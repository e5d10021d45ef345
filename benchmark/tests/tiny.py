"""A cell at a size a CPU test run holds: the harness's path end to end,
with the port's plain (CPU) kernels in the program's place."""

from benchmark import spec

CONFIG = {
    "n_items": 3000, "dims": 32, "metric": "cosine", "n_queries": 200, "k": 10, "n_trees": 6,
    "corpus_model": {"parents": 64, "noise": 0.05},
}


def cell(searcher=None, filter_share=None, limits=None, batch=64, base="glove100-exact-b2048"):
    """A tiny cell with the limits and metrics of the cell `base`."""
    base = spec.load_cell(base)
    traffic = {"loop": "closed", "clients": 1, "batch": batch, "filter_share": filter_share,
               "searcher": searcher or {"engine": "auto"}}
    return spec.Cell("tiny", CONFIG, traffic, limits or base.limits, base.end_to_end, base.per_layer)
