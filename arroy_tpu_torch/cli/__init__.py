"""Command-line tools mirroring the reference example binaries.

Counterpart of `arroy_tpu/cli/`, tool for tool, with the same flags and
printed lines, plus ``--device`` (default ``cuda``; the tests pass
``--device cpu``), which is handed to `Database(path, device=...)`.

=====================  =================================================
reference binary       PyTorch port equivalent
=====================  =================================================
import-vectors         ``python -m arroy_tpu_torch.cli.import_vectors``
build-tree-no-commit   ``python -m arroy_tpu_torch.cli.build_only``
stats                  ``python -m arroy_tpu_torch.cli.stats``
graph                  ``python -m arroy_tpu_torch.cli.graph``
search_movies          ``python -m arroy_tpu_torch.cli.search_bench``
compare_with_hnsw      ``python -m arroy_tpu_torch.cli.compare_exact``
fuzz                   ``python -m arroy_tpu_torch.cli.fuzz``
sample_vectors         ``python -m arroy_tpu_torch.cli.sample_vectors``
(ext. benchmark repo)  ``python -m arroy_tpu_torch.cli.recall_sweep``
(src/upgrade.rs)       ``python -m arroy_tpu_torch.cli.upgrade``
(extra: db fsck)       ``python -m arroy_tpu_torch.cli.check``
=====================  =================================================
"""
