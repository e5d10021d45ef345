"""The benchmark of `arroy_tpu_torch`: one cell (a configuration under one
traffic mix) run once by ``python benchmark/run.py``.

Everything that measures lives here: the corpus and query generator, the
closed request loop, the plain reference and the comparison that decides
``correct``, the profiler reading and the per-layer metric readers.  From
the port it takes only the system under test (`Database`, `Writer`,
`Reader.searcher`) and its launch counters and kernel names.  Nothing here
imports JAX or the JAX package.
"""
