"""Find a forest cell's ``search_k``: recall@10 and queries/s of the
forest engine at ``search_k`` = 2000 * 2^n on one seed, in one process
(one corpus, one build), each point a short closed-loop window at the
given batch judged against the reference.

    python3 benchmark/sweep.py --config dbpedia-openai-100k --batch 256 \\
        [--filter-share 0.1] --seed 0 --search-k 2000,4000,8000,16000,32000 --seconds 3

One JSON line a point.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--filter-share", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--search-k", default="2000,4000,8000,16000,32000")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from benchmark import cell, checks, data, loop, spec

    bench = spec.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == args.config)
    cfg = spec._json(os.path.join(spec.ROOT, entry["file"]))
    k, b = cfg["k"], args.batch
    x, pool = data.vectors(cfg, args.seed, args.device)
    sched = data.schedule(len(pool), b, args.seed)
    batches = [np.ascontiguousarray(pool[i]) for i in sched]
    allowed = data.filter_ids(len(x), args.filter_share, args.seed) if args.filter_share else None
    db, reader = cell._build(cfg, x, args.seed, args.device)
    points = []
    for sk in (int(s) for s in args.search_k.split(",")):
        s = reader.searcher(k, candidates=allowed, engine="forest", search_k=sk)
        loop.drive(s, batches, k, 0.5)  # warm-up
        w = loop.drive(s, batches, k, args.seconds)
        points.append((sk, s.route, w))
        del s
        gc.collect()
    del reader, db
    gc.collect()
    if args.device == "cuda":
        torch.cuda.empty_cache()
    for sk, route, w in points:
        judged = checks.judge(w.answers, sched, x, pool, cfg["metric"], k,
                              {"recall10_min": 0.0, "dist_err_max": float("inf")}, allowed, args.device)
        print(json.dumps({
            "config": args.config, "batch": b, "filter_share": args.filter_share, "seed": args.seed, "search_k": sk,
            "route": route, "recall10": judged["recall10"]["value"],
            "dist_err": judged["dist_err"]["value"], "bad_answers": judged["bad_answers"]["value"],
            "qps": len(w.answers) * b / w.seconds, "p95_ms": loop.p95_ms(w), "requests": w.requests,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
