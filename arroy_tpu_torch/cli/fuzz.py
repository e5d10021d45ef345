"""Randomized add/delete/build/validate fuzz loop.

Reference: examples/fuzz.rs — random batches of Add/Delete ops over a
small id space, build + `assert_validity` after every commit, logging
iterations/second.  Run for a wall-clock budget with --seconds.

Beyond the reference's op mix this soak also churns the two subsystems
where round-1 self-review found real data-loss bugs:

- **persistence reload** (``--path`` + ``--reload-every``): the database
  is periodically closed and reopened from disk, and the reloaded state
  is checked against a host-side oracle of expected live items — this
  exercises the generation publish/fsync chain and the device cache
  invalidation (the round-1 "generation collision after drop+recreate"
  bug class);
- **multi-index drop/recreate** (``--indexes`` + ``--drop-prob``): ops
  are spread over several u16 sub-indexes and a random index is
  occasionally dropped mid-stream, then repopulated from scratch.

After every commit, every live index is validated: item set == oracle,
`assert_validity` forest invariants, and a self-query sanity probe.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..errors import MissingMetadata
from ..reader import Reader
from ..store.database import Database
from ..writer import Writer
from ._common import add_device_arg


def _check_index(db, index, metric, live):
    """Validate one index against the oracle item set."""
    try:
        r = Reader.open(db.read(), index, db, metric=metric)
    except MissingMetadata:
        assert not live, (
            f"index {index}: oracle has {len(live)} live items but "
            f"the database has no metadata"
        )
        return
    got = set(r.item_ids())
    assert got == live, (
        f"index {index}: item set mismatch — "
        f"missing={sorted(live - got)[:10]} extra={sorted(got - live)[:10]}"
    )
    r.assert_validity()
    if live:
        some = next(iter(live))
        res = r.nns(3).by_item(some)
        assert res, f"index {index}: self-query of item {some} returned nothing"
        assert res[0][0] == some or res[0][1] <= 1e-5, (
            f"index {index}: self-query of item {some} -> {res[0]}"
        )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--dims", type=int, default=8)
    ap.add_argument("--distinct-vectors", type=int, default=5)
    ap.add_argument("--ops-per-batch", type=int, default=50)
    ap.add_argument("--batches-per-commit", type=int, default=5)
    ap.add_argument("--id-space", type=int, default=128)
    ap.add_argument("--distance", default="euclidean")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--path", default=None, help="persistent database dir (default: in-memory)"
    )
    ap.add_argument(
        "--indexes", type=int, default=1, help="number of u16 sub-indexes to churn"
    )
    ap.add_argument(
        "--drop-prob",
        type=float,
        default=0.0,
        help="per-commit probability of dropping a random index",
    )
    ap.add_argument(
        "--reload-every",
        type=int,
        default=0,
        help="close + reopen the database from disk every N commits (needs --path)",
    )
    add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.reload_every and not args.path:
        ap.error("--reload-every requires --path")

    rng = np.random.default_rng(args.seed)
    base = rng.standard_normal((args.distinct_vectors, args.dims)).astype(np.float32)

    db = Database(args.path, device=args.device)
    writers = {
        i: Writer(db, i, args.dims, metric=args.distance) for i in range(args.indexes)
    }
    live: dict[int, set[int]] = {i: set() for i in range(args.indexes)}

    t_end = time.time() + args.seconds
    iters = reloads = drops = 0
    t0 = time.time()
    while time.time() < t_end:
        touched: set[int] = set()
        with db.write() as wtxn:
            if args.drop_prob and rng.random() < args.drop_prob and iters > 0:
                victim = int(rng.integers(args.indexes))
                wtxn.drop_index(victim)
                live[victim] = set()
                drops += 1
            for _ in range(args.batches_per_commit):
                for _ in range(args.ops_per_batch):
                    idx = int(rng.integers(args.indexes))
                    w = writers[idx]
                    touched.add(idx)
                    item = int(rng.integers(args.id_space))
                    if rng.random() < 0.5:
                        w.add_item(wtxn, item, base[int(rng.integers(len(base)))])
                        live[idx].add(item)
                    else:
                        w.del_item(wtxn, item)
                        live[idx].discard(item)
            for idx in sorted(touched):
                writers[idx].builder(seed=int(rng.integers(2**31))).build(wtxn)

        if args.reload_every and (iters + 1) % args.reload_every == 0:
            db.close()
            db = Database(args.path, device=args.device)
            writers = {
                i: Writer(db, i, args.dims, metric=args.distance)
                for i in range(args.indexes)
            }
            reloads += 1

        for idx in range(args.indexes):
            _check_index(db, idx, args.distance, live[idx])
        iters += 1
        if iters % 10 == 0:
            print(
                f"{iters} iterations, {iters / (time.time() - t0):.2f} it/s"
                f" ({reloads} reloads, {drops} index drops)",
                flush=True,
            )
    print(
        f"done: {iters} iterations in {time.time() - t0:.1f}s "
        f"({reloads} reloads, {drops} index drops), no invariant violations"
    )


if __name__ == "__main__":
    main()
