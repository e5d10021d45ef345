"""Flat structure-of-arrays forest.

The reference stores each tree node as an LMDB record —
`SplitPlaneNormal{normal, left, right}` or `Descendants{bitmap}`
(reference: src/node.rs:15-20,45-47,68-100) — addressed by a u32 tree-node
id allocated by `ConcurrentNodeIds` (reference: src/parallel.rs:208-255).

Here the node table is a set of parallel numpy arrays indexed directly by
node id: `kind`, `left`, `right`, `ptr` (split → row in the normals
matrix), plus a dict of leaf membership id-sets.  The device mirror packs
leaves into a CSR and uploads everything as flat tensors so that query
traversal is pure gathers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..errors import DatabaseFull

KIND_FREE = -1
KIND_SPLIT = 0  # split with a real hyperplane
KIND_SPLIT_NONE = 1  # split whose normal is None (random fallback, src/writer.rs:1218-1227)
KIND_LEAF = 2  # descendants node


class NodeIdAllocator:
    """Tree-node id allocator recycling holes first.

    Mirrors `ConcurrentNodeIds` (reference: src/parallel.rs:208-255): ids
    freed by earlier deletes are handed out before the bump counter grows,
    and exhausting u32 raises `DatabaseFull`.
    """

    def __init__(self, used: np.ndarray):
        used = np.asarray(used, dtype=np.int64)
        if used.size:
            top = int(used.max()) + 1
            holes = np.setdiff1d(np.arange(top, dtype=np.int64), used, assume_unique=False)
            self._available: list[int] = [int(h) for h in holes[::-1]]
            self._next = top
        else:
            self._available = []
            self._next = 0

    def next(self) -> int:
        if self._available:
            return self._available.pop()
        # the node tables store ids as int32, so the practical cap is
        # i32::MAX (the reference errors at u32 overflow; ours fires at
        # the dtype limit the arrays can actually hold)
        if self._next > 0x7FFFFFFF:
            raise DatabaseFull()
        nid = self._next
        self._next += 1
        return nid

    def next_many(self, n: int) -> np.ndarray:
        """Allocate `n` ids — the exact sequence `n` next() calls would
        return (holes first, then the bump counter), so bulk callers stay
        byte-identical with the scalar path."""
        out = np.empty(n, np.int64)
        k = min(len(self._available), n)
        for j in range(k):
            out[j] = self._available.pop()
        rest = n - k
        if rest:
            if self._next + rest - 1 > 0x7FFFFFFF:
                raise DatabaseFull()
            out[k:] = np.arange(self._next, self._next + rest, dtype=np.int64)
            self._next += rest
        return out


@dataclass
class Forest:
    """Host-side forest for one index."""

    kind: np.ndarray = field(default_factory=lambda: np.empty(0, np.int8))
    left: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    right: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    ptr: np.ndarray = field(default_factory=lambda: np.empty(0, np.int32))
    #: split-plane matrix, rows indexed by `ptr` (f32 [S, d] or uint32 [S, w])
    normals: np.ndarray | None = None
    aux: np.ndarray = field(default_factory=lambda: np.empty(0, np.float32))
    #: node id -> sorted uint32 item ids (the Descendants bitmaps)
    leaves: dict[int, np.ndarray] = field(default_factory=dict)
    #: tree roots, in creation order (oldest first, reference metadata.roots)
    roots: list[int] = field(default_factory=list)

    # ------------------------------------------------------------------
    def clone(self) -> "Forest":
        return Forest(
            kind=self.kind.copy(),
            left=self.left.copy(),
            right=self.right.copy(),
            ptr=self.ptr.copy(),
            normals=None if self.normals is None else self.normals.copy(),
            aux=self.aux.copy(),
            leaves={k: v for k, v in self.leaves.items()},
            roots=list(self.roots),
        )

    def used_node_ids(self) -> np.ndarray:
        return np.nonzero(self.kind != KIND_FREE)[0].astype(np.int64)

    def n_nodes(self) -> int:
        return int(np.count_nonzero(self.kind != KIND_FREE))

    def _ensure(self, node_id: int) -> None:
        n = self.kind.shape[0]
        if node_id < n:
            return
        new = max(node_id + 1 - n, n // 2, 64)
        self.kind = np.concatenate([self.kind, np.full(new, KIND_FREE, np.int8)])
        self.left = np.concatenate([self.left, np.zeros(new, np.int32)])
        self.right = np.concatenate([self.right, np.zeros(new, np.int32)])
        self.ptr = np.concatenate([self.ptr, np.zeros(new, np.int32)])

    # -- mutation ------------------------------------------------------
    def put_leaf(self, node_id: int, items: np.ndarray) -> None:
        # an overwritten split's normal row is garbage-collected by repack
        self._ensure(node_id)
        self.kind[node_id] = KIND_LEAF
        # own a copy (clone() shares leaf arrays) and enforce the sorted
        # invariant every consumer's searchsorted set-algebra relies on
        ids = np.array(items, dtype=np.uint32, copy=True)
        if len(ids) > 1 and (ids[1:] <= ids[:-1]).any():
            raise ValueError(f"leaf {node_id}: items must be sorted unique u32s")
        self.leaves[node_id] = ids

    def put_leaves(self, node_ids: np.ndarray, arrays: list[np.ndarray]) -> None:
        """Trusted bulk put_leaf for the builder's write-back: arrays are
        sorted-unique uint32 by construction (one lexsort over the whole
        permutation), so the per-leaf validation and copy are skipped —
        the scalar loop was ~590k Python iterations at 1.18M x 25 trees."""
        node_ids = np.asarray(node_ids, np.int64)
        if not len(node_ids):
            return
        self._ensure(int(node_ids.max()))
        self.kind[node_ids] = KIND_LEAF
        self.leaves.update(zip(node_ids.tolist(), arrays))

    def put_split(
        self, node_id: int, left: int, right: int, normal_row: int | None
    ) -> None:
        """normal_row indexes a caller-managed staging list (which also
        holds the bias/aux per row); repack later."""
        self._ensure(node_id)
        self.leaves.pop(node_id, None)
        if normal_row is None:
            self.kind[node_id] = KIND_SPLIT_NONE
            self.ptr[node_id] = 0
        else:
            self.kind[node_id] = KIND_SPLIT
            self.ptr[node_id] = normal_row
        self.left[node_id] = left
        self.right[node_id] = right

    def put_splits(
        self,
        node_ids: np.ndarray,
        lefts: np.ndarray,
        rights: np.ndarray,
        normal_rows: np.ndarray,
    ) -> None:
        """Vectorized put_split; ``normal_rows < 0`` means a None normal
        (random-side split).  Equivalent to calling put_split per row."""
        node_ids = np.asarray(node_ids, np.int64)
        if not len(node_ids):
            return
        self._ensure(int(node_ids.max()))
        for nid in node_ids.tolist():
            self.leaves.pop(nid, None)
        rows = np.asarray(normal_rows, np.int64)
        none = rows < 0
        self.kind[node_ids] = np.where(
            none, KIND_SPLIT_NONE, KIND_SPLIT
        ).astype(self.kind.dtype)
        self.ptr[node_ids] = np.where(none, 0, rows).astype(self.ptr.dtype)
        self.left[node_ids] = np.asarray(lefts, self.left.dtype)
        self.right[node_ids] = np.asarray(rights, self.right.dtype)

    def remove(self, node_id: int) -> None:
        if node_id < self.kind.shape[0]:
            self.kind[node_id] = KIND_FREE
            self.leaves.pop(node_id, None)

    def delete_subtree(self, node_id: int) -> None:
        """Recursively free a whole tree (reference: src/writer.rs:1263-1277)."""
        stack = [int(node_id)]
        while stack:
            nid = stack.pop()
            k = self.kind[nid]
            if k in (KIND_SPLIT, KIND_SPLIT_NONE):
                stack.append(int(self.left[nid]))
                stack.append(int(self.right[nid]))
            self.remove(nid)

    # -- traversal helpers --------------------------------------------
    def subtree_items(self, node_id: int) -> np.ndarray:
        """All item ids reachable from a node (unioned leaves)."""
        out: list[np.ndarray] = []
        stack = [int(node_id)]
        while stack:
            nid = stack.pop()
            k = self.kind[nid]
            if k == KIND_LEAF:
                out.append(self.leaves[nid])
            elif k in (KIND_SPLIT, KIND_SPLIT_NONE):
                stack.append(int(self.left[nid]))
                stack.append(int(self.right[nid]))
        if not out:
            return np.empty(0, np.uint32)
        return np.unique(np.concatenate(out))

    def repack_normals(self, staging: np.ndarray, staging_aux: np.ndarray) -> None:
        """Compact the normals matrix to live split rows only.

        During a build, new split rows are appended to a staging matrix and
        `ptr` indexes into it; this rewrites `normals`/`aux` to contain only
        rows referenced by live SPLIT nodes and fixes `ptr` up.
        """
        live = np.nonzero(self.kind == KIND_SPLIT)[0]
        rows = self.ptr[live]
        self.normals = staging[rows] if live.size else staging[:0]
        self.aux = staging_aux[rows] if live.size else staging_aux[:0]
        self.ptr[live] = np.arange(live.size, dtype=np.int32)
