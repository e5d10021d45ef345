"""Sorted-unique id sets — the roaring-bitmap role of the reference.

The reference uses `RoaringBitmap` everywhere an (ordered) set of u32 item
ids is needed: descendants membership, the metadata item list, the updated
set, query candidate filters (reference: src/node.rs:45-47,
src/metadata.rs:12-17, src/reader.rs:31).  On the host side we use sorted
unique ``uint32`` numpy arrays, which give vectorized set algebra and
convert to device masks in O(n); compressed encodings buy nothing for the
flat-array TPU design, so this is intentionally *not* a roaring port.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Union

import numpy as np

IdsLike = Union["ItemSet", np.ndarray, Iterable[int]]


def _as_sorted_unique(ids: IdsLike) -> np.ndarray:
    if isinstance(ids, ItemSet):
        return ids.ids
    arr = np.asarray(list(ids) if not isinstance(ids, np.ndarray) else ids)
    if arr.size == 0:
        return np.empty(0, dtype=np.uint32)
    if arr.min() < 0 or arr.max() > np.iinfo(np.uint32).max:
        raise ValueError("item ids must fit in u32")
    return np.unique(arr.astype(np.uint32))


class ItemSet:
    """An immutable sorted set of u32 item ids."""

    __slots__ = ("ids",)

    def __init__(self, ids: IdsLike = ()):  # noqa: B008
        object.__setattr__(self, "ids", _as_sorted_unique(ids))

    # -- constructors -------------------------------------------------
    @staticmethod
    def from_sorted(arr: np.ndarray) -> "ItemSet":
        """Wrap an array that is already sorted+unique (no copy, no check)."""
        s = ItemSet.__new__(ItemSet)
        object.__setattr__(s, "ids", np.ascontiguousarray(arr, dtype=np.uint32))
        return s

    # -- basic protocol ------------------------------------------------
    def __len__(self) -> int:
        return int(self.ids.size)

    def __iter__(self) -> Iterator[int]:
        return iter(int(i) for i in self.ids)

    def __contains__(self, item: int) -> bool:
        i = np.searchsorted(self.ids, np.uint32(item))
        return bool(i < self.ids.size and self.ids[i] == item)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ItemSet):
            return NotImplemented
        return self.ids.shape == other.ids.shape and bool(np.all(self.ids == other.ids))

    def __hash__(self):  # pragma: no cover - identity-ish use only
        return hash(self.ids.tobytes())

    def __repr__(self) -> str:
        head = ", ".join(str(i) for i in self.ids[:8])
        more = ", ..." if len(self) > 8 else ""
        return f"ItemSet([{head}{more}], len={len(self)})"

    def is_empty(self) -> bool:
        return self.ids.size == 0

    # -- set algebra ---------------------------------------------------
    def union(self, other: IdsLike) -> "ItemSet":
        return ItemSet.from_sorted(np.union1d(self.ids, _as_sorted_unique(other)))

    def intersection(self, other: IdsLike) -> "ItemSet":
        return ItemSet.from_sorted(
            np.intersect1d(self.ids, _as_sorted_unique(other), assume_unique=True)
        )

    def difference(self, other: IdsLike) -> "ItemSet":
        return ItemSet.from_sorted(
            np.setdiff1d(self.ids, _as_sorted_unique(other), assume_unique=True)
        )

    def contains_many(self, items: np.ndarray) -> np.ndarray:
        """Vectorized membership for an arbitrary uint32 array."""
        items = np.asarray(items, dtype=np.uint32)
        idx = np.searchsorted(self.ids, items)
        idx_clip = np.minimum(idx, max(self.ids.size - 1, 0))
        if self.ids.size == 0:
            return np.zeros(items.shape, dtype=bool)
        return self.ids[idx_clip] == items

    __or__ = union
    __and__ = intersection
    __sub__ = difference

    def is_superset(self, other: "ItemSet") -> bool:
        return len(self.intersection(other)) == len(other)

    # -- conversions ---------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        return self.ids.copy()

    def max(self) -> int:
        if self.is_empty():
            raise ValueError("empty ItemSet has no max")
        return int(self.ids[-1])
