"""Index data models: the item store and the forest structure.

These are the TPU-native replacements for the reference's LMDB-resident
node records (reference: src/node.rs, src/key.rs): flat structure-of-arrays
tables on the host with device mirrors built on demand.
"""

from .forest import KIND_FREE, KIND_LEAF, KIND_SPLIT, KIND_SPLIT_NONE, Forest, NodeIdAllocator
from .items import ItemStore

__all__ = [
    "Forest",
    "ItemStore",
    "NodeIdAllocator",
    "KIND_FREE",
    "KIND_SPLIT",
    "KIND_SPLIT_NONE",
    "KIND_LEAF",
]
