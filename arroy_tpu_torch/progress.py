"""Build progress reporting and cancellation.

Mirrors the reference's structured progress API: a `WriterProgress`
carrying a `MainStep` (13 variants) and an optional `SubStep` with a
shared counter that workers bump (reference: src/writer.rs:44-93).
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional


class MainStep(enum.Enum):
    """Reference: src/writer.rs:79-93 (same variants, same order)."""

    PRE_PROCESSING_THE_ITEMS = "PreProcessingTheItems"
    RETRIEVING_THE_ITEMS_IDS = "RetrievingTheItemsIds"
    RETRIEVE_THE_UPDATED_ITEMS = "RetrieveTheUpdatedItems"
    WRITING_THE_DESCENDANTS_AND_METADATA = "WritingTheDescendantsAndMetadata"
    DELETING_EXTRA_TREES = "DeletingExtraTrees"
    REMOVE_ITEMS_FROM_EXISTING_TREES = "RemoveItemsFromExistingTrees"
    RETRIEVING_THE_USED_TREE_NODES = "RetrievingTheUsedTreeNodes"
    RETRIEVING_THE_ITEMS = "RetrievingTheItems"
    RETRIEVING_THE_TREE_NODES = "RetrievingTheTreeNodes"
    INSERT_ITEMS_IN_CURRENT_TREES = "InsertItemsInCurrentTrees"
    RETRIEVE_THE_LARGE_DESCENDANTS = "RetrieveTheLargeDescendants"
    CREATE_TREES_FOR_ITEMS = "CreateTreesForItems"
    WRITE_THE_METADATA = "WriteTheMetadata"


@dataclass
class SubStep:
    """A finer-grained counter under a MainStep (reference: src/writer.rs:52-69)."""

    unit: str
    max: int
    _current: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @property
    def current(self) -> int:
        return self._current

    def add(self, n: int) -> None:
        # clamped: budget-mode rebuilds can re-place the same items in a
        # merged leaf, so placements may exceed the estimate slightly
        with self._lock:
            self._current = min(self._current + n, self.max)


@dataclass
class WriterProgress:
    main: MainStep
    sub: Optional[SubStep] = None


ProgressFn = Callable[[WriterProgress], None]
CancelFn = Callable[[], bool]
