"""Error taxonomy for arroy-tpu.

Mirrors the reference error enum (reference: src/error.rs:7-86) with
Python exception classes.  Every error that the reference can surface to a
user has an equivalent here so that code ported from arroy can translate
its error handling one-to-one.
"""

from __future__ import annotations


class ArroyError(Exception):
    """Base class of every arroy-tpu error (reference: src/error.rs:7)."""


class InvalidVecDimension(ArroyError):
    """A vector of the wrong dimension was inserted or queried.

    Reference: src/error.rs:17-24 (`Error::InvalidVecDimension`).
    """

    def __init__(self, expected: int, received: int):
        self.expected = expected
        self.received = received
        super().__init__(
            f"Invalid vector dimensions. Got {received} but expected {expected}"
        )


class DatabaseFull(ArroyError):
    """Internal node-id space exhausted (reference: src/error.rs:26-28)."""

    def __init__(self) -> None:
        super().__init__(
            "Database full. Arroy cannot generate enough internal IDs for your items"
        )


class InvalidItemAppend(ArroyError):
    """`append_item` used with a non-increasing item id.

    Reference: src/error.rs:30-33 (`Error::InvalidItemAppend`).
    """

    def __init__(self) -> None:
        super().__init__("Item cannot be appended into the database")


class UnmatchingDistance(ArroyError):
    """Opened an index with a different distance than it was built with.

    Reference: src/error.rs:35-42 (`Error::UnmatchingDistance`).
    """

    def __init__(self, expected: str, received: str):
        self.expected = expected
        self.received = received
        super().__init__(
            f"Invalid distance provided. Got {received} but expected {expected}"
        )


class MissingMetadata(ArroyError):
    """The index was never built (reference: src/error.rs:44-48)."""

    def __init__(self, index: int):
        self.index = index
        super().__init__(
            f"Metadata are missing on index {index}, "
            "You must build your database before attempting to read it"
        )


class NeedBuild(ArroyError):
    """Items were updated but `build` was not called again.

    Reference: src/error.rs:50-52 (`Error::NeedBuild`).
    """

    def __init__(self, index: int):
        self.index = index
        super().__init__(f"The trees have not been built after an update on index {index}")


class BuildCancelled(ArroyError):
    """The user-supplied cancel closure returned True.

    Reference: src/error.rs:54-56 (`Error::BuildCancelled`).
    """

    def __init__(self) -> None:
        super().__init__("The corresponding build process has been cancelled")


class MissingKey(ArroyError):
    """Internal error: a node id is dangling (reference: src/error.rs:58-67)."""

    def __init__(self, index: int, mode: str, item: int):
        self.index = index
        self.mode = mode
        self.item = item
        super().__init__(f"Internal error: {mode}({item}) is missing in index `{index}`")


class CannotDecodeKeyMode(ArroyError):
    """A stored key has an unknown mode tag (reference: src/error.rs:69-74)."""

    def __init__(self, mode: object):
        self.mode = mode
        super().__init__(f"Cannot decode key mode: `{mode!r}`")


class UnknownVersion(ArroyError):
    """The on-disk format version is not understood.

    Reference: src/error.rs:76-81 (`Error::UnknownVersion`).
    """

    def __init__(self, version: str):
        self.version = version
        super().__init__(f"Unknown version: v{version}")


class Panic(ArroyError):
    """A worker task raised unexpectedly (reference: src/error.rs:83-85)."""

    def __init__(self, msg: str):
        super().__init__(f"Unexpected panic in: {msg}")


class SizeMismatch(ArroyError):
    """A raw vector payload has the wrong size for its codec
    (reference: src/unaligned_vector/mod.rs SizeMismatch)."""
