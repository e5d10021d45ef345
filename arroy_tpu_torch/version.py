"""Index-format versioning (reference: src/version.rs:8-64).

The reference stores a semver triple under a dedicated metadata key and
dispatches node decoding on it; we store the triple in the index metadata
of our own container format and dispatch `upgrade` steps on it.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Version:
    major: int
    minor: int
    patch: int

    def __str__(self) -> str:  # reference: src/version.rs:14-18
        return f"{self.major}.{self.minor}.{self.patch}"

    @staticmethod
    def parse(s: str) -> "Version":
        major, minor, patch = (int(p) for p in s.split("."))
        return Version(major, minor, patch)


#: The first arroy-tpu format: generation directories whose state lives
#: either in plain ``*.npy`` files or in a ``state.atc`` container.
V1_0_0 = Version(1, 0, 0)

#: 1.1.0 declared the native container (`state.atc`, CRC-checked) the
#: only store; v1.0.0 npy generations are migrated by
#: `upgrade.upgrade_index` (the reference's step chain role,
#: src/upgrade.rs:26,150,183).
V1_1_0 = Version(1, 1, 0)

#: Version written by the current writer.  Independent of the reference's
#: crate version.  1.2.0 forbids KIND_SPLIT nodes whose stored normal row
#: is all-zero: such nodes are semantically `normal: None` (a random-side
#: split) and must be stored as KIND_SPLIT_NONE with no normal row — the
#: exact analog of the reference's 0.6→0.7 zero-normal surgery
#: (reference: src/upgrade.rs:249-258, src/node.rs zero-normal legacy).
#: `upgrade.upgrade_index` transforms offending nodes and repacks the
#: normals matrix.
CURRENT_VERSION = Version(1, 2, 0)

#: Formats older than this never existed for arroy-tpu; kept for the
#: upgrade-machinery parity with `before_version_db_was_introduced`
#: (reference: src/version.rs:22-24).
OLDEST_READABLE_VERSION = Version(1, 0, 0)
