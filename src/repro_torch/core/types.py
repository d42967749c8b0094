"""Core value types for the RStore layer.

The paper's data model (§2.1): the unit of storage is an immutable *record*
identified by a *composite key* ``<primary-key, version-id-of-origin>``.
Versions are identified by integer version-ids (the paper permits hashes; we
use ints for array-friendliness and keep a side table for symbolic names).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

VersionId = int
PrimaryKey = int

# Composite keys are packed into a single int64: high 32 bits = primary key,
# low 32 bits = origin version-id.  This gives every distinct record a global
# address (§2.1 "global address space") that is also a valid array element.
_KEY_BITS = 32
_KEY_MASK = (1 << _KEY_BITS) - 1
# keys/versions are capped at 2^31-1 so packed values stay positive int64
_MAX_PART = (1 << 31) - 1


def pack_ck(key: PrimaryKey, version: VersionId) -> int:
    """Pack a composite key into an int64 scalar."""
    if not (0 <= key <= _MAX_PART and 0 <= version <= _MAX_PART):
        raise ValueError(f"composite key out of range: ({key}, {version})")
    return (key << _KEY_BITS) | version


def unpack_ck(ck: int) -> Tuple[PrimaryKey, VersionId]:
    return (ck >> _KEY_BITS) & _KEY_MASK, ck & _KEY_MASK


def pack_ck_array(keys: np.ndarray, versions: np.ndarray) -> np.ndarray:
    return (keys.astype(np.int64) << _KEY_BITS) | versions.astype(np.int64)


def unpack_ck_array(cks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    cks = cks.astype(np.int64)
    return (cks >> _KEY_BITS).astype(np.int64), (cks & _KEY_MASK).astype(np.int64)


@dataclass(frozen=True)
class CompositeKey:
    """``<K, V>`` — primary key plus the version where this record originated."""

    key: PrimaryKey
    version: VersionId

    def packed(self) -> int:
        return pack_ck(self.key, self.version)

    @staticmethod
    def from_packed(ck: int) -> "CompositeKey":
        k, v = unpack_ck(ck)
        return CompositeKey(k, v)

    def __repr__(self) -> str:  # matches the paper's ⟨K, V⟩ notation
        return f"<K{self.key},V{self.version}>"


@dataclass
class Record:
    """An immutable record: composite key + opaque payload bytes."""

    ck: CompositeKey
    payload: bytes

    @property
    def size(self) -> int:
        return len(self.payload)


@dataclass
class Delta:
    """The set of changes from a parent version to a child version (§2.1).

    ``adds`` holds records *created* in the child (newly inserted primary keys
    and new record-versions of modified keys); their composite keys carry the
    child's version-id.  ``dels`` holds the composite keys (as stored in the
    parent) of records removed or superseded in the child.

    ``Delta`` is symmetric in the paper (Δij = Δji); we store the directed
    (parent→child) form and expose :meth:`reversed` for the other direction.
    Consistency (Ghandeharizadeh et al.): Δ+ ∩ Δ− = ∅ is checked on ingest.
    """

    adds: Dict[PrimaryKey, bytes] = field(default_factory=dict)
    dels: List[CompositeKey] = field(default_factory=list)

    def validate(self, child_version: VersionId) -> None:
        del_keys = {ck.key for ck in self.dels}
        # A modified key appears in both dels (old record) and adds (new
        # record) — that is fine; what must not happen is the *same composite
        # key* on both sides, which cannot occur since adds carry the child's
        # version id and dels carry ancestor ids.
        for ck in self.dels:
            if ck.version == child_version:
                raise ValueError(f"delta deletes a record it creates: {ck}")
        if len(del_keys) != len(self.dels):
            raise ValueError("delta deletes the same primary key twice")

    @property
    def num_changes(self) -> int:
        return len(self.adds) + len(self.dels)


@dataclass
class Chunk:
    """A fixed-size group of records — the backend KVS storage unit (§2.4)."""

    chunk_id: int
    record_ids: np.ndarray  # int64 indices into the RecordStore
    nbytes: int = 0

    def __len__(self) -> int:
        return len(self.record_ids)


@dataclass
class Partitioning:
    """Result of a partitioning algorithm: record → chunk assignment."""

    chunks: List[Chunk]
    record_to_chunk: np.ndarray  # int64[num_records], -1 if unassigned
    algorithm: str = ""

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def validate(self, record_sizes: np.ndarray, capacity: int, slack: float = 0.25) -> None:
        """Paper's fixed-chunk-size invariant: every chunk ≤ C·(1+slack); every
        record assigned to exactly one chunk."""
        seen = np.zeros(len(self.record_to_chunk), dtype=bool)
        for ch in self.chunks:
            if len(ch.record_ids) == 0:
                raise ValueError(f"empty chunk {ch.chunk_id}")
            size = int(record_sizes[ch.record_ids].sum())
            # single records larger than a chunk get a dedicated chunk
            if size > capacity * (1 + slack) and len(ch.record_ids) > 1:
                raise ValueError(
                    f"chunk {ch.chunk_id} overfull: {size} > {capacity * (1 + slack)}")
            if seen[ch.record_ids].any():
                raise ValueError("record assigned to multiple chunks")
            seen[ch.record_ids] = True
        if not seen.all():
            raise ValueError(f"{int((~seen).sum())} records unassigned")
