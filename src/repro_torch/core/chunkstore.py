"""Physical chunk layout + chunk maps (§2.4).

A stored chunk holds (a) its records' payloads grouped into *sub-chunks*
(singleton sub-chunks unless §3.4 compression is enabled: records of one
primary key, connected in the version tree, XOR-delta'd against their
sub-chunk parent and zlib'd together), and (b) the chunk map ``M^{C_i}`` —
for each record, the set of versions containing it, stored as a bitmap over
version indices ("the adjacency list in each chunk map file is then converted
to a bitmap, compressed and stored in the KVS").
"""
from __future__ import annotations

import functools
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .. import trace
from ..kernels import ops as kops
from .version_graph import VersionGraph


# ------------------------------------------------------------------ chunk map
@dataclass
class ChunkMap:
    """Per-chunk slice of the 3-D mapping M (Fig. 3): record composite keys +
    a (n_rec, W) uint32 bitmap of version-index membership."""

    cks: np.ndarray            # (n_rec,) int64 packed composite keys
    bitmap: np.ndarray         # (n_rec, W) uint32
    n_versions: int

    def records_in_version(self, vidx: int) -> np.ndarray:
        w, bit = divmod(vidx, 32)
        hit = (self.bitmap[:, w] >> np.uint32(bit)) & np.uint32(1)
        return np.flatnonzero(hit)

    def versions_of_record(self, local_idx: int) -> np.ndarray:
        row = self.bitmap[local_idx]
        out = []
        for w in range(len(row)):
            v = int(row[w])
            while v:
                b = v & -v
                out.append(w * 32 + b.bit_length() - 1)
                v ^= b
        return np.asarray([o for o in out if o < self.n_versions], dtype=np.int64)

    def to_bytes(self) -> bytes:
        raw = self.bitmap.astype("<u4").tobytes()
        comp = zlib.compress(raw, level=6)
        head = struct.pack("<IIII", len(self.cks), self.bitmap.shape[1],
                           self.n_versions, len(comp))
        return head + self.cks.astype("<i8").tobytes() + comp

    @staticmethod
    def from_bytes(buf: bytes) -> "ChunkMap":
        tr = trace.ACTIVE
        if tr is not None:
            tr.open("read.parse.map")
        try:
            n_rec, w, n_ver, clen = struct.unpack_from("<IIII", buf, 0)
            off = 16
            cks = np.frombuffer(buf, dtype="<i8", count=n_rec,
                                offset=off).astype(np.int64)
            off += n_rec * 8
            raw = zlib.decompress(buf[off:off + clen])
            bitmap = np.frombuffer(raw, dtype="<u4").reshape(
                n_rec, w).astype(np.uint32)
            return ChunkMap(cks=cks, bitmap=bitmap, n_versions=n_ver)
        finally:
            if tr is not None:
                tr.close()


# --------------------------------------------------------------- stored chunk
@dataclass
class SubChunkBlob:
    """One compressed sub-chunk: local record indices (first = raw base, the
    rest XOR-delta'd against their sub-chunk tree parent) + payload blob.
    The three index columns are tuples of ints (serialized as int32)."""

    local_ids: Sequence[int]   # local record indices, tree (BFS) order
    parent_pos: Sequence[int]  # position *within sub-chunk* of each
    #                            record's delta parent (-1 = stored raw)
    lengths: Sequence[int]     # true payload lengths
    blob: bytes                # zlib(concat of raw-or-delta payloads)


_HEAD = struct.Struct("<III")
_SUB_HEAD = struct.Struct("<II")
_U32 = struct.Struct("<I")


@functools.lru_cache(maxsize=None)
def _sub_cols(n: int) -> struct.Struct:
    """The three int32 columns of an ``n``-record sub-chunk."""
    return struct.Struct(f"<{3 * n}i")


class SubChunkDirectory(NamedTuple):
    """Where a stored chunk's sub-chunks lie in its encoding, as flat
    arrays: read in place, with no object a sub-chunk or a record."""

    sub_start: np.ndarray   # (n_sub + 1,) CSR of records over sub-chunks
    blob_off: np.ndarray    # (n_sub,) offset of each zlib blob
    blob_len: np.ndarray    # (n_sub,)
    local_ids: np.ndarray   # (n_rec,) int32, sub-chunk after sub-chunk
    parent_pos: np.ndarray  # (n_rec,) int32, -1 = stored raw
    lengths: np.ndarray     # (n_rec,) int32 true payload lengths
    singletons: bool        # every sub-chunk one record, stored raw


def _gather_i32(u8: np.ndarray, at: np.ndarray, k: int) -> np.ndarray:
    """The ``k`` little-endian int32 that start at each byte offset ``at``
    (offsets need no alignment): shape ``(len(at), k)``."""
    return u8[at[:, None] + np.arange(4 * k)].view("<i4")


def _walk(buf, off: int, n_sub: int, singletons: bool) -> np.ndarray:
    """The offset of each sub-chunk head, from the one before it: a
    singleton entry is ``20 + blob_len`` bytes, any entry ``8 + 12 n +
    blob_len``."""
    heads = []
    append = heads.append
    if singletons:
        blob_len = _U32.unpack_from
        for _ in range(n_sub):
            append(off)
            off += 20 + blob_len(buf, off + 4)[0]
    else:
        sub_head = _SUB_HEAD.unpack_from
        for _ in range(n_sub):
            append(off)
            n, blen = sub_head(buf, off)
            off += 8 + 12 * n + blen
    return np.array(heads, dtype=np.int64)


def _directory(buf, off: int, n_rec: int, n_sub: int) -> SubChunkDirectory:
    """The directory of the sub-chunks that start at ``off``.  Where the
    header counts as many sub-chunks as records, each is taken to be a
    singleton, whose columns sit at fixed offsets from its head (every k=1
    chunk); otherwise, or where a head says otherwise, the columns are
    gathered through the CSR of records over sub-chunks."""
    u8 = np.frombuffer(buf, dtype=np.uint8)
    if n_sub == n_rec:
        try:
            heads = _walk(buf, off, n_sub, True)
            ent = _gather_i32(u8, heads, 5)     # n, blob_len, id, parent, len
        except (struct.error, IndexError):      # walked off: a longer head
            ent = None
        # where every head reads n = 1, the general walk is this one
        if ent is not None and (ent[:, 0] == 1).all():
            return SubChunkDirectory(
                np.arange(n_sub + 1, dtype=np.int64), heads + 20,
                ent[:, 1].astype(np.int64), ent[:, 2], ent[:, 3], ent[:, 4],
                True)
    heads = _walk(buf, off, n_sub, False)
    hd = _gather_i32(u8, heads, 2).astype(np.int64)
    n, blen = hd[:, 0], hd[:, 1]
    sub_start = np.zeros(n_sub + 1, dtype=np.int64)
    np.cumsum(n, out=sub_start[1:])
    sub = np.repeat(np.arange(n_sub), n)
    # record j of sub-chunk s: its three columns 4 n_s bytes apart
    col0 = heads[sub] + 8 + 4 * (np.arange(n_rec) - sub_start[sub])
    at = (col0[:, None] + 4 * n[sub][:, None] * np.arange(3)).ravel()
    cols = _gather_i32(u8, at, 1).reshape(n_rec, 3)
    return SubChunkDirectory(sub_start, heads + 8 + 12 * n, blen,
                             cols[:, 0], cols[:, 1], cols[:, 2], False)


class StoredChunk:
    """One physical chunk: its records' composite keys and their payloads
    in sub-chunks.

    A chunk built on the write side holds its ``subchunks`` (what
    :meth:`to_bytes` encodes); a chunk parsed by :meth:`from_bytes` holds
    the fetched buffer and a :class:`SubChunkDirectory` over it, and builds
    ``subchunks`` from the directory only when asked.  Both decode through
    the directory of their encoding."""

    def __init__(self, chunk_id: int, cks: np.ndarray,
                 subchunks: Optional[List[SubChunkBlob]] = None,
                 raw_bytes: int = 0, stored_bytes: int = 0) -> None:
        self.chunk_id = chunk_id
        self.cks = cks                       # (n_rec,) packed composite keys
        self.raw_bytes = raw_bytes           # un-encoded payload bytes
        self.stored_bytes = stored_bytes     # encoded (what the KVS holds)
        self._subchunks = subchunks
        # memoized serialization: chunks are write-once, and the build paths
        # both size the encoding and stage it for the group commit; a parsed
        # chunk's is the buffer it was parsed from
        self._encoded = None
        self._dir: Optional[SubChunkDirectory] = None

    @property
    def subchunks(self) -> List[SubChunkBlob]:
        if self._subchunks is None:
            d, buf = self._dir, self._encoded
            ss = d.sub_start.tolist()
            ids, ppos, lens = (d.local_ids.tolist(), d.parent_pos.tolist(),
                               d.lengths.tolist())
            self._subchunks = [
                SubChunkBlob(tuple(ids[a:b]), tuple(ppos[a:b]),
                             tuple(lens[a:b]), bytes(buf[o:o + ln]))
                for a, b, o, ln in zip(ss, ss[1:], d.blob_off.tolist(),
                                       d.blob_len.tolist())]
        return self._subchunks

    def directory(self) -> SubChunkDirectory:
        if self._dir is None:
            buf = self.to_bytes()
            _, n_rec, n_sub = _HEAD.unpack_from(buf, 0)
            self._dir = _directory(buf, 12 + 8 * n_rec, n_rec, n_sub)
        return self._dir

    def payloads(self, device=None) -> Dict[int, bytes]:
        """Decode every record: local index -> payload bytes.

        Each zlib blob is read in place through the directory.  Delta
        parents precede their children within a sub-chunk (``parent_pos[i]
        < i``, tree order), so records decode level by level of the
        sub-chunk trees: one ``xor_delta_pairs`` call per level for the
        whole chunk.  Singleton sub-chunks (k=1) need none.

        Traced as one ``read.decode`` a chunk, its zlib pass one
        ``read.decode.inflate`` and its levels one ``read.decode.delta``;
        counts ``chunks_decoded`` and ``records_decoded``."""
        tr = trace.ACTIVE
        if tr is None:
            return self._decode(device, None)
        tr.add("chunks_decoded", 1)
        tr.add("records_decoded", len(self.cks))
        return tr.call("read.decode", self._decode, device, tr)

    def _decode(self, device, tr: Optional[trace.Tracer]
                ) -> Dict[int, bytes]:
        d = self.directory()
        decoded, levels = (self._inflate(d) if tr is None else
                           tr.call("read.decode.inflate", self._inflate, d))
        if levels:
            if tr is None:
                self._undelta(decoded, levels, device)
            else:
                tr.call("read.decode.delta", self._undelta, decoded, levels,
                        device)
        return dict(zip(d.local_ids.tolist(), decoded))

    def _inflate(self, d: SubChunkDirectory):
        """Each record as stored, raw ones decoded, in directory order; and
        by tree level, the delta-encoded ones: (records, their parents,
        their true lengths)."""
        mv = memoryview(self._encoded)
        raws = [zlib.decompress(mv[o:o + ln]) for o, ln in
                zip(d.blob_off.tolist(), d.blob_len.tolist())]
        got = np.fromiter(map(len, raws), dtype=np.int64, count=len(raws))
        if d.singletons:
            if np.array_equal(got, d.lengths):
                return raws, []
            return [r[:ln] for r, ln in zip(raws, d.lengths.tolist())], []
        ln = d.lengths.astype(np.int64)
        ppos = d.parent_pos
        n_rec = len(ln)
        sub = np.repeat(np.arange(len(raws)), np.diff(d.sub_start))
        has_p = ppos >= 0
        par = np.where(has_p, d.sub_start[sub] + ppos, np.arange(n_rec))
        # deltas are stored at the max(parent, child) length
        stored = np.where(has_p, np.maximum(ln, ln[par]), ln)
        start = np.cumsum(stored) - stored
        base = np.zeros(len(raws) + 1, dtype=np.int64)
        np.cumsum(got, out=base[1:])
        # each piece within its own sub-chunk's inflated bytes
        lo = base[sub] + start - start[d.sub_start[sub]]
        hi = np.minimum(lo + stored, base[sub + 1])
        lo = np.minimum(lo, hi)
        joined = b"".join(raws)
        decoded = [joined[a:b] for a, b in zip(lo.tolist(), hi.tolist())]
        # a tree level a pass; a sub-chunk of n records is at most n deep
        level = np.zeros(n_rec, dtype=np.int64)
        for _ in range(int(np.diff(d.sub_start).max(initial=0))):
            nxt = np.where(has_p, level[par] + 1, 0)
            if np.array_equal(nxt, level):
                break
            level = nxt
        levels = []
        for lvl in range(1, int(level.max(initial=0)) + 1):
            recs = np.flatnonzero(level == lvl)
            levels.append((recs.tolist(), par[recs].tolist(),
                           ln[recs].tolist()))
        return decoded, levels

    @staticmethod
    def _undelta(decoded, levels, device) -> None:
        """XOR each level's deltas onto their decoded parents, one
        ``xor_delta_pairs`` call a level, in place."""
        for recs, parents, lens in levels:
            pieces = [decoded[j] for j in recs]
            plain, _ = kops.xor_delta_pairs(
                [decoded[p].ljust(len(pc), b"\0")
                 for p, pc in zip(parents, pieces)], pieces, device=device)
            for j, ln, pl in zip(recs, lens, plain):
                decoded[j] = pl[:ln]

    # ------------------------------------------------------------ serialization
    def to_bytes(self) -> bytes:
        if self._encoded is None:
            parts = [_HEAD.pack(self.chunk_id, len(self.cks),
                                len(self.subchunks)),
                     self.cks.astype("<i8").tobytes()]
            for sc in self.subchunks:
                n = len(sc.local_ids)
                parts.append(_SUB_HEAD.pack(n, len(sc.blob)))
                parts.append(_sub_cols(n).pack(*sc.local_ids, *sc.parent_pos,
                                               *sc.lengths))
                parts.append(sc.blob)
            self._encoded = b"".join(parts)
        return self._encoded

    @staticmethod
    def from_bytes(buf: bytes) -> "StoredChunk":
        """The chunk ``buf`` encodes, read in place: its header, its keys
        and the directory of its sub-chunks (:func:`_directory`); ``buf``
        becomes its encoding.  Traced as ``read.parse.chunk``; counts
        ``subchunks_parsed``."""
        tr = trace.ACTIVE
        if tr is not None:
            tr.open("read.parse.chunk")
        try:
            cid, n_rec, n_sub = _HEAD.unpack_from(buf, 0)
            cks = np.frombuffer(buf, dtype="<i8", count=n_rec,
                                offset=12).astype(np.int64)
            d = _directory(buf, 12 + 8 * n_rec, n_rec, n_sub)
            sc = StoredChunk(chunk_id=cid, cks=cks, stored_bytes=len(buf),
                             raw_bytes=int(d.lengths.sum(dtype=np.int64)))
            sc._encoded = buf
            sc._dir = d
            if tr is not None:
                tr.add("subchunks_parsed", n_sub)
            return sc
        finally:
            if tr is not None:
                tr.close()


# -------------------------------------------------------------------- builder
@dataclass
class StagedChunk:
    """A chunk build's first pass: everything but its XOR deltas.

    Singleton chunks are finished here (``subs``).  Otherwise ``staged``
    holds each sub-chunk's ``(local ids, parent positions, lengths,
    pieces)``, a piece being a raw payload or the index of its delta in
    ``pair_parents``/``pair_children``, this chunk's delta pairs."""

    chunk_id: int
    cks: np.ndarray
    raw_bytes: int
    compress_level: int
    subs: Optional[List[SubChunkBlob]] = None
    staged: List[Tuple[Tuple[int, ...], List[int], List[int], List]] = \
        field(default_factory=list)
    pair_parents: List[bytes] = field(default_factory=list)
    pair_children: List[bytes] = field(default_factory=list)


def stage_chunk(graph: VersionGraph, record_ids: np.ndarray, chunk_id: int,
                subchunk_groups: Optional[List[np.ndarray]] = None,
                compress_level: int = 6) -> StagedChunk:
    """Pass 1 of :func:`build_chunk`: the sub-chunks and their delta pairs,
    which :func:`finish_chunk` turns into the stored chunk once the pairs
    are XORed (for many chunks in one ``xor_delta_pairs`` call)."""
    store = graph.store
    cks = store.cks[record_ids]
    has_payloads = store.has_payloads()

    def payload(r: int) -> bytes:
        return (store.payload(r) if has_payloads
                else b"\0" * int(store.sizes[r]))

    if subchunk_groups is None:
        # singleton sub-chunks: each record stored raw, compressed alone
        sizes = store.sizes[record_ids].tolist()
        subs = [SubChunkBlob((i,), (-1,), (sz,),
                             zlib.compress(payload(r), compress_level))
                for i, (r, sz) in enumerate(zip(record_ids.tolist(), sizes))]
        return StagedChunk(chunk_id, cks, sum(sizes), compress_level,
                           subs=subs)
    st = StagedChunk(chunk_id, cks, 0, compress_level)
    _stage_groups(graph, record_ids, subchunk_groups, payload, st)
    return st


def finish_chunk(st: StagedChunk, deltas: Sequence[bytes]) -> StoredChunk:
    """Pass 2 of :func:`build_chunk`: ``deltas[i]`` is the XOR of
    ``st``'s pair ``i``; each sub-chunk is compressed."""
    subs = st.subs
    if subs is None:
        subs = [SubChunkBlob(local, tuple(ppos), tuple(lens), zlib.compress(
                    b"".join(deltas[p] if isinstance(p, int) else p
                             for p in pieces), level=st.compress_level))
                for local, ppos, lens, pieces in st.staged]
    chunk = StoredChunk(chunk_id=st.chunk_id, cks=st.cks, subchunks=subs,
                        raw_bytes=st.raw_bytes)
    chunk.stored_bytes = len(chunk.to_bytes())
    return chunk


def build_chunk(graph: VersionGraph, record_ids: np.ndarray, chunk_id: int,
                vidx_of: Dict[int, int], n_versions: int,
                rec_versions_csr: Tuple[np.ndarray, np.ndarray],
                subchunk_groups: Optional[List[np.ndarray]] = None,
                compress_level: int = 6,
                device=None) -> Tuple[StoredChunk, ChunkMap]:
    """Assemble one physical chunk + its chunk map.

    ``subchunk_groups``: optional list of record-id arrays (each a connected
    same-primary-key group in sub-chunk tree order, §3.4); defaults to
    singleton groups.  Records absent from any group get singletons.  All
    of the chunk's (parent, child) delta pairs go through ONE
    ``xor_delta_pairs`` call; a build of many chunks stages them all
    (:func:`stage_chunk`) and XORs every pair in one call instead.
    """
    st = stage_chunk(graph, record_ids, chunk_id, subchunk_groups,
                     compress_level)
    deltas: List[bytes] = []
    if st.pair_parents:
        deltas, _ = kops.xor_delta_pairs(st.pair_parents, st.pair_children,
                                         device=device)
    return finish_chunk(st, deltas), build_chunk_map(
        graph, record_ids, n_versions, rec_versions_csr)


def build_chunk_map(graph: VersionGraph, record_ids: np.ndarray,
                    n_versions: int,
                    rec_versions_csr: Tuple[np.ndarray, np.ndarray]
                    ) -> ChunkMap:
    """The chunk map alone: a bitmap over version indices per record, in
    the chunk's stored record order (what a flush rewrites for old chunks
    its versions touched — their payload blobs do not change)."""
    W = (n_versions + 31) // 32
    bitmap = np.zeros((len(record_ids), W), dtype=np.uint32)
    indptr, vidxs = rec_versions_csr
    record_ids = np.asarray(record_ids)
    starts = indptr[record_ids]
    cnt = indptr[record_ids + 1] - starts
    rows = np.repeat(np.arange(len(record_ids)), cnt)
    pos = (np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
           + np.repeat(starts, cnt))
    vs = vidxs[pos]
    # bitwise_or.at: unbuffered — duplicate word indices must accumulate
    np.bitwise_or.at(bitmap, (rows, vs // 32),
                     np.uint32(1) << (vs % 32).astype(np.uint32))
    return ChunkMap(cks=graph.store.cks[record_ids], bitmap=bitmap,
                    n_versions=n_versions)


def _stage_groups(graph: VersionGraph, record_ids: np.ndarray,
                  subchunk_groups: List[np.ndarray], payload,
                  st: StagedChunk) -> None:
    """Sub-chunks of connected same-key groups (§3.4): each member after the
    first is XOR-delta'd against its in-group tree parent (a delta pair of
    ``st``); records in no group get singletons."""
    store = graph.store
    local_of = {int(r): i for i, r in enumerate(record_ids)}
    seen = set()
    groups: List[np.ndarray] = []
    for grp in subchunk_groups:
        groups.append(np.asarray(grp, dtype=np.int64))
        seen.update(int(g) for g in grp)
    for r in record_ids:
        if int(r) not in seen:
            groups.append(np.array([r], dtype=np.int64))

    # raw pieces, delta parent positions, and the delta pairs
    for grp, parents in zip(groups, _subchunk_parents(graph, groups)):
        rids = grp.tolist()
        local = tuple(local_of[r] for r in rids)
        lens = store.sizes[grp].tolist()
        payloads = [payload(r) for r in rids]
        st.raw_bytes += sum(lens)
        ppos = [-1] * len(rids)
        pos_of = {r: i for i, r in enumerate(rids)}
        pieces: List = []
        for i, par in enumerate(parents):
            if par is None or int(par) not in pos_of:
                pieces.append(payloads[i])
            else:
                pi = pos_of[int(par)]
                ppos[i] = pi
                w = max(len(payloads[pi]), len(payloads[i]))
                pieces.append(len(st.pair_parents))   # index of its delta
                st.pair_parents.append(payloads[pi].ljust(w, b"\0"))
                st.pair_children.append(payloads[i].ljust(w, b"\0"))
        st.staged.append((local, ppos, lens, pieces))


def _subchunk_parents(graph: VersionGraph, groups: List[np.ndarray]):
    """For each group, the delta-parent record id of each member (None = raw).
    Members are same-primary-key records connected in the version tree; the
    parent of record (K, Vc) is the record (K, Vp) live at the nearest proper
    ancestor of Vc — within the group, that is the group member whose origin
    version is the closest ancestor."""
    origins = graph.store.origin_versions()
    out = []
    for grp in groups:
        if len(grp) == 1:
            out.append([None])
            continue
        grp_origin = {int(origins[r]): int(r) for r in grp}
        parents: List[Optional[int]] = []
        for r in grp:
            v = int(origins[r])
            p = graph.tree_parent(v)
            found = None
            while p is not None:
                if p in grp_origin:
                    found = grp_origin[p]
                    break
                p = graph.tree_parent(p)
            parents.append(found)
        out.append(parents)
    return out
