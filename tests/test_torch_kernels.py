"""The port's kernel entry points against the reference package's.

On this CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels are held against those same plain versions on the card by
``chip_smoke.py``).  Inputs come from numpy with a seed and go through both
packages; the tolerance is exact equality, since these are integer kernels.
The reference's ``bitmap_vm`` Pallas body does not trace on the installed
JAX, so the VM is compared with ``ref.bitmap_vm_ref`` and
``ops.bitmap_vm_batch``; ``xor_delta``, ``minhash`` and ``and_popcount`` run
their Pallas bodies in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitmap as rbitmap
from repro.kernels import deltaenc as rdelta
from repro.kernels import minhash as rminhash
from repro.kernels import ops as rops
from repro.kernels import ref as rref

from repro_torch.kernels import bitmap as tbitmap
from repro_torch.kernels import deltaenc as tdelta
from repro_torch.kernels import minhash as tminhash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CPU = "cpu"


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _random_prog(rng, S: int, P: int) -> np.ndarray:
    prog = np.empty((P, 4), dtype=np.int32)
    prog[:, 0] = rng.integers(0, 3, size=P)
    prog[:, 1:] = rng.integers(0, S, size=(P, 3))
    return prog


# ---------------------------------------------------------------- xor delta
@pytest.mark.parametrize("N,W", [(128, 128), (256, 256), (384, 512), (7, 3)])
def test_xor_delta_matches_reference_kernel(N, W):
    rng = np.random.default_rng(N + W)
    p = rng.integers(0, 2**32, size=(N, W), dtype=np.uint32)
    c = rng.integers(0, 2**32, size=(N, W), dtype=np.uint32)
    c[::3] = p[::3]                                   # some all-zero rows
    Np = -(-N // 128) * 128
    pp = np.zeros((Np, W), np.uint32)
    cp = np.zeros((Np, W), np.uint32)
    pp[:N], cp[:N] = p, c
    rd, rc = rdelta.xor_delta(jnp.asarray(pp), jnp.asarray(cp), interpret=True)
    td, tc = tdelta.xor_delta(_t(p), _t(c))
    np.testing.assert_array_equal(_u(td), np.asarray(rd)[:N])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc)[:N])
    od, oc = tops.xor_delta_batch(p, c, device=CPU)
    np.testing.assert_array_equal(od, np.asarray(rd)[:N])
    np.testing.assert_array_equal(oc, np.asarray(rc)[:N])


@pytest.mark.parametrize("lp,lc", [(0, 0), (1, 7), (256, 256), (300, 13),
                                   (17, 64)])
def test_xor_delta_bytes_matches_reference(lp, lc):
    rng = np.random.default_rng(lp * 31 + lc)
    p = rng.integers(0, 256, lp, dtype=np.uint8).tobytes()
    c = rng.integers(0, 256, lc, dtype=np.uint8).tobytes()
    assert tops.xor_delta_bytes(p, c, device=CPU) == rops.xor_delta_bytes(p, c)
    # decode(parent, encode(parent, child)) == child, zero-padded
    w = max(lp, lc)
    d, _ = tops.xor_delta_bytes(p, c, device=CPU)
    back, _ = tops.xor_delta_bytes(p.ljust(w, b"\0"), d, device=CPU)
    assert back == c.ljust(w, b"\0")


# Row lengths (words) of the ragged kernel's cases: 64-word records with
# lengths that are not a multiple of 4 words, zero-length rows, one word a
# row, one very long row among short ones, all rows empty, no row at all.
RAGGED = {"mixed": [64, 0, 3, 5, 64, 1, 7, 130, 0, 4, 65, 63, 2],
          "one_word": [1] * 37,
          "long_row": [5, 3, 20_001, 7, 64, 0],
          "all_empty": [0, 0, 0],
          "no_rows": []}


def _ragged(case, seed):
    """Flat uint32 parent/child words and the CSR of word offsets; about a
    third of the child's words equal the parent's, and so does every third
    row."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(RAGGED[case], dtype=np.int64)
    off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    total = int(off[-1])
    p = rng.integers(0, 2**32, size=total, dtype=np.uint32)
    c = rng.integers(0, 2**32, size=total, dtype=np.uint32)
    same = rng.random(total) < 0.3
    c[same] = p[same]
    for r in range(0, len(lens), 3):
        c[off[r]:off[r + 1]] = p[off[r]:off[r + 1]]
    return p, c, off


@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("case", list(RAGGED))
def test_xor_delta_ragged_matches_reference_row_by_row(case, shift):
    """The ragged entry's plain version against ``repro.kernels.ref
    .xor_delta_ref`` row by row; and the same call on (parent, delta)
    decodes the child (the XOR is an involution), counting its nonzero
    words."""
    p, c, off = _ragged(case, seed=len(RAGGED[case]) * 7 + shift)
    tp, tc, toff = _t(p), _t(c), torch.from_numpy(off)
    if shift:
        # the same words in views ``shift`` words into their storage
        tp, tc = (torch.cat([torch.zeros(shift, dtype=t.dtype), t])[shift:]
                  for t in (tp, tc))
        assert tp.storage_offset() == tc.storage_offset() == shift
    td, tn = tdelta.xor_delta_ragged(tp, tc, toff)
    assert td.shape == tp.shape and tn.shape == (len(off) - 1,)
    assert tn.dtype == torch.int32
    for r in range(len(off) - 1):
        lo, hi = int(off[r]), int(off[r + 1])
        rd, rn = rref.xor_delta_ref(jnp.asarray(p[None, lo:hi]),
                                    jnp.asarray(c[None, lo:hi]))
        np.testing.assert_array_equal(_u(td)[lo:hi], np.asarray(rd)[0])
        assert int(tn[r]) == int(np.asarray(rn)[0])
    back, bn = tdelta.xor_delta_ragged(tp, td, toff)
    np.testing.assert_array_equal(_u(back), c)
    np.testing.assert_array_equal(
        bn.numpy(), [np.count_nonzero(c[off[r]:off[r + 1]])
                     for r in range(len(off) - 1)])


def test_xor_delta_ragged_bad_inputs_raise():
    w = torch.zeros(8, dtype=torch.int32)
    off = torch.tensor([0, 3, 8])
    with pytest.raises(ValueError, match="equal"):
        tdelta.xor_delta_ragged(w, w[:7], off)
    with pytest.raises(ValueError, match="int32"):
        tdelta.xor_delta_ragged(w.long(), w.long(), off)
    with pytest.raises(ValueError, match="row_off"):
        tdelta.xor_delta_ragged(w, w, off.int())
    with pytest.raises(ValueError, match="row_off"):
        tdelta.xor_delta_ragged(w, w, torch.zeros(0, dtype=torch.int64))


@pytest.mark.parametrize("lens", [
    [256, 256, 0, 5, 64, 256, 131],      # mixed byte lengths, one empty
    [256] * 9,                           # whole words: no padding
    [1, 2, 3, 4, 5, 6, 7],               # each pair shorter than a vector
    [4 * 20_001 + 3, 12, 0]])            # one very long pair
def test_xor_delta_pairs_equals_per_pair_bytes(monkeypatch, lens):
    rng = np.random.default_rng(sum(lens) + len(lens))
    parents = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    children = [bytes(x ^ (i % 3 == 0) * 0xFF for x in p)
                for i, p in enumerate(parents)]
    want = [rops.xor_delta_bytes(p, c) for p, c in zip(parents, children)]
    # one launch, and split into several by the memory bound
    for cap in (tops.PAIRS_MAX_BYTES, 512):
        monkeypatch.setattr(tops, "PAIRS_MAX_BYTES", cap)
        d, cnt = tops.xor_delta_pairs(parents, children, device=CPU)
        assert list(zip(d, cnt.tolist())) == want
    with pytest.raises(ValueError, match="pair 1"):
        tops.xor_delta_pairs([b"ab", b"abc"], [b"xy", b"x"], device=CPU)


def test_xor_delta_identical_is_zero():
    p = np.arange(256 * 64, dtype=np.uint32).reshape(256, 64)
    d, cnt = tops.xor_delta_batch(p, p, device=CPU)
    assert (d == 0).all() and (cnt == 0).all()


# ---------------------------------------------------------------- bitmap VM
@pytest.mark.parametrize("S,W,P", [(128, 128, 8), (128, 256, 32), (256, 128, 1),
                                   (5, 7, 0), (40, 300, 2000)])
def test_bitmap_vm_matches_reference(S, W, P):
    rng = np.random.default_rng(S * 13 + W + P)
    regs = rng.integers(0, 2**32, size=(S, W), dtype=np.uint32)
    prog = _random_prog(rng, S, P)
    bo, bc = rops.bitmap_vm_batch(regs, prog)
    if P:   # the reference's plain version traces only a non-empty program
        ro, rc = rref.bitmap_vm_ref(jnp.asarray(regs), jnp.asarray(prog))
        np.testing.assert_array_equal(bo, np.asarray(ro))
        np.testing.assert_array_equal(bc, np.asarray(rc))
    to, tc = tbitmap.bitmap_vm(_t(regs), torch.from_numpy(prog))
    np.testing.assert_array_equal(_u(to), bo)
    np.testing.assert_array_equal(tc.numpy(), bc)
    oo, oc = tops.bitmap_vm_batch(regs, prog, device=CPU)
    np.testing.assert_array_equal(oo, bo)
    np.testing.assert_array_equal(oc, bc)


@pytest.mark.parametrize("op", [tbitmap.OP_AND, tbitmap.OP_OR,
                                tbitmap.OP_ANDNOT])
def test_bitmap_vm_each_op_exact(op):
    rng = np.random.default_rng(40 + op)
    regs = rng.integers(0, 2**32, size=(4, 9), dtype=np.uint32)
    prog = np.array([[op, 3, 0, 1]], dtype=np.int32)
    out, cnt = tops.bitmap_vm_batch(regs, prog, device=CPU)
    a, b = regs[0], regs[1]
    want = a & b if op == 0 else (a | b if op == 1 else a & ~b)
    np.testing.assert_array_equal(out[3], want)
    np.testing.assert_array_equal(out[:3], regs[:3])
    np.testing.assert_array_equal(
        cnt, [sum(bin(int(x)).count("1") for x in r) for r in out])


def test_bitmap_vm_all_zero_bitmaps():
    regs = np.zeros((6, 11), dtype=np.uint32)
    prog = np.array([[tbitmap.OP_OR, 4, 0, 1],
                     [tbitmap.OP_ANDNOT, 5, 2, 3]], dtype=np.int32)
    out, cnt = tops.bitmap_vm_batch(regs, prog, device=CPU)
    assert (out == 0).all() and (cnt == 0).all()


def test_bitmap_vm_operand_out_of_range_raises():
    regs = np.zeros((4, 4), dtype=np.uint32)
    with pytest.raises(ValueError, match="out of range"):
        tops.bitmap_vm_batch(regs, np.array([[0, 4, 0, 1]], dtype=np.int32),
                             device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        tops.bitmap_vm_batch(regs, np.array([[0, 0, -1, 1]], dtype=np.int32),
                             device=CPU)


def test_bitmap_vm_counts_one_launch_per_call():
    regs = np.ones((3, 3), dtype=np.uint32)
    before = tops.BITMAP_LAUNCHES
    tops.bitmap_vm_batch(regs, np.zeros((0, 4), dtype=np.int32), device=CPU)
    tops.bitmap_vm_batch(regs, np.array([[1, 2, 0, 1]] * 5, np.int32),
                         device=CPU)
    assert tops.BITMAP_LAUNCHES - before == 2
    # the CUDA kernels' own counters move only where a kernel launched
    assert tbitmap.LAUNCHES == tdelta.LAUNCHES == 0
    assert tbitmap.AND_LAUNCHES == tminhash.LAUNCHES == 0


def test_popcount_swar_exact():
    v = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x55555555, 0x12345678],
                 dtype=np.uint32)
    got = tref.popcount32_ref(_t(v)).numpy()
    np.testing.assert_array_equal(got, [bin(int(x)).count("1") for x in v])
    np.testing.assert_array_equal(
        got, np.asarray(rref.popcount32_ref(jnp.asarray(v))))


# ------------------------------------------------------------------ minhash
def _csr(rows):
    indptr = np.cumsum([0] + [len(r) for r in rows]).astype(np.int64)
    col = np.asarray([v for r in rows for v in r], dtype=np.int64)
    return indptr, col


def _padded_to_csr(vers: np.ndarray):
    R, D = vers.shape
    return (np.arange(R + 1, dtype=np.int64) * D,
            vers.reshape(-1).astype(np.int32))


@pytest.mark.parametrize("R,D,L", [(128, 128, 1), (256, 128, 8),
                                   (128, 384, 16), (128, 128, 40)])
def test_minhash_matches_reference_kernel(R, D, L):
    rng = np.random.default_rng(R * 1000 + D + L)
    vers = rng.integers(0, 10_000, size=(R, D)).astype(np.int32)
    vers[rng.random((R, D)) < 0.4] = -1
    vers[5] = -1                                      # an empty row
    a, b = rops.hash_family(L, seed=7)
    want = np.asarray(rminhash.minhash(jnp.asarray(vers), jnp.asarray(a),
                                       jnp.asarray(b), interpret=True))
    np.testing.assert_array_equal(
        _u(tref.minhash_ref(_t(vers), _t(a), _t(b))), want)
    ptr, col = _padded_to_csr(vers)
    got = tminhash.minhash(torch.from_numpy(ptr), torch.from_numpy(col),
                           _t(a), _t(b))
    np.testing.assert_array_equal(_u(got), want)
    np.testing.assert_array_equal(tops.minhash_padded(vers, a, b, device=CPU),
                                  want.T)
    np.testing.assert_array_equal(rops.minhash_padded(vers, a, b), want.T)


def _minhash_cases():
    rng = np.random.default_rng(21)
    ragged = [rng.integers(0, 2**20, int(rng.integers(0, 40))).tolist()
              for _ in range(300)]
    ragged[3] = ragged[77] = []
    a8, b8 = rops.hash_family(8, 1)
    # a = 1 with b >= 2^31: every hash of a small entry is >= 2^31, so a
    # signed min would return the wrong word; large entries with odd a wrap
    # mod 2^32 (entries >= 2^31 / a)
    a_hi = np.array([1, 3, 0x9E3779B1], dtype=np.uint32)
    b_hi = np.array([2**31 + 5, 2**32 - 100, 2**31], dtype=np.uint32)
    big = [rng.integers(2**30, 2**31 - 1, 20).tolist() for _ in range(50)]
    return {
        "ragged": (*_csr(ragged), a8, b8),
        "empty_rows": (*_csr([[], [], [4, 4], []]), a8, b8),
        "R=0": (np.zeros(1, np.int64), np.zeros(0, np.int64), a8, b8),
        "high_hashes": (*_csr([[0, 1, 2], [7], [2**31 - 1]] + big), a_hi,
                        b_hi),
        "skips_pad": (*_csr([[5, -1, 9], [-1, -1], [-1]]), a8, b8),
    }


@pytest.mark.parametrize("case", ["ragged", "empty_rows", "R=0",
                                  "high_hashes", "skips_pad"])
def test_minhash_csr_matches_reference(case):
    indptr, col, a, b = _minhash_cases()[case]
    want = rops.minhash_csr(indptr, col, a, b)
    if len(indptr) > 1:     # the Pallas body, in interpret mode
        np.testing.assert_array_equal(
            rops.minhash_csr(indptr, col, a, b, force_kernel=True), want)
    got = tops.minhash_csr(indptr, col, a, b, device=CPU)
    assert got.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    plain = tref.minhash_csr_ref(torch.from_numpy(indptr),
                                 torch.from_numpy(col.astype(np.int32)),
                                 _t(a), _t(b))
    np.testing.assert_array_equal(_u(plain).T, want)
    # and a plain Python min over each row's set
    for i in range(len(indptr) - 1):
        row = {int(v) for v in col[indptr[i]:indptr[i + 1]] if v != -1}
        for l in range(len(a)):
            assert got[i, l] == min(
                ((int(a[l]) * (v & 0xFFFFFFFF) + int(b[l])) & 0xFFFFFFFF
                 for v in row), default=0xFFFFFFFF)


def test_minhash_high_hashes_are_unsigned():
    indptr, col, a, b = _minhash_cases()["high_hashes"]
    got = tops.minhash_csr(indptr, col, a, b, device=CPU)
    # a = 1, b = 2^31 + 5: the mins of the first rows are >= 2^31 ...
    np.testing.assert_array_equal(got[:2, 0], [2**31 + 5, 2**31 + 12])
    # ... and 2^31 - 1 + b wraps past 2^32
    assert got[2, 0] == 4


def test_hash_family_is_the_reference_family():
    for n, seed in ((8, 0), (3, 5), (40, 1)):
        for x, y in zip(tops.hash_family(n, seed), rops.hash_family(n, seed)):
            assert x.dtype == y.dtype == np.uint32
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- and_popcount
@pytest.mark.parametrize("N,W,pairwise", [(128, 128, False), (256, 256, True),
                                          (128, 33, True), (128, 7, False),
                                          (128, 513, True), (128, 513, False)])
def test_and_popcount_matches_reference_kernel(N, W, pairwise):
    rng = np.random.default_rng(N * 7 + W + pairwise)
    bms = rng.integers(0, 2**32, size=(N, W), dtype=np.uint32)
    row = rng.integers(0, 2**32, size=(N if pairwise else 1, W),
                       dtype=np.uint32)
    bms[::5] = 0
    ra, rc = rbitmap.and_popcount(jnp.asarray(bms), jnp.asarray(row),
                                  interpret=True)
    ra, rc = np.asarray(ra), np.asarray(rc)
    ta, tc = tbitmap.and_popcount(_t(bms), _t(row))
    np.testing.assert_array_equal(_u(ta), ra)
    np.testing.assert_array_equal(tc.numpy(), rc)
    pa, pc = tref.and_popcount_ref(_t(bms), _t(row))
    np.testing.assert_array_equal(_u(pa), ra)
    np.testing.assert_array_equal(pc.numpy(), rc)
    oa, oc = tops.and_popcount_batch(bms, row, device=CPU)
    np.testing.assert_array_equal(oa, ra)
    np.testing.assert_array_equal(oc, rc)
    assert oc.dtype == rc.dtype == np.int32


@pytest.mark.parametrize("N,W,row_rows", [(5, 9, None), (5, 9, 1), (5, 9, 5),
                                          (1, 4, 1), (0, 4, None),
                                          (3, 0, 3)])
def test_and_popcount_batch_row_shapes(N, W, row_rows):
    """(W,), (1, W) and (N, W) rows, N = 1, N = 0 and W = 0, each one
    BITMAP_LAUNCHES, with the reference's results."""
    rng = np.random.default_rng(N * 10 + W)
    bms = rng.integers(0, 2**32, size=(N, W), dtype=np.uint32)
    shape = (W,) if row_rows is None else (row_rows, W)
    row = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    r0, t0 = rops.BITMAP_LAUNCHES, tops.BITMAP_LAUNCHES
    ra, rc = rops.and_popcount_batch(bms, row)
    ta, tc = tops.and_popcount_batch(bms, row, device=CPU)
    assert rops.BITMAP_LAUNCHES - r0 == tops.BITMAP_LAUNCHES - t0 == 1
    np.testing.assert_array_equal(ta, ra)
    np.testing.assert_array_equal(tc, rc)
    assert ta.shape == (N, W) and tc.shape == (N,)


def test_and_popcount_batch_bad_row_raises():
    bms = np.zeros((4, 6), np.uint32)
    for row in (np.zeros((2, 6), np.uint32), np.zeros(5, np.uint32)):
        with pytest.raises(ValueError, match="row must be"):
            rops.and_popcount_batch(bms, row)
        with pytest.raises(ValueError, match="row must be"):
            tops.and_popcount_batch(bms, row, device=CPU)


# ------------------------------- the chip run's edge cases on the plain path
@pytest.mark.parametrize("case", ["skewed", "R=1"])
def test_minhash_plain_edge_cases_match_reference(case):
    """The shapes the chip run holds the kernel at that no test above
    covers, small enough for the reference: a long row among short ones,
    and one row."""
    rng = np.random.default_rng(5)
    L = 8
    if case == "R=1":
        rows = [rng.integers(0, 64, 30).tolist()]
    else:
        rows = [rng.integers(0, 64, int(rng.integers(0, 4))).tolist()
                for _ in range(200)]
        if case == "skewed":
            rows[77] = rng.integers(0, 2**31 - 1, 5000).tolist()
    indptr, col = _csr(rows)
    a, b = rops.hash_family(L, seed=3)
    want = rops.minhash_csr(indptr, col, a, b)
    np.testing.assert_array_equal(
        tops.minhash_csr(indptr, col, a, b, device=CPU), want)


@pytest.mark.parametrize("S,W,P", [(6, 1, 5), (33, 33, 40), (17, 511, 1500)])
def test_bitmap_vm_plain_edge_cases_match_reference(S, W, P):
    """W = 1, 33 and 511, P = 1500 (three program tiles of the kernel), and
    instructions whose dst is their own lhs or rhs."""
    rng = np.random.default_rng(S + W + P)
    regs = rng.integers(0, 2**32, size=(S, W), dtype=np.uint32)
    prog = _random_prog(rng, S, P)
    prog[::3, 1] = prog[::3, 2]         # dst == lhs
    prog[1::3, 1] = prog[1::3, 3]       # dst == rhs
    ro, rc = rref.bitmap_vm_ref(jnp.asarray(regs), jnp.asarray(prog))
    to, tc = tops.bitmap_vm_batch(regs, prog, device=CPU)
    np.testing.assert_array_equal(to, np.asarray(ro))
    np.testing.assert_array_equal(tc, np.asarray(rc))
