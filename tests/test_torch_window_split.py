"""The arithmetic of ``csrc/window_apply.cu``'s 3xTF32 split, in numpy.

The kernel splits x = hi + lo on a grid per column and k-step of 8 (W per
row and k-step), so that each k-step's hi·hi sums are exact on tensor
cores that round toward zero, and takes x W = x_hi W_hi + x_hi W_lo +
x_lo tf32(W).  These tests replay that arithmetic with float32 numpy
operations: the sums are exactly representable in float32, and the whole
product stays within the kernel's float64 limit (chip_smoke.py's F64_TOL,
2e-6) at every window width.

The reduced dot modes (``bf16_3x``, ``bf16``) take the same tile with
BF16 products of the reference's plain split, hi = bf16(x) rounded to
nearest even, lo = bf16(x − hi), no grid.  Their replays below fix, before
any CUDA is written, what each variant may be held to: its packing of a
lane's two k of a k-step into one BF16 pair (whatever order ``k_of`` gives
them), its error against float64 (chip_smoke.py: 2e-5 for bf16_3x, 1e-2
for bf16), against its plain version's float64-summed model (the tensor
cores' sums, rounded toward zero, cost less than 1e-5), and the norm drift
those truncating sums cause pass after pass.

The reduced modes' window kernel (``csrc/window_bf16.cuh``) takes W as the
A operand of ``mma.sync.m16n8k16``, pre-split once per block, and sums
each k16-step's hi·hi products on the tensor cores; its replays below fix
its fragment map, its limits and its drift against the k8 tile's, and
the order of products of the reduced FMA window (D <= 4) against
``window_apply_ref``.

The f32 window at D = 128 (``csrc/window_wg.cuh``) runs the same split on
``wgmma`` m64n128k8 products from shared memory: ``wg_product`` replays it
with the parts read back through the stage's layout, each k-step's exact
and cross sums added to nearest, and holds it to float64, to float32
products, to ``window_apply_ref`` and to the mma.sync tile's truncation.

    PYTHONPATH=. python3 tests/test_torch_window_split.py

prints the emulated relative L2 error against float64 at D = 8..128
beside that of plain float32 products, in every mode, and the bf16_3x
drift of the brickwork that the split W predicts at 15-26 qubits.
"""
from __future__ import annotations

import numpy as np
import pytest

F32 = np.float32
F64_TOL = 2e-6


def _bits(x):
    return np.asarray(x, F32).view(np.uint32)


def _tf32(x):
    """Round to tf32 as the kernel does: add half a unit, clear 13 bits."""
    b = (_bits(x).astype(np.uint64) + 0x1000) & 0xFFFFE000
    return b.astype(np.uint32).view(F32)


def _grid(amax):
    """The kernel's grid_of: 1.5 · 2^(E + 13) for magnitudes below 2^E."""
    e = _bits(amax) >> 23
    return (((e + 14) << 23) | 0x400000).astype(np.uint32).view(F32)


def _split(x, m):
    hi = ((x + m).astype(F32) - m).astype(F32)
    return hi, _tf32((x - hi).astype(F32))


def _bf16(x):
    """Round float32 to bf16, to nearest even (cvt.rn.bf16x2.f32)."""
    b = _bits(x).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(F32)


def _split_bf16(x):
    """x = hi + lo as the reduced modes split it: hi = bf16(x), lo =
    bf16(x - hi)."""
    hi = _bf16(x)
    return hi, _bf16((np.asarray(x, F32) - hi).astype(F32))


def _unitary(d, rng):
    q, r = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def emulate(d: int, cols: int = 1024, seed: int = 0):
    """(kernel's relative L2 error vs float64, plain float32's, every
    k-step's hi·hi sums exact) for a random unitary window on random
    columns."""
    rng = np.random.default_rng(seed)
    u = _unitary(d, rng)
    wr, wi = u.real.astype(F32), u.imag.astype(F32)
    x = rng.normal(size=(d, cols)) + 1j * rng.normal(size=(d, cols))
    x *= np.exp(rng.normal(size=(d, cols)))      # amplitudes of many sizes
    xr, xi = x.real.astype(F32), x.imag.astype(F32)
    f64 = np.float64
    want = (wr.astype(f64) + 1j * wi) @ (xr.astype(f64) + 1j * xi)
    acc = [np.zeros((d, cols), F32), np.zeros((d, cols), F32)]
    exact = True
    for k in range(d // 8):
        s = slice(8 * k, 8 * k + 8)
        mx = _grid(np.maximum(abs(xr[s]), abs(xi[s])).max(0))[None, :]
        mw = _grid(np.maximum(abs(wr[:, s]), abs(wi[:, s])).max(1))[:, None]
        xrh, xrl = (a.astype(f64) for a in _split(xr[s], mx))
        xih, xil = (a.astype(f64) for a in _split(xi[s], mx))
        wrh, wrl = (a.astype(f64) for a in _split(wr[:, s], mw))
        wih, wil = (a.astype(f64) for a in _split(wi[:, s], mw))
        wrt, wit = (_tf32(a).astype(f64) for a in (wr[:, s], wi[:, s]))
        # x W = x_hi W_hi + x_hi W_lo + x_lo tf32(W)
        sums = [wrh @ xrh - wih @ xih, wih @ xrh + wrh @ xih]
        cross = [wrl @ xrh + wrt @ xrl - wil @ xih - wit @ xil,
                 wil @ xrh + wit @ xrl + wrl @ xih + wrt @ xil]
        for p in range(2):
            exact &= bool(np.all(sums[p].astype(F32) == sums[p]))
            acc[p] = (acc[p] + sums[p].astype(F32)).astype(F32)
            acc[p] = (acc[p] + cross[p].astype(F32)).astype(F32)
    got = acc[0].astype(f64) + 1j * acc[1]
    plain = (wr @ xr - wi @ xi).astype(f64) + 1j * (wr @ xi + wi @ xr)

    def rel(a):
        return float(np.linalg.norm(a - want) / np.linalg.norm(want))
    return rel(got), rel(plain), exact


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
def test_split_sums_are_exact_and_within_f64_limit(d):
    err, _, exact = emulate(d)
    assert exact
    assert err <= F64_TOL


def test_grid_hi_parts_are_tf32():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(8, 64)) * np.exp(4 * rng.normal(size=(8, 64)))
         ).astype(F32)
    hi, lo = _split(x, _grid(np.abs(x).max(0))[None, :])
    assert np.all(_bits(hi) & 0x1FFF == 0)
    assert np.all(_bits(lo) & 0x1FFF == 0)
    # x - hi - lo is below 2^-22 of the column's largest magnitude
    err = np.abs(x.astype(np.float64) - hi - lo).max(0)
    assert np.all(err <= np.abs(x).max(0) * 2.0**-21)


# ---------------------------------------------------------------------------
# the reduced modes: BF16 products of the plain split
# ---------------------------------------------------------------------------

STAGE = 16      # k per cp.async stage: the cross terms' sums on the cores
F64 = np.float64
BF16_F64_TOL = {"bf16_3x": 2e-5, "bf16": 1e-2}


def _rz(x):
    """float64 → float32 rounded toward zero, as the tensor cores round."""
    f = x.astype(F32)
    over = np.abs(f.astype(F64)) > np.abs(x)
    return np.where(over, np.nextafter(f, F32(0)), f).astype(F32)


def _mm(a, b):
    """Σ_k a[c, k] b[n, k], in float64."""
    return a.astype(F64) @ b.astype(F64).T


def tc_product_bf16(xr, xi, wr, wi, mode, rounding=_rz):
    """(out_r, out_i) of out[c, n] = Σ_k x[c, k] W[n, k], complex, as the
    tile computes it in a reduced mode: x (C, K) and W (N, K) float32
    planes split into bf16 parts; each k-step's hi·hi sum of both planes
    on the tensor cores (two mma, ``rounding`` after each), added to the
    float32 accumulators to nearest; bf16_3x's cross terms x_hi W_lo +
    x_lo W_hi summed over a stage on the tensor cores, then added."""
    (xrh, xrl), (xih, xil) = _split_bf16(xr), _split_bf16(xi)
    (wrh, wrl), (wih, wil) = _split_bf16(wr), _split_bf16(wi)
    K = xr.shape[1]
    acc = [np.zeros((xr.shape[0], wr.shape[0]), F32) for _ in range(2)]
    for k0 in range(0, K, min(K, STAGE)):
        cross = [np.zeros_like(acc[0]), np.zeros_like(acc[1])]
        for ks in range(k0, k0 + min(K, STAGE), 8):
            s = slice(ks, ks + 8)
            plan = (([(xrh, wrh), (-xih, wih)],
                     [(xrh, wrl), (xrl, wrh), (-xih, wil), (-xil, wih)]),
                    ([(xrh, wih), (xih, wrh)],
                     [(xrh, wil), (xrl, wih), (xih, wrl), (xil, wrh)]))
            for p, (hi, lo) in enumerate(plan):
                e = np.zeros_like(acc[p], F64)
                for a, b in hi:
                    e = rounding(e + _mm(a[:, s], b[:, s])).astype(F64)
                acc[p] = (acc[p] + e.astype(F32)).astype(F32)
                if mode == "bf16_3x":
                    for a, b in lo:
                        cross[p] = rounding(cross[p].astype(F64)
                                            + _mm(a[:, s], b[:, s]))
        for p in range(2):
            acc[p] = (acc[p] + cross[p]).astype(F32)
    return acc[0], acc[1]


def plain_model_bf16(xr, xi, wr, wi, mode):
    """The plain version's products in a reduced mode, summed in float64:
    hi·hi (+ hi·lo + lo·hi for bf16_3x) of the same split."""
    (xrh, xrl), (xih, xil) = _split_bf16(xr), _split_bf16(xi)
    (wrh, wrl), (wih, wil) = _split_bf16(wr), _split_bf16(wi)
    terms = [((xrh, xih), (wrh, wih))]
    if mode == "bf16_3x":
        terms += [((xrh, xih), (wrl, wil)), ((xrl, xil), (wrh, wih))]
    out_r = sum(_mm(a, c) - _mm(b, d) for (a, b), (c, d) in terms)
    out_i = sum(_mm(a, d) + _mm(b, c) for (a, b), (c, d) in terms)
    return out_r, out_i


def _columns(d, cols, rng):
    x = rng.normal(size=(cols, d)) + 1j * rng.normal(size=(cols, d))
    x *= np.exp(rng.normal(size=(cols, d)))      # amplitudes of many sizes
    return x.real.astype(F32), x.imag.astype(F32)


def emulate_bf16(d: int, mode: str, cols: int = 512, seed: int = 0):
    """(kernel's relative L2 error vs float64, vs its plain version's
    model) for a random unitary window on random columns."""
    rng = np.random.default_rng(seed)
    u = _unitary(d, rng)
    wr, wi = u.real.astype(F32), u.imag.astype(F32)
    xr, xi = _columns(d, cols, rng)
    want = (xr.astype(F64) + 1j * xi) @ (wr.astype(F64) + 1j * wi).T
    gr, gi = tc_product_bf16(xr, xi, wr, wi, mode)
    got = gr.astype(F64) + 1j * gi
    pr, pi = plain_model_bf16(xr, xi, wr, wi, mode)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return rel(got, want), rel(got, pr + 1j * pi)


@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
def test_bf16_tile_within_its_limits(d, mode):
    err, vs_plain = emulate_bf16(d, mode, seed=d)
    assert err <= BF16_F64_TOL[mode]
    assert vs_plain <= 1e-5


def test_bf16_split_is_round_to_nearest_even():
    x = np.array([1 + 2**-8, 1 + 3 * 2**-8, 1 + 2**-8 + 2**-20, -(2.0**-130),
                  65504.0, 1.0 - 2**-24], F32)
    np.testing.assert_array_equal(
        _bf16(x), np.array([1.0, 1 + 2**-6, 1 + 2**-7, -(2.0**-130), 65536.0,
                            1.0], F32))
    rng = np.random.default_rng(3)
    x = (rng.normal(size=4096) * np.exp(4 * rng.normal(size=4096))
         ).astype(F32)
    hi, lo = _split_bf16(x)
    assert np.all(_bits(hi) & 0xFFFF == 0) and np.all(_bits(lo) & 0xFFFF == 0)
    # x - hi is exact in float32, and hi + lo keeps 2^-17 of x
    assert np.all((x - hi).astype(F64) == x.astype(F64) - hi.astype(F64))
    assert np.all(np.abs(x.astype(F64) - hi - lo) <= np.abs(x) * 2.0**-17)


@pytest.mark.parametrize("paired", [False, True])
def test_bf16_fragments_pack_a_lanes_two_k(paired):
    """The BF16 m16n8k8 fragment of lane (g, t) holds k slots 2t, 2t + 1:
    A registers (e0 | e2 << 16) and (e1 | e3 << 16), B (b0 | b1 << 16).
    With the tile's elements at k = k_of(t, e) in either order, the mma's
    slot sum is the product over j."""
    rng = np.random.default_rng(int(paired))
    a = _bf16(rng.normal(size=(16, 8)).astype(F32)).astype(F64)
    b = _bf16(rng.normal(size=(8, 8)).astype(F32)).astype(F64)  # [k][n]

    def k_of(t, e):
        return 2 * t + (e >> 1) if paired else t + 4 * (e >> 1)

    slot_a, slot_b = np.zeros((16, 8)), np.zeros((8, 8))
    for g in range(8):
        for t in range(4):
            e = [a[g + 8 * (i & 1), k_of(t, i)] for i in range(4)]
            regs = [(e[0], e[2]), (e[1], e[3])]       # (low, high) halves
            for r, (lo, hi) in enumerate(regs):
                slot_a[g + 8 * r, 2 * t], slot_a[g + 8 * r, 2 * t + 1] = lo, hi
            slot_b[2 * t, g] = b[k_of(t, 0), g]
            slot_b[2 * t + 1, g] = b[k_of(t, 2), g]
    np.testing.assert_array_equal(slot_a @ slot_b, a @ b)


def drift(d: int, mode: str, passes: int, rounding, seed: int = 0,
          cols: int = 256, product=tc_product_bf16):
    """The norm of random columns after ``passes`` applications of one
    random unitary window through the replayed tile (``product``: the k8
    tile, or the k16 kernel of the reduced windows)."""
    rng = np.random.default_rng(seed)
    u = _unitary(d, rng)
    wr, wi = u.real.astype(F32), u.imag.astype(F32)
    xr, xi = _columns(d, cols, rng)
    n0 = np.linalg.norm(xr.astype(F64)) ** 2 + np.linalg.norm(xi) ** 2
    for _ in range(passes):
        xr, xi = product(xr, xi, wr, wi, mode, rounding)
    return (np.linalg.norm(xr.astype(F64)) ** 2
            + np.linalg.norm(xi.astype(F64)) ** 2) / n0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_truncating_sums_shrink_the_norm(seed):
    """Sums rounded toward zero shrink the state pass after pass, against
    round-to-nearest sums of the same products: part of the norm drift of
    the reduced modes on the card, and why renorm_every exists.  (The split
    W is not exactly unitary either: repeating one W moves the norm by its
    own, of either sign, in both roundings.)"""
    def rn(x):
        return x.astype(F32)

    extra = drift(64, "bf16_3x", 16, rn, seed) - drift(64, "bf16_3x", 16,
                                                          _rz, seed)
    assert 1e-8 < extra < 1e-5


# ---------------------------------------------------------------------------
# the reduced modes' window kernel (csrc/window_bf16.cuh): m16n8k16, W the
# A operand, pre-split once per block
# ---------------------------------------------------------------------------

def w_fragment_word(d: int, mt: int, ks: int, lane: int, r: int):
    """(row, j) of the low half of word r of lane ``lane``'s A fragment of
    m-tile ``mt`` and k16-step ``ks``, as window_bf16.cuh's prologue writes
    it (the high half holds j + 4), or None where the word is zero."""
    g, t = lane >> 2, lane & 3
    row, j = 16 * mt + g + 8 * (r & 1), 16 * ks + t + 8 * (r >> 1)
    return (row, j) if row < d and j < d else None


def x_fragment_j(d: int, t: int, e: int):
    """The j (within the k16-step) of element e of a lane's B fragment:
    b[0] packs e = 0, 1, b[1] e = 2, 3 (low half first), or None where the
    element is zero (D = 8 holds 8 j)."""
    return t + 4 * e if e < (2 if d < 16 else 4) else None


@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
def test_k16_fragments_give_both_operands_the_same_j(d):
    """mma.sync.m16n8k16 takes A slots (row, k) from lane (g, t): words 0-3
    are rows g, g + 8, g, g + 8 at k = 2t, 2t + 1 (words 0, 1) and 2t + 8,
    2t + 9 (words 2, 3), low half first; B slots (k, column g) from b[0]
    (2t, 2t + 1) and b[1] (2t + 8, 2t + 9).  With the kernel's pre-split W
    and x fragments, each lane's four k slots hold the same j on both
    operands, so the slot sums over the k16-steps are W x."""
    rng = np.random.default_rng(d)
    w = _bf16(rng.normal(size=(d, d)).astype(F32)).astype(F64)
    x = _bf16(rng.normal(size=(d, 8)).astype(F32)).astype(F64)
    steps = max(1, d // 16)
    got = np.zeros((16 * steps, 8))
    for mt in range(steps):
        for ks in range(steps):
            a, b = np.zeros((16, 16)), np.zeros((16, 8))
            slot_j = {}
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for r in range(4):
                    rj = w_fragment_word(d, mt, ks, lane, r)
                    row = g + 8 * (r & 1)
                    k = 2 * t + 8 * (r >> 1)
                    if rj is not None:
                        a[row, k] = w[rj[0], rj[1]]
                        a[row, k + 1] = w[rj[0], rj[1] + 4]
                        slot_j[(lane, k)] = rj[1] - 16 * ks
                        slot_j[(lane, k + 1)] = rj[1] + 4 - 16 * ks
                for e in range(4):
                    j = x_fragment_j(d, t, e)
                    k = 2 * t + 8 * (e >> 1) + (e & 1)
                    if j is not None:
                        b[k, g] = x[16 * ks + j, g]
                        assert slot_j.get((lane, k), j) == j
            got[16 * mt:16 * mt + 16] += a @ b
    np.testing.assert_array_equal(got[:d], w @ x)


def tc_product_bf16_k16(xr, xi, wr, wi, mode, rounding=_rz, chained=False):
    """(out_r, out_i) of out[c, n] = Σ_k x[c, k] W[n, k], complex, as
    window_bf16.cuh computes it: both operands split into bf16 parts; each
    k16-step's hi·hi sums of a plane, one mma for each of its two terms
    from a zero accumulator (``rounding`` after each), added to the float32
    accumulators to nearest, apart; bf16_3x's four cross-term products of a
    plane summed over the stage (the k16-step) on the tensor cores, then
    added likewise.  ``chained``: a plane's two hi·hi terms in one sum, the
    form PR 8-9's kernels took, kept as the yardstick of the drift."""
    (xrh, xrl), (xih, xil) = _split_bf16(xr), _split_bf16(xi)
    (wrh, wrl), (wih, wil) = _split_bf16(wr), _split_bf16(wi)
    acc = [np.zeros((xr.shape[0], wr.shape[0]), F32) for _ in range(2)]
    plan = (([(xrh, wrh), (-xih, wih)],
             [(xrh, wrl), (xrl, wrh), (-xih, wil), (-xil, wih)]),
            ([(xrh, wih), (xih, wrh)],
             [(xrh, wil), (xrl, wih), (xih, wrl), (xil, wrh)]))
    for ks in range(0, xr.shape[1], 16):
        s = slice(ks, ks + 16)
        for p, (hi, lo) in enumerate(plan):
            terms = ([hi] if chained else [[t] for t in hi]) + (
                [lo] if mode == "bf16_3x" else [])
            for chain in terms:
                e = np.zeros_like(acc[p], F64)
                for a, b in chain:
                    e = rounding(e + _mm(a[:, s], b[:, s])).astype(F64)
                acc[p] = (acc[p] + e.astype(F32)).astype(F32)
    return acc[0], acc[1]


def emulate_bf16_k16(d: int, mode: str, cols: int = 512, seed: int = 0):
    """(window_bf16.cuh's relative L2 error vs float64, vs its plain
    version's model) for a random unitary window on random columns."""
    rng = np.random.default_rng(seed)
    u = _unitary(d, rng)
    wr, wi = u.real.astype(F32), u.imag.astype(F32)
    xr, xi = _columns(d, cols, rng)
    want = (xr.astype(F64) + 1j * xi) @ (wr.astype(F64) + 1j * wi).T
    gr, gi = tc_product_bf16_k16(xr, xi, wr, wi, mode)
    got = gr.astype(F64) + 1j * gi
    pr, pi = plain_model_bf16(xr, xi, wr, wi, mode)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return rel(got, want), rel(got, pr + 1j * pi)


@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
def test_bf16_k16_tile_within_its_limits(d, mode):
    err, vs_plain = emulate_bf16_k16(d, mode, seed=d)
    assert err <= BF16_F64_TOL[mode]
    assert vs_plain <= 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k16_truncating_sums_shrink_the_norm_more_than_k8(seed):
    """A sum of 16 bf16 products is exact in float32 less often than a sum
    of 8: with a plane's two hi·hi terms chained into one k16 sum (PR 8-9's
    kernels) the shrink the truncating sums add over round-to-nearest sums
    was 1.5-2.5 times the k8 tile's here (still asserted, as the chained
    form's); with the two terms summed apart, as the kernels sum them now,
    each truncated sum is of 16 products as in the k8 tile, and the shrink
    falls below the chained form's, within twice the k8 tile's.  (On the
    card, phases 7 and 8 of chip_smoke.py hold the whole drift of bf16_3x
    at 1e-6 per 100 gates.)"""
    def rn(x):
        return x.astype(F32)

    def shrink(product):
        return (drift(64, "bf16_3x", 8, rn, seed, 1024, product)
                - drift(64, "bf16_3x", 8, _rz, seed, 1024, product))

    def chained(*args):
        return tc_product_bf16_k16(*args, chained=True)

    k8, k16, k16_chained = (shrink(tc_product_bf16),
                            shrink(tc_product_bf16_k16), shrink(chained))
    assert 0 < k8 < k16_chained < 3 * k8
    assert 0 < k16 < k16_chained and k16 < 2 * k8


# ---------------------------------------------------------------------------
# the FMA window at D <= 4 (csrc/window_apply.cu: window_fma_stream_kernel),
# in every dot mode
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """fmaf in float32: the float64 product of two float32 values is exact,
    and the sum is rounded once (twice only where it is not exact in
    float64, beyond any tolerance here)."""
    return (a.astype(F64) * b + c).astype(F32)


def _mode_parts(x, mode):
    """The parts of a float32 operand in a dot mode: x (f32); bf16 hi and
    lo (bf16_3x); bf16 hi (bf16)."""
    if mode == "f32":
        return (np.asarray(x, F32),)
    hi, lo = _split_bf16(x)
    return (hi, lo) if mode == "bf16_3x" else (hi,)


def fma_window_model(xr, xi, wr, wi, mode):
    """out[a, i, b] = Σ_k W[i, k] x[a, k, b], complex, as the FMA window
    sums it in a dot mode: x (A, D, B) and W (D, D) planes as they are
    (f32) or split into bf16 hi and lo parts, and for each k the products
    hi·hi, hi·lo, lo·hi (W part, x part; f32 and bf16: one) taken by FP32
    FMAs in that order."""
    xs = [_mode_parts(xr, mode), _mode_parts(xi, mode)]
    ws = [_mode_parts(wr, mode), _mode_parts(wi, mode)]
    products = ((0, 0), (0, 1), (1, 0)) if mode == "bf16_3x" else ((0, 0),)
    A, D, B = xr.shape
    ar = np.zeros((A, D, B), F32)
    ai = np.zeros((A, D, B), F32)
    for k in range(D):
        for pw, px in products:
            w_r = ws[0][pw][None, :, k, None]
            w_i = ws[1][pw][None, :, k, None]
            x_r = xs[0][px][:, None, k, :]
            x_i = xs[1][px][:, None, k, :]
            ar = _fma(w_r, x_r, _fma(-w_i, x_i, ar))
            ai = _fma(w_r, x_i, _fma(w_i, x_r, ai))
    return ar, ai


# dot mode -> the FMA window's relative L2 limits against window_apply_ref
# in the mode (f32: float32 sums of D <= 4 products in another order) and
# against float64 (chip_smoke.py's LIMITS)
FMA_TOL = {"f32": (1e-6, F64_TOL), "bf16_3x": (1e-5, BF16_F64_TOL["bf16_3x"]),
           "bf16": (1e-5, BF16_F64_TOL["bf16"])}


@pytest.mark.parametrize("mode", list(FMA_TOL))
@pytest.mark.parametrize("geometry", [(5, 1, 3), (4, 2, 3), (9, 1, 0),
                                      (8, 2, 0), (6, 2, 1), (0, 1, 9),
                                      (0, 2, 8)],
                         ids=lambda g: "A{}_w{}_B{}".format(*g))
def test_fma_window_order_matches_plain_version(geometry, mode):
    """The FMA window's products, in the kernel's order, against
    window_apply_ref in the same mode on the CPU (with flips and phases),
    A = 1 (the first window of a plan) among them: f32 within 1e-6, the
    reduced modes within 1e-5, the limit chip_smoke.py and the card tests
    hold the kernel to, and each within the mode's float64 limit."""
    import torch

    from qbot_tpu_torch.tpu import kernels

    log_a, width, log_b = geometry
    n, d = log_a + width + log_b, 2**width
    rng = np.random.default_rng(sum(geometry))
    psi = rng.normal(size=(2, 2**n))
    psi = torch.tensor(psi / np.linalg.norm(psi), dtype=torch.float32)
    u = _unitary(d, rng)
    w = torch.tensor(np.stack([u.real, u.imag]), dtype=torch.float32)
    phases = (((log_a, n - 1), complex(np.exp(0.5j)), 1),)
    diag = kernels.fused_diagonals(n, (3, 2**n - 5), phases)
    x = kernels._apply_diagonals_ref(psi, diag).numpy().reshape(
        2, 2**log_a, d, 2**log_b)
    ar, ai = fma_window_model(x[0], x[1], w[0].numpy(), w[1].numpy(), mode)
    got = np.stack([ar, ai]).reshape(2, -1).astype(F64)
    want = kernels.window_apply_ref(psi, n, log_a, width, w, diag,
                                    mode=mode).numpy()
    exact = kernels.window_apply_ref(psi.double(), n, log_a, width,
                                     w.double(), diag, mode="f32").numpy()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    tol, f64_tol = FMA_TOL[mode]
    assert rel(got, want) <= tol
    assert rel(got, exact) <= f64_tol



# ---------------------------------------------------------------------------
# the fused flips and phases of the kernels (csrc/tc_tile.cuh: diag_tables,
# apply_hit, apply_several_hits)
# ---------------------------------------------------------------------------

TABLE = 8       # diagonal entries the kernels look up in tables


def _cmul(xr, xi, zr, zi):
    """tc_tile.cuh's cmul: each product and sum rounded on its own."""
    return ((xr * zr).astype(F32) - (xi * zi).astype(F32)).astype(F32), \
        ((xr * zi).astype(F32) + (xi * zr).astype(F32)).astype(F32)


def kernel_phases(psi, diag, combine):
    """The kernels' flips and phases on a planar state: the table entries
    (the phases, then the flips as phases of -1; the first TABLE) by their
    hit set's factor, the product of its entries' factors (``combine``, the
    F32 kernels) or, in the reduced modes, the one entry's factor, several
    entries' factors one by one in a second pass; then the entries past the
    tables one by one."""
    n_amps = psi.shape[1]
    idx = np.arange(n_amps, dtype=np.int64)
    ph = diag.phase.numpy()
    entries = [(m, w, ph[0, p], ph[1, p]) for p, (m, w) in
               enumerate(zip(diag.mask.numpy(), diag.want.numpy()))]
    entries += [(n_amps - 1, f, F32(-1), F32(0)) for f in diag.flips.numpy()]
    hits = [(idx & m) == w for m, w, _, _ in entries]
    zr, zi = np.ones(n_amps, F32), np.zeros(n_amps, F32)
    count = sum(h.astype(int) for h in hits[:TABLE])
    for hit, (_, _, er, ei) in zip(hits[:TABLE], entries):
        take = hit & (count == 1) if not combine else hit
        r, i = _cmul(zr, zi, F32(er), F32(ei))
        zr, zi = np.where(take, r, zr), np.where(take, i, zi)
    xr, xi = _cmul(psi[0], psi[1], zr, zi)
    for k, (hit, (_, _, er, ei)) in enumerate(zip(hits, entries)):
        if k < TABLE:
            take = np.zeros_like(hit) if combine else hit & (count > 1)
        else:
            take = hit
        r, i = _cmul(xr, xi, F32(er), F32(ei))
        xr, xi = np.where(take, r, xr), np.where(take, i, xi)
    return np.stack([xr, xi])


def _many_entries(n, rng):
    """7 phases on 3 qubits of random angles and patterns, and 6 flips."""
    from qbot_tpu_torch.tpu import kernels
    phases = tuple((tuple(int(q) for q in rng.choice(n, 3, replace=False)),
                    complex(np.exp(1j * rng.uniform(0, 6))),
                    int(rng.integers(0, 8))) for _ in range(7))
    flips = tuple(int(m) for m in rng.integers(0, 2**n, size=6))
    return kernels.fused_diagonals(n, flips, phases)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduced_kernels_phase_as_the_plain_version(seed):
    """With 13 flips and phases, more than the tables hold, the reduced
    modes' order (one entry's factor from the table, several entries'
    factors one by one, then the entries past the tables) gives the plain
    version's amplitudes bit for bit."""
    import torch

    from qbot_tpu_torch.tpu import kernels
    n = 12
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(2, 2**n)).astype(F32)
    diag = _many_entries(n, rng)
    got = kernel_phases(psi, diag, combine=False)
    want = kernels._apply_diagonals_ref(torch.from_numpy(psi), diag).numpy()
    np.testing.assert_array_equal(got, want)


def combined_factor_distance(seed, n=16, width=7):
    """Relative L2 distance of the bf16 window (D = 128) whose amplitudes
    were phased with combined factors, from its plain version, with 13
    flips and phases."""
    import torch

    from qbot_tpu_torch.tpu import kernels
    rng = np.random.default_rng(seed)
    psi = rng.normal(size=(2, 2**n))
    psi = torch.tensor(psi / np.linalg.norm(psi), dtype=torch.float32)
    u = _unitary(2**width, rng)
    w = torch.tensor(np.stack([u.real, u.imag]), dtype=torch.float32)
    diag = _many_entries(n, rng)
    phased = torch.from_numpy(kernel_phases(psi.numpy(), diag, combine=True))
    got = kernels.window_apply_ref(phased, n, 3, width, w,
                                   kernels.fused_diagonals(n), mode="bf16")
    want = kernels.window_apply_ref(psi, n, 3, width, w, diag, mode="bf16")
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def test_combined_factors_move_bf16_windows_past_their_limit():
    """Why the reduced kernels apply several entries' factors one by one: a
    product of two factors rounds once more, the bf16 rounding of an
    amplitude an ulp apart moves by 2^-8, and over 8 seeds at 16 qubits the
    window at D = 128 with 13 entries lands 0 to 3.05e-5 from its plain
    version, past its limit of 1e-5."""
    distances = [combined_factor_distance(seed) for seed in range(8)]
    assert max(distances) > 1e-5


# ---------------------------------------------------------------------------
# the bf16_3x drift of a plan whose first window is one qubit wide
# ---------------------------------------------------------------------------

def split_drift(n, layers=16, repeats=16, seed=0, measure=True):
    """(drift, predicted, (narrow, wide)) of the brickwork body x
    ``repeats`` in bf16_3x through the plain versions (the reference's
    split) on the CPU: the drift (1 - |psi|^2) per 100 gates (None unless
    ``measure``); the drift the split W predicts, each window pass
    shrinking the norm of a state whose window is maximally mixed by
    1 - |W_hi + W_lo|_F^2 / D; and that prediction's parts from the
    windows of D <= 4 and of the wider ones."""
    import torch

    from _torch_parity import brickwork
    from qbot_tpu_torch import compile_circuit
    from qbot_tpu_torch.tpu import circuit, kernels
    from qbot_tpu_torch.tpu.planar import (apply_plan_planar_ref,
                                           fold_window_static,
                                           product_state_planar)

    c = brickwork(circuit, n, layers, seed)
    plan = compile_circuit(c, pair=False)
    parts = [0.0, 0.0]
    for step in plan.steps:
        w = fold_window_static(step)
        re, im = (sum(p.astype(F64) for p in _split_bf16(x.astype(F32)))
                  for x in (w.real, w.imag))
        shrink = 1 - (np.sum(re ** 2) + np.sum(im ** 2)) / w.shape[0]
        parts[step.width > 2] += shrink * repeats / (c.gate_count * repeats
                                                     / 100)
    if not measure:
        return None, sum(parts), tuple(parts)
    kernels.set_dot_mode("bf16_3x")
    try:
        psi = product_state_planar([np.array([1.0, 0.0])] * n, "cpu")
        for _ in range(repeats):
            psi = apply_plan_planar_ref(psi, plan)
    finally:
        kernels.set_dot_mode("f32")
    norm = float(torch.sum(psi.double() ** 2))
    drift = (1 - norm) / (c.gate_count * repeats / 100)
    return drift, sum(parts), tuple(parts)


def test_bf16_3x_drift_is_the_split_of_w():
    """Why the brickwork drifts most in bf16_3x where its first window is
    one qubit wide (22 qubits on the card: 2.9644e-06 per 100 gates through
    the plain versions, against 6.2e-07 at 23 and 1.9e-07 at 26): the
    split W_hi + W_lo of a window's unitary is off unitary, a D = 2
    window's deviation (4 entries) does not average out as a D = 128
    window's does, and the scanned body repeats each window's deviation
    with the same sign.  At 15 qubits (n = 1 mod 7, like 22) the plain
    versions' drift is the prediction within 10%, and the one-qubit windows
    carry most of it."""
    drift, predicted, (narrow, wide) = split_drift(15)
    assert abs(drift - predicted) <= 0.1 * abs(predicted)
    assert abs(narrow) >= 5 * abs(wide)

# ---------------------------------------------------------------------------
# the FMA pair at D1, D2 <= 4 (csrc/pair_apply.cu: pair_fma_stream_kernel)
# ---------------------------------------------------------------------------

def _fmul(a, b):
    return (np.asarray(a, F64) * b).astype(F32)


def _mode_dot(w, x, mode):
    """The kernel's mode_cdot over axis 1 of x, for every row of w: w (2,
    D, D) and x (2, A, D, R) float32 planes; E(a, b) = Σ_k a_k b_k in order
    (the first product rounded, then an FMA a term), M(a, b) = (E(hi, hi) +
    E(hi, lo)) + E(lo, hi) in bf16_3x, E(hi, hi) in bf16, E(a, b) in f32;
    re = M(Wr, xr) − M(Wi, xi), im = M(Wr, xi) + M(Wi, xr)."""
    ws = [_mode_parts(w[0], mode), _mode_parts(w[1], mode)]
    xs = [_mode_parts(x[0], mode), _mode_parts(x[1], mode)]
    d = w.shape[1]

    def e(wp, xp):
        s = _fmul(wp[None, :, 0, None], xp[:, None, 0])
        for k in range(1, d):
            s = _fma(wp[None, :, k, None], xp[:, None, k], s)
        return s

    def m(wc, pl):
        s = e(ws[wc][0], xs[pl][0])
        if mode == "bf16_3x":
            s = (s + e(ws[wc][0], xs[pl][1])).astype(F32)
            s = (s + e(ws[wc][1], xs[pl][0])).astype(F32)
        return s
    return ((m(0, 0) - m(1, 1)).astype(F32),
            (m(0, 1) + m(1, 0)).astype(F32))


def fma_pair_model(x, w1, w2, mode):
    """The streaming pair's products on the phased planes x (2, A, D1, D2,
    B): Y = W1·X over j, then out = Y·W2ᵀ over m, Y split anew, each by
    ``_mode_dot``."""
    _, A, d1, d2, B = x.shape
    y = np.stack(_mode_dot(w1, x.reshape(2, A, d1, d2 * B), mode))
    y = y.reshape(2, A * d1, d2, B)
    out = np.stack(_mode_dot(w2, y, mode))
    return out.reshape(2, -1)


# dot mode -> the FMA pair's relative L2 limit against pair_apply_ref in
# the mode (0: bit for bit; f32 sums inexact products, whose roundings the
# einsum may take in another order) and against float64
FMA_PAIR_TOL = {"f32": (1e-6, F64_TOL), "bf16_3x": (0.0, 2e-5),
                "bf16": (0.0, 1e-2)}


@pytest.mark.parametrize("mode", list(FMA_PAIR_TOL))
@pytest.mark.parametrize("geometry", [(1, 1, 1, 7), (0, 1, 2, 7),
                                      (2, 2, 1, 7), (0, 2, 2, 8),
                                      (3, 2, 2, 0), (4, 1, 1, 0)],
                         ids=lambda g: "A{}_{}x{}_B{}".format(*g))
def test_fma_pair_model_is_the_plain_version(geometry, mode):
    """The streaming pair's arithmetic, its flips and phases in the
    kernels' order (13 entries, several hitting one element, more than the
    tables hold) and its products in the plain version's structure: bit for
    bit ``pair_apply_ref`` in bf16_3x and bf16 (the products of bf16 parts
    are exact, and the einsum sums each k in order), within 1e-6 in f32,
    and within each mode's float64 limit."""
    import torch

    from qbot_tpu_torch.tpu import kernels

    log_a, w1w, w2w, log_b = geometry
    n = log_a + w1w + w2w + log_b
    rng = np.random.default_rng(sum(geometry) + len(mode))
    psi = rng.normal(size=(2, 2**n)) * np.exp(rng.normal(size=(2, 2**n)))
    psi = torch.tensor(psi / np.linalg.norm(psi), dtype=torch.float32)
    w1, w2 = (np.stack([u.real, u.imag]).astype(F32)
              for u in (_unitary(2**w1w, rng), _unitary(2**w2w, rng)))
    diag = _many_entries(n, rng)
    x = kernel_phases(psi.numpy(), diag, combine=False)
    got = fma_pair_model(x.reshape(2, 2**log_a, 2**w1w, 2**w2w, 2**log_b),
                         w1, w2, mode)
    want = kernels.pair_apply_ref(psi, n, log_a, w1w, w2w,
                                  torch.from_numpy(w1), torch.from_numpy(w2),
                                  diag, mode=mode).numpy()
    exact = kernels.pair_apply_ref(psi.double(), n, log_a, w1w, w2w,
                                   torch.from_numpy(w1).double(),
                                   torch.from_numpy(w2).double(), diag,
                                   mode="f32").numpy()

    def rel(a, b):
        return float(np.linalg.norm(a.astype(F64) - b)
                     / np.linalg.norm(b))
    tol, f64_tol = FMA_PAIR_TOL[mode]
    if tol == 0.0:
        np.testing.assert_array_equal(got, want)
    assert rel(got, want) <= tol
    assert rel(got, exact) <= f64_tol


# ---------------------------------------------------------------------------
# the f32 window at D = 128 (csrc/window_wg.cuh): wgmma m64n128k8 TF32, both
# operands split by the producer into a stage of shared memory
# ---------------------------------------------------------------------------

# window_wg.cuh's stage: for each half tile of 64 columns, x's parts (re
# hi, im hi, re lo, im lo, -im hi, -im lo), 64 rows x 8 k each, then W's
# (re hi, im hi, re lo, im lo, re tf32, im tf32), 128 x 8;
# a part is [k half][8-row group][row][4 k], its k halves WG_*_LBO bytes
# apart, its 8-row groups WG_GROUP bytes apart (the descriptors' offsets)
WG_A_LBO, WG_B_LBO, WG_GROUP = 1024 + 64, 2048, 128
WG_A_PART, WG_B_PART = WG_A_LBO + 1024, 2 * 2048
WG_COLS = 64          # state columns of a half tile: the products' 64 rows
WG_HALVES = 2
WG_X_HALF = 6 * WG_A_PART
WG_W = WG_HALVES * WG_X_HALF  # the W parts' first byte
WG_STAGE = WG_W + 6 * WG_B_PART
# (A part, B part) of each plane's products in issue order: the exact sum
# of the hi parts, then the cross terms x_hi W_lo + x_lo tf32(W); plane 0
# takes -x_im, plane 1 W's planes swapped
WG_PLAN = ((((0, 0), (4, 1)), ((0, 2), (4, 3), (2, 4), (5, 5))),
           (((0, 1), (1, 0)), ((0, 3), (1, 2), (2, 5), (3, 4))))


def _wg_offsets(rows: int, lbo: int):
    """Byte offsets of a part's (row, k) elements from its start."""
    r, k = np.meshgrid(np.arange(rows), np.arange(8), indexing="ij")
    return (r >> 3) * WG_GROUP + (r & 7) * 16 + (k >> 2) * lbo + (k & 3) * 4


def wg_stage(xparts, wparts, w_base=WG_W, w_rows=128):
    """The words of one stage as the kernel fills it: ``xparts[h]`` the six
    x parts of half h (the producer's), ``wparts`` the six W parts of
    ``w_rows`` rows from byte ``w_base`` (the split kernel's, bulk-copied;
    each part's k halves w_rows * 16 bytes apart)."""
    st = np.zeros(WG_STAGE // 4, np.uint32)
    for h, parts in enumerate(xparts):
        for a, part in enumerate(parts):
            st[(h * WG_X_HALF + a * WG_A_PART
                + _wg_offsets(WG_COLS, WG_A_LBO)) // 4] = _bits(part)
    for b, part in enumerate(wparts):
        st[(w_base + b * 32 * w_rows
            + _wg_offsets(w_rows, 16 * w_rows)) // 4] = _bits(part)
    return st


def wg_operand(st, base: int, lbo: int, rows: int):
    """The (rows, 8) operand a descriptor at byte ``base`` reads."""
    return st.view(F32)[(base + _wg_offsets(rows, lbo)) // 4]


def _wg_sum(a_ops, b_ops, products, rounding):
    """(the tensor cores' sum of the (A part, B part) products from a
    zeroed accumulator, ``rounding`` after each; the exact sum)."""
    d = np.zeros((WG_COLS, b_ops[0].shape[0]), F64)
    whole = np.zeros_like(d)
    for a, b in products:
        term = _mm(a_ops[a], b_ops[b])
        whole += term
        d = rounding(d + term).astype(F64)
    return d, whole


def wg_product(xr, xi, wr, wi, rounding=None):
    """(out_r, out_i, every exact sum exact) of out[c, n] = Σ_k x[c, k]
    W[n, k] at D = 128 as window_wg.cuh computes it: per k-step of 8 j, x
    and W split on their grids, the parts read back from the stage through
    the descriptors' offsets; each plane's exact sum (two products from a
    zeroed accumulator) and cross sum (four) on the tensor cores
    (``rounding`` after each product, toward zero by default), each added
    to the FP32 accumulators to nearest, exact sum first."""
    rounding = _rz if rounding is None else rounding
    cols = xr.shape[0]
    # a tile's columns past the state's are copied in as zeros
    pad = ((0, -cols % (WG_HALVES * WG_COLS)), (0, 0))
    xr, xi = np.pad(xr, pad), np.pad(xi, pad)
    acc = [np.zeros((xr.shape[0], 128), F32) for _ in range(2)]
    exact = True
    for s in range(16):
        sl = slice(8 * s, 8 * s + 8)
        mx = _grid(np.maximum(abs(xr[:, sl]), abs(xi[:, sl])).max(1))[:, None]
        mw = _grid(np.maximum(abs(wr[:, sl]), abs(wi[:, sl])).max(1))[:, None]
        (xrh, xrl), (xih, xil) = _split(xr[:, sl], mx), _split(xi[:, sl], mx)
        (wrh, wrl), (wih, wil) = _split(wr[:, sl], mw), _split(wi[:, sl], mw)
        wparts = [wrh, wih, wrl, wil, _tf32(wr[:, sl]), _tf32(wi[:, sl])]
        for t0 in range(0, xr.shape[0], WG_HALVES * WG_COLS):
            halves = [slice(t0 + h * WG_COLS, t0 + (h + 1) * WG_COLS)
                      for h in range(WG_HALVES)]
            st = wg_stage([[p[cs] for p in (xrh, xih, xrl, xil, -xih, -xil)]
                           for cs in halves], wparts)
            b_ops = [wg_operand(st, WG_W + b * WG_B_PART, WG_B_LBO, 128)
                     for b in range(6)]
            for h, cs in enumerate(halves):
                a_ops = [wg_operand(st, h * WG_X_HALF + a * WG_A_PART,
                                    WG_A_LBO, WG_COLS) for a in range(6)]
                for p, sums in enumerate(WG_PLAN):
                    for q, products in enumerate(sums):
                        d, whole = _wg_sum(a_ops, b_ops, products, rounding)
                        exact &= q > 0 or bool(np.all(d == whole))
                        acc[p][cs] = (acc[p][cs] + d.astype(F32)).astype(F32)
    return acc[0][:cols], acc[1][:cols], exact


def tc_product_f32(xr, xi, wr, wi, rounding=None):
    """(out_r, out_i) of the same product as the mma.sync tile of
    tc_tile.cuh computes it at D = 128 (tc_products): each k-step's exact
    sums added to nearest, the cross terms summed over a stage of 16 j on
    the tensor cores (``rounding`` after each mma), then added."""
    rounding = _rz if rounding is None else rounding
    cols = xr.shape[0]
    acc = [np.zeros((cols, 128), F32) for _ in range(2)]
    # plane p: (A part, W part) of its two products, and their signs
    terms = (((0, 0), (1, 1)), ((0, 1), (1, 0)))
    signs = ((1, -1), (1, 1))
    for s0 in range(0, 16, STAGE // 8):
        cross = [np.zeros((cols, 128), F64) for _ in range(2)]
        for s in range(s0, s0 + STAGE // 8):
            sl = slice(8 * s, 8 * s + 8)
            mx = _grid(np.maximum(abs(xr[:, sl]),
                                  abs(xi[:, sl])).max(1))[:, None]
            mw = _grid(np.maximum(abs(wr[:, sl]),
                                  abs(wi[:, sl])).max(1))[:, None]
            xh, xl = zip(_split(xr[:, sl], mx), _split(xi[:, sl], mx))
            wh, wl = zip(_split(wr[:, sl], mw), _split(wi[:, sl], mw))
            wt = (_tf32(wr[:, sl]), _tf32(wi[:, sl]))
            for p in range(2):
                (a0, w0), (a1, w1) = terms[p]
                s_0, s_1 = signs[p]
                e = rounding(s_0 * _mm(xh[a0], wh[w0])).astype(F64)
                for a, part, w, sg in ((xh, wl, w0, s_0), (xl, wt, w0, s_0)):
                    cross[p] = rounding(cross[p] + sg * _mm(a[a0], part[w]))
                e = rounding(e + s_1 * _mm(xh[a1], wh[w1])).astype(F64)
                acc[p] = (acc[p] + e.astype(F32)).astype(F32)
                for a, part, w, sg in ((xh, wl, w1, s_1), (xl, wt, w1, s_1)):
                    cross[p] = rounding(cross[p] + sg * _mm(a[a1], part[w]))
        for p in range(2):
            acc[p] = (acc[p] + cross[p].astype(F32)).astype(F32)
    return acc[0], acc[1]


@pytest.mark.parametrize("part", range(18))
def test_wg_stage_reads_back_each_part(part):
    """Every part written into a stage (each half's six x parts, then the
    six W parts) is the operand its descriptor reads, and no two parts share
    a byte of the stage."""
    rng = np.random.default_rng(part)
    nx = 6 * WG_HALVES
    rows = WG_COLS if part < nx else 128
    parts = [rng.normal(size=(WG_COLS if p < nx else 128, 8)).astype(F32)
             for p in range(nx + 6)]
    st = wg_stage([parts[6 * h:6 * h + 6] for h in range(WG_HALVES)],
                  parts[nx:])
    base, lbo = ((part // 6 * WG_X_HALF + part % 6 * WG_A_PART, WG_A_LBO)
                 if part < nx else
                 (WG_W + (part - nx) * WG_B_PART, WG_B_LBO))
    np.testing.assert_array_equal(wg_operand(st, base, lbo, rows),
                                  parts[part])
    span = base + _wg_offsets(rows, lbo)
    size = WG_A_PART if part < nx else WG_B_PART
    assert span.min() == base and span.max() + 4 <= base + size
    assert len(np.unique(span)) == rows * 8


def _wg_case(seed: int, cols: int):
    rng = np.random.default_rng(seed)
    u = _unitary(128, rng)
    wr, wi = u.real.astype(F32), u.imag.astype(F32)
    xr, xi = _columns(128, cols, rng)
    return xr, xi, wr, wi


@pytest.mark.parametrize("seed", [0, 1])
def test_wg_product_exact_sums_within_f32_limits(seed):
    """The replay's exact sums are exact, and it lies within the f32
    kernels' limits of float64 (F64_TOL) and of float32 products
    (tests/test_torch_cuda.py: 1e-5)."""
    xr, xi, wr, wi = _wg_case(seed, WG_HALVES * WG_COLS)
    gr, gi, exact = wg_product(xr, xi, wr, wi)
    assert exact
    got = gr.astype(F64) + 1j * gi
    want = (xr.astype(F64) + 1j * xi) @ (wr.astype(F64) + 1j * wi).T
    plain = ((xr @ wr.T - xi @ wi.T).astype(F64)
             + 1j * (xr @ wi.T + xi @ wr.T))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= F64_TOL
    assert np.linalg.norm(got - plain) / np.linalg.norm(want) <= 1e-5


@pytest.mark.parametrize("start,n", [(0, 7), (1, 9), (2, 9)])
def test_wg_product_is_the_plain_window(start, n):
    """On a state with flips and phases past the 8-entry tables, applied as
    the F32 kernels apply them, the replay is window_apply_ref's window at
    D = 128 within 1e-5, in either orientation."""
    import torch

    from qbot_tpu_torch.tpu import kernels

    rng = np.random.default_rng(10 * n + start)
    psi = rng.normal(size=(2, 2**n)) * np.exp(rng.normal(size=(2, 2**n)))
    psi = torch.tensor(psi / np.linalg.norm(psi), dtype=torch.float32)
    u = _unitary(128, rng)
    w = np.stack([u.real, u.imag]).astype(F32)
    diag = _many_entries(n, rng)
    x = kernel_phases(psi.numpy(), diag, combine=True)
    B = 2 ** (n - start - 7)
    # columns c = a B + b of x[plane, a, j, b]
    cols = x.reshape(2, 2**start, 128, B).transpose(0, 1, 3, 2)
    cols = cols.reshape(2, -1, 128)
    gr, gi, exact = wg_product(cols[0], cols[1], w[0], w[1])
    got = np.stack([gr, gi]).reshape(2, 2**start, B, 128)
    got = got.transpose(0, 1, 3, 2).reshape(2, -1)
    want = kernels.window_apply_ref(psi, n, start, 7, torch.from_numpy(w),
                                    diag, mode="f32").numpy()
    assert exact
    assert (np.linalg.norm(got.astype(F64) - want)
            / np.linalg.norm(want)) <= 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wg_truncation_no_worse_than_the_tile(seed):
    """The tensor cores' sums rounded toward zero move the warpgroup
    kernel's product less than the mma.sync tile's (its cross sums run over
    8 j, the tile's over a stage of 16), and neither shrinks the norm of a
    pass measurably: only cross terms, 2^-11 of the state and of random
    sign against it, go through them (beside
    test_truncating_sums_shrink_the_norm, where the bf16_3x sums do)."""
    def rn(x):
        return x.astype(F32)

    xr, xi, wr, wi = _wg_case(seed, WG_HALVES * WG_COLS)
    n0 = np.linalg.norm(xr.astype(F64)) ** 2 + np.linalg.norm(xi) ** 2
    moved = {}
    for name, product in (("wg", wg_product), ("tile", tc_product_f32)):
        zr, zi = product(xr, xi, wr, wi, _rz)[:2]
        nr, ni = product(xr, xi, wr, wi, rn)[:2]
        shrink = (np.linalg.norm(nr.astype(F64)) ** 2 + np.linalg.norm(ni) ** 2
                  - np.linalg.norm(zr.astype(F64)) ** 2
                  - np.linalg.norm(zi) ** 2) / n0
        assert abs(shrink) < 1e-9
        moved[name] = np.sqrt((np.linalg.norm(zr.astype(F64) - nr) ** 2
                               + np.linalg.norm(zi.astype(F64) - ni) ** 2)
                              / n0)
    assert moved["wg"] <= moved["tile"]


# ---------------------------------------------------------------------------
# the f32 trailing pair at D2 = 128, D1 = 64 and 128 (csrc/pair_wg.cuh): the
# window_wg products twice, W1 first, Y kept in FP32 and split anew
# ---------------------------------------------------------------------------

# pair_wg.cuh's stages: phase 1 X's four parts (the slab's 128 rows m, K =
# j; k halves 2112 bytes apart), then W1's nine parts of a unit's 64 rows i
# (k halves 1024 bytes apart), W1 the A operand; phase 2 W2's six parts as
# the window's W from byte 0, the A operand Y's parts in registers
PWG_NI = 64
PWG_X_LBO = 128 * 16 + 64
PWG_X_PART = PWG_X_LBO + 128 * 16
PWG_W1 = 4 * PWG_X_PART
PWG_STAGE = PWG_W1 + 9 * 2 * 16 * PWG_NI
# phase 1's (X part, W1 part) products of each plane, exact sum then cross
# terms: -W1_im's parts (6-8) take the place of -x_im's
PWG_PLAN1 = ((((0, 0), (1, 6)), ((0, 2), (1, 7), (2, 4), (3, 8))),
             (((0, 1), (1, 0)), ((0, 3), (1, 2), (2, 5), (3, 4))))
# the paired order of a phase-2 k-step: its A fragment's k = t, t + 4 hold
# a lane's m = 2t, 2t + 1, and W2's parts take its order
PWG_PAIRED = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def _pwg_stage(blocks):
    """The words of one stage: ``blocks`` of (first byte, bytes between
    the k halves of a part, bytes between parts, the parts)."""
    st = np.zeros(PWG_STAGE // 4, np.uint32)
    for base, lbo, size, parts in blocks:
        for b, part in enumerate(parts):
            st[(base + b * size
                + _wg_offsets(part.shape[0], lbo)) // 4] = _bits(part)
    return st


def _pwg_parts(x, w, kk):
    """The six parts of x's k-step ``kk`` (re hi, im hi, re lo, im lo,
    -im hi, -im lo) and the nine of W (re hi, im hi, re lo, im lo, re
    tf32, im tf32, -im hi, -im lo, -im tf32), each on the grids of its
    rows."""
    xs, ws = x[:, :, kk], w[:, :, kk]
    mx = _grid(np.maximum(abs(xs[0]), abs(xs[1])).max(1))[:, None]
    mw = _grid(np.maximum(abs(ws[0]), abs(ws[1])).max(1))[:, None]
    (xrh, xrl), (xih, xil) = _split(xs[0], mx), _split(xs[1], mx)
    (wrh, wrl), (wih, wil) = _split(ws[0], mw), _split(ws[1], mw)
    wt = _tf32(ws[1])
    return ([xrh, xih, xrl, xil, -xih, -xil],
            [wrh, wih, wrl, wil, _tf32(ws[0]), wt, -wih, -wil, -wt])


def _pwg_phase(x_ops, w_ops, acc, plan, rounding):
    """One k-step of a phase: each plane's exact sum and cross sum of the
    (x part, W part) products of ``plan`` on the tensor cores
    (``rounding`` after each, from a zeroed accumulator), added to
    ``acc[plane][i, c]`` = Σ_k W[i, k] x[c, k] to nearest, exact sum
    first; whether every exact sum was exact."""
    exact = True
    for p, sums in enumerate(plan):
        for q, products in enumerate(sums):
            d = np.zeros((w_ops[0].shape[0], x_ops[0].shape[0]), F64)
            whole = np.zeros_like(d)
            for a, b in products:
                term = _mm(w_ops[b], x_ops[a])
                whole += term
                d = rounding(d + term).astype(F64)
            exact &= q > 0 or bool(np.all(d == whole))
            acc[p][:] = (acc[p] + d.astype(F32)).astype(F32)
    return exact


def pair_wg_product(x, w1, w2, rounding=None):
    """(out, every exact sum exact) of one slab of the trailing pair, out[i,
    l] = Σ_{j,m} W1[i, j] W2[l, m] x[j, m], as pair_wg.cuh computes it: x
    (2, D1, 128) float32 (phased), W1 (2, D1, D1) and W2 (2, 128, 128); a
    unit's 64 rows i at a time.  Phase 1: per k-step of j, X's four parts
    (rows m) and W1's nine (the unit's rows i) written into a stage and read
    back through the descriptors' offsets, Y[i, m] summed in FP32.  Phase
    2: per k-step of m in the paired order, Y's parts on the grids of its
    rows i (the A fragments in registers) and W2's read back from a
    stage."""
    rounding = _rz if rounding is None else rounding
    d1 = x.shape[1]
    xt = x.transpose(0, 2, 1)          # (2, m, j): X's rows m, K = j
    out = np.zeros((2, d1, 128), F32)
    exact = True
    for h in range(d1 // PWG_NI):
        w1h = w1[:, h * PWG_NI:(h + 1) * PWG_NI]
        y = [np.zeros((PWG_NI, 128), F32) for _ in range(2)]
        for s in range(d1 // 8):
            xparts, wparts = _pwg_parts(xt, w1h, slice(8 * s, 8 * s + 8))
            st = _pwg_stage([(0, PWG_X_LBO, PWG_X_PART, xparts[:4]),
                             (PWG_W1, 16 * PWG_NI, 32 * PWG_NI, wparts)])
            x_ops = [wg_operand(st, a * PWG_X_PART, PWG_X_LBO, 128)
                     for a in range(4)]
            w_ops = [wg_operand(st, PWG_W1 + b * 32 * PWG_NI, 16 * PWG_NI,
                                PWG_NI) for b in range(9)]
            exact &= _pwg_phase(x_ops, w_ops, y, PWG_PLAN1, rounding)
        y = np.stack(y)                # (2, i, m): Y's rows i, K = m
        acc = [np.zeros((128, PWG_NI), F32) for _ in range(2)]
        for q in range(16):
            kk = 8 * q + PWG_PAIRED
            yparts, wparts = _pwg_parts(y, w2, kk)
            st = _pwg_stage([(0, WG_B_LBO, WG_B_PART, wparts[:6])])
            w_ops = [wg_operand(st, b * WG_B_PART, WG_B_LBO, 128)
                     for b in range(6)]
            exact &= _pwg_phase(yparts, w_ops, acc, WG_PLAN, rounding)
        out[0, h * PWG_NI:(h + 1) * PWG_NI] = acc[0].T
        out[1, h * PWG_NI:(h + 1) * PWG_NI] = acc[1].T
    return out, exact


def _pwg_case(d1, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, d1, 128)) * np.exp(rng.normal(size=(2, d1, 128)))
    us = [_unitary(d, rng) for d in (d1, 128)]
    w1, w2 = (np.stack([u.real, u.imag]).astype(F32) for u in us)
    return (x / np.linalg.norm(x)).astype(F32), w1, w2


@pytest.mark.parametrize("d1,seed", [(64, 0), (64, 1), (128, 2)])
def test_pair_wg_product_exact_sums_within_f32_limits(d1, seed):
    """The pair's replay: its exact sums are exact, and it lies within the
    f32 kernels' limits of float64 (F64_TOL) and of the float32 products
    of the plain version, W1 first (tests/test_torch_cuda.py: 1e-5)."""
    x, w1, w2 = _pwg_case(d1, seed)
    got, exact = pair_wg_product(x, w1, w2)
    assert exact
    xc = x[0].astype(F64) + 1j * x[1]
    w1c, w2c = (w[0].astype(F64) + 1j * w[1] for w in (w1, w2))
    want = w1c @ xc @ w2c.T
    yr = (w1[0] @ x[0] - w1[1] @ x[1]).astype(F32)
    yi = (w1[0] @ x[1] + w1[1] @ x[0]).astype(F32)
    plain = ((yr @ w2[0].T - yi @ w2[1].T).astype(F64)
             + 1j * (yr @ w2[1].T + yi @ w2[0].T).astype(F64))
    gotc = got[0].astype(F64) + 1j * got[1]
    assert np.linalg.norm(gotc - want) / np.linalg.norm(want) <= F64_TOL
    assert np.linalg.norm(gotc - plain) / np.linalg.norm(want) <= 1e-5


def test_pair_wg_stage_holds_each_part():
    """A phase-1 stage holds X's four parts (128 rows) and then W1's nine
    (a unit's 64 rows), a phase-2 stage W2's six (128 rows), each read back
    by its descriptor's offsets, no two sharing a byte, within the stage."""
    rng = np.random.default_rng(7)
    layouts = ([(0, PWG_X_LBO, PWG_X_PART, 128, 4),
                (PWG_W1, 16 * PWG_NI, 32 * PWG_NI, PWG_NI, 9)],
               [(0, WG_B_LBO, WG_B_PART, 128, 6)])
    for layout in layouts:
        blocks = [(base, lbo, size,
                   [rng.normal(size=(rows, 8)).astype(F32)
                    for _ in range(parts)])
                  for base, lbo, size, rows, parts in layout]
        st = _pwg_stage(blocks)
        spans = []
        for base, lbo, size, parts in blocks:
            for b, part in enumerate(parts):
                np.testing.assert_array_equal(
                    wg_operand(st, base + b * size, lbo, part.shape[0]), part)
                spans.append(base + b * size
                             + _wg_offsets(part.shape[0], lbo).ravel())
        spans = np.concatenate(spans)
        assert len(np.unique(spans)) == len(spans)
        assert spans.max() + 4 <= PWG_STAGE


@pytest.mark.parametrize("n,width1", [(13, 6), (14, 6), (14, 7)])
def test_pair_wg_product_is_the_plain_pair(n, width1):
    """On a state with flips and phases past the 8-entry tables, applied as
    the F32 kernels apply them, the replay slab by slab is pair_apply_ref's
    trailing pair at D2 = 128 within 1e-5."""
    import torch

    from qbot_tpu_torch.tpu import kernels

    rng = np.random.default_rng(10 * n + width1)
    psi = rng.normal(size=(2, 2**n)) * np.exp(rng.normal(size=(2, 2**n)))
    psi = torch.tensor(psi / np.linalg.norm(psi), dtype=torch.float32)
    d1 = 2**width1
    w1, w2 = (np.stack([u.real, u.imag]).astype(F32)
              for u in (_unitary(d1, rng), _unitary(128, rng)))
    diag = _many_entries(n, rng)
    x = kernel_phases(psi.numpy(), diag, combine=True).reshape(2, -1, d1, 128)
    got = np.stack([pair_wg_product(x[:, a], w1, w2)[0]
                    for a in range(x.shape[1])], axis=1).reshape(2, -1)
    start = n - width1 - 7
    want = kernels.pair_apply_ref(psi, n, start, width1, 7,
                                  torch.from_numpy(w1), torch.from_numpy(w2),
                                  diag, mode="f32").numpy()
    assert (np.linalg.norm(got.astype(F64) - want)
            / np.linalg.norm(want)) <= 1e-5


if __name__ == "__main__":
    for d in (8, 16, 32, 64, 128):
        err, plain, exact = emulate(d)
        print(f"D = {d:3d}: emulated kernel {err:.3e}, plain float32 "
              f"{plain:.3e} relative L2 vs float64; exact sums {exact}")
        for mode in ("bf16_3x", "bf16"):
            err, vs_plain = emulate_bf16(d, mode)
            err16, vs_plain16 = emulate_bf16_k16(d, mode)
            print(f"    {mode}: emulated k8 tile {err:.3e} vs float64, "
                  f"{vs_plain:.3e} vs its plain version; k16 kernel "
                  f"{err16:.3e}, {vs_plain16:.3e}")
    for mode in ("bf16_3x", "bf16"):
        print(f"{mode}: norm after 16 passes at D = 64 "
              f"{drift(64, mode, 16, _rz):.9f} (sums rounded toward zero)")
    print(f"bf16_3x k16 kernel: norm after 16 passes at D = 64 "
          f"{drift(64, 'bf16_3x', 16, _rz, product=tc_product_bf16_k16):.9f}")
    xr, xi, wr, wi = _wg_case(0, WG_HALVES * WG_COLS)
    gr, gi, exact = wg_product(xr, xi, wr, wi)
    want = (xr.astype(F64) + 1j * xi) @ (wr.astype(F64) + 1j * wi).T
    print(f"f32 D = 128 warpgroup kernel: emulated "
          f"{np.linalg.norm(gr + 1j * gi.astype(F64) - want) / np.linalg.norm(want):.3e}"
          f" relative L2 vs float64; exact sums {exact}")
    for n in (15, 16, 22, 23, 26):
        _, predicted, (narrow, wide) = split_drift(n, measure=False)
        print(f"bf16_3x brickwork {n}q x 256 layers: the split W predicts "
              f"a drift of {predicted:.4e} per 100 gates ({narrow:.4e} from "
              f"the windows of D <= 4, {wide:.4e} from the wider ones)")
