"""The arithmetic of the tensor-core pair kernel (``csrc/pair_tc.cuh``), in
numpy.

The kernel computes out = W1 · (ΦF X) · W2ᵀ on each (D1, D2) slab X as two
products of the window kernel's 3xTF32 tile (``csrc/tc_tile.cuh``), W1
first as in the reference; a slab is one a of the trailing pair's
(A, D1, D2) view, or one b-column of the middle pair's (A, D1, D2, B) view:

- phase 1, Y[m, i] = Σ_j X[j, m] W1[i, j]: X split on a grid per column m
  and k-step of 8 j, W1 per row i and k-step;
- phase 2, out[i, l] = Σ_m Y[m, i] W2[l, m] on the float32 Y: Y split on a
  grid per row i and k-step of 8 m, W2 per row l and k-step.

Each k-step's hi·hi sums (two mma.sync products) are exact; the cross terms
x_hi W_lo + x_lo tf32(W) are summed over a stage of 16 k on the tensor
cores, which round each sum toward zero; the sums go to float32
accumulators by round-to-nearest adds.  These tests replay that with
float32 numpy operations (products summed in float64, then rounded as the
tensor cores round), on slabs of amplitudes of many sizes with a few flips
and phases at the flat indices of each orientation: every k-step's hi·hi
sums are exactly representable, and the pair stays within chip_smoke.py's
float64 limit (F64_TOL, 2e-6) at every (D1, D2) of the tensor-core
variant, trailing and middle.  The rows and columns of a product are
independent, so the replay takes them in slab order, whatever order the
kernel's tiles take them in.

In the reduced modes (``bf16_3x``, ``bf16``) phase 2 splits the float32 Y
anew, as the reference's second ``_dot`` does.  The reduced pairs run
``csrc/pair_bf16.cuh``: both products on ``mma.sync.m16n8k16`` with the
rounding structure of the reduced window (``tc_product_bf16_k16`` of
``tests/test_torch_window_split.py``), W1, W2 and Y split once, Y kept in
registers between the products.  Their replays below fix its fragment maps
(each operand's k slots give both operands the same j, or m), hold each
mode to chip_smoke.py's float64 limits (2e-5, 1e-2) and to its plain
version's model (float64 sums, Y rounded to float32 between the products)
within 1e-5, bf16 within 1e-4 (its Y is rounded to bf16 a second time, so a
one-ulp difference in Y moves a rounding), and bound the norm shrink of its
truncating sums against that of the k8 BF16 tile (``tc_product_bf16``)
that the reduced pairs ran before, which these tests keep replaying as the
yardstick of the drift.

The narrow pairs (D1 = 2, 4 with D2 >= 8) run the D2 window's tile
(``csrc/window_tc.cuh``, ``csrc/window_bf16.cuh`` with D1 > 1): a pass over
each stage turns X into Y = W1 · (ΦF X) in place, mixed in FP32 FMAs, and
the window's fragments split Y as they split x (3xTF32 grids, or the k16
bf16 parts).  Their replays fix the kernel's column map (every amplitude
once, the D1 slots of a base column at one (a, b), every base element of a
stage to one thread of the pass), hold the arithmetic to
``pair_apply_ref`` and to float64, and
show that Y is bit for bit the output of the reduced FMA window, so the
pair's truncation shrink is its two windows'.

    python3 tests/test_torch_pair_split.py

prints the emulated relative L2 error against float64 at every (D1, D2).
"""
from __future__ import annotations

import numpy as np
import pytest

from test_torch_window_split import BF16_F64_TOL, F32, F64_TOL, _bf16, \
    _fma, _grid, _split, _split_bf16, _tf32, _unitary, fma_window_model, \
    plain_model_bf16, tc_product_bf16, tc_product_bf16_k16

F64 = np.float64
WIDTHS = [8, 16, 32, 64, 128]
MIDDLE_WIDTHS = [8, 16, 32]     # D1 of the middle pair (pair_route)
STAGE = 16      # k per cp.async stage: the cross terms' sums on the cores


def _rz(x):
    """float64 → float32 rounded toward zero, as the tensor cores round."""
    f = x.astype(F32)
    over = np.abs(f.astype(F64)) > np.abs(x)
    return np.where(over, np.nextafter(f, F32(0)), f).astype(F32)


def _mm(a, b):
    """Σ_k a[c, k] b[n, k] of tf32 values, in float64."""
    return a.astype(F64) @ b.astype(F64).T


def tc_product(xr, xi, wr, wi):
    """(out_r, out_i, exact) of out[c, n] = Σ_k x[c, k] W[n, k], complex,
    as the tile computes it: x (C, K), W (N, K) float32 planes."""
    K = xr.shape[1]
    acc = [np.zeros((xr.shape[0], wr.shape[0]), F32) for _ in range(2)]
    exact = True
    for k0 in range(0, K, min(K, STAGE)):
        cross = [None, None]
        for ks in range(k0, k0 + min(K, STAGE), 8):
            s = slice(ks, ks + 8)
            mx = _grid(np.maximum(abs(xr[:, s]), abs(xi[:, s])).max(1))
            mw = _grid(np.maximum(abs(wr[:, s]), abs(wi[:, s])).max(1))
            mx, mw = mx[:, None], mw[:, None]
            xrh, xrl = _split(xr[:, s], mx)
            xih, xil = _split(xi[:, s], mx)
            wrh, wrl = _split(wr[:, s], mw)
            wih, wil = _split(wi[:, s], mw)
            wrt, wit = _tf32(wr[:, s]), _tf32(wi[:, s])
            # plane p: two exact products, then four cross-term products,
            # in the kernel's order
            plan = (([(xrh, wrh), (-xih, wih)],
                     [(xrh, wrl), (xrl, wrt), (-xih, wil), (-xil, wit)]),
                    ([(xrh, wih), (xih, wrh)],
                     [(xrh, wil), (xrl, wit), (xih, wrl), (xil, wrt)]))
            for p, (hi, lo) in enumerate(plan):
                e = np.zeros_like(acc[p], F64)
                for a, b in hi:
                    e = e + _mm(a, b)
                    exact &= bool(np.all(e.astype(F32) == e))
                acc[p] = (acc[p] + e.astype(F32)).astype(F32)
                c = cross[p] if ks > k0 else np.zeros_like(acc[p])
                for a, b in lo:
                    c = _rz(c.astype(F64) + _mm(a, b))
                cross[p] = c
        for p in range(2):
            acc[p] = (acc[p] + cross[p]).astype(F32)
    return acc[0], acc[1], exact


def _diagonals(slabs, d1, d2, rng):
    """ΦF as one complex64 factor an element: three flips, a phase on a
    pattern of j and m bits, one on a j bit, one on the slab index."""
    f = np.ones((slabs, d1, d2), np.complex64)
    for idx in rng.integers(0, f.size, size=3):
        f.flat[idx] *= -1
    j, m = np.arange(d1)[:, None], np.arange(d2)[None, :]
    f[:, ((j & 1) == 1) & ((m >> 2 & 1) == 0)] *= np.complex64(np.exp(0.7j))
    f[:, d1 // 2:, :] *= np.complex64(-1)
    f[1::2] *= np.complex64(np.exp(-1.3j))
    return f


def _random_pair(d1, d2, shape, rng):
    """(W1, W2) float32 planes of random unitaries, and complex64
    amplitudes of many sizes of the given shape."""
    u1, u2 = _unitary(d1, rng), _unitary(d2, rng)
    w1 = [u1.real.astype(F32), u1.imag.astype(F32)]
    w2 = [u2.real.astype(F32), u2.imag.astype(F32)]
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    x *= np.exp(rng.normal(size=shape))
    return w1, w2, x.astype(np.complex64)


# the reduced modes' tiles: "k16", csrc/pair_bf16.cuh; "k8", the BF16
# m16n8k8 tile of tc_tile.cuh that the reduced pairs ran before it;
# "k16_chained", PR 9's pair, a plane's two hi·hi terms in one sum
REDUCED_TILES = {"k16": tc_product_bf16_k16, "k8": tc_product_bf16,
                 "k16_chained": lambda *args: tc_product_bf16_k16(
                     *args, chained=True)}


def tc_pair(xd, w1, w2, mode="f32", tile="k16", rounding=_rz):
    """(out, every k-step's hi·hi sums exact): W1 · X · W2ᵀ of each
    (D1, D2) slab of xd (slabs, D1, D2), complex64, as the kernel computes
    it in dot ``mode``; a reduced mode on ``tile`` (REDUCED_TILES), its
    tensor-core sums rounded by ``rounding`` (its sums are not exact:
    False)."""
    slabs, d1, d2 = xd.shape

    def product(xr, xi, wr, wi):
        if mode == "f32":
            return tc_product(xr, xi, wr, wi)
        return (*REDUCED_TILES[tile](xr, xi, wr, wi, mode, rounding), False)

    # phase 1: the columns (s, m) as A rows, K = j
    def cols(x):
        return x.transpose(0, 2, 1).reshape(-1, d1)

    yr, yi, exact1 = product(cols(xd.real), cols(xd.imag), *w1)

    # phase 2: rows (s, i), K = m, from the float32 Y
    def rows(y):
        return y.reshape(slabs, d2, d1).transpose(0, 2, 1).reshape(-1, d2)

    outr, outi, exact2 = product(rows(yr), rows(yi), *w2)
    got = (outr.astype(F64) + 1j * outi).reshape(slabs, d1, d2)
    return got, exact1 and exact2


def plain_pair_bf16(xd, w1, w2, mode):
    """The plain version's pair in a reduced mode: each product's split
    products summed in float64, Y rounded to float32 between them."""
    slabs, d1, d2 = xd.shape

    def cols(x):
        return x.transpose(0, 2, 1).reshape(-1, d1).astype(F32)

    yr, yi = plain_model_bf16(cols(xd.real), cols(xd.imag), *w1, mode)

    def rows(y):
        return (y.astype(F32).reshape(slabs, d2, d1).transpose(0, 2, 1)
                .reshape(-1, d2))

    outr, outi = plain_model_bf16(rows(yr), rows(yi), *w2, mode)
    return (outr + 1j * outi).reshape(slabs, d1, d2)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def emulate(d1: int, d2: int, slabs: int = 2, seed: int = 0,
            mode: str = "f32", tile: str = "k16"):
    """(kernel's relative L2 error vs float64, every k-step's hi·hi sums
    exact) for random unitaries on random slabs of the trailing pair; in a
    reduced mode, (error vs float64, error vs the plain version's model)."""
    rng = np.random.default_rng(seed)
    shape = (slabs, d1, d2)
    w1, w2, x = _random_pair(d1, d2, shape, rng)
    diag = _diagonals(slabs, d1, d2, rng)
    want = ((w1[0].astype(F64) + 1j * w1[1]) @ (x.astype(np.complex128) * diag)
            @ (w2[0].astype(F64) + 1j * w2[1]).T)
    got, exact = tc_pair(x * diag, w1, w2, mode, tile)   # float32 products
    if mode != "f32":
        return _rel(got, want), _rel(got, plain_pair_bf16(x * diag, w1, w2,
                                                          mode))
    return _rel(got, want), exact


def _middle_diagonals(a, d1, d2, b, rng):
    """ΦF of the middle pair as one complex64 factor an element of the
    (A, D1, D2, B) view, from its flat indices ((a D1 + j) D2 + m) B + b:
    three flips, a phase on a pattern of a-, j-, m- and b-bits, one on a j
    and an m bit, one on an a and a b bit."""
    lb, lm, lj = (int(np.log2(v)) for v in (b, d2, d1))
    flat = np.arange(a * d1 * d2 * b)
    bit_a, bit_j, bit_m, bit_b = (1 << (lb + lm + lj), 1 << (lb + lm),
                                  1 << lb, 1)
    top_j, top_m, top_b = (1 << (lb + lm + lj - 1), 1 << (lb + lm - 1),
                           1 << (lb - 1))
    f = np.ones(flat.size, np.complex64)
    f[rng.integers(0, flat.size, size=3)] *= -1
    mask = bit_a | bit_j | top_m | top_b
    want = mask & int(rng.integers(0, 2**62))
    f[(flat & mask) == want] *= np.complex64(np.exp(0.7j))
    f[(flat & (top_j | bit_m)) == top_j] *= np.complex64(-1)
    f[(flat & (bit_a | bit_b)) == (bit_a | bit_b)] *= np.complex64(
        np.exp(-1.3j))
    return f.reshape(a, d1, d2, b)


def emulate_middle(d1: int, d2: int, a: int = 2, b: int = 4, seed: int = 0,
                   mode: str = "f32", tile: str = "k16"):
    """As :func:`emulate`, for the middle pair: the slabs are the b-columns
    of a (D1, D2, B) view, the flips and phases at their flat indices."""
    rng = np.random.default_rng(seed)
    w1, w2, x = _random_pair(d1, d2, (a, d1, d2, b), rng)
    diag = _middle_diagonals(a, d1, d2, b, rng)
    want = np.einsum("ij,ajmb,lm->ailb", w1[0].astype(F64) + 1j * w1[1],
                     x.astype(np.complex128) * diag,
                     w2[0].astype(F64) + 1j * w2[1])
    slabs = (x * diag).transpose(0, 3, 1, 2).reshape(a * b, d1, d2)
    got, exact = tc_pair(slabs, w1, w2, mode, tile)

    def view(out):
        return out.reshape(a, b, d1, d2).transpose(0, 2, 3, 1)
    if mode != "f32":
        return _rel(view(got), want), _rel(got, plain_pair_bf16(slabs, w1,
                                                                w2, mode))
    return _rel(view(got), want), exact


@pytest.mark.parametrize("d2", WIDTHS)
@pytest.mark.parametrize("d1", WIDTHS)
def test_pair_split_sums_are_exact_and_within_f64_limit(d1, d2):
    err, exact = emulate(d1, d2, seed=d1 + 3 * d2)
    assert exact
    assert err <= F64_TOL


@pytest.mark.parametrize("d2", WIDTHS)
@pytest.mark.parametrize("d1", MIDDLE_WIDTHS)
def test_middle_pair_split_sums_are_exact_and_within_f64_limit(d1, d2):
    err, exact = emulate_middle(d1, d2, seed=d1 + 5 * d2)
    assert exact
    assert err <= F64_TOL


# relative L2 of a reduced-mode pair against its plain version's model
BF16_PLAIN_TOL = {"bf16_3x": 1e-5, "bf16": 1e-4}


@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
@pytest.mark.parametrize("d2", WIDTHS)
@pytest.mark.parametrize("d1", WIDTHS)
def test_bf16_pair_within_its_limits(d1, d2, mode):
    err, vs_plain = emulate(d1, d2, seed=d1 + 3 * d2, mode=mode, tile="k8")
    assert err <= BF16_F64_TOL[mode]
    assert vs_plain <= BF16_PLAIN_TOL[mode]


@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
@pytest.mark.parametrize("d2", WIDTHS)
@pytest.mark.parametrize("d1", MIDDLE_WIDTHS)
def test_bf16_middle_pair_within_its_limits(d1, d2, mode):
    err, vs_plain = emulate_middle(d1, d2, seed=d1 + 5 * d2, mode=mode,
                                   tile="k8")
    assert err <= BF16_F64_TOL[mode]
    assert vs_plain <= BF16_PLAIN_TOL[mode]



# ---------------------------------------------------------------------------
# csrc/pair_bf16.cuh: the reduced pairs on mma.sync.m16n8k16
# ---------------------------------------------------------------------------

PAIR_ORIENTATIONS = [("trailing", d1, d2) for d1 in WIDTHS for d2 in WIDTHS] \
    + [("middle", d1, d2) for d1 in MIDDLE_WIDTHS for d2 in WIDTHS]


@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
@pytest.mark.parametrize("orientation,d1,d2", PAIR_ORIENTATIONS,
                         ids=lambda v: str(v))
def test_k16_pair_within_its_limits(orientation, d1, d2, mode):
    """The k16 pair (both products on m16n8k16, Y split once) in both
    orientations: within the mode's float64 limit and within its limit of
    the plain version's model, the limits the k8 tile was held to."""
    if orientation == "trailing":
        err, vs_plain = emulate(d1, d2, seed=d1 + 3 * d2, mode=mode)
    else:
        err, vs_plain = emulate_middle(d1, d2, seed=d1 + 5 * d2, mode=mode)
    assert err <= BF16_F64_TOL[mode]
    assert vs_plain <= BF16_PLAIN_TOL[mode]


def w1_fragment_word(d1: int, rows: int, mt: int, ks: int, lane: int, r: int):
    """(row, j) of the low half of word r of lane ``lane``'s A fragment of
    m-tile ``mt`` and k16-step ``ks`` of a block's ``rows`` rows of W1, as
    pair_bf16.cuh's prologue writes it (the high half holds j + 1), or None
    where the word is zero."""
    g, t = lane >> 2, lane & 3
    row, j = 16 * mt + g + 8 * (r & 1), 16 * ks + 2 * t + 8 * (r >> 1)
    return (row, j) if row < rows and j < d1 else None


def x_fragment_slot(d1: int, ks: int, lane: int, e: int):
    """(column g, j) of element e of a lane's B fragment of phase 1, as the
    copying thread places it (b[0] packs e = 0, 1, b[1] e = 2, 3), or None
    past D1."""
    g, t = lane >> 2, lane & 3
    j = 16 * ks + 2 * t + (e & 1) + 8 * (e >> 1)
    return (g, j) if j < d1 else None


def y_fragment_word(d2: int, kk: int, lane: int, r: int):
    """(accumulator n-tile, element q) of phase 1 that word r's low half of
    a lane's phase-2 A fragment of k16-step kk packs (the high half packs
    q + 1), or None where it is zero (D2 = 8)."""
    nt = 2 * kk + (r >> 1)
    return (nt, 2 * (r & 1)) if 8 * nt < d2 else None


def w2_fragment_word(d2: int, lt: int, kk: int, lane: int, r: int):
    """(l, m, plane) of the low half of word r of lane ``lane``'s B fragment
    of l-tile ``lt`` and k16-step ``kk`` ({re b0, re b1, im b0, im b1}; the
    high half holds m + 1), or None past D2."""
    g, t = lane >> 2, lane & 3
    m = 16 * kk + 2 * t + 8 * (r & 1)
    return (8 * lt + g, m, r >> 1) if m < d2 else None


def _mma_k16(a_slot, b_slot):
    """Σ_k A[row, k] B[k, col] of one m16n8k16 from the operands' slots:
    a_slot(lane, r, half) and b_slot(lane, reg, half) give the value the
    lane holds there.  A's words 0-3 are rows g, g + 8, g, g + 8 at k = 2t
    (words 0, 1) and 2t + 8 (words 2, 3), low half first; B's registers
    column g at k = 2t, 2t + 1 (b[0]) and 2t + 8, 2t + 9 (b[1]).  Returns
    the (16, 8) product and each lane's C: rows g (q = 0, 1), g + 8 (q = 2,
    3) at columns 2t + (q & 1)."""
    a, b = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for r in range(4):
            for half in range(2):
                a[g + 8 * (r & 1), 2 * t + 8 * (r >> 1) + half] = \
                    a_slot(lane, r, half)
        for reg in range(2):
            for half in range(2):
                b[2 * t + 8 * reg + half, g] = b_slot(lane, reg, half)
    return a @ b


@pytest.mark.parametrize("d1,d2", [(8, 8), (8, 128), (32, 16), (64, 128),
                                   (128, 32), (128, 128)])
def test_k16_pair_fragments_give_both_operands_the_same_j(d1, d2):
    """With pair_bf16.cuh's pre-split W1 fragments, the slots the copying
    threads give X, phase 1's C fragments reused as phase 2's A fragments
    and W2's pre-split fragments, the slot sums of both products are
    W1 · X · W2ᵀ for a block's IN = min(D1, 64) rows of W1: each operand's
    k slots hold the same j (phase 1) or m (phase 2) on both sides."""
    rng = np.random.default_rng(d1 + d2)
    rows = min(d1, 64)
    w1 = _bf16(rng.normal(size=(d1, d1)).astype(F32)).astype(F64)
    w2 = _bf16(rng.normal(size=(d2, d2)).astype(F32)).astype(F64)
    x = _bf16(rng.normal(size=(d1, d2)).astype(F32)).astype(F64)
    mts, ks1, ks2 = max(1, rows // 16), max(1, d1 // 16), max(1, d2 // 16)
    want_y = w1[:rows] @ x
    out = np.zeros((16 * mts, d2))
    for mt in range(mts):
        # phase 1: the warp's C fragments of every n-tile of m
        cfrag = {}
        for nt in range(d2 // 8):
            c = np.zeros((16, 8))
            for ks in range(ks1):
                def a_slot(lane, r, half):
                    rj = w1_fragment_word(d1, rows, mt, ks, lane, r)
                    return 0.0 if rj is None else w1[rj[0], rj[1] + half]

                def b_slot(lane, reg, half):
                    gj = x_fragment_slot(d1, ks, lane, 2 * reg + half)
                    return 0.0 if gj is None else x[gj[1], 8 * nt + gj[0]]
                c += _mma_k16(a_slot, b_slot)
            rows_mt = slice(16 * mt, min(16 * mt + 16, rows))
            np.testing.assert_array_equal(
                c[:rows_mt.stop - rows_mt.start], want_y[rows_mt,
                                                         8 * nt:8 * nt + 8])
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                cfrag[nt, lane] = [c[g + 8 * (q >> 1), 2 * t + (q & 1)]
                                   for q in range(4)]
        # phase 2: those C fragments as A, W2's fragments as B
        for lt in range(d2 // 8):
            o = np.zeros((16, 8))
            for kk in range(ks2):
                def ya_slot(lane, r, half):
                    nq = y_fragment_word(d2, kk, lane, r)
                    return 0.0 if nq is None else \
                        cfrag[nq[0], lane][nq[1] + half]

                def w2_slot(lane, reg, half):
                    lmp = w2_fragment_word(d2, lt, kk, lane, reg)
                    return 0.0 if lmp is None else w2[lmp[0], lmp[1] + half]
                o += _mma_k16(ya_slot, w2_slot)
            out[16 * mt:16 * mt + 16, 8 * lt:8 * lt + 8] = o
    np.testing.assert_allclose(out[:rows], want_y @ w2.T, rtol=1e-12,
                               atol=1e-12)


def pair_shrink(d1: int, d2: int, tile: str, seed: int, passes: int = 8,
                slabs: int = 32) -> float:
    """The norm the bf16_3x pair's truncating sums take from random slabs
    over ``passes`` applications of one random (W1, W2), against the same
    products summed to nearest: its share of the paired plans' drift."""
    def norm_after(rounding):
        rng = np.random.default_rng(seed)
        w1, w2, x = _random_pair(d1, d2, (slabs, d1, d2), rng)
        n0 = np.sum(np.abs(x.astype(np.complex128)) ** 2)
        for _ in range(passes):
            x = tc_pair(x, w1, w2, "bf16_3x", tile, rounding)[0].astype(
                np.complex64)
        return np.sum(np.abs(x.astype(np.complex128)) ** 2) / n0

    def rn(x):
        return x.astype(F32)
    return norm_after(rn) - norm_after(_rz)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k16_pair_shrinks_the_norm_less_than_three_k8_pairs(seed):
    """A sum of 16 bf16 products is exact in float32 less often than one of
    8: with a plane's two hi·hi terms chained into one k16 sum (PR 9's
    pair) the truncating sums shrank the norm 1.4-2.8 times as much as the
    k8 tile's over 8 seeds at (128, 128) and (32, 128), mean 1.9 (PERF.md
    §6, PR 9), still asserted here between 1 and 3 times for the chained
    form.  With the two terms summed apart, as the kernel sums them now,
    each truncated sum is of 16 products, as in the k8 tile: the shrink
    falls below the chained form's and stays below three k8 pairs' (0.64-
    0.99 of the k8 tile's over 6 seeds), at (32, 64) on 32 slabs (fewer
    slabs leave the difference of the two roundings to chance);
    chip_smoke.py phases 7 and 8 hold the card to 1e-6 per 100 gates."""
    k8 = pair_shrink(32, 64, "k8", seed)
    k16 = pair_shrink(32, 64, "k16", seed)
    k16_chained = pair_shrink(32, 64, "k16_chained", seed)
    assert 0 < k8 < k16_chained < 3 * k8
    assert 0 < k16 < k16_chained and k16 < 3 * k8


# ---------------------------------------------------------------------------
# the narrow pairs: the D2 window's tile, W1 mixed into its operand
# ---------------------------------------------------------------------------

def narrow_cols(bn: int, d1: int, trailing: bool, log_b: int):
    """(window_col, col) of csrc/tc_tile.cuh's Narrow<BN, BK, PITCH, D1,
    TRAIL, NTHR>: the D2 window's column of a tile column, and the tile
    column of base column cb's slot j."""
    bnb = bn // d1

    def window_col(c):
        if trailing:
            return c
        cl = c & (bn - 1)
        base = (c - cl) // d1 + (cl & (bnb - 1))
        return (((base >> log_b) * d1 + cl // bnb) << log_b) | (
            base & ((1 << log_b) - 1))

    def col(cb, j):
        return cb * d1 + j if trailing else j * bnb + cb
    return window_col, col


def narrow_elements(bn: int, bk: int, d1: int, trailing: bool, nthr: int):
    """The (base column, k) of every thread's elements q < Q of a stage in
    Narrow::element: the k fastest in the trailing pair, the base column in
    the middle pair."""
    bnb = bn // d1
    q_count = bnb * bk // nthr
    assert q_count >= 1 and q_count * nthr == bnb * bk
    for tid in range(nthr):
        for q in range(q_count):
            e = tid + q * nthr
            yield (e // bk, e % bk) if trailing else (e % bnb, e // bnb)


# (D2, BN) of the tiles at D1 > 1: F32 128 columns at D2 <= 32, else 64;
# BF16 walkers of 8 warps, 8 NN columns a warp (NN = 4, 2, 2, 1, 1)
NARROW_TILES = {"f32": {8: 128, 16: 128, 32: 128, 64: 64, 128: 64},
                "bf16": {8: 256, 16: 128, 32: 128, 64: 64, 128: 64}}


@pytest.mark.parametrize("tile", list(NARROW_TILES))
@pytest.mark.parametrize("d2", WIDTHS)
@pytest.mark.parametrize("d1", [2, 4])
@pytest.mark.parametrize("log_a,log_b", [(0, 0), (2, 0), (5, 0), (0, 7),
                                         (1, 10)])
def test_narrow_pair_columns(log_a, log_b, d1, d2, tile):
    """The narrow pair's column map, as window_tc.cuh and window_bf16.cuh
    take it: the tiles' columns give every (a, i, b) of the (A, D1, D2, B)
    view once (a partial last tile at A D1 < BN); the D1 slots of a base
    column are its own (a, b) at j = 0 .. D1 - 1; the pass's elements give
    every base column and k of a stage to one thread; and the BF16 tile's
    float2 stores of columns 2t, 2t + 1 (B > 1) land on b, b + 1."""
    bn = NARROW_TILES[tile][d2]
    trailing = log_b == 0
    window_col, col = narrow_cols(bn, d1, trailing, log_b)
    A, B = 1 << log_a, 1 << log_b
    cols = A * d1 * B

    def col_base(c):
        c = window_col(c)
        return ((c >> log_b) << (log_b + d2.bit_length() - 1)) | (c & (B - 1))

    def decode(flat):
        assert flat // B % d2 == 0
        return flat // (d1 * d2 * B), flat // (d2 * B) % d1, flat % B

    seen = set()
    for c0 in range(0, cols, bn):
        for cl in range(bn):
            if c0 + cl >= cols:
                continue
            seen.add(decode(col_base(c0 + cl)))
            if not trailing and cl % 2 == 0:
                assert col_base(c0 + cl + 1) == col_base(c0 + cl) + 1
        for cb in range(bn // d1):
            if c0 + col(cb, 0) >= cols:
                assert all(c0 + col(cb, j) >= cols for j in range(d1))
                continue
            a, _, b = decode(col_base(c0 + col(cb, 0)))
            for j in range(d1):
                assert decode(col_base(c0 + col(cb, j))) == (a, j, b)
    assert len(seen) == cols
    bk = min(d2, 16)
    elements = list(narrow_elements(bn, bk, d1, trailing, 256))
    assert sorted(elements) == [(cb, k) for cb in range(bn // d1)
                                for k in range(bk)]


def narrow_mix(xr, xi, w1, mode):
    """Y = W1 · x over axis 1 of x (A, D1, R) float32 planes, as the
    kernel's narrow_pass mixes it: for each j the mode's products of
    W1[i, j] and x_j (f32: W x; bf16_3x: the bf16 parts hi·hi, hi·lo,
    lo·hi, W's part first; bf16: hi·hi), each by two FMAs a plane, re
    first −im·im then re·re, im first im·re then re·im."""
    if mode == "f32":
        ws, xs, products = [[w1[0]], [w1[1]]], [[xr], [xi]], ((0, 0),)
    else:
        ws = [_split_bf16(w1[0]), _split_bf16(w1[1])]
        xs = [_split_bf16(xr), _split_bf16(xi)]
        products = ((0, 0), (0, 1), (1, 0)) if mode == "bf16_3x" else (
            (0, 0),)
    yr = np.zeros(xr.shape, F32)
    yi = np.zeros(xr.shape, F32)
    for j in range(xr.shape[1]):
        for pw, px in products:
            w_r, w_i = ws[0][pw][None, :, j, None], ws[1][pw][None, :, j, None]
            x_r, x_i = xs[0][px][:, None, j, :], xs[1][px][:, None, j, :]
            yr = _fma(w_r, x_r, _fma(-w_i, x_i, yr))
            yi = _fma(w_r, x_i, _fma(w_i, x_r, yi))
    return yr, yi


def narrow_pair(x, w1, w2, mode, rounding=_rz, mix=narrow_mix):
    """(out, the f32 tile's k-step hi·hi sums exact) of the narrow pair on
    the phased amplitudes x (A, D1, D2, B), complex64: Y by ``mix``, then
    the D2 window's tile on the columns (a, i, b) of the float32 Y (the
    3xTF32 tile, or the k16 tile with its sums rounded by ``rounding``)."""
    A, d1, d2, B = x.shape
    yr, yi = (mix(x.real.reshape(A, d1, -1).astype(F32),
                  x.imag.reshape(A, d1, -1).astype(F32), w1, mode))

    def cols(y):
        return y.reshape(A, d1, d2, B).transpose(0, 1, 3, 2).reshape(-1, d2)
    if mode == "f32":
        outr, outi, exact = tc_product(cols(yr), cols(yi), *w2)
    else:
        outr, outi = tc_product_bf16_k16(cols(yr), cols(yi), *w2, mode,
                                         rounding)
        exact = False
    out = (outr.astype(F64) + 1j * outi).reshape(A, d1, B, d2)
    return out.transpose(0, 1, 3, 2), exact


NARROW_PAIRS = [(orientation, d1, d2) for orientation in ("trailing",
                                                          "middle")
                for d1 in (2, 4) for d2 in (8, 32, 128)]
# relative L2 of the narrow pair against pair_apply_ref in its mode, and
# against float64 (chip_smoke.py's LIMITS)
NARROW_TOL = {"f32": (1e-5, F64_TOL), "bf16_3x": (1e-5, 2e-5),
              "bf16": (1e-4, 1e-2)}


@pytest.mark.parametrize("mode", list(NARROW_TOL))
@pytest.mark.parametrize("orientation,d1,d2", NARROW_PAIRS,
                         ids=lambda v: str(v))
def test_narrow_pair_replay(orientation, d1, d2, mode):
    """The narrow pair's arithmetic, Y mixed in FP32 in the mode's order,
    then the f32 tile's grids (every k-step's hi·hi sums exact) or the k16
    split, against the port's plain version in the mode and against
    float64, with flips and phases, in both orientations."""
    import torch

    from qbot_tpu_torch.tpu import kernels

    w1w, w2w = d1.bit_length() - 1, d2.bit_length() - 1
    start, log_b = (2, 0) if orientation == "trailing" else (1, 2)
    n = start + w1w + w2w + log_b
    rng = np.random.default_rng(7 * d1 + d2 + len(mode))
    psi = rng.normal(size=(2, 2**n)) * np.exp(rng.normal(size=(2, 2**n)))
    psi = torch.tensor(psi / np.linalg.norm(psi), dtype=torch.float32)
    planes = [np.stack([u.real, u.imag]).astype(F32)
              for u in (_unitary(d1, rng), _unitary(d2, rng))]
    w1, w2 = (torch.from_numpy(p) for p in planes)
    phases = (((max(start - 1, 0), start, start + w1w, n - 1),
               complex(np.exp(0.7j)), 0b1010),
              ((start + w1w - 1,), complex(np.exp(-1.3j)), -1))
    diag = kernels.fused_diagonals(n, (3, 2**n - 5), phases)
    x = kernels._apply_diagonals_ref(psi, diag).numpy()
    x = (x[0] + 1j * x[1]).reshape(2**start, d1, d2, 2**log_b)
    got, exact = narrow_pair(x, planes[0], planes[1], mode)
    got = got.reshape(-1)
    want = kernels.pair_apply_ref(psi, n, start, w1w, w2w, w1, w2, diag,
                                  mode=mode).double().numpy()
    f64 = kernels.pair_apply_ref(psi.double(), n, start, w1w, w2w,
                                 w1.double(), w2.double(), diag,
                                 mode="f32").numpy()
    tol, f64_tol = NARROW_TOL[mode]
    assert _rel(got, want[0] + 1j * want[1]) <= tol
    assert _rel(got, f64[0] + 1j * f64[1]) <= f64_tol
    assert exact or mode != "f32"


@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
@pytest.mark.parametrize("d1", [2, 4])
def test_narrow_pair_y_is_the_fma_window(d1, mode):
    """In the reduced modes the pair's Y is bit for bit the output of the
    reduced FMA window (csrc/window_apply.cu, fma_window_model, tied to
    window_apply_ref by test_fma_window_order_matches_plain_version): the
    pair rounds what its two windows round."""
    rng = np.random.default_rng(d1)
    u = _unitary(d1, rng)
    w1 = [u.real.astype(F32), u.imag.astype(F32)]
    x = rng.normal(size=(2, 3, d1, 40)) * np.exp(rng.normal(size=(2, 3, d1,
                                                                  40)))
    xr, xi = x.astype(F32)
    got = narrow_mix(xr, xi, w1, mode)
    want = fma_window_model(xr, xi, w1[0], w1[1], mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("d1", [2, 4])
def test_narrow_pair_shrinks_the_norm_as_its_two_windows(d1, seed):
    """bf16_3x: the truncation shrink of 8 narrow (D1, 64) pairs on 128
    slabs, their sums rounded toward zero against to nearest, equals that
    of their two windows (the reduced FMA window, then the k16 window on its
    float32 output), over several seeds: the narrow pairs leave the
    brickwork's drift where the unpaired plan has it (its sign, at this
    size, is chance: the k16 sums' shrink is a few 1e-8)."""
    def shrink(mix):
        def norm_after(rounding):
            r = np.random.default_rng(seed)
            w1, w2, x = _random_pair(d1, 64, (128, d1, 64), r)
            x = x[..., None]
            n0 = np.sum(np.abs(x.astype(np.complex128)) ** 2)
            for _ in range(8):
                x = narrow_pair(x, w1, w2, "bf16_3x", rounding,
                                mix)[0].astype(np.complex64)
            return np.sum(np.abs(x.astype(np.complex128)) ** 2) / n0
        return norm_after(lambda v: v.astype(F32)) - norm_after(_rz)

    pair = shrink(narrow_mix)
    windows = shrink(lambda xr, xi, w, mode: fma_window_model(
        xr, xi, w[0], w[1], mode))
    assert pair == windows

if __name__ == "__main__":
    for d1 in WIDTHS:
        for d2 in WIDTHS:
            err, exact = emulate(d1, d2)
            print(f"trailing (D1, D2) = ({d1:3d}, {d2:3d}): emulated kernel "
                  f"{err:.3e} relative L2 vs float64; exact sums {exact}")
    for d1 in MIDDLE_WIDTHS:
        for d2 in WIDTHS:
            err, exact = emulate_middle(d1, d2)
            print(f"middle (D1, D2) = ({d1:3d}, {d2:3d}): emulated kernel "
                  f"{err:.3e} relative L2 vs float64; exact sums {exact}")
    for mode in ("bf16_3x", "bf16"):
        for d1 in WIDTHS:
            for d2 in WIDTHS:
                err, vs_plain = emulate(d1, d2, mode=mode)
                print(f"{mode} trailing (D1, D2) = ({d1:3d}, {d2:3d}): "
                      f"emulated kernel {err:.3e} vs float64, {vs_plain:.3e} "
                      f"vs its plain version")
