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

In the reduced modes (``bf16_3x``, ``bf16``) each product is the BF16
tile of ``tests/test_torch_window_split.py`` (``tc_product_bf16``), and
phase 2 splits the float32 Y anew, as the reference's second ``_dot``
does: the replays hold each mode to chip_smoke.py's float64 limits (2e-5,
1e-2) and to its plain version's model (float64 sums, Y rounded to float32
between the products) within 1e-5, bf16 within 1e-4 (its Y is rounded to
bf16 a second time, so a one-ulp difference in Y moves a rounding).

    python3 tests/test_torch_pair_split.py

prints the emulated relative L2 error against float64 at every (D1, D2).
"""
from __future__ import annotations

import numpy as np
import pytest

from test_torch_window_split import BF16_F64_TOL, F32, F64_TOL, _grid, \
    _split, _tf32, _unitary, plain_model_bf16, tc_product_bf16

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


def tc_pair(xd, w1, w2, mode="f32"):
    """(out, every k-step's hi·hi sums exact): W1 · X · W2ᵀ of each
    (D1, D2) slab of xd (slabs, D1, D2), complex64, as the kernel computes
    it in dot ``mode`` (the reduced modes' sums are not exact: False)."""
    slabs, d1, d2 = xd.shape

    def product(xr, xi, wr, wi):
        if mode == "f32":
            return tc_product(xr, xi, wr, wi)
        return (*tc_product_bf16(xr, xi, wr, wi, mode), False)

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
            mode: str = "f32"):
    """(kernel's relative L2 error vs float64, every k-step's hi·hi sums
    exact) for random unitaries on random slabs of the trailing pair; in a
    reduced mode, (error vs float64, error vs the plain version's model)."""
    rng = np.random.default_rng(seed)
    shape = (slabs, d1, d2)
    w1, w2, x = _random_pair(d1, d2, shape, rng)
    diag = _diagonals(slabs, d1, d2, rng)
    want = ((w1[0].astype(F64) + 1j * w1[1]) @ (x.astype(np.complex128) * diag)
            @ (w2[0].astype(F64) + 1j * w2[1]).T)
    got, exact = tc_pair(x * diag, w1, w2, mode)   # float32 complex products
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
                   mode: str = "f32"):
    """As :func:`emulate`, for the middle pair: the slabs are the b-columns
    of a (D1, D2, B) view, the flips and phases at their flat indices."""
    rng = np.random.default_rng(seed)
    w1, w2, x = _random_pair(d1, d2, (a, d1, d2, b), rng)
    diag = _middle_diagonals(a, d1, d2, b, rng)
    want = np.einsum("ij,ajmb,lm->ailb", w1[0].astype(F64) + 1j * w1[1],
                     x.astype(np.complex128) * diag,
                     w2[0].astype(F64) + 1j * w2[1])
    slabs = (x * diag).transpose(0, 3, 1, 2).reshape(a * b, d1, d2)
    got, exact = tc_pair(slabs, w1, w2, mode)

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
    err, vs_plain = emulate(d1, d2, seed=d1 + 3 * d2, mode=mode)
    assert err <= BF16_F64_TOL[mode]
    assert vs_plain <= BF16_PLAIN_TOL[mode]


@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
@pytest.mark.parametrize("d2", WIDTHS)
@pytest.mark.parametrize("d1", MIDDLE_WIDTHS)
def test_bf16_middle_pair_within_its_limits(d1, d2, mode):
    err, vs_plain = emulate_middle(d1, d2, seed=d1 + 5 * d2, mode=mode)
    assert err <= BF16_F64_TOL[mode]
    assert vs_plain <= BF16_PLAIN_TOL[mode]


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
