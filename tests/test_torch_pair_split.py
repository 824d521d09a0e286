"""The arithmetic of ``csrc/pair_apply.cu``'s tensor-core trailing pair, in
numpy.

The kernel computes out = W1 · (ΦF X) · W2ᵀ on each (D1, D2) slab X as two
products of the window kernel's 3xTF32 tile (``csrc/tc_tile.cuh``):

- phase 1, Y[j, l] = Σ_m X[j, m] W2[l, m]: X split on a grid per row j and
  k-step of 8 m, W2 per row l and k-step;
- phase 2, out[i, l] = Σ_j W1[i, j] Y[j, l] on the float32 Y: Y split on a
  grid per column l and k-step of 8 j, W1 per row i and k-step.

Each k-step's hi·hi sums (two mma.sync products) are exact; the cross terms
x_hi W_lo + x_lo tf32(W) are summed over a stage of 16 k on the tensor
cores, which round each sum toward zero; the sums go to float32
accumulators by round-to-nearest adds.  These tests replay that with
float32 numpy operations (products summed in float64, then rounded as the
tensor cores round), on slabs of amplitudes of many sizes with a few flips
and phases: every k-step's hi·hi sums are exactly representable, and the
pair stays within chip_smoke.py's float64 limit (F64_TOL, 2e-6) at every
(D1, D2) of the tensor-core variant.

    python3 tests/test_torch_pair_split.py

prints the emulated relative L2 error against float64 at every (D1, D2).
"""
from __future__ import annotations

import numpy as np
import pytest

from test_torch_window_split import F32, F64_TOL, _grid, _split, _tf32, \
    _unitary

F64 = np.float64
WIDTHS = [8, 16, 32, 64, 128]
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


def emulate(d1: int, d2: int, slabs: int = 2, seed: int = 0):
    """(kernel's relative L2 error vs float64, every k-step's hi·hi sums
    exact) for random unitaries on random slabs."""
    rng = np.random.default_rng(seed)
    u1, u2 = _unitary(d1, rng), _unitary(d2, rng)
    w1 = [u1.real.astype(F32), u1.imag.astype(F32)]
    w2 = [u2.real.astype(F32), u2.imag.astype(F32)]
    shape = (slabs, d1, d2)
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    x *= np.exp(rng.normal(size=shape))             # amplitudes of many sizes
    x = x.astype(np.complex64)
    diag = _diagonals(slabs, d1, d2, rng)
    want = ((w1[0].astype(F64) + 1j * w1[1]) @ (x.astype(np.complex128) * diag)
            @ (w2[0].astype(F64) + 1j * w2[1]).T)
    xd = x * diag                                   # float32 complex products
    # phase 1: rows (s, j), K = m
    yr, yi, exact1 = tc_product(xd.real.reshape(-1, d2),
                                xd.imag.reshape(-1, d2), *w2)
    # phase 2: columns (s, l), K = j, from the float32 Y
    def cols(y):
        return y.reshape(shape).transpose(0, 2, 1).reshape(-1, d1)

    outr, outi, exact2 = tc_product(cols(yr), cols(yi), *w1)
    got = (outr.astype(F64) + 1j * outi).reshape(slabs, d2, d1)
    got = got.transpose(0, 2, 1)
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    return err, exact1 and exact2


@pytest.mark.parametrize("d2", WIDTHS)
@pytest.mark.parametrize("d1", WIDTHS)
def test_pair_split_sums_are_exact_and_within_f64_limit(d1, d2):
    err, exact = emulate(d1, d2, seed=d1 + 3 * d2)
    assert exact
    assert err <= F64_TOL


if __name__ == "__main__":
    for d1 in WIDTHS:
        for d2 in WIDTHS:
            err, exact = emulate(d1, d2)
            print(f"(D1, D2) = ({d1:3d}, {d2:3d}): emulated kernel {err:.3e} "
                  f"relative L2 vs float64; exact sums {exact}")
