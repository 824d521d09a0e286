"""The arithmetic of ``csrc/window_apply.cu``'s 3xTF32 split, in numpy.

The kernel splits x = hi + lo on a grid per column and k-step of 8 (W per
row and k-step), so that each k-step's hi·hi sums are exact on tensor
cores that round toward zero, and takes x W = x_hi W_hi + x_hi W_lo +
x_lo tf32(W).  These tests replay that arithmetic with float32 numpy
operations: the sums are exactly representable in float32, and the whole
product stays within the kernel's float64 limit (chip_smoke.py's F64_TOL,
2e-6) at every window width.

    python3 tests/test_torch_window_split.py

prints the emulated relative L2 error against float64 at D = 8..128
beside that of plain float32 products.
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


if __name__ == "__main__":
    for d in (8, 16, 32, 64, 128):
        err, plain, exact = emulate(d)
        print(f"D = {d:3d}: emulated kernel {err:.3e}, plain float32 "
              f"{plain:.3e} relative L2 vs float64; exact sums {exact}")
