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

    python3 tests/test_torch_window_split.py

prints the emulated relative L2 error against float64 at D = 8..128
beside that of plain float32 products, in every mode.
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


def drift(d: int, mode: str, passes: int, rounding, seed: int = 0):
    """The norm of random columns after ``passes`` applications of one
    random unitary window through the replayed tile."""
    rng = np.random.default_rng(seed)
    u = _unitary(d, rng)
    wr, wi = u.real.astype(F32), u.imag.astype(F32)
    xr, xi = _columns(d, 256, rng)
    n0 = np.linalg.norm(xr.astype(F64)) ** 2 + np.linalg.norm(xi) ** 2
    for _ in range(passes):
        xr, xi = tc_product_bf16(xr, xi, wr, wi, mode, rounding)
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


if __name__ == "__main__":
    for d in (8, 16, 32, 64, 128):
        err, plain, exact = emulate(d)
        print(f"D = {d:3d}: emulated kernel {err:.3e}, plain float32 "
              f"{plain:.3e} relative L2 vs float64; exact sums {exact}")
        for mode in ("bf16_3x", "bf16"):
            err, vs_plain = emulate_bf16(d, mode)
            print(f"    {mode}: emulated kernel {err:.3e} vs float64, "
                  f"{vs_plain:.3e} vs its plain version")
    for mode in ("bf16_3x", "bf16"):
        print(f"{mode}: norm after 16 passes at D = 64 "
              f"{drift(64, mode, 16, _rz):.9f} (sums rounded toward zero)")
