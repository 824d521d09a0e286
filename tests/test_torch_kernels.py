"""The port's kernel wrappers on the CPU (their plain PyTorch versions) vs
the JAX package's Pallas kernels in interpret mode, on the same numpy-seeded
inputs.

Tolerance: 1e-5 absolute on amplitudes of a normalised 10- to 14-qubit state
(float32 products and sums over at most 128 terms, or two such sums for a
pair, taken in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qbot_tpu.tpu import kernels as jk
from qbot_tpu_torch.tpu import kernels as tk

torch.set_num_threads(1)

TOL = 1e-5


@pytest.fixture
def interpret_kernels():
    jk.set_kernel_mode("interpret")
    try:
        yield
    finally:
        jk.set_kernel_mode("auto")


def _rand_state(n, rng):
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    psi /= np.linalg.norm(psi)
    return np.stack([psi.real, psi.imag]).astype(np.float32)


def _rand_unitary(d, rng):
    q, r = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


# (n, start, width): middle window (B >= 128, the left-multiply kernel),
# trailing window (B == 1, right-multiply) and small B (XLA fallback)
GEOMETRIES = {"middle": (10, 1, 2), "trailing": (10, 3, 7),
              "small_b": (10, 0, 7)}
SEEDS = {"middle": 1, "trailing": 2, "small_b": 3}


def _diagonals(n, start, width, rng):
    """Flips and phases whose want bits include 0, on a-, j- and b-bits."""
    a_bits = list(range(start))
    j_bits = list(range(start, start + width))
    b_bits = list(range(start + width, n))
    qa = a_bits[-1:]
    qj = [j_bits[0], j_bits[-1]]
    qb = b_bits[:1]
    phases = [(tuple(qa + qj + qb), complex(np.exp(0.9j)), 0),
              (tuple(qj), complex(np.exp(-0.4j)), 0b10),
              (tuple(qa + qb) or (j_bits[0],), -1.0 + 0j, -1)]
    flips = tuple(int(m) for m in rng.integers(0, 2**n, size=3))
    return flips, tuple(phases)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_window_apply_matches_pallas(geometry, fused, interpret_kernels):
    n, start, width = GEOMETRIES[geometry]
    rng = np.random.default_rng(SEEDS[geometry] + 10 * fused)
    psi = _rand_state(n, rng)
    W = _rand_unitary(2**width, rng)
    flips, phases = _diagonals(n, start, width, rng) if fused else ((), ())

    want = jk.planar_window_apply(
        jnp.asarray(psi), n, start, width,
        jnp.asarray(W.real, jnp.float32), jnp.asarray(W.imag, jnp.float32),
        flips, phases)
    w = torch.from_numpy(np.stack([W.real, W.imag]).astype(np.float32))
    diag = tk.fused_diagonals(n, flips, phases)
    got = tk.window_apply(torch.from_numpy(psi), n, start, width, w, diag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


# (n, start, width1, width2) of a pair, one per route of
# qbot_tpu/tpu/kernels.py:652-706: trailing pair (B = 1, _pair_b1), middle
# pair (B = 128, D1 <= 32, _pair_bt), and two windows for D1 > 32 with
# B = 128 and for 1 < B < 128
PAIR_GEOMETRIES = {"trailing": (10, 2, 4, 4), "middle": (12, 0, 2, 3),
                   "two_windows_wide": (14, 0, 6, 1),
                   "two_windows_small_b": (12, 2, 3, 3)}


def _pair_diagonals(n, start, width1, width2, rng):
    """Flips, and phases on a-, j-, m- and b-bits whose want bits include
    0."""
    qa = list(range(start))[-1:]
    qj = [start, start + width1 - 1]
    qm = [start + width1 + width2 - 1]
    qb = list(range(start + width1 + width2, n))[:1]
    phases = ((tuple(qa + qj + qm + qb), complex(np.exp(0.9j)), 0b0100),
              (tuple(qj + qm), complex(np.exp(-0.4j)), 0),
              (tuple(qa + qb) or (qm[0],), -1.0 + 0j, -1))
    flips = tuple(int(m) for m in rng.integers(0, 2**n, size=3))
    return flips, phases


@pytest.mark.parametrize("fused", ["flips", "phases"])
@pytest.mark.parametrize("geometry", list(PAIR_GEOMETRIES))
def test_pair_apply_matches_pallas(geometry, fused, interpret_kernels):
    n, start, width1, width2 = PAIR_GEOMETRIES[geometry]
    rng = np.random.default_rng(n + start + width1 + 10 * (fused == "flips"))
    psi = _rand_state(n, rng)
    W1 = _rand_unitary(2**width1, rng)
    W2 = _rand_unitary(2**width2, rng)
    flips, phases = _pair_diagonals(n, start, width1, width2, rng)
    if fused == "flips":
        phases = ()
    else:
        flips = ()

    want = jk.planar_pair_window_apply(
        jnp.asarray(psi), n, start, width1, start + width1, width2,
        *(jnp.asarray(x, jnp.float32) for x in (W1.real, W1.imag, W2.real,
                                               W2.imag)),
        flips, phases)
    w1, w2 = (torch.from_numpy(np.stack([W.real, W.imag]).astype(np.float32))
              for W in (W1, W2))
    diag = tk.fused_diagonals(n, flips, phases)
    got = tk.pair_apply(torch.from_numpy(psi), n, start, width1, width2, w1,
                        w2, diag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("geometry,route", [
    ("trailing", "trailing"), ("middle", "middle"),
    ("two_windows_wide", "two_windows"),
    ("two_windows_small_b", "two_windows")])
def test_pair_route_matches_pallas_dispatch(geometry, route):
    assert tk.pair_route(*PAIR_GEOMETRIES[geometry]) == route


def test_pair_apply_is_two_windows():
    """The pair equals its first window (with the diagonals) then its
    second, on the CPU."""
    rng = np.random.default_rng(4)
    n, start, width1, width2 = 9, 1, 3, 2
    psi = torch.from_numpy(_rand_state(n, rng))
    w1, w2 = (torch.from_numpy(np.stack([U.real, U.imag]).astype(np.float32))
              for U in (_rand_unitary(8, rng), _rand_unitary(4, rng)))
    flips, phases = _pair_diagonals(n, start, width1, width2, rng)
    diag = tk.fused_diagonals(n, flips, phases)
    got = tk.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
    want = tk.window_apply(tk.window_apply(psi, n, start, width1, w1, diag),
                           n, start + width1, width2, w2,
                           tk.fused_diagonals(n))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)


@pytest.mark.parametrize("H,T", [(8, 128), (16, 256)])
def test_reflect_kernels_match_pallas(H, T, interpret_kernels):
    rng = np.random.default_rng(H + T)
    n = (H * T).bit_length() - 1
    p3 = _rand_state(n, rng).reshape(2, H, T)

    def unit(d):
        v = rng.normal(size=d) + 1j * rng.normal(size=d)
        v /= np.linalg.norm(v)
        return np.stack([v.real, v.imag]).astype(np.float32)

    a = unit(H).reshape(2, H, 1)
    b = unit(T).reshape(2, 1, T)
    c = (rng.normal(size=2) * 0.1).astype(np.float32)
    flips = tuple(int(m) for m in rng.integers(0, H * T, size=2))

    d_want = jk.planar_reflect_dot(jnp.asarray(p3), jnp.asarray(a),
                                   jnp.asarray(b))
    out_want, dd_want = jk.planar_reflect_update(
        jnp.asarray(p3), jnp.asarray(c), jnp.asarray(a), jnp.asarray(b),
        flips)

    tp, ta, tb = (torch.from_numpy(x) for x in (p3, a, b))
    d_got = tk.reflect_dot(tp, ta, tb)
    out_got, dd_got = tk.reflect_update(
        tp, torch.from_numpy(c), ta, tb,
        torch.tensor(flips, dtype=torch.int64))
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want), atol=TOL)
    np.testing.assert_allclose(out_got.numpy(), np.asarray(out_want),
                               atol=TOL)
    np.testing.assert_allclose(dd_got.numpy(), np.asarray(dd_want),
                               atol=TOL)


def test_phase_bits_match_pattern_convention():
    # qubit q is bit n-1-q; pattern bit k-1-j belongs to qubits[j]
    assert tk.phase_bits(4, (0, 3), 0b10) == (0b1001, 0b1000)
    assert tk.phase_bits(4, (2,), -1) == (0b0010, 0b0010)
    assert tk.phase_bits(4, (3, 1), 0) == (0b0101, 0)


def test_duplicate_flips_cancel():
    psi = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    diag = tk.fused_diagonals(2, (1, 1, 2))
    w = torch.stack([torch.eye(2), torch.zeros(2, 2)])
    out = tk.window_apply(psi, 2, 1, 1, w, diag)
    np.testing.assert_array_equal(out.numpy(), [[0, 1, -2, 3],
                                                [4, 5, -6, 7]])


class TestWrapperChecks:
    """A wrapper refuses what its kernel does not take, and never falls
    back to the plain version off the CPU."""

    def _window_args(self, n=4):
        psi = torch.zeros(2, 2**n)
        w = torch.stack([torch.eye(4), torch.zeros(4, 4)])
        return psi, w, tk.fused_diagonals(n)

    def test_rejects_dtype(self):
        psi, w, diag = self._window_args()
        with pytest.raises(ValueError, match="float32"):
            tk.window_apply(psi.double(), 4, 0, 2, w, diag)

    def test_rejects_shape(self):
        psi, w, diag = self._window_args()
        with pytest.raises(ValueError, match="shape"):
            tk.window_apply(psi, 4, 0, 3, w, diag)

    def test_rejects_non_contiguous(self):
        psi = torch.zeros(2 ** 4, 2).t()
        _, w, diag = self._window_args()
        with pytest.raises(ValueError, match="contiguous"):
            tk.window_apply(psi, 4, 0, 2, w, diag)

    def test_rejects_window_outside_register(self):
        psi, w, diag = self._window_args()
        with pytest.raises(ValueError, match="does not fit"):
            tk.window_apply(psi, 4, 3, 2, w, diag)

    def test_other_devices_raise(self):
        psi = torch.zeros(2, 16, device="meta")
        w = torch.zeros(2, 4, 4, device="meta")
        diag = tk.fused_diagonals(4, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tk.window_apply(psi, 4, 0, 2, w, diag)

    def test_pair_rejects_windows_outside_register(self):
        psi, w, diag = self._window_args()
        with pytest.raises(ValueError, match="do not fit"):
            tk.pair_apply(psi, 4, 1, 2, 2, w, w, diag)

    def test_pair_rejects_matrix_shape(self):
        psi, w, diag = self._window_args()
        with pytest.raises(ValueError, match="w2 must have shape"):
            tk.pair_apply(psi, 4, 0, 2, 1, w, w, diag)

    def test_reflect_rejects_mismatched_tables(self):
        p3 = torch.zeros(2, 8, 16)
        with pytest.raises(ValueError, match="shape"):
            tk.reflect_dot(p3, torch.zeros(2, 4, 1), torch.zeros(2, 1, 16))

    def test_cpu_runs_count_no_launches(self):
        tk.reset_launch_counts()
        psi, w, diag = self._window_args()
        tk.window_apply(psi, 4, 0, 2, w, diag)
        tk.pair_apply(psi, 4, 0, 2, 2, w, w, diag)
        assert tk.launch_counts() == {"window_apply": 0,
                                      "window_apply_trailing": 0,
                                      "reflect_dot": 0, "reflect_update": 0,
                                      "pair_apply": 0,
                                      "pair_apply_trailing": 0}


def test_failed_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    """No nvcc, or a compiler error, surfaces as an exception."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: broken kernel' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(tk, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(tk, "_BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken kernel"):
        tk.build_kernels()
    assert not list((tmp_path / "build").rglob("*.so"))
