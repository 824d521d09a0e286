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
from qbot_tpu_torch.tpu import compiler as tc
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
              "small_b": (10, 0, 7),
              # the streaming window as plans place it first (A = 1)
              "first_d2": (10, 0, 1), "first_d4": (10, 0, 2)}
SEEDS = {"middle": 1, "trailing": 2, "small_b": 3, "first_d2": 4,
         "first_d4": 5}


def _diagonals(n, start, width, rng):
    """Flips and phases whose want bits include 0, on a-, j- and b-bits."""
    a_bits = list(range(start))
    j_bits = list(range(start, start + width))
    b_bits = list(range(start + width, n))
    qa = a_bits[-1:]
    qj = sorted({j_bits[0], j_bits[-1]})    # one j-bit at width 1
    qb = b_bits[:1]
    phases = [(tuple(qa + qj + qb), complex(np.exp(0.9j)), 0),
              (tuple(qj), complex(np.exp(-0.4j)), 0b10 % 2 ** len(qj)),
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
                   "two_windows_small_b": (12, 2, 3, 3),
                   # the narrow pairs: D1 = 2, 4 with D2 = 8, 32 ("middle"
                   # is the middle (4, 8))
                   "trailing_narrow_2x8": (8, 4, 1, 3),
                   "trailing_narrow_2x32": (9, 3, 1, 5),
                   "trailing_narrow_4x8": (8, 3, 2, 3),
                   "trailing_narrow_4x32": (9, 2, 2, 5),
                   "middle_narrow_2x8": (11, 0, 1, 3),
                   "middle_narrow_2x32": (13, 0, 1, 5),
                   "middle_narrow_4x32": (14, 0, 2, 5),
                   # the streaming pairs: D1, D2 = 2, 4, as window=1 and
                   # window=2 plans place them (middle), and trailing
                   "middle_stream_2x2": (10, 1, 1, 1),
                   "middle_stream_2x4": (11, 1, 1, 2),
                   "middle_stream_4x2": (11, 0, 2, 1),
                   "middle_stream_4x4": (12, 1, 2, 2),
                   "trailing_stream_4x4": (7, 3, 2, 2)}


def _pair_diagonals(n, start, width1, width2, rng):
    """Flips, and phases on a-, j-, m- and b-bits whose want bits include
    0 (the j-bits once each: a one-qubit first window has one)."""
    qa = list(range(start))[-1:]
    qj = sorted({start, start + width1 - 1})
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
    ("two_windows_small_b", "two_windows"),
    ("trailing_narrow_4x32", "trailing"), ("middle_narrow_2x32", "middle"),
    ("middle_stream_4x4", "middle"), ("trailing_stream_4x4", "trailing")])
def test_pair_route_matches_pallas_dispatch(geometry, route):
    assert tk.pair_route(*PAIR_GEOMETRIES[geometry]) == route


@pytest.mark.parametrize("geometry,family", [
    ((12, 3, 2), "window_stream"), ((12, 5, 7), "window_tc"),
    ((12, 0, 7), "window_tc"), ((10, 2, 4, 4), "pair_tc_trailing"),
    ((20, 0, 5, 7), "pair_tc_middle"), ((12, 0, 2, 3), "pair_narrow"),
    ((9, 2, 2, 5), "pair_narrow"), ((12, 1, 2, 2), "pair_stream"),
    ((7, 3, 2, 2), "pair_stream"), ((12, 2, 3, 3), "two_windows"),
    ((14, 0, 6, 1), "two_windows"),
    # D1 >= 8 with D2 <= 4, middle (B = 128) and trailing (B = 1): the
    # reference's dispatch runs its pair kernels here, the port two windows
    ((14, 0, 5, 2), "two_windows"), ((9, 2, 5, 2), "two_windows")])
def test_launch_family_names_each_kernel(geometry, family):
    """One window width or two pair widths name the kernel's cost family
    (compiler.COSTS), or two windows, as pair_route routes the pair."""
    assert tk.launch_family(*geometry) == family
    if family == "two_windows":
        assert tk.pair_route(*geometry) == "two_windows"
    else:
        assert family in tc.COSTS


@pytest.mark.parametrize("geometry", [(13, 0, 6, 7), (26, 13, 6, 7),
                                      (14, 0, 7, 7), (26, 12, 7, 7)],
                         ids=lambda g: "n{}_s{}_{}x{}".format(*g))
def test_wg_pairs_keep_route_family_and_counts(geometry):
    """The trailing pairs at D2 = 128 with D1 = 64, 128, which the f32 modes
    run on the warpgroup kernel, keep their route and cost family (so every
    plan and launch count is as before); its counter, pair_tc_wg, sits
    outside LAUNCH_COUNTS, as window_tc_d128 does, and a CPU run moves
    neither."""
    from qbot_tpu_torch.utils import profiling

    assert tk.pair_route(*geometry) == "trailing"
    assert tk.launch_family(*geometry) == "pair_tc_trailing"
    assert tk.PAIR_WG_COUNTER == "pair_tc_wg"
    assert {tk.PAIR_WG_COUNTER, tk.WG_COUNTER}.isdisjoint(tk.LAUNCH_COUNTS)
    n, start, width1, width2 = geometry
    if n > 14:
        return
    rng = np.random.default_rng(n + width1)
    psi = torch.from_numpy(_rand_state(n, rng))
    w1, w2 = (torch.from_numpy(np.stack([U.real, U.imag]).astype(np.float32))
              for U in (_rand_unitary(2**width1, rng),
                        _rand_unitary(128, rng)))
    tk.reset_launch_counts()
    before = profiling.counters().get(tk.PAIR_WG_COUNTER, 0)
    tk.pair_apply(psi, n, start, width1, width2, w1, w2,
                  tk.fused_diagonals(n))
    assert profiling.counters().get(tk.PAIR_WG_COUNTER, 0) == before
    assert tk.launch_counts() == dict.fromkeys(tk.LAUNCH_COUNTS, 0)


@pytest.mark.parametrize("middle", [False, True])
def test_pair_variants_follow_the_router(middle):
    """Every tensor-core pair that launch_family names has its variant in
    the build table (D1 by orientation, in every precision), and no variant
    is built that it never names."""
    n = 20
    routed = set()
    for width1 in range(1, 8):
        for width2 in range(1, 8):
            start = 0 if middle else n - width1 - width2
            family = tk.launch_family(n, start, width1, width2)
            if family == f"pair_tc_{'middle' if middle else 'trailing'}":
                routed.add(2**width1)
    for prec in (0, 1, 2):
        built = {v["QBOT_D1"] for v in tk._VARIANTS["pair_tc.cu"]
                 if v["QBOT_MIDDLE"] == int(middle) and v["QBOT_PREC"] == prec}
        assert built == routed, prec


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
        counts = tk.launch_counts()
        assert counts == dict.fromkeys(tk.LAUNCH_COUNTS, 0)
        assert {"window_apply", "window_apply_trailing", "reflect_dot",
                "reflect_update", "pair_apply", "pair_apply_trailing",
                "window_apply[bf16_3x]", "pair_apply_trailing[bf16]"} \
            <= set(counts)


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


def test_edited_header_changes_the_build_directory(monkeypatch, tmp_path):
    """The build is named by every file nvcc reads, headers too: an edited
    ``csrc/*.cuh`` never loads a library built from the old one."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "kernel.cu").write_text('#include "tile.cuh"\n')
    header = src / "tile.cuh"
    header.write_text("// first\n")
    monkeypatch.setattr(tk, "_CSRC", src)
    monkeypatch.setattr(tk, "_BUILD", tmp_path / "build")
    first = tk._build_dir()
    assert tk._build_dir() == first
    header.write_text("// second\n")
    assert tk._build_dir() != first
