"""The port's dot engine (``qbot_tpu_torch.tpu.dotplan``) against
``qbot_tpu.tpu.dotplan`` on the CPU.

The classes mirror ``tests/test_dotplan.py``: circuits are built in both
packages from one seed (``tests/_torch_parity.py``), compiled by each
package's compiler (the plans equal field for field), and the same
numpy-seeded state runs through both engines.  JAX on the CPU ignores dot
precision and torch on the CPU has no bf16 product with float32 output, so
the reference holds only f32; the reduced modes and ``f32_mix`` are held
to float64 at the modes' limits and bit for bit to a model of each
window's products written with ``kernels._mode_bmm``'s arithmetic.  The
library route of the card runs here with its products mocked.

Tolerances: f32 5e-6 absolute on amplitudes (the reference's ``F32TOL``),
the scanned runners 2e-5 (three bodies), the gradients 1e-4 (the
reference's), ρ 1e-5 (the reference's density tests); against float64,
relative L2 2e-6 a window in f32 (3e-7 measured), 2e-5 in bf16_3x and 1e-2
in bf16 (PERF.md §2), times the windows of the plan; the models and
``f32_mix``'s rule bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import assert_same, both, brickwork, grover_body
from qbot_tpu.tpu import compiler as jc
from qbot_tpu.tpu import dotplan as jd
from qbot_tpu.tpu import kernels as jk
from qbot_tpu.tpu import planar as jp
from qbot_tpu_torch.tpu import circuit as tcirc
from qbot_tpu_torch.tpu import dotplan as td
from qbot_tpu_torch.tpu import kernels as tk
from qbot_tpu_torch.tpu import planar as tp
from qbot_tpu_torch.tpu import simulator
from qbot_tpu_torch.tpu.compiler import (
    Plan,
    Term,
    WindowStep,
    compile_circuit,
)

torch.set_num_threads(1)

F32TOL = 5e-6
SCAN_TOL = 2e-5
GRAD_TOL = 1e-4
DENSITY_TOL = 1e-5
F64_LIMITS = {"f32": 2e-6, "bf16_3x": 2e-5, "bf16": 1e-2}


@pytest.fixture(autouse=True)
def modes():
    """The reference's kernels off (its own tests run its dot engine so),
    the port's dot mode f32; both restored, and the reference's traces
    dropped (its kernels read the mode when traced)."""
    jk.set_kernel_mode("off")
    try:
        yield
    finally:
        tk.set_dot_mode("f32")
        jk.set_kernel_mode("auto")
        jax.clear_caches()


def _rand_state(n, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    z /= np.linalg.norm(z)
    return np.stack([z.real, z.imag]).astype(np.float32)


def _rand_unitary(d, rng):
    q, r = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _plans(make, w, partition="kernel", pair=True):
    circ, jcirc = both(make)
    plan = compile_circuit(circ, w, pair, partition=partition)
    jplan = jc.compile_circuit(jcirc, w, pair, partition={
        "kernel": "pallas", "dot": "dot"}[partition])
    assert_same(plan, jplan)
    return plan, jplan


def _compare(make, w, seed=1, params=None, partition="kernel"):
    """The port's dot engine against the reference's on one plan (f32)."""
    plan, jplan = _plans(make, w, partition)
    psi0 = _rand_state(plan.n, seed)
    lowered = td.lower_dot_plan(plan)
    assert lowered is not None
    jparams = None if params is None else jnp.asarray(params)
    want = np.asarray(jd.apply_plan_dot(jnp.asarray(psi0),
                                        jd.lower_dot_plan(jplan), jparams))
    tparams = None if params is None else torch.from_numpy(params)
    got = td.apply_plan_dot(torch.from_numpy(psi0), lowered, tparams)
    np.testing.assert_allclose(got.numpy(), want, atol=F32TOL)
    return plan, got


# the reference's spanning-gate and standalone-diagonal circuits at 10
# qubits, where a 3-wide plan has more than one window to span
def _spanning(m):
    c = brickwork(m, 10, 2, seed=5)
    rng = np.random.default_rng(6)
    c.gate(_rand_unitary(4, rng), [0, 9])     # spans every partition
    for op in brickwork(m, 10, 1, seed=7).ops:
        c.ops.append(op)
    return c


def _diagonal(m):
    c = m.Circuit(10)
    for q in range(10):
        c.h(q)
    rng = np.random.default_rng(9)
    c.diagonal(np.exp(1j * rng.uniform(0, 2 * np.pi, 8)), [1, 5, 9])
    for q in range(10):
        c.h(q)
    return c


def _fused(m):
    """Windows after a CZ and a controlled e^{0.7i} across windows and a
    flip, fused into the next window."""
    rng = np.random.default_rng(3)
    c = m.Circuit(10)
    for q in range(10):
        c.h(q)
    c.cz(1, 8)
    c.diagonal(np.array([1, 1, 1, np.exp(0.7j)]), [2, 9])
    c.phase_flip(513)
    for q in range(10):
        c.gate(_rand_unitary(2, rng), [q])
    return c


class TestDifferential:
    @pytest.mark.parametrize("w", range(3, 9))
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_brickwork(self, w, seed):
        _compare(lambda m: brickwork(m, 8, 3, seed), w, seed)

    @pytest.mark.parametrize("w", range(3, 9))
    def test_random_circuit(self, w):
        _compare(lambda m: m.random_circuit(7, 3, seed=4), w)

    def test_parameterized(self):
        rng = np.random.default_rng(3)
        num = both(lambda m: m.parameterized_layers(6, 2))[0].num_params
        params = rng.uniform(0, 2 * np.pi, num).astype(np.float32)
        _compare(lambda m: m.parameterized_layers(6, 2), 4, params=params)

    def test_standalone_diagonal(self):
        plan, _ = _compare(_diagonal, 3)
        assert any(isinstance(s, td._Diag)
                   for s in td.lower_dot_plan(plan).steps)

    def test_grover_reflections(self):
        plan, _ = _compare(lambda m: m.grover_circuit(6, marked=11,
                                                      iterations=3), 3)
        assert any(isinstance(s, td._Reflect)
                   for s in td.lower_dot_plan(plan).steps)

    def test_spanning_gate_contract(self):
        plan, _ = _compare(_spanning, 3)
        assert any(isinstance(s, td._Contract)
                   for s in td.lower_dot_plan(plan).steps)

    def test_fused_flips_and_phases(self):
        """Windows with a fused flip, a real phase (CZ) and a complex one,
        against the reference and the port's kernel engine."""
        plan, got = _compare(_fused, 4)
        wins = [s for s in td.lower_dot_plan(plan).steps
                if isinstance(s, td._Win)]
        assert any(s.flips for s in wins)
        zs = [z for s in wins for _, z, _ in s.phases]
        assert -1.0 in zs and any(z.imag for z in zs)
        psi0 = torch.from_numpy(_rand_state(10, 1))
        np.testing.assert_allclose(got.numpy(), tp.apply_plan_planar(
            psi0, plan).numpy(), atol=F32TOL)


class TestDotPartition:
    @pytest.mark.parametrize("pair", [True, False])
    @pytest.mark.parametrize("w", range(4, 9))
    @pytest.mark.parametrize("n", [6, 14, 17, 20])
    def test_plans_equal_the_reference(self, n, w, pair):
        """Host only: the dot partition's plans, field for field."""
        plan, _ = _plans(lambda m: brickwork(m, n, 3, seed=n), w, "dot",
                         pair)
        if n >= 14:
            bounds = sorted({(s.step.start, s.step.width)
                             for s in td.lower_dot_plan(plan).steps
                             if isinstance(s, td._Win)})
            assert bounds[-2:] == [(n - 13, 6), (n - 7, 7)]
            assert all(width <= w for _, width in bounds[:-2])

    @pytest.mark.parametrize("w", [3, 4])
    def test_dot_partition_at_14q(self, w):
        """At 14 qubits, the one size where the dot partition differs from
        the kernel partition that runs here: against the reference's dot
        engine and the port's kernel engine on its own partition."""
        make = lambda m: brickwork(m, 14, 3, seed=13)  # noqa: E731
        plan, got = _compare(make, w, seed=14, partition="dot")
        kernel_plan = compile_circuit(make(tcirc), w)
        psi0 = torch.from_numpy(_rand_state(14, 14))
        np.testing.assert_allclose(
            got.numpy(), tp.apply_plan_planar(psi0, kernel_plan).numpy(),
            atol=F32TOL)


class TestCycle:
    def test_scanned_body_matches_sequential(self):
        plan, jplan = _plans(lambda m: brickwork(m, 7, 2, seed=8), 4)
        psi0 = _rand_state(7, 4)
        run = td.make_scanned_dot_runner(plan, 3)
        got = run(torch.from_numpy(psi0)).numpy()
        ref = jnp.asarray(psi0)
        for _ in range(3):
            ref = jp.apply_plan_planar(ref, jplan)
        np.testing.assert_allclose(got, np.asarray(ref), atol=SCAN_TOL)
        seq = torch.from_numpy(psi0)
        for _ in range(3):
            seq = td.apply_plan_dot(seq, td.lower_dot_plan(plan))
        assert torch.equal(run(torch.from_numpy(psi0)), seq)

    def test_init_plan_and_engine_dispatch(self):
        """``make_scanned_planar_runner`` of a dot-engine body runs the dot
        runner; a Grover init and body (a reflection) against the
        reference's scanned runner."""
        plan, jplan = _plans(lambda m: grover_body(m, 7, 45), 3)
        init, jinit = _plans(lambda m: brickwork(m, 7, 1, seed=2), 4)
        plan.engine, jplan.engine = "dot", "dot"
        psi0 = _rand_state(7, 5)
        want = jp.make_scanned_planar_runner(jplan, 3, init_plan=jinit)(
            jnp.asarray(psi0))
        got = tp.make_scanned_planar_runner(plan, 3, init_plan=init)(
            torch.from_numpy(psi0))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SCAN_TOL)


class TestRenormCadence:
    """The reference's free-cadence renormalisation: a body that inflates
    the norm 1.5x, scanned 8 times, at 14 qubits."""

    def _runner(self, renorm_every, m=None):
        n = 14
        H = np.array([[1, 1], [1, -1]], complex) / np.sqrt(2)

        def make(mod):
            c = mod.Circuit(n)
            c.gate(1.5 * H, [0])
            c.gate(H, [5])
            return c
        plan, jplan = _plans(make, 4)
        plan.engine, jplan.engine = "dot", "dot"
        return (tp.make_scanned_planar_runner(plan, 8,
                                              renorm_every=renorm_every),
                jp.make_scanned_planar_runner(jplan, 8,
                                              renorm_every=renorm_every), n)

    @pytest.mark.parametrize("every", [1, 2])
    def test_unit_norm_and_direction(self, every):
        """Every 1 or 2 bodies (8 bodies: the exit lands the last pending
        correction): unit norm, the unrenormalised direction, the
        reference's state."""
        base, _, n = self._runner(0)
        ren, jren, _ = self._runner(every)
        psi0 = tp.zero_state_planar(n, "cpu")
        a = base(psi0).numpy()
        b = ren(psi0).numpy()
        assert abs(float((b.astype(np.float64) ** 2).sum()) - 1.0) < 1e-5
        np.testing.assert_allclose(b, a / np.sqrt((a ** 2).sum()), atol=1e-5)
        np.testing.assert_allclose(
            b, np.asarray(jren(jp.zero_state_planar(n))), atol=1e-5)

    def test_batch_with_renorm_raises(self):
        ren, _, n = self._runner(2)
        with pytest.raises(ValueError, match="one"):
            ren(torch.zeros(3, 2, 2**n))


class TestGradients:
    def test_grad_matches_reference_and_kernel_engine(self):
        plan, jplan = _plans(lambda m: m.parameterized_layers(5, 2), 3)
        psi0, target = _rand_state(5, 5), _rand_state(5, 6)
        theta = np.linspace(0.1, 1.0, plan.num_params).astype(np.float32)
        jlow = jd.lower_dot_plan(jplan)

        def jloss(t):
            out = jd.apply_plan_dot(jnp.asarray(psi0), jlow, t)
            return jnp.sum((out - jnp.asarray(target)) ** 2)
        want = np.asarray(jax.grad(jloss)(jnp.asarray(theta)))

        def grad(run):
            t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
            out = run(torch.from_numpy(psi0), t)
            torch.sum((out - torch.from_numpy(target)) ** 2).backward()
            return t.grad.numpy()
        lowered = td.lower_dot_plan(plan)
        got = grad(lambda p, t: td.apply_plan_dot(p, lowered, t))
        np.testing.assert_allclose(got, want, atol=GRAD_TOL)
        np.testing.assert_allclose(got, grad(
            lambda p, t: tp.apply_plan_planar(p, plan, t)), atol=GRAD_TOL)

    def test_grad_in_the_state(self):
        plan, _ = _plans(lambda m: brickwork(m, 6, 2, seed=3), 4)
        lowered = td.lower_dot_plan(plan)
        target = torch.from_numpy(_rand_state(6, 7))

        def grad(run):
            p = torch.from_numpy(_rand_state(6, 8)).requires_grad_()
            torch.sum(run(p) * target).backward()
            return p.grad.numpy()
        np.testing.assert_allclose(
            grad(lambda p: td.apply_plan_dot(p, lowered)),
            grad(lambda p: tp.apply_plan_planar(p, plan)), atol=GRAD_TOL)


def _mixed_state(n, seed=11):
    rng = np.random.default_rng(seed)
    k1 = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    k2 = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    k1, k2 = k1 / np.linalg.norm(k1), k2 / np.linalg.norm(k2)
    rho = 0.6 * np.outer(k1, k1.conj()) + 0.4 * np.outer(k2, k2.conj())
    return np.stack([rho.real, rho.imag]).astype(np.float32)


def _density_circuit(m):
    c = m.Circuit(5)
    for q in range(5):
        c.h(q)
    c.phase_flip(13)
    rng = np.random.default_rng(9)
    c.diagonal(np.exp(1j * rng.uniform(0, 2 * np.pi, 4)), [0, 4])
    for q in range(5):
        c.h(q)
    return c


class TestDensityDotEngine:
    @pytest.mark.parametrize("name,make,w", [
        ("brickwork", lambda m: brickwork(m, 6, 2, seed=5), 4),
        ("flip_and_diag", _density_circuit, 3),
        ("grover", lambda m: m.grover_circuit(5, marked=6, iterations=2), 3),
        ("parameterized", lambda m: m.parameterized_layers(4, 2), 3)])
    def test_density_plan_2n(self, name, make, w):
        """The 2n-qubit plan field for field, and ρ on the dot engine
        against the reference's and the port's kernel engine's."""
        plan, jplan = _plans(make, w)
        assert_same(td.density_plan_2n(plan), jd.density_plan_2n(jplan))
        rho = _mixed_state(plan.n)
        params = (None if not plan.num_params else
                  np.linspace(0.2, 1.1, plan.num_params).astype(np.float32))
        jplan.engine = "dot"
        want = np.asarray(jp.apply_plan_density_planar(
            jnp.asarray(rho), jplan,
            None if params is None else jnp.asarray(params)))
        tparams = None if params is None else torch.from_numpy(params)
        kernel = tp.apply_plan_density_planar(torch.from_numpy(rho), plan,
                                              tparams)
        plan.engine = "dot"
        got = tp.apply_plan_density_planar(torch.from_numpy(rho), plan,
                                           tparams)
        np.testing.assert_allclose(got.numpy(), want, atol=DENSITY_TOL)
        np.testing.assert_allclose(got.numpy(), kernel.numpy(),
                                   atol=DENSITY_TOL)
        runner = tp.make_planar_density_runner(plan)
        assert torch.equal(runner(torch.from_numpy(rho), tparams), got)


# ---------------------------------------------------------------------------
# the dot modes: float64, a model of the products, f32_mix's rule
# ---------------------------------------------------------------------------

def _one_window(n, start, width, seed=0, flips=(), phases=()):
    rng = np.random.default_rng(seed)
    u = _rand_unitary(2**width, rng)
    step = WindowStep(start, width, (Term(tuple(range(width)), u),),
                      tuple(flips), tuple(phases))
    return Plan(n, width, [step], engine="dot"), u


# (n, start, width): A = 1, a middle window, B = 1, the f32_mix threshold
GEOMETRIES = [(9, 0, 4), (9, 2, 5), (9, 2, 7), (9, 0, 8), (10, 3, 6),
              (10, 1, 7)]


def _model(psi, n, start, width, u, flips, phases, mode):
    """The products of one window as ``kernels._mode_bmm`` computes them,
    after the flips (each negates its amplitude) and the phases (the factor
    1 + (re − 1)·mask in float32, a real phase once, a complex one
    rotated), written here apart from the engine."""
    x = psi.clone()
    for m in flips:
        x[:, m] = -x[:, m]
    idx = torch.arange(2**n)
    for qubits, z, pattern in phases:
        k = len(qubits)
        hit = torch.ones(2**n, dtype=torch.bool)
        for j, q in enumerate(qubits):
            want = (pattern >> (k - 1 - j)) & 1 if pattern >= 0 else 1
            hit &= ((idx >> (n - 1 - q)) & 1) == want
        mask = hit.float()
        re = float(np.float32(np.float32(z.real) - np.float32(1.0)))
        fr = 1.0 + re * mask
        if abs(z.imag) < 1e-9:
            x = x * fr
        else:
            fi = float(np.float32(z.imag)) * mask
            x = torch.stack([x[0] * fr - x[1] * fi, x[0] * fi + x[1] * fr])
    w = torch.from_numpy(np.stack([u.real, u.imag]).astype(np.float32))
    m = torch.cat([torch.cat([w[0], -w[1]], 1), torch.cat([w[1], w[0]], 1)])
    A, D, B = 2**start, 2**width, 2**(n - start - width)
    if B == 1 and A > 1:
        xs = x.reshape(2, A, D).transpose(1, 2).reshape(1, 2 * D, A)
        y = tk._mode_bmm(m, xs, mode)
        return y.reshape(2, D, A).transpose(1, 2).reshape(2, -1)
    xs = x.reshape(2, A, D, B).transpose(0, 1).reshape(A, 2 * D, B)
    y = tk._mode_bmm(m, xs, mode)
    return y.reshape(A, 2, D, B).transpose(0, 1).reshape(2, -1)


def _f64(psi, u, n, start, width):
    """The exact window of ``u`` on ``psi`` in complex128."""
    z = (psi[0].double() + 1j * psi[1].double()).numpy()
    A, D = 2**start, 2**width
    out = np.einsum("ij,ajb->aib", u, z.reshape(A, D, -1)).reshape(-1)
    return np.stack([out.real, out.imag])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mode", ["f32", "bf16_3x", "bf16"])
@pytest.mark.parametrize("n,start,width", GEOMETRIES)
def test_window_against_float64(n, start, width, mode):
    plan, u = _one_window(n, start, width, seed=width)
    psi = torch.from_numpy(_rand_state(n, 3))
    tk.set_dot_mode(mode)
    got = td.apply_plan_dot(psi, td.lower_dot_plan(plan))
    assert _rel(got, _f64(psi, u, n, start, width)) <= F64_LIMITS[mode]


@pytest.mark.parametrize("mode", ["f32", "bf16_3x", "bf16"])
@pytest.mark.parametrize("n,start,width", GEOMETRIES)
def test_window_is_the_model_bit_for_bit(n, start, width, mode):
    """With three flips (one listed twice), a real phase with a pattern,
    a CZ with a 1e-16 residue (made real) and a complex phase."""
    flips = (5, 2**n - 3, 5, 17)
    phases = (((start, n - 1), -1.0 + 0j, 0b10),
              ((0, start + width - 1), complex(-1.0, 1e-16), -1),
              ((n - 2,), complex(np.exp(0.7j)), 1))
    plan, u = _one_window(n, start, width, 1, flips, phases)
    psi = torch.from_numpy(_rand_state(n, 4))
    tk.set_dot_mode(mode)
    got = td.apply_plan_dot(psi, td.lower_dot_plan(plan))
    real = [(q, complex(z.real, 0.0) if abs(z.imag) < 1e-9 else z, p)
            for q, z, p in phases]
    want = _model(psi, n, start, width, u, (2**n - 3, 17), real, mode)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,start,width", GEOMETRIES)
def test_f32_mix_runs_its_per_window_rule(n, start, width):
    """f32_mix: a window of 7 or more qubits is bf16_3x's bit for bit, a
    narrower one f32's; the rule is fixed when the plan is lowered."""
    plan, _ = _one_window(n, start, width, seed=2)
    psi = torch.from_numpy(_rand_state(n, 5))
    out = {}
    for mode in ("f32_mix", "f32", "bf16_3x"):
        tk.set_dot_mode(mode)
        lowered = td.lower_dot_plan(plan)
        out[mode] = td.apply_plan_dot(psi, lowered)
    want = "bf16_3x" if width >= 7 else "f32"
    assert td.window_mode("f32_mix", width) == want
    assert torch.equal(out["f32_mix"], out[want])
    assert not torch.equal(out["f32"], out["bf16_3x"])
    tk.set_dot_mode("f32_mix")
    lowered = td.lower_dot_plan(plan)
    tk.set_dot_mode("bf16")
    assert torch.equal(td.apply_plan_dot(psi, lowered), out[want]) == \
        (width >= 7)


@pytest.mark.parametrize("mode", ["bf16_3x", "bf16", "f32_mix"])
def test_reduced_plan_against_float64(mode):
    """A 9-qubit brickwork on the dot engine (widths 4 and 7, so f32_mix
    mixes both rules) within its windows' float64 limits."""
    plan, _ = _plans(lambda m: brickwork(m, 9, 3, seed=6), 4)
    psi = torch.from_numpy(_rand_state(9, 6))
    tk.set_dot_mode(mode)
    lowered = td.lower_dot_plan(plan)
    wins = [s for s in lowered.steps if isinstance(s, td._Win)]
    got = td.apply_plan_dot(psi, lowered)
    z = simulator.apply_plan(torch.complex(psi[0].double(), psi[1].double()),
                             plan)
    limit = sum(F64_LIMITS[s.mode or td.dot_precision(mode)] for s in wins)
    assert _rel(got, torch.stack([z.real, z.imag])) <= limit
    if mode == "f32_mix":
        assert {s.mode for s in wins} == {None, "bf16_3x"}


# ---------------------------------------------------------------------------
# the card's library route, its products mocked
# ---------------------------------------------------------------------------

@pytest.fixture
def on_card(monkeypatch):
    """The library route on CPU tensors: each bf16 product with float32
    output that the route makes is recorded and computed as the card
    would, bf16 products exact in float32 (any other call passes
    through)."""
    calls = []
    monkeypatch.setattr(td, "_on_card", lambda device: True)

    def fake(real):
        def product(a, b, *args, out_dtype=None, **kw):
            if out_dtype is None:
                return real(a, b, *args, **kw)
            calls.append((real.__name__, a.dtype, b.dtype, out_dtype))
            return real(a.float(), b.float(), *args, **kw)
        return product
    monkeypatch.setattr(torch, "mm", fake(torch.mm))
    monkeypatch.setattr(torch, "bmm", fake(torch.bmm))
    td.reset_product_counts()
    return calls


@pytest.mark.parametrize("mode", ["f32", "bf16_3x", "bf16"])
@pytest.mark.parametrize("n,start,width", GEOMETRIES)
def test_library_route(n, start, width, mode, on_card):
    """On a CUDA tensor a reduced product is one bf16 product with float32
    output (mm at A = 1 or B = 1, bmm else), within the plain products'
    rounding; f32 runs float32 products; each is counted by its mode."""
    plan, _ = _one_window(n, start, width, seed=width,
                          phases=(((0, n - 1), -1.0 + 0j, -1),))
    psi = torch.from_numpy(_rand_state(n, 3))
    tk.set_dot_mode(mode)
    lowered = td.lower_dot_plan(plan)
    plain = td.apply_plan_dot_ref(psi, lowered)
    got = td.apply_plan_dot(psi, lowered)
    A, B = 2**start, 2**(n - start - width)
    if mode == "f32":
        assert on_card == []
    else:
        name = "mm" if A == 1 or B == 1 else "bmm"
        assert on_card == [(name, torch.bfloat16, torch.bfloat16,
                            torch.float32)]
    assert td.product_counts() == {f"dot_window[{mode}]": 1}
    assert _rel(got, plain) <= 1e-6


def test_library_route_raises_without_a_bf16_product():
    """Without a bf16 product with float32 output (torch on the CPU has
    none) a reduced product raises: no float32 emulation on the card."""
    plan, _ = _one_window(9, 2, 5)
    psi = torch.from_numpy(_rand_state(9, 3))
    tk.set_dot_mode("bf16_3x")
    lowered = td.lower_dot_plan(plan)
    fns = td._step_fns(lowered, psi.device, td._LIBRARY)
    with pytest.raises((NotImplementedError, RuntimeError)):
        td._run(psi, fns)


def test_scanned_runner_on_the_library_route(on_card):
    """The prepared runner splits a static W once per mode, whatever the
    number of bodies, and matches the plain route within the mode's float64
    limit a product (a one-ulp difference of an intermediate re-splits to a
    bf16_3x rounding apart in the next product)."""
    plan, _ = _plans(lambda m: brickwork(m, 9, 2, seed=1), 5)
    psi = torch.from_numpy(_rand_state(9, 2))
    tk.set_dot_mode("bf16_3x")
    got = td.make_scanned_dot_runner(plan, 3)(psi)
    want = psi
    for _ in range(3):
        want = td.apply_plan_dot_ref(want, td.lower_dot_plan(plan))
    wins = sum(isinstance(s, td._Win)
               for s in td.lower_dot_plan(plan).steps)
    assert td.product_counts() == {"dot_window[bf16_3x]": 3 * wins}
    assert len(on_card) == 3 * wins
    assert _rel(got, want) <= 3 * wins * F64_LIMITS["bf16_3x"]
