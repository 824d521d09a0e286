"""The reduced-precision path of the port (``--precision``, the dot modes of
``qbot_tpu/tpu/kernels.py:41-71``, and ``renorm_every``) against the JAX
package, on the CPU.

- ``f32``, ``f32_mix`` and ``bf16_3x``: the port's window and pair plain
  versions against ``qbot_tpu``'s Pallas kernels in interpret mode, set to
  the same mode, within relative L2 1e-6 (float32 sums of exact products,
  taken in another order).  The JAX kernels are ``jax.jit`` functions whose
  mode is read when they are traced, so the fixture clears JAX's caches
  whenever it sets a mode.
- ``bf16``: on the CPU the reference computes its single bf16 pass in full
  float32 (XLA:CPU's DEFAULT-precision dot), so the port is held to a numpy
  model of the TPU's pass (operands rounded to bf16 to nearest even,
  float64 products and sums, a pair's float32 Y rounded again) within 1e-6,
  and to the JAX result only within 1e-2.
- ``renorm_every`` in {1, 2}: the port's scanned runner against
  ``qbot_tpu``'s, within relative L2 1e-6.
- The CLI: ``--precision``, ``--ensemble``, ``--profile``, ``--dtype``,
  ``--seed``, ``--smc`` and ``--compile --ensemble`` as ``qbot_tpu``'s CLI
  takes them, ``--shard`` without ``--compile`` ignored as there; the
  flags whose slice has not landed exit 1 naming their ROADMAP item.

The geometries are those on which the reference reaches its Pallas kernels
(B >= 128 or a trailing window with at least 8 rows; trailing pairs, and
middle pairs with B >= 128 and D1 <= 32).  A middle pair with D1, D2 >= 8
and B >= 128 needs 13 qubits; every other case has at most 12.

    python -m pytest tests/test_torch_precision.py -q
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import both, brickwork, grover_body
from test_torch_window_split import _bf16
from qbot_tpu.tpu import compiler as jc
from qbot_tpu.tpu import kernels as jk
from qbot_tpu.tpu import planar as jp
from qbot_tpu_torch.cli import main as torch_cli
from qbot_tpu_torch.tpu import kernels as tk
from qbot_tpu_torch.tpu import planar as tp
from qbot_tpu_torch.tpu.compiler import compile_circuit

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6
BF16_VS_JAX = 1e-2

# (n, start, width): middle windows (B >= 128, _left_multiply) and trailing
# windows (B = 1, _right_multiply), at D >= 8 and at D <= 4
WINDOWS = {"middle_d32": (12, 0, 5), "middle_d4": (11, 1, 2),
           "trailing_d128": (10, 3, 7), "trailing_d4": (10, 8, 2),
           "first_d2": (11, 0, 1)}
# (n, start, width1, width2): trailing pairs (_pair_b1) and middle pairs
# (_pair_bt), at D1, D2 >= 8 and with D1 or D2 <= 4; the narrow pairs (D1 =
# 2, 4 with D2 = 8, 32) in both orientations; the streaming pairs (D1, D2
# = 2, 4) of window=1 and window=2 plans, and one trailing
PAIRS = {"trailing_d16": (10, 2, 4, 4), "trailing_d4": (9, 3, 2, 4),
         "middle_d8": (13, 0, 3, 3), "middle_d4": (12, 0, 2, 3),
         "trailing_d2_8": (8, 4, 1, 3), "trailing_d2_32": (9, 3, 1, 5),
         "trailing_d4_8": (8, 3, 2, 3), "trailing_d4_32": (9, 2, 2, 5),
         "middle_d2_8": (11, 0, 1, 3), "middle_d2_32": (13, 0, 1, 5),
         "middle_d4_32": (14, 0, 2, 5),
         "middle_s2x2": (10, 1, 1, 1), "middle_s2x4": (11, 0, 1, 2),
         "middle_s4x4": (12, 1, 2, 2), "trailing_s4x2": (7, 4, 2, 1)}


@pytest.fixture
def dot_mode(request):
    """Both packages in the dot mode ``request.param``, the JAX kernels in
    interpret mode with their caches cleared; f32 again afterwards."""
    jk.set_kernel_mode("interpret")
    jk.set_dot_mode(request.param)
    tk.set_dot_mode(request.param)
    jax.clear_caches()
    try:
        yield request.param
    finally:
        jk.set_dot_mode("f32")
        tk.set_dot_mode("f32")
        jk.set_kernel_mode("auto")
        jax.clear_caches()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _state(n, rng):
    psi = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    psi /= np.linalg.norm(psi)
    return np.stack([psi.real, psi.imag]).astype(np.float32)


def _planar_unitary(d, rng):
    q, r = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    u = q * (np.diag(r) / np.abs(np.diag(r)))
    return np.stack([u.real, u.imag]).astype(np.float32)


def _diagonals(n, qubits, rng):
    """Three flips and two phases on ``qubits`` (wants that include 0)."""
    flips = tuple(int(m) for m in rng.integers(0, 2**n, size=3))
    phases = ((tuple(qubits), complex(np.exp(0.9j)), 0b0101 % 2**len(qubits)),
              ((qubits[-1],), complex(np.exp(-0.4j)), -1))
    return flips, phases


def _window_case(name, seed):
    n, start, width = WINDOWS[name]
    rng = np.random.default_rng(seed)
    psi, w = _state(n, rng), _planar_unitary(2**width, rng)
    qubits = sorted({max(start - 1, 0), start, start + width - 1, n - 1})
    return (n, start, width), psi, w, _diagonals(n, qubits, rng)


def _pair_case(name, seed):
    n, start, width1, width2 = PAIRS[name]
    rng = np.random.default_rng(seed)
    psi = _state(n, rng)
    w1, w2 = _planar_unitary(2**width1, rng), _planar_unitary(2**width2, rng)
    end = start + width1 + width2
    qubits = sorted({max(start - 1, 0), start, start + width1, end - 1,
                     n - 1})
    return (n, start, width1, width2), psi, w1, w2, _diagonals(n, qubits,
                                                               rng)


def _jax_window(geom, psi, w, diag):
    n, start, width = geom
    return np.asarray(jk.planar_window_apply(
        jnp.asarray(psi), n, start, width, jnp.asarray(w[0]),
        jnp.asarray(w[1]), *diag))


def _torch_window(geom, psi, w, diag):
    n, start, width = geom
    return tk.window_apply(torch.from_numpy(psi), n, start, width,
                           torch.from_numpy(w),
                           tk.fused_diagonals(n, *diag)).numpy()


def _jax_pair(geom, psi, w1, w2, diag):
    n, start, width1, width2 = geom
    return np.asarray(jk.planar_pair_window_apply(
        jnp.asarray(psi), n, start, width1, start + width1, width2,
        *(jnp.asarray(x) for x in (w1[0], w1[1], w2[0], w2[1])), *diag))


def _torch_pair(geom, psi, w1, w2, diag):
    n, start, width1, width2 = geom
    return tk.pair_apply(torch.from_numpy(psi), n, start, width1, width2,
                         torch.from_numpy(w1), torch.from_numpy(w2),
                         tk.fused_diagonals(n, *diag)).numpy()


# ---------------------------------------------------------------------------
# f32, f32_mix, bf16_3x: against the JAX kernels in the same mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dot_mode", ["f32", "f32_mix", "bf16_3x"],
                         indirect=True)
@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_matches_pallas_in_mode(name, dot_mode):
    geom, psi, w, diag = _window_case(name, 7 + len(name))
    got = _torch_window(geom, psi, w, diag)
    assert _rel(got, _jax_window(geom, psi, w, diag)) <= TOL


@pytest.mark.parametrize("dot_mode", ["f32", "f32_mix", "bf16_3x"],
                         indirect=True)
@pytest.mark.parametrize("name", list(PAIRS))
def test_pair_matches_pallas_in_mode(name, dot_mode):
    geom, psi, w1, w2, diag = _pair_case(name, 11 + len(name))
    got = _torch_pair(geom, psi, w1, w2, diag)
    assert _rel(got, _jax_pair(geom, psi, w1, w2, diag)) <= TOL


@pytest.mark.parametrize("dot_mode", ["bf16_3x"], indirect=True)
def test_bf16_3x_differs_from_f32_as_the_reference_does(dot_mode):
    """The mode reaches both packages: bf16_3x moves the JAX kernel and the
    port alike away from their f32 results (by a few 1e-6)."""
    geom, psi, w, diag = _window_case("middle_d32", 3)
    got, want = _torch_window(geom, psi, w, diag), _jax_window(geom, psi, w,
                                                               diag)
    tk.set_dot_mode("f32")
    jk.set_dot_mode("f32")
    jax.clear_caches()
    got32, want32 = _torch_window(geom, psi, w, diag), _jax_window(
        geom, psi, w, diag)
    assert 1e-7 < _rel(got, got32) < 2e-5
    assert 1e-7 < _rel(want, want32) < 2e-5
    assert _rel(got, want) <= TOL


# ---------------------------------------------------------------------------
# bf16: against a numpy model of the TPU's single bf16 pass
# ---------------------------------------------------------------------------

def _diagonals_f32(psi, n, diag):
    """The fused phases, then the flips, in float32 numpy operations, as
    the plain versions apply them."""
    flips, phases = diag
    x = psi.copy()
    idx = np.arange(2**n)
    for mask, want, z in ((*tk.phase_bits(n, q, pat), z)
                          for q, z, pat in phases):
        hit = (idx & mask) == want
        fr = np.where(hit, np.float32(z.real), np.float32(1.0))
        fi = np.where(hit, np.float32(z.imag), np.float32(0.0))
        x = np.stack([x[0] * fr - x[1] * fi, x[0] * fi + x[1] * fr])
    sign = np.ones(2**n, np.float32)
    for m in flips:
        sign[m] *= -1
    return (x * sign).astype(np.float32)


def _bf16_product(w, x):
    """Σ_j W[i, j] x[a, j, b], complex, from planar float32 (2, D, D) and
    (2, A, D, B): operands rounded to bf16, float64 products and sums."""
    wr, wi = (_bf16(p).astype(np.float64) for p in w)
    xr, xi = (_bf16(p).astype(np.float64) for p in x)

    def mm(a, b):
        return np.einsum("ij,ajb->aib", a, b)
    return np.stack([mm(wr, xr) - mm(wi, xi), mm(wr, xi) + mm(wi, xr)])


def bf16_window_model(geom, psi, w, diag):
    n, start, width = geom
    x = _diagonals_f32(psi, n, diag).reshape(2, 2**start, 2**width, -1)
    return _bf16_product(w, x).reshape(psi.shape)


def bf16_pair_model(geom, psi, w1, w2, diag):
    """W1 then W2 (their windows are adjacent), the float32 Y rounded to
    bf16 again for the second product, as the TPU's pair kernels and the
    CUDA pair kernels do."""
    n, start, width1, width2 = geom
    x = _diagonals_f32(psi, n, diag)
    for pre, width, w in ((start, width1, w1), (start + width1, width2, w2)):
        x = _bf16_product(w, x.reshape(2, 2**pre, 2**width, -1))
        x = x.astype(np.float32).reshape(psi.shape)
    return x


def _w2_first(geom, psi, w1, w2, diag):
    """The pair in the other order, W2 then W1, as two plain windows in the
    current dot mode (the diagonals fused into the first)."""
    n, start, width1, width2 = geom
    y = tk.window_apply_ref(torch.from_numpy(psi), n, start + width1, width2,
                            torch.from_numpy(w2),
                            tk.fused_diagonals(n, *diag))
    return tk.window_apply_ref(y, n, start, width1, torch.from_numpy(w1),
                               tk.fused_diagonals(n)).numpy()


@pytest.mark.parametrize("dot_mode", ["bf16"], indirect=True)
@pytest.mark.parametrize("name", list(WINDOWS))
def test_bf16_window_matches_model(name, dot_mode):
    geom, psi, w, diag = _window_case(name, 7 + len(name))
    got = _torch_window(geom, psi, w, diag)
    assert _rel(got, bf16_window_model(geom, psi, w, diag)) <= TOL
    assert _rel(got, _jax_window(geom, psi, w, diag)) <= BF16_VS_JAX


@pytest.mark.parametrize("dot_mode", ["bf16"], indirect=True)
@pytest.mark.parametrize("name", list(PAIRS))
def test_bf16_pair_matches_model(name, dot_mode):
    """The pair in the TPU's order (W1 first) against the model; the other
    order rounds another intermediate to bf16, about 2e-3 away, so the
    order is part of the bf16 mode's result."""
    geom, psi, w1, w2, diag = _pair_case(name, 11 + len(name))
    got = _torch_pair(geom, psi, w1, w2, diag)
    assert _rel(got, bf16_pair_model(geom, psi, w1, w2, diag)) <= TOL
    assert _rel(got, _jax_pair(geom, psi, w1, w2, diag)) <= BF16_VS_JAX
    assert 1e-4 < _rel(_w2_first(geom, psi, w1, w2, diag), got) \
        < BF16_VS_JAX


@pytest.mark.parametrize("dot_mode", ["f32", "bf16_3x"], indirect=True)
def test_pair_orders_agree_in_f32_and_bf16_3x(dot_mode):
    """The pair (W1 first) against the other order (W2 first): 1e-6 in
    f32, 1e-5 in bf16_3x (the card's limit for a pair against its plain
    version): only bf16 depends on the order."""
    geom, psi, w1, w2, diag = _pair_case("trailing_d16", 5)
    rel = _rel(_w2_first(geom, psi, w1, w2, diag),
               _torch_pair(geom, psi, w1, w2, diag))
    assert rel <= (TOL if dot_mode == "f32" else 1e-5)


def test_bf16_rounds_to_nearest_even():
    """The port's bf16 rounding is the numpy model's."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=4096) * np.exp(3 * rng.normal(size=4096))
         ).astype(np.float32)
    ties = np.array([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8)], np.float32)
    for v in (x, ties):
        np.testing.assert_array_equal(
            tk._bf16(torch.from_numpy(v)).numpy(), _bf16(v))
    np.testing.assert_array_equal(_bf16(ties), [1.0, 1 + 2**-6, -1.0])


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown dot mode"):
        tk.set_dot_mode("fp8")
    with pytest.raises(ValueError, match="unknown dot mode"):
        tk.window_apply_ref(torch.zeros(2, 4), 2, 0, 1, torch.zeros(2, 2, 2),
                            tk.fused_diagonals(2), mode="tf32")
    assert tk.dot_mode() == "f32"


# ---------------------------------------------------------------------------
# renorm_every
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_renorm_every_matches_jax(k):
    circ, jcirc = both(lambda m: brickwork(m, 9, 3, seed=k))
    rng = np.random.default_rng(k)
    psi = _state(9, rng) * np.float32(0.8)
    want = jp.make_scanned_planar_runner(jc.compile_circuit(jcirc), 5,
                                         renorm_every=k)(jnp.asarray(psi))
    got = tp.make_scanned_planar_runner(compile_circuit(circ), 5,
                                        renorm_every=k)(torch.from_numpy(psi))
    assert _rel(got.numpy(), want) <= TOL
    assert abs(float(tp.planar_norm(got)) - 1.0) <= 1e-6


def test_renorm_runs_a_reflection_body_through_its_steps():
    """With renorm_every a Grover body (one ReflectStep) leaves the fast
    path in both packages (qbot_tpu/tpu/planar.py:770-773): the same state
    as the reference's, a norm of 1, and Grover's closed form."""
    n, marked, repeats = 9, 300, 6

    def hadamards(m):
        c = m.Circuit(n)
        for q in range(n):
            c.h(q)
        return c

    init, jinit = both(hadamards)
    body, jbody = both(lambda m: grover_body(m, n, marked))
    want = jp.make_scanned_planar_runner(
        jc.compile_circuit(jbody), repeats,
        init_plan=jc.compile_circuit(jinit),
        renorm_every=1)(jp.zero_state_planar(n))
    got = tp.make_scanned_planar_runner(
        compile_circuit(body), repeats, init_plan=compile_circuit(init),
        renorm_every=1)(tp.zero_state_planar(n, "cpu"))
    assert _rel(got.numpy(), want) <= TOL
    p = float(tp.planar_probs(got)[marked])
    assert abs(p - np.sin((2 * repeats + 1)
                          * np.arcsin(2 ** (-n / 2))) ** 2) < 1e-5
    assert abs(float(tp.planar_norm(got)) - 1.0) <= 1e-6


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_NUM = r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?%?"


def _run(module, *args):
    # ``qbot_tpu`` keeps a persistent XLA cache in the repo; an executable
    # that another run left there is loaded with an XLA log line on stderr,
    # which is not the program's output. Each run here compiles afresh.
    env = {**os.environ, "QBOT_TPU_COMPILE_CACHE": "off"}
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=300)


def _same_numbers(got, want, tol):
    import re

    assert re.sub(_NUM, "#", got) == re.sub(_NUM, "#", want)
    for a, b in zip(re.findall(_NUM, got), re.findall(_NUM, want)):
        scale = 100 if a.endswith("%") else 1
        assert abs(float(a.rstrip("%")) - float(b.rstrip("%"))) <= tol * scale


@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
def test_cli_precision_matches_reference(mode):
    """``--compile --precision`` on the CPU against ``qbot_tpu``'s CPU run
    in the same mode (whose CPU kernels compute f32): readouts within 1e-4
    in bf16_3x, 1e-2 in bf16."""
    prog = "examples/grover.qb"
    got = _run("qbot_tpu_torch", prog, "--compile", "--precision", mode,
               "--device", "cpu")
    want = _run("qbot_tpu", prog, "--compile", "--precision", mode)
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    _same_numbers(got.stdout, want.stdout, 1e-4 if mode == "bf16_3x"
                  else 1e-2)
    assert tk.dot_mode() == "f32"


BRANCHING = ROOT / "examples" / "probabilistic_branching.qb"


@pytest.mark.parametrize("readout", [False, True],
                         ids=["example", "with_readout"])
def test_cli_ensemble_matches_reference(readout, tmp_path):
    """``--ensemble`` prints what ``qbot_tpu``'s prints: nothing for the
    example itself, the merged readout once it measures and prints."""
    prog = BRANCHING
    if readout:
        prog = tmp_path / "branching.qb"
        prog.write_text(BRANCHING.read_text() + "\nmeas out ; comp\n"
                        "cout out\n")
    got = _run("qbot_tpu_torch", str(prog), "--ensemble")
    want = _run("qbot_tpu", str(prog), "--ensemble")
    assert got.returncode == want.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    assert bool(got.stdout) == readout


def test_ensemble_namespace_matches_reference():
    """The merged namespace: the branch-weighted density matrix (the 0.75
    branch halts in |0〉, the 0.25 branch jumps to X) and the classical
    variables."""
    from qbot_tpu.frontend.ensemble import executeTxtEnsemble as jax_ensemble
    from qbot_tpu_torch import executeTxtEnsemble

    src = BRANCHING.read_text() + "\ncdef k ; 2\n"
    got, want = executeTxtEnsemble(src), jax_ensemble(src)
    np.testing.assert_allclose(got["state"], want["state"], atol=1e-12)
    np.testing.assert_allclose(np.real(np.diag(got["state"])), [0.75, 0.25],
                               atol=1e-12)
    assert sorted(k for k in got if not k.startswith("__")) == \
        sorted(k for k in want if not k.startswith("__"))


@pytest.mark.parametrize("flags", [["--profile"], ["--dtype", "c64"],
                                   ["--dtype", "c128"], ["--seed", "3"],
                                   ["--backend", "numpy"]])
def test_cli_host_flags_are_accepted(flags, capsys):
    assert torch_cli(["examples/deutsch.qb", *flags]) == 0
    out = capsys.readouterr()
    assert "|1〉- 1.0 (100.0%)" in out.out
    if flags == ["--profile"]:
        assert "hits" in out.err
    from qbot_tpu_torch.backend import dtype_override, set_dtype
    from qbot_tpu_torch.utils.config import runtime_config

    assert runtime_config().seed == (3 if flags == ["--seed", "3"] else 0)
    assert dtype_override() == {"c64": np.complex64, "c128": np.complex128
                                }.get(flags[-1])
    set_dtype(None)


def test_cli_dtype_c64_runs_the_registers_in_complex64():
    from qbot_tpu_torch import executeTxt
    from qbot_tpu_torch.backend import set_dtype

    set_dtype("c64")
    try:
        ns = executeTxt("qset comp[0]\ngate hadamardGate\n")
    finally:
        set_dtype(None)
    assert ns["state"].dtype == np.complex64


@pytest.mark.parametrize("flags,item", [
    (["--shard", "1"], None), (["--mesh", "2x2"], None),
    (["--backend", "jax"], "North star")])
def test_cli_flags_not_ported_exit_1_naming_their_item(flags, item, capsys):
    """``--backend jax`` exits 1 naming the ROADMAP's reason.  ``--shard``
    and ``--mesh`` run with ``--compile`` (tests/test_torch_sharded.py,
    tests/test_torch_sharded_ensemble_cli.py); without it they are
    ignored, as under ``qbot_tpu``: the dense interpreter's output, exit
    0."""
    if item is None:
        assert torch_cli(["examples/grover.qb", *flags]) == 0
        want = _run("qbot_tpu", "examples/grover.qb", *flags)
        assert want.returncode == 0, want.stderr
        _same_numbers(capsys.readouterr().out, want.stdout, 1e-6)
        return
    assert torch_cli(["examples/grover.qb", *flags]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and item in err[0] and "ROADMAP" in err[0]


@pytest.mark.parametrize("flags", [["--smc", "4"],
                                   ["--compile", "--ensemble"]])
def test_cli_device_ensemble_flags_do_what_the_reference_does(flags):
    """``--smc`` alone is ignored (the dense interpreter runs), ``--compile
    --ensemble`` runs the device ensemble: the exit code, the readout and
    the stderr line as ``qbot_tpu``'s."""
    got = _run("qbot_tpu_torch", "examples/grover.qb", *flags,
               "--device", "cpu")
    want = _run("qbot_tpu", "examples/grover.qb", *flags)
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    _same_numbers(got.stdout, want.stdout, 1e-6)
    assert got.stderr.strip() == want.stderr.strip()
