"""The port's ``--compile`` slice on the CPU vs ``qbot_tpu``'s: lowered
programs through :func:`qbot_tpu_torch.run_lowered` and through
:func:`qbot_tpu.frontend.lowering.run_lowered` on CPU-JAX, and the two CLIs.

Tolerance: 1e-6 on outcome probabilities (float32 states of a few qubits;
printed readouts are compared number by number, percentages at 1e-4).
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qbot_tpu.frontend import lowering as jl
from qbot_tpu.ops.measurement import MeasurementResult
from qbot_tpu_torch import compile_circuit, lower_program, run_lowered
from qbot_tpu_torch.cli import main as torch_cli
from qbot_tpu_torch.frontend.lowering import LoweringError
from qbot_tpu_torch.ops.measurement import \
    MeasurementResult as TorchMeasurementResult

torch.set_num_threads(1)

TOL = 1e-6
ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ["deutsch.qb", "grover.qb", "phase_kickback.qb", "superdense.qb",
            "teleportation.qb"]

PROGRAMS = {
    # tests/test_lowering.py: bell-basis and subset measurements
    "bell_basis": ("qset tensorProd(comp[0], comp[0])\n"
                   "gate hadamardGate ; 0\n"
                   "gate pauliXGate ; 1 ; 0\n"
                   "meas out ; bell"),
    "bell_non_contiguous": ("qset tensorProd(comp[0], comp[1], comp[0])\n"
                            "gate hadamardGate ; 0\n"
                            "gate pauliXGate ; 2 ; 0\n"
                            "meas out ; bell ; [0, 2]"),
    "subset": ("qset tensorProd(comp[1], hada[0], comp[0])\n"
               "meas out ; comp ; [0, 2]"),
    "bell_pairs": ("qset tensorExp(comp.kets[0], 9)\n"
                   "cdef i ; 0\nmark l\ngate hadamardGate ; i\n"
                   "gate pauliXGate ; i + 1 ; i\ncdef i ; i + 2\n"
                   "cjmp l ; i < 8\n"
                   "gate yRotGate(0.7) ; 8\n"
                   "meas out ; bell ; [2, 3, 0, 8]"),
}


def _results(ns, cls):
    return {k: v for k, v in ns.items()
            if not k.startswith("__") and isinstance(v, cls)}


def _assert_same_run(src):
    lp_t, lp_j = lower_program(src), jl.lower_program(src)
    probs_t, psi = run_lowered(lp_t, device="cpu")
    probs_j, _ = jl.run_lowered(lp_j)
    assert psi.device.type == "cpu" and psi.dtype == torch.float32
    np.testing.assert_allclose(probs_t, np.asarray(probs_j), atol=TOL)
    got = _results(lp_t.namespace, TorchMeasurementResult)
    want = _results(lp_j.namespace, MeasurementResult)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].probs, want[name].probs,
                                   atol=TOL)
    return lp_t, lp_j


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_match_jax(name):
    src = (ROOT / "examples" / name).read_text()
    lp_t, lp_j = _assert_same_run(src)
    for key, val in lp_j.namespace.items():
        if key.startswith("__") or callable(val) or key == "state":
            continue
        if isinstance(val, list) and all(isinstance(x, str) for x in val):
            assert lp_t.namespace[key] == val
        elif isinstance(val, list):
            np.testing.assert_allclose(np.asarray(lp_t.namespace[key],
                                                  float),
                                       np.asarray(val, float), atol=TOL)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_programs_match_jax(name):
    _assert_same_run(PROGRAMS[name])


def _brickwork_program(n, layers, seed):
    """A DSL brickwork: y and z rotations of seeded angles on every qubit,
    then CX on alternating neighbour pairs, per layer; every qubit
    measured."""
    rng = np.random.default_rng(seed)
    lines = [f"qset tensorExp(comp.kets[0], {n})"]
    for layer in range(layers):
        for q in range(n):
            a, b = rng.uniform(0, 2 * np.pi, size=2)
            lines += [f"gate yRotGate({a:.6f}) ; {q}",
                      f"gate zRotGate({b:.6f}) ; {q}"]
        for q in range(layer % 2, n - 1, 2):
            lines.append(f"gate pauliXGate ; {q + 1} ; {q}")
    lines.append("meas out ; comp")
    return "\n".join(lines)


@pytest.mark.parametrize("n,window,route,widths", [
    (9, 7, "trailing", (2, 7)), (12, 3, "middle", (2, 3)),
    (12, 4, "middle", (1, 4))])
def test_narrow_pair_slice_matches_jax(n, window, route, widths):
    """The slice through a plan that holds a narrow pair (D1 = 2, 4 with
    D2 >= 8: the trailing (4, 128) of 9 qubits at width 7, the middle
    (4, 8) and (2, 16) of 12 qubits at widths 3 and 4): the plans equal
    ``qbot_tpu``'s field by field, the probabilities within TOL."""
    from _torch_parity import assert_same
    from qbot_tpu.tpu.compiler import compile_circuit as jax_compile
    from qbot_tpu_torch.tpu.compiler import compile_circuit
    from qbot_tpu_torch.tpu.kernels import pair_route

    src = _brickwork_program(n, 6, seed=n + window)
    lp_t, lp_j = lower_program(src), jl.lower_program(src)
    plan = compile_circuit(lp_t.circuit, window=window)
    assert_same(plan, jax_compile(lp_j.circuit, window=window))
    narrow = {(s.first.start, s.first.width, s.second.width)
              for s in plan.steps if hasattr(s, "second")
              and s.first.width <= 2 and s.second.width >= 3}
    assert narrow and all(pair_route(n, *g) == route and g[1:] == widths
                          for g in narrow)
    probs_t, _ = run_lowered(lp_t, window=window, device="cpu")
    probs_j, _ = jl.run_lowered(lp_j, window=window)
    np.testing.assert_allclose(probs_t, np.asarray(probs_j), atol=TOL)
    np.testing.assert_allclose(lp_t.namespace["out"].probs,
                               lp_j.namespace["out"].probs, atol=TOL)


@pytest.mark.parametrize("n,window", [(9, 1), (10, 2), (11, 2), (12, 1)])
def test_stream_pair_slice_matches_jax(n, window):
    """The slice through plans compiled at window=1 and window=2, whose
    pairs of D1, D2 = 2, 4 run the streaming pair on the card and whose
    D = 2, 4 windows the streaming window: the plans equal ``qbot_tpu``'s
    field by field, the probabilities within TOL."""
    from _torch_parity import assert_same
    from qbot_tpu.tpu.compiler import compile_circuit as jax_compile
    from qbot_tpu_torch.tpu.compiler import compile_circuit
    from qbot_tpu_torch.tpu.kernels import pair_route

    src = _brickwork_program(n, 4, seed=n + window)
    lp_t, lp_j = lower_program(src), jl.lower_program(src)
    plan = compile_circuit(lp_t.circuit, window=window)
    assert_same(plan, jax_compile(lp_j.circuit, window=window))
    stream = {(s.first.start, s.first.width, s.second.width)
              for s in plan.steps if hasattr(s, "second")
              and s.first.width <= 2 and s.second.width <= 2}
    assert stream and all(pair_route(n, *g) == "middle" for g in stream)
    probs_t, _ = run_lowered(lp_t, window=window, device="cpu")
    probs_j, _ = jl.run_lowered(lp_j, window=window)
    np.testing.assert_allclose(probs_t, np.asarray(probs_j), atol=TOL)
    np.testing.assert_allclose(lp_t.namespace["out"].probs,
                               lp_j.namespace["out"].probs, atol=TOL)

def test_dense_fields_replay_on_the_host():
    lp, _ = _assert_same_run(PROGRAMS["bell_basis"])
    dense = lp.namespace["out"].newState
    assert dense.shape == (4, 4)


def test_outside_the_fragment_raises_like_jax():
    src = (ROOT / "examples" / "mid_measurement.qb").read_text()
    with pytest.raises(jl.LoweringError):
        jl.run_lowered(jl.lower_program(src))
    lp = lower_program(src)
    with pytest.raises(LoweringError):
        run_lowered(lp, device="cpu")
    np.testing.assert_allclose(lp.namespace["first"].probs, [0.5, 0.5],
                               atol=TOL)


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?%?")


def _run_cli(module, path, *extra):
    proc = subprocess.run(
        [sys.executable, "-m", module, str(path), "--compile", *extra],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc


def test_cli_matches_qbot_tpu_cli(tmp_path):
    prog = tmp_path / "prog.qb"
    prog.write_text(PROGRAMS["bell_non_contiguous"].replace(
        "meas out ; bell ; [0, 2]", "gate hadamardGate ; 1\n"
                                    "meas out ; comp ; [0, 1, 2]"))
    got = _run_cli("qbot_tpu_torch", prog, "--device", "cpu")
    want = _run_cli("qbot_tpu", prog)
    # the CLI compiles with window="auto", as qbot_tpu's does, and names
    # the engine it picked beside the device
    auto = compile_circuit(lower_program(prog.read_text()).circuit, "auto")
    assert f"({auto.engine} engine, torch cpu)" in got.stderr
    passes = re.search(r"(\d+) device passes", got.stderr)
    assert int(passes.group(1)) == auto.num_passes
    lines_t, lines_j = got.stdout.splitlines(), want.stdout.splitlines()
    assert len(lines_t) == len(lines_j) == 8
    for t, j in zip(lines_t, lines_j):
        assert _NUM.sub("#", t) == _NUM.sub("#", j)
        for a, b in zip(_NUM.findall(t), _NUM.findall(j)):
            scale = 100 if a.endswith("%") else 1
            assert abs(float(a.rstrip("%")) - float(b.rstrip("%"))) \
                <= TOL * scale


def test_cli_needs_cuda_unless_told_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prog = tmp_path / "prog.qb"
    prog.write_text(PROGRAMS["subset"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_cli([str(prog), "--compile"])
    assert torch_cli([str(prog), "--compile", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[2].startswith("|1〉|0〉- 1.0")


def test_cli_without_compile_runs_dense_interpreter(tmp_path, capsys):
    prog = tmp_path / "prog.qb"
    prog.write_text("qset comp[0]\ngate hadamardGate\nmeas out ; comp\n"
                    "cout out")
    assert torch_cli([str(prog)]) == 0
    assert "0.5" in capsys.readouterr().out


def test_cli_missing_file(capsys):
    assert torch_cli(["/nonexistent/prog.qb", "--compile"]) == 1
    assert "File Not Found" in capsys.readouterr().out
