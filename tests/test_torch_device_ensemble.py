"""The port's device ensemble on the CPU: ``run_lowered_ensemble``,
``executeTxtDeviceEnsemble`` and ``--compile --ensemble [--smc B]``
against ``qbot_tpu``'s, and against the port's host ensemble.

Programs: ``examples/mid_measurement.qb``, ``teleportation.qb``,
``probabilistic_branching.qb`` and a random 9-qubit mid-measurement
program with ``disc`` and targeted ``qset`` (made from a numpy seed).
Tolerance: 1e-5 on every outcome probability and on every entry of a
mixture (float32 states); the CLI's readouts line for line within 1e-6
(float32 digits).  Sampling mode draws from a torch generator, so its
outcomes are not the reference's: a sampled run of B >= 2000 particles is
held to the exact fan-out within 4σ of each outcome probability.
"""
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from qbot_tpu.frontend import device_ensemble as jde
from qbot_tpu.frontend import lowering as jlow
from qbot_tpu.inference import ensemble_exec as jee
from qbot_tpu_torch import (
    executeTxt,
    executeTxtDeviceEnsemble,
    executeTxtEnsemble,
    lower_program,
    run_lowered_ensemble,
)
from qbot_tpu_torch.cli import main as torch_cli
from qbot_tpu_torch.frontend.device_ensemble import (
    execute_lines_device_ensemble,
)
from qbot_tpu_torch.inference import ensemble_exec as ee

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
SMC_B = 2000


def _random_program(n=9, seed=0, first=(6,), last=(4,)):
    """Random rotations and CX, a mid-circuit meas of ``first``, a disc, a
    targeted qset (unsorted targets) and a final meas of ``last``."""
    rng = np.random.default_rng(seed)
    lines = [f"qset tensorExp(comp[0], {n})"]

    def layer():
        for q in range(n):
            kind = ("xRotGate", "yRotGate", "zRotGate")[rng.integers(3)]
            lines.append(f"gate {kind}({rng.uniform(0, 3):.6f}) ; {q}")
        for q in range(int(rng.integers(2)), n - 1, 2):
            lines.append(f"gate pauliXGate ; {q + 1} ; [{q}]")
    layer()
    lines.append(f"meas a ; computation ; {list(first)}")
    layer()
    lines.append(f"disc [{n - 1}]")
    lines.append("qset tensorProd(hadamard[0], comp[1]) ; [5, 2]")
    n -= 1
    layer()
    lines.append(f"meas b ; computation ; {list(last)}")
    return "\n".join(lines)


EXAMPLES = ("mid_measurement", "teleportation", "probabilistic_branching")
PROGRAMS = {name: (ROOT / "examples" / f"{name}.qb").read_text()
            for name in EXAMPLES}
PROGRAMS["random_9q"] = _random_program()
# the K² fan-outs of its measurements pass 256 particles: pruned as the
# reference prunes
PROGRAMS["random_9q_pruned"] = _random_program(first=(1, 6),
                                               last=(0, 4, 7))
LOWERABLE = ("mid_measurement", "teleportation", "random_9q",
             "random_9q_pruned")
EXACT = EXAMPLES + ("random_9q",)


def _results_close(got: dict, want: dict, tol=TOL):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].probs, want[name].probs,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("name", LOWERABLE)
def test_run_lowered_ensemble_matches_reference(name, capsys):
    src = PROGRAMS[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got, g_ens = run_lowered_ensemble(
            lower_program(src, mid_measure=True), device="cpu")
        out_port = capsys.readouterr().out
        want, w_ens = jlow.run_lowered_ensemble(
            jlow.lower_program(src, mid_measure=True))
    assert abs(float(g_ens.lost_mass) - float(w_ens.lost_mass)) <= TOL
    assert (float(g_ens.lost_mass) > 0) == name.endswith("pruned")
    assert capsys.readouterr().out.splitlines() == out_port.splitlines()
    _results_close(got, want)
    assert g_ens.num_particles == w_ens.num_particles
    np.testing.assert_allclose(ee.ensemble_mixture(g_ens),
                               jee.ensemble_mixture(w_ens), atol=TOL)


def _namespaces_close(got: dict, want: dict, tol=TOL):
    keys = sorted(k for k in want if not k.startswith("__"))
    assert sorted(k for k in got if not k.startswith("__")) == keys
    for k in keys:
        a, b = got[k], want[k]
        if hasattr(b, "probs"):      # a MeasurementResult or a ProbVal
            np.testing.assert_allclose(a.probs, b.probs, atol=tol,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(a, complex),
                                       np.asarray(b, complex), atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("name", EXACT)
def test_device_ensemble_matches_reference_and_host(name, capsys):
    """The same merged namespace as ``qbot_tpu``'s device runner and as
    the port's host ensemble."""
    src = PROGRAMS[name]
    got = executeTxtDeviceEnsemble(src, device="cpu")
    want = jde.executeTxtDeviceEnsemble(src)
    host = executeTxtEnsemble(src)
    capsys.readouterr()
    _namespaces_close(got, want)
    _namespaces_close(got, host)


def test_device_ensemble_mesh_is_not_ported():
    """``mesh=``: the device ensemble on a 2 × 2 gloo mesh of CPU ranks
    gives the reference's namespace on its 2 × 2 emulated mesh (the
    mid-measurement example: outcome distributions and the merged state
    within 1e-5)."""
    import jax

    from _torch_sharded_ensemble_ranks import device_namespace
    from qbot_tpu.tpu.sharding import make_mesh
    from qbot_tpu_torch.tpu.sharding import launch

    src = (ROOT / "examples" / "mid_measurement.qb").read_text()
    got = launch(device_namespace, (2, 2), src, device="cpu", timeout=300,
                 collective_timeout=120.0)[0]
    want = jde.executeTxtDeviceEnsemble(
        src, mesh=make_mesh((2, 2), devices=jax.devices()[:4]))
    names = [k for k in got if k.startswith("probs_")]
    assert names
    for key in names:
        np.testing.assert_allclose(got[key], want[key[6:]].probs, atol=TOL)
    np.testing.assert_allclose(got["state"],
                               np.asarray(want["state"], complex), atol=TOL)


DEEP = ("qset tensorProd(comp[0], comp[0], comp[0], comp[0])\n"
        "gate hadamardGate ; 0\n"
        "gate hadamardGate ; 1\n"
        "gate hadamardGate ; 2\n"
        "gate hadamardGate ; 3\n"
        "meas a ; computation ; [0, 1]\n"
        "meas b ; computation ; [1, 2]\n"
        "meas c ; computation ; [2, 3]")


def test_lost_mass_and_its_warning():
    """The K² fan-out capped at 32: the dropped mass surfaces as the
    reference's lost_mass, with its warning, and bounds the readouts'
    total-variation error against the dense interpreter."""
    with pytest.warns(RuntimeWarning, match="probability mass"):
        got, g_ens = run_lowered_ensemble(
            lower_program(DEEP, mid_measure=True), max_particles=32,
            device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want, w_ens = jlow.run_lowered_ensemble(
            jlow.lower_program(DEEP, mid_measure=True), max_particles=32)
    lost = float(g_ens.lost_mass)
    assert 0.0 < lost < 1.0
    assert abs(lost - float(w_ens.lost_mass)) <= TOL
    _results_close(got, want)
    dense = executeTxt(DEEP)
    for name in ("a", "b", "c"):
        tv = 0.5 * np.abs(np.asarray(got[name].probs)
                          - np.asarray(dense[name].probs)).sum()
        assert tv <= lost + 1e-6
    with pytest.warns(RuntimeWarning, match="pruning dropped"):
        res, _ = execute_lines_device_ensemble(DEEP.splitlines(),
                                               max_particles=32,
                                               device="cpu")
    assert abs(res.lost_mass - lost) <= TOL


CKPT = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
        "gate hadamardGate ; 0\n"
        "gate pauliXGate ; 1 ; [0]\n"
        "meas a ; computation ; [0]\n"
        "gate hadamardGate ; 2\n"
        "meas b ; computation ; [2]\n"
        "disc [2]\n"
        "meas c ; computation")


@pytest.mark.parametrize("sample", [0, 64])
def test_checkpoint_resume_equals_an_uninterrupted_run(sample, tmp_path,
                                                       monkeypatch):
    """A run that dies after its second measurement resumes from the
    snapshot (ensemble, cursor, results and, sampled, the generator's
    state) and ends where the uninterrupted run does."""
    kw = dict(device="cpu", sample=sample, seed=5)
    want, w_ens = run_lowered_ensemble(lower_program(CKPT, mid_measure=True),
                                       **kw)
    name = "measure_sample" if sample else "measure_fanout"
    real = getattr(ee, name)
    calls = {"n": 0}

    def dying(*a, **k):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("injected host loss")
        return real(*a, **k)

    ckpt = str(tmp_path / "snap")
    monkeypatch.setattr(ee, name, dying)
    with pytest.raises(RuntimeError, match="injected host loss"):
        run_lowered_ensemble(lower_program(CKPT, mid_measure=True),
                             checkpoint_dir=ckpt, **kw)
    monkeypatch.setattr(ee, name, real)
    got, g_ens = run_lowered_ensemble(lower_program(CKPT, mid_measure=True),
                                      checkpoint_dir=ckpt, **kw)
    for key in ("a", "b", "c"):
        np.testing.assert_allclose(got[key].probs, want[key].probs,
                                   atol=1e-12)
    np.testing.assert_array_equal(g_ens.psi.numpy(), w_ens.psi.numpy())


def test_snapshot_files_roll(tmp_path):
    from qbot_tpu_torch.utils.checkpoint import CheckpointManager

    ckpt = str(tmp_path / "snap")
    run_lowered_ensemble(lower_program(CKPT, mid_measure=True),
                         checkpoint_dir=ckpt, device="cpu")
    # one snapshot per event (2 meas + disc + meas), retention keeps 3
    assert CheckpointManager(ckpt).all_steps() == [2, 3, 4]


def _within_4_sigma(sampled, exact, B):
    p = np.asarray(exact, float)
    sigma = np.sqrt(np.maximum(p * (1 - p), 1.0 / B) / B)
    assert np.all(np.abs(np.asarray(sampled) - p) <= 4 * sigma), \
        (sampled, exact)


SMC_PROGRAM = ("qset tensorProd(comp[0], comp[0], comp[0])\n"
               "gate yRotGate(1.1) ; 0\n"
               "gate pauliXGate ; 1 ; [0]\n"
               "meas a ; computation ; [0]\n"
               "gate hadamardGate ; 2\n"
               "gate yRotGate(0.7) ; 1\n"
               "meas b ; computation ; [1, 2]\n"
               "gate xRotGate(0.4) ; 2\n"
               "meas c ; computation ; [2]")


def test_smc_matches_the_exact_fanout_statistically():
    """B = 2000 sampled particles at 3 qubits: every readout within 4σ of
    the exact fan-out's (a, drawn before any sampling, within 1e-5)."""
    exact, _ = run_lowered_ensemble(
        lower_program(SMC_PROGRAM, mid_measure=True), device="cpu")
    sampled, ens = run_lowered_ensemble(
        lower_program(SMC_PROGRAM, mid_measure=True), device="cpu",
        sample=SMC_B, seed=0)
    assert ens.num_particles == SMC_B and float(ens.lost_mass) == 0.0
    np.testing.assert_allclose(sampled["a"].probs, exact["a"].probs,
                               atol=TOL)
    for name in ("b", "c"):
        _within_4_sigma(sampled[name].probs, exact[name].probs, SMC_B)


# the reference CLI's output of every example, from one process (importing
# jax once)
_REFERENCE_CLI = """
import contextlib, io, json, sys
from qbot_tpu.cli import main
out = {}
for path in sys.argv[1:]:
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = main([path, "--compile", "--ensemble"])
    out[path] = (rc, o.getvalue(), e.getvalue())
print(json.dumps(out))
"""

CLI_EXAMPLES = EXAMPLES + ("superdense", "grover")


@pytest.fixture(scope="module")
def reference_cli():
    import json

    paths = [f"examples/{name}.qb" for name in CLI_EXAMPLES]
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_CLI, *paths],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


_NUM = r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?%?"


def _same_lines(got: str, want: str, tol=1e-6):
    import re

    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w), (got, want)
    for a, b in zip(g, w):
        assert re.sub(_NUM, "#", a) == re.sub(_NUM, "#", b), (a, b)
        for x, y in zip(re.findall(_NUM, a), re.findall(_NUM, b)):
            scale = 100 if x.endswith("%") else 1
            assert abs(float(x.rstrip("%")) - float(y.rstrip("%"))) \
                <= tol * scale, (a, b)


@pytest.mark.parametrize("name", CLI_EXAMPLES)
def test_cli_compile_ensemble_matches_reference(name, reference_cli, capsys):
    path = f"examples/{name}.qb"
    rc = torch_cli([path, "--compile", "--ensemble", "--device", "cpu"])
    out = capsys.readouterr()
    want_rc, want_out, want_err = reference_cli[path]
    assert rc == want_rc == 0
    _same_lines(out.out, want_out)
    assert out.err.strip().startswith("device ensemble:")
    assert out.err.strip() == want_err.strip()


def _readouts(text: str) -> list:
    """The probabilities a CLI run printed, one list per blank-line
    separated block."""
    blocks, cur = [], []
    for line in text.splitlines():
        if "- " in line and line.endswith("%)"):
            cur.append(float(line.split("- ")[1].split(" ")[0]))
        elif cur:
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    return blocks


def test_cli_smc_passes_the_statistical_check(capsys):
    path = "examples/mid_measurement.qb"
    assert torch_cli([path, "--compile", "--ensemble", "--device",
                      "cpu"]) == 0
    exact = _readouts(capsys.readouterr().out)
    assert torch_cli([path, "--compile", "--ensemble", "--device", "cpu",
                      "--smc", str(SMC_B), "--seed", "1"]) == 0
    out = capsys.readouterr()
    sampled = _readouts(out.out)
    assert f"{SMC_B} device particles" in out.err
    assert len(sampled) == len(exact) == 2
    for s, e in zip(sampled, exact):
        _within_4_sigma(s, e, SMC_B)
