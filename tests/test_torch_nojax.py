"""The port runs where neither JAX nor ``qbot_tpu`` can be imported, as on
the machine with the card.

A subprocess blocks ``import jax`` and ``import qbot_tpu``
(``sys.modules[name] = None``), imports ``qbot_tpu_torch``, compiles a
10-qubit Grover circuit with the port's compiler (whose reflection
detection folds window matrices, which the JAX package's compiler does
through a module that imports JAX) and runs it on the CPU, then runs a
paired plan on the statevector and density executors, a lowered program,
and the port's CLI on ``examples/grover.qb`` with and without
``--compile``, and with ``--compile --precision bf16_3x``, then the exact
host ensemble (``frontend/ensemble.py``, with ``utils/config.py`` read by
the CLI) through ``--ensemble``, and the device ensemble
(``frontend/device_ensemble.py``, ``inference/``, ``utils/checkpoint.py``)
through ``--compile --ensemble`` and ``--compile --ensemble --smc 4`` on
``examples/mid_measurement.qb``, then one HMC step and one NUTS step over
the angles of a 4-qubit ansatz through the planar log-prob (gradients
through the kernels' backward) and the complex simulator's, then
``--compile --shard 1 --device cpu`` and ``--compile --ensemble --mesh
2x2 --device cpu`` (the particle × qubit mesh,
``tpu/sharded_ensemble.py``): their spawned ranks inherit a ``sys.path``
whose first entry holds a ``jax`` and a ``qbot_tpu`` that raise on
import, so the runs show that the ranks import neither.
Tolerance: 1e-5 on the marked probability and on ρ against ψψ†
(float32); the two CLI modes print the same readout within 1e-6, the
bf16_3x run within 1e-4, the exact device ensemble within 1e-6 of the
dense interpreter, the sharded runs within 1e-6 of the unsharded ones.
"""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = """
import contextlib, io, re, sys
sys.modules["jax"] = None
sys.modules["qbot_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import qbot_tpu_torch
from qbot_tpu_torch import lower_program
from qbot_tpu_torch.cli import main as cli_main
from qbot_tpu_torch.tpu.circuit import grover_circuit
from qbot_tpu_torch.tpu.compiler import compile_circuit
from qbot_tpu_torch.tpu.planar import (apply_plan_density_planar,
                                       apply_plan_planar, from_planar,
                                       planar_probs, zero_density_planar,
                                       zero_state_planar)
n, marked, iters = 10, 345, 6
plan = compile_circuit(grover_circuit(n, marked, iterations=iters))
assert any(type(s).__name__ == "ReflectStep" for s in plan.steps)
p = float(planar_probs(apply_plan_planar(zero_state_planar(n, "cpu"),
                                         plan))[marked])
want = np.sin((2 * iters + 1) * np.arcsin(2 ** (-n / 2))) ** 2
assert abs(p - want) < 1e-5, (p, want)
paired = compile_circuit(grover_circuit(9, 7, iterations=1), window=2)
assert any(type(s).__name__ == "PairStep" for s in paired.steps)
psi = from_planar(apply_plan_planar(zero_state_planar(9, "cpu"), paired))
rho = apply_plan_density_planar(zero_density_planar(9, "cpu"), paired).numpy()
assert np.allclose(rho[0] + 1j * rho[1], np.outer(psi, psi.conj()),
                   atol=1e-5)
lp = lower_program("qset comp[0]\\ngate hadamardGate\\nmeas out ; comp")
probs, _ = qbot_tpu_torch.run_lowered(lp, device="cpu")
assert np.allclose(probs, [0.5, 0.5], atol=1e-6)
outs = []
for extra in ([], ["--compile", "--device", "cpu"],
              ["--compile", "--device", "cpu", "--precision", "bf16_3x"]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli_main(["examples/grover.qb", *extra]) == 0
    outs.append(buf.getvalue())
line = re.compile(r"^(\\S+)- (\\S+) \\((\\S+)%\\)$", re.M)
dense, compiled, reduced = (line.findall(o) for o in outs)
assert len(dense) == len(compiled) == len(reduced) == 8, outs
for (kd, pd, cd), (kc, pc, cc), (kr, pr, _) in zip(dense, compiled, reduced):
    assert kd == kc == kr and abs(float(pd) - float(pc)) <= 1e-6, outs
    assert abs(float(cd) - float(cc)) <= 1e-4, outs
    assert abs(float(pd) - float(pr)) <= 1e-4, outs
assert max(float(p) for _, p, _ in dense) > 0.9, outs
from qbot_tpu_torch.tpu.kernels import dot_mode
assert dot_mode() == "bf16_3x"
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert cli_main(["examples/probabilistic_branching.qb", "--ensemble",
                     "--seed", "5"]) == 0
from qbot_tpu_torch.utils.config import runtime_config
assert runtime_config().seed == 5
ns = qbot_tpu_torch.executeTxtEnsemble(
    open("examples/probabilistic_branching.qb").read())
assert np.allclose(np.diag(ns["state"]).real, [0.75, 0.25])
outs = []
for extra in ([], ["--compile", "--ensemble", "--device", "cpu"],
              ["--compile", "--ensemble", "--device", "cpu", "--smc", "4"]):
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        assert cli_main(["examples/mid_measurement.qb", *extra]) == 0
    outs.append((line.findall(buf.getvalue()), err.getvalue()))
(dense, _), (exact, exact_err), (smc, smc_err) = outs
assert len(dense) == len(exact) == len(smc) == 6, outs
for (kd, pd, _), (ke, pe, _), (ks, ps, _) in zip(dense, exact, smc):
    assert kd == ke == ks and abs(float(pd) - float(pe)) <= 1e-6, outs
assert "64 device particles" in exact_err and "4 device particles" in smc_err
from qbot_tpu_torch.inference import (hmc_init, hmc_step,
                                      make_circuit_log_prob,
                                      make_circuit_log_prob_planar, nuts_step)
from qbot_tpu_torch.tpu.circuit import parameterized_layers
ansatz = compile_circuit(parameterized_layers(4, 2), window=2)
counts = np.zeros(16)
counts[0], counts[5] = 30.0, 10.0
gen = torch.Generator().manual_seed(0)
theta0 = torch.linspace(0.1, 1.0, 8)
for make in (make_circuit_log_prob_planar, make_circuit_log_prob):
    lp = make(ansatz, counts, device="cpu")
    state = hmc_step(gen, hmc_init(lp, theta0), lp, 0.05, 3)
    state, stats = nuts_step(gen, state, lp, 0.05, max_tree_depth=3)
    assert torch.isfinite(state.grad).all() and int(stats.num_leaves) >= 1
import os, tempfile
blocked = tempfile.mkdtemp()
for name in ("jax", "qbot_tpu"):
    os.mkdir(os.path.join(blocked, name))
    with open(os.path.join(blocked, name, "__init__.py"), "w") as f:
        f.write(f"raise ImportError('{name} is blocked')\\n")
sys.path.insert(0, blocked)
outs = []
for extra in (["--compile"], ["--compile", "--shard", "1"]):
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        assert cli_main(["examples/grover.qb", "--device", "cpu", *extra]) == 0
    outs.append((line.findall(buf.getvalue()), err.getvalue()))
(plain, _), (shard, shard_err) = outs
assert len(plain) == len(shard) == 8, outs
for (kp, pp, _), (ks, ps, _) in zip(plain, shard):
    assert kp == ks and abs(float(pp) - float(ps)) <= 1e-6, outs
assert "sharded: 2^1 devices" in shard_err, shard_err
buf, err = io.StringIO(), io.StringIO()
with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
    assert cli_main(["examples/mid_measurement.qb", "--compile", "--ensemble",
                     "--mesh", "2x2", "--device", "cpu"]) == 0
mesh = line.findall(buf.getvalue())
assert len(mesh) == 6, buf.getvalue()
for (ke, pe, _), (km, pm, _) in zip(exact, mesh):
    assert ke == km and abs(float(pe) - float(pm)) <= 1e-6, (exact, mesh)
assert "device ensemble: 1 branches" in err.getvalue(), err.getvalue()
assert not any(m.split(".")[0] in ("jax", "qbot_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# the device ensemble's modules, HMC/NUTS's, the utilities and the sharded
# register's, which the scans below must reach
ENSEMBLE_MODULES = ("inference/__init__.py", "inference/smc.py",
                    "inference/ensemble_exec.py", "utils/checkpoint.py",
                    "frontend/device_ensemble.py", "inference/hmc.py",
                    "inference/nuts.py", "tpu/simulator.py",
                    "utils/guards.py", "utils/profiling.py",
                    "tpu/sharded.py", "tpu/sharding.py",
                    "tpu/sharded_ensemble.py", "tpu/distributed.py")
# scripts beside the package that must import neither
SCRIPTS = ("chip_smoke.py", "tools/fit_costs.py")


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    sources = sorted((ROOT / "qbot_tpu_torch").rglob("*.py"))
    assert sources
    for module in ENSEMBLE_MODULES:
        assert ROOT / "qbot_tpu_torch" / module in sources, module
    for path in sources + [ROOT / name for name in SCRIPTS]:
        assert not pattern.search(path.read_text()), path


def test_port_sources_never_import_qbot_tpu():
    pattern = re.compile(r"^\s*(import|from)\s+qbot_tpu(\.|\s|$)", re.M)
    sources = sorted((ROOT / "qbot_tpu_torch").rglob("*.py"))
    assert len(sources) >= 20
    for path in sources + [ROOT / name for name in SCRIPTS]:
        assert not pattern.search(path.read_text()), path
