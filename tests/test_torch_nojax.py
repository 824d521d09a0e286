"""The port runs where JAX is not installed, as on the machine with the card.

A subprocess blocks ``import jax`` (``sys.modules["jax"] = None``), imports
``qbot_tpu_torch``, compiles a 10-qubit Grover circuit with the port's
compiler (whose reflection detection folds window matrices, which the JAX
package's compiler does through a module that imports JAX) and runs it on
the CPU, then runs a paired plan on the statevector and density executors.
Tolerance: 1e-5 on the marked probability and on ρ against ψψ† (float32).
"""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import qbot_tpu_torch
from qbot_tpu.frontend.lowering import lower_program
from qbot_tpu.tpu.circuit import grover_circuit
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
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    sources = sorted((ROOT / "qbot_tpu_torch").rglob("*.py"))
    assert sources
    for path in sources + [ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
