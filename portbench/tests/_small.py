"""The cells of ``BENCHMARK.json`` cut to a size the CPU holds in a test:
the same files, with the register and the traffic made smaller."""
from __future__ import annotations

import time
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parents[2]

# workload -> (qubits, traffic parameters that replace the file's)
SMALL = {
    "sv26-brickwork": (10, {"layers": 16, "repeats": 16}),
    "sv26-grover": (10, {"repeats": 16}),
    "ens24-smc64": (12, {"sample": 32}),
    "ens24-exact": (12, {}),
}


def small_spec(workload: str) -> dict:
    spec = run.load_cell(ROOT, workload)
    n, traffic = SMALL[workload]
    spec["config"]["qubits"] = n
    spec["traffic"].update(traffic)
    return spec


def measure(spec: dict, seed: int = 20261018, trace: bool = False) -> dict:
    return run.measure(spec, seed, 0.05, trace, "cpu", time.perf_counter())
