#!/usr/bin/env python3
"""Measures the bf16_3x norm drift of two source trees of this repository on
one card: ``bench.py``'s brickwork body (16 layers) x 16 on the scanned
runner, paired and unpaired, at 22, 23 and 26 qubits.

    python3 tools/drift_ab.py PARENT_TREE [CHANGE_TREE]

Each tree (a checkout, e.g. ``git archive`` of a commit unpacked into a
directory that ``.gitignore`` lists; the change defaults to this one) runs
in a process of its own, which imports that tree's ``qbot_tpu_torch`` and
builds its kernels into the tree's own ``_build``.  The drift, (1 - |psi|^2)
per 100 gates with the norm summed in float64, is deterministic: one run a
tree.  Prints each run's drift beside the other tree's, then the card's name
and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
QUBITS = (22, 23, 26)
LAYERS, REPEATS = 16, 16


def worker() -> None:
    """The drifts of this process's qbot_tpu_torch (the tree first on
    sys.path)."""
    import numpy as np
    import torch

    from chip_smoke import brickwork_circuit
    from qbot_tpu_torch import compile_circuit
    from qbot_tpu_torch.tpu import kernels
    from qbot_tpu_torch.tpu.planar import (make_scanned_planar_runner,
                                           product_state_planar)

    kernels.set_dot_mode("bf16_3x")
    device = torch.device("cuda", 0)
    drifts = {}
    for n in QUBITS:
        c = brickwork_circuit(n, LAYERS)
        psi0 = product_state_planar([np.array([1.0, 0.0])] * n, device)
        for pair in (True, False):
            psi = make_scanned_planar_runner(compile_circuit(c, pair=pair),
                                             REPEATS)(psi0)
            norm = float(torch.sum(torch.square(psi), dtype=torch.float64))
            key = f"{n}q {'paired' if pair else 'unpaired'}"
            drifts[key] = (1.0 - norm) / (c.gate_count * REPEATS / 100)
    print(json.dumps(drifts))


def run(tree: Path) -> dict:
    code = (f"import sys; sys.path.insert(0, {str(tree)!r}); "
            f"sys.path.insert(1, {str(ROOT / 'tools')!r}); "
            "import drift_ab; drift_ab.worker()")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main(argv) -> int:
    parent = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) > 1 else ROOT
    a, b = run(parent), run(change)
    for key in a:
        print(f"bf16_3x drift per 100 gates, {key}: parent {a[key]:.4e}, "
              f"change {b[key]:.4e}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
