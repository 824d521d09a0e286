#!/usr/bin/env python3
"""Measures the bf16_3x norm drift of two source trees of this repository on
one card: ``bench.py``'s brickwork body (16 layers) x 16 on the scanned
runner, paired and unpaired, at 22, 23 and 26 qubits; the same 256 layers
of the unpaired plan through the kernels' plain versions (the reference's
split, ``apply_plan_planar_ref``); and through the kernels with the plain
versions in place of the windows of D <= 4 (``narrow windows plain``) or of
the wider ones (``wide windows plain``), which tells whose rounding the
drift is.

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
    from qbot_tpu_torch.tpu import kernels, planar
    from qbot_tpu_torch.tpu.planar import product_state_planar

    def mixed(narrow_plain: bool):
        """The kernels, with the plain window in place of the windows of
        D <= 4 (``narrow_plain``) or of the wider ones."""
        def window(psi, n, start, width, w, diag):
            plain = (width <= 2) == narrow_plain
            return (kernels.window_apply_ref if plain else
                    kernels.window_apply)(psi, n, start, width, w, diag)
        return planar._KERNELS._replace(window=window)

    ops = {"unpaired": planar._KERNELS, "plain": planar._PLAIN,
           "narrow windows plain": mixed(True),
           "wide windows plain": mixed(False)}
    kernels.set_dot_mode("bf16_3x")
    device = torch.device("cuda", 0)
    drifts = {}
    for n in QUBITS:
        c = brickwork_circuit(n, LAYERS)
        psi0 = product_state_planar([np.array([1.0, 0.0])] * n, device)
        runs = {"paired": (compile_circuit(c), planar._KERNELS)}
        runs.update((label, (compile_circuit(c, pair=False), o))
                    for label, o in ops.items())
        for label, (plan, o) in runs.items():
            fns = planar._step_fns(plan, device, o)
            psi = psi0
            for _ in range(REPEATS):
                psi = planar._run(psi, fns)
            norm = float(torch.sum(torch.square(psi), dtype=torch.float64))
            drifts[f"{n}q {label}"] = (1.0 - norm) / (c.gate_count * REPEATS
                                                      / 100)
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
