#!/usr/bin/env python3
"""Times ``window_apply`` of two source trees of this repository on one
card, in turns, at the window shapes of ``chip_smoke.py``'s phase 2.

    python3 tools/window_ab.py PARENT_TREE [CHANGE_TREE]

Each tree (a checkout, e.g. ``git archive`` of a commit unpacked into a
directory that ``.gitignore`` lists; the change defaults to this one) runs
in a process of its own, which imports that tree's ``qbot_tpu_torch`` and
builds its kernels into the tree's own ``_build``.  The processes run in the
order parent, change, change, parent; each times every shape in every dot
mode (f32, whose kernels a change may leave as they are, shows the spread)
as the mean of 20 launches after a warm-up, with CUDA events.  Prints, per
shape and mode, each tree's mean of its two runs and their ratio, then the
card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N = 26
MODES = ("f32", "bf16_3x", "bf16")
# chip_smoke.py check_window's shapes: label -> (start, width)
SHAPES = {"first": (0, 5), "middle": (N - 21, 7), "trailing": (N - 7, 7),
          "small_b": (N - 10, 7), "density_rows": (0, 6),
          "first_d2": (0, 1), "first_d4": (0, 2), "window2_a8": (3, 2),
          "window2_b128": (N - 9, 2), "window1_d2": (N - 10, 1),
          "unreached_d4": (N - 10, 2), "unreached_d4_trailing": (N - 2, 2)}


def worker() -> None:
    """Times this process's qbot_tpu_torch (the tree first on sys.path)."""
    import numpy as np
    import torch

    from qbot_tpu_torch.tpu import kernels

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    rng = np.random.default_rng(0)
    psi = torch.randn((2, 2**N), generator=gen, device=device)
    psi /= torch.sqrt(torch.sum(psi * psi))
    times = {}
    for label, (start, width) in SHAPES.items():
        d = 2**width
        q, r = np.linalg.qr(rng.normal(size=(d, d))
                            + 1j * rng.normal(size=(d, d)))
        u = q * (np.diag(r) / np.abs(np.diag(r)))
        w = torch.tensor(np.stack([u.real, u.imag]), dtype=torch.float32,
                         device=device)
        qs = sorted({max(start - 1, 0), start, start + width - 1, N - 1})
        phases = ((tuple(qs), complex(np.exp(0.7j)), 1),
                  ((start,), complex(-1.0), 0),
                  ((N - 1,), complex(np.exp(-1.3j)), 0))
        flips = tuple(int(m) for m in rng.integers(0, 2**N, size=3))
        diag = kernels.fused_diagonals(N, flips, phases, device)
        for mode in MODES:
            kernels.set_dot_mode(mode)
            kernels.window_apply(psi, N, start, width, w, diag)
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(20):
                kernels.window_apply(psi, N, start, width, w, diag)
            t1.record()
            torch.cuda.synchronize()
            times[f"{label} {mode}"] = t0.elapsed_time(t1) / 20
    kernels.set_dot_mode("f32")
    print(json.dumps(times))


def run(tree: Path, tool: str) -> dict:
    """The times ``tools/<tool>.py``'s worker takes in a process that
    imports ``tree``'s qbot_tpu_torch."""
    code = (f"import sys; sys.path.insert(0, {str(tree)!r}); "
            f"sys.path.insert(0, {str(ROOT / 'tools')!r}); "
            f"import {tool}; {tool}.worker()")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main(argv, tool: str = "window_ab") -> int:
    parent = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) > 1 else ROOT
    runs = [("parent", run(parent, tool)), ("change", run(change, tool)),
            ("change", run(change, tool)), ("parent", run(parent, tool))]
    for key in runs[0][1]:
        a = sum(r[key] for who, r in runs if who == "parent") / 2
        b = sum(r[key] for who, r in runs if who == "change") / 2
        print(f"{key}: parent {a:.4f} ms, change {b:.4f} ms, change / "
              f"parent {b / a:.3f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
