#!/usr/bin/env python3
"""Times ``pair_apply`` of two source trees of this repository on one card,
in turns, at the pair shapes of ``chip_smoke.py``'s phase 2.

    python3 tools/pair_ab.py PARENT_TREE [CHANGE_TREE]

Each tree (a checkout, e.g. ``git archive`` of a commit unpacked into a
directory that ``.gitignore`` lists; the change defaults to this one) runs
in a process of its own, which imports that tree's ``qbot_tpu_torch`` and
builds its kernels into the tree's own ``_build``.  The processes run in the
order parent, change, change, parent; each times every shape in every dot
mode (f32, whose kernels a change may leave as they are, shows the spread)
as the mean of 20 launches after a warm-up, with CUDA events, and the f32
trailing pairs at D2 = 128 (``trailing``, ``density_columns``) also as the
two window launches that could stand in for them (``two_windows``: the D1
window with the flips and phases, then the D2 window).  Prints, per shape
and mode, each tree's mean of its two runs and their ratio, then the
card's name and power limit (``tools/window_ab.py`` runs the turns).
"""
from __future__ import annotations

import json
import sys

import window_ab

N = 26
MODES = ("f32", "bf16_3x", "bf16")
# chip_smoke.py check_pair's shapes: label -> (start, width1, width2); the
# worker of this tree times every tree, so a parent whose pair_apply ran
# the D1, D2 <= 4 shapes on its shared-memory FMA kernel is timed there too,
# and the "wide_d1_narrow_d2" shapes (D1 >= 8 with D2 = 4) time a parent's
# shared-memory FMA pair against this tree's two window launches
SHAPES = {"middle": (0, 5, 7), "trailing": (N - 14, 7, 7),
          "density_columns": (N - 13, 6, 7), "middle_b1024": (4, 5, 7),
          "wide_d1_narrow_d2_middle": (0, 5, 2),
          "wide_d1_narrow_d2_trailing": (N - 9, 7, 2),
          "middle_narrow": (0, 2, 7), "middle_narrow_d2": (0, 1, 7),
          "trailing_narrow": (N - 9, 2, 7),
          "trailing_narrow_d2": (N - 8, 1, 7),
          "stream_2x2": (3, 2, 2), "stream_1x2": (0, 1, 2),
          "stream_1x1": (0, 1, 1), "stream_1x1_b128": (N - 9, 1, 1),
          "unreached_stream_trailing": (N - 4, 2, 2)}
# the shapes also timed as their two-window route, in f32
TWO_WINDOWS = ("trailing", "density_columns")


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

    def unitary(d):
        q, r = np.linalg.qr(rng.normal(size=(d, d))
                            + 1j * rng.normal(size=(d, d)))
        u = q * (np.diag(r) / np.abs(np.diag(r)))
        return torch.tensor(np.stack([u.real, u.imag]), dtype=torch.float32,
                            device=device)

    def timed(fn) -> float:
        """ms a call: the mean of 20 after a warm-up, by CUDA events."""
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(20):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / 20

    nodiag = kernels.fused_diagonals(N, device=device)
    times = {}
    for label, (start, width1, width2) in SHAPES.items():
        w1, w2 = unitary(2**width1), unitary(2**width2)
        end = start + width1 + width2
        qs = sorted({max(start - 1, 0), start, start + width1, end - 1,
                     N - 1})
        phases = ((tuple(qs), complex(np.exp(0.7j)), 1),
                  ((start,), complex(-1.0), 0),
                  ((N - 1,), complex(np.exp(-1.3j)), 0))
        flips = tuple(int(m) for m in rng.integers(0, 2**N, size=3))
        diag = kernels.fused_diagonals(N, flips, phases, device)
        for mode in MODES:
            kernels.set_dot_mode(mode)
            times[f"{label} {mode}"] = timed(
                lambda: kernels.pair_apply(psi, N, start, width1, width2, w1,
                                           w2, diag))
        kernels.set_dot_mode("f32")
        if label in TWO_WINDOWS:
            times[f"{label} two_windows f32"] = timed(
                lambda: kernels.window_apply(
                    kernels.window_apply(psi, N, start, width1, w1, diag), N,
                    start + width1, width2, w2, nodiag))
    print(json.dumps(times))


def main(argv) -> int:
    return window_ab.main(argv, tool="pair_ab")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
