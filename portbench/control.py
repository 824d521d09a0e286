"""The readings that set a cell's limits, on the card: the numbers the
reference compares, for sound runs of the program over a dozen seeds or
more, and for the control over three or more, all in one process: the
program with its lower-precision dot mode switched on (``--control-mode
bf16_3x``), the reference in the program's place computed in TF32
(``--control-mode tf32``), or the program with a fault of
``portbench/faults.py`` planted (``--control-mode fault:draw_zero``).

    python3 -m portbench.control --workload NAME --first-seed N \
        [--seeds 12] [--control-seeds 3] [--control-mode MODE[,MODE...]] \
        [--seconds 2] [--out FILE]

Each seed is one :func:`portbench.run.measure` of the cell (set-up, a
short window at the cell's own load, the judgement) with the limits out of
the way; it prints one JSON line a seed and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
import time
from pathlib import Path

from portbench import generator, run


def reference_readings(spec: dict, seed: int, device="cuda") -> dict:
    """The numbers compared for the control in the program's place: the
    reference's outputs in TF32, judged by the reference in float64."""
    request = generator.make_request(spec["config"], spec["traffic"], seed)
    reference = importlib.import_module(
        f"portbench.reference.{spec['config']['reference']}")
    outputs = reference.control_outputs(request, device, seed)
    return reference.judge(request, outputs, device)


def readings(spec: dict, mode: str, seed: int, seconds: float,
             device="cuda") -> dict:
    """The numbers compared in one short run of the cell with the program
    in dot ``mode`` (``tf32``: :func:`reference_readings`; ``fault:NAME``:
    the configuration's own mode with the fault NAME planted), the limits
    out of the way."""
    if mode == "tf32":
        return reference_readings(spec, seed, device)
    if mode.startswith("fault:"):
        from portbench import faults

        with faults.planted(mode.split(":", 1)[1]):
            return readings(spec, spec["config"]["precision"], seed,
                            seconds, device)
    spec = {**spec, "config": {**spec["config"], "precision": mode},
            "limits": {k: math.inf for k in spec["limits"]}}
    result = run.measure(spec, seed, seconds, False, device,
                         time.perf_counter())
    return {k: c["value"] for k, c in result["checks"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--control-mode", default="bf16_3x")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    spec = run.load_cell(Path.cwd(), args.workload)
    run.check_card(spec["cell"]["chips"])
    lines = []
    plan = [(spec["config"]["precision"], args.first_seed + i)
            for i in range(args.seeds)]
    plan += [(mode, args.first_seed + i)
             for mode in args.control_mode.split(",")
             for i in range(args.control_seeds)]
    for mode, seed in plan:
        line = {"workload": args.workload, "mode": mode, "seed": seed,
                "readings": readings(spec, mode, seed, args.seconds)}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
