"""Command-line interface of the PyTorch port.

``python -m qbot_tpu_torch FILE --compile [--device cuda|cpu]`` runs a .qb
program's unitary fragment on the planar executor, with the same output as
``python -m qbot_tpu FILE --compile`` (``qbot_tpu/cli.py:193-247``).
Without ``--compile`` the program runs on the port's copy of the dense host
interpreter, as it does under ``qbot_tpu``.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    from qbot_tpu_torch import __version__

    parser = argparse.ArgumentParser(
        prog="qbot-tpu-torch",
        description="the qbot probabilistic-quantum DSL on PyTorch: "
                    "--compile runs the unitary fragment on a CUDA card")
    parser.add_argument("--version", action="version",
                        version="%(prog)s " + __version__)
    parser.add_argument("FILE", type=str,
                        help="path to the .qb file to execute (relative or "
                             "absolute)")
    parser.add_argument("--compile", dest="compile_mode", action="store_true",
                        help="lower the program to the circuit IR and run it "
                             "on the device engine (unitary fragment only)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device of the --compile engine (default cuda; "
                             "cpu runs the kernels' plain PyTorch versions)")
    return parser


def _print_outcomes(lp, probs) -> None:
    basis = lp.measure_basis
    m = len(lp.measure_targets) // basis.numQubits
    for i, p in enumerate(probs):
        syms = ""
        rem, digs = i, []
        for _ in range(m):
            digs.append(rem % len(basis))
            rem //= len(basis)
        for d in reversed(digs):
            syms += basis.ketSymbols[d]
        print(f"{syms}- {round(float(p), 15)} "
              f"({round(float(p) * 100, 13)}%)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    path = args.FILE if os.path.isabs(args.FILE) else os.path.join(
        os.getcwd(), args.FILE.lstrip("/"))
    if not os.path.exists(path):
        print(f"File Not Found at Path: \n{path}")
        return 1

    from qbot_tpu_torch.errors import QbotScriptError
    from qbot_tpu_torch.frontend.interpreter import executeFile

    try:
        if not args.compile_mode:
            with open(path, "r") as f:
                executeFile(f)
            return 0

        import torch

        from qbot_tpu_torch.frontend.lowering import lower_program, run_lowered
        from qbot_tpu_torch.tpu.compiler import compile_circuit

        if args.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass --device cpu to "
                               "run the --compile engine on the CPU")
        with open(path, "r") as f:
            lp = lower_program(f.read())
        plan = compile_circuit(lp.circuit)
        print(f"lowered: {lp.n} qubits, {lp.circuit.gate_count} gates, "
              f"{plan.num_passes} device passes "
              f"(torch {args.device} engine)", file=sys.stderr)
        probs, _ = run_lowered(lp, device=args.device, plan=plan)
        # programs with a classical epilogue print their own output (it
        # ran inside run_lowered with the result bound)
        if probs is not None and not lp.has_epilogue:
            _print_outcomes(lp, probs)
    except QbotScriptError as e:
        print(str(e))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
