"""Command-line interface of the PyTorch port.

``python -m qbot_tpu_torch FILE --compile [--device cuda|cpu]
[--precision f32|f32_mix|bf16_3x|bf16]`` runs a .qb program's unitary
fragment on the planar executor, with the same output as ``python -m
qbot_tpu FILE --compile`` (``qbot_tpu/cli.py:193-247``).  ``--compile
--ensemble [--smc B] [--seed S]`` runs it on the device particle ensemble
(mid-circuit ``meas``, ``disc``, targeted ``qset`` and ProbVal control
flow; exact fan-out, or B sampled SMC particles), as ``qbot_tpu/cli.py:
123-191`` does without its mesh.  Without ``--compile`` the program runs
on the port's copy of the dense host interpreter, as it does under
``qbot_tpu``, ``--ensemble`` on its copy of the exact host ensemble, and
``--smc``, ``--shard`` and ``--mesh 1xQ`` are ignored there, as under
``qbot_tpu``.

``--compile --shard K [--mesh 1x2^K]`` runs the program on a register
sharded over 2^K ranks (``qbot_tpu/cli.py:202-229``): local ranks started
with the spawn method, one a shard, in a ``torch.distributed`` group
(:mod:`qbot_tpu_torch.tpu.sharding`), ``nccl`` and one CUDA device a rank
under ``--device cuda``, ``gloo`` under ``--device cpu``.  Rank 0 prints
the readout; stderr gets ``sharded: 2^K devices, R reshards, B
interconnect bytes/run`` as under ``qbot_tpu``.  Too few CUDA devices, or a
program that cannot be sharded so, is one ``sharding error: …`` line and
exit 1; a malformed ``--mesh`` one ``mesh error: …`` line.

``--compile --ensemble`` with ``--shard K``, ``--mesh PxQ`` or ``--mesh
auto`` runs the device ensemble on a P × Q mesh of ranks
(``qbot_tpu/cli.py:124-191``; P × 2^K for ``--shard K`` alone): P rows of
particles, each particle's state sharded over its row's Q ranks
(:mod:`qbot_tpu_torch.tpu.sharded_ensemble`), started as ``--shard``
starts its ranks.  ``--mesh auto`` prints ``mesh auto: PxQ (particles x
qubit-shards)`` (:func:`~qbot_tpu_torch.utils.config.auto_mesh_shape`:
particles only until the register outgrows half a device's memory).  It
counts the ranks a mesh may have: on the card, the CUDA devices (one
``nccl`` rank each); on the CPU (``--device cpu``), ``CPU_MESH_RANKS`` = 8
``gloo`` ranks, the emulated devices the reference's CPU runs have
(``tests/conftest.py``), since CPU ranks are processes, which no device
count bounds.  A mesh of more ranks than that is one ``mesh error: …`` line
and exit 1.  On the register path (``--compile --shard K`` without
``--ensemble``) the particle axis of ``--mesh PxQ`` has nothing to split
and is not run.

The parser takes every flag of ``qbot_tpu/cli.py:22-75``, with the same
names, choices and defaults, and ``--device``.  ``--backend jax`` prints
why the port has no jax engine and exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys

# the ranks --mesh counts on the CPU (see the module docstring)
CPU_MESH_RANKS = 8


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
    parser.add_argument("--backend", choices=["numpy", "jax"],
                        default="numpy",
                        help="numeric engine of the host interpreter: numpy "
                             "(the port has no jax engine)")
    parser.add_argument("--dtype", choices=["c64", "c128"], default=None,
                        help="complex precision of the host interpreter's "
                             "registers (default c128)")
    parser.add_argument("--seed", type=int, default=0,
                        help="PRNG seed for sampling layers (SMC/HMC)")
    parser.add_argument("--precision",
                        choices=["f32", "f32_mix", "bf16_3x", "bf16"],
                        default=None,
                        help="precision of the --compile engine's window and "
                             "pair products: f32 (3xTF32 on the card, "
                             "default), f32_mix (the dot engine's per-window "
                             "rule: windows of 7 or more qubits run bf16_3x "
                             "products, narrower ones f32; the kernels run "
                             "it in f32, as the reference's do), bf16_3x (a "
                             "bf16 hi/lo split, three products), bf16 (one "
                             "bf16 product).  The reduced modes shrink the "
                             "norm a little every pass (README.md)")
    parser.add_argument("--profile", action="store_true",
                        help="print a per-line wall-time report after "
                             "execution")
    parser.add_argument("--compile", dest="compile_mode", action="store_true",
                        help="lower the program to the circuit IR and run it "
                             "on the device engine (unitary fragment only)")
    parser.add_argument("--shard", type=int, default=0, metavar="K",
                        help="with --compile: shard the register over 2^K "
                             "ranks, one a device (nccl, one CUDA device a "
                             "rank; gloo with --device cpu)")
    parser.add_argument("--ensemble", action="store_true",
                        help="enable probabilistic control flow: ProbVal "
                             "conditions on cjmp/halt/retr fork weighted "
                             "execution branches")
    parser.add_argument("--smc", type=int, default=0, metavar="B",
                        help="with --compile --ensemble: run B sampled SMC "
                             "particles")
    parser.add_argument("--mesh", type=str, default=None, metavar="PxQ",
                        help="device mesh shape particles x qubit-shards "
                             "(e.g. 2x4, or auto) for --compile --ensemble "
                             "runs, 1x2^K for --shard runs; default 1 x "
                             "2^K")
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


def _not_ported(args) -> str | None:
    """The message for a flag the port does not run, or None."""
    if args.backend == "jax":
        return ("--backend jax: the port has no jax engine and imports no "
                "jax (ROADMAP, North star); use --backend numpy")
    return None


def _sharded_rank(mesh, text: str, k: int, dtype, precision) -> tuple:
    """One rank of ``--compile --shard K``: lower the program (its output
    was printed once, by the launching process), run it sharded.  Returns
    (what rank 0 printed: the epilogue's output or the readout, a script
    error's message or None)."""
    from qbot_tpu_torch.backend import set_dtype
    from qbot_tpu_torch.errors import QbotScriptError
    from qbot_tpu_torch.frontend.lowering import (
        lower_program,
        run_lowered_sharded,
    )

    set_dtype(dtype)
    if precision:
        from qbot_tpu_torch.tpu.kernels import set_dot_mode

        set_dot_mode(precision)
    with contextlib.redirect_stdout(io.StringIO()):
        lp = lower_program(text)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            probs, _, _ = run_lowered_sharded(lp, k=k, mesh=mesh)
            if mesh.rank == 0 and probs is not None and not lp.has_epilogue:
                _print_outcomes(lp, probs)
    except QbotScriptError as e:
        return out.getvalue(), str(e)
    return out.getvalue(), None


def _run_sharded(text: str, lp, args) -> int:
    """``--compile --shard K``: the program on 2^K local ranks."""
    from qbot_tpu_torch.frontend.lowering import _full_circuit
    from qbot_tpu_torch.tpu.sharded import compile_sharded
    from qbot_tpu_torch.tpu.sharding import launch

    try:
        splan = compile_sharded(_full_circuit(lp, 7), args.shard)
    except ValueError as e:
        print(f"sharding error: {e}", file=sys.stderr)
        return 1
    sys.stdout.flush()
    sys.stderr.flush()
    ranks = launch(_sharded_rank, 2**args.shard, text, args.shard,
                   args.dtype, args.precision, device=args.device)
    if 0 not in ranks:          # another rank of a torchrun group
        return 0
    printed, error = ranks[0]
    print(printed, end="")
    if error is not None:
        print(error)
        return 1
    print(f"sharded: 2^{args.shard} devices, {splan.num_reshards} reshards, "
          f"{splan.comm_bytes()} interconnect bytes/run", file=sys.stderr)
    return 0


def _shard_error(args, mesh_shape) -> str | None:
    """Why ``--compile --shard K`` cannot start its ranks, or None."""
    if args.shard < 0:
        return f"--shard {args.shard}: K must be >= 0"
    size = 2**args.shard
    if mesh_shape is not None and mesh_shape[1] != size:
        return (f"--mesh {args.mesh} has {mesh_shape[1]} qubit shards, "
                f"--shard {args.shard} runs {size}")
    if args.device == "cuda":
        import torch

        count = torch.cuda.device_count()
        if count < size:
            return (f"--shard {args.shard} runs {size} ranks under nccl, "
                    f"one a CUDA device: {size} needed, {count} available")
    return None


def _device_ensemble(lines, smc: int, seed: int, device, mesh=None
                     ) -> str:
    """Run the device ensemble and print what ``--compile --ensemble``
    prints; returns its stderr line."""
    from qbot_tpu_torch.frontend.device_ensemble import (
        execute_lines_device_ensemble,
    )
    from qbot_tpu_torch.frontend.interpreter import peek_opcode
    from qbot_tpu_torch.ops.measurement import MeasurementResult

    res, particles = execute_lines_device_ensemble(
        lines, sample=smc, seed=seed, device=device, mesh=mesh)
    n_dev = sum(p.qreg.num_particles for p in particles
                if p.qreg is not None)
    extra = (f", pruned mass <= {res.lost_mass:.3e}"
             if res.lost_mass > 0 else "")
    # programs that print their own output did so during execution;
    # otherwise show every bound measurement result
    if not any(peek_opcode(line) == "cout" for line in lines):
        for name, val in res.namespace.items():
            if not name.startswith("__") and isinstance(
                    val, MeasurementResult):
                print(f"{name}:")
                print(val, end="")
    return (f"device ensemble: {len(particles)} branches, "
            f"{n_dev} device particles{extra}")


def _ensemble_rank(mesh, lines, smc: int, seed: int, dtype, precision
                   ) -> tuple:
    """One rank of ``--compile --ensemble`` on a mesh.  Returns (what it
    printed, its stderr line or None, a script error's message or
    None)."""
    from qbot_tpu_torch.backend import set_dtype
    from qbot_tpu_torch.errors import QbotScriptError

    set_dtype(dtype)
    if precision:
        from qbot_tpu_torch.tpu.kernels import set_dot_mode

        set_dot_mode(precision)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            line = _device_ensemble(lines, smc, seed, mesh.device, mesh)
    except QbotScriptError as e:
        return out.getvalue(), None, str(e)
    return out.getvalue(), line, None


def _mesh_ranks(device: str) -> int:
    """The ranks a mesh may have: one a CUDA device, or CPU_MESH_RANKS."""
    if device == "cuda":
        import torch

        return torch.cuda.device_count()
    return CPU_MESH_RANKS


def _ensemble_mesh_shape(path: str, args):
    """The mesh of ``--compile --ensemble`` (None: one device), or a
    ``mesh error`` message."""
    from qbot_tpu_torch.utils.config import auto_mesh_shape, parse_mesh_shape

    if not (args.shard or args.mesh):
        return None, None
    ranks = _mesh_ranks(args.device)
    try:
        if args.mesh == "auto":
            # particles only until the register's memory forces qubit
            # shards; the width is read off the program's initial qset
            from qbot_tpu_torch.errors import QbotScriptError
            from qbot_tpu_torch.frontend.lowering import lower_program

            n_q = None          # a program that does not lower: unknown
            try:
                with open(path, "r") as f, \
                        contextlib.redirect_stdout(io.StringIO()):
                    n_q = lower_program(f.read(), mid_measure=True).n
            except QbotScriptError:
                pass
            budget = {}
            if args.device == "cuda" and ranks:
                import torch

                budget = {"hbm_budget_bytes": torch.cuda.
                          get_device_properties(0).total_memory / 2}
            shape = auto_mesh_shape(ranks, n_q, **budget)
            print(f"mesh auto: {shape[0]}x{shape[1]} (particles x "
                  f"qubit-shards)", file=sys.stderr)
        else:
            shape = (parse_mesh_shape(args.mesh) if args.mesh
                     else (1, 2**args.shard))
        if shape[0] * shape[1] > ranks:
            raise ValueError(f"mesh {shape[0]}x{shape[1]} needs "
                             f"{shape[0] * shape[1]} devices, only {ranks} "
                             f"available")
    except ValueError as e:
        return None, f"mesh error: {e}"
    return shape, None


def _run_device_ensemble(path: str, args) -> int:
    """``--compile --ensemble``: quantum registers live on the device
    particle axis; ProbVal control flow forks host-side particles that
    share device tensors; mid-circuit meas/disc fan (or, with --smc,
    sample) device particles.  On a mesh, every rank runs the program and
    rank 0 prints."""
    shape, error = _ensemble_mesh_shape(path, args)
    if error:
        print(error, file=sys.stderr)
        return 1
    with open(path, "r") as f:
        lines = f.read().splitlines()
    if shape is None:
        line = _device_ensemble(lines, args.smc, args.seed, args.device)
        print(line, file=sys.stderr)
        return 0
    from qbot_tpu_torch.tpu.sharding import launch

    sys.stdout.flush()
    sys.stderr.flush()
    ranks = launch(_ensemble_rank, shape, lines, args.smc, args.seed,
                   args.dtype, args.precision, device=args.device)
    if 0 not in ranks:          # another rank of a torchrun group
        return 0
    printed, line, error = ranks[0]
    print(printed, end="")
    if error is not None:
        print(error)
        return 1
    print(line, file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    path = args.FILE if os.path.isabs(args.FILE) else os.path.join(
        os.getcwd(), args.FILE.lstrip("/"))
    if not os.path.exists(path):
        print(f"File Not Found at Path: \n{path}")
        return 1

    from qbot_tpu_torch.backend import set_backend, set_dtype
    from qbot_tpu_torch.errors import QbotScriptError
    from qbot_tpu_torch.frontend.interpreter import executeFile
    from qbot_tpu_torch.utils.config import (
        EngineConfig,
        parse_mesh_shape,
        set_runtime_config,
    )
    from qbot_tpu_torch.utils.profiling import (
        line_profile_report,
        profiling_enabled,
    )

    try:
        config = EngineConfig.from_args(args)
    except ValueError as e:
        print(f"mesh error: {e}", file=sys.stderr)
        return 1
    missing = _not_ported(args)
    if missing:
        print(missing, file=sys.stderr)
        return 1
    set_backend(args.backend)
    set_dtype(args.dtype)
    set_runtime_config(config)
    if args.precision:
        from qbot_tpu_torch.tpu.kernels import set_dot_mode

        set_dot_mode(args.precision)

    try:
        if not args.compile_mode:
            with open(path, "r") as f:
                if args.ensemble:
                    from qbot_tpu_torch.frontend.ensemble import (
                        executeTxtEnsemble,
                    )
                    runner = lambda: executeTxtEnsemble(f.read())  # noqa: E731
                else:
                    runner = lambda: executeFile(f)  # noqa: E731
                if args.profile:
                    with profiling_enabled():
                        runner()
                    print(line_profile_report(), file=sys.stderr)
                else:
                    runner()
            return 0

        import torch

        from qbot_tpu_torch.frontend.lowering import lower_program, run_lowered
        from qbot_tpu_torch.tpu.compiler import compile_circuit

        if args.shard and not args.ensemble:
            try:    # "auto" too, as under qbot_tpu: it has no PxQ shape
                mesh_shape = parse_mesh_shape(args.mesh) if args.mesh else None
            except ValueError as e:
                print(f"mesh error: {e}", file=sys.stderr)
                return 1
            why = _shard_error(args, mesh_shape)
            if why:
                print(f"sharding error: {why}", file=sys.stderr)
                return 1
        if args.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass --device cpu to "
                               "run the --compile engine on the CPU")
        if args.ensemble:
            return _run_device_ensemble(path, args)
        with open(path, "r") as f:
            text = f.read()
        lp = lower_program(text)
        plan = compile_circuit(lp.circuit, window="auto")
        print(f"lowered: {lp.n} qubits, {lp.circuit.gate_count} gates, "
              f"{plan.num_passes} device passes "
              f"({plan.engine} engine, torch {args.device})",
              file=sys.stderr)
        if args.shard:
            return _run_sharded(text, lp, args)
        probs, _ = run_lowered(lp, window="auto", device=args.device,
                               plan=plan)
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
