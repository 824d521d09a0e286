#!/usr/bin/env python3
"""Fits the constants of the port's cost model for ``window="auto"``
(``qbot_tpu_torch/tpu/compiler.py``: ``COSTS``) to launch times measured on
one card.

    python3 tools/fit_costs.py [--out FILE] [--trace DIR]
    python3 tools/fit_costs.py --refit FILE

Collects every launch geometry that the planar executor makes for the
16-layer brickwork (``chip_smoke.py``'s ``brickwork_circuit``) and for
``parameterized_layers(n, 4)``, compiled at widths 1..7, paired and
unpaired, at 20, 23 and 26 qubits (first, middle and trailing windows at
D = 2-128, the pairs each plan emits, by family: ``compiler.step_launches``),
and a Grover body's reflection, and three PyTorch passes (a two-qubit
diagonal, a standalone flip, a two-qubit contraction across the register).
Each product launch is timed with none and with one fused controlled phase
(at 26 qubits also three), in every dot mode: a warm-up, then 10 launches
through its ``tpu/kernels.py`` wrapper between CUDA events, the modes in
turns, forward then backward, the mean of the two.  The reflection's first
launch is timed with the formation of c that the executor makes after it,
the PyTorch passes through the executor's own step functions, in f32 only
(they run no products in a dot mode).

The dot engine's launches (``tpu/dotplan.py``, ``compiler.dot_step_launches``)
are timed in the same run: every window of the same circuits compiled with
``partition="dot"`` at widths 4..8, by route (``dot_window_first``,
``dot_window_middle``, ``dot_window_trailing``), through the engine's own
window step on a CUDA state (its split of W prepared once, the state's
split and layout inside the launch), in every dot mode in turns; and the
masked pass of a real and of a complex phase (``dot_phase_real``,
``dot_phase_complex``), in f32.  Their phases are passes of their own, so
their windows are timed without.

For each family and mode it fits ``t0 + max(bytes / BW, ops / rate)`` to
the phase-free times (least squared relative error, BW and rate on a
geometric grid, t0 in closed form), then the fraction of the rest that a
fused phase adds (the median at 26 qubits over the launches with one
phase, against the same launch without; none when negative).  Prints each
family's constants as ``COSTS`` entries, its residuals (median and largest
relative error, and the geometry of the largest), and the card's name and
power limit; ``--out`` writes every time measured as JSON.  ``--trace DIR``
also runs the 26-qubit f32 launches once under
``qbot_tpu_torch.utils.profiling.device_trace`` and prints each kernel's
device time beside the CUDA-event time, which shows the host part of t0.
``--refit FILE`` fits the times of an earlier ``--out`` on any machine.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    _device_busy_ms,
    brickwork_circuit,
    grover_circuits,
)
from qbot_tpu_torch.tpu import dotplan, kernels, planar  # noqa: E402
from qbot_tpu_torch.tpu.circuit import parameterized_layers  # noqa: E402
from qbot_tpu_torch.tpu.compiler import (  # noqa: E402
    COSTS,
    DOT_WIDTHS,
    ContractStep,
    DiagStep,
    FlipStep,
    Launch,
    Plan,
    Term,
    WindowStep,
    compile_circuit,
    dot_step_launches,
    step_launches,
)

QUBITS = (20, 23, 26)
WIDTHS = range(1, 8)
MODES = ("f32", "bf16_3x", "bf16")
ITERS = 10
LAYERS = 16
TORCH_PASSES = ("torch_diag", "torch_flip", "torch_contract")
DOT_PHASES = ("dot_phase_real", "dot_phase_complex")
# the phase fused into a launch: the CZ normal form of a CX across two
# windows (-1 where both qubits are 1), then two more
CZ = -1.0 + 0j


def geometries(qubits) -> list[Launch]:
    """Every distinct launch (phases aside) of the plans named above."""
    seen = {}
    for n in qubits:
        circuits = (brickwork_circuit(n, LAYERS), parameterized_layers(n, 4))
        plans = [compile_circuit(c, w, pair) for c in circuits
                 for w in WIDTHS for pair in (True, False)]
        plans.append(compile_circuit(grover_circuits(n)[2]))
        for plan in plans:
            for step in plan.steps:
                for x in step_launches(step, n):
                    seen.setdefault((x.family, n, x.start, x.widths), x)
        for c in circuits:
            for w in DOT_WIDTHS:
                for step in compile_circuit(c, w, partition="dot").steps:
                    for x in dot_step_launches(step, n):
                        if x.family.startswith("dot_window"):
                            seen.setdefault((x.family, n, x.start, x.widths),
                                            x)
        seen.update({(f, n): Launch(f, n) for f in DOT_PHASES})
        seen.update({(f, n): Launch(f, n, 0, (2,) if f == "torch_contract"
                                    else ()) for f in TORCH_PASSES})
    return [Launch(x.family, x.n, x.start, x.widths) for x in seen.values()]


def _unitary(d: int, rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(d, d))
                        + 1j * rng.normal(size=(d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _planar(u: np.ndarray, device) -> torch.Tensor:
    return torch.tensor(np.stack([u.real, u.imag]), dtype=torch.float32,
                        device=device)


def _phases(x: Launch, k: int) -> tuple:
    n, s = x.n, x.start
    return (((s, n - 1), CZ, 3), ((n - 1,), np.exp(0.7j), 1),
            ((s,), CZ, 1))[:k]


def launcher(x: Launch, k: int, psi, device, rng):
    """A callable making launch ``x`` with ``k`` fused phases on ``psi``."""
    n = x.n
    if x.family.startswith("dot_window"):
        w = x.widths[0]
        step = WindowStep(x.start, w, (Term(tuple(range(w)),
                                            _unitary(2**w, rng)),))
        fn = dotplan._window_fn(n, dotplan._Win(step, (), ()), device,
                                dotplan._LIBRARY)
        return lambda: fn(psi, None)
    if x.family in DOT_PHASES:
        z = CZ if x.family == "dot_phase_real" else np.exp(0.7j)
        fn = dotplan._phase_fn(n, ((0, n - 1), z, 3), device)
        return lambda: fn(psi)
    if x.family.startswith(("window", "pair")):
        diag = kernels.fused_diagonals(n, (), _phases(x, k), device)
        ws = [_planar(_unitary(2**w, rng), device) for w in x.widths]
        if x.family.startswith("window"):
            return lambda: kernels.window_apply(psi, n, x.start, x.widths[0],
                                                ws[0], diag)
        return lambda: kernels.pair_apply(psi, n, x.start, *x.widths, *ws,
                                          diag)
    if x.family.startswith("reflect"):
        _, _, body = grover_circuits(n)
        refl = planar._Reflection(compile_circuit(body).steps[0], device)
        p3 = psi.reshape(2, refl.H, refl.T)
        if x.family == "reflect_dot":
            return lambda: refl.c_from_lane_dot(
                kernels.reflect_dot(p3, refl.a, refl.b), p3)
        c = torch.tensor([0.01, -0.02], device=device)
        return lambda: kernels.reflect_update(p3, c, refl.a, refl.b,
                                              refl.flips)
    step = {"torch_diag": DiagStep((0, n - 1), np.exp(1j * np.arange(4.0))),
            "torch_flip": FlipStep(5),
            "torch_contract": ContractStep((3, n - 2),
                                           _unitary(4, rng))}[x.family]
    fn = planar._step_fns(Plan(n, 7, [step]), device, planar._KERNELS)[0]
    return lambda: fn(psi, None)


def _ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def measure(qubits, device) -> list[dict]:
    """One record per launch, phase count and mode: its mean ms."""
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    launches = geometries(qubits)
    for n in qubits:
        psi = torch.randn((2, 2**n), generator=gen, device=device)
        psi /= torch.sqrt(torch.sum(psi * psi))
        for x in (x for x in launches if x.n == n):
            products = x.family.startswith(("window", "pair", "dot_window"))
            fused = x.family.startswith(("window", "pair"))
            modes = MODES if products else ("f32",)
            for k in ((0, 1, 3) if n == max(qubits) else (0, 1)) \
                    if fused else (0,):
                fn = launcher(x, k, psi, device, rng)
                ms = defaultdict(float)
                for mode in modes:
                    kernels.set_dot_mode(mode)
                    fn()
                for mode in modes + modes[::-1]:
                    kernels.set_dot_mode(mode)
                    ms[mode] += _ms(fn) / 2
                for mode in modes:
                    out.append({"family": x.family, "n": n, "start": x.start,
                                "widths": list(x.widths), "phases": k,
                                "mode": None if not products else mode,
                                "bytes": x.nbytes, "ops": x.ops,
                                "ms": ms[mode]})
        del psi
    kernels.set_dot_mode("f32")
    return out


def fit(b, o, t) -> tuple[float, float, float]:
    """(t0, BW, rate) minimising the squared relative error of
    t0 + max(b / BW, o / rate) against ``t`` (seconds)."""
    bws = np.geomspace(1e10, 2e13, 600)
    rates = (np.append(np.geomspace(1e12, 2e15, 600), np.inf) if o.any()
             else np.array([np.inf]))
    w = 1.0 / t**2
    best = (np.inf, 0.0, 0.0, 0.0)
    for rate in rates:
        m = np.maximum(b[None, :] / bws[:, None], o[None, :] / rate)
        t0 = np.clip(((t - m) * w).sum(1) / w.sum(), 0.0, None)
        err = (((t0[:, None] + m - t) / t) ** 2).sum(1)
        i = int(err.argmin())
        if err[i] < best[0]:
            best = (err[i], float(t0[i]), float(bws[i]), float(rate))
    return best[1:]


def fit_all(records) -> dict:
    """({family: {mode: (t0, BW, rate, phase)}}, residuals): the phase
    fraction is the median, over the largest register's launches with one
    phase, of the time that phase adds over the launch's phase-free time,
    as a share of the fitted body (the time less t0)."""
    groups = defaultdict(list)
    for r in records:
        groups[(r["family"], r["mode"])].append(r)
    n_max = max(r["n"] for r in records)
    costs, residuals = defaultdict(dict), {}
    for (family, mode), rs in sorted(groups.items(),
                                     key=lambda kv: str(kv[0])):
        plain = {(r["n"], r["start"], tuple(r["widths"])): r["ms"] * 1e-3
                 for r in rs if r["phases"] == 0}
        b, o, t = (np.array([r[k] for r in rs if r["phases"] == 0])
                   for k in ("bytes", "ops", "ms"))
        t0, bw, rate = fit(b, o, t * 1e-3)

        def body(r):
            return max(r["bytes"] / bw, r["ops"] / rate)
        added = [(r["ms"] * 1e-3 - plain[(r["n"], r["start"],
                                          tuple(r["widths"]))]) / body(r)
                 for r in rs if r["phases"] == 1 and r["n"] == n_max]
        phase = max(float(np.median(added)), 0.0) if added else 0.0
        costs[family][mode] = (t0, bw, rate, phase)
        rel = [(t0 + body(r) * (1 + phase * r["phases"])) / (r["ms"] * 1e-3)
               - 1 for r in rs]
        worst = int(np.argmax(np.abs(rel)))
        residuals[(family, mode)] = (
            float(np.median(np.abs(rel))), rel[worst], rs[worst], len(rs))
    return costs, residuals


def trace(device, out_dir: str) -> None:
    """The 26-qubit f32 launches with one phase, once under
    ``device_trace``: the card's busy time beside the CUDA-event time of
    the same launches, and the kernels by device time."""
    from qbot_tpu_torch.utils.profiling import device_trace, named_scope

    rng = np.random.default_rng(1)
    n = max(QUBITS)
    psi = torch.randn((2, 2**n), device=device)
    fns = [(x, launcher(x, 1, psi, device, rng)) for x in geometries((n,))
           if x.family.startswith(("window", "pair"))]
    events_ms = sum(_ms(fn) for _, fn in fns) * ITERS
    with device_trace(out_dir) as prof:
        for x, fn in fns:
            with named_scope(f"launch {x.family} {x.start} {x.widths}"):
                for _ in range(ITERS):
                    fn()
        torch.cuda.synchronize()
    print(f"trace ({out_dir}): {len(fns)} launch geometries x {ITERS}, f32: "
          f"CUDA events {events_ms:.3f} ms, device busy "
          f"{_device_busy_ms(prof):.3f} ms")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12))


def _num(v: float) -> str:
    return "np.inf" if v == np.inf else f"{v:.4g}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, help="write the times as JSON")
    parser.add_argument("--trace", metavar="DIR", help="also trace the "
                        "26-qubit f32 launches into DIR")
    parser.add_argument("--refit", type=Path, metavar="FILE",
                        help="fit the times an earlier run wrote with "
                             "--out, on any machine, and measure nothing")
    args = parser.parse_args(argv)
    if args.refit:
        saved = json.loads(args.refit.read_text())
        card, records = saved["card"], saved["records"]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("tools/fit_costs.py needs a CUDA card")
        device = torch.device("cuda", 0)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        kernels.build_kernels()
        records = measure(QUBITS, device)
    if args.out and not args.refit:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "records": records}))
    costs, residuals = fit_all(records)
    print("COSTS = {")
    for family in COSTS:
        fitted = costs.get(family, {})
        entries = [("None" if mode is None else f'"{mode}"') + ": ("
                   + ", ".join(map(_num, fitted[mode])) + ")"
                   for mode in (None, *MODES) if mode in fitted]
        sep = ",\n" + " " * (len(family) + 9)
        print(f'    "{family}": {{{sep.join(entries)}}},')
    print("}")
    for (family, mode), (med, worst, r, count) in residuals.items():
        print(f"residual {family} [{mode}]: {count} times, median "
              f"{med:.3f}, largest {worst:+.3f} at n={r['n']} start="
              f"{r['start']} widths={r['widths']} phases={r['phases']} "
              f"({r['ms']:.4f} ms)")
    if args.trace and not args.refit:
        trace(device, args.trace)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
