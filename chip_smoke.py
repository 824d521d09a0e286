#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``qbot_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and the script exits
nonzero:

0. the card: ``torch.cuda.is_available()`` must hold; prints its name and
   power limit as ``nvidia-smi`` reports them.
1. builds the CUDA kernels from ``qbot_tpu_torch/csrc/`` (timed).
2. holds every kernel against its plain PyTorch version on the card, at the
   26-qubit shapes of the ``--compile`` and density paths, with fused flips
   and phases: relative L2 error <= 1e-5 (float32 sums of up to 128
   products, two such sums for a pair, or row partials, taken in another
   order).  Times both, and each pair also as the two window launches it
   replaces.
3. runs the example programs through the port's CLI and holds the readout
   to the dense host interpreter's within 1e-6; then a generated 24-qubit
   program (Hadamards and a CX chain; qubit 0 reads [0.5, 0.5]).
4. Grover at 26 qubits, 512 iterations of the reflection loop after a
   paired Hadamard init: the marked probability within 1e-4 of
   sin²((2R+1)·asin(2^-n/2)), the norm of 1.
5. a 26-qubit random brickwork of 16 layers, paired (the default) and
   unpaired: each norm within 1e-4 of 1, each state within relative L2
   1e-5 of the same plan run through the kernels' plain versions on the
   card, and the two states within relative L2 1e-5 of each other.
6. a 13-qubit density matrix: ``bench.py``'s brickwork of 8 layers run 16
   times through the density runner.  The trace within 1e-4 of 1, one body
   within relative L2 1e-5 of the plain versions, and the final ρ within
   relative Frobenius 1e-4 of ψψ† of the statevector path (float32 over 16
   bodies).

Launch counts are reset before phase 3 and read after phase 6: every kernel
must have launched on that path.  The line before the last is one JSON
object of per-kernel results; the last is the run's verdict.

    python3 chip_smoke.py --profile chiprun_out

runs phases 0 and 1, then profiles phases 4, 5 (paired and unpaired) and 6
with torch.profiler (device busy share, the table of device time per
kernel, Chrome traces written to the directory) and nothing else.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import qbot_tpu_torch
# qbot_tpu's JAX-free host layer: the DSL front end and circuit IR the port
# shares, and the dense host interpreter that phase 3 takes as reference
from qbot_tpu.frontend.interpreter import executeTxt
from qbot_tpu.frontend.lowering import lower_program
from qbot_tpu.tpu.circuit import Circuit
from qbot_tpu_torch import compile_circuit
from qbot_tpu_torch.cli import main as cli_main
from qbot_tpu_torch.tpu import kernels
from qbot_tpu_torch.tpu.planar import (
    apply_plan_density_planar_ref,
    apply_plan_planar,
    apply_plan_planar_ref,
    make_planar_density_runner,
    make_scanned_planar_runner,
    planar_norm,
    product_state_planar,
    zero_density_planar,
    zero_state_planar,
)

ROOT = Path(__file__).resolve().parent
N = 26
GROVER_REPEATS = 512
BRICKWORK_LAYERS = 16
KERNEL_TOL = 1e-5          # relative L2, kernel vs plain version
READOUT_TOL = 1e-6         # probability units
NORM_TOL = 1e-4
DENSITY_N = 13             # bench.py's density workload
DENSITY_LAYERS = 8
DENSITY_REPEATS = 16
DENSITY_TOL = 1e-4         # relative Frobenius, ρ vs ψψ† after 16 bodies

# launch count name -> (source, TPU kernel it replaces); window_apply and
# pair_apply are one CUDA kernel each serving two TPU kernels, counted apart
# by geometry
KERNEL_SOURCES = {
    "window_apply": ("qbot_tpu_torch/csrc/window_apply.cu",
                     "qbot_tpu/tpu/kernels.py:208"),
    "window_apply_trailing": ("qbot_tpu_torch/csrc/window_apply.cu",
                              "qbot_tpu/tpu/kernels.py:270"),
    "reflect_dot": ("qbot_tpu_torch/csrc/reflect.cu",
                    "qbot_tpu/tpu/kernels.py:551"),
    "reflect_update": ("qbot_tpu_torch/csrc/reflect.cu",
                       "qbot_tpu/tpu/kernels.py:500"),
    "pair_apply": ("qbot_tpu_torch/csrc/pair_apply.cu",
                   "qbot_tpu/tpu/kernels.py:419"),
    "pair_apply_trailing": ("qbot_tpu_torch/csrc/pair_apply.cu",
                            "qbot_tpu/tpu/kernels.py:351"),
}


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_ms(fn, device, iters: int = 10) -> float:
    """Mean time of ``fn`` over ``iters`` runs after one warm-up: CUDA
    events on the card, the host clock elsewhere."""
    fn()
    sync(device)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_and_plain_ms(kernel, plain, device) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns: plain, kernel, kernel, plain."""
    return tuple(timed_in_turns([plain, kernel], device)[::-1])


def timed_in_turns(fns, device) -> list[float]:
    """Mean ms of each of ``fns``, timed forward then backward (plain,
    kernel, kernel, plain for two)."""
    order = list(range(len(fns)))
    ms = [0.0] * len(fns)
    for i in order + order[::-1]:
        ms[i] += timed_ms(fns[i], device) / 2
    return ms


def compare(name: str, got, want) -> tuple[float, float]:
    """(relative L2 error, max abs error); raises above KERNEL_TOL."""
    got, want = got.double(), want.double()
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    max_abs = float(torch.max(torch.abs(got - want)))
    if not rel <= KERNEL_TOL:
        raise AssertionError(f"{name}: relative L2 error {rel:.3e} > "
                             f"{KERNEL_TOL:g} (max abs {max_abs:.3e})")
    return rel, max_abs


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _random_state(n: int, gen: torch.Generator, device) -> torch.Tensor:
    psi = torch.randn((2, 2**n), generator=gen, device=device)
    return psi / torch.sqrt(torch.sum(psi * psi))


def _random_unitary(d: int, rng: np.random.Generator) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _planar_unitary(d: int, rng, device) -> torch.Tensor:
    u = _random_unitary(d, rng)
    return torch.from_numpy(np.stack([u.real, u.imag]).astype(
        np.float32)).to(device)


def check_window(n: int, device, rng, gen) -> tuple[dict, dict]:
    """window_apply vs window_apply_ref at the --compile path's geometries:
    the first and middle windows of the 26-qubit partition (B >= 128), the
    trailing window (B = 1), and a window with small B.  Returns the
    results of the B > 1 shapes (timed at the middle window) and of the
    trailing window."""
    D = 128 if n >= 8 else 2 ** (n - 1)
    width = D.bit_length() - 1
    geoms = {"first": (0, min(5, n - width)),
             "middle": (n - 3 * width, width) if n >= 3 * width + 1
             else (0, width),
             "trailing": (n - width, width),
             "small_b": (n - width - 3, width)}
    shapes = []
    psi = _random_state(n, gen, device)
    for label, (start, w) in geoms.items():
        A, B = 2**start, 2 ** (n - start - w)
        # qubits on the a-, j- and b-bits, wants that include 0
        qa = [start - 1] if start else []
        qj = [start, start + w - 1]
        qb = [n - 1] if B > 1 else []
        phases = ((tuple(qa + qj + qb), complex(np.exp(0.7j)),
                   int(rng.integers(0, 2 ** len(qa + qj + qb)))),
                  (tuple(qj), complex(-1.0), 0b01),
                  (tuple(qa + qb) or (start,), complex(np.exp(-1.3j)), -1))
        flips = tuple(int(m) for m in rng.integers(0, 2**n, size=3))
        diag = kernels.fused_diagonals(n, flips, phases, device)
        wt = _planar_unitary(2**w, rng, device)

        got = kernels.window_apply(psi, n, start, w, wt, diag)
        want = kernels.window_apply_ref(psi, n, start, w, wt, diag)
        rel, max_abs = compare(f"window_apply {label}", got, want)
        ms, plain_ms = kernel_and_plain_ms(
            lambda: kernels.window_apply(psi, n, start, w, wt, diag),
            lambda: kernels.window_apply_ref(psi, n, start, w, wt, diag),
            device)
        shapes.append({"window": label, "A": A, "D": 2**w, "B": B,
                       "rel_l2": rel, "max_abs_err": max_abs, "ms": ms,
                       "plain_ms": plain_ms})
        say(f"window_apply {label}: (A, D, B) = ({A}, {2**w}, {B}), "
            f"rel L2 {rel:.3e}, max abs {max_abs:.3e}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    def summary(group, timed):
        return {"shapes": group,
                "rel_l2": max(s["rel_l2"] for s in group),
                "max_abs_err": max(s["max_abs_err"] for s in group),
                "ms": timed["ms"], "plain_ms": timed["plain_ms"]}

    trailing = [s for s in shapes if s["B"] == 1]
    wide = [s for s in shapes if s["B"] > 1]
    middle = next(s for s in wide if s["window"] == "middle")
    return summary(wide, middle), summary(trailing, trailing[0])


def check_pair(n: int, device, rng, gen) -> tuple[dict, dict]:
    """pair_apply vs pair_apply_ref at the paths' 26-qubit pairs: the
    middle pair (0,5)+(5,7) of the brickwork and Grover's init (A = 1, B =
    2^14), their trailing pair (12,7)+(19,7), and the 13-qubit density's
    column pair (13,6)+(19,7).  Each is timed as the kernel, its plain
    version and the two window_apply launches it replaces.  Returns the
    results of the middle pair and of the trailing pairs (timed at
    (128, 128))."""
    geoms = {"middle": (0, 5, 7), "trailing": (n - 14, 7, 7),
             "density_columns": (n - 13, 6, 7)}
    psi = _random_state(n, gen, device)
    none = kernels.fused_diagonals(n, device=device)
    shapes = []
    for label, (start, width1, width2) in geoms.items():
        end = start + width1 + width2
        A, B = 2**start, 2 ** (n - end)
        # qubits on the a-, j-, m- and b-bits, wants that include 0
        qa = [start - 1] if start else []
        qj = [start, start + width1 - 1]
        qm = [start + width1, end - 1]
        qb = [n - 1] if B > 1 else []
        qs = qa + qj + qm + qb
        phases = ((tuple(qs), complex(np.exp(0.7j)),
                   int(rng.integers(0, 2 ** len(qs)))),
                  (tuple(qj + qm), complex(-1.0), 0b0100),
                  (tuple(qa + qb) or (start + width1,),
                   complex(np.exp(-1.3j)), -1))
        flips = tuple(int(m) for m in rng.integers(0, 2**n, size=3))
        diag = kernels.fused_diagonals(n, flips, phases, device)
        w1 = _planar_unitary(2**width1, rng, device)
        w2 = _planar_unitary(2**width2, rng, device)

        def kernel():
            return kernels.pair_apply(psi, n, start, width1, width2, w1, w2,
                                      diag)

        def plain():
            return kernels.pair_apply_ref(psi, n, start, width1, width2, w1,
                                          w2, diag)

        def windows():
            out = kernels.window_apply(psi, n, start, width1, w1, diag)
            return kernels.window_apply(out, n, start + width1, width2, w2,
                                        none)

        want = plain()
        rel, max_abs = compare(f"pair_apply {label}", kernel(), want)
        compare(f"two windows {label}", windows(), want)
        plain_ms, ms, windows_ms = timed_in_turns([plain, kernel, windows],
                                                  device)
        shapes.append({"pair": label, "A": A, "D1": 2**width1,
                       "D2": 2**width2, "B": B, "rel_l2": rel,
                       "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                       "two_window_ms": windows_ms})
        say(f"pair_apply {label}: (A, D1, D2, B) = ({A}, {2**width1}, "
            f"{2**width2}, {B}), rel L2 {rel:.3e}, max abs {max_abs:.3e}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, two windows "
            f"{windows_ms:.4f} ms")

    def summary(group):
        return {"shapes": group,
                "rel_l2": max(s["rel_l2"] for s in group),
                "max_abs_err": max(s["max_abs_err"] for s in group),
                "ms": group[0]["ms"], "plain_ms": group[0]["plain_ms"],
                "two_window_ms": group[0]["two_window_ms"]}

    return (summary([s for s in shapes if s["B"] > 1]),
            summary([s for s in shapes if s["B"] == 1]))


def check_reflect(n: int, device, rng, gen) -> tuple[dict, dict]:
    """reflect_dot / reflect_update vs their plain versions at the Grover
    geometry: H = 2^(n-7) head rows, T = 128 tail lanes, with flips."""
    T = 2 ** min(7, n - 1)
    H = 2**n // T
    psi = _random_state(n, gen, device).reshape(2, H, T)

    def unit(d):
        v = rng.normal(size=d) + 1j * rng.normal(size=d)
        v /= np.linalg.norm(v)
        return torch.from_numpy(np.stack([v.real, v.imag]).astype(np.float32))

    a = unit(H).reshape(2, H, 1).to(device)
    b = unit(T).reshape(2, 1, T).to(device)
    c = torch.tensor(rng.normal(size=2) * 2.0**(-n / 2), dtype=torch.float32,
                     device=device)
    flips = torch.tensor(rng.integers(0, 2**n, size=2), dtype=torch.int64,
                         device=device)

    rel, max_abs = compare("reflect_dot", kernels.reflect_dot(psi, a, b),
                           kernels.reflect_dot_ref(psi, a, b))
    ms, plain_ms = kernel_and_plain_ms(
        lambda: kernels.reflect_dot(psi, a, b),
        lambda: kernels.reflect_dot_ref(psi, a, b), device)
    dot = {"rel_l2": rel, "max_abs_err": max_abs, "ms": ms,
           "plain_ms": plain_ms, "shapes": [{"H": H, "T": T}]}
    say(f"reflect_dot: (H, T) = ({H}, {T}), rel L2 {rel:.3e}, max abs "
        f"{max_abs:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    out, d = kernels.reflect_update(psi, c, a, b, flips)
    out_ref, d_ref = kernels.reflect_update_ref(psi, c, a, b, flips)
    rel_o, abs_o = compare("reflect_update out", out, out_ref)
    rel_d, abs_d = compare("reflect_update D", d, d_ref)
    ms, plain_ms = kernel_and_plain_ms(
        lambda: kernels.reflect_update(psi, c, a, b, flips),
        lambda: kernels.reflect_update_ref(psi, c, a, b, flips), device)
    upd = {"rel_l2": max(rel_o, rel_d), "max_abs_err": max(abs_o, abs_d),
           "ms": ms, "plain_ms": plain_ms, "shapes": [{"H": H, "T": T}]}
    say(f"reflect_update: (H, T) = ({H}, {T}), rel L2 out {rel_o:.3e} D "
        f"{rel_d:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dot, upd


# ---------------------------------------------------------------------------
# phase 3: programs through the CLI, against the dense interpreter
# ---------------------------------------------------------------------------

_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?%?")


def _same_readout(name: str, got: str, want: str) -> None:
    """The two outputs agree in text, and number for number within
    READOUT_TOL (percentages within 100 × READOUT_TOL)."""
    if _NUM.sub("#", got) != _NUM.sub("#", want):
        raise AssertionError(f"{name}: output differs from the dense "
                             f"interpreter's\n--- port\n{got}--- dense\n"
                             f"{want}")
    for g, w in zip(_NUM.findall(got), _NUM.findall(want)):
        scale = 100.0 if g.endswith("%") else 1.0
        if abs(float(g.rstrip("%")) - float(w.rstrip("%"))) > \
                READOUT_TOL * scale:
            raise AssertionError(f"{name}: {g} vs dense {w}")


def _capture(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def run_examples(device, n: int = 24) -> None:
    for path in sorted((ROOT / "examples").glob("*.qb")):
        if path.name == "probabilistic_branching.qb":
            continue        # needs --ensemble, which the port lacks
        src = path.read_text()
        rc, got = _capture(cli_main, [str(path), "--compile", "--device",
                                      str(torch.device(device).type)])
        _, want = _capture(executeTxt, src)
        if "LoweringError" in got:
            # outside the unitary fragment, as under qbot_tpu --compile:
            # the measurement before the error still ran on the device
            lp = lower_program(src)
            try:
                qbot_tpu_torch.run_lowered(lp, device=device)
                raised = False
            except Exception as e:                     # noqa: BLE001
                if type(e).__name__ != "LoweringError":
                    raise
                raised = True
            name = lp.measure_name
            dense = _capture(executeTxt, src)[0][name].probs
            err = float(np.max(np.abs(np.asarray(lp.namespace[name].probs)
                                      - np.asarray(dense))))
            if rc != 1 or not raised or err > READOUT_TOL:
                raise AssertionError(f"{path.name}: rc {rc}, {name} "
                                     f"readout off by {err:.3e}")
            say(f"example {path.name}: LoweringError after '{name}' as "
                f"under qbot_tpu --compile; '{name}' within {err:.1e}")
            continue
        if rc != 0:
            raise AssertionError(f"{path.name}: rc {rc}\n{got}")
        _same_readout(path.name, got, want)
        say(f"example {path.name}: readout matches the dense interpreter")

    src = (f"qset tensorExp(comp.kets[0], {n})\n"
           "cdef i ; 0\nmark l\ngate hadamardGate ; i\ncdef i ; i + 1\n"
           f"cjmp l ; i < {n}\n"
           "cdef i ; 0\nmark c\ngate pauliXGate ; i + 1 ; i\n"
           f"cdef i ; i + 1\ncjmp c ; i < {n - 1}\n"
           "meas out ; comp ; 0")
    t0 = time.perf_counter()
    lp = lower_program(src)
    probs, psi = qbot_tpu_torch.run_lowered(lp, device=device)
    sync(device)
    err = float(np.max(np.abs(probs - 0.5)))
    if lp.n != n or err > 1e-5:
        raise AssertionError(f"{n}-qubit program: probs {probs}")
    say(f"{n}-qubit DSL program: {lp.circuit.gate_count} gates, qubit 0 "
        f"reads {probs.tolist()} in {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phases 4 and 5: the headline circuits
# ---------------------------------------------------------------------------

def grover_circuits(n: int) -> tuple[int, Circuit, Circuit]:
    """(marked index, init circuit, iteration body) of ``bench.py``'s
    Grover workload."""
    marked = 12345 % 2**n
    init = Circuit(n)
    for q in range(n):
        init.h(q)
    body = Circuit(n)
    body.phase_flip(marked)
    for q in range(n):
        body.h(q)
    body.phase_flip(0)
    for q in range(n):
        body.h(q)
    return marked, init, body


def grover_runner(n: int, repeats: int, device):
    """(marked index, gate count, runner of ``psi0 -> psi``, psi0)."""
    marked, init, body = grover_circuits(n)
    body_plan = compile_circuit(body)
    if [type(s).__name__ for s in body_plan.steps] != ["ReflectStep"]:
        raise AssertionError(f"Grover body compiled to {body_plan.steps}")
    run = make_scanned_planar_runner(body_plan, repeats,
                                     init_plan=compile_circuit(init))
    gates = body.gate_count * repeats + init.gate_count
    return marked, gates, run, zero_state_planar(n, device)


def brickwork_circuit(n: int, layers: int, seed: int = 0) -> Circuit:
    """``bench.py``'s random brickwork: Haar 1-qubit gates on every qubit,
    then CX on alternating neighbour pairs, per layer."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    for layer in range(layers):
        for q in range(n):
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            qm, r = np.linalg.qr(z)
            c.gate(qm * np.conj(r.diagonal() / np.abs(r.diagonal())), [q])
        for q in range(layer % 2, n - 1, 2):
            c.gate(X, [q + 1], controls=[q])
    return c


def grover(n: int, repeats: int, device) -> float:
    marked, gates, run, psi0 = grover_runner(n, repeats, device)
    run(psi0)
    sync(device)
    t0 = time.perf_counter()
    out = run(psi0)
    sync(device)
    elapsed = time.perf_counter() - t0
    p_marked = float(out[0, marked] ** 2 + out[1, marked] ** 2)
    p_want = math.sin((2 * repeats + 1) * math.asin(2 ** (-n / 2))) ** 2
    norm = float(planar_norm(out))
    if abs(p_marked - p_want) > NORM_TOL or abs(norm - 1.0) > NORM_TOL:
        raise AssertionError(f"Grover: marked {p_marked} vs {p_want}, "
                             f"norm {norm}")
    gates_s = gates / elapsed
    say(f"Grover {n}q x {repeats}: marked {p_marked:.8f} (closed form "
        f"{p_want:.8f}), norm {norm:.8f}, {elapsed:.4f} s, "
        f"{gates_s:.1f} gates/s")
    return gates_s


def brickwork(n: int, layers: int, device) -> dict:
    """Gates/s of the brickwork, paired (the default plan) and unpaired."""
    c = brickwork_circuit(n, layers)
    psi0 = product_state_planar([np.array([1.0, 0.0])] * n, device)
    rates, outs = {}, {}
    for label, pair in (("paired", True), ("unpaired", False)):
        plan = compile_circuit(c, pair=pair)
        apply_plan_planar(psi0, plan)
        sync(device)
        t0 = time.perf_counter()
        out = apply_plan_planar(psi0, plan)
        sync(device)
        elapsed = time.perf_counter() - t0
        norm = float(planar_norm(out))
        if abs(norm - 1.0) > NORM_TOL:
            raise AssertionError(f"brickwork {label}: norm {norm}")
        rel, _ = compare(f"brickwork {label} state", out,
                         apply_plan_planar_ref(psi0, plan))
        rates[label] = c.gate_count / elapsed
        outs[label] = out
        say(f"brickwork {n}q x {layers} layers, {label}: "
            f"{len(plan.steps)} steps, {plan.num_passes} passes, norm "
            f"{norm:.8f}, rel L2 vs plain {rel:.3e}, {elapsed:.4f} s, "
            f"{rates[label]:.1f} gates/s")
    rel, _ = compare("brickwork paired vs unpaired", outs["paired"],
                     outs["unpaired"])
    say(f"brickwork paired vs unpaired: rel L2 {rel:.3e}")
    return rates


def pure_density(psi: torch.Tensor) -> torch.Tensor:
    """Planar ψψ† of a planar state."""
    pr, pi = psi[0], psi[1]
    return torch.stack([torch.outer(pr, pr) + torch.outer(pi, pi),
                        torch.outer(pi, pr) - torch.outer(pr, pi)])


def density_runner(device):
    """(gate count, plan, runner of ``rho0 -> rho`` over the repeated
    bodies, rho0) of ``bench.py``'s density workload."""
    c = brickwork_circuit(DENSITY_N, DENSITY_LAYERS, seed=7)
    plan = compile_circuit(c)
    body = make_planar_density_runner(plan)

    def run(rho):
        for _ in range(DENSITY_REPEATS):
            rho = body(rho)
        return rho
    return (c.gate_count * DENSITY_REPEATS, plan, run,
            zero_density_planar(DENSITY_N, device))


def density(device) -> float:
    gates, plan, run, rho0 = density_runner(device)
    one = make_planar_density_runner(plan)(rho0)
    rel_one, _ = compare("density one body", one,
                         apply_plan_density_planar_ref(rho0, plan))
    del one
    run(rho0)
    sync(device)
    t0 = time.perf_counter()
    rho = run(rho0)
    sync(device)
    elapsed = time.perf_counter() - t0
    trace = float(torch.sum(torch.diagonal(rho[0])))
    if abs(trace - 1.0) > NORM_TOL:
        raise AssertionError(f"density: trace {trace}")
    psi = zero_state_planar(DENSITY_N, device)
    for _ in range(DENSITY_REPEATS):
        psi = apply_plan_planar(psi, plan)
    pure = pure_density(psi)
    frob = float(torch.linalg.vector_norm((rho - pure).double())
                 / torch.linalg.vector_norm(pure.double()))
    if not frob <= DENSITY_TOL:
        raise AssertionError(f"density: relative Frobenius {frob:.3e} from "
                             f"ψψ† > {DENSITY_TOL:g}")
    gates_s = gates / elapsed
    say(f"density {DENSITY_N}q x {DENSITY_LAYERS} layers x "
        f"{DENSITY_REPEATS}: {len(plan.steps)} steps a body, trace "
        f"{trace:.8f}, one body rel L2 vs plain {rel_one:.3e}, rel "
        f"Frobenius vs ψψ† {frob:.3e}, {elapsed:.4f} s, {gates_s:.1f} "
        f"gates/s")
    return gates_s


# ---------------------------------------------------------------------------
# --profile: where the time goes in phases 4 and 5
# ---------------------------------------------------------------------------

def _device_busy_ms(prof) -> float:
    """Milliseconds in which at least one device activity (kernel or copy)
    of the traced run was running: the union of their intervals."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type != torch.autograd.DeviceType.CPU)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return busy_us / 1e3


def profile(n: int, device, out_dir: Path) -> None:
    """Runs Grover (phase 4), the brickwork paired and unpaired (phase 5)
    and the density run (phase 6) once untimed, once timed on the host
    clock, and once under torch.profiler.  Prints each run's wall times,
    its device busy share (device-busy time over the traced wall time) and
    the profiler's table by device time, and writes the Chrome traces to
    ``out_dir``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out_dir.mkdir(parents=True, exist_ok=True)
    _, _, run, grover_psi0 = grover_runner(n, GROVER_REPEATS, device)
    brick = brickwork_circuit(n, BRICKWORK_LAYERS)
    paired = compile_circuit(brick)
    unpaired = compile_circuit(brick, pair=False)
    brick_psi0 = product_state_planar([np.array([1.0, 0.0])] * n, device)
    _, _, run_density, rho0 = density_runner(device)
    cases = {"grover": lambda: run(grover_psi0),
             "brickwork": lambda: apply_plan_planar(brick_psi0, paired),
             "brickwork_unpaired": lambda: apply_plan_planar(brick_psi0,
                                                             unpaired),
             "density": lambda: run_density(rho0)}
    for name, fn in cases.items():
        fn()
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        with torch_profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            sync(device)
            traced_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = _device_busy_ms(prof)
        trace = out_dir / f"trace_{name}.json"
        prof.export_chrome_trace(str(trace))
        say(f"profile {name} {n}q: wall {wall_ms:.3f} ms untraced, "
            f"{traced_ms:.3f} ms traced; device busy {busy_ms:.3f} ms, "
            f"busy share {busy_ms / traced_ms:.3f}; trace {trace}")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=12), flush=True)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", type=Path,
                        help="after the build, profile Grover, the "
                             "brickwork (paired and unpaired) and the "
                             "density run with torch.profiler, write their "
                             "traces to DIR, and run no other phase")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card: "
                           "torch.cuda.is_available() is false")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, power limit " \
           f"{smi.rsplit(',', 1)[-1].strip()}"
    say(f"phase 0: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    lib = kernels.build_kernels()
    kernels._library()
    say(f"phase 1: kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s ({lib.relative_to(ROOT)})")
    if args.profile is not None:
        profile(N, device, args.profile)
        return 0

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    results["window_apply"], results["window_apply_trailing"] = \
        check_window(N, device, rng, gen)
    results["reflect_dot"], results["reflect_update"] = check_reflect(
        N, device, rng, gen)
    results["pair_apply"], results["pair_apply_trailing"] = check_pair(
        N, device, rng, gen)
    say("phase 2: every kernel agrees with its plain version")

    kernels.reset_launch_counts()
    run_examples(device)
    say("phase 3: programs agree with the dense interpreter")
    grover_rate = grover(N, GROVER_REPEATS, device)
    say("phase 4: Grover agrees with its closed form")
    brick_rates = brickwork(N, BRICKWORK_LAYERS, device)
    say("phase 5: brickwork, paired and unpaired, agrees with the plain "
        "versions and with itself")
    density_rate = density(device)
    say("phase 6: the density matrix agrees with the plain versions and "
        "with ψψ†")
    counts = kernels.launch_counts()
    say(f"launches on the main path: {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    say(f"Grover {N}q: {grover_rate:.1f} gates/s; brickwork {N}q: "
        f"{brick_rates['paired']:.1f} gates/s paired, "
        f"{brick_rates['unpaired']:.1f} unpaired; density {DENSITY_N}q: "
        f"{density_rate:.1f} gates/s ({card})")

    print(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name],
         "max_abs_err": results[name]["max_abs_err"],
         "rel_l2": results[name]["rel_l2"], "ms": results[name]["ms"],
         "plain_ms": results[name]["plain_ms"],
         "two_window_ms": results[name].get("two_window_ms"),
         "shapes": results[name]["shapes"]}
        for name, (src, rep) in KERNEL_SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
