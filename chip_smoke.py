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
   order).  ``window_apply`` and the pairs are also held within relative
   L2 2e-6 of a float64 product of the same inputs (3xTF32 products with
   FP32 accumulation; the plain float32 version's own float64 error is
   printed beside it).  Times each kernel in turns with its plain
   version and with one PyTorch call of the same function (``library_ms``,
   empty diagonals, TF32 off: an einsum over the real block form of W for
   the windows and pairs, one matmul of conj(A)'s block form for
   ``reflect_dot``; none for ``reflect_update``), the window also without
   diagonals, each pair also as the two window launches it replaces; and
   states each kernel's bound (section ``bound``).  Then every window and
   pair shape again in each reduced dot mode (``bf16_3x``, ``bf16``; the
   FMA kernels at D <= 4 included): each kernel against its plain version
   in the same mode (relative L2 1e-5; a bf16 pair 1e-4, since it rounds
   its float32 Y to bf16 a second time, and a Y one ulp apart can round
   2^-8 apart) and against float64 (2e-5, 1e-2), timed beside the f32
   kernel.  The pairs apply W1 first, as the reference and the plain
   version do.  Each is timed with the bound of its BF16 products and, for
   the windows, one bf16 product with float32 output (``torch.mm`` /
   ``torch.bmm`` with ``out_dtype``) as its library call, for the pairs
   the two such calls of its windows chained (no one call re-splits the
   intermediate Y), their operands split and laid out before
   the timed call (``library_ms``) and inside it (``library_split_ms``).
   The shapes are the ones plans produce (the windows at D <= 4 as the
   first window of a plan at n = 1, 2 (mod 7) and in a ``window=2`` plan;
   the pairs at D1, D2 <= 4 of ``window=1`` and ``window=2`` plans, on the
   streaming kernels) and a few that no plan reaches, printed so.
3. runs the example programs through the port's CLI and holds the readout
   to the dense host interpreter's within 1e-6; then a generated 24-qubit
   program (Hadamards and a CX chain; qubit 0 reads [0.5, 0.5]).
4. Grover at 26 qubits, 512 iterations of the reflection loop after a
   paired Hadamard init: the marked probability within 1e-4 of
   sin²((2R+1)·asin(2^-n/2)), the norm of 1.
5. a 26-qubit random brickwork of 16 layers, paired (the default) and
   unpaired: each norm within 1e-4 of 1, each state within relative L2
   1e-5 of the same plan run through the kernels' plain versions on the
   card, and the two states within relative L2 1e-5 of each other.  Then
   the drift check: ``bench.py``'s full 256 layers, paired (544 passes) and
   unpaired (771 window passes), each norm within 1e-5 of the plain
   versions' (a kernel whose sums round with a bias drifts the norm pass
   after pass).
6. a 13-qubit density matrix: ``bench.py``'s brickwork of 8 layers run 16
   times through the density runner.  The trace within 1e-4 of 1, one body
   within relative L2 1e-5 of the plain versions, and the final ρ within
   relative Frobenius 1e-4 of ψψ† of the statevector path (float32 over 16
   bodies).

7. the main path in each reduced dot mode: ``bench.py``'s brickwork
   (16-layer body x 16 repeats, 256 layers) on the scanned runner, its norm
   drift per 100 gates without renormalisation (at most 1e-6 in bf16_3x;
   bf16's rounded W are not unitary, its drift is printed), and with
   ``renorm_every=1``
   the norm within 1e-5 of 1 and its distance from the f32 run; the
   unpaired body; the density run (one body against the plain versions in
   the mode: within its launches' pair limits in bf16_3x, 1e-2 in bf16,
   whose roundings carry any difference up to a bf16 ulp; the trace after
   16 bodies within 1e-3 of 1 in bf16_3x); the examples through the CLI with
   ``--precision`` (readouts within 1e-4 of the dense interpreter's in
   bf16_3x, 1e-2 in bf16).

8. the brickwork of 16 layers at n = 1, 2 (mod 7), whose paired plans
   hold the narrow pairs (D1 = 2, 4 with D2 = 128), in every dot mode: at
   8, 9, 22 and 23 qubits against the plain versions and the unpaired plan
   (``runs_limit``); at 23 qubits the 256-layer drift (f32 as phase 5
   holds it, bf16_3x at most 1e-6 per 100 gates); at 22 qubits, whose first
   window is one qubit wide, the bf16_3x drift within 10% of the plain
   versions' drift in the same run (SPLIT_DRIFT_MARGIN); at 29 and 30
   qubits (4 and 8 GiB planar states) one body paired and unpaired, timed
   (gates/s, device milliseconds between CUDA events), the norm within
   1e-4 of 1 (f32, bf16_3x), paired against unpaired, and their launches
   of the D <= 4 window.
9. the 26-qubit brickwork of 16 layers compiled at ``window=2`` and at
   ``window=1`` (their plans pair D1, D2 <= 4 windows and run the D = 4
   windows), paired, in every dot mode: against the plain versions and the
   unpaired plan (as phase 8 holds them), the norm within 1e-4 of 1 (f32,
   bf16_3x), timed (gates/s, device milliseconds).
10. the device ensemble.  First the kernels' particle axis: every launcher
   (the D = 128 windows, middle and trailing, the streaming window, the
   D1 >= 8 pairs, middle and trailing, the narrow and the streaming pairs,
   the two reflections) at phase 2's 26-qubit shapes, in every dot mode
   (the reflections have none), on a batch of 3 states: one launch for the
   batch, each particle bit for bit its own single launch, the batch
   within LIMITS of the plain version; and one launch for 32 states at 24
   qubits timed in turns against 32 single launches, with its bound.  Then
   the ensemble path, with the launch counts reset before it: ``bench.py``'s
   SMC program (24 qubits, 32 particles, 4 collapse events; bench.py:
   396-470) through ``run_lowered_ensemble(sample=32, seed=0)`` three times
   (each result sums to 1 within 1e-3, bench.py's check; ``a``, drawn
   before any sampling, within 1e-5 of a run through the plain versions;
   warm wall time, samples/s, peak allocated memory); the same program's
   exact fan-out (every result within 1e-5 of the plain versions', the
   final particle count and ``lost_mass`` equal, peak memory); a 20-qubit
   Grover init and 4 bodies (one ReflectStep each, under the particle
   axis) on 8 sampled particles, then a measurement (state and pre-sampling
   distribution against the plain versions); every example through ``python
   -m qbot_tpu_torch FILE --compile --ensemble`` on the card against the
   same on ``--device cpu``.  It fails unless each of PHASE10_KERNELS moved.
11. gradients and HMC/NUTS over gate angles (``qbot_tpu_torch.inference``)
   at 24 qubits: ``benchmarks/smc_bench.py``'s posterior, the ansatz
   ``parameterized_layers(24, 4)`` (96 angles, a 128 MiB planar state),
   64 counts at outcome 0 and 32 at outcome 1, θ0 = linspace(0.1, 1.0),
   compiled paired (the default) and unpaired, and the same posterior
   over ``complex_ansatz(24, 2)`` (RX and RZ angles, so complex
   parameterised windows, with controlled phases e^{0.7i} and a phase
   flip fused into them), paired and unpaired.  In every dot mode, each
   plan's log-prob value and 96-angle gradient through the kernels (the
   window, pair and reflection Functions, whose backward runs the same
   kernels with W†) against the plain versions' autograd in the mode
   (GRAD_LIMITS: value 1e-5 / 1e-4 / 1e-6 relative, gradient 1e-4 / 1e-4 /
   3e-2 relative L2 in f32 / bf16_3x / bf16; the reasons beside them);
   every step after the first launches its kernel once more in the
   backward (the launch counts of a value-and-gradient are twice the
   forward's less the first step's, whose input needs no cotangent), and
   each of ``window_apply``, ``window_apply_trailing``, ``pair_apply`` and
   ``pair_apply_trailing`` has backward launches in every mode.  Each
   circuit's f32 gradients against the complex64 simulator's (rtol 2e-3, atol 1e-3,
   ``tests/test_inference.py``'s limits); a 20-qubit Grover-in-the-loss
   gradient (its reflection's adjoint through ``reflect_dot`` and
   ``reflect_update``) against the plain versions.  Timed: forward and
   value-and-gradient (wall and device milliseconds between CUDA events);
   for each window and pair geometry of the two plans the forward launch,
   the W† launch, the matrix cotangents' products and the whole backward,
   in turns, with the bound; ``run_hmc_chains`` with 4 chains x 8 samples,
   step 0.05, 5 leapfrogs (samples/s, gradients/s, acceptance, peak
   allocated memory); ``nuts_warmup`` 4 + ``run_nuts`` 4 transitions at
   ``max_tree_depth=4`` (leaves, finiteness).  Each kernel's entry of the
   JSON line gains ``backward_launches``.
12. ``window="auto"`` against the card, in every dot mode, on four cells:
   the 16-layer brickwork at 26 and at 23 qubits, Grover's 26-qubit body
   (64 iterations on the scanned runner after its width-7 init) and the
   24-qubit ansatz ``parameterized_layers(24, 4)`` forward at fixed
   angles.  Each compiled with ``window="auto"``, on the kernel engine at
   widths 1..7 and on the dot engine at widths 4..8 (``partition="dot"``),
   paired: (a) the auto plan equals the candidate of its engine and width
   step for step; each candidate timed on its prepared runner
   (``make_planar_runner``, the scanned runner for Grover, both honouring
   the plan's engine), the median of 5 CUDA-event runs in turns, printed
   beside its modelled ms (its engine's model) and the spread of the 5;
   candidates that make the same launches (``same_work``: Grover's one
   reflection at every width, on either engine) are measured by the
   median of all their runs; (b) the auto pick's time at most 1.10 x the
   least of the ranked candidates of either engine (kernel widths 4..7,
   dot widths 4..8);
   (c) every candidate's final state within ``runs_limit`` of its launches
   and library products (f32 KERNEL_TOL) of the f32 kernel width-7 plan's.
   Printed too: the kernel widths of 1..3 faster than the pick by more
   than 10% (a finding; the candidates stay the reference's), the host
   seconds of the auto compile against one width-7 compile, and the
   one-shot wall of ``apply_plan_planar`` at the pick (the route of the
   CLI's ``run_lowered``).
13. the dot engine (``qbot_tpu_torch/tpu/dotplan.py``: a library product
   a window) in f32, f32_mix, bf16_3x and bf16: the 26-qubit brickwork
   body (16 layers, the dot partition at the width the dot ranking picks)
   x 8 and Grover 26q x 64 (its width-7 init on the dot engine) on
   ``make_scanned_dot_runner``, each against ``apply_plan_dot_ref`` (every
   product as the CPU computes it) on the card (``dot_limit``: f32
   KERNEL_TOL, the reduced modes ``runs_limit`` of their products) and
   against the kernel engine's state of the same circuit at its first
   cheapest width, both timed (median of 3 in turns), the norm drift per
   100 gates printed; in the reduced modes ``renorm_every=4``, the norm
   within 1e-5 of 1 on exit.  Then ``bench.py``'s density workload (13
   qubits x 8 layers x 16 bodies, bench.py:355-362) three ways from the
   kernel engine's first cheapest plan: ``density_plan_2n`` on the dot
   engine, the same 26-qubit plan on the kernel engine and
   ``make_planar_density_runner``, the first two against the third (f32:
   trace and ρ within 1e-4; the other modes within their summed limits),
   all timed.  f32_mix's per-window rule: windows of 7 and 8 qubits (B = 1
   and A = 1) equal bf16_3x's products bit for bit, a 6-qubit one (A, B >
   1) f32's, each counted in its mode.  The dot window at each window
   geometry of phase 2 beside ``window_apply``, in turns (median of 5),
   in f32, bf16_3x and bf16.  Fails unless the library products ran in
   each of f32, bf16_3x and bf16 (``dotplan.product_counts``).  Its
   numbers make the JSON line (``{"dot_engine": ...}``) before the
   kernels' line.

14. the qubit-sharded register (``qbot_tpu_torch/tpu/sharded.py``) on
   ``torch.distributed`` ranks spawned from this script, all on the one
   card: K ranks under ``gloo`` (``nccl`` refuses two ranks of one
   communicator on one GPU; gloo copies each CUDA exchange through host
   memory), and one rank under ``nccl``.
   Each rank resets its launch counts before its runs and reports them
   after; a rank that fails fails the phase.  (a) The 16-layer 26-qubit
   brickwork of phase 5 on K = 2 and K = 4: the gathered, unpermuted state
   within relative L2 1e-5 of the single-device kernel path of the same
   circuit (``compile_circuit(..., window=7)``), the norm within 1e-4 of 1,
   every rank's window and pair kernels launched; ``num_reshards``,
   ``comm_bytes`` and the wall time of a run after one untimed run.  (b)
   Grover 26q x 64 on K = 4 (gloo) and K = 1 (nccl): its Hadamard init,
   then a body compiled from the init's layout whose ``num_reshards`` is
   0 (a ShardedFlip and a ShardedReflect); the marked probability within
   1e-4 of sin²((2R+1)·asin(2^-n/2)), ``reflect_dot`` and
   ``reflect_update`` launched on every rank.  (c) The 13-qubit density
   brickwork of phase 6 (one 8-layer body) on K = 2: the trace within 1e-4
   of 1, ρ within relative Frobenius 1e-4 of ``make_planar_density_runner``'s,
   ρ restored to the logical layout by ``plan_perm_to_identity``'s
   BitSwaps and LocalPerm within 1e-4 of it, then
   ``sharded_density_discard`` of two qubits (qubit 0, whose row axis is
   sharded there, and a local one) within 1e-4 of the single-device partial
   trace,
   ``sharded_density_probs_fn`` within 1e-4 (relative L2) of
   ``planar_density_probs``.  (d) ``python -m qbot_tpu_torch
   examples/grover.qb --compile --shard 1`` on the one card exits 1 with
   one ``sharding error`` line.  The readings print under a line saying
   the exchanges ran over gloo and the host: their times say nothing of
   NVLink or NCCL.  Each kernel's entry of the JSON line gains
   ``sharded_launches`` (phase 14's, summed over the ranks of each run).
15. the particle × qubit mesh (``tpu/sharded_ensemble.py``), its ranks
   spawned from the script, all on the one card: ``bench.py``'s SMC
   program at 24 qubits (``bench.py:402-445``: 4 collapse events, ``disc
   [n-1]``) through ``run_lowered_sharded_ensemble`` on (a) 1 × 1 under
   nccl, ``bench.py``'s mesh (:449), (b) 2 × 1 and (c) 2 × 2 under gloo,
   each with 32 sampled particles, and (d) 2 × 2 under gloo in exact
   fan-out mode; then one ``tpu/distributed.py:dryrun_step`` on the 2 × 2
   ranks (one HMC step with the chains on the particle axis, Grover 8q on
   the qubit axis, a mid-circuit program).  Checks: (d)'s marginals within
   1e-5 of phase 10's single-device exact fan-out; each sampled run's
   marginals sum to 1 within 1e-3 and lie within 4σ (binomial, 32
   particles) of (d)'s; each of the six TPU kernels' counters (grouped by
   the kernel they replace) launched in the phase, summed over the ranks.
   Readings: samples/s, wall per collapse, ``num_reshards``,
   ``comm_bytes``, ``num_collectives``, the memory peak per rank.  The
   ranks share the card, so samples/s at P > 1 is time-sliced, not
   scaling.  Each kernel's entry of the JSON line gains ``mesh_launches``.

Launch counts are reset before phase 3 and read after phase 6: every f32
kernel must have launched on that path; they are reset again before
phase 7, after which every reduced-mode counter (``window_apply[bf16_3x]``
and so on) must have moved, and before phase 8, after which every narrow
pair's counter (``pair_apply_narrow``, ``pair_apply_trailing_narrow``, in
each mode) must have moved, and before phase 9, after which the streaming
kernels' counters (``window_apply_stream``, ``pair_apply_stream``, in each
mode) must have moved, and before phase 10's ensemble runs (after its
particle-axis checks), after which each of PHASE10_KERNELS must have
moved, and before phases 11, 12 and 13, whose launches are added to the
line's, as are phase 14's and phase 15's ranks'.
The timed run of Grover, of each brickwork
plan and of the density bodies also reports its own launches.
The line before the last is one JSON object of per-kernel results; the
last is the run's verdict.

Bound: the least time the card could take for a kernel's work, the larger
of its bytes (each input read once, each output written once) over 3.35
TB/s and its operations over their peak rate: the complex products of a
window or pair as 3xTF32 products (FP32-grade) on the 495 TFLOP/s TF32
tensor cores, or as 3 (bf16_3x) and 1 (bf16) BF16 products on the 989
TFLOP/s BF16 tensor cores; the FMA variants' products (D <= 4; 1, 3, 1
a product) and the reflections' arithmetic at the 67 TFLOP/s FP32 rate.

    python3 chip_smoke.py --profile chiprun_out [--precision bf16_3x]

runs phases 0 and 1, then profiles phases 4, 5 (paired and unpaired), 8
(the 23-qubit body), 9 (the ``window=2`` body), 6, 10 (the SMC
program, sampled, one run) and 11 (one value-and-gradient of the paired
24-qubit ansatz) with torch.profiler
(device busy share, the table of device time per kernel, Chrome traces
written to the directory), in the dot mode ``--precision`` (default f32),
and nothing else.
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

# the rooflines' bound_ms read the benchmark's yardstick: a change to
# portbench/bounds.py moves every share this script prints
from portbench.bounds import bound, pair_bound, product_bound
from portbench.families import smc_program as smc_family
from portbench.families.brickwork import brickwork_ops
import qbot_tpu_torch
# the port's dense host interpreter is phase 3's reference
from qbot_tpu_torch import compile_circuit, executeTxt, lower_program
from qbot_tpu_torch.cli import main as cli_main
from qbot_tpu_torch.tpu import dotplan, kernels, sharded
from qbot_tpu_torch.tpu.circuit import Circuit
from qbot_tpu_torch.tpu.planar import (
    apply_plan_density_planar_ref,
    apply_plan_planar,
    apply_plan_planar_ref,
    make_planar_density_runner,
    make_scanned_planar_runner,
    planar_density_probs,
    planar_norm,
    planar_probs,
    product_state_planar,
    zero_density_planar,
    zero_state_planar,
)
from qbot_tpu_torch.tpu.sharding import launch
from qbot_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent
N = 26
GROVER_REPEATS = 512
BRICKWORK_LAYERS = 16
DRIFT_LAYERS = 256         # bench.py's brickwork depth
DRIFT_TOL = 1e-5           # norm after DRIFT_LAYERS, kernels vs plain
KERNEL_TOL = 1e-5          # relative L2, kernel vs plain version
READOUT_TOL = 1e-6         # probability units
NORM_TOL = 1e-4
F64_TOL = 2e-6             # relative L2, 3xTF32 kernels vs float64 products
# dot mode -> relative L2 limits (window vs plain, pair vs plain, either vs
# float64).  A bf16 pair rounds its float32 Y to bf16 a second time, and
# the kernel's Y and the plain version's are summed in other orders, so a
# one-ulp difference there moves a rounding by 2^-8: 1e-4 against its
# plain version.
LIMITS = {"f32": (KERNEL_TOL, KERNEL_TOL, F64_TOL),
          "bf16_3x": (1e-5, 1e-5, 2e-5),
          "bf16": (1e-5, 1e-4, 1e-2)}
REDUCED_MODES = ("bf16_3x", "bf16")
# readouts of the CLI in a reduced mode vs the dense interpreter (bf16: one
# bf16 product a pass, 2^-9 relative rounding of each operand)
MODE_READOUT_TOL = {"bf16_3x": 1e-4, "bf16": 1e-2}
RENORM_TOL = 1e-5          # |norm - 1| of the renormalised reduced runs
# |1 - norm| per 100 gates of the 256-layer bf16_3x brickwork without
# renormalisation (the tensor cores' truncating sums shrink it; 4.324e-7 on
# the k8 BF16 tile)
BF16X3_DRIFT_TOL = 1e-6
# |trace - 1| of the bf16_3x density run, 16 bodies without
# renormalisation (bf16's rounded W are not unitary: its trace is printed,
# and its body held to the plain versions)
DENSITY_TRACE_TOL = 1e-3
DENSITY_N = 13             # bench.py's density workload
DENSITY_LAYERS = 8
DENSITY_REPEATS = 16
DENSITY_TOL = 1e-4         # relative Frobenius, ρ vs ψψ† after 16 bodies
# phase 8: the brickwork at n = 1, 2 (mod 7), whose paired plans hold the
# narrow pairs: trailing (2, 128) and (4, 128) at 8 and 9 qubits, middle at
# 22 and 23 (and the sizes users run up to 8 GiB planar states, 29 and 30)
NARROW_QUBITS = (8, 9, 22, 23)
NARROW_DRIFT_QUBITS = 23
LARGE_QUBITS = (29, 30)
# the bf16_3x drift at 22 qubits, whose first window is one qubit wide: the
# mode's split leaves each window's W_hi + W_lo off unitary, and the one-
# qubit window's deviation (4 entries) does not average out as a D = 128
# window's does, so the plain versions drift 2.9644e-06 per 100 gates
# there (on the card and on the CPU alike; 6.2262e-07 at 23 qubits,
# 1.8706e-07 at 26).  The kernels add the truncating k16 sums of their
# D = 128 windows, 2.2-2.5e-7 at 22, 23 and 26 qubits alike (PERF.md §2):
# the kernels' drift is held within 10% of the plain versions' in the
# same run, the band within which the two drift alike
SPLIT_DRIFT_QUBITS = 22
SPLIT_DRIFT_MARGIN = 0.1
# phase 9: the 26-qubit brickwork compiled at these widths, whose plans
# pair D1, D2 <= 4 windows on the streaming pair and run D = 4 windows
STREAM_WINDOWS = (2, 1)

# launch count name -> (source, TPU kernel it replaces); window_apply and
# pair_apply are one CUDA kernel each serving two TPU kernels, counted apart
# by geometry, and by dot mode (window_apply[bf16_3x], ...)
KERNEL_SOURCES = {
    "window_apply": ("qbot_tpu_torch/csrc/window_tc.cuh",
                     "qbot_tpu/tpu/kernels.py:209"),
    "window_apply_trailing": ("qbot_tpu_torch/csrc/window_tc.cuh",
                              "qbot_tpu/tpu/kernels.py:271"),
    "reflect_dot": ("qbot_tpu_torch/csrc/reflect.cu",
                    "qbot_tpu/tpu/kernels.py:552"),
    "reflect_update": ("qbot_tpu_torch/csrc/reflect.cu",
                       "qbot_tpu/tpu/kernels.py:501"),
    "pair_apply": ("qbot_tpu_torch/csrc/pair_tc.cuh",
                   "qbot_tpu/tpu/kernels.py:420"),
    "pair_apply_trailing": ("qbot_tpu_torch/csrc/pair_tc.cuh",
                            "qbot_tpu/tpu/kernels.py:352"),
    # the narrow pairs (D1 = 2, 4 with D2 >= 8): the window's tile with W1
    # mixed into its operand
    "pair_apply_narrow": ("qbot_tpu_torch/csrc/window_tc.cuh",
                          "qbot_tpu/tpu/kernels.py:420"),
    "pair_apply_trailing_narrow": ("qbot_tpu_torch/csrc/window_tc.cuh",
                                   "qbot_tpu/tpu/kernels.py:352"),
    # the streaming FMA kernels of the narrow widths, in every dot mode:
    # windows at D = 2, 4 and pairs at D1, D2 = 2, 4 (plans reach them with
    # B > 1)
    "window_apply_stream": ("qbot_tpu_torch/csrc/window_apply.cu",
                            "qbot_tpu/tpu/kernels.py:209"),
    "pair_apply_stream": ("qbot_tpu_torch/csrc/pair_stream.cu",
                          "qbot_tpu/tpu/kernels.py:420"),
}
# the kernels of check_window's and check_pair's result groups, in order
WINDOW_KERNELS = ("window_apply", "window_apply_trailing",
                  "window_apply_stream")
PAIR_KERNELS = ("pair_apply", "pair_apply_trailing", "pair_apply_narrow",
                "pair_apply_trailing_narrow", "pair_apply_stream")
PRODUCT_KERNELS = WINDOW_KERNELS + PAIR_KERNELS
NARROW_KERNELS = tuple(k for k in PRODUCT_KERNELS if k.endswith("narrow"))
STREAM_KERNELS = tuple(k for k in PRODUCT_KERNELS if k.endswith("stream"))
# the reduced modes' windows and narrow pairs run csrc/window_bf16.cuh, their
# other pairs csrc/pair_bf16.cuh, the streaming kernels their own sources
for _mode in REDUCED_MODES:
    for _name in PRODUCT_KERNELS:
        src, rep = KERNEL_SOURCES[_name]
        if src.endswith("window_tc.cuh"):
            src = "qbot_tpu_torch/csrc/window_bf16.cuh"
        elif src.endswith("pair_tc.cuh"):
            src = "qbot_tpu_torch/csrc/pair_bf16.cuh"
        KERNEL_SOURCES[f"{_name}[{_mode}]"] = (src, rep)


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


def rel_l2(got, want) -> float:
    """Relative L2 distance, in float64 a chunk of 2^26 values at a time
    (a 30-qubit planar state takes 16 GiB in float64)."""
    got, want = got.reshape(-1), want.reshape(-1)
    num = den = 0.0
    for i in range(0, want.numel(), 1 << 26):
        g, w = got[i:i + (1 << 26)].double(), want[i:i + (1 << 26)].double()
        num += float(torch.sum((g - w) ** 2))
        den += float(torch.sum(w * w))
    return math.sqrt(num / den)


def compare(name: str, got, want, tol: float = KERNEL_TOL
            ) -> tuple[float, float]:
    """(relative L2 error, max abs error); raises above ``tol``."""
    rel = rel_l2(got, want)
    max_abs = float(torch.max(torch.abs(got.double() - want.double())))
    if not rel <= tol:
        raise AssertionError(f"{name}: relative L2 error {rel:.3e} > "
                             f"{tol:g} (max abs {max_abs:.3e})")
    return rel, max_abs


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores")
# a window or pair kernel in a mangled name (after its length prefix; an
# anonymous namespace may put a source's name before it)
_PTXAS_KERNEL = re.compile(
    r"\d((?:window|pair)_(?:tc|bf16|fma_stream|apply)_kernel)I(\w*?)EEv")


def ptxas_report(log: Path) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill-store bytes) of each window and pair kernel
    variant in the build's ptxas log."""
    rows, kernel, spills = [], None, 0
    for line in log.read_text().splitlines():
        if m := _PTXAS_ENTRY.search(line):
            k = _PTXAS_KERNEL.search(m.group(1))
            kernel = k and (f"{k.group(1)}<"
                            f"{','.join(re.findall(r'L[ib](\d+)E', k.group(2)))}>")
        elif kernel and (m := _PTXAS_SPILL.search(line)):
            spills = int(m.group(1))
        elif kernel and (m := _PTXAS_REGS.search(line)):
            rows.append((kernel, int(m.group(1)), spills))
            kernel = None
    return rows


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


def real_block(w: torch.Tensor) -> torch.Tensor:
    """(2, 2, D, D) real block form [[Wr, -Wi], [Wi, Wr]] of a planar
    (2, D, D) matrix."""
    return torch.stack([torch.stack([w[0], -w[1]]), torch.stack([w[1], w[0]])])


def library_window(psi, A, D, w):
    """One PyTorch call for window_apply with empty diagonals."""
    m, view = real_block(w), psi.view(2, A, D, -1)

    def run():
        with kernels._fp32_matmul():
            return torch.einsum("xyij,yajb->xaib", m, view)
    return run


def library_window_reduced(psi, A, D, B, w, mode, split_inside=False):
    """One PyTorch call for window_apply with empty diagonals in a reduced
    mode: a bf16 matrix product with float32 output (``out_dtype``) over
    the real block form, K-stacked [W_hi, W_hi, W_lo]·[x_hi; x_lo; x_hi]
    for bf16_3x.  Its operands are split and laid out (A, K, B) before the
    timed call (``library_ms``: less than the kernel's own work, which reads
    float32), or inside it (``split_inside``, ``library_split_ms``)."""
    def operands():
        m = real_block(w).permute(0, 2, 1, 3).reshape(2 * D, 2 * D)
        x = psi.view(2, A, D, B).permute(1, 0, 2, 3).reshape(A, 2 * D, B)
        mh, xh = m.bfloat16(), x.bfloat16()
        if mode == "bf16_3x":
            ml, xl = (m - mh.float()).bfloat16(), (x - xh.float()).bfloat16()
            mh, xh = torch.cat([mh, mh, ml], dim=1), torch.cat([xh, xl, xh],
                                                               1)
        if B == 1:
            return xh.reshape(A, -1).contiguous(), mh.t().contiguous()
        return mh.expand(A, -1, -1), xh

    mm = torch.mm if B == 1 else torch.bmm

    def run(a, b):
        return mm(a, b, out_dtype=torch.float32)
    if split_inside:
        return lambda: run(*operands())
    ops = operands()
    return lambda: run(*ops)


def _planar(out, A, D, B):
    """The planar (2, A·D·B) state of a reduced window library call's output
    (``library_window_reduced``: (A, 2D) for B = 1, (A, 2D, B) else)."""
    return out.view(A, 2, D, B).permute(1, 0, 2, 3).reshape(2, -1)


def library_pair_reduced(psi, A, D1, D2, B, w1, w2, mode,
                         split_inside=False):
    """Two PyTorch calls for pair_apply with empty diagonals in a reduced
    mode: ``library_window_reduced`` for W1, then for W2 on its output
    (which no single call re-splits).  Their operands are split and laid
    out before the timed calls (``library_ms``), or inside them, the second
    call's from the first call's output (``split_inside``,
    ``library_split_ms``)."""
    first = library_window_reduced(psi, A, D1, D2 * B, w1, mode,
                                   split_inside)
    if split_inside:
        return lambda: library_window_reduced(
            _planar(first(), A, D1, D2 * B), A * D1, D2, B, w2, mode,
            True)()
    second = library_window_reduced(_planar(first(), A, D1, D2 * B),
                                    A * D1, D2, B, w2, mode)
    return lambda: (first(), second())


def window_geometries(n: int) -> dict:
    """{label: (start, width)} of the windows phase 2 holds at ``n``
    qubits (check_window says which plan reaches each)."""
    width = 7
    return {"first": (0, 5),
            "middle": (n - 3 * width, width),
            "trailing": (n - width, width),
            "small_b": (n - width - 3, width),
            "density_rows": (0, 6),
            "first_d2": (0, 1),
            "first_d4": (0, 2),
            "window2_a8": (3, 2),
            "window2_b128": (n - 9, 2),
            "window1_d2": (n - 10, 1),
            "unreached_d4": (n - 10, 2),
            "unreached_d4_trailing": (n - 2, 2)}


def check_window(n: int, device, rng, gen, mode: str = "f32",
                 f32: dict | None = None) -> tuple[dict, dict]:
    """window_apply vs window_apply_ref in dot ``mode`` (set by the caller)
    at the --compile path's geometries: the first and middle windows of the
    26-qubit partition (B >= 128), the trailing window (B = 1), a window
    with small B, the density path's D = 64 row window, on the tensor
    cores; and on the streaming kernel at D = 2, 4 the first window of a
    plan at n = 1, 2 (mod 7) (A = 1), the D = 4 windows of the ``window=2``
    partition (A = 8, and B = 128), a D = 2 window of an unpaired
    ``window=1`` plan, and two shapes no plan reaches (the trailing window
    is min(n, 7) wide, the ``window=2`` starts odd at 26 qubits), with 3
    flips and 3 phases.  Also vs a float64 product of the same inputs, and
    timed with and without the diagonals, beside the plain version and one
    library call; ``f32``, the f32 run's results, puts each shape's f32
    time beside.  Returns the results of the tensor-core B > 1 shapes
    (timed at the middle window), of the trailing ones, and of the
    streaming ones (timed at the D = 4 first window)."""
    geoms = window_geometries(n)
    tol, _, f64_tol = LIMITS[mode]
    f32_ms = {s["window"]: s["ms"] for g in (f32 or {}).values()
              for s in g["shapes"]}
    shapes = []
    psi = _random_state(n, gen, device)
    none = kernels.fused_diagonals(n, device=device)
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
        rel, max_abs = compare(f"window_apply[{mode}] {label}", got, want,
                               tol)
        exact = kernels.window_apply_ref(psi.double(), n, start, w,
                                         wt.double(), diag, mode="f32")
        f64, plain_f64 = rel_l2(got, exact), rel_l2(want, exact)
        del exact
        if not f64 <= f64_tol:
            raise AssertionError(f"window_apply[{mode}] {label}: relative "
                                 f"L2 {f64:.3e} from float64 > {f64_tol:g}")
        fns = [lambda: kernels.window_apply_ref(psi, n, start, w, wt, diag),
               lambda: kernels.window_apply(psi, n, start, w, wt, diag),
               lambda: kernels.window_apply(psi, n, start, w, wt, none)]
        if mode == "f32":
            fns.append(library_window(psi, A, 2**w, wt))
        else:
            fns += [library_window_reduced(psi, A, 2**w, B, wt, mode),
                    library_window_reduced(psi, A, 2**w, B, wt, mode,
                                           split_inside=True)]
        plain_ms, ms, no_diag_ms, library_ms, *split_ms = timed_in_turns(
            fns, device)
        library_split_ms = split_ms[0] if split_ms else None
        del fns
        bound_ms, bound_by = product_bound(2 * psi.nbytes + wt.nbytes,
                                           8 * 2**w * 2**n, mode, w >= 3)
        shapes.append({"window": label, "A": A, "D": 2**w, "B": B,
                       "reached": not label.startswith("unreached"),
                       "rel_l2": rel, "max_abs_err": max_abs,
                       "rel_l2_f64": f64, "plain_rel_l2_f64": plain_f64,
                       "ms": ms, "ms_no_diagonals": no_diag_ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "library_split_ms": library_split_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by})
        beside = (f"; f32 kernel {f32_ms[label]:.4f} ms" if label in f32_ms
                  else "")
        split = ("" if library_split_ms is None
                 else f" (split inside {library_split_ms:.4f} ms)")
        if label.startswith("unreached"):
            beside += "; no plan reaches this"
        say(f"window_apply[{mode}] {label}: (A, D, B) = ({A}, {2**w}, {B}), "
            f"rel L2 {rel:.3e}, max abs {max_abs:.3e}; vs float64 "
            f"{f64:.3e} (plain {plain_f64:.3e}); kernel {ms:.4f} ms "
            f"(no diagonals {no_diag_ms:.4f}), plain {plain_ms:.4f} ms, "
            f"library {library_ms:.4f} ms{split}, bound {bound_ms:.4f} ms "
            f"({bound_by}, share {bound_ms / ms:.3f}){beside}")

    def summary(group, timed):
        return {"shapes": group,
                "rel_l2": max(s["rel_l2"] for s in group),
                "max_abs_err": max(s["max_abs_err"] for s in group),
                "rel_l2_f64": max(s["rel_l2_f64"] for s in group),
                **{k: timed[k] for k in ("ms", "plain_ms", "library_ms",
                                         "library_split_ms", "bound_ms",
                                         "bound_by")}}

    stream = [s for s in shapes if s["D"] <= 4]
    trailing = [s for s in shapes if s["B"] == 1 and s["D"] >= 8]
    wide = [s for s in shapes if s["B"] > 1 and s["D"] >= 8]
    middle = next(s for s in wide if s["window"] == "middle")
    first = next(s for s in stream if s["window"] == "first_d4")
    return (summary(wide, middle), summary(trailing, trailing[0]),
            summary(stream, first))


def library_reflect_dot(psi, a):
    """One PyTorch call for reflect_dot: the (2, 2H) real block form
    [[Ar, Ai], [-Ai, Ar]] of conj(A) times ψ viewed as (2H, T), in float32
    (the kernel sums in float64)."""
    ar, ai = a[0, :, 0], a[1, :, 0]
    m = torch.stack([torch.cat([ar, ai]), torch.cat([-ai, ar])])
    view = psi.reshape(2 * psi.shape[1], psi.shape[2])

    def run():
        with kernels._fp32_matmul():
            return m @ view
    return run


def check_pair(n: int, device, rng, gen, mode: str = "f32",
               f32: dict | None = None) -> tuple[dict, dict]:
    """pair_apply vs pair_apply_ref in dot ``mode`` (set by the caller) at
    the paths' 26-qubit pairs: the middle pair (0,5)+(5,7) of the brickwork
    and Grover's init (A = 1, B = 2^14), their trailing pair (12,7)+(19,7),
    and the 13-qubit density's column pair (13,6)+(19,7), all on the tensor
    cores; the brickwork's middle pair moved to (4,5)+(9,7) (A = 16, B =
    2^10: the same work with 16x shorter strides between the slab rows);
    the narrow pairs of the brickwork at n = 1, 2 (mod 7) at 26 qubits,
    middle (0,2)+(2,7) and (0,1)+(1,7), trailing (17,2)+(19,7) and
    (18,1)+(19,7), on the window's tile; the pairs of ``window=2`` and
    ``window=1`` plans on the streaming kernel, (0,1)+(1,2) and
    (3,2)+(5,2), (0,1)+(1,1) and (17,1)+(18,1) (B = 128), and its trailing
    form (22,2)+(24,2), which no plan reaches; a middle pair (0,5)+(5,2)
    and a trailing pair (17,7)+(24,2), whose D1 >= 8 with D2 = 4 runs as
    two windows (explicit ``partition="dot"`` plans reach it).
    Each is also held to a float64 product of the same inputs, and timed as
    the kernel, its plain version, one einsum (empty diagonals; in a
    reduced mode the two library calls of its windows,
    ``library_pair_reduced``) and the two window_apply launches it
    replaces; ``f32``, the f32 run's results, puts each shape's f32 time
    beside.  Returns the results of the middle pairs (timed at (32, 128)),
    the trailing pairs (timed at (128, 128)), the narrow middle and the
    narrow trailing pairs (timed at D1 = 4) and the streaming pairs (timed
    at (4, 4))."""
    geoms = {"middle": (0, 5, 7), "trailing": (n - 14, 7, 7),
             "density_columns": (n - 13, 6, 7), "middle_b1024": (4, 5, 7),
             "wide_d1_narrow_d2_middle": (0, 5, 2),
             "wide_d1_narrow_d2_trailing": (n - 9, 7, 2),
             "middle_narrow": (0, 2, 7), "middle_narrow_d2": (0, 1, 7),
             "trailing_narrow": (n - 9, 2, 7),
             "trailing_narrow_d2": (n - 8, 1, 7),
             "stream_2x2": (3, 2, 2), "stream_1x2": (0, 1, 2),
             "stream_1x1": (0, 1, 1), "stream_1x1_b128": (n - 9, 1, 1),
             "unreached_stream_trailing": (n - 4, 2, 2)}
    _, tol, f64_tol = LIMITS[mode]
    f32_ms = {s["pair"]: s["ms"] for g in (f32 or {}).values()
              for s in g["shapes"]}
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
        m1, m2 = real_block(w1), real_block(w2)
        view = psi.view(2, A, 2**width1, 2**width2, B)

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

        def library():
            with kernels._fp32_matmul():
                return torch.einsum("xyij,yzlm,zajmb->xailb", m1, m2, view)

        want = plain()
        got = kernel()
        rel, max_abs = compare(f"pair_apply[{mode}] {label}", got, want, tol)
        compare(f"two windows[{mode}] {label}", windows(), want, tol)
        exact = kernels.pair_apply_ref(psi.double(), n, start, width1,
                                       width2, w1.double(), w2.double(), diag,
                                       mode="f32")
        f64, plain_f64 = rel_l2(got, exact), rel_l2(want, exact)
        del exact, got
        if not f64 <= f64_tol:
            raise AssertionError(f"pair_apply[{mode}] {label}: relative L2 "
                                 f"{f64:.3e} from float64 > {f64_tol:g}")
        if mode == "f32":
            plain_ms, ms, library_ms, windows_ms = timed_in_turns(
                [plain, kernel, library, windows], device)
            library_split_ms = None
        else:
            fns = [plain, kernel, windows,
                   *(library_pair_reduced(psi, A, 2**width1, 2**width2, B,
                                          w1, w2, mode, inside)
                     for inside in (False, True))]
            (plain_ms, ms, windows_ms, library_ms,
             library_split_ms) = timed_in_turns(fns, device)
            del fns
        bound_ms, bound_by = pair_bound(
            2 * psi.nbytes + w1.nbytes + w2.nbytes, 2**n, 2**width1,
            2**width2, mode)
        shapes.append({"pair": label, "reached":
                       not label.startswith("unreached"), "A": A,
                       "D1": 2**width1,
                       "D2": 2**width2, "B": B, "rel_l2": rel,
                       "max_abs_err": max_abs, "rel_l2_f64": f64,
                       "plain_rel_l2_f64": plain_f64, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "library_split_ms": library_split_ms,
                       "two_window_ms": windows_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by})
        if library_ms is None:
            lib = "none"
        elif library_split_ms is None:
            lib = f"{library_ms:.4f} ms"
        else:
            lib = (f"{library_ms:.4f} ms as two calls (split inside "
                   f"{library_split_ms:.4f} ms)")
        beside = (f"; f32 kernel {f32_ms[label]:.4f} ms" if label in f32_ms
                  else "")
        if label.startswith("unreached"):
            beside += "; no plan reaches this"
        say(f"pair_apply[{mode}] {label}: (A, D1, D2, B) = ({A}, "
            f"{2**width1}, {2**width2}, {B}), rel L2 {rel:.3e}, max abs "
            f"{max_abs:.3e}; vs float64 "
            f"{f64:.3e} (plain {plain_f64:.3e}), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, "
            f"two windows {windows_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, share {bound_ms / ms:.3f}){beside}")

    def summary(group):
        return {"shapes": group,
                "rel_l2": max(s["rel_l2"] for s in group),
                "max_abs_err": max(s["max_abs_err"] for s in group),
                "rel_l2_f64": max(s["rel_l2_f64"] for s in group),
                **{k: group[0][k] for k in ("ms", "plain_ms", "library_ms",
                                            "library_split_ms",
                                            "two_window_ms", "bound_ms",
                                            "bound_by")}}

    def kind(s):
        return ("stream" if s["D1"] <= 4 and s["D2"] <= 4 else
                "narrow" if s["D1"] <= 4 else "wide")
    return (summary([s for s in shapes if s["B"] > 1 and kind(s) == "wide"]),
            summary([s for s in shapes
                     if s["B"] == 1 and kind(s) == "wide"]),
            summary([s for s in shapes
                     if s["B"] > 1 and kind(s) == "narrow"]),
            summary([s for s in shapes
                     if s["B"] == 1 and kind(s) == "narrow"]),
            summary([s for s in shapes if kind(s) == "stream"]))


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

    want = kernels.reflect_dot_ref(psi, a, b)
    rel, max_abs = compare("reflect_dot", kernels.reflect_dot(psi, a, b),
                           want)
    library = library_reflect_dot(psi, a)
    compare("reflect_dot library", library().reshape(want.shape), want)
    plain_ms, ms, library_ms = timed_in_turns([
        lambda: kernels.reflect_dot_ref(psi, a, b),
        lambda: kernels.reflect_dot(psi, a, b), library], device)
    # reads ψ and A (not B), writes the float64 (2, 1, T) D
    bound_ms, bound_by = bound(psi.nbytes + a.nbytes + 16 * T,
                               fp32_flops=8 * H * T)
    dot = {"rel_l2": rel, "max_abs_err": max_abs, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "shapes": [{"H": H, "T": T}]}
    say(f"reflect_dot: (H, T) = ({H}, {T}), rel L2 {rel:.3e}, max abs "
        f"{max_abs:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
        f"share {bound_ms / ms:.3f})")

    out, d = kernels.reflect_update(psi, c, a, b, flips)
    out_ref, d_ref = kernels.reflect_update_ref(psi, c, a, b, flips)
    rel_o, abs_o = compare("reflect_update out", out, out_ref)
    rel_d, abs_d = compare("reflect_update D", d, d_ref)
    ms, plain_ms = kernel_and_plain_ms(
        lambda: kernels.reflect_update(psi, c, a, b, flips),
        lambda: kernels.reflect_update_ref(psi, c, a, b, flips), device)
    bound_ms, bound_by = bound(2 * psi.nbytes + a.nbytes + b.nbytes
                               + 16 * T, fp32_flops=16 * H * T)
    upd = {"rel_l2": max(rel_o, rel_d), "max_abs_err": max(abs_o, abs_d),
           "ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "shapes": [{"H": H, "T": T}]}
    say(f"reflect_update: (H, T) = ({H}, {T}), rel L2 out {rel_o:.3e} D "
        f"{rel_d:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"none, bound {bound_ms:.4f} ms ({bound_by}, share "
        f"{bound_ms / ms:.3f})")
    return dot, upd


# ---------------------------------------------------------------------------
# phase 3: programs through the CLI, against the dense interpreter
# ---------------------------------------------------------------------------

_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?%?")


def _same_readout(name: str, got: str, want: str,
                  tol: float = READOUT_TOL) -> None:
    """The two outputs agree in text, and number for number within ``tol``
    (percentages within 100 × ``tol``)."""
    if _NUM.sub("#", got) != _NUM.sub("#", want):
        raise AssertionError(f"{name}: output differs from the dense "
                             f"interpreter's\n--- port\n{got}--- dense\n"
                             f"{want}")
    for g, w in zip(_NUM.findall(got), _NUM.findall(want)):
        scale = 100.0 if g.endswith("%") else 1.0
        if abs(float(g.rstrip("%")) - float(w.rstrip("%"))) > tol * scale:
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
    Grover workload.  Not ``portbench.families.grover``'s: that one draws
    the marked index from its seed and builds its Hadamards from another
    matrix, an ulp apart."""
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
    then CX on alternating neighbour pairs, per layer (the benchmark's
    ``portbench.families.brickwork``)."""
    c = Circuit(n)
    for _, targets, matrix, controls in brickwork_ops(n, layers, seed):
        c.gate(matrix, list(targets), list(controls))
    return c


def timed_run(fn, device):
    """(result, host seconds, device milliseconds between CUDA events around
    the run (None off the card), kernel launches) of one run of ``fn``
    after a warm-up run, ended by a synchronise."""
    fn()
    sync(device)
    events = None
    if torch.device(device).type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    if events:
        events[0].record()
    out = fn()
    if events:
        events[1].record()
    sync(device)
    elapsed = time.perf_counter() - t0
    after = kernels.launch_counts()
    return (out, elapsed, events and events[0].elapsed_time(events[1]),
            {k: after[k] - before[k] for k in after if after[k] != before[k]})


def grover(n: int, repeats: int, device) -> tuple[float, dict]:
    marked, gates, run, psi0 = grover_runner(n, repeats, device)
    out, elapsed, _, launches = timed_run(lambda: run(psi0), device)
    p_marked = float(out[0, marked] ** 2 + out[1, marked] ** 2)
    p_want = math.sin((2 * repeats + 1) * math.asin(2 ** (-n / 2))) ** 2
    norm = float(planar_norm(out))
    if abs(p_marked - p_want) > NORM_TOL or abs(norm - 1.0) > NORM_TOL:
        raise AssertionError(f"Grover: marked {p_marked} vs {p_want}, "
                             f"norm {norm}")
    gates_s = gates / elapsed
    say(f"Grover {n}q x {repeats}: marked {p_marked:.8f} (closed form "
        f"{p_want:.8f}), norm {norm:.8f}, {elapsed:.4f} s, "
        f"{gates_s:.1f} gates/s; launches {launches}")
    return gates_s, launches


def brickwork(n: int, layers: int, device) -> tuple[dict, dict]:
    """Gates/s and launches of the brickwork, paired (the default plan) and
    unpaired."""
    c = brickwork_circuit(n, layers)
    psi0 = product_state_planar([np.array([1.0, 0.0])] * n, device)
    rates, outs, launches = {}, {}, {}
    for label, pair in (("paired", True), ("unpaired", False)):
        plan = compile_circuit(c, pair=pair)
        out, elapsed, _, launches[label] = timed_run(
            lambda: apply_plan_planar(psi0, plan), device)
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
            f"{rates[label]:.1f} gates/s; launches {launches[label]}")
    rel, _ = compare("brickwork paired vs unpaired", outs["paired"],
                     outs["unpaired"])
    say(f"brickwork paired vs unpaired: rel L2 {rel:.3e}")
    return rates, launches


def brickwork_drift(n: int, layers: int, device) -> None:
    """The brickwork at ``bench.py``'s depth, paired and unpaired: the norm
    after every pass of it within DRIFT_TOL of the plain versions'."""
    c = brickwork_circuit(n, layers)
    psi0 = product_state_planar([np.array([1.0, 0.0])] * n, device)
    for label, pair in (("paired", True), ("unpaired", False)):
        plan = compile_circuit(c, pair=pair)
        t0 = time.perf_counter()
        out = apply_plan_planar(psi0, plan)
        norm = float(planar_norm(out))
        elapsed = time.perf_counter() - t0
        ref = apply_plan_planar_ref(psi0, plan)
        norm_ref = float(planar_norm(ref))
        rel = rel_l2(out, ref)
        del out, ref
        if not abs(norm - norm_ref) <= DRIFT_TOL:
            raise AssertionError(f"brickwork x {layers} {label}: norm "
                                 f"{norm} against {norm_ref} of the plain "
                                 f"versions")
        say(f"brickwork {n}q x {layers} layers, {label}: "
            f"{plan.num_passes} passes, norm {norm:.8f} (plain versions "
            f"{norm_ref:.8f}), rel L2 vs plain {rel:.3e}, {elapsed:.4f} s")


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


def density(device) -> tuple[float, dict]:
    gates, plan, run, rho0 = density_runner(device)
    one = make_planar_density_runner(plan)(rho0)
    rel_one, _ = compare("density one body", one,
                         apply_plan_density_planar_ref(rho0, plan))
    del one
    rho, elapsed, _, launches = timed_run(lambda: run(rho0), device)
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
        f"gates/s; launches {launches}")
    return gates_s, launches


# ---------------------------------------------------------------------------
# phase 7: the reduced dot modes end to end
# ---------------------------------------------------------------------------

def _launch_delta(fn):
    """(result of ``fn()`` ended by a synchronise, kernel launches it
    made)."""
    before = kernels.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def f32_references(n: int, device) -> dict:
    """The f32 states the reduced runs are measured against: the 26-qubit
    brickwork's 16 bodies on the scanned runner, and its unpaired body."""
    c = brickwork_circuit(n, BRICKWORK_LAYERS)
    psi0 = product_state_planar([np.array([1.0, 0.0])] * n, device)
    return {"scanned": make_scanned_planar_runner(
                compile_circuit(c), DRIFT_LAYERS // BRICKWORK_LAYERS)(psi0),
            "unpaired": apply_plan_planar(psi0, compile_circuit(c,
                                                                pair=False))}


def reduced_mode_path(n: int, device, mode: str, f32: dict) -> dict:
    """The main path in dot ``mode`` (set by the caller), as ``bench.py``'s
    reduced-precision rows run it (``tpu_general``: a 16-layer brickwork
    body x 16 repeats on the scanned runner, 256 layers): without
    renormalisation, the norm drift per 100 gates; with ``renorm_every=1``
    the norm within RENORM_TOL of 1, and the distance from the f32 run.
    Then the unpaired body (the single windows), the 13-qubit density
    matrix (one body against the plain versions in the mode, and its trace
    after 16 bodies), and the example programs through the
    CLI with ``--precision`` (readouts within MODE_READOUT_TOL of the dense
    interpreter's; mid_measurement.qb stops at a LoweringError under
    --compile and probabilistic_branching.qb needs --ensemble, as in phase
    3).  Returns the launches of each run."""
    c = brickwork_circuit(n, BRICKWORK_LAYERS)
    repeats = DRIFT_LAYERS // BRICKWORK_LAYERS
    body = compile_circuit(c)
    psi0 = product_state_planar([np.array([1.0, 0.0])] * n, device)
    gates = c.gate_count * repeats
    runs = {}
    t0 = time.perf_counter()
    out, runs["scanned"] = _launch_delta(
        lambda: make_scanned_planar_runner(body, repeats)(psi0))
    elapsed = time.perf_counter() - t0
    norm = float(planar_norm(out))
    rel = rel_l2(out, f32["scanned"])
    drift = (1.0 - norm) / (gates / 100)
    say(f"[{mode}] brickwork {n}q x {BRICKWORK_LAYERS} layers x {repeats} "
        f"(scanned, {gates} gates): norm {norm:.8f}, drift "
        f"{drift:.4e} per 100 gates, rel L2 vs f32 {rel:.3e}, "
        f"{elapsed:.4f} s")
    if mode == "bf16_3x" and not abs(drift) <= BF16X3_DRIFT_TOL:
        raise AssertionError(f"[{mode}] norm drift {drift:.4e} per 100 "
                             f"gates > {BF16X3_DRIFT_TOL:g}")
    out, runs["scanned_renorm"] = _launch_delta(
        lambda: make_scanned_planar_runner(body, repeats,
                                           renorm_every=1)(psi0))
    norm = float(planar_norm(out))
    rel = rel_l2(out, f32["scanned"])
    if not abs(norm - 1.0) <= RENORM_TOL:
        raise AssertionError(f"[{mode}] renorm_every=1: norm {norm}")
    say(f"[{mode}] the same with renorm_every=1: norm {norm:.8f}, rel L2 "
        f"vs f32 {rel:.3e}")
    del out
    out, runs["unpaired"] = _launch_delta(
        lambda: apply_plan_planar(psi0, compile_circuit(c, pair=False)))
    say(f"[{mode}] unpaired body: norm {float(planar_norm(out)):.8f}, rel "
        f"L2 vs f32 {rel_l2(out, f32['unpaired']):.3e}")
    del out
    gates_d, plan_d, run_density, rho0 = density_runner(device)
    # one body against the plain versions in the mode.  bf16_3x: each
    # launch within its pair limit, and a unitary step carries an earlier
    # difference on unchanged, so the body within their sum.  bf16: a
    # difference anywhere moves later bf16 roundings, each by 2^-8, so two
    # runs of a body drift apart to the mode's own error: its float64 limit
    one, launches_one = _launch_delta(
        lambda: make_planar_density_runner(plan_d)(rho0))
    rel_one, _ = compare(f"[{mode}] density one body", one,
                         apply_plan_density_planar_ref(rho0, plan_d),
                         sum(launches_one.values()) * LIMITS[mode][1]
                         if mode == "bf16_3x" else LIMITS[mode][2])
    del one
    rho, runs["density"] = _launch_delta(lambda: run_density(rho0))
    trace = float(torch.sum(torch.diagonal(rho[0])))
    if mode == "bf16_3x" and not abs(trace - 1.0) <= DENSITY_TRACE_TOL:
        raise AssertionError(f"[{mode}] density: trace {trace}")
    say(f"[{mode}] density {DENSITY_N}q x {DENSITY_LAYERS} layers x "
        f"{DENSITY_REPEATS} ({gates_d} gates): one body rel L2 vs plain "
        f"{rel_one:.3e} ({sum(launches_one.values())} launches), trace "
        f"{trace:.8f}")
    del rho

    def examples():
        for path in sorted((ROOT / "examples").glob("*.qb")):
            if path.name in ("probabilistic_branching.qb",
                             "mid_measurement.qb"):
                continue
            rc, got = _capture(cli_main, [
                str(path), "--compile", "--precision", mode, "--device",
                str(torch.device(device).type)])
            if rc != 0:
                raise AssertionError(f"[{mode}] {path.name}: rc {rc}\n"
                                     f"{got}")
            _same_readout(f"[{mode}] {path.name}", got,
                          _capture(executeTxt, path.read_text())[1],
                          MODE_READOUT_TOL[mode])
            say(f"[{mode}] example {path.name} --compile --precision "
                f"{mode}: readout within {MODE_READOUT_TOL[mode]:g} of the "
                f"dense interpreter")
    _, runs["examples"] = _launch_delta(examples)
    return runs


# ---------------------------------------------------------------------------
# phase 8: the narrow pairs on the main path
# ---------------------------------------------------------------------------

def narrow_pairs(plan) -> list[tuple[int, int, int]]:
    """(start, width1, width2) of the plan's narrow pairs (D1 = 2, 4 with
    D2 >= 8)."""
    return [(s.first.start, s.first.width, s.second.width)
            for s in plan.steps if hasattr(s, "second")
            and s.first.width <= 2 and s.second.width >= 3]


def runs_limit(mode: str, launches: int) -> float:
    """The relative L2 limit between two runs of a circuit in dot ``mode``
    that make ``launches`` launches between them: f32 KERNEL_TOL (phase
    5); bf16_3x and bf16, each launch within the mode's float64 limit of
    the exact product and a unitary step carrying an earlier difference on
    unchanged, the sum of their limits (in bf16 a difference anywhere moves
    later bf16 roundings by 2^-8, so two runs drift apart to the mode's own
    error)."""
    if mode == "f32":
        return KERNEL_TOL
    return launches * LIMITS[mode][2]


def counter(name: str, mode: str) -> str:
    """The launch count name of kernel ``name`` in dot ``mode``."""
    return name if mode == "f32" else f"{name}[{mode}]"


def hold_plans(n: int, c: Circuit, paired, unpaired, device, mode: str,
               against_plain: bool = True) -> tuple[dict, str]:
    """One run of circuit ``c``'s paired plan and one of its unpaired plan
    in dot ``mode`` (set by the caller), each timed after a warm-up: the
    paired state against the unpaired one within ``runs_limit``, and (when
    ``against_plain``) against the same plan through the plain versions
    (f32 within KERNEL_TOL, bf16_3x within its launches' pair limits as
    phase 7 holds a density body, bf16 within ``runs_limit``); the norm
    within NORM_TOL of 1 (bf16's rounded W are not unitary: printed).
    Returns the paired run's launches and a line that reports both runs."""
    psi0 = product_state_planar([np.array([1.0, 0.0])] * n, device)
    out, elapsed, span, launches = timed_run(
        lambda: apply_plan_planar(psi0, paired), device)
    alone, _, alone_span, launches_u = timed_run(
        lambda: apply_plan_planar(psi0, unpaired), device)
    between = sum(launches.values()) + sum(launches_u.values())
    rel_u = rel_l2(out, alone)
    norm = float(planar_norm(out))
    del alone

    def device_ms(ms):
        return "not measured" if ms is None else f"{ms:.3f} ms"
    line = (f"paired {elapsed:.4f} s ({c.gate_count / elapsed:.1f} gates/s, "
            f"device {device_ms(span)}), unpaired device "
            f"{device_ms(alone_span)}; norm {norm:.8f}, paired vs unpaired "
            f"rel L2 {rel_u:.3e}")
    if mode != "bf16" and not abs(norm - 1.0) <= NORM_TOL:
        raise AssertionError(f"[{mode}] brickwork {n}q: norm {norm}")
    if against_plain:
        plain = (KERNEL_TOL if mode == "f32" else
                 sum(launches.values()) * LIMITS[mode][1]
                 if mode == "bf16_3x" else
                 runs_limit(mode, 2 * sum(launches.values())))
        rel, _ = compare(f"[{mode}] brickwork {n}q vs plain", out,
                         apply_plan_planar_ref(psi0, paired), plain)
        line += f", vs plain {rel:.3e}"
    if not rel_u <= runs_limit(mode, between):
        raise AssertionError(f"[{mode}] brickwork {n}q: paired vs "
                             f"unpaired rel L2 {rel_u:.3e}")
    return launches, line


def bf16x3_drift(n: int, device, plain: bool = False) -> tuple[float, dict]:
    """((1 - norm) per 100 gates, launches) of the brickwork body x 16 on
    the scanned runner in bf16_3x (set by the caller), or of the same 256
    layers through the plain versions (``plain``)."""
    c = brickwork_circuit(n, BRICKWORK_LAYERS)
    repeats = DRIFT_LAYERS // BRICKWORK_LAYERS
    body = compile_circuit(c)
    psi = product_state_planar([np.array([1.0, 0.0])] * n, device)
    if plain:
        for _ in range(repeats):
            psi = apply_plan_planar_ref(psi, body)
        launches = {}
    else:
        psi, launches = _launch_delta(
            lambda: make_scanned_planar_runner(body, repeats)(psi))
    norm = float(torch.sum(torch.square(psi), dtype=torch.float64))
    return (1.0 - norm) / (c.gate_count * repeats / 100), launches


def narrow_path(device, mode: str) -> dict:
    """The brickwork of 16 layers at n = 1, 2 (mod 7) in dot ``mode`` (set
    by the caller): at 8, 9, 22 and 23 qubits paired, its state against the
    same plan through the plain versions (f32 within KERNEL_TOL, bf16_3x
    within its launches' pair limits as phase 7 holds a density body,
    bf16 within ``runs_limit``) and against the unpaired plan (within
    ``runs_limit``); at 23 qubits the 256-layer drift, f32 paired and
    unpaired as phase 5 holds it, bf16_3x on the scanned runner at most
    BF16X3_DRIFT_TOL per 100 gates, and at 22 qubits within
    SPLIT_DRIFT_MARGIN of the plain versions' drift; at 29 and 30 qubits
    one body paired and unpaired, timed, its norm within NORM_TOL of 1
    (bf16's rounded W are not unitary: printed) and paired against unpaired
    within ``runs_limit`` (``hold_plans``), and their launches of the D <= 4
    window.  Returns the launches of each run."""
    runs = {}
    for n in NARROW_QUBITS + LARGE_QUBITS:
        c = brickwork_circuit(n, BRICKWORK_LAYERS)
        paired, unpaired = compile_circuit(c), compile_circuit(c, pair=False)
        pairs = narrow_pairs(paired)
        if not pairs:
            raise AssertionError(f"brickwork {n}q: no narrow pair in "
                                 f"{paired.steps}")
        launches, line = hold_plans(n, c, paired, unpaired, device, mode,
                                    against_plain=n not in LARGE_QUBITS)
        runs[f"brickwork_{n}q"] = launches
        narrow_windows = launches.get(counter("window_apply_stream", mode),
                                      0)
        say(f"[{mode}] brickwork {n}q x {BRICKWORK_LAYERS} layers, narrow "
            f"pairs {sorted(set(pairs))}, {narrow_windows} D <= 4 windows: "
            f"{line}; launches {launches}")
    if mode == "f32":
        brickwork_drift(NARROW_DRIFT_QUBITS, DRIFT_LAYERS, device)
    elif mode == "bf16_3x":
        for n in (SPLIT_DRIFT_QUBITS, NARROW_DRIFT_QUBITS):
            drift, runs[f"scanned_{n}q"] = bf16x3_drift(n, device)
            if n == SPLIT_DRIFT_QUBITS:
                plain, _ = bf16x3_drift(n, device, plain=True)
                limit = (1 + SPLIT_DRIFT_MARGIN) * abs(plain)
                against = f" (plain versions {plain:.4e}, limit {limit:.4e})"
            else:
                limit = BF16X3_DRIFT_TOL
                against = f" (limit {limit:g})"
            say(f"[{mode}] brickwork {n}q x {BRICKWORK_LAYERS} layers x "
                f"{DRIFT_LAYERS // BRICKWORK_LAYERS} (scanned): drift "
                f"{drift:.4e} per 100 gates{against}")
            if not abs(drift) <= limit:
                raise AssertionError(f"[{mode}] {n}q norm drift {drift:.4e} "
                                     f"per 100 gates > {limit:.4e}")
    return runs


# ---------------------------------------------------------------------------
# phase 9: the streaming kernels on the main path
# ---------------------------------------------------------------------------

def stream_path(device, mode: str) -> dict:
    """The 26-qubit brickwork of 16 layers compiled at each of
    STREAM_WINDOWS in dot ``mode`` (set by the caller), paired (the D1, D2
    <= 4 pairs on the streaming pair, the D = 4 windows of ``window=2`` on
    the streaming window) against the plain versions and the unpaired plan,
    timed (``hold_plans``).  Returns the launches of each run."""
    runs = {}
    c = brickwork_circuit(N, BRICKWORK_LAYERS)
    for window in STREAM_WINDOWS:
        paired = compile_circuit(c, window=window)
        unpaired = compile_circuit(c, window=window, pair=False)
        launches, line = hold_plans(N, c, paired, unpaired, device, mode)
        runs[f"brickwork_window{window}"] = launches
        say(f"[{mode}] brickwork {N}q x {BRICKWORK_LAYERS} layers at "
            f"window={window}: {len(paired.steps)} passes, "
            f"{launches.get(counter('pair_apply_stream', mode), 0)} "
            f"streaming pairs, "
            f"{launches.get(counter('window_apply_stream', mode), 0)} "
            f"streaming windows; {line}; launches {launches}")
    return runs


# ---------------------------------------------------------------------------
# --profile: where the time goes in phases 4 and 5
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 10: the device ensemble (mid-circuit measurement, SMC) and the
# kernels' particle axis
# ---------------------------------------------------------------------------

BATCH = 3                  # particles of the bit-for-bit launches
BATCH_TIMED = 32           # particles of the timed launches (bench.py's SMC)
BATCH_TIMED_QUBITS = 24
SMC_QUBITS = 24            # bench.py:396-470: 24 qubits, 32 particles,
SMC_PARTICLES = 32         # 4 collapse events
SMC_RUNS = 3               # the first, then the warm runs
SMC_SUM_TOL = 1e-3         # bench.py's own check: each result sums to 1
ENSEMBLE_TOL = 1e-5        # deterministic readouts, kernels vs plain
GROVER_SMC_QUBITS = 20
GROVER_SMC_REPEATS = 4
GROVER_SMC_PARTICLES = 8
# the f32 kernels phase 10's runs launch: the SMC program's windows and
# trailing pair, the Grover body's reflections, the examples' trailing and
# streaming windows
PHASE10_KERNELS = ("window_apply", "window_apply_trailing",
                   "window_apply_stream", "pair_apply_trailing",
                   "reflect_dot", "reflect_update")


def batch_geometries(n: int) -> dict:
    """Launch count name -> the window (start, width) or pair (start,
    width1, width2) of phase 2's shapes at ``n`` qubits that reaches it."""
    return {"window_apply": (n - 21, 7), "window_apply_trailing": (n - 7, 7),
            "window_apply_stream": (n - 9, 2),
            "pair_apply": (0, 5, 7), "pair_apply_trailing": (n - 14, 7, 7),
            "pair_apply_narrow": (0, 2, 7),
            "pair_apply_trailing_narrow": (n - 9, 2, 7),
            "pair_apply_stream": (3, 2, 2)}


def _batch_diag(n: int, start: int, width: int, rng, device):
    """3 flips and 2 phases, on bits of a, of the window and of b."""
    qubits = sorted({max(start - 1, 0), start, start + width - 1, n - 1})
    phases = ((tuple(qubits), complex(np.exp(0.7j)), 0b0101 % 2**len(qubits)),
              ((start,), complex(np.exp(-1.3j)), -1))
    flips = tuple(int(m) for m in rng.integers(0, 2**n, size=3))
    return kernels.fused_diagonals(n, flips, phases, device)


def _launcher(name: str, n: int, rng, device):
    """(fn(state or batch, particle) launching ``name``'s kernel, its plain
    version, the geometry, the bytes of its matrices)."""
    geom = batch_geometries(n)[name]
    diag = _batch_diag(n, geom[0], sum(geom[1:]), rng, device)
    if len(geom) == 2:
        start, w = geom
        wt = _planar_unitary(2**w, rng, device)
        return (lambda x, p=None: kernels.window_apply(x, n, start, w, wt,
                                                       diag),
                lambda x: kernels.window_apply_ref(x, n, start, w, wt, diag),
                geom, wt.nbytes)
    start, w1, w2 = geom
    u1, u2 = (_planar_unitary(2**w, rng, device) for w in (w1, w2))
    return (lambda x, p=None: kernels.pair_apply(x, n, start, w1, w2, u1, u2,
                                                 diag),
            lambda x: kernels.pair_apply_ref(x, n, start, w1, w2, u1, u2,
                                             diag),
            geom, u1.nbytes + u2.nbytes)


def _reflect_launchers(n: int, P: int, rng, device):
    """((H, T, table bytes), {name: (fn(a (P, 2, H, T) batch, or particle
    p's (2, H, T) view with p), plain version)}) of the two reflections at
    the Grover geometry, one c a particle."""
    T = 2 ** min(7, n - 1)
    H = 2**n // T

    def unit(d):
        v = rng.normal(size=d) + 1j * rng.normal(size=d)
        v /= np.linalg.norm(v)
        return torch.from_numpy(np.stack([v.real, v.imag]).astype(
            np.float32)).to(device)

    a, b = unit(H).reshape(2, H, 1), unit(T).reshape(2, 1, T)
    c = torch.tensor(rng.normal(size=(P, 2)) * 2.0**(-n / 2),
                     dtype=torch.float32, device=device)
    flips = torch.tensor(rng.integers(0, 2**n, size=2), dtype=torch.int64,
                         device=device)

    return (H, T, a.nbytes + b.nbytes), {
        "reflect_dot": (lambda x, p=None: kernels.reflect_dot(x, a, b),
                        lambda x: kernels.reflect_dot_ref(x, a, b)),
        "reflect_update": (
            lambda x, p=None: kernels.reflect_update(
                x, c if p is None else c[p], a, b, flips),
            lambda x: kernels.reflect_update_ref(x, c, a, b, flips))}


def _flat(out):
    """A reflection's (out, D) or a window's output, as one tensor list."""
    return list(out) if isinstance(out, tuple) else [out]


def _batch_random(n: int, P: int, gen, device, view=None):
    psi = torch.randn((P, 2, 2**n), generator=gen, device=device)
    psi = psi / torch.sqrt(torch.sum(psi * psi, dim=(1, 2), keepdim=True))
    return psi if view is None else psi.reshape(P, 2, *view)


def check_particle_axis(n: int, device, rng, gen, mode: str) -> dict:
    """Every launcher at phase 2's ``n``-qubit shapes on a batch of BATCH
    states, in dot ``mode`` (set by the caller; the reflections in f32
    only, which have no mode): one launch for the batch, each particle the
    bits of its own launch, the batch within LIMITS of the plain version
    on the batch.  Returns {launch count name: result}."""
    results = {}
    window_tol, pair_tol, _ = LIMITS[mode]
    cases = {}
    for name in batch_geometries(n):
        fn, plain, geom, _ = _launcher(name, n, rng, device)
        cases[name] = (fn, plain, geom, window_tol if len(geom) == 2
                       else pair_tol, None)
    if mode == "f32":
        (H, T, _), refl = _reflect_launchers(n, BATCH, rng, device)
        for name, (fn, plain) in refl.items():
            cases[name] = (fn, plain, (H, T), KERNEL_TOL, (H, T))
    for name, (fn, plain, geom, tol, view) in cases.items():
        psi = _batch_random(n, BATCH, gen, device, view)
        singles = [_flat(fn(psi[p], p)) for p in range(BATCH)]
        got, launches = _launch_delta(lambda: _flat(fn(psi)))
        key = counter(name, mode) if "reflect" not in name else name
        if launches != {key: 1}:
            raise AssertionError(f"{key}: a batch of {BATCH} launched "
                                 f"{launches}, not one {key}")
        for p in range(BATCH):
            for g, s in zip(got, singles[p]):
                if not torch.equal(g[p], s):
                    raise AssertionError(f"{key}: particle {p} of the batch "
                                         f"differs from its own launch")
        rel = max_abs = 0.0
        for g, w in zip(got, _flat(plain(psi))):
            r, m = compare(f"{key} batch of {BATCH}", g, w, tol)
            rel, max_abs = max(rel, r), max(max_abs, m)
        del got, singles
        results[key] = {"geometry": list(geom), "n": n, "particles": BATCH,
                        "bit_for_bit": True, "rel_l2": rel,
                        "max_abs_err": max_abs}
        say(f"{key} particle axis: {n}q {tuple(geom)}, a batch of {BATCH} "
            f"in one launch, each particle bit for bit its own launch; rel "
            f"L2 vs plain {rel:.3e}, max abs {max_abs:.3e}")
    return results


def time_particle_axis(n: int, device, rng, gen, mode: str,
                       results: dict) -> None:
    """One launch for BATCH_TIMED states at ``n`` qubits against
    BATCH_TIMED single launches, in turns, with the batch's bound; into
    ``results``."""
    cases = {}
    for name in batch_geometries(n):
        fn, _, geom, w_bytes = _launcher(name, n, rng, device)
        d1 = 2 ** geom[1]
        d2 = 2 ** geom[2] if len(geom) == 3 else 0
        cases[name] = (fn, None, w_bytes, d1, d2)
    if mode == "f32":
        (H, T, tables), refl = _reflect_launchers(n, BATCH_TIMED, rng,
                                                  device)
        for name, (fn, _) in refl.items():
            cases[name] = (fn, (H, T), tables, 0, 0)
    for name, (fn, view, w_bytes, d1, d2) in cases.items():
        psi = _batch_random(n, BATCH_TIMED, gen, device, view)
        batched_ms, singles_ms = timed_in_turns(
            [lambda: fn(psi),
             lambda: [fn(psi[p], p) for p in range(BATCH_TIMED)]], device)
        amps = BATCH_TIMED * 2**n
        # a reflection writes each particle's float64 (2, T) D
        d_bytes = 16 * BATCH_TIMED * view[1] if view else 0
        if name == "reflect_dot":
            bnd = bound(psi.nbytes + w_bytes + d_bytes, fp32_flops=8 * amps)
        elif name == "reflect_update":
            bnd = bound(2 * psi.nbytes + w_bytes + d_bytes,
                        fp32_flops=16 * amps)
        elif d2:
            bnd = pair_bound(2 * psi.nbytes + w_bytes, amps, d1, d2, mode)
        else:
            bnd = product_bound(2 * psi.nbytes + w_bytes, 8 * d1 * amps,
                                mode, d1 >= 8)
        del psi
        key = counter(name, mode) if "reflect" not in name else name
        results[key].update({"timed_n": n, "timed_particles": BATCH_TIMED,
                             "ms": batched_ms, "singles_ms": singles_ms,
                             "bound_ms": bnd[0], "bound_by": bnd[1]})
        say(f"{key} particle axis: {n}q x {BATCH_TIMED} particles, one "
            f"launch {batched_ms:.4f} ms, {BATCH_TIMED} single launches "
            f"{singles_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, share "
            f"{bnd[0] / batched_ms:.3f})")


def smc_program(n: int) -> str:
    """``bench.py``'s SMC workload (``bench.py:421-436``, the benchmark's
    ``portbench.families.smc_program``): layers of Hadamards and CX on
    every third qubit around three measurements and a disc (4 collapse
    events)."""
    return smc_family.smc_program(n)[0]


@contextlib.contextmanager
def plain_versions():
    """The ensemble executor's plans through the kernels' plain versions
    (on the same device): the reference of a kernel run."""
    from qbot_tpu_torch.inference import ensemble_exec
    from qbot_tpu_torch.tpu import planar

    ensemble_exec.apply_plan_planar = planar.apply_plan_planar_ref
    try:
        yield
    finally:
        ensemble_exec.apply_plan_planar = planar.apply_plan_planar


def _ensemble_run(src: str, device, sample: int, plain: bool = False):
    """(results {name: probs}, final ensemble's particles and lost mass,
    host seconds, peak device bytes, launches) of one run_lowered_ensemble
    of ``src``."""
    import warnings

    from qbot_tpu_torch import run_lowered_ensemble

    lp = lower_program(src, mid_measure=True)
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(plain_versions())
        stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("ignore", RuntimeWarning)
        t0 = time.perf_counter()
        (res, ens), launches = _launch_delta(
            lambda: run_lowered_ensemble(lp, sample=sample, seed=0,
                                         device=device))
        elapsed = time.perf_counter() - t0
    if plain and launches:
        raise AssertionError(f"the plain versions' run launched {launches}")
    probs = {k: np.asarray(v.probs) for k, v in res.items()}
    return (probs, (ens.num_particles, float(ens.lost_mass)), elapsed,
            torch.cuda.max_memory_allocated(), launches)


def _results_within(label: str, got: dict, want: dict, names,
                    tol: float = ENSEMBLE_TOL) -> float:
    err = max(float(np.max(np.abs(got[k] - want[k]))) for k in names)
    if not err <= tol:
        raise AssertionError(f"{label}: readouts off the plain versions' by "
                             f"{err:.3e} > {tol:g}")
    return err


def smc_path(device, card: str) -> tuple[dict, dict, dict]:
    """``bench.py``'s SMC program at SMC_QUBITS through
    run_lowered_ensemble(sample=SMC_PARTICLES, seed=0), SMC_RUNS times, and
    once through the plain versions: each result sums to 1 within 1e-3;
    ``a``, drawn before any sampling, within 1e-5 of the plain versions'.
    Then the exact fan-out of the same program, every result within 1e-5 of
    the plain versions'.  Returns ({run: launches}, numbers, the exact
    fan-out's results)."""
    src = smc_program(SMC_QUBITS)
    walls, runs = [], {}
    for i in range(SMC_RUNS):
        probs, (parts, lost), wall, peak, launches = _ensemble_run(
            src, device, SMC_PARTICLES)
        walls.append(wall)
        if i == 0:
            runs["smc_24q"] = launches
    for name, p in probs.items():
        if abs(float(np.sum(p)) - 1.0) > SMC_SUM_TOL:
            raise AssertionError(f"SMC: {name} sums to {np.sum(p)}")
    plain, *_ = _ensemble_run(src, device, SMC_PARTICLES, plain=True)
    err = _results_within("SMC", probs, plain, ["a"])
    warm = min(walls[1:])
    numbers = {"smc_wall_s": warm, "smc_first_run_s": walls[0],
               "smc_samples_per_s": SMC_PARTICLES / warm,
               "smc_peak_bytes": peak}
    say(f"SMC {SMC_QUBITS}q x {SMC_PARTICLES} particles (bench.py's "
        f"program, 4 collapse events): warm wall {warm:.4f} s (first run "
        f"{walls[0]:.4f} s), {SMC_PARTICLES / warm:.2f} samples/s, peak "
        f"{peak / 2**30:.3f} GiB allocated; a within {err:.1e} of the "
        f"plain versions; readouts { {k: v.tolist() for k, v in probs.items()} }; "
        f"launches {runs['smc_24q']} ({card})")

    exact, (parts, lost), wall, peak, launches = _ensemble_run(src, device,
                                                               0)
    runs["exact_24q"] = launches
    want, (w_parts, w_lost), *_ = _ensemble_run(src, device, 0, plain=True)
    err = _results_within("exact fan-out", exact, want, list(want))
    if parts != w_parts or abs(lost - w_lost) > ENSEMBLE_TOL:
        raise AssertionError(f"exact fan-out: {parts} particles, lost "
                             f"{lost} against {w_parts}, {w_lost}")
    numbers.update({"exact_wall_s": wall, "exact_peak_bytes": peak,
                    "exact_particles": parts, "exact_lost_mass": lost})
    say(f"exact fan-out {SMC_QUBITS}q: {parts} particles at the end, "
        f"lost_mass {lost:.6e}, every readout within {err:.1e} of the "
        f"plain versions; {wall:.4f} s, peak {peak / 2**30:.3f} GiB "
        f"allocated; launches {launches} ({card})")
    return runs, numbers, exact


def grover_smc(device) -> dict:
    """A GROVER_SMC_QUBITS-qubit Grover init and GROVER_SMC_REPEATS bodies
    (one ReflectStep each, under the particle axis) on a sampled ensemble
    of GROVER_SMC_PARTICLES, then a measurement of qubits 0 and 1: the
    pre-sampling distribution and the state before it within KERNEL_TOL of
    the plain versions'.  Returns its launches."""
    from qbot_tpu_torch.inference import ensemble_exec as ee

    n = GROVER_SMC_QUBITS
    marked, init, body = grover_circuits(n)
    init_plan, body_plan = compile_circuit(init), compile_circuit(body)
    if [type(s).__name__ for s in body_plan.steps] != ["ReflectStep"]:
        raise AssertionError(f"Grover body compiled to {body_plan.steps}")

    def run():
        ens = ee.init_product_ensemble([np.array([1.0, 0.0])] * n,
                                       B=GROVER_SMC_PARTICLES, device=device)
        ens = ee.apply_plan_ensemble(ens, init_plan)
        for _ in range(GROVER_SMC_REPEATS):
            ens = ee.apply_plan_ensemble(ens, body_plan)
        gen = torch.Generator(device=device).manual_seed(0)
        return ens.psi, ee.measure_sample(gen, ens, n, [0, 1])[1]

    (psi, dist), launches = _launch_delta(run)
    with plain_versions():
        (psi_ref, dist_ref), plain_launches = _launch_delta(run)
    if plain_launches:
        raise AssertionError(f"the plain versions' run launched "
                             f"{plain_launches}")
    rel, _ = compare("Grover SMC state", psi, psi_ref)
    err = float(torch.max(torch.abs(dist - dist_ref)))
    if not err <= ENSEMBLE_TOL:
        raise AssertionError(f"Grover SMC: distribution off by {err:.3e}")
    say(f"Grover {n}q x {GROVER_SMC_REPEATS} bodies on {GROVER_SMC_PARTICLES}"
        f" particles, then meas [0, 1] sampled: distribution "
        f"{dist.tolist()} within {err:.1e} of the plain versions, state rel "
        f"L2 {rel:.3e}; launches {launches}")
    return launches


def ensemble_examples(device) -> dict:
    """Every example through ``python -m qbot_tpu_torch FILE --compile
    --ensemble`` on the card, against the port's own ``--device cpu``
    output (readouts within 1e-6, the same stderr line).  Returns their
    launches."""
    total: dict = {}
    card = torch.device(device).type
    for path in sorted((ROOT / "examples").glob("*.qb")):
        outs = {}
        for dev in (card, "cpu"):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                (rc, out), launches = _launch_delta(lambda: _capture(
                    cli_main, [str(path), "--compile", "--ensemble",
                               "--device", dev]))
            if rc != 0:
                raise AssertionError(f"{path.name} --compile --ensemble "
                                     f"--device {dev}: rc {rc}")
            outs[dev] = (out, err.getvalue().strip())
            if dev == card:
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
        _same_readout(f"{path.name} --compile --ensemble", outs[card][0],
                      outs["cpu"][0])
        if outs[card][1] != outs["cpu"][1]:
            raise AssertionError(f"{path.name}: {outs[card][1]} against "
                                 f"{outs['cpu'][1]}")
        say(f"example {path.name} --compile --ensemble: the card's readout "
            f"matches --device cpu ({outs[card][1]})")
    return total


# ---------------------------------------------------------------------------
# phase 11: gradients through the kernels, and HMC/NUTS over gate angles
# ---------------------------------------------------------------------------

HMC_QUBITS = 24            # benchmarks/smc_bench.py: parameterized_layers(24,
HMC_DEPTH = 4              # 4), 96 angles, 64 counts at outcome 0 and 32 at
HMC_COUNTS = {0: 64.0, 1: 32.0}        # outcome 1 over all qubits (:47)
HMC_STEP = 0.05            # smc_bench.py:66-72: step 0.05, 5 leapfrogs,
HMC_LEAPFROG = 5           # θ0 = linspace(0.1, 1.0) over chains x angles
HMC_CHAINS = 4
HMC_SAMPLES = 8
NUTS_WARMUP = 4
NUTS_SAMPLES = 4
NUTS_DEPTH = 4
GRAD_GROVER_QUBITS = 20
COMPLEX_DEPTH = 2          # complex_ansatz(24, 2): 96 angles, as the ansatz
# dot mode -> (value relative, gradient relative L2) of the log-prob through
# the kernels against the plain versions' autograd in the mode.  f32: the
# kernels' products are the plain versions' (phase 2: KERNEL_TOL a launch):
# 1e-5 and 1e-4.  The reduced modes from this phase's readings over the
# four plans (H100 80GB HBM3, 700 W), with the headroom stated.  A reduced
# backward rounds W† and the cotangent to bf16 before its product, where
# the plain versions' autograd rounds the product's result, so the two
# gradients differ on the CPU too.  bf16_3x read values 8.5e-7-1.32e-5 and
# gradients 1.11-2.38e-5: 1e-4 (7.6x) and 1e-4 (4.2x); bf16 read values
# 0-8.0e-8 and gradients 2.88-8.61e-3: 1e-6 (12x) and 3e-2 (3.5x)
GRAD_LIMITS = {"f32": (1e-5, 1e-4), "bf16_3x": (1e-4, 1e-4),
               "bf16": (1e-6, 3e-2)}
SIM_GRAD_TOL = {"rtol": 2e-3, "atol": 1e-3}   # tests/test_inference.py's
GRAD_KERNELS = ("window_apply", "window_apply_trailing", "pair_apply",
                "pair_apply_trailing")


def hmc_ansatz(device):
    """(circuit, {label: plan} paired and unpaired, counts, θ0 (chains,
    angles)) of smc_bench.py's posterior."""
    from qbot_tpu_torch.tpu.circuit import parameterized_layers

    circ = parameterized_layers(HMC_QUBITS, HMC_DEPTH)
    counts = np.zeros(2**HMC_QUBITS, np.float32)
    for k, v in HMC_COUNTS.items():
        counts[k] = v
    plans = {"paired": compile_circuit(circ),
             "unpaired": compile_circuit(circ, pair=False)}
    theta0 = torch.linspace(0.1, 1.0, HMC_CHAINS * circ.num_params,
                            device=device).reshape(HMC_CHAINS, -1)
    return circ, plans, counts, theta0


def complex_ansatz(n: int, depth: int) -> Circuit:
    """RX and RZ angles on every qubit (complex parameterised windows), then
    controlled phases e^{0.7i} on neighbours (those across two windows
    fuse into the next window as phases) and a phase flip (fused as a
    flip), ``depth`` times: 4n angles at depth 2."""
    cphase = np.array([1, 1, 1, np.exp(0.7j)])
    c, k = Circuit(n), 0
    for layer in range(depth):
        for q in range(n):
            c.prx(q, k)
            c.prz(q, k + 1)
            k += 2
        for q in range(layer % 2, n - 1, 2):
            c.diagonal(cphase, [q, q + 1])
        c.phase_flip((2**n) // 3 + layer)
    return c


def complex_plans() -> dict:
    """{label: plan} of the complex ansatz, paired and unpaired; each fuses
    phases and a flip into a window with angles, and the paired plan
    phases into a pair."""
    from qbot_tpu_torch.tpu.compiler import PairStep

    circ = complex_ansatz(HMC_QUBITS, COMPLEX_DEPTH)
    plans = {}
    for label, pair in (("complex paired", True),
                        ("complex unpaired", False)):
        plan = compile_circuit(circ, pair=pair)
        windows = [w for st in plan.steps
                   for w in ((st.first, st.second)
                             if isinstance(st, PairStep) else (st,))
                   if hasattr(w, "pre_phases")]
        angled = [w for w in windows
                  if any(t.matrix is None for t in w.terms)]
        if not (any(w.pre_flips for w in angled)
                and any(w.pre_phases for w in angled)
                and (not pair or any(
                    st.first.pre_phases or st.second.pre_phases
                    for st in plan.steps if isinstance(st, PairStep)))):
            raise AssertionError(f"{label}: no fused phase or flip on an "
                                 f"angled window: {plan.steps}")
        plans[label] = plan
    return plans


def plain_log_prob(plan, counts, device):
    """The planar posterior through the kernels' plain versions and
    PyTorch's own autograd: the reference of a gradient through the
    kernels."""
    from qbot_tpu_torch.inference import hmc

    def probs_of(theta):
        psi = apply_plan_planar_ref(zero_state_planar(plan.n, device), plan,
                                    theta)
        return planar_probs(psi, None, plan.n)
    return hmc._posterior(probs_of, counts, 10.0, device, torch.float32)


def first_step_launches(plan, theta, device) -> dict:
    """Launches of a plan's first step alone: its input, |0⟩, needs no
    cotangent, so its kernel runs once in a value-and-gradient."""
    from qbot_tpu_torch.tpu.compiler import Plan

    first = Plan(plan.n, plan.window, plan.steps[:1], plan.num_params)
    return _launch_delta(lambda: apply_plan_planar(
        zero_state_planar(plan.n, device), first, theta))[1]


def check_gradient(label: str, plan, lp, plain, theta, device,
                   mode: str) -> tuple[torch.Tensor, dict]:
    """The value and gradient of ``lp`` at ``theta`` through the kernels
    against ``plain``'s (GRAD_LIMITS); every step after the first launches
    its kernel once more in the backward, W† in the current mode.  Returns
    (gradient, backward launches)."""
    from qbot_tpu_torch.inference import hmc

    _, forward = _launch_delta(lambda: lp(theta))
    (value, grad), both = _launch_delta(
        lambda: hmc.value_and_grad(lp)(theta))
    first = first_step_launches(plan, theta, device)
    want = {k: 2 * v - first.get(k, 0) for k, v in forward.items()}
    if both != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{label}: forward {forward}, first step "
                             f"{first}, value-and-gradient {both}")
    want_v, want_g = hmc.value_and_grad(plain)(theta)
    value_tol, grad_tol = GRAD_LIMITS[mode]
    rel_v = abs(float(value) - float(want_v)) / abs(float(want_v))
    rel_g = rel_l2(grad, want_g)
    if not (rel_v <= value_tol and rel_g <= grad_tol
            and torch.isfinite(grad).all()):
        raise AssertionError(f"{label} [{mode}]: value {float(value)} vs "
                             f"{float(want_v)} (rel {rel_v:.3e}), gradient "
                             f"rel L2 {rel_g:.3e} > {grad_tol:g}")
    backward = {k: both[k] - forward.get(k, 0) for k in both}
    say(f"gradient {label} [{mode}]: value {float(value):.6f} (rel "
        f"{rel_v:.3e} of the plain versions), gradient rel L2 {rel_g:.3e} "
        f"(limit {grad_tol:g}), |g| "
        f"{float(torch.linalg.vector_norm(grad)):.4f}; launches forward "
        f"{forward}, backward {backward}")
    return grad, backward


def grover_loss(n: int, marked: int) -> Circuit:
    """tests/test_inference.py:180-213 at ``n`` qubits: an RY on every
    qubit, then one Grover body, which compiles to a ReflectStep."""
    H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    c = Circuit(n)
    for q in range(n):
        c.pry(q, q)
    for q in range(n):
        c.gate(H, [q])
    c.phase_flip(marked)
    for q in range(n):
        c.gate(H, [q])
    c.phase_flip(0)
    for q in range(n):
        c.gate(H, [q])
    return c


def time_value_and_grad(lp, theta, device) -> dict:
    """Wall and device milliseconds (CUDA events around the run) of one
    forward and of one value-and-gradient, each after a warm-up."""
    from qbot_tpu_torch.inference import hmc

    out = {}
    for label, fn in (("forward", lambda: lp(theta)),
                      ("value_and_grad",
                       lambda: hmc.value_and_grad(lp)(theta))):
        _, wall, device_ms, _ = timed_run(fn, device)
        out[f"{label}_wall_ms"] = wall * 1e3
        out[f"{label}_device_ms"] = device_ms
    return out


def backward_parts(plan, device) -> list:
    """For each distinct window and pair geometry of ``plan`` at its
    shapes: ms of the forward launch, of the backward's W† launch, of its
    matrix-cotangent products (one float32 GEMM of the stacked planes; a
    pair's intermediates Z = W2·y and V = W1·y too) and of the forward and
    backward through autograd, timed in turns, with the forward launch's
    bound and the launches a gradient makes of it."""
    from qbot_tpu_torch.tpu.compiler import PairStep

    n, gen = plan.n, torch.Generator(device=device).manual_seed(11)
    rng = np.random.default_rng(11)
    psi = _random_state(n, gen, device)
    cot = _random_state(n, gen, device)
    none = kernels.fused_diagonals(n, device=device)
    rows, seen = [], {}
    for i, step in enumerate(plan.steps):
        pair = isinstance(step, PairStep)
        if pair:
            start, w1, w2 = (step.first.start, step.first.width,
                             step.second.width)
            key = ("pair", start, w1, w2)
        else:
            start, w1, w2 = step.start, step.width, 0
            key = ("window", start, w1)
        seen.setdefault(key, [0, 0])
        seen[key][0] += 1
        seen[key][1] += 1 if i else 0
        if seen[key][0] > 1:
            continue
        ws = [_planar_unitary(2**w, rng, device) for w in (w1, w2) if w]
        adj = [kernels._adjoint(w) for w in ws]
        split = ((2**start, 2**w1, 2**w2, -1) if pair
                 else (2**start, 2**w1, -1))
        if pair:
            def launch(x, m):
                return kernels.pair_apply(x, n, start, w1, w2, *m, none)

            def cotangents():
                z = kernels.window_apply_ref(psi, n, start + w1, w2, ws[1],
                                             none, mode="f32")
                v = kernels.window_apply_ref(psi, n, start, w1, ws[0], none,
                                             mode="f32")
                return (kernels._matrix_cotangent(cot, z, split, 1),
                        kernels._matrix_cotangent(cot, v, split, 2))
            nbytes = 2 * psi.numel() * 4
            bound_ms, bound_by = pair_bound(nbytes, 2**n, 2**w1, 2**w2,
                                            "f32")
        else:
            def launch(x, m):
                return kernels.window_apply(x, n, start, w1, m[0], none)

            def cotangents():
                return kernels._matrix_cotangent(cot, psi, split, 1)
            bound_ms, bound_by = product_bound(
                2 * psi.numel() * 4, 8 * 2**w1 * 2**n, "f32", w1 > 2)

        def forward_and_backward():
            x = psi.detach().requires_grad_()
            ms = [w.detach().requires_grad_() for w in ws]
            return torch.autograd.grad(launch(x, ms), [x, *ms], cot)

        fwd, adj_ms, cot_ms, both = timed_in_turns(
            [lambda: launch(psi, ws), lambda: launch(cot, adj),
             cotangents, forward_and_backward], device)
        rows.append({"step": key, "forward_ms": fwd, "adjoint_ms": adj_ms,
                     "cotangent_ms": cot_ms, "forward_backward_ms": both,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "ratio": both / fwd})
    for row in rows:
        row["forward_launches"], row["adjoint_launches"] = seen[row["step"]]
    return rows


def time_folds(plan, theta, device) -> dict:
    """Wall ms (ended by a synchronise) of folding every parameterised
    window of ``plan`` once at ``theta``, and of the folds with their
    backward: the host work a value-and-gradient does besides its
    launches."""
    from qbot_tpu_torch.tpu.compiler import PairStep
    from qbot_tpu_torch.tpu.planar import fold_window_planar

    windows = [w for s in plan.steps
               for w in ((s.first, s.second) if isinstance(s, PairStep)
                         else (s,))
               if any(t.matrix is None for t in w.terms)]

    def folds(grad: bool):
        t = theta.detach().requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            total = sum(torch.sum(fold_window_planar(w, t)) for w in windows)
        if grad:
            torch.autograd.grad(total, t)
    out = {"windows": len(windows)}
    for label, grad in (("fold_ms", False), ("fold_and_backward_ms", True)):
        _, wall, _, _ = timed_run(lambda: folds(grad), device)
        out[label] = wall * 1e3
    return out


def gradient_path(device, card: str) -> tuple[dict, dict, dict]:
    """Phase 11.  Returns ({run: launches}, {counter: backward launches},
    numbers)."""
    from qbot_tpu_torch.inference import hmc, nuts

    circ, plans, counts, theta0 = hmc_ansatz(device)
    theta = theta0[0]
    checked = {**plans, **complex_plans()}
    runs, backward, numbers = {}, {}, {}
    grads = {}
    for mode in ("f32", *REDUCED_MODES):
        kernels.set_dot_mode(mode)
        moved = dict.fromkeys(GRAD_KERNELS, 0)
        for label, plan in checked.items():
            lp = hmc.make_circuit_log_prob_planar(plan, counts, device=device)
            grad, back = check_gradient(
                f"ansatz {HMC_QUBITS}q {label}", plan, lp,
                plain_log_prob(plan, counts, device), theta, device, mode)
            for k, v in back.items():
                backward[k] = backward.get(k, 0) + v
                if k.split("[")[0] in moved:
                    moved[k.split("[")[0]] += v
            if mode == "f32":
                grads[label] = grad
            if mode == "f32" and label in plans:
                numbers[f"grad_{label}"] = time_value_and_grad(lp, theta,
                                                               device)
        missing = [k for k, v in moved.items() if v <= 0]
        if missing:
            raise AssertionError(f"phase 11 [{mode}]: no backward launch of "
                                 f"{missing}")
    kernels.set_dot_mode("f32")

    simulated = {}      # one simulator gradient a circuit
    for label, grad in grads.items():
        circuit = label.split()[0] == "complex"
        if circuit not in simulated:
            simulated[circuit] = hmc.value_and_grad(hmc.make_circuit_log_prob(
                checked[label], counts, dtype=torch.complex64,
                device=device))(theta)[1]
        want = simulated[circuit]
        err = float(torch.max(torch.abs(grad - want)))
        if not torch.allclose(grad, want, **SIM_GRAD_TOL):
            raise AssertionError(f"ansatz {label}: gradient off the "
                                 f"complex64 simulator's by {err:.3e}")
        say(f"ansatz {HMC_QUBITS}q {label}: gradient within {err:.3e} of "
            f"the complex64 simulator's (rtol 2e-3, atol 1e-3)")

    n = GRAD_GROVER_QUBITS
    marked = (2**n) // 3
    plan = compile_circuit(grover_loss(n, marked))
    if not any(type(s).__name__ == "ReflectStep" for s in plan.steps):
        raise AssertionError(f"Grover-in-the-loss compiled to {plan.steps}")
    g_counts = np.zeros(2**n, np.float32)
    g_counts[0], g_counts[marked] = 10.0, 6.0
    lp = hmc.make_circuit_log_prob_planar(plan, g_counts, device=device)
    _, back = check_gradient(f"Grover-in-the-loss {n}q", plan, lp,
                             plain_log_prob(plan, g_counts, device),
                             torch.linspace(0.3, 1.1, n, device=device),
                             device, "f32")
    for k, v in back.items():
        backward[k] = backward.get(k, 0) + v
    if not (back.get("reflect_dot", 0) and back.get("reflect_update", 0)):
        raise AssertionError(f"Grover-in-the-loss: backward {back}")

    parts = {label: backward_parts(plan, device)
             for label, plan in plans.items()}
    for label, rows in parts.items():
        for row in rows:
            say(f"backward {label} {row['step']}: forward "
                f"{row['forward_ms']:.4f} ms, W† launch "
                f"{row['adjoint_ms']:.4f}, matrix cotangents "
                f"{row['cotangent_ms']:.4f}, forward and backward "
                f"{row['forward_backward_ms']:.4f}, ratio to the forward "
                f"{row['ratio']:.3f}; bound {row['bound_ms']:.4f} "
                f"({row['bound_by']}); launches {row['forward_launches']} "
                f"forward, {row['adjoint_launches']} W† a gradient")
    numbers["backward_parts"] = parts
    numbers["fold"] = time_folds(plans["paired"], theta, device)
    say(f"parameterised folds of the paired plan: {numbers['fold']}")

    lp = hmc.make_circuit_log_prob_planar(plans["paired"], counts,
                                          device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (qs, lps), runs["hmc_chains"] = _launch_delta(lambda: hmc.run_hmc_chains(
        gen, lp, theta0, HMC_SAMPLES, HMC_STEP, HMC_LEAPFROG))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not (torch.isfinite(qs).all() and torch.isfinite(lps).all()):
        raise AssertionError("HMC: a position or log-prob is not finite")
    moved = torch.any(qs != torch.cat([theta0[:, None], qs[:, :-1]], 1),
                      dim=-1)
    samples = HMC_CHAINS * HMC_SAMPLES
    grads_run = HMC_CHAINS * (1 + HMC_SAMPLES * HMC_LEAPFROG)
    numbers["hmc"] = {"wall_s": wall, "samples_per_s": samples / wall,
                      "gradients_per_s": grads_run / wall,
                      "acceptance": float(moved.double().mean()),
                      "peak_bytes": peak,
                      "final_log_probs": lps[:, -1].tolist()}
    say(f"HMC {HMC_QUBITS}q, {circ.num_params} angles, {HMC_CHAINS} chains "
        f"x {HMC_SAMPLES} samples, step {HMC_STEP}, {HMC_LEAPFROG} "
        f"leapfrogs: {wall:.3f} s, {samples / wall:.3f} samples/s, "
        f"{grads_run / wall:.2f} gradients/s, acceptance "
        f"{float(moved.double().mean()):.3f}, peak {peak / 2**30:.3f} GiB "
        f"allocated; final log-probs {lps[:, -1].tolist()}; launches "
        f"{runs['hmc_chains']} ({card})")

    gen = torch.Generator(device=device).manual_seed(1)
    t0 = time.perf_counter()

    def run_nuts():
        eps, warm = nuts.nuts_warmup(gen, lp, theta, NUTS_WARMUP, 0.8,
                                     HMC_STEP, NUTS_DEPTH)
        return eps, nuts.run_nuts(gen, lp, warm.position, NUTS_SAMPLES,
                                  eps, NUTS_DEPTH)

    (eps, (qs, lps, stats)), runs["nuts"] = _launch_delta(run_nuts)
    wall = time.perf_counter() - t0
    if not (torch.isfinite(qs).all() and torch.isfinite(lps).all()):
        raise AssertionError("NUTS: a position or log-prob is not finite")
    leaves = int(stats.num_leaves.sum())
    numbers["nuts"] = {"wall_s": wall, "step_size": eps, "leaves": leaves,
                       "depths": stats.depth.tolist(),
                       "accept_prob": stats.accept_prob.tolist(),
                       "diverged": int(stats.diverged.sum())}
    say(f"NUTS {HMC_QUBITS}q: warm-up {NUTS_WARMUP} + {NUTS_SAMPLES} "
        f"transitions at max_tree_depth {NUTS_DEPTH}: step size {eps:.4f}, "
        f"{leaves} leaves in the samples, depths {stats.depth.tolist()}, "
        f"{int(stats.diverged.sum())} divergent, {wall:.3f} s; launches "
        f"{runs['nuts']} ({card})")
    return runs, backward, numbers


# ---------------------------------------------------------------------------
# phase 12: window="auto" against the card
# ---------------------------------------------------------------------------

AUTO_SLACK = 1.10          # the pick's time over the best ranked candidate
AUTO_RUNS = 5              # timed runs of each plan, in turns
AUTO_GROVER_REPEATS = 64   # the scanned Grover body's iterations
ALL_WIDTHS = tuple(range(1, 8))


def same_plan(a, b) -> bool:
    """``a`` and ``b`` equal step for step, field for field (arrays bit for
    bit)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if hasattr(a, "__dataclass_fields__"):
        return all(same_plan(getattr(a, f), getattr(b, f))
                   for f in a.__dataclass_fields__)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(same_plan, a, b))
    return a is b or a == b


def bind_angles(plan, theta):
    """``plan`` with every parameterised term and contraction fixed at the
    angles ``theta``: a static plan, which a prepared runner folds once,
    so that timing it leaves the per-call folds out."""
    from dataclasses import replace

    from qbot_tpu_torch.ops.gates import controlled
    from qbot_tpu_torch.tpu.compiler import ContractStep, PairStep, WindowStep

    def fixed(x):
        if x.maker is None:
            return x
        m = x.maker(theta[x.param_idx].double()).detach().cpu().numpy()
        m = m[0] + 1j * m[1]
        return replace(x, matrix=controlled(m, x.num_controls)
                       if x.num_controls else m, param_idx=None,
                       maker=None, num_controls=0)

    def step(s):
        if isinstance(s, WindowStep):
            return replace(s, terms=tuple(map(fixed, s.terms)))
        if isinstance(s, PairStep):
            return PairStep(step(s.first), step(s.second))
        return fixed(s) if isinstance(s, ContractStep) else s
    return replace(plan, steps=[step(s) for s in plan.steps], num_params=0)


def modelled_s(plan, mode: str) -> float:
    """The cost model of the plan's engine: ``dot_cost_model`` or
    ``plan_cost_model``."""
    from qbot_tpu_torch.tpu.compiler import dot_cost_model, plan_cost_model

    model = dot_cost_model if plan.engine == "dot" else plan_cost_model
    return model(plan, mode)


def candidate_plans(circ) -> dict:
    """{(engine, width): plan} of ``circ``: the kernel engine's plans at
    widths 1..7 and the dot engine's at DOT_WIDTHS (``partition="dot"``,
    ``engine = "dot"``), all paired."""
    from qbot_tpu_torch.tpu.compiler import DOT_WIDTHS

    plans = {("kernel", w): compile_circuit(circ, window=w)
             for w in ALL_WIDTHS}
    for w in DOT_WIDTHS:
        plans[("dot", w)] = compile_circuit(circ, window=w, partition="dot")
        plans[("dot", w)].engine = "dot"
    return plans


def ranked(key) -> bool:
    """True for the candidates ``window="auto"`` ranks: kernel widths
    AUTO_WIDTHS, dot widths DOT_WIDTHS."""
    from qbot_tpu_torch.tpu.compiler import AUTO_WIDTHS, DOT_WIDTHS

    engine, w = key
    return w in (AUTO_WIDTHS if engine == "kernel" else DOT_WIDTHS)


def auto_cells(device) -> tuple[dict, torch.Tensor]:
    """({cell: (circuit, plan -> runner(psi0), (plan, mode) -> modelled
    seconds)}, the ansatz's angles): the brickwork bodies at 26 and 23
    qubits, Grover's 26-qubit body on the scanned runner after its width-7
    init (modelled as the init and AUTO_GROVER_REPEATS bodies; the runner
    forms ⟨v|ψ⟩ of each later iteration in the update, so the model counts
    a ``reflect_dot`` an iteration more than it makes; a body of one
    reflection takes the reflection loop on either engine, as in the
    reference), the 24-qubit ansatz forward at fixed angles
    (``bind_angles``: the runner folds its windows once, as it does a
    static plan's).  Each plan is modelled by its engine's model."""
    from qbot_tpu_torch.tpu.compiler import plan_cost_model
    from qbot_tpu_torch.tpu.planar import make_planar_runner

    marked, init, body = grover_circuits(N)
    init_plan = compile_circuit(init)
    ansatz, _, _, theta0 = hmc_ansatz(device)
    theta = theta0[0]

    def planar_runner(plan):
        run = make_planar_runner(bind_angles(plan, theta))
        return lambda psi: run(psi)

    def grover_model(plan, mode):
        return (plan_cost_model(init_plan, mode)
                + AUTO_GROVER_REPEATS * modelled_s(plan, mode))
    return {
        f"brickwork_{N}q": (brickwork_circuit(N, BRICKWORK_LAYERS),
                            planar_runner, modelled_s),
        f"brickwork_{NARROW_DRIFT_QUBITS}q": (
            brickwork_circuit(NARROW_DRIFT_QUBITS, BRICKWORK_LAYERS),
            planar_runner, modelled_s),
        f"grover_{N}q": (body, lambda plan: make_scanned_planar_runner(
            plan, AUTO_GROVER_REPEATS, init_plan=init_plan), grover_model),
        f"ansatz_{HMC_QUBITS}q": (ansatz, planar_runner, modelled_s),
    }, theta


def _event_ms(fn) -> float:
    """Milliseconds of one run of ``fn`` between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _label(key) -> str:
    return f"{key[0]} width {key[1]}"


def launches_of(plan) -> list:
    """The launches the cost model of the plan's engine counts for it
    (``step_launches`` or ``dot_step_launches``), in order."""
    from qbot_tpu_torch.tpu.compiler import dot_step_launches, step_launches

    launches = dot_step_launches if plan.engine == "dot" else step_launches
    return [x for s in plan.steps for x in launches(s, plan.n)]


def same_work(a, b) -> bool:
    """True when the runners of plans ``a`` and ``b`` make the same
    launches at the same geometries (Grover's one reflection at every
    width and on either engine: its factors differ, its two kernels do
    not)."""
    return launches_of(a) == launches_of(b)


def _work_delta(fn):
    """(result of ``fn()``, kernel launches and dot-engine library products
    it made, summed)."""
    before = dotplan.product_counts()
    out, launches = _launch_delta(fn)
    after = dotplan.product_counts()
    return out, sum(launches.values()) + sum(
        v - before.get(k, 0) for k, v in after.items()), launches


def auto_cell(name: str, circ, model, theta, device, mode: str,
              plans: dict, runners: dict, reference,
              reference_launches: int) -> tuple[dict, dict]:
    """One cell of phase 12 in dot ``mode`` (set by the caller): ``circ``
    compiled with ``window="auto"`` equals the candidate of its engine and
    width (a); each candidate in ``plans`` timed on its prepared runner,
    the median of AUTO_RUNS CUDA-event runs in turns, beside its ``model``;
    the pick within AUTO_SLACK of the best ranked candidate of either
    engine, kernel widths 4..7 and dot widths 4..8 (b); each candidate's
    final state against ``reference`` (the f32 kernel width-7 state, of
    ``reference_launches`` launches) within ``runs_limit`` of their
    launches and library products (c).  Returns (the pick's launches, the
    cell's numbers)."""
    t0 = time.perf_counter()
    auto = compile_circuit(circ, window="auto")
    auto_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compile_circuit(circ, window=7)
    seven_s = time.perf_counter() - t0
    pick = (auto.engine, auto.window)
    if not same_plan(auto, plans[pick]):
        raise AssertionError(f"[{mode}] {name}: the auto plan differs from "
                             f"its {_label(pick)}'s")
    psi0 = zero_state_planar(circ.n, device)
    limits, launches, errors = {}, {}, {}
    for key in plans:
        out, work, launches[key] = _work_delta(lambda: runners[key](psi0))
        limits[key] = runs_limit(mode, work + reference_launches)
        errors[key] = rel_l2(out, reference)
        del out
    times = {key: [] for key in plans}
    order = list(plans)
    for r in range(AUTO_RUNS):
        for key in order[::1 if r % 2 == 0 else -1]:
            times[key].append(_event_ms(lambda: runners[key](psi0)))
    own = {key: float(np.median(t)) for key, t in times.items()}
    spread = {key: (max(t) - min(t)) / own[key] for key, t in times.items()}
    # candidates that make the same launches (Grover's one reflection at
    # every width, on either engine) are one piece of work: each is
    # measured by the median of all their runs, so that the pick is not
    # held against the luckiest of several runs of its own work
    measured = {key: float(np.median([t for other in plans
                                      if same_work(plans[key], plans[other])
                                      for t in times[other]]))
                for key in plans}
    modelled = {key: model(plans[key], mode) * 1e3 for key in plans}
    best = min(measured[key] for key in plans if ranked(key))
    for key in plans:
        pooled = ("" if measured[key] == own[key] else
                  f", {measured[key]:.4f} ms with the runs of the same work")
        say(f"[{mode}] {name} {_label(key)}"
            f"{' (auto)' if key == pick else ''}: "
            f"{len(plans[key].steps)} steps, modelled {modelled[key]:.4f} "
            f"ms, measured {own[key]:.4f} ms (median of {AUTO_RUNS}, "
            f"spread {spread[key]:.3f}{pooled}), vs f32 kernel width 7 rel "
            f"L2 {errors[key]:.3e} (limit {limits[key]:.3e})")
    beaten = [w for w in ALL_WIDTHS[:3]
              if measured[("kernel", w)] * AUTO_SLACK < measured[pick]]
    t0 = time.perf_counter()
    apply_plan_planar(psi0, auto, theta if auto.num_params else None)
    sync(device)
    oneshot_s = time.perf_counter() - t0
    fastest = min((k for k in plans if ranked(k)), key=measured.get)
    say(f"[{mode}] {name}: auto picks the {_label(pick)}, measured "
        f"{measured[pick]:.4f} ms against {best:.4f} ms, the best ranked "
        f"candidate (the {_label(fastest)}; limit {AUTO_SLACK} x); kernel "
        f"widths 1..3 faster than the pick by more than 10%: "
        f"{beaten or 'none'}; compile auto {auto_s:.4f} s against width 7 "
        f"{seven_s:.4f} s; one-shot apply_plan_planar at the pick "
        f"{oneshot_s:.4f} s")
    bad = [_label(k) for k in plans if not errors[k] <= limits[k]]
    if bad:
        raise AssertionError(f"[{mode}] {name}: {bad} leave the f32 "
                             f"width-7 state: {errors}")
    if not measured[pick] <= AUTO_SLACK * best:
        raise AssertionError(f"[{mode}] {name}: the auto pick "
                             f"({_label(pick)}) takes {measured[pick]:.4f} "
                             f"ms, over {AUTO_SLACK} x {best:.4f} ms")

    def by_label(d):
        return {_label(k): v for k, v in d.items()}
    return launches[pick], {
        "pick": _label(pick), "fastest": _label(fastest),
        "modelled_ms": by_label(modelled),
        "measured_ms": by_label(measured), "own_ms": by_label(own),
        "spread": by_label(spread),
        "rel_l2": by_label(errors), "beaten_by_1_3": beaten,
        "auto_compile_s": auto_s, "width7_compile_s": seven_s,
        "oneshot_s": oneshot_s}


def auto_path(device, card: str) -> tuple[dict, dict]:
    """Phase 12.  Returns ({run: launches}, numbers)."""
    cells, theta = auto_cells(device)
    runs, numbers = {}, {}
    for name, (circ, make_runner, model) in cells.items():
        plans = candidate_plans(circ)
        runners = {key: make_runner(plan) for key, plan in plans.items()}
        psi0 = zero_state_planar(circ.n, device)
        kernels.set_dot_mode("f32")
        reference, ref_launches = _launch_delta(
            lambda: runners[("kernel", 7)](psi0))
        for mode in ("f32", *REDUCED_MODES):
            kernels.set_dot_mode(mode)
            launches, numbers[f"{name}[{mode}]"] = auto_cell(
                name, circ, model, theta, device, mode, plans, runners,
                reference, sum(ref_launches.values()))
            runs[f"auto_{name}" if mode == "f32" else
                 f"auto_{name}[{mode}]"] = launches
        kernels.set_dot_mode("f32")
        del reference, runners
    say(f"auto numbers ({card}): {json.dumps(numbers)}")
    return runs, numbers


# ---------------------------------------------------------------------------
# phase 13: the dot engine (tpu/dotplan.py)
# ---------------------------------------------------------------------------

ALL_DOT_MODES = ("f32", "f32_mix", *REDUCED_MODES)
DOT_BRICKWORK_REPEATS = 8  # bodies of the 16-layer brickwork, scanned
DOT_RENORM_EVERY = 4
DOT_RUNS = 3               # timed runs of each route, in turns
DOT_DENSITY_TOL = 1e-4     # trace and relative Frobenius vs the step runner


def first_cheapest(circ, mode: str, engine: str):
    """The first cheapest candidate of ``engine`` that ``window="auto"``
    ranks for ``circ`` in dot ``mode`` (its plan's ``engine`` set)."""
    from qbot_tpu_torch.tpu.compiler import auto_candidates

    _, plan, _ = min((c for c in auto_candidates(circ, mode=mode)
                      if c[2] == engine), key=lambda c: c[0])
    plan.engine = engine
    return plan


def dot_limit(mode: str, lowered, runs: int) -> float:
    """The relative L2 limit between ``runs`` runs of ``lowered`` through
    the library and through the plain products in dot ``mode``: f32
    KERNEL_TOL; bf16_3x and bf16 ``runs_limit`` of their products; f32_mix
    KERNEL_TOL and the bf16_3x limits of its wide windows."""
    wins = [s for s in lowered.steps if isinstance(s, dotplan._Win)]
    if mode == "f32":
        return KERNEL_TOL
    if mode == "f32_mix":
        wide = sum(s.mode == "bf16_3x" for s in wins)
        return KERNEL_TOL + runs * wide * LIMITS["bf16_3x"][2]
    return runs_limit(mode, runs * len(wins))


def _products(fn):
    """(result of ``fn()`` ended by a synchronise, library products it
    made by mode)."""
    before = dotplan.product_counts()
    out = fn()
    torch.cuda.synchronize()
    after = dotplan.product_counts()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


def _median_in_turns(fns: dict, runs: int = DOT_RUNS) -> dict:
    """Median CUDA-event ms of each of ``fns`` over ``runs`` runs in turns."""
    times = {k: [] for k in fns}
    for r in range(runs):
        for k in list(fns)[::1 if r % 2 == 0 else -1]:
            times[k].append(_event_ms(fns[k]))
    return {k: float(np.median(t)) for k, t in times.items()}


def dot_circuit(name: str, circ, repeats: int, init, device,
                mode: str) -> dict:
    """One circuit on the dot engine in dot ``mode`` (set by the caller):
    its dot plan at the width the dot ranking picks, ``repeats`` bodies
    after ``init`` on ``make_scanned_dot_runner``, against the same
    through the plain products (``dot_limit``) and against the kernel
    engine's first cheapest plan (the sum of both routes' limits; f32
    KERNEL_TOL); both timed; in the reduced modes ``renorm_every``
    DOT_RENORM_EVERY with the norm within RENORM_TOL of 1 on exit."""
    from qbot_tpu_torch.tpu.dotplan import (
        apply_plan_dot_ref,
        lower_dot_plan,
        make_scanned_dot_runner,
    )

    plan = first_cheapest(circ, mode, "dot")
    kplan = first_cheapest(circ, mode, "kernel")
    lowered = lower_dot_plan(plan)
    init_lowered = None if init is None else lower_dot_plan(init)
    run = make_scanned_dot_runner(plan, repeats, init_plan=init)
    krun = make_scanned_planar_runner(kplan, repeats, init_plan=init)
    psi0 = zero_state_planar(circ.n, device)
    out, products = _products(lambda: run(psi0))
    ref = psi0 if init_lowered is None else apply_plan_dot_ref(
        psi0, init_lowered)
    for _ in range(repeats):
        ref = apply_plan_dot_ref(ref, lowered)
    limit = dot_limit(mode, lowered, repeats) + (
        0.0 if init_lowered is None else dot_limit(mode, init_lowered, 1))
    rel_ref, max_abs = compare(f"[{mode}] dot {name} vs plain products",
                               out, ref, limit)
    del ref
    kout, klaunches = _launch_delta(lambda: krun(psi0))
    klimit = runs_limit(mode if mode in REDUCED_MODES else "f32",
                        sum(klaunches.values()))
    kin = (KERNEL_TOL if mode == "f32" else limit + klimit)
    rel_kernel = rel_l2(out, kout)
    if not rel_kernel <= kin:
        raise AssertionError(f"[{mode}] dot {name}: rel L2 {rel_kernel:.3e} "
                             f"from the kernel engine > {kin:.3e}")
    norm = float(planar_norm(out))
    drift = (1.0 - norm) / (circ.gate_count * repeats / 100)
    del kout, out
    ms = _median_in_turns({"dot": lambda: run(psi0),
                           "kernel": lambda: krun(psi0)})
    numbers = {"dot_width": plan.window, "kernel_width": kplan.window,
               "dot_steps": len(lowered.steps), "products": products,
               "rel_l2_plain": rel_ref, "limit_plain": limit,
               "max_abs_err": max_abs, "rel_l2_kernel": rel_kernel,
               "limit_kernel": kin, "norm": norm,
               "drift_per_100_gates": drift,
               "dot_modelled_ms": repeats * modelled_s(plan, mode) * 1e3,
               "kernel_modelled_ms": repeats * modelled_s(kplan, mode) * 1e3,
               "dot_ms": ms["dot"], "kernel_ms": ms["kernel"]}
    line = ""
    if mode in REDUCED_MODES:
        renormed = make_scanned_dot_runner(plan, repeats, init_plan=init,
                                           renorm_every=DOT_RENORM_EVERY)
        rnorm = float(planar_norm(renormed(psi0)))
        numbers["renorm_norm"] = rnorm
        if not abs(rnorm - 1.0) <= RENORM_TOL:
            raise AssertionError(f"[{mode}] dot {name}: norm {rnorm} after "
                                 f"renorm_every={DOT_RENORM_EVERY}")
        line = f", renorm_every={DOT_RENORM_EVERY} norm {rnorm:.8f}"
    say(f"[{mode}] dot engine {name} x {repeats}: dot width {plan.window} "
        f"({len(lowered.steps)} steps, products {products}), rel L2 vs "
        f"plain products {rel_ref:.3e} (limit {limit:.3e}), vs the kernel "
        f"engine (width {kplan.window}) {rel_kernel:.3e} (limit "
        f"{kin:.3e}), norm {norm:.8f} (drift {drift:.4e} per 100 gates)"
        f"{line}; dot {ms['dot']:.4f} ms "
        f"(modelled {numbers['dot_modelled_ms']:.4f}), kernel engine "
        f"{ms['kernel']:.4f} ms (modelled "
        f"{numbers['kernel_modelled_ms']:.4f})")
    return numbers


def mix_rule(device, gen) -> dict:
    """f32_mix's per-window rule on the card: a window of 7 or 8 qubits
    (the dot partition's lane window, B = 1, and a first window, A = 1)
    runs bf16_3x's products bit for bit, a 6-qubit one (the sub window,
    A and B > 1) f32's."""
    from qbot_tpu_torch.tpu.compiler import Plan, Term, WindowStep
    from qbot_tpu_torch.tpu.dotplan import apply_plan_dot, lower_dot_plan

    rng = np.random.default_rng(13)
    psi = _random_state(N, gen, device)
    out = {}
    for start, width in ((N - 7, 7), (0, 8), (N - 13, 6)):
        u = _random_unitary(2**width, rng)
        plan = Plan(N, width, [WindowStep(start, width, (
            Term(tuple(range(width)), u),))], engine="dot")
        runs = {}
        for mode in ("f32_mix", dotplan.window_mode("f32_mix", width)):
            kernels.set_dot_mode(mode)
            runs[mode], products = _products(
                lambda: apply_plan_dot(psi, lower_dot_plan(plan)))
            runs[mode + " products"] = products
        kernels.set_dot_mode("f32")
        want = dotplan.window_mode("f32_mix", width)
        same = bool(torch.equal(runs["f32_mix"], runs[want]))
        if not same or runs["f32_mix products"] != {f"dot_window[{want}]": 1}:
            raise AssertionError(f"f32_mix window of {width} qubits: "
                                 f"{runs['f32_mix products']}, bit for bit "
                                 f"{want}'s: {same}")
        out[f"{start}+{width}"] = want
        say(f"[f32_mix] dot window [{start}, {start + width}): "
            f"{runs['f32_mix products']}, bit for bit {want}'s products")
    return out


def dot_density(device, mode: str) -> dict:
    """``bench.py``'s density workload (13 qubits x 8 layers x 16 bodies,
    bench.py:355-362) in dot ``mode`` (set by the caller), three ways from
    the kernel engine's first cheapest plan: ``density_plan_2n`` on the dot
    engine (``make_scanned_dot_runner``), the same 26-qubit plan on the
    kernel engine (``make_scanned_planar_runner``), and
    ``make_planar_density_runner`` body by body.  The first two against
    the third: in f32 the trace and ρ (relative Frobenius) within
    DOT_DENSITY_TOL; in the other modes within the routes' summed limits.
    All three timed."""
    from dataclasses import replace

    from qbot_tpu_torch.tpu.dotplan import (
        density_plan_2n,
        lower_dot_plan,
        make_scanned_dot_runner,
    )

    c = brickwork_circuit(DENSITY_N, DENSITY_LAYERS, seed=7)
    plan = first_cheapest(c, mode, "kernel")
    big = density_plan_2n(plan)
    lowered = lower_dot_plan(big)
    step_body = make_planar_density_runner(plan)
    routes = {
        "dot": make_scanned_dot_runner(big, DENSITY_REPEATS),
        "kernel_2n": make_scanned_planar_runner(replace(big, engine="kernel"),
                                                DENSITY_REPEATS)}
    rho0 = zero_density_planar(DENSITY_N, device)

    def step_run():
        rho = rho0
        for _ in range(DENSITY_REPEATS):
            rho = step_body(rho)
        return rho.reshape(2, -1)
    fns = {name: (lambda r=r: r(rho0.reshape(2, -1)))
           for name, r in routes.items()}
    fns["step"] = step_run
    want, step_launches = _launch_delta(step_run)
    trace_want = float(torch.sum(torch.diagonal(want.reshape(
        2, 2**DENSITY_N, 2**DENSITY_N)[0])))
    numbers = {"window": plan.window, "dot_steps": len(lowered.steps)}
    for name in routes:
        got, work, _ = _work_delta(fns[name])
        limit = (DOT_DENSITY_TOL if mode == "f32" else
                 dot_limit(mode, lowered, DENSITY_REPEATS)
                 + runs_limit(mode if mode in REDUCED_MODES else "f32",
                              work + sum(step_launches.values())))
        trace = float(torch.sum(torch.diagonal(got.reshape(
            2, 2**DENSITY_N, 2**DENSITY_N)[0])))
        frob = rel_l2(got, want)
        numbers[name] = {"trace": trace, "rel_frobenius": frob,
                         "limit": limit}
        del got
        if not (abs(trace - trace_want) <= limit and frob <= limit):
            raise AssertionError(f"[{mode}] density {name}: trace {trace} "
                                 f"against {trace_want}, relative Frobenius "
                                 f"{frob:.3e} (limit {limit:.3e})")
    del want
    ms = _median_in_turns(fns)
    for name in fns:
        numbers.setdefault(name, {})["ms"] = ms[name]
    say(f"[{mode}] density {DENSITY_N}q x {DENSITY_LAYERS} layers x "
        f"{DENSITY_REPEATS} (width {plan.window}): density_plan_2n on the "
        f"dot engine {ms['dot']:.4f} ms (trace "
        f"{numbers['dot']['trace']:.8f}, rel Frobenius vs the step runner "
        f"{numbers['dot']['rel_frobenius']:.3e}), on the kernel engine "
        f"{ms['kernel_2n']:.4f} ms "
        f"({numbers['kernel_2n']['rel_frobenius']:.3e}), "
        f"make_planar_density_runner {ms['step']:.4f} ms (trace "
        f"{trace_want:.8f})")
    return numbers


def dot_windows(device, gen) -> dict:
    """The dot engine's window (the engine's own window step, its matrix
    split once, the state's split and layout inside) at each window
    geometry of phase 2, beside ``window_apply`` (no diagonals), in turns,
    in every mode that runs its own products; the two states within the
    sum of the mode's window limits."""
    from qbot_tpu_torch.tpu.compiler import Term, WindowStep

    rng = np.random.default_rng(17)
    psi = _random_state(N, gen, device)
    none = kernels.fused_diagonals(N, device=device)
    out = {}
    for mode in ("f32", *REDUCED_MODES):
        kernels.set_dot_mode(mode)
        for label, (start, w) in window_geometries(N).items():
            u = _random_unitary(2**w, rng)
            wt = torch.from_numpy(np.stack([u.real, u.imag]).astype(
                np.float32)).to(device)
            step = WindowStep(start, w, (Term(tuple(range(w)), u),))
            fn = dotplan._window_fn(N, dotplan._Win(step, (), ()), device,
                                    dotplan._LIBRARY)
            got = fn(psi, None)
            ref = kernels.window_apply(psi, N, start, w, wt, none)
            rel = rel_l2(got, ref)
            limit = 2 * LIMITS[mode][2]
            del got, ref
            if not rel <= limit:
                raise AssertionError(f"[{mode}] dot window {label}: rel L2 "
                                     f"{rel:.3e} from window_apply")
            ms = _median_in_turns({
                "dot": lambda: fn(psi, None),
                "kernel": lambda: kernels.window_apply(psi, N, start, w, wt,
                                                       none)}, runs=5)
            A, B = 2**start, 2**(N - start - w)
            out[f"{label}[{mode}]"] = {"A": A, "D": 2**w, "B": B,
                                       "dot_ms": ms["dot"],
                                       "kernel_ms": ms["kernel"],
                                       "rel_l2": rel}
            say(f"[{mode}] dot window {label} (A, D, B) = ({A}, {2**w}, "
                f"{B}): dot {ms['dot']:.4f} ms, kernel {ms['kernel']:.4f} "
                f"ms, rel L2 between them {rel:.3e}")
    kernels.set_dot_mode("f32")
    return out


def dot_path(device, gen, card: str) -> dict:
    """Phase 13.  Returns its numbers."""
    marked, init, body = grover_circuits(N)
    circuits = {f"brickwork_{N}q": (brickwork_circuit(N, BRICKWORK_LAYERS),
                                    DOT_BRICKWORK_REPEATS, None),
                f"grover_{N}q": (body, AUTO_GROVER_REPEATS,
                                 compile_circuit(init))}
    numbers = {}
    dotplan.reset_product_counts()
    for mode in ALL_DOT_MODES:
        kernels.set_dot_mode(mode)
        for name, (circ, repeats, init_plan) in circuits.items():
            numbers[f"{name}[{mode}]"] = dot_circuit(
                name, circ, repeats, init_plan, device, mode)
        numbers[f"density_{DENSITY_N}q[{mode}]"] = dot_density(device, mode)
    kernels.set_dot_mode("f32")
    numbers["f32_mix_rule"] = mix_rule(device, gen)
    numbers["windows"] = dot_windows(device, gen)
    numbers["products"] = dotplan.product_counts()
    missing = [f"dot_window[{m}]" for m in ("f32", *REDUCED_MODES)
               if not numbers["products"].get(f"dot_window[{m}]")]
    if missing:
        raise AssertionError(f"phase 13 never ran {missing}")
    numbers["card"] = card
    return numbers


# ---------------------------------------------------------------------------
# phase 14: the qubit-sharded register on torch.distributed ranks
# ---------------------------------------------------------------------------

SHARD_GLOO_SIZES = (2, 4)  # ranks of the brickwork, all on the one card
SHARD_GROVER_SIZES = ((4, "gloo"), (1, "nccl"))
SHARD_GROVER_REPEATS = 64
SHARD_DENSITY_SIZE = 2
SHARD_STATE_TOL = 1e-5     # rel L2, gathered state vs the single-device path
SHARD_PROBS_TARGETS = (0, 5, DENSITY_N - 1)


def _rank_sum(mesh, value: float) -> float:
    """The sum of a float64 scalar over the ranks."""
    t = torch.tensor([value], dtype=torch.float64, device=mesh.device)
    return float(sharded._all_reduce(mesh, t)[0])


def _counted(fn):
    """(result of ``fn()``, the launches it made on this rank)."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in kernels.launch_counts().items() if v}


def _timed_wall(mesh, fn) -> float:
    """Host seconds of one run of ``fn`` on every rank, between barriers
    (its exchanges included), after the untimed run the caller made."""
    torch.distributed.barrier()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    torch.distributed.barrier()
    return time.perf_counter() - t0


def sharded_brickwork_rank(mesh, n: int, layers: int) -> dict:
    """Phase 14 (a) on one rank: the brickwork of phase 5, sharded."""
    c = brickwork_circuit(n, layers)
    splan = sharded.compile_sharded(c, mesh.k)
    run = sharded.make_sharded_planar_runner(splan, mesh)
    psi0 = sharded.sharded_zero_state(n, mesh)
    out, launches = _counted(lambda: run(psi0))
    wall = _timed_wall(mesh, lambda: run(psi0))
    norm = _rank_sum(mesh, float(torch.sum(out.double() ** 2)))
    full = sharded.gather_planar(out, mesh)
    rec = {"rank": mesh.rank, "launches": launches, "wall_s": wall}
    if full is not None:
        full = sharded.unpermute_planar(full, splan.final_perm)
        single = apply_plan_planar(zero_state_planar(n, mesh.device),
                                   compile_circuit(c, window=7))
        rec.update(norm=norm, rel_l2=rel_l2(full, single),
                   num_reshards=splan.num_reshards,
                   comm_bytes=splan.comm_bytes(),
                   items=[type(i).__name__ for i in splan.items],
                   backend=mesh.backend)
    return rec


def sharded_grover_rank(mesh, n: int, repeats: int) -> dict:
    """Phase 14 (b) on one rank: Grover's Hadamard init, then ``repeats``
    bodies compiled from the init's layout."""
    marked, init, body = grover_circuits(n)
    k = mesh.k
    init_plan = sharded.compile_sharded(init, k)
    body_plan = sharded.compile_sharded(body, k,
                                        initial_perm=init_plan.final_perm)
    init_run = sharded.make_sharded_planar_runner(init_plan, mesh)
    body_run = sharded.make_sharded_planar_runner(body_plan, mesh)

    def run():
        psi = init_run(sharded.sharded_zero_state(n, mesh))
        for _ in range(repeats):
            psi = body_run(psi)
        return psi
    out, launches = _counted(run)
    wall = _timed_wall(mesh, run)
    # the marked amplitude's physical index under the final layout
    perm = body_plan.final_perm
    index = sum(((marked >> (n - 1 - perm[p])) & 1) << (n - 1 - p)
                for p in range(n))
    local = index & ((1 << (n - k)) - 1)
    mine = mesh.rank == index >> (n - k)
    p_marked = _rank_sum(mesh, float(out[0, local] ** 2 + out[1, local] ** 2)
                         if mine else 0.0)
    norm = _rank_sum(mesh, float(torch.sum(out.double() ** 2)))
    return {"rank": mesh.rank, "launches": launches, "wall_s": wall,
            "p_marked": p_marked, "norm": norm,
            "body_reshards": body_plan.num_reshards,
            "init_reshards": init_plan.num_reshards,
            "body_items": [type(i).__name__ for i in body_plan.items],
            "backend": mesh.backend}


def _partial_trace(rho: torch.Tensor, n: int, qubits) -> torch.Tensor:
    """Tr over ``qubits`` of a planar (2, 2^n, 2^n) ρ, one qubit at a time
    on a (2, pre, 2, post, pre, 2, post) view."""
    for q in sorted(qubits, reverse=True):
        pre, post = 2**q, 2 ** (n - 1 - q)
        v = rho.reshape(2, pre, 2, post, pre, 2, post)
        rho = (v[:, :, 0, :, :, 0, :] + v[:, :, 1, :, :, 1, :]).reshape(
            2, pre * post, pre * post)
        n -= 1
    return rho


def sharded_density_rank(mesh) -> dict:
    """Phase 14 (c) on one rank: one body of phase 6's density brickwork,
    its discard of two qubits and its marginals."""
    n = DENSITY_N
    c = brickwork_circuit(n, DENSITY_LAYERS, seed=7)
    splan = sharded.compile_sharded_density(c, mesh.k)
    run = sharded.make_sharded_planar_runner(splan, mesh)
    rho0 = sharded.sharded_zero_density(n, mesh)
    out, launches = _counted(lambda: run(rho0))
    wall = _timed_wall(mesh, lambda: run(rho0))
    probs = {t: sharded.sharded_density_probs_fn(splan, mesh, t)(out)
             for t in (None, SHARD_PROBS_TARGETS)}
    # back to the logical layout (BitSwaps and a LocalPerm), where qubit
    # 0's row axis is sharded; then discard it and a local qubit
    perm = splan.final_perm
    items, ident = sharded.plan_perm_to_identity(perm, 2 * n, mesh.k)
    canon = sharded.make_sharded_planar_runner(sharded.ShardedPlan(
        n=2 * n, k=mesh.k, items=items, final_perm=ident), mesh)(out)
    targets = [0, n - 1]
    reduced, new_perm = sharded.sharded_density_discard(
        canon, n, mesh.k, targets, mesh, perm=ident)
    full = sharded.gather_planar(out, mesh)
    canon_full = sharded.gather_planar(canon, mesh)
    reduced_full = sharded.gather_planar(reduced, mesh)
    rec = {"rank": mesh.rank, "launches": launches, "wall_s": wall}
    if full is None:
        return rec
    rho = sharded.unpermute_density(full, perm)
    single = make_planar_density_runner(compile_circuit(c))(
        zero_density_planar(n, mesh.device))
    want_reduced = _partial_trace(single, n, targets)
    got_reduced = sharded.unpermute_density(reduced_full, new_perm)
    rec.update(
        trace=float(torch.sum(torch.diagonal(rho[0]).double())),
        rel_frobenius=rel_l2(rho, single),
        layout_items=[type(i).__name__ for i in items],
        layout_rel_frobenius=rel_l2(canon_full, single),
        discard_targets=targets,
        discard_rel_frobenius=rel_l2(got_reduced, want_reduced),
        probs_rel_l2={str(t): rel_l2(p, planar_density_probs(single, t, n))
                      for t, p in probs.items()},
        num_reshards=splan.num_reshards, comm_bytes=splan.comm_bytes(),
        backend=mesh.backend)
    return rec


def _sum_launches(records) -> dict:
    total: dict = {}
    for rec in records:
        for name, count in rec["launches"].items():
            total[name] = total.get(name, 0) + count
    return total


def _require_launches(label: str, records, names) -> None:
    """Every rank of a run launched some kernel of each group of
    ``names``."""
    for rec in records:
        for group in names:
            if not any(rec["launches"].get(k, 0) for k in group):
                raise AssertionError(
                    f"{label}: rank {rec['rank']} never launched any of "
                    f"{group}; its launches {rec['launches']}")


def sharded_path(device, card: str) -> tuple[dict, dict]:
    """Phase 14: (launches summed over each run's ranks, readings)."""
    torch.cuda.empty_cache()
    runs, readings = {}, {}
    for size in SHARD_GLOO_SIZES:
        t0 = time.perf_counter()
        ranks = launch(sharded_brickwork_rank, size, N, BRICKWORK_LAYERS,
                       device="cuda", backend="gloo", timeout=900)
        records = [ranks[r] for r in sorted(ranks)]
        head = records[0]
        label = f"sharded_brickwork_{N}q_{size}ranks"
        if not (head["rel_l2"] <= SHARD_STATE_TOL
                and abs(head["norm"] - 1.0) <= NORM_TOL):
            raise AssertionError(f"{label}: rel L2 {head['rel_l2']:.3e} from "
                                 f"the single-device kernel path, norm "
                                 f"{head['norm']}")
        _require_launches(label, records, (WINDOW_KERNELS, PAIR_KERNELS))
        runs[label] = _sum_launches(records)
        readings[label] = {
            "ranks": size, "backend": head["backend"],
            "items": head["items"],
            "num_reshards": head["num_reshards"],
            "comm_bytes": head["comm_bytes"], "norm": head["norm"],
            "rel_l2_vs_single_device": head["rel_l2"],
            "wall_s": max(r["wall_s"] for r in records),
            "launches_per_rank": [r["launches"] for r in records],
            "phase_s": time.perf_counter() - t0}
        say(f"{label}: {readings[label]}")
    p_want = math.sin((2 * SHARD_GROVER_REPEATS + 1)
                      * math.asin(2 ** (-N / 2))) ** 2
    for size, backend in SHARD_GROVER_SIZES:
        t0 = time.perf_counter()
        ranks = launch(sharded_grover_rank, size, N, SHARD_GROVER_REPEATS,
                       device="cuda", backend=backend, timeout=900)
        records = [ranks[r] for r in sorted(ranks)]
        head = records[0]
        label = f"sharded_grover_{N}q_{size}ranks_{backend}"
        if not (abs(head["p_marked"] - p_want) <= NORM_TOL
                and abs(head["norm"] - 1.0) <= NORM_TOL
                and head["body_reshards"] == 0):
            raise AssertionError(f"{label}: marked {head['p_marked']} "
                                 f"against {p_want}, norm {head['norm']}, "
                                 f"body reshards {head['body_reshards']}")
        _require_launches(label, records, (("reflect_dot",),
                                           ("reflect_update",)))
        runs[label] = _sum_launches(records)
        readings[label] = {
            "ranks": size, "backend": head["backend"],
            "p_marked": head["p_marked"],
            "closed_form": p_want, "norm": head["norm"],
            "init_reshards": head["init_reshards"],
            "body_reshards": head["body_reshards"],
            "body_items": head["body_items"],
            "wall_s": max(r["wall_s"] for r in records),
            "launches_per_rank": [r["launches"] for r in records],
            "phase_s": time.perf_counter() - t0}
        say(f"{label}: {readings[label]}")
    t0 = time.perf_counter()
    ranks = launch(sharded_density_rank, SHARD_DENSITY_SIZE, device="cuda",
                   backend="gloo", timeout=900)
    records = [ranks[r] for r in sorted(ranks)]
    head = records[0]
    label = f"sharded_density_{DENSITY_N}q_{SHARD_DENSITY_SIZE}ranks"
    worst_probs = max(head["probs_rel_l2"].values())
    if not (abs(head["trace"] - 1.0) <= NORM_TOL
            and head["rel_frobenius"] <= DENSITY_TOL
            and head["layout_rel_frobenius"] <= DENSITY_TOL
            and head["discard_rel_frobenius"] <= DENSITY_TOL
            and worst_probs <= DENSITY_TOL):
        raise AssertionError(f"{label}: {head}")
    _require_launches(label, records, (WINDOW_KERNELS, PAIR_KERNELS))
    runs[label] = _sum_launches(records)
    readings[label] = {k: v for k, v in head.items()
                       if k not in ("rank", "launches", "wall_s")}
    readings[label].update(
        wall_s=max(r["wall_s"] for r in records),
        launches_per_rank=[r["launches"] for r in records],
        phase_s=time.perf_counter() - t0)
    say(f"{label}: {readings[label]}")
    cli = subprocess.run([sys.executable, "-m", "qbot_tpu_torch",
                          "examples/grover.qb", "--compile", "--shard", "1"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    err = cli.stderr.strip().splitlines()
    if not (cli.returncode == 1 and len(err) == 1
            and err[0].startswith("sharding error:") and not cli.stdout):
        raise AssertionError(f"--compile --shard 1 on one card: rc "
                             f"{cli.returncode}, stdout {cli.stdout!r}, "
                             f"stderr {cli.stderr!r}")
    readings["cli_shard_1_on_one_card"] = err[0]
    say(f"--compile --shard 1 on one card: exit 1, {err[0]!r}")
    return runs, readings


# ---------------------------------------------------------------------------
# phase 15: the particle × qubit mesh on torch.distributed ranks
# ---------------------------------------------------------------------------

MESH_QUBITS = SMC_QUBITS   # bench.py:402-470: 24 qubits, 32 particles
MESH_PARTICLES = SMC_PARTICLES
MESH_EXACT_TOL = 1e-5      # (d) against the single-device exact fan-out
MESH_SIGMAS = 4            # a sampled marginal's binomial bound
# (label, mesh shape, backend, runs (label, sampled particles)); a launch
# runs its runs in turn on the same ranks, then the dry run where asked
MESH_LAUNCHES = (
    ("1x1_nccl", (1, 1), "nccl", (("smc", MESH_PARTICLES),), False),
    ("2x1_gloo", (2, 1), "gloo", (("smc", MESH_PARTICLES),), False),
    ("2x2_gloo", (2, 2), "gloo", (("smc", MESH_PARTICLES), ("exact", 0)),
     True))
# the six TPU kernels (what a counter replaces) the phase must launch
MESH_KERNELS = sorted({rep for name, (_, rep) in KERNEL_SOURCES.items()
                       if "[" not in name})


def _mesh_run(emesh, n: int, sample: int, warm: bool) -> dict:
    """One timed run of bench.py's SMC program on this rank of ``emesh``
    (after an untimed one when ``warm``): its results, wall between
    barriers (the program lowered before it, as phase 10 times the
    single-device run), stats, launches and memory peak."""
    import warnings

    from qbot_tpu_torch.frontend.lowering import run_lowered_sharded_ensemble

    def run(lp, stats=None):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            res, ens, _, _ = run_lowered_sharded_ensemble(
                lp, mesh=emesh, sample=sample, seed=0, stats=stats)
        return {k: np.asarray(v.probs) for k, v in res.items()}, ens

    if warm:
        run(lower_program(smc_program(n), mid_measure=True))
    lp = lower_program(smc_program(n), mid_measure=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats: dict = {}
    with profiling.tracing():         # the spans fill stats["phase_walls"]
        ((probs, ens), wall), launches = _counted(
            lambda: _timed_wall_out(lambda: run(lp, stats)))
    return {"probs": probs, "wall_s": wall, "launches": launches,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "particles": ens.num_particles,
            "lost_mass": float(ens.lost_mass),
            "stats": {k: stats[k] for k in (
                "collapse_events", "num_reshards", "comm_bytes",
                "hbm_bytes", "num_collectives")},
            "phase_walls": stats.get("phase_walls", {}),
            "island_exchanges": stats.get("island_exchanges", 0)}


def _timed_wall_out(fn):
    """(``fn()``, host seconds of it on every rank between barriers)."""
    torch.distributed.barrier()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    torch.distributed.barrier()
    return out, time.perf_counter() - t0


def mesh_rank(emesh, n: int, runs, dry: bool) -> dict:
    """Phase 15 on one rank: ``runs`` ((label, sampled particles), ...) of
    the SMC program at ``n`` qubits, then the dry run when ``dry``."""
    from qbot_tpu_torch.tpu.distributed import dryrun_step

    out = {"rank": emesh.rank, "backend": emesh.backend, "runs": {}}
    for i, (label, sample) in enumerate(runs):
        out["runs"][label] = _mesh_run(emesh, n, sample, warm=i == 0)
    if dry:
        rec, launches = _counted(lambda: dryrun_step(emesh))
        out["dryrun"] = {"launches": launches,
                         **{k: v.tolist() for k, v in rec.items()}}
    return out


def _binomial_bound(p, B: int) -> np.ndarray:
    """MESH_SIGMAS standard deviations of a mean of B Bernoulli(p) draws
    (and the float32 readout's 1e-5 where p is 0 or 1)."""
    p = np.asarray(p)
    return MESH_SIGMAS * np.sqrt(p * (1.0 - p) / B) + 1e-5


def mesh_path(device, card: str, exact_single: dict) -> tuple[dict, dict]:
    """Phase 15: (launches summed over each run's ranks, readings).
    ``exact_single``: phase 10's single-device exact fan-out results of
    the same program."""
    torch.cuda.empty_cache()
    runs, readings, records = {}, {}, {}
    for label, shape, backend, mesh_runs, dry in MESH_LAUNCHES:
        t0 = time.perf_counter()
        ranks = launch(mesh_rank, shape, MESH_QUBITS, mesh_runs, dry,
                       device="cuda", backend=backend, timeout=900)
        records[label] = [ranks[r] for r in sorted(ranks)]
        say(f"mesh {label}: {len(ranks)} ranks in "
            f"{time.perf_counter() - t0:.2f} s")
    exact = records["2x2_gloo"][0]["runs"]["exact"]["probs"]
    for name, want in exact_single.items():
        err = float(np.max(np.abs(exact[name] - want)))
        if not err <= MESH_EXACT_TOL:
            raise AssertionError(f"mesh 2x2 exact: {name} off the "
                                 f"single-device exact fan-out by {err:.3e}")
    for label, shape, backend, mesh_runs, dry in MESH_LAUNCHES:
        recs = records[label]
        for run, sample in mesh_runs:
            head = recs[0]["runs"][run]
            key = f"mesh_{label}_{run}_{MESH_QUBITS}q"
            if sample:
                for name, p in head["probs"].items():
                    total = float(np.sum(p))
                    off = np.abs(p - exact[name]) - _binomial_bound(
                        exact[name], sample)
                    if abs(total - 1.0) > SMC_SUM_TOL or np.any(off > 0):
                        raise AssertionError(
                            f"{key}: {name} = {p.tolist()} (sum {total}) "
                            f"against exact {exact[name].tolist()}, "
                            f"{MESH_SIGMAS} sigma at {sample} particles")
            runs[key] = _sum_launches(
                [{"launches": r["runs"][run]["launches"]} for r in recs])
            wall = max(r["runs"][run]["wall_s"] for r in recs)
            readings[key] = {
                "mesh": f"{shape[0]}x{shape[1]}", "backend": backend,
                "sampled_particles": sample,
                "particles": head["particles"],
                "lost_mass": head["lost_mass"],
                "wall_s": wall,
                "samples_per_s": sample / wall if sample else None,
                "wall_per_collapse_s": wall / head["stats"][
                    "collapse_events"],
                **head["stats"],
                "phase_walls": head["phase_walls"],
                "island_exchanges": head["island_exchanges"],
                "peak_bytes_per_rank": [r["runs"][run]["peak_bytes"]
                                        for r in recs],
                "readout": {k: v.tolist() for k, v in head["probs"].items()},
                "launches_per_rank": [r["runs"][run]["launches"]
                                      for r in recs]}
            say(f"{key}: {readings[key]}")
        if dry:
            dr = recs[0]["dryrun"]
            key = f"mesh_{label}_dryrun"
            runs[key] = _sum_launches([r["dryrun"] for r in recs])
            if abs(sum(dr["grover"]) - 1.0) > 1e-4:
                raise AssertionError(f"{key}: Grover sums to "
                                     f"{sum(dr['grover'])}")
            readings[key] = {"thetas_mean": float(np.mean(dr["thetas"])),
                             "grover": dr["grover"], "a": dr["a"],
                             "b": dr["b"], "launches": runs[key]}
            say(f"{key}: {readings[key]}")
    total = _sum_launches([{"launches": v} for v in runs.values()])
    missing = [rep for rep in MESH_KERNELS
               if not any(total.get(name, 0) for name, (_, r)
                          in KERNEL_SOURCES.items()
                          if r == rep and "[" not in name)]
    if missing:
        raise AssertionError(f"phase 15 never launched the kernels "
                             f"replacing {missing}: {total}")
    return runs, readings


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
    """Runs Grover (phase 4), the brickwork paired and unpaired (phase 5),
    the 23-qubit brickwork whose plan holds the narrow pairs (phase 8), the
    brickwork compiled at ``window=2`` (phase 9), the density run (phase
    6), the SMC program (phase 10) and a value-and-gradient of the paired
    24-qubit ansatz (phase 11) once untimed, once timed on the host
    clock, and once under torch.profiler.  Prints each run's wall times,
    its device busy share (device-busy time over the traced wall time) and
    the profiler's table by device time, and writes the Chrome traces to
    ``out_dir``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from qbot_tpu_torch.inference import hmc

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out_dir.mkdir(parents=True, exist_ok=True)
    _, _, run, grover_psi0 = grover_runner(n, GROVER_REPEATS, device)
    brick = brickwork_circuit(n, BRICKWORK_LAYERS)
    paired = compile_circuit(brick)
    unpaired = compile_circuit(brick, pair=False)
    brick_psi0 = product_state_planar([np.array([1.0, 0.0])] * n, device)
    narrow = compile_circuit(brickwork_circuit(NARROW_DRIFT_QUBITS,
                                               BRICKWORK_LAYERS))
    narrow_psi0 = product_state_planar(
        [np.array([1.0, 0.0])] * NARROW_DRIFT_QUBITS, device)
    window2 = compile_circuit(brick, window=STREAM_WINDOWS[0])
    _, _, run_density, rho0 = density_runner(device)
    smc_src = smc_program(SMC_QUBITS)
    _, hmc_plans, hmc_counts, hmc_theta = hmc_ansatz(device)
    grad_lp = hmc.make_circuit_log_prob_planar(hmc_plans["paired"],
                                               hmc_counts, device=device)
    cases = {f"grover_{n}q": lambda: run(grover_psi0),
             f"brickwork_{n}q": lambda: apply_plan_planar(brick_psi0,
                                                          paired),
             f"brickwork_unpaired_{n}q": lambda: apply_plan_planar(
                 brick_psi0, unpaired),
             f"brickwork_{NARROW_DRIFT_QUBITS}q": lambda: apply_plan_planar(
                 narrow_psi0, narrow),
             f"brickwork_window{STREAM_WINDOWS[0]}_{n}q":
                 lambda: apply_plan_planar(brick_psi0, window2),
             f"density_{DENSITY_N}q": lambda: run_density(rho0),
             f"smc_{SMC_QUBITS}q": lambda: qbot_tpu_torch.run_lowered_ensemble(
                 lower_program(smc_src, mid_measure=True),
                 sample=SMC_PARTICLES, seed=0, device=device),
             f"value_and_grad_{HMC_QUBITS}q": lambda: hmc.value_and_grad(
                 grad_lp)(hmc_theta[0])}
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
        say(f"profile [{kernels.dot_mode()}] {name}: wall "
            f"{wall_ms:.3f} ms untraced, "
            f"{traced_ms:.3f} ms traced; device busy {busy_ms:.3f} ms, "
            f"busy share {busy_ms / traced_ms:.3f}; trace {trace}")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=12), flush=True)
        if name.startswith(("smc", "value_and_grad")):
            # a host-bound run: where its host time goes
            print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                            row_limit=12), flush=True)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", type=Path,
                        help="after the build, profile Grover, the "
                             "brickwork (paired and unpaired, at 23 "
                             "qubits, and at window=2), the density "
                             "run, the SMC program and a 24-qubit "
                             "value-and-gradient with "
                             "torch.profiler, write their traces to DIR, "
                             "and run no other phase")
    parser.add_argument("--precision", choices=kernels.DOT_MODES,
                        default="f32",
                        help="the dot mode of the --profile runs")
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
    for kernel, regs, spills in ptxas_report(lib.parent / "ptxas.log"):
        say(f"ptxas {kernel}: {regs} registers, {spills} bytes spill "
            f"stores")
    if args.profile is not None:
        kernels.set_dot_mode(args.precision)
        profile(N, device, args.profile)
        return 0

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    results.update(zip(WINDOW_KERNELS, check_window(N, device, rng, gen)))
    results["reflect_dot"], results["reflect_update"] = check_reflect(
        N, device, rng, gen)
    results.update(zip(PAIR_KERNELS, check_pair(N, device, rng, gen)))
    for mode in REDUCED_MODES:
        kernels.set_dot_mode(mode)
        results.update(zip(
            (counter(k, mode) for k in WINDOW_KERNELS),
            check_window(N, device, rng, gen, mode,
                         {k: results[k] for k in WINDOW_KERNELS})))
        results.update(zip(
            (counter(k, mode) for k in PAIR_KERNELS),
            check_pair(N, device, rng, gen, mode,
                       {k: results[k] for k in PAIR_KERNELS})))
    kernels.set_dot_mode("f32")
    say("phase 2: every kernel agrees with its plain version, in every dot "
        "mode")

    kernels.reset_launch_counts()
    run_examples(device)
    say("phase 3: programs agree with the dense interpreter")
    grover_rate, per_run = grover(N, GROVER_REPEATS, device)
    say("phase 4: Grover agrees with its closed form")
    brick_rates, brick_launches = brickwork(N, BRICKWORK_LAYERS, device)
    brickwork_drift(N, DRIFT_LAYERS, device)
    say("phase 5: brickwork, paired and unpaired, agrees with the plain "
        "versions and with itself; no norm drift over 256 layers, paired "
        "or unpaired")
    density_rate, density_launches = density(device)
    say("phase 6: the density matrix agrees with the plain versions and "
        "with ψψ†")
    counts = kernels.launch_counts()
    runs = {"grover": per_run, "brickwork": brick_launches["paired"],
            "brickwork_unpaired": brick_launches["unpaired"],
            "density": density_launches}
    say(f"launches on the main path: {counts}")

    f32_states = f32_references(N, device)
    kernels.reset_launch_counts()
    for mode in REDUCED_MODES:
        kernels.set_dot_mode(mode)
        for run, launches in reduced_mode_path(N, device, mode,
                                               f32_states).items():
            runs[f"{run}[{mode}]"] = launches
    kernels.set_dot_mode("f32")
    reduced_counts = kernels.launch_counts()
    del f32_states
    say(f"phase 7: the reduced dot modes run the main path; launches "
        f"{ {k: v for k, v in reduced_counts.items() if '[' in k} }")
    for name in KERNEL_SOURCES:
        if "[" in name:
            counts[name] = reduced_counts[name]

    kernels.reset_launch_counts()
    for mode in ("f32", *REDUCED_MODES):
        kernels.set_dot_mode(mode)
        for run, launches in narrow_path(device, mode).items():
            runs[run if mode == "f32" else f"{run}[{mode}]"] = launches
    kernels.set_dot_mode("f32")
    narrow_counts = kernels.launch_counts()
    for name in KERNEL_SOURCES:
        if name.split("[")[0] in NARROW_KERNELS:
            counts[name] = narrow_counts[name]
    say(f"phase 8: the brickwork at n = 1, 2 (mod 7) runs its narrow pairs "
        f"in every dot mode; launches "
        f"{ {k: v for k, v in narrow_counts.items() if v} }")

    kernels.reset_launch_counts()
    for mode in ("f32", *REDUCED_MODES):
        kernels.set_dot_mode(mode)
        for run, launches in stream_path(device, mode).items():
            runs[run if mode == "f32" else f"{run}[{mode}]"] = launches
    kernels.set_dot_mode("f32")
    stream_counts = kernels.launch_counts()
    for name in KERNEL_SOURCES:
        if name.split("[")[0] in STREAM_KERNELS:
            counts[name] = stream_counts[name]
    say(f"phase 9: the {N}-qubit brickwork at window = "
        f"{', '.join(map(str, STREAM_WINDOWS))} runs the streaming kernels "
        f"in every dot mode; launches "
        f"{ {k: v for k, v in stream_counts.items() if v} }")

    particle = {}
    for mode in ("f32", *REDUCED_MODES):
        kernels.set_dot_mode(mode)
        particle.update(check_particle_axis(N, device, rng, gen, mode))
        time_particle_axis(BATCH_TIMED_QUBITS, device, rng, gen, mode,
                           particle)
    kernels.set_dot_mode("f32")
    kernels.reset_launch_counts()
    ensemble_runs, ensemble_numbers, exact_smc = smc_path(device, card)
    ensemble_runs["grover_smc_20q"] = grover_smc(device)
    ensemble_runs["examples_ensemble"] = ensemble_examples(device)
    ensemble_counts = kernels.launch_counts()
    missing = [k for k in PHASE10_KERNELS if ensemble_counts[k] <= 0]
    if missing:
        raise AssertionError(f"phase 10 never launched {missing}")
    for name in KERNEL_SOURCES:
        counts[name] += ensemble_counts[name]
    runs.update(ensemble_runs)
    say(f"ensemble numbers: {json.dumps(ensemble_numbers)}")
    say(f"phase 10: every launcher serves a batch in one launch, bit for "
        f"bit its single launches, in every dot mode; the SMC and exact "
        f"ensembles, Grover under the particle axis and the examples with "
        f"--compile --ensemble agree with the plain versions; launches "
        f"{ {k: v for k, v in ensemble_counts.items() if v} }")

    kernels.reset_launch_counts()
    grad_runs, backward, grad_numbers = gradient_path(device, card)
    grad_counts = kernels.launch_counts()
    for name in KERNEL_SOURCES:
        counts[name] += grad_counts[name]
    runs.update(grad_runs)
    say(f"gradient numbers: {json.dumps(grad_numbers)}")
    say(f"phase 11: the {HMC_QUBITS}-qubit ansatz's and complex ansatz's "
        f"values and gradients through the kernels agree with the plain "
        f"versions in every dot mode, paired and unpaired, and with the "
        f"complex64 simulator; the "
        f"{GRAD_GROVER_QUBITS}-qubit Grover-in-the-loss gradient with the "
        f"plain versions; HMC and NUTS chains ran; backward launches "
        f"{ {k: v for k, v in backward.items() if v} }")
    kernels.reset_launch_counts()
    auto_runs, _ = auto_path(device, card)
    auto_counts = kernels.launch_counts()
    for name in KERNEL_SOURCES:
        counts[name] += auto_counts[name]
    runs.update(auto_runs)
    say(f"phase 12: window=\"auto\" picks, in every cell and dot mode, a "
        f"candidate within {AUTO_SLACK} x the best ranked candidate of "
        f"either engine on the card, its plan equal to that candidate's, "
        f"every candidate's state within its limit; launches "
        f"{ {k: v for k, v in auto_counts.items() if v} }")
    kernels.reset_launch_counts()
    dot_numbers = dot_path(device, gen, card)
    dot_counts = kernels.launch_counts()
    for name in KERNEL_SOURCES:
        counts[name] += dot_counts[name]
    say(f"phase 13: the dot engine runs the {N}-qubit brickwork and Grover, "
        f"and the density workload three ways, in every dot mode, within "
        f"its limits of the plain products and of the kernel engine; "
        f"f32_mix runs its per-window rule bit for bit; library products "
        f"{dot_numbers['products']}; kernel launches "
        f"{ {k: v for k, v in dot_counts.items() if v} }")
    shard_runs, shard_readings = sharded_path(device, card)
    shard_counts = _sum_launches([{"launches": v}
                                  for v in shard_runs.values()])
    for name in KERNEL_SOURCES:
        counts[name] += shard_counts.get(name, 0)
    runs.update(shard_runs)
    say("phase 14 readings: the exchanges ran over gloo and the host "
        "(gloo's copies through host memory and loopback TCP, every rank "
        "on this one card), not over NVLink or NCCL: their times say "
        f"nothing of a multi-GPU host ({card})")
    say(f"sharded numbers: {json.dumps(shard_readings)}")
    say(f"phase 14: the sharded register runs the {N}-qubit brickwork on "
        f"{' and '.join(map(str, SHARD_GLOO_SIZES))} gloo ranks and Grover "
        f"on 4 gloo ranks and 1 nccl rank within their limits of the "
        f"single-device kernel path and the closed form, the "
        f"{DENSITY_N}-qubit density body, discard and marginals on "
        f"{SHARD_DENSITY_SIZE}; kernel launches "
        f"{ {k: v for k, v in shard_counts.items() if v} }")
    mesh_runs, mesh_readings = mesh_path(device, card, exact_smc)
    mesh_counts = _sum_launches([{"launches": v}
                                 for v in mesh_runs.values()])
    for name in KERNEL_SOURCES:
        counts[name] += mesh_counts.get(name, 0)
    runs.update(mesh_runs)
    say("phase 15 readings: every rank shares this one card; samples/s at "
        "P > 1 is the card time-sliced between processes, not a scaling "
        f"figure; exchanges ran over gloo and the host ({card})")
    say(f"mesh numbers: {json.dumps(mesh_readings)}")
    say(f"phase 15: bench.py's SMC program at {MESH_QUBITS} qubits runs on "
        f"the 1x1 nccl, 2x1 and 2x2 gloo meshes, sampled within "
        f"{MESH_SIGMAS} sigma of the 2x2 exact fan-out, which is within "
        f"{MESH_EXACT_TOL:g} of the single-device one; the dry run on 2x2; "
        f"kernel launches {mesh_counts}")
    missing = [k for k in KERNEL_SOURCES if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    imported = [m for m in ("jax", "qbot_tpu") if m in sys.modules]
    if imported:
        raise AssertionError(f"the port imported {imported}")
    say(f"Grover {N}q: {grover_rate:.1f} gates/s; brickwork {N}q: "
        f"{brick_rates['paired']:.1f} gates/s paired, "
        f"{brick_rates['unpaired']:.1f} unpaired; density {DENSITY_N}q: "
        f"{density_rate:.1f} gates/s; SMC {SMC_QUBITS}q x {SMC_PARTICLES}: "
        f"{ensemble_numbers['smc_samples_per_s']:.2f} samples/s, peak "
        f"{ensemble_numbers['smc_peak_bytes'] / 2**30:.3f} GiB; exact "
        f"fan-out peak {ensemble_numbers['exact_peak_bytes'] / 2**30:.3f} "
        f"GiB ({card}); HMC {HMC_QUBITS}q x {HMC_CHAINS} chains: "
        f"{grad_numbers['hmc']['samples_per_s']:.3f} samples/s, "
        f"{grad_numbers['hmc']['gradients_per_s']:.2f} gradients/s, peak "
        f"{grad_numbers['hmc']['peak_bytes'] / 2**30:.3f} GiB")

    print(smi)
    print(json.dumps({"dot_engine": dot_numbers}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name],
         "launches_per_run": {k: v[name] for k, v in runs.items()
                              if v.get(name)},
         "max_abs_err": results[name]["max_abs_err"],
         "rel_l2": results[name]["rel_l2"], "ms": results[name]["ms"],
         "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"],
         "bound_by": results[name]["bound_by"],
         "library_ms": results[name]["library_ms"],
         "library_split_ms": results[name].get("library_split_ms"),
         "two_window_ms": results[name].get("two_window_ms"),
         "rel_l2_f64": results[name].get("rel_l2_f64"),
         "shapes": results[name]["shapes"],
         "particle_axis": particle[name],
         "backward_launches": backward.get(name, 0),
         "sharded_launches": {run: v[name] for run, v in shard_runs.items()
                              if v.get(name)},
         "mesh_launches": {run: v[name] for run, v in mesh_runs.items()
                           if v.get(name)}}
        for name, (src, rep) in KERNEL_SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
