"""Window-fusion circuit compiler.

Turns a :class:`~qbot_tpu_torch.tpu.circuit.Circuit` into a static plan of
window, pair, reflection, diagonal, phase, flip and contraction steps.  A
copy of the integer-window branch of ``qbot_tpu.tpu.compiler`` with its plan
dataclasses and passes (``qbot_tpu/tpu/compiler.py:45-182, 271-368,
498-971``); reflection detection folds window matrices with
:func:`fold_window_static`.

Windows are paired by default, as in ``qbot_tpu``: adjacent windows that
:func:`_pairable` accepts become one ``PairStep`` (one pass of the pair
kernel).  Plans equal ``qbot_tpu``'s ``compile_circuit(circ, window, pair,
partition)`` step for step, field for field, for both values of ``pair``
and both partitions; ``Plan.engine`` is ``"kernel"`` where the reference
says ``"pallas"``.

``window="auto"`` ranks the reference's candidates in the reference's order
(``qbot_tpu/tpu/compiler.py:474-535``): for each width 4..8 the dot
engine's plan (``partition="dot"``, :func:`dot_cost_model`), then, up to
width 7, the kernel engine's (:func:`plan_cost_model`).  Both models give
modelled device seconds on one H100: the sum over the plan's steps of what
the engine launches for each on a CUDA state (:func:`step_launches`: the
window and pair kernels by family and route, the two reflection kernels,
the PyTorch passes of diagonals, phases, flips and contractions that stand
alone; :func:`dot_step_launches`: a library product a window, by route and
dot mode, with its split and layout, and a pass for its flips and for each
of its phases).  A launch costs ``t0 + max(bytes / BW, ops / rate)``, more
for each phase a kernel fuses, with constants fitted per family and dot
mode to times measured on the card (``tools/fit_costs.py``, :data:`COSTS`).
The models read nothing but the plan and the mode, so a program compiles to
the same plan on the CPU and on the card.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np

from qbot_tpu_torch.ops.gates import controlled
from qbot_tpu_torch.tpu import kernels
from qbot_tpu_torch.tpu.circuit import Circuit, CircuitOp

__all__ = ["Term", "WindowStep", "DiagStep", "FlipStep", "PhaseStep",
           "ContractStep", "PairStep", "ReflectStep", "Plan",
           "compile_circuit", "auto_candidates", "plan_cost_model",
           "step_costs", "step_launches", "Launch", "AUTO_WIDTHS",
           "DOT_WIDTHS", "dot_cost_model", "dot_step_costs",
           "dot_step_launches",
           "expand_pairs", "expand_reflections",
           "expand_phases", "phase_as_diag", "gate_as_diag",
           "eigen_decompose_controlled", "decompose_spanning_swap"]

_LANE_LOG2 = 7     # width of the trailing window


@dataclass(frozen=True)
class Term:
    """One gate folded into a window: positions are window-relative axes."""
    positions: tuple[int, ...]
    matrix: Optional[np.ndarray]      # static (controls already folded in)
    param_idx: Optional[int] = None
    maker: Optional[Callable] = None
    num_controls: int = 0             # for param gates: wrap maker output


@dataclass(frozen=True)
class WindowStep:
    start: int                        # first qubit axis of the window
    width: int                        # window qubit count (dim = 2**width)
    terms: tuple[Term, ...]
    # basis-state sign flips applied BEFORE this window's unitary, fused
    # into the window kernel so they cost no extra HBM pass
    pre_flips: tuple[int, ...] = ()
    # controlled-phase factors applied BEFORE this window's unitary:
    # each (qubits, z) multiplies an amplitude by z when ALL the qubits
    # are 1 — fused into the window kernel as an in-register masked
    # complex multiply, so a cross-window CZ/CPhase costs no HBM pass
    pre_phases: tuple[tuple[tuple[int, ...], complex], ...] = ()


@dataclass(frozen=True)
class DiagStep:
    targets: tuple[int, ...]
    diag: np.ndarray                  # (2**len(targets),) phase vector


@dataclass(frozen=True)
class FlipStep:
    """Sign-flip of a single basis state (multi-controlled-Z): one scatter."""
    index: int


@dataclass(frozen=True)
class PhaseStep:
    """Multiply by ``phase`` every amplitude whose ``qubits`` bits equal
    the bits of ``pattern`` (bit k−1−j of ``pattern`` ↔ ``qubits[j]``,
    matching the diag-vector index convention).

    The normal form of any (multi-)controlled phase gate — in particular
    every cross-window CZ/CPhase left by the CX → H·CZ·H and controlled-U
    eigendecomposition rewrites (whose eigenvalue ordering may place the
    phase at any diag index, hence the pattern).  Never executed
    standalone on the hot path: ``_fuse_phases`` attaches it to the next
    window/pair kernel, where it costs a few in-register VPU ops instead
    of a full HBM pass (a standalone DiagStep pass measured 13 ms at
    26 qubits — as much as a fused 128×128 window matmul pass).
    """
    qubits: tuple[int, ...]
    phase: complex
    pattern: int = -1                     # -1 = all qubits 1


@dataclass(frozen=True)
class PairStep:
    """Two disjoint, qubit-contiguous windows applied in ONE HBM pass.

    The planar executor lowers this to a single Pallas kernel that
    left-multiplies ``first``'s unitary and contracts ``second``'s on the
    other axis of the same VMEM tile — halving state traffic versus two
    window passes.  Disjoint supports commute, so semantics equal applying
    ``first`` then ``second``.
    """
    first: WindowStep
    second: WindowStep


@dataclass(frozen=True)
class ReflectStep:
    """Householder reflection ``ψ → ψ − 2⟨v|ψ⟩v`` about a product state.

    Detected from the algebraic pattern ``A-layer · flip(idx) · A†-layer``
    (windows with inverse unitaries sandwiching a basis-state sign flip),
    which equals ``I − 2|v⟩⟨v|`` with ``v = A†|idx⟩`` — a PRODUCT of
    per-block vectors, so the whole two-layer sandwich collapses to one
    read pass (the ⟨v|ψ⟩ contraction) plus one read+write pass (the rank-1
    update), instead of 2× full window layers.  This is exactly Grover's
    diffusion operator, recognised structurally rather than special-cased.

    ``factors[i]`` is the complex vector for the i-th contiguous qubit
    block; blocks tile [0, n) in order.  ``original`` keeps the replaced
    steps for executors that cannot run reflections directly (density).

    ``pre_flips`` are basis-state sign flips applied BEFORE the reflection
    (a preceding oracle).  Because the reflection is a rank-1 update, a
    flipped basis state only shifts ⟨v|ψ⟩ by a scalar and the output at one
    index — so fused flips cost O(1) gather/scatter work instead of an HBM
    pass of their own.
    """
    factors: tuple[np.ndarray, ...]
    original: tuple = ()
    pre_flips: tuple[int, ...] = ()


@dataclass(frozen=True)
class ContractStep:
    targets: tuple[int, ...]          # includes controls (leading)
    matrix: Optional[np.ndarray]
    param_idx: Optional[int] = None
    maker: Optional[Callable] = None
    num_controls: int = 0


Step = Union[WindowStep, DiagStep, FlipStep, PhaseStep, ContractStep,
             PairStep, ReflectStep]


@dataclass
class Plan:
    n: int
    window: int
    steps: list[Step] = field(default_factory=list)
    num_params: int = 0
    gate_count: int = 0               # logical gates represented
    # the engine the auto-compiler ranked fastest for this plan: "kernel",
    # the window and pair kernels (qbot_tpu's "pallas"), or "dot", a
    # library product a window (tpu/dotplan.py); the runners honour it
    engine: str = "kernel"

    @property
    def num_passes(self) -> int:
        """Full-state HBM passes this plan costs (the perf figure of merit).

        ReflectStep costs 2 (⟨v|ψ⟩ read pass + rank-1 update pass);
        FlipStep costs 0 (an in-place single-element scatter); every other
        step reads and writes the state once.
        """
        total = 0
        for s in self.steps:
            if isinstance(s, ReflectStep):
                total += 2
            elif not isinstance(s, FlipStep):
                total += 1
        return total


def fold_window_static(step: WindowStep) -> Optional[np.ndarray]:
    """Fuse a window's terms into one complex matrix on the host.

    Returns None if any term is parameterised.
    """
    if any(t.matrix is None for t in step.terms):
        return None
    w, dim = step.width, 2**step.width
    W = np.eye(dim, dtype=np.complex128).reshape((2,) * w + (dim,))
    for term in step.terms:
        m = np.asarray(term.matrix, dtype=np.complex128)
        k = len(term.positions)
        g = m.reshape((2,) * (2 * k))
        W = np.tensordot(g, W, axes=(list(range(k, 2 * k)),
                                     list(term.positions)))
        W = np.moveaxis(W, list(range(k)), list(term.positions))
    return W.reshape(dim, dim)


def gate_as_diag(op: CircuitOp) -> Optional[CircuitOp]:
    """Normalise a diagonal (possibly controlled) gate op to a 'diag' op.

    A controlled diagonal gate is itself diagonal (identity on the
    non-triggered block), so e.g. a multi-controlled-Z over ALL qubits
    becomes one elementwise pass — and, on a sharded register, a purely
    local multiply with zero communication — instead of a full-space
    contraction.  Returns None when the op is not a static diagonal gate.
    """
    if op.kind != "gate" or op.matrix is None:
        return None
    m = np.asarray(op.matrix)
    if m.ndim != 2 or not np.allclose(m, np.diag(np.diag(m)),
                                      rtol=0.0, atol=1e-12):
        return None
    d = np.diag(m).astype(np.complex128)
    if op.controls:
        full = np.ones(2 ** len(op.controls + op.targets), np.complex128)
        full[-d.shape[0]:] = d
        d = full
    return CircuitOp("diag", tuple(op.controls) + tuple(op.targets), (), d)


_SWAP2 = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                   [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex)


def _unitary_eig(U: np.ndarray, atol: float = 1e-9):
    """Orthonormal eigendecomposition U = V diag(d) V† of a unitary.

    Every unitary is normal, hence unitarily diagonalizable — but
    ``np.linalg.eig`` does not return orthonormal eigenvectors for repeated
    eigenvalues, so diagonalize a random Hermitian combination of the
    commuting Hermitian/anti-Hermitian parts instead (their joint
    eigenbasis is U's); verify, retry with fresh coefficients on the
    measure-zero failure of a degenerate combination.
    """
    H = (U + U.conj().T) / 2
    S = (U - U.conj().T) / 2j
    rng = np.random.default_rng(0)
    for _ in range(4):
        t = rng.uniform(0.2, 0.8)
        _, V = np.linalg.eigh(t * H + (1 - t) * S)
        D = V.conj().T @ U @ V
        if np.allclose(D, np.diag(np.diag(D)), atol=atol):
            return np.diag(D), V
    return None, None


def eigen_decompose_controlled(op: CircuitOp) -> Optional[list[CircuitOp]]:
    """Rewrite a static controlled-U as  V† · controlled-diag · V.

    U = V diag(d) V† (unitaries are normal) gives
    ``C-U = (I⊗V) · C-diag(d) · (I⊗V†)`` — the V factors touch ONLY the
    target qubits and the controlled part becomes a *diagonal*, which costs
    one fused elementwise pass wherever it lands (and, on a sharded
    register, factors across shards with zero communication).  This removes
    the need to ever contract a controlled gate across windows or shards —
    the TPU-native replacement for the reference's full-space
    ``genMultiControlledGate`` conjugations (qgates.py:228-275).

    Returns None when the op is not a static controlled gate or the
    decomposition fails numerically (caller keeps the contraction path).
    """
    if op.kind != "gate" or op.matrix is None or not op.controls:
        return None
    U = np.asarray(op.matrix, np.complex128)
    d, V = _unitary_eig(U)
    if d is None:
        return None                      # pragma: no cover - retry exhausted
    full = np.ones(2 ** (len(op.controls) + len(op.targets)), np.complex128)
    full[-d.shape[0]:] = d
    out = []
    if not np.allclose(V, np.eye(V.shape[0]), atol=1e-12):
        out.append(CircuitOp("gate", op.targets, (), V.conj().T))
        out.append(CircuitOp("diag", tuple(op.controls) + tuple(op.targets),
                             (), full))
        out.append(CircuitOp("gate", op.targets, (), V))
    else:                                # U already diagonal
        out.append(CircuitOp("diag", tuple(op.controls) + tuple(op.targets),
                             (), full))
    return out


def decompose_spanning_swap(op: CircuitOp) -> Optional[list[CircuitOp]]:
    """A 2-qubit SWAP as 3 CXs (each then eigen-decomposes to H·CZ·H),
    for swaps spanning windows or shards."""
    if (op.kind != "gate" or op.matrix is None or op.controls
            or len(op.targets) != 2):
        return None
    if not np.allclose(np.asarray(op.matrix, complex), _SWAP2, atol=1e-12):
        return None
    a, b = op.targets
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    return [CircuitOp("gate", (b,), (a,), X),
            CircuitOp("gate", (a,), (b,), X),
            CircuitOp("gate", (b,), (a,), X)]


# ---------------------------------------------------------------------------
# window="auto": both engines' candidates ranked by the card's costs
# ---------------------------------------------------------------------------

AUTO_WIDTHS = (4, 5, 6, 7)     # qbot_tpu/tpu/compiler.py:489-494, "pallas"
DOT_WIDTHS = (4, 5, 6, 7, 8)   # :489-491, "dot"

# Per family and dot mode: (t0 seconds, bytes/s, ops/s, fraction a fused
# phase adds).  Fitted by tools/fit_costs.py to CUDA-event times of each
# launch through its tpu/kernels.py wrapper (t0 holds the wrapper's host
# time) at the geometries of widths 1..7 at 20, 23 and 26 qubits, on
# "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name, power.limit).
# f32_mix launches the f32 kernels and costs as f32; families without a
# mode run no products in a dot mode.  The dot engine's families
# (tpu/dotplan.py) come from a later run of the same tool, which also times
# the engine's launches at the dot partition's widths 4..8 on the same card:
# a library window by route (A = 1, middle, B = 1), its split and layout
# included, a window of f32_mix costing as the mode its width runs
# (dotplan.window_mode), and the masked pass of a real or a complex phase.
COSTS = {
    "window_tc": {"f32": (3.94e-05, 3.606e+12, 4.616e+13, 0.1212),
                  "bf16_3x": (4.055e-05, 3.428e+12, 9.884e+13, 0.05821),
                  "bf16": (3.992e-05, 3.606e+12, 1.621e+14, 0.02604)},
    "window_stream": {"f32": (3.868e-05, 3.516e+12, 7.058e+12, 0.0146),
                      "bf16_3x": (3.821e-05, 3.385e+12, 6.794e+12, 0.02124),
                      "bf16": (3.814e-05, 3.385e+12, 6.794e+12, 0.01245)},
    "pair_tc_middle": {"f32": (4.743e-05, 2.528e+12, 3.492e+13, 0.176),
                       "bf16_3x": (4.808e-05, 8.818e+11, 4.735e+13, 0.05603),
                       "bf16": (4.684e-05, 9.16e+11, 7.382e+13, 0.06481)},
    "pair_tc_trailing": {"f32": (4.473e-05, 5.444e+11, 4.015e+13, 0.04077),
                         "bf16_3x": (4.733e-05, 9.395e+11, 9.044e+13, 0.1672),
                         "bf16": (5.001e-05, 1.817e+12, 2.037e+14, 0.2943)},
    "pair_narrow": {"f32": (4.566e-05, 3.385e+12, 4.388e+13, 0.1974),
                    "bf16_3x": (4.449e-05, 2.528e+12, 9.515e+13, 0.2544),
                    "bf16": (4.021e-05, 3.3e+12, 1.522e+14, 0.3336)},
    "pair_stream": {"f32": (3.72e-05, 3.892e+12, 1.203e+13, 0),
                    "bf16_3x": (3.937e-05, 3.472e+12, 1.073e+13, 0),
                    "bf16": (3.71e-05, 3.746e+12, 1.173e+13, 0.003243)},
    "reflect_dot": {None: (0.0002599, 7.528e+12, np.inf, 0)},
    "reflect_update": {None: (4.813e-05, 3.058e+12, np.inf, 0)},
    "torch_diag": {None: (4.708e-05, 5.801e+11, np.inf, 0)},
    "torch_flip": {None: (2.808e-05, 3.794e+12, np.inf, 0)},
    "torch_contract": {None: (0.0002072, 2.744e+11, 1e+12, 0)},
    "dot_window_first": {"f32": (3.304e-05, 2.528e+12, 4.735e+13, 0),
                         "bf16_3x": (8.113e-05, 7.289e+11, 8.381e+13, 0),
                         "bf16": (4.814e-05, 2.403e+12, 3.097e+14, 0)},
    "dot_window_middle": {"f32": (0.0001215, 9.884e+11, 3.195e+13, 0),
                          "bf16_3x": (8.948e-05, 4.332e+11, 1.4e+13, 0),
                          "bf16": (5.675e-05, 1.094e+12, 3.536e+13, 0)},
    "dot_window_trailing": {"f32": (0.0001399, 6.586e+11, 4.224e+13, 0),
                            "bf16_3x": (6.517e-05, 4.332e+11, 2.779e+13, 0),
                            "bf16": (4.127e-05, 1.08e+12, 6.841e+13, 0)},
    "dot_phase_real": {None: (2.266e-05, 2.693e+12, np.inf, 0)},
    "dot_phase_complex": {None: (0.0001008, 7.289e+11, np.inf, 0)},
}
_COST_MODE = {"f32": "f32", "f32_mix": "f32", "bf16_3x": "bf16_3x",
              "bf16": "bf16"}


@dataclass(frozen=True)
class Launch:
    """One launch the planar executor makes for a step on a CUDA state: a
    kernel of :mod:`qbot_tpu_torch.tpu.kernels` or a PyTorch pass, by
    cost ``family``, with its geometry (window ``widths`` from ``start``;
    a reflection's ``widths`` is its tail factor's, a contraction's its
    target count) and its fused ``phases``."""
    family: str
    n: int
    start: int = 0
    widths: tuple[int, ...] = ()
    phases: int = 0

    @property
    def nbytes(self) -> float:
        """The planar float32 state read once and written once (read only
        by ``reflect_dot``)."""
        per_amp = 8 if self.family == "reflect_dot" else 16
        return float(per_amp * 2**self.n)

    @property
    def ops(self) -> float:
        """FLOPs of the complex products: 8·D an amplitude a window (the
        pairs' two, a contraction's 2^k), none for the other passes."""
        if self.family.startswith(("window", "pair", "dot_window")):
            return float(8 * sum(2**w for w in self.widths) * 2**self.n)
        if self.family == "torch_contract":
            return float(8 * 2**self.widths[0] * 2**self.n)
        return 0.0


def _window_launch(n: int, w: WindowStep, phases: int) -> Launch:
    return Launch(kernels.launch_family(n, w.start, w.width), n, w.start,
                  (w.width,), phases)


def step_launches(step: Step, n: int) -> list[Launch]:
    """What :func:`qbot_tpu_torch.tpu.planar.apply_plan_planar` launches for
    ``step`` on a CUDA state, as ``tpu/kernels.py`` routes it: a window or a
    pair on the kernel :func:`~qbot_tpu_torch.tpu.kernels.launch_family`
    names, a pair it runs as two windows (among them D1 >= 8 with D2 <= 4,
    which explicit ``partition="dot"`` plans hold) as those two; a
    reflection's two kernels; a PyTorch pass for a diagonal, a phase, a flip
    or a contraction that stands alone.  Fused flips cost nothing."""
    if isinstance(step, WindowStep):
        return [_window_launch(n, step, len(step.pre_phases))]
    if isinstance(step, PairStep):
        a, b = step.first, step.second
        phases = len(a.pre_phases)
        family = kernels.launch_family(n, a.start, a.width, b.width)
        if family == "two_windows":
            return [_window_launch(n, a, phases), _window_launch(n, b, 0)]
        return [Launch(family, n, a.start, (a.width, b.width), phases)]
    if isinstance(step, ReflectStep):
        tail = int(step.factors[-1].shape[0]).bit_length() - 1
        return [Launch("reflect_dot", n, n - tail, (tail,)),
                Launch("reflect_update", n, n - tail, (tail,))]
    if isinstance(step, (DiagStep, PhaseStep)):
        return [Launch("torch_diag", n)]
    if isinstance(step, FlipStep):
        return [Launch("torch_flip", n)]
    return [Launch("torch_contract", n, 0, (len(step.targets),))]


def launch_seconds(launch: Launch, mode: str = "f32") -> float:
    """Modelled seconds of one launch in dot ``mode`` on the card."""
    costs = COSTS[launch.family]
    t0, bw, rate, phase = costs.get(_COST_MODE[mode]) or costs[None]
    body = max(launch.nbytes / bw, launch.ops / rate)
    return t0 + body * (1.0 + phase * launch.phases)


def step_costs(plan: Plan, dot_mode: str = "f32") -> list[float]:
    """Modelled seconds of each of ``plan``'s steps in ``dot_mode``."""
    return [sum(launch_seconds(x, dot_mode)
                for x in step_launches(s, plan.n)) for s in plan.steps]


def plan_cost_model(plan: Plan, dot_mode: str = "f32") -> float:
    """Modelled device seconds of one run of ``plan`` on one H100 on the
    kernel engine: the sum of :func:`step_costs`
    (``qbot_tpu/tpu/compiler.py:441-471`` with the card's kernels and
    constants)."""
    return sum(step_costs(plan, dot_mode))


def dot_step_launches(step: Step, n: int) -> list[Launch]:
    """What :func:`qbot_tpu_torch.tpu.dotplan.apply_plan_dot` launches for
    ``step`` on a CUDA state: for each window (a pair's two), one pass for
    its fused flips, one masked pass for each of its phases, real or
    complex (``dotplan.phase_is_real``), and its library product by route
    (``dot_window_first`` at A = 1, ``dot_window_trailing`` at B = 1,
    ``dot_window_middle`` else); any other step as :func:`step_launches`
    has it, the same PyTorch passes and reflection kernels."""
    from qbot_tpu_torch.tpu.dotplan import phase_is_real

    if isinstance(step, PairStep):
        return (dot_step_launches(step.first, n)
                + dot_step_launches(step.second, n))
    if not isinstance(step, WindowStep):
        return step_launches(step, n)
    out = [Launch("torch_flip", n)] if step.pre_flips else []
    out += [Launch("dot_phase_real" if phase_is_real(z) else
                   "dot_phase_complex", n) for _, z, _ in step.pre_phases]
    route = ("first" if step.start == 0 else
             "trailing" if step.start + step.width == n else "middle")
    return out + [Launch(f"dot_window_{route}", n, step.start,
                         (step.width,))]


def dot_step_costs(plan: Plan, dot_mode: str = "f32") -> list[float]:
    """Modelled seconds of each of ``plan``'s steps on the dot engine in
    ``dot_mode``: a window of ``f32_mix`` costs as the mode its width runs
    (:func:`qbot_tpu_torch.tpu.dotplan.window_mode`)."""
    from qbot_tpu_torch.tpu.dotplan import window_mode

    def seconds(x: Launch) -> float:
        if x.family.startswith("dot_window"):
            return launch_seconds(x, window_mode(dot_mode, x.widths[0]))
        return launch_seconds(x, dot_mode)
    return [sum(map(seconds, dot_step_launches(s, plan.n)))
            for s in plan.steps]


def dot_cost_model(plan: Plan, dot_mode: str = "f32") -> float:
    """Modelled device seconds of one run of ``plan`` on the dot engine on
    one H100: the sum of :func:`dot_step_costs`
    (``qbot_tpu/tpu/compiler.py:394-438`` with the card's launches and
    constants)."""
    return sum(dot_step_costs(plan, dot_mode))


def auto_candidates(circ: Circuit, pair: bool = True,
                    mode: Optional[str] = None):
    """``(cost, plan, engine)`` of every candidate ``window="auto"`` ranks,
    in the reference's order (``qbot_tpu/tpu/compiler.py:474-495``): for
    each width of :data:`DOT_WIDTHS` the dot engine's plan
    (``partition="dot"``) under :func:`dot_cost_model`, then, for the widths
    of :data:`AUTO_WIDTHS`, the kernel engine's under
    :func:`plan_cost_model`, both in ``mode`` (default the current dot
    mode).  Widths that clamp at small n stay as duplicates, as in the
    reference."""
    if mode is None:
        mode = kernels.dot_mode()
    out = []
    for w in DOT_WIDTHS:
        cand = compile_circuit(circ, w, pair, partition="dot")
        out.append((dot_cost_model(cand, mode), cand, "dot"))
        if w in AUTO_WIDTHS:
            plan = compile_circuit(circ, w, pair)
            out.append((plan_cost_model(plan, mode), plan, "kernel"))
    return out


def compile_circuit(circ: Circuit, window: Union[int, str] = 7,
                    pair: bool = True, partition: str = "kernel") -> Plan:
    """Compile to a window-fused plan of windows of up to ``window``
    qubits (``qbot_tpu/tpu/compiler.py:498-694``), with adjacent windows
    paired when ``pair``.

    ``partition="dot"`` puts, at n >= 14, a 6-qubit window at [n-13, n-7)
    and the 7-qubit lane window at [n-7, n) and splits the front into
    ``window``-wide chunks, the remainder last (the reference's in-place
    positions for its dot engine); below 14 qubits, and with the default
    ``"kernel"`` partition (the reference's ``"pallas"``), the last window
    is min(n, 7) wide and the front splits end-aligned, the remainder
    first.  A width-8 window has no kernel: such a plan runs on the dot
    engine (``plan.engine = "dot"``).

    ``window="auto"`` keeps the first cheapest of :func:`auto_candidates`;
    a dot-engine pick gets ``engine = "dot"``, and one that the dot engine
    cannot lower re-ranks the kernel candidates alone (the reference's
    ``"auto_pallas"``)."""
    if window == "auto":
        candidates = auto_candidates(circ, pair)
        _, plan, engine = min(candidates, key=lambda c: c[0])
        if engine == "dot":
            from qbot_tpu_torch.tpu.dotplan import lower_dot_plan

            if lower_dot_plan(plan) is None:
                return min((c for c in candidates if c[2] == "kernel"),
                           key=lambda c: c[0])[1]
            plan.engine = "dot"
        return plan
    if not isinstance(window, int):
        raise ValueError(f"window must be an integer width or 'auto', "
                         f"got {window!r}")
    if partition not in ("kernel", "dot"):
        raise ValueError(f"partition must be 'kernel' or 'dot', got "
                         f"{partition!r}")
    n = circ.n
    w = min(window, n) if n else 1
    if partition == "dot" and n >= 14:
        sub = 6
        front = n - sub - _LANE_LOG2
        bounds = [(q, min(w, front - q)) for q in range(0, front, w)]
        bounds += [(front, sub), (front + sub, _LANE_LOG2)]
    else:
        # the last window has width min(n, 7); the front qubits split
        # end-aligned into windows of width w, the remainder first
        last_w = min(n, _LANE_LOG2)
        front = n - last_w
        rem = front % w
        bounds = ([(0, rem)] if rem else []) + [
            (rem + i * w, w) for i in range(front // w)]
        if last_w:
            bounds.append((front, last_w))
    group_of = [0] * n
    for gi, (start, width) in enumerate(bounds):
        for q in range(start, start + width):
            group_of[q] = gi

    plan = Plan(n=n, window=w, num_params=circ.num_params,
                gate_count=circ.gate_count)
    pending: dict[int, list[Term]] = {}
    pending_support: dict[int, set[int]] = {}

    def fold(gi: int, qubits, term: Term) -> None:
        pending.setdefault(gi, []).append(term)
        pending_support.setdefault(gi, set()).update(qubits)

    def flush(gi: int) -> None:
        terms = pending.pop(gi, None)
        pending_support.pop(gi, None)
        if terms:
            plan.steps.append(WindowStep(bounds[gi][0], bounds[gi][1],
                                         tuple(terms)))

    def flush_overlapping(qubits) -> None:
        # a pending window flushes before a spanning step only if its
        # terms share support with it: disjoint supports commute
        qs = set(qubits)
        for gi in sorted(g for g, sup in list(pending_support.items())
                         if sup & qs):
            flush(gi)

    def local(gi: int, qubits) -> tuple[int, ...]:
        return tuple(q - bounds[gi][0] for q in qubits)

    queue = deque(circ.ops)
    while queue:
        op = queue.popleft()
        dop = gate_as_diag(op)
        if dop is not None:
            op = dop
        if op.kind == "flip":
            flush_overlapping(op.targets)
            plan.steps.append(FlipStep(op.index))
            continue
        if op.kind == "diag":
            targets = op.targets
            gis = {group_of[q] for q in targets}
            if len(gis) == 1:
                gi = next(iter(gis))
                fold(gi, targets, Term(local(gi, targets),
                                       np.diag(op.matrix).astype(
                                           np.complex128)))
            else:
                d = np.asarray(op.matrix, np.complex128)
                flush_overlapping(targets)
                nontriv = np.flatnonzero(
                    ~np.isclose(d, 1.0, rtol=0.0, atol=1e-12))
                if (nontriv.shape[0] == 1
                        and abs(abs(d[nontriv[0]]) - 1.0) < 1e-12):
                    # controlled-phase normal form: fuses into the next
                    # window kernel instead of costing a pass
                    idx = int(nontriv[0])
                    plan.steps.append(
                        PhaseStep(targets, complex(d[idx]), idx))
                else:
                    plan.steps.append(DiagStep(targets, op.matrix))
            continue

        qubits = op.controls + op.targets
        gis = {group_of[q] for q in qubits}
        if op.matrix is not None:
            if len(gis) > 1:
                dec = (decompose_spanning_swap(op)
                       or eigen_decompose_controlled(op))
                if dec is not None:
                    queue.extendleft(reversed(dec))
                    continue
            mat = controlled(op.matrix, len(op.controls)) if op.controls \
                else op.matrix
            if len(gis) == 1:
                gi = next(iter(gis))
                fold(gi, qubits, Term(local(gi, qubits), mat))
            else:
                flush_overlapping(qubits)
                plan.steps.append(ContractStep(qubits, mat))
        else:
            if len(gis) == 1:
                gi = next(iter(gis))
                fold(gi, qubits, Term(local(gi, qubits), None,
                                      op.param_idx, op.maker,
                                      len(op.controls)))
            else:
                flush_overlapping(qubits)
                plan.steps.append(ContractStep(qubits, None, op.param_idx,
                                               op.maker, len(op.controls)))

    for gi in sorted(pending):
        flush(gi)
    plan.steps = merge_adjacent_diags(plan.steps)
    plan.steps = _detect_reflections(plan.steps, n)
    plan.steps = _fuse_phases(plan.steps)
    plan.steps = _fuse_flips(plan.steps)
    if pair:
        plan.steps = _pair_windows(plan.steps, n)
    return plan


def combine_diag_vectors(targets_a, diag_a, targets_b, diag_b, union):
    """Phase vector of diag_a·diag_b over the sorted union of their targets.

    Diagonals compose elementwise: each union index selects the bits of the
    two operand target subsets and multiplies the corresponding phases.
    """
    k = len(union)
    pos = {q: i for i, q in enumerate(union)}
    idx = np.arange(2**k)

    def sub_index(targets):
        s = np.zeros(2**k, dtype=np.int64)
        t = len(targets)
        for j, q in enumerate(targets):
            bit = (idx >> (k - 1 - pos[q])) & 1
            s |= bit << (t - 1 - j)
        return s

    va = np.asarray(diag_a, np.complex128)
    vb = np.asarray(diag_b, np.complex128)
    return va[sub_index(targets_a)] * vb[sub_index(targets_b)]


def merge_adjacent_diags(steps: list[Step], cap: int = 12) -> list[Step]:
    """Fuse runs of adjacent DiagSteps into one elementwise pass each.

    All diagonals commute, so adjacent DiagSteps combine exactly; the
    merged phase tensor is capped at 2^cap entries so a long run over many
    distinct qubits (e.g. a QFT's controlled-phase cascade) merges in
    chunks rather than materialising a 2^n constant.
    """
    out: list[Step] = []
    for step in steps:
        if (isinstance(step, DiagStep) and out
                and isinstance(out[-1], DiagStep)):
            prev = out[-1]
            union = tuple(sorted(set(prev.targets) | set(step.targets)))
            if len(union) <= cap:
                out[-1] = DiagStep(union, combine_diag_vectors(
                    prev.targets, prev.diag, step.targets, step.diag,
                    union))
                continue
        out.append(step)
    return out


def _detect_reflections(steps: list[Step], n: int) -> list[Step]:
    """Replace ``windows_A · flip(idx) · windows_B`` with a ReflectStep when
    B is the blockwise inverse of A (``qbot_tpu/tpu/compiler.py:752-817``).

    Windows on disjoint qubits commute, so matching is by (start, width)
    regardless of order within each run.
    """
    out: list[Step] = list(steps)
    i = 0
    while i < len(out):
        step = out[i]
        if not isinstance(step, FlipStep):
            i += 1
            continue
        a_lo = i
        while a_lo > 0 and isinstance(out[a_lo - 1], WindowStep):
            a_lo -= 1
        b_hi = i + 1
        while b_hi < len(out) and isinstance(out[b_hi], WindowStep):
            b_hi += 1
        a_run = out[a_lo:i]
        b_run = out[i + 1:b_hi]
        if not a_run or not b_run:
            i += 1
            continue
        a_by = {(w.start, w.width): w for w in a_run}
        b_by = {(w.start, w.width): w for w in b_run}
        if len(a_by) != len(a_run) or set(a_by) != set(b_by):
            i += 1
            continue
        mats = {}
        for key, wa in a_by.items():
            ma = fold_window_static(wa)
            mb = fold_window_static(b_by[key])
            if ma is None or mb is None or not np.allclose(
                    mb, ma.conj().T, atol=1e-9):
                break
            mats[key] = ma
        else:
            # v = A† |idx⟩, a product over blocks tiling [0, n): a window
            # block gives the conjugate of row idx_w of A_w, a gap block a
            # basis vector
            idx = step.index
            factors: list[np.ndarray] = []
            q = 0
            for start, width in sorted(a_by) + [(n, 0)]:
                if q < start:
                    gap = start - q
                    bits = (idx >> (n - start)) & ((1 << gap) - 1)
                    e = np.zeros(2**gap, np.complex128)
                    e[bits] = 1.0
                    factors.append(e)
                if width:
                    w_idx = (idx >> (n - start - width)) & ((1 << width) - 1)
                    factors.append(np.conj(mats[(start, width)][w_idx, :]))
                q = start + width
            out[a_lo:b_hi] = [ReflectStep(tuple(factors),
                                          tuple(out[a_lo:b_hi]))]
            i = a_lo + 1
            continue
        i += 1
    return out


def expand_reflections(steps):
    """Iterate steps with ReflectSteps expanded back to their window/flip
    form (for executors without a reflection fast path)."""
    for step in steps:
        if isinstance(step, ReflectStep):
            yield from step.original
        else:
            yield step


def _pairable(a: Step, b: Step, n: int) -> bool:
    """True when adjacent steps fuse into one Pallas pair-kernel pass.

    Requirements: both are windows, qubit-contiguous (``a`` immediately
    before ``b``, so the state views as (A, D1, D2, B) with no middle
    axis), ``b`` carries no pre-flips (a basis-state flip between the two
    unitaries would not commute with ``a``), and the geometry matches one
    of the two kernels: trailing pair (B == 1, any D1/D2 up to 128×128) or
    middle pair (B >= 128 with D1 <= 32 so the in-kernel row loop stays
    short).
    """
    if not (isinstance(a, WindowStep) and isinstance(b, WindowStep)):
        return False
    if a.start + a.width != b.start or b.pre_flips or b.pre_phases:
        return False
    if a.width + b.width > 14:          # fused tile beyond 128×128
        return False
    B = 2 ** (n - b.start - b.width)
    if B == 1:
        return True
    return B >= 128 and a.width <= 5


def _pair_windows(steps: list[Step], n: int) -> list[Step]:
    """Greedy left-to-right fusion of adjacent window steps into PairSteps."""
    out: list[Step] = []
    i = 0
    while i < len(steps):
        if i + 1 < len(steps) and _pairable(steps[i], steps[i + 1], n):
            out.append(PairStep(steps[i], steps[i + 1]))
            i += 2
        else:
            out.append(steps[i])
            i += 1
    return out


def expand_pairs(steps):
    """Iterate steps with PairSteps expanded to their two windows (for
    executors that gain nothing from pair fusion: complex/density/XLA)."""
    for step in steps:
        if isinstance(step, PairStep):
            yield step.first
            yield step.second
        else:
            yield step


def _fuse_phases(steps: list[Step]) -> list[Step]:
    """Attach each PhaseStep to the next WindowStep as a fused pre-phase.

    Controlled phases are diagonal, so consecutive ones commute with each
    other (and with FlipSteps) but not with a later unitary — each run of
    PhaseSteps may only fuse into the *first* subsequent window.  Phases
    with no fusable successor stay standalone (executors apply them as one
    masked elementwise pass).
    """
    out: list[Step] = []
    pending: list[PhaseStep] = []
    for step in steps:
        if isinstance(step, PhaseStep):
            pending.append(step)
            continue
        if pending and isinstance(step, WindowStep):
            step = WindowStep(
                step.start, step.width, step.terms, step.pre_flips,
                step.pre_phases + tuple((p.qubits, p.phase, p.pattern)
                                        for p in pending))
            pending.clear()
        elif pending and not isinstance(step, FlipStep):
            # flips are diagonal too: let a phase run pass over them so
            # both can fuse into the same following window
            out.extend(pending)
            pending.clear()
        out.append(step)
    out.extend(pending)
    return out


def phase_as_diag(step: PhaseStep) -> DiagStep:
    """Equivalent DiagStep (for executors without in-kernel phase fusion)."""
    k = len(step.qubits)
    d = np.ones(2**k, np.complex128)
    d[step.pattern if step.pattern >= 0 else 2**k - 1] = step.phase
    return DiagStep(tuple(step.qubits), d)


def expand_phases(steps):
    """Iterate steps with fused pre-phases re-materialised as DiagSteps
    (and standalone PhaseSteps converted), for executors that apply
    diagonals as their own pass (density / sharded / complex oracle)."""
    for step in steps:
        if isinstance(step, PhaseStep):
            yield phase_as_diag(step)
        elif isinstance(step, WindowStep) and step.pre_phases:
            for qubits, z, pat in step.pre_phases:
                yield phase_as_diag(PhaseStep(qubits, z, pat))
            yield WindowStep(step.start, step.width, step.terms,
                             step.pre_flips)
        elif isinstance(step, PairStep) and step.first.pre_phases:
            for qubits, z, pat in step.first.pre_phases:
                yield phase_as_diag(PhaseStep(qubits, z, pat))
            yield PairStep(WindowStep(step.first.start, step.first.width,
                                      step.first.terms,
                                      step.first.pre_flips),
                           step.second)
        else:
            yield step


def _fuse_flips(steps: list[Step]) -> list[Step]:
    """Attach each FlipStep to the next WindowStep or ReflectStep as a
    fused pre-flip.

    A flip does not commute with later steps, so it may only fuse into the
    *first* subsequent step; flips not followed by a fusable step stay
    standalone.  Fusing into a ReflectStep keeps the replaced original
    steps prefixed with the flips so ``expand_reflections`` stays exact.
    """
    out: list[Step] = []
    pending: list[int] = []
    for step in steps:
        if isinstance(step, FlipStep):
            pending.append(step.index)
            continue
        if pending and isinstance(step, WindowStep):
            step = WindowStep(step.start, step.width, step.terms,
                              step.pre_flips + tuple(pending),
                              step.pre_phases)
            pending.clear()
        elif pending and isinstance(step, ReflectStep):
            step = ReflectStep(
                step.factors,
                tuple(FlipStep(i) for i in pending) + tuple(step.original),
                step.pre_flips + tuple(pending))
            pending.clear()
        elif pending:
            out.extend(FlipStep(i) for i in pending)
            pending.clear()
        out.append(step)
    out.extend(FlipStep(i) for i in pending)
    return out
