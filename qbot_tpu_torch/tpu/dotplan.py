"""The dot engine: each window of a plan as one library matrix product.

Port of :mod:`qbot_tpu.tpu.dotplan`, the reference's second engine.  On the
TPU it runs each window as one XLA einsum; here each window is one library
product (cuBLAS through ``torch.mm`` / ``torch.bmm``) over the state's
planes, so the engine replaces XLA products, not Pallas kernels, and adds
no hand-written kernel.  :func:`lower_dot_plan` translates a plan's steps:
windows (a pair's two, after ``expand_pairs``), each with its fused flips
and phases applied as passes of their own before its product, as the
reference applies them; diagonals and standalone phases
(``phase_as_diag``); flips; reflections, on the reflection kernels of
:mod:`qbot_tpu_torch.tpu.kernels`, as the reference's run its kernels
(``qbot_tpu/tpu/dotplan.py:470-472``); contractions, as the planar
executor runs them.  Not ported, because it exists only for the TPU: the
reference's (8, 128) tiling layer (``_tail_split``, ``plan_tail_split``,
``window_spec``'s carrier views, ``_grouped_view_ok``, ``_DiagCarrier``,
``carrier_shape``, ``_flip_coords``); every pass here keeps the planar
``(2, 2^n)`` layout.

A window's products run in the dot mode of
:func:`qbot_tpu_torch.tpu.kernels.set_dot_mode` (:func:`dot_precision`):
``f32`` a float32 product with TF32 off; ``bf16_3x`` both operands split
as hi = bf16(x), lo = bf16(x − hi), summed hi·hi + hi·lo + lo·hi; ``bf16``
one product of the bf16-rounded operands.  ``f32_mix`` is the reference's
per-window rule (``qbot_tpu/tpu/dotplan.py:79-84, 291-292``): a window of
:data:`_MIX_WIDTH_MIN` qubits or more runs bf16_3x products, a narrower one
f32 (:func:`window_mode`), fixed when the plan is lowered.

Dispatch is by the state's device.  On a CUDA tensor each product is a
library call: in f32, one GEMM over the realified matrix at A = 1 (the
state's planes are its contracted axis as they lie), else four plane
products accumulated in place into the output, W broadcast over A; in the
reduced modes, the state split to bf16 in a layout whose contracted axis
is contiguous (bf16_3x stacks hi, lo, hi along it, against W's hi, hi,
lo), one bf16 product with float32 output (``out_dtype``), and the planes
put back.  A reduced product that PyTorch cannot run so raises; it never
becomes the float32 emulation.  On a CPU tensor, and through
:func:`apply_plan_dot_ref` on any device, reflections run the kernels'
plain versions and every product is computed as
``kernels._mode_bmm`` computes it (bf16 values carried in float32, float32
products), over the realified matrix and the state laid out (A, 2D, B),
or (1, 2D, A) when B = 1.  Library products are counted by the mode they
ran in (:func:`product_counts`), on a CUDA tensor only.

Every entry point takes the ``(2, 2^n)`` state or the ``(P, 2, 2^n)``
batch of :func:`qbot_tpu_torch.tpu.planar.apply_plan_planar`, out of
place, differentiable in the state and in ``params`` through PyTorch's
autograd.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from qbot_tpu_torch.tpu import kernels, planar
from qbot_tpu_torch.tpu.compiler import (
    ContractStep,
    DiagStep,
    FlipStep,
    PhaseStep,
    Plan,
    ReflectStep,
    Term,
    WindowStep,
    _fuse_phases,
    expand_pairs,
    expand_phases,
    expand_reflections,
    phase_as_diag,
)
from qbot_tpu_torch.utils import profiling

__all__ = ["DotPlan", "lower_dot_plan", "apply_plan_dot",
           "apply_plan_dot_ref", "make_dot_runner", "make_scanned_dot_runner",
           "density_plan_2n", "dot_precision", "window_mode", "phase_is_real",
           "reset_product_counts", "product_counts"]

# f32_mix's width threshold (qbot_tpu/tpu/dotplan.py:79-84): windows this
# wide or wider run bf16_3x products, narrower ones f32
_MIX_WIDTH_MIN = 7


def dot_precision(mode: Optional[str] = None) -> str:
    """The products of dot ``mode`` (default the current one) where
    f32_mix's per-window rule does not apply: ``f32`` and ``f32_mix`` run
    float32 products, ``bf16_3x`` and ``bf16`` their own
    (``qbot_tpu/tpu/dotplan.py:62-76``: HIGHEST, HIGHEST, HIGH, DEFAULT)."""
    mode = kernels.dot_mode() if mode is None else mode
    return {"f32": "f32", "f32_mix": "f32", "bf16_3x": "bf16_3x",
            "bf16": "bf16"}[mode]


def window_mode(mode: str, width: int) -> str:
    """The products a window ``width`` qubits wide runs in dot ``mode``:
    bf16_3x for f32_mix at :data:`_MIX_WIDTH_MIN` or more, else
    :func:`dot_precision`."""
    if mode == "f32_mix" and width >= _MIX_WIDTH_MIN:
        return "bf16_3x"
    return dot_precision(mode)


def phase_is_real(z) -> bool:
    """True when a phase takes the real pass: |Im z| < 1e-9, as the
    reference decides (``qbot_tpu/tpu/dotplan.py:234-239``; a CZ from the
    controlled eigendecomposition carries ~1e-16 of imaginary residue)."""
    return abs(complex(z).imag) < 1e-9


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Win:
    """One window product, after its flips and phases."""
    step: WindowStep                  # terms to fold (matrices, params)
    flips: tuple[int, ...]            # flat indices, applied before
    phases: tuple                     # (qubits, z, pattern), applied before
    mode: Optional[str] = None        # f32_mix's products for this window


@dataclass(frozen=True)
class _Diag:
    step: DiagStep


@dataclass(frozen=True)
class _Flip:
    index: int


@dataclass(frozen=True)
class _Contract:
    step: ContractStep


@dataclass(frozen=True)
class _Reflect:
    step: ReflectStep


@dataclass
class DotPlan:
    n: int
    num_params: int
    steps: list


def lower_dot_plan(plan: Plan) -> Optional[DotPlan]:
    """Translate a plan's steps for the dot engine
    (``qbot_tpu/tpu/dotplan.py:263-345``): windows after ``expand_pairs``,
    each with its flips and its phases (a phase with |Im z| < 1e-9 made
    real, :func:`phase_is_real`) and, when the current dot mode is
    f32_mix, the products of its width (:func:`window_mode`); diagonals
    and standalone phases as diagonals; flips; reflections; contractions
    (at any n and any targets: the reference lowers only qubit-contiguous
    ones above 13 qubits, a tiling limit of the TPU).  Returns None only
    for a step of a kind it does not know; every step ``compile_circuit``
    emits lowers."""
    mix = kernels.dot_mode() == "f32_mix"
    steps: list = []
    for s in expand_pairs(plan.steps):
        if isinstance(s, WindowStep):
            phases = tuple(
                (tuple(q), complex(complex(z).real, 0.0) if phase_is_real(z)
                 else complex(z), pattern)
                for q, z, pattern in s.pre_phases)
            steps.append(_Win(s, tuple(int(m) for m in s.pre_flips), phases,
                              "bf16_3x" if mix and s.width >= _MIX_WIDTH_MIN
                              else None))
        elif isinstance(s, FlipStep):
            steps.append(_Flip(s.index))
        elif isinstance(s, (PhaseStep, DiagStep)):
            steps.append(_Diag(phase_as_diag(s) if isinstance(s, PhaseStep)
                               else s))
        elif isinstance(s, ReflectStep):
            steps.append(_Reflect(s))
        elif isinstance(s, ContractStep):
            steps.append(_Contract(s))
        else:
            return None
    return DotPlan(n=plan.n, num_params=plan.num_params, steps=steps)


# ---------------------------------------------------------------------------
# a window's product: out[x, a, i, b] = Σ_{c, j} M[x·D + i, c·D + j] ·
# psi[c, a, j, b], M the realified (2D, 2D) matrix [[Wr, −Wi], [Wi, Wr]]
# ---------------------------------------------------------------------------

def _realify(w: torch.Tensor) -> torch.Tensor:
    """The (2D, 2D) real block form of a planar (2, D, D) matrix."""
    return torch.cat([torch.cat([w[0], -w[1]], 1),
                      torch.cat([w[1], w[0]], 1)], 0)


# the products are keys of the program's one counter table
_products = profiling.COUNTS
_PRODUCT = "dot_window["


def reset_product_counts() -> None:
    for name in [k for k in _products if k.startswith(_PRODUCT)]:
        del _products[name]


def product_counts() -> dict:
    """Library products since the last reset, by the mode they ran in
    (``dot_window[f32]``, ``dot_window[bf16_3x]``, ``dot_window[bf16]``),
    on CUDA tensors only."""
    return {k: v for k, v in _products.items() if k.startswith(_PRODUCT)}


def _per_particle(window):
    """``window`` over one state, mapped over the particles of a batch."""
    def apply(psi, A, D, B, m, mode):
        if psi.dim() == 3:
            return torch.stack([window(p, A, D, B, m, mode) for p in psi])
        return window(psi, A, D, B, m, mode)
    return apply


@_per_particle
def _plain_window(psi, A: int, D: int, B: int, m, mode: str):
    """A window's product as ``kernels._mode_bmm`` computes it, over the
    realified matrix ``m`` and the state laid out (A, 2D, B), or
    (1, 2D, A) when B = 1 and A > 1 (one product of 2D rows)."""
    with kernels._fp32_matmul():
        if B == 1 and A > 1:
            x = psi.reshape(2, A, D).transpose(1, 2).reshape(1, 2 * D, A)
            y = kernels._mode_bmm(m, x, mode)
            return y.reshape(2, D, A).transpose(1, 2).reshape(psi.shape)
        x = psi.reshape(2, A, D, B).transpose(0, 1).reshape(A, 2 * D, B)
        y = kernels._mode_bmm(m, x, mode)
        return y.reshape(A, 2, D, B).transpose(0, 1).reshape(psi.shape)


def _f32_library(psi, A: int, D: int, B: int, m):
    """The f32 product through cuBLAS, TF32 off: one GEMM at A = 1; else
    out[x] = M[x, 0]·psi[0] + M[x, 1]·psi[1], the second product
    accumulated into the first's output (beta = 1), W broadcast over A
    (``mm``/``addmm`` at B = 1, ``bmm``/``baddbmm`` else)."""
    with kernels._fp32_matmul():
        if A == 1:
            return (m @ psi.reshape(2 * D, B)).reshape(psi.shape)

        def block(x, c):
            return m[x * D:(x + 1) * D, c * D:(c + 1) * D]
        if B == 1:
            p = psi.reshape(2, A, D)

            def operands(x, c):
                return p[c], block(x, c).t()
            first, accumulate = torch.mm, "addmm"
        else:
            p = psi.reshape(2, A, D, B)

            def operands(x, c):
                return block(x, c).expand(A, D, D), p[c]
            first, accumulate = torch.bmm, "baddbmm"
        if kernels._needs_grad(psi, m):
            add = getattr(torch, accumulate)
            return torch.stack([add(first(*operands(x, 0)), *operands(x, 1))
                                for x in (0, 1)]).reshape(psi.shape)
        out = torch.empty_like(p)
        for x in (0, 1):
            first(*operands(x, 0), out=out[x])
            getattr(out[x], accumulate + "_")(*operands(x, 1))
        return out.reshape(psi.shape)


def _split_state(v, mode: str):
    """The bf16 operand of a (A, 2, D, B) view of the state: (A, 2D, B),
    hi = bf16(x) (bf16), or hi, lo = bf16(x − hi), hi stacked along the
    contracted axis, (A, 6D, B) (bf16_3x)."""
    A, _, D, B = v.shape
    parts = 3 if mode == "bf16_3x" else 1
    x = torch.empty((A, parts, 2, D, B), dtype=torch.bfloat16,
                    device=v.device)
    x[:, 0].copy_(v)
    if parts == 3:
        x[:, 1].copy_(v - x[:, 0])
        x[:, 2].copy_(x[:, 0])
    return x.reshape(A, parts * 2 * D, B)


def _split_matrix(m, mode: str):
    """The bf16 operand of the realified matrix: bf16(M) (bf16), or
    [hi | hi | lo] (2D, 6D) against the state's hi, lo, hi (bf16_3x)."""
    hi = m.to(torch.bfloat16)
    if mode == "bf16":
        return hi
    lo = (m - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, hi, lo], 1)


@_per_particle
def _library_window(psi, A: int, D: int, B: int, m, mode: str):
    """A window's product through the library on a CUDA state: f32 as
    :func:`_f32_library`; a reduced mode one bf16 product with float32
    output of ``m`` (:func:`_split_matrix`) and the split state
    (:func:`_split_state`), the planes put back after it."""
    name = f"{_PRODUCT}{mode}]"
    _products[name] = _products.get(name, 0) + 1
    if mode == "f32":
        return _f32_library(psi, A, D, B, m)
    x = _split_state(psi.reshape(2, A, D, B).transpose(0, 1), mode)
    if A == 1:
        y = torch.mm(m, x[0], out_dtype=torch.float32)
    elif B == 1:
        y = torch.mm(x[..., 0], m.t(), out_dtype=torch.float32)
    else:
        y = torch.bmm(m.expand(A, *m.shape), x, out_dtype=torch.float32)
    return y.reshape(A, 2, D, B).transpose(0, 1).reshape(psi.shape)


class _Route(NamedTuple):
    """How a device runs a window: the operand a mode's product takes of
    the realified matrix, and the product."""
    operand: Callable
    window: Callable
    reflect: planar._Ops


_PLAIN = _Route(lambda m, mode: m, _plain_window, planar._PLAIN)
_LIBRARY = _Route(lambda m, mode: m if mode == "f32" else
                  _split_matrix(m, mode), _library_window, planar._KERNELS)


def _on_card(device) -> bool:
    """True for a CUDA device (library products), False for the CPU (the
    plain products); anything else raises."""
    kind = torch.device(device).type
    kernels._require(kind in ("cuda", "cpu"), f"unsupported device "
                     f"{device}: CUDA or CPU only")
    return kind == "cuda"


# ---------------------------------------------------------------------------
# steps: each prepares its device tables once
# ---------------------------------------------------------------------------

def _flip_fn(flips, device):
    """The flips of a window in one pass (an index listed twice flips
    back), or None."""
    odd = sorted(m for m, k in Counter(flips).items() if k % 2)
    if not odd:
        return None
    idx = torch.tensor(odd, dtype=torch.int64, device=device)
    return lambda psi: psi.index_copy(-1, idx, -psi.index_select(-1, idx))


def _phase_fn(n: int, phase, device):
    """One fused phase as a masked pass (``qbot_tpu/tpu/dotplan.py:352-376``):
    the factor 1 + (re − 1)·mask, rounded as the reference forms it, and
    for a complex phase im·mask, over a view of the state that keeps each
    of the phase's qubits as an axis."""
    qubits, z, pattern = phase
    k = len(qubits)
    shape, axes, _ = planar._grouped_view(n, qubits)
    bits = pattern if pattern >= 0 else 2**k - 1
    mask = np.zeros((2,) * k, np.float32)
    mask[tuple((bits >> (k - 1 - j)) & 1 for j in range(k))] = 1.0
    mask = np.transpose(mask, np.argsort(axes))
    bshape = [2 if i in axes else 1 for i in range(len(shape))]
    mask = torch.from_numpy(np.ascontiguousarray(mask)).reshape(bshape)
    re = float(np.float32(np.float32(z.real) - np.float32(1.0)))
    fr = (1.0 + re * mask).to(device)
    fi = (float(np.float32(z.imag)) * mask).to(device)

    def real(psi):
        t = psi.reshape(*psi.shape[:-1], *shape)
        return (t * fr).reshape(psi.shape)

    def rotate(psi):
        pl, pr, pi = planar._planes(psi, shape)
        return torch.stack([pr * fr - pi * fi, pr * fi + pi * fr],
                           dim=pl).reshape(psi.shape)
    return real if z.imag == 0.0 else rotate


def _window_fn(n: int, s: _Win, device, route: _Route):
    """``(psi, params, prescale) -> psi`` of one window: its flips, its
    phases, then its product; ``prescale`` scales the realified matrix
    before it is split.  A static window's matrix is folded, realified
    and split once per mode."""
    start, width = s.step.start, s.step.width
    A, D, B = 2**start, 2**width, 2**(n - start - width)
    flip = _flip_fn(s.flips, device)
    phases = [_phase_fn(n, ph, device) for ph in s.phases]
    table = planar._window_tables(s.step, device)
    static = all(t.matrix is not None for t in s.step.terms)
    split: dict = {}

    def operand(params, prescale, mode):
        if static and prescale is None:
            if mode not in split:
                split[mode] = route.operand(_realify(table(None)), mode)
            return split[mode]
        m = _realify(table(params))
        if prescale is not None:
            m = m * prescale
        return route.operand(m, mode)

    def apply(psi, params, prescale=None):
        if flip is not None:
            psi = flip(psi)
        for phase in phases:
            psi = phase(psi)
        mode = s.mode or dot_precision()
        return route.window(psi, A, D, B, operand(params, prescale, mode),
                            mode)
    return apply


def _step_fns(lowered: DotPlan, device, route: _Route) -> list:
    """(takes a prescale, fn) of each lowered step on ``device``."""
    n = lowered.n
    fns = []
    for s in lowered.steps:
        if isinstance(s, _Win):
            fns.append((True, _window_fn(n, s, device, route)))
            continue
        if isinstance(s, _Diag):
            fn = planar._diag_fn(n, s.step.targets, s.step.diag, device)
        elif isinstance(s, _Flip):
            fn = planar._flip_fn(s.index)
        elif isinstance(s, _Reflect):
            fn = planar._reflect_fn(s.step, device, route.reflect)
        else:
            fn = planar._contract_fn(n, s.step, device)
        fns.append((False, fn))
    return fns


def _engine_fns(lowered: DotPlan, device) -> list:
    return _step_fns(lowered, device,
                     _LIBRARY if _on_card(device) else _PLAIN)


def _run(psi, fns, params=None, prescale=None):
    params = planar._as_params(params, psi.device)
    for takes_prescale, fn in fns:
        if takes_prescale:
            psi = fn(psi, params, prescale)
            prescale = None
        else:
            psi = fn(psi, params)
    if prescale is not None:          # no window took it
        psi = psi * prescale
    return psi


def apply_plan_dot(psi: torch.Tensor, lowered: DotPlan, params=None,
                   prescale=None) -> torch.Tensor:
    """Run a lowered plan on the dot engine over a planar (2, 2^n) float32
    state, or over each state of a (P, 2, 2^n) batch
    (``qbot_tpu/tpu/dotplan.py:399-479``): on a CUDA tensor the library
    products, on a CPU tensor the plain ones.  ``params`` as in
    :func:`qbot_tpu_torch.tpu.planar.apply_plan_planar`; ``prescale``, a
    scalar, scales the first window's realified matrix before its split
    (the state, when no window takes it).  Differentiable in ``psi`` and
    ``params``."""
    return _run(psi, _engine_fns(lowered, psi.device), params, prescale)


def apply_plan_dot_ref(psi: torch.Tensor, lowered: DotPlan, params=None,
                       prescale=None) -> torch.Tensor:
    """:func:`apply_plan_dot` with every product computed as the CPU
    computes it (``kernels._mode_bmm``'s arithmetic) and the reflections
    through the kernels' plain versions, on any device: what the library
    route is held against on the card."""
    return _run(psi, _step_fns(lowered, psi.device, _PLAIN), params,
                prescale)


def make_dot_runner(lowered: DotPlan):
    """``run(psi, params=None)``: :func:`apply_plan_dot` with the steps'
    tables (folded, realified and split matrices, masks, flips) prepared
    once per device."""
    prepared = planar._Prepared(lambda device: _engine_fns(lowered, device))

    def run(psi: torch.Tensor, params=None) -> torch.Tensor:
        return _run(psi, prepared(psi.device), params)
    return run


def _inv_norm(psi: torch.Tensor) -> torch.Tensor:
    """1/√⟨ψ|ψ⟩ of one state, the norm summed in float64."""
    norm2 = torch.sum(torch.square(psi), dtype=torch.float64)
    return torch.rsqrt(norm2).to(psi.dtype)


def make_scanned_dot_runner(plan: Plan, repeats: int,
                            init_plan: Optional[Plan] = None,
                            renorm_every: int = 0):
    """``run(psi, params=None)`` applying ``init_plan`` once, then ``plan``
    ``repeats`` times on the dot engine (``qbot_tpu/tpu/dotplan.py:
    549-609``), or None when ``plan`` does not lower.  The init runs on the
    dot engine too where it lowers, else on the planar runner.  The steps
    are prepared once per device, the static windows' matrices split once.

    ``renorm_every=k`` (one state, not a batch) renormalises after every
    k-th body without a pass of its own: the norm of that body's output is
    summed (in float64) and 1/√norm folds into the next body's first
    window matrix (``prescale``); the last pending correction lands on
    exit, so the result is renormalised."""
    lowered = lower_dot_plan(plan)
    if lowered is None:
        return None
    init = None
    if init_plan is not None:
        init_lowered = lower_dot_plan(init_plan)
        init = (planar.make_planar_runner(init_plan) if init_lowered is None
                else make_dot_runner(init_lowered))
    body = planar._Prepared(lambda device: _engine_fns(lowered, device))

    def run(psi: torch.Tensor, params=None) -> torch.Tensor:
        if renorm_every and psi.dim() != 2:
            raise ValueError("renorm_every renormalises one (2, 2^n) state, "
                             f"got shape {tuple(psi.shape)}")
        if init is not None:
            psi = init(psi, params)
        fns = body(psi.device)
        c = None
        for i in range(repeats):
            psi = _run(psi, fns, params, prescale=c)
            c = (_inv_norm(psi) if renorm_every
                 and (i + 1) % renorm_every == 0 else None)
        return psi if c is None else psi * c
    return run


# ---------------------------------------------------------------------------
# density matrices: G ρ G† as a 2n-qubit statevector plan
# ---------------------------------------------------------------------------

def _conj_maker(maker):
    """A planar (2, d, d) gate maker's conjugate gate."""
    def conj(theta):
        stacked = maker(theta)
        return torch.stack([stacked[0], -stacked[1]])
    return conj


def density_plan_2n(plan: Plan) -> Optional[Plan]:
    """The 2n-qubit statevector plan computing ``G ρ G†``
    (``qbot_tpu/tpu/dotplan.py:481-546``).

    ρ flat, as the density executor views it, is a 2n-qubit planar state:
    each step applies to the row axes [0, n) as it is and to the column
    axes [n, 2n) conjugated.  A flipped basis state m negates row m and
    column m: two phases of −1, which fuse into the next window as masked
    passes.  Fused phases and reflections are expanded first.  The plan
    runs on the dot engine (``engine = "dot"``)."""
    n = plan.n
    big = Plan(n=2 * n, window=plan.window, num_params=plan.num_params,
               gate_count=plan.gate_count, engine="dot")
    rows = tuple(range(n))
    cols = tuple(range(n, 2 * n))

    def flip_phases(index: int):
        return [PhaseStep(rows, -1.0 + 0.0j, index),
                PhaseStep(cols, -1.0 + 0.0j, index)]

    def conj_term(t: Term) -> Term:
        return Term(t.positions,
                    None if t.matrix is None else np.conj(
                        np.asarray(t.matrix)),
                    t.param_idx,
                    None if t.maker is None else _conj_maker(t.maker),
                    t.num_controls)

    for step in expand_pairs(expand_phases(expand_reflections(plan.steps))):
        if isinstance(step, WindowStep):
            for m in step.pre_flips:
                big.steps.extend(flip_phases(m))
            big.steps.append(WindowStep(step.start, step.width, step.terms))
            big.steps.append(WindowStep(n + step.start, step.width,
                                        tuple(conj_term(t)
                                              for t in step.terms)))
        elif isinstance(step, DiagStep):
            big.steps.append(step)
            big.steps.append(DiagStep(tuple(n + q for q in step.targets),
                                      np.conj(np.asarray(step.diag))))
        elif isinstance(step, FlipStep):
            big.steps.extend(flip_phases(step.index))
        elif isinstance(step, ContractStep):
            big.steps.append(step)
            big.steps.append(ContractStep(
                tuple(n + q for q in step.targets),
                None if step.matrix is None else np.conj(
                    np.asarray(step.matrix)),
                step.param_idx,
                None if step.maker is None else _conj_maker(step.maker),
                step.num_controls))
        else:
            return None
    big.steps = _fuse_phases(big.steps)
    return big
