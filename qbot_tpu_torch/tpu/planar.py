"""Planar statevector and density-matrix executors on PyTorch.

Port of :mod:`qbot_tpu.tpu.planar`.  A state is a float32 tensor of shape
``(2, 2^n)`` holding (real, imag) planes, a density matrix one of shape
``(2, 2^n, 2^n)``, on any device; every entry point takes or returns
tensors on the caller's device.  The statevector executor also takes a
batch of states with a leading particle axis, ``(P, 2, 2^n)`` (the
ensemble executor's layout; the reference runs ``apply_plan_planar`` under
``jax.vmap`` over it): every step serves the whole batch at once, each
kernel in one launch.  Window, pair and reflection steps go
through the kernels of :mod:`qbot_tpu_torch.tpu.kernels`; diagonal, phase,
flip and contraction steps are plain PyTorch, as they are XLA outside
Pallas in the JAX package.  Every step is out of place: the caller's state
is never written.

The window and pair products run in the dot mode of
:func:`qbot_tpu_torch.tpu.kernels.set_dot_mode` (the CLI's
``--precision``); the reduced modes shrink the norm a little every pass,
and :func:`make_scanned_planar_runner`'s ``renorm_every`` renormalises.

Parameterised gates (``Circuit.prx/pry/prz``, ``param_gate``) take their
angles from ``params``, a 1-D tensor on the state's device: their windows
fold per call (:func:`fold_window_planar`), with autograd, and every
window, pair and reflection step is differentiable through the kernels'
``torch.autograd.Function``s, whose backward runs the same kernels with
W† (:mod:`qbot_tpu_torch.tpu.kernels`; the reflection's below).
:func:`make_planar_runner` prepares the static steps once per device.

A plan whose ``engine`` is ``"dot"`` (``window="auto"`` ranked the dot
engine fastest, ``qbot_tpu/tpu/planar.py:496-501, 578-588, 778-784``) runs
on :mod:`qbot_tpu_torch.tpu.dotplan` instead, a library product a window,
through every entry point below: a density plan through its 2n-qubit
statevector plan (``dotplan.density_plan_2n``), a scanned body through
``dotplan.make_scanned_dot_runner``.  The kernel engine runs ``f32_mix`` in
full float32, as the reference's kernels do; the dot engine runs its
per-window rule.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from qbot_tpu_torch.tpu import kernels
from qbot_tpu_torch.tpu.compiler import (
    ContractStep,
    DiagStep,
    FlipStep,
    PairStep,
    PhaseStep,
    Plan,
    ReflectStep,
    WindowStep,
    expand_reflections,
    fold_window_static,
    phase_as_diag,
)
from qbot_tpu_torch.tpu.kernels import _fp32_matmul
from qbot_tpu_torch.utils import profiling

__all__ = ["zero_state_planar", "to_planar", "from_planar",
           "product_state_planar", "fold_window_static",
           "fold_window_planar", "apply_plan_planar",
           "apply_plan_planar_ref", "make_planar_runner",
           "make_scanned_planar_runner", "planar_probs", "planar_norm",
           "zero_density_planar", "product_density_planar",
           "apply_plan_density_planar",
           "apply_plan_density_planar_ref", "make_planar_density_runner",
           "planar_density_probs"]

REAL_DTYPE = torch.float32

# ---------------------------------------------------------------------------
# states
# ---------------------------------------------------------------------------

def product_state_planar(kets, device) -> torch.Tensor:
    """Planar (2, 2^n) normalised product state ⊗kets, built on ``device``.

    Each ket goes to the device as it is (a few amplitudes, or one ket that
    lowering already materialised on the host); the Kronecker products and
    the normalisation run on the device, so no 2^n array is built on the
    host.
    """
    r = torch.ones(1, dtype=REAL_DTYPE, device=device)
    i = torch.zeros(1, dtype=REAL_DTYPE, device=device)
    for k in kets:
        k = np.asarray(k, np.complex128).ravel()
        pk = profiling.upload(to_planar(k), device)
        br, bi = pk[0], pk[1]
        r, i = ((r[:, None] * br[None, :] - i[:, None] * bi[None, :])
                .reshape(-1),
                (r[:, None] * bi[None, :] + i[:, None] * br[None, :])
                .reshape(-1))
    nrm = torch.sqrt(torch.sum(r * r + i * i))
    return torch.stack([r, i]) / nrm


def zero_state_planar(n: int, device) -> torch.Tensor:
    psi = torch.zeros((2, 2**n), dtype=REAL_DTYPE, device=device)
    psi[0, 0] = 1.0         # a copy of a host scalar: it waits for the card
    profiling.count("host_syncs")
    return psi


def to_planar(psi_complex: np.ndarray, dtype=np.float32) -> np.ndarray:
    return np.stack([np.real(psi_complex),
                     np.imag(psi_complex)]).astype(dtype)


def from_planar(psi) -> np.ndarray:
    """Complex numpy vector of a planar state (tensor or array)."""
    if isinstance(psi, torch.Tensor):
        psi = psi.detach().cpu().numpy()
    psi = np.asarray(psi)
    return psi[0] + 1j * psi[1]


def _planar_tensor(mat, device) -> torch.Tensor:
    return profiling.upload(to_planar(np.asarray(mat, np.complex128)),
                            device)


def _grouped_view(n: int, qubits):
    """View of a 2^n axis that keeps each of ``qubits`` as its own size-2
    axis and merges the runs of other qubits between them.

    Returns (shape, axis of each qubit in ``qubits`` order, axes of the
    merged runs).  Keeps tensors far below PyTorch's dimension limits at
    any n, where a (2,)*n view would not.
    """
    shape, axis_of, rest = [], {}, []
    pos = 0
    for q in sorted(qubits):
        if q > pos:
            rest.append(len(shape))
            shape.append(2 ** (q - pos))
        axis_of[q] = len(shape)
        shape.append(2)
        pos = q + 1
    if pos < n:
        rest.append(len(shape))
        shape.append(2 ** (n - pos))
    return shape, [axis_of[q] for q in qubits], rest


# ---------------------------------------------------------------------------
# parameterised terms: qbot_tpu/tpu/planar.py:164-217, folded per call on
# the angles' device, with autograd
# ---------------------------------------------------------------------------

def _planar_controlled(m: torch.Tensor, num_controls: int) -> torch.Tensor:
    """The planar (2, d, d) matrix ``m`` under ``num_controls`` leading
    controls: the identity but for its last d × d block."""
    dim = 2**num_controls * m.shape[-1]
    eye = torch.eye(dim - m.shape[-1], dtype=m.dtype, device=m.device)
    return torch.stack([torch.block_diag(eye, m[0]),
                        torch.block_diag(torch.zeros_like(eye), m[1])])


def _require_params(params) -> None:
    if params is None:
        raise ValueError("the plan has parameterised gates: pass params")


def _term_planar(term, params) -> torch.Tensor:
    """A parameterised term's planar (2, d, d) float64 matrix: its maker's
    output at ``params[term.param_idx]`` (float64 angles) under its
    controls."""
    _require_params(params)
    m = term.maker(params[term.param_idx]).to(torch.float64)
    if term.num_controls:
        m = _planar_controlled(m, term.num_controls)
    return m


def _fold_contract(g: torch.Tensor, W: torch.Tensor, positions
                   ) -> torch.Tensor:
    """One contraction of the window fold: the complex k-qubit gate ``g``
    (2^k, 2^k) on the row axes ``positions`` of W ((2,)*w + (2^w,))."""
    k = len(positions)
    out = torch.tensordot(g.reshape((2,) * (2 * k)), W,
                          dims=(list(range(k, 2 * k)), list(positions)))
    return torch.movedim(out, list(range(k)), list(positions))


def _static_terms(step: WindowStep, device) -> list:
    """The complex128 matrix of each static term of a window on ``device``
    (None for a parameterised one), uploaded once."""
    return [None if t.matrix is None else profiling.upload(
        np.asarray(t.matrix, np.complex128), device) for t in step.terms]


def _fold(step: WindowStep, static: list, params) -> torch.Tensor:
    _require_params(params)
    w, dim = step.width, 2**step.width
    W = torch.eye(dim, dtype=torch.complex128, device=params.device)
    W = W.reshape((2,) * w + (dim,))
    for term, g in zip(step.terms, static):
        if g is None:
            m = _term_planar(term, params)
            g = torch.complex(m[0], m[1])
        W = _fold_contract(g, W, term.positions)
    W = W.reshape(dim, dim)
    return torch.stack([W.real, W.imag]).to(torch.float32).contiguous()


def fold_window_planar(step: WindowStep, params) -> torch.Tensor:
    """The planar (2, D, D) float32 unitary of a window whose terms may be
    parameterised, on the angles' device, differentiable in ``params``.

    The fold runs in float64 (complex128: each term one contraction of its
    float64 planes) and rounds once to float32, as the static fold does in
    numpy; the reference folds in float32 (``fold_window_planar``,
    ``qbot_tpu/tpu/planar.py:203-213``), from which it differs by a few
    float32 roundings of the entries.
    """
    _require_params(params)
    params = params.to(torch.float64)
    return _fold(step, _static_terms(step, params.device), params)


def _conj_planar(w: torch.Tensor) -> torch.Tensor:
    return torch.stack([w[0], -w[1]])


def _window_tables(step: WindowStep, device) -> Callable:
    """``params -> W`` of a window: its static matrix, folded and uploaded
    once; or, parameterised, the fold of each call (its static terms
    uploaded once)."""
    folded = fold_window_static(step)
    if folded is None:
        static = _static_terms(step, device)
        return lambda params: _fold(step, static, params)
    w = _planar_tensor(folded, device)
    return lambda params: w


def _as_params(params, device):
    """``params`` as a float64 tensor on ``device``, differentiable in the
    caller's tensor."""
    if params is None:
        return None
    if not isinstance(params, torch.Tensor):
        params = torch.as_tensor(np.asarray(params))
    return params.to(device=device, dtype=torch.float64)


# ---------------------------------------------------------------------------
# steps: each prepares its device tables once and returns
# (psi, params) -> psi
# ---------------------------------------------------------------------------

class _Ops(NamedTuple):
    window: Callable
    pair: Callable
    reflect_dot: Callable
    reflect_update: Callable


_KERNELS = _Ops(kernels.window_apply, kernels.pair_apply,
                kernels.reflect_dot, kernels.reflect_update)
_PLAIN = _Ops(kernels.window_apply_ref, kernels.pair_apply_ref,
              kernels.reflect_dot_ref, kernels.reflect_update_ref)


def _window_fn(n: int, step: WindowStep, device, ops: _Ops):
    w = _window_tables(step, device)
    diag = kernels.fused_diagonals(n, step.pre_flips, step.pre_phases,
                                   device)
    return lambda psi, params: ops.window(psi, n, step.start, step.width,
                                          w(params), diag)


def _pair_parts(step: PairStep, device):
    """(start, width1, width2, params -> W1, params -> W2) of a pair of
    adjacent windows."""
    first, second = step.first, step.second
    if first.start + first.width != second.start:
        raise ValueError("pair windows must be qubit-contiguous")
    return (first.start, first.width, second.width,
            _window_tables(first, device), _window_tables(second, device))


def _pair_fn(n: int, step: PairStep, device, ops: _Ops):
    """Both windows of a PairStep in one pass, after the first window's
    fused flips and phases."""
    start, width1, width2, w1, w2 = _pair_parts(step, device)
    diag = kernels.fused_diagonals(n, step.first.pre_flips,
                                   step.first.pre_phases, device)
    return lambda psi, params: ops.pair(psi, n, start, width1, width2,
                                        w1(params), w2(params), diag)


def reflect_component(factors, index: int) -> complex:
    """Static component ``v[index]`` of the product state |v⟩ = ⊗ factors."""
    v = 1.0 + 0.0j
    shift = sum(int(f.shape[0]).bit_length() - 1 for f in factors)
    for f in factors:
        d = int(f.shape[0])
        shift -= d.bit_length() - 1
        v *= complex(np.asarray(f, np.complex128)[(index >> shift) & (d - 1)])
    return v


class _Reflection:
    """Device tables of a ReflectStep: |v⟩ = A ⊗ B with A the Kronecker
    product of all factors but the last (H entries) and B the last (T)."""

    def __init__(self, step: ReflectStep, device):
        head = np.ones(1, np.complex128)
        for f in step.factors[:-1]:
            head = np.kron(head, np.asarray(f, np.complex128))
        tail = np.asarray(step.factors[-1], np.complex128)
        self.H, self.T = head.shape[0], tail.shape[0]
        a32, b32 = to_planar(head), to_planar(tail)
        self.a = profiling.upload(a32, device).reshape(2, self.H, 1)
        self.b = profiling.upload(b32, device).reshape(2, 1, self.T)
        # c is scaled by 1/⟨v|v⟩ of the float32 tables: the update is then
        # the exact Householder reflection about the tables' own direction,
        # which keeps the norm however the tables round (by estimate, their
        # rounding alone would drift it by ~7e-5 over 512 Grover
        # iterations at 26 qubits)
        inv_vv = 1.0 / (float(np.sum(a32.astype(np.float64) ** 2))
                        * float(np.sum(b32.astype(np.float64) ** 2)))
        # c = Σ_t conj(B_t)·D[t] as one contraction of the planar lane dot:
        # c[i] = Σ_{j,t} lane[i, j, t]·D[j, t]
        br, bi = b32.astype(np.float64)
        lane = np.stack([np.stack([br, bi]), np.stack([-bi, br])])
        # each fused flip m shifts c by −2·conj(v_m)·ψ_m (planar.py:304-312):
        # c[i] += Σ_{j,f} flip[i, j, f]·ψ[j, m_f]
        v = np.array([reflect_component(step.factors, m)
                      for m in step.pre_flips], np.complex128)
        flip = -2.0 * np.stack([np.stack([v.real, v.imag]),
                                np.stack([-v.imag, v.real])])
        self.lane = profiling.upload(lane * inv_vv, device)
        self.flip = profiling.upload(flip.reshape(2, 2, -1) * inv_vv, device)
        self.flips = profiling.upload(np.asarray(step.pre_flips, np.int64),
                                      device)
        self.no_flips = self.flips[:0]

    def c64_from_lane_dot(self, d, psi3=None):
        """⟨v|Fψ⟩/⟨v|v⟩ from the float64 lane dot D of ψ and the fused
        flips' values in ψ, formed in float64 on the device: a (2,)
        float64 tensor; of a (P, 2, H, T) batch, one c a particle, (P, 2).
        Without ``psi3``, ⟨v|ψ⟩/⟨v|v⟩, no flip corrected."""
        c = torch.einsum("ijt,...jt->...i", self.lane, d[..., 0, :])
        if psi3 is not None and self.flips.numel():
            vals = psi3.reshape(*psi3.shape[:-2], -1)[..., self.flips]
            c = c + torch.einsum("ijf,...jf->...i", self.flip, vals.double())
        return c

    def c_from_lane_dot(self, d, psi3=None):
        """:meth:`c64_from_lane_dot` as the float32 tensor the update
        kernel reads."""
        return self.c64_from_lane_dot(d, psi3).float()


def _reflect(psi, refl: _Reflection, ops: _Ops):
    """ψ → Fψ − 2⟨v|Fψ⟩v: one read pass (dot) and one read+write pass."""
    p3 = psi.reshape(*psi.shape[:-1], refl.H, refl.T)
    c = refl.c_from_lane_dot(ops.reflect_dot(p3, refl.a, refl.b), p3)
    out, _ = ops.reflect_update(p3, c, refl.a, refl.b, refl.flips)
    return out.reshape(psi.shape)


class _ReflectApply(torch.autograd.Function):
    """The reflection R = (I − 2vv†/⟨v|v⟩)F through the reflection kernels,
    and its adjoint (``qbot_tpu/tpu/planar.py:343-370``) through them too:
    R†ḡ = F(ḡ − 2⟨v|ḡ⟩v/⟨v|v⟩), ⟨v|ḡ⟩ from ``reflect_dot`` in float64
    without the flips' corrections, ``reflect_update`` with no flips, then
    the flips.  ⟨v|v⟩ is the float32 tables' own, as in the forward, so
    the backward is its exact adjoint."""

    @staticmethod
    def forward(ctx, psi, refl):
        ctx.refl = refl
        return _reflect(psi, refl, _KERNELS)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        refl = ctx.refl
        g3 = g.contiguous().reshape(*g.shape[:-1], refl.H, refl.T)
        c = refl.c_from_lane_dot(kernels.reflect_dot(g3, refl.a, refl.b))
        out, _ = kernels.reflect_update(g3, c, refl.a, refl.b,
                                        refl.no_flips)
        return kernels._flip_signs(out.reshape(g.shape), refl.flips), None


def _reflect_fn(step: ReflectStep, device, ops: _Ops):
    refl = _Reflection(step, device)

    def apply(psi, params):
        if ops is _KERNELS and kernels._needs_grad(psi):
            return _ReflectApply.apply(psi, refl)
        return _reflect(psi, refl, ops)
    return apply


def _planes(psi, shape):
    """(plane axis, re, im) of a (..., 2, 2^n) state or batch viewed as
    (..., 2, *shape)."""
    pl = psi.dim() - 2
    t = psi.reshape(*psi.shape[:pl], 2, *shape)
    return pl, t.select(pl, 0), t.select(pl, 1)


def _diag_fn(n: int, targets, diag, device):
    """Elementwise pass multiplying by a diagonal on ``targets``."""
    k = len(targets)
    shape, axes, _ = _grouped_view(n, targets)
    d = np.asarray(diag, np.complex128).reshape((2,) * k)
    # diag axes in target order -> the view's axes, in qubit order
    d = np.transpose(d, np.argsort(axes))
    bshape = [2 if i in axes else 1 for i in range(len(shape))]
    dt = _planar_tensor(d, device).reshape([2] + bshape)
    dr, di = dt[0], dt[1]

    def apply(psi, params):
        pl, pr, pi = _planes(psi, shape)
        return torch.stack([dr * pr - di * pi, dr * pi + di * pr],
                           dim=pl).reshape(psi.shape)
    return apply


def _flip_fn(index: int):
    def apply(psi, params):
        out = psi.clone()
        out[..., index] = -out[..., index]
        return out
    return apply


def _contract_tables(step: ContractStep, device, conj: bool = False
                     ) -> Callable:
    """``params -> (2, d, d)`` planar float32 matrix of a contraction step
    (conjugated for the columns of a density matrix): static, uploaded
    once, or its maker's output per call under its controls."""
    if step.matrix is not None:
        m = np.asarray(step.matrix)
        g = _planar_tensor(m.conj() if conj else m, device)
        return lambda params: g

    def make(params):
        m = _term_planar(step, params).to(torch.float32)
        return _conj_planar(m) if conj else m
    return make


def _contract_fn(n: int, step: ContractStep, device, conj: bool = False,
                 offset: int = 0):
    """Cross-window gate as a tensor contraction over its target axes
    (shifted by ``offset``: a density matrix's columns)."""
    matrix = _contract_tables(step, device, conj)
    targets = [offset + q for q in step.targets]
    k = len(targets)
    shape, axes, _ = _grouped_view(n, targets)

    def con(gm, x, lead):
        at = [lead + a for a in axes]
        out = torch.tensordot(gm.reshape((2,) * (2 * k)), x,
                              dims=(list(range(k, 2 * k)), at))
        return torch.movedim(out, list(range(k)), at)

    def apply(psi, params):
        g = matrix(params)
        pl, pr, pi = _planes(psi, shape)
        with _fp32_matmul():
            out_r = con(g[0], pr, pl) - con(g[1], pi, pl)
            out_i = con(g[0], pi, pl) + con(g[1], pr, pl)
        return torch.stack([out_r, out_i], dim=pl).reshape(psi.shape)
    return apply


@profiling.spanned("qbot.plan.prepare")
def _step_fns(plan: Plan, device, ops: _Ops) -> list:
    n = plan.n
    fns = []
    for step in plan.steps:
        if isinstance(step, WindowStep):
            fns.append(_window_fn(n, step, device, ops))
        elif isinstance(step, PairStep):
            fns.append(_pair_fn(n, step, device, ops))
        elif isinstance(step, ReflectStep):
            fns.append(_reflect_fn(step, device, ops))
        elif isinstance(step, DiagStep):
            fns.append(_diag_fn(n, step.targets, step.diag, device))
        elif isinstance(step, PhaseStep):
            d = phase_as_diag(step)
            fns.append(_diag_fn(n, d.targets, d.diag, device))
        elif isinstance(step, FlipStep):
            fns.append(_flip_fn(step.index))
        else:
            fns.append(_contract_fn(n, step, device))
    return fns


def _run(psi, fns, params=None):
    params = _as_params(params, psi.device)
    for fn in fns:
        psi = fn(psi, params)
    return psi


def apply_plan_planar(psi: torch.Tensor, plan: Plan,
                      params=None) -> torch.Tensor:
    """Run a compiled plan over a planar (2, 2^n) float32 statevector, or
    over each state of a (P, 2, 2^n) batch (one ``params`` for all).

    On a CUDA tensor every window, pair and reflection runs its CUDA
    kernel, one launch for the whole batch; on a CPU tensor, the kernels'
    plain versions.  ``params`` (1-D, on the state's device) holds the
    angles of the plan's parameterised gates; the result is differentiable
    in it and in ``psi``.  Prepares every step anew:
    :func:`make_planar_runner` prepares them once.  A plan of the dot
    engine runs on :func:`qbot_tpu_torch.tpu.dotplan.apply_plan_dot`.
    """
    lowered = _dot_lowered(plan)
    if lowered is not None:
        from qbot_tpu_torch.tpu.dotplan import apply_plan_dot

        return apply_plan_dot(psi, lowered, params)
    fns = _step_fns(plan, psi.device, _KERNELS)
    with profiling.named_scope("qbot.plan.apply"):
        return _run(psi, fns, params)


def apply_plan_planar_ref(psi: torch.Tensor, plan: Plan,
                          params=None) -> torch.Tensor:
    """:func:`apply_plan_planar` through the kernels' plain PyTorch
    versions on any device (differentiable by PyTorch's own autograd): the
    reference a kernel run is checked against on the card.  A plan of the
    dot engine runs on ``dotplan.apply_plan_dot_ref``."""
    lowered = _dot_lowered(plan)
    if lowered is not None:
        from qbot_tpu_torch.tpu.dotplan import apply_plan_dot_ref

        return apply_plan_dot_ref(psi, lowered, params)
    return _run(psi, _step_fns(plan, psi.device, _PLAIN), params)


def _dot_lowered(plan: Plan):
    """The plan lowered for the dot engine when its ``engine`` is
    ``"dot"`` and it lowers, else None (the kernel engine runs it)."""
    if plan.engine != "dot":
        return None
    from qbot_tpu_torch.tpu.dotplan import lower_dot_plan

    return lower_dot_plan(plan)


class _Prepared:
    """Step functions of a plan, prepared once per device."""

    def __init__(self, make):
        self.make, self.fns = make, {}

    def __call__(self, device) -> list:
        if device not in self.fns:
            self.fns[device] = self.make(device)
        return self.fns[device]


def make_planar_runner(plan: Plan):
    """``run(psi, params=None)``: :func:`apply_plan_planar` with the static
    steps' tables (folded matrices, fused diagonals, reflection tables)
    prepared once per device; a parameterised window folds per call.  A
    plan of the dot engine runs on ``dotplan.make_dot_runner``."""
    lowered = _dot_lowered(plan)
    if lowered is not None:
        from qbot_tpu_torch.tpu.dotplan import make_dot_runner

        return make_dot_runner(lowered)
    prepared = _Prepared(lambda device: _step_fns(plan, device, _KERNELS))

    def run(psi: torch.Tensor, params=None) -> torch.Tensor:
        fns = prepared(psi.device)
        with profiling.named_scope("qbot.plan.apply"):
            return _run(psi, fns, params)
    return run


def _renormalize(psi: torch.Tensor) -> torch.Tensor:
    """ψ/√⟨ψ|ψ⟩, the norm summed in float64 (float32 sums of 2^n nearly
    equal terms are biased)."""
    norm2 = torch.sum(torch.square(psi), dtype=torch.float64)
    return psi * torch.rsqrt(norm2).to(psi.dtype)


def make_scanned_planar_runner(body_plan: Plan, repeats: int,
                               init_plan: Optional[Plan] = None,
                               renorm_every: int = 0):
    """``run(psi)`` applying ``init_plan`` once, then ``body_plan``
    ``repeats`` times, renormalising ψ after every ``renorm_every``-th body
    when it is set (``qbot_tpu/tpu/planar.py:767-803``: the remedy for the
    norm drift of the reduced dot modes).

    A body that is one ReflectStep (Grover's oracle and diffusion), without
    ``renorm_every`` and with nothing that requires a gradient, runs one
    ``reflect_dot`` prologue, then one ``reflect_update`` per iteration:
    each update also returns the lane dot of its result, from which the
    next ⟨v|Fψ⟩ is formed on the device, so the loop never waits for the
    host.  Other bodies, and a reflection body under autograd, loop over
    the body's prepared steps (each reflection then through its
    differentiable kernels).  A body of the dot engine that is not that
    reflection runs on ``dotplan.make_scanned_dot_runner``, as in the
    reference.
    """
    reflect_body = (len(body_plan.steps) == 1
                    and isinstance(body_plan.steps[0], ReflectStep)
                    and not renorm_every)
    if not reflect_body and body_plan.engine == "dot":
        from qbot_tpu_torch.tpu.dotplan import make_scanned_dot_runner

        dot = make_scanned_dot_runner(body_plan, repeats, init_plan,
                                      renorm_every)
        if dot is not None:
            return dot
    init = None if init_plan is None else make_planar_runner(init_plan)
    body = _Prepared(lambda device: _step_fns(body_plan, device, _KERNELS))

    @profiling.spanned("qbot.scan")
    def run(psi: torch.Tensor, params=None) -> torch.Tensor:
        if init is not None:
            psi = init(psi, params)
        if not reflect_body or kernels._needs_grad(psi):
            fns = body(psi.device)
            with profiling.named_scope("qbot.plan.apply"):
                for i in range(repeats):
                    psi = _run(psi, fns, params)
                    if renorm_every and (i + 1) % renorm_every == 0:
                        psi = _renormalize(psi)
            return psi
        with profiling.named_scope("qbot.plan.prepare"):
            refl = _Reflection(body_plan.steps[0], psi.device)
        with profiling.named_scope("qbot.plan.apply"):
            p3 = psi.reshape(*psi.shape[:-1], refl.H, refl.T)
            c = refl.c_from_lane_dot(kernels.reflect_dot(p3, refl.a, refl.b),
                                     p3)
            for _ in range(repeats):
                p3, d = kernels.reflect_update(p3, c, refl.a, refl.b,
                                               refl.flips)
                c = refl.c_from_lane_dot(d, p3)
        return p3.reshape(psi.shape)
    return run


# ---------------------------------------------------------------------------
# readout
# ---------------------------------------------------------------------------

def planar_probs(psi: torch.Tensor, targets=None,
                 n: Optional[int] = None) -> torch.Tensor:
    """Outcome probabilities of ``targets`` (sorted qubit order), or of the
    whole register, as a tensor on the state's device; of a (P, 2, 2^n)
    batch, one row a particle."""
    if n is None:
        n = psi.shape[-1].bit_length() - 1
    return _marginal(psi[..., 0, :] ** 2 + psi[..., 1, :] ** 2, targets, n)


def _marginal(p: torch.Tensor, targets, n: int) -> torch.Tensor:
    """Marginal of the 2^n outcome probabilities ``p`` (..., 2^n) on
    ``targets``."""
    if targets is None:
        return p
    shape, _, rest = _grouped_view(n, targets)
    lead = p.shape[:-1]
    p = p.reshape(*lead, *shape)
    if rest:
        p = torch.sum(p, dim=[len(lead) + r for r in rest])
    return p.reshape(*lead, -1)


def planar_norm(psi: torch.Tensor) -> torch.Tensor:
    """⟨ψ|ψ⟩; of a (P, 2, 2^n) batch, one a particle."""
    return torch.sum(psi[..., 0, :] ** 2 + psi[..., 1, :] ** 2, dim=-1)


# ---------------------------------------------------------------------------
# density matrices (``qbot_tpu/tpu/planar.py:521-657``)
#
# ρ is a planar (2, 2^n, 2^n) float32 tensor.  Viewed flat as a planar
# (2, 4^n) state of 2n qubits, the row index is qubits [0, n) and the column
# index qubits [n, 2n): every step acts on the rows at q and, conjugated, on
# the columns at n + q, through the same window and pair kernels, so a
# density plan costs twice the statevector plan's passes.
# ---------------------------------------------------------------------------

def zero_density_planar(n: int, device) -> torch.Tensor:
    rho = torch.zeros((2, 2**n, 2**n), dtype=REAL_DTYPE, device=device)
    rho[0, 0, 0] = 1.0
    return rho


def product_density_planar(rhos, device) -> torch.Tensor:
    """Planar (2, 2^n, 2^n) float32 product state ρ_0 ⊗ … ⊗ ρ_{n−1} of n
    one-qubit 2 × 2 complex matrices ``rhos`` (qubit 0 the most significant
    bit), built on ``device``.

    The factors go to the device in one upload; the Kronecker products run
    there, each written once into its own tensor, so no 4^n array is built
    on the host.
    """
    factors = np.stack([to_planar(np.asarray(r, np.complex128).reshape(2, 2))
                        for r in rhos])
    f = profiling.upload(factors, device)               # (n, 2, 2, 2)
    rho = torch.stack([torch.ones((1, 1), dtype=REAL_DTYPE, device=device),
                       torch.zeros((1, 1), dtype=REAL_DTYPE, device=device)])
    for fr, fi in zip(f[:, 0], f[:, 1]):
        d = rho.shape[-1]
        r, i = rho[0, :, None, :, None], rho[1, :, None, :, None]
        fr, fi = fr[None, :, None, :], fi[None, :, None, :]
        out = torch.empty((2, d, 2, d, 2), dtype=REAL_DTYPE, device=device)
        torch.mul(r, fr, out=out[0])
        out[0].addcmul_(i, fi, value=-1.0)
        torch.mul(r, fi, out=out[1])
        out[1].addcmul_(i, fr)
        rho = out.reshape(2, 2 * d, 2 * d)
    return rho


def _density_flip_phases(n: int, flips) -> tuple:
    """Fused phases of the 2n-qubit view for ρ → FρF: each flipped basis
    state m negates row m and column m (and so leaves ρ[m, m])."""
    rows, cols = tuple(range(n)), tuple(range(n, 2 * n))
    return tuple(p for m in flips for p in ((rows, -1.0, m), (cols, -1.0, m)))


def _density_diagonals(n: int, step: WindowStep, device):
    """The row launch's fused diagonals of the 2n-qubit view for ρ → DρD†,
    D the step's phases and flips: each phase (qubits, z, pattern) on the
    rows and (n + each qubit, conj(z), pattern) on the columns, then the
    flips on both (:func:`_density_flip_phases`).  Diagonals commute, and
    the row launch's W touches no column bit, so the column launch takes
    none."""
    phases = tuple(
        p for qubits, z, pat in step.pre_phases
        for p in ((tuple(qubits), z, pat),
                  (tuple(n + q for q in qubits), np.conj(z), pat)))
    return kernels.fused_diagonals(
        2 * n, pre_phases=phases + _density_flip_phases(n, step.pre_flips),
        device=device)


def _density_tables(step: WindowStep, device) -> Callable:
    """``params -> (W, conj(W))`` of a window: static, both uploaded once;
    parameterised, the fold of each call and its conjugate."""
    folded = fold_window_static(step)
    if folded is None:
        fold = _window_tables(step, device)

        def both(params):
            w = fold(params)
            return w, _conj_planar(w).contiguous()
        return both
    tables = (_planar_tensor(folded, device),
              _planar_tensor(folded.conj(), device))
    return lambda params: tables


def _density_window_fn(n: int, step: WindowStep, device, ops: _Ops):
    """W at s on the rows (after the step's phases and flips on rows and
    columns, fused into the row pass), conj(W) at n + s on the columns."""
    tables = _density_tables(step, device)
    diag = _density_diagonals(n, step, device)
    none = kernels.fused_diagonals(2 * n, device=device)
    start, width = step.start, step.width

    def apply(flat, params):
        w, wc = tables(params)
        flat = ops.window(flat, 2 * n, start, width, w, diag)
        return ops.window(flat, 2 * n, n + start, width, wc, none)
    return apply


def _density_pair_fn(n: int, step: PairStep, device, ops: _Ops):
    """(W1, W2) at s on the rows, after the first window's phases and
    flips on rows and columns; conjugated at n + s on the columns."""
    start, width1, width2 = (step.first.start, step.first.width,
                             step.second.width)
    first = _density_tables(step.first, device)
    second = _density_tables(step.second, device)
    diag = _density_diagonals(n, step.first, device)
    none = kernels.fused_diagonals(2 * n, device=device)

    def apply(flat, params):
        (w1, w1c), (w2, w2c) = first(params), second(params)
        flat = ops.pair(flat, 2 * n, start, width1, width2, w1, w2, diag)
        return ops.pair(flat, 2 * n, n + start, width1, width2, w1c, w2c,
                        none)
    return apply


def _density_flip_fn(n: int, index: int):
    def apply(flat, params):
        rho = flat.reshape(2, 2**n, 2**n).clone()
        rho[:, index, :] = -rho[:, index, :]
        rho[:, :, index] = -rho[:, :, index]
        return rho.reshape(flat.shape)
    return apply


def _both_sides(row, col):
    return lambda flat, params: col(row(flat, params), params)


def _density_diag_fn(n: int, step: DiagStep, device):
    """A diagonal on the rows at its targets and, conjugated, on the columns
    at n + each: two elementwise passes over ρ."""
    rows = _diag_fn(2 * n, step.targets, step.diag, device)
    cols = _diag_fn(2 * n, tuple(n + q for q in step.targets),
                    np.conj(np.asarray(step.diag)), device)
    return _both_sides(rows, cols)


class _DensitySteps(NamedTuple):
    """A density plan's step functions, with what each call counts:
    ``diag_passes``, the elementwise passes over ρ of its standalone
    diagonals, and ``fused_phases``, the entries its windows' and pairs'
    fused phases take in the row launches (each phase twice: rows and
    columns; flips not counted)."""
    fns: list
    diag_passes: int
    fused_phases: int


@profiling.spanned("qbot.plan.prepare")
def _density_step_fns(plan: Plan, device, ops: _Ops) -> _DensitySteps:
    """Steps over the flat (2, 4^n) view: reflections expand to their
    windows and flips; a window's or pair's fused phases go to its row
    launch on both sides (:func:`_density_diagonals`), and a standalone
    phase or diagonal, with no kernel beside it, is two elementwise passes
    (``qbot_tpu/tpu/planar.py:589-628`` expands every fused phase to
    such passes)."""
    n = plan.n
    fns, passes, fused = [], 0, 0
    for step in expand_reflections(plan.steps):
        if isinstance(step, PhaseStep):
            step = phase_as_diag(step)
        if isinstance(step, WindowStep):
            fns.append(_density_window_fn(n, step, device, ops))
            fused += 2 * len(step.pre_phases)
        elif isinstance(step, PairStep):
            fns.append(_density_pair_fn(n, step, device, ops))
            fused += 2 * len(step.first.pre_phases)
        elif isinstance(step, DiagStep):
            fns.append(_density_diag_fn(n, step, device))
            passes += 2
        elif isinstance(step, FlipStep):
            fns.append(_density_flip_fn(n, step.index))
        else:
            fns.append(_both_sides(
                _contract_fn(2 * n, step, device),
                _contract_fn(2 * n, step, device, conj=True, offset=n)))
    return _DensitySteps(fns, passes, fused)


def _run_density(rho, steps: _DensitySteps, params=None):
    """Counts ``density_diag_passes`` and ``density_fused_phases`` (both
    even at 0, so a reader finds them), then runs the steps."""
    profiling.count("density_diag_passes", steps.diag_passes)
    profiling.count("density_fused_phases", steps.fused_phases)
    return _run(rho.reshape(2, -1), steps.fns, params).reshape(rho.shape)


def _dot_density_lowered(plan: Plan):
    """A density plan of the dot engine as its 2n-qubit statevector plan
    (``dotplan.density_plan_2n``), lowered, or None (the kernel engine
    runs it)."""
    if plan.engine != "dot":
        return None
    from qbot_tpu_torch.tpu.dotplan import density_plan_2n

    big = density_plan_2n(plan)
    return None if big is None else _dot_lowered(big)


def apply_plan_density_planar(rho: torch.Tensor, plan: Plan,
                              params=None) -> torch.Tensor:
    """Run a compiled plan over a planar (2, 2^n, 2^n) float32 density
    matrix: ρ → UρU†.

    On a CUDA tensor every window and pair runs its CUDA kernel, on the
    rows and on the columns; on a CPU tensor, the kernels' plain versions.
    ``params`` as in :func:`apply_plan_planar`; a parameterised window's
    column side is the conjugate of its fold.  A plan of the dot engine
    runs its 2n-qubit statevector plan on ``dotplan.apply_plan_dot``.
    """
    lowered = _dot_density_lowered(plan)
    if lowered is not None:
        from qbot_tpu_torch.tpu.dotplan import apply_plan_dot

        return apply_plan_dot(rho.reshape(2, -1), lowered,
                              params).reshape(rho.shape)
    return _run_density(rho, _density_step_fns(plan, rho.device, _KERNELS),
                        params)


def apply_plan_density_planar_ref(rho: torch.Tensor, plan: Plan,
                                  params=None) -> torch.Tensor:
    """:func:`apply_plan_density_planar` through the kernels' plain
    PyTorch versions on any device: the reference a kernel run is checked
    against on the card (a plan of the dot engine, ``apply_plan_dot_ref``
    of its 2n-qubit plan)."""
    lowered = _dot_density_lowered(plan)
    if lowered is not None:
        from qbot_tpu_torch.tpu.dotplan import apply_plan_dot_ref

        return apply_plan_dot_ref(rho.reshape(2, -1), lowered,
                                  params).reshape(rho.shape)
    return _run_density(rho, _density_step_fns(plan, rho.device, _PLAIN),
                        params)


def make_planar_density_runner(plan: Plan):
    """``run(rho, params=None)``: :func:`apply_plan_density_planar` with
    the step tables (folded matrices, fused diagonals) prepared once per
    device."""
    lowered = _dot_density_lowered(plan)
    if lowered is not None:
        from qbot_tpu_torch.tpu.dotplan import make_dot_runner

        run_flat = make_dot_runner(lowered)
        return lambda rho, params=None: run_flat(
            rho.reshape(2, -1), params).reshape(rho.shape)
    prepared = _Prepared(
        lambda device: _density_step_fns(plan, device, _KERNELS))

    def run(rho: torch.Tensor, params=None) -> torch.Tensor:
        steps = prepared(rho.device)
        with profiling.named_scope("qbot.plan.apply"):
            return _run_density(rho, steps, params)
    return run


def planar_density_probs(rho: torch.Tensor, targets=None,
                         n: Optional[int] = None) -> torch.Tensor:
    """Computation-basis outcome probabilities, the diagonal of ρ, of
    ``targets`` (sorted qubit order) or of the whole register, as a tensor
    on the state's device."""
    if n is None:
        n = rho.shape[-1].bit_length() - 1
    return _marginal(torch.diagonal(rho[0]).clone(), targets, n)
