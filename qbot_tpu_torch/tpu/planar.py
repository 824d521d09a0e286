"""Planar statevector executor on PyTorch.

Port of the statevector half of :mod:`qbot_tpu.tpu.planar`.  The state is a
float32 tensor of shape ``(2, 2^n)`` holding (real, imag) planes, on any
device; every entry point takes or returns tensors on the caller's device.
Window steps and reflections go through the kernels of
:mod:`qbot_tpu_torch.tpu.kernels`; diagonal, phase, flip and contraction
steps are plain PyTorch, as they are XLA outside Pallas in the JAX package.
Every step is out of place: the caller's state is never written.

Not ported yet (they raise ``NotImplementedError`` naming the ROADMAP item
that brings them): parameterised gates, ``PairStep``, ``renorm_every``, and
matrix precisions other than full float32.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from qbot_tpu.tpu.compiler import (
    ContractStep,
    DiagStep,
    FlipStep,
    PairStep,
    PhaseStep,
    Plan,
    ReflectStep,
    WindowStep,
    phase_as_diag,
)
from qbot_tpu_torch.tpu import kernels
from qbot_tpu_torch.tpu.kernels import _fp32_matmul

__all__ = ["zero_state_planar", "to_planar", "from_planar",
           "product_state_planar", "fold_window_static",
           "apply_plan_planar", "apply_plan_planar_ref",
           "make_scanned_planar_runner", "planar_probs", "planar_norm"]

REAL_DTYPE = torch.float32

_PARAM_TODO = ("parameterised gates are not ported yet "
               "(ROADMAP queue 1, item 8: inference and the kernels' backward)")
_PAIR_TODO = ("PairStep is not ported yet (ROADMAP queue 2, items 5-6: "
              "_pair_bt and _pair_b1); compile with "
              "qbot_tpu_torch.compile_circuit, which never pairs")
_RENORM_TODO = ("renorm_every is not ported yet (ROADMAP queue 1, item 5: "
                "precision modes and renormalisation)")


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
        pk = torch.from_numpy(to_planar(k)).to(device)
        br, bi = pk[0], pk[1]
        r, i = ((r[:, None] * br[None, :] - i[:, None] * bi[None, :])
                .reshape(-1),
                (r[:, None] * bi[None, :] + i[:, None] * br[None, :])
                .reshape(-1))
    nrm = torch.sqrt(torch.sum(r * r + i * i))
    return torch.stack([r, i]) / nrm


def zero_state_planar(n: int, device) -> torch.Tensor:
    psi = torch.zeros((2, 2**n), dtype=REAL_DTYPE, device=device)
    psi[0, 0] = 1.0
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


def _planar_tensor(mat, device) -> torch.Tensor:
    return torch.from_numpy(to_planar(np.asarray(mat, np.complex128))
                            ).to(device)


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
# steps: each prepares its device tables once and returns psi -> psi
# ---------------------------------------------------------------------------

class _Ops(NamedTuple):
    window: Callable
    reflect_dot: Callable
    reflect_update: Callable


_KERNELS = _Ops(kernels.window_apply, kernels.reflect_dot,
                kernels.reflect_update)
_PLAIN = _Ops(kernels.window_apply_ref, kernels.reflect_dot_ref,
              kernels.reflect_update_ref)


def _window_fn(n: int, step: WindowStep, device, ops: _Ops):
    static = fold_window_static(step)
    if static is None:
        raise NotImplementedError(_PARAM_TODO)
    w = _planar_tensor(static, device)
    diag = kernels.fused_diagonals(n, step.pre_flips, step.pre_phases,
                                   device)
    return lambda psi: ops.window(psi, n, step.start, step.width, w, diag)


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
        self.a = torch.from_numpy(a32).to(device).reshape(2, self.H, 1)
        self.b = torch.from_numpy(b32).to(device).reshape(2, 1, self.T)
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
        self.lane = torch.from_numpy(lane * inv_vv).to(device)
        self.flip = torch.from_numpy(
            flip.reshape(2, 2, -1) * inv_vv).to(device)
        self.flips = torch.tensor(list(step.pre_flips), dtype=torch.int64,
                                  device=device)

    def c_from_lane_dot(self, d, psi3):
        """⟨v|Fψ⟩/⟨v|v⟩ from the float64 lane dot D of ψ and the fused
        flips' values in ψ, in float64 on the device, as the (2,) float32
        tensor the update kernel reads."""
        c = torch.einsum("ijt,jt->i", self.lane, d[:, 0])
        if self.flips.numel():
            vals = psi3.reshape(2, -1)[:, self.flips].double()
            c = c + torch.einsum("ijf,jf->i", self.flip, vals)
        return c.float()


def _reflect_fn(step: ReflectStep, device, ops: _Ops):
    """ψ → Fψ − 2⟨v|Fψ⟩v: one read pass (dot) and one read+write pass."""
    refl = _Reflection(step, device)

    def apply(psi):
        p3 = psi.reshape(2, refl.H, refl.T)
        c = refl.c_from_lane_dot(ops.reflect_dot(p3, refl.a, refl.b), p3)
        out, _ = ops.reflect_update(p3, c, refl.a, refl.b, refl.flips)
        return out.reshape(psi.shape)
    return apply


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

    def apply(psi):
        t = psi.reshape([2] + shape)
        pr, pi = t[0], t[1]
        return torch.stack([dr * pr - di * pi,
                            dr * pi + di * pr]).reshape(psi.shape)
    return apply


def _flip_fn(index: int):
    def apply(psi):
        out = psi.clone()
        out[:, index] = -out[:, index]
        return out
    return apply


def _contract_fn(n: int, step: ContractStep, device):
    """Cross-window gate as a tensor contraction over its target axes."""
    if step.matrix is None:
        raise NotImplementedError(_PARAM_TODO)
    g = _planar_tensor(step.matrix, device)
    k = len(step.targets)
    shape, axes, _ = _grouped_view(n, step.targets)
    gr = g[0].reshape((2,) * (2 * k))
    gi = g[1].reshape((2,) * (2 * k))

    def con(gm, x):
        out = torch.tensordot(gm, x, dims=(list(range(k, 2 * k)), axes))
        return torch.movedim(out, list(range(k)), axes)

    def apply(psi):
        t = psi.reshape([2] + shape)
        pr, pi = t[0], t[1]
        with _fp32_matmul():
            out_r = con(gr, pr) - con(gi, pi)
            out_i = con(gr, pi) + con(gi, pr)
        return torch.stack([out_r, out_i]).reshape(psi.shape)
    return apply


def _step_fns(plan: Plan, device, ops: _Ops) -> list:
    n = plan.n
    fns = []
    for step in plan.steps:
        if isinstance(step, WindowStep):
            fns.append(_window_fn(n, step, device, ops))
        elif isinstance(step, PairStep):
            raise NotImplementedError(_PAIR_TODO)
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


def _run(psi, fns):
    for fn in fns:
        psi = fn(psi)
    return psi


def apply_plan_planar(psi: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Run a compiled plan over a planar (2, 2^n) float32 statevector.

    On a CUDA tensor every window and reflection runs its CUDA kernel; on
    a CPU tensor, the kernels' plain versions.
    """
    return _run(psi, _step_fns(plan, psi.device, _KERNELS))


def apply_plan_planar_ref(psi: torch.Tensor, plan: Plan) -> torch.Tensor:
    """:func:`apply_plan_planar` through the kernels' plain PyTorch
    versions on any device: the reference a kernel run is checked
    against on the card."""
    return _run(psi, _step_fns(plan, psi.device, _PLAIN))


def make_scanned_planar_runner(body_plan: Plan, repeats: int,
                               init_plan: Optional[Plan] = None,
                               renorm_every: int = 0):
    """``run(psi)`` applying ``init_plan`` once, then ``body_plan``
    ``repeats`` times.

    A body that is one ReflectStep (Grover's oracle and diffusion) runs one
    ``reflect_dot`` prologue, then one ``reflect_update`` per iteration:
    each update also returns the lane dot of its result, from which the
    next ⟨v|Fψ⟩ is formed on the device, so the loop never waits for the
    host.  Other bodies loop over :func:`apply_plan_planar`.
    """
    if renorm_every:
        raise NotImplementedError(_RENORM_TODO)
    reflect_body = (len(body_plan.steps) == 1
                    and isinstance(body_plan.steps[0], ReflectStep))

    def run(psi: torch.Tensor) -> torch.Tensor:
        if init_plan is not None:
            psi = apply_plan_planar(psi, init_plan)
        if not reflect_body:
            fns = _step_fns(body_plan, psi.device, _KERNELS)
            for _ in range(repeats):
                psi = _run(psi, fns)
            return psi
        refl = _Reflection(body_plan.steps[0], psi.device)
        p3 = psi.reshape(2, refl.H, refl.T)
        c = refl.c_from_lane_dot(kernels.reflect_dot(p3, refl.a, refl.b), p3)
        for _ in range(repeats):
            p3, d = kernels.reflect_update(p3, c, refl.a, refl.b, refl.flips)
            c = refl.c_from_lane_dot(d, p3)
        return p3.reshape(psi.shape)
    return run


# ---------------------------------------------------------------------------
# readout
# ---------------------------------------------------------------------------

def planar_probs(psi: torch.Tensor, targets=None,
                 n: Optional[int] = None) -> torch.Tensor:
    """Outcome probabilities of ``targets`` (sorted qubit order), or of the
    whole register, as a tensor on the state's device."""
    if n is None:
        n = psi.shape[-1].bit_length() - 1
    p = psi[0] ** 2 + psi[1] ** 2
    if targets is None:
        return p
    shape, _, rest = _grouped_view(n, targets)
    p = p.reshape(shape)
    if rest:
        p = torch.sum(p, dim=rest)
    return p.reshape(-1)


def planar_norm(psi: torch.Tensor) -> torch.Tensor:
    return torch.sum(psi[0] ** 2 + psi[1] ** 2)
