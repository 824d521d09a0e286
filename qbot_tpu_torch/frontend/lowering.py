"""Run a lowered .qb program on the PyTorch planar executor.

Port of :func:`qbot_tpu.frontend.lowering.run_lowered` on its planar route
(``qbot_tpu/frontend/lowering.py:1702-1767``).  The DSL front end is shared:
:func:`qbot_tpu.frontend.lowering.lower_program` turns the program into
circuit IR and :func:`~qbot_tpu.frontend.lowering.finish_lowered` binds the
result and runs the classical epilogue; neither imports JAX.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from qbot_tpu.frontend.lowering import (
    _DENSE_REPLAY_LIMIT,
    LoweredProgram,
    _too_large_provider,
    finish_lowered,
)
from qbot_tpu.tpu.circuit import Circuit
from qbot_tpu.tpu.compiler import Plan
from qbot_tpu_torch.tpu.compiler import compile_circuit
from qbot_tpu_torch.tpu.planar import (
    apply_plan_planar,
    planar_probs,
    product_state_planar,
)

__all__ = ["run_lowered"]


def _is_computational(basis) -> bool:
    return basis.numQubits == 1 and all(
        np.allclose(k, e) for k, e in zip(basis.kets,
                                          np.eye(2, dtype=complex)))


def run_lowered(lp: LoweredProgram, window: int = 7, device="cuda",
                plan: Optional[Plan] = None):
    """Execute a lowered program on ``device``.

    ``plan`` is ``compile_circuit(lp.circuit, window)`` (paired) when the
    caller has compiled it already; it is compiled here when None.

    Returns (outcome probabilities as numpy, or None without a final
    measurement; final planar state tensor on ``device``).
    """
    device = torch.device(device)
    if plan is None:
        plan = compile_circuit(lp.circuit, window=window)
    psi = apply_plan_planar(product_state_planar(lp.initial_kets, device),
                            plan)
    if lp.measure_basis is None:
        return None, psi

    basis = lp.measure_basis
    targets = lp.measure_targets

    def provider(psi=psi, n=lp.n):
        if n > _DENSE_REPLAY_LIMIT:
            _too_large_provider(n)()
        host = psi.cpu().numpy()
        ket = host[0] + 1j * host[1]
        return np.outer(ket, np.conj(ket))

    if _is_computational(basis):
        probs = planar_probs(psi, targets, lp.n).cpu().numpy()
        finish_lowered(lp, probs, provider=provider)
        return probs, psi

    # general product basis: rotate the measured qubits into the basis
    # frame (B† per block), then read computational probabilities
    rot = np.stack(basis.kets).conj()
    bq = basis.numQubits
    post = Circuit(lp.n)
    for i in range(0, len(targets), bq):
        post.gate(rot, list(targets[i:i + bq]))
    psi_rot = apply_plan_planar(psi, compile_circuit(post, window=window))
    probs = planar_probs(psi_rot, targets, lp.n).cpu().numpy()
    finish_lowered(lp, probs, provider=provider)
    return probs, psi
