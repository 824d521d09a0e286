"""qbot_tpu_torch — the qbot DSL's planar engine on PyTorch and CUDA.

A port of :mod:`qbot_tpu`'s ``--compile`` path from JAX on a TPU to PyTorch
on an NVIDIA Hopper card.  It imports ``torch`` and never ``jax``, and
nothing of :mod:`qbot_tpu`: it keeps its own copy of the host layer (DSL
front end and dense interpreter, circuit IR, plan dataclasses and compiler
passes) under the same module names.

Entry points: :func:`executeTxt` / :func:`executeFile` (the dense host
interpreter), :func:`executeTxtEnsemble` (its exact probabilistic-branching
ensemble), :func:`lower_program` and :func:`run_lowered` (a .qb program
on the planar executor), :func:`run_lowered_ensemble` and
:func:`executeTxtDeviceEnsemble` (mid-circuit measurement and
probabilistic control flow on the device particle ensemble, exact or SMC),
:func:`run_lowered_sharded` (a program on a register sharded over the ranks
of a ``torch.distributed`` group, :mod:`qbot_tpu_torch.tpu.sharded`),
:func:`compile_circuit` (circuit IR to a plan, paired by default), the
statevector and density-matrix executors in
:mod:`qbot_tpu_torch.tpu.planar` (differentiable in the state and in the
angles of parameterised gates, through the kernels' backward) and the
complex ones of :mod:`qbot_tpu_torch.tpu.simulator`, and HMC/NUTS over
gate angles in :mod:`qbot_tpu_torch.inference`.  :func:`planar_from_numpy` and
:func:`planar_to_numpy` carry a planar ``(2, 2^n)`` state or ``(2, 2^n,
2^n)`` density matrix across from and to the JAX package as numpy.
"""
import numpy as np
import torch

from qbot_tpu_torch.frontend.device_ensemble import executeTxtDeviceEnsemble
from qbot_tpu_torch.frontend.ensemble import executeTxtEnsemble
from qbot_tpu_torch.frontend.interpreter import executeFile, executeTxt
from qbot_tpu_torch.frontend.lowering import (
    lower_program,
    run_lowered,
    run_lowered_ensemble,
    run_lowered_sharded,
)
from qbot_tpu_torch.tpu.compiler import compile_circuit

__version__ = "0.1.0"


def planar_from_numpy(arr, device) -> torch.Tensor:
    """A planar float32 tensor on ``device`` from a (2, 2^n) state or a
    (2, 2^n, 2^n) density matrix."""
    return torch.tensor(np.asarray(arr), dtype=torch.float32, device=device)


def planar_to_numpy(psi: torch.Tensor) -> np.ndarray:
    """The float32 numpy array of a planar state or density tensor."""
    return psi.detach().cpu().numpy()


def main():
    import sys

    from qbot_tpu_torch.cli import main as _cli_main
    sys.exit(_cli_main())


__all__ = ["executeTxt", "executeFile", "executeTxtEnsemble",
           "executeTxtDeviceEnsemble", "lower_program", "run_lowered",
           "run_lowered_ensemble", "run_lowered_sharded",
           "compile_circuit", "planar_from_numpy",
           "planar_to_numpy", "main", "__version__"]
