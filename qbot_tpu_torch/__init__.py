"""qbot_tpu_torch — the qbot DSL's planar engine on PyTorch and CUDA.

A port of :mod:`qbot_tpu`'s ``--compile`` path from JAX on a TPU to PyTorch
on an NVIDIA Hopper card.  It imports ``torch`` and never ``jax``; the
JAX-free host layer of :mod:`qbot_tpu` (DSL front end, circuit IR, plan
dataclasses) is shared, not copied.

Entry points: :func:`run_lowered` (a lowered .qb program),
:func:`compile_circuit` (circuit IR to a plan, paired by default), and the
statevector and density-matrix executors in
:mod:`qbot_tpu_torch.tpu.planar`.  :func:`planar_from_numpy` and
:func:`planar_to_numpy` carry a planar ``(2, 2^n)`` state or ``(2, 2^n,
2^n)`` density matrix across from and to the JAX package as numpy.
"""
import numpy as np
import torch

from qbot_tpu_torch.frontend.lowering import run_lowered
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


__all__ = ["run_lowered", "compile_circuit", "planar_from_numpy",
           "planar_to_numpy", "main", "__version__"]
