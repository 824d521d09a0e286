"""Multi-host initialisation and the host-aware particle × qubit mesh.

Port of :mod:`qbot_tpu.tpu.distributed` (``qbot_tpu/tpu/distributed.py``)
on ``torch.distributed``: a run past one host starts one process a device
with ``torchrun`` (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), and the same
P × Q mesh spans the hosts, laid out so that amplitude exchanges (the
qubit axis) stay within a host and only the particle axis's small weight
reductions cross hosts.

:func:`dryrun_mesh` is the analogue of ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:48``): one HMC step over gate angles with the chains
split over the particle axis, each rank running its chains through
:func:`~qbot_tpu_torch.tpu.planar.make_planar_runner` (the hand-written
kernels and their backward on a CUDA rank), then the sharded Grover of
:mod:`qbot_tpu_torch.tpu.sharded` on the qubit axis and a mid-circuit
measurement program on the whole mesh.  The reference's dry run also takes
a gradient of a state sharded over the qubit axis through GSPMD; GSPMD is
XLA's and is not ported (ROADMAP, North star), so here each chain's state
lives on one rank.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from qbot_tpu_torch.tpu.sharding import (
    EnsembleMesh,
    default_backend,
    ensemble_mesh,
    launch,
    rank_device,
)

__all__ = ["initialize_multihost", "make_multihost_mesh", "host_local_batch",
           "dryrun_step", "dryrun_mesh"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> None:
    """Join the process group (``init_process_group``): at
    ``coordinator_address`` ("host:port") when given, else from
    ``torchrun``'s environment.  Does nothing for a single process or
    when this process has joined already."""
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if num_processes in (None, 1) or dist.is_initialized():
        return
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    dev = rank_device(local_rank, device)
    backend = default_backend(device)
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            device_id=dev if backend == "nccl" else None)


def _hosts() -> int:
    """The hosts of the group: its ranks over ``LOCAL_WORLD_SIZE``, the
    ranks ``torchrun`` started on each host (one host if unset)."""
    if not dist.is_initialized():
        return 1
    size = dist.get_world_size()
    return max(1, size // int(os.environ.get("LOCAL_WORLD_SIZE", size)))


def make_multihost_mesh(particles_per_host: int = 1,
                        device="cuda") -> EnsembleMesh:
    """This rank's view of the global P × Q mesh, the particle axis
    across hosts: P = hosts · ``particles_per_host`` rows.  ``torchrun``
    numbers ranks host-major, so each row's Q = ranks / P consecutive
    ranks lie on one host: amplitude exchanges stay within a host and
    only the particle axis's reductions cross hosts."""
    size = dist.get_world_size()
    rows = _hosts() * particles_per_host
    if size % rows:
        raise ValueError(f"{size} ranks not divisible into {rows} particle "
                         f"rows")
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return ensemble_mesh((rows, size // rows),
                         rank_device(local_rank, device))


def host_local_batch(global_batch: int) -> int:
    """Per-host share of a global particle batch."""
    hosts = _hosts()
    if global_batch % hosts:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{hosts} hosts")
    return global_batch // hosts


# the dry run's shapes: tiny, as the reference's (``__graft_entry__.py:87``),
# but for the ansatz: at 16 qubits its paired plan holds a middle pair as
# well as trailing ones (at width 7 from 15 qubits on), so the dry run
# launches every window and pair kernel
_N, _HMC_N, _DEPTH, _CHAINS = 8, 16, 2, 4
_EPS, _LEAPFROG = 0.01, 3
_PROGRAM = ("qset tensorExp(computation.kets[0], 8)\n"
            "gate hadamardGate ; 0\n"
            "gate pauliXGate ; 7 ; [0]\n"
            "meas a ; computation ; [0]\n"
            "qset hadamard.kets[0] ; [3]\n"
            "disc [7]\n"
            "meas b ; computation ; [0, 3]")


def _hmc_rows(emesh: EnsembleMesh) -> torch.Tensor:
    """One HMC step of the chains of this rank's row (the chains split
    over the particle axis; the Q ranks of a row run the same chains),
    then every chain's new angles on every rank: (chains, angles)."""
    from qbot_tpu_torch.inference.hmc import (
        _leapfrog,
        make_circuit_log_prob_planar,
        value_and_grad,
    )
    from qbot_tpu_torch.tpu.circuit import parameterized_layers
    from qbot_tpu_torch.tpu.compiler import compile_circuit

    if _CHAINS % emesh.P:
        raise ValueError(f"{_CHAINS} chains do not split over {emesh.P} "
                         f"particle rows")
    dev = emesh.device
    circ = parameterized_layers(_HMC_N, _DEPTH)
    counts = np.zeros(2**_HMC_N)
    counts[0] = 16.0                  # tiny synthetic observations
    vg = value_and_grad(make_circuit_log_prob_planar(
        compile_circuit(circ), counts, device=dev))
    dim = circ.num_params
    theta0 = torch.linspace(0.1, 1.0, _CHAINS * dim,
                            device=dev).reshape(_CHAINS, dim)
    # every rank draws every chain's momenta and uniform, then keeps its
    # row's: a chain's draws do not depend on the split
    gen = torch.Generator(device="cpu").manual_seed(0)
    p0 = torch.randn((_CHAINS, dim), generator=gen).to(dev)
    u = torch.rand(_CHAINS, generator=gen, dtype=torch.float64)
    per = _CHAINS // emesh.P
    out = torch.zeros_like(theta0)
    for c in range(emesh.p * per, (emesh.p + 1) * per):
        lp0, g0 = vg(theta0[c])
        q, p, _, lp1 = _leapfrog(vg, theta0[c], p0[c], g0, _EPS, _LEAPFROG)
        ham0 = lp0 - 0.5 * torch.sum(p0[c] ** 2)
        ham1 = lp1 - 0.5 * torch.sum(p ** 2)
        accept = math.log(float(u[c])) < float(ham1 - ham0)
        out[c] = q if accept else theta0[c]
    # the rows' chains to every rank: zeros elsewhere, so the sum is exact
    if emesh.P > 1:
        dist.all_reduce(out, group=emesh.particles.group)
    return out


def dryrun_step(emesh: EnsembleMesh) -> dict:
    """The dry run on this rank of ``emesh`` (every rank calls it):
    ``{"thetas": every chain's angles after one HMC step, "grover":
    marginals of qubits 0-2 of Grover 8q sharded over the row, "a", "b":
    the mid-circuit program's outcome distributions}``, as numpy, the
    same on every rank."""
    from qbot_tpu_torch.frontend.lowering import (
        lower_program,
        run_lowered_sharded_ensemble,
    )
    from qbot_tpu_torch.tpu.circuit import grover_circuit
    from qbot_tpu_torch.tpu.sharded import (
        compile_sharded,
        make_sharded_planar_runner,
        sharded_probs_fn,
        sharded_zero_state,
    )

    thetas = _hmc_rows(emesh)
    if not bool(torch.all(torch.isfinite(thetas))):
        raise AssertionError("the HMC step's angles are not finite")
    splan = compile_sharded(grover_circuit(_N, marked=5, iterations=2),
                            emesh.k)
    psi = make_sharded_planar_runner(splan, emesh.qubits)(
        sharded_zero_state(_N, emesh.qubits))
    grover = sharded_probs_fn(splan, emesh.qubits, targets=[0, 1, 2])(psi)
    if abs(float(torch.sum(grover)) - 1.0) > 1e-4:
        raise AssertionError(f"Grover's marginals sum to "
                             f"{float(torch.sum(grover))}")
    results, ens, _, _ = run_lowered_sharded_ensemble(
        lower_program(_PROGRAM, mid_measure=True), mesh=emesh)
    if ens.psi.shape[-1] != 2 ** (_N - 1 - emesh.k):
        raise AssertionError("the register did not shrink at disc")
    return {"thetas": thetas.cpu().numpy(), "grover": grover.cpu().numpy(),
            **{name: np.asarray(r.probs) for name, r in results.items()}}


def dryrun_mesh(P: int, Q: int, device="cuda",
                backend: Optional[str] = None,
                timeout: Optional[float] = None) -> dict:
    """:func:`dryrun_step` on a P × Q mesh started on this host
    (:func:`~qbot_tpu_torch.tpu.sharding.launch`; under ``torchrun``,
    this rank of its group): rank 0's result (another rank of a
    ``torchrun`` group: its own)."""
    ranks = launch(dryrun_step, (P, Q), device=device, backend=backend,
                   timeout=timeout)
    return ranks[min(ranks)]
