"""The qubit mesh of the sharded register, on ``torch.distributed``.

The counterpart of the qubit axis of ``qbot_tpu.tpu.sharding.make_mesh``
(``qbot_tpu/tpu/sharding.py:33-48``): where the reference runs one program
over a device mesh under ``shard_map``, the port runs K = 2^k processes,
one a shard (SPMD), in one ``torch.distributed`` process group.  A
:class:`QubitMesh` is one rank's view of it: the group, K, this rank and
this rank's device.  :mod:`qbot_tpu_torch.tpu.sharded` runs a sharded plan
on it.

- On CUDA the rank's device is ``cuda:{local_rank % device_count}``, made
  current with ``torch.cuda.set_device``; on the CPU it is ``cpu``, only
  when the caller asks for it.
- ``nccl`` puts one rank on each card: it refuses two ranks of one
  communicator on one GPU ("Duplicate GPU detected").  So :func:`launch`
  refuses an ``nccl`` mesh of more ranks than cards; several ranks on one
  card run under ``gloo``.
- :func:`launch` starts K ranks on this host with the spawn start method
  (never fork: the caller may have threads running), each joining the group
  over ``tcp://localhost``, runs ``fn(mesh, *args)`` on every rank and
  returns each rank's result.  Any rank's exception fails the whole run;
  the other ranks are then stopped.  Under ``torchrun`` (``WORLD_SIZE``
  set) it joins the group that exists and runs this rank alone.

An :class:`EnsembleMesh` is one rank of a P × Q mesh (the reference's
``qbot_tpu/tpu/sharded_ensemble.py:134-158``), the mesh of the sharded
particle ensemble: P·Q ranks, rank r = p·Q + q, P rows of particles, each
row's particles sharded over its Q ranks' leading qubits.  Every rank keeps
two subgroups: its row, the Q ranks holding the same particles (a
:class:`QubitMesh`, on which the sharded register's executor runs as it
runs on a whole qubit mesh), and its column, the P ranks holding the same
qubit shard of every row (the particle axis: weight sums, the mixture, the
island exchange).  ``dist.new_group`` is called by every rank for every
group in one order (rows, then columns), as it must be.  :func:`launch`
and :func:`join_mesh` take a mesh shape (P, Q) as well as a qubit mesh.

The GSPMD parts of the reference's module (``state_sharding``,
``shard_state``, ``make_sharded_runner``) exist for XLA and are not ported
(ROADMAP, North star).
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import traceback
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

__all__ = ["QubitMesh", "EnsembleMesh", "rank_device", "init_mesh",
           "init_ensemble_mesh", "ensemble_mesh", "join_mesh",
           "default_backend", "launch"]

# the longest any collective may wait for its peers
_TIMEOUT = datetime.timedelta(minutes=10)


@dataclass(frozen=True)
class QubitMesh:
    """One rank of a K-way qubit mesh: ``group`` (None: the default
    group), K = ``size`` ranks, this ``rank`` and its ``device``."""
    group: Optional[object]
    size: int
    rank: int
    device: torch.device

    @property
    def k(self) -> int:
        """log2 of the number of shards."""
        return self.size.bit_length() - 1

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))


@dataclass(frozen=True)
class EnsembleMesh:
    """One rank of a P × Q (particles × qubit shards) mesh.

    ``rank`` = p·Q + q in the default group of P·Q ranks; ``qubits`` is
    this rank's row (its ``rank`` q of ``size`` Q), ``particles`` its
    column (its ``rank`` p of ``size`` P), both on this rank's
    ``device``."""
    P: int
    K: int
    rank: int
    device: torch.device
    qubits: QubitMesh
    particles: QubitMesh

    @property
    def k(self) -> int:
        """log2 of the number of qubit shards."""
        return self.K.bit_length() - 1

    @property
    def p(self) -> int:
        return self.particles.rank

    @property
    def q(self) -> int:
        return self.qubits.rank

    @property
    def size(self) -> int:
        return self.P * self.K

    @property
    def backend(self) -> str:
        return str(dist.get_backend())


def default_backend(device) -> str:
    """``nccl`` for CUDA ranks, ``gloo`` for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(local_rank: int, device) -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` (made
    current) for ``device="cuda"``, ``cpu`` for ``device="cpu"``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unsupported device {device}: CUDA or CPU only")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("CUDA is not available: a CUDA mesh needs a card")
    dev = torch.device("cuda", local_rank % count)
    torch.cuda.set_device(dev)
    return dev


def _check_size(size: int) -> None:
    if size < 1 or size & (size - 1):
        raise ValueError(f"a qubit mesh has 2^k ranks, got {size}")


def _check_backend(size: int, device, backend: str) -> None:
    """Refuse an ``nccl`` mesh of more ranks than CUDA devices."""
    if backend == "nccl" and torch.device(device).type == "cuda":
        count = torch.cuda.device_count()
        if size > count:
            raise ValueError(
                f"{size} ranks under nccl need {size} CUDA devices, one a "
                f"rank; {count} available")


def _timeout(seconds: Optional[float]) -> datetime.timedelta:
    return (_TIMEOUT if seconds is None
            else datetime.timedelta(seconds=seconds))


def _join(rank: int, size: int, init_method: str, device, backend,
          local_rank: Optional[int], timeout) -> torch.device:
    """``init_process_group`` as ``rank`` of ``size``; this rank's device."""
    backend = backend or default_backend(device)
    dev = rank_device(rank if local_rank is None else local_rank, device)
    # nccl binds its communicator to the rank's card
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank,
                            timeout=_timeout(timeout),
                            device_id=dev if backend == "nccl" else None)
    return dev


def init_mesh(rank: int, size: int, init_method: str, device="cuda",
              backend: Optional[str] = None,
              local_rank: Optional[int] = None,
              timeout: Optional[float] = None) -> QubitMesh:
    """Join a ``size``-rank group as ``rank`` (``init_process_group`` at
    ``init_method``) and return this rank's mesh.  ``timeout``: the
    seconds any collective may wait for its peers (default 10 minutes)."""
    _check_size(size)
    dev = _join(rank, size, init_method, device, backend, local_rank,
                timeout)
    return QubitMesh(None, size, rank, dev)


def _ensemble_groups(P: int, K: int, timeout) -> tuple[list, list]:
    """(row groups, column groups) of a P × K mesh, made on every rank in
    the same order; a group of every rank is the default group."""
    def group(ranks):
        if len(ranks) == P * K:
            return None
        return dist.new_group(ranks, timeout=_timeout(timeout))
    rows = [group([p * K + q for q in range(K)]) for p in range(P)]
    cols = [group([p * K + q for p in range(P)]) for q in range(K)]
    return rows, cols


def ensemble_mesh(shape, device, timeout: Optional[float] = None
                  ) -> EnsembleMesh:
    """This rank's view of a P × Q mesh over the default group, which
    holds P·Q ranks: makes the row and column groups (every rank calls
    it)."""
    P, K = shape
    _check_size(K)
    rank = dist.get_rank()
    if dist.get_world_size() != P * K:
        raise ValueError(f"a {P}x{K} mesh needs {P * K} ranks, the group "
                         f"has {dist.get_world_size()}")
    rows, cols = _ensemble_groups(P, K, timeout)
    p, q = divmod(rank, K)
    device = torch.device(device)
    return EnsembleMesh(P, K, rank, device,
                        QubitMesh(rows[p], K, q, device),
                        QubitMesh(cols[q], P, p, device))


def init_ensemble_mesh(rank: int, shape, init_method: str, device="cuda",
                       backend: Optional[str] = None,
                       local_rank: Optional[int] = None,
                       timeout: Optional[float] = None) -> EnsembleMesh:
    """Join a P·Q-rank group as ``rank`` and return this rank's view of
    the P × Q mesh (``shape``)."""
    P, K = shape
    _check_size(K)
    dev = _join(rank, P * K, init_method, device, backend, local_rank,
                timeout)
    return ensemble_mesh(shape, dev, timeout)


def _torchrun_rank() -> tuple[int, int, int]:
    """(world size, rank, local rank) of a process that ``torchrun``
    started."""
    size = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", 0))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return size, rank, local_rank


def join_mesh(device="cuda", backend: Optional[str] = None, shape=None,
              timeout: Optional[float] = None):
    """The mesh of a process that ``torchrun`` started (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set),
    joining the group unless this process has joined it already: a
    :class:`QubitMesh` of every rank, or, for a ``shape`` (P, Q), this
    rank's :class:`EnsembleMesh` of the P·Q ranks."""
    size, rank, local_rank = _torchrun_rank()
    if shape is not None:
        if not dist.is_initialized():
            return init_ensemble_mesh(rank, shape, "env://", device,
                                      backend, local_rank, timeout)
        return ensemble_mesh(shape, rank_device(local_rank, device), timeout)
    if dist.is_initialized():
        _check_size(dist.get_world_size())
        return QubitMesh(None, dist.get_world_size(), dist.get_rank(),
                         rank_device(local_rank, device))
    return init_mesh(rank, size, "env://", device, backend, local_rank,
                     timeout)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _shape(size) -> tuple[int, int]:
    """(P, Q) of a qubit mesh's size Q or a mesh shape (P, Q)."""
    P, K = (1, size) if isinstance(size, int) else tuple(size)
    if P < 1:
        raise ValueError(f"a mesh has P >= 1 rows of particles, got {P}")
    _check_size(K)
    return P, K


def _rank_main(rank: int, size, init_method: str, device, backend,
               fn: Callable, args: tuple, results, timeout) -> None:
    """One spawned rank: join, run ``fn(mesh, *args)``, report the result
    or the traceback, leave the group."""
    try:
        # the ranks share the host's cores
        torch.set_num_threads(1)
        if isinstance(size, int):
            mesh = init_mesh(rank, size, init_method, device, backend,
                             timeout=timeout)
        else:
            mesh = init_ensemble_mesh(rank, size, init_method, device,
                                      backend, timeout=timeout)
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        # the parent raises it, naming this rank
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, size, *args, device="cuda",
           backend: Optional[str] = None,
           timeout: Optional[float] = None,
           collective_timeout: Optional[float] = None) -> dict:
    """Run ``fn(mesh, *args)`` on the ranks of a new mesh on this host and
    return ``{rank: result}``: ``size`` ranks of a qubit mesh
    (:class:`QubitMesh`), or, for a shape ``(P, Q)``, the P·Q ranks of an
    :class:`EnsembleMesh`.

    ``fn`` and ``args`` go to each rank by pickle (``fn`` by its import
    path), as does each result back.  The ranks start with the spawn
    method; the backend defaults to :func:`default_backend`.  Any rank that
    raises or dies fails the run with a ``RuntimeError`` naming it (its
    traceback included), and the other ranks are stopped; so is every rank
    after ``timeout`` seconds.  ``collective_timeout``: the seconds a
    collective waits for its peers before it fails (default 10 minutes).
    Under ``torchrun`` this process joins the group that exists and runs
    its own rank alone: ``{rank: result}``.
    """
    P, K = _shape(size)
    total = P * K
    backend = backend or default_backend(device)
    if "WORLD_SIZE" in os.environ:
        mesh = join_mesh(device, backend,
                         None if isinstance(size, int) else size,
                         collective_timeout)
        if mesh.size != total:
            raise ValueError(f"torchrun started {mesh.size} ranks, the run "
                             f"needs {total}")
        return {mesh.rank: fn(mesh, *args)}
    _check_backend(total, device, backend)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, size, init_method, device, backend, fn,
                               args, results, collective_timeout))
             for r in range(total)]
    # each rank reads the environment as it starts: c10d's warnings (a
    # host without reverse name lookup draws one a connection) stay off
    # the program's stderr
    saved = os.environ.get("TORCH_CPP_LOG_LEVEL")
    os.environ["TORCH_CPP_LOG_LEVEL"] = "ERROR"
    try:
        for p in procs:
            p.start()
    finally:
        if saved is None:
            del os.environ["TORCH_CPP_LOG_LEVEL"]
        else:
            os.environ["TORCH_CPP_LOG_LEVEL"] = saved
    out: dict = {}
    waited = 0.0
    try:
        while len(out) < total:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {total} died (exit code "
                        f"{procs[dead[0]].exitcode}) before reporting")
                if timeout is not None and waited > timeout:
                    raise RuntimeError(f"the {total} ranks did not finish "
                                       f"within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {total} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    return out
