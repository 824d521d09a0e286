"""The program under test for a sharded statevector configuration: a
register of ``qubits`` split over K = 2^``shard_qubits`` ranks through the
port's sharded register (``compile_sharded``, ``make_sharded_planar_runner``,
``sharded_probs_fn``: the calls of ``run_lowered_sharded`` and ``--compile
--shard K``), each run reading the marginal of the first
``marginal_qubits`` logical qubits to the host.

**The ranks.**  The harness's process is rank 0, on the first card.  The
first entry made in a process loads (or builds) the kernels, so that no
two processes build them at once, then starts ranks 1..K-1 with the spawn
method, and all K join one group (``sharding.init_mesh``): ``nccl`` when
every rank has a card of its own, ``gloo`` when the ranks share a card or
run on the CPU.  The ranks stay for the process's later entries
(``python3 -m portbench.control`` measures one seed after another) and stop
when it exits.  Each call of rank 0 (set-up, a run, the end of the window,
the reference's judgement) is commanded to the other ranks with one small
broadcast, and every rank then does the same work on its own shard, so the
harness's window, profiler, memory peak and launch counts are rank 0's of
symmetric ranks.  No run can hang: a collective waits at most
``COLLECTIVE_TIMEOUT`` seconds for its peers, a rank that raises (out of
memory, say) exits, and rank 0 ends the process with exit code 1 as soon as
another rank has exited.

**A run.**  Set-up compiles the init ops and the body ``repeats`` times as
one sharded plan on rank 0 (``compile_sharded(circuit, k,
window=config["window"])``, its windows paired), broadcasts it, and makes
every rank's runner and marginal; then a page-locked host buffer and one
warm-up run.  A run: every rank's shard of |0…0⟩ (``sharded_zero_state``),
the runner, the marginal (one ``all_reduce``), copied on rank 0 into the
host buffer.  After the window every rank restores the logical qubit order
of its last state with the plan's ``plan_perm_to_identity`` items, outside
the timed runs, and ``outputs()["on_every_rank"]`` lets the reference run a
function of its own on every rank's outputs.
"""
from __future__ import annotations

import atexit
import multiprocessing
import os
import socket
import sys
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from portbench import bounds, comm_bounds
from portbench.entries.statevector import KEEP_READOUTS, to_circuit
from qbot_tpu_torch.tpu import kernels, sharded, sharding

COLLECTIVE_TIMEOUT = 300   # seconds a collective waits for its peers
_POLL_S = 0.5              # how often a rank looks at its peers' processes


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _exit_now(message: str) -> None:
    """End this process at once, whatever its threads wait on."""
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    sys.stdout.flush()
    os._exit(1)


class _Rank:
    """One rank's side of the entry: its runner and marginal, its last
    state, and the outputs the reference reads."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.splan = self.runner = self.probs = self.state = None
        self.outputs: dict = {}

    def _free(self) -> None:
        if self.mesh.device.type == "cuda":
            torch.cuda.empty_cache()

    def setup(self, splan, precision: str, targets) -> None:
        self.runner = self.probs = self.state = None
        self.outputs = {}
        self._free()
        kernels.set_dot_mode(precision)
        self.splan = splan
        self.runner = sharded.make_sharded_planar_runner(splan, self.mesh)
        self.probs = sharded.sharded_probs_fn(splan, self.mesh, targets)

    def run(self) -> torch.Tensor:
        """One run; keeps its state, returns its marginal."""
        self.state = None
        self.state = self.runner(
            sharded.sharded_zero_state(self.splan.n, self.mesh))
        return self.probs(self.state)

    def finish(self) -> None:
        """The last state in logical qubit order; the runner freed."""
        n, k = self.splan.n, self.splan.k
        items, perm = sharded.plan_perm_to_identity(self.splan.final_perm,
                                                    n, k)
        self.runner = self.probs = None
        if items:
            restore = sharded.make_sharded_planar_runner(
                sharded.ShardedPlan(n=n, k=k, items=items, final_perm=perm),
                self.mesh)
            self.state = restore(self.state)
        self.outputs = {"state": self.state, "readouts": []}
        self.state = None
        self._free()

    def call(self, fn, *args):
        return fn(self.outputs, *args)


class Ranks:
    """Ranks 1..K-1 of a K-rank mesh whose rank 0 is this process."""

    def __init__(self, size: int, device):
        device = torch.device(device)
        self.size = size
        cuda = device.type == "cuda"
        backend = ("nccl" if cuda and torch.cuda.device_count() >= size
                   else "gloo")
        if cuda:
            kernels.build_kernels()
        init_method = f"tcp://localhost:{_free_port()}"
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, size, init_method, device.type,
                                        backend))
                      for r in range(1, size)]
        for p in self.procs:
            p.start()
        self.clean, self.closing = True, False
        threading.Thread(target=self._watch, daemon=True).start()
        self.local = _Rank(sharding.init_mesh(
            0, size, init_method, device.type, backend,
            timeout=COLLECTIVE_TIMEOUT))
        atexit.register(self.close)

    def _dead(self) -> str:
        """Which rank has exited, if one has."""
        for r, p in enumerate(self.procs, 1):
            if p.exitcode is not None:
                return f"rank {r} of {self.size} exited (code {p.exitcode})"
        return ""

    def _watch(self) -> None:
        while not self.closing:
            dead = self._dead()
            if dead and not self.closing:
                self._kill()
                _exit_now(f"{dead}: the run stops")
            time.sleep(_POLL_S)

    def _kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()

    def command(self, name: str, *args):
        """Every rank calls ``_Rank.<name>(*args)``; returns rank 0's
        result."""
        self.clean = False
        dist.broadcast_object_list([(name, *args)], src=0)
        out = getattr(self.local, name)(*args)
        self.clean = True
        return out

    def on_every_rank(self, fn, *args):
        """``fn(outputs, *args)`` on every rank, its own outputs of the last
        window (``state``: its shard of the last run's state in logical
        order; on rank 0 ``readouts`` too); returns rank 0's result.
        ``fn`` goes to the other ranks by its import path."""
        return self.command("call", fn, *args)

    def close(self) -> None:
        """Stop the ranks; after a call that did not return, at once."""
        if self.closing:
            return
        self.closing = True
        if not self.clean:
            dead = self._dead()
            self._kill()
            _exit_now(f"{dead or 'a call to the ranks did not return'}: "
                      f"the run stops")
        dist.broadcast_object_list([("stop",)], src=0)
        for p in self.procs:
            p.join(timeout=60)
        self._kill()
        dist.destroy_process_group()


def _orphaned(parent: int) -> None:
    while os.getppid() == parent:
        time.sleep(_POLL_S)
    os._exit(1)


def _serve(rank: int, size: int, init_method: str, device: str,
           backend: str) -> None:
    """A rank other than 0: join, then do what rank 0 commands until it
    says stop, then exit at once, leaving the group to rank 0: on four
    H100s under nccl, ranks that destroyed the group here were still in
    ``destroy_process_group`` when rank 0 stopped waiting for them, 60 s
    later.  Any exception ends the process, which ends rank 0's."""
    try:
        torch.set_num_threads(1)
        threading.Thread(target=_orphaned, args=(os.getppid(),),
                         daemon=True).start()
        local = _Rank(sharding.init_mesh(rank, size, init_method, device,
                                         backend,
                                         timeout=COLLECTIVE_TIMEOUT))
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0)
            name, *args = box[0]
            if name == "stop":
                break
            getattr(local, name)(*args)
    except BaseException:
        traceback.print_exc()
        _exit_now(f"rank {rank} of {size} failed")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


_RANKS: dict = {}


def ranks(size: int, device) -> Ranks:
    """The process's ranks for a mesh of ``size`` on ``device``, started
    on first use."""
    key = (size, torch.device(device).type)
    if key not in _RANKS:
        if _RANKS:
            raise ValueError(f"the process holds ranks {list(_RANKS)}; "
                             f"a mesh {key} would be a second group")
        _RANKS[key] = Ranks(size, device)
    return _RANKS[key]


class Entry:
    def __init__(self, config: dict, request, device, span):
        self.config, self.request = config, request
        self.device, self.span = torch.device(device), span
        self.k = config["shard_qubits"]
        if not config["pair"]:
            raise ValueError("compile_sharded pairs windows: pair is true")
        self.targets = list(range(config["marginal_qubits"]))
        self.rng = np.random.default_rng([request.seed, 1])
        self.ranks = ranks(2 ** self.k, device)
        self.readouts: list = []
        self.runs = 0

    def setup(self, parts: dict) -> None:
        """Compile on rank 0 (its host seconds into ``parts["compile_s"]``),
        prepare every rank and warm up."""
        req, cfg = self.request, self.config
        ops = req.init_ops + req.body_ops * req.repeats
        with self.span("compile") as clock:
            self.splan = sharded.compile_sharded(
                to_circuit(req.n, ops), self.k, window=cfg["window"])
        parts["compile_s"] = clock.seconds
        # the bytes each rank sends a run, the work of the exchange's bound
        req.per_run["exchange_bytes"] = comm_bounds.sent_bytes(self.splan)
        self.ranks.command("setup", self.splan, cfg["precision"],
                           self.targets)
        self.host = torch.empty(2 ** len(self.targets), dtype=torch.float32,
                                pin_memory=self.device.type == "cuda")
        self._once()

    def _once(self) -> torch.Tensor:
        with self.span("run"):
            probs = self.ranks.command("run")
        with self.span("readout"):
            self.host.copy_(probs)
        return probs

    def run(self) -> None:
        """One request; keeps the device readouts of KEEP_READOUTS runs
        drawn from the seed (reservoir sampling); every rank keeps the
        state of its last run."""
        probs = self._once()
        self.runs += 1
        if len(self.readouts) < KEEP_READOUTS:
            self.readouts.append(probs)
        else:
            slot = int(self.rng.integers(0, self.runs))
            if slot < KEEP_READOUTS:
                self.readouts[slot] = probs

    def bound_s(self) -> float:
        """Seconds one run takes at least on each of K H100s: every local
        segment's steps on the (n − k)-qubit shard (``bounds.py``), a
        sharded diagonal or local transpose one pass over the shard (as a
        diagonal step), a reflection as a reflection step, a flip one
        amplitude, the exchanges over NVLink (``comm_bounds``), the fresh
        shard and the readout of its probabilities."""
        mode = self.config["precision"]
        n_local = self.request.n - self.k
        amps = 2 ** n_local
        passes = {"ShardedDiag": (bounds.STATE_BYTES * amps, 6 * amps),
                  "LocalPerm": (bounds.STATE_BYTES * amps, 0),
                  "ShardedReflect": (bounds.STATE_BYTES * amps, 16 * amps),
                  "ShardedFlip": (bounds.STATE_BYTES, 0)}
        total = 0.0
        for item in self.splan.items:
            kind = type(item).__name__
            if kind == "LocalSegment":
                total += bounds.plan_bound_s(item.plan, mode)
            elif kind in passes:
                nbytes, flops = passes[kind]
                total += bounds.bound(nbytes, fp32_flops=flops)[0] / 1e3
            elif kind not in comm_bounds.EXCHANGES:
                raise ValueError(f"no bound for a sharded item {kind!r}")
        return (total + comm_bounds.exchange_bound_s(self.splan)
                + bounds.fill_bound_s(n_local)
                + bounds.probs_bound_s(n_local))

    def outputs(self) -> dict:
        """What the reference judges: every rank's last state in logical
        order (through ``on_every_rank``), rank 0's readouts (the kept
        device readouts and the last host copy) and their targets."""
        self.ranks.command("finish")
        readouts = [*self.readouts, self.host]
        self.ranks.local.outputs["readouts"] = readouts
        self.readouts, self.host = [], None
        return {"on_every_rank": self.ranks.on_every_rank,
                "targets": self.targets, "shard_qubits": self.k}
