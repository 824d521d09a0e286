"""The qubit-sharded planar register on ``torch.distributed``.

Port of :mod:`qbot_tpu.tpu.sharded` (``qbot_tpu/tpu/sharded.py``): the
``(2, 2^n)`` planar state is sharded over its leading k = log2 K qubit
axes, one shard a rank of a :class:`~qbot_tpu_torch.tpu.sharding.QubitMesh`
(SPMD: every rank runs the same plan on its ``(2, 2^(n-k))`` shard, where
the reference runs one program under ``shard_map``):

* window/pair steps on **local** qubit axes run per shard, each a plan of
  the planar executor (:func:`~qbot_tpu_torch.tpu.planar.make_planar_runner`:
  the hand-written kernels on a CUDA rank, their plain versions on a CPU
  rank);
* a step on a **sharded** axis is preceded by a *qubit reshard*: one
  ``all_to_all_single`` that exchanges the k sharded axes with a block of k
  local ones; a :class:`BitSwap` exchanges one axis with the rank that
  differs in that bit; the compiler tracks the logical→physical
  permutation so later steps target the right axes;
* flips touch one amplitude on one shard; diagonals need no exchange; a
  reflection about a product state (Grover's diffusion) runs through the
  reflection kernels with one ``all_reduce`` of a float64 complex scalar;
* readout marginals are per-shard partial sums and one ``all_reduce``.

The plan half (the items, :class:`ShardedPlan`, :func:`compile_sharded`,
the layout planners, :func:`density_circuit`) is host code, a copy of the
reference's.  A density matrix runs as the flat ``(2, 4^n)`` planar state of
2n qubits, rows then columns, through the same runner.

The executor takes a batch of shards too, ``(B, 2, 2^(n-k))`` (B
particles of the sharded ensemble, :mod:`qbot_tpu_torch.tpu.sharded_ensemble`):
every item acts on each, and each kernel launches once for the batch.  On
a one-rank mesh no exchange or reduction is issued.

Not ported, because they exist only for the TPU: ``_shard_map`` and its
relaxed check, the ``set_kernel_mode("off")`` around each local segment
(Mosaic kernels do not lower under manual sharding), the ``(8, 128)``
carrier branch of the sharded diagonal, and ``splan_cache_key`` (the key
of the sharded ensemble's jit cache, which the port does not have).

Spans and counters (:mod:`qbot_tpu_torch.utils.profiling`): each local
segment runs inside the span ``qbot.shard.segment``, and each exchange of a
Reshard or BitSwap inside ``qbot.shard.exchange``, whose range carries the
bytes this rank sends to the others; the counters ``comm_bytes`` (those
bytes) and ``num_reshards`` (one a Reshard or BitSwap run) count every
exchange, so over one call of a runner on one state ``comm_bytes`` times K
is ``ShardedPlan.comm_bytes()``.

Several ranks on one card run under ``gloo``: ``nccl`` refuses two ranks of
one communicator on one GPU ("Duplicate GPU detected").  gloo takes the
CUDA shards of every exchange used here (``all_to_all_single``, also with
one non-empty chunk, ``all_reduce``, ``gather``) and copies them through
host memory itself; its ``batch_isend_irecv`` does not (torch
2.11.0+cu128: "writev ... Bad address"), so the pairwise exchange is an
``all_to_all_single`` (``tools/dist_probe.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from qbot_tpu_torch.tpu import kernels
from qbot_tpu_torch.tpu.circuit import Circuit, CircuitOp
from qbot_tpu_torch.tpu.compiler import (
    Plan,
    ReflectStep,
    combine_diag_vectors,
    compile_circuit,
    decompose_spanning_swap,
    eigen_decompose_controlled,
    gate_as_diag,
)
from qbot_tpu_torch.tpu.dotplan import _conj_maker
from qbot_tpu_torch.tpu.planar import (
    REAL_DTYPE,
    _diag_fn,
    _marginal,
    _Reflection,
    make_planar_runner,
)
from qbot_tpu_torch.tpu.sharding import QubitMesh
from qbot_tpu_torch.utils import profiling

__all__ = ["ShardedPlan", "compile_sharded", "make_sharded_planar_runner",
           "sharded_zero_state", "shard_planar", "gather_planar",
           "sharded_probs_fn", "unpermute_planar",
           "LocalSegment", "Reshard", "ShardedFlip", "ShardedDiag",
           "ShardedReflect", "LocalPerm", "BitSwap",
           "plan_reshards_to_localize", "plan_perm_to_identity",
           "apply_bitswap_local",
           "density_circuit", "compile_sharded_density",
           "shard_density", "sharded_zero_density",
           "sharded_density_probs_fn", "sharded_density_discard",
           "unpermute_density"]


# ---------------------------------------------------------------------------
# the plan (host only): ``qbot_tpu/tpu/sharded.py:68-264, 329-625, 828-875``
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LocalSegment:
    """A run of ops acting only on local (unsharded) qubit axes, compiled
    to a normal window-fused plan over the n−k local axes."""
    plan: Plan


@dataclass(frozen=True)
class Reshard:
    """Exchange the k sharded axes (physical [0,k)) with local physical
    axes [m, m+k): one all_to_all on the mesh axis."""
    m: int


@dataclass(frozen=True)
class ShardedFlip:
    """Sign-flip of one global basis state: owner shard + local index."""
    owner: int
    local_index: int


@dataclass(frozen=True)
class LocalPerm:
    """Shard-local qubit-axis transpose: new local axis i holds what was
    at local axis ``order[i]``.  Zero communication, one HBM pass — used
    when target localization finds no contiguous free exchange block."""
    order: tuple[int, ...]


@dataclass(frozen=True)
class BitSwap:
    """Exchange ONE sharded axis (device bit ``shard_pos``) with ONE local
    qubit axis: each device keeps the local slice matching its own bit and
    ppermutes the other half to the device differing in that bit — half
    the state crosses the links (vs (K−1)/K for a full Reshard).  The
    primitive that makes ANY layout reachable (full-block all_to_alls can
    never mix the sharded set with the local set in the tight n = 2k
    case)."""
    shard_pos: int
    local_axis: int


@dataclass(frozen=True)
class ShardedReflect:
    """Householder reflection about a product state, sharded.

    ``ψ → ψ − 2⟨v|ψ⟩v`` with ``v = ⊗ single-qubit factors``: the sharded
    axes contribute only a per-device scalar ``s_d = Π v_p[bit_p(d)]``, so
    the whole two-layer+flip sandwich costs ONE psum of a complex scalar —
    a sharded Grover iteration needs zero all_to_alls.

    ``shard_factors``: one complex 2-vector per sharded physical position;
    ``local_factors``: one per local physical axis, in order.
    """
    shard_factors: tuple[np.ndarray, ...]
    local_factors: tuple[np.ndarray, ...]


@dataclass(frozen=True)
class _OpReflect:
    """Op-stream marker produced by reflection detection (internal)."""
    factors: tuple[np.ndarray, ...]      # per LOGICAL qubit, in order
    kind: str = "reflect"
    controls: tuple = ()
    targets: tuple = ()


def _detect_op_reflections(ops, n: int):
    """Replace ``1q-layer · flip(idx) · inverse-1q-layer`` patterns in an op
    stream with :class:`_OpReflect` markers (circuit-level analogue of the
    step-level detection in compile_circuit, done here BEFORE reshard
    scheduling so the layers never touch sharded axes at all).

    Conservative: only uncontrolled static single-qubit layers match.
    """
    out: list = []
    i = 0
    while i < len(ops):
        op = ops[i]
        if op.kind != "flip":
            out.append(op)
            i += 1
            continue
        # layer A: maximal trailing run of distinct-target 1q static gates
        a_map: dict[int, object] = {}
        j = len(out) - 1
        while j >= 0:
            o = out[j]
            if (getattr(o, "kind", None) == "gate" and o.matrix is not None
                    and not o.controls and len(o.targets) == 1
                    and o.targets[0] not in a_map):
                a_map[o.targets[0]] = o
                j -= 1
            else:
                break
        if not a_map:
            out.append(op)
            i += 1
            continue
        # layer B: forward run matching A's supports with inverse matrices
        b_seen: set[int] = set()
        kk = i + 1
        ok = True
        while kk < len(ops) and len(b_seen) < len(a_map):
            o = ops[kk]
            if (o.kind == "gate" and o.matrix is not None and not o.controls
                    and len(o.targets) == 1 and o.targets[0] in a_map
                    and o.targets[0] not in b_seen):
                ma = np.asarray(a_map[o.targets[0]].matrix)
                if not np.allclose(np.asarray(o.matrix), ma.conj().T,
                                   atol=1e-9):
                    ok = False
                    break
                b_seen.add(o.targets[0])
                kk += 1
            else:
                ok = False
                break
        if not (ok and len(b_seen) == len(a_map)):
            out.append(op)
            i += 1
            continue
        idx = op.index
        factors = []
        for q in range(n):
            bit = (idx >> (n - 1 - q)) & 1
            if q in a_map:
                A = np.asarray(a_map[q].matrix, complex)
                factors.append(np.conj(A[bit, :]))
            else:
                e = np.zeros(2, complex)
                e[bit] = 1.0
                factors.append(e)
        del out[j + 1:]                  # consume layer A
        out.append(_OpReflect(tuple(factors)))
        i = kk                           # consume flip + layer B
    return out


@dataclass(frozen=True)
class ShardedDiag:
    """Diagonal unitary whose support touches sharded axes.

    Diagonals factor across shards: each device multiplies by its slice of
    the phase tensor (sharded-position bits come from the device id), so
    NO reshard is needed — a multi-controlled-Z over every qubit is one
    local elementwise pass.  ``positions`` are physical; ``diag`` is the
    phase vector indexed by the bits of ``positions`` in order.
    """
    positions: tuple[int, ...]
    diag: np.ndarray


Item = Union[LocalSegment, Reshard, ShardedFlip, ShardedDiag,
             ShardedReflect, LocalPerm, BitSwap]


@dataclass
class ShardedPlan:
    n: int
    k: int                               # log2(number of shards)
    items: list[Item] = field(default_factory=list)
    # perm[physical_position] = logical qubit, at plan END (for readout)
    final_perm: list[int] = field(default_factory=list)
    num_params: int = 0
    gate_count: int = 0

    @property
    def num_reshards(self) -> int:
        return sum(isinstance(i, (Reshard, BitSwap)) for i in self.items)

    def comm_bytes(self, dtype_bytes: int = 4) -> int:
        """Interconnect traffic per execution: a reshard all_to_all moves
        (K−1)/K of the full planar state across the links; a BitSwap
        ppermute moves exactly half of it."""
        K = 2**self.k
        state = 2 * (2**self.n) * dtype_bytes        # planar (re, im)
        total = 0
        for i in self.items:
            if isinstance(i, Reshard):
                total += state * (K - 1) // K
            elif isinstance(i, BitSwap):
                total += state // 2
        return total

    def hbm_bytes(self, dtype_bytes: int = 4) -> int:
        """Aggregate HBM traffic across shards per execution."""
        state = 2 * (2**self.n) * dtype_bytes
        passes = sum(i.plan.num_passes for i in self.items
                     if isinstance(i, LocalSegment))
        passes += sum(isinstance(i, (Reshard, ShardedDiag, LocalPerm,
                                     BitSwap))
                      for i in self.items)
        passes += 2 * sum(isinstance(i, ShardedReflect)
                          for i in self.items)
        return 2 * state * passes


def _support(op: CircuitOp) -> tuple[int, ...]:
    return tuple(op.controls) + tuple(op.targets)


def compile_sharded(circ: Circuit, k: int, window: int = 7,
                    initial_perm=None) -> ShardedPlan:
    """Compile a circuit for a 2^k-way sharded register.

    Tracks the logical→physical qubit permutation across reshards.  Ops on
    disjoint qubit sets commute, so when an op touches a sharded axis the
    scheduler first pulls forward every later op that is already local and
    commutes past the blocked ones — a full layer over all n qubits then
    costs exactly ONE all_to_all, not one per blocked op.  The exchange
    block is chosen to evict qubits that no blocked op needs (Belady-style:
    minimise overlap with the pending-front support).

    ``initial_perm``: the state's starting physical→logical permutation
    (a previous plan's ``final_perm``) — lets program segments between
    collapse points compose without restoring logical order in between.
    """
    n = circ.n
    if k < 0 or (k and n - k < k):
        raise ValueError(f"cannot shard {n} qubits {2**k} ways")
    if initial_perm is None:
        pos = list(range(n))             # pos[logical] = physical
        perm = list(range(n))            # perm[physical] = logical
    else:
        perm = list(initial_perm)
        if sorted(perm) != list(range(n)):
            raise ValueError(f"initial_perm {perm} is not a permutation "
                             f"of range({n})")
        pos = [0] * n
        for p, q in enumerate(perm):
            pos[q] = p
    splan = ShardedPlan(n=n, k=k, num_params=circ.num_params,
                        gate_count=circ.gate_count)
    pending = Circuit(n - k)
    pending.num_params = circ.num_params

    def flush():
        nonlocal pending
        if pending.ops:
            splan.items.append(LocalSegment(compile_circuit(pending, window)))
            pending = Circuit(n - k)
            pending.num_params = circ.num_params

    def is_local(op: CircuitOp) -> bool:
        return all(pos[q] >= k for q in _support(op))

    def emit(op: CircuitOp) -> None:
        qubits = _support(op)
        local = [pos[q] - k for q in qubits]
        nc = len(op.controls)
        pending.ops.append(CircuitOp(op.kind, tuple(local[nc:]),
                                     tuple(local[:nc]), op.matrix,
                                     op.param_idx, op.maker, op.index))

    def reshard_for(must_avoid: set[int], prefer_avoid: set[int]) -> None:
        """Exchange sharded axes with a local block disjoint from
        ``must_avoid`` physical positions, minimising ``prefer_avoid``
        overlap (evict qubits the pending front does not need)."""
        best, best_cost = None, None
        for m in range(n - k, k - 1, -1):
            block = set(range(m, m + k))
            if block & must_avoid:
                continue
            cost = len(block & prefer_avoid)
            if best_cost is None or cost < best_cost:
                best, best_cost = m, cost
                if cost == 0:
                    break
        if best is None:
            raise ValueError(
                f"support {sorted(must_avoid)} leaves no free local block "
                f"for resharding ({n} qubits, k={k})")
        flush()
        splan.items.append(Reshard(best))
        for i in range(k):
            a, b = perm[i], perm[best + i]
            perm[i], perm[best + i] = b, a
            pos[a], pos[b] = best + i, i

    def physical_index(logical_index: int) -> int:
        out = 0
        for p in range(n):
            bit = (logical_index >> (n - 1 - perm[p])) & 1
            out |= bit << (n - 1 - p)
        return out

    ops = []
    for op in _detect_op_reflections(list(circ.ops), n):
        if isinstance(op, _OpReflect):
            ops.append(op)
            continue
        dop = gate_as_diag(op)
        ops.append(dop if dop is not None else op)
    emitted = [False] * len(ops)
    i = -1
    while i + 1 < len(ops):
        i += 1
        op = ops[i]
        if emitted[i]:
            continue
        if (not isinstance(op, _OpReflect) and op.kind == "gate"
                and op.matrix is not None and not is_local(op)):
            # algebraic rewrite instead of a reshard: spanning swaps → 3
            # CXs; controlled gates → V†·controlled-diag·V — the diagonal
            # factors across shards (ShardedDiag, zero communication) and
            # the V factors touch only the (usually local) target qubits
            dec = (decompose_spanning_swap(op)
                   or eigen_decompose_controlled(op))
            if dec is not None:
                dec = [gate_as_diag(d) or d for d in dec]
                ops[i:i + 1] = dec
                emitted[i:i + 1] = [False] * len(dec)
                i -= 1
                continue
        if isinstance(op, _OpReflect):
            # map logical factors to physical axes under the current perm
            flush()
            phys = [op.factors[perm[p]] for p in range(n)]
            splan.items.append(ShardedReflect(tuple(phys[:k]),
                                              tuple(phys[k:])))
            emitted[i] = True
            continue
        if op.kind == "flip":
            flush()
            mp = physical_index(op.index)
            splan.items.append(ShardedFlip(mp >> (n - k),
                                           mp & ((1 << (n - k)) - 1)))
            emitted[i] = True
            continue
        if op.kind == "diag" and not is_local(op):
            # diagonals factor across shards: emit in place, no reshard
            flush()
            splan.items.append(ShardedDiag(
                tuple(pos[q] for q in op.targets),
                np.asarray(op.matrix, np.complex128)))
            emitted[i] = True
            continue
        if not is_local(op):
            # pull forward commuting local ops, gathering the blocked front
            barrier = set(_support(op))
            blocked = set(_support(op))
            for j in range(i + 1, len(ops)):
                if emitted[j]:
                    continue
                oj = ops[j]
                if oj.kind in ("flip", "reflect"):   # all-qubit: hard wall
                    break
                sj = set(_support(oj))
                if sj & barrier:
                    barrier |= sj
                    blocked |= sj
                    continue
                if is_local(oj):
                    emit(oj)
                    emitted[j] = True
                else:
                    barrier |= sj
                    blocked |= sj
            must = {pos[q] for q in _support(op)}
            prefer = {pos[q] for q in blocked}
            reshard_for(must, prefer)
            if not is_local(op):         # pragma: no cover - guarded above
                raise AssertionError("reshard failed to localise op")
        emit(op)
        emitted[i] = True
    flush()
    # adjacent sharded diagonals commute: fuse runs into one pass each
    merged: list[Item] = []
    for item in splan.items:
        if (isinstance(item, ShardedDiag) and merged
                and isinstance(merged[-1], ShardedDiag)):
            prev = merged[-1]
            union = tuple(sorted(set(prev.positions) | set(item.positions)))
            if len(union) <= 12:
                merged[-1] = ShardedDiag(union, combine_diag_vectors(
                    prev.positions, prev.diag, item.positions, item.diag,
                    union))
                continue
        merged.append(item)
    splan.items = merged
    splan.final_perm = list(perm)
    return splan


def plan_reshards_to_localize(perm, n: int, k: int, logical_targets):
    """Reshard items making every target's physical position local (>= k).

    Collapse points (mid-circuit ``meas``/``disc``) need their target
    qubits on local axes so the outcome split is shard-local; ONE
    all_to_all always suffices — exchange the k sharded axes with a local
    block disjoint from the targets' current positions.  Returns
    (items, new_perm).
    """
    perm = list(perm)
    if k == 0:
        return [], perm
    pos = [0] * n
    for p, q in enumerate(perm):
        pos[q] = p
    if all(pos[q] >= k for q in logical_targets):
        return [], perm
    items: list = []
    must = {pos[q] for q in logical_targets}
    best = None
    for m in range(n - k, k - 1, -1):
        if not (set(range(m, m + k)) & must):
            best = m
            break
    if best is None:
        # no contiguous free block: transpose the local axes so local
        # targets sit at the FRONT of the local region, freeing the tail
        # (zero communication, one HBM pass)
        local_t = sorted(p - k for p in must if p >= k)
        if (n - k) - len(local_t) < k:
            raise ValueError(
                f"cannot localize targets {sorted(logical_targets)}: only "
                f"{(n - k) - len(local_t)} non-target local axes for a "
                f"width-{k} exchange block ({n} qubits)")
        order = tuple(local_t
                      + [a for a in range(n - k) if a not in local_t])
        items.append(LocalPerm(order))
        old_local = perm[k:]
        perm[k:] = [old_local[a] for a in order]
        best = n - k
    for i in range(k):
        perm[i], perm[best + i] = perm[best + i], perm[i]
    items.append(Reshard(best))
    return items, perm


def plan_perm_to_identity(perm, n: int, k: int):
    """Layout items restoring logical qubit order (perm → identity).

    BitSwaps place each of logical 0..k-1 at its sharded slot (evicting a
    mis-sharded occupant to a local axis first when needed), then one
    LocalPerm sorts the local region.  Any layout is reachable — the
    full-block all_to_all alone cannot mix the sharded set with the local
    set in the tight n = 2k case.  Used by per-op executors (the sharded
    device-ensemble engine) that keep a canonical identity layout so
    branch ensembles stay concatenable.  Returns (items, identity perm).
    """
    perm = list(perm)
    items: list = []
    for p in range(k):
        if perm[p] == p:
            continue
        pos = perm.index(p)
        if pos < k:
            # logical p is sharded at the wrong slot: evict to local axis 0
            items.append(BitSwap(pos, 0))
            perm[pos], perm[k] = perm[k], perm[pos]
            pos = k
        items.append(BitSwap(p, pos - k))
        perm[p], perm[pos] = perm[pos], perm[p]
    cur = perm[k:]
    target = sorted(cur)
    order = [cur.index(q) for q in target]
    if order != list(range(n - k)):
        items.append(LocalPerm(tuple(order)))
        perm[k:] = target
    return items, perm



def density_circuit(circ: Circuit) -> Circuit:
    """Map an n-qubit circuit to its 2n-qubit row/column program on ρ.

    ``gate U`` → U on rows, conj(U) on columns; ``diag d`` → d on rows,
    conj(d) on columns; ``flip m`` (ρ → FρF, F = I − 2|m⟩⟨m|) → a ±1 diag
    over the n row axes and the same over the n column axes (a flip of one
    n-qubit basis state touches a full row and column of ρ, so it is a
    diagonal over the half-register, not a single 2n-register amplitude).
    """
    n = circ.n
    out = Circuit(2 * n)
    out.num_params = circ.num_params
    for op in circ.ops:
        rows = tuple(op.targets)
        cols = tuple(n + q for q in op.targets)
        crows = tuple(op.controls)
        ccols = tuple(n + q for q in op.controls)
        if op.kind == "gate":
            if op.matrix is not None:
                out.gate(op.matrix, rows, crows)
                out.gate(np.conj(np.asarray(op.matrix)), cols, ccols)
            else:
                out.param_gate(op.maker, rows, crows, param_idx=op.param_idx)
                out.param_gate(_conj_maker(op.maker), cols, ccols,
                               param_idx=op.param_idx)
        elif op.kind == "diag":
            out.diagonal(np.asarray(op.matrix), rows)
            out.diagonal(np.conj(np.asarray(op.matrix)), cols)
        elif op.kind == "flip":
            vec = np.ones(2**n, np.complex128)
            vec[op.index] = -1.0
            out.diagonal(vec, tuple(range(n)))
            out.diagonal(vec, tuple(range(n, 2 * n)))
        else:  # pragma: no cover - circuit IR has no other kinds
            raise ValueError(f"unknown op kind {op.kind!r}")
    return out


def compile_sharded_density(circ: Circuit, k: int, window: int = 7
                            ) -> ShardedPlan:
    """Compile an n-qubit circuit for a 2^k-way sharded planar ρ.

    The returned plan runs through the ordinary
    :func:`make_sharded_planar_runner` on the flat (2, 4^n) view of ρ.
    """
    return compile_sharded(density_circuit(circ), k, window=window)


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------

def _exchange(mesh: QubitMesh, send: torch.Tensor, splits=None
              ) -> torch.Tensor:
    """``all_to_all_single`` of a contiguous ``send``: its dim 0 in K equal
    chunks, or ``splits[r]`` elements to rank r (and as many from it).
    Returns what arrived.  Counts one ``num_reshards`` and the bytes sent
    to the other ranks as ``comm_bytes``."""
    own = send.shape[0] // mesh.size if splits is None else splits[mesh.rank]
    nbytes = (send.numel() - own * (send.numel() // send.shape[0])) \
        * send.element_size()
    profiling.count("num_reshards")
    profiling.count("comm_bytes", nbytes)
    if mesh.size == 1:
        return send.clone()
    with profiling.named_scope("qbot.shard.exchange", nbytes):
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, splits, splits, group=mesh.group)
    return recv


def _all_reduce(mesh: QubitMesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, a new tensor."""
    out = t.clone()
    if mesh.size > 1:
        dist.all_reduce(out, group=mesh.group)
    return out


def _bit(rank: int, k: int, p: int) -> int:
    """Rank ``rank``'s bit of sharded position ``p`` (0 the most
    significant): the shard holds the amplitudes whose leading k index bits
    spell its rank."""
    return (rank >> (k - 1 - p)) & 1


def _permute_qubits(x: torch.Tensor, order) -> torch.Tensor:
    """``x`` (..., 2^m) with its m qubit axes (the most significant first)
    permuted: new axis i holds old axis ``order[i]``.  Runs of axes that
    stay adjacent move as one axis, so any m stays within PyTorch's
    dimension limits."""
    runs: list = []
    for a in order:
        if runs and runs[-1][0] + runs[-1][1] == a:
            runs[-1][1] += 1
        else:
            runs.append([a, 1])
    by_start = sorted(range(len(runs)), key=lambda i: runs[i][0])
    where = {i: j for j, i in enumerate(by_start)}
    lead = x.dim() - 1
    t = x.reshape(*x.shape[:-1], *(2 ** runs[i][1] for i in by_start))
    t = t.permute(*range(lead), *(lead + where[i] for i in range(len(runs))))
    return t.contiguous().reshape(x.shape)


# ---------------------------------------------------------------------------
# the executor: ``qbot_tpu/tpu/sharded.py:565-592, 628-810``
# ---------------------------------------------------------------------------

def apply_bitswap_local(psi: torch.Tensor, item: BitSwap, n_local: int,
                        k: int, mesh: QubitMesh) -> torch.Tensor:
    """Apply a BitSwap to this rank's planar block ``psi``, (..., 2,
    2^n_local) with any leading batch dims: the rank keeps the local-axis
    slice equal to its own bit of ``shard_pos`` and receives the other
    slice from the rank that differs in that bit, one ``all_to_all_single``
    whose only non-empty chunk goes to that partner."""
    a = item.local_axis
    t = psi.reshape(*psi.shape[:-1], 2**a, 2, 2 ** (n_local - a - 1))
    bit = _bit(mesh.rank, k, item.shard_pos)
    partner = mesh.rank ^ (1 << (k - 1 - item.shard_pos))
    keep = t.select(-2, bit)
    send = t.select(-2, 1 - bit).contiguous()
    splits = [send.numel() if r == partner else 0 for r in range(mesh.size)]
    recv = _exchange(mesh, send.reshape(-1), splits).reshape(keep.shape)
    pair = (keep, recv) if bit == 0 else (recv, keep)
    return torch.stack(pair, dim=-2).reshape(psi.shape)


def _reshard_fn(item: Reshard, n: int, k: int, mesh: QubitMesh):
    """Exchange the sharded axes with local axes [m, m+k): the shard viewed
    as (2, pre, K, post) sends its chunk j of the K axis to rank j and
    stacks the chunks it receives along that axis in rank order (the
    reference's tiled ``all_to_all`` on axis 2).  ``all_to_all_single``
    splits dim 0, so K goes to the front and back."""
    K = 2**k
    pre, post = 2 ** (item.m - k), 2 ** (n - item.m - k)

    def apply(psi, params):
        lead = psi.dim() - 1          # the batch axes and the planes
        send = psi.reshape(*psi.shape[:-1], pre, K, post)
        send = send.movedim(lead + 1, 0)
        recv = _exchange(mesh, send.contiguous())
        return recv.movedim(0, lead + 1).contiguous().reshape(psi.shape)
    return apply


def _sharded_diag_fn(item: ShardedDiag, n_local: int, k: int, rank: int,
                     device):
    """Multiply by this rank's slice of the phase tensor: the sharded
    positions' bits come from the rank, the rest is an elementwise pass
    over the local axes."""
    d = np.asarray(item.diag, np.complex128)
    d = d.reshape((2,) * len(item.positions))
    d = d[tuple(_bit(rank, k, p) if p < k else slice(None)
                for p in item.positions)]
    local = [p - k for p in item.positions if p >= k]
    if local:
        return _diag_fn(n_local, local, d.reshape(-1), device)
    c = complex(d)

    def apply(psi, params):
        pr, pi = psi[..., 0, :], psi[..., 1, :]
        return torch.stack([c.real * pr - c.imag * pi,
                            c.real * pi + c.imag * pr], dim=-2)
    return apply


_LANES = 7          # the reflection kernels' lane width: T = 2^7


class _ShardedReflection:
    """ψ → ψ − 2⟨v|ψ⟩v/⟨v|v⟩ with v = s_d ⊗ v_loc on rank d.

    The sharded axes enter only through the rank's scalar s_d = Π_p
    f_p[bit_p(d)]; v_loc = ⊗ local factors is the same on every rank, held
    as the planar reflection's float32 tables t = A ⊗ B (its last 7 axes
    the lanes).  ``reflect_dot`` gives the lane dot of the shard, from which
    c_d = ⟨t|ψ_d⟩/⟨t|t⟩ is formed in float64 as the single-device
    reflection forms it; one ``all_reduce`` of the float64 complex
    conj(s_d)·c_d, divided by Σ_d |s_d|², gives c = ⟨v|ψ⟩/⟨v|v⟩ with the
    GLOBAL ⟨v|v⟩ = Σ_d |s_d|²·⟨t|t⟩ (the exact Householder reflection
    about the tables' own direction, which keeps the norm); then
    ``reflect_update`` with the rank's coefficient c·s_d.
    """

    def __init__(self, item: ShardedReflect, n_local: int, k: int,
                 rank: int, device):
        s = 1.0 + 0.0j
        s2 = 1.0
        for p, f in enumerate(item.shard_factors):
            f = np.asarray(f, np.complex128)
            s *= complex(f[_bit(rank, k, p)])
            s2 *= float(np.sum(np.abs(f) ** 2))
        self.s, self.s2 = s, s2
        local = [np.asarray(f, np.complex128) for f in item.local_factors]
        lanes = min(_LANES, n_local)
        tail = np.ones(1, np.complex128)
        for f in local[n_local - lanes:]:
            tail = np.kron(tail, f)
        self.refl = _Reflection(
            ReflectStep(tuple(local[:n_local - lanes]) + (tail,)), device)

    def __call__(self, psi: torch.Tensor, mesh: QubitMesh) -> torch.Tensor:
        refl = self.refl
        p3 = psi.reshape(*psi.shape[:-2], 2, refl.H, refl.T)
        c = refl.c64_from_lane_dot(kernels.reflect_dot(p3, refl.a, refl.b))
        sr, si = self.s.real, self.s.imag
        cr, ci = c[..., 0], c[..., 1]
        part = torch.stack([sr * cr + si * ci, sr * ci - si * cr], dim=-1)
        g = _all_reduce(mesh, part) / self.s2
        gr, gi = g[..., 0], g[..., 1]
        coef = torch.stack([gr * sr - gi * si, gr * si + gi * sr], dim=-1)
        out, _ = kernels.reflect_update(p3, coef.float(), refl.a, refl.b,
                                        refl.no_flips)
        return out.reshape(psi.shape)


def _item_fn(item, n: int, k: int, mesh: QubitMesh):
    """``(psi, params) -> psi`` of one item on this rank, its tables
    prepared on the rank's device."""
    n_local, device = n - k, mesh.device
    if isinstance(item, LocalSegment):
        run = make_planar_runner(item.plan)

        def segment(psi, params):
            with profiling.named_scope("qbot.shard.segment"):
                return run(psi, params)
        return segment
    if isinstance(item, Reshard):
        return _reshard_fn(item, n, k, mesh)
    if isinstance(item, BitSwap):
        return lambda psi, params: apply_bitswap_local(psi, item, n_local,
                                                       k, mesh)
    if isinstance(item, ShardedDiag):
        return _sharded_diag_fn(item, n_local, k, mesh.rank, device)
    if isinstance(item, ShardedReflect):
        refl = _ShardedReflection(item, n_local, k, mesh.rank, device)
        return lambda psi, params: refl(psi, mesh)
    if isinstance(item, LocalPerm):
        return lambda psi, params: _permute_qubits(psi, item.order)
    raise TypeError(f"unknown sharded plan item {item!r}")


def make_sharded_planar_runner(splan: ShardedPlan, mesh: QubitMesh):
    """``run(psi_local, params=None) -> psi_local``: the plan on this
    rank's (2, 2^(n-k)) float32 shard, or on each of a (B, 2, 2^(n-k))
    batch of them, every rank of ``mesh`` calling it (SPMD).  Every item's tables are prepared once, on the rank's device;
    ``params`` (1-D, on that device) feeds the local segments'
    parameterised gates.  Out of place: the caller's shard is never
    written."""
    n, k = splan.n, splan.k
    if mesh.size != 2**k:
        raise ValueError(f"the mesh has {mesh.size} ranks, the plan "
                         f"{2**k} shards")
    fns = []
    for item in splan.items:
        if isinstance(item, ShardedFlip):
            if mesh.rank == item.owner:
                fns.append((item.local_index, None))
        else:
            fns.append((None, _item_fn(item, n, k, mesh)))

    def run(psi: torch.Tensor, params=None) -> torch.Tensor:
        given = psi
        for flip, fn in fns:
            if fn is not None:
                psi = fn(psi, params)
                continue
            # a flip negates one amplitude in place, of a copy the first
            # time it would write the caller's shard
            if psi is given:
                psi = psi.clone()
            psi[..., flip] = -psi[..., flip]
        return psi
    return run


def sharded_zero_state(n: int, mesh: QubitMesh) -> torch.Tensor:
    """This rank's shard of |0…0⟩: (2, 2^(n-k)) float32 on its device."""
    psi = torch.zeros((2, 2 ** (n - mesh.k)), dtype=REAL_DTYPE,
                      device=mesh.device)
    if mesh.rank == 0:
        psi[0, 0] = 1.0
    return psi


def shard_planar(psi, mesh: QubitMesh) -> torch.Tensor:
    """This rank's shard of a full planar (2, 2^n) state (a tensor or an
    array): the block of amplitudes whose leading k index bits spell the
    rank, as float32 on the rank's device."""
    flat = torch.as_tensor(psi).reshape(2, -1)
    size = flat.shape[1] // mesh.size
    block = flat[:, mesh.rank * size:(mesh.rank + 1) * size]
    return block.to(device=mesh.device, dtype=REAL_DTYPE).contiguous()


def gather_planar(psi: torch.Tensor, mesh: QubitMesh
                  ) -> Optional[torch.Tensor]:
    """The full (2, 2^n) state of the shards on rank 0, on its device;
    None on the other ranks.  One ``gather``; every rank calls it."""
    src = psi.contiguous()
    parts = ([torch.empty_like(src) for _ in range(mesh.size)]
             if mesh.rank == 0 else None)
    dist.gather(src, parts, dst=0, group=mesh.group)
    return None if parts is None else torch.cat(parts, dim=1)


def unpermute_planar(psi: torch.Tensor, perm) -> torch.Tensor:
    """Restore the logical qubit order of a full (2, 2^n) planar state
    whose axis p holds logical qubit ``perm[p]`` (a runner's output layout,
    ``splan.final_perm``, after :func:`gather_planar`).  A full-state
    transpose, for inspection and the tests: readout goes through
    :func:`sharded_probs_fn`, which handles the permutation per shard."""
    pos = [0] * len(perm)
    for p, q in enumerate(perm):
        pos[q] = p
    return _permute_qubits(psi, pos)


def _scatter_index(device, offset: int, weights) -> torch.Tensor:
    """Output index of each entry of a partial marginal whose axes (the
    most significant first) carry the output bits ``weights``, plus the
    rank's ``offset``."""
    m = len(weights)
    ar = torch.arange(2**m, device=device)
    idx = torch.full_like(ar, offset)
    for r, w in enumerate(weights):
        idx += ((ar >> (m - 1 - r)) & 1) * w
    return idx


def sharded_probs_fn(splan: ShardedPlan, mesh: QubitMesh, targets=None):
    """``probs(psi_local)``: the marginal computation-basis probabilities
    of logical ``targets`` (sorted; all qubits if None), float32 on every
    rank's device.  Each rank sums its shard's marginal over its local
    axes, scatters it at the offset its rank's bits give the sharded
    targets, and one ``all_reduce`` assembles the distribution."""
    n, k = splan.n, splan.k
    pos = [0] * n
    for p, q in enumerate(splan.final_perm):
        pos[q] = p
    targets = list(range(n)) if targets is None else sorted(targets)
    width = len(targets)
    offset, local = 0, []
    for i, q in enumerate(targets):
        weight = 1 << (width - 1 - i)
        if pos[q] < k:
            offset += _bit(mesh.rank, k, pos[q]) * weight
        else:
            local.append((pos[q] - k, weight))
    local.sort()                  # the marginal's axes: physical order
    axes = [a for a, _ in local]
    idx = _scatter_index(mesh.device, offset, [w for _, w in local])

    def probs(psi: torch.Tensor) -> torch.Tensor:
        marg = _marginal(psi[0] ** 2 + psi[1] ** 2, axes, n - k)
        out = torch.zeros(2**width, dtype=marg.dtype, device=psi.device)
        out[idx] = marg
        return _all_reduce(mesh, out)
    return probs


# ---------------------------------------------------------------------------
# sharded density matrices: ``qbot_tpu/tpu/sharded.py:878-1043``
#
# ρ, planar (2, 2^n, 2^n), runs as the flat (2, 4^n) planar state of 2n
# qubits (rows [0, n), columns [n, 2n)) through the statevector runner.  A
# trace or diagonal over a row axis and its column axis is taken on a view
# of the flat shard as (pre, 2, mid, 2, post), so any n stays within
# PyTorch's dimension limits.
# ---------------------------------------------------------------------------

def _pair_view(t: torch.Tensor, count: int, a: int, b: int) -> torch.Tensor:
    """``t`` (..., 2^count) viewed as (..., pre, 2, mid, 2, post) around
    its qubit axes a < b."""
    return t.reshape(*t.shape[:-1], 2**a, 2, 2 ** (b - a - 1), 2,
                     2 ** (count - b - 1))


def shard_density(rho_planar, mesh: QubitMesh) -> torch.Tensor:
    """This rank's shard of a planar (2, 2^n, 2^n) ρ, flattened to the
    runner's (2, 4^n) layout: sharded over its leading row-qubit axes."""
    return shard_planar(rho_planar, mesh)


def sharded_zero_density(n: int, mesh: QubitMesh) -> torch.Tensor:
    """This rank's shard of |0…0⟩⟨0…0| as a flat planar (2, 4^n)."""
    return sharded_zero_state(2 * n, mesh)


def unpermute_density(rho_flat: torch.Tensor, perm) -> torch.Tensor:
    """A runner's full flat planar ρ (after :func:`gather_planar`) in
    logical order, (2, 2^n, 2^n)."""
    n = len(perm) // 2
    return unpermute_planar(rho_flat, perm).reshape(2, 2**n, 2**n)


def sharded_density_discard(rho_flat: torch.Tensor, n: int, k: int, targets,
                            mesh: QubitMesh, perm=None):
    """``disc`` on a sharded density matrix: Tr over ``targets``, the
    reduced sharded ρ (the register shrinks).

    ``rho_flat``: this rank's shard of the flat planar (2, 4^n) ρ in the
    layout ``perm`` (a density plan's ``final_perm`` over 2n axes; identity
    if None).  Each discarded qubit q contracts its row axis q with its
    column axis n+q: both are first made local (one exchange covers all of
    them), then each shard sums their diagonal.  Returns (this rank's shard
    of the reduced flat ρ, new_perm over 2(n−t) axes in the reduced
    register's numbering).
    """
    targets = sorted(set(int(q) for q in targets))
    t = len(targets)
    n2 = 2 * n
    perm = list(range(n2)) if perm is None else list(perm)
    pair_axes = [q for q in targets] + [n + q for q in targets]
    items, perm = plan_reshards_to_localize(perm, n2, k, pair_axes)
    if items:
        splan = ShardedPlan(n=n2, k=k, items=items, final_perm=perm)
        rho_flat = make_sharded_planar_runner(splan, mesh)(rho_flat)
    pos = [0] * n2
    for p, q in enumerate(perm):
        pos[q] = p
    tags = list(range(k, n2))       # physical position of each local axis
    reduced = rho_flat
    for q in targets:
        a, b = sorted((tags.index(pos[q]), tags.index(pos[n + q])))
        v = _pair_view(reduced, len(tags), a, b)
        reduced = (v[..., 0, :, 0, :] + v[..., 1, :, 1, :]).reshape(2, -1)
        del tags[b], tags[a]

    # the reduced register renumbers: logical row q → q' = q − #targets<q,
    # column n+q → (n−t)+q'; physical axes = sharded positions then the
    # surviving local axes in order
    removed_phys = {pos[q] for q in targets} | {pos[n + q] for q in targets}

    def relabel(q):
        if q < n:                        # row axis
            return q - sum(1 for r in targets if r < q)
        qq = q - n
        return (n - t) + qq - sum(1 for r in targets if r < qq)

    new_perm = [relabel(q) for p, q in enumerate(perm)
                if p not in removed_phys]
    return reduced, new_perm


def sharded_density_probs_fn(splan: ShardedPlan, mesh: QubitMesh,
                             targets=None):
    """``probs(rho_local)``: the marginal computation-basis probabilities
    of logical ``targets`` (the diagonal of the reduced ρ), float32 on every
    rank's device.

    ``splan`` is a density plan over 2n axes (:func:`compile_sharded_density`);
    logical qubit q lives at the physical positions of axes q (row) and n+q
    (column) under ``splan.final_perm``.  Per shard, qubit pairs are
    diagonal-extracted (kept targets) or traced (the rest), pair by pair; a
    pair with one sharded side selects the rank's bit on the other, and a
    pair with both sides sharded contributes only on ranks whose two bits
    agree.  Shard results scatter at their rank's offset and one
    ``all_reduce`` assembles the marginal.
    """
    n2, k = splan.n, splan.k
    n = n2 // 2
    pos = [0] * n2
    for p, q in enumerate(splan.final_perm):
        pos[q] = p
    targets = list(range(n)) if targets is None else sorted(targets)
    width = len(targets)
    weight = {q: 1 << (width - 1 - i) for i, q in enumerate(targets)}
    rank = mesh.rank

    def probs(rho: torch.Tensor) -> torch.Tensor:
        # the diagonal of a Hermitian ρ is real: only the real plane counts
        t = rho[0]
        tags: list = [("local", p) for p in range(k, n2)]
        agree, offset = True, 0
        for q in range(n):
            pr, pc = pos[q], pos[n + q]
            if pr >= k and pc >= k:
                a, b = sorted((tags.index(("local", pr)),
                               tags.index(("local", pc))))
                v = _pair_view(t, len(tags), a, b)
                d0, d1 = v[:, 0, :, 0, :], v[:, 1, :, 1, :]
                del tags[b], tags[a]
                if q in weight:
                    t = torch.stack([d0, d1], dim=-1).reshape(-1)
                    tags.append(("q", q))
                else:
                    t = (d0 + d1).reshape(-1)
            elif pr < k and pc < k:
                br, bc = _bit(rank, k, pr), _bit(rank, k, pc)
                agree = agree and br == bc
                offset += br * weight.get(q, 0)
            else:
                shard_p, local_p = (pr, pc) if pr < k else (pc, pr)
                bit = _bit(rank, k, shard_p)
                a = tags.index(("local", local_p))
                t = t.reshape(2**a, 2, -1)[:, bit].reshape(-1)
                del tags[a]
                offset += bit * weight.get(q, 0)
        out = torch.zeros(2**width, dtype=t.dtype, device=t.device)
        if agree:
            idx = _scatter_index(t.device, offset,
                                 [weight[q] for _, q in tags])
            out[idx] = t.reshape(-1)
        return _all_reduce(mesh, out)
    return probs
