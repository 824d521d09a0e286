"""Plain sharded statevector reference: the request's circuit applied to
|0…0⟩ in complex128, distributed over the same K = 2^k ranks as the program
through ``torch.distributed`` directly, and the comparison that judges the
program's last state and readouts against it.

It imports nothing of the program and takes nothing the program made but
its outputs: the ops come from the request.  Rank r holds the amplitudes
whose k leading index bits (logical qubits 0..k-1, qubit 0 the most
significant) spell r, a flat complex128 shard of 2^(n-k) entries whose
index bits are qubits k..n-1 in order; the layout never changes.

- **Local gates** (every qubit of a gate's support local) are kept
  pending as blocks of neighbouring qubits, each with its matrix: a gate
  joins the blocks it overlaps while their span stays within GROUP qubits,
  else those blocks are applied first.  Applying blocks is one chunked
  matrix product over a (a, 2^g, b) view of the shard a group of up to
  GROUP neighbouring qubits, written back in place, CHUNK entries at a
  time, so a card holds the shard, the program's kept shard and a few
  chunks.
- **A 1-qubit gate on a sharded qubit** is kept as its 2 × 2 product and
  applied when another op needs that qubit: each rank exchanges its shard,
  chunk by chunk, with the rank that differs in that qubit's bit
  (``all_to_all_single``, every other split empty) and forms its own
  half of the product.  Pending local blocks are applied first.
- **A gate controlled by sharded qubits** with local targets acts on the
  ranks whose bits are 1, as a local gate there; **a 1-target gate on a
  sharded qubit controlled by sharded qubits alone** is the exchange above
  on those ranks.  Other gates on sharded qubits, and local supports wider
  than GROUP, raise: the brickwork has none.
- A flip negates one amplitude on the rank that owns it.

Torch's TF32 flags are off; complex128 products take no TF32 anyway.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from portbench.reference.statevector import _no_tf32, worst

GROUP = 6                  # qubits of one matrix product
CHUNK = 2 ** 26            # complex128 entries a chunk: 1 GiB


def _controlled_matrix(m, targets, controls, lo: int, width: int):
    """The (2^width)² matrix on qubits lo..lo+width-1 of ``m`` on
    ``targets`` where every qubit of ``controls`` is 1 (all inside the
    range, qubit lo the most significant)."""
    m = np.asarray(m, np.complex128)
    t_bits = [width - 1 - (q - lo) for q in targets]
    c_bits = [width - 1 - (q - lo) for q in controls]
    dim = 2 ** width
    out = np.zeros((dim, dim), np.complex128)
    for col in range(dim):
        if not all((col >> b) & 1 for b in c_bits):
            out[col, col] = 1.0
            continue
        j = sum(((col >> b) & 1) << (len(t_bits) - 1 - i)
                for i, b in enumerate(t_bits))
        base = col & ~sum(1 << b for b in t_bits)
        for i in range(m.shape[0]):
            row = base | sum(((i >> (len(t_bits) - 1 - s)) & 1) << b
                             for s, b in enumerate(t_bits))
            out[row, col] += m[i, j]
    return out


def _widen(block, lo: int, hi: int):
    """A block (its lo, hi, matrix) as a matrix on qubits lo..hi."""
    b_lo, b_hi, mat = block
    return np.kron(np.kron(np.eye(2 ** (b_lo - lo)), mat),
                   np.eye(2 ** (hi - b_hi)))


class Shard:
    """This rank's complex128 shard and the ops pending on it."""

    def __init__(self, n: int, device):
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.k = self.size.bit_length() - 1
        if self.size != 2 ** self.k or n < 2 * self.k:
            raise ValueError(f"{self.size} ranks cannot hold {n} qubits")
        self.L, self.device = n - self.k, device
        self.psi = torch.zeros(2 ** self.L, dtype=torch.complex128,
                               device=device)
        if self.rank == 0:
            self.psi[0] = 1.0
        self.blocks: list = []       # (lo, hi, matrix) on local qubits
        self.sharded: dict = {}      # sharded qubit -> pending 2 × 2

    def bit(self, q: int) -> int:
        """This rank's bit of sharded qubit ``q``."""
        return (self.rank >> (self.k - 1 - q)) & 1

    # local blocks --------------------------------------------------------

    def _apply_matrix(self, lo: int, mat) -> None:
        """``mat`` on local qubits lo.., in place, CHUNK entries a step."""
        g = int(round(math.log2(mat.shape[0])))
        a, d, b = 2 ** lo, 2 ** g, 2 ** (self.L - lo - g)
        mat = torch.from_numpy(mat).to(self.device)
        v = self.psi.view(a, d, b)
        if b == 1:
            rows = max(1, CHUNK // d)
            for i in range(0, a, rows):
                blk = v[i:i + rows, :, 0]
                blk.copy_(blk @ mat.T)
        elif d * b <= CHUNK:
            rows = CHUNK // (d * b)
            for i in range(0, a, rows):
                blk = v[i:i + rows]
                blk.copy_(torch.matmul(mat, blk))
        else:
            cols = max(1, CHUNK // (a * d))
            for j in range(0, b, cols):
                blk = v[:, :, j:j + cols]
                blk.copy_(torch.matmul(mat, blk))

    def _apply_blocks(self, blocks) -> None:
        """The blocks, neighbours in qubit order sharing a product while
        their span stays within GROUP."""
        group = []
        for block in sorted(blocks, key=lambda b: b[0]):
            if group and block[1] - group[0][0] >= GROUP:
                self._apply_group(group)
                group = []
            group.append(block)
        if group:
            self._apply_group(group)

    def _apply_group(self, group) -> None:
        lo, hi = group[0][0], group[-1][1]
        mat = np.eye(2 ** (hi - lo + 1), dtype=np.complex128)
        for block in group:
            mat = _widen(block, lo, hi) @ mat
        self._apply_matrix(lo, mat)

    def flush_local(self) -> None:
        self._apply_blocks(self.blocks)
        self.blocks = []

    def local_gate(self, m, targets, controls) -> None:
        """A gate on local qubits, merged with the pending blocks it
        overlaps, or after them when the merge would span more than
        GROUP qubits."""
        support = list(targets) + list(controls)
        lo, hi = min(support), max(support)
        if hi - lo >= GROUP:
            raise NotImplementedError(f"a local gate spanning {hi - lo + 1} "
                                      f"qubits (at most {GROUP})")
        hit = [b for b in self.blocks if b[0] <= hi and b[1] >= lo]
        self.blocks = [b for b in self.blocks if b[0] > hi or b[1] < lo]
        u_lo = min([lo] + [b[0] for b in hit])
        u_hi = max([hi] + [b[1] for b in hit])
        if u_hi - u_lo >= GROUP:
            self._apply_blocks(hit)
            hit, u_lo, u_hi = [], lo, hi
        mat = np.eye(2 ** (u_hi - u_lo + 1), dtype=np.complex128)
        for block in hit:
            mat = _widen(block, u_lo, u_hi) @ mat
        gate = _controlled_matrix(m, targets, controls, u_lo,
                                  u_hi - u_lo + 1)
        self.blocks.append((u_lo, u_hi, gate @ mat))

    # sharded qubits ------------------------------------------------------

    def _exchange_mix(self, q: int, m, take_part: bool) -> None:
        """2 × 2 ``m`` on sharded qubit ``q`` where ``take_part`` (the
        same on both ranks of a pair): every rank calls the same
        ``all_to_all_single`` a chunk, the pairs that take part sending
        each other their chunk."""
        partner = self.rank ^ (1 << (self.k - 1 - q))
        b = self.bit(q)
        mine_c, other_c = complex(m[b, b]), complex(m[b, 1 - b])
        for j in range(0, self.psi.numel(), CHUNK):
            mine = self.psi[j:j + CHUNK]
            c = mine.numel()
            send = torch.view_as_real(mine).reshape(-1) if take_part \
                else mine.new_empty(0, dtype=torch.float64)
            recv = torch.empty_like(send)
            splits = [send.numel() if r == partner and take_part else 0
                      for r in range(self.size)]
            dist.all_to_all_single(recv, send, splits, splits)
            if take_part:
                other = torch.view_as_complex(recv.view(c, 2))
                mine.copy_(mine * mine_c + other * other_c)

    def flush_sharded(self, qubits) -> None:
        """The pending gates of sharded ``qubits``, local blocks first."""
        qubits = [q for q in sorted(set(qubits)) if q in self.sharded]
        if not qubits:
            return
        self.flush_local()
        for q in qubits:
            self._exchange_mix(q, self.sharded.pop(q), True)

    # ops -----------------------------------------------------------------

    def gate(self, m, targets, controls) -> None:
        k = self.k
        sh_t = [t for t in targets if t < k]
        sh_c = [c for c in controls if c < k]
        loc_t = [t - k for t in targets if t >= k]
        loc_c = [c - k for c in controls if c >= k]
        if not sh_t and not sh_c:
            self.local_gate(m, loc_t, loc_c)
        elif len(targets) == 1 and not controls:
            q = targets[0]
            self.sharded[q] = np.asarray(m, np.complex128) @ \
                self.sharded.get(q, np.eye(2, dtype=np.complex128))
        elif not sh_t:
            support = loc_t + loc_c
            if max(support) - min(support) >= GROUP:
                raise NotImplementedError("a local support wider than GROUP")
            self.flush_sharded(sh_c)
            if all(self.bit(c) for c in sh_c):
                self.local_gate(m, loc_t, loc_c)
        elif len(targets) == 1 and not loc_c:
            self.flush_sharded(sh_t + sh_c)
            self.flush_local()
            self._exchange_mix(targets[0], np.asarray(m, np.complex128),
                               all(self.bit(c) for c in sh_c))
        else:
            raise NotImplementedError(
                f"a gate on sharded qubits {sh_t} with local controls "
                f"{loc_c} or several targets")

    def flip(self, index: int) -> None:
        self.flush_sharded(list(self.sharded))
        self.flush_local()
        if index >> self.L == self.rank:
            i = index & (2 ** self.L - 1)
            self.psi[i] = -self.psi[i]

    def apply_ops(self, ops) -> None:
        for op in ops:
            if op[0] == "flip":
                self.flip(op[1])
            else:
                _, targets, matrix, controls = op
                self.gate(matrix, list(targets), list(controls))

    def finish(self) -> torch.Tensor:
        self.flush_sharded(list(self.sharded))
        self.flush_local()
        return self.psi


def simulate_shard(request, device) -> torch.Tensor:
    """This rank's shard of the request's final state (init ops once, then
    the body ``repeats`` times); every rank of the default group calls
    it."""
    _no_tf32()
    shard = Shard(request.n, device)
    shard.apply_ops(request.init_ops)
    for _ in range(request.repeats):
        shard.apply_ops(request.body_ops)
    return shard.finish()


def _norm2(z: torch.Tensor) -> torch.Tensor:
    """Σ |z|² of a complex tensor, summed over its real and imaginary parts
    (no complex kernel: PyTorch compiles some of those at run time into a
    cache under the home directory)."""
    return torch.sum(torch.view_as_real(z).square())


def _sums(got: torch.Tensor, ref: torch.Tensor):
    """(‖got − ref‖², ‖ref‖²) of a planar float32 shard against a complex
    one, chunk by chunk, as float64 tensors."""
    num = torch.zeros((), dtype=torch.float64, device=ref.device)
    den = torch.zeros_like(num)
    for j in range(0, ref.numel(), CHUNK):
        r = ref[j:j + CHUNK]
        g = torch.complex(got[0, j:j + CHUNK].double(),
                          got[1, j:j + CHUNK].double())
        num += _norm2(g - r)
        den += _norm2(r)
    return num, den


def _marginal(ref: torch.Tensor, width: int, k: int, rank: int):
    """The reference's marginal of logical qubits 0..width-1, summed over
    the ranks (every rank gets it)."""
    rows = 2 ** (width - k)
    view = ref.view(rows, -1)
    part = torch.empty(rows, dtype=torch.float64, device=ref.device)
    step = max(1, CHUNK // view.shape[1])
    for i in range(0, rows, step):
        part[i:i + step] = torch.sum(
            torch.view_as_real(view[i:i + step]).square(), dim=(1, 2))
    out = torch.zeros(2 ** width, dtype=torch.float64, device=ref.device)
    out[rank * rows:(rank + 1) * rows] = part
    dist.all_reduce(out)
    return out


def judge_rank(outputs: dict, request, targets) -> dict | None:
    """On every rank: the reference's shard, then the readings; rank 0's
    are returned.  ``state_gap``: the relative L2 distance of the program's
    last state (every rank's shard, in logical order) from the reference's;
    ``probs_gap``: the largest distance of a readout's probability from the
    reference's marginal, over the largest reference probability."""
    got = outputs["state"]
    ref = simulate_shard(request, got.device)
    num, den = _sums(got, ref)
    sums = torch.stack([num, den])
    dist.all_reduce(sums)
    width = len(targets)
    if list(targets) != list(range(width)):
        raise ValueError(f"the readout's targets {targets} are not a "
                         f"leading block of qubits")
    k = dist.get_world_size().bit_length() - 1
    p_ref = _marginal(ref, width, k, dist.get_rank())
    del ref
    if dist.get_rank() != 0:
        return None
    state_gap = float(torch.sqrt(sums[0] / sums[1]))
    top = float(torch.max(p_ref))
    probs_gap = 0.0
    for probs in outputs["readouts"]:
        gap = torch.max(torch.abs(probs.to(p_ref.device).double() - p_ref))
        probs_gap = worst(probs_gap, float(gap) / top)
    return {"state_gap": state_gap, "probs_gap": probs_gap}


def judge(request, outputs: dict, device) -> dict:
    """Readings of the program's outputs against the reference, computed
    on every rank of the program's mesh (``outputs["on_every_rank"]``)."""
    return outputs["on_every_rank"](judge_rank, request, outputs["targets"])


def control_outputs(request, device, seed: int) -> dict:
    """This cell's control is the program's own ``bf16_3x``
    (``--control-mode bf16_3x``): the reference runs only beside the
    program's ranks."""
    raise NotImplementedError("the sharded reference has no TF32 control; "
                              "use --control-mode bf16_3x")
