"""The yardstick of the exchanges between cards: the published NVLink rate
of the H100 SXM and the least time a sharded plan's exchanges take, from the
bytes each rank sends, beside ``bounds.py``'s bounds of the work on a card.

NVLink 4 on the H100 SXM: 18 links, 900 GB/s a card in both directions
together, so 450 GB/s in one direction (NVIDIA H100 data sheet).  In a
sharded plan of K = 2^k ranks every rank sends as much as it receives, and
it sends in parallel to all its peers through the NVLink switch: the
exchanges of a run take at least the bytes one rank sends over 450 GB/s.
A Reshard (an all-to-all over the k sharded qubits) sends (K − 1)/K of each
rank's planar float32 shard, a BitSwap half of it; no other sharded item
crosses a link.  The count reads only the plan's item kinds and sizes.
"""
from __future__ import annotations

NVLINK_BYTES_S = 450e9     # H100 SXM: NVLink 4, one direction
EXCHANGES = ("Reshard", "BitSwap")


def sent_bytes(splan, dtype_bytes: int = 4) -> int:
    """Bytes one rank sends to the others in one run of ``splan``."""
    K = 2 ** splan.k
    shard = 2 * 2 ** (splan.n - splan.k) * dtype_bytes
    total = 0
    for item in splan.items:
        kind = type(item).__name__
        if kind == "Reshard":
            total += shard * (K - 1) // K
        elif kind == "BitSwap":
            total += shard // 2
    return total


def exchange_bound_s(splan) -> float:
    """Seconds one run's exchanges take at least: :func:`sent_bytes` over
    the NVLink rate."""
    return sent_bytes(splan) / NVLINK_BYTES_S
