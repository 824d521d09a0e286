"""The four-card cell on four gloo ranks on the CPU, cut to 8 qubits: the
sharded reference (``portbench/reference/sharded.py``) against a dense
unitary, whole runs of the entry (``portbench/entries/sharded.py``) judged
correct, two faults planted in every rank's exchange failing the
judgement, and a rank that dies ending the run.

The ranks are the entry's own (``entries.sharded.ranks``): spawned once
for the module's process and kept, as ``python3 -m portbench.control``
keeps them."""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from portbench import comm_bounds, generator, run
from portbench.entries import sharded as entry
from portbench.families.brickwork import brickwork_ops
from portbench.reference import sharded as reference
from portbench.request import X, Request
from portbench.tests._small import ROOT

WORKLOAD = "sv33x4-brickwork"
N = 8
K = 4


def small_spec() -> dict:
    spec = run.load_cell(ROOT, WORKLOAD)
    spec["config"]["qubits"] = N
    spec["config"]["marginal_qubits"] = 5
    spec["traffic"].update(layers=6, repeats=2)
    return spec


def measure(spec: dict, seed: int = 20261018) -> dict:
    return run.measure(spec, seed, 0.05, False, "cpu", time.perf_counter())


def _haar(rng, d):
    z = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    q, r = np.linalg.qr(z)
    return q * np.conj(r.diagonal() / np.abs(r.diagonal()))


def mixed_request(seed: int) -> Request:
    """A brickwork with the gates the reference handles apart: controlled
    by sharded qubits with local targets, a sharded target controlled by a
    sharded qubit, a 2-qubit gate and a controlled gate on local qubits, a
    flip."""
    rng = np.random.default_rng(seed)
    ops = brickwork_ops(N, 3, seed)
    ops += [("gate", (5,), X, (0,)),
            ("gate", (4,), _haar(rng, 2), (0, 1)),
            ("gate", (0,), _haar(rng, 2), (1,)),
            ("gate", (3, 4), _haar(rng, 4), ()),
            ("gate", (3,), _haar(rng, 2), (6,)),
            ("flip", 0b10110101),
            ("gate", (1,), _haar(rng, 2), ())]
    ops += brickwork_ops(N, 2, seed + 1)
    return Request("circuit", N, seed, body_ops=ops, repeats=2)


def dense_state(request: Request) -> np.ndarray:
    """The request's state by full 2^n matrices, qubit 0 the most
    significant bit."""
    n, dim = request.n, 2 ** request.n
    psi = np.zeros(dim, np.complex128)
    psi[0] = 1.0
    for op in request.init_ops + request.body_ops * request.repeats:
        if op[0] == "flip":
            psi[op[1]] = -psi[op[1]]
            continue
        _, targets, m, controls = op
        bits = [n - 1 - q for q in targets]
        u = np.zeros((dim, dim), np.complex128)
        for col in range(dim):
            if not all((col >> (n - 1 - c)) & 1 for c in controls):
                u[col, col] = 1.0
                continue
            j = sum(((col >> b) & 1) << (len(bits) - 1 - i)
                    for i, b in enumerate(bits))
            rest = col & ~sum(1 << b for b in bits)
            for i in range(m.shape[0]):
                row = rest | sum(((i >> (len(bits) - 1 - s)) & 1) << b
                                 for s, b in enumerate(bits))
                u[row, col] += m[i, j]
        psi = u @ psi
    return psi


def _all_shards(outputs, request):
    """The reference's shards of every rank, in rank order."""
    mine = reference.simulate_shard(request, "cpu")
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return torch.cat(parts).numpy()


@pytest.mark.parametrize("kind", ["mixed", "brickwork"])
def test_reference_matches_a_dense_unitary(kind):
    request = mixed_request(7) if kind == "mixed" else \
        generator.make_request({"qubits": N}, {
            "family": "brickwork", "layers": 16, "repeats": 2}, 7)
    got = entry.ranks(K, "cpu").on_every_rank(_all_shards, request)
    np.testing.assert_allclose(got, dense_state(request), atol=1e-12)


def test_sent_bytes_are_the_plans():
    """Each rank's bytes a run, times K, are ``comm_bytes()`` of the cell's
    own plan (2 reshards at 33 qubits)."""
    from qbot_tpu_torch.tpu import sharded
    from portbench.entries.statevector import to_circuit

    spec = run.load_cell(ROOT, WORKLOAD)
    request = generator.make_request(spec["config"], spec["traffic"], 5)
    splan = sharded.compile_sharded(
        to_circuit(request.n, request.body_ops * request.repeats),
        spec["config"]["shard_qubits"], window="auto")
    assert comm_bounds.sent_bytes(splan) * K == splan.comm_bytes()
    assert splan.num_reshards == 2


def test_sound_runs_are_correct():
    for seed in (1, 2 ** 40 + 3):
        result = measure(small_spec(), seed)
        assert result["correct"], result["checks"]


_SAVED: dict = {}


def _plant(outputs, name):
    """The fault ``name`` in this rank's exchange (None: none)."""
    from qbot_tpu_torch.tpu import sharded

    exchange = _SAVED.setdefault("exchange", sharded._exchange)

    def wrong_order(mesh, send, splits=None):
        """A reshard stacks the chunks it receives in the wrong rank
        order."""
        recv = exchange(mesh, send, splits)
        return recv if splits is not None else torch.roll(recv, 1, 0)

    def stale(mesh, send, splits=None):
        """The exchange runs, and its received buffer is not used."""
        exchange(mesh, send, splits)
        return send.clone()

    faults = {None: exchange, "wrong_order": wrong_order,
              "stale_exchange": stale}
    sharded._exchange = faults[name]


@pytest.mark.parametrize("fault", ["wrong_order", "stale_exchange"])
def test_fault_in_the_exchange_fails(fault):
    ranks = entry.ranks(K, "cpu")
    ranks.on_every_rank(_plant, fault)
    try:
        result = measure(small_spec())
    finally:
        ranks.on_every_rank(_plant, None)
    assert not result["correct"], result["checks"]
    assert result["checks"]["state_gap"]["value"] > 0.1


def _die(outputs, rank):
    import os

    if dist.get_rank() == rank:
        os._exit(3)
    dist.barrier()


def test_a_rank_that_dies_ends_the_run():
    """Rank 1 exits while rank 0 waits on it in a collective: rank 0's
    process ends with exit code 1 within seconds, naming the rank."""
    code = ("from portbench.entries import sharded as e\n"
            "from portbench.tests.test_portbench_sharded import _die\n"
            "e.ranks(4, 'cpu').on_every_rank(_die, 1)\n"
            "print('returned')\n")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr[-2000:]
    assert "rank 1 of 4 exited" in out.stderr
    assert "returned" not in out.stdout
    assert time.perf_counter() - t0 < 90
