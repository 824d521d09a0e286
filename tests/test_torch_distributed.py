"""Multi-host execution of the port: a 2-process gloo cluster on the CPU
(``qbot_tpu_torch/tpu/distributed.py``), the counterpart of
``tests/test_distributed.py``.

Two processes start with ``torchrun``'s environment, each its own host
(``LOCAL_WORLD_SIZE`` 1): ``initialize_multihost`` joins them,
``make_multihost_mesh`` puts the particle axis across the hosts (a 2 × 1
mesh), a sum crosses the process boundary, ``host_local_batch`` halves a
batch, and ``dryrun_step`` takes one HMC step with the chains split over
the particle axis, Grover on the qubit axis and a mid-circuit program on
the mesh.  Both processes return the same result, equal to the same dry
run on one process (a 1 × 1 mesh): the chains' angles bit for bit (each
chain's step does not depend on the split), the distributions within
1e-6.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from qbot_tpu_torch.tpu.distributed import dryrun_mesh, host_local_batch
from qbot_tpu_torch.tpu.sharding import _free_port

WORKER = Path(__file__).resolve().parent / "_torch_distributed_worker.py"


def test_two_process_cluster_sum_and_dryrun(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "WORLD_SIZE": "2", "RANK": str(rank),
               "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "TORCH_CPP_LOG_LEVEL": "ERROR"}
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert out.strip().endswith("OK"), out
    got = [dict(np.load(tmp_path / f"rank_{r}.npz")) for r in range(2)]
    single = dryrun_mesh(1, 1, device="cpu", timeout=240)
    for res in got:
        assert float(res["total"]) == 2.0
        assert list(res["shape"]) == [2, 1]
        assert int(res["batch"]) == 4
        np.testing.assert_array_equal(res["thetas"], single["thetas"])
        for key in ("grover", "a", "b"):
            np.testing.assert_allclose(res[key], single[key], atol=1e-6)


def test_host_local_batch_single_host():
    assert host_local_batch(8) == 8
    assert host_local_batch(7) == 7


def test_dryrun_refuses_chains_that_do_not_split():
    with pytest.raises(RuntimeError, match="do not split over 3"):
        dryrun_mesh(3, 1, device="cpu", timeout=240)
