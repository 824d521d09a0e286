"""One process of ``tests/test_torch_distributed.py``'s cluster.

Usage: ``python _torch_distributed_worker.py OUT_DIR`` with ``torchrun``'s
environment set (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  Joins the gloo
group (``initialize_multihost``), builds the host-aware mesh, sums a
count across the processes and runs the mesh dry run; writes
``rank_<r>.npz``.  Imports neither ``jax`` nor ``qbot_tpu``.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from qbot_tpu_torch.tpu.distributed import (  # noqa: E402
    dryrun_step,
    host_local_batch,
    initialize_multihost,
    make_multihost_mesh,
)


def main():
    torch.set_num_threads(1)
    initialize_multihost(device="cpu")
    mesh = make_multihost_mesh(device="cpu")
    total = torch.ones(())
    dist.all_reduce(total)          # crosses the process boundary
    out = dryrun_step(mesh)
    np.savez(os.path.join(sys.argv[1], f"rank_{dist.get_rank()}.npz"),
             total=float(total), shape=np.array([mesh.P, mesh.K]),
             batch=host_local_batch(8), **out)
    dist.destroy_process_group()
    print("OK")


if __name__ == "__main__":
    main()
