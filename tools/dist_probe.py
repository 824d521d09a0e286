#!/usr/bin/env python3
"""Which ``torch.distributed`` exchanges take CUDA tensors on this host, and
what the sharded register's exchange costs when it stages through host
memory.

    python3 tools/dist_probe.py [--qubits 26]

Every case runs in fresh processes (spawned; a refused collective can
abort its rank or break the group), all on card 0:

- two ``nccl`` ranks on the one GPU: one ``all_reduce``, NCCL's refusal;
- one ``nccl`` rank: ``all_reduce`` and ``all_to_all_single``;
- two ``gloo`` ranks, each collective of ``qbot_tpu_torch/tpu/sharded.py``
  on CUDA tensors in a group of its own: ``all_to_all_single`` of a state
  shard (2^qubits planar amplitudes split over the ranks) and of a few
  values, the pairwise exchange (``all_to_all_single`` with one non-empty
  chunk), ``batch_isend_irecv``, a float64 ``all_reduce``, ``gather``;
- ``gloo`` ranks exchanging a state's shards from pinned host memory (the
  copies included): seconds of one ``all_to_all_single`` on 2 and 4
  ranks, the median of 3 after one.

Prints one line per case, then the card (``nvidia-smi``) and one JSON
object of every result.
"""
from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import queue
import socket
import statistics
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _case(name: str, rank: int, size: int, qubits: int):
    dev = torch.device("cuda", 0)
    if name in ("nccl_all_reduce", "gloo_all_reduce_f64"):
        x = torch.full((2,), rank + 1.0, dtype=torch.float64, device=dev)
        dist.all_reduce(x)
        return x.tolist()
    if name == "nccl_all_to_all_single":
        x = torch.arange(8.0, device=dev)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return bool(torch.equal(x, y))
    if name.startswith("gloo_all_to_all_single_s"):
        count = 8 if name.endswith("small") else 2 * 2**qubits // size
        x = torch.full((count,), float(rank), device=dev)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        want = torch.arange(size, device=dev).repeat_interleave(count // size)
        return bool(torch.equal(y, want.float()))
    if name == "gloo_pairwise_all_to_all_single":
        x = torch.full((4,), float(rank), device=dev)
        y = torch.empty_like(x)
        splits = [4 if r == rank ^ 1 else 0 for r in range(size)]
        dist.all_to_all_single(y, x, splits, splits)
        return y.tolist()
    if name == "gloo_batch_isend_irecv":
        x = torch.full((3,), float(rank), device=dev)
        y = torch.empty_like(x)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, rank ^ 1),
                dist.P2POp(dist.irecv, y, rank ^ 1)]):
            req.wait()
        return y.tolist()
    if name == "gloo_gather":
        x = torch.full((3,), float(rank), device=dev)
        parts = ([torch.empty_like(x) for _ in range(size)] if rank == 0
                 else None)
        dist.gather(x, parts, dst=0)
        return None if parts is None else [p.tolist() for p in parts]
    if name == "gloo_staged_exchange_s":
        count = 2 * 2**qubits // size
        x = torch.randn(count, device=dev)
        times = []
        for _ in range(4):
            dist.barrier()
            t0 = time.perf_counter()
            host = torch.empty(x.shape, pin_memory=True)
            host.copy_(x)
            recv = torch.empty_like(host)
            dist.all_to_all_single(recv, host)
            recv.to(dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times[1:])
    raise ValueError(name)


def _rank(name, rank, size, backend, init, qubits, results) -> None:
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=init, world_size=size,
                                rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        out = _case(name, rank, size, qubits)
        torch.cuda.synchronize()
        results.put((rank, "ok", out))
        dist.destroy_process_group()
    except Exception as e:
        results.put((rank, "error", f"{type(e).__name__}: {e}"[:600]))
        traceback.print_exc()


def run_case(name: str, size: int, backend: str, qubits: int) -> dict:
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://localhost:{_port()}"
    procs = [ctx.Process(target=_rank, args=(name, r, size, backend, init,
                                             qubits, results))
             for r in range(size)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.time() + 180
    while len(got) < size and time.time() < deadline:
        try:
            rank, status, value = results.get(timeout=1.0)
            got[rank] = (status, value)
        except queue.Empty:
            if all(p.exitcode is not None for p in procs):
                break
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()
    return {"ranks": size, "backend": backend,
            "exit_codes": [p.exitcode for p in procs],
            "results": {r: got.get(r, ("no report", None))
                        for r in range(size)}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--qubits", type=int, default=26,
                        help="the state whose shards the large exchanges "
                             "move (default 26)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("tools/dist_probe.py needs a CUDA card")
    cases = [("nccl_all_reduce", 2, "nccl"), ("nccl_all_reduce", 1, "nccl"),
             ("nccl_all_to_all_single", 1, "nccl"),
             ("gloo_all_to_all_single_small", 2, "gloo"),
             ("gloo_all_to_all_single_state", 2, "gloo"),
             ("gloo_pairwise_all_to_all_single", 2, "gloo"),
             ("gloo_batch_isend_irecv", 2, "gloo"),
             ("gloo_all_reduce_f64", 2, "gloo"), ("gloo_gather", 2, "gloo"),
             ("gloo_staged_exchange_s", 2, "gloo"),
             ("gloo_staged_exchange_s", 4, "gloo")]
    report = {}
    for name, size, backend in cases:
        label = f"{name}[{size}]"
        report[label] = run_case(name, size, backend, args.qubits)
        print(f"{label}: {json.dumps(report[label])}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps({"torch": torch.__version__,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "qubits": args.qubits, "cases": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
