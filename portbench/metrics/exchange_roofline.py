"""The least time the window's exchanges could take (the bytes rank 0 sends
over NVLink, ``portbench/comm_bounds.py``; the entry counts them as the
work ``exchange_bytes`` of a run) over the device time of the operations
in the traced window whose names begin with ``nccl``, in %; nothing without
such an operation among the trace summary's ``device_ops``."""


def read(rec):
    from portbench import comm_bounds

    if rec.trace is None or not rec.work.get("exchange_bytes"):
        return None
    nccl_s = sum(s for name, s in rec.trace.device_ops
                 if name.startswith("nccl"))
    if not nccl_s:
        return None
    return 100.0 * rec.work["exchange_bytes"] / comm_bounds.NVLINK_BYTES_S \
        / nccl_s
