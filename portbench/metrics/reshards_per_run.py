"""Exchanges of the sharded qubits a run (each Reshard or BitSwap): the
program's ``num_reshards`` counter (``qbot_tpu_torch.utils.profiling
.span_counts``, the counts made while the program's spans record, which a
traced run's profiler limits to rank 0's window) over the window's runs; a
program without the counter gives nothing."""


def read(rec):
    from qbot_tpu_torch.utils import profiling

    counts = getattr(profiling, "span_counts", None)
    if rec.trace is None or counts is None or not rec.runs:
        return None
    n = counts().get("num_reshards")
    return None if n is None else n / rec.runs
