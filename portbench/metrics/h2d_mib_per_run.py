"""MiB a run the program hands from host arrays to the card: its
``h2d_bytes`` counter (``qbot_tpu_torch.utils.profiling.span_counts``, the
counts made while the program's spans record, which a traced run's
profiler limits to the window) over the window's runs; a program without
the counter gives nothing."""


def read(rec):
    from qbot_tpu_torch.utils import profiling

    counts = getattr(profiling, "span_counts", None)
    if rec.trace is None or counts is None or not rec.runs:
        return None
    n = counts().get("h2d_bytes")
    return None if n is None else n / rec.runs / 2 ** 20
