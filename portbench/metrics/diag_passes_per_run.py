"""The density executor's elementwise diagonal passes over ρ a run: its
``density_diag_passes`` counter (``qbot_tpu_torch.utils.profiling
.span_counts``, the counts made while the program's spans record, which a
traced run's profiler limits to the window) over the window's runs; a
program without the counter gives nothing."""


def read(rec):
    from qbot_tpu_torch.utils import profiling

    counts = getattr(profiling, "span_counts", None)
    if rec.trace is None or counts is None or not rec.runs:
        return None
    n = counts().get("density_diag_passes")
    return None if n is None else n / rec.runs
