"""Host milliseconds a run inside the program's ``qbot.sync`` spans
(``qbot_tpu_torch.utils.profiling.span_totals``): the host reads that wait
for the card (an ESS, a readout, a ``torch.nonzero``).  The program's spans
record while a profiler traces, so a traced run's table holds the window
alone; a program without them gives nothing."""


def read(rec):
    from qbot_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    if rec.trace is None or totals is None or not rec.runs:
        return None
    sync = totals().get("qbot.sync")
    if sync is None:
        return None
    return 1e3 * sync["total_s"] / rec.runs
