"""Host milliseconds a run in the program's preparation spans (self time of
``qbot.ensemble.init``, ``qbot.ensemble.compile`` and ``qbot.plan.prepare``,
``qbot_tpu_torch.utils.profiling.span_totals``): the lowered ket made
planar and uploaded, each segment compiled, each plan's step tables folded
and uploaded.  The program's spans record while a profiler traces, so a
traced run's table holds the window alone; a program without them gives
nothing."""

PREP = ("qbot.ensemble.init", "qbot.ensemble.compile", "qbot.plan.prepare")


def read(rec):
    from qbot_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    if rec.trace is None or totals is None or not rec.runs:
        return None
    spans = totals()
    found = [spans[name]["self_s"] for name in PREP if name in spans]
    if not found:
        return None
    return 1e3 * sum(found) / rec.runs
