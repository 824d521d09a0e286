"""Gate applications of the runs completed in the window over its host
seconds."""


def read(rec):
    if "gates" not in rec.work:
        return None
    return rec.work["gates"] / rec.window_s
