"""Device kernel milliseconds of the traced window over its
trajectories."""


def read(rec):
    if rec.trace is None or not rec.trace.kernel_s \
            or not rec.work.get("samples"):
        return None
    return 1e3 * rec.trace.kernel_s / rec.work["samples"]
