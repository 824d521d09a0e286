"""The share of the traced window in which no kernel, copy or memset ran on
the device, in %."""


def read(rec):
    if rec.trace is None or not rec.trace.busy_s:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
