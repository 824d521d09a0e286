"""The least time the window's runs could take on one H100 (as
``kernel_roofline`` counts it) over the traced window's length, in %:
the whole run's share of the card's peak, idle time included."""


def read(rec):
    if rec.trace is None or rec.bound_s is None or not rec.trace.busy_s:
        return None
    return 100.0 * rec.bound_s * rec.runs / rec.trace.window_s
