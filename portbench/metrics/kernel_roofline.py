"""The least time the window's runs could take on one H100 (the bound of
every plan step run, the fresh states and the readouts, from
``portbench/bounds.py``) over the device kernel time of the traced window,
in %."""


def read(rec):
    if rec.trace is None or rec.bound_s is None or not rec.trace.kernel_s:
        return None
    return 100.0 * rec.bound_s * rec.runs / rec.trace.kernel_s
