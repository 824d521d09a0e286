"""Host seconds of the set-up's ``lower_program(..., mid_measure=True)``."""


def read(rec):
    return rec.parts.get("lower_s")
