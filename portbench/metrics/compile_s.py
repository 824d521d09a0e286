"""Host seconds of the set-up's ``compile_circuit`` calls."""


def read(rec):
    return rec.parts.get("compile_s")
