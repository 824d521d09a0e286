"""Host seconds from process start to the first timed run."""


def read(rec):
    return rec.setup_s
