"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB."""


def read(rec):
    if not rec.peak_bytes:
        return None
    return rec.peak_bytes / 2 ** 30
