"""The program's hand-written kernel launches in the window
(``qbot_tpu_torch.tpu.kernels.launch_counts``) over its runs."""


def read(rec):
    if not rec.runs:
        return None
    return sum(rec.launches.values()) / rec.runs
