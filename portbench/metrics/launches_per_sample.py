"""The program's hand-written kernel launches in the window
(``qbot_tpu_torch.tpu.kernels.launch_counts``) over its trajectories."""


def read(rec):
    if not rec.work.get("samples"):
        return None
    return sum(rec.launches.values()) / rec.work["samples"]
