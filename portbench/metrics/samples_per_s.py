"""Particle trajectories of the runs completed in the window (a sampled
particle, or a final branch of nonzero probability of the exact fan-out)
over its host seconds."""


def read(rec):
    if "samples" not in rec.work:
        return None
    return rec.work["samples"] / rec.window_s
