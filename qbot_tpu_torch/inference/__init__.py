"""Inference layer: SMC particle ensembles and the device ensemble executor.

Port of :mod:`qbot_tpu.inference` without HMC/NUTS over gate angles, which
need the kernels' backward (ROADMAP queue 1, item 8).
"""
from qbot_tpu_torch.inference.smc import (
    Ensemble,
    branch,
    effective_sample_size,
    from_probs,
    lift_vmap,
    mix_to_density,
    normalize,
    resample_if_needed,
    systematic_indices,
    systematic_resample,
    to_probval,
)

__all__ = [
    "Ensemble", "branch", "effective_sample_size", "from_probs", "lift_vmap",
    "mix_to_density", "normalize", "resample_if_needed",
    "systematic_indices", "systematic_resample", "to_probval",
]
