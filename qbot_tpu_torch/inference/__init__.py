"""Inference layer: SMC particle ensembles, the device ensemble executor,
and HMC/NUTS over gate angles (port of :mod:`qbot_tpu.inference`)."""
from qbot_tpu_torch.inference.hmc import (
    HMCState,
    dual_averaging_warmup,
    hmc_init,
    hmc_step,
    make_circuit_log_prob,
    make_circuit_log_prob_planar,
    run_hmc,
    run_hmc_chains,
)
from qbot_tpu_torch.inference.nuts import (
    NutsStats,
    nuts_step,
    nuts_warmup,
    run_nuts,
    run_nuts_chains,
)
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
    "HMCState", "dual_averaging_warmup", "hmc_init", "hmc_step",
    "make_circuit_log_prob", "make_circuit_log_prob_planar", "run_hmc",
    "run_hmc_chains",
    "NutsStats", "nuts_step", "nuts_warmup", "run_nuts", "run_nuts_chains",
    "Ensemble", "branch", "effective_sample_size", "from_probs", "lift_vmap",
    "mix_to_density", "normalize", "resample_if_needed",
    "systematic_indices", "systematic_resample", "to_probval",
]
