"""The controls at each cell's own size, on the card: the control comes out
not correct on three seeds, where sound runs of the program come out
correct.  The control is the program in its ``bf16_3x`` dot mode where
that mode reaches the work (the brickwork's windows and pairs, the SMC
program's rotations, the exact fan-out's weights and readouts), else the
reference in the program's place in TF32 (Grover's reflections are f32
only).  The SMC cell's sampler faults (``portbench/faults.py``) fail it
too."""
from __future__ import annotations

import pytest

from portbench import control, run
from portbench.tests._small import ROOT

CONTROLS = {"sv26-brickwork": ["bf16_3x"], "sv26-grover": ["tf32"],
            "ens24-smc64": ["bf16_3x", "fault:draw_zero",
                            "fault:draw_shared"],
            "ens24-exact": ["bf16_3x"]}
SEEDS = (6100000001, 6100000002, 6100000003)


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", list(CONTROLS))
def test_control_is_not_correct(workload):
    _card()
    spec = run.load_cell(ROOT, workload)
    limits = spec["limits"]
    for seed in SEEDS:
        sound = control.readings(spec, spec["config"]["precision"], seed, 1.0)
        assert all(v <= limits[k] for k, v in sound.items()), (seed, sound)
        for mode in CONTROLS[workload]:
            got = control.readings(spec, mode, seed, 1.0)
            assert any(v > limits[k] for k, v in got.items()), \
                (seed, mode, got)
