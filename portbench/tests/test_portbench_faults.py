"""A whole run of each cell, cut to the CPU's size and past the harness's
look for a card, with the timed path broken underneath
(``portbench/faults.py``): ``correct`` comes out false for each fault the
cell can have.  No cell spans cards, so none can leave out an exchange
between them."""
from __future__ import annotations

import pytest

from portbench import faults
from portbench.tests._small import SMALL, measure, small_spec

ENSEMBLE = [w for w in SMALL if w.startswith("ens")]
SAMPLED = [w for w in ENSEMBLE if small_spec(w)["traffic"]["sample"]]


@pytest.mark.parametrize("workload", list(SMALL))
def test_sound_runs_are_correct(workload):
    assert measure(small_spec(workload))["correct"]


@pytest.mark.parametrize("workload", list(SMALL))
@pytest.mark.parametrize("fault", [faults.stale_step, faults.altered_answer])
def test_fault_fails(workload, fault, monkeypatch):
    fault(monkeypatch.setattr)
    result = measure(small_spec(workload))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", ENSEMBLE)
def test_half_batch_fails(workload, monkeypatch):
    faults.half_batch(monkeypatch.setattr)
    result = measure(small_spec(workload))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", SAMPLED)
@pytest.mark.parametrize("fault", [faults.draw_zero, faults.draw_shared])
def test_sampler_fault_fails_the_draws(workload, fault, monkeypatch):
    """A sampler that ignores the Born weights, or gives every particle one
    draw, is caught by the draws pooled over the window's runs."""
    fault(monkeypatch.setattr)
    result = measure(small_spec(workload))
    checks = result["checks"]
    assert checks["draw_chi2"]["value"] > checks["draw_chi2"]["limit"], \
        checks


def test_planted_restores_the_program():
    from qbot_tpu_torch.inference import ensemble_exec

    before = ensemble_exec._sample_outcomes
    with faults.planted("draw_zero"):
        assert ensemble_exec._sample_outcomes is not before
    assert ensemble_exec._sample_outcomes is before


def test_no_cell_spans_cards():
    from portbench.tests.test_portbench_manifest import MANIFEST

    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])
