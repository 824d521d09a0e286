"""Faults planted in the program under test, each a function of ``patch``
(``patch(owner, name, value)`` replaces an attribute, as pytest's
``monkeypatch.setattr`` does): the tests see ``correct`` come out false
under each, and ``python3 -m portbench.control --control-mode fault:NAME``
reads the numbers compared under one on the card.  The benchmark's own
runs plant none."""
from __future__ import annotations

import contextlib

import torch

from qbot_tpu_torch.frontend import lowering
from qbot_tpu_torch.inference import ensemble_exec
from qbot_tpu_torch.tpu import planar


def stale_step(patch):
    """The last step of every plan returns its state unchanged."""
    run = planar._run
    patch(planar, "_run",
          lambda psi, fns, params=None: run(psi, fns[:-1], params))


def half_batch(patch):
    """A batch's plans run on its first half only, the rest left as it
    was, and an ensemble's distributions are the mean over that half."""
    apply = ensemble_exec.apply_plan_planar
    weights_of = ensemble_exec._weights_of

    def apply_half(psi, plan, params=None):
        half = psi.shape[0] // 2
        out = psi.clone()
        if half:
            out[:half] = apply(psi[:half].contiguous(), plan, params)
        return out

    def mean_of_half(log_w, p_all):
        half = max(1, log_w.shape[0] // 2)
        return weights_of(log_w[:half], p_all[:half])

    patch(ensemble_exec, "apply_plan_planar", apply_half)
    patch(ensemble_exec, "_weights_of", mean_of_half)


def altered_answer(patch):
    """The answer is altered where it is produced: the largest readout
    probability halved, or 0.01 moved between a distribution's first and
    last outcomes."""
    probs = planar.planar_probs

    def altered_probs(psi, *args, **kwargs):
        p = probs(psi, *args, **kwargs).clone()
        p.view(-1)[int(p.argmax())] *= 0.5
        return p

    make = lowering._make_result

    def altered_result(basis, targets, p, provider=None):
        p = p.copy()
        p[0] += 0.01
        p[-1] -= 0.01
        return make(basis, targets, p, provider)

    patch(planar, "planar_probs", altered_probs)
    patch(lowering, "_make_result", altered_result)


def draw_zero(patch):
    """The sampler draws outcome 0 for every particle, whatever its Born
    distribution."""
    def zeros(gen, p_all):
        return torch.zeros(p_all.shape[0], dtype=torch.long,
                           device=p_all.device)

    patch(ensemble_exec, "_sample_outcomes", zeros)


def draw_shared(patch):
    """The sampler draws one outcome, by the first particle's Born
    distribution, and gives it to every particle."""
    sample = ensemble_exec._sample_outcomes

    def shared(gen, p_all):
        one = sample(gen, p_all[:1])
        return one.expand(p_all.shape[0]).contiguous()

    patch(ensemble_exec, "_sample_outcomes", shared)


FAULTS = {f.__name__: f for f in (stale_step, half_batch, altered_answer,
                                  draw_zero, draw_shared)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` planted for the duration of the block."""
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    FAULTS[name](patch)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
