"""The program under test for a device-ensemble configuration: a program
with mid-circuit measurement lowered once in set-up, then each run is
``run_lowered_ensemble`` on it: ``sample`` particles of SMC, each run with
its own seed drawn from ``--seed``, or the exact fan-out.

Set-up: ``lower_program(text, mid_measure=True)``, one warm-up run.  After
each sampled run the harness projects every final particle on two random
vectors of its own (``PROBES``, drawn on the device from ``--seed``): one
product that reads the final ensemble once, a few milliseconds of the
run, and 4 numbers a particle to the host.  The reference tells from them
which branch each particle of every run ended in.
"""
from __future__ import annotations

import numpy as np
import torch

from qbot_tpu_torch.frontend import lowering
from qbot_tpu_torch.tpu import kernels

PROBES = 2                 # random vectors each final particle is read on


class Entry:
    def __init__(self, config: dict, request, device, span):
        self.config, self.request = config, request
        self.device, self.span = torch.device(device), span
        kernels.set_dot_mode(config["precision"])
        self.rng = np.random.default_rng([request.seed, 2])
        self.kept = None
        self.run_readouts: list = []
        self.probe = None
        self.projections: list = []
        self.runs = 0

    def setup(self, parts: dict) -> None:
        """Lower (its host seconds into ``parts["lower_s"]``), warm up,
        and draw the probe vectors."""
        with self.span("lower") as clock:
            self.lp = lowering.lower_program(self.request.text,
                                             mid_measure=True)
        parts["lower_s"] = clock.seconds
        _, ens = self._once(int(self.rng.integers(0, 2 ** 63)))
        if self.request.sample:
            self._project(ens)

    def _once(self, seed: int):
        req = self.request
        with self.span("ensemble_run"):
            results, ens = lowering.run_lowered_ensemble(
                self.lp, max_particles=req.max_particles,
                window=self.config["window"], sample=req.sample, seed=seed,
                prune_tol=req.prune_tol, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        readouts = {k: np.asarray(v.probs) for k, v in results.items()}
        return readouts, ens

    def _project(self, ens) -> np.ndarray:
        """(P, 2, PROBES) projections of the particles' planes on the
        probe vectors."""
        psi = ens.psi
        if self.probe is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.request.seed % 2 ** 63)
            self.probe = torch.randn((psi.shape[-1], PROBES), generator=gen,
                                     device=self.device, dtype=psi.dtype)
        proj = psi.reshape(-1, psi.shape[-1]) @ self.probe
        return proj.reshape(psi.shape[0], 2, PROBES).cpu().numpy()

    def run(self) -> None:
        """One request.  A sampled run draws with its own seed and keeps
        the final ensemble of one run drawn from ``--seed`` (reservoir
        sampling), which holds its memory through the later runs; the
        exact fan-out, the same every run, keeps the last run's.  Every
        run's readouts are kept, and of a sampled run the projections and
        log-weights of its particles."""
        if not self.request.sample:
            self.kept = None
        readouts, ens = self._once(int(self.rng.integers(0, 2 ** 63)))
        self.runs += 1
        self.run_readouts.append(readouts)
        if self.request.sample:
            self.projections.append((self._project(ens),
                                     ens.log_w.double().cpu().numpy()))
        if not self.request.sample or \
                int(self.rng.integers(0, self.runs)) == 0:
            self.kept = (readouts, ens)

    def bound_s(self):
        return None

    def outputs(self) -> dict:
        readouts, ens = self.kept
        out = {"psi": ens.psi, "log_w": ens.log_w,
               "lost_mass": float(ens.lost_mass), "readouts": readouts,
               "run_readouts": self.run_readouts,
               "probe": self.probe, "projections": self.projections}
        self.kept = self.lp = None
        return out
