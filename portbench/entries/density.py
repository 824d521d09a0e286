"""The program under test for a density-matrix configuration: a circuit
compiled once in set-up, then each run builds the request's product
initial state ρ0 on the card, applies the body ``repeats`` times as
ρ → UρU† and reads the diagonal to the host.

Set-up: ``compile_circuit(body, window=config["window"],
pair=config["pair"])``, ``make_planar_density_runner(plan)``, a
page-locked host buffer for the readout, one warm-up run.  A run:
``product_density_planar`` of the request's factors on the device, the
runner ``repeats`` times, then ``planar_density_probs`` copied into the
host buffer.  The runs, the readouts kept and the outputs are the
statevector entry's.  A request with init ops is refused: the initial
state is the product of its factors.
"""
from __future__ import annotations

import torch

from portbench import density_bounds
from portbench.entries import statevector
from qbot_tpu_torch.tpu import compiler, planar


class Entry(statevector.Entry):
    def setup(self, parts: dict) -> None:
        """Compile (its host seconds into ``parts["compile_s"]``) and warm
        up."""
        req, cfg = self.request, self.config
        if req.init_ops:
            raise ValueError("a density request starts from its factors' "
                             "product and takes no init ops")
        with self.span("compile") as clock:
            self.plan = compiler.compile_circuit(
                statevector.to_circuit(req.n, req.body_ops),
                window=cfg["window"], pair=cfg["pair"])
        parts["compile_s"] = clock.seconds
        self.runner = planar.make_planar_density_runner(self.plan)
        self.host = torch.empty(2 ** req.n, dtype=torch.float32,
                                pin_memory=self.device.type == "cuda")
        self._once()

    def _once(self):
        with self.span("run"):
            out = planar.product_density_planar(self.request.rhos,
                                                self.device)
            for _ in range(self.request.repeats):
                out = self.runner(out)
        with self.span("readout"):
            probs = planar.planar_density_probs(out)
            self.host.copy_(probs)
        return out, probs

    def bound_s(self) -> float:
        """Seconds one run takes at least on one H100: the plan's steps
        (the body's ``repeats`` times), the fresh ρ0 and the readout."""
        n = self.request.n
        total = self.request.repeats * density_bounds.plan_bound_s(
            self.plan, self.config["precision"])
        return (total + density_bounds.fill_bound_s(n)
                + density_bounds.readout_bound_s(n))
