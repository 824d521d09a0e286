"""The plain references: the statevector's against a dense unitary, and
each cell's reference against the program's plain path at a size the CPU
holds, with a lower precision failing the comparison."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control, generator, run
from portbench.families import brickwork, grover, smc_program
from portbench.reference import ensemble, statevector
from portbench.request import Request
from portbench.tests._small import ROOT, SMALL, small_spec


def dense(n: int, op) -> np.ndarray:
    """The 2^n x 2^n matrix of one op, qubit 0 the most significant bit."""
    if op[0] == "flip":
        d = np.ones(2 ** n, dtype=np.complex128)
        d[op[1]] = -1
        return np.diag(d)
    _, targets, m, controls = op
    u = np.zeros((2 ** n, 2 ** n), dtype=np.complex128)
    for col in range(2 ** n):
        bits = [(col >> (n - 1 - q)) & 1 for q in range(n)]
        if not all(bits[c] for c in controls):
            u[col, col] = 1
            continue
        t = int("".join(str(bits[q]) for q in targets), 2)
        for r in range(2 ** len(targets)):
            out = list(bits)
            for i, q in enumerate(targets):
                out[q] = (r >> (len(targets) - 1 - i)) & 1
            u[int("".join(map(str, out)), 2), col] += m[r, t]
    return u


def test_statevector_reference_against_a_dense_unitary():
    n = 5
    ops = brickwork.brickwork_ops(n, 3, seed=7)
    init, body = grover.grover_ops(n, marked=19)
    ops += init + body
    two = np.kron(brickwork.brickwork_ops(1, 1, 4)[0][2],
                  brickwork.brickwork_ops(1, 1, 5)[0][2])
    ops += [("gate", (3, 1), two, (0,)), ("gate", (4,), two[:2, :2] * 0 +
                                         np.eye(2), (2, 3))]
    want = np.zeros(2 ** n, dtype=np.complex128)
    want[0] = 1
    for op in ops:
        want = dense(n, op) @ want
    req = Request("circuit", n, 0, body_ops=ops)
    got = statevector.simulate(req, "cpu").reshape(-1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_exact_fan_out_readouts_and_weights():
    text, events = smc_program.smc_program(6)
    req = Request("program", 6, 0, text=text, events=events)
    leaves, readouts = ensemble.enumerate_branches(req, "cpu")
    assert len(leaves) == 64
    assert sum(w for w, _, _ in leaves) == pytest.approx(1.0)
    np.testing.assert_allclose(readouts["a"], [0.5, 0.5])
    np.testing.assert_allclose(readouts["c"], [0.5, 0, 0.5, 0], atol=1e-15)
    for _, psi, _ in leaves:
        assert float(torch.linalg.vector_norm(psi)) == pytest.approx(1.0)


@pytest.mark.parametrize("workload", list(SMALL))
def test_program_within_the_limits(workload):
    spec = small_spec(workload)
    got = control.readings(spec, spec["config"]["precision"], 11, 0.05,
                           device="cpu")
    for name, value in got.items():
        assert value <= spec["limits"][name], (name, value)


@pytest.mark.parametrize("workload", list(SMALL))
def test_control_in_tf32_fails(workload):
    """The reference in the program's place, every product in TF32."""
    spec = small_spec(workload)
    got = control.readings(spec, "tf32", 11, 0.05, device="cpu")
    assert any(v > spec["limits"][k] for k, v in got.items()), got


@pytest.mark.parametrize("workload", ["sv26-brickwork", "ens24-smc64"])
def test_program_in_bf16_3x_fails(workload):
    """The program's own lower-precision path, where it reaches the work
    (the window and pair products of the brickwork, the rotations of the
    SMC program)."""
    spec = small_spec(workload)
    got = control.readings(spec, "bf16_3x", 11, 0.05, device="cpu")
    assert any(v > spec["limits"][k] for k, v in got.items()), got


def test_rotations_make_the_outcomes_differ():
    """With ``rotations`` the first readout is cos²(θ/2), sin²(θ/2) of the
    first angle, and the branches' weights differ; the gates are the same
    for every seed."""
    spec = small_spec("ens24-smc64")
    req = generator.make_request(spec["config"], spec["traffic"], 2 ** 40)
    leaves, readouts = ensemble.enumerate_branches(req, "cpu")
    theta = float(req.text.split("yRotGate(")[1].split(")")[0])
    np.testing.assert_allclose(
        readouts["a"], [np.cos(theta / 2) ** 2, np.sin(theta / 2) ** 2])
    weights = [w for w, _, _ in leaves]
    assert sum(weights) == pytest.approx(1.0)
    assert max(weights) > 1.5 * min(weights)
    other = generator.make_request(spec["config"], spec["traffic"], 7)
    assert other.text != req.text
    strip = [line.split("(")[0] + line.split(")")[-1]
             for line in req.text.splitlines()]
    assert strip == [line.split("(")[0] + line.split(")")[-1]
                     for line in other.text.splitlines()]


def test_draw_chi2_of_counts():
    """Counts in proportion to the branches' weights read 0; every particle
    in one branch reads far above any limit; bins expected to hold fewer
    than five are pooled."""
    class Two:
        weight = {0: 0.25, 1: 0.75}

    perfect = [(np.array([0] * 16 + [1] * 48), np.zeros(64))]
    assert ensemble.draw_chi2(Two, perfect) == pytest.approx(0.0)
    one = [(np.array([0] * 64), np.zeros(64))] * 10
    assert ensemble.draw_chi2(Two, one) > 100
    few = [(np.array([0, 1]), np.zeros(2))]
    assert ensemble.draw_chi2(Two, few) == 0.0


def test_requests_repeat_from_the_seed():
    spec = run.load_cell(ROOT, "sv26-brickwork")
    a = generator.make_request(spec["config"], spec["traffic"], 2 ** 33 + 5)
    b = generator.make_request(spec["config"], spec["traffic"], 2 ** 33 + 5)
    c = generator.make_request(spec["config"], spec["traffic"], 2 ** 33 + 6)
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(a.body_ops,
                                                          b.body_ops))
    assert not np.array_equal(a.body_ops[0][2], c.body_ops[0][2])
    assert a.per_run == {"gates": 616 * 16}
