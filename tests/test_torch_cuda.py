"""The port's CUDA kernels on the card vs their plain PyTorch versions.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: relative L2 error 1e-5 (float32 sums of up to 128 products, two
such sums for a pair, or row partials, taken in another order than the
plain version's).
"""
import numpy as np
import pytest
import torch

from qbot_tpu.tpu.circuit import Circuit, random_circuit
from qbot_tpu_torch import compile_circuit
from qbot_tpu_torch.tpu import kernels, planar

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def rel_l2(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _state(n, rng, device):
    psi = rng.normal(size=(2, 2**n))
    psi /= np.linalg.norm(psi)
    return torch.tensor(psi, dtype=torch.float32, device=device)


def _unitary(d, rng, device):
    q, r = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    u = q * (np.diag(r) / np.abs(np.diag(r)))
    return torch.tensor(np.stack([u.real, u.imag]), dtype=torch.float32,
                        device=device)


@pytest.mark.parametrize("where", ["first", "middle", "trailing"])
@pytest.mark.parametrize("width", range(1, 8))
def test_window_kernel_every_width(cuda, width, where):
    n = 12
    start = {"first": 0, "middle": (n - width) // 2,
             "trailing": n - width}[where]
    rng = np.random.default_rng(100 * width + len(where))
    psi = _state(n, rng, cuda)
    w = _unitary(2**width, rng, cuda)
    qubits = sorted({0, start, start + width - 1, n - 1})
    phases = ((tuple(qubits), complex(np.exp(0.5j)), 0),
              ((start,), complex(np.exp(-2.0j)), -1))
    flips = tuple(int(m) for m in rng.integers(0, 2**n, size=3))
    diag = kernels.fused_diagonals(n, flips, phases, cuda)
    got = kernels.window_apply(psi, n, start, width, w, diag)
    want = kernels.window_apply_ref(psi, n, start, width, w, diag)
    assert rel_l2(got, want) <= TOL


def _pair_inputs(n, start, width1, width2, rng, device):
    psi = _state(n, rng, device)
    w1 = _unitary(2**width1, rng, device)
    w2 = _unitary(2**width2, rng, device)
    end = start + width1 + width2
    qubits = sorted({0, start, start + width1 - 1, start + width1,
                     end - 1, n - 1})
    phases = ((tuple(qubits), complex(np.exp(0.5j)), 0),
              ((start + width1,), complex(np.exp(-2.0j)), -1),
              ((start,), -1.0 + 0j, 0))
    flips = tuple(int(m) for m in rng.integers(0, 2**n, size=3))
    diag = kernels.fused_diagonals(n, flips, phases, device)
    return psi, w1, w2, diag


# (n, start, width1, width2): the parity tests' geometries (trailing,
# middle, two windows at D1 > 32 and at 1 < B < 128) and wider ones
PAIR_GEOMETRIES = [(10, 2, 4, 4), (12, 0, 2, 3), (14, 0, 6, 1),
                   (12, 2, 3, 3), (18, 4, 7, 7), (19, 0, 5, 7),
                   (20, 7, 6, 7), (18, 0, 2, 7), (18, 9, 2, 7)]


@pytest.mark.parametrize("geometry", PAIR_GEOMETRIES,
                         ids=lambda g: "n{}_s{}_{}x{}".format(*g))
def test_pair_kernel(cuda, geometry):
    n, start, width1, width2 = geometry
    rng = np.random.default_rng(sum(geometry))
    psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
    got = kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
    want = kernels.pair_apply_ref(psi, n, start, width1, width2, w1, w2,
                                  diag)
    assert rel_l2(got, want) <= TOL


@pytest.mark.parametrize("width2", range(1, 8))
@pytest.mark.parametrize("width1", range(1, 8))
def test_pair_kernel_every_width(cuda, width1, width2):
    """The trailing pair at every (D1, D2), and the middle pair at every
    D1 <= 32 with B = 128."""
    for n, start in ((width1 + width2 + 2, 2), (width1 + width2 + 8, 1)):
        if kernels.pair_route(n, start, width1, width2) == "two_windows":
            continue
        rng = np.random.default_rng(10 * width1 + width2 + n)
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        got = kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
        want = kernels.pair_apply_ref(psi, n, start, width1, width2, w1, w2,
                                      diag)
        assert rel_l2(got, want) <= TOL, (n, start)


def test_pair_kernel_is_deterministic(cuda):
    for n, start, width1, width2 in ((20, 6, 7, 7), (19, 0, 5, 7)):
        rng = np.random.default_rng(n)
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        first = kernels.pair_apply(psi, n, start, width1, width2, w1, w2,
                                   diag)
        for _ in range(3):
            assert torch.equal(kernels.pair_apply(psi, n, start, width1,
                                                  width2, w1, w2, diag),
                               first)


def test_pair_counts_its_routes(cuda):
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    for n, start, width1, width2 in ((12, 2, 3, 7), (12, 0, 2, 3),
                                     (12, 2, 3, 3)):
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
    counts = kernels.launch_counts()
    assert counts["pair_apply_trailing"] == 1
    assert counts["pair_apply"] == 1
    assert counts["window_apply"] == 2          # the two-window route


@pytest.mark.parametrize("H,T", [(1, 2), (8, 128), (4096, 128), (64, 300),
                                 (1000, 7)])
def test_reflect_kernels(cuda, H, T):
    rng = np.random.default_rng(H * T)
    psi = torch.tensor(rng.normal(size=(2, H, T)), dtype=torch.float32,
                       device=cuda)
    a = torch.tensor(rng.normal(size=(2, H, 1)), dtype=torch.float32,
                     device=cuda)
    b = torch.tensor(rng.normal(size=(2, 1, T)), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.normal(size=2), dtype=torch.float32, device=cuda)
    flips = torch.tensor(rng.integers(0, H * T, size=2), dtype=torch.int64,
                         device=cuda)
    assert rel_l2(kernels.reflect_dot(psi, a, b),
                  kernels.reflect_dot_ref(psi, a, b)) <= TOL
    out, d = kernels.reflect_update(psi, c, a, b, flips)
    out_ref, d_ref = kernels.reflect_update_ref(psi, c, a, b, flips)
    assert rel_l2(out, out_ref) <= TOL
    assert rel_l2(d, d_ref) <= TOL


def test_reflect_sums_are_deterministic(cuda):
    rng = np.random.default_rng(7)
    psi = torch.tensor(rng.normal(size=(2, 2**14, 128)), dtype=torch.float32,
                       device=cuda)
    a = torch.ones((2, 2**14, 1), device=cuda)
    b = torch.ones((2, 1, 128), device=cuda)
    c = torch.tensor([0.3, -0.1], device=cuda)
    flips = torch.tensor([5], dtype=torch.int64, device=cuda)
    first = kernels.reflect_update(psi, c, a, b, flips)[1]
    for _ in range(3):
        assert torch.equal(kernels.reflect_update(psi, c, a, b, flips)[1],
                           first)


def test_wrappers_count_launches(cuda):
    kernels.reset_launch_counts()
    n = 9
    psi = _state(n, np.random.default_rng(1), cuda)
    w = _unitary(4, np.random.default_rng(2), cuda)
    diag = kernels.fused_diagonals(n, device=cuda)
    kernels.window_apply(psi, n, 3, 2, w, diag)
    kernels.window_apply(psi, n, 7, 2, w, diag)
    kernels.window_apply(psi, n, 7, 2, w, diag)
    kernels.window_apply_ref(psi, n, 3, 2, w, diag)
    counts = kernels.launch_counts()
    assert counts["window_apply"] == 1
    assert counts["window_apply_trailing"] == 2


def test_plan_on_card_matches_cpu(cuda):
    n = 10
    c = random_circuit(n, 3, seed=4)
    c.phase_flip(99)
    c.cz(0, 9)
    c.h(4)
    plan = compile_circuit(c, window=4)
    psi = _state(n, np.random.default_rng(3), "cpu")
    want = planar.apply_plan_planar(psi, plan)
    got = planar.apply_plan_planar(psi.to(cuda), plan)
    assert rel_l2(got, want) <= TOL


def test_paired_plan_on_card_matches_cpu(cuda):
    n = 12
    c = random_circuit(n, 3, seed=6)
    c.phase_flip(99)
    c.cz(0, 11)
    plan = compile_circuit(c, window=2)
    assert any(type(s).__name__ == "PairStep" for s in plan.steps)
    psi = _state(n, np.random.default_rng(8), "cpu")
    want = planar.apply_plan_planar(psi, plan)
    got = planar.apply_plan_planar(psi.to(cuda), plan)
    assert rel_l2(got, want) <= TOL


@pytest.mark.parametrize("window", [2, 7])
def test_density_plan_on_card_matches_cpu(cuda, window):
    n = 10
    c = random_circuit(n, 3, seed=5)
    c.phase_flip(77)
    c.cz(1, 8)
    c.h(3)
    plan = compile_circuit(c, window=window)
    rng = np.random.default_rng(window)
    v = rng.normal(size=(2, 2**n))
    rho = np.stack([np.outer(v[0], v[0]) + np.outer(v[1], v[1]),
                    np.outer(v[1], v[0]) - np.outer(v[0], v[1])])
    rho = torch.tensor(rho / np.trace(rho[0]), dtype=torch.float32)
    want = planar.apply_plan_density_planar(rho, plan)
    kernels.reset_launch_counts()
    got = planar.make_planar_density_runner(plan)(rho.to(cuda))
    assert rel_l2(got, want) <= TOL
    assert kernels.launch_counts()["pair_apply_trailing"] > 0


def test_grover_loop_on_card(cuda):
    n, marked, repeats = 12, 1000, 20
    init, body = Circuit(n), Circuit(n)
    for q in range(n):
        init.h(q)
    body.phase_flip(marked)
    for q in range(n):
        body.h(q)
    body.phase_flip(0)
    for q in range(n):
        body.h(q)
    run = planar.make_scanned_planar_runner(
        compile_circuit(body), repeats, init_plan=compile_circuit(init))
    out = run(planar.zero_state_planar(n, cuda))
    p = float(planar.planar_probs(out)[marked])
    want = np.sin((2 * repeats + 1) * np.arcsin(2 ** (-n / 2))) ** 2
    assert abs(p - want) < 1e-5
