"""The port's CUDA kernels on the card vs their plain PyTorch versions.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: relative L2 error 1e-5 (float32 sums of up to 128 products, or
of row partials, taken in another order than the plain version's).
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
