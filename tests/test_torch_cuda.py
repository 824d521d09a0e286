"""The port's CUDA kernels on the card vs their plain PyTorch versions.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor ``qbot_tpu``, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: relative L2 error 1e-5 (float32 sums of up to 128 products, two
such sums for a pair, or row partials, taken in another order than the
plain version's); the 3xTF32 trailing and middle pairs also within 2e-6 of
a float64 product of the same inputs (chip_smoke.py's F64_TOL).  In the
reduced dot modes each kernel is held to its plain version in the same mode
at 1e-5 (a bf16 pair at 1e-4: it rounds its float32 Y to bf16 a second
time, so a one-ulp difference in Y moves a rounding by 2^-8), and to a
float64 product at 2e-5 (bf16_3x) and 1e-2 (bf16), chip_smoke.py's
limits.
"""
import numpy as np
import pytest
import torch

from qbot_tpu_torch import compile_circuit
from qbot_tpu_torch.tpu import kernels, planar
from qbot_tpu_torch.tpu.circuit import Circuit, random_circuit

pytestmark = pytest.mark.cuda

TOL = 1e-5
F64_TOL = 2e-6
# reduced dot mode -> (window vs plain, pair vs plain, vs float64)
MODE_TOL = {"bf16_3x": (1e-5, 1e-5, 2e-5), "bf16": (1e-5, 1e-4, 1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(params=list(MODE_TOL))
def reduced_mode(request):
    """A reduced dot mode for the test, f32 again after it."""
    kernels.set_dot_mode(request.param)
    try:
        yield request.param
    finally:
        kernels.set_dot_mode("f32")


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


@pytest.mark.parametrize("width", [3, 5, 7])
def test_window_kernel_many_diagonals(cuda, width):
    """More flips and phases than the kernel's lookup tables hold (8): the
    rest are tested element by element."""
    n = 12
    start = n - width - 2
    rng = np.random.default_rng(width)
    psi = _state(n, rng, cuda)
    w = _unitary(2**width, rng, cuda)
    phases = tuple((tuple(int(q) for q in rng.choice(n, size=3,
                                                      replace=False)),
                    complex(np.exp(1j * rng.uniform(0, 6))),
                    int(rng.integers(0, 8))) for _ in range(7))
    flips = tuple(int(m) for m in rng.integers(0, 2**n, size=5))
    diag = kernels.fused_diagonals(n, flips + flips[:1], phases, cuda)
    got = kernels.window_apply(psi, n, start, width, w, diag)
    want = kernels.window_apply_ref(psi, n, start, width, w, diag)
    assert rel_l2(got, want) <= TOL


def test_window_kernel_needs_aligned_state(cuda):
    n = 8
    flat = torch.zeros(2 * 2**n + 1, device=cuda)
    psi = flat[1:].view(2, 2**n)
    w = _unitary(4, np.random.default_rng(0), cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.window_apply(psi, n, 0, 2, w,
                             kernels.fused_diagonals(n, device=cuda))


# ---------------------------------------------------------------------------
# the f32 window at D = 128 on Hopper's warpgroup products
# (csrc/window_wg.cuh): every f32 and f32_mix launch of width 7
# ---------------------------------------------------------------------------

def _wg_launches():
    from qbot_tpu_torch.utils import profiling

    return profiling.counters().get(kernels.WG_COUNTER, 0)


def _f64_window(psi, n, start, w, diag):
    """The window of D = 128 on the diagonals' float64 product, in float64
    on the card."""
    x = kernels._apply_diagonals_ref(psi.double(), kernels.FusedDiagonals(
        diag.flips, diag.mask, diag.want, diag.phase.double()))
    return kernels.window_apply_ref(x, n, start, 7, w.double(),
                                    kernels.fused_diagonals(n, device=x.device),
                                    mode="f32")


def _wg_diagonals(n, start, entries, rng, device):
    """0, 3 or 13 flips and phases (13: past the kernel's 8-entry tables)."""
    if entries == 0:
        return kernels.fused_diagonals(n, device=device)
    qubits = sorted({max(start - 1, 0), start, start + 6, n - 1})
    phases = [(tuple(qubits), complex(np.exp(0.7j)), 1),
              ((start,), -1.0 + 0j, 0)]
    if entries == 13:
        phases += [(tuple(int(q) for q in rng.choice(n, size=2,
                                                     replace=False)),
                    complex(np.exp(1j * rng.uniform(0, 6))),
                    int(rng.integers(0, 4))) for _ in range(7)]
    flips = tuple(int(m) for m in rng.integers(0, 2**n, size=entries
                                                - len(phases)))
    return kernels.fused_diagonals(n, flips, tuple(phases), device)


# (n, start): B = 1, 8, 2^13 and 2^14
WG_GEOMETRIES = [(20, 13), (20, 10), (20, 0), (21, 0)]


@pytest.mark.parametrize("entries", [0, 3, 13])
@pytest.mark.parametrize("particles", [1, 3])
@pytest.mark.parametrize("geometry", WG_GEOMETRIES,
                         ids=lambda g: "n{}_B{}".format(g[0], 2**(g[0] - g[1] - 7)))
def test_wg_window_against_plain_and_float64(cuda, geometry, particles,
                                             entries):
    """The warpgroup window against its plain version (1e-5) and float64
    (2e-6) in every orientation, batched or not, with 0, 3 and 13 flips and
    phases; one launch, counted once under window_tc_d128; two launches
    agree bit for bit, and a batch's particles are their own launches'."""
    n, start = geometry
    rng = np.random.default_rng(n + start + 7 * particles + entries)
    psi = (_batch(n, rng, cuda, particles) if particles > 1
           else _state(n, rng, cuda))
    w = _unitary(128, rng, cuda)
    diag = _wg_diagonals(n, start, entries, rng, cuda)
    kernels.reset_launch_counts()
    before = _wg_launches()
    got = kernels.window_apply(psi, n, start, 7, w, diag)
    assert _wg_launches() - before == 1
    assert sum(kernels.launch_counts().values()) == 1
    again = kernels.window_apply(psi, n, start, 7, w, diag)
    assert torch.equal(got, again)
    assert rel_l2(got, kernels.window_apply_ref(psi, n, start, 7, w,
                                                diag)) <= TOL
    assert rel_l2(got, _f64_window(psi, n, start, w, diag)) <= F64_TOL
    if particles > 1:
        for p in range(particles):
            one = kernels.window_apply(psi[p].contiguous(), n, start, 7, w,
                                       diag)
            assert torch.equal(got[p], one), p


@pytest.mark.parametrize("geometry", [(16, 2), (16, 9)],
                         ids=["middle", "trailing"])
def test_wg_window_backward(cuda, geometry):
    """Through the W† backward the warpgroup window runs twice (forward, then
    W† on the cotangent), and ψ̄, W̄ match autograd through the plain
    versions."""
    n, start = geometry
    rng = np.random.default_rng(n + start)
    psi, w = _state(n, rng, cuda), _unitary(128, rng, cuda)
    diag = kernels.fused_diagonals(n, (5, 77), (((start,), np.exp(0.4j), -1),),
                                   cuda)
    cot = _state(n, rng, cuda)
    before = _wg_launches()
    got = _cotangents(
        lambda p, m: kernels.window_apply(p, n, start, 7, m, diag),
        (psi, w), cot)
    assert _wg_launches() - before == 2
    want = _cotangents(
        lambda p, m: kernels.window_apply_ref(p, n, start, 7, m, diag),
        (psi, w), cot)
    for g, h in zip(got, want):
        assert rel_l2(g, h) <= GRAD_TOL["f32"]


@pytest.mark.parametrize("mode,launches", [("f32", 1), ("f32_mix", 1),
                                           ("bf16_3x", 0), ("bf16", 0)])
def test_wg_counter_counts_the_f32_d128_windows(cuda, mode, launches):
    """window_tc_d128 counts the f32 and f32_mix windows of D = 128, and not
    the reduced modes', the D = 64 window's or the narrow pairs' at
    D2 = 128 (D1 = 2, 4, which keep the mma.sync tile)."""
    n = 12
    rng = np.random.default_rng(len(mode))
    psi = _state(n, rng, cuda)
    diag = kernels.fused_diagonals(n, device=cuda)
    kernels.set_dot_mode(mode)
    try:
        for start in (0, 3, 5):
            before = _wg_launches()
            kernels.window_apply(psi, n, start, 7, _unitary(128, rng, cuda),
                                 diag)
            assert _wg_launches() - before == launches
        before = _wg_launches()
        kernels.window_apply(psi, n, 3, 6, _unitary(64, rng, cuda), diag)
        # the narrow pairs, middle (B = 256) and trailing, at 16 qubits
        n = 16
        psi = _state(n, rng, cuda)
        diag = kernels.fused_diagonals(n, device=cuda)
        for width1 in (1, 2):
            for start in (0, n - width1 - 7):
                assert kernels.launch_family(n, start, width1,
                                             7) == "pair_narrow"
                kernels.pair_apply(psi, n, start, width1, 7,
                                   _unitary(2**width1, rng, cuda),
                                   _unitary(128, rng, cuda), diag)
        assert _wg_launches() == before
    finally:
        kernels.set_dot_mode("f32")

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
# middle, two windows at D1 > 32 and at 1 < B < 128), wider ones, and two
# windows at D1 >= 8 with D2 <= 4, middle (B = 128) and trailing
PAIR_GEOMETRIES = [(10, 2, 4, 4), (12, 0, 2, 3), (14, 0, 6, 1),
                   (12, 2, 3, 3), (18, 4, 7, 7), (19, 0, 5, 7),
                   (20, 7, 6, 7), (18, 0, 2, 7), (18, 9, 2, 7),
                   (14, 0, 5, 2), (9, 2, 5, 2)]


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
    """The trailing pair at every (D1, D2), with 4 and with 64 slabs, and
    the middle pair at every (D1, D2) with B = 128, on whatever route
    pair_route gives them: the tensor-core, narrow and streaming pairs, and
    two windows (D1 >= 8 with D2 <= 4, and the middle pairs at D1 > 32)."""
    for n, start in ((width1 + width2 + 2, 2), (width1 + width2 + 6, 6),
                     (width1 + width2 + 8, 1)):
        rng = np.random.default_rng(10 * width1 + width2 + n)
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        got = kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
        want = kernels.pair_apply_ref(psi, n, start, width1, width2, w1, w2,
                                      diag)
        assert rel_l2(got, want) <= TOL, (n, start)


@pytest.mark.parametrize("width1,width2", [(7, 7), (6, 7)])
def test_trailing_pair_within_f64(cuda, width1, width2):
    """The trailing pair at the 26-qubit paths' widths, (128, 128) and
    (64, 128), against a float64 product: more slabs than the card has
    blocks, so the persistent blocks take several units each."""
    n = width1 + width2 + 8
    rng = np.random.default_rng(width1)
    psi, w1, w2, diag = _pair_inputs(n, 8, width1, width2, rng, cuda)
    got = kernels.pair_apply(psi, n, 8, width1, width2, w1, w2, diag)
    want = kernels.pair_apply_ref(psi.double(), n, 8, width1, width2,
                                  w1.double(), w2.double(), diag)
    assert rel_l2(got, want) <= F64_TOL


# ---------------------------------------------------------------------------
# the f32 trailing pair at D2 = 128, D1 = 64 and 128, on Hopper's warpgroup
# products (csrc/pair_wg.cuh)
# ---------------------------------------------------------------------------

def _pair_wg_launches():
    from qbot_tpu_torch.utils import profiling

    return profiling.counters().get(kernels.PAIR_WG_COUNTER, 0)


# (n, width1): one slab (fewer units than blocks), 2^7 slabs, and more
# slabs than the card has blocks (units taken several a block)
PAIR_WG_GEOMETRIES = [(13, 6), (20, 6), (22, 6), (14, 7), (18, 7), (21, 7)]


@pytest.mark.parametrize("entries", [0, 3, 13])
@pytest.mark.parametrize("particles", [1, 3])
@pytest.mark.parametrize("geometry", PAIR_WG_GEOMETRIES,
                         ids=lambda g: "n{}_D1_{}".format(g[0], 2**g[1]))
def test_wg_pair_against_plain_and_float64(cuda, geometry, particles,
                                           entries):
    """The warpgroup pair (trailing, D2 = 128) against its plain version
    (1e-5) and float64 (2e-6), batched or not, with 0, 3 and 13 flips and
    phases; one launch, counted once under pair_tc_wg beside its
    pair_apply_trailing count; two launches agree bit for bit, and a
    batch's particles are their own launches'."""
    n, width1 = geometry
    start = n - width1 - 7
    rng = np.random.default_rng(n + width1 + 7 * particles + entries)
    psi = (_batch(n, rng, cuda, particles) if particles > 1
           else _state(n, rng, cuda))
    w1, w2 = _unitary(2**width1, rng, cuda), _unitary(128, rng, cuda)
    diag = _wg_diagonals(n, start, entries, rng, cuda)
    kernels.reset_launch_counts()
    before = _pair_wg_launches()
    got = kernels.pair_apply(psi, n, start, width1, 7, w1, w2, diag)
    assert _pair_wg_launches() - before == 1
    assert kernels.launch_counts()["pair_apply_trailing"] == 1
    assert sum(kernels.launch_counts().values()) == 1
    again = kernels.pair_apply(psi, n, start, width1, 7, w1, w2, diag)
    assert torch.equal(got, again)
    assert rel_l2(got, kernels.pair_apply_ref(psi, n, start, width1, 7, w1,
                                              w2, diag)) <= TOL
    exact = kernels.pair_apply_ref(psi.double(), n, start, width1, 7,
                                   w1.double(), w2.double(), diag, mode="f32")
    assert rel_l2(got, exact) <= F64_TOL
    if particles > 1:
        for p in range(particles):
            one = kernels.pair_apply(psi[p].contiguous(), n, start, width1, 7,
                                     w1, w2, diag)
            assert torch.equal(got[p], one), p


@pytest.mark.parametrize("geometry",
                         [g for g in PAIR_GEOMETRIES
                          if g[3] == 7 and g[2] >= 6 and sum(g[1:]) == g[0]],
                         ids=lambda g: "n{}_s{}_{}x{}".format(*g))
def test_wg_pair_backward(cuda, geometry):
    """Through the W† backward the warpgroup pair runs twice (forward, then
    (W1†, W2†) on the cotangent), and ψ̄, W̄1, W̄2 match autograd through
    the plain versions."""
    n, start, width1, width2 = geometry
    rng = np.random.default_rng(sum(geometry))
    psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
    cot = _state(n, rng, cuda)
    before = _pair_wg_launches()
    got = _cotangents(
        lambda p, a, b: kernels.pair_apply(p, n, start, width1, width2, a, b,
                                           diag), (psi, w1, w2), cot)
    assert _pair_wg_launches() - before == 2
    want = _cotangents(
        lambda p, a, b: kernels.pair_apply_ref(p, n, start, width1, width2,
                                               a, b, diag),
        (psi, w1, w2), cot)
    for g, h in zip(got, want):
        assert rel_l2(g, h) <= GRAD_TOL["f32"]


@pytest.mark.parametrize("mode,launches", [("f32", 1), ("f32_mix", 1),
                                           ("bf16_3x", 0), ("bf16", 0)])
def test_pair_wg_counter_counts_the_f32_trailing_pairs(cuda, mode, launches):
    """pair_tc_wg counts the f32 and f32_mix trailing pairs at D2 = 128 with
    D1 = 64, 128, once a launch, and not the reduced modes', the (16, 128)
    trailing pair's (the mma.sync tile) or the middle pairs'."""
    rng = np.random.default_rng(len(mode))
    kernels.set_dot_mode(mode)
    try:
        for n, start, width1, width2 in ((15, 2, 6, 7), (16, 2, 7, 7)):
            psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng,
                                             cuda)
            before = _pair_wg_launches()
            kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
            assert _pair_wg_launches() - before == launches
        before = _pair_wg_launches()
        for n, start, width1, width2 in ((13, 2, 4, 7), (18, 0, 4, 7),
                                         (18, 2, 5, 4)):
            psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng,
                                             cuda)
            kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
        assert _pair_wg_launches() == before
    finally:
        kernels.set_dot_mode("f32")


@pytest.mark.parametrize("width2", range(3, 8))
@pytest.mark.parametrize("width1", range(3, 6))
def test_middle_pair_within_f64(cuda, width1, width2):
    """The middle pair at every (D1, D2) of its tensor-core variant, with
    B = 128 and 16 a, against a float64 product."""
    start = 4
    n = start + width1 + width2 + 7
    rng = np.random.default_rng(10 * width1 + width2)
    psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
    assert kernels.pair_route(n, start, width1, width2) == "middle"
    got = kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
    want = kernels.pair_apply_ref(psi.double(), n, start, width1, width2,
                                  w1.double(), w2.double(), diag)
    assert rel_l2(got, want) <= F64_TOL


def test_pair_kernel_is_deterministic(cuda):
    for n, start, width1, width2 in ((20, 6, 7, 7), (19, 0, 5, 7),
                                     (19, 6, 6, 7), (14, 4, 3, 7),
                                     (12, 5, 2, 5)):
        rng = np.random.default_rng(n)
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        first = kernels.pair_apply(psi, n, start, width1, width2, w1, w2,
                                   diag)
        for _ in range(3):
            assert torch.equal(kernels.pair_apply(psi, n, start, width1,
                                                  width2, w1, w2, diag),
                               first)


def test_pair_kernel_needs_aligned_operands(cuda):
    """The pair kernels copy the state and W1 in 16-byte cp.async chunks."""
    n = 8
    rng = np.random.default_rng(0)
    psi, w1, w2, diag = _pair_inputs(n, 2, 3, 3, rng, cuda)
    flat = torch.zeros(2 * 2**n + 1, device=cuda)
    shifted = flat[1:].view(2, 2**n)
    shifted.copy_(psi)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.pair_apply(shifted, n, 2, 3, 3, w1, w2, diag)


def test_pair_counts_its_routes(cuda):
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    for n, start, width1, width2 in ((12, 2, 3, 7), (12, 0, 2, 3),
                                     (12, 2, 3, 3)):
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
    counts = kernels.launch_counts()
    assert counts["pair_apply_trailing"] == 1
    assert counts["pair_apply_narrow"] == 1     # (4, 8): the narrow pair
    assert counts["pair_apply"] == 0
    assert counts["window_apply"] == 2          # the two-window route


def test_narrow_d2_counts_as_the_fma_pair(cuda):
    """D2 = 2, 4 at D1 >= 8, the geometry of the retired shared-memory FMA
    pair, counts as its two window launches in either orientation (the D1
    window on the tensor cores, the D2 window streaming) and as no pair;
    D1, D2 = 2, 4 counts as the streaming pair (pair_apply_stream, either
    orientation); D1 = 2, 4 with D2 >= 8 as the narrow pair."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(4)
    for n, start, width1, width2 in ((14, 0, 5, 2), (9, 2, 5, 2),
                                     (11, 0, 2, 2), (6, 2, 2, 2),
                                     (10, 0, 1, 2), (10, 2, 1, 7)):
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
    counts = kernels.launch_counts()
    assert counts["pair_apply"] == 0
    assert counts["pair_apply_trailing"] == 0
    assert counts["window_apply"] == 2
    assert counts["window_apply_stream"] == 2
    assert counts["pair_apply_stream"] == 3
    assert counts["pair_apply_narrow"] == 0
    assert counts["pair_apply_trailing_narrow"] == 1


@pytest.mark.parametrize("geometry", [(14, 0, 5, 2), (10, 2, 7, 1)],
                         ids=lambda g: "n{}_s{}_{}x{}".format(*g))
def test_pair_entry_refuses_wide_d1_narrow_d2(cuda, geometry):
    """The C entry point serves no pair of D1 >= 8 with D2 <= 4: it returns
    cudaErrorInvalidValue (1) and launches nothing."""
    n, start, width1, width2 = geometry
    rng = np.random.default_rng(5)
    psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
    out = torch.full_like(psi, 7.0)
    lib = kernels._library()
    rc = lib.qbot_pair_apply(
        psi.data_ptr(), out.data_ptr(), w1.data_ptr(), w2.data_ptr(), 2**n,
        1, width1, width2, n - start - width1 - width2,
        diag.flips.data_ptr(), diag.flips.numel(), diag.mask.data_ptr(),
        diag.want.data_ptr(), diag.phase.data_ptr(), diag.mask.numel(), 0,
        None, kernels._stream(psi))
    torch.cuda.synchronize()
    assert rc == 1
    assert torch.all(out == 7.0)


# dot mode -> (pair vs plain, vs float64)
PAIR_TOL = {"f32": (TOL, F64_TOL), "bf16_3x": MODE_TOL["bf16_3x"][1:],
            "bf16": MODE_TOL["bf16"][1:]}


@pytest.fixture(params=list(PAIR_TOL))
def any_mode(request):
    """A dot mode for the test, f32 again after it."""
    kernels.set_dot_mode(request.param)
    try:
        yield request.param
    finally:
        kernels.set_dot_mode("f32")


def _narrow_check(n, start, width1, width2, mode, rng, device, diag=None):
    psi, w1, w2, few = _pair_inputs(n, start, width1, width2, rng, device)
    _pair_check(psi, n, start, width1, width2, w1, w2,
                few if diag is None else diag, mode)


@pytest.mark.parametrize("width2", range(3, 8))
@pytest.mark.parametrize("width1", [1, 2])
def test_narrow_pair_kernel(cuda, any_mode, width1, width2):
    """The narrow pair (D1 = 2, 4; D2 = 8-128) in every dot mode against
    its plain version and against float64: trailing with 1 a (fewer columns
    than a tile) and with 8 and 512; middle at B = 2^7 and 2^10, with 4 a,
    and at B = 2^7 with 1 a."""
    geometries = [(width1 + width2 + k, k) for k in (0, 3, 9)]
    geometries += [(2 + width1 + width2 + log_b, 2) for log_b in (7, 10)]
    geometries += [(width1 + width2 + 7, 0)]
    for n, start in geometries:
        rng = np.random.default_rng(10 * width1 + width2 + n)
        assert kernels.pair_route(n, start, width1, width2) != "two_windows"
        _narrow_check(n, start, width1, width2, any_mode, rng, cuda)


@pytest.mark.parametrize("geometry", [(18, 0, 2, 7), (16, 0, 1, 7),
                                      (11, 2, 2, 7), (12, 5, 2, 5)],
                         ids=lambda g: "n{}_s{}_{}x{}".format(*g))
def test_narrow_pair_many_diagonals(cuda, any_mode, geometry):
    """More flips and phases than the lookup tables hold (8): the narrow
    pair tests the rest on each X element's flat index."""
    n, start, width1, width2 = geometry
    rng = np.random.default_rng(sum(geometry))
    _narrow_check(n, start, width1, width2, any_mode, rng, cuda,
                  _many_diagonals(n, rng, cuda))


def test_narrow_pair_kernel_is_deterministic(cuda, any_mode):
    """Bit for bit the same output in repeated launches: the brickwork's
    narrow pairs, middle (2, 128) and (4, 128) at 19 qubits and trailing
    (4, 128) at 9."""
    for n, start, width1, width2 in ((19, 0, 1, 7), (19, 0, 2, 7),
                                     (9, 0, 2, 7)):
        rng = np.random.default_rng(n + width1)
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        first = kernels.pair_apply(psi, n, start, width1, width2, w1, w2,
                                   diag)
        for _ in range(3):
            assert torch.equal(kernels.pair_apply(psi, n, start, width1,
                                                  width2, w1, w2, diag),
                               first)


def test_narrow_pair_counts(cuda, any_mode):
    """The narrow pairs count apart, in the mode's counters."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(6)
    for n, start, width1, width2 in ((16, 0, 2, 7), (9, 0, 2, 7)):
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
    counts = kernels.launch_counts()
    suffix = "" if any_mode == "f32" else f"[{any_mode}]"
    assert counts[f"pair_apply_narrow{suffix}"] == 1
    assert counts[f"pair_apply_trailing_narrow{suffix}"] == 1
    assert counts[f"pair_apply{suffix}"] == 0
    assert sum(counts.values()) == 2


def test_layered_circuit_narrow_pairs_on_card(cuda, any_mode):
    """Layers of 1-qubit gates and CX at 9 and 16 qubits, whose paired plans
    hold a narrow trailing (4, 128) and middle (4, 128) pair: the card's
    state against the plain versions' and the unpaired plan's (f32 within
    1e-5, the reduced modes within the float64 limit of a launch)."""
    tol = TOL if any_mode == "f32" else MODE_TOL[any_mode][2]
    for n in (9, 16):
        c = random_circuit(n, 4, seed=n)
        psi0 = planar.zero_state_planar(n, cuda)
        plan = compile_circuit(c)
        kernels.reset_launch_counts()
        got = planar.apply_plan_planar(psi0, plan)
        counts = kernels.launch_counts()
        assert sum(v for k, v in counts.items() if "narrow" in k) > 0
        assert rel_l2(got, planar.apply_plan_planar_ref(psi0, plan)) <= tol
        unpaired = planar.apply_plan_planar(psi0, compile_circuit(c,
                                                                  pair=False))
        assert rel_l2(got, unpaired) <= tol


@pytest.mark.parametrize("width2", [1, 2])
@pytest.mark.parametrize("width1", [1, 2])
def test_stream_pair_kernel(cuda, any_mode, width1, width2):
    """The streaming pair (D1, D2 = 2, 4) in every dot mode against its
    plain version and against float64: middle at B = 2^7 and 2^10 with 4 a,
    at B = 2^7 with 1 a and at B = 2^18 (more columns than the resident
    threads); trailing with 1, 8 and 2^18 slabs."""
    geometries = [(2 + width1 + width2 + log_b, 2) for log_b in (7, 10, 18)]
    geometries += [(width1 + width2 + 7, 0)]
    geometries += [(width1 + width2 + k, k) for k in (0, 3, 18)]
    for n, start in geometries:
        rng = np.random.default_rng(10 * width1 + width2 + n)
        assert kernels.pair_route(n, start, width1, width2) != "two_windows"
        _narrow_check(n, start, width1, width2, any_mode, rng, cuda)


@pytest.mark.parametrize("geometry", [(12, 2, 2, 2), (11, 0, 1, 2),
                                      (12, 1, 2, 1), (9, 5, 2, 2)],
                         ids=lambda g: "n{}_s{}_{}x{}".format(*g))
def test_stream_pair_many_diagonals(cuda, any_mode, geometry):
    """More flips and phases than the lookup tables hold (8): the streaming
    pair tests the rest on each element's flat index."""
    n, start, width1, width2 = geometry
    rng = np.random.default_rng(sum(geometry))
    _narrow_check(n, start, width1, width2, any_mode, rng, cuda,
                  _many_diagonals(n, rng, cuda))


def test_stream_pair_kernel_is_deterministic(cuda, any_mode):
    """Bit for bit the same output in repeated launches: the pairs of
    window=2 and window=1 plans, (2, 4) and (4, 4) at 22 qubits, (2, 2) at
    B = 128, and the trailing (4, 4)."""
    for n, start, width1, width2 in ((22, 0, 1, 2), (22, 3, 2, 2),
                                     (20, 11, 1, 1), (14, 10, 2, 2)):
        rng = np.random.default_rng(n + width1)
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        first = kernels.pair_apply(psi, n, start, width1, width2, w1, w2,
                                   diag)
        for _ in range(3):
            assert torch.equal(kernels.pair_apply(psi, n, start, width1,
                                                  width2, w1, w2, diag),
                               first)


def test_stream_kernels_count(cuda, any_mode):
    """The streaming window and pair count apart, in the mode's counters,
    in either orientation."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(7)
    for n, start, width in ((12, 0, 1), (12, 3, 2), (12, 10, 2)):
        w = _unitary(2**width, rng, cuda)
        kernels.window_apply(_state(n, rng, cuda), n, start, width, w,
                             kernels.fused_diagonals(n, device=cuda))
    for n, start, width1, width2 in ((12, 0, 2, 2), (11, 7, 2, 2)):
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
    counts = kernels.launch_counts()
    suffix = "" if any_mode == "f32" else f"[{any_mode}]"
    assert counts[f"window_apply_stream{suffix}"] == 3
    assert counts[f"pair_apply_stream{suffix}"] == 2
    assert sum(counts.values()) == 5


@pytest.mark.parametrize("diagonals", ["few", "many"])
@pytest.mark.parametrize("width", [1, 2])
def test_stream_window_first_window(cuda, any_mode, width, diagonals):
    """The streaming window at D = 2, 4 as plans place it first (A = 1),
    at 22 qubits (more columns than the resident threads), in every dot
    mode: against its plain version and float64 (f32 at 1e-5 and 2e-6),
    and bit for bit the same in a second launch."""
    tol = TOL if any_mode == "f32" else MODE_TOL[any_mode][0]
    f64_tol = F64_TOL if any_mode == "f32" else MODE_TOL[any_mode][2]
    n = 22
    rng = np.random.default_rng(width + len(diagonals))
    psi = _state(n, rng, cuda)
    w = _unitary(2**width, rng, cuda)
    if diagonals == "many":
        diag = _many_diagonals(n, rng, cuda)
    else:
        diag = kernels.fused_diagonals(
            n, (3, 2**n - 5), (((0, n - 1), complex(np.exp(0.5j)), 1),),
            cuda)
    got = kernels.window_apply(psi, n, 0, width, w, diag)
    want = kernels.window_apply_ref(psi, n, 0, width, w, diag)
    exact = kernels.window_apply_ref(psi.double(), n, 0, width, w.double(),
                                     diag, mode="f32")
    assert torch.equal(got, kernels.window_apply(psi, n, 0, width, w, diag))
    assert rel_l2(got, want) <= tol
    assert rel_l2(got, exact) <= f64_tol


@pytest.mark.parametrize("window", [1, 2])
def test_stream_plans_on_card(cuda, any_mode, window):
    """A layered circuit at 16 qubits compiled at window=1 and window=2,
    whose paired plans run the streaming pair: the card's state against the
    plain versions' and the unpaired plan's (f32 within 1e-5, the reduced
    modes within the float64 limit of a launch)."""
    tol = TOL if any_mode == "f32" else MODE_TOL[any_mode][2]
    n = 16
    c = random_circuit(n, 4, seed=window)
    psi0 = planar.zero_state_planar(n, cuda)
    plan = compile_circuit(c, window=window)
    kernels.reset_launch_counts()
    got = planar.apply_plan_planar(psi0, plan)
    counts = kernels.launch_counts()
    assert sum(v for k, v in counts.items() if "pair_apply_stream" in k) > 0
    assert rel_l2(got, planar.apply_plan_planar_ref(psi0, plan)) <= tol
    unpaired = planar.apply_plan_planar(
        psi0, compile_circuit(c, window=window, pair=False))
    assert rel_l2(got, unpaired) <= tol


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
    """A window of D >= 8 counts as window_apply (B > 1) or
    window_apply_trailing (B = 1); one of D <= 4, on the streaming kernel,
    as window_apply_stream in either orientation; a plain version never."""
    kernels.reset_launch_counts()
    n = 9
    psi = _state(n, np.random.default_rng(1), cuda)
    diag = kernels.fused_diagonals(n, device=cuda)
    for width in (2, 3):
        w = _unitary(2**width, np.random.default_rng(2), cuda)
        kernels.window_apply(psi, n, 3, width, w, diag)
        kernels.window_apply(psi, n, n - width, width, w, diag)
        kernels.window_apply(psi, n, n - width, width, w, diag)
        kernels.window_apply_ref(psi, n, 3, width, w, diag)
    counts = kernels.launch_counts()
    assert counts["window_apply_stream"] == 3
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
    # the column side's trailing pair: (8, 128) at window 7, the narrow
    # (4, 128) at window 2
    counts = kernels.launch_counts()
    assert counts["pair_apply_trailing"] + counts[
        "pair_apply_trailing_narrow"] > 0


def test_density_13q_thermal_body_on_card(cuda):
    """The benchmark's density cell in small: the thermal product state
    built on the card and one body of the 13-qubit brickwork plan at
    ``window="auto"`` on the kernels, against the plain versions.  Within
    chip_smoke.py's DENSITY_TOL, 1e-4 relative Frobenius: float32 ρ through
    five steps of row and column passes, each within 1e-5 of its plain
    version, four of them with a fused phase on both sides."""
    from portbench.entries.statevector import to_circuit
    from portbench.families.brickwork import brickwork_ops
    from portbench.families.thermal_brickwork import thermal_factors

    n = 13
    plan = compile_circuit(to_circuit(n, brickwork_ops(n, 8, 23)),
                           window="auto")
    factors = thermal_factors(n, 23)
    rho = planar.product_density_planar(factors, cuda)
    want_rho = planar.product_density_planar(factors, "cpu")
    assert rel_l2(rho, want_rho) <= TOL
    got = planar.make_planar_density_runner(plan)(rho)
    want = planar.apply_plan_density_planar_ref(rho, plan)
    assert rel_l2(got, want) <= 1e-4
    trace = float(torch.sum(torch.diagonal(got[0])))
    assert abs(trace - 1.0) <= 1e-4


@pytest.mark.parametrize("name", ["complex_phases", "over_table"])
def test_density_fused_phases_on_card(cuda, name):
    """Controlled-S and -T phases fused into the row launches of 10-qubit
    windows and pairs, on the rows and, conjugated, on the columns (and,
    ``over_table``, more entries in one launch than the kernels' tables
    hold): the runner on the card against the benchmark's complex128
    U ρ U† gate by gate, which shares no fusion with the plain versions,
    within the density path's 1e-5 of ``tests/test_torch_density.py``."""
    import _torch_density_cases as dc
    from portbench.families.thermal_brickwork import ThermalRequest
    from portbench.reference import density
    from qbot_tpu_torch.tpu import circuit

    n = 10
    make, window = dc.CASES[name]
    ops = make(n, np.random.default_rng(7))
    plan = compile_circuit(dc.circuit(circuit, n, ops), window=window)
    assert dc.engages(name, plan)
    factors = dc.hermitian_factors(n, 12)
    got = planar.make_planar_density_runner(plan)(
        planar.product_density_planar(factors, cuda))
    req = ThermalRequest("circuit", n, 0, body_ops=ops, repeats=1,
                         rhos=factors)
    readings = density.judge(req, {"state": got, "readouts": [
        planar.planar_density_probs(got)]}, cuda)
    assert max(readings.values()) <= 1e-5, readings


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


def _many_diagonals(n, rng, device):
    """13 flips and phases: more than the kernels' lookup tables hold (8)."""
    phases = tuple((tuple(int(q) for q in rng.choice(n, size=3,
                                                      replace=False)),
                    complex(np.exp(1j * rng.uniform(0, 6))),
                    int(rng.integers(0, 8))) for _ in range(7))
    flips = tuple(int(m) for m in rng.integers(0, 2**n, size=6))
    return kernels.fused_diagonals(n, flips, phases, device)


@pytest.mark.parametrize("diagonals", ["few", "many"])
@pytest.mark.parametrize("where", ["first", "middle", "trailing", "b2", "b4"])
@pytest.mark.parametrize("width", range(1, 8))
def test_window_kernel_reduced_modes(cuda, reduced_mode, width, where,
                                     diagonals):
    """Every width and orientation in bf16_3x and bf16 (the FMA variant at
    D <= 4, window_bf16.cuh at D >= 8), with B = 2 and 4 beside the first,
    middle and trailing windows, and with more diagonals than the lookup
    tables hold: the kernel of the mode against the plain version of the
    mode and against float64."""
    tol, _, f64_tol = MODE_TOL[reduced_mode]
    n = 12
    start = {"first": 0, "middle": (n - width) // 2, "trailing": n - width,
             "b2": n - width - 1, "b4": n - width - 2}[where]
    rng = np.random.default_rng(100 * width + len(where))
    psi = _state(n, rng, cuda)
    w = _unitary(2**width, rng, cuda)
    if diagonals == "many":
        diag = _many_diagonals(n, rng, cuda)
    else:
        flips = tuple(int(m) for m in rng.integers(0, 2**n, size=3))
        phases = ((tuple(sorted({0, start, n - 1})), complex(np.exp(0.5j)),
                   0),)
        diag = kernels.fused_diagonals(n, flips, phases, cuda)
    got = kernels.window_apply(psi, n, start, width, w, diag)
    want = kernels.window_apply_ref(psi, n, start, width, w, diag)
    exact = kernels.window_apply_ref(psi.double(), n, start, width,
                                     w.double(), diag, mode="f32")
    assert rel_l2(got, want) <= tol
    assert rel_l2(got, exact) <= f64_tol


@pytest.mark.parametrize("where", ["middle", "trailing"])
@pytest.mark.parametrize("width", range(1, 8))
def test_window_kernel_reduced_modes_many_tiles(cuda, reduced_mode, width,
                                                where):
    """At 20 qubits (a persistent block walks many tiles): the kernel of
    the mode against its plain version, and bit for bit the same in a
    second launch."""
    tol = MODE_TOL[reduced_mode][0]
    n = 20
    start = n - width - (8 if where == "middle" else 0)
    rng = np.random.default_rng(width)
    psi = _state(n, rng, cuda)
    w = _unitary(2**width, rng, cuda)
    diag = _many_diagonals(n, rng, cuda)
    got = kernels.window_apply(psi, n, start, width, w, diag)
    again = kernels.window_apply(psi, n, start, width, w, diag)
    want = kernels.window_apply_ref(psi, n, start, width, w, diag)
    assert torch.equal(got, again)
    assert rel_l2(got, want) <= tol


@pytest.mark.parametrize("geometry", PAIR_GEOMETRIES,
                         ids=lambda g: "n{}_s{}_{}x{}".format(*g))
def test_pair_kernel_reduced_modes(cuda, reduced_mode, geometry):
    """Every pair route in bf16_3x and bf16: the kernel (W1 first, as the
    reference) against the plain version of the mode and against
    float64."""
    _, tol, f64_tol = MODE_TOL[reduced_mode]
    n, start, width1, width2 = geometry
    rng = np.random.default_rng(sum(geometry))
    psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
    got = kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
    want = kernels.pair_apply_ref(psi, n, start, width1, width2, w1, w2,
                                  diag)
    exact = kernels.pair_apply_ref(psi.double(), n, start, width1, width2,
                                   w1.double(), w2.double(), diag,
                                   mode="f32")
    assert rel_l2(got, want) <= tol
    assert rel_l2(got, exact) <= f64_tol


def _pair_check(psi, n, start, width1, width2, w1, w2, diag, mode):
    """The pair kernel of dot ``mode`` against the plain version of the
    mode and against float64."""
    tol, f64_tol = PAIR_TOL[mode]
    got = kernels.pair_apply(psi, n, start, width1, width2, w1, w2, diag)
    want = kernels.pair_apply_ref(psi, n, start, width1, width2, w1, w2,
                                  diag)
    exact = kernels.pair_apply_ref(psi.double(), n, start, width1, width2,
                                   w1.double(), w2.double(), diag,
                                   mode="f32")
    assert rel_l2(got, want) <= tol, (n, start)
    assert rel_l2(got, exact) <= f64_tol, (n, start)
    return got


@pytest.mark.parametrize("width2", range(3, 8))
@pytest.mark.parametrize("width1", range(3, 8))
def test_pair_kernel_reduced_modes_every_width(cuda, reduced_mode, width1,
                                               width2):
    """Every (D1, D2) of 8-128 in bf16_3x and bf16: the trailing pair with
    1, 2 and 64 slabs (fewer than a unit of 2 or 4 slabs at D1 <= 32, and
    more than the walkers), the middle pair (D1 <= 32) at B = 128 with 1
    and 4 a."""
    geometries = [(width1 + width2 + k, k) for k in (0, 1, 6)]
    if width1 <= 5:
        geometries += [(width1 + width2 + 7 + k, k) for k in (0, 2)]
    for n, start in geometries:
        rng = np.random.default_rng(10 * width1 + width2 + n)
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        assert kernels.pair_route(n, start, width1, width2) != "two_windows"
        _pair_check(psi, n, start, width1, width2, w1, w2, diag,
                            reduced_mode)


@pytest.mark.parametrize("log_b", [7, 10])
def test_middle_pair_reduced_modes_b(cuda, reduced_mode, log_b):
    """The middle pair at the smallest B its route takes (128) and at
    B = 2^10, (32, 128) as on the brickwork's path, with 4 a."""
    n, start = 2 + 5 + 7 + log_b, 2
    rng = np.random.default_rng(log_b)
    psi, w1, w2, diag = _pair_inputs(n, start, 5, 7, rng, cuda)
    assert kernels.pair_route(n, start, 5, 7) == "middle"
    _pair_check(psi, n, start, 5, 7, w1, w2, diag, reduced_mode)


def test_reduced_pair_kernel_is_deterministic(cuda, reduced_mode):
    """Bit for bit the same output in repeated launches, in each reduced
    mode: trailing (128, 128), (64, 128) and (32, 128) with more slabs than
    the walkers, the middle (32, 128) and (8, 64)."""
    for n, start, width1, width2 in ((20, 6, 7, 7), (19, 6, 6, 7),
                                     (20, 8, 5, 7), (19, 0, 5, 7),
                                     (18, 2, 3, 6)):
        rng = np.random.default_rng(n + width1)
        psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
        first = kernels.pair_apply(psi, n, start, width1, width2, w1, w2,
                                   diag)
        for _ in range(3):
            assert torch.equal(kernels.pair_apply(psi, n, start, width1,
                                                  width2, w1, w2, diag),
                               first)


def test_reduced_mode_launches_its_own_kernel(cuda, reduced_mode):
    """A CUDA tensor in a reduced mode launches that mode's kernel: its
    counter moves, the f32 kernel's does not."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(5)
    psi, w1, w2, diag = _pair_inputs(12, 2, 3, 7, rng, cuda)
    kernels.window_apply(psi, 12, 2, 3, w1, diag)
    kernels.pair_apply(psi, 12, 2, 3, 7, w1, w2, diag)
    counts = kernels.launch_counts()
    assert counts[f"window_apply[{reduced_mode}]"] == 1
    assert counts[f"pair_apply_trailing[{reduced_mode}]"] == 1
    assert counts["window_apply"] == counts["pair_apply_trailing"] == 0


def test_renormalised_bf16_3x_runner_on_card(cuda):
    """The scanned runner in bf16_3x with renorm_every=1 keeps the norm
    within 1e-5 of 1 and the state within 1e-4 of the f32 run."""
    n = 14
    plan = compile_circuit(random_circuit(n, 4, seed=2))
    psi0 = planar.zero_state_planar(n, cuda)
    want = planar.make_scanned_planar_runner(plan, 8)(psi0)
    kernels.set_dot_mode("bf16_3x")
    try:
        got = planar.make_scanned_planar_runner(plan, 8,
                                                renorm_every=1)(psi0)
    finally:
        kernels.set_dot_mode("f32")
    assert abs(float(planar.planar_norm(got)) - 1.0) <= 1e-5
    assert rel_l2(got, want) <= 1e-4


# ---------------------------------------------------------------------------
# the particle axis: one launch for a (P, 2, 2^n) batch
# ---------------------------------------------------------------------------

PARTICLES = 3


def _batch(n, rng, device, P=PARTICLES):
    psi = rng.normal(size=(P, 2, 2**n))
    psi /= np.linalg.norm(psi, axis=(1, 2), keepdims=True)
    return torch.tensor(psi, dtype=torch.float32, device=device)


def _one_launch_each(fn, batch):
    """(fn(batch), [fn(batch[p]) for each p]) with the launches of the
    batched call counted: one, whatever P is."""
    singles = [fn(batch[p].contiguous()) for p in range(batch.shape[0])]
    kernels.reset_launch_counts()
    got = fn(batch)
    launches = sum(kernels.launch_counts().values())
    return got, singles, launches


@pytest.mark.parametrize("where", ["first", "middle", "trailing"])
@pytest.mark.parametrize("width", range(1, 8))
def test_window_particle_axis_bit_for_bit(cuda, any_mode, width, where):
    """A batch of 3 in one launch gives each particle the bits of its own
    launch, in every dot mode, with flips and phases; at 20 qubits the
    persistent kernels' grid is shared out among the particles."""
    for n in (12, 20):
        start = {"first": 0, "middle": (n - width) // 2,
                 "trailing": n - width}[where]
        rng = np.random.default_rng(width + n)
        psi = _batch(n, rng, cuda)
        w = _unitary(2**width, rng, cuda)
        phases = (((0, start, n - 1), complex(np.exp(0.5j)), 0),)
        flips = tuple(int(m) for m in rng.integers(0, 2**n, size=3))
        diag = kernels.fused_diagonals(n, flips, phases, cuda)

        def fn(x):
            return kernels.window_apply(x, n, start, width, w, diag)
        got, singles, launches = _one_launch_each(fn, psi)
        assert launches == 1
        for p, one in enumerate(singles):
            assert torch.equal(got[p], one), (n, p)
        want = kernels.window_apply_ref(psi, n, start, width, w, diag)
        assert rel_l2(got, want) <= MODE_TOL.get(any_mode, (TOL,))[0]


# (n, start, width1, width2): the tensor-core trailing and middle pairs, the
# narrow pairs, the streaming pairs and two windows (D1 >= 8 with D2 <= 4
# among them)
BATCH_PAIRS = [(12, 0, 3, 7), (18, 4, 7, 7), (20, 0, 5, 7), (12, 2, 3, 3),
               (18, 9, 2, 7), (12, 3, 2, 7), (14, 6, 2, 2), (12, 8, 2, 2),
               (14, 5, 7, 2), (14, 0, 6, 1)]


@pytest.mark.parametrize("geometry", BATCH_PAIRS,
                         ids=lambda g: "n{}_s{}_{}x{}".format(*g))
def test_pair_particle_axis_bit_for_bit(cuda, any_mode, geometry):
    n, start, width1, width2 = geometry
    rng = np.random.default_rng(sum(geometry))
    _, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
    psi = _batch(n, rng, cuda)

    def fn(x):
        return kernels.pair_apply(x, n, start, width1, width2, w1, w2, diag)
    got, singles, launches = _one_launch_each(fn, psi)
    two = kernels.pair_route(n, start, width1, width2) == "two_windows"
    assert launches == (2 if two else 1)
    for p, one in enumerate(singles):
        assert torch.equal(got[p], one), p
    want = kernels.pair_apply_ref(psi, n, start, width1, width2, w1, w2,
                                  diag)
    assert rel_l2(got, want) <= PAIR_TOL[any_mode][0]


@pytest.mark.parametrize("H,T", [(8, 128), (4096, 128), (1000, 7)])
def test_reflect_particle_axis_bit_for_bit(cuda, H, T):
    """Each particle its own c, partials and lane dot D."""
    rng = np.random.default_rng(H + T)
    psi = torch.tensor(rng.normal(size=(PARTICLES, 2, H, T)),
                       dtype=torch.float32, device=cuda)
    a = torch.tensor(rng.normal(size=(2, H, 1)), dtype=torch.float32,
                     device=cuda)
    b = torch.tensor(rng.normal(size=(2, 1, T)), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.normal(size=(PARTICLES, 2)), dtype=torch.float32,
                     device=cuda)
    flips = torch.tensor(rng.integers(0, H * T, size=2), dtype=torch.int64,
                         device=cuda)
    d, singles, launches = _one_launch_each(
        lambda x: kernels.reflect_dot(x, a, b), psi)
    assert launches == 1 and d.shape == (PARTICLES, 2, 1, T)
    for p, one in enumerate(singles):
        assert torch.equal(d[p], one)
    kernels.reset_launch_counts()
    out, d2 = kernels.reflect_update(psi, c, a, b, flips)
    assert kernels.launch_counts()["reflect_update"] == 1
    for p in range(PARTICLES):
        o1, e1 = kernels.reflect_update(psi[p].contiguous(), c[p], a, b,
                                        flips)
        assert torch.equal(out[p], o1) and torch.equal(d2[p], e1)
    out_ref, d_ref = kernels.reflect_update_ref(psi, c, a, b, flips)
    assert rel_l2(out, out_ref) <= TOL and rel_l2(d2, d_ref) <= TOL


def test_launch_counts_do_not_depend_on_particles(cuda):
    """A plan over 1, 3 and 17 particles launches the same kernels the same
    number of times."""
    n = 11
    plan = compile_circuit(random_circuit(n, 3, seed=9))
    counts = []
    for P in (1, 3, 17):
        psi = _batch(n, np.random.default_rng(P), cuda, P)
        kernels.reset_launch_counts()
        planar.apply_plan_planar(psi, plan)
        counts.append(kernels.launch_counts())
    assert counts[0] == counts[1] == counts[2]
    assert sum(counts[0].values()) > 0


def test_device_ensemble_on_card_matches_cpu(cuda):
    """The exact fan-out of a 10-qubit program with mid-circuit meas, disc
    and targeted qset, on the card and on the CPU; the sampled run twice
    from one seed (the CUDA generator is seeded)."""
    from qbot_tpu_torch import lower_program, run_lowered_ensemble
    from qbot_tpu_torch.inference.ensemble_exec import ensemble_mixture

    src = "\n".join(
        ["qset tensorExp(comp[0], 10)"]
        + [f"gate hadamardGate ; {q}" for q in range(10)]
        + ["meas a ; computation ; [0, 3]", "gate pauliXGate ; 5 ; [3]",
           "disc [9]", "qset hadamard.kets[1] ; [2]",
           "gate hadamardGate ; 4", "meas b ; computation ; [4, 5]"])
    runs = {}
    for device in ("cpu", cuda):
        res, ens = run_lowered_ensemble(lower_program(src, mid_measure=True),
                                        device=device)
        runs[str(device)] = ({k: np.asarray(v.probs) for k, v in res.items()},
                             ensemble_mixture(ens))
    (pc, mc), (pg, mg) = runs.values()
    for name in pc:
        np.testing.assert_allclose(pg[name], pc[name], atol=1e-5)
    np.testing.assert_allclose(mg, mc, atol=1e-5)
    sampled = [run_lowered_ensemble(lower_program(src, mid_measure=True),
                                    device=cuda, sample=16, seed=3)[0]
               for _ in range(2)]
    for name in sampled[0]:
        assert sampled[0][name].probs == sampled[1][name].probs


def test_device_ensemble_reuses_its_initial_state_on_card(cuda):
    """A 12-qubit SMC program run twice on the card from one seed, and
    once more lowered anew: equal particles, bit for bit; the initial state
    kept on the program, on the card, is unchanged by sampled and exact
    runs."""
    from portbench.families.smc_program import smc_program
    from qbot_tpu_torch.frontend import lowering
    from qbot_tpu_torch.tpu.planar import product_state_planar

    rng = np.random.default_rng(5)
    text, _ = smc_program(12, iter(rng.uniform(0.8, 2.3, size=48)))
    lp = lowering.lower_program(text, mid_measure=True)
    want = product_state_planar(lp.initial_kets, cuda)
    runs = [lowering.run_lowered_ensemble(p, sample=16, seed=3,
                                          device=cuda)[1]
            for p in (lp, lp, lowering.lower_program(text, mid_measure=True))]
    kept = lp._init_planar[2]
    assert kept.device == cuda and torch.equal(kept, want)
    for ens in runs[1:]:
        assert torch.equal(ens.psi, runs[0].psi)
        assert torch.equal(ens.log_w, runs[0].log_w)
    lowering.run_lowered_ensemble(lp, sample=0, device=cuda)
    assert lp._init_planar[2] is kept and torch.equal(kept, want)


# ---------------------------------------------------------------------------
# gradients: the Functions' backward through the kernels
# ---------------------------------------------------------------------------

# dot mode -> relative L2 of a cotangent against PyTorch's autograd through
# the plain versions in the mode: the backward's W† launch rounds ḡ in the
# mode, which the plain versions' autograd (each rounding's gradient the
# identity) does not, so a cotangent is held at the mode's float64 limit
GRAD_TOL = {"f32": TOL, "bf16_3x": MODE_TOL["bf16_3x"][2],
            "bf16": MODE_TOL["bf16"][2]}


def _cotangents(fn, inputs, cot):
    xs = [x.clone().requires_grad_() for x in inputs]
    return torch.autograd.grad(fn(*xs), xs, cot)


def _counted_backward(fn, inputs, cot):
    """(cotangents through the kernels, launches of the forward, launches
    of forward and backward)."""
    xs = [x.clone().requires_grad_() for x in inputs]
    kernels.reset_launch_counts()
    out = fn(*xs)
    forward = kernels.launch_counts()
    grads = torch.autograd.grad(out, xs, cot)
    return grads, forward, kernels.launch_counts()


# (n, start, width): the D = 128 window, the trailing one, a D = 8 first
# window and the streaming D = 4 window
GRAD_WINDOWS = [(16, 2, 7), (16, 9, 7), (16, 0, 3), (16, 3, 2)]


@pytest.mark.parametrize("geometry", GRAD_WINDOWS,
                         ids=lambda g: "n{}_s{}_w{}".format(*g))
def test_window_grad_on_card(cuda, any_mode, geometry):
    """ψ̄ and W̄ through the window Function against autograd through the
    plain versions on the card; the backward is one more launch of the
    same counter, W† in the current mode."""
    n, start, width = geometry
    rng = np.random.default_rng(sum(geometry))
    psi, w = _state(n, rng, cuda), _unitary(2**width, rng, cuda)
    diag = kernels.fused_diagonals(n, (5, 77), (((start,), np.exp(0.4j), -1),),
                                   cuda)
    cot = _state(n, rng, cuda)
    got, forward, total = _counted_backward(
        lambda p, m: kernels.window_apply(p, n, start, width, m, diag),
        (psi, w), cot)
    want = _cotangents(
        lambda p, m: kernels.window_apply_ref(p, n, start, width, m, diag),
        (psi, w), cot)
    for g, h in zip(got, want):
        assert rel_l2(g, h) <= GRAD_TOL[any_mode]
    assert sum(forward.values()) == 1
    assert total == {k: 2 * v for k, v in forward.items()}


# (n, start, width1, width2): middle and trailing pairs at D1 >= 8, the
# narrow and the streaming pair, two windows at D1 > 32
GRAD_PAIRS = [(17, 0, 3, 7), (17, 3, 7, 7), (16, 0, 2, 7), (16, 2, 2, 2),
              (16, 0, 6, 3)]


@pytest.mark.parametrize("geometry", GRAD_PAIRS,
                         ids=lambda g: "n{}_s{}_{}x{}".format(*g))
def test_pair_grad_on_card(cuda, any_mode, geometry):
    """ψ̄, W̄1 and W̄2 through the pair Function against autograd through
    the plain versions; the backward runs the pair's own route again with
    (W1†, W2†)."""
    n, start, width1, width2 = geometry
    rng = np.random.default_rng(sum(geometry))
    psi, w1, w2, diag = _pair_inputs(n, start, width1, width2, rng, cuda)
    cot = _state(n, rng, cuda)
    got, forward, total = _counted_backward(
        lambda p, a, b: kernels.pair_apply(p, n, start, width1, width2, a, b,
                                           diag), (psi, w1, w2), cot)
    want = _cotangents(
        lambda p, a, b: kernels.pair_apply_ref(p, n, start, width1, width2,
                                               a, b, diag),
        (psi, w1, w2), cot)
    for g, h in zip(got, want):
        assert rel_l2(g, h) <= GRAD_TOL[any_mode]
    assert total == {k: 2 * v for k, v in forward.items()}


def test_reflect_grad_on_card(cuda):
    """The reflection's adjoint through reflect_dot and reflect_update
    against autograd through their plain versions."""
    from qbot_tpu_torch.tpu.compiler import ReflectStep

    n = 14
    c = Circuit(n)
    c.phase_flip(1234)
    for q in range(n):
        c.h(q)
    c.phase_flip(0)
    for q in range(n):
        c.h(q)
    step = next(s for s in compile_circuit(c).steps
                if isinstance(s, ReflectStep))
    rng = np.random.default_rng(14)
    psi, cot = _state(n, rng, cuda), _state(n, rng, cuda)
    kernel = planar._reflect_fn(step, cuda, planar._KERNELS)
    plain = planar._reflect_fn(step, cuda, planar._PLAIN)
    (got,), forward, total = _counted_backward(lambda p: kernel(p, None),
                                               (psi,), cot)
    (want,) = _cotangents(lambda p: plain(p, None), (psi,), cot)
    assert rel_l2(got, want) <= TOL
    assert forward["reflect_dot"] == forward["reflect_update"] == 1
    assert total["reflect_dot"] == total["reflect_update"] == 2


# dot mode -> (log-prob value relative, gradient relative L2) of a whole
# plan through the kernels against the plain versions in the mode:
# chip_smoke.py's phase 11 limits (its docstring says why)
LOG_PROB_TOL = {"f32": (1e-5, 1e-4), "bf16_3x": (1e-4, 1e-3),
                "bf16": (1e-2, 1e-1)}


def test_log_prob_grad_on_card(cuda, any_mode):
    """The value and angle gradient of a 14-qubit ansatz through the
    kernels against the plain versions' autograd, paired and unpaired;
    every step after the first (whose input, |0⟩, needs no cotangent)
    launches its kernel once more in the backward."""
    from qbot_tpu_torch.inference.hmc import (
        make_circuit_log_prob_planar,
        value_and_grad,
    )
    from qbot_tpu_torch.tpu.circuit import parameterized_layers

    n = 14
    circ = parameterized_layers(n, 3)
    counts = np.zeros(2**n)
    counts[0], counts[1] = 64.0, 32.0
    theta = torch.linspace(0.1, 1.0, circ.num_params, device=cuda)
    for pair in (True, False):
        plan = compile_circuit(circ, pair=pair)
        lp = make_circuit_log_prob_planar(plan, counts, device=cuda)
        kernels.reset_launch_counts()
        lp(theta)
        forward = kernels.launch_counts()
        kernels.reset_launch_counts()
        value, grad = value_and_grad(lp)(theta)
        both_ways = kernels.launch_counts()
        kernels.reset_launch_counts()
        planar.apply_plan_planar(planar.zero_state_planar(n, cuda),
                                 type(plan)(n, plan.window, plan.steps[:1],
                                            plan.num_params), theta)
        first = kernels.launch_counts()
        assert both_ways == {k: 2 * v - first[k] for k, v in forward.items()}

        def plain_lp(t):
            psi = planar.apply_plan_planar_ref(
                planar.zero_state_planar(n, cuda), plan, t)
            p = torch.clamp(planar.planar_probs(psi), 1e-12, 1.0)
            c = torch.as_tensor(counts, dtype=torch.float32, device=cuda)
            return torch.sum(c * torch.log(p)) - 0.5 * torch.sum(
                (t / 10.0) ** 2)

        want_v, want_g = value_and_grad(plain_lp)(theta)
        value_tol, grad_tol = LOG_PROB_TOL[any_mode]
        assert float(value) == pytest.approx(float(want_v), rel=value_tol)
        assert rel_l2(grad, want_g) <= grad_tol


# ---------------------------------------------------------------------------
# window="auto": the ranked plan runs as the plan at its width
# ---------------------------------------------------------------------------

def _counter(launch, mode):
    """The launch count a modelled launch (compiler.step_launches) moves."""
    trailing = launch.start + sum(launch.widths) == launch.n
    name = {"window_tc": "window_apply_trailing" if trailing
            else "window_apply",
            "window_stream": "window_apply_stream",
            "pair_tc_middle": "pair_apply",
            "pair_tc_trailing": "pair_apply_trailing",
            "pair_narrow": "pair_apply_trailing_narrow" if trailing
            else "pair_apply_narrow",
            "pair_stream": "pair_apply_stream"}.get(launch.family)
    if name is None:
        return launch.family if launch.family.startswith("reflect") else None
    return name if mode == "f32" else f"{name}[{mode}]"


def _auto_circuit(name):
    from qbot_tpu_torch.tpu.circuit import (
        grover_circuit,
        parameterized_layers,
    )

    return {"random_16": lambda: random_circuit(16, 4, seed=3),
            "random_17": lambda: random_circuit(17, 4, seed=5),
            "ansatz_17": lambda: parameterized_layers(17, 3),
            "grover_16": lambda: grover_circuit(16, 1234, iterations=2),
            }[name]()


@pytest.mark.parametrize("name", ["random_16", "random_17", "ansatz_17",
                                  "grover_16"])
def test_auto_plan_runs_as_its_width(cuda, any_mode, name):
    """At 16-17 qubits in each dot mode, the auto plan launches the same
    kernels (and, on the dot engine, library products) as the explicit
    plan of its engine and width and gives its state bit for bit; every
    launch the engine's cost model counts moves its count once."""
    from qbot_tpu_torch.tpu import dotplan
    from qbot_tpu_torch.tpu.compiler import dot_step_launches, step_launches

    c = _auto_circuit(name)
    auto = compile_circuit(c, window="auto")
    explicit = compile_circuit(c, window=auto.window, partition=(
        "dot" if auto.engine == "dot" else "kernel"))
    explicit.engine = auto.engine
    params = (torch.linspace(0.1, 1.0, c.num_params, device=cuda)
              if c.num_params else None)
    psi0 = planar.zero_state_planar(c.n, cuda)
    states, counts, products = [], [], []
    for plan in (auto, explicit):
        kernels.reset_launch_counts()
        dotplan.reset_product_counts()
        states.append(planar.apply_plan_planar(psi0, plan, params))
        torch.cuda.synchronize()
        counts.append(kernels.launch_counts())
        products.append(sum(dotplan.product_counts().values()))
    assert counts[0] == counts[1] and products[0] == products[1]
    assert torch.equal(states[0], states[1])
    want = dict.fromkeys(counts[0], 0)
    launches = dot_step_launches if auto.engine == "dot" else step_launches
    windows = 0
    for step in auto.steps:
        for launch in launches(step, c.n):
            windows += launch.family.startswith("dot_window")
            key = _counter(launch, any_mode)
            if key is not None:
                want[key] += 1
    assert counts[0] == want
    assert products[0] == windows


@pytest.mark.parametrize("mode", ["f32", "f32_mix", "bf16_3x", "bf16"])
def test_dot_engine_on_the_card(cuda, mode):
    """The dot engine's library products on a CUDA state: a 16-qubit
    brickwork on the dot partition at widths 4 and 8, each window one
    product in the mode its width runs (f32_mix: bf16_3x at 7 or more
    qubits, else f32), within the float64 limit of each product (f32
    TOL) of the same products computed as the CPU computes them."""
    from qbot_tpu_torch.tpu import dotplan

    kernels.set_dot_mode(mode)
    try:
        for w in (4, 8):
            plan = compile_circuit(random_circuit(16, 4, seed=7), w,
                                   partition="dot")
            lowered = dotplan.lower_dot_plan(plan)
            wins = [s for s in lowered.steps if isinstance(s, dotplan._Win)]
            psi0 = _state(16, np.random.default_rng(w), cuda)
            dotplan.reset_product_counts()
            got = dotplan.apply_plan_dot(psi0, lowered)
            torch.cuda.synchronize()
            want = {}
            for s in wins:
                k = f"dot_window[{dotplan.window_mode(mode, s.step.width)}]"
                want[k] = want.get(k, 0) + 1
            assert dotplan.product_counts() == want
            limit = TOL if mode == "f32" else sum(
                MODE_TOL.get(dotplan.window_mode(mode, s.step.width),
                             (0, 0, TOL))[2] for s in wins)
            assert rel_l2(got, dotplan.apply_plan_dot_ref(psi0, lowered)) \
                <= limit
    finally:
        kernels.set_dot_mode("f32")


def test_particle_mesh_2x1_on_the_card(cuda):
    """The particle × qubit mesh on the card: a 2 × 1 gloo mesh of two
    ranks sharing it runs a 12-qubit version of ``bench.py``'s SMC program
    (4 collapse events) in exact fan-out mode within 1e-5 of the
    single-device runner, its 16-particle sampled run sums to 1 within
    1e-3, and each rank launched the product kernels (each segment's
    plan is one pair at 12 qubits)."""
    import warnings

    from _torch_sharded_ensemble_ranks import smc_program_run
    from qbot_tpu_torch import lower_program, run_lowered_ensemble
    from qbot_tpu_torch.tpu.sharding import launch

    n = 12
    rows = [f"gate hadamardGate ; {q}" for q in range(0, n, 3)] + [
        f"gate pauliXGate ; {q + 1} ; [{q}]" for q in range(0, n - 1, 3)]
    src = "\n".join([f"qset tensorExp(computation.kets[0], {n})", *rows,
                     "meas a ; computation ; [0]", *rows,
                     f"gate hadamardGate ; {n // 2}",
                     f"meas b ; computation ; [{n // 2}]", *rows,
                     f"disc [{n - 1}]", "meas c ; computation ; [1, 2]"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want, _ = run_lowered_ensemble(lower_program(src, mid_measure=True),
                                       device=cuda)
    for sample in (0, 16):
        ranks = launch(smc_program_run, (2, 1), src, sample, device="cuda",
                       backend="gloo", timeout=600, collective_timeout=120.0)
        for name, res in want.items():
            got = ranks[0][f"probs_{name}"]
            if sample:
                assert abs(float(np.sum(got)) - 1.0) <= 1e-3
            else:
                np.testing.assert_allclose(got, res.probs, atol=TOL)
        for rank in ranks.values():
            counts = rank["launches"]
            assert sum(v for k, v in counts.items()
                       if k.startswith(("window_apply", "pair_apply"))), \
                counts



# ---------------------------------------------------------------------------
# 2^31 amplitudes a plane: the launch families of a 33-qubit register's
# shard on one of four cards (portbench's sv33x4-brickwork), where the
# imaginary plane starts past the reach of a 32-bit int
# ---------------------------------------------------------------------------

BIG_N = 31
# (start, widths, launch family): every family the cell's plan launches,
# with its B (2^17, 1, 2^13, 1)
BIG_GEOMETRIES = {"window_d16_middle": (10, (4,), "window_tc"),
                  "window_d128_trailing": (24, (7,), "window_tc"),
                  "pair_16x16_middle": (10, (4, 4), "pair_tc_middle"),
                  "pair_16x128_trailing": (20, (4, 7), "pair_tc_trailing")}
# the modes the cell's limits are read in: its own and the control's
BIG_MODES = {"f32": F64_TOL, "bf16_3x": MODE_TOL["bf16_3x"][2]}


@pytest.fixture(scope="module")
def big_state():
    """A seeded (2, 2^31) float32 state on the card: 16 GiB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(31)
    psi = torch.randn((2, 2**BIG_N), generator=gen, device="cuda")
    yield psi
    del psi
    torch.cuda.empty_cache()


def _big_columns(cols: int) -> list:
    """Columns checked: the first, about the middle (their elements about
    2^30) and the last (ending at element 2^31 − 1 of each plane)."""
    return [0, 1, cols // 2 - 1, cols // 2, cols - 2, cols - 1]


@pytest.mark.parametrize("mode", list(BIG_MODES))
@pytest.mark.parametrize("name", list(BIG_GEOMETRIES))
def test_launch_family_at_2_31_amplitudes(cuda, big_state, name, mode):
    """Each launch family of the 33-qubit cell's plan, with a phase on the
    register's first, a window and its last qubit, on a (2, 2^31) state: its
    outputs at the first, middle and last columns of both planes (the
    imaginary plane from flat element 2^31 on) against the product of
    those columns' own inputs in float64."""
    start, widths, family = BIG_GEOMETRIES[name]
    assert kernels.launch_family(BIG_N, start, *widths) == family
    rng = np.random.default_rng(len(name) + 7 * len(mode))
    ws = [_unitary(2**w, rng, cuda) for w in widths]
    end = start + sum(widths)
    qubits = (0, start, end - 1, BIG_N - 1)
    z = complex(np.exp(0.9j))
    diag = kernels.fused_diagonals(BIG_N, (), ((qubits, z, -1),), cuda)
    kernels.set_dot_mode(mode)
    try:
        if len(widths) == 1:
            out = kernels.window_apply(big_state, BIG_N, start, widths[0],
                                       ws[0], diag)
        else:
            out = kernels.pair_apply(big_state, BIG_N, start, *widths, *ws,
                                     diag)
    finally:
        kernels.set_dot_mode("f32")
    w = np.ones((1, 1), np.complex128)
    for t in ws:
        t = t.double().cpu().numpy()
        w = np.kron(w, t[0] + 1j * t[1])
    d, log_b = w.shape[0], BIG_N - end
    mask, want = kernels.phase_bits(BIG_N, qubits, -1)
    for c in _big_columns(2**BIG_N // d):
        base = ((c >> log_b) << (log_b + int(np.log2(d)))) | \
            (c & ((1 << log_b) - 1))
        idx = torch.tensor([base + (j << log_b) for j in range(d)],
                           device=cuda)
        x = big_state[:, idx].double().cpu().numpy()
        x = x[0] + 1j * x[1]
        x = np.where((idx.cpu().numpy() & mask) == want, x * z, x)
        ref = w @ x
        got = out[:, idx].double().cpu().numpy()
        got = got[0] + 1j * got[1]
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert err <= BIG_MODES[mode], (c, err)
    del out
