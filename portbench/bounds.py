"""The yardstick of the kernels' roofline: published H100 peaks, the bound
of a pass, and the bound of each kind of plan step from its geometry.

The peaks and ``bound``, ``product_bound`` and ``pair_bound`` are frozen
copies of ``chip_smoke.py:319-322`` and ``chip_smoke.py:532-579`` (the
NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM, dense TF32 at 495, BF16 at
989 and FP32 outside the tensor cores at 67 TFLOP/s), so that a change to
the program cannot move them.

A step's bound counts each input byte read once and each output byte
written once, and 8·D FLOPs an amplitude for a window of D = 2^width
amplitudes (a pair: its two windows), at the rate of the configuration's
dot mode.  It reads only the step's geometry, so the same step reads the
same work whichever kernel or engine runs it.  A step kind this module does
not know raises.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12      # H100 SXM data sheet: memory rate
TF32_FLOPS_S = 495e12      # dense TF32 tensor-core peak
BF16_FLOPS_S = 989e12      # dense BF16 tensor-core peak
FP32_FLOPS_S = 67e12       # FP32 outside the tensor cores

STATE_BYTES = 16           # a planar float32 amplitude read and written


def bound(nbytes: float, tf32_flops: float = 0.0,
          fp32_flops: float = 0.0, bf16_flops: float = 0.0
          ) -> tuple[float, str]:
    """(bound ms, what bounds it): bytes over the memory rate against
    3xTF32 products (3 TF32 FLOPs each), BF16 tensor-core FLOPs and FP32
    arithmetic over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = (3 * tf32_flops / TF32_FLOPS_S + bf16_flops / BF16_FLOPS_S
             + fp32_flops / FP32_FLOPS_S)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def product_bound(nbytes: float, flops: float, mode: str,
                  tensor_cores: bool) -> tuple[float, str]:
    """The bound of a window or pair doing ``flops`` of complex products in
    dot ``mode``: on the tensor cores 3xTF32 (f32) or 3 and 1 BF16 products
    (bf16_3x, bf16); in the FMA variants (widths below 8) 1, 3 and 1 FP32
    products."""
    parts = 3 if mode == "bf16_3x" else 1
    if not tensor_cores:
        return bound(nbytes, fp32_flops=parts * flops)
    if mode == "f32":
        return bound(nbytes, tf32_flops=flops)
    return bound(nbytes, bf16_flops=parts * flops)


def pair_bound(nbytes: float, n_amps: int, d1: int, d2: int,
               mode: str) -> tuple[float, str]:
    """The bound of a pair on ``n_amps`` amplitudes: its two windows'
    products, 8 (D1 + D2) FLOPs an amplitude, on the tensor cores (D1,
    D2 >= 8) or in FP32 FMAs (D2 <= 4); the narrow pair (D1 = 2, 4 with
    D2 >= 8) runs W2's on the tensor cores and W1's 8 D1 (3 x 8 D1 in
    bf16_3x) at the FP32 rate, on other units, so its bound is the larger of
    its bytes and the two."""
    if d1 >= 8 or d2 < 8:
        return product_bound(nbytes, 8 * (d1 + d2) * n_amps, mode,
                             d1 >= 8 and d2 >= 8)
    parts = 3 if mode == "bf16_3x" else 1
    w2 = 8 * d2 * n_amps
    t_w2 = 3 * w2 / TF32_FLOPS_S if mode == "f32" else parts * w2 / \
        BF16_FLOPS_S
    t_ops = max(t_w2, parts * 8 * d1 * n_amps / FP32_FLOPS_S)
    t_bytes = nbytes / HBM_BYTES_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


# the modes' products: f32_mix runs the kernels' f32 tile
_BOUND_MODE = {"f32": "f32", "f32_mix": "f32", "bf16_3x": "bf16_3x",
               "bf16": "bf16"}


def _window_s(n: int, width: int, mode: str) -> float:
    amps = 2 ** n
    d = 2 ** width
    return product_bound(STATE_BYTES * amps, 8 * d * amps, mode,
                         d >= 8)[0] / 1e3


def step_bound_s(step, n: int, mode: str) -> float:
    """Seconds a plan step takes at least on one H100, on one ``n``-qubit
    planar float32 state, by the kind of step (its class name) and its
    geometry.  Flips and phases fused into a window cost no pass; a flip
    alone is one amplitude; a diagonal, a phase or a reflection reads and
    writes the state once (a reflection's ⟨v|ψ⟩ and rank-1 update are
    8 FLOPs an amplitude each, at the FP32 rate); a contraction on k
    targets is a window of width k."""
    mode = _BOUND_MODE[mode]
    kind = type(step).__name__
    amps = 2 ** n
    if kind == "WindowStep":
        return _window_s(n, step.width, mode)
    if kind == "PairStep":
        return pair_bound(STATE_BYTES * amps, amps, 2 ** step.first.width,
                          2 ** step.second.width, mode)[0] / 1e3
    if kind == "ReflectStep":
        return bound(STATE_BYTES * amps, fp32_flops=16 * amps)[0] / 1e3
    if kind in ("DiagStep", "PhaseStep"):
        return bound(STATE_BYTES * amps, fp32_flops=6 * amps)[0] / 1e3
    if kind == "FlipStep":
        return bound(STATE_BYTES)[0] / 1e3
    if kind == "ContractStep":
        return _window_s(n, len(step.targets), mode)
    raise ValueError(f"no bound for a plan step of kind {kind!r}")


def plan_bound_s(plan, mode: str) -> float:
    """The sum of :func:`step_bound_s` over a plan's steps."""
    return sum(step_bound_s(s, plan.n, mode) for s in plan.steps)


def fill_bound_s(n: int) -> float:
    """A fresh planar state written once (8 bytes an amplitude)."""
    return bound(8 * 2 ** n)[0] / 1e3


def probs_bound_s(n: int) -> float:
    """The readout |re|² + |im|²: 8 bytes an amplitude read, 4 written."""
    return bound(12 * 2 ** n, fp32_flops=3 * 2 ** n)[0] / 1e3
