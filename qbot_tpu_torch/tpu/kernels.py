"""Hand-written CUDA kernels of the planar statevector path, and their plain
PyTorch versions.

Port of :mod:`qbot_tpu.tpu.kernels` (the forward window, pair and
reflection kernels).  Each wrapper dispatches on the device of the state it
is given: a CPU tensor goes through the plain PyTorch version beside it, a
CUDA tensor launches the kernel from ``qbot_tpu_torch/csrc/`` or raises.
There is no fallback.

The window and pair products run in the dot mode of :func:`set_dot_mode`,
the reference's ``--precision`` (``qbot_tpu/tpu/kernels.py:41-71``):
``f32`` and ``f32_mix`` in full float32 (the kernels' 3xTF32 tile;
``f32_mix`` is the dot engine's per-window rule, :mod:`.dotplan`),
``bf16_3x`` as three bfloat16 products of a hi/lo split, ``bf16`` as one.
The plain versions compute each mode as the reference's ``_dot`` does; a
CUDA tensor launches the kernel of the mode, never another.

The kernels are CUDA C++ for ``sm_90a`` with a plain C interface, compiled
by ``nvcc`` at first use (one process per source, all at once, then one
link) into ``qbot_tpu_torch/_build/<hash of the sources>/`` and loaded with
:mod:`ctypes`.  They launch on PyTorch's current stream, never synchronise,
and allocate nothing: the wrappers allocate outputs and scratch with
``torch.empty``.

Every wrapper takes one planar state, ``(2, 2^n)`` (a reflection's
``(2, H, T)`` view), or a batch of them with a leading particle axis,
``(P, 2, 2^n)``, the layout of the ensemble executor's
``QuantumEnsemble.psi`` (``qbot_tpu/inference/ensemble_exec.py:43-62``):
one launch serves the whole batch, as the reference's ``pallas_call`` under
``jax.vmap`` gains a batch grid axis.  The CUDA kernels put the particle on
a grid axis of its own and advance to its state on entry
(``csrc/tc_tile.cuh``: ``particle_offset``), so each particle's bits are
those of its own launch; the plain versions take the batch as a leading
dimension of the same operations.

``window_apply`` and ``pair_apply`` are differentiable in the state and
the matrices (``torch.autograd.Function``s, the reference's
``jax.custom_vjp``s, ``qbot_tpu/tpu/kernels.py:806-912``): the state
cotangent is the same wrapper again with W† (so the same CUDA kernel in
the current dot mode on a CUDA tensor), then the conjugate diagonals; the
matrix cotangents are float32 matrix products against the recomputed
y = ΦFψ, as the reference's einsums outside any Pallas kernel are.  A call
whose inputs need no gradient launches directly.

Which kernel serves a window or a pair of given widths is said once, by
:func:`launch_family`; the launch counters and the compiler's cost model
(``compiler.step_launches``) read it there.  A pair with D1 >= 8 and
D2 <= 4 runs as two window launches (:func:`pair_route`): explicit
``partition="dot"`` plans on the kernel engine hold such pairs.

Every wrapper counts its launches (:func:`launch_counts`), one a call
whatever the number of particles, so a run can show that it went through
the kernel.  ``window_apply`` and ``pair_apply``
count their trailing launches (B = 1, the role of the TPU's
``_right_multiply`` and ``_pair_b1``) apart, ``pair_apply`` its narrow
pairs (D1 = 2, 4 with D2 >= 8, which run the window's tile) apart, the
streaming FMA kernels of the narrow widths (windows at D = 2, 4, pairs at
D1, D2 = 2, 4) apart, and the launches of each reduced mode apart, as
``window_apply[bf16_3x]`` and so on.  The f32 windows at D = 128, which
run on Hopper's warpgroup products (``csrc/window_wg.cuh``), count once
more under :data:`WG_COUNTER` in the program's counter table, and the f32
trailing pairs at D2 = 128 with D1 = 64, 128, which run them too
(``csrc/pair_wg.cuh``), under :data:`PAIR_WG_COUNTER`.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from qbot_tpu_torch.utils import profiling

__all__ = ["set_dot_mode", "dot_mode", "DOT_MODES",
           "FusedDiagonals", "fused_diagonals", "phase_bits",
           "window_apply", "window_apply_ref",
           "pair_apply", "pair_apply_ref", "pair_route", "launch_family",
           "reflect_dot", "reflect_dot_ref",
           "reflect_update", "reflect_update_ref",
           "build_kernels", "reset_launch_counts", "launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]

_lib = None

# The widths that pick a launch's kernel (launch_family, pair_route): a
# window or pair product of D <= 4 runs on a streaming FMA kernel (below
# the tensor-core tile's k-step and n-tile of 8); a middle pair holds a
# first window of D1 <= 32 (qbot_tpu/tpu/kernels.py:652-706)
_STREAM_MAX_WIDTH = 2
_MIDDLE_MAX_WIDTH = 5

# The sources nvcc compiles once per variant, with the variant's -D defines
# (csrc/window_tc.cu, csrc/pair_tc.cu, csrc/pair_stream.cu): the
# tensor-core window (D1 = 1) and the narrow pair (D1 = 2, 4) once per D1
# and precision of the products (csrc/tc_tile.cuh: Prec), the tensor-core
# pair once per D1, orientation and precision, the streaming pair once per
# precision, so that the longest compiles of the library run side by side.
# Every other source compiles once.
_PRECS = (0, 1, 2)
_VARIANTS = {
    "window_tc.cu": [{"QBOT_D1": d1, "QBOT_PREC": p} for p in _PRECS
                     for d1 in (1, 2, 4)],
    "pair_tc.cu": [{"QBOT_D1": 2**w1, "QBOT_MIDDLE": middle, "QBOT_PREC": p}
                   for p in _PRECS
                   for middle, top in ((0, 7), (1, _MIDDLE_MAX_WIDTH))
                   for w1 in range(_STREAM_MAX_WIDTH + 1, top + 1)],
    "pair_stream.cu": [{"QBOT_PREC": p} for p in _PRECS],
}

# The dot modes of qbot_tpu/tpu/kernels.py:41-52, and the precision of the
# products each launches (csrc/tc_tile.cuh: Prec): f32_mix is the dot
# engine's per-window rule (tpu/dotplan.py: window_mode), and the kernels
# run it in full f32, as the reference's kernels do (:55-60)
DOT_MODES = ("f32", "f32_mix", "bf16_3x", "bf16")
_PREC = {"f32": 0, "f32_mix": 0, "bf16_3x": 1, "bf16": 2}
REDUCED_MODES = ("bf16_3x", "bf16")
_DOT_MODE = "f32"


def set_dot_mode(mode: str) -> None:
    """Select the precision of the window and pair products (the CLI's
    ``--precision``), for the kernels and their plain versions alike."""
    global _DOT_MODE
    if mode not in DOT_MODES:
        raise ValueError(f"unknown dot mode {mode!r}")
    _DOT_MODE = mode


def dot_mode() -> str:
    return _DOT_MODE


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of qbot_tpu_torch "
                       "are built from source at first use and need the "
                       "CUDA toolkit")


def _build_dir() -> Path:
    """The build directory of the current sources: named by a hash of the
    nvcc flags and of every file nvcc reads (the ``*.cu`` sources and the
    ``*.cuh`` headers they include), so an edited header rebuilds too."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    h.update(repr(sorted(_VARIANTS.items())).encode())
    for src in sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / h.hexdigest()[:16]


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` into one shared library (once per source hash,
    :func:`_build_dir`) and return its path.  The objects compile in
    parallel, one nvcc each: one per source, or one per variant of the
    sources of :data:`_VARIANTS`; ptxas's register and spill report of every
    kernel goes to ``ptxas.log`` beside the library.  A failed build raises
    with nvcc's stderr."""
    out_dir = _build_dir()
    lib_path = out_dir / "libqbot_tpu_torch.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent builders never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cmds, objs = [], []
        for src in sorted(_CSRC.glob("*.cu")):
            for defines in _VARIANTS.get(src.name, [{}]):
                obj = Path(tmp) / "_".join(
                    [src.stem, *(str(v) for v in defines.values())])
                objs.append(obj.with_suffix(".o"))
                cmds.append([_nvcc(), *_NVCC_FLAGS,
                             *(f"-D{k}={v}" for k, v in defines.items()),
                             "-Xptxas", "-v", "-c", "-o", str(objs[-1]),
                             str(src)])
        logs = _run_nvcc(cmds)
        (out_dir / "ptxas.log").write_text("".join(logs))
        lib_tmp = Path(tmp) / lib_path.name
        _run_nvcc([[_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(lib_tmp),
                    *map(str, objs)]])
        os.replace(lib_tmp, lib_path)
    return lib_path


def _run_nvcc(cmds) -> list[str]:
    """Run the nvcc commands at once and return their stderr; raise with
    the stderr of the first that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errors, logs = [], []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError(errors[0])
    return logs


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_kernels()))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.qbot_window_apply.argtypes = [p, p, p, i64, i32, i32, i32, p, i32,
                                      p, p, p, i32, i32, p, p]
    lib.qbot_window_apply.restype = i32
    lib.qbot_pair_apply.argtypes = [p, p, p, p, i64, i32, i32, i32, i32,
                                    p, i32, p, p, p, i32, i32, p, p]
    lib.qbot_pair_apply.restype = i32
    lib.qbot_reflect_dot.argtypes = [p, p, i64, i64, i64, i32, i32, p, p, p]
    lib.qbot_reflect_dot.restype = i32
    lib.qbot_reflect_update.argtypes = [p, p, p, p, p, p, i32, i64, i64,
                                        i64, i32, i32, p, p, p]
    lib.qbot_reflect_update.restype = i32
    lib.qbot_window_scratch_floats.argtypes = []
    lib.qbot_window_scratch_floats.restype = i32
    lib.qbot_pair_scratch_floats.argtypes = [i32]
    lib.qbot_pair_scratch_floats.restype = i32
    lib.qbot_error_string.argtypes = [i32]
    lib.qbot_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check_launch(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.qbot_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@contextlib.contextmanager
def _fp32_matmul():
    """Full-FP32 matrix products for the plain versions on a CUDA device
    (PyTorch's default, pinned here: TF32 keeps about 3 digits)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# launch counts: one per TPU kernel replaced (window_apply and pair_apply
# with B > 1 and with B = 1 apart, the narrow pairs apart from the other
# pairs, the streaming kernels of D <= 4 windows and D1, D2 <= 4 pairs, at
# any B, apart), and one per reduced mode of each of those that run the
# products
_PRODUCT_COUNTS = ("window_apply", "window_apply_trailing",
                   "window_apply_stream", "pair_apply",
                   "pair_apply_trailing", "pair_apply_narrow",
                   "pair_apply_trailing_narrow", "pair_apply_stream")
LAUNCH_COUNTS = (
    *_PRODUCT_COUNTS[:3], "reflect_dot", "reflect_update",
    *_PRODUCT_COUNTS[3:],
    *(f"{name}[{mode}]" for mode in REDUCED_MODES for name in _PRODUCT_COUNTS))
# the launches are keys of the program's one counter table
_launches = profiling.COUNTS
# The f32 (and f32_mix) window launches at D = 128, which run the
# warpgroup products of ``csrc/window_wg.cuh``: a counter of the program
# (``profiling.count``) beside their ``window_apply`` or
# ``window_apply_trailing`` count, not one of LAUNCH_COUNTS, so that no
# launch counts twice there
WG_COUNTER = "window_tc_d128"
# The f32 (and f32_mix) trailing pair launches at D2 = 128 with D1 = 64,
# 128, which run the warpgroup products of ``csrc/pair_wg.cuh``: beside
# their ``pair_apply_trailing`` count, likewise
PAIR_WG_COUNTER = "pair_tc_wg"


def reset_launch_counts() -> None:
    _launches.update(dict.fromkeys(LAUNCH_COUNTS, 0))


def launch_counts() -> dict:
    """Kernel launches since the last reset, by :data:`LAUNCH_COUNTS`."""
    return {name: _launches[name] for name in LAUNCH_COUNTS}


def _count(name: str) -> None:
    """One launch of ``name`` in the current dot mode (the f32 and f32_mix
    launches run one kernel, counted under the plain name)."""
    mode = _DOT_MODE
    _launches[name if _PREC[mode] == 0 else f"{name}[{mode}]"] += 1


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_f32(name: str, t: torch.Tensor, shape, device) -> None:
    _require(t.dtype == torch.float32, f"{name} must be float32, got "
             f"{t.dtype}")
    _require(tuple(t.shape) == tuple(shape), f"{name} must have shape "
             f"{tuple(shape)}, got {tuple(t.shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(t.device == device, f"{name} is on {t.device}, the state on "
             f"{device}")


# the kernels' particle axis lies on a grid axis of at most 65535 blocks
# (csrc/tc_tile.cuh: MAX_PARTICLES)
MAX_PARTICLES = 65535


def _particles(psi: torch.Tensor, state_dims: int) -> tuple:
    """(leading shape, particle count) of a state or a batch of states whose
    own shape has ``state_dims`` dimensions: ``()`` and 1 for one state,
    ``(P,)`` and P for a batch."""
    _require(psi.dim() in (state_dims, state_dims + 1),
             f"psi must be one state of {state_dims} dimensions or a batch "
             f"of them, got shape {tuple(psi.shape)}")
    lead = tuple(psi.shape[:psi.dim() - state_dims])
    P = lead[0] if lead else 1
    _require(1 <= P <= MAX_PARTICLES,
             f"a batch holds 1..{MAX_PARTICLES} particles, got {P}")
    return lead, P


def _dispatch(psi: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); anything else raises."""
    if psi.device.type == "cuda":
        return True
    _require(psi.device.type == "cpu",
             f"unsupported device {psi.device}: CUDA or CPU only")
    return False


# ---------------------------------------------------------------------------
# fused diagonal prefix: sign flips and controlled phases
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedDiagonals:
    """Flips and phases applied before a kernel's product, on device.

    ``flips``: (F,) int64 global flat indices whose sign is negated.
    Phase p multiplies every amplitude whose flat index m has
    ``m & mask[p] == want[p]`` by ``phase[0, p] + i·phase[1, p]``.
    """
    flips: torch.Tensor     # (F,) int64
    mask: torch.Tensor      # (P,) int64
    want: torch.Tensor      # (P,) int64
    phase: torch.Tensor     # (2, P) float32


def phase_bits(n: int, qubits, pattern: int) -> tuple[int, int]:
    """(mask, want) over global index bits for a controlled phase that
    triggers when ``qubits`` equal ``pattern`` (bit k−1−j ↔ qubits[j];
    −1 = all ones).  Qubit q is bit n−1−q of the flat index."""
    k = len(qubits)
    mask = want = 0
    for j, q in enumerate(qubits):
        bit = 1 << (n - 1 - q)
        mask |= bit
        if pattern < 0 or (pattern >> (k - 1 - j)) & 1:
            want |= bit
    return mask, want


def fused_diagonals(n: int, pre_flips=(), pre_phases=(),
                    device="cpu") -> FusedDiagonals:
    """Device tables of a step's fused flips and (qubits, z, pattern)
    phases, as :class:`qbot_tpu_torch.tpu.compiler.WindowStep` carries
    them.  A phase's float32 real part is 1 + (re - 1), rounded as the
    reference's kernels form it (``qbot_tpu/tpu/kernels.py:_apply_phases``:
    re - 1 in float64, rounded to float32, then 1 added in float32); it can
    sit an ulp from re rounded once, and a cancelling complex product
    carries that to several ulps of the amplitude, which a bf16 split
    rounds apart."""
    bits = [phase_bits(n, q, pat) for q, _, pat in pre_phases]
    z = np.array([complex(z) for _, z, _ in pre_phases], np.complex128)
    re = np.float32(1.0) + (z.real - 1.0).astype(np.float32)
    up = profiling.upload
    return FusedDiagonals(
        flips=up(np.asarray(list(pre_flips), np.int64), device),
        mask=up(np.asarray([m for m, _ in bits], np.int64), device),
        want=up(np.asarray([w for _, w in bits], np.int64), device),
        phase=up(np.stack([re, z.imag.astype(np.float32)]).reshape(2, -1),
                 device))


def _flip_signs(x: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """x (..., 2, N) with the listed flat indices negated (an index listed
    twice flips back), out of place."""
    if flips.numel() == 0:
        return x
    hits = torch.zeros(x.shape[-1], dtype=torch.int64, device=x.device)
    hits.index_add_(0, flips, torch.ones_like(flips))
    return x * (1 - 2 * (hits % 2)).to(x.dtype)


def _apply_diagonals_ref(psi: torch.Tensor, diag: FusedDiagonals):
    """ΦF psi of a (..., 2, N) state or batch, out of place."""
    x = psi
    if diag.mask.numel():
        idx = torch.arange(psi.shape[-1], dtype=torch.int64,
                           device=psi.device)
        for p in range(diag.mask.shape[0]):
            hit = (idx & diag.mask[p]) == diag.want[p]
            fr = torch.where(hit, diag.phase[0, p], 1.0)
            fi = torch.where(hit, diag.phase[1, p], 0.0)
            xr, xi = x[..., 0, :], x[..., 1, :]
            x = torch.stack([xr * fr - xi * fi, xr * fi + xi * fr], dim=-2)
    return _flip_signs(x, diag.flips)


def _check_diag(diag: FusedDiagonals, device) -> None:
    for name, t, dtype in (("flips", diag.flips, torch.int64),
                           ("mask", diag.mask, torch.int64),
                           ("want", diag.want, torch.int64)):
        _require(t.dtype == dtype and t.dim() == 1 and t.is_contiguous()
                 and t.device == device,
                 f"{name} must be a contiguous 1-D {dtype} on {device}")
    _check_f32("phase", diag.phase, (2, diag.mask.shape[0]), device)


# ---------------------------------------------------------------------------
# the products of a dot mode: qbot_tpu/tpu/kernels.py:55-71
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _mode_bmm(w, x, mode: str):
    """``w @ x[p]`` for each particle p of x (P, K, N), w (M, K), with the
    products of ``mode``, as the reference's ``_dot``: full precision (f32,
    f32_mix); both operands split as hi = bf16(x), lo = bf16(x − hi), summed
    as hi·hi + hi·lo + lo·hi (bf16_3x); both rounded to bf16, one product
    (bf16).  Products of bf16 values are exact in float32, their sums
    float32's.  One batched product whose every batch entry is the product
    of one state, so a particle's bits do not depend on how many others
    share the call."""
    if x.shape[-1] == 1:
        # a one-column product of one particle runs as a matrix-vector
        # product, of several as a batched GEMM, and the two round apart:
        # a zero second column makes both a GEMM
        return _mode_bmm(w, torch.nn.functional.pad(x, (0, 1)), mode)[..., :1]

    def bmm(a, b):
        return torch.bmm(a.expand(b.shape[0], *a.shape), b)

    if _PREC[mode] == 0:
        return bmm(w, x)
    wh, xh = _bf16(w), _bf16(x)
    if mode == "bf16":
        return bmm(wh, xh)
    wl, xl = _bf16(w - wh), _bf16(x - xh)
    return bmm(wh, xh) + bmm(wh, xl) + bmm(wl, xh)


def _complex_bmm(w, xr, xi, mode: str):
    """(re, im) of the planar complex product ``w @ x[p]`` (``_mode_bmm``)."""
    def mm(a, b):
        return _mode_bmm(a, b, mode)

    with _fp32_matmul():
        return (mm(w[0], xr) - mm(w[1], xi), mm(w[0], xi) + mm(w[1], xr))


def _resolve_mode(mode) -> str:
    if mode is None:
        return _DOT_MODE
    _require(mode in DOT_MODES, f"unknown dot mode {mode!r}")
    return mode


# ---------------------------------------------------------------------------
# window: out[a, i, b] = Σ_j W[i, j] · (Φ F p)[a, j, b]
# ---------------------------------------------------------------------------

def window_apply_ref(psi, n: int, start: int, width: int, w,
                     diag: FusedDiagonals, mode=None):
    """Plain version of :func:`window_apply`, in dot mode ``mode`` (default
    the current one)."""
    mode = _resolve_mode(mode)
    A, D = 2**start, 2**width
    P = psi.shape[0] if psi.dim() == 3 else 1
    # x[plane, p, j, (a, b)]: W contracts j of each particle's columns
    x = _apply_diagonals_ref(psi, diag).reshape(P, 2, A, D, -1)
    B = x.shape[-1]
    x = x.permute(1, 0, 3, 2, 4).reshape(2, P, D, A * B)
    out_r, out_i = _complex_bmm(w, x[0], x[1], mode)
    out = torch.stack([out_r, out_i]).reshape(2, P, D, A, B)
    return out.permute(1, 0, 3, 2, 4).contiguous().reshape(psi.shape)


def window_apply(psi, n: int, start: int, width: int, w,
                 diag: FusedDiagonals):
    """Apply a (2, D, D) planar window unitary to qubits
    [start, start + width) of a (2, 2^n) planar float32 state, or of each
    state of a (P, 2, 2^n) batch in one launch, after the fused flips and
    phases of ``diag``, with the products of the current dot mode.  Out of
    place; differentiable in ``psi`` and ``w`` (:class:`_WindowApply`)."""
    if _needs_grad(psi, w):
        return _WindowApply.apply(psi, w, n, start, width, diag)
    return _window_launch(psi, n, start, width, w, diag)


def _window_launch(psi, n: int, start: int, width: int, w,
                   diag: FusedDiagonals):
    _require(1 <= width <= 7 and 0 <= start and start + width <= n,
             f"window [{start}, {start + width}) does not fit 1..7 qubits "
             f"of a {n}-qubit register")
    D = 2**width
    lead, P = _particles(psi, 2)
    _check_f32("psi", psi, (*lead, 2, 2**n), psi.device)
    _check_f32("w", w, (2, D, D), psi.device)
    _check_diag(diag, psi.device)
    if not _dispatch(psi):
        return window_apply_ref(psi, n, start, width, w, diag)
    _require(psi.data_ptr() % 16 == 0, "psi must be 16-byte aligned")
    lib = _library()
    out = torch.empty_like(psi)
    # the f32 window at D = 128 splits W once into a scratch of its parts
    wg = width == 7 and _PREC[_DOT_MODE] == 0
    scratch = (torch.empty(lib.qbot_window_scratch_floats(),
                           dtype=torch.float32, device=psi.device)
               if wg else None)
    with torch.cuda.device(psi.device):
        rc = lib.qbot_window_apply(
            psi.data_ptr(), out.data_ptr(), w.data_ptr(), 2**n, P, width,
            n - start - width, diag.flips.data_ptr(), diag.flips.numel(),
            diag.mask.data_ptr(), diag.want.data_ptr(),
            diag.phase.data_ptr(), diag.mask.numel(), _PREC[_DOT_MODE],
            None if scratch is None else scratch.data_ptr(), _stream(psi))
    _check_launch(lib, rc, "window_apply")
    _count(_COUNTER[launch_family(n, start, width), start + width == n])
    if wg:
        profiling.count(WG_COUNTER)
    return out


# ---------------------------------------------------------------------------
# pair: out[a, i, l, b] = Σ_{j,m} W1[i, j]·W2[l, m]·(Φ F p)[a, j, m, b]
# ---------------------------------------------------------------------------

def pair_apply_ref(psi, n: int, start: int, width1: int, width2: int, w1, w2,
                   diag: FusedDiagonals, mode=None):
    """Plain version of :func:`pair_apply`, for every geometry, in dot mode
    ``mode`` (default the current one).  W1 goes first, Y = W1·(ΦF X), as
    in the reference (``qbot_tpu/tpu/kernels.py:341-348, 407-416``) and the
    kernels; the second product splits the float32 intermediate Y anew."""
    mode = _resolve_mode(mode)
    A, D1, D2 = 2**start, 2**width1, 2**width2
    P = psi.shape[0] if psi.dim() == 3 else 1
    x = _apply_diagonals_ref(psi, diag).reshape(P, 2, A, D1, D2, -1)
    B = x.shape[-1]
    # Y[p, i, (a, m, b)] = Σ_j W1[i, j]·X[p, a, j, m, b]
    x = x.permute(1, 0, 3, 2, 4, 5).reshape(2, P, D1, A * D2 * B)
    yr, yi = _complex_bmm(w1, x[0], x[1], mode)
    # out[p, l, (a, i, b)] = Σ_m W2[l, m]·Y[p, a, i, m, b]
    y = torch.stack([yr, yi]).reshape(2, P, D1, A, D2, B)
    y = y.permute(0, 1, 4, 3, 2, 5).reshape(2, P, D2, A * D1 * B)
    out_r, out_i = _complex_bmm(w2, y[0], y[1], mode)
    out = torch.stack([out_r, out_i]).reshape(2, P, D2, A, D1, B)
    return out.permute(1, 0, 3, 4, 2, 5).contiguous().reshape(psi.shape)


def pair_route(n: int, start: int, width1: int, width2: int) -> str:
    """How :func:`pair_apply` runs a pair on a CUDA tensor: ``"trailing"``
    (B = 1), ``"middle"`` (B >= 128 and D1 <= 32) or ``"two_windows"``, as
    ``qbot_tpu``'s ``_pair_apply_impl`` (``qbot_tpu/tpu/kernels.py:652-706``)
    routes it, but for one geometry: D1 >= 8 with D2 <= 4 runs as two
    windows in either orientation, where the reference runs its pair
    kernel.  On the H100 the two window launches beat a one-pass pair of
    FP32 FMAs from shared-memory slabs there by 4.0-8.6x in the middle
    (1, 32, 4, 2^19) and 4.5-11.8x trailing (2^17, 128, 4, 1), in every
    dot mode (PERF.md, section 6)."""
    if width1 > _STREAM_MAX_WIDTH and width2 <= _STREAM_MAX_WIDTH:
        return "two_windows"
    B = 2 ** (n - start - width1 - width2)
    if B == 1:
        return "trailing"
    if B >= 128 and width1 <= _MIDDLE_MAX_WIDTH:
        return "middle"
    return "two_windows"


def launch_family(n: int, start: int, *widths: int) -> str:
    """The kernel that runs a window (one width) or a pair (two widths, W1
    first) at ``start`` of an ``n``-qubit state on a CUDA tensor, by the
    cost family the compiler prices it under (``compiler.COSTS``): a
    window's streaming FMA kernel (``window_stream``, D <= 4) or tensor-core
    tile (``window_tc``); a pair's streaming kernel (``pair_stream``, D1,
    D2 <= 4), narrow pair (``pair_narrow``, D1 <= 4 with D2 >= 8) or
    tensor-core pair (``pair_tc_middle``, ``pair_tc_trailing``); or
    ``two_windows``, a pair that runs as two window launches
    (:func:`pair_route`)."""
    if len(widths) == 1:
        return ("window_stream" if widths[0] <= _STREAM_MAX_WIDTH
                else "window_tc")
    width1, width2 = widths
    route = pair_route(n, start, width1, width2)
    if route == "two_windows":
        return route
    if width1 <= _STREAM_MAX_WIDTH:
        return "pair_stream" if width2 <= _STREAM_MAX_WIDTH else "pair_narrow"
    return f"pair_tc_{route}"


# (launch family, trailing) -> the launch counter (LAUNCH_COUNTS)
_COUNTER = {("window_stream", False): "window_apply_stream",
            ("window_stream", True): "window_apply_stream",
            ("window_tc", False): "window_apply",
            ("window_tc", True): "window_apply_trailing",
            ("pair_stream", False): "pair_apply_stream",
            ("pair_stream", True): "pair_apply_stream",
            ("pair_narrow", False): "pair_apply_narrow",
            ("pair_narrow", True): "pair_apply_trailing_narrow",
            ("pair_tc_middle", False): "pair_apply",
            ("pair_tc_trailing", True): "pair_apply_trailing"}


def pair_apply(psi, n: int, start: int, width1: int, width2: int, w1, w2,
               diag: FusedDiagonals):
    """Apply (2, D1, D1) and (2, D2, D2) planar window unitaries to the
    adjacent windows [start, start + width1) and [start + width1,
    start + width1 + width2) of a (2, 2^n) planar float32 state, or of each
    state of a (P, 2, 2^n) batch in one launch, in one pass, after the
    fused flips and phases of ``diag``, with the products of the current
    dot mode.  Out of place; differentiable in ``psi``, ``w1`` and ``w2``
    (:class:`_PairApply`).  :func:`_pair_launch` says how it runs."""
    if _needs_grad(psi, w1, w2):
        return _PairApply.apply(psi, w1, w2, n, start, width1, width2, diag)
    return _pair_launch(psi, n, start, width1, width2, w1, w2, diag)


def _pair_launch(psi, n: int, start: int, width1: int, width2: int, w1, w2,
                 diag: FusedDiagonals):
    """The launch of :func:`pair_apply`.  On a CUDA tensor,
    :func:`launch_family` picks the kernel, or two :func:`window_apply`
    launches with the diagonals fused into the first (counted as window
    launches).  The trailing and middle pairs at D1, D2 >= 8 run on the
    tensor cores (3xTF32, ``csrc/pair_tc.cuh``, the trailing pairs at
    D2 = 128 with D1 = 64, 128 on the warpgroup products of
    ``csrc/pair_wg.cuh``; in the reduced modes BF16
    ``mma.sync.m16n8k16``, ``csrc/pair_bf16.cuh``); the narrow pairs,
    D1 = 2, 4 with D2 >= 8, on the D2 window's tile with W1 mixed into its
    operand as it is staged (``csrc/window_tc.cuh``,
    ``csrc/window_bf16.cuh``; counted as ``pair_apply_narrow`` and
    ``pair_apply_trailing_narrow``); D1, D2 = 2, 4 on a streaming kernel of
    FP32 FMAs (``csrc/pair_stream.cu``, counted as ``pair_apply_stream``).
    D1 >= 8 with D2 = 2, 4 runs as two windows: explicit
    ``partition="dot"`` plans on the kernel engine produce it (the
    brickwork's at 17 qubits and more, widths 3-5).  All apply W1 first, as
    the plain version does.
    """
    _require(1 <= width1 <= 7 and 1 <= width2 <= 7 and 0 <= start
             and start + width1 + width2 <= n,
             f"windows [{start}, {start + width1}) and [{start + width1}, "
             f"{start + width1 + width2}) do not fit 1..7 qubits each of a "
             f"{n}-qubit register")
    D1, D2 = 2**width1, 2**width2
    lead, P = _particles(psi, 2)
    _check_f32("psi", psi, (*lead, 2, 2**n), psi.device)
    _check_f32("w1", w1, (2, D1, D1), psi.device)
    _check_f32("w2", w2, (2, D2, D2), psi.device)
    _check_diag(diag, psi.device)
    if not _dispatch(psi):
        return pair_apply_ref(psi, n, start, width1, width2, w1, w2, diag)
    family = launch_family(n, start, width1, width2)
    if family == "two_windows":
        psi = _window_launch(psi, n, start, width1, w1, diag)
        return _window_launch(psi, n, start + width1, width2, w2,
                              _no_diagonals(n, psi.device))
    _require(psi.data_ptr() % 16 == 0 and w2.data_ptr() % 16 == 0,
             "psi and w2 must be 16-byte aligned")
    lib = _library()
    out = torch.empty_like(psi)
    # the f32 trailing pair at D2 = 128, D1 = 64, 128 splits W1 and W2 once
    # into a scratch of their parts
    wg = (family == "pair_tc_trailing" and width2 == 7 and width1 >= 6
          and _PREC[_DOT_MODE] == 0)
    scratch = (torch.empty(lib.qbot_pair_scratch_floats(width1),
                           dtype=torch.float32, device=psi.device)
               if wg else None)
    with torch.cuda.device(psi.device):
        rc = lib.qbot_pair_apply(
            psi.data_ptr(), out.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            2**n, P, width1, width2, n - start - width1 - width2,
            diag.flips.data_ptr(), diag.flips.numel(), diag.mask.data_ptr(),
            diag.want.data_ptr(), diag.phase.data_ptr(), diag.mask.numel(),
            _PREC[_DOT_MODE], None if scratch is None else scratch.data_ptr(),
            _stream(psi))
    _check_launch(lib, rc, "pair_apply")
    _count(_COUNTER[family, start + width1 + width2 == n])
    if wg:
        profiling.count(PAIR_WG_COUNTER)
    return out


# ---------------------------------------------------------------------------
# the backward of the window and the pair: qbot_tpu/tpu/kernels.py:806-912
# ---------------------------------------------------------------------------

def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _adjoint(w: torch.Tensor) -> torch.Tensor:
    """W† of a planar (2, D, D) matrix, contiguous: (Wr.T, −Wi.T)."""
    return torch.stack([w[0].t(), -w[1].t()]).contiguous()


def _conj_diagonals(diag: FusedDiagonals) -> FusedDiagonals:
    """(ΦF)† = F Φ*: the flips as they are, each phase's imaginary part
    negated."""
    return FusedDiagonals(diag.flips, diag.mask, diag.want,
                          torch.stack([diag.phase[0], -diag.phase[1]]))


@functools.lru_cache(maxsize=None)
def _no_diagonals(n: int, device: torch.device) -> FusedDiagonals:
    """Empty diagonals of an n-qubit launch, made once per device (the W†
    launch of a backward and a pair's second window carry none)."""
    return fused_diagonals(n, device=device)


def _planes_by(x: torch.Tensor, split, axis: int) -> torch.Tensor:
    """(2D, K) view of a (…, 2, N) state or batch: its flat index split as
    ``split`` (the (…, 2) axes first), the rows the planes × axis
    ``axis`` of the split, the columns every other index."""
    lead = x.dim() - 1
    x = x.reshape(*x.shape[:lead], *split)
    plane, ax = lead - 1, lead + axis
    rest = [d for d in range(x.dim()) if d not in (plane, ax)]
    x = x.permute(plane, ax, *rest)
    return x.reshape(2 * split[axis], -1)


def _matrix_cotangent(g, z, split, axis: int) -> torch.Tensor:
    """W̄ (2, D, D) of out = W·z on axis ``axis`` of the flat split:
    W̄r = gr·zrᵀ + gi·ziᵀ, W̄i = gi·zrᵀ − gr·ziᵀ, summed over every other
    index and the particle axis, as one float32 product of the stacked
    planes (TF32 off)."""
    D = split[axis]
    with _fp32_matmul():
        m = _planes_by(g, split, axis) @ _planes_by(z, split, axis).t()
    m = m.reshape(2, D, 2, D)
    return torch.stack([m[0, :, 0] + m[1, :, 1], m[1, :, 0] - m[0, :, 1]])


class _WindowApply(torch.autograd.Function):
    """out = W·ΦFψ and its adjoint (``_window_apply_bwd``,
    ``qbot_tpu/tpu/kernels.py:818-845``): ψ̄ = FΦ*·(W†ḡ), W†ḡ through
    :func:`window_apply` itself with empty diagonals; W̄ against
    y = ΦFψ, recomputed."""

    @staticmethod
    def forward(ctx, psi, w, n, start, width, diag):
        ctx.save_for_backward(psi, w)
        ctx.geometry = (n, start, width, diag)
        return _window_launch(psi, n, start, width, w, diag)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        psi, w = ctx.saved_tensors
        n, start, width, diag = ctx.geometry
        g = g.contiguous()
        d_psi = d_w = None
        if ctx.needs_input_grad[0]:
            gw = _window_launch(g, n, start, width, _adjoint(w),
                                _no_diagonals(n, g.device))
            d_psi = _apply_diagonals_ref(gw, _conj_diagonals(diag))
        if ctx.needs_input_grad[1]:
            split = (2**start, 2**width, -1)
            y = _apply_diagonals_ref(psi, diag)
            d_w = _matrix_cotangent(g, y, split, 1)
        return d_psi, d_w, None, None, None, None


class _PairApply(torch.autograd.Function):
    """out = (W1 ⊗ W2)·ΦFψ and its adjoint (``_pair_apply_bwd``,
    ``qbot_tpu/tpu/kernels.py:865-912``): ψ̄ = FΦ*·(W1† ⊗ W2†)ḡ through
    :func:`pair_apply` itself (the same route), W̄1 against Z = W2·y and
    W̄2 against V = W1·y, y = ΦFψ recomputed."""

    @staticmethod
    def forward(ctx, psi, w1, w2, n, start, width1, width2, diag):
        ctx.save_for_backward(psi, w1, w2)
        ctx.geometry = (n, start, width1, width2, diag)
        return _pair_launch(psi, n, start, width1, width2, w1, w2, diag)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        psi, w1, w2 = ctx.saved_tensors
        n, start, width1, width2, diag = ctx.geometry
        g = g.contiguous()
        d_psi = d_w1 = d_w2 = None
        if ctx.needs_input_grad[0]:
            gw = _pair_launch(g, n, start, width1, width2, _adjoint(w1),
                              _adjoint(w2), _no_diagonals(n, g.device))
            d_psi = _apply_diagonals_ref(gw, _conj_diagonals(diag))
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            split = (2**start, 2**width1, 2**width2, -1)
            y = _apply_diagonals_ref(psi, diag)
            none = _no_diagonals(n, y.device)
            if ctx.needs_input_grad[1]:
                z = window_apply_ref(y, n, start + width1, width2, w2, none,
                                     mode="f32")
                d_w1 = _matrix_cotangent(g, z, split, 1)
            if ctx.needs_input_grad[2]:
                v = window_apply_ref(y, n, start, width1, w1, none,
                                     mode="f32")
                d_w2 = _matrix_cotangent(g, v, split, 2)
        return d_psi, d_w1, d_w2, None, None, None, None, None


# ---------------------------------------------------------------------------
# reflection: |v⟩ = A ⊗ B; D[t] = Σ_h conj(A_h)·ψ[h, t]
# ---------------------------------------------------------------------------

_REFLECT_THREADS = 256       # csrc/reflect.cu THREADS
_REFLECT_MAX_CHUNKS = 1024   # row chunks: enough blocks to fill the card


def _reflect_chunks(H: int, T: int) -> tuple[int, int]:
    """(rows per block, number of row chunks) of the reflection kernels."""
    ry = _REFLECT_THREADS // min(T, _REFLECT_THREADS)
    rows = max(ry, -(-H // _REFLECT_MAX_CHUNKS))
    rows = -(-rows // ry) * ry
    return rows, -(-H // rows)


def _check_reflect(psi, a, b):
    """(leading shape, particles, H, T) of a (2, H, T) view or a (P, 2, H,
    T) batch of them."""
    lead, P = _particles(psi, 3)
    _require(psi.shape[-3] == 2,
             f"psi must be a (2, H, T) view or a batch of them, got "
             f"{tuple(psi.shape)}")
    H, T = psi.shape[-2:]
    _check_f32("psi", psi, (*lead, 2, H, T), psi.device)
    _check_f32("a", a, (2, H, 1), psi.device)
    _check_f32("b", b, (2, 1, T), psi.device)
    return lead, P, H, T


def reflect_dot_ref(psi, a, b):
    """Plain version of :func:`reflect_dot`."""
    pr, pi = psi[..., 0, :, :].double(), psi[..., 1, :, :].double()
    ar, ai = a[0].double(), a[1].double()
    dr = torch.sum(ar * pr + ai * pi, dim=-2, keepdim=True)
    di = torch.sum(ar * pi - ai * pr, dim=-2, keepdim=True)
    return torch.stack([dr, di], dim=-3)


def reflect_dot(psi, a, b):
    """Per-lane dot D[t] = Σ_h conj(A_h)·ψ[h, t] of a (2, H, T) planar
    view, or of each view of a (P, 2, H, T) batch in one launch, in one
    read pass.  ⟨v|ψ⟩ = Σ_t conj(B_t)·D[t].

    D is a (2, 1, T) float64 tensor (a batch: (P, 2, 1, T)), its products
    and sums taken in float64: float32 roundings in ⟨v|ψ⟩ are biased on a
    state of nearly equal amplitudes and drift a Grover loop's norm.
    """
    lead, P, H, T = _check_reflect(psi, a, b)
    if not _dispatch(psi):
        return reflect_dot_ref(psi, a, b)
    lib = _library()
    rows, chunks = _reflect_chunks(H, T)
    partial = torch.empty((P, 2, T, chunks), dtype=torch.float64,
                          device=psi.device)
    d = torch.empty((*lead, 2, 1, T), dtype=torch.float64, device=psi.device)
    with torch.cuda.device(psi.device):
        rc = lib.qbot_reflect_dot(psi.data_ptr(), a.data_ptr(), H, T, rows,
                                  chunks, P, partial.data_ptr(),
                                  d.data_ptr(), _stream(psi))
    _check_launch(lib, rc, "reflect_dot")
    _launches["reflect_dot"] += 1
    return d


def reflect_update_ref(psi, c, a, b, flips):
    """Plain version of :func:`reflect_update`."""
    lead = tuple(psi.shape[:-3])
    x = _flip_signs(psi.reshape(*lead, 2, -1), flips).reshape(psi.shape)
    cr, ci = c[..., 0, None, None], c[..., 1, None, None]
    qr = cr * b[0] - ci * b[1]
    qi = cr * b[1] + ci * b[0]
    out = torch.stack([x[..., 0, :, :] - 2.0 * (a[0] * qr - a[1] * qi),
                       x[..., 1, :, :] - 2.0 * (a[0] * qi + a[1] * qr)],
                      dim=-3)
    return out, reflect_dot_ref(out, a, b)


def reflect_update(psi, c, a, b, flips):
    """One-pass reflection update out = Fψ − 2c·(A⊗B) of a (2, H, T)
    planar view, or of each view of a (P, 2, H, T) batch in one launch,
    plus the float64 per-lane dot D of ``out`` (for chaining; see
    :func:`reflect_dot`).

    ``c``: (2,) float32 device tensor holding ⟨v|Fψ⟩ (a batch: (P, 2), one
    c a particle); ``flips``: (F,) int64 flat indices sign-flipped before
    the update.  Out of place.
    """
    lead, P, H, T = _check_reflect(psi, a, b)
    _check_f32("c", c, (*lead, 2), psi.device)
    _require(flips.dtype == torch.int64 and flips.dim() == 1
             and flips.device == psi.device and flips.is_contiguous(),
             f"flips must be a contiguous 1-D int64 on {psi.device}")
    if not _dispatch(psi):
        return reflect_update_ref(psi, c, a, b, flips)
    lib = _library()
    rows, chunks = _reflect_chunks(H, T)
    out = torch.empty_like(psi)
    partial = torch.empty((P, 2, T, chunks), dtype=torch.float64,
                          device=psi.device)
    d = torch.empty((*lead, 2, 1, T), dtype=torch.float64, device=psi.device)
    with torch.cuda.device(psi.device):
        rc = lib.qbot_reflect_update(
            psi.data_ptr(), out.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), flips.data_ptr(), flips.numel(), H, T, rows,
            chunks, P, partial.data_ptr(), d.data_ptr(), _stream(psi))
    _check_launch(lib, rc, "reflect_update")
    _launches["reflect_update"] += 1
    return out, d


reset_launch_counts()
