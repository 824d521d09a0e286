"""Hand-written CUDA kernels of the planar statevector path, and their plain
PyTorch versions.

Port of :mod:`qbot_tpu.tpu.kernels` (the forward window, pair and
reflection kernels).  Each wrapper dispatches on the device of the state it
is given: a CPU tensor goes through the plain PyTorch version beside it, a
CUDA tensor launches the kernel from ``qbot_tpu_torch/csrc/`` or raises.
There is no fallback and no mode switch.

The kernels are CUDA C++ for ``sm_90a`` with a plain C interface, compiled
by ``nvcc`` at first use (one process per source, all at once, then one
link) into ``qbot_tpu_torch/_build/<hash of the sources>/`` and loaded with
:mod:`ctypes`.  They launch on PyTorch's current stream, never synchronise,
and allocate nothing: the wrappers allocate outputs and scratch with
``torch.empty``.

Every wrapper counts its launches in an integer attribute (``launches``)
so a run can show that it went through the kernel.  ``window_apply`` and
``pair_apply`` count their trailing launches (B = 1, the role of the TPU's
``_right_multiply`` and ``_pair_b1``) apart, in ``trailing_launches``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

__all__ = ["FusedDiagonals", "fused_diagonals", "phase_bits",
           "window_apply", "window_apply_ref",
           "pair_apply", "pair_apply_ref", "pair_route",
           "reflect_dot", "reflect_dot_ref",
           "reflect_update", "reflect_update_ref",
           "build_kernels", "reset_launch_counts", "launch_counts"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]

_lib = None


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


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` into one shared library (once per source hash)
    and return its path.  The sources compile in parallel, one nvcc each.
    A failed build raises with nvcc's stderr."""
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = _BUILD / h.hexdigest()[:16]
    lib_path = out_dir / "libqbot_tpu_torch.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent builders never
    # load a half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        _run_nvcc([[_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                   for src, obj in zip(sources, objs)])
        lib_tmp = Path(tmp) / lib_path.name
        _run_nvcc([[_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(lib_tmp),
                    *map(str, objs)]])
        os.replace(lib_tmp, lib_path)
    return lib_path


def _run_nvcc(cmds) -> None:
    """Run the nvcc commands at once; raise with the stderr of the first
    that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError(errors[0])


def _library():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_kernels()))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.qbot_window_apply.argtypes = [p, p, p, i64, i32, i32, p, i32,
                                      p, p, p, i32, p]
    lib.qbot_window_apply.restype = i32
    lib.qbot_pair_apply.argtypes = [p, p, p, p, i64, i32, i32, i32,
                                    p, i32, p, p, p, i32, p]
    lib.qbot_pair_apply.restype = i32
    lib.qbot_reflect_dot.argtypes = [p, p, i64, i64, i64, i32, p, p, p]
    lib.qbot_reflect_dot.restype = i32
    lib.qbot_reflect_update.argtypes = [p, p, p, p, p, p, i32, i64, i64,
                                        i64, i32, p, p, p]
    lib.qbot_reflect_update.restype = i32
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


def reset_launch_counts() -> None:
    for fn in (window_apply, pair_apply, reflect_dot, reflect_update):
        fn.launches = 0
    window_apply.trailing_launches = 0
    pair_apply.trailing_launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset, one count per TPU kernel
    replaced: window_apply and pair_apply with B > 1 and with B = 1 count
    apart."""
    return {"window_apply": window_apply.launches,
            "window_apply_trailing": window_apply.trailing_launches,
            "reflect_dot": reflect_dot.launches,
            "reflect_update": reflect_update.launches,
            "pair_apply": pair_apply.launches,
            "pair_apply_trailing": pair_apply.trailing_launches}


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
    phases, as :class:`qbot_tpu.tpu.compiler.WindowStep` carries them."""
    bits = [phase_bits(n, q, pat) for q, _, pat in pre_phases]
    z = np.array([complex(z) for _, z, _ in pre_phases], np.complex128)
    return FusedDiagonals(
        flips=torch.tensor(list(pre_flips), dtype=torch.int64,
                           device=device),
        mask=torch.tensor([m for m, _ in bits], dtype=torch.int64,
                          device=device),
        want=torch.tensor([w for _, w in bits], dtype=torch.int64,
                          device=device),
        phase=torch.tensor(np.stack([z.real, z.imag]).reshape(2, -1),
                           dtype=torch.float32, device=device))


def _flip_signs(x: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """x (2, N) with the listed flat indices negated (an index listed twice
    flips back), out of place."""
    if flips.numel() == 0:
        return x
    hits = torch.zeros(x.shape[1], dtype=torch.int64, device=x.device)
    hits.index_add_(0, flips, torch.ones_like(flips))
    return x * (1 - 2 * (hits % 2)).to(x.dtype)


def _apply_diagonals_ref(psi: torch.Tensor, diag: FusedDiagonals):
    x = psi
    if diag.mask.numel():
        idx = torch.arange(psi.shape[1], dtype=torch.int64,
                           device=psi.device)
        for p in range(diag.mask.shape[0]):
            hit = (idx & diag.mask[p]) == diag.want[p]
            fr = torch.where(hit, diag.phase[0, p], 1.0)
            fi = torch.where(hit, diag.phase[1, p], 0.0)
            x = torch.stack([x[0] * fr - x[1] * fi, x[0] * fi + x[1] * fr])
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
# window: out[a, i, b] = Σ_j W[i, j] · (Φ F p)[a, j, b]
# ---------------------------------------------------------------------------

def window_apply_ref(psi, n: int, start: int, width: int, w,
                     diag: FusedDiagonals):
    """Plain version of :func:`window_apply`."""
    A, D = 2**start, 2**width
    x = _apply_diagonals_ref(psi, diag).reshape(2, A, D, -1)
    with _fp32_matmul():
        def mm(W, p):
            return torch.einsum("ij,ajb->aib", W, p)

        out_r = mm(w[0], x[0]) - mm(w[1], x[1])
        out_i = mm(w[0], x[1]) + mm(w[1], x[0])
    return torch.stack([out_r, out_i]).reshape(psi.shape)


def window_apply(psi, n: int, start: int, width: int, w,
                 diag: FusedDiagonals):
    """Apply a (2, D, D) planar window unitary to qubits
    [start, start + width) of a (2, 2^n) planar float32 state, after the
    fused flips and phases of ``diag``.  Out of place."""
    _require(1 <= width <= 7 and 0 <= start and start + width <= n,
             f"window [{start}, {start + width}) does not fit 1..7 qubits "
             f"of a {n}-qubit register")
    D = 2**width
    _check_f32("psi", psi, (2, 2**n), psi.device)
    _check_f32("w", w, (2, D, D), psi.device)
    _check_diag(diag, psi.device)
    if not _dispatch(psi):
        return window_apply_ref(psi, n, start, width, w, diag)
    lib = _library()
    out = torch.empty_like(psi)
    with torch.cuda.device(psi.device):
        rc = lib.qbot_window_apply(
            psi.data_ptr(), out.data_ptr(), w.data_ptr(), 2**n, width,
            n - start - width, diag.flips.data_ptr(), diag.flips.numel(),
            diag.mask.data_ptr(), diag.want.data_ptr(),
            diag.phase.data_ptr(), diag.mask.numel(), _stream(psi))
    _check_launch(lib, rc, "window_apply")
    if start + width == n:
        window_apply.trailing_launches += 1
    else:
        window_apply.launches += 1
    return out


# ---------------------------------------------------------------------------
# pair: out[a, i, l, b] = Σ_{j,m} W1[i, j]·W2[l, m]·(Φ F p)[a, j, m, b]
# ---------------------------------------------------------------------------

def pair_apply_ref(psi, n: int, start: int, width1: int, width2: int, w1, w2,
                   diag: FusedDiagonals):
    """Plain version of :func:`pair_apply`, for every geometry."""
    A, D1, D2 = 2**start, 2**width1, 2**width2
    x = _apply_diagonals_ref(psi, diag).reshape(2, A, D1, D2, -1)
    with _fp32_matmul():
        def cmm(spec, w, xr, xi):
            def mm(a, b):
                return torch.einsum(spec, a, b)

            return (mm(w[0], xr) - mm(w[1], xi), mm(w[0], xi) + mm(w[1], xr))

        yr, yi = cmm("ij,ajmb->aimb", w1, x[0], x[1])
        out_r, out_i = cmm("lm,aimb->ailb", w2, yr, yi)
    return torch.stack([out_r, out_i]).reshape(psi.shape)


def pair_route(n: int, start: int, width1: int, width2: int) -> str:
    """How :func:`pair_apply` runs a pair on a CUDA tensor, as ``qbot_tpu``'s
    ``_pair_apply_impl`` (``qbot_tpu/tpu/kernels.py:652-706``) does:
    ``"trailing"`` (B = 1), ``"middle"`` (B >= 128 and D1 <= 32) or
    ``"two_windows"``."""
    B = 2 ** (n - start - width1 - width2)
    if B == 1:
        return "trailing"
    if B >= 128 and width1 <= 5:
        return "middle"
    return "two_windows"


def pair_apply(psi, n: int, start: int, width1: int, width2: int, w1, w2,
               diag: FusedDiagonals):
    """Apply (2, D1, D1) and (2, D2, D2) planar window unitaries to the
    adjacent windows [start, start + width1) and [start + width1,
    start + width1 + width2) of a (2, 2^n) planar float32 state, in one
    pass, after the fused flips and phases of ``diag``.  Out of place.

    On a CUDA tensor, :func:`pair_route` picks the trailing or the middle
    pair kernel, or two :func:`window_apply` launches with the diagonals
    fused into the first (counted as window launches).
    """
    _require(1 <= width1 <= 7 and 1 <= width2 <= 7 and 0 <= start
             and start + width1 + width2 <= n,
             f"windows [{start}, {start + width1}) and [{start + width1}, "
             f"{start + width1 + width2}) do not fit 1..7 qubits each of a "
             f"{n}-qubit register")
    D1, D2 = 2**width1, 2**width2
    _check_f32("psi", psi, (2, 2**n), psi.device)
    _check_f32("w1", w1, (2, D1, D1), psi.device)
    _check_f32("w2", w2, (2, D2, D2), psi.device)
    _check_diag(diag, psi.device)
    if not _dispatch(psi):
        return pair_apply_ref(psi, n, start, width1, width2, w1, w2, diag)
    route = pair_route(n, start, width1, width2)
    if route == "two_windows":
        psi = window_apply(psi, n, start, width1, w1, diag)
        return window_apply(psi, n, start + width1, width2, w2,
                            fused_diagonals(n, device=psi.device))
    lib = _library()
    out = torch.empty_like(psi)
    with torch.cuda.device(psi.device):
        rc = lib.qbot_pair_apply(
            psi.data_ptr(), out.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            2**n, width1, width2, n - start - width1 - width2,
            diag.flips.data_ptr(), diag.flips.numel(), diag.mask.data_ptr(),
            diag.want.data_ptr(), diag.phase.data_ptr(), diag.mask.numel(),
            _stream(psi))
    _check_launch(lib, rc, "pair_apply")
    if route == "trailing":
        pair_apply.trailing_launches += 1
    else:
        pair_apply.launches += 1
    return out


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
    _require(psi.dim() == 3 and psi.shape[0] == 2,
             f"psi must be a (2, H, T) view, got {tuple(psi.shape)}")
    _, H, T = psi.shape
    _check_f32("psi", psi, (2, H, T), psi.device)
    _check_f32("a", a, (2, H, 1), psi.device)
    _check_f32("b", b, (2, 1, T), psi.device)
    return H, T


def reflect_dot_ref(psi, a, b):
    """Plain version of :func:`reflect_dot`."""
    pr, pi = psi[0].double(), psi[1].double()
    ar, ai = a[0].double(), a[1].double()
    dr = torch.sum(ar * pr + ai * pi, dim=0, keepdim=True)
    di = torch.sum(ar * pi - ai * pr, dim=0, keepdim=True)
    return torch.stack([dr, di])


def reflect_dot(psi, a, b):
    """Per-lane dot D[t] = Σ_h conj(A_h)·ψ[h, t] of a (2, H, T) planar
    view, in one read pass.  ⟨v|ψ⟩ = Σ_t conj(B_t)·D[t].

    D is a (2, 1, T) float64 tensor, its products and sums taken in
    float64: float32 roundings in ⟨v|ψ⟩ are biased on a state of nearly
    equal amplitudes and drift a Grover loop's norm.
    """
    H, T = _check_reflect(psi, a, b)
    if not _dispatch(psi):
        return reflect_dot_ref(psi, a, b)
    lib = _library()
    rows, chunks = _reflect_chunks(H, T)
    partial = torch.empty((2, T, chunks), dtype=torch.float64,
                          device=psi.device)
    d = torch.empty((2, 1, T), dtype=torch.float64, device=psi.device)
    with torch.cuda.device(psi.device):
        rc = lib.qbot_reflect_dot(psi.data_ptr(), a.data_ptr(), H, T, rows,
                                  chunks, partial.data_ptr(), d.data_ptr(),
                                  _stream(psi))
    _check_launch(lib, rc, "reflect_dot")
    reflect_dot.launches += 1
    return d


def reflect_update_ref(psi, c, a, b, flips):
    """Plain version of :func:`reflect_update`."""
    x = _flip_signs(psi.reshape(2, -1), flips).reshape(psi.shape)
    qr = c[0] * b[0] - c[1] * b[1]
    qi = c[0] * b[1] + c[1] * b[0]
    out = torch.stack([x[0] - 2.0 * (a[0] * qr - a[1] * qi),
                       x[1] - 2.0 * (a[0] * qi + a[1] * qr)])
    return out, reflect_dot_ref(out, a, b)


def reflect_update(psi, c, a, b, flips):
    """One-pass reflection update out = Fψ − 2c·(A⊗B) of a (2, H, T)
    planar view, plus the float64 per-lane dot D of ``out`` (for
    chaining; see :func:`reflect_dot`).

    ``c``: (2,) float32 device tensor holding ⟨v|Fψ⟩; ``flips``: (F,)
    int64 flat indices sign-flipped before the update.  Out of place.
    """
    H, T = _check_reflect(psi, a, b)
    _check_f32("c", c, (2,), psi.device)
    _require(flips.dtype == torch.int64 and flips.dim() == 1
             and flips.device == psi.device and flips.is_contiguous(),
             f"flips must be a contiguous 1-D int64 on {psi.device}")
    if not _dispatch(psi):
        return reflect_update_ref(psi, c, a, b, flips)
    lib = _library()
    rows, chunks = _reflect_chunks(H, T)
    out = torch.empty_like(psi)
    partial = torch.empty((2, T, chunks), dtype=torch.float64,
                          device=psi.device)
    d = torch.empty((2, 1, T), dtype=torch.float64, device=psi.device)
    with torch.cuda.device(psi.device):
        rc = lib.qbot_reflect_update(
            psi.data_ptr(), out.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), flips.data_ptr(), flips.numel(), H, T, rows,
            chunks, partial.data_ptr(), d.data_ptr(), _stream(psi))
    _check_launch(lib, rc, "reflect_update")
    reflect_update.launches += 1
    return out, d


reset_launch_counts()
