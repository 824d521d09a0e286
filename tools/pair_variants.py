#!/usr/bin/env python3
"""Builds and times variants of the reduced pair kernel
(``qbot_tpu_torch/csrc/pair_bf16.cuh``) on one card, at the 26-qubit pair
shapes of ``chip_smoke.py``'s phase 2 (trailing (128, 128), the density
run's (64, 128), middle (32, 128)), in both reduced modes.

    python3 tools/pair_variants.py [VARIANT ...]

A variant is this tree's kernel with the text substitutions of
``VARIANTS`` applied to a copy of ``csrc/``: the walker shapes the kernel
chooses between, and diagnostics that take the products out (what is left
is the copies, the conversion, the barriers and the stores).  Each builds
with nvcc into ``qbot_tpu_torch/_build/variants/<name>/`` (all at once),
then each shape and mode is timed as the mean of 20 launches after a
warm-up, with CUDA events, with the three flips and three phases of
``tools/pair_ab.py``; the kernel as it is (``as_is``) is also held to
``pair_apply_ref``.  Prints one line a variant, shape and mode, then the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "qbot_tpu_torch" / "csrc"
OUT = ROOT / "qbot_tpu_torch" / "_build" / "variants"
N = 26
# label -> (start, width1, width2), as in chip_smoke.py check_pair
SHAPES = {"trailing": (N - 14, 7, 7), "density_columns": (N - 13, 6, 7),
          "middle": (0, 5, 7)}
_WIDE = ("  static constexpr bool WIDE = MIDDLE || "
         "(PREC == BF16 && D1 == 128);",
         "  static constexpr int IN_MAX = PREC == BF16 ? 128 : 64;")
_PHASE1 = "      for (int mcc = 0; mcc < T::NMC; ++mcc) {"
_PHASE2 = "      for (int kk = 0; kk < T::KS2; ++kk) {\n        const int f2"
VARIANTS = {
    "as_is": [],
    # two walkers of 4 warps a block everywhere (W1's rows in halves at
    # D1 = 128), or one walker of 8 warps everywhere
    "two_walkers": [(_WIDE[0], "  static constexpr bool WIDE = false;"),
                    (_WIDE[1], "  static constexpr int IN_MAX = 64;")],
    "one_walker": [(_WIDE[0], "  static constexpr bool WIDE = true;")],
    # no products in phase 2, or in either phase
    "no_phase2_products": [(_PHASE2, _PHASE2.replace("kk < T::KS2",
                                                     "kk < 0"))],
    "no_products": [(_PHASE1, _PHASE1.replace("mcc < T::NMC", "mcc < 0")),
                    (_PHASE2, _PHASE2.replace("kk < T::KS2", "kk < 0"))],
}
DRIVER = r'''
#include "pair_bf16.cuh"
template <int P>
int launch_p(int which, const PairArgs& a) {
  switch (which) {
    case 0: return launch_bf16_pair<128, 128, false, P>(a);
    case 1: return launch_bf16_pair<64, 128, false, P>(a);
    default: return launch_bf16_pair<32, 128, true, P>(a);
  }
}
extern "C" int variant_pair(int which, int prec, const float* psi,
                            float* out, const float* w1, const float* w2,
                            int64_t n_amps, int log_d2, int log_b,
                            const int64_t* flips, int nflips,
                            const int64_t* masks, const int64_t* wants,
                            const float* phase, int nphases, void* stream) {
  PairArgs a{psi, out, w1, w2, n_amps, log_d2, log_b, flips, nflips, masks,
             wants, phase, nphases, static_cast<cudaStream_t>(stream)};
  return prec == 1 ? launch_p<1>(which, a) : launch_p<2>(which, a);
}
'''


def build(names) -> dict:
    """{variant: shared library}, nvcc run for every variant at once."""
    from qbot_tpu_torch.tpu import kernels

    procs = {}
    for name in names:
        src = OUT / name
        shutil.rmtree(src, ignore_errors=True)
        src.mkdir(parents=True)
        for f in CSRC.glob("*.cuh"):
            text = f.read_text()
            if f.name == "pair_bf16.cuh":
                for old, new in VARIANTS[name]:
                    if old not in text:
                        raise RuntimeError(f"{name}: {old!r} not in "
                                           f"{f.name}")
                    text = text.replace(old, new)
            (src / f.name).write_text(text)
        (src / "variant.cu").write_text(DRIVER)
        cmd = [kernels._nvcc(), *kernels._NVCC_FLAGS, "-shared", "-o",
               str(src / "variant.so"), str(src / "variant.cu")]
        procs[name] = subprocess.Popen(cmd, stderr=subprocess.PIPE,
                                       text=True)
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
    return {name: OUT / name / "variant.so" for name in names}


def main(argv) -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from qbot_tpu_torch.tpu import kernels

    names = argv or list(VARIANTS)
    libs = build(names)
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    rng = np.random.default_rng(0)
    psi = torch.randn((2, 2**N), generator=gen, device=device)
    psi /= torch.sqrt(torch.sum(psi * psi))
    out = torch.empty_like(psi)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    funcs = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).variant_pair
        fn.argtypes = [i32, i32, p, p, p, p, i64, i32, i32, p, i32, p, p, p,
                       i32, p]
        funcs[name] = fn

    def unitary(d):
        q, r = np.linalg.qr(rng.normal(size=(d, d))
                            + 1j * rng.normal(size=(d, d)))
        u = q * (np.diag(r) / np.abs(np.diag(r)))
        return torch.tensor(np.stack([u.real, u.imag]), dtype=torch.float32,
                            device=device)

    for which, (label, (start, width1, width2)) in enumerate(SHAPES.items()):
        w1, w2 = unitary(2**width1), unitary(2**width2)
        end = start + width1 + width2
        qs = sorted({max(start - 1, 0), start, start + width1, end - 1,
                     N - 1})
        phases = ((tuple(qs), complex(np.exp(0.7j)), 1),
                  ((start,), complex(-1.0), 0),
                  ((N - 1,), complex(np.exp(-1.3j)), 0))
        flips = tuple(int(m) for m in rng.integers(0, 2**N, size=3))
        diag = kernels.fused_diagonals(N, flips, phases, device)
        for prec, mode in ((1, "bf16_3x"), (2, "bf16")):
            for name, fn in funcs.items():
                def launch():
                    rc = fn(which, prec, psi.data_ptr(), out.data_ptr(),
                            w1.data_ptr(), w2.data_ptr(), 2**N, width2,
                            N - end, diag.flips.data_ptr(),
                            diag.flips.numel(), diag.mask.data_ptr(),
                            diag.want.data_ptr(), diag.phase.data_ptr(),
                            diag.mask.numel(),
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name} {label}: CUDA error "
                                           f"{rc}")
                launch()
                torch.cuda.synchronize()
                check = ""
                if name == "as_is":
                    want = kernels.pair_apply_ref(psi, N, start, width1,
                                                  width2, w1, w2, diag,
                                                  mode=mode)
                    rel = float(torch.linalg.vector_norm(out - want)
                                / torch.linalg.vector_norm(want))
                    check = f", rel L2 vs plain {rel:.3e}"
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(20):
                    launch()
                t1.record()
                torch.cuda.synchronize()
                print(f"{name} {label} {mode}: "
                      f"{t0.elapsed_time(t1) / 20:.4f} ms{check}",
                      flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
