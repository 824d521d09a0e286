// Window kernel of the planar statevector executor.
//
// Replaces the TPU kernels _left_multiply (qbot_tpu/tpu/kernels.py:179-231,
// middle windows, B > 1) and _right_multiply (qbot_tpu/tpu/kernels.py:
// 243-293, the trailing window, B == 1) with one kernel:
//
//   out[a, i, b] = sum_j W[i, j] * (Phi F p)[a, j, b]
//
// on one planar float32 state (re plane, then im plane, 2^n floats each)
// viewed as (A, D, B), D = 2^width <= 128.  F negates the amplitudes at a
// few global flat indices; Phi multiplies every amplitude whose flat index m
// has (m & mask) == want by a phase.
//
// What bounds it on an H100: at 26 qubits one pass reads and writes 1.07 GB
// (0.32 ms at 3.35 TB/s) and does 8 * D FLOPs per complex amplitude.  The
// products run on the TF32 tensor cores as a 3xTF32 split (three products
// per product, FP32-grade error), so the operation bound is 3 * 8 * D * 2^n
// TF32 FLOPs at 495 TFLOP/s: 0.10 ms at D = 32, bound by bytes (0.32 ms);
// 0.42 ms at D = 128, bound by operations.
//
// Design: the planar complex product is one real GEMM, [out_r; out_i] =
// [[Wr, -Wi], [Wi, Wr]] [x_r; x_i], computed transposed, out^T = X^T M^T,
// with mma.sync.m16n8k8 TF32: the state columns c = a*B + b are the rows of
// the A operand (built in registers), W the B operand, read from shared
// memory in W's own row-major (K-major) order.  mma.sync and not wgmma:
// wgmma's TF32 form needs its B operand K-major in shared memory with the
// swizzled layouts and descriptors of the async proxy; mma.sync takes the
// same products from registers.  The tile (tc_tile.cuh, shared with
// pair_apply.cu) does:
//
// - 3xTF32 without rounding bias: x and W split into hi and lo parts on a
//   grid per column (row) and k-step, so each k-step's hi*hi sums are exact
//   on tensor cores that round toward zero; the products are x_hi W_hi +
//   x_hi W_lo + x_lo tf32(W).  Error against float64: about 3e-7 relative
//   L2 (float32 FMAs: 1-2e-7; tests/test_torch_window_split.py replays the
//   arithmetic in numpy).  Without the grids (x_hi = x rounded to tf32) a
//   26-qubit brickwork lost 1.6e-7 of its norm a pass.
// - A persistent block (8 warps) stages W once in mma fragment order with
//   its grids: split into hi, lo and tf32 parts at D <= 64 (96 KiB at
//   D = 64), kept FP32 and split as the fragments are built at D = 128,
//   where the split W (384 KiB) does not fit in shared memory.
// - The block walks tiles of BN state columns and all D outputs: each warp
//   owns 16 columns and half the outputs (all of them at D <= 32: at D = 64
//   all of them took 255 registers and spilled), so every state element
//   is read from device memory once and written once.  The products go
//   two n-tiles at a time, two exact and two cross-term sums each: 8
//   independent chains a warp.
// - The state streams through a 3-stage ring of BK-deep chunks of 16-byte
//   (8-byte at B = 2) cp.async copies, laid out [k][c] (B > 1) or [c][k]
//   (B = 1, contiguous along j) with padded rows, so the fragment loads are
//   free of bank conflicts.  A warp issues all of a stage's fragment loads
//   before it uses any.
// - Flips and phases, once per element as the A fragment is built; a flip
//   is a phase of -1 on every index bit.  The first 8 entries are looked
//   up: a bit per entry whose window bits match j (tabulated once per
//   block), a bit per entry whose other bits match the column (once per
//   column and tile), and the product of the hit entries from a table of
//   256: one lookup and one complex multiply an element.  Further entries
//   are tested on the flat index, element by element.
// - D <= 4 is below the tensor-core tile's k-step of 8 and runs a plain FP32
//   FMA variant from shared-memory tiles.
//
// ptxas (sm_90a, -O3; chip_smoke.py phase 1 on an H100), registers / spill
// stores of window_tc_kernel<D, B == 1>: <128, no> 255 / 12 B, <128, yes>
// 255 / 0, <64> 215 / 0 and 220 / 0, <32> 219 / 0 and 224 / 0, <16> 115 / 0
// and 123 / 0, <8> 88 / 0 and 96 / 0; window_fma_kernel at D = 4 and 2:
// 64 / 0 and 40 / 0.  Measured at 26 qubits without diagonals (PERF.md):
// 1.53 ms at D = 128 (27% of the operation bound), 0.83 ms at D = 64 and
// 0.50 ms at D = 32 (39% and 64% of the byte bound).  Its time is set by
// issue slots, not by the products: the grids and the cross terms cost
// 17-19% at D = 128 against tf32-rounded hi parts.
#include "window_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// D <= 4: FP32 FMAs from shared-memory tiles
// ---------------------------------------------------------------------------

constexpr int TN = 4;  // columns per thread

__device__ __forceinline__ void apply_diagonals(
    int64_t m, float& xr, float& xi, const int64_t* __restrict__ flips,
    int nflips, const int64_t* __restrict__ masks,
    const int64_t* __restrict__ wants, const float* __restrict__ phase,
    int nphases) {
  for (int f = 0; f < nflips; ++f) {
    if (flips[f] == m) {
      xr = -xr;
      xi = -xi;
    }
  }
  for (int p = 0; p < nphases; ++p) {
    if ((m & masks[p]) == wants[p]) {
      cmul(xr, xi, phase[p], phase[nphases + p]);
    }
  }
}

// PREC F32: the products in FP32 FMAs.  BF16X3 and BF16: x and W split
// into bf16 hi and lo parts as they are staged, the products of parts
// (exact in FP32) summed by FP32 FMAs: hi·hi, hi·lo and lo·hi, or hi·hi.
template <int D, int BN, int TM, int PREC>
__global__ void __launch_bounds__((D / TM) * (BN / TN))
    window_fma_kernel(const float* __restrict__ psi, float* __restrict__ out,
                      const float* __restrict__ w, int64_t n_amps, int log_b,
                      const int64_t* __restrict__ flips, int nflips,
                      const int64_t* __restrict__ masks,
                      const int64_t* __restrict__ wants,
                      const float* __restrict__ phase, int nphases) {
  constexpr int NX = BN / TN;  // threads along the columns
  constexpr int NT = (D / TM) * NX;
  constexpr int LOG_BN = ilog2(BN);
  constexpr int PARTS = PREC == F32 ? 1 : 2;     // [hi, lo] of x and W
  constexpr int PRODUCTS = PREC == BF16X3 ? 3 : 1;
  __shared__ float xs[PARTS][2][D][BN + 1];
  __shared__ float ws[PARTS][2][D][D + 1];

  const int tid = threadIdx.x;
  const int tx = tid % NX;
  const int ty = tid / NX;
  const int64_t cols = n_amps / D;
  const int64_t c0 = int64_t(blockIdx.x) * BN;
  const int64_t B = int64_t(1) << log_b;
  // the tile holds BN / Bt runs of Bt contiguous columns (Bt = min(B, BN))
  const int log_bt = log_b < LOG_BN ? log_b : LOG_BN;
  const int bt_mask = (1 << log_bt) - 1;
  // x into parts[0] (and its bf16 lo part into parts[1])
  auto stage = [](float (*parts)[2][D][BN + 1], int pl, int k, int col,
                  float x) {
    if constexpr (PREC == F32) {
      parts[0][pl][k][col] = x;
    } else {
      const float hi = round_bf16(x);
      parts[0][pl][k][col] = hi;
      parts[1][pl][k][col] = round_bf16(__fsub_rn(x, hi));
    }
  };

  for (int e = tid; e < D * BN; e += NT) {
    const int b_off = e & bt_mask;
    const int k = (e >> log_bt) % D;
    const int a_off = (e >> log_bt) / D;
    const int col = (a_off << log_bt) + b_off;
    const int64_t c = c0 + col;
    float xr = 0.f, xi = 0.f;
    if (c < cols) {
      const int64_t m = ((c >> log_b) * D + k) * B + (c & (B - 1));
      xr = psi[m];
      xi = psi[n_amps + m];
      apply_diagonals(m, xr, xi, flips, nflips, masks, wants, phase,
                      nphases);
    }
    stage(xs, 0, k, col, xr);
    stage(xs, 1, k, col, xi);
  }
  for (int e = tid; e < D * D; e += NT) {
    const float wr = w[e], wi = w[D * D + e];
    if constexpr (PREC == F32) {
      ws[0][0][e % D][e / D] = wr;
      ws[0][1][e % D][e / D] = wi;
    } else {
      const float hr = round_bf16(wr), hi = round_bf16(wi);
      ws[0][0][e % D][e / D] = hr;
      ws[0][1][e % D][e / D] = hi;
      ws[1][0][e % D][e / D] = round_bf16(__fsub_rn(wr, hr));
      ws[1][1][e % D][e / D] = round_bf16(__fsub_rn(wi, hi));
    }
  }
  __syncthreads();

  float acc_r[TM][TN] = {}, acc_i[TM][TN] = {};
#pragma unroll
  for (int k = 0; k < D; ++k) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        // the (W part, x part) of product q: hi hi, hi lo, lo hi
#pragma unroll
        for (int q = 0; q < PRODUCTS; ++q) {
          const int pw = q == 2 ? 1 : 0, px = q == 1 ? 1 : 0;
          const float wr = ws[pw][0][k][ty * TM + r];
          const float wi = ws[pw][1][k][ty * TM + r];
          const float xr = xs[px][0][k][tx + t * NX];
          const float xi = xs[px][1][k][tx + t * NX];
          acc_r[r][t] = fmaf(wr, xr, fmaf(-wi, xi, acc_r[r][t]));
          acc_i[r][t] = fmaf(wr, xi, fmaf(wi, xr, acc_i[r][t]));
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < TN; ++t) {
    const int64_t c = c0 + tx + t * NX;
    if (c >= cols) continue;
    const int64_t a = c >> log_b;
    const int64_t b = c & (B - 1);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int64_t m = (a * D + ty * TM + r) * B + b;
      out[m] = acc_r[r][t];
      out[n_amps + m] = acc_i[r][t];
    }
  }
}

template <int D, int PREC>
int launch_fma(const WindowArgs& a) {
  constexpr int BN = 512;
  const int64_t cols = a.n_amps / D;
  const unsigned grid = static_cast<unsigned>((cols + BN - 1) / BN);
  window_fma_kernel<D, BN, D, PREC><<<grid, BN / TN, 0, a.stream>>>(
      a.psi, a.out, a.w, a.n_amps, a.log_b, a.flips, a.nflips, a.masks,
      a.wants, a.phase, a.nphases);
  return static_cast<int>(cudaGetLastError());
}

template <int PREC>
int launch(const WindowArgs& a) {
  switch (a.log_d) {
    case 1: return launch_fma<2, PREC>(a);
    case 2: return launch_fma<4, PREC>(a);
    default: return window_tc_launch<PREC>(a);
  }
}

}  // namespace

// psi, out: (2, n_amps) float32, 16-byte aligned; w: (2, D, D) float32 with
// D = 2^log_d; B = 2^log_b; prec: the precision of the products
// (tc_tile.cuh: Prec).  Returns the launch's cudaGetLastError().
extern "C" int qbot_window_apply(const float* psi, float* out, const float* w,
                                 int64_t n_amps, int log_d, int log_b,
                                 const int64_t* flips, int nflips,
                                 const int64_t* masks, const int64_t* wants,
                                 const float* phase, int nphases, int prec,
                                 void* stream) {
  if (log_d < 1 || log_d > 7) return static_cast<int>(cudaErrorInvalidValue);
  const WindowArgs a{psi,   out,   w,     n_amps,  log_d,
                     log_b, flips, nflips, masks, wants,
                     phase, nphases, static_cast<cudaStream_t>(stream)};
  switch (prec) {
    case F32: return launch<F32>(a);
    case BF16X3: return launch<BF16X3>(a);
    case BF16: return launch<BF16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* qbot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
