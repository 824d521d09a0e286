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
// memory in W's own row-major (K-major) order.  The tile (tc_tile.cuh,
// shared with pair_apply.cu) does:
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
//   D = 64), kept FP32 and split as the fragments are built at D = 128 (the
//   narrow pairs' second window), where the split W (384 KiB) does not fit
//   in shared memory.
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
//   256: one lookup and one complex multiply an element.  (The reduced
//   modes apply several entries' factors one by one, as the plain version
//   does: tc_tile.cuh, diag_tables.)  Further entries are tested on the
//   flat index, element by element.
// - D <= 4 is below the tensor-core tile's k-step of 8 and runs a streaming
//   kernel of FP32 FMAs in every mode (window_fma_stream_kernel below):
//   plans reach it as the first window of the brickwork at n = 1, 2
//   (mod 7), A = 1, and in every window of a window=2 plan.
// - The reduced modes' tensor-core window is window_bf16.cuh.
// - The f32 window at D = 128 runs on Hopper's warpgroup products instead
//   (window_wg.cuh: wgmma.mma_async, W split once per launch, a producer
//   warpgroup), with this arithmetic; the tile above serves D = 8 .. 64
//   and the narrow pairs.
//
// ptxas (sm_90a, -O3; chip_smoke.py phase 1 on an H100), registers / spill
// stores of window_tc_kernel<D, B == 1>: <64> 215 / 0 and 220 / 0, <32>
// 219 / 0 and 224 / 0, <16> 115 / 0 and 123 / 0, <8> 88 / 0 and 96 / 0.
// Measured at 26 qubits without diagonals on an NVIDIA H100 80GB HBM3 at
// 700.00 W (PERF.md): 0.83 ms at D = 64 and 0.50 ms at D = 32 (39% and 64%
// of the byte bound).  Its time is set by issue slots, not by the
// products: the grids and the cross terms cost 17-19% at D = 128 against
// tf32-rounded hi parts.
#include "fma_stream.cuh"
#include "window_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// D <= 4: a streaming kernel of FP32 FMAs
// ---------------------------------------------------------------------------

// The window at D = 2, 4, in every dot mode.  Each thread owns V whole
// columns (V consecutive b, read as one vector a row, B > 1) or one column
// (its D contiguous elements read as one vector, TRAIL: B == 1), walked by
// a grid of resident blocks, so each element is read and written once.  The
// flips and phases are applied in registers, entry by entry in the plain
// version's order (fma_stream.cuh: stream_phases).  F32 takes x as loaded
// and W as it is; BF16X3 and BF16 split x into bf16 parts there once and W
// once per block (read as broadcast (re, im) pairs from shared memory).
// The products of the parts (exact in FP32 in the reduced modes) are
// summed by FP32 FMAs, for each k the W part, x part pairs hi hi, hi lo,
// lo hi (BF16X3; F32 and BF16: one product).  Bound by the bytes: at
// D = 4 in bf16_3x the FMAs take 0.1 ms of a 26-qubit pass at 67 TFLOP/s,
// its bytes 0.32 ms; F32 does a third of that work.
template <int D, int V, bool TRAIL, int PREC>
__global__ void __launch_bounds__(THREADS, 3)
    window_fma_stream_kernel(const float* __restrict__ psi,
                             float* __restrict__ out,
                             const float* __restrict__ w, int64_t n_amps,
                             int log_b, const Diag diag) {
  static_assert(!TRAIL || V == 1, "a trailing thread owns one column");
  constexpr int LOG_D = ilog2(D);
  constexpr int PARTS = parts<PREC>();
  constexpr int PRODUCTS = PREC == BF16X3 ? 3 : 1;
  __shared__ float2 ws[PARTS][D * D];               // (re, im) of W[i][k]
  __shared__ uint32_t jtab[D];
  __shared__ float2 comb[1 << TABLE];
  __shared__ long long cmask[TABLE], cwant[TABLE];
  psi += particle_offset(n_amps);
  out += particle_offset(n_amps);
  stage_parts<D, PREC>(w, ws);
  diag_tables<D, false>(diag, log_b, jtab, comb, cmask, cwant);
  __syncthreads();

  const int64_t B = int64_t(1) << log_b;
  const int64_t groups = (n_amps >> LOG_D) / V;
  for (int64_t grp = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       grp < groups; grp += int64_t(gridDim.x) * blockDim.x) {
    const int64_t c = grp * V;
    // flat index of element (j, v): base + j * stride + v
    const int64_t base =
        TRAIL ? c * D : ((c >> log_b) << (log_b + LOG_D)) | (c & (B - 1));
    const int64_t stride = TRAIL ? 1 : B;
    float x[2][D][V];  // [plane][j][v]
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      if constexpr (TRAIL) {
        const Vec<D> r = load_vec<D>(psi + pl * n_amps + base);
#pragma unroll
        for (int j = 0; j < D; ++j) x[pl][j][0] = r.v[j];
      } else {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const Vec<V> r = load_vec<V>(psi + pl * n_amps + base + j * B);
#pragma unroll
          for (int v = 0; v < V; ++v) x[pl][j][v] = r.v[v];
        }
      }
    }
    stream_phases<D, V>(x, base, stride, diag, jtab, comb, cmask, cwant);
    float xp[PARTS][2][D][V];  // [part][plane][j][v]
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float part[PARTS];
          split_mode<PREC>(x[pl][j][v], part);
#pragma unroll
          for (int p = 0; p < PARTS; ++p) xp[p][pl][j][v] = part[p];
        }
      }
    }
    // out[plane][i][v]
    float o[2][D][V];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float ar = 0.f, ai = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          // the (W part, x part) of product q: hi hi, hi lo, lo hi
#pragma unroll
          for (int q = 0; q < PRODUCTS; ++q) {
            const int pw = q == 2 ? 1 : 0, px = q == 1 ? 1 : 0;
            const float2 wq = ws[pw][i * D + k];
            const float xr = xp[px][0][k][v], xi = xp[px][1][k][v];
            ar = fmaf(wq.x, xr, fmaf(-wq.y, xi, ar));
            ai = fmaf(wq.x, xi, fmaf(wq.y, xr, ai));
          }
        }
        o[0][i][v] = ar;
        o[1][i][v] = ai;
      }
    }
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      if constexpr (TRAIL) {
        float r[D];
#pragma unroll
        for (int i = 0; i < D; ++i) r[i] = o[pl][i][0];
        store_vec<D>(out + pl * n_amps + base, r);
      } else {
#pragma unroll
        for (int i = 0; i < D; ++i)
          store_vec<V>(out + pl * n_amps + base + i * B, o[pl][i]);
      }
    }
  }
}

template <int D, int V, bool TRAIL, int PREC>
int launch_fma_stream(const WindowArgs& a) {
  static int blocks_cap[MAX_DEVICES] = {};  // resident blocks, per device
  cudaError_t err;
  const unsigned grid =
      stream_grid(window_fma_stream_kernel<D, V, TRAIL, PREC>,
                  a.n_amps / D / V, a.particles, blocks_cap, err);
  if (grid == 0) return static_cast<int>(err);
  const Diag diag{a.flips, a.nflips, a.masks, a.wants,
                  a.phase, a.nphases, a.n_amps - 1};
  window_fma_stream_kernel<D, V, TRAIL, PREC>
      <<<dim3(grid, a.particles), THREADS, 0, a.stream>>>(
          a.psi, a.out, a.w, a.n_amps, a.log_b, diag);
  return static_cast<int>(cudaGetLastError());
}

// V consecutive b a thread: one 16-byte (D = 2, B >= 4) or 8-byte load a
// row, so that x, its lo part and the outputs fit the registers of three
// blocks an SM in every mode
template <int D, int PREC>
int launch_fma(const WindowArgs& a) {
  if (a.log_b == 0) return launch_fma_stream<D, 1, true, PREC>(a);
  if constexpr (D == 4) {
    return launch_fma_stream<D, 2, false, PREC>(a);
  } else {
    return a.log_b == 1 ? launch_fma_stream<D, 2, false, PREC>(a)
                        : launch_fma_stream<D, 4, false, PREC>(a);
  }
}

template <int PREC>
int launch(const WindowArgs& a) {
  switch (a.log_d) {
    case 1: return launch_fma<2, PREC>(a);
    case 2: return launch_fma<4, PREC>(a);
    default: return window_tc_launch<1, PREC>(a);
  }
}

}  // namespace

// psi, out: (particles, 2, n_amps) float32, 16-byte aligned, one launch for
// all the particles (tc_tile.cuh: particle_offset); w: (2, D, D) float32
// with D = 2^log_d; B = 2^log_b; prec: the precision of the products
// (tc_tile.cuh: Prec); scratch: qbot_window_scratch_floats() floats,
// 16-byte aligned, for the f32 window at D = 128 (window_wg.cuh), else
// unused.  Returns the launch's cudaGetLastError().
extern "C" int qbot_window_apply(const float* psi, float* out, const float* w,
                                 int64_t n_amps, int particles, int log_d,
                                 int log_b, const int64_t* flips, int nflips,
                                 const int64_t* masks, const int64_t* wants,
                                 const float* phase, int nphases, int prec,
                                 float* scratch, void* stream) {
  if (log_d < 1 || log_d > 7 || particles < 1 || particles > MAX_PARTICLES)
    return static_cast<int>(cudaErrorInvalidValue);
  const WindowArgs a{psi,     out,   w,      n_amps,
                     log_d,   log_b, flips,  nflips,
                     masks,   wants, phase,  nphases,
                     static_cast<cudaStream_t>(stream), nullptr, particles,
                     scratch};
  switch (prec) {
    case F32: return launch<F32>(a);
    case BF16X3: return launch<BF16X3>(a);
    case BF16: return launch<BF16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the floats of the scratch qbot_window_apply takes
extern "C" int qbot_window_scratch_floats() { return wg::SCRATCH_FLOATS; }

extern "C" const char* qbot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
