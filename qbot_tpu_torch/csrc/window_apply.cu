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
//   256: one lookup and one complex multiply an element.  (The reduced
//   modes apply several entries' factors one by one, as the plain version
//   does: tc_tile.cuh, diag_tables.)  Further entries are tested on the
//   flat index, element by element.
// - D <= 4 is below the tensor-core tile's k-step of 8 and runs a plain FP32
//   FMA variant from shared-memory tiles (f32), or a streaming FMA kernel
//   that splits its operands in registers (bf16_3x, bf16).
// - The reduced modes' tensor-core window is window_bf16.cuh.
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

// F32: the products in FP32 FMAs, from shared-memory tiles.
template <int D, int BN, int TM>
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
  __shared__ float xs[2][D][BN + 1];
  __shared__ float ws[2][D][D + 1];

  const int tid = threadIdx.x;
  const int tx = tid % NX;
  const int ty = tid / NX;
  const int64_t cols = n_amps / D;
  const int64_t c0 = int64_t(blockIdx.x) * BN;
  const int64_t B = int64_t(1) << log_b;
  // the tile holds BN / Bt runs of Bt contiguous columns (Bt = min(B, BN))
  const int log_bt = log_b < LOG_BN ? log_b : LOG_BN;
  const int bt_mask = (1 << log_bt) - 1;

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
    xs[0][k][col] = xr;
    xs[1][k][col] = xi;
  }
  for (int e = tid; e < D * D; e += NT) {
    ws[0][e % D][e / D] = w[e];
    ws[1][e % D][e / D] = w[D * D + e];
  }
  __syncthreads();

  float acc_r[TM][TN] = {}, acc_i[TM][TN] = {};
#pragma unroll
  for (int k = 0; k < D; ++k) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float wr = ws[0][k][ty * TM + r];
        const float wi = ws[1][k][ty * TM + r];
        const float xr = xs[0][k][tx + t * NX];
        const float xi = xs[1][k][tx + t * NX];
        acc_r[r][t] = fmaf(wr, xr, fmaf(-wi, xi, acc_r[r][t]));
        acc_i[r][t] = fmaf(wr, xi, fmaf(wi, xr, acc_i[r][t]));
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

// N consecutive floats, one vector load or store
template <int N>
struct Vec {
  float v[N];
};

template <int N>
__device__ __forceinline__ Vec<N> load_vec(const float* p) {
  Vec<N> r;
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    r.v[0] = q.x, r.v[1] = q.y;
  }
  return r;
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// BF16X3 and BF16: a streaming kernel.  Each thread owns V whole columns
// (V consecutive b, read as one vector a row, B > 1) or one column (its D
// contiguous elements read as one vector, TRAIL: B == 1), walked by a grid
// of resident blocks.  The flips and phases are applied in registers, found
// by the tensor-core windows' lookup tables (tc_tile.cuh: diag_tables); x is
// split into bf16 hi and lo there once, W once per block into shared
// memory (read as broadcast (re, im) pairs); the products of the parts
// (exact in FP32) are summed by FP32 FMAs in the order of the F32 kernel
// above, hi·hi, hi·lo, lo·hi for each j (BF16: hi·hi alone).  Bound by the
// bytes: at D = 4 in bf16_3x the FMAs take 0.1 ms of a 26-qubit pass at 67
// TFLOP/s, its bytes 0.32 ms.
template <int D, int V, bool TRAIL, int PREC>
__global__ void __launch_bounds__(THREADS, 3)
    window_fma_stream_kernel(const float* __restrict__ psi,
                             float* __restrict__ out,
                             const float* __restrict__ w, int64_t n_amps,
                             int log_b, const Diag diag) {
  static_assert(PREC == BF16X3 || PREC == BF16, "a reduced dot mode");
  static_assert(!TRAIL || V == 1, "a trailing thread owns one column");
  constexpr int LOG_D = ilog2(D);
  constexpr int PARTS = PREC == BF16X3 ? 2 : 1;     // [hi, lo] of x and W
  constexpr int PRODUCTS = PREC == BF16X3 ? 3 : 1;
  __shared__ float2 ws[PARTS][D * D];               // (re, im) of W[i][k]
  __shared__ uint32_t jtab[D];
  __shared__ float2 comb[1 << TABLE];
  __shared__ long long cmask[TABLE], cwant[TABLE];
  for (int e = threadIdx.x; e < D * D; e += blockDim.x) {
    const float wr = w[e], wi = w[D * D + e];
    const float hr = round_bf16(wr), hi = round_bf16(wi);
    ws[0][e] = make_float2(hr, hi);
    if constexpr (PARTS == 2)
      ws[1][e] = make_float2(round_bf16(__fsub_rn(wr, hr)),
                             round_bf16(__fsub_rn(wi, hi)));
  }
  diag_tables<D, false>(diag, log_b, jtab, comb, cmask, cwant);
  __syncthreads();
  const int ndiag = diag.nphases + diag.nflips;
  const int ntab = ndiag < TABLE ? ndiag : TABLE;

  const int64_t B = int64_t(1) << log_b;
  const int64_t groups = (n_amps >> LOG_D) / V;
  for (int64_t grp = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       grp < groups; grp += int64_t(gridDim.x) * blockDim.x) {
    const int64_t c = grp * V;
    // flat index of element (j, v): base + j * stride + v
    const int64_t base =
        TRAIL ? c * D : ((c >> log_b) << (log_b + LOG_D)) | (c & (B - 1));
    const int64_t stride = TRAIL ? 1 : B;
    // x[part][plane][j][v]
    float x[PARTS][2][D][V];
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      if constexpr (TRAIL) {
        const Vec<D> r = load_vec<D>(psi + pl * n_amps + base);
#pragma unroll
        for (int j = 0; j < D; ++j) x[0][pl][j][0] = r.v[j];
      } else {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const Vec<V> r = load_vec<V>(psi + pl * n_amps + base + j * B);
#pragma unroll
          for (int v = 0; v < V; ++v) x[0][pl][j][v] = r.v[v];
        }
      }
    }
    if (ndiag) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        // column c + v's j = 0 element sits at base + v
        const uint32_t hit = col_hits(base + v, ntab, cmask, cwant);
#pragma unroll
        for (int j = 0; j < D; ++j) {
          // the entries that hit the element one by one, in order, as the
          // plain version applies them (comb of one entry is the entry):
          // a combined factor would round otherwise, and a bf16 rounding
          // of x moves by 2^-8 with it
          for (uint32_t h = hit & jtab[j]; h; h &= h - 1) {
            const float2 z = comb[h & (0u - h)];
            cmul(x[0][0][j][v], x[0][1][j][v], z.x, z.y);
          }
          for (int q = TABLE; q < ndiag; ++q) {
            int64_t mask, want;
            float zr, zi;
            diag.entry(q, mask, want, zr, zi);
            if (((base + j * stride + v) & mask) == want)
              cmul(x[0][0][j][v], x[0][1][j][v], zr, zi);
          }
        }
      }
    }
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float hi = round_bf16(x[0][pl][j][v]);
          if constexpr (PARTS == 2)
            x[1][pl][j][v] = round_bf16(__fsub_rn(x[0][pl][j][v], hi));
          x[0][pl][j][v] = hi;
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
            const float xr = x[px][0][k][v], xi = x[px][1][k][v];
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
  const int cap = resident_blocks(window_fma_stream_kernel<D, V, TRAIL, PREC>,
                                  0, blocks_cap, err);
  if (cap == 0) return static_cast<int>(err);
  const int64_t groups = a.n_amps / D / V;
  const int64_t blocks = (groups + THREADS - 1) / THREADS;
  const unsigned grid = static_cast<unsigned>(blocks < cap ? blocks : cap);
  const Diag diag{a.flips, a.nflips, a.masks, a.wants,
                  a.phase, a.nphases, a.n_amps - 1};
  window_fma_stream_kernel<D, V, TRAIL, PREC><<<grid, THREADS, 0, a.stream>>>(
      a.psi, a.out, a.w, a.n_amps, a.log_b, diag);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int PREC>
int launch_fma(const WindowArgs& a) {
  if constexpr (PREC == F32) {
    constexpr int BN = 512;
    const int64_t cols = a.n_amps / D;
    const unsigned grid = static_cast<unsigned>((cols + BN - 1) / BN);
    window_fma_kernel<D, BN, D><<<grid, BN / TN, 0, a.stream>>>(
        a.psi, a.out, a.w, a.n_amps, a.log_b, a.flips, a.nflips, a.masks,
        a.wants, a.phase, a.nphases);
    return static_cast<int>(cudaGetLastError());
  } else {
    // V consecutive b a thread: one 16-byte (D = 2, B >= 4) or 8-byte load
    // a row, so that x, its lo part and the outputs fit the registers of
    // three blocks an SM
    if (a.log_b == 0) return launch_fma_stream<D, 1, true, PREC>(a);
    if constexpr (D == 4) {
      return launch_fma_stream<D, 2, false, PREC>(a);
    } else {
      return a.log_b == 1 ? launch_fma_stream<D, 2, false, PREC>(a)
                          : launch_fma_stream<D, 4, false, PREC>(a);
    }
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
