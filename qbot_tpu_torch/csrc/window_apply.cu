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
#include "tc_tile.cuh"

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
      const float zr = phase[p], zi = phase[nphases + p];
      const float r = xr * zr - xi * zi;
      const float i = xr * zi + xi * zr;
      xr = r;
      xi = i;
    }
  }
}

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
      const float wr = ws[0][k][ty * TM + r], wi = ws[1][k][ty * TM + r];
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float xr = xs[0][k][tx + t * NX], xi = xs[1][k][tx + t * NX];
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

template <int D>
int launch_fma(const float* psi, float* out, const float* w, int64_t n_amps,
               int log_b, const int64_t* flips, int nflips,
               const int64_t* masks, const int64_t* wants, const float* phase,
               int nphases, cudaStream_t stream) {
  constexpr int BN = 512;
  const int64_t cols = n_amps / D;
  const unsigned grid = static_cast<unsigned>((cols + BN - 1) / BN);
  window_fma_kernel<D, BN, D><<<grid, BN / TN, 0, stream>>>(
      psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase,
      nphases);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// D >= 8: 3xTF32 tensor-core kernel
// ---------------------------------------------------------------------------

template <int D, bool TRAIL>
struct Tile {
  static constexpr int LOG_D = ilog2(D);
  static constexpr int KS = D / 8;                // k-steps of 8 j
  static constexpr int WI = D >= 64 ? 2 : 1;      // warps along the outputs
  static constexpr int NI = KS / WI;              // 8-output n-tiles a warp
  static constexpr int WC = WARPS / WI;           // warps along the columns
  static constexpr int BN = WC * 16;              // columns per tile
  static constexpr int BK = D < 16 ? D : 16;      // j per stage
  static constexpr int KC = BK / 8;               // k-steps per stage
  static constexpr int CHUNKS = D / BK;
  static constexpr bool SPLIT_W = D <= 64;
  // a stage is [plane][k][c] (B > 1) or [plane][c][k] (B = 1); the row pads
  // put the 32 lanes of a fragment load in 32 distinct banks
  static constexpr int PITCH = TRAIL ? BK + 4 : BN + 8;
  static constexpr int PLANE = TRAIL ? BN * PITCH : BK * PITCH;
  static constexpr int STAGE = 2 * PLANE;
  // split W: per fragment, 32 lanes of {hi, lo} re, of {hi, lo} im and of
  // tf32(W) re and im, each a float4
  static constexpr int W_FLOATS = SPLIT_W ? 6 * D * D : 2 * D * D;
  // W_FLOATS, then the stages, the grids of W ([k-step][i]), jtab, comb,
  // cmask and cwant
  static constexpr int SMEM = 4 * (W_FLOATS + STAGES * STAGE + KS * D + D) +
                              8 * (1 << TABLE) + 16 * TABLE;
};

template <int D, bool TRAIL>
__global__ void __launch_bounds__(THREADS, 1)
    window_tc_kernel(const float* __restrict__ psi, float* __restrict__ out,
                     const float* __restrict__ w, int64_t n_amps, int log_b,
                     const Diag diag) {
  using T = Tile<D, TRAIL>;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* xs = ws + T::W_FLOATS;
  float* wgrid = xs + STAGES * T::STAGE;
  uint32_t* jtab = reinterpret_cast<uint32_t*>(wgrid + T::KS * D);
  float2* comb = reinterpret_cast<float2*>(jtab + D);
  long long* cmask = reinterpret_cast<long long*>(comb + (1 << TABLE));
  long long* cwant = cmask + TABLE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wi = warp % T::WI, wc = warp / T::WI;
  const int64_t B = int64_t(1) << log_b;
  const int64_t cols = n_amps >> T::LOG_D;
  const int64_t tiles = (cols + T::BN - 1) / T::BN;
  const int ndiag = diag.nphases + diag.nflips;
  const int ntab = ndiag < TABLE ? ndiag : TABLE;

  // the grid of row i of W over k-step ks, both planes
  for (int e = tid; e < T::KS * D; e += THREADS) {
    const int i = e & (D - 1), ks = e >> T::LOG_D;
    wgrid[e] = grid_of_row8(w + i * D + 8 * ks, w + D * D + i * D + 8 * ks);
  }
  __syncthreads();
  // W into fragment order: for n-tile it, k-step ks and lane (g, t), the
  // B fragment is W[8 it + g][8 ks + t] and W[8 it + g][8 ks + t + 4]
  for (int e = tid; e < D * D; e += THREADS) {
    const int i = e >> T::LOG_D, j = e & (D - 1);
    const int frag = (i >> 3) * T::KS + (j >> 3);
    const int ln = (i & 7) * 4 + (j & 3), half = (j >> 2) & 1;
    const float wr = w[e], wim = w[D * D + e];
    if (T::SPLIT_W) {
      const float m = wgrid[(j >> 3) * D + i];
      float* f = ws + (frag * 96 + ln) * 4;
      uint32_t hi, lo;
      split(wr, m, hi, lo);
      f[half] = __uint_as_float(hi);
      f[2 + half] = __uint_as_float(lo);
      split(wim, m, hi, lo);
      f[128 + half] = __uint_as_float(hi);
      f[128 + 2 + half] = __uint_as_float(lo);
      f[256 + half] = __uint_as_float(tf32(wr));
      f[256 + 2 + half] = __uint_as_float(tf32(wim));
    } else {
      float* f = ws + (frag * 32 + ln) * 4;
      f[half] = wr;
      f[2 + half] = wim;
    }
  }
  diag_tables<D>(diag, log_b, jtab, comb, cmask, cwant);

  auto tile_c0 = [&](int64_t s) {
    return (blockIdx.x + (s / T::CHUNKS) * gridDim.x) * T::BN;
  };
  // flat index of column c's j = 0 element: a * D * B + b
  auto col_base = [&](int64_t c) {
    return ((c >> log_b) << (log_b + T::LOG_D)) | (c & (B - 1));
  };

  auto load = [&](int64_t s, int stage) {
    const int64_t c0 = tile_c0(s);
    const int j0 = int(s % T::CHUNKS) * T::BK;
    float* st = xs + stage * T::STAGE;
    if (TRAIL) {
      constexpr int KQ = T::BK / 4;
      for (int e = tid; e < 2 * T::BN * KQ; e += THREADS) {
        const int kq = e % KQ, cl = (e / KQ) % T::BN, pl = e / (KQ * T::BN);
        const int64_t c = c0 + cl;
        const bool ok = c < cols;
        cp_async(st + pl * T::PLANE + cl * T::PITCH + kq * 4,
                 psi + pl * n_amps + (ok ? c * D + j0 + kq * 4 : 0), 16, ok);
      }
    } else {
      const int lv = log_b < 2 ? log_b : 2;  // 2^lv columns per copy
      const int lrow = ilog2(T::BN) - lv;
      for (int e = tid; e < (2 * T::BK) << lrow; e += THREADS) {
        const int cl = (e & ((1 << lrow) - 1)) << lv;
        const int k = (e >> lrow) & (T::BK - 1);
        const int pl = e >> (lrow + ilog2(T::BK));
        const int64_t c = c0 + cl;
        const bool ok = c < cols;
        cp_async(st + pl * T::PLANE + k * T::PITCH + cl,
                 psi + pl * n_amps +
                     (ok ? col_base(c) + (int64_t(j0 + k) << log_b) : 0),
                 4 << lv, ok);
      }
    }
  };

  const int64_t my_tiles =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t items = my_tiles * T::CHUNKS;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < items) load(s, s);
    cp_async_commit();
  }

  float acc[T::NI][2][4];
  uint32_t colhit[2];
  const int cw = wc * 16;  // the warp's first column in the tile
  for (int64_t s = 0, stage = 0; s < items;
       ++s, stage = stage == STAGES - 1 ? 0 : stage + 1) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int chunk = int(s % T::CHUNKS);
    const int64_t c0 = tile_c0(s);
    if (chunk == 0) {
#pragma unroll
      for (int it = 0; it < T::NI; ++it) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[it][q >> 2][q & 3] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        colhit[r] = col_hits(col_base(c0 + cw + g + 8 * r), ntab, cmask, cwant);
    }
    // the A fragments of the stage's k-steps: element e of k-step kc is
    // column row g (+ 8 for odd e) at j = 8 kc + t (+ 4 for e >= 2).  All
    // loads first, so their latencies overlap.
    const float* st = xs + stage * T::STAGE;
    float xr[T::KC][4], xi[T::KC][4];
#pragma unroll
    for (int kc = 0; kc < T::KC; ++kc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = kc * 8 + t + 4 * (e >> 1), cl = cw + g + 8 * (e & 1);
        const int off = TRAIL ? cl * T::PITCH + k : k * T::PITCH + cl;
        xr[kc][e] = st[off];
        xi[kc][e] = st[T::PLANE + off];
      }
    }
    // item s + STAGES - 1 goes to the stage item s - 1 used
    if (s + STAGES - 1 < items)
      load(s + STAGES - 1, stage == 0 ? STAGES - 1 : int(stage) - 1);
    cp_async_commit();
    if (ndiag) {
      diag_fragments<T::KC, false>(
          xr, xi, diag, ndiag, chunk * T::BK, log_b, jtab, comb, colhit,
          [&](int r) { return col_base(c0 + cw + g + 8 * r); });
    }
    // x = hi + lo on the grid of its column row and k-step, W likewise on
    // the grid of its row and k-step (wgrid): exact hi·hi k-step sums
    // (tc_tile.cuh)
    const ASplit<T::KC> a(xr, xi);
    tc_products<T::KC, T::NI>(acc, a, [&](int it, int kc, BFrag& b) {
      const int row = wi * T::NI + it;
      const int frag = row * T::KS + chunk * T::KC + kc;
      if (T::SPLIT_W) {
        const float4* f = reinterpret_cast<const float4*>(ws) + frag * 96;
        const float4 fr = f[lane], fi = f[32 + lane], ft = f[64 + lane];
        b.h[0][0] = __float_as_uint(fr.x);
        b.h[0][1] = __float_as_uint(fr.y);
        b.l[0][0] = __float_as_uint(fr.z);
        b.l[0][1] = __float_as_uint(fr.w);
        b.h[1][0] = __float_as_uint(fi.x);
        b.h[1][1] = __float_as_uint(fi.y);
        b.l[1][0] = __float_as_uint(fi.z);
        b.l[1][1] = __float_as_uint(fi.w);
        b.t[0][0] = __float_as_uint(ft.x);
        b.t[0][1] = __float_as_uint(ft.y);
        b.t[1][0] = __float_as_uint(ft.z);
        b.t[1][1] = __float_as_uint(ft.w);
      } else {
        const float m = wgrid[(chunk * T::KC + kc) * D + row * 8 + g];
        const float4 f = reinterpret_cast<const float4*>(ws)[frag * 32 + lane];
        b.set(f.x, f.y, f.z, f.w, m);
      }
    });
    if (chunk == T::CHUNKS - 1) {
      // c0, c1 of an accumulator are outputs 2t, 2t + 1 of column row g;
      // c2, c3 the same of row g + 8
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t c = c0 + cw + g + 8 * r;
        if (c >= cols) continue;
        const int64_t base = col_base(c);
#pragma unroll
        for (int it = 0; it < T::NI; ++it) {
          const int i = (wi * T::NI + it) * 8 + 2 * t;
#pragma unroll
          for (int pl = 0; pl < 2; ++pl) {
            const float v0 = acc[it][pl][2 * r];
            const float v1 = acc[it][pl][2 * r + 1];
            float* o = out + pl * n_amps + base;
            if (TRAIL) {
              *reinterpret_cast<float2*>(o + i) = make_float2(v0, v1);
            } else {
              o[int64_t(i) << log_b] = v0;
              o[int64_t(i + 1) << log_b] = v1;
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int D, bool TRAIL>
int launch_tc(const float* psi, float* out, const float* w, int64_t n_amps,
              int log_b, const int64_t* flips, int nflips,
              const int64_t* masks, const int64_t* wants, const float* phase,
              int nphases, cudaStream_t stream) {
  using T = Tile<D, TRAIL>;
  static int blocks_cap[MAX_DEVICES] = {};  // resident blocks, per device
  cudaError_t err;
  const int cap =
      resident_blocks(window_tc_kernel<D, TRAIL>, T::SMEM, blocks_cap, err);
  if (cap == 0) return static_cast<int>(err);
  const int64_t tiles = ((n_amps >> T::LOG_D) + T::BN - 1) / T::BN;
  const unsigned grid = static_cast<unsigned>(tiles < cap ? tiles : cap);
  const Diag diag{flips, nflips, masks, wants, phase, nphases, n_amps - 1};
  window_tc_kernel<D, TRAIL><<<grid, THREADS, T::SMEM, stream>>>(
      psi, out, w, n_amps, log_b, diag);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const float* psi, float* out, const float* w, int64_t n_amps,
           int log_b, const int64_t* flips, int nflips, const int64_t* masks,
           const int64_t* wants, const float* phase, int nphases,
           cudaStream_t stream) {
  if constexpr (D < 8) {
    return launch_fma<D>(psi, out, w, n_amps, log_b, flips, nflips, masks,
                         wants, phase, nphases, stream);
  } else if (log_b == 0) {
    return launch_tc<D, true>(psi, out, w, n_amps, log_b, flips, nflips,
                              masks, wants, phase, nphases, stream);
  } else {
    return launch_tc<D, false>(psi, out, w, n_amps, log_b, flips, nflips,
                               masks, wants, phase, nphases, stream);
  }
}

}  // namespace

// psi, out: (2, n_amps) float32, 16-byte aligned; w: (2, D, D) float32 with
// D = 2^log_d; B = 2^log_b.  Returns the launch's cudaGetLastError().
extern "C" int qbot_window_apply(const float* psi, float* out, const float* w,
                                 int64_t n_amps, int log_d, int log_b,
                                 const int64_t* flips, int nflips,
                                 const int64_t* masks, const int64_t* wants,
                                 const float* phase, int nphases,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_d) {
    case 1: return launch<2>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s);
    case 2: return launch<4>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s);
    case 3: return launch<8>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s);
    case 4: return launch<16>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s);
    case 5: return launch<32>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s);
    case 6: return launch<64>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s);
    case 7: return launch<128>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* qbot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
