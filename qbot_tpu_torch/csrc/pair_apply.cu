// Pair kernel of the planar statevector executor: two adjacent windows in
// one pass over the state.
//
// Replaces the TPU kernels _pair_b1 (qbot_tpu/tpu/kernels.py:352, the
// trailing pair, B == 1) and _pair_bt (qbot_tpu/tpu/kernels.py:420, the
// middle pair, B >= 128 with D1 <= 32):
//
//   out[a, i, l, b] = sum_{j,m} W1[i, j] * W2[l, m] * (Phi F p)[a, j, m, b]
//
// on one planar float32 state (re plane, then im plane, 2^n floats each)
// viewed as (A, D1, D2, B).  F and Phi are the fused flips and phases of
// window_apply.cu, applied at load from global flat indices, before both
// unitaries.  W1 and W2 arrive as (2, D, D), not transposed.
//
// Which widths take which variant (chosen here, by geometry, before the
// launch; a geometry is never retried on another variant):
// - D1 >= 8 and D2 >= 8, trailing or middle: on the tensor cores,
//   pair_tc_kernel (pair_tc.cuh: 3xTF32 products) in f32 and f32_mix,
//   pair_bf16_kernel (pair_bf16.cuh: BF16 m16n8k16) in bf16_3x and bf16;
// - D1 in {2, 4} and D2 >= 8, the narrow pair of the brickwork at n = 1, 2
//   (mod 7): the D2 window's tensor-core tile with W1 mixed into its
//   operand as it is staged (window_tc.cuh in f32 and f32_mix,
//   window_bf16.cuh in bf16_3x and bf16, instantiated with D1 > 1);
// - D1 and D2 in {2, 4}, below the tile's k-step and n-tile of 8: the
//   streaming pair_fma_stream_kernel (pair_stream.cu), FP32 FMAs on
//   registers (plans at window = 1, 2 reach it as middle pairs);
// - D1 >= 8 with D2 in {2, 4}: pair_apply_kernel, FP32 FMAs from slabs in
//   shared memory.  No plan produces this geometry (the compiler's last
//   window is min(n, 7) wide and its narrow windows come first), so only a
//   direct pair_apply call reaches it.
// Each in the precision of the products the caller asks for (tc_tile.cuh:
// Prec): F32 for the f32 and f32_mix modes, BF16X3 and BF16 for bf16_3x and
// bf16, whose FMA variants split their operands into bf16 parts in
// registers.
//
// The shared-memory FMA variant (pair_apply_kernel, D1 >= 8 with D2 = 2,
// 4; no plan reaches it), bound by the card's 67 TFLOP/s FP32 rate: every
// output amplitude depends on the whole (D1, D2) slab of its (a, b), so a
// block holds S whole slabs in shared memory (S * D1 * D2 <= 16384 complex
// amplitudes, at most 32 slabs).  Trailing pair: S consecutive a, each
// slab contiguous in memory, kept row by row.  Middle pair: S consecutive
// b of one a, read and written in runs of S floats and kept in that order,
// b fastest.  The block then runs two GEMMs on the slabs, W1 first, as the
// reference's pair kernels (so the reduced modes round the same
// intermediate Y):
//   phase 1  Y = W1 X  over the columns (s, m); a column sweep covers every
//            row i, so it writes Y back over its own columns of X in place;
//   phase 2  out = Y W2^T  over the rows (s, i), stored to device memory.
// Each thread keeps a TM x TN tile of complex accumulators, its TN columns
// two runs of 4, every operand masked at the slabs' ragged edges.
// The matrices stream through two shared-memory buffers in BK-deep chunks,
// the next chunk copied by cp.async while the block computes on the
// current one; the slab loads LU amplitudes a thread at once.  Rows are
// padded by 4 floats so the row operands of neighbouring threads fall in
// distinct banks.
#include "pair_tc.cuh"
#include "window_tc.cuh"

// The launcher of the streaming pair at D1 = 2^log_d1 and D2 = 2^args.
// log_d2, both 2 or 4, in one precision of the products (tc_tile.cuh:
// Prec), trailing (args.log_b == 0) or middle; returns the launch's
// cudaGetLastError().  Defined in pair_stream.cu, once per precision.
template <int PREC>
int pair_stream_launch(int log_d1, const PairArgs& args);

namespace {

// ---------------------------------------------------------------------------
// D1 >= 8 with D2 < 8: FP32 FMAs from shared-memory slabs
// ---------------------------------------------------------------------------

constexpr int NT = 256;          // threads per block
constexpr int TM = 4;            // output rows per thread
constexpr int TN = 8;            // output columns per thread: two runs of 4
constexpr int BK = 16;           // depth of a streamed matrix chunk
constexpr int WROW = 132;        // chunk row in shared memory: 128 + 4 pad
constexpr int PAD = 4;           // pad of a slab row in shared memory
constexpr int MAX_TILE = 16384;  // complex amplitudes a block holds
constexpr int MAX_S = 32;        // slabs a block holds
constexpr int LU = 16;           // slab amplitudes a thread loads at once
constexpr int WBUF = 2 * BK * WROW;  // floats of one chunk buffer (re, im)

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

// c += a b, complex, in FP32 FMAs
__device__ __forceinline__ void cfma(float& cr, float& ci, float ar, float ai,
                                     float br, float bi) {
  cr = fmaf(ar, br, cr);
  cr = fmaf(-ai, bi, cr);
  ci = fmaf(ar, bi, ci);
  ci = fmaf(ai, br, ci);
}

// x = hi + lo of n values, each rounded to bf16
template <int n>
__device__ __forceinline__ void split_parts(const float (&x)[n],
                                            float (&hi)[n], float (&lo)[n]) {
#pragma unroll
  for (int k = 0; k < n; ++k) {
    hi[k] = round_bf16(x[k]);
    lo[k] = round_bf16(__fsub_rn(x[k], hi[k]));
  }
}

// acc += a b over a TM x TN tile: PREC F32 in FP32 FMAs; BF16X3 and BF16
// split both operands into bf16 parts where they are used (so phase 2
// splits the FP32 Y anew, as the reference's second _dot does) and sum the
// products of parts (exact in FP32) by FP32 FMAs: hi hi, hi lo and lo hi,
// or hi hi
template <int PREC>
__device__ __forceinline__ void cmac(float (&acc_r)[TM][TN],
                                     float (&acc_i)[TM][TN],
                                     const float (&ar)[TM],
                                     const float (&ai)[TM],
                                     const float (&br)[TN],
                                     const float (&bi)[TN]) {
  if constexpr (PREC == F32) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int t = 0; t < TN; ++t)
        cfma(acc_r[r][t], acc_i[r][t], ar[r], ai[r], br[t], bi[t]);
    }
  } else {
    float arh[TM], arl[TM], aih[TM], ail[TM];
    float brh[TN], brl[TN], bih[TN], bil[TN];
    split_parts(ar, arh, arl);
    split_parts(ai, aih, ail);
    split_parts(br, brh, brl);
    split_parts(bi, bih, bil);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        cfma(acc_r[r][t], acc_i[r][t], arh[r], aih[r], brh[t], bih[t]);
        if constexpr (PREC == BF16X3) {
          cfma(acc_r[r][t], acc_i[r][t], arh[r], aih[r], brl[t], bil[t]);
          cfma(acc_r[r][t], acc_i[r][t], arl[r], ail[r], brh[t], bih[t]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc_r)[TM][TN],
                                     float (&acc_i)[TM][TN]) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      acc_r[r][t] = 0.f;
      acc_i[r][t] = 0.f;
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// column of a thread's t-th output: two runs of 4, nx threads apart
__device__ __forceinline__ int col_of(int t, int tx, int nx) {
  return (t >> 2) * 4 * nx + tx * 4 + (t & 3);
}

// TRAILING: slabs s are consecutive a (B == 1), element (j, m) of slab s at
// flat index base + s * D1 * D2 + j * D2 + m.  Otherwise slabs are
// consecutive b, element (j, m) at base + s + (j * D2 + m) * B.
template <bool TRAILING, int PREC>
__global__ void __launch_bounds__(NT, 1)
    pair_apply_kernel(const float* __restrict__ psi, float* __restrict__ out,
                      const float* __restrict__ w1,
                      const float* __restrict__ w2, int64_t n_amps,
                      int log_d1, int log_d2, int log_b, int log_s,
                      const int64_t* __restrict__ flips, int nflips,
                      const int64_t* __restrict__ masks,
                      const int64_t* __restrict__ wants,
                      const float* __restrict__ phase, int nphases) {
  extern __shared__ __align__(16) float smem[];
  const int D1 = 1 << log_d1, D2 = 1 << log_d2, S = 1 << log_s;
  const int slab = D1 * D2;
  // shared-memory strides of element (s, j, m), in floats
  const int JS = TRAILING ? D2 + PAD : D2 * S + PAD;
  const int MS = TRAILING ? 1 : S;
  const int SS = TRAILING ? D1 * JS : 1;
  const int plane = TRAILING ? S * SS : D1 * JS;
  float* xr = smem;
  float* xi = smem + plane;
  float* wbuf = smem + 2 * plane;  // two [2][BK][WROW] matrix chunks
  const int tid = threadIdx.x;
  psi += particle_offset(n_amps);
  out += particle_offset(n_amps);

  int64_t base, sl_step, el_step;
  if (TRAILING) {
    base = int64_t(blockIdx.x) * S * slab;
    sl_step = slab;
    el_step = 1;
  } else {
    const int log_tiles = log_b - log_s;  // b-tiles per a
    const int64_t a = int64_t(blockIdx.x) >> log_tiles;
    const int64_t bt = int64_t(blockIdx.x) & ((int64_t(1) << log_tiles) - 1);
    base = ((a * slab) << log_b) + (bt << log_s);
    sl_step = 1;
    el_step = int64_t(1) << log_b;
  }

  // load the slabs in memory order, flips and phases applied, LU loads of
  // a thread in flight at once
  for (int e0 = tid; e0 < S * slab; e0 += NT * LU) {
    float vr[LU], vi[LU];
    int64_t g[LU];
    int x[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int e = e0 + u * NT;
      int s, j, m;
      if (TRAILING) {
        s = e >> (log_d1 + log_d2);
        j = (e >> log_d2) & (D1 - 1);
        m = e & (D2 - 1);
      } else {
        s = e & (S - 1);
        m = (e >> log_s) & (D2 - 1);
        j = e >> (log_s + log_d2);
      }
      g[u] = base + s * sl_step + int64_t(j * D2 + m) * el_step;
      x[u] = s * SS + j * JS + m * MS;
      if (e < S * slab) {
        vr[u] = psi[g[u]];
        vi[u] = psi[n_amps + g[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      if (e0 + u * NT < S * slab) {
        apply_diagonals(g[u], vr[u], vi[u], flips, nflips, masks, wants,
                        phase, nphases);
        xr[x[u]] = vr[u];
        xi[x[u]] = vi[u];
      }
    }
  }
  __syncthreads();

  float acc_r[TM][TN], acc_i[TM][TN];

  // phase 1: Y[(s, i), m] = sum_j W1[i, j] * X[(s, j), m], in place
  {
    const int cols = S * D2;
    const int ny_want = D1 / TM > 0 ? D1 / TM : 1;
    const int ny = ny_want < NT ? ny_want : NT;  // threads along i
    const int nx = NT / ny;
    const int tx = tid % nx, ty = tid / nx;
    // one sweep covers every row i (D1 <= NT TM), so it writes Y back over
    // its own columns of X in place
    const int rows_sweep = ny * TM < D1 ? ny * TM : D1;
    const int kc = D1 < BK ? D1 : BK;
    for (int c0 = 0; c0 < cols; c0 += nx * TN) {
      // column c = (s, m): m fastest in the trailing pair, s in the middle
      // one, so a run of 4 columns is contiguous in shared memory
      int coff[TN];
      bool cok[TN];
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int c = c0 + col_of(t, tx, nx);
        const int s = TRAILING ? c >> log_d2 : c & (S - 1);
        const int m = TRAILING ? c & (D2 - 1) : c >> log_s;
        cok[t] = c < cols;
        coff[t] = s * SS + m * MS;
      }
      // chunk c of W1^T: wr[k][i] = W1[i, c * kc + k]
      auto fetch = [&](int c) {
        float* wr = wbuf + (c & 1) * WBUF;
        float* wi = wr + BK * WROW;
        for (int e = tid; e < kc * rows_sweep; e += NT) {
          const int k = e % kc, i = e / kc;
          cp_async4(wr + k * WROW + i, w1 + i * D1 + c * kc + k);
          cp_async4(wi + k * WROW + i, w1 + D1 * D1 + i * D1 + c * kc + k);
        }
        cp_async_commit();
      };
      zero(acc_r, acc_i);
      fetch(0);
      for (int c = 0; c < D1 / kc; ++c) {
        if (c + 1 < D1 / kc) {
          fetch(c + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int j0 = c * kc;
        const float* wr = wbuf + (c & 1) * WBUF;
        const float* wi = wr + BK * WROW;
#pragma unroll 4
        for (int k = 0; k < kc; ++k) {
          float ar[TM], ai[TM], br[TN], bi[TN];
          const int krow = (j0 + k) * JS;
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const bool ok = ty * TM + r < rows_sweep;
            ar[r] = ok ? wr[k * WROW + ty * TM + r] : 0.f;
            ai[r] = ok ? wi[k * WROW + ty * TM + r] : 0.f;
          }
#pragma unroll
          for (int t = 0; t < TN; ++t) {
            br[t] = cok[t] ? xr[coff[t] + krow] : 0.f;
            bi[t] = cok[t] ? xi[coff[t] + krow] : 0.f;
          }
          cmac<PREC>(acc_r, acc_i, ar, ai, br, bi);
        }
        __syncthreads();
      }
      // every read of these columns is behind the barrier above
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int i = ty * TM + r;
        if (i >= rows_sweep) continue;
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          if (!cok[t]) continue;
          xr[coff[t] + i * JS] = acc_r[r][t];
          xi[coff[t] + i * JS] = acc_i[r][t];
        }
      }
    }
  }
  __syncthreads();

  // phase 2: out[(s, i), l] = sum_m Y[(s, i), m] * W2[l, m]
  {
    const int nx = D2 >= TN ? D2 / TN : 1;  // threads along l
    const int ny = NT / nx;
    const int tx = tid % nx, ty = tid / nx;
    const int rows = S * D1;
    const int kc = D2 < BK ? D2 : BK;
    for (int r0 = 0; r0 < rows; r0 += ny * TM) {
      // row (s, i): TM consecutive rows are consecutive i (trailing) or
      // consecutive s (middle)
      int roff[TM];
      int64_t rmem[TM];
      bool rok[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int row = r0 + ty * TM + r;
        const int s = TRAILING ? row >> log_d1 : row & (S - 1);
        const int i = TRAILING ? row & (D1 - 1) : row >> log_s;
        rok[r] = row < rows;
        roff[r] = s * SS + i * JS;
        rmem[r] = base + s * sl_step + int64_t(i) * D2 * el_step;
      }
      // chunk c of W2^T: wr[k][l] = W2[l, c * kc + k]
      auto fetch = [&](int c) {
        float* wr = wbuf + (c & 1) * WBUF;
        float* wi = wr + BK * WROW;
        for (int e = tid; e < kc * D2; e += NT) {
          const int k = e % kc, l = e / kc;
          cp_async4(wr + k * WROW + l, w2 + l * D2 + c * kc + k);
          cp_async4(wi + k * WROW + l, w2 + D2 * D2 + l * D2 + c * kc + k);
        }
        cp_async_commit();
      };
      zero(acc_r, acc_i);
      fetch(0);
      for (int c = 0; c < D2 / kc; ++c) {
        if (c + 1 < D2 / kc) {
          fetch(c + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int m0 = c * kc;
        const float* wr = wbuf + (c & 1) * WBUF;
        const float* wi = wr + BK * WROW;
#pragma unroll 4
        for (int k = 0; k < kc; ++k) {
          float ar[TM], ai[TM], br[TN], bi[TN];
          const int xk = (m0 + k) * MS;
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            ar[r] = rok[r] ? xr[roff[r] + xk] : 0.f;
            ai[r] = rok[r] ? xi[roff[r] + xk] : 0.f;
          }
#pragma unroll
          for (int t = 0; t < TN; ++t) {
            const int l = col_of(t, tx, nx);
            br[t] = l < D2 ? wr[k * WROW + l] : 0.f;
            bi[t] = l < D2 ? wi[k * WROW + l] : 0.f;
          }
          cmac<PREC>(acc_r, acc_i, ar, ai, br, bi);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          const int l = col_of(t, tx, nx);
          if (!rok[r] || l >= D2) continue;
          out[rmem[r] + l * el_step] = acc_r[r][t];
          out[n_amps + rmem[r] + l * el_step] = acc_i[r][t];
        }
      }
    }
  }
}

int smem_bytes(bool trailing, int log_d1, int log_d2, int log_s) {
  const int D1 = 1 << log_d1, D2 = 1 << log_d2, S = 1 << log_s;
  const int plane = trailing ? S * D1 * (D2 + PAD) : D1 * (D2 * S + PAD);
  return static_cast<int>(sizeof(float)) * (2 * plane + 2 * WBUF);
}

template <bool TRAILING, int PREC>
int launch(const float* psi, float* out, const float* w1, const float* w2,
           int64_t n_amps, int log_d1, int log_d2, int log_b, int log_s,
           int64_t blocks, int particles, const int64_t* flips, int nflips,
           const int64_t* masks, const int64_t* wants, const float* phase,
           int nphases, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only once the kernel allows it
  // (a per-device attribute, so set at every launch)
  const int smem = smem_bytes(TRAILING, log_d1, log_d2, log_s);
  const cudaError_t err = cudaFuncSetAttribute(
      pair_apply_kernel<TRAILING, PREC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_apply_kernel<TRAILING, PREC>
      <<<dim3(static_cast<unsigned>(blocks), particles), NT, smem, stream>>>(
          psi, out, w1, w2, n_amps, log_d1, log_d2, log_b, log_s, flips,
          nflips, masks, wants, phase, nphases);
  return static_cast<int>(cudaGetLastError());
}

int log2_floor(int64_t x) {
  int k = 0;
  while ((int64_t(1) << (k + 1)) <= x) ++k;
  return k;
}

template <int PREC>
int launch_tc_any(int log_d1, bool middle, const PairArgs& args) {
  if (middle) {
    switch (log_d1) {
      case 3: return pair_tc_launch<8, true, PREC>(args);
      case 4: return pair_tc_launch<16, true, PREC>(args);
      case 5: return pair_tc_launch<32, true, PREC>(args);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (log_d1) {
    case 3: return pair_tc_launch<8, false, PREC>(args);
    case 4: return pair_tc_launch<16, false, PREC>(args);
    case 5: return pair_tc_launch<32, false, PREC>(args);
    case 6: return pair_tc_launch<64, false, PREC>(args);
    case 7: return pair_tc_launch<128, false, PREC>(args);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int PREC>
int launch_pair(const float* psi, float* out, const float* w1,
                const float* w2, int64_t n_amps, int particles, int log_d1,
                int log_d2, int log_b, const int64_t* flips, int nflips,
                const int64_t* masks, const int64_t* wants,
                const float* phase, int nphases, cudaStream_t s) {
  const PairArgs args{psi,   out,    w1,    w2,      n_amps, log_d2,
                      log_b, flips,  nflips, masks,  wants,  phase,
                      nphases, s,    particles};
  if (log_d1 >= 3 && log_d2 >= 3)
    return launch_tc_any<PREC>(log_d1, log_b != 0, args);
  if (log_d1 <= 2 && log_d2 <= 2)
    return pair_stream_launch<PREC>(log_d1, args);
  if (log_d2 >= 3) {
    // the narrow pair: the D2 window with W = W2, W1 mixed in as it stages
    const WindowArgs a{psi,    out,   w2,    n_amps, log_d2, log_b,
                       flips,  nflips, masks, wants, phase,  nphases,
                       s,      w1,    particles};
    return log_d1 == 1 ? window_tc_launch<2, PREC>(a)
                       : window_tc_launch<4, PREC>(a);
  }
  const int log_a = log2_floor(n_amps) - log_d1 - log_d2 - log_b;
  // slabs a block holds: up to MAX_TILE amplitudes and MAX_S slabs
  int log_s = log2_floor(MAX_TILE) - log_d1 - log_d2;
  if (log_s > log2_floor(MAX_S)) log_s = log2_floor(MAX_S);
  if (log_b == 0 && log_s > log_a) log_s = log_a;
  // the padded rows of narrow slabs (D2 = 4 at D1 = 128) take more than
  // the 227 KiB a block has at MAX_TILE amplitudes
  while (log_s > 0 &&
         smem_bytes(log_b == 0, log_d1, log_d2, log_s) > MAX_SMEM)
    --log_s;
  if (log_b == 0)
    return launch<true, PREC>(psi, out, w1, w2, n_amps, log_d1, log_d2, 0,
                              log_s, int64_t(1) << (log_a - log_s),
                              particles, flips, nflips, masks, wants, phase,
                              nphases, s);
  return launch<false, PREC>(psi, out, w1, w2, n_amps, log_d1, log_d2, log_b,
                             log_s, int64_t(1) << (log_a + log_b - log_s),
                             particles, flips, nflips, masks, wants, phase,
                             nphases, s);
}

}  // namespace

// psi, out: (particles, 2, n_amps) float32, 16-byte aligned, one launch for
// all the particles (tc_tile.cuh: particle_offset); w1: (2, D1, D1), w2:
// (2, D2, D2) float32, w2 16-byte aligned, with Di = 2^log_di; B = 2^log_b;
// prec: the precision of the products (tc_tile.cuh: Prec).  B == 1 runs the
// trailing pair, B >= 128 with D1 <= 32 the middle pair; other geometries
// are refused (the caller runs two windows).  Returns the launch's
// cudaGetLastError().
extern "C" int qbot_pair_apply(const float* psi, float* out, const float* w1,
                               const float* w2, int64_t n_amps,
                               int particles, int log_d1, int log_d2,
                               int log_b, const int64_t* flips, int nflips,
                               const int64_t* masks, const int64_t* wants,
                               const float* phase, int nphases, int prec,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_d1 < 1 || log_d1 > 7 || log_d2 < 1 || log_d2 > 7 ||
      (n_amps >> (log_d1 + log_d2 + log_b)) < 1 || particles < 1 ||
      particles > MAX_PARTICLES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (log_b != 0 && (log_b < 7 || log_d1 > 5))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (prec) {
    case F32:
      return launch_pair<F32>(psi, out, w1, w2, n_amps, particles, log_d1,
                              log_d2, log_b, flips, nflips, masks, wants,
                              phase, nphases, s);
    case BF16X3:
      return launch_pair<BF16X3>(psi, out, w1, w2, n_amps, particles, log_d1,
                                 log_d2, log_b, flips, nflips, masks, wants,
                                 phase, nphases, s);
    case BF16:
      return launch_pair<BF16>(psi, out, w1, w2, n_amps, particles, log_d1,
                               log_d2, log_b, flips, nflips, masks, wants,
                               phase, nphases, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
