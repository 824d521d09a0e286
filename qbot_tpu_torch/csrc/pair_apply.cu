// Pair kernel of the planar statevector executor: two adjacent windows in
// one pass over the state.
//
// Replaces the TPU kernels _pair_b1 (qbot_tpu/tpu/kernels.py:351, the
// trailing pair, B == 1) and _pair_bt (qbot_tpu/tpu/kernels.py:419, the
// middle pair, B >= 128 with D1 <= 32) with one kernel in two variants:
//
//   out[a, i, l, b] = sum_{j,m} W1[i, j] * W2[l, m] * (Phi F p)[a, j, m, b]
//
// on one planar float32 state (re plane, then im plane, 2^n floats each)
// viewed as (A, D1, D2, B).  F and Phi are the fused flips and phases of
// window_apply.cu, applied at load from global flat indices, before both
// unitaries.  W1 and W2 arrive as (2, D, D), not transposed.
//
// What bounds it on an H100: a pair does the FLOPs of its two windows,
// 8 * (D1 + D2) per complex amplitude, and saves one of their two state
// passes.  At 26 qubits the (128, 128) pair does 137 GFLOP against 1 GiB of
// traffic (0.3 ms at 3.35 TB/s), about 2 ms at the card's 67 TFLOP/s FP32
// rate: it is bound by FP32 FMA throughput, and saving the pass buys little.
// The products stay in true FP32 FMAs (no TF32 tensor cores).
//
// Design: every output amplitude depends on the whole (D1, D2) slab of its
// (a, b), so a block holds S whole slabs in shared memory (S * D1 * D2 <=
// 16384 complex amplitudes, about 130 KiB: one block of 8 warps per SM at
// the widest pair).  Trailing pair: S consecutive a, each slab contiguous
// in memory, kept row by row.  Middle pair: S consecutive b of one a, read
// and written in runs of S floats (S = 4 at D1 = 32, D2 = 128: 16-byte
// runs, a coalescing cost) and kept in that order, b fastest.  The block
// then runs two GEMMs on the slabs:
//   phase 1  Y = X W2^T  over the rows (s, j); a row sweep covers every
//            column l, so it writes Y back over its own rows of X in place;
//   phase 2  out = W1 Y  over the columns (s, l), stored to device memory.
// Each thread keeps a TM x TN tile of complex accumulators; its TN columns
// are two runs of 4, so at the geometries of the 26-qubit paths (FULL: no
// ragged edge) the column operands and the W1 rows load as float4.  The
// matrices stream through two shared-memory buffers in BK-deep chunks, the
// next chunk copied by cp.async while the block computes on the current
// one; the slab loads LU amplitudes a thread at once.  Rows are padded by 4
// floats so the row operands of neighbouring threads fall in distinct
// banks.  A faster kernel would use wgmma or a 3xTF32 split, and clusters
// to share a slab.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
      const float zr = phase[p], zi = phase[nphases + p];
      const float r = xr * zr - xi * zi;
      const float i = xr * zi + xi * zr;
      xr = r;
      xi = i;
    }
  }
}

__device__ __forceinline__ void cmac(float (&acc_r)[TM][TN],
                                     float (&acc_i)[TM][TN],
                                     const float (&ar)[TM],
                                     const float (&ai)[TM],
                                     const float (&br)[TN],
                                     const float (&bi)[TN]) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      acc_r[r][t] = fmaf(ar[r], br[t], acc_r[r][t]);
      acc_r[r][t] = fmaf(-ai[r], bi[t], acc_r[r][t]);
      acc_i[r][t] = fmaf(ar[r], bi[t], acc_i[r][t]);
      acc_i[r][t] = fmaf(ai[r], br[t], acc_i[r][t]);
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// column of a thread's t-th output: two runs of 4, nx threads apart
__device__ __forceinline__ int col_of(int t, int tx, int nx) {
  return (t >> 2) * 4 * nx + tx * 4 + (t & 3);
}

// TRAILING: slabs s are consecutive a (B == 1), element (j, m) of slab s at
// flat index base + s * D1 * D2 + j * D2 + m.  Otherwise slabs are
// consecutive b, element (j, m) at base + s + (j * D2 + m) * B.  FULL: the
// geometry has no ragged edge (D2 >= 8, D1 >= 4, S * D1 * D2 >= 8192), so
// no operand is masked and runs of 4 load as float4.
template <bool TRAILING, bool FULL>
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

  // phase 1: Y[(s, j), l] = sum_m X[(s, j), m] * W2[l, m], in place
  {
    const int nx = D2 >= TN ? D2 / TN : 1;  // threads along l
    const int ny = NT / nx;
    const int tx = tid % nx, ty = tid / nx;
    const int rows = S * D1;
    const int kc = D2 < BK ? D2 : BK;
    for (int r0 = 0; r0 < rows; r0 += ny * TM) {
      int roff[TM];
      bool rok[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int row = r0 + ty * TM + r;
        const int s = TRAILING ? row >> log_d1 : row & (S - 1);
        const int j = TRAILING ? row & (D1 - 1) : row >> log_s;
        rok[r] = FULL || row < rows;
        roff[r] = s * SS + j * JS;
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
          if (FULL) {
            load4(br, wr + k * WROW + tx * 4);
            load4(br + 4, wr + k * WROW + 4 * nx + tx * 4);
            load4(bi, wi + k * WROW + tx * 4);
            load4(bi + 4, wi + k * WROW + 4 * nx + tx * 4);
          } else {
#pragma unroll
            for (int t = 0; t < TN; ++t) {
              const int l = col_of(t, tx, nx);
              br[t] = l < D2 ? wr[k * WROW + l] : 0.f;
              bi[t] = l < D2 ? wi[k * WROW + l] : 0.f;
            }
          }
          cmac(acc_r, acc_i, ar, ai, br, bi);
        }
        __syncthreads();
      }
      // every read of these rows is behind the barrier above
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          const int l = col_of(t, tx, nx);
          if (rok[r] && (FULL || l < D2)) {
            xr[roff[r] + l * MS] = acc_r[r][t];
            xi[roff[r] + l * MS] = acc_i[r][t];
          }
        }
      }
    }
  }
  __syncthreads();

  // phase 2: out[i, (s, l)] = sum_j W1[i, j] * Y[(s, j), l]
  {
    const int cols = S * D2;
    const int ny_want = D1 / TM > 0 ? D1 / TM : 1;
    const int ny = ny_want < NT ? ny_want : NT;  // threads along i
    const int nx = NT / ny;
    const int tx = tid % nx, ty = tid / nx;
    const int rows_sweep = ny * TM < D1 ? ny * TM : D1;
    const int kc = D1 < BK ? D1 : BK;
    for (int i0 = 0; i0 < D1; i0 += ny * TM) {
      for (int c0 = 0; c0 < cols; c0 += nx * TN) {
        // column c = (s, l): l fastest in the trailing pair, s in the
        // middle one, so a run of 4 columns is contiguous in shared and in
        // device memory
        int coff[TN];
        int64_t cmem[TN];
        bool cok[TN];
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          const int c = c0 + col_of(t, tx, nx);
          const int s = TRAILING ? c >> log_d2 : c & (S - 1);
          const int l = TRAILING ? c & (D2 - 1) : c >> log_s;
          cok[t] = FULL || c < cols;
          coff[t] = s * SS + l * MS;
          cmem[t] = base + s * sl_step + l * el_step;
        }
        // chunk c of W1^T: wr[k][i] = W1[i0 + i, c * kc + k]
        auto fetch = [&](int c) {
          float* wr = wbuf + (c & 1) * WBUF;
          float* wi = wr + BK * WROW;
          for (int e = tid; e < kc * rows_sweep; e += NT) {
            const int k = e % kc, i = e / kc;
            cp_async4(wr + k * WROW + i, w1 + (i0 + i) * D1 + c * kc + k);
            cp_async4(wi + k * WROW + i,
                      w1 + D1 * D1 + (i0 + i) * D1 + c * kc + k);
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
            if (FULL) {
              load4(ar, wr + k * WROW + ty * TM);
              load4(ai, wi + k * WROW + ty * TM);
              load4(br, xr + coff[0] + krow);
              load4(br + 4, xr + coff[4] + krow);
              load4(bi, xi + coff[0] + krow);
              load4(bi + 4, xi + coff[4] + krow);
            } else {
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
            }
            cmac(acc_r, acc_i, ar, ai, br, bi);
          }
          __syncthreads();
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const int i = i0 + ty * TM + r;
          if (!FULL && ty * TM + r >= rows_sweep) continue;
          const int64_t irow = int64_t(i) * D2 * el_step;
          if (FULL) {
#pragma unroll
            for (int g = 0; g < TN; g += 4) {
              const int64_t m = cmem[g] + irow;
              *reinterpret_cast<float4*>(out + m) = make_float4(
                  acc_r[r][g], acc_r[r][g + 1], acc_r[r][g + 2],
                  acc_r[r][g + 3]);
              *reinterpret_cast<float4*>(out + n_amps + m) = make_float4(
                  acc_i[r][g], acc_i[r][g + 1], acc_i[r][g + 2],
                  acc_i[r][g + 3]);
            }
          } else {
#pragma unroll
            for (int t = 0; t < TN; ++t) {
              if (!cok[t]) continue;
              out[cmem[t] + irow] = acc_r[r][t];
              out[n_amps + cmem[t] + irow] = acc_i[r][t];
            }
          }
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

template <bool TRAILING, bool FULL>
int launch(const float* psi, float* out, const float* w1, const float* w2,
           int64_t n_amps, int log_d1, int log_d2, int log_b, int log_s,
           int64_t blocks, const int64_t* flips, int nflips,
           const int64_t* masks, const int64_t* wants, const float* phase,
           int nphases, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory only once the kernel allows it
  // (a per-device attribute, so set at every launch)
  const int smem = smem_bytes(TRAILING, log_d1, log_d2, log_s);
  const cudaError_t err = cudaFuncSetAttribute(
      pair_apply_kernel<TRAILING, FULL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_apply_kernel<TRAILING, FULL>
      <<<static_cast<unsigned>(blocks), NT, smem, stream>>>(
          psi, out, w1, w2, n_amps, log_d1, log_d2, log_b, log_s, flips,
          nflips, masks, wants, phase, nphases);
  return static_cast<int>(cudaGetLastError());
}

template <bool TRAILING>
int launch_geometry(bool full, const float* psi, float* out, const float* w1,
                    const float* w2, int64_t n_amps, int log_d1, int log_d2,
                    int log_b, int log_s, int64_t blocks,
                    const int64_t* flips, int nflips, const int64_t* masks,
                    const int64_t* wants, const float* phase, int nphases,
                    cudaStream_t stream) {
  if (full)
    return launch<TRAILING, true>(psi, out, w1, w2, n_amps, log_d1, log_d2,
                                  log_b, log_s, blocks, flips, nflips, masks,
                                  wants, phase, nphases, stream);
  return launch<TRAILING, false>(psi, out, w1, w2, n_amps, log_d1, log_d2,
                                 log_b, log_s, blocks, flips, nflips, masks,
                                 wants, phase, nphases, stream);
}

int ilog2(int64_t x) {
  int k = 0;
  while ((int64_t(1) << (k + 1)) <= x) ++k;
  return k;
}

}  // namespace

// psi, out: (2, n_amps) float32; w1: (2, D1, D1), w2: (2, D2, D2) float32
// with Di = 2^log_di; B = 2^log_b.  B == 1 runs the trailing pair, B >= 128
// with D1 <= 32 the middle pair; other geometries are refused (the caller
// runs two windows).  Returns the launch's cudaGetLastError().
extern "C" int qbot_pair_apply(const float* psi, float* out, const float* w1,
                               const float* w2, int64_t n_amps, int log_d1,
                               int log_d2, int log_b, const int64_t* flips,
                               int nflips, const int64_t* masks,
                               const int64_t* wants, const float* phase,
                               int nphases, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_d1 < 1 || log_d1 > 7 || log_d2 < 1 || log_d2 > 7 ||
      (n_amps >> (log_d1 + log_d2 + log_b)) < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int log_a = ilog2(n_amps) - log_d1 - log_d2 - log_b;
  // slabs a block holds: up to MAX_TILE amplitudes and MAX_S slabs
  int log_s = ilog2(MAX_TILE) - log_d1 - log_d2;
  if (log_s > ilog2(MAX_S)) log_s = ilog2(MAX_S);
  if (log_b == 0) {
    if (log_s > log_a) log_s = log_a;
  } else if (log_b < 7 || log_d1 > 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool full = log_d2 >= 3 && log_d1 >= 2 &&
                    log_s + log_d1 + log_d2 >= 13;
  if (log_b == 0)
    return launch_geometry<true>(full, psi, out, w1, w2, n_amps, log_d1,
                                 log_d2, 0, log_s,
                                 int64_t(1) << (log_a - log_s), flips, nflips,
                                 masks, wants, phase, nphases, s);
  return launch_geometry<false>(full, psi, out, w1, w2, n_amps, log_d1,
                                log_d2, log_b, log_s,
                                int64_t(1) << (log_a + log_b - log_s), flips,
                                nflips, masks, wants, phase, nphases, s);
}
