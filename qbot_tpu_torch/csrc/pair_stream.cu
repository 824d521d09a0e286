// The streaming pair of the narrow widths, D1, D2 = 2, 4, in one precision
// of the products, given as the define QBOT_PREC (tc_tile.cuh: Prec).
// pair_apply.cu's qbot_pair_apply calls its launcher, pair_stream_launch;
// tpu/kernels.py:build_kernels compiles this source once per precision,
// in parallel with the other objects.
#include "fma_stream.cuh"
#include "pair_tc.cuh"

namespace {

// One element of a product in a dot mode as the plain version forms it
// (tpu/kernels.py: pair_apply_ref, _mode_bmm): for the row w[part][k] =
// (re, im) of W's parts and the K values x[part][plane][k],
//   re = M(Wr, xr) - M(Wi, xi),  im = M(Wr, xi) + M(Wi, xr),
//   M(a, b) = (E(a_hi, b_hi) + E(a_hi, b_lo)) + E(a_lo, b_hi)   (BF16X3),
//   M(a, b) = E(a_hi, b_hi) (BF16), E(a, b) (F32),
// each E a sum over k in order, one rounding a term: the products of bf16
// parts are exact in FP32, so an FMA rounds each sum as the einsum's
// in-order float32 sum does, and the reduced modes give the plain version's
// values bit for bit where it sums in that order
// (tests/test_torch_window_split.py: fma_pair_model).
template <int K, int PREC>
__device__ __forceinline__ void mode_cdot(
    const float2 (&w)[parts<PREC>()][K],
    const float (&x)[parts<PREC>()][2][K], float& re, float& im) {
  auto e = [&](int pw, bool wim, int px, int pl) {
    float s = __fmul_rn(wim ? w[pw][0].y : w[pw][0].x, x[px][pl][0]);
#pragma unroll
    for (int k = 1; k < K; ++k)
      s = fmaf(wim ? w[pw][k].y : w[pw][k].x, x[px][pl][k], s);
    return s;
  };
  auto m = [&](bool wim, int pl) {
    float s = e(0, wim, 0, pl);
    if constexpr (PREC == BF16X3) {
      s = __fadd_rn(s, e(0, wim, 1, pl));
      s = __fadd_rn(s, e(1, wim, 0, pl));
    }
    return s;
  };
  re = __fsub_rn(m(false, 0), m(true, 1));
  im = __fadd_rn(m(false, 1), m(true, 0));
}

// Row r of a W staged by stage_parts, read from shared memory each time it
// is called: the compiler would otherwise keep every row of both matrices
// in registers across the unrolled loops (a load it may reuse), and spill.
template <int K, int PREC>
__device__ __forceinline__ void load_row(const float2 (*ws)[K * K], int r,
                                         float2 (&w)[parts<PREC>()][K]) {
#pragma unroll
  for (int p = 0; p < parts<PREC>(); ++p) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned a = static_cast<unsigned>(
          __cvta_generic_to_shared(&ws[p][r * K + k]));
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(w[p][k].x), "=f"(w[p][k].y)
                   : "r"(a));
    }
  }
}

// The pair at D1, D2 = 2, 4 (_pair_bt at B >= 128, and _pair_b1 at B == 1,
// TRAIL), in every dot mode:
//
//   out[a, i, l, b] = sum_m W2[l, m] Y[a, i, m, b],
//   Y[a, i, m, b] = sum_j W1[i, j] (Phi F p)[a, j, m, b].
//
// The (j, m) axes together are one axis of S = D1 D2 <= 16 elements at
// stride B, so the pair streams as a window of width S does: each thread
// owns V consecutive b of one a (V S = 16 floats a plane at S >= 4) or one
// contiguous slab (TRAIL), walked by a grid of resident blocks; it loads
// the slab's S rows of each plane, applies the fused flips and phases in
// registers through the tables of a window of width S (fma_stream.cuh:
// stream_phases), forms Y = W1 (Phi F X) over j for each m, then
// out = Y W2^T over m for each i, each row stored as it is done.  Every
// element is read and written once.  In bf16_3x and bf16 X and W1 are
// split as the FMA window splits them, Y anew for the second product (the
// reference's second _dot); W1 and W2 are split once a block into shared
// memory, and a row of them is read into registers for each output row
// and reused over the thread's V columns.  The slab and Y take 2 S V = 32
// registers, the parts of a column and of a W row up to 32 more: at S = 4
// that fits the 80 registers of three blocks an SM, at S >= 8 it runs two
// (at 80, ptxas spilled).  Bound
// by the bytes in every mode: at 26 qubits and D1 = D2 = 4 the bf16_3x
// products take about 0.19 ms at 67 TFLOP/s, the bytes 0.32 ms.
template <int D1, int D2, int V, bool TRAIL, int PREC>
__global__ void __launch_bounds__(THREADS, D1 * D2 >= 8 ? 2 : 3)
    pair_fma_stream_kernel(const float* __restrict__ psi,
                           float* __restrict__ out,
                           const float* __restrict__ w1,
                           const float* __restrict__ w2, int64_t n_amps,
                           int log_b, const Diag diag) {
  static_assert(!TRAIL || V == 1, "a trailing thread owns one slab");
  constexpr int S = D1 * D2, LOG_S = ilog2(S);
  constexpr int PARTS = parts<PREC>();
  __shared__ float2 w1s[PARTS][D1 * D1], w2s[PARTS][D2 * D2];
  __shared__ uint32_t jtab[S];
  __shared__ float2 comb[1 << TABLE];
  __shared__ long long cmask[TABLE], cwant[TABLE];
  psi += particle_offset(n_amps);
  out += particle_offset(n_amps);
  stage_parts<D1, PREC>(w1, w1s);
  stage_parts<D2, PREC>(w2, w2s);
  diag_tables<S, false>(diag, log_b, jtab, comb, cmask, cwant);
  __syncthreads();

  const int64_t B = int64_t(1) << log_b;
  const int64_t groups = (n_amps >> LOG_S) / V;
  for (int64_t grp = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       grp < groups; grp += int64_t(gridDim.x) * blockDim.x) {
    const int64_t c = grp * V;
    // flat index of element (s = j D2 + m, v): base + s * stride + v
    const int64_t base =
        TRAIL ? c * S : ((c >> log_b) << (log_b + LOG_S)) | (c & (B - 1));
    const int64_t stride = TRAIL ? 1 : B;
    float x[2][S][V];  // [plane][s][v]: X, then Y
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      if constexpr (TRAIL) {
        const Vec<S> r = load_vec<S>(psi + pl * n_amps + base);
#pragma unroll
        for (int s = 0; s < S; ++s) x[pl][s][0] = r.v[s];
      } else {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const Vec<V> r = load_vec<V>(psi + pl * n_amps + base + s * B);
#pragma unroll
          for (int v = 0; v < V; ++v) x[pl][s][v] = r.v[v];
        }
      }
    }
    stream_phases<S, V>(x, base, stride, diag, jtab, comb, cmask, cwant);
    // Y over j, column m by column m, over X in place
#pragma unroll
    for (int m = 0; m < D2; ++m) {
      float xp[V][PARTS][2][D1];
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
          for (int j = 0; j < D1; ++j) {
            float part[PARTS];
            split_mode<PREC>(x[pl][j * D2 + m][v], part);
#pragma unroll
            for (int p = 0; p < PARTS; ++p) xp[v][p][pl][j] = part[p];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < D1; ++i) {
        float2 w[PARTS][D1];
        load_row<D1, PREC>(w1s, i, w);
#pragma unroll
        for (int v = 0; v < V; ++v)
          mode_cdot<D1, PREC>(w, xp[v], x[0][i * D2 + m][v],
                              x[1][i * D2 + m][v]);
      }
    }
    // out over m, row i by row i, stored as each is done
#pragma unroll
    for (int i = 0; i < D1; ++i) {
      float yp[V][PARTS][2][D2];
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
          for (int m = 0; m < D2; ++m) {
            float part[PARTS];
            split_mode<PREC>(x[pl][i * D2 + m][v], part);
#pragma unroll
            for (int p = 0; p < PARTS; ++p) yp[v][p][pl][m] = part[p];
          }
        }
      }
      float o[2][D2][V];
#pragma unroll
      for (int l = 0; l < D2; ++l) {
        float2 w[PARTS][D2];
        load_row<D2, PREC>(w2s, l, w);
#pragma unroll
        for (int v = 0; v < V; ++v)
          mode_cdot<D2, PREC>(w, yp[v], o[0][l][v], o[1][l][v]);
      }
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        if constexpr (TRAIL) {
          float r[D2];
#pragma unroll
          for (int l = 0; l < D2; ++l) r[l] = o[pl][l][0];
          store_vec<D2>(out + pl * n_amps + base + i * D2, r);
        } else {
#pragma unroll
          for (int l = 0; l < D2; ++l)
            store_vec<V>(out + pl * n_amps + base + (i * D2 + l) * B,
                         o[pl][l]);
        }
      }
    }
  }
}

template <int D1, int D2, int PREC>
int launch_pair_stream(const PairArgs& a) {
  constexpr int S = D1 * D2;
  // V S = 16 floats a plane a thread in the middle pair (B >= 128)
  constexpr int V = S >= 16 ? 1 : 16 / S;
  static int cap_trail[MAX_DEVICES] = {}, cap_middle[MAX_DEVICES] = {};
  const Diag diag{a.flips, a.nflips, a.masks, a.wants,
                  a.phase, a.nphases, a.n_amps - 1};
  cudaError_t err;
  if (a.log_b == 0) {
    const unsigned grid =
        stream_grid(pair_fma_stream_kernel<D1, D2, 1, true, PREC>,
                    a.n_amps / S, a.particles, cap_trail, err);
    if (grid == 0) return static_cast<int>(err);
    pair_fma_stream_kernel<D1, D2, 1, true, PREC>
        <<<dim3(grid, a.particles), THREADS, 0, a.stream>>>(
            a.psi, a.out, a.w1, a.w2, a.n_amps, 0, diag);
  } else {
    const unsigned grid =
        stream_grid(pair_fma_stream_kernel<D1, D2, V, false, PREC>,
                    a.n_amps / S / V, a.particles, cap_middle, err);
    if (grid == 0) return static_cast<int>(err);
    pair_fma_stream_kernel<D1, D2, V, false, PREC>
        <<<dim3(grid, a.particles), THREADS, 0, a.stream>>>(
            a.psi, a.out, a.w1, a.w2, a.n_amps, a.log_b, diag);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

template <int PREC>
int pair_stream_launch(int log_d1, const PairArgs& a) {
  if (log_d1 == 1)
    return a.log_d2 == 1 ? launch_pair_stream<2, 2, PREC>(a)
                         : launch_pair_stream<2, 4, PREC>(a);
  return a.log_d2 == 1 ? launch_pair_stream<4, 2, PREC>(a)
                       : launch_pair_stream<4, 4, PREC>(a);
}

template int pair_stream_launch<QBOT_PREC>(int, const PairArgs&);
