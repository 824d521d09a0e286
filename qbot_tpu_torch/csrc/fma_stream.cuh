// The pieces shared by the streaming FMA kernels of the narrow widths: the
// window at D = 2, 4 (window_apply.cu: window_fma_stream_kernel) and the
// pair at D1, D2 = 2, 4 (pair_stream.cu: pair_fma_stream_kernel).  Each
// thread of those kernels owns whole columns of the product (V consecutive
// b, or one contiguous run at B == 1), so it loads, phases, multiplies and
// stores its elements in registers, and the state streams through once.
#pragma once

#include "tc_tile.cuh"

namespace {

// N consecutive floats, read and written as 4-, 8- or 16-byte vectors
template <int N>
struct Vec {
  float v[N];
};

template <int N>
__device__ __forceinline__ Vec<N> load_vec(const float* p) {
  static_assert(N == 1 || N == 2 || N % 4 == 0, "a vector of 1, 2 or 4k");
  Vec<N> r;
  if constexpr (N == 1) {
    r.v[0] = *p;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    r.v[0] = q.x, r.v[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      r.v[k] = q.x, r.v[k + 1] = q.y, r.v[k + 2] = q.z, r.v[k + 3] = q.w;
    }
  }
  return r;
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  static_assert(N == 1 || N == 2 || N % 4 == 0, "a vector of 1, 2 or 4k");
  if constexpr (N == 1) {
    *p = v[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

// the operand parts of a dot mode: x itself (F32); hi = bf16(x), lo =
// bf16(x - hi) (BF16X3), hi alone (BF16), as the reference's _dot splits
template <int PREC>
__host__ __device__ constexpr int parts() {
  return PREC == BF16X3 ? 2 : 1;
}

template <int PREC>
__device__ __forceinline__ void split_mode(float x, float* part) {
  if constexpr (PREC == F32) {
    part[0] = x;
  } else {
    part[0] = round_bf16(x);
    if constexpr (PREC == BF16X3) part[1] = round_bf16(__fsub_rn(x, part[0]));
  }
}

// W (2, D, D) into shared memory, entry e of part p as ws[p][e] = (re, im)
template <int D, int PREC>
__device__ __forceinline__ void stage_parts(const float* w,
                                            float2 (*ws)[D * D]) {
  for (int e = threadIdx.x; e < D * D; e += blockDim.x) {
    float re[parts<PREC>()], im[parts<PREC>()];
    split_mode<PREC>(w[e], re);
    split_mode<PREC>(w[D * D + e], im);
#pragma unroll
    for (int p = 0; p < parts<PREC>(); ++p)
      ws[p][e] = make_float2(re[p], im[p]);
  }
}

// x[plane][s][v] *= the diagonal entries that hit element (s, v), whose
// flat index is base + s * stride + v: the first TABLE entries found by the
// tables of diag_tables<S, false> (a window of S values of s at stride; the
// column bits of v's element s = 0 at base + v), then the rest on the flat
// index, one entry at a time in the entries' order (the phases, then the
// flips), as the plain version applies them: a product of two entries'
// factors would round otherwise, and a bf16 rounding of x moves by 2^-8
// with it.  At these widths an element's few entries cost little.
template <int S, int V>
__device__ __forceinline__ void stream_phases(
    float (&x)[2][S][V], int64_t base, int64_t stride, const Diag& diag,
    const uint32_t* jtab, const float2* comb, const long long* cmask,
    const long long* cwant) {
  const int ndiag = diag.nphases + diag.nflips;
  if (!ndiag) return;
  const int ntab = ndiag < TABLE ? ndiag : TABLE;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint32_t hit = col_hits(base + v, ntab, cmask, cwant);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // comb of a one-entry hit set is that entry's factor
      for (uint32_t h = hit & jtab[s]; h; h &= h - 1) {
        const float2 z = comb[h & (0u - h)];
        cmul(x[0][s][v], x[1][s][v], z.x, z.y);
      }
      for (int q = TABLE; q < ndiag; ++q) {
        int64_t mask, want;
        float zr, zi;
        diag.entry(q, mask, want, zr, zi);
        if (((base + s * stride + v) & mask) == want)
          cmul(x[0][s][v], x[1][s][v], zr, zi);
      }
    }
  }
}

// Resident blocks of a streaming kernel and the x extent of the grid that
// walks groups of its columns with THREADS threads a block, for each of
// `particles` states: at most one block a group of THREADS, at most the
// resident ones shared out among the particles (particle_grid).  Returns 0
// with err set on failure.
template <typename Kernel>
unsigned stream_grid(Kernel kernel, int64_t groups, int particles,
                     int* blocks_cap, cudaError_t& err) {
  const int cap = resident_blocks(kernel, 0, blocks_cap, err);
  if (cap == 0) return 0;
  return particle_grid((groups + THREADS - 1) / THREADS, cap, particles);
}

}  // namespace
