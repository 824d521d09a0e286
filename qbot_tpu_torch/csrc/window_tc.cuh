// The tensor-core window kernel (window_apply.cu describes its design) for
// D = 8 .. 128, in both orientations (B > 1, and TRAIL: B == 1), with the
// F32 tile's products (tc_tile.cuh: Prec F32; the reduced modes' window is
// window_bf16.cuh).  At D = 128 it serves the narrow pairs alone: the f32
// window there is window_wg.cuh's.
//
// The narrow pair (D1 = 2, 4 of the template's D1; D1 = 1 is the window):
// the pair of a narrow first window and a D = D2 >= 8 second one, W1 first
// as in the reference's _pair_bt (qbot_tpu/tpu/kernels.py:379-416) and
// _pair_b1 (:304-348),
//
//   out[a, i, l, b] = sum_m W2[l, m] Y[a, i, m, b],
//   Y[a, i, m, b] = sum_j W1[i, j] (Phi F p)[a, j, m, b],
//
// runs as the D2 window of the state viewed as (A D1, D2, B), W = W2, whose
// operand is mixed by W1 as it is staged.  W1's work is 8 D1 FLOPs an
// amplitude against W2's 8 D2, so the pair costs about one window: the
// stage holds the same X elements the window would (a tile's columns are
// BN / D1 base columns (a, b) times the D1 slots j, tc_tile.cuh: Narrow),
// and once it has landed one pass over it (tc_tile.cuh: narrow_pass) turns
// each base element's D1 values X[a, j, m, b] into the D1 values of
// Y[a, i, m, b] in place: each X element read and phased once (a third
// lookup table, of the first window's bits), Y mixed in FP32 FMAs with W1
// from shared memory.  A barrier, and the window's fragment loads and
// products run unchanged on Y, with no diagonals: the grids of the 3xTF32
// split are taken on Y, so each k-step's hi*hi sums stay exact.  (Mixing Y
// as each lane builds its fragment would read and phase every X element
// once for each of the D1 warps that own its base column's slots, times
// the two warps along the outputs: with diagonals, more than the products
// cost.)
//
// Build: the kernel has one instantiation per (D, TRAIL, PREC, D1).  So
// window_tc.cu instantiates the launcher window_tc_launch<D1, PREC>
// declared below for one D1 and precision, given as -D defines, and nvcc
// compiles it once per variant, in parallel with the pair's variants
// (tpu/kernels.py: build_kernels); window_apply.cu (D1 = 1) and
// pair_apply.cu (D1 = 2, 4) call the launchers.
#pragma once

#include "tc_tile.cuh"

// The arguments of a tensor-core window launch, as qbot_window_apply takes
// them
struct WindowArgs {
  const float* psi;
  float* out;
  const float* w;
  int64_t n_amps;
  int log_d;
  int log_b;
  const int64_t* flips;
  int nflips;
  const int64_t* masks;
  const int64_t* wants;
  const float* phase;
  int nphases;
  cudaStream_t stream;
  const float* w1 = nullptr;  // the narrow pair's (2, D1, D1) W1
  int particles = 1;          // states of the launch (tc_tile.cuh)
  // the f32 window at D = 128: window_wg.cuh's scratch of W's split parts
  // (wg::SCRATCH_FLOATS floats, 16-byte aligned)
  float* scratch = nullptr;
};

// The launcher of the tensor-core window (D1 = 1), or of the narrow pair
// whose first window has D1 = 2, 4 (args.w1; args.w is W2), in one
// precision, for every D = D2 of 8-128; returns the launch's
// cudaGetLastError(), cudaErrorInvalidValue for another D.  Defined in
// window_tc.cu, once per D1 and precision.
template <int D1, int PREC>
int window_tc_launch(const WindowArgs& args);

#include "window_wg.cuh"

namespace {

template <int D, bool TRAIL, int PREC, int D1 = 1>
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
  static_assert(PREC == F32, "the F32 tile (the reduced modes' window is "
                "window_bf16.cuh)");
  // W staged split (hi, lo, tf32) up to D = 64; at D = 128 staged in FP32
  // and split as the fragments are built
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
  // cmask and cwant, and the narrow pair's W1 and j1tab
  static constexpr int SMEM = 4 * (W_FLOATS + STAGES * STAGE + KS * D + D) +
                              8 * (1 << TABLE) + 16 * TABLE +
                              (D1 > 1 ? 16 * D1 * D1 + 4 * D1 : 0);
};

template <int D, bool TRAIL, int PREC, int D1>
__global__ void __launch_bounds__(THREADS, 1)
    window_tc_kernel(const float* __restrict__ psi, float* __restrict__ out,
                     const float* __restrict__ w, int64_t n_amps, int log_b,
                     const Diag diag, const float* __restrict__ w1) {
  using T = Tile<D, TRAIL, PREC, D1>;
  using N = Narrow<T::BN, T::BK, T::PITCH, D1, TRAIL, THREADS>;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* xs = ws + T::W_FLOATS;
  float* wgrid = xs + STAGES * T::STAGE;
  uint32_t* jtab = reinterpret_cast<uint32_t*>(wgrid + T::KS * D);
  float2* comb = reinterpret_cast<float2*>(jtab + D);
  long long* cmask = reinterpret_cast<long long*>(comb + (1 << TABLE));
  long long* cwant = cmask + TABLE;
  float4* w1s = reinterpret_cast<float4*>(cwant + TABLE);
  uint32_t* j1tab = reinterpret_cast<uint32_t*>(w1s + D1 * D1);
  const int pl0 = particle_plane();

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
    if constexpr (T::SPLIT_W) {
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
  diag_tables<D, true>(diag, log_b, jtab, comb, cmask, cwant);
  if constexpr (D1 > 1) {
    diag_tables_d1<D1>(diag, log_b + T::LOG_D, j1tab, cmask, cwant);
    stage_w1<D1, PREC>(w1, w1s);
  }

  auto tile_c0 = [&](int64_t s) {
    return (blockIdx.x + (s / T::CHUNKS) * gridDim.x) * T::BN;
  };
  // flat index of column c's j = 0 element: a * D * B + b (the narrow pair:
  // of its tile column's X or output element, tc_tile.cuh: Narrow)
  auto col_base = [&](int64_t c) {
    if constexpr (D1 > 1) c = N::window_col(c, log_b);
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
                 psi + (pl0 + pl) * n_amps +
                     (ok ? c * D + j0 + kq * 4 : 0),
                 16, ok);
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
                 psi + (pl0 + pl) * n_amps +
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
  // the narrow pair: the table entries the columns of the thread's base
  // elements hit
  uint32_t phit[N::Q];
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
      if constexpr (D1 > 1) {
#pragma unroll
        for (int q = 0; q < N::Q; ++q) {
          int cb, k;
          N::element(tid, q, cb, k);
          phit[q] = col_hits(col_base(c0 + N::col(cb, 0)), ntab, cmask,
                             cwant);
        }
      }
    }
    float* st = xs + stage * T::STAGE;
    if constexpr (D1 > 1) {
      // item s + STAGES - 1 goes to the stage item s - 1 used
      if (s + STAGES - 1 < items)
        load(s + STAGES - 1, stage == 0 ? STAGES - 1 : int(stage) - 1);
      cp_async_commit();
      // the narrow pair: Y over X in place, then the window's loads of Y
      narrow_pass<N, D1, T::PLANE, PREC>(
          st, tid, w1s, phit, j1tab, jtab, chunk * T::BK, comb, diag, ndiag,
          log_b, [&](int cl) { return col_base(c0 + cl); });
      __syncthreads();
    }
    // the A fragments of the stage's k-steps: element e of k-step kc is
    // column row g (+ 8 for odd e) at j = 8 kc + t (+ 4 for e >= 2).  All
    // loads first, so their latencies overlap.
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
    if constexpr (D1 == 1) {
      // item s + STAGES - 1 goes to the stage item s - 1 used
      if (s + STAGES - 1 < items)
        load(s + STAGES - 1, stage == 0 ? STAGES - 1 : int(stage) - 1);
      cp_async_commit();
      if (ndiag) {
        diag_fragments<T::KC, false>(
            xr, xi, diag, ndiag, chunk * T::BK, log_b, jtab, comb, colhit,
            [&](int r) { return col_base(c0 + cw + g + 8 * r); });
      }
    }
    // x = hi + lo on the grid of its column row and k-step, W likewise on
    // the grid of its row and k-step (wgrid): exact hi·hi k-step sums
    const ASplit<T::KC> a(xr, xi);
    tc_products<T::KC, T::NI>(acc, a, [&](int it, int kc, BFrag& b) {
      const int row = wi * T::NI + it;
      const int frag = row * T::KS + chunk * T::KC + kc;
      if constexpr (T::SPLIT_W) {
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
            float* o = out + (pl0 + pl) * n_amps + base;
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

template <int D, bool TRAIL, int PREC, int D1>
int launch_tc(const WindowArgs& a) {
  using T = Tile<D, TRAIL, PREC, D1>;
  static int blocks_cap[MAX_DEVICES] = {};  // resident blocks, per device
  cudaError_t err;
  const int cap = resident_blocks(window_tc_kernel<D, TRAIL, PREC, D1>,
                                  T::SMEM, blocks_cap, err);
  if (cap == 0) return static_cast<int>(err);
  const int64_t tiles = ((a.n_amps >> T::LOG_D) + T::BN - 1) / T::BN;
  const unsigned grid = particle_grid(tiles, cap, a.particles);
  const Diag diag{a.flips, a.nflips, a.masks, a.wants,
                  a.phase, a.nphases, a.n_amps - 1};
  window_tc_kernel<D, TRAIL, PREC, D1>
      <<<dim3(grid, a.particles), THREADS, T::SMEM, a.stream>>>(
          a.psi, a.out, a.w, a.n_amps, a.log_b, diag, a.w1);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int PREC, int D1>
int launch_tc_trail(const WindowArgs& a) {
  return a.log_b == 0 ? launch_tc<D, true, PREC, D1>(a)
                      : launch_tc<D, false, PREC, D1>(a);
}

// the body of window_tc_launch<D1, PREC> for f32, in window_tc.cu: the
// window at D = 128 (D1 = 1) runs on the warpgroup products of
// window_wg.cuh, every other D and the narrow pairs on the tile above
template <int D1, int PREC>
int launch_tc_d(const WindowArgs& a) {
  switch (a.log_d) {
    case 3: return launch_tc_trail<8, PREC, D1>(a);
    case 4: return launch_tc_trail<16, PREC, D1>(a);
    case 5: return launch_tc_trail<32, PREC, D1>(a);
    case 6: return launch_tc_trail<64, PREC, D1>(a);
    case 7:
      if constexpr (D1 == 1) {
        return a.log_b == 0 ? launch_wg<true>(a) : launch_wg<false>(a);
      } else {
        return launch_tc_trail<128, PREC, D1>(a);
      }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
