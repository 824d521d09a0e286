// The tensor-core window of the reduced dot modes (bf16_3x, bf16) for
// D = 8 .. 128, in both orientations (B > 1, and TRAIL: B == 1).
//
// Replaces, in the reference's --precision bf16_3x and bf16, the TPU
// kernels _left_multiply (qbot_tpu/tpu/kernels.py:179-231) and
// _right_multiply (:243-293), whose _dot (:55-71) splits both operands as
// hi = bf16(x) to nearest even, lo = bf16(x - hi) and sums hi·hi + hi·lo +
// lo·hi (bf16_3x) or hi·hi (bf16).  window_tc.cu instantiates it for those
// two modes in place of the F32 tile (window_tc.cuh).
//
// What bounds it on an H100: the bytes, 1.07 GB a pass at 26 qubits (0.32 ms
// at 3.35 TB/s); the products are 3 (bf16_3x) or 1 (bf16) x 8 D FLOPs an
// amplitude on the 989 TFLOP/s BF16 tensor cores, 0.21 ms at D = 128 in
// bf16_3x.  So the design keeps every instruction that is not a product or
// a byte moved out of the loop:
//
// - W is the A operand of mma.sync.m16n8k16 (16 outputs i a tile), the state
//   columns the B operand (8 a tile): a warp owns 8 NN columns and all the
//   block's outputs, so each x element a block reads is loaded, phased and
//   split into bf16 once, by one lane.
// - W is split into bf16 hi (and lo, bf16_3x) once per block and stored in
//   shared memory in A-fragment order: one LDS.128 a fragment, no
//   conversion in the loop.  The k slots 2t, 2t + 1, 2t + 8, 2t + 9 of lane
//   (g, t) hold j = t, t + 4, t + 8, t + 12 of the k16-step on both
//   operands (a permutation of k that A and B share leaves the sum
//   unchanged), so a lane's x loads stay the conflict-free [k][c] / [c][k]
//   ones of the F32 tile.
// - The rounding structure of window_tc.cuh's BF16 form, at k = 16: each
//   k16-step's hi·hi sums, one mma for each of the two terms of a plane
//   (x_re W_re and -x_im W_im, or x_re W_im and x_im W_re), start from a
//   zero accumulator apart and go to the FP32 accumulators by
//   round-to-nearest FADDs; bf16_3x's four cross-term products of a plane
//   are summed over the stage (one k16-step) on the tensor cores, then
//   added likewise.  The tensor cores round their sums toward zero, and a
//   sum of 16 bf16 products is exact less often than one of 8, and one of
//   32 less still: a plane's two terms chained into one sum drift the
//   256-layer bf16_3x brickwork past 1e-6 per 100 gates at 22 and 23
//   qubits (tools/drift_ab.py); apart, each truncated sum holds 16
//   products, as the k8 tile's do, and the replay's shrink falls below the
//   chained form's.  tests/test_torch_window_split.py replays it, and
//   chip_smoke.py phases 7 and 8 hold the drift it causes.
// - Persistent tile walkers stream the state through a 3- or 4-stage
//   cp.async ring of 16-deep chunks (the F32 tile's loads and layouts), at least two
//   walkers an SM, each with its own ring and barrier: with one an SM,
//   every stall at the ring's barrier stalls the SM (PERF.md §6).  A walker
//   of 8 warps is a block of its own where W's parts, the ring and the
//   diagonal tables fit twice in shared memory; bf16_3x at D = 128, whose
//   W parts take 128 KiB, runs one block an SM of several walkers that
//   share W, each synchronising its warps on a named barrier.
//   __launch_bounds__ holds the registers to 128 a thread.
// - D = 8 fills a quarter of the m16n8k16 tile: W's rows 8-15 and k slots
//   8-15 are zero.
//
// The narrow pair (D1 = 2, 4; window_tc.cuh says how it runs as the D2
// window with W = W2): a walker's pass over each stage turns X into Y in
// place (tc_tile.cuh: narrow_pass), mixed in FP32 in the mode's products as
// the reference's first _dot forms it; the fragments then take Y as the
// window takes x, and split it into bf16 parts as the reference's second
// _dot does.  bf16_3x at D2 = 128 runs two walkers of 8 warps (as B == 1
// does), so that a middle pair's tile is 16 or 32 b of each slot: runs of
// 64-128 bytes.
#pragma once

#include "window_tc.cuh"

namespace {

template <int D, bool TRAIL, int PREC, int D1 = 1>
struct Bf16Tile {
  static_assert(PREC == BF16X3 || PREC == BF16, "a reduced dot mode");
  static constexpr int LOG_D = ilog2(D);
  static constexpr int MT = D < 16 ? 1 : D / 16;  // 16-output m-tiles
  static constexpr int KS = D < 16 ? 1 : D / 16;  // k16-steps
  static constexpr int NE = D < 16 ? 2 : 4;       // j of a lane a k16-step
  static constexpr int NN = D >= 64 ? 1 : D >= 16 ? 2 : 4;  // n-tiles a warp
  // tile walkers a block, each with its own ring and barrier: where W's
  // parts do not fit in shared memory twice (bf16_3x at D = 128), one
  // block an SM of four walkers of 4 warps (B > 1) or two of 8 (B = 1),
  // the faster of the two in each orientation (two of 8 for the narrow
  // pair); else one walker of 8 warps a block, and two blocks an SM
  static constexpr int GROUPS =
      PREC == BF16X3 && D == 128 ? (TRAIL || D1 > 1 ? 2 : 4) : 1;
  static constexpr int WW = GROUPS == 4 ? 4 : WARPS;  // warps a walker
  static constexpr int WT = 32 * WW;              // threads a walker
  static constexpr int NT = GROUPS * WT;          // threads a block
  static constexpr int BN = WW * 8 * NN;          // columns per tile
  static constexpr int BK = D < 16 ? D : 16;      // j per stage
  static constexpr int CHUNKS = D / BK;
  // cp.async ring depth: 3 stages at D <= 32, whose stages hold little
  // compute (D = 32 read faster so, PERF.md §6), else 4
  static constexpr int RING = D <= 32 ? 3 : 4;
  static constexpr int PARTS = PREC == BF16X3 ? 2 : 1;  // W hi (, lo)
  // a stage is [plane][k][c] (B > 1) or [plane][c][k] (B = 1); the row pads
  // put the 32 lanes of a fragment load in 32 distinct banks
  static constexpr int PITCH = TRAIL ? BK + 4 : BN + 8;
  static constexpr int PLANE = TRAIL ? BN * PITCH : BK * PITCH;
  static constexpr int STAGE = 2 * PLANE;
  // W's fragments: [part][plane][m-tile][k16-step][lane] of uint4
  static constexpr int W_FRAGS = MT * KS;
  static constexpr int W_WORDS = PARTS * 2 * W_FRAGS * 128;
  // W_WORDS, then each group's stages, jtab, comb, cmask and cwant, and
  // the narrow pair's W1 and j1tab
  static constexpr int SMEM = 4 * (W_WORDS + GROUPS * RING * STAGE + D) +
                              8 * (1 << TABLE) + 16 * TABLE +
                              (D1 > 1 ? 16 * D1 * D1 + 4 * D1 : 0);
  // two blocks an SM (1 KiB of each block's share of 228 KiB is the
  // system's), or one block of several walkers
  static constexpr int MIN_BLOCKS = GROUPS == 1 ? 2 : 1;
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 228 * 1024, "shared memory");
};

template <int D, bool TRAIL, int PREC, int D1>
__global__ void __launch_bounds__((Bf16Tile<D, TRAIL, PREC, D1>::NT),
                                  (Bf16Tile<D, TRAIL, PREC, D1>::MIN_BLOCKS))
    window_bf16_kernel(const float* __restrict__ psi, float* __restrict__ out,
                       const float* __restrict__ w, int64_t n_amps,
                       int log_b, const Diag diag,
                       const float* __restrict__ w1) {
  using T = Bf16Tile<D, TRAIL, PREC, D1>;
  using N = Narrow<T::BN, T::BK, T::PITCH, D1, TRAIL, T::WT>;
  extern __shared__ __align__(16) float smem[];
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem);
  uint32_t* jtab = ws + T::W_WORDS + T::GROUPS * T::RING * T::STAGE;
  float2* comb = reinterpret_cast<float2*>(jtab + D);
  long long* cmask = reinterpret_cast<long long*>(comb + (1 << TABLE));
  long long* cwant = cmask + TABLE;
  float4* w1s = reinterpret_cast<float4*>(cwant + TABLE);
  uint32_t* j1tab = reinterpret_cast<uint32_t*>(w1s + D1 * D1);
  const int pl0 = particle_plane();

  // the thread's group, and its index and warp in it
  const int grp = threadIdx.x / T::WT, tid = threadIdx.x % T::WT;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t walker = blockIdx.x * T::GROUPS + grp;
  const int64_t walkers = int64_t(gridDim.x) * T::GROUPS;
  float* xs = smem + T::W_WORDS + grp * T::RING * T::STAGE;
  const int64_t B = int64_t(1) << log_b;
  const int64_t cols = n_amps >> T::LOG_D;
  const int64_t tiles = (cols + T::BN - 1) / T::BN;
  const int ndiag = diag.nphases + diag.nflips;
  const int ntab = ndiag < TABLE ? ndiag : TABLE;

  // W split into A-fragment order: word r of lane (g, t) of fragment (plane,
  // m-tile mt, k16-step ks) packs W[i][j] (low half) and W[i][j + 4] (high
  // half), i = 16 mt + g + 8 (r & 1), j = 16 ks + t + 8 (r >> 1); zero
  // outside D
  for (int e = threadIdx.x; e < 2 * T::W_FRAGS * 128; e += T::NT) {
    const int r = e & 3, ln = (e >> 2) & 31, f = e >> 7;
    const int ks = f % T::KS, mt = (f / T::KS) % T::MT, pl = f / T::W_FRAGS;
    const int row = 16 * mt + (ln >> 2) + 8 * (r & 1);
    const int j = 16 * ks + (ln & 3) + 8 * (r >> 1);
    float w0 = 0.f, w1 = 0.f;
    if (row < D && j < D) {
      w0 = w[(pl * D + row) * D + j];
      w1 = w[(pl * D + row) * D + j + 4];
    }
    uint32_t hi, lo;
    split_bf16(w0, w1, hi, lo);
    ws[e] = hi;
    if constexpr (T::PARTS == 2) ws[2 * T::W_FRAGS * 128 + e] = lo;
  }
  diag_tables<D, false>(diag, log_b, jtab, comb, cmask, cwant);
  if constexpr (D1 > 1) {
    diag_tables_d1<D1>(diag, log_b + T::LOG_D, j1tab, cmask, cwant);
    stage_w1<D1, PREC>(w1, w1s);
  }
  __syncthreads();
  // the group's barrier: the ring's stages are the group's alone
  auto group_sync = [&]() {
    if constexpr (T::GROUPS == 1) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(T::WT));
    }
  };

  auto tile_c0 = [&](int64_t s) {
    return (walker + (s / T::CHUNKS) * walkers) * T::BN;
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
      for (int e = tid; e < 2 * T::BN * KQ; e += T::WT) {
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
      for (int e = tid; e < (2 * T::BK) << lrow; e += T::WT) {
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
      tiles > walker ? (tiles - 1 - walker) / walkers + 1 : 0;
  const int64_t items = my_tiles * T::CHUNKS;
#pragma unroll
  for (int s = 0; s < T::RING - 1; ++s) {
    if (s < items) load(s, s);
    cp_async_commit();
  }

  const uint4* wf = reinterpret_cast<const uint4*>(ws);
  // acc[mt][nn][p]: plane p of outputs 16 mt + g (q = 0, 1) and + 8 (q = 2,
  // 3) of columns 2t, 2t + 1 (q even, odd) of n-tile nn
  float acc[T::MT][T::NN][2][4];
  uint32_t colhit[T::NN];
  const int cw = warp * 8 * T::NN;  // the warp's first column in the tile
  // the narrow pair: the table entries the columns of the thread's base
  // elements hit
  uint32_t phit[N::Q];
  for (int64_t s = 0, stage = 0; s < items;
       ++s, stage = stage == T::RING - 1 ? 0 : stage + 1) {
    cp_async_wait<T::RING - 2>();
    group_sync();
    const int chunk = int(s % T::CHUNKS);  // the k16-step
    const int j0 = chunk * T::BK;
    const int64_t c0 = tile_c0(s);
    if (chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
        for (int nn = 0; nn < T::NN; ++nn) {
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[mt][nn][q >> 2][q & 3] = 0.f;
        }
      }
#pragma unroll
      for (int nn = 0; nn < T::NN; ++nn)
        colhit[nn] = col_hits(col_base(c0 + cw + 8 * nn + g), ntab, cmask,
                              cwant);
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
      // item s + RING - 1 goes to the stage item s - 1 used
      if (s + T::RING - 1 < items)
        load(s + T::RING - 1, stage == 0 ? T::RING - 1 : int(stage) - 1);
      cp_async_commit();
      // the narrow pair: Y over X in place, then the window's loads of Y
      narrow_pass<N, D1, T::PLANE, PREC>(
          st, tid, w1s, phit, j1tab, jtab, j0, comb, diag, ndiag, log_b,
          [&](int cl) { return col_base(c0 + cl); });
      group_sync();
    }
    // the B fragments: element e of n-tile nn is column cw + 8 nn + g at
    // j = t + 4 e of the stage.  All loads first, so their latencies overlap.
    float xr[T::NN][4], xi[T::NN][4];
#pragma unroll
    for (int nn = 0; nn < T::NN; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = t + 4 * e, cl = cw + 8 * nn + g;
        const int off = TRAIL ? cl * T::PITCH + k : k * T::PITCH + cl;
        xr[nn][e] = e < T::NE ? st[off] : 0.f;
        xi[nn][e] = e < T::NE ? st[T::PLANE + off] : 0.f;
      }
    }
    if constexpr (D1 == 1) {
      // item s + RING - 1 goes to the stage item s - 1 used
      if (s + T::RING - 1 < items)
        load(s + T::RING - 1, stage == 0 ? T::RING - 1 : int(stage) - 1);
      cp_async_commit();
      if (ndiag) {
        uint32_t several = 0;
#pragma unroll
        for (int nn = 0; nn < T::NN; ++nn) {
#pragma unroll
          for (int e = 0; e < T::NE; ++e) {
            const uint32_t h = colhit[nn] & jtab[j0 + t + 4 * e];
            apply_hit(xr[nn][e], xi[nn][e], h, comb);
            several |= h & (h - 1);
          }
        }
        if (several) {
#pragma unroll
          for (int nn = 0; nn < T::NN; ++nn) {
#pragma unroll
            for (int e = 0; e < T::NE; ++e) {
              apply_several_hits(xr[nn][e], xi[nn][e],
                                 colhit[nn] & jtab[j0 + t + 4 * e], comb);
            }
          }
        }
        if (ndiag > TABLE) {
#pragma unroll
          for (int nn = 0; nn < T::NN; ++nn) {
            const int64_t base = col_base(c0 + cw + 8 * nn + g);
#pragma unroll
            for (int e = 0; e < T::NE; ++e) {
              const int64_t mflat = base | (int64_t(j0 + t + 4 * e) << log_b);
              for (int q = TABLE; q < ndiag; ++q) {
                int64_t mask, want;
                float zr, zi;
                diag.entry(q, mask, want, zr, zi);
                if ((mflat & mask) == want) cmul(xr[nn][e], xi[nn][e], zr, zi);
              }
            }
          }
        }
      }
    }
    // x = hi + lo, split once: [plane re, im, -im][register], the two
    // registers packing j = t, t + 4 and t + 8, t + 12 (zero at D = 8)
    uint32_t xh[T::NN][3][2], xl[T::NN][3][2];
#pragma unroll
    for (int nn = 0; nn < T::NN; ++nn) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        split_bf16(xr[nn][2 * q], xr[nn][2 * q + 1], xh[nn][0][q],
                   xl[nn][0][q]);
        split_bf16(xi[nn][2 * q], xi[nn][2 * q + 1], xh[nn][1][q],
                   xl[nn][1][q]);
        xh[nn][2][q] = xh[nn][1][q] ^ 0x80008000u;
        xl[nn][2][q] = xl[nn][1][q] ^ 0x80008000u;
      }
    }
    // out_r = Wr x_r - Wi x_i, out_i = Wi x_r + Wr x_i
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      const int f = mt * T::KS + chunk;
      const uint4 wrh = wf[f * 32 + lane];
      const uint4 wih = wf[(T::W_FRAGS + f) * 32 + lane];
#pragma unroll
      for (int nn = 0; nn < T::NN; ++nn) {
        // each plane's two hi hi sums from zero, apart: [plane][term]
        float e[2][2][4];
        mma16_0(e[0][0], wrh, xh[nn][0]);
        mma16_0(e[1][0], wih, xh[nn][0]);
        mma16_0(e[0][1], wih, xh[nn][2]);
        mma16_0(e[1][1], wrh, xh[nn][1]);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[mt][nn][p][q] = acc[mt][nn][p][q] + e[p][0][q] + e[p][1][q];
        }
      }
      if constexpr (PREC == BF16X3) {
        const uint4 wrl = wf[(2 * T::W_FRAGS + f) * 32 + lane];
        const uint4 wil = wf[(3 * T::W_FRAGS + f) * 32 + lane];
#pragma unroll
        for (int nn = 0; nn < T::NN; ++nn) {
          // W_hi x_lo + W_lo x_hi
          float c[2][4];
          mma16_0(c[0], wrl, xh[nn][0]);
          mma16_0(c[1], wil, xh[nn][0]);
          mma16(c[0], wrh, xl[nn][0]);
          mma16(c[1], wih, xl[nn][0]);
          mma16(c[0], wil, xh[nn][2]);
          mma16(c[1], wrl, xh[nn][1]);
          mma16(c[0], wih, xl[nn][2]);
          mma16(c[1], wrh, xl[nn][1]);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][nn][p][q] += c[p][q];
          }
        }
      }
    }
    if (chunk == T::CHUNKS - 1) {
#pragma unroll
      for (int nn = 0; nn < T::NN; ++nn) {
        const int64_t c = c0 + cw + 8 * nn + 2 * t;
        if (c >= cols) continue;
        const int64_t base = col_base(c);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
          for (int h = 0; h < (D < 16 ? 1 : 2); ++h) {
            const int i = 16 * mt + g + 8 * h;
#pragma unroll
            for (int pl = 0; pl < 2; ++pl) {
              const float v0 = acc[mt][nn][pl][2 * h];
              const float v1 = acc[mt][nn][pl][2 * h + 1];
              float* o = out + (pl0 + pl) * n_amps;
              if (TRAIL) {
                o[c * D + i] = v0;
                if (c + 1 < cols) o[(c + 1) * D + i] = v1;
              } else {
                // B >= 2: columns c, c + 1 are b, b + 1 of one a
                *reinterpret_cast<float2*>(o + base + (int64_t(i) << log_b)) =
                    make_float2(v0, v1);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int D, bool TRAIL, int PREC, int D1>
int launch_bf16(const WindowArgs& a) {
  using T = Bf16Tile<D, TRAIL, PREC, D1>;
  static int blocks_cap[MAX_DEVICES] = {};  // resident blocks, per device
  cudaError_t err;
  const int cap = resident_blocks(window_bf16_kernel<D, TRAIL, PREC, D1>,
                                  T::SMEM, blocks_cap, err, T::NT);
  if (cap == 0) return static_cast<int>(err);
  // GROUPS tile walkers a block
  const int64_t tiles = ((a.n_amps >> T::LOG_D) + T::BN - 1) / T::BN;
  const int64_t blocks = (tiles + T::GROUPS - 1) / T::GROUPS;
  const unsigned grid = particle_grid(blocks, cap, a.particles);
  const Diag diag{a.flips, a.nflips, a.masks, a.wants,
                  a.phase, a.nphases, a.n_amps - 1};
  window_bf16_kernel<D, TRAIL, PREC, D1>
      <<<dim3(grid, a.particles), T::NT, T::SMEM, a.stream>>>(
          a.psi, a.out, a.w, a.n_amps, a.log_b, diag, a.w1);
  return static_cast<int>(cudaGetLastError());
}

// the body of window_tc_launch<D1, PREC> for the reduced modes, in
// window_tc.cu
template <int D1, int PREC>
int launch_bf16_d(const WindowArgs& a) {
  const bool trail = a.log_b == 0;
  switch (a.log_d) {
    case 3: return trail ? launch_bf16<8, true, PREC, D1>(a)
                         : launch_bf16<8, false, PREC, D1>(a);
    case 4: return trail ? launch_bf16<16, true, PREC, D1>(a)
                         : launch_bf16<16, false, PREC, D1>(a);
    case 5: return trail ? launch_bf16<32, true, PREC, D1>(a)
                         : launch_bf16<32, false, PREC, D1>(a);
    case 6: return trail ? launch_bf16<64, true, PREC, D1>(a)
                         : launch_bf16<64, false, PREC, D1>(a);
    case 7: return trail ? launch_bf16<128, true, PREC, D1>(a)
                         : launch_bf16<128, false, PREC, D1>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
