// Tensor-core pair kernel of the planar statevector executor: two adjacent
// windows in one pass over the state, at D1, D2 >= 8, with the F32 tile's
// products (tc_tile.cuh: Prec F32; the reduced modes' pair is
// pair_bf16.cuh; pair_apply.cu holds the entry point and the dispatch of
// the narrower widths):
//
//   out[a, i, l, b] = sum_{j,m} W1[i, j] * W2[l, m] * (Phi F p)[a, j, m, b]
//
// - the trailing pair (B == 1) replaces the TPU kernel _pair_b1
//   (qbot_tpu/tpu/kernels.py:352), but for D2 = 128 with D1 = 64, 128,
//   which pair_wg.cuh's warpgroup products serve;
// - the middle pair (MIDDLE: B >= 128, D1 <= 32) replaces _pair_bt
//   (qbot_tpu/tpu/kernels.py:420).
//
// What bounds it on an H100: a pair does the FLOPs of its two windows,
// 8 * (D1 + D2) per complex amplitude, and saves one of their two state
// passes.  At 26 qubits the trailing (128, 128) pair does 137 GFLOP and the
// middle (32, 128) pair 86 GFLOP against 1 GiB of traffic (0.32 ms at
// 3.35 TB/s): 0.83 and 0.52 ms as 3xTF32 products on the 495 TFLOP/s TF32
// tensor cores.  Both are bound by their products.
//
// Design: each (D1, D2) slab X goes through two products of the window
// kernel's tile (tc_tile.cuh: mma.sync.m16n8k8 TF32 in a 3xTF32 split whose
// hi parts lie on a grid per row and k-step, so each k-step's hi*hi sums
// are exact on tensor cores that round toward zero).  W1 goes first, as in
// the reference's pair kernels and pair_bf16.cuh.  A
// slab is one a of the trailing pair (contiguous, row-major in (j, m)) or
// one b-column of the middle pair (element (j, m) at flat index a D1 D2 B +
// (j D2 + m) B + b):
//   phase 1  Y[(s, m), i] = sum_j W1[i, j] (Phi F X_s)[j, m]: the A rows
//            are the slab's columns (s, m), K = j; the flips and phases
//            apply here, at the elements' flat indices (window bits j at
//            log D2 + log B);
//   phase 2  out[(s, i), l] = sum_m Y[(s, i), m] W2[l, m], from Y in shared
//            memory: the A rows are the rows (s, i), K = m, on grids per
//            row and k-step of m.
// A whole slab and both W do not fit in a block's 227 KiB at (128, 128)
// (128 KiB of slab, 128 KiB of each W).  So a persistent block owns
// IN <= 64 of the output rows i of every unit it takes, always the same
// part h of the D1 / IN, and the blocks of one unit's parts run side by
// side, so the second read of X hits L2.  A unit is S = 8192 / (IN D2)
// slabs: consecutive a (trailing), or consecutive b of one a (middle,
// where IN <= 2048 / D2 keeps S >= 4: runs of b of 16 bytes); Y, the
// unit's (S D2) x IN outputs of phase 1, is always 8192 complex values.
// Consecutive units go to blocks that run at the same time (the persistent
// stride), so where the middle pair's runs of S b are shorter than a
// 32-byte sector (S = 4 at (32, 128)), the other half of the sector is the
// neighbouring block's and hits L2.
//
// Shared memory at (128, 128), 219 KiB: the IN rows of W1 of part h in
// FP32, in fragment order, staged once and split as the fragments are
// built, as window_apply does at D = 128 (64 KiB), with their grids; W2's
// grids; Y (68 KiB with its row pads); a 3-stage cp.async ring of 16-deep
// chunks: X chunks of 128 rows in phase 1, then W2 chunks of all D2 rows in
// phase 2.  One ring for both phases: the copies of the next unit's X
// overlap this unit's phase 2.  The k of a k-step go in the paired order
// (tc_tile.cuh: k_of).  In phase 1 each of the 8 warps owns 16 rows (s, m)
// and all IN outputs, a lane's fragment rows g and g + 8 being the stage's
// rows 2g and 2g + 1 (one 8-byte load gives both); phase 2 tiles the rows
// (s, i) as window_apply tiles B > 1 (two warps along the outputs l at
// D2 >= 64).  Layouts, whose pads put the lanes of every fragment load in
// distinct banks:
// - an X stage is [plane][j][row], rows fastest, as window_apply's B > 1
//   stage is [k][c]: X arrives as runs along m (trailing, rows (s, m)) or
//   of S floats along b (middle, rows (m, s), s fastest);
// - Y is [plane][(s, m)][i] (trailing) or [plane][m][(i, s)] (middle, s
//   fastest, so phase 2's rows, and the lanes that store them, run along
//   b).
//
// Build: the kernel has one instantiation per (D1, D2), orientation and
// precision, the longest compile of the library.  So pair_tc.cu
// instantiates the launcher pair_tc_launch<D1, MIDDLE, PREC> declared
// below for one (D1, MIDDLE, PREC), given as -D defines, and nvcc compiles
// it once per variant, all in parallel (tpu/kernels.py:build_kernels);
// pair_apply.cu calls the launchers.
// Everything else here sits in tc_tile.cuh's anonymous namespace, so the
// launchers take their arguments as plain values.
#pragma once

#include "tc_tile.cuh"

// The arguments of a tensor-core pair launch, as qbot_pair_apply takes them
struct PairArgs {
  const float* psi;
  float* out;
  const float* w1;
  const float* w2;
  int64_t n_amps;
  int log_d2;
  int log_b;
  const int64_t* flips;
  int nflips;
  const int64_t* masks;
  const int64_t* wants;
  const float* phase;
  int nphases;
  cudaStream_t stream;
  int particles = 1;  // states of the launch (tc_tile.cuh)
  // the f32 trailing pair at D2 = 128, D1 = 64, 128: pair_wg.cuh's scratch
  // of W1's and W2's split parts (qbot_pair_scratch_floats, 16-byte
  // aligned)
  float* scratch = nullptr;
};

// The launcher of the tensor-core pair at one D1, orientation and
// precision of the products (tc_tile.cuh: Prec), for every D2 of 8-128;
// returns the launch's cudaGetLastError(), cudaErrorInvalidValue for
// another D2.  Defined in pair_tc.cu, once per variant.
template <int D1, bool MIDDLE, int PREC>
int pair_tc_launch(const PairArgs& args);

// The launcher of the f32 trailing pair at D2 = 128 and D1 = 2^log_d1 =
// 64, 128 on the warpgroup products (pair_wg.cuh); returns the launch's
// cudaGetLastError(), cudaErrorInvalidValue for another D1.  Defined in
// pair_wg.cu.
int pair_wg_launch(int log_d1, const PairArgs& args);

namespace {

constexpr int MAX_IN = 64;  // output rows i a block owns, at most

template <int D1, int D2, bool MIDDLE>
struct PairTile {
  static constexpr int LOG_D1 = ilog2(D1), LOG_D2 = ilog2(D2);
  // the middle pair's units span S = 8192 / (IN D2) >= 4 b
  static constexpr int IN_MAX =
      MIDDLE && 2048 / D2 < MAX_IN ? 2048 / D2 : MAX_IN;
  static constexpr int IN = D1 < IN_MAX ? D1 : IN_MAX;
  static constexpr int LOG_IN = ilog2(IN);
  static constexpr int H = D1 / IN;              // blocks (parts of i) a unit
  static constexpr int S = 8192 / (IN * D2);     // slabs a unit
  static constexpr int LOG_S = ilog2(S);
  // phase 1: the unit's rows (s, m) in tiles of RM, 16 a warp, K = j
  static constexpr int RM = WARPS * 16;
  static constexpr int ROWS = S * D2;
  static constexpr int KS1 = D1 / 8;             // k-steps of 8 j
  static constexpr int NI1 = IN / 8;             // n-tiles of i a warp
  static constexpr int BK1 = D1 < 16 ? D1 : 16;  // j per stage
  static constexpr int KC1 = BK1 / 8;
  static constexpr int CH1 = D1 / BK1;
  static constexpr int P1 = RM + 4;              // X stage: [plane][j][row]
  static constexpr int XPLANE = BK1 * P1;
  // phase 2: the unit's rows (s, i) in tiles of BN2, K = m
  static constexpr int KS2 = D2 / 8;
  static constexpr int WI2 = D2 >= 64 ? 2 : 1;   // warps along the outputs l
  static constexpr int NI2 = KS2 / WI2;
  static constexpr int BN2 = (WARPS / WI2) * 16;
  static constexpr int COLS = S * IN;
  static constexpr int BK2 = D2 < 16 ? D2 : 16;  // m per stage
  static constexpr int KC2 = BK2 / 8;
  static constexpr int CH2 = D2 / BK2;
  static constexpr int P2 = BK2 + 8;             // W2 stage: [plane][l][m]
  static constexpr int NA = NI1 > NI2 ? NI1 : NI2;
  // items of a unit: phase 1 (row tile, j chunk), then phase 2 (row tile
  // of Y, m chunk)
  static constexpr int ITEMS1 = ROWS / RM * CH1;
  static constexpr int ITEMS = ITEMS1 + COLS / BN2 * CH2;
  // Y: [plane][(s, m)][i] (trailing), [plane][m][(i, s)] (middle).  The
  // pads put the lanes of a fragment load in distinct banks: P1 for the
  // 8-byte loads of rows 2g, 2g + 1 at k = 2t (+ 1), P2 for those of row g
  // at k = 2t, 2t + 1 (the paired k order), PY for the loads of rows
  // m = 2t (+ 1)
  static constexpr int PY = MIDDLE ? COLS + 4 : IN + 4;
  static constexpr int YPLANE = (MIDDLE ? D2 : ROWS) * PY;
  static constexpr int PLANE = XPLANE > D2 * P2 ? XPLANE : D2 * P2;
  static constexpr int STAGE = 2 * PLANE;
  static constexpr int W1_FLOATS = 2 * IN * D1;
  // the stages, W1's rows (fragment order), their grids ([k-step][i]), W2's
  // grids ([k-step][l]), Y; then jtab, comb, cmask and cwant
  static constexpr int SMEM =
      4 * (STAGES * STAGE + W1_FLOATS + KS1 * IN + KS2 * D2 + 2 * YPLANE +
           D1) +
      8 * (1 << TABLE) + 16 * TABLE;
  static_assert(ROWS % RM == 0 && COLS % BN2 == 0, "pair tile");
  static_assert(!MIDDLE || (S >= 4 && S <= 128 && D1 <= 32),
                "middle pair: 16-byte runs of b, S <= B");
  static_assert(SMEM <= MAX_SMEM, "pair tile shared memory");
};

template <int D1, int D2, bool MIDDLE, int PREC>
__global__ void __launch_bounds__(THREADS, 1)
    pair_tc_kernel(const float* __restrict__ psi, float* __restrict__ out,
                   const float* __restrict__ w1, const float* __restrict__ w2,
                   int64_t n_amps, int log_b, const Diag diag) {
  static_assert(PREC == F32, "the F32 tile (the reduced modes' pair is "
                "pair_bf16.cuh)");
  using T = PairTile<D1, D2, MIDDLE>;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* w1s = ring + STAGES * T::STAGE;
  float* grid1 = w1s + T::W1_FLOATS;
  float* grid2 = grid1 + T::KS1 * T::IN;
  float* ys = grid2 + T::KS2 * D2;
  uint32_t* jtab = reinterpret_cast<uint32_t*>(ys + 2 * T::YPLANE);
  float2* comb = reinterpret_cast<float2*>(jtab + D1);
  long long* cmask = reinterpret_cast<long long*>(comb + (1 << TABLE));
  long long* cwant = cmask + TABLE;
  const int pl0 = particle_plane();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wi = warp % T::WI2, wc = warp / T::WI2;  // phase 2
  const int h = blockIdx.x % T::H;                   // the block's part of i
  // the middle pair's units are whole (S <= 128 <= B)
  const int64_t slabs = n_amps >> (T::LOG_D1 + T::LOG_D2);
  const int64_t units = MIDDLE ? slabs >> T::LOG_S : (slabs + T::S - 1) / T::S;
  const int64_t first = blockIdx.x / T::H, stride = gridDim.x / T::H;
  // the window bits j sit at jshift of the flat index
  const int jshift = T::LOG_D2 + (MIDDLE ? log_b : 0);
  const int ndiag = diag.nphases + diag.nflips;
  const int ntab = ndiag < TABLE ? ndiag : TABLE;

  // W1's rows h IN + ii in fragment order (n-tile ii / 8, k-step j / 8:
  // lane (g, t) holds W1[8 it + g][8 ks + 2t] and [8 ks + 2t + 1], re and
  // im: the paired k order), the grids of those rows and of W2's, per k-step
  const float* w1h = w1 + h * T::IN * D1;
  for (int e = tid; e < T::KS1 * T::IN; e += THREADS) {
    const int ii = e % T::IN, ks = e / T::IN;
    grid1[e] = grid_of_row8(w1h + ii * D1 + 8 * ks,
                            w1h + D1 * D1 + ii * D1 + 8 * ks);
  }
  for (int e = tid; e < T::KS2 * D2; e += THREADS) {
    const int l = e % D2, ks = e / D2;
    grid2[e] = grid_of_row8(w2 + l * D2 + 8 * ks,
                            w2 + D2 * D2 + l * D2 + 8 * ks);
  }
  for (int e = tid; e < T::IN * D1; e += THREADS) {
    const int ii = e >> T::LOG_D1, j = e & (D1 - 1);
    const int frag = (ii >> 3) * T::KS1 + (j >> 3);
    const int ln = (ii & 7) * 4 + ((j & 7) >> 1), half = j & 1;
    float* f = w1s + (frag * 32 + ln) * 4;
    f[half] = w1h[e];
    f[2 + half] = w1h[D1 * D1 + e];
  }
  diag_tables<D1, true>(diag, jshift, jtab, comb, cmask, cwant);

  auto unit_of = [&](int64_t s) { return first + (s / T::ITEMS) * stride; };
  // middle: the flat index of unit u's (j, m, s) = (0, 0, 0) element, a D1
  // D2 B + b0
  auto unit_base = [&](int64_t u) {
    return ((u >> (log_b - T::LOG_S)) << (T::LOG_D1 + T::LOG_D2 + log_b)) |
           ((u << T::LOG_S) & ((int64_t(1) << log_b) - 1));
  };
  // the slab of the trailing pair's row r = (s, m) of unit u
  auto slab_of = [&](int64_t u, int r) { return u * T::S + (r >> T::LOG_D2); };
  // the flat index of the j = 0 element of the unit's row r: (s, m) in the
  // trailing pair, (m, s) in the middle pair
  auto row_base = [&](int64_t u, int r) -> int64_t {
    if constexpr (MIDDLE) {
      return unit_base(u) + (int64_t(r >> T::LOG_S) << log_b) +
             (r & (T::S - 1));
    } else {
      return (slab_of(u, r) << (T::LOG_D1 + T::LOG_D2)) + (r & (D2 - 1));
    }
  };
  auto load = [&](int64_t s, int stage) {
    const int64_t u = unit_of(s);
    const int r = int(s % T::ITEMS);
    float* st = ring + stage * T::STAGE;
    if (r < T::ITEMS1) {
      // rows r0.. of the unit's X, j0..j0 + BK1: runs of 4 rows (m, or s),
      // 16 bytes
      const int r0 = (r / T::CH1) * T::RM;
      const int j0 = (r % T::CH1) * T::BK1;
      constexpr int RQ = T::RM / 4;
      for (int e = tid; e < 2 * T::BK1 * RQ; e += THREADS) {
        const int rq = e % RQ, k = (e / RQ) % T::BK1,
                  pl = e / (RQ * T::BK1);
        const int rl = r0 + 4 * rq;
        const bool ok = MIDDLE || slab_of(u, rl) < slabs;
        cp_async(st + pl * T::PLANE + k * T::P1 + 4 * rq,
                 psi + (pl0 + pl) * n_amps +
                     (ok ? row_base(u, rl) + (int64_t(j0 + k) << jshift) : 0),
                 16, ok);
      }
    } else {
      // W2[:, m0..m0 + BK2]
      const int m0 = ((r - T::ITEMS1) % T::CH2) * T::BK2;
      constexpr int KQ = T::BK2 / 4;
      for (int e = tid; e < 2 * D2 * KQ; e += THREADS) {
        const int kq = e % KQ, l = (e / KQ) % D2, pl = e / (KQ * D2);
        cp_async(st + pl * T::PLANE + l * T::P2 + kq * 4,
                 w2 + pl * D2 * D2 + l * D2 + m0 + kq * 4, 16, true);
      }
    }
  };

  const int64_t my_units =
      units > first ? (units - 1 - first) / stride + 1 : 0;
  const int64_t items = my_units * T::ITEMS;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < items) load(s, s);
    cp_async_commit();
  }

  float acc[T::NA][2][4];
  uint32_t colhit[2];
  for (int64_t s = 0, stage = 0; s < items;
       ++s, stage = stage == STAGES - 1 ? 0 : stage + 1) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int64_t u = unit_of(s);
    const int r = int(s % T::ITEMS);
    const float* st = ring + stage * T::STAGE;
    // item s + STAGES - 1 goes to the stage item s - 1 used, once this
    // item's operands from the ring are loaded (phase 1) or at once (phase
    // 2, whose ring operand is this stage's W2)
    auto prefetch = [&]() {
      if (s + STAGES - 1 < items)
        load(s + STAGES - 1, stage == 0 ? STAGES - 1 : int(stage) - 1);
      cp_async_commit();
    };
    if (r < T::ITEMS1) {
      // phase 1, K = j: the lane's fragment rows g and g + 8 are the
      // unit's rows ur and ur + 1, side by side in the stage
      const int rt = r / T::CH1, chunk = r % T::CH1;
      const int rl = 16 * warp + 2 * g;  // in the row tile
      const int ur = rt * T::RM + rl;
      if (chunk == 0) {
#pragma unroll
        for (int it = 0; it < T::NI1; ++it) {
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[it][q >> 2][q & 3] = 0.f;
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          colhit[rr] = col_hits(row_base(u, ur + rr), ntab, cmask, cwant);
      }
      // rows g and g + 8 at k = 2t, 2t + 1 of each k-step: one 8-byte load
      // a k
      float xr[T::KC1][4], xi[T::KC1][4];
#pragma unroll
      for (int kc = 0; kc < T::KC1; ++kc) {
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {
          const int off = (kc * 8 + 2 * t + hk) * T::P1 + rl;
          const float2 vr = *reinterpret_cast<const float2*>(st + off);
          const float2 vi =
              *reinterpret_cast<const float2*>(st + T::PLANE + off);
          xr[kc][2 * hk] = vr.x, xr[kc][2 * hk + 1] = vr.y;
          xi[kc][2 * hk] = vi.x, xi[kc][2 * hk + 1] = vi.y;
        }
      }
      prefetch();
      if (ndiag) {
        diag_fragments<T::KC1, true>(
            xr, xi, diag, ndiag, chunk * T::BK1, jshift, jtab, comb, colhit,
            [&](int rr) { return row_base(u, ur + rr); });
      }
      const ASplit<T::KC1> a(xr, xi);
      tc_products<T::KC1, T::NI1>(acc, a, [&](int it, int kc,
                                              BFrag& b) {
        const int ks = chunk * T::KC1 + kc;
        const float4 f = reinterpret_cast<const float4*>(
            w1s)[(it * T::KS1 + ks) * 32 + lane];
        b.set(f.x, f.y, f.z, f.w, grid1[ks * T::IN + it * 8 + g]);
      });
      if (chunk == T::CH1 - 1) {
        // Y: accumulator q = 0, 1 holds i = 8 it + 2t, 2t + 1 of row ur,
        // q = 2, 3 the same of row ur + 1
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int yr = ur + rr;
#pragma unroll
          for (int it = 0; it < T::NI1; ++it) {
#pragma unroll
            for (int pl = 0; pl < 2; ++pl) {
              const float v0 = acc[it][pl][2 * rr];
              const float v1 = acc[it][pl][2 * rr + 1];
              if constexpr (MIDDLE) {
                // Y[m][(i, s)] of row (m, s)
                float* y = ys + pl * T::YPLANE + (yr >> T::LOG_S) * T::PY +
                           ((8 * it + 2 * t) << T::LOG_S) + (yr & (T::S - 1));
                y[0] = v0;
                y[T::S] = v1;
              } else {
                *reinterpret_cast<float2*>(ys + pl * T::YPLANE + yr * T::PY +
                                           8 * it + 2 * t) =
                    make_float2(v0, v1);
              }
            }
          }
        }
      }
    } else {
      // phase 2: the lane's rows c = (s, i) are col (+ 8), K = m
      const int q2 = r - T::ITEMS1, ct = q2 / T::CH2, chunk = q2 % T::CH2;
      const int col = ct * T::BN2 + 16 * wc + g;
      if (chunk == 0) {
#pragma unroll
        for (int it = 0; it < T::NI2; ++it) {
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[it][q >> 2][q & 3] = 0.f;
        }
      }
      prefetch();
      float xr[T::KC2][4], xi[T::KC2][4];
#pragma unroll
      for (int kc = 0; kc < T::KC2; ++kc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = col + 8 * (e & 1);
          const int m = chunk * T::BK2 + kc * 8 + k_of<true>(t, e);
          // row c is i << LOG_S | s (middle), s << LOG_IN | i (trailing)
          const int off =
              MIDDLE ? m * T::PY + c
                     : (((c >> T::LOG_IN) << T::LOG_D2) + m) * T::PY +
                           (c & (T::IN - 1));
          xr[kc][e] = ys[off];
          xi[kc][e] = ys[T::YPLANE + off];
        }
      }
      // Y, FP32 in shared memory, split anew into hi and lo on grids, as
      // the reference's second _dot splits its FP32 operand
      const ASplit<T::KC2> a(xr, xi);
      tc_products<T::KC2, T::NI2>(acc, a, [&](int it, int kc,
                                              BFrag& b) {
        const int l = (wi * T::NI2 + it) * 8 + g;
        const float* w = st + l * T::P2 + kc * 8 + 2 * t;
        const float2 re = *reinterpret_cast<const float2*>(w);
        const float2 im = *reinterpret_cast<const float2*>(w + T::PLANE);
        b.set(re.x, re.y, im.x, im.y, grid2[(chunk * T::KC2 + kc) * D2 + l]);
      });
      if (chunk == T::CH2 - 1) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = col + 8 * rr;
          // the flat index of output (i, l) = (c's i, 0); l strides by B
          // (middle) or 1 (trailing: l, l + 1 in one 8-byte store)
          int64_t base;
          if constexpr (MIDDLE) {
            base = unit_base(u) +
                   (int64_t(h * T::IN + (c >> T::LOG_S))
                    << (T::LOG_D2 + log_b)) +
                   (c & (T::S - 1));
          } else {
            const int64_t slab = u * T::S + (c >> T::LOG_IN);
            if (slab >= slabs) continue;
            base = (slab << (T::LOG_D1 + T::LOG_D2)) +
                   (int64_t(h * T::IN + (c & (T::IN - 1))) << T::LOG_D2);
          }
#pragma unroll
          for (int it = 0; it < T::NI2; ++it) {
            const int l = (wi * T::NI2 + it) * 8 + 2 * t;
#pragma unroll
            for (int pl = 0; pl < 2; ++pl) {
              float* o = out + (pl0 + pl) * n_amps + base;
              if constexpr (MIDDLE) {
                o[int64_t(l) << log_b] = acc[it][pl][2 * rr];
                o[int64_t(l + 1) << log_b] = acc[it][pl][2 * rr + 1];
              } else {
                *reinterpret_cast<float2*>(o + l) =
                    make_float2(acc[it][pl][2 * rr], acc[it][pl][2 * rr + 1]);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int D1, int D2, bool MIDDLE, int PREC>
int launch_tc(const PairArgs& a) {
  using T = PairTile<D1, D2, MIDDLE>;
  // the middle pair's units are S consecutive b of one a
  if (MIDDLE && a.log_b < T::LOG_S)
    return static_cast<int>(cudaErrorInvalidValue);
  static int blocks_cap[MAX_DEVICES] = {};  // resident blocks, per device
  cudaError_t err;
  const int cap =
      resident_blocks(pair_tc_kernel<D1, D2, MIDDLE, PREC>, T::SMEM,
                      blocks_cap, err);
  if (cap == 0) return static_cast<int>(err);
  const int64_t slabs = a.n_amps >> (T::LOG_D1 + T::LOG_D2);
  const int64_t work = (slabs + T::S - 1) / T::S * T::H;
  // every part of a unit in the same round: whole units of H blocks
  const unsigned grid = particle_grid(work, cap, a.particles, T::H);
  const Diag diag{a.flips, a.nflips, a.masks, a.wants,
                  a.phase, a.nphases, a.n_amps - 1};
  pair_tc_kernel<D1, D2, MIDDLE, PREC>
      <<<dim3(grid, a.particles), THREADS, T::SMEM, a.stream>>>(
          a.psi, a.out, a.w1, a.w2, a.n_amps, a.log_b, diag);
  return static_cast<int>(cudaGetLastError());
}

// the body of pair_tc_launch<D1, MIDDLE, PREC>, in pair_tc.cu; the
// trailing pair at D2 = 128 and D1 >= 64 is pair_wg.cuh's
template <int D1, bool MIDDLE, int PREC>
int launch_tc_d2(const PairArgs& a) {
  switch (a.log_d2) {
    case 3: return launch_tc<D1, 8, MIDDLE, PREC>(a);
    case 4: return launch_tc<D1, 16, MIDDLE, PREC>(a);
    case 5: return launch_tc<D1, 32, MIDDLE, PREC>(a);
    case 6: return launch_tc<D1, 64, MIDDLE, PREC>(a);
    case 7:
      if constexpr (!MIDDLE && D1 >= 64) {
        return static_cast<int>(cudaErrorInvalidValue);
      } else {
        return launch_tc<D1, 128, MIDDLE, PREC>(a);
      }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
