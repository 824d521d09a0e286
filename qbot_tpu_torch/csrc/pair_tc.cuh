// Tensor-core pair kernel of the planar statevector executor: two adjacent
// windows in one pass over the state, at D1, D2 >= 8 (pair_apply.cu holds
// the entry point and the FP32 FMA variant of the narrower widths):
//
//   out[a, i, l, b] = sum_{j,m} W1[i, j] * W2[l, m] * (Phi F p)[a, j, m, b]
//
// - the trailing pair (B == 1) replaces the TPU kernel _pair_b1
//   (qbot_tpu/tpu/kernels.py:352);
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
// are exact on tensor cores that round toward zero).  A slab is one a of
// the trailing pair (contiguous, row-major in (j, m)) or one b-column of
// the middle pair (element (j, m) at flat index a D1 D2 B + (j D2 + m) B +
// b):
//   phase 1  Y[(s, j), l] = sum_m (Phi F X_s)[j, m] W2[l, m]: the A rows
//            are the slab rows, K = m; the flips and phases apply here, at
//            the elements' flat indices (window bits m at log B);
//   phase 2  out[i, (s, l)] = sum_j W1[i, j] Y[(s, j), l], from Y in shared
//            memory: the A rows are the columns (s, l), K = j, on grids per
//            column and k-step of j.
// A whole slab and both W do not fit in a block's 227 KiB at (128, 128)
// (128 KiB of slab, 128 KiB of each W).  So a persistent block owns
// LN = min(D2, 64) of the output columns l of every unit it takes, always
// the same part h of the D2 / LN, and the blocks of one unit's parts run
// side by side, so the second read of X hits L2.  A unit is S = 8192 /
// (D1 LN) slabs: consecutive a (trailing), or consecutive b of one a
// (middle); Y, the unit's (S D1) x LN outputs of phase 1, is always 8192
// complex values.  Consecutive units go to blocks that run at the same time
// (the persistent stride), so where the middle pair's runs of S b are
// shorter than a 32-byte sector (S = 4 at (32, 128)), the other half of the
// sector is the neighbouring block's and hits L2.
//
// Measured (chip_smoke.py phase 2 at 26 qubits, PERF.md): the middle
// (32, 128) pair at B = 2^14 takes 2.92 ms, 1.36x its two window launches:
// with LN = 32 (S = 8, whole sectors, X read four times) it ran within 1%,
// with LN = 16 31% slower; the same pair at B = 2^10 (16x shorter strides
// between the slab rows) takes 2.47 ms.  Its runs along b, one per (j, m)
// row 2^(log B + 2) bytes apart, set its pace beside the tile's issue rate.
//
// Shared memory at (128, 128), 219 KiB: the LN rows of W2 of part h in
// FP32, in fragment order, staged once and split as the fragments are
// built, as window_apply does at D = 128 (64 KiB), with their grids; W1's
// grids; Y (68 KiB with its row pads); a 3-stage cp.async ring of 16-deep
// chunks: X chunks of 128 rows in phase 1, then W1 chunks of all D1 rows in
// phase 2.  One ring for both phases: the copies of the next unit's X
// overlap this unit's phase 2.  The k of a k-step go in the paired order
// (tc_tile.cuh: k_of).  In phase 1 each of the 8 warps owns 16 rows and
// all LN outputs; phase 2 tiles the columns (s, l) as window_apply tiles
// B > 1 (two warps along the outputs i at D1 >= 64).  Layouts, whose pads
// put the 32 lanes of every fragment load in distinct banks:
// - trailing: an X stage is [plane][row (s, j)][m], so a lane loads its two
//   k of a row with one 8-byte load; Y is [plane][(s, j)][l];
// - middle: X arrives as runs of S floats along b, so an X stage is
//   [plane][m][row (j, s)], s fastest, as window_apply's B > 1 stage is
//   [k][c]; Y is [plane][j][(l, s)], s fastest, so phase 2's columns, and
//   the lanes that store them, run along b.
//
// Build: the kernel has one instantiation per (D1, D2) and orientation,
// the longest compile of the library.  So this header is instantiated in
// small sources of their own, one per D1 and orientation
// (pair_tc_trailing_<D1>.cu, pair_tc_middle_<D1>.cu), which nvcc compiles
// in parallel (tpu/kernels.py:build_kernels); each defines the launcher
// pair_tc_launch<D1, MIDDLE> declared below, which pair_apply.cu calls.
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
};

// The launcher of the tensor-core pair at one D1 and orientation (every D2
// of 8-128); returns the launch's cudaGetLastError(), cudaErrorInvalidValue
// for another D2.
template <int D1, bool MIDDLE>
int pair_tc_launch(const PairArgs& args);
template <> int pair_tc_launch<8, false>(const PairArgs&);
template <> int pair_tc_launch<16, false>(const PairArgs&);
template <> int pair_tc_launch<32, false>(const PairArgs&);
template <> int pair_tc_launch<64, false>(const PairArgs&);
template <> int pair_tc_launch<128, false>(const PairArgs&);
template <> int pair_tc_launch<8, true>(const PairArgs&);
template <> int pair_tc_launch<16, true>(const PairArgs&);
template <> int pair_tc_launch<32, true>(const PairArgs&);

namespace {

constexpr int MAX_LN = 64;  // output columns l a block owns, at most

template <int D1, int D2, bool MIDDLE>
struct PairTile {
  static constexpr int LOG_D1 = ilog2(D1), LOG_D2 = ilog2(D2);
  static constexpr int LN = D2 < MAX_LN ? D2 : MAX_LN;
  static constexpr int LOG_LN = ilog2(LN);
  static constexpr int H = D2 / LN;              // blocks (parts of l) a unit
  static constexpr int S = 8192 / (D1 * LN);     // slabs a unit
  static constexpr int LOG_S = ilog2(S);
  // phase 1: the unit's rows in tiles of RM, 16 a warp, K = m
  static constexpr int RM = WARPS * 16;
  static constexpr int ROWS = S * D1;
  static constexpr int KS1 = D2 / 8;             // k-steps of 8 m
  static constexpr int NI1 = LN / 8;             // n-tiles of l a warp
  static constexpr int BK1 = D2 < 16 ? D2 : 16;  // m per stage
  static constexpr int KC1 = BK1 / 8;
  static constexpr int CH1 = D2 / BK1;
  // X stage: [plane][row][m] (trailing), [plane][m][row] (middle)
  static constexpr int P1 = MIDDLE ? RM + 4 : BK1 + 8;
  static constexpr int XPLANE = (MIDDLE ? BK1 : RM) * P1;
  // phase 2: the unit's columns (s, l) in tiles of BN2, K = j
  static constexpr int KS2 = D1 / 8;
  static constexpr int WI2 = D1 >= 64 ? 2 : 1;   // warps along the outputs i
  static constexpr int NI2 = KS2 / WI2;
  static constexpr int BN2 = (WARPS / WI2) * 16;
  static constexpr int COLS = S * LN;
  static constexpr int BK2 = D1 < 16 ? D1 : 16;  // j per stage
  static constexpr int KC2 = BK2 / 8;
  static constexpr int CH2 = D1 / BK2;
  static constexpr int P2 = BK2 + 8;             // W1 stage: [plane][i][j]
  static constexpr int NA = NI1 > NI2 ? NI1 : NI2;
  // items of a unit: phase 1 (row tile, m chunk), then phase 2 (column
  // tile, j chunk)
  static constexpr int ITEMS1 = ROWS / RM * CH1;
  static constexpr int ITEMS = ITEMS1 + COLS / BN2 * CH2;
  // Y: [plane][(s, j)][l] (trailing), [plane][j][(l, s)] (middle).  The
  // pads put the lanes of a fragment load in distinct banks: P1 and P2 for
  // the loads of rows g at k = 2t, 2t + 1 (the paired k order), PY for the
  // loads of rows j = 2t (+ 1)
  static constexpr int PY = MIDDLE ? COLS + 4 : LN + 4;
  static constexpr int YPLANE = (MIDDLE ? D1 : ROWS) * PY;
  static constexpr int PLANE = XPLANE > D1 * P2 ? XPLANE : D1 * P2;
  static constexpr int STAGE = 2 * PLANE;
  static constexpr int W2_FLOATS = 2 * LN * D2;
  // the stages, W2's rows (fragment order), their grids ([k-step][l]), W1's
  // grids ([k-step][i]), Y; then jtab, comb, cmask and cwant
  static constexpr int SMEM =
      4 * (STAGES * STAGE + W2_FLOATS + KS1 * LN + KS2 * D1 + 2 * YPLANE +
           D2) +
      8 * (1 << TABLE) + 16 * TABLE;
  static_assert(ROWS % RM == 0 && COLS % BN2 == 0, "pair tile");
  static_assert(!MIDDLE || (S >= 4 && S <= 128 && D1 <= 32),
                "middle pair: 16-byte runs of b, S <= B");
  static_assert(SMEM <= MAX_SMEM, "pair tile shared memory");
};

template <int D1, int D2, bool MIDDLE>
__global__ void __launch_bounds__(THREADS, 1)
    pair_tc_kernel(const float* __restrict__ psi, float* __restrict__ out,
                   const float* __restrict__ w1, const float* __restrict__ w2,
                   int64_t n_amps, int log_b, const Diag diag) {
  using T = PairTile<D1, D2, MIDDLE>;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* w2s = ring + STAGES * T::STAGE;
  float* grid2 = w2s + T::W2_FLOATS;
  float* grid1 = grid2 + T::KS1 * T::LN;
  float* ys = grid1 + T::KS2 * D1;
  uint32_t* jtab = reinterpret_cast<uint32_t*>(ys + 2 * T::YPLANE);
  float2* comb = reinterpret_cast<float2*>(jtab + D2);
  long long* cmask = reinterpret_cast<long long*>(comb + (1 << TABLE));
  long long* cwant = cmask + TABLE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wi = warp % T::WI2, wc = warp / T::WI2;  // phase 2
  const int h = blockIdx.x % T::H;                   // the block's part of l
  // trailing: slab rows (a, j) and slabs; the middle pair's units are
  // whole (S <= 128 <= B)
  const int64_t rows = n_amps >> T::LOG_D2;
  const int64_t slabs = rows >> T::LOG_D1;
  const int64_t units = MIDDLE ? slabs >> T::LOG_S : (slabs + T::S - 1) / T::S;
  const int64_t first = blockIdx.x / T::H, stride = gridDim.x / T::H;
  const int wshift = MIDDLE ? log_b : 0;  // the window bits m sit at wshift
  const int ndiag = diag.nphases + diag.nflips;
  const int ntab = ndiag < TABLE ? ndiag : TABLE;

  // W2's rows h LN + ll in fragment order (n-tile ll / 8, k-step m / 8:
  // lane (g, t) holds W2[8 it + g][8 ks + 2t] and [8 ks + 2t + 1], re and
  // im: the paired k order), the grids of those rows and of W1's, per k-step
  const float* w2h = w2 + h * T::LN * D2;
  for (int e = tid; e < T::KS1 * T::LN; e += THREADS) {
    const int ll = e % T::LN, ks = e / T::LN;
    grid2[e] = grid_of_row8(w2h + ll * D2 + 8 * ks,
                            w2h + D2 * D2 + ll * D2 + 8 * ks);
  }
  for (int e = tid; e < T::KS2 * D1; e += THREADS) {
    const int i = e % D1, ks = e / D1;
    grid1[e] = grid_of_row8(w1 + i * D1 + 8 * ks,
                            w1 + D1 * D1 + i * D1 + 8 * ks);
  }
  for (int e = tid; e < T::LN * D2; e += THREADS) {
    const int ll = e >> T::LOG_D2, m = e & (D2 - 1);
    const int frag = (ll >> 3) * T::KS1 + (m >> 3);
    const int ln = (ll & 7) * 4 + ((m & 7) >> 1), half = m & 1;
    float* f = w2s + (frag * 32 + ln) * 4;
    f[half] = w2h[e];
    f[2 + half] = w2h[D2 * D2 + e];
  }
  diag_tables<D2>(diag, wshift, jtab, comb, cmask, cwant);

  auto unit_of = [&](int64_t s) { return first + (s / T::ITEMS) * stride; };
  // middle: the flat index of unit u's (j, m, s) = (0, 0, 0) element, a D1
  // D2 B + b0
  auto unit_base = [&](int64_t u) {
    return ((u >> (log_b - T::LOG_S)) << (T::LOG_D1 + T::LOG_D2 + log_b)) |
           ((u << T::LOG_S) & ((int64_t(1) << log_b) - 1));
  };
  // the flat index of the m = 0 element of the unit's row r: (s, j) in the
  // trailing pair, (j, s) in the middle pair
  auto row_base = [&](int64_t u, int r) -> int64_t {
    if constexpr (MIDDLE) {
      return unit_base(u) +
             ((int64_t(r >> T::LOG_S) << T::LOG_D2) << log_b) +
             (r & (T::S - 1));
    } else {
      return (u * T::ROWS + r) << T::LOG_D2;
    }
  };
  auto load = [&](int64_t s, int stage) {
    const int64_t u = unit_of(s);
    const int r = int(s % T::ITEMS);
    float* st = ring + stage * T::STAGE;
    if (r < T::ITEMS1) {
      // rows r0.. of the unit's X, m0..m0 + BK1
      const int r0 = (r / T::CH1) * T::RM;
      const int m0 = (r % T::CH1) * T::BK1;
      if constexpr (MIDDLE) {
        // runs of 4 s (16 bytes) of one (j, m)
        constexpr int RQ = T::RM / 4;
        const int64_t base = row_base(u, r0) + (int64_t(m0) << log_b);
        for (int e = tid; e < 2 * T::BK1 * RQ; e += THREADS) {
          const int rq = e % RQ, k = (e / RQ) % T::BK1,
                    pl = e / (RQ * T::BK1);
          const int rl = 4 * rq;
          const int64_t off =
              ((int64_t(((rl >> T::LOG_S) << T::LOG_D2) + k)) << log_b) +
              (rl & (T::S - 1));
          cp_async(st + pl * T::PLANE + k * T::P1 + rl,
                   psi + pl * n_amps + base + off, 16, true);
        }
      } else {
        constexpr int KQ = T::BK1 / 4;
        const int64_t row0 = u * T::ROWS + r0;
        for (int e = tid; e < 2 * T::RM * KQ; e += THREADS) {
          const int kq = e % KQ, rl = (e / KQ) % T::RM,
                    pl = e / (KQ * T::RM);
          const int64_t row = row0 + rl;
          const bool ok = row < rows;
          cp_async(st + pl * T::PLANE + rl * T::P1 + kq * 4,
                   psi + pl * n_amps +
                       (ok ? (row << T::LOG_D2) + m0 + kq * 4 : 0),
                   16, ok);
        }
      }
    } else {
      // W1[:, j0..j0 + BK2]
      const int j0 = ((r - T::ITEMS1) % T::CH2) * T::BK2;
      constexpr int KQ = T::BK2 / 4;
      for (int e = tid; e < 2 * D1 * KQ; e += THREADS) {
        const int kq = e % KQ, i = (e / KQ) % D1, pl = e / (KQ * D1);
        cp_async(st + pl * T::PLANE + i * T::P2 + kq * 4,
                 w1 + pl * D1 * D1 + i * D1 + j0 + kq * 4, 16, true);
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
    // 2, whose ring operand is this stage's W1)
    auto prefetch = [&]() {
      if (s + STAGES - 1 < items)
        load(s + STAGES - 1, stage == 0 ? STAGES - 1 : int(stage) - 1);
      cp_async_commit();
    };
    if (r < T::ITEMS1) {
      // phase 1: the lane's rows are ur (+ 8) of the unit, K = m
      const int rt = r / T::CH1, chunk = r % T::CH1;
      const int rl = 16 * warp + g;  // row g of the warp, in the row tile
      const int ur = rt * T::RM + rl;
      if (chunk == 0) {
#pragma unroll
        for (int it = 0; it < T::NI1; ++it) {
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[it][q >> 2][q & 3] = 0.f;
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          colhit[rr] = col_hits(row_base(u, ur + 8 * rr), ntab, cmask, cwant);
      }
      // rows g and g + 8 at k = 2t, 2t + 1 of each k-step: 8-byte loads
      // along m (trailing), two 4-byte loads along the rows (middle)
      float xr[T::KC1][4], xi[T::KC1][4];
#pragma unroll
      for (int kc = 0; kc < T::KC1; ++kc) {
#pragma unroll
        for (int r8 = 0; r8 < 2; ++r8) {
          if constexpr (MIDDLE) {
#pragma unroll
            for (int hk = 0; hk < 2; ++hk) {
              const int off = (kc * 8 + 2 * t + hk) * T::P1 + rl + 8 * r8;
              xr[kc][2 * hk + r8] = st[off];
              xi[kc][2 * hk + r8] = st[T::PLANE + off];
            }
          } else {
            const int off = (rl + 8 * r8) * T::P1 + kc * 8 + 2 * t;
            const float2 vr = *reinterpret_cast<const float2*>(st + off);
            const float2 vi =
                *reinterpret_cast<const float2*>(st + T::PLANE + off);
            xr[kc][r8] = vr.x, xr[kc][2 + r8] = vr.y;
            xi[kc][r8] = vi.x, xi[kc][2 + r8] = vi.y;
          }
        }
      }
      prefetch();
      if (ndiag) {
        diag_fragments<T::KC1, true>(
            xr, xi, diag, ndiag, chunk * T::BK1, wshift, jtab, comb, colhit,
            [&](int rr) { return row_base(u, ur + 8 * rr); });
      }
      const ASplit<T::KC1> a(xr, xi);
      tc_products<T::KC1, T::NI1>(acc, a, [&](int it, int kc, BFrag& b) {
        const int ks = chunk * T::KC1 + kc;
        const float4 f = reinterpret_cast<const float4*>(
            w2s)[(it * T::KS1 + ks) * 32 + lane];
        b.set(f.x, f.y, f.z, f.w, grid2[ks * T::LN + it * 8 + g]);
      });
      if (chunk == T::CH1 - 1) {
        // Y: accumulator q = 0, 1 holds l = 8 it + 2t, 2t + 1 of row g,
        // q = 2, 3 the same of row g + 8
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int yr = ur + 8 * rr;
#pragma unroll
          for (int it = 0; it < T::NI1; ++it) {
#pragma unroll
            for (int pl = 0; pl < 2; ++pl) {
              const float v0 = acc[it][pl][2 * rr];
              const float v1 = acc[it][pl][2 * rr + 1];
              if constexpr (MIDDLE) {
                // Y[j][(l, s)] of row (j, s)
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
      // phase 2: the lane's columns c = (s, l) are col (+ 8), K = j
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
          const int j = chunk * T::BK2 + kc * 8 + k_of<true>(t, e);
          // column c is l << LOG_S | s (middle), s << LOG_LN | l (trailing)
          const int off =
              MIDDLE ? j * T::PY + c
                     : (((c >> T::LOG_LN) << T::LOG_D1) + j) * T::PY +
                           (c & (T::LN - 1));
          xr[kc][e] = ys[off];
          xi[kc][e] = ys[T::YPLANE + off];
        }
      }
      const ASplit<T::KC2> a(xr, xi);
      tc_products<T::KC2, T::NI2>(acc, a, [&](int it, int kc, BFrag& b) {
        const int i = (wi * T::NI2 + it) * 8 + g;
        const float* w = st + i * T::P2 + kc * 8 + 2 * t;
        const float2 r = *reinterpret_cast<const float2*>(w);
        const float2 im = *reinterpret_cast<const float2*>(w + T::PLANE);
        b.set(r.x, r.y, im.x, im.y, grid1[(chunk * T::KC2 + kc) * D1 + i]);
      });
      if (chunk == T::CH2 - 1) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int c = col + 8 * rr;
          // the flat index of output (i, l) = (0, c's l) and the stride of i
          int64_t base;
          int log_i;
          if constexpr (MIDDLE) {
            base = unit_base(u) +
                   (int64_t(h * T::LN + (c >> T::LOG_S)) << log_b) +
                   (c & (T::S - 1));
            log_i = T::LOG_D2 + log_b;
          } else {
            const int64_t slab = u * T::S + (c >> T::LOG_LN);
            if (slab >= slabs) continue;
            base = (slab << (T::LOG_D1 + T::LOG_D2)) + h * T::LN +
                   (c & (T::LN - 1));
            log_i = T::LOG_D2;
          }
#pragma unroll
          for (int it = 0; it < T::NI2; ++it) {
            const int i = (wi * T::NI2 + it) * 8 + 2 * t;
#pragma unroll
            for (int pl = 0; pl < 2; ++pl) {
              float* o = out + pl * n_amps + base;
              o[int64_t(i) << log_i] = acc[it][pl][2 * rr];
              o[int64_t(i + 1) << log_i] = acc[it][pl][2 * rr + 1];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int D1, int D2, bool MIDDLE>
int launch_tc(const PairArgs& a) {
  using T = PairTile<D1, D2, MIDDLE>;
  // the middle pair's units are S consecutive b of one a
  if (MIDDLE && a.log_b < T::LOG_S)
    return static_cast<int>(cudaErrorInvalidValue);
  static int blocks_cap[MAX_DEVICES] = {};  // resident blocks, per device
  cudaError_t err;
  int cap = resident_blocks(pair_tc_kernel<D1, D2, MIDDLE>, T::SMEM,
                            blocks_cap, err);
  if (cap == 0) return static_cast<int>(err);
  cap -= cap % T::H;  // every part of a unit in the same round
  const int64_t slabs = a.n_amps >> (T::LOG_D1 + T::LOG_D2);
  const int64_t work = (slabs + T::S - 1) / T::S * T::H;
  const unsigned grid = static_cast<unsigned>(work < cap ? work : cap);
  const Diag diag{a.flips, a.nflips, a.masks, a.wants,
                  a.phase, a.nphases, a.n_amps - 1};
  pair_tc_kernel<D1, D2, MIDDLE><<<grid, THREADS, T::SMEM, a.stream>>>(
      a.psi, a.out, a.w1, a.w2, a.n_amps, a.log_b, diag);
  return static_cast<int>(cudaGetLastError());
}

// the body of pair_tc_launch<D1, MIDDLE>, in the source of that D1
template <int D1, bool MIDDLE>
int launch_tc_d2(const PairArgs& a) {
  switch (a.log_d2) {
    case 3: return launch_tc<D1, 8, MIDDLE>(a);
    case 4: return launch_tc<D1, 16, MIDDLE>(a);
    case 5: return launch_tc<D1, 32, MIDDLE>(a);
    case 6: return launch_tc<D1, 64, MIDDLE>(a);
    case 7: return launch_tc<D1, 128, MIDDLE>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
