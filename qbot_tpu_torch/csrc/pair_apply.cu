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
// Which widths take which variant:
// - the trailing pair (B == 1) with D1 >= 8 and D2 >= 8: pair_tc_kernel,
//   3xTF32 products on the tensor cores;
// - the trailing pair with D1 or D2 in {2, 4} (below the tile's k-step and
//   n-tile of 8), and every middle pair: pair_apply_kernel, FP32 FMAs.
//
// What bounds it on an H100: a pair does the FLOPs of its two windows,
// 8 * (D1 + D2) per complex amplitude, and saves one of their two state
// passes.  At 26 qubits the (128, 128) pair does 137 GFLOP against 1 GiB of
// traffic (0.32 ms at 3.35 TB/s): 2.05 ms at the card's 67 TFLOP/s FP32
// rate, 0.83 ms as 3xTF32 products on the 495 TFLOP/s TF32 tensor cores.
// It is bound by its products.
//
// The tensor-core variant takes its products from the window kernel's tile
// (tc_tile.cuh: mma.sync.m16n8k8 TF32 in a 3xTF32 split whose hi parts lie
// on a grid per row and k-step, so each k-step's hi*hi sums are exact on
// tensor cores that round toward zero).  A slab X (one a: D1 x D2,
// contiguous, row-major in (j, m)) goes through two window products:
//   phase 1  Y[j, l] = sum_m (Phi F X)[j, m] W2[l, m]: the trailing
//            window's orientation (the A rows are the slab rows j, K = m);
//            the flips and phases apply here, at flat index
//            a D1 D2 + j D2 + m;
//   phase 2  out[i, l] = sum_j W1[i, j] Y[j, l]: the middle window's (the A
//            rows are the columns l, K = j), from Y in shared memory, grids
//            per column l and k-step of j.
// A whole slab and both W do not fit in a block's 227 KiB at (128, 128)
// (128 KiB of slab, 128 KiB of each W).  So a persistent block owns
// LN = min(D2, 64) of the output columns l of every unit it takes, always
// the same part h of the D2 / LN, and the blocks of one unit's parts run
// side by side, so the second read of X hits L2.  A unit is
// S = 8192 / (D1 LN) consecutive slabs: Y, the unit's (S D1) x LN outputs of
// phase 1, is always 8192 complex values.  Shared memory at (128, 128),
// 219 KiB: the 64 rows of W2 of part h in FP32, in fragment order, staged
// once and split as the fragments are built, as window_apply does at
// D = 128 (64 KiB), with their grids; W1's grids; Y (68 KiB with its row
// pads); a 3-stage cp.async ring of 16-deep chunks (24 KiB a stage, padded
// rows: conflict-free fragment loads), X chunks of 128 rows in phase 1, then
// W1 chunks of all D1 rows in phase 2.  The k of a k-step go in the paired
// order (tc_tile.cuh: k_of), so a lane loads its two k of an X row, and of
// a W1 row, with one 8-byte load.  One ring for both phases: the copies of
// the next unit's X overlap this unit's phase 2.  In phase 1 each of the 8
// warps owns 16 rows and all LN outputs; phase 2 tiles the columns (s, l)
// as window_apply tiles B > 1 (two warps along the outputs i at
// D1 >= 64).
//
// The FP32 FMA variant (pair_apply_kernel): every output amplitude depends
// on the whole (D1, D2) slab of its (a, b), so a block holds S whole slabs
// in shared memory (S * D1 * D2 <= 16384 complex amplitudes, about
// 130 KiB: one block of 8 warps per SM at the widest pair).  Trailing
// pair: S consecutive a, each slab contiguous in memory, kept row by row.
// Middle pair: S consecutive b of one a, read and written in runs of S
// floats (S = 4 at D1 = 32, D2 = 128: 16-byte runs, a coalescing cost) and
// kept in that order, b fastest.  The block then runs two GEMMs on the
// slabs:
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
// banks.
#include "tc_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// trailing pair, D1 >= 8 and D2 >= 8: 3xTF32 tensor cores
// ---------------------------------------------------------------------------

template <int D1, int D2>
struct PairTile {
  static constexpr int LOG_D1 = ilog2(D1), LOG_D2 = ilog2(D2);
  static constexpr int LN = D2 < 64 ? D2 : 64;   // columns l a block owns
  static constexpr int LOG_LN = ilog2(LN);
  static constexpr int H = D2 / LN;              // blocks (parts of l) a unit
  static constexpr int S = 8192 / (D1 * LN);     // slabs a unit
  // phase 1: the unit's rows (s, j) in tiles of RM, 16 a warp, K = m
  static constexpr int RM = WARPS * 16;
  static constexpr int ROWS = S * D1;
  static constexpr int KS1 = D2 / 8;             // k-steps of 8 m
  static constexpr int NI1 = LN / 8;             // n-tiles of l a warp
  static constexpr int BK1 = D2 < 16 ? D2 : 16;  // m per stage
  static constexpr int KC1 = BK1 / 8;
  static constexpr int CH1 = D2 / BK1;
  static constexpr int P1 = BK1 + 8;             // X stage: [plane][row][m]
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
  // Y: [plane][(s, j)][l].  The pads put the lanes of a fragment load in
  // distinct banks: P1 and P2 for the 8-byte loads of rows g at k = 2t,
  // 2t + 1 (the paired k order), PY for the loads of rows j = 2t (+ 1)
  static constexpr int PY = LN + 4;
  static constexpr int YPLANE = ROWS * PY;
  static constexpr int PLANE = RM * P1 > D1 * P2 ? RM * P1 : D1 * P2;
  static constexpr int STAGE = 2 * PLANE;
  static constexpr int W2_FLOATS = 2 * LN * D2;
  // the stages, W2's rows (fragment order), their grids ([k-step][l]), W1's
  // grids ([k-step][i]), Y; then jtab, comb, cmask and cwant
  static constexpr int SMEM =
      4 * (STAGES * STAGE + W2_FLOATS + KS1 * LN + KS2 * D1 + 2 * YPLANE +
           D2) +
      8 * (1 << TABLE) + 16 * TABLE;
  static_assert(ROWS % RM == 0 && COLS % BN2 == 0, "pair tile");
  static_assert(SMEM <= MAX_SMEM, "pair tile shared memory");
};

template <int D1, int D2>
__global__ void __launch_bounds__(THREADS, 1)
    pair_tc_kernel(const float* __restrict__ psi, float* __restrict__ out,
                   const float* __restrict__ w1, const float* __restrict__ w2,
                   int64_t n_amps, const Diag diag) {
  using T = PairTile<D1, D2>;
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
  const int64_t rows = n_amps >> T::LOG_D2;          // slab rows (a, j)
  const int64_t slabs = rows >> T::LOG_D1;
  const int64_t units = (slabs + T::S - 1) / T::S;
  const int64_t first = blockIdx.x / T::H, stride = gridDim.x / T::H;
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
  diag_tables<D2>(diag, 0, jtab, comb, cmask, cwant);

  auto unit_of = [&](int64_t s) { return first + (s / T::ITEMS) * stride; };
  auto load = [&](int64_t s, int stage) {
    const int64_t u = unit_of(s);
    const int r = int(s % T::ITEMS);
    float* st = ring + stage * T::STAGE;
    if (r < T::ITEMS1) {
      // rows row0.. of X, m0..m0 + BK1
      const int64_t row0 = u * T::ROWS + (r / T::CH1) * T::RM;
      const int m0 = (r % T::CH1) * T::BK1;
      constexpr int KQ = T::BK1 / 4;
      for (int e = tid; e < 2 * T::RM * KQ; e += THREADS) {
        const int kq = e % KQ, rl = (e / KQ) % T::RM, pl = e / (KQ * T::RM);
        const int64_t row = row0 + rl;
        const bool ok = row < rows;
        cp_async(st + pl * T::PLANE + rl * T::P1 + kq * 4,
                 psi + pl * n_amps +
                     (ok ? (row << T::LOG_D2) + m0 + kq * 4 : 0),
                 16, ok);
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
      // phase 1: the lane's rows are row (+ 8) of the unit's slabs, K = m
      const int rt = r / T::CH1, chunk = r % T::CH1;
      const int rl = 16 * warp + g;  // row g of the warp, in the row tile
      const int64_t row = u * T::ROWS + rt * T::RM + rl;
      if (chunk == 0) {
#pragma unroll
        for (int it = 0; it < T::NI1; ++it) {
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[it][q >> 2][q & 3] = 0.f;
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          colhit[rr] = col_hits((row + 8 * rr) << T::LOG_D2, ntab, cmask,
                                cwant);
      }
      // rows g and g + 8 at k = 2t, 2t + 1 of each k-step: 8-byte loads
      float xr[T::KC1][4], xi[T::KC1][4];
#pragma unroll
      for (int kc = 0; kc < T::KC1; ++kc) {
#pragma unroll
        for (int r8 = 0; r8 < 2; ++r8) {
          const int off = (rl + 8 * r8) * T::P1 + kc * 8 + 2 * t;
          const float2 vr = *reinterpret_cast<const float2*>(st + off);
          const float2 vi =
              *reinterpret_cast<const float2*>(st + T::PLANE + off);
          xr[kc][r8] = vr.x, xr[kc][2 + r8] = vr.y;
          xi[kc][r8] = vi.x, xi[kc][2 + r8] = vi.y;
        }
      }
      prefetch();
      if (ndiag) {
        diag_fragments<T::KC1, true>(
            xr, xi, diag, ndiag, chunk * T::BK1, 0, jtab, comb, colhit,
            [&](int rr) { return (row + 8 * rr) << T::LOG_D2; });
      }
      const ASplit<T::KC1> a(xr, xi);
      tc_products<T::KC1, T::NI1>(acc, a, [&](int it, int kc, BFrag& b) {
        const int ks = chunk * T::KC1 + kc;
        const float4 f = reinterpret_cast<const float4*>(
            w2s)[(it * T::KS1 + ks) * 32 + lane];
        b.set(f.x, f.y, f.z, f.w, grid2[ks * T::LN + it * 8 + g]);
      });
      if (chunk == T::CH1 - 1) {
        // Y[(s, j)][l]: accumulator q = 0, 1 holds l = 8 it + 2t, 2t + 1 of
        // row g, q = 2, 3 the same of row g + 8
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int yrow = rt * T::RM + rl + 8 * rr;
#pragma unroll
          for (int it = 0; it < T::NI1; ++it) {
#pragma unroll
            for (int pl = 0; pl < 2; ++pl) {
              *reinterpret_cast<float2*>(ys + pl * T::YPLANE + yrow * T::PY +
                                         8 * it + 2 * t) =
                  make_float2(acc[it][pl][2 * rr], acc[it][pl][2 * rr + 1]);
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
          const int off = (((c >> T::LOG_LN) << T::LOG_D1) + j) * T::PY +
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
          const int64_t slab = u * T::S + (c >> T::LOG_LN);
          if (slab >= slabs) continue;
          const int64_t base = (slab << (T::LOG_D1 + T::LOG_D2)) +
                               h * T::LN + (c & (T::LN - 1));
#pragma unroll
          for (int it = 0; it < T::NI2; ++it) {
            const int i = (wi * T::NI2 + it) * 8 + 2 * t;
#pragma unroll
            for (int pl = 0; pl < 2; ++pl) {
              float* o = out + pl * n_amps + base;
              o[int64_t(i) << T::LOG_D2] = acc[it][pl][2 * rr];
              o[int64_t(i + 1) << T::LOG_D2] = acc[it][pl][2 * rr + 1];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int D1, int D2>
int launch_tc(const float* psi, float* out, const float* w1, const float* w2,
              int64_t n_amps, const Diag& diag, cudaStream_t stream) {
  using T = PairTile<D1, D2>;
  static int blocks_cap[MAX_DEVICES] = {};  // resident blocks, per device
  cudaError_t err;
  int cap = resident_blocks(pair_tc_kernel<D1, D2>, T::SMEM, blocks_cap, err);
  if (cap == 0) return static_cast<int>(err);
  cap -= cap % T::H;  // every part of a unit in the same round
  const int64_t slabs = n_amps >> (T::LOG_D1 + T::LOG_D2);
  const int64_t work = (slabs + T::S - 1) / T::S * T::H;
  const unsigned grid = static_cast<unsigned>(work < cap ? work : cap);
  pair_tc_kernel<D1, D2><<<grid, THREADS, T::SMEM, stream>>>(
      psi, out, w1, w2, n_amps, diag);
  return static_cast<int>(cudaGetLastError());
}

template <int D1>
int launch_tc_d2(int log_d2, const float* psi, float* out, const float* w1,
                 const float* w2, int64_t n_amps, const Diag& diag,
                 cudaStream_t s) {
  switch (log_d2) {
    case 3: return launch_tc<D1, 8>(psi, out, w1, w2, n_amps, diag, s);
    case 4: return launch_tc<D1, 16>(psi, out, w1, w2, n_amps, diag, s);
    case 5: return launch_tc<D1, 32>(psi, out, w1, w2, n_amps, diag, s);
    case 6: return launch_tc<D1, 64>(psi, out, w1, w2, n_amps, diag, s);
    case 7: return launch_tc<D1, 128>(psi, out, w1, w2, n_amps, diag, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_tc_any(int log_d1, int log_d2, const float* psi, float* out,
                  const float* w1, const float* w2, int64_t n_amps,
                  const Diag& diag, cudaStream_t s) {
  switch (log_d1) {
    case 3: return launch_tc_d2<8>(log_d2, psi, out, w1, w2, n_amps, diag, s);
    case 4: return launch_tc_d2<16>(log_d2, psi, out, w1, w2, n_amps, diag, s);
    case 5: return launch_tc_d2<32>(log_d2, psi, out, w1, w2, n_amps, diag, s);
    case 6: return launch_tc_d2<64>(log_d2, psi, out, w1, w2, n_amps, diag, s);
    case 7: return launch_tc_d2<128>(log_d2, psi, out, w1, w2, n_amps, diag, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// the middle pair, and trailing pairs with D1 or D2 < 8: FP32 FMAs
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

int log2_floor(int64_t x) {
  int k = 0;
  while ((int64_t(1) << (k + 1)) <= x) ++k;
  return k;
}

}  // namespace

// psi, out: (2, n_amps) float32, 16-byte aligned; w1: (2, D1, D1), w2:
// (2, D2, D2) float32, w1 16-byte aligned, with Di = 2^log_di; B = 2^log_b.
// B == 1 runs the trailing pair, B >= 128 with D1 <= 32 the middle pair;
// other geometries are refused (the caller runs two windows).  Returns the
// launch's cudaGetLastError().
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
  if (log_b == 0 && log_d1 >= 3 && log_d2 >= 3) {
    const Diag diag{flips, nflips, masks, wants, phase, nphases, n_amps - 1};
    return launch_tc_any(log_d1, log_d2, psi, out, w1, w2, n_amps, diag, s);
  }
  const int log_a = log2_floor(n_amps) - log_d1 - log_d2 - log_b;
  // slabs a block holds: up to MAX_TILE amplitudes and MAX_S slabs
  int log_s = log2_floor(MAX_TILE) - log_d1 - log_d2;
  if (log_s > log2_floor(MAX_S)) log_s = log2_floor(MAX_S);
  if (log_b == 0) {
    if (log_s > log_a) log_s = log_a;
  } else if (log_b < 7 || log_d1 > 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the padded rows of narrow slabs (D2 = 4 at D1 = 128) take more than
  // the 227 KiB a block has at MAX_TILE amplitudes
  while (log_s > 0 &&
         smem_bytes(log_b == 0, log_d1, log_d2, log_s) > MAX_SMEM)
    --log_s;
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
