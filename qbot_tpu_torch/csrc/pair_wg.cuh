// The f32 trailing pair at D2 = 128 and D1 = 64, 128 on Hopper's warpgroup
// products: every f32 and f32_mix pair launch of that geometry with B = 1
// (pair_apply.cu's dispatcher; every other pair keeps pair_tc.cuh's tile or
// its reduced kernels), with the particle axis and the fused flips and
// phases.  It replaces there the TPU kernel _pair_b1
// (qbot_tpu/tpu/kernels.py:352):
//
//   out[a, i, l] = sum_{j,m} W1[i, j] W2[l, m] (Phi F p)[a, j, m].
//
// What bounds it on an H100: the 3xTF32 products, 3 * 8 * (D1 + 128) FLOPs
// an amplitude at 495 TFLOP/s: 0.6247 ms at (8192, 64, 128, 1), 0.8330 ms
// at (4096, 128, 128, 1).  The mma.sync tile of pair_tc.cuh took 2.57 and
// 3.39 ms there (0.24-0.25 of the bound): mma.sync runs at 315-323 TFLOP/s
// on the card, and every warp split its B fragments of W again for every
// tile (the D = 128 window's limits, which window_wg.cuh lifted).
// Measured at 26 qubits on an NVIDIA H100 80GB HBM3 at 700 W with 3 flips
// and 3 phases (PERF.md, section 6): 1.49 ms at (64, 128), 1.89 ms at
// (128, 128), 0.42 and 0.44 of the bound.  Phase 1 waits on the producers'
// split of X (its products hide), phase 2 on its products, whose sums each
// consumer adds between its groups; with the products taken out the
// hand-offs, adds and copies alone take 0.71 ms at (128, 128).
//
// The arithmetic is window_wg.cuh's in both products: per k-step of 8 (j,
// then m) x split on the grid of its row and k-step (both planes), W on
// its row's; each k-step's hi sums from a zeroed accumulator added to the
// FP32 sums to nearest, then its cross terms x_hi W_lo + x_lo tf32(W)
// likewise.  W1 goes first: Y = W1 (Phi F X) stays in shared memory in
// FP32, and the second product splits it anew on the grids of its rows i
// and k-steps of m, as pair_apply_ref and the reference split their FP32
// intermediate.  tests/test_torch_window_split.py replays it in numpy
// (pair_wg_product).
//
// Design.  A slab is one a: X = (D1, 128), row-major in (j, m), contiguous.
// A unit is 64 output rows i of a slab (one unit a slab at D1 = 64, two at
// D1 = 128, whose blocks run side by side so that the second read of X
// hits L2): a whole slab's Y at D1 = 128 (128 KiB) would leave no room
// for the stages.  A block of four warpgroups owns an SM (223 KiB of
// shared memory) and walks units, a persistent grid over units and
// particles; a unit is D1 / 8 phase-1 items, then 16 phase-2 items, each a
// k-step in one stage of a ring of three:
//
// - phase 1, Y[i, m] = sum_j W1[i, j] X[j, m]: the A operand W1's parts of
//   the unit's 64 rows i (18 KiB a k-step, one bulk copy: -W1_im's three
//   parts beside the six, so that X needs no -im parts), the B operand X's
//   four parts, its 128 rows m (N = 128, K = j).  The k-step's X rows (4
//   KiB a plane) arrive by four bulk copies into a raw ring; a producer
//   reads them transposed, phases and splits them, and writes X's parts.
// - Y: each consumer writes its plane's sums as Y[plane][i][m] (FP32, rows
//   padded to 136 floats), and the two meet at a named barrier.
// - phase 2, out[i, l] = sum_m Y[i, m] W2[l, m]: the A operand from
//   registers, which each consumer loads from Y (both planes of its rows)
//   and splits itself, the next k-step's while the tensor cores sum the
//   cross terms of this one; the B operand W2's parts (24 KiB a k-step,
//   one bulk copy; a k-step's m in the order of the A fragment, which holds
//   a lane's two neighbouring m at k = t and t + 4).  A stage holds
//   nothing else.
//
// Two consumer warpgroups, one an output plane, issue the products and the
// round-to-nearest adds (each waits for its products before it reads their
// sum; the other keeps the tensor cores busy meanwhile), as window_wg's
// do.  Two producer warpgroups take the items in turns, so that splitting
// X keeps up with the products (one producer, as window_wg has, held
// phase 1 at its pace).  W1 and W2 are split once a launch
// (pair_wg_split_kernel) into a scratch of the wrapper's: W2's 384 KiB,
// then W1's, 18 KiB a k-step and unit row block.
#pragma once

#include "pair_tc.cuh"
#include "window_tc.cuh"

namespace {
namespace pwg {

constexpr int D2 = 128;
constexpr int LOG_D2 = 7;
constexpr int KS2 = D2 / 8;         // phase 2's k-steps (of m)
constexpr int NI = 64;              // output rows i of a unit
constexpr int BM = 64;              // columns m of a phase-1 half
constexpr int HALVES = D2 / BM;     // phase 1's halves
constexpr int THREADS = 4 * 128;    // consumers (re, im), then 2 producers
constexpr int PRODUCER = 2 * 128;   // the first producer's first thread
constexpr int CONSUMER_REGS = 200;
constexpr int PRODUCER_REGS = 56;
constexpr int STAGES = 3;           // stages of split operands
constexpr int RAW = 6;              // k-steps of raw X, 3 a producer

// A stage.  Phase 1: X's four parts (re hi, im hi, re lo, im lo), each
// 128 rows m x 8 k as [k half][8-row group][row][4 k], its k halves X_LBO
// bytes apart (a 64-byte pad puts a producer lane pair's two halves in
// distinct bank groups); then W1's nine parts of the unit's 64 rows i (re
// hi, im hi, re lo, im lo, re tf32, im tf32, -im hi, -im lo, -im tf32),
// likewise, its k halves W1_LBO bytes apart.  Phase 2: W2's six parts as
// window_wg's stage holds W's (128 rows, wg::B_LBO, wg::B_PART).
using wg::B_LBO;
using wg::B_PART;
using wg::GROUP;
using wg::W_STEP;
constexpr int X_LBO = D2 * 16 + 64;
constexpr int X_PART = X_LBO + D2 * 16;
constexpr int W1_LBO = NI * 16;
constexpr int W1_PART = 2 * W1_LBO;
constexpr int W1_STEP = 9 * W1_PART;  // bytes of a k-step's W1 parts
constexpr int OFF_W1 = 4 * X_PART;
constexpr int STAGE = OFF_W1 + W1_STEP > W_STEP ? OFF_W1 + W1_STEP : W_STEP;
// Y: [plane][i][m], rows PY floats apart (the 8-byte stores and loads of a
// half warp, 4 rows i by 4 lanes along m, fall in distinct banks)
constexpr int PY = D2 + 8;
constexpr int YPLANE = NI * PY;
// a raw k-step: [plane][k half] blocks of 4 rows j of X, each 4 * 128
// floats as the bulk copy writes them and 16 floats of pad (a lane pair's
// k halves in distinct banks)
constexpr int RAW_ROWS = 4 * D2;
constexpr int RAW_PITCH = RAW_ROWS + 16;
constexpr int RAW_STAGE = 4 * RAW_PITCH;

constexpr int OFF_Y = STAGES * STAGE;
constexpr int OFF_RAW = OFF_Y + 2 * YPLANE * 4;
constexpr int OFF_JTAB = OFF_RAW + RAW * RAW_STAGE * 4;
constexpr int OFF_COMB = OFF_JTAB + 4 * 128;
constexpr int OFF_CMASK = OFF_COMB + 8 * (1 << TABLE);
constexpr int OFF_CWANT = OFF_CMASK + 8 * TABLE;
constexpr int OFF_BARS = OFF_CWANT + 8 * TABLE;
constexpr int SMEM = OFF_BARS + (2 * STAGES + 2 * RAW) * 8;
static_assert(SMEM <= MAX_SMEM, "shared memory of a block");
static_assert(STAGE % 16 == 0 && OFF_W1 % 16 == 0 && OFF_RAW % 16 == 0 &&
                  RAW_PITCH % 4 == 0,
              "16-byte alignment");

// The scratch of W's split parts: W2's k-steps, then W1's (row block h,
// k-step s) at h * D1 / 8 + s
constexpr int OFF_SCRATCH_W1 = KS2 * W_STEP;
template <int D1>
constexpr int scratch_floats() {
  return (OFF_SCRATCH_W1 + D1 / NI * (D1 / 8) * W1_STEP) / 4;
}

// Block b < KS2: W2's k-step b, one thread a row, in the paired order of
// phase 2's A fragments; else W1's row block and k-step b - KS2, one thread
// a row of its 64.
template <int D1>
__global__ void __launch_bounds__(D2)
    pair_wg_split_kernel(const float* __restrict__ w1,
                         const float* __restrict__ w2,
                         float4* __restrict__ parts) {
  unsigned char* p = reinterpret_cast<unsigned char*>(parts);
  const int b = blockIdx.x, tid = threadIdx.x;
  if (b < KS2) {
    wg::split_w_row<D2, D2, true>(w2, p + b * W_STEP, tid, tid, b);
  } else if (tid < NI) {
    constexpr int KS1 = D1 / 8;
    const int e = b - KS2;
    wg::split_w_row<D1, NI, false, true>(
        w1, p + OFF_SCRATCH_W1 + e * W1_STEP, e / KS1 * NI + tid, tid,
        e % KS1);
  }
}

// the two consumer warpgroups meet (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCER) : "memory");
}

template <int D1>
__global__ void __launch_bounds__(THREADS, 1)
    pair_wg_kernel(const float* __restrict__ psi, float* __restrict__ out,
                   const float4* __restrict__ wparts, int64_t n_amps,
                   const Diag diag) {
  constexpr int LOG_D1 = ilog2(D1);
  constexpr int KS1 = D1 / 8;      // phase 1's k-steps (of j)
  constexpr int H = D1 / NI;       // units a slab
  constexpr int LOG_SLAB = LOG_D1 + LOG_D2;
  extern __shared__ __align__(1024) unsigned char pw_smem[];
  unsigned char* stages = pw_smem;
  float* ys = reinterpret_cast<float*>(pw_smem + OFF_Y);
  float* raws = reinterpret_cast<float*>(pw_smem + OFF_RAW);
  uint32_t* jtab = reinterpret_cast<uint32_t*>(pw_smem + OFF_JTAB);
  float2* comb = reinterpret_cast<float2*>(pw_smem + OFF_COMB);
  long long* cmask = reinterpret_cast<long long*>(pw_smem + OFF_CMASK);
  long long* cwant = reinterpret_cast<long long*>(pw_smem + OFF_CWANT);
  uint64_t* full = reinterpret_cast<uint64_t*>(pw_smem + OFF_BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* raw_full = empty + STAGES;
  uint64_t* raw_empty = raw_full + RAW;

  const int tid = threadIdx.x;
  const int pl0 = particle_plane();
  const int64_t units = (n_amps >> LOG_SLAB) * H;
  const int64_t my_units =
      units > blockIdx.x ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // the block's k-th unit
  auto unit_of = [&](int64_t k) { return blockIdx.x + k * gridDim.x; };

  // the window bits j sit at bit LOG_D2 of the flat index
  diag_tables<D1, true>(diag, LOG_D2, jtab, comb, cmask, cwant);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the 128 threads of the item's producer, and its first thread's
      // byte count
      mbar_init(&full[s], 128 + 1);
      mbar_init(&empty[s], 2 * 128);
    }
    for (int r = 0; r < RAW; ++r) {
      mbar_init(&raw_full[r], 1);
      mbar_init(&raw_empty[r], 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= PRODUCER) {
    // ------------- producers: the block's items of parity pw -------------
    regs_dec<PRODUCER_REGS>();
    const int pw = (tid - PRODUCER) >> 7;
    const int pt = (tid - PRODUCER) & 127, lane = pt & 31;
    // the row m of X (in each half of 64) and the k half this thread splits
    const int xc = (pt >> 5) * 16 + (lane >> 1), xh = lane & 1;
    const int ndiag = diag.nphases + diag.nflips;
    const int ntab = ndiag < TABLE ? ndiag : TABLE;
    const float4* w1parts = wparts + OFF_SCRATCH_W1 / 16;
    const int64_t raws_total = my_units * KS1;
    // the first thread: X rows 8 s .. 8 s + 7 of the slab of the block's
    // phase-1 item r (its unit's k-step s), both planes, into raw slot
    // r % RAW once every thread has read it
    auto issue_raw = [&](int64_t r) {
      const int slot = int(r % RAW);
      mbar_wait(&raw_empty[slot], uint32_t((r / RAW) & 1) ^ 1u);
      mbar_expect_bytes(&raw_full[slot], 4 * RAW_ROWS * 4);
      const int64_t slab = unit_of(r / KS1) / H;
      const float* src = psi + pl0 * n_amps + (slab << LOG_SLAB) +
                         int(r % KS1) * 8 * D2;
      float* dst = raws + slot * RAW_STAGE;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
          bulk_copy(dst + (2 * p + kh) * RAW_PITCH,
                    src + p * n_amps + kh * RAW_ROWS, RAW_ROWS * 4,
                    &raw_full[slot]);
      }
    };
    // this producer's phase-1 items are r = pw, pw + 2, ...; its raw
    // copies run two of them ahead
    if (pt == 0) {
      for (int64_t r = pw; r < pw + 4 && r < raws_total; r += 2)
        issue_raw(r);
    }
    // a unit's KS1 + KS2 items, even in number: the item's parity is its
    // k-step's
    int64_t item = pw, r = pw;
    for (int64_t k = 0; k < my_units; ++k) {
      const int64_t u = unit_of(k);
      const int h = int(u % H);
      const int64_t sbase = (u / H) << LOG_SLAB;
      uint32_t colhit[HALVES];
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh)
        colhit[hh] = col_hits(sbase | (hh * BM + xc), ntab, cmask, cwant);
      // phase 1: X's k-step s and W1's
#pragma unroll 1
      for (int s = pw; s < KS1; s += 2, item += 2, r += 2) {
        if (pt == 0 && r + 4 < raws_total) issue_raw(r + 4);
        const int slot = int(item % STAGES);
        mbar_wait(&empty[slot], uint32_t((item / STAGES) & 1) ^ 1u);
        unsigned char* st = stages + slot * STAGE;
        if (pt == 0) {
          mbar_expect_bytes(&full[slot], W1_STEP);
          bulk_copy(st + OFF_W1, w1parts + (h * KS1 + s) * (W1_STEP / 16),
                    W1_STEP, &full[slot]);
        }
        const int rs = int(r % RAW);
        mbar_wait(&raw_full[rs], uint32_t((r / RAW) & 1));
        const float* raw = raws + rs * RAW_STAGE + xh * RAW_PITCH;
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh) {
          // row m of X's parts, j = 8 s + 4 xh + q
          const int m = hh * BM + xc;
          float xr[4], xi[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            xr[q] = raw[q * D2 + m];
            xi[q] = raw[2 * RAW_PITCH + q * D2 + m];
          }
          if (ndiag) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int j = 8 * s + 4 * xh + q;
              phase_element<true>(xr[q], xi[q], colhit[hh] & jtab[j], comb,
                                  diag, ndiag, [&] {
                                    return sbase | (int64_t(j) << LOG_D2) |
                                           m;
                                  });
            }
          }
          wg::write_x_parts<X_LBO, X_PART, false>(st, m, xh, xr, xi);
        }
        mbar_arrive(&raw_empty[rs]);
        fence_async_smem();
        mbar_arrive(&full[slot]);
      }
      // phase 2: W2's k-step q
#pragma unroll 1
      for (int q = pw; q < KS2; q += 2, item += 2) {
        const int slot = int(item % STAGES);
        mbar_wait(&empty[slot], uint32_t((item / STAGES) & 1) ^ 1u);
        if (pt == 0) {
          mbar_expect_bytes(&full[slot], W_STEP);
          bulk_copy(stages + slot * STAGE, wparts + q * (W_STEP / 16),
                    W_STEP, &full[slot]);
        }
        mbar_arrive(&full[slot]);
      }
    }
  } else {
    // ---------------- consumers: output plane tid / 128 ----------------
    regs_inc<CONSUMER_REGS>();
    const int plane = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // The W1 part of each of this plane's six phase-1 products (the X part
    // is 0, 1, 0, 1, 2, 3): plane 0 sums W_re x_re + (-W_im) x_im, plane 1
    // W_im x_re + W_re x_im, each pair exact sum, then cross terms x_hi W_lo
    // + x_lo tf32(W), in window_wg's order.  Phase 2 takes -y_im in plane
    // 0 and W2's planes swapped in plane 1, as window_wg does.
    const int w1p[6] = {plane ? 1 : 0, plane ? 0 : 6, plane ? 3 : 2,
                        plane ? 2 : 7, plane ? 5 : 4, plane ? 4 : 8};
    const int w_first = plane, w_second = 1 - plane;
    const uint32_t neg = plane ? 0u : 0x80000000u;
    const uint32_t st0 = smem_addr(stages);
    // the descriptors of W1 part y and X part x (phase 1), and of W2 part y
    // (phase 2), in the stage at byte `base`
    auto W1 = [&](uint32_t base, int y) {
      return kmajor_desc(base + OFF_W1 + y * W1_PART, W1_LBO, GROUP);
    };
    auto X = [&](uint32_t base, int x) {
      return kmajor_desc(base + x * X_PART, X_LBO, GROUP);
    };
    auto W2 = [&](uint32_t base, int y) {
      return kmajor_desc(base + y * B_PART, B_LBO, GROUP);
    };
    float* yp = ys + plane * YPLANE;
    float* o = out + (pl0 + plane) * n_amps;
    // this lane's rows i of Y (g, g + 8 of its warp's 16), plane 0
    const float* y0 = ys + (16 * warp + g) * PY + 2 * t;
    float acc[64], d[64];
    // the products' sum, once in, added to acc to nearest
    auto add = [&]() {
      wgmma_wait<0>();
      fence_acc(d);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
    };
    // Phase 2's A fragments of k-step q: rows g, g + 8 at k = t, t + 4,
    // which hold m = 8 q + 2 t, 8 q + 2 t + 1 (W2's paired order), split on
    // the grids of the rows (tc_tile.cuh: row_grids); the im parts negated
    // in plane 0
    struct Frags {
      uint32_t rh[4], rl[4], ih[4], il[4];
    };
    auto frags = [&](int q, Frags& f) {
      float xr[4], xi[4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float2 vr =
            *reinterpret_cast<const float2*>(y0 + 8 * rr * PY + 8 * q);
        const float2 vi = *reinterpret_cast<const float2*>(
            y0 + YPLANE + 8 * rr * PY + 8 * q);
        xr[rr] = vr.x, xr[2 + rr] = vr.y;
        xi[rr] = vi.x, xi[2 + rr] = vi.y;
      }
      float mg[2];
      row_grids(xr, xi, mg[0], mg[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split(xr[e], mg[e & 1], f.rh[e], f.rl[e]);
        split(xi[e], mg[e & 1], f.ih[e], f.il[e]);
        f.ih[e] ^= neg;
        f.il[e] ^= neg;
      }
    };
    int64_t item = 0;
    for (int64_t k = 0; k < my_units; ++k) {
      const int64_t u = unit_of(k);
      // ---- phase 1: Y[i, m], the unit's 64 rows i by the slab's 128 m ----
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
#pragma unroll 1
      for (int s = 0; s < KS1; ++s, ++item) {
        const int slot = int(item % STAGES);
        mbar_wait(&full[slot], uint32_t((item / STAGES) & 1));
        const uint32_t base = st0 + slot * STAGE;
        // the exact sum of the hi parts from a zeroed accumulator, then the
        // cross terms, each added to nearest
        fence_acc(d);
        wgmma_fence();
        wgmma_tf32(d, W1(base, w1p[0]), X(base, 0), 0);
        wgmma_tf32(d, W1(base, w1p[1]), X(base, 1), 1);
        wgmma_commit();
        add();
        fence_acc(d);
        wgmma_fence();
        wgmma_tf32(d, W1(base, w1p[2]), X(base, 0), 0);
        wgmma_tf32(d, W1(base, w1p[3]), X(base, 1), 1);
        wgmma_tf32(d, W1(base, w1p[4]), X(base, 2), 1);
        wgmma_tf32(d, W1(base, w1p[5]), X(base, 3), 1);
        wgmma_commit();
        add();
        mbar_arrive(&empty[slot]);
      }
      // acc[4 j + e]: Y row i = 16 warp + g + 8 (e >> 1), m = 8 j + 2 t +
      // (e & 1).  The other consumer has read the last unit's Y: it gave
      // back that unit's last phase-2 stage before this unit's phase 1
      // (more items than stages) could fill.
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float* yr = yp + (16 * warp + g + 8 * rr) * PY + 2 * t;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<float2*>(yr + 8 * j) =
              make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
        }
      }
      consumers_sync();
      // ---- phase 2: out[i, l] = sum_m Y[i, m] W2[l, m] ----
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      Frags cur, nxt;
      frags(0, cur);
#pragma unroll 1
      for (int q = 0; q < KS2; ++q, ++item) {
        const int slot = int(item % STAGES);
        mbar_wait(&full[slot], uint32_t((item / STAGES) & 1));
        const uint32_t base = st0 + slot * STAGE;
        fence_acc(d);
        wgmma_fence();
        wgmma_tf32_ra(d, cur.rh, W2(base, w_first), 0);
        wgmma_tf32_ra(d, cur.ih, W2(base, w_second), 1);
        wgmma_commit();
        add();
        fence_acc(d);
        wgmma_fence();
        wgmma_tf32_ra(d, cur.rh, W2(base, 2 + w_first), 0);
        wgmma_tf32_ra(d, cur.ih, W2(base, 2 + w_second), 1);
        wgmma_tf32_ra(d, cur.rl, W2(base, 4 + w_first), 1);
        wgmma_tf32_ra(d, cur.il, W2(base, 4 + w_second), 1);
        wgmma_commit();
        // the next k-step's fragments while these products run
        if (q + 1 < KS2) frags(q + 1, nxt);
        add();
        fence_frag(cur.rh);
        fence_frag(cur.ih);
        fence_frag(cur.rl);
        fence_frag(cur.il);
        mbar_arrive(&empty[slot]);
        cur = nxt;
      }
      // acc[4 j + e]: row i = 16 warp + g + 8 (e >> 1) of the unit, output
      // l = 8 j + 2 t + (e & 1)
      const int64_t obase =
          ((u / H) << LOG_SLAB) + (int64_t(int(u % H) * NI) << LOG_D2);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float* oc = o + obase + int64_t(16 * warp + g + 8 * rr) * D2;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<float2*>(oc + 8 * j + 2 * t) =
              make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
        }
      }
    }
  }
}

}  // namespace pwg

// the launch of pwg::pair_wg_kernel<D1> and its split of W1 and W2
template <int D1>
int launch_pair_wg(const PairArgs& a) {
  static int blocks_cap[MAX_DEVICES] = {};  // resident blocks, per device
  cudaError_t err;
  const int cap = resident_blocks(pwg::pair_wg_kernel<D1>, pwg::SMEM,
                                  blocks_cap, err, pwg::THREADS);
  if (cap == 0) return static_cast<int>(err);
  if (a.scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int H = D1 / pwg::NI;
  float4* parts = reinterpret_cast<float4*>(a.scratch);
  pwg::pair_wg_split_kernel<D1>
      <<<pwg::KS2 + H * (D1 / 8), pwg::D2, 0, a.stream>>>(a.w1, a.w2, parts);
  const int64_t units = (a.n_amps >> (ilog2(D1) + pwg::LOG_D2)) * H;
  // both units of a slab in the same round
  const unsigned grid = particle_grid(units, cap, a.particles, H);
  const Diag diag{a.flips, a.nflips, a.masks, a.wants,
                  a.phase, a.nphases, a.n_amps - 1};
  pwg::pair_wg_kernel<D1>
      <<<dim3(grid, a.particles), pwg::THREADS, pwg::SMEM, a.stream>>>(
          a.psi, a.out, parts, a.n_amps, diag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
