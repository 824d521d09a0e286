// The tensor-core pair of the reduced dot modes (bf16_3x, bf16) at D1, D2 =
// 8 .. 128, in both orientations (the trailing pair, B == 1, and MIDDLE: B
// >= 128, D1 <= 32).  It stands to pair_tc.cuh (the f32 / f32_mix tile) as
// window_bf16.cuh stands to window_tc.cuh: pair_tc.cu instantiates it for
// those two modes.
//
//   out[a, i, l, b] = sum_m W2[l, m] sum_j W1[i, j] (Phi F p)[a, j, m, b]
//
// Replaces, in the reference's --precision bf16_3x and bf16, the TPU
// kernels _pair_b1 (qbot_tpu/tpu/kernels.py:304-348) and _pair_bt
// (:379-416), whose _dot (:55-71) splits both operands as hi = bf16(x) to
// nearest even, lo = bf16(x - hi) and sums hi·hi + hi·lo + lo·hi (bf16_3x)
// or hi·hi (bf16): W1 first, Y = W1 (Phi F X) in FP32, then out = Y W2^T
// with Y split anew.
//
// What bounds it on an H100: at 26 qubits the (128, 128) trailing pair does
// 8 (D1 + D2) FLOPs an amplitude, 3 BF16 products each in bf16_3x: 0.42 ms
// on the 989 TFLOP/s BF16 tensor cores, against 0.32 ms of bytes (1.07 GB);
// bf16 and the (32, 128) middle pair are bound by the bytes.  mma.sync
// m16n8k16 runs at about 640 TFLOP/s (tools/mma_rate.cu), so the products
// alone take 0.64 ms in bf16_3x at (128, 128).  The design keeps every
// instruction that is not a product or a byte moved out of the loop:
//
// - Y never leaves the registers.  A warp owns 16 rows i of one slab: in
//   phase 1 W1 (16 rows) is the A operand of mma.sync.m16n8k16 and the
//   slab's columns m the B operand, so the warp's FP32 accumulators hold
//   Y[i, m] for all D2 m; their C fragments (rows g, g + 8, columns 2t,
//   2t + 1 of each n-tile) are the A fragments of phase 2 (rows g, g + 8,
//   k slots 2t, 2t + 1 and 2t + 8, 2t + 9 from n-tiles 2kk and 2kk + 1),
//   where W2^T is the B operand.  So Y is split into bf16 hi (and lo) once,
//   in registers, when phase 1 ends, and no warp loads or re-splits it.
// - W1 and W2 are split once per block into bf16 hi (and lo) in fragment
//   order and kept in shared memory: one LDS.128 a fragment, no conversion
//   in the loop.  They fit because Y needs no shared memory: in bf16_3x at
//   (128, 128) W2 (128 KiB), the IN = 64 rows of W1 a block owns (64 KiB)
//   and two rings of 16 KiB; in bf16 all of W1.  (A pre-split copy of W2
//   in global memory, streamed through the ring, would have cost an
//   argument of the entry point and W2's bytes from L2 on every unit.)
// - X is phased and split once a walker, by the thread that copied it: a
//   stage is one k16-step (16 j) of the unit's slabs at MCS columns m,
//   copied with 4-byte cp.async straight into B-fragment order (lane (g, t)
//   of a fragment holds column g at j = 2t, 2t + 1, 2t + 8, 2t + 9, both
//   planes), so each thread converts in place only the elements it copied
//   itself: after its own cp.async.wait_group it applies the flips and
//   phases (table lookups: the entries a column's j, m and other bits
//   match), splits, and writes hi and lo over them, after issuing the
//   products of the stage before; one barrier a stage.  Every warp of the
//   walker then loads the converted fragments.
// - The rounding structure of window_bf16.cuh: each k16-step's hi·hi sums
//   (one mma for each of the two terms of a plane) start from a zero
//   accumulator apart and go to the FP32 accumulators by round-to-nearest
//   FADDs; bf16_3x's four cross-term products of a plane are summed per
//   k16-step on the tensor cores, then added likewise
//   (tests/test_torch_pair_split.py replays it).  A pair so rounds as its
//   two windows do.
// - One block an SM.  A walker (the m-tiles of its IN rows of a slab, or
//   of several slabs where D1 < 64) has its own ring and named barrier.
//   Y's D2 accumulators a lane hold the registers to 200-255 a thread at
//   D2 = 128, so an SM runs 8 warps: two walkers of 4, or one of 8 where
//   the card read that faster (PERF.md §6, PR 9): bf16 at D1 = 128, whose
//   W1 fits whole, so each slab is read and split once, not once for each
//   half of its rows; and the middle pair, whose units then hold 4 or 8 b.
// - The middle pair's unit is SG consecutive b of one a (SG slabs), its
//   copies runs of SG floats along b (16 bytes at D1 = 32, 32 below); its
//   outputs go through a small staging buffer (one n-tile of l at a time,
//   double-buffered) so that they too leave in runs of SG floats along b.
//   The trailing pair's outputs leave as 8-byte stores of l, l + 1 (whole
//   32-byte sectors).
// - D1 = 8 (D2 = 8) fills half of the k16-step: W1's (W2's) k slots 8-15
//   are zero; at D1 = 8 also rows 8-15 of the m-tile.
#pragma once

#include "pair_tc.cuh"

namespace {

// a 4-byte cp.async (zero-filled where !valid)
__device__ __forceinline__ void cp_async4(uint32_t* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ uint4 neg_bf16(uint4 v) {
  return make_uint4(v.x ^ 0x80008000u, v.y ^ 0x80008000u, v.z ^ 0x80008000u,
                    v.w ^ 0x80008000u);
}

template <int D1, int D2, bool MIDDLE, int PREC>
struct PairBf16Tile {
  static_assert(PREC == BF16X3 || PREC == BF16, "a reduced dot mode");
  static constexpr int LOG_D1 = ilog2(D1), LOG_D2 = ilog2(D2);
  static constexpr int PARTS = PREC == BF16X3 ? 2 : 1;  // hi (, lo)
  // one walker of 8 warps a block where that reads the state once (bf16 at
  // D1 = 128: all of W1 fits beside W2) or in runs of 4 or 8 b (the middle
  // pair), else two walkers of 4 warps (PERF.md §6, PR 9)
  static constexpr bool WIDE = MIDDLE || (PREC == BF16 && D1 == 128);
  static constexpr int WW = WIDE ? 8 : 4;        // warps a walker
  static constexpr int WT = 32 * WW;             // threads a walker
  static constexpr int NW = WIDE ? 1 : 2;        // walkers a block
  static constexpr int NT = NW * WT;
  // the rows i of W1 a block owns (always the same part h of the D1 / IN),
  // in MT m-tiles of 16 (one, half empty, at D1 = 8)
  static constexpr int IN_MAX = PREC == BF16 ? 128 : 64;
  static constexpr int IN = D1 < IN_MAX ? D1 : IN_MAX;
  static constexpr int H = D1 / IN;
  static constexpr int MT = IN < 16 ? 1 : IN / 16;
  // slabs a unit, one a warp per m-tile: warp w takes slab w / MT, m-tile
  // w % MT
  static constexpr int SG = WW / MT;
  static constexpr int LOG_SG = ilog2(SG);
  static constexpr int KS1 = D1 < 16 ? 1 : D1 / 16;  // k16-steps of j
  static constexpr int KS2 = D2 < 16 ? 1 : D2 / 16;  // k16-steps of m
  static constexpr int NT2 = D2 / 8;             // n-tiles of m, then of l
  // a stage: one k16-step of the unit's SG slabs at MCS columns m, NF
  // fragment columns of 8 (slab-major), one fragment lane a thread
  static constexpr int MCS = 8 * WW / SG < D2 ? 8 * WW / SG : D2;
  static constexpr int NTI = MCS / 8;            // n-tiles of a slab a stage
  static constexpr int NMC = D2 / MCS;           // stages of a k16-step
  static constexpr int NF = SG * NTI;
  static constexpr int SLOTS = 32 * NF;
  static constexpr int ITEMS = KS1 * NMC;        // stages a unit
  // 32-bit words: a stage [fragment column][plane r, i (FP32) / hi, lo
  // (bf16)][lane][4]; W1's fragments [m-tile][k16-step][part][plane][lane]
  // [4]; W2's [n-tile of l][k16-step][part][lane][4] ({re b0, re b1, im
  // b0, im b1}); the middle pair's staging, two [plane][i][l of 8][slab]
  static constexpr int STAGE = NF * 256;
  static constexpr int W1_WORDS = MT * KS1 * PARTS * 256;
  static constexpr int W2_WORDS = NT2 * KS2 * PARTS * 128;
  static constexpr int STG = MIDDLE ? 2 * IN * 8 * SG : 0;
  static constexpr int smem(int ring) {
    return 4 * (W1_WORDS + W2_WORDS + NW * (ring * STAGE + 2 * STG) + D1 +
                D2) +
           8 * (1 << TABLE) + 16 * TABLE;
  }
  // cp.async ring depth: the deepest of 8, 6, 4 and 3 stages that fits.  A
  // stage holds 24-48 mma a warp, so 2 stages of look-ahead do not cover a
  // load's latency
  static constexpr int RING = smem(8) <= MAX_SMEM   ? 8
                              : smem(6) <= MAX_SMEM ? 6
                              : smem(4) <= MAX_SMEM ? 4
                                                    : 3;
  static constexpr int SMEM = smem(RING);
  static_assert(SMEM <= MAX_SMEM, "pair tile shared memory");
  static_assert(NF <= WW && SG * MT == WW, "pair tile warps");
  static_assert(!MIDDLE || D1 <= 32, "middle pair: D1 <= 32");
};

template <int D1, int D2, bool MIDDLE, int PREC>
__global__ void __launch_bounds__((PairBf16Tile<D1, D2, MIDDLE, PREC>::NT), 1)
    pair_bf16_kernel(const float* __restrict__ psi, float* __restrict__ out,
                     const float* __restrict__ w1,
                     const float* __restrict__ w2, int64_t n_amps, int log_b,
                     const Diag diag) {
  using T = PairBf16Tile<D1, D2, MIDDLE, PREC>;
  extern __shared__ __align__(16) float smem[];
  uint32_t* w1s = reinterpret_cast<uint32_t*>(smem);
  uint32_t* w2s = w1s + T::W1_WORDS;
  uint32_t* jtab = w2s + T::W2_WORDS + T::NW * (T::RING * T::STAGE +
                                                 2 * T::STG);
  float2* comb = reinterpret_cast<float2*>(jtab + D1);
  long long* cmask = reinterpret_cast<long long*>(comb + (1 << TABLE));
  long long* cwant = cmask + TABLE;
  uint32_t* mtab = reinterpret_cast<uint32_t*>(cwant + TABLE);
  const int pl0 = particle_plane();

  // the thread's walker, and its index, warp and lane in it
  const int wid = threadIdx.x / T::WT, tid = threadIdx.x % T::WT;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* ring = w2s + T::W2_WORDS + wid * (T::RING * T::STAGE + 2 * T::STG);
  float* stg = reinterpret_cast<float*>(ring + T::RING * T::STAGE);
  const int h = blockIdx.x % T::H;  // the block's part of i
  const int64_t walker = int64_t(blockIdx.x / T::H) * T::NW + wid;
  const int64_t walkers = int64_t(gridDim.x / T::H) * T::NW;
  const int64_t slabs = n_amps >> (T::LOG_D1 + T::LOG_D2);
  // the middle pair's units are whole (SG <= 8 <= B)
  const int64_t units =
      MIDDLE ? slabs >> T::LOG_SG : (slabs + T::SG - 1) >> T::LOG_SG;
  // the window bits j sit at jshift of the flat index
  const int jshift = T::LOG_D2 + (MIDDLE ? log_b : 0);
  const int ndiag = diag.nphases + diag.nflips;
  const int ntab = ndiag < TABLE ? ndiag : TABLE;
  // W1's rows h IN + 16 mt + g (+ 8) at j = 16 ks + 2t (+ 1) (words 0, 1)
  // and + 8 (words 2, 3), split once; zero outside D1 and IN
  for (int e = threadIdx.x; e < T::MT * T::KS1 * 2 * 128; e += T::NT) {
    const int r = e & 3, ln = (e >> 2) & 31, pl = (e >> 7) & 1;
    const int ks = (e >> 8) % T::KS1, mt = (e >> 8) / T::KS1;
    const int row = 16 * mt + (ln >> 2) + 8 * (r & 1);
    const int j = 16 * ks + 2 * (ln & 3) + 8 * (r >> 1);
    float v0 = 0.f, v1 = 0.f;
    if (row < T::IN && j < D1) {
      const float* src = w1 + (pl * D1 + h * T::IN + row) * D1 + j;
      v0 = src[0], v1 = src[1];
    }
    uint32_t hi, lo;
    split_bf16(v0, v1, hi, lo);
    const int base = (((mt * T::KS1 + ks) * T::PARTS) * 2 + pl) * 128 +
                     ln * 4 + r;
    w1s[base] = hi;
    if constexpr (T::PARTS == 2) w1s[base + 256] = lo;
  }
  // W2's rows l = 8 lt + g at m = 16 kk + 2t (+ 1) (words 0: re, 2: im) and
  // + 8 (words 1, 3), split once; zero outside D2
  for (int e = threadIdx.x; e < T::NT2 * T::KS2 * 128; e += T::NT) {
    const int r = e & 3, ln = (e >> 2) & 31;
    const int kk = (e >> 7) % T::KS2, lt = (e >> 7) / T::KS2;
    const int l = 8 * lt + (ln >> 2), pl = r >> 1;
    const int m = 16 * kk + 2 * (ln & 3) + 8 * (r & 1);
    float v0 = 0.f, v1 = 0.f;
    if (m < D2) {
      const float* src = w2 + (pl * D2 + l) * D2 + m;
      v0 = src[0], v1 = src[1];
    }
    uint32_t hi, lo;
    split_bf16(v0, v1, hi, lo);
    const int base = ((lt * T::KS2 + kk) * T::PARTS) * 128 + ln * 4 + r;
    w2s[base] = hi;
    if constexpr (T::PARTS == 2) w2s[base + 128] = lo;
  }
  diag_tables<D1, false>(diag, jshift, jtab, comb, cmask, cwant);
  // the table entries a column's m bits match (mtab, as jtab for j); the
  // entries' other bits (cmask, cwant without the m bits) are matched once
  // a unit and slab
  const int mshift = MIDDLE ? log_b : 0;
  const int64_t mbits = int64_t(D2 - 1) << mshift;
  for (int m = threadIdx.x; m < D2; m += T::NT) {
    uint32_t bits = 0;
    for (int e = 0; e < ntab; ++e) {
      int64_t mask, want;
      float zr, zi;
      diag.entry(e, mask, want, zr, zi);
      if (((int64_t(m) << mshift) & mask & mbits) == (want & mbits))
        bits |= 1u << e;
    }
    mtab[m] = bits;
  }
  __syncthreads();
  if (threadIdx.x < ntab) {
    cmask[threadIdx.x] &= ~mbits;
    cwant[threadIdx.x] &= ~mbits;
  }
  __syncthreads();
  // the walker's barrier: the ring and the staging are the walker's alone
  auto walker_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wid), "n"(T::WT));
  };

  auto unit_of = [&](int64_t s) {
    return walker + (s / T::ITEMS) * walkers;
  };
  // middle: the flat index of unit u's (j, m, slab) = (0, 0, 0) element, a
  // D1 D2 B + b0
  auto unit_base = [&](int64_t u) {
    return ((u >> (log_b - T::LOG_SG)) << (T::LOG_D1 + T::LOG_D2 + log_b)) |
           ((u << T::LOG_SG) & ((int64_t(1) << log_b) - 1));
  };
  // the flat index of the j = 0 element of column m of the unit's slab sl
  auto col_base = [&](int64_t u, int sl, int m) -> int64_t {
    if constexpr (MIDDLE) {
      return unit_base(u) + (int64_t(m) << log_b) + sl;
    } else {
      return ((u * T::SG + sl) << (T::LOG_D1 + T::LOG_D2)) + m;
    }
  };
  // the fragment slot (column fc, lane ln) a thread copies and converts,
  // the thread tid < SLOTS: lanes along m (trailing: a copy is 8 columns of
  // 32 bytes, at 4 j), or slabs fastest (middle: runs of SG b)
  const bool copier = tid < T::SLOTS;
  const int q = MIDDLE ? tid >> T::LOG_SG : tid;
  const int fc = MIDDLE ? (tid & (T::SG - 1)) * T::NTI + (q >> 5) : tid >> 5;
  const int ln = q & 31;
  const int slot_sl = fc / T::NTI;                 // its slab
  const int slot_m = (fc % T::NTI) * 8 + (ln >> 2);  // its column in a stage
  // the j of element e of the slot's planes
  auto slot_j = [&](int e) { return 2 * (ln & 3) + (e & 1) + 8 * (e >> 1); };
  auto copy = [&](int64_t s, int stage) {
    const int64_t u = unit_of(s);
    const int r = int(s % T::ITEMS);
    const int ks = r / T::NMC, mc = r % T::NMC;
    const bool ok = MIDDLE || u * T::SG + slot_sl < slabs;
    const int64_t base = ok ? col_base(u, slot_sl, mc * T::MCS + slot_m) : 0;
    uint32_t* dst = ring + stage * T::STAGE + fc * 256 + ln * 4;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * ks + slot_j(e);
        const bool v = ok && j < D1;
        cp_async4(dst + pl * 128 + e,
                  psi + (pl0 + pl) * n_amps +
                      (v ? base + (int64_t(j) << jshift) : 0),
                  v);
      }
    }
  };
  // the slot's elements, phased and split in place: hi over plane r's
  // words, lo over plane i's
  int64_t hit_unit = -1;  // the unit of unit_hits
  uint32_t unit_hits = 0;   // the entries the slot's unit and slab match
  auto convert = [&](int64_t s, int stage) {
    const int64_t u = unit_of(s);
    const int r = int(s % T::ITEMS);
    const int ks = r / T::NMC, mc = r % T::NMC;
    uint4* slot =
        reinterpret_cast<uint4*>(ring + stage * T::STAGE + fc * 256) + ln;
    const float4 vr = *reinterpret_cast<const float4*>(slot);
    const float4 vi = *reinterpret_cast<const float4*>(slot + 32);
    float xr[4] = {vr.x, vr.y, vr.z, vr.w}, xi[4] = {vi.x, vi.y, vi.z, vi.w};
    if (ndiag) {
      const int m = mc * T::MCS + slot_m;
      if (u != hit_unit) {
        hit_unit = u;
        unit_hits = col_hits(col_base(u, slot_sl, 0), ntab, cmask, cwant);
      }
      const uint32_t hit = unit_hits & mtab[m];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * ks + slot_j(e);
        if (j >= D1) continue;
        apply_hit(xr[e], xi[e], hit & jtab[j], comb);
        apply_several_hits(xr[e], xi[e], hit & jtab[j], comb);
        if (ndiag > TABLE) {
          const int64_t mflat =
              col_base(u, slot_sl, m) | (int64_t(j) << jshift);
          for (int qd = TABLE; qd < ndiag; ++qd) {
            int64_t mask, want;
            float zr, zi;
            diag.entry(qd, mask, want, zr, zi);
            if ((mflat & mask) == want) cmul(xr[e], xi[e], zr, zi);
          }
        }
      }
    }
    uint4 hi, lo;
    split_bf16(xr[0], xr[1], hi.x, lo.x);
    split_bf16(xr[2], xr[3], hi.y, lo.y);
    split_bf16(xi[0], xi[1], hi.z, lo.z);
    split_bf16(xi[2], xi[3], hi.w, lo.w);
    slot[0] = hi;
    if constexpr (T::PARTS == 2) slot[32] = lo;
  };

  const int64_t my_units =
      units > walker ? (units - 1 - walker) / walkers + 1 : 0;
  const int64_t items = my_units * T::ITEMS;
#pragma unroll
  for (int s = 0; s < T::RING - 1; ++s) {
    if (copier && s < items) copy(s, s);
    cp_async_commit();
  }
  cp_async_wait<T::RING - 2>();
  if (copier && items > 0) convert(0, 0);

  const uint4* w1f = reinterpret_cast<const uint4*>(w1s);
  const uint4* w2f = reinterpret_cast<const uint4*>(w2s);
  const int sl_w = warp / T::MT, mt_w = warp % T::MT;  // the warp's rows
  // acc[nt][p]: plane p of Y at rows g (q = 0, 1) and g + 8 (q = 2, 3),
  // columns m = 8 nt + 2t (q even), + 1 (q odd)
  float acc[T::NT2][2][4];
  int64_t s = 0;  // the item
  int stage = 0;   // its stage
  for (int64_t uu = 0; uu < my_units; ++uu) {
    const int64_t u = walker + uu * walkers;
    // acc is dead from phase 2 of a unit to the start of the next: one unit
    // a trip, so the registers of Y's fragments are acc's
#pragma unroll
    for (int nt = 0; nt < T::NT2; ++nt) {
#pragma unroll
      for (int qq = 0; qq < 8; ++qq) acc[nt][qq >> 2][qq & 3] = 0.f;
    }
    for (int r = 0; r < T::ITEMS;
         ++r, ++s, stage = stage == T::RING - 1 ? 0 : stage + 1) {
      // item s is converted, and the walker done with item s - 1
      walker_sync();
      // item s + RING - 1 goes to the stage item s - 1 used
      if (copier && s + T::RING - 1 < items)
        copy(s + T::RING - 1, stage == 0 ? T::RING - 1 : stage - 1);
      cp_async_commit();
      const int ks = r / T::NMC, mc = r % T::NMC;
      // phase 1: Y += W1 X over this k16-step of j, at the stage's columns
      // of the warp's slab.  Y_r = W1r Xr + (-W1i) Xi, Y_i = W1i Xr + W1r Xi
      const uint4* st =
          reinterpret_cast<const uint4*>(ring + stage * T::STAGE);
      const int f1 = (mt_w * T::KS1 + ks) * T::PARTS * 2;
      const uint4 wrh = w1f[f1 * 32 + lane];
      const uint4 wih = w1f[(f1 + 1) * 32 + lane];
      const uint4 nwih = neg_bf16(wih);
      uint4 wrl{}, wil{}, nwil{};
      if constexpr (T::PARTS == 2) {
        wrl = w1f[(f1 + 2) * 32 + lane];
        wil = w1f[(f1 + 3) * 32 + lane];
        nwil = neg_bf16(wil);
      }
#pragma unroll
      for (int mcc = 0; mcc < T::NMC; ++mcc) {
        if (mcc != mc) continue;
#pragma unroll
        for (int ntl = 0; ntl < T::NTI; ++ntl) {
          const int fc = sl_w * T::NTI + ntl;
          float(&y)[2][4] = acc[mcc * T::NTI + ntl];
          const uint4 xh = st[fc * 64 + lane];
          const uint32_t xrh[2] = {xh.x, xh.y}, xih[2] = {xh.z, xh.w};
          // each plane's two hi hi sums from zero, apart: [plane][term]
          float e[2][2][4];
          mma16_0(e[0][0], wrh, xrh);
          mma16_0(e[1][0], wih, xrh);
          mma16_0(e[0][1], nwih, xih);
          mma16_0(e[1][1], wrh, xih);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
#pragma unroll
            for (int qq = 0; qq < 4; ++qq)
              y[p][qq] = y[p][qq] + e[p][0][qq] + e[p][1][qq];
          }
          if constexpr (T::PARTS == 2) {
            const uint4 xl = st[fc * 64 + 32 + lane];
            const uint32_t xrl[2] = {xl.x, xl.y}, xil[2] = {xl.z, xl.w};
            float c[2][4];
            mma16_0(c[0], wrl, xrh);
            mma16_0(c[1], wil, xrh);
            mma16(c[0], wrh, xrl);
            mma16(c[1], wih, xrl);
            mma16(c[0], nwil, xih);
            mma16(c[1], wrl, xih);
            mma16(c[0], nwih, xil);
            mma16(c[1], wrh, xil);
#pragma unroll
            for (int p = 0; p < 2; ++p) {
#pragma unroll
              for (int qq = 0; qq < 4; ++qq) y[p][qq] += c[p][qq];
            }
          }
        }
      }
      // item s + 1 has landed (this thread's copies): convert it once the
      // products of item s are issued (past the last item, a stale stage no
      // one reads again)
      cp_async_wait<T::RING - 2>();
      if (copier) convert(s + 1, stage == T::RING - 1 ? 0 : stage + 1);
    }
    // phase 2: out = Y W2^T, Y split once into the A fragments: k slots 2t,
    // 2t + 1 of n-tile 2kk (x: row g, y: row g + 8), 2t + 8, 2t + 9 of
    // n-tile 2kk + 1 (z, w); zero past D2 = 8
    uint4 yh[T::KS2][2], yl[T::KS2][2];
#pragma unroll
    for (int kk = 0; kk < T::KS2; ++kk) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        split_bf16(acc[2 * kk][p][0], acc[2 * kk][p][1], yh[kk][p].x,
                   yl[kk][p].x);
        split_bf16(acc[2 * kk][p][2], acc[2 * kk][p][3], yh[kk][p].y,
                   yl[kk][p].y);
        if constexpr (T::NT2 > 1) {
          split_bf16(acc[2 * kk + 1][p][0], acc[2 * kk + 1][p][1],
                     yh[kk][p].z, yl[kk][p].z);
          split_bf16(acc[2 * kk + 1][p][2], acc[2 * kk + 1][p][3],
                     yh[kk][p].w, yl[kk][p].w);
        } else {
          yh[kk][p].z = yh[kk][p].w = yl[kk][p].z = yl[kk][p].w = 0u;
        }
      }
    }
    // the warp's slab, and the flat index of its output (i, l) = (16 mt_w +
    // g, 0) in the trailing pair
    const int64_t slab = u * T::SG + sl_w;
    const int64_t obase =
        (slab << (T::LOG_D1 + T::LOG_D2)) +
        (int64_t(h * T::IN + 16 * mt_w + g) << T::LOG_D2) + 2 * t;
#pragma unroll 1
    for (int lt = 0; lt < T::NT2; ++lt) {
      // out_r = Yr W2r^T + Yi (-W2i)^T, out_i = Yr W2i^T + Yi W2r^T
      float o[2][4];
#pragma unroll
      for (int qq = 0; qq < 8; ++qq) o[qq >> 2][qq & 3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < T::KS2; ++kk) {
        const int f2 = (lt * T::KS2 + kk) * T::PARTS;
        const uint4 bh = w2f[f2 * 32 + lane];
        const uint32_t brh[2] = {bh.x, bh.y}, bih[2] = {bh.z, bh.w};
        const uint32_t nbih[2] = {bh.z ^ 0x80008000u, bh.w ^ 0x80008000u};
        // each plane's two hi hi sums from zero, apart: [plane][term]
        float e[2][2][4];
        mma16_0(e[0][0], yh[kk][0], brh);
        mma16_0(e[1][0], yh[kk][0], bih);
        mma16_0(e[0][1], yh[kk][1], nbih);
        mma16_0(e[1][1], yh[kk][1], brh);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            o[p][qq] = o[p][qq] + e[p][0][qq] + e[p][1][qq];
        }
        if constexpr (T::PARTS == 2) {
          const uint4 bl = w2f[(f2 + 1) * 32 + lane];
          const uint32_t brl[2] = {bl.x, bl.y}, bil[2] = {bl.z, bl.w};
          const uint32_t nbil[2] = {bl.z ^ 0x80008000u, bl.w ^ 0x80008000u};
          float c[2][4];
          mma16_0(c[0], yh[kk][0], brl);
          mma16_0(c[1], yh[kk][0], bil);
          mma16(c[0], yl[kk][0], brh);
          mma16(c[1], yl[kk][0], bih);
          mma16(c[0], yh[kk][1], nbil);
          mma16(c[1], yh[kk][1], brl);
          mma16(c[0], yl[kk][1], nbih);
          mma16(c[1], yl[kk][1], brh);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) o[p][qq] += c[p][qq];
          }
        }
      }
      // o[p]: rows i = 16 mt_w + g (q = 0, 1), + 8 (q = 2, 3); l = 8 lt +
      // 2t (q even), + 1 (q odd)
      if constexpr (MIDDLE) {
        // through the staging buffer [plane][i][l of 8][slab], then runs of
        // SG b
        float* sb = stg + (lt & 1) * T::STG;
#pragma unroll
        for (int hh = 0; hh < (T::IN < 16 ? 1 : 2); ++hh) {
          const int il = 16 * mt_w + g + 8 * hh;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2)
              sb[((p * T::IN + il) * 8 + 2 * t + c2) * T::SG + sl_w] =
                  o[p][2 * hh + c2];
          }
        }
        walker_sync();
        const int64_t ub = unit_base(u);
        for (int e = tid; e < 2 * T::IN * 8; e += T::WT) {
          const int lc = e & 7, il = (e >> 3) % T::IN, p = e / (8 * T::IN);
          float* dst = out + (pl0 + p) * n_amps + ub +
                       ((int64_t((il << T::LOG_D2) + 8 * lt + lc)) << log_b);
          const float* src = sb + e * T::SG;
          if constexpr (T::SG >= 4) {
#pragma unroll
            for (int v = 0; v < T::SG; v += 4)
              *reinterpret_cast<float4*>(dst + v) =
                  *reinterpret_cast<const float4*>(src + v);
          } else if constexpr (T::SG == 2) {
            *reinterpret_cast<float2*>(dst) =
                *reinterpret_cast<const float2*>(src);
          } else {
            *dst = *src;
          }
        }
      } else {
        if (slab >= slabs) continue;
#pragma unroll
        for (int hh = 0; hh < (T::IN < 16 ? 1 : 2); ++hh) {
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            *reinterpret_cast<float2*>(out + (pl0 + p) * n_amps + obase +
                                       (int64_t(8 * hh) << T::LOG_D2) +
                                       8 * lt) =
                make_float2(o[p][2 * hh], o[p][2 * hh + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int D1, int D2, bool MIDDLE, int PREC>
int launch_bf16_pair(const PairArgs& a) {
  using T = PairBf16Tile<D1, D2, MIDDLE, PREC>;
  // the middle pair's units are SG consecutive b of one a
  if (MIDDLE && a.log_b < T::LOG_SG)
    return static_cast<int>(cudaErrorInvalidValue);
  static int blocks_cap[MAX_DEVICES] = {};  // resident blocks, per device
  cudaError_t err;
  const int cap =
      resident_blocks(pair_bf16_kernel<D1, D2, MIDDLE, PREC>, T::SMEM,
                      blocks_cap, err, T::NT);
  if (cap == 0) return static_cast<int>(err);
  const int64_t slabs = a.n_amps >> (T::LOG_D1 + T::LOG_D2);
  const int64_t units = (slabs + T::SG - 1) / T::SG;
  const int64_t work = (units + T::NW - 1) / T::NW * T::H;
  // every part of a unit in the same round: whole units of H blocks
  const unsigned grid = particle_grid(work, cap, a.particles, T::H);
  const Diag diag{a.flips, a.nflips, a.masks, a.wants,
                  a.phase, a.nphases, a.n_amps - 1};
  pair_bf16_kernel<D1, D2, MIDDLE, PREC>
      <<<dim3(grid, a.particles), T::NT, T::SMEM, a.stream>>>(
          a.psi, a.out, a.w1, a.w2, a.n_amps, a.log_b, diag);
  return static_cast<int>(cudaGetLastError());
}

// the body of pair_tc_launch<D1, MIDDLE, PREC> for the reduced modes, in
// pair_tc.cu
template <int D1, bool MIDDLE, int PREC>
int launch_bf16_pair_d2(const PairArgs& a) {
  switch (a.log_d2) {
    case 3: return launch_bf16_pair<D1, 8, MIDDLE, PREC>(a);
    case 4: return launch_bf16_pair<D1, 16, MIDDLE, PREC>(a);
    case 5: return launch_bf16_pair<D1, 32, MIDDLE, PREC>(a);
    case 6: return launch_bf16_pair<D1, 64, MIDDLE, PREC>(a);
    case 7: return launch_bf16_pair<D1, 128, MIDDLE, PREC>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
