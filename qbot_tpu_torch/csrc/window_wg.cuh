// The f32 window at D = 128 on Hopper's warpgroup products: every f32 and
// f32_mix window launch of D = 128 (window_tc.cuh: launch_tc_d; the narrow
// pairs, D1 = 2, 4, keep the tile of window_tc.cuh), in both orientations
// (B > 1, and B = 1), with the particle axis and the fused flips and
// phases.  It replaces at this width the TPU kernels _left_multiply and
// _right_multiply (qbot_tpu/tpu/kernels.py:209, 271):
//
//   out[a, i, b] = sum_j W[i, j] (Phi F p)[a, j, b].
//
// What bounds it on an H100: the 3xTF32 products, 3 * 8 * 128 FLOPs an
// amplitude at 495 TFLOP/s, 0.4165 ms at 26 qubits; its bytes (each read
// and written once) take 0.3205 ms.  wgmma m64n128k8 TF32 from shared
// memory runs at 489 TFLOP/s on the card, mma.sync m16n8k8 TF32 at 315-323
// (tools/mma_rate.cu), so the mma.sync tile of window_tc.cuh could not
// pass 0.65 of the bound; it reached 0.25-0.28 (1.50-1.64 ms): every warp
// split its B fragments of W again for every 64-column tile, and that
// split, the x split and the round-to-nearest adds cost several ALU
// instructions per mma.sync, with two warps a scheduler to hide them.
//
// The arithmetic is the F32 tile's (tc_tile.cuh): x = x_hi + x_lo on the
// grid of its column and k-step of 8 j (both planes), W = W_hi + W_lo on
// the grid of its row and k-step; each k-step's x_hi W_hi sums (both
// planes' terms) come from a zeroed accumulator, so they are exact, and go
// to the FP32 accumulators by a round-to-nearest add; the cross terms
// x_hi W_lo + x_lo tf32(W) of the same k-step are summed on the tensor
// cores from a zeroed accumulator, then added likewise: for each column,
// exact sum then cross sum of k-step 0, then of k-step 1, ...  Nothing at
// the state's magnitude goes through the tensor cores' truncating sums.
// tests/test_torch_window_split.py replays it in numpy (wg_product).
//
// Design.  W is split once per launch: window_wg_split_kernel writes its
// six parts (re and im of W_hi, W_lo, tf32(W)) for each k-step into a
// 384 KiB scratch of the wrapper's, in the layout the products read, and a
// k-step's parts (24 KiB) reach each block by one bulk copy from L2.  A
// block of three warpgroups owns an SM (197 KiB of shared memory) and walks
// tiles of 128 state columns, two halves of 64 (the A operand's 64 rows),
// by all 128 outputs, a persistent grid over tiles and particles; each
// k-step's W parts serve both halves, so W's traffic from L2 is a sixth of
// the products' operand bytes:
//
// - Two consumer warpgroups, one an output plane (re, im), each keep the
//   two halves' FP32 sums and one 64-register accumulator (setmaxnreg 224)
//   and do nothing but issue wgmma.mma_async m64n128k8 TF32, both operands
//   from shared memory, and the round-to-nearest adds: per k-step and half
//   2 products for the exact sum, then 4 for the cross terms (-x_im is a
//   part of its own, so each product's operands are chosen by the plane's
//   descriptors alone).  A warpgroup waits for its products before it
//   reads their sum (ptxas serializes the products of a warpgroup that
//   reads one accumulator while another is in flight), so the tensor cores
//   are kept busy by the other warpgroup's products while it adds.
// - One producer warpgroup (setmaxnreg 56) fills a ring of three stages,
//   one a k-step: its first thread the W parts by cp.async.bulk, every
//   thread 4 x elements of each half (a column row, half a k-step, both
//   planes), which it copies in itself by cp.async five k-steps ahead into
//   a ring of its own (so no thread waits for another's copies), phases
//   (one table lookup and complex product an element, tc_tile.cuh:
//   diag_tables; the entries past the tables on the flat index), splits on
//   the column row's grid (a lane pair's shuffle) and writes as x's six
//   parts (re and im, hi and lo, and -im's; 64 x 8 each, K-major core
//   matrices, no swizzle).
// - A stage is handed over by two mbarriers: `full` (the producer's 128
//   threads arrive after a proxy fence, so the products read what they
//   wrote, and the bulk copy completes its bytes) and `empty` (the 256
//   consumer threads arrive once the products that read it have
//   completed).
//
// Measured at 26 qubits on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
// section 6): 0.79-0.82 ms without diagonals, 0.85-0.88 ms with 6 flips
// and phases, in either orientation and at B = 8: 0.47-0.53 of the bound.
// What holds it there: W's parts stream from L2 (3.2 GB a launch; with the
// products taken out the stream alone took 0.47-0.54 ms at about 7 TB/s,
// before the halves shared it) and shared memory, which carries the
// products' operands (72 KiB a k-step and half) beside the stage's
// writes.  ptxas: 168 registers at launch (setmaxnreg 224 / 56), no
// spills; the split kernel 38.  Its splits of W (split_w_row) and of x
// (write_x_parts) also serve the trailing pair of pair_wg.cuh.
#pragma once

#include "tc_tile.cuh"
#include "wgmma.cuh"

namespace {
namespace wg {

constexpr int D = 128;
constexpr int LOG_D = 7;
constexpr int KS = D / 8;           // k-steps of a tile
constexpr int BM = 64;              // state columns of a half tile
constexpr int HALVES = 2;           // halves of a tile
constexpr int TILE = HALVES * BM;   // state columns of a tile
constexpr int THREADS = 3 * 128;    // consumers (re, im), then the producer
constexpr int PRODUCER = 2 * 128;   // the producer's first thread
constexpr int CONSUMER_REGS = 224;
constexpr int PRODUCER_REGS = 56;
constexpr int STAGES = 3;           // stages of split operands
constexpr int RAW = 6;              // stages of raw x

// A stage: for each half, x's parts (re hi, im hi, re lo, im lo, -im hi,
// -im lo), each 64 rows x 8 k as [k half][8-row group][row][4 k]; the
// second k half starts A_LBO bytes in (a 64-byte pad puts a producer lane
// pair's two halves in distinct bank groups).  Then W's parts (re hi,
// im hi, re lo, im lo, re tf32, im tf32), each 128 rows x 8 k, [k half]
// [8-row group][row][4 k], as the scratch holds them for each k-step.
constexpr int A_LBO = 1024 + 64;
constexpr int A_PART = A_LBO + 1024;
constexpr int X_HALF = 6 * A_PART;  // bytes of a half's x parts
constexpr int B_LBO = 2048;
constexpr int B_PART = 2 * B_LBO;
constexpr int W_STEP = 6 * B_PART;  // bytes of a k-step's W parts
constexpr int GROUP = 128;          // bytes between 8-row groups
constexpr int STAGE = HALVES * X_HALF + W_STEP;
// a raw stage: each producer thread's 4 x elements of both planes, for
// each half, [half][plane][thread][4 k]
constexpr int RAW_HALF = 2 * 128 * 4;  // floats
constexpr int RAW_STAGE = HALVES * RAW_HALF;

constexpr int OFF_RAW = STAGES * STAGE;
constexpr int OFF_JTAB = OFF_RAW + RAW * RAW_STAGE * 4;
constexpr int OFF_COMB = OFF_JTAB + 4 * D;
constexpr int OFF_CMASK = OFF_COMB + 8 * (1 << TABLE);
constexpr int OFF_CWANT = OFF_CMASK + 8 * TABLE;
constexpr int OFF_BARS = OFF_CWANT + 8 * TABLE;
constexpr int SMEM = OFF_BARS + 2 * STAGES * 8;
static_assert(SMEM <= MAX_SMEM, "shared memory of a block");
static_assert(STAGE % 16 == 0 && OFF_RAW % 16 == 0, "16-byte alignment");

// the floats of the scratch that holds W's split parts (the wrapper's)
constexpr int SCRATCH_FLOATS = KS * W_STEP / 4;

// flat index of column c's j = 0 element: a * D * B + b
__device__ __forceinline__ int64_t col_base(int64_t c, int log_b) {
  return ((c >> log_b) << (log_b + LOG_D)) | (c & ((int64_t(1) << log_b) - 1));
}

__device__ __forceinline__ float4 bits4(const uint32_t (&v)[4]) {
  return make_float4(__uint_as_float(v[0]), __uint_as_float(v[1]),
                     __uint_as_float(v[2]), __uint_as_float(v[3]));
}

// 4 bytes from global to shared memory by cp.async (zeros if !valid)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// One thread a row i of a (2, D, D) W and k-step s: the grid of the row's
// 8 j, both planes; hi, lo on it; tf32(W); written at `step` as row r of
// the k-step's six parts of a block of N rows (each part N rows x 8 k,
// [k half][8-row group][row][4 k], its k halves N * 16 bytes apart).  The
// k-step's j 8 s + k in k order, or PAIRED: 8 s + 2 k, then 8 s + 2 k + 1
// (the order of an A fragment that holds a lane's two neighbouring j at k
// = t and t + 4).  NEG: three parts more, -im hi, -im lo, -im tf32.  W is
// read a float at a time: it needs no alignment.
template <int D, int N, bool PAIRED = false, bool NEG = false>
__device__ __forceinline__ void split_w_row(const float* __restrict__ w,
                                            unsigned char* step, int i,
                                            int r, int s) {
  float v[2][2][4];  // [plane][k half][k]
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[p][h][q] = w[(p * D + i) * D + 8 * s +
                       (PAIRED ? 2 * q + h : 4 * h + q)];
    }
  }
  float a = 0.f;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 4; ++q) a = fmaxf(a, fabsf(v[p][h][q]));
    }
  }
  const float m = grid_of(__float_as_uint(a) >> 23);
  constexpr int LBO = N * 16, PART = 2 * LBO;
  unsigned char* wp = step + r * 16;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t hi[4], lo[4], t[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        split(v[p][h][q], m, hi[q], lo[q]);
        t[q] = tf32(v[p][h][q]);
      }
      unsigned char* o = wp + h * LBO;
      *reinterpret_cast<float4*>(o + p * PART) = bits4(hi);
      *reinterpret_cast<float4*>(o + (2 + p) * PART) = bits4(lo);
      *reinterpret_cast<float4*>(o + (4 + p) * PART) = bits4(t);
      if (NEG && p == 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          hi[q] ^= 0x80000000u;
          lo[q] ^= 0x80000000u;
          t[q] ^= 0x80000000u;
        }
        *reinterpret_cast<float4*>(o + 6 * PART) = bits4(hi);
        *reinterpret_cast<float4*>(o + 7 * PART) = bits4(lo);
        *reinterpret_cast<float4*>(o + 8 * PART) = bits4(t);
      }
    }
  }
}

// One thread a row i of W and k-step s (the block's 128 threads a k-step):
// the k-step's six parts of the scratch.
template <int N = D>
__global__ void __launch_bounds__(N)
    window_wg_split_kernel(const float* __restrict__ w,
                           float4* __restrict__ parts) {
  split_w_row<D, N>(w, reinterpret_cast<unsigned char*>(parts) +
                           blockIdx.x * W_STEP,
                    threadIdx.x, threadIdx.x, blockIdx.x);
}

// A producer thread's 4 elements of an operand's row xc at k = 4 xh + q
// (both planes, phased): the grid of the row's 8 k (this lane's and its
// pair lane's, xh ^ 1), hi and lo on it, written as the six parts (re hi,
// im hi, re lo, im lo, -im hi, -im lo) of the operand at `half`, or as the
// first four (!NEG), each part PART bytes, its k halves LBO bytes apart
// (the 64-row A operand of a half's products by default).  Every lane of
// the warp calls it (a shuffle).
template <int LBO = A_LBO, int PART = A_PART, bool NEG = true>
__device__ __forceinline__ void write_x_parts(unsigned char* half, int xc,
                                              int xh, const float (&xr)[4],
                                              const float (&xi)[4]) {
  float a = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) a = fmaxf(a, fmaxf(fabsf(xr[q]), fabsf(xi[q])));
  uint32_t e = __float_as_uint(a) >> 23;
  e = max(e, __shfl_xor_sync(0xffffffffu, e, 1));
  const float m = grid_of(e);
  unsigned char* xp = half + xh * LBO + (xc >> 3) * GROUP + (xc & 7) * 16;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) split(xr[q], m, hi[q], lo[q]);
  *reinterpret_cast<float4*>(xp) = bits4(hi);
  *reinterpret_cast<float4*>(xp + 2 * PART) = bits4(lo);
#pragma unroll
  for (int q = 0; q < 4; ++q) split(xi[q], m, hi[q], lo[q]);
  *reinterpret_cast<float4*>(xp + PART) = bits4(hi);
  *reinterpret_cast<float4*>(xp + 3 * PART) = bits4(lo);
  if (!NEG) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    hi[q] ^= 0x80000000u;
    lo[q] ^= 0x80000000u;
  }
  *reinterpret_cast<float4*>(xp + 4 * PART) = bits4(hi);
  *reinterpret_cast<float4*>(xp + 5 * PART) = bits4(lo);
}

template <bool TRAIL>
__global__ void __launch_bounds__(THREADS, 1)
    window_wg_kernel(const float* __restrict__ psi, float* __restrict__ out,
                     const float4* __restrict__ wparts, int64_t n_amps,
                     int log_b, const Diag diag) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* stages = wg_smem;
  float* raws = reinterpret_cast<float*>(wg_smem + OFF_RAW);
  uint32_t* jtab = reinterpret_cast<uint32_t*>(wg_smem + OFF_JTAB);
  float2* comb = reinterpret_cast<float2*>(wg_smem + OFF_COMB);
  long long* cmask = reinterpret_cast<long long*>(wg_smem + OFF_CMASK);
  long long* cwant = reinterpret_cast<long long*>(wg_smem + OFF_CWANT);
  uint64_t* full = reinterpret_cast<uint64_t*>(wg_smem + OFF_BARS);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int pl0 = particle_plane();
  const int64_t cols = n_amps >> LOG_D;
  const int64_t tiles = (cols + TILE - 1) / TILE;
  const int64_t my_tiles =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t items = my_tiles * KS;  // an item: a tile's k-step
  // the first column of half h of item's tile
  auto col0 = [&](int64_t item, int h) {
    return (blockIdx.x + (item / KS) * gridDim.x) * int64_t(TILE) + h * BM;
  };

  diag_tables<D, true>(diag, log_b, jtab, comb, cmask, cwant);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's 128 threads, and its first thread's byte count
      mbar_init(&full[s], 128 + 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= PRODUCER) {
    // ---------------- producer ----------------
    regs_dec<PRODUCER_REGS>();
    const int pt = tid - PRODUCER, lane = pt & 31;
    // the x column row (of each half) and k half this thread splits
    const int xc = (pt >> 5) * 16 + (lane >> 1), xh = lane & 1;
    const int ndiag = diag.nphases + diag.nflips;
    const int ntab = ndiag < TABLE ? ndiag : TABLE;
    // this thread's x elements of half h of item, in raw stage item % RAW
    auto raw_of = [&](int64_t item, int h) {
      return raws + (item % RAW) * RAW_STAGE + h * RAW_HALF + 4 * pt;
    };
    auto issue = [&](int64_t item) {
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        float* raw = raw_of(item, h);
        const int64_t c = col0(item, h) + xc;
        const bool ok = c < cols;
        const int j = int(item % KS) * 8 + 4 * xh;
        const float* src =
            psi + pl0 * n_amps +
            (ok ? col_base(c, log_b) + (int64_t(j) << log_b) : 0);
        if (TRAIL) {
          cp_async(raw, src, 16, ok);
          cp_async(raw + 4 * 128, src + n_amps, 16, ok);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int64_t o = int64_t(q) << log_b;
            cp_async4(raw + q, src + o, ok);
            cp_async4(raw + 4 * 128 + q, src + n_amps + o, ok);
          }
        }
      }
    };
#pragma unroll
    for (int s = 0; s < RAW - 1; ++s) {
      if (s < items) issue(s);
      cp_async_commit();
    }
    int64_t xbase[HALVES] = {};
    uint32_t colhit[HALVES] = {};
    for (int64_t item = 0; item < items; ++item) {
      const int slot = int(item % STAGES), s = int(item % KS);
      if (item + RAW - 1 < items) issue(item + RAW - 1);
      cp_async_commit();
      if (s == 0) {
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          xbase[h] = col_base(col0(item, h) + xc, log_b);
          colhit[h] = col_hits(xbase[h], ntab, cmask, cwant);
        }
      }
      // this thread's copies of item have landed
      cp_async_wait<RAW - 1>();
      mbar_wait(&empty[slot], uint32_t((item / STAGES) & 1) ^ 1u);
      unsigned char* st = stages + slot * STAGE;
      if (pt == 0) {
        // the k-step's W parts, one bulk copy counted on full[slot]
        mbar_expect_bytes(&full[slot], W_STEP);
        bulk_copy(st + HALVES * X_HALF, wparts + s * (W_STEP / 16), W_STEP,
                  &full[slot]);
      }
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        // column row xc of the half, k = 4 xh + q
        const float* raw = raw_of(item, h);
        const float4 r4 = *reinterpret_cast<const float4*>(raw);
        const float4 i4 = *reinterpret_cast<const float4*>(raw + 4 * 128);
        float xr[4] = {r4.x, r4.y, r4.z, r4.w};
        float xi[4] = {i4.x, i4.y, i4.z, i4.w};
        if (ndiag) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 8 * s + 4 * xh + q;
            phase_element<true>(xr[q], xi[q], colhit[h] & jtab[j], comb,
                                diag, ndiag, [&] {
                                  return xbase[h] | (int64_t(j) << log_b);
                                });
          }
        }
        write_x_parts(st + h * X_HALF, xc, xh, xr, xi);
      }
      fence_async_smem();
      mbar_arrive(&full[slot]);
    }
    cp_async_wait<0>();
  } else {
    // ---------------- consumers: output plane tid / 128 ----------------
    regs_inc<CONSUMER_REGS>();
    const int plane = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // This plane's operands, as parts of a stage: plane 0 sums x_re W_re +
    // (-x_im) W_im, plane 1 x_re W_im + x_im W_re, so the second product of
    // each pair takes -x_im in plane 0 and W's planes swap in plane 1.
    const int x_im_hi = plane ? 1 : 4, x_im_lo = plane ? 3 : 5;
    const int w_first = plane, w_second = 1 - plane;
    const uint32_t st0 = smem_addr(stages);
    // the descriptors of x part x of half h, and of W part y, in the stage
    // at byte `base`
    auto A = [&](uint32_t base, int h, int x) {
      return kmajor_desc(base + h * X_HALF + x * A_PART, A_LBO, GROUP);
    };
    auto B = [&](uint32_t base, int y) {
      return kmajor_desc(base + HALVES * X_HALF + y * B_PART, B_LBO, GROUP);
    };
    float* o = out + (pl0 + plane) * n_amps;
    float acc[HALVES][64], d[64];
    // the exact sum of half h's hi parts from a zeroed accumulator
    auto exact = [&](uint32_t base, int h) {
      fence_acc(d);
      wgmma_fence();
      wgmma_tf32(d, A(base, h, 0), B(base, w_first), 0);
      wgmma_tf32(d, A(base, h, x_im_hi), B(base, w_second), 1);
      wgmma_commit();
    };
    // the cross terms x_hi W_lo + x_lo tf32(W) of half h, likewise
    auto cross = [&](uint32_t base, int h) {
      fence_acc(d);
      wgmma_fence();
      wgmma_tf32(d, A(base, h, 0), B(base, 2 + w_first), 0);
      wgmma_tf32(d, A(base, h, x_im_hi), B(base, 2 + w_second), 1);
      wgmma_tf32(d, A(base, h, 2), B(base, 4 + w_first), 1);
      wgmma_tf32(d, A(base, h, x_im_lo), B(base, 4 + w_second), 1);
      wgmma_commit();
    };
    // the products' sum, once in, added to half h's to nearest
    auto add = [&](int h) {
      wgmma_wait<0>();
      fence_acc(d);
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[h][r] = __fadd_rn(acc[h][r], d[r]);
    };
    int64_t item = 0;
    for (int64_t tile = 0; tile < my_tiles; ++tile) {
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
#pragma unroll
        for (int r = 0; r < 64; ++r) acc[h][r] = 0.f;
      }
      // each k-step: for each half its exact sum, then its cross sum, and
      // the stage handed back
#pragma unroll 1
      for (int s = 0; s < KS; ++s, ++item) {
        const int slot = int(item % STAGES);
        mbar_wait(&full[slot], uint32_t((item / STAGES) & 1));
        const uint32_t base = st0 + slot * STAGE;
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          exact(base, h);
          add(h);
          cross(base, h);
          add(h);
        }
        mbar_arrive(&empty[slot]);
      }
      // acc[h][4 j + e]: column row 16 warp + g + 8 (e >> 1) of half h,
      // output 8 j + 2 t + (e & 1)
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int64_t c = col0(item - 1, h) + 16 * warp + g + 8 * r;
          if (c >= cols) continue;
          float* oc = o + col_base(c, log_b);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int i = 8 * j + 2 * t;
            const float v0 = acc[h][4 * j + 2 * r];
            const float v1 = acc[h][4 * j + 2 * r + 1];
            if (TRAIL) {
              *reinterpret_cast<float2*>(oc + i) = make_float2(v0, v1);
            } else {
              oc[int64_t(i) << log_b] = v0;
              oc[int64_t(i + 1) << log_b] = v1;
            }
          }
        }
      }
    }
  }
}

}  // namespace wg

template <bool TRAIL>
int launch_wg(const WindowArgs& a) {
  static int blocks_cap[MAX_DEVICES] = {};  // resident blocks, per device
  cudaError_t err;
  const int cap = resident_blocks(wg::window_wg_kernel<TRAIL>, wg::SMEM,
                                  blocks_cap, err, wg::THREADS);
  if (cap == 0) return static_cast<int>(err);
  if (a.scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float4* parts = reinterpret_cast<float4*>(a.scratch);
  wg::window_wg_split_kernel<><<<wg::KS, wg::D, 0, a.stream>>>(a.w, parts);
  const int64_t tiles = ((a.n_amps >> wg::LOG_D) + wg::TILE - 1) / wg::TILE;
  const unsigned grid = particle_grid(tiles, cap, a.particles);
  const Diag diag{a.flips, a.nflips, a.masks, a.wants,
                  a.phase, a.nphases, a.n_amps - 1};
  wg::window_wg_kernel<TRAIL>
      <<<dim3(grid, a.particles), wg::THREADS, wg::SMEM, a.stream>>>(
          a.psi, a.out, parts, a.n_amps, a.log_b, diag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
