// The tensor-core tile of the window and pair kernels (window_tc.cuh,
// pair_tc.cuh): 3xTF32 mma.sync.m16n8k8 products of planar complex
// operands without rounding bias, the BF16 m16n8k16 product and bf16
// splits of the reduced modes' kernels, the cp.async helpers, and the
// lookup tables of the fused flips and phases.  One copy, included by every source; tpu/kernels.py:build_kernels
// hashes it with them.
//
// The product is one real GEMM, [out_r; out_i] = [[Wr, -Wi], [Wi, Wr]]
// [x_r; x_i], computed transposed: the state columns are the rows of the A
// operand (built in registers), W the B operand.
//
// 3xTF32 without rounding bias.  x = x_hi + x_lo, W = W_hi + W_lo.  The
// tensor cores round their sums toward zero, so any sum they round shrinks
// the state a little every pass.  Here x_hi is x rounded to nearest on a
// grid shared by a column's 8 elements of a k-step (both planes): the step
// 2^(E - 10), E the exponent just above their largest magnitude; W likewise
// per row and k-step.  Every hi*hi product is then a multiple of
// 2^(Ex + Ew - 20) below 2^(Ex + Ew), a k-step's xr Wr - xi Wi (and
// xr Wi + xi Wr) has at most 24 significant bits, and the tensor cores sum
// it exactly; it is added to FP32 accumulators by round-to-nearest FADDs.
// x_lo = x - x_hi rounded to tf32 can reach 2^-11 of the grid's largest
// magnitude, so x_lo W_lo is not negligible: the three products are
// x_hi W_hi + x_hi W_lo + x_lo tf32(W).  The two cross terms (small, of
// random sign) are summed over a stage on the tensor cores.
// tests/test_torch_window_split.py and tests/test_torch_pair_split.py
// replay the arithmetic in numpy.
//
// The reduced modes (Prec BF16X3, BF16: the reference's --precision bf16_3x
// and bf16, qbot_tpu/tpu/kernels.py:55-71) have kernels of their own,
// window_bf16.cuh and pair_bf16.cuh (m16n8k16, W split once per block), so
// the 3xTF32 tile here serves the F32 precision alone.  x and W are split
// as the reference splits them, x_hi = x rounded to bf16 (to nearest
// even), x_lo = bf16(x - x_hi), with no grid; BF16X3 sums x_hi W_hi +
// x_hi W_lo + x_lo W_hi, BF16 x_hi W_hi alone.  Products of bf16 values are
// exact in FP32, but a k-step's sum of them is not, and the tensor cores
// round it toward zero: the state shrinks a little every pass (a norm
// drift that is these modes' contract; planar.make_scanned_planar_runner's
// renorm_every is its remedy).  The earlier form of those modes, this
// tile's staging and loads with mma.sync.m16n8k8 BF16 products, lives on
// only in the numpy replays of tests/test_torch_window_split.py and
// tests/test_torch_pair_split.py, as the yardstick of the kernels' drift.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;   // cp.async ring depth
constexpr int TABLE = 8;    // diagonal entries looked up by tables
constexpr int MAX_DEVICES = 64;  // size of the per-device launch caches
constexpr int MAX_SMEM = 232448;  // dynamic shared memory of a block (H100)

// The precision of the products: the 3xTF32 tile without rounding bias
// (the f32 and f32_mix modes), or the reduced modes' BF16 splits; the
// integer the entry points take (tpu/kernels.py: _PREC)
enum Prec { F32 = 0, BF16X3 = 1, BF16 = 2 };

// x rounded to tf32, to nearest with ties away from zero, for finite x
// (cvt.rna.tf32.f32 also screens NaN: twice the instructions)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The rounding constant of a grid: for values below 2^E in magnitude, where
// e is the exponent field of their largest magnitude (E = e - 126), it is
// 1.5 * 2^(E + 13), whose ulp is the grid step 2^(E - 10).
__device__ __forceinline__ float grid_of(uint32_t e) {
  return __uint_as_float(((e + 14u) << 23) | 0x400000u);
}

// The grid of 8 k-consecutive elements of a row of W, both planes
__device__ __forceinline__ float grid_of_row8(const float* wr,
                                              const float* wi) {
  float a = 0.f;
  for (int j = 0; j < 8; ++j) a = fmaxf(a, fmaxf(fabsf(wr[j]), fabsf(wi[j])));
  return grid_of(__float_as_uint(a) >> 23);
}

// x = hi + lo: hi is x rounded to nearest on the grid of m (at most 11
// significant bits, so a tf32 value), lo the rest rounded to tf32
__device__ __forceinline__ void split(float x, float m, uint32_t& hi,
                                      uint32_t& lo) {
  const float h = __fsub_rn(__fadd_rn(x, m), m);
  hi = __float_as_uint(h);
  lo = tf32(__fsub_rn(x, h));
}

// The grids of the column rows g and g + 8 of an A fragment's k-step: the
// lanes 4g..4g+3 hold the row's 8 elements of both planes
__device__ __forceinline__ void row_grids(const float* xr, const float* xi,
                                          float& m0, float& m1) {
  const float a0 = fmaxf(fmaxf(fabsf(xr[0]), fabsf(xi[0])),
                         fmaxf(fabsf(xr[2]), fabsf(xi[2])));
  const float a1 = fmaxf(fmaxf(fabsf(xr[1]), fabsf(xi[1])),
                         fmaxf(fabsf(xr[3]), fabsf(xi[3])));
  uint32_t e = (__float_as_uint(a0) >> 23) | (__float_as_uint(a1) >> 23 << 16);
  e = __vmaxu2(e, __shfl_xor_sync(0xffffffffu, e, 1));
  e = __vmaxu2(e, __shfl_xor_sync(0xffffffffu, e, 2));
  m0 = grid_of(e & 0xffffu);
  m1 = grid_of(e >> 16);
}

// c += a b in mma.sync.m16n8k8 TF32: 4 A and 2 B registers
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a b, from a zero accumulator
__device__ __forceinline__ void mma0(float* c, const uint32_t* a,
                                     const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// c += a b in mma.sync.m16n8k16 BF16 (window_bf16.cuh): A registers a.x,
// a.y hold k slots 2t, 2t + 1 of rows g and g + 8, a.z, a.w slots 2t + 8,
// 2t + 9 of the same rows; B registers b[0], b[1] slots 2t, 2t + 1 and
// 2t + 8, 2t + 9 of column g
__device__ __forceinline__ void mma16(float* c, const uint4& a,
                                      const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

// c = a b in mma.sync.m16n8k16 BF16, from a zero accumulator
__device__ __forceinline__ void mma16_0(float* c, const uint4& a,
                                        const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// x0, x1 rounded to bf16 to nearest even and packed, x0 in the low half
__device__ __forceinline__ uint32_t bf16x2(float x0, float x1) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(x1), "f"(x0));
  return d;
}

// x rounded to bf16 to nearest even, as an FP32 value
__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float(bf16x2(x, 0.f) << 16);
}

// x = hi + lo for two values: hi = bf16(x), lo = bf16(x - hi), packed as
// bf16x2 packs them (x - hi is exact in FP32)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = bf16x2(x0, x1);
  lo = bf16x2(__fsub_rn(x0, __uint_as_float(hi << 16)),
              __fsub_rn(x1, __uint_as_float(hi & 0xffff0000u)));
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 8 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x *= z, each product and sum rounded on its own (no FMA contraction), as
// the plain versions' elementwise operations round them: a phase then gives
// the plain version's float32 amplitude, which the reduced modes round to
// bf16 (an amplitude one ulp apart can round to a bf16 value 2^-8 apart)
__device__ __forceinline__ void cmul(float& xr, float& xi, float zr,
                                     float zi) {
  const float r = __fsub_rn(__fmul_rn(xr, zr), __fmul_rn(xi, zi));
  xi = __fadd_rn(__fmul_rn(xr, zi), __fmul_rn(xi, zr));
  xr = r;
}

// ---------------------------------------------------------------------------
// fused flips and phases
// ---------------------------------------------------------------------------

// Diagonal entry e of a launch: the phases, then the flips as phases of -1
// on every index bit.
struct Diag {
  const int64_t* flips;
  int nflips;
  const int64_t* masks;
  const int64_t* wants;
  const float* phase;
  int nphases;
  int64_t all_bits;

  __device__ __forceinline__ void entry(int e, int64_t& mask, int64_t& want,
                                        float& zr, float& zi) const {
    if (e < nphases) {
      mask = masks[e], want = wants[e];
      zr = phase[e], zi = phase[nphases + e];
    } else {
      mask = all_bits, want = flips[e - nphases];
      zr = -1.f, zi = 0.f;
    }
  }
};

// The lookup tables of the first TABLE diagonal entries for a product over
// the D window bits log_b.. of the flat index (block-wide): entry e hits
// element (c, j) iff its window bits match j (bit e of jtab[j]) and its
// other bits match the column (bit e of col_hits); comb[h] is the factor of
// the hit set h.  COMBINE (the F32 kernels): the product of its entries'
// factors, one lookup and one complex product an element; an amplitude so
// moves by an ulp from the plain version's, far below their limits.  Else
// (the reduced modes, where the bf16 rounding of an amplitude an ulp apart
// moves by 2^-8): entry e's factor for h = {e}, 1 for no entry and for
// several, whose factors go on one by one (apply_hit, apply_several_hits).
template <int D, bool COMBINE>
__device__ __forceinline__ void diag_tables(const Diag& diag, int log_b,
                                            uint32_t* jtab, float2* comb,
                                            long long* cmask,
                                            long long* cwant) {
  const int tid = threadIdx.x;
  const int64_t jbits = int64_t(D - 1) << log_b;
  const int ndiag = diag.nphases + diag.nflips;
  const int ntab = ndiag < TABLE ? ndiag : TABLE;
  for (int j = tid; j < D; j += blockDim.x) {
    uint32_t bits = 0;
    for (int e = 0; e < ntab; ++e) {
      int64_t mask, want;
      float zr, zi;
      diag.entry(e, mask, want, zr, zi);
      if (((int64_t(j) << log_b) & mask & jbits) == (want & jbits))
        bits |= 1u << e;
    }
    jtab[j] = bits;
  }
  for (int h = tid; h < (1 << ntab); h += blockDim.x) {
    float2 z = make_float2(1.f, 0.f);
    for (int e = 0; e < ntab; ++e) {
      if (((h >> e) & 1) && (COMBINE || h == (1 << e))) {
        int64_t mask, want;
        float er, ei;
        diag.entry(e, mask, want, er, ei);
        cmul(z.x, z.y, er, ei);
      }
    }
    comb[h] = z;
  }
  if (tid < ntab) {
    int64_t mask, want;
    float zr, zi;
    diag.entry(tid, mask, want, zr, zi);
    cmask[tid] = mask & ~jbits;
    cwant[tid] = want & ~jbits;
  }
}

// x *= comb[h] (diag_tables).  In the reduced modes the factors of an
// element hit by several entries then go on one by one in the entries'
// order, as the plain versions apply them (apply_several_hits): a product of
// two entries' factors would round otherwise, and the bf16 rounding of x
// moves by 2^-8 with it: at D = 128 with 13 entries a combined factor puts
// the bf16 window 0 to 3.05e-5 from its plain version, against its limit
// of 1e-5 (tests/test_torch_window_split.py replays both orders, over 8
// seeds).  The second pass runs only where an element has two or more.
__device__ __forceinline__ void apply_hit(float& xr, float& xi, uint32_t h,
                                          const float2* comb) {
  const float2 z = comb[h];
  cmul(xr, xi, z.x, z.y);
}

__device__ __forceinline__ void apply_several_hits(float& xr, float& xi,
                                                   uint32_t h,
                                                   const float2* comb) {
  if (!(h & (h - 1))) return;
  for (; h; h &= h - 1) {
    const float2 z = comb[h & (0u - h)];
    cmul(xr, xi, z.x, z.y);
  }
}

// the table entries that the column whose j = 0 element sits at flat index
// base hits
__device__ __forceinline__ uint32_t col_hits(int64_t base, int ntab,
                                             const long long* cmask,
                                             const long long* cwant) {
  uint32_t bits = 0;
  for (int e = 0; e < ntab; ++e) {
    if ((base & cmask[e]) == cwant[e]) bits |= 1u << e;
  }
  return bits;
}

// The k within its k-step of element e of a lane's A fragment (and of its
// B fragment's b0, b1 for e >> 1 = 0, 1): t + 4 (e >> 1) in mma's own
// order; 2t + (e >> 1) in the paired order, which keeps a lane's two k of a
// row side by side (one 8-byte load).  A k-step's sum is the same in any
// order of its k, as long as A and B take the same one.
template <bool PAIRED_K>
__device__ __forceinline__ int k_of(int t, int e) {
  return PAIRED_K ? 2 * t + (e >> 1) : t + 4 * (e >> 1);
}

// Flips and phases on the A fragments of KC k-steps whose first j is j0 (the
// F32 tile, its table COMBINE): one lookup and one complex product an
// element, then the entries past the tables tested on the flat index,
// base_of(r) | j << log_b for column row g + 8 r.  Call only with diagonals
// (ndiag > 0).
template <int KC, bool PAIRED_K, typename BaseOf>
__device__ __forceinline__ void diag_fragments(
    float (&xr)[KC][4], float (&xi)[KC][4], const Diag& diag, int ndiag,
    int j0, int log_b, const uint32_t* jtab, const float2* comb,
    const uint32_t (&colhit)[2], BaseOf base_of) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + kc * 8 + k_of<PAIRED_K>(t, e);
      apply_hit(xr[kc][e], xi[kc][e], colhit[e & 1] & jtab[j], comb);
    }
  }
  if (ndiag > TABLE) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + kc * 8 + k_of<PAIRED_K>(t, e);
        const int64_t mflat = base_of(e & 1) | (int64_t(j) << log_b);
        for (int q = TABLE; q < ndiag; ++q) {
          int64_t mask, want;
          float zr, zi;
          diag.entry(q, mask, want, zr, zi);
          if ((mflat & mask) == want) cmul(xr[kc][e], xi[kc][e], zr, zi);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the narrow pair: a D2 window whose operand is Y = W1 (Phi F X), W1 of
// D1 = 2, 4 (window_tc.cuh, window_bf16.cuh with D1 > 1)
// ---------------------------------------------------------------------------

// The narrow pair's columns and its pass over a stage.  A tile of BN
// columns holds BNB = BN / D1 base columns (a, b) times the D1 slots, j of
// the staged X, which the pass turns into i of Y in place: slot-major in the
// middle pair, so that a run of tile columns is a run of b; base-major in
// the trailing pair, where column c = a D1 + slot is the D2 window's own.
// The pass gives each thread Q base elements (base column, k) of a stage of
// BK k, the k fastest in the trailing pair's [c][k] stage, the base column
// in the middle pair's [k][c] stage.
template <int BN, int BK, int PITCH, int D1, bool TRAIL, int NTHR>
struct Narrow {
  static constexpr int BNB = BN / D1;
  static constexpr int Q = BNB * BK / NTHR;
  static_assert(Q >= 1 && Q * NTHR == BNB * BK, "narrow pass");
  // the D2 window's column, (a D1 + slot) B + b, of tile column c
  static __device__ __forceinline__ int64_t window_col(int64_t c,
                                                       int log_b) {
    if constexpr (TRAIL) {
      return c;
    } else {
      const int64_t cl = c & (BN - 1);
      const int64_t base = (c - cl) / D1 + (cl & (BNB - 1));
      return (((base >> log_b) * D1 + cl / BNB) << log_b) |
             (base & ((int64_t(1) << log_b) - 1));
    }
  }
  // the tile column of base column cb's slot j
  static __device__ __forceinline__ int col(int cb, int j) {
    return TRAIL ? cb * D1 + j : j * BNB + cb;
  }
  // the base column and k of a thread's element q
  static __device__ __forceinline__ void element(int tid, int q, int& cb,
                                                 int& k) {
    const int e = tid + q * NTHR;
    cb = TRAIL ? e / BK : e % BNB;
    k = TRAIL ? e % BK : e / BNB;
  }
  static __device__ __forceinline__ int offset(int cl, int k) {
    return TRAIL ? cl * PITCH + k : k * PITCH + cl;
  }
};

// The narrow pair's table of its first window: bit e of j1tab[j] is set iff
// table entry e's bits of that window (D1 values of j at bit shift of the
// flat index) match j; the entries' column bits (diag_tables: cmask, cwant)
// then lose those bits.  Call after diag_tables, from every thread of the
// block (the thread that wrote an entry's cmask and cwant clears them).
template <int D1>
__device__ __forceinline__ void diag_tables_d1(const Diag& diag, int shift,
                                               uint32_t* j1tab,
                                               long long* cmask,
                                               long long* cwant) {
  const int tid = threadIdx.x;
  const int64_t bits = int64_t(D1 - 1) << shift;
  const int ndiag = diag.nphases + diag.nflips;
  const int ntab = ndiag < TABLE ? ndiag : TABLE;
  for (int j = tid; j < D1; j += blockDim.x) {
    uint32_t hit = 0;
    for (int e = 0; e < ntab; ++e) {
      int64_t mask, want;
      float zr, zi;
      diag.entry(e, mask, want, zr, zi);
      if (((int64_t(j) << shift) & mask & bits) == (want & bits))
        hit |= 1u << e;
    }
    j1tab[j] = hit;
  }
  if (tid < ntab) {
    cmask[tid] &= ~bits;
    cwant[tid] &= ~bits;
  }
}

// W1 (2, D1, D1) into shared memory, entry (i, j) as {re, im} of its parts:
// W itself and 0 (F32), the reference's bf16 parts hi = bf16(w) to nearest
// even and lo = bf16(w - hi) (BF16X3, BF16)
template <int D1, int PREC>
__device__ __forceinline__ void stage_w1(const float* w1, float4* w1s) {
  for (int e = threadIdx.x; e < D1 * D1; e += blockDim.x) {
    const float wr = w1[e], wi = w1[D1 * D1 + e];
    if constexpr (PREC == F32) {
      w1s[e] = make_float4(wr, wi, 0.f, 0.f);
    } else {
      uint32_t hi, lo;
      split_bf16(wr, wi, hi, lo);
      w1s[e] = make_float4(__uint_as_float(hi << 16),
                           __uint_as_float(hi & 0xffff0000u),
                           __uint_as_float(lo << 16),
                           __uint_as_float(lo & 0xffff0000u));
    }
  }
}

// x *= the diagonal entries that hit one element: the table entries of its
// hit set h (diag_tables<COMBINE>), then those past the tables that its
// flat index, flat(), matches
template <bool COMBINE, typename Flat>
__device__ __forceinline__ void phase_element(float& xr, float& xi,
                                              uint32_t h, const float2* comb,
                                              const Diag& diag, int ndiag,
                                              Flat flat) {
  apply_hit(xr, xi, h, comb);
  if constexpr (!COMBINE) apply_several_hits(xr, xi, h, comb);
  if (ndiag > TABLE) {
    const int64_t m = flat();
    for (int q = TABLE; q < ndiag; ++q) {
      int64_t mask, want;
      float zr, zi;
      diag.entry(q, mask, want, zr, zi);
      if ((m & mask) == want) cmul(xr, xi, zr, zi);
    }
  }
}

// y += w x, complex, by two FMAs a plane: re first -wi xi then wr xr, im
// first wi xr then wr xi (a product of bf16 parts is exact in FP32, so an
// FMA rounds its sum once, as an add would)
__device__ __forceinline__ void cfma2(float wr, float wi, float xr, float xi,
                                      float& yr, float& yi) {
  yr = fmaf(wr, xr, fmaf(-wi, xi, yr));
  yi = fmaf(wr, xi, fmaf(wi, xr, yi));
}

// The narrow pair's pass over stage st (planes PLANE floats apart) of the
// k16 (k8) step whose first m is m0: each of the thread's Q base elements
// (N: Narrow) is read at its D1 slots j, phased (the table entries of hit
// set phit[q] & j1tab[j] & jtab[m], then those past the tables on its flat
// index, flat(tile column) | m << log_b), mixed into the D1 values of
// Y[i] = sum_j W1[i, j] X_j in FP32 in the precision of the products, and
// written back over its slots.  For each i the sum runs over j in order,
// taking for each j the mode's products of W1's parts and x's: F32, W x;
// BF16X3, hi hi, hi lo, lo hi (W's part first); BF16, hi hi: the order of
// the reduced FMA window (window_apply.cu), so Y is its output bit for bit
// (tests/test_torch_pair_split.py).
template <class N, int D1, int PLANE, int PREC, typename Flat>
__device__ __forceinline__ void narrow_pass(
    float* st, int tid, const float4* w1s, const uint32_t (&phit)[N::Q],
    const uint32_t* j1tab, const uint32_t* jtab, int m0, const float2* comb,
    const Diag& diag, int ndiag, int log_b, Flat flat) {
#pragma unroll 1
  for (int q = 0; q < N::Q; ++q) {
    int cb, k;
    N::element(tid, q, cb, k);
    float x[D1][4];  // [j]: re, im (hi parts), lo re, lo im
#pragma unroll
    for (int j = 0; j < D1; ++j) {
      const int o = N::offset(N::col(cb, j), k);
      x[j][0] = st[o];
      x[j][1] = st[PLANE + o];
      if (ndiag) {
        phase_element<PREC == F32>(
            x[j][0], x[j][1], phit[q] & j1tab[j] & jtab[m0 + k], comb, diag,
            ndiag, [&] {
                        return flat(N::col(cb, j)) |
                               (int64_t(m0 + k) << log_b);
                      });
      }
      if constexpr (PREC != F32) {
        uint32_t hi, lo;
        split_bf16(x[j][0], x[j][1], hi, lo);
        x[j][0] = __uint_as_float(hi << 16);
        x[j][1] = __uint_as_float(hi & 0xffff0000u);
        x[j][2] = __uint_as_float(lo << 16);
        x[j][3] = __uint_as_float(lo & 0xffff0000u);
      }
    }
#pragma unroll
    for (int i = 0; i < D1; ++i) {
      float yr = 0.f, yi = 0.f;
#pragma unroll
      for (int j = 0; j < D1; ++j) {
        const float4 w = w1s[i * D1 + j];
        cfma2(w.x, w.y, x[j][0], x[j][1], yr, yi);
        if constexpr (PREC == BF16X3) {
          cfma2(w.x, w.y, x[j][2], x[j][3], yr, yi);
          cfma2(w.z, w.w, x[j][0], x[j][1], yr, yi);
        }
      }
      const int o = N::offset(N::col(cb, i), k);
      st[o] = yr;
      st[PLANE + o] = yi;
    }
  }
}

// ---------------------------------------------------------------------------
// the products
// ---------------------------------------------------------------------------

// The A fragments of KC k-steps, element e of k-step kc being column row
// g (+ 8 for odd e) at k = 8 kc + k_of(t, e), split into hi and lo
// parts, with the negated im parts that the real form of the complex
// product takes: one TF32 register an element, on the grid of its column
// row and k-step.
template <int KC>
struct ASplit {
  uint32_t rh[KC][4], rl[KC][4], ih[KC][4], il[KC][4], nh[KC][4], nl[KC][4];

  __device__ __forceinline__ ASplit(const float (&xr)[KC][4],
                                    const float (&xi)[KC][4]) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      float m[2];
      row_grids(xr[kc], xi[kc], m[0], m[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split(xr[kc][e], m[e & 1], rh[kc][e], rl[kc][e]);
        split(xi[kc][e], m[e & 1], ih[kc][e], il[kc][e]);
        nh[kc][e] = ih[kc][e] ^ 0x80000000u;
        nl[kc][e] = il[kc][e] ^ 0x80000000u;
      }
    }
  }
};

// The B fragments of one n-tile and k-step, W[8 it + g][8 ks + k_of(t, e)]
// for e = 0, 2, each [re, im] in registers [b0, b1]: W_hi, W_lo and the W
// that multiplies x_lo, tf32(W)
struct BFrag {
  uint32_t h[2][2], l[2][2], t[2][2];

  // from FP32 values and the grid m of their row and k-step
  __device__ __forceinline__ void set(float r0, float r1, float i0, float i1,
                                      float m) {
    split(r0, m, h[0][0], l[0][0]);
    split(r1, m, h[0][1], l[0][1]);
    split(i0, m, h[1][0], l[1][0]);
    split(i1, m, h[1][1], l[1][1]);
    t[0][0] = tf32(r0);
    t[0][1] = tf32(r1);
    t[1][0] = tf32(i0);
    t[1][1] = tf32(i1);
  }
};

// acc[it] += x W over the KC k-steps of a stage for the warp's NI n-tiles;
// load_b(it, kc, b) fills the B fragments of n-tile it at k-step kc.  x W =
// x_hi W_hi + x_hi W_lo + x_lo tf32(W): each k-step's exact x_hi W_hi sums
// go to the FP32 accumulators by round-to-nearest FADDs; the cross terms
// are summed over the stage on the tensor cores, then added likewise.
// G n-tiles at once, each with two exact sums (re, im) and two cross-term
// sums.  acc[it][p][q]: plane p; q = 0, 1 are outputs 2t, 2t + 1 of column
// row g, q = 2, 3 the same of row g + 8.
template <int KC, int NI, int NA, typename LoadB>
__device__ __forceinline__ void tc_products(float (&acc)[NA][2][4],
                                            const ASplit<KC>& a,
                                            LoadB load_b) {
  static_assert(NI <= NA, "accumulators");
  constexpr int G = NI < 2 ? NI : 2;
#pragma unroll
  for (int it0 = 0; it0 < NI; it0 += G) {
    float cross[G][2][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      BFrag b[G];
#pragma unroll
      for (int g2 = 0; g2 < G; ++g2) load_b(it0 + g2, kc, b[g2]);
      // plane p of n-tile g2 sums x plane ah/al[p][s] times W plane
      // wp[p][s], s = 0, 1
      const uint32_t* ah[2][2] = {{a.rh[kc], a.nh[kc]}, {a.rh[kc], a.ih[kc]}};
      const uint32_t* al[2][2] = {{a.rl[kc], a.nl[kc]}, {a.rl[kc], a.il[kc]}};
      constexpr int wp[2][2] = {{0, 1}, {1, 0}};
      float exact[G][2][4];
#pragma unroll
      for (int g2 = 0; g2 < G; ++g2) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma0(exact[g2][p], ah[p][0], b[g2].h[wp[p][0]]);
          if (kc == 0)
            mma0(cross[g2][p], ah[p][0], b[g2].l[wp[p][0]]);
          else
            mma(cross[g2][p], ah[p][0], b[g2].l[wp[p][0]]);
        }
      }
#pragma unroll
      for (int g2 = 0; g2 < G; ++g2) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma(exact[g2][p], ah[p][1], b[g2].h[wp[p][1]]);
          mma(cross[g2][p], al[p][0], b[g2].t[wp[p][0]]);
        }
      }
#pragma unroll
      for (int g2 = 0; g2 < G; ++g2) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[it0 + g2][p][q] += exact[g2][p][q];
        }
      }
#pragma unroll
      for (int g2 = 0; g2 < G; ++g2) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma(cross[g2][p], ah[p][1], b[g2].l[wp[p][1]]);
          mma(cross[g2][p], al[p][1], b[g2].t[wp[p][1]]);
        }
      }
    }
#pragma unroll
    for (int g2 = 0; g2 < G; ++g2) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[it0 + g2][p][q] += cross[g2][p][q];
      }
    }
  }
}

// Resident blocks of a kernel of ``threads`` threads a block on the current
// device, cached per device, after allowing it smem bytes of dynamic shared
// memory; cache holds MAX_DEVICES entries.  Returns 0 with err set on
// failure.
template <typename Kernel>
int resident_blocks(Kernel kernel, int smem, int* cache, cudaError_t& err,
                    int threads = THREADS) {
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return 0;
  if (dev >= MAX_DEVICES) {
    err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cache[dev] == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return 0;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cache[dev];
}

// The particle axis.  A batched launch serves P states of one shape, laid
// out one after another as (P, 2, n_amps) (the ensemble's (B, 2, 2^n)):
// blockIdx.y is the particle, and a kernel advances its state and output
// pointers by particle_offset(n_amps) on entry, so that all its index
// arithmetic, the flat indices of the fused flips and phases included, is
// that of one state.  The tensor-core kernels (window_tc.cuh,
// pair_tc.cuh, window_bf16.cuh, pair_bf16.cuh) sit at their register
// limits, where the two moved pointers (4 registers) spilled the f32
// trailing D = 128 window (11% slower on an H100) and slowed the reduced
// windows by 5-17%: they index the batch's planes from particle_plane()
// instead, one register.  gridDim.y holds at most MAX_PARTICLES.
constexpr int MAX_PARTICLES = 65535;

__device__ __forceinline__ int64_t particle_offset(int64_t n_amps) {
  return int64_t(blockIdx.y) * 2 * n_amps;
}

// the batch's plane of this particle's real part; its imaginary part is
// the next one
__device__ __forceinline__ int particle_plane() { return 2 * blockIdx.y; }

// The x extent of a persistent grid whose y axis holds `particles` states:
// at most `work` blocks, and the `cap` resident blocks shared out among the
// particles in multiples of `unit` (one unit at least), so that a batched
// launch fills the card as one state's launch does.  Which block computes
// an element changes with it, how the element is computed does not: a
// batched launch gives each particle the bits of its own launch.
inline unsigned particle_grid(int64_t work, int cap, int particles,
                              int unit = 1) {
  int64_t per = cap / (particles > 0 ? particles : 1);
  per -= per % unit;
  if (per < unit) per = unit;
  return static_cast<unsigned>(work < per ? work : per);
}

}  // namespace
