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
// This file is the dispatcher: which widths take which kernel (chosen here,
// by geometry, before the launch, as tpu/kernels.py:launch_family names
// it; a geometry is never retried on another kernel):
// - D1 >= 8 and D2 >= 8, trailing or middle: on the tensor cores,
//   pair_tc_kernel (pair_tc.cuh: 3xTF32 mma.sync products) in f32 and
//   f32_mix, but for the trailing pair at D2 = 128 with D1 = 64, 128, which
//   runs pair_wg_kernel (pair_wg.cuh: 3xTF32 wgmma products, W1 and W2 split
//   once into the caller's scratch); pair_bf16_kernel (pair_bf16.cuh: BF16
//   m16n8k16) in bf16_3x and bf16;
// - D1 in {2, 4} and D2 >= 8, the narrow pair of the brickwork at n = 1, 2
//   (mod 7): the D2 window's tensor-core tile with W1 mixed into its
//   operand as it is staged (window_tc.cuh in f32 and f32_mix,
//   window_bf16.cuh in bf16_3x and bf16, instantiated with D1 > 1);
// - D1 and D2 in {2, 4}, below the tile's k-step and n-tile of 8: the
//   streaming pair_fma_stream_kernel (pair_stream.cu), FP32 FMAs on
//   registers (plans at window = 1, 2 reach it as middle pairs);
// - D1 >= 8 with D2 in {2, 4}: refused.  The caller runs such a pair as two
//   window launches (tpu/kernels.py:pair_route), which beat a one-pass pair
//   of FP32 FMAs there; explicit partition="dot" plans on the kernel engine
//   produce it.
// Each in the precision of the products the caller asks for (tc_tile.cuh:
// Prec): F32 for the f32 and f32_mix modes, BF16X3 and BF16 for bf16_3x and
// bf16, whose FMA variants split their operands into bf16 parts in
// registers.
#include "pair_tc.cuh"
#include "window_tc.cuh"

// The launcher of the streaming pair at D1 = 2^log_d1 and D2 = 2^args.
// log_d2, both 2 or 4, in one precision of the products (tc_tile.cuh:
// Prec), trailing (args.log_b == 0) or middle; returns the launch's
// cudaGetLastError().  Defined in pair_stream.cu, once per precision.
template <int PREC>
int pair_stream_launch(int log_d1, const PairArgs& args);

namespace {

template <int PREC>
int launch_tc_any(int log_d1, bool middle, const PairArgs& args) {
  if (middle) {
    switch (log_d1) {
      case 3: return pair_tc_launch<8, true, PREC>(args);
      case 4: return pair_tc_launch<16, true, PREC>(args);
      case 5: return pair_tc_launch<32, true, PREC>(args);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (log_d1) {
    case 3: return pair_tc_launch<8, false, PREC>(args);
    case 4: return pair_tc_launch<16, false, PREC>(args);
    case 5: return pair_tc_launch<32, false, PREC>(args);
    case 6: return pair_tc_launch<64, false, PREC>(args);
    case 7: return pair_tc_launch<128, false, PREC>(args);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int PREC>
int launch_pair(const float* psi, float* out, const float* w1,
                const float* w2, int64_t n_amps, int particles, int log_d1,
                int log_d2, int log_b, const int64_t* flips, int nflips,
                const int64_t* masks, const int64_t* wants,
                const float* phase, int nphases, float* scratch,
                cudaStream_t s) {
  const PairArgs args{psi,   out,    w1,    w2,      n_amps, log_d2,
                      log_b, flips,  nflips, masks,  wants,  phase,
                      nphases, s,    particles, scratch};
  if (PREC == F32 && log_b == 0 && log_d2 == 7 && log_d1 >= 6)
    return pair_wg_launch(log_d1, args);
  if (log_d1 >= 3 && log_d2 >= 3)
    return launch_tc_any<PREC>(log_d1, log_b != 0, args);
  if (log_d1 >= 3)  // D2 <= 4 under D1 >= 8: the caller runs two windows
    return static_cast<int>(cudaErrorInvalidValue);
  if (log_d2 <= 2)
    return pair_stream_launch<PREC>(log_d1, args);
  // the narrow pair: the D2 window with W = W2, W1 mixed in as it stages
  const WindowArgs a{psi,    out,   w2,    n_amps, log_d2, log_b,
                     flips,  nflips, masks, wants, phase,  nphases,
                     s,      w1,    particles};
  return log_d1 == 1 ? window_tc_launch<2, PREC>(a)
                     : window_tc_launch<4, PREC>(a);
}

}  // namespace

// psi, out: (particles, 2, n_amps) float32, 16-byte aligned, one launch for
// all the particles (tc_tile.cuh: particle_offset); w1: (2, D1, D1), w2:
// (2, D2, D2) float32, w2 16-byte aligned, with Di = 2^log_di; B = 2^log_b;
// prec: the precision of the products (tc_tile.cuh: Prec); scratch:
// qbot_pair_scratch_floats(log_d1) floats, 16-byte aligned, for the f32
// trailing pair at D2 = 128 with D1 = 64, 128 (pair_wg.cuh), else unused.
// B == 1 runs the trailing pair, B >= 128 with D1 <= 32 the middle pair;
// other geometries, and D1 >= 8 with D2 <= 4, are refused with
// cudaErrorInvalidValue (the caller runs two windows).  Returns the
// launch's cudaGetLastError().
extern "C" int qbot_pair_apply(const float* psi, float* out, const float* w1,
                               const float* w2, int64_t n_amps,
                               int particles, int log_d1, int log_d2,
                               int log_b, const int64_t* flips, int nflips,
                               const int64_t* masks, const int64_t* wants,
                               const float* phase, int nphases, int prec,
                               float* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_d1 < 1 || log_d1 > 7 || log_d2 < 1 || log_d2 > 7 ||
      (n_amps >> (log_d1 + log_d2 + log_b)) < 1 || particles < 1 ||
      particles > MAX_PARTICLES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (log_b != 0 && (log_b < 7 || log_d1 > 5))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (prec) {
    case F32:
      return launch_pair<F32>(psi, out, w1, w2, n_amps, particles, log_d1,
                              log_d2, log_b, flips, nflips, masks, wants,
                              phase, nphases, scratch, s);
    case BF16X3:
      return launch_pair<BF16X3>(psi, out, w1, w2, n_amps, particles, log_d1,
                                 log_d2, log_b, flips, nflips, masks, wants,
                                 phase, nphases, scratch, s);
    case BF16:
      return launch_pair<BF16>(psi, out, w1, w2, n_amps, particles, log_d1,
                               log_d2, log_b, flips, nflips, masks, wants,
                               phase, nphases, scratch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
