// The tensor-core pair at one D1, orientation and precision of the
// products, given as the defines QBOT_D1, QBOT_MIDDLE (0 or 1) and
// QBOT_PREC (tc_tile.cuh: Prec): the F32 tile (pair_tc.cuh) for f32 and
// f32_mix, the BF16 m16n8k16 kernel (pair_bf16.cuh) for bf16_3x and bf16.
// tpu/kernels.py:build_kernels compiles this source once per variant, all
// in parallel, so that no one nvcc process compiles every instantiation of
// the kernel.
#include "pair_bf16.cuh"

template <int D1, bool MIDDLE, int PREC>
int pair_tc_launch(const PairArgs& args) {
  if constexpr (PREC == F32) {
    return launch_tc_d2<D1, MIDDLE, PREC>(args);
  } else {
    return launch_bf16_pair_d2<D1, MIDDLE, PREC>(args);
  }
}

template int pair_tc_launch<QBOT_D1, bool(QBOT_MIDDLE), QBOT_PREC>(
    const PairArgs&);
