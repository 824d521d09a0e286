// The tensor-core window in one precision of the products, given as the
// define QBOT_PREC (tc_tile.cuh: Prec): the F32 tile (window_tc.cuh) for
// f32 and f32_mix, the BF16 m16n8k16 kernel (window_bf16.cuh) for bf16_3x
// and bf16.  tpu/kernels.py:build_kernels compiles this source once per
// precision, in parallel with the pair's variants.
#include "window_bf16.cuh"

template <int PREC>
int window_tc_launch(const WindowArgs& args) {
  if constexpr (PREC == F32) {
    return launch_tc_d<PREC>(args);
  } else {
    return launch_bf16_d<PREC>(args);
  }
}

template int window_tc_launch<QBOT_PREC>(const WindowArgs&);
