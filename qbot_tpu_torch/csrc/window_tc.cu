// The tensor-core window, or the narrow pair (window_tc.cuh), at one D1 and
// precision of the products, given as the defines QBOT_D1 (1: the window;
// 2, 4: the narrow pair) and QBOT_PREC (tc_tile.cuh: Prec): the F32 tile
// (window_tc.cuh) for f32 and f32_mix, the BF16 m16n8k16 kernel
// (window_bf16.cuh) for bf16_3x and bf16.  tpu/kernels.py:build_kernels
// compiles this source once per variant, in parallel with the pair's
// variants.
#include "window_bf16.cuh"

template <int D1, int PREC>
int window_tc_launch(const WindowArgs& args) {
  if constexpr (PREC == F32) {
    return launch_tc_d<D1, PREC>(args);
  } else {
    return launch_bf16_d<D1, PREC>(args);
  }
}

template int window_tc_launch<QBOT_D1, QBOT_PREC>(const WindowArgs&);
