// The tensor-core window (window_tc.cuh) in one precision of the products,
// given as the define QBOT_PREC (tc_tile.cuh: Prec).
// tpu/kernels.py:build_kernels compiles this source once per precision, in
// parallel with the pair's variants.
#include "window_tc.cuh"

template <int PREC>
int window_tc_launch(const WindowArgs& args) {
  return launch_tc_d<PREC>(args);
}

template int window_tc_launch<QBOT_PREC>(const WindowArgs&);
