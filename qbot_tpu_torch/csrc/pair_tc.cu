// The tensor-core pair (pair_tc.cuh) at one D1, orientation and precision
// of the products, given as the defines QBOT_D1, QBOT_MIDDLE (0 or 1) and
// QBOT_PREC (tc_tile.cuh: Prec).  tpu/kernels.py:build_kernels compiles
// this source once per variant, all in parallel, so that no one nvcc
// process compiles every instantiation of the kernel.
#include "pair_tc.cuh"

template <int D1, bool MIDDLE, int PREC>
int pair_tc_launch(const PairArgs& args) {
  return launch_tc_d2<D1, MIDDLE, PREC>(args);
}

template int pair_tc_launch<QBOT_D1, bool(QBOT_MIDDLE), QBOT_PREC>(
    const PairArgs&);
