// The tensor-core middle pair at D1 = 16 (pair_tc.cuh), in a source of its
// own so that nvcc compiles it in parallel with the others.
#include "pair_tc.cuh"

template <>
int pair_tc_launch<16, true>(const PairArgs& args) {
  return launch_tc_d2<16, true>(args);
}
