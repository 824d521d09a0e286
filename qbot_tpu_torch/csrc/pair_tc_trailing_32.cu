// The tensor-core trailing pair at D1 = 32 (pair_tc.cuh), in a source of its
// own so that nvcc compiles it in parallel with the others.
#include "pair_tc.cuh"

template <>
int pair_tc_launch<32, false>(const PairArgs& args) {
  return launch_tc_d2<32, false>(args);
}
