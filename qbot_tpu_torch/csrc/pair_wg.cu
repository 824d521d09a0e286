// The f32 trailing pair at D2 = 128 with D1 = 64 and 128 on the warpgroup
// products (pair_wg.cuh), compiled once, beside the variants of
// pair_tc.cu; pair_apply.cu's dispatcher calls pair_wg_launch.
#include "pair_wg.cuh"

int pair_wg_launch(int log_d1, const PairArgs& args) {
  switch (log_d1) {
    case 6: return launch_pair_wg<64>(args);
    case 7: return launch_pair_wg<128>(args);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the floats of the scratch qbot_pair_apply takes at D1 = 2^log_d1 (its
// warpgroup pair: D2 = 128, B = 1, f32), 0 at any other D1
extern "C" int qbot_pair_scratch_floats(int log_d1) {
  switch (log_d1) {
    case 6: return pwg::scratch_floats<64>();
    case 7: return pwg::scratch_floats<128>();
    default: return 0;
  }
}
