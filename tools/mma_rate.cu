// The rate of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on one
// card: the instruction of the reduced window kernel
// (qbot_tpu_torch/csrc/window_bf16.cuh).  Every warp runs CH independent
// accumulator chains of the instruction; the grid fills every SM with
// BLOCKS blocks of 8 warps.  One chain a warp shows the latency, several the
// throughput.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate \
//       tools/mma_rate.cu && ./mma_rate
//
// prints, per (chains, blocks an SM), the time, the BF16 rate in TFLOP/s
// (4096 FLOPs an instruction) and the cycles an instruction takes on one of
// the SM's four schedulers at the clock cudaDevAttrClockRate reports.
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma16(float* c, const uint4& a,
                                      const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

template <int CH>
__global__ void __launch_bounds__(256) chains(float* out, int iters) {
  const uint4 a = make_uint4(threadIdx.x, 1, 2, 3);
  const uint32_t b[2] = {threadIdx.x * 7u, 5u};
  float c[CH][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int q = 0; q < CH; ++q) mma16(c[q], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < CH; ++q) s += c[q][0] + c[q][1] + c[q][2] + c[q][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CH>
void run(int blocks_per_sm) {
  int sms = 0, khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const int blocks = sms * blocks_per_sm, iters = 20000;
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * blocks * 256);
  chains<CH><<<blocks, 256>>>(out, 100);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  chains<CH><<<blocks, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = double(blocks) * 8 * iters * CH;
  const double cycles = ms * 1e-3 * khz * 1e3;
  printf("chains %2d, blocks an SM %d: %.3f ms, %.1f TFLOP/s, %.2f cycles an "
         "instruction a scheduler (%d MHz)\n",
         CH, blocks_per_sm, ms, mmas * 4096 / (ms * 1e-3) / 1e12,
         cycles / (mmas / (4.0 * sms)), khz / 1000);
  cudaFree(out);
}

int main() {
  run<1>(1);
  run<4>(1);
  run<8>(1);
  run<4>(2);
  run<8>(2);
  run<16>(2);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
