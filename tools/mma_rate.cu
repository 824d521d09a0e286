// The tensor cores' rate on one card, for the instructions of the window
// kernels: mma.sync.aligned.m16n8k16 BF16 (the reduced window,
// qbot_tpu_torch/csrc/window_bf16.cuh), mma.sync.aligned.m16n8k8 TF32 (the
// F32 tile, csrc/tc_tile.cuh) and wgmma.mma_async m64n128k8 TF32 with both
// operands in shared memory (the f32 window at D = 128,
// csrc/window_wg.cuh, through csrc/wgmma.cuh).
//
// mma.sync: every warp runs CH independent accumulator chains of the
// instruction; the grid fills every SM with BLOCKS blocks of 8 warps.  One
// chain a warp shows the latency, several the throughput.  wgmma: WG
// warpgroups a block, one block an SM, each issuing groups of 8 products on
// one accumulator with one group in flight while the next is issued.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate \
//       tools/mma_rate.cu && ./mma_rate
//
// prints, per mode, the time, the rate in TFLOP/s (4096 FLOPs a BF16
// mma.sync, 2048 a TF32 one, 131072 a wgmma m64n128k8) and, for mma.sync,
// the cycles an instruction takes on one of the SM's four schedulers at the
// clock cudaDevAttrClockRate reports.
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../qbot_tpu_torch/csrc/wgmma.cuh"

__device__ __forceinline__ void mma16(float* c, const uint4& a,
                                      const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma8_tf32(float* c, const uint4& a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b[0]), "r"(b[1]));
}

template <int CH, bool TF32>
__global__ void __launch_bounds__(256) chains(float* out, int iters) {
  const uint4 a = make_uint4(threadIdx.x, 1, 2, 3);
  const uint32_t b[2] = {threadIdx.x * 7u, 5u};
  float c[CH][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      if constexpr (TF32) {
        mma8_tf32(c[q], a, b);
      } else {
        mma16(c[q], a, b);
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < CH; ++q) s += c[q][0] + c[q][1] + c[q][2] + c[q][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// WG warpgroups, each 8 wgmma m64n128k8 TF32 a group on one accumulator
template <int WG>
__global__ void __launch_bounds__(WG * 128, 1) wgmma_chains(float* out,
                                                            int iters) {
  // A (64 x 8, 2 KiB) at byte 0, B (128 x 8, 4 KiB) at byte 4096
  __shared__ __align__(128) uint32_t ops[2048];
  for (int e = threadIdx.x; e < 2048; e += blockDim.x)
    ops[e] = 0x3f800000u + ((e & 7) << 13);
  __syncthreads();
  const uint32_t base = smem_addr(ops);
  const uint64_t da = kmajor_desc(base, 1024, 128);
  const uint64_t db = kmajor_desc(base + 4096, 2048, 128);
  float d[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) d[r] = 0.f;
  for (int i = 0; i < iters; ++i) {
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 8; ++q) wgmma_tf32(d, da, db, 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_acc(d);
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < 64; ++r) s += d[r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

struct Card {
  int sms = 0, khz = 0;
  Card() {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  }
};

// milliseconds of one launch of kernel<<<blocks, threads>>>(out, iters),
// after a warm-up of 100 iterations
template <typename Kernel>
float time_ms(Kernel kernel, int blocks, int threads, float* out, int iters) {
  kernel<<<blocks, threads>>>(out, 100);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  kernel<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

template <int CH, bool TF32>
void run(int blocks_per_sm) {
  const Card card;
  const int blocks = card.sms * blocks_per_sm, iters = 20000;
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * blocks * 256);
  const float ms = time_ms(chains<CH, TF32>, blocks, 256, out, iters);
  const double mmas = double(blocks) * 8 * iters * CH;
  const double cycles = ms * 1e-3 * card.khz * 1e3;
  printf("%s, chains %2d, blocks an SM %d: %.3f ms, %.1f TFLOP/s, %.2f "
         "cycles an instruction a scheduler (%d MHz)\n",
         TF32 ? "mma.sync m16n8k8 tf32" : "mma.sync m16n8k16 bf16", CH,
         blocks_per_sm, ms, mmas * (TF32 ? 2048 : 4096) / (ms * 1e-3) / 1e12,
         cycles / (mmas / (4.0 * card.sms)), card.khz / 1000);
  cudaFree(out);
}

template <int WG>
void run_wgmma() {
  const Card card;
  const int iters = 4000;
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * card.sms * WG * 128);
  const float ms =
      time_ms(wgmma_chains<WG>, card.sms, WG * 128, out, iters);
  const double products = double(card.sms) * WG * iters * 8;
  printf("wgmma m64n128k8 tf32 (shared A, B), warpgroups an SM %d: %.3f ms, "
         "%.1f TFLOP/s (%d MHz)\n",
         WG, ms, products * 131072 / (ms * 1e-3) / 1e12, card.khz / 1000);
  cudaFree(out);
}

int main() {
  run<1, false>(1);
  run<4, false>(1);
  run<8, false>(1);
  run<4, false>(2);
  run<8, false>(2);
  run<16, false>(2);
  run<1, true>(1);
  run<4, true>(1);
  run<8, true>(1);
  run<8, true>(2);
  run<16, true>(2);
  run_wgmma<1>();
  run_wgmma<2>();
  run_wgmma<3>();
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
