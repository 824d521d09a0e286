// Window kernel of the planar statevector executor.
//
// Replaces the TPU kernels _left_multiply (qbot_tpu/tpu/kernels.py:208) and
// _right_multiply (qbot_tpu/tpu/kernels.py:270) with one kernel:
//
//   out[a, i, b] = sum_j W[i, j] * (Phi F p)[a, j, b]
//
// on one planar float32 state (re plane, then im plane, 2^n floats each)
// viewed as (A, D, B), D = 2^width <= 128.  F negates the amplitudes at a
// few global flat indices; Phi multiplies every amplitude whose flat index m
// has (m & mask) == want by a phase.  The TPU kernels split the product into
// a left- and a right-multiply, with W pre-transposed, for the TPU's lane
// layout; here one kernel serves every (A, D, B), B == 1 and small B too.
//
// What bounds it on an H100: at 26 qubits one pass reads and writes 1 GiB in
// all and does 8*D FLOPs per complex amplitude.  At D = 128 that is 69 GFLOP,
// about 1 ms at the card's 67 TFLOP/s FP32 rate against about 0.3 ms of
// memory traffic, so wide windows are bound by FP32 FMA throughput.  The
// product stays in true FP32 FMAs (no TF32 tensor cores).
//
// Design: the columns c = a*B + b form one GEMM  C = W X  with M = K = D and
// N = A*B.  A block owns BN columns and all D rows, so every state element is
// read once and written once.  The K loop streams BK-row chunks of X and
// BK-column chunks of W through shared memory; each thread keeps a TM x TN
// register tile of complex accumulators.  The chunk loader walks the tile in
// memory order, so loads coalesce for any B.  Flips and phases are applied
// to X as it is loaded, from global flat indices, so they cost no pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 4;  // columns per thread

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

__device__ __forceinline__ void apply_diagonals(
    int64_t m, float& xr, float& xi, const int64_t* __restrict__ flips,
    int nflips, const int64_t* __restrict__ masks,
    const int64_t* __restrict__ wants, const float* __restrict__ phase,
    int nphases) {
  for (int f = 0; f < nflips; ++f) {
    if (flips[f] == m) {
      xr = -xr;
      xi = -xi;
    }
  }
  for (int p = 0; p < nphases; ++p) {
    if ((m & masks[p]) == wants[p]) {
      const float zr = phase[p], zi = phase[nphases + p];
      const float r = xr * zr - xi * zi;
      const float i = xr * zi + xi * zr;
      xr = r;
      xi = i;
    }
  }
}

template <int D, int BN, int TM>
__global__ void __launch_bounds__((D / TM) * (BN / TN))
    window_apply_kernel(const float* __restrict__ psi, float* __restrict__ out,
                        const float* __restrict__ w, int64_t n_amps,
                        int log_b, const int64_t* __restrict__ flips,
                        int nflips, const int64_t* __restrict__ masks,
                        const int64_t* __restrict__ wants,
                        const float* __restrict__ phase, int nphases) {
  constexpr int BK = D < 16 ? D : 16;  // K rows per chunk
  constexpr int NX = BN / TN;          // threads along the columns
  constexpr int NT = (D / TM) * NX;
  constexpr int LOG_BN = ilog2(BN);
  // +1 pads keep the column-strided stores of the loaders conflict-free
  __shared__ float xs[2][BK][BN + 1];
  __shared__ float ws[2][BK][D + 1];

  const int tid = threadIdx.x;
  const int tx = tid % NX;
  const int ty = tid / NX;
  const int64_t cols = n_amps / D;
  const int64_t c0 = int64_t(blockIdx.x) * BN;
  const int64_t B = int64_t(1) << log_b;
  // the tile holds BN / Bt runs of Bt contiguous columns (Bt = min(B, BN))
  const int log_bt = log_b < LOG_BN ? log_b : LOG_BN;
  const int bt_mask = (1 << log_bt) - 1;

  float acc_r[TM][TN], acc_i[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      acc_r[r][t] = 0.f;
      acc_i[r][t] = 0.f;
    }
  }

  for (int j0 = 0; j0 < D; j0 += BK) {
    for (int e = tid; e < BK * BN; e += NT) {
      const int b_off = e & bt_mask;
      const int k = (e >> log_bt) % BK;
      const int a_off = (e >> log_bt) / BK;
      const int col = (a_off << log_bt) + b_off;
      const int64_t c = c0 + col;
      float xr = 0.f, xi = 0.f;
      if (c < cols) {
        const int64_t a = c >> log_b;
        const int64_t b = c & (B - 1);
        const int64_t m = (a * D + j0 + k) * B + b;
        xr = psi[m];
        xi = psi[n_amps + m];
        apply_diagonals(m, xr, xi, flips, nflips, masks, wants, phase,
                        nphases);
      }
      xs[0][k][col] = xr;
      xs[1][k][col] = xi;
    }
    for (int e = tid; e < BK * D; e += NT) {
      const int k = e % BK;
      const int i = e / BK;
      ws[0][k][i] = w[i * D + j0 + k];
      ws[1][k][i] = w[D * D + i * D + j0 + k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float wr[TM], wi[TM], xr[TN], xi[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        wr[r] = ws[0][k][ty * TM + r];
        wi[r] = ws[1][k][ty * TM + r];
      }
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        xr[t] = xs[0][k][tx + t * NX];
        xi[t] = xs[1][k][tx + t * NX];
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          acc_r[r][t] = fmaf(wr[r], xr[t], acc_r[r][t]);
          acc_r[r][t] = fmaf(-wi[r], xi[t], acc_r[r][t]);
          acc_i[r][t] = fmaf(wr[r], xi[t], acc_i[r][t]);
          acc_i[r][t] = fmaf(wi[r], xr[t], acc_i[r][t]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < TN; ++t) {
    const int64_t c = c0 + tx + t * NX;
    if (c >= cols) continue;
    const int64_t a = c >> log_b;
    const int64_t b = c & (B - 1);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int64_t m = (a * D + ty * TM + r) * B + b;
      out[m] = acc_r[r][t];
      out[n_amps + m] = acc_i[r][t];
    }
  }
}

template <int D, int BN, int TM>
void launch(const float* psi, float* out, const float* w, int64_t n_amps,
            int log_b, const int64_t* flips, int nflips, const int64_t* masks,
            const int64_t* wants, const float* phase, int nphases,
            cudaStream_t stream) {
  const int64_t cols = n_amps / D;
  const unsigned grid = static_cast<unsigned>((cols + BN - 1) / BN);
  window_apply_kernel<D, BN, TM><<<grid, (D / TM) * (BN / TN), 0, stream>>>(
      psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase,
      nphases);
}

}  // namespace

// psi, out: (2, n_amps) float32; w: (2, D, D) float32 with D = 2^log_d;
// B = 2^log_b.  Returns the launch's cudaGetLastError().
extern "C" int qbot_window_apply(const float* psi, float* out, const float* w,
                                 int64_t n_amps, int log_d, int log_b,
                                 const int64_t* flips, int nflips,
                                 const int64_t* masks, const int64_t* wants,
                                 const float* phase, int nphases,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_d) {
    case 1: launch<2, 512, 2>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s); break;
    case 2: launch<4, 512, 4>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s); break;
    case 3: launch<8, 512, 8>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s); break;
    case 4: launch<16, 256, 8>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s); break;
    case 5: launch<32, 128, 8>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s); break;
    case 6: launch<64, 64, 8>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s); break;
    case 7: launch<128, 64, 8>(psi, out, w, n_amps, log_b, flips, nflips, masks, wants, phase, nphases, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* qbot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
