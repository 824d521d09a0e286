// Householder-reflection kernels of the planar statevector executor.
//
// Replace the TPU kernels _reflect_dot (qbot_tpu/tpu/kernels.py:551) and
// _reflect_update (qbot_tpu/tpu/kernels.py:500).  The state is viewed as
// (H, T) per planar component and |v> = A (x) B is a product of a head
// table A (H) and a tail table B (T):
//
//   dot:     D[t] = sum_h conj(A_h) psi[h, t]
//   update:  out = F psi - 2 c (A (x) B), and D[t] of out in the same pass
//
// with F the sign flips at a few global flat indices and c = <v|F psi> read
// from device memory, so a chained loop of updates (Grover) never waits for
// the host.  The caller forms <v|psi> = sum_t conj(B_t) D[t].  D is float64:
// its products and sums are taken in float64.  A Grover state's amplitudes
// are nearly equal, so float32 roundings in <v|psi> are biased, not random:
// at 26 qubits, float32 sums moved the norm by 1% over 512 iterations and
// float32 products with float64 sums still by 1.4e-4.  The FP64 FMAs cost
// nothing visible in a pass that memory bounds.
//
// What bounds them on an H100: memory.  At 26 qubits the dot reads 512 MiB
// and the update reads and writes 512 MiB each, for a few FLOPs per element:
// about 0.16 ms and 0.32 ms at 3.35 TB/s.
//
// Design: the TPU kernel summed D across its sequential grid.  Blocks here
// run in no order, so each block writes the partial D of its chunk of rows
// and a second small kernel sums the partials in a fixed order: no float
// atomics, the same bits on every run.  A block is TT = min(T, 256) threads
// along t (coalesced) times RY = 256 / TT rows; it walks its rows and sums
// its RY row partials in shared memory, in a fixed order.  The second
// kernel gives each lane t a block whose threads sum strided chunks, then
// a fixed-shape tree: one thread per lane summing 1024 chunks in a row took
// 129 us a call at 26 qubits, a fifth of the Grover loop.
//
// The particle axis: one launch of each kernel serves P states of one shape,
// (P, 2, H, T), each with its own c, partials and D.  The row chunks hold
// the grid's y axis, so the particle is blockIdx.z (the reduction's
// blockIdx.y); every kernel advances its pointers to its particle on entry,
// and each particle's sums are those of its own launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PARTICLES = 65535;  // gridDim.y and gridDim.z

template <bool UPDATE>
__global__ void __launch_bounds__(THREADS) reflect_pass(
    const float* __restrict__ psi, float* __restrict__ out,
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const int64_t* __restrict__ flips,
    int nflips, int64_t H, int64_t T, int tt, int64_t rows_per_block,
    double* __restrict__ partial) {
  __shared__ double red[2][THREADS];
  const int tx = threadIdx.x % tt;
  const int ty = threadIdx.x / tt;
  const int ry = blockDim.x / tt;
  const int64_t t = int64_t(blockIdx.x) * tt + tx;
  const int64_t h_lo = int64_t(blockIdx.y) * rows_per_block;
  const int64_t h_hi = h_lo + rows_per_block < H ? h_lo + rows_per_block : H;
  const int64_t n_amps = H * T;
  const int64_t p = blockIdx.z;  // the particle
  psi += p * 2 * n_amps;
  if (UPDATE) {
    out += p * 2 * n_amps;
    c += 2 * p;
  }
  partial += p * 2 * T * gridDim.y;

  double dr = 0.0, di = 0.0;
  if (t < T) {
    float qr = 0.f, qi = 0.f;  // q = c * B_t
    if (UPDATE) {
      const float cr = c[0], ci = c[1];
      const float br = b[t], bi = b[T + t];
      qr = cr * br - ci * bi;
      qi = cr * bi + ci * br;
    }
#pragma unroll 4
    for (int64_t h = h_lo + ty; h < h_hi; h += ry) {
      const int64_t m = h * T + t;
      float pr = psi[m], pi = psi[n_amps + m];
      const float ar = a[h], ai = a[H + h];
      if (UPDATE) {
        for (int f = 0; f < nflips; ++f) {
          if (flips[f] == m) {
            pr = -pr;
            pi = -pi;
          }
        }
        pr = pr - 2.f * (ar * qr - ai * qi);
        pi = pi - 2.f * (ar * qi + ai * qr);
        out[m] = pr;
        out[n_amps + m] = pi;
      }
      dr = fma(double(ar), double(pr), dr);
      dr = fma(double(ai), double(pi), dr);
      di = fma(double(ar), double(pi), di);
      di = fma(-double(ai), double(pr), di);
    }
  }
  red[0][threadIdx.x] = dr;
  red[1][threadIdx.x] = di;
  __syncthreads();
  if (ty == 0 && t < T) {
    for (int y = 1; y < ry; ++y) {
      dr += red[0][y * tt + tx];
      di += red[1][y * tt + tx];
    }
    const int64_t nchunks = gridDim.y;
    partial[t * nchunks + blockIdx.y] = dr;
    partial[(T + t) * nchunks + blockIdx.y] = di;
  }
}

constexpr int REDUCE_THREADS = 128;

// d[c, t] = sum over chunks k of partial[c, t, k]: block t, thread i sums
// chunks i, i + 128, ... in order, then a fixed-shape tree in shared memory
__global__ void __launch_bounds__(REDUCE_THREADS) reduce_partials(
    const double* __restrict__ partial, double* __restrict__ d, int64_t T,
    int nchunks) {
  __shared__ double red[2][REDUCE_THREADS];
  const int64_t t = blockIdx.x;
  partial += int64_t(blockIdx.y) * 2 * T * nchunks;  // the particle's
  d += int64_t(blockIdx.y) * 2 * T;
  double dr = 0.0, di = 0.0;
  for (int k = threadIdx.x; k < nchunks; k += REDUCE_THREADS) {
    dr += partial[t * nchunks + k];
    di += partial[(T + t) * nchunks + k];
  }
  red[0][threadIdx.x] = dr;
  red[1][threadIdx.x] = di;
  __syncthreads();
  for (int s = REDUCE_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      red[0][threadIdx.x] += red[0][threadIdx.x + s];
      red[1][threadIdx.x] += red[1][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    d[t] = red[0][0];
    d[T + t] = red[1][0];
  }
}

template <bool UPDATE>
int run(const float* psi, float* out, const float* a, const float* b,
        const float* c, const int64_t* flips, int nflips, int64_t H,
        int64_t T, int64_t rows_per_block, int nchunks, int particles,
        double* partial, double* d, cudaStream_t stream) {
  if (particles < 1 || particles > MAX_PARTICLES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tt = T < THREADS ? static_cast<int>(T) : THREADS;
  const dim3 grid(static_cast<unsigned>((T + tt - 1) / tt),
                  static_cast<unsigned>(nchunks),
                  static_cast<unsigned>(particles));
  reflect_pass<UPDATE><<<grid, (THREADS / tt) * tt, 0, stream>>>(
      psi, out, a, b, c, flips, nflips, H, T, tt, rows_per_block, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<dim3(static_cast<unsigned>(T),
                         static_cast<unsigned>(particles)),
                    REDUCE_THREADS, 0, stream>>>(partial, d, T, nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// psi: (particles, 2, H, T) float32; a: (2, H); partial: (particles, 2, T,
// nchunks) float64 scratch with nchunks = ceil(H / rows_per_block); d:
// (particles, 2, T) float64.
extern "C" int qbot_reflect_dot(const float* psi, const float* a, int64_t H,
                                int64_t T, int64_t rows_per_block,
                                int nchunks, int particles, double* partial,
                                double* d, void* stream) {
  return run<false>(psi, nullptr, a, nullptr, nullptr, nullptr, 0, H, T,
                    rows_per_block, nchunks, particles, partial, d,
                    static_cast<cudaStream_t>(stream));
}

// As qbot_reflect_dot, plus out: (particles, 2, H, T), b: (2, T), c:
// (particles, 2) and flips.
extern "C" int qbot_reflect_update(const float* psi, float* out,
                                   const float* a, const float* b,
                                   const float* c, const int64_t* flips,
                                   int nflips, int64_t H, int64_t T,
                                   int64_t rows_per_block, int nchunks,
                                   int particles, double* partial, double* d,
                                   void* stream) {
  return run<true>(psi, out, a, b, c, flips, nflips, H, T, rows_per_block,
                   nchunks, particles, partial, d,
                   static_cast<cudaStream_t>(stream));
}
