// Batched small-SPD Cholesky factor / solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of dm_control_tpu/ops/linalg_kernel.py:
//   dmc_cholesky    <- cholesky_batched   (body _factor)
//   dmc_chol_solve  <- chol_solve_batched (_factor + _solve)
//   dmc_cho_solve   <- cho_solve_batched  (_solve)
//
// Layout: batch-last, as the TPU kernel kept it: A/L are (n, n, B) and
// vectors (n, B), so element (i, j) of environment b lives at
// (i * n + j) * B + b.  One thread owns one environment and runs the
// column-loop factor (pivot sqrt(max(a_jj, 1e-30))) and the forward/back
// substitutions in place in its output; neighbouring threads touch
// neighbouring addresses, so every load and store is coalesced.
//
// What bounds it on an H100: at walker's (4096, 9, 9) the factor moves
// 2.6 MB (A in, L out) and does ~1 MFLOP, so its floor is bytes, under a
// microsecond at 3.35 TB/s.  What bounds THIS design is latency: one thread
// per environment gives 4096 threads = 32 blocks of 128 on 132 SMs, each
// thread walking n^3/6 dependent global read-modify-writes (served from
// L1/L2).  The design keeps the data in the TPU kernel's layout so the
// wrapper is a transpose and a launch; a later design spreads an
// environment's matrix over a warp and keeps it in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ long long at(int i, int j, int n, long long B,
                                        long long b) {
  return ((long long)i * n + j) * B + b;
}

// Lower Cholesky in place on the lower triangle of l (upper left as is).
__device__ void factor_inplace(float* l, int n, long long B, long long b) {
  for (int j = 0; j < n; ++j) {
    const float pivot = sqrtf(fmaxf(l[at(j, j, n, B, b)], kTiny));
    l[at(j, j, n, B, b)] = pivot;
    for (int i = j + 1; i < n; ++i) l[at(i, j, n, B, b)] /= pivot;
    for (int i = j + 1; i < n; ++i) {
      const float lij = l[at(i, j, n, B, b)];
      for (int k = j + 1; k <= i; ++k)
        l[at(i, k, n, B, b)] -= lij * l[at(k, j, n, B, b)];
    }
  }
}

// L L^T x = y in place on x (n, B), given lower L.
__device__ void solve_inplace(const float* l, float* x, int n, long long B,
                              long long b) {
  for (int j = 0; j < n; ++j) {           // forward: L y = b
    const float yj = x[(long long)j * B + b] / l[at(j, j, n, B, b)];
    for (int i = j + 1; i < n; ++i) x[(long long)i * B + b] -= l[at(i, j, n, B, b)] * yj;
    x[(long long)j * B + b] = yj;
  }
  for (int j = n - 1; j >= 0; --j) {      // backward: L^T x = y
    const float xj = x[(long long)j * B + b] / l[at(j, j, n, B, b)];
    for (int i = 0; i < j; ++i) x[(long long)i * B + b] -= l[at(j, i, n, B, b)] * xj;
    x[(long long)j * B + b] = xj;
  }
}

// Lower triangle of a into l, zeros above the diagonal.
__device__ void copy_lower(const float* a, float* l, int n, long long B,
                           long long b) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      l[at(i, j, n, B, b)] = j <= i ? a[at(i, j, n, B, b)] : 0.0f;
}

__global__ void cholesky_kernel(const float* a, float* l, int n, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  copy_lower(a, l, n, B, b);
  factor_inplace(l, n, B, b);
}

__global__ void chol_solve_kernel(const float* a, const float* rhs, float* l,
                                  float* x, int n, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  copy_lower(a, l, n, B, b);
  factor_inplace(l, n, B, b);
  for (int i = 0; i < n; ++i) x[(long long)i * B + b] = rhs[(long long)i * B + b];
  solve_inplace(l, x, n, B, b);
}

__global__ void cho_solve_kernel(const float* l, const float* rhs, float* x,
                                 int n, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  for (int i = 0; i < n; ++i) x[(long long)i * B + b] = rhs[(long long)i * B + b];
  solve_inplace(l, x, n, B, b);
}

inline unsigned blocks_for(int batch) {
  return (unsigned)((batch + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int dmc_cholesky(const float* a, float* l, int n, int batch,
                            void* stream) {
  cholesky_kernel<<<blocks_for(batch), kThreads, 0, (cudaStream_t)stream>>>(
      a, l, n, batch);
  return (int)cudaGetLastError();
}

extern "C" int dmc_chol_solve(const float* a, const float* rhs, float* l,
                              float* x, int n, int batch, void* stream) {
  chol_solve_kernel<<<blocks_for(batch), kThreads, 0, (cudaStream_t)stream>>>(
      a, rhs, l, x, n, batch);
  return (int)cudaGetLastError();
}

extern "C" int dmc_cho_solve(const float* l, const float* rhs, float* x, int n,
                             int batch, void* stream) {
  cho_solve_kernel<<<blocks_for(batch), kThreads, 0, (cudaStream_t)stream>>>(
      l, rhs, x, n, batch);
  return (int)cudaGetLastError();
}
