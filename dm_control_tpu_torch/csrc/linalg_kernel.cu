// Batched small-SPD Cholesky factor / solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of dm_control_tpu/ops/linalg_kernel.py:
//   dmc_cholesky    <- cholesky_batched   (body _factor)
//   dmc_chol_solve  <- chol_solve_batched (_factor + _solve)
//   dmc_cho_solve   <- cho_solve_batched  (_solve)
// All three are one kernel, k1_kernel<MODE>: factor, factor and solve, or
// solve with a given factor.
//
// What bounds them on an H100: at walker's (4096, 9, 9) the factor moves
// 2.6 MB (A in, L out) and does ~1 MFLOP, so its floor is bytes, under a
// microsecond at 3.35 TB/s; the solves move half that.  What bounds a
// launch in practice is latency: the factor of one matrix is a chain of
// n dependent columns (a square root and a reciprocal on each), and the
// substitutions chains of n dependent steps, while a whole launch is only
// a few microseconds of work spread over the card.
//
// Design:
//   - Batch-first in and out, the port's own layout: A or L (B, n, n), b
//     and x (B, n).  A block takes `envs` consecutive environments, whose
//     matrices are one contiguous span of device memory; the whole block
//     copies the span into shared memory with 16-byte loads from the first
//     16-byte boundary on, four in flight per thread, and the arithmetic
//     runs there.  The solves write only x (B, n), as one span again; the
//     fused solve's L never leaves the SM.  dmc_cholesky writes L (B, n, n)
//     the same way, with zeros above the diagonal.
//   - A group of G lanes (1, 2, 4, ... 32, chosen by n on the host:
//     ops/linalg_kernel.py launch_config) works on one environment, 32 / G
//     environments to a warp.  Lane g owns rows i = g mod G.  The factor is
//     left-looking: for column j each lane sums a_ij - sum_k<j l_ik l_jk
//     over its rows i >= j, in k order as the TPU kernel's right-looking
//     updates subtract them; the pivot's owner hands a_jj to its group by
//     shuffle, every lane takes d = sqrt(max(a_jj, 1e-30)) and one IEEE
//     reciprocal 1/d and scales its rows; one __syncwarp per column.  The
//     substitutions are the TPU kernel's column sweeps, each solved entry
//     passed to the group by shuffle, multiplied by the stored reciprocal
//     of its pivot.  IEEE sqrtf and one IEEE reciprocal per pivot: L and
//     x are within ~1.5 ulp per step of the TPU kernel's divisions.
//   - dmc_cho_solve forms the reciprocals 1.0f / l_jj of the given factor
//     (each row's owner, once per pivot) and runs the same substitution:
//     1 / l_jj is bit for bit the r that the factor computed for l_jj = d,
//     so cho_solve(cholesky(A), b) gives chol_solve(A, b)'s bits.
//   - One environment's matrix has row stride ld = n | 1 (odd) and the
//     environments of a warp start G * ld words apart modulo 32, so the 32
//     lanes of a warp reading one column of their own rows hit 32 banks.
//   - Only the lower triangle of A or L is read by the arithmetic (the
//     upper one is copied in with its rows and never used).  Each
//     environment's result depends on its own inputs alone, in a fixed
//     order: a launch is deterministic and independent of the batch around
//     an environment.
//
// Everything is float32, as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 96;
constexpr int SMEM_LIMIT = 232448;      // dynamic shared bytes of a block
constexpr unsigned FULL = 0xffffffffu;
constexpr float kTiny = 1e-30f;
constexpr int kLoads = 4;               // 16-byte loads in flight per thread

// ---------------------------------------------------------------------------
// Shared-memory carve: per environment its matrix (n rows of stride ld),
// then y (n) and the pivots' reciprocals (n), padded so that environment q
// of a warp starts q * G * ld words (mod 32) after environment 0.
// ---------------------------------------------------------------------------

__host__ __device__ inline int row_stride(int n) { return n | 1; }

__host__ __device__ inline int env_words(int n, int group) {
  const int ld = row_stride(n);
  const int used = n * ld + 2 * n;
  return used + ((group * ld - used) % 32 + 32) % 32;
}

// A span of consecutive environments' rows of n floats in device memory
// (`rows` per environment: n for their matrices, 1 for their vectors) and
// where they go in shared memory: row i of environment e at
// e * words + base + i * ld.  Element k of the span is found with two
// divisions (`locate`); the elements after it by stepping (`next`).
struct Span {
  int n, rows, ld, words, base;
  struct At {
    int e, i, j;
  };
  __device__ At locate(int k) const {
    const int e = k / (rows * n), r = k - e * rows * n, i = r / n;
    return {e, i, r - i * n};
  }
  __device__ void next(At& p) const {
    if (++p.j == n) {
      p.j = 0;
      if (++p.i == rows) {
        p.i = 0;
        ++p.e;
      }
    }
  }
  __device__ int word(const At& p) const {
    return p.e * words + base + p.i * ld + p.j;
  }
};

// The whole block copies `count` contiguous floats of device memory into
// shared memory as `span` places them: 16-byte loads from the first
// 16-byte boundary on, kLoads of them issued before the first is stored
// (so a thread waits out one memory latency per kLoads, not per load),
// single floats before and after.
__device__ void load_span(float* smem, const float* src, int count,
                          const Span& span) {
  int head = (int)(((16u - ((uintptr_t)src & 15u)) & 15u) >> 2);
  head = head < count ? head : count;
  const int n4 = (count - head) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int k = threadIdx.x; k < head; k += blockDim.x)
    smem[span.word(span.locate(k))] = src[k];
  for (int q0 = threadIdx.x; q0 < n4; q0 += kLoads * blockDim.x) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q < n4) v[u] = s4[q];
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q < n4) {
        Span::At p = span.locate(head + 4 * q);
        smem[span.word(p)] = v[u].x;
        span.next(p);
        smem[span.word(p)] = v[u].y;
        span.next(p);
        smem[span.word(p)] = v[u].z;
        span.next(p);
        smem[span.word(p)] = v[u].w;
      }
    }
  }
  for (int k = head + 4 * n4 + threadIdx.x; k < count; k += blockDim.x)
    smem[span.word(span.locate(k))] = src[k];
}

// The whole block writes `count` contiguous floats of device memory from
// shared memory as `span` places them, with 16-byte stores from the first
// 16-byte boundary on; with `lower`, 0 for the elements above a matrix's
// diagonal (j > i).
__device__ void store_span(float* dst, int count, const float* smem,
                           const Span& span, bool lower) {
  auto value = [&](const Span::At& p) {
    return lower && p.j > p.i ? 0.0f : smem[span.word(p)];
  };
  int head = (int)(((16u - ((uintptr_t)dst & 15u)) & 15u) >> 2);
  head = head < count ? head : count;
  const int n4 = (count - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int k = threadIdx.x; k < head; k += blockDim.x)
    dst[k] = value(span.locate(k));
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    Span::At p = span.locate(head + 4 * q);
    float4 v;
    v.x = value(p);
    span.next(p);
    v.y = value(p);
    span.next(p);
    v.z = value(p);
    span.next(p);
    v.w = value(p);
    d4[q] = v;
  }
  for (int k = head + 4 * n4 + threadIdx.x; k < count; k += blockDim.x)
    dst[k] = value(span.locate(k));
}

// v from lane `src` of this lane's group of G (G uniform over the warp;
// every lane of the warp takes part).
__device__ __forceinline__ float group_bcast(float v, int src, int G) {
  return G > 1 ? __shfl_sync(FULL, v, src, G) : v;
}

// Left-looking lower Cholesky of the matrix at m (stride ld) in place, by
// the G lanes of a group, lane g owning rows i = g mod G; inv[j] = 1 / l_jj
// (written by the owner of row j).  Reads only the lower triangle.
__device__ void factor(float* m, float* inv, int n, int ld, int g, int G) {
  for (int j = 0; j < n; ++j) {
    const float* rj = m + j * ld;
    const int owner = j & (G - 1);
    const int i0 = j + ((g - j) & (G - 1));   // this lane's first row >= j
    float ajj = 0.0f;
    for (int i = i0; i < n; i += G) {
      float* ri = m + i * ld;
      float s = ri[j];
#pragma unroll 4
      for (int k = 0; k < j; ++k) s -= ri[k] * rj[k];
      ri[j] = s;
      if (i == j) ajj = s;
    }
    const float d = sqrtf(fmaxf(group_bcast(ajj, owner, G), kTiny));
    const float r = 1.0f / d;
    for (int i = i0; i < n; i += G)
      m[i * ld + j] = i == j ? d : m[i * ld + j] * r;
    if (g == owner) inv[j] = r;
    __syncwarp();
  }
}

// L L' x = y in place on y (the TPU kernel's column sweeps), given the
// factor and reciprocals of `factor`; y[i] belongs to row i's lane.
__device__ void substitute(const float* m, float* y, const float* inv, int n,
                           int ld, int g, int G) {
  for (int j = 0; j < n; ++j) {              // forward: L z = y
    const int owner = j & (G - 1);
    float zj = 0.0f;
    if (g == owner) y[j] = zj = y[j] * inv[j];
    zj = group_bcast(zj, owner, G);
    for (int i = j + 1 + ((g - j - 1) & (G - 1)); i < n; i += G)
      y[i] -= m[i * ld + j] * zj;
  }
  for (int j = n - 1; j >= 0; --j) {         // backward: L' x = z
    const int owner = j & (G - 1);
    float xj = 0.0f;
    if (g == owner) y[j] = xj = y[j] * inv[j];
    xj = group_bcast(xj, owner, G);
    const float* rj = m + j * ld;
    for (int i = g; i < j; i += G) y[i] -= rj[i] * xj;
  }
}

// What a launch of k1_kernel computes.
enum Mode : int {
  kFactor = 0,        // L of A into out (B, n, n)           dmc_cholesky
  kFactorSolve = 1,   // A^-1 rhs into out (B, n)            dmc_chol_solve
  kSolve = 2,         // (L L')^-1 rhs, L given in a, into out (B, n)
};                    //                                     dmc_cho_solve

// One block: `envs` environments from b0 = blockIdx.x * envs, G =
// blockDim.x / envs lanes each.
template <int MODE>
__global__ void k1_kernel(const float* a, const float* rhs, float* out, int n,
                          long long batch, int envs) {
  extern __shared__ float smem[];
  constexpr bool kRhs = MODE != kFactor;
  const int G = blockDim.x / envs;
  const int ld = row_stride(n), words = env_words(n, G);
  const Span mats{n, n, ld, words, 0}, vecs{n, 1, 0, words, n * ld};
  const long long b0 = (long long)blockIdx.x * envs;
  const int count = batch - b0 < envs ? (int)(batch - b0) : envs;
  load_span(smem, a + b0 * n * n, count * n * n, mats);
  if (kRhs) load_span(smem, rhs + b0 * n, count * n, vecs);
  __syncthreads();

  // environments past the batch run on whatever their words hold and
  // store nothing, so that every lane of a warp takes part in its shuffles
  const int g = threadIdx.x & (G - 1);
  float* m = smem + (threadIdx.x / G) * words;
  float* y = m + n * ld;
  float* inv = y + n;
  if (MODE == kSolve) {
    // the reciprocals `factor` leaves, of the given pivots; each row's
    // owner forms and reads its own
    for (int i = g; i < n; i += G) inv[i] = 1.0f / m[i * ld + i];
  } else {
    factor(m, inv, n, ld, g, G);
  }
  if (kRhs) substitute(m, y, inv, n, ld, g, G);
  __syncthreads();

  if (kRhs)
    store_span(out + b0 * n, count * n, smem, vecs, false);
  else
    store_span(out + b0 * n * n, count * n * n, smem, mats, true);
}

}  // namespace

// The checks of ops/linalg_kernel.py launch_config, again: a launch the
// carve does not cover is refused before it is made.
template <int MODE>
static int launch_k1(const float* a, const float* rhs, float* out, int n,
                     int batch, int envs, int threads, int smem_bytes,
                     void* stream) {
  if (n < 1 || n > MAX_N || batch < 1 || envs < 1 || (envs & (envs - 1)) ||
      threads < 32 || threads > 1024 || threads % 32 || threads % envs)
    return (int)cudaErrorInvalidValue;
  const int group = threads / envs;
  if (group > 32 || (group & (group - 1)) ||
      4LL * envs * env_words(n, group) != smem_bytes ||
      smem_bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k1_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((batch + envs - 1) / envs);
  k1_kernel<MODE><<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(
      a, rhs, out, n, batch, envs);
  return (int)cudaGetLastError();
}

extern "C" int dmc_cholesky(const float* a, float* l, int n, int batch,
                            int envs, int threads, int smem_bytes,
                            void* stream) {
  return launch_k1<kFactor>(a, nullptr, l, n, batch, envs, threads,
                            smem_bytes, stream);
}

extern "C" int dmc_chol_solve(const float* a, const float* b, float* x, int n,
                              int batch, int envs, int threads, int smem_bytes,
                              void* stream) {
  return launch_k1<kFactorSolve>(a, b, x, n, batch, envs, threads, smem_bytes,
                                 stream);
}

extern "C" int dmc_cho_solve(const float* l, const float* b, float* x, int n,
                             int batch, int envs, int threads, int smem_bytes,
                             void* stream) {
  return launch_k1<kSolve>(l, b, x, n, batch, envs, threads, smem_bytes,
                           stream);
}
