// The whole batched projected-Newton constraint solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of dm_control_tpu/ops/newton_kernel.py
// (newton_solve_batched -> _build -> _make_kernel), elliptic cones
// included.  Per environment it minimises
//   0.5 (x - a)' M (x - a) + sum_i c_i((J x - aref)_i) + sum_c c_c(jar_c)
// in the TPU kernel's order: warmstart choice by cost, row forces/weights
// (diag_terms), the elliptic contacts' zone terms (ell_terms), H = M +
// J' W J + sum_c J_c' W_c J_c, Cholesky with +1e-12 on the pivot, a
// 12-step guarded Newton line search, accept-if-improved, and the per-env
// exit on scaled improvement or gradient < tol.
//
// One kernel for both layouts: wherever the TPU kernel calls ell_terms
// (the warmstart costs, the gradient, the Hessian, the line search's
// phi' / phi'' and the final forces) a loop runs over the ncg elliptic
// contacts, which is empty where the layout has none (walker: K2); with
// them it is K2-ell.  A contact is condim 3 (rows n, t1, t2, row scales
// s): y = jar * s, n = y_0, t = |y_1..2|;
// top zone (n >= mu t) nothing, bottom zone (mu n <= -t) force -D y and
// block D I, middle zone force fn (1, -mu u) with fn = D (mu t - n) /
// (1 + mu^2), u = y_1..2 / t, and block D/(1+mu^2) v v' + mu fn / t
// (P - e e') with v = (1, -mu u), e = (0, u), P = diag(0, 1, 1); all in
// raw residuals through s.  The TPU kernel's diag + p p' - m m' form is
// the same matrix.  Rows of type ELLIPTIC give nothing in row_terms, so
// no row counts twice.
//
// Cones of condim 4 and 6 (the TPU kernel's _Static flattens every condim
// into one list of contacts, ell_terms sums their friction rows): the
// kernel is also a template on C, the largest condim of the layout's
// elliptic contacts.  C = 3 is the code above.  C = 6 takes contacts of 3,
// 4 and 6 rows in one layout, each with its own row count k: n = y_0, t =
// |y_1..k-1|, and the same zones, forces and k x k blocks with u = y_1..k-1
// / t and P = diag(0, 1, .., 1); every per-contact table and block is
// carved C or C^2 words wide, and a row past a contact's k is never read.
//
// Layout: batch-first, the port's own: J (B, nefc, nv), M (B, nv, nv),
// row vectors (B, nefc), dof vectors (B, nv); outputs x (B, nv), f
// (B, nefc), iterations (B,).  The contacts' rows (ncg, C, padded past
// each contact's k with its normal row), row counts (ncg), mu (ncg) and
// the row scales (nefc) are the same for every environment.
//
// What bounds it on an H100: the inputs are read once, ~2.5 KB per walker
// environment (nv 9, nefc 62): 10 MB at B = 4096, 0.0048 ms of HBM time.
// The arithmetic, ~5 * 10^4 FLOP per Newton iteration per environment, is
// ~0.01 ms of the card's float32 rate for a few iterations.  What sets the
// time instead is latency: each environment's Newton loop is serial
// (iterations, 12 line-search steps each, a Cholesky, two substitutions),
// a launch lasts as long as its slowest environment's loop, and that
// environment's iteration count is itself decided by float32 rounding in
// the line search.  On the slowest warps every step of the loop waits on
// a shuffle sum, a shared-memory load or an IEEE division or square root
// (tools/newton_kernel_cycles.py splits the cycles by phase).
//
// Design: one warp per environment, W warps (environments) per block.
//   - A warp copies its environment's contiguous J, M and row blocks from
//     device memory into shared memory once (16-byte loads where aligned)
//     and works there: J (row stride padded to an odd number of words, so
//     that lanes reading J[e][v] for consecutive e hit distinct banks), M,
//     H/L, the residuals jar/djar, the row weights D/frictionloss/active,
//     the row forces and quadratic-zone weights, the contact blocks, and
//     x/a/delta.  The per-layout tables (row types, the contact row table,
//     mu, the row scales) are loaded once per block.  Nothing per
//     environment goes to local or device memory inside the loop.
//   - Only live rows and contacts take part (see Env): an environment
//     that touches the floor in 3 of finger's 34 candidate contacts
//     evaluates 3 contacts, not 34, in each of the ~15 sweeps of a Newton
//     iteration.  Live row i and live contact k are items i and nr + k,
//     item j on lane j mod 32; dof v on lane v mod 32.
//   - Costs, phi' and phi'', the gradient norm and the dot products are
//     xor-shuffle sums; J' f is summed by each dof's lane over the live
//     rows in list order.  No atomics: a launch is deterministic, and an
//     environment's result does not depend on the batch around it.  Every
//     lane of an xor butterfly ends with the same bits, so each branch on
//     a reduced value (warmstart, lo/hi, accept, exit) is taken by the
//     whole warp.
//   - H's lower triangle is spread over the lanes, each summing entries k
//     and k + 32 over the weighted live rows and contacts; the Cholesky
//     runs column by column with lane i owning row i, and the two
//     substitutions pass each solved entry by shuffle, multiplying by the
//     pivots' reciprocals.
//
// Two shape families, one source: the kernel is a template on S, the dofs
// each lane owns.
//   - S = 1, nv <= 32: dof v on lane v, J in shared memory, as above.
//   - S = 2, 32 < nv <= MAX_NV = 64 (the TPU kernel's own limit): lane l
//     owns dofs l and l + 32 (their rows of M, H and L, their entries of
//     x, a, delta and the gradient), and J stays in device memory.  At
//     humanoid_CMU's layout (nefc 880, nv 62) J alone is 218,240 bytes,
//     over a block's 232,448 with M and H beside it; without J an
//     environment needs 60,400 bytes, so three share an SM.  J is read
//     where it is used, with live rows only: the gradient's J' f reads each
//     live row whole across the lanes (coalesced), H's build reads each
//     live row's two entries per lane, and the residuals J x read a row per
//     lane.  Beside three environments' 188 KB of shared memory an
//     environment's live rows (~170 at humanoid_CMU's impact states, 42 KB)
//     do not stay in L1, so each of H's build sweeps (31 per iteration at
//     nv 62) reads them from L2: that sets this family's time, ~39x its
//     operations bound.  Two dofs per lane keep every reduction, branch and
//     shuffle of the one-warp design, so the nv <= 32 family's code and
//     bits are unchanged; two warps per environment would need block-wide
//     barriers and shared partial sums in every sweep.
// Everything is float32, as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_NV = 64;             // two dofs per lane past 32
constexpr int MAX_WARPS = 4;            // environments per block, at most
constexpr int SMEM_LIMIT = 232448;      // dynamic shared bytes of a block
constexpr int EQUALITY = 0;
constexpr int FRICTION = 1;
constexpr int ONESIDED = 2;
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory carve, in 4-byte words (the wrapper's launch_config
// mirrors these three functions).  J is in it only where nv <= 32; C is
// the layout's largest condim (3 or 6).
__host__ __device__ inline int row_stride(int nv) { return nv | 1; }
__host__ __device__ inline int block_words(int nefc, int ncg, int C) {
  // types, scales; cone rows, mu and, where C > 3, each cone's row count
  return 2 * nefc + (C + 1) * ncg + (C > 3 ? ncg : 0);
}
__host__ __device__ inline int warp_words(int nefc, int nv, int ncg, int C) {
  const int ld = row_stride(nv);
  // J, M and H; jar, djar, D, fl, active, f, w and the live-row list;
  // cone blocks, flags and the live-cone list; x, a, delta and a scratch
  // vector
  return (nv <= 32 ? nefc * ld : 0) + 2 * nv * ld + 8 * nefc
         + (C * C + 2) * ncg + 4 * nv;
}

// Force, quadratic-zone weight and cost of one row (solver._diag_terms).
__device__ __forceinline__ void row_terms(int type, float jar, float d,
                                          float fl, float act, float* f,
                                          float* w, float* c) {
  float ff = 0.0f, ww = 0.0f, cc = 0.0f;
  const float c_quad = 0.5f * d * jar * jar;
  if (type == EQUALITY) {
    ff = -d * jar;
    ww = d;
    cc = c_quad;
  } else if (type == FRICTION) {
    const bool quad = d * fabsf(jar) <= fl;
    ff = fminf(fmaxf(-d * jar, -fl), fl);
    ww = quad ? d : 0.0f;
    cc = quad ? c_quad : fl * fabsf(jar) - 0.5f * fl * fl / fmaxf(d, 1e-14f);
  } else if (type == ONESIDED) {
    if (jar < 0.0f) {
      ff = -d * jar;
      ww = d;
      cc = c_quad;
    }
  }
  *f = ff * act;
  *w = ww * act;
  *c = cc * act;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Two sums at once, their shuffles interleaved.
__device__ __forceinline__ void warp_sum2(float* a, float* b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float pa = __shfl_xor_sync(FULL, *a, o);
    const float pb = __shfl_xor_sync(FULL, *b, o);
    *a += pa;
    *b += pb;
  }
}

struct Problem {
  const float* J;
  const float* M;
  const float* aref;
  const float* D;
  const float* fl;
  const float* active;
  const float* a;
  const float* warm;
  const int* types;
  const int* ell_rows;   // (ncg, C): normal, then friction rows per contact
  const int* ell_k;      // (ncg,) rows of each contact (read where C > 3)
  const float* ell_mu;   // (ncg,)
  const float* s_row;    // (nefc,) elliptic row scales
  float* x_out;
  float* f_out;
  int* iters_out;
  int nefc;
  int nv;
  int ncg;
  long long B;
};

// One environment's problem in shared memory, seen from one lane.
//
// Only the live rows and contacts take part: the active rows that are not
// elliptic (rl, nr of them) and the active elliptic contacts (cl, nc); an
// inactive one adds nothing to any cost, force, gradient or Hessian.  The
// lists are built once per environment, in row order.  They are items
// 0..nr-1 (rows) and nr..nr+nc-1 (contacts), item i on lane i mod 32; the
// lane that owns a contact also owns its rows' residuals.  C is the
// layout's largest condim.
template <int C>
struct Env {
  const int* types;      // per block
  const int* rows;       // (ncg, C)
  const int* kr;         // (ncg,) rows of each contact (C > 3)
  const float* mu;
  const float* scale;
  const float* J;        // per warp (S = 1), or in device memory (S = 2)
  float* M;
  float* H;
  float* jar;
  float* djar;
  float* D;
  float* fl;
  float* act;
  float* f;
  float* w;
  int* rl;               // live rows
  float* W;              // (nc, C, C) blocks of the live contacts at jar
  float* on;             // (nc,) 1 where the live contact adds a block
  int* cl;               // live contacts
  float* x;
  float* a;
  float* d;
  float* t;
  int nefc;
  int nv;
  int ncg;
  int ld;                // row stride of M and H
  int ldj;               // row stride of J
  int lane;
  int nr;
  int nc;
  int cone0;             // this lane's first live contact (list position)

  __device__ float j(int e, int v) const { return J[e * ldj + v]; }
  __device__ void terms(int e, float jar_e, float* f_, float* w_,
                        float* c_) const {
    row_terms(types[e], jar_e, D[e], fl[e], act[e], f_, w_, c_);
  }
  // residuals jar + alpha * djar of contact c's C rows (past its own row
  // count, its normal row's: padding, never used)
  __device__ void cone_res(int c, float alpha, float jr[C]) const {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int k = rows[C * c + i];
      jr[i] = alpha == 0.0f ? jar[k] : jar[k] + alpha * djar[k];
    }
  }
  // fn(e) for every row whose residuals this lane owns
  template <typename Fn>
  __device__ void own_rows(Fn fn) const {
    for (int i = lane; i < nr; i += 32) fn(rl[i]);
    for (int k = cone0; k < nc; k += 32) {
      const int* r = rows + C * cl[k];
      if constexpr (C == 3) {
        fn(r[0]);
        fn(r[1]);
        fn(r[2]);
      } else {
        const int n = kr[cl[k]];
        for (int i = 0; i < n; ++i) fn(r[i]);
      }
    }
  }
};

// Append the indices i < n with pred(i) to list, in order, across the warp
// (ballot and prefix count); returns their number.
template <typename Pred>
__device__ __forceinline__ int warp_compact(int n, int lane, int* list,
                                            Pred pred) {
  int count = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const bool keep = i < n && pred(i);
    const unsigned mask = __ballot_sync(FULL, keep);
    if (keep) list[count + __popc(mask & ((1u << lane) - 1u))] = i;
    count += __popc(mask);
  }
  return count;
}

// Copy n contiguous floats of device memory into shared memory as rows of
// ncols with stride ld, across the warp: 16-byte loads from the first
// 16-byte boundary on, single floats before and after it.
__device__ __forceinline__ void warp_load(float* dst, const float* src, int n,
                                          int ncols, int ld, int lane) {
  if (ncols == ld) ncols = ld = n;       // no padding: a straight copy
  int head = (int)(((16u - ((uintptr_t)src & 15u)) & 15u) >> 2);
  head = head < n ? head : n;
  for (int k = lane; k < head; k += 32)
    dst[(k / ncols) * ld + k % ncols] = src[k];
  const int n4 = (n - head) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int q = lane; q < n4; q += 32) {
    const float4 v = s4[q];
    const int k = head + 4 * q;
    dst[(k / ncols) * ld + k % ncols] = v.x;
    dst[((k + 1) / ncols) * ld + (k + 1) % ncols] = v.y;
    dst[((k + 2) / ncols) * ld + (k + 2) % ncols] = v.z;
    dst[((k + 3) / ncols) * ld + (k + 3) % ncols] = v.w;
  }
  for (int k = head + 4 * n4 + lane; k < n; k += 32)
    dst[(k / ncols) * ld + k % ncols] = src[k];
}

// One elliptic contact's constants: its rows' scales (0 past its row
// count), the normal row's D and active flag, mu and, where C > 3, its
// row count n.
template <int C>
struct Cone {
  float s[C];
  float dn;
  float ac;
  float mu;
  int n;
};

template <int C>
__device__ __forceinline__ Cone<C> cone_of(const Env<C>& p, int c) {
  const int* r = p.rows + C * c;
  Cone<C> k;
  if constexpr (C == 3) {
#pragma unroll
    for (int i = 0; i < 3; ++i) k.s[i] = p.scale[r[i]];
    k.n = 3;
  } else {
    k.n = p.kr[c];
#pragma unroll
    for (int i = 0; i < C; ++i) k.s[i] = i < k.n ? p.scale[r[i]] : 0.0f;
  }
  k.dn = p.D[r[0]];
  k.ac = p.act[r[0]];
  k.mu = p.mu[c];
  return k;
}

// The same for a contact of k.n <= C rows (C = 6: condim 3, 4 or 6): n =
// y_0, t = |y_1..n-1|, u = y_1..n-1 / t, v = (1, -mu u), e = (0, u), P =
// diag(0, 1, .., 1).  Entries past k.n come out 0 (their scales are 0)
// and are never read.
template <int C>
__device__ __forceinline__ bool cone_eval_k(const Cone<C>& k,
                                            const float jr[C], float f[C],
                                            float W[C][C], float* cost) {
  const float ac = k.ac;
  if (ac == 0.0f) return false;
  const float dn = k.dn, mu = k.mu;
  float y[C];
  float t2 = 0.0f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    y[i] = i < k.n ? jr[i] * k.s[i] : 0.0f;
    if (i > 0) t2 += y[i] * y[i];
  }
  const float n = y[0];
  const float t = sqrtf(fmaxf(t2, 1e-30f));
  if (n >= mu * t) return false;                      // top
  if (mu * n <= -t) {                                  // bottom
#pragma unroll
    for (int i = 0; i < C; ++i) {
      f[i] = -dn * y[i] * k.s[i] * ac;
#pragma unroll
      for (int j = 0; j < C; ++j)
        W[i][j] = i == j ? dn * k.s[i] * k.s[i] * ac : 0.0f;
    }
    *cost = 0.5f * dn * (n * n + t2) * ac;
  } else {                                             // middle
    const float mu2p1 = 1.0f + mu * mu;
    const float fn = dn * (mu * t - n) / mu2p1;
    const float cv = dn / mu2p1, ce = mu * fn / t;
    float u[C], v[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      u[i] = i > 0 ? y[i] / t : 0.0f;
      v[i] = i > 0 ? -mu * u[i] : 1.0f;
      f[i] = (i > 0 ? -mu * fn * u[i] : fn) * k.s[i] * ac;
    }
#pragma unroll
    for (int i = 0; i < C; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j)
        W[i][j] = (cv * v[i] * v[j]
                   + ce * ((i == j && i > 0 ? 1.0f : 0.0f) - u[i] * u[j]))
                  * k.s[i] * k.s[j] * ac;
    const float g = mu * t - n;
    *cost = 0.5f * dn * g * g / mu2p1 * ac;
  }
  return true;
}

// Row forces f, cost and Hessian block W (in the raw residuals jr) of a
// condim-3 elliptic contact (solver._ell_terms of the JAX package).
// Returns false, with nothing written, where the contact is inactive or
// in the top zone: it then adds nothing.  (The solve itself visits only
// active contacts; the check keeps the function whole.)
template <int C>
__device__ __forceinline__ bool cone_eval(const Cone<C>& k, const float jr[C],
                                          float f[C], float W[C][C],
                                          float* cost) {
  if constexpr (C > 3) {
    return cone_eval_k<C>(k, jr, f, W, cost);
  } else {
  const float ac = k.ac;
  if (ac == 0.0f) return false;
  const float dn = k.dn, mu = k.mu;
  float s[3], y[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s[i] = k.s[i];
    y[i] = jr[i] * s[i];
  }
  const float n = y[0];
  const float t2 = y[1] * y[1] + y[2] * y[2];
  const float t = sqrtf(fmaxf(t2, 1e-30f));
  if (n >= mu * t) return false;                      // top
  float fs[3], Ws[3][3];
  if (mu * n <= -t) {                                  // bottom
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      fs[i] = -dn * y[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) Ws[i][j] = i == j ? dn : 0.0f;
    }
    *cost = 0.5f * dn * (n * n + t2) * ac;
  } else {                                             // middle
    const float mu2p1 = 1.0f + mu * mu;
    const float fn = dn * (mu * t - n) / mu2p1;
    const float u[3] = {0.0f, y[1] / t, y[2] / t};
    const float v[3] = {1.0f, -mu * u[1], -mu * u[2]};
    const float cv = dn / mu2p1, ce = mu * fn / t;
    fs[0] = fn;
    fs[1] = -mu * fn * u[1];
    fs[2] = -mu * fn * u[2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Ws[i][j] = cv * v[i] * v[j]
                   + ce * ((i == j && i > 0 ? 1.0f : 0.0f) - u[i] * u[j]);
    const float g = mu * t - n;
    *cost = 0.5f * dn * g * g / mu2p1 * ac;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f[i] = fs[i] * s[i] * ac;
#pragma unroll
    for (int j = 0; j < 3; ++j) W[i][j] = Ws[i][j] * s[i] * s[j] * ac;
  }
  return true;
  }
}

template <int C>
__device__ __forceinline__ bool cone_terms(const Env<C>& p, int c,
                                           const float jr[C], float f[C],
                                           float W[C][C], float* cost) {
  return cone_eval<C>(cone_of<C>(p, c), jr, f, W, cost);
}

// A live row or contact as the line search sees it: constants, residual
// jar and step djar, in registers for the 12 steps.
struct RowReg {
  int type;
  float d;
  float fl;
  float act;
  float jar;
  float dj;
};

template <int C>
struct ConeReg {
  Cone<C> k;
  float jar[C];
  float dj[C];
};

template <int C>
__device__ __forceinline__ RowReg row_reg(const Env<C>& p, int e) {
  return {p.types[e], p.D[e], p.fl[e], p.act[e], p.jar[e], p.djar[e]};
}

template <int C>
__device__ __forceinline__ ConeReg<C> cone_reg(const Env<C>& p, int c) {
  ConeReg<C> r;
  r.k = cone_of<C>(p, c);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    r.jar[i] = p.jar[p.rows[C * c + i]];
    r.dj[i] = p.djar[p.rows[C * c + i]];
  }
  return r;
}

// Add a row's or a contact's terms of phi'(alpha) (less gma + alpha dmd)
// and phi''(alpha) (less dmd) to *pf and *pw.
__device__ __forceinline__ void row_phi(const RowReg& r, float alpha,
                                        float* pf, float* pw) {
  float f, w, c;
  row_terms(r.type, r.jar + alpha * r.dj, r.d, r.fl, r.act, &f, &w, &c);
  *pf += f * r.dj;
  *pw += w * r.dj * r.dj;
}

template <int C>
__device__ __forceinline__ void cone_phi(const ConeReg<C>& r, float alpha,
                                         float* pf, float* pw) {
  float jr[C], f[C], W[C][C], cost;
#pragma unroll
  for (int i = 0; i < C; ++i)
    jr[i] = alpha == 0.0f ? r.jar[i] : r.jar[i] + alpha * r.dj[i];
  if (!cone_eval<C>(r.k, jr, f, W, &cost)) return;
  const float* dj = r.dj;
  if constexpr (C == 3) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    *pf += f[i] * dj[i];
    *pw += dj[i] * (W[i][0] * dj[0] + W[i][1] * dj[1] + W[i][2] * dj[2]);
  }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (i >= r.k.n) break;
      float wd = 0.0f;
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (j < r.k.n) wd += W[i][j] * dj[j];
      *pf += f[i] * dj[i];
      *pw += dj[i] * wd;
    }
  }
}

// This lane's share of the row and cone costs at jar + alpha * djar.
template <int C>
__device__ __forceinline__ float cost_part(const Env<C>& p, float alpha) {
  float total = 0.0f;
  for (int i = p.lane; i < p.nr; i += 32) {
    const int e = p.rl[i];
    float f, w, c;
    p.terms(e, p.jar[e] + alpha * p.djar[e], &f, &w, &c);
    total += c;
  }
  for (int k = p.cone0; k < p.nc; k += 32) {
    float jr[C], f[C], W[C][C], cost;
    p.cone_res(p.cl[k], alpha, jr);
    if (cone_terms<C>(p, p.cl[k], jr, f, W, &cost)) total += cost;
  }
  return total;
}

// 0.5 vec' M vec over the warp (vec in shared memory); for each of its
// dofs u = lane + 32 k < nv a lane gets (M vec)[u] in mv[k] (0 past nv).
template <int S, int C>
__device__ __forceinline__ float quad(const Env<C>& p, const float* vec,
                                      float mv[S]) {
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int u = p.lane + 32 * k;
    float s = 0.0f;
    if (u < p.nv) {
      const float* row = p.M + u * p.ld;
#pragma unroll 4
      for (int v = 0; v < p.nv; ++v) s += row[v] * vec[v];
      q = k == 0 ? vec[u] * s : q + vec[u] * s;
    }
    mv[k] = s;
  }
  return 0.5f * warp_sum(q);
}

// Row forces f and weights w, and the live contacts' blocks, at jar.
// Rows that are not live keep the force 0 they were given at the start.
template <int C>
__device__ __forceinline__ void eval_terms(const Env<C>& p) {
  __syncwarp();
  for (int i = p.lane; i < p.nr; i += 32) {
    const int e = p.rl[i];
    float f, w, c;
    p.terms(e, p.jar[e], &f, &w, &c);
    p.f[e] = f;
    p.w[e] = w;
  }
  for (int k = p.cone0; k < p.nc; k += 32) {
    const int c = p.cl[k];
    const int* r = p.rows + C * c;
    const int n = C == 3 ? 3 : p.kr[c];
    float jr[C], f[C], W[C][C], cost;
    p.cone_res(c, 0.0f, jr);
    float* Wk = p.W + C * C * k;
    if (cone_terms<C>(p, c, jr, f, W, &cost)) {
      p.on[k] = 1.0f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (i >= n) break;
        p.f[r[i]] = f[i];
#pragma unroll
        for (int j = 0; j < C; ++j) Wk[C * i + j] = W[i][j];
      }
    } else {                    // top zone: no force, no block
      p.on[k] = 0.0f;
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (i < n) p.f[r[i]] = 0.0f;
    }
  }
  __syncwarp();
}

// grad = M (x - a) - J' f and mxa = M (x - a), each held by the lane of
// dof v < nv in its slot for v (0 past nv), J' f summed over the live rows
// in list order; needs eval_terms at x's jar.  A lane's second dof (S = 2)
// reads column min(lane + 32, nv - 1), kept only where it is below nv, so
// that every lane runs the same loop.
template <int S, int C>
__device__ __forceinline__ void gradient(const Env<C>& p, float mxa[S],
                                         float grad[S]) {
  __syncwarp();
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int u = p.lane + 32 * k;
    if (u < p.nv) p.t[u] = p.x[u] - p.a[u];
  }
  __syncwarp();
  float m[S];
  quad<S, C>(p, p.t, m);
  float jf[S];
#pragma unroll
  for (int k = 0; k < S; ++k) jf[k] = 0.0f;
  if (p.lane < p.nv) {
    const int v = p.lane;
    const int v1 = S == 2 ? min(v + 32, p.nv - 1) : v;
#pragma unroll 4
    for (int i = 0; i < p.nr; ++i) {
      const int e = p.rl[i];
      jf[0] += p.j(e, v) * p.f[e];
      if (S == 2) jf[S - 1] += p.j(e, v1) * p.f[e];
    }
    for (int k = 0; k < p.nc; ++k) {
      const int* r = p.rows + C * p.cl[k];
      if constexpr (C == 3) {
      jf[0] += p.j(r[0], v) * p.f[r[0]];
      jf[0] += p.j(r[1], v) * p.f[r[1]];
      jf[0] += p.j(r[2], v) * p.f[r[2]];
      if (S == 2) {
        jf[S - 1] += p.j(r[0], v1) * p.f[r[0]];
        jf[S - 1] += p.j(r[1], v1) * p.f[r[1]];
        jf[S - 1] += p.j(r[2], v1) * p.f[r[2]];
      }
      } else {
        const int n = p.kr[p.cl[k]];
        for (int i = 0; i < n; ++i) {
          jf[0] += p.j(r[i], v) * p.f[r[i]];
          if (S == 2) jf[S - 1] += p.j(r[i], v1) * p.f[r[i]];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    mxa[k] = m[k];
    grad[k] = k == 0 || p.lane + 32 * k < p.nv ? m[k] - jf[k] : 0.0f;
  }
}

// Row u and column v of entry k of a lower triangle stored row by row.
__device__ __forceinline__ void tri_index(int k, int* u, int* v) {
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= k) ++r;
  *u = r;
  *v = k - r * (r + 1) / 2;
}

// H = M + J' diag(w) J + sum_c J_c' W_c J_c, lower triangle, the
// nv (nv + 1) / 2 entries spread over the lanes: each lane sums entries k
// and k + 32 in one pass over the live rows and contacts.
template <int C>
__device__ __forceinline__ void build_h(const Env<C>& p) {
  const int nt = p.nv * (p.nv + 1) / 2, ld = p.ld, ldj = p.ldj;
  for (int k = p.lane; k < nt; k += 64) {
    const bool two = k + 32 < nt;
    int u0, v0, u1 = 0, v1 = 0;
    tri_index(k, &u0, &v0);
    if (two) tri_index(k + 32, &u1, &v1);
    float h0 = p.M[u0 * ld + v0], h1 = p.M[u1 * ld + v1];
#pragma unroll 4
    for (int i = 0; i < p.nr; ++i) {     // a row with w = 0 adds 0
      const int e = p.rl[i];
      const float w = p.w[e];
      const float* Je = p.J + e * ldj;
      h0 += (w * Je[u0]) * Je[v0];
      h1 += (w * Je[u1]) * Je[v1];
    }
    for (int c = 0; c < p.nc; ++c) {
      if (p.on[c] == 0.0f) continue;
      const int* r = p.rows + C * p.cl[c];
      const float* W = p.W + C * C * c;
      if constexpr (C > 3) {
        // (W J_c)[:, u] over the contact's n rows, then J_c[:, v]' of it
        const int n = p.kr[p.cl[c]];
        for (int i = 0; i < n; ++i) {
          float wj = 0.0f, wk = 0.0f;
          for (int j = 0; j < n; ++j) {
            const float* Jj = p.J + r[j] * ldj;
            wj += W[C * i + j] * Jj[u0];
            wk += W[C * i + j] * Jj[u1];
          }
          const float* Ji = p.J + r[i] * ldj;
          h0 += Ji[v0] * wj;
          h1 += Ji[v1] * wk;
        }
        continue;
      }
      const float* J0 = p.J + r[0] * ldj;
      const float* J1 = p.J + r[1] * ldj;
      const float* J2 = p.J + r[2] * ldj;
      float wj[3], wk[3];     // (W J_c)[:, u0], (W J_c)[:, u1]
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        wj[i] = W[3 * i] * J0[u0] + W[3 * i + 1] * J1[u0] + W[3 * i + 2] * J2[u0];
        wk[i] = W[3 * i] * J0[u1] + W[3 * i + 1] * J1[u1] + W[3 * i + 2] * J2[u1];
      }
      h0 += J0[v0] * wj[0] + J1[v0] * wj[1] + J2[v0] * wj[2];
      h1 += J0[v1] * wk[0] + J1[v1] * wk[1] + J2[v1] * wk[2];
    }
    p.H[u0 * ld + v0] = h0;
    if (two) p.H[u1 * ld + v1] = h1;
  }
  __syncwarp();
}

// In-place Cholesky of H's lower triangle with +1e-12 on the pivot
// (solver's eye_reg), column by column: the lane of row i >= j forms its
// entry of column j from row i and row j (the same subtractions, in the
// same order, as the right-looking loop), the pivot goes from row j's lane
// to the others by shuffle, and one __syncwarp publishes the column.  A
// lane owns rows lane + 32 k, k < S.
template <int S, int C>
__device__ __forceinline__ void cholesky(const Env<C>& p) {
  const int ld = p.ld;
  for (int j = 0; j < p.nv; ++j) {
    float s[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int i = p.lane + 32 * k;
      s[k] = 0.0f;
      if (i < p.nv && i >= j) {
        s[k] = p.H[i * ld + j];
        for (int c = 0; c < j; ++c) s[k] -= p.H[i * ld + c] * p.H[j * ld + c];
      }
    }
    const float sj = j < 32 ? s[0] : s[S - 1];
    const float pivot = __shfl_sync(FULL, sqrtf(fmaxf(sj + 1e-12f, 1e-30f)),
                                    j & 31);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int i = p.lane + 32 * k;
      if (i == j) p.H[j * ld + j] = pivot;
      else if (i < p.nv && i > j) p.H[i * ld + j] = s[k] / pivot;
    }
    __syncwarp();
  }
}

// delta = -H^-1 grad from the factor L in H; the lane of dof v < nv
// holds entry v in d.  Each of the 2 nv substitution steps waits on the one
// before, and an IEEE division is a long instruction sequence, so each lane
// takes the reciprocal of its own pivots once, all lanes at a time, and the
// steps multiply by it (within ~1.5 ulp of the quotient).
template <int S, int C>
__device__ __forceinline__ void newton_step(const Env<C>& p, const float grad[S],
                                            float d[S]) {
  const int ld = p.ld;
  float inv[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = p.lane + 32 * k;
    const bool own = i < p.nv;
    inv[k] = own ? 1.0f / p.H[i * ld + i] : 0.0f;
    d[k] = own ? -grad[k] : 0.0f;
  }
  for (int j = 0; j < p.nv; ++j) {
    const float src = j < 32 ? d[0] * inv[0] : d[S - 1] * inv[S - 1];
    const float yj = __shfl_sync(FULL, src, j & 31);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int i = p.lane + 32 * k;
      if (i > j && i < p.nv) d[k] -= p.H[i * ld + j] * yj;
      if (i == j) d[k] = yj;
    }
  }
  for (int j = p.nv - 1; j >= 0; --j) {
    const float src = j < 32 ? d[0] * inv[0] : d[S - 1] * inv[S - 1];
    const float xj = __shfl_sync(FULL, src, j & 31);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int i = p.lane + 32 * k;
      if (i < j) d[k] -= p.H[j * ld + i] * xj;
      if (i == j) d[k] = xj;
    }
  }
}

// This lane's share of |v|^2 over its dof slots.
template <int S>
__device__ __forceinline__ float sum_sq(const float v[S]) {
  float s = v[0] * v[0];
  if (S == 2) s += v[S - 1] * v[S - 1];
  return s;
}

template <int S, int C>
__global__ void __launch_bounds__(MAX_WARPS * 32)
newton_kernel(Problem q, int niter, int ls_iter, float tol, float scale) {
  extern __shared__ float smem[];
  const int nefc = q.nefc, nv = q.nv, ncg = q.ncg;
  // per-block tables, loaded by every thread before any warp leaves
  int* s_types = reinterpret_cast<int*>(smem);
  float* s_scale = smem + nefc;
  int* s_rows = reinterpret_cast<int*>(s_scale + nefc);
  float* s_mu = smem + 2 * nefc + C * ncg;
  int* s_k = reinterpret_cast<int*>(s_mu + ncg);    // C > 3 only
  for (int k = threadIdx.x; k < nefc; k += blockDim.x) {
    s_types[k] = q.types[k];
    s_scale[k] = ncg > 0 ? q.s_row[k] : 1.0f;
  }
  for (int k = threadIdx.x; k < C * ncg; k += blockDim.x)
    s_rows[k] = q.ell_rows[k];
  for (int k = threadIdx.x; k < ncg; k += blockDim.x) {
    s_mu[k] = q.ell_mu[k];
    if (C > 3) s_k[k] = q.ell_k[k];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= q.B) return;            // the whole warp: its environment is past B

  Env<C> p;
  p.types = s_types;
  p.rows = s_rows;
  p.kr = s_k;
  p.mu = s_mu;
  p.scale = s_scale;
  p.nefc = nefc;
  p.nv = nv;
  p.ncg = ncg;
  p.ld = row_stride(nv);
  p.lane = lane;
  float* const base = smem + block_words(nefc, ncg, C)
                      + warp * warp_words(nefc, nv, ncg, C);
  if (S == 1) {
    p.J = base;
    p.ldj = p.ld;
    p.M = base + nefc * p.ld;
  } else {
    p.J = q.J + b * nefc * nv;
    p.ldj = nv;
    p.M = base;
  }
  p.H = p.M + nv * p.ld;
  p.jar = p.H + nv * p.ld;
  p.djar = p.jar + nefc;
  p.D = p.djar + nefc;
  p.fl = p.D + nefc;
  p.act = p.fl + nefc;
  p.f = p.act + nefc;
  p.w = p.f + nefc;
  p.rl = reinterpret_cast<int*>(p.w + nefc);
  p.W = p.w + 2 * nefc;
  p.on = p.W + C * C * ncg;
  p.cl = reinterpret_cast<int*>(p.on + ncg);
  p.x = p.on + 2 * ncg;
  p.a = p.x + nv;
  p.d = p.a + nv;
  p.t = p.d + nv;

  if (S == 1) warp_load(base, q.J + b * nefc * nv, nefc * nv, nv, p.ld, lane);
  warp_load(p.M, q.M + b * nv * nv, nv * nv, nv, p.ld, lane);
  warp_load(p.D, q.D + b * nefc, nefc, nefc, nefc, lane);
  warp_load(p.fl, q.fl + b * nefc, nefc, nefc, nefc, lane);
  warp_load(p.act, q.active + b * nefc, nefc, nefc, nefc, lane);
  for (int e = lane; e < nefc; e += 32) p.f[e] = 0.0f;
  float a_v[S], w_v[S];    // the lane's dofs of a and warm
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int u = lane + 32 * k;
    a_v[k] = 0.0f;
    w_v[k] = 0.0f;
    if (u < nv) {
      a_v[k] = q.a[b * nv + u];
      w_v[k] = q.warm[b * nv + u];
      p.a[u] = a_v[k];
      p.x[u] = w_v[k];
    }
  }
  __syncwarp();
  p.nr = warp_compact(nefc, lane, p.rl, [&](int e) {
    return p.act[e] != 0.0f && s_types[e] <= ONESIDED;
  });
  p.nc = warp_compact(ncg, lane, p.cl, [&](int c) {
    return p.act[s_rows[C * c]] != 0.0f;
  });
  p.cone0 = (lane - p.nr % 32 + 32) % 32;
  __syncwarp();

  // warmstart selection: the better initial cost wins (jar holds J a -
  // aref, djar J warm - aref)
  p.own_rows([&](int e) {
    float ja = -q.aref[b * nefc + e], jw = ja;
    for (int v = 0; v < nv; ++v) {
      const float jv = p.j(e, v);
      ja += jv * p.a[v];
      jw += jv * p.x[v];
    }
    p.jar[e] = ja;
    p.djar[e] = jw;
  });
  float part_a = 0.0f, part_w = 0.0f;
  for (int i = lane; i < p.nr; i += 32) {
    const int e = p.rl[i];
    float f, w, c;
    p.terms(e, p.jar[e], &f, &w, &c);
    part_a += c;
    p.terms(e, p.djar[e], &f, &w, &c);
    part_w += c;
  }
  for (int k = p.cone0; k < p.nc; k += 32) {
    const int c = p.cl[k];
    float jr[C], f[C], W[C][C], cost;
    p.cone_res(c, 0.0f, jr);
    if (cone_terms<C>(p, c, jr, f, W, &cost)) part_a += cost;
#pragma unroll
    for (int i = 0; i < C; ++i) jr[i] = p.djar[p.rows[C * c + i]];
    if (cone_terms<C>(p, c, jr, f, W, &cost)) part_w += cost;
  }
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (lane + 32 * k < nv) p.t[lane + 32 * k] = w_v[k] - a_v[k];
  __syncwarp();
  float tmp[S];
  const float quad_w = quad<S, C>(p, p.t, tmp);
  warp_sum2(&part_a, &part_w);
  const float cost_a = part_a, cost_w = part_w + quad_w;
  const bool use_warm = cost_w < cost_a;
  float cost = fminf(cost_w, cost_a);
  float x_v[S];
#pragma unroll
  for (int k = 0; k < S; ++k) x_v[k] = use_warm ? w_v[k] : a_v[k];
  if (use_warm) {
    p.own_rows([&](int e) { p.jar[e] = p.djar[e]; });
  } else {
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (lane + 32 * k < nv) p.x[lane + 32 * k] = a_v[k];
  }
  eval_terms<C>(p);
  float mxa[S], grad[S];
  gradient<S, C>(p, mxa, grad);
  bool done = !(scale * sqrtf(warp_sum(sum_sq<S>(grad))) >= tol);

  int it = 0;
  while (it < niter && !done) {
    build_h<C>(p);
    cholesky<S, C>(p);
    float d_v[S];
    newton_step<S, C>(p, grad, d_v);
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (lane + 32 * k < nv) p.d[lane + 32 * k] = d_v[k];
    __syncwarp();
    p.own_rows([&](int e) {
      float s = 0.0f;
#pragma unroll 4
      for (int v = 0; v < nv; ++v) s += p.j(e, v) * p.d[v];
      p.djar[e] = s;
    });
    float dmd = 2.0f * quad<S, C>(p, p.d, tmp);
    float gma = d_v[0] * mxa[0];
    if (S == 2) gma += d_v[S - 1] * mxa[S - 1];
    gma = warp_sum(gma);
    __syncwarp();

    // guarded Newton on phi'(alpha), starting at the full step; this
    // lane's first live row and contact stay in registers throughout
    float alpha = 1.0f, lo = 0.0f, hi = 4.0f;
    const bool has_row = lane < p.nr, has_cone = p.cone0 < p.nc;
    RowReg row0;
    ConeReg<C> cone0;
    if (has_row) row0 = row_reg<C>(p, p.rl[lane]);
    if (has_cone) cone0 = cone_reg<C>(p, p.cl[p.cone0]);
    for (int s = 0; s < ls_iter; ++s) {
      float pf = 0.0f, pw = 0.0f;
      if (has_row) row_phi(row0, alpha, &pf, &pw);
      for (int i = lane + 32; i < p.nr; i += 32)
        row_phi(row_reg<C>(p, p.rl[i]), alpha, &pf, &pw);
      if (has_cone) cone_phi<C>(cone0, alpha, &pf, &pw);
      for (int k = p.cone0 + 32; k < p.nc; k += 32)
        cone_phi<C>(cone_reg<C>(p, p.cl[k]), alpha, &pf, &pw);
      warp_sum2(&pf, &pw);
      const float dp = gma + alpha * dmd - pf;
      const float ddp = dmd + pw;
      if (dp < 0.0f) lo = fmaxf(lo, alpha);
      if (dp > 0.0f) hi = fminf(hi, alpha);
      const float alpha_n = alpha - dp / fmaxf(ddp, 1e-14f);
      alpha = (alpha_n > lo && alpha_n < hi) ? alpha_n : 0.5f * (lo + hi);
    }

    // accept if improved
    __syncwarp();
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (lane + 32 * k < nv)
        p.t[lane + 32 * k] = x_v[k] + alpha * d_v[k] - a_v[k];
    __syncwarp();
    float q_new = 0.0f, part = cost_part<C>(p, alpha);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int u = lane + 32 * k;
      if (u < nv) {
        float s = 0.0f;
        for (int v = 0; v < nv; ++v) s += p.M[u * p.ld + v] * p.t[v];
        q_new = k == 0 ? p.t[u] * s : q_new + p.t[u] * s;
      }
    }
    warp_sum2(&q_new, &part);
    const float new_cost = 0.5f * q_new + part;
    float improvement = 0.0f;
    __syncwarp();
    if (new_cost < cost) {
#pragma unroll
      for (int k = 0; k < S; ++k) {
        x_v[k] += alpha * d_v[k];
        if (lane + 32 * k < nv) p.x[lane + 32 * k] = x_v[k];
      }
      p.own_rows([&](int e) { p.jar[e] += alpha * p.djar[e]; });
      improvement = scale * (cost - new_cost);
      cost = new_cost;
    }
    eval_terms<C>(p);
    gradient<S, C>(p, mxa, grad);
    const float grad_norm = scale * sqrtf(warp_sum(sum_sq<S>(grad)));
    // NaN-robust: a diverged environment stops
    done = !(improvement >= tol && grad_norm >= tol);
    ++it;
  }

  // exact final forces from x
  __syncwarp();
  p.own_rows([&](int e) {
    float s = -q.aref[b * nefc + e];
    for (int v = 0; v < nv; ++v) s += p.j(e, v) * p.x[v];
    p.jar[e] = s;
  });
  eval_terms<C>(p);
  for (int e = lane; e < nefc; e += 32) q.f_out[b * nefc + e] = p.f[e];
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (lane + 32 * k < nv) q.x_out[b * nv + lane + 32 * k] = x_v[k];
  if (lane == 0) q.iters_out[b] = it;
}

}  // namespace

template <int S, int C>
static int launch(const Problem& q, int niter, int ls_iter, float tol,
                  float scale, int warps, int smem_bytes,
                  cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        newton_kernel<S, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((q.B + warps - 1) / warps);
  newton_kernel<S, C><<<blocks, warps * 32, smem_bytes, stream>>>(
      q, niter, ls_iter, tol, scale);
  return (int)cudaGetLastError();
}

// cmax: the layout's largest elliptic condim (3 or 6; 3 where it has none)
extern "C" int dmc_newton_solve(const float* J, const float* M,
                                const float* aref, const float* D,
                                const float* fl, const float* active,
                                const float* a, const float* warm,
                                const int* types, const int* ell_rows,
                                const int* ell_k, const float* ell_mu,
                                const float* s_row, float* x_out,
                                float* f_out, int* iters_out, int nefc,
                                int nv, int ncg, int cmax, int batch,
                                int niter, int ls_iter, float tol,
                                float scale, int warps, int smem_bytes,
                                void* stream) {
  if (nv < 1 || nv > MAX_NV || nefc < 1 || ncg < 0 || batch < 1 ||
      warps < 1 || warps > MAX_WARPS || (cmax != 3 && cmax != 6))
    return (int)cudaErrorInvalidValue;
  const long long words = block_words(nefc, ncg, cmax)
                          + (long long)warps * warp_words(nefc, nv, ncg, cmax);
  if (4 * words != smem_bytes || smem_bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  Problem q{J, M, aref, D, fl, active, a, warm, types, ell_rows, ell_k,
            ell_mu, s_row, x_out, f_out, iters_out, nefc, nv, ncg,
            (long long)batch};
  const cudaStream_t st = (cudaStream_t)stream;
  if (cmax == 3)
    return nv <= 32
        ? launch<1, 3>(q, niter, ls_iter, tol, scale, warps, smem_bytes, st)
        : launch<2, 3>(q, niter, ls_iter, tol, scale, warps, smem_bytes, st);
  return nv <= 32
      ? launch<1, 6>(q, niter, ls_iter, tol, scale, warps, smem_bytes, st)
      : launch<2, 6>(q, niter, ls_iter, tol, scale, warps, smem_bytes, st);
}
