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
// Layout: batch-last as on the TPU: J (nv, nefc, B), M (nv, nv, B), row
// vectors (nefc, B), dof vectors (nv, B); the contacts' rows (ncg, 3),
// mu (ncg) and the row scales (nefc) are the same for every lane.  No
// padding of nefc or nv (that was Mosaic's sublane rule).
//
// Design: one thread per environment runs the whole Newton loop for its
// lane and leaves it on its own exit rule, which gives the per-lane result
// of the TPU kernel's frozen done lanes.  x, the gradient, the step and
// H/L live in thread-local arrays sized by MAX_NV; J, M and the row
// vectors are read from device memory, coalesced across the warp, and
// the row residuals jar/djar go to a (nefc, B) scratch the wrapper
// allocates.  Everything is float32, as on the TPU.  (Double accumulators
// for the costs and the gradient were tried on an H100 and made lanes
// wander further along flat directions, not less: the accept-if-improved
// test then sees improvements the float32 reference cannot.)
//
// What bounds it on an H100: the inputs are read once, ~2.5 KB per walker
// environment (nv 9, nefc 62): 10 MB at B = 4096, 3 us of HBM time.  The
// arithmetic, ~5 * 10^4 FLOP per Newton iteration per environment, is
// ~0.01 ms of the card's float32 rate for a few iterations.  This design
// is bound by neither: 4096 threads fill 32 blocks of 128 on 132 SMs (one
// warp scheduler in sixteen), and each thread's serial loop re-reads J
// from L1/L2 every iteration and line-search step.  K2-ell on finger-spin
// (nv 3, nefc 105, 34 cones) reads ~3.4 KB per environment once; its time
// is set the same way, and by the slowest lane's iteration count, since a
// launch lasts as long as its longest loop.  A later design puts an
// environment on a warp, keeps J in shared memory and spreads the rows
// and the cones over the lanes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int MAX_NV = 32;
constexpr int EQUALITY = 0;
constexpr int FRICTION = 1;
constexpr int ONESIDED = 2;

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

struct Problem {
  const float* J;
  const float* M;
  const float* aref;
  const float* D;
  const float* fl;
  const float* active;
  const int* types;
  const int* ell_rows;   // (ncg, 3): normal, t1, t2 row of each contact
  const float* ell_mu;   // (ncg,)
  const float* s_row;    // (nefc,) elliptic row scales
  float* jar;
  float* djar;
  int nefc;
  int nv;
  int ncg;
  long long B;
  long long b;

  __device__ long long e_at(int e) const { return (long long)e * B + b; }
  __device__ float j(int v, int e) const {
    return J[((long long)v * nefc + e) * B + b];
  }
  __device__ float m(int u, int v) const {
    return M[((long long)u * nv + v) * B + b];
  }
  __device__ void terms(int e, float jar_e, float* f, float* w,
                        float* c) const {
    const long long i = e_at(e);
    row_terms(types[e], jar_e, D[i], fl[i], active[i], f, w, c);
  }
  // residuals jar + alpha * djar of contact c's three rows
  __device__ void cone_res(int c, float alpha, float jr[3]) const {
    for (int i = 0; i < 3; ++i) {
      const long long k = e_at(ell_rows[3 * c + i]);
      jr[i] = alpha == 0.0f ? jar[k] : jar[k] + alpha * djar[k];
    }
  }
};

// Row forces f, cost and Hessian block W (in the raw residuals jr) of the
// condim-3 elliptic contact c (solver._ell_terms of the JAX package).
// Returns false, with nothing written, where the contact is inactive or
// in the top zone: it then adds nothing.
__device__ bool cone_terms(const Problem& p, int c, const float jr[3],
                           float f[3], float W[3][3], float* cost) {
  const int* r = p.ell_rows + 3 * c;
  const long long i0 = p.e_at(r[0]);
  const float ac = p.active[i0];
  if (ac == 0.0f) return false;
  const float dn = p.D[i0], mu = p.ell_mu[c];
  float s[3], y[3];
  for (int i = 0; i < 3; ++i) {
    s[i] = p.s_row[r[i]];
    y[i] = jr[i] * s[i];
  }
  const float n = y[0];
  const float t2 = y[1] * y[1] + y[2] * y[2];
  const float t = sqrtf(fmaxf(t2, 1e-30f));
  if (n >= mu * t) return false;                      // top
  float fs[3], Ws[3][3];
  if (mu * n <= -t) {                                  // bottom
    for (int i = 0; i < 3; ++i) {
      fs[i] = -dn * y[i];
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
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Ws[i][j] = cv * v[i] * v[j]
                   + ce * ((i == j && i > 0 ? 1.0f : 0.0f) - u[i] * u[j]);
    const float g = mu * t - n;
    *cost = 0.5f * dn * g * g / mu2p1 * ac;
  }
  for (int i = 0; i < 3; ++i) {
    f[i] = fs[i] * s[i] * ac;
    for (int j = 0; j < 3; ++j) W[i][j] = Ws[i][j] * s[i] * s[j] * ac;
  }
  return true;
}

// Sum of the elliptic contacts' costs at jar + alpha * djar.
__device__ float cone_cost(const Problem& p, float alpha) {
  float total = 0.0f;
  for (int c = 0; c < p.ncg; ++c) {
    float jr[3], f[3], W[3][3], cost;
    p.cone_res(c, alpha, jr);
    if (cone_terms(p, c, jr, f, W, &cost)) total += cost;
  }
  return total;
}

// 0.5 xa' M xa, and M xa into mxa.
__device__ float quad_cost(const Problem& p, const float* xa, float* mxa) {
  float q = 0.0f;
  for (int u = 0; u < p.nv; ++u) {
    float s = 0.0f;
    for (int v = 0; v < p.nv; ++v) s += p.m(u, v) * xa[v];
    mxa[u] = s;
    q += xa[u] * s;
  }
  return 0.5f * q;
}

// grad = M (x - a) - J' f(jar); mxa = M (x - a).
__device__ void gradient(const Problem& p, const float* x, const float* a,
                         float* mxa, float* grad) {
  float xa[MAX_NV];
  for (int v = 0; v < p.nv; ++v) xa[v] = x[v] - a[v];
  quad_cost(p, xa, mxa);
  float g[MAX_NV];
  for (int v = 0; v < p.nv; ++v) g[v] = mxa[v];
  for (int e = 0; e < p.nefc; ++e) {
    float f, w, c;
    p.terms(e, p.jar[p.e_at(e)], &f, &w, &c);
    if (f != 0.0f)
      for (int v = 0; v < p.nv; ++v) g[v] -= p.j(v, e) * f;
  }
  for (int c = 0; c < p.ncg; ++c) {
    float jr[3], f[3], W[3][3], cost;
    p.cone_res(c, 0.0f, jr);
    if (!cone_terms(p, c, jr, f, W, &cost)) continue;
    for (int i = 0; i < 3; ++i) {
      const int e = p.ell_rows[3 * c + i];
      for (int v = 0; v < p.nv; ++v) g[v] -= p.j(v, e) * f[i];
    }
  }
  for (int v = 0; v < p.nv; ++v) grad[v] = g[v];
}

__device__ float norm(const float* v, int n) {
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s += v[i] * v[i];
  return sqrtf(s);
}

__global__ void newton_kernel(Problem p, const float* a_in,
                              const float* warm_in, float* x_out,
                              float* f_out, int* iters_out, int niter,
                              int ls_iter, float tol, float scale) {
  p.b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p.b >= p.B) return;
  const int nv = p.nv, nefc = p.nefc;
  float a[MAX_NV], x[MAX_NV], mxa[MAX_NV], grad[MAX_NV], delta[MAX_NV];
  float H[MAX_NV * MAX_NV];
  float xa[MAX_NV], tmp[MAX_NV];

  // warmstart selection: the better initial cost wins
  for (int v = 0; v < nv; ++v) {
    a[v] = a_in[(long long)v * p.B + p.b];
    x[v] = warm_in[(long long)v * p.B + p.b];
  }
  float cost_a = 0.0f, cost_w = 0.0f;
  for (int e = 0; e < nefc; ++e) {
    float ja = -p.aref[p.e_at(e)], jw = ja;
    for (int v = 0; v < nv; ++v) {
      const float jv = p.j(v, e);
      ja += jv * a[v];
      jw += jv * x[v];
    }
    float f, w, c;
    p.terms(e, ja, &f, &w, &c);
    cost_a += c;
    p.terms(e, jw, &f, &w, &c);
    cost_w += c;
    p.jar[p.e_at(e)] = ja;
    p.djar[p.e_at(e)] = jw;
  }
  cost_a += cone_cost(p, 0.0f);        // jar holds J a - aref
  for (int c = 0; c < p.ncg; ++c) {    // djar holds J warm - aref
    float jr[3], f[3], W[3][3], cost;
    for (int i = 0; i < 3; ++i)
      jr[i] = p.djar[p.e_at(p.ell_rows[3 * c + i])];
    if (cone_terms(p, c, jr, f, W, &cost)) cost_w += cost;
  }
  for (int v = 0; v < nv; ++v) xa[v] = x[v] - a[v];
  cost_w += quad_cost(p, xa, tmp);
  const bool use_warm = cost_w < cost_a;
  float cost = fminf(cost_w, cost_a);
  if (use_warm) {
    for (int e = 0; e < nefc; ++e) p.jar[p.e_at(e)] = p.djar[p.e_at(e)];
  } else {
    for (int v = 0; v < nv; ++v) x[v] = a[v];
  }
  gradient(p, x, a, mxa, grad);
  bool done = !(scale * norm(grad, nv) >= tol);

  int it = 0;
  while (it < niter && !done) {
    // H = M + J' diag(w) J, lower triangle
    for (int u = 0; u < nv; ++u)
      for (int v = 0; v <= u; ++v) H[u * nv + v] = p.m(u, v);
    for (int e = 0; e < nefc; ++e) {
      float f, w, c;
      p.terms(e, p.jar[p.e_at(e)], &f, &w, &c);
      if (w == 0.0f) continue;
      for (int v = 0; v < nv; ++v) tmp[v] = p.j(v, e);
      for (int u = 0; u < nv; ++u) {
        const float wu = w * tmp[u];
        for (int v = 0; v <= u; ++v) H[u * nv + v] += wu * tmp[v];
      }
    }
    for (int c = 0; c < p.ncg; ++c) {   // + J_c' W_c J_c
      float jr[3], f[3], W[3][3], cost;
      p.cone_res(c, 0.0f, jr);
      if (!cone_terms(p, c, jr, f, W, &cost)) continue;
      const int* r = p.ell_rows + 3 * c;
      for (int u = 0; u < nv; ++u) {
        float wj[3];     // (W J_c)[:, u]
        for (int i = 0; i < 3; ++i)
          wj[i] = W[i][0] * p.j(u, r[0]) + W[i][1] * p.j(u, r[1])
                  + W[i][2] * p.j(u, r[2]);
        for (int v = 0; v <= u; ++v)
          H[u * nv + v] += p.j(v, r[0]) * wj[0] + p.j(v, r[1]) * wj[1]
                           + p.j(v, r[2]) * wj[2];
      }
    }
    // Cholesky with +1e-12 on the pivot (solver's eye_reg)
    for (int j = 0; j < nv; ++j) {
      const float pivot = sqrtf(fmaxf(H[j * nv + j] + 1e-12f, 1e-30f));
      H[j * nv + j] = pivot;
      for (int i = j + 1; i < nv; ++i) H[i * nv + j] /= pivot;
      for (int i = j + 1; i < nv; ++i) {
        const float lij = H[i * nv + j];
        for (int k = j + 1; k <= i; ++k) H[i * nv + k] -= lij * H[k * nv + j];
      }
    }
    // delta = -H^-1 grad
    for (int j = 0; j < nv; ++j) delta[j] = -grad[j];
    for (int j = 0; j < nv; ++j) {
      const float yj = delta[j] / H[j * nv + j];
      for (int i = j + 1; i < nv; ++i) delta[i] -= H[i * nv + j] * yj;
      delta[j] = yj;
    }
    for (int j = nv - 1; j >= 0; --j) {
      const float xj = delta[j] / H[j * nv + j];
      for (int i = 0; i < j; ++i) delta[i] -= H[j * nv + i] * xj;
      delta[j] = xj;
    }

    for (int e = 0; e < nefc; ++e) {
      float s = 0.0f;
      for (int v = 0; v < nv; ++v) s += p.j(v, e) * delta[v];
      p.djar[p.e_at(e)] = s;
    }
    const float dmd = 2.0f * quad_cost(p, delta, tmp);
    float gma = 0.0f;
    for (int v = 0; v < nv; ++v) gma += delta[v] * mxa[v];

    // guarded Newton on phi'(alpha), starting at the full step
    float alpha = 1.0f, lo = 0.0f, hi = 4.0f;
    for (int s = 0; s < ls_iter; ++s) {
      float dp = gma + alpha * dmd, ddp = dmd;
      for (int e = 0; e < nefc; ++e) {
        const float dj = p.djar[p.e_at(e)];
        float f, w, c;
        p.terms(e, p.jar[p.e_at(e)] + alpha * dj, &f, &w, &c);
        dp -= f * dj;
        ddp += w * dj * dj;
      }
      for (int c = 0; c < p.ncg; ++c) {
        float jr[3], f[3], W[3][3], cost;
        p.cone_res(c, alpha, jr);
        if (!cone_terms(p, c, jr, f, W, &cost)) continue;
        float dj[3];
        for (int i = 0; i < 3; ++i)
          dj[i] = p.djar[p.e_at(p.ell_rows[3 * c + i])];
        for (int i = 0; i < 3; ++i) {
          dp -= f[i] * dj[i];
          ddp += dj[i] * (W[i][0] * dj[0] + W[i][1] * dj[1]
                          + W[i][2] * dj[2]);
        }
      }
      if (dp < 0.0f) lo = fmaxf(lo, alpha);
      if (dp > 0.0f) hi = fminf(hi, alpha);
      const float alpha_n = alpha - dp / fmaxf(ddp, 1e-14f);
      alpha = (alpha_n > lo && alpha_n < hi) ? alpha_n : 0.5f * (lo + hi);
    }

    // accept if improved
    for (int v = 0; v < nv; ++v) xa[v] = x[v] + alpha * delta[v] - a[v];
    float new_cost = quad_cost(p, xa, tmp);
    for (int e = 0; e < nefc; ++e) {
      float f, w, c;
      p.terms(e, p.jar[p.e_at(e)] + alpha * p.djar[p.e_at(e)], &f, &w, &c);
      new_cost += c;
    }
    new_cost += cone_cost(p, alpha);
    float improvement = 0.0f;
    if (new_cost < cost) {
      for (int v = 0; v < nv; ++v) x[v] += alpha * delta[v];
      for (int e = 0; e < nefc; ++e)
        p.jar[p.e_at(e)] += alpha * p.djar[p.e_at(e)];
      improvement = scale * (cost - new_cost);
      cost = new_cost;
    }
    gradient(p, x, a, mxa, grad);
    const float grad_norm = scale * norm(grad, nv);
    // NaN-robust: a diverged lane stops
    done = !(improvement >= tol && grad_norm >= tol);
    ++it;
  }

  // exact final forces from x
  for (int e = 0; e < nefc; ++e) {
    float s = -p.aref[p.e_at(e)];
    for (int v = 0; v < nv; ++v) s += p.j(v, e) * x[v];
    float f, w, c;
    p.terms(e, s, &f, &w, &c);
    f_out[p.e_at(e)] = f;
    p.jar[p.e_at(e)] = s;
  }
  for (int c = 0; c < p.ncg; ++c) {
    float jr[3], f[3], W[3][3], cost;
    p.cone_res(c, 0.0f, jr);
    if (!cone_terms(p, c, jr, f, W, &cost)) continue;
    for (int i = 0; i < 3; ++i) f_out[p.e_at(p.ell_rows[3 * c + i])] = f[i];
  }
  for (int v = 0; v < nv; ++v) x_out[(long long)v * p.B + p.b] = x[v];
  iters_out[p.b] = it;
}

}  // namespace

extern "C" int dmc_newton_solve(const float* J, const float* M,
                                const float* aref, const float* D,
                                const float* fl, const float* active,
                                const float* a, const float* warm,
                                const int* types, const int* ell_rows,
                                const float* ell_mu, const float* s_row,
                                float* x_out, float* f_out, int* iters_out,
                                float* jar, float* djar, int nefc, int nv,
                                int ncg, int batch, int niter, int ls_iter,
                                float tol, float scale, void* stream) {
  if (nv < 1 || nv > MAX_NV || nefc < 1 || ncg < 0)
    return (int)cudaErrorInvalidValue;
  Problem p{J, M, aref, D, fl, active, types, ell_rows, ell_mu, s_row,
            jar, djar, nefc, nv, ncg, (long long)batch, 0};
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  newton_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, a, warm, x_out, f_out, iters_out, niter, ls_iter, tol, scale);
  return (int)cudaGetLastError();
}
