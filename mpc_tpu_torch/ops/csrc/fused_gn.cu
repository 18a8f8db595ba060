// fused_gn.cu — the whole batched AL-SQP solve in one launch, for Hopper.
//
// Replaces mpc_tpu/ops/fused_gn.py::_make_kernel (the Pallas TPU kernel,
// launched by _solve_packed).  Computes, per lane: an initial rollout that
// caches the constraint rows; al_iters x sqp_iters Gauss-Newton steps, each
// with analytic stage quadratics, the RK4/Euler chain-rule Jacobian, a
// Riccati sweep with a closed-form 2x2 Quu inverse, then either the
// unguarded full step with NaN/inf-scrubbed gains or the merit ladder; the
// multiplier and penalty update; and the diagnostics (adjoint stationarity,
// scaled violation, cost, merit).  The plain PyTorch version of the same
// function is fused_gn.py::solve_batch_fused_plain.
//
// What bounds it on an H100.  Each lane is a long sequential program: ~10^5
// fp32 operations per GN iteration at H=30 (the 5x5 Riccati products
// dominate) against ~16 KB of inputs and outputs per lane.  By the roofline
// the warm 1x1 budget is bound by those bytes and the cold 3x4 budget by
// its operations; in practice both are bound by latency: one lane cannot be
// split across threads without synchronising at every stage, and at the
// bench batch (16384 lanes) there are only 512 warps for 132 SMs, about
// one per scheduler, so neither arithmetic nor load latency is hidden.
// The per-stage working set (P, A, B, Q, K, ...) is ~150 floats, so the
// compiler keeps the sweep near the 255-register cap and may spill.
// PERF.md has the measured times beside the bound.
//
// What the design does about it.  One thread per lane: no cross-thread
// synchronisation at all, every per-stage quantity lives in registers, and
// the only memory traffic is the per-stage state, stored with the lane index
// fastest ((stage, field, lane)) so the 32 threads of a warp load
// neighbouring addresses.  Small blocks (64 threads by default) spread the
// few warps over all SMs.  The line-search keeps two trial chains per lane
// and swaps which one is "best" instead of copying the winner.  When the
// caller passes a rung buffer, each ladder iteration writes the rung it
// committed (0 for alpha = 0, r + 1 for alphas[r]), so a check can tell a
// near-tie of merits from a wrong choice.
//
// Semantics kept from the TPU kernel on purpose: clips, maxima and signs
// propagate NaN (compares, not fminf/fmaxf), the unguarded step commits a
// non-finite rollout into the warm start, rows cached by the initial rollout
// and by the multiplier update are read back by the next sweep and by the
// diagnostics.  Build without --use_fast_math: the parity bands assume IEEE
// tanf, sqrtf, sinf, cosf and division.

#include <cuda_runtime.h>
#include <stdint.h>

#define NX 5
#define NU 2
#define NR 14
#define NROWVALS 44
#define MAX_ALPHAS 16

struct FgnArgs {
  int32_t B, H, al_iters, sqp_iters, n_alphas;
  int32_t forcespro, rk4, moving, use_term, threads;
  float dt, half_dt, dt6, inv_l, reg, d_ego, a_cap, inv_fr_scale;
  float u_lo0, u_hi0, u_lo1, u_hi1, d_lo, d_hi, v_lo, v_hi;
  float mu0, mu_factor, mu_max, viol_improve, lam_max, tol_feas;
  float alphas[MAX_ALPHAS];
};

// --------------------------------------------------------------------------
// NaN-propagating scalar helpers (jnp semantics)
// --------------------------------------------------------------------------

__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;  // NaN in either operand -> NaN
}
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);  // NaN stays NaN
}
__device__ __forceinline__ float relu(float t) { return t > 0.f ? t : 0.f; }
__device__ __forceinline__ float sgn3(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);  // sign(0) = 0, NaN -> NaN
}
__device__ __forceinline__ bool finite_f32(float x) {
  return fabsf(x) <= 3.402823466e38f;  // false for inf and NaN
}

// Per-lane view of an array stored (..., field, lane): element (k, i).
struct Lane {
  int B, lane;
  __device__ __forceinline__ size_t at(int k, int i, int nf) const {
    return ((size_t)k * nf + i) * B + lane;
  }
};

// --------------------------------------------------------------------------
// dynamics: KS ODE, discrete step, analytic (A, B)
// --------------------------------------------------------------------------

__device__ __forceinline__ void ks_ode(const float x[NX], const float u[NU],
                                       float inv_l, float f[NX]) {
  const float delta = x[2], v = x[3], psi = x[4];
  f[0] = v * cosf(psi);
  f[1] = v * sinf(psi);
  f[2] = u[0];
  f[3] = u[1];
  f[4] = v * tanf(delta) * inv_l;
}

__device__ __forceinline__ void axpy(const float x[NX], float s,
                                     const float k[NX], float out[NX]) {
#pragma unroll
  for (int i = 0; i < NX; ++i) out[i] = x[i] + s * k[i];
}

__device__ void step_fn(const FgnArgs& a, const float x[NX],
                        const float u[NU], float out[NX]) {
  float k1[NX];
  ks_ode(x, u, a.inv_l, k1);
  if (!a.rk4) {
    axpy(x, a.dt, k1, out);
    return;
  }
  float xs[NX], k2[NX], k3[NX], k4[NX];
  axpy(x, a.half_dt, k1, xs);
  ks_ode(xs, u, a.inv_l, k2);
  axpy(x, a.half_dt, k2, xs);
  ks_ode(xs, u, a.inv_l, k3);
  axpy(x, a.dt, k3, xs);
  ks_ode(xs, u, a.inv_l, k4);
#pragma unroll
  for (int i = 0; i < NX; ++i)
    out[i] = x[i] + a.dt6 * (k1[i] + 2.f * k2[i] + 2.f * k3[i] + k4[i]);
}

// J(x) @ M for the KS Jacobian's 6 nonzeros; M is NX x NC, out NX x NC.
template <int NC>
__device__ __forceinline__ void jmul(const float x[NX], const float M[NX][NC],
                                     float inv_l, float out[NX][NC]) {
  const float delta = x[2], v = x[3], psi = x[4];
  const float t = tanf(delta), cp = cosf(psi), sp = sinf(psi);
  const float dvd = v * (1.f + t * t) * inv_l;
  const float tl = t * inv_l;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    out[0][j] = cp * M[3][j] - (v * sp) * M[4][j];
    out[1][j] = sp * M[3][j] + (v * cp) * M[4][j];
    out[2][j] = 0.f;
    out[3][j] = 0.f;
    out[4][j] = dvd * M[2][j] + tl * M[3][j];
  }
}

// Analytic (A, Bm) of the discrete step (chain rule through RK4 / Euler).
__device__ void lin_step(const FgnArgs& a, const float x[NX],
                         const float u[NU], float A[NX][NX],
                         float Bm[NX][NU]) {
  float eye[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) eye[i][j] = i == j ? 1.f : 0.f;
  float fu[NX][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) fu[i][j] = 0.f;
  fu[2][0] = 1.f;
  fu[3][1] = 1.f;

  float J[NX][NX];
  jmul<NX>(x, eye, a.inv_l, J);
  if (!a.rk4) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) A[i][j] = eye[i][j] + a.dt * J[i][j];
#pragma unroll
      for (int j = 0; j < NU; ++j) Bm[i][j] = a.dt * fu[i][j];
    }
    return;
  }
  float k1[NX], k2[NX], k3[NX], x2[NX], x3[NX], x4[NX];
  ks_ode(x, u, a.inv_l, k1);
  axpy(x, a.half_dt, k1, x2);
  ks_ode(x2, u, a.inv_l, k2);
  axpy(x, a.half_dt, k2, x3);
  ks_ode(x3, u, a.inv_l, k3);
  axpy(x, a.dt, k3, x4);

  // d k_i / d x, accumulated into A as dk1 + 2 dk2 + 2 dk3 + dk4
  float m[NX][NX], dk[NX][NX], acc[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      acc[i][j] = J[i][j];                       // dk1x
      m[i][j] = eye[i][j] + a.half_dt * J[i][j];  // m2
    }
  jmul<NX>(x2, m, a.inv_l, dk);                  // dk2x
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      acc[i][j] = acc[i][j] + 2.f * dk[i][j];
      m[i][j] = eye[i][j] + a.half_dt * dk[i][j];  // m3
    }
  jmul<NX>(x3, m, a.inv_l, dk);                  // dk3x
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      acc[i][j] = acc[i][j] + 2.f * dk[i][j];
      m[i][j] = eye[i][j] + a.dt * dk[i][j];     // m4
    }
  jmul<NX>(x4, m, a.inv_l, dk);                  // dk4x
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j)
      A[i][j] = eye[i][j] + a.dt6 * (acc[i][j] + dk[i][j]);

  // d k_i / d u: dk1u = fu; dk_{i+1}u = J(x_{i+1}) (h_i dk_i u) + fu
  float bu[NX][NU], du[NX][NU], accu[NX][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      accu[i][j] = fu[i][j];
      bu[i][j] = 0.f + a.half_dt * fu[i][j];
    }
  jmul<NU>(x2, bu, a.inv_l, du);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      du[i][j] = du[i][j] + 1.f * fu[i][j];      // dk2u
      accu[i][j] = accu[i][j] + 2.f * du[i][j];
      bu[i][j] = 0.f + a.half_dt * du[i][j];
    }
  jmul<NU>(x3, bu, a.inv_l, du);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      du[i][j] = du[i][j] + 1.f * fu[i][j];      // dk3u
      accu[i][j] = accu[i][j] + 2.f * du[i][j];
      bu[i][j] = 0.f + a.dt * du[i][j];
    }
  jmul<NU>(x4, bu, a.inv_l, du);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j)
      Bm[i][j] = a.dt6 * (accu[i][j] + (du[i][j] + 1.f * fu[i][j]));
}

// --------------------------------------------------------------------------
// constraint rows: values + closed-form gradients
// --------------------------------------------------------------------------

// friction h_f, gf = (g_delta, g_v, g_a); 9 circles (d, ux, uy, g_psi);
// boxes (u0, u1, delta, v).  Packed in this order into the rows cache.
struct Rows {
  float hf, gf[3], circ[9][4], box[4];
};

__device__ void compute_rows(const FgnArgs& a, const float x[NX],
                             const float ue[NU], const float obs[6],
                             bool is_term, bool k_is0, Rows& r) {
  const float px = x[0], py = x[1], delta = x[2], v = x[3], psi = x[4];
  const float acc = ue[1];
  const float t = tanf(delta);
  float gd, gv, ga;
  if (a.forcespro) {
    const float w = v * v * t * a.inv_l;  // v * psidot
    r.hf = acc * acc + w * w;
    gd = 2.f * w * v * v * (1.f + t * t) * a.inv_l;
    gv = 4.f * w * v * t * a.inv_l;
    ga = 2.f * acc;
  } else {  // casadi: |a^2 + v^2 tan(delta) / l|, stage 0 only
    const float s_val = acc * acc + v * v * t * a.inv_l;
    const float sg = sgn3(s_val);
    r.hf = k_is0 ? fabsf(s_val) : 0.f;
    gd = k_is0 ? sg * v * v * (1.f + t * t) * a.inv_l : 0.f;
    gv = k_is0 ? sg * 2.f * v * t * a.inv_l : 0.f;
    ga = k_is0 ? sg * 2.f * acc : 0.f;
  }
  if (is_term) ga = 0.f;  // terminal u columns are dropped
  r.gf[0] = gd;
  r.gf[1] = gv;
  r.gf[2] = ga;

  const float cp = cosf(psi), sp = sinf(psi);
  const float ks[3] = {0.f, a.d_ego, -a.d_ego};
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    const int i = p / 3;
    // all 9 pairs (forcespro) | the matched pair, 3 times (casadi)
    const float ox = a.forcespro ? obs[2 * (p % 3)] : obs[2 * i];
    const float oy = a.forcespro ? obs[2 * (p % 3) + 1] : obs[2 * i + 1];
    const float dx = px + ks[i] * cp - ox;
    const float dy = py + ks[i] * sp - oy;
    const float dist = sqrtf(dx * dx + dy * dy + 1e-9f);
    const float inv_d = 1.f / dist;
    const float ux = dx * inv_d, uy = dy * inv_d;
    r.circ[p][0] = dist;
    r.circ[p][1] = ux;
    r.circ[p][2] = uy;
    r.circ[p][3] = i == 0 ? 0.f : ks[i] * (-ux * sp + uy * cp);
  }
  r.box[0] = ue[0];
  r.box[1] = ue[1];
  r.box[2] = delta;
  r.box[3] = v;
}

__device__ __forceinline__ float row_value(const Rows& r, int i) {
  return i == 0 ? r.hf : (i < 10 ? r.circ[i - 1][0] : r.box[i - 10]);
}

__device__ void store_rows(const Lane& L, float* rows, int k, const Rows& r) {
  rows[L.at(k, 0, NROWVALS)] = r.hf;
#pragma unroll
  for (int i = 0; i < 3; ++i) rows[L.at(k, 1 + i, NROWVALS)] = r.gf[i];
#pragma unroll
  for (int p = 0; p < 9; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      rows[L.at(k, 4 + 4 * p + c, NROWVALS)] = r.circ[p][c];
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[L.at(k, 40 + i, NROWVALS)] = r.box[i];
}

__device__ void load_rows(const Lane& L, const float* rows, int k, Rows& r) {
  r.hf = rows[L.at(k, 0, NROWVALS)];
#pragma unroll
  for (int i = 0; i < 3; ++i) r.gf[i] = rows[L.at(k, 1 + i, NROWVALS)];
#pragma unroll
  for (int p = 0; p < 9; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      r.circ[p][c] = rows[L.at(k, 4 + 4 * p + c, NROWVALS)];
#pragma unroll
  for (int i = 0; i < 4; ++i) r.box[i] = rows[L.at(k, 40 + i, NROWVALS)];
}

// (lo, hi) of row i; has_lo / has_hi false for an unbounded side.
__device__ __forceinline__ void row_bounds(const FgnArgs& a, int i,
                                           bool is_term, float mind,
                                           bool& has_lo, float& lo,
                                           bool& has_hi, float& hi) {
  has_lo = has_hi = true;
  lo = hi = 0.f;
  if (i == 0) {
    lo = 0.f;
    hi = a.a_cap;
  } else if (i < 10) {
    lo = mind;
    has_hi = false;
  } else if (i == 10) {
    if (is_term) has_lo = has_hi = false;
    lo = a.u_lo0;
    hi = a.u_hi0;
  } else if (i == 11) {
    if (is_term) has_lo = has_hi = false;
    lo = a.u_lo1;
    hi = a.u_hi1;
  } else if (i == 12) {
    lo = a.d_lo;
    hi = a.d_hi;
  } else {
    lo = a.v_lo;
    hi = a.v_hi;
  }
}

// AL terms of one side: psi = (m^2 - lam^2) / (2 mu), grad = +-m, gn.
__device__ __forceinline__ void al_one_sided(float h, float bound, float lam,
                                             float mu, bool is_hi, float& psi,
                                             float& grad, float& gn) {
  const float c = is_hi ? h - bound : bound - h;
  const float t = lam + mu * c;
  const bool act = t > 0.f;
  const float m = act ? t : 0.f;
  psi = (m * m - lam * lam) / (2.f * mu);
  grad = is_hi ? m : -m;
  gn = act ? mu : 0.f;
}

// Per row: psi, d psi / d h and the GN diagonal, summed over its sides.
__device__ void row_terms(const FgnArgs& a, const Rows& r, bool is_term,
                          float mind, const float lam_lo[NR],
                          const float lam_hi[NR], const float mu[NR],
                          float psi[NR], float gh[NR], float gn[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    bool has_lo, has_hi;
    float lo, hi;
    row_bounds(a, i, is_term, mind, has_lo, lo, has_hi, hi);
    const float h = row_value(r, i);
    float ps = 0.f, g = 0.f, n = 0.f, p1, g1, n1;
    if (has_hi) {
      al_one_sided(h, hi, lam_hi[i], mu[i], true, p1, g1, n1);
      ps = ps + p1;
      g = g + g1;
      n = n + n1;
    }
    if (has_lo) {
      al_one_sided(h, lo, lam_lo[i], mu[i], false, p1, g1, n1);
      ps = ps + p1;
      g = g + g1;
      n = n + n1;
    }
    psi[i] = ps;
    gh[i] = g;
    gn[i] = n;
  }
}

__device__ __forceinline__ float sum_psi(const float psi[NR]) {
  float s = psi[0];
#pragma unroll
  for (int i = 1; i < NR; ++i) s = s + psi[i];
  return s;
}

__device__ __forceinline__ float stage_cost(const float x[NX],
                                            const float u[NU],
                                            const float xref[NX],
                                            const float wq[NX],
                                            const float wr[NU]) {
  float c = wq[0] * (x[0] - xref[0]) * (x[0] - xref[0]);
#pragma unroll
  for (int i = 1; i < NX; ++i) c = c + wq[i] * (x[i] - xref[i]) * (x[i] - xref[i]);
#pragma unroll
  for (int i = 0; i < NU; ++i) c = c + wr[i] * u[i] * u[i];
  return c;
}

__device__ __forceinline__ float term_cost(const float x[NX],
                                           const float xref[NX],
                                           const float wqN[NX]) {
  float c = wqN[0] * (x[0] - xref[0]) * (x[0] - xref[0]);
#pragma unroll
  for (int i = 1; i < NX; ++i)
    c = c + wqN[i] * (x[i] - xref[i]) * (x[i] - xref[i]);
  return c;
}

// GN quadratic of cost + AL rows at one stage.  Non-terminal: Q, R, M, qx,
// qu with the stage weights; terminal: Q, qx only, with wqN when use_cost.
__device__ void assemble_quad(const Rows& r, const float gh[NR],
                              const float gn[NR], const float x[NX],
                              const float ue[NU], const float xref[NX],
                              const float w[NX], const float wr[NU],
                              bool is_term, bool use_cost, float Q[NX][NX],
                              float R[NU][NU], float M[NX][NU], float qx[NX],
                              float qu[NU]) {
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    qx[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NX; ++j) Q[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NU; ++j) M[i][j] = 0.f;
  }
  R[0][0] = R[0][1] = R[1][0] = R[1][1] = 0.f;
  qu[0] = qu[1] = 0.f;

  {  // friction row -> (delta, v, a)
    const float gd = r.gf[0], gv = r.gf[1], ga = r.gf[2];
    Q[2][2] = Q[2][2] + gn[0] * gd * gd;
    Q[2][3] = Q[2][3] + gn[0] * gd * gv;
    Q[3][3] = Q[3][3] + gn[0] * gv * gv;
    qx[2] = qx[2] + gh[0] * gd;
    qx[3] = qx[3] + gh[0] * gv;
    if (!is_term) {
      R[1][1] = R[1][1] + gn[0] * ga * ga;
      M[2][1] = M[2][1] + gn[0] * gd * ga;
      M[3][1] = M[3][1] + gn[0] * gv * ga;
      qu[1] = qu[1] + gh[0] * ga;
    }
  }
#pragma unroll
  for (int p = 0; p < 9; ++p) {  // circle rows -> (px, py, psi)
    const float ux = r.circ[p][1], uy = r.circ[p][2], gp = r.circ[p][3];
    const float h = gh[1 + p], n = gn[1 + p];
    Q[0][0] = Q[0][0] + n * ux * ux;
    Q[0][1] = Q[0][1] + n * ux * uy;
    Q[1][1] = Q[1][1] + n * uy * uy;
    Q[0][4] = Q[0][4] + n * ux * gp;
    Q[1][4] = Q[1][4] + n * uy * gp;
    Q[4][4] = Q[4][4] + n * gp * gp;
    qx[0] = qx[0] + h * ux;
    qx[1] = qx[1] + h * uy;
    qx[4] = qx[4] + h * gp;
  }
  if (!is_term) {  // box rows u0, u1
    R[0][0] = R[0][0] + gn[10];
    qu[0] = qu[0] + gh[10];
    R[1][1] = R[1][1] + gn[11];
    qu[1] = qu[1] + gh[11];
  }
  Q[2][2] = Q[2][2] + gn[12];  // box rows delta, v
  qx[2] = qx[2] + gh[12];
  Q[3][3] = Q[3][3] + gn[13];
  qx[3] = qx[3] + gh[13];

  if (!is_term || use_cost) {  // quadratic cost: exact Hessian
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      Q[i][i] = Q[i][i] + 2.f * w[i];
      qx[i] = qx[i] + 2.f * w[i] * (x[i] - xref[i]);
    }
  }
  if (!is_term) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      R[i][i] = R[i][i] + 2.f * wr[i];
      qu[i] = qu[i] + 2.f * wr[i] * ue[i];
    }
  }
  Q[1][0] = Q[0][1];
  Q[3][2] = Q[2][3];
  Q[4][0] = Q[0][4];
  Q[4][1] = Q[1][4];
}

// --------------------------------------------------------------------------
// the kernel
// --------------------------------------------------------------------------

struct Bufs {
  const float *x0, *xref, *obs, *mind, *w;
  float *U, *lam_lo, *lam_hi, *mu, *pviol, *X, *diag, *K, *d, *rows, *Xc,
      *Uc;
  int32_t* rung;  // (al_iters * sqp_iters, B) or null
};

// Per-lane solve state and accessors.
struct Solve {
  const FgnArgs& a;
  const Bufs& b;
  Lane L;
  float wq[NX], wr[NU], wqN[NX], x0[NX], mind;

  __device__ Solve(const FgnArgs& a_, const Bufs& b_, int lane)
      : a(a_), b(b_) {
    L.B = a.B;
    L.lane = lane;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      wq[i] = b.w[L.at(0, i, 1)];
      wqN[i] = b.w[L.at(0, NX + NU + i, 1)];
      x0[i] = b.x0[L.at(0, i, 1)];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) wr[i] = b.w[L.at(0, NX + i, 1)];
    mind = b.mind[L.at(0, 0, 1)];
  }

  __device__ void obs_at(int k, float o[6]) const {
#pragma unroll
    for (int i = 0; i < 6; ++i)
      o[i] = a.moving ? b.obs[L.at(k, i, 6)] : b.obs[L.at(0, i, 6)];
  }
  __device__ __forceinline__ void load(const float* p, int k, int n,
                                       float* out) const {
#pragma unroll
    for (int i = 0; i < n; ++i) out[i] = p[L.at(k, i, n)];
  }
  __device__ __forceinline__ void store(float* p, int k, int n,
                                        const float* v) const {
#pragma unroll
    for (int i = 0; i < n; ++i) p[L.at(k, i, n)] = v[i];
  }
  __device__ void refs(int k, float xref[NX], float ll[NR], float lh[NR],
                       float mu[NR]) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) xref[i] = b.xref[L.at(k, i, NX)];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      ll[i] = b.lam_lo[L.at(k, i, NR)];
      lh[i] = b.lam_hi[L.at(k, i, NR)];
      mu[i] = b.mu[L.at(k, i, NR)];
    }
  }

  // Rows of stage k at (x, u), fresh or from the cache.
  __device__ void rows_at(int k, const float x[NX], const float u[NU],
                          bool cached, bool is_term, Rows& r) const {
    if (cached) {
      load_rows(L, b.rows, k, r);
    } else {
      float o[6];
      obs_at(k, o);
      compute_rows(a, x, u, o, is_term, k == 0, r);
    }
  }

  // cost + AL psi of one stage of a trial chain
  __device__ float stage_merit(int k, const float x[NX], const float u[NU],
                               bool is_term) const {
    float xref[NX], ll[NR], lh[NR], mu[NR], psi[NR], gh[NR], gn[NR];
    refs(k, xref, ll, lh, mu);
    Rows r;
    rows_at(k, x, u, false, is_term, r);
    row_terms(a, r, is_term, mind, ll, lh, mu, psi, gh, gn);
    const float p = sum_psi(psi);
    float c;
    if (is_term)
      c = a.use_term ? term_cost(x, xref, wqN) : 0.f;
    else
      c = stage_cost(x, u, xref, wq, wr);
    return c + p;
  }

  __device__ void initial_rollout() const {
    float x[NX], u[NU], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    Rows r;
    for (int k = 0; k < a.H; ++k) {
      store(b.X, k, NX, x);
      load(b.U, k, NU, u);
      rows_at(k, x, u, false, false, r);
      store_rows(L, b.rows, k, r);
      step_fn(a, x, u, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    store(b.X, a.H, NX, x);
    const float zu[NU] = {0.f, 0.f};
    rows_at(a.H, x, zu, false, true, r);
    store_rows(L, b.rows, a.H, r);
  }

  // Riccati backward sweep at the current iterate -> K, d (scrubbed of
  // NaN/inf when ``scrub``: the recursion itself uses the raw gains).
  __device__ void backward_sweep(bool cached, bool scrub) const {
    const int H = a.H;
    float P[NX][NX], p[NX];
    {
      float xT[NX], xref[NX], ll[NR], lh[NR], mu[NR], psi[NR], gh[NR],
          gn[NR], R[NU][NU], M[NX][NU], qu[NU];
      const float zu[NU] = {0.f, 0.f};
      load(b.X, H, NX, xT);
      refs(H, xref, ll, lh, mu);
      Rows r;
      rows_at(H, xT, zu, cached, true, r);
      row_terms(a, r, true, mind, ll, lh, mu, psi, gh, gn);
      assemble_quad(r, gh, gn, xT, zu, xref, wqN, wr, true, a.use_term != 0,
                    P, R, M, p, qu);
    }
    for (int k = H - 1; k >= 0; --k) {
      float x[NX], u[NU], xref[NX], ll[NR], lh[NR], mu[NR];
      load(b.X, k, NX, x);
      load(b.U, k, NU, u);
      refs(k, xref, ll, lh, mu);
      float Q[NX][NX], R[NU][NU], M[NX][NU], qx[NX], qu[NU];
      {
        float psi[NR], gh[NR], gn[NR];
        Rows r;
        rows_at(k, x, u, cached, false, r);
        row_terms(a, r, false, mind, ll, lh, mu, psi, gh, gn);
        assemble_quad(r, gh, gn, x, u, xref, wq, wr, false, true, Q, R, M,
                      qx, qu);
      }
      float A[NX][NX], Bm[NX][NU];
      lin_step(a, x, u, A, Bm);

      float PA[NX][NX], PB[NX][NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < NX; ++t) s += P[i][t] * A[t][j];
          PA[i][j] = s;
        }
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < NX; ++t) s += P[i][t] * Bm[t][j];
          PB[i][j] = s;
        }
      }
      float Quu[NU][NU], Qux[NU][NX], gu[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < NX; ++t) s += Bm[t][i] * PB[t][j];
          Quu[i][j] = R[i][j] + s;
        }
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < NX; ++t) s += Bm[t][i] * PA[t][j];
          Qux[i][j] = M[j][i] + s;
        }
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < NX; ++t) s += Bm[t][i] * p[t];
        gu[i] = qu[i] + s;
      }
      const float aa = Quu[0][0] + a.reg, bb = Quu[0][1], cc = Quu[1][0],
                  dd = Quu[1][1] + a.reg;
      const float inv_det = 1.f / (aa * dd - bb * cc);
      const float Qi[NU][NU] = {{dd * inv_det, -bb * inv_det},
                                {-cc * inv_det, aa * inv_det}};
      float Kk[NU][NX], dk[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j)
          Kk[i][j] = -(Qi[i][0] * Qux[0][j] + Qi[i][1] * Qux[1][j]);
        dk[i] = -(Qi[i][0] * gu[0] + Qi[i][1] * gu[1]);
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const float kv = Kk[i][j];
          b.K[L.at(k, i * NX + j, NU * NX)] = (scrub && !finite_f32(kv)) ? 0.f : kv;
        }
        b.d[L.at(k, i, NU)] = (scrub && !finite_f32(dk[i])) ? 0.f : dk[i];
      }
      // P <- sym(Qxx + Qux' K), p <- gx + Qux' d
      float Pn[NX][NX], pn[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < NX; ++t) s += A[t][i] * PA[t][j];
          Pn[i][j] = Q[i][j] + s + Qux[0][i] * Kk[0][j] + Qux[1][i] * Kk[1][j];
        }
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < NX; ++t) s += A[t][i] * p[t];
        pn[i] = qx[i] + s + Qux[0][i] * dk[0] + Qux[1][i] * dk[1];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        p[i] = pn[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) P[i][j] = 0.5f * (Pn[i][j] + Pn[j][i]);
      }
    }
  }

  // Feedback rollout u = clip(ub + alpha d + K (x - xb)) from x0 against
  // the current iterate (X, U).  Writes the chain to (Xo, Uo), which may
  // be X, U themselves (the unguarded step, alpha unused: ub + d + K dx).
  // Returns the merit when ``merit`` is set.
  __device__ float feedback_rollout(float alpha, bool unguarded, float* Xo,
                                    float* Uo, bool merit) const {
    float x[NX], xn[NX], xb[NX], ub[NU], u[NU], Kk[NU * NX], dk[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    float acc = 0.f;
    for (int k = 0; k < a.H; ++k) {
      load(b.X, k, NX, xb);
      load(b.U, k, NU, ub);
      load(b.K, k, NU * NX, Kk);
      load(b.d, k, NU, dk);
      float dx[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) dx[i] = x[i] - xb[i];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float fb = 0.f;
#pragma unroll
        for (int j = 0; j < NX; ++j) fb += Kk[i * NX + j] * dx[j];
        u[i] = (unguarded ? ub[i] + dk[i] : ub[i] + alpha * dk[i]) + fb;
      }
      u[0] = clipf(u[0], a.u_lo0, a.u_hi0);
      u[1] = clipf(u[1], a.u_lo1, a.u_hi1);
      if (merit) acc = acc + stage_merit(k, x, u, false);
      step_fn(a, x, u, xn);
      store(Xo, k, NX, x);
      store(Uo, k, NU, u);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    if (merit) {
      const float zu[NU] = {0.f, 0.f};
      acc = acc + stage_merit(a.H, x, zu, true);
    }
    store(Xo, a.H, NX, x);
    return acc;
  }

  // it: the GN iteration's index over the whole solve
  __device__ void ladder(int it) const {
    const size_t xs = (size_t)(a.H + 1) * NX * a.B;
    const size_t us = (size_t)a.H * NU * a.B;
    int best = 0, best_rung = 0;
    float best_m = feedback_rollout(0.f, false, b.Xc, b.Uc, true);
    for (int r = 0; r < a.n_alphas; ++r) {
      const int trial = 1 - best;
      const float m = feedback_rollout(a.alphas[r], false, b.Xc + trial * xs,
                                       b.Uc + trial * us, true);
      if (m < best_m) {
        best_m = m;
        best = trial;
        best_rung = r + 1;
      }
    }
    if (b.rung) b.rung[(size_t)it * a.B + L.lane] = best_rung;
    float v[NX];
    for (int k = 0; k <= a.H; ++k) {
      load(b.Xc + best * xs, k, NX, v);
      store(b.X, k, NX, v);
    }
    for (int k = 0; k < a.H; ++k) {
      load(b.Uc + best * us, k, NU, v);
      store(b.U, k, NU, v);
    }
  }

  // Multiplier / penalty update at all stages; caches the rows (stage H:
  // inputs masked to 0, u-box rows 10 and 11 left unchanged).
  __device__ void multiplier_update() const {
    const int H = a.H;
    for (int k = 0; k <= H; ++k) {
      const bool is_last = k == H;
      float x[NX], u[NU], xref[NX], ll[NR], lh[NR], mu[NR], pv[NR];
      load(b.X, k, NX, x);
      load(b.U, k < H ? k : H - 1, NU, u);
      if (is_last) u[0] = u[1] = 0.f;
      refs(k, xref, ll, lh, mu);
      load(b.pviol, k, NR, pv);
      Rows r;
      rows_at(k, x, u, false, false, r);
      store_rows(L, b.rows, k, r);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        bool has_lo, has_hi;
        float lo, hi;
        row_bounds(a, i, false, mind, has_lo, lo, has_hi, hi);
        const float h = row_value(r, i);
        float nh = lh[i], nl = ll[i], v_hi = 0.f, v_lo = 0.f;
        if (has_hi) {
          nh = clipf(relu(lh[i] + mu[i] * (h - hi)), 0.f, a.lam_max);
          v_hi = nmax(h - hi, 0.f);
        }
        if (has_lo) {
          nl = clipf(relu(ll[i] + mu[i] * (lo - h)), 0.f, a.lam_max);
          v_lo = nmax(lo - h, 0.f);
        }
        float viol = nmax(v_hi, v_lo);
        if ((i == 10 || i == 11) && is_last) {
          nh = lh[i];
          nl = ll[i];
          viol = 0.f;
        }
        const bool stalled = viol > a.viol_improve * pv[i];
        const bool active = viol > a.tol_feas;
        const float m_new =
            clipf(stalled && active ? mu[i] * a.mu_factor : mu[i], a.mu0,
                  a.mu_max);
        b.lam_lo[L.at(k, i, NR)] = nl;
        b.lam_hi[L.at(k, i, NR)] = nh;
        b.mu[L.at(k, i, NR)] = m_new;
        b.pviol[L.at(k, i, NR)] = viol;
      }
    }
  }

  __device__ float scaled_viol(const Rows& r, bool is_term, float v) const {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      bool has_lo, has_hi;
      float lo, hi;
      row_bounds(a, i, is_term, mind, has_lo, lo, has_hi, hi);
      const float s = i == 0 ? a.inv_fr_scale : 1.f;
      const float h = row_value(r, i);
      if (has_hi) v = nmax(v, (h - hi) * s);
      if (has_lo) v = nmax(v, (lo - h) * s);
    }
    return v;
  }

  // stat (adjoint stationarity), viol, cost, merit from the cached rows.
  __device__ void diagnostics() const {
    const int H = a.H;
    float lam[NX], stat = 0.f, viol, cost, merit;
    {
      float xT[NX], xref[NX], ll[NR], lh[NR], mu[NR], psi[NR], gh[NR],
          gn[NR], Q[NX][NX], R[NU][NU], M[NX][NU], qu[NU];
      const float zu[NU] = {0.f, 0.f};
      load(b.X, H, NX, xT);
      refs(H, xref, ll, lh, mu);
      Rows r;
      rows_at(H, xT, zu, true, true, r);
      row_terms(a, r, true, mind, ll, lh, mu, psi, gh, gn);
      assemble_quad(r, gh, gn, xT, zu, xref, wqN, wr, true, a.use_term != 0,
                    Q, R, M, lam, qu);
      const float psi_T = sum_psi(psi);
      const float cost_T = a.use_term ? term_cost(xT, xref, wqN) : 0.f;
      viol = nmax(scaled_viol(r, true, 0.f), 0.f);
      cost = cost_T;
      merit = cost_T + psi_T;
    }
    for (int k = H - 1; k >= 0; --k) {
      float x[NX], u[NU], xref[NX], ll[NR], lh[NR], mu[NR], psi[NR], gh[NR],
          gn[NR], Q[NX][NX], R[NU][NU], M[NX][NU], qx[NX], qu[NU];
      load(b.X, k, NX, x);
      load(b.U, k, NU, u);
      refs(k, xref, ll, lh, mu);
      Rows r;
      rows_at(k, x, u, true, false, r);
      row_terms(a, r, false, mind, ll, lh, mu, psi, gh, gn);
      assemble_quad(r, gh, gn, x, u, xref, wq, wr, false, true, Q, R, M, qx,
                    qu);
      float A[NX][NX], Bm[NX][NU];
      lin_step(a, x, u, A, Bm);
      float g_u[NU], lam_new[NX];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < NX; ++t) s += Bm[t][i] * lam[t];
        g_u[i] = qu[i] + s;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < NX; ++t) s += A[t][i] * lam[t];
        lam_new[i] = qx[i] + s;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) lam[i] = lam_new[i];
      stat = nmax(stat, nmax(fabsf(g_u[0]), fabsf(g_u[1])));
      viol = scaled_viol(r, false, viol);
      const float c = stage_cost(x, u, xref, wq, wr);
      cost = cost + c;
      merit = merit + c + sum_psi(psi);
    }
    b.diag[L.at(0, 0, 4)] = stat;
    b.diag[L.at(0, 1, 4)] = viol;
    b.diag[L.at(0, 2, 4)] = cost;
    b.diag[L.at(0, 3, 4)] = merit;
  }
};

// __grid_constant__: the Solve object keeps references to the parameters,
// which then stay in the constant bank instead of a local copy.
__global__ void fused_gn_kernel(const __grid_constant__ FgnArgs a,
                                const __grid_constant__ Bufs b) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  Solve s(a, b, lane);
  s.initial_rollout();
  for (int ai = 0; ai < a.al_iters; ++ai) {
    for (int si = 0; si < a.sqp_iters; ++si) {
      // the first GN iteration of each AL iteration reads the rows cached
      // by the initial rollout (ai = 0) or the multiplier update (ai > 0)
      const bool unguarded = a.n_alphas == 0;
      s.backward_sweep(si == 0, unguarded);
      if (unguarded)
        s.feedback_rollout(1.f, true, b.X, b.U, false);
      else
        s.ladder(ai * a.sqp_iters + si);
    }
    s.multiplier_update();
  }
  s.diagnostics();
}

extern "C" int fused_gn_solve(const FgnArgs* args, const float* x0,
                              const float* xref, const float* obs,
                              const float* mind, const float* w, float* U,
                              float* lam_lo, float* lam_hi, float* mu,
                              float* pviol, float* X, float* diag, float* K,
                              float* d, float* rows, float* Xc, float* Uc,
                              int32_t* rung, void* stream) {
  Bufs b{x0, xref, obs, mind, w, U,  lam_lo, lam_hi, mu,
         pviol, X, diag, K, d, rows, Xc, Uc, rung};
  const int threads = args->threads > 0 ? args->threads : 64;
  const int blocks = (args->B + threads - 1) / threads;
  fused_gn_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args, b);
  return (int)cudaGetLastError();
}
