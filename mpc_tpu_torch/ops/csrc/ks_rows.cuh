// ks_rows.cuh — device helpers shared by the fused AL-SQP kernel
// (fused_gn.cu) and the fused IP-RTI kernel (fused_ip.cu).
//
// The counterparts of the row-list helpers that mpc_tpu/ops/fused_gn.py
// shares between its two Pallas kernels: the KS model and its discrete step,
// the analytic (A, B) of that step, the constraint rows with their
// closed-form gradients, the row bounds, the stage costs,
// the sparse stage quadratic and one step of the Riccati sweep.  Each helper
// that reads per-config constants is a template over the kernel's argument
// block, which names them the same in both kernels.
//
// The helpers that do not depend on the model (the rows, which read the
// first five states only, the stage costs, the quadratic, the Riccati
// step) are templates over the state count N, so that the ST model's
// instances (st_model.cuh, N = 7) share them; KsModel is the KS model's
// policy type, which the kernels take as a template parameter.
//
// Road-boundary rows: a stage of a kernel's boundary instance has 6 more
// rows (NR + NB_ROWS), each the model nx cx + ny cy + c0 of a signed
// distance on an ego circle centre, from the stage's 18 floats of
// linear models (fused_gn.py::linearize_boundaries).  They are added as
// overloads and template instances (BndRows, row_value, row_bounds_of,
// assemble_quad), so that the instances without them compile as before.
//
// Semantics kept from the TPU kernels on purpose: clips, maxima, minima and
// signs propagate NaN (compares, not fminf/fmaxf).  Build without
// --use_fast_math: the parity bands assume IEEE tanf, sqrtf, sinf, cosf and
// division.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define NX 5  // the KS model's states
#define NU 2
#define NR 14
#define MAX_ALPHAS 16
#define NB_ROWS 6     // road-boundary rows a stage: 3 circles x 2 boundaries
#define NBND 18       // floats of their models a stage: [nx, ny, c0] x 6

// --------------------------------------------------------------------------
// NaN-propagating scalar helpers (jnp semantics)
// --------------------------------------------------------------------------

__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;  // NaN in either operand -> NaN
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;  // NaN in either operand -> NaN
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

template <class Args>
__device__ void step_fn(const Args& a, const float x[NX], const float u[NU],
                        float out[NX]) {
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
template <class Args>
__device__ void lin_step(const Args& a, const float x[NX], const float u[NU],
                         float A[NX][NX], float Bm[NX][NU]) {
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
// boxes (u0, u1, delta, v).  The rows read the first five states of x
// (px, py, delta, v, psi), the same in both models.
struct Rows {
  float hf, gf[3], circ[9][4], box[4];
};

template <class Args>
__device__ void compute_rows(const Args& a, const float* x,
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

// The rows with the 6 road-boundary rows (hb, nx, ny, g_psi), circle-major:
// row NR + 2 i + j is circle i (offset 0, +d, -d along the heading) and
// boundary j.
struct BndRows : Rows {
  float bnd[NB_ROWS][4];
};
template <bool BND>
using RowsOf = typename std::conditional<BND, BndRows, Rows>::type;
template <bool BND>
__host__ __device__ constexpr int nrows() {
  return BND ? NR + NB_ROWS : NR;
}

// The boundary rows at x from the stage's models m[18] ([nx, ny, c0] a row),
// with the circle rows' (px, py, psi) gradient.
template <class Args>
__device__ void boundary_rows(const Args& a, const float* x,
                              const float m[NBND], BndRows& r) {
  const float px = x[0], py = x[1], psi = x[4];
  const float cp = cosf(psi), sp = sinf(psi);
  const float ks[3] = {0.f, a.d_ego, -a.d_ego};
#pragma unroll
  for (int idx = 0; idx < NB_ROWS; ++idx) {
    const int i = idx / 2;
    const float nx = m[3 * idx], ny = m[3 * idx + 1], c0 = m[3 * idx + 2];
    const float cx = px + ks[i] * cp, cy = py + ks[i] * sp;
    r.bnd[idx][0] = nx * cx + ny * cy + c0;
    r.bnd[idx][1] = nx;
    r.bnd[idx][2] = ny;
    r.bnd[idx][3] = i == 0 ? 0.f : ks[i] * (-nx * sp + ny * cp);
  }
}

__device__ __forceinline__ float row_value(const BndRows& r, int i) {
  return i < NR ? row_value(static_cast<const Rows&>(r), i)
                : r.bnd[i - NR][0];
}

// (lo, hi) of row i; has_lo / has_hi false for an unbounded side.
template <class Args>
__device__ __forceinline__ void row_bounds(const Args& a, int i, bool is_term,
                                           float mind, bool& has_lo,
                                           float& lo, bool& has_hi,
                                           float& hi) {
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

// (lo, hi) of row i of a stage with (BND) or without the boundary rows,
// whose bound is r_ego <= h.
template <bool BND, class Args>
__device__ __forceinline__ void row_bounds_of(const Args& a, int i,
                                              bool is_term, float mind,
                                              bool& has_lo, float& lo,
                                              bool& has_hi, float& hi) {
  if (BND && i >= NR) {
    has_lo = true;
    lo = a.r_ego;
    has_hi = false;
    hi = 0.f;
    return;
  }
  row_bounds(a, i, is_term, mind, has_lo, lo, has_hi, hi);
}

template <int N>
__device__ __forceinline__ float stage_cost(const float x[N],
                                            const float u[NU],
                                            const float xref[N],
                                            const float wq[N],
                                            const float wr[NU]) {
  float c = wq[0] * (x[0] - xref[0]) * (x[0] - xref[0]);
#pragma unroll
  for (int i = 1; i < N; ++i)
    c = c + wq[i] * (x[i] - xref[i]) * (x[i] - xref[i]);
#pragma unroll
  for (int i = 0; i < NU; ++i) c = c + wr[i] * u[i] * u[i];
  return c;
}

template <int N>
__device__ __forceinline__ float term_cost(const float x[N],
                                           const float xref[N],
                                           const float wqN[N]) {
  float c = wqN[0] * (x[0] - xref[0]) * (x[0] - xref[0]);
#pragma unroll
  for (int i = 1; i < N; ++i)
    c = c + wqN[i] * (x[i] - xref[i]) * (x[i] - xref[i]);
  return c;
}

// Quadratic of cost + rows at one stage, each row i entering with its
// gradient weight gh[i] and its curvature gn[i] (the AL terms' d psi / d h
// and GN diagonal, or the IP's barrier weight and z / s).  Non-terminal: Q,
// R, M, qx, qu with the stage weights; terminal: Q, qx only, with wqN when
// use_cost.  RowsT: Rows, or BndRows, whose boundary rows enter after the
// box rows.  N states: the rows touch the first five, the weights all.
template <class RowsT, int N>
__device__ void assemble_quad(const RowsT& r, const float* gh,
                              const float* gn, const float x[N],
                              const float ue[NU], const float xref[N],
                              const float w[N], const float wr[NU],
                              bool is_term, bool use_cost, float Q[N][N],
                              float R[NU][NU], float M[N][NU], float qx[N],
                              float qu[NU]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    qx[i] = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) Q[i][j] = 0.f;
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
  if constexpr (std::is_same<RowsT, BndRows>::value) {
#pragma unroll
    for (int b = 0; b < NB_ROWS; ++b) {  // boundary rows -> (px, py, psi)
      const float nx = r.bnd[b][1], ny = r.bnd[b][2], gp = r.bnd[b][3];
      const float h = gh[NR + b], n = gn[NR + b];
      Q[0][0] = Q[0][0] + n * nx * nx;
      Q[0][1] = Q[0][1] + n * nx * ny;
      Q[1][1] = Q[1][1] + n * ny * ny;
      Q[0][4] = Q[0][4] + n * nx * gp;
      Q[1][4] = Q[1][4] + n * ny * gp;
      Q[4][4] = Q[4][4] + n * gp * gp;
      qx[0] = qx[0] + h * nx;
      qx[1] = qx[1] + h * ny;
      qx[4] = qx[4] + h * gp;
    }
  }

  if (!is_term || use_cost) {  // quadratic cost: exact Hessian
#pragma unroll
    for (int i = 0; i < N; ++i) {
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
// one step of the Riccati backward sweep
// --------------------------------------------------------------------------

// Given the cost-to-go (P, p) of stage k+1, the stage quadratic (Q, R, M,
// qx, qu) and the dynamics (A, Bm) of stage k: the gains Kk, dk (closed-form
// 2x2 Quu inverse) and, in place, P <- sym(Qxx + Qux' K), p <- gx + Qux' d.
template <int N>
__device__ __forceinline__ void riccati_step(
    float reg, float P[N][N], float p[N], const float Q[N][N],
    const float R[NU][NU], const float M[N][NU], const float qx[N],
    const float qu[NU], const float A[N][N], const float Bm[N][NU],
    float Kk[NU][N], float dk[NU]) {
  float PA[N][N], PB[N][NU];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < N; ++t) s += P[i][t] * A[t][j];
      PA[i][j] = s;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < N; ++t) s += P[i][t] * Bm[t][j];
      PB[i][j] = s;
    }
  }
  float Quu[NU][NU], Qux[NU][N], gu[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < N; ++t) s += Bm[t][i] * PB[t][j];
      Quu[i][j] = R[i][j] + s;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < N; ++t) s += Bm[t][i] * PA[t][j];
      Qux[i][j] = M[j][i] + s;
    }
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < N; ++t) s += Bm[t][i] * p[t];
    gu[i] = qu[i] + s;
  }
  const float aa = Quu[0][0] + reg, bb = Quu[0][1], cc = Quu[1][0],
              dd = Quu[1][1] + reg;
  const float inv_det = 1.f / (aa * dd - bb * cc);
  const float Qi[NU][NU] = {{dd * inv_det, -bb * inv_det},
                            {-cc * inv_det, aa * inv_det}};
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      Kk[i][j] = -(Qi[i][0] * Qux[0][j] + Qi[i][1] * Qux[1][j]);
    dk[i] = -(Qi[i][0] * gu[0] + Qi[i][1] * gu[1]);
  }
  float Pn[N][N], pn[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < N; ++t) s += A[t][i] * PA[t][j];
      Pn[i][j] = Q[i][j] + s + Qux[0][i] * Kk[0][j] + Qux[1][i] * Kk[1][j];
    }
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < N; ++t) s += A[t][i] * p[t];
    pn[i] = qx[i] + s + Qux[0][i] * dk[0] + Qux[1][i] * dk[1];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[i] = pn[i];
#pragma unroll
    for (int j = 0; j < N; ++j) P[i][j] = 0.5f * (Pn[i][j] + Pn[j][i]);
  }
}

// --------------------------------------------------------------------------
// the KS model's policy type
// --------------------------------------------------------------------------

// What a kernel asks of its model: the state count N and the discrete step;
// the KS kernels build (A, B) with lin_step's analytic chain rule, the ST
// ones with StModel::lin (st_model.cuh).
struct KsModel {
  static constexpr int N = NX;
  static constexpr bool ST = false;
  template <class Args>
  static __device__ __forceinline__ void step(const Args& a, const float x[N],
                                              const float u[NU],
                                              float out[N]) {
    step_fn(a, x, u, out);
  }
};
