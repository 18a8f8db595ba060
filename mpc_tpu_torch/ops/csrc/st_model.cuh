// st_model.cuh — the 7-state single-track model with tire dynamics (ST) for
// the fused kernels (fused_gn_st.cu, fused_ip_st.cu): the device helpers of
// mpc_tpu/ops/fused_gn.py:285-504 (_Dual, _st_ode_d, _st_step_rows,
// _st_lin_step), which both Pallas kernels call for model='st'.
//
// State x = [px, py, delta, v, psi, psiDot, beta], input u = [deltaDot, a].
// The ODE is written once, as a template over its scalar type: on floats
// it gives the rollouts, on forward-mode dual numbers the exact (A, B) of
// the RK4 / Euler step (the plain PyTorch version is fused_gn.py's _Dual,
// _st_step_rows and _st_lin_step).  Both of its branches are evaluated and
// selected per lane, value and tangents together (|v| < 0.1: the low-speed
// kinematic branch); the tire branch divides by v floored at 1e-3 in
// magnitude, a clamp of the value alone, the tangents kept.  The low-speed
// slip rate is the JAX kernels' (1 + (tan(delta) lr / l)^2 in its
// denominator; models/dynamics.py's st_ode has 1 + (tan^2(delta) lr / l)^2).
//
// Rounding kept from the reference on purpose: a quotient a / b of the
// ODE is a * (1 / b), as the reference's dual type divides; each product
// of vehicle parameters is formed once in double precision on the host
// (StConsts, fused_gn.py::st_consts) and enters as a float.
//
// Registers.  A dual over all 9 seed directions (7 states, 2 inputs) is 10
// floats, and an RK4 step carries three arrays of 7 of them besides the
// ODE's temporaries, so the dual step spills at the kernels' register caps.
// StModel::lin runs it as one pass all the same, as the reference does, and
// hands each entry of (A, B) to the caller's ``put(i, j, value)`` (j < 7:
// column j of A; j >= 7: column j - 7 of B).  On the card passes of fewer
// directions, with fewer spills, were slower in both kernels (PERF.md).
#pragma once

#include "ks_rows.cuh"

#define NX_ST 7              // the ST model's states
#define NS_ST (NX_ST + NU)   // seed directions of its (A, B)

// Products of vehicle parameters, in the order of fused_gn.py::ST_CONSTS
// (zero in a KS solve's argument block).
struct StConsts {
  float lr_l, inv_l, lr, l, h, g_lr, g_lf, c5_lf, c5_lr, c5_r, c5_f, mu_l,
      sr_lr, sf_lf, c_sr, c_sf;
};

// --------------------------------------------------------------------------
// forward-mode dual numbers over NT seed directions; a float operand is a
// constant
// --------------------------------------------------------------------------

template <int NT>
struct Dual {
  float v, t[NT];
};

__device__ __forceinline__ float val(float x) { return x; }
template <int NT>
__device__ __forceinline__ float val(const Dual<NT>& x) {
  return x.v;
}

template <int NT>
__device__ __forceinline__ Dual<NT> operator+(const Dual<NT>& a,
                                              const Dual<NT>& b) {
  Dual<NT> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.t[i] = a.t[i] + b.t[i];
  return r;
}
template <int NT>
__device__ __forceinline__ Dual<NT> operator+(const Dual<NT>& a, float c) {
  Dual<NT> r = a;
  r.v = a.v + c;
  return r;
}
template <int NT>
__device__ __forceinline__ Dual<NT> operator+(float c, const Dual<NT>& a) {
  return a + c;
}
template <int NT>
__device__ __forceinline__ Dual<NT> operator-(const Dual<NT>& a,
                                              const Dual<NT>& b) {
  Dual<NT> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.t[i] = a.t[i] - b.t[i];
  return r;
}
template <int NT>
__device__ __forceinline__ Dual<NT> operator-(const Dual<NT>& a, float c) {
  Dual<NT> r = a;
  r.v = a.v - c;
  return r;
}
template <int NT>
__device__ __forceinline__ Dual<NT> operator-(float c, const Dual<NT>& a) {
  Dual<NT> r;
  r.v = c - a.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.t[i] = -a.t[i];
  return r;
}
template <int NT>
__device__ __forceinline__ Dual<NT> operator*(const Dual<NT>& a,
                                              const Dual<NT>& b) {
  Dual<NT> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.t[i] = a.t[i] * b.v + a.v * b.t[i];
  return r;
}
template <int NT>
__device__ __forceinline__ Dual<NT> operator*(const Dual<NT>& a, float c) {
  Dual<NT> r;
  r.v = a.v * c;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.t[i] = a.t[i] * c;
  return r;
}
template <int NT>
__device__ __forceinline__ Dual<NT> operator*(float c, const Dual<NT>& a) {
  return a * c;
}

// a / b as the reference's dual type divides: q = a * (1 / b), and on duals
// the tangents (a' - q b') / b
__device__ __forceinline__ float ddiv(float a, float b) {
  return a * (1.f / b);
}
template <int NT>
__device__ __forceinline__ Dual<NT> ddiv(const Dual<NT>& a,
                                         const Dual<NT>& b) {
  const float inv = 1.f / b.v;
  Dual<NT> r;
  r.v = a.v * inv;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.t[i] = (a.t[i] - r.v * b.t[i]) * inv;
  return r;
}
template <int NT>
__device__ __forceinline__ Dual<NT> ddiv(float a, const Dual<NT>& b) {
  const float inv = 1.f / b.v;
  Dual<NT> r;
  r.v = a * inv;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.t[i] = -(r.v * b.t[i]) * inv;
  return r;
}

// f(x) with f'(x) = d: the tangents scaled by d
template <int NT>
__device__ __forceinline__ Dual<NT> dchain(float f, float d,
                                           const Dual<NT>& x) {
  Dual<NT> r;
  r.v = f;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.t[i] = d * x.t[i];
  return r;
}
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ float dtan(float x) { return tanf(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
template <int NT>
__device__ __forceinline__ Dual<NT> dcos(const Dual<NT>& x) {
  return dchain(cosf(x.v), -sinf(x.v), x);
}
template <int NT>
__device__ __forceinline__ Dual<NT> dsin(const Dual<NT>& x) {
  return dchain(sinf(x.v), cosf(x.v), x);
}
template <int NT>
__device__ __forceinline__ Dual<NT> dtan(const Dual<NT>& x) {
  const float t = tanf(x.v);
  return dchain(t, 1.f + t * t, x);
}
template <int NT>
__device__ __forceinline__ Dual<NT> dsqrt(const Dual<NT>& x) {
  const float r = sqrtf(x.v);
  return dchain(r, 0.5f / r, x);
}

// value and tangents of a where c, else of b
__device__ __forceinline__ float dwhere(bool c, float a, float b) {
  return c ? a : b;
}
template <int NT>
__device__ __forceinline__ Dual<NT> dwhere(bool c, const Dual<NT>& a,
                                           const Dual<NT>& b) {
  Dual<NT> r;
  r.v = c ? a.v : b.v;
#pragma unroll
  for (int i = 0; i < NT; ++i) r.t[i] = c ? a.t[i] : b.t[i];
  return r;
}

// |x| floored at lo, the value alone (NaN stays NaN)
__device__ __forceinline__ float dguard(float x, float lo) {
  return fabsf(x) < lo ? lo : x;
}
template <int NT>
__device__ __forceinline__ Dual<NT> dguard(const Dual<NT>& x, float lo) {
  Dual<NT> r = x;
  r.v = dguard(x.v, lo);
  return r;
}

// --------------------------------------------------------------------------
// the ODE, its discrete step, (A, B)
// --------------------------------------------------------------------------

// f = xdot of the ST model; S is float or a Dual.
template <class S>
__device__ __forceinline__ void st_ode(const StConsts& c, const S x[NX_ST],
                                       const S u[NU], S f[NX_ST]) {
  const S &delta = x[2], &v = x[3], &psi = x[4], &psi_dot = x[5],
          &beta = x[6];
  const S td = dtan(delta);
  // low-speed kinematic branch: beta_kin = arctan(tan(delta) lr / l)
  // enters through cos(arctan t) = 1 / sqrt(1 + t^2) and sin = t cos
  const S tb = td * c.lr_l;
  const S cbk = ddiv(1.f, dsqrt(tb * tb + 1.f));
  const S sbk = tb * cbk;
  const S cpsi = dcos(psi), spsi = dsin(psi);
  const S f0_lo = v * (cbk * cpsi - sbk * spsi);
  const S f1_lo = v * (sbk * cpsi + cbk * spsi);
  const S f4_lo = v * cbk * td * c.inv_l;
  const S cd = dcos(delta);
  const S cd2 = cd * cd;
  const S d_beta = ddiv(u[0] * c.lr, (cd2 * (1.f + tb * tb)) * c.l);
  const S cb = dcos(beta), sb = dsin(beta);
  const S dd_psi = (u[1] * cb * td - v * sb * d_beta * td +
                    ddiv(v * cb * u[0], cd2)) *
                   c.inv_l;
  // high-speed tire branch
  const S v_safe = dguard(v, 1e-3f);
  const S f0_hi = v * dcos(beta + psi);
  const S f1_hi = v * dsin(beta + psi);
  const S glr = c.g_lr - u[1] * c.h;
  const S glf = c.g_lf + u[1] * c.h;
  const S f5_hi = ddiv(c.c5_lf * glr, v_safe) * psi_dot +
                  ddiv(c.c5_lr * glf, v_safe) * psi_dot +
                  c.c5_r * glf * beta - c.c5_f * glr * beta +
                  c.c5_f * glr * delta;
  const S f6_hi =
      (ddiv(c.mu_l * (c.sr_lr * glf - c.sf_lf * glr), v_safe * v_safe) -
       1.f) * psi_dot -
      ddiv(c.mu_l * (c.c_sr * glf + c.c_sf * glr), v_safe) * beta +
      ddiv(c.mu_l * (c.c_sf * glr), v_safe) * delta;
  const bool low = fabsf(val(v)) < 0.1f;
  f[0] = dwhere(low, f0_lo, f0_hi);
  f[1] = dwhere(low, f1_lo, f1_hi);
  f[2] = u[0];
  f[3] = u[1];
  f[4] = dwhere(low, f4_lo, psi_dot);
  f[5] = dwhere(low, dd_psi, f5_hi);
  f[6] = dwhere(low, d_beta, f6_hi);
}

// The discrete step (RK4, or Euler when !a.rk4), the additions of step_fn
// in its order: x + dt6 (((k1 + 2 k2) + 2 k3) + k4).
template <class S, class Args>
__device__ __forceinline__ void st_step(const Args& a, const S x[NX_ST],
                                        const S u[NU], S out[NX_ST]) {
  S k[NX_ST], acc[NX_ST], xs[NX_ST];
  st_ode(a.st, x, u, k);
  if (!a.rk4) {
#pragma unroll
    for (int i = 0; i < NX_ST; ++i) out[i] = x[i] + a.dt * k[i];
    return;
  }
#pragma unroll
  for (int i = 0; i < NX_ST; ++i) {
    acc[i] = k[i];
    xs[i] = x[i] + a.half_dt * k[i];
  }
  st_ode(a.st, xs, u, k);
#pragma unroll
  for (int i = 0; i < NX_ST; ++i) {
    acc[i] = acc[i] + 2.f * k[i];
    xs[i] = x[i] + a.half_dt * k[i];
  }
  st_ode(a.st, xs, u, k);
#pragma unroll
  for (int i = 0; i < NX_ST; ++i) {
    acc[i] = acc[i] + 2.f * k[i];
    xs[i] = x[i] + a.dt * k[i];
  }
  st_ode(a.st, xs, u, k);
#pragma unroll
  for (int i = 0; i < NX_ST; ++i) out[i] = x[i] + a.dt6 * (acc[i] + k[i]);
}

// The ST model's policy type (ks_rows.cuh's KsModel is the KS one).
struct StModel {
  static constexpr int N = NX_ST;
  static constexpr bool ST = true;
  template <class Args>
  static __device__ __forceinline__ void step(const Args& a, const float x[N],
                                              const float u[NU],
                                              float out[N]) {
    st_step<float>(a, x, u, out);
  }
  // (A, B) of the step at (x, u): column j of [A | B] from the tangents of
  // a dual step seeded along direction j; put(i, j, value) receives entry
  // (i, j) of [A | B].
  template <class Args, class Put>
  static __device__ __forceinline__ void lin(const Args& a, const float x[N],
                                             const float u[NU], Put put) {
    Dual<NS_ST> xd[N], ud[NU], out[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      xd[i].v = x[i];
#pragma unroll
      for (int j = 0; j < NS_ST; ++j) xd[i].t[j] = j == i ? 1.f : 0.f;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      ud[i].v = u[i];
#pragma unroll
      for (int j = 0; j < NS_ST; ++j) ud[i].t[j] = j == N + i ? 1.f : 0.f;
    }
    st_step(a, xd, ud, out);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < NS_ST; ++j) put(i, j, out[i].t[j]);
  }
};
