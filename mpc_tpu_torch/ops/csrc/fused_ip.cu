// fused_ip.cu — the whole batched hard-constrained RTI-SQP solve in one
// launch, for Hopper.
//
// Replaces mpc_tpu/ops/fused_ip.py::_make_ip_kernel (the Pallas TPU kernel,
// launched by _solve_ip_packed).  Computes, per lane: an initial rollout that
// caches the constraint rows; ip_sqp_iters RTI iterations, each of which
// starts slacks and duals from the row margins (or from the warm duals
// clipped to a band around the central path), runs ip_iters primal-dual
// interior-point Newton steps on the stagewise QP (sigma = z / s weighted
// stage quadratics, a Riccati sweep with a closed-form 2x2 Quu inverse, a
// linear forward pass, slack and dual steps, the fraction-to-boundary step,
// the barrier update from the complementarity gap), scrubs the input step
// of NaN/inf and applies it unguarded or through the exact-penalty ladder;
// then the diagnostics (Lagrangian stationarity with lam = z_hi - z_lo and
// the Jacobians of the final iterate, per-row and scaled violation, cost).
// The plain PyTorch version of the same function is
// fused_ip.py::solve_batch_fused_ip_plain.
//
// What bounds it on an H100.  Each lane is a long sequential program, and
// the Newton step's state does not fit in registers: slacks, duals and
// their steps (6 x 14 rows), the row and (A, B) caches, K, d and the
// primal steps come to ~190 floats a stage, ~23 KB a lane at H=30.  Every
// Newton step walks them four times (backward sweep, forward pass, steps,
// apply), so the scratch traffic through L2 and device memory, far above
// the ~10 KB of inputs and outputs a lane, and the latency of each
// dependent load at one warp per scheduler set the time.  PERF.md has the
// measured times beside the bound.
//
// What the design does about it.  One thread per lane, as in fused_gn.cu:
// no synchronisation, P, A, B, K, d and each stage's quadratic in
// registers, every per-stage array stored (stage, field, lane) so the 32
// threads of a warp load neighbouring addresses.  The rows and (A, B) of
// the outer iterate are cached once per RTI iteration (the first Newton
// sweep fills (A, B), later ones read it), so the transcendental-heavy
// chain runs once, not ip_iters times.  The warm state (U, z_lo, z_hi) is
// updated in place.  The ragged edge is masked; no lane is padded.  When
// the caller passes a rung buffer, each ladder iteration writes the rung it
// committed (0 for alpha = 0, r + 1 for alphas[r]).
//
// Semantics kept from the TPU kernel on purpose: maxima, minima and clips
// propagate NaN; the unguarded step commits a non-finite rollout; a
// non-finite merit counts as 1e30 and a rung is taken on a strict "<".
// Build without --use_fast_math.

#include "ks_rows.cuh"

#define NAB (NX * NX + NX * NU)

// ipqp constants (mpc_tpu_torch/ops/ipqp.py)
#define S_FLOOR 1e-10f
#define Z_MAX 1e6f
#define WARM_KAPPA 100.f
#define S_MIN 1e-2f
#define MU0 1.f
#define SIGMA_B 0.2f
#define TAU 0.995f
#define MU_MIN 1e-8f
#define BIG 1e30f

struct IpArgs {
  int32_t B, H, ip_sqp_iters, ip_iters, n_alphas;
  int32_t forcespro, rk4, moving, use_term, warm, threads;
  float dt, half_dt, dt6, inv_l, reg, d_ego, a_cap, inv_fr_scale;
  float u_lo0, u_hi0, u_lo1, u_hi1, d_lo, d_hi, v_lo, v_hi;
  float rho, n_act;
  float alphas[MAX_ALPHAS];
};

struct IpBufs {
  const float *x0, *xref, *obs, *mind, *w;
  float *U, *z_lo, *z_hi;   // warm state, updated in place
  float *X, *pviol, *diag;  // outputs
  float *K, *d, *dX, *dU, *ddX, *ddU, *s_lo, *s_hi, *ds_lo, *ds_hi, *dz_lo,
      *dz_hi, *rows, *ab;   // scratch
  int32_t* rung;            // (ip_sqp_iters, B) or null
};

// Linearized row values c_i = h_i + J_i . (dX, dU) (sparse gradients).
__device__ __forceinline__ void row_lin(const Rows& r, const float dX[NX],
                                        const float dU[NU], float c[NR]) {
  c[0] = r.hf + r.gf[0] * dX[2] + r.gf[1] * dX[3] + r.gf[2] * dU[1];
#pragma unroll
  for (int p = 0; p < 9; ++p)
    c[1 + p] = r.circ[p][0] + r.circ[p][1] * dX[0] + r.circ[p][2] * dX[1] +
               r.circ[p][3] * dX[4];
  c[10] = r.box[0] + dU[0];
  c[11] = r.box[1] + dU[1];
  c[12] = r.box[2] + dX[2];
  c[13] = r.box[3] + dX[3];
}

// Fraction-to-boundary: min(amin, -v / dv) where dv < 0.
__device__ __forceinline__ float ftb(float v, float dv, float amin) {
  return nmin(amin, dv < 0.f ? -v / dv : BIG);
}

// Slack and dual of one bounded side at the start of a QP.
__device__ __forceinline__ void side_init(float margin, float z0, bool warm,
                                         float& s, float& z) {
  s = margin <= 0.f ? 1.f : nmax(margin, S_MIN);
  const float zc = MU0 / s;
  if (!warm) {
    z = zc;
    return;
  }
  z = nmin(nmax(z0 > 0.f ? z0 : zc, zc / WARM_KAPPA), zc * WARM_KAPPA);
}

// Per-lane solve state and accessors.
struct IpSolve {
  const IpArgs& a;
  const IpBufs& b;
  Lane L;
  float wq[NX], wr[NU], wqN[NX], x0[NX], mind;

  __device__ IpSolve(const IpArgs& a_, const IpBufs& b_, int lane)
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
  // dX, dU (zero at the terminal stage) of stage k from (px, pu)
  __device__ __forceinline__ void load_xu(const float* px, const float* pu,
                                          int k, float x[NX],
                                          float u[NU]) const {
    load(px, k, NX, x);
    if (k < a.H) {
      load(pu, k, NU, u);
    } else {
      u[0] = u[1] = 0.f;
    }
  }
  __device__ void fresh_rows(int k, const float x[NX], const float u[NU],
                             Rows& r) const {
    float o[6];
    obs_at(k, o);
    compute_rows(a, x, u, o, k == a.H, k == 0, r);
  }

  __device__ void initial_rollout() const {
    float x[NX], u[NU], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    Rows r;
    for (int k = 0; k < a.H; ++k) {
      store(b.X, k, NX, x);
      load(b.U, k, NU, u);
      fresh_rows(k, x, u, r);
      store_rows(L, b.rows, k, r);
      step_fn(a, x, u, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    store(b.X, a.H, NX, x);
    const float zu[NU] = {0.f, 0.f};
    fresh_rows(a.H, x, zu, r);
    store_rows(L, b.rows, a.H, r);
  }

  // Slacks and duals from the margins of the cached rows (or the warm
  // duals); dX = dU = 0.
  __device__ void init_ip() const {
    const float zero[NX] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k <= a.H; ++k) {
      const bool is_term = k == a.H;
      Rows r;
      load_rows(L, b.rows, k, r);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        bool has_lo, has_hi;
        float lo, hi;
        row_bounds(a, i, is_term, mind, has_lo, lo, has_hi, hi);
        const float h = row_value(r, i);
        float sl = 1.f, zl = 0.f, sh = 1.f, zh = 0.f;
        if (has_lo)
          side_init(h - lo, b.z_lo[L.at(k, i, NR)], a.warm != 0, sl, zl);
        if (has_hi)
          side_init(hi - h, b.z_hi[L.at(k, i, NR)], a.warm != 0, sh, zh);
        b.s_lo[L.at(k, i, NR)] = sl;
        b.s_hi[L.at(k, i, NR)] = sh;
        b.z_lo[L.at(k, i, NR)] = zl;
        b.z_hi[L.at(k, i, NR)] = zh;
      }
      store(b.dX, k, NX, zero);
      if (!is_term) store(b.dU, k, NU, zero);
    }
  }

  // IP row weights of stage k at the current (dX, dU): w (into gh) and
  // sigma = z / s (into gn), summed over the row's bounded sides.
  __device__ void ip_terms(int k, const Rows& r, const float dXk[NX],
                           const float dUk[NU], float mu_b, float gh[NR],
                           float gn[NR]) const {
    const bool is_term = k == a.H;
    float cs[NR];
    row_lin(r, dXk, dUk, cs);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      bool has_lo, has_hi;
      float lo, hi;
      row_bounds(a, i, is_term, mind, has_lo, lo, has_hi, hi);
      float w = 0.f, sig = 0.f;
      if (has_hi) {
        const float s = b.s_hi[L.at(k, i, NR)], z = b.z_hi[L.at(k, i, NR)];
        const float rs = s - (hi - cs[i]);
        const float sg = z / s;
        w = w + mu_b / s + sg * rs;
        sig = sig + sg;
      }
      if (has_lo) {
        const float s = b.s_lo[L.at(k, i, NR)], z = b.z_lo[L.at(k, i, NR)];
        const float rs = s - (cs[i] - lo);
        const float sg = z / s;
        w = w - mu_b / s - sg * rs;
        sig = sig + sg;
      }
      gh[i] = w;
      gn[i] = sig;
    }
  }

  // Riccati sweep of the QP at the shifted point (X + dX, U + dU) -> K, d;
  // fills the (A, B) cache at the outer iterate when ``fill_ab``.
  __device__ void backward_sweep(float mu_b, bool fill_ab) const {
    const int H = a.H;
    float P[NX][NX], p[NX];
    {
      float x[NX], dx[NX], du[NU], xref[NX], gh[NR], gn[NR], R[NU][NU],
          M[NX][NU], qu[NU];
      const float zu[NU] = {0.f, 0.f};
      load(b.X, H, NX, x);
      load_xu(b.dX, b.dU, H, dx, du);
      load(b.xref, H, NX, xref);
      Rows r;
      load_rows(L, b.rows, H, r);
      ip_terms(H, r, dx, du, mu_b, gh, gn);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = x[i] + dx[i];
      assemble_quad(r, gh, gn, x, zu, xref, wqN, wr, true, a.use_term != 0,
                    P, R, M, p, qu);
    }
    for (int k = H - 1; k >= 0; --k) {
      float x[NX], u[NU], dx[NX], du[NU], xref[NX];
      load(b.X, k, NX, x);
      load(b.U, k, NU, u);
      load_xu(b.dX, b.dU, k, dx, du);
      load(b.xref, k, NX, xref);
      float Q[NX][NX], R[NU][NU], M[NX][NU], qx[NX], qu[NU];
      {
        float gh[NR], gn[NR], xc[NX], uc[NU];
        Rows r;
        load_rows(L, b.rows, k, r);
        ip_terms(k, r, dx, du, mu_b, gh, gn);
#pragma unroll
        for (int i = 0; i < NX; ++i) xc[i] = x[i] + dx[i];
#pragma unroll
        for (int i = 0; i < NU; ++i) uc[i] = u[i] + du[i];
        assemble_quad(r, gh, gn, xc, uc, xref, wq, wr, false, true, Q, R, M,
                      qx, qu);
      }
      float A[NX][NX], Bm[NX][NU];
      if (fill_ab) {
        lin_step(a, x, u, A, Bm);
#pragma unroll
        for (int i = 0; i < NX; ++i) {
#pragma unroll
          for (int j = 0; j < NX; ++j) b.ab[L.at(k, i * NX + j, NAB)] = A[i][j];
#pragma unroll
          for (int j = 0; j < NU; ++j)
            b.ab[L.at(k, NX * NX + i * NU + j, NAB)] = Bm[i][j];
        }
      } else {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
#pragma unroll
          for (int j = 0; j < NX; ++j) A[i][j] = b.ab[L.at(k, i * NX + j, NAB)];
#pragma unroll
          for (int j = 0; j < NU; ++j)
            Bm[i][j] = b.ab[L.at(k, NX * NX + i * NU + j, NAB)];
        }
      }
      float Kk[NU][NX], dk[NU];
      riccati_step(a.reg, P, p, Q, R, M, qx, qu, A, Bm, Kk, dk);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) b.K[L.at(k, i * NX + j, NU * NX)] = Kk[i][j];
        b.d[L.at(k, i, NU)] = dk[i];
      }
    }
  }

  // ddx_0 = 0 (x0 pinned); ddu_k = d_k + K_k ddx_k; ddx_{k+1} = A ddx + B ddu
  __device__ void forward_pass() const {
    float ddx[NX] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < a.H; ++k) {
      store(b.ddX, k, NX, ddx);
      float ddu[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NX; ++j)
          s += b.K[L.at(k, i * NX + j, NU * NX)] * ddx[j];
        ddu[i] = b.d[L.at(k, i, NU)] + s;
      }
      store(b.ddU, k, NU, ddu);
      float nxt[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int j = 0; j < NX; ++j) sa += b.ab[L.at(k, i * NX + j, NAB)] * ddx[j];
#pragma unroll
        for (int j = 0; j < NU; ++j)
          sb += b.ab[L.at(k, NX * NX + i * NU + j, NAB)] * ddu[j];
        nxt[i] = sa + sb;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) ddx[i] = nxt[i];
    }
    store(b.ddX, a.H, NX, ddx);
  }

  // Slack and dual steps of every stage; returns the least
  // fraction-to-boundary ratio.
  __device__ float dual_steps(float mu_b) const {
    float amin = BIG;
    for (int k = 0; k <= a.H; ++k) {
      const bool is_term = k == a.H;
      float dx[NX], du[NU], ddx[NX], ddu[NU], cs[NR], jl[NR];
      Rows r;
      load_rows(L, b.rows, k, r);
      load_xu(b.dX, b.dU, k, dx, du);
      load_xu(b.ddX, b.ddU, k, ddx, ddu);
      row_lin(r, dx, du, cs);
      row_lin(r, ddx, ddu, jl);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        bool has_lo, has_hi;
        float lo, hi;
        row_bounds(a, i, is_term, mind, has_lo, lo, has_hi, hi);
        const float jd = jl[i] - row_value(r, i);
        float dsl = 0.f, dzl = 0.f, dsh = 0.f, dzh = 0.f;
        if (has_lo) {
          const float s = b.s_lo[L.at(k, i, NR)], z = b.z_lo[L.at(k, i, NR)];
          const float rs = s - (cs[i] - lo);
          const float sg = z / s;
          dsl = jd - rs;
          dzl = mu_b / s - z - sg * dsl;
          amin = ftb(s, dsl, amin);
          amin = ftb(z, dzl, amin);
        }
        if (has_hi) {
          const float s = b.s_hi[L.at(k, i, NR)], z = b.z_hi[L.at(k, i, NR)];
          const float rs = s - (hi - cs[i]);
          const float sg = z / s;
          dsh = -jd - rs;
          dzh = mu_b / s - z - sg * dsh;
          amin = ftb(s, dsh, amin);
          amin = ftb(z, dzh, amin);
        }
        b.ds_lo[L.at(k, i, NR)] = dsl;
        b.dz_lo[L.at(k, i, NR)] = dzl;
        b.ds_hi[L.at(k, i, NR)] = dsh;
        b.dz_hi[L.at(k, i, NR)] = dzh;
      }
    }
    return amin;
  }

  // The step of length alpha on (dX, dU, s, z), slacks floored at S_FLOOR
  // and duals capped at Z_MAX; returns the complementarity gap.
  __device__ float apply_step(float alpha) const {
    float gap = 0.f;
    for (int k = 0; k <= a.H; ++k) {
      const bool is_term = k == a.H;
#pragma unroll
      for (int i = 0; i < NX; ++i)
        b.dX[L.at(k, i, NX)] = b.dX[L.at(k, i, NX)] + alpha * b.ddX[L.at(k, i, NX)];
      if (!is_term) {
#pragma unroll
        for (int i = 0; i < NU; ++i)
          b.dU[L.at(k, i, NU)] = b.dU[L.at(k, i, NU)] + alpha * b.ddU[L.at(k, i, NU)];
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        bool has_lo, has_hi;
        float lo, hi;
        row_bounds(a, i, is_term, mind, has_lo, lo, has_hi, hi);
        const size_t at = L.at(k, i, NR);
        float sl = 1.f, zl = 0.f, sh = 1.f, zh = 0.f;
        if (has_lo) {
          sl = nmax(b.s_lo[at] + alpha * b.ds_lo[at], S_FLOOR);
          zl = nmin(b.z_lo[at] + alpha * b.dz_lo[at], Z_MAX);
          gap = gap + sl * zl;
        }
        if (has_hi) {
          sh = nmax(b.s_hi[at] + alpha * b.ds_hi[at], S_FLOOR);
          zh = nmin(b.z_hi[at] + alpha * b.dz_hi[at], Z_MAX);
          gap = gap + sh * zh;
        }
        b.s_lo[at] = sl;
        b.z_lo[at] = zl;
        b.s_hi[at] = sh;
        b.z_hi[at] = zh;
      }
    }
    return gap;
  }

  // One primal-dual Newton step; returns the next barrier.
  __device__ float newton(float mu_b, bool fill_ab) const {
    backward_sweep(mu_b, fill_ab);
    forward_pass();
    const float alpha = nmin(1.f, TAU * dual_steps(mu_b));
    const float gap = apply_step(alpha);
    return nmax(SIGMA_B * gap / a.n_act, MU_MIN);
  }

  // max(lo - h, h - hi, 0) of row i (raw).
  __device__ float row_viol(const Rows& r, int i, bool is_term) const {
    bool has_lo, has_hi;
    float lo, hi;
    row_bounds(a, i, is_term, mind, has_lo, lo, has_hi, hi);
    const float h = row_value(r, i);
    float vi = 0.f;
    if (has_hi) vi = nmax(vi, h - hi);
    if (has_lo) vi = nmax(vi, lo - h);
    return nmax(vi, 0.f);
  }
  // the friction row's violation is scaled by its bound
  __device__ __forceinline__ float scaled(int i, float vi) const {
    return i == 0 ? vi * a.inv_fr_scale : vi;
  }

  // sum over the rows of their scaled violations
  __device__ float penalty_viol(const Rows& r, bool is_term) const {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < NR; ++i) v = v + scaled(i, row_viol(r, i, is_term));
    return v;
  }

  // The RTI step U <- clip(U + alpha dU) and its rollout from x0 (no
  // feedback).  ``write`` commits (X, U) and the rows cache; ``merit``
  // returns objective + rho * viol (1e30 when not finite).
  __device__ float du_rollout(float alpha, bool write, bool merit) const {
    float x[NX], xn[NX], u[NU], ub[NU], dk[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x0[i];
    float acc = 0.f;
    Rows r;
    for (int k = 0; k < a.H; ++k) {
      load(b.U, k, NU, ub);
      load(b.dU, k, NU, dk);
      u[0] = clipf(ub[0] + alpha * dk[0], a.u_lo0, a.u_hi0);
      u[1] = clipf(ub[1] + alpha * dk[1], a.u_lo1, a.u_hi1);
      fresh_rows(k, x, u, r);
      if (write) store_rows(L, b.rows, k, r);
      if (merit) {
        float xref[NX];
        load(b.xref, k, NX, xref);
        acc = acc + stage_cost(x, u, xref, wq, wr) + a.rho * penalty_viol(r, false);
      }
      if (write) {
        store(b.X, k, NX, x);
        store(b.U, k, NU, u);
      }
      step_fn(a, x, u, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    const float zu[NU] = {0.f, 0.f};
    fresh_rows(a.H, x, zu, r);
    if (write) {
      store_rows(L, b.rows, a.H, r);
      store(b.X, a.H, NX, x);
    }
    if (!merit) return 0.f;
    if (a.use_term) {
      float xref[NX];
      load(b.xref, a.H, NX, xref);
      acc = acc + term_cost(x, xref, wqN);
    }
    acc = acc + a.rho * penalty_viol(r, true);
    return finite_f32(acc) ? acc : BIG;
  }

  // The RTI step of SQP iteration ``si``: dU scrubbed, then the unguarded
  // full step or the ladder.
  __device__ void rti_step(int si) const {
    for (int k = 0; k < a.H; ++k)
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const float v = b.dU[L.at(k, i, NU)];
        b.dU[L.at(k, i, NU)] = finite_f32(v) ? v : 0.f;
      }
    if (a.n_alphas == 0) {
      du_rollout(1.f, true, false);
      return;
    }
    float best_m = du_rollout(0.f, false, true), best_a = 0.f;
    int best_rung = 0;
    for (int r = 0; r < a.n_alphas; ++r) {
      const float m = du_rollout(a.alphas[r], false, true);
      if (m < best_m) {
        best_m = m;
        best_a = a.alphas[r];
        best_rung = r + 1;
      }
    }
    if (b.rung) b.rung[(size_t)si * a.B + L.lane] = best_rung;
    du_rollout(best_a, true, false);
  }

  // Per-row violations of stage k's rows (raw, into pviol) and ``viol``
  // maxed with their scaled values.
  __device__ float store_viol(int k, const Rows& r, float viol) const {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float vi = row_viol(r, i, k == a.H);
      b.pviol[L.at(k, i, NR)] = vi;
      viol = nmax(viol, scaled(i, vi));
    }
    return viol;
  }

  // stat (adjoint Lagrangian stationarity with lam = z_hi - z_lo), viol,
  // cost at the final iterate; rows from the cache, (A, B) recomputed.
  __device__ void diagnostics() const {
    const int H = a.H;
    const float zero[NR] = {};
    float lam[NX], stat = 0.f, viol, cost;
    {
      float xT[NX], xref[NX], lr[NR], Q[NX][NX], R[NU][NU], M[NX][NU],
          qu[NU];
      const float zu[NU] = {0.f, 0.f};
      load(b.X, H, NX, xT);
      load(b.xref, H, NX, xref);
#pragma unroll
      for (int i = 0; i < NR; ++i)
        lr[i] = b.z_hi[L.at(H, i, NR)] - b.z_lo[L.at(H, i, NR)];
      Rows r;
      load_rows(L, b.rows, H, r);
      assemble_quad(r, lr, zero, xT, zu, xref, wqN, wr, true, a.use_term != 0,
                    Q, R, M, lam, qu);
      viol = store_viol(H, r, 0.f);
      cost = a.use_term ? term_cost(xT, xref, wqN) : 0.f;
    }
    for (int k = H - 1; k >= 0; --k) {
      float x[NX], u[NU], xref[NX], lr[NR], Q[NX][NX], R[NU][NU], M[NX][NU],
          qx[NX], qu[NU];
      load(b.X, k, NX, x);
      load(b.U, k, NU, u);
      load(b.xref, k, NX, xref);
#pragma unroll
      for (int i = 0; i < NR; ++i)
        lr[i] = b.z_hi[L.at(k, i, NR)] - b.z_lo[L.at(k, i, NR)];
      Rows r;
      load_rows(L, b.rows, k, r);
      assemble_quad(r, lr, zero, x, u, xref, wq, wr, false, true, Q, R, M, qx,
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
      viol = store_viol(k, r, viol);
      cost = cost + stage_cost(x, u, xref, wq, wr);
    }
    b.diag[L.at(0, 0, 4)] = stat;
    b.diag[L.at(0, 1, 4)] = viol;
    b.diag[L.at(0, 2, 4)] = cost;
    b.diag[L.at(0, 3, 4)] = cost;
  }
};

// __grid_constant__: the IpSolve object keeps references to the
// parameters, which then stay in the constant bank instead of a local copy.
__global__ void fused_ip_kernel(const __grid_constant__ IpArgs a,
                                const __grid_constant__ IpBufs b) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  IpSolve s(a, b, lane);
  s.initial_rollout();
  for (int si = 0; si < a.ip_sqp_iters; ++si) {
    // warm duals chain across SQP iterations and MPC steps: z_lo / z_hi
    // hold the caller's duals at si = 0 and the last QP's after
    s.init_ip();
    float mu_b = MU0;
    for (int it = 0; it < a.ip_iters; ++it) mu_b = s.newton(mu_b, it == 0);
    s.rti_step(si);
  }
  s.diagnostics();
}

extern "C" int fused_ip_solve(const IpArgs* args, const float* x0,
                              const float* xref, const float* obs,
                              const float* mind, const float* w, float* U,
                              float* lam_lo, float* lam_hi, float* X,
                              float* pviol, float* diag, float* K, float* d,
                              float* dX, float* dU, float* ddX, float* ddU,
                              float* s_lo, float* s_hi, float* ds_lo,
                              float* ds_hi, float* dz_lo, float* dz_hi,
                              float* rows, float* ab, int32_t* rung,
                              void* stream) {
  IpBufs b{x0,  xref, obs,  mind,  w,     U,     lam_lo, lam_hi, X,    pviol,
           diag, K,   d,    dX,    dU,    ddX,   ddU,    s_lo,   s_hi, ds_lo,
           ds_hi, dz_lo, dz_hi, rows, ab, rung};
  const int threads = args->threads > 0 ? args->threads : 64;
  const int blocks = (args->B + threads - 1) / threads;
  fused_ip_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args, b);
  return (int)cudaGetLastError();
}
