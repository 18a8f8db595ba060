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
// tanf, sqrtf, sinf, cosf and division.  The helpers it shares with
// fused_ip.cu are in ks_rows.cuh.

#include "ks_rows.cuh"

struct FgnArgs {
  int32_t B, H, al_iters, sqp_iters, n_alphas;
  int32_t forcespro, rk4, moving, use_term, threads;
  float dt, half_dt, dt6, inv_l, reg, d_ego, a_cap, inv_fr_scale;
  float u_lo0, u_hi0, u_lo1, u_hi1, d_lo, d_hi, v_lo, v_hi;
  float mu0, mu_factor, mu_max, viol_improve, lam_max, tol_feas;
  float alphas[MAX_ALPHAS];
};

// --------------------------------------------------------------------------
// augmented-Lagrangian row terms
// --------------------------------------------------------------------------

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

      float Kk[NU][NX], dk[NU];
      riccati_step(a.reg, P, p, Q, R, M, qx, qu, A, Bm, Kk, dk);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const float kv = Kk[i][j];
          b.K[L.at(k, i * NX + j, NU * NX)] = (scrub && !finite_f32(kv)) ? 0.f : kv;
        }
        b.d[L.at(k, i, NU)] = (scrub && !finite_f32(dk[i])) ? 0.f : dk[i];
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
