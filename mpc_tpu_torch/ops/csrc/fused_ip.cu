// fused_ip.cu — the whole batched hard-constrained RTI-SQP solve in one
// launch, for Hopper: the KS model without the road-boundary rows (B2).
//
// Replaces mpc_tpu/ops/fused_ip.py::_make_ip_kernel (the Pallas TPU kernel,
// launched by _solve_ip_packed) for the KS model and the 14 rows a stage.
// Its boundary-row branch (fused_ip.py:765, :783) and its ST branch
// (:100-108) build from fused_ip_ring.cu, the same function on the ring of
// stage operands, 32 lanes a block (fused_ip_ks_ring.cu, fused_ip_st.cu);
// this source refuses boundary = 1.  Computes, per lane: an initial rollout that
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
// What bounds it on an H100.  A lane's Newton state (slacks, duals, the row
// and (A, B) caches, the stage quadratics, K, d, the primal steps) is ~160
// floats a stage, ~20 KB a lane at H=30, and every Newton step walks it
// several times.  Kept in device memory (one thread a lane) it is ~460 MB
// at B=16384, nine times the L2, and its traffic plus one warp per
// scheduler set the time.  Most of the work is separable by stage; only
// the rollouts, the Riccati sweep, the forward pass and the adjoint carry
// a dependency from stage to stage.  The bound (operations, PERF.md) is far
// below what this design reaches: the sweep, a chain of 5x5 products per
// stage, runs on one thread a lane and takes about half the time.
//
// What the design does about it.
// - One warp a lane.  Thread t owns stages t, t + 32, ... (SPT stages a
//   thread, a template parameter; H + 1 <= 32 * MAX_SPT).  The phases that
//   are separable by stage run on the owners at once: slacks and duals at
//   the start of a QP, the row weights and stage quadratic, (A, B) by the
//   chain rule through RK4, the slack and dual steps, the rows and
//   violations of a rollout, the diagnostics' per-stage terms.
// - A stage's slacks, duals, dX and dU live in its owner's registers.  The
//   rows cache, (A, B), the stage quadratics, K, d, the Newton direction
//   (ddX, ddU), X, U, xref, the obstacles and the terminal P live in
//   dynamic shared memory (Layout; 19,228 B a lane at H=30, 12 lanes a
//   block).  The slack and dual steps are never stored: one pass takes the
//   fraction-to-boundary ratio, a second recomputes the steps and applies
//   them.  No per-lane scratch is in device memory.
// - The rollouts: a step's increment depends on (delta, v) in its steering
//   and speed rows, on (delta, v, u) in its heading row and on (delta, v,
//   psi, u) in its position rows, so three rounds of increments on every
//   stage's owner at once (the transcendentals of step_fn's four KS
//   evaluations), each followed by its running sum on thread 0, with
//   step_fn's own additions in order.
// - The Riccati sweep with the forward pass, and the diagnostics' adjoint,
//   run for lane l on thread l of warp 0, between two __syncthreads: P and
//   p in registers, riccati_step (ks_rows.cuh, the single-thread step of
//   fused_gn.cu) a stage, operands read from the lane's shared memory; a
//   warp thus sweeps 12 lanes at once.  A spread sweep (each stage's 5x5
//   products over the 32 or 8 threads of a lane, with __syncwarp between
//   phases) was slower on the card (PERF.md).
// - Reductions across stages: the fraction-to-boundary minimum and the
//   violation maximum by __shfl_xor_sync butterflies of the NaN-propagating
//   nmin / nmax (exact in any order); the complementarity gap, the ladder
//   merit and the cost as sums per thread in stage order, then a butterfly,
//   each result broadcast from thread 0.  Those three sums change order
//   against the single-thread kernel: a few ulp of relative rounding
//   (~1e-7), far inside the cost band (1e-3, 1e-2); the gap enters only
//   through the barrier mu = 0.2 gap / n_act; near-tied merits are covered
//   by the check's rung replay at TIE_RTOL = 1e-4.
// - Every buffer is lanes leading, (B, ...): one lane's arrays are
//   contiguous, so a warp loads and stores them at consecutive addresses.
// - Lanes a block: given, or chosen by the occupancy API from registers and
//   shared memory together (fused_ip_geometry reports the choice).
//   __launch_bounds__ caps the registers at 168 so that 12 warps fit an SM;
//   a spare warp of the ragged last block solves a copy of the last lane
//   and stores nothing, so that every warp meets the same __syncthreads.
// - No tensor cores: the products are 5x5 in float32, and TF32 would
//   break the float32 bands.
//
// Semantics kept from the TPU kernel on purpose: maxima, minima and clips
// propagate NaN; the unguarded step commits a non-finite rollout; a
// non-finite merit counts as 1e30 and a rung is taken on a strict "<".
// Build without --use_fast_math.

// st_model.cuh for StConsts: IpArgs is fused_ip_ring.cu's, field for field
#include "st_model.cuh"

constexpr int N = NX;  // the KS model's states

#define TPL 32         // threads per lane: one warp
#define MAX_SPT 2      // stages a thread holds, at most
// Lanes a block, at most: caps the registers at 65536 / (32 * 12) = 168 a
// thread, so that three warps fit each of an SM's four register
// partitions (16,384 registers each) and shared memory, not registers,
// bounds the lanes an SM holds (12 at H=30).
#define MAX_LPB 12
#define ROW_LD 45      // floats a stage in the rows cache (44, padded odd)
#define OBS_LD 7       // floats a stage of the obstacles (6, padded odd)
#define FULL_MASK 0xffffffffu

// The sizes of a lane's arrays.
struct IpDims {
  static constexpr int NAB = N * N + N * NU;  // (A, B) a stage
  // one stage quadratic: Q's upper triangle, R, M, qx, qu (36 floats,
  // padded odd to 37)
  static constexpr int QO_R = N * (N + 1) / 2;
  static constexpr int QO_M = QO_R + NU * NU;
  static constexpr int QO_QX = QO_M + N * NU;
  static constexpr int QO_QU = QO_QX + N;
  static constexpr int QUAD_LD = (QO_QU + NU) | 1;
  // a lane's constants: wq, wr, wqN, x0, min_dist
  static constexpr int C_WQ = 0;
  static constexpr int C_WR = N;
  static constexpr int C_WQN = N + NU;
  static constexpr int C_X0 = 2 * N + NU;
  static constexpr int C_MIND = 3 * N + NU;
  static constexpr int NCST = C_MIND + 1;
};

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
  int32_t forcespro, rk4, moving, use_term, warm, lanes_per_block;
  float dt, half_dt, dt6, inv_l, reg, d_ego, a_cap, inv_fr_scale;
  float u_lo0, u_hi0, u_lo1, u_hi1, d_lo, d_hi, v_lo, v_hi;
  float rho, n_act;
  float alphas[MAX_ALPHAS];
  int32_t boundary;  // 1: the instance with the road-boundary rows
  float r_ego;       // their bound: r_ego <= h
  StConsts st;       // the ST model's constants (zero for KS)
};

// Every buffer lanes leading: (B, ...), one lane contiguous.
struct IpBufs {
  const float *x0, *xref, *obs, *mind, *w;
  float *U, *z_lo, *z_hi;   // warm state, updated in place
  float *X, *pviol, *diag;  // outputs
  int32_t* rung;            // (ip_sqp_iters, B) or null
};

// Offsets (floats) of one lane's arrays in shared memory.
struct Layout {
  using D = IpDims;
  int rows, quad, ab, K, d, ddX, ddU, X, Xt, inc, U, Ut, xref, obs, P, p,
      stat, cst, total;
  __host__ __device__ explicit Layout(int H) {
    const int S = H + 1;
    int o = 0;
    rows = o;  o += ROW_LD * S;
    quad = o;  o += D::QUAD_LD * S;
    // a rollout's scratch shares the quadratics' space: the rollouts run
    // between the last Newton step of an RTI iteration and the next
    // quadratics
    Xt = quad;               // a ladder trial's states
    inc = Xt + N * S;       // a rollout's per-stage increments
    Ut = inc + N * H;       // a ladder trial's inputs
    ab = o;    o += D::NAB * H;
    K = o;     o += NU * N * H;
    d = o;     o += NU * H;
    ddX = o;   o += N * S;     // the Newton direction
    ddU = o;   o += NU * S;     // (zero at the terminal stage)
    X = o;     o += N * S;
    U = o;     o += NU * S;     // (zero at the terminal stage)
    xref = o;  o += N * S;
    obs = o;   o += OBS_LD * S;
    P = o;     o += N * N;    // the terminal cost-to-go
    p = o;     o += N;
    stat = o;  o += 1;          // the adjoint's stationarity
    cst = o;   o += D::NCST;
    total = o;
  }
};

// Index of Q[i][j] in its stored upper triangle.
__host__ __device__ __forceinline__ int ut(int i, int j) {
  return i <= j ? i * N - i * (i - 1) / 2 + j - i
                : j * N - j * (j - 1) / 2 + i - j;
}

// Linearized value c_i = h_i + J_i . (dX, dU) of row i (sparse gradient;
// the rows read the first five states), one row at a time so that no row
// array stays live.
__device__ __forceinline__ float row_lin(const Rows& r, int i,
                                         const float* dX,
                                         const float dU[NU]) {
  if (i == 0) return r.hf + r.gf[0] * dX[2] + r.gf[1] * dX[3] + r.gf[2] * dU[1];
  if (i < 10) {
    const float* c = r.circ[i - 1];
    return c[0] + c[1] * dX[0] + c[2] * dX[1] + c[3] * dX[4];
  }
  if (i < 12) return r.box[i - 10] + dU[i - 10];
  return r.box[i - 10] + dX[i - 10];
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

// Butterfly reductions over the warp, the result broadcast from thread 0
// so that every thread holds the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = TPL / 2; m > 0; m >>= 1)
    v = v + __shfl_xor_sync(FULL_MASK, v, m);
  return __shfl_sync(FULL_MASK, v, 0);
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int m = TPL / 2; m > 0; m >>= 1)
    v = nmin(v, __shfl_xor_sync(FULL_MASK, v, m));
  return __shfl_sync(FULL_MASK, v, 0);
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = TPL / 2; m > 0; m >>= 1)
    v = nmax(v, __shfl_xor_sync(FULL_MASK, v, m));
  return __shfl_sync(FULL_MASK, v, 0);
}

// One stage's Newton state, in its owner's registers.
struct StageState {
  float sl[NR], sh[NR], zl[NR], zh[NR];  // slacks and duals, both sides
  float dx[N], du[NU];
};

// The Riccati sweep and the linear forward pass of the lane whose shared
// memory is ``sm``, on one thread: P and p in registers from the terminal
// quadratic, each stage's quadratic and (A, B) read from shared memory,
// one riccati_step (ks_rows.cuh) a stage; K and d, then ddX and ddU
// (ddx_0 = 0, x0 pinned; ddu_k = d_k + K_k ddx_k; ddx_{k+1} = A ddx +
// B ddu) into shared memory.
template <class Args>
__device__ void sweep_lane(const Args& a, float* sm, const Layout& L) {
  using D = IpDims;
  const int H = a.H;
  float P[N][N], p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < N; ++c) P[i][c] = sm[L.P + i * N + c];
    p[i] = sm[L.p + i];
  }
  for (int k = H - 1; k >= 0; --k) {
    const float* q = sm + L.quad + k * D::QUAD_LD;
    const float* abk = sm + L.ab + k * D::NAB;
    float Q[N][N], R[NU][NU], M[N][NU], qx[N], qu[NU], A[N][N],
        Bm[N][NU];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        Q[i][c] = q[ut(i, c)];
        A[i][c] = abk[i * N + c];
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        M[i][c] = q[D::QO_M + i * NU + c];
        Bm[i][c] = abk[N * N + i * NU + c];
      }
      qx[i] = q[D::QO_QX + i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int c = 0; c < NU; ++c) R[i][c] = q[D::QO_R + i * NU + c];
      qu[i] = q[D::QO_QU + i];
    }
    float Kk[NU][N], dk[NU];
    riccati_step(a.reg, P, p, Q, R, M, qx, qu, A, Bm, Kk, dk);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int c = 0; c < N; ++c) sm[L.K + k * NU * N + i * N + c] = Kk[i][c];
      sm[L.d + k * NU + i] = dk[i];
    }
  }
  float ddx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) ddx[i] = 0.f;
  for (int k = 0; k < H; ++k) {
    const float* Kk = sm + L.K + k * NU * N;
    const float* dk = sm + L.d + k * NU;
    const float* abk = sm + L.ab + k * D::NAB;
    float ddu[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < N; ++c) s += Kk[i * N + c] * ddx[c];
      ddu[i] = dk[i] + s;
      sm[L.ddU + k * NU + i] = ddu[i];
    }
    float nxt[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sm[L.ddX + k * N + i] = ddx[i];
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int c = 0; c < N; ++c) sa += abk[i * N + c] * ddx[c];
#pragma unroll
      for (int c = 0; c < NU; ++c) sb += abk[N * N + i * NU + c] * ddu[c];
      nxt[i] = sa + sb;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) ddx[i] = nxt[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) sm[L.ddX + H * N + i] = ddx[i];
}

// The adjoint recursion of the diagnostics for the lane whose shared
// memory is ``sm``, on one thread: lam_H = qx_H, g_u = qu_k + B' lam,
// lam <- qx_k + A' lam, with qx, qu (lam = z_hi - z_lo) and (A, B) of the
// final iterate in shared memory; the largest |g_u| into ``stat``.
template <class Args>
__device__ void adjoint_lane(const Args& a, float* sm, const Layout& L) {
  using D = IpDims;
  float lam[N], stat = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    lam[i] = sm[L.quad + a.H * D::QUAD_LD + D::QO_QX + i];
  for (int k = a.H - 1; k >= 0; --k) {
    const float* q = sm + L.quad + k * D::QUAD_LD;
    const float* abk = sm + L.ab + k * D::NAB;
    float g_u[NU], lam_new[N];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < N; ++c) s += abk[N * N + c * NU + i] * lam[c];
      g_u[i] = q[D::QO_QU + i] + s;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < N; ++c) s += abk[c * N + i] * lam[c];
      lam_new[i] = q[D::QO_QX + i] + s;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) lam[i] = lam_new[i];
    stat = nmax(stat, nmax(fabsf(g_u[0]), fabsf(g_u[1])));
  }
  sm[L.stat] = stat;
}

// One lane's solve, run by the 32 threads of its warp; the lanes of a
// block meet at __syncthreads around the recursions that thread l of
// warp 0 runs for lane l.
template <int SPT>
struct IpLane {
  using D = IpDims;
  const IpArgs& a;
  const IpBufs& b;
  const int lane, t, w, lpb, H, S;
  const bool live;         // false: a copy of the last lane that stores
                           // nothing (the ragged block's spare warps)
  float* const block_sm;   // the block's shared memory
  float* const sm;         // this lane's
  const Layout L;
  StageState st[SPT];

  __device__ __forceinline__ IpLane(const IpArgs& a_, const IpBufs& b_,
                                    int lane_, bool live_, int t_, int w_,
                                    int lpb_, float* block_sm_,
                                    const Layout& L_)
      : a(a_), b(b_), lane(lane_), t(t_), w(w_), lpb(lpb_), H(a_.H),
        S(a_.H + 1), live(live_), block_sm(block_sm_),
        sm(block_sm_ + (size_t)w_ * L_.total), L(L_) {}

  // ---- shared-memory views
  __device__ __forceinline__ Rows& rows(int k) const {
    return *reinterpret_cast<Rows*>(sm + L.rows + k * ROW_LD);
  }
  __device__ __forceinline__ float* quad(int k) const {
    return sm + L.quad + k * D::QUAD_LD;
  }
  __device__ __forceinline__ float* ab(int k) const {
    return sm + L.ab + k * D::NAB;
  }
  __device__ __forceinline__ float* xref(int k) const {
    return sm + L.xref + k * N;
  }
  __device__ __forceinline__ const float* cst(int i) const {
    return sm + L.cst + i;
  }
  __device__ __forceinline__ float mind() const { return *cst(D::C_MIND); }
  // stage k of slot j, or -1 past the horizon
  __device__ __forceinline__ int stage(int j) const {
    const int k = t + TPL * j;
    return k <= H ? k : -1;
  }

  __device__ void fresh_rows(int k, const float x[N], const float u[NU],
                             Rows& r) const {
    const float* o = sm + L.obs + (a.moving ? k * OBS_LD : 0);
    float ob[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) ob[i] = o[i];
    compute_rows(a, x, u, ob, k == H, k == 0, r);
  }

  // ---- the lane's inputs into shared memory and registers
  __device__ void load() {
    const size_t l = (size_t)lane;
    for (int e = t; e < N * S; e += TPL)
      sm[L.xref + e] = b.xref[l * N * S + e];
    for (int e = t; e < NU * H; e += TPL) sm[L.U + e] = b.U[l * NU * H + e];
    if (t < NU) {   // the terminal stage's inputs and input step: zero
      sm[L.U + H * NU + t] = 0.f;
      sm[L.ddU + H * NU + t] = 0.f;
    }
    if (a.moving) {
      for (int e = t; e < 6 * S; e += TPL)
        sm[L.obs + (e / 6) * OBS_LD + e % 6] = b.obs[l * 6 * S + e];
    } else if (t < 6) {
      sm[L.obs + t] = b.obs[l * 6 + t];
    }
    if (t < D::C_X0) {
      sm[L.cst + t] = b.w[l * D::C_X0 + t];           // wq, wr, wqN
    } else if (t < D::C_MIND) {
      sm[L.cst + t] = b.x0[l * N + t - D::C_X0];
    } else if (t == D::C_MIND) {
      sm[L.cst + t] = b.mind[l];
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = stage(j);
      if (k < 0) continue;
      const float* zl = b.z_lo + (l * S + k) * NR;
      const float* zh = b.z_hi + (l * S + k) * NR;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        st[j].zl[i] = zl[i];
        st[j].zh[i] = zh[i];
        st[j].sl[i] = st[j].sh[i] = 1.f;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) st[j].dx[i] = 0.f;
#pragma unroll
      for (int i = 0; i < NU; ++i) st[j].du[i] = 0.f;
    }
    __syncwarp();
  }

  // ---- the results back to device memory
  __device__ void store() const {
    if (!live) return;
    const size_t l = (size_t)lane;
    for (int e = t; e < N * S; e += TPL) b.X[l * N * S + e] = sm[L.X + e];
    for (int e = t; e < NU * H; e += TPL) b.U[l * NU * H + e] = sm[L.U + e];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = stage(j);
      if (k < 0) continue;
      float* zl = b.z_lo + (l * S + k) * NR;
      float* zh = b.z_hi + (l * S + k) * NR;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        zl[i] = st[j].zl[i];
        zh[i] = st[j].zh[i];
      }
    }
  }

  // ---- rollouts

  // Running sum of column i of the per-stage increments from x0 into Xs
  // (thread 0): x_{k+1} = x_k + inc_k, the additions of step_fn in order.
  __device__ __forceinline__ void running_sum(float* Xs, int i) const {
    const float* inc = sm + L.inc;
    float x = *cst(D::C_X0 + i);
    for (int k = 0; k < H; ++k) {
      Xs[k * N + i] = x;
      x = x + inc[k * N + i];
    }
    Xs[H * N + i] = x;
  }

  // States from x0 under the inputs Us (no feedback) into Xs.  A step's
  // increment x_{k+1} - x_k = dt6 (k1 + 2 k2 + 2 k3 + k4) (dt k1 for
  // Euler) depends on (delta, v) alone in its steering and speed rows, on
  // (delta, v, u) alone in its heading row and on (delta, v, psi, u) alone
  // in its position rows.  So three rounds, each an increment on every
  // stage's owner at once (the transcendentals of step_fn's four KS
  // evaluations, with step_fn's own arithmetic) and then its running sum
  // on thread 0: steering and speed, heading, position.
  __device__ void rollout(const float* Us, float* Xs) const {
    float* inc = sm + L.inc;
    float kp[SPT][3];   // heading rates of k1, k2, k3 at each own stage
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = stage(j);
      if (k < 0 || k == H) continue;
      const float u0 = Us[k * NU], u1 = Us[k * NU + 1];
      inc[k * N + 2] = a.rk4 ? a.dt6 * (u0 + 2.f * u0 + 2.f * u0 + u0)
                              : a.dt * u0;
      inc[k * N + 3] = a.rk4 ? a.dt6 * (u1 + 2.f * u1 + 2.f * u1 + u1)
                              : a.dt * u1;
    }
    __syncwarp();
    if (t == 0) {
      running_sum(Xs, 2);
      running_sum(Xs, 3);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = stage(j);
      if (k < 0 || k == H) continue;
      const float delta = Xs[k * N + 2], v = Xs[k * N + 3];
      const float u0 = Us[k * NU], u1 = Us[k * NU + 1];
      const float k1 = v * tanf(delta) * a.inv_l;
      kp[j][0] = k1;
      if (!a.rk4) {
        inc[k * N + 4] = a.dt * k1;
        continue;
      }
      // x2 and x3 share (delta, v): k3's heading rate is k2's
      const float v2 = v + a.half_dt * u1;
      const float k2 = v2 * tanf(delta + a.half_dt * u0) * a.inv_l;
      const float v4 = v + a.dt * u1;
      const float k4 = v4 * tanf(delta + a.dt * u0) * a.inv_l;
      kp[j][1] = kp[j][2] = k2;
      inc[k * N + 4] = a.dt6 * (k1 + 2.f * k2 + 2.f * k2 + k4);
    }
    __syncwarp();
    if (t == 0) running_sum(Xs, 4);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = stage(j);
      if (k < 0 || k == H) continue;
      const float v = Xs[k * N + 3], psi = Xs[k * N + 4];
      if (!a.rk4) {
        inc[k * N + 0] = a.dt * (v * cosf(psi));
        inc[k * N + 1] = a.dt * (v * sinf(psi));
        continue;
      }
      const float u1 = Us[k * NU + 1];
      const float v2 = v + a.half_dt * u1, v4 = v + a.dt * u1;
      const float p2 = psi + a.half_dt * kp[j][0];
      const float p3 = psi + a.half_dt * kp[j][1];
      const float p4 = psi + a.dt * kp[j][2];
      inc[k * N + 0] = a.dt6 * (v * cosf(psi) + 2.f * (v2 * cosf(p2)) +
                                 2.f * (v2 * cosf(p3)) + v4 * cosf(p4));
      inc[k * N + 1] = a.dt6 * (v * sinf(psi) + 2.f * (v2 * sinf(p2)) +
                                 2.f * (v2 * sinf(p3)) + v4 * sinf(p4));
    }
    __syncwarp();
    if (t == 0) {
      running_sum(Xs, 0);
      running_sum(Xs, 1);
    }
    __syncwarp();
  }

  // max(lo - h, h - hi, 0) of row i (raw).
  __device__ float row_viol(const Rows& r, int i, bool is_term) const {
    bool has_lo, has_hi;
    float lo, hi;
    row_bounds_of<false>(a, i, is_term, mind(), has_lo, lo, has_hi, hi);
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

  // The rows of the rollout (Xs, Us), each stage on its owner: stored into
  // the rows cache when ``write``; with ``merit``, returns objective +
  // rho * viol (1e30 when not finite).
  __device__ float stage_rows(const float* Xs, const float* Us, bool write,
                              bool merit) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = stage(j);
      if (k < 0) continue;
      const bool is_term = k == H;
      const float* x = Xs + k * N;
      const float* u = Us + k * NU;
      Rows r;
      fresh_rows(k, x, u, r);
      if (write) rows(k) = r;
      if (merit) {
        if (!is_term) {
          acc = acc +
                (stage_cost<N>(x, u, xref(k), cst(D::C_WQ), cst(D::C_WR)) +
                 a.rho * penalty_viol(r, false));
        } else {
          const float tc =
              a.use_term ? term_cost<N>(x, xref(k), cst(D::C_WQN)) : 0.f;
          acc = acc + (tc + a.rho * penalty_viol(r, true));
        }
      }
    }
    __syncwarp();
    if (!merit) return 0.f;
    acc = warp_sum(acc);
    return finite_f32(acc) ? acc : BIG;
  }

  // The RTI step U <- clip(U + alpha dU) and its rollout; ``write``
  // commits (X, U) and the rows cache, else the trial goes to (Xt, Ut).
  __device__ float du_rollout(float alpha, bool write, bool merit) {
    float* Ud = sm + (write ? L.U : L.Ut);
    float* Xd = sm + (write ? L.X : L.Xt);
    const float* Us = sm + L.U;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = stage(j);
      if (k < 0) continue;
      if (k == H) {   // the terminal stage has no input
        Ud[k * NU] = Ud[k * NU + 1] = 0.f;
        continue;
      }
      const float u0 = clipf(Us[k * NU] + alpha * st[j].du[0], a.u_lo0,
                             a.u_hi0);
      const float u1 = clipf(Us[k * NU + 1] + alpha * st[j].du[1], a.u_lo1,
                             a.u_hi1);
      Ud[k * NU] = u0;
      Ud[k * NU + 1] = u1;
    }
    __syncwarp();
    rollout(Ud, Xd);
    return stage_rows(Xd, Ud, write, merit);
  }

  // ---- the IP iterations

  // Slacks and duals from the margins of the cached rows (or the warm
  // duals); dX = dU = 0.
  __device__ void init_ip() {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = stage(j);
      if (k < 0) continue;
      const bool is_term = k == H;
      const Rows& r = rows(k);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        bool has_lo, has_hi;
        float lo, hi;
        row_bounds_of<false>(a, i, is_term, mind(), has_lo, lo, has_hi, hi);
        const float h = row_value(r, i);
        float sl = 1.f, zl = 0.f, sh = 1.f, zh = 0.f;
        if (has_lo) side_init(h - lo, st[j].zl[i], a.warm != 0, sl, zl);
        if (has_hi) side_init(hi - h, st[j].zh[i], a.warm != 0, sh, zh);
        st[j].sl[i] = sl;
        st[j].sh[i] = sh;
        st[j].zl[i] = zl;
        st[j].zh[i] = zh;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) st[j].dx[i] = 0.f;
#pragma unroll
      for (int i = 0; i < NU; ++i) st[j].du[i] = 0.f;
    }
  }

  // Stage quadratics at the shifted point (X + dX, U + dU), each on its
  // owner: the IP row weights w (gh) and sigma = z / s (gn), then the
  // quadratic into shared memory (the terminal one into P and p, where the
  // sweep starts); with ``fill_ab`` also (A, B) at the outer iterate.
  __device__ void stage_quads(float mu_b, bool fill_ab) {
    __syncwarp();   // the last step's readers of P, the quadratics, ab
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = stage(j);
      if (k < 0) continue;
      const bool is_term = k == H;
      const StageState& s = st[j];
      const Rows& r = rows(k);
      float gh[NR], gn[NR];
      {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          bool has_lo, has_hi;
          float lo, hi;
          row_bounds_of<false>(a, i, is_term, mind(), has_lo, lo, has_hi, hi);
          const float c = row_lin(r, i, s.dx, s.du);
          float w = 0.f, sig = 0.f;
          if (has_hi) {
            const float rs = s.sh[i] - (hi - c);
            const float sg = s.zh[i] / s.sh[i];
            w = w + mu_b / s.sh[i] + sg * rs;
            sig = sig + sg;
          }
          if (has_lo) {
            const float rs = s.sl[i] - (c - lo);
            const float sg = s.zl[i] / s.sl[i];
            w = w - mu_b / s.sl[i] - sg * rs;
            sig = sig + sg;
          }
          gh[i] = w;
          gn[i] = sig;
        }
      }
      const float* xk = sm + L.X + k * N;
      const float* uk = sm + L.U + k * NU;
      float xc[N], uc[NU];
#pragma unroll
      for (int i = 0; i < N; ++i) xc[i] = xk[i] + s.dx[i];
#pragma unroll
      for (int i = 0; i < NU; ++i) uc[i] = is_term ? 0.f : uk[i] + s.du[i];
      float Q[N][N], R[NU][NU], M[N][NU], qx[N], qu[NU];
      assemble_quad(r, gh, gn, xc, uc, xref(k),
                    is_term ? cst(D::C_WQN) : cst(D::C_WQ), cst(D::C_WR),
                    is_term, is_term ? a.use_term != 0 : true, Q, R, M, qx, qu);
      if (is_term) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
          for (int c = 0; c < N; ++c) sm[L.P + i * N + c] = Q[i][c];
          sm[L.p + i] = qx[i];
        }
        continue;
      }
      float* q = quad(k);
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int c = i; c < N; ++c) q[ut(i, c)] = Q[i][c];
#pragma unroll
        for (int c = 0; c < NU; ++c) q[D::QO_M + i * NU + c] = M[i][c];
        q[D::QO_QX + i] = qx[i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int c = 0; c < NU; ++c) q[D::QO_R + i * NU + c] = R[i][c];
        q[D::QO_QU + i] = qu[i];
      }
      if (fill_ab) store_ab(k, xk, uk);
    }
    __syncwarp();
  }

  __device__ void store_ab(int k, const float* xk, const float* uk) const {
    float* o = ab(k);
    float A[N][N], Bm[N][NU];
    lin_step(a, xk, uk, A, Bm);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int c = 0; c < N; ++c) o[i * N + c] = A[i][c];
#pragma unroll
      for (int c = 0; c < NU; ++c) o[N * N + i * NU + c] = Bm[i][c];
    }
  }

  // Slack and dual steps of row i from the current (dX, dU) and the
  // Newton direction; a missing side steps by 0.
  __device__ __forceinline__ void side_steps(const StageState& s,
                                             int i, bool has_lo, float lo,
                                             bool has_hi, float hi, float c,
                                             float jd, float mu_b, float& dsl,
                                             float& dzl, float& dsh,
                                             float& dzh) const {
    dsl = dzl = dsh = dzh = 0.f;
    if (has_lo) {
      const float rs = s.sl[i] - (c - lo);
      const float sg = s.zl[i] / s.sl[i];
      dsl = jd - rs;
      dzl = mu_b / s.sl[i] - s.zl[i] - sg * dsl;
    }
    if (has_hi) {
      const float rs = s.sh[i] - (hi - c);
      const float sg = s.zh[i] / s.sh[i];
      dsh = -jd - rs;
      dzh = mu_b / s.sh[i] - s.zh[i] - sg * dsh;
    }
  }

  // The slack and dual steps of every stage: the least fraction-to-
  // boundary ratio (``apply`` false), or the step of length alpha on
  // (dX, dU, s, z), slacks floored at S_FLOOR and duals capped at Z_MAX,
  // returning this thread's share of the complementarity gap.
  template <bool apply>
  __device__ float dual_pass(float mu_b, float alpha) {
    float acc = apply ? 0.f : BIG;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = stage(j);
      if (k < 0) continue;
      const bool is_term = k == H;
      StageState& s = st[j];
      const Rows& r = rows(k);
      const float* ddx = sm + L.ddX + k * N;
      const float* ddu = sm + L.ddU + k * NU;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        bool has_lo, has_hi;
        float lo, hi;
        row_bounds_of<false>(a, i, is_term, mind(), has_lo, lo, has_hi, hi);
        const float c = row_lin(r, i, s.dx, s.du);
        const float jd = row_lin(r, i, ddx, ddu) - row_value(r, i);
        float dsl, dzl, dsh, dzh;
        side_steps(s, i, has_lo, lo, has_hi, hi, c, jd, mu_b, dsl, dzl, dsh,
                   dzh);
        if (!apply) {
          if (has_lo) {
            acc = ftb(s.sl[i], dsl, acc);
            acc = ftb(s.zl[i], dzl, acc);
          }
          if (has_hi) {
            acc = ftb(s.sh[i], dsh, acc);
            acc = ftb(s.zh[i], dzh, acc);
          }
          continue;
        }
        float sl = 1.f, zl = 0.f, sh = 1.f, zh = 0.f;
        if (has_lo) {
          sl = nmax(s.sl[i] + alpha * dsl, S_FLOOR);
          zl = nmin(s.zl[i] + alpha * dzl, Z_MAX);
          acc = acc + sl * zl;
        }
        if (has_hi) {
          sh = nmax(s.sh[i] + alpha * dsh, S_FLOOR);
          zh = nmin(s.zh[i] + alpha * dzh, Z_MAX);
          acc = acc + sh * zh;
        }
        s.sl[i] = sl;
        s.zl[i] = zl;
        s.sh[i] = sh;
        s.zh[i] = zh;
      }
      if (!apply) continue;
#pragma unroll
      for (int i = 0; i < N; ++i) s.dx[i] = s.dx[i] + alpha * ddx[i];
      if (!is_term) {
#pragma unroll
        for (int i = 0; i < NU; ++i) s.du[i] = s.du[i] + alpha * ddu[i];
      }
    }
    return acc;
  }

  // One primal-dual Newton step; returns the next barrier.
  __device__ float newton(float mu_b, bool fill_ab) {
    stage_quads(mu_b, fill_ab);
    __syncthreads();
    if (w == 0 && t < lpb) sweep_lane(a, block_sm + t * L.total, L);
    __syncthreads();
    const float amin = warp_min(dual_pass<false>(mu_b, 0.f));
    const float alpha = nmin(1.f, TAU * amin);
    const float gap = warp_sum(dual_pass<true>(mu_b, alpha));
    return nmax(SIGMA_B * gap / a.n_act, MU_MIN);
  }

  // The RTI step of SQP iteration ``si``: dU scrubbed, then the unguarded
  // full step or the ladder.
  __device__ void rti_step(int si) {
#pragma unroll
    for (int j = 0; j < SPT; ++j)
#pragma unroll
      for (int i = 0; i < NU; ++i)
        st[j].du[i] = finite_f32(st[j].du[i]) ? st[j].du[i] : 0.f;
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
    if (b.rung && t == 0 && live)
      b.rung[(size_t)si * a.B + lane] = best_rung;
    du_rollout(best_a, true, false);
  }

  // stat (adjoint Lagrangian stationarity with lam = z_hi - z_lo), viol,
  // cost at the final iterate; rows from the cache, (A, B) recomputed.
  // The per-stage terms on the owners, the adjoint on one thread.
  __device__ void diagnostics() {
    const float zero[NR] = {};
    const size_t l = (size_t)lane;
    float viol = 0.f, cost = 0.f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = stage(j);
      if (k < 0) continue;
      const bool is_term = k == H;
      const Rows& r = rows(k);
      float lr[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) lr[i] = st[j].zh[i] - st[j].zl[i];
      const float* x = sm + L.X + k * N;
      const float* u = sm + L.U + k * NU;
      float Q[N][N], R[NU][NU], M[N][NU], qx[N], qu[NU];
      assemble_quad(r, lr, zero, x, u, xref(k),
                    is_term ? cst(D::C_WQN) : cst(D::C_WQ), cst(D::C_WR),
                    is_term, is_term ? a.use_term != 0 : true, Q, R, M, qx, qu);
      float* q = quad(k);
#pragma unroll
      for (int i = 0; i < N; ++i) q[D::QO_QX + i] = qx[i];
#pragma unroll
      for (int i = 0; i < NU; ++i) q[D::QO_QU + i] = qu[i];
      if (!is_term) store_ab(k, x, u);
      float* pv = b.pviol + (l * S + k) * NR;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float vi = row_viol(r, i, is_term);
        if (live) pv[i] = vi;
        viol = nmax(viol, scaled(i, vi));
      }
      if (!is_term) {
        cost = cost + stage_cost<N>(x, u, xref(k), cst(D::C_WQ), cst(D::C_WR));
      } else if (a.use_term) {
        cost = cost + term_cost<N>(x, xref(k), cst(D::C_WQN));
      }
    }
    __syncwarp();
    viol = warp_max(viol);
    cost = warp_sum(cost);
    __syncthreads();
    if (w == 0 && t < lpb) adjoint_lane(a, block_sm + t * L.total, L);
    __syncthreads();
    const float stat = sm[L.stat];
    if (t == 0 && live) {
      b.diag[l * 4 + 0] = stat;
      b.diag[l * 4 + 1] = viol;
      b.diag[l * 4 + 2] = cost;
      b.diag[l * 4 + 3] = cost;
    }
  }
};

// One warp a lane, lanes_per_block warps a block.  __grid_constant__: the
// IpLane object keeps references to the parameters, which then stay in the
// constant bank instead of a local copy.
template <int SPT>
__global__ void __launch_bounds__(TPL * MAX_LPB)
fused_ip_kernel(const __grid_constant__ IpArgs a,
                                const __grid_constant__ IpBufs b) {
  extern __shared__ float smem_dyn[];
  const int w = threadIdx.x / TPL, lpb = blockDim.x / TPL;
  const int lane = blockIdx.x * lpb + w;
  // a warp past the last lane solves a copy of it and stores nothing, so
  // that every warp of the block meets the same __syncthreads
  const Layout L(a.H);
  IpLane<SPT> s(a, b, lane < a.B ? lane : a.B - 1, lane < a.B,
                threadIdx.x % TPL, w, lpb, smem_dyn, L);
  s.load();
  s.rollout(s.sm + L.U, s.sm + L.X);
  s.stage_rows(s.sm + L.X, s.sm + L.U, true, false);
  for (int si = 0; si < a.ip_sqp_iters; ++si) {
    // warm duals chain across SQP iterations and MPC steps: the registers
    // hold the caller's duals at si = 0 and the last QP's after
    s.init_ip();
    float mu_b = MU0;
    for (int it = 0; it < a.ip_iters; ++it) mu_b = s.newton(mu_b, it == 0);
    s.rti_step(si);
  }
  s.diagnostics();
  s.store();
}

// Lanes per block when the caller gives none: the most lanes resident on
// an SM (occupancy API: registers and shared memory together), the most
// lanes a block among equals.  Fills out[] as fused_ip_geometry does; the
// most lanes a block is the most whose block fits an SM at all.
template <int SPT>
static int geometry(const IpArgs* args, int32_t out[6]) {
  auto kernel = fused_ip_kernel<SPT>;
  int dev = 0, optin = 0, err;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return err;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)))
    return err;
  const int lane_bytes =
      Layout(args->H).total * (int)sizeof(float);
  int smem_lpb = optin / lane_bytes;
  if (smem_lpb > MAX_LPB) smem_lpb = MAX_LPB;
  int best = 0, best_per_sm = 0, max_lpb = 0, given_per_sm = 0;
  for (int l = 1; l <= smem_lpb; ++l) {
    int nb = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &nb, kernel, TPL * l, (size_t)l * lane_bytes)))
      return err;
    if (nb < 1) break;
    max_lpb = l;
    if (nb * l >= best_per_sm) best = l, best_per_sm = nb * l;
    if (l == args->lanes_per_block) given_per_sm = nb * l;
  }
  const int lpb = args->lanes_per_block > 0 ? args->lanes_per_block : best;
  const int per_sm = args->lanes_per_block > 0 ? given_per_sm : best_per_sm;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel))) return err;
  out[0] = lpb;
  out[1] = lane_bytes;
  out[2] = lpb * lane_bytes;
  out[3] = lpb > 0 ? per_sm / lpb : 0;
  out[4] = fa.numRegs;
  out[5] = max_lpb;
  return 0;
}

template <int SPT>
static int launch(const IpArgs* args, const IpBufs& b, void* stream) {
  int32_t g[6];
  int err = geometry<SPT>(args, g);
  if (err) return err;
  const int lpb = g[0];
  if (lpb < 1 || lpb > g[5]) return (int)cudaErrorInvalidValue;
  // the smallest shared-memory carveout that holds the resident blocks
  // (1 KB a block is the system's), leaving the rest to L1
  int dev = 0, sm_bytes = 0;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(
           &sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)))
    return err;
  const long need = (long)g[3] * (g[2] + 1024);
  int pct = (int)((100 * need + sm_bytes - 1) / sm_bytes);
  if (pct > 100) pct = 100;
  auto kernel = fused_ip_kernel<SPT>;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributePreferredSharedMemoryCarveout, pct)))
    return err;
  const int threads = TPL * lpb;
  const int blocks = (args->B + lpb - 1) / lpb;
  const size_t smem = (size_t)g[2];
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(*args, b);
  return (int)cudaGetLastError();
}

// Floats of one lane's shared memory at horizon H (the Python side's
// eligibility mirrors it); -1 with the boundary rows, which this source
// does not build.
extern "C" int fused_ip_lane_floats(int H, int boundary) {
  return boundary ? -1 : Layout(H).total;
}

// The template instance of args: SPT = ceil((H + 1) / 32) stages a thread;
// -1 outside the kernel's horizons or with the boundary rows.
static int instance(const IpArgs* args) {
  const int spt = (args->H + TPL) / TPL;
  return spt < 1 || spt > MAX_SPT || args->boundary ? -1 : spt;
}

// The launch geometry at args: lanes per block (given or chosen), shared
// bytes a lane and a block, blocks resident an SM, registers a thread, the
// most lanes a block's shared memory holds.
extern "C" int fused_ip_geometry(const IpArgs* args, int32_t* out) {
  switch (instance(args)) {
    case 1: return geometry<1>(args, out);
    case 2: return geometry<2>(args, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The buffers of fused_ip.py's KERNEL_ORDER; bnd, the boundary rows'
// models, is refused here with the rows themselves (boundary = 1).
extern "C" int fused_ip_solve(const IpArgs* args, const float* x0,
                              const float* xref, const float* obs,
                              const float* mind, const float* w, float* U,
                              float* lam_lo, float* lam_hi, float* X,
                              float* pviol, float* diag, int32_t* rung,
                              const float* bnd, void* stream) {
  (void)bnd;
  IpBufs b{x0, xref, obs, mind, w, U, lam_lo, lam_hi, X, pviol, diag, rung};
  switch (instance(args)) {
    case 1: return launch<1>(args, b, stream);
    case 2: return launch<2>(args, b, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
