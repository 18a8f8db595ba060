// fused_gn.cu — the whole batched AL-SQP solve in one launch, for Hopper.
//
// Replaces mpc_tpu/ops/fused_gn.py::_make_kernel (the Pallas TPU kernel,
// launched by _solve_packed).  Computes, per lane: an initial rollout;
// al_iters x sqp_iters Gauss-Newton steps, each with analytic stage
// quadratics, the RK4/Euler chain-rule Jacobian, a Riccati sweep with a
// closed-form 2x2 Quu inverse, then either the unguarded full step with
// NaN/inf-scrubbed gains or the merit ladder; the multiplier and penalty
// update; and the diagnostics (adjoint stationarity, scaled violation,
// cost, merit).  The plain PyTorch version of the same function is
// fused_gn.py::solve_batch_fused_plain.
//
// What bounds it on an H100.  By the roofline the warm 1x1 budget is bound
// by its bytes (~16 KB a lane of inputs and outputs) and the cold 3x4
// budget by its fp32 operations (~10^6 a lane at H=30); in practice both
// are bound by latency.  About 70% of a solve's operations are separable
// by stage (rows, AL terms, stage quadratics, the RK4 (A, B), the
// multiplier update, the diagnostics' per-stage terms); the rest are
// chains from stage to stage (the Riccati sweep, the closed-loop feedback
// rollout u_k = clip(ub_k + d_k + K_k (x_k - xb_k)), which cannot be split
// into per-stage increments, the open-loop initial rollout, the
// diagnostics' adjoint), which one thread a lane runs in order.  One thread
// a lane for everything (this kernel's first design) left one warp on each
// scheduler at the bench batch, with nothing to hide its latency.
//
// What the design does about it.
// - A block holds 32 lanes and T warps (T threads a lane, a template
//   parameter: 2, 4 or 8).  Thread (w, l) = (threadIdx.x / 32,
//   threadIdx.x % 32) serves lane blockIdx.x * 32 + l.  Every per-stage
//   load and store is (stage, field, lane) with the lane fastest, so a
//   warp's accesses coalesce with no transpose.
// - The chains run for lane l on thread l of warp 0: a whole warp busy, 32
//   lanes at once.  __launch_bounds__ caps the KS instances' registers at
//   128, so that 16 warps fit an SM (at T = 4 the 512 blocks of the bench
//   batch are all resident at once); the ST instances' cap is set by the
//   blocks their shared memory lets an SM hold (GnMinBlocks).
// - A Gauss-Newton step is a ring: warps 1..T-1 produce the operands of
//   stages H, H-1, ..., 0 (rows, AL terms, the stage quadratic and (A, B);
//   43 floats, the structural zeros and identity rows of Q, R, M, A and B
//   left out) into a ring of 6-7 stages in shared memory, and warp 0 runs
//   the Riccati step on each as it arrives, so that the sweep overlaps the
//   production.  Each slot has a full and an empty named barrier
//   between its one producer warp and warp 0.  The sweep keeps P and p in
//   shared memory at an odd stride: in registers, beside the step's
//   operands and products, they spilled ~600 B at the 128 cap.  The
//   diagnostics' adjoint is fed by the same ring.
// - The multiplier update that closes an AL iteration runs in the
//   producers of the next ring (the next AL iteration's first sweep, or the
//   diagnostics): a stage's rows are computed once and its multipliers read
//   once for both.
// - The rollouts fetch the next stage's X, U, K and d into a staging ring
//   in shared memory with cp.async while they compute this one; loaded
//   into registers instead, the copies spilled.
// - The rows are recomputed where the first design read a rows cache: a
//   stage's rows are a pure function of (X_k, U_k) and the obstacles, and
//   neither changed between the step that cached them and the step that
//   read them, so the values are the same bits.  (Stage H, cached by the
//   multiplier update with is_term = false and u = 0 and read with is_term
//   = true, differs only in the friction row's d/da, which is 2 * 0 = +0
//   either way and unread at stage H.)
// - The merit ladder runs its rungs across the warps: every rung reads the
//   same iterate and gains at a stage, and only its alpha and its own state
//   chain differ.  So thread (w, l) rolls out rung w (then w + T, ...) for
//   lane l, all T warps at once at full width, from one staging ring that
//   the block fills with cp.async and meets at a barrier a stage; 7 rungs
//   at T = 4 take 2 rounds where a rung a round on warp 0 took 7.  The
//   rolling thread adds up each stage's merit (its cost and its rows' AL
//   terms, a pure function of the stage's (x, u)) as it goes, over k =
//   0..H in order, and writes its trial chain to a slot of its own; thread
//   l of warp 0 then picks the rung by the sequential rule and the owners
//   commit that slot.
// - Sums keep their order: the ladder's merits over k = 0..H on the
//   rolling thread; each stage's cost and AL term to shared memory, which
//   thread l of warp 0 sums for lane l from stage H down with the
//   diagnostics' adjoint.  The violation maximum (NaN-propagating nmax,
//   exact in any order) comes from the producers' partials.  So no sum
//   changed order against the one-thread design.
// - Device-memory scratch: K and d (the sweep's, read by the rollouts) and
//   the ladder's trial chains Xc, Uc, a slot a rung.  The kernel also
//   writes the status (to_solution's mapping), so that a solve needs no
//   launch after it.
// - A thread past the last lane (the ragged last block) does no work and
//   stores nothing but meets every barrier, named ones included.
// - Threads a lane: given, or chosen with the occupancy API
//   (fused_gn_geometry): the most whose blocks are all resident at once.
// - No tensor cores: the products are 5x5 (7x7 for ST) in float32, and TF32
//   would break the float32 bands.
// - Road-boundary rows (BND, a template parameter: the instances without
//   them compile as before): 6 more rows a stage, whose models (18 floats
//   a stage, fused_gn.py::linearize_boundaries) the producers read from
//   device memory where they build a stage's rows.  Their gradients touch
//   only Q00, Q01, Q11, Q04, Q14, Q44 and qx0, qx1, qx4, which the ring's
//   43-float operand already carries, so the ring, the sweep and the
//   shared memory a lane are the same in both instances; the multipliers,
//   penalties and violations take 20 rows a stage in place of 14.
//
// - The model (Mdl, a template parameter: KsModel or StModel, orthogonal
//   to T and BND).  This source builds the KS instances; fused_gn_st.cu is
//   this source with FUSED_MODEL_ST defined, the ST instances (7 states,
//   tire dynamics; st_model.cuh), a library of its own that nvcc builds in
//   parallel with this one.  The model sets the ring's stage operand
//   (Ring<Mdl>: rows 2 and 3 of A are the identity's and of B a single
//   constant each in both models, since delta and v are pure integrators
//   under RK4 and Euler; the other rows of A and B are dense, and the ST
//   weights add Q55 and Q66: 43 floats a stage for KS, 71 for ST), the
//   staging ring's stage (19 or 25 floats), the sweep's P and p (31 or 57)
//   and so the shared memory a lane.  The ST (A, B) come from dual numbers
//   (StModel::lin), written entry by entry into the ring.
//
// Semantics kept from the TPU kernel on purpose: clips, maxima and signs
// propagate NaN (compares, not fminf/fmaxf), the unguarded step scrubs K
// and d of NaN/inf but commits a non-finite rollout into the warm start, a
// rung is taken on a strict "<" and recorded (0 for alpha = 0, r + 1 for
// alphas[r]) when the caller passes a rung buffer.  Build without
// --use_fast_math: the parity bands assume IEEE tanf, sqrtf, sinf, cosf and
// division.  The helpers it shares with fused_ip.cu are in ks_rows.cuh and
// st_model.cuh; the ring's stage operand (Ring), the named barriers and the
// cp.async copies it shares with fused_ip_ring.cu are in ring.cuh.  Its own
// slot accessors and ring loop below are the members they were before
// fused_ip_ring.cu: built from ring.cuh's free versions (the same
// arithmetic), the unguarded cold 3x4 budget took ~4% longer (PERF.md).

#include "ring.cuh"

#if defined(FUSED_MODEL_ST)
using Model = StModel;
#else
using Model = KsModel;
#endif

// Blocks an SM that __launch_bounds__ asks for at T threads a lane, which
// caps the registers at 65536 / (32 T blocks) a thread.  KS: 16 / T, 16
// warps an SM.  ST at T = 4: 2, the blocks its shared memory lets an SM
// hold at H >= 18 (80,000 B a block at the bench horizon H = 30; 3 blocks
// fit up to H = 17, where this cap, not shared memory, holds an SM to 2);
// 4, as before, bought no residency at H = 30, only a register cap at
// which the instance spilled 1,260 B a thread (PERF.md).  ST at T = 8:
// 16 / T = 2 (at 1, with no spill, it took 1.6-1.7x as long as at 2: half
// the lanes resident).
template <class Mdl, int T>
struct GnMinBlocks {
  static constexpr int value = Mdl::ST && T == 4 ? 2 : 16 / T;
};

struct FgnArgs {
  int32_t B, H, al_iters, sqp_iters, n_alphas;
  int32_t forcespro, rk4, moving, use_term, threads_per_lane;
  float dt, half_dt, dt6, inv_l, reg, d_ego, a_cap, inv_fr_scale;
  float u_lo0, u_hi0, u_lo1, u_hi1, d_lo, d_hi, v_lo, v_hi;
  float mu0, mu_factor, mu_max, viol_improve, lam_max, tol_feas, tol_stat;
  float tol_infeas;
  float alphas[MAX_ALPHAS];
  int32_t boundary;  // 1: the instance with the road-boundary rows
  float r_ego;       // their bound: r_ego <= h
  StConsts st;       // the ST model's constants (zero for KS)
};

#define NSTG 3    // stages in flight in a rollout's staging ring

// Floats of one lane's shared memory: the producers' partials (T), the
// ladder's slot, a cost and an AL term a stage, a rollout's
// staging ring, the ring of stage operands, and the sweep's P and p.
template <class Mdl>
__host__ __device__ __forceinline__ int lane_floats(int H, int T) {
  using RG = Ring<Mdl>;
  return T + 1 + 2 * (H + 1) + NSTG * RG::NROLL + ring_slots(T) * RG::NOP +
         RG::PSTR;
}

// --------------------------------------------------------------------------
// augmented-Lagrangian row terms
// --------------------------------------------------------------------------

// AL terms of one side: psi = (m^2 - lam^2) / (2 mu), grad = +-m, gn.
// An inactive side without a multiplier (m = +0, lam = +-0, mu > 0) has psi
// = (+0 - +0) / (2 mu) = +0 exactly, which skips the division: most sides
// of a stage are such, and these divisions are a large part of the
// ladder's merits (PERF.md).
__device__ __forceinline__ void al_one_sided(float h, float bound, float lam,
                                             float mu, bool is_hi, float& psi,
                                             float& grad, float& gn) {
  const float c = is_hi ? h - bound : bound - h;
  const float t = lam + mu * c;
  const bool act = t > 0.f;
  const float m = act ? t : 0.f;
  if (!act && lam == 0.f && mu > 0.f)
    psi = 0.f;
  else
    psi = (m * m - lam * lam) / (2.f * mu);
  grad = is_hi ? m : -m;
  gn = act ? mu : 0.f;
}

// AL terms of row i at value h: psi, d psi / d h and the GN diagonal,
// summed over its sides, with the row's multipliers (ll, lh, mu).
template <bool BND>
__device__ __forceinline__ void row_term(const FgnArgs& a, int i, float h,
                                         bool is_term, float mind, float ll,
                                         float lh, float mu, float& psi,
                                         float& gh, float& gn) {
  bool has_lo, has_hi;
  float lo, hi;
  row_bounds_of<BND>(a, i, is_term, mind, has_lo, lo, has_hi, hi);
  float ps = 0.f, g = 0.f, n = 0.f, p1, g1, n1;
  if (has_hi) {
    al_one_sided(h, hi, lh, mu, true, p1, g1, n1);
    ps = ps + p1;
    g = g + g1;
    n = n + n1;
  }
  if (has_lo) {
    al_one_sided(h, lo, ll, mu, false, p1, g1, n1);
    ps = ps + p1;
    g = g + g1;
    n = n + n1;
  }
  psi = ps;
  gh = g;
  gn = n;
}

// --------------------------------------------------------------------------
// the kernel
// --------------------------------------------------------------------------

struct Bufs {
  const float *x0, *xref, *obs, *mind, *w;
  float *U, *lam_lo, *lam_hi, *mu, *pviol, *X, *diag;
  int32_t* status;  // (B): 1 converged, 0 feasible, -7 infeasible
  float *K, *d, *Xc, *Uc;
  int32_t* rung;  // (al_iters * sqp_iters, B) or null
  const float* bnd;  // (H + 1, NBND, B) boundary rows' models or null
};

// One thread's share of a lane's solve: the stages it owns, and for warp 0
// the lane's chains.  BND: with the 6 road-boundary rows a stage; Mdl: the
// model.
template <int T, bool BND, class Mdl>
struct Solve {
  static constexpr int N = Mdl::N;  // states
  using RG = Ring<Mdl>;
  const FgnArgs& a;
  const Bufs& b;
  Lane L;
  const int w, l;
  const bool live;  // false: past the last lane; meets the barriers only
  float* const part;   // (T, LPB) the producers' violation partials
  int* const slot;     // (LPB) the ladder's best slot
  float* const sm_m;   // (H + 1, LPB) the stage costs
  float* const sm_p;   // (H + 1, LPB) the stages' AL terms
  float* const stg;    // (NSTG, RG::NROLL, LPB) the rollouts' staging ring
  float* const ring;   // (R, RG::NOP, LPB) the ring of stage operands; the
                       // ladder's merits (1 + n_alphas, LPB) between rings
  float* const pm;     // (LPB, PSTR) the sweep's P and p, lane by lane
  static constexpr int R = ring_slots(T);
  static constexpr int NRB = nrows<BND>();  // rows a stage
  using RowsT = RowsOf<BND>;
  float mind;

  __device__ Solve(const FgnArgs& a_, const Bufs& b_, int lane, bool live_,
                   int w_, int l_, float* smem)
      : a(a_), b(b_), w(w_), l(l_), live(live_), part(smem),
        slot(reinterpret_cast<int*>(smem + T * LPB)),
        sm_m(smem + (T + 1) * LPB),
        sm_p(smem + (T + 1 + a_.H + 1) * LPB),
        stg(smem + (T + 1 + 2 * (a_.H + 1)) * LPB),
        ring(smem + (T + 1 + 2 * (a_.H + 1) + NSTG * RG::NROLL) * LPB),
        pm(smem +
           (T + 1 + 2 * (a_.H + 1) + NSTG * RG::NROLL + R * RG::NOP) * LPB +
           l_ * RG::PSTR) {
    L.B = a.B;
    L.lane = lane;
    mind = b.mind[L.at(0, 0, 1)];
  }

  // per-lane weights, read where used (they stay in L1, not registers)
  __device__ __forceinline__ void weights(bool is_term, float wx[N],
                                          float wr[NU]) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      wx[i] = b.w[L.at(0, (is_term ? N + NU : 0) + i, 1)];
#pragma unroll
    for (int i = 0; i < NU; ++i) wr[i] = b.w[L.at(0, N + i, 1)];
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
  // Multiplier / penalty update of row i of stage k at value h (stage H:
  // u-box rows 10 and 11 left unchanged): stores lam_lo, lam_hi, mu and
  // the row's violation, and returns the new multipliers in (ll, lh, mu).
  __device__ __forceinline__ void update_row(int k, int i, float h,
                                             float& ll, float& lh,
                                             float& mu) const {
    const bool is_last = k == a.H;
    bool has_lo, has_hi;
    float lo, hi;
    row_bounds_of<BND>(a, i, false, mind, has_lo, lo, has_hi, hi);
    const size_t at = L.at(k, i, NRB);
    float nh = lh, nl = ll, v_hi = 0.f, v_lo = 0.f;
    if (has_hi) {
      nh = clipf(relu(lh + mu * (h - hi)), 0.f, a.lam_max);
      v_hi = nmax(h - hi, 0.f);
    }
    if (has_lo) {
      nl = clipf(relu(ll + mu * (lo - h)), 0.f, a.lam_max);
      v_lo = nmax(lo - h, 0.f);
    }
    float viol = nmax(v_hi, v_lo);
    if ((i == 10 || i == 11) && is_last) {
      nh = lh;
      nl = ll;
      viol = 0.f;
    }
    const bool stalled = viol > a.viol_improve * b.pviol[at];
    const bool active = viol > a.tol_feas;
    const float m_new =
        clipf(stalled && active ? mu * a.mu_factor : mu, a.mu0, a.mu_max);
    b.lam_lo[at] = nl;
    b.lam_hi[at] = nh;
    b.mu[at] = m_new;
    b.pviol[at] = viol;
    ll = nl;
    lh = nh;
    mu = m_new;
  }

  // AL terms of every row of stage k at rows r, the multipliers read row
  // by row (so that no array of them stays live), after their update when
  // UPDATE; psi summed over the rows in order into ``psum``.
  template <bool UPDATE>
  __device__ void terms(const RowsT& r, int k, bool is_term, float& psum,
                        float gh[NRB], float gn[NRB]) const {
#pragma unroll
    for (int i = 0; i < NRB; ++i) {
      const float h = row_value(r, i);
      const size_t at = L.at(k, i, NRB);
      float ll = b.lam_lo[at], lh = b.lam_hi[at], mu = b.mu[at], psi;
      if (UPDATE) update_row(k, i, h, ll, lh, mu);
      row_term<BND>(a, i, h, is_term, mind, ll, lh, mu, psi, gh[i], gn[i]);
      psum = i == 0 ? psi : psum + psi;
    }
  }
  // (x, u) of stage k of a chain; u = 0 at the terminal stage
  __device__ __forceinline__ void xu(const float* Xs, const float* Us, int k,
                                     float x[N], float u[NU]) const {
    load(Xs, k, N, x);
    if (k < a.H) {
      load(Us, k, NU, u);
    } else {
      u[0] = u[1] = 0.f;
    }
  }
  __device__ void fresh_rows(int k, const float x[N], const float u[NU],
                             bool is_term, RowsT& r) const {
    float o[6];
    obs_at(k, o);
    compute_rows(a, x, u, o, is_term, k == 0, r);
    if constexpr (BND) {
      float m[NBND];
      load(b.bnd, k, NBND, m);
      boundary_rows(a, x, m, r);
    }
  }

  // ---- a stage's operands (field f of slot s of the ring)
  __device__ __forceinline__ float& rg(int s, int f) const {
    return ring[(s * RG::NOP + f) * LPB + l];
  }
  __device__ void put_quad(int s, const float Q[N][N],
                           const float R[NU][NU], const float M[N][NU],
                           const float qx[N], const float qu[NU]) const {
    const float qv[9] = {Q[0][0], Q[0][1], Q[1][1], Q[0][4], Q[1][4],
                         Q[4][4], Q[2][2], Q[2][3], Q[3][3]};
#pragma unroll
    for (int i = 0; i < 9; ++i) rg(s, RG::OP_Q + i) = qv[i];
#pragma unroll
    for (int i = 5; i < N; ++i) rg(s, RG::OP_Q + 4 + i) = Q[i][i];
    rg(s, RG::OP_R) = R[0][0];
    rg(s, RG::OP_R + 1) = R[1][1];
    rg(s, RG::OP_M) = M[2][1];
    rg(s, RG::OP_M + 1) = M[3][1];
#pragma unroll
    for (int i = 0; i < N; ++i) rg(s, RG::OP_QX + i) = qx[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) rg(s, RG::OP_QU + i) = qu[i];
  }
  __device__ void put_ab(int s, const float A[N][N],
                         const float Bm[N][NU]) const {
#pragma unroll
    for (int r = 0; r < RG::NAR; ++r) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        rg(s, RG::OP_A + r * N + j) = A[RG::arow(r)][j];
#pragma unroll
      for (int j = 0; j < NU; ++j)
        rg(s, RG::OP_B + r * NU + j) = Bm[RG::arow(r)][j];
    }
    rg(s, RG::OP_BD) = Bm[2][0];
    rg(s, RG::OP_BD + 1) = Bm[3][1];
  }
  // entry (i, j) of [A | B] into ring slot s (StModel::lin's put): rows 2
  // and 3 only through B20 and B31, the other entries of those rows being
  // the identity's and zero
  __device__ __forceinline__ void put_ab_entry(int s, int i, int j,
                                               float v) const {
    if (i == 2 || i == 3) {
      if (j == N + i - 2) rg(s, RG::OP_BD + i - 2) = v;
      return;
    }
    const int r = i < 2 ? i : i - 2;
    rg(s, j < N ? RG::OP_A + r * N + j : RG::OP_B + r * NU + j - N) = v;
  }
  // field f of stage k in the staging ring, and a stage's fetch into it
  __device__ __forceinline__ float& st(int k, int f) const {
    return stg[((k % NSTG) * RG::NROLL + f) * LPB + l];
  }
  __device__ __forceinline__ void fetch(int k, int f, const float* src,
                                        int i, int n) const {
    copy_async(&st(k, f), src + L.at(k, i, n));
  }
  // X, U, K and d of stage k < H (the feedback rollout's)
  __device__ void fetch_roll(int k) const {
#pragma unroll
    for (int i = 0; i < N; ++i) fetch(k, i, b.X, i, N);
#pragma unroll
    for (int i = 0; i < NU; ++i) fetch(k, N + i, b.U, i, NU);
#pragma unroll
    for (int i = 0; i < NU * N; ++i) fetch(k, N + NU + i, b.K, i, NU * N);
#pragma unroll
    for (int i = 0; i < NU; ++i)
      fetch(k, N + NU + NU * N + i, b.d, i, NU);
    copy_commit();
  }

  // Q and qx of a stage, field i read by g(i) (the full symmetric Q, zeros
  // where assemble_quad leaves them)
  template <class G>
  __device__ void get_qx(G g, float Q[N][N], float qx[N]) const {
    float qv[RG::NQ];
#pragma unroll
    for (int i = 0; i < RG::NQ; ++i) qv[i] = g(RG::OP_Q + i);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) Q[i][j] = 0.f;
    Q[0][0] = qv[0];
    Q[0][1] = Q[1][0] = qv[1];
    Q[1][1] = qv[2];
    Q[0][4] = Q[4][0] = qv[3];
    Q[1][4] = Q[4][1] = qv[4];
    Q[4][4] = qv[5];
    Q[2][2] = qv[6];
    Q[2][3] = Q[3][2] = qv[7];
    Q[3][3] = qv[8];
#pragma unroll
    for (int i = 5; i < N; ++i) Q[i][i] = qv[4 + i];
#pragma unroll
    for (int i = 0; i < N; ++i) qx[i] = g(RG::OP_QX + i);
  }
  // qu, A and B of a stage k < H (rows 2 and 3 of A are the identity's and
  // of B a single constant each, as both models' steps leave them)
  template <class G>
  __device__ void get_ab(G g, float qu[NU], float A[N][N],
                         float Bm[N][NU]) const {
#pragma unroll
    for (int i = 0; i < NU; ++i) qu[i] = g(RG::OP_QU + i);
#pragma unroll
    for (int r = 0; r < RG::NAR; ++r) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        A[RG::arow(r)][j] = g(RG::OP_A + r * N + j);
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Bm[RG::arow(r)][j] = g(RG::OP_B + r * NU + j);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      A[2][j] = j == 2 ? 1.f : 0.f;
      A[3][j] = j == 3 ? 1.f : 0.f;
    }
    Bm[2][0] = g(RG::OP_BD);
    Bm[2][1] = 0.f;
    Bm[3][0] = 0.f;
    Bm[3][1] = g(RG::OP_BD + 1);
  }

  // ---- separable work: stage by stage on the producers or the owners

  // The stage quadratic and (A, B) of stage k of the iterate (X, U) into
  // ring slot s, after the stage's multiplier update when UPDATE.
  // With DIAG also the stage's cost and AL term into shared memory,
  // and its largest scaled violation folded into v.  (The update reads the
  // rows at stage H as non-terminal ones, which differ from the terminal
  // ones only in the friction row's d/da, unread at stage H.)
  template <bool DIAG, bool UPDATE>
  __device__ void stage_ops(int k, int s, float& v) const {
    const bool is_term = k == a.H;
    float x[N], u[NU], xref[N], wx[N], wr[NU];
    xu(b.X, b.U, k, x, u);
    load(b.xref, k, N, xref);
    weights(is_term, wx, wr);
    RowsT r;
    fresh_rows(k, x, u, is_term && !UPDATE, r);
    float psum, gh[NRB], gn[NRB];
    terms<UPDATE>(r, k, is_term, psum, gh, gn);
    float Q[N][N], R[NU][NU], M[N][NU], qx[N], qu[NU];
    assemble_quad(r, gh, gn, x, u, xref, wx, wr, is_term,
                  is_term ? a.use_term != 0 : true, Q, R, M, qx, qu);
    put_quad(s, Q, R, M, qx, qu);
    if (DIAG) {
      float c;
      if (is_term)
        c = a.use_term ? term_cost<N>(x, xref, wx) : 0.f;
      else
        c = stage_cost<N>(x, u, xref, wx, wr);
      sm_m[k * LPB + l] = c;
      sm_p[k * LPB + l] = psum;
      v = scaled_viol(r, is_term, v);
    }
    if (!is_term) {
      if constexpr (Mdl::ST) {
        Mdl::lin(a, x, u,
                 [&](int i, int j, float v) { put_ab_entry(s, i, j, v); });
      } else {
        float A[N][N], Bm[N][NU];
        lin_step(a, x, u, A, Bm);
        put_ab(s, A, Bm);
      }
    }
  }

  // The ring: warps 1..T-1 produce the stage operands of k = H, H-1, ...,
  // 0 (stage H - j by warp 1 + j % (T - 1), into slot j % R), and warp 0
  // runs ``use(k, g)`` on each as it arrives (g(f): field f).  Slot s has
  // two named barriers between its producer and warp 0: full (1 + s) and
  // empty (1 + R + s).  Threads past the last lane meet the barriers only.
  template <bool DIAG, bool UPDATE, class Use>
  __device__ void ring_phase(Use use) const {
    constexpr int P = T - 1, PAIR = 2 * LPB;
    if (w == 0) {
      for (int j = 0; j <= a.H; ++j) {
        const int s = j % R;
        bar_wait(1 + s, PAIR);
        if (live) use(a.H - j, [&](int f) { return rg(s, f); });
        if (j + R <= a.H) bar_arrive(1 + R + s, PAIR);
      }
    } else {
      float v = 0.f;
      for (int j = w - 1; j <= a.H; j += P) {
        const int s = j % R;
        if (j >= R) bar_wait(1 + R + s, PAIR);
        if (live) stage_ops<DIAG, UPDATE>(a.H - j, s, v);
        bar_arrive(1 + s, PAIR);
      }
      if (DIAG) part[w * LPB + l] = v;
    }
  }

  // the ladder: copy the best chain into (X, U) at the owned stages
  __device__ void commit(const float* Xs, const float* Us) const {
    if (!live) return;
    for (int k = w; k <= a.H; k += T) {
      float v[N];
      load(Xs, k, N, v);
      store(b.X, k, N, v);
      if (k < a.H) {
        load(Us, k, NU, v);
        store(b.U, k, NU, v);
      }
    }
  }

  __device__ float scaled_viol(const RowsT& r, bool is_term, float v) const {
#pragma unroll
    for (int i = 0; i < NRB; ++i) {
      bool has_lo, has_hi;
      float lo, hi;
      row_bounds_of<BND>(a, i, is_term, mind, has_lo, lo, has_hi, hi);
      const float s = i == 0 ? a.inv_fr_scale : 1.f;
      const float h = row_value(r, i);
      if (has_hi) v = nmax(v, (h - hi) * s);
      if (has_lo) v = nmax(v, (lo - h) * s);
    }
    return v;
  }

  // ---- chains: thread l of warp 0 for lane l

  // Each chain fetches stage k + 1 (or k - 1) into the staging ring while
  // it computes stage k: wait for all but the newest group of copies.
  __device__ __forceinline__ void next(bool more) const {
    if (more)
      copy_wait<1>();
    else
      copy_wait<0>();
  }

  // open-loop rollout of U from x0 into X
  __device__ void initial_rollout() const {
    const auto fetch_u = [&](int k) {
#pragma unroll
      for (int i = 0; i < NU; ++i) fetch(k, i, b.U, i, NU);
      copy_commit();
    };
    float x[N], u[NU], xn[N];
    load(b.x0, 0, N, x);
    if (a.H > 0) fetch_u(0);
    for (int k = 0; k < a.H; ++k) {
      if (k + 1 < a.H) fetch_u(k + 1);
      next(k + 1 < a.H);
      store(b.X, k, N, x);
#pragma unroll
      for (int i = 0; i < NU; ++i) u[i] = st(k, i);
      Mdl::step(a, x, u, xn);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = xn[i];
    }
    store(b.X, a.H, N, x);
  }

  // The Riccati backward sweep over the ring -> K, d (scrubbed of NaN/inf
  // when ``scrub``: the recursion itself uses the raw gains).  ``update``:
  // the producers first apply the multiplier update that closed the last
  // AL iteration.
  __device__ void backward_sweep(bool scrub, bool update) const {
    // P and p in shared memory, not registers: the step's own operands
    // and products then fit 128 registers
    float(*P)[N] = reinterpret_cast<float(*)[N]>(pm);
    float* p = pm + N * N;
    const auto use = [&](int k, auto g) {
      if (k == a.H) {
        get_qx(g, P, p);
        return;
      }
      float Q[N][N], R[NU][NU], M[N][NU], qx[N], qu[NU], A[N][N],
          Bm[N][NU];
      get_qx(g, Q, qx);
      get_ab(g, qu, A, Bm);
      R[0][0] = g(RG::OP_R);
      R[1][1] = g(RG::OP_R + 1);
      R[0][1] = R[1][0] = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) M[i][0] = M[i][1] = 0.f;
      M[2][1] = g(RG::OP_M);
      M[3][1] = g(RG::OP_M + 1);
      float Kk[NU][N], dk[NU];
      riccati_step(a.reg, P, p, Q, R, M, qx, qu, A, Bm, Kk, dk);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float kv = Kk[i][j];
          b.K[L.at(k, i * N + j, NU * N)] =
              (scrub && !finite_f32(kv)) ? 0.f : kv;
        }
        b.d[L.at(k, i, NU)] = (scrub && !finite_f32(dk[i])) ? 0.f : dk[i];
      }
    };
    if (update)
      ring_phase<false, true>(use);
    else
      ring_phase<false, false>(use);
  }

  // The unguarded step: the feedback rollout u = clip(ub + d + K (x - xb))
  // from x0 against the current iterate (X, U), into (X, U) themselves.
  __device__ void full_step() const {
    float x[N], xn[N], xb[N], ub[NU], u[NU], Kk[NU * N], dk[NU];
    load(b.x0, 0, N, x);
    if (a.H > 0) fetch_roll(0);
    for (int k = 0; k < a.H; ++k) {
      if (k + 1 < a.H) fetch_roll(k + 1);
      next(k + 1 < a.H);
#pragma unroll
      for (int i = 0; i < N; ++i) xb[i] = st(k, i);
#pragma unroll
      for (int i = 0; i < NU; ++i) ub[i] = st(k, N + i);
#pragma unroll
      for (int i = 0; i < NU * N; ++i) Kk[i] = st(k, N + NU + i);
#pragma unroll
      for (int i = 0; i < NU; ++i) dk[i] = st(k, N + NU + NU * N + i);
      float dx[N];
#pragma unroll
      for (int i = 0; i < N; ++i) dx[i] = x[i] - xb[i];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float fb = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) fb += Kk[i * N + j] * dx[j];
        u[i] = (ub[i] + dk[i]) + fb;
      }
      u[0] = clipf(u[0], a.u_lo0, a.u_hi0);
      u[1] = clipf(u[1], a.u_lo1, a.u_hi1);
      Mdl::step(a, x, u, xn);
      store(b.X, k, N, x);
      store(b.U, k, NU, u);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = xn[i];
    }
    store(b.X, a.H, N, x);
  }

  // The merit of stage k of a trial chain at (x, u) (u = 0 at stage H):
  // its cost plus its rows' AL terms at the current multipliers.
  __device__ float stage_merit(int k, const float x[N],
                               const float u[NU]) const {
    const bool is_term = k == a.H;
    float xref[N], wx[N], wr[NU], p, gh[NRB], gn[NRB];
    load(b.xref, k, N, xref);
    weights(is_term, wx, wr);
    RowsT r;
    fresh_rows(k, x, u, is_term, r);
    terms<false>(r, k, is_term, p, gh, gn);
    float c;
    if (is_term)
      c = a.use_term ? term_cost<N>(x, xref, wx) : 0.f;
    else
      c = stage_cost<N>(x, u, xref, wx, wr);
    return c + p;
  }

  // Field f of stage k of the feedback rollout's inputs: X, U, K, d.
  __device__ __forceinline__ const float* roll_src(int k, int f) const {
    if (f < N) return b.X + L.at(k, f, N);
    if (f < N + NU) return b.U + L.at(k, f - N, NU);
    if (f < N + NU + NU * N) return b.K + L.at(k, f - N - NU, NU * N);
    return b.d + L.at(k, f - N - NU - NU * N, NU);
  }

  // One round of the ladder: thread (w, l) rolls rung q = q0 + w out for
  // lane l (q = 0: alpha = 0; q = r + 1: alphas[r]) into slot q of (Xc,
  // Uc), the feedback rollout's arithmetic, and adds up its stage merits
  // over k = 0..H in order as it goes, into shared memory (q, l).  The
  // rung threads share one staging ring: each thread fetches the fields f
  // = w mod T of its lane's next stage, and the block meets at a barrier
  // a stage.  A thread past the rungs or the lanes meets the barriers only.
  __device__ void ladder_round(int q0, float* mer) const {
    const int q = q0 + w;
    const bool act = live && q <= a.n_alphas;
    const float alpha = act && q > 0 ? a.alphas[q - 1] : 0.f;
    float* const Xo = b.Xc + (size_t)q * (a.H + 1) * N * a.B;
    float* const Uo = b.Uc + (size_t)q * a.H * NU * a.B;
    const auto fetch_part = [&](int k) {
      if (live)
        for (int f = w; f < RG::NROLL; f += T)
          copy_async(&st(k, f), roll_src(k, f));
      copy_commit();
    };
    float x[N], u[NU], acc = 0.f;
    load(b.x0, 0, N, x);
    __syncthreads();   // the last round's readers of the staging ring
    if (a.H > 0) fetch_part(0);
    for (int k = 0; k < a.H; ++k) {
      if (k + 1 < a.H) fetch_part(k + 1);
      next(k + 1 < a.H);
      // the stage's fields in from every thread; the slot fetched next
      // (k + 2) was last read at stage k - 1, before this barrier
      __syncthreads();
      if (!act) continue;
      float dx[N];
#pragma unroll
      for (int i = 0; i < N; ++i) dx[i] = x[i] - st(k, i);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float fb = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) fb += st(k, N + NU + i * N + j) * dx[j];
        u[i] = (st(k, N + i) + alpha * st(k, N + NU + NU * N + i)) + fb;
      }
      u[0] = clipf(u[0], a.u_lo0, a.u_hi0);
      u[1] = clipf(u[1], a.u_lo1, a.u_hi1);
      acc = acc + stage_merit(k, x, u);
      float xn[N];
      Mdl::step(a, x, u, xn);
      store(Xo, k, N, x);
      store(Uo, k, NU, u);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = xn[i];
    }
    if (!act) return;
    u[0] = u[1] = 0.f;
    acc = acc + stage_merit(a.H, x, u);
    store(Xo, a.H, N, x);
    mer[q * LPB + l] = acc;
  }

  // The line-search ladder of GN iteration ``it`` (over the whole solve):
  // the 1 + n_alphas rungs in rounds of T, a rung a warp (ladder_round),
  // each trial chain into a slot of its own with its merit; then thread l
  // of warp 0 picks lane l's rung by the sequential rule (alpha = 0 first,
  // a rung taken on a strict "<", so a NaN merit never wins), and the
  // owners commit the best chain.  The merits go to the ring's shared
  // memory, which no ring phase uses during the ladder.
  __device__ void ladder(int it) const {
    float* const mer = ring;
    for (int q0 = 0; q0 <= a.n_alphas; q0 += T) ladder_round(q0, mer);
    __syncthreads();
    if (live && w == 0) {
      int best = 0;
      float best_m = mer[l];
      for (int q = 1; q <= a.n_alphas; ++q) {
        const float m = mer[q * LPB + l];
        if (m < best_m) {
          best_m = m;
          best = q;
        }
      }
      if (b.rung) b.rung[(size_t)it * a.B + L.lane] = best;
      slot[l] = best;
    }
    __syncthreads();
    const int pick = slot[l];
    commit(b.Xc + (size_t)pick * (a.H + 1) * N * a.B,
           b.Uc + (size_t)pick * a.H * NU * a.B);
  }

  // The diagnostics, run by every thread: the producers apply the last
  // AL iteration's multiplier update and pass the stage terms through the
  // ring (the adjoint's qx, qu, A, B; each stage's cost and AL term in
  // shared memory) to warp 0, which runs the adjoint and sums the cost and
  // merit from stage H down; then the violation from the producers'
  // partials.
  __device__ void diagnostics() const {
    float lam[N], cost = 0.f, merit = 0.f, stat = 0.f;
    const auto use = [&](int k, auto g) {
      const float c = sm_m[k * LPB + l];
      if (k == a.H) {
        float Q[N][N];
        get_qx(g, Q, lam);
        cost = c;
        merit = c + sm_p[k * LPB + l];
        return;
      }
      float qx[N], qu[NU], A[N][N], Bm[N][NU];
#pragma unroll
      for (int i = 0; i < N; ++i) qx[i] = g(RG::OP_QX + i);
      get_ab(g, qu, A, Bm);
      float g_u[NU], lam_new[N];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < N; ++t) s += Bm[t][i] * lam[t];
        g_u[i] = qu[i] + s;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < N; ++t) s += A[t][i] * lam[t];
        lam_new[i] = qx[i] + s;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) lam[i] = lam_new[i];
      stat = nmax(stat, nmax(fabsf(g_u[0]), fabsf(g_u[1])));
      cost = cost + c;
      merit = merit + c + sm_p[k * LPB + l];
    };
    ring_phase<true, true>(use);
    __syncthreads();
    if (!live || w != 0) return;
    float viol = part[LPB + l];
    for (int t = 2; t < T; ++t) viol = nmax(viol, part[t * LPB + l]);
    b.diag[L.at(0, 0, 4)] = stat;
    b.diag[L.at(0, 1, 4)] = viol;
    b.diag[L.at(0, 2, 4)] = cost;
    b.diag[L.at(0, 3, 4)] = merit;
    // fused_gn.to_solution's mapping (viol is >= 0 or NaN here, so its
    // clamp at 0 changes nothing)
    const bool converged = stat < a.tol_stat && viol < a.tol_feas;
    b.status[L.lane] = converged ? 1 : (viol < a.tol_infeas ? 0 : -7);
  }
};

// 32 lanes and T warps a block; GnMinBlocks blocks an SM (KS: at most 128
// registers a thread, so that 16 warps fit an SM).  __grid_constant__: the
// Solve object keeps references
// to the parameters, which then stay in the constant bank instead of a
// local copy.  LAD: 1 the instance with the merit ladder (n_alphas > 0), 0
// the unguarded step's, -1 either, as the call asks.  The KS library builds
// 0 and 1: the ladder's code in the unguarded solve's instance spilled its
// registers (252 B at T = 4 against none), and called out of line it put
// the Solve in local memory; either cost the unguarded bench budgets 4-7%
// (PERF.md).  The ST library builds -1, which halves its build, the
// slowest of the port's (its dual-number producers).
template <int T, bool BND, class Mdl, int LAD>
__global__ void __launch_bounds__(LPB * T, GnMinBlocks<Mdl, T>::value)
fused_gn_kernel(const __grid_constant__ FgnArgs a,
                const __grid_constant__ Bufs b) {
  extern __shared__ float smem_dyn[];
  const int w = threadIdx.x / LPB, l = threadIdx.x % LPB;
  const int lane = blockIdx.x * LPB + l;
  const bool live = lane < a.B;
  const Solve<T, BND, Mdl> s(a, b, live ? lane : a.B - 1, live, w, l,
                             smem_dyn);
  const bool chain = live && w == 0;
  if (chain) s.initial_rollout();
  __syncthreads();
  // The multiplier update that closes an AL iteration runs in the
  // producers of the next ring, the next AL iteration's first sweep or the
  // diagnostics, at the same rows (al_iters, sqp_iters >= 1).
  for (int ai = 0; ai < a.al_iters; ++ai) {
    for (int si = 0; si < a.sqp_iters; ++si) {
      const bool ladder = LAD < 0 ? a.n_alphas > 0 : LAD == 1;
      s.backward_sweep(!ladder, ai > 0 && si == 0);
      if (ladder) {
        __syncthreads();
        s.ladder(ai * a.sqp_iters + si);
      } else if (chain) {
        // K and d, stored by this thread, are read by its cp.async copies
        __threadfence_block();
        s.full_step();
      }
      __syncthreads();
    }
  }
  s.diagnostics();
}

// The geometry of a launch (fused_gn_geometry fills out[] with it): threads
// a lane given, or the most of 2, 4, 8 (4, 8 for ST) whose blocks are all
// resident at once (occupancy API), else 4; lanes a block; shared bytes a
// lane and a block; blocks resident an SM; registers a thread; of the
// instance with or without the boundary rows (args->boundary) and of the
// ladder (with_ladder), of this source's model.
// The attribute and occupancy calls are made once per device and shared
// memory size, and kept.
template <int T, bool BND, int LAD>
static int occupancy(const FgnArgs* args, int32_t out[6]) {
  static int dev_c = -1, smem_c = -1, nb = 0, regs = 0;
  auto kernel = fused_gn_kernel<T, BND, Model, LAD>;
  const int lane_bytes = lane_floats<Model>(args->H, T) * (int)sizeof(float);
  const int smem = LPB * lane_bytes;
  int dev = 0, err;
  if ((err = cudaGetDevice(&dev))) return err;
  if (dev != dev_c || smem != smem_c) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel,
                                                             LPB * T, smem)))
      return err;
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, kernel))) return err;
    regs = fa.numRegs;
    dev_c = dev;
    smem_c = smem;
  }
  out[0] = T;
  out[1] = LPB;
  out[2] = lane_bytes;
  out[3] = smem;
  out[4] = nb;
  out[5] = regs;
  return 0;
}

template <bool BND, int LAD>
static int occupancy_at(const FgnArgs* args, int T, int32_t out[6]) {
  switch (T) {
#if !defined(FUSED_MODEL_ST)  // the ST instances take 4 and 8 threads a lane
    case 2: return occupancy<2, BND, LAD>(args, out);
#endif
    case 4: return occupancy<4, BND, LAD>(args, out);
    case 8: return occupancy<8, BND, LAD>(args, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f(std::integral_constant<int, LAD>()) for the LAD instance of args
template <class F>
static int with_ladder(const FgnArgs* args, F f) {
#if defined(FUSED_MODEL_ST)
  return f(std::integral_constant<int, -1>());
#else
  return args->n_alphas > 0 ? f(std::integral_constant<int, 1>())
                            : f(std::integral_constant<int, 0>());
#endif
}

static int occupancy_at(const FgnArgs* args, int T, int32_t out[6]) {
  return with_ladder(args, [&](auto lad) {
    constexpr int LAD = decltype(lad)::value;
    return args->boundary ? occupancy_at<true, LAD>(args, T, out)
                          : occupancy_at<false, LAD>(args, T, out);
  });
}

static int geometry(const FgnArgs* args, int32_t out[6]) {
  if (args->threads_per_lane > 0)
    return occupancy_at(args, args->threads_per_lane, out);
  static int dev_c = -1, sms = 0;
  int dev = 0, err;
  if ((err = cudaGetDevice(&dev))) return err;
  if (dev != dev_c) {
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)))
      return err;
    dev_c = dev;
  }
  const int blocks = (args->B + LPB - 1) / LPB;
  // The fewest threads a lane this library has (the ST one builds 4 and 8):
  // when no instance holds every block at once, it runs in waves.
  constexpr int T_MIN = Model::ST ? 4 : 2;
  for (int T = 8; T >= T_MIN; T /= 2) {
    if ((err = occupancy_at(args, T, out))) return err;
    if ((long)out[4] * sms >= blocks || T == T_MIN) return 0;
  }
  return 0;
}

// Floats of one lane's shared memory at horizon H and T threads a lane, for
// this source's model (the Python side's eligibility mirrors it).
extern "C" int fused_gn_lane_floats(int H, int T) {
  return lane_floats<Model>(H, T);
}

extern "C" int fused_gn_geometry(const FgnArgs* args, int32_t* out) {
  return geometry(args, out);
}

template <int T>
static int launch(const FgnArgs* args, const Bufs& b, size_t smem,
                  void* stream) {
  const int blocks = (args->B + LPB - 1) / LPB;
  const int threads = LPB * T;
  return with_ladder(args, [&](auto lad) {
    constexpr int LAD = decltype(lad)::value;
    auto kernel = args->boundary ? fused_gn_kernel<T, true, Model, LAD>
                                 : fused_gn_kernel<T, false, Model, LAD>;
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(*args, b);
    return (int)cudaGetLastError();
  });
}

extern "C" int fused_gn_solve(const FgnArgs* args, const float* x0,
                              const float* xref, const float* obs,
                              const float* mind, const float* w, float* U,
                              float* lam_lo, float* lam_hi, float* mu,
                              float* pviol, float* X, float* diag,
                              int32_t* status, float* K, float* d, float* Xc,
                              float* Uc, int32_t* rung, const float* bnd,
                              void* stream) {
  if (args->boundary && !bnd) return (int)cudaErrorInvalidValue;
  Bufs b{x0, xref, obs, mind, w, U,  lam_lo, lam_hi, mu,
         pviol, X, diag, status, K, d, Xc, Uc, rung, bnd};
  int32_t g[6];
  int err = geometry(args, g);
  if (err) return err;
  if (g[4] < 1) return (int)cudaErrorInvalidValue;
  switch (g[0]) {
#if !defined(FUSED_MODEL_ST)
    case 2: return launch<2>(args, b, (size_t)g[3], stream);
#endif
    case 4: return launch<4>(args, b, (size_t)g[3], stream);
    case 8: return launch<8>(args, b, (size_t)g[3], stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
