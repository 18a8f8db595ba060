// fused_ip_ring.cu — the whole batched hard-constrained RTI-SQP solve in
// one launch, for Hopper, on the ring of fused_gn.cu: the design of the ST
// model's instances (fused_ip_st.cu) and of the KS model's instance with
// the road-boundary rows (fused_ip_ks_ring.cu).
//
// Replaces mpc_tpu/ops/fused_ip.py::_make_ip_kernel (the Pallas TPU kernel,
// launched by _solve_ip_packed), model='st' (fused_ip.py:100-108) and its
// boundary rows (fused_ip.py:765, :783).  The function is fused_ip.cu's,
// whose notes say what it computes: per lane an
// initial rollout; ip_sqp_iters RTI iterations, each of which starts slacks
// and duals from the row margins (or from the warm duals), runs ip_iters
// primal-dual Newton steps (sigma = z / s weighted stage quadratics, a
// Riccati sweep with a closed-form 2x2 Quu inverse, a linear forward pass,
// the slack and dual steps, the fraction-to-boundary step, the barrier
// from the complementarity gap), scrubs the input step of NaN/inf and
// applies it unguarded or through the exact-penalty ladder; then the
// diagnostics.  The plain PyTorch version of the same function is
// fused_ip.py::solve_batch_fused_ip_plain.
//
// What bounds it on an H100.  The ST step couples every state it moves,
// so a rollout is a chain of RK4 steps of the tire model, stage after
// stage; the Riccati sweep with its 7x7 products, the forward pass and the
// adjoint are chains too.  fused_ip.cu runs a warp a lane with its Newton
// state in registers and shared memory, which holds 8 ST lanes an SM (26
// KB of shared memory a lane), and runs those chains on one thread a
// lane: 8 threads of an SM carried the rollouts and the sweep, and the
// kernel was bound by their latency.  With the boundary rows the KS lane
// takes 10,748 B at H=14 there, so 12 lanes an SM, and 17 of a warp's 32
// threads idle in every separable phase at that horizon.
//
// What the design does about it.
// - A block holds 32 lanes and T warps (T threads a lane, a template
//   parameter; the library builds T = 4).  Thread (w, l) serves lane
//   blockIdx.x * 32 + l, and every per-stage buffer is (stage, field, lane)
//   with the lane fastest, so a warp's accesses coalesce.
// - The chains run for lane l on thread l of warp 0, 32 lanes at once: the
//   initial and the unguarded rollout, the sweep (P and p in shared memory
//   at an odd stride), the forward pass and the adjoint.
// - The ring of ring.cuh feeds them: in each Newton step warps 1..T-1
//   produce stages H..0 (the row weights, the stage quadratic and (A, B))
//   for the sweep, then stages 0..H-1 ((A, B), K and d) for the forward
//   pass; the diagnostics' ring carries qx, qu and (A, B) to the adjoint.
//   The ring's operand is fused_gn.cu's, the structural zeros of Q, R, M
//   and the identity rows of A and B left out.
// - The Newton state leaves shared memory: slacks and duals (the duals in
//   the caller's z buffers, in place), the primal step (dX, dU), the Newton
//   direction (ddX, ddU), K, d and the (A, B) of the RTI iteration, filled
//   once per iteration by the model's linearization (StModel::lin's dual
//   numbers, KS lin_step's chain rule), live in device memory that the
//   wrapper allocates, lanes fastest; a stage's producer reads and writes
//   them coalesced.  The rows are recomputed where they are needed: a pure
//   function of (X_k, U_k), the obstacles and the boundary models, the same
//   bits as a cache of them.
// - The separable phases run on all T warps, stage by stage: the slacks
//   and duals at the start of a QP with the iterate's (A, B) (once an RTI
//   iteration, into the device cache that the Newton steps' producers copy
//   from), the fraction-to-boundary
//   minimum and the slack and dual steps of each Newton step.  The minimum is a
//   NaN-propagating nmin over per-thread partials (exact in any order);
//   the complementarity gap is summed in stage order from each stage's
//   sum, by every thread of the lane alike.
// - The ladder's rungs run across the warps, as in fused_gn.cu: thread
//   (w, l) rolls out rung w, w + T, ... for lane l, adds up the merit
//   (cost + rho * violation, the plain version's order) as it goes and
//   writes its trial to a slot of its own; thread l of warp 0 picks the
//   rung by the sequential rule and the owners commit it.
// - A thread past the last lane (the ragged last block) does no work and
//   stores nothing but meets every barrier, named ones included.
// - Lanes a block: 32.  __launch_bounds__ asks for the model's
//   IpMinBlocks blocks an SM; fused_ip_geometry reports the blocks the
//   occupancy API finds.  A KS lane with the boundary rows takes 1,484 B
//   of shared memory at H=14 (371 floats), a block ~47 KB: registers, not
//   shared memory, decide the blocks an SM.
// - Memory-level parallelism: the loads that a stage's work waits for go
//   out together.  Slacks and duals of a separable phase's stage are
//   fetched by cp.async into the thread's part of the ring's shared memory
//   (free between rings) before the stage's rows are built, and the
//   producers' copies of (A, B), K and d into a slot are cp.async too: as
//   plain loads interleaved with stores through generic pointers, which
//   the compiler may not reorder, each waited for the latency of the one
//   before.
//
// Semantics kept from the TPU kernel on purpose: maxima, minima and clips
// propagate NaN; the unguarded step commits a non-finite rollout; a
// non-finite merit counts as 1e30 and a rung is taken on a strict "<".
// Build without --use_fast_math.

#include <type_traits>

#include "ring.cuh"

#if defined(FUSED_MODEL_ST)
using Model = StModel;
#else
using Model = KsModel;
#endif

#define T_IP 4            // threads a lane of the library's instances

// Blocks an SM that __launch_bounds__ asks for, by model, as measured
// (PERF.md).  ST: 2, 255 registers a thread and no spill; at 3 (168
// registers) the kernel spilled ~350 B a thread into local memory, whose
// traffic the L1 left beside three blocks' shared memory could not hold,
// and a warm 1x4 solve took 1.5x as long.  KS (the boundary rows'
// instance): 4, 128 registers and ~100 B of spills, the most that its
// shared memory lets an SM hold (47,488 B a block at H=14), so that the
// 512 blocks of B=16384 are all resident at once: at 3 (168 registers, no
// spill) they ran in 1.3 waves and took 1.4x as long.
template <class Mdl>
struct IpMinBlocks {
  static constexpr int value = Mdl::ST ? 2 : 4;
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

// fused_ip.cu's argument block, field for field (fused_ip.py::IpArgs)
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

// Every buffer lanes fastest: (..., field, B).
struct IpRBufs {
  const float *x0, *xref, *obs, *mind, *w;
  float *U, *z_lo, *z_hi;   // warm state, updated in place
  float *X, *pviol, *diag;  // outputs
  int32_t* rung;            // (ip_sqp_iters, B) or null
  const float* bnd;         // (H + 1, NBND, B) boundary models or null
  // the Newton state: slacks (H + 1, NRB, B), the primal step dX (H + 1,
  // N, B) and dU (H, NU, B), the Newton direction ddX, ddU (the same),
  // the gains K (H, NU * N, B), d (H, NU, B), (A, B) (H, NAB, B), and the
  // ladder's trial chains Xc (rungs, H + 1, N, B), Uc (rungs, H, NU, B)
  float *s_lo, *s_hi, *dX, *dU, *ddX, *ddU, *K, *d, *AB, *Xc, *Uc;
};

// Floats a lane of the ring's part of shared memory: the ring of stage
// operands, which also holds the ladder's merits between rings and, in the
// separable phases, each thread's slacks and duals of a stage (4 a row);
// for KS with the boundary rows the latter are the larger (4 x 4 x 20 =
// 320 against 6 x 43).
template <class Mdl, bool BND>
__host__ __device__ constexpr int ring_part_floats(int T) {
  return ring_slots(T) * Ring<Mdl>::NOP > T * 4 * nrows<BND>()
             ? ring_slots(T) * Ring<Mdl>::NOP
             : T * 4 * nrows<BND>();
}

// Floats of one lane's shared memory: the threads' partials (T), the
// ladder's slot, a value a stage (the gap, the cost), the ring's part and
// the sweep's P and p.
template <class Mdl, bool BND>
__host__ __device__ __forceinline__ int ring_lane_floats(int H, int T) {
  return T + 1 + (H + 1) + ring_part_floats<Mdl, BND>(T) + Ring<Mdl>::PSTR;
}

// Linearized value c_i = h_i + J_i . (dX, dU) of row i (sparse gradient;
// the rows read the first five states).
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
// the same with the boundary rows, whose gradient is a circle row's
__device__ __forceinline__ float row_lin(const BndRows& r, int i,
                                         const float* dX,
                                         const float dU[NU]) {
  if (i < NR) return row_lin(static_cast<const Rows&>(r), i, dX, dU);
  const float* c = r.bnd[i - NR];
  return c[0] + c[1] * dX[0] + c[2] * dX[1] + c[3] * dX[4];
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

// One thread's share of a lane's solve.  BND: with the 6 road-boundary
// rows a stage; Mdl: the model.
template <int T, bool BND, class Mdl>
struct IpRing {
  static constexpr int N = Mdl::N;  // states
  using RG = Ring<Mdl>;
  static constexpr int R = ring_slots(T);
  static constexpr int RP = ring_part_floats<Mdl, BND>(T);
  static constexpr int NRB = nrows<BND>();  // rows a stage
  using RowsT = RowsOf<BND>;
  const IpArgs& a;
  const IpRBufs& b;
  Lane L;
  const int w, l;
  const bool live;  // false: past the last lane; meets the barriers only
  float* const part;  // (T, LPB) the threads' partials
  int* const slot;    // (LPB) the ladder's best rung
  float* const sv;    // (H + 1, LPB) a value a stage
  float* const ring;  // (RP, LPB) the ring (R, NOP, LPB); the ladder's
                      // merits; the separable phases' slacks and duals
  float* const pm;    // (LPB, PSTR) the sweep's P and p, lane by lane
  float mind;

  __device__ IpRing(const IpArgs& a_, const IpRBufs& b_, int lane,
                    bool live_, int w_, int l_, float* smem)
      : a(a_), b(b_), w(w_), l(l_), live(live_), part(smem),
        slot(reinterpret_cast<int*>(smem + T * LPB)),
        sv(smem + (T + 1) * LPB),
        ring(smem + (T + 1 + a_.H + 1) * LPB),
        pm(smem + (T + 1 + a_.H + 1 + RP) * LPB + l_ * RG::PSTR) {
    L.B = a.B;
    L.lane = lane;
    mind = b.mind[L.lane];
  }

  // ---- per-lane data, (stage, field, lane)
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
  // the lane's weights (wqN at the terminal stage)
  __device__ __forceinline__ void weights(bool is_term, float wx[N],
                                          float wr[NU]) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      wx[i] = b.w[L.at(0, (is_term ? N + NU : 0) + i, 1)];
#pragma unroll
    for (int i = 0; i < NU; ++i) wr[i] = b.w[L.at(0, N + i, 1)];
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
  // the step dU of stage k (0 at the terminal stage)
  __device__ __forceinline__ void du_at(const float* p, int k,
                                        float du[NU]) const {
    if (k < a.H) {
      load(p, k, NU, du);
    } else {
      du[0] = du[1] = 0.f;
    }
  }
  __device__ void fresh_rows(int k, const float x[N], const float u[NU],
                             RowsT& r) const {
    float o[6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      o[i] = a.moving ? b.obs[L.at(k, i, 6)] : b.obs[L.at(0, i, 6)];
    compute_rows(a, x, u, o, k == a.H, k == 0, r);
    if constexpr (BND) {
      float m[NBND];
      load(b.bnd, k, NBND, m);
      boundary_rows(a, x, m, r);
    }
  }
  __device__ __forceinline__ float& rg(int s, int f) const {
    return ring[(s * RG::NOP + f) * LPB + l];
  }

  // max(lo - h, h - hi, 0) of row i (raw)
  __device__ float row_viol(const RowsT& r, int i, bool is_term) const {
    bool has_lo, has_hi;
    float lo, hi;
    row_bounds_of<BND>(a, i, is_term, mind, has_lo, lo, has_hi, hi);
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
  __device__ float penalty_viol(const RowsT& r, bool is_term) const {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < NRB; ++i) v = v + scaled(i, row_viol(r, i, is_term));
    return v;
  }

  // ---- chains: thread l of warp 0 for lane l

  // States from x0 under the inputs U into X.
  __device__ void initial_rollout() const {
    float x[N], xn[N], u[NU], un[NU];
    load(b.x0, 0, N, x);
    if (a.H > 0) load(b.U, 0, NU, u);
    for (int k = 0; k < a.H; ++k) {
      if (k + 1 < a.H) load(b.U, k + 1, NU, un);   // in flight meanwhile
      store(b.X, k, N, x);
      Mdl::step(a, x, u, xn);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = xn[i];
#pragma unroll
      for (int i = 0; i < NU; ++i) u[i] = un[i];
    }
    store(b.X, a.H, N, x);
  }

  // The input of the RTI step at a stage of inputs uk and step du:
  // clip(uk + alpha du), du scrubbed of NaN/inf.
  __device__ __forceinline__ void rti_input(const float uk[NU],
                                            const float du[NU], float alpha,
                                            float u[NU]) const {
    float d[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) d[i] = finite_f32(du[i]) ? du[i] : 0.f;
    u[0] = clipf(uk[0] + alpha * d[0], a.u_lo0, a.u_hi0);
    u[1] = clipf(uk[1] + alpha * d[1], a.u_lo1, a.u_hi1);
  }
  __device__ __forceinline__ void rti_input(int k, float alpha,
                                            float u[NU]) const {
    float uk[NU], du[NU];
    load(b.U, k, NU, uk);
    load(b.dU, k, NU, du);
    rti_input(uk, du, alpha, u);
  }

  // The unguarded RTI step: U <- clip(U + dU) and its rollout into X (the
  // next stage's U and dU loaded ahead of this one's stores).
  __device__ void full_step() const {
    float x[N], xn[N], u[NU], uk[NU], du[NU], un[NU], dun[NU];
    load(b.x0, 0, N, x);
    if (a.H > 0) {
      load(b.U, 0, NU, uk);
      load(b.dU, 0, NU, du);
    }
    for (int k = 0; k < a.H; ++k) {
      if (k + 1 < a.H) {
        load(b.U, k + 1, NU, un);
        load(b.dU, k + 1, NU, dun);
      }
      rti_input(uk, du, 1.f, u);
      store(b.U, k, NU, u);
      store(b.X, k, N, x);
      Mdl::step(a, x, u, xn);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = xn[i];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        uk[i] = un[i];
        du[i] = dun[i];
      }
    }
    store(b.X, a.H, N, x);
  }

  // ---- separable phases, stage by stage

  // This thread's part of the ring's shared memory, which no ring uses
  // during the separable phases: the slacks and duals of one stage (s_lo,
  // s_hi, z_lo, z_hi, row by row; field f at sz[f * LPB]).
  __device__ __forceinline__ float* sz_part() const {
    static_assert(T * 4 * NRB <= RP,
                  "a stage's slacks and duals a thread exceed the ring's part");
    return ring + (size_t)w * 4 * NRB * LPB + l;
  }
  // the slacks and duals of stage k into sz_part() by cp.async, issued
  // before the stage's other loads and its rows (the caller waits), so
  // that their latency is paid once a stage and not once a row
  __device__ void fetch_sz(int k) const {
    float* const o = sz_part();
#pragma unroll
    for (int i = 0; i < NRB; ++i) {
      const size_t at = L.at(k, i, NRB);
      copy_async(o + i * LPB, b.s_lo + at);
      copy_async(o + (NRB + i) * LPB, b.s_hi + at);
      copy_async(o + (2 * NRB + i) * LPB, b.z_lo + at);
      copy_async(o + (3 * NRB + i) * LPB, b.z_hi + at);
    }
    copy_commit();
  }

  // Slacks and duals from the margins of the iterate's rows (or the warm
  // duals), on every warp; dX = dU = 0; and, for the Newton steps, the
  // (A, B) of the iterate into the device cache by the model's
  // linearization.
  __device__ void init_ip() const {
    if (!live) return;
    const float* const sz = sz_part();
    for (int k = w; k <= a.H; k += T) {
      const bool is_term = k == a.H;
      fetch_sz(k);
      float x[N], u[NU];
      xu(b.X, b.U, k, x, u);
      RowsT r;
      fresh_rows(k, x, u, r);
      copy_wait<0>();
#pragma unroll
      for (int i = 0; i < NRB; ++i) {
        bool has_lo, has_hi;
        float lo, hi;
        row_bounds_of<BND>(a, i, is_term, mind, has_lo, lo, has_hi, hi);
        const float h = row_value(r, i);
        const size_t at = L.at(k, i, NRB);
        float sl = 1.f, zl = 0.f, sh = 1.f, zh = 0.f;
        if (has_lo)
          side_init(h - lo, sz[(2 * NRB + i) * LPB], a.warm != 0, sl, zl);
        if (has_hi)
          side_init(hi - h, sz[(3 * NRB + i) * LPB], a.warm != 0, sh, zh);
        b.s_lo[at] = sl;
        b.s_hi[at] = sh;
        b.z_lo[at] = zl;
        b.z_hi[at] = zh;
      }
      const float zero[N] = {};
      store(b.dX, k, N, zero);
      if (is_term) continue;
      store(b.dU, k, NU, zero);
      if (a.ip_iters > 0)
        lin_into(
            [&](int f) -> float& { return b.AB[L.at(k, f - RG::OP_A, RG::NAB)]; },
            x, u);
    }
  }

  // The stage quadratic of stage k at the shifted point (X + dX, U + dU)
  // into ring slot s: the IP row weights w (gh) and sigma = z / s (gn);
  // and (A, B) at the iterate from the device cache, in flight while the
  // quadratic is built.
  __device__ void stage_ops(int k, int s, float mu_b) const {
    const bool is_term = k == a.H;
    if (!is_term) {
      fetch_ab(k, s);
      copy_commit();
    }
    float x[N], u[NU], dx[N], du[NU];
    xu(b.X, b.U, k, x, u);
    load(b.dX, k, N, dx);
    du_at(b.dU, k, du);
    RowsT r;
    fresh_rows(k, x, u, r);
    float gh[NRB], gn[NRB];
#pragma unroll
    for (int i = 0; i < NRB; ++i) {
      bool has_lo, has_hi;
      float lo, hi;
      row_bounds_of<BND>(a, i, is_term, mind, has_lo, lo, has_hi, hi);
      const float c = row_lin(r, i, dx, du);
      const size_t at = L.at(k, i, NRB);
      float wt = 0.f, sig = 0.f;
      if (has_hi) {
        const float sh = b.s_hi[at];
        const float rs = sh - (hi - c);
        const float sg = b.z_hi[at] / sh;
        wt = wt + mu_b / sh + sg * rs;
        sig = sig + sg;
      }
      if (has_lo) {
        const float sl = b.s_lo[at];
        const float rs = sl - (c - lo);
        const float sg = b.z_lo[at] / sl;
        wt = wt - mu_b / sl - sg * rs;
        sig = sig + sg;
      }
      gh[i] = wt;
      gn[i] = sig;
    }
    float xc[N], uc[NU], xref[N], wx[N], wr[NU];
#pragma unroll
    for (int i = 0; i < N; ++i) xc[i] = x[i] + dx[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) uc[i] = is_term ? 0.f : u[i] + du[i];
    load(b.xref, k, N, xref);
    weights(is_term, wx, wr);
    float Q[N][N], Rm[NU][NU], M[N][NU], qx[N], qu[NU];
    assemble_quad(r, gh, gn, xc, uc, xref, wx, wr, is_term,
                  is_term ? a.use_term != 0 : true, Q, Rm, M, qx, qu);
    ring_put_quad<Mdl>([&](int f) -> float& { return rg(s, f); }, Q, Rm, M,
                       qx, qu);
    if (!is_term) copy_wait<0>();
  }

  // (A, B) of stage k from the device cache into ring slot s, by cp.async
  // (the caller commits and waits)
  __device__ __forceinline__ void fetch_ab(int k, int s) const {
#pragma unroll
    for (int f = 0; f < RG::NAB; ++f)
      copy_async(&rg(s, RG::OP_A + f), b.AB + L.at(k, f, RG::NAB));
  }

  // (A, B) of the step at (x, u) into a ring slot's fields (put(f))
  template <class Put>
  __device__ __forceinline__ void lin_into(Put put, const float x[N],
                                           const float u[NU]) const {
    if constexpr (Mdl::ST) {
      Mdl::lin(a, x, u, [&](int i, int j, float v) {
        ring_put_ab_entry<Mdl>(put, i, j, v);
      });
    } else {
      float A[N][N], Bm[N][NU];
      lin_step(a, x, u, A, Bm);
      ring_put_ab<Mdl>(put, A, Bm);
    }
  }

  // The slack and dual steps of every stage, on every warp: the least
  // fraction-to-boundary ratio of this thread's stages (``apply`` false),
  // or the step of length alpha on (dX, dU, s, z), slacks floored at
  // S_FLOOR and duals capped at Z_MAX, each stage's complementarity gap
  // into sv.
  template <bool apply>
  __device__ float dual_pass(float mu_b, float alpha) const {
    float acc = BIG;
    if (!live) return acc;
    const float* const sz = sz_part();
    for (int k = w; k <= a.H; k += T) {
      const bool is_term = k == a.H;
      fetch_sz(k);
      float x[N], u[NU], dx[N], du[NU], ddx[N], ddu[NU];
      xu(b.X, b.U, k, x, u);
      load(b.dX, k, N, dx);
      du_at(b.dU, k, du);
      load(b.ddX, k, N, ddx);
      du_at(b.ddU, k, ddu);
      RowsT r;
      fresh_rows(k, x, u, r);
      copy_wait<0>();
      float gap = 0.f;
#pragma unroll
      for (int i = 0; i < NRB; ++i) {
        bool has_lo, has_hi;
        float lo, hi;
        row_bounds_of<BND>(a, i, is_term, mind, has_lo, lo, has_hi, hi);
        const float c = row_lin(r, i, dx, du);
        const float jd = row_lin(r, i, ddx, ddu) - row_value(r, i);
        const size_t at = L.at(k, i, NRB);
        const float sl = sz[i * LPB], sh = sz[(NRB + i) * LPB],
                    zl = sz[(2 * NRB + i) * LPB], zh = sz[(3 * NRB + i) * LPB];
        float dsl = 0.f, dzl = 0.f, dsh = 0.f, dzh = 0.f;
        if (has_lo) {
          const float rs = sl - (c - lo);
          const float sg = zl / sl;
          dsl = jd - rs;
          dzl = mu_b / sl - zl - sg * dsl;
        }
        if (has_hi) {
          const float rs = sh - (hi - c);
          const float sg = zh / sh;
          dsh = -jd - rs;
          dzh = mu_b / sh - zh - sg * dsh;
        }
        if (!apply) {
          if (has_lo) {
            acc = ftb(sl, dsl, acc);
            acc = ftb(zl, dzl, acc);
          }
          if (has_hi) {
            acc = ftb(sh, dsh, acc);
            acc = ftb(zh, dzh, acc);
          }
          continue;
        }
        float nsl = 1.f, nzl = 0.f, nsh = 1.f, nzh = 0.f;
        if (has_lo) {
          nsl = nmax(sl + alpha * dsl, S_FLOOR);
          nzl = nmin(zl + alpha * dzl, Z_MAX);
          gap = gap + nsl * nzl;
        }
        if (has_hi) {
          nsh = nmax(sh + alpha * dsh, S_FLOOR);
          nzh = nmin(zh + alpha * dzh, Z_MAX);
          gap = gap + nsh * nzh;
        }
        b.s_lo[at] = nsl;
        b.z_lo[at] = nzl;
        b.s_hi[at] = nsh;
        b.z_hi[at] = nzh;
      }
      if (!apply) continue;
#pragma unroll
      for (int i = 0; i < N; ++i) dx[i] = dx[i] + alpha * ddx[i];
      store(b.dX, k, N, dx);
      if (!is_term) {
#pragma unroll
        for (int i = 0; i < NU; ++i) du[i] = du[i] + alpha * ddu[i];
        store(b.dU, k, NU, du);
      }
      sv[k * LPB + l] = gap;
    }
    return acc;
  }

  // ---- a Newton step: the two rings, then the separable steps

  // The Riccati sweep over the ring of stages H..0 -> K, d (the raw gains).
  __device__ void backward_sweep(float mu_b) const {
    // P and p in shared memory: in registers they spilled and were no
    // faster (PERF.md)
    float(*P)[N] = reinterpret_cast<float(*)[N]>(pm);
    float* p = pm + N * N;
    ring_pipeline<T>(
        w, live, a.H + 1,
        [&](int j, int s) { stage_ops(a.H - j, s, mu_b); },
        [&](int j, int s) {
          const int k = a.H - j;
          const auto g = [&](int f) { return rg(s, f); };
          if (k == a.H) {
            ring_get_qx<Mdl>(g, P, p);
            return;
          }
          float Q[N][N], Rm[NU][NU], M[N][NU], qx[N], qu[NU], A[N][N],
              Bm[N][NU];
          ring_get_qx<Mdl>(g, Q, qx);
#pragma unroll
          for (int i = 0; i < NU; ++i) qu[i] = g(RG::OP_QU + i);
          ring_get_ab<Mdl>(g, A, Bm);
          ring_get_rm<Mdl>(g, Rm, M);
          float Kk[NU][N], dk[NU];
          riccati_step(a.reg, P, p, Q, Rm, M, qx, qu, A, Bm, Kk, dk);
          store(b.K, k, NU * N, &Kk[0][0]);
          store(b.d, k, NU, dk);
        });
  }

  // The linear forward pass over the ring of stages 0..H-1 (their (A, B),
  // K and d): ddx_0 = 0 (x0 pinned), ddu_k = d_k + K_k ddx_k, ddx_{k+1} =
  // A ddx + B ddu, into ddX and ddU.
  __device__ void forward_pass() const {
    constexpr int OK = 0, OD = NU * N;  // K and d ahead of (A, B)
    static_assert(OD + NU <= RG::OP_A, "K and d overlap (A, B) in a slot");
    float ddx[N];
#pragma unroll
    for (int i = 0; i < N; ++i) ddx[i] = 0.f;
    ring_pipeline<T>(
        w, live, a.H,
        [&](int k, int s) {
          fetch_ab(k, s);
#pragma unroll
          for (int f = 0; f < NU * N; ++f)
            copy_async(&rg(s, OK + f), b.K + L.at(k, f, NU * N));
#pragma unroll
          for (int f = 0; f < NU; ++f)
            copy_async(&rg(s, OD + f), b.d + L.at(k, f, NU));
          copy_commit();
          copy_wait<0>();
        },
        [&](int k, int s) {
          const auto g = [&](int f) { return rg(s, f); };
          float ddu[NU];
#pragma unroll
          for (int i = 0; i < NU; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int c = 0; c < N; ++c) acc += g(OK + i * N + c) * ddx[c];
            ddu[i] = g(OD + i) + acc;
          }
          store(b.ddU, k, NU, ddu);
          store(b.ddX, k, N, ddx);
          float A[N][N], Bm[N][NU], nxt[N];
          ring_get_ab<Mdl>(g, A, Bm);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            float sa = 0.f, sb = 0.f;
#pragma unroll
            for (int c = 0; c < N; ++c) sa += A[i][c] * ddx[c];
#pragma unroll
            for (int c = 0; c < NU; ++c) sb += Bm[i][c] * ddu[c];
            nxt[i] = sa + sb;
          }
#pragma unroll
          for (int i = 0; i < N; ++i) ddx[i] = nxt[i];
        });
    if (live && w == 0) store(b.ddX, a.H, N, ddx);
  }

  // One primal-dual Newton step; returns the next barrier.
  __device__ float newton(float mu_b) const {
    backward_sweep(mu_b);
    __syncthreads();
    forward_pass();
    __syncthreads();
    part[w * LPB + l] = dual_pass<false>(mu_b, 0.f);
    __syncthreads();
    float amin = part[l];
    for (int t = 1; t < T; ++t) amin = nmin(amin, part[t * LPB + l]);
    const float alpha = nmin(1.f, TAU * amin);
    dual_pass<true>(mu_b, alpha);
    __syncthreads();
    float gap = 0.f;
    for (int k = 0; k <= a.H; ++k) gap = gap + sv[k * LPB + l];
    return nmax(SIGMA_B * gap / a.n_act, MU_MIN);
  }

  // ---- the RTI step

  // Rung q of the ladder (q = 0: alpha = 0; q = r + 1: alphas[r]) for lane
  // l: its trial into slot q of (Xc, Uc) and its merit, objective + rho *
  // viol added up stage by stage (1e30 when not finite), into the ring's
  // shared memory (q, l).
  __device__ void rung_rollout(int q) const {
    if (!live || q > a.n_alphas) return;
    const float alpha = q > 0 ? a.alphas[q - 1] : 0.f;
    float* const Xo = b.Xc + (size_t)q * (a.H + 1) * N * a.B;
    float* const Uo = b.Uc + (size_t)q * a.H * NU * a.B;
    float x[N], xn[N], u[NU], xref[N], wx[N], wr[NU], acc = 0.f;
    load(b.x0, 0, N, x);
    weights(false, wx, wr);
    for (int k = 0; k < a.H; ++k) {
      rti_input(k, alpha, u);
      store(Uo, k, NU, u);
      store(Xo, k, N, x);
      RowsT r;
      fresh_rows(k, x, u, r);
      load(b.xref, k, N, xref);
      acc = acc + stage_cost<N>(x, u, xref, wx, wr);
      acc = acc + a.rho * penalty_viol(r, false);
      Mdl::step(a, x, u, xn);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = xn[i];
    }
    store(Xo, a.H, N, x);
    u[0] = u[1] = 0.f;
    RowsT r;
    fresh_rows(a.H, x, u, r);
    if (a.use_term) {
      load(b.xref, a.H, N, xref);
      weights(true, wx, wr);
      acc = acc + term_cost<N>(x, xref, wx);
    }
    acc = acc + a.rho * penalty_viol(r, true);
    ring[q * LPB + l] = finite_f32(acc) ? acc : BIG;
  }

  // The RTI step of SQP iteration ``si``: the unguarded full step on warp
  // 0, or the ladder: its rungs across the warps (rung_rollout), the
  // choice by the sequential rule on thread l of warp 0, the best trial
  // committed by the owners.
  __device__ void rti_step(int si) const {
    if (a.n_alphas == 0) {
      if (live && w == 0) full_step();
      __syncthreads();
      return;
    }
    for (int q0 = 0; q0 <= a.n_alphas; q0 += T) rung_rollout(q0 + w);
    __syncthreads();
    if (live && w == 0) {
      int best = 0;
      float best_m = ring[l];
      for (int q = 1; q <= a.n_alphas; ++q) {
        const float m = ring[q * LPB + l];
        if (m < best_m) {
          best_m = m;
          best = q;
        }
      }
      if (b.rung) b.rung[(size_t)si * a.B + L.lane] = best;
      slot[l] = best;
    }
    __syncthreads();
    if (live) {
      const int q = slot[l];
      const float* Xs = b.Xc + (size_t)q * (a.H + 1) * N * a.B;
      const float* Us = b.Uc + (size_t)q * a.H * NU * a.B;
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
    __syncthreads();
  }

  // stat (adjoint Lagrangian stationarity with lam = z_hi - z_lo), viol,
  // cost at the final iterate: the producers build each stage's qx, qu and
  // (A, B) into the ring, its row violations into pviol and its cost into
  // sv; warp 0 runs the adjoint from stage H down and sums the cost in that
  // order; the violation from the producers' partials.
  __device__ void diagnostics() const {
    float lam[N], cost = 0.f, stat = 0.f, viol = 0.f;
    ring_pipeline<T>(
        w, live, a.H + 1,
        [&](int j, int s) {
          const int k = a.H - j;
          const bool is_term = k == a.H;
          float x[N], u[NU], lr[NRB], xref[N], wx[N], wr[NU];
          const float zero[NRB] = {};
          xu(b.X, b.U, k, x, u);
          RowsT r;
          fresh_rows(k, x, u, r);
#pragma unroll
          for (int i = 0; i < NRB; ++i) {
            const size_t at = L.at(k, i, NRB);
            lr[i] = b.z_hi[at] - b.z_lo[at];
          }
          load(b.xref, k, N, xref);
          weights(is_term, wx, wr);
          float Q[N][N], Rm[NU][NU], M[N][NU], qx[N], qu[NU];
          assemble_quad(r, lr, zero, x, u, xref, wx, wr, is_term,
                        is_term ? a.use_term != 0 : true, Q, Rm, M, qx, qu);
#pragma unroll
          for (int i = 0; i < N; ++i) rg(s, RG::OP_QX + i) = qx[i];
#pragma unroll
          for (int i = 0; i < NU; ++i) rg(s, RG::OP_QU + i) = qu[i];
          if (!is_term)
            lin_into([&](int f) -> float& { return rg(s, f); }, x, u);
#pragma unroll
          for (int i = 0; i < NRB; ++i) {
            const float vi = row_viol(r, i, is_term);
            b.pviol[L.at(k, i, NRB)] = vi;
            viol = nmax(viol, scaled(i, vi));
          }
          float c;
          if (is_term)
            c = a.use_term ? term_cost<N>(x, xref, wx) : 0.f;
          else
            c = stage_cost<N>(x, u, xref, wx, wr);
          sv[k * LPB + l] = c;
        },
        [&](int j, int s) {
          const int k = a.H - j;
          const auto g = [&](int f) { return rg(s, f); };
          const float c = sv[k * LPB + l];
          if (k == a.H) {
#pragma unroll
            for (int i = 0; i < N; ++i) lam[i] = g(RG::OP_QX + i);
            cost = c;
            return;
          }
          float A[N][N], Bm[N][NU], g_u[NU], lam_new[N];
          ring_get_ab<Mdl>(g, A, Bm);
#pragma unroll
          for (int i = 0; i < NU; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int t = 0; t < N; ++t) acc += Bm[t][i] * lam[t];
            g_u[i] = g(RG::OP_QU + i) + acc;
          }
#pragma unroll
          for (int i = 0; i < N; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int t = 0; t < N; ++t) acc += A[t][i] * lam[t];
            lam_new[i] = g(RG::OP_QX + i) + acc;
          }
#pragma unroll
          for (int i = 0; i < N; ++i) lam[i] = lam_new[i];
          stat = nmax(stat, nmax(fabsf(g_u[0]), fabsf(g_u[1])));
          cost = cost + c;
        });
    if (w > 0) part[w * LPB + l] = viol;
    __syncthreads();
    if (!live || w != 0) return;
    for (int t = 1; t < T; ++t) viol = nmax(viol, part[t * LPB + l]);
    b.diag[L.at(0, 0, 4)] = stat;
    b.diag[L.at(0, 1, 4)] = viol;
    b.diag[L.at(0, 2, 4)] = cost;
    b.diag[L.at(0, 3, 4)] = cost;
  }
};

// 32 lanes and T warps a block.  __grid_constant__: the IpRing object
// keeps references to the parameters, which then stay in the constant bank
// instead of a local copy.
template <int T, bool BND, class Mdl>
__global__ void __launch_bounds__(LPB * T, IpMinBlocks<Mdl>::value)
fused_ip_ring_kernel(const __grid_constant__ IpArgs a,
                     const __grid_constant__ IpRBufs b) {
  extern __shared__ float smem_dyn[];
  const int w = threadIdx.x / LPB, l = threadIdx.x % LPB;
  const int lane = blockIdx.x * LPB + l;
  const bool live = lane < a.B;
  const IpRing<T, BND, Mdl> s(a, b, live ? lane : a.B - 1, live, w, l,
                              smem_dyn);
  if (live && w == 0) s.initial_rollout();
  __syncthreads();
  for (int si = 0; si < a.ip_sqp_iters; ++si) {
    // warm duals chain across SQP iterations and MPC steps: z holds the
    // caller's duals at si = 0 and the last QP's after
    s.init_ip();
    __syncthreads();
    float mu_b = MU0;
    for (int it = 0; it < a.ip_iters; ++it) mu_b = s.newton(mu_b);
    s.rti_step(si);
  }
  s.diagnostics();
}

// The launch geometry (fused_ip_geometry fills out[] with it): lanes a
// block (32), shared bytes a lane and a block, blocks resident an SM
// (occupancy API), registers a thread, the most lanes a block (32), of the
// instance with or without the boundary rows.  lanes_per_block: 0 or 32.
// The attribute and occupancy calls are made once per device and shared
// memory size, and kept.
template <bool BND>
static int geometry(const IpArgs* args, int32_t out[6]) {
  static int dev_c = -1, smem_c = -1, nb = 0, regs = 0;
  auto kernel = fused_ip_ring_kernel<T_IP, BND, Model>;
  if (args->lanes_per_block != 0 && args->lanes_per_block != LPB)
    return (int)cudaErrorInvalidValue;
  const int lane_bytes =
      ring_lane_floats<Model, BND>(args->H, T_IP) * (int)sizeof(float);
  const int smem = LPB * lane_bytes;
  int dev = 0, err;
  if ((err = cudaGetDevice(&dev))) return err;
  if (dev != dev_c || smem != smem_c) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &nb, kernel, LPB * T_IP, smem)))
      return err;
    cudaFuncAttributes fa;
    if ((err = cudaFuncGetAttributes(&fa, kernel))) return err;
    regs = fa.numRegs;
    dev_c = dev;
    smem_c = smem;
  }
  out[0] = LPB;
  out[1] = lane_bytes;
  out[2] = smem;
  out[3] = nb;
  out[4] = regs;
  out[5] = LPB;
  return 0;
}

template <bool BND>
static int launch(const IpArgs* args, const IpRBufs& b, void* stream) {
  int32_t g[6];
  int err = geometry<BND>(args, g);
  if (err) return err;
  if (g[3] < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (args->B + LPB - 1) / LPB, threads = LPB * T_IP;
  const size_t smem = (size_t)g[2];
  auto kernel = fused_ip_ring_kernel<T_IP, BND, Model>;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(*args, b);
  return (int)cudaGetLastError();
}

// f(std::bool_constant<BND>()) for the instance of args.  The ST library
// builds both; the KS one the boundary rows' alone, and refuses a problem
// without them (B2 without rows is fused_ip.cu's).
template <class F>
static int with_instance(const IpArgs* args, F f) {
  if (args->boundary) return f(std::true_type());
  if constexpr (Model::ST) {
    return f(std::false_type());
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// Floats of one lane's shared memory at horizon H with (boundary != 0) or
// without the boundary rows (the Python side's eligibility mirrors it).
extern "C" int fused_ip_lane_floats(int H, int boundary) {
  return boundary ? ring_lane_floats<Model, true>(H, T_IP)
                  : ring_lane_floats<Model, false>(H, T_IP);
}

extern "C" int fused_ip_geometry(const IpArgs* args, int32_t* out) {
  return with_instance(args, [&](auto bnd) {
    return geometry<decltype(bnd)::value>(args, out);
  });
}

extern "C" int fused_ip_solve(const IpArgs* args, const float* x0,
                              const float* xref, const float* obs,
                              const float* mind, const float* w, float* U,
                              float* lam_lo, float* lam_hi, float* X,
                              float* pviol, float* diag, int32_t* rung,
                              const float* bnd, float* s_lo, float* s_hi,
                              float* dX, float* dU, float* ddX, float* ddU,
                              float* K, float* d, float* AB, float* Xc,
                              float* Uc, void* stream) {
  if (args->boundary && !bnd) return (int)cudaErrorInvalidValue;
  if (args->n_alphas > 0 && !(Xc && Uc)) return (int)cudaErrorInvalidValue;
  IpRBufs b{x0, xref, obs, mind, w, U, lam_lo, lam_hi, X, pviol, diag, rung,
            bnd, s_lo, s_hi, dX, dU, ddX, ddU, K, d, AB, Xc, Uc};
  return with_instance(args, [&](auto bnd_) {
    return launch<decltype(bnd_)::value>(args, b, stream);
  });
}
