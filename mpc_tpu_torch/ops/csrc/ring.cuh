// ring.cuh — the ring of stage operands of the fused kernels' H100 designs
// (fused_gn.cu, fused_ip_ring.cu): a block of 32 lanes and T warps, thread
// (w, l) serving lane l; warps 1..T-1 produce a stage's operands into a
// ring of slots in shared memory, (slot, field, lane) with the lane
// fastest, and warp 0 consumes them stage after stage (the Riccati sweep,
// a forward pass, the adjoint), each slot with a full and an empty named
// barrier between its one producer warp and warp 0.
//
// Both include the stage operand's layout with its structural zeros left
// out (Ring), the named barriers and the cp.async copies (the host
// emulation of the kernels' tests stands in for both under
// HOST_KERNEL_SHIM).  The ring loop and the slot accessors below are
// fused_ip_ring.cu's; fused_gn.cu keeps its own member versions of them.
#pragma once

#include "st_model.cuh"

#define LPB 32  // lanes a block: a warp's width

// One stage's operands in a ring slot (field, lane), and the other shared
// arrays whose size the model sets.  Q has nonzeros at Q00 Q01 Q11 Q04 Q14
// Q44 Q22 Q23 Q33 and the diagonal of the weights, R at R00 R11, M at M21
// M31 (assemble_quad); rows 2 and 3 of A are the identity's and of B a
// single constant each in both models (delta and v are pure integrators
// under RK4 and Euler), the other rows of A and B are dense.
template <class Mdl>
struct Ring {
  static constexpr int N = Mdl::N;
  static constexpr int NQ = N + 4;   // Q00 Q01 Q11 Q04 Q14 Q44 Q22 Q23 Q33,
                                     // then Q55 Q66 (ST)
  static constexpr int NAR = N - 2;  // rows of A and B stored: all but 2, 3
  static constexpr int OP_Q = 0;
  static constexpr int OP_R = NQ;          // R00 R11
  static constexpr int OP_M = NQ + 2;      // M21 M31
  static constexpr int OP_QX = NQ + 4;     // qx (N)
  static constexpr int OP_QU = OP_QX + N;  // qu (2)
  static constexpr int OP_A = OP_QU + NU;  // rows 0, 1, 4[, 5, 6] of A
  static constexpr int OP_B = OP_A + NAR * N;   // the same rows of B
  static constexpr int OP_BD = OP_B + NAR * NU;  // B20, B31
  static constexpr int NOP = OP_BD + 2;    // 43 (KS), 71 (ST)
  static constexpr int NAB = NOP - OP_A;   // (A, B) of a stage: 23, 47
  static constexpr int NROLL = N + NU + NU * N + NU;  // X, U, K, d a stage
  static constexpr int PSTR = (N * N + N) | 1;  // P and p, padded odd
  // the state row of stored row r: 0, 1, 4, 5, 6
  __host__ __device__ static constexpr int arow(int r) {
    return r < 2 ? r : r + 2;
  }
};

// Stages of the ring from the producers to the consumer: a multiple of the
// T - 1 producer warps, so that a slot always has the same producer (6, 6
// and 7 at T = 2, 4, 8).
__host__ __device__ constexpr int ring_slots(int T) {
  return (T - 1) * ((6 + T - 2) / (T - 1));
}

// Named barriers (bar.arrive / bar.sync with an id and a thread count):
// a producer warp arrives, the consuming warp waits, and back.
__device__ __forceinline__ void bar_arrive(int id, int n) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#elif defined(HOST_KERNEL_SHIM)
  host_named_barrier(id, n, false);
#endif
}
__device__ __forceinline__ void bar_wait(int id, int n) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#elif defined(HOST_KERNEL_SHIM)
  host_named_barrier(id, n, true);
#endif
}

// Asynchronous 4-byte copies from device into shared memory (cp.async),
// by which a chain's thread fetches the next stage while it computes this
// one; a plain copy in the host emulation.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// The ring over n items j = 0..n-1 (the caller maps j to its stage):
// item j is made by warp 1 + j % (T - 1) into slot j % R with make(j, s),
// and warp 0 runs use(j, s) on the items in order as they arrive.  Slot s
// has two named barriers between its producer and warp 0: full (1 + s)
// and empty (1 + R + s).  Threads past the last lane (live false) meet the
// barriers only.  Two rings in a row need a __syncthreads between them,
// which their barriers' counts then start from zero.
template <int T, class Make, class Use>
__device__ __forceinline__ void ring_pipeline(int w, bool live, int n,
                                              Make make, Use use) {
  constexpr int P = T - 1, R = ring_slots(T), PAIR = 2 * LPB;
  if (w == 0) {
    for (int j = 0; j < n; ++j) {
      const int s = j % R;
      bar_wait(1 + s, PAIR);
      if (live) use(j, s);
      if (j + R < n) bar_arrive(1 + R + s, PAIR);
    }
  } else {
    for (int j = w - 1; j < n; j += P) {
      const int s = j % R;
      if (j >= R) bar_wait(1 + R + s, PAIR);
      if (live) make(j, s);
      bar_arrive(1 + s, PAIR);
    }
  }
}

// ---- a stage's operands into a slot (p(f): field f, a float&) and out of
// it (g(f): field f)

template <class Mdl, class Put>
__device__ __forceinline__ void ring_put_quad(
    Put p, const float Q[Mdl::N][Mdl::N], const float R[NU][NU],
    const float M[Mdl::N][NU], const float qx[Mdl::N], const float qu[NU]) {
  using RG = Ring<Mdl>;
  constexpr int N = Mdl::N;
  const float qv[9] = {Q[0][0], Q[0][1], Q[1][1], Q[0][4], Q[1][4],
                       Q[4][4], Q[2][2], Q[2][3], Q[3][3]};
#pragma unroll
  for (int i = 0; i < 9; ++i) p(RG::OP_Q + i) = qv[i];
#pragma unroll
  for (int i = 5; i < N; ++i) p(RG::OP_Q + 4 + i) = Q[i][i];
  p(RG::OP_R) = R[0][0];
  p(RG::OP_R + 1) = R[1][1];
  p(RG::OP_M) = M[2][1];
  p(RG::OP_M + 1) = M[3][1];
#pragma unroll
  for (int i = 0; i < N; ++i) p(RG::OP_QX + i) = qx[i];
#pragma unroll
  for (int i = 0; i < NU; ++i) p(RG::OP_QU + i) = qu[i];
}

// (A, B) of a stage: the stored rows of A, those of B, then B20 and B31
template <class Mdl, class Put>
__device__ __forceinline__ void ring_put_ab(Put p,
                                            const float A[Mdl::N][Mdl::N],
                                            const float Bm[Mdl::N][NU]) {
  using RG = Ring<Mdl>;
  constexpr int N = Mdl::N;
#pragma unroll
  for (int r = 0; r < RG::NAR; ++r) {
#pragma unroll
    for (int j = 0; j < N; ++j) p(RG::OP_A + r * N + j) = A[RG::arow(r)][j];
#pragma unroll
    for (int j = 0; j < NU; ++j)
      p(RG::OP_B + r * NU + j) = Bm[RG::arow(r)][j];
  }
  p(RG::OP_BD) = Bm[2][0];
  p(RG::OP_BD + 1) = Bm[3][1];
}

// entry (i, j) of [A | B] (StModel::lin's put): rows 2 and 3 only through
// B20 and B31, the other entries of those rows being the identity's and
// zero
template <class Mdl, class Put>
__device__ __forceinline__ void ring_put_ab_entry(Put p, int i, int j,
                                                  float v) {
  using RG = Ring<Mdl>;
  constexpr int N = Mdl::N;
  if (i == 2 || i == 3) {
    if (j == N + i - 2) p(RG::OP_BD + i - 2) = v;
    return;
  }
  const int r = i < 2 ? i : i - 2;
  p(j < N ? RG::OP_A + r * N + j : RG::OP_B + r * NU + j - N) = v;
}

// Q and qx of a stage (the full symmetric Q, zeros where assemble_quad
// leaves them)
template <class Mdl, class G>
__device__ __forceinline__ void ring_get_qx(G g, float Q[Mdl::N][Mdl::N],
                                            float qx[Mdl::N]) {
  using RG = Ring<Mdl>;
  constexpr int N = Mdl::N;
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

// R and M of a stage k < H
template <class Mdl, class G>
__device__ __forceinline__ void ring_get_rm(G g, float R[NU][NU],
                                            float M[Mdl::N][NU]) {
  using RG = Ring<Mdl>;
  R[0][0] = g(RG::OP_R);
  R[1][1] = g(RG::OP_R + 1);
  R[0][1] = R[1][0] = 0.f;
#pragma unroll
  for (int i = 0; i < Mdl::N; ++i) M[i][0] = M[i][1] = 0.f;
  M[2][1] = g(RG::OP_M);
  M[3][1] = g(RG::OP_M + 1);
}

// A and B of a stage k < H (rows 2 and 3 of A are the identity's and of B
// a single constant each, as both models' steps leave them)
template <class Mdl, class G>
__device__ __forceinline__ void ring_get_ab(G g, float A[Mdl::N][Mdl::N],
                                            float Bm[Mdl::N][NU]) {
  using RG = Ring<Mdl>;
  constexpr int N = Mdl::N;
#pragma unroll
  for (int r = 0; r < RG::NAR; ++r) {
#pragma unroll
    for (int j = 0; j < N; ++j) A[RG::arow(r)][j] = g(RG::OP_A + r * N + j);
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
