// riccati.cu — the batched Riccati backward sweep in one launch, for Hopper.
//
// Replaces tools/ablation/pallas_riccati.py::_riccati_kernel (the Pallas TPU
// kernel, launched by _riccati_pallas_packed) and computes, per lane, the
// function of mpc_tpu/ops/riccati_vec.py::backward_pass_vec: starting from
// the terminal cost (P, p) = (QH, qH), for stages k = H-1 .. 0
//
//   Prp = p + P r,  Qxx = Q + A'PA,  Quu = R + B'PB,  Qux = M' + B'PA,
//   gx = qx + A' Prp,  gu = qu + B' Prp,
//   K = -(Quu + reg I)^-1 Qux,  d = -(Quu + reg I)^-1 gu  (closed-form 2x2),
//   P <- sym(Qxx + Qux' K),  p <- gx + Qux' d,
//
// and the predicted-decrease terms dV1 = sum_k d'gu and
// dV2 = sum_k d'(Quu + reg I) d.  The plain PyTorch version of the same
// function is riccati_vec.py::backward_pass_vec_plain.
//
// The state dimension RX is a template parameter: 5 for the KS model, 7
// for the ST model (args.nx picks the instance).
//
// What bounds it on an H100.  Per lane and stage it reads Q, R, M, qx, qu,
// A, B, r (86 floats at RX = 5, 150 at RX = 7) and writes K, d (12 or 16);
// per lane it reads QH, qH (30 or 56) and writes dV1, dV2.  That is ~0.2
// GB at the bench point (B=16384, H=30, RX = 5) for ~1,000 fp32
// operations a lane and stage, so by the roofline it is
// bound by bytes (~0.06 ms).  In practice it is bound by latency: the
// stages are a sequential chain within a lane, and at 16384 lanes one
// thread per lane gives 512 warps, about one per scheduler on 132 SMs, so
// each stage's loads and its dependent 5x5 products are exposed.
//
// What the design does about it.  One thread per lane and a loop over the
// stages in reverse: no synchronisation, P (25 floats, 49 at RX = 7) and p
// stay in registers for the whole sweep (the nx=7 instance takes 255
// registers and spills nothing, PERF.md), and every stage's operands are
// read once
// from a structure-of-arrays layout, (stage, field, lane) with the lane
// fastest, so the 32 threads of a warp load neighbouring addresses.  All
// of a stage's loads are independent of its arithmetic, so the compiler can
// start them together.  No shared memory is needed.
//
// Semantics kept on purpose: IEEE division (build without --use_fast_math),
// so a singular Quu gives the inf and NaN gains the plain version gives; the
// unguarded solve scrubs them afterwards.

#include <cuda_runtime.h>
#include <stdint.h>

#define RU 2  // input dimension

struct RicArgs {
  int32_t B, H, threads;
  float reg;
  int32_t nx;  // state dimension: 5 (KS) or 7 (ST)
};

struct RicBufs {
  const float *Q, *R, *M, *qx, *qu, *A, *Bm, *r, *QH, *qH;
  float *K, *d, *dV;
};

template <int RX>
__global__ void riccati_kernel(const __grid_constant__ RicArgs a,
                               const __grid_constant__ RicBufs b) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.B) return;
  const size_t B = (size_t)a.B;
  // element (k, i) of an array stored (stage, field, lane) with nf fields
#define AT(k, i, nf) ((((size_t)(k)) * (nf) + (i)) * B + lane)

  float P[RX][RX], p[RX];
#pragma unroll
  for (int i = 0; i < RX; ++i) {
#pragma unroll
    for (int j = 0; j < RX; ++j) P[i][j] = b.QH[AT(0, i * RX + j, RX * RX)];
    p[i] = b.qH[AT(0, i, RX)];
  }
  float dv1 = 0.f, dv2 = 0.f;
  for (int k = a.H - 1; k >= 0; --k) {
    float Q[RX][RX], A[RX][RX], R[RU][RU], M[RX][RU], Bm[RX][RU];
    float qx[RX], qu[RU], r[RX];
#pragma unroll
    for (int i = 0; i < RX; ++i) {
#pragma unroll
      for (int j = 0; j < RX; ++j) {
        Q[i][j] = b.Q[AT(k, i * RX + j, RX * RX)];
        A[i][j] = b.A[AT(k, i * RX + j, RX * RX)];
      }
#pragma unroll
      for (int j = 0; j < RU; ++j) {
        M[i][j] = b.M[AT(k, i * RU + j, RX * RU)];
        Bm[i][j] = b.Bm[AT(k, i * RU + j, RX * RU)];
      }
      qx[i] = b.qx[AT(k, i, RX)];
      r[i] = b.r[AT(k, i, RX)];
    }
#pragma unroll
    for (int i = 0; i < RU; ++i) {
#pragma unroll
      for (int j = 0; j < RU; ++j) R[i][j] = b.R[AT(k, i * RU + j, RU * RU)];
      qu[i] = b.qu[AT(k, i, RU)];
    }

    // PA = P A, PB = P B, Prp = p + P r
    float PA[RX][RX], PB[RX][RU], Prp[RX];
#pragma unroll
    for (int i = 0; i < RX; ++i) {
#pragma unroll
      for (int j = 0; j < RX; ++j) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < RX; ++t) s += P[i][t] * A[t][j];
        PA[i][j] = s;
      }
#pragma unroll
      for (int j = 0; j < RU; ++j) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < RX; ++t) s += P[i][t] * Bm[t][j];
        PB[i][j] = s;
      }
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < RX; ++t) s += P[i][t] * r[t];
      Prp[i] = p[i] + s;
    }
    // Quu = R + B'PB, Qux = M' + B'PA, gu = qu + B' Prp
    float Quu[RU][RU], Qux[RU][RX], gu[RU];
#pragma unroll
    for (int i = 0; i < RU; ++i) {
#pragma unroll
      for (int j = 0; j < RU; ++j) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < RX; ++t) s += Bm[t][i] * PB[t][j];
        Quu[i][j] = R[i][j] + s;
      }
#pragma unroll
      for (int j = 0; j < RX; ++j) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < RX; ++t) s += Bm[t][i] * PA[t][j];
        Qux[i][j] = M[j][i] + s;
      }
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < RX; ++t) s += Bm[t][i] * Prp[t];
      gu[i] = qu[i] + s;
    }
    // closed-form inverse of Quu + reg I
    const float aa = Quu[0][0] + a.reg, bb = Quu[0][1], cc = Quu[1][0],
                dd = Quu[1][1] + a.reg;
    const float inv_det = 1.f / (aa * dd - bb * cc);
    const float Qi[RU][RU] = {{dd * inv_det, -bb * inv_det},
                              {-cc * inv_det, aa * inv_det}};
    float Kk[RU][RX], dk[RU];
#pragma unroll
    for (int i = 0; i < RU; ++i) {
#pragma unroll
      for (int j = 0; j < RX; ++j) {
        Kk[i][j] = -(Qi[i][0] * Qux[0][j] + Qi[i][1] * Qux[1][j]);
        b.K[AT(k, i * RX + j, RU * RX)] = Kk[i][j];
      }
      dk[i] = -(Qi[i][0] * gu[0] + Qi[i][1] * gu[1]);
      b.d[AT(k, i, RU)] = dk[i];
    }
    dv1 += dk[0] * gu[0] + dk[1] * gu[1];
    dv2 += dk[0] * (aa * dk[0] + bb * dk[1]) + dk[1] * (cc * dk[0] + dd * dk[1]);

    // P <- sym(Q + A'PA + Qux' K), p <- qx + A' Prp + Qux' d
    float Pn[RX][RX], pn[RX];
#pragma unroll
    for (int i = 0; i < RX; ++i) {
#pragma unroll
      for (int j = 0; j < RX; ++j) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < RX; ++t) s += A[t][i] * PA[t][j];
        Pn[i][j] = Q[i][j] + s + Qux[0][i] * Kk[0][j] + Qux[1][i] * Kk[1][j];
      }
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < RX; ++t) s += A[t][i] * Prp[t];
      pn[i] = qx[i] + s + Qux[0][i] * dk[0] + Qux[1][i] * dk[1];
    }
#pragma unroll
    for (int i = 0; i < RX; ++i) {
      p[i] = pn[i];
#pragma unroll
      for (int j = 0; j < RX; ++j) P[i][j] = 0.5f * (Pn[i][j] + Pn[j][i]);
    }
  }
  b.dV[AT(0, 0, 2)] = dv1;
  b.dV[AT(0, 1, 2)] = dv2;
#undef AT
}

// C entry point: one launch on `stream` of the instance of args->nx;
// returns the CUDA error of the launch (0 when it was accepted).  Arrays are (stage, field, lane) and
// (field, lane), float32, lanes fastest.
extern "C" int riccati_sweep(const RicArgs* args, const float* Q,
                             const float* R, const float* M, const float* qx,
                             const float* qu, const float* A, const float* Bm,
                             const float* r, const float* QH, const float* qH,
                             float* K, float* d, float* dV, void* stream) {
  RicBufs b{Q, R, M, qx, qu, A, Bm, r, QH, qH, K, d, dV};
  if (args->nx != 5 && args->nx != 7) return (int)cudaErrorInvalidValue;
  const int threads = args->threads > 0 ? args->threads : 64;
  const int blocks = (args->B + threads - 1) / threads;
  auto kernel = args->nx == 7 ? riccati_kernel<7> : riccati_kernel<5>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args, b);
  return (int)cudaGetLastError();
}
