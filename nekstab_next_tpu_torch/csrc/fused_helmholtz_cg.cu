// Whole-solve preconditioned CG for the assembled projected Helmholtz system
//
//     A x = P (h1 K + h2 B) P x = rhs,   P = vmask . inv_mult . dssum(vmask .)
//
// for C field components at once, preconditioned by P . FDM . P, with early
// exit at rr <= tol^2 bb and at most maxiter iterations — one cooperative
// kernel launch per solve.
//
// Replaces: nekstab_next_tpu/ops/fused_cg.py, FusedHelmholtzCG._build_call
// (Pallas kernel body `kernel`, pallas_call in `call`).  Its plain PyTorch
// version is FusedHelmholtzCG.plain in nekstab_next_tpu_torch/ops/fused_cg.py.
//
// What bounds it on Hopper: not FLOPs and not HBM.  At the flagship shape
// (768 elements, n = 7, C = 2) every vector is 300 KB and lives in L2; one
// iteration does ~2 * 7 FMAs per node and component per contraction.  The
// cost is the grid-wide dependency: each iteration has two cross-element
// gathers (dssum) and two global dot products, i.e. four grid barriers.
//
// Design: one persistent cooperative kernel (grid sync between phases, no
// host sync inside a solve).  Blocks own fixed element ranges, so the
// element-local phases (operator apply, axpys, FDM) run back to back on the
// block's own elements without a barrier; barriers separate only the gathers
// and the dots.  Tensor-product contractions are n x n loops over shared
// memory (7 FMAs a node per direction, not the 49 of the TPU's Kronecker
// matmuls).  Dots accumulate in double and are reduced deterministically
// (sem_device.cuh), so every block takes the same early-exit branch.
// Simple first: no wgmma/TMA; later work can tune it.
#include "sem_device.cuh"

namespace nsk {

struct HelmParams {
  int E, C, maxiter;
  float tol, h1, h2;
  const float* rhs;
  float *x, *r, *p, *z, *Ap, *w;  // (E, n*n, C) each; w is the gather buffer
  double* part;                   // 3 * gridDim.x partial sums
  const float *D, *S, *lam;       // (n, n), (n, n), (n)
  const float* fgeo;              // (E, 3): b/a, a/b, a*b of the FDM box
  const float *g11, *g12, *g22, *bm, *imult;  // (E, n*n)
  const float* vmask;                          // (E, n*n, C)
  const int *gid, *gs_off, *gs_idx;            // dssum gather table
};

// w = vmask * fdm(val): tensor-product fast-diagonalization inverse of the
// element's box operator, FDM denominator rebuilt from h1, h2 (threshold
// 1e-6 ref, as the TPU kernel).  u, s1, s2: the slot's shared buffers.
template <int N>
__device__ __forceinline__ void fdm_elem(const HelmParams& P, int e, bool act, int t,
                                         size_t vi, float val, float* u, float* s1,
                                         float* s2, const float* sS, const float* slam) {
  const int i = t / N, j = t % N;
  if (act) u[t] = val;
  __syncthreads();
  if (act) {  // s1[i,b] = sum_q S[q,b] u[i,q]
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) a += sS[q * N + j] * u[i * N + q];
    s1[t] = a;
  }
  __syncthreads();
  if (act) {  // s2[a,b] = inv[a,b] * sum_q S[q,a] s1[q,b]
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) a += sS[q * N + i] * s1[q * N + j];
    const float boa = __ldg(P.fgeo + 3 * e), aob = __ldg(P.fgeo + 3 * e + 1),
                ab = __ldg(P.fgeo + 3 * e + 2);
    const float den = P.h1 * (boa * slam[i] + aob * slam[j]) + P.h2 * ab;
    const float ref = P.h1 * (boa + aob) * slam[1] + P.h2 * ab;
    const float inv = den > 1e-6f * ref ? 1.f / den : 1.f / fmaxf(ref, 1e-30f);
    s2[t] = a * inv;
  }
  __syncthreads();
  if (act) {  // s1[i,b] = sum_q S[i,q] s2[q,b]
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) a += sS[i * N + q] * s2[q * N + j];
    s1[t] = a;
  }
  __syncthreads();
  if (act) {  // y[i,j] = sum_q S[j,q] s1[i,q]
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) a += sS[j * N + q] * s1[i * N + q];
    P.w[vi] = __ldg(P.vmask + vi) * a;
  }
  __syncthreads();
}

// w = vmask * (h1 K + h2 B) p for component c of element e.
template <int N>
__device__ __forceinline__ void helm_elem(const HelmParams& P, bool act, int t, size_t gi,
                                          size_t vi, float* u, float* s1, float* s2,
                                          const float* sD) {
  const int i = t / N, j = t % N;
  if (act) u[t] = P.p[vi];
  __syncthreads();
  if (act) {
    float ur = 0.f, us = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      ur += sD[i * N + q] * u[q * N + j];
      us += sD[j * N + q] * u[i * N + q];
    }
    const float a11 = __ldg(P.g11 + gi), a12 = __ldg(P.g12 + gi), a22 = __ldg(P.g22 + gi);
    s1[t] = a11 * ur + a12 * us;
    s2[t] = a12 * ur + a22 * us;
  }
  __syncthreads();
  if (act) {
    float k = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) k += sD[q * N + i] * s1[q * N + j] + sD[q * N + j] * s2[i * N + q];
    P.w[vi] = __ldg(P.vmask + vi) * (P.h1 * k + P.h2 * __ldg(P.bm + gi) * u[t]);
  }
  __syncthreads();
}

template <int N>
__global__ void __launch_bounds__(THREADS) helmholtz_cg_kernel(const HelmParams P) {
  constexpr int NN = N * N;
  cg::grid_group grid = cg::this_grid();
  __shared__ float sD[NN], sS[NN], slam[N];
  __shared__ float sbuf[EPB][3][TPE];
  __shared__ double red[3 * WARPS];
  for (int q = threadIdx.x; q < NN; q += THREADS) {
    sD[q] = P.D[q];
    sS[q] = P.S[q];
  }
  if (threadIdx.x < N) slam[threadIdx.x] = P.lam[threadIdx.x];
  __syncthreads();

  const int slot = threadIdx.x / TPE, t = threadIdx.x % TPE;
  const int C = P.C, G = gridDim.x;
  const int first = blockIdx.x * EPB, stride = G * EPB;
  float* u = sbuf[slot][0];
  float* s1 = sbuf[slot][1];
  float* s2 = sbuf[slot][2];
  double* part_pap = P.part;
  double* part_rz = P.part + G;  // rz, rr in consecutive rows

  // ---- init: x = 0, r = b, w = vmask fdm(b); then z = p = P(w) ----------
  double acc1[1] = {0.0};
  for (int eb = first; eb < P.E; eb += stride) {
    const int e = eb + slot;
    const bool act = t < NN && e < P.E;
    const size_t gi = (size_t)e * NN + t;
    for (int c = 0; c < C; ++c) {
      const size_t vi = gi * C + c;
      float b = 0.f;
      if (act) {
        b = P.rhs[vi];
        P.x[vi] = 0.f;
        P.r[vi] = b;
        acc1[0] += (double)b * b;
      }
      fdm_elem<N>(P, e, act, t, vi, b, u, s1, s2, sS, slam);
    }
  }
  block_partials<1>(acc1, part_pap, red);
  grid.sync();
  double bb[1];
  grid_sum<1>(part_pap, bb, red);
  double acc2[2] = {0.0, 0.0};
  for (int eb = first; eb < P.E; eb += stride) {
    const int e = eb + slot;
    if (t < NN && e < P.E) {
      const size_t gi = (size_t)e * NN + t;
      const float im = __ldg(P.imult + gi);
      for (int c = 0; c < C; ++c) {
        const size_t vi = gi * C + c;
        const float zz = __ldg(P.vmask + vi) * im * gs_sum(P.w, P.gid, P.gs_off, P.gs_idx, (int)gi, C, c);
        P.z[vi] = zz;
        P.p[vi] = zz;
        acc2[0] += (double)P.r[vi] * zz;
      }
    }
  }
  block_partials<2>(acc2, part_rz, red);
  grid.sync();
  double s2v[2];
  grid_sum<2>(part_rz, s2v, red);
  double rz = s2v[0], rr = bb[0];
  const double atol2 = (double)P.tol * (double)P.tol * bb[0];

  for (int k = 0; k < P.maxiter && rr > atol2; ++k) {
    // A: w = vmask (h1 K + h2 B) p on the block's own elements
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      const bool act = t < NN && e < P.E;
      const size_t gi = (size_t)e * NN + t;
      for (int c = 0; c < C; ++c) helm_elem<N>(P, act, t, gi, gi * C + c, u, s1, s2, sD);
    }
    grid.sync();
    // B: Ap = vmask inv_mult dssum(w); p.Ap
    acc1[0] = 0.0;
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      if (t < NN && e < P.E) {
        const size_t gi = (size_t)e * NN + t;
        const float im = __ldg(P.imult + gi);
        for (int c = 0; c < C; ++c) {
          const size_t vi = gi * C + c;
          const float ap = __ldg(P.vmask + vi) * im * gs_sum(P.w, P.gid, P.gs_off, P.gs_idx, (int)gi, C, c);
          P.Ap[vi] = ap;
          acc1[0] += (double)P.p[vi] * ap;
        }
      }
    }
    block_partials<1>(acc1, part_pap, red);
    grid.sync();
    double pap[1];
    grid_sum<1>(part_pap, pap, red);
    const float alpha = (float)sdiv(rz, pap[0]);
    // C: x += alpha p, r -= alpha Ap, w = vmask fdm(r)
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      const bool act = t < NN && e < P.E;
      const size_t gi = (size_t)e * NN + t;
      for (int c = 0; c < C; ++c) {
        const size_t vi = gi * C + c;
        float rv = 0.f;
        if (act) {
          P.x[vi] += alpha * P.p[vi];
          rv = P.r[vi] - alpha * P.Ap[vi];
          P.r[vi] = rv;
        }
        fdm_elem<N>(P, e, act, t, vi, rv, u, s1, s2, sS, slam);
      }
    }
    grid.sync();
    // D: z = vmask inv_mult dssum(w); r.z and r.r
    acc2[0] = 0.0;
    acc2[1] = 0.0;
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      if (t < NN && e < P.E) {
        const size_t gi = (size_t)e * NN + t;
        const float im = __ldg(P.imult + gi);
        for (int c = 0; c < C; ++c) {
          const size_t vi = gi * C + c;
          const float zz = __ldg(P.vmask + vi) * im * gs_sum(P.w, P.gid, P.gs_off, P.gs_idx, (int)gi, C, c);
          const float rv = P.r[vi];
          P.z[vi] = zz;
          acc2[0] += (double)rv * zz;
          acc2[1] += (double)rv * rv;
        }
      }
    }
    block_partials<2>(acc2, part_rz, red);
    grid.sync();
    grid_sum<2>(part_rz, s2v, red);
    const float beta = (float)sdiv(s2v[0], rz);
    rz = s2v[0];
    rr = s2v[1];
    // E: p = z + beta p (own elements; the next A reads only these)
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      if (t < NN && e < P.E) {
        const size_t gi = (size_t)e * NN + t;
        for (int c = 0; c < C; ++c) {
          const size_t vi = gi * C + c;
          P.p[vi] = P.z[vi] + beta * P.p[vi];
        }
      }
    }
  }
}

template <int N>
static int launch(const HelmParams& P, int device, cudaStream_t stream) {
  return (int)launch_cooperative(helmholtz_cg_kernel<N>, P, P.E, 0, device, stream);
}

}  // namespace nsk

extern "C" int nsk_fused_helmholtz_cg(
    int device, int n, int E, int C, int maxiter, float tol, float h1, float h2,
    const float* rhs, float* x, float* r, float* p, float* z, float* Ap, float* w,
    double* part, const float* D, const float* S, const float* lam, const float* fgeo,
    const float* g11, const float* g12, const float* g22, const float* bm,
    const float* imult, const float* vmask, const int* gid, const int* gs_off,
    const int* gs_idx, void* stream) {
  nsk::HelmParams P;
  P.E = E; P.C = C; P.maxiter = maxiter;
  P.tol = tol; P.h1 = h1; P.h2 = h2;
  P.rhs = rhs; P.x = x; P.r = r; P.p = p; P.z = z; P.Ap = Ap; P.w = w; P.part = part;
  P.D = D; P.S = S; P.lam = lam; P.fgeo = fgeo;
  P.g11 = g11; P.g12 = g12; P.g22 = g22; P.bm = bm; P.imult = imult; P.vmask = vmask;
  P.gid = gid; P.gs_off = gs_off; P.gs_idx = gs_idx;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 4: return nsk::launch<4>(P, device, st);
    case 5: return nsk::launch<5>(P, device, st);
    case 6: return nsk::launch<6>(P, device, st);
    case 7: return nsk::launch<7>(P, device, st);
    case 8: return nsk::launch<8>(P, device, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
