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
// What bounds it on Hopper: not FLOPs and not HBM (bound ~1 us a flagship
// solve, operations).  At the flagship shape (768 elements, n = 7, C = 2;
// 192 blocks) every vector is 300 KB and lives in L2.  The cost is latency:
// each iteration has two cross-element gathers (dssum) and two global dot
// products, i.e. four grid barriers, the minimum for this recurrence (a
// gather needs its neighbours' w, a dot every block's partial).  A solve of
// k iterations crosses 2 + 4 k barriers.  Measured on an H100 (700 W): 9.5
// us an iteration, 10.8 us of set-up; two bare barriers (~1.25 us each) and
// two with an all-reduce (~1.9 us each; tools_torch/grid_barrier_probe.py)
// are ~6.3 us of it, the rest is the gathers' L2 round trips and the
// __syncthreads stages of the operator and the FDM.
//
// Design: one persistent cooperative kernel; a block owns fixed element
// groups, so the element-local phases (operator apply, axpys, FDM) run back
// to back on its own elements and barriers separate only the gathers and
// the dots.  Per phase the critical path is kept short:
// * resident state: a block that owns one group (the flagship: 192 groups,
//   192 blocks; __launch_bounds__ keep two blocks an SM, 264 on an H100)
//   loads each node's metrics, mass, inverse multiplicity, masks, FDM
//   inverse denominator (built once from h1, h2) and first four copy indices
//   into registers at kernel start, and keeps its CG vectors x, r, p, z, Ap
//   in registers for the whole solve (x is written once, at the end); a
//   block that owns several groups re-reads them for every group;
// * the component count is a template parameter for C = 1, 2, so component
//   loops unroll and their loads issue together (other C: a generic
//   instance with the vectors in memory);
// * the gather is one dependent load of w per copy (sem_device.cuh gather);
// * the C components run through each contraction together, so the
//   operator apply takes 2 __syncthreads and the FDM 4, whatever C;
// * the barrier is the arrive/wait GridSync, and the dots' partials ride on
//   it (grid_allreduce).
// Tensor-product contractions are n x n loops over shared memory (7 FMAs a
// node per direction, not the 49 of the TPU's Kronecker matmuls).  Every sum
// keeps the order of the first version of this kernel, so it returns the
// same bits.  No wgmma/TMA: at 4 KB a block per phase there is nothing for
// them to feed.
#include "sem_device.cuh"

namespace nsk {

struct HelmParams {
  int E, C, maxiter, M;  // M: copies per local node in `copies`
  float tol, h1, h2;
  const float* rhs;
  float *x, *r, *p, *z, *Ap, *w;  // (E, n*n, C) each; w is the gather buffer
  unsigned* bar;                  // zeroed arrival counter
  double* part;                   // 3 * gridDim.x partial sums
  const float *D, *S, *lam;       // (n, n), (n, n), (n)
  const float* fgeo;              // (E, 3): b/a, a/b, a*b of the FDM box
  const float *g11, *g12, *g22, *bm, *imult;  // (E, n*n)
  const float* vmask;                          // (E, n*n, C)
  const int* copies;                           // (E*n*n, M) gather lists
};

// One node's static operands (node t of element e); the mask of the first
// CR components.
template <int N, int CR>
struct HelmNode {
  float g11 = 0.f, g12 = 0.f, g22 = 0.f, bm = 0.f, im = 0.f;
  float finv = 0.f;  // FDM inverse eigen-denominator at (i, j)
  float vm[CR] = {};
  Copies cp;

  __device__ __forceinline__ void load(const HelmParams& P, int e, int t, const float* slam) {
    cp.k[0] = cp.k[1] = cp.k[2] = cp.k[3] = -1;
    if (e >= P.E || t >= N * N) return;
    const size_t gi = (size_t)e * N * N + t;
    g11 = __ldg(P.g11 + gi);
    g12 = __ldg(P.g12 + gi);
    g22 = __ldg(P.g22 + gi);
    bm = __ldg(P.bm + gi);
    im = __ldg(P.imult + gi);
#pragma unroll
    for (int c = 0; c < CR; ++c) vm[c] = c < P.C ? __ldg(P.vmask + gi * P.C + c) : 0.f;
    cp.load(P.copies, gi, P.M);
    // the denominator rebuilt from h1, h2, threshold 1e-6 ref, as the TPU kernel
    const int i = t / N, j = t % N;
    const float boa = __ldg(P.fgeo + 3 * e), aob = __ldg(P.fgeo + 3 * e + 1),
                ab = __ldg(P.fgeo + 3 * e + 2);
    const float den = P.h1 * (boa * slam[i] + aob * slam[j]) + P.h2 * ab;
    const float ref = P.h1 * (boa + aob) * slam[1] + P.h2 * ab;
    finv = den > 1e-6f * ref ? 1.f / den : 1.f / fmaxf(ref, 1e-30f);
  }

  // vmask of component c at local node gi
  __device__ __forceinline__ float mask(const HelmParams& P, size_t gi, int C, int c) const {
    return CR == C ? vm[c] : __ldg(P.vmask + gi * C + c);
  }
};

// One node's CG vectors x, r, p, z, Ap for its components: in registers
// (`res`, a block that owns one group, CT components known at compile time)
// or in the global vectors.
template <int CR>
struct HelmState {
  float v[5][CR] = {};
  enum { X, R, P_, Z, AP };

  __device__ __forceinline__ float get(bool res, const float* g, int k, size_t vi, int c) const {
    return res ? v[k][c] : g[vi];
  }
  __device__ __forceinline__ void put(bool res, float* g, int k, size_t vi, int c, float a) {
    if (res)
      v[k][c] = a;
    else
      g[vi] = a;
  }
};

// w = vmask * fdm(u): the tensor-product fast-diagonalization inverse of the
// element's box operator for all C components; u[c * TPE + t] holds this
// thread's values on entry.  u, s1, s2: the slot's shared buffers.
template <int N, int CT, int CR>
__device__ __forceinline__ void fdm_elem(const HelmParams& P, const HelmNode<N, CR>& nd, bool act,
                                         int t, size_t gi, float* u, float* s1, float* s2,
                                         const float* sS) {
  const int i = t / N, j = t % N, C = CT > 0 ? CT : P.C;
  __syncthreads();
  if (act)  // s1[i,b] = sum_q S[q,b] u[i,q]
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* uc = u + c * TPE;
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q) a += sS[q * N + j] * uc[i * N + q];
      s1[c * TPE + t] = a;
    }
  __syncthreads();
  if (act)  // s2[a,b] = inv[a,b] * sum_q S[q,a] s1[q,b]
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* s1c = s1 + c * TPE;
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q) a += sS[q * N + i] * s1c[q * N + j];
      s2[c * TPE + t] = a * nd.finv;
    }
  __syncthreads();
  if (act)  // s1[i,b] = sum_q S[i,q] s2[q,b]
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* s2c = s2 + c * TPE;
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q) a += sS[i * N + q] * s2c[q * N + j];
      s1[c * TPE + t] = a;
    }
  __syncthreads();
  if (act)  // y[i,j] = sum_q S[j,q] s1[i,q]
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* s1c = s1 + c * TPE;
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q) a += sS[j * N + q] * s1c[i * N + q];
      P.w[gi * C + c] = nd.mask(P, gi, C, c) * a;
    }
}

// w = vmask * (h1 K + h2 B) u for all C components; u[c * TPE + t] holds
// this thread's values on entry.
template <int N, int CT, int CR>
__device__ __forceinline__ void helm_elem(const HelmParams& P, const HelmNode<N, CR>& nd, bool act,
                                          int t, size_t gi, float* u, float* s1, float* s2,
                                          const float* sD) {
  const int i = t / N, j = t % N, C = CT > 0 ? CT : P.C;
  __syncthreads();
  if (act)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* uc = u + c * TPE;
      float ur = 0.f, us = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q) {
        ur += sD[i * N + q] * uc[q * N + j];
        us += sD[j * N + q] * uc[i * N + q];
      }
      s1[c * TPE + t] = nd.g11 * ur + nd.g12 * us;
      s2[c * TPE + t] = nd.g12 * ur + nd.g22 * us;
    }
  __syncthreads();
  if (act)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float *s1c = s1 + c * TPE, *s2c = s2 + c * TPE;
      float k = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q)
        k += sD[q * N + i] * s1c[q * N + j] + sD[q * N + j] * s2c[i * N + q];
      P.w[gi * C + c] = nd.mask(P, gi, C, c) * (P.h1 * k + P.h2 * nd.bm * u[c * TPE + t]);
    }
}

// CT: the component count when it is 1 or 2 (loops unrolled, a resident
// block's CG vectors in registers), 0 for any other (read from P.C; the
// vectors stay in global memory).
template <int N, int CT>
__global__ void __launch_bounds__(THREADS, 2) helmholtz_cg_kernel(const HelmParams P) {
  constexpr int NN = N * N, CR = CT > 0 ? CT : 1;
  constexpr int X = HelmState<CR>::X, R = HelmState<CR>::R, PP = HelmState<CR>::P_,
                Z = HelmState<CR>::Z, AP = HelmState<CR>::AP;
  __shared__ float sD[NN], sS[NN], slam[N];
  __shared__ double red[4 * WARPS];
  extern __shared__ float sbuf[];  // [EPB][3][C][TPE]
  for (int q = threadIdx.x; q < NN; q += THREADS) {
    sD[q] = P.D[q];
    sS[q] = P.S[q];
  }
  if (threadIdx.x < N) slam[threadIdx.x] = P.lam[threadIdx.x];
  __syncthreads();

  const int slot = threadIdx.x / TPE, t = threadIdx.x % TPE;
  const int C = CT > 0 ? CT : P.C, G = gridDim.x;
  const int first = blockIdx.x * EPB, stride = G * EPB;
  const bool reload = first + stride < P.E;  // this block owns several groups
  const bool res = CT > 0 && !reload;        // CG vectors in registers
  float* u = sbuf + (size_t)slot * 3 * C * TPE;
  float* s1 = u + C * TPE;
  float* s2 = s1 + C * TPE;
  GridSync gs{P.bar, P.part, 0u};
  HelmNode<N, CR> nd;
  HelmState<CR> st;
  if (!reload) nd.load(P, first + slot, t, slam);

  // ---- init: x = 0, r = b, w = vmask fdm(b); then z = p = P(w) ----------
  double bb[1] = {0.0};
  for (int eb = first; eb < P.E; eb += stride) {
    const int e = eb + slot;
    const bool act = t < NN && e < P.E;
    const size_t gi = (size_t)e * NN + t;
    if (reload) nd.load(P, e, t, slam);
    if (act)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t vi = gi * C + c;
        const float b = P.rhs[vi];
        st.put(res, P.x, X, vi, c, 0.f);
        st.put(res, P.r, R, vi, c, b);
        bb[0] += (double)b * b;
        u[c * TPE + t] = b;
      }
    fdm_elem<N, CT>(P, nd, act, t, gi, u, s1, s2, sS);
  }
  grid_allreduce<1>(gs, 0, bb, red);
  double rz1[1] = {0.0};
  for (int eb = first; eb < P.E; eb += stride) {
    const int e = eb + slot;
    const size_t gi = (size_t)e * NN + t;
    if (reload) nd.load(P, e, t, slam);
    if (t < NN && e < P.E)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t vi = gi * C + c;
        const float zz = nd.mask(P, gi, C, c) * nd.im * gather(P.w, nd.cp, P.copies, gi, P.M, C, c);
        st.put(res, P.z, Z, vi, c, zz);
        st.put(res, P.p, PP, vi, c, zz);
        rz1[0] += (double)st.get(res, P.r, R, vi, c) * zz;
      }
  }
  grid_allreduce<1>(gs, 1, rz1, red);
  double rz = rz1[0], rr = bb[0];
  const double atol2 = (double)P.tol * (double)P.tol * bb[0];
  float beta = 0.f;

  for (int k = 0; k < P.maxiter && rr > atol2; ++k) {
    // A: p = z + beta p (after the first iteration); w = vmask (h1 K + h2 B) p
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      const bool act = t < NN && e < P.E;
      const size_t gi = (size_t)e * NN + t;
      if (reload) nd.load(P, e, t, slam);
      if (act)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const size_t vi = gi * C + c;
          float pv = st.get(res, P.p, PP, vi, c);
          if (k > 0) {
            pv = st.get(res, P.z, Z, vi, c) + beta * pv;
            st.put(res, P.p, PP, vi, c, pv);
          }
          u[c * TPE + t] = pv;
        }
      helm_elem<N, CT>(P, nd, act, t, gi, u, s1, s2, sD);
    }
    grid_sync(gs);
    // B: Ap = vmask inv_mult dssum(w); p.Ap
    double pap[1] = {0.0};
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      const size_t gi = (size_t)e * NN + t;
      if (reload) nd.load(P, e, t, slam);
      if (t < NN && e < P.E)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const size_t vi = gi * C + c;
          const float ap = nd.mask(P, gi, C, c) * nd.im * gather(P.w, nd.cp, P.copies, gi, P.M, C, c);
          st.put(res, P.Ap, AP, vi, c, ap);
          pap[0] += (double)st.get(res, P.p, PP, vi, c) * ap;
        }
    }
    grid_allreduce<1>(gs, 0, pap, red);
    const float alpha = (float)sdiv(rz, pap[0]);
    // C: x += alpha p, r -= alpha Ap, w = vmask fdm(r)
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      const bool act = t < NN && e < P.E;
      const size_t gi = (size_t)e * NN + t;
      if (reload) nd.load(P, e, t, slam);
      if (act)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const size_t vi = gi * C + c;
          const float pv = st.get(res, P.p, PP, vi, c);
          st.put(res, P.x, X, vi, c, st.get(res, P.x, X, vi, c) + alpha * pv);
          const float rv = st.get(res, P.r, R, vi, c) - alpha * st.get(res, P.Ap, AP, vi, c);
          st.put(res, P.r, R, vi, c, rv);
          u[c * TPE + t] = rv;
        }
      fdm_elem<N, CT>(P, nd, act, t, gi, u, s1, s2, sS);
    }
    grid_sync(gs);
    // D: z = vmask inv_mult dssum(w); r.z and r.r
    double s2v[2] = {0.0, 0.0};
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      const size_t gi = (size_t)e * NN + t;
      if (reload) nd.load(P, e, t, slam);
      if (t < NN && e < P.E)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const size_t vi = gi * C + c;
          const float zz = nd.mask(P, gi, C, c) * nd.im * gather(P.w, nd.cp, P.copies, gi, P.M, C, c);
          const float rv = st.get(res, P.r, R, vi, c);
          st.put(res, P.z, Z, vi, c, zz);
          s2v[0] += (double)rv * zz;
          s2v[1] += (double)rv * rv;
        }
    }
    grid_allreduce<2>(gs, 1, s2v, red);
    beta = (float)sdiv(s2v[0], rz);
    rz = s2v[0];
    rr = s2v[1];
  }
  if (res && t < NN && first + slot < P.E)  // the solution leaves the registers
#pragma unroll
    for (int c = 0; c < C; ++c) P.x[((size_t)(first + slot) * NN + t) * C + c] = st.v[X][c];
}

template <int N>
static cudaError_t launch(const HelmParams& P, int device, cudaStream_t st, int* info) {
  const size_t smem = sizeof(float) * EPB * 3 * P.C * TPE;
  switch (P.C) {
    case 1: return launch_cooperative(helmholtz_cg_kernel<N, 1>, P, P.E, smem, device, st, info);
    case 2: return launch_cooperative(helmholtz_cg_kernel<N, 2>, P, P.E, smem, device, st, info);
    default: return launch_cooperative(helmholtz_cg_kernel<N, 0>, P, P.E, smem, device, st, info);
  }
}

}  // namespace nsk

extern "C" int nsk_fused_helmholtz_cg(
    int device, int n, int E, int C, int maxiter, float tol, float h1, float h2,
    const float* rhs, float* x, float* r, float* p, float* z, float* Ap, float* w,
    unsigned* bar, double* part, const float* D, const float* S, const float* lam,
    const float* fgeo, const float* g11, const float* g12, const float* g22,
    const float* bm, const float* imult, const float* vmask, const int* copies, int M,
    void* stream, int* info) {
  nsk::HelmParams P;
  P.E = E; P.C = C; P.maxiter = maxiter; P.M = M;
  P.tol = tol; P.h1 = h1; P.h2 = h2;
  P.rhs = rhs; P.x = x; P.r = r; P.p = p; P.z = z; P.Ap = Ap; P.w = w;
  P.bar = bar; P.part = part;
  P.D = D; P.S = S; P.lam = lam; P.fgeo = fgeo;
  P.g11 = g11; P.g12 = g12; P.g22 = g22; P.bm = bm; P.imult = imult; P.vmask = vmask;
  P.copies = copies;
  nsk::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 4: return (int)nsk::launch<4>(P, device, st, info);
    case 5: return (int)nsk::launch<5>(P, device, st, info);
    case 6: return (int)nsk::launch<6>(P, device, st, info);
    case 7: return (int)nsk::launch<7>(P, device, st, info);
    case 8: return (int)nsk::launch<8>(P, device, st, info);
    default: return (int)cudaErrorInvalidValue;
  }
}
