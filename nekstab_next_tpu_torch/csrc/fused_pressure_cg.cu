// Whole-solve preconditioned CG for the PnPn-2 pressure system
//
//     E q = D M^-1 D^T q = rhs
//
// on the discontinuous Gauss pressure space (npr = n - 2 points a direction),
// preconditioned by the exact element-block inverse plus the Q1 vertex
// coarse level, with early exit at rr <= tol^2 bb, at most maxiter
// iterations and an optional mean projection (enclosed flows) — one
// cooperative kernel launch per solve.
//
// Replaces: nekstab_next_tpu/ops/fused_cg.py, FusedPressureCG._build_call
// (Pallas kernel body `kernel`, pallas_call in `call`).  Its plain PyTorch
// version is FusedPressureCG.plain in nekstab_next_tpu_torch/ops/fused_cg.py.
//
// What bounds it on Hopper: the grid-wide dependencies, not FLOPs or HBM.
// Per iteration: one velocity-space gather (M^-1 needs dssum), one coarse
// vertex gather, one dense coarse solve that needs every vertex sum, and
// two dot products — five grid barriers.  The largest operand is the dense
// coarse inverse Acinv (nc x nc; 816 vertices on the flagship, 2.7 MB f32),
// read from L2 once per iteration, one warp per row.
//
// Design: one persistent cooperative kernel; blocks own element ranges and
// run the element-local work (D^T lift, D restriction, block inverse, coarse
// restriction/prolongation) without barriers.  The coarse level runs in full
// f32 (the TPU kernel ran its vertex scatters with bf16 products), through
// a vertex -> (element, corner) table summed in table order, so it is
// deterministic like the dssum.  The Q1 restriction and prolongation are
// folded with the Gauss<->GLL lift into one (4, npr^2) matrix Kc, built on
// the host in float64.  Simple first: no wgmma/TMA.
#include "sem_device.cuh"

namespace nsk {

struct PresParams {
  int E, nc, maxiter, project_mean;
  float tol;
  const float* rhs;
  float *x, *r, *p, *z, *Ap;  // (E, npr^2) each
  float* w;                   // (E, n*n, 2) velocity gather buffer
  float *rc, *xc;             // (E, 4) corner residuals; (nc) coarse solution
  double* part;               // 4 * gridDim.x partial sums
  const float *D, *Jg, *Kc;   // (n, n); (n, npr) Gauss -> GLL; (4, npr^2)
  const float *rx, *ry, *sx, *sy, *bm, *binv;  // (E, n*n)
  const float* vmask;                           // (E, n*n, 2)
  const float* pinv;                            // (E, npr^2, npr^2)
  const float* Acinv;                           // (nc, nc)
  const int *cid, *vtx_off, *vtx_idx;           // coarse vertex table
  const int *gid, *gs_off, *gs_idx;             // dssum gather table
};

template <int N>
struct PresShared {
  static constexpr int NP = N - 2, NN = N * N, NP2 = NP * NP;
  float D[NN], Jg[N * NP], Kc[4 * NP2];
  float buf[EPB][6][TPE];
  double red[3 * WARPS];
};

// w = vmask . D^T q for the element's Gauss field q = p (first half of E).
template <int N>
__device__ __forceinline__ void gradT_elem(const PresParams& P, PresShared<N>& S, int e,
                                           int slot, int t) {
  constexpr int NP = N - 2, NN = N * N, NP2 = NP * NP;
  const bool ok = e < P.E;
  float* q = S.buf[slot][0];
  float* t1 = S.buf[slot][1];
  float *a0 = S.buf[slot][2], *b0 = S.buf[slot][3], *a1 = S.buf[slot][4], *b1 = S.buf[slot][5];
  if (ok && t < NP2) q[t] = P.p[(size_t)e * NP2 + t];
  __syncthreads();
  if (ok && t < N * NP) {  // t1[i,b] = sum_a Jg[i,a] q[a,b]
    const int i = t / NP, b = t % NP;
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < NP; ++a) s += S.Jg[i * NP + a] * q[a * NP + b];
    t1[t] = s;
  }
  __syncthreads();
  const int i = t / N, j = t % N;
  const size_t gi = (size_t)e * NN + t;
  if (ok && t < NN) {  // zb[i,j] = bm sum_b Jg[j,b] t1[i,b]
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < NP; ++b) s += S.Jg[j * NP + b] * t1[i * NP + b];
    const float zb = __ldg(P.bm + gi) * s;
    a0[t] = __ldg(P.rx + gi) * zb;
    b0[t] = __ldg(P.sx + gi) * zb;
    a1[t] = __ldg(P.ry + gi) * zb;
    b1[t] = __ldg(P.sy + gi) * zb;
  }
  __syncthreads();
  if (ok && t < NN) {  // u_c = D_r^T a_c + D_s^T b_c
    float u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int q2 = 0; q2 < N; ++q2) {
      u0 += S.D[q2 * N + i] * a0[q2 * N + j] + S.D[q2 * N + j] * b0[i * N + q2];
      u1 += S.D[q2 * N + i] * a1[q2 * N + j] + S.D[q2 * N + j] * b1[i * N + q2];
    }
    P.w[gi * 2] = __ldg(P.vmask + gi * 2) * u0;
    P.w[gi * 2 + 1] = __ldg(P.vmask + gi * 2 + 1) * u1;
  }
  __syncthreads();
}

// Ap = D (vmask binv dssum(w)) for the element (second half of E); returns
// this thread's share of p.Ap.
template <int N>
__device__ __forceinline__ double div_elem(const PresParams& P, PresShared<N>& S, int e,
                                           int slot, int t) {
  constexpr int NP = N - 2, NN = N * N, NP2 = NP * NP;
  const bool ok = e < P.E;
  float *v0 = S.buf[slot][0], *v1 = S.buf[slot][1], *db = S.buf[slot][2], *t2 = S.buf[slot][3];
  const int i = t / N, j = t % N;
  const size_t gi = (size_t)e * NN + t;
  if (ok && t < NN) {
    const float bi = __ldg(P.binv + gi);
    v0[t] = __ldg(P.vmask + gi * 2) * bi * gs_sum(P.w, P.gid, P.gs_off, P.gs_idx, (int)gi, 2, 0);
    v1[t] = __ldg(P.vmask + gi * 2 + 1) * bi * gs_sum(P.w, P.gid, P.gs_off, P.gs_idx, (int)gi, 2, 1);
  }
  __syncthreads();
  if (ok && t < NN) {
    float ur0 = 0.f, us0 = 0.f, ur1 = 0.f, us1 = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      ur0 += S.D[i * N + q] * v0[q * N + j];
      us0 += S.D[j * N + q] * v0[i * N + q];
      ur1 += S.D[i * N + q] * v1[q * N + j];
      us1 += S.D[j * N + q] * v1[i * N + q];
    }
    const float d = __ldg(P.rx + gi) * ur0 + __ldg(P.sx + gi) * us0 +
                    __ldg(P.ry + gi) * ur1 + __ldg(P.sy + gi) * us1;
    db[t] = __ldg(P.bm + gi) * d;
  }
  __syncthreads();
  if (ok && t < NP * N) {  // t2[a,j] = sum_i Jg[i,a] db[i,j]
    const int a = t / N, jj = t % N;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) s += S.Jg[q * NP + a] * db[q * N + jj];
    t2[t] = s;
  }
  __syncthreads();
  double acc = 0.0;
  if (ok && t < NP2) {  // Ap[a,b] = sum_j Jg[j,b] t2[a,j]
    const int a = t / NP, b = t % NP;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < N; ++q) s += S.Jg[q * NP + b] * t2[a * N + q];
    const size_t pi = (size_t)e * NP2 + t;
    P.Ap[pi] = s;
    acc = (double)P.p[pi] * s;
  }
  __syncthreads();
  return acc;
}

// Local preconditioner part for residual value rv (node t of element e):
// z = Pinv_e r_e and the coarse corner residuals rc[e, c] = Kc[c] . r_e.
template <int N>
__device__ __forceinline__ void precond_local(const PresParams& P, PresShared<N>& S, int e,
                                              int slot, int t, float rv) {
  constexpr int NP = N - 2, NP2 = NP * NP;
  const bool ok = e < P.E;
  float* rs = S.buf[slot][0];
  if (ok && t < NP2) rs[t] = rv;
  __syncthreads();
  if (ok && t < NP2) {
    const float* row = P.pinv + ((size_t)e * NP2 + t) * NP2;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NP2; ++k) s += __ldg(row + k) * rs[k];
    P.z[(size_t)e * NP2 + t] = s;
  } else if (ok && t >= TPE - 4) {  // the slot's last 4 threads: the corners
    const int c = t - (TPE - 4);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NP2; ++k) s += S.Kc[c * NP2 + k] * rs[k];
    P.rc[(size_t)e * 4 + c] = s;
  }
  __syncthreads();
}

// Coarse solve xc = Acinv V, V[v] = sum of rc over the vertex's (element,
// corner) slots in table order.  Each block with rows forms all of V in
// shared memory (the same sums in every block), then one warp per row.
__device__ __forceinline__ void coarse_solve(const PresParams& P, float* V) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x * WARPS >= P.nc) return;  // block-uniform: no rows here
  for (int v = threadIdx.x; v < P.nc; v += THREADS) {
    const int k1 = __ldg(P.vtx_off + v + 1);
    float s = 0.f;
    for (int k = __ldg(P.vtx_off + v); k < k1; ++k) s += __ldcg(P.rc + __ldg(P.vtx_idx + k));
    V[v] = s;
  }
  __syncthreads();
  for (int row = blockIdx.x * WARPS + warp; row < P.nc; row += gridDim.x * WARPS) {
    const float* a = P.Acinv + (size_t)row * P.nc;
    float s = 0.f;
    for (int col = lane; col < P.nc; col += 32) s += __ldg(a + col) * V[col];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) P.xc[row] = s;
  }
}

// z += Kc^T xc[cid[e, :]] (coarse prolongation); returns (r.z, r.r) shares.
template <int N>
__device__ __forceinline__ void coarse_add(const PresParams& P, PresShared<N>& S, int e, int t,
                                           double (&acc)[2]) {
  constexpr int NP = N - 2, NP2 = NP * NP;
  if (e < P.E && t < NP2) {
    const size_t pi = (size_t)e * NP2 + t;
    float zz = P.z[pi];
#pragma unroll
    for (int c = 0; c < 4; ++c) zz += S.Kc[c * NP2 + t] * __ldcg(P.xc + __ldg(P.cid + 4 * e + c));
    P.z[pi] = zz;
    const float rv = P.r[pi];
    acc[0] += (double)rv * zz;
    acc[1] += (double)rv * rv;
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS) pressure_cg_kernel(const PresParams P) {
  constexpr int NP = N - 2, NN = N * N, NP2 = NP * NP;
  cg::grid_group grid = cg::this_grid();
  __shared__ PresShared<N> S;
  extern __shared__ float V[];  // nc coarse vertex sums
  for (int q = threadIdx.x; q < NN; q += THREADS) S.D[q] = P.D[q];
  for (int q = threadIdx.x; q < N * NP; q += THREADS) S.Jg[q] = P.Jg[q];
  for (int q = threadIdx.x; q < 4 * NP2; q += THREADS) S.Kc[q] = P.Kc[q];
  __syncthreads();

  const int slot = threadIdx.x / TPE, t = threadIdx.x % TPE;
  const int G = gridDim.x;
  const int first = blockIdx.x * EPB, stride = G * EPB;
  double* part_pap = P.part;
  double* part_rz = P.part + G;  // rz, rr rows
  double* part_mean = P.part + 3 * G;
  const double csq = (double)P.E * NP2;

  // ---- init: b = project(rhs), x = 0, r = b, z = M r, p = z -------------
  float mean = 0.f;
  if (P.project_mean) {
    double acc[1] = {0.0};
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      if (e < P.E && t < NP2) acc[0] += P.rhs[(size_t)e * NP2 + t];
    }
    block_partials<1>(acc, part_mean, S.red);
    grid.sync();
    grid_sum<1>(part_mean, acc, S.red);
    mean = (float)(acc[0] / csq);
  }
  for (int eb = first; eb < P.E; eb += stride) {
    const int e = eb + slot;
    float b = 0.f;
    if (e < P.E && t < NP2) {
      const size_t pi = (size_t)e * NP2 + t;
      b = P.rhs[pi] - mean;
      P.x[pi] = 0.f;
      P.r[pi] = b;
    }
    precond_local<N>(P, S, e, slot, t, b);
  }
  grid.sync();
  coarse_solve(P, V);
  grid.sync();
  double acc2[2] = {0.0, 0.0};
  for (int eb = first; eb < P.E; eb += stride) {
    const int e = eb + slot;
    coarse_add<N>(P, S, e, t, acc2);
    if (e < P.E && t < NP2) P.p[(size_t)e * NP2 + t] = P.z[(size_t)e * NP2 + t];
  }
  block_partials<2>(acc2, part_rz, S.red);
  grid.sync();
  double s2v[2];
  grid_sum<2>(part_rz, s2v, S.red);
  double rz = s2v[0], rr = s2v[1];
  const double atol2 = (double)P.tol * (double)P.tol * s2v[1];

  for (int k = 0; k < P.maxiter && rr > atol2; ++k) {
    // A: w = vmask D^T p
    for (int eb = first; eb < P.E; eb += stride) gradT_elem<N>(P, S, eb + slot, slot, t);
    grid.sync();
    // B: Ap = D vmask binv dssum(w); p.Ap
    double acc1[1] = {0.0};
    for (int eb = first; eb < P.E; eb += stride) acc1[0] += div_elem<N>(P, S, eb + slot, slot, t);
    block_partials<1>(acc1, part_pap, S.red);
    grid.sync();
    double pap[1];
    grid_sum<1>(part_pap, pap, S.red);
    const float alpha = (float)sdiv(rz, pap[0]);
    // C: x += alpha p, r -= alpha Ap, local preconditioner parts
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      float rv = 0.f;
      if (e < P.E && t < NP2) {
        const size_t pi = (size_t)e * NP2 + t;
        P.x[pi] += alpha * P.p[pi];
        rv = P.r[pi] - alpha * P.Ap[pi];
        P.r[pi] = rv;
      }
      precond_local<N>(P, S, e, slot, t, rv);
    }
    grid.sync();
    // D: coarse solve
    coarse_solve(P, V);
    grid.sync();
    // E: z += coarse prolongation; r.z, r.r
    acc2[0] = 0.0;
    acc2[1] = 0.0;
    for (int eb = first; eb < P.E; eb += stride) coarse_add<N>(P, S, eb + slot, t, acc2);
    block_partials<2>(acc2, part_rz, S.red);
    grid.sync();
    grid_sum<2>(part_rz, s2v, S.red);
    const float beta = (float)sdiv(s2v[0], rz);
    rz = s2v[0];
    rr = s2v[1];
    // F: p = z + beta p
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      if (e < P.E && t < NP2) {
        const size_t pi = (size_t)e * NP2 + t;
        P.p[pi] = P.z[pi] + beta * P.p[pi];
      }
    }
  }

  if (P.project_mean) {  // out = project(x)
    double acc[1] = {0.0};
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      if (e < P.E && t < NP2) acc[0] += P.x[(size_t)e * NP2 + t];
    }
    block_partials<1>(acc, part_mean, S.red);
    grid.sync();
    grid_sum<1>(part_mean, acc, S.red);
    const float mx = (float)(acc[0] / csq);
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      if (e < P.E && t < NP2) P.x[(size_t)e * NP2 + t] -= mx;
    }
  }
}

template <int N>
static int launch(const PresParams& P, int device, cudaStream_t stream) {
  return (int)launch_cooperative(pressure_cg_kernel<N>, P, P.E, (size_t)P.nc * sizeof(float),
                                 device, stream);
}

}  // namespace nsk

extern "C" int nsk_fused_pressure_cg(
    int device, int n, int E, int nc, int maxiter, float tol, int project_mean,
    const float* rhs, float* x, float* r, float* p, float* z, float* Ap, float* w, float* rc,
    float* xc, double* part, const float* D, const float* Jg, const float* Kc,
    const float* rx, const float* ry, const float* sx, const float* sy, const float* bm,
    const float* binv, const float* vmask, const float* pinv, const float* Acinv,
    const int* cid, const int* vtx_off, const int* vtx_idx, const int* gid,
    const int* gs_off, const int* gs_idx, void* stream) {
  nsk::PresParams P;
  P.E = E; P.nc = nc; P.maxiter = maxiter; P.project_mean = project_mean; P.tol = tol;
  P.rhs = rhs; P.x = x; P.r = r; P.p = p; P.z = z; P.Ap = Ap; P.w = w; P.rc = rc; P.xc = xc;
  P.part = part; P.D = D; P.Jg = Jg; P.Kc = Kc;
  P.rx = rx; P.ry = ry; P.sx = sx; P.sy = sy; P.bm = bm; P.binv = binv; P.vmask = vmask;
  P.pinv = pinv; P.Acinv = Acinv; P.cid = cid; P.vtx_off = vtx_off; P.vtx_idx = vtx_idx;
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
