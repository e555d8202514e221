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
// What bounds it on Hopper: the grid-wide dependencies, not FLOPs or HBM
// (bound ~2.2 us a flagship solve, operations).  Per iteration: one
// velocity-space gather (M^-1 needs dssum), one coarse vertex gather and two
// dot products — four grid barriers:
//   A  p = z + beta p; w = vmask D^T p                          | barrier
//   B  Ap = D vmask binv dssum(w); p.Ap                         | barrier + dot
//   C  x += alpha p; r -= alpha Ap; z = Pinv r; corner residuals | barrier
//   D  vertex sums V; the coarse solution at the block's own
//      corners; z += coarse prolongation; r.z, r.r              | barrier + dot
// A solve of k iterations crosses 2 + 4 k barriers (+ 2 with the mean
// projection).  The coarse solve has no phase of its own: every block forms
// all nc vertex sums V in shared memory (the same sums in every block) and
// computes only the rows of xc = Acinv V that its own elements' corners
// need, 16 rows a group of 4 elements, one warp per row (two at once).
// Measured on an H100 (700 W): 12.0 us an iteration, 17.5 us of set-up; the
// four barriers are ~6.3 us of it (tools_torch/grid_barrier_probe.py), the
// rest is two L2 round trips for data of other blocks (the gather of w; the
// 4E corner residuals every block copies to form V), the 16 coarse rows and
// the __syncthreads stages of the Gauss <-> GLL transfers.
//
// Design: one persistent cooperative kernel; blocks own element groups and
// run the element-local work (D^T lift, D restriction, block inverse, coarse
// restriction/prolongation) without barriers.  A block that owns one group
// (the flagship: 192 groups, 192 blocks; __launch_bounds__ keep two blocks
// an SM) keeps its nodes' metric factors, masks, first four gather copies,
// each Gauss node's row of the block inverse and its CG values x, r, p, z,
// Ap in registers for the whole solve, and, where shared memory holds them,
// its 16 rows of Acinv and the vertex lists, copied with cp.async while the
// init phase runs; a block that owns several groups re-reads them for every
// group.  The
// barrier is the arrive/wait GridSync of sem_device.cuh, the dots' partials
// ride on it.  The coarse level runs in full f32 (the TPU kernel ran its
// vertex scatters with bf16 products), through vertex -> (element, corner)
// lists summed in list order, so it is deterministic like the dssum.  The
// Q1 restriction and prolongation are folded with the Gauss<->GLL lift into
// one (4, npr^2) matrix Kc, built on the host in float64.  The Gauss-space
// stages keep one thread per Gauss node (25 of a slot's 64 at n = 7):
// spreading a 25-term sum over more threads would change its order.  Every
// sum keeps the order of the first version of this kernel, so it returns
// the same bits.  No wgmma/TMA.
#include "sem_device.cuh"

namespace nsk {

struct PresParams {
  int E, nc, maxiter, project_mean;
  int M, MV;       // gather copies per node; (element, corner) slots per vertex
  int stage;       // 1: the block's 16 Acinv rows and the vertex lists are
                   // staged in shared memory
  float tol;
  const float* rhs;
  float *x, *r, *p, *z, *Ap;  // (E, npr^2) each
  float* w;                   // (E, n*n, 2) velocity gather buffer
  float* rc;                  // (E, 4) corner residuals
  unsigned* bar;              // zeroed arrival counter
  double* part;               // 4 * gridDim.x partial sums
  const float *D, *Jg, *Kc;   // (n, n); (n, npr) Gauss -> GLL; (4, npr^2)
  const float *rx, *ry, *sx, *sy, *bm, *binv;  // (E, n*n)
  const float* vmask;                           // (E, n*n, 2)
  const float* pinv;                            // (E, npr^2, npr^2)
  const float* Acinv;                           // (nc, nc)
  const int* cid;                               // (E, 4) corner vertices
  const int* vtx;                               // (nc, MV) vertex lists
  const int* copies;                            // (E*n*n, M) gather lists
};

constexpr int RCH = 4096;  // corner residuals staged at a time (16 KB)

template <int N>
struct PresShared {
  static constexpr int NP = N - 2, NN = N * N, NP2 = NP * NP;
  alignas(16) float rcb[RCH];  // a chunk of the corner residuals
  float D[NN], Jg[N * NP], Kc[4 * NP2];
  float buf[EPB][6][TPE];
  float xc[EPB * 4];  // coarse solution at the group's (element, corner) slots
  double red[4 * WARPS];
};

// One thread's static operands: GLL node t and Gauss node t of element e.
template <int N>
struct PresNode {
  static constexpr int NN = N * N, NP2 = (N - 2) * (N - 2);
  float rx = 0.f, ry = 0.f, sx = 0.f, sy = 0.f, bm = 0.f, binv = 0.f, vm0 = 0.f, vm1 = 0.f;
  float pinv[NP2];  // the Gauss node's row of the element-block inverse
  Copies cp;

  __device__ __forceinline__ void load(const PresParams& P, int e, int t) {
    cp.k[0] = cp.k[1] = cp.k[2] = cp.k[3] = -1;
    if (e >= P.E) return;
    if (t < NN) {
      const size_t gi = (size_t)e * NN + t;
      rx = __ldg(P.rx + gi);
      ry = __ldg(P.ry + gi);
      sx = __ldg(P.sx + gi);
      sy = __ldg(P.sy + gi);
      bm = __ldg(P.bm + gi);
      binv = __ldg(P.binv + gi);
      vm0 = __ldg(P.vmask + gi * 2);
      vm1 = __ldg(P.vmask + gi * 2 + 1);
      cp.load(P.copies, gi, P.M);
    }
    if (t < NP2) {
      const float* row = P.pinv + ((size_t)e * NP2 + t) * NP2;
#pragma unroll
      for (int k = 0; k < NP2; ++k) pinv[k] = __ldg(row + k);
    }
  }
};

// 4-byte asynchronous copy global -> shared (no registers; completes at
// cp_async_wait_all).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Gauss node t's CG values x, r, p, z, Ap: in registers (`res`, a block
// that owns one group) or in the global vectors.
struct PresState {
  float v[5] = {};
  enum { X, R, P_, Z, AP };

  __device__ __forceinline__ float get(bool res, const float* g, int k, size_t pi) const {
    return res ? v[k] : g[pi];
  }
  __device__ __forceinline__ void put(bool res, float* g, int k, size_t pi, float a) {
    if (res)
      v[k] = a;
    else
      g[pi] = a;
  }
};

// w = vmask . D^T q for the element's Gauss field q (pv: node t's value).
template <int N>
__device__ __forceinline__ void gradT_elem(const PresParams& P, PresShared<N>& S,
                                           const PresNode<N>& nd, int e, int slot, int t,
                                           float pv) {
  constexpr int NP = N - 2, NN = N * N, NP2 = NP * NP;
  const bool ok = e < P.E;
  float* q = S.buf[slot][0];
  float* t1 = S.buf[slot][1];
  float *a0 = S.buf[slot][2], *b0 = S.buf[slot][3], *a1 = S.buf[slot][4], *b1 = S.buf[slot][5];
  if (ok && t < NP2) q[t] = pv;
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
  if (ok && t < NN) {  // zb[i,j] = bm sum_b Jg[j,b] t1[i,b]
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < NP; ++b) s += S.Jg[j * NP + b] * t1[i * NP + b];
    const float zb = nd.bm * s;
    a0[t] = nd.rx * zb;
    b0[t] = nd.sx * zb;
    a1[t] = nd.ry * zb;
    b1[t] = nd.sy * zb;
  }
  __syncthreads();
  if (ok && t < NN) {  // u_c = D_r^T a_c + D_s^T b_c
    float u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int q2 = 0; q2 < N; ++q2) {
      u0 += S.D[q2 * N + i] * a0[q2 * N + j] + S.D[q2 * N + j] * b0[i * N + q2];
      u1 += S.D[q2 * N + i] * a1[q2 * N + j] + S.D[q2 * N + j] * b1[i * N + q2];
    }
    const size_t gi = (size_t)e * NN + t;
    P.w[gi * 2] = nd.vm0 * u0;
    P.w[gi * 2 + 1] = nd.vm1 * u1;
  }
}

// ap = (D (vmask binv dssum(w)))[t] for the element (Gauss node t); pv is
// node t's p.  Returns this thread's share of p.Ap.
template <int N>
__device__ __forceinline__ double div_elem(const PresParams& P, PresShared<N>& S,
                                           const PresNode<N>& nd, int e, int slot, int t,
                                           float pv, float& ap) {
  constexpr int NP = N - 2, NN = N * N, NP2 = NP * NP;
  const bool ok = e < P.E;
  float *v0 = S.buf[slot][0], *v1 = S.buf[slot][1], *db = S.buf[slot][2], *t2 = S.buf[slot][3];
  const int i = t / N, j = t % N;
  const size_t gi = (size_t)e * NN + t;
  if (ok && t < NN) {
    v0[t] = nd.vm0 * nd.binv * gather(P.w, nd.cp, P.copies, gi, P.M, 2, 0);
    v1[t] = nd.vm1 * nd.binv * gather(P.w, nd.cp, P.copies, gi, P.M, 2, 1);
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
    const float d = nd.rx * ur0 + nd.sx * us0 + nd.ry * ur1 + nd.sy * us1;
    db[t] = nd.bm * d;
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
    ap = s;
    acc = (double)pv * s;
  }
  return acc;
}

// Local preconditioner part for residual value rv (Gauss node t of element
// e): returns (Pinv_e r_e)[t]; writes the coarse corner residuals rc[e, c] =
// Kc[c] . r_e.
template <int N>
__device__ __forceinline__ float precond_local(const PresParams& P, PresShared<N>& S,
                                               const PresNode<N>& nd, int e, int slot, int t,
                                               float rv) {
  constexpr int NP = N - 2, NP2 = NP * NP;
  const bool ok = e < P.E;
  float* rs = S.buf[slot][0];
  if (ok && t < NP2) rs[t] = rv;
  __syncthreads();
  float s = 0.f;
  if (ok && t < NP2) {
#pragma unroll
    for (int k = 0; k < NP2; ++k) s += nd.pinv[k] * rs[k];
  } else if (ok && t >= TPE - 4) {  // the slot's last 4 threads: the corners
    const int c = t - (TPE - 4);
    float sc = 0.f;
#pragma unroll
    for (int k = 0; k < NP2; ++k) sc += S.Kc[c * NP2 + k] * rs[k];
    P.rc[(size_t)e * 4 + c] = sc;
  }
  return s;
}

// V[v] = sum of rc over the vertex's (element, corner) slots in list order,
// all nc vertices, in shared memory; vt: the vertex lists (staged in shared
// memory or P.vtx).  Every block needs all 4E corner residuals: it copies
// them coalesced, RCH at a time and every load in flight at once, into
// shared memory (scattered 4-byte loads from every block queue at the L2),
// and each thread adds, for its vertices, the list entries that fall in the
// chunk; the lists are increasing, so every V[v] still sums in list order.
template <int N>
__device__ __forceinline__ void vertex_sums(const PresParams& P, PresShared<N>& S, float* V,
                                            const int* vt) {
  constexpr int CU = RCH / 4 / THREADS;  // float4 loads per thread per chunk
  const int total = 4 * P.E;
  for (int v = threadIdx.x; v < P.nc; v += THREADS) V[v] = 0.f;
  for (int c0 = 0; c0 < total; c0 += RCH) {
    const int n4 = min(RCH, total - c0) / 4;  // the chunk in float4s
    const float4* src = reinterpret_cast<const float4*>(P.rc + c0);
    float4 buf[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int i = threadIdx.x + u * THREADS;
      if (i < n4) buf[u] = __ldcg(src + i);
    }
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int i = threadIdx.x + u * THREADS;
      if (i < n4) reinterpret_cast<float4*>(S.rcb)[i] = buf[u];
    }
    __syncthreads();
#pragma unroll 2
    for (int v = threadIdx.x; v < P.nc; v += THREADS) {
      float s = V[v];
#pragma unroll 4
      for (int q = 0; q < P.MV; ++q) {
        const int k = vt[(size_t)v * P.MV + q] - c0;
        if (k >= 0 && k < 4 * n4) s += S.rcb[k];
      }
      V[v] = s;
    }
  }
}

// xc at the 16 (element, corner) slots of the group at eb: slot k = 4 *
// element slot + corner, row cid[eb + k / 4, k % 4] of Acinv dotted with V;
// warp w computes slots w and w + WARPS.  Staged rows sit in shared memory
// in slot order.
template <int N>
__device__ __forceinline__ void coarse_rows(const PresParams& P, PresShared<N>& S,
                                            const float* V, const float* rows, int eb) {
  static_assert(EPB * 4 == 2 * WARPS, "two rows a warp");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* a[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = warp + h * WARPS, e = eb + k / 4;
    ok[h] = e < P.E;
    a[h] = P.stage ? rows + (size_t)k * P.nc
           : ok[h]      ? P.Acinv + (size_t)__ldg(P.cid + 4 * e + k % 4) * P.nc
                        : P.Acinv;
  }
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
  for (int col = lane; col < P.nc; col += 32) {
    const float vv = V[col];
    s0 += a[0][col] * vv;
    s1 += a[1][col] * vv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_down_sync(0xffffffffu, s0, o);
    s1 += __shfl_down_sync(0xffffffffu, s1, o);
  }
  if (lane == 0) {
    S.xc[warp] = ok[0] ? s0 : 0.f;
    S.xc[warp + WARPS] = ok[1] ? s1 : 0.f;
  }
}

// Phase D for every group of the block: z += Kc^T xc (coarse prolongation),
// with p = z at init; returns the (r.z, r.r) shares in acc.
template <int N>
__device__ __forceinline__ void coarse_phase(const PresParams& P, PresShared<N>& S, float* V,
                                             const float* rows, const int* vt, PresState& st,
                                             bool res,
                                             int first, int stride, int slot, int t,
                                             bool reload, bool init, double (&acc)[2]) {
  constexpr int NP = N - 2, NP2 = NP * NP;
  vertex_sums<N>(P, S, V, vt);
  __syncthreads();
  for (int eb = first; eb < P.E; eb += stride) {
    coarse_rows<N>(P, S, V, rows, eb);
    __syncthreads();
    const int e = eb + slot;
    if (e < P.E && t < NP2) {
      const size_t pi = (size_t)e * NP2 + t;
      float zz = st.get(res, P.z, PresState::Z, pi);
#pragma unroll
      for (int c = 0; c < 4; ++c) zz += S.Kc[c * NP2 + t] * S.xc[4 * slot + c];
      st.put(res, P.z, PresState::Z, pi, zz);
      if (init) st.put(res, P.p, PresState::P_, pi, zz);
      const float rv = st.get(res, P.r, PresState::R, pi);
      acc[0] += (double)rv * zz;
      acc[1] += (double)rv * rv;
    }
    if (reload) __syncthreads();  // S.xc is rewritten for the next group
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, 2) pressure_cg_kernel(const PresParams P) {
  constexpr int NP = N - 2, NN = N * N, NP2 = NP * NP;
  constexpr int X = PresState::X, R = PresState::R, PP = PresState::P_, Z = PresState::Z,
                AP = PresState::AP;
  __shared__ PresShared<N> S;
  __shared__ int scid[EPB * 4];
  extern __shared__ float V[];  // nc vertex sums, then the staged Acinv rows
  float* rows = V + P.nc;         // and vertex lists
  int* svt = reinterpret_cast<int*>(rows + (size_t)EPB * 4 * P.nc);
  const int* vt = P.stage ? svt : P.vtx;
  for (int q = threadIdx.x; q < NN; q += THREADS) S.D[q] = P.D[q];
  for (int q = threadIdx.x; q < N * NP; q += THREADS) S.Jg[q] = P.Jg[q];
  for (int q = threadIdx.x; q < 4 * NP2; q += THREADS) S.Kc[q] = P.Kc[q];

  const int slot = threadIdx.x / TPE, t = threadIdx.x % TPE;
  const int G = gridDim.x;
  const int first = blockIdx.x * EPB, stride = G * EPB;
  const bool reload = first + stride < P.E;  // this block owns several groups
  const bool res = !reload;                  // CG values in registers
  const int row_pap = 0, row_rz = 1, row_mean = 3;
  const double csq = (double)P.E * NP2;
  GridSync gs{P.bar, P.part, 0u};
  PresNode<N> nd;
  PresState st;
  if (!reload) nd.load(P, first + slot, t);
  if (P.stage) {  // one group: its 16 corner rows, in slot order, and the
    if (threadIdx.x < EPB * 4) {  // vertex lists, copied while the init phase runs
      const int e = first + threadIdx.x / 4;
      scid[threadIdx.x] = e < P.E ? __ldg(P.cid + 4 * e + threadIdx.x % 4) : 0;
    }
    __syncthreads();
    const int total = EPB * 4 * P.nc;
    for (int f = threadIdx.x; f < total; f += THREADS) {
      const int k = f / P.nc, col = f - k * P.nc;
      cp_async4(rows + f, P.Acinv + (size_t)scid[k] * P.nc + col);
    }
    for (int f = threadIdx.x; f < P.nc * P.MV; f += THREADS)
      cp_async4(reinterpret_cast<float*>(svt + f), reinterpret_cast<const float*>(P.vtx + f));
  }
  __syncthreads();

  // ---- init: b = project(rhs), x = 0, r = b, z = M r, p = z -------------
  float mean = 0.f;
  if (P.project_mean) {
    double acc[1] = {0.0};
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      if (e < P.E && t < NP2) acc[0] += P.rhs[(size_t)e * NP2 + t];
    }
    grid_allreduce<1>(gs, row_mean, acc, S.red);
    mean = (float)(acc[0] / csq);
  }
  for (int eb = first; eb < P.E; eb += stride) {
    const int e = eb + slot;
    const size_t pi = (size_t)e * NP2 + t;
    if (reload) nd.load(P, e, t);
    float b = 0.f;
    if (e < P.E && t < NP2) {
      b = P.rhs[pi] - mean;
      st.put(res, P.x, X, pi, 0.f);
      st.put(res, P.r, R, pi, b);
    }
    const float zl = precond_local<N>(P, S, nd, e, slot, t, b);
    if (e < P.E && t < NP2) st.put(res, P.z, Z, pi, zl);
    if (reload) __syncthreads();  // the slot's buffer is rewritten for the next group
  }
  if (P.stage) cp_async_wait_all();  // the barrier's __syncthreads publishes them
  grid_sync(gs);
  double s2v[2] = {0.0, 0.0};
  coarse_phase<N>(P, S, V, rows, vt, st, res, first, stride, slot, t, reload, true, s2v);
  grid_allreduce<2>(gs, row_rz, s2v, S.red);
  double rz = s2v[0], rr = s2v[1];
  const double atol2 = (double)P.tol * (double)P.tol * s2v[1];
  float beta = 0.f;

  for (int k = 0; k < P.maxiter && rr > atol2; ++k) {
    // A: p = z + beta p (after the first iteration); w = vmask D^T p
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      if (reload) nd.load(P, e, t);
      float pv = 0.f;
      if (e < P.E && t < NP2) {
        const size_t pi = (size_t)e * NP2 + t;
        pv = st.get(res, P.p, PP, pi);
        if (k > 0) {
          pv = st.get(res, P.z, Z, pi) + beta * pv;
          st.put(res, P.p, PP, pi, pv);
        }
      }
      gradT_elem<N>(P, S, nd, e, slot, t, pv);
    }
    grid_sync(gs);
    // B: Ap = D vmask binv dssum(w); p.Ap
    double pap[1] = {0.0};
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      const size_t pi = (size_t)e * NP2 + t;
      const bool own = e < P.E && t < NP2;
      if (reload) nd.load(P, e, t);
      float ap = 0.f;
      pap[0] += div_elem<N>(P, S, nd, e, slot, t, own ? st.get(res, P.p, PP, pi) : 0.f, ap);
      if (own) st.put(res, P.Ap, AP, pi, ap);
    }
    grid_allreduce<1>(gs, row_pap, pap, S.red);
    const float alpha = (float)sdiv(rz, pap[0]);
    // C: x += alpha p, r -= alpha Ap, local preconditioner parts
    for (int eb = first; eb < P.E; eb += stride) {
      const int e = eb + slot;
      const size_t pi = (size_t)e * NP2 + t;
      const bool own = e < P.E && t < NP2;
      if (reload) nd.load(P, e, t);
      float rv = 0.f;
      if (own) {
        st.put(res, P.x, X, pi, st.get(res, P.x, X, pi) + alpha * st.get(res, P.p, PP, pi));
        rv = st.get(res, P.r, R, pi) - alpha * st.get(res, P.Ap, AP, pi);
        st.put(res, P.r, R, pi, rv);
      }
      const float zl = precond_local<N>(P, S, nd, e, slot, t, rv);
      if (own) st.put(res, P.z, Z, pi, zl);
      if (reload) __syncthreads();
    }
    grid_sync(gs);
    // D: coarse solve at the own corners, z += prolongation; r.z, r.r
    s2v[0] = 0.0;
    s2v[1] = 0.0;
    coarse_phase<N>(P, S, V, rows, vt, st, res, first, stride, slot, t, reload, false, s2v);
    grid_allreduce<2>(gs, row_rz, s2v, S.red);
    beta = (float)sdiv(s2v[0], rz);
    rz = s2v[0];
    rr = s2v[1];
  }

  // out = x, or project(x) for enclosed flows
  const size_t pres = (size_t)(first + slot) * NP2 + t;
  const bool own_res = res && first + slot < P.E && t < NP2;
  if (P.project_mean) {
    double acc[1] = {0.0};
    if (own_res) acc[0] += st.v[X];
    for (int eb = first; !res && eb < P.E; eb += stride) {
      const int e = eb + slot;
      if (e < P.E && t < NP2) acc[0] += P.x[(size_t)e * NP2 + t];
    }
    grid_allreduce<1>(gs, row_mean, acc, S.red);
    const float mx = (float)(acc[0] / csq);
    if (own_res) st.v[X] -= mx;
    for (int eb = first; !res && eb < P.E; eb += stride) {
      const int e = eb + slot;
      if (e < P.E && t < NP2) P.x[(size_t)e * NP2 + t] -= mx;
    }
  }
  if (own_res) P.x[pres] = st.v[X];
}

// Stage the Acinv rows and the vertex lists when every block owns one group
// and shared memory holds them; else read them from L2/HBM.
template <int N>
static cudaError_t launch(PresParams P, int device, cudaStream_t stream, int* info) {
  const size_t base = sizeof(float) * P.nc,
               staged = base * (1 + EPB * 4) + sizeof(int) * P.nc * P.MV;
  int cap = 0;
  cudaError_t err = resident_blocks(pressure_cg_kernel<N>, staged, device, &cap);
  if (err != cudaSuccess) return err;
  P.stage = (P.E + EPB - 1) / EPB <= cap;
  return launch_cooperative(pressure_cg_kernel<N>, P, P.E, P.stage ? staged : base, device,
                            stream, info);
}

}  // namespace nsk

extern "C" int nsk_fused_pressure_cg(
    int device, int n, int E, int nc, int maxiter, float tol, int project_mean,
    const float* rhs, float* x, float* r, float* p, float* z, float* Ap, float* w, float* rc,
    unsigned* bar, double* part, const float* D, const float* Jg, const float* Kc,
    const float* rx, const float* ry, const float* sx, const float* sy, const float* bm,
    const float* binv, const float* vmask, const float* pinv, const float* Acinv,
    const int* cid, const int* vtx, int MV, const int* copies, int M, void* stream,
    int* info) {
  nsk::PresParams P;
  P.E = E; P.nc = nc; P.maxiter = maxiter; P.project_mean = project_mean; P.tol = tol;
  P.M = M; P.MV = MV; P.stage = 0;
  P.rhs = rhs; P.x = x; P.r = r; P.p = p; P.z = z; P.Ap = Ap; P.w = w; P.rc = rc;
  P.bar = bar; P.part = part; P.D = D; P.Jg = Jg; P.Kc = Kc;
  P.rx = rx; P.ry = ry; P.sx = sx; P.sy = sy; P.bm = bm; P.binv = binv; P.vmask = vmask;
  P.pinv = pinv; P.Acinv = Acinv; P.cid = cid; P.vtx = vtx; P.copies = copies;
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
