// Element-local weak Helmholtz apply, unassembled (no gather-scatter):
//
//     out = h1 * sum_ab D_a^T G_ab D_b u  +  h2 * bm * u       per element,
//
// in 2-D (n x n nodes, metrics g11 g12 g22) and 3-D (n x n x n nodes,
// metrics g11 g22 g33 g12 g13 g23), for C field components at once.  Fields
// are float32 in the JAX package's layout, (E, n, .., n) with the C
// components last: element e, node t, component c at (e * NN + t) * C + c.
//
// Replaces: nekstab_next_tpu/ops/pallas_kernels.py, FusedHelmholtz._build_call
// (pallas_call at :210; bodies _helmholtz2_kernel :67-83 and
// _helmholtz3_kernel :86-103).  Its plain PyTorch version is
// FusedHelmholtz.plain in nekstab_next_tpu_torch/ops/fused_helmholtz.py.
//
// What bounds it on Hopper.  The bytes: at the 3-D cube's velocity shape
// (1,472 elements, n = 7, C = 3) it must read u (6.06 MB) and seven
// metric/mass fields (14.1 MB) and write out (6.06 MB), 26.3 MB or 7.8 us
// at 3.35 TB/s; at the pressure shape (C = 1, h2 = 0, so bm is not read)
// 16.2 MB, 4.8 us.  The operations (~52 MFLOP per component) take under
// 3 us at 67 TFLOP/s.  As measured on an H100 (PERF.md section 6), the
// first version of this kernel (one element per 352-thread block, every
// operand of every contraction from shared memory, ~84 accesses per node
// and component) was paced by the shared-memory pipe, not device memory:
// ~3,600 SM cycles an element against ~3,500 wavefronts.  This one makes
// ~18 accesses per node and component; what remains is the pipeline around
// them: moving the bytes alone through it (no arithmetic) takes 2.2x the
// memory bound at the velocity shape with the L2 cache flushed, as the
// flush leaves dirty lines to write back.  At the 2-D flagship (768
// elements, n = 7, C = 2) it moves ~0.9 MB: launch-bound.
//
// Design:
// * lines and columns: a thread of an element plays three parts in turn,
//   each on N nodes: the line along i, (0:N, j, k), where it forms the
//   derivative along i of the line from N loads and writes it to shared
//   memory (N loads serve N outputs), likewise the line along j in 3-D;
//   then the column (i, j, 0:N), which it holds in registers with its
//   metrics: it forms the derivative along the column there, combines the
//   three with the metrics, keeps w along the column in registers and
//   writes the other two over the derivatives; then the lines again, for
//   the transposed contractions; then the column, which sums
//   (r + s) + t and h2 bm u.  Every contraction has D at compile-time
//   indices, read from the kernel's parameters (D is passed by value), so
//   D costs no load.  The layout of Swirydowicz et al. (arXiv 1711.00903)
//   kept the column in registers and read the other directions from
//   shared memory node by node (~4n + 3 accesses per node and component):
//   on this card that left the shared-memory pipe the limit (PERF.md).
// * components: in 3-D a thread carries all C (C is a template
//   parameter), so each node's metrics are read once; in 2-D, where an
//   element has only N columns and latency rules, one component a thread.
// * a persistent grid with the next operands in flight: a block owns EPB
//   elements at a time and walks the element groups with a stride of the
//   grid (as many blocks as fit on the card, sized once per process and
//   shape).  While a group computes, cp.async copies the next groups' u,
//   metrics and mass into the block's other buffers (a ring of 2, or of 3
//   with one element a block at C = 1 in 3-D, whichever measured faster):
//   16-byte copies for the aligned middle of each contiguous run, 4-byte
//   ones at its ragged ends.
//   bm is not read when h2 = 0.  The result overwrites the group's u in
//   shared memory and leaves in 16-byte stores.
// * five block barriers per group: operands landed (and the previous
//   group's store done), the line derivatives, w, the transposed line
//   terms, the result.
// * no atomics: the same bits run after run.  The forward derivatives and
//   w keep the first version's order (q ascending); the transposed sum is
//   (r + s) + t where the first version interleaved the three terms over
//   q, so the results differ from it in the last bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace nsk_helm {

constexpr int MAXC = 3;  // components per launch (the velocity's 2 or 3)
constexpr int MAXN = 8;
constexpr int MAXDEV = 16;

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

template <int DIM, int N, int C>
struct Geo {
  static constexpr int NN = DIM == 2 ? N * N : N * N * N;  // nodes per element
  static constexpr int NCOL = DIM == 2 ? N : N * N;        // columns per element
  static constexpr int NMET = DIM == 2 ? 3 : 6;            // metric fields
  // elements per block and buffers (one group computing, the others in
  // flight), as measured best on an H100 at n = 7 (PERF.md section 6):
  // 3-D C >= 2 ~160 threads (2 blocks an SM at C = 3) and 2 buffers;
  // 3-D C = 1, where the bytes outweigh the arithmetic, ~49 threads and a
  // ring of 3; 2-D one warp and 2 buffers
  static constexpr int EPB = DIM == 2 ? 32 / N
                             : C == 1 ? (49 / NCOL > 1 ? 49 / NCOL : 1)
                                      : (160 / NCOL > 1 ? 160 / NCOL : 1);
  static constexpr int NBUF = DIM == 3 && C == 1 ? 3 : 2;
  // components per thread: all C in 3-D (each node's metrics read once);
  // one in 2-D, where an element has few columns and latency rules
  static constexpr int CS = DIM == 2 ? 1 : C;
  static constexpr int THREADS = EPB * (C / CS) * NCOL;
  // one buffer: u of the group (+ 4 floats for its 16-byte phase), then each
  // metric field and bm of the group (each + 4)
  static constexpr int UF = round4(EPB * NN * C + 4);
  static constexpr int GF = round4(EPB * NN + 4);
  static constexpr int BUF = UF + (NMET + 1) * GF;
  // metric-weighted derivatives of the directions held in shared memory
  static constexpr int WF = EPB * C * (DIM - 1) * NN;
  static constexpr int SMEM = (NBUF * BUF + WF) * 4;  // bytes
};

struct Args {
  int E;
  float h1, h2;
  const float* u;
  float* out;
  const float* g[7];  // metrics, (E, NN) each: 2-D g11 g12 g22; 3-D g11 g22 g33
                      // g12 g13 g23; then bm
  float D[MAXN * MAXN];  // row-major: D[i * N + q] = dphi_q/dxi at node i
};

// ---- asynchronous copies global -> shared ----------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` of this thread's committed groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

// The 16-byte phase of a global address, in floats.
__device__ __forceinline__ int phase(const float* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

// Copy src[0:L) to dst[ph : ph + L), ph = phase(src), dst 16-byte aligned:
// the run's aligned middle in 16-byte copies, its ends in 4-byte ones.
__device__ __forceinline__ void stage(float* dst, const float* src, int L, int tid,
                                      int nthr) {
  const int ph = phase(src);
  const int h = min((4 - ph) & 3, L);
  const int nv = (L - h) >> 2;
  float* d = dst + ph;
  for (int v = tid; v < nv; v += nthr) cp_async16(d + h + 4 * v, src + h + 4 * v);
  const int rest = h + (L - h - 4 * nv);  // head, then tail
  for (int x = tid; x < rest; x += nthr) {
    const int y = x < h ? x : x + 4 * nv;
    cp_async4(d + y, src + y);
  }
}

// Store src[ph : ph + L) (shared, staged at phase(dst) == ph) to dst[0:L);
// 16-byte stores when the phases agree, else 4-byte ones.
__device__ __forceinline__ void unstage(float* dst, const float* src0, int ph, int L,
                                        int tid, int nthr) {
  const float* s = src0 + ph;
  if (phase(dst) == ph) {
    const int h = min((4 - ph) & 3, L);
    const int nv = (L - h) >> 2;
    for (int v = tid; v < nv; v += nthr)
      *reinterpret_cast<float4*>(dst + h + 4 * v) =
          *reinterpret_cast<const float4*>(s + h + 4 * v);
    const int rest = h + (L - h - 4 * nv);
    for (int x = tid; x < rest; x += nthr) {
      const int y = x < h ? x : x + 4 * nv;
      dst[y] = s[y];
    }
  } else {
    for (int x = tid; x < L; x += nthr) dst[x] = s[x];
  }
}

// Start the copies of element group g (if it exists) into buffer `buf`.
template <int DIM, int N, int C>
__device__ __forceinline__ void stage_group(const Args& A, int g, int groups, float* buf,
                                            bool with_bm) {
  using G = Geo<DIM, N, C>;
  if (g >= groups) return;
  const int e0 = g * G::EPB, ne = min(G::EPB, A.E - e0);
  stage(buf, A.u + (size_t)e0 * G::NN * C, ne * G::NN * C, threadIdx.x, G::THREADS);
  const int nm = with_bm ? G::NMET + 1 : G::NMET;
  for (int m = 0; m < nm; ++m)
    stage(buf + G::UF + m * G::GF, A.g[m] + (size_t)e0 * G::NN, ne * G::NN, threadIdx.x,
          G::THREADS);
}

// (the extra parentheses keep the template's commas out of the macro's arguments)
template <int DIM, int N, int C>
__global__ void __launch_bounds__((Geo<DIM, N, C>::THREADS))
helmholtz_local_kernel(const __grid_constant__ Args A) {
  using G = Geo<DIM, N, C>;
  constexpr int NN = G::NN, NCOL = G::NCOL, EPB = G::EPB, NMET = G::NMET;
  constexpr int SI = NN / N;  // node stride of i: node (i, j, k) is i*N*N + j*N + k
  extern __shared__ float4 smem4[];
  constexpr int NB = G::NBUF;
  float* const sbuf = reinterpret_cast<float*>(smem4);  // NB buffers of G::BUF
  float* const sw = sbuf + NB * G::BUF;                 // derivatives, G::WF

  const int tid = threadIdx.x;
  constexpr int CS = G::CS;
  const int slot = tid / (C / CS * NCOL), col = tid % NCOL;
  const int c1 = (tid / NCOL) % (C / CS) * CS;  // the thread's first component
  // A thread of an element slot plays three parts, each on N nodes:
  // * column: 3-D the nodes (i, j, 0:N) with col = i*N + j, 2-D (i, 0:N)
  //   with col = i; nodes col*N + k;
  // * line along i: 3-D (0:N, j, k) with col = j*N + k, 2-D (0:N, k) with
  //   col = k; nodes q*SI + col;
  // * line along j (3-D): (i, 0:N, k) with col = i*N + k; nodes
  //   i*N*N + q*N + k = (col / N)*N*N + q*N + col % N.
  const int lj0 = (col / N) * N * N + col % N;
  const int groups = (A.E + EPB - 1) / EPB;
  const bool with_bm = A.h2 != 0.f;

  for (int s = 0; s < NB - 1; ++s) {  // the block's first groups in flight
    stage_group<DIM, N, C>(A, blockIdx.x + s * gridDim.x, groups, sbuf + s * G::BUF,
                           with_bm);
    cp_async_commit();
  }
  for (int g = blockIdx.x, it = 0; g < groups; g += gridDim.x, ++it) {
    float* const buf = sbuf + (it % NB) * G::BUF;
    cp_async_wait_group<NB - 2>();  // group g landed; later ones may still fly
    __syncthreads();  // ... for every thread; the previous group's store is done
    // the group NB - 1 ahead into the buffer the previous one freed
    stage_group<DIM, N, C>(A, g + (NB - 1) * gridDim.x, groups,
                           sbuf + ((it + NB - 1) % NB) * G::BUF, with_bm);
    cp_async_commit();

    const int e0 = g * EPB, ne = min(EPB, A.E - e0);
    const int phu = phase(A.u + (size_t)e0 * NN * C);
    float* const ue = buf + phu + slot * NN * C;  // u, node t component c at t*C + c
    const float* gm[NMET + 1];
#pragma unroll
    for (int m = 0; m <= NMET; ++m)
      gm[m] = buf + G::UF + m * G::GF + phase(A.g[m] + (size_t)e0 * NN) + slot * NN;
    const bool act = slot < ne;
    // derivatives along i (d = 0) and j (d = 1, 3-D), per component and node
    float* const sd = sw + slot * C * (DIM - 1) * NN;
    auto dr = [&](int c, int d, int t) -> float& { return sd[(c * (DIM - 1) + d) * NN + t]; };

    // 1. lines: the reference derivatives along i (and j) of the slot's
    //    element, u_r = sum_q D[i,q] u[q,j,k] (q ascending), into shared
    //    memory; each line's N loads serve its N outputs
    if (act) {
#pragma unroll
      for (int c0 = 0, c = c1; c0 < CS; ++c0, ++c) {
        float v[N];
#pragma unroll
        for (int q = 0; q < N; ++q) v[q] = ue[(q * SI + col) * C + c];
#pragma unroll
        for (int p = 0; p < N; ++p) {
          float r = 0.f;
#pragma unroll
          for (int q = 0; q < N; ++q) r += A.D[p * N + q] * v[q];
          dr(c, 0, p * SI + col) = r;
        }
        if constexpr (DIM == 3) {
#pragma unroll
          for (int q = 0; q < N; ++q) v[q] = ue[(lj0 + q * N) * C + c];
#pragma unroll
          for (int p = 0; p < N; ++p) {
            float r = 0.f;
#pragma unroll
            for (int q = 0; q < N; ++q) r += A.D[p * N + q] * v[q];
            dr(c, 1, lj0 + p * N) = r;
          }
        }
      }
    }
    __syncthreads();  // u_r, u_s complete

    // 2. columns: the derivative along the column in registers, the metric
    //    combination; w along the column stays in registers, the others
    //    overwrite u_r, u_s
    float uc[CS][N];  // the column, every component
    float wt[CS][N];  // metric-weighted derivative along the column
    if (act) {
      float gv[NMET][N];  // this column's metrics, read once for every component
#pragma unroll
      for (int k = 0; k < N; ++k) {
#pragma unroll
        for (int c0 = 0, c = c1; c0 < CS; ++c0, ++c) uc[c0][k] = ue[(col * N + k) * C + c];
#pragma unroll
        for (int m = 0; m < NMET; ++m) gv[m][k] = gm[m][col * N + k];
      }
#pragma unroll
      for (int c0 = 0, c = c1; c0 < CS; ++c0, ++c)
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int t = col * N + k;
          float ul = 0.f;  // along the column: u_s in 2-D, u_t in 3-D
#pragma unroll
          for (int q = 0; q < N; ++q) ul += A.D[k * N + q] * uc[c0][q];
          const float ur = dr(c, 0, t);
          if constexpr (DIM == 2) {
            dr(c, 0, t) = gv[0][k] * ur + gv[1][k] * ul;
            wt[c0][k] = gv[1][k] * ur + gv[2][k] * ul;
          } else {
            const float us = dr(c, 1, t);
            dr(c, 0, t) = gv[0][k] * ur + gv[3][k] * us + gv[4][k] * ul;
            dr(c, 1, t) = gv[3][k] * ur + gv[1][k] * us + gv[5][k] * ul;
            wt[c0][k] = gv[4][k] * ur + gv[5][k] * us + gv[2][k] * ul;
          }
        }
    }
    __syncthreads();  // w_r, w_s complete

    // 3. lines: the transposed contractions along i (and j),
    //    sum_q D[q,i] w_r[q,j,k] (q ascending), each over its own w
    if (act) {
#pragma unroll
      for (int c0 = 0, c = c1; c0 < CS; ++c0, ++c) {
        float v[N];
#pragma unroll
        for (int q = 0; q < N; ++q) v[q] = dr(c, 0, q * SI + col);
#pragma unroll
        for (int p = 0; p < N; ++p) {
          float r = 0.f;
#pragma unroll
          for (int q = 0; q < N; ++q) r += A.D[q * N + p] * v[q];
          dr(c, 0, p * SI + col) = r;
        }
        if constexpr (DIM == 3) {
#pragma unroll
          for (int q = 0; q < N; ++q) v[q] = dr(c, 1, lj0 + q * N);
#pragma unroll
          for (int p = 0; p < N; ++p) {
            float r = 0.f;
#pragma unroll
            for (int q = 0; q < N; ++q) r += A.D[q * N + p] * v[q];
            dr(c, 1, lj0 + p * N) = r;
          }
        }
      }
    }
    __syncthreads();  // the transposed terms along i (and j) complete

    // 4. columns: K u = (r term + s term) + t term; out = h1 K u + h2 bm u,
    //    over the group's u in shared memory
    if (act) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int t = col * N + k;
        const float b = with_bm ? gm[NMET][t] : 0.f;
#pragma unroll
        for (int c0 = 0, c = c1; c0 < CS; ++c0, ++c) {
          float kl = 0.f;
#pragma unroll
          for (int q = 0; q < N; ++q) kl += A.D[q * N + k] * wt[c0][q];
          float ku = dr(c, 0, t);
          if constexpr (DIM == 3) ku += dr(c, 1, t);
          ku += kl;
          ue[t * C + c] = A.h1 * ku + A.h2 * b * uc[c0][k];
        }
      }
    }
    __syncthreads();  // the group's result complete in shared memory
    unstage(A.out + (size_t)e0 * NN * C, buf, phu, ne * NN * C, tid, G::THREADS);
  }
}

// Launch geometry of one instance on `device`, computed once per process:
// info = {grid for E elements, resident blocks per SM, elements per block,
// threads per block, dynamic shared memory bytes, SMs}.
template <int DIM, int N, int C>
static cudaError_t geometry(int device, int E, int* info) {
  using G = Geo<DIM, N, C>;
  static int per_sm[MAXDEV] = {}, nsm[MAXDEV] = {};
  if (device < 0 || device >= MAXDEV) return cudaErrorInvalidDevice;
  if (per_sm[device] == 0) {
    cudaError_t err = cudaFuncSetAttribute(helmholtz_local_kernel<DIM, N, C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           G::SMEM);
    if (err != cudaSuccess) return err;
    int b = 0, s = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, helmholtz_local_kernel<DIM, N, C>, G::THREADS, G::SMEM);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (b < 1) return cudaErrorInvalidConfiguration;
    nsm[device] = s;
    per_sm[device] = b;
  }
  const int groups = (E + G::EPB - 1) / G::EPB;
  const int cap = per_sm[device] * nsm[device];
  info[0] = groups < cap ? groups : cap;
  info[1] = per_sm[device];
  info[2] = G::EPB;
  info[3] = G::THREADS;
  info[4] = G::SMEM;
  info[5] = nsm[device];
  return cudaSuccess;
}

template <int DIM, int N, int C>
static cudaError_t launch(int device, const Args& A, cudaStream_t stream) {
  using G = Geo<DIM, N, C>;
  int info[6];
  cudaError_t err = geometry<DIM, N, C>(device, A.E, info);
  if (err != cudaSuccess) return err;
  helmholtz_local_kernel<DIM, N, C><<<info[0], G::THREADS, G::SMEM, stream>>>(A);
  return cudaGetLastError();
}

// One instance per (dim, n, C): launch it (A non-null) or report its geometry.
template <int DIM, int N>
static cudaError_t dispatch_c(int C, int device, int E, const Args* A, cudaStream_t st,
                              int* info) {
  switch (C) {
    case 1: return A ? launch<DIM, N, 1>(device, *A, st) : geometry<DIM, N, 1>(device, E, info);
    case 2: return A ? launch<DIM, N, 2>(device, *A, st) : geometry<DIM, N, 2>(device, E, info);
    case 3: return A ? launch<DIM, N, 3>(device, *A, st) : geometry<DIM, N, 3>(device, E, info);
    default: return cudaErrorInvalidValue;
  }
}

template <int DIM>
static cudaError_t dispatch(int n, int C, int device, int E, const Args* A, cudaStream_t st,
                            int* info) {
  switch (n) {
    case 4: return dispatch_c<DIM, 4>(C, device, E, A, st, info);
    case 5: return dispatch_c<DIM, 5>(C, device, E, A, st, info);
    case 6: return dispatch_c<DIM, 6>(C, device, E, A, st, info);
    case 7: return dispatch_c<DIM, 7>(C, device, E, A, st, info);
    case 8: return dispatch_c<DIM, 8>(C, device, E, A, st, info);
    default: return cudaErrorInvalidValue;
  }
}

// Run f on `device`, leaving the caller's current device as it was.
template <typename F>
static cudaError_t on_device(int device, F f) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  err = f();
  if (prev != device) {
    const cudaError_t reset = cudaSetDevice(prev);
    if (err == cudaSuccess) err = reset;
  }
  return err;
}

}  // namespace nsk_helm

// Launch on `device` and `stream`, leaving the caller's current device as it
// was.  Returns the CUDA error code of the launch (0 on success); a launch
// that is refused never runs.  D is (n, n), row-major, and is read on the
// host (it travels in the kernel's parameters).
extern "C" int nsk_fused_helmholtz(int device, int dim, int n, int E, int C, float h1,
                                   float h2, const float* u, float* out, const float* D,
                                   const float* g0, const float* g1, const float* g2,
                                   const float* g3, const float* g4, const float* g5,
                                   const float* bm, void* stream) {
  if ((dim != 2 && dim != 3) || C < 1 || C > nsk_helm::MAXC || E < 0 || n < 4 ||
      n > nsk_helm::MAXN)
    return (int)cudaErrorInvalidValue;
  if (E == 0) return 0;
  nsk_helm::Args A;
  A.E = E; A.h1 = h1; A.h2 = h2;
  A.u = u; A.out = out;
  A.g[0] = g0; A.g[1] = g1; A.g[2] = g2; A.g[3] = g3; A.g[4] = g4; A.g[5] = g5;
  if (dim == 2) {
    A.g[3] = bm;
    A.g[4] = A.g[5] = A.g[6] = nullptr;
  } else {
    A.g[6] = bm;
  }
  for (int k = 0; k < nsk_helm::MAXN * nsk_helm::MAXN; ++k) A.D[k] = k < n * n ? D[k] : 0.f;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)nsk_helm::on_device(device, [&] {
    return dim == 2 ? nsk_helm::dispatch<2>(n, C, device, E, &A, st, nullptr)
                    : nsk_helm::dispatch<3>(n, C, device, E, &A, st, nullptr);
  });
}

// The launch geometry nsk_fused_helmholtz uses for E elements:
// info[0] grid (blocks), [1] resident blocks per SM, [2] elements per block,
// [3] threads per block, [4] dynamic shared memory bytes, [5] SMs.
extern "C" int nsk_fused_helmholtz_geometry(int device, int dim, int n, int E, int C,
                                            int* info) {
  if ((dim != 2 && dim != 3) || C < 1 || C > nsk_helm::MAXC || E < 0 || n < 4 ||
      n > nsk_helm::MAXN)
    return (int)cudaErrorInvalidValue;
  return (int)nsk_helm::on_device(device, [&] {
    return dim == 2 ? nsk_helm::dispatch<2>(n, C, device, E, nullptr, nullptr, info)
                    : nsk_helm::dispatch<3>(n, C, device, E, nullptr, nullptr, info);
  });
}
