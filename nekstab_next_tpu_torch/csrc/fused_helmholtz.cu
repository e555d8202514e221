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
// What bounds it on Hopper: device memory.  At the 3-D cube's shape (1,472
// elements, n = 7, C = 3) it must read u (6.06 MB) and seven metric/mass
// fields (14.1 MB) and write out (6.06 MB): 26.3 MB, 7.8 us at 3.35 TB/s,
// against ~52 MFLOP per component (under 3 us at 67 TFLOP/s in f32).  At the
// 2-D flagship (768 elements, n = 7, C = 2) it moves ~0.9 MB: launch-bound.
//
// Design: the TPU kernel multiplied dense (n^d x n^d) Kronecker matrices on
// the MXU (343 MACs a node per derivative at n = 7 in 3-D); here each
// derivative is a sum-factorised n-term contraction (7 MACs a node and
// direction).  One element slot of TPE threads per element, thread t owning
// node t; 3-D takes one element per block (343 of 352 threads at n = 7), 2-D
// several (4 x 64 threads).  The block stages its elements' u, all
// components, into shared memory with coalesced loads; each thread loads its
// node's metric factors and mass ONCE into registers and reuses them for
// every component.  Per component: the reference derivatives, the metric
// combination into shared memory, a barrier, the transposed contractions,
// and the result written back over u in shared memory (each component's u is
// last read before that barrier); a final coalesced store writes out.  D
// sits in shared memory.  Simple first: no TMA, no multi-element pipelining.
#include <cuda_runtime.h>

namespace nsk_helm {

constexpr int MAXC = 3;  // components per launch (the velocity's 2 or 3)

template <int DIM, int N>
struct Geo {
  static constexpr int NN = DIM == 2 ? N * N : N * N * N;  // nodes per element
  static constexpr int TPE = (NN + 31) / 32 * 32;           // threads per element slot
  static constexpr int EPB = TPE >= 256 ? 1 : 256 / TPE;    // element slots per block
  static constexpr int THREADS = TPE * EPB;
  static constexpr int NMET = DIM == 2 ? 3 : 6;
};

struct Args {
  int E, C;
  float h1, h2;
  const float* u;
  float* out;
  const float* D;    // (N, N), row-major: D[i * N + q] = dphi_q/dxi at node i
  const float* g[6]; // metrics, (E, NN) each: 2-D g11 g12 g22; 3-D g11 g22 g33 g12 g13 g23
  const float* bm;   // (E, NN)
};

// (the extra parentheses keep the template's comma out of the macro's arguments)
template <int DIM, int N>
__global__ void __launch_bounds__((Geo<DIM, N>::THREADS))
helmholtz_local_kernel(const Args A) {
  using G = Geo<DIM, N>;
  constexpr int NN = G::NN, TPE = G::TPE, EPB = G::EPB;
  __shared__ float sD[N * N];
  __shared__ float su[EPB * NN * MAXC];  // the block's elements, as in memory
  __shared__ float sw[DIM][EPB * NN];    // metric-weighted reference derivatives

  const int slot = threadIdx.x / TPE, t = threadIdx.x % TPE;
  const int e0 = blockIdx.x * EPB;
  const int ne = min(EPB, A.E - e0);
  const int C = A.C;
  const bool act = t < NN && slot < ne;

  for (int k = threadIdx.x; k < N * N; k += blockDim.x) sD[k] = __ldg(A.D + k);
  const int nval = ne * NN * C;
  const float* ub = A.u + (size_t)e0 * NN * C;
  for (int k = threadIdx.x; k < nval; k += blockDim.x) su[k] = __ldg(ub + k);

  // this node's metric factors and mass, shared by every component
  float g[G::NMET];
  float b = 0.f;
  if (act) {
    const size_t gi = (size_t)(e0 + slot) * NN + t;
#pragma unroll
    for (int m = 0; m < G::NMET; ++m) g[m] = __ldg(A.g[m] + gi);
    b = __ldg(A.bm + gi);
  }
  __syncthreads();

  // node coordinates: 2-D t = i*N + j; 3-D t = (i*N + j)*N + k
  const int i = DIM == 2 ? t / N : t / (N * N);
  const int j = DIM == 2 ? t % N : (t / N) % N;
  const int k = DIM == 2 ? 0 : t % N;
  constexpr int SI = DIM == 2 ? N : N * N;  // node stride of i
  constexpr int SJ = DIM == 2 ? 1 : N;      // node stride of j
  const float* ue = su + slot * NN * C;
  float* w0 = sw[0] + slot * NN;
  float* w1 = sw[1] + slot * NN;
  float* w2 = sw[DIM - 1] + slot * NN;

  for (int c = 0; c < C; ++c) {
    float uv = 0.f;
    if (act) {
      // reference derivatives: u_r = sum_q D[i,q] u[q,j,k], likewise s, t
      float ur = 0.f, us = 0.f, ut = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q) {
        ur += sD[i * N + q] * ue[(q * SI + j * SJ + k) * C + c];
        us += sD[j * N + q] * ue[(i * SI + q * SJ + k) * C + c];
        if constexpr (DIM == 3) ut += sD[k * N + q] * ue[(i * SI + j * SJ + q) * C + c];
      }
      uv = ue[t * C + c];
      if constexpr (DIM == 2) {
        w0[t] = g[0] * ur + g[1] * us;
        w1[t] = g[1] * ur + g[2] * us;
      } else {
        w0[t] = g[0] * ur + g[3] * us + g[4] * ut;
        w1[t] = g[3] * ur + g[1] * us + g[5] * ut;
        w2[t] = g[4] * ur + g[5] * us + g[2] * ut;
      }
    }
    __syncthreads();  // w complete; component c of u is read no more
    if (act) {
      // transposed contractions: K u = sum_q D[q,i] w_r[q,j,k] + ...
      float ku = 0.f;
#pragma unroll
      for (int q = 0; q < N; ++q) {
        ku += sD[q * N + i] * w0[q * SI + j * SJ + k];
        ku += sD[q * N + j] * w1[i * SI + q * SJ + k];
        if constexpr (DIM == 3) ku += sD[q * N + k] * w2[i * SI + j * SJ + q];
      }
      su[(slot * NN + t) * C + c] = A.h1 * ku + A.h2 * b * uv;
    }
    __syncthreads();  // sw is rewritten by the next component
  }

  float* ob = A.out + (size_t)e0 * NN * C;
  for (int q = threadIdx.x; q < nval; q += blockDim.x) ob[q] = su[q];
}

template <int DIM, int N>
static cudaError_t launch(const Args& A, cudaStream_t stream) {
  using G = Geo<DIM, N>;
  const int grid = (A.E + G::EPB - 1) / G::EPB;
  helmholtz_local_kernel<DIM, N><<<grid, G::THREADS, 0, stream>>>(A);
  return cudaGetLastError();
}

template <int DIM>
static cudaError_t launch_n(int n, const Args& A, cudaStream_t stream) {
  switch (n) {
    case 4: return launch<DIM, 4>(A, stream);
    case 5: return launch<DIM, 5>(A, stream);
    case 6: return launch<DIM, 6>(A, stream);
    case 7: return launch<DIM, 7>(A, stream);
    case 8: return launch<DIM, 8>(A, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace nsk_helm

// Launch on `device` and `stream`, leaving the caller's current device as it
// was.  Returns the CUDA error code of the launch (0 on success); a launch
// that is refused never runs.
extern "C" int nsk_fused_helmholtz(int device, int dim, int n, int E, int C, float h1,
                                   float h2, const float* u, float* out, const float* D,
                                   const float* g0, const float* g1, const float* g2,
                                   const float* g3, const float* g4, const float* g5,
                                   const float* bm, void* stream) {
  if ((dim != 2 && dim != 3) || C < 1 || C > nsk_helm::MAXC || E < 0)
    return (int)cudaErrorInvalidValue;
  if (E == 0) return 0;
  nsk_helm::Args A;
  A.E = E; A.C = C; A.h1 = h1; A.h2 = h2;
  A.u = u; A.out = out; A.D = D; A.bm = bm;
  A.g[0] = g0; A.g[1] = g1; A.g[2] = g2; A.g[3] = g3; A.g[4] = g4; A.g[5] = g5;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  err = dim == 2 ? nsk_helm::launch_n<2>(n, A, st) : nsk_helm::launch_n<3>(n, A, st);
  if (prev != device) {
    const cudaError_t reset = cudaSetDevice(prev);
    if (err == cudaSuccess) err = reset;
  }
  return (int)err;
}
