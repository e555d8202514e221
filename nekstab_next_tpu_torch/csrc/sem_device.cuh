// Device helpers shared by the two whole-solve CG kernels
// (fused_helmholtz_cg.cu, fused_pressure_cg.cu).
//
// * Block geometry: a block holds EPB element slots of TPE threads; thread t
//   of a slot owns node t of the slot's element (n*n <= 64, so n <= 8).
//   Blocks walk the element groups in a grid-stride loop whose trip count is
//   the same for every thread of a block, so __syncthreads() inside it is
//   legal.  A block that owns one group keeps its static operands in
//   registers for the whole solve; a block that owns several re-reads them
//   for every group.
// * gather: the direct-stiffness sum as a deterministic GATHER over a
//   per-local-node list of copies (the local indices of the node's global
//   node, increasing, padded with -1; built on the host), the first four of
//   which the thread holds in registers: one dependent load of w per copy,
//   all issued at once.  Replaces the TPU kernels' roll + 0/1-mask +
//   selector-matmul exchange (nekstab_next_tpu/ops/fused_cg.py _make_dssum
//   over ops/exchange.py ShiftExchange), which existed only because Pallas on
//   the TPU has no gather.  No float atomics: every copy of a global node
//   sums the same values in the same order, so copies come out bit-identical
//   and runs are reproducible; meshes that do not shift-decompose work too.
// * GridSync: a grid-wide barrier for the fully resident (cooperatively
//   launched) grid, one release add per block on an arrival counter and an
//   acquire spin.  grid_allreduce puts a dot product's block partials on the
//   barrier and sums them in a fixed order in every block (three
//   __syncthreads instead of six), so all blocks hold the same bits and take
//   the same early-exit branch without a host round trip.
//   tools_torch/grid_barrier_probe.py times it against cooperative_groups'
//   grid.sync(): at the flagship's 192 blocks on an H100, 1.25 against 1.39
//   us bare and 1.88 against 2.03 us with the all-reduce; the two are even
//   at 264 blocks (the kernels' grid on the 4,608-element test mesh) and
//   grid.sync() is the faster above that.
//
// Data written inside a kernel and read by other blocks after a barrier is
// loaded with __ldcg (L2, bypassing the non-coherent L1).
#pragma once

#include <cuda_runtime.h>

namespace nsk {

constexpr int TPE = 64;             // threads per element slot
constexpr int EPB = 4;              // element slots per block
constexpr int THREADS = TPE * EPB;  // threads per block
constexpr int WARPS = THREADS / 32;
constexpr int NCOPY = 4;            // copies of a node held in registers

// The copies of one local node: the first NCOPY in registers.
struct Copies {
  int k[NCOPY];

  __device__ __forceinline__ void load(const int* copies, size_t l, int M) {
#pragma unroll
    for (int q = 0; q < NCOPY; ++q) k[q] = q < M ? __ldg(copies + l * M + q) : -1;
  }
};

// Sum of the copies of local node l's global node, component c of a
// (nlocal, C)-interleaved vector w, in increasing local index.
__device__ __forceinline__ float gather(const float* w, const Copies& cp, const int* copies,
                                        size_t l, int M, int C, int c) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < NCOPY; ++q)
    if (cp.k[q] >= 0) s += __ldcg(w + (size_t)cp.k[q] * C + c);
  for (int q = NCOPY; q < M; ++q) {  // nodes shared by more than NCOPY elements
    const int k = __ldg(copies + l * M + q);
    if (k >= 0) s += __ldcg(w + (size_t)k * C + c);
  }
  return s;
}

// a / d for d > 0, else 0 (the CG breakdown guard of ops/cg.py).
__device__ __forceinline__ double sdiv(double a, double d) { return d > 0.0 ? a / d : 0.0; }

// ---- grid barrier -------------------------------------------------------
// bar counts arrivals from 0 (the wrapper zeroes it for every launch): every
// block adds 1 per barrier, so the k-th barrier is complete when bar reaches
// k * gridDim.x (and bar / gridDim.x counts the launch's barriers).  Thread 0
// arrives with a release reduction (no reply to wait for) and spins with
// acquire loads; a barrier that has not completed after 2 s traps instead of
// hanging the card.
struct GridSync {
  unsigned* bar;
  double* part;     // rows of gridDim.x block partials
  unsigned target;  // arrivals that complete the next barrier
};

__device__ __forceinline__ void arrive_and_wait(unsigned* bar, unsigned target) {
  unsigned v;
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (unsigned polls = 1;; ++polls) {
    asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
    if (v >= target) break;
    if ((polls & 1023u) == 0) {
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (t - t0 > 2000000000ull) __trap();
    }
  }
}

// Grid-wide barrier without a reduction.
__device__ __forceinline__ void grid_sync(GridSync& gs) {
  __syncthreads();
  gs.target += gridDim.x;
  if (threadIdx.x == 0) arrive_and_wait(gs.bar, gs.target);
  __syncthreads();
}

// Grid-wide barrier that also all-reduces K doubles: v holds this thread's
// shares on entry and the grid-wide sums, identical in every block, on exit.
// row: the first of K rows of gs.part.  red: shared scratch of 2 K WARPS
// doubles.  The summation tree is fixed: each warp's shares by a shuffle
// tree, the block's warps in order (thread 0 writes the block's partial
// before it arrives, so the partials ride on the barrier); then thread t of
// every block holds partials t, t + THREADS, ..., again a shuffle tree per
// warp and the warps in order.  Three __syncthreads in all.
template <int K>
__device__ __forceinline__ void grid_allreduce(GridSync& gs, int row, double (&v)[K],
                                               double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x;
  double* part = gs.part + (size_t)row * G;
#pragma unroll
  for (int q = 0; q < K; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_down_sync(0xffffffffu, v[q], o);
    if (lane == 0) red[q * WARPS + warp] = v[q];
  }
  __syncthreads();
  gs.target += G;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      double s = 0.0;
      for (int w = 0; w < WARPS; ++w) s += red[q * WARPS + w];
      part[q * G + blockIdx.x] = s;
    }
    arrive_and_wait(gs.bar, gs.target);
  }
  __syncthreads();
  double x[K];  // independent predicated loads, all in flight at once
#pragma unroll
  for (int q = 0; q < K; ++q) {
    x[q] = 0.0;
    if ((int)threadIdx.x < G) x[q] += __ldcg(part + q * G + threadIdx.x);
  }
  for (int b = threadIdx.x + THREADS; b < G; b += THREADS)
#pragma unroll
    for (int q = 0; q < K; ++q) x[q] += __ldcg(part + q * G + b);
#pragma unroll
  for (int q = 0; q < K; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x[q] += __shfl_down_sync(0xffffffffu, x[q], o);
    if (lane == 0) red[(K + q) * WARPS + warp] = x[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += red[(K + q) * WARPS + w];
    v[q] = s;
  }
}

// ---- launch -------------------------------------------------------------
// Sets `device` current for its lifetime, then restores the caller's.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev_);
    if (err == cudaSuccess && prev_ != device) {
      err = cudaSetDevice(device);
      set_ = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (set_) cudaSetDevice(prev_);
  }
  cudaError_t err;

 private:
  int prev_ = 0;
  bool set_ = false;
};

// The most blocks of `kernel` that fit on the current device at once with
// dyn_smem bytes of dynamic shared memory (0 when it does not fit).
template <typename Params>
inline cudaError_t resident_blocks(void (*kernel)(Params), size_t dyn_smem, int device,
                                   int* blocks) {
  int nsm = 0, per_sm = 0, optin = 0;
  *blocks = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (dyn_smem + fa.sharedSizeBytes > (size_t)optin) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn_smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, dyn_smem);
  *blocks = per_sm * nsm;
  return err;
}

// Cooperative launch on the current device: one block per EPB elements, at
// most as many blocks as fit on the card at once (the grid barrier needs
// them all resident).  info[0] receives the grid, info[1] the most blocks
// that fit.
template <typename Params>
inline cudaError_t launch_cooperative(void (*kernel)(Params), const Params& prm, int nelem,
                                      size_t dyn_smem, int device, cudaStream_t stream,
                                      int* info) {
  int coop = 0, cap = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (!coop) return cudaErrorNotSupported;
  cudaError_t err = resident_blocks(kernel, dyn_smem, device, &cap);
  if (err != cudaSuccess) return err;
  const int need = (nelem + EPB - 1) / EPB;
  const int grid = need < cap ? need : cap;
  info[0] = grid;
  info[1] = cap;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  Params p = prm;
  void* args[] = {(void*)&p};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args,
                                    dyn_smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace nsk
