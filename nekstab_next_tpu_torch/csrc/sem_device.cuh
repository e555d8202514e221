// Device helpers shared by the two whole-solve CG kernels
// (fused_helmholtz_cg.cu, fused_pressure_cg.cu).
//
// * Block geometry: a block holds EPB element slots of TPE threads; thread t
//   of a slot owns node t of the slot's element (n*n <= 64, so n <= 8).
//   Blocks walk the elements in a grid-stride loop whose trip count is the
//   same for every thread of a block, so __syncthreads() inside it is legal.
// * gs_sum: the direct-stiffness sum as a deterministic GATHER over the
//   node->copies table (CSR: gs_off over global nodes, gs_idx the copies in
//   increasing local index).  Replaces the TPU kernels' roll + 0/1-mask +
//   selector-matmul exchange (nekstab_next_tpu/ops/fused_cg.py _make_dssum
//   over ops/exchange.py ShiftExchange), which existed only because Pallas on
//   the TPU has no gather.  No float atomics: every copy of a global node
//   sums the same values in the same order, so copies come out bit-identical
//   and runs are reproducible; meshes that do not shift-decompose work too.
// * block_sum / grid_sum: deterministic reductions.  A dot product writes
//   one partial per block; after a grid sync EVERY block sums all partials in
//   the same fixed order, so all blocks hold the same bits and take the same
//   early-exit branch without a host round trip.
//
// Data written inside a kernel and read by other blocks after a grid sync is
// loaded with __ldcg (L2, bypassing the non-coherent L1).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace nsk {

namespace cg = cooperative_groups;

constexpr int TPE = 64;             // threads per element slot
constexpr int EPB = 4;              // element slots per block
constexpr int THREADS = TPE * EPB;  // threads per block
constexpr int WARPS = THREADS / 32;

// Sum of the copies of local node l's global node, component c of a
// (nlocal, C)-interleaved vector w.
__device__ __forceinline__ float gs_sum(const float* w, const int* __restrict__ gid,
                                        const int* __restrict__ gs_off,
                                        const int* __restrict__ gs_idx, int l, int C,
                                        int c) {
  const int g = __ldg(gid + l);
  const int k1 = __ldg(gs_off + g + 1);
  float s = 0.f;
  for (int k = __ldg(gs_off + g); k < k1; ++k)
    s += __ldcg(w + (size_t)__ldg(gs_idx + k) * C + c);
  return s;
}

// Block-wide sum of K doubles; every thread receives the same result.
// red: shared scratch of K * WARPS doubles.
template <int K>
__device__ __forceinline__ void block_sum(double (&v)[K], double* red) {
#pragma unroll
  for (int q = 0; q < K; ++q)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_down_sync(0xffffffffu, v[q], o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < K; ++q) red[q * WARPS + warp] = v[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += red[q * WARPS + w];
    v[q] = s;
  }
}

// Reduce this block's K partial sums and store them at part[q * G + block].
template <int K>
__device__ __forceinline__ void block_partials(double (&v)[K], double* part, double* red) {
  block_sum<K>(v, red);
  if (threadIdx.x == 0)
#pragma unroll
    for (int q = 0; q < K; ++q) part[q * gridDim.x + blockIdx.x] = v[q];
}

// After a grid sync: the grid-wide sums of the K partial rows part[q * G + b],
// identical in every block.
template <int K>
__device__ __forceinline__ void grid_sum(const double* part, double (&out)[K], double* red) {
  const int G = gridDim.x;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    out[q] = 0.0;
    for (int b = threadIdx.x; b < G; b += THREADS) out[q] += __ldcg(part + q * G + b);
  }
  block_sum<K>(out, red);
}

// a / d for d > 0, else 0 (the CG breakdown guard of ops/cg.py).
__device__ __forceinline__ double sdiv(double a, double d) { return d > 0.0 ? a / d : 0.0; }

// Cooperative launch on the current device: one block per EPB elements, at
// most as many blocks as fit on the card at once (grid sync needs them all
// resident).
template <typename Params>
inline cudaError_t launch_on_device(void (*kernel)(Params), const Params& prm, int nelem,
                                    size_t dyn_smem, int device, cudaStream_t stream) {
  cudaError_t err;
  int coop = 0, nsm = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  if (!coop) return cudaErrorNotSupported;
  if (dyn_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn_smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, dyn_smem);
  if (err != cudaSuccess) return err;
  const int need = (nelem + EPB - 1) / EPB;
  const int grid = need < per_sm * nsm ? need : per_sm * nsm;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  Params p = prm;
  void* args[] = {(void*)&p};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args,
                                    dyn_smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Cooperative launch of a persistent kernel on `device`, leaving the
// caller's current device as it was.  Returns the CUDA error code (0 on
// success).
template <typename Params>
inline cudaError_t launch_cooperative(void (*kernel)(Params), const Params& prm, int nelem,
                                      size_t dyn_smem, int device, cudaStream_t stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  err = launch_on_device(kernel, prm, nelem, dyn_smem, device, stream);
  if (prev != device) {
    const cudaError_t reset = cudaSetDevice(prev);
    if (err == cudaSuccess) err = reset;
  }
  return err;
}

}  // namespace nsk
