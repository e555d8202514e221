// Cost of one grid-wide barrier, with and without a deterministic
// all-reduce of one double, in a persistent cooperative kernel of THREADS
// threads a block: cooperative_groups' grid.sync() against the arrive/wait
// barrier of nekstab_next_tpu_torch/csrc/sem_device.cuh.  Built and timed by
// grid_barrier_probe.py; not part of the package.
#include <cooperative_groups.h>

#include "sem_device.cuh"

namespace nsk {

namespace cg = cooperative_groups;

// The whole-solve kernels' reduction before this redesign: block_sum to one
// partial per block, grid.sync(), then every block sums all partials.
__device__ __forceinline__ double block_sum1(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// variant 0: grid.sync(); 1: arrive/wait; 2: block_sum + grid.sync() + every
// block sums the partials; 3: grid_allreduce<1>.
__global__ void __launch_bounds__(THREADS)
probe_kernel(int variant, int rounds, unsigned* bar, double* part, double* out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double red[2 * WARPS];
  GridSync gs{bar, part, 0u};
  double acc = 0.0;
  for (int k = 0; k < rounds; ++k) {
    double v = (double)(threadIdx.x + blockIdx.x) + (double)k;
    if (variant == 0) {
      grid.sync();
    } else if (variant == 1) {
      grid_sync(gs);
    } else if (variant == 2) {
      double* row = part + (k & 1) * gridDim.x;  // alternate rows: one barrier a round
      v = block_sum1(v, red);
      if (threadIdx.x == 0) row[blockIdx.x] = v;
      grid.sync();
      double s = 0.0;
      for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) s += __ldcg(row + b);
      acc += block_sum1(s, red);
    } else {
      double w[1] = {v};
      grid_allreduce<1>(gs, k & 1, w, red);
      acc += w[0];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = acc;
}

}  // namespace nsk

extern "C" int nsk_grid_barrier_probe(int device, int variant, int grid, int rounds,
                                      unsigned* bar, double* part, double* out,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&variant, &rounds, &bar, &part, &out};
  err = cudaLaunchCooperativeKernel((const void*)nsk::probe_kernel, dim3(grid),
                                    dim3(nsk::THREADS), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int nsk_grid_barrier_probe_resident(int device) {
  int nsm = 0, per_sm = 0;
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nsk::probe_kernel, nsk::THREADS, 0);
  return nsm * per_sm;
}
