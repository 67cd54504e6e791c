// Thread-block-cluster helpers for kernels that keep a weight matrix
// resident across the shared memory / registers of a few CTAs and exchange a
// small vector per step through distributed shared memory (sm_90).
//
//   cluster_rank()            this CTA's rank in its cluster (x dimension)
//   cluster_peer(ptr, rank)   the same shared-memory address in CTA `rank`
//   cluster_sync()            barrier over all threads of the cluster; remote
//                             writes made before it are visible after it
//                             (arrive.release + wait.acquire)
//   launch_cluster(...)       launch with a cluster of `width` CTAs along x
//
// Rules a caller keeps: a remote write is read only after a cluster_sync();
// no CTA exits while a peer may still write to it (sync once after the last
// step); every CTA of a cluster must fit co-resident on one GPC, so a launch
// can fail with cudaErrorLaunchOutOfResources: the error is returned, never
// worked around.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cluster {

__device__ __forceinline__ unsigned cluster_rank() {
  return cooperative_groups::this_cluster().block_rank();
}

template <typename T>
__device__ __forceinline__ T* cluster_peer(T* smem, unsigned rank) {
  return cooperative_groups::this_cluster().map_shared_rank(smem, rank);
}

__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }

// grid.x must be a multiple of `width`; returns the launch's error
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 block,
                                  unsigned width, size_t smem, cudaStream_t stream,
                                  Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = width;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace cluster
