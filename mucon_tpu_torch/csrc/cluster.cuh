// Thread-block-cluster helpers for kernels that keep a weight matrix
// resident across the shared memory / registers of a few CTAs and exchange a
// small vector per step through distributed shared memory (sm_90).
//
//   cluster_rank()            this CTA's rank in its cluster (x dimension)
//   cluster_peer(ptr, rank)   the same shared-memory address in CTA `rank`
//   cluster_sync()            barrier over all threads of the cluster; remote
//                             writes made before it are visible after it
//                             (arrive.release + wait.acquire)
//   cluster_arrive(), cluster_wait()
//                             the same barrier split in two: work between
//                             them overlaps the peers' arrival
//   launch_cluster(...)       launch with a cluster of `width` CTAs along x
//   max_active_clusters(...)  how many clusters of that launch the card holds
//                             at once (a grid of more runs in waves)
//   width_for(H)              the widest of 8, 4, 2 CTAs that leaves each at
//                             least 16 of H units, else 1 (the recurrences'
//                             even split of a hidden size)
//   ragged_width(H)           8 CTAs from H = 64, 4 from 32, 2 from 16, else
//                             1 (a ragged split, where the even one does not
//                             fit a kernel)
//   units_of(rank, cl, H, ..) the units [j0, j0 + n) of CTA `rank` of a
//                             ragged split: ceil or floor of H / cl
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// A launch configuration with a cluster of `width` CTAs along x; `attr`
// must outlive it.  Raises the kernel's dynamic shared memory limit where
// smem is above the default 48 KiB.
template <typename... Params>
inline cudaError_t cluster_config(void (*kernel)(Params...), dim3 grid, dim3 block,
                                  unsigned width, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  *cfg = {};
  cfg->gridDim = grid;
  cfg->blockDim = block;
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = width;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  if (smem <= 48 * 1024) return cudaSuccess;  // within the default limit
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline int width_for(int H) {
  for (int c = 8; c > 1; c /= 2)
    if (H % c == 0 && H / c >= 16) return c;
  return 1;
}

inline int ragged_width(int H) { return H >= 64 ? 8 : (H >= 32 ? 4 : (H >= 16 ? 2 : 1)); }

__host__ __device__ inline void units_of(int rank, int cl, int H, int& j0, int& n) {
  j0 = rank * H / cl;
  n = (rank + 1) * H / cl - j0;
}

// grid.x must be a multiple of `width`; returns the launch's error
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 block,
                                  unsigned width, size_t smem, cudaStream_t stream,
                                  Args... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(kernel, grid, block, width, smem, stream, &attr, &cfg);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Clusters of this launch shape the card can hold at once, into *n
template <typename... Params>
inline cudaError_t max_active_clusters(void (*kernel)(Params...), dim3 grid, dim3 block,
                                       unsigned width, size_t smem, int* n) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(kernel, grid, block, width, smem, nullptr, &attr, &cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

}  // namespace cluster
