// Thread-block clusters for K1 (scan_forward.cuh) and K4 (scan_backward.cu):
// one trajectory row on a cluster of C CTAs, each CTA owning a contiguous
// slice of K/C particles, the slices joined through distributed shared
// memory (DSMEM). Here: the launch of B·C CTAs in clusters of C, and the
// occupancy query from which fused_step.cluster_size picks C.
//
// C is a runtime argument (cudaLaunchAttributeClusterDimension, not
// __cluster_dims__), so one instantiation serves every C; C = 1 is a
// cluster of one CTA, the one-CTA-per-row design, run by the same code.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "resample.cuh"

namespace psvo {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // the portable cluster size

inline cudaLaunchConfig_t cluster_config(int ctas, int cluster, size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// rows clusters of `cluster` CTAs each (grid = rows·cluster), kThreads
// threads and `smem` bytes of dynamic shared memory per CTA.
template <class Args>
cudaError_t launch_clusters(void (*kernel)(Args), const Args& a, int rows, int cluster,
                            size_t smem, cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(rows * cluster, cluster, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `cluster` CTAs with `smem` bytes each can be resident
// at once: a cluster needs its C SMs in one GPC, and the GPCs differ in size,
// so this is not the SM count over C.
template <class Args>
cudaError_t max_active_clusters(void (*kernel)(Args), int cluster, size_t smem, int* out) {
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster * 32, cluster, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// K4's query, defined in scan_backward.cu (psvo_max_active_clusters, in
// scan_forward.cu, serves both kernels).
int scan_backward_max_active(int dx, int dy, int hidden, int cluster, int smem, int* out);

}  // namespace psvo
