// Thread-block cluster helpers of the resident routes: csrc/scalar2.cu
// (kernels B1, B2, B4a, B4b), csrc/elastic.cu (kernel B3) and
// csrc/acoustic.cu (kernels B5, B6).  A resident kernel runs one cluster
// of C CTAs per shot on a grid of (C, ns); its plan comes from the Python
// side (ops/scalar2.py::resident_plan,
// ops/elastic_fused.py::elastic_resident_plan,
// ops/kernels.py::acoustic_resident_plan), and each source checks it
// before the launch.
#pragma once

#include <cuda_runtime.h>

#define RET_IF(expr)                    \
  do {                                  \
    cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)
#define LAUNCHED() RET_IF(cudaGetLastError())

namespace {

// The .aligned forms: every warp reaches each barrier converged (the
// loops around them have the same bounds in every thread).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// A resident launch plan: C CTAs of `threads` threads per shot, bands of
// R rows, a thread rpt rows, `smem` bytes of dynamic shared memory.
struct Plan {
  int C, R, rpt, threads, smem;
};

template <typename Args>
using ResKernel = void (*)(Args);

// The kernel's attributes for the plan: its dynamic shared memory and,
// for clusters of more than the portable 8 CTAs, the non-portable size.
template <typename Args>
cudaError_t prepare_resident(ResKernel<Args> kern, const Plan& p) {
  RET_IF(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              p.smem));
  if (p.C > 8)
    RET_IF(cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  return cudaSuccess;
}

// Grid (C, ns), clusters of (C, 1, 1), the plan's threads and shared memory.
template <typename Args>
cudaLaunchConfig_t cluster_config(const Plan& p, int ns, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C, ns);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Args>
cudaError_t launch_resident(ResKernel<Args> kern, const Args& a,
                            const Plan& p, int ns, cudaStream_t st) {
  RET_IF(prepare_resident(kern, p));
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<Args>(p, ns, st, &attr);
  RET_IF(cudaLaunchKernelEx(&cfg, kern, a));
  LAUNCHED();
  return cudaSuccess;
}

// How many clusters of the plan the card keeps resident at once, into *out.
template <typename Args>
cudaError_t max_active_clusters(ResKernel<Args> kern, const Plan& p, int ns,
                                int* out) {
  RET_IF(prepare_resident(kern, p));
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<Args>(p, ns, 0, &attr);
  return cudaOccupancyMaxActiveClusters(out, (const void*)kern, &cfg);
}

}  // namespace
