// Forward-only elastic kernel for Hopper (sm_90a): the whole time loop in
// one launch.
//
// Replaces the Pallas TPU kernel of the JAX package
//   B8  b8_elastic_forward  <- physicsbasedfwi2_tpu/ops/pallas_elastic.py
//                              elastic_forward_pallas / _el_kernel
//
// Scheme: the 5-field Virieux P-SV velocity-stress update with a
// multiplicative Kosloff sponge `damp` that also zeroes a 2-cell ring,
// absorbing on every side (the Pallas kernel refuses a free surface), and
// 4th-order staggered derivatives in grid units (csrc/elastic.cu has them):
//     vx' = damp (vx + dtx bx (Dxf sxx + Dzb sxz))
//     vz' = damp (vz + dtx bz (Dxb sxz + Dzf szz))
//     sxx' = damp (sxx + dtx (l2m Dxb vx' + lam Dzb vz')) + s_t
//     szz' = damp (szz + dtx (lam Dxb vx' + l2m Dzb vz')) + s_t
//     sxz' = damp (sxz + dtx muxz (Dxf vz' + Dzf vx'))
// with s_t = wav_t gain at the source cell; the receiver rows of vx', vz'
// are recorded every step.  It is the function of csrc/elastic.cu's ring
// forward (b3_elastic_ring) without a free-surface row.
//
// Design.  The Pallas kernel keeps one shot's five fields on chip and runs
// the whole time loop in one program per shot.  The fields of one shot
// (5 x 144 x 384 floats, 1.1 MB at marmousi_elastic's shape) do not fit in
// the 227 KB of shared memory a block has, so here the time loop moves
// into one persistent cooperative launch over all shots: as many blocks as
// can be resident at once (occupancy x SMs), threads striding over the
// [ns, nz, nx] cells with the fields in global memory (39 MB for 35
// shots, inside the 50 MB L2), and a grid-wide barrier after each of the
// step's two phases:
//   V  reads the stress neighbours, writes its own vx, vz and the
//      receiver rows;
//   S  reads the new velocity neighbours, writes its own sxx, szz, sxz.
// No phase reads a value that it writes, so the state is updated in place
// without double buffering, the hazard argument of csrc/elastic.cu.  No
// atomics.  A card that refuses the cooperative launch makes the call
// fail; nothing falls back to per-step launches.
//
// What bounds it on the H100: 68 flops per cell-step, 3.8e11 flop for 35
// shots at nt 3334 (5.6 ms at 67 TFLOP/s); its inputs and outputs are
// ~0.36 GB (0.1 ms).  Each step moves the whole state through L2 (~55 MB
// read and ~40 MB written over the two phases).  b3_elastic_ring runs the
// same steps as 6,668 launches at 2 per step.  Prediction before the first
// chip run: the ring forward costs ~39 us per step, of which the launch
// gaps are ~3 us, so removing the launches saves at most ~10 %, and the
// 6,668 grid barriers (~1-2 us each with ~1,000 resident blocks) take
// part of that back: B8 within 15 % of the ring forward on the same inputs
// (~130-150 ms for 35 shots), bound by the state's L2 traffic, ~25x its
// operation bound.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), 35 shots with
// an absorbing top: 172 ms in one launch of 792 blocks against the ring
// forward's 167 ms in 6,668 launches, traces bit-equal.  The launches
// were not what bounds the ring forward: each phase's work is.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr float kC1 = 9.0f / 8.0f;
constexpr float kC2 = -1.0f / 24.0f;
enum { VX = 0, VZ, SXX, SZZ, SXZ };     // state fields
enum { LAM = 0, L2M, MUXZ, BXX, BZZ };  // media

struct Dims {
  int ns, nz, nx;
  long long F;  // nz * nx
};

__device__ __forceinline__ float ld0(const float* f, int i, int j,
                                     const Dims& d) {
  return (i >= 0 && i < d.nz && j >= 0 && j < d.nx) ? f[i * d.nx + j]
                                                     : 0.0f;
}

// staggered derivatives, in csrc/elastic.cu's order
__device__ __forceinline__ float dxf(const float* f, int i, int j,
                                     const Dims& d) {
  return kC1 * (ld0(f, i, j + 1, d) - ld0(f, i, j, d)) +
         kC2 * (ld0(f, i, j + 2, d) - ld0(f, i, j - 1, d));
}
__device__ __forceinline__ float dxb(const float* f, int i, int j,
                                     const Dims& d) {
  return kC1 * (ld0(f, i, j, d) - ld0(f, i, j - 1, d)) +
         kC2 * (ld0(f, i, j + 1, d) - ld0(f, i, j - 2, d));
}
__device__ __forceinline__ float dzf(const float* f, int i, int j,
                                     const Dims& d) {
  return kC1 * (ld0(f, i + 1, j, d) - ld0(f, i, j, d)) +
         kC2 * (ld0(f, i + 2, j, d) - ld0(f, i - 1, j, d));
}
__device__ __forceinline__ float dzb(const float* f, int i, int j,
                                     const Dims& d) {
  return kC1 * (ld0(f, i, j, d) - ld0(f, i - 1, j, d)) +
         kC2 * (ld0(f, i + 1, j, d) - ld0(f, i - 2, j, d));
}

struct Args {
  const float* med;    // [5, nz, nx] lam, l2m, muxz, bx, bz
  const float* damp;   // [nz, nx]
  const float* wav;    // [ns, nt_wav]
  const int* src_z;
  const int* src_x;
  const int* rcv_row;
  const float* gain;   // [ns] dt/dx^2 l2m[src]
  float* state;        // [ns, 5, nz, nx], zero on entry
  float* hist;         // [2, ns, nt, nx]
  Dims d;
  int nt, nt_wav;
  float dtx;
};

// The state is written during the launch, so it is read with plain
// (coherent) loads; only the media, damp and geometry are read-only.
__global__ void __launch_bounds__(kThreads) el_forward(Args a) {
  cg::grid_group grid = cg::this_grid();
  const Dims d = a.d;
  const long long F = d.F;
  // 32-bit cell index and divisions (b8_elastic_forward checks that
  // ns nz nx < 2^31)
  const int fi = (int)F;
  const int cells = d.ns * fi;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const float* __restrict__ med = a.med;
  const float* __restrict__ damp = a.damp;
  for (int t = 0; t < a.nt; ++t) {
    // phase V
    for (int q = first; q < cells; q += stride) {
      const int s = q / fi;
      const int idx = q - s * fi;
      const int i = idx / d.nx;
      const int j = idx - i * d.nx;
      float* st = a.state + s * 5 * F;
      const float* sxx = st + SXX * F;
      const float* szz = st + SZZ * F;
      const float* sxz = st + SXZ * F;
      const float dm = damp[idx];
      const float t1 = dxf(sxx, i, j, d) + dzb(sxz, i, j, d);
      const float vx =
          dm * (st[VX * F + idx] + a.dtx * med[BXX * F + idx] * t1);
      const float t2 = dxb(sxz, i, j, d) + dzf(szz, i, j, d);
      const float vz =
          dm * (st[VZ * F + idx] + a.dtx * med[BZZ * F + idx] * t2);
      st[VX * F + idx] = vx;
      st[VZ * F + idx] = vz;
      if (i == a.rcv_row[s]) {
        const long long r = ((long long)s * a.nt + t) * d.nx + j;
        a.hist[r] = vx;
        a.hist[(long long)d.ns * a.nt * d.nx + r] = vz;
      }
    }
    grid.sync();
    // phase S
    for (int q = first; q < cells; q += stride) {
      const int s = q / fi;
      const int idx = q - s * fi;
      const int i = idx / d.nx;
      const int j = idx - i * d.nx;
      float* st = a.state + s * 5 * F;
      const float* vx = st + VX * F;
      const float* vz = st + VZ * F;
      const float lam = med[LAM * F + idx];
      const float l2m = med[L2M * F + idx];
      const float dm = damp[idx];
      const float da = dxb(vx, i, j, d);
      const float db = dzb(vz, i, j, d);
      float sxx = dm * (st[SXX * F + idx] + a.dtx * (l2m * da + lam * db));
      float szz = dm * (st[SZZ * F + idx] + a.dtx * (lam * da + l2m * db));
      if (i == a.src_z[s] && j == a.src_x[s]) {
        const float amp = a.wav[(long long)s * a.nt_wav + t] * a.gain[s];
        sxx += amp;
        szz += amp;
      }
      const float cc = dxf(vz, i, j, d) + dzf(vx, i, j, d);
      const float sxz =
          dm * (st[SXZ * F + idx] + a.dtx * med[MUXZ * F + idx] * cc);
      st[SXX * F + idx] = sxx;
      st[SZZ * F + idx] = szz;
      st[SXZ * F + idx] = sxz;
    }
    grid.sync();
  }
}

}  // namespace

#define RET_IF(expr)                    \
  do {                                  \
    cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)

extern "C" {

// B8: elastic_forward_pallas.  med [5, nz, nx]; damp [nz, nx]; wav
// [ns, nt_wav]; gain [ns]; state [ns, 5, nz, nx] scratch; hist
// [2, ns, nt, nx] receives the receiver rows of vx and vz every step.
// One cooperative launch; *blocks_out gets its grid size.
int b8_elastic_forward(const float* med, const float* damp, const float* wav,
                       const int* src_z, const int* src_x,
                       const int* rcv_row, const float* gain, float* state,
                       float* hist, int* blocks_out, int ns, int nz, int nx,
                       int nt, int nt_wav, float dtx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  RET_IF(cudaGetDevice(&dev));
  RET_IF(cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev));
  if (!coop) return cudaErrorNotSupported;
  RET_IF(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  RET_IF(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, el_forward,
                                                       kThreads, 0));
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const Dims d{ns, nz, nx, (long long)nz * nx};
  if (ns * d.F >= (1LL << 31)) return cudaErrorInvalidValue;
  RET_IF(cudaMemsetAsync(state, 0, sizeof(float) * 5 * (size_t)ns * d.F, st));
  const long long blocks_needed = (ns * d.F + kThreads - 1) / kThreads;
  const int blocks =
      (int)(blocks_needed < (long long)per_sm * sms ? blocks_needed
                                                    : (long long)per_sm * sms);
  Args a{med, damp, wav, src_z, src_x, rcv_row, gain, state, hist, d, nt,
         nt_wav, dtx};
  void* params[] = {&a};
  RET_IF(cudaLaunchCooperativeKernel((const void*)el_forward, dim3(blocks),
                                     dim3(kThreads), params, 0, st));
  *blocks_out = blocks;
  return cudaSuccess;
}

}  // extern "C"
