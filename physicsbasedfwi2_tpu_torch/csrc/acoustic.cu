// First-order (velocity-pressure) acoustic propagator kernels for Hopper
// (sm_90a): the forward and the exact transpose of the differentiable
// acoustic_pallas propagator.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   B5  b5_acoustic_forward   <- physicsbasedfwi2_tpu/ops/pallas_kernels.py
//                                acoustic_forward_pallas / _forward_kernel
//   B6  b6_acoustic_backward  <- physicsbasedfwi2_tpu/ops/pallas_adjoint.py
//                                _pallas_backward / _bwd_kernel
//
// Scheme: 4 split fields (vx, vz, px, pz), 4th-order staggered derivatives
// in grid units,
//     Dxf(f)[j] = C1 (f[j+1] - f[j]) + C2 (f[j+2] - f[j-1]),
//     Dxb(f)[j] = C1 (f[j] - f[j-1]) + C2 (f[j+1] - f[j-2]),
// Dzf/Dzb the same along rows, split-PML decay factors multiplied by a
// 2-cell zero ring, a = dt/dx and kap = vp^2 dt/dx:
//     p = px + pz
//     vx = ax_v (vx + a Dxf(p)),   vz = az_v (vz + a Dzf(p))
//     px = ax_p (px + kap Dxb(vx)), pz = az_p (pz + kap Dzb(vz)) + src_amp_t
//     y_t = (px + pz)[rcv_row]
// The source amplitude src_amp[s, t] = wav[s, t] * gain[s] comes from the
// wrapper (B5: kappa_dt[src] / dx^2; B6: kap[src] / dx, as each Pallas
// kernel computes it).  Exact transpose of one step (pallas_adjoint.py
// header), with (avx, avz, apx, apz) the cotangents:
//     apx += S^T ybar_t, apz += S^T ybar_t
//     gk[src] += (wav_t / dx) apz[src]
//     wx = ax_p apx, wz = az_p apz;  gk += wx Dxb(vx1) + wz Dzb(vz1)
//     vbx = avx - Dxf(kap wx),  vbz = avz - Dzf(kap wz)
//     avx = ax_v vbx,  avz = az_v vbz
//     pb0 = -a (Dxb(avx) + Dzb(avz));  apx = wx + pb0,  apz = wz + pb0
// and gk (dJ/dkap) goes through the chain rule and the edge-pad transpose
// on the host.
//
// Design.  As csrc/scalar2.cu and csrc/elastic.cu: the Pallas kernels keep
// one shot's whole state in VMEM (B6: 9 fields plus a 2 x 16-step cache,
// about 7 MB at the flagship shape), far beyond the 227 KB of shared
// memory a block has, so every phase of a time step is one launch over all
// shots, one thread per cell of [ns, nz8, nx128], with the state in global
// memory; at the flagship shape (18 shots, 192 x 256) a field for all
// shots is 3.5 MB, so the 4 live fields and the 5 coefficient planes stay
// in the 50 MB L2.  The time loop runs inside one C call.  Each step is two
// phases whose reads and writes do not overlap, so the state updates in
// place without double buffering:
//   forward  V: reads the neighbours of px, pz; writes its own vx, vz;
//            P: reads the neighbours of the new vx, vz; writes its own
//               px, pz (and, in B6's recompute, the Dxb(vx), Dzb(vz) cache);
//   adjoint  A: reads the neighbours of apx, apz (plus ybar on the receiver
//               row); writes its own avx, avz and gk, never ap*;
//            B: reads the neighbours of the new avx, avz; recomputes its own
//               wx, wz from ap* (plus ybar) and writes its own apx, apz.
// B6 runs its own checkpointed forward sweep (checkpoints of the 4 fields
// every K = 16 steps, [ns, n_ck, 4, F]), as the Pallas kernel does: the
// autograd forward saves only its inputs, so B5 stays a plain forward.
// Then per chunk, last first: restore, recompute K steps caching Dxb(vx),
// Dzb(vz), run K adjoint steps.
//
// Boundaries: Pallas rolls circularly; the zero ring keeps every forward
// field, and every cotangent product that is read at a neighbour (kap wx,
// kap wz, avx, avz), zero within 2 cells of the array edge, so reading 0
// outside the array gives the same values.
//
// Determinism: no atomics.  dJ/dkap is accumulated per shot and summed
// over shots in order.
//
// What bounds it on the H100 (PERF.md has the arithmetic): per padded cell
// and step the scheme needs 33 flop forward and 36 adjoint, so at the
// flagship shape (18 x 191 x 240 cells, nt 4001) B5 needs 1.09e11 flop
// (1.63 ms at 67 TFLOP/s float32) and B6 2.28e11 (3.40 ms); inputs and
// outputs are under 0.1 GB (< 0.03 ms at 3.35 TB/s): compute-bound.  This
// is the simple version: B5 takes 2 launches per step (8 k per call), B6 6
// per step (its forward sweep, the recompute and the adjoint: 24 k).
// Prediction, written before the first run on the card: at the 7-10 us per
// step that B1-B3 cost (about 1.5 us of launch gap each), B5 ~60-80 ms and
// B6 ~200-250 ms per call, bound by launches and per-step L2 traffic,
// 40-60x above the compute bound.

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr float kC1 = (float)(9.0 / 8.0);
constexpr float kC2 = (float)(-1.0 / 24.0);

__device__ __forceinline__ float ld0(const float* f, int i, int j, int nz,
                                     int nx) {
  return (i >= 0 && i < nz && j >= 0 && j < nx) ? f[i * nx + j] : 0.0f;
}

// The state of one shot: 4 fields of F cells each.
struct Fields {
  float* a;  // vx (forward) / avx (adjoint)
  float* b;  // vz / avz
  float* c;  // px / apx
  float* d;  // pz / apz
};

__device__ __forceinline__ Fields fields_of(float* st, int s, long long F) {
  float* base = st + (long long)s * 4 * F;
  return Fields{base, base + F, base + 2 * F, base + 3 * F};
}

__device__ __forceinline__ float p_at(const Fields& f, int i, int j, int nz,
                                      int nx) {
  if (i < 0 || i >= nz || j < 0 || j >= nx) return 0.0f;
  const int q = i * nx + j;
  return f.c[q] + f.d[q];
}

// Forward phase V for every shot: vx, vz from the neighbours of p.
// ckpt (optional) receives the 4 fields before the step, shot stride
// ck_stride.
__global__ void fwd_vel(const float* __restrict__ axv,
                        const float* __restrict__ azv, float* st, float a,
                        float* __restrict__ ckpt, long long ck_stride, int nz,
                        int nx) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  const int s = blockIdx.z;
  if (i >= nz || j >= nx) return;
  const long long F = (long long)nz * nx;
  const int idx = i * nx + j;
  const Fields f = fields_of(st, s, F);
  const float vx = f.a[idx], vz = f.b[idx];
  if (ckpt) {
    float* ck = ckpt + s * ck_stride;
    ck[idx] = vx;
    ck[F + idx] = vz;
    ck[2 * F + idx] = f.c[idx];
    ck[3 * F + idx] = f.d[idx];
  }
  const float p0 = p_at(f, i, j, nz, nx);
  const float dxf = kC1 * (p_at(f, i, j + 1, nz, nx) - p0) +
                    kC2 * (p_at(f, i, j + 2, nz, nx) - p_at(f, i, j - 1, nz, nx));
  const float dzf = kC1 * (p_at(f, i + 1, j, nz, nx) - p0) +
                    kC2 * (p_at(f, i + 2, j, nz, nx) - p_at(f, i - 1, j, nz, nx));
  f.a[idx] = axv[idx] * (vx + a * dxf);
  f.b[idx] = azv[idx] * (vz + a * dzf);
}

struct Src {
  const int* src_z;
  const int* src_x;
  const int* rcv_row;
  const float* amp;  // [ns, nt_amp]: wavelet times the source gain
  int nt_amp;
};

// Forward phase P for every shot at time t: px, pz from the neighbours of
// the new vx, vz, the source added to pz after the damping.
//   hist (optional) row t of [ns, nt_rows, nx] receives px + pz of rcv_row;
//   dxv, dzv (optional) receive Dxb(vx), Dzb(vz), shot stride cache_stride.
__global__ void fwd_pres(const float* __restrict__ kap,
                         const float* __restrict__ axp,
                         const float* __restrict__ azp, float* st, Src src,
                         int t, float* __restrict__ hist, int nt_rows,
                         float* __restrict__ dxv, float* __restrict__ dzv,
                         long long cache_stride, int nz, int nx) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  const int s = blockIdx.z;
  if (i >= nz || j >= nx) return;
  const long long F = (long long)nz * nx;
  const int idx = i * nx + j;
  const Fields f = fields_of(st, s, F);
  const float vx0 = f.a[idx], vz0 = f.b[idx];
  const float dxb = kC1 * (vx0 - ld0(f.a, i, j - 1, nz, nx)) +
                    kC2 * (ld0(f.a, i, j + 1, nz, nx) - ld0(f.a, i, j - 2, nz, nx));
  const float dzb = kC1 * (vz0 - ld0(f.b, i - 1, j, nz, nx)) +
                    kC2 * (ld0(f.b, i + 1, j, nz, nx) - ld0(f.b, i - 2, j, nz, nx));
  if (dxv) {
    dxv[s * cache_stride + idx] = dxb;
    dzv[s * cache_stride + idx] = dzb;
  }
  const float k = kap[idx];
  const float px = axp[idx] * (f.c[idx] + k * dxb);
  float pz = azp[idx] * (f.d[idx] + k * dzb);
  if (i == src.src_z[s] && j == src.src_x[s])
    pz += src.amp[(long long)s * src.nt_amp + t];
  f.c[idx] = px;
  f.d[idx] = pz;
  if (hist && i == src.rcv_row[s])
    hist[((long long)s * nt_rows + t) * nx + j] = px + pz;
}

// A pressure cotangent as the adjoint step at time t sees it: the stored
// value plus the receiver cotangent on the receiver row; 0 outside.
__device__ __forceinline__ float ap_at(const float* ap, const float* yrow,
                                       int rrow, int i, int j, int nz,
                                       int nx) {
  if (i < 0 || i >= nz || j < 0 || j >= nx) return 0.0f;
  const float v = ap[i * nx + j];
  return i == rrow ? v + yrow[j] : v;
}

// kap * (a_p * ap) at a (possibly out-of-range) cell: 0 outside.
__device__ __forceinline__ float kw_at(const float* kap, const float* a_p,
                                       const float* ap, const float* yrow,
                                       int rrow, int i, int j, int nz,
                                       int nx) {
  if (i < 0 || i >= nz || j < 0 || j >= nx) return 0.0f;
  const int q = i * nx + j;
  return kap[q] * (a_p[q] * ap_at(ap, yrow, rrow, i, j, nz, nx));
}

// Adjoint phase A for every shot at time t: gk and the velocity
// cotangents; the pressure cotangents are only read.
__global__ void adj_vel(const float* __restrict__ kap,
                        const float* __restrict__ axv,
                        const float* __restrict__ azv,
                        const float* __restrict__ axp,
                        const float* __restrict__ azp, float* ast,
                        float* __restrict__ gk, const float* __restrict__ dxv,
                        const float* __restrict__ dzv, long long cache_stride,
                        const float* __restrict__ ybar, int nt_rows, Src src,
                        const float* __restrict__ dg, int t, int nz, int nx) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  const int s = blockIdx.z;
  if (i >= nz || j >= nx) return;
  const long long F = (long long)nz * nx;
  const int idx = i * nx + j;
  const Fields f = fields_of(ast, s, F);
  const float* yrow = ybar + ((long long)s * nt_rows + t) * nx;
  const int rrow = src.rcv_row[s];
  const float apx = ap_at(f.c, yrow, rrow, i, j, nz, nx);
  const float apz = ap_at(f.d, yrow, rrow, i, j, nz, nx);
  const float wx = axp[idx] * apx;
  const float wz = azp[idx] * apz;
  float g = gk[s * F + idx];
  if (i == src.src_z[s] && j == src.src_x[s])
    g += dg[(long long)s * src.nt_amp + t] * apz;
  g = g + wx * dxv[s * cache_stride + idx] + wz * dzv[s * cache_stride + idx];
  gk[s * F + idx] = g;
  const float kwx0 = kap[idx] * wx;
  const float kwz0 = kap[idx] * wz;
  const float dxf =
      kC1 * (kw_at(kap, axp, f.c, yrow, rrow, i, j + 1, nz, nx) - kwx0) +
      kC2 * (kw_at(kap, axp, f.c, yrow, rrow, i, j + 2, nz, nx) -
             kw_at(kap, axp, f.c, yrow, rrow, i, j - 1, nz, nx));
  const float dzf =
      kC1 * (kw_at(kap, azp, f.d, yrow, rrow, i + 1, j, nz, nx) - kwz0) +
      kC2 * (kw_at(kap, azp, f.d, yrow, rrow, i + 2, j, nz, nx) -
             kw_at(kap, azp, f.d, yrow, rrow, i - 1, j, nz, nx));
  f.a[idx] = axv[idx] * (f.a[idx] - dxf);
  f.b[idx] = azv[idx] * (f.b[idx] - dzf);
}

// Adjoint phase B for every shot at time t: the pressure cotangents from
// the neighbours of the new velocity cotangents.
__global__ void adj_pres(const float* __restrict__ axp,
                         const float* __restrict__ azp, float* ast,
                         const float* __restrict__ ybar, int nt_rows, Src src,
                         float a, int t, int nz, int nx) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  const int s = blockIdx.z;
  if (i >= nz || j >= nx) return;
  const long long F = (long long)nz * nx;
  const int idx = i * nx + j;
  const Fields f = fields_of(ast, s, F);
  const float* yrow = ybar + ((long long)s * nt_rows + t) * nx;
  const int rrow = src.rcv_row[s];
  const float dxb = kC1 * (f.a[idx] - ld0(f.a, i, j - 1, nz, nx)) +
                    kC2 * (ld0(f.a, i, j + 1, nz, nx) - ld0(f.a, i, j - 2, nz, nx));
  const float dzb = kC1 * (f.b[idx] - ld0(f.b, i - 1, j, nz, nx)) +
                    kC2 * (ld0(f.b, i + 1, j, nz, nx) - ld0(f.b, i - 2, j, nz, nx));
  const float pb0 = (-a) * (dxb + dzb);
  const float wx = axp[idx] * ap_at(f.c, yrow, rrow, i, j, nz, nx);
  const float wz = azp[idx] * ap_at(f.d, yrow, rrow, i, j, nz, nx);
  f.c[idx] = wx + pb0;
  f.d[idx] = wz + pb0;
}

__global__ void sum_shots(const float* __restrict__ per_shot, int ns,
                          long long F, float* __restrict__ out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= F) return;
  float acc = 0.0f;
  for (int s = 0; s < ns; ++s) acc += per_shot[s * F + q];
  out[q] = acc;
}

inline dim3 cell_grid(int ns, int nz, int nx) {
  return dim3((nx + BX - 1) / BX, (nz + BY - 1) / BY, ns);
}

}  // namespace

#define RET_IF(expr)                    \
  do {                                  \
    cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)
#define LAUNCHED() RET_IF(cudaGetLastError())

extern "C" {

// B5: the forward.  kap, axv, azv, axp, azp [nz, nx] (damping already
// ring-masked); src_amp [ns, nt]; st [ns, 4, nz, nx] scratch;
// hist [ns, nt, nx] receives px + pz of each shot's receiver row.
int b5_acoustic_forward(const float* kap, const float* axv, const float* azv,
                        const float* axp, const float* azp,
                        const float* src_amp, const int* src_z,
                        const int* src_x, const int* rcv_row, float* st,
                        float* hist, int ns, int nz, int nx, int nt, float a,
                        void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  const long long F = (long long)nz * nx;
  RET_IF(cudaMemsetAsync(st, 0, sizeof(float) * 4 * (size_t)ns * F, cs));
  const Src src{src_z, src_x, rcv_row, src_amp, nt};
  const dim3 grid = cell_grid(ns, nz, nx), block(BX, BY);
  for (int t = 0; t < nt; ++t) {
    fwd_vel<<<grid, block, 0, cs>>>(axv, azv, st, a, nullptr, 0, nz, nx);
    LAUNCHED();
    fwd_pres<<<grid, block, 0, cs>>>(kap, axp, azp, st, src, t, hist, nt,
                                     nullptr, nullptr, 0, nz, nx);
    LAUNCHED();
  }
  return cudaSuccess;
}

// B6: dJ/dkap for receiver-row cotangents ybar [ns, n_ck*K, nx] (every row
// injected).  src_amp, dg [ns, n_ck*K] (wavelet times kap[src]/dx, and
// times 1/dx); st, ast [ns, 4, nz, nx]; ckpt [ns, n_ck, 4, nz, nx];
// dxv, dzv [ns, K, nz, nx]; gk_shots [ns, nz, nx]; gk_out [nz, nx].
int b6_acoustic_backward(const float* kap, const float* axv,
                         const float* azv, const float* axp,
                         const float* azp, const float* src_amp,
                         const float* dg, const int* src_z, const int* src_x,
                         const int* rcv_row, const float* ybar, float* st,
                         float* ast, float* ckpt, float* dxv, float* dzv,
                         float* gk_shots, float* gk_out, int ns, int nz,
                         int nx, int n_ck, int K, float a, void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  const long long F = (long long)nz * nx;
  const size_t sbytes = sizeof(float) * 4 * (size_t)ns * F;
  const int nt_pad = n_ck * K;
  RET_IF(cudaMemsetAsync(st, 0, sbytes, cs));
  RET_IF(cudaMemsetAsync(ast, 0, sbytes, cs));
  RET_IF(cudaMemsetAsync(gk_shots, 0, sizeof(float) * (size_t)ns * F, cs));
  const Src src{src_z, src_x, rcv_row, src_amp, nt_pad};
  const dim3 grid = cell_grid(ns, nz, nx), block(BX, BY);
  const long long ck_stride = (long long)n_ck * 4 * F;
  const long long cache_stride = (long long)K * F;

  // forward sweep with checkpoints every K steps
  for (int t = 0; t < nt_pad; ++t) {
    fwd_vel<<<grid, block, 0, cs>>>(
        axv, azv, st, a, t % K == 0 ? ckpt + (t / K) * 4 * F : nullptr,
        ck_stride, nz, nx);
    LAUNCHED();
    fwd_pres<<<grid, block, 0, cs>>>(kap, axp, azp, st, src, t, nullptr, 0,
                                     nullptr, nullptr, 0, nz, nx);
    LAUNCHED();
  }

  // reverse sweep, chunk by chunk
  for (int c = n_ck - 1; c >= 0; --c) {
    RET_IF(cudaMemcpy2DAsync(st, sizeof(float) * 4 * F, ckpt + c * 4 * F,
                             sizeof(float) * ck_stride, sizeof(float) * 4 * F,
                             ns, cudaMemcpyDeviceToDevice, cs));
    for (int kk = 0; kk < K; ++kk) {
      const int t = c * K + kk;
      fwd_vel<<<grid, block, 0, cs>>>(axv, azv, st, a, nullptr, 0, nz, nx);
      LAUNCHED();
      fwd_pres<<<grid, block, 0, cs>>>(kap, axp, azp, st, src, t, nullptr, 0,
                                       dxv + kk * F, dzv + kk * F,
                                       cache_stride, nz, nx);
      LAUNCHED();
    }
    for (int kk = K - 1; kk >= 0; --kk) {
      const int t = c * K + kk;
      adj_vel<<<grid, block, 0, cs>>>(kap, axv, azv, axp, azp, ast, gk_shots,
                                      dxv + kk * F, dzv + kk * F,
                                      cache_stride, ybar, nt_pad, src, dg, t,
                                      nz, nx);
      LAUNCHED();
      adj_pres<<<grid, block, 0, cs>>>(axp, azp, ast, ybar, nt_pad, src, a, t,
                                       nz, nx);
      LAUNCHED();
    }
  }
  sum_shots<<<(unsigned)((F + 255) / 256), 256, 0, cs>>>(gk_shots, ns, F,
                                                        gk_out);
  LAUNCHED();
  return cudaSuccess;
}

}  // extern "C"
