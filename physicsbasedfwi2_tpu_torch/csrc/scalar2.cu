// Second-order acoustic FWI kernels for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of the JAX package:
//   B1  b1_forward2             <- physicsbasedfwi2_tpu/ops/pallas_scalar2.py
//                                  forward2 / _fwd_kernel
//   B2  b2_fwi_l1_loss_grad     <- physicsbasedfwi2_tpu/ops/pallas_fwi_fused.py
//                                  fwi_l1_loss_grad / _kernel (with its
//                                  want_wavelet_grad output)
//   B4a b4a_forward2_ckpt       <- pallas_scalar2.py forward2_ckpt /
//                                  _fwd_ckpt_kernel (B2's phase 1)
//   B4b b4b_backward2           <- pallas_scalar2.py _backward2 / _bwd_kernel
//                                  (B2's phase 3 for any row cotangent)
//
// B4a and B4b are the primal and adjoint of the acoustic_pallas2 custom
// VJP.  They run B2's own sweeps (fwd_ckpt_sweep, reverse_sweep below), so
// they cost what B2's phases cost: per step B4a is B1's step plus the
// checkpoint writes every KC steps, B4b B2's recompute and adjoint steps.
// Prediction before their first chip run, at marmousi_acoustic's shape:
// B4a ~30 ms (B1's 4 k launches), B4b ~90-100 ms (B2 minus its forward),
// against operation bounds of ~0.84 and ~0.99 ms: bound by launches and
// the step's L2 traffic, as B1 and B2 are.
//
// Scheme (K = (vp dt/dx)^2, d+ / d- the sponge factors with a 2-cell zero
// ring folded into d+):
//     u1 = d+ (2 u0 - d- u_-1 + K Lap4(u0)),  u1[src] += amp_t K[src]
// and the receiver row of u1 is recorded every step.
//
// Design.  The Pallas kernels keep one shot's whole grid (about 11 MB of
// fields, Laplacian cache and row history) resident on chip, one program
// per shot.  That does not fit in 227 KB of shared memory, so here every
// time step is one launch over all shots at once, one thread per cell of
// [ns, nz8, nx128], with the fields in global memory.  At the flagship
// shape (18 shots, 192 x 256 padded) a field is 3.5 MB for all shots, so
// the live fields and the three coefficient planes (about 14 MB) stay in
// the 50 MB L2; the Laplacian cache and checkpoints stream from HBM.
//
// What bounds it on the H100: per cell-step the forward reads u0 (plus its
// stencil neighbours, mostly L1/L2 hits), u_-1, K, d+, d- and writes u1:
// about 24 B, some 21 MB per step for all shots; the reverse sweep adds
// the Laplacian cache and checkpoints, which stream from HBM.  At
// nt = 4001 the forward is 4 k launches and the fused loss+gradient
// 3 x 4 k.  Measured on an H100 80GB HBM3 at 700 W (PERF.md), a step
// costs 7.3 us (B1) and 10.1 us (B2) against launch floors of 2.7 and
// 3.5 us: the step's memory traffic bounds it, launches take a third.
// The design keeps the time loop inside one C call per kernel (no Python
// per step) and leaves CUDA graphs, a persistent kernel and on-chip
// tiling to later work.
//
// Boundaries: Pallas reads neighbours with circular rolls; the zero ring in
// d+ keeps every field zero within 2 cells of the array edge, so reading 0
// outside the array gives the same values.  The tests hold the plain
// PyTorch versions (which use the same zero reads) against the Pallas
// kernels in interpret mode.
//
// Determinism: no atomics.  The gradient is accumulated per shot and the
// shots are summed in order afterwards; the loss is accumulated per
// (shot, column) in double and summed in order by one thread.

#include <cuda_runtime.h>

#include <initializer_list>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr float kL0 = -5.0f;                       // 2 axes x (-5/2)
constexpr float kL1 = (float)(4.0 / 3.0);
constexpr float kL2 = (float)(-1.0 / 12.0);
constexpr float kEps = 1e-10f;

__device__ __forceinline__ float ld0(const float* f, int i, int j, int nz,
                                     int nx) {
  return (i >= 0 && i < nz && j >= 0 && j < nx) ? f[i * nx + j] : 0.0f;
}

// 4th-order 5-point-per-axis Laplacian in grid units, summed in the order
// of pallas_scalar2._lap.
__device__ __forceinline__ float lap4(const float* f, int i, int j, int nz,
                                      int nx) {
  float s1 = ld0(f, i, j + 1, nz, nx) + ld0(f, i, j - 1, nz, nx) +
             ld0(f, i + 1, j, nz, nx) + ld0(f, i - 1, j, nz, nx);
  float s2 = ld0(f, i, j + 2, nz, nx) + ld0(f, i, j - 2, nz, nx) +
             ld0(f, i + 2, j, nz, nx) + ld0(f, i - 2, j, nz, nx);
  return kL0 * f[i * nx + j] + kL1 * s1 + kL2 * s2;
}

__device__ __forceinline__ float sgn(float x) {  // jnp.sign: sign(0) = 0
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

struct Geom {
  const int* src_z;
  const int* src_x;
  const int* rcv_row;
  const float* wav;  // [ns, nt_wav]
  int nt_wav;
};

// One forward step for every shot.  u_m1 holds u_-1 on entry and u1 on
// exit (each thread reads and writes only its own cell of it).
//   ckpt   (optional) receives (u0, u_-1) before the step, shot stride
//          ck_stride;
//   lapc   (optional) receives Lap(u0), shot stride lap_stride;
//   hist   (optional) row t of [ns, nt_rows, nx] receives u1[rcv_row]
//          minus dir's row t (dir optional), only for t < nt_valid.
__global__ void fwd_step(const float* __restrict__ K,
                         const float* __restrict__ dp,
                         const float* __restrict__ dm,
                         const float* __restrict__ u0,
                         float* __restrict__ u_m1, Geom geo, int t,
                         float* __restrict__ ckpt, long long ck_stride,
                         float* __restrict__ lapc, long long lap_stride,
                         float* __restrict__ hist,
                         const float* __restrict__ dir, int nt_rows,
                         int nt_valid, int nz, int nx) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  const int s = blockIdx.z;
  if (i >= nz || j >= nx) return;
  const long long F = (long long)nz * nx;
  const int idx = i * nx + j;
  const float* u0s = u0 + s * F;
  float* ums = u_m1 + s * F;
  const float c0 = u0s[idx];
  const float cm = ums[idx];
  if (ckpt) {
    float* ck = ckpt + s * ck_stride;
    ck[idx] = c0;
    ck[F + idx] = cm;
  }
  const float lp = lap4(u0s, i, j, nz, nx);
  if (lapc) lapc[s * lap_stride + idx] = lp;
  const float k = K[idx];
  float u1 = dp[idx] * (2.0f * c0 - dm[idx] * cm + k * lp);
  if (i == geo.src_z[s] && j == geo.src_x[s])
    u1 += geo.wav[(long long)s * geo.nt_wav + t] * k;
  ums[idx] = u1;
  if (hist && i == geo.rcv_row[s] && t < nt_valid) {
    const long long r = ((long long)s * nt_rows + t) * nx + j;
    hist[r] = dir ? u1 - dir[r] : u1;
  }
}

// Receiver-row cotangent as seen by the adjoint step at time t.
__device__ __forceinline__ float pb_at(const float* pbs, const float* yrow,
                                       int rrow, int i, int j, int nz,
                                       int nx) {
  if (i < 0 || i >= nz || j < 0 || j >= nx) return 0.0f;
  const float v = pbs[i * nx + j];
  return (yrow && i == rrow) ? v + yrow[j] : v;
}

// K * d+ * pb at a (possibly out-of-range) cell: 0 outside the array.
__device__ __forceinline__ float kw_at(const float* K, const float* dp,
                                       const float* pbs, const float* yrow,
                                       int rrow, int i, int j, int nz,
                                       int nx) {
  if (i < 0 || i >= nz || j < 0 || j >= nx) return 0.0f;
  const int q = i * nx + j;
  return K[q] * (dp[q] * pb_at(pbs, yrow, rrow, i, j, nz, nx));
}

// One adjoint (exact transpose) step for every shot at time t:
//   pb += S^T ybar_t;  w = d+ pb;  gk[src] += amp_t pb[src];  gk += w Lap(u0)
//   pb' = qb + 2 w + Lap(K w);  qb' = -d- w
// pb is double-buffered (neighbours are read); qb and gk are per-cell.
// gwav (optional) [ns, nt_wav] receives dJ/d amp_t = K[src] pb[src], the
// source cell's thread its only writer (pallas_fwi_fused.py:219-226).
__global__ void adj_step(const float* __restrict__ K,
                         const float* __restrict__ dp,
                         const float* __restrict__ dm,
                         const float* __restrict__ pb_in,
                         float* __restrict__ pb_out, float* __restrict__ qb,
                         float* __restrict__ gk,
                         const float* __restrict__ lapc, long long lap_stride,
                         const float* __restrict__ ybar, int nt_rows,
                         int nt_valid, float* __restrict__ gwav, Geom geo,
                         int t, int nz, int nx) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  const int s = blockIdx.z;
  if (i >= nz || j >= nx) return;
  const long long F = (long long)nz * nx;
  const int idx = i * nx + j;
  const float* pbs = pb_in + s * F;
  const float* yrow =
      t < nt_valid ? ybar + ((long long)s * nt_rows + t) * nx : nullptr;
  const int rrow = geo.rcv_row[s];
  const float p = pb_at(pbs, yrow, rrow, i, j, nz, nx);
  const float w = dp[idx] * p;
  float g = gk[s * F + idx];
  if (i == geo.src_z[s] && j == geo.src_x[s]) {
    g += geo.wav[(long long)s * geo.nt_wav + t] * p;
    if (gwav) gwav[(long long)s * geo.nt_wav + t] = p * K[idx];
  }
  g += w * lapc[s * lap_stride + idx];
  gk[s * F + idx] = g;
  const float kwc = K[idx] * w;
  const float s1 = kw_at(K, dp, pbs, yrow, rrow, i, j + 1, nz, nx) +
                   kw_at(K, dp, pbs, yrow, rrow, i, j - 1, nz, nx) +
                   kw_at(K, dp, pbs, yrow, rrow, i + 1, j, nz, nx) +
                   kw_at(K, dp, pbs, yrow, rrow, i - 1, j, nz, nx);
  const float s2 = kw_at(K, dp, pbs, yrow, rrow, i, j + 2, nz, nx) +
                   kw_at(K, dp, pbs, yrow, rrow, i, j - 2, nz, nx) +
                   kw_at(K, dp, pbs, yrow, rrow, i + 2, j, nz, nx) +
                   kw_at(K, dp, pbs, yrow, rrow, i - 2, j, nz, nx);
  const float lkw = kL0 * kwc + kL1 * s1 + kL2 * s2;
  float* qbs = qb + s * F;
  pb_out[s * F + idx] = qbs[idx] + 2.0f * w + lkw;
  qbs[idx] = -(dm[idx] * w);
}

// Trace-normalized L1 misfit and its cotangent, one thread per (shot,
// column), four sweeps over the column's history (max; ties; loss and S;
// cotangent written over the history):
//   yn = y / (m + eps),  r = (yn - obs) mask,  g = sign(r) / count
//   ybar = g / (m + eps) - 1[|y| == m] sign(y) S / (cnt (m + eps))
// the exact jnp.max subgradient (pallas_fwi_fused.py:21-30).
__global__ void misfit_cols(float* __restrict__ hist,
                            const float* __restrict__ obs,
                            const float* __restrict__ rmask, int ns,
                            int nt_rows, int nx, float inv_count,
                            double* __restrict__ loss_part) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (j >= nx || s >= ns) return;
  const long long base = (long long)s * nt_rows * nx + j;
  float* y = hist + base;
  const float* ob = obs + base;
  float m = 0.0f;
  for (int t = 0; t < nt_rows; ++t) m = fmaxf(m, fabsf(y[(long long)t * nx]));
  const float inv_m = 1.0f / (m + kEps);
  float cnt = 0.0f;
  for (int t = 0; t < nt_rows; ++t)
    cnt += fabsf(y[(long long)t * nx]) == m ? 1.0f : 0.0f;
  const float inv_cnt = 1.0f / fmaxf(cnt, 1.0f);
  const float mk = rmask[s * nx + j];
  double loss = 0.0, S = 0.0;
  for (int t = 0; t < nt_rows; ++t) {
    const long long q = (long long)t * nx;
    const float yn = y[q] * inv_m;
    const float r = (yn - ob[q]) * mk;
    const float g = sgn(r) * inv_count;
    loss += fabsf(r);
    S += g * yn;
  }
  const float corr = inv_cnt * (float)S * inv_m;
  for (int t = 0; t < nt_rows; ++t) {
    const long long q = (long long)t * nx;
    const float yk = y[q];
    const float yn = yk * inv_m;
    const float g = sgn((yn - ob[q]) * mk) * inv_count;
    const float star = fabsf(yk) == m ? 1.0f : 0.0f;
    y[q] = g * inv_m - star * sgn(yk) * corr;
  }
  loss_part[s * nx + j] = loss;
}

__global__ void sum_loss(const double* __restrict__ part, int n,
                         float inv_count, float* __restrict__ out) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    double acc = 0.0;
    for (int k = 0; k < n; ++k) acc += part[k];
    out[0] = (float)(acc * inv_count);
  }
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

namespace {

// Forward sweep of n_ck*KC steps from zero fields, (u0, u_-1) written to
// ckpt[s, c] before step c*KC; hist rows (minus dir's, if given) for
// t < nt_valid, row stride nt_rows.
cudaError_t fwd_ckpt_sweep(const float* K, const float* dp, const float* dm,
                           const Geom& geo, float* u0, float* um1,
                           float* hist, const float* dir, int nt_rows,
                           int nt_valid, float* ckpt, int ns, int nz, int nx,
                           int n_ck, int KC, cudaStream_t st) {
  const long long F = (long long)nz * nx;
  const size_t fbytes = sizeof(float) * (size_t)ns * F;
  RET_IF(cudaMemsetAsync(u0, 0, fbytes, st));
  RET_IF(cudaMemsetAsync(um1, 0, fbytes, st));
  const dim3 grid = cell_grid(ns, nz, nx), block(BX, BY);
  const long long ck_stride = (long long)n_ck * 2 * F;
  float* cur = u0;
  float* prev = um1;
  for (int c = 0; c < n_ck; ++c) {
    for (int kk = 0; kk < KC; ++kk) {
      const int t = c * KC + kk;
      fwd_step<<<grid, block, 0, st>>>(
          K, dp, dm, cur, prev, geo, t, kk == 0 ? ckpt + c * 2 * F : nullptr,
          ck_stride, nullptr, 0, hist, dir, nt_rows, nt_valid, nz, nx);
      LAUNCHED();
      float* tmp = cur;
      cur = prev;
      prev = tmp;
    }
  }
  return cudaSuccess;
}

// Reverse sweep: per chunk (last first) restore (u0, u_-1) from ckpt,
// recompute KC steps caching Lap(u0), then KC adjoint steps injecting the
// cotangent rows ybar (row stride nt_rows) for t < nt_valid; dJ/dK per
// shot in gk_shots, summed over shots in order into gk_out; dJ/dwavelet
// into gwav [ns, nt_wav] when it is given.
cudaError_t reverse_sweep(const float* K, const float* dp, const float* dm,
                          const Geom& geo, const float* ybar, int nt_rows,
                          int nt_valid, const float* ckpt, float* u0,
                          float* um1, float* pb0, float* pb1, float* qb,
                          float* gk_shots, float* lapc, float* gk_out,
                          float* gwav, int ns, int nz, int nx, int n_ck,
                          int KC, cudaStream_t st) {
  const long long F = (long long)nz * nx;
  const size_t fbytes = sizeof(float) * (size_t)ns * F;
  for (float* p : {pb0, qb, gk_shots})
    RET_IF(cudaMemsetAsync(p, 0, fbytes, st));
  const dim3 grid = cell_grid(ns, nz, nx), block(BX, BY);
  const long long ck_stride = (long long)n_ck * 2 * F;
  const long long lap_stride = (long long)KC * F;
  float* pin = pb0;
  float* pout = pb1;
  for (int c = n_ck - 1; c >= 0; --c) {
    for (int f = 0; f < 2; ++f)
      RET_IF(cudaMemcpy2DAsync(
          f == 0 ? u0 : um1, sizeof(float) * F, ckpt + (c * 2 + f) * F,
          sizeof(float) * ck_stride, sizeof(float) * F, ns,
          cudaMemcpyDeviceToDevice, st));
    float* cur = u0;
    float* prev = um1;
    for (int kk = 0; kk < KC; ++kk) {
      fwd_step<<<grid, block, 0, st>>>(K, dp, dm, cur, prev, geo, c * KC + kk,
                                       nullptr, 0, lapc + kk * F, lap_stride,
                                       nullptr, nullptr, nt_rows, nt_valid,
                                       nz, nx);
      LAUNCHED();
      float* tmp = cur;
      cur = prev;
      prev = tmp;
    }
    for (int kk = KC - 1; kk >= 0; --kk) {
      adj_step<<<grid, block, 0, st>>>(K, dp, dm, pin, pout, qb, gk_shots,
                                       lapc + kk * F, lap_stride, ybar,
                                       nt_rows, nt_valid, gwav, geo,
                                       c * KC + kk, nz, nx);
      LAUNCHED();
      float* tmp = pin;
      pin = pout;
      pout = tmp;
    }
  }
  sum_shots<<<(unsigned)((F + 255) / 256), 256, 0, st>>>(gk_shots, ns, F,
                                                        gk_out);
  LAUNCHED();
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* pbfwi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// B1: forward2.  hist[ns, nt, nx] receives the receiver row of every step.
// u0/um1 are [ns, nz, nx] scratch.
int b1_forward2(const float* K, const float* dp, const float* dm,
                const float* wav, const int* src_z, const int* src_x,
                const int* rcv_row, float* u0, float* um1, float* hist,
                int ns, int nz, int nx, int nt, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t fbytes = sizeof(float) * (size_t)ns * nz * nx;
  RET_IF(cudaMemsetAsync(u0, 0, fbytes, st));
  RET_IF(cudaMemsetAsync(um1, 0, fbytes, st));
  const Geom geo{src_z, src_x, rcv_row, wav, nt};
  const dim3 grid = cell_grid(ns, nz, nx), block(BX, BY);
  float* cur = u0;
  float* prev = um1;
  for (int t = 0; t < nt; ++t) {
    fwd_step<<<grid, block, 0, st>>>(K, dp, dm, cur, prev, geo, t, nullptr,
                                     0, nullptr, 0, hist, nullptr, nt, nt,
                                     nz, nx);
    LAUNCHED();
    float* tmp = cur;
    cur = prev;
    prev = tmp;
  }
  return cudaSuccess;
}

// B2: fused trace-normalized L1 loss and dJ/dK.
//   wav [ns, n_ck*KC] (zero past nt); obs, dir, hist [ns, n_ck*KC, nx];
//   rmask [ns, nx]; u0, um1, pb0, pb1, qb, gk_shots [ns, nz, nx];
//   lapc [ns, KC, nz, nx]; ckpt [ns, n_ck, 2, nz, nx];
//   loss_part [ns, nx] doubles; loss_out [1]; gk_out [nz, nx];
//   gwav (null, or want_wavelet_grad) [ns, n_ck*KC] gets dJ/dwavelet.
int b2_fwi_l1_loss_grad(const float* K, const float* dp, const float* dm,
                        const float* wav, const int* src_z, const int* src_x,
                        const int* rcv_row, const float* obs,
                        const float* dir, const float* rmask, float* u0,
                        float* um1, float* pb0, float* pb1, float* qb,
                        float* gk_shots, float* lapc, float* hist,
                        float* ckpt, double* loss_part, float* loss_out,
                        float* gk_out, float* gwav, int ns, int nz, int nx,
                        int nt, int n_ck, int KC, float inv_count,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nt_pad = n_ck * KC;
  RET_IF(cudaMemsetAsync(hist, 0, sizeof(float) * (size_t)ns * nt_pad * nx,
                         st));
  const Geom geo{src_z, src_x, rcv_row, wav, nt_pad};
  // phase 1: forward with checkpoints every KC steps; hist = pred - dir
  RET_IF(fwd_ckpt_sweep(K, dp, dm, geo, u0, um1, hist, dir, nt_pad, nt, ckpt,
                        ns, nz, nx, n_ck, KC, st));
  // phase 2: misfit, loss partials and the cotangent rows (over hist)
  misfit_cols<<<dim3((nx + 127) / 128, ns), 128, 0, st>>>(
      hist, obs, rmask, ns, nt_pad, nx, inv_count, loss_part);
  LAUNCHED();
  // phase 3: reverse sweep, chunk by chunk from the checkpoints
  RET_IF(reverse_sweep(K, dp, dm, geo, hist, nt_pad, nt, ckpt, u0, um1, pb0,
                       pb1, qb, gk_shots, lapc, gk_out, gwav, ns, nz, nx, n_ck,
                       KC, st));
  sum_loss<<<1, 1, 0, st>>>(loss_part, ns * nx, inv_count, loss_out);
  LAUNCHED();
  return cudaSuccess;
}

// B4a: forward2 with (u0, u_-1) checkpoints every KC steps.
//   wav [ns, n_ck*KC] (zero past nt); hist [ns, nt, nx];
//   u0, um1 [ns, nz, nx] scratch; ckpt [ns, n_ck, 2, nz, nx].
int b4a_forward2_ckpt(const float* K, const float* dp, const float* dm,
                      const float* wav, const int* src_z, const int* src_x,
                      const int* rcv_row, float* u0, float* um1, float* hist,
                      float* ckpt, int ns, int nz, int nx, int nt, int n_ck,
                      int KC, void* stream) {
  const Geom geo{src_z, src_x, rcv_row, wav, n_ck * KC};
  return fwd_ckpt_sweep(K, dp, dm, geo, u0, um1, hist, nullptr, nt, nt, ckpt,
                        ns, nz, nx, n_ck, KC, (cudaStream_t)stream);
}

// B4b: dJ/dK of the second-order forward for receiver-row cotangents
// ybar [ns, n_ck*KC, nx] (every row injected, as the Pallas kernel does),
// from B4a's checkpoints.  Scratch as in B2; gk_out [nz, nx].
int b4b_backward2(const float* K, const float* dp, const float* dm,
                  const float* wav, const int* src_z, const int* src_x,
                  const int* rcv_row, const float* ybar, const float* ckpt,
                  float* u0, float* um1, float* pb0, float* pb1, float* qb,
                  float* gk_shots, float* lapc, float* gk_out, int ns, int nz,
                  int nx, int n_ck, int KC, void* stream) {
  const int nt_pad = n_ck * KC;
  const Geom geo{src_z, src_x, rcv_row, wav, nt_pad};
  return reverse_sweep(K, dp, dm, geo, ybar, nt_pad, nt_pad, ckpt, u0, um1,
                       pb0, pb1, qb, gk_shots, lapc, gk_out, nullptr, ns, nz,
                       nx, n_ck, KC, (cudaStream_t)stream);
}

}  // extern "C"
