// Shot-pair second-order acoustic kernels for Hopper (sm_90a): the
// per-step route.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   B7a b7a_forward2b   <- physicsbasedfwi2_tpu/ops/pallas_scalar2b.py
//                          forward2b / _fwd_kernel
//   B7b b7b_backward2b  <- pallas_scalar2b.py _backward2b / _bwd_kernel
//
// Routes.  ops/scalar2b.py picks one by shape before any launch, as
// ops/scalar2.py does for B4.  The default, wherever
// ops/scalar2.py::resident_plan holds the grid, is the resident route,
// b7a_forward2b_resident / b7b_backward2b_resident in csrc/scalar2.cu: B4's
// resident sweeps (one thread-block cluster per shot) with the checkpoints
// in pairs and the gradient summed in pair order.  The kernels below are
// the per-step route, for grids no plan holds and for comparison.  Either
// route's checkpoints feed either route's B7b.
//
// They compute what B4a and B4b (csrc/scalar2.cu) compute, with the
// Pallas kernels' other layout: shots in pairs (B = 2; the wrapper pads
// an odd shot count by repeating the last shot), checkpoints of (u0, u_-1)
// every KC = 16 steps as [ns/2, n_ck, 2, B, nz, nx], the receiver rows of
// every step streamed to device memory.  Scheme (K = (vp dt/dx)^2, d+ / d-
// the sponge factors with a 2-cell zero ring folded into d+):
//     u1 = d+ (2 u0 - d- u_-1 + K Lap4(u0)),  u1[src] += amp_t K[src]
// and its exact transpose (see csrc/scalar2.cu).
//
// Design.  The Pallas kernel's own idea carried over: one grid program per
// pair of shots, the medium block read once and broadcast over the pair.
// Here every time step is one launch over all pairs, one thread per cell of
// [ns/2, nz, nx]; the thread loads K, d+ and d- once and updates that cell
// for both shots (the adjoint step likewise for each neighbour's K d+).
// The fields stay in global memory, as in csrc/scalar2.cu.  The gradient is
// accumulated per shot, then summed as the Pallas kernel sums it: the two
// shots of a pair first, then the pairs in order.  No atomics.
//
// What bounds it on the H100: the same as B4 (csrc/scalar2.cu), launches
// and the step's L2 traffic; the pairing halves the threads and the loads
// of the three coefficient planes, not the field traffic.  The TPU saw no
// gain from pairing (pallas_scalar2b.py:8-11).  Prediction before the first
// chip run, at marmousi_acoustic's shape (18 shots, nt 4001): B7a 28-32 ms
// against B4a's 30, B7b 85-100 ms against B4b's 90 (KC = 16 restores twice
// as many checkpoints), within 10 % of B4 either way; operation bounds
// 0.84 and 0.99 ms.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): B7a 30.2 ms
// against B4a's 32.2, B7b 87.0 ms against B4b's 90.5 on the same inputs;
// reading the medium once per pair buys ~4 %.
//
// Arithmetic and order per cell are B4's, so B7a's traces are B4a's and
// B7b's gradient differs from B4b's only by the order of the shot sum.

#include <cuda_runtime.h>

#include <initializer_list>

namespace {

constexpr int B = 2;  // shots per pair
constexpr int BX = 32;
constexpr int BY = 8;
constexpr float kL0 = -5.0f;                       // 2 axes x (-5/2)
constexpr float kL1 = (float)(4.0 / 3.0);
constexpr float kL2 = (float)(-1.0 / 12.0);

__device__ __forceinline__ float ld0(const float* f, int i, int j, int nz,
                                     int nx) {
  return (i >= 0 && i < nz && j >= 0 && j < nx) ? f[i * nx + j] : 0.0f;
}

// 4th-order Laplacian in grid units, in csrc/scalar2.cu's order.
__device__ __forceinline__ float lap4(const float* f, int i, int j, int nz,
                                      int nx) {
  float s1 = ld0(f, i, j + 1, nz, nx) + ld0(f, i, j - 1, nz, nx) +
             ld0(f, i + 1, j, nz, nx) + ld0(f, i - 1, j, nz, nx);
  float s2 = ld0(f, i, j + 2, nz, nx) + ld0(f, i, j - 2, nz, nx) +
             ld0(f, i + 2, j, nz, nx) + ld0(f, i - 2, j, nz, nx);
  return kL0 * f[i * nx + j] + kL1 * s1 + kL2 * s2;
}

struct Geom {
  const int* src_z;
  const int* src_x;
  const int* rcv_row;
  const float* wav;  // [ns, nt_wav]
  int nt_wav;
};

// One forward step for both shots of every pair (blockIdx.z = pair).
// u_m1 holds u_-1 on entry and u1 on exit.
//   ckpt  (optional) this chunk's checkpoint, pair stride ck_stride,
//         laid out [2 (u0, u_-1), B, nz, nx];
//   lapc  (optional) receives Lap(u0), [ns, nz, nx];
//   hist  (optional) row t of [ns, nt_rows, nx] receives u1[rcv_row],
//         for t < nt_rows.
__global__ void fwd_step2(const float* __restrict__ K,
                          const float* __restrict__ dp,
                          const float* __restrict__ dm,
                          const float* __restrict__ u0,
                          float* __restrict__ u_m1, Geom geo, int t,
                          float* __restrict__ ckpt, long long ck_stride,
                          float* __restrict__ lapc, float* __restrict__ hist,
                          int nt_rows, int nz, int nx) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  const int pair = blockIdx.z;
  if (i >= nz || j >= nx) return;
  const long long F = (long long)nz * nx;
  const int idx = i * nx + j;
  const float k = K[idx];
  const float p = dp[idx];
  const float m = dm[idx];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int s = pair * B + b;
    const float* u0s = u0 + s * F;
    float* ums = u_m1 + s * F;
    const float c0 = u0s[idx];
    const float cm = ums[idx];
    if (ckpt) {
      float* ck = ckpt + pair * ck_stride + b * F;
      ck[idx] = c0;
      ck[B * F + idx] = cm;
    }
    const float lp = lap4(u0s, i, j, nz, nx);
    if (lapc) lapc[s * F + idx] = lp;
    float u1 = p * (2.0f * c0 - m * cm + k * lp);
    if (i == geo.src_z[s] && j == geo.src_x[s])
      u1 += geo.wav[(long long)s * geo.nt_wav + t] * k;
    ums[idx] = u1;
    if (hist && i == geo.rcv_row[s] && t < nt_rows)
      hist[((long long)s * nt_rows + t) * nx + j] = u1;
  }
}

// Receiver-row cotangent as seen by the adjoint step.
__device__ __forceinline__ float pb_at(const float* pbs, const float* yrow,
                                       int rrow, int i, int j, int nz,
                                       int nx) {
  if (i < 0 || i >= nz || j < 0 || j >= nx) return 0.0f;
  const float v = pbs[i * nx + j];
  return i == rrow ? v + yrow[j] : v;
}

struct Pair {
  const float* pb[B];    // this step's pb of each shot
  const float* yrow[B];  // its ybar row at t
  int rrow[B];
};

// K (d+ pb) at a (possibly out-of-range) cell for both shots: K and d+
// loaded once.
__device__ __forceinline__ float2 kw2_at(const float* K, const float* dp,
                                         const Pair& q, int i, int j, int nz,
                                         int nx) {
  if (i < 0 || i >= nz || j < 0 || j >= nx) return make_float2(0.0f, 0.0f);
  const int c = i * nx + j;
  const float k = K[c];
  const float d = dp[c];
  return make_float2(k * (d * pb_at(q.pb[0], q.yrow[0], q.rrow[0], i, j, nz,
                                    nx)),
                     k * (d * pb_at(q.pb[1], q.yrow[1], q.rrow[1], i, j, nz,
                                    nx)));
}

// One adjoint step for both shots of every pair at time t:
//   pb += S^T ybar_t;  w = d+ pb;  gk[src] += amp_t pb[src];  gk += w Lap(u0)
//   pb' = qb + 2 w + Lap(K w);  qb' = -d- w
// pb is double-buffered (neighbours are read); qb and gk are per-cell.
__global__ void adj_step2(const float* __restrict__ K,
                          const float* __restrict__ dp,
                          const float* __restrict__ dm,
                          const float* __restrict__ pb_in,
                          float* __restrict__ pb_out, float* __restrict__ qb,
                          float* __restrict__ gk,
                          const float* __restrict__ lapc,
                          const float* __restrict__ ybar, int nt_rows,
                          Geom geo, int t, int nz, int nx) {
  const int j = blockIdx.x * BX + threadIdx.x;
  const int i = blockIdx.y * BY + threadIdx.y;
  const int pair = blockIdx.z;
  if (i >= nz || j >= nx) return;
  const long long F = (long long)nz * nx;
  const int idx = i * nx + j;
  const float k = K[idx];
  const float d = dp[idx];
  const float m = dm[idx];
  Pair q;
  float w[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int s = pair * B + b;
    q.pb[b] = pb_in + s * F;
    q.yrow[b] = ybar + ((long long)s * nt_rows + t) * nx;
    q.rrow[b] = geo.rcv_row[s];
    const float p = pb_at(q.pb[b], q.yrow[b], q.rrow[b], i, j, nz, nx);
    w[b] = d * p;
    float g = gk[s * F + idx];
    if (i == geo.src_z[s] && j == geo.src_x[s])
      g += geo.wav[(long long)s * geo.nt_wav + t] * p;
    g += w[b] * lapc[s * F + idx];
    gk[s * F + idx] = g;
  }
  const float2 a1 = kw2_at(K, dp, q, i, j + 1, nz, nx);
  const float2 a2 = kw2_at(K, dp, q, i, j - 1, nz, nx);
  const float2 a3 = kw2_at(K, dp, q, i + 1, j, nz, nx);
  const float2 a4 = kw2_at(K, dp, q, i - 1, j, nz, nx);
  const float2 b1 = kw2_at(K, dp, q, i, j + 2, nz, nx);
  const float2 b2 = kw2_at(K, dp, q, i, j - 2, nz, nx);
  const float2 b3 = kw2_at(K, dp, q, i + 2, j, nz, nx);
  const float2 b4 = kw2_at(K, dp, q, i - 2, j, nz, nx);
  const float s1[B] = {a1.x + a2.x + a3.x + a4.x, a1.y + a2.y + a3.y + a4.y};
  const float s2[B] = {b1.x + b2.x + b3.x + b4.x, b1.y + b2.y + b3.y + b4.y};
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int s = pair * B + b;
    const float lkw = kL0 * (k * w[b]) + kL1 * s1[b] + kL2 * s2[b];
    float* qbs = qb + s * F;
    pb_out[s * F + idx] = qbs[idx] + 2.0f * w[b] + lkw;
    qbs[idx] = -(m * w[b]);
  }
}

// out[q] = sum over pairs of (gk[2 p, q] + gk[2 p + 1, q]), pairs in order
__global__ void sum_pairs(const float* __restrict__ per_shot, int npair,
                          long long F, float* __restrict__ out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= F) return;
  float acc = 0.0f;
  for (int p = 0; p < npair; ++p)
    acc += per_shot[(2LL * p) * F + q] + per_shot[(2LL * p + 1) * F + q];
  out[q] = acc;
}

inline dim3 pair_grid(int npair, int nz, int nx) {
  return dim3((nx + BX - 1) / BX, (nz + BY - 1) / BY, npair);
}

}  // namespace

#define RET_IF(expr)                    \
  do {                                  \
    cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)
#define LAUNCHED() RET_IF(cudaGetLastError())

extern "C" {

// B7a: forward2b.  npair = ns/2 (ns even); wav [ns, n_ck*KC] (zero past
// nt); u0, um1 [ns, nz, nx] scratch; hist [ns, nt, nx];
// ckpt [npair, n_ck, 2, B, nz, nx].
int b7a_forward2b(const float* K, const float* dp, const float* dm,
                  const float* wav, const int* src_z, const int* src_x,
                  const int* rcv_row, float* u0, float* um1, float* hist,
                  float* ckpt, int npair, int nz, int nx, int nt, int n_ck,
                  int KC, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long F = (long long)nz * nx;
  const size_t fbytes = sizeof(float) * (size_t)npair * B * F;
  RET_IF(cudaMemsetAsync(u0, 0, fbytes, st));
  RET_IF(cudaMemsetAsync(um1, 0, fbytes, st));
  const Geom geo{src_z, src_x, rcv_row, wav, n_ck * KC};
  const dim3 grid = pair_grid(npair, nz, nx), block(BX, BY);
  const long long ck_stride = (long long)n_ck * 2 * B * F;
  float* cur = u0;
  float* prev = um1;
  for (int c = 0; c < n_ck; ++c) {
    for (int kk = 0; kk < KC; ++kk) {
      fwd_step2<<<grid, block, 0, st>>>(
          K, dp, dm, cur, prev, geo, c * KC + kk,
          kk == 0 ? ckpt + c * 2 * B * F : nullptr, ck_stride, nullptr, hist,
          nt, nz, nx);
      LAUNCHED();
      float* tmp = cur;
      cur = prev;
      prev = tmp;
    }
  }
  return cudaSuccess;
}

// B7b: dJ/dK for receiver-row cotangents ybar [ns, n_ck*KC, nx] (every
// row injected, as the Pallas kernel does) from B7a's checkpoints.
//   u0, um1, pb0, pb1, qb, gk_shots [ns, nz, nx]; lapc [KC, ns, nz, nx];
//   gk_out [nz, nx].
int b7b_backward2b(const float* K, const float* dp, const float* dm,
                   const float* wav, const int* src_z, const int* src_x,
                   const int* rcv_row, const float* ybar, const float* ckpt,
                   float* u0, float* um1, float* pb0, float* pb1, float* qb,
                   float* gk_shots, float* lapc, float* gk_out, int npair,
                   int nz, int nx, int n_ck, int KC, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long F = (long long)nz * nx;
  const int ns = npair * B;
  const int nt_pad = n_ck * KC;
  const size_t fbytes = sizeof(float) * (size_t)ns * F;
  for (float* p : {pb0, qb, gk_shots})
    RET_IF(cudaMemsetAsync(p, 0, fbytes, st));
  const Geom geo{src_z, src_x, rcv_row, wav, nt_pad};
  const dim3 grid = pair_grid(npair, nz, nx), block(BX, BY);
  const long long ck_stride = (long long)n_ck * 2 * B * F;
  float* pin = pb0;
  float* pout = pb1;
  for (int c = n_ck - 1; c >= 0; --c) {
    for (int f = 0; f < 2; ++f)
      RET_IF(cudaMemcpy2DAsync(
          f == 0 ? u0 : um1, sizeof(float) * B * F,
          ckpt + (c * 2 + f) * B * F, sizeof(float) * ck_stride,
          sizeof(float) * B * F, npair, cudaMemcpyDeviceToDevice, st));
    float* cur = u0;
    float* prev = um1;
    for (int kk = 0; kk < KC; ++kk) {
      fwd_step2<<<grid, block, 0, st>>>(K, dp, dm, cur, prev, geo,
                                        c * KC + kk, nullptr, 0,
                                        lapc + kk * ns * F, nullptr, 0, nz,
                                        nx);
      LAUNCHED();
      float* tmp = cur;
      cur = prev;
      prev = tmp;
    }
    for (int kk = KC - 1; kk >= 0; --kk) {
      adj_step2<<<grid, block, 0, st>>>(K, dp, dm, pin, pout, qb, gk_shots,
                                        lapc + kk * ns * F, ybar, nt_pad, geo,
                                        c * KC + kk, nz, nx);
      LAUNCHED();
      float* tmp = pin;
      pin = pout;
      pout = tmp;
    }
  }
  sum_pairs<<<(unsigned)((F + 255) / 256), 256, 0, st>>>(gk_shots, npair, F,
                                                        gk_out);
  LAUNCHED();
  return cudaSuccess;
}

}  // extern "C"
