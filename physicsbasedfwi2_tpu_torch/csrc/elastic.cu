// Fused elastic FWI loss+gradient kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   B3  b3_fused_elastic_loss_grad  <- physicsbasedfwi2_tpu/ops/
//                                      pallas_elastic_fused.py
//                                      fused_elastic_loss_grad_meds / _kernel
// and runs its forward phases alone for the ring forward
//       b3_elastic_ring             <- the same file's simulate_elastic_ring
//                                      (a JAX scan of the same scheme)
//
// Scheme: the 5-field Virieux P-SV velocity-stress update with a
// multiplicative sponge `damp` (which also zeroes a 2-cell ring) and
// 4th-order staggered derivatives in grid units,
//     Dxf(f)[j] = C1 (f[j+1] - f[j]) + C2 (f[j+2] - f[j-1]),
// Dxb the same one cell back, Dzf/Dzb along rows (see
// ops/elastic_fused.py for the update).  The explosive source adds
// wav_t * dt/dx^2 * l2m[src] to sxx and szz; szz is zeroed on the
// free-surface row.
//
// Design.  Like csrc/scalar2.cu: the Pallas kernel keeps one shot's
// whole state (10 fields, a KC-step cache of 5 more, row buffers) in
// VMEM, far more than the 227 KB of shared memory a block has, so here
// every phase of a time step is one launch over all shots, one thread
// per cell of [ns, nz8, nx128], with the fields in global memory (at
// the slice shape a field is 0.98 MB for 5 shots, so the live state and
// the media stay in the 50 MB L2).  Each step splits into two phases
// whose reads and writes do not overlap, so the state is updated in
// place without double buffering:
//   forward  V: reads stress neighbours, writes its own vx, vz;
//            S: reads the new velocity neighbours, writes its own
//               sxx, szz, sxz;
//   adjoint  A: injects the receiver cotangent, reads the stress
//               cotangents' neighbours, writes its own Vx, Vz (and
//               accumulates dJ/dbx, dJ/dbz);
//            B: reads the new Vx, Vz neighbours, writes its own Sxx,
//               Szz, Sxz (and accumulates dJ/dlam, dJ/dl2m, dJ/dmuxz,
//               with the source-gain term on l2m at the source cell).
// The checkpoint interval KC and the layouts of the checkpoints
// [n_ck, ns, 5, F] and the cache [KC, ns, 5, F] are this port's own;
// results differ from the Pallas kernel only by rounding.
//
// Boundaries: Pallas reads neighbours with circular rolls; the zero
// ring keeps every field (and cotangent) zero within 2 cells of the
// array edge, so reading 0 outside the array gives the same values.
//
// Determinism: no atomics.  The five gradients are accumulated per shot
// and summed over shots in order; the loss per (component, shot,
// column) in double, summed in order by one thread.
//
// What bounds it on the H100 (PERF.md has the arithmetic): the function
// needs about 68 flops per cell-step forward and 99 adjoint, 1.2e11
// flop at the slice shape (5 shots, 122 x 340 padded, nt 3334), 1.7 ms
// at 67 TFLOP/s of float32; its inputs and outputs are ~53 MB, 16 us
// at 3.35 TB/s.  So the function is compute-bound.  This kernel is the
// simple version: 4 launches per time step (2 forward, 2 adjoint) and
// 2 more per step of the checkpointed forward sweep, ~20 k launches per
// call.  Prediction, written before the first run on the card: at the
// 2.7-3.5 us launch floor measured for csrc/scalar2.cu plus a few us of
// L2 traffic per phase, 50-100 ms per call, bound by launches, 30-60x
// above the compute bound.  Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md): 125-162 ms, the card idle 23 % of a call between
// launches.  A persistent or cluster-tiled design is later work.

#include <cuda_runtime.h>

#include <initializer_list>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr float kC1 = 9.0f / 8.0f;
constexpr float kC2 = -1.0f / 24.0f;
constexpr float kEps = 1e-10f;
enum { VX = 0, VZ, SXX, SZZ, SXZ };           // state / cotangent fields
enum { LAM = 0, L2M, MUXZ, BXX, BZZ };        // media / gradients
enum { T1 = 0, T2, CA, CB, CC };              // cached derivative terms

struct Dims {
  int ns, nz, nx;
  long long F;  // nz * nx
};

__device__ __forceinline__ float ld0(const float* f, int i, int j,
                                     const Dims& d) {
  return (i >= 0 && i < d.nz && j >= 0 && j < d.nx) ? f[i * d.nx + j]
                                                     : 0.0f;
}

// staggered derivatives of a field read with zeros outside the array,
// in the operation order of pallas_kernels._dx_fwd and the others
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

struct Src {
  const int* src_z;
  const int* src_x;
  const int* rcv_row;
  const float* gain;  // [ns] dt/dx^2 l2m[src]
  const float* wav;   // [ns, nt_wav]
  int nt_wav;
};

#define CELL_INDEX                                  \
  const int j = blockIdx.x * BX + threadIdx.x;      \
  const int i = blockIdx.y * BY + threadIdx.y;      \
  const int s = blockIdx.z;                         \
  if (i >= d.nz || j >= d.nx) return;               \
  const int idx = i * d.nx + j;                     \
  const long long F = d.F;

// Forward phase V.  state [ns, 5, F]; cache (optional) [ns, 5, F] gets
// t1, t2; hist (optional) [2, ns, nt_rows, nx] gets the receiver rows of
// vx', vz' for t < nt_valid.
__global__ void el_fwd_v(const float* __restrict__ med,
                         const float* __restrict__ damp, float* state,
                         float* __restrict__ cache, float* __restrict__ hist,
                         Src src, int t, int nt_rows, int nt_valid, Dims d,
                         float dtx) {
  CELL_INDEX
  float* st = state + s * 5 * F;
  const float* sxx = st + SXX * F;
  const float* szz = st + SZZ * F;
  const float* sxz = st + SXZ * F;
  const float dm = damp[idx];
  const float t1 = dxf(sxx, i, j, d) + dzb(sxz, i, j, d);
  const float vx = dm * (st[VX * F + idx] + dtx * med[BXX * F + idx] * t1);
  const float t2 = dxb(sxz, i, j, d) + dzf(szz, i, j, d);
  const float vz = dm * (st[VZ * F + idx] + dtx * med[BZZ * F + idx] * t2);
  st[VX * F + idx] = vx;
  st[VZ * F + idx] = vz;
  if (cache) {
    float* c = cache + s * 5 * F;
    c[T1 * F + idx] = t1;
    c[T2 * F + idx] = t2;
  }
  if (hist && i == src.rcv_row[s] && t < nt_valid) {
    const long long r = ((long long)s * nt_rows + t) * d.nx + j;
    hist[r] = vx;
    hist[(long long)d.ns * nt_rows * d.nx + r] = vz;
  }
}

// Forward phase S.  cache (optional) gets a, b, c.
__global__ void el_fwd_s(const float* __restrict__ med,
                         const float* __restrict__ damp, float* state,
                         float* __restrict__ cache, Src src, int t,
                         int fs_row, Dims d, float dtx) {
  CELL_INDEX
  float* st = state + s * 5 * F;
  const float* vx = st + VX * F;
  const float* vz = st + VZ * F;
  const float lam = med[LAM * F + idx];
  const float l2m = med[L2M * F + idx];
  const float dm = damp[idx];
  const float a = dxb(vx, i, j, d);
  const float b = dzb(vz, i, j, d);
  float sxx = dm * (st[SXX * F + idx] + dtx * (l2m * a + lam * b));
  float szz = dm * (st[SZZ * F + idx] + dtx * (lam * a + l2m * b));
  if (i == src.src_z[s] && j == src.src_x[s]) {
    const float amp = src.wav[(long long)s * src.nt_wav + t] * src.gain[s];
    sxx += amp;
    szz += amp;
  }
  if (i == fs_row) szz = 0.0f;
  const float cc = dxf(vz, i, j, d) + dzf(vx, i, j, d);
  const float sxz =
      dm * (st[SXZ * F + idx] + dtx * med[MUXZ * F + idx] * cc);
  st[SXX * F + idx] = sxx;
  st[SZZ * F + idx] = szz;
  st[SXZ * F + idx] = sxz;
  if (cache) {
    float* c = cache + s * 5 * F;
    c[CA * F + idx] = a;
    c[CB * F + idx] = b;
    c[CC * F + idx] = cc;
  }
}

// Adjoint helpers: the cotangents flowing into the velocities from the
// stress updates, at a (possibly out-of-range) cell (0 outside).
//   cbar = dtx muxz damp Sxz
//   abar = dtx lam damp w4 + dtx l2m damp Sxx,  w4 = fs Szz
//   bbar = dtx l2m damp w4 + dtx lam damp Sxx
struct AdjIn {
  const float* med;
  const float* damp;
  const float* cot;  // this shot's [5, F]
  int fs_row;
  float dtx;
};

__device__ __forceinline__ float cbar_at(const AdjIn& q, int i, int j,
                                         const Dims& d) {
  if (i < 0 || i >= d.nz || j < 0 || j >= d.nx) return 0.0f;
  const int k = i * d.nx + j;
  return q.dtx * q.med[MUXZ * d.F + k] * (q.damp[k] * q.cot[SXZ * d.F + k]);
}

__device__ __forceinline__ float abar_at(const AdjIn& q, int i, int j,
                                         const Dims& d, bool want_a) {
  if (i < 0 || i >= d.nz || j < 0 || j >= d.nx) return 0.0f;
  const int k = i * d.nx + j;
  const float dm = q.damp[k];
  const float w4 = i == q.fs_row ? 0.0f : q.cot[SZZ * d.F + k];
  const float sxx = q.cot[SXX * d.F + k];
  const float lam = q.med[LAM * d.F + k];
  const float l2m = q.med[L2M * d.F + k];
  return want_a ? q.dtx * lam * dm * w4 + q.dtx * l2m * dm * sxx
                : q.dtx * l2m * dm * w4 + q.dtx * lam * dm * sxx;
}

// Adjoint phase A at time t.  ybar [2, ns, nt_rows, nx] holds the
// receiver-row cotangents of every step, the padded steps t >= nt
// included, as the Pallas kernel injects them (zero for l2; for tnl1
// zero unless the observed rows are nonzero there).
__global__ void el_adj_v(const float* __restrict__ med,
                         const float* __restrict__ damp, float* cot,
                         const float* __restrict__ cache,
                         const float* __restrict__ ybar,
                         float* __restrict__ gmed, Src src, int t,
                         int nt_rows, int fs_row, Dims d, float dtx) {
  CELL_INDEX
  float* cs = cot + s * 5 * F;
  const AdjIn q{med, damp, cs, fs_row, dtx};
  float vx = cs[VX * F + idx];
  float vz = cs[VZ * F + idx];
  if (i == src.rcv_row[s]) {
    const long long r = ((long long)s * nt_rows + t) * d.nx + j;
    vx += ybar[r];
    vz += ybar[(long long)d.ns * nt_rows * d.nx + r];
  }
  // Vz -= Dxb(cbar); Vx -= Dzb(cbar)
  vz -= kC1 * (cbar_at(q, i, j, d) - cbar_at(q, i, j - 1, d)) +
        kC2 * (cbar_at(q, i, j + 1, d) - cbar_at(q, i, j - 2, d));
  vx -= kC1 * (cbar_at(q, i, j, d) - cbar_at(q, i - 1, j, d)) +
        kC2 * (cbar_at(q, i + 1, j, d) - cbar_at(q, i - 2, j, d));
  // Vx -= Dxf(abar); Vz -= Dzf(bbar)
  vx -= kC1 * (abar_at(q, i, j + 1, d, true) - abar_at(q, i, j, d, true)) +
        kC2 * (abar_at(q, i, j + 2, d, true) - abar_at(q, i, j - 1, d, true));
  vz -= kC1 * (abar_at(q, i + 1, j, d, false) - abar_at(q, i, j, d, false)) +
        kC2 * (abar_at(q, i + 2, j, d, false) -
               abar_at(q, i - 1, j, d, false));
  const float dm = damp[idx];
  const float w1 = dm * vx;
  const float w2 = dm * vz;
  cs[VX * F + idx] = w1;
  cs[VZ * F + idx] = w2;
  const float* c = cache + s * 5 * F;
  float* g = gmed + s * 5 * F;
  g[BZZ * F + idx] += dtx * c[T2 * F + idx] * w2;
  g[BXX * F + idx] += dtx * c[T1 * F + idx] * w1;
}

// dtx * b * W at a (possibly out-of-range) cell, W the new velocity
// cotangent (t1bar with bx and Vx, t2bar with bz and Vz)
__device__ __forceinline__ float tbar_at(const float* b, const float* w,
                                         float dtx, int i, int j,
                                         const Dims& d) {
  if (i < 0 || i >= d.nz || j < 0 || j >= d.nx) return 0.0f;
  const int k = i * d.nx + j;
  return dtx * b[k] * w[k];
}

// Adjoint phase B at time t (wav_t unscaled).
__global__ void el_adj_s(const float* __restrict__ med,
                         const float* __restrict__ damp, float* cot,
                         const float* __restrict__ cache,
                         float* __restrict__ gmed, Src src, int t,
                         int fs_row, Dims d, float dtx, float dt_invdx2) {
  CELL_INDEX
  float* cs = cot + s * 5 * F;
  const float* c = cache + s * 5 * F;
  float* g = gmed + s * 5 * F;
  const float dm = damp[idx];
  const float sxx = cs[SXX * F + idx];
  const float szz = cs[SZZ * F + idx];
  const float w4 = i == fs_row ? 0.0f : szz;
  const float w5 = dm * cs[SXZ * F + idx];
  const float a = c[CA * F + idx];
  const float b = c[CB * F + idx];
  g[MUXZ * F + idx] += dtx * c[CC * F + idx] * w5;
  float glam = g[LAM * F + idx];
  float gl2m = g[L2M * F + idx];
  glam += dtx * a * dm * w4;
  gl2m += dtx * b * dm * w4;
  gl2m += dtx * a * dm * sxx;
  glam += dtx * b * dm * sxx;
  if (i == src.src_z[s] && j == src.src_x[s])
    gl2m += src.wav[(long long)s * src.nt_wav + t] * dt_invdx2 * (sxx + w4);
  g[LAM * F + idx] = glam;
  g[L2M * F + idx] = gl2m;
  const float* bx = med + BXX * F;
  const float* bz = med + BZZ * F;
  const float* Vx = cs + VX * F;
  const float* Vz = cs + VZ * F;
  // Sxz = w5 - Dxf(t2bar) - Dzf(t1bar); Szz = damp w4 - Dzb(t2bar);
  // Sxx = damp Sxx - Dxb(t1bar)
  float nsxz = w5;
  nsxz -= kC1 * (tbar_at(bz, Vz, dtx, i, j + 1, d) -
                 tbar_at(bz, Vz, dtx, i, j, d)) +
          kC2 * (tbar_at(bz, Vz, dtx, i, j + 2, d) -
                 tbar_at(bz, Vz, dtx, i, j - 1, d));
  const float nszz =
      dm * w4 - (kC1 * (tbar_at(bz, Vz, dtx, i, j, d) -
                        tbar_at(bz, Vz, dtx, i - 1, j, d)) +
                 kC2 * (tbar_at(bz, Vz, dtx, i + 1, j, d) -
                        tbar_at(bz, Vz, dtx, i - 2, j, d)));
  const float nsxx =
      dm * sxx - (kC1 * (tbar_at(bx, Vx, dtx, i, j, d) -
                         tbar_at(bx, Vx, dtx, i, j - 1, d)) +
                  kC2 * (tbar_at(bx, Vx, dtx, i, j + 1, d) -
                         tbar_at(bx, Vx, dtx, i, j - 2, d)));
  nsxz -= kC1 * (tbar_at(bx, Vx, dtx, i + 1, j, d) -
                 tbar_at(bx, Vx, dtx, i, j, d)) +
          kC2 * (tbar_at(bx, Vx, dtx, i + 2, j, d) -
                 tbar_at(bx, Vx, dtx, i - 1, j, d));
  cs[SXX * F + idx] = nsxx;
  cs[SZZ * F + idx] = nszz;
  cs[SXZ * F + idx] = nsxz;
}

__device__ __forceinline__ float sgn(float x) {  // jnp.sign: sign(0) = 0
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Misfit and its cotangent rows, one thread per (component, shot,
// column); the cotangent overwrites the history.
//   l2:   d = (y - obs) mask (t < nt_valid),  loss += d^2,  ybar = 2 d / n
//   tnl1: four sweeps (max; ties; loss and S; cotangent) as in
//         csrc/scalar2.cu's misfit_cols, dividing y by (m + eps) as
//         trace_normalize does (pallas_elastic_fused.py:318-321)
__global__ void el_misfit_cols(float* __restrict__ hist,
                               const float* __restrict__ obs_x,
                               const float* __restrict__ obs_z,
                               const float* __restrict__ rmask, int ns,
                               int nt_rows, int nt_valid, int nx,
                               float inv_count, int tnl1,
                               double* __restrict__ loss_part) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  const int comp = blockIdx.z;
  if (j >= nx || s >= ns) return;
  const long long base = (long long)s * nt_rows * nx + j;
  float* y = hist + (long long)comp * ns * nt_rows * nx + base;
  const float* ob = (comp ? obs_z : obs_x) + base;
  const float mk = rmask[s * nx + j];
  double loss = 0.0;
  if (!tnl1) {
    const float two_n = 2.0f * inv_count;
    for (int t = 0; t < nt_rows; ++t) {
      const long long q = (long long)t * nx;
      const float dd = t < nt_valid ? (y[q] - ob[q]) * mk : 0.0f;
      loss += (double)dd * dd;
      y[q] = two_n * dd;
    }
  } else {
    float m = 0.0f;
    for (int t = 0; t < nt_rows; ++t)
      m = fmaxf(m, fabsf(y[(long long)t * nx]));
    const float den = m + kEps;
    const float inv_m = 1.0f / den;
    float cnt = 0.0f;
    for (int t = 0; t < nt_rows; ++t)
      cnt += fabsf(y[(long long)t * nx]) == m ? 1.0f : 0.0f;
    const float inv_cnt = 1.0f / fmaxf(cnt, 1.0f);
    float S = 0.0f;
    for (int t = 0; t < nt_rows; ++t) {
      const long long q = (long long)t * nx;
      const float yn = __fdiv_rn(y[q], den);
      const float r = (yn - ob[q]) * mk;
      loss += fabsf(r);
      S += sgn(r) * inv_count * yn;
    }
    const float corr = inv_cnt * S * inv_m;
    for (int t = 0; t < nt_rows; ++t) {
      const long long q = (long long)t * nx;
      const float yk = y[q];
      const float yn = __fdiv_rn(yk, den);
      const float g = sgn((yn - ob[q]) * mk) * inv_count;
      const float star = fabsf(yk) == m ? 1.0f : 0.0f;
      y[q] = g * inv_m - star * sgn(yk) * corr;
    }
  }
  loss_part[((long long)comp * ns + s) * nx + j] = loss;
}

__global__ void sum_loss(const double* __restrict__ part, int n,
                         float inv_count, float* __restrict__ out) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    double acc = 0.0;
    for (int k = 0; k < n; ++k) acc += part[k];
    out[0] = (float)(acc * inv_count);
  }
}

// out[f, q] = sum_s per_shot[s, f, q], in shot order
__global__ void sum_shots5(const float* __restrict__ per_shot, int ns,
                           long long F, float* __restrict__ out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= 5 * F) return;
  float acc = 0.0f;
  for (int s = 0; s < ns; ++s) acc += per_shot[s * 5 * F + q];
  out[q] = acc;
}

inline dim3 cell_grid(const Dims& d) {
  return dim3((d.nx + BX - 1) / BX, (d.nz + BY - 1) / BY, d.ns);
}

}  // namespace

#define RET_IF(expr)                    \
  do {                                  \
    cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)
#define LAUNCHED() RET_IF(cudaGetLastError())

extern "C" {

// Ring forward: hist[2, ns, nt, nx] receives the receiver rows of vx and
// vz every step.  state [ns, 5, nz, nx] is scratch.
int b3_elastic_ring(const float* med, const float* damp, const float* wav,
                    const int* src_z, const int* src_x, const int* rcv_row,
                    const float* gain, float* state, float* hist, int ns,
                    int nz, int nx, int nt, int nt_wav, int fs_row,
                    float dtx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims d{ns, nz, nx, (long long)nz * nx};
  RET_IF(cudaMemsetAsync(state, 0, sizeof(float) * 5 * ns * d.F, st));
  RET_IF(cudaMemsetAsync(hist, 0, sizeof(float) * 2 * (size_t)ns * nt * nx,
                         st));
  const Src src{src_z, src_x, rcv_row, gain, wav, nt_wav};
  const dim3 grid = cell_grid(d), block(BX, BY);
  for (int t = 0; t < nt; ++t) {
    el_fwd_v<<<grid, block, 0, st>>>(med, damp, state, nullptr, hist, src, t,
                                     nt, nt, d, dtx);
    LAUNCHED();
    el_fwd_s<<<grid, block, 0, st>>>(med, damp, state, nullptr, src, t,
                                     fs_row, d, dtx);
    LAUNCHED();
  }
  return cudaSuccess;
}

// B3: fused loss and dJ/d(lam, l2m, muxz, bx, bz).
//   med [5, nz, nx]; damp [nz, nx]; wav [ns, n_ck*KC] (zero past nt);
//   obs_x, obs_z [ns, n_ck*KC, nx]; rmask [ns, nx];
//   state, cot, gmed_shots [ns, 5, nz, nx]; ckpt [n_ck, ns, 5, nz, nx];
//   cache [KC, ns, 5, nz, nx]; hist [2, ns, n_ck*KC, nx];
//   loss_part [2, ns, nx] doubles; loss_out [1]; gmed_out [5, nz, nx].
int b3_fused_elastic_loss_grad(
    const float* med, const float* damp, const float* wav, const int* src_z,
    const int* src_x, const int* rcv_row, const float* gain,
    const float* obs_x, const float* obs_z, const float* rmask, float* state,
    float* cot, float* ckpt, float* cache, float* hist, float* gmed_shots,
    double* loss_part, float* loss_out, float* gmed_out, int ns, int nz,
    int nx, int nt, int n_ck, int KC, int fs_row, int tnl1, float dtx,
    float dt_invdx2, float inv_count, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Dims d{ns, nz, nx, (long long)nz * nx};
  const int nt_pad = n_ck * KC;
  const size_t sbytes = sizeof(float) * 5 * (size_t)ns * d.F;
  const long long sfloats = 5LL * ns * d.F;
  for (float* p : {state, cot, gmed_shots})
    RET_IF(cudaMemsetAsync(p, 0, sbytes, st));
  RET_IF(cudaMemsetAsync(hist, 0,
                         sizeof(float) * 2 * (size_t)ns * nt_pad * nx, st));
  const Src src{src_z, src_x, rcv_row, gain, wav, nt_pad};
  const dim3 grid = cell_grid(d), block(BX, BY);

  // phase 1: forward sweep, a checkpoint every KC steps, receiver rows
  for (int c = 0; c < n_ck; ++c) {
    RET_IF(cudaMemcpyAsync(ckpt + c * sfloats, state, sbytes,
                           cudaMemcpyDeviceToDevice, st));
    for (int kk = 0; kk < KC; ++kk) {
      const int t = c * KC + kk;
      el_fwd_v<<<grid, block, 0, st>>>(med, damp, state, nullptr, hist, src,
                                       t, nt_pad, nt, d, dtx);
      LAUNCHED();
      el_fwd_s<<<grid, block, 0, st>>>(med, damp, state, nullptr, src, t,
                                       fs_row, d, dtx);
      LAUNCHED();
    }
  }

  // phase 2: misfit, loss partials and the cotangent rows (over hist)
  el_misfit_cols<<<dim3((nx + 127) / 128, ns, 2), 128, 0, st>>>(
      hist, obs_x, obs_z, rmask, ns, nt_pad, nt, nx, inv_count, tnl1,
      loss_part);
  LAUNCHED();

  // phase 3: reverse sweep, chunk by chunk from the checkpoints
  for (int c = n_ck - 1; c >= 0; --c) {
    RET_IF(cudaMemcpyAsync(state, ckpt + c * sfloats, sbytes,
                           cudaMemcpyDeviceToDevice, st));
    for (int kk = 0; kk < KC; ++kk) {
      const int t = c * KC + kk;
      float* ck = cache + kk * sfloats;
      el_fwd_v<<<grid, block, 0, st>>>(med, damp, state, ck, nullptr, src, t,
                                       nt_pad, nt, d, dtx);
      LAUNCHED();
      el_fwd_s<<<grid, block, 0, st>>>(med, damp, state, ck, src, t, fs_row,
                                       d, dtx);
      LAUNCHED();
    }
    for (int kk = KC - 1; kk >= 0; --kk) {
      const int t = c * KC + kk;
      const float* ck = cache + kk * sfloats;
      el_adj_v<<<grid, block, 0, st>>>(med, damp, cot, ck, hist, gmed_shots,
                                       src, t, nt_pad, fs_row, d, dtx);
      LAUNCHED();
      el_adj_s<<<grid, block, 0, st>>>(med, damp, cot, ck, gmed_shots, src, t,
                                       fs_row, d, dtx, dt_invdx2);
      LAUNCHED();
    }
  }

  sum_shots5<<<(unsigned)((5 * d.F + 255) / 256), 256, 0, st>>>(
      gmed_shots, ns, d.F, gmed_out);
  LAUNCHED();
  sum_loss<<<1, 1, 0, st>>>(loss_part, 2 * ns * nx, inv_count, loss_out);
  LAUNCHED();
  return cudaSuccess;
}

}  // extern "C"
