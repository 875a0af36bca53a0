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
// VJP.  They run B2's own sweeps on either route (fwd_resident and
// rev_resident, or fwd_ckpt_sweep and reverse_sweep), so they cost what
// B2's phases cost: per step B4a is B1's step plus the checkpoint writes
// every KC steps, B4b B2's recompute and adjoint steps.
//
// The resident route of two more kernels lives here too, because it is
// B4's own sweeps:
//   B7a b7a_forward2b_resident   <- pallas_scalar2b.py forward2b /
//                                   _fwd_kernel
//   B7b b7b_backward2b_resident  <- pallas_scalar2b.py _backward2b /
//                                   _bwd_kernel
// And kernel B9, the forward sweep alone with its mechanisms switched on
// at compile time:
//   B9  b9_variant_resident      <- benchmarks/bench_kernel_breakdown.py
//                                   build_variant / _variant_kernel
// B9's instances b9_resident<flags> are the resident forward sweep
// (fwd_sweep, which fwd_resident<P> runs with its B9 flags 0) from a
// seeded field u0 = K 1e-3, with the raw amplitude added at the source,
// and with the source, the receiver rows and the checkpoints each a
// template flag, so that each variant's registers and time show what its
// mechanism costs.  Like B1 it is bound by the step's stencil work and
// its cluster barrier, not by its 5.7e10 flop (0.84 ms at the float32
// peak) or its bytes (the checkpoints' 0.89 GB, 0.27 ms).
//
// B7 computes per cell and per shot what B4 computes (ops/scalar2b.py).
// It differs in the checkpoint layout, shots in pairs [ns/2, n_ck, 2, 2,
// nz, nx] (the sweeps' template parameter P = 2, see ckpt_offset), in the
// gradient's shot sum, pairs first and then the pairs in order
// (sum_pairs), and in KC = 16.  Its per-step route is csrc/scalar2b.cu.
// Predicted before the first timed run, at marmousi_acoustic's shape (18
// shots, 192 x 256, nt 4001, KC 16; one wave of the 22 clusters resident;
// H100, 700 W): B7a ~11-13 ms (B4a's resident 10.5-10.9 plus twice B4a's
// checkpoint writes, 1.78 GB), B7b ~36-40 ms (B4b's resident 36.0-36.8;
// twice the restores, a 57 MB Laplacian cache), an acoustic_pallas2b
// FWI iteration ~0.050-0.055 s (from 0.1194-0.1201 on the per-step route).
//
// Scheme (K = (vp dt/dx)^2, d+ / d- the sponge factors with a 2-cell zero
// ring folded into d+):
//     u1 = d+ (2 u0 - d- u_-1 + K Lap4(u0)),  u1[src] += amp_t K[src]
// and the receiver row of u1 is recorded every step.
//
// Two routes run the same arithmetic; ops/scalar2.py picks one by shape
// before any launch (resident_plan) and counts each route's launches.
//
// Resident route (fwd_resident, rev_resident; the default where the plan
// fits).  The Pallas kernels keep one shot's whole grid on chip for the
// whole time loop, one program per shot.  Here one thread-block cluster
// of C CTAs holds one shot: CTA r owns a band of R rows (a multiple of 8;
// the last band may be shorter) across the full width, each thread a
// block of RPT = 5 rows of 4 columns (one float4).  Shared memory holds the
// band's K, d+ and d- and a double-buffered field (u0 forward, K w in the
// adjoint) with 2 halo rows above and below and zero columns each side;
// u_-1, and in the reverse sweep pb, qb and the shot's dJ/dK, stay in
// registers.  A step computes every owned cell from the current buffer,
// writes it to the other one and its 2 edge rows into the neighbours'
// halo rows through distributed shared memory, then passes one cluster
// barrier (arrive.release / wait.acquire, the receiver row's store
// between the two).  The top band's upper and the bottom band's lower
// halo stay zero, as ld0's zero reads and the Pallas rolls over the zero
// ring.  The plan is the smallest cluster whose bands fit.  At the
// flagship shape (18 shots, 192 x 256 padded) it is
// C = 5, R = 40, RPT = 5, 512 threads, 215,808 B of shared memory: the
// card keeps 22 such clusters resident, so all 18 shots run in one wave
// (6-CTA clusters of 32-row bands fit only 17: a cluster stays within
// one GPC).  Each kernel is one launch per sweep.  The reverse
// sweep restores each chunk's checkpoint into the band (halos from
// global memory), recomputes it writing Lap(u0) to a per-shot cache, and
// runs the adjoint steps; each thread reads back only its own cells of
// the cache.  Every route checkpoints at the caller's KC.  At 18 shots
// the cache is 113 MB at KC 32, more than the 50 MB L2, and 28 MB at KC
// 8, which holds 4x the checkpoints; on an H100 80GB HBM3 at 700 W B2
// took 45.7 ms at KC 32 and 47.5-48.0 at KC 8, with 1.0 and 3.4 GiB
// above its inputs (chip_smoke.py, both in turns; PERF.md).
//
// What bounds the resident route: a step is ~20 cells of shared-memory
// stencil work per thread at 16 warps an SM (one CTA: its shared memory
// and 128 registers a thread allow no more), then one cluster barrier;
// registers bound the reverse sweep (pb, qb, dJ/dK and the prefetched
// cache row: it spills a little, so phase B recomputes p and w rather
// than hold them).  Predicted before the first timed run (H100, 700 W):
// 1-2 us a step, B1 ~5-8 ms, B2 ~15-30 ms.  Measured (PERF.md):
// 2.6-2.8 us a forward step, ~6 us an adjoint step; B1 ~10.5 ms (per-step
// route ~30), B2 ~46 ms (~120), bit-equal to the per-step route.
//
// Per-step route (fwd_step, adj_step; grids the plan cannot hold, and
// kept as an entry point for comparison).  Every time step is one launch
// over all shots, one thread per cell of [ns, nz8, nx128], the fields in
// global memory (L2 resident at the flagship shape).  Measured on an
// H100 80GB HBM3 at 700 W (PERF.md), a step costs ~7.5 us (B1) and ~10
// us (B2): the step's L2 traffic and the 9 neighbour products of the
// adjoint bound it, launches take a third.
//
// Boundaries: Pallas reads neighbours with circular rolls; the zero ring in
// d+ keeps every field zero within 2 cells of the array edge, so reading 0
// outside the array gives the same values.  The tests hold the plain
// PyTorch versions (which use the same zero reads) against the Pallas
// kernels in interpret mode.
//
// Determinism: no atomics.  The gradient is accumulated per shot and the
// shots are summed in order afterwards; the loss is accumulated per
// (shot, column) in double, in a fixed order, and summed in order by one
// thread.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <initializer_list>

#include "cluster.cuh"

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

// Trace-normalized L1 misfit and its cotangent, four sweeps over each
// column's history (max; ties; loss and S; cotangent written over the
// history):
//   yn = y / (m + eps),  r = (yn - obs) mask,  g = sign(r) / count
//   ybar = g / (m + eps) - 1[|y| == m] sign(y) S / (cnt (m + eps))
// the exact jnp.max subgradient (pallas_fwi_fused.py:21-30).  A block
// takes 32 columns of one shot (coalesced rows) and spreads the rows over
// MF_ROWS thread rows; the per-thread partials are combined in a fixed
// order (max and the tie count exactly, loss and S in double), so the
// result is deterministic.  Both routes use it.  nx % 32 == 0.
constexpr int MF_COLS = 32;
constexpr int MF_ROWS = 16;

__global__ void __launch_bounds__(MF_COLS * MF_ROWS)
    misfit_tiles(float* __restrict__ hist, const float* __restrict__ obs,
                 const float* __restrict__ rmask, int nt_rows, int nx,
                 float inv_count, double* __restrict__ loss_part) {
  __shared__ float red_f[MF_ROWS][MF_COLS];
  __shared__ double red_d[2][MF_ROWS][MF_COLS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * MF_COLS + tx;
  const int s = blockIdx.y;
  const long long base = (long long)s * nt_rows * nx + j;
  float* y = hist + base;
  const float* ob = obs + base;
  float m = 0.0f;
  for (int t = ty; t < nt_rows; t += MF_ROWS)
    m = fmaxf(m, fabsf(y[(long long)t * nx]));
  red_f[ty][tx] = m;
  __syncthreads();
  m = red_f[0][tx];
  for (int k = 1; k < MF_ROWS; ++k) m = fmaxf(m, red_f[k][tx]);
  __syncthreads();
  const float inv_m = 1.0f / (m + kEps);
  float cnt = 0.0f;
  for (int t = ty; t < nt_rows; t += MF_ROWS)
    cnt += fabsf(y[(long long)t * nx]) == m ? 1.0f : 0.0f;
  red_f[ty][tx] = cnt;
  __syncthreads();
  cnt = red_f[0][tx];
  for (int k = 1; k < MF_ROWS; ++k) cnt += red_f[k][tx];
  const float inv_cnt = 1.0f / fmaxf(cnt, 1.0f);
  const float mk = rmask[s * nx + j];
  double loss = 0.0, S = 0.0;
  for (int t = ty; t < nt_rows; t += MF_ROWS) {
    const long long q = (long long)t * nx;
    const float yn = y[q] * inv_m;
    const float r = (yn - ob[q]) * mk;
    const float g = sgn(r) * inv_count;
    loss += fabsf(r);
    S += g * yn;
  }
  red_d[0][ty][tx] = loss;
  red_d[1][ty][tx] = S;
  __syncthreads();
  loss = red_d[0][0][tx];
  S = red_d[1][0][tx];
  for (int k = 1; k < MF_ROWS; ++k) {
    loss += red_d[0][k][tx];
    S += red_d[1][k][tx];
  }
  const float corr = inv_cnt * (float)S * inv_m;
  for (int t = ty; t < nt_rows; t += MF_ROWS) {
    const long long q = (long long)t * nx;
    const float yk = y[q];
    const float yn = yk * inv_m;
    const float g = sgn((yn - ob[q]) * mk) * inv_count;
    const float star = fabsf(yk) == m ? 1.0f : 0.0f;
    y[q] = g * inv_m - star * sgn(yk) * corr;
  }
  if (ty == 0) loss_part[s * nx + j] = loss;
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

// B7b's order (ops/scalar2b.py::_sum_pairs, the Pallas kernel's): the two
// shots of a pair first, then the pairs in order,
//   out = (g0 + g1) + (g2 + g3) + ...;  ns even.
__global__ void sum_pairs(const float* __restrict__ per_shot, int ns,
                          long long F, float* __restrict__ out) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= F) return;
  float acc = per_shot[q] + per_shot[F + q];
  for (int s = 2; s < ns; s += 2)
    acc = acc + (per_shot[s * F + q] + per_shot[(s + 1) * F + q]);
  out[q] = acc;
}

// ---------------------------------------------------------------------------
// Resident route: one thread-block cluster per shot (see the note above).
// Grid (C, ns), cluster (C, 1, 1): CTA r = blockIdx.x of shot blockIdx.y.
// Every thread reaches every cluster barrier; cells outside the band are
// predicated, never returned from.
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kResThreads = 512;  // at most: 128 registers a thread
constexpr int kVec = 4;           // columns a thread owns (one float4)
constexpr int kPadL = 4;          // zero columns left of column 0 (2 read)
constexpr int RPT = 5;            // rows a thread owns (ROWS_PER_THREAD)

__device__ __forceinline__ void ld4(float (&d)[kVec], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__device__ __forceinline__ void st4(float* p, const float (&s)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
}

// A CTA's band and its shared memory: two field buffers of (H + 4) x P
// floats (P = nx + 8; buffer row lr + 2 holds band row lr, column j + 4
// column j, so that every thread's 4 columns are one aligned float4; H =
// TY x RPT >= rows, the rows the threads cover), then K, d+ and d- of
// the band ([R, nx] each).  Thread (ty, x) owns rows i0 = ty RPT ..
// i0 + RPT - 1 of columns j0 = 4x .. j0 + 3.  Buffer k sits at offset
// k bsz, here and in the neighbours.
struct Band {
  int r, C, R, rows, row0, nz, nx, P, j0, i0, bsz;
  float* buf0;
  float* up0;  // the upper neighbour's buffer 0 (null for the top band)
  float* dn0;  // the lower neighbour's (null for the bottom band)
  float* Ks;
  float* dps;
  float* dms;
  __device__ float* buf(int k) const { return buf0 + k * bsz; }
  // offset of band row lr, own column 0, in a buffer
  __device__ int at(int lr) const { return (lr + 2) * P + j0 + kPadL; }
};

__device__ __forceinline__ Band make_band(float* smem, int R, int nz,
                                          int nx) {
  Band b;
  b.r = blockIdx.x;
  b.C = gridDim.x;
  b.R = R;
  b.nz = nz;
  b.nx = nx;
  b.P = nx + 2 * kPadL;
  b.row0 = b.r * R;
  b.rows = min(R, nz - b.row0);
  const int per_row = nx / kVec;
  b.j0 = (threadIdx.x % per_row) * kVec;
  b.i0 = (threadIdx.x / per_row) * RPT;
  b.bsz = ((blockDim.x / per_row) * RPT + 4) * b.P;
  b.buf0 = smem;
  b.Ks = smem + 2 * b.bsz;
  b.dps = b.Ks + R * nx;
  b.dms = b.dps + R * nx;
  cg::cluster_group cl = cg::this_cluster();
  b.up0 = b.r > 0 ? cl.map_shared_rank(smem, b.r - 1) : nullptr;
  b.dn0 = b.r + 1 < b.C ? cl.map_shared_rank(smem, b.r + 1) : nullptr;
  return b;
}

// Zero both buffers (halos, pad columns and rows past the band stay zero
// for good) and load the band's coefficients.  The caller then passes a
// cluster barrier before any neighbour writes into the halos.
__device__ __forceinline__ void band_init(const Band& b, const float* K,
                                          const float* dp, const float* dm) {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4* buf = reinterpret_cast<float4*>(b.buf0);
  for (int q = threadIdx.x; q < 2 * b.bsz / kVec; q += blockDim.x) buf[q] = z;
  const int off = b.row0 * b.nx;
  for (int q = threadIdx.x * kVec; q < b.rows * b.nx; q += blockDim.x * kVec) {
    *reinterpret_cast<float4*>(b.Ks + q) =
        *reinterpret_cast<const float4*>(K + off + q);
    *reinterpret_cast<float4*>(b.dps + q) =
        *reinterpret_cast<const float4*>(dp + off + q);
    *reinterpret_cast<float4*>(b.dms + q) =
        *reinterpret_cast<const float4*>(dm + off + q);
  }
}

// Write v (own 4 cells of band row lr) into buffer k and, for the band's
// 2 edge rows, into the neighbours' halo rows of their buffer k.
__device__ __forceinline__ void band_put(const Band& b, int k, int lr,
                                         const float (&v)[kVec]) {
  const int off = k * b.bsz + b.j0 + kPadL;
  st4(b.buf0 + off + (lr + 2) * b.P, v);
  if (lr < 2 && b.up0) st4(b.up0 + off + (b.R + 2 + lr) * b.P, v);
  if (lr >= b.rows - 2 && b.dn0) st4(b.dn0 + off + (lr - b.rows + 2) * b.P, v);
}

// Lap of the 4 own cells of band row i0 + c from buffer f: v holds the
// thread's columns of rows i0 - 2 .. i0 + RPT + 1 (v[c + 2] is row c),
// h the row's columns j0 - 2 .. j0 + 5.  Same summation order as lap4.
__device__ __forceinline__ void lap_row(float (&out)[kVec],
                                        const float (&v)[RPT + 4][kVec],
                                        const float* f, int c) {
  float h[kVec + 4];
  const float2 l = *reinterpret_cast<const float2*>(f - 2);
  const float2 r = *reinterpret_cast<const float2*>(f + kVec);
  h[0] = l.x;
  h[1] = l.y;
#pragma unroll
  for (int m = 0; m < kVec; ++m) h[m + 2] = v[c + 2][m];
  h[kVec + 2] = r.x;
  h[kVec + 3] = r.y;
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    const float s1 = h[m + 3] + h[m + 1] + v[c + 3][m] + v[c + 1][m];
    const float s2 = h[m + 4] + h[m] + v[c + 4][m] + v[c][m];
    out[m] = kL0 * h[m + 2] + kL1 * s1 + kL2 * s2;
  }
}

// One forward step of the band, as fwd_step: u0 from buffer n & 1 (halos
// included), u1 into buffer (n + 1) & 1 and the neighbours' halos; um1
// holds u_-1 on entry and u0 on exit; Lap(u0) into lap_out ([nz, nx],
// optional).  Same expressions as fwd_step.  (sc, sm): the source's row
// and column among the thread's cells (sc = -1: not this thread's).
// kHold keeps the new rows in registers until all are computed (all
// loads first); without it each row is stored at once, which saves
// registers where pb, qb and dJ/dK hold them (the reverse sweep).
// kRawSrc (kernel B9 only) adds the raw amplitude, amp, not amp K[src].
template <bool kHold, bool kRawSrc = false>
__device__ __forceinline__ void band_fwd_step(const Band& b, int n,
                                              float (&um1)[RPT][kVec],
                                              float amp, int sc, int sm,
                                              float* lap_out) {
  const float* cur = b.buf(n & 1);
  float v[RPT + 4][kVec];
  float u1[RPT][kVec];
#pragma unroll
  for (int c = 0; c < 4; ++c) ld4(v[c], cur + b.at(b.i0 + c - 2));
#pragma unroll
  for (int c = 0; c < RPT; ++c) {
    ld4(v[c + 4], cur + b.at(b.i0 + c + 2));
    const int lr = b.i0 + c;
    float lp[kVec], kk[kVec], dp[kVec], dm[kVec];
    lap_row(lp, v, cur + b.at(lr), c);
    if (lr < b.rows) {
      const int k = lr * b.nx + b.j0;
      ld4(kk, b.Ks + k);
      ld4(dp, b.dps + k);
      ld4(dm, b.dms + k);
#pragma unroll
      for (int m = 0; m < kVec; ++m) {
        float u = dp[m] * (2.0f * v[c + 2][m] - dm[m] * um1[c][m] + kk[m] * lp[m]);
        if (c == sc && m == sm) u += kRawSrc ? amp : amp * kk[m];
        u1[c][m] = u;
      }
      if (lap_out) st4(lap_out + (b.row0 + lr) * b.nx + b.j0, lp);
      if (!kHold) band_put(b, (n + 1) & 1, lr, u1[c]);
    }
#pragma unroll
    for (int m = 0; m < kVec; ++m) um1[c][m] = v[c + 2][m];
  }
  if (kHold) {
#pragma unroll
    for (int c = 0; c < RPT; ++c)
      if (b.i0 + c < b.rows) band_put(b, (n + 1) & 1, b.i0 + c, u1[c]);
  }
}

// (row, column) of global cell (gi, gj) among the thread's cells, or -1.
__device__ __forceinline__ void own_cell(const Band& b, int rpt, int gi,
                                         int gj, int& c, int& m) {
  const int lr = gi - b.row0;
  const bool mine = lr >= 0 && lr < b.rows && lr >= b.i0 && lr < b.i0 + rpt &&
                    gj >= b.j0 && gj < b.j0 + kVec;
  c = mine ? lr - b.i0 : -1;
  m = mine ? gj - b.j0 : -1;
}

// The adjoint step's p = pb (+ the cotangent row on the receiver row)
// and w = d+ p for the 4 own cells of band row lr, as adj_step.
__device__ __forceinline__ void adj_pw(const Band& b, int lr, int lrr,
                                       const float* yrow,
                                       const float (&pbc)[kVec],
                                       float (&p)[kVec], float (&w)[kVec]) {
  float dp[kVec];
#pragma unroll
  for (int m = 0; m < kVec; ++m) p[m] = pbc[m];
  if (yrow && lr == lrr) {
    float y[kVec];
    ld4(y, yrow);
#pragma unroll
    for (int m = 0; m < kVec; ++m) p[m] = p[m] + y[m];
  }
  ld4(dp, b.dps + lr * b.nx + b.j0);
#pragma unroll
  for (int m = 0; m < kVec; ++m) w[m] = dp[m] * p[m];
}

// Offset of shot s's u0 at checkpoint c in a buffer of (u0, u_-1) whose
// shots are grouped P at a time, [ns/P, n_ck, 2, P, nz, nx] (F = nz nx);
// its u_-1 sits P F further on.  P = 1 is B2's and B4's [ns, n_ck, 2, nz,
// nx], P = 2 B7's shot pairs (ops/scalar2b.py::ckpt_offset is the same
// formula, and tests/test_torch_pair_resident.py holds it to the layout).
// A template parameter of the sweeps, so that their P = 1 instances are
// the code they were before B7 shared them; used once per chunk.
template <int P>
__device__ __forceinline__ long long ckpt_offset(int s, int c, int n_ck,
                                                 long long F) {
  return (((long long)(s / P) * n_ck + c) * 2 * P + s % P) * F;
}

struct FwdArgs {
  const float* K;
  const float* dp;
  const float* dm;
  Geom geo;
  float* hist;       // row t of [ns, nt_rows, nx] for t < nt_valid
  const float* dir;  // subtracted from the row (optional)
  int nt_rows, nt_valid;
  float* ckpt;  // (u0, u_-1) before step c KC at ckpt_offset<P>, or null
  int KC, n_ck, nsteps, nz, nx, R;
};

// Kernel B9's variants (benchmarks/bench_kernel_breakdown.py
// build_variant / _variant_kernel): flags of fwd_sweep's kB9.  kB9On
// starts from the seeded field u0 = K * kB9Seed (u_-1 = 0) and adds the
// raw amplitude at the source; kB9Src, kB9Rcv and kB9Ckpt switch the
// source, the receiver rows and the checkpoints on at compile time, as
// the TPU kernel switches them statically.
constexpr int kB9On = 1, kB9Src = 2, kB9Rcv = 4, kB9Ckpt = 8;
constexpr float kB9Seed = 1e-3f;

// B9's extra outputs: the final (u0, u_-1) [ns, 2, nz, nx] (or null) and
// each shot's sum of u0[:8, :128] at the end, corner [ns].
struct B9Out {
  float* fin;
  float* corner;
};

// B9's start: buffer 0 holds K * kB9Seed on the band's rows and on the 2
// halo rows each side that lie inside the array (the values the
// neighbours would write there), zero elsewhere.  After band_init, whose
// stores it follows behind a CTA barrier; the caller's cluster barrier
// comes next.
__device__ __forceinline__ void band_seed(const Band& b, const float* K) {
  __syncthreads();
  const int per_row = b.nx / kVec;
  for (int q = threadIdx.x; q < (b.rows + 4) * per_row; q += blockDim.x) {
    const int lr = q / per_row - 2;
    const int j = (q % per_row) * kVec;
    const int gi = b.row0 + lr;
    if (gi < 0 || gi >= b.nz) continue;
    float k[kVec];
    ld4(k, K + (long long)gi * b.nx + j);
#pragma unroll
    for (int m = 0; m < kVec; ++m) k[m] = k[m] * kB9Seed;
    st4(b.buf0 + (lr + 2) * b.P + j + kPadL, k);
  }
}

// B9's end: the final fields of the thread's cells into out.fin, and in
// the top band (rows 0-7 lie in it: R >= 8) warp 0's sum of u0[:8, :128]
// into out.corner[s]: lane l sums the cells l, l + 32, ... of the 1024 in
// row-major order, then a fixed butterfly; the same bits every run.
__device__ __forceinline__ void b9_epilogue(const Band& b, const B9Out& out,
                                            int s, int n,
                                            const float (&um1)[RPT][kVec]) {
  const float* cur = b.buf(n & 1);
  if (out.fin) {
    const long long F = (long long)b.nz * b.nx;
    float* f0 = out.fin + 2 * s * F;
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      const int lr = b.i0 + c;
      if (lr < b.rows) {
        const long long g = (long long)(b.row0 + lr) * b.nx + b.j0;
        float u[kVec];
        ld4(u, cur + b.at(lr));
        st4(f0 + g, u);
        st4(f0 + F + g, um1[c]);
      }
    }
  }
  if (b.r == 0 && threadIdx.x < 32) {
    float acc = 0.0f;
    for (int q = threadIdx.x; q < 8 * 128; q += 32)
      acc += cur[(q / 128 + 2) * b.P + q % 128 + kPadL];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (threadIdx.x == 0) out.corner[s] = acc;
  }
}

// Forward sweep of nsteps steps from zero fields: B1, B4a and B2's phase 1
// (P = 1), B7a (P = 2: the checkpoints in shot pairs); with kB9 != 0
// kernel B9's variant kB9 (P = 1), from B9's seeded field.  The kB9 = 0
// instances are the production sweep (every kB9 branch compiles away).
template <int P, int kB9>
__device__ __forceinline__ void fwd_sweep(FwdArgs a, B9Out o) {
  constexpr bool b9 = kB9 & kB9On;
  constexpr bool src_on = !b9 || (kB9 & kB9Src);
  constexpr bool rcv_on = !b9 || (kB9 & kB9Rcv);
  constexpr bool ckpt_on = !b9 || (kB9 & kB9Ckpt);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s = blockIdx.y;
  const Band b = make_band(smem, a.R, a.nz, a.nx);
  band_init(b, a.K, a.dp, a.dm);
  if constexpr (b9) band_seed(b, a.K);
  cg::this_cluster().sync();
  const long long F = (long long)a.nz * a.nx;
  int sc, sm;
  own_cell(b, RPT, a.geo.src_z[s], a.geo.src_x[s], sc, sm);
  if constexpr (!src_on) sc = -1;
  const int lrr = a.geo.rcv_row[s] - b.row0;  // receiver row in the band
  const bool has_rcv = lrr >= 0 && lrr < b.rows && lrr >= b.i0 &&
                       lrr < b.i0 + RPT;
  const float* wav = a.geo.wav + (long long)s * a.geo.nt_wav;
  float um1[RPT][kVec];
#pragma unroll
  for (int c = 0; c < RPT; ++c)
#pragma unroll
    for (int m = 0; m < kVec; ++m) um1[c][m] = 0.0f;
  for (int t = 0; t < a.nsteps; ++t) {
    if (ckpt_on && a.ckpt && t % a.KC == 0) {
      float* ck = a.ckpt + ckpt_offset<P>(s, t / a.KC, a.n_ck, F);
      const float* cur = b.buf(t & 1);
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        const int lr = b.i0 + c;
        if (lr < b.rows) {
          const long long g = (long long)(b.row0 + lr) * a.nx + b.j0;
          float u[kVec];
          ld4(u, cur + b.at(lr));
          st4(ck + g, u);
          st4(ck + P * F + g, um1[c]);
        }
      }
    }
    const float amp = sc >= 0 ? wav[t] : 0.0f;
    band_fwd_step<true, b9>(b, t, um1, amp, sc, sm, nullptr);
    cluster_arrive();
    if (rcv_on && a.hist && has_rcv && t < a.nt_valid) {
      float u[kVec];
      ld4(u, b.buf((t + 1) & 1) + b.at(lrr));
      const long long q = ((long long)s * a.nt_rows + t) * a.nx + b.j0;
      if (a.dir) {
        float d[kVec];
        ld4(d, a.dir + q);
#pragma unroll
        for (int m = 0; m < kVec; ++m) u[m] = u[m] - d[m];
      }
      st4(a.hist + q, u);
    }
    cluster_wait();
  }
  cg::this_cluster().sync();
  if constexpr (b9) b9_epilogue(b, o, s, a.nsteps, um1);
}

template <int P>
__global__ void __launch_bounds__(kResThreads, 1) fwd_resident(FwdArgs a) {
  fwd_sweep<P, 0>(a, B9Out{nullptr, nullptr});
}

struct B9Args {
  FwdArgs f;
  B9Out o;
};

// Kernel B9: variant kFlags (kB9Src | kB9Rcv | kB9Ckpt) of the sweep.
template <int kFlags>
__global__ void __launch_bounds__(kResThreads, 1) b9_resident(B9Args a) {
  fwd_sweep<1, kB9On | kFlags>(a.f, a.o);
}

// chk[0] = the shots' corner sums added in shot order (the TPU kernel
// adds each grid step's into chk_out[0, 0] in turn).
__global__ void b9_chk(const float* __restrict__ corner, int ns,
                       float* __restrict__ chk) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float acc = 0.0f;
    for (int s = 0; s < ns; ++s) acc += corner[s];
    chk[0] = acc;
  }
}

struct RevArgs {
  const float* K;
  const float* dp;
  const float* dm;
  Geom geo;
  const float* ybar;  // cotangent rows [ns, nt_rows, nx], t < nt_valid
  int nt_rows, nt_valid;
  const float* ckpt;  // (u0, u_-1) of chunk c at ckpt_offset<P>
  int n_ck, KC;
  float* lapc;      // [ns, KC, nz, nx] scratch
  float* gk_shots;  // [ns, nz, nx] dJ/dK per shot
  float* gwav;      // [ns, nt_wav] dJ/d amp_t, or null
  int nz, nx, R;
};

// Reverse sweep, chunk by chunk from the checkpoints (last first): B4b
// and B2's phase 3 (P = 1), B7b (P = 2).  pb, qb and the shot's dJ/dK
// stay in registers.
template <int P>
__global__ void __launch_bounds__(kResThreads, 1) rev_resident(RevArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s = blockIdx.y;
  const Band b = make_band(smem, a.R, a.nz, a.nx);
  band_init(b, a.K, a.dp, a.dm);
  const long long F = (long long)a.nz * a.nx;
  int sc, sm;
  own_cell(b, RPT, a.geo.src_z[s], a.geo.src_x[s], sc, sm);
  const int lrr = a.geo.rcv_row[s] - b.row0;
  const float* wav = a.geo.wav + (long long)s * a.geo.nt_wav;
  float* lap_s = a.lapc + (long long)s * a.KC * F;
  float pb[RPT][kVec], qb[RPT][kVec], gk[RPT][kVec];
#pragma unroll
  for (int c = 0; c < RPT; ++c)
#pragma unroll
    for (int m = 0; m < kVec; ++m) pb[c][m] = qb[c][m] = gk[c][m] = 0.0f;
  for (int ck = a.n_ck - 1; ck >= 0; --ck) {
    cg::this_cluster().sync();
    // restore (u0 with its halo rows, u_-1) from the checkpoint
    const float* src = a.ckpt + ckpt_offset<P>(s, ck, a.n_ck, F);
    const int per_row = a.nx / kVec;
    for (int q = threadIdx.x; q < (b.rows + 4) * per_row; q += blockDim.x) {
      const int lr = q / per_row - 2, jq = (q % per_row) * kVec;
      const int gi = b.row0 + lr;
      float u[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (gi >= 0 && gi < a.nz) ld4(u, src + (long long)gi * a.nx + jq);
      st4(b.buf0 + (lr + 2) * b.P + jq + kPadL, u);
    }
    float um1[RPT][kVec];
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      const int lr = b.i0 + c;
#pragma unroll
      for (int m = 0; m < kVec; ++m) um1[c][m] = 0.0f;
      if (lr < b.rows)
        ld4(um1[c], src + P * F + (long long)(b.row0 + lr) * a.nx + b.j0);
    }
    __syncthreads();
    for (int kk = 0; kk < a.KC; ++kk) {
      const float amp = sc >= 0 ? wav[ck * a.KC + kk] : 0.0f;
      band_fwd_step<false>(b, kk, um1, amp, sc, sm, lap_s + kk * F);
      cluster_arrive();
      cluster_wait();
    }
    for (int kk = a.KC - 1; kk >= 0; --kk) {
      const int t = ck * a.KC + kk;
      const int nb = (2 * a.KC - kk) & 1;  // buffer of step 2 KC - 1 - kk
      const float* yrow =
          t < a.nt_valid
              ? a.ybar + ((long long)s * a.nt_rows + t) * a.nx + b.j0
              : nullptr;
      // Lap(u0) of this step from the cache, loaded first so that phase
      // A and the barrier hide its latency
      float lp[RPT][kVec];
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        const int lr = b.i0 + c;
        if (lr < b.rows)
          ld4(lp[c], lap_s + kk * F + (long long)(b.row0 + lr) * a.nx + b.j0);
      }
      // phase A: K w once per cell into the buffer and the neighbours'
      // halos (p and w as adj_pw gives them)
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        const int lr = b.i0 + c;
        if (lr < b.rows) {
          float p[kVec], w[kVec], k4[kVec], kw[kVec];
          adj_pw(b, lr, lrr, yrow, pb[c], p, w);
          ld4(k4, b.Ks + lr * a.nx + b.j0);
#pragma unroll
          for (int m = 0; m < kVec; ++m) kw[m] = k4[m] * w[m];
          band_put(b, nb, lr, kw);
        }
      }
      cluster_arrive();
      cluster_wait();
      // phase B: p and w again (the same operations: cheaper than holding
      // w across the barrier, registers being what bounds this kernel);
      // the source term, then w Lap(u0), as adj_step; then
      // pb = qb + 2 w + Lap(K w), qb = -d- w
      const float* kwb = b.buf(nb);
      float v[RPT + 4][kVec];
#pragma unroll
      for (int c = 0; c < 4; ++c) ld4(v[c], kwb + b.at(b.i0 + c - 2));
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        ld4(v[c + 4], kwb + b.at(b.i0 + c + 2));
        const int lr = b.i0 + c;
        if (lr < b.rows) {
          const int k = lr * a.nx + b.j0;
          float p[kVec], w[kVec], lkw[kVec], dm[kVec];
          adj_pw(b, lr, lrr, yrow, pb[c], p, w);
#pragma unroll
          for (int m = 0; m < kVec; ++m) {
            if (c == sc && m == sm) {
              gk[c][m] += wav[t] * p[m];
              if (a.gwav)
                a.gwav[(long long)s * a.geo.nt_wav + t] = p[m] * b.Ks[k + m];
            }
            gk[c][m] += w[m] * lp[c][m];
          }
          lap_row(lkw, v, kwb + b.at(lr), c);
          ld4(dm, b.dms + k);
#pragma unroll
          for (int m = 0; m < kVec; ++m) {
            pb[c][m] = qb[c][m] + 2.0f * w[m] + lkw[m];
            qb[c][m] = -(dm[m] * w[m]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < RPT; ++c) {
    const int lr = b.i0 + c;
    if (lr < b.rows)
      st4(a.gk_shots + s * F + (long long)(b.row0 + lr) * a.nx + b.j0,
          gk[c]);
  }
  cg::this_cluster().sync();
}

inline dim3 cell_grid(int ns, int nz, int nx) {
  return dim3((nx + BX - 1) / BX, (nz + BY - 1) / BY, ns);
}

}  // namespace

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

cudaError_t misfit(float* hist, const float* obs, const float* rmask, int ns,
                   int nt_rows, int nx, float inv_count, double* loss_part,
                   cudaStream_t st) {
  if (nx % MF_COLS) return cudaErrorInvalidValue;
  misfit_tiles<<<dim3(nx / MF_COLS, ns), dim3(MF_COLS, MF_ROWS), 0, st>>>(
      hist, obs, rmask, nt_rows, nx, inv_count, loss_part);
  LAUNCHED();
  return cudaSuccess;
}

// The resident route's launch plan (Plan, csrc/cluster.cuh) is made by
// ops/scalar2.py::resident_plan: a thread owns rpt rows of 4 columns.
int plan_smem(const Plan& p, int nx) {
  const int H = p.threads / (nx / kVec) * p.rpt;
  return (int)sizeof(float) * (2 * (H + 4) * (nx + 2 * kPadL) + 3 * p.R * nx);
}

cudaError_t check_plan(const Plan& p, int nz, int nx) {
  const bool ok =
      nx % MF_COLS == 0 && p.C >= 1 && p.C <= 8 && p.R >= 8 &&
      p.R % 8 == 0 && p.C * p.R >= nz && (p.C - 1) * p.R < nz &&
      nz - (p.C - 1) * p.R >= 2 &&
      p.rpt == RPT &&
      p.threads % (nx / kVec) == 0 && p.threads <= kResThreads &&
      p.threads / (nx / kVec) * p.rpt >= p.R && p.smem >= plan_smem(p, nx) &&
      p.smem <= 232448;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
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
  RET_IF(misfit(hist, obs, rmask, ns, nt_pad, nx, inv_count, loss_part, st));
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

// --- resident route: the same functions, one cluster per shot ------------
// Each takes the plan (C, R, rpt, threads, smem) after its sizes and
// returns cudaErrorInvalidValue for a plan that does not fit the grid.

// B1, resident.  hist [ns, nt, nx].
int b1_forward2_resident(const float* K, const float* dp, const float* dm,
                         const float* wav, const int* src_z,
                         const int* src_x, const int* rcv_row, float* hist,
                         int ns, int nz, int nx, int nt, int C, int R,
                         int rpt, int threads, int smem, void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(check_plan(p, nz, nx));
  const FwdArgs a{K,  dp, dm, Geom{src_z, src_x, rcv_row, wav, nt},
                  hist, nullptr, nt, nt, nullptr, 1, 0, nt, nz, nx, R};
  return launch_resident(fwd_resident<1>, a, p, ns, (cudaStream_t)stream);
}

// B4a, resident.  wav [ns, n_ck*KC]; hist [ns, nt, nx];
// ckpt [ns, n_ck, 2, nz, nx].
int b4a_forward2_ckpt_resident(const float* K, const float* dp,
                               const float* dm, const float* wav,
                               const int* src_z, const int* src_x,
                               const int* rcv_row, float* hist, float* ckpt,
                               int ns, int nz, int nx, int nt, int n_ck,
                               int KC, int C, int R, int rpt, int threads,
                               int smem, void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(check_plan(p, nz, nx));
  const int nt_pad = n_ck * KC;
  const FwdArgs a{K,    dp,      dm, Geom{src_z, src_x, rcv_row, wav, nt_pad},
                  hist, nullptr, nt, nt, ckpt, KC, n_ck, nt_pad, nz, nx, R};
  return launch_resident(fwd_resident<1>, a, p, ns, (cudaStream_t)stream);
}

// B4b, resident.  ybar [ns, n_ck*KC, nx]; ckpt from B4a; gk_shots
// [ns, nz, nx] and lapc [ns, KC, nz, nx] scratch; gk_out [nz, nx].
int b4b_backward2_resident(const float* K, const float* dp, const float* dm,
                           const float* wav, const int* src_z,
                           const int* src_x, const int* rcv_row,
                           const float* ybar, const float* ckpt,
                           float* gk_shots, float* lapc, float* gk_out,
                           int ns, int nz, int nx, int n_ck, int KC, int C,
                           int R, int rpt, int threads, int smem,
                           void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(check_plan(p, nz, nx));
  cudaStream_t st = (cudaStream_t)stream;
  const int nt_pad = n_ck * KC;
  const RevArgs a{K,    dp,   dm,       Geom{src_z, src_x, rcv_row, wav, nt_pad},
                  ybar, nt_pad, nt_pad, ckpt, n_ck, KC, lapc, gk_shots,
                  nullptr, nz, nx, R};
  RET_IF(launch_resident(rev_resident<1>, a, p, ns, st));
  const long long F = (long long)nz * nx;
  sum_shots<<<(unsigned)((F + 255) / 256), 256, 0, st>>>(gk_shots, ns, F,
                                                        gk_out);
  LAUNCHED();
  return cudaSuccess;
}

// B2, resident.  As b2_fwi_l1_loss_grad, without the per-step scratch
// fields: lapc [ns, KC, nz, nx], ckpt [ns, n_ck, 2, nz, nx].
int b2_fwi_l1_loss_grad_resident(
    const float* K, const float* dp, const float* dm, const float* wav,
    const int* src_z, const int* src_x, const int* rcv_row, const float* obs,
    const float* dir, const float* rmask, float* gk_shots, float* lapc,
    float* hist, float* ckpt, double* loss_part, float* loss_out,
    float* gk_out, float* gwav, int ns, int nz, int nx, int nt, int n_ck,
    int KC, int C, int R, int rpt, int threads, int smem, float inv_count,
    void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(check_plan(p, nz, nx));
  cudaStream_t st = (cudaStream_t)stream;
  const int nt_pad = n_ck * KC;
  const Geom geo{src_z, src_x, rcv_row, wav, nt_pad};
  RET_IF(cudaMemsetAsync(hist, 0, sizeof(float) * (size_t)ns * nt_pad * nx,
                         st));
  const FwdArgs fa{K,    dp,  dm, geo,  hist,   dir, nt_pad, nt,
                   ckpt, KC, n_ck, nt_pad, nz, nx, R};
  RET_IF(launch_resident(fwd_resident<1>, fa, p, ns, st));
  RET_IF(misfit(hist, obs, rmask, ns, nt_pad, nx, inv_count, loss_part, st));
  const RevArgs ra{K,    dp,   dm,       geo,  hist, nt_pad, nt, ckpt,
                   n_ck, KC,   lapc, gk_shots, gwav, nz, nx, R};
  RET_IF(launch_resident(rev_resident<1>, ra, p, ns, st));
  const long long F = (long long)nz * nx;
  sum_shots<<<(unsigned)((F + 255) / 256), 256, 0, st>>>(gk_shots, ns, F,
                                                        gk_out);
  LAUNCHED();
  sum_loss<<<1, 1, 0, st>>>(loss_part, ns * nx, inv_count, loss_out);
  LAUNCHED();
  return cudaSuccess;
}

// B7a, resident: fwd_resident with the checkpoints in shot pairs.
//   ns = 2 npair shots (the last repeated for an odd count);
//   wav [ns, n_ck*KC]; hist [ns, nt, nx]; ckpt [npair, n_ck, 2, 2, nz, nx].
int b7a_forward2b_resident(const float* K, const float* dp, const float* dm,
                           const float* wav, const int* src_z,
                           const int* src_x, const int* rcv_row, float* hist,
                           float* ckpt, int npair, int nz, int nx, int nt,
                           int n_ck, int KC, int C, int R, int rpt,
                           int threads, int smem, void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(check_plan(p, nz, nx));
  const int nt_pad = n_ck * KC;
  const FwdArgs a{K,    dp,      dm, Geom{src_z, src_x, rcv_row, wav, nt_pad},
                  hist, nullptr, nt, nt, ckpt, KC, n_ck, nt_pad, nz, nx, R};
  return launch_resident(fwd_resident<2>, a, p, 2 * npair,
                         (cudaStream_t)stream);
}

// B7b, resident: rev_resident from B7a's checkpoints (either route's),
// every cotangent row of ybar [ns, n_ck*KC, nx] injected as the Pallas
// kernel injects them; then the per-shot dJ/dK gk_shots [ns, nz, nx]
// summed in pair order into gk_out [nz, nx].  lapc [ns, KC, nz, nx].
int b7b_backward2b_resident(const float* K, const float* dp, const float* dm,
                            const float* wav, const int* src_z,
                            const int* src_x, const int* rcv_row,
                            const float* ybar, const float* ckpt,
                            float* gk_shots, float* lapc, float* gk_out,
                            int npair, int nz, int nx, int n_ck, int KC,
                            int C, int R, int rpt, int threads, int smem,
                            void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(check_plan(p, nz, nx));
  cudaStream_t st = (cudaStream_t)stream;
  const int ns = 2 * npair;
  const int nt_pad = n_ck * KC;
  const RevArgs a{K,    dp,   dm,       Geom{src_z, src_x, rcv_row, wav, nt_pad},
                  ybar, nt_pad, nt_pad, ckpt, n_ck, KC, lapc, gk_shots,
                  nullptr, nz, nx, R};
  RET_IF(launch_resident(rev_resident<2>, a, p, ns, st));
  const long long F = (long long)nz * nx;
  sum_pairs<<<(unsigned)((F + 255) / 256), 256, 0, st>>>(gk_shots, ns, F,
                                                        gk_out);
  LAUNCHED();
  return cudaSuccess;
}

// B9, resident: variant `flags` (bit 0 source, bit 1 receiver rows, bit 2
// checkpoints) of B2's forward sweep from B9's seeded field, n_ck KC
// steps.  wav [ns, n_ck*KC] (zero past nt); hist [ns, nt, nx] (bit 1);
// ckpt [ns, n_ck, 2, nz, nx] (bit 2); fin [ns, 2, nz, nx] the final
// (u0, u_-1), or null; corner [ns] each shot's sum of u0[:8, :128]; chk
// [8, 128] zeros on entry, chk[0, 0] the corners' sum in shot order.
int b9_variant_resident(const float* K, const float* dp, const float* dm,
                        const float* wav, const int* src_z, const int* src_x,
                        const int* rcv_row, float* hist, float* ckpt,
                        float* fin, float* corner, float* chk, int flags,
                        int ns, int nz, int nx, int nt, int n_ck, int KC,
                        int C, int R, int rpt, int threads, int smem,
                        void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(check_plan(p, nz, nx));
  if (flags < 0 || flags > 7 || nx < 128 || nz < 8 || KC < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt_pad = n_ck * KC;
  const B9Args a{FwdArgs{K, dp, dm, Geom{src_z, src_x, rcv_row, wav, nt_pad},
                         hist, nullptr, nt, nt, ckpt, KC, n_ck, nt_pad, nz,
                         nx, R},
                 B9Out{fin, corner}};
  switch (flags) {
    case 0: RET_IF(launch_resident(b9_resident<0>, a, p, ns, st)); break;
    case 1: RET_IF(launch_resident(b9_resident<kB9Src>, a, p, ns, st)); break;
    case 2: RET_IF(launch_resident(b9_resident<kB9Rcv>, a, p, ns, st)); break;
    case 3:
      RET_IF(launch_resident(b9_resident<kB9Src | kB9Rcv>, a, p, ns, st));
      break;
    case 4: RET_IF(launch_resident(b9_resident<kB9Ckpt>, a, p, ns, st)); break;
    case 5:
      RET_IF(launch_resident(b9_resident<kB9Src | kB9Ckpt>, a, p, ns, st));
      break;
    case 6:
      RET_IF(launch_resident(b9_resident<kB9Rcv | kB9Ckpt>, a, p, ns, st));
      break;
    default:
      RET_IF(launch_resident(b9_resident<kB9Src | kB9Rcv | kB9Ckpt>, a, p,
                             ns, st));
  }
  b9_chk<<<1, 1, 0, st>>>(corner, ns, chk);
  LAUNCHED();
  return cudaSuccess;
}

// How many clusters of a plan the card keeps resident at once
// (cudaOccupancyMaxActiveClusters) for the forward (reverse = 0) or the
// reverse kernel, checkpoints grouped `group` shots at a time (1: B1, B2,
// B4; 2: B7), into *out.
int pbfwi_resident_max_clusters(int reverse, int group, int ns, int nz,
                                int nx, int C, int R, int rpt, int threads,
                                int smem, int* out) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(check_plan(p, nz, nx));
  if (group == 1)
    return reverse ? max_active_clusters<RevArgs>(rev_resident<1>, p, ns, out)
                   : max_active_clusters<FwdArgs>(fwd_resident<1>, p, ns, out);
  if (group == 2)
    return reverse ? max_active_clusters<RevArgs>(rev_resident<2>, p, ns, out)
                   : max_active_clusters<FwdArgs>(fwd_resident<2>, p, ns, out);
  return cudaErrorInvalidValue;
}

}  // extern "C"
