// First-order (velocity-pressure) acoustic propagator kernels for Hopper
// (sm_90a): the forward and the exact transpose of the differentiable
// acoustic_pallas propagator.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   B5  b5_acoustic_forward   <- physicsbasedfwi2_tpu/ops/pallas_kernels.py
//                                acoustic_forward_pallas / _forward_kernel
//   B6  b6_checkpoints +      <- physicsbasedfwi2_tpu/ops/pallas_adjoint.py
//       b6_adjoint               _pallas_backward / _bwd_kernel
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
// on the host.  B6 runs its own checkpointed forward sweep (the 4 fields
// every K = 16 steps, [ns, n_ck, 4, nz, nx]), as the Pallas kernel does:
// the autograd forward saves only its inputs, so B5 stays a plain forward.
// Then per chunk, last first: restore, recompute K steps caching Dxb(vx)
// and Dzb(vz), run K adjoint steps.
//
// Each step is two dependent phases in each direction:
//   forward  V: reads the neighbours of p; writes vx, vz;
//            P: reads the neighbours of the new vx, vz; writes px, pz
//               (and, in B6's recompute, the Dxb(vx), Dzb(vz) cache);
//   adjoint  A: reads the neighbours of kap wx, kap wz (the pressure
//               cotangents with ybar on the receiver row); writes avx, avz
//               and gk;
//            B: reads the neighbours of the new avx, avz; writes apx, apz.
// The arithmetic of a cell is the same rounded functions on both routes
// below (d4, vel_new, pres_new, gk_step, av_new, pb0_of): every operation
// rounded explicitly (__fmul_rn, __fsub_rn, __fmaf_rn), since the routes
// keep a cell's values in different places (registers across steps, or
// memory between launches) and which product the compiler fuses into an
// FMA otherwise follows the surrounding code (as csrc/elastic.cu found
// for B3).  So the two routes give the same bits.
//
// Two routes; ops/kernels.py picks one by shape before any launch
// (acoustic_resident_plan) and counts each route's launches.
//
// Resident route (ac_fwd_resident, ac_rev_resident; the default where the
// plan holds the grid).  The Pallas kernels keep one shot's state in VMEM
// (B6: 9 fields and a 2 x 16-step cache, ~7 MB at the flagship shape).
// Here one thread-block cluster of C CTAs holds one shot: CTA r owns a
// band of R rows across the full width, each thread a block of RPT = 5
// rows of 4 columns (one float4), as csrc/scalar2.cu's resident kernels.
// Shared memory holds 4 planes of the band with 2 halo rows above and
// below and 4 zero columns each side, the band's kap (40 KB at C = 5: it
// is read every step), and the row profiles of the decay factors.  The
// factors are separable (ax_* depends on the column, az_* on the row, each
// times the 0/1 ring), so a column profile of ax_v and ax_p (0 off the
// ring's columns; each thread holds its 4 columns' in registers), a row
// profile of az_v and az_p (0 off the ring's rows) and the ring test (a
// profile is nonzero exactly on the ring) give every factor's exact value
// without 4 band planes (160 KB).  At the flagship shape (18 shots,
// 192 x 256 padded) the plan is C = 5 CTAs of 40 rows, 512 threads and
// 4 (4 x 44 x 264 + 40 x 256 + 2 x 40) = 227,136 B of shared memory:
// 4-CTA clusters would need 640 threads, and the card keeps 22 clusters
// of 5 resident, so the 18 shots run in one wave.
//   Forward (B5, B6's forward sweep; one launch a sweep): planes p, vx,
// vz and px (own cells; registers hold pz only).  Phase V reads p (halo
// rows from the neighbours), writes vx and vz (vz's edge rows into the
// neighbours' halos through distributed shared memory); a cluster
// barrier; phase P reads vx along the row and vz across the band edges,
// updates px, pz, adds the source, publishes p = px + pz; a cluster
// barrier.  The rows a phase reads across the thread's block are loaded
// once each.  B5 stores the receiver row every step, B6's sweep the 4
// fields every K steps.
//   Reverse (B6; one launch): apx, apz in registers; planes kap wx,
// kap wz, avx, avz; the shot's dJ/dkap accumulated in gk_shots at the
// thread's own cells.  Per chunk, last first: apx, apz, avx and avz go to
// a per-shot stash in global memory, the checkpoint is restored into
// planes p, vx, vz, px (halos from global memory), K steps are recomputed
// through the forward's code writing Dxb(vx), Dzb(vz) to a per-shot cache
// (each thread reads back only its own cells), the stash comes back, and
// K adjoint steps run: publish kap wx, kap wz and add the step's imaging
// term to dJ/dkap (which needs w too: its cache and dJ/dkap loads then
// overlap the barrier); barrier; phase A; barrier; phase B.  Two cluster
// barriers a step, as B3's resident route.  No atomics; dJ/dkap is per
// shot and summed over shots in order.

// Per-step route (fwd_vel, fwd_pres, adj_vel, adj_pres; grids the plan
// cannot hold, and kept as an entry point for comparison): every phase of
// a time step is one launch over all shots, one thread per cell of
// [ns, nz8, nx128], the state in global memory (at the flagship shape a
// field for all shots is 3.5 MB, so the 4 live fields and the 5
// coefficient planes stay in the 50 MB L2).  Each phase's reads and
// writes do not overlap, so the state updates in place.  B5 takes 2
// launches a step (8 k a call), B6 6 (24 k).
//
// Boundaries: Pallas rolls circularly; the zero ring keeps every forward
// field, and every cotangent product that is read at a neighbour (kap wx,
// kap wz, avx, avz), zero within 2 cells of the array edge, so reading 0
// outside the array (the halo and pad zeros on the resident route) gives
// the same values.
//
// What bounds it on the H100 (PERF.md has the arithmetic): per padded cell
// and step the scheme needs 33 flop forward and 36 adjoint, so at the
// flagship shape (18 x 191 x 240 cells, nt 4001) B5 needs 1.09e11 flop
// (1.63 ms at 67 TFLOP/s float32) and B6 2.28e11 (3.40 ms); inputs and
// outputs are under 0.1 GB (< 0.03 ms at 3.35 TB/s): compute-bound.
// Per-step route, measured on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md): B5 61.0 ms (7.7 us a step), B6 221 ms, bound by each step's L2
// traffic and the redundant neighbour arithmetic more than by launches.
//
// Resident route, predicted before its first timed run (H100, 700 W): a
// forward step is 2 cluster barriers across 5 CTAs plus 20 cells of ~33
// flop and ~8 shared-memory row loads a cell-row per phase: 3-4.5 us (B2's
// 1-barrier step 2.4 us, B3's 2-barrier step 4.5); an adjoint step the
// same 2 barriers and ~1.5x the loads, plus the cache reads: 5-7 us, so a
// recompute + adjoint pair 8-11 us.  B5 ~12-18 ms (from 61), B6's forward
// sweep ~12-18 ms and its reverse sweep ~32-45 ms, B6 ~45-65 ms (from
// 221), and an FWI iteration through acoustic_pallas ~0.07-0.09 s (from
// 0.284-0.288).  Registers bound the reverse kernel (apx, apz and dJ/dkap:
// 60 live floats a thread at 128 registers): expect spills there.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): B5
// 22.2-23.0 ms (5.6 us a step), B6 108.4-110.4 ms (the sweeps' split in
// PERF.md), bit-equal to the per-step route (60-65 and 221-227 ms on the
// same inputs); not met.  Both
// kernels take 128 registers and spill (forward 160 B, reverse 432 B);
// the spills stayed the same with 20 fewer live floats, so the unrolled
// rows' schedule, not the held state, fills the registers.  Tried and
// dropped (PERF.md): an L2 prefetch of the next step's cache, splitting
// each cluster barrier so that warps without halo rows go on, 10 rows a
// thread at 256 threads, dJ/dkap in registers, apz in shared memory with
// kap read through L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr float kC1 = (float)(9.0 / 8.0);
constexpr float kC2 = (float)(-1.0 / 24.0);

// --- the per-cell arithmetic (both routes), every operation rounded ------

// C1 (p1 - p0) + C2 (p2 - pm): Dxf(f)[j] = d4(f[j+1], f[j], f[j+2], f[j-1]),
// Dxb(f)[j] = d4(f[j], f[j-1], f[j+1], f[j-2]), Dzf/Dzb the same on rows.
__device__ __forceinline__ float d4(float p1, float p0, float p2, float pm) {
  return __fmaf_rn(kC1, __fsub_rn(p1, p0), __fmul_rn(kC2, __fsub_rn(p2, pm)));
}

// forward V: d (v + a Dxf(p))
__device__ __forceinline__ float vel_new(float d, float v, float a, float df) {
  return __fmul_rn(d, __fmaf_rn(a, df, v));
}

// forward P: d (p + kap Dxb(v))
__device__ __forceinline__ float pres_new(float d, float p, float k,
                                          float db) {
  return __fmul_rn(d, __fmaf_rn(k, db, p));
}

// adjoint A: the imaging term g + wx Dxb(vx1) + wz Dzb(vz1)
__device__ __forceinline__ float gk_step(float g, float wx, float dxv,
                                         float wz, float dzv) {
  return __fmaf_rn(wz, dzv, __fmaf_rn(wx, dxv, g));
}

// adjoint A: d (av - Dxf(kap w))
__device__ __forceinline__ float av_new(float d, float av, float df) {
  return __fmul_rn(d, __fsub_rn(av, df));
}

// adjoint B: -a (Dxb(avx) + Dzb(avz))
__device__ __forceinline__ float pb0_of(float a, float dxb, float dzb) {
  return __fmul_rn(-a, __fadd_rn(dxb, dzb));
}

struct Src {
  const int* src_z;
  const int* src_x;
  const int* rcv_row;
  const float* amp;  // [ns, nt_amp]: wavelet times the source gain
  int nt_amp;
};

// --- per-step route --------------------------------------------------------

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
  return __fadd_rn(f.c[q], f.d[q]);
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
  const float dxf = d4(p_at(f, i, j + 1, nz, nx), p0,
                       p_at(f, i, j + 2, nz, nx), p_at(f, i, j - 1, nz, nx));
  const float dzf = d4(p_at(f, i + 1, j, nz, nx), p0,
                       p_at(f, i + 2, j, nz, nx), p_at(f, i - 1, j, nz, nx));
  f.a[idx] = vel_new(axv[idx], vx, a, dxf);
  f.b[idx] = vel_new(azv[idx], vz, a, dzf);
}

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
  const float dxb = d4(f.a[idx], ld0(f.a, i, j - 1, nz, nx),
                       ld0(f.a, i, j + 1, nz, nx), ld0(f.a, i, j - 2, nz, nx));
  const float dzb = d4(f.b[idx], ld0(f.b, i - 1, j, nz, nx),
                       ld0(f.b, i + 1, j, nz, nx), ld0(f.b, i - 2, j, nz, nx));
  if (dxv) {
    dxv[s * cache_stride + idx] = dxb;
    dzv[s * cache_stride + idx] = dzb;
  }
  const float k = kap[idx];
  const float px = pres_new(axp[idx], f.c[idx], k, dxb);
  float pz = pres_new(azp[idx], f.d[idx], k, dzb);
  if (i == src.src_z[s] && j == src.src_x[s])
    pz = __fadd_rn(pz, src.amp[(long long)s * src.nt_amp + t]);
  f.c[idx] = px;
  f.d[idx] = pz;
  if (hist && i == src.rcv_row[s])
    hist[((long long)s * nt_rows + t) * nx + j] = __fadd_rn(px, pz);
}

// A pressure cotangent as the adjoint step at time t sees it: the stored
// value plus the receiver cotangent on the receiver row; 0 outside.
__device__ __forceinline__ float ap_at(const float* ap, const float* yrow,
                                       int rrow, int i, int j, int nz,
                                       int nx) {
  if (i < 0 || i >= nz || j < 0 || j >= nx) return 0.0f;
  const float v = ap[i * nx + j];
  return i == rrow ? __fadd_rn(v, yrow[j]) : v;
}

// kap * (a_p * ap) at a (possibly out-of-range) cell: 0 outside.
__device__ __forceinline__ float kw_at(const float* kap, const float* a_p,
                                       const float* ap, const float* yrow,
                                       int rrow, int i, int j, int nz,
                                       int nx) {
  if (i < 0 || i >= nz || j < 0 || j >= nx) return 0.0f;
  const int q = i * nx + j;
  return __fmul_rn(kap[q],
                   __fmul_rn(a_p[q], ap_at(ap, yrow, rrow, i, j, nz, nx)));
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
  const float apz = ap_at(f.d, yrow, rrow, i, j, nz, nx);
  const float wx = __fmul_rn(axp[idx], ap_at(f.c, yrow, rrow, i, j, nz, nx));
  const float wz = __fmul_rn(azp[idx], apz);
  float g = gk[s * F + idx];
  if (i == src.src_z[s] && j == src.src_x[s])
    g = __fmaf_rn(dg[(long long)s * src.nt_amp + t], apz, g);
  gk[s * F + idx] = gk_step(g, wx, dxv[s * cache_stride + idx], wz,
                            dzv[s * cache_stride + idx]);
  const float dxf = d4(kw_at(kap, axp, f.c, yrow, rrow, i, j + 1, nz, nx),
                       __fmul_rn(kap[idx], wx),
                       kw_at(kap, axp, f.c, yrow, rrow, i, j + 2, nz, nx),
                       kw_at(kap, axp, f.c, yrow, rrow, i, j - 1, nz, nx));
  const float dzf = d4(kw_at(kap, azp, f.d, yrow, rrow, i + 1, j, nz, nx),
                       __fmul_rn(kap[idx], wz),
                       kw_at(kap, azp, f.d, yrow, rrow, i + 2, j, nz, nx),
                       kw_at(kap, azp, f.d, yrow, rrow, i - 1, j, nz, nx));
  f.a[idx] = av_new(axv[idx], f.a[idx], dxf);
  f.b[idx] = av_new(azv[idx], f.b[idx], dzf);
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
  const float dxb = d4(f.a[idx], ld0(f.a, i, j - 1, nz, nx),
                       ld0(f.a, i, j + 1, nz, nx), ld0(f.a, i, j - 2, nz, nx));
  const float dzb = d4(f.b[idx], ld0(f.b, i - 1, j, nz, nx),
                       ld0(f.b, i + 1, j, nz, nx), ld0(f.b, i - 2, j, nz, nx));
  const float pb0 = pb0_of(a, dxb, dzb);
  const float wx = __fmul_rn(axp[idx], ap_at(f.c, yrow, rrow, i, j, nz, nx));
  const float wz = __fmul_rn(azp[idx], ap_at(f.d, yrow, rrow, i, j, nz, nx));
  f.c[idx] = __fadd_rn(wx, pb0);
  f.d[idx] = __fadd_rn(wz, pb0);
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

// --- resident route: one thread-block cluster per shot (see the note) -----
// Grid (C, ns), cluster (C, 1, 1): CTA r = blockIdx.x of shot blockIdx.y.
// Every thread reaches every cluster barrier; cells outside the band are
// predicated, never returned from.

namespace cg = cooperative_groups;

constexpr int kResThreads = 512;  // at most: 128 registers a thread
constexpr int kVec = 4;           // columns a thread owns (one float4)
constexpr int kPadL = 4;          // zero columns each side (2 are read)
constexpr int RPT = 5;            // rows a thread owns
constexpr int kPlanes = 4;
// the planes: forward p, vx, vz, px (own cells only); adjoint kap wx,
// kap wz, avx, avz
enum { PL_P = 0, PL_VX = 1, PL_VZ = 2, PL_PX = 3 };
enum { PL_KWX = 0, PL_KWZ = 1, PL_AVX = 2, PL_AVZ = 3 };

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

// A row's columns j0 - 2 .. j0 + 5 (h[m + 2] is own column m) from a plane
// pointer at own column 0.
__device__ __forceinline__ void ld_row(float (&h)[kVec + 4], const float* f) {
  const float2 l = *reinterpret_cast<const float2*>(f - 2);
  const float2 r = *reinterpret_cast<const float2*>(f + kVec);
  float m[kVec];
  ld4(m, f);
  h[0] = l.x;
  h[1] = l.y;
#pragma unroll
  for (int k = 0; k < kVec; ++k) h[k + 2] = m[k];
  h[kVec + 2] = r.x;
  h[kVec + 3] = r.y;
}

// A CTA's band and its shared memory: kPlanes planes of (H + 4) x P floats
// (P = nx + 8; plane row lr + 2 holds band row lr, column j + 4 column j;
// H = TY x RPT >= rows, the rows the threads cover), then kap of the band
// [R, nx] and the row profiles [R] of (az_v, az_p) pairs.  Thread (ty, x)
// owns rows i0 = ty RPT .. i0 + RPT - 1 of columns j0 = 4x .. j0 + 3, and
// holds its columns' ax_v and ax_p profiles in registers.  Plane k sits at
// offset k psz, here and in the neighbours.
struct AcBand {
  int C, R, rows, row0, nx, P, j0, i0, psz;
  float* pl;
  float* up;  // the upper neighbour's planes (null for the top band)
  float* dn;  // the lower neighbour's (null for the bottom band)
  float* kap;
  const float2* zpr;
  float axv[kVec], axp[kVec];
  __device__ float* plane(int k) const { return pl + k * psz; }
  // offset of band row lr, own column 0, in a plane
  __device__ int at(int lr) const { return (lr + 2) * P + j0 + kPadL; }
};

struct AcArgs {
  const float* kap;  // [nz, nx]
  const float* xpr;  // [2, nx] ax_v, ax_p on the ring's rows
  const float* zpr;  // [2, nz] az_v, az_p on the ring's columns
  Src src;
  const float* dg;   // [ns, nt_amp] wavelet / dx (reverse)
  float* hist;       // forward: receiver rows [ns, nsteps, nx], or null
  float* ckpt;       // [ns, n_ck, 4, nz, nx]: forward writes (or null),
                     // reverse reads
  const float* ybar;  // reverse: cotangent rows [ns, n_ck K, nx]
  float* dxv;         // reverse: [ns, K, nz, nx] cache
  float* dzv;
  float* stash;       // reverse: [ns, 4, nz, nx] apx, apz, avx, avz
  float* gk_shots;    // reverse: [ns, nz, nx]
  int n_ck, K, nsteps, nz, nx, R;
  float a;
};

// Zero the planes (halos, pad columns and rows past the band stay zero
// unless a neighbour writes them) and load the band's kap and profiles.
// The caller passes a cluster barrier before any neighbour writes into the
// halos.
__device__ __forceinline__ AcBand band_init(float* smem, const AcArgs& a) {
  AcBand b;
  const int r = blockIdx.x;
  b.C = gridDim.x;
  b.R = a.R;
  b.nx = a.nx;
  b.P = a.nx + 2 * kPadL;
  b.row0 = r * a.R;
  b.rows = min(a.R, a.nz - b.row0);
  const int per_row = a.nx / kVec;
  b.j0 = (threadIdx.x % per_row) * kVec;
  b.i0 = (threadIdx.x / per_row) * RPT;
  b.psz = ((blockDim.x / per_row) * RPT + 4) * b.P;
  b.pl = smem;
  b.kap = smem + kPlanes * b.psz;
  float* zpr = b.kap + a.R * a.nx;
  b.zpr = reinterpret_cast<const float2*>(zpr);
  ld4(b.axv, a.xpr + b.j0);
  ld4(b.axp, a.xpr + a.nx + b.j0);
  cg::cluster_group cl = cg::this_cluster();
  b.up = r > 0 ? cl.map_shared_rank(smem, r - 1) : nullptr;
  b.dn = r + 1 < b.C ? cl.map_shared_rank(smem, r + 1) : nullptr;
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4* pl4 = reinterpret_cast<float4*>(smem);
  for (int q = threadIdx.x; q < kPlanes * b.psz / kVec; q += blockDim.x)
    pl4[q] = z;
  const int off = b.row0 * a.nx;
  for (int q = threadIdx.x * kVec; q < b.rows * a.nx; q += blockDim.x * kVec)
    *reinterpret_cast<float4*>(b.kap + q) =
        *reinterpret_cast<const float4*>(a.kap + off + q);
  for (int q = threadIdx.x; q < 2 * a.R; q += blockDim.x) {
    const int k = q % 2, lr = q / 2;
    zpr[q] = lr < b.rows ? a.zpr[k * a.nz + b.row0 + lr] : 0.0f;
  }
  return b;
}

// ax_v (k = 0) or ax_p (k = 1) at the own cells of a band row whose
// (az_v, az_p) profile pair is zr: the column profile on the ring's rows
// (az_v's profile is nonzero exactly there).
__device__ __forceinline__ void xfac(const AcBand& b, int k, float2 zr,
                                     float (&f)[kVec]) {
#pragma unroll
  for (int m = 0; m < kVec; ++m)
    f[m] = zr.x != 0.0f ? (k ? b.axp[m] : b.axv[m]) : 0.0f;
}

// az_v (k = 0) or az_p (k = 1) at the own cells of that row: the row
// profile on the ring's columns (ax_v's profile is nonzero exactly there).
__device__ __forceinline__ void zfac(const AcBand& b, int k, float2 zr,
                                     float (&f)[kVec]) {
#pragma unroll
  for (int m = 0; m < kVec; ++m)
    f[m] = b.axv[m] != 0.0f ? (k ? zr.y : zr.x) : 0.0f;
}

// Write v (own 4 cells of band row lr) into plane k and, with `halo`, for
// the band's 2 edge rows into the neighbours' halo rows of their plane k.
__device__ __forceinline__ void put(const AcBand& b, int k, int lr,
                                    const float (&v)[kVec], bool halo) {
  const int off = k * b.psz + b.j0 + kPadL;
  st4(b.pl + off + (lr + 2) * b.P, v);
  if (halo) {
    if (lr < 2 && b.up) st4(b.up + off + (b.R + 2 + lr) * b.P, v);
    if (lr >= b.rows - 2 && b.dn)
      st4(b.dn + off + (lr - b.rows + 2) * b.P, v);
  }
}

// (row, column) of global cell (gi, gj) among the thread's cells, or -1.
__device__ __forceinline__ void own_cell(const AcBand& b, int gi, int gj,
                                         int& c, int& m) {
  const int lr = gi - b.row0;
  const bool mine = lr >= 0 && lr < b.rows && lr >= b.i0 && lr < b.i0 + RPT &&
                    gj >= b.j0 && gj < b.j0 + kVec;
  c = mine ? lr - b.i0 : -1;
  m = mine ? gj - b.j0 : -1;
}

// One forward step of the band, as fwd_vel then fwd_pres, each phase
// ending at a cluster barrier.  px lives in plane PL_PX and pz in
// registers at the own cells; amp: the source amplitude, added at own
// cell (sc, sm) (sc = -1: not this thread's); dxv, dzv (optional): the
// step's [nz, nx] cache slots; rec (optional): the receiver row's [nx]
// slot, lrr its band row.  The rows a phase reads across the band are
// loaded once into a window (w[c + 1] is row i0 + c of p; z[c + 2] row
// i0 + c of vz), of which only the live rows take registers.
__device__ __forceinline__ void ac_fwd_step(const AcBand& b, float a,
                                            float (&pz)[RPT][kVec], float amp,
                                            int sc, int sm, float* dxv,
                                            float* dzv, float* rec, int lrr) {
  const float* P = b.plane(PL_P);
  // phase V: vx, vz from the neighbours of p
  float w[RPT + 3][kVec];
#pragma unroll
  for (int c = 0; c < 3; ++c) ld4(w[c], P + b.at(b.i0 + c - 1));
#pragma unroll
  for (int c = 0; c < RPT; ++c) {
    const int lr = b.i0 + c;
    ld4(w[c + 3], P + b.at(lr + 2));
    if (lr < b.rows) {
      // row lr's columns j0 - 1 .. j0 + 5 (h[m + 1] is own column m)
      const float* f = P + b.at(lr);
      const float2 l = *reinterpret_cast<const float2*>(f - 2);
      const float2 r = *reinterpret_cast<const float2*>(f + kVec);
      const float h[kVec + 3] = {l.y, w[c + 1][0], w[c + 1][1],
                                 w[c + 1][2], w[c + 1][3], r.x, r.y};
      const float2 zr = b.zpr[lr];
      float d[kVec], v[kVec];
      xfac(b, 0, zr, d);
      ld4(v, b.plane(PL_VX) + b.at(lr));
#pragma unroll
      for (int m = 0; m < kVec; ++m)
        v[m] = vel_new(d[m], v[m], a, d4(h[m + 2], h[m + 1], h[m + 3], h[m]));
      put(b, PL_VX, lr, v, false);
      zfac(b, 0, zr, d);
      ld4(v, b.plane(PL_VZ) + b.at(lr));
#pragma unroll
      for (int m = 0; m < kVec; ++m)
        v[m] = vel_new(d[m], v[m], a,
                       d4(w[c + 2][m], w[c + 1][m], w[c + 3][m], w[c][m]));
      put(b, PL_VZ, lr, v, true);
    }
  }
  cluster_barrier();
  // phase P: px, pz from the neighbours of the new vx, vz; publish p
  const float* VX = b.plane(PL_VX);
  const float* VZ = b.plane(PL_VZ);
  float z[RPT + 3][kVec];
#pragma unroll
  for (int c = 0; c < 3; ++c) ld4(z[c], VZ + b.at(b.i0 + c - 2));
#pragma unroll
  for (int c = 0; c < RPT; ++c) {
    const int lr = b.i0 + c;
    ld4(z[c + 3], VZ + b.at(lr + 1));
    if (lr < b.rows) {
      float h[kVec + 4], dxb[kVec], dzb[kVec], k[kVec], d[kVec], x[kVec];
      float p[kVec];
      ld_row(h, VX + b.at(lr));
#pragma unroll
      for (int m = 0; m < kVec; ++m) {
        dxb[m] = d4(h[m + 2], h[m + 1], h[m + 3], h[m]);
        dzb[m] = d4(z[c + 2][m], z[c + 1][m], z[c + 3][m], z[c][m]);
      }
      const long long g = (long long)(b.row0 + lr) * b.nx + b.j0;
      if (dxv) {
        st4(dxv + g, dxb);
        st4(dzv + g, dzb);
      }
      ld4(k, b.kap + lr * b.nx + b.j0);
      ld4(x, b.plane(PL_PX) + b.at(lr));
      const float2 zr = b.zpr[lr];
      xfac(b, 1, zr, d);
#pragma unroll
      for (int m = 0; m < kVec; ++m) x[m] = pres_new(d[m], x[m], k[m], dxb[m]);
      put(b, PL_PX, lr, x, false);
      zfac(b, 1, zr, d);
#pragma unroll
      for (int m = 0; m < kVec; ++m) {
        float q = pres_new(d[m], pz[c][m], k[m], dzb[m]);
        if (c == sc && m == sm) q = __fadd_rn(q, amp);
        pz[c][m] = q;
        p[m] = __fadd_rn(x[m], q);
      }
      put(b, PL_P, lr, p, true);
      if (rec && lr == lrr) st4(rec + b.j0, p);
    }
  }
  cluster_barrier();
}

// Forward sweep of nsteps steps from zero fields: B5 (hist) and B6's
// forward sweep (ckpt: the 4 fields before every K-th step).
__global__ void __launch_bounds__(kResThreads, 1) ac_fwd_resident(AcArgs a) {
  extern __shared__ float4 smem4[];
  const AcBand b = band_init(reinterpret_cast<float*>(smem4), a);
  cluster_barrier();
  const int s = blockIdx.y;
  const long long F = (long long)a.nz * a.nx;
  int sc, sm;
  own_cell(b, a.src.src_z[s], a.src.src_x[s], sc, sm);
  const int lrr = a.src.rcv_row[s] - b.row0;
  const float* amp = a.src.amp + (long long)s * a.src.nt_amp;
  float pz[RPT][kVec];
#pragma unroll
  for (int c = 0; c < RPT; ++c)
#pragma unroll
    for (int m = 0; m < kVec; ++m) pz[c][m] = 0.0f;
  for (int t = 0; t < a.nsteps; ++t) {
    if (a.ckpt && t % a.K == 0) {
      float* ck = a.ckpt + ((long long)s * a.n_ck + t / a.K) * 4 * F;
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        const int lr = b.i0 + c;
        if (lr < b.rows) {
          const long long g = (long long)(b.row0 + lr) * a.nx + b.j0;
          float v[kVec];
          ld4(v, b.plane(PL_VX) + b.at(lr));
          st4(ck + g, v);
          ld4(v, b.plane(PL_VZ) + b.at(lr));
          st4(ck + F + g, v);
          ld4(v, b.plane(PL_PX) + b.at(lr));
          st4(ck + 2 * F + g, v);
          st4(ck + 3 * F + g, pz[c]);
        }
      }
    }
    float* rec =
        a.hist ? a.hist + ((long long)s * a.nsteps + t) * a.nx : nullptr;
    ac_fwd_step(b, a.a, pz, sc >= 0 ? amp[t] : 0.0f, sc, sm, nullptr,
                nullptr, rec, lrr);
  }
}

// The adjoint step's pressure cotangents (plus the cotangent row on the
// receiver row) and w = a_p ap for the own cells of band row lr.
__device__ __forceinline__ void adj_w(const AcBand& b, int lr, int lrr,
                                      const float* yrow,
                                      const float (&apx)[kVec],
                                      const float (&apz)[kVec],
                                      float (&ez)[kVec], float (&wx)[kVec],
                                      float (&wz)[kVec]) {
  float ex[kVec], d[kVec];
  const float2 zr = b.zpr[lr];
#pragma unroll
  for (int m = 0; m < kVec; ++m) {
    ex[m] = apx[m];
    ez[m] = apz[m];
  }
  if (lr == lrr) {
    float y[kVec];
    ld4(y, yrow);
#pragma unroll
    for (int m = 0; m < kVec; ++m) {
      ex[m] = __fadd_rn(ex[m], y[m]);
      ez[m] = __fadd_rn(ez[m], y[m]);
    }
  }
  xfac(b, 1, zr, d);
#pragma unroll
  for (int m = 0; m < kVec; ++m) wx[m] = __fmul_rn(d[m], ex[m]);
  zfac(b, 1, zr, d);
#pragma unroll
  for (int m = 0; m < kVec; ++m) wz[m] = __fmul_rn(d[m], ez[m]);
}

// Reverse sweep, chunk by chunk from the checkpoints (last first): B6's
// recompute and adjoint.  apx and apz stay in registers, stashed in global
// memory while a chunk is recomputed; the shot's dJ/dkap is accumulated
// in gk_shots at the own cells (registers do not hold a third field).
__global__ void __launch_bounds__(kResThreads, 1) ac_rev_resident(AcArgs a) {
  extern __shared__ float4 smem4[];
  const AcBand b = band_init(reinterpret_cast<float*>(smem4), a);
  const int s = blockIdx.y;
  const long long F = (long long)a.nz * a.nx;
  int sc, sm;
  own_cell(b, a.src.src_z[s], a.src.src_x[s], sc, sm);
  const int lrr = a.src.rcv_row[s] - b.row0;
  const int nt_rows = a.n_ck * a.K;
  const float* amp = a.src.amp + (long long)s * a.src.nt_amp;
  const float* dg = a.dg + (long long)s * a.src.nt_amp;
  float* stash = a.stash + (long long)s * 4 * F;
  float* gks = a.gk_shots + (long long)s * F;
  float* dxv = a.dxv + (long long)s * a.K * F;
  float* dzv = a.dzv + (long long)s * a.K * F;
  float apx[RPT][kVec], apz[RPT][kVec];
#pragma unroll
  for (int c = 0; c < RPT; ++c) {
    const int lr = b.i0 + c;
#pragma unroll
    for (int m = 0; m < kVec; ++m) apx[c][m] = apz[c][m] = 0.0f;
    if (lr < b.rows)
      st4(gks + (long long)(b.row0 + lr) * a.nx + b.j0, apx[c]);
  }
  cluster_barrier();  // the planes are zero before the first stash
  for (int ck = a.n_ck - 1; ck >= 0; --ck) {
    // stash the adjoint state's own cells (the planes avx, avz: zero at
    // the start, as band_init left them)
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      const int lr = b.i0 + c;
      if (lr < b.rows) {
        const long long g = (long long)(b.row0 + lr) * a.nx + b.j0;
        float v[kVec];
        st4(stash + g, apx[c]);
        st4(stash + F + g, apz[c]);
        ld4(v, b.plane(PL_AVX) + b.at(lr));
        st4(stash + 2 * F + g, v);
        ld4(v, b.plane(PL_AVZ) + b.at(lr));
        st4(stash + 3 * F + g, v);
      }
    }
    cluster_barrier();  // every CTA is done with the planes
    // restore p, vx, vz with their halo rows, and px (own rows) and pz,
    // from the checkpoint
    const float* src = a.ckpt + ((long long)s * a.n_ck + ck) * 4 * F;
    const int per_row = a.nx / kVec;
    for (int q = threadIdx.x; q < (b.rows + 4) * per_row; q += blockDim.x) {
      const int lr = q / per_row - 2, jq = (q % per_row) * kVec;
      const int gi = b.row0 + lr;
      float vx[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
      float vz[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
      float x[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
      float p[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (gi >= 0 && gi < a.nz) {
        const long long g = (long long)gi * a.nx + jq;
        float z[kVec];
        ld4(vx, src + g);
        ld4(vz, src + F + g);
        ld4(x, src + 2 * F + g);
        ld4(z, src + 3 * F + g);
#pragma unroll
        for (int m = 0; m < kVec; ++m) p[m] = __fadd_rn(x[m], z[m]);
      }
      const int o = (lr + 2) * b.P + jq + kPadL;
      st4(b.plane(PL_P) + o, p);
      st4(b.plane(PL_VX) + o, vx);
      st4(b.plane(PL_VZ) + o, vz);
      if (lr >= 0 && lr < b.rows) st4(b.plane(PL_PX) + o, x);
    }
    float pz[RPT][kVec];
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      const int lr = b.i0 + c;
#pragma unroll
      for (int m = 0; m < kVec; ++m) pz[c][m] = 0.0f;
      if (lr < b.rows)
        ld4(pz[c], src + 3 * F + (long long)(b.row0 + lr) * a.nx + b.j0);
    }
    cluster_barrier();  // no neighbour writes a halo row being restored
    for (int kk = 0; kk < a.K; ++kk) {
      const int t = ck * a.K + kk;
      ac_fwd_step(b, a.a, pz, sc >= 0 ? amp[t] : 0.0f, sc, sm, dxv + kk * F,
                  dzv + kk * F, nullptr, lrr);
    }
    // the last step's barrier freed the planes: the stash comes back
#pragma unroll
    for (int c = 0; c < RPT; ++c) {
      const int lr = b.i0 + c;
#pragma unroll
      for (int m = 0; m < kVec; ++m) apx[c][m] = apz[c][m] = 0.0f;
      if (lr < b.rows) {
        const long long g = (long long)(b.row0 + lr) * a.nx + b.j0;
        float v[kVec];
        ld4(apx[c], stash + g);
        ld4(apz[c], stash + F + g);
        ld4(v, stash + 2 * F + g);
        put(b, PL_AVX, lr, v, false);
        ld4(v, stash + 3 * F + g);
        put(b, PL_AVZ, lr, v, false);
      }
    }
    for (int kk = a.K - 1; kk >= 0; --kk) {
      const int t = ck * a.K + kk;
      const float* yrow =
          a.ybar + ((long long)s * nt_rows + t) * a.nx + b.j0;
      // publish kap wx and kap wz; dJ/dkap (the source term first, as
      // adj_vel), its loads and stores before the barrier
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        const int lr = b.i0 + c;
        if (lr < b.rows) {
          const long long g = (long long)(b.row0 + lr) * a.nx + b.j0;
          float ez[kVec], wx[kVec], wz[kVec], k[kVec], cx[kVec], cz[kVec];
          float gg[kVec];
          ld4(cx, dxv + kk * F + g);
          ld4(cz, dzv + kk * F + g);
          ld4(gg, gks + g);
          adj_w(b, lr, lrr, yrow, apx[c], apz[c], ez, wx, wz);
#pragma unroll
          for (int m = 0; m < kVec; ++m) {
            if (c == sc && m == sm) gg[m] = __fmaf_rn(dg[t], ez[m], gg[m]);
            gg[m] = gk_step(gg[m], wx[m], cx[m], wz[m], cz[m]);
          }
          st4(gks + g, gg);
          ld4(k, b.kap + lr * a.nx + b.j0);
#pragma unroll
          for (int m = 0; m < kVec; ++m) {
            wx[m] = __fmul_rn(k[m], wx[m]);
            wz[m] = __fmul_rn(k[m], wz[m]);
          }
          put(b, PL_KWX, lr, wx, false);
          put(b, PL_KWZ, lr, wz, true);
        }
      }
      cluster_barrier();
      // phase A: the velocity cotangents from the neighbours of kap w
      const float* KX = b.plane(PL_KWX);
      const float* KZ = b.plane(PL_KWZ);
      float kz[RPT + 3][kVec];
#pragma unroll
      for (int c = 0; c < 3; ++c) ld4(kz[c], KZ + b.at(b.i0 + c - 1));
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        const int lr = b.i0 + c;
        ld4(kz[c + 3], KZ + b.at(lr + 2));
        if (lr < b.rows) {
          float h[kVec + 4], d[kVec], v[kVec];
          const float2 zr = b.zpr[lr];
          ld_row(h, KX + b.at(lr));
          xfac(b, 0, zr, d);
          ld4(v, b.plane(PL_AVX) + b.at(lr));
#pragma unroll
          for (int m = 0; m < kVec; ++m)
            v[m] = av_new(d[m], v[m], d4(h[m + 3], h[m + 2], h[m + 4], h[m + 1]));
          put(b, PL_AVX, lr, v, false);
          zfac(b, 0, zr, d);
          ld4(v, b.plane(PL_AVZ) + b.at(lr));
#pragma unroll
          for (int m = 0; m < kVec; ++m)
            v[m] = av_new(d[m], v[m],
                          d4(kz[c + 2][m], kz[c + 1][m], kz[c + 3][m], kz[c][m]));
          put(b, PL_AVZ, lr, v, true);
        }
      }
      cluster_barrier();
      // phase B: the pressure cotangents from the neighbours of the new
      // avx, avz (w again: cheaper than holding it across the barriers)
      const float* AX = b.plane(PL_AVX);
      const float* AZ = b.plane(PL_AVZ);
      float z[RPT + 3][kVec];
#pragma unroll
      for (int c = 0; c < 3; ++c) ld4(z[c], AZ + b.at(b.i0 + c - 2));
#pragma unroll
      for (int c = 0; c < RPT; ++c) {
        const int lr = b.i0 + c;
        ld4(z[c + 3], AZ + b.at(lr + 1));
        if (lr < b.rows) {
          float h[kVec + 4], ez[kVec], wx[kVec], wz[kVec];
          ld_row(h, AX + b.at(lr));
          adj_w(b, lr, lrr, yrow, apx[c], apz[c], ez, wx, wz);
#pragma unroll
          for (int m = 0; m < kVec; ++m) {
            const float pb0 =
                pb0_of(a.a, d4(h[m + 2], h[m + 1], h[m + 3], h[m]),
                       d4(z[c + 2][m], z[c + 1][m], z[c + 3][m], z[c][m]));
            apx[c][m] = __fadd_rn(wx[m], pb0);
            apz[c][m] = __fadd_rn(wz[m], pb0);
          }
        }
      }
    }
  }
  cluster_barrier();  // no CTA leaves while a neighbour reads its planes
}

// The resident route's plan (Plan, csrc/cluster.cuh), made by
// ops/kernels.py::acoustic_resident_plan: a thread owns rpt rows of 4
// columns.
int ac_plan_smem(const Plan& p, int nx) {
  const int H = p.threads / (nx / kVec) * p.rpt;
  return (int)sizeof(float) *
         (kPlanes * (H + 4) * (nx + 2 * kPadL) + p.R * nx + 2 * p.R);
}

cudaError_t ac_check_plan(const Plan& p, int nz, int nx) {
  const bool ok =
      nx % 32 == 0 && p.C >= 1 && p.C <= 8 && p.R >= 8 && p.R % 8 == 0 &&
      p.C * p.R >= nz && (p.C - 1) * p.R < nz && nz - (p.C - 1) * p.R >= 2 &&
      p.rpt == RPT && p.threads % (nx / kVec) == 0 &&
      p.threads <= kResThreads && p.threads / (nx / kVec) * p.rpt >= p.R &&
      p.smem >= ac_plan_smem(p, nx) && p.smem <= 232448;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// B5: the forward, per-step route.  kap, axv, azv, axp, azp [nz, nx]
// (damping already ring-masked); src_amp [ns, nt]; st [ns, 4, nz, nx]
// scratch; hist [ns, nt, nx] receives px + pz of each shot's receiver row.
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

// B6's forward sweep, per-step route: ckpt [ns, n_ck, 4, nz, nx] receives
// (vx, vz, px, pz) before every K-th of n_ck*K steps.  src_amp
// [ns, n_ck*K]; st [ns, 4, nz, nx] scratch.
int b6_checkpoints(const float* kap, const float* axv, const float* azv,
                   const float* axp, const float* azp, const float* src_amp,
                   const int* src_z, const int* src_x, const int* rcv_row,
                   float* st, float* ckpt, int ns, int nz, int nx, int n_ck,
                   int K, float a, void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  const long long F = (long long)nz * nx;
  const int nt_pad = n_ck * K;
  RET_IF(cudaMemsetAsync(st, 0, sizeof(float) * 4 * (size_t)ns * F, cs));
  const Src src{src_z, src_x, rcv_row, src_amp, nt_pad};
  const dim3 grid = cell_grid(ns, nz, nx), block(BX, BY);
  const long long ck_stride = (long long)n_ck * 4 * F;
  for (int t = 0; t < nt_pad; ++t) {
    fwd_vel<<<grid, block, 0, cs>>>(
        axv, azv, st, a, t % K == 0 ? ckpt + (t / K) * 4 * F : nullptr,
        ck_stride, nz, nx);
    LAUNCHED();
    fwd_pres<<<grid, block, 0, cs>>>(kap, axp, azp, st, src, t, nullptr, 0,
                                     nullptr, nullptr, 0, nz, nx);
    LAUNCHED();
  }
  return cudaSuccess;
}

// B6's reverse sweep, per-step route: dJ/dkap for receiver-row cotangents
// ybar [ns, n_ck*K, nx] (every row injected) from b6_checkpoints' ckpt.
// src_amp, dg [ns, n_ck*K] (wavelet times kap[src]/dx, and times 1/dx);
// st, ast [ns, 4, nz, nx]; dxv, dzv [ns, K, nz, nx]; gk_shots [ns, nz, nx];
// gk_out [nz, nx].
int b6_adjoint(const float* kap, const float* axv, const float* azv,
               const float* axp, const float* azp, const float* src_amp,
               const float* dg, const int* src_z, const int* src_x,
               const int* rcv_row, const float* ybar, const float* ckpt,
               float* st, float* ast, float* dxv, float* dzv, float* gk_shots,
               float* gk_out, int ns, int nz, int nx, int n_ck, int K,
               float a, void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  const long long F = (long long)nz * nx;
  const int nt_pad = n_ck * K;
  RET_IF(cudaMemsetAsync(ast, 0, sizeof(float) * 4 * (size_t)ns * F, cs));
  RET_IF(cudaMemsetAsync(gk_shots, 0, sizeof(float) * (size_t)ns * F, cs));
  const Src src{src_z, src_x, rcv_row, src_amp, nt_pad};
  const dim3 grid = cell_grid(ns, nz, nx), block(BX, BY);
  const long long ck_stride = (long long)n_ck * 4 * F;
  const long long cache_stride = (long long)K * F;
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

// --- resident route: the same functions, one cluster per shot ------------
// kap [nz, nx]; xpr [2, nx] and zpr [2, nz] the decay factors' profiles
// (ops/kernels.py::damp_profiles); each takes the plan (C, R, rpt,
// threads, smem) after its sizes and returns cudaErrorInvalidValue for a
// plan that does not fit the grid.

// B5, resident.  hist [ns, nt, nx].
int b5_acoustic_forward_resident(const float* kap, const float* xpr,
                                 const float* zpr, const float* src_amp,
                                 const int* src_z, const int* src_x,
                                 const int* rcv_row, float* hist, int ns,
                                 int nz, int nx, int nt, int C, int R,
                                 int rpt, int threads, int smem, float a,
                                 void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(ac_check_plan(p, nz, nx));
  AcArgs args = {};
  args.kap = kap;
  args.xpr = xpr;
  args.zpr = zpr;
  args.src = Src{src_z, src_x, rcv_row, src_amp, nt};
  args.hist = hist;
  args.K = 1;
  args.nsteps = nt;
  args.nz = nz;
  args.nx = nx;
  args.R = R;
  args.a = a;
  return launch_resident(ac_fwd_resident, args, p, ns, (cudaStream_t)stream);
}

// B6's forward sweep, resident.  src_amp [ns, n_ck*K];
// ckpt [ns, n_ck, 4, nz, nx].
int b6_checkpoints_resident(const float* kap, const float* xpr,
                            const float* zpr, const float* src_amp,
                            const int* src_z, const int* src_x,
                            const int* rcv_row, float* ckpt, int ns, int nz,
                            int nx, int n_ck, int K, int C, int R, int rpt,
                            int threads, int smem, float a, void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(ac_check_plan(p, nz, nx));
  AcArgs args = {};
  args.kap = kap;
  args.xpr = xpr;
  args.zpr = zpr;
  args.src = Src{src_z, src_x, rcv_row, src_amp, n_ck * K};
  args.ckpt = ckpt;
  args.n_ck = n_ck;
  args.K = K;
  args.nsteps = n_ck * K;
  args.nz = nz;
  args.nx = nx;
  args.R = R;
  args.a = a;
  return launch_resident(ac_fwd_resident, args, p, ns, (cudaStream_t)stream);
}

// B6's reverse sweep, resident.  As b6_adjoint, without the per-step
// scratch (st, ast): stash [ns, 4, nz, nx].
int b6_adjoint_resident(const float* kap, const float* xpr, const float* zpr,
                        const float* src_amp, const float* dg,
                        const int* src_z, const int* src_x,
                        const int* rcv_row, const float* ybar,
                        const float* ckpt, float* dxv, float* dzv,
                        float* stash, float* gk_shots, float* gk_out, int ns,
                        int nz, int nx, int n_ck, int K, int C, int R,
                        int rpt, int threads, int smem, float a,
                        void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(ac_check_plan(p, nz, nx));
  cudaStream_t cs = (cudaStream_t)stream;
  AcArgs args = {};
  args.kap = kap;
  args.xpr = xpr;
  args.zpr = zpr;
  args.src = Src{src_z, src_x, rcv_row, src_amp, n_ck * K};
  args.dg = dg;
  args.ckpt = const_cast<float*>(ckpt);
  args.ybar = ybar;
  args.dxv = dxv;
  args.dzv = dzv;
  args.stash = stash;
  args.gk_shots = gk_shots;
  args.n_ck = n_ck;
  args.K = K;
  args.nsteps = n_ck * K;
  args.nz = nz;
  args.nx = nx;
  args.R = R;
  args.a = a;
  RET_IF(launch_resident(ac_rev_resident, args, p, ns, cs));
  const long long F = (long long)nz * nx;
  sum_shots<<<(unsigned)((F + 255) / 256), 256, 0, cs>>>(gk_shots, ns, F,
                                                        gk_out);
  LAUNCHED();
  return cudaSuccess;
}

// How many clusters of a plan the card keeps resident at once
// (cudaOccupancyMaxActiveClusters) for the forward (reverse = 0) or the
// reverse kernel of B5/B6's resident route, into *out.
int pbfwi_b56_max_clusters(int reverse, int ns, int nz, int nx, int C, int R,
                           int rpt, int threads, int smem, int* out) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(ac_check_plan(p, nz, nx));
  return max_active_clusters<AcArgs>(
      reverse ? ac_rev_resident : ac_fwd_resident, p, ns, out);
}

}  // extern "C"
