// Fused elastic FWI loss+gradient kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   B3  b3_fused_elastic_loss_grad  <- physicsbasedfwi2_tpu/ops/
//                                      pallas_elastic_fused.py
//                                      fused_elastic_loss_grad_meds / _kernel
// and runs its forward phases alone for the ring forward
//       b3_elastic_ring_resident,   <- the same file's simulate_elastic_ring
//       b3_elastic_ring                (a JAX scan of the same scheme,
//                                      _ring_scan)
// and, with no free-surface row, for
//   B8  elastic_forward_pallas      <- physicsbasedfwi2_tpu/ops/
//       (ops/elastic_fwd.py)           pallas_elastic.py _el_kernel
// on both routes.
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
// Each step splits into two phases whose reads and writes do not
// overlap, so the state is updated in place without double buffering:
//   forward  V: reads stress neighbours, writes its own vx, vz;
//            S: reads the new velocity neighbours, writes its own
//               sxx, szz, sxz;
//   adjoint  A: injects the receiver cotangent, reads the neighbours'
//               products of the stress cotangents (cbar, abar, bbar),
//               writes its own Vx, Vz (and accumulates dJ/dbx, dJ/dbz);
//            B: reads the neighbours' products of the new velocity
//               cotangents (dtx bx Vx, dtx bz Vz), writes its own Sxx,
//               Szz, Sxz (and accumulates dJ/dlam, dJ/dl2m, dJ/dmuxz,
//               with the source-gain term on l2m at the source cell).
// The arithmetic of one cell in each phase is one __device__ function
// (fwd_v_cell, fwd_s_cell, adj_v_cell, adj_s_cell) that reads its
// neighbours through an accessor: global memory with zeros outside the
// array, or a band in shared memory.  Both routes below call them, so
// they give the same bits.  The adjoint ones round every operation
// explicitly (__fmul_rn, __fsub_rn, __fmaf_rn): the routes keep a cell's
// cotangent in different places (registers across steps, or memory
// between launches), and which product the compiler fuses into an FMA
// otherwise follows the surrounding code (the difference showed in the
// sponge, where damp < 1 makes a product inexact).  The checkpoint
// interval KC and the layouts of the checkpoints [n_ck, ns, 5, F] and the
// cache [KC, ns, 5, F] are this port's own; results differ from the
// Pallas kernel only by rounding.
//
// Two routes; ops/elastic_fused.py picks one by shape before any launch
// (elastic_resident_plan for B3, elastic_forward_plan for the ring
// forward) and counts each route's launches.  The resident route has two
// shared-memory layouts (the plan's layout): see below.
//
// Resident route (el_fwd_resident, el_rev_resident; the default where
// the plan holds the grid).  The Pallas kernel keeps one shot's state,
// cotangent and KC-step caches in VMEM, one program per shot.  Here one
// thread-block cluster of C CTAs holds one shot: CTA r owns the band of
// rows [8 r, 8 r + 8) across the full width, one thread a column (8
// cells).  Shared memory holds 5 field buffers of the band with 2 halo
// rows above and below and 4 zero columns each side, and the band's six
// media (lam, l2m, muxz, bx, bz, damp).  The forward sweep keeps the
// state in the 5 buffers; a phase computes the thread's 8 cells, writes
// them and the band's 2 edge rows into the neighbours' halo rows
// (distributed shared memory), then passes one cluster barrier: two per
// step.  The reverse sweep keeps the shot's cotangent (5 fields) and its
// 5 gradient accumulators in registers at the thread's own cells, since
// no neighbour reads them; per chunk (last first) it restores the
// checkpoint into the buffers, recomputes KC steps writing the 5
// derivative terms of its own cells to the cache, and then reuses the 5
// buffers for what neighbours do read: before phase A the products
// cbar, abar, bbar, before phase B dtx bx Vx and dtx bz Vz, each computed
// once per cell (the per-step route evaluates them at 8-16 neighbours).
// Two launches per call, one per sweep; the misfit (el_misfit_cols),
// sum_shots5 and sum_loss run between and after them as on the per-step
// route.  The plan: C = nz8 / 8 CTAs (at most 16, a non-portable cluster
// size that the launch allows explicitly), nx128 threads (at most 384,
// so 168 registers a thread), 4 (5 (8 + 4)(nx128 + 8) + 6 8 nx128) bytes
// of shared memory: at 128 x 384 (the marmousi_elastic family) 16 CTAs
// of 384 threads and 167,808 B.  Taller grids take layout 1 (below);
// grids no plan holds take the per-step route.
//
// Layout 1 (el_fwd_resident<R, CK, true>, el_rev_resident_l1<R>): bands
// of R = 9 (seam_elastic's 144 x 384) or 12 rows (real_data's 192 x 384)
// on 16-CTA clusters, which layout 0 cannot hold: at 12 rows its shared
// memory would be 236,032 B (the limit is 232,448), and its reverse
// sweep already spills at 8 (80 live floats of cotangent and gradients a
// thread).  The field buffers, the halo exchange and the two barriers a
// step are as above.  The six media move out of shared memory into a
// copy laid out band by band with rows of kMaxCols floats
// (el_band_media, one launch a call), read with plain loads through L1
// (the grid is 1.3-1.8 MB and sits in the 50 MB L2 for every shot); the
// reverse sweep's 5 gradient accumulators move into shared memory at the
// thread's own cells (no neighbour reads them, so no barrier), and the
// cotangent stays in registers (45 floats at 9 rows, 60 at 12).  Shared
// memory: 4 (5 (R + 4)(nx + 8) + 5 R nx) bytes, 171,040 at R 9 and
// 217,600 at R 12; the forward sweep takes the field buffers alone
// (101,920 and 125,440).  The cache of the derivative terms is laid out
// band by band as well (l1_cache_slot), so that every offset a thread
// reads or writes is known at compile time: runtime offsets of 6 R media
// and 5 R cache cells are hoisted out of the step loop into registers and
// spilled.  Each cell's forward update is written as soon as it is
// computed (a phase reads only its neighbours' fields of the other kind).
// Prediction before the first timed run (H100, 700 W): B3's measured
// steps scaled by rows a thread, ~22 us a time step at R 9 and ~29 at
// R 12, so 55-75 ms a call at SEAM's grid (4 shots, nt 2568; from 92-113
// per-step) and 55-70 at real_data's (4 shots, nt 2001; from 83-85).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phases 4,
// 17, 20, routes in turns; PERF.md): SEAM 63.42-63.55 ms against per-step
// 90.81-91.42, real_data 63.36-63.89 against 83.71-84.20, each bit-equal
// to the per-step route; ptxas: the reverse kernels 168 registers with
// 52 B (R 9) and 32 B (R 12) of spill stores, the forward ones none.
// Layout 1 at 8-row bands runs 76.84-76.86 ms against layout 0's
// 70.98-71.10 at 128 x 384, bit-equal: reading the media through L1
// costs ~8 %.  The first
// build (media by __ldg at runtime offsets from the grid's [5, nz, nx],
// the cache in layout 0's order, the gradients behind a reference-
// returning accessor) spilled 944 B at R 12 and ran real_data's call in
// 91 ms, no faster than per-step.  The ring forward at 192 x 384 (12
// shots, 7 clusters resident, 2 waves) 29.91-30.29 ms against per-step
// 42.15-42.76.
//
// The ring forward's resident route (b3_elastic_ring_resident) is the
// same forward sweep without checkpoints, a template on the band height
// R and the layout (el_fwd_resident<R, CK, L1>): R 8 at 128 x 384 (B3's
// instance with CK, the ring forward's without), R 9 at 144 x 384 (B8 at
// marmousi_elastic's shape with an absorbing top, seam_elastic's ring
// forward), 16 CTAs and 4 (5 (R + 4)(nx + 8) + 6 R nx) bytes: 184,864 at
// R 9, all in layout 0; R 12 at 192 x 384 in layout 1 (real_data's prep
// and SU gathers).  One launch over all shots; the clusters the card
// cannot hold at once wait, so 35 shots run in waves.
// Prediction before the first timed run (H100, 700 W): one CTA an SM at
// either height, so 7 clusters resident as for B3, 35 shots in 5 waves of
// ~15 ms (B3's forward sweep, 4.5 us a step): the ring forward ~70-80 ms
// (from 137.69 per-step), B8 ~80-100 ms (from 172.17 cooperative; 9 rows
// a thread, a step ~1.1x).  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, routes in turns; PERF.md): 7 clusters resident at both
// heights; the ring forward 74.8-76.8 ms (22.7 us a step of 35 shots, 5
// waves of B3's 4.5 us step) against per-step 139.1-139.5, B8 77.0-77.4
// against a cooperative kernel's 174.2-174.5 (a 9-row step 1.02x an
// 8-row one); each bit-equal to its other route, B8 to the ring forward.
// B8's cooperative kernel was then removed: the per-step route below
// computes the same bits and was no slower (167-168 ms against 172).
//
// Per-step route (el_fwd_v, el_fwd_s, el_adj_v, el_adj_s; and the ring
// forward).  Every phase of a time step is one launch over all shots,
// one thread per cell of [ns, nz8, nx128], the fields in global memory
// (at the slice shape a field is 0.98 MB for 5 shots, so the live state
// and the media stay in the 50 MB L2): 4 launches per time step and 2
// more per step of the checkpointed forward sweep, ~20 k launches per
// call.
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
// at 3.35 TB/s.  So the function is compute-bound.  Per-step route:
// predicted 50-100 ms per call before the first run on the card;
// measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 125-162 ms,
// the card idle 23 % of a call between launches.
//
// Resident route, predicted before its first timed run (H100, 700 W):
// 5 shots fill 80 of the 132 SMs, one CTA (12 warps) an SM.  A forward
// step is 2 cluster barriers across 16 CTAs plus 8 cells of ~68 flop and
// ~20 shared-memory loads a thread: ~3-4 us.  A reverse step is a
// recomputed forward step plus an adjoint step of 2 barriers, ~99 flop
// and the 10 cache loads and stores a cell: ~8-11 us.  So the forward
// sweep ~10-13 ms and the reverse sweep ~27-37 ms: B3 ~40-55 ms per call
// (from ~128) and a marmousi_elastic physics epoch ~0.07-0.09 s (from
// 0.145-0.163).  Registers bound the reverse kernel (80 live floats a
// thread for the cotangent and the gradients).  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py, profile_torch.py; PERF.md):
// forward sweep 14.9-15.0 ms (4.5 us a step), reverse sweep 49.9-50.1 ms
// (15.0 us a recompute + adjoint pair), B3 67.1-71.2 ms against the
// per-step route's 126.6-129.8 on the same inputs, bit-equal; physics
// epochs 0.090-0.104 s.  The prediction was not met by a third.  The
// reverse kernel takes the 168 registers it may and spills 320 B a
// thread; loading the cached terms a phase ahead of their use (so that
// a barrier hides their L2 latency) changed nothing (70.8-71.1 ms
// against 70.2-70.6, more spills), so L2 latency is not what bounds it.
// 7 clusters of 16 CTAs can be resident at once (5 needed).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <initializer_list>

#include "cluster.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BX = 32;
constexpr int BY = 8;
constexpr float kC1 = 9.0f / 8.0f;
constexpr float kC2 = -1.0f / 24.0f;
constexpr float kEps = 1e-10f;
enum { VX = 0, VZ, SXX, SZZ, SXZ };           // state / cotangent fields
enum { LAM = 0, L2M, MUXZ, BXX, BZZ, DAMP };  // media / gradients
enum { T1 = 0, T2, CA, CB, CC };              // cached derivative terms
// what the adjoint phases read at neighbours: the products of the stress
// cotangents (phase A) and of the new velocity cotangents (phase B)
enum { PC = 0, PA, PB, PTX, PTZ };

struct Dims {
  int ns, nz, nx;
  long long F;  // nz * nx
};

__device__ __forceinline__ float ld0(const float* f, int i, int j,
                                     const Dims& d) {
  return (i >= 0 && i < d.nz && j >= 0 && j < d.nx) ? f[i * d.nx + j]
                                                     : 0.0f;
}

// staggered derivatives of field f of accessor r (r(f, i, j): the value
// at cell (i, j), zero outside the array), in the operation order of
// pallas_kernels._dx_fwd and the others
template <class Rd>
__device__ __forceinline__ float dxf(const Rd& r, int f, int i, int j) {
  return kC1 * (r(f, i, j + 1) - r(f, i, j)) +
         kC2 * (r(f, i, j + 2) - r(f, i, j - 1));
}
template <class Rd>
__device__ __forceinline__ float dxb(const Rd& r, int f, int i, int j) {
  return kC1 * (r(f, i, j) - r(f, i, j - 1)) +
         kC2 * (r(f, i, j + 1) - r(f, i, j - 2));
}
template <class Rd>
__device__ __forceinline__ float dzf(const Rd& r, int f, int i, int j) {
  return kC1 * (r(f, i + 1, j) - r(f, i, j)) +
         kC2 * (r(f, i + 2, j) - r(f, i - 1, j));
}
template <class Rd>
__device__ __forceinline__ float dzb(const Rd& r, int f, int i, int j) {
  return kC1 * (r(f, i, j) - r(f, i - 1, j)) +
         kC2 * (r(f, i + 1, j) - r(f, i - 2, j));
}

// The same four derivatives with every operation rounded explicitly
// (no contraction left to the compiler), for the adjoint phases: there
// the two routes hold a cell's values in different places (registers
// across steps, or memory between launches), and the compiler's choice
// of which product to fuse into an FMA follows the surrounding code.
__device__ __forceinline__ float d4_rn(float p1, float p0, float p2,
                                       float pm) {
  return __fmaf_rn(kC1, __fsub_rn(p1, p0), __fmul_rn(kC2, __fsub_rn(p2, pm)));
}
template <class Rd>
__device__ __forceinline__ float dxf_rn(const Rd& r, int f, int i, int j) {
  return d4_rn(r(f, i, j + 1), r(f, i, j), r(f, i, j + 2), r(f, i, j - 1));
}
template <class Rd>
__device__ __forceinline__ float dxb_rn(const Rd& r, int f, int i, int j) {
  return d4_rn(r(f, i, j), r(f, i, j - 1), r(f, i, j + 1), r(f, i, j - 2));
}
template <class Rd>
__device__ __forceinline__ float dzf_rn(const Rd& r, int f, int i, int j) {
  return d4_rn(r(f, i + 1, j), r(f, i, j), r(f, i + 2, j), r(f, i - 1, j));
}
template <class Rd>
__device__ __forceinline__ float dzb_rn(const Rd& r, int f, int i, int j) {
  return d4_rn(r(f, i, j), r(f, i - 1, j), r(f, i + 1, j), r(f, i - 2, j));
}

struct Src {
  const int* src_z;
  const int* src_x;
  const int* rcv_row;
  const float* gain;  // [ns] dt/dx^2 l2m[src]
  const float* wav;   // [ns, nt_wav]
  int nt_wav;
};

// --- the per-cell arithmetic of the four phases (both routes) -----------

// Forward phase V: vx, vz old in, new out; t1, t2 the cached terms.
template <class Rd>
__device__ __forceinline__ void fwd_v_cell(const Rd& r, int i, int j,
                                           float dm, float bx, float bz,
                                           float dtx, float& vx, float& vz,
                                           float& t1, float& t2) {
  t1 = dxf(r, SXX, i, j) + dzb(r, SXZ, i, j);
  vx = dm * (vx + dtx * bx * t1);
  t2 = dxb(r, SXZ, i, j) + dzf(r, SZZ, i, j);
  vz = dm * (vz + dtx * bz * t2);
}

// Forward phase S at time t: the stresses old in, new out; a, b, cc the
// cached terms.  is_src: the shot's source cell; is_fs: the free-surface
// row.
template <class Rd>
__device__ __forceinline__ void fwd_s_cell(const Rd& r, int i, int j,
                                           float lam, float l2m, float muxz,
                                           float dm, float dtx, bool is_src,
                                           const Src& src, int s, int t,
                                           bool is_fs, float& sxx, float& szz,
                                           float& sxz, float& a, float& b,
                                           float& cc) {
  a = dxb(r, VX, i, j);
  b = dzb(r, VZ, i, j);
  sxx = dm * (sxx + dtx * (l2m * a + lam * b));
  szz = dm * (szz + dtx * (lam * a + l2m * b));
  if (is_src) {
    const float amp = src.wav[(long long)s * src.nt_wav + t] * src.gain[s];
    sxx += amp;
    szz += amp;
  }
  if (is_fs) szz = 0.0f;
  cc = dxf(r, VZ, i, j) + dzf(r, VX, i, j);
  sxz = dm * (sxz + dtx * muxz * cc);
}

// The cotangents flowing into the velocities from the stress updates:
//   cbar = dtx muxz damp Sxz
//   abar = dtx lam damp w4 + dtx l2m damp Sxx,  w4 = fs Szz
//   bbar = dtx l2m damp w4 + dtx lam damp Sxx
// and into the stresses from the velocity updates: dtx b W (t1bar with
// bx and Vx, t2bar with bz and Vz).  The per-step route evaluates them
// where the derivatives use them, the resident route stores them; like
// the adjoint phases below, every operation is rounded explicitly, so
// that both give the same bits.
__device__ __forceinline__ float cbar_val(float dtx, float muxz, float dm,
                                          float sxz) {
  return __fmul_rn(__fmul_rn(dtx, muxz), __fmul_rn(dm, sxz));
}
__device__ __forceinline__ float abar_val(float dtx, float lam, float l2m,
                                          float dm, float w4, float sxx) {
  return __fmaf_rn(__fmul_rn(__fmul_rn(dtx, l2m), dm), sxx,
                   __fmul_rn(__fmul_rn(__fmul_rn(dtx, lam), dm), w4));
}
__device__ __forceinline__ float bbar_val(float dtx, float lam, float l2m,
                                          float dm, float w4, float sxx) {
  return __fmaf_rn(__fmul_rn(__fmul_rn(dtx, lam), dm), sxx,
                   __fmul_rn(__fmul_rn(__fmul_rn(dtx, l2m), dm), w4));
}
__device__ __forceinline__ float tbar_val(float dtx, float b, float w) {
  return __fmul_rn(__fmul_rn(dtx, b), w);
}

// Adjoint phase A: vx, vz the velocity cotangents (receiver row already
// injected) in, w1 = damp Vx', w2 = damp Vz' out; r reads PC, PA, PB.
template <class Rd>
__device__ __forceinline__ void adj_v_cell(const Rd& r, int i, int j,
                                           float dm, float dtx, float t1,
                                           float t2, float& vx, float& vz,
                                           float& gbx, float& gbz) {
  // Vz -= Dxb(cbar); Vx -= Dzb(cbar); Vx -= Dxf(abar); Vz -= Dzf(bbar)
  vz = __fsub_rn(vz, dxb_rn(r, PC, i, j));
  vx = __fsub_rn(vx, dzb_rn(r, PC, i, j));
  vx = __fsub_rn(vx, dxf_rn(r, PA, i, j));
  vz = __fsub_rn(vz, dzf_rn(r, PB, i, j));
  vx = __fmul_rn(dm, vx);
  vz = __fmul_rn(dm, vz);
  gbz = __fmaf_rn(__fmul_rn(dtx, t2), vz, gbz);
  gbx = __fmaf_rn(__fmul_rn(dtx, t1), vx, gbx);
}

// Adjoint phase B at time t (wav_t unscaled): the stress cotangents in
// and out; r reads PTX, PTZ (of the new velocity cotangents).
template <class Rd>
__device__ __forceinline__ void adj_s_cell(
    const Rd& r, int i, int j, float dm, float dtx, float dt_invdx2, float a,
    float b, float cc, bool is_src, const Src& src, int s, int t, bool is_fs,
    float& sxx, float& szz, float& sxz, float& glam, float& gl2m,
    float& gmuxz) {
  const float s0 = sxx;
  const float w4 = is_fs ? 0.0f : szz;
  const float w5 = __fmul_rn(dm, sxz);
  const float da = __fmul_rn(__fmul_rn(dtx, a), dm);
  const float db = __fmul_rn(__fmul_rn(dtx, b), dm);
  gmuxz = __fmaf_rn(__fmul_rn(dtx, cc), w5, gmuxz);
  glam = __fmaf_rn(da, w4, glam);
  gl2m = __fmaf_rn(db, w4, gl2m);
  gl2m = __fmaf_rn(da, s0, gl2m);
  glam = __fmaf_rn(db, s0, glam);
  if (is_src)
    gl2m = __fmaf_rn(
        __fmul_rn(src.wav[(long long)s * src.nt_wav + t], dt_invdx2),
        __fadd_rn(s0, w4), gl2m);
  // Sxz = w5 - Dxf(t2bar) - Dzf(t1bar); Szz = damp w4 - Dzb(t2bar);
  // Sxx = damp Sxx - Dxb(t1bar)
  sxz = __fsub_rn(__fsub_rn(w5, dxf_rn(r, PTZ, i, j)), dzf_rn(r, PTX, i, j));
  szz = __fsub_rn(__fmul_rn(dm, w4), dzb_rn(r, PTZ, i, j));
  sxx = __fsub_rn(__fmul_rn(dm, s0), dxb_rn(r, PTX, i, j));
}

// --- per-step route ------------------------------------------------------

// One shot's [5, F] fields in global memory, zero outside the array.
struct GlobalRd {
  const float* f;
  Dims d;
  __device__ float operator()(int k, int i, int j) const {
    return ld0(f + k * d.F, i, j, d);
  }
};

// The adjoint products at a (possibly out-of-range) cell, evaluated from
// the media and one shot's cotangent [5, F] (0 outside the array).
struct ProductRd {
  const float* med;
  const float* damp;
  const float* cot;
  int fs_row;
  float dtx;
  Dims d;
  __device__ float operator()(int p, int i, int j) const {
    if (i < 0 || i >= d.nz || j < 0 || j >= d.nx) return 0.0f;
    const int k = i * d.nx + j;
    const long long F = d.F;
    const float dm = damp[k];
    if (p == PC) return cbar_val(dtx, med[MUXZ * F + k], dm, cot[SXZ * F + k]);
    if (p == PTX) return tbar_val(dtx, med[BXX * F + k], cot[VX * F + k]);
    if (p == PTZ) return tbar_val(dtx, med[BZZ * F + k], cot[VZ * F + k]);
    const float w4 = i == fs_row ? 0.0f : cot[SZZ * F + k];
    const float sxx = cot[SXX * F + k];
    const float lam = med[LAM * F + k];
    const float l2m = med[L2M * F + k];
    return p == PA ? abar_val(dtx, lam, l2m, dm, w4, sxx)
                   : bbar_val(dtx, lam, l2m, dm, w4, sxx);
  }
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
  float vx = st[VX * F + idx], vz = st[VZ * F + idx], t1, t2;
  fwd_v_cell(GlobalRd{st, d}, i, j, damp[idx], med[BXX * F + idx],
             med[BZZ * F + idx], dtx, vx, vz, t1, t2);
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
  float sxx = st[SXX * F + idx], szz = st[SZZ * F + idx],
        sxz = st[SXZ * F + idx], a, b, cc;
  fwd_s_cell(GlobalRd{st, d}, i, j, med[LAM * F + idx], med[L2M * F + idx],
             med[MUXZ * F + idx], damp[idx], dtx,
             i == src.src_z[s] && j == src.src_x[s], src, s, t, i == fs_row,
             sxx, szz, sxz, a, b, cc);
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
  float vx = cs[VX * F + idx];
  float vz = cs[VZ * F + idx];
  if (i == src.rcv_row[s]) {
    const long long r = ((long long)s * nt_rows + t) * d.nx + j;
    vx += ybar[r];
    vz += ybar[(long long)d.ns * nt_rows * d.nx + r];
  }
  const float* c = cache + s * 5 * F;
  float* g = gmed + s * 5 * F;
  float gbx = g[BXX * F + idx], gbz = g[BZZ * F + idx];
  adj_v_cell(ProductRd{med, damp, cs, fs_row, dtx, d}, i, j, damp[idx], dtx,
             c[T1 * F + idx], c[T2 * F + idx], vx, vz, gbx, gbz);
  cs[VX * F + idx] = vx;
  cs[VZ * F + idx] = vz;
  g[BXX * F + idx] = gbx;
  g[BZZ * F + idx] = gbz;
}

// Adjoint phase B at time t.
__global__ void el_adj_s(const float* __restrict__ med,
                         const float* __restrict__ damp, float* cot,
                         const float* __restrict__ cache,
                         float* __restrict__ gmed, Src src, int t,
                         int fs_row, Dims d, float dtx, float dt_invdx2) {
  CELL_INDEX
  float* cs = cot + s * 5 * F;
  const float* c = cache + s * 5 * F;
  float* g = gmed + s * 5 * F;
  float sxx = cs[SXX * F + idx], szz = cs[SZZ * F + idx],
        sxz = cs[SXZ * F + idx];
  float glam = g[LAM * F + idx], gl2m = g[L2M * F + idx],
        gmuxz = g[MUXZ * F + idx];
  adj_s_cell(ProductRd{med, damp, cs, fs_row, dtx, d}, i, j, damp[idx], dtx,
             dt_invdx2, c[CA * F + idx], c[CB * F + idx], c[CC * F + idx],
             i == src.src_z[s] && j == src.src_x[s], src, s, t, i == fs_row,
             sxx, szz, sxz, glam, gl2m, gmuxz);
  g[LAM * F + idx] = glam;
  g[L2M * F + idx] = gl2m;
  g[MUXZ * F + idx] = gmuxz;
  cs[SXX * F + idx] = sxx;
  cs[SZZ * F + idx] = szz;
  cs[SXZ * F + idx] = sxz;
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


// ---------------------------------------------------------------------------
// Resident route: one thread-block cluster per shot (see the note above).
// Grid (C, ns), cluster (C, 1, 1): CTA r = blockIdx.x of shot blockIdx.y,
// thread x owns column x of rows [R r, R r + R).  Every thread reaches
// every cluster barrier.  Two shared-memory layouts (the plan's
// `layout`, template parameter L1):
//   0  the band's six media in shared memory; B3's reverse sweep keeps its
//      gradient accumulators in registers.  Bands of 8 rows (B3), 8 or 9
//      (the forward sweep alone).
//   1  the media read from global memory (L1, and the L2 that holds
//      every shot's grid), from a copy laid out band by band with rows of
//      kMaxCols floats (el_band_media), so that a thread's reads sit at
//      offsets known at compile time from one pointer; the reverse sweep
//      keeps its gradient accumulators in shared memory at the thread's
//      own cells.  Bands of 9 or 12 rows (B3; 8 too, timed against layout
//      0), 12 (the forward sweep alone).
// ---------------------------------------------------------------------------

constexpr int kRows = 8;        // band rows: the rows a thread owns
constexpr int kRowsTall = 9;    // layout 0 forward alone; layout 1 B3
constexpr int kRowsL1 = 12;     // layout 1's tallest band
constexpr int kMaxCols = 384;   // threads (columns) at most: 168 registers
constexpr int kMaxCluster = 16;
constexpr int kPad = 4;         // zero columns each side (2 are read)

// 5 field buffers of (R + 4) x (nx + 8) floats
int el_fields_smem(int R, int nx) {
  return (int)sizeof(float) * 5 * (R + 4) * (nx + 2 * kPad);
}

// A kernel's shared memory: the field buffers and, in layout 0, the
// band's 6 media, in layout 1 the reverse sweep's 5 gradient accumulators
// (the forward sweep alone needs none).
int el_plan_smem(int R, int nx, int layout, bool reverse) {
  const int band = (int)sizeof(float) * R * nx;
  return el_fields_smem(R, nx) +
         (layout == 0 ? 6 * band : (reverse ? 5 * band : 0));
}

// A CTA's band of R rows in shared memory: 5 field buffers of (R + 4) x P
// floats (P = nx + 8; buffer row lr + 2 holds band row lr, column j + 4
// column j), then (layout 0) the band's 6 media ([R, nx] each).  Buffer f
// sits at offset f fsz, here and in the neighbours.
template <int R, bool L1>
struct BandR {
  int row0, nx, P, fsz;
  float* sm;
  float* up;  // the upper neighbour's buffers (null for the top band)
  float* dn;  // the lower neighbour's (null for the bottom band)
  // layout 0: the band's [6, R, nx] in shared memory; layout 1: the
  // thread's column of the band's [6, R, kMaxCols] in el_band_media's copy
  const float* med;
  __device__ int at(int f, int lr) const {
    return f * fsz + (lr + 2) * P + (int)threadIdx.x + kPad;
  }
  // medium k at the thread's cell of band row lr.  Layout 1 reads with a
  // plain load: one that the compiler may treat as invariant (__ldg)
  // would be hoisted out of the time loop into 6 R registers.
  __device__ float m(int k, int lr) const {
    if constexpr (L1) {
      return med[(k * R + lr) * kMaxCols];
    } else {
      return med[(k * R + lr) * nx + threadIdx.x];
    }
  }
  // write v at the thread's cell of band row lr of buffer f and, for the
  // band's 2 edge rows, into the neighbours' halo rows
  __device__ void put(int f, int lr, float v) const {
    const int c = f * fsz + (int)threadIdx.x + kPad;
    sm[c + (lr + 2) * P] = v;
    if (lr < 2 && up) up[c + (R + 2 + lr) * P] = v;
    if (lr >= R - 2 && dn) dn[c + (lr - R + 2) * P] = v;
  }
};

using Band = BandR<kRows, false>;

// The band's buffers as an accessor of global rows i
struct SharedRd {
  const float* sm;
  int fsz, P, row0;
  __device__ float operator()(int f, int i, int j) const {
    return sm[f * fsz + (i - row0 + 2) * P + j + kPad];
  }
};

struct ElArgs {
  const float* med;   // [5, nz, nx]
  const float* damp;  // [nz, nx]
  float* medb;        // layout 1: [C, 6, R, kMaxCols] (el_band_media)
  Src src;
  float* ckpt;        // [n_ck, ns, 5, nz, nx]
  float* hist;        // forward: [2, ns, nt_rows, nx] receiver rows;
                      // reverse: their cotangents
  float* cache;       // scratch (reverse): layout 0 [KC, ns, 5, nz, nx],
                      // layout 1 l1_cache_slot's
  float* gmed;        // [ns, 5, nz, nx] per-shot gradients (reverse)
  int ns, nz, nx, nt_rows, nt_valid, n_ck, KC, fs_row;
  float dtx, dt_invdx2;
};

// Zero the buffers (halos and pad columns stay zero unless a neighbour
// writes them) and, in layout 0, load the band's media.  The caller
// passes a cluster barrier before any neighbour writes into the halos.
template <int R, bool L1>
__device__ __forceinline__ BandR<R, L1> band_init(float* smem,
                                                  const ElArgs& a) {
  BandR<R, L1> b;
  const int r = blockIdx.x, C = gridDim.x;
  b.row0 = r * R;
  b.nx = a.nx;
  b.P = a.nx + 2 * kPad;
  b.fsz = (R + 4) * b.P;
  b.sm = smem;
  cg::cluster_group cl = cg::this_cluster();
  b.up = r > 0 ? cl.map_shared_rank(smem, r - 1) : nullptr;
  b.dn = r + 1 < C ? cl.map_shared_rank(smem, r + 1) : nullptr;
  for (int q = threadIdx.x; q < 5 * b.fsz; q += blockDim.x) smem[q] = 0.0f;
  if constexpr (L1) {
    b.med = a.medb + (long long)r * 6 * R * kMaxCols + threadIdx.x;
  } else {
    float* med = smem + 5 * b.fsz;
    b.med = med;
    const long long F = (long long)a.nz * a.nx;
    const int j = threadIdx.x;
#pragma unroll
    for (int lr = 0; lr < R; ++lr) {
      const long long g = (long long)(b.row0 + lr) * a.nx + j;
#pragma unroll
      for (int k = 0; k < 5; ++k)
        med[(k * R + lr) * a.nx + j] = a.med[k * F + g];
      med[(DAMP * R + lr) * a.nx + j] = a.damp[g];
    }
  }
  return b;
}

// One forward step of the band at time t (the state in the buffers),
// each phase ending at a cluster barrier.  cache (optional): this shot's
// [5, F] slot of the step's derivative terms; hist (optional): the
// receiver rows.  Layout 0's; layout 1's is the overload below.
template <int R>
__device__ __forceinline__ void band_fwd_step(const BandR<R, false>& b,
                                              const ElArgs& a, int s, int t,
                                              float* cache, float* hist) {
  const int j = threadIdx.x;
  const long long F = (long long)a.nz * a.nx;
  const SharedRd r{b.sm, b.fsz, b.P, b.row0};
  const int rr = a.src.rcv_row[s], sz = a.src.src_z[s], sx = a.src.src_x[s];
  float u[R], w[R];
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    const int i = b.row0 + lr;
    float t1, t2;
    u[lr] = b.sm[b.at(VX, lr)];
    w[lr] = b.sm[b.at(VZ, lr)];
    fwd_v_cell(r, i, j, b.m(DAMP, lr), b.m(BXX, lr), b.m(BZZ, lr), a.dtx,
               u[lr], w[lr], t1, t2);
    if (cache) {
      cache[T1 * F + (long long)i * a.nx + j] = t1;
      cache[T2 * F + (long long)i * a.nx + j] = t2;
    }
  }
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    b.put(VX, lr, u[lr]);
    b.put(VZ, lr, w[lr]);
    const int i = b.row0 + lr;
    if (hist && i == rr && t < a.nt_valid) {
      const long long q = ((long long)s * a.nt_rows + t) * a.nx + j;
      hist[q] = u[lr];
      hist[(long long)a.ns * a.nt_rows * a.nx + q] = w[lr];
    }
  }
  cluster_barrier();
  float v[R];
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    const int i = b.row0 + lr;
    float ca, cb, cc;
    u[lr] = b.sm[b.at(SXX, lr)];
    w[lr] = b.sm[b.at(SZZ, lr)];
    v[lr] = b.sm[b.at(SXZ, lr)];
    fwd_s_cell(r, i, j, b.m(LAM, lr), b.m(L2M, lr), b.m(MUXZ, lr),
               b.m(DAMP, lr), a.dtx, i == sz && j == sx, a.src, s, t,
               i == a.fs_row, u[lr], w[lr], v[lr], ca, cb, cc);
    if (cache) {
      cache[CA * F + (long long)i * a.nx + j] = ca;
      cache[CB * F + (long long)i * a.nx + j] = cb;
      cache[CC * F + (long long)i * a.nx + j] = cc;
    }
  }
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    b.put(SXX, lr, u[lr]);
    b.put(SZZ, lr, w[lr]);
    b.put(SXZ, lr, v[lr]);
  }
  cluster_barrier();
}

// Forward sweep of n_ck KC steps from zero fields in bands of R rows,
// the receiver rows to hist.  CK: B3's phase 1, the state written to
// ckpt before every KC-th step; without CK the ring forward (and B8),
// n_ck = 1 chunk of nt steps and no checkpoint.
template <int R, bool CK, bool L1>
__global__ void __launch_bounds__(kMaxCols, 1) el_fwd_resident(ElArgs a) {
  extern __shared__ float4 smem4[];
  const BandR<R, L1> b =
      band_init<R, L1>(reinterpret_cast<float*>(smem4), a);
  cluster_barrier();
  const int s = blockIdx.y, j = threadIdx.x;
  const long long F = (long long)a.nz * a.nx;
  const int nsteps = a.n_ck * a.KC;
  for (int t = 0; t < nsteps; ++t) {
    if constexpr (CK) {
      if (t % a.KC == 0) {
        float* ck = a.ckpt + ((long long)(t / a.KC) * a.ns + s) * 5 * F;
#pragma unroll
        for (int f = 0; f < 5; ++f)
#pragma unroll
          for (int lr = 0; lr < R; ++lr)
            ck[f * F + (long long)(b.row0 + lr) * a.nx + j] =
                b.sm[b.at(f, lr)];
      }
    }
    band_fwd_step(b, a, s, t, nullptr, a.hist);
  }
}

// The products of the thread's stress cotangents (cot: Sxx, Szz, Sxz of
// band row lr) into PC, PA, PB.
template <int R, bool L1>
__device__ __forceinline__ void put_stress_products(const BandR<R, L1>& b,
                                                    const ElArgs& a, int lr,
                                                    float sxx, float szz,
                                                    float sxz) {
  const int i = b.row0 + lr;
  const float dm = b.m(DAMP, lr), lam = b.m(LAM, lr), l2m = b.m(L2M, lr);
  const float w4 = i == a.fs_row ? 0.0f : szz;
  b.put(PC, lr, cbar_val(a.dtx, b.m(MUXZ, lr), dm, sxz));
  b.put(PA, lr, abar_val(a.dtx, lam, l2m, dm, w4, sxx));
  b.put(PB, lr, bbar_val(a.dtx, lam, l2m, dm, w4, sxx));
}

// Reverse sweep, chunk by chunk from the checkpoints (last first): B3's
// phase 3.  Layout 0: the cotangent and the gradients stay in registers.
// The reverse sweeps of the two layouts are separate kernels (and so are
// their forward steps): layout 0's takes the 168 registers it may and
// spills, so its code is kept as it was measured (the same arithmetic in
// one template with layout 1's spilled 428 B against 320).
__global__ void __launch_bounds__(kMaxCols, 1) el_rev_resident(ElArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Band b = band_init<kRows, false>(smem, a);
  const int s = blockIdx.y, j = threadIdx.x;
  const long long F = (long long)a.nz * a.nx;
  const SharedRd r{b.sm, b.fsz, b.P, b.row0};
  const int rr = a.src.rcv_row[s], sz = a.src.src_z[s], sx = a.src.src_x[s];
  const long long yz = (long long)a.ns * a.nt_rows * a.nx;
  float cot[5][kRows], g[5][kRows];
#pragma unroll
  for (int f = 0; f < 5; ++f)
#pragma unroll
    for (int lr = 0; lr < kRows; ++lr) cot[f][lr] = g[f][lr] = 0.0f;
  for (int ck = a.n_ck - 1; ck >= 0; --ck) {
    cluster_barrier();  // every CTA is done with the buffers
    // restore the state with its halo rows from the checkpoint
    const float* src = a.ckpt + ((long long)ck * a.ns + s) * 5 * F;
#pragma unroll
    for (int f = 0; f < 5; ++f)
      for (int lr = -2; lr < kRows + 2; ++lr) {
        const int gi = b.row0 + lr;
        b.sm[f * b.fsz + (lr + 2) * b.P + j + kPad] =
            gi >= 0 && gi < a.nz ? src[f * F + (long long)gi * a.nx + j]
                                 : 0.0f;
      }
    cluster_barrier();  // no neighbour writes a halo row being restored
    for (int kk = 0; kk < a.KC; ++kk)
      band_fwd_step(b, a, s, ck * a.KC + kk,
                    a.cache + ((long long)kk * a.ns + s) * 5 * F, nullptr);
#pragma unroll
    for (int lr = 0; lr < kRows; ++lr)
      put_stress_products(b, a, lr, cot[SXX][lr], cot[SZZ][lr],
                          cot[SXZ][lr]);
    cluster_barrier();
    for (int kk = a.KC - 1; kk >= 0; --kk) {
      const int t = ck * a.KC + kk;
      const float* c = a.cache + ((long long)kk * a.ns + s) * 5 * F;
      // phase A
#pragma unroll
      for (int lr = 0; lr < kRows; ++lr) {
        const int i = b.row0 + lr;
        const long long q = (long long)i * a.nx + j;
        float vx = cot[VX][lr], vz = cot[VZ][lr];
        if (i == rr) {
          const long long y = ((long long)s * a.nt_rows + t) * a.nx + j;
          vx += a.hist[y];
          vz += a.hist[yz + y];
        }
        adj_v_cell(r, i, j, b.m(DAMP, lr), a.dtx, c[T1 * F + q],
                   c[T2 * F + q], vx, vz, g[BXX][lr], g[BZZ][lr]);
        cot[VX][lr] = vx;
        cot[VZ][lr] = vz;
      }
#pragma unroll
      for (int lr = 0; lr < kRows; ++lr) {
        b.put(PTX, lr, tbar_val(a.dtx, b.m(BXX, lr), cot[VX][lr]));
        b.put(PTZ, lr, tbar_val(a.dtx, b.m(BZZ, lr), cot[VZ][lr]));
      }
      cluster_barrier();
      // phase B, then the products of the new stress cotangents for the
      // next step's phase A
#pragma unroll
      for (int lr = 0; lr < kRows; ++lr) {
        const int i = b.row0 + lr;
        const long long q = (long long)i * a.nx + j;
        adj_s_cell(r, i, j, b.m(DAMP, lr), a.dtx, a.dt_invdx2, c[CA * F + q],
                   c[CB * F + q], c[CC * F + q], i == sz && j == sx, a.src, s,
                   t, i == a.fs_row, cot[SXX][lr], cot[SZZ][lr],
                   cot[SXZ][lr], g[LAM][lr], g[L2M][lr], g[MUXZ][lr]);
      }
#pragma unroll
      for (int lr = 0; lr < kRows; ++lr)
        put_stress_products(b, a, lr, cot[SXX][lr], cot[SZZ][lr],
                            cot[SXZ][lr]);
      cluster_barrier();
    }
  }
  float* gs = a.gmed + (long long)s * 5 * F;
#pragma unroll
  for (int f = 0; f < 5; ++f)
#pragma unroll
    for (int lr = 0; lr < kRows; ++lr)
      gs[f * F + (long long)(b.row0 + lr) * a.nx + j] = g[f][lr];
}

// ---- layout 1 ------------------------------------------------------------
// B3's cache of the derivative terms (ElArgs::cache) in layout 1:
// [KC, ns, C, 5, R, kMaxCols].  The slot of step kk of the chunk for shot
// s points at the thread's column of its band, and term f of band row lr
// sits at an offset known at compile time (runtime offsets are hoisted out
// of the step loop into registers).
template <int R>
__device__ __forceinline__ float* l1_cache_slot(const ElArgs& a, int kk,
                                                int s) {
  return a.cache +
         (((long long)kk * a.ns + s) * gridDim.x + blockIdx.x) * 5 * R *
             kMaxCols +
         threadIdx.x;
}
template <int R>
__device__ __forceinline__ int l1_co(int f, int lr) {
  return (f * R + lr) * kMaxCols;
}

// Layout 1's forward step: as layout 0's, but a phase reads its
// neighbours' fields of the other kind (V the stresses, S the velocities)
// and its own cells of the kind it writes, so each cell is written as soon
// as it is computed (fewer live registers beside the reverse sweep's
// cotangent).  cache (optional): l1_cache_slot.
template <int R>
__device__ __forceinline__ void band_fwd_step(const BandR<R, true>& b,
                                              const ElArgs& a, int s, int t,
                                              float* cache, float* hist) {
  const int j = threadIdx.x;
  const SharedRd r{b.sm, b.fsz, b.P, b.row0};
  const int rr = a.src.rcv_row[s], sz = a.src.src_z[s], sx = a.src.src_x[s];
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    const int i = b.row0 + lr;
    float t1, t2;
    float u = b.sm[b.at(VX, lr)], w = b.sm[b.at(VZ, lr)];
    fwd_v_cell(r, i, j, b.m(DAMP, lr), b.m(BXX, lr), b.m(BZZ, lr), a.dtx, u,
               w, t1, t2);
    if (cache) {
      cache[l1_co<R>(T1, lr)] = t1;
      cache[l1_co<R>(T2, lr)] = t2;
    }
    b.put(VX, lr, u);
    b.put(VZ, lr, w);
    if (hist && i == rr && t < a.nt_valid) {
      const long long q = ((long long)s * a.nt_rows + t) * a.nx + j;
      hist[q] = u;
      hist[(long long)a.ns * a.nt_rows * a.nx + q] = w;
    }
  }
  cluster_barrier();
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    const int i = b.row0 + lr;
    float ca, cb, cc;
    float u = b.sm[b.at(SXX, lr)], w = b.sm[b.at(SZZ, lr)],
          v = b.sm[b.at(SXZ, lr)];
    fwd_s_cell(r, i, j, b.m(LAM, lr), b.m(L2M, lr), b.m(MUXZ, lr),
               b.m(DAMP, lr), a.dtx, i == sz && j == sx, a.src, s, t,
               i == a.fs_row, u, w, v, ca, cb, cc);
    if (cache) {
      cache[l1_co<R>(CA, lr)] = ca;
      cache[l1_co<R>(CB, lr)] = cb;
      cache[l1_co<R>(CC, lr)] = cc;
    }
    b.put(SXX, lr, u);
    b.put(SZZ, lr, w);
    b.put(SXZ, lr, v);
  }
  cluster_barrier();
}

// Layout 1's reverse sweep: layout 0's with the 5 gradient accumulators in
// shared memory ([5, R, nx] after the field buffers, each thread its own
// cells, so no barrier guards them) and the cotangent in registers.
template <int R>
__global__ void __launch_bounds__(kMaxCols, 1) el_rev_resident_l1(ElArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const BandR<R, true> b = band_init<R, true>(smem, a);
  const int s = blockIdx.y, j = threadIdx.x;
  const long long F = (long long)a.nz * a.nx;
  const SharedRd r{b.sm, b.fsz, b.P, b.row0};
  const int rr = a.src.rcv_row[s], sz = a.src.src_z[s], sx = a.src.src_x[s];
  const long long yz = (long long)a.ns * a.nt_rows * a.nx;
  float* g = smem + 5 * b.fsz + j;  // g[(f R + lr) nx]: gradient f, row lr
  float cot[5][R];
#pragma unroll
  for (int f = 0; f < 5; ++f)
#pragma unroll
    for (int lr = 0; lr < R; ++lr) {
      cot[f][lr] = 0.0f;
      g[(f * R + lr) * a.nx] = 0.0f;
    }
  for (int ck = a.n_ck - 1; ck >= 0; --ck) {
    cluster_barrier();  // every CTA is done with the buffers
    // restore the state with its halo rows from the checkpoint
    const float* src = a.ckpt + ((long long)ck * a.ns + s) * 5 * F;
#pragma unroll
    for (int f = 0; f < 5; ++f)
      for (int lr = -2; lr < R + 2; ++lr) {
        const int gi = b.row0 + lr;
        b.sm[f * b.fsz + (lr + 2) * b.P + j + kPad] =
            gi >= 0 && gi < a.nz ? src[f * F + (long long)gi * a.nx + j]
                                 : 0.0f;
      }
    cluster_barrier();  // no neighbour writes a halo row being restored
    for (int kk = 0; kk < a.KC; ++kk)
      band_fwd_step(b, a, s, ck * a.KC + kk, l1_cache_slot<R>(a, kk, s),
                    nullptr);
#pragma unroll
    for (int lr = 0; lr < R; ++lr)
      put_stress_products(b, a, lr, cot[SXX][lr], cot[SZZ][lr],
                          cot[SXZ][lr]);
    cluster_barrier();
    for (int kk = a.KC - 1; kk >= 0; --kk) {
      const int t = ck * a.KC + kk;
      const float* c = l1_cache_slot<R>(a, kk, s);
      // phase A
#pragma unroll
      for (int lr = 0; lr < R; ++lr) {
        const int i = b.row0 + lr;
        float vx = cot[VX][lr], vz = cot[VZ][lr];
        if (i == rr) {
          const long long y = ((long long)s * a.nt_rows + t) * a.nx + j;
          vx += a.hist[y];
          vz += a.hist[yz + y];
        }
        adj_v_cell(r, i, j, b.m(DAMP, lr), a.dtx, c[l1_co<R>(T1, lr)],
                   c[l1_co<R>(T2, lr)], vx, vz, g[(BXX * R + lr) * a.nx],
                   g[(BZZ * R + lr) * a.nx]);
        cot[VX][lr] = vx;
        cot[VZ][lr] = vz;
      }
#pragma unroll
      for (int lr = 0; lr < R; ++lr) {
        b.put(PTX, lr, tbar_val(a.dtx, b.m(BXX, lr), cot[VX][lr]));
        b.put(PTZ, lr, tbar_val(a.dtx, b.m(BZZ, lr), cot[VZ][lr]));
      }
      cluster_barrier();
      // phase B, then the products of the new stress cotangents for the
      // next step's phase A
#pragma unroll
      for (int lr = 0; lr < R; ++lr) {
        const int i = b.row0 + lr;
        adj_s_cell(r, i, j, b.m(DAMP, lr), a.dtx, a.dt_invdx2,
                   c[l1_co<R>(CA, lr)], c[l1_co<R>(CB, lr)],
                   c[l1_co<R>(CC, lr)], i == sz && j == sx, a.src, s, t,
                   i == a.fs_row, cot[SXX][lr], cot[SZZ][lr], cot[SXZ][lr],
                   g[(LAM * R + lr) * a.nx], g[(L2M * R + lr) * a.nx],
                   g[(MUXZ * R + lr) * a.nx]);
      }
#pragma unroll
      for (int lr = 0; lr < R; ++lr)
        put_stress_products(b, a, lr, cot[SXX][lr], cot[SZZ][lr],
                            cot[SXZ][lr]);
      cluster_barrier();
    }
  }
  float* gs = a.gmed + (long long)s * 5 * F;
#pragma unroll
  for (int f = 0; f < 5; ++f)
#pragma unroll
    for (int lr = 0; lr < R; ++lr)
      gs[f * F + (long long)(b.row0 + lr) * a.nx + j] = g[(f * R + lr) * a.nx];
}

inline dim3 cell_grid(const Dims& d) {
  return dim3((d.nx + BX - 1) / BX, (d.nz + BY - 1) / BY, d.ns);
}

// Layout 1's copy of the media: medb[((r * 6 + k) * R + lr) * kMaxCols + j]
// = medium k (lam, l2m, muxz, bx, bz, damp) at row r R + lr, column j;
// one thread a cell.
__global__ void el_band_media(const float* __restrict__ med,
                              const float* __restrict__ damp, int nz, int nx,
                              int R, float* __restrict__ medb) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y, k = blockIdx.z;
  if (j >= nx || i >= nz) return;
  const long long g = (long long)i * nx + j;
  medb[((long long)(i / R * 6 + k) * R + i % R) * kMaxCols + j] =
      k == DAMP ? damp[g] : med[k * (long long)nz * nx + g];
}

cudaError_t el_prepare_media(const ElArgs& a, int R, int layout,
                             cudaStream_t st) {
  if (layout != 1) return cudaSuccess;
  if (!a.medb) return cudaErrorInvalidValue;
  el_band_media<<<dim3((a.nx + 127) / 128, a.nz, 6), 128, 0, st>>>(
      a.med, a.damp, a.nz, a.nx, R, a.medb);
  LAUNCHED();
  return cudaSuccess;
}

// The band heights each layout has instances for: B3 (both sweeps) or
// the forward sweep alone (fwd_only).
bool el_rows(int R, int layout, bool fwd_only) {
  if (layout == 0) return R == kRows || (fwd_only && R == kRowsTall);
  if (layout == 1)
    return R == kRowsL1 || (!fwd_only && (R == kRows || R == kRowsTall));
  return false;
}

// The resident plan (Plan, csrc/cluster.cuh) and layout, made by
// ops/elastic_fused.py::elastic_resident_plan (B3) or
// elastic_forward_plan (the forward sweep alone, fwd_only), cover the
// grid, one thread a column, with the shared memory the layout needs.
cudaError_t el_check_plan(const Plan& p, int layout, int nz, int nx,
                          bool fwd_only = false) {
  const bool ok = el_rows(p.R, layout, fwd_only) && p.rpt == p.R &&
                  p.C >= 1 && p.C <= kMaxCluster && p.C * p.R == nz &&
                  nx % 32 == 0 && p.threads == nx && nx <= kMaxCols &&
                  p.smem >= el_plan_smem(p.R, nx, layout, !fwd_only) &&
                  p.smem <= 232448;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// B3's two sweeps for a checked plan and layout, and the forward sweep's
// plan: in layout 1 it takes only the field buffers.
struct ElSweeps {
  ResKernel<ElArgs> fwd, rev;
  Plan fwd_plan;
};

template <int R, bool L1>
ElSweeps el_sweeps_for(const Plan& p) {
  Plan pf = p;
  if constexpr (L1) pf.smem = el_fields_smem(R, p.threads);
  if constexpr (L1)
    return {el_fwd_resident<R, true, true>, el_rev_resident_l1<R>, pf};
  else
    return {el_fwd_resident<R, true, false>, el_rev_resident, pf};
}

ElSweeps el_sweeps(const Plan& p, int layout) {
  if (layout == 0) return el_sweeps_for<kRows, false>(p);
  if (p.R == kRowsTall) return el_sweeps_for<kRowsTall, true>(p);
  if (p.R == kRowsL1) return el_sweeps_for<kRowsL1, true>(p);
  return el_sweeps_for<kRows, true>(p);
}

// The forward sweep without checkpoints for a checked plan and layout.
ResKernel<ElArgs> el_ring_kernel(const Plan& p, int layout) {
  if (layout == 1) return el_fwd_resident<kRowsL1, false, true>;
  if (p.R == kRowsTall) return el_fwd_resident<kRowsTall, false, false>;
  return el_fwd_resident<kRows, false, false>;
}

// Misfit, loss partials and the cotangent rows over hist (both routes).
cudaError_t el_misfit(float* hist, const float* obs_x, const float* obs_z,
                      const float* rmask, int ns, int nt_rows, int nt_valid,
                      int nx, float inv_count, int tnl1, double* loss_part,
                      cudaStream_t st) {
  el_misfit_cols<<<dim3((nx + 127) / 128, ns, 2), 128, 0, st>>>(
      hist, obs_x, obs_z, rmask, ns, nt_rows, nt_valid, nx, inv_count, tnl1,
      loss_part);
  LAUNCHED();
  return cudaSuccess;
}

// The gradients summed over shots and the loss (both routes).
cudaError_t el_sums(const float* gmed_shots, const double* loss_part, int ns,
                    int nx, long long F, float inv_count, float* gmed_out,
                    float* loss_out, cudaStream_t st) {
  sum_shots5<<<(unsigned)((5 * F + 255) / 256), 256, 0, st>>>(
      gmed_shots, ns, F, gmed_out);
  LAUNCHED();
  sum_loss<<<1, 1, 0, st>>>(loss_part, 2 * ns * nx, inv_count, loss_out);
  LAUNCHED();
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Ring forward, per-step route: hist[2, ns, nt, nx] receives the receiver
// rows of vx and vz every step.  state [ns, 5, nz, nx] is scratch.
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

// B3: fused loss and dJ/d(lam, l2m, muxz, bx, bz), per-step route.
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
  RET_IF(el_misfit(hist, obs_x, obs_z, rmask, ns, nt_pad, nt, nx, inv_count,
                   tnl1, loss_part, st));

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
  return el_sums(gmed_shots, loss_part, ns, nx, d.F, inv_count, gmed_out,
                 loss_out, st);
}

// B3, resident route: as b3_fused_elastic_loss_grad, without the
// per-step scratch (state, cot), then the plan (C, R, rpt, threads,
// smem) and its layout (0 or 1, see above; cudaErrorInvalidValue for a
// plan that does not hold the grid).
int b3_fused_elastic_loss_grad_resident(
    const float* med, const float* damp, const float* wav, const int* src_z,
    const int* src_x, const int* rcv_row, const float* gain,
    const float* obs_x, const float* obs_z, const float* rmask, float* ckpt,
    float* cache, float* hist, float* gmed_shots, double* loss_part,
    float* loss_out, float* gmed_out, float* medb, int ns, int nz, int nx,
    int nt, int n_ck, int KC, int fs_row, int tnl1, int C, int R, int rpt,
    int threads, int smem, int layout, float dtx, float dt_invdx2,
    float inv_count, void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(el_check_plan(p, layout, nz, nx));
  const ElSweeps k = el_sweeps(p, layout);
  cudaStream_t st = (cudaStream_t)stream;
  const int nt_pad = n_ck * KC;
  RET_IF(cudaMemsetAsync(hist, 0,
                         sizeof(float) * 2 * (size_t)ns * nt_pad * nx, st));
  const ElArgs a{med,  damp, medb, Src{src_z, src_x, rcv_row, gain, wav,
                 nt_pad}, ckpt, hist, cache, gmed_shots, ns, nz, nx, nt_pad,
                 nt,   n_ck, KC, fs_row, dtx, dt_invdx2};
  RET_IF(el_prepare_media(a, R, layout, st));
  RET_IF(launch_resident(k.fwd, a, k.fwd_plan, ns, st));
  RET_IF(el_misfit(hist, obs_x, obs_z, rmask, ns, nt_pad, nt, nx, inv_count,
                   tnl1, loss_part, st));
  RET_IF(launch_resident(k.rev, a, p, ns, st));
  return el_sums(gmed_shots, loss_part, ns, nx, (long long)nz * nx,
                 inv_count, gmed_out, loss_out, st);
}

// How many clusters of a plan and layout the card keeps resident at once
// (cudaOccupancyMaxActiveClusters) for the forward (reverse = 0) or the
// reverse kernel of B3's resident route, into *out.
int pbfwi_b3_max_clusters(int reverse, int ns, int nz, int nx, int C, int R,
                          int rpt, int threads, int smem, int layout,
                          int* out) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(el_check_plan(p, layout, nz, nx));
  const ElSweeps k = el_sweeps(p, layout);
  return reverse ? max_active_clusters<ElArgs>(k.rev, p, ns, out)
                 : max_active_clusters<ElArgs>(k.fwd, k.fwd_plan, ns, out);
}

// The ring forward, resident route: one launch of the forward sweep
// without checkpoints (el_fwd_resident<R, false, L1>) over a grid of
// (C, ns), one cluster per shot; the clusters beyond those the card keeps
// resident wait for a free slot, so the shots run in waves.  hist
// [2, ns, nt, nx] receives the receiver rows of vx and vz every step; no
// state scratch.  B8 (elastic_forward_pallas) calls it with fs_row -1.
// Then the plan (C, R, rpt, threads, smem) and its layout
// (cudaErrorInvalidValue for a plan that does not hold the grid).
int b3_elastic_ring_resident(const float* med, const float* damp,
                             const float* wav, const int* src_z,
                             const int* src_x, const int* rcv_row,
                             const float* gain, float* hist, float* medb,
                             int ns, int nz, int nx, int nt, int nt_wav,
                             int fs_row, int C, int R, int rpt, int threads,
                             int smem, int layout, float dtx, void* stream) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(el_check_plan(p, layout, nz, nx, true));
  cudaStream_t st = (cudaStream_t)stream;
  RET_IF(cudaMemsetAsync(hist, 0, sizeof(float) * 2 * (size_t)ns * nt * nx,
                         st));
  // one chunk of nt steps; no checkpoints, cache or gradients
  const ElArgs a{med, damp, medb, Src{src_z, src_x, rcv_row, gain, wav,
                 nt_wav}, nullptr, hist, nullptr, nullptr, ns, nz, nx, nt, nt,
                 1, nt, fs_row, dtx, 0.0f};
  RET_IF(el_prepare_media(a, R, layout, st));
  return launch_resident(el_ring_kernel(p, layout), a, p, ns, st);
}

// How many clusters of a plan and layout the card keeps resident at once
// for the ring forward's instance (el_fwd_resident<R, false, L1>), into
// *out.
int pbfwi_ring_max_clusters(int ns, int nz, int nx, int C, int R, int rpt,
                            int threads, int smem, int layout, int* out) {
  const Plan p{C, R, rpt, threads, smem};
  RET_IF(el_check_plan(p, layout, nz, nx, true));
  return max_active_clusters<ElArgs>(el_ring_kernel(p, layout), p, ns, out);
}

}  // extern "C"
