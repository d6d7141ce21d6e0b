// The two kernels generated per tape: the counterpart of the Pallas probe
// demos/exp_unrolled_kernel.py:49 (`build_unrolled_kernel`, the whole
// tape as straight-line code in one kernel) and of the straight-line XLA
// that fidget_tpu/eval/unrolled_fast.py traces for the per-shape
// compiled 2D path (`render_unrolled`, `render_dense`).
//
// fidget_tpu_torch/eval/unrolled_cuda.py emits one statement per tape row
// and includes this file for the rest:
//
// - U1 `fidget_unrolled_float`: lanes are pixels of a compacted worklist
//   of tiles (or of one tile covering the whole image). A thread forms
//   its pixel from its tile's origin, applies the screen -> model matrix
//   in the f32 order of render/transform.py `transform_points`, and runs
//   the program of the segment its slot lies in: a launch of one program
//   (the full leaf, the dense frame) and a union frame's P programs with
//   the full-tape fallback alike: each program is a device function of
//   its own translation unit, linked with -rdc, so that a frame's
//   programs compile in parallel (inlining a lone program in the
//   kernel's unit ran 4-11% slower and compiled slower still: PERF.md
//   §6). Invalid slots get 0.
// - U2 `fidget_unrolled_interval`: lanes are cull tiles, 32 to a group,
//   and a group's rows are spread over the U_K warps of one block. The
//   emitter renames the tape into values (registers and memory slots
//   disappear), orders them depth-first from the output and cuts that
//   order into U_K runs of equal length, one a warp, so that a warp
//   holds whole subtrees. A row that reads another warp's value runs in
//   a later stage than it: the producer stores the value to shared
//   memory (one Ival a tile, U_SH), and stages are separated by block
//   barriers (U_BAR), a few per tape, not one a row. Every row keeps
//   its operands and eval_tape_interval_fast's rules (u_min / u_max /
//   u_div / u_abs / u_square below; the rest is ops.cuh's interval
//   mode). Each warp's stream is a device function in its own
//   translation unit. The warp that computes the output writes the
//   proofs hi < 0 and lo > 0; the epilogue is fixed when the code is
//   generated (U_EPI): 0 nothing more; 1 the packed choice words [cw][n]
//   (choice j in word j / 16 at bit 2 (j % 16)); 2 the fused violation
//   flag, (w | u) != u per word. Each warp ORs its part of a word into
//   the block's words in shared memory (in a global scratch where a
//   tape's words would not fit a block); after the last stage the warps
//   write them out or test them against u together, one word in k each.
//
// - U1-3D `fidget_unrolled_voxel_depth`: the 3D renderer's unrolled leaf,
//   U1's programs behind a kernel unit of its own (U_VOXEL_KERNEL). A
//   group of G lanes (1-16, chosen from the slot count so that the grid
//   fills the card twice over) owns one (vy, vx) column of a worklist slot's sub^3
//   subtile and walks vz from the top down G voxels at a time, lane i
//   one voxel of each chunk; a ballot over the group finds the topmost
//   voxel inside (d < 0), and the group stops at the first chunk that
//   holds one: the depth bz + vz + 1, the max over the column of inside ?
//   bz + vz + 1 : 0, with no reduction. Its frame entry reads the
//   stratum's compacted worklist and live count from device memory,
//   forms each slot's corner itself and folds the depth into the floor
//   with atomicMax (no candidates tensor, no scatter); its explicit entry
//   takes the corners as planes and writes [n][sub][sub] candidates. At
//   the union's 128 slots one lane a column left most SMs with 1-2 blocks
//   and a warp ran as long as its deepest walk; groups put G times the
//   warps on the card and cut a column's dependent evaluations G-fold.
// - U2-3D `fidget_unrolled_interval` under U_Z3: U2 over 3D boxes
//   [x0, x0 + T0] x [y0, y0 + T0] x [z0, z0 + T0], proofs only. U_Z3 adds
//   the z0 corners and the subtiles' edge and count to the warp streams'
//   and the kernel's arguments; without it (2D) every expansion is as it
//   was. Its frame entry proves a frame's root tiles and every subtile of
//   them in one launch, forming each subtile's corner from its root's;
//   its explicit entry takes each box's corner. The warps a group (k of
//   the schedule; k = 1 is one thread a box, one stream, no barrier) are
//   fixed when the code is generated, from the frame's box count.
// - U1-P `fidget_unrolled_points`: the mesher's points kernel (the
//   counterpart of eval_tape_float_fast in fidget_tpu/mesh/fused.py's
//   leaf and merge cores), U1's programs behind a kernel unit of
//   its own (U_POINTS_KERNEL). A thread evaluates one model-space point
//   of a flat list (the caller forms the points), with the epilogue
//   fixed when the code is generated: the distance, or the sign d < 0.
// - U1-P's sign table (U_TABLE_KERNEL), what the mesher's leaf and merge
//   cores run: neighbouring leaf cells share corners (4x at the leaf)
//   and neighbouring candidates share lattice points, most of them leaf
//   corners (7x over a first collapse round), and one thread a point is
//   bound by issuing the program's rows, so the time falls only with
//   fewer evaluations. A build keeps one open-addressing table of
//   leaf-lattice keys and their signs; an insert pass (one lane a
//   (cell, corner) or (candidate, lattice point) pair, the key formed
//   from the cell's key or the candidate's corner in the kernel) lists
//   the keys the table lacked, an evaluation pass runs the program once
//   a listed point, and a last pass forms the leaf's 8-bit masks (a
//   ballot over 8 lanes a cell) or each candidate's 27-bit inside word
//   and mesh/collapse.py's topology test. A point's sign depends on its
//   key alone, so the result is that of evaluating every pair, bit for
//   bit.
// - U1-P `fidget_unrolled_edges` (U_EDGE_KERNEL): the mesher's edge
//   search (fused.py's edge core) on a compacted list of crossing
//   (cell, edge) slots. A group of lanes (the sample count rounded up to
//   a power of two, at most a warp) owns one slot: it forms the edge's
//   inside and outside corners from the cell's key and corner mask, and
//   runs every round of the N-ary search with the brackets in
//   registers, lane i evaluating sample i (i + 32 ... past a warp); a
//   warp ballot gives the least outside sample. Then the intersection,
//   its model point and the distance there. It replaces the edge core's
//   rounds of eval_tape_float_fast over all 12 edges of every surface
//   cell (fidget_tpu/mesh/fused.py): one launch a build instead of a
//   launch a round with torch ops over [samples, 12, cells] between
//   them, and only the edges that cross. Bound by issuing the program's
//   rows, as U1: the samples of a slot run side by side, the brackets
//   never leave registers.
// - U2-B under U_BOX: U2's rows as ONE stream (the schedule at one
//   warp: no hand-off, no barrier), one thread a box (the counterpart
//   of eval_tape_interval_fast in fused.py's level core), proofs only.
//   Two kernels share the stream: `fidget_unrolled_level` (U_LEVEL_KERNEL)
//   decodes a parent cell's key, forms the world box of one of its 8
//   children and the model box in the reference's positive / negative
//   coefficient order, and writes the child's key and whether it stays
//   active; `fidget_unrolled_interval_boxes` (U_BOX_KERNEL) reads
//   explicit boxes as six planes [6][n] (x lo, x hi, y lo, y hi, z lo,
//   z hi). With hundreds of thousands of boxes a level there is
//   parallelism enough without splitting a box's rows over warps, so no
//   hand-off or barrier is paid; bound by issuing the rows.
//
// The mesher kernels read a live count from device memory, so that a
// chain of levels never waits on the host: lane g of a [rows][cols]
// list is live when g % cols < *count (every lane with no count; U1-P
// edges: slot g < *count; U2-B levels: parent g / 8 < *count). A dead
// lane writes 0 (U1-P) or no proof (U2-B) and does no work; a warp of
// U1-P edges with no live slot leaves at once.
//
// What bounds them on the card: instruction issue and the latency of
// dependent rows. A row is one to a few dozen instructions on
// registers, with no tape to fetch or decode (the interpreter kernels'
// cost), and the inputs are a few bytes a lane; U1's time falls with
// every resident warp, U2 needed more warps than one a tile group to
// hide its latency (PERF.md §6). Built with --fmad=false, as
// every kernel of the port, so that no a*b+c rounds differently from
// the plain PyTorch versions.
#pragma once

#include <cstdint>

#include "ops.cuh"

namespace fidget {

constexpr int UBLOCK = 128;

// numpy / torch minimum and maximum (NaN-propagating) as one min.NaN /
// max.NaN instruction (sm_80+): NaN where either operand is NaN, fminf /
// fmaxf's result elsewhere, as ops.cuh's nmin / nmax, which take a NaN
// test, an fminf and a select
__device__ __forceinline__ float u_fmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float u_fmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// eval_tape_interval_fast's MIN / MAX: NaN-propagating folds, no poison;
// Left when a lies wholly below (MIN) / above (MAX) b, Right the mirror,
// else Both (a NaN fails both compares)
__device__ __forceinline__ Ival u_min(Ival a, Ival b, int& c) {
  c = a.hi < b.lo ? CHOICE_LEFT : (b.hi < a.lo ? CHOICE_RIGHT : CHOICE_BOTH);
  return Ival{u_fmin(a.lo, b.lo), u_fmin(a.hi, b.hi)};
}
__device__ __forceinline__ Ival u_max(Ival a, Ival b, int& c) {
  c = a.lo > b.hi ? CHOICE_LEFT : (b.lo > a.hi ? CHOICE_RIGHT : CHOICE_BOTH);
  return Ival{u_fmax(a.lo, b.lo), u_fmax(a.hi, b.hi)};
}

// DIV: NaN-propagating corner folds; poisoned only where the denominator
// spans zero (an immediate denominator of 0 is emitted as a NaN constant)
__device__ __forceinline__ Ival u_div_corners(Ival a, Ival b) {
  const float q0 = a.lo / b.lo, q1 = a.lo / b.hi;
  const float q2 = a.hi / b.lo, q3 = a.hi / b.hi;
  return Ival{u_fmin(u_fmin(q0, q1), u_fmin(q2, q3)),
              u_fmax(u_fmax(q0, q1), u_fmax(q2, q3))};
}
__device__ __forceinline__ Ival u_div(Ival a, Ival b) {
  const bool bad = !(b.lo > 0.f || b.hi < 0.f);
  return bad ? Ival{f_nan(), f_nan()} : u_div_corners(a, b);
}

// ops.cuh's interval ABS and SQUARE (interval.rs:67-94) with u_fmax for
// nmax
__device__ __forceinline__ Ival u_abs(Ival a) {
  const float al = a.lo, au = a.hi;
  return Ival{al < 0.f ? (au > 0.f ? 0.f : -au) : al,
              al < 0.f ? (au > 0.f ? u_fmax(au, -al) : -al) : au};
}
__device__ __forceinline__ Ival u_square(Ival a) {
  const float al = a.lo, au = a.hi;
  const float lo2 = al * al, hi2 = au * au;
  const float m = u_fmax(fabsf(al), fabsf(au));
  const float mixed_hi = m * m;
  const float lo = au < 0.f ? hi2 : (al > 0.f ? lo2 : 0.f);
  const float hi = au < 0.f ? lo2 : (al > 0.f ? hi2 : mixed_hi);
  return poison(has_nan(a), lo, hi);
}

// params: mat [4][4] row-major, z, then the V input values
constexpr int U_PARAM_Z = 16;
constexpr int U_PARAM_VARS = 17;

// render/transform.py transform_points: ((m0 x + m1 y) + m2 z) + m3, / w
__device__ __forceinline__ float u_row(const float* __restrict__ p, int r,
                                       float x, float y, float z) {
  return p[4 * r] * x + p[4 * r + 1] * y + p[4 * r + 2] * z + p[4 * r + 3];
}

// transform_intervals: IntervalMode MUL / ADD per row, then DIV by w
__device__ __forceinline__ Ival u_row(const float* __restrict__ p, int r,
                                      Ival x, Ival y, Ival z) {
  auto c = [&](int k) { return Ival{p[4 * r + k], p[4 * r + k]}; };
  const Ival s = i_binary(OP_ADD, i_binary(OP_MUL, x, c(0)),
                          i_binary(OP_MUL, y, c(1)));
  return i_binary(OP_ADD, i_binary(OP_ADD, s, i_binary(OP_MUL, z, c(2))),
                  c(3));
}

// the perspective divide of each mode: IEEE f32 division; IntervalMode DIV
__device__ __forceinline__ float u_div3(float a, float w) { return a / w; }
__device__ __forceinline__ Ival u_div3(Ival a, Ival w) {
  return i_binary(OP_DIV, a, w);
}
// an input that is a var's value
__device__ __forceinline__ void u_var(float c, float& v) { v = c; }
__device__ __forceinline__ void u_var(float c, Ival& v) { v = Ival{c, c}; }

// The V inputs of one pixel (T = float) or tile box (T = Ival): the var
// values, then the model-space axes written into the inputs AX / AY / AZ
// name (-1: unused).
template <int V, int AX, int AY, int AZ, class T>
__device__ __forceinline__ void u_inputs(const float* __restrict__ p, T x,
                                         T y, T z, T* in) {
#pragma unroll
  for (int i = 0; i < V; ++i) u_var(p[U_PARAM_VARS + i], in[i]);
  if constexpr (AX >= 0 || AY >= 0 || AZ >= 0) {
    const T w = u_row(p, 3, x, y, z);
    if constexpr (AX >= 0) in[AX] = u_div3(u_row(p, 0, x, y, z), w);
    if constexpr (AY >= 0) in[AY] = u_div3(u_row(p, 1, x, y, z), w);
    if constexpr (AZ >= 0) in[AZ] = u_div3(u_row(p, 2, x, y, z), w);
  }
}

}  // namespace fidget

// U1. Float programs: `float fidget_uprog_<key>(float i0, ...)`, one
// translation unit each. The kernel's unit defines U_V / U_AX / U_AY /
// U_AZ, U_NSEG (the number of programs) and `u_run(segment, in)` (the
// dispatch to the segment's program), then expands U_FLOAT_KERNEL.
// Thread g evaluates pixel g % pp of slot g / pp.
#define U_FLOAT_KERNEL                                                        \
  extern "C" __global__ void __launch_bounds__(fidget::UBLOCK)                \
      fidget_unrolled_float(const float* __restrict__ cx0,                    \
                            const float* __restrict__ cy0,                    \
                            const bool* __restrict__ valid,                   \
                            const float* __restrict__ params,                 \
                            const int32_t* __restrict__ seg, int nseg,        \
                            float* __restrict__ out, int n_slots, int tw,     \
                            int pp) {                                         \
    const long long g = (long long)blockIdx.x * fidget::UBLOCK + threadIdx.x; \
    if (g >= (long long)n_slots * pp) return;                                 \
    const int slot = (int)(g / pp);                                           \
    const int i = (int)(g - (long long)slot * pp);                            \
    float d = 0.f;                                                            \
    if (valid[slot]) {                                                        \
      float in[U_V];                                                          \
      const float px = cx0[slot] + (float)(i % tw);                           \
      const float py = cy0[slot] + (float)(i / tw);                           \
      fidget::u_inputs<U_V, U_AX, U_AY, U_AZ, float>(                         \
          params, px, py, params[fidget::U_PARAM_Z], in);                     \
      /* the segment [seg[s], seg[s + 1]) that holds the slot */              \
      int lo = 0;                                                             \
      if (U_NSEG > 1) {                                                       \
        int hi = nseg - 1;                                                    \
        while (lo < hi) {                                                     \
          const int mid = (lo + hi + 1) >> 1;                                 \
          if (slot >= seg[mid]) lo = mid;                                     \
          else hi = mid - 1;                                                  \
        }                                                                     \
      }                                                                       \
      d = u_run(lo, in);                                                      \
    }                                                                         \
    out[g] = d;                                                               \
  }                                                                           \
  extern "C" int fidget_unrolled_float_launch(                                \
      const float* cx0, const float* cy0, const bool* valid,                  \
      const float* params, const int32_t* seg, int nseg, float* out,          \
      int n_slots, int tw, int pp, void* stream) {                            \
    const long long total = (long long)n_slots * pp;                          \
    const long long blocks = (total + fidget::UBLOCK - 1) / fidget::UBLOCK;   \
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;             \
    if (blocks > 0)                                                           \
      fidget_unrolled_float<<<(unsigned)blocks, fidget::UBLOCK, 0,            \
                              (cudaStream_t)stream>>>(                        \
          cx0, cy0, valid, params, seg, nseg, out, n_slots, tw, pp);          \
    return (int)cudaGetLastError();                                           \
  }

namespace fidget {
// The V inputs of one model-space point: the var values, then the axes
// written into the inputs AX / AY / AZ name (-1: unused).
template <int V, int AX, int AY, int AZ>
__device__ __forceinline__ void u_point_inputs(
    const float* __restrict__ p, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ z, int g,
    float* in) {
#pragma unroll
  for (int i = 0; i < V; ++i) in[i] = p[i];
  if constexpr (AX >= 0) in[AX] = x[g];
  if constexpr (AY >= 0) in[AY] = y[g];
  if constexpr (AZ >= 0) in[AZ] = z[g];
}
}  // namespace fidget

// U1-P. The kernel's unit defines U_V / U_AX / U_AY / U_AZ and
// `u_run(0, in)` (the one program) as U1's does, then expands
// U_POINTS_KERNEL(SIGN). Thread g evaluates point g of n (x, y, z f32
// [n] in model space, params the V input values); out is f32 [n], or
// bool [n] (d < 0) with SIGN 1. Dead lanes (module comment) get 0.
#define U_POINTS_KERNEL(SIGN)                                                 \
  extern "C" __global__ void __launch_bounds__(fidget::UBLOCK)                \
      fidget_unrolled_points(                                                 \
          const float* __restrict__ x, const float* __restrict__ y,           \
          const float* __restrict__ z, const float* __restrict__ params,      \
          const int32_t* __restrict__ count, int cols, void* __restrict__ out,\
          int n) {                                                            \
    const long long g = (long long)blockIdx.x * fidget::UBLOCK + threadIdx.x; \
    if (g >= n) return;                                                       \
    const int lim = count ? __ldg(count) : cols;                              \
    float d = 0.f;                                                            \
    if ((int)(g % cols) < lim) {                                              \
      float in[U_V];                                                          \
      fidget::u_point_inputs<U_V, U_AX, U_AY, U_AZ>(params, x, y, z, (int)g,  \
                                                    in);                      \
      d = u_run(0, in);                                                       \
    }                                                                         \
    if (SIGN)                                                                 \
      static_cast<bool*>(out)[g] = d < 0.f;                                   \
    else                                                                      \
      static_cast<float*>(out)[g] = d;                                        \
  }                                                                           \
  extern "C" int fidget_unrolled_points_launch(                               \
      const float* x, const float* y, const float* z, const float* params,    \
      const int32_t* count, int cols, void* out, int n, void* stream) {       \
    const long long blocks = ((long long)n + fidget::UBLOCK - 1) /            \
                             fidget::UBLOCK;                                  \
    if (cols <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;\
    if (blocks > 0)                                                           \
      fidget_unrolled_points<<<(unsigned)blocks, fidget::UBLOCK, 0,           \
                               (cudaStream_t)stream>>>(x, y, z, params,       \
                                                       count, cols, out, n);  \
    return (int)cudaGetLastError();                                           \
  }

namespace fidget {
//: rows of the edge search's output [U_EDGE_OUTS][cap]: the brackets ta,
//: tb, the intersection's world x, y, z, its model x, y, z, the distance
constexpr int U_EDGE_OUTS = 9;

// fused.py's _model_pts: ((m0 x + m1 y) + m2 z) + m3, mat [3][4]
__device__ __forceinline__ float u_model(const float* __restrict__ mat,
                                         int r, float x, float y, float z) {
  return mat[4 * r] * x + mat[4 * r + 1] * y + mat[4 * r + 2] * z +
         mat[4 * r + 3];
}

// a / (samples + 1.0) as torch divides a tensor by a Python float on the
// card: times the f32 reciprocal (ATen's div_true on a CPU scalar), the
// same on the plain version there
__device__ __forceinline__ float u_edge_div(float a, float s1) {
  return a * (1.f / s1);
}

// The edge search of one crossing slot (module comment). `run(in)` is
// the tape's program; edge_lo / edge_hi the edges' corners (mesh/
// tables.py), ks the packed key's stride. The arithmetic is the plain
// version's (unrolled_edges_plain, mesh/fused.py's dense rounds) op for
// op, every product and sum rounded on its own (--fmad=false).
template <int V, int AX, int AY, int AZ, class Run>
__device__ __forceinline__ void u_edges(
    const int32_t* __restrict__ key, const int32_t* __restrict__ mask,
    const int32_t* __restrict__ slot, const int32_t* __restrict__ count,
    const float* __restrict__ mat, const float* __restrict__ params,
    const int* edge_lo, const int* edge_hi, int ks, float h, int samples,
    int rounds, int group, float* __restrict__ out, int cap, Run run) {
  const long long g = (long long)blockIdx.x * UBLOCK + threadIdx.x;
  const int lane = threadIdx.x & (group - 1);
  const int base = (threadIdx.x & 31) & ~(group - 1);
  const long long q = g / group;
  const long long q0 = (g - (threadIdx.x & 31)) / group;  // the warp's first
  const int lim = min(__ldg(count), cap);
  if (q0 >= lim) {  // the warp holds no live slot: zeros, and leave
    if (lane == 0 && q < cap)
      for (int k = 0; k < U_EDGE_OUTS; ++k) out[(size_t)k * cap + q] = 0.f;
    return;
  }
  // a dead group beside live ones walks the warp's first slot for the
  // ballots and writes zeros
  const bool live = q < lim;
  const int s = live ? (int)q : (int)q0;
  const int kk = max(__ldg(key + s), 0);
  const int m = __ldg(mask + s);
  const int e = __ldg(slot + s) % 12;
  const int x = kk / (ks * ks), y = (kk / ks) % ks, z = kk % ks;
  const int lo = edge_lo[e], hi = edge_hi[e];
  const bool lo_in = (m >> lo) & 1;
  const int c0 = lo_in ? lo : hi, c1 = lo_in ? hi : lo;
  const float sx = (float)(x + (c0 & 1)) * h - 1.f;
  const float sy = (float)(y + ((c0 >> 1) & 1)) * h - 1.f;
  const float sz = (float)(z + ((c0 >> 2) & 1)) * h - 1.f;
  const float dx = ((float)(x + (c1 & 1)) * h - 1.f) - sx;
  const float dy = ((float)(y + ((c1 >> 1) & 1)) * h - 1.f) - sy;
  const float dz = ((float)(z + ((c1 >> 2) & 1)) * h - 1.f) - sz;
  float in[V];
#pragma unroll
  for (int i = 0; i < V; ++i) in[i] = params[i];
  auto at = [&](float t) {
    const float px = sx + dx * t, py = sy + dy * t, pz = sz + dz * t;
    if constexpr (AX >= 0) in[AX] = u_model(mat, 0, px, py, pz);
    if constexpr (AY >= 0) in[AY] = u_model(mat, 1, px, py, pz);
    if constexpr (AZ >= 0) in[AZ] = u_model(mat, 2, px, py, pz);
  };
  const float s1 = (float)samples + 1.f;
  const unsigned gmask = group == 32 ? 0xffffffffu : (1u << group) - 1u;
  float ta = 0.f, tb = 1.f;
  for (int r = 0; r < rounds; ++r) {
    const float span = tb - ta;
    int F = samples;  // the least outside sample (samples: none)
    for (int c = 0; c < samples; c += group) {  // uniform over the warp
      const int k = c + lane;
      bool outside = false;
      if (k < samples) {
        at(ta + span * u_edge_div((float)k + 1.f, s1));
        outside = !(run(in) < 0.f);  // NaN is outside, as ~(d < 0)
      }
      const unsigned bits =
          (__ballot_sync(0xffffffffu, outside) >> base) & gmask;
      if (F == samples && bits) F = c + __ffs(bits) - 1;
    }
    const bool any_out = F < samples;
    const float Ff = (float)F;
    const float tbF = ta + u_edge_div(span * (Ff + 1.f), s1);
    const float taF = ta + u_edge_div(span * Ff, s1);
    const float ts_last = ta + u_edge_div(span * (float)samples, s1);
    const float ntb = any_out ? tbF : tb;
    ta = any_out ? (F > 0 ? taF : ta) : ts_last;
    tb = ntb;
  }
  if (lane != 0 || q >= cap) return;
  const float t = 0.5f * (ta + tb);
  const float ipx = sx + dx * t, ipy = sy + dy * t, ipz = sz + dz * t;
  const float mx = u_model(mat, 0, ipx, ipy, ipz);
  const float my = u_model(mat, 1, ipx, ipy, ipz);
  const float mz = u_model(mat, 2, ipx, ipy, ipz);
  if constexpr (AX >= 0) in[AX] = mx;
  if constexpr (AY >= 0) in[AY] = my;
  if constexpr (AZ >= 0) in[AZ] = mz;
  const float vals[U_EDGE_OUTS] = {ta, tb, ipx, ipy, ipz, mx, my, mz,
                                   live ? run(in) : 0.f};
#pragma unroll
  for (int k = 0; k < U_EDGE_OUTS; ++k)
    out[(size_t)k * cap + q] = live ? vals[k] : 0.f;
}
}  // namespace fidget

// U1-P edges. The kernel's unit defines U_V / U_AX / U_AY / U_AZ and
// `u_run(0, in)` (the one program) as U1's does, the edge tables
// u_edge_lo / u_edge_hi [12] and the key stride U_KS, then expands
// U_EDGE_KERNEL. Thread g is lane g % group of slot g / group of the
// [cap] list (key, corner mask, slot = 12 cell + edge); out f32
// [U_EDGE_OUTS][cap].
#define U_EDGE_KERNEL                                                         \
  extern "C" __global__ void __launch_bounds__(fidget::UBLOCK)                \
      fidget_unrolled_edges(                                                  \
          const int32_t* __restrict__ key, const int32_t* __restrict__ mask,  \
          const int32_t* __restrict__ slot, const int32_t* __restrict__ count,\
          const float* __restrict__ mat, const float* __restrict__ params,    \
          float h, int samples, int rounds, int group,                        \
          float* __restrict__ out, int cap) {                                 \
    fidget::u_edges<U_V, U_AX, U_AY, U_AZ>(                                   \
        key, mask, slot, count, mat, params, u_edge_lo, u_edge_hi, U_KS, h,   \
        samples, rounds, group, out, cap,                                     \
        [](const float* in) { return u_run(0, in); });                        \
  }                                                                           \
  extern "C" int fidget_unrolled_edges_launch(                                \
      const int32_t* key, const int32_t* mask, const int32_t* slot,           \
      const int32_t* count, const float* mat, const float* params, float h,   \
      int samples, int rounds, int group, float* out, int cap,                \
      void* stream) {                                                         \
    const long long blocks =                                                  \
        ((long long)cap * group + fidget::UBLOCK - 1) / fidget::UBLOCK;       \
    if (samples <= 0 || rounds < 0 || group <= 0 || group > 32 ||             \
        (group & (group - 1)) || blocks > 0x7fffffffLL)                       \
      return (int)cudaErrorInvalidValue;                                      \
    if (blocks > 0)                                                           \
      fidget_unrolled_edges<<<(unsigned)blocks, fidget::UBLOCK, 0,            \
                              (cudaStream_t)stream>>>(                        \
          key, mask, slot, count, mat, params, h, samples, rounds, group,     \
          out, cap);                                                          \
    return (int)cudaGetLastError();                                           \
  }

namespace fidget {
// The sign table of a mesh build (U_TABLE_KERNEL): open addressing with
// linear probing over `slots` int32 [cap], cap a power of two; an entry is
// a leaf-lattice key (x * KS + y) * KS + z, below 2^31, with the sign d < 0
// of its world point in bit 31; -1 is empty. `count` int32 [3]: the points
// the last pass evaluated (its list's length), the keys held, and inserts
// a full table refused (the host sizes it at a load of at most 1/2, so
// this stays 0; a probe never loops past the capacity).
constexpr int32_t U_TAB_EMPTY = -1;
constexpr int32_t U_TAB_KEY = 0x7fffffff;
constexpr int32_t U_TAB_SIGN = INT32_MIN;
//: blocks of the evaluation pass (a grid-stride loop over the list): twice
//: the 2,048 threads resident on each of the card's 132 SMs
constexpr unsigned U_TAB_EVAL_BLOCKS = 2 * 132 * 2048 / UBLOCK;

// murmur3's finalizer: neighbouring keys land far apart
__device__ __forceinline__ uint32_t u_tab_hash(int32_t key, uint32_t mask) {
  uint32_t k = (uint32_t)key;
  k ^= k >> 16;
  k *= 0x85ebca6bu;
  k ^= k >> 13;
  k *= 0xc2b2ae35u;
  k ^= k >> 16;
  return k & mask;
}

// The slot of `key`, where `entry` (the key, or the key with its sign) is
// written with atomicCAS when the table lacks it (`fresh`); -1 when the
// table is full (counted in *refused). Within a pass a slot only turns from
// empty to a key, so a stale read of an empty slot is settled by the CAS.
__device__ __forceinline__ int u_tab_insert(int32_t* slots, uint32_t mask,
                                            int32_t key, int32_t entry,
                                            bool& fresh, int32_t* refused) {
  uint32_t s = u_tab_hash(key, mask);
  for (uint32_t i = 0; i <= mask; ++i) {
    int32_t e = __ldcg(slots + s);
    if (e == U_TAB_EMPTY) {
      e = atomicCAS(slots + s, U_TAB_EMPTY, entry);
      if (e == U_TAB_EMPTY) {
        fresh = true;
        return (int)s;
      }
    }
    if ((e & U_TAB_KEY) == key) return (int)s;
    s = (s + 1) & mask;
  }
  atomicAdd(refused, 1);
  return -1;
}

// The entry of `key`, or U_TAB_EMPTY where the table lacks it
__device__ __forceinline__ int32_t u_tab_find(const int32_t* slots,
                                              uint32_t mask, int32_t key) {
  uint32_t s = u_tab_hash(key, mask);
  for (uint32_t i = 0; i <= mask; ++i) {
    const int32_t e = __ldcg(slots + s);
    if (e == U_TAB_EMPTY || (e & U_TAB_KEY) == key) return e;
    s = (s + 1) & mask;
  }
  return U_TAB_EMPTY;
}

__device__ __forceinline__ bool u_tab_inside(int32_t e) {
  return e < 0 && e != U_TAB_EMPTY;
}

// Appends the slots of the block's fresh keys to `list` at count[0] and
// adds them to count[1]: one atomicAdd a block, not a lane (the passes
// insert millions of keys into one list). Every thread of the block calls
// it.
__device__ __forceinline__ void u_tab_append(bool fresh, int slot,
                                             int32_t* list, int32_t* count) {
  __shared__ int warp_base[UBLOCK / 32];
  __shared__ int block_base;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, fresh);
  if (lane == 0) warp_base[w] = __popc(m);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < UBLOCK / 32; ++i) {
      const int c = warp_base[i];
      warp_base[i] = total;
      total += c;
    }
    block_base = total ? atomicAdd(count, total) : 0;
    if (total) atomicAdd(count + 1, total);
  }
  __syncthreads();
  if (fresh)
    list[block_base + warp_base[w] + __popc(m & ((1u << lane) - 1u))] = slot;
}

// corner c (offset (c & 1, c >> 1 & 1, c >> 2 & 1), mesh/fused.py's
// _CORNER_OFF) of the cell whose packed key is k
__device__ __forceinline__ int32_t u_corner_key(int32_t k, int c, int ks) {
  return k + (c & 1) * ks * ks + ((c >> 1) & 1) * ks + ((c >> 2) & 1);
}

// lattice point p (mesh/collapse.py's _LATTICE: x = p % 3, y = p / 3 % 3,
// z = p / 9, in units of `half`) of candidate j, whose lo corner is
// pb3[:, j] ([3][kcap])
__device__ __forceinline__ int32_t u_lattice_key(const int32_t* pb3, int kcap,
                                                 int j, int p, int half,
                                                 int ks) {
  const int x = __ldg(pb3 + j) + p % 3 * half;
  const int y = __ldg(pb3 + kcap + j) + p / 3 % 3 * half;
  const int z = __ldg(pb3 + 2 * kcap + j) + p / 9 * half;
  return (x * ks + y) * ks + z;
}

// The evaluation pass: each listed slot's point, its world coordinates
// k * h - 1 and model point through mat [3][4] (_model_pts' order), through
// the tape; an inside point gets its sign bit. The list's length is
// count[0], written by the pass's insert launch.
template <int V, int AX, int AY, int AZ, class Run>
__device__ __forceinline__ void u_tab_eval(
    int32_t* __restrict__ slots, const int32_t* __restrict__ list,
    const int32_t* __restrict__ count, const float* __restrict__ mat,
    const float* __restrict__ params, float h, int ks, Run run) {
  const int n = *count;
  float in[V];
#pragma unroll
  for (int i = 0; i < V; ++i) in[i] = params[i];
  for (int i = blockIdx.x * UBLOCK + threadIdx.x; i < n;
       i += gridDim.x * UBLOCK) {
    const int s = list[i];
    const int32_t key = slots[s];
    const int x = key / (ks * ks), y = key / ks % ks, z = key % ks;
    const float wx = (float)x * h - 1.f;
    const float wy = (float)y * h - 1.f;
    const float wz = (float)z * h - 1.f;
    if constexpr (AX >= 0) in[AX] = u_model(mat, 0, wx, wy, wz);
    if constexpr (AY >= 0) in[AY] = u_model(mat, 1, wx, wy, wz);
    if constexpr (AZ >= 0) in[AZ] = u_model(mat, 2, wx, wy, wz);
    if (run(in) < 0.f) slots[s] = key | U_TAB_SIGN;
  }
}

// The leaf entry's insert pass: thread g is corner g & 7 of cell g >> 3,
// live below min(*n_leaf, cl) with a key >= 0. A block with no live cell
// leaves at once (uniform over the block).
__device__ __forceinline__ void u_leaf_insert(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ n_leaf,
    int cl, int32_t* slots, uint32_t mask, int32_t* __restrict__ list,
    int32_t* count, int ks) {
  const int lim = min(__ldg(n_leaf), cl);
  if ((int)(blockIdx.x * (UBLOCK / 8)) >= lim) return;
  const int g = blockIdx.x * UBLOCK + threadIdx.x;
  const int cell = g >> 3;
  bool fresh = false;
  int slot = -1;
  if (cell < lim) {
    const int32_t k = __ldg(keys + cell);
    if (k >= 0) {
      const int32_t key = u_corner_key(k, g & 7, ks);
      slot = u_tab_insert(slots, mask, key, key, fresh, count + 2);
    }
  }
  u_tab_append(fresh, slot, list, count);
}

// The leaf entry's masks: bit c of out[cell] is the sign of corner c, 0 at
// a dead cell; 8 lanes a cell, one corner each, and a ballot (ahead of one
// thread looking up all 8: PERF.md section 6).
__device__ __forceinline__ void u_leaf_mask(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ n_leaf,
    int cl, const int32_t* slots, uint32_t mask, int ks,
    int32_t* __restrict__ out) {
  const int lim = min(__ldg(n_leaf), cl);
  const int g = blockIdx.x * UBLOCK + threadIdx.x;
  const int cell = g >> 3;
  bool inside = false;
  if (cell < lim) {
    const int32_t k = __ldg(keys + cell);
    if (k >= 0)
      inside =
          u_tab_inside(u_tab_find(slots, mask, u_corner_key(k, g & 7, ks)));
  }
  const unsigned b =
      (__ballot_sync(0xffffffffu, inside) >> (threadIdx.x & 24)) & 0xffu;
  if ((g & 7) == 0 && cell < cl) out[cell] = (int32_t)b;
}

// The merge entry's insert pass: thread g is lattice point g % 27 of
// candidate g / 27, live below n_cand.
__device__ __forceinline__ void u_merge_insert(
    const int32_t* __restrict__ pb3, int kcap, int n_cand, int half,
    int32_t* slots, uint32_t mask, int32_t* __restrict__ list, int32_t* count,
    int ks) {
  const int g = blockIdx.x * UBLOCK + threadIdx.x;
  const int j = g / 27;
  bool fresh = false;
  int slot = -1;
  if (j < n_cand) {
    const int32_t key = u_lattice_key(pb3, kcap, j, g - 27 * j, half, ks);
    slot = u_tab_insert(slots, mask, key, key, fresh, count + 2);
  }
  u_tab_append(fresh, slot, list, count);
}

// mesh/collapse.py's topo_safe on one candidate's 27-bit inside word w
// (bit p: lattice point p): the merged corner mask has one vertex
// (vc1: a bit a mask), every edge midpoint carries an endpoint's sign,
// every face midpoint a corner's and no face is ambiguous, the centre
// carries a corner's. corner [8], edge [12][3] (mid, a, b), face [6][5]
// (mid, 4 corners) are lattice indices.
__device__ __forceinline__ bool u_topo_safe(uint32_t w, const int* corner,
                                            const int* edge, const int* face,
                                            const unsigned* vc1, int center) {
  auto s = [w](int p) { return (w >> p) & 1u; };
  int pm = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) pm |= (int)s(corner[c]) << c;
  bool ok = (vc1[pm >> 5] >> (pm & 31)) & 1u;
#pragma unroll
  for (int e = 0; e < 12; ++e) {
    const unsigned m = s(edge[3 * e]);
    ok = ok && (m == s(edge[3 * e + 1]) || m == s(edge[3 * e + 2]));
  }
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const int* q = face + 5 * f;
    const unsigned m = s(q[0]);
    const unsigned c0 = s(q[1]), c1 = s(q[2]), c2 = s(q[3]), c3 = s(q[4]);
    ok = ok && (m == c0 || m == c1 || m == c2 || m == c3) &&
         !(c0 == c3 && c1 == c2 && c0 != c1);
  }
  bool hit = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) hit = hit || s(center) == s(corner[c]);
  return ok && hit;
}

// The merge entry's test: candidate g's inside word from the table and
// topo_safe of it (false past n_cand); a thread a candidate looks up all
// 27 points (ahead of 32 lanes a candidate and a ballot: PERF.md section 6)
__device__ __forceinline__ void u_merge_topo(
    const int32_t* __restrict__ pb3, int kcap, int n_cand, int half,
    const int32_t* slots, uint32_t mask, int ks, const int* corner,
    const int* edge, const int* face, const unsigned* vc1, int center,
    bool* __restrict__ topo) {
  const int g = blockIdx.x * UBLOCK + threadIdx.x;
  if (g >= kcap) return;
  bool ok = false;
  if (g < n_cand) {
    uint32_t w = 0;
    for (int p = 0; p < 27; ++p)
      w |= (uint32_t)u_tab_inside(u_tab_find(
               slots, mask, u_lattice_key(pb3, kcap, g, p, half, ks)))
           << p;
    ok = u_topo_safe(w, corner, edge, face, vc1, center);
  }
  topo[g] = ok;
}

// A larger table: every entry of `old` [old_cap], sign and all, into slots
__device__ __forceinline__ void u_tab_grow(const int32_t* __restrict__ old,
                                           int old_cap, int32_t* slots,
                                           uint32_t mask, int32_t* refused) {
  const int g = blockIdx.x * UBLOCK + threadIdx.x;
  if (g >= old_cap) return;
  const int32_t e = __ldg(old + g);
  bool fresh = false;
  if (e != U_TAB_EMPTY)
    u_tab_insert(slots, mask, e & U_TAB_KEY, e, fresh, refused);
}

__host__ inline bool u_tab_cap_ok(int cap) {
  return cap > 0 && (cap & (cap - 1)) == 0;
}
__host__ inline unsigned u_blocks(long long threads) {
  return (unsigned)((threads + UBLOCK - 1) / UBLOCK);
}
}  // namespace fidget

// U1-P's sign table. The kernel's unit defines U_V / U_AX / U_AY / U_AZ and
// `u_run(0, in)` (the one program) as U1's does, the key stride U_KS, the
// topology tables u_topo_corner [8], u_topo_edge [12 * 3], u_topo_face
// [6 * 5], u_topo_vc1 [8] and U_TOPO_CENTER, then expands U_TABLE_KERNEL.
// Two entries share the evaluation pass (one launch after each insert
// pass, over the points the table lacked) and the table (slots [cap], list
// [room for the pass's inserts], count [3]):
// - `..._leaf_masks_launch`: keys [cl], n_leaf [1] -> the corner masks
//   out int32 [cl] (insert, evaluate, masks);
// - `..._merge_topo_launch`: pb3 [3][kcap], n_cand candidates, half ->
//   topo bool [kcap] (insert, evaluate, test).
// `..._table_grow_launch` rehashes a table into a larger one.
#define U_TABLE_KERNEL                                                        \
  extern "C" __global__ void __launch_bounds__(fidget::UBLOCK)                \
      fidget_unrolled_table_eval(int32_t* __restrict__ slots,                 \
                                 const int32_t* __restrict__ list,            \
                                 const int32_t* __restrict__ count,           \
                                 const float* __restrict__ mat,               \
                                 const float* __restrict__ params, float h) { \
    fidget::u_tab_eval<U_V, U_AX, U_AY, U_AZ>(                                \
        slots, list, count, mat, params, h, U_KS,                             \
        [](const float* in) { return u_run(0, in); });                        \
  }                                                                           \
  extern "C" __global__ void __launch_bounds__(fidget::UBLOCK)                \
      fidget_unrolled_leaf_insert(const int32_t* keys, const int32_t* n_leaf, \
                                  int cl, int32_t* slots, unsigned mask,      \
                                  int32_t* list, int32_t* count) {            \
    fidget::u_leaf_insert(keys, n_leaf, cl, slots, mask, list, count, U_KS);  \
  }                                                                           \
  extern "C" __global__ void __launch_bounds__(fidget::UBLOCK)                \
      fidget_unrolled_leaf_mask(const int32_t* keys, const int32_t* n_leaf,   \
                                int cl, const int32_t* slots, unsigned mask,  \
                                int32_t* out) {                               \
    fidget::u_leaf_mask(keys, n_leaf, cl, slots, mask, U_KS, out);            \
  }                                                                           \
  extern "C" __global__ void __launch_bounds__(fidget::UBLOCK)                \
      fidget_unrolled_merge_insert(const int32_t* pb3, int kcap, int n_cand,  \
                                   int half, int32_t* slots, unsigned mask,   \
                                   int32_t* list, int32_t* count) {           \
    fidget::u_merge_insert(pb3, kcap, n_cand, half, slots, mask, list, count, \
                           U_KS);                                             \
  }                                                                           \
  extern "C" __global__ void __launch_bounds__(fidget::UBLOCK)                \
      fidget_unrolled_merge_topo(const int32_t* pb3, int kcap, int n_cand,    \
                                 int half, const int32_t* slots,              \
                                 unsigned mask, bool* topo) {                 \
    fidget::u_merge_topo(pb3, kcap, n_cand, half, slots, mask, U_KS,          \
                         u_topo_corner, u_topo_edge, u_topo_face, u_topo_vc1, \
                         U_TOPO_CENTER, topo);                                \
  }                                                                           \
  extern "C" __global__ void __launch_bounds__(fidget::UBLOCK)                \
      fidget_unrolled_table_grow(const int32_t* old, int old_cap,             \
                                 int32_t* slots, unsigned mask,               \
                                 int32_t* count) {                            \
    fidget::u_tab_grow(old, old_cap, slots, mask, count + 2);                 \
  }                                                                           \
  /* the evaluation pass over the points an insert pass of `inserts` */    \
  /* lanes listed (count[0], set to 0 before the insert pass) */              \
  static void u_tab_evaluate(long long inserts, int32_t* slots,               \
                             const int32_t* list, const int32_t* count,       \
                             const float* mat, const float* params, float h,  \
                             cudaStream_t st) {                               \
    const unsigned b = fidget::u_blocks(inserts);                             \
    if (b > 0)                                                                \
      fidget_unrolled_table_eval<<<b < fidget::U_TAB_EVAL_BLOCKS              \
                                       ? b                                    \
                                       : fidget::U_TAB_EVAL_BLOCKS,           \
                                   fidget::UBLOCK, 0, st>>>(                  \
          slots, list, count, mat, params, h);                                \
  }                                                                           \
  extern "C" int fidget_unrolled_leaf_masks_launch(                           \
      const int32_t* keys, const int32_t* n_leaf, int cl, const float* mat,   \
      const float* params, float h, int32_t* slots, int cap, int32_t* list,   \
      int32_t* count, int32_t* out, void* stream) {                           \
    const cudaStream_t st = (cudaStream_t)stream;                             \
    if (cl < 0 || 8LL * cl > 0x7fffffffLL || !fidget::u_tab_cap_ok(cap))      \
      return (int)cudaErrorInvalidValue;                                      \
    const int err = (int)cudaMemsetAsync(count, 0, sizeof(int32_t), st);     \
    if (err) return err;                                                      \
    const unsigned b = fidget::u_blocks(8LL * cl);                            \
    if (b > 0) {                                                              \
      fidget_unrolled_leaf_insert<<<b, fidget::UBLOCK, 0, st>>>(              \
          keys, n_leaf, cl, slots, (unsigned)(cap - 1), list, count);         \
      u_tab_evaluate(8LL * cl, slots, list, count, mat, params, h, st);       \
      fidget_unrolled_leaf_mask<<<b, fidget::UBLOCK, 0, st>>>(                \
          keys, n_leaf, cl, slots, (unsigned)(cap - 1), out);                 \
    }                                                                         \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int fidget_unrolled_merge_topo_launch(                           \
      const int32_t* pb3, int kcap, int n_cand, int half, const float* mat,   \
      const float* params, float h, int32_t* slots, int cap, int32_t* list,   \
      int32_t* count, bool* topo, void* stream) {                             \
    const cudaStream_t st = (cudaStream_t)stream;                             \
    if (kcap < 0 || n_cand < 0 || n_cand > kcap ||                            \
        27LL * kcap > 0x7fffffffLL || !fidget::u_tab_cap_ok(cap))             \
      return (int)cudaErrorInvalidValue;                                      \
    const int err = (int)cudaMemsetAsync(count, 0, sizeof(int32_t), st);     \
    if (err) return err;                                                      \
    if (n_cand > 0) {                                                         \
      fidget_unrolled_merge_insert<<<fidget::u_blocks(27LL * n_cand),         \
                                     fidget::UBLOCK, 0, st>>>(                \
          pb3, kcap, n_cand, half, slots, (unsigned)(cap - 1), list, count);  \
      u_tab_evaluate(27LL * n_cand, slots, list, count, mat, params, h, st);  \
    }                                                                         \
    if (kcap > 0)                                                             \
      fidget_unrolled_merge_topo<<<fidget::u_blocks(kcap), fidget::UBLOCK, 0, \
                                   st>>>(pb3, kcap, n_cand, half, slots,      \
                                         (unsigned)(cap - 1), topo);          \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int fidget_unrolled_table_grow_launch(                           \
      const int32_t* old, int old_cap, int32_t* slots, int cap,               \
      int32_t* count, void* stream) {                                         \
    if (old_cap < 0 || !fidget::u_tab_cap_ok(cap))                            \
      return (int)cudaErrorInvalidValue;                                      \
    if (old_cap > 0)                                                          \
      fidget_unrolled_table_grow<<<fidget::u_blocks(old_cap), fidget::UBLOCK, \
                                   0, (cudaStream_t)stream>>>(                \
          old, old_cap, slots, (unsigned)(cap - 1), count);                   \
    return (int)cudaGetLastError();                                           \
  }

namespace fidget {
// U1-3D's column walk (module comment). Lane `lane` of a group of `group`
// lanes owns column c (vy = c / sub, vx = c % sub) of slot `slot`; the
// slot's base corner comes from the explicit planes bx / by / bz under
// `valid`, or, with a worklist (`order` non-null), from the compacted
// subtile index order[slot] (lz, gy, gx slab-local, live below *count),
// formed in the f32 order of render3d.py's `stratum_leaf`. Each chunk of
// `group` voxels runs side by side, lane i at vz = sub - 1 - (chunk +
// i); a ballot over the group gives the topmost voxel inside (d < 0), and
// the group stops at the first chunk with one. The explicit entry writes
// the column's depth (0: nothing inside, or a dead slot) to out[slot][c];
// the worklist entry folds it into the slab's int32 floor [ny2 sub][nx2
// sub] by atomicMax, the max of integers in any order.
template <int V, int AX, int AY, int AZ, class Run>
__device__ __forceinline__ void u_voxel(
    const float* __restrict__ bx, const float* __restrict__ by,
    const float* __restrict__ bz, const bool* __restrict__ valid,
    const int64_t* __restrict__ order, const int64_t* __restrict__ count,
    const float* __restrict__ z_lo, float y_base, int ny2, int nx2,
    const float* __restrict__ params, int32_t* __restrict__ out, int n_slots,
    int sub, int group, Run run) {
  // 32-bit indices (the launcher checks that they fit) and a shift for
  // the group, a power of two: a 64-bit division is a software routine
  // of dozens of instructions, against a short program's few rows
  const int cols = sub * sub;
  const int g = blockIdx.x * UBLOCK + threadIdx.x;
  const int lane = threadIdx.x & (group - 1);
  const int base = (threadIdx.x & 31) & ~(group - 1);
  const int q = g >> (__ffs(group) - 1);  // the column over all slots
  const int total = n_slots * cols;
  const int slot = min(q / cols, n_slots - 1);
  const int c = q - slot * cols;
  bool live = q < total;
  float x0 = 0.f, y0 = 0.f, z0 = 0.f;
  int gx = 0, gy = 0;
  if (order != nullptr) {
    live = live && slot < __ldg(count);
    if (live) {
      const int o = (int)__ldg(order + slot);
      const int per = ny2 * nx2;
      const int lz = o / per;
      const int rem = o - lz * per;
      gy = rem / nx2;
      gx = rem - gy * nx2;
      x0 = (float)(gx * sub);
      y0 = (float)(gy * sub);
      if (y_base != 0.f) y0 = y0 + y_base;
      z0 = (float)(lz * sub) + __ldg(z_lo);
    }
  } else if (live && valid[slot]) {
    x0 = bx[slot];
    y0 = by[slot];
    z0 = bz[slot];
  } else {
    live = false;
  }
  const int vy = c / sub, vx = c - vy * sub;
  const float px = x0 + (float)vx, py = y0 + (float)vy;
  const unsigned gmask = group == 32 ? 0xffffffffu : (1u << group) - 1u;
  float in[V];
  int d = 0;
  bool done = !live;
  for (int c0 = 0; c0 < sub; c0 += group) {
    if (__all_sync(0xffffffffu, done)) break;  // uniform over the warp
    const int vz = sub - 1 - (c0 + lane);
    bool inside = false;
    if (!done && vz >= 0) {
      u_inputs<V, AX, AY, AZ, float>(params, px, py, z0 + (float)vz, in);
      inside = run(in) < 0.f;
    }
    const unsigned bits =
        (__ballot_sync(0xffffffffu, inside) >> base) & gmask;
    if (!done && bits) {
      d = (int)z0 + (sub - 1 - (c0 + __ffs(bits) - 1)) + 1;
      done = true;
    }
  }
  if (lane != 0 || q >= total) return;
  if (order == nullptr)
    out[q] = d;
  else if (d > 0)
    atomicMax(out + (gy * sub + vy) * (nx2 * sub) + gx * sub + vx, d);
}
}  // namespace fidget

// U1-3D. The kernel's unit defines U_V / U_AX / U_AY / U_AZ and
// `u_run(0, in)` (the one program) as U1's does, then expands
// U_VOXEL_KERNEL: thread g is lane g % group of column g / group over
// the slots (`u_voxel`). Two entries launch it: the explicit planes
// (`..._voxel_depth_launch`: out int32 [n_slots][sub][sub]) and the
// stratum's worklist (`..._voxel_fold_launch`: order int64 [n_slots],
// the live count int64 [1], the slab's z base f32 [1], out the floor).
#define U_VOXEL_KERNEL                                                        \
  extern "C" __global__ void __launch_bounds__(fidget::UBLOCK)                \
      fidget_unrolled_voxel_depth(                                            \
          const float* __restrict__ bx, const float* __restrict__ by,         \
          const float* __restrict__ bz, const bool* __restrict__ valid,       \
          const int64_t* __restrict__ order,                                  \
          const int64_t* __restrict__ count, const float* __restrict__ z_lo,  \
          float y_base, int ny2, int nx2, const float* __restrict__ params,   \
          int32_t* __restrict__ out, int n_slots, int sub, int group) {       \
    fidget::u_voxel<U_V, U_AX, U_AY, U_AZ>(                                   \
        bx, by, bz, valid, order, count, z_lo, y_base, ny2, nx2, params, out, \
        n_slots, sub, group, [](const float* in) { return u_run(0, in); });   \
  }                                                                           \
  static int u_voxel_launch(                                                  \
      const float* bx, const float* by, const float* bz, const bool* valid,   \
      const int64_t* order, const int64_t* count, const float* z_lo,          \
      float y_base, int ny2, int nx2, const float* params, int32_t* out,      \
      int n_slots, int sub, int group, void* stream) {                        \
    const long long total = (long long)n_slots * sub * sub * group;           \
    const long long blocks = (total + fidget::UBLOCK - 1) / fidget::UBLOCK;   \
    if (sub <= 0 || group <= 0 || group > 32 || (group & (group - 1)) ||      \
        blocks * fidget::UBLOCK > 0x7fffffffLL ||                             \
        (long long)ny2 * nx2 * sub * sub > 0x7fffffffLL)                      \
      return (int)cudaErrorInvalidValue;                                      \
    if (blocks > 0)                                                           \
      fidget_unrolled_voxel_depth<<<(unsigned)blocks, fidget::UBLOCK, 0,      \
                                    (cudaStream_t)stream>>>(                  \
          bx, by, bz, valid, order, count, z_lo, y_base, ny2, nx2, params,    \
          out, n_slots, sub, group);                                          \
    return (int)cudaGetLastError();                                           \
  }                                                                           \
  extern "C" int fidget_unrolled_voxel_depth_launch(                          \
      const float* bx, const float* by, const float* bz, const bool* valid,   \
      const float* params, int32_t* out, int n_slots, int sub, int group,     \
      void* stream) {                                                         \
    return u_voxel_launch(bx, by, bz, valid, nullptr, nullptr, nullptr, 0.f,  \
                          0, 1, params, out, n_slots, sub, group, stream);    \
  }                                                                           \
  extern "C" int fidget_unrolled_voxel_fold_launch(                           \
      const int64_t* order, const int64_t* count, const float* z_lo,          \
      float y_base, int ny2, int nx2, const float* params, int32_t* floor_,   \
      int n_slots, int sub, int group, void* stream) {                        \
    if (ny2 <= 0 || nx2 <= 0) return (int)cudaErrorInvalidValue;             \
    return u_voxel_launch(nullptr, nullptr, nullptr, nullptr, order, count,   \
                          z_lo, y_base, ny2, nx2, params, floor_, n_slots,    \
                          sub, group, stream);                                \
  }

// U2. Every unit of an interval kernel defines U_EPI, U_V, U_AX / U_AY /
// U_AZ and U_K (warps a group) before including this file; a unit of
// U2-3D also U_Z3 1, one of U2-B U_BOX 1.
#if defined(U_K)
#ifndef U_Z3
#define U_Z3 0
#endif
#ifndef U_BOX
#define U_BOX 0
#endif
namespace fidget {
#if U_BOX
// The inputs of one model-space box: the var values, then the axes'
// intervals written into the inputs AX / AY / AZ name.
template <int V, int AX, int AY, int AZ>
__device__ __forceinline__ void u_box_inputs(Ival bx, Ival by, Ival bz,
                                             const float* __restrict__ p,
                                             Ival* in) {
#pragma unroll
  for (int i = 0; i < V; ++i) in[i] = Ival{p[i], p[i]};
  if constexpr (AX >= 0) in[AX] = bx;
  if constexpr (AY >= 0) in[AY] = by;
  if constexpr (AZ >= 0) in[AZ] = bz;
}
#elif U_Z3
// The box of one 3D tile through transform_intervals. With nl == 0 box
// `tile` is [x0, x0 + T0] x [y0, y0 + T0] x [z0, z0 + T0] at its own
// corners; else box `tile` is entry j of root t = tile / (1 + nl^3): the
// root itself (j = 0, edge T0), or its subtile j - 1 in (lz, ly, lx)
// row-major order (edge Ts), whose corner is the root's plus (lx, ly,
// lz) Ts, the f32 sums of integers that render3d.py's tables give.
__device__ __forceinline__ void u_tile_inputs(const float* __restrict__ x0,
                                              const float* __restrict__ y0,
                                              const float* __restrict__ z0,
                                              const float* __restrict__ p,
                                              float T0, float Ts, int nl,
                                              int tile, Ival* in) {
  int t = tile, j = 0;
  if (nl > 0) {
    const int m1 = nl * nl * nl + 1;
    t = tile / m1;
    j = tile - t * m1;
  }
  float ax = x0[t], ay = y0[t], az = z0[t], e = T0;
  if (j > 0) {
    const int k = j - 1;
    ax = ax + (float)(k % nl) * Ts;
    ay = ay + (float)((k / nl) % nl) * Ts;
    az = az + (float)(k / (nl * nl)) * Ts;
    e = Ts;
  }
  u_inputs<U_V, U_AX, U_AY, U_AZ, Ival>(p, Ival{ax, ax + e}, Ival{ay, ay + e},
                                        Ival{az, az + e}, in);
}
#else
// The box of one tile through transform_intervals.
__device__ __forceinline__ void u_tile_inputs(const float* __restrict__ x0,
                                              const float* __restrict__ y0,
                                              const float* __restrict__ p,
                                              float T0, int tile, Ival* in) {
  const float z = p[U_PARAM_Z];
  u_inputs<U_V, U_AX, U_AY, U_AZ, Ival>(
      p, Ival{x0[tile], x0[tile] + T0}, Ival{y0[tile], y0[tile] + T0},
      Ival{z, z}, in);
}
#endif
}  // namespace fidget

// the z0 corners and the subtiles' edge and count (nl: subtiles a root
// edge, 0 for explicit boxes) in the argument lists of U2-3D (nothing in
// 2D), and the entry point of each
#if U_Z3
#define U_Z0_PARAM const float *__restrict__ z0,
#define U_Z0_ARG z0,
#define U_SUB_PARAM float Ts, int nl,
#define U_SUB_ARG Ts, nl,
#define U_ILAUNCH fidget_unrolled_interval3_launch
#else
#define U_Z0_PARAM
#define U_Z0_ARG
#define U_SUB_PARAM
#define U_SUB_ARG
#define U_ILAUNCH fidget_unrolled_interval_launch
#endif

// A warp's stream: `void name(U_WARP_ARGS)`. `sh` points at the lane's
// column of the block's hand-off slots (slot s at sh[32 s]), `wd` at its
// column of the block's choice words (word j at wd[32 j]); `tile` is the
// lane's tile (the last one for lanes past n, which compute and write
// nothing).
// (U2-B: `Ival name(U_WARP_ARGS)`, the one stream of a box: its model
// box and the var values in, the output's interval out.)
#if U_BOX
#define U_WARP_ARGS                                                        \
  fidget::Ival bx, fidget::Ival by, fidget::Ival bz,                       \
      const float *__restrict__ params
#define U_TILE_INPUTS u_box_inputs<U_V, U_AX, U_AY, U_AZ>(bx, by, bz, params, in)
#define U_WARP_BEGIN(name)                                                 \
  extern "C" __device__ __noinline__ fidget::Ival name(U_WARP_ARGS) {      \
    using namespace fidget;                                                \
    Ival in[U_V];                                                          \
    U_TILE_INPUTS;                                                         \
    Ival o_{0.f, 0.f};                                                     \
    [[maybe_unused]] int c_ = 0;
#define U_WARP_END                                                         \
  return o_;                                                               \
  }
#else
#define U_WARP_ARGS                                                        \
  const float *__restrict__ x0, const float *__restrict__ y0, U_Z0_PARAM   \
      const float *__restrict__ params, float T0, U_SUB_PARAM              \
      fidget::Ival *sh, uint32_t *wd, bool *__restrict__ rin,              \
      bool *__restrict__ rout, int tile, bool live
#define U_TILE_INPUTS                                                      \
  u_tile_inputs(x0, y0, U_Z0_ARG params, T0, U_SUB_ARG tile, in)
#define U_WARP_BEGIN(name)                                                 \
  extern "C" __device__ __noinline__ void name(U_WARP_ARGS) {              \
    using namespace fidget;                                                \
    Ival in[U_V];                                                          \
    U_TILE_INPUTS;                                                         \
    [[maybe_unused]] uint32_t w_ = 0u;                                     \
    [[maybe_unused]] int c_ = 0;                                           \
    (void)sh;                                                              \
    (void)wd;                                                              \
    (void)rin;                                                             \
    (void)rout;                                                            \
    (void)live;

#define U_WARP_END }
#endif

// A hand-off slot of the lane, and the barrier between stages. The warps
// reach it from different functions, so it is the non-aligned
// `barrier.sync` (sm_70+), which is defined when the threads of a block
// arrive through different barrier instructions; __syncthreads (the
// aligned form) is not. Every warp passes the same number of them.
#define U_SH(s) sh[32 * (s)]
#define U_BAR() asm volatile("barrier.sync 0;" ::: "memory")
// the proofs, from the output row's value (U2-B: the stream's result)
#if U_BOX
#define U_OUT(v) (o_ = (v))
#else
#define U_OUT(v)                                                           \
  do {                                                                     \
    if (live) {                                                            \
      rin[tile] = (v).hi < 0.f;                                            \
      rout[tile] = (v).lo > 0.f;                                           \
    }                                                                      \
  } while (0)
#endif

// The choice epilogues: U_CHOICE(shift, code) after every choice row of
// the warp, U_WORD(j) when the warp's next choice (or none) lies in
// another word than j: the warp's part of word j is ORed into the
// block's word, which the kernel writes out (capture) or tests against
// u (violation) once every warp is done.
#if U_EPI != 0
#define U_CHOICE(s, c) (w_ |= (uint32_t)(c) << (s))
#define U_WORD(j) (atomicOr(wd + 32 * (j), w_), w_ = 0u)
#else
#define U_CHOICE(s, c) ((void)(c))
#define U_WORD(j) ((void)0)
#endif

// The kernel's unit declares the warp streams and defines
// `u_warps(warp, U_WARP_ARGS)`, which calls warp's stream, then expands
// U_INTERVAL_KERNEL with U_SLOTS hand-off slots, U_CW choice words and
// U_GW, where the block's words are: 0 in its shared memory, 1 in its
// [U_CW][32] part of the global `scratch`, for a tape whose words would
// not fit a block. A block is one group: U_K warps over 32 tiles. Its
// dynamic shared memory (u_shared_bytes) holds the slots, the words
// (epilogues 1, 2; U_GW 0) and the warps' violation flags (2).
#define U_CWS (U_EPI != 0 ? U_CW : 0)
#define U_INTERVAL_KERNEL                                                     \
  constexpr int u_shared_bytes =                                              \
      (U_SLOTS * 32) * (int)sizeof(fidget::Ival) +                            \
      (U_GW ? 0 : U_CWS * 32 * 4) + (U_EPI == 2 ? U_K * 32 : 0);              \
  extern "C" __global__ void __launch_bounds__(U_K * 32)                      \
      fidget_unrolled_interval(                                               \
          const float* __restrict__ x0, const float* __restrict__ y0,         \
          U_Z0_PARAM const float* __restrict__ params, float T0,              \
          U_SUB_PARAM const int32_t* __restrict__ u, bool* __restrict__ rin,  \
          bool* __restrict__ rout, int32_t* __restrict__ words,               \
          bool* __restrict__ viol, uint32_t* __restrict__ scratch, int n) {   \
    using namespace fidget;                                                   \
    extern __shared__ __align__(16) unsigned char u_smem_[];                  \
    Ival* sh_ = reinterpret_cast<Ival*>(u_smem_);                             \
    uint32_t* wsh_ = reinterpret_cast<uint32_t*>(sh_ + U_SLOTS * 32);         \
    bool* bad_ = reinterpret_cast<bool*>(wsh_ + (U_GW ? 0 : U_CWS * 32));     \
    uint32_t* wd_ =                                                           \
        U_GW ? scratch + (size_t)blockIdx.x * U_CWS * 32 : wsh_;              \
    const int l = threadIdx.x & 31;                                           \
    const int w = threadIdx.x >> 5;                                           \
    const int t = blockIdx.x * 32 + l;                                        \
    const bool live = t < n;                                                  \
    const int tile = live ? t : n - 1;                                        \
    if (U_CWS > 0) {                                                          \
      for (int i = threadIdx.x; i < U_CWS * 32; i += U_K * 32) wd_[i] = 0u;   \
      __syncthreads();                                                        \
    }                                                                         \
    u_warps(w, x0, y0, U_Z0_ARG params, T0, U_SUB_ARG sh_ + l, wd_ + l, rin,  \
            rout, tile, live);                                                \
    if (U_CWS > 0) __syncthreads();                                           \
    if (U_EPI == 1 && live)                                                   \
      for (int j = w; j < U_CWS; j += U_K)                                    \
        words[(size_t)j * n + tile] = (int32_t)wd_[32 * j + l];               \
    if (U_EPI == 2) {                                                         \
      bool bad = false;                                                       \
      for (int j = w; j < U_CWS; j += U_K) {                                  \
        const uint32_t uj = (uint32_t)__ldg(u + (size_t)j * n + tile);        \
        bad |= (wd_[32 * j + l] | uj) != uj;                                  \
      }                                                                       \
      bad_[threadIdx.x] = bad;                                                \
      __syncthreads();                                                        \
      if (w == 0 && live) {                                                   \
        bool any = false;                                                     \
        for (int k = 0; k < U_K; ++k) any |= bad_[32 * k + l];                \
        viol[tile] = any;                                                     \
      }                                                                       \
    }                                                                         \
  }                                                                           \
  extern "C" int U_ILAUNCH(                                                   \
      const float* x0, const float* y0, U_Z0_PARAM const float* params,       \
      float T0, U_SUB_PARAM                                                   \
      const int32_t* u, bool* rin, bool* rout, int32_t* words, bool* viol,    \
      uint32_t* scratch, int n, void* stream) {                               \
    const int blocks = (n + 31) / 32;                                         \
    FIDGET_SET_SMEM(fidget_unrolled_interval, u_shared_bytes);                \
    if (blocks > 0)                                                           \
      fidget_unrolled_interval<<<blocks, U_K * 32, u_shared_bytes,            \
                                 (cudaStream_t)stream>>>(                     \
          x0, y0, U_Z0_ARG params, T0, U_SUB_ARG u, rin, rout, words, viol,   \
          scratch, n);                                                        \
    return (int)cudaGetLastError();                                           \
  }

// U2-B's kernel unit declares its one stream `u_box(U_WARP_ARGS)`,
// defines U_BLOCK (threads a block) and expands U_BOX_KERNEL: proofs
// only, no choice words, one thread a box. U_BOX_KERNEL's lane t is box t
// of the [rows][cols] list of planes, live when t % cols < *count; a dead
// box gets no proof (false, false).
#define U_BOX_KERNEL                                                          \
  extern "C" __global__ void __launch_bounds__(U_BLOCK)                       \
      fidget_unrolled_interval_boxes(                                         \
          const float* __restrict__ box, const float* __restrict__ params,    \
          const int32_t* __restrict__ count, int cols,                        \
          bool* __restrict__ rin, bool* __restrict__ rout, int n) {           \
    using namespace fidget;                                                   \
    const long long t = (long long)blockIdx.x * U_BLOCK + threadIdx.x;        \
    if (t >= n) return;                                                       \
    const int lim = count ? __ldg(count) : cols;                              \
    bool full = false, empty = false;                                         \
    if ((int)(t % cols) < lim) {                                              \
      const Ival r = u_box(Ival{box[t], box[n + t]},                          \
                           Ival{box[2LL * n + t], box[3LL * n + t]},          \
                           Ival{box[4LL * n + t], box[5LL * n + t]}, params); \
      full = r.hi < 0.f;                                                      \
      empty = r.lo > 0.f;                                                     \
    }                                                                         \
    rin[t] = full;                                                            \
    rout[t] = empty;                                                          \
  }                                                                           \
  extern "C" int fidget_unrolled_interval_boxes_launch(                       \
      const float* box, const float* params, const int32_t* count, int cols,  \
      bool* rin, bool* rout, int n, void* stream) {                           \
    const int blocks = (n + U_BLOCK - 1) / U_BLOCK;                           \
    if (cols <= 0) return (int)cudaErrorInvalidValue;                         \
    if (blocks > 0)                                                           \
      fidget_unrolled_interval_boxes<<<blocks, U_BLOCK, 0,                    \
                                       (cudaStream_t)stream>>>(               \
          box, params, count, cols, rin, rout, n);                            \
    return (int)cudaGetLastError();                                           \
  }

// fused.py's level core on the parents' packed keys: thread g forms child
// g % 8 (corner offset (c & 1, c >> 1 & 1, c >> 2 & 1)) of parent g / 8,
// its world box [2 p + o] h_child - 1 + [0, h_child], and the model box
// through pos / neg [3][3] (the matrix's positive and negative parts) and
// off3 [3], lo = pos wlo + neg whi + off3 and hi = pos whi + neg wlo +
// off3, summed left to right. A parent is live below *count with a key
// >= 0; act [cin * 8] is true where a live parent's child is neither
// full nor empty, kid [cin * 8] the child's packed key (a dead parent's
// decoded as key 0).
#define U_LEVEL_KERNEL                                                        \
  extern "C" __global__ void __launch_bounds__(U_BLOCK)                       \
      fidget_unrolled_level(                                                  \
          const int32_t* __restrict__ keys, const int32_t* __restrict__ count,\
          int cin, const float* __restrict__ pos,                             \
          const float* __restrict__ neg, const float* __restrict__ off3,      \
          const float* __restrict__ params, float hc,                         \
          bool* __restrict__ act, int32_t* __restrict__ kid) {                \
    using namespace fidget;                                                   \
    const long long g = (long long)blockIdx.x * U_BLOCK + threadIdx.x;        \
    if (g >= 8LL * cin) return;                                               \
    const int p = (int)(g >> 3), c = (int)(g & 7);                            \
    const int k = __ldg(keys + p);                                            \
    const int kk = max(k, 0);                                                 \
    const int cx = kk / (U_KS * U_KS) * 2 + (c & 1);                          \
    const int cy = (kk / U_KS) % U_KS * 2 + ((c >> 1) & 1);                   \
    const int cz = kk % U_KS * 2 + ((c >> 2) & 1);                            \
    kid[g] = (cx * U_KS + cy) * U_KS + cz;                                    \
    bool a = false;                                                           \
    if (p < __ldg(count) && k >= 0) {                                         \
      const float wl[3] = {(float)cx * hc - 1.f, (float)cy * hc - 1.f,        \
                           (float)cz * hc - 1.f};                             \
      const float wh[3] = {wl[0] + hc, wl[1] + hc, wl[2] + hc};               \
      Ival b[3];                                                              \
      _Pragma("unroll") for (int r = 0; r < 3; ++r) {                         \
        const float* P = pos + 3 * r;                                         \
        const float* N = neg + 3 * r;                                         \
        b[r].lo = P[0] * wl[0] + P[1] * wl[1] + P[2] * wl[2] + N[0] * wh[0] + \
                  N[1] * wh[1] + N[2] * wh[2] + off3[r];                      \
        b[r].hi = P[0] * wh[0] + P[1] * wh[1] + P[2] * wh[2] + N[0] * wl[0] + \
                  N[1] * wl[1] + N[2] * wl[2] + off3[r];                      \
      }                                                                       \
      const Ival o = u_box(b[0], b[1], b[2], params);                         \
      a = !(o.hi < 0.f || o.lo > 0.f);                                        \
    }                                                                         \
    act[g] = a;                                                               \
  }                                                                           \
  extern "C" int fidget_unrolled_level_launch(                                \
      const int32_t* keys, const int32_t* count, int cin, const float* pos,   \
      const float* neg, const float* off3, const float* params, float hc,     \
      bool* act, int32_t* kid, void* stream) {                                \
    const long long blocks = (8LL * cin + U_BLOCK - 1) / U_BLOCK;             \
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;             \
    if (blocks > 0)                                                           \
      fidget_unrolled_level<<<(unsigned)blocks, U_BLOCK, 0,                   \
                              (cudaStream_t)stream>>>(                        \
          keys, count, cin, pos, neg, off3, params, hc, act, kid);            \
    return (int)cudaGetLastError();                                           \
  }
#endif  // U_K
