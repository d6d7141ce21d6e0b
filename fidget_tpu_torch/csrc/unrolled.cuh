// The two kernels generated per tape: the counterpart of the Pallas probe
// demos/exp_unrolled_kernel.py:49 (`build_unrolled_kernel`, the whole
// tape as straight-line code in one kernel) and of the straight-line XLA
// that fidget_tpu/eval/unrolled_fast.py traces for the per-shape
// compiled 2D path (`render_unrolled`, `render_dense`).
//
// fidget_tpu_torch/eval/unrolled_cuda.py emits one statement per tape row
// on local variables, one per tape register and memory slot, calling
// ops.cuh's f_* / i_* with constant opcodes so that every switch folds
// away, and includes this file for the rest:
//
// - U1 `fidget_unrolled_float`: lanes are pixels of a compacted worklist
//   of tiles (or of one tile covering the whole image). A thread forms
//   its pixel from its tile's origin, applies the screen -> model matrix
//   in the f32 order of render/transform.py `transform_points`, and runs
//   the program of the segment its slot lies in (a union frame's P
//   programs and the full-tape fallback in one launch; each program is a
//   device function of its own translation unit, linked with -rdc, so
//   that the programs compile in parallel). Invalid slots get 0.
// - U2 `fidget_unrolled_interval`: lanes are cull tiles. A thread forms
//   its tile's box through `transform_intervals` (IntervalMode rules),
//   runs the tape with eval_tape_interval_fast's rules (u_min / u_max /
//   u_div below; every other op is ops.cuh's interval mode) and writes
//   the proofs hi < 0 and lo > 0, plus one epilogue fixed when the code
//   is generated (U_EPI): 0 nothing more; 1 the packed choice words
//   [cw][n] (choice j in word j / 16 at bit 2 (j % 16)); 2 the fused
//   violation flag ((w | u) != u per finished word, u [cw][n]). Its body
//   is cut into chunks of rows, each a device function of its own
//   translation unit (`UState` carries the thread's registers between
//   them), because an interval row is tens of instructions and a long
//   tape in one unit is the slowest build of a frame.
//
// What bounds them on the card: arithmetic. A row is one to a dozen
// instructions on registers, with no tape to fetch or decode (the
// interpreter kernels' cost), so the bound is the rows times the lanes
// over the issue rate; the inputs are a few bytes a lane. The design is
// the simple one: one lane a thread, registers allocated by ptxas.
// Built with --fmad=false, as every kernel of the port, so that no a*b+c
// rounds differently from the plain PyTorch versions.
#pragma once

#include <cstdint>

#include "ops.cuh"

namespace fidget {

constexpr int UBLOCK = 128;

// eval_tape_interval_fast's MIN / MAX: NaN-propagating folds, no poison;
// Left when a lies wholly below (MIN) / above (MAX) b, Right the mirror,
// else Both (a NaN fails both compares)
__device__ __forceinline__ Ival u_min(Ival a, Ival b, int& c) {
  c = a.hi < b.lo ? CHOICE_LEFT : (b.hi < a.lo ? CHOICE_RIGHT : CHOICE_BOTH);
  return Ival{nmin(a.lo, b.lo), nmin(a.hi, b.hi)};
}
__device__ __forceinline__ Ival u_max(Ival a, Ival b, int& c) {
  c = a.lo > b.hi ? CHOICE_LEFT : (b.lo > a.hi ? CHOICE_RIGHT : CHOICE_BOTH);
  return Ival{nmax(a.lo, b.lo), nmax(a.hi, b.hi)};
}

// DIV: NaN-propagating corner folds; poisoned only where the denominator
// spans zero (an immediate denominator of 0 is emitted as a NaN constant)
__device__ __forceinline__ Ival u_div_corners(Ival a, Ival b) {
  const float q0 = a.lo / b.lo, q1 = a.lo / b.hi;
  const float q2 = a.hi / b.lo, q3 = a.hi / b.hi;
  return Ival{nmin(nmin(q0, q1), nmin(q2, q3)),
              nmax(nmax(q0, q1), nmax(q2, q3))};
}
__device__ __forceinline__ Ival u_div(Ival a, Ival b) {
  const bool bad = !(b.lo > 0.f || b.hi < 0.f);
  return bad ? Ival{f_nan(), f_nan()} : u_div_corners(a, b);
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

// Float programs: `float fidget_uprog_<key>(float i0, ...)`, one
// translation unit each. The kernel's unit defines U_V / U_AX / U_AY /
// U_AZ and `u_run(segment, in)`, then expands U_FLOAT_KERNEL.
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
      int lo = 0, hi = nseg - 1;                                              \
      while (lo < hi) {                                                       \
        const int mid = (lo + hi + 1) >> 1;                                   \
        if (slot >= seg[mid]) lo = mid;                                       \
        else hi = mid - 1;                                                    \
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

// The choice epilogue of U2 (U_EPI, see the top of this file): the
// generated body calls U_CHOICE(shift, code) after every choice op and
// U_WORD(j) after the last choice of word j.
#if defined(U_EPI) && U_EPI == 1
#define U_CHOICE(s, c) (w_ |= (uint32_t)(c) << (s))
#define U_WORD(j) (words[(size_t)(j) * n + lane] = (int32_t)w_, w_ = 0u)
#elif defined(U_EPI) && U_EPI == 2
#define U_CHOICE(s, c) (w_ |= (uint32_t)(c) << (s))
#define U_WORD(j)                                                     \
  do {                                                                \
    const uint32_t u_ = (uint32_t)__ldg(u + (size_t)(j) * n + lane);  \
    bad_ |= (w_ | u_) != u_;                                          \
    w_ = 0u;                                                          \
  } while (0)
#else
#define U_CHOICE(s, c) ((void)(c))
#define U_WORD(j) ((void)0)
#endif

// U2's state between the chunks of its body: the tape's registers and
// memory slots, the inputs, the output, the word being packed and the
// violation flag. Each chunk is a device function of its own translation
// unit (U_CHUNK below), so that a long tape's interval code compiles in
// parallel; the thread's state stays in its local memory between them.
#if defined(U_NR)
namespace fidget {
struct UState {
  Ival r[U_NR];
  Ival m[U_NM > 0 ? U_NM : 1];
  Ival in[U_V];
  Ival o;
  uint32_t w;
  bool bad;
};
}  // namespace fidget

#define U_CHUNK_ARGS                                                       \
  fidget::UState *__restrict__ s_, const int32_t *__restrict__ u,          \
      int32_t *__restrict__ words, int n, int lane

// A chunk opens with its state in locals (U_CHUNK_BEGIN(name), then the
// generated loads `Ival rK = s_->r[K];`) and closes by storing them back
// (the generated stores, then U_CHUNK_END).
#define U_CHUNK_BEGIN(name)                                                \
  extern "C" __device__ __noinline__ void name(U_CHUNK_ARGS) {             \
    using namespace fidget;                                                \
    [[maybe_unused]] const Ival* in = s_->in;                              \
    [[maybe_unused]] uint32_t w_ = s_->w;                                  \
    bool bad_ = s_->bad;                                                   \
    Ival o_ = s_->o;                                                       \
    (void)u;                                                               \
    (void)words;                                                           \
    (void)n;                                                               \
    (void)lane;

#define U_CHUNK_END                                                        \
    s_->w = w_;                                                            \
    s_->bad = bad_;                                                        \
    s_->o = o_;                                                            \
  }

// The kernel's unit declares the chunks and defines
// `u_chunks(s, u, words, n, lane)`, which calls them in order, then
// expands U_INTERVAL_KERNEL.
#define U_INTERVAL_KERNEL                                                     \
  extern "C" __global__ void __launch_bounds__(fidget::UBLOCK)                \
      fidget_unrolled_interval(                                               \
          const float* __restrict__ x0, const float* __restrict__ y0,         \
          const float* __restrict__ params, float T0,                         \
          const int32_t* __restrict__ u, bool* __restrict__ rin,              \
          bool* __restrict__ rout, int32_t* __restrict__ words,               \
          bool* __restrict__ viol, int n) {                                   \
    using namespace fidget;                                                   \
    const int lane = blockIdx.x * UBLOCK + threadIdx.x;                       \
    if (lane >= n) return;                                                    \
    UState s = {};                                                            \
    const float z = params[U_PARAM_Z];                                        \
    u_inputs<U_V, U_AX, U_AY, U_AZ, Ival>(                                    \
        params, Ival{x0[lane], x0[lane] + T0}, Ival{y0[lane], y0[lane] + T0}, \
        Ival{z, z}, s.in);                                                    \
    u_chunks(&s, u, words, n, lane);                                          \
    rin[lane] = s.o.hi < 0.f;                                                 \
    rout[lane] = s.o.lo > 0.f;                                                \
    if (viol != nullptr) viol[lane] = s.bad;                                  \
  }                                                                           \
  extern "C" int fidget_unrolled_interval_launch(                             \
      const float* x0, const float* y0, const float* params, float T0,        \
      const int32_t* u, bool* rin, bool* rout, int32_t* words, bool* viol,    \
      int n, void* stream) {                                                  \
    const int blocks = (n + fidget::UBLOCK - 1) / fidget::UBLOCK;             \
    if (blocks > 0)                                                           \
      fidget_unrolled_interval<<<blocks, fidget::UBLOCK, 0,                   \
                                 (cudaStream_t)stream>>>(                     \
          x0, y0, params, T0, u, rin, rout, words, viol, n);                  \
    return (int)cudaGetLastError();                                           \
  }
#endif  // U_NR
