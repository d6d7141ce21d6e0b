// The row loop shared by the value-mode interpreters: interp_float.cu
// (K3), interp_float_coded.cu (K6), interp_voxel_depth.cu (K5),
// interp_grad.cu (K4) and the two-stream probe interleave.cu (P2, which
// takes `row_value` alone). A thread owns R = 4 (2, 1) neighbouring lanes,
// and a block walks rows already decoded into a `TapeRing` buffer
// (ops.cuh `stage_row`), one 16-byte broadcast row and its immediate at
// a time. The loop is written once, over two parameters:
//   - a value mode: what a lane holds and how an op computes it,
//     `Floats<R>` (one float) or `Duals<R, P>` (P planes of forward-mode
//     duals, the value v and the tangents dx, dy, dz up to P, each plane
//     its own register file);
//   - an output sink: what an OUTPUT row does with its `a` operand,
//     `StoreOutput` (write it to the output planes) or `KeepOutput`
//     (keep it in registers, as the voxel pass does with the distance).
#pragma once

#include "ops.cuh"

namespace fidget {

template <int R>
struct alignas(4 * R) Pack {
  float v[R];
};

template <int R>
__device__ __forceinline__ Pack<R> splat(float x) {
  Pack<R> p;
#pragma unroll
  for (int i = 0; i < R; ++i) p.v[i] = x;
  return p;
}

template <int R>
__device__ __forceinline__ Pack<R> load_pack(const void* p) {
  return *reinterpret_cast<const Pack<R>*>(p);
}
template <int R>
__device__ __forceinline__ void store_pack(void* p, const Pack<R>& v) {
  *reinterpret_cast<Pack<R>*>(p) = v;
}

// Float mode. Register file [nf][lanes]; inputs and outputs are planes
// `lanes` floats apart.
template <int R>
struct Floats {
  using Val = Pack<R>;

  // an operand: the thread's R lanes of a register, or the immediate
  __device__ __forceinline__ Val load(const unsigned char* regs, int off,
                                      float iv) const {
    if (off >= 0) return load_pack<R>(regs + off);
    return splat<R>(iv);
  }
  __device__ __forceinline__ void store(unsigned char* regs, int off,
                                        const Val& v) const {
    store_pack<R>(regs + off, v);
  }
  __device__ __forceinline__ Val input(const float* tvars, int pay,
                                       int lanes) const {
    return load_pack<R>(tvars + (size_t)pay * lanes);
  }
  __device__ __forceinline__ void output(float* tout, int pay, int lanes,
                                         const Val& v) const {
    store_pack<R>(tout + (size_t)pay * lanes, v);
  }
  // zeroes output plane o
  __device__ __forceinline__ void clear(float* tout, int o, int lanes) const {
    store_pack<R>(tout + (size_t)o * lanes, splat<R>(0.f));
  }
  template <int OP>
  __device__ __forceinline__ static Val unary(const Val& a) {
    Val r;
#pragma unroll
    for (int i = 0; i < R; ++i) r.v[i] = f_unary(OP, a.v[i]);
    return r;
  }
  template <int OP>
  __device__ __forceinline__ static Val binary(const Val& a, const Val& b) {
    Val r;
#pragma unroll
    for (int i = 0; i < R; ++i) r.v[i] = f_binary(OP, a.v[i], b.v[i]);
    return r;
  }
};

// Grad mode: P register files (the value and its first P - 1 tangents,
// 2 <= P <= 4), plane k `pstride` bytes after plane 0; a row's operand
// offsets address plane 0. An immediate reads as (imm, 0, ...). Input
// and output i hold their P planes at (P i + k) * lanes. An op runs the
// full four-plane `Dual` rule with the missing tangents 0 and keeps the
// first P planes, so every kept plane is the same expression at every
// P, and the compiler drops the discarded ones.
template <int R, int P>
struct Duals {
  static_assert(P >= 2 && P <= 4, "a dual holds the value and 1-3 tangents");
  struct Val {
    Pack<R> p[P];
  };
  int pstride;

  __device__ __forceinline__ Val load(const unsigned char* regs, int off,
                                      float iv) const {
    Val r;
    if (off >= 0) {
#pragma unroll
      for (int k = 0; k < P; ++k) r.p[k] = load_pack<R>(regs + off + k * pstride);
    } else {
      r.p[0] = splat<R>(iv);
#pragma unroll
      for (int k = 1; k < P; ++k) r.p[k] = splat<R>(0.f);
    }
    return r;
  }
  __device__ __forceinline__ void store(unsigned char* regs, int off,
                                        const Val& v) const {
#pragma unroll
    for (int k = 0; k < P; ++k) store_pack<R>(regs + off + k * pstride, v.p[k]);
  }
  __device__ __forceinline__ Val input(const float* tvars, int pay,
                                       int lanes) const {
    Val r;
#pragma unroll
    for (int k = 0; k < P; ++k)
      r.p[k] = load_pack<R>(tvars + (size_t)(P * pay + k) * lanes);
    return r;
  }
  __device__ __forceinline__ void output(float* tout, int pay, int lanes,
                                         const Val& v) const {
#pragma unroll
    for (int k = 0; k < P; ++k)
      store_pack<R>(tout + (size_t)(P * pay + k) * lanes, v.p[k]);
  }
  __device__ __forceinline__ void clear(float* tout, int o, int lanes) const {
#pragma unroll
    for (int k = 0; k < P; ++k)
      store_pack<R>(tout + (size_t)(P * o + k) * lanes, splat<R>(0.f));
  }
  // lane i of `a` as a four-plane dual, the planes past P read as 0
  __device__ __forceinline__ static Dual lane(const Val& a, int i) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < P; ++k) d[k] = a.p[k].v[i];
    return Dual{d[0], d[1], d[2], d[3]};
  }
  // the first P planes of `d` into lane i of `r`
  __device__ __forceinline__ static void keep(Val& r, int i, const Dual& d) {
    const float e[4] = {d.v, d.dx, d.dy, d.dz};
#pragma unroll
    for (int k = 0; k < P; ++k) r.p[k].v[i] = e[k];
  }
  template <int OP>
  __device__ __forceinline__ static Val unary(const Val& a) {
    Val r;
#pragma unroll
    for (int i = 0; i < R; ++i) keep(r, i, g_unary(OP, lane(a, i)));
    return r;
  }
  template <int OP>
  __device__ __forceinline__ static Val binary(const Val& a, const Val& b) {
    Val r;
#pragma unroll
    for (int i = 0; i < R; ++i)
      keep(r, i, g_binary(OP, lane(a, i), lane(b, i)));
    return r;
  }
};

// OUTPUT writes its operand to output plane min(aux, O - 1)
template <class Mode>
struct StoreOutput {
  float* tout;
  int lanes;
  __device__ __forceinline__ void operator()(const Mode& m, int pay,
                                             const typename Mode::Val& v) {
    m.output(tout, pay, lanes, v);
  }
};

// OUTPUT keeps its operand: after the walk, `v` is the last OUTPUT's
template <class Mode>
struct KeepOutput {
  typename Mode::Val v;
  __device__ __forceinline__ void operator()(const Mode&, int,
                                             const typename Mode::Val& a) {
    v = a;
  }
};

#define FIDGET_UNARY(OP)                       \
  case OP:                                     \
    r = Mode::template unary<OP>(va);          \
    break;
#define FIDGET_BINARY(OP)                      \
  case OP:                                     \
    r = Mode::template binary<OP>(va, vb);     \
    break;

// The value of one tape row on the thread's R lanes from its operands:
// one flat switch with a constant opcode per case. OUTPUT hands `va` to
// the sink and passes it on; COPY (and any opcode past the switch)
// passes `va` through.
template <class Mode, class Sink>
__device__ __forceinline__ typename Mode::Val row_value(
    const Mode& m, Sink& sink, const Row cur, const typename Mode::Val& va,
    const typename Mode::Val& vb, const float* tvars, int lanes) {
  using Val = typename Mode::Val;
  const int pay = cur.op_pay >> 8;
  Val r;
  switch (cur.op_pay & 0xFF) {
    case OP_OUTPUT:
      sink(m, pay, va);
      r = va;
      break;
    case OP_INPUT:
      r = m.input(tvars, pay, lanes);
      break;
    FIDGET_UNARY(OP_NEG) FIDGET_UNARY(OP_ABS) FIDGET_UNARY(OP_RECIP)
    FIDGET_UNARY(OP_SQRT) FIDGET_UNARY(OP_SQUARE) FIDGET_UNARY(OP_FLOOR)
    FIDGET_UNARY(OP_CEIL) FIDGET_UNARY(OP_ROUND) FIDGET_UNARY(OP_SIN)
    FIDGET_UNARY(OP_COS) FIDGET_UNARY(OP_TAN) FIDGET_UNARY(OP_ASIN)
    FIDGET_UNARY(OP_ACOS) FIDGET_UNARY(OP_ATAN) FIDGET_UNARY(OP_EXP)
    FIDGET_UNARY(OP_LN) FIDGET_UNARY(OP_NOT)
    FIDGET_BINARY(OP_ADD) FIDGET_BINARY(OP_SUB) FIDGET_BINARY(OP_MUL)
    FIDGET_BINARY(OP_DIV) FIDGET_BINARY(OP_ATAN2) FIDGET_BINARY(OP_COMPARE)
    FIDGET_BINARY(OP_MOD) FIDGET_BINARY(OP_MIN) FIDGET_BINARY(OP_MAX)
    FIDGET_BINARY(OP_AND) FIDGET_BINARY(OP_OR)
    default:  // OP_COPY
      r = va;
      break;
  }
  return r;
}

// One tape row on the thread's R lanes: both operand loads first, then
// the row's value, then its store.
template <class Mode, class Sink>
__device__ __forceinline__ void run_row(const Mode& m, Sink& sink,
                                        const Row cur, const float iv,
                                        unsigned char* regs,
                                        const float* tvars, int lanes) {
  using Val = typename Mode::Val;
  const Val va = m.load(regs, cur.a, iv);
  const Val vb = m.load(regs, cur.b, iv);
  m.store(regs, cur.out, row_value(m, sink, cur, va, vb, tvars, lanes));
}

#undef FIDGET_UNARY
#undef FIDGET_BINARY

// Rows [0, count) of one decoded buffer, two a turn, each loaded while
// the other runs, into registers of its own: a single loop-carried row
// would be copied at the top of the loop and wait there for the load
// just started. The slot past `count` is read and never run.
template <class Mode, class Sink>
__device__ __forceinline__ void run_rows(const Mode& m, Sink& sink,
                                         const Row* rows, const float* imms,
                                         int count, unsigned char* regs,
                                         const float* tvars, int lanes) {
  Row row_a = rows[0];
  float imm_a = imms[0];
  for (int k = 0; k < count; k += 2) {
    const Row row_b = rows[k + 1];
    const float imm_b = imms[k + 1];
    run_row(m, sink, row_a, imm_a, regs, tvars, lanes);
    if (k + 1 >= count) break;
    row_a = rows[k + 2];
    imm_a = imms[k + 2];
    run_row(m, sink, row_b, imm_b, regs, tvars, lanes);
  }
}

// Where a block's rows land: the order table (or null), the register
// file's size and its bytes from one register to the next, and the
// input and output counts that clamp INPUT and OUTPUT payloads.
struct Staging {
  const int32_t* order;
  int nf, stride, V, O;
};

// The whole of one tape, rows [0, n), through the ring: the next chunk
// is copied while this one runs and decoded behind it. Every thread of
// the block must call it; it ends on a barrier, after which the ring
// may be reused.
template <class Mode, class Sink>
__device__ __forceinline__ void run_tape(const Mode& m, Sink& sink,
                                         const TapeRing& ring,
                                         const Staging& st,
                                         const int32_t* tw1,
                                         const int32_t* tw2,
                                         const float* timm, int n,
                                         unsigned char* regs,
                                         const float* tvars, int lanes) {
  const int chunk = ring.chunk;
  ring.fetch(tw1, tw2, timm, 0, min(chunk, n));
  ring.decode(0, min(chunk, n), st.order, st.nf, st.stride, st.V, st.O, 0);
  __syncthreads();
  for (int j0 = 0, buf = 0; j0 < n; j0 += chunk, buf ^= 1) {
    const int count = min(chunk, n - j0);
    const int next = min(chunk, n - j0 - chunk);
    if (next > 0) ring.fetch(tw1, tw2, timm, j0 + chunk, next);
    run_rows(m, sink, ring.rows(buf), ring.imms(buf), count, regs, tvars,
             lanes);
    if (next > 0)
      ring.decode(buf ^ 1, next, st.order, st.nf, st.stride, st.V, st.O, 0);
    __syncthreads();
  }
}

}  // namespace fidget
