// Tape opcodes, packed-word decoding and the per-op arithmetic of the
// float, interval and grad value modes, shared by the interpreter
// kernels.
//
// Every function transcribes the matching branch of
// fidget_tpu_torch/eval/arith.py (itself fidget_tpu/eval/arith.py),
// which in turn follows fidget-core/src/types/interval.rs. The rules
// that must be copied exactly, because they decide choice codes and
// NaN propagation:
//   - Rust f32::min/max (fminf/fmaxf: a NaN operand is ignored);
//   - round half away from zero, returning |a| >= 2^23 unchanged;
//   - COMPARE of a NaN operand is NaN;
//   - MOD is rem_euclid: fmod, then + |b| when negative;
//   - intervals with a NaN bound poison to [NaN, NaN];
//   - quadrant-aware interval sin/cos, with a NaN quadrant read as 0
//     (the f32 -> i32 conversion of both XLA and cvt.rzi).
// Built with --fmad=false so that no a*b+c is contracted into an FMA
// that the plain PyTorch version would round differently.
#pragma once

#include <cstddef>
#include <cstdint>

namespace fidget {

// canonical TapeOp numbering (fidget_tpu_torch/compiler/tape.py)
enum Op : int {
  OP_OUTPUT = 0, OP_INPUT = 1, OP_COPY = 2, OP_MAX = 3, OP_SUB = 4,
  OP_ADD = 5, OP_MIN = 6, OP_NEG = 7, OP_SQUARE = 8, OP_SQRT = 9,
  OP_MUL = 10, OP_DIV = 11, OP_ABS = 12, OP_EXP = 13, OP_LN = 14,
  OP_RECIP = 15, OP_FLOOR = 16, OP_CEIL = 17, OP_ROUND = 18, OP_NOT = 19,
  OP_AND = 20, OP_OR = 21, OP_MOD = 22, OP_COMPARE = 23, OP_ATAN2 = 24,
  OP_SIN = 25, OP_COS = 26, OP_TAN = 27, OP_ASIN = 28, OP_ACOS = 29,
  OP_ATAN = 30,
};

constexpr int IMM12 = 0xFFF;
constexpr uint32_t CHOICE_MASK =
    (1u << OP_MIN) | (1u << OP_MAX) | (1u << OP_AND) | (1u << OP_OR);
constexpr uint32_t BINARY_MASK =
    (1u << OP_ADD) | (1u << OP_SUB) | (1u << OP_MUL) | (1u << OP_DIV) |
    (1u << OP_ATAN2) | (1u << OP_COMPARE) | (1u << OP_MOD) |
    (1u << OP_MIN) | (1u << OP_MAX) | (1u << OP_AND) | (1u << OP_OR);

constexpr int CHOICE_LEFT = 1;
constexpr int CHOICE_RIGHT = 2;
constexpr int CHOICE_BOTH = 3;

// threads per block of every interpreter kernel; launch geometry beyond
// that (lanes per thread, shared-memory bytes, tape chunk, register-file
// route) is decided in fidget_tpu_torch/eval/cuda.py and passed in
constexpr int BLOCK = 128;

struct Word {
  int op, out, a, b, aux;
};

// compiler/pack.py layout: w1 = op | out << 7 | a << 19, w2 = b | aux << 12
__device__ __forceinline__ Word decode(int32_t w1, int32_t w2) {
  Word w;
  w.op = w1 & 127;
  w.out = (w1 >> 7) & 0xFFF;
  w.a = (w1 >> 19) & 0xFFF;
  w.b = w2 & 0xFFF;
  w.aux = w2 >> 12;
  return w;
}

// The same for an arena packed under an opcode renumbering
// (compiler/pack.py `pack_tapes(op_order=...)`): `order` maps the 31
// positions of the op field back to canonical opcodes, so the kernels
// keep one switch over the canonical numbering. ORDERED is a template
// parameter of the kernels, so the canonical path (no table) compiles
// to the plain decode.
constexpr int N_OPS = 31;
template <bool ORDERED>
__device__ __forceinline__ Word decode(int32_t w1, int32_t w2,
                                       const int32_t* __restrict__ order) {
  Word w = decode(w1, w2);
  if (ORDERED && w.op < N_OPS) w.op = __ldg(order + w.op);
  return w;
}

// ---------------------------------------------------------------------
// Staged tape rows (interp_float.cu, interp_interval.cu). A block copies
// its tape chunk by chunk into shared memory with cp.async, one chunk
// ahead of the one it executes, and decodes every row once per block
// instead of once per warp: the opcode mapped back through the order
// table, operands as byte offsets into the register file (already
// clamped to nf - 1 and scaled by the row stride), the payload of aux
// already clamped. The row loop then reads one 16-byte broadcast word
// and an immediate per row.

struct alignas(16) Row {
  int32_t op_pay;  // op | payload << 8
  int32_t a, b;    // operand byte offsets, or OPND_IMM
  int32_t out;     // result byte offset
};

// operand is the row's immediate (also set for operands the op ignores)
constexpr int OPND_IMM = -1;

// Payload by op: OUTPUT min(aux, O - 1); INPUT min(aux, V - 1); choice
// ops (CW > 0) min(aux / 16, CW - 1) << 5 | (aux % 16) * 2; else 0.
__device__ __forceinline__ Row stage_row(int32_t w1, int32_t w2,
                                         const int32_t* __restrict__ order,
                                         int nf, int stride, int V, int O,
                                         int CW) {
  int op = w1 & 127;
  if (op >= N_OPS) op = OP_COPY;  // the value modes' default: pass a through
  else if (order != nullptr) op = __ldg(order + op);
  const int a = (w1 >> 19) & 0xFFF, b = w2 & 0xFFF, out = (w1 >> 7) & 0xFFF;
  const int aux = (int)((uint32_t)w2 >> 12);
  int pay = 0;
  if (op == OP_OUTPUT) pay = min(aux, O - 1);
  else if (op == OP_INPUT) pay = min(aux, V - 1);
  else if (CW > 0 && ((CHOICE_MASK >> op) & 1))
    pay = (min(aux >> 4, CW - 1) << 5) | ((aux & 15) * 2);
  Row r;
  r.op_pay = op | (pay << 8);
  r.a = (op == OP_INPUT || a == IMM12) ? OPND_IMM : min(a, nf - 1) * stride;
  r.b = (!((BINARY_MASK >> op) & 1) || b == IMM12) ? OPND_IMM
                                                   : min(b, nf - 1) * stride;
  r.out = min(out, nf - 1) * stride;
  return r;
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The ring of one block: raw words as cp.async lands them (each thread
// reads back only the slots it copied itself, so no barrier lies
// between the wait and the decode), and two buffers of decoded rows and
// immediates, one executing and one being filled. `chunk` rows each,
// plus one slot so that the loop may read one row ahead.
__host__ __device__ constexpr size_t tape_ring_bytes(int chunk) {
  return ((size_t)(chunk + 1) * 2 * (sizeof(Row) + sizeof(float)) +
          (size_t)chunk * 3 * sizeof(int32_t) + 15) / 16 * 16;
}

struct TapeRing {
  unsigned char* base;  // 16-byte aligned shared memory
  int chunk;

  // buffers are addressed by arithmetic on `base`, so that the compiler
  // keeps them in the shared address space and in registers
  __device__ __forceinline__ Row* rows(int buf) const {
    return reinterpret_cast<Row*>(base) + buf * (chunk + 1);
  }
  __device__ __forceinline__ float* imms(int buf) const {
    return reinterpret_cast<float*>(rows(2)) + buf * (chunk + 1);
  }
  __device__ __forceinline__ int32_t* raw(int word) const {
    return reinterpret_cast<int32_t*>(imms(2)) + word * chunk;
  }
  // the first byte behind the ring
  __device__ __forceinline__ unsigned char* end() const {
    return base + tape_ring_bytes(chunk);
  }

  // starts the copy of rows [j0, j0 + count) of one tape
  __device__ __forceinline__ void fetch(const int32_t* w1, const int32_t* w2,
                                        const float* imm, int j0,
                                        int count) const {
    for (int k = threadIdx.x; k < count; k += BLOCK) {
      cp_async4(raw(0) + k, w1 + j0 + k);
      cp_async4(raw(1) + k, w2 + j0 + k);
      cp_async4(raw(2) + k, imm + j0 + k);
    }
    cp_async_commit();
  }

  // waits for this thread's copies and decodes them into buffer `buf`
  __device__ __forceinline__ void decode(int buf, int count,
                                         const int32_t* __restrict__ order,
                                         int nf, int stride, int V, int O,
                                         int CW) const {
    cp_async_wait_all();
    for (int k = threadIdx.x; k < count; k += BLOCK) {
      rows(buf)[k] =
          stage_row(raw(0)[k], raw(1)[k], order, nf, stride, V, O, CW);
      imms(buf)[k] = __int_as_float(raw(2)[k]);
    }
  }
};

__device__ __forceinline__ float f_nan() { return __int_as_float(0x7fc00000); }

// f32(pi) and f32(2 pi), and the f32 of 2 / f32(pi), as numpy forms them
constexpr float F32PI = 3.14159274101257324f;
constexpr float F32TAU = 6.28318548202514648f;
constexpr float QSCALE = (float)(2.0 / 3.14159274101257324);

// numpy minimum/maximum: NaN-propagating
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? f_nan() : fminf(a, b);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? f_nan() : fmaxf(a, b);
}

__device__ __forceinline__ float f_round(float a) {
  float r = a >= 0.f ? floorf(a + 0.5f) : ceilf(a - 0.5f);
  return fabsf(a) >= 8388608.f ? a : r;
}

__device__ __forceinline__ float f_mod(float a, float b) {
  float r = fmodf(a, b);
  return r < 0.f ? r + fabsf(b) : r;
}

// ---------------------------------------------------------------------
// float mode (FloatMode)

__device__ __forceinline__ float f_unary(int op, float a) {
  switch (op) {
    case OP_NEG: return -a;
    case OP_ABS: return fabsf(a);
    case OP_RECIP: return 1.0f / a;
    case OP_SQRT: return sqrtf(a);
    case OP_SQUARE: return a * a;
    case OP_FLOOR: return floorf(a);
    case OP_CEIL: return ceilf(a);
    case OP_ROUND: return f_round(a);
    case OP_SIN: return sinf(a);
    case OP_COS: return cosf(a);
    case OP_TAN: return tanf(a);
    case OP_ASIN: return asinf(a);
    case OP_ACOS: return acosf(a);
    case OP_ATAN: return atanf(a);
    case OP_EXP: return expf(a);
    case OP_LN: return logf(a);
    case OP_NOT: return a == 0.f ? 1.f : 0.f;
    default: return a;
  }
}

// every binary op, choice ops included (the float kernel drops choices)
__device__ __forceinline__ float f_binary(int op, float a, float b) {
  switch (op) {
    case OP_ADD: return a + b;
    case OP_SUB: return a - b;
    case OP_MUL: return a * b;
    case OP_DIV: return a / b;
    case OP_ATAN2: return atan2f(a, b);
    case OP_COMPARE:
      if (isnan(a) || isnan(b)) return f_nan();
      return a < b ? -1.f : (a > b ? 1.f : 0.f);
    case OP_MOD: return f_mod(a, b);
    case OP_MIN: {
      bool nan = isnan(a) || isnan(b);
      return a < b ? a : (b < a ? b : (nan ? f_nan() : b));
    }
    case OP_MAX: {
      bool nan = isnan(a) || isnan(b);
      return a > b ? a : (b > a ? b : (nan ? f_nan() : b));
    }
    case OP_AND: return a == 0.f ? a : b;
    case OP_OR: return a != 0.f ? a : b;
    default: return a;
  }
}

// ---------------------------------------------------------------------
// interval mode (IntervalMode)

struct Ival {
  float lo, hi;
};

__device__ __forceinline__ Ival poison(bool bad, float lo, float hi) {
  return bad ? Ival{f_nan(), f_nan()} : Ival{lo, hi};
}

__device__ __forceinline__ bool has_nan(Ival a) {
  return isnan(a.lo) || isnan(a.hi);
}

__device__ __forceinline__ float quadrant(float v) {
  float q = floorf(v * QSCALE);
  q = q - floorf(q / 4.0f) * 4.0f;
  return isnan(q) ? 0.f : q;
}

// interval.rs:109-204
__device__ __forceinline__ Ival i_sin_cos(Ival a, bool is_sin) {
  float al = a.lo, au = a.hi;
  float fl = is_sin ? sinf(al) : cosf(al);
  float fu = is_sin ? sinf(au) : cosf(au);
  float lq = quadrant(al), uq = quadrant(au);
  float d = au - al;
  bool a_inc, b_inc, full_ii, full_dd;
  if (is_sin) {
    a_inc = lq == 0.f || lq == 3.f;
    b_inc = uq == 0.f || uq == 3.f;
    full_ii = lq == 0.f && uq == 3.f;
    full_dd = lq == 2.f && uq == 1.f;
  } else {
    a_inc = lq >= 2.f;
    b_inc = uq >= 2.f;
    full_ii = lq == 3.f && uq == 2.f;
    full_dd = lq == 1.f && uq == 0.f;
  }
  bool inc = a_inc && b_inc && !full_ii;
  bool dec = !a_inc && !b_inc && !full_dd;
  bool up = a_inc && !b_inc;
  bool down = !a_inc && b_inc;
  bool wide = d >= F32PI;
  float lo, hi;
  if (inc) {
    lo = wide ? -1.f : fl;
    hi = wide ? 1.f : fu;
  } else if (dec) {
    lo = wide ? -1.f : fu;
    hi = wide ? 1.f : fl;
  } else {
    lo = up ? nmin(fl, fu) : -1.f;
    hi = down ? nmax(fl, fu) : 1.f;
  }
  if (d >= F32TAU) {
    lo = -1.f;
    hi = 1.f;
  }
  return poison(has_nan(a), lo, hi);
}

__device__ __forceinline__ Ival i_unary(int op, Ival a) {
  float al = a.lo, au = a.hi;
  switch (op) {
    case OP_NEG: return Ival{-au, -al};
    case OP_ABS: {
      // interval.rs:67-78
      float lo = al < 0.f ? (au > 0.f ? 0.f : -au) : al;
      float hi = al < 0.f ? (au > 0.f ? nmax(au, -al) : -al) : au;
      return Ival{lo, hi};
    }
    case OP_RECIP:
      return poison(!(al > 0.f || au < 0.f), 1.0f / au, 1.0f / al);
    case OP_SQRT: return poison(al < 0.f, sqrtf(al), sqrtf(au));
    case OP_SQUARE: {
      // interval.rs:82-94
      float lo2 = al * al, hi2 = au * au;
      float m = nmax(fabsf(al), fabsf(au));
      float mixed_hi = m * m;
      float lo = au < 0.f ? hi2 : (al > 0.f ? lo2 : 0.f);
      float hi = au < 0.f ? lo2 : (al > 0.f ? hi2 : mixed_hi);
      return poison(has_nan(a), lo, hi);
    }
    case OP_FLOOR: return Ival{floorf(al), floorf(au)};
    case OP_CEIL: return Ival{ceilf(al), ceilf(au)};
    case OP_ROUND: return Ival{f_round(al), f_round(au)};
    case OP_SIN: return i_sin_cos(a, true);
    case OP_COS: return i_sin_cos(a, false);
    case OP_TAN: {
      // interval.rs:207-221
      float tl = tanf(al), tu = tanf(au);
      return poison((au - al >= F32PI) || !(tu >= tl), tl, tu);
    }
    case OP_ASIN:
      return poison(al < -1.f || au > 1.f, asinf(al), asinf(au));
    case OP_ACOS:
      return poison(al < -1.f || au > 1.f, acosf(au), acosf(al));
    case OP_ATAN: return Ival{atanf(al), atanf(au)};
    case OP_EXP: return Ival{expf(al), expf(au)};
    case OP_LN: return poison(!(al > 0.f), logf(al), logf(au));
    case OP_NOT: {
      // vm/mod.rs:400-408
      bool no_zero = !(al <= 0.f && au >= 0.f) && !has_nan(a);
      bool exactly_zero = al == 0.f && au == 0.f;
      float lo = exactly_zero ? 1.f : 0.f;
      float hi = exactly_zero ? 1.f : (no_zero ? 0.f : 1.f);
      return Ival{lo, hi};
    }
    default: return a;
  }
}

__device__ __forceinline__ float rmin4(float a, float b, float c, float d) {
  return fminf(fminf(fminf(a, b), c), d);
}
__device__ __forceinline__ float rmax4(float a, float b, float c, float d) {
  return fmaxf(fmaxf(fmaxf(a, b), c), d);
}

// non-choice binary ops
__device__ __forceinline__ Ival i_binary(int op, Ival a, Ival b) {
  float al = a.lo, au = a.hi, bl = b.lo, bu = b.hi;
  bool nan = has_nan(a) || has_nan(b);
  switch (op) {
    case OP_ADD: return Ival{al + bl, au + bu};
    case OP_SUB: return Ival{al - bu, au - bl};
    case OP_MUL: {
      float p0 = al * bl, p1 = al * bu, p2 = au * bl, p3 = au * bu;
      return poison(nan, rmin4(p0, p1, p2, p3), rmax4(p0, p1, p2, p3));
    }
    case OP_DIV: {
      bool ok = bl > 0.f || bu < 0.f;
      float q0 = al / bl, q1 = al / bu, q2 = au / bl, q3 = au / bu;
      return poison(!ok || nan, rmin4(q0, q1, q2, q3), rmax4(q0, q1, q2, q3));
    }
    case OP_ATAN2: {
      // interval.rs:488-553: branch cut check, else corner extremes
      float c0 = atan2f(al, bl), c1 = atan2f(al, bu);
      float c2 = atan2f(au, bl), c3 = atan2f(au, bu);
      float lo = rmin4(c0, c1, c2, c3), hi = rmax4(c0, c1, c2, c3);
      if (al <= 0.f && au >= 0.f && bl < 0.f) {
        lo = -F32PI;
        hi = F32PI;
      }
      return poison(nan, lo, hi);
    }
    case OP_COMPARE: {
      // vm/mod.rs:488-521
      bool lt = au < bl, gt = al > bu;
      return poison(nan, (gt && !lt) ? 1.f : -1.f, lt ? -1.f : 1.f);
    }
    case OP_MOD: {
      // interval.rs:448-466 (rem_euclid)
      float abs_hi = nmax(fabsf(bl), fabsf(bu));
      float qa = al / bl, qb = au / bl;
      bool const_pos = bl == bu && bl > 0.f;
      bool same_floor = qa != floorf(qa) && floorf(qa) == floorf(qb);
      bool use_exact = const_pos && same_floor;
      float lo = use_exact ? f_mod(al, bl) : 0.f;
      float hi = use_exact ? f_mod(au, bl) : abs_hi;
      return poison(nan || (bl <= 0.f && bu >= 0.f), lo, hi);
    }
    default: return a;
  }
}

// choice ops (interval.rs:295-381): value and 2-bit choice code
__device__ __forceinline__ Ival i_choice(int op, Ival a, Ival b, int* code) {
  float al = a.lo, au = a.hi, bl = b.lo, bu = b.hi;
  bool nan = has_nan(a) || has_nan(b);
  float lo, hi;
  int c;
  if (op == OP_MIN || op == OP_MAX) {
    bool left, right;
    if (op == OP_MIN) {
      left = au < bl;
      right = bu < al;
      lo = nmin(al, bl);
      hi = nmin(au, bu);
    } else {
      left = al > bu;
      right = bl > au;
      lo = nmax(al, bl);
      hi = nmax(au, bu);
    }
    c = left ? CHOICE_LEFT : (right ? CHOICE_RIGHT : CHOICE_BOTH);
  } else {
    bool zero = al == 0.f && au == 0.f;
    bool nonzero = !(al <= 0.f && au >= 0.f);
    if (op == OP_AND) {
      // an unambiguous 0 in lhs selects itself; no 0 selects rhs
      lo = zero ? 0.f : (nonzero ? bl : nmin(bl, 0.f));
      hi = zero ? 0.f : (nonzero ? bu : nmax(bu, 0.f));
      c = zero ? CHOICE_LEFT : (nonzero ? CHOICE_RIGHT : CHOICE_BOTH);
    } else {
      lo = nonzero ? al : (zero ? bl : nmin(al, bl));
      hi = nonzero ? au : (zero ? bu : nmax(au, bu));
      c = nonzero ? CHOICE_LEFT : (zero ? CHOICE_RIGHT : CHOICE_BOTH);
    }
  }
  *code = nan ? CHOICE_BOTH : c;
  return poison(nan, lo, hi);
}

// ---------------------------------------------------------------------
// grad mode (GradMode): forward duals (v, dx, dy, dz)

struct Dual {
  float v, dx, dy, dz;
};

__device__ __forceinline__ Dual d_scale(float f, Dual a, float s) {
  return Dual{f, a.dx * s, a.dy * s, a.dz * s};
}

__device__ __forceinline__ Dual d_const(float f) {
  return Dual{f, 0.f, 0.f, 0.f};
}

__device__ Dual g_unary(int op, Dual a) {
  const float v = a.v;
  switch (op) {
    case OP_NEG: return Dual{-v, -a.dx, -a.dy, -a.dz};
    case OP_ABS: return v < 0.f ? Dual{-v, -a.dx, -a.dy, -a.dz} : a;
    case OP_RECIP: return d_scale(1.0f / v, a, -1.0f / (v * v));
    case OP_SQRT: {
      float r = sqrtf(v);
      return d_scale(r, a, 0.5f / r);
    }
    case OP_SQUARE: return d_scale(v * v, a, 2.0f * v);
    case OP_FLOOR: case OP_CEIL: case OP_ROUND: case OP_NOT:
      return d_const(f_unary(op, v));
    case OP_SIN: return d_scale(sinf(v), a, cosf(v));
    case OP_COS: return d_scale(cosf(v), a, -sinf(v));
    case OP_TAN: {
      float c = cosf(v);
      return d_scale(tanf(v), a, 1.0f / (c * c));
    }
    case OP_ASIN: return d_scale(asinf(v), a, 1.0f / sqrtf(1.0f - v * v));
    case OP_ACOS: return d_scale(acosf(v), a, -1.0f / sqrtf(1.0f - v * v));
    case OP_ATAN: return d_scale(atanf(v), a, 1.0f / (v * v + 1.0f));
    case OP_EXP: {
      float e = expf(v);
      return d_scale(e, a, e);
    }
    case OP_LN: return d_scale(logf(v), a, 1.0f / v);
    default: return a;
  }
}

// every binary op, choice ops included: MIN/MAX/AND/OR pick a whole
// dual by strict comparison of the values (grad.rs:169), not by the
// NaN rules of float mode
__device__ Dual g_binary(int op, Dual a, Dual b) {
  switch (op) {
    case OP_ADD: return Dual{a.v + b.v, a.dx + b.dx, a.dy + b.dy, a.dz + b.dz};
    case OP_SUB: return Dual{a.v - b.v, a.dx - b.dx, a.dy - b.dy, a.dz - b.dz};
    case OP_MUL:
      return Dual{a.v * b.v, a.v * b.dx + b.v * a.dx, a.v * b.dy + b.v * a.dy,
                  a.v * b.dz + b.v * a.dz};
    case OP_DIV: case OP_ATAN2: {
      float v = op == OP_DIV ? a.v / b.v : atan2f(a.v, b.v);
      float d = op == OP_DIV ? b.v * b.v : a.v * a.v + b.v * b.v;
      return Dual{v, (b.v * a.dx - a.v * b.dx) / d,
                  (b.v * a.dy - a.v * b.dy) / d, (b.v * a.dz - a.v * b.dz) / d};
    }
    case OP_COMPARE: return d_const(f_binary(OP_COMPARE, a.v, b.v));
    case OP_MOD: {
      // grad.rs:186-196: d = da - db * div_euclid(a, b)
      float q = truncf(a.v / b.v);
      float r = fmodf(a.v, b.v);
      float e = r < 0.f ? (b.v > 0.f ? q - 1.0f : q + 1.0f) : q;
      return Dual{f_mod(a.v, b.v), a.dx - b.dx * e, a.dy - b.dy * e,
                  a.dz - b.dz * e};
    }
    case OP_MIN: return a.v < b.v ? a : b;
    case OP_MAX: return a.v > b.v ? a : b;
    case OP_AND: return a.v == 0.f ? a : b;
    case OP_OR: return a.v != 0.f ? a : b;
    default: return a;
  }
}

}  // namespace fidget

// Launch helper shared by the sources: dynamic shared memory above
// 48 KB needs the opt-in attribute.
#define FIDGET_SET_SMEM(kernel, bytes)                                     \
  do {                                                                     \
    if ((bytes) > 48 * 1024) {                                             \
      cudaError_t e_ = cudaFuncSetAttribute(                               \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (bytes));   \
      if (e_ != cudaSuccess) return (int)e_;                               \
    }                                                                      \
  } while (0)
