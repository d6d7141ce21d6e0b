// The float-mode row loop shared by interp_float.cu (K3) and
// interp_float_coded.cu (K6): a thread owns R = 4 (2, 1) neighbouring
// lanes, and a block walks rows already decoded into a `TapeRing`
// buffer (ops.cuh `stage_row`), one 16-byte broadcast row and its
// immediate at a time.
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

// an operand: the thread's R lanes of a register, or the immediate
template <int R>
__device__ __forceinline__ Pack<R> operand(const unsigned char* regs, int off,
                                           float iv) {
  if (off >= 0) return *reinterpret_cast<const Pack<R>*>(regs + off);
  return splat<R>(iv);
}

#define FIDGET_UNARY(OP)                                       \
  case OP:                                                     \
    _Pragma("unroll") for (int i = 0; i < R; ++i) r.v[i] =     \
        f_unary(OP, va.v[i]);                                  \
    break;
#define FIDGET_BINARY(OP)                                      \
  case OP:                                                     \
    _Pragma("unroll") for (int i = 0; i < R; ++i) r.v[i] =     \
        f_binary(OP, va.v[i], vb.v[i]);                        \
    break;

// One tape row on the thread's R lanes: both operand loads first, then
// one flat switch with a constant opcode per case.
template <int R>
__device__ __forceinline__ void run_row(const Row cur, const float iv,
                                        unsigned char* regs,
                                        const float* tvars, float* tout,
                                        int lanes) {
  const Pack<R> va = operand<R>(regs, cur.a, iv);
  const Pack<R> vb = operand<R>(regs, cur.b, iv);
  const int pay = cur.op_pay >> 8;
  Pack<R> r;
  switch (cur.op_pay & 0xFF) {
    case OP_OUTPUT:
      *reinterpret_cast<Pack<R>*>(tout + (size_t)pay * lanes) = va;
      r = va;
      break;
    case OP_INPUT:
      r = *reinterpret_cast<const Pack<R>*>(tvars + (size_t)pay * lanes);
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
  *reinterpret_cast<Pack<R>*>(regs + cur.out) = r;
}

#undef FIDGET_UNARY
#undef FIDGET_BINARY

// Rows [0, count) of one decoded buffer, two a turn, each loaded while
// the other runs, into registers of its own: a single loop-carried row
// would be copied at the top of the loop and wait there for the load
// just started. The slot past `count` is read and never run.
template <int R>
__device__ __forceinline__ void run_rows(const Row* rows, const float* imms,
                                         int count, unsigned char* regs,
                                         const float* tvars, float* tout,
                                         int lanes) {
  Row row_a = rows[0];
  float imm_a = imms[0];
  for (int k = 0; k < count; k += 2) {
    const Row row_b = rows[k + 1];
    const float imm_b = imms[k + 1];
    run_row<R>(row_a, imm_a, regs, tvars, tout, lanes);
    if (k + 1 >= count) break;
    row_a = rows[k + 2];
    imm_a = imms[k + 2];
    run_row<R>(row_b, imm_b, regs, tvars, tout, lanes);
  }
}

}  // namespace fidget
