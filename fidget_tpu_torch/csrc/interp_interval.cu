// Interval-mode tape interpreter with 2-bit choice capture.
//
// Replaces the TPU kernel fidget_tpu/eval/pallas_interp.py
// `_interp_interval_impl` (pallas_call at :715), the root pass of the
// 2D frame (lanes = root tiles). Semantics: as the float kernel, over
// (lo, hi) pairs; each MIN/MAX/AND/OR ORs its choice code into word
// min(aux / 16, CW - 1) of its lane at bit (aux % 16) * 2, so indices
// past 16 * CW fold into the last word (over-approximate, never wrong).
// Outputs not written by the tape are 0. `order`, when not null, is the
// position -> canonical opcode table of a renumbered arena (ops.cuh
// `decode`).
//
// Design. One thread per lane, grid (instance, lane block), tape words
// warp-uniform. Two register files (lo, hi), each [nf][BLOCK] in
// dynamic shared memory when both fit SMEM_LIMIT, else a global scratch
// [2][t][reg][lane]. Each lane is evaluated on its own, so any split of
// the lanes gives the same words (the chunk-equality property the TPU
// wrapper's s0 split was pinned by). Choice words are read-modify-
// written in device memory, coalesced across the warp. What bounds it:
// the serial chain over the tape, per thread; the root pass has only
// S0 * 128 lanes, so few blocks are in flight and latency dominates.

#include <cuda_runtime.h>

#include "ops.cuh"

using namespace fidget;

template <bool ORDERED>
__global__ void __launch_bounds__(BLOCK) interp_interval_kernel(
    const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
    const float* __restrict__ imm, const int32_t* __restrict__ lengths,
    const float* __restrict__ var_lo, const float* __restrict__ var_hi,
    float* __restrict__ out_lo, float* __restrict__ out_hi,
    int32_t* __restrict__ choices, float* __restrict__ scratch,
    const int32_t* __restrict__ order, int T, int L, int nf, int V, int O,
    int CW, int lanes) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int lane = blockIdx.y * BLOCK + threadIdx.x;
  if (lane >= lanes) return;

  float *rlo, *rhi;
  size_t stride;
  if (scratch != nullptr) {
    rlo = scratch + (size_t)t * nf * lanes + lane;
    rhi = rlo + (size_t)T * nf * lanes;
    stride = lanes;
  } else {
    rlo = smem + threadIdx.x;
    rhi = rlo + (size_t)nf * BLOCK;
    stride = BLOCK;
  }
  const int32_t* tw1 = w1 + (size_t)t * L;
  const int32_t* tw2 = w2 + (size_t)t * L;
  const float* timm = imm + (size_t)t * L;
  const size_t vbase = (size_t)t * V * lanes + lane;
  const size_t obase = (size_t)t * O * lanes + lane;
  int32_t* tch = choices + (size_t)t * CW * lanes + lane;

  for (int o = 0; o < O; ++o) {
    out_lo[obase + (size_t)o * lanes] = 0.f;
    out_hi[obase + (size_t)o * lanes] = 0.f;
  }
  for (int c = 0; c < CW; ++c) tch[(size_t)c * lanes] = 0;

  const int n = min(lengths[t], L);
  for (int j = 0; j < n; ++j) {
    const Word w = decode<ORDERED>(tw1[j], tw2[j], order);
    const float iv = timm[j];
    const size_t ia = (size_t)min(w.a, nf - 1) * stride;
    const size_t ib = (size_t)min(w.b, nf - 1) * stride;
    const Ival va = w.a == IMM12 ? Ival{iv, iv} : Ival{rlo[ia], rhi[ia]};
    const Ival vb = w.b == IMM12 ? Ival{iv, iv} : Ival{rlo[ib], rhi[ib]};
    Ival r;
    switch (w.op) {
      case OP_OUTPUT: {
        const size_t o = obase + (size_t)min(w.aux, O - 1) * lanes;
        out_lo[o] = va.lo;
        out_hi[o] = va.hi;
        r = va;
        break;
      }
      case OP_INPUT: {
        const size_t i = vbase + (size_t)min(w.aux, V - 1) * lanes;
        r = Ival{var_lo[i], var_hi[i]};
        break;
      }
      case OP_COPY:
        r = va;
        break;
      case OP_MIN: case OP_MAX: case OP_AND: case OP_OR: {
        int code;
        r = i_choice(w.op, va, vb, &code);
        int32_t* word = tch + (size_t)min(w.aux >> 4, CW - 1) * lanes;
        *word = (int32_t)((uint32_t)*word | ((uint32_t)code << ((w.aux & 15) * 2)));
        break;
      }
      case OP_NEG: case OP_ABS: case OP_RECIP: case OP_SQRT:
      case OP_SQUARE: case OP_FLOOR: case OP_CEIL: case OP_ROUND:
      case OP_SIN: case OP_COS: case OP_TAN: case OP_ASIN: case OP_ACOS:
      case OP_ATAN: case OP_EXP: case OP_LN: case OP_NOT:
        r = i_unary(w.op, va);
        break;
      default:
        r = i_binary(w.op, va, vb);
        break;
    }
    const size_t io = (size_t)min(w.out, nf - 1) * stride;
    rlo[io] = r.lo;
    rhi[io] = r.hi;
  }
}

extern "C" int fidget_interp_interval(
    const int32_t* w1, const int32_t* w2, const float* imm,
    const int32_t* lengths, const float* var_lo, const float* var_hi,
    float* out_lo, float* out_hi, int32_t* choices, float* scratch,
    const int32_t* order, int T, int L, int nf, int V, int O, int CW,
    int lanes, cudaStream_t stream) {
  if (T <= 0 || lanes <= 0) return (int)cudaSuccess;
  size_t smem = scratch ? 0 : (size_t)2 * nf * BLOCK * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  dim3 grid(T, (lanes + BLOCK - 1) / BLOCK);
  if (order != nullptr) {
    FIDGET_SET_SMEM(interp_interval_kernel<true>, (int)smem);
    interp_interval_kernel<true><<<grid, BLOCK, smem, stream>>>(
        w1, w2, imm, lengths, var_lo, var_hi, out_lo, out_hi, choices,
        scratch, order, T, L, nf, V, O, CW, lanes);
  } else {
    FIDGET_SET_SMEM(interp_interval_kernel<false>, (int)smem);
    interp_interval_kernel<false><<<grid, BLOCK, smem, stream>>>(
        w1, w2, imm, lengths, var_lo, var_hi, out_lo, out_hi, choices,
        scratch, order, T, L, nf, V, O, CW, lanes);
  }
  return (int)cudaGetLastError();
}
