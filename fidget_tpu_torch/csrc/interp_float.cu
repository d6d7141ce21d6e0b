// Float-mode tape interpreter: one packed tape per instance, evaluated
// over that instance's lanes.
//
// Replaces the TPU kernel fidget_tpu/eval/pallas_interp.py
// `_interp_float_impl` (pallas_call at :228), the leaf pass of the 2D
// frame. Semantics: each instance t walks its own tape for
// min(lengths[t], L) steps; OUTPUT writes its `a` operand to
// out[t, min(aux, O-1)]; INPUT reads vars[t, min(aux, V-1)]; register
// reads clamp to nf - 1. Outputs not written by the tape (all of them
// for a length-0 instance, i.e. a culled tile) are 0.
//
// Design. One thread per lane, grid (instance, lane block). All threads
// of a block share a tape, so tape words are warp-uniform loads and the
// opcode switch does not diverge. The register file is indexed by tape
// operands, so it cannot live in thread registers: it sits in dynamic
// shared memory as [nf][BLOCK] when that fits SMEM_LIMIT, else in a
// global scratch laid out [t][reg][lane] (coalesced across the warp).
// What bounds it: each step is a dependent chain (two register-file
// reads, one op, one write) repeated over the tape, so a thread's time
// is tape length times that latency; the leaf pass hides it with many
// resident blocks (one per 128 lanes of every active tile). Bytes moved
// (tape words, inputs, one output plane) are small beside that.

#include <cuda_runtime.h>

#include "ops.cuh"

using namespace fidget;

__global__ void __launch_bounds__(BLOCK) interp_float_kernel(
    const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
    const float* __restrict__ imm, const int32_t* __restrict__ lengths,
    const float* __restrict__ vars, float* __restrict__ out,
    float* __restrict__ scratch, int L, int nf, int V, int O, int lanes) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int lane = blockIdx.y * BLOCK + threadIdx.x;
  if (lane >= lanes) return;

  float* regs;
  size_t stride;
  if (scratch != nullptr) {
    regs = scratch + (size_t)t * nf * lanes + lane;
    stride = lanes;
  } else {
    regs = smem + threadIdx.x;
    stride = BLOCK;
  }
  const int32_t* tw1 = w1 + (size_t)t * L;
  const int32_t* tw2 = w2 + (size_t)t * L;
  const float* timm = imm + (size_t)t * L;
  const float* tvars = vars + (size_t)t * V * lanes + lane;
  float* tout = out + (size_t)t * O * lanes + lane;

  for (int o = 0; o < O; ++o) tout[(size_t)o * lanes] = 0.f;
  const int n = min(lengths[t], L);
  for (int j = 0; j < n; ++j) {
    const Word w = decode(tw1[j], tw2[j]);
    const float iv = timm[j];
    const float va = w.a == IMM12 ? iv : regs[(size_t)min(w.a, nf - 1) * stride];
    const float vb = w.b == IMM12 ? iv : regs[(size_t)min(w.b, nf - 1) * stride];
    float r;
    switch (w.op) {
      case OP_OUTPUT:
        tout[(size_t)min(w.aux, O - 1) * lanes] = va;
        r = va;
        break;
      case OP_INPUT:
        r = tvars[(size_t)min(w.aux, V - 1) * lanes];
        break;
      case OP_COPY:
        r = va;
        break;
      case OP_NEG: case OP_ABS: case OP_RECIP: case OP_SQRT:
      case OP_SQUARE: case OP_FLOOR: case OP_CEIL: case OP_ROUND:
      case OP_SIN: case OP_COS: case OP_TAN: case OP_ASIN: case OP_ACOS:
      case OP_ATAN: case OP_EXP: case OP_LN: case OP_NOT:
        r = f_unary(w.op, va);
        break;
      default:
        r = f_binary(w.op, va, vb);
        break;
    }
    regs[(size_t)min(w.out, nf - 1) * stride] = r;
  }
}

extern "C" int fidget_interp_float(
    const int32_t* w1, const int32_t* w2, const float* imm,
    const int32_t* lengths, const float* vars, float* out, float* scratch,
    int T, int L, int nf, int V, int O, int lanes, cudaStream_t stream) {
  if (T <= 0 || lanes <= 0) return (int)cudaSuccess;
  size_t smem = scratch ? 0 : (size_t)nf * BLOCK * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  FIDGET_SET_SMEM(interp_float_kernel, (int)smem);
  dim3 grid(T, (lanes + BLOCK - 1) / BLOCK);
  interp_float_kernel<<<grid, BLOCK, smem, stream>>>(
      w1, w2, imm, lengths, vars, out, scratch, L, nf, V, O, lanes);
  return (int)cudaGetLastError();
}
