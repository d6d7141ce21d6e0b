// Grad-mode tape interpreter: forward-mode duals (v, dx, dy, dz), one
// packed tape per instance, evaluated over that instance's lanes.
//
// Replaces the TPU kernel fidget_tpu/eval/pallas_interp.py `interp_grad`
// (pallas_call at :897), the normals pass of the 3D renderer.
// Semantics: vars is [T, V, 4, lanes] and out [T, O, 4, lanes]; each
// instance t walks its own tape for min(lengths[t], L) steps; an IMM12
// operand reads as (imm, 0, 0, 0); OUTPUT writes all four planes of its
// `a` operand to out[t, min(aux, O-1)]; INPUT reads the four planes of
// vars[t, min(aux, V-1)]; register reads and writes clamp to nf - 1.
// Outputs the tape does not write are 0. The arithmetic is GradMode's
// (fidget_tpu_torch/eval/arith.py), op for op, in ops.cuh.
//
// Design. One thread per lane, grid (instance, lane block), as in
// interp_float.cu, with four register files instead of one. They take
// 4 * nf * BLOCK floats of dynamic shared memory when that fits
// SMEM_LIMIT of eval/cuda.py (nf <= 48), else a global scratch laid out
// [t][plane][reg][lane], coalesced across the warp; every register
// bucket of the renderers has nf >= 64, so the normals pass takes the
// global route. The TPU wrapper split the lanes (s0) to fit its VMEM
// budget; lanes are independent here, so no split is needed.
// What bounds it: like the float kernel, a dependent chain of register
// reads, one op and register writes per tape step, four planes wide;
// the normals pass has 32 instances x 8,192 lanes (2,048 blocks), enough
// to keep every SM busy on a short tape.

#include <cuda_runtime.h>

#include "ops.cuh"

using namespace fidget;

__global__ void __launch_bounds__(BLOCK) interp_grad_kernel(
    const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
    const float* __restrict__ imm, const int32_t* __restrict__ lengths,
    const float* __restrict__ vars, float* __restrict__ out,
    float* __restrict__ scratch, int L, int nf, int V, int O, int lanes) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int lane = blockIdx.y * BLOCK + threadIdx.x;
  if (lane >= lanes) return;

  // register r of plane k sits at regs[k * pstride + r * stride]
  float* regs;
  size_t stride, pstride;
  if (scratch != nullptr) {
    regs = scratch + (size_t)t * 4 * nf * lanes + lane;
    stride = lanes;
    pstride = (size_t)nf * lanes;
  } else {
    regs = smem + threadIdx.x;
    stride = BLOCK;
    pstride = (size_t)nf * BLOCK;
  }
  const int32_t* tw1 = w1 + (size_t)t * L;
  const int32_t* tw2 = w2 + (size_t)t * L;
  const float* timm = imm + (size_t)t * L;
  const float* tvars = vars + (size_t)t * V * 4 * lanes + lane;
  float* tout = out + (size_t)t * O * 4 * lanes + lane;

  for (int o = 0; o < O * 4; ++o) tout[(size_t)o * lanes] = 0.f;
  auto load = [&](int r, float iv) -> Dual {
    if (r == IMM12) return d_const(iv);
    float* p = regs + (size_t)min(r, nf - 1) * stride;
    return Dual{p[0], p[pstride], p[2 * pstride], p[3 * pstride]};
  };
  const int n = min(lengths[t], L);
  for (int j = 0; j < n; ++j) {
    const Word w = decode(tw1[j], tw2[j]);
    const float iv = timm[j];
    const Dual va = load(w.a, iv);
    const Dual vb = load(w.b, iv);
    Dual r;
    switch (w.op) {
      case OP_OUTPUT: {
        float* po = tout + (size_t)min(w.aux, O - 1) * 4 * lanes;
        po[0] = va.v;
        po[(size_t)lanes] = va.dx;
        po[(size_t)2 * lanes] = va.dy;
        po[(size_t)3 * lanes] = va.dz;
        r = va;
        break;
      }
      case OP_INPUT: {
        const float* pi = tvars + (size_t)min(w.aux, V - 1) * 4 * lanes;
        r = Dual{pi[0], pi[(size_t)lanes], pi[(size_t)2 * lanes],
                 pi[(size_t)3 * lanes]};
        break;
      }
      case OP_COPY:
        r = va;
        break;
      case OP_NEG: case OP_ABS: case OP_RECIP: case OP_SQRT:
      case OP_SQUARE: case OP_FLOOR: case OP_CEIL: case OP_ROUND:
      case OP_SIN: case OP_COS: case OP_TAN: case OP_ASIN: case OP_ACOS:
      case OP_ATAN: case OP_EXP: case OP_LN: case OP_NOT:
        r = g_unary(w.op, va);
        break;
      default:
        r = g_binary(w.op, va, vb);
        break;
    }
    float* p = regs + (size_t)min(w.out, nf - 1) * stride;
    p[0] = r.v;
    p[pstride] = r.dx;
    p[2 * pstride] = r.dy;
    p[3 * pstride] = r.dz;
  }
}

extern "C" int fidget_interp_grad(
    const int32_t* w1, const int32_t* w2, const float* imm,
    const int32_t* lengths, const float* vars, float* out, float* scratch,
    int T, int L, int nf, int V, int O, int lanes, cudaStream_t stream) {
  if (T <= 0 || lanes <= 0) return (int)cudaSuccess;
  size_t smem = scratch ? 0 : (size_t)4 * nf * BLOCK * sizeof(float);
  FIDGET_SET_SMEM(interp_grad_kernel, (int)smem);
  dim3 grid(T, (lanes + BLOCK - 1) / BLOCK);
  interp_grad_kernel<<<grid, BLOCK, smem, stream>>>(
      w1, w2, imm, lengths, vars, out, scratch, L, nf, V, O, lanes);
  return (int)cudaGetLastError();
}
