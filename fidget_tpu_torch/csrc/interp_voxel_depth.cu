// Voxel-depth tape interpreter: float evaluation over one subtile's
// voxels fused with the per-column depth reduction.
//
// Replaces the TPU kernel fidget_tpu/eval/pallas_interp.py
// `_interp_voxel_depth_impl` (pallas_call at :453), the voxel pass of
// the 3D renderer. Semantics: instance t is one sub^3 subtile whose
// lanes are its voxels in (vz, vy, vx) row-major order (vars is
// [T, V, sub^3]); it walks its tape for min(lengths[t], L) steps, and
// the distance of a voxel is the `a` operand of the tape's last OUTPUT
// (+1.0 when the tape has none, so a culled length-0 subtile is empty).
// Output is int32 [T, pp_out, 128]: column c = vy * sub + vx sits at
// plane c / 128, lane c % 128, and holds max over vz of
// (distance < 0 ? vz + 1 : 0) (the "deepest interior voxel" rule of
// fidget-raster/src/voxel.rs:443-445); a NaN distance is not inside.
// Planes past sub^2 / 128 (padding up to pp_out) are 0.
//
// Design. One thread per (vy, vx) column, 128 columns per block, grid
// (instance, column plane). A thread walks the tape once per vz, from
// the nearest-to-origin slice up, and keeps its column's depth in a
// register, so the reduction over vz needs no shared memory and no
// second pass; the lane-steps are those of one walk per voxel, as in
// the float kernel. The register file ([nf][BLOCK] floats) sits in
// dynamic shared memory when that fits SMEM_LIMIT (eval/cuda.py), else
// in a global scratch [t][reg][column]; it is reused by the sub walks of a column.
// The TPU kernel's tiles_per_step batching amortized a per-grid-step
// cost the card does not have and is dropped.
// What bounds it: the dependent chain of register-file reads, one op
// and a write per tape step, as in interp_float.cu; the output is one
// int per column, 16x less than the distance volume.

#include <cuda_runtime.h>

#include "ops.cuh"

using namespace fidget;

__global__ void __launch_bounds__(BLOCK) interp_voxel_depth_kernel(
    const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
    const float* __restrict__ imm, const int32_t* __restrict__ lengths,
    const float* __restrict__ vars, int32_t* __restrict__ out,
    float* __restrict__ scratch, int L, int nf, int V, int sub,
    int pp_out) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int plane = blockIdx.y;
  const int cols = sub * sub;
  int32_t* tout = out + ((size_t)t * pp_out + plane) * BLOCK + threadIdx.x;
  if (plane * BLOCK >= cols) {  // padding plane
    *tout = 0;
    return;
  }
  const int col = plane * BLOCK + threadIdx.x;
  const size_t lanes = (size_t)cols * sub;

  float* regs;
  size_t stride;
  if (scratch != nullptr) {
    regs = scratch + (size_t)t * nf * cols + col;
    stride = cols;
  } else {
    regs = smem + threadIdx.x;
    stride = BLOCK;
  }
  const int32_t* tw1 = w1 + (size_t)t * L;
  const int32_t* tw2 = w2 + (size_t)t * L;
  const float* timm = imm + (size_t)t * L;
  const float* tvars = vars + (size_t)t * V * lanes + col;

  const int n = min(lengths[t], L);
  int depth = 0;
  for (int vz = 0; vz < sub; ++vz) {
    const float* zvars = tvars + (size_t)vz * cols;
    float dist = 1.0f;
    for (int j = 0; j < n; ++j) {
      const Word w = decode(tw1[j], tw2[j]);
      const float iv = timm[j];
      const float va = w.a == IMM12 ? iv : regs[(size_t)min(w.a, nf - 1) * stride];
      const float vb = w.b == IMM12 ? iv : regs[(size_t)min(w.b, nf - 1) * stride];
      float r;
      switch (w.op) {
        case OP_OUTPUT:
          dist = va;
          r = va;
          break;
        case OP_INPUT:
          r = zvars[(size_t)min(w.aux, V - 1) * lanes];
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
    // vz only grows, so the last inside slice is the max over vz
    if (dist < 0.f) depth = vz + 1;
  }
  *tout = depth;
}

extern "C" int fidget_interp_voxel_depth(
    const int32_t* w1, const int32_t* w2, const float* imm,
    const int32_t* lengths, const float* vars, int32_t* out, float* scratch,
    int T, int L, int nf, int V, int sub, int pp_out, cudaStream_t stream) {
  if (T <= 0) return (int)cudaSuccess;
  if ((sub * sub) % BLOCK != 0 || pp_out * BLOCK < sub * sub)
    return (int)cudaErrorInvalidValue;
  size_t smem = scratch ? 0 : (size_t)nf * BLOCK * sizeof(float);
  FIDGET_SET_SMEM(interp_voxel_depth_kernel, (int)smem);
  dim3 grid(T, pp_out);
  interp_voxel_depth_kernel<<<grid, BLOCK, smem, stream>>>(
      w1, w2, imm, lengths, vars, out, scratch, L, nf, V, sub, pp_out);
  return (int)cudaGetLastError();
}
