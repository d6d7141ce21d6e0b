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
// (fidget_tpu_torch/eval/arith.py), op for op, in ops.cuh. `order`,
// when not null, is the position -> canonical opcode table of a
// renumbered arena.
//
// What bounds it on an H100. The normals pass hands it 32 instances of
// 8,192 lanes and the 28-row gyroid tape. One thread per lane decoding
// every row from device memory, with four register files at the
// bucket's nf 64 (128 KB a block, so in a global scratch: 8 operand
// loads and 4 stores a row a lane through L2), took 0.059 ms against a
// 0.005 ms byte bound. The design is K3's, a value four planes wide:
//   - rows are staged and decoded once per block through the ring
//     (ops.cuh `TapeRing`) and run by float_rows.cuh's row loop in its
//     grad mode (`Duals`), the opcode through the order table;
//   - a thread owns R neighbouring lanes (`launch_geometry` picks R
//     from GRAD_LANES in eval/cuda.py: on the normals pass R = 2 took
//     0.0207 ms of device time, R = 1 0.0241 and R = 4 0.0277 on an
//     H100); each plane of an operand moves as one R-wide vector;
//   - the four register files are [4][nf][BLOCK * R] floats of shared
//     memory at the nf the caller names (the tape's 6 registers on the
//     3D path: 24 KB a block at R = 2), or a global scratch
//     [t][plane][reg][lane] where not even one lane a thread fits.
// What bounds it now: a row moves four planes through shared memory
// (two operands read, one result written), four times K3's bytes, and
// the pass is short (28 rows): the ring's fetch and the input loads
// are a large part of it.

#include <cuda_runtime.h>

#include "float_rows.cuh"

using namespace fidget;

namespace {

template <int R, bool SHARED>
__global__ void __launch_bounds__(BLOCK) interp_grad_kernel(
    const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
    const float* __restrict__ imm, const int32_t* __restrict__ lengths,
    const float* __restrict__ vars, float* __restrict__ out,
    float* __restrict__ scratch, const int32_t* __restrict__ order, int L,
    int nf, int V, int O, int lanes, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int lane = (blockIdx.y * BLOCK + threadIdx.x) * R;
  const float* tvars = vars + (size_t)t * V * 4 * lanes + lane;
  float* tout = out + (size_t)t * O * 4 * lanes + lane;

  for (int o = 0; o < O; ++o) Duals<R>{}.clear(tout, o, lanes);
  const int n = min(lengths[t], L);
  if (n <= 0) return;  // uniform across the block: a culled instance

  const TapeRing ring{smem, chunk};
  // register r of plane k at regs + k * pstride + r * stride
  unsigned char* regs;
  int stride, pstride;
  if (SHARED) {
    regs = ring.end() + threadIdx.x * (R * 4);
    stride = BLOCK * R * 4;
  } else {
    regs = reinterpret_cast<unsigned char*>(
        scratch + (size_t)t * 4 * nf * lanes + lane);
    stride = lanes * 4;
  }
  pstride = nf * stride;
  const Duals<R> mode{pstride};
  StoreOutput<Duals<R>> sink{tout, lanes};
  run_tape(mode, sink, ring, Staging{order, nf, stride, V, O},
           w1 + (size_t)t * L, w2 + (size_t)t * L, imm + (size_t)t * L, n,
           regs, tvars, lanes);
}

}  // namespace

// `r` lanes a thread (1, 2 or 4; lanes a multiple of BLOCK * r), `chunk`
// tape rows a ring buffer, `smem_bytes` of dynamic shared memory: the
// ring, then the four register files unless `scratch` ([T, 4, nf,
// lanes] floats) is given.
extern "C" int fidget_interp_grad(
    const int32_t* w1, const int32_t* w2, const float* imm,
    const int32_t* lengths, const float* vars, float* out, float* scratch,
    const int32_t* order, int T, int L, int nf, int V, int O, int lanes, int r,
    int chunk, int smem_bytes, cudaStream_t stream) {
  if (T <= 0 || lanes <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || (r != 1 && r != 2 && r != 4) || lanes % (BLOCK * r) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      tape_ring_bytes(chunk) +
      (scratch ? 0 : (size_t)4 * nf * BLOCK * r * sizeof(float));
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  auto kernel = interp_grad_kernel<1, true>;
  if (scratch == nullptr) {
    if (r == 2) kernel = interp_grad_kernel<2, true>;
    if (r == 4) kernel = interp_grad_kernel<4, true>;
  } else {
    kernel = interp_grad_kernel<1, false>;
    if (r == 2) kernel = interp_grad_kernel<2, false>;
    if (r == 4) kernel = interp_grad_kernel<4, false>;
  }
  FIDGET_SET_SMEM(kernel, smem_bytes);
  dim3 grid(T, lanes / (BLOCK * r));
  kernel<<<grid, BLOCK, smem_bytes, stream>>>(
      w1, w2, imm, lengths, vars, out, scratch, order, L, nf, V, O, lanes,
      chunk);
  return (int)cudaGetLastError();
}
