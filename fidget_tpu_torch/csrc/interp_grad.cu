// Grad-mode tape interpreter: forward-mode duals of P planes (the value
// v and the first P - 1 of the tangents dx, dy, dz; P = 2, 3 or 4), one
// packed tape per instance, evaluated over that instance's lanes.
//
// Replaces the TPU kernel fidget_tpu/eval/pallas_interp.py `interp_grad`
// (pallas_call at :897), the normals pass of the 3D renderer; it also
// computes the Jacobian of the fitting step and of every
// differentiable frame (eval/interp.py `_FloatJacobian`).
// Semantics: vars is [T, V, P, lanes] and out [T, O, P, lanes]; each
// instance t walks its own tape for min(lengths[t], L) steps; an IMM12
// operand reads as (imm, 0, ...); OUTPUT writes the P planes of its `a`
// operand to out[t, min(aux, O-1)]; INPUT reads the P planes of
// vars[t, min(aux, V-1)]; register reads and writes clamp to nf - 1.
// Outputs the tape does not write are 0. The arithmetic is GradMode's
// (fidget_tpu_torch/eval/arith.py), op for op, in ops.cuh: plane k of
// a P-plane run is the same float as plane k of the four-plane run.
// `order`, when not null, is the position -> canonical opcode table of
// a renumbered arena.
//
// What bounds it on an H100. The normals pass hands it 32 instances of
// 8,192 lanes and the 28-row gyroid tape. One thread per lane decoding
// every row from device memory, with four register files at the
// bucket's nf 64 (128 KB a block, so in a global scratch: 8 operand
// loads and 4 stores a row a lane through L2), took 0.059 ms against a
// 0.005 ms byte bound. The design is K3's, a value P planes wide:
//   - rows are staged and decoded once per block through the ring
//     (ops.cuh `TapeRing`) and run by float_rows.cuh's row loop in its
//     grad mode (`Duals<R, P>`), the opcode through the order table;
//   - a thread owns R neighbouring lanes (`launch_geometry` picks R
//     from GRAD_LANES in eval/cuda.py: on the normals pass R = 2 took
//     0.0207 ms of device time, R = 1 0.0241 and R = 4 0.0277 on an
//     H100, so R = 4 is not built); each plane of an operand moves as
//     one R-wide vector;
//   - the P register files are [P][nf][BLOCK * R] floats of shared
//     memory at the nf the caller names (the tape's 6 registers on the
//     3D path: 24 KB a block at R = 2 and P = 4), or a global scratch
//     [t][plane][reg][lane] where not even one lane a thread fits, at
//     four planes only: a slow path, built once rather than at each P;
//   - P is the caller's: the 3D normals, the bulk evaluator and the
//     solver seed three tangents (P = 4), the fit's Jacobian only the
//     inputs whose partials it keeps, so a plane nobody reads is never
//     loaded, computed or stored.
// What bounds it now. Every row reads two operands and writes one
// result, P planes each, through shared memory: 12 P bytes a lane a
// row. The fit's pass (7,207 rows over 2048^2 lanes, nf 14, P = 3)
// moves about 1.09 TB, some 33 ms at 128 B a clock on 132 SMs at
// 1,980 MHz, far above its HBM and FP32 bounds; its 56,368 B a block
// let four blocks share an SM, where three did at P = 4. It took
// 40.90 ms of device time on an H100 80GB HBM3 (700 W), against 62.39
// ms for the same tape at P = 4 and 32.15 at P = 2. On the short
// normals pass (28 rows) the ring's fetch and the input loads are a
// large part of it.

#include <cuda_runtime.h>

#include "float_rows.cuh"

using namespace fidget;

namespace {

template <int R, bool SHARED, int P>
__global__ void __launch_bounds__(BLOCK) interp_grad_kernel(
    const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
    const float* __restrict__ imm, const int32_t* __restrict__ lengths,
    const float* __restrict__ vars, float* __restrict__ out,
    float* __restrict__ scratch, const int32_t* __restrict__ order, int L,
    int nf, int V, int O, int lanes, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int lane = (blockIdx.y * BLOCK + threadIdx.x) * R;
  const float* tvars = vars + (size_t)t * V * P * lanes + lane;
  float* tout = out + (size_t)t * O * P * lanes + lane;

  for (int o = 0; o < O; ++o) Duals<R, P>{}.clear(tout, o, lanes);
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
        scratch + (size_t)t * P * nf * lanes + lane);
    stride = lanes * 4;
  }
  pstride = nf * stride;
  const Duals<R, P> mode{pstride};
  StoreOutput<Duals<R, P>> sink{tout, lanes};
  run_tape(mode, sink, ring, Staging{order, nf, stride, V, O},
           w1 + (size_t)t * L, w2 + (size_t)t * L, imm + (size_t)t * L, n,
           regs, tvars, lanes);
}

using Kernel = decltype(&interp_grad_kernel<1, true, 4>);

// the instance at r lanes a thread and P planes, its register files in
// shared memory, or in the global scratch at P = 4 alone (the wrapper
// runs a narrower dual there as four planes); else null
template <int P>
Kernel pick(int r, bool shared) {
  if (shared)
    return r == 2 ? interp_grad_kernel<2, true, P>
                  : interp_grad_kernel<1, true, P>;
  if constexpr (P == 4)
    return r == 2 ? interp_grad_kernel<2, false, 4>
                  : interp_grad_kernel<1, false, 4>;
  return nullptr;
}

}  // namespace

// `r` lanes a thread (1 or 2; lanes a multiple of BLOCK * r), `planes`
// planes a dual (2, 3 or 4: the value and 1-3 tangents), `chunk` tape
// rows a ring buffer, `smem_bytes` of dynamic shared memory: the ring,
// then the `planes` register files unless `scratch` ([T, 4, nf, lanes]
// floats, four planes only) is given.
extern "C" int fidget_interp_grad(
    const int32_t* w1, const int32_t* w2, const float* imm,
    const int32_t* lengths, const float* vars, float* out, float* scratch,
    const int32_t* order, int T, int L, int nf, int V, int O, int lanes, int r,
    int planes, int chunk, int smem_bytes, cudaStream_t stream) {
  if (T <= 0 || lanes <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || (r != 1 && r != 2) || lanes % (BLOCK * r) != 0 ||
      planes < 2 || planes > 4)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      tape_ring_bytes(chunk) +
      (scratch ? 0 : (size_t)planes * nf * BLOCK * r * sizeof(float));
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  const bool shared = scratch == nullptr;
  const Kernel kernel = planes == 2   ? pick<2>(r, shared)
                        : planes == 3 ? pick<3>(r, shared)
                                      : pick<4>(r, shared);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  FIDGET_SET_SMEM(kernel, smem_bytes);
  dim3 grid(T, lanes / (BLOCK * r));
  kernel<<<grid, BLOCK, smem_bytes, stream>>>(
      w1, w2, imm, lengths, vars, out, scratch, order, L, nf, V, O, lanes,
      chunk);
  return (int)cudaGetLastError();
}
