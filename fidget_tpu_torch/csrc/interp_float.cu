// Float-mode tape interpreter: one packed tape per instance, evaluated
// over that instance's lanes.
//
// Replaces the TPU kernel fidget_tpu/eval/pallas_interp.py
// `_interp_float_impl` (pallas_call at :228), the leaf pass of the 2D
// frame. Semantics: each instance t walks its own tape for
// min(lengths[t], L) steps; OUTPUT writes its `a` operand to
// out[t, min(aux, O-1)]; INPUT reads vars[t, min(aux, V-1)]; register
// reads and writes clamp to nf - 1. Outputs not written by the tape (all
// of them for a length-0 instance, i.e. a culled tile) are 0. `order`,
// when not null, is the position -> canonical opcode table of a
// renumbered arena.
//
// What bounds it on an H100. All threads of a block share a tape, so a
// tape row costs every warp the same fetch, decode, dispatch and
// register-file traffic whatever the op. With one lane a thread that
// was about 80 scheduler slots a row for one useful float operation per
// lane, and the schedulers were the bound (6.5 ms for the 2.03e9
// lane-rows of a 1024^2 leaf pass; NVIDIA H100 80GB HBM3, 700 W). The
// design spends those slots once for four times the lanes and takes
// most of them out of the loop:
//   - a thread owns R = 4 (2, 1) neighbouring lanes, so a warp-row
//     serves 128 lanes; values, register file, inputs and outputs move
//     as 16-byte vectors, neighbouring threads on neighbouring
//     addresses;
//   - the tape is staged through a ring in shared memory (ops.cuh
//     `TapeRing`): cp.async copies the next chunk while this one runs,
//     and each row is decoded once per block, to an opcode mapped
//     through the order table, byte offsets already clamped and scaled,
//     and a payload already clamped. The loop reads one 16-byte
//     broadcast word and the immediate, one row ahead of use;
//   - the register file is [nf][BLOCK * R] floats of shared memory
//     behind the ring (LDS/STS with 32-bit offsets), sized by the nf
//     the caller names; where no shared memory holds it, the SHARED =
//     false instance keeps it in a global scratch [t][reg][lane];
//   - one flat switch whose cases apply f_unary / f_binary with a
//     constant opcode to the R lanes (the compiler lowers it to a tree
//     of compares, not a jump table).
// What bounds it now is shared-memory bandwidth: two 16-byte operand
// loads, one store and the row word are 14 wavefronts a warp-row, and
// with the arithmetic taken out the same pass still takes 0.9 of its
// 1.3 ms. Handing the previous row's result on in registers instead of
// re-reading it was measured and is slower (more selects than it saves
// loads). Lanes per thread, chunk, shared-memory bytes and the route
// come from `launch_geometry` in fidget_tpu_torch/eval/cuda.py.

#include <cuda_runtime.h>

#include "ops.cuh"

using namespace fidget;

namespace {

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

template <int R, bool SHARED>
__global__ void __launch_bounds__(BLOCK) interp_float_kernel(
    const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
    const float* __restrict__ imm, const int32_t* __restrict__ lengths,
    const float* __restrict__ vars, float* __restrict__ out,
    float* __restrict__ scratch, const int32_t* __restrict__ order, int L,
    int nf, int V, int O, int lanes, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int lane = (blockIdx.y * BLOCK + threadIdx.x) * R;
  const float* tvars = vars + (size_t)t * V * lanes + lane;
  float* tout = out + (size_t)t * O * lanes + lane;

  for (int o = 0; o < O; ++o)
    *reinterpret_cast<Pack<R>*>(tout + (size_t)o * lanes) = splat<R>(0.f);
  const int n = min(lengths[t], L);
  if (n <= 0) return;  // uniform across the block: a culled instance

  const TapeRing ring{smem, chunk};
  unsigned char* regs;
  int stride;  // bytes from one register to the next
  if (SHARED) {
    regs = ring.end() + threadIdx.x * (R * 4);
    stride = BLOCK * R * 4;
  } else {
    regs = reinterpret_cast<unsigned char*>(scratch + (size_t)t * nf * lanes +
                                            lane);
    stride = lanes * 4;
  }
  const int32_t* tw1 = w1 + (size_t)t * L;
  const int32_t* tw2 = w2 + (size_t)t * L;
  const float* timm = imm + (size_t)t * L;

  ring.fetch(tw1, tw2, timm, 0, min(chunk, n));
  ring.decode(0, min(chunk, n), order, nf, stride, V, O, 0);
  __syncthreads();
  for (int j0 = 0, buf = 0; j0 < n; j0 += chunk, buf ^= 1) {
    const int count = min(chunk, n - j0);
    const int next = min(chunk, n - j0 - chunk);
    if (next > 0) ring.fetch(tw1, tw2, timm, j0 + chunk, next);
    const Row* rows = ring.rows(buf);
    const float* imms = ring.imms(buf);
    // Two rows a turn, each loaded while the other runs, into registers
    // of its own: a single loop-carried row would be copied at the top
    // of the loop and wait there for the load just started. The slot past
    // the chunk is read and never run.
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
    if (next > 0) ring.decode(buf ^ 1, next, order, nf, stride, V, O, 0);
    __syncthreads();
  }
}

}  // namespace

// `r` lanes a thread (1, 2 or 4; lanes a multiple of BLOCK * r), `chunk`
// tape rows a ring buffer, `smem_bytes` of dynamic shared memory: the
// ring, then the register file unless `scratch` is given.
extern "C" int fidget_interp_float(
    const int32_t* w1, const int32_t* w2, const float* imm,
    const int32_t* lengths, const float* vars, float* out, float* scratch,
    const int32_t* order, int T, int L, int nf, int V, int O, int lanes, int r,
    int chunk, int smem_bytes, cudaStream_t stream) {
  if (T <= 0 || lanes <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || (r != 1 && r != 2 && r != 4) || lanes % (BLOCK * r) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t need = tape_ring_bytes(chunk) +
                      (scratch ? 0 : (size_t)nf * BLOCK * r * sizeof(float));
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  auto kernel = interp_float_kernel<1, true>;
  if (scratch == nullptr) {
    if (r == 2) kernel = interp_float_kernel<2, true>;
    if (r == 4) kernel = interp_float_kernel<4, true>;
  } else {
    kernel = interp_float_kernel<1, false>;
    if (r == 2) kernel = interp_float_kernel<2, false>;
    if (r == 4) kernel = interp_float_kernel<4, false>;
  }
  FIDGET_SET_SMEM(kernel, smem_bytes);
  dim3 grid(T, lanes / (BLOCK * r));
  kernel<<<grid, BLOCK, smem_bytes, stream>>>(
      w1, w2, imm, lengths, vars, out, scratch, order, L, nf, V, O, lanes,
      chunk);
  return (int)cudaGetLastError();
}
