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

#include "float_rows.cuh"

using namespace fidget;

namespace {

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

  const Floats<R> mode{};
  for (int o = 0; o < O; ++o) mode.clear(tout, o, lanes);
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
  StoreOutput<Floats<R>> sink{tout, lanes};
  run_tape(mode, sink, ring, Staging{order, nf, stride, V, O},
           w1 + (size_t)t * L, w2 + (size_t)t * L, imm + (size_t)t * L, n,
           regs, tvars, lanes);
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
