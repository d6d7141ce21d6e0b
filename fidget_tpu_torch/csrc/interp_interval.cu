// Interval-mode tape interpreter with 2-bit choice capture.
//
// Replaces the TPU kernel fidget_tpu/eval/pallas_interp.py
// `_interp_interval_impl` (pallas_call at :715), the root pass of the
// 2D frame (lanes = root tiles) and the subtile pass of the two-level
// and 3D frames. Semantics: as the float kernel, over (lo, hi) pairs;
// each MIN/MAX/AND/OR ORs its choice code into word
// min(aux / 16, CW - 1) of its lane at bit (aux % 16) * 2, so indices
// past 16 * CW fold into the last word (over-approximate, never wrong).
// Outputs and choice words not written by the tape are 0. `order`, when
// not null, is the position -> canonical opcode table of a renumbered
// arena.
//
// What bounds it on an H100: latency. The passes that call it have a
// few hundred lanes (one per tile), so a scheduler holds one warp and
// every tape row is a dependent chain with nothing to hide it behind;
// a row costs what its instructions and, above all, its taken branches
// cost one warp alone (about 3.5 cycles an instruction, 20-30 a taken
// branch). Each lane is evaluated on its own, so any split of the
// lanes gives the same words; one thread per lane stays. The design
// shortens the chain:
//   - the tape is staged through a ring in shared memory (ops.cuh
//     `TapeRing`, cp.async one chunk ahead) and decoded once per block;
//     the loop reads a row as one 16-byte broadcast word, one row ahead
//     of use, so neither the fetch nor the decode is on the chain;
//   - a register holds (lo, hi) as one 8-byte element, [nf][BLOCK] in
//     shared memory behind the ring (one LDS.64 per operand at a 32-bit
//     offset), or in a global scratch [t][reg][lane] where shared
//     memory does not hold it;
//   - both operand loads start before the dispatch, so their
//     latency overlaps the compare-and-branch tree of the switch;
//   - choice words accumulate in shared memory, [CW][BLOCK], by an
//     atomic OR whose result is unused (fire and forget), and are
//     written to device memory once, coalesced, after the walk; where
//     they do not fit they are OR-reduced into device memory that the
//     wrapper has zeroed. No choice row waits on a load;
//   - one flat switch whose cases call i_unary / i_binary / i_choice
//     with a constant opcode (all force-inlined).
// Measured and left out because each made the pass slower (0.98 ms for
// 7,203 rows at the root of a 1024^2 frame; NVIDIA H100 80GB HBM3,
// 700 W): loading the next row's operands before this row's store when
// the two are independent (1.22 ms), handing the previous result on in
// registers (1.27 ms), and computing the cheap ops branch-free with
// selects (1.39 ms): each adds more instructions to the chain than it
// takes latency off it. With the dispatch and the arithmetic removed
// the walk takes 0.35 ms, so two thirds of a row are the branch tree
// and the interval op. Chunk, shared-memory bytes and the two routes
// come from `launch_geometry` in fidget_tpu_torch/eval/cuda.py.

#include <cuda_runtime.h>

#include "ops.cuh"

using namespace fidget;

namespace {

// an operand: the lane's (lo, hi) of a register, or the immediate
__device__ __forceinline__ Ival operand(const unsigned char* regs, int off,
                                        float iv) {
  if (off >= 0) {
    const float2 v = *reinterpret_cast<const float2*>(regs + off);
    return Ival{v.x, v.y};
  }
  return Ival{iv, iv};
}

#define FIDGET_UNARY(OP)   \
  case OP:                 \
    r = i_unary(OP, va);   \
    break;
#define FIDGET_BINARY(OP)      \
  case OP:                     \
    r = i_binary(OP, va, vb);  \
    break;
#define FIDGET_CHOICE(OP)                                               \
  case OP: {                                                            \
    int code;                                                           \
    r = i_choice(OP, va, vb, &code);                                    \
    const int bits = (int)((uint32_t)code << (pay & 31));               \
    if (CH_SHARED)                                                      \
      atomicOr(chs + (pay >> 5) * BLOCK, bits);                         \
    else                                                                \
      atomicOr(tch + (size_t)(pay >> 5) * lanes, bits);                 \
    break;                                                              \
  }

// What a row needs of its block beside the register file.
struct Lane {
  const float *var_lo, *var_hi;  // at this instance's lane
  float *out_lo, *out_hi;
  int32_t* tch;  // this lane's choice words in device memory
  int32_t* chs;  // and in shared memory
  int lanes;
};

// One tape row on one lane: both operand loads first, so that their
// latency overlaps the dispatch, then one flat switch with a constant
// opcode per case.
template <bool CH_SHARED>
__device__ __forceinline__ void run_row(const Row cur, const float iv,
                                        unsigned char* regs, const Lane& ln) {
  const Ival va = operand(regs, cur.a, iv);
  const Ival vb = operand(regs, cur.b, iv);
  const int pay = cur.op_pay >> 8;
  const int lanes = ln.lanes;
  int32_t* const chs = ln.chs;
  int32_t* const tch = ln.tch;
  Ival r;
  switch (cur.op_pay & 0xFF) {
    case OP_OUTPUT:
      ln.out_lo[(size_t)pay * lanes] = va.lo;
      ln.out_hi[(size_t)pay * lanes] = va.hi;
      r = va;
      break;
    case OP_INPUT:
      r = Ival{ln.var_lo[(size_t)pay * lanes], ln.var_hi[(size_t)pay * lanes]};
      break;
    FIDGET_CHOICE(OP_MIN) FIDGET_CHOICE(OP_MAX) FIDGET_CHOICE(OP_AND)
    FIDGET_CHOICE(OP_OR)
    FIDGET_UNARY(OP_NEG) FIDGET_UNARY(OP_ABS) FIDGET_UNARY(OP_RECIP)
    FIDGET_UNARY(OP_SQRT) FIDGET_UNARY(OP_SQUARE) FIDGET_UNARY(OP_FLOOR)
    FIDGET_UNARY(OP_CEIL) FIDGET_UNARY(OP_ROUND) FIDGET_UNARY(OP_SIN)
    FIDGET_UNARY(OP_COS) FIDGET_UNARY(OP_TAN) FIDGET_UNARY(OP_ASIN)
    FIDGET_UNARY(OP_ACOS) FIDGET_UNARY(OP_ATAN) FIDGET_UNARY(OP_EXP)
    FIDGET_UNARY(OP_LN) FIDGET_UNARY(OP_NOT)
    FIDGET_BINARY(OP_ADD) FIDGET_BINARY(OP_SUB) FIDGET_BINARY(OP_MUL)
    FIDGET_BINARY(OP_DIV) FIDGET_BINARY(OP_ATAN2) FIDGET_BINARY(OP_COMPARE)
    FIDGET_BINARY(OP_MOD)
    default:  // OP_COPY
      r = va;
      break;
  }
  *reinterpret_cast<float2*>(regs + cur.out) = make_float2(r.lo, r.hi);
}

#undef FIDGET_UNARY
#undef FIDGET_BINARY
#undef FIDGET_CHOICE

template <bool REGS_SHARED, bool CH_SHARED>
__global__ void __launch_bounds__(BLOCK) interp_interval_kernel(
    const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
    const float* __restrict__ imm, const int32_t* __restrict__ lengths,
    const float* __restrict__ var_lo, const float* __restrict__ var_hi,
    float* __restrict__ out_lo, float* __restrict__ out_hi,
    int32_t* __restrict__ choices, float* __restrict__ scratch,
    const int32_t* __restrict__ order, int L, int nf, int V, int O, int CW,
    int lanes, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int lane = blockIdx.y * BLOCK + threadIdx.x;
  const size_t vbase = (size_t)t * V * lanes + lane;
  const size_t obase = (size_t)t * O * lanes + lane;
  int32_t* tch = choices + (size_t)t * CW * lanes + lane;

  for (int o = 0; o < O; ++o) {
    out_lo[obase + (size_t)o * lanes] = 0.f;
    out_hi[obase + (size_t)o * lanes] = 0.f;
  }
  const int n = min(lengths[t], L);
  if (n <= 0) {  // uniform across the block: no tape, no choices
    if (CH_SHARED)
      for (int c = 0; c < CW; ++c) tch[(size_t)c * lanes] = 0;
    return;
  }

  const TapeRing ring{smem, chunk};
  unsigned char* regs;
  int stride;  // bytes from one register to the next
  if (REGS_SHARED) {
    regs = ring.end() + threadIdx.x * 8;
    stride = BLOCK * 8;
  } else {
    regs = reinterpret_cast<unsigned char*>(
        scratch + ((size_t)t * nf * lanes + lane) * 2);
    stride = lanes * 8;
  }
  int32_t* chs =
      reinterpret_cast<int32_t*>(
          ring.end() + (REGS_SHARED ? (size_t)nf * BLOCK * 8 : 0)) +
      threadIdx.x;
  if (CH_SHARED)
    for (int c = 0; c < CW; ++c) chs[c * BLOCK] = 0;
  const Lane ln{var_lo + vbase, var_hi + vbase, out_lo + obase,
                out_hi + obase, tch, chs, lanes};
  const int32_t* tw1 = w1 + (size_t)t * L;
  const int32_t* tw2 = w2 + (size_t)t * L;
  const float* timm = imm + (size_t)t * L;

  ring.fetch(tw1, tw2, timm, 0, min(chunk, n));
  ring.decode(0, min(chunk, n), order, nf, stride, V, O, CW);
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
      run_row<CH_SHARED>(row_a, imm_a, regs, ln);
      if (k + 1 >= count) break;
      row_a = rows[k + 2];
      imm_a = imms[k + 2];
      run_row<CH_SHARED>(row_b, imm_b, regs, ln);
    }
    if (next > 0) ring.decode(buf ^ 1, next, order, nf, stride, V, O, CW);
    __syncthreads();
  }
  if (CH_SHARED)
    for (int c = 0; c < CW; ++c) tch[(size_t)c * lanes] = chs[c * BLOCK];
}

}  // namespace

// `chunk` tape rows a ring buffer; `smem_bytes` of dynamic shared
// memory: the ring, then the register file unless `scratch` is given,
// then the choice words if `choices_shared` (else `choices` must come
// zeroed).
extern "C" int fidget_interp_interval(
    const int32_t* w1, const int32_t* w2, const float* imm,
    const int32_t* lengths, const float* var_lo, const float* var_hi,
    float* out_lo, float* out_hi, int32_t* choices, float* scratch,
    const int32_t* order, int T, int L, int nf, int V, int O, int CW,
    int lanes, int chunk, int choices_shared, int smem_bytes,
    cudaStream_t stream) {
  if (T <= 0 || lanes <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || CW <= 0 || lanes % BLOCK != 0)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      tape_ring_bytes(chunk) +
      (scratch ? 0 : (size_t)nf * BLOCK * 2 * sizeof(float)) +
      (choices_shared ? (size_t)CW * BLOCK * sizeof(int32_t) : 0);
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  auto kernel = interp_interval_kernel<true, true>;
  if (scratch == nullptr && !choices_shared)
    kernel = interp_interval_kernel<true, false>;
  if (scratch != nullptr && choices_shared)
    kernel = interp_interval_kernel<false, true>;
  if (scratch != nullptr && !choices_shared)
    kernel = interp_interval_kernel<false, false>;
  FIDGET_SET_SMEM(kernel, smem_bytes);
  dim3 grid(T, lanes / BLOCK);
  kernel<<<grid, BLOCK, smem_bytes, stream>>>(
      w1, w2, imm, lengths, var_lo, var_hi, out_lo, out_hi, choices, scratch,
      order, L, nf, V, O, CW, lanes, chunk);
  return (int)cudaGetLastError();
}
