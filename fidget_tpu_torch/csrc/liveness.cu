// Reverse-liveness pass: per-lane 2-bit action codes for every op of a
// tape, from the lane's interval choice codes.
//
// Replaces the TPU kernel fidget_tpu/eval/simplify_device.py
// `_liveness_codes` (pallas_call at :154), the per-tile simplification
// of the 2D frame. Semantics: walk the tape backwards carrying a
// per-lane liveness bit for each of the nf registers; an op executes if
// it is an OUTPUT or writes a live register; its code is 0 (drop),
// 1 (keep), 2 (COPY from a) or 3 (COPY from b) by its choice code, and
// a COPY onto its own destination is elided. Codes pack 16 per int32
// word, op j at bit (j % 16) * 2 of word j / 16. Immediate operands
// carry the IMM12 marker and are clamped to nf - 1 before the liveness
// plane is indexed (their use bit is 0 then): the unclamped index was
// the reference's out-of-bounds write (BUGREPORT.md). `order`, when not
// null, is the position -> canonical opcode table of a renumbered arena
// (ops.cuh `decode`); the choice and operand masks stay canonical.
//
// Design. One thread per lane, grid (instance, lane block); with a
// shared tape every block reads the same warp-uniform words. The
// liveness plane is one byte per (register, lane): [nf][BLOCK] in
// dynamic shared memory when it fits SMEM_LIMIT (eval/cuda.py), else a
// global scratch [b][reg][lane]. The code word under construction stays in a thread
// register and is stored once per 16 ops. What bounds it: the serial
// chain over the tape (read one choice word, update three liveness
// bytes per op), per thread, with only S0 * 128 lanes in flight.

#include <cuda_runtime.h>

#include "ops.cuh"

using namespace fidget;

template <bool ORDERED>
__global__ void __launch_bounds__(BLOCK) liveness_kernel(
    const int32_t* __restrict__ w1s, const int32_t* __restrict__ w2s,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ choices,
    int32_t* __restrict__ codes, uint8_t* __restrict__ scratch,
    const int32_t* __restrict__ order, int Tt, int L, int nf, int CW,
    int lanes) {
  extern __shared__ uint8_t smem_live[];
  const int bi = blockIdx.x;
  const int lane = blockIdx.y * BLOCK + threadIdx.x;
  if (lane >= lanes) return;

  uint8_t* live;
  size_t stride;
  if (scratch != nullptr) {
    live = scratch + (size_t)bi * nf * lanes + lane;
    stride = lanes;
  } else {
    live = smem_live + threadIdx.x;
    stride = BLOCK;
  }
  const int tr = Tt == 1 ? 0 : bi;
  const int32_t* tw1 = w1s + (size_t)tr * L;
  const int32_t* tw2 = w2s + (size_t)tr * L;
  const int32_t* tch = choices + (size_t)bi * CW * lanes + lane;
  const int LW = (L + 15) / 16;
  int32_t* tcodes = codes + (size_t)bi * LW * lanes + lane;

  for (int r = 0; r < nf; ++r) live[(size_t)r * stride] = 0;
  const int n = min(lengths[tr], L);
  for (int wi = (n + 15) / 16; wi < LW; ++wi) tcodes[(size_t)wi * lanes] = 0;

  uint32_t acc = 0;
  int cur = (n - 1) >> 4;
  for (int j = n - 1; j >= 0; --j) {
    if ((j >> 4) != cur) {
      tcodes[(size_t)cur * lanes] = (int32_t)acc;
      acc = 0;
      cur = j >> 4;
    }
    const Word w = decode<ORDERED>(tw1[j], tw2[j], order);
    const bool is_output = w.op == OP_OUTPUT;
    const bool known = w.op < 32;
    const bool is_choice = known && ((CHOICE_MASK >> w.op) & 1u);
    const bool a_is_reg = w.op != OP_INPUT && w.a != IMM12;
    const bool b_is_reg = known && ((BINARY_MASK >> w.op) & 1u) && w.b != IMM12;
    const size_t io = (size_t)min(w.out, nf - 1) * stride;
    const bool executed = is_output || live[io];
    int c = 0;
    if (is_choice) {
      const uint32_t word = (uint32_t)tch[(size_t)min(w.aux >> 4, CW - 1) * lanes];
      c = (word >> ((w.aux & 15) * 2)) & 3u;
    }
    const bool left = is_choice && c == CHOICE_LEFT;
    const bool right = is_choice && c == CHOICE_RIGHT;
    const bool both = !is_choice || c == CHOICE_BOTH || c == 0;
    const bool elide =
        executed && ((w.a == w.out && left) || (w.b == w.out && right));
    const bool emit = executed && !elide;
    const uint32_t code = emit ? (both ? 1u : (left ? 2u : 3u)) : 0u;
    acc |= code << ((j & 15) * 2);
    const bool use_a = a_is_reg && emit && (both || left);
    const bool use_b = b_is_reg && emit && (both || right);
    if (emit) live[io] = 0;
    if (use_a) live[(size_t)min(w.a, nf - 1) * stride] = 1;
    if (use_b) live[(size_t)min(w.b, nf - 1) * stride] = 1;
  }
  if (n > 0) tcodes[(size_t)cur * lanes] = (int32_t)acc;
}

extern "C" int fidget_liveness_codes(
    const int32_t* w1s, const int32_t* w2s, const int32_t* lengths,
    const int32_t* choices, int32_t* codes, uint8_t* scratch,
    const int32_t* order, int B, int Tt, int L, int nf, int CW, int lanes,
    cudaStream_t stream) {
  if (B <= 0 || lanes <= 0) return (int)cudaSuccess;
  size_t smem = scratch ? 0 : (size_t)nf * BLOCK;
  dim3 grid(B, (lanes + BLOCK - 1) / BLOCK);
  if (order != nullptr) {
    FIDGET_SET_SMEM(liveness_kernel<true>, (int)smem);
    liveness_kernel<true><<<grid, BLOCK, smem, stream>>>(
        w1s, w2s, lengths, choices, codes, scratch, order, Tt, L, nf, CW,
        lanes);
  } else {
    FIDGET_SET_SMEM(liveness_kernel<false>, (int)smem);
    liveness_kernel<false><<<grid, BLOCK, smem, stream>>>(
        w1s, w2s, lengths, choices, codes, scratch, order, Tt, L, nf, CW,
        lanes);
  }
  return (int)cudaGetLastError();
}
