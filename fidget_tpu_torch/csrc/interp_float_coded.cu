// Float-mode tape interpreter over ONE shared tape, specialized per tile
// by packed 2-bit action codes instead of per-tile child tapes.
//
// Replaces the TPU kernel fidget_tpu/eval/pallas_interp.py
// `interp_float_coded` (pallas_call at :579), the coded leaf pass of the
// 2D frame. Semantics: tile t walks rows j < min(lengths[t], L) of the
// single tape; its code for row j is bits (j % 16) * 2 of word j / 16 of
// codes[t]. Code 0 skips the row without reading its tape words; code 1
// executes it; code 2 (3) executes it as COPY from operand a (b). An
// IMM12 operand reads imm[j], a COPY of an immediate included. OUTPUT is
// tested after the rewrite (a rewritten row is never OUTPUT) and writes
// its `a` operand to out[t, min(aux, O-1)]; INPUT reads
// vars[t, min(aux, V-1)]; register reads and writes clamp to nf - 1.
// Outputs the tile never writes (all of them when lengths[t] is 0, a
// culled tile) are 0. The arithmetic is interp_float.cu's (f_unary and
// f_binary of ops.cuh, --fmad=false), so on equal inputs this kernel
// equals reconstruct + interp_float bit for bit.
//
// Design. One thread per lane, grid (tile, lane block). Every thread of
// a block shares the tile's codes, so the skip test is uniform and never
// diverges. A code word is loaded once per 16 rows; the rows to run are
// taken from it by find-first-set, so a skipped row costs no instruction
// and a zero word costs one load. The last word is masked to the tile's
// length (L need not be a multiple of 16). The register file is
// [nf][BLOCK] in dynamic shared memory when the wrapper finds room for
// it (SMEM_LIMIT, eval/cuda.py), else a global scratch [t][reg][lane].
// What bounds it: as the one-lane-a-thread float kernel before it, the
// dependent chain of each executed row (two register-file reads, one op,
// one write); the executed rows of a tile are what its child tape would
// hold, so the lane-steps are those of reconstruct + interp_float, with
// tape words read at scattered rows of one tape that every block shares
// (it stays in L2) instead of consecutive rows of a tape per tile.

#include <cuda_runtime.h>

#include "ops.cuh"

using namespace fidget;

__global__ void __launch_bounds__(BLOCK) interp_float_coded_kernel(
    const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
    const float* __restrict__ imm, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ codes, const float* __restrict__ vars,
    float* __restrict__ out, float* __restrict__ scratch, int L, int LW,
    int nf, int V, int O, int lanes) {
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
  const int32_t* tcodes = codes + (size_t)t * LW;
  const float* tvars = vars + (size_t)t * V * lanes + lane;
  float* tout = out + (size_t)t * O * lanes + lane;

  for (int o = 0; o < O; ++o) tout[(size_t)o * lanes] = 0.f;
  const int n = min(lengths[t], L);
  for (int base = 0; base < n; base += 16) {
    uint32_t word = (uint32_t)tcodes[base >> 4];
    const int left = n - base;  // rows of this word inside the tape
    if (left < 16) word &= (1u << (2 * left)) - 1u;
    while (word != 0u) {
      const int k = (__ffs((int)word) - 1) >> 1;
      const int code = (int)((word >> (2 * k)) & 3u);
      word &= ~(3u << (2 * k));
      const int j = base + k;
      Word w = decode(w1[j], w2[j]);
      if (code > 1) {
        if (code == 3) w.a = w.b;
        w.op = OP_COPY;
      }
      const float iv = imm[j];
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
}

extern "C" int fidget_interp_float_coded(
    const int32_t* w1, const int32_t* w2, const float* imm,
    const int32_t* lengths, const int32_t* codes, const float* vars,
    float* out, float* scratch, int T, int L, int LW, int nf, int V, int O,
    int lanes, cudaStream_t stream) {
  if (T <= 0 || lanes <= 0) return (int)cudaSuccess;
  if (LW * 16 < L) return (int)cudaErrorInvalidValue;
  size_t smem = scratch ? 0 : (size_t)nf * BLOCK * sizeof(float);
  FIDGET_SET_SMEM(interp_float_coded_kernel, (int)smem);
  dim3 grid(T, (lanes + BLOCK - 1) / BLOCK);
  interp_float_coded_kernel<<<grid, BLOCK, smem, stream>>>(
      w1, w2, imm, lengths, codes, vars, out, scratch, L, LW, nf, V, O, lanes);
  return (int)cudaGetLastError();
}
