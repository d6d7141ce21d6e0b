// Float-mode tape interpreter over ONE shared tape, specialized per tile
// by packed 2-bit action codes instead of per-tile child tapes.
//
// Replaces the TPU kernel fidget_tpu/eval/pallas_interp.py
// `interp_float_coded` (pallas_call at :579), the coded leaf pass of the
// 2D frame. Semantics: tile t walks rows j < min(lengths[t], L) of the
// single tape; its code for row j is bits (j % 16) * 2 of word j / 16 of
// codes[t]. Code 0 skips the row; code 1 executes it; code 2 (3)
// executes it as COPY from operand a (b), whatever the row's op (a code
// 3 on a unary row copies from its raw b field). An IMM12 operand reads
// imm[j], a COPY of an immediate included. OUTPUT is tested after the
// rewrite (a rewritten row is never OUTPUT) and writes its `a` operand
// to out[t, min(aux, O-1)]; INPUT reads vars[t, min(aux, V-1)]; register
// reads and writes clamp to nf - 1, and a register no executed row
// wrote reads 0, as in the plain version, so the two agree for any
// codes. Outputs the tile never writes (all of them when lengths[t] is
// 0, a culled tile) are 0. The arithmetic is interp_float.cu's
// (float_rows.cuh, --fmad=false), so on equal inputs this kernel equals
// reconstruct + interp_float bit for bit.
//
// What bounds it on an H100: what bounds interp_float.cu, on the rows a
// tile executes. The one-lane loop it replaces paid per warp per row the
// fetch of scattered tape words, the decode and the dispatch (8.3 ms for
// the coded leaf of a 1024^2 frame, against 1.3 ms for reconstruct's
// child tapes through interp_float; NVIDIA H100 80GB HBM3, 700 W). The
// design makes its row loop interp_float's:
//   - a thread owns R = 4 (2, 1) lanes with 16-byte accesses, and the
//     register file [nf][BLOCK * R] lies in shared memory behind the
//     ring (or, SHARED = false, in a global scratch [t][reg][lane]);
//   - the shared tape goes through the cp.async ring of ops.cuh
//     (`TapeRing`) one chunk ahead, and per chunk the block decodes
//     only the rows its tile executes, compacted: each thread reads the
//     chunk's code words (the same for the whole block), counts the
//     executed rows before its own by popcount, rewrites a code 2 / 3
//     row into a COPY in the raw words and hands it to `stage_row`. The
//     loop (`run_rows`) then runs exactly the rows the tile's child tape
//     would hold, one broadcast row at a time, and a skipped row costs
//     no loop turn;
//   - a length-0 tile leaves at once, uniformly across its block.
// 1.45 ms on that leaf, 1.30 for interp_float on the same rows: the
// rest is the 29 chunk decodes a tile against 8. Measured and left out
// because each was slower: the chunk's code words loaded into registers
// before the walk (1.53 ms) and the executed rows gathered from device
// memory instead of copying the chunk (1.60 ms).
// Lanes per thread, chunk, shared-memory bytes and the route come from
// `launch_geometry` in fidget_tpu_torch/eval/cuda.py (K3's rule).

#include <cuda_runtime.h>

#include "float_rows.cuh"

using namespace fidget;

namespace {

// Decodes the executed rows among rows [j0, j0 + count) of the tape
// (count <= chunk; the raw words are in `ring` as `fetch` left them)
// into buffer `buf`, compacted in tape order. Returns how many there
// are. The thread handles the rows it copied itself, slots k = tid,
// tid + BLOCK, ...; at most one of them lies in each word of 16.
__device__ __forceinline__ int decode_executed(
    const TapeRing& ring, int buf, int j0, int count,
    const int32_t* __restrict__ tcodes, int n, int nf, int stride, int V,
    int O) {
  cp_async_wait_all();
  const int words = (count + 15) >> 4;
  int before = 0;  // executed rows of the words already passed
  int k = threadIdx.x;
  for (int wi = 0; wi < words; ++wi) {
    const int base = j0 + 16 * wi;
    uint32_t word = (uint32_t)__ldg(tcodes + (base >> 4));
    if (n - base < 16) word &= (1u << (2 * (n - base))) - 1u;
    const uint32_t any = (word | (word >> 1)) & 0x55555555u;
    if ((k >> 4) == wi) {
      const int s = 2 * (k & 15);
      const uint32_t code = (word >> s) & 3u;
      if (code != 0u) {
        const int pos = before + __popc(any & ((1u << s) - 1u));
        int32_t w1 = ring.raw(0)[k];
        const int32_t w2 = ring.raw(1)[k];
        if (code > 1u) {
          const int src = code == 3u ? (w2 & 0xFFF) : ((w1 >> 19) & 0xFFF);
          w1 = OP_COPY | (w1 & (0xFFF << 7)) | (src << 19);
        }
        ring.rows(buf)[pos] = stage_row(w1, w2, nullptr, nf, stride, V, O, 0);
        ring.imms(buf)[pos] = __int_as_float(ring.raw(2)[k]);
      }
      k += BLOCK;
    }
    before += __popc(any);
  }
  return before;
}

template <int R, bool SHARED>
__global__ void __launch_bounds__(BLOCK) interp_float_coded_kernel(
    const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
    const float* __restrict__ imm, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ codes, const float* __restrict__ vars,
    float* __restrict__ out, float* __restrict__ scratch, int L, int LW,
    int nf, int V, int O, int lanes, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int lane = (blockIdx.y * BLOCK + threadIdx.x) * R;
  const float* tvars = vars + (size_t)t * V * lanes + lane;
  float* tout = out + (size_t)t * O * lanes + lane;

  const Floats<R> mode{};
  for (int o = 0; o < O; ++o) mode.clear(tout, o, lanes);
  const int n = min(lengths[t], L);
  if (n <= 0) return;  // uniform across the block: a culled tile

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
  for (int r = 0; r < nf; ++r)
    *reinterpret_cast<Pack<R>*>(regs + r * stride) = splat<R>(0.f);
  const int32_t* tcodes = codes + (size_t)t * LW;
  StoreOutput<Floats<R>> sink{tout, lanes};

  ring.fetch(w1, w2, imm, 0, min(chunk, n));
  int count = decode_executed(ring, 0, 0, min(chunk, n), tcodes, n, nf,
                              stride, V, O);
  __syncthreads();
  for (int j0 = 0, buf = 0; j0 < n; j0 += chunk, buf ^= 1) {
    const int next = min(chunk, n - j0 - chunk);
    if (next > 0) ring.fetch(w1, w2, imm, j0 + chunk, next);
    run_rows(mode, sink, ring.rows(buf), ring.imms(buf), count, regs, tvars,
             lanes);
    if (next > 0)
      count = decode_executed(ring, buf ^ 1, j0 + chunk, next, tcodes, n, nf,
                              stride, V, O);
    __syncthreads();
  }
}

}  // namespace

// `r` lanes a thread (1, 2 or 4; lanes a multiple of BLOCK * r), `chunk`
// tape rows a ring buffer (a multiple of 16), `smem_bytes` of dynamic
// shared memory: the ring, then the register file unless `scratch` is
// given.
extern "C" int fidget_interp_float_coded(
    const int32_t* w1, const int32_t* w2, const float* imm,
    const int32_t* lengths, const int32_t* codes, const float* vars,
    float* out, float* scratch, int T, int L, int LW, int nf, int V, int O,
    int lanes, int r, int chunk, int smem_bytes, cudaStream_t stream) {
  if (T <= 0 || lanes <= 0) return (int)cudaSuccess;
  if (LW * 16 < L || chunk <= 0 || chunk % 16 != 0 ||
      (r != 1 && r != 2 && r != 4) || lanes % (BLOCK * r) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t need = tape_ring_bytes(chunk) +
                      (scratch ? 0 : (size_t)nf * BLOCK * r * sizeof(float));
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  auto kernel = interp_float_coded_kernel<1, true>;
  if (scratch == nullptr) {
    if (r == 2) kernel = interp_float_coded_kernel<2, true>;
    if (r == 4) kernel = interp_float_coded_kernel<4, true>;
  } else {
    kernel = interp_float_coded_kernel<1, false>;
    if (r == 2) kernel = interp_float_coded_kernel<2, false>;
    if (r == 4) kernel = interp_float_coded_kernel<4, false>;
  }
  FIDGET_SET_SMEM(kernel, smem_bytes);
  dim3 grid(T, lanes / (BLOCK * r));
  kernel<<<grid, BLOCK, smem_bytes, stream>>>(
      w1, w2, imm, lengths, codes, vars, out, scratch, L, LW, nf, V, O, lanes,
      chunk);
  return (int)cudaGetLastError();
}
