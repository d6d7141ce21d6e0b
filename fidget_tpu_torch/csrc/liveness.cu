// Reverse-liveness pass: per-lane 2-bit action codes for every op of a
// tape, from the lane's interval choice codes.
//
// Replaces the TPU kernel fidget_tpu/eval/simplify_device.py
// `_liveness_codes` (pallas_call at :154), the per-tile simplification
// of the 2D frame. Semantics: walk the tape backwards carrying a
// per-lane liveness bit for each of the nf registers; an op executes if
// it is an OUTPUT or writes a live register; its code is 0 (drop),
// 1 (keep), 2 (COPY from a) or 3 (COPY from b) by its choice code, and
// a COPY onto its own destination is elided (the raw 12-bit fields are
// compared, before any clamping). Codes pack 16 per int32 word, op j at
// bit (j % 16) * 2 of word j / 16; words past the tape's length are 0.
// Registers are clamped to nf - 1 before the liveness bits are indexed,
// immediates (IMM12) included (their use bit is 0 then): the unclamped
// index was the reference's out-of-bounds write (BUGREPORT.md). Opcodes
// past 31 are no choice and take no b; a counts as a register. `order`,
// when not null, is the position -> canonical opcode table of a
// renumbered arena (ops.cuh `decode`). Choice indices past 16 * CW read
// the last word.
//
// What bounds it on an H100: the serial chain of the reverse walk. Its
// passes have one real lane per tile (64 at the root of a 1024^2 frame,
// 16 per tape at the second level), so a scheduler holds one warp and
// each row waits for the liveness of the row after it. The one-lane loop
// this replaces put every load on that chain (two tape words and the
// choice word from device memory, the liveness byte plane through a
// pointer that may be global): about 470 cycles a row, 1.71 ms for the
// 7,203 rows of the root (NVIDIA H100 80GB HBM3, 700 W). The design
// leaves only the liveness bits on the chain:
//   - liveness is a bit mask in the thread's registers (W = 1 or 2
//     32-bit words, nf <= 64); a row's chain is an AND with its
//     destination's bit, a test, and an and-not / or with the bits it
//     clears and sets: a handful of dependent integer instructions.
//     Above 64 registers (W = 0) the byte plane [nf][BLOCK] stays, in
//     shared memory or in a global scratch [b][reg][lane];
//   - the tape is staged backwards through a cp.async ring in shared
//     memory, chunk by chunk from the end, the chunk before the one
//     being walked in flight, and every row is decoded once per block
//     into a `LiveRow`: the one-hot bits (or byte offsets) of its
//     clamped destination and register operands, the offset and shift
//     of its choice word, and for each of the four choice codes what the
//     row emits and which operands it marks live, with the raw-field
//     elision already applied. Chunks hold whole words of 16 rows, and
//     rows past the tape's end decode to rows that never execute, so a
//     word is 16 unrolled steps and one store;
//   - the block's choice words [CW][BLOCK] are copied into shared
//     memory at the start; where they do not fit, they are read from
//     device memory, and neither is on the chain (the choice code picks
//     the row's entry, which the chain only gates).
// Chunk, shared-memory bytes and the routes come from `launch_geometry`
// in fidget_tpu_torch/eval/cuda.py.

#include <cuda_runtime.h>

#include "ops.cuh"

using namespace fidget;

namespace {

// One row as the reverse walk reads it. On the mask route (W > 0),
// `out`, `a` and `b` are one-hot 64-bit masks (lo, hi) of the clamped
// registers; on the byte-plane route, `out[0]`, `a[0]` and `b[0]` are
// byte offsets into the plane. `ctl` holds the choice word's shift in
// bits 0-4, FORCE (an OUTPUT row, executed whatever the liveness) and,
// in bits 16-31, one nibble per choice code c: the code the row emits
// if it executes (bits 0-1; 0 = elided) and whether it marks a (bit 2)
// and b (bit 3) live. A row that never executes is all zeros.
struct alignas(16) LiveRow {
  uint32_t out[2], a[2], b[2];
  int32_t cw_off;  // byte offset of the choice word from the lane's first
  uint32_t ctl;
};

constexpr uint32_t FORCE = 1u << 8;

__host__ __device__ constexpr size_t live_ring_bytes(int chunk) {
  return (size_t)chunk * (2 * sizeof(LiveRow) + 2 * sizeof(int32_t));
}

// W > 0: the mask words a register's bit lies in; W == 0: byte offsets
template <int W>
__device__ __forceinline__ void reg_bits(uint32_t* m, int r, int stride) {
  if (W == 0) {
    m[0] = (uint32_t)(r * stride);
    m[1] = 0u;
  } else {
    m[0] = r < 32 ? 1u << r : 0u;
    m[1] = r >= 32 ? 1u << (r - 32) : 0u;
  }
}

template <int W>
__device__ __forceinline__ LiveRow stage_live_row(
    int32_t w1, int32_t w2, const int32_t* __restrict__ order, int nf,
    int stride, int cw_mul, int CW) {
  int op = w1 & 127;
  if (order != nullptr && op < N_OPS) op = __ldg(order + op);
  const int out = (w1 >> 7) & 0xFFF, a = (w1 >> 19) & 0xFFF, b = w2 & 0xFFF;
  const int aux = (int)((uint32_t)w2 >> 12);
  const bool known = op < 32;
  const bool is_choice = known && ((CHOICE_MASK >> op) & 1u);
  const bool a_is_reg = op != OP_INPUT && a != IMM12;
  const bool b_is_reg = known && ((BINARY_MASK >> op) & 1u) && b != IMM12;
  uint32_t table = 0;
  for (int c = 0; c < 4; ++c) {
    const bool left = is_choice && c == CHOICE_LEFT;
    const bool right = is_choice && c == CHOICE_RIGHT;
    const bool both = !is_choice || c == CHOICE_BOTH || c == 0;
    const bool elide = (a == out && left) || (b == out && right);
    const uint32_t code = elide ? 0u : (both ? 1u : (left ? 2u : 3u));
    const bool use_a = a_is_reg && code != 0u && (both || left);
    const bool use_b = b_is_reg && code != 0u && (both || right);
    table |= (code | (uint32_t)use_a << 2 | (uint32_t)use_b << 3) << (4 * c);
  }
  LiveRow r;
  reg_bits<W>(r.out, min(out, nf - 1), stride);
  reg_bits<W>(r.a, min(a, nf - 1), stride);
  reg_bits<W>(r.b, min(b, nf - 1), stride);
  r.cw_off = is_choice ? min(aux >> 4, CW - 1) * cw_mul : 0;
  r.ctl = (is_choice ? (uint32_t)(aux & 15) * 2 : 0u) |
          (op == OP_OUTPUT ? FORCE : 0u) | table << 16;
  return r;
}

// The ring of one block: two buffers of `chunk` decoded rows, one being
// walked and one being filled, then the raw words (w1, w2) of one chunk
// as cp.async lands them. Each thread decodes only the slots it copied
// itself, so no barrier lies between the wait and the decode.
struct LiveRing {
  unsigned char* base;  // 16-byte aligned shared memory
  int chunk;

  __device__ __forceinline__ LiveRow* rows(int buf) const {
    return reinterpret_cast<LiveRow*>(base) + buf * chunk;
  }
  __device__ __forceinline__ int32_t* raw(int word) const {
    return reinterpret_cast<int32_t*>(rows(2)) + word * chunk;
  }
  __device__ __forceinline__ unsigned char* end() const {
    return base + live_ring_bytes(chunk);
  }

  // starts the copy of tape rows [j0, j0 + count)
  __device__ __forceinline__ void fetch(const int32_t* w1, const int32_t* w2,
                                        int j0, int count) const {
    for (int k = threadIdx.x; k < count; k += BLOCK) {
      cp_async4(raw(0) + k, w1 + j0 + k);
      cp_async4(raw(1) + k, w2 + j0 + k);
    }
    cp_async_commit();
  }

  // decodes rows [j0, j0 + span) into buffer `buf`: rows below n from
  // the raw words, the rest as rows that never execute
  template <int W>
  __device__ __forceinline__ void decode(int buf, int j0, int span, int n,
                                         const int32_t* __restrict__ order,
                                         int nf, int stride, int cw_mul,
                                         int CW) const {
    cp_async_wait_all();
    for (int k = threadIdx.x; k < span; k += BLOCK) {
      LiveRow r = {};
      if (j0 + k < n)
        r = stage_live_row<W>(raw(0)[k], raw(1)[k], order, nf, stride, cw_mul,
                              CW);
      rows(buf)[k] = r;
    }
  }
};

// The liveness of one lane: W mask words in registers, or (W == 0) the
// lane's column of the byte plane.
template <int W>
struct Live {
  uint32_t m[W > 0 ? W : 1];
  uint8_t* plane;

  // one row: returns the row's code for this lane and updates liveness
  __device__ __forceinline__ uint32_t step(const LiveRow& row,
                                           uint32_t word) {
    const uint32_t c = __funnelshift_r(word, 0u, row.ctl) & 3u;
    const uint32_t entry = row.ctl >> (16 + 4 * c);
    bool exec = (row.ctl & FORCE) != 0u;
    if (W == 0) {
      exec = exec || plane[row.out[0]] != 0;
      if (exec) {
        if (entry & 3u) plane[row.out[0]] = 0;
        if (entry & 4u) plane[row.a[0]] = 1;
        if (entry & 8u) plane[row.b[0]] = 1;
      }
    } else {
      uint32_t hit = 0u;
#pragma unroll
      for (int i = 0; i < W; ++i) hit |= m[i] & row.out[i];
      exec = exec || hit != 0u;
      // one word: a select; two: logic on the mask with all ones for a
      // row that executes, because a select over two words compiled to
      // a divergent branch a row (2.7x the one-word walk on an H100),
      // and the logic costs one word 7%
      const uint32_t em = exec ? ~0u : 0u;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const uint32_t clr = (entry & 3u) ? row.out[i] : 0u;
        const uint32_t set =
            ((entry & 4u) ? row.a[i] : 0u) | ((entry & 8u) ? row.b[i] : 0u);
        if (W == 1)
          m[i] = exec ? ((m[i] & ~clr) | set) : m[i];
        else
          m[i] = (m[i] & ~(clr & em)) | (set & em);
      }
      if (W > 1) return entry & 3u & em;
    }
    return exec ? (entry & 3u) : 0u;
  }
};

template <int W, bool CH_SHARED>
__global__ void __launch_bounds__(BLOCK) liveness_kernel(
    const int32_t* __restrict__ w1s, const int32_t* __restrict__ w2s,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ choices,
    int32_t* __restrict__ codes, uint8_t* __restrict__ scratch,
    const int32_t* __restrict__ order, int Tt, int L, int nf, int CW,
    int lanes, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bi = blockIdx.x;
  const int lane = blockIdx.y * BLOCK + threadIdx.x;
  const int tr = Tt == 1 ? 0 : bi;
  const int32_t* tw1 = w1s + (size_t)tr * L;
  const int32_t* tw2 = w2s + (size_t)tr * L;
  const int32_t* tch = choices + (size_t)bi * CW * lanes + lane;
  const int LW = (L + 15) / 16;
  int32_t* tcodes = codes + (size_t)bi * LW * lanes + lane;

  const int n = min(lengths[tr], L);
  const int words = n > 0 ? (n + 15) / 16 : 0;
  for (int wi = words; wi < LW; ++wi) tcodes[(size_t)wi * lanes] = 0;
  if (n <= 0) return;  // uniform across the block

  const LiveRing ring{smem, chunk};
  unsigned char* next_free = ring.end();
  const unsigned char* chw;  // this lane's choice word 0
  int cw_mul;                // bytes from one of its words to the next
  if (CH_SHARED) {
    int32_t* chs = reinterpret_cast<int32_t*>(next_free) + threadIdx.x;
    for (int c = 0; c < CW; ++c) cp_async4(chs + c * BLOCK, tch + (size_t)c * lanes);
    chw = reinterpret_cast<const unsigned char*>(chs);
    cw_mul = BLOCK * 4;
    next_free += (size_t)CW * BLOCK * 4;
  } else {
    chw = reinterpret_cast<const unsigned char*>(tch);
    cw_mul = lanes * 4;
  }
  Live<W> live;
  int stride = 0;  // bytes from one register's plane byte to the next
#pragma unroll
  for (int i = 0; i < (W > 0 ? W : 1); ++i) live.m[i] = 0u;
  live.plane = nullptr;
  if (W == 0) {
    if (scratch != nullptr) {
      live.plane = scratch + (size_t)bi * nf * lanes + lane;
      stride = lanes;
    } else {
      live.plane = next_free + threadIdx.x;
      stride = BLOCK;
    }
    for (int r = 0; r < nf; ++r) live.plane[r * stride] = 0;
  }

  // rows [0, 16 * words) in chunks from the end; chunk q holds rows
  // [q * chunk, min((q + 1) * chunk, top))
  const int top = 16 * words;
  int q = (top - 1) / chunk;
  ring.fetch(tw1, tw2, q * chunk, min(chunk, n - q * chunk));
  ring.decode<W>(0, q * chunk, top - q * chunk, n, order, nf, stride, cw_mul,
                 CW);
  __syncthreads();
  for (int buf = 0; q >= 0; --q, buf ^= 1) {
    const int j0 = q * chunk;
    if (q > 0) ring.fetch(tw1, tw2, j0 - chunk, chunk);
    const LiveRow* rows = ring.rows(buf);
    for (int wi = min(top, j0 + chunk) / 16 - 1; wi >= j0 / 16; --wi) {
      const LiveRow* rw = rows + (wi * 16 - j0);
      uint32_t acc = 0u;
#pragma unroll
      for (int k = 15; k >= 0; --k) {
        const uint32_t word = CH_SHARED
            ? *reinterpret_cast<const uint32_t*>(chw + rw[k].cw_off)
            : __ldg(reinterpret_cast<const uint32_t*>(chw + rw[k].cw_off));
        acc |= live.step(rw[k], word) << (2 * k);
      }
      tcodes[(size_t)wi * lanes] = (int32_t)acc;
    }
    if (q > 0)
      ring.decode<W>(buf ^ 1, j0 - chunk, chunk, n, order, nf, stride, cw_mul,
                     CW);
    __syncthreads();
  }
}

template <int W>
int launch(bool ch_shared, dim3 grid, int smem, cudaStream_t stream,
           const int32_t* w1s, const int32_t* w2s, const int32_t* lengths,
           const int32_t* choices, int32_t* codes, uint8_t* scratch,
           const int32_t* order, int Tt, int L, int nf, int CW, int lanes,
           int chunk) {
  auto kernel = ch_shared ? liveness_kernel<W, true> : liveness_kernel<W, false>;
  FIDGET_SET_SMEM(kernel, smem);
  kernel<<<grid, BLOCK, smem, stream>>>(w1s, w2s, lengths, choices, codes,
                                        scratch, order, Tt, L, nf, CW, lanes,
                                        chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// `chunk` tape rows a ring buffer (a multiple of 16); `mask_words` 1 or
// 2 keeps liveness in registers (nf <= 32 * mask_words), 0 in the byte
// plane, in shared memory unless `scratch` is given; `smem_bytes` of
// dynamic shared memory: the ring, the choice words if `choices_shared`,
// then the byte plane if it is in shared memory.
extern "C" int fidget_liveness_codes(
    const int32_t* w1s, const int32_t* w2s, const int32_t* lengths,
    const int32_t* choices, int32_t* codes, uint8_t* scratch,
    const int32_t* order, int B, int Tt, int L, int nf, int CW, int lanes,
    int chunk, int mask_words, int choices_shared, int smem_bytes,
    cudaStream_t stream) {
  if (B <= 0 || lanes <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || chunk % 16 != 0 || lanes % BLOCK != 0 || nf <= 0 ||
      CW <= 0 || mask_words < 0 || mask_words > 2 ||
      (mask_words > 0 && nf > 32 * mask_words) ||
      (mask_words > 0 && scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t need =
      live_ring_bytes(chunk) +
      (choices_shared ? (size_t)CW * BLOCK * sizeof(int32_t) : 0) +
      (mask_words == 0 && scratch == nullptr ? (size_t)nf * BLOCK : 0);
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, lanes / BLOCK);
  const bool cs = choices_shared != 0;
  if (mask_words == 1)
    return launch<1>(cs, grid, smem_bytes, stream, w1s, w2s, lengths, choices,
                     codes, scratch, order, Tt, L, nf, CW, lanes, chunk);
  if (mask_words == 2)
    return launch<2>(cs, grid, smem_bytes, stream, w1s, w2s, lengths, choices,
                     codes, scratch, order, Tt, L, nf, CW, lanes, chunk);
  return launch<0>(cs, grid, smem_bytes, stream, w1s, w2s, lengths, choices,
                   codes, scratch, order, Tt, L, nf, CW, lanes, chunk);
}
