// Two-stream float interpreter: two packed tapes and two register files
// per instance, row j of both streams each turn.
//
// Replaces the Pallas probe demos/exp_interleave.py `interp_float2`
// (pallas_call at :98), which asks whether two independent tape streams
// in one instance hide the interpreter's serial row latency: variant A
// is interp_float (K3) on T instances, variant B this kernel on T / 2
// instances of two streams, the same rows in all. Semantics, as the
// reference computes them:
//   - every instance walks all L rows of both its tapes (the reference
//     hands its kernel lengths of L, so the wrapper's `lens` is unused);
//   - operand a (b) reads the row's immediate when it is IMM12, else
//     register min(a, nf - 1); INPUT reads vars[t, min(aux, V - 1)],
//     the same planes for both streams;
//   - OUTPUT and COPY write `a` to the row's register; there is no
//     output plane: out[t, s] is register 0 of stream s after the walk;
//   - an opcode past 30 acts as ATAN (the reference's lax.switch clamps
//     its index), where the other value-mode kernels pass `a` through;
//   - both register files start at 0 (the reference's scratch starts
//     unset), and register writes clamp to nf - 1 as reads do (the
//     reference writes out of bounds).
//
// Design. Each stream has its own TapeRing (ops.cuh): its tape is
// copied with cp.async one chunk ahead and decoded once per block. The
// two register files lie behind the two rings in shared memory
// ([nf][BLOCK * R] floats each) or, where they do not fit, in a global
// scratch [t][2][nf][lanes]. A turn loads the operands of both streams'
// rows first, then computes both values (float_rows.cuh `row_value`)
// and stores both: the files are disjoint, so stream B's loads need not
// wait for stream A's store, and the two rows' latencies overlap. The
// next turn's rows are read while this one runs, as K3 reads its next
// row. What bounds it is what bounds K3 (interp_float.cu): scheduler
// slots and shared-memory wavefronts per row, not operations or bytes.
// Lanes per thread, chunk, shared-memory bytes and the route come from
// `launch_geometry` in fidget_tpu_torch/eval/cuda.py.

#include <cuda_runtime.h>

#include "float_rows.cuh"

using namespace fidget;

namespace {

// OUTPUT writes no plane: its operand lands only in the row's register
template <class Mode>
struct DropOutput {
  __device__ __forceinline__ void operator()(const Mode&, int,
                                             const typename Mode::Val&) {}
};

// Waits for this thread's copies and decodes them into buffer `buf` of
// `ring` (TapeRing::decode with the canonical order), an opcode past
// the switch becoming ATAN.
__device__ __forceinline__ void decode_rows(const TapeRing& ring, int buf,
                                            int count, int nf, int stride,
                                            int V) {
  cp_async_wait_all();
  for (int k = threadIdx.x; k < count; k += BLOCK) {
    int32_t w1 = ring.raw(0)[k];
    if ((w1 & 127) >= N_OPS) w1 = (w1 & ~127) | OP_ATAN;
    ring.rows(buf)[k] = stage_row(w1, ring.raw(1)[k], nullptr, nf, stride,
                                  V, 1, 0);
    ring.imms(buf)[k] = __int_as_float(ring.raw(2)[k]);
  }
}

// Row k of both streams: the four operand loads first, then both
// values, then both stores.
struct Turn {
  Row a, b;
  float ia, ib;
};

__device__ __forceinline__ Turn load_turn(const TapeRing& ring_a,
                                          const TapeRing& ring_b, int buf,
                                          int k) {
  return Turn{ring_a.rows(buf)[k], ring_b.rows(buf)[k], ring_a.imms(buf)[k],
              ring_b.imms(buf)[k]};
}

template <class Mode, class Sink>
__device__ __forceinline__ void run_turn(const Mode& m, Sink& sink,
                                         const Turn& t, unsigned char* regs_a,
                                         unsigned char* regs_b,
                                         const float* tvars, int lanes) {
  using Val = typename Mode::Val;
  const Val a0 = m.load(regs_a, t.a.a, t.ia);
  const Val a1 = m.load(regs_a, t.a.b, t.ia);
  const Val b0 = m.load(regs_b, t.b.a, t.ib);
  const Val b1 = m.load(regs_b, t.b.b, t.ib);
  const Val ya = row_value(m, sink, t.a, a0, a1, tvars, lanes);
  const Val yb = row_value(m, sink, t.b, b0, b1, tvars, lanes);
  m.store(regs_a, t.a.out, ya);
  m.store(regs_b, t.b.out, yb);
}

// Turns [0, count) of one decoded buffer of both rings, two a loop turn,
// each loaded while the other runs, as float_rows.cuh `run_rows` walks
// one stream; the slot past `count` is read and never run.
template <class Mode, class Sink>
__device__ __forceinline__ void run_turns(const Mode& m, Sink& sink,
                                          const TapeRing& ring_a,
                                          const TapeRing& ring_b, int buf,
                                          int count, unsigned char* regs_a,
                                          unsigned char* regs_b,
                                          const float* tvars, int lanes) {
  Turn t0 = load_turn(ring_a, ring_b, buf, 0);
  for (int k = 0; k < count; k += 2) {
    const Turn t1 = load_turn(ring_a, ring_b, buf, k + 1);
    run_turn(m, sink, t0, regs_a, regs_b, tvars, lanes);
    if (k + 1 >= count) break;
    t0 = load_turn(ring_a, ring_b, buf, k + 2);
    run_turn(m, sink, t1, regs_a, regs_b, tvars, lanes);
  }
}

template <int R, bool SHARED>
__global__ void __launch_bounds__(BLOCK) interp_float2_kernel(
    const int32_t* __restrict__ w1a, const int32_t* __restrict__ w2a,
    const float* __restrict__ imma, const int32_t* __restrict__ w1b,
    const int32_t* __restrict__ w2b, const float* __restrict__ immb,
    const float* __restrict__ vars, float* __restrict__ out,
    float* __restrict__ scratch, int L, int nf, int V, int lanes,
    int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int lane = (blockIdx.y * BLOCK + threadIdx.x) * R;
  const float* tvars = vars + (size_t)t * V * lanes + lane;

  const TapeRing ring_a{smem, chunk};
  const TapeRing ring_b{ring_a.end(), chunk};
  unsigned char* regs_a;
  int stride;  // bytes from one register to the next
  if (SHARED) {
    regs_a = ring_b.end() + threadIdx.x * (R * 4);
    stride = BLOCK * R * 4;
  } else {
    regs_a = reinterpret_cast<unsigned char*>(
        scratch + (size_t)t * 2 * nf * lanes + lane);
    stride = lanes * 4;
  }
  unsigned char* regs_b = regs_a + (size_t)nf * stride;

  const Floats<R> mode{};
  for (int k = 0; k < nf; ++k) {
    mode.store(regs_a, k * stride, splat<R>(0.f));
    mode.store(regs_b, k * stride, splat<R>(0.f));
  }
  DropOutput<Floats<R>> sink;
  const size_t tape = (size_t)t * L;
  if (L > 0) {  // uniform across the block
    ring_a.fetch(w1a + tape, w2a + tape, imma + tape, 0, min(chunk, L));
    ring_b.fetch(w1b + tape, w2b + tape, immb + tape, 0, min(chunk, L));
    decode_rows(ring_a, 0, min(chunk, L), nf, stride, V);
    decode_rows(ring_b, 0, min(chunk, L), nf, stride, V);
    __syncthreads();
  }
  for (int j0 = 0, buf = 0; j0 < L; j0 += chunk, buf ^= 1) {
    const int count = min(chunk, L - j0);
    const int next = min(chunk, L - j0 - chunk);
    if (next > 0) {
      ring_a.fetch(w1a + tape, w2a + tape, imma + tape, j0 + chunk, next);
      ring_b.fetch(w1b + tape, w2b + tape, immb + tape, j0 + chunk, next);
    }
    run_turns(mode, sink, ring_a, ring_b, buf, count, regs_a, regs_b, tvars,
              lanes);
    if (next > 0) {
      decode_rows(ring_a, buf ^ 1, next, nf, stride, V);
      decode_rows(ring_b, buf ^ 1, next, nf, stride, V);
    }
    __syncthreads();
  }
  float* tout = out + (size_t)t * 2 * lanes + lane;
  store_pack<R>(tout, mode.load(regs_a, 0, 0.f));
  store_pack<R>(tout + lanes, mode.load(regs_b, 0, 0.f));
}

}  // namespace

// `r` lanes a thread (1, 2 or 4; lanes a multiple of BLOCK * r), `chunk`
// tape rows a ring buffer, `smem_bytes` of dynamic shared memory: the
// two rings, then the two register files unless `scratch` is given.
extern "C" int fidget_interp_float2(
    const int32_t* w1a, const int32_t* w2a, const float* imma,
    const int32_t* w1b, const int32_t* w2b, const float* immb,
    const float* vars, float* out, float* scratch, int T, int L, int nf,
    int V, int lanes, int r, int chunk, int smem_bytes, cudaStream_t stream) {
  if (T <= 0 || lanes <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || nf <= 0 || V <= 0 || L < 0 ||
      (r != 1 && r != 2 && r != 4) || lanes % (BLOCK * r) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t need =
      2 * tape_ring_bytes(chunk) +
      (scratch ? 0 : 2 * (size_t)nf * BLOCK * r * sizeof(float));
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  auto kernel = interp_float2_kernel<1, true>;
  if (scratch == nullptr) {
    if (r == 2) kernel = interp_float2_kernel<2, true>;
    if (r == 4) kernel = interp_float2_kernel<4, true>;
  } else {
    kernel = interp_float2_kernel<1, false>;
    if (r == 2) kernel = interp_float2_kernel<2, false>;
    if (r == 4) kernel = interp_float2_kernel<4, false>;
  }
  FIDGET_SET_SMEM(kernel, smem_bytes);
  dim3 grid(T, lanes / (BLOCK * r));
  kernel<<<grid, BLOCK, smem_bytes, stream>>>(w1a, w2a, imma, w1b, w2b, immb,
                                              vars, out, scratch, L, nf, V,
                                              lanes, chunk);
  return (int)cudaGetLastError();
}
