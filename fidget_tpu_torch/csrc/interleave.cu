// Two-stream float interpreter: two packed tapes and two register files
// per instance.
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
// What bounds it. Not bytes or operations: a row moves 12 bytes of
// shared memory a lane (two operand loads, one store) and does one
// operation, so the floor is the shared-memory traffic of the register
// files. What held the first port back was the opcode dispatch: one
// branch tree a row, uniform across the warp but serial, and two of
// them a turn when one warp walked both streams.
//
// Design (each part chosen by timing variants by turns on the card;
// PERF.md §6):
//   - A stream a block. Block (t, slice, s) walks stream s of instance t
//     over BLOCK * R lanes with its own TapeRing (ops.cuh: cp.async one
//     chunk ahead, decoded once per block) and its own register file, so
//     every warp walks one tape and issues one dispatch a row, and the
//     SM's schedulers interleave the warps of both streams as they do
//     any two blocks'. (Half a block a stream, each half on its own ring
//     and named barrier, measured 1.13-1.39x slower on an H100: at 4
//     lanes a thread its two files hold one block an SM, whose ring
//     prologue and chunk barriers no second block overlaps.) The
//     geometry's 128-row ring lets three blocks share an SM at the
//     probe's shapes where a 256-row one lets two.
//   - The dispatch out of the row. `decode_rows` gives every row a
//     control word from the wrapper's class table (demos/
//     exp_interleave.py `ROW_CLASSES`). ADD, SUB, MUL, MIN, MAX, COPY
//     and OUTPUT rows take one uniform branch, compare/select (MIN; MAX
//     with the compare turned round; COPY and OUTPUT as MIN of a with
//     itself) or arithmetic (the sum with b's sign from the word, or the
//     product, by a select); every other row goes to float_rows.cuh's
//     `row_value` switch. (No branch at all, selects over all five ops,
//     and a switch over the six classes measured slower.)
// The register file lies behind the ring in shared memory ([nf][BLOCK *
// R] floats) or, where it does not fit, in a global scratch
// [t][2][nf][lanes]. Lanes per thread, chunk, shared-memory bytes and
// the route come from `launch_geometry` in fidget_tpu_torch/eval/cuda.py.

#include <cuda_runtime.h>

#include "float_rows.cuh"

using namespace fidget;

namespace {

// A decoded row's control word (its Row::op_pay): C_SWITCH and the row's
// op_pay shifted up by one for a row of the switch; else the flags below
// (demos/exp_interleave.py `ROW_CLASSES` gives them per opcode).
constexpr int C_SWITCH = 1;
constexpr int C_MUL = 2;     // the product, not the sum
constexpr int C_MINMAX = 4;  // the compare/select
constexpr int C_MAX = 8;     // ... of MAX
constexpr int C_ALIAS = 16;  // b reads a's operand (COPY, OUTPUT)
constexpr int C_SIGN = (int)0x80000000;  // b's sign flipped (SUB)

// OUTPUT writes no plane: its operand lands only in the row's register
template <class Mode>
struct DropOutput {
  __device__ __forceinline__ void operator()(const Mode&, int,
                                             const typename Mode::Val&) {}
};

// Waits for this thread's copies and decodes them into buffer `buf` of
// `ring` (ops.cuh `stage_row` with the canonical order, an opcode past
// the switch becoming ATAN), the control word from `classes`.
__device__ __forceinline__ void decode_rows(const TapeRing& ring, int buf,
                                            int count, const int32_t* classes,
                                            int nf, int stride, int V) {
  cp_async_wait_all();
  for (int k = threadIdx.x; k < count; k += BLOCK) {
    int32_t w1 = ring.raw(0)[k];
    if ((w1 & 127) >= N_OPS) w1 = (w1 & ~127) | OP_ATAN;
    Row r = stage_row(w1, ring.raw(1)[k], nullptr, nf, stride, V, 1, 0);
    const int c = __ldg(classes + (w1 & 127));
    if (c & C_SWITCH) {
      r.op_pay = (r.op_pay << 1) | C_SWITCH;
    } else {
      if (c & C_ALIAS) r.b = r.a;
      r.op_pay = c;
    }
    ring.rows(buf)[k] = r;
    ring.imms(buf)[k] = __int_as_float(ring.raw(2)[k]);
  }
}

// One row on the thread's R lanes: both operand loads, the value, the
// store. MIN keeps a where a < b, MAX where b < a, and both keep a NaN
// a (any NaN stands for NaN), else b: ops.cuh's `f_binary`.
template <int R>
__device__ __forceinline__ void run_row2(const Floats<R>& m, const Row cur,
                                         float iv, unsigned char* regs,
                                         const float* tvars, int lanes) {
  const Pack<R> va = m.load(regs, cur.a, iv);
  const Pack<R> vb = m.load(regs, cur.b, iv);
  const int c = cur.op_pay;
  Pack<R> r;
  if (c & C_SWITCH) {
    DropOutput<Floats<R>> sink;
    r = row_value(m, sink, Row{c >> 1, cur.a, cur.b, cur.out}, va, vb, tvars,
                  lanes);
  } else if (c & C_MINMAX) {
    const bool mx = (c & C_MAX) != 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float a = va.v[i], b = vb.v[i];
      r.v[i] = ((mx ? (b < a) : (a < b)) || isnan(a)) ? a : b;
    }
  } else {
    const bool mul = (c & C_MUL) != 0;
    const int sign = c & C_SIGN;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float a = va.v[i], b = vb.v[i];
      const float sum = a + __int_as_float(__float_as_int(b) ^ sign);
      r.v[i] = mul ? a * b : sum;
    }
  }
  m.store(regs, cur.out, r);
}

// Rows [0, count) of one decoded buffer, two a turn, each loaded while
// the other runs, as float_rows.cuh `run_rows` walks them; the slot past
// `count` is read and never run.
template <int R>
__device__ __forceinline__ void run_rows2(const Floats<R>& m, const Row* rows,
                                          const float* imms, int count,
                                          unsigned char* regs,
                                          const float* tvars, int lanes) {
  Row row_a = rows[0];
  float imm_a = imms[0];
  for (int k = 0; k < count; k += 2) {
    const Row row_b = rows[k + 1];
    const float imm_b = imms[k + 1];
    run_row2(m, row_a, imm_a, regs, tvars, lanes);
    if (k + 1 >= count) break;
    row_a = rows[k + 2];
    imm_a = imms[k + 2];
    run_row2(m, row_b, imm_b, regs, tvars, lanes);
  }
}

template <int R, bool SHARED>
__global__ void __launch_bounds__(BLOCK) interp_float2_kernel(
    const int32_t* __restrict__ w1a, const int32_t* __restrict__ w2a,
    const float* __restrict__ imma, const int32_t* __restrict__ w1b,
    const int32_t* __restrict__ w2b, const float* __restrict__ immb,
    const int32_t* __restrict__ classes, const float* __restrict__ vars,
    float* __restrict__ out, float* __restrict__ scratch, int L, int nf,
    int V, int lanes, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x;
  const int s = blockIdx.z;  // the stream
  const int lane = (blockIdx.y * BLOCK + threadIdx.x) * R;
  const float* tvars = vars + (size_t)t * V * lanes + lane;
  const size_t tape = (size_t)t * L;
  const int32_t* w1 = (s ? w1b : w1a) + tape;
  const int32_t* w2 = (s ? w2b : w2a) + tape;
  const float* imm = (s ? immb : imma) + tape;

  const TapeRing ring{smem, chunk};
  unsigned char* regs;
  int stride;  // bytes from one register to the next
  if (SHARED) {
    regs = ring.end() + threadIdx.x * (R * 4);
    stride = BLOCK * R * 4;
  } else {
    regs = reinterpret_cast<unsigned char*>(
        scratch + ((size_t)t * 2 + s) * nf * lanes + lane);
    stride = lanes * 4;
  }

  const Floats<R> mode{};
  for (int k = 0; k < nf; ++k) mode.store(regs, k * stride, splat<R>(0.f));
  if (L > 0) {  // uniform across the grid
    ring.fetch(w1, w2, imm, 0, min(chunk, L));
    decode_rows(ring, 0, min(chunk, L), classes, nf, stride, V);
    __syncthreads();
  }
  for (int j0 = 0, buf = 0; j0 < L; j0 += chunk, buf ^= 1) {
    const int count = min(chunk, L - j0);
    const int next = min(chunk, L - j0 - chunk);
    if (next > 0) ring.fetch(w1, w2, imm, j0 + chunk, next);
    run_rows2(mode, ring.rows(buf), ring.imms(buf), count, regs, tvars,
              lanes);
    if (next > 0) decode_rows(ring, buf ^ 1, next, classes, nf, stride, V);
    __syncthreads();
  }
  store_pack<R>(out + ((size_t)t * 2 + s) * lanes + lane,
                mode.load(regs, 0, 0.f));
}

}  // namespace

// `classes`: the control word of each of the N_OPS opcodes; `r` lanes a
// thread (1, 2 or 4; lanes a multiple of BLOCK * r), `chunk` tape rows a
// ring buffer, `smem_bytes` of dynamic shared memory: the ring, then the
// register file unless `scratch` is given. A grid of T x lanes / (BLOCK
// * r) x 2 blocks, the last dimension the stream.
extern "C" int fidget_interp_float2(
    const int32_t* w1a, const int32_t* w2a, const float* imma,
    const int32_t* w1b, const int32_t* w2b, const float* immb,
    const int32_t* classes, const float* vars, float* out, float* scratch,
    int T, int L, int nf, int V, int lanes, int r, int chunk, int smem_bytes,
    cudaStream_t stream) {
  if (T <= 0 || lanes <= 0) return (int)cudaSuccess;
  if (classes == nullptr || chunk <= 0 || nf <= 0 || V <= 0 || L < 0 ||
      (r != 1 && r != 2 && r != 4) || lanes % (BLOCK * r) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t need = tape_ring_bytes(chunk) +
                      (scratch ? 0 : (size_t)nf * BLOCK * r * sizeof(float));
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
  dim3 grid(T, lanes / (BLOCK * r), 2);
  kernel<<<grid, BLOCK, smem_bytes, stream>>>(w1a, w2a, imma, w1b, w2b, immb,
                                              classes, vars, out, scratch, L,
                                              nf, V, lanes, chunk);
  return (int)cudaGetLastError();
}
