// Voxel-depth tape interpreter: float evaluation over one subtile's
// voxels fused with the per-column depth reduction.
//
// Replaces the TPU kernel fidget_tpu/eval/pallas_interp.py
// `_interp_voxel_depth_impl` (pallas_call at :453), the voxel pass of
// the 3D renderer. Semantics: instance t is one sub^3 subtile whose
// lanes are its voxels in (vz, vy, vx) row-major order (vars is
// [T, V, sub^3]); it walks its tape for min(lengths[t], L) steps, and
// the distance of a voxel is the `a` operand of the tape's last OUTPUT
// (+1.0 when the tape has none, so a culled length-0 subtile is empty).
// Output is int32 [T, pp_out, 128]: column c = vy * sub + vx sits at
// plane c / 128, lane c % 128, and holds max over vz of
// (distance < 0 ? vz + 1 : 0) (the "deepest interior voxel" rule of
// fidget-raster/src/voxel.rs:443-445); a NaN distance is not inside.
// Planes past sub^2 / 128 (padding up to pp_out) are 0. `order`, when
// not null, is the position -> canonical opcode table of a renumbered
// arena.
//
// What bounds it on an H100. The 3D path hands it T = 1,024 subtiles of
// 4,096 voxels (about 600 of them live) and child tapes of at most 28
// rows. One thread per column walking the tape once per vz, decoding
// every row from device memory each time, was issue-bound like K3's
// first loop (0.27 ms against a 0.0074 ms slot bound). The design is
// K3's, with the subtile's slices walked in passes:
//   - a thread owns R = 4 (2, 1) neighbouring lanes of one slice, so
//     inputs, register file and operands move as 16-byte vectors; the
//     row loop is float_rows.cuh's, with an output sink that keeps the
//     distance in registers (`KeepOutput`) instead of storing it;
//   - a block covers `cb` columns of its subtile over every vz, S =
//     BLOCK * R / cb slices a pass, sub / S passes; a tape that fits one
//     ring chunk is staged and decoded once and run every pass, a longer
//     one streams through the ring each pass. `launch_geometry` takes the
//     fewest columns that still give a block two passes (sub 16 at R =
//     4: 64 columns, 8 slices a pass, 4 blocks a subtile): more,
//     shorter blocks overlap each other's latencies, and one block a
//     subtile of 8 passes (4-5 live blocks an SM) took 0.092 ms of device
//     time against 0.070 on an H100;
//   - the depth of a column is folded in registers across passes (vz
//     only grows), then across the slices of a pass through shared
//     memory, and written once per column by the live blocks, which
//     also write the padding planes;
//   - the register file is [nf][BLOCK * R] floats of shared memory at
//     the nf the caller names (the tape's registers on the 3D path), or
//     a global scratch [block][reg][lane] where no shared memory holds
//     it.
// What bounds it now: the row loop's shared-memory traffic and issue, as
// in K3, with the tape's sin/cos rows at R times a polynomial each, and
// the latency of each pass's input loads; the inputs (12 bytes a voxel
// for x, y, z) are the byte bound. Lanes per thread, columns a block,
// chunk, shared-memory bytes and the route come from `launch_geometry`
// in fidget_tpu_torch/eval/cuda.py.

#include <cuda_runtime.h>

#include "float_rows.cuh"

using namespace fidget;

namespace {

template <int R>
struct alignas(4 * R) IPack {
  int32_t v[R];
};

// one pass's distances into the depths of the thread's columns: vz only
// grows from pass to pass, so the last inside slice is the deepest
template <int R>
__device__ __forceinline__ void fold_pass(IPack<R>& depth,
                                          const Pack<R>& dist, int vz) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (dist.v[i] < 0.f) depth.v[i] = vz + 1;
}

template <int R, bool SHARED>
__global__ void __launch_bounds__(BLOCK) interp_voxel_depth_kernel(
    const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
    const float* __restrict__ imm, const int32_t* __restrict__ lengths,
    const float* __restrict__ vars, int32_t* __restrict__ out,
    float* __restrict__ scratch, const int32_t* __restrict__ order, int L,
    int nf, int V, int sub, int pp_out, int chunk, int cb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = BLOCK * R;  // lanes of one pass
  const int t = blockIdx.x;
  const int cols = sub * sub;
  const int lanes = cols * sub;
  // a block's cb columns over every vz: S slices a pass
  const int S = P / cb;
  const int l = threadIdx.x * R;  // the thread's first lane in a pass
  const int s = l / cb;           // its slice within a pass
  const int col = blockIdx.y * cb + l % cb;
  // the thread of the lowest slice of its columns writes them
  const bool writer = s == 0;
  int32_t* tout = out + (size_t)t * pp_out * BLOCK;

  if (blockIdx.y == 0)  // padding planes
    for (int k = cols + threadIdx.x; k < pp_out * BLOCK; k += BLOCK)
      tout[k] = 0;
  const int n = min(lengths[t], L);
  if (n <= 0) {  // uniform across the block: a culled subtile
    if (writer) *reinterpret_cast<IPack<R>*>(tout + col) = IPack<R>{};
    return;
  }

  const TapeRing ring{smem, chunk};
  // the register file [nf][P], in shared memory or the block's scratch
  unsigned char* regs;
  if (SHARED) {
    regs = ring.end() + l * 4;
  } else {
    regs = reinterpret_cast<unsigned char*>(
        scratch + ((size_t)t * gridDim.y + blockIdx.y) * nf * P + l);
  }
  const int stride = P * 4;  // bytes from one register to the next
  const Staging st{order, nf, stride, V, 1};
  const int32_t* tw1 = w1 + (size_t)t * L;
  const int32_t* tw2 = w2 + (size_t)t * L;
  const float* timm = imm + (size_t)t * L;
  // pass p runs slices p * S ... p * S + S - 1
  const float* tvars = vars + (size_t)t * V * lanes + s * cols + col;
  const int span = S * cols;  // lanes from one pass to the next
  const Floats<R> mode{};

  IPack<R> d{};
  if (n <= chunk) {
    ring.fetch(tw1, tw2, timm, 0, n);
    ring.decode(0, n, order, nf, stride, V, 1, 0);
    __syncthreads();
    for (int p = 0; p < sub / S; ++p) {
      KeepOutput<Floats<R>> sink{splat<R>(1.0f)};
      run_rows(mode, sink, ring.rows(0), ring.imms(0), n, regs,
               tvars + (size_t)p * span, lanes);
      fold_pass(d, sink.v, p * S + s);
    }
  } else {
    for (int p = 0; p < sub / S; ++p) {
      KeepOutput<Floats<R>> sink{splat<R>(1.0f)};
      run_tape(mode, sink, ring, st, tw1, tw2, timm, n, regs,
               tvars + (size_t)p * span, lanes);
      fold_pass(d, sink.v, p * S + s);
    }
  }

  if (S > 1) {  // fold the slices of a pass into the lowest
    int32_t* slices = reinterpret_cast<int32_t*>(
        ring.end() + (SHARED ? (size_t)nf * P * 4 : 0));
    *reinterpret_cast<IPack<R>*>(slices + l) = d;
    __syncthreads();
    if (writer)
      for (int k = cb; k < P; k += cb) {
        const IPack<R> o = *reinterpret_cast<const IPack<R>*>(slices + k + l);
#pragma unroll
        for (int i = 0; i < R; ++i) d.v[i] = max(d.v[i], o.v[i]);
      }
  }
  if (writer) *reinterpret_cast<IPack<R>*>(tout + col) = d;
}

}  // namespace

// `r` lanes a thread (1, 2 or 4), `cb` columns a block (dividing sub^2
// and BLOCK * r, the BLOCK * r / cb slices of a pass dividing sub),
// `chunk` tape rows a ring buffer, `smem_bytes` of dynamic shared
// memory: the ring, the register file unless `scratch` is given
// ([T * sub^2 / cb, nf, BLOCK * r] floats), and, when a pass spans
// several slices, BLOCK * r ints to fold them.
extern "C" int fidget_interp_voxel_depth(
    const int32_t* w1, const int32_t* w2, const float* imm,
    const int32_t* lengths, const float* vars, int32_t* out, float* scratch,
    const int32_t* order, int T, int L, int nf, int V, int sub, int pp_out,
    int r, int cb, int chunk, int smem_bytes, cudaStream_t stream) {
  if (T <= 0) return (int)cudaSuccess;
  const int cols = sub * sub, P = BLOCK * r;
  if (cols % BLOCK != 0 || pp_out * BLOCK < cols || chunk <= 0 ||
      (r != 1 && r != 2 && r != 4) || cb < r || cb % r != 0 ||
      cols % cb != 0 || P % cb != 0 || sub % (P / cb) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t need = tape_ring_bytes(chunk) +
                      (scratch ? 0 : (size_t)nf * P * sizeof(float)) +
                      (P > cb ? (size_t)P * sizeof(int32_t) : 0);
  if ((size_t)smem_bytes < need) return (int)cudaErrorInvalidValue;
  auto kernel = interp_voxel_depth_kernel<1, true>;
  if (scratch == nullptr) {
    if (r == 2) kernel = interp_voxel_depth_kernel<2, true>;
    if (r == 4) kernel = interp_voxel_depth_kernel<4, true>;
  } else {
    kernel = interp_voxel_depth_kernel<1, false>;
    if (r == 2) kernel = interp_voxel_depth_kernel<2, false>;
    if (r == 4) kernel = interp_voxel_depth_kernel<4, false>;
  }
  FIDGET_SET_SMEM(kernel, smem_bytes);
  dim3 grid(T, cols / cb);
  kernel<<<grid, BLOCK, smem_bytes, stream>>>(
      w1, w2, imm, lengths, vars, out, scratch, order, L, nf, V, sub, pp_out,
      chunk, cb);
  return (int)cudaGetLastError();
}
