// The smallest kernel that does a block's work: one CTA a grid step.
//
// Replaces the Pallas probe demos/exp_grid_overhead.py `build` (kernel
// and pallas_call at :30-42), which times the fixed cost of a TPU grid
// step: x [T, 8, 128] f32 goes through T / G grid steps of one
// [G, 8, 128] block each, every element running v = v * 1.0001 + 0.5
// eight times. Here a grid step is a CTA: T / G CTAs of STEP_THREADS
// threads, each thread moving G 16-byte vectors of its CTA's block in
// and out. A CTA moves 8 KiB a tile and does 16 operations an element,
// so what bounds the work is its bytes (2 T 4 KiB over the card's
// memory rate); at small T / G the launch and the CTAs' own fixed costs
// come first, and they are what the probe measures
// (fidget_tpu_torch/demos/exp_grid_overhead.py). Each step of the body
// is a multiply, then an add, each rounded (__fmul_rn, __fadd_rn), as
// the plain PyTorch version computes it.

#include <cuda_runtime.h>

namespace {

constexpr int STEP_THREADS = 256;
constexpr int REPS = 8;
// float4s of one [8, 128] f32 tile
constexpr int TILE_VECS = 8 * 128 / 4;

__device__ __forceinline__ float step(float v) {
  return __fadd_rn(__fmul_rn(v, 1.0001f), 0.5f);
}

__global__ void __launch_bounds__(STEP_THREADS) grid_step_kernel(
    const float4* __restrict__ x, float4* __restrict__ y, int vecs) {
  const size_t base = (size_t)blockIdx.x * vecs;
  for (int k = threadIdx.x; k < vecs; k += STEP_THREADS) {
    float4 v = x[base + k];
#pragma unroll
    for (int i = 0; i < REPS; ++i) {
      v.x = step(v.x);
      v.y = step(v.y);
      v.z = step(v.z);
      v.w = step(v.w);
    }
    y[base + k] = v;
  }
}

}  // namespace

// x, y: [T, 8, 128] f32, 16-byte aligned; T / G CTAs of G tiles each.
extern "C" int fidget_grid_step(const float* x, float* y, int T, int G,
                                cudaStream_t stream) {
  if (T <= 0) return (int)cudaSuccess;
  if (G <= 0 || T % G != 0) return (int)cudaErrorInvalidValue;
  grid_step_kernel<<<T / G, STEP_THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
      G * TILE_VECS);
  return (int)cudaGetLastError();
}
