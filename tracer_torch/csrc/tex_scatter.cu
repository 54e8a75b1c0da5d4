// Texture-gradient scatter for Hopper (sm_90a).
//
// Replaces the TPU kernel tracer/pallas/tex_scatter.py:_scatter_kernel
// (texture_image_grads_kernel) and computes what it computes: the texture
// image's cotangent from the backward kernel's per-bounce texel
// cotangents. The bilinear fetch is texel = sum_k w_k(fu, fv) * tex[corner
// k], so its transpose adds w_k * g to each of the four corners, with the
// fetch's neighbour wrap (tracer/pallas/bwd.py:648-649).
//
// Design: one thread per (tape row, pixel) slot, a plain atomicAdd of the
// four weighted corners for each of the three channels. Slots whose
// cotangent is zero in every channel (untextured hits, misses, bounces the
// path never reached) skip the atomics. The TPU kernel's write-back block
// cache and one-hot matrix products exist to make a sequential grid
// scatter fast; the card's L2 atomics do that here.
//
// What bounds it on this card: bytes. It reads 7 floats per slot (3
// cotangents, 4 addressing fields: 28 bytes) and does ~40 FP32 operations
// on them; the output image is small and stays in L2, where atomics to a
// texel shared by many slots serialise. Atomic order varies from run to
// run, so sums agree with a plain scatter up to float32 addition order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256) scatter_kernel(
    const float* __restrict__ gtex,  // [3, rows, P] channel-major
    const float* __restrict__ addr,  // [4, rows, P]: x0, y0, fu, fv
    long long rows, long long npx, int th, int tw, float* __restrict__ out) {
  const long long slots = rows * npx;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < slots;
       k += (long long)gridDim.x * blockDim.x) {
    const float g0 = __ldg(gtex + k), g1 = __ldg(gtex + slots + k),
                g2 = __ldg(gtex + 2 * slots + k);
    if (g0 == 0.0f && g1 == 0.0f && g2 == 0.0f) continue;
    const int x0 = (int)__ldg(addr + k);
    const int y0 = (int)__ldg(addr + slots + k);
    const float fu = __ldg(addr + 2 * slots + k);
    const float fv = __ldg(addr + 3 * slots + k);
    const int x1 = x0 + 1 < tw ? x0 + 1 : 0;  // neighbour wrap
    const int y1 = y0 + 1 < th ? y0 + 1 : 0;
    const int ys[4] = {y0, y0, y1, y1};
    const int xs[4] = {x0, x1, x0, x1};
    const float ws[4] = {(1.0f - fu) * (1.0f - fv), fu * (1.0f - fv), (1.0f - fu) * fv,
                         fu * fv};
    for (int c = 0; c < 4; ++c) {
      float* px = out + ((size_t)ys[c] * tw + xs[c]) * 3;
      atomicAdd(px + 0, ws[c] * g0);
      atomicAdd(px + 1, ws[c] * g1);
      atomicAdd(px + 2, ws[c] * g2);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes by tracer_torch/kernels/tex_scatter.py.
// `out` [th, tw, 3] comes zeroed. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int tracer_tex_scatter(const float* gtex, const float* addr, long long rows,
                                  long long npx, int th, int tw, float* out, int threads,
                                  void* stream) {
  const long long slots = rows * npx;
  long long blocks = (slots + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  if (blocks < 1) blocks = 1;
  scatter_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      gtex, addr, rows, npx, th, tw, out);
  return static_cast<int>(cudaGetLastError());
}
