// K6: one image staged into shared memory, then one piece of the decoder
// stage's compute, for Hopper (sm_90a).
//
// Replaces the Pallas TPU probe kernels that copied one image at a time
// into VMEM and ran one op of the stage on it: scripts/bisect_v3c.py
// make_kernel (through `run`; modes matmul, matmul_up, taps, up_only) and
// scripts/bisect_v3d.py dma_matmul (mode matmul).  Per image of an NHWC
// f32 input x (N, H, W, C):
//
//   matmul     out (H, W, Cout) = x @ w, w (C, Cout)
//   matmul_up  the same, each output pixel written to its 2x2 block
//   taps       out (H, W, C) = sum over dw (outer) and dh (inner) of the
//              zero-padded (pad 2 of this image's tile, not a halo from
//              the neighbouring image) x[h + dh - 2, w + dw - 2] * 0.04,
//              each product rounded and added in that order, as the
//              script's loop does
//   up_only    out (2H, 2W, C): nearest x2
//
// The kernel computes its own products (f32 FMAs on the CUDA cores, the
// sum over C in order); no library call.
//
// One block per image, as the script's one program took one image per
// loop step through one slot: the image's H x W x C tile is copied into
// shared memory (cp.async 16-byte copies when C fills whole 16-byte words
// and the pointers are 16-byte aligned, element loads otherwise), then the
// block's threads walk the outputs, neighbouring threads on neighbouring
// channels, so the pointwise weights are read as whole rows and the tile
// as broadcasts.
//
// What bounds it on the card: at the probes' shapes (8x8 images, C up to
// 256, N = 4) nothing but latency: four blocks on a 132-SM card, each
// copying one 16-64 KB tile and running a few hundred FMAs a thread.  It
// is a check of the staging pattern and of each op, not a rate.

#include "stage_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMatmul = 0, kMatmulUp = 1, kTaps = 2, kUpOnly = 3;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    staged_compute_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          float* __restrict__ out, int H, int W, int C, int Cout, int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tile = reinterpret_cast<float*>(smem_raw);  // [H][W][C]
  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int pix = H * W;
  const float* xi = x + static_cast<size_t>(n) * pix * C;
  if (kVec) {
    for (int v = t; v < pix * C / 4; v += kThreads) fdk::cp_async16(tile + 4 * v, xi + 4 * v, true);
    fdk::cp_async_commit();
    fdk::cp_async_wait<0>();
  } else {
    for (int i = t; i < pix * C; i += kThreads) tile[i] = xi[i];
  }
  __syncthreads();

  if (mode == kMatmul || mode == kMatmulUp) {
    const int H2 = 2 * H, W2 = 2 * W;
    for (int o = t; o < pix * Cout; o += kThreads) {
      const int p = o / Cout, co = o % Cout;
      const float* xp = tile + p * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc = fmaf(xp[c], __ldg(w + static_cast<size_t>(c) * Cout + co), acc);
      if (mode == kMatmul) {
        out[(static_cast<size_t>(n) * pix + p) * Cout + co] = acc;
      } else {
        const int h = p / W, wc = p % W;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
            out[((static_cast<size_t>(n) * H2 + 2 * h + dy) * W2 + 2 * wc + dx) * Cout + co] = acc;
      }
    }
  } else if (mode == kTaps) {
    for (int o = t; o < pix * C; o += kThreads) {
      const int p = o / C, c = o % C;
      const int h = p / W, wc = p % W;
      float acc = 0.f;
      for (int dw = 0; dw < 5; ++dw) {
        const int ww = wc + dw - 2;
        for (int dh = 0; dh < 5; ++dh) {
          const int hh = h + dh - 2;
          const float v = (hh >= 0 && hh < H && ww >= 0 && ww < W) ? tile[(hh * W + ww) * C + c] : 0.f;
          acc = __fadd_rn(acc, __fmul_rn(v, 0.04f));
        }
      }
      out[static_cast<size_t>(n) * pix * C + o] = acc;
    }
  } else {  // kUpOnly
    const int W2 = 2 * W;
    for (int o = t; o < 4 * pix * C; o += kThreads) {
      const int c = o % C, q = o / C;
      const int oh = q / W2, ow = q % W2;
      out[static_cast<size_t>(n) * 4 * pix * C + o] = tile[((oh / 2) * W + ow / 2) * C + c];
    }
  }
}

}  // namespace

// x (N, H, W, C) and out dense f32 (NHWC); w (C, Cout) dense f32, read in
// the matmul modes only; mode: 0 matmul, 1 matmul_up, 2 taps (Cout == C),
// 3 up_only (Cout == C).  Launches one block per image on `stream` and
// returns the launch's cudaError_t (0 = success); it neither allocates nor
// syncs.
extern "C" int fd_staged_compute(const void* x, const void* w, void* out, int N, int H, int W,
                                 int C, int Cout, int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || mode < kMatmul || mode > kUpOnly)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((mode == kTaps || mode == kUpOnly) && Cout != C) return static_cast<int>(cudaErrorInvalidValue);
  if ((mode == kMatmul || mode == kMatmulUp) && w == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(H) * W * C * sizeof(float);
  const bool vec = C % 4 == 0 && fd_aligned16(x);
  auto kernel = vec ? &staged_compute_kernel<true> : &staged_compute_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<N, kThreads, smem, s>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                   static_cast<float*>(out), H, W, C, Cout, mode);
  return static_cast<int>(cudaGetLastError());
}
