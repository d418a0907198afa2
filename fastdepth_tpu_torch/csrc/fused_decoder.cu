// K1: one FastDepth NNConv5(dw) decoder level, fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fastdepth_tpu/ops/pallas/fused_decoder.py::fused_decoder_stage.
// Per image it computes
//
//     dw5x5 (zero pad 2, stride 1) + bias -> ReLU -> pw1x1 C->Cout + bias
//         -> ReLU -> nearest x2 upsample -> [+ skip]
//
// on NHWC memory (the port's channels_last tensors), f32 or bf16 in, f32
// accumulation, output in the input dtype.  There is no ReLU after the
// skip-add.
//
// What bounds it on the card: per image, the pruned flagship's stages do
// 11 / 22 / 58 / 61 / 58 MFLOP over 0.26 / 1.8 / 3.8 / 7.1 / 6.0 MB of
// input, skip and output in f32 — 44, 12.5, 15, 8.6 and 9.6 FLOP per byte.
// The H100's f32 ridge outside the tensor cores is about 20 FLOP per byte
// (67 TFLOP/s over 3.35 TB/s), so on the roofline stages 2-5 are
// memory-bound and stage 1 (7x7, 512 -> 200) leans on the arithmetic.
// This first version reaches neither roof: measured on an H100 SXM
// (700 W) at batch 128 it moves about 0.65 TB/s and does about 7 TFLOP/s,
// and bf16 runs no faster than f32.  Its inner loops execute one
// shared-memory load for every one to four FMAs, so shared-memory traffic
// bounds it; tensor-core pointwise and register-blocked taps are the next
// step.  What the design does about the bytes: the depthwise and
// pointwise intermediates never touch device memory.
//
// A block owns one image's 8x8 input tile (a 16x16 output tile) and a
// tile of Cout, and walks C in chunks of 32 channels: the zero-padded
// 12x12 halo goes to shared memory, the 25-tap stencil writes the ReLU'd
// depthwise tile to shared memory, and every thread accumulates a block
// of PX pixels x 4 output channels of the pointwise product in registers.
// The epilogue adds the bias, applies ReLU and writes each pixel as a 2x2
// block, adding the skip on the way out.  Device memory sees the input,
// the weights, the skip and the output, nothing else.
//
// Left for later: the pointwise product on tensor cores (wgmma), TMA
// loads, vectorised stores, and reading each input tile once for all
// Cout tiles.

#include "stage_common.cuh"

namespace {

using fdk::from_float;
using fdk::to_float;

constexpr int kTile = 8;              // input pixels per tile side
constexpr int kHalo = kTile + 4;      // 5x5 taps: 2 pixels of halo per side
constexpr int kChunk = 32;            // channels per pass over C
constexpr int kThreads = 256;
constexpr int kRows = kThreads / kChunk;

// kCoutTile output channels per block, 4 per thread; the 64 pixels of the
// tile are spread over the remaining thread dimension.
template <typename T, int kCoutTile>
__global__ void __launch_bounds__(kThreads)
    fused_decoder_stage_kernel(const T* __restrict__ x, const T* __restrict__ dw_w,
                               const T* __restrict__ dw_b, const T* __restrict__ pw_w,
                               const T* __restrict__ pw_b, const T* __restrict__ skip,
                               T* __restrict__ out, int H, int W, int C, int Cout,
                               int tiles_w) {
  constexpr int kGroups = kCoutTile / 4;
  constexpr int kPixGroups = kThreads / kGroups;
  constexpr int kPx = kTile * kTile / kPixGroups;
  static_assert(kPx * kPixGroups == kTile * kTile, "the tile must split evenly");

  __shared__ float s_halo[kHalo * kHalo][kChunk];
  __shared__ float s_dw[kTile * kTile][kChunk + 1];  // +1: no bank conflicts
  __shared__ __align__(16) float s_pw[kChunk][kCoutTile];

  const int t = threadIdx.x;
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * kCoutTile;
  const int h0 = (blockIdx.x / tiles_w) * kTile;
  const int w0 = (blockIdx.x % tiles_w) * kTile;
  const int lane_c = t % kChunk;  // the channel this thread loads and convolves
  const int row = t / kChunk;
  const int cg = t % kGroups;     // this thread's 4 output channels
  const int pg = t / kGroups;     // and its pixels: pg + j * kPixGroups

  const T* xn = x + static_cast<size_t>(n) * H * W * C;

  float acc[kPx][4];
#pragma unroll
  for (int j = 0; j < kPx; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int c = c0 + lane_c;
    const bool c_ok = c < C;
    __syncthreads();  // the previous chunk's pointwise pass is done with shared memory

    // zero-padded halo: outside the image and past C it reads as 0
    for (int q = row; q < kHalo * kHalo; q += kRows) {
      const int h = h0 - 2 + q / kHalo;
      const int w = w0 - 2 + q % kHalo;
      float v = 0.f;
      if (c_ok && h >= 0 && h < H && w >= 0 && w < W)
        v = to_float(xn[(static_cast<size_t>(h) * W + w) * C + c]);
      s_halo[q][lane_c] = v;
    }
    for (int i = t; i < kChunk * kCoutTile; i += kThreads) {
      const int ci = i / kCoutTile;
      const int co = i % kCoutTile;
      float v = 0.f;
      if (c0 + ci < C && co0 + co < Cout)
        v = to_float(pw_w[static_cast<size_t>(c0 + ci) * Cout + co0 + co]);
      s_pw[ci][co] = v;
    }
    float tap[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) tap[k] = c_ok ? to_float(dw_w[k * C + c]) : 0.f;
    const float bias = c_ok ? to_float(dw_b[c]) : 0.f;
    __syncthreads();

    // depthwise 5x5 + bias + ReLU into shared memory (channels past C give 0)
    for (int p = row; p < kTile * kTile; p += kRows) {
      const int py = p / kTile;
      const int px = p % kTile;
      float s = 0.f;
#pragma unroll
      for (int dy = 0; dy < 5; ++dy)
#pragma unroll
        for (int dx = 0; dx < 5; ++dx)
          s = fmaf(s_halo[(py + dy) * kHalo + px + dx][lane_c], tap[dy * 5 + dx], s);
      s_dw[p][lane_c] = fmaxf(s + bias, 0.f);
    }
    __syncthreads();

    // pointwise partial product over this chunk, in registers
    const int depth = min(kChunk, C - c0);
    for (int ci = 0; ci < depth; ++ci) {
      const float4 wv = *reinterpret_cast<const float4*>(&s_pw[ci][cg * 4]);
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const float a = s_dw[pg + j * kPixGroups][ci];
        acc[j][0] = fmaf(a, wv.x, acc[j][0]);
        acc[j][1] = fmaf(a, wv.y, acc[j][1]);
        acc[j][2] = fmaf(a, wv.z, acc[j][2]);
        acc[j][3] = fmaf(a, wv.w, acc[j][3]);
      }
    }
  }

  // epilogue: + bias, ReLU, each pixel as a 2x2 block, + skip
  const size_t H2 = 2 * static_cast<size_t>(H);
  const size_t W2 = 2 * static_cast<size_t>(W);
#pragma unroll
  for (int j = 0; j < kPx; ++j) {
    const int p = pg + j * kPixGroups;
    const int h = h0 + p / kTile;
    const int w = w0 + p % kTile;
    if (h >= H || w >= W) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int co = co0 + cg * 4 + k;
      if (co >= Cout) continue;
      const float v = fmaxf(acc[j][k] + to_float(pw_b[co]), 0.f);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const size_t o = ((n * H2 + 2 * h + dy) * W2 + 2 * w + dx) * Cout + co;
          float r = v;
          if (skip != nullptr) r += to_float(skip[o]);
          out[o] = from_float<T>(r);
        }
    }
  }
}

template <typename T, int kCoutTile>
cudaError_t launch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                   const void* pw_b, const void* skip, void* out, int N, int H, int W, int C,
                   int Cout, cudaStream_t stream) {
  const int tiles_h = (H + kTile - 1) / kTile;
  const int tiles_w = (W + kTile - 1) / kTile;
  const dim3 grid(tiles_h * tiles_w, (Cout + kCoutTile - 1) / kCoutTile, N);
  fused_decoder_stage_kernel<T, kCoutTile><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw_w), static_cast<const T*>(dw_b),
      static_cast<const T*>(pw_w), static_cast<const T*>(pw_b), static_cast<const T*>(skip),
      static_cast<T*>(out), H, W, C, Cout, tiles_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                     const void* pw_b, const void* skip, void* out, int N, int H, int W, int C,
                     int Cout, cudaStream_t stream) {
  if (Cout <= 16) return launch<T, 16>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, H, W, C, Cout, stream);
  if (Cout <= 32) return launch<T, 32>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, H, W, C, Cout, stream);
  return launch<T, 64>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, H, W, C, Cout, stream);
}

}  // namespace

// x (N,H,W,C); dw_w (25,C); dw_b (C); pw_w (C,Cout); pw_b (Cout);
// skip (N,2H,2W,Cout) or null; out (N,2H,2W,Cout); all dense, one dtype:
// dtype 0 = float32, 1 = bfloat16.  Launches on `stream` and returns the
// launch's cudaError_t (0 = success); it neither allocates nor syncs.
extern "C" int fd_fused_decoder_stage(const void* x, const void* dw_w, const void* dw_b,
                                      const void* pw_w, const void* pw_b, const void* skip,
                                      void* out, int N, int H, int W, int C, int Cout, int dtype,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          dispatch<float>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, H, W, C, Cout, s));
    case 1:
      return static_cast<int>(
          dispatch<__nv_bfloat16>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, H, W, C, Cout, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
