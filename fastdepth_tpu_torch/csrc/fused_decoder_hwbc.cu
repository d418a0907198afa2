// K2: the fused FastDepth decoder level over image groups, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// fastdepth_tpu/ops/pallas/fused_decoder.py::fused_decoder_stage_hwbc.
// The math is K1's (fused_decoder.cu): per image
//
//     dw5x5 (zero pad 2) + bias -> ReLU -> pw1x1 C->Cout + bias -> ReLU
//         -> nearest x2 upsample -> [+ skip]
//
// on NHWC memory, f32 or bf16 in, f32 accumulation, output in the input
// dtype.  The TPU kernel viewed activations as (N/B, H, W, B, C) only to
// keep Mosaic from relayouting the tap shifts; that layout means nothing
// here, so K2 reads and writes NHWC like K1.  What it keeps from the TPU
// kernel is the image group: a block holds the same 8x8 input tile of B
// images (block_batch), so each C-chunk of depthwise taps (registers) and
// pointwise weights (shared memory) loaded once serves B images, and the
// pointwise product has B x 64 rows instead of 64.
//
// What bounds it on the card: like K1, shared-memory instruction rate in the
// pointwise loop (one shared load per one to four FMAs) at the large
// levels; grouping raises the reuse of each pointwise-weight load by B.
// At the 7x7 levels the grid bounds it: with B = 8 at batch 8 there is
// one image group and one tile, so the only parallelism left is the Cout
// tiles.  The launch shrinks the Cout tile (down to 8) until the grid
// holds at least one block per SM or the tile is at its floor; each Cout
// tile recomputes the depthwise pass for all C, which is the price.
//
// A ragged last group (N not a multiple of B) is masked: missing images
// read as zero and are not written, so the result does not depend on B.
//
// Shared memory is dynamic: the pointwise chunk (32 x Cout tile), one
// image's 12x12 halo of the chunk, and the ReLU'd depthwise rows of all B
// images (B x 64 x 33 f32, 67.6 KB at B = 8).

#include "stage_common.cuh"

namespace {

using fdk::from_float;
using fdk::to_float;

constexpr int kTile = 8;          // input pixels per tile side
constexpr int kHalo = kTile + 4;  // 5x5 taps: 2 pixels of halo per side
constexpr int kChunk = 32;        // channels per pass over C
constexpr int kThreads = 256;
constexpr int kRows = kThreads / kChunk;

template <int kB, int kCoutTile>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kChunk * kCoutTile + kHalo * kHalo * kChunk +
                          kB * kTile * kTile * (kChunk + 1));
}

// kCoutTile output channels per block, 4 per thread; the B x 64 pixel rows
// are spread over the remaining thread dimension, kPx rows per thread.
template <typename T, int kB, int kCoutTile>
__global__ void __launch_bounds__(kThreads)
    fused_decoder_stage_hwbc_kernel(const T* __restrict__ x, const T* __restrict__ dw_w,
                                    const T* __restrict__ dw_b, const T* __restrict__ pw_w,
                                    const T* __restrict__ pw_b, const T* __restrict__ skip,
                                    T* __restrict__ out, int N, int H, int W, int C, int Cout,
                                    int tiles_w) {
  constexpr int kPix = kTile * kTile;
  constexpr int kGroupRows = kB * kPix;
  constexpr int kGroups = kCoutTile / 4;
  constexpr int kPixGroups = kThreads / kGroups;
  constexpr int kPx = kGroupRows / kPixGroups;
  static_assert(kPx >= 1 && kPx * kPixGroups == kGroupRows, "the rows must split evenly");

  extern __shared__ __align__(16) float smem[];
  float* s_pw = smem;                             // [kChunk][kCoutTile], 16-byte aligned
  float* s_halo = s_pw + kChunk * kCoutTile;      // [kHalo * kHalo][kChunk]
  float* s_dw = s_halo + kHalo * kHalo * kChunk;  // [kGroupRows][kChunk + 1]

  const int t = threadIdx.x;
  const int n0 = blockIdx.z * kB;
  const int co0 = blockIdx.y * kCoutTile;
  const int h0 = (blockIdx.x / tiles_w) * kTile;
  const int w0 = (blockIdx.x % tiles_w) * kTile;
  const int lane_c = t % kChunk;
  const int row = t / kChunk;
  const int cg = t % kGroups;
  const int pg = t / kGroups;

  float acc[kPx][4];
#pragma unroll
  for (int j = 0; j < kPx; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int c = c0 + lane_c;
    const bool c_ok = c < C;
    __syncthreads();  // the previous chunk's pointwise pass is done with shared memory

    for (int i = t; i < kChunk * kCoutTile; i += kThreads) {
      const int ci = i / kCoutTile;
      const int co = i % kCoutTile;
      float v = 0.f;
      if (c0 + ci < C && co0 + co < Cout)
        v = to_float(pw_w[static_cast<size_t>(c0 + ci) * Cout + co0 + co]);
      s_pw[i] = v;
    }
    float tap[25];
#pragma unroll
    for (int k = 0; k < 25; ++k) tap[k] = c_ok ? to_float(dw_w[k * C + c]) : 0.f;
    const float bias = c_ok ? to_float(dw_b[c]) : 0.f;

    // one image at a time through the halo; the depthwise rows of all B
    // images stay in shared memory for the pointwise pass
    for (int b = 0; b < kB; ++b) {
      const int n = n0 + b;
      if (b > 0) __syncthreads();  // the previous image's stencil is done with the halo
      const T* xn = x + static_cast<size_t>(n) * H * W * C;
      for (int q = row; q < kHalo * kHalo; q += kRows) {
        const int h = h0 - 2 + q / kHalo;
        const int w = w0 - 2 + q % kHalo;
        float v = 0.f;
        if (c_ok && n < N && h >= 0 && h < H && w >= 0 && w < W)
          v = to_float(xn[(static_cast<size_t>(h) * W + w) * C + c]);
        s_halo[q * kChunk + lane_c] = v;
      }
      __syncthreads();
      for (int p = row; p < kPix; p += kRows) {
        const int py = p / kTile;
        const int px = p % kTile;
        float s = 0.f;
#pragma unroll
        for (int dy = 0; dy < 5; ++dy)
#pragma unroll
          for (int dx = 0; dx < 5; ++dx)
            s = fmaf(s_halo[((py + dy) * kHalo + px + dx) * kChunk + lane_c], tap[dy * 5 + dx], s);
        s_dw[(b * kPix + p) * (kChunk + 1) + lane_c] = fmaxf(s + bias, 0.f);
      }
    }
    __syncthreads();

    const int depth = min(kChunk, C - c0);
    for (int ci = 0; ci < depth; ++ci) {
      const float4 wv = *reinterpret_cast<const float4*>(&s_pw[ci * kCoutTile + cg * 4]);
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const float a = s_dw[(pg + j * kPixGroups) * (kChunk + 1) + ci];
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
    const int r = pg + j * kPixGroups;
    const int n = n0 + r / kPix;
    const int p = r % kPix;
    const int h = h0 + p / kTile;
    const int w = w0 + p % kTile;
    if (n >= N || h >= H || w >= W) continue;
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
          float rv = v;
          if (skip != nullptr) rv += to_float(skip[o]);
          out[o] = from_float<T>(rv);
        }
    }
  }
}

template <typename T, int kB, int kCoutTile>
cudaError_t launch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                   const void* pw_b, const void* skip, void* out, int N, int H, int W, int C,
                   int Cout, cudaStream_t stream) {
  const int tiles_w = fd_ceil_div(W, kTile);
  const dim3 grid(fd_ceil_div(H, kTile) * tiles_w, fd_ceil_div(Cout, kCoutTile),
                  fd_ceil_div(N, kB));
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<kB, kCoutTile>();
  auto kernel = fused_decoder_stage_hwbc_kernel<T, kB, kCoutTile>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw_w), static_cast<const T*>(dw_b),
      static_cast<const T*>(pw_w), static_cast<const T*>(pw_b), static_cast<const T*>(skip),
      static_cast<T*>(out), N, H, W, C, Cout, tiles_w);
  return cudaGetLastError();
}

// The Cout tile: the smallest power of two >= Cout, within [8, 64], and at
// most 128 / B (at most 32 accumulators a thread) and at least 16 / B (one
// row a thread).  Then halved while the grid holds fewer blocks than the
// card has SMs.
int cout_tile(int N, int H, int W, int Cout, int B) {
  int tile = fd_pow2_ceil(Cout);
  tile = tile < 8 ? 8 : (tile > 64 ? 64 : tile);
  if (tile > 128 / B) tile = 128 / B;
  const int floor_tile = 16 / B > 8 ? 16 / B : 8;
  if (tile < floor_tile) tile = floor_tile;
  const long long fixed = static_cast<long long>(fd_ceil_div(H, kTile)) * fd_ceil_div(W, kTile) *
                          fd_ceil_div(N, B);
  const int sms = fd_sm_count();
  while (tile > floor_tile && fixed * fd_ceil_div(Cout, tile) < sms) tile /= 2;
  return tile;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                     const void* pw_b, const void* skip, void* out, int N, int H, int W, int C,
                     int Cout, int B, cudaStream_t stream) {
  if (B != 1 && B != 2 && B != 4 && B != 8) return cudaErrorInvalidValue;
  const int tile = cout_tile(N, H, W, Cout, B);
#define FD_HWBC(b, t)                                                                       \
  if (B == b && tile == t)                                                                  \
    return launch<T, b, t>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, H, W, C, Cout, stream);
  FD_HWBC(1, 16) FD_HWBC(1, 32) FD_HWBC(1, 64)
  FD_HWBC(2, 8) FD_HWBC(2, 16) FD_HWBC(2, 32) FD_HWBC(2, 64)
  FD_HWBC(4, 8) FD_HWBC(4, 16) FD_HWBC(4, 32)
  FD_HWBC(8, 8) FD_HWBC(8, 16)
#undef FD_HWBC
  return cudaErrorInvalidValue;
}

}  // namespace

// As fd_fused_decoder_stage (fused_decoder.cu), plus B, the images per
// block: 1, 2, 4 or 8.  Launches on `stream` and returns the launch's
// cudaError_t (0 = success); it neither allocates nor syncs.
extern "C" int fd_fused_decoder_stage_hwbc(const void* x, const void* dw_w, const void* dw_b,
                                           const void* pw_w, const void* pw_b, const void* skip,
                                           void* out, int N, int H, int W, int C, int Cout,
                                           int B, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          dispatch<float>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, H, W, C, Cout, B, s));
    case 1:
      return static_cast<int>(dispatch<__nv_bfloat16>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N,
                                                      H, W, C, Cout, B, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
