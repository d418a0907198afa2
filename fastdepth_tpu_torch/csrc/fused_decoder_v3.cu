// K3: the fused FastDepth decoder level as a persistent, double-buffered
// kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fastdepth_tpu/ops/pallas/fused_decoder.py::fused_decoder_stage_v3.  The
// math is K1's (fused_decoder.cu): per image
//
//     dw5x5 (zero pad 2) + bias -> ReLU -> pw1x1 C->Cout + bias -> ReLU
//         -> nearest x2 upsample -> [+ skip]
//
// on NHWC memory, f32 or bf16 in, f32 accumulation, output in the input
// dtype.  The TPU kernel ran one grid step that walked the batch through
// its own two-slot in/skip/out DMA pipeline, so that image i+1's copies
// overlapped image i's compute.  The Hopper counterpart: a persistent
// grid, as many blocks as fit on the card at once (the SM count times the
// blocks an SM holds), each walking work items (image group of B, 4x4
// input tile, Cout tile) with stride gridDim.x, through a two-slot
// cp.async ring in shared memory.  A ring stage is one (item, 32-channel
// chunk): its halo tile (B images x 8x8 pixels x 32 channels) and its
// pointwise-weight chunk; an item's first stage also brings the item's
// skip tile (B x 8x8 output pixels x the Cout tile).  While the block
// computes stage s, the copies of stage s+1 are in flight, across item
// boundaries too.  Outputs go straight from registers to device memory
// (stores do not stall the SM, so there is no out slot).
//
// What bounds it on the card: it is meant to hide load latency with few
// warps (one 4-warp block per SM slot), so its bound is the compute of
// each stage: the stencil and the pointwise loop on shared memory, as in
// K1, at a quarter of K1's tile (16 input pixels an image), which costs
// halo re-reads (8x8 loaded per 4x4 used) and more Cout-tile recompute.
// The small tile keeps two slots of halo and skip within shared memory
// (at most 217.6 KB, f32, B = 8).
//
// cp.async copies 16 bytes and needs 16-byte aligned addresses: the
// flagship's widths (512, 200, 256, 120, 56, 16 channels) give them.  Any
// other C or Cout takes the same ring with ordinary element loads into
// the slots (synchronous, masked) instead; there is no other path.
// Pixels outside the image, images past N (a ragged last group) and
// channels past C or Cout read as zero and are not written.

#include "stage_common.cuh"

namespace {

using fdk::from_float;
using fdk::to_float;

constexpr int kTile = 4;          // input pixels per tile side
constexpr int kHalo = kTile + 4;  // 8x8 halo for the 5x5 taps
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kPix = kTile * kTile;      // input pixels per image and tile
constexpr int kOutPix = 4 * kPix;        // its 8x8 output pixels
constexpr int kChunk = 32;               // channels per ring stage
constexpr int kThreads = 128;
constexpr int kRows = kThreads / kChunk;

template <typename T, int kB, int kCoutTile>
struct Layout {
  static constexpr int kHaloElems = kB * kHaloPix * kChunk;  // one slot
  static constexpr int kPwElems = kChunk * kCoutTile;
  static constexpr int kSkipElems = kB * kOutPix * kCoutTile;
  static constexpr int kDwFloats = kB * kPix * (kChunk + 1);
  static size_t bytes(bool has_skip) {
    return sizeof(T) * (2 * kHaloElems + 2 * kPwElems + (has_skip ? 2 * kSkipElems : 0)) +
           sizeof(float) * kDwFloats;
  }
};

struct Item {
  int n0, h0, w0, co0;
};

__device__ __forceinline__ Item decode(int item, int n_ct, int n_tiles, int tiles_w, int B,
                                       int cout_tile) {
  const int ct = item % n_ct;
  const int rest = item / n_ct;
  const int tile = rest % n_tiles;
  return Item{(rest / n_tiles) * B, (tile / tiles_w) * kTile, (tile % tiles_w) * kTile,
              ct * cout_tile};
}

// Start the copies of one ring stage into its slots: the halo of channels
// [c0, c0 + 32) for B images, the pointwise chunk, and (when s_skip is
// given) the item's skip tile.  Aligned operands go through cp.async;
// otherwise element loads.
template <typename T, int kB, int kCoutTile>
__device__ __forceinline__ void load_stage(const T* __restrict__ x, const T* __restrict__ pw_w,
                                           const T* __restrict__ skip, T* s_halo, T* s_pw,
                                           T* s_skip, Item it, int c0, int N, int H, int W, int C,
                                           int Cout, bool x_vec, bool co_vec) {
  constexpr int kV = 16 / sizeof(T);
  const int t = threadIdx.x;
  if (x_vec) {
    constexpr int kParts = kChunk / kV;
    for (int i = t; i < kB * kHaloPix * kParts; i += kThreads) {
      const int part = i % kParts;
      const int q = (i / kParts) % kHaloPix;
      const int b = i / (kParts * kHaloPix);
      const int n = it.n0 + b, h = it.h0 - 2 + q / kHalo, w = it.w0 - 2 + q % kHalo;
      const int c = c0 + part * kV;
      const bool ok = n < N && h >= 0 && h < H && w >= 0 && w < W && c < C;
      const T* src = ok ? x + ((static_cast<size_t>(n) * H + h) * W + w) * C + c : x;
      fdk::cp_async16(s_halo + (b * kHaloPix + q) * kChunk + part * kV, src, ok);
    }
  } else {
    for (int i = t; i < kB * kHaloPix * kChunk; i += kThreads) {
      const int ci = i % kChunk;
      const int q = (i / kChunk) % kHaloPix;
      const int b = i / (kChunk * kHaloPix);
      const int n = it.n0 + b, h = it.h0 - 2 + q / kHalo, w = it.w0 - 2 + q % kHalo;
      const int c = c0 + ci;
      const bool ok = n < N && h >= 0 && h < H && w >= 0 && w < W && c < C;
      s_halo[i] = ok ? x[((static_cast<size_t>(n) * H + h) * W + w) * C + c] : from_float<T>(0.f);
    }
  }
  if (co_vec) {
    constexpr int kParts = kCoutTile / kV;
    static_assert(kParts >= 1, "a Cout tile fills whole 16-byte words");
    for (int i = t; i < kChunk * kParts; i += kThreads) {
      const int part = i % kParts;
      const int ci = i / kParts;
      const int co = it.co0 + part * kV;
      const bool ok = c0 + ci < C && co < Cout;
      const T* src = ok ? pw_w + static_cast<size_t>(c0 + ci) * Cout + co : pw_w;
      fdk::cp_async16(s_pw + ci * kCoutTile + part * kV, src, ok);
    }
    if (s_skip != nullptr) {
      const int H2 = 2 * H, W2 = 2 * W;
      for (int i = t; i < kB * kOutPix * kParts; i += kThreads) {
        const int part = i % kParts;
        const int q = (i / kParts) % kOutPix;
        const int b = i / (kParts * kOutPix);
        const int n = it.n0 + b, oh = 2 * it.h0 + q / (2 * kTile), ow = 2 * it.w0 + q % (2 * kTile);
        const int co = it.co0 + part * kV;
        const bool ok = n < N && oh < H2 && ow < W2 && co < Cout;
        const T* src = ok ? skip + ((static_cast<size_t>(n) * H2 + oh) * W2 + ow) * Cout + co : skip;
        fdk::cp_async16(s_skip + (b * kOutPix + q) * kCoutTile + part * kV, src, ok);
      }
    }
  } else {
    for (int i = t; i < kChunk * kCoutTile; i += kThreads) {
      const int col = i % kCoutTile;
      const int ci = i / kCoutTile;
      const int co = it.co0 + col;
      const bool ok = c0 + ci < C && co < Cout;
      s_pw[i] = ok ? pw_w[static_cast<size_t>(c0 + ci) * Cout + co] : from_float<T>(0.f);
    }
    if (s_skip != nullptr) {
      const int H2 = 2 * H, W2 = 2 * W;
      for (int i = t; i < kB * kOutPix * kCoutTile; i += kThreads) {
        const int col = i % kCoutTile;
        const int q = (i / kCoutTile) % kOutPix;
        const int b = i / (kCoutTile * kOutPix);
        const int n = it.n0 + b, oh = 2 * it.h0 + q / (2 * kTile), ow = 2 * it.w0 + q % (2 * kTile);
        const int co = it.co0 + col;
        const bool ok = n < N && oh < H2 && ow < W2 && co < Cout;
        s_skip[i] = ok ? skip[((static_cast<size_t>(n) * H2 + oh) * W2 + ow) * Cout + co]
                       : from_float<T>(0.f);
      }
    }
  }
}

// kCoutTile output channels per item, 4 per thread; the B x 16 pixel rows
// are spread over the remaining thread dimension, kPx rows per thread.
template <typename T, int kB, int kCoutTile>
__global__ void __launch_bounds__(kThreads)
    fused_decoder_stage_v3_kernel(const T* __restrict__ x, const T* __restrict__ dw_w,
                                  const T* __restrict__ dw_b, const T* __restrict__ pw_w,
                                  const T* __restrict__ pw_b, const T* __restrict__ skip,
                                  T* __restrict__ out, int N, int H, int W, int C, int Cout,
                                  int tiles_w, int n_tiles, int n_ct, int n_items, int x_vec,
                                  int co_vec) {
  using L = Layout<T, kB, kCoutTile>;
  constexpr int kGroupRows = kB * kPix;
  constexpr int kGroups = kCoutTile / 4;
  constexpr int kPixGroups = kThreads / kGroups;
  constexpr int kPx = kGroupRows / kPixGroups;
  static_assert(kPx >= 1 && kPx * kPixGroups == kGroupRows, "the rows must split evenly");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_halo = reinterpret_cast<T*>(smem_raw);       // [2][kB][8x8][kChunk]
  T* s_pw = s_halo + 2 * L::kHaloElems;             // [2][kChunk][kCoutTile]
  T* s_skip = s_pw + 2 * L::kPwElems;               // [2][kB x 64][kCoutTile], with a skip
  float* s_dw = reinterpret_cast<float*>(s_skip + (skip != nullptr ? 2 * L::kSkipElems : 0));

  const int t = threadIdx.x;
  const int lane_c = t % kChunk;
  const int row = t / kChunk;
  const int cg = t % kGroups;
  const int pg = t / kGroups;
  const int n_chunks = fd_ceil_div(C, kChunk);
  const int my_items =
      blockIdx.x < n_items ? (n_items - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int n_stages = my_items * n_chunks;
  if (n_stages == 0) return;

  auto item_at = [&](int j) {
    return decode(blockIdx.x + j * gridDim.x, n_ct, n_tiles, tiles_w, kB, kCoutTile);
  };
  auto prefetch = [&](int s) {
    const int j = s / n_chunks, k = s % n_chunks;
    T* sk = (skip != nullptr && k == 0) ? s_skip + (j & 1) * L::kSkipElems : nullptr;
    load_stage<T, kB, kCoutTile>(x, pw_w, skip, s_halo + (s & 1) * L::kHaloElems,
                                 s_pw + (s & 1) * L::kPwElems, sk, item_at(j), k * kChunk, N, H,
                                 W, C, Cout, x_vec != 0, co_vec != 0);
  };

  float acc[kPx][4];
#pragma unroll
  for (int j = 0; j < kPx; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  prefetch(0);
  fdk::cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    // the slots of stage s + 1 were last read in stage s - 1, which ended
    // at the barrier at the bottom of the loop
    if (s + 1 < n_stages) prefetch(s + 1);
    fdk::cp_async_commit();
    fdk::cp_async_wait<1>();  // this thread's copies up to stage s have landed
    __syncthreads();          // and everyone's

    const int j = s / n_chunks, k = s % n_chunks;
    const Item it = item_at(j);
    const int c0 = k * kChunk;
    const T* halo = s_halo + (s & 1) * L::kHaloElems;
    const T* pw = s_pw + (s & 1) * L::kPwElems;

    // depthwise 5x5 + bias + ReLU of all B images into s_dw
    const int c = c0 + lane_c;
    const bool c_ok = c < C;
    float tap[25];
#pragma unroll
    for (int q = 0; q < 25; ++q) tap[q] = c_ok ? to_float(dw_w[q * C + c]) : 0.f;
    const float bias = c_ok ? to_float(dw_b[c]) : 0.f;
    for (int r = row; r < kGroupRows; r += kRows) {
      const T* hb = halo + (r / kPix) * kHaloPix * kChunk;
      const int py = (r % kPix) / kTile;
      const int px = (r % kPix) % kTile;
      float acc_dw = 0.f;
#pragma unroll
      for (int dy = 0; dy < 5; ++dy)
#pragma unroll
        for (int dx = 0; dx < 5; ++dx)
          acc_dw = fmaf(to_float(hb[((py + dy) * kHalo + px + dx) * kChunk + lane_c]),
                        tap[dy * 5 + dx], acc_dw);
      s_dw[r * (kChunk + 1) + lane_c] = fmaxf(acc_dw + bias, 0.f);
    }
    __syncthreads();

    // pointwise partial product over this chunk, in registers
    const int depth = min(kChunk, C - c0);
    for (int ci = 0; ci < depth; ++ci) {
      const float4 wv = fdk::load4(pw + ci * kCoutTile + cg * 4);
#pragma unroll
      for (int jj = 0; jj < kPx; ++jj) {
        const float a = s_dw[(pg + jj * kPixGroups) * (kChunk + 1) + ci];
        acc[jj][0] = fmaf(a, wv.x, acc[jj][0]);
        acc[jj][1] = fmaf(a, wv.y, acc[jj][1]);
        acc[jj][2] = fmaf(a, wv.z, acc[jj][2]);
        acc[jj][3] = fmaf(a, wv.w, acc[jj][3]);
      }
    }

    if (k == n_chunks - 1) {
      // epilogue of item j: + bias, ReLU, each pixel as a 2x2 block, + skip
      const T* sk = s_skip + (j & 1) * L::kSkipElems;
      const size_t H2 = 2 * static_cast<size_t>(H);
      const size_t W2 = 2 * static_cast<size_t>(W);
#pragma unroll
      for (int jj = 0; jj < kPx; ++jj) {
        const int r = pg + jj * kPixGroups;
        const int b = r / kPix;
        const int py = (r % kPix) / kTile;
        const int px = (r % kPix) % kTile;
        const int n = it.n0 + b, h = it.h0 + py, w = it.w0 + px;
        const bool px_ok = n < N && h < H && w < W;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int col = cg * 4 + kk;
          const int co = it.co0 + col;
          if (px_ok && co < Cout) {
            const float v = fmaxf(acc[jj][kk] + to_float(pw_b[co]), 0.f);
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
#pragma unroll
              for (int dx = 0; dx < 2; ++dx) {
                const size_t o = ((n * H2 + 2 * h + dy) * W2 + 2 * w + dx) * Cout + co;
                float rv = v;
                if (skip != nullptr) {
                  const int q = (2 * py + dy) * (2 * kTile) + 2 * px + dx;
                  rv += to_float(sk[(b * kOutPix + q) * kCoutTile + col]);
                }
                out[o] = from_float<T>(rv);
              }
          }
          acc[jj][kk] = 0.f;
        }
      }
    }
    __syncthreads();  // stage s's slots and s_dw are free for stage s + 2
  }
  fdk::cp_async_wait<0>();
}

template <typename T, int kB, int kCoutTile>
cudaError_t launch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                   const void* pw_b, const void* skip, void* out, int N, int H, int W, int C,
                   int Cout, int blocks, cudaStream_t stream) {
  const int tiles_w = fd_ceil_div(W, kTile);
  const int n_tiles = fd_ceil_div(H, kTile) * tiles_w;
  const int n_ct = fd_ceil_div(Cout, kCoutTile);
  const long long n_items = static_cast<long long>(fd_ceil_div(N, kB)) * n_tiles * n_ct;
  if (n_items == 0) return cudaSuccess;
  if (n_items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = Layout<T, kB, kCoutTile>::bytes(skip != nullptr);
  auto kernel = fused_decoder_stage_v3_kernel<T, kB, kCoutTile>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (blocks <= 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    blocks = fd_sm_count() * (per_sm > 0 ? per_sm : 1);
    if (blocks <= 0) return cudaErrorInvalidValue;
  }
  const int grid = n_items < blocks ? static_cast<int>(n_items) : blocks;
  constexpr size_t kV = 16 / sizeof(T);
  const bool x_vec = C % kV == 0 && fd_aligned16(x);
  const bool co_vec = Cout % kV == 0 && fd_aligned16(pw_w) && (skip == nullptr || fd_aligned16(skip));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw_w), static_cast<const T*>(dw_b),
      static_cast<const T*>(pw_w), static_cast<const T*>(pw_b), static_cast<const T*>(skip),
      static_cast<T*>(out), N, H, W, C, Cout, tiles_w, n_tiles, n_ct, static_cast<int>(n_items),
      x_vec, co_vec);
  return cudaGetLastError();
}

// The Cout tile: the smallest power of two >= Cout, within [8, 64], at
// most 128 / B (at most 16 accumulators a thread) and at least 32 / B (one
// row a thread).
int cout_tile(int Cout, int B) {
  int tile = fd_pow2_ceil(Cout);
  tile = tile < 8 ? 8 : (tile > 64 ? 64 : tile);
  if (tile > 128 / B) tile = 128 / B;
  if (tile < 32 / B) tile = 32 / B;
  return tile;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                     const void* pw_b, const void* skip, void* out, int N, int H, int W, int C,
                     int Cout, int B, int blocks, cudaStream_t stream) {
  if (B != 1 && B != 2 && B != 4 && B != 8) return cudaErrorInvalidValue;
  const int tile = cout_tile(Cout, B);
#define FD_V3(b, t)                                                                   \
  if (B == b && tile == t)                                                            \
    return launch<T, b, t>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, H, W, C, Cout, blocks, \
                           stream);
  FD_V3(1, 32) FD_V3(1, 64)
  FD_V3(2, 16) FD_V3(2, 32) FD_V3(2, 64)
  FD_V3(4, 8) FD_V3(4, 16) FD_V3(4, 32)
  FD_V3(8, 8) FD_V3(8, 16)
#undef FD_V3
  return cudaErrorInvalidValue;
}

}  // namespace

// As fd_fused_decoder_stage (fused_decoder.cu), plus B, the images per work
// item (1, 2, 4 or 8), and blocks, the grid size (0: as many blocks as fit
// on the card at once).  Launches on `stream` and returns the launch's
// cudaError_t (0 = success); it neither allocates nor syncs.
extern "C" int fd_fused_decoder_stage_v3(const void* x, const void* dw_w, const void* dw_b,
                                         const void* pw_w, const void* pw_b, const void* skip,
                                         void* out, int N, int H, int W, int C, int Cout, int B,
                                         int blocks, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch<float>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, H, W, C,
                                              Cout, B, blocks, s));
    case 1:
      return static_cast<int>(dispatch<__nv_bfloat16>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N,
                                                      H, W, C, Cout, B, blocks, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
