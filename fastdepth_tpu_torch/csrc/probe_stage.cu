// K6: one piece of the decoder stage's compute on NHWC f32 tiles spread
// over the whole card, for Hopper (sm_90a).
//
// Replaces the Pallas TPU probe kernels that copied one image at a time
// into VMEM and ran one op of the stage on it: scripts/bisect_v3c.py
// make_kernel (through `run`; modes matmul, matmul_up, taps, up_only) and
// scripts/bisect_v3d.py dma_matmul (mode matmul).  On an NHWC f32 input
// x (N, H, W, C):
//
//   matmul     out (N, H, W, Cout) = x @ w, w (C, Cout)
//   matmul_up  the same, each output pixel written to its 2x2 block
//   taps       out (N, H, W, C) = sum over dw (outer) and dh (inner) of the
//              zero-padded (pad 2 of each image, not a halo from the
//              neighbouring image) x[h + dh - 2, w + dw - 2] * 0.04, each
//              product rounded and added in that order, as the script's
//              loop does
//   up_only    out (N, 2H, 2W, C): nearest x2
//
// The kernel computes its own products (f32 on the CUDA cores); no library
// call.
//
// The scripts ran one program (grid=()) that walked the images in a loop,
// one image a step through one VMEM slot: on a one-core TPU that loop was
// the whole chip.  On the card the image is not the unit of work; each
// mode is cut into tiles that fill the 132 SMs where the shapes allow
// (ops/cuda/probes.py::stage_geometry picks the tiles on the host):
//
//   matmul / matmul_up: a tiled GEMM with the N*H*W pixels as its M
//     dimension (the images are independent; one image a step was a VMEM
//     artefact).  A block owns a BM x BN tile of (pixels, Cout), each
//     thread TM pixels (4, or 8 in the largest tile) x 4 neighbouring
//     output channels in registers: per 4 channels of C a thread loads
//     TM + 4 16-byte words from shared memory for 16 TM FMAs.  x and w
//     move through shared memory in chunks of 32 channels by 16-byte
//     cp.async, two slots: the next chunk's copy is in flight while this
//     one is multiplied.  Each output is summed over C in order with fmaf, as the
//     one-block kernel did.  Pixel and Cout edges are masked (zero-filled
//     copies, guarded stores), never divided.  matmul_up writes each
//     thread's 4 channels to the pixel's 2x2 block as 16-byte stores.
//     Tensor cores are set aside: TF32 keeps a 10-bit mantissa, and over
//     the 128-512 products of a sum its error reaches the probe's f32
//     tolerance (1e-4 * max(1, max|plain|)).  A 3xTF32 split would hold it
//     and is not built (PERF.md, open questions).
//   taps: a block stages a band of rows of one image with its +-2-row halo
//     (zero rows outside the image) for a tile of channels, by cp.async,
//     so that each value a block needs leaves memory once for it; then
//     each thread sums a strip of up to 4 rows of one pixel column for 4
//     channels from shared memory, each loaded value and its rounded
//     product serving every sum of the strip that takes it (the order of
//     each sum's 25 terms is the script's), and writes 16 bytes a pixel.
//   up_only: a copy.  Each thread reads one 16-byte word of channels and
//     writes it to its 4 destinations; a value read once gains nothing
//     from staging, so nothing is staged.
//
// Copies and stores are 16-byte words when the channel counts fill whole
// words and the pointers are 16-byte aligned; element loads and stores
// into the same tiles otherwise.
//
// What bounds it on the card: at the probes' shapes (8x8 images, N = 4)
// the launch and one or two round trips to device memory, far above the
// 0.1-1 us their work needs; at the scale rows (engine/probes.py
// compute_sweep) the f32 operations (matmul, matmul_up) or the bytes
// (taps, up_only).

#include "stage_common.cuh"

namespace {

constexpr int kMatmul = 0, kMatmulUp = 1, kTaps = 2, kUpOnly = 3;
constexpr int kBK = 32;   // channels of C a GEMM chunk
constexpr int kPad = 4;   // floats after each staged pixel row of a GEMM chunk
constexpr float kTap = 0.04f;

// One 16-byte word of 4 channels from device memory into shared memory:
// cp.async when kVec (the word is whole or wholly outside: zero-filled),
// else element loads, each channel masked on its own.
template <bool kVec>
__device__ __forceinline__ void stage4(float* dst, const float* src, const float* base,
                                       bool ok, int valid) {
  if (kVec) {
    fdk::cp_async16(dst, ok ? src : base, ok);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[i] = ok && i < valid ? __ldg(src + i) : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* dst, const float4 v, int valid) {
  if (kVec) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    const float f[4] = {v.x, v.y, v.z, v.w};
    for (int i = 0; i < 4 && i < valid; ++i) dst[i] = f[i];
  }
}

// --- matmul / matmul_up ------------------------------------------------

template <int BM, int BN, int TM, bool kVec>
__global__ void __launch_bounds__(BM * BN / (4 * TM))
    gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int M, int C, int Cout, int H, int W, int up) {
  constexpr int kThreads = BM * BN / (4 * TM);
  constexpr int kTX = BN / 4;   // threads along Cout
  constexpr int kTY = BM / TM;  // threads along the pixels
  __shared__ __align__(16) float As[2][BM][kBK + kPad];  // pixels x channels
  __shared__ __align__(16) float Bs[2][kBK][BN];         // channels x Cout
  const int t = threadIdx.x;
  // a thread's pixels are ty + kTY * i: a warp's A loads hit neighbouring
  // rows of the tile, 16-byte bank groups apart
  const int tx = t % kTX, ty = t / kTX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int chunks = (C + kBK - 1) / kBK;

  auto load = [&](int slot, int k0) {
    for (int v = t; v < BM * kBK / 4; v += kThreads) {
      const int r = v / (kBK / 4), c = k0 + (v % (kBK / 4)) * 4;
      const int m = m0 + r;
      stage4<kVec>(&As[slot][r][c - k0], x + static_cast<size_t>(m) * C + c, x,
                   m < M && c < C, C - c);
    }
    for (int v = t; v < kBK * BN / 4; v += kThreads) {
      const int r = v / (BN / 4), n = n0 + (v % (BN / 4)) * 4;
      const int c = k0 + r;
      stage4<kVec>(&Bs[slot][r][n - n0], w + static_cast<size_t>(c) * Cout + n, w,
                   c < C && n < Cout, Cout - n);
    }
  };

  float acc[TM][4] = {};
  load(0, 0);
  fdk::cp_async_commit();
  for (int s = 0; s < chunks; ++s) {
    // slot (s + 1) & 1 was last read by chunk s - 1, which ended at the
    // barrier at the bottom of the loop
    if (s + 1 < chunks) load((s + 1) & 1, (s + 1) * kBK);
    fdk::cp_async_commit();
    fdk::cp_async_wait<1>();  // this thread's copies of chunk s have landed
    __syncthreads();          // and everyone's
    const int b = s & 1;
#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      float a[TM][4], bv[4][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 f = *reinterpret_cast<const float4*>(&As[b][ty + kTY * i][k]);
        a[i][0] = f.x; a[i][1] = f.y; a[i][2] = f.z; a[i][3] = f.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 f = *reinterpret_cast<const float4*>(&Bs[b][k + kk][tx * 4]);
        bv[kk][0] = f.x; bv[kk][1] = f.y; bv[kk][2] = f.z; bv[kk][3] = f.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][kk], bv[kk][j], acc[i][j]);
    }
    __syncthreads();
  }

  const int n = n0 + tx * 4;
  if (n >= Cout) return;
  const int hw = H * W;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + kTY * i;
    if (m >= M) break;
    const float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (!up) {
      store4<kVec>(out + static_cast<size_t>(m) * Cout + n, v, Cout - n);
    } else {
      const int img = m / hw, p = m - img * hw;
      const int h = p / W, wc = p - h * W;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx)
          store4<kVec>(out + ((static_cast<size_t>(img) * 2 * H + 2 * h + dy) * 2 * W + 2 * wc +
                              dx) * Cout + n,
                       v, Cout - n);
    }
  }
}

// --- taps --------------------------------------------------------------

// Block (image n, band of `rows` rows from r0, channels c0 .. c0 + ct):
// tile [rows + 4][W][ct] in shared memory, rows r0 - 2 .. r0 + rows + 1.
// A thread computes S rows of one pixel column for 4 channels: for each dw
// it loads the S + 4 values of its column once, rounds each product with
// 0.04 once, and adds each into the S sums that take it, so every sum
// still adds its 25 products dw outer, dh inner.
template <int S, bool kVec>
__global__ void __launch_bounds__(256)
    taps_kernel(const float* __restrict__ x, float* __restrict__ out, int H, int W, int C,
                int rows, int ct) {
  extern __shared__ __align__(16) float tile[];
  const int bands = (H + rows - 1) / rows;
  const int n = blockIdx.x / bands, r0 = (blockIdx.x % bands) * rows;
  const int c0 = blockIdx.y * ct;
  const int words = ct / 4;
  const size_t img = static_cast<size_t>(n) * H * W * C;
  for (int v = threadIdx.x; v < (rows + 4) * W * words; v += blockDim.x) {
    const int c4 = v % words, q = v / words;
    const int wc = q % W, rr = q / W;
    const int h = r0 - 2 + rr, c = c0 + 4 * c4;
    const bool ok = h >= 0 && h < H && c < C;
    stage4<kVec>(tile + 4 * v, ok ? x + img + (static_cast<size_t>(h) * W + wc) * C + c : x, x,
                 ok, C - c);
  }
  fdk::cp_async_commit();
  fdk::cp_async_wait<0>();
  __syncthreads();
  for (int v = threadIdx.x; v < rows / S * W * words; v += blockDim.x) {
    const int c4 = v % words, q = v / words;
    const int wc = q % W, r = q / W * S;  // the strip's first row in the band
    const int c = c0 + 4 * c4;
    if (r0 + r >= H || c >= C) continue;
    float acc[S][4] = {};
#pragma unroll
    for (int dw = 0; dw < 5; ++dw) {
      const int ww = wc + dw - 2;
      const bool in = ww >= 0 && ww < W;
      // tile row r + i is image row r0 + r + i - 2 (zero outside the image)
      float p[S + 4][4];
#pragma unroll
      for (int i = 0; i < S + 4; ++i) {
        const float4 f = in ? *reinterpret_cast<const float4*>(
                                  tile + ((r + i) * W + ww) * ct + 4 * c4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        p[i][0] = __fmul_rn(f.x, kTap);
        p[i][1] = __fmul_rn(f.y, kTap);
        p[i][2] = __fmul_rn(f.z, kTap);
        p[i][3] = __fmul_rn(f.w, kTap);
      }
#pragma unroll
      for (int j = 0; j < S; ++j)
#pragma unroll
        for (int dh = 0; dh < 5; ++dh)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], p[j + dh][e]);
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int h = r0 + r + j;
      if (h >= H) break;
      store4<kVec>(out + img + (static_cast<size_t>(h) * W + wc) * C + c,
                   make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]), C - c);
    }
  }
}

template <int S>
cudaError_t launch_taps(bool vec, const float* x, float* out, int N, int H, int W, int C,
                        int rows, int ct, int threads, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(rows + 4) * W * ct * sizeof(float);
  const dim3 grid(N * fd_ceil_div(H, rows), fd_ceil_div(C, ct));
  auto kernel = vec ? &taps_kernel<S, true> : &taps_kernel<S, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(x, out, H, W, C, rows, ct);
  return cudaGetLastError();
}

// --- up_only -----------------------------------------------------------

template <bool kVec>
__global__ void __launch_bounds__(256)
    up_kernel(const float* __restrict__ x, float* __restrict__ out, long long words, int H,
              int W, int C) {
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= words) return;
  const int per_px = (C + 3) / 4;
  const long long p = v / per_px;
  const int c = static_cast<int>(v - p * per_px) * 4;
  const int wc = static_cast<int>(p % W);
  const long long nh = p / W;  // n * H + h
  const float* src = x + p * C + c;
  float4 f;
  if (kVec) {
    f = __ldg(reinterpret_cast<const float4*>(src));
  } else {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = i < C - c ? __ldg(src + i) : 0.f;
    f = make_float4(e[0], e[1], e[2], e[3]);
  }
  const long long n = nh / H, h = nh - n * H;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
      store4<kVec>(out + ((n * 2 * H + 2 * h + dy) * 2 * W + 2 * wc + dx) * C + c, f, C - c);
}

template <int BM, int BN, int TM>
cudaError_t launch_gemm(bool vec, const float* x, const float* w, float* out, int M, int C,
                        int Cout, int H, int W, int up, cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  constexpr int kThreads = BM * BN / (4 * TM);
  if (vec)
    gemm_kernel<BM, BN, TM, true><<<grid, kThreads, 0, s>>>(x, w, out, M, C, Cout, H, W, up);
  else
    gemm_kernel<BM, BN, TM, false><<<grid, kThreads, 0, s>>>(x, w, out, M, C, Cout, H, W, up);
  return cudaGetLastError();
}

}  // namespace

// x (N, H, W, C) and out dense f32 (NHWC); w (C, Cout) dense f32, read in
// the matmul modes only; mode: 0 matmul, 1 matmul_up, 2 taps (Cout == C),
// 3 up_only (Cout == C).  The tiles come from the wrapper's stage_geometry:
// matmul modes, tile_m x tile_n of (pixels, Cout) with `threads` threads,
// one of 128x32 (128 threads, 8 pixels a thread), 64x64 (256), 64x32
// (128), 32x16 (32; 4 pixels a thread); taps, bands of tile_m
// rows (each thread a strip of min(4, tile_m) of them) and tiles of tile_n
// channels (a multiple of 4), `threads` threads and (tile_m + 4) * W *
// tile_n floats of shared memory a block; up_only takes neither.
// Launches on `stream` and returns the launch's cudaError_t (0 =
// success); it neither allocates nor syncs.
extern "C" int fd_staged_compute(const void* x, const void* w, void* out, int N, int H, int W,
                                 int C, int Cout, int mode, int tile_m, int tile_n, int threads,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || mode < kMatmul || mode > kUpOnly)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((mode == kTaps || mode == kUpOnly) && Cout != C)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const bool aligned = fd_aligned16(x) && fd_aligned16(out);
  if (mode == kMatmul || mode == kMatmulUp) {
    if (w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const float* wf = static_cast<const float*>(w);
    const bool vec = aligned && fd_aligned16(w) && C % 4 == 0 && Cout % 4 == 0;
    const long long M = static_cast<long long>(N) * H * W;
    if (M > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int up = mode == kMatmulUp;
    const int m = static_cast<int>(M);
    if (tile_m == 128 && tile_n == 32 && threads == 128)
      return static_cast<int>(launch_gemm<128, 32, 8>(vec, xf, wf, of, m, C, Cout, H, W, up, s));
    if (tile_m == 64 && tile_n == 64 && threads == 256)
      return static_cast<int>(launch_gemm<64, 64, 4>(vec, xf, wf, of, m, C, Cout, H, W, up, s));
    if (tile_m == 64 && tile_n == 32 && threads == 128)
      return static_cast<int>(launch_gemm<64, 32, 4>(vec, xf, wf, of, m, C, Cout, H, W, up, s));
    if (tile_m == 32 && tile_n == 16 && threads == 32)
      return static_cast<int>(launch_gemm<32, 16, 4>(vec, xf, wf, of, m, C, Cout, H, W, up, s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = aligned && C % 4 == 0;
  if (mode == kTaps) {
    if (tile_m <= 0 || tile_n <= 0 || tile_n % 4 != 0 || threads <= 0 || threads > 256 ||
        threads % 32 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    // strips of 4 rows a thread where the band holds whole ones (bands of
    // 8, 4, 2 or 1 rows)
    if (tile_m % 4 == 0)
      return static_cast<int>(launch_taps<4>(vec, xf, of, N, H, W, C, tile_m, tile_n, threads, s));
    if (tile_m % 2 == 0)
      return static_cast<int>(launch_taps<2>(vec, xf, of, N, H, W, C, tile_m, tile_n, threads, s));
    return static_cast<int>(launch_taps<1>(vec, xf, of, N, H, W, C, tile_m, tile_n, threads, s));
  }
  const long long words = static_cast<long long>(N) * H * W * fd_ceil_div(C, 4);
  const long long blocks = (words + 255) / 256;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (vec)
    up_kernel<true><<<static_cast<unsigned>(blocks), 256, 0, s>>>(xf, of, words, H, W, C);
  else
    up_kernel<false><<<static_cast<unsigned>(blocks), 256, 0, s>>>(xf, of, words, H, W, C);
  return static_cast<int>(cudaGetLastError());
}
