// K7: the epilogue of a folded inference convolution, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU, XLA fused each conv's bias add and
// activation into the convolution itself.  On the card, ATen runs cuDNN's
// convolution without the bias and then adds it as a broadcast
// (output.add_(bias.reshape(1, C, 1, 1))): the bias has stride 0 over N, H
// and W, so the add cannot vectorise and runs as ATen's generic strided
// elementwise kernel.  The activation, and a residual add where a block
// ends in one, follow as further full passes.  K7 is all of that in one
// pass over the conv's fresh NHWC (channels_last) output:
//
//     out = act(round(round(x + b[c]) + residual))
//
// with the residual optional and act none, ReLU or ReLU6.  Each sum is
// taken in f32 and rounded to the working dtype (f32 or bf16) exactly where
// ATen's unfused sequence rounds: after the bias, and again after the
// residual; the activation then picks a value and rounds nothing.  So K7
// gives, bit for bit, add_ -> [+ residual] -> act.  `out` may be `x` (the
// port's eager path writes in place).
//
// What bounds it on the card: bytes.  It reads x (and the residual) once
// and writes out once: 4 bytes an element in bf16, 6 with a residual (f32:
// 8 and 12), and a handful of f32 operations, far below the H100's ridge.
// At 3.35 TB/s the pruned flagship's 27 encoder epilogues (3,573,864
// elements a frame) take 4.27 us a frame in bf16.  The design moves each
// byte once, 16 bytes at a time:
//  - where C fills whole 16-byte words (8 bf16 or 4 f32) and every pointer
//    is 16-byte aligned, a thread moves one word of a pixel; otherwise it
//    moves one value (C = 1 at the final convs);
//  - a block is a (words a pixel) x (pixels) grid of threads, cut into
//    chunks of C along grid.y only where a pixel has more than 256 words.
//    Consecutive threads take consecutive words, so a warp reads one
//    contiguous span, and each thread keeps its word's bias in registers
//    for every pixel it visits: no per-element index arithmetic;
//  - each thread starts the loads of two pixels (and their residuals)
//    before it converts or stores any, so several loads are in flight;
//    where two a thread would leave the card under one block wave (8 a
//    SM), it takes one pixel and the grid twice the blocks.  (Over the
//    flagship's b128 epilogues two came out ahead of one, four and eight,
//    and of a persistent grid-stride block: PERF.md, the kernel table);
//  - offsets are 64-bit: DA-V2's b64 head writes conv outputs of 0.55-0.72
//    G elements, and its resizes' outputs pass 2^31.
// It allocates nothing and launches on the caller's stream, so a CUDA
// graph captures it.

#include <type_traits>

#include "stage_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPixels = 2;  // pixels a thread, at most
constexpr int kFillBlocks = 8 * 132;  // 8 blocks of 256 threads on each of 132 SMs

enum Act { kNone = 0, kRelu = 1, kRelu6 = 2 };

// The value f rounded to T's precision and back (f32 stays f32).
template <typename T>
__device__ __forceinline__ float round_to(float f);
template <>
__device__ __forceinline__ float round_to<float>(float f) { return f; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float f) {
  return __bfloat162float(__float2bfloat16(f));
}

// ATen's clamp_min(0) / clamp(0, 6): a NaN passes through.
template <int kAct>
__device__ __forceinline__ float activate(float v) {
  if (kAct == kNone || v != v) return v;
  v = fmaxf(v, 0.f);
  return kAct == kRelu6 ? fminf(v, 6.f) : v;
}

// One load or store of V consecutive values of T: 16 bytes, or one value.
template <typename T, int V>
using Word = typename std::conditional<V == 1, T, uint4>::type;

__device__ __forceinline__ void unpack(float w, float (&f)[1]) { f[0] = w; }
__device__ __forceinline__ void unpack(__nv_bfloat16 w, float (&f)[1]) {
  f[0] = __bfloat162float(w);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8]) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ void pack(const float (&f)[1], float& w) { w = f[0]; }
__device__ __forceinline__ void pack(const float (&f)[1], __nv_bfloat16& w) {
  w = __float2bfloat16(f[0]);
}
__device__ __forceinline__ void pack(const float (&f)[4], uint4& w) {
  w = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                 __float_as_uint(f[3]));
}
__device__ __forceinline__ void pack(const float (&f)[8], uint4& w) {
  unsigned words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    words[i] = *reinterpret_cast<const unsigned*>(&p);
  }
  w = make_uint4(words[0], words[1], words[2], words[3]);
}

// threadIdx.x: the word of the pixel (within grid.y's chunk of C),
// threadIdx.y: the pixel within the block's next blockDim.y pixels; a
// block covers blockDim.y * per_thread consecutive pixels.
template <typename T, int V, int kAct, bool kRes>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(const T* x, T* out, const T* __restrict__ bias,
                         const T* __restrict__ res, long long pixels, int words, int per_thread) {
  using W = Word<T, V>;
  const int cw = blockIdx.y * blockDim.x + threadIdx.x;
  if (cw >= words) return;
  float b[V];
  unpack(__ldg(reinterpret_cast<const W*>(bias) + cw), b);
  const long long p0 =
      static_cast<long long>(blockIdx.x) * blockDim.y * per_thread + threadIdx.y;
  const W* xw = reinterpret_cast<const W*>(x);
  const W* rw = reinterpret_cast<const W*>(res);
  W* ow = reinterpret_cast<W*>(out);
  W v[kMaxPixels], r[kMaxPixels];
#pragma unroll
  for (int k = 0; k < kMaxPixels; ++k) {
    const long long p = p0 + static_cast<long long>(k) * blockDim.y;
    if (k < per_thread && p < pixels) {
      const long long i = p * words + cw;
      v[k] = xw[i];
      if (kRes) r[k] = __ldg(rw + i);
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxPixels; ++k) {
    const long long p = p0 + static_cast<long long>(k) * blockDim.y;
    if (k < per_thread && p < pixels) {
      float f[V], g[V];
      unpack(v[k], f);
      if (kRes) unpack(r[k], g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float t = round_to<T>(f[j] + b[j]);
        if (kRes) t = round_to<T>(t + g[j]);
        f[j] = activate<kAct>(t);
      }
      W o;
      pack(f, o);
      ow[p * words + cw] = o;
    }
  }
}

template <typename T, int V, int kAct, bool kRes>
cudaError_t launch(const void* x, void* out, const void* bias, const void* res, long long pixels,
                   int C, cudaStream_t stream) {
  const int words = C / V;
  const int chunks = fd_ceil_div(words, kThreads);
  const int tx = fd_ceil_div(words, chunks);
  const int ty = kThreads / tx;
  int per = kMaxPixels;
  long long blocks = (pixels + ty * per - 1) / (ty * per);
  if (blocks * chunks < kFillBlocks) {
    per = 1;
    blocks = (pixels + ty - 1) / ty;
  }
  if (blocks > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidValue;
  conv_epilogue_kernel<T, V, kAct, kRes>
      <<<dim3(static_cast<unsigned>(blocks), chunks), dim3(tx, ty), 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(bias),
          static_cast<const T*>(res), pixels, words, per);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_act(const void* x, void* out, const void* bias, const void* res,
                       long long pixels, int C, int act, cudaStream_t s) {
  const bool r = res != nullptr;
  switch (act) {
    case kNone:
      return r ? launch<T, V, kNone, true>(x, out, bias, res, pixels, C, s)
               : launch<T, V, kNone, false>(x, out, bias, res, pixels, C, s);
    case kRelu:
      return r ? launch<T, V, kRelu, true>(x, out, bias, res, pixels, C, s)
               : launch<T, V, kRelu, false>(x, out, bias, res, pixels, C, s);
    case kRelu6:
      return r ? launch<T, V, kRelu6, true>(x, out, bias, res, pixels, C, s)
               : launch<T, V, kRelu6, false>(x, out, bias, res, pixels, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dtype(const void* x, void* out, const void* bias, const void* res,
                         long long pixels, int C, int act, cudaStream_t s) {
  if (pixels == 0 || C == 0) return cudaSuccess;
  constexpr int kV = 16 / sizeof(T);
  const bool vec = C % kV == 0 && fd_aligned16(x) && fd_aligned16(out) && fd_aligned16(bias) &&
                   (res == nullptr || fd_aligned16(res));
  return vec ? launch_act<T, kV>(x, out, bias, res, pixels, C, act, s)
             : launch_act<T, 1>(x, out, bias, res, pixels, C, act, s);
}

}  // namespace

// x, out and res (pixels, C) dense (NHWC tensors), out may be x; bias (C);
// res may be null; act 0 = none, 1 = ReLU, 2 = ReLU6; one dtype: 0 =
// float32, 1 = bfloat16.  Launches on `stream` and returns the launch's
// cudaError_t (0 = success); it neither allocates nor syncs.
extern "C" int fd_conv_epilogue(const void* x, void* out, const void* bias, const void* res,
                                long long pixels, int C, int act, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_dtype<float>(x, out, bias, res, pixels, C, act, s));
    case 1:
      return static_cast<int>(launch_dtype<__nv_bfloat16>(x, out, bias, res, pixels, C, act, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
