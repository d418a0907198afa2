// K4: the FastDepth 1x1 head, C -> 1 + bias -> ReLU, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fastdepth_tpu/ops/pallas/fused_decoder.py::fused_pointwise_head.  Per
// pixel of an NHWC (channels_last) input it computes
//
//     out = max(0, sum_c x[c] * w[c] + b)
//
// f32 or bf16 in, f32 accumulation, output in the input dtype.
//
// What bounds it on the card: bytes.  It does 2C FLOP per pixel over C
// input values: at the flagship's head (C = 16, 224x224, batch 8, f32) it
// reads 25.7 MB and writes 1.6 MB for 13 MFLOP, half a FLOP per byte,
// far below the H100's ridge.  The design moves each byte once and
// moves it wide: one thread per pixel, the pixel's C channels read with
// 16-byte vector loads (4 f32 or 8 bf16) when C fills whole 16-byte
// words, neighbouring threads on neighbouring pixels so a warp reads one
// contiguous span; the weights and bias are a few hundred bytes, read
// through the read-only cache by every thread.  Any other C takes scalar
// loads.

#include "stage_common.cuh"

namespace {

using fdk::from_float;
using fdk::to_float;

constexpr int kThreads = 256;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    pointwise_head_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ b, T* __restrict__ out, long long pixels, int C) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= pixels) return;
  const T* xp = x + p * C;
  float s = 0.f;
  if (kVec) {
    constexpr int kV = 16 / sizeof(T);
    for (int c = 0; c < C; c += kV) {
      float v[kV];
      fdk::load16(xp + c, v);
#pragma unroll
      for (int k = 0; k < kV; ++k) s = fmaf(v[k], to_float(__ldg(w + c + k)), s);
    }
  } else {
    for (int c = 0; c < C; ++c) s = fmaf(to_float(xp[c]), to_float(__ldg(w + c)), s);
  }
  out[p] = from_float<T>(fmaxf(s + to_float(__ldg(b)), 0.f));
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out, long long pixels, int C,
                   cudaStream_t stream) {
  const long long blocks = (pixels + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = (C * sizeof(T)) % 16 == 0 && fd_aligned16(x);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  if (vec)
    pointwise_head_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xt, wt, bt, ot, pixels, C);
  else
    pointwise_head_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xt, wt, bt, ot, pixels, C);
  return cudaGetLastError();
}

}  // namespace

// x (pixels, C) dense (an NHWC tensor); w (C); b (1); out (pixels); one
// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream` and returns the
// launch's cudaError_t (0 = success); it neither allocates nor syncs.
extern "C" int fd_pointwise_head(const void* x, const void* w, const void* b, void* out,
                                 long long pixels, int C, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, w, b, out, pixels, C, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, w, b, out, pixels, C, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
