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
// kernel is the image group: a block holds the same th x tw pixel tile of
// B = block_batch images, so each C chunk's pointwise-weight rows and
// depthwise taps, loaded once into shared memory, serve all B images, and
// the pointwise product is one tile GEMM with B x th x tw rows.
//
// What bounds it on the card: K1's levels (its header), with the same
// function.  The first K2 reached 3% of that bound: it shrank its Cout
// tile (down to 8) until the grid covered the SMs, and every Cout tile
// redid the whole depthwise pass and re-read the halo; its halo loads
// were synchronous element loads with two barriers per image and chunk,
// its pointwise loop did one shared-memory load per four FMAs and its
// epilogue stored 4 bytes at a time.
//
// The design is K1's, generalised to image groups in stage_tile.cuh (the
// block, StageBlock, and its one-item pipeline, run_item).
// The Cout tile is all of Cout <= 256; the block walks C in chunks
// through the two-slot cp.async pipeline (each image's halo of chunk
// s + 2 and the weights of chunk s + 1 land while chunk s computes);
// register-blocked depthwise strips; the tile GEMM on a 4x8 f32 register
// tile a thread (no TF32) or bf16 mma.sync; split-C thread groups summed
// in a fixed order; 16-byte epilogue stores with the skip read the same
// way.  The launch is chosen on the host, in closed form, by
// ops/cuda/fused_decoder_hwbc.py::launch_geometry: a block's GEMM rows
// are B x the per-image pixel tile, so at B = 8 the tile is as small as
// 1 x 4 pixels; where image groups x tiles leave SMs idle (7^2 and 14^2
// at batch 8 with B = 8) it shrinks the tile, then splits C over thread
// groups, and only last splits Cout.
//
// A ragged last group (N not a multiple of B) is masked: its missing
// images read as zero and are not written, so the result does not depend
// on B.

#include "stage_tile.cuh"

namespace {

template <typename T, int KC>
__global__ void __launch_bounds__(256, 2)
    k2_kernel(const T* __restrict__ x, const T* __restrict__ dw_w, const T* __restrict__ dw_b,
              const T* __restrict__ pw_w, const T* __restrict__ pw_b,
              const T* __restrict__ skip, T* __restrict__ out, fdk::Geom g, bool vec_x,
              bool vec_w, bool vec_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  fdk::StageBlock<T, KC, false> sb(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, vec_x, vec_w,
                                   vec_o, smem);
  const int tile = blockIdx.x % g.tiles;
  const fdk::Item it{(static_cast<int>(blockIdx.x) / g.tiles) << g.b_log2,
                     (tile / g.tiles_w) * g.th, (tile % g.tiles_w) * g.tw,
                     static_cast<int>(blockIdx.y) * g.nc};
  fdk::run_item(sb, it);
}

template <typename T, int KC>
cudaError_t launch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                   const void* pw_b, const void* skip, void* out, const fdk::Geom& g,
                   int threads, cudaStream_t stream) {
  const int smem = fdk::Layout<T, KC>(g.th, g.tw, g.nc, g.ks, g.b_log2, false).total;
  auto kernel = k2_kernel<T, KC>;
  static int smem_allowed = 48 * 1024;  // per instantiation: raise the cap once
  const cudaError_t err = fdk::allow_smem(kernel, smem, smem_allowed);
  if (err != cudaSuccess) return err;
  bool vec_x, vec_w, vec_o;
  fdk::vector_paths<T>(g, x, dw_w, dw_b, pw_w, skip, out, vec_x, vec_w, vec_o);
  const dim3 grid(fd_ceil_div(g.N, 1 << g.b_log2) * g.tiles, g.n_ct);
  kernel<<<grid, threads * g.ks, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw_w), static_cast<const T*>(dw_b),
      static_cast<const T*>(pw_w), static_cast<const T*>(pw_b), static_cast<const T*>(skip),
      static_cast<T*>(out), g, vec_x, vec_w, vec_o);
  return cudaGetLastError();
}

}  // namespace

// As fd_fused_decoder_stage (fused_decoder.cu), plus B, the images per
// block: 1, 2, 4 or 8; th x tw is each image's pixel tile.  The geometry
// comes from the wrapper's launch_geometry; one the kernel does not take
// returns cudaErrorInvalidValue.  Launches on `stream` and returns the
// launch's cudaError_t (0 = success); it neither allocates nor syncs.
extern "C" int fd_fused_decoder_stage_hwbc(const void* x, const void* dw_w, const void* dw_b,
                                           const void* pw_w, const void* pw_b, const void* skip,
                                           void* out, int N, int H, int W, int C, int Cout,
                                           int threads, int th, int tw, int nc, int kc, int ks,
                                           int B, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fdk::pow2(B) || B > 8) return static_cast<int>(cudaErrorInvalidValue);
  fdk::Geom g;
  if (!fdk::make_geom(g, N, H, W, C, Cout, threads, th, tw, nc, ks, __builtin_ctz(B), dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(fd_ceil_div(N, B)) * g.tiles > 0x7fffffffLL || g.n_ct > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (kc) {
      case 8: return static_cast<int>(launch<float, 8>(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, threads, s));
      case 16: return static_cast<int>(launch<float, 16>(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, threads, s));
      case 32: return static_cast<int>(launch<float, 32>(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, threads, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (kc) {
    case 16: return static_cast<int>(launch<__nv_bfloat16, 16>(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, threads, s));
    case 32: return static_cast<int>(launch<__nv_bfloat16, 32>(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
