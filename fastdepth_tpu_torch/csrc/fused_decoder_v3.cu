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
// its own two-slot DMA pipeline, so that image i+1's copies overlapped
// image i's compute.  What K3 keeps of it: one persistent launch, as many
// blocks as the card holds at once (or `blocks`), each walking work items
// in stride order through its own double-buffered pipeline.
//
// What bounds it on the card: K1's levels (its header), with the same
// function.  The first K3 reached 8% of that bound: its items were 4x4
// input tiles with an 8x8 halo (4x the pixels it used) and a Cout tile of
// at most 128 / B, each redoing the depthwise pass; 128-thread blocks,
// one shared-memory load per four FMAs, bf16 on the CUDA cores and 4-byte
// stores.
//
// The design.  A work item is (image group of B = block_batch, a K1-sized
// pixel tile of each image, all of Cout <= 256), chosen on the host in
// closed form by ops/cuda/fused_decoder_v3.py::launch_geometry (K2's
// geometry; the blocks an SM holds give the grid).  The block is K1's
// design over image groups (stage_tile.cuh: StageBlock, kPersistent): C chunks
// through the two-slot cp.async ring, register-blocked depthwise strips,
// the tile GEMM on a 4x8 f32 register tile a thread (no TF32) or bf16
// mma.sync, split-C thread groups summed in a fixed order, 16-byte
// epilogue stores with the skip read the same way.  The ring runs over
// the flat sequence of (item, chunk) (run_persistent): item j + 1's first
// halo and weights land, and its first depthwise pass runs, while item
// j's last chunk computes, and item j's epilogue stages in a shared-memory
// region of its own while item j + 1's copies are in flight.
//
// Pixels outside the image, images past N (a ragged last group) and
// channels past C or Cout read as zero and are not written; widths off the
// 16-byte grid take element loads and stores in the same structure.

#include "stage_tile.cuh"

namespace {

template <typename T, int KC>
__global__ void __launch_bounds__(256, 2)
    k3_kernel(const T* __restrict__ x, const T* __restrict__ dw_w, const T* __restrict__ dw_b,
              const T* __restrict__ pw_w, const T* __restrict__ pw_b,
              const T* __restrict__ skip, T* __restrict__ out, fdk::Geom g, int n_items,
              bool vec_x, bool vec_w, bool vec_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  fdk::StageBlock<T, KC, true> sb(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, vec_x, vec_w,
                                  vec_o, smem);
  fdk::run_persistent(sb, n_items);
}

template <typename T, int KC>
cudaError_t launch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                   const void* pw_b, const void* skip, void* out, const fdk::Geom& g,
                   int threads, int n_items, int blocks, cudaStream_t stream) {
  const int smem = fdk::Layout<T, KC>(g.th, g.tw, g.nc, g.ks, g.b_log2, true).total;
  auto kernel = k3_kernel<T, KC>;
  static int smem_allowed = 48 * 1024;  // per instantiation: raise the cap once
  const cudaError_t err = fdk::allow_smem(kernel, smem, smem_allowed);
  if (err != cudaSuccess) return err;
  bool vec_x, vec_w, vec_o;
  fdk::vector_paths<T>(g, x, dw_w, dw_b, pw_w, skip, out, vec_x, vec_w, vec_o);
  const int grid = n_items < blocks ? n_items : blocks;
  kernel<<<grid, threads * g.ks, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw_w), static_cast<const T*>(dw_b),
      static_cast<const T*>(pw_w), static_cast<const T*>(pw_b), static_cast<const T*>(skip),
      static_cast<T*>(out), g, n_items, vec_x, vec_w, vec_o);
  return cudaGetLastError();
}

}  // namespace

// As fd_fused_decoder_stage_hwbc (fused_decoder_hwbc.cu), plus blocks,
// the persistent grid (at least 1; the wrapper passes the blocks the card
// holds at once unless the caller gives it).  Launches on `stream` and
// returns the launch's cudaError_t (0 = success); it neither allocates
// nor syncs.
extern "C" int fd_fused_decoder_stage_v3(const void* x, const void* dw_w, const void* dw_b,
                                         const void* pw_w, const void* pw_b, const void* skip,
                                         void* out, int N, int H, int W, int C, int Cout,
                                         int threads, int th, int tw, int nc, int kc, int ks,
                                         int B, int blocks, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!fdk::pow2(B) || B > 8 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  fdk::Geom g;
  if (!fdk::make_geom(g, N, H, W, C, Cout, threads, th, tw, nc, ks, __builtin_ctz(B), dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(fd_ceil_div(N, B)) * g.tiles * g.n_ct;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(items);
  if (dtype == 0) {
    switch (kc) {
      case 8: return static_cast<int>(launch<float, 8>(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, threads, n, blocks, s));
      case 16: return static_cast<int>(launch<float, 16>(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, threads, n, blocks, s));
      case 32: return static_cast<int>(launch<float, 32>(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, threads, n, blocks, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (kc) {
    case 16: return static_cast<int>(launch<__nv_bfloat16, 16>(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, threads, n, blocks, s));
    case 32: return static_cast<int>(launch<__nv_bfloat16, 32>(x, dw_w, dw_b, pw_w, pw_b, skip, out, g, threads, n, blocks, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
