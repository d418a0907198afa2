// K5: a staged copy, device memory -> a ring of shared-memory slots ->
// device memory, for Hopper (sm_90a).
//
// Replaces the Pallas TPU probe kernels that stage whole arrays, images or
// chunks through VMEM with manual DMA and scale them on the way out:
// scripts/bisect_v3.py k_a / k_b / k_c / k_d (through `run`),
// scripts/bisect_v3d.py flat_dma / vmem_autocopy_small_lane /
// dma_2d_small_lane, scripts/bisect_v3e.py rank3_folded_dma /
// value_reshape_split, and scripts/probe_xla_opts.py dma_copy (the copy
// bandwidth sweep).  Per element
//
//     out = a * x  [+ x[channel 0 of the same pixel]]
//
// f32 or bf16 in and out, f32 arithmetic (rounded as the plain version
// rounds: a multiply, then an add, no FMA).  The input is seen as `rows`
// rows of `row_len` elements (a row is an image of the scripts); a work
// item is one chunk of a row, at most `chunk` elements, so a long row is
// cut into chunks and its ragged tail is masked.  With the broadcast, the
// chunk is a whole number of pixels (`bcast_c` channels each) and a row a
// whole number of pixels, so no chunk separates a pixel from its channel 0.
//
// The grid is persistent: block b walks items b, b + gridDim.x, ...  The
// scripts' one program walked the images in order, which on a one-core
// TPU was the whole chip; on the card the wrapper's plan_copy cuts the
// rows into chunks small enough (down to 4 KB, one 16-byte word a thread)
// that every block the card holds at once gets about two items, and the
// grid is as many blocks as fit.  Each block owns `depth` slots of
// `chunk` elements in shared memory:
//   depth 1               one slot: copy in, wait, scale out (k_a, k_b);
//   depth 2, no prefetch  two slots used in turn, each copy waited (k_c,
//                         and dma_copy as the script wrote it);
//   depth 2, prefetch     the next item's copy is in flight while the
//                         current one is scaled and written (k_d).
// Copies are cp.async 16-byte copies when the row, the chunk and the
// channel group fill whole 16-byte words and both pointers are 16-byte
// aligned; otherwise element loads into the same slots (synchronous), as
// K3 does.  Results go from the slot straight to device memory (stores do
// not stall the SM, so there is no out slot).  A thread reads back from a
// slot only the words it copied in, except a pixel's channel 0 under the
// broadcast: only then does an item need a barrier after its copy lands
// and one before its slot is reused; without the broadcast each thread's
// own cp.async wait is the whole handshake, which keeps the fixed cost of
// an item small when a block holds only one or two.
//
// What bounds it on the card: bytes.  It moves 2 bytes of device memory
// per byte of input and does one or two FLOPs per element, far below the
// H100's ridge; the design keeps enough bytes in flight per SM to cover
// the memory latency (a chunk per block, several blocks per SM when the
// chunk is small, the next chunk in flight with prefetch) and moves them
// in 16-byte words, neighbouring threads on neighbouring words.  Above
// ~50 MB of traffic it reads device memory; below it partly reads L2.

#include "stage_common.cuh"

namespace {

using fdk::from_float;
using fdk::to_float;

constexpr int kThreads = 256;
// Blocks an SM holds at once: __launch_bounds__ keeps each kernel within
// the registers for 5 (ops/cuda/probes.py COPY_BLOCKS_PER_SM sizes the
// default grid and the cut by the same number).
constexpr int kBlocksPerSm = 5;

// 16 bytes of a slot (4 f32 or 8 bf16) as f32, and 16 bytes to device memory.
__device__ __forceinline__ void slot16(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void slot16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  unsigned* words = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    words[i] = *reinterpret_cast<const unsigned*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

struct Chunk {
  long long off;  // first element, in the flat array
  int len;        // elements, <= chunk
};

__device__ __forceinline__ Chunk chunk_at(long long item, long long row_len, int chunk,
                                          int n_chunks) {
  const long long row = item / n_chunks;
  const long long k = item % n_chunks;
  const long long start = k * chunk;
  const long long left = row_len - start;
  return Chunk{row * row_len + start, static_cast<int>(left < chunk ? left : chunk)};
}

template <typename T, bool kVec>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x, T* slot, Chunk c) {
  if (kVec) {
    constexpr int kV = 16 / sizeof(T);
    for (int w = threadIdx.x; w < c.len / kV; w += kThreads)
      fdk::cp_async16(slot + w * kV, x + c.off + w * kV, true);
  } else {
    for (int i = threadIdx.x; i < c.len; i += kThreads) slot[i] = x[c.off + i];
  }
}

__device__ __forceinline__ float scaled(float a, float v, float c0) {
  return __fadd_rn(__fmul_rn(a, v), c0);
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_chunk(const T* slot, T* __restrict__ out, Chunk c, float a,
                                            int bcast_c) {
  if (kVec) {
    constexpr int kV = 16 / sizeof(T);
    for (int w = threadIdx.x; w < c.len / kV; w += kThreads) {
      float v[kV];
      slot16(slot + w * kV, v);
      // a 16-byte word never straddles two pixels (bcast_c fills whole words)
      const float c0 = bcast_c > 0 ? to_float(slot[w * kV - (w * kV) % bcast_c]) : 0.f;
#pragma unroll
      for (int k = 0; k < kV; ++k) v[k] = scaled(a, v[k], c0);
      store16(out + c.off + w * kV, v);
    }
  } else {
    for (int i = threadIdx.x; i < c.len; i += kThreads) {
      const float c0 = bcast_c > 0 ? to_float(slot[i - i % bcast_c]) : 0.f;
      out[c.off + i] = from_float<T>(scaled(a, to_float(slot[i]), c0));
    }
  }
}

// A barrier across the block, only where threads read each other's words
// of a slot (kShare: the broadcast's channel 0).
template <bool kShare>
__device__ __forceinline__ void slot_barrier() {
  if (kShare) __syncthreads();
}

template <typename T, bool kVec, bool kShare>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    staged_copy_kernel(const T* __restrict__ x, T* __restrict__ out, long long row_len, int chunk,
                       int n_chunks, long long n_items, float a, int bcast_c, int depth,
                       int prefetch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slots = reinterpret_cast<T*>(smem_raw);  // [depth][chunk]
  const long long first = blockIdx.x;
  if (first >= n_items) return;
  const long long n = (n_items - 1 - first) / gridDim.x + 1;  // this block's items
  auto item = [&](long long j) {
    return chunk_at(first + j * gridDim.x, row_len, chunk, n_chunks);
  };

  if (prefetch) {
    // depth 2: the copy of item j + 1 is in flight while item j is scaled
    load_chunk<T, kVec>(x, slots, item(0));
    fdk::cp_async_commit();
    for (long long j = 0; j < n; ++j) {
      // slot (j + 1) & 1 was last read by item j - 1: by this thread alone
      // (its own words), or by everyone before the barrier that ended it
      if (j + 1 < n) load_chunk<T, kVec>(x, slots + ((j + 1) & 1) * chunk, item(j + 1));
      fdk::cp_async_commit();
      fdk::cp_async_wait<1>();  // this thread's copies of item j have landed
      slot_barrier<kShare>();   // and everyone's
      store_chunk<T, kVec>(slots + (j & 1) * chunk, out, item(j), a, bcast_c);
      slot_barrier<kShare>();
    }
  } else {
    for (long long j = 0; j < n; ++j) {
      T* slot = slots + (depth == 2 ? (j & 1) : 0) * chunk;
      load_chunk<T, kVec>(x, slot, item(j));
      fdk::cp_async_commit();
      fdk::cp_async_wait<0>();
      slot_barrier<kShare>();
      store_chunk<T, kVec>(slot, out, item(j), a, bcast_c);
      slot_barrier<kShare>();
    }
  }
  fdk::cp_async_wait<0>();
}

template <typename T, bool kVec, bool kShare>
cudaError_t launch_kernel(const T* x, T* out, long long row_len, int chunk, int n_chunks,
                          long long n_items, float a, int bcast_c, int depth, int prefetch,
                          int blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(depth) * chunk * sizeof(T);
  auto kernel = staged_copy_kernel<T, kVec, kShare>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = n_items < blocks ? static_cast<int>(n_items) : blocks;
  kernel<<<grid, kThreads, smem, stream>>>(x, out, row_len, chunk, n_chunks, n_items, a, bcast_c,
                                           depth, prefetch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* out, long long rows, long long row_len, int chunk,
                     float a, int bcast_c, int depth, int prefetch, int blocks,
                     cudaStream_t stream) {
  if (rows <= 0 || row_len <= 0) return cudaSuccess;
  if (chunk <= 0 || (depth != 1 && depth != 2) || (prefetch && depth != 2) || bcast_c < 0 ||
      blocks <= 0)
    return cudaErrorInvalidValue;
  if (bcast_c > 0 && (chunk % bcast_c != 0 || row_len % bcast_c != 0))
    return cudaErrorInvalidValue;
  const long long chunks = (row_len + chunk - 1) / chunk;
  const long long n_items = rows * chunks;
  if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr long long kV = 16 / sizeof(T);
  const bool vec = row_len % kV == 0 && chunk % kV == 0 && (bcast_c == 0 || bcast_c % kV == 0) &&
                   fd_aligned16(x) && fd_aligned16(out);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int n_chunks = static_cast<int>(chunks);
  auto launch = bcast_c > 0
                     ? (vec ? &launch_kernel<T, true, true> : &launch_kernel<T, false, true>)
                     : (vec ? &launch_kernel<T, true, false> : &launch_kernel<T, false, false>);
  return launch(xt, ot, row_len, chunk, n_chunks, n_items, a, bcast_c, depth, prefetch, blocks,
                stream);
}

}  // namespace

// x and out: `rows` x `row_len` dense elements, one dtype (0 = float32,
// 1 = bfloat16); chunk: elements per ring slot; a: the scale; bcast_c: 0,
// or the channels of a pixel whose channel 0 is added to each of them;
// depth: 1 or 2 slots; prefetch: 1 keeps the next chunk's copy in flight
// (depth 2 only); blocks: the persistent grid (at most; never more blocks
// than items), which the wrapper sizes to what the card holds at once.
// Launches on `stream` and returns the launch's cudaError_t (0 =
// success); it neither allocates nor syncs.
extern "C" int fd_staged_copy(const void* x, void* out, long long rows, long long row_len,
                              int chunk, float a, int bcast_c, int depth, int prefetch,
                              int blocks, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch<float>(x, out, rows, row_len, chunk, a, bcast_c, depth,
                                               prefetch, blocks, s));
    case 1:
      return static_cast<int>(dispatch<__nv_bfloat16>(x, out, rows, row_len, chunk, a, bcast_c,
                                                       depth, prefetch, blocks, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
