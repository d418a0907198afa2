// K8: the depth metrics' masked sums, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU, XLA fused the elementwise ops and
// masked reductions of metrics.evaluate_batch into a few fusions.  On the
// card ATen runs metrics.metric_sums op by op: about twenty elementwise
// passes, nine where + sum pairs, a count and a stack, some sixty launches
// an evaluation step, each reading or writing whole f32 maps.  K8 reads
// each pixel of the (N, H, W, 1) f32 prediction and target once and writes
// the same (10, N) f32 stack: each image's nine masked sums, in the order
// of metrics.SUM_FIELDS (squared error, absolute error, |log10 ratio|,
// relative error, delta1-3, squared and absolute inverse error), then its
// valid-pixel count.
//
// Semantics (the reference's Result.evaluate): a pixel is valid where the
// target or the prediction is > 0, and depths are scaled to millimetres.
// Each per-pixel term is rounded exactly where ATen's sequence rounds it:
// 1e3 *, the differences, |.|, the two divisions of max_ratio, 1.0 /
// (ATen's reciprocal: 1 / x, correctly rounded, which __frcp_rn gives
// too), log10f (CUDA's math library, which ATen's log10 calls) and the
// compares against 1.25, 1.5625 and 1.953125.  The library is built with
// nvcc's default -fmad=true (ops/cuda/_build.py, shared by every kernel),
// so the terms are written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn: no product is contracted into the difference or the running
// sum that takes it.
// max(a, b) < c is taken as a < c && b < c, which is what ATen's maximum
// (NaN-propagating) followed by the compare gives.  So only the order of
// the sums differs from the plain version; the delta sums and the count are
// integers (below 2^24 an image), exact in any order.
//
// Its bound on the card is bytes: it reads 8 bytes a pixel and writes 40
// bytes an image, 51.4 MB a flagship step (b128 at 224^2), 15.3 us at
// 3.35 TB/s; 137 MB a DA-V2 step (b64 at 518^2), 41 us.  But its exact
// arithmetic, five correctly rounded divisions and two log10f a valid
// pixel, is about 200 instructions, so on the card it is bound by issuing
// them (some 45 us a flagship step) before the bytes bind.  The design
// moves each byte once and keeps the issue slots busy:
//  - the grid is (image, chunk), and the kernel picks its chunks an image
//    from N and H x W alone (metric_chunks): one wave of the blocks the card
//    holds resident at once (its SMs times the blocks an SM holds, as the
//    occupancy API reports them: six of 256 threads on Hopper, the
//    __launch_bounds__ below), never under 128 pixels a chunk.  b128 at 224^2
//    takes 6 chunks an image (768 blocks of 792 slots), b64 at 518^2 12, one
//    224^2 image 392.  Against 8 blocks an SM's worth (9 and 17 chunks, 1.45
//    and 1.37 waves) it measured 2% slower at b128 and 2% faster at b64;
//    the partial second wave costs little, since each block is short;
//  - where an image's pixel count is a multiple of 4 and both maps are
//    16-byte aligned, a thread loads 16 bytes (float4) of each map at a
//    time, else one value.  A thread holds one word of each map at a time:
//    at 40 registers six blocks fit an SM, and 48 warps an SM hide the
//    loads (holding four words took 71 registers and three blocks, and
//    19-27% longer).  Offsets are 64-bit;
//  - __fdiv_rn and __frcp_rn leave their fast path for a zero operand, and
//    a warp waits for its slowest lane: with a zero in 20% of the
//    predictions and 30% of the targets (a depth map's holes) the b128
//    launch took 2.6 times as long.  So a zero operand's quotient (0, inf
//    or NaN, signed as IEEE signs it) is given without dividing;
//  - each thread keeps the ten running sums in registers; the block reduces
//    them with warp shuffles, then across its warps in shared memory, and
//    writes them to a workspace, one row a (image, chunk).  A second small
//    launch sums each image's rows over its chunks in a fixed order (in
//    double, rounded once to f32).  No float atomics: the output is the same
//    bits from run to run.
// It allocates nothing (the wrapper passes the workspace) and launches on
// the caller's stream, so a CUDA graph captures it.

#include "stage_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 6;  // at 40 registers a thread
constexpr int kFields = 10;  // the nine sums of metrics.SUM_FIELDS, then the count
constexpr long long kMinChunkPixels = 128;  // the fewest pixels a chunk
constexpr int kMaxDevices = 64;

// x / y correctly rounded, as __fdiv_rn; a zero operand's quotient without
// the division's slow path: x / 0 is inf, 0 / y is 0, each signed as x * y
// would be, and 0 / 0 or a NaN operand is NaN.
__device__ __forceinline__ float div_rn(float x, float y) {
  if (x != 0.f && y != 0.f) return __fdiv_rn(x, y);
  if (x != x || y != y || x == y) return __int_as_float(0x7fffffff);
  const float sign = copysignf(1.f, x) * copysignf(1.f, y);
  return y == 0.f ? copysignf(INFINITY, sign) : copysignf(0.f, sign);
}

// 1 / x correctly rounded (ATen's reciprocal); 1 / +-0 is +-inf.
__device__ __forceinline__ float rcp_rn(float x) {
  return x != 0.f ? __frcp_rn(x) : copysignf(INFINITY, x);
}

// One thread's running sums over the pixels it visits.
struct Sums {
  float sq_err = 0.f, abs_err = 0.f, lg10 = 0.f, absrel = 0.f, inv_sq_err = 0.f,
        inv_abs_err = 0.f;
  unsigned delta1 = 0, delta2 = 0, delta3 = 0, count = 0;

  // One pixel: prediction o, target t (metres), each term as ATen rounds it.
  __device__ __forceinline__ void add(float o, float t) {
    if (!(t > 0.f || o > 0.f)) return;
    const float om = __fmul_rn(1e3f, o), tm = __fmul_rn(1e3f, t);
    const float d = fabsf(__fsub_rn(om, tm));
    sq_err = __fadd_rn(sq_err, __fmul_rn(d, d));
    abs_err = __fadd_rn(abs_err, d);
    lg10 = __fadd_rn(lg10, fabsf(__fsub_rn(log10f(om), log10f(tm))));
    absrel = __fadd_rn(absrel, div_rn(d, tm));
    const float r1 = div_rn(om, tm), r2 = div_rn(tm, om);
    delta1 += r1 < 1.25f && r2 < 1.25f;
    delta2 += r1 < 1.5625f && r2 < 1.5625f;
    delta3 += r1 < 1.953125f && r2 < 1.953125f;
    const float iv = fabsf(__fsub_rn(rcp_rn(om), rcp_rn(tm)));
    inv_sq_err = __fadd_rn(inv_sq_err, __fmul_rn(iv, iv));
    inv_abs_err = __fadd_rn(inv_abs_err, iv);
    ++count;
  }
};

// Word i of p: V consecutive values (V = 4: p 16-byte aligned).
template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, long long i, float (&v)[V]);
template <>
__device__ __forceinline__ void load<1>(const float* __restrict__ p, long long i, float (&v)[1]) {
  v[0] = __ldg(p + i);
}
template <>
__device__ __forceinline__ void load<4>(const float* __restrict__ p, long long i, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// Block (image blockIdx.x, chunk blockIdx.y): the chunk's sums into
// partials[(image * chunks + chunk) * kFields + field].  Words of V pixels;
// a chunk is a run of consecutive words of one image.
template <int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    metric_partials_kernel(const float* __restrict__ out, const float* __restrict__ tgt,
                           float* __restrict__ partials, long long pixels, int chunks) {
  const long long words = pixels / V;
  const long long span = (words + chunks - 1) / chunks;
  const long long lo = blockIdx.y * span;
  const long long hi = lo + span < words ? lo + span : words;
  const long long base = static_cast<long long>(blockIdx.x) * pixels;
  const float* o_img = out + base;
  const float* t_img = tgt + base;
  Sums s;
  for (long long w = lo + threadIdx.x; w < hi; w += kThreads) {
    float o[V], t[V];
    load<V>(o_img, w, o);
    load<V>(t_img, w, t);
#pragma unroll
    for (int j = 0; j < V; ++j) s.add(o[j], t[j]);
  }
  float v[kFields] = {s.sq_err,
                      s.abs_err,
                      s.lg10,
                      s.absrel,
                      static_cast<float>(s.delta1),
                      static_cast<float>(s.delta2),
                      static_cast<float>(s.delta3),
                      s.inv_sq_err,
                      s.inv_abs_err,
                      static_cast<float>(s.count)};
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[f] += __shfl_down_sync(0xffffffffu, v[f], off);
  }
  __shared__ float warp_sums[kWarps][kFields];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < kFields; ++f) warp_sums[warp][f] = v[f];
  }
  __syncthreads();
  if (threadIdx.x < kFields) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) acc += warp_sums[k][threadIdx.x];
    partials[(static_cast<long long>(blockIdx.x) * chunks + blockIdx.y) * kFields +
             threadIdx.x] = acc;
  }
}

// Thread (field f, image n) of sums (kFields, images): partials' rows of
// image n summed over its chunks in order, in double, rounded once.
__global__ void __launch_bounds__(kThreads)
    metric_finish_kernel(const float* __restrict__ partials, float* __restrict__ sums,
                         long long images, int chunks) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= kFields * images) return;
  const long long f = i / images, n = i % images;
  const float* p = partials + n * chunks * kFields + f;
  double acc = 0.0;
  for (int c = 0; c < chunks; ++c) acc += static_cast<double>(p[c * kFields]);
  sums[i] = static_cast<float>(acc);
}

// The blocks of metric_partials_kernel<V> the current device holds resident
// at once: its SMs times the blocks an SM holds, as the occupancy API reports
// them; looked up once a device.
template <int V>
cudaError_t resident_blocks(int* blocks) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, metric_partials_kernel<V>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

// The chunks an image of K8's grid for `images` images of `pixels` pixels:
// as many as keep the whole grid resident at once (one wave), but no chunk
// under kMinChunkPixels pixels and no more rows than the workspace's
// `capacity`; at least one.
template <int V>
cudaError_t metric_chunks(long long images, long long pixels, long long capacity, int* chunks) {
  int resident = 0;
  const cudaError_t err = resident_blocks<V>(&resident);
  if (err != cudaSuccess) return err;
  long long c = (resident < capacity ? resident : capacity) / images;
  const long long most = (pixels + kMinChunkPixels - 1) / kMinChunkPixels;
  if (c > most) c = most;
  *chunks = c < 1 ? 1 : static_cast<int>(c);
  return cudaSuccess;
}

bool vectorised(const void* out, const void* tgt, long long pixels) {
  return pixels % 4 == 0 && fd_aligned16(out) && fd_aligned16(tgt);
}

bool valid(long long images, long long pixels, long long capacity) {
  return images > 0 && images <= 0x7fffffffLL && pixels >= 0 && capacity >= images;
}

}  // namespace

// The chunks an image fd_metric_sums cuts the same operands into, written to
// *chunks; returns a cudaError_t (0 = success).
extern "C" int fd_metric_sums_chunks(const void* out, const void* tgt, long long images,
                                     long long pixels, long long capacity, int* chunks) {
  if (!valid(images, pixels, capacity)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(vectorised(out, tgt, pixels)
                              ? metric_chunks<4>(images, pixels, capacity, chunks)
                              : metric_chunks<1>(images, pixels, capacity, chunks));
}

// out and tgt: `images` x `pixels` f32, dense (an (N, H, W, 1) tensor);
// partials: `capacity` rows of 10 f32 of workspace (capacity >= images; a
// wave of the card's blocks is enough for any shape); sums: (10, images)
// f32.  Launches on `stream` and returns the launches' cudaError_t (0 =
// success); it neither allocates nor syncs.
extern "C" int fd_metric_sums(const void* out, const void* tgt, void* partials, void* sums,
                              long long images, long long pixels, long long capacity,
                              void* stream) {
  if (images == 0) return cudaSuccess;
  if (!valid(images, pixels, capacity)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vectorised(out, tgt, pixels);
  int chunks = 1;
  cudaError_t err = vec ? metric_chunks<4>(images, pixels, capacity, &chunks)
                        : metric_chunks<1>(images, pixels, capacity, &chunks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(images), static_cast<unsigned>(chunks));
  const float* o = static_cast<const float*>(out);
  const float* t = static_cast<const float*>(tgt);
  float* p = static_cast<float*>(partials);
  if (vec) {
    metric_partials_kernel<4><<<grid, kThreads, 0, s>>>(o, t, p, pixels, chunks);
  } else {
    metric_partials_kernel<1><<<grid, kThreads, 0, s>>>(o, t, p, pixels, chunks);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (kFields * images + kThreads - 1) / kThreads;
  metric_finish_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      p, static_cast<float*>(sums), images, chunks);
  return static_cast<int>(cudaGetLastError());
}
