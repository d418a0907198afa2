// K1: one FastDepth NNConv5(dw) decoder level, fused, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// fastdepth_tpu/ops/pallas/fused_decoder.py::fused_decoder_stage.  Per
// image it computes
//
//     dw5x5 (zero pad 2, stride 1) + bias -> ReLU -> pw1x1 C->Cout + bias
//         -> ReLU -> nearest x2 upsample -> [+ skip]
//
// on NHWC memory (the port's channels_last tensors), f32 or bf16 in, f32
// accumulation, output in the input dtype.  There is no ReLU after the
// skip-add.
//
// What bounds it on the card.  Per image the pruned flagship's levels move
// 0.26 / 1.8 / 3.8 / 7.1 / 6.0 MB of input, skip and output in f32 and do
// 11 / 22 / 58 / 61 / 58 MFLOP: levels 2-5 sit below the f32 ridge (about
// 20 FLOP per byte on the CUDA cores) and are bound by device memory,
// level 1 (7x7, 512 -> 200) by its pointwise arithmetic; in bf16 every
// level is bound by memory.  The first version of this kernel reached
// about a quarter of that bound: it re-read the input (and redid the
// depthwise pass) for every 64-wide Cout tile, ran the pointwise product
// at one shared-memory load per one to four FMAs, launched a handful of
// blocks at the small levels, each walking all of C, and stored 4 bytes
// at a time.
//
// The design.  A block owns a tile of pixels of one image and a tile of
// Cout; where Cout <= 256 (every pruned level) the Cout tile is all of
// Cout, so each input tile is read and convolved once.  The block walks C
// in chunks, one barrier a chunk: after the barrier of step s the tile
// GEMM of chunk s runs beside the depthwise pass of chunk s + 1, while the
// zero-padded (TH+4)x(TW+4) halo of chunk s + 2 and the pointwise weight
// rows of chunk s + 1 arrive by cp.async (16 bytes a thread) into the
// shared-memory slots the step before has finished with; two depthwise
// tiles alternate likewise.  The depthwise taps are register-blocked: a
// thread slides the 5-wide window along a strip of 4 or 8 output pixels
// of one row and one channel, so each halo value is loaded once per strip
// and not once per tap.  The ReLU'd depthwise tile then enters the
// pointwise product, a tile GEMM [pixels x chunk] x [chunk x Cout tile]
// out of shared memory:
//   * f32 on the CUDA cores, each thread a 4-pixel x 8-channel register
//     tile, three 16-byte loads for 32 FMAs (no TF32: it would break the
//     f32 tolerance of 1e-4); a thread's 8 channels are two runs of 4
//     half the Cout tile apart, so that a warp's weight loads read one
//     contiguous run of shared memory, free of bank conflicts;
//   * bf16 on the tensor cores, mma.sync.m16n8k16 with f32 accumulation,
//     operands by ldmatrix, each warp a 32 x 32 tile.  The depthwise result
//     enters the product rounded to bf16: one rounding of the order of the
//     output's own, held to the bf16 tolerance 2^-7 * max|plain|.
// The epilogue stages the accumulators in shared memory, adds the bias,
// applies ReLU and writes each pixel's 2x2 duplicate with 16-byte stores
// coalesced along Cout, adding the skip read the same way.
//
// Occupancy.  The kernel is held to 128 registers a thread, two blocks of
// 256 threads an SM (unbounded, the f32 kernel took 134 and ran one block
// an SM), and the wrapper picks each C chunk
// so that the slots of the blocks an SM holds fit its shared memory.
// Where a level's tiles x images would leave SMs idle (the 7^2 and 14^2
// levels at small batch, every level at batch 1), the wrapper's launch
// geometry (ops/cuda/fused_decoder.py::launch_geometry) shrinks the block,
// and with it the pixel tile, splits Cout into tiles that recompute the
// cheap depthwise pass, and runs several groups of threads a block that
// split C and sum their partial products in a fixed order: no atomics, and
// the result is deterministic.  Shapes off the 16-byte grid (C or Cout
// not a multiple of 4 f32 / 8 bf16 values) take element loads and stores
// in the same structure.
//
// Index arithmetic.  The kernel issues more instructions than the card
// can overlap with its memory traffic, so the per-element index math is
// kept to shifts and multiplies: tiles are powers of two, and the halo's
// row / column split and the epilogue's item split divide by a
// multiply-high.
//
// What K1 shares with K2 and K3.  K2 (image groups) and K3 (persistent)
// run this design through stage_tile.cuh, which holds it generalised to
// image groups and to a walk over work items.  K1 takes from there only
// the leaf pieces (dw_strip, ldmatrix_x4 / _trans, mma_bf16, store16),
// and keeps its own copy of the rest (the chunk loaders, the depthwise
// loop, the tile GEMM, the epilogue and the pipeline): built from
// stage_tile.cuh's block, K1 gave the same results bit for bit but its
// bf16 levels with a skip ran 4-11% slower on an H100 (the same call,
// parent and change alternating), with f32 unchanged, and passing the
// epilogue's pointers restrict-qualified did not bring it back.  A
// change to the pieces below is a change to stage_tile.cuh's too.

#include "stage_tile.cuh"

namespace {

using fdk::cp_async16;
using fdk::cp_async_commit;
using fdk::cp_async_wait;
using fdk::dw_strip;
using fdk::from_float;
using fdk::ldmatrix_x4;
using fdk::ldmatrix_x4_trans;
using fdk::mma_bf16;
using fdk::store16;
using fdk::to_float;

constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may have on Hopper

// The launch geometry the wrapper chose (launch_geometry).  The block's
// threads form `ks` groups; each group walks every ks-th chunk of C with
// buffers of its own, and the epilogue sums the groups' partial products
// in group order (deterministic, no atomics).
struct Geom {
  int H, W, C, Cout;
  int th, tw;     // pixel tile: th rows x tw columns (P = th * tw), powers of two
  int th_log2, tw_log2;
  int tiles_w;    // tiles per tile row of an image
  int tiles;      // tiles per image
  int nc;         // Cout tile, a power of two
  int nc_log2;
  int ks;         // groups of threads splitting C
};

// Shared-memory carve-up in bytes, the same formula as launch_geometry.
// Per group, in the main loop: two slots, each the halo, the pointwise
// weight and the depthwise taps (25 rows and the bias) of a chunk, and two
// depthwise tiles; in the epilogue the group's f32 output tile, over the
// same bytes.
template <typename T, int KC>
struct Layout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kPixWords = KC * static_cast<int>(sizeof(T)) / 4;  // 4-byte words a pixel
  int row, halo, pw_stride, pw, taps, slot, dw, group, total;
  __host__ __device__ Layout(int th, int tw, int nc, int ks) {
    const int p = th * tw;
    // a halo row is padded so that consecutive rows start kPixWords banks
    // apart: the depthwise pass reads 32 / kPixWords rows at once
    const int pad_words = ((kPixWords * (1 - (tw + 4))) % 32 + 32) % 32;
    row = (tw + 4) * KC + pad_words * 4 / static_cast<int>(sizeof(T));  // elements
    halo = (th + 4) * row * static_cast<int>(sizeof(T));
    pw_stride = kBf16 ? nc + 8 : nc;  // +8: ldmatrix rows on distinct banks
    pw = KC * pw_stride * static_cast<int>(sizeof(T));
    taps = 26 * KC * static_cast<int>(sizeof(T));
    slot = halo + pw + taps;
    dw = kBf16 ? p * (KC + 8) * 2 : KC * (p + 4) * 4;
    const int epi = p * (nc + 4) * 4;
    const int main = 2 * (slot + dw);
    group = main > epi ? main : epi;
    total = ks * group;
  }
};

template <typename T, int KC, int SW>
__device__ __forceinline__ void depthwise(const T* halo, int row_len, const T* s_taps,
                                          unsigned char* s_dw, const Geom& g, int gtid, int tb) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int p_all = g.th * g.tw;
  const int nseg = g.tw / SW;
  const int items = KC * g.th * nseg;
  // channel fastest, then row: a warp reads 32 / KC rows of one strip.
  // The group's thread count is a multiple of KC, so a thread keeps one
  // channel, and its taps, for all its items.
  const int k = gtid % KC;
  float tap[25];  // channels past C load as 0 and give 0
#pragma unroll
  for (int t = 0; t < 25; ++t) tap[t] = to_float(s_taps[t * KC + k]);
  const float bias = to_float(s_taps[25 * KC + k]);
  for (int it = gtid; it < items; it += tb) {
    const int rs = it / KC;
    const int r = rs & (g.th - 1);
    const int col = (rs >> g.th_log2) * SW;
    float o[SW];
    dw_strip<T, KC, SW>(halo, row_len, r, col, k, tap, bias, o);
    const int p = r * g.tw + col;
    if constexpr (kBf16) {
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(s_dw);
#pragma unroll
      for (int j = 0; j < SW; ++j) d[(p + j) * (KC + 8) + k] = __float2bfloat16(o[j]);
    } else {
      float* d = reinterpret_cast<float*>(s_dw) + k * (p_all + 4) + p;
#pragma unroll
      for (int j = 0; j < SW; j += 4)
        *reinterpret_cast<float4*>(d + j) = make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]);
    }
  }
}

// At most 128 registers a thread, so that two blocks of 256 threads share
// an SM: with one block a level's barriers leave the SM idle.
template <typename T, int KC>
__global__ void __launch_bounds__(256, 2)
    k1_kernel(const T* __restrict__ x, const T* __restrict__ dw_w, const T* __restrict__ dw_b,
              const T* __restrict__ pw_w, const T* __restrict__ pw_b,
              const T* __restrict__ skip, T* __restrict__ out, Geom g, bool vec_x, bool vec_w,
              bool vec_o) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // values per 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T, KC> L(g.th, g.tw, g.nc, g.ks);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int tb = nthreads / g.ks;  // threads per group
  const int group = tid / tb;
  const int gtid = tid % tb;
  unsigned char* gsm = smem + group * L.group;
  // slot 0-1: a chunk's halo, pointwise weight and taps; depthwise tile 0-1
  auto s_halo = [&](int slot) { return reinterpret_cast<T*>(gsm + slot * L.slot); };
  auto s_pw = [&](int slot) { return reinterpret_cast<T*>(gsm + slot * L.slot + L.halo); };
  auto s_taps = [&](int slot) {
    return reinterpret_cast<T*>(gsm + slot * L.slot + L.halo + L.pw);
  };
  auto s_dw = [&](int i) { return gsm + 2 * L.slot + i * L.dw; };

  const int P = g.th * g.tw;
  const int nc = g.nc;
  const int hh = g.th + 4;
  const int hw = g.tw + 4;
  // q / hw as a multiply-high: exact for q < 2^16 (a halo has < 1000 pixels)
  const unsigned hw_magic = 0xffffffffu / hw + 1;
  auto div_hw = [&](int q) { return static_cast<int>(__umulhi(q, hw_magic)); };
  const int n = blockIdx.x / g.tiles;
  const int tile = blockIdx.x % g.tiles;
  const int h0 = (tile / g.tiles_w) * g.th;
  const int w0 = (tile % g.tiles_w) * g.tw;
  const int co0 = blockIdx.y * nc;
  const T* xn = x + static_cast<size_t>(n) * g.H * g.W * g.C;
  const T zero = from_float<T>(0.f);

  // chunk `chunk` of the halo and the depthwise taps into this group's
  // slot `slot`; past C everything reads as 0
  auto load_halo = [&](int chunk, int slot) {
    const int c0 = chunk * KC;
    T* sh = s_halo(slot);
    T* st = s_taps(slot);
    if (vec_x) {
      constexpr int kVecs = KC / V;
      for (int i = gtid; i < hh * hw * kVecs; i += tb) {
        const int q = i / kVecs;
        const int c = c0 + (i % kVecs) * V;
        const int qh = div_hw(q);
        const int qw = q - qh * hw;
        const int h = h0 - 2 + qh;
        const int w = w0 - 2 + qw;
        const bool ok = c < g.C && h >= 0 && h < g.H && w >= 0 && w < g.W;
        cp_async16(sh + qh * L.row + qw * KC + (i % kVecs) * V,
                   ok ? xn + (static_cast<size_t>(h) * g.W + w) * g.C + c : x, ok);
      }
      for (int i = gtid; i < 26 * kVecs; i += tb) {
        const int t = i / kVecs;
        const int c = c0 + (i % kVecs) * V;
        const bool ok = c < g.C;
        const T* src = t < 25 ? dw_w + static_cast<size_t>(t) * g.C + c : dw_b + c;
        cp_async16(st + t * KC + (i % kVecs) * V, ok ? src : dw_b, ok);
      }
    } else {
      for (int i = gtid; i < hh * hw * KC; i += tb) {
        const int q = i / KC;
        const int c = c0 + i % KC;
        const int qh = div_hw(q);
        const int qw = q - qh * hw;
        const int h = h0 - 2 + qh;
        const int w = w0 - 2 + qw;
        const bool ok = c < g.C && h >= 0 && h < g.H && w >= 0 && w < g.W;
        sh[qh * L.row + qw * KC + i % KC] =
            ok ? xn[(static_cast<size_t>(h) * g.W + w) * g.C + c] : zero;
      }
      for (int i = gtid; i < 26 * KC; i += tb) {
        const int t = i / KC;
        const int c = c0 + i % KC;
        st[i] = c >= g.C ? zero : t < 25 ? dw_w[static_cast<size_t>(t) * g.C + c] : dw_b[c];
      }
    }
  };
  // chunk `chunk`'s rows of the pointwise weight into slot `slot`
  auto load_pw = [&](int chunk, int slot) {
    const int c0 = chunk * KC;
    T* sp = s_pw(slot);
    if (vec_w) {
      const int vecs_log2 = g.nc_log2 - (V == 4 ? 2 : 3);  // nc / V vectors a row
      for (int i = gtid; i < KC << vecs_log2; i += tb) {
        const int k = i >> vecs_log2;
        const int j = (i & ((1 << vecs_log2) - 1)) * V;
        const bool ok = c0 + k < g.C && co0 + j < g.Cout;
        cp_async16(sp + k * L.pw_stride + j,
                   ok ? pw_w + static_cast<size_t>(c0 + k) * g.Cout + co0 + j : pw_w, ok);
      }
    } else {
      for (int i = gtid; i < KC * nc; i += tb) {
        const int k = i >> g.nc_log2;
        const int j = i & (nc - 1);
        const bool ok = c0 + k < g.C && co0 + j < g.Cout;
        sp[k * L.pw_stride + j] = ok ? pw_w[static_cast<size_t>(c0 + k) * g.Cout + co0 + j] : zero;
      }
    }
  };

  // the pointwise accumulators: f32, a thread's 4 pixels x 8 channels;
  // bf16, a warp's 32 x 32 tile as 2 x 4 m16n8 fragments
  constexpr int kAccM = kBf16 ? 2 : 4;
  constexpr int kAccN = kBf16 ? 4 : 8;
  constexpr int kAccR = kBf16 ? 4 : 1;
  float acc[kAccM][kAccN][kAccR];
#pragma unroll
  for (int i = 0; i < kAccM; ++i)
#pragma unroll
    for (int j = 0; j < kAccN; ++j)
#pragma unroll
      for (int r = 0; r < kAccR; ++r) acc[i][j][r] = 0.f;

  const int lane = gtid % 32;
  // f32: thread (tp, tc) holds pixels 4 tp .. 4 tp + 3 and channels
  // 4 tc .. 4 tc + 3 and nc / 2 + 4 tc .. nc / 2 + 4 tc + 3; a warp spans
  // at most 16 tc, so that each 16-byte weight load of the warp reads one
  // contiguous run of at most 256 bytes (no bank conflicts)
  const int tco = nc / 8;
  const int cw = tco < 16 ? tco : 16;
  const int tc = ((gtid / 32) % (tco / cw)) * cw + lane % cw;
  const int tp = ((gtid / 32) / (tco / cw)) * (32 / cw) + lane / cw;
  const int wco = nc / 32;  // bf16: warps along the Cout tile
  const int wc = (gtid / 32) % wco;
  const int wp = (gtid / 32) / wco;

  // the tile GEMM of one chunk: [P x KC] depthwise tile x [KC x nc] weight
  auto pointwise = [&](const unsigned char* s_a, const T* s_b) {
    if constexpr (kBf16) {
      const __nv_bfloat16* a_s = reinterpret_cast<const __nv_bfloat16*>(s_a);
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        unsigned a[2][4];
        unsigned b[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], a_s + (wp * 32 + mt * 16 + (lane & 15)) * (KC + 8) + kk +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned r[4];
          ldmatrix_x4_trans(r, s_b + (kk + (lane & 15)) * L.pw_stride + wc * 32 + np * 16 +
                                   (lane >> 4) * 8);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
    } else {
      const float* a_s = reinterpret_cast<const float*>(s_a) + tp * 4;
      const float* b_s = reinterpret_cast<const float*>(s_b) + tc * 4;
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(a_s + k * (P + 4));
        const float4 b0 = *reinterpret_cast<const float4*>(b_s + k * nc);
        const float4 b1 = *reinterpret_cast<const float4*>(b_s + k * nc + nc / 2);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j][0] = fmaf(av[i], bv[j], acc[i][j][0]);
      }
    }
  };

  // Group `group` takes chunks group, group + ks, ...: step s is chunk
  // group + s * ks.  Every group runs the same number of steps (a step
  // past C computes nothing) so that the block's barriers line up.  One
  // barrier a step: after it, the GEMM of step s runs beside the depthwise
  // pass of step s + 1, while the halo of step s + 2 and the pointwise
  // weight of step s + 1 arrive, each into the slot that step s - 1 (or s)
  // has finished with; the depthwise tiles alternate likewise.
  const int nchunks = (g.C + KC - 1) / KC;
  const int steps = (nchunks + g.ks - 1) / g.ks;
  auto live = [&](int s) { return s < steps && group + s * g.ks < nchunks; };
  // strips of 8 where the chunk has at least one for every thread
  const bool sw8 = g.tw >= 8 && KC * g.th * (g.tw / 8) >= tb;
  auto depthwise_step = [&](int s) {
    if (sw8)
      depthwise<T, KC, 8>(s_halo(s & 1), L.row, s_taps(s & 1), s_dw(s & 1), g, gtid, tb);
    else
      depthwise<T, KC, 4>(s_halo(s & 1), L.row, s_taps(s & 1), s_dw(s & 1), g, gtid, tb);
  };
  if (live(0)) {
    load_halo(group, 0);
    load_pw(group, 0);
  }
  cp_async_commit();
  if (live(1)) load_halo(group + g.ks, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (live(0)) depthwise_step(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();  // step s's weight and step s + 1's halo have landed
    __syncthreads();     // ... for every thread; step s - 1 is done with its slots
    if (live(s + 2)) load_halo(group + (s + 2) * g.ks, s & 1);
    if (live(s + 1)) load_pw(group + (s + 1) * g.ks, (s + 1) & 1);
    cp_async_commit();
    if (live(s)) pointwise(s_dw(s & 1), s_pw(s & 1));
    if (live(s + 1)) depthwise_step(s + 1);
  }
  __syncthreads();  // the epilogue's staging overwrites the slots

  // each group stages its partial product as a [P][nc + 4] f32 tile
  const int os = nc + 4;
  float* s_out = reinterpret_cast<float*>(smem);
  float* g_out = s_out + group * (L.group / 4);
  if constexpr (kBf16) {
    const int gq = lane >> 2;
    const int tq = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int p = wp * 32 + mt * 16 + gq;
        const int co = wc * 32 + nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(g_out + p * os + co) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(g_out + (p + 8) * os + co) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* d = g_out + (tp * 4 + i) * os + tc * 4;
      *reinterpret_cast<float4*>(d) =
          make_float4(acc[i][0][0], acc[i][1][0], acc[i][2][0], acc[i][3][0]);
      *reinterpret_cast<float4*>(d + nc / 2) =
          make_float4(acc[i][4][0], acc[i][5][0], acc[i][6][0], acc[i][7][0]);
    }
  }
  __syncthreads();

  // sum the groups in order, + bias, ReLU, each pixel as a 2x2 block,
  // + skip.  An item is (pixel, dx, channel group): consecutive threads
  // write a pixel's two horizontal copies as one run of 16-byte stores.
  const size_t H2 = 2 * static_cast<size_t>(g.H);
  const size_t W2 = 2 * static_cast<size_t>(g.W);
  const size_t row2 = W2 * g.Cout;  // one output row
  const int cvalid = min(nc, g.Cout - co0);
  const int gstride = L.group / 4;
  if (vec_o) {
    const int groups = cvalid / V;
    // i / groups as a multiply-high: exact for i < 2^16 (P * 2 * groups <=
    // 2^13); the magic of a divisor of 1 would not fit 32 bits
    const unsigned groups_magic = 0xffffffffu / groups + 1;
    for (int i = tid; i < P * 2 * groups; i += nthreads) {
      const int q = groups == 1 ? i : static_cast<int>(__umulhi(i, groups_magic));
      const int gi = i - q * groups;
      const int dx = q & 1;
      const int p = q >> 1;
      const int co = co0 + gi * V;
      const int h = h0 + (p >> g.tw_log2);
      const int w = w0 + (p & (g.tw - 1));
      if (h >= g.H || w >= g.W) continue;
      float v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = s_out[p * os + gi * V + j];
      for (int q = 1; q < g.ks; ++q)
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] += s_out[q * gstride + p * os + gi * V + j];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = fmaxf(v[j] + to_float(pw_b[co + j]), 0.f);
      const size_t o0 = ((n * H2 + 2 * h) * W2 + 2 * w + dx) * g.Cout + co;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const size_t o = o0 + dy * row2;
        float r[V];
        if (skip != nullptr) {
          fdk::load16(skip + o, r);
#pragma unroll
          for (int j = 0; j < V; ++j) r[j] += v[j];
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) r[j] = v[j];
        }
        store16(out + o, r);
      }
    }
  } else {
    for (int i = tid; i < P * cvalid; i += nthreads) {
      const int p = i / cvalid;
      const int ci = i - p * cvalid;
      const int h = h0 + (p >> g.tw_log2);
      const int w = w0 + (p & (g.tw - 1));
      if (h >= g.H || w >= g.W) continue;
      float v = s_out[p * os + ci];
      for (int q = 1; q < g.ks; ++q) v += s_out[q * gstride + p * os + ci];
      v = fmaxf(v + to_float(pw_b[co0 + ci]), 0.f);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const size_t o = ((n * H2 + 2 * h + dy) * W2 + 2 * w + dx) * g.Cout + co0 + ci;
          out[o] = from_float<T>(skip != nullptr ? v + to_float(skip[o]) : v);
        }
    }
  }
}

template <typename T, int KC>
cudaError_t launch(const void* x, const void* dw_w, const void* dw_b, const void* pw_w,
                   const void* pw_b, const void* skip, void* out, int N, const Geom& g,
                   int threads, cudaStream_t stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int smem = Layout<T, KC>(g.th, g.tw, g.nc, g.ks).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = k1_kernel<T, KC>;
  static int smem_allowed = 48 * 1024;  // per instantiation: raise the cap once
  if (smem > smem_allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    smem_allowed = kMaxSmem;
  }
  const bool vec_x =
      g.C % V == 0 && fd_aligned16(x) && fd_aligned16(dw_w) && fd_aligned16(dw_b);
  const bool vec_w = g.Cout % V == 0 && fd_aligned16(pw_w);
  const bool vec_o = g.Cout % V == 0 && fd_aligned16(out) && (skip == nullptr || fd_aligned16(skip));
  const dim3 grid(N * g.tiles, fd_ceil_div(g.Cout, g.nc));
  kernel<<<grid, threads * g.ks, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw_w), static_cast<const T*>(dw_b),
      static_cast<const T*>(pw_w), static_cast<const T*>(pw_b), static_cast<const T*>(skip),
      static_cast<T*>(out), g, vec_x, vec_w, vec_o);
  return cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

// x (N,H,W,C); dw_w (25,C); dw_b (C); pw_w (C,Cout); pw_b (Cout);
// skip (N,2H,2W,Cout) or null; out (N,2H,2W,Cout); all dense, one dtype:
// dtype 0 = float32, 1 = bfloat16.  The launch geometry (threads per
// group, the th x tw pixel tile, the Cout tile nc, the C chunk kc and the
// ks groups splitting C) comes from the wrapper's launch_geometry; a
// geometry the kernel does not take returns cudaErrorInvalidValue.
// Launches on `stream` and returns the launch's cudaError_t (0 =
// success); it neither allocates nor syncs.
extern "C" int fd_fused_decoder_stage(const void* x, const void* dw_w, const void* dw_b,
                                      const void* pw_w, const void* pw_b, const void* skip,
                                      void* out, int N, int H, int W, int C, int Cout,
                                      int threads, int th, int tw, int nc, int kc, int ks,
                                      int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  const int p = th * tw;
  const int lanes = bf16 ? 32 : 8;  // Cout per warp column (bf16) / per thread (f32)
  const int rows = bf16 ? 32 : 4;   // pixels per warp row (bf16) / per thread (f32)
  const int units = bf16 ? threads / 32 : threads;
  const bool ok = (dtype == 0 || dtype == 1) && N > 0 && H > 0 && W > 0 && C > 0 &&
                  Cout > 0 && pow2(threads) && threads >= 32 && pow2(ks) &&
                  threads * ks <= 256 && (tw == 4 || tw == 8 || tw == 16 || tw == 32) &&
                  pow2(th) && pow2(nc) && nc >= lanes && nc <= 256 && nc / lanes <= units &&
                  p == units / (nc / lanes) * rows;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.Cout = Cout;
  g.th = th;
  g.tw = tw;
  g.th_log2 = __builtin_ctz(th);
  g.tw_log2 = __builtin_ctz(tw);
  g.tiles_w = fd_ceil_div(W, tw);
  g.tiles = fd_ceil_div(H, th) * g.tiles_w;
  g.nc = nc;
  g.nc_log2 = __builtin_ctz(nc);
  g.ks = ks;
  if (static_cast<long long>(N) * g.tiles > 0x7fffffffLL || fd_ceil_div(Cout, nc) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!bf16) {
    switch (kc) {
      case 8: return static_cast<int>(launch<float, 8>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, g, threads, s));
      case 16: return static_cast<int>(launch<float, 16>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, g, threads, s));
      case 32: return static_cast<int>(launch<float, 32>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, g, threads, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (kc) {
    case 16: return static_cast<int>(launch<__nv_bfloat16, 16>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, g, threads, s));
    case 32: return static_cast<int>(launch<__nv_bfloat16, 32>(x, dw_w, dw_b, pw_w, pw_b, skip, out, N, g, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
