// The fused decoder level's block over image groups, for K2
// (fused_decoder_hwbc.cu) and K3 (fused_decoder_v3.cu): K1's design
// (fused_decoder.cu), generalised to items of several images and to a
// walk over items.
//
// One block computes, for one work item, the function
//
//     dw5x5 (zero pad 2, stride 1) + bias -> ReLU -> pw1x1 C->Cout + bias
//         -> ReLU -> nearest x2 upsample -> [+ skip]
//
// on NHWC memory, f32 or bf16 in, f32 accumulation, output in the input
// dtype.  An item is a th x tw pixel tile of each of 1 << b_log2 images
// (an image group) and a Cout tile of nc channels (all of Cout where
// Cout <= 256).  The pointwise product of an item is one tile
// GEMM whose M dimension is images x pixels, so each chunk of pointwise
// weights and depthwise taps loaded into shared memory serves every image
// of the group.
//
// The pieces, K1's design (its header says what bounds it on the card):
//   * the C chunk loaders: each image's zero-padded (th+4)x(tw+4) halo and
//     the chunk's depthwise taps (load_halo), the chunk's pointwise weight
//     rows (load_pw), 16 bytes a thread by cp.async where the operands are
//     aligned, element loads otherwise;
//   * the depthwise pass: register-blocked strips of 4 or 8 output pixels
//     of one row and one channel (dw_strip), so each halo value is loaded
//     once per strip and not once per tap;
//   * the pointwise tile GEMM: f32 on the CUDA cores, each thread a
//     4-pixel x 8-channel register tile (no TF32); bf16 on the tensor
//     cores, mma.sync.m16n8k16 with f32 accumulation, operands by ldmatrix,
//     each warp a 32 x 32 tile;
//   * the epilogue: the accumulators staged in shared memory, the ks thread
//     groups' partial products summed in group order, + bias, ReLU, each
//     pixel's 2x2 duplicate written with 16-byte stores, the skip read the
//     same way.
// The main loops (run_item: one item a block, K2; run_persistent: K3's
// walk over items) drive them through a two-slot chunk pipeline with one
// barrier a chunk.  K1 takes the leaf pieces from here (dw_strip,
// ldmatrix_x4 / _trans, mma_bf16, store16) and keeps its own one-image
// copy of the rest; fused_decoder.cu's header says why.

#pragma once

#include "stage_common.cuh"

namespace fdk {

constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may have on Hopper

// The launch geometry the wrapper chose (ops/cuda/fused_decoder.py::
// launch_geometry, through K2's and K3's).  The block's threads form `ks` groups; each
// group walks every ks-th chunk of C with buffers of its own, and the
// epilogue sums the groups' partial products in group order
// (deterministic, no atomics).
struct Geom {
  int N, H, W, C, Cout;
  int th, tw;     // pixel tile of each image: th rows x tw columns, powers of two
  int th_log2, tw_log2;
  int tiles_w;    // tiles per tile row of an image
  int tiles;      // tiles per image
  int nc;         // Cout tile, a power of two
  int nc_log2;
  int ks;         // groups of threads splitting C
  int b_log2;     // images per item: 1 << b_log2
  int n_ct;       // Cout tiles
};

// Shared-memory carve-up in bytes, the same formula as the wrappers'
// smem_bytes.  Per group, in the main loop: two slots, each the halos of
// the item's images, the pointwise weight and the depthwise taps (25 rows
// and the bias) of a chunk, and two depthwise tiles.  In the epilogue,
// one item a block: each group's f32 output tile, over the same bytes;
// persistent: one f32 output tile for the block after the groups' bytes
// (the next item's chunks are in flight while an item's epilogue runs),
// into which the groups add their partial products in group order.
template <typename T, int KC>
struct Layout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kPixWords = KC * static_cast<int>(sizeof(T)) / 4;  // 4-byte words a pixel
  int row, halo_img, halo, pw_stride, pw, taps, slot, dw, epi_off, group, total;
  __host__ __device__ Layout(int th, int tw, int nc, int ks, int b_log2, bool persistent) {
    const int m = (th * tw) << b_log2;
    // a halo row is padded so that consecutive rows start kPixWords banks
    // apart: the depthwise pass reads 32 / kPixWords rows at once
    const int pad_words = ((kPixWords * (1 - (tw + 4))) % 32 + 32) % 32;
    row = (tw + 4) * KC + pad_words * 4 / static_cast<int>(sizeof(T));  // elements
    halo_img = (th + 4) * row * static_cast<int>(sizeof(T));
    halo = halo_img << b_log2;
    pw_stride = kBf16 ? nc + 8 : nc;  // +8: ldmatrix rows on distinct banks
    pw = KC * pw_stride * static_cast<int>(sizeof(T));
    taps = 26 * KC * static_cast<int>(sizeof(T));
    slot = halo + pw + taps;
    dw = kBf16 ? m * (KC + 8) * 2 : KC * (m + 4) * 4;
    const int epi = m * (nc + 4) * 4;
    const int main = 2 * (slot + dw);
    group = persistent ? main : (main > epi ? main : epi);
    epi_off = persistent ? ks * main : 0;
    total = ks * group + (persistent ? epi : 0);
  }
};

// One item: images n0 .. n0 + (1 << b_log2) - 1, the pixel tile at
// (h0, w0) of each, output channels co0 .. co0 + nc - 1.
struct Item {
  int n0, h0, w0, co0;
};

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d += a * b: one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One item of the depthwise pass: channel k of the chunk, output row r of
// the tile, output columns [col, col + SW).  The 5-wide window slides
// along the strip: each halo value of the 5 input rows is loaded once.
// Returns the ReLU'd results in o.
template <typename T, int KC, int SW>
__device__ __forceinline__ void dw_strip(const T* halo, int row_len, int r, int col, int k,
                                         const float (&tap)[25], float bias, float (&o)[SW]) {
#pragma unroll
  for (int j = 0; j < SW; ++j) o[j] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
    const T* row = halo + (r + dy) * row_len + col * KC + k;
    float v[SW + 4];
#pragma unroll
    for (int j = 0; j < SW + 4; ++j) v[j] = to_float(row[j * KC]);
#pragma unroll
    for (int dx = 0; dx < 5; ++dx)
#pragma unroll
      for (int j = 0; j < SW; ++j) o[j] = fmaf(v[j + dx], tap[dy * 5 + dx], o[j]);
  }
#pragma unroll
  for (int j = 0; j < SW; ++j) o[j] = fmaxf(o[j] + bias, 0.f);
}

// The block's state and its pieces.  kPersistent: the epilogue stages
// after the main loop's buffers (K3).
template <typename T, int KC, bool kPersistent>
struct StageBlock {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // values per 16-byte vector
  // the pointwise accumulators: f32, a thread's 4 pixels x 8 channels;
  // bf16, a warp's 32 x 32 tile as 2 x 4 m16n8 fragments
  static constexpr int kAccM = kBf16 ? 2 : 4;
  static constexpr int kAccN = kBf16 ? 4 : 8;
  static constexpr int kAccR = kBf16 ? 4 : 1;

  const T* __restrict__ x;
  const T* __restrict__ dw_w;
  const T* __restrict__ dw_b;
  const T* __restrict__ pw_w;
  const T* __restrict__ pw_b;
  const T* __restrict__ skip;
  T* __restrict__ out;
  const Geom g;
  const Layout<T, KC> L;
  const bool vec_x, vec_w, vec_o;
  unsigned char* smem;
  unsigned char* gsm;
  int tid, nthreads, tb, group, gtid, lane;
  int b_log2;  // images per item, log2
  int P;       // pixels per image and tile
  int M;       // the tile GEMM's rows: images x pixels
  int hh, hw;
  unsigned hw_magic;
  int tc, tp, wc, wp;
  bool sw8;
  float acc[kAccM][kAccN][kAccR];

  __device__ __forceinline__ StageBlock(const T* x_, const T* dw_w_, const T* dw_b_,
                                        const T* pw_w_, const T* pw_b_, const T* skip_, T* out_,
                                        const Geom& g_, bool vec_x_, bool vec_w_, bool vec_o_,
                                        unsigned char* smem_)
      : x(x_), dw_w(dw_w_), dw_b(dw_b_), pw_w(pw_w_), pw_b(pw_b_), skip(skip_), out(out_),
        g(g_), L(g_.th, g_.tw, g_.nc, g_.ks, g_.b_log2, kPersistent),
        vec_x(vec_x_), vec_w(vec_w_), vec_o(vec_o_), smem(smem_) {
    tid = threadIdx.x;
    nthreads = blockDim.x;
    tb = nthreads / g.ks;  // threads per group
    group = tid / tb;
    gtid = tid % tb;
    gsm = smem + group * L.group;
    lane = gtid % 32;
    b_log2 = g.b_log2;
    P = g.th * g.tw;
    M = P << b_log2;
    hh = g.th + 4;
    hw = g.tw + 4;
    // q / hw as a multiply-high: exact for q < 2^16 (a halo has < 1000 pixels)
    hw_magic = 0xffffffffu / hw + 1;
    // f32: thread (tp, tc) holds rows 4 tp .. 4 tp + 3 and channels
    // 4 tc .. 4 tc + 3 and nc / 2 + 4 tc .. nc / 2 + 4 tc + 3; a warp spans
    // at most 16 tc, so that each 16-byte weight load of the warp reads one
    // contiguous run of at most 256 bytes (no bank conflicts)
    const int tco = g.nc / 8;
    const int cw = tco < 16 ? tco : 16;
    tc = ((gtid / 32) % (tco / cw)) * cw + lane % cw;
    tp = ((gtid / 32) / (tco / cw)) * (32 / cw) + lane / cw;
    const int wco = g.nc / 32;  // bf16: warps along the Cout tile
    wc = (gtid / 32) % wco;
    wp = (gtid / 32) / wco;
    // strips of 8 where the chunk has at least one for every thread
    sw8 = g.tw >= 8 && (KC * g.th * (g.tw / 8) << b_log2) >= tb;
    zero_acc();
  }

  // slot 0-1: a chunk's halos, pointwise weight and taps; depthwise tile 0-1
  __device__ __forceinline__ T* s_halo(int slot) const {
    return reinterpret_cast<T*>(gsm + slot * L.slot);
  }
  __device__ __forceinline__ T* s_pw(int slot) const {
    return reinterpret_cast<T*>(gsm + slot * L.slot + L.halo);
  }
  __device__ __forceinline__ T* s_taps(int slot) const {
    return reinterpret_cast<T*>(gsm + slot * L.slot + L.halo + L.pw);
  }
  __device__ __forceinline__ unsigned char* s_dw(int i) const {
    return gsm + 2 * L.slot + i * L.dw;
  }
  __device__ __forceinline__ int div_hw(int q) const {
    return static_cast<int>(__umulhi(q, hw_magic));
  }

  __device__ __forceinline__ void zero_acc() {
#pragma unroll
    for (int i = 0; i < kAccM; ++i)
#pragma unroll
      for (int j = 0; j < kAccN; ++j)
#pragma unroll
        for (int r = 0; r < kAccR; ++r) acc[i][j][r] = 0.f;
  }

  // chunk `chunk` of each image's halo and of the depthwise taps into this
  // group's slot `slot`; past C, outside the image and past N (a ragged
  // last group) everything reads as 0
  __device__ __forceinline__ void load_halo(const Item& it, int chunk, int slot) {
    const int c0 = chunk * KC;
    const T zero = from_float<T>(0.f);
    const int images = 1 << b_log2;
    for (int b = 0; b < images; ++b) {
      const int n = it.n0 + b;
      const bool img_ok = n < g.N;
      const T* xn = x + static_cast<size_t>(n) * g.H * g.W * g.C;
      T* sh = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(s_halo(slot)) +
                                   b * L.halo_img);
      if (vec_x) {
        constexpr int kVecs = KC / V;
        for (int i = gtid; i < hh * hw * kVecs; i += tb) {
          const int q = i / kVecs;
          const int c = c0 + (i % kVecs) * V;
          const int qh = div_hw(q);
          const int qw = q - qh * hw;
          const int h = it.h0 - 2 + qh;
          const int w = it.w0 - 2 + qw;
          const bool ok = img_ok && c < g.C && h >= 0 && h < g.H && w >= 0 && w < g.W;
          cp_async16(sh + qh * L.row + qw * KC + (i % kVecs) * V,
                     ok ? xn + (static_cast<size_t>(h) * g.W + w) * g.C + c : x, ok);
        }
      } else {
        for (int i = gtid; i < hh * hw * KC; i += tb) {
          const int q = i / KC;
          const int c = c0 + i % KC;
          const int qh = div_hw(q);
          const int qw = q - qh * hw;
          const int h = it.h0 - 2 + qh;
          const int w = it.w0 - 2 + qw;
          const bool ok = img_ok && c < g.C && h >= 0 && h < g.H && w >= 0 && w < g.W;
          sh[qh * L.row + qw * KC + i % KC] =
              ok ? xn[(static_cast<size_t>(h) * g.W + w) * g.C + c] : zero;
        }
      }
    }
    T* st = s_taps(slot);
    if (vec_x) {
      constexpr int kVecs = KC / V;
      for (int i = gtid; i < 26 * kVecs; i += tb) {
        const int t = i / kVecs;
        const int c = c0 + (i % kVecs) * V;
        const bool ok = c < g.C;
        const T* src = t < 25 ? dw_w + static_cast<size_t>(t) * g.C + c : dw_b + c;
        cp_async16(st + t * KC + (i % kVecs) * V, ok ? src : dw_b, ok);
      }
    } else {
      for (int i = gtid; i < 26 * KC; i += tb) {
        const int t = i / KC;
        const int c = c0 + i % KC;
        st[i] = c >= g.C ? zero : t < 25 ? dw_w[static_cast<size_t>(t) * g.C + c] : dw_b[c];
      }
    }
  }

  // chunk `chunk`'s rows of the pointwise weight into slot `slot`
  __device__ __forceinline__ void load_pw(const Item& it, int chunk, int slot) {
    const int c0 = chunk * KC;
    const int co0 = it.co0;
    const int nc = g.nc;
    const T zero = from_float<T>(0.f);
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
  }

  template <int SW>
  __device__ __forceinline__ void depthwise(const T* halo, const T* s_t, unsigned char* s_d) {
    const int nseg = g.tw / SW;
    const int nseg_log2 = g.tw_log2 - (SW == 8 ? 3 : 2);
    const int items = (KC * g.th * nseg) << b_log2;
    // channel fastest, then row, then strip, then image: a warp reads
    // 32 / KC rows of one strip.  The group's thread count is a multiple
    // of KC, so a thread keeps one channel, and its taps, for all its items.
    const int k = gtid % KC;
    float tap[25];  // channels past C load as 0 and give 0
#pragma unroll
    for (int t = 0; t < 25; ++t) tap[t] = to_float(s_t[t * KC + k]);
    const float bias = to_float(s_t[25 * KC + k]);
    for (int it = gtid; it < items; it += tb) {
      const int rs = it / KC;
      const int r = rs & (g.th - 1);
      const int rest = rs >> g.th_log2;
      const int col = (rest & (nseg - 1)) * SW;
      const int b = rest >> nseg_log2;
      float o[SW];
      dw_strip<T, KC, SW>(halo + b * (L.halo_img / static_cast<int>(sizeof(T))), L.row, r, col,
                          k, tap, bias, o);
      const int p = b * P + r * g.tw + col;
      if constexpr (kBf16) {
        __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(s_d);
#pragma unroll
        for (int j = 0; j < SW; ++j) d[(p + j) * (KC + 8) + k] = __float2bfloat16(o[j]);
      } else {
        float* d = reinterpret_cast<float*>(s_d) + k * (M + 4) + p;
#pragma unroll
        for (int j = 0; j < SW; j += 4)
          *reinterpret_cast<float4*>(d + j) = make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]);
      }
    }
  }

  __device__ __forceinline__ void depthwise_step(int slot) {
    if (sw8)
      depthwise<8>(s_halo(slot), s_taps(slot), s_dw(slot));
    else
      depthwise<4>(s_halo(slot), s_taps(slot), s_dw(slot));
  }

  // the tile GEMM of one chunk: [M x KC] depthwise tile x [KC x nc] weight
  __device__ __forceinline__ void pointwise(int slot) {
    const unsigned char* s_a = s_dw(slot);
    const T* s_b = s_pw(slot);
    const int nc = g.nc;
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
        const float4 a = *reinterpret_cast<const float4*>(a_s + k * (M + 4));
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
  }

  // this group's partial product into an [M][nc + 4] f32 tile: written
  // (add = false) or added to what is there (add = true)
  __device__ __forceinline__ void put_acc(float* g_out, bool add) {
    const int nc = g.nc;
    const int os = nc + 4;
    if constexpr (kBf16) {
      const int gq = lane >> 2;
      const int tq = lane & 3;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int p = wp * 32 + mt * 16 + gq;
          const int co = wc * 32 + nt * 8 + 2 * tq;
          float2* d0 = reinterpret_cast<float2*>(g_out + p * os + co);
          float2* d1 = reinterpret_cast<float2*>(g_out + (p + 8) * os + co);
          float2 v0 = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
          float2 v1 = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
          if (add) {
            const float2 a0 = *d0, a1 = *d1;
            v0 = make_float2(a0.x + v0.x, a0.y + v0.y);
            v1 = make_float2(a1.x + v1.x, a1.y + v1.y);
          }
          *d0 = v0;
          *d1 = v1;
        }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* d = g_out + (tp * 4 + i) * os + tc * 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float4* dh = reinterpret_cast<float4*>(d + h * (nc / 2));
          float4 v = make_float4(acc[i][4 * h][0], acc[i][4 * h + 1][0], acc[i][4 * h + 2][0],
                                 acc[i][4 * h + 3][0]);
          if (add) {
            const float4 a = *dh;
            v = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
          }
          *dh = v;
        }
      }
    }
  }

  // The partial products into the epilogue's staging.  One item a block:
  // each group writes its own tile (the epilogue sums them in group
  // order).  Persistent: the groups add theirs into the block's one tile
  // in group order, a barrier apart, which sums in the same order; it
  // ends with a barrier.
  __device__ __forceinline__ void stage_acc() {
    float* s_out = reinterpret_cast<float*>(smem + L.epi_off);
    if constexpr (kPersistent) {
      for (int q = 0; q < g.ks; ++q) {
        if (group == q) put_acc(s_out, q > 0);
        __syncthreads();
      }
    } else {
      put_acc(s_out + group * (L.group / 4), false);
    }
  }

  // sum the groups in order, + bias, ReLU, each pixel as a 2x2 block,
  // + skip.  An item is (row, dx, channel group): consecutive threads
  // write a pixel's two horizontal copies as one run of 16-byte stores.
  // Rows of images past N and pixels outside the image are not written.
  // The callers pass the block's pw_b, skip and out as `bias`, `res` and
  // `dst`, restrict-qualified as the kernel's own parameters are (a struct
  // member drops the qualifier), so that a row's loads need not wait for
  // the previous row's stores.
  __device__ __forceinline__ void epilogue(const Item& it, const T* __restrict__ bias,
                                           const T* __restrict__ res, T* __restrict__ dst) {
    const int nc = g.nc;
    const int os = nc + 4;
    const float* s_out = reinterpret_cast<const float*>(smem + L.epi_off);
    const int co0 = it.co0;
    const int P_log2 = g.th_log2 + g.tw_log2;
    const size_t H2 = 2 * static_cast<size_t>(g.H);
    const size_t W2 = 2 * static_cast<size_t>(g.W);
    const size_t row2 = W2 * g.Cout;  // one output row
    const int cvalid = min(nc, g.Cout - co0);
    const int gstride = L.group / 4;
    const int parts = kPersistent ? 1 : g.ks;  // persistent: summed while staged
    if (vec_o) {
      const int groups = cvalid / V;
      // i / groups as a multiply-high: exact for i < 2^16 (M * 2 * groups <=
      // 2^13); the magic of a divisor of 1 would not fit 32 bits
      const unsigned groups_magic = 0xffffffffu / groups + 1;
      for (int i = tid; i < M * 2 * groups; i += nthreads) {
        const int q = groups == 1 ? i : static_cast<int>(__umulhi(i, groups_magic));
        const int gi = i - q * groups;
        const int dx = q & 1;
        const int p = q >> 1;
        const int px = p & (P - 1);
        const int n = it.n0 + (p >> P_log2);
        const int co = co0 + gi * V;
        const int h = it.h0 + (px >> g.tw_log2);
        const int w = it.w0 + (px & (g.tw - 1));
        if (h >= g.H || w >= g.W || n >= g.N) continue;
        float v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = s_out[p * os + gi * V + j];
        for (int q = 1; q < parts; ++q)
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] += s_out[q * gstride + p * os + gi * V + j];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = fmaxf(v[j] + to_float(__ldg(bias + co + j)), 0.f);
        const size_t o0 = ((n * H2 + 2 * h) * W2 + 2 * w + dx) * g.Cout + co;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const size_t o = o0 + dy * row2;
          float r[V];
          if (res != nullptr) {
            load16(res + o, r);
#pragma unroll
            for (int j = 0; j < V; ++j) r[j] += v[j];
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) r[j] = v[j];
          }
          store16(dst + o, r);
        }
      }
    } else {
      for (int i = tid; i < M * cvalid; i += nthreads) {
        const int p = i / cvalid;
        const int ci = i - p * cvalid;
        const int px = p & (P - 1);
        const int n = it.n0 + (p >> P_log2);
        const int h = it.h0 + (px >> g.tw_log2);
        const int w = it.w0 + (px & (g.tw - 1));
        if (h >= g.H || w >= g.W || n >= g.N) continue;
        float v = s_out[p * os + ci];
        for (int q = 1; q < parts; ++q) v += s_out[q * gstride + p * os + ci];
        v = fmaxf(v + to_float(__ldg(bias + co0 + ci)), 0.f);
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const size_t o = ((n * H2 + 2 * h + dy) * W2 + 2 * w + dx) * g.Cout + co0 + ci;
            dst[o] = from_float<T>(res != nullptr ? v + to_float(__ldg(res + o)) : v);
          }
      }
    }
  }
};

// One item a block (K2).  Group `group` takes chunks group, group +
// ks, ...: step s is chunk group + s * ks.  Every group runs the same
// number of steps (a step past C computes nothing) so that the block's
// barriers line up.  One barrier a step: after it, the GEMM of step s runs
// beside the depthwise pass of step s + 1, while the halo of step s + 2
// and the pointwise weight of step s + 1 arrive, each into the slot that
// step s - 1 (or s) has finished with; the depthwise tiles alternate
// likewise.
template <typename T, int KC>
__device__ __forceinline__ void run_item(StageBlock<T, KC, false>& sb, const Item& it) {
  const Geom& g = sb.g;
  const int group = sb.group;
  const int nchunks = (g.C + KC - 1) / KC;
  const int steps = (nchunks + g.ks - 1) / g.ks;
  auto live = [&](int s) { return s < steps && group + s * g.ks < nchunks; };
  if (live(0)) {
    sb.load_halo(it, group, 0);
    sb.load_pw(it, group, 0);
  }
  cp_async_commit();
  if (live(1)) sb.load_halo(it, group + g.ks, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (live(0)) sb.depthwise_step(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();  // step s's weight and step s + 1's halo have landed
    __syncthreads();     // ... for every thread; step s - 1 is done with its slots
    if (live(s + 2)) sb.load_halo(it, group + (s + 2) * g.ks, s & 1);
    if (live(s + 1)) sb.load_pw(it, group + (s + 1) * g.ks, (s + 1) & 1);
    cp_async_commit();
    if (live(s)) sb.pointwise(s & 1);
    if (live(s + 1)) sb.depthwise_step((s + 1) & 1);
  }
  __syncthreads();  // the epilogue's staging overwrites the slots
  sb.stage_acc();
  __syncthreads();
  sb.epilogue(it, sb.pw_b, sb.skip, sb.out);
}

// Item `j` of the persistent walk (K3): Cout tile fastest, so that blocks
// running side by side share an input tile in L2; then the pixel tile,
// then the image group.
__device__ __forceinline__ Item decode_item(const Geom& g, int j) {
  const int ct = j % g.n_ct;
  const int rest = j / g.n_ct;
  const int tile = rest % g.tiles;
  const int grp = rest / g.tiles;
  return Item{grp << g.b_log2, (tile / g.tiles_w) * g.th, (tile % g.tiles_w) * g.tw,
              ct * g.nc};
}

// The persistent walk (K3): the block takes items blockIdx.x, blockIdx.x
// + gridDim.x, ... (n_items in all), and runs run_item's pipeline over the
// flat sequence of (item, step): the slots and depthwise tiles alternate
// across item boundaries, so item j + 1's first halo and weight load, and
// its first depthwise pass runs, while item j's last chunk computes.  An
// item's epilogue stages after the pipeline's buffers (Layout with
// persistent = true) and runs while the next item's copies are in flight.
// The loop tracks its place incrementally (t, this step's place in its
// item, and the items of this step and the next two), with no division a
// step.
template <typename T, int KC>
__device__ __forceinline__ void run_persistent(StageBlock<T, KC, true>& sb, int n_items) {
  const Geom& g = sb.g;
  const int group = sb.group;
  const int nchunks = (g.C + KC - 1) / KC;
  const int steps = (nchunks + g.ks - 1) / g.ks;
  const int first = static_cast<int>(blockIdx.x);
  const int stride = static_cast<int>(gridDim.x);
  const int my_items = first < n_items ? (n_items - 1 - first) / stride + 1 : 0;
  const int total = my_items * steps;
  auto decode = [&](int k) { return decode_item(g, first + k * stride); };
  int k = 0;  // this step's item, of the block's
  int t = 0;  // this step's place in it
  Item it0 = decode(0), it1 = decode(1), it2 = decode(2);  // items k, k + 1, k + 2
  // step s + d (d = 0, 1, 2): its item and chunk; returns whether it has work
  auto place = [&](int s, int d, Item& it, int& chunk) {
    int u = t + d;
    it = it0;
    if (u >= steps) {
      u -= steps;
      it = it1;
      if (u >= steps) {
        u -= steps;
        it = it2;
      }
    }
    chunk = group + u * g.ks;
    return s + d < total && chunk < nchunks;
  };
  Item it;
  int chunk;
  if (place(0, 0, it, chunk)) {
    sb.load_halo(it, chunk, 0);
    sb.load_pw(it, chunk, 0);
  }
  cp_async_commit();
  if (place(0, 1, it, chunk)) sb.load_halo(it, chunk, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (place(0, 0, it, chunk)) sb.depthwise_step(0);
  for (int s = 0; s < total; ++s) {
    cp_async_wait<0>();  // step s's weight and step s + 1's halo have landed
    __syncthreads();     // ... for every thread; step s - 1 is done with its slots
    if (place(s, 2, it, chunk)) sb.load_halo(it, chunk, s & 1);
    if (place(s, 1, it, chunk)) sb.load_pw(it, chunk, (s + 1) & 1);
    cp_async_commit();
    if (place(s, 0, it, chunk)) sb.pointwise(s & 1);
    if (place(s, 1, it, chunk)) sb.depthwise_step((s + 1) & 1);
    if (++t == steps) {  // item k's last step: the same for every thread
      sb.stage_acc();    // ends with a barrier: every group has added its part
      sb.zero_acc();
      sb.epilogue(it0, sb.pw_b, sb.skip, sb.out);  // the next staging follows the loop's barriers
      t = 0;
      ++k;
      it0 = it1;
      it1 = it2;
      it2 = decode(k + 2);
    }
  }
  cp_async_wait<0>();
}

inline bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The host's check of a launch geometry and the Geom it gives: the block
// shapes the kernels take (threads per group a power of two >= 32, ks
// groups, at most 256 threads; tw 4-32 and th powers of two; a
// power-of-two Cout tile of 8-256 f32 / 32-256 bf16 channels; the tile
// GEMM's rows images x pixels = what the threads' register tiles cover).
inline bool make_geom(Geom& g, int N, int H, int W, int C, int Cout, int threads, int th,
                      int tw, int nc, int ks, int b_log2, int dtype) {
  const bool bf16 = dtype == 1;
  const int m = (th * tw) << b_log2;
  const int lanes = bf16 ? 32 : 8;  // Cout per warp column (bf16) / per thread (f32)
  const int rows = bf16 ? 32 : 4;   // rows per warp row (bf16) / per thread (f32)
  const int units = bf16 ? threads / 32 : threads;
  const bool ok = (dtype == 0 || dtype == 1) && N > 0 && H > 0 && W > 0 && C > 0 &&
                  Cout > 0 && pow2(threads) && threads >= 32 && pow2(ks) &&
                  threads * ks <= 256 && (tw == 4 || tw == 8 || tw == 16 || tw == 32) &&
                  pow2(th) && pow2(nc) && nc >= lanes && nc <= 256 && nc / lanes <= units &&
                  b_log2 >= 0 && b_log2 <= 3 && m == units / (nc / lanes) * rows;
  if (!ok) return false;
  g.N = N;
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
  g.b_log2 = b_log2;
  g.n_ct = fd_ceil_div(Cout, nc);
  return true;
}

// Raise a kernel's dynamic shared-memory cap to 227 KB the first time a
// launch needs more than the default 48 KB (one flag per instantiation).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem, int& allowed) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    allowed = kMaxSmem;
  }
  return cudaSuccess;
}

// The alignment tests of the 16-byte paths: x and the taps (halo loads),
// the pointwise weight (its rows), the output and the skip (epilogue).
template <typename T>
inline void vector_paths(const Geom& g, const void* x, const void* dw_w, const void* dw_b,
                         const void* pw_w, const void* skip, const void* out, bool& vec_x,
                         bool& vec_w, bool& vec_o) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  vec_x = g.C % V == 0 && fd_aligned16(x) && fd_aligned16(dw_w) && fd_aligned16(dw_b);
  vec_w = g.Cout % V == 0 && fd_aligned16(pw_w);
  vec_o = g.Cout % V == 0 && fd_aligned16(out) && (skip == nullptr || fd_aligned16(skip));
}

}  // namespace fdk
