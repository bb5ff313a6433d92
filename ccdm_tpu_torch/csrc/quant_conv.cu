// Int8 convolution for quantized inference: quantize the activations on
// load, an implicit GEMM on the int8 tensor cores with int32 sums, and the
// dequantisation with an fp32 bias in the epilogue.
//
// Replaces: ccdm_tpu/ops/quant.py, quantized_conv (called by QuantConv). On
// the TPU that is XLA code, not a Pallas kernel; the port writes it by hand
// so the activations are quantized inside the conv instead of in a pass of
// their own. Semantics, bit for bit those of the plain version
// (ops/quant.py::quant_conv_plain):
//   x_q = clip(rint(x / s_x), -127, 127)   the IEEE fp32 quotient's rounding
//                                          (see quantize), half to even, -127
//   acc = sum over (tap, ci) of x_q * w_q   int32, exact in any order
//   out = float(acc) * (s_x * s_w[n]) + bias[n], every operation rounded on
//         its own (__fmul_rn / __fadd_rn: no contraction into an FMA), then
//         one cast to x's dtype.
// s_x is read through a device pointer, so neither the dynamic scale (a
// device reduction) nor a calibrated one costs the host a synchronisation.
//
// Layout: x NCHW contiguous, bf16 or fp32; w_q int8 [Cout, taps * cin_pad],
// tap-major (tap = r * k + s) with each tap's Cin channels zero-padded to
// cin_pad, a multiple of 32; s_w, bias fp32 [Cout]; out NCHW in x's dtype.
// 3x3 with stride 1 or 2 and padding 1, or 1x1 with padding 0; any B, Cin,
// H, W, Cout (ragged edges masked, padded channels multiply zeros).
//
// Bound: at the narrow LIDC sites bytes (x once, w_q once, out once over
// 3.35 TB/s), e.g. [128,32,128,128] 3x3 32->32 bf16: 80 us by bytes against
// 19.5 us of int8 operations; at the Cityscapes level 0 [2,128,256,512] the
// two are close (40.1 / 39.1 us); the deep Cityscapes sites ([2,512,8,16]
// 512->512) are a small GEMM whose weights are most of the bytes.
//
// Two paths; the wrapper (ops/quant.py::_plan_conv) picks one from the shape
// and this file checks what it is given.
//
// RING (quant_conv_ring; output rows of at least 32 pixels, 64 for a 3x3 of
// stride 1, which also needs 64 output channels a block or all of them: on
// shorter rows the tile was faster). A block owns a strip of `rs` output
// rows, a column tile of `tw` (32, 64 or 128) output pixels and `bn` (32, 64
// or 128) output channels, with all of Cin. It walks down the strip. Shared
// memory holds the block's weights for every tap (loaded once), and a ring of
// k rows of quantized input codes, channel-innermost, each pixel's cin_pad
// codes padded to a pitch of cin_pad + 16 bytes (an odd number of 16-byte
// units, so ldmatrix's eight row addresses fall in distinct banks). Each new
// output row costs s new input rows: each element of x that the block needs
// is read from device memory once and quantized once (a strip's first rows
// and a column tile's two edge columns excepted). While the tensor cores
// multiply row y, the raw bf16 / fp32 values of row y + 1's new input rows
// are already in flight as 16-byte loads along W into registers (NI items a
// thread, an item 4 channels x one vector of pixels, so its codes are four
// bytes of a pixel); after a barrier they are quantized into the ring slots
// that row y no longer needs. Where W or the address does not allow 16-byte
// loads, element loads after the barrier take their place. Stride 2 stores a
// ring row's even columns first and its odd columns after them, so the
// pixels of one tap column are contiguous there too. Products: mma.sync
// m16n8k32 s8 x s8 -> s32, a warp per 32 pixels x 32 channels, A and B
// fragments by ldmatrix.x4 from the ring and the weights. The epilogue
// stages fp32 results [bn][tw] in shared memory and writes each output row
// along W, 16 bytes a thread where aligned.
//
// TILE (quant_conv_tile; the other sites, and whatever the ring cannot
// hold): the first version of this kernel. A block takes 64 output pixels
// of one image (TH x TW, TW = 64, 32, 16 or 8 from Wo) and 64 output
// channels, loops over chunks of 32 input channels, and per chunk
// quantizes the tile's halo into shared memory and multiplies each tap.
// Where such tiles give too few
// blocks for 132 SMs (the deep Cityscapes sites: [2,512,8,16] gives 32), K
// splits over `split` ranges of chunks (blockIdx.z); each range adds its
// int32 sums into a zeroed int32 scratch with atomics (exact in any order)
// and a second launch, quant_conv_epilogue, dequantizes once the sums are
// complete.
//
// Not used: wgmma, TMA and a fused upsample (ROADMAP, queue 2 item 10).
// A ring variant whose products were wgmma m64n64k32 (the quantizing
// threads wrote the codes and weights in its core-matrix layout, read
// through descriptors without swizzle) was exact but no faster than
// mma.sync at any Cityscapes site: ptxas serialized its wgmmas (it injected
// warpgroup.arrive between them). Nor are the products the larger part:
// tools/phase_quant_conv.py times the ring with each phase skipped, and at
// the Cityscapes sites of 256 input channels the next rows' loads and
// quantization cost more than the products, with one block of 4-5 warps
// an SM (all taps' weights for 64 channels take 157 KB of shared memory)
// and little overlap between the two. The raw loads are register-staged
// ld.global, not TMA: the values pass through the threads anyway to be
// divided by s_x and transposed to channel-innermost. The decoder's 2x
// nearest Upsample stays a pass of its own.
#include "common.cuh"

using namespace ccdm;

namespace {

// ---- shared helpers ------------------------------------------------------

// rint(v / sx) exactly as the IEEE division rounds it, from v * rx with rx =
// 1 / sx (IEEE, once a block): the product is within 2^-22 relative of the
// rounded quotient, 3.1e-5 at |v / sx| <= 128, so the two round to the same
// integer unless the product lies within 1e-3 of a half-integer, where the
// division decides (about 0.2% of values). Past 128 both clip to +-127.
__device__ __forceinline__ uint32_t quantize(float v, float sx, float rx) {
  const float p = v * rx;
  float q = rintf(p);
  if (fabsf(fabsf(p - q) - 0.5f) < 1e-3f) q = rintf(__fdiv_rn(v, sx));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(q))));
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(a));
}

// out = float(acc) * (sx * s_w) + bias, each operation rounded on its own
__device__ __forceinline__ float dequant(int acc, float sx, float sw, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(sx, sw)), bias);
}

// ---- the ring path ---------------------------------------------------------

constexpr int kRingMaxThreads = 512;
constexpr int kRingMinThreads = 128;  // at least 4 warps load and quantize
constexpr int kRingMaxItems = 4;      // NI: prefetched items a thread
constexpr int kRingSmemMax = 232448;  // bytes of shared memory a block may have

struct RingArgs {
  const void* x;
  const int8_t* wq;
  const float* s_w;
  const float* bias;
  const float* s_x;
  void* out;
  int batch, cin, h, w, cout, ho, wo, ks, stride, pad, cin_pad;
  int tw, bn, rs;            // output pixels, channels and rows a block
  int twin, half;            // ring row pixels; stride 2: even columns first, `half` of them
  int pitch;                 // bytes a pixel's codes (and a weight row) take: cin_pad + 16
  int tiles_w, strips, ntiles;
  int nq;                    // channel quads with a real channel: ceil(cin / 4)
  int vec;                   // 1: 16-byte loads along W
  int nv;                    // vectors a ring row's channel spans (vec)
  int warps_m, warps;        // warp tiles along the pixels; warps that multiply
  int ring_bytes, w_bytes, stage_pitch;
};

// where input column offset `px` (0 .. twin-1) of a ring row lives
__device__ __forceinline__ int ring_index(int px, int stride, int half) {
  return stride == 1 ? px : ((px & 1) ? half + (px >> 1) : (px >> 1));
}

template <typename T>
struct RingIo {
  static constexpr int V = 16 / sizeof(T);  // elements a 16-byte vector
};

// pack the codes of 4 channels of one pixel into a word
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d, float sx,
                                          float rx) {
  return quantize(a, sx, rx) | (quantize(b, sx, rx) << 8) | (quantize(c, sx, rx) << 16) |
         (quantize(d, sx, rx) << 24);
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e) {
  return to_float(reinterpret_cast<const T*>(&v)[e]);
}

template <typename T, int NI>
__global__ void __launch_bounds__(kRingMaxThreads)
quant_conv_ring(const RingArgs a) {
  constexpr int V = RingIo<T>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                         // [ks][twin][pitch]
  unsigned char* wsm = smem + a.ring_bytes;           // [taps][bn][pitch]
  float* stage = reinterpret_cast<float*>(smem + a.ring_bytes + a.w_bytes);  // [bn][tw + 4]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x;
  int blk = blockIdx.x;
  const int nt = blk % a.ntiles;
  blk /= a.ntiles;
  const int tcol = blk % a.tiles_w;
  blk /= a.tiles_w;
  const int strip = blk % a.strips;
  const int b = blk / a.strips;
  const int n0 = nt * a.bn, ox0 = tcol * a.tw;
  const int oy_begin = strip * a.rs;
  const int oy_end = min(a.ho, oy_begin + a.rs);
  const int ix0 = ox0 * a.stride - a.pad;
  // the first vector's column: floor(ix0 / V) * V
  const int vcol0 = (ix0 >= 0 ? ix0 / V : -((-ix0 + V - 1) / V)) * V;
  const int taps = a.ks * a.ks;
  const size_t plane = static_cast<size_t>(a.h) * a.w;
  const T* x = static_cast<const T*>(a.x) + static_cast<size_t>(b) * a.cin * plane;
  const float sx = *a.s_x, rx = __frcp_rn(sx);

  // zero the ring (the quads past Cin stay zero), load the weights once
  for (int i = tid * 16; i < a.ring_bytes; i += threads * 16)
    *reinterpret_cast<uint4*>(ring + i) = make_uint4(0, 0, 0, 0);
  {
    const int units = a.cin_pad / 16;
    const size_t k_pad = static_cast<size_t>(taps) * a.cin_pad;
    for (int u = tid; u < taps * a.bn * units; u += threads) {
      const int row = u / units, c16 = u - row * units;
      const int tap = row / a.bn, n = row - tap * a.bn;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n0 + n < a.cout)
        v = *reinterpret_cast<const uint4*>(a.wq + (n0 + n) * k_pad + tap * a.cin_pad +
                                            c16 * 16);
      *reinterpret_cast<uint4*>(wsm + row * a.pitch + c16 * 16) = v;
    }
  }
  __syncthreads();

  // the codes of input rows iy_first .. iy_first + nrows - 1 into their ring
  // slots, loaded and quantized by the threads in turn; rows and columns
  // outside the image are zeros (the padding)
  auto fill_rows = [&](int iy_first, int nrows) {
    if (a.vec) {
      const int per_row = a.nq * a.nv;
      for (int it = tid; it < nrows * per_row; it += threads) {
        const int r = it / per_row, rem = it - r * per_row;
        const int v = rem / a.nq, cq = rem - v * a.nq;
        const int iy = iy_first + r, col = vcol0 + v * V;
        uint4 raw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = cq * 4 + i;
          raw[i] = make_uint4(0, 0, 0, 0);
          if (c < a.cin && iy >= 0 && iy < a.h && col >= 0 && col < a.w)
            raw[i] = __ldg(reinterpret_cast<const uint4*>(x + c * plane +
                                                          static_cast<size_t>(iy) * a.w + col));
        }
        unsigned char* dst = ring + ((iy + a.pad) % a.ks) * a.twin * a.pitch + cq * 4;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int px = col + e - ix0;
          if (px >= 0 && px < a.twin)
            *reinterpret_cast<uint32_t*>(dst + ring_index(px, a.stride, a.half) * a.pitch) =
                pack4(elem<T>(raw[0], e), elem<T>(raw[1], e), elem<T>(raw[2], e),
                      elem<T>(raw[3], e), sx, rx);
        }
      }
    } else {
      const int per_row = a.nq * a.twin;
      for (int it = tid; it < nrows * per_row; it += threads) {
        const int r = it / per_row, rem = it - r * per_row;
        const int px = rem / a.nq, cq = rem - px * a.nq;
        const int iy = iy_first + r, ix = ix0 + px;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = cq * 4 + i;
          v[i] = (c < a.cin && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w)
                     ? to_float(x[c * plane + static_cast<size_t>(iy) * a.w + ix])
                     : 0.f;
        }
        *reinterpret_cast<uint32_t*>(ring + ((iy + a.pad) % a.ks) * a.twin * a.pitch +
                                     ring_index(px, a.stride, a.half) * a.pitch + cq * 4) =
            pack4(v[0], v[1], v[2], v[3], sx, rx);
      }
    }
  };

  // the window of the strip's first output row
  fill_rows(oy_begin * a.stride - a.pad, a.ks);
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const bool computes = warp < a.warps;  // warp-uniform
  const int wm = warp % a.warps_m, wn = warp / a.warps_m;
  const int kchunks = a.cin_pad / 32;
  const int per_row = a.nq * a.nv;
  T* out = static_cast<T*>(a.out);
  const size_t out_plane = static_cast<size_t>(a.ho) * a.wo;
  const int sp = a.stage_pitch;
  // ldmatrix row addresses: A's matrices are pixels 0-7 / 8-15 (bit 0 of the
  // matrix index) by bytes 0-15 / 16-31 of the chunk (bit 1); B's are output
  // channels nj * 8 .. + 7 (bit 1) by bytes 0-15 / 16-31 (bit 0)
  const int mat = lane >> 3, r8 = lane & 7;
  const int a_pix = wm * 32 + (mat & 1) * 8 + r8, a_byte = (mat >> 1) * 16;
  const int b_row = wn * 32 + (mat >> 1) * 8 + r8, b_byte = (mat & 1) * 16;

  for (int oy = oy_begin; oy < oy_end; ++oy) {
    const bool next = oy + 1 < oy_end;
    const int iy_new = (oy + 1) * a.stride - a.pad + a.ks - a.stride;  // next row's new rows
    // 1. the next output row's new input rows, in flight during the products
    uint4 raw[NI][4];
    if (a.vec && next) {
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int it = tid + j * threads;
        const int r = it / per_row, rem = it - r * per_row;
        const int v = rem / a.nq, cq = rem - v * a.nq;
        const int iy = iy_new + r, col = vcol0 + v * V;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = cq * 4 + i;
          raw[j][i] = make_uint4(0, 0, 0, 0);
          if (r < a.stride && c < a.cin && iy >= 0 && iy < a.h && col >= 0 && col < a.w)
            raw[j][i] = __ldg(reinterpret_cast<const uint4*>(
                x + c * plane + static_cast<size_t>(iy) * a.w + col));
        }
      }
    }
    // 2. the products of output row oy
    int acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;
    if (computes) {
      for (int r = 0; r < a.ks; ++r) {
        const unsigned char* slot = ring + ((oy * a.stride + r) % a.ks) * a.twin * a.pitch;
        for (int sc = 0; sc < a.ks; ++sc) {
          const int tap = r * a.ks + sc;
          // the ring index of output pixel p at tap column sc
          const int shift = a.stride == 1 ? sc : (sc == 1 ? a.half : (sc >> 1));
          const unsigned char* arow = slot + (a_pix + shift) * a.pitch;
          const unsigned char* brow = wsm + (tap * a.bn + b_row) * a.pitch + b_byte;
          for (int kc = 0; kc < kchunks; ++kc) {
            uint32_t af[2][4], bq[2][4];
            ldmatrix_x4(af[0], arow + kc * 32 + a_byte);
            ldmatrix_x4(af[1], arow + 16 * a.pitch + kc * 32 + a_byte);
            ldmatrix_x4(bq[0], brow + kc * 32);
            ldmatrix_x4(bq[1], brow + 16 * a.pitch + kc * 32);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int nj = 0; nj < 4; ++nj) {
                const uint32_t bf[2] = {bq[nj >> 1][(nj & 1) * 2], bq[nj >> 1][(nj & 1) * 2 + 1]};
                mma_s8(acc[mi][nj], af[mi], bf);
              }
          }
        }
      }
      // 3. dequantize into the stage [n][pixel]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = wm * 32 + mi * 16 + g + (e >> 1) * 8;
            const int n = wn * 32 + nj * 8 + t * 2 + (e & 1);
            if (n0 + n < a.cout)
              stage[n * sp + p] = dequant(acc[mi][nj][e], sx, a.s_w[n0 + n], a.bias[n0 + n]);
          }
    }
    __syncthreads();  // the ring slots of row oy are read, the stage is written
    // 4. the next row's codes into the slots row oy no longer needs
    if (next) {
      if (a.vec) {
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int it = tid + j * threads;
          const int r = it / per_row, rem = it - r * per_row;
          if (r >= a.stride) continue;
          const int v = rem / a.nq, cq = rem - v * a.nq;
          const int iy = iy_new + r, col = vcol0 + v * V;
          unsigned char* dst = ring + ((iy + a.pad) % a.ks) * a.twin * a.pitch + cq * 4;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int px = col + e - ix0;
            if (px >= 0 && px < a.twin)
              *reinterpret_cast<uint32_t*>(dst + ring_index(px, a.stride, a.half) * a.pitch) =
                  pack4(elem<T>(raw[j][0], e), elem<T>(raw[j][1], e), elem<T>(raw[j][2], e),
                        elem<T>(raw[j][3], e), sx, rx);
          }
        }
      } else {
        fill_rows(iy_new, a.stride);
      }
    }
    // 5. output row oy, along W
    {
      const int wv = a.tw / V;
      T* orow = out + (static_cast<size_t>(b) * a.cout + n0) * out_plane +
                static_cast<size_t>(oy) * a.wo + ox0;
      const bool aligned = a.vec && (a.wo % V == 0);
      for (int i = tid; i < a.bn * wv; i += threads) {
        const int n = i / wv, p0 = (i - n * wv) * V;
        if (n0 + n >= a.cout || ox0 + p0 >= a.wo) continue;
        T* dst = orow + static_cast<size_t>(n) * out_plane + p0;
        const float* src = stage + n * sp + p0;
        if (aligned && ox0 + p0 + V <= a.wo) {
          Pack<T, V> pk;
#pragma unroll
          for (int e = 0; e < V; ++e) pk.v[e] = from_float<T>(src[e]);
          *reinterpret_cast<Pack<T, V>*>(dst) = pk;
        } else {
          for (int e = 0; e < V && ox0 + p0 + e < a.wo; ++e) dst[e] = from_float<T>(src[e]);
        }
      }
    }
    __syncthreads();  // the next row's slots are written, the stage is free
  }
}

// ---- the tile path (the first version, with a split of K) -----------------

constexpr int kThreads = 128;  // 4 warps: 2 (pixels) x 2 (channels) of 32 x 32
constexpr int kBM = 64;        // output pixels a block
constexpr int kBN = 64;        // output channels a block
constexpr int kChunk = 32;     // input channels a K step: one m16n8k32's depth
constexpr int kRow = 48;       // shared bytes a pixel's (or a weight row's) 32 codes take
constexpr int kStage = kBM + 4;  // fp32 stage row: conflict-free epilogue writes
constexpr int kHalf = kChunk / 2;  // channels a halo load item: half a pixel's chunk
constexpr int kSlots = 7;      // halo items a thread: a halo has at most 387 x 2 items

struct ConvArgs {
  const void* x;
  const int8_t* wq;
  const float* s_w;
  const float* bias;
  const float* s_x;
  void* out;
  int* acc32;  // split > 1: the int32 sums, [batch, cout, ho, wo], zeroed
  int cin, h, w, cout, ho, wo, ks, stride, pad, cin_pad;
  int tw, tw_shift, th, tiles_w, tiles_per_image, hh, ww, halo_bytes, rows;
  int chunks_per_split;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) quant_conv_tile(const ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* halo = smem;                  // [hh * ww][kRow] int8 codes
  unsigned char* wsm = smem + a.halo_bytes;    // [taps * rows][kRow] int8 codes
  float* stage = reinterpret_cast<float*>(smem);  // [kBN][kStage], after the K loop

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const int b = blockIdx.x / a.tiles_per_image;
  const int tile = blockIdx.x - b * a.tiles_per_image;
  const int tile_y = tile / a.tiles_w, tile_x = tile - tile_y * a.tiles_w;
  const int n0 = blockIdx.y * kBN;
  const int taps = a.ks * a.ks;
  const int oy0 = tile_y * a.th, ox0 = tile_x * a.tw;
  const int iy0 = oy0 * a.stride - a.pad, ix0 = ox0 * a.stride - a.pad;
  const int hpix = a.hh * a.ww;
  const size_t plane = static_cast<size_t>(a.h) * a.w;
  const T* x = static_cast<const T*>(a.x) + static_cast<size_t>(b) * a.cin * plane;
  const float sx = *a.s_x, rx = __frcp_rn(sx);
  const size_t k_pad = static_cast<size_t>(taps) * a.cin_pad;
  // the block's weight rows: 32 where at most 32 output channels are left
  const int rows = a.cout - n0 > 32 ? a.rows : 32;
  // this block's range of K chunks
  const int c_begin = blockIdx.z * a.chunks_per_split * kChunk;
  const int c_end = min(a.cin_pad, c_begin + a.chunks_per_split * kChunk);

  // this thread's halo items (a pixel's first or second 16 channels), the
  // same for every chunk: the pixel's offset in an input plane, or -1
  // outside the image (zero padding)
  int src_off[kSlots];
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) {
    const int pix = (tid + sl * kThreads) >> 1;
    const int hy = pix / a.ww, hx = pix - hy * a.ww;
    const int iy = iy0 + hy, ix = ix0 + hx;
    src_off[sl] = (pix < hpix && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w) ? iy * a.w + ix
                                                                           : -1;
  }
  // byte offsets in the halo of this thread's fragment rows (pixel g and
  // g + 8 of each 16-pixel half of the warp's 32), at tap (0, 0)
  int aoff[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = warp_m * 32 + mi * 16 + hf * 8 + g;
      const int ty = p >> a.tw_shift, tx = p & (a.tw - 1);
      aoff[mi][hf] = (ty * a.stride * a.ww + tx * a.stride) * kRow + t * 4;
    }
  const bool active = n0 + warp_n * 32 < a.cout;  // warp-uniform

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

  for (int c0 = c_begin; c0 < c_end; c0 += kChunk) {
    // the halo, quantized: each thread its items' 16 channels, all loads
    // issued before the first is used; the threads of a warp take
    // neighbouring pixels, so each channel's loads coalesce. An item's codes
    // go to shared memory as one 16-byte vector.
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      const int item = tid + sl * kThreads;
      if (item >= 2 * hpix) break;
      const int c = c0 + (item & 1) * kHalf;
      const int nch = a.cin - c < kHalf ? a.cin - c : kHalf;  // <= 0 past Cin
      uint32_t word[4] = {0, 0, 0, 0};
      if (src_off[sl] >= 0) {
        const T* src = x + c * plane + src_off[sl];
        float v[kHalf];
#pragma unroll
        for (int j = 0; j < kHalf; ++j) v[j] = j < nch ? to_float(src[j * plane]) : 0.f;
#pragma unroll
        for (int j = 0; j < kHalf; ++j)
          if (j < nch) word[j >> 2] |= quantize(v[j], sx, rx) << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(halo + (item >> 1) * kRow + (item & 1) * 16) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
    // the chunk's weights of every tap: two 16-byte vectors a (tap, channel)
    for (int i = tid; i < taps * rows * 2; i += kThreads) {
      const int hf = i & 1, row = i >> 1;
      const int tap = row / rows, n = row - tap * rows;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n0 + n < a.cout)
        v = *reinterpret_cast<const uint4*>(a.wq + (n0 + n) * k_pad + tap * a.cin_pad + c0 +
                                            hf * 16);
      *reinterpret_cast<uint4*>(wsm + row * kRow + hf * 16) = v;
    }
    __syncthreads();
    if (active) {
      for (int tap = 0; tap < taps; ++tap) {
        const int r = tap / a.ks, s = tap - r * a.ks;
        const int toff = (r * a.ww + s) * kRow;
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const unsigned char* p0 = halo + aoff[mi][0] + toff;
          const unsigned char* p1 = halo + aoff[mi][1] + toff;
          af[mi][0] = ld32(p0);
          af[mi][1] = ld32(p1);
          af[mi][2] = ld32(p0 + 16);
          af[mi][3] = ld32(p1 + 16);
        }
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const unsigned char* q =
              wsm + (tap * rows + warp_n * 32 + nj * 8 + g) * kRow + t * 4;
          bf[nj][0] = ld32(q);
          bf[nj][1] = ld32(q + 16);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) mma_s8(acc[mi][nj], af[mi], bf[nj]);
      }
    }
    __syncthreads();
  }

  const size_t out_plane = static_cast<size_t>(a.ho) * a.wo;
  if (a.acc32) {
    // a range of K: add the int32 sums; quant_conv_epilogue finishes
    if (active) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = warp_m * 32 + mi * 16 + g + (e >> 1) * 8;
            const int n = warp_n * 32 + nj * 8 + t * 2 + (e & 1);
            const int oy = oy0 + (p >> a.tw_shift), ox = ox0 + (p & (a.tw - 1));
            if (n0 + n < a.cout && oy < a.ho && ox < a.wo)
              atomicAdd(a.acc32 + (static_cast<size_t>(b) * a.cout + n0 + n) * out_plane +
                            static_cast<size_t>(oy) * a.wo + ox,
                        acc[mi][nj][e]);
          }
    }
    return;
  }
  // epilogue: dequantize and add the bias in fp32 into the stage [n][pixel]
  if (active) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = warp_m * 32 + mi * 16 + g + (e >> 1) * 8;
          const int n = warp_n * 32 + nj * 8 + t * 2 + (e & 1);
          if (n0 + n < a.cout)
            stage[n * kStage + p] = dequant(acc[mi][nj][e], sx, a.s_w[n0 + n], a.bias[n0 + n]);
        }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < kBN * kBM; i += kThreads) {
    const int n = i / kBM, p = i - n * kBM;
    const int ty = p >> a.tw_shift, tx = p & (a.tw - 1);
    const int oy = oy0 + ty, ox = ox0 + tx;
    if (n0 + n < a.cout && oy < a.ho && ox < a.wo)
      out[(static_cast<size_t>(b) * a.cout + n0 + n) * out_plane +
          static_cast<size_t>(oy) * a.wo + ox] = from_float<T>(stage[n * kStage + p]);
  }
}

// out = dequant(acc32) over [batch, cout, ho * wo]
template <typename T>
__global__ void quant_conv_epilogue(const int* __restrict__ acc32, const float* __restrict__ s_w,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ s_x, T* __restrict__ out,
                                    long long total, int cout, long long plane) {
  const float sx = *s_x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>((i / plane) % cout);
    out[i] = from_float<T>(dequant(acc32[i], sx, s_w[n], bias[n]));
  }
}

template <typename T, int NI>
int launch_ring(const RingArgs& a, int smem, int threads, unsigned int blocks, cudaStream_t s) {
  static bool configured = false;  // the attribute, once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        quant_conv_ring<T, NI>, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingSmemMax);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  quant_conv_ring<T, NI><<<blocks, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch_ring(const RingArgs& a, int ni, int smem, int threads, unsigned int blocks,
                  cudaStream_t s) {
  switch (ni) {
    case 1: return launch_ring<T, 1>(a, smem, threads, blocks, s);
    case 2: return launch_ring<T, 2>(a, smem, threads, blocks, s);
    case 3: return launch_ring<T, 3>(a, smem, threads, blocks, s);
    case 4: return launch_ring<T, 4>(a, smem, threads, blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x NCHW [batch, cin, h, w] (dtype 0 fp32, 1 bf16), w_q int8 [cout, k*k*cin_pad],
// s_w and bias fp32 [cout], s_x an fp32 device scalar, out NCHW in x's dtype.
// path 0 (tile): p0 = split (K ranges), p1..p4 unused; acc32 an int32 scratch
// [batch, cout, ho, wo] zeroed by the caller where split > 1. path 1 (ring):
// p0 = tw, p1 = bn, p2 = rs, p3 = NI (prefetched items a thread), p4 = threads.
extern "C" int ccdm_quant_conv(const void* x, const void* wq, const void* s_w,
                               const void* bias, const void* s_x, void* out, void* acc32,
                               int dtype, int batch, int cin, int h, int w, int cout, int ks,
                               int stride, int pad, int cin_pad, int path, int p0, int p1,
                               int p2, int p3, int p4, void* stream) {
  if (batch <= 0 || cin <= 0 || h <= 0 || w <= 0 || cout <= 0) return cudaErrorInvalidValue;
  if (!((ks == 3 && pad == 1) || (ks == 1 && pad == 0)) || (stride != 1 && stride != 2))
    return cudaErrorInvalidValue;
  if (cin_pad % kChunk != 0 || cin_pad < cin || cin_pad - cin >= kChunk)
    return cudaErrorInvalidValue;
  if (dtype != kFloat32 && dtype != kBFloat16) return cudaErrorInvalidValue;
  const int ho = (h + 2 * pad - ks) / stride + 1;
  const int wo = (w + 2 * pad - ks) / stride + 1;
  if (ho <= 0 || wo <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int itemsize = dtype == kFloat32 ? 4 : 2;

  if (path == 1) {
    RingArgs a{};
    a.x = x;
    a.wq = static_cast<const int8_t*>(wq);
    a.s_w = static_cast<const float*>(s_w);
    a.bias = static_cast<const float*>(bias);
    a.s_x = static_cast<const float*>(s_x);
    a.out = out;
    a.batch = batch, a.cin = cin, a.h = h, a.w = w, a.cout = cout, a.ho = ho, a.wo = wo;
    a.ks = ks, a.stride = stride, a.pad = pad, a.cin_pad = cin_pad;
    a.tw = p0, a.bn = p1, a.rs = p2;
    const int ni = p3;
    if ((a.tw != 32 && a.tw != 64 && a.tw != 128) || (a.bn != 32 && a.bn != 64 && a.bn != 128))
      return cudaErrorInvalidValue;
    if (a.rs <= 0 || ni < 1 || ni > kRingMaxItems || (ks == 1 && stride != 1))
      return cudaErrorInvalidValue;
    const int V = 16 / itemsize;
    a.twin = (a.tw - 1) * stride + ks;
    a.half = (a.twin + 1) / 2;
    a.pitch = cin_pad + 16;
    a.tiles_w = (wo + a.tw - 1) / a.tw;
    a.strips = (ho + a.rs - 1) / a.rs;
    a.ntiles = (cout + a.bn - 1) / a.bn;
    a.nq = (cin + 3) / 4;
    a.vec = (w % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(out) % 16 == 0) ? 1 : 0;
    const int lead = pad ? V - 1 : 0;  // columns before ix0 in its vector (ix0 = 32m*s - pad)
    a.nv = (a.twin + lead + V - 1) / V;
    a.warps_m = a.tw / 32;
    a.warps = a.warps_m * (a.bn / 32);
    const int threads = p4;  // a warp per 32 x 32 tile, more where the loads need them
    if (threads % 32 || threads < a.warps * 32 || threads < kRingMinThreads ||
        threads > kRingMaxThreads)
      return cudaErrorInvalidConfiguration;
    if (a.vec && stride * a.nq * a.nv > ni * threads) return cudaErrorInvalidConfiguration;
    a.ring_bytes = ks * a.twin * a.pitch;
    a.w_bytes = ks * ks * a.bn * a.pitch;
    a.stage_pitch = a.tw + 4;
    const long long smem = static_cast<long long>(a.ring_bytes) + a.w_bytes +
                           static_cast<long long>(a.bn) * a.stage_pitch * 4;
    if (smem > kRingSmemMax) return cudaErrorInvalidConfiguration;
    const long long blocks = static_cast<long long>(batch) * a.strips * a.tiles_w * a.ntiles;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    if (dtype == kFloat32)
      return dispatch_ring<float>(a, ni, static_cast<int>(smem), threads,
                                  static_cast<unsigned int>(blocks), s);
    return dispatch_ring<__nv_bfloat16>(a, ni, static_cast<int>(smem), threads,
                                        static_cast<unsigned int>(blocks), s);
  }
  if (path != 0) return cudaErrorInvalidValue;

  ConvArgs a{x, static_cast<const int8_t*>(wq), static_cast<const float*>(s_w),
             static_cast<const float*>(bias), static_cast<const float*>(s_x), out, nullptr,
             cin, h, w, cout, ho, wo, ks, stride, pad, cin_pad};
  const int chunks = cin_pad / kChunk;
  const int split = p0;
  if (split < 1 || split > chunks) return cudaErrorInvalidValue;
  a.chunks_per_split = (chunks + split - 1) / split;
  if ((chunks + a.chunks_per_split - 1) / a.chunks_per_split != split)
    return cudaErrorInvalidValue;  // every range non-empty
  if (split > 1) {
    if (acc32 == nullptr) return cudaErrorInvalidValue;
    a.acc32 = static_cast<int*>(acc32);
  }
  a.tw_shift = a.wo > 32 ? 6 : a.wo > 16 ? 5 : a.wo > 8 ? 4 : 3;
  a.tw = 1 << a.tw_shift;
  a.th = kBM / a.tw;
  a.tiles_w = (a.wo + a.tw - 1) / a.tw;
  a.tiles_per_image = a.tiles_w * ((a.ho + a.th - 1) / a.th);
  a.hh = (a.th - 1) * stride + ks;
  a.ww = (a.tw - 1) * stride + ks;
  if (2 * a.hh * a.ww > kSlots * kThreads) return cudaErrorInvalidConfiguration;  // <= 774
  a.halo_bytes = a.hh * a.ww * kRow;  // a multiple of 16
  a.rows = cout > 32 ? kBN : 32;
  const int loop_bytes = a.halo_bytes + ks * ks * a.rows * kRow;
  const int stage_bytes = kBN * kStage * static_cast<int>(sizeof(float));
  const int smem = loop_bytes > stage_bytes ? loop_bytes : stage_bytes;
  if (smem > 48 * 1024) return cudaErrorInvalidConfiguration;  // at most 46,224 bytes
  const long long blocks = static_cast<long long>(batch) * a.tiles_per_image;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned int>(blocks), (cout + kBN - 1) / kBN, split);
  if (dtype == kFloat32)
    quant_conv_tile<float><<<grid, kThreads, smem, s>>>(a);
  else
    quant_conv_tile<__nv_bfloat16><<<grid, kThreads, smem, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  const long long total = static_cast<long long>(batch) * cout * ho * wo;
  const long long eblocks = (total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096;
  if (dtype == kFloat32)
    quant_conv_epilogue<float><<<static_cast<unsigned int>(eblocks), 256, 0, s>>>(
        a.acc32, a.s_w, a.bias, a.s_x, static_cast<float*>(out), total, cout,
        static_cast<long long>(ho) * wo);
  else
    quant_conv_epilogue<__nv_bfloat16><<<static_cast<unsigned int>(eblocks), 256, 0, s>>>(
        a.acc32, a.s_w, a.bias, a.s_x, static_cast<__nv_bfloat16*>(out), total, cout,
        static_cast<long long>(ho) * wo);
  return cudaGetLastError();
}
