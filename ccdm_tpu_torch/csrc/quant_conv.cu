// Int8 convolution for quantized inference: quantize the activations on
// load, an implicit GEMM on the int8 tensor cores with int32 sums, and the
// dequantisation with an fp32 bias in the epilogue.
//
// Replaces: ccdm_tpu/ops/quant.py, quantized_conv (called by QuantConv). On
// the TPU that is XLA code, not a Pallas kernel; the port writes it by hand
// so the activations are quantized inside the conv instead of in a pass of
// their own. Semantics, bit for bit those of the plain version
// (ops/quant.py::quant_conv_plain):
//   x_q = clip(rint(x / s_x), -127, 127)   IEEE fp32 division (__fdiv_rn, no
//                                          reciprocal), half to even, -127
//   acc = sum over (tap, ci) of x_q * w_q   int32, exact
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
// GEMM: M = B * Ho * Wo output pixels, N = Cout, K = taps * Cin. A block
// takes a tile of 64 output pixels of one image (TH x TW, TW = 64, 32, 16 or
// 8 from Wo) and 64 output channels, with four warps of 32 pixels x 32
// channels each, on mma.sync m16n8k32 s8 x s8 -> s32. The K loop runs over
// chunks of 32 input channels. For each chunk the block loads the input halo
// its tile needs ((TH-1)*stride + k rows by (TW-1)*stride + k columns) and
// quantizes each element once into shared memory as int8: each thread owns
// up to 7 items of 16 channels of a halo pixel, found once, and issues an
// item's 16 loads before it quantizes any. The codes are channel-innermost:
// a pixel's 32 codes are one 48-byte row, padded so the fragment loads of 8
// neighbouring pixels hit distinct banks. The block then loads the chunk's
// weights of every tap (32 rows where at most 32 output channels are left),
// and each tap is one k32 step whose A fragments are 32-bit loads of 4
// channels at the tap's shifted pixel. No int8 copy of x goes to device
// memory. The epilogue stages the fp32 results through shared memory so the
// NCHW stores are coalesced along the pixels.
//
// Bound: at the narrow LIDC sites bytes (x once, w_q once, out once over
// 3.35 TB/s) bound it, e.g. [128,32,128,128] 3x3 32->32 bf16: 80 us by bytes
// against 19.5 us of int8 operations; at the Cityscapes level 0
// [2,128,256,512] the two are close (40.1 / 39.1 us). This first kernel reads
// a halo row up to three times (from L2), quantizes it as often (one IEEE
// division an element), and keeps the copies and the products in one stream
// of instructions per warp (no cp.async, no wgmma, no TMA, no persistent
// grid, no split of K where a deep layer gives few blocks): a later
// redesign's work.
#include "common.cuh"

using namespace ccdm;

namespace {

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
  int cin, h, w, cout, ho, wo, ks, stride, pad, cin_pad;
  int tw, tw_shift, th, tiles_w, tiles_per_image, hh, ww, halo_bytes, rows;
};

__device__ __forceinline__ uint32_t quantize(float v, float sx) {
  float q = rintf(__fdiv_rn(v, sx));
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

template <typename T>
__global__ void __launch_bounds__(kThreads) quant_conv_kernel(const ConvArgs a) {
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
  const float sx = *a.s_x;
  const size_t k_pad = static_cast<size_t>(taps) * a.cin_pad;
  // the block's weight rows: 32 where at most 32 output channels are left
  const int rows = a.cout - n0 > 32 ? a.rows : 32;

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

  for (int c0 = 0; c0 < a.cin_pad; c0 += kChunk) {
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
          if (j < nch) word[j >> 2] |= quantize(v[j], sx) << (8 * (j & 3));
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
          if (n0 + n < a.cout) {
            const float scale = __fmul_rn(sx, a.s_w[n0 + n]);
            stage[n * kStage + p] =
                __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][nj][e]), scale), a.bias[n0 + n]);
          }
        }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  const size_t out_plane = static_cast<size_t>(a.ho) * a.wo;
  for (int i = tid; i < kBN * kBM; i += kThreads) {
    const int n = i / kBM, p = i - n * kBM;
    const int ty = p >> a.tw_shift, tx = p & (a.tw - 1);
    const int oy = oy0 + ty, ox = ox0 + tx;
    if (n0 + n < a.cout && oy < a.ho && ox < a.wo)
      out[(static_cast<size_t>(b) * a.cout + n0 + n) * out_plane +
          static_cast<size_t>(oy) * a.wo + ox] = from_float<T>(stage[n * kStage + p]);
  }
}

}  // namespace

// x NCHW [batch, cin, h, w] (dtype 0 fp32, 1 bf16), w_q int8 [cout, k*k*cin_pad],
// s_w and bias fp32 [cout], s_x an fp32 device scalar, out NCHW in x's dtype.
extern "C" int ccdm_quant_conv(const void* x, const void* wq, const void* s_w,
                               const void* bias, const void* s_x, void* out, int dtype,
                               int batch, int cin, int h, int w, int cout, int ks, int stride,
                               int pad, int cin_pad, void* stream) {
  if (batch <= 0 || cin <= 0 || h <= 0 || w <= 0 || cout <= 0) return cudaErrorInvalidValue;
  if (!((ks == 3 && pad == 1) || (ks == 1 && pad == 0)) || (stride != 1 && stride != 2))
    return cudaErrorInvalidValue;
  if (cin_pad % kChunk != 0 || cin_pad < cin || cin_pad - cin >= kChunk)
    return cudaErrorInvalidValue;
  ConvArgs a{x, static_cast<const int8_t*>(wq), static_cast<const float*>(s_w),
             static_cast<const float*>(bias), static_cast<const float*>(s_x), out,
             cin, h, w, cout, 0, 0, ks, stride, pad, cin_pad};
  a.ho = (h + 2 * pad - ks) / stride + 1;
  a.wo = (w + 2 * pad - ks) / stride + 1;
  if (a.ho <= 0 || a.wo <= 0) return cudaErrorInvalidValue;
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
  const dim3 grid(static_cast<unsigned int>(blocks), (cout + kBN - 1) / kBN);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    quant_conv_kernel<float><<<grid, kThreads, smem, s>>>(a);
  else if (dtype == kBFloat16)
    quant_conv_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(a);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
