// Self-attention forward, softmax(q k^T / sqrt(dh)) v, without a T x T
// tensor in device memory.
//
// Replaces: ccdm_tpu/ops/flash_attention.py, _attn_kernel (launched by
// _flash_bh, wrapped by flash_attention / _flash_fwd_impl). Numerics follow
// it: logits are fp32 products of the inputs scaled once by 1/sqrt(dh), the
// softmax is fp32, and the normalised probabilities are rounded to v's dtype
// before the product with v, which accumulates in fp32.
//
// Bound: at the flagship shapes (T <= 256, dh = 32) each (batch*head)
// moves 4*T*dh elements and needs 4*T^2*dh flops, at most 128 flops per
// byte in bf16, below the card's ~295: by the roofline the work is
// bandwidth-bound, and the dense form adds a [BH,T,T] fp32 tensor written
// and read back, which this kernel never materialises. This first kernel
// does not reach that bound: it runs on the FP32 FMA pipes, not the tensor
// cores, and the FMAs and the shared-memory loads feeding them set its
// time (PERF.md has the numbers).
//
// Design: one block per (batch*head, tile of 64 queries), one thread per
// query, which holds its q row and its output row in registers. K and V
// stream through shared memory in tiles of 64 keys, so any T works (the
// TPU kernel keeps all of K/V resident, which at the Cityscapes T = 2048
// would not fit a Hopper block). Two passes over the key tiles:
//   1. online running max and running sum of exp(logit - max);
//   2. p = exp(logit - max) / sum, rounded to v's dtype, accumulated into
//      the output row.
// Pass 2 recomputes the logits rather than storing them, so the
// probabilities are the final normalised ones before the rounding, exactly
// as in the TPU kernel. Ragged query and key tails are masked.
//
// Layout: q, k, v are [BH, dh, T] with unit stride along T and any stride
// along dh and BH — the views that the reference's legacy qkv split gives
// (channels ordered (heads, [q|k|v], dh)). out is [BH, dh, T] contiguous.
#include <math.h>

#include "common.cuh"

using namespace ccdm;

namespace {

constexpr int kQTile = 64;  // queries per block, one per thread
constexpr int kKTile = 64;  // keys per shared-memory tile

template <int DH>
__device__ __forceinline__ float dot_row(const float (&q)[DH], const float* row) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    const float4 k4 = r[d];
    acc = fmaf(q[4 * d], k4.x, acc);
    acc = fmaf(q[4 * d + 1], k4.y, acc);
    acc = fmaf(q[4 * d + 2], k4.z, acc);
    acc = fmaf(q[4 * d + 3], k4.w, acc);
  }
  return acc;
}

template <typename T, int DH>
__device__ __forceinline__ void load_tile(float (*dst)[DH + 4], const T* src, long long sd,
                                          int s0, int nk) {
  // thread i loads key s0+i: neighbouring threads read neighbouring tokens
  const int i = threadIdx.x;
  if (i < nk) {
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[i][d] = to_float(src[d * sd + s0 + i]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kQTile)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         T* __restrict__ out, int t_len, int q_tiles, long long q_sbh, long long q_sd,
         long long k_sbh, long long k_sd, long long v_sbh, long long v_sd, float scale) {
  // rows padded by 4 floats: keeps float4 alignment and spreads the
  // transposed stores over 8 banks instead of 1
  __shared__ __align__(16) float ks[kKTile][DH + 4];
  __shared__ __align__(16) float vs[kKTile][DH + 4];

  const int bh = blockIdx.x / q_tiles;
  const int qi = (blockIdx.x % q_tiles) * kQTile + threadIdx.x;
  const bool active = qi < t_len;
  const T* kb = k + bh * k_sbh;
  const T* vb = v + bh * v_sbh;

  float qr[DH];
  {
    const T* qb = q + bh * q_sbh;
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = active ? to_float(qb[d * q_sd + qi]) : 0.f;
  }

  // pass 1: running max m and running sum l of exp(logit - m)
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < t_len; s0 += kKTile) {
    const int nk = min(kKTile, t_len - s0);
    __syncthreads();  // the previous tile is consumed
    load_tile<T, DH>(ks, kb, k_sd, s0, nk);
    __syncthreads();
    for (int s = 0; s < nk; ++s) {
      const float x = dot_row<DH>(qr, ks[s]) * scale;
      const float mn = fmaxf(m, x);
      l = l * expf(m - mn) + expf(x - mn);
      m = mn;
    }
  }

  // pass 2: normalised probabilities, rounded to v's dtype, times v
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int s0 = 0; s0 < t_len; s0 += kKTile) {
    const int nk = min(kKTile, t_len - s0);
    __syncthreads();
    load_tile<T, DH>(ks, kb, k_sd, s0, nk);
    load_tile<T, DH>(vs, vb, v_sd, s0, nk);
    __syncthreads();
    for (int s = 0; s < nk; ++s) {
      const float x = dot_row<DH>(qr, ks[s]) * scale;
      const float p = to_float(from_float<T>(expf(x - m) / l));
      const float4* vr = reinterpret_cast<const float4*>(vs[s]);
#pragma unroll
      for (int d = 0; d < DH / 4; ++d) {
        const float4 v4 = vr[d];
        acc[4 * d] = fmaf(p, v4.x, acc[4 * d]);
        acc[4 * d + 1] = fmaf(p, v4.y, acc[4 * d + 1]);
        acc[4 * d + 2] = fmaf(p, v4.z, acc[4 * d + 2]);
        acc[4 * d + 3] = fmaf(p, v4.w, acc[4 * d + 3]);
      }
    }
  }

  if (active) {
    T* ob = out + static_cast<long long>(bh) * DH * t_len;
#pragma unroll
    for (int d = 0; d < DH; ++d) ob[static_cast<long long>(d) * t_len + qi] = from_float<T>(acc[d]);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int t,
           long long q_sbh, long long q_sd, long long k_sbh, long long k_sd,
           long long v_sbh, long long v_sd, float scale, cudaStream_t stream) {
  const int q_tiles = (t + kQTile - 1) / kQTile;
  const dim3 grid(static_cast<unsigned int>(bh) * q_tiles);
  attn_fwd<T, DH><<<grid, kQTile, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), t, q_tiles, q_sbh, q_sd, k_sbh, k_sd, v_sbh, v_sd, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* out, int bh, int t,
                int dh, long long q_sbh, long long q_sd, long long k_sbh, long long k_sd,
                long long v_sbh, long long v_sd, float scale, cudaStream_t stream) {
  if (dh == 32)
    return launch<T, 32>(q, k, v, out, bh, t, q_sbh, q_sd, k_sbh, k_sd, v_sbh, v_sd, scale,
                         stream);
  if (dh == 64)
    return launch<T, 64>(q, k, v, out, bh, t, q_sbh, q_sd, k_sbh, k_sd, v_sbh, v_sd, scale,
                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: [bh, dh, t] views with unit stride along t (strides in elements
// along bh and dh given); out: [bh, dh, t] contiguous. dh in {32, 64}.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int ccdm_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    int dtype, int bh, int t, int dh, long long q_sbh,
                                    long long q_sd, long long k_sbh, long long k_sd,
                                    long long v_sbh, long long v_sd, float scale,
                                    void* stream) {
  if (bh <= 0 || t <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_dh<float>(q, k, v, out, bh, t, dh, q_sbh, q_sd, k_sbh, k_sd, v_sbh,
                              v_sd, scale, s);
  if (dtype == kBFloat16)
    return dispatch_dh<__nv_bfloat16>(q, k, v, out, bh, t, dh, q_sbh, q_sd, k_sbh, k_sd,
                                      v_sbh, v_sd, scale, s);
  return cudaErrorInvalidValue;
}
