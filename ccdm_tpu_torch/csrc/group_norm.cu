// Fused GroupNorm(+SiLU) over NCHW activations.
//
// Replaces: ccdm_tpu/ops/group_norm.py, _gn_stats_norm_kernel (launched by
// pallas_group_norm). Per (sample, group): fp32 sum and sum of squares,
// mean, var = max(E[x^2] - mean^2, 0) (flax GroupNorm's clamp), rstd =
// rsqrt(var + eps), then y = (x - mean) * (rstd * gamma) + beta with an
// optional SiLU, written in the input dtype.
//
// Bound: device-memory bandwidth. Each element costs ~10 flops against 2-4
// bytes read and written per pass; on the flagship sampler the largest
// inputs are [128,64,128,128] bf16 and the [128,32,128,128] fp32 head, each
// 268 MB, far beyond the 50 MB L2.
//
// Design: the TPU kernel keeps a whole sample in VMEM; a Hopper block has
// at most 227 KB of shared memory and one flagship sample is 2 MB, so the
// work splits into two launches instead:
//   1. gn_partial_stats: grid (B*G) x splits. In NCHW one (sample, group)
//      slab is a contiguous run of cpg*H*W elements; each block sums one
//      chunk of it with 16-byte vector loads and writes a partial
//      (sum, sum of squares) to scratch [B*G, splits, 2]. No atomics, so
//      the result is the same on every run.
//   2. gn_apply: same grid. Warp 0 folds the group's partials in a fixed
//      order into mean/rstd, then the block normalises its chunk, applies
//      the per-channel affine and SiLU, and stores with vector stores.
// Reads are 2 passes over x (stats, apply) plus 1 write; the first pass
// keeps the whole tensor's bytes moving with enough blocks to fill 132 SMs.
#include "common.cuh"

using namespace ccdm;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32], sb[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sa[lane] : 0.f;
    b = lane < kThreads / 32 ? sb[lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

// x: [B*G, slab] contiguous; partial: [B*G, splits, 2].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_partial_stats(const T* __restrict__ x, float* __restrict__ partial,
                 long long slab, long long chunk, int splits) {
  const long long bg = blockIdx.x / splits;
  const long long begin = (blockIdx.x % splits) * chunk;
  const long long end = min(begin + chunk, slab);
  const T* base = x + bg * slab;
  float s1 = 0.f, s2 = 0.f;
  for (long long i = begin + threadIdx.x * VEC; i < end; i += kThreads * VEC) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(base + i);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float v = to_float(p.v[j]);
      s1 += v;
      s2 += v * v;
    }
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = s1;
    partial[2 * blockIdx.x + 1] = s2;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_apply(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
         const float* __restrict__ beta, const float* __restrict__ partial,
         long long slab, long long chunk, int splits, long long hw, int cpg,
         int groups, float eps, int silu) {
  const long long bg = blockIdx.x / splits;
  const long long begin = (blockIdx.x % splits) * chunk;
  const long long end = min(begin + chunk, slab);
  __shared__ float s_mean, s_rstd;
  if (threadIdx.x < 32) {
    const float* pg = partial + 2 * bg * splits;
    float a = 0.f, b = 0.f;
    for (int j = threadIdx.x; j < splits; j += 32) {
      a += pg[2 * j];
      b += pg[2 * j + 1];
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (threadIdx.x == 0) {
      const float n = static_cast<float>(slab);
      const float mean = a / n;
      const float var = fmaxf(b / n - mean * mean, 0.f);
      s_mean = mean;
      s_rstd = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mean = s_mean, rstd = s_rstd;
  const int c0 = static_cast<int>(bg % groups) * cpg;
  const T* xb = x + bg * slab;
  T* yb = y + bg * slab;
  for (long long i = begin + threadIdx.x * VEC; i < end; i += kThreads * VEC) {
    // hw % VEC == 0, so a pack never straddles two channels
    const int c = c0 + static_cast<int>(i / hw);
    const float mul = rstd * gamma[c];
    const float add = beta[c];
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + i);
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = (to_float(p.v[j]) - mean) * mul + add;
      if (silu) v = v / (1.f + expf(-v));
      o.v[j] = from_float<T>(v);
    }
    *reinterpret_cast<Pack<T, VEC>*>(yb + i) = o;
  }
}

template <typename T, int VEC>
int launch(const void* x, void* y, const void* gamma, const void* beta, void* partial,
           long long batch, long long channels, long long hw, int groups, int splits,
           float eps, int silu, cudaStream_t stream) {
  const int cpg = static_cast<int>(channels / groups);
  const long long slab = cpg * hw;
  long long chunk = (slab + splits - 1) / splits;
  chunk = (chunk + VEC - 1) / VEC * VEC;
  const dim3 blocks(static_cast<unsigned int>(batch * groups * splits));
  gn_partial_stats<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial), slab, chunk, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(partial), slab, chunk,
      splits, hw, cpg, groups, eps, silu);
  return cudaGetLastError();
}

template <typename T>
int dispatch_vec(const void* x, void* y, const void* gamma, const void* beta,
                 void* partial, long long batch, long long channels, long long hw,
                 int groups, int splits, float eps, int silu, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (aligned && hw % kVec == 0)
    return launch<T, kVec>(x, y, gamma, beta, partial, batch, channels, hw, groups,
                           splits, eps, silu, stream);
  return launch<T, 1>(x, y, gamma, beta, partial, batch, channels, hw, groups, splits,
                      eps, silu, stream);
}

}  // namespace

// x, y: [batch, channels, hw] contiguous, dtype per `dtype`; gamma, beta:
// [channels] fp32; partial: fp32 scratch of batch*groups*splits*2 floats.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int ccdm_group_norm(const void* x, void* y, const void* gamma, const void* beta,
                               void* partial, int dtype, long long batch,
                               long long channels, long long hw, int groups, int splits,
                               float eps, int silu, void* stream) {
  if (groups <= 0 || channels % groups != 0 || splits <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_vec<float>(x, y, gamma, beta, partial, batch, channels, hw, groups,
                               splits, eps, silu, s);
  if (dtype == kBFloat16)
    return dispatch_vec<__nv_bfloat16>(x, y, gamma, beta, partial, batch, channels, hw,
                                       groups, splits, eps, silu, s);
  return cudaErrorInvalidValue;
}
