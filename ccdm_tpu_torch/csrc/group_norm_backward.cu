// The backward of the fused GroupNorm(+SiLU) with the optional per-(sample,
// channel) add in front of it (the forward is group_norm.cu).
//
// Replaces: the autodiff of the GroupNorm that the JAX package trains
// through (flax nn.GroupNorm in ccdm_tpu/models/layers.py:65, XLA code);
// its forward is the Pallas kernel ccdm_tpu/ops/group_norm.py,
// _gn_stats_norm_kernel. Per (sample, group) slab of N = cpg*H*W elements,
// with v = x + add[b, c] rounded to x's dtype (the sum the forward
// normalised), mean and rstd recomputed from v as the forward computes
// them (fp32 sums, var = max(E[v^2] - mean^2, 0)), xhat = (v - mean) * rstd:
//   g   = dy * silu'(y_pre), y_pre = (v - mean) * (rstd * gamma) + beta
//         (g = dy without SiLU)
//   u   = g * gamma[c]
//   dv  = rstd * (u - mean(u) - xhat * mean(u * xhat))      -> dx, in x's dtype
//   dgamma[c] = sum_{b,hw} g * xhat, dbeta[c] = sum_{b,hw} g  (fp32)
//   dadd[b, c] = sum_hw dv                                   (in x's dtype)
//
// Bound: device-memory bandwidth. The least traffic is one read of x, one
// read of dy and one write of dx (plus the [B, C] add and dadd); each
// element costs ~20 flops and one exponential.
//
// Design: simple, one block per slab, three passes over the slab from
// device memory: (1) the statistics, (2) the per-channel sums of g * xhat
// and g, from which the slab's sums of u and u * xhat follow (sum over the
// group's channels of gamma[c] times them), (3) dx, and with the add its
// per-channel sum. Passes 2 and 3 read x and dy again; a slab of the
// flagship is at most 64 KB each, and the re-reads come from L2 where the
// blocks in flight fit it. The mean and rstd are recomputed here rather
// than stored by the forward: the forward kernels stay as they are and
// nothing is kept between the two calls. The per-(sample, channel) sums of
// dgamma and dbeta go to scratch, and a second launch adds them over the
// batch in sample order: every sum has a fixed order and no atomics, so two
// runs give the same gradients bit for bit.
#include "common.cuh"

using namespace ccdm;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the sum of (a, b) over the block, returned to every thread; each thread
// adds the warps' partials in warp order, so all get the same value
__device__ __forceinline__ float2 block_allreduce2(float a, float b) {
  __shared__ float sa[kWarps], sb[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    r.x += sa[w];
    r.y += sb[w];
  }
  __syncthreads();  // no warp writes the next partials before all have read these
  return r;
}

struct Slab {
  long long bg;   // (sample, group) index
  int b, c0;      // sample, first channel
};

template <typename T>
__device__ __forceinline__ float load_v(T raw, float a, bool has_add) {
  float v = to_float(raw);
  // x + add[c], rounded to T as the forward's unfused add rounds it
  return has_add ? to_float(from_float<T>(v + a)) : v;
}

// dy scaled by silu'(y_pre) when the forward applied SiLU
__device__ __forceinline__ float grad_pre(float dy, float centred, float mul, float shift,
                                          int silu) {
  if (!silu) return dy;
  const float y = centred * mul + shift;
  const float s = 1.f / (1.f + __expf(-y));
  return dy * s * (1.f + y * (1.f - s));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_backward(const T* __restrict__ x, const T* __restrict__ dy,
            const float* __restrict__ gamma, const float* __restrict__ beta,
            const T* __restrict__ add, T* __restrict__ dx, T* __restrict__ dadd,
            float* __restrict__ partial_w, float* __restrict__ partial_b, int hw, int cpg,
            int groups, int channels, float eps, int silu) {
  const long long bg = blockIdx.x;
  const int b = static_cast<int>(bg / groups);
  const int c0 = static_cast<int>(bg % groups) * cpg;
  const long long slab = static_cast<long long>(cpg) * hw;
  const T* xb = x + bg * slab;
  const T* gb = dy + bg * slab;
  T* db = dx + bg * slab;
  const T* ab = add ? add + static_cast<long long>(b) * channels + c0 : nullptr;
  const bool has_add = ab != nullptr;

  // pass 1: the statistics of v = x (+ add)
  float s1 = 0.f, s2 = 0.f;
  for (int cl = 0; cl < cpg; ++cl) {
    const float a = has_add ? to_float(ab[cl]) : 0.f;
    const T* xc = xb + static_cast<long long>(cl) * hw;
    for (int i = threadIdx.x * VEC; i < hw; i += kThreads * VEC) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xc + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = load_v<T>(p.v[e], a, has_add);
        s1 += v;
        s2 += v * v;
      }
    }
  }
  const float2 tot = block_allreduce2(s1, s2);
  const float n = static_cast<float>(slab);
  const float mean = tot.x / n;
  const float rstd = rsqrtf(fmaxf(tot.y / n - mean * mean, 0.f) + eps);

  // pass 2: per channel, sum g * xhat and g; the slab's sums of u and u * xhat
  float sum_u = 0.f, sum_ux = 0.f;
  for (int cl = 0; cl < cpg; ++cl) {
    const int c = c0 + cl;
    const float a = has_add ? to_float(ab[cl]) : 0.f;
    const float w = gamma[c], mul = rstd * w, shift = beta[c];
    const long long off = static_cast<long long>(cl) * hw;
    float sw = 0.f, sb = 0.f;
    for (int i = threadIdx.x * VEC; i < hw; i += kThreads * VEC) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + off + i);
      const Pack<T, VEC> q = *reinterpret_cast<const Pack<T, VEC>*>(gb + off + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float centred = load_v<T>(p.v[e], a, has_add) - mean;
        const float g = grad_pre(to_float(q.v[e]), centred, mul, shift, silu);
        sw += g * (centred * rstd);
        sb += g;
      }
    }
    const float2 r = block_allreduce2(sw, sb);
    if (threadIdx.x == 0) {
      partial_w[static_cast<long long>(b) * channels + c] = r.x;
      partial_b[static_cast<long long>(b) * channels + c] = r.y;
    }
    sum_u += w * r.y;
    sum_ux += w * r.x;
  }
  const float m1 = sum_u / n, m2 = sum_ux / n;

  // pass 3: dx, and with the add its per-channel sum
  for (int cl = 0; cl < cpg; ++cl) {
    const int c = c0 + cl;
    const float a = has_add ? to_float(ab[cl]) : 0.f;
    const float w = gamma[c], mul = rstd * w, shift = beta[c];
    const long long off = static_cast<long long>(cl) * hw;
    float sd = 0.f;
    for (int i = threadIdx.x * VEC; i < hw; i += kThreads * VEC) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + off + i);
      const Pack<T, VEC> q = *reinterpret_cast<const Pack<T, VEC>*>(gb + off + i);
      Pack<T, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float centred = load_v<T>(p.v[e], a, has_add) - mean;
        const float g = grad_pre(to_float(q.v[e]), centred, mul, shift, silu);
        const float d = rstd * (g * w - m1 - centred * rstd * m2);
        sd += d;
        o.v[e] = from_float<T>(d);
      }
      *reinterpret_cast<Pack<T, VEC>*>(db + off + i) = o;
    }
    if (has_add) {
      const float2 r = block_allreduce2(sd, 0.f);
      if (threadIdx.x == 0) dadd[static_cast<long long>(b) * channels + c] = from_float<T>(r.x);
    }
  }
}

// dgamma[c] = sum_b partial_w[b, c], dbeta likewise, in sample order
__global__ void gn_backward_params(const float* __restrict__ partial_w,
                                   const float* __restrict__ partial_b,
                                   float* __restrict__ dgamma, float* __restrict__ dbeta,
                                   int batch, int channels) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float w = 0.f, bsum = 0.f;
  for (int b = 0; b < batch; ++b) {
    w += partial_w[static_cast<long long>(b) * channels + c];
    bsum += partial_b[static_cast<long long>(b) * channels + c];
  }
  dgamma[c] = w;
  dbeta[c] = bsum;
}

template <typename T, int VEC>
int launch(const void* x, const void* dy, const void* gamma, const void* beta,
           const void* add, void* dx, void* dadd, float* partial, void* dgamma, void* dbeta,
           int batch, int channels, int hw, int groups, float eps, int silu,
           cudaStream_t stream) {
  const int cpg = channels / groups;
  float* partial_w = partial;
  float* partial_b = partial + static_cast<long long>(batch) * channels;
  gn_backward<T, VEC><<<static_cast<unsigned int>(batch) * groups, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(add), static_cast<T*>(dx),
      static_cast<T*>(dadd), partial_w, partial_b, hw, cpg, groups, channels, eps, silu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_backward_params<<<(channels + 255) / 256, 256, 0, stream>>>(
      partial_w, partial_b, static_cast<float*>(dgamma), static_cast<float*>(dbeta), batch,
      channels);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int vec, const void* x, const void* dy, const void* gamma, const void* beta,
             const void* add, void* dx, void* dadd, float* partial, void* dgamma, void* dbeta,
             int batch, int channels, int hw, int groups, float eps, int silu,
             cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == 1)
    return launch<T, 1>(x, dy, gamma, beta, add, dx, dadd, partial, dgamma, dbeta, batch,
                        channels, hw, groups, eps, silu, stream);
  if (vec != kVec) return cudaErrorInvalidValue;
  // 16-byte vectors need aligned rows that never straddle a channel
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(dx) % 16 || hw % kVec)
    return cudaErrorMisalignedAddress;
  return launch<T, kVec>(x, dy, gamma, beta, add, dx, dadd, partial, dgamma, dbeta, batch,
                         channels, hw, groups, eps, silu, stream);
}

}  // namespace

// x, dy, dx: [batch, channels, hw] contiguous, dtype per `dtype`; gamma, beta,
// dgamma, dbeta: [channels] fp32; add, dadd: [batch, channels] in x's dtype,
// both null or both given; partial: fp32 scratch of 2 * batch * channels.
// vec: elements per vector access, 1 or 16 / sizeof(dtype). Launches two
// kernels on `stream`, allocates nothing, returns a cudaError_t.
extern "C" int ccdm_group_norm_backward(const void* x, const void* dy, const void* gamma,
                                        const void* beta, const void* add, void* dx,
                                        void* dadd, void* partial, void* dgamma, void* dbeta,
                                        int dtype, long long batch, long long channels,
                                        long long hw, int groups, int vec, float eps, int silu,
                                        void* stream) {
  if (groups <= 0 || channels % groups != 0 || batch <= 0 || hw <= 0 ||
      (add == nullptr) != (dadd == nullptr))
    return cudaErrorInvalidValue;
  if (batch * groups > 0x7fffffffLL || channels > 0x7fffffffLL || hw > 0x7fffffffLL ||
      channels / groups * hw > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const int b = static_cast<int>(batch), c = static_cast<int>(channels),
            h = static_cast<int>(hw);
  if (dtype == kFloat32)
    return dispatch<float>(vec, x, dy, gamma, beta, add, dx, dadd, part, dgamma, dbeta, b, c,
                           h, groups, eps, silu, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(vec, x, dy, gamma, beta, add, dx, dadd, part, dgamma,
                                   dbeta, b, c, h, groups, eps, silu, s);
  return cudaErrorInvalidValue;
}
