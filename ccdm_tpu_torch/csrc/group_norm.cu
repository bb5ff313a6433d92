// Fused GroupNorm(+SiLU) over NCHW activations, with an optional per-(sample,
// channel) add in front of it.
//
// Replaces: ccdm_tpu/ops/group_norm.py, _gn_stats_norm_kernel (launched by
// pallas_group_norm). Per (sample, group): fp32 sum and sum of squares,
// mean, var = max(E[x^2] - mean^2, 0) (flax GroupNorm's clamp), rstd =
// rsqrt(var + eps), then y = (x - mean) * (rstd * gamma) + beta with an
// optional SiLU, written in the input dtype. With `add` ([B, C], x's dtype)
// the kernel first forms x + add[b, c] rounded to x's dtype, exactly as the
// ResBlock's unfused `h + emb_out` does (ccdm_tpu/models/layers.py:181-182),
// and normalises that sum; the add never makes its own pass over x.
//
// Bound: device-memory bandwidth. Each element costs ~10 flops against the
// 2-4 bytes it is read and written with; the least traffic is one read of x
// and one write of y. The flagship's largest inputs ([128,64,128,128] bf16,
// the [128,32,128,128] fp32 head) are 268 MB, far beyond the 50 MB L2.
//
// Design. In NCHW one (sample, group) slab is a contiguous run of cpg*H*W
// elements. The wrapper (ops/group_norm.py::_plan) picks one of three paths
// per shape and passes its parameters; this file only checks them:
//   S  gn_small: slabs of at most 8 vectors per lane. One warp per slab,
//      8 slabs per block; the warp keeps its slab in registers, so x is read
//      once and y written once in one launch (the 8x8 and 16x16 levels and
//      the attention pre-norms, where launch latency and not bytes set the
//      time). At 16 vectors a lane the registers leave one block an SM.
//   M  gn_cluster: slabs that fit the shared memory of one thread-block
//      cluster of 1-8 blocks of at most 64 KB each, so 3 blocks share an SM
//      and one block's copy overlaps another's arithmetic (every flagship
//      slab is <= 64 KB). Each block copies its chunk into shared memory with
//      one bulk asynchronous copy (cp.async.bulk, completion on an mbarrier) when
//      address and size are 16-byte aligned, with element loads otherwise,
//      reduces it, and the blocks of a cluster exchange their (sum, sum of
//      squares) partials over distributed shared memory; every rank adds
//      them in rank order, so the result is the same on every run without
//      atomics. Each block then normalises its chunk from shared memory:
//      one read and one write of x, one launch.
//   L  gn_partial_stats + gn_apply: larger slabs (the Cityscapes torso's
//      1 MB bf16 and head's 2 MB fp32 slabs). Per-chunk partials to scratch,
//      then a second launch folds them in a fixed order and normalises: two
//      reads, one write, but many blocks an SM; on 1 MB slabs it ran faster
//      than a cluster of 8 blocks of 128 KB, one block an SM.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace ccdm;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSlabsPerBlock = kThreads / 32;  // path S: one warp per slab

constexpr uint32_t kBulkPiece = 32 * 1024;     // bytes per cp.async.bulk (multiple of 16)

enum Path : int { kSmall = 0, kCluster = 1, kLarge = 2 };

// x + add[c], rounded to T as the unfused add in T rounds it
template <typename T>
__device__ __forceinline__ float add_rounded(float v, float a) {
  return to_float(from_float<T>(v + a));
}

// y = (v - mean) * (rstd * gamma) + beta, then SiLU; the plain version's order.
// The SiLU's exponential and divide run on the SFU (__expf, __fdividef: a few
// ulps, far inside the 2e-5 fp32 bound): with expf and an IEEE divide the
// arithmetic costs as much as the bytes at the flagship's largest shape.
__device__ __forceinline__ float normalise(float v, float mean, float mul, float shift,
                                          int silu) {
  float y = (v - mean) * mul + shift;
  if (silu) y = __fdividef(y, 1.f + __expf(-y));
  return y;
}

struct Stats {
  float mean, rstd;
};

__device__ __forceinline__ Stats finish(float s1, float s2, float n, float eps) {
  const float mean = s1 / n;
  const float var = fmaxf(s2 / n - mean * mean, 0.f);
  return {mean, rsqrtf(var + eps)};
}

// sum over the block; the result is valid in warp 0
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

// Geometry shared by the kernels. Slab `bg` is sample bg / groups, channels
// c0 .. c0 + cpg - 1 with c0 = (bg % groups) * cpg.
struct Geom {
  int slab, hw, cpg, groups, channels;
  __device__ __forceinline__ int sample(long long bg) const {
    return static_cast<int>(bg / groups);
  }
  __device__ __forceinline__ int first_channel(long long bg) const {
    return static_cast<int>(bg % groups) * cpg;
  }
};

// ---- path S: one warp per slab, values in registers ----------------------

template <typename T, int VEC, int NPACK>
__global__ void __launch_bounds__(kThreads)
gn_small(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
         const float* __restrict__ beta, const T* __restrict__ add, long long n_slabs,
         Geom g, float eps, int silu) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bg = static_cast<long long>(blockIdx.x) * kSlabsPerBlock + warp;
  if (bg >= n_slabs) return;  // the whole warp leaves; nothing below syncs the block
  const T* xb = x + bg * g.slab;
  T* yb = y + bg * g.slab;
  const int c0 = g.first_channel(bg);
  const T* ab = add ? add + static_cast<long long>(g.sample(bg)) * g.channels + c0 : nullptr;

  Pack<T, VEC> p[NPACK];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NPACK; ++j) {
    const int i = (j * 32 + lane) * VEC;
    if (i < g.slab) {
      p[j] = *reinterpret_cast<const Pack<T, VEC>*>(xb + i);
      // hw % VEC == 0, so a pack never straddles two channels
      const float a = ab ? to_float(ab[i / g.hw]) : 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = to_float(p[j].v[e]);
        if (ab) {
          v = add_rounded<T>(v, a);
          p[j].v[e] = from_float<T>(v);
        }
        s1 += v;
        s2 += v * v;
      }
    }
  }
  const Stats st = finish(warp_sum(s1), warp_sum(s2), static_cast<float>(g.slab), eps);
#pragma unroll
  for (int j = 0; j < NPACK; ++j) {
    const int i = (j * 32 + lane) * VEC;
    if (i < g.slab) {
      const int c = c0 + i / g.hw;
      const float mul = st.rstd * gamma[c], shift = beta[c];
      Pack<T, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = from_float<T>(normalise(to_float(p[j].v[e]), st.mean, mul, shift, silu));
      *reinterpret_cast<Pack<T, VEC>*>(yb + i) = o;
    }
  }
}

// ---- path M: one cluster per slab, the slab in shared memory -------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// BULK: one cp.async.bulk of the chunk (16-byte aligned address and size);
// otherwise element loads.
template <typename T, int VEC, bool BULK>
__global__ void __launch_bounds__(kThreads)
gn_cluster(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
           const float* __restrict__ beta, const T* __restrict__ add, int chunk, Geom g,
           float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ __align__(8) unsigned long long bar;
  __shared__ float partial[2];
  __shared__ Stats stats;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const long long bg = blockIdx.x / ranks;
  const int begin = rank * chunk;
  const int n = max(0, min(chunk, g.slab - begin));
  const T* src = x + bg * g.slab + begin;

  if constexpr (BULK) {
    const uint32_t b = smem_addr(&bar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(n) * sizeof(T);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(bytes)
                   : "memory");
      const char* from = reinterpret_cast<const char*>(src);
      for (uint32_t off = 0; off < bytes; off += kBulkPiece)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem_raw) + off),
            "l"(from + off), "r"(min(kBulkPiece, bytes - off)), "r"(b)
            : "memory");
    }
    mbar_wait(b, 0);
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) xs[i] = src[i];
    __syncthreads();
  }

  const int c0 = g.first_channel(bg);
  const T* ab = add ? add + static_cast<long long>(g.sample(bg)) * g.channels + c0 : nullptr;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x * VEC; i < n; i += kThreads * VEC) {
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xs + i);
    const float a = ab ? to_float(ab[(begin + i) / g.hw]) : 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float v = to_float(p.v[e]);
      if (ab) {
        v = add_rounded<T>(v, a);
        p.v[e] = from_float<T>(v);
      }
      s1 += v;
      s2 += v * v;
    }
    // the same thread reads these elements back below
    if (ab) *reinterpret_cast<Pack<T, VEC>*>(xs + i) = p;
  }
  block_sum2(s1, s2);
  if (ranks == 1) {
    if (threadIdx.x == 0) stats = finish(s1, s2, static_cast<float>(g.slab), eps);
    __syncthreads();
  } else {
    if (threadIdx.x == 0) {
      partial[0] = s1;
      partial[1] = s2;
    }
    cluster.sync();  // every rank's partials are written
    if (threadIdx.x == 0) {
      float a = 0.f, b = 0.f;
      for (int r = 0; r < ranks; ++r) {  // rank order: the same sum on every rank
        const float* pr = cluster.map_shared_rank(partial, r);
        a += pr[0];
        b += pr[1];
      }
      stats = finish(a, b, static_cast<float>(g.slab), eps);
    }
    cluster.sync();  // no rank leaves while another reads its partials
  }
  const Stats st = stats;
  T* dst = y + bg * g.slab + begin;
  for (int i = threadIdx.x * VEC; i < n; i += kThreads * VEC) {
    const int c = c0 + (begin + i) / g.hw;
    const float mul = st.rstd * gamma[c], shift = beta[c];
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xs + i);
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = from_float<T>(normalise(to_float(p.v[e]), st.mean, mul, shift, silu));
    *reinterpret_cast<Pack<T, VEC>*>(dst + i) = o;
  }
}

// ---- path L: partial sums to scratch, then apply --------------------------

// x: [B*G, slab] contiguous; partial: [B*G, splits, 2].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_partial_stats(const T* __restrict__ x, const T* __restrict__ add,
                 float* __restrict__ partial, long long chunk, int splits, Geom g) {
  const long long bg = blockIdx.x / splits;
  const long long begin = (blockIdx.x % splits) * chunk;
  const long long end = min(begin + chunk, static_cast<long long>(g.slab));
  const T* base = x + bg * g.slab;
  const int c0 = g.first_channel(bg);
  const T* ab = add ? add + static_cast<long long>(g.sample(bg)) * g.channels + c0 : nullptr;
  float s1 = 0.f, s2 = 0.f;
  for (long long i = begin + threadIdx.x * VEC; i < end; i += kThreads * VEC) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(base + i);
    const float a = ab ? to_float(ab[i / g.hw]) : 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = to_float(p.v[j]);
      if (ab) v = add_rounded<T>(v, a);
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
         const float* __restrict__ beta, const T* __restrict__ add,
         const float* __restrict__ partial, long long chunk, int splits, Geom g, float eps,
         int silu) {
  const long long bg = blockIdx.x / splits;
  const long long begin = (blockIdx.x % splits) * chunk;
  const long long end = min(begin + chunk, static_cast<long long>(g.slab));
  __shared__ Stats stats;
  if (threadIdx.x < 32) {
    const float* pg = partial + 2 * bg * splits;
    float a = 0.f, b = 0.f;
    for (int j = threadIdx.x; j < splits; j += 32) {
      a += pg[2 * j];
      b += pg[2 * j + 1];
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (threadIdx.x == 0) stats = finish(a, b, static_cast<float>(g.slab), eps);
  }
  __syncthreads();
  const Stats st = stats;
  const int c0 = g.first_channel(bg);
  const T* ab = add ? add + static_cast<long long>(g.sample(bg)) * g.channels + c0 : nullptr;
  const T* xb = x + bg * g.slab;
  T* yb = y + bg * g.slab;
  for (long long i = begin + threadIdx.x * VEC; i < end; i += kThreads * VEC) {
    const int cl = static_cast<int>(i / g.hw);
    const float mul = st.rstd * gamma[c0 + cl], shift = beta[c0 + cl];
    const float a = ab ? to_float(ab[cl]) : 0.f;
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xb + i);
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = to_float(p.v[j]);
      if (ab) v = add_rounded<T>(v, a);
      o.v[j] = from_float<T>(normalise(v, st.mean, mul, shift, silu));
    }
    *reinterpret_cast<Pack<T, VEC>*>(yb + i) = o;
  }
}

// ---- launches ---------------------------------------------------------------

struct Args {
  const void *x, *gamma, *beta, *add;
  void *y, *partial;
  long long batch;
  Geom g;
  int param;        // S: packs per lane; M: cluster size; L: splits
  long long chunk;  // M and L: elements per block
  float eps;
  int silu;
  cudaStream_t stream;
};

template <typename T, int VEC, int NPACK>
int launch_small(const Args& a) {
  const long long n_slabs = a.batch * a.g.groups;
  const dim3 blocks(static_cast<unsigned int>((n_slabs + kSlabsPerBlock - 1) / kSlabsPerBlock));
  gn_small<T, VEC, NPACK><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.y), static_cast<const float*>(a.gamma),
      static_cast<const float*>(a.beta), static_cast<const T*>(a.add), n_slabs, a.g, a.eps,
      a.silu);
  return cudaGetLastError();
}

template <typename T, int VEC>
int dispatch_small(const Args& a) {
  switch (a.param) {
    case 1: return launch_small<T, VEC, 1>(a);
    case 2: return launch_small<T, VEC, 2>(a);
    case 4: return launch_small<T, VEC, 4>(a);
    case 8: return launch_small<T, VEC, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int VEC>
int launch_cluster(const Args& a) {
  constexpr bool kBulk = VEC > 1;  // VEC > 1 only where address and size are 16-byte aligned
  auto kernel = gn_cluster<T, VEC, kBulk>;
  const int cluster = a.param;
  const size_t smem = static_cast<size_t>(a.chunk) * sizeof(T);
  // raised once per device and size: the attribute call on every launch
  // costs host time, and the host paces the sampler's hundreds of launches a step
  constexpr int kMaxDevices = 64;
  static size_t raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || smem > raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) raised[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(a.batch * a.g.groups * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.x), static_cast<T*>(a.y),
                           static_cast<const float*>(a.gamma),
                           static_cast<const float*>(a.beta), static_cast<const T*>(a.add),
                           static_cast<int>(a.chunk), a.g, a.eps, a.silu);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int VEC>
int launch_large(const Args& a) {
  const int splits = a.param;
  const dim3 blocks(static_cast<unsigned int>(a.batch * a.g.groups * splits));
  gn_partial_stats<T, VEC><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.add), static_cast<float*>(a.partial),
      a.chunk, splits, a.g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply<T, VEC><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.y), static_cast<const float*>(a.gamma),
      static_cast<const float*>(a.beta), static_cast<const T*>(a.add),
      static_cast<const float*>(a.partial), a.chunk, splits, a.g, a.eps, a.silu);
  return cudaGetLastError();
}

template <typename T, int VEC>
int dispatch_path(int path, const Args& a) {
  if (path == kSmall) return dispatch_small<T, VEC>(a);
  if (path == kCluster) {
    if (a.param < 1 || a.param > 8 || a.chunk <= 0 || a.chunk * a.param < a.g.slab ||
        a.chunk % VEC)
      return cudaErrorInvalidValue;
    return launch_cluster<T, VEC>(a);
  }
  if (path == kLarge) {
    if (a.param < 1 || a.chunk <= 0 || a.chunk * a.param < a.g.slab || a.chunk % VEC)
      return cudaErrorInvalidValue;
    return launch_large<T, VEC>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch_vec(int path, int vec, const Args& a) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == 1) return dispatch_path<T, 1>(path, a);
  if (vec != kVec) return cudaErrorInvalidValue;
  // 16-byte vectors need aligned rows that never straddle a channel
  if (reinterpret_cast<uintptr_t>(a.x) % 16 || reinterpret_cast<uintptr_t>(a.y) % 16 ||
      a.g.hw % kVec)
    return cudaErrorMisalignedAddress;
  return dispatch_path<T, kVec>(path, a);
}

}  // namespace

// x, y: [batch, channels, hw] contiguous, dtype per `dtype`; gamma, beta:
// [channels] fp32; add: [batch, channels] in x's dtype, or null; partial:
// fp32 scratch of batch*groups*param*2 floats (path L only, else unused).
// path 0 (S): param = vectors per lane (1, 2, 4 or 8);
// path 1 (M): param = cluster size (1-8), chunk = elements per block;
// path 2 (L): param = splits per slab, chunk = elements per block.
// vec: elements per vector access, 1 or 16 / sizeof(dtype).
// Launches on `stream`, allocates nothing, returns a cudaError_t.
extern "C" int ccdm_group_norm(const void* x, void* y, const void* gamma, const void* beta,
                               const void* add, void* partial, int dtype, long long batch,
                               long long channels, long long hw, int groups, int path,
                               int vec, int param, long long chunk, float eps, int silu,
                               void* stream) {
  if (groups <= 0 || channels % groups != 0 || batch <= 0 || hw <= 0)
    return cudaErrorInvalidValue;
  const long long slab = channels / groups * hw;
  if (slab > 0x7fffffffLL || channels > 0x7fffffffLL) return cudaErrorInvalidValue;
  Args a{x, gamma, beta, add, y, partial, batch,
         Geom{static_cast<int>(slab), static_cast<int>(hw), static_cast<int>(channels / groups),
              groups, static_cast<int>(channels)},
         param, chunk, eps, silu, static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch_vec<float>(path, vec, a);
  if (dtype == kBFloat16) return dispatch_vec<__nv_bfloat16>(path, vec, a);
  return cudaErrorInvalidValue;
}
