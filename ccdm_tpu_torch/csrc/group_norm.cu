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
//
// Channels-last inputs (NHWC: x [B, HW, C], channels innermost, as the UNet's
// inference torso holds its activations) take paths of their own. There a
// group is `cpg` adjacent channels of every pixel, so a 16-byte vector of
// channels may span two groups and a (sample, group) slab is not contiguous.
// The unit of work is a (sample, channel tile): `tile` channels (whole
// groups, a multiple of the vector) of every pixel of one sample, whose rows
// of tile * itemsize bytes lie C * itemsize apart (contiguous where tile ==
// C). Each thread owns one channel vector of the tile and a set of pixel
// rows, so it accumulates per-channel fp32 sums and sums of squares (after
// the [B, C] add) and reads the add, gamma and beta of its channels once; a
// block reduces them over its rows and folds the channels into groups, in a
// fixed order.
//   M  gn_cluster_nhwc: units that fit a cluster of up to 16 blocks of at
//      most 64 KB: each thread copies its pixel rows into shared memory
//      (cp.async, 16 bytes a copy), the blocks read each other's group sums
//      over distributed shared memory, and each normalises its rows from
//      shared memory: one read and one write of x, one launch.
//   L  gn_partial_stats_nhwc + gn_apply_nhwc: larger units (the Cityscapes
//      torso's 32-64 MB samples). Clusters of stats blocks stream x and fold
//      their partials over distributed shared memory into one partial per
//      cluster; apply blocks fold those in order and normalise.
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

// ---- channels-last (NHWC) paths ---------------------------------------------

// Geometry of the NHWC paths. Unit u is sample u / tiles, channels c0 .. c0 +
// tile - 1 with c0 = (u % tiles) * tile; a thread owns channel vector `cv` of
// the tile and pixel rows row, row + rows, ... of its block's pixels.
struct GeomN {
  int hw, channels, cpg, tile;
  __host__ __device__ __forceinline__ int tiles() const { return channels / tile; }
  __host__ __device__ __forceinline__ int groups() const { return tile / cpg; }  // a tile
};

constexpr int kMaxTileGroups = 32;  // G <= 32 (models/layers.group_count)
constexpr int kMaxCluster = 16;     // blocks a cluster: the non-portable size
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileM = 128;      // path M: channels a tile (the warps' sums: 8 KB)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Path L's stats blocks: the thread's channel sums s[VEC] (thread `row *
// vectors + cv` of `active`, so `red` holds rows x tile values row-major)
// folded into the tile's groups, out[g] for g < groups, in a fixed order: a
// group's `per` threads (an aligned warp segment) each add every per-th
// (row, channel) of the group, then a shuffle tree. Every thread of the
// block calls it; `red` holds kThreads * VEC floats.
template <int VEC>
__device__ __forceinline__ void fold_rows(const float (&s)[VEC], float* red, float* out,
                                          int active, int rows, const GeomN& g) {
  for (int e = 0; e < VEC; ++e) red[threadIdx.x * VEC + e] = threadIdx.x < active ? s[e] : 0.f;
  __syncthreads();
  const int groups = g.groups();
  int per = 32;
  while (per * groups > kThreads) per >>= 1;
  const int grp = threadIdx.x / per, lane = threadIdx.x % per;
  float acc = 0.f;
  if (grp < groups) {
    const int n = rows * g.cpg;  // (row, channel of the group) pairs
    for (int k = lane; k < n; k += per)
      acc += red[(k / g.cpg) * g.tile + grp * g.cpg + k % g.cpg];
  }
  for (int o = per >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (grp < groups && lane == 0) out[grp] = acc;
  __syncthreads();  // `red` is free again, `out` is written
}

// The lanes of a row: a row's channel vectors take `lanes` adjacent threads,
// the least power of 2 that holds them (at most 32; the spare ones idle).
// So the threads of one channel vector in a warp are lanes apart by `lanes`.
__device__ __forceinline__ int row_lanes(int vectors) {
  int lanes = 1;
  while (lanes < vectors) lanes <<= 1;
  return lanes;
}

// Path M: the block's (sum, sum of squares) of each tile group into
// part[0][g], part[1][g], from the thread's channel sums s1, s2 (thread
// (row, cv) with `lanes` threads a row, `on` for cv < vectors): a shuffle
// tree adds a warp's rows, a table (`wsum`) holds each warp's channel sums,
// and a group's `per` threads (an aligned warp segment) add its channels
// over the warps, then a shuffle tree: a fixed order. Every thread of the
// block calls it.
template <int VEC>
__device__ __forceinline__ void fold_groups(float (&s1)[VEC], float (&s2)[VEC],
                                            float (*wsum)[kWarps][kMaxTileM],
                                            float (*part)[kMaxTileGroups], int lanes, bool on,
                                            int cl, const GeomN& g) {
  for (int o = 16; o >= lanes; o >>= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
      s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
    }
  }
  const int warp = threadIdx.x >> 5;
  if (on && (threadIdx.x & 31) < lanes) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      wsum[0][warp][cl + e] = s1[e];
      wsum[1][warp][cl + e] = s2[e];
    }
  }
  __syncthreads();
  const int groups = g.groups();
  int per = 32;
  while (per * groups > kThreads) per >>= 1;
  const int grp = threadIdx.x / per, k = threadIdx.x % per;
  float a = 0.f, q = 0.f;
  if (grp < groups) {
    for (int i = k; i < kWarps * g.cpg; i += per) {
      const int c = grp * g.cpg + i % g.cpg;
      a += wsum[0][i / g.cpg][c];
      q += wsum[1][i / g.cpg][c];
    }
  }
  for (int o = per >> 1; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  if (grp < groups && k == 0) {
    part[0][grp] = a;
    part[1][grp] = q;
  }
  __syncthreads();
}

// The add ([B, C]) of the thread's channels, read once
template <typename T, int VEC>
struct Lane {
  float a[VEC];
  __device__ __forceinline__ void load_add(const T* add, long long at) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[e] = add ? to_float(add[at + e]) : 0.f;
  }
};

// x + add rounded to T, accumulated into s1, s2; the sum written back into p
template <typename T, int VEC>
__device__ __forceinline__ void accumulate(Pack<T, VEC>& p, const float (&a)[VEC], bool add,
                                           float (&s1)[VEC], float (&s2)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float v = to_float(p.v[e]);
    if (add) {
      v = add_rounded<T>(v, a[e]);
      p.v[e] = from_float<T>(v);
    }
    s1[e] += v;
    s2[e] += v * v;
  }
}

// The thread's channels' mean, rstd * gamma and beta from the tile groups' stats
template <int VEC>
__device__ __forceinline__ void channel_affine(const Stats* st, const float* gamma,
                                               const float* beta, int c0, int cl,
                                               const GeomN& g, float (&mean)[VEC],
                                               float (&mul)[VEC], float (&shift)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const Stats s = st[(cl + e) / g.cpg];
    mean[e] = s.mean;
    mul[e] = s.rstd * gamma[c0 + cl + e];
    shift[e] = beta[c0 + cl + e];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> normalise_pack(const Pack<T, VEC>& p,
                                                       const float (&mean)[VEC],
                                                       const float (&mul)[VEC],
                                                       const float (&shift)[VEC], int silu) {
  Pack<T, VEC> o;
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    o.v[e] = from_float<T>(normalise(to_float(p.v[e]), mean[e], mul[e], shift[e], silu));
  return o;
}

// Path M: grid = units x cluster blocks, a cluster a unit; block `rank` holds
// pixels rank * chunk .. + chunk - 1 of its unit in shared memory, each
// thread copying its own rows (cp.async) and reading back only those. A
// row's channel vectors take `lanes` adjacent threads (a power of 2, the
// spare ones idle), so the threads of one channel vector in a warp are the
// lanes apart by `lanes`: a shuffle tree adds their rows, one table a warp
// holds the sums, and a group's threads add the warps' channels.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_cluster_nhwc(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
                const float* __restrict__ beta, const T* __restrict__ add, int chunk, GeomN g,
                float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ float wsum[2][kWarps][kMaxTileM];
  __shared__ float part[2][kMaxTileGroups];
  __shared__ Stats stats[kMaxTileGroups];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const long long unit = blockIdx.x / ranks;
  const int tiles = g.tiles(), groups = g.groups();
  const long long b = unit / tiles;
  const int c0 = static_cast<int>(unit % tiles) * g.tile;
  const int vectors = g.tile / VEC, lanes = row_lanes(vectors);
  const int rows = kThreads / lanes;
  const int cv = threadIdx.x % lanes, row = threadIdx.x / lanes, cl = cv * VEC;
  const bool on = cv < vectors;
  const int p0 = rank * chunk;
  const int n = max(0, min(chunk, g.hw - p0));  // this block's pixels
  const T* src = x + (b * g.hw + p0) * g.channels + c0 + cl;

  if (on) {
    for (int r = row; r < n; r += rows) {
      if constexpr (VEC > 1) {
        cp_async16(xs + r * g.tile + cl, src + static_cast<long long>(r) * g.channels);
      } else {
        xs[r * g.tile + cl] = src[static_cast<long long>(r) * g.channels];
      }
    }
  }
  if constexpr (VEC > 1) cp_async_wait_all();

  float s1[VEC] = {}, s2[VEC] = {};
  if (on) {
    Lane<T, VEC> ln;
    ln.load_add(add, b * g.channels + c0 + cl);
    for (int r = row; r < n; r += rows) {
      Pack<T, VEC>* at = reinterpret_cast<Pack<T, VEC>*>(xs + r * g.tile + cl);
      Pack<T, VEC> p = *at;
      accumulate<T, VEC>(p, ln.a, add != nullptr, s1, s2);
      if (add) *at = p;
    }
  }
  fold_groups<VEC>(s1, s2, wsum, part, lanes, on, cl, g);
  const float count = static_cast<float>(g.hw) * g.cpg;
  if (ranks > 1) cluster.sync();  // every rank's sums are written
  if (threadIdx.x < groups) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < ranks; ++r) {  // rank order: the same sum on every rank
      const float(*pr)[kMaxTileGroups] = ranks > 1 ? cluster.map_shared_rank(part, r) : part;
      a += pr[0][threadIdx.x];
      q += pr[1][threadIdx.x];
    }
    stats[threadIdx.x] = finish(a, q, count, eps);
  }
  // no rank leaves while another reads its sums
  if (ranks > 1) cluster.sync(); else __syncthreads();

  if (on) {
    float mean[VEC], mul[VEC], shift[VEC];
    channel_affine<VEC>(stats, gamma, beta, c0, cl, g, mean, mul, shift);
    T* dst = y + (b * g.hw + p0) * g.channels + c0 + cl;
    for (int r = row; r < n; r += rows) {
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xs + r * g.tile + cl);
      *reinterpret_cast<Pack<T, VEC>*>(dst + static_cast<long long>(r) * g.channels) =
          normalise_pack<T, VEC>(p, mean, mul, shift, silu);
    }
  }
}

// Path L, pass 1: grid = units x splits blocks in clusters of `ranks`; block
// s streams pixels s * chunk .. + chunk - 1 of its unit. The cluster's rank 0
// writes the cluster's group sums, added in rank order, to
// partial[unit][s / ranks][2][groups].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_partial_stats_nhwc(const T* __restrict__ x, const T* __restrict__ add,
                      float* __restrict__ partial, int splits, int chunk, GeomN g) {
  __shared__ float red[kThreads * VEC];
  __shared__ float part[2][kMaxTileGroups];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const long long unit = blockIdx.x / splits;
  const int split = static_cast<int>(blockIdx.x % splits);
  const int tiles = g.tiles(), groups = g.groups();
  const long long b = unit / tiles;
  const int c0 = static_cast<int>(unit % tiles) * g.tile;
  const int vectors = g.tile / VEC, rows = kThreads / vectors, active = rows * vectors;
  const int cv = threadIdx.x % vectors, row = threadIdx.x / vectors, cl = cv * VEC;
  const long long p0 = static_cast<long long>(split) * chunk;
  const int n = static_cast<int>(max(0LL, min(static_cast<long long>(chunk), g.hw - p0)));
  const T* src = x + (b * g.hw + p0) * g.channels + c0 + cl;

  Lane<T, VEC> ln;
  ln.load_add(add, b * g.channels + c0 + cl);
  float s1[VEC] = {}, s2[VEC] = {};
  if (threadIdx.x < active) {
#pragma unroll 4
    for (int r = row; r < n; r += rows) {
      Pack<T, VEC> p =
          *reinterpret_cast<const Pack<T, VEC>*>(src + static_cast<long long>(r) * g.channels);
      accumulate<T, VEC>(p, ln.a, add != nullptr, s1, s2);
    }
  }
  fold_rows<VEC>(s1, red, part[0], active, rows, g);
  fold_rows<VEC>(s2, red, part[1], active, rows, g);
  if (ranks > 1) cluster.sync();  // every rank's sums are written
  if (rank == 0 && threadIdx.x < 2 * groups) {
    const int k = threadIdx.x / groups, grp = threadIdx.x % groups;
    float acc = 0.f;
    for (int r = 0; r < ranks; ++r)  // rank order
      acc += (ranks > 1 ? cluster.map_shared_rank(part, r) : part)[k][grp];
    partial[((unit * (splits / ranks) + split / ranks) * 2 + k) * groups + grp] = acc;
  }
  if (ranks > 1) cluster.sync();  // no rank leaves while rank 0 reads its sums
}

// Path L, pass 2: grid = units x applies blocks; block a normalises pixels
// a * chunk .. + chunk - 1 of its unit after folding the unit's `parts`
// partials, in order. The blocks run the units' pixels from the last: the
// stats pass read those last, so the first apply blocks find them in L2.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_apply_nhwc(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
              const float* __restrict__ beta, const T* __restrict__ add,
              const float* __restrict__ partial, int parts, int applies, int chunk, GeomN g,
              float eps, int silu) {
  __shared__ Stats stats[kMaxTileGroups];
  const long long block = gridDim.x - 1 - blockIdx.x;
  const long long unit = block / applies;
  const int tiles = g.tiles(), groups = g.groups();
  const long long b = unit / tiles;
  const int c0 = static_cast<int>(unit % tiles) * g.tile;
  {
    // a group's threads: an aligned warp segment, each summing every
    // per-th part from its own, then a shuffle tree
    int per = 32;
    while (per * groups > kThreads) per >>= 1;
    const int grp = threadIdx.x / per, lane = threadIdx.x % per;
    float a = 0.f, q = 0.f;
    if (grp < groups) {
      const float* pu = partial + unit * parts * 2 * groups;
      for (int k = lane; k < parts; k += per) {
        a += pu[(k * 2) * groups + grp];
        q += pu[(k * 2 + 1) * groups + grp];
      }
    }
    for (int o = per >> 1; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (grp < groups && lane == 0)
      stats[grp] = finish(a, q, static_cast<float>(g.hw) * g.cpg, eps);
  }
  __syncthreads();
  const int vectors = g.tile / VEC, rows = kThreads / vectors, active = rows * vectors;
  if (threadIdx.x >= active) return;
  const int cv = threadIdx.x % vectors, row = threadIdx.x / vectors, cl = cv * VEC;
  const long long p0 = (block % applies) * chunk;
  const int n = static_cast<int>(max(0LL, min(static_cast<long long>(chunk), g.hw - p0)));
  const long long base = (b * g.hw + p0) * g.channels + c0 + cl;
  Lane<T, VEC> ln;
  ln.load_add(add, b * g.channels + c0 + cl);
  float mean[VEC], mul[VEC], shift[VEC];
  channel_affine<VEC>(stats, gamma, beta, c0, cl, g, mean, mul, shift);
#pragma unroll 4
  for (int r = row; r < n; r += rows) {
    const long long at = base + static_cast<long long>(r) * g.channels;
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(x + at);
    if (add) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        p.v[e] = from_float<T>(add_rounded<T>(to_float(p.v[e]), ln.a[e]));
    }
    *reinterpret_cast<Pack<T, VEC>*>(y + at) = normalise_pack<T, VEC>(p, mean, mul, shift, silu);
  }
}

struct ArgsN {
  const void *x, *gamma, *beta, *add;
  void *y, *partial;
  long long batch;
  GeomN g;
  int cluster;  // M: blocks a unit; L: stats blocks a cluster
  int splits;   // L: stats blocks a unit
  int chunk;    // M: pixels a block; L: pixels a stats block
  int apply;    // L: pixels an apply block
  float eps;
  int silu;
  cudaStream_t stream;
};

// The kernel's attributes, set once per device (and again for more shared
// memory): the attribute call on every launch would cost host time that the
// sampler's hundreds of launches a step cannot spare. Clusters of up to 16
// blocks need the non-portable size allowed.
template <typename K>
cudaError_t raise_smem(K kernel, size_t smem, size_t* raised) {
  constexpr int kMaxDevices = 64;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && raised[dev] >= smem + 1) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = smem + 1;
  return err;
}

template <typename K, typename... A>
cudaError_t launch_clustered(K kernel, unsigned int blocks, int cluster, size_t smem,
                             cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int VEC>
int launch_nhwc(int path, const ArgsN& a) {
  const long long units = a.batch * a.g.tiles();
  const T* x = static_cast<const T*>(a.x);
  const T* add = static_cast<const T*>(a.add);
  if (path == kCluster) {
    auto kernel = gn_cluster_nhwc<T, VEC>;
    static size_t raised[64] = {};
    const size_t smem = static_cast<size_t>(a.chunk) * a.g.tile * sizeof(T);
    cudaError_t err = raise_smem(kernel, smem, raised);
    if (err != cudaSuccess) return err;
    return launch_clustered(kernel, static_cast<unsigned int>(units * a.cluster), a.cluster,
                            smem, a.stream, x, static_cast<T*>(a.y),
                            static_cast<const float*>(a.gamma),
                            static_cast<const float*>(a.beta), add, a.chunk, a.g, a.eps,
                            a.silu);
  }
  auto stats = gn_partial_stats_nhwc<T, VEC>;
  static size_t raised[64] = {};
  cudaError_t err = raise_smem(stats, 0, raised);
  if (err != cudaSuccess) return err;
  err = launch_clustered(stats, static_cast<unsigned int>(units * a.splits), a.cluster, 0,
                         a.stream, x, add, static_cast<float*>(a.partial), a.splits, a.chunk,
                         a.g);
  if (err != cudaSuccess) return err;
  const int applies = static_cast<int>((a.g.hw + a.apply - 1) / a.apply);
  gn_apply_nhwc<T, VEC><<<static_cast<unsigned int>(units * applies), kThreads, 0,
                          a.stream>>>(
      x, static_cast<T*>(a.y), static_cast<const float*>(a.gamma),
      static_cast<const float*>(a.beta), add, static_cast<const float*>(a.partial),
      a.splits / a.cluster, applies, a.apply, a.g, a.eps, a.silu);
  return cudaGetLastError();
}

template <typename T>
int dispatch_nhwc(int path, int vec, const ArgsN& a) {
  constexpr int kVec = 16 / sizeof(T);
  const GeomN& g = a.g;
  if (vec != 1 && vec != kVec) return cudaErrorInvalidValue;
  if (g.tile <= 0 || g.channels % g.tile || g.tile % g.cpg || g.tile % vec ||
      g.tile / vec > kThreads || g.tile / g.cpg > kMaxTileGroups || a.cluster < 1 ||
      a.cluster > kMaxCluster || a.chunk <= 0)
    return cudaErrorInvalidValue;
  if (vec == kVec && (reinterpret_cast<uintptr_t>(a.x) % 16 ||
                      reinterpret_cast<uintptr_t>(a.y) % 16))
    return cudaErrorMisalignedAddress;
  if (path == kCluster) {
    if (g.tile > kMaxTileM || g.tile / vec > 32 ||
        static_cast<long long>(a.chunk) * a.cluster < g.hw ||
        static_cast<size_t>(a.chunk) * g.tile * sizeof(T) > 200 * 1024)
      return cudaErrorInvalidValue;
  } else if (path == kLarge) {
    if (a.splits % a.cluster || static_cast<long long>(a.chunk) * a.splits < g.hw ||
        a.apply <= 0)
      return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  return vec == 1 ? launch_nhwc<T, 1>(path, a) : launch_nhwc<T, kVec>(path, a);
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

// x, y: [batch, hw, channels] contiguous (channels innermost), dtype per
// `dtype`; gamma, beta: [channels] fp32; add: [batch, channels] in x's dtype,
// or null; tile: channels a unit (whole groups, a multiple of vec, dividing
// channels). path 1 (M): `cluster` blocks a unit of `chunk` pixels each;
// path 2 (L): `splits` stats blocks a unit of `chunk` pixels each, in
// clusters of `cluster`, then apply blocks of `apply` pixels; partial: fp32
// scratch of batch * (channels / tile) * (splits / cluster) * 2 * (tile /
// cpg) floats (path L only, else unused). vec: 1 or 16 / sizeof(dtype).
// Launches on `stream`, allocates nothing, returns a cudaError_t.
extern "C" int ccdm_group_norm_nhwc(const void* x, void* y, const void* gamma,
                                    const void* beta, const void* add, void* partial,
                                    int dtype, long long batch, long long channels,
                                    long long hw, int groups, int path, int vec, int tile,
                                    int cluster, int splits, int chunk, int apply, float eps,
                                    int silu, void* stream) {
  if (groups <= 0 || channels % groups != 0 || batch <= 0 || hw <= 0 ||
      hw > 0x7fffffffLL || channels > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  ArgsN a{x, gamma, beta, add, y, partial, batch,
          GeomN{static_cast<int>(hw), static_cast<int>(channels),
                static_cast<int>(channels / groups), tile},
          cluster, splits, chunk, apply, eps, silu, static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch_nhwc<float>(path, vec, a);
  if (dtype == kBFloat16) return dispatch_nhwc<__nv_bfloat16>(path, vec, a);
  return cudaErrorInvalidValue;
}
