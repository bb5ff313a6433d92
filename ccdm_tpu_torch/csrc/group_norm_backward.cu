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
// The slab's sums of u and u * xhat follow from the per-channel sums of g
// and g * xhat (the sum over the group's channels of gamma[c] times them).
//
// Bound: device-memory bandwidth. The least traffic is one read of x, one
// read of dy and one write of dx (plus the [B, C] add and dadd); each
// element costs ~20 flops and one exponential.
//
// Design. The wrapper (ops/group_norm.py::_plan_backward) picks one of three
// paths from the shape, as _plan does for the forward; this file checks what
// it is given.
//   S  gn_backward_small: slabs of at most 512 vectors and 16 channels (the
//      4x8-32x64 levels, the attention pre-norms). A team of 1-8 warps per
//      slab, at most 2 vectors a lane, holds x and dy in
//      registers, so each is read once; lanes cover the flat cpg*H*W run, so
//      none idles at H*W = 32. Per-vector partial sums go to shared memory,
//      where a warp per channel adds the channel's run of vectors. One
//      thread-block cluster per group walks the batch and adds dgamma and
//      dbeta over distributed shared memory, so the call is one launch with
//      no scratch.
//   M  gn_backward_cluster: slabs whose x and dy fit the shared memory of a
//      cluster of 1-8 blocks, at most 16 KB of each a block (the levels of
//      64x128 and up). Blocks of 4 warps and at most 34.5 KB, so 6 share an
//      SM and one block's copies and cluster barriers overlap the others'
//      arithmetic. Each block copies its chunk of x and dy into shared memory
//      with bulk asynchronous copies (cp.async.bulk, completion on an
//      mbarrier; element loads where address or size is not 16-byte aligned);
//      the ranks exchange their (sum v, sum v^2) and per-channel sums over
//      distributed shared memory, a lane per rank, added in one fixed order
//      on every rank. dx is written from shared memory: one read of x and dy,
//      one write of dx.
//   L  gn_backward_stats, gn_backward_sums, gn_backward_dx: larger slabs. The
//      slab is split into chunks, enough for ~4 blocks an SM; the statistics'
//      and then the channel sums' partials go to scratch, and the next launch
//      folds them in a fixed order. Three launches, five reads; the second
//      walks the chunks in reverse so that its first reads hit what the first
//      launch left in L2.
// Inside a block (M, L) the chunk is cut into tiles: the part of one channel
// that one warp covers with 2 vectors a lane. Each warp sums its tiles, a
// warp per channel adds a channel's tiles, and a chunk boundary inside a
// channel is folded across ranks (M) or chunks (L), always in one order.
//
// dgamma and dbeta (M, L): each slab writes its per-(sample, channel) sums to
// scratch; the last block of the launch to finish (an integer completion
// counter that it resets to 0) adds them over the batch in sample order. No
// float atomics and every sum in a fixed order: two runs give the same bits.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace ccdm;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTilePacks = 2;                // vectors a lane covers in one tile
constexpr int kMaxTiles = 128;               // tiles one block's chunk may hold (M, L)
constexpr uint32_t kBulkPiece = 32 * 1024;   // bytes per cp.async.bulk (multiple of 16)
constexpr int kBlocksPerSM = 3;              // L: registers for 3 blocks an SM
constexpr int kClusterThreads = 128;         // M: threads a block
constexpr int kClusterBlocksPerSM = 6;       // M: 6 blocks of at most 34.5 KB share an SM
constexpr int kMaxSmallPacks = 2;            // path S: vectors per lane
constexpr int kMaxSmallChannels = 16;        // path S: channels per group at most

enum Path : int { kSmall = 0, kCluster = 1, kLarge = 2 };

// the sum of (a, b) over the block (at most kWarps warps), returned to every
// thread; each thread adds the warps' partials in warp order, so all get the
// same value
__device__ __forceinline__ float2 block_allreduce2(float a, float b) {
  __shared__ float sa[kWarps], sb[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  for (int w = 0; w < warps; ++w) {
    r.x += sa[w];
    r.y += sb[w];
  }
  __syncthreads();  // no warp writes the next partials before all have read these
  return r;
}

struct Stats {
  float mean, rstd;
};

__device__ __forceinline__ Stats finish(float s1, float s2, float n, float eps) {
  const float mean = s1 / n;
  return {mean, rsqrtf(fmaxf(s2 / n - mean * mean, 0.f) + eps)};
}

// Slab `bg` is sample bg / groups, channels c0 .. c0 + cpg - 1 with
// c0 = (bg % groups) * cpg; `slab` = cpg * hw elements.
struct Geom {
  int slab, hw, cpg, groups, channels, batch;
  __device__ __forceinline__ int sample(long long bg) const {
    return static_cast<int>(bg / groups);
  }
  __device__ __forceinline__ int first_channel(long long bg) const {
    return static_cast<int>(bg % groups) * cpg;
  }
};

template <typename T>
__device__ __forceinline__ float load_v(T raw, float a, bool has_add) {
  const float v = to_float(raw);
  // x + add[c], rounded to T as the forward's unfused add rounds it
  return has_add ? to_float(from_float<T>(v + a)) : v;
}

// dy scaled by silu'(y_pre) when the forward applied SiLU. The sigmoid's
// exponential and divide run on the SFU (__expf, __fdividef: a few ulps,
// far inside the 1e-4 fp32 bound), as the forward's SiLU does: with an IEEE
// divide, computed twice an element, the arithmetic outweighed the bytes.
__device__ __forceinline__ float grad_pre(float dy, float centred, float mul, float shift,
                                          int silu) {
  if (!silu) return dy;
  const float y = centred * mul + shift;
  const float s = __fdividef(1.f, 1.f + __expf(-y));
  return dy * s * (1.f + y * (1.f - s));
}

// Of the `blocks` blocks that write scratch and call this once after their
// writes, the last to get here returns true, on all its threads, after a
// fence that makes the others' writes visible; it must reset the counter.
__device__ __forceinline__ bool last_block(unsigned int* counter, unsigned int blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == blocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// dgamma[c] = sum_b partial_w[b, c], dbeta likewise, in sample order (8
// samples' loads in flight at a time); then the counter back to 0 for the
// next launch
__device__ void fold_params(const float* partial_w, const float* partial_b, float* dgamma,
                            float* dbeta, unsigned int* counter, const Geom& g) {
  constexpr int kAhead = 8;
  for (int c = threadIdx.x; c < g.channels; c += blockDim.x) {
    float w = 0.f, bsum = 0.f;
    for (int b0 = 0; b0 < g.batch; b0 += kAhead) {
      float pw[kAhead], pb[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const long long at = static_cast<long long>(b0 + j) * g.channels + c;
        pw[j] = b0 + j < g.batch ? __ldcg(partial_w + at) : 0.f;
        pb[j] = b0 + j < g.batch ? __ldcg(partial_b + at) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        w += pw[j];
        bsum += pb[j];
      }
    }
    dgamma[c] = w;
    dbeta[c] = bsum;
  }
  if (threadIdx.x == 0) atomicExch(counter, 0u);
}

// ---- path S: a team of warps per slab, x and dy in registers ---------------

// One cluster of `ranks` blocks per group: block `rank` holds 8 / team slabs
// at a time, one per team of `team` warps, and walks the group's samples
// b = (k * ranks + rank) * (8 / team) + t. Each lane holds NPACK vectors of x
// and dy. Per-vector partial sums go to shared memory, where a warp per
// channel adds the channel's run of vectors; the per-channel sums of g * xhat
// and g are then added over the block's samples in (k, t) order and over the
// cluster in rank order over distributed shared memory: dgamma and dbeta are
// written here, with no scratch and no second pass.
template <typename T, int VEC, int NPACK>
__global__ void __launch_bounds__(kThreads)
gn_backward_small(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const T* __restrict__ add, T* __restrict__ dx, T* __restrict__ dadd,
                  float* __restrict__ dgamma, float* __restrict__ dbeta, int team, Geom g,
                  float eps, int silu) {
  __shared__ float red[kWarps][2];                         // per warp: sum v, sum v^2
  __shared__ float2 vecs[kThreads * NPACK];                // per vector of each team
  __shared__ float2 ctot[kWarps][kMaxSmallChannels];       // per team and channel
  __shared__ float2 acc[kWarps][kMaxSmallChannels];        // per team: over its samples
  __shared__ float2 total[kMaxSmallChannels];              // the block's, read by rank 0

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int teams = kWarps / team, t = warp / team, w0 = t * team;
  const int q = (warp - w0) * 32 + lane;  // the lane's place in its team
  float2* tv = vecs + t * team * 32 * NPACK;  // the team's vectors, in slab order
  const int per_channel = g.hw / VEC;         // vectors a channel
  const int group = static_cast<int>(blockIdx.x / ranks), c0 = group * g.cpg;
  const float n = static_cast<float>(g.slab);
  for (int i = threadIdx.x; i < kWarps * kMaxSmallChannels; i += kThreads)
    (&acc[0][0])[i] = make_float2(0.f, 0.f);

  // a warp per channel of the team's slab: the sum of the channel's vectors
  auto fold_channels = [&](bool both) {
    for (int cl = warp - w0; cl < g.cpg; cl += team) {
      float a = 0.f, b = 0.f;
      for (int p = cl * per_channel + lane; p < (cl + 1) * per_channel; p += 32) {
        a += tv[p].x;
        if (both) b += tv[p].y;
      }
      a = warp_sum(a);
      if (both) b = warp_sum(b);
      if (lane == 0) ctot[t][cl] = make_float2(a, b);
    }
  };

  const int per_pass = ranks * teams;
  for (int k = 0; k * per_pass < g.batch; ++k) {
    const int b = (k * ranks + rank) * teams + t;
    const bool valid = b < g.batch;
    const long long base = (static_cast<long long>(b) * g.groups + group) * g.slab;
    const long long row = static_cast<long long>(b) * g.channels + c0;
    const T* ab = add && valid ? add + row : nullptr;
    Pack<T, VEC> px[NPACK], pg[NPACK];
    int ch[NPACK];  // the pack's channel in the group, -1 past the slab
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NPACK; ++j) {
      const int i = (j * team * 32 + q) * VEC;
      // hw % VEC == 0, so a pack never straddles two channels
      ch[j] = valid && i < g.slab ? i / g.hw : -1;
      if (ch[j] >= 0) {
        px[j] = *reinterpret_cast<const Pack<T, VEC>*>(x + base + i);
        pg[j] = *reinterpret_cast<const Pack<T, VEC>*>(dy + base + i);
        const float a = ab ? to_float(ab[ch[j]]) : 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = load_v<T>(px[j].v[e], a, ab != nullptr);
          if (ab) px[j].v[e] = from_float<T>(v);  // exact: v is already rounded to T
          s1 += v;
          s2 += v * v;
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[warp][0] = s1;
      red[warp][1] = s2;
    }
    __syncthreads();
    s1 = s2 = 0.f;
    for (int w = w0; w < w0 + team; ++w) {  // the team's warps in order
      s1 += red[w][0];
      s2 += red[w][1];
    }
    const Stats st = finish(s1, s2, n, eps);

    // per vector: sum g * xhat and g
#pragma unroll
    for (int j = 0; j < NPACK; ++j) {
      if (ch[j] >= 0) {
        const int c = c0 + ch[j];
        const float mul = st.rstd * gamma[c], shift = beta[c];
        float sw = 0.f, sb = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float centred = to_float(px[j].v[e]) - st.mean;
          const float gv = grad_pre(to_float(pg[j].v[e]), centred, mul, shift, silu);
          sw += gv * centred;
          sb += gv;
        }
        tv[j * team * 32 + q] = make_float2(sw * st.rstd, sb);
      }
    }
    __syncthreads();
    fold_channels(true);
    __syncthreads();
    // every warp: a lane per channel, the slab's sums of u and u * xhat
    float sum_u = 0.f, sum_ux = 0.f;
    if (lane < g.cpg) {
      const float2 c = ctot[t][lane];
      const float gw = gamma[c0 + lane];
      sum_u = gw * c.y;
      sum_ux = gw * c.x;
      if (valid && warp == w0) {  // the team's running sums over its samples
        acc[t][lane].x += c.x;
        acc[t][lane].y += c.y;
      }
    }
    const float m1 = warp_sum(sum_u) / n, m2 = warp_sum(sum_ux) / n;

#pragma unroll
    for (int j = 0; j < NPACK; ++j) {
      if (ch[j] >= 0) {
        const int c = c0 + ch[j];
        const float gw = gamma[c], mul = st.rstd * gw, shift = beta[c];
        // dv = rstd * (g * w - m1 - xhat * m2) = g * dw + centred * dc + d0
        const float dw = st.rstd * gw, dc = -st.rstd * st.rstd * m2, d0 = -st.rstd * m1;
        Pack<T, VEC> o;
        float sd = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float centred = to_float(px[j].v[e]) - st.mean;
          const float gv = grad_pre(to_float(pg[j].v[e]), centred, mul, shift, silu);
          const float d = fmaf(gv, dw, fmaf(centred, dc, d0));
          sd += d;
          o.v[e] = from_float<T>(d);
        }
        *reinterpret_cast<Pack<T, VEC>*>(dx + base + (j * team * 32 + q) * VEC) = o;
        if (add) tv[j * team * 32 + q].x = sd;  // the folds above have read tv
      }
    }
    if (add) {  // dadd[b, c]: the channel's vectors, by a warp per channel
      __syncthreads();
      fold_channels(false);
      __syncthreads();
      if (valid && warp == w0 && lane < g.cpg) dadd[row + lane] = from_float<T>(ctot[t][lane].x);
    }
    // the next samples' first __syncthreads comes after every read of red,
    // vecs and ctot above; so does the one below
  }
  __syncthreads();

  // dgamma and dbeta: the block's teams in order, then the ranks in order
  for (int cl = threadIdx.x; cl < g.cpg; cl += kThreads) {
    float2 s = make_float2(0.f, 0.f);
    for (int tt = 0; tt < teams; ++tt) {
      s.x += acc[tt][cl].x;
      s.y += acc[tt][cl].y;
    }
    total[cl] = s;
  }
  cluster.sync();
  if (rank == 0) {
    for (int cl = threadIdx.x; cl < g.cpg; cl += kThreads) {
      float sw = 0.f, sb = 0.f;
      for (int r = 0; r < ranks; ++r) {
        const float2 tr = cluster.map_shared_rank(total, r)[cl];
        sw += tr.x;
        sb += tr.y;
      }
      dgamma[c0 + cl] = sw;
      dbeta[c0 + cl] = sb;
    }
  }
  cluster.sync();  // no rank leaves while rank 0 reads its shared memory
}

// ---- tiles: a chunk [begin, end) of a slab, cut at channel starts ----------

// Tile k (counted from the slab's start) is channel k / per, elements
// [t * len, (t + 1) * len) of it, t = k % per, cut to the channel and the
// chunk. len = kTilePacks * 32 * VEC: one warp, 2 vectors a lane.
struct Tiles {
  int begin, end, hw, len, per, first, count;
  __device__ Tiles(int begin_, int end_, int hw_, int len_)
      : begin(begin_), end(end_), hw(hw_), len(len_), per((hw_ + len_ - 1) / len_) {
    first = id(begin);
    count = end > begin ? id(end - 1) - first + 1 : 0;
  }
  __device__ __forceinline__ int id(int pos) const { return pos / hw * per + pos % hw / len; }
  __device__ __forceinline__ int channel(int k) const { return k / per; }
  __device__ __forceinline__ int2 range(int k) const {
    const int cl = k / per, lo = cl * hw + k % per * len;
    return make_int2(max(lo, begin), min(min(lo + len, (cl + 1) * hw), end));
  }
  // the chunk's channels: first_channel() .. first_channel() + channels() - 1
  __device__ __forceinline__ int first_channel() const { return begin / hw; }
  __device__ __forceinline__ int channels() const {
    return count ? (end - 1) / hw - begin / hw + 1 : 0;
  }
  // the chunk's tiles of its local channel k: [x, y)
  __device__ __forceinline__ int2 of_channel(int k) const {
    const int cl = first_channel() + k;
    return make_int2(max(first, cl * per) - first, min(first + count, (cl + 1) * per) - first);
  }
};

// The per-tile work of one warp: elements [r.x, r.y) of the slab, read from
// xs / gs at an offset of -`origin` (shared memory for M, the slab for L).
template <typename T, int VEC>
struct TileIO {
  const T* xs;
  const T* gs;
  int origin;
  __device__ __forceinline__ void load(int2 r, Pack<T, VEC> (&px)[kTilePacks],
                                       Pack<T, VEC> (&pg)[kTilePacks], bool with_dy) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int u = 0; u < kTilePacks; ++u) {
      const int i = r.x + (u * 32 + lane) * VEC;
      if (i < r.y) {
        px[u] = *reinterpret_cast<const Pack<T, VEC>*>(xs + (i - origin));
        if (with_dy) pg[u] = *reinterpret_cast<const Pack<T, VEC>*>(gs + (i - origin));
      }
    }
  }
};

// sum v and v^2 over the chunk's tiles, over the block (every thread gets
// it); with `keep` (path M's shared copy of x) v = x + add, rounded to T,
// is written back over x, so that the later passes read v as it is
template <typename T, int VEC>
__device__ float2 chunk_stats(const Tiles& tl, const TileIO<T, VEC>& io, const T* ab,
                              T* keep) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s1 = 0.f, s2 = 0.f;
  for (int k = tl.first + warp; k < tl.first + tl.count; k += blockDim.x >> 5) {
    const int2 r = tl.range(k);
    const float a = ab ? to_float(ab[tl.channel(k)]) : 0.f;
    Pack<T, VEC> px[kTilePacks], pg[kTilePacks];
    io.load(r, px, pg, false);
#pragma unroll
    for (int u = 0; u < kTilePacks; ++u) {
      if (r.x + (u * 32 + lane) * VEC < r.y) {
        const int i = r.x + (u * 32 + lane) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = load_v<T>(px[u].v[e], a, ab != nullptr);
          if (ab) px[u].v[e] = from_float<T>(v);  // exact: v is already rounded to T
          s1 += v;
          s2 += v * v;
        }
        if (keep && ab) *reinterpret_cast<Pack<T, VEC>*>(keep + (i - io.origin)) = px[u];
      }
    }
  }
  return block_allreduce2(s1, s2);
}

// per tile, sum g * xhat into tw and g into tb. SILU and ADD are
// compile-time copies of `silu` and of whether v = x + add must still be
// formed from x (L; M wrote v over its copy of x): the per-element
// arithmetic is what sets this kernel's time, and no test of either is left
// inside its loops.
template <typename T, int VEC, bool SILU, bool ADD>
__device__ void tile_sums_of(const Tiles& tl, const TileIO<T, VEC>& io, const T* ab,
                             const float* gamma, const float* beta, int c0, Stats st,
                             float* tw, float* tb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = tl.first + warp; k < tl.first + tl.count; k += blockDim.x >> 5) {
    const int2 r = tl.range(k);
    const int cl = tl.channel(k);
    const float a = ADD ? to_float(ab[cl]) : 0.f;
    const float mul = st.rstd * gamma[c0 + cl], shift = beta[c0 + cl];
    Pack<T, VEC> px[kTilePacks], pg[kTilePacks];
    io.load(r, px, pg, true);
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int u = 0; u < kTilePacks; ++u) {
      if (r.x + (u * 32 + lane) * VEC < r.y) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float centred = load_v<T>(px[u].v[e], a, ADD) - st.mean;
          const float gv = grad_pre(to_float(pg[u].v[e]), centred, mul, shift, SILU);
          sw += gv * centred;
          sb += gv;
        }
      }
    }
    sw = warp_sum(sw) * st.rstd;
    sb = warp_sum(sb);
    if (lane == 0) {
      tw[k - tl.first] = sw;
      tb[k - tl.first] = sb;
    }
  }
}

template <typename T, int VEC>
__device__ void tile_sums(const Tiles& tl, const TileIO<T, VEC>& io, const T* ab,
                          const float* gamma, const float* beta, int c0, Stats st, int silu,
                          float* tw, float* tb) {
  if (silu && ab)
    tile_sums_of<T, VEC, true, true>(tl, io, ab, gamma, beta, c0, st, tw, tb);
  else if (silu)
    tile_sums_of<T, VEC, true, false>(tl, io, ab, gamma, beta, c0, st, tw, tb);
  else if (ab)
    tile_sums_of<T, VEC, false, true>(tl, io, ab, gamma, beta, c0, st, tw, tb);
  else
    tile_sums_of<T, VEC, false, false>(tl, io, ab, gamma, beta, c0, st, tw, tb);
}

// dx over the chunk's tiles, written to the slab `dxb`; with SUM, the sum of
// dv per tile into td (the add's gradient). SILU and ADD as in tile_sums_of.
template <typename T, int VEC, bool SILU, bool ADD, bool SUM>
__device__ void tile_dx_of(const Tiles& tl, const TileIO<T, VEC>& io, const T* ab,
                           const float* gamma, const float* beta, int c0, Stats st, float m1,
                           float m2, T* dxb, float* td) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = tl.first + warp; k < tl.first + tl.count; k += blockDim.x >> 5) {
    const int2 r = tl.range(k);
    const int cl = tl.channel(k);
    const float a = ADD ? to_float(ab[cl]) : 0.f;
    const float w = gamma[c0 + cl], mul = st.rstd * w, shift = beta[c0 + cl];
    // dv = rstd * (g * w - m1 - xhat * m2) = g * dw + centred * dc + d0
    const float dw = st.rstd * w, dc = -st.rstd * st.rstd * m2, d0 = -st.rstd * m1;
    Pack<T, VEC> px[kTilePacks], pg[kTilePacks];
    io.load(r, px, pg, true);
    float sd = 0.f;
#pragma unroll
    for (int u = 0; u < kTilePacks; ++u) {
      const int i = r.x + (u * 32 + lane) * VEC;
      if (i < r.y) {
        Pack<T, VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float centred = load_v<T>(px[u].v[e], a, ADD) - st.mean;
          const float gv = grad_pre(to_float(pg[u].v[e]), centred, mul, shift, SILU);
          const float d = fmaf(gv, dw, fmaf(centred, dc, d0));
          if (SUM) sd += d;
          o.v[e] = from_float<T>(d);
        }
        *reinterpret_cast<Pack<T, VEC>*>(dxb + i) = o;
      }
    }
    if (SUM) {
      sd = warp_sum(sd);
      if (lane == 0) td[k - tl.first] = sd;
    }
  }
}

template <typename T, int VEC>
__device__ void tile_dx(const Tiles& tl, const TileIO<T, VEC>& io, const T* ab,
                        const float* gamma, const float* beta, int c0, Stats st, float m1,
                        float m2, int silu, T* dxb, float* td, bool sum) {
#define CCDM_TILE_DX(SILU, ADD, SUM) \
  tile_dx_of<T, VEC, SILU, ADD, SUM>(tl, io, ab, gamma, beta, c0, st, m1, m2, dxb, td)
  if (silu) {
    if (ab) CCDM_TILE_DX(true, true, true);
    else if (sum) CCDM_TILE_DX(true, false, true);
    else CCDM_TILE_DX(true, false, false);
  } else {
    if (ab) CCDM_TILE_DX(false, true, true);
    else if (sum) CCDM_TILE_DX(false, false, true);
    else CCDM_TILE_DX(false, false, false);
  }
#undef CCDM_TILE_DX
}

// the chunk's per-channel sums of the tile sums ta (and tb, where given)
// into oa (and ob) at a stride: a warp per local channel, its lanes over the
// channel's tiles (after a __syncthreads that follows the tile writes)
__device__ __forceinline__ void fold_tiles(const Tiles& tl, const float* ta, const float* tb,
                                           float* oa, float* ob, int stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < tl.channels(); k += blockDim.x >> 5) {
    const int2 span = tl.of_channel(k);
    float a = 0.f, b = 0.f;
    for (int j = span.x + lane; j < span.y; j += 32) {
      a += ta[j];
      if (tb) b += tb[j];
    }
    a = warp_sum(a);
    if (tb) b = warp_sum(b);
    if (lane == 0) {
      oa[k * stride] = a;
      if (ob) ob[k * stride] = b;
    }
  }
}

// ---- path M: one cluster per slab, x and dy in shared memory --------------

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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  const char* from = static_cast<const char*>(src);
  for (uint32_t off = 0; off < bytes; off += kBulkPiece)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst) + off),
        "l"(from + off), "r"(min(kBulkPiece, bytes - off)), "r"(bar)
        : "memory");
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// One cluster of `ranks` blocks of kClusterThreads per slab. Each block
// copies its chunk of x and dy into shared memory, with cp.async.bulk (BULK:
// 16-byte aligned address and size) or element loads; small blocks, so
// that 6 share an SM and one's copies and barriers overlap the others' work.
template <typename T, int VEC, bool BULK>
__global__ void __launch_bounds__(kClusterThreads, kClusterBlocksPerSM)
gn_backward_cluster(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const T* __restrict__ add, T* __restrict__ dx, T* __restrict__ dadd,
                    float* __restrict__ partial_w, float* __restrict__ partial_b,
                    unsigned int* __restrict__ counter, float* __restrict__ dgamma,
                    float* __restrict__ dbeta, int chunk, Geom g, float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t stride = align16(static_cast<size_t>(chunk) * sizeof(T));
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* gs = reinterpret_cast<T*>(smem_raw + stride);
  __shared__ __align__(8) unsigned long long bar;
  __shared__ float tw[kMaxTiles], tb[kMaxTiles];
  __shared__ float cw[kMaxTiles], cb[kMaxTiles], cd[kMaxTiles];  // per local channel
  __shared__ float part[2];
  __shared__ Stats stats;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bg = blockIdx.x / ranks;
  const int begin = rank * chunk;
  const int n = max(0, min(chunk, g.slab - begin));
  const long long base = bg * g.slab;

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
                   "r"(2 * bytes)
                   : "memory");
      bulk_copy(xs, x + base + begin, bytes, b);
      bulk_copy(gs, dy + base + begin, bytes, b);
    }
    mbar_wait(b, 0);
  } else {
    for (int i = threadIdx.x; i < n; i += kClusterThreads) {
      xs[i] = x[base + begin + i];
      gs[i] = dy[base + begin + i];
    }
    __syncthreads();
  }

  const int b = g.sample(bg), c0 = g.first_channel(bg);
  const long long row = static_cast<long long>(b) * g.channels + c0;
  const T* ab = add ? add + row : nullptr;
  const Tiles tl(begin, begin + n, g.hw, kTilePacks * 32 * VEC);
  const TileIO<T, VEC> io{xs, gs, begin};
  const float nf = static_cast<float>(g.slab);
  // the ranks that hold part of channel cl: first_rank(cl) .. last_rank(cl)
  auto first_rank = [&](int cl) { return cl * g.hw / chunk; };
  auto last_rank = [&](int cl) { return min(ranks - 1, ((cl + 1) * g.hw - 1) / chunk); };

  // 1: the statistics; every rank adds the ranks' partials in one fixed order
  const float2 s = chunk_stats<T, VEC>(tl, io, ab, xs);
  if (threadIdx.x == 0) {
    part[0] = s.x;
    part[1] = s.y;
  }
  cluster.sync();
  if (warp == 0) {
    float a = 0.f, q = 0.f;
    if (lane < ranks) {
      const float* pr = cluster.map_shared_rank(part, lane);
      a = pr[0];
      q = pr[1];
    }
    a = warp_sum(a);
    q = warp_sum(q);
    if (lane == 0) stats = finish(a, q, nf, eps);
  }
  __syncthreads();
  const Stats st = stats;

  // 2: per channel, sum g * xhat and g: per tile, per local channel, then a
  // warp per channel of the slab adds the ranks that hold part of it. Every
  // rank forms the slab's sums of u and u * xhat in the same order.
  tile_sums<T, VEC>(tl, io, nullptr, gamma, beta, c0, st, silu, tw, tb);  // xs holds v
  __syncthreads();
  fold_tiles(tl, tw, tb, cw, cb, 1);
  cluster.sync();
  float su = 0.f, sux = 0.f;
  for (int cl = warp; cl < g.cpg; cl += kClusterThreads / 32) {
    const int r = first_rank(cl) + lane;
    float w = 0.f, bs = 0.f;
    if (r <= last_rank(cl)) {
      const int k = cl - r * chunk / g.hw;
      w = cluster.map_shared_rank(cw, r)[k];
      bs = cluster.map_shared_rank(cb, r)[k];
    }
    w = warp_sum(w);
    bs = warp_sum(bs);
    if (rank == 0 && lane == 0) {
      partial_w[row + cl] = w;
      partial_b[row + cl] = bs;
    }
    su += gamma[c0 + cl] * bs;
    sux += gamma[c0 + cl] * w;
  }
  // every lane of a warp holds its sums: count lane 0's
  const float2 m = block_allreduce2(lane == 0 ? su : 0.f, lane == 0 ? sux : 0.f);

  // 3: dx from shared memory; with the add, its per-channel sums
  tile_dx<T, VEC>(tl, io, nullptr, gamma, beta, c0, st, m.x / nf, m.y / nf, silu, dx + base, tw,
                  ab != nullptr);
  if (ab) {
    __syncthreads();
    fold_tiles(tl, tw, nullptr, cd, nullptr, 1);
    cluster.sync();
    if (rank == 0) {
      for (int cl = warp; cl < g.cpg; cl += kClusterThreads / 32) {
        const int r = first_rank(cl) + lane;
        float d = r <= last_rank(cl) ? cluster.map_shared_rank(cd, r)[cl - r * chunk / g.hw]
                                     : 0.f;
        d = warp_sum(d);
        if (lane == 0) dadd[row + cl] = from_float<T>(d);
      }
    }
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
  // only rank 0 writes the partials, so only the rank-0 blocks count
  if (rank == 0 && last_block(counter, static_cast<unsigned int>(gridDim.x / ranks)))
    fold_params(partial_w, partial_b, dgamma, dbeta, counter, g);
}

// ---- path L: partials to scratch, three launches ---------------------------

// Scratch of path L: stats [B*G*splits, 2]; chan [B*G*splits, maxch, 2] (sum g
// * xhat, sum g per local channel of a chunk); dchan [B*G*splits, maxch] (sum
// dv). maxch = ceil(chunk / hw) + 1 bounds the channels a chunk touches.
struct Large {
  float* stats;
  float* chan;
  float* dchan;
  int chunk, splits, maxch;
  __device__ __forceinline__ int begin(int split) const { return split * chunk; }
};

// the slab's mean and rstd from its chunks' partials, in chunk order (the
// same code, so the same bits, in both launches that need them)
__device__ __forceinline__ Stats fold_stats(const Large& L, long long bg, float n, float eps) {
  __shared__ Stats stats;
  if (threadIdx.x < 32) {
    const float* p = L.stats + 2 * bg * L.splits;
    float a = 0.f, q = 0.f;
    for (int j = threadIdx.x; j < L.splits; j += 32) {
      a += p[2 * j];
      q += p[2 * j + 1];
    }
    a = warp_sum(a);
    q = warp_sum(q);
    if (threadIdx.x == 0) stats = finish(a, q, n, eps);
  }
  __syncthreads();
  return stats;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gn_backward_stats(const T* __restrict__ x, const T* __restrict__ add, Large L, Geom g) {
  const long long bg = blockIdx.x / L.splits;
  const int begin = L.begin(blockIdx.x % L.splits);
  const T* ab = add ? add + static_cast<long long>(g.sample(bg)) * g.channels +
                          g.first_channel(bg)
                    : nullptr;
  const Tiles tl(begin, min(begin + L.chunk, g.slab), g.hw, kTilePacks * 32 * VEC);
  const TileIO<T, VEC> io{x + bg * g.slab, nullptr, 0};
  const float2 s = chunk_stats<T, VEC>(tl, io, ab, nullptr);
  if (threadIdx.x == 0) {
    L.stats[2 * blockIdx.x] = s.x;
    L.stats[2 * blockIdx.x + 1] = s.y;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gn_backward_sums(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 const T* __restrict__ add, Large L, Geom g, float eps, int silu) {
  __shared__ float tw[kMaxTiles], tb[kMaxTiles];
  // the chunks in reverse: the first blocks find the stats launch's last reads in L2
  const int blk = gridDim.x - 1 - blockIdx.x;
  const long long bg = blk / L.splits;
  const int begin = L.begin(blk % L.splits);
  const int c0 = g.first_channel(bg);
  const T* ab = add ? add + static_cast<long long>(g.sample(bg)) * g.channels + c0 : nullptr;
  const Stats st = fold_stats(L, bg, static_cast<float>(g.slab), eps);
  const Tiles tl(begin, min(begin + L.chunk, g.slab), g.hw, kTilePacks * 32 * VEC);
  const TileIO<T, VEC> io{x + bg * g.slab, dy + bg * g.slab, 0};
  tile_sums<T, VEC>(tl, io, ab, gamma, beta, c0, st, silu, tw, tb);
  __syncthreads();
  float* out = L.chan + 2LL * blk * L.maxch;
  fold_tiles(tl, tw, tb, out, out + 1, 2);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
gn_backward_dx(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               const T* __restrict__ add, T* __restrict__ dx, T* __restrict__ dadd,
               float* __restrict__ partial_w, float* __restrict__ partial_b,
               unsigned int* __restrict__ counter, float* __restrict__ dgamma,
               float* __restrict__ dbeta, Large L, Geom g, float eps, int silu) {
  __shared__ float td[kMaxTiles];
  const long long bg = blockIdx.x / L.splits;
  const int split = blockIdx.x % L.splits;
  const int begin = L.begin(split);
  const int c0 = g.first_channel(bg);
  const long long row = static_cast<long long>(g.sample(bg)) * g.channels + c0;
  const T* ab = add ? add + row : nullptr;
  const float nf = static_cast<float>(g.slab);
  const Stats st = fold_stats(L, bg, nf, eps);

  // the slab's channel sums: a warp per channel, its lanes over the
  // channel's chunks, added in the same fixed order by every block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float su = 0.f, sux = 0.f;
  for (int cl = warp; cl < g.cpg; cl += kWarps) {
    float w = 0.f, bs = 0.f;
    const int j_end = ((cl + 1) * g.hw - 1) / L.chunk;
    for (int j = cl * g.hw / L.chunk + lane; j <= j_end; j += 32) {
      const float* p = L.chan + 2 * ((bg * L.splits + j) * L.maxch + cl - L.begin(j) / g.hw);
      w += p[0];
      bs += p[1];
    }
    w = warp_sum(w);
    bs = warp_sum(bs);
    if (split == 0 && lane == 0) {
      partial_w[row + cl] = w;
      partial_b[row + cl] = bs;
    }
    su += gamma[c0 + cl] * bs;
    sux += gamma[c0 + cl] * w;
  }
  // each warp's lanes hold the same sums: count one lane of each
  const float2 m = block_allreduce2(lane == 0 ? su : 0.f, lane == 0 ? sux : 0.f);

  const Tiles tl(begin, min(begin + L.chunk, g.slab), g.hw, kTilePacks * 32 * VEC);
  const TileIO<T, VEC> io{x + bg * g.slab, dy + bg * g.slab, 0};
  tile_dx<T, VEC>(tl, io, ab, gamma, beta, c0, st, m.x / nf, m.y / nf, silu, dx + bg * g.slab,
                  td, ab != nullptr);
  if (ab) {
    __syncthreads();
    fold_tiles(tl, td, nullptr, L.dchan + static_cast<long long>(blockIdx.x) * L.maxch,
               nullptr, 1);
  }
  if (last_block(counter, gridDim.x)) {
    if (add) {  // dadd[b, c]: each channel's chunks in chunk order
      const long long total = static_cast<long long>(g.batch) * g.channels;
      for (long long bc = threadIdx.x; bc < total; bc += kThreads) {
        const int c = static_cast<int>(bc % g.channels), cl = c % g.cpg;
        const long long s_bg = bc / g.channels * g.groups + c / g.cpg;
        float d = 0.f;
        const int j_end = ((cl + 1) * g.hw - 1) / L.chunk;
        for (int j = cl * g.hw / L.chunk; j <= j_end; ++j)
          d += __ldcg(L.dchan + (s_bg * L.splits + j) * L.maxch + cl - L.begin(j) / g.hw);
        dadd[bc] = from_float<T>(d);
      }
    }
    fold_params(partial_w, partial_b, dgamma, dbeta, counter, g);
  }
}

// ---- launches ---------------------------------------------------------------

struct Args {
  const void *x, *dy, *gamma, *beta, *add;
  void *dx, *dadd, *dgamma, *dbeta;
  float *partial_w, *partial_b, *large;  // large: path L's scratch after the partials
  unsigned int* counter;
  Geom g;
  int param;  // S: vectors per lane; M: cluster size; L: splits
  int chunk;  // S: warps per slab; M and L: elements per block
  float eps;
  int silu;
  cudaStream_t stream;
};

constexpr int kMaxDevices = 64;

// path M's dynamic shared memory: the chunk of x and of dy
template <typename T>
size_t cluster_smem(int chunk) {
  const size_t stride = align16(static_cast<size_t>(chunk) * sizeof(T));
  return 2 * stride;
}

// cudaLaunchKernelEx with a cluster of `cluster` blocks along x
template <typename Kernel, typename... Params>
cudaError_t launch_clusters(Kernel kernel, unsigned int blocks, int threads, int cluster,
                            size_t smem, cudaStream_t stream, Params... params) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, params...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int VEC, int NPACK>
int launch_small(const Args& a) {
  const int team = a.chunk, per_block = kWarps / team;
  const int ranks = min(8, (a.g.batch + per_block - 1) / per_block);
  return launch_clusters(gn_backward_small<T, VEC, NPACK>,
                         static_cast<unsigned int>(a.g.groups * ranks), kThreads, ranks, 0,
                         a.stream,
                         static_cast<const T*>(a.x), static_cast<const T*>(a.dy),
                         static_cast<const float*>(a.gamma), static_cast<const float*>(a.beta),
                         static_cast<const T*>(a.add), static_cast<T*>(a.dx),
                         static_cast<T*>(a.dadd), static_cast<float*>(a.dgamma),
                         static_cast<float*>(a.dbeta), team, a.g, a.eps, a.silu);
}

template <typename T, int VEC>
int dispatch_small(const Args& a) {
  if (a.chunk != 1 && a.chunk != 2 && a.chunk != 4 && a.chunk != 8) return cudaErrorInvalidValue;
  switch (a.param) {
    case 1: return launch_small<T, VEC, 1>(a);
    case 2: return launch_small<T, VEC, 2>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int VEC>
int launch_cluster(const Args& a) {
  constexpr bool kBulk = VEC > 1;  // VEC > 1 only where address and size are 16-byte aligned
  auto kernel = gn_backward_cluster<T, VEC, kBulk>;
  const size_t smem = cluster_smem<T>(a.chunk);
  // raised once per device and size: the attribute call on every launch
  // costs host time, and the host paces the train step's launches
  static size_t raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised[dev] = smem;
  }
  const long long blocks = static_cast<long long>(a.g.batch) * a.g.groups * a.param;
  return launch_clusters(kernel, static_cast<unsigned int>(blocks), kClusterThreads, a.param,
                         smem, a.stream, static_cast<const T*>(a.x),
                         static_cast<const T*>(a.dy), static_cast<const float*>(a.gamma),
                         static_cast<const float*>(a.beta), static_cast<const T*>(a.add),
                         static_cast<T*>(a.dx), static_cast<T*>(a.dadd), a.partial_w,
                         a.partial_b, a.counter, static_cast<float*>(a.dgamma),
                         static_cast<float*>(a.dbeta), a.chunk, a.g, a.eps, a.silu);
}

template <typename T, int VEC>
int launch_large(const Args& a) {
  const long long n_slabs = static_cast<long long>(a.g.batch) * a.g.groups;
  const long long units = n_slabs * a.param;
  const int maxch = (a.chunk + a.g.hw - 1) / a.g.hw + 1;
  const Large L{a.large, a.large + 2 * units, a.large + 2 * units + 2 * units * maxch, a.chunk,
                a.param, maxch};
  const dim3 blocks(static_cast<unsigned int>(units));
  gn_backward_stats<T, VEC><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.add), L, a.g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_backward_sums<T, VEC><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy),
      static_cast<const float*>(a.gamma), static_cast<const float*>(a.beta),
      static_cast<const T*>(a.add), L, a.g, a.eps, a.silu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_backward_dx<T, VEC><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy),
      static_cast<const float*>(a.gamma), static_cast<const float*>(a.beta),
      static_cast<const T*>(a.add), static_cast<T*>(a.dx), static_cast<T*>(a.dadd),
      a.partial_w, a.partial_b, a.counter, static_cast<float*>(a.dgamma),
      static_cast<float*>(a.dbeta), L, a.g, a.eps, a.silu);
  return cudaGetLastError();
}

// The most tiles a run of `chunk` elements holds, wherever it starts (as
// ops/group_norm.py::_tiles_bound): Tiles cuts each channel into
// ceil(hw / len) tiles, so a run holds at most that many per channel it
// touches, and at most one tile more than its pieces in each channel hold
// at their length.
template <int VEC>
long long tiles_bound(long long chunk, long long hw) {
  constexpr long long len = kTilePacks * 32 * VEC;
  const long long channels = 1 + (chunk - 1 + hw - 1) / hw;
  const long long whole = channels * ((hw + len - 1) / len);
  const long long pieces = (chunk + channels * (len - 1)) / len + 1;
  return whole < pieces ? whole : pieces;
}

template <typename T, int VEC>
int dispatch_path(int path, const Args& a) {
  const long long covered = static_cast<long long>(a.chunk) * a.param;
  if (path == kSmall) {
    if (a.param > kMaxSmallPacks || a.g.cpg > kMaxSmallChannels ||
        static_cast<long long>(a.param) * a.chunk * 32 * VEC < a.g.slab)
      return cudaErrorInvalidValue;
    return dispatch_small<T, VEC>(a);
  }
  if (a.param < 1 || a.chunk <= 0 || covered < a.g.slab || a.chunk % VEC ||
      tiles_bound<VEC>(a.chunk, a.g.hw) > kMaxTiles)
    return cudaErrorInvalidValue;
  if (path == kCluster) {
    if (a.param > 8 || cluster_smem<T>(a.chunk) > 200 * 1024)
      return cudaErrorInvalidValue;
    return launch_cluster<T, VEC>(a);
  }
  if (path == kLarge) return launch_large<T, VEC>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch_vec(int path, int vec, const Args& a) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == 1) return dispatch_path<T, 1>(path, a);
  if (vec != kVec) return cudaErrorInvalidValue;
  // 16-byte vectors need aligned rows that never straddle a channel
  if (reinterpret_cast<uintptr_t>(a.x) % 16 || reinterpret_cast<uintptr_t>(a.dy) % 16 ||
      reinterpret_cast<uintptr_t>(a.dx) % 16 || a.g.hw % kVec)
    return cudaErrorMisalignedAddress;
  return dispatch_path<T, kVec>(path, a);
}

}  // namespace

// x, dy, dx: [batch, channels, hw] contiguous, dtype per `dtype`; gamma, beta,
// dgamma, dbeta: [channels] fp32; add, dadd: [batch, channels] in x's dtype,
// both null or both given. scratch (M, L): fp32, 2 * batch * channels floats,
// and for path L after them B*G*splits * (2 + 3 * maxch) more (see `Large`;
// ops/group_norm.py::_scratch_floats). counter (M, L): one uint32 that is 0
// and that no other launch uses at the same time; the kernel leaves it 0.
// path 0 (S): param = vectors per lane (1 or 2), chunk = warps per slab
//             (1, 2, 4 or 8), at most 16 channels a group;
// path 1 (M): param = cluster size (1-8), chunk = elements per block;
// path 2 (L): param = splits per slab, chunk = elements per block.
// vec: elements per vector access, 1 or 16 / sizeof(dtype).
// Launches on `stream` (S, M: one kernel; L: three), allocates nothing,
// returns a cudaError_t.
extern "C" int ccdm_group_norm_backward(const void* x, const void* dy, const void* gamma,
                                        const void* beta, const void* add, void* dx,
                                        void* dadd, void* scratch, void* counter,
                                        void* dgamma, void* dbeta, int dtype,
                                        long long batch, long long channels, long long hw,
                                        int groups, int path, int vec, int param,
                                        long long chunk, float eps, int silu, void* stream) {
  if (groups <= 0 || channels % groups != 0 || batch <= 0 || hw <= 0 ||
      (add == nullptr) != (dadd == nullptr) || counter == nullptr)
    return cudaErrorInvalidValue;
  if (batch * groups > 0x7fffffffLL || channels > 0x7fffffffLL || batch > 0x7fffffffLL ||
      channels / groups * hw > 0x3fffffffLL || chunk > 0x3fffffffLL || chunk < 0)
    return cudaErrorInvalidValue;
  float* part = static_cast<float*>(scratch);
  const long long bc = batch * channels;
  Args a{x, dy, gamma, beta, add, dx, dadd, dgamma, dbeta, part, part + bc, part + 2 * bc,
         static_cast<unsigned int*>(counter),
         Geom{static_cast<int>(channels / groups * hw), static_cast<int>(hw),
              static_cast<int>(channels / groups), groups, static_cast<int>(channels),
              static_cast<int>(batch)},
         param, static_cast<int>(chunk), eps, silu, static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch_vec<float>(path, vec, a);
  if (dtype == kBFloat16) return dispatch_vec<__nv_bfloat16>(path, vec, a);
  return cudaErrorInvalidValue;
}
