// Self-attention forward, softmax(q k^T / sqrt(dh)) v, without a T x T
// tensor in device memory.
//
// Replaces: ccdm_tpu/ops/flash_attention.py, _attn_kernel (launched by
// _flash_bh, wrapped by flash_attention / _flash_fwd_impl). Numerics follow
// it: logits are fp32 products of the inputs scaled once by 1/sqrt(dh), the
// softmax is fp32, and the normalised probabilities are rounded to v's dtype
// before the product with v, which accumulates in fp32.
//
// Layout: q, k, v are [BH, dh, T] with unit stride along T and any stride
// along dh and BH — the views that the reference's legacy qkv split gives
// (channels ordered (heads, [q|k|v], dh)), read in place. out is [BH, dh, T]
// contiguous. dh is 32 or 64; any T, ragged tails masked.
//
// Bound: at the flagship shapes (T <= 256, dh = 32) each (batch*head) moves
// 4*T*dh elements and needs 4*T^2*dh flops, at most 128 flops per byte in
// bf16, below the card's ~295: device-memory bytes bound the work. At the
// Cityscapes T = 2048 the products bound it (34 GFLOP at BH 64).
//
// bf16 design (attn_fwd_mma): one block per (batch*head, 64 queries), four
// warps, each owning 16 query rows (FlashAttention-2's split), both products
// on the tensor cores with mma.sync m16n8k16 bf16 -> fp32. K/V tiles of 64
// keys are double-buffered in shared memory, loaded with 16-byte cp.async
// (8 tokens a thread along T; a ragged tail is zero-filled and its logits
// set to -inf). Storage is [dh][T], so Q (the A operand of S = Q K^T) and K
// (its B operand) load with ldmatrix.trans, while V is already the [n][k]
// B layout of P V and loads with plain ldmatrix. Shared rows are padded to
// 72 elements (144 bytes), so the eight rows of an ldmatrix fall in eight
// distinct 16-byte bank groups. The output accumulators [q][d] are staged
// through shared memory so the store to [BH, dh, T] is coalesced along T.
//
// Softmax in two passes, as the TPU kernel's rounding needs: pass 1 runs
// over the K tiles for each row's max and sum (a quad shuffle joins the four
// threads that share a row); pass 2 recomputes S on the tensor cores, forms
// p = exp(S - m) / l, rounds it to bf16 and feeds it from registers as the A
// fragment of P V (the m16n8k16 accumulator layout is the A layout). The
// rounding of the normalised p is then exact for any T, which a one-pass
// online softmax cannot give; the extra Q K^T is cheap at dh <= 64. The
// exponentials are ex2.approx on logits prescaled by log2(e): two per logit,
// on the SFU, which at BH 384, T 256 is already above the byte bound.
// mma.sync and not wgmma: at the flagship shapes bytes bound the kernel and
// mma.sync reaches them; a wgmma kernel with TMA-fed K/V and warp
// specialisation is for the compute-bound Cityscapes T = 2048 shape, later.
//
// The async loads need 16-byte aligned rows: T % 8 == 0 and strides that are
// multiples of 8. Views that are not (e.g. the packed qkv of T = 70) take the
// same kernel with element loads (ASYNC = false).
//
// fp32 inputs keep the SIMT kernel attn_fwd_simt (one thread per query on the
// FMA pipes): tensor cores would mean TF32, which the fp32 checks (2e-5)
// refuse, and fp32 runs only in the reference checks.
#include <math.h>

#include "common.cuh"

using namespace ccdm;

namespace {

using bf16 = __nv_bfloat16;

// ---- fp32: SIMT kernel -------------------------------------------------------

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

template <int DH>
__device__ __forceinline__ void load_tile_simt(float (*dst)[DH + 4], const float* src,
                                               long long sd, int s0, int nk) {
  // thread i loads key s0+i: neighbouring threads read neighbouring tokens
  const int i = threadIdx.x;
  if (i < nk) {
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[i][d] = src[d * sd + s0 + i];
  }
}

template <int DH>
__global__ void __launch_bounds__(kQTile)
attn_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int t_len, int q_tiles,
              long long q_sbh, long long q_sd, long long k_sbh, long long k_sd,
              long long v_sbh, long long v_sd, float scale) {
  // rows padded by 4 floats: keeps float4 alignment and spreads the
  // transposed stores over 8 banks instead of 1
  __shared__ __align__(16) float ks[kKTile][DH + 4];
  __shared__ __align__(16) float vs[kKTile][DH + 4];

  const int bh = blockIdx.x / q_tiles;
  const int qi = (blockIdx.x % q_tiles) * kQTile + threadIdx.x;
  const bool active = qi < t_len;
  const float* kb = k + bh * k_sbh;
  const float* vb = v + bh * v_sbh;

  float qr[DH];
  {
    const float* qb = q + bh * q_sbh;
#pragma unroll
    for (int d = 0; d < DH; ++d) qr[d] = active ? qb[d * q_sd + qi] : 0.f;
  }

  // pass 1: running max m and running sum l of exp(logit - m)
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < t_len; s0 += kKTile) {
    const int nk = min(kKTile, t_len - s0);
    __syncthreads();  // the previous tile is consumed
    load_tile_simt<DH>(ks, kb, k_sd, s0, nk);
    __syncthreads();
    for (int s = 0; s < nk; ++s) {
      const float x = dot_row<DH>(qr, ks[s]) * scale;
      const float mn = fmaxf(m, x);
      l = l * expf(m - mn) + expf(x - mn);
      m = mn;
    }
  }

  // pass 2: normalised probabilities times v
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int s0 = 0; s0 < t_len; s0 += kKTile) {
    const int nk = min(kKTile, t_len - s0);
    __syncthreads();
    load_tile_simt<DH>(ks, kb, k_sd, s0, nk);
    load_tile_simt<DH>(vs, vb, v_sd, s0, nk);
    __syncthreads();
    for (int s = 0; s < nk; ++s) {
      const float x = dot_row<DH>(qr, ks[s]) * scale;
      const float p = expf(x - m) / l;
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
    float* ob = out + static_cast<long long>(bh) * DH * t_len;
#pragma unroll
    for (int d = 0; d < DH; ++d) ob[static_cast<long long>(d) * t_len + qi] = acc[d];
  }
}

// ---- bf16: tensor-core kernel ----------------------------------------------

constexpr int kTile = 64;         // queries per block and keys per K/V tile
constexpr int kWarps = 4;         // 16 query rows each
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kLd = kTile + 8;    // padded row: 144 bytes
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct AttnSmem {
  bf16 q[DH][kLd];  // Q tile; stages the output tile at the end
  bf16 k[2][DH][kLd];
  bf16 v[2][DH][kLd];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading src
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b, a: 16x16 bf16 (4 regs), b: 16x8 bf16 (2 regs), c: 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One [DH][64] tile of tokens t0 .. t0+63 into shared memory, zeros past t_len.
// ASYNC: 16-byte cp.async (t_len % 8 == 0, aligned rows), else element loads.
template <int DH, bool ASYNC>
__device__ __forceinline__ void load_tile(bf16 (*dst)[kLd], const bf16* src, long long sd,
                                          int t0, int t_len) {
  if constexpr (ASYNC) {
    constexpr int kChunks = DH * kTile / 8;
#pragma unroll
    for (int c = threadIdx.x; c < kChunks; c += kMmaThreads) {
      const int d = c / (kTile / 8), j = (c % (kTile / 8)) * 8;
      const bool valid = t0 + j < t_len;  // a chunk is all in or all out
      cp_async16(&dst[d][j], src + d * sd + (valid ? t0 + j : 0), valid);
    }
  } else {
    for (int e = threadIdx.x; e < DH * kTile; e += kMmaThreads) {
      const int d = e / kTile, j = e % kTile;
      dst[d][j] = t0 + j < t_len ? src[d * sd + t0 + j] : __float2bfloat16(0.f);
    }
  }
}

// Q fragments of this warp's 16 rows: A operands of S = Q K^T, one per 16 dh.
template <int DH>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[DH / 16][4],
                                             bf16 (*qs)[kLd], int warp, int lane) {
  // matrices 0..3: (q 0-7, d 0-7), (q 8-15, d 0-7), (q 0-7, d 8-15), (q 8-15, d 8-15)
  const int q = warp * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd)
    ldsm_x4_trans(qf[kd], &qs[kd * 16 + (lane & 7) + (lane >> 4) * 8][q]);
}

// S (16 rows x 64 keys, this warp) = Q K^T over one K tile, unscaled fp32.
// sc[nt] holds keys nt*8 .. nt*8+7 in the m16n8 accumulator layout:
// {row g, col 2t}, {g, 2t+1}, {g+8, 2t}, {g+8, 2t+1} for g = lane/4, t = lane%4.
template <int DH>
__device__ __forceinline__ void qk_tile(float (&sc)[8][4], const uint32_t (&qf)[DH / 16][4],
                                        bf16 (*ks)[kLd], int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) sc[nt][r] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; nt += 2) {
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) {
      // matrices 0..3: (d 0-7, keys nt), (d 8-15, keys nt), (d 0-7, nt+1), (d 8-15, nt+1)
      uint32_t b[4];
      ldsm_x4_trans(b, &ks[kd * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][nt * 8 + (lane >> 4) * 8]);
      mma_bf16(sc[nt], qf[kd], b[0], b[1]);
      mma_bf16(sc[nt + 1], qf[kd], b[2], b[3]);
    }
  }
}

template <int DH, bool ASYNC>
__global__ void __launch_bounds__(kMmaThreads)
attn_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int t_len, int q_tiles,
             long long q_sbh, long long q_sd, long long k_sbh, long long k_sd,
             long long v_sbh, long long v_sd, float scale_log2) {
  __shared__ __align__(16) AttnSmem<DH> sm;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const bf16* kb = k + bh * k_sbh;
  const bf16* vb = v + bh * v_sbh;
  const int n_tiles = (t_len + kTile - 1) / kTile;
  const int n_stages = 2 * n_tiles;  // pass 1: K tiles; pass 2: K and V tiles

  auto issue = [&](int stage) {
    const int tile = stage < n_tiles ? stage : stage - n_tiles;
    load_tile<DH, ASYNC>(sm.k[stage & 1], kb, k_sd, tile * kTile, t_len);
    if (stage >= n_tiles) load_tile<DH, ASYNC>(sm.v[stage & 1], vb, v_sd, tile * kTile, t_len);
  };

  load_tile<DH, ASYNC>(sm.q, q + bh * q_sbh, q_sd, q0, t_len);
  issue(0);
  if constexpr (ASYNC) cp_async_commit();

  uint32_t qf[DH / 16][4];
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g+8, log2 domain
  float l[2] = {0.f, 0.f};
  float o[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[dt][r] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) issue(s + 1);
    if constexpr (ASYNC) {
      cp_async_commit();  // possibly empty: keeps one group per stage
      cp_async_wait<1>();  // stage s (and Q) have landed
    }
    __syncthreads();
    if (s == 0) load_q_frags<DH>(qf, sm.q, warp, lane);
    const int tile = s < n_tiles ? s : s - n_tiles;
    const int buf = s & 1;

    float sc[8][4];
    qk_tile<DH>(sc, qf, sm.k[buf], lane);
    const bool ragged = (tile + 1) * kTile > t_len;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = tile * kTile + nt * 8 + 2 * tig + (r & 1);
        sc[nt][r] = ragged && key >= t_len ? -INFINITY : sc[nt][r] * scale_log2;
      }

    if (s < n_tiles) {
      // pass 1: running max and (per-thread) running sum of each row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * h], sc[nt][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[h], mx);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) sum += ex2(sc[nt][2 * h] - mn) + ex2(sc[nt][2 * h + 1] - mn);
        l[h] = l[h] * ex2(m[h] - mn) + sum;
        m[h] = mn;
      }
      if (s == n_tiles - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
          l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
          l[h] = 1.f / l[h];  // from here on, the reciprocal
        }
      }
    } else {
      // pass 2: p = exp(S - m) / l rounded to bf16, as A fragments; O += P V
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(ex2(sc[2 * kk][0] - m[0]) * l[0], ex2(sc[2 * kk][1] - m[0]) * l[0]);
        a[1] = pack_bf16(ex2(sc[2 * kk][2] - m[1]) * l[1], ex2(sc[2 * kk][3] - m[1]) * l[1]);
        a[2] = pack_bf16(ex2(sc[2 * kk + 1][0] - m[0]) * l[0],
                         ex2(sc[2 * kk + 1][1] - m[0]) * l[0]);
        a[3] = pack_bf16(ex2(sc[2 * kk + 1][2] - m[1]) * l[1],
                         ex2(sc[2 * kk + 1][3] - m[1]) * l[1]);
#pragma unroll
        for (int dt = 0; dt < DH / 8; dt += 2) {
          // matrices 0..3: (d dt, keys 0-7), (d dt, keys 8-15), (d dt+1, 0-7), (d dt+1, 8-15)
          uint32_t b[4];
          ldsm_x4(b, &sm.v[buf][dt * 8 + (lane & 7) + (lane >> 4) * 8]
                              [kk * 16 + ((lane >> 3) & 1) * 8]);
          mma_bf16(o[dt], a, b[0], b[1]);
          mma_bf16(o[dt + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // buffer `buf` is free for stage s + 2
  }

  // stage O as [d][q] bf16 in the Q tile, then store coalesced along T
  const int row = warp * 16 + (lane >> 2);
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int d = dt * 8 + 2 * tig;
    sm.q[d][row] = __float2bfloat16(o[dt][0]);
    sm.q[d + 1][row] = __float2bfloat16(o[dt][1]);
    sm.q[d][row + 8] = __float2bfloat16(o[dt][2]);
    sm.q[d + 1][row + 8] = __float2bfloat16(o[dt][3]);
  }
  __syncthreads();
  bf16* ob = out + static_cast<long long>(bh) * DH * t_len;
  if constexpr (ASYNC) {
    constexpr int kChunks = DH * kTile / 8;
#pragma unroll
    for (int c = threadIdx.x; c < kChunks; c += kMmaThreads) {
      const int d = c / (kTile / 8), j = (c % (kTile / 8)) * 8;
      if (q0 + j < t_len)
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(d) * t_len + q0 + j) =
            *reinterpret_cast<const uint4*>(&sm.q[d][j]);
    }
  } else {
    for (int e = threadIdx.x; e < DH * kTile; e += kMmaThreads) {
      const int d = e / kTile, j = e % kTile;
      if (q0 + j < t_len) ob[static_cast<long long>(d) * t_len + q0 + j] = sm.q[d][j];
    }
  }
}

// Unscaled fp32 logits S = Q K^T of one (batch*head, 64 queries, 64 keys)
// block through the same loads and fragments as attn_fwd_mma: the device
// check of the fragment mapping. out: [BH, T, T] fp32 contiguous.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
attn_logits_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                float* __restrict__ out, int t_len, int q_tiles, long long q_sbh,
                long long q_sd, long long k_sbh, long long k_sd) {
  __shared__ __align__(16) AttnSmem<DH> sm;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kTile;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_tile<DH, true>(sm.q, q + bh * q_sbh, q_sd, q0, t_len);
  load_tile<DH, true>(sm.k[0], k + bh * k_sbh, k_sd, k0, t_len);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DH / 16][4];
  load_q_frags<DH>(qf, sm.q, warp, lane);
  float sc[8][4];
  qk_tile<DH>(sc, qf, sm.k[0], lane);
  float* ob = out + static_cast<long long>(bh) * t_len * t_len;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + warp * 16 + (lane >> 2) + (r >> 1) * 8;
      const int key = k0 + nt * 8 + 2 * (lane & 3) + (r & 1);
      if (qi < t_len && key < t_len) ob[static_cast<long long>(qi) * t_len + key] = sc[nt][r];
    }
}

// ---- launches ---------------------------------------------------------------

enum AttnPath : int { kSimt = 0, kMma = 1, kMmaScalar = 2 };

struct AttnArgs {
  const void *q, *k, *v;
  void* out;
  int bh, t;
  long long q_sbh, q_sd, k_sbh, k_sd, v_sbh, v_sd;
  float scale;
  cudaStream_t stream;
};

template <int DH>
int launch_simt(const AttnArgs& a) {
  const int q_tiles = (a.t + kQTile - 1) / kQTile;
  attn_fwd_simt<DH><<<dim3(static_cast<unsigned int>(a.bh) * q_tiles), kQTile, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.t, q_tiles, a.q_sbh,
      a.q_sd, a.k_sbh, a.k_sd, a.v_sbh, a.v_sd, a.scale);
  return cudaGetLastError();
}

template <int DH, bool ASYNC>
int launch_mma(const AttnArgs& a) {
  const int q_tiles = (a.t + kTile - 1) / kTile;
  attn_fwd_mma<DH, ASYNC>
      <<<dim3(static_cast<unsigned int>(a.bh) * q_tiles), kMmaThreads, 0, a.stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.t, q_tiles, a.q_sbh,
          a.q_sd, a.k_sbh, a.k_sd, a.v_sbh, a.v_sd, a.scale * kLog2e);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the async path's 16-byte loads and stores: aligned bases, strides and T
bool async_ok(const AttnArgs& a) {
  return aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.out) &&
         a.t % 8 == 0 && a.q_sbh % 8 == 0 && a.q_sd % 8 == 0 && a.k_sbh % 8 == 0 &&
         a.k_sd % 8 == 0 && a.v_sbh % 8 == 0 && a.v_sd % 8 == 0;
}

template <int DH>
int dispatch_path(int dtype, int path, const AttnArgs& a) {
  if (path == kSimt && dtype == kFloat32) return launch_simt<DH>(a);
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  if (path == kMma) return async_ok(a) ? launch_mma<DH, true>(a) : cudaErrorMisalignedAddress;
  if (path == kMmaScalar) return launch_mma<DH, false>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: [bh, dh, t] views with unit stride along t (strides in elements
// along bh and dh given); out: [bh, dh, t] contiguous. dh in {32, 64}.
// path 0: fp32 SIMT kernel; 1: bf16 tensor cores, 16-byte async loads (T %
// 8 == 0 and 16-byte aligned rows, else cudaErrorMisalignedAddress); 2: bf16
// tensor cores, element loads (any view). Launches on `stream`, allocates
// nothing, returns a cudaError_t.
extern "C" int ccdm_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    int dtype, int path, int bh, int t, int dh,
                                    long long q_sbh, long long q_sd, long long k_sbh,
                                    long long k_sd, long long v_sbh, long long v_sd,
                                    float scale, void* stream) {
  if (bh <= 0 || t <= 0) return cudaErrorInvalidValue;
  const AttnArgs a{q, k, v, out, bh, t, q_sbh, q_sd, k_sbh, k_sd, v_sbh, v_sd, scale,
                   static_cast<cudaStream_t>(stream)};
  if (dh == 32) return dispatch_path<32>(dtype, path, a);
  if (dh == 64) return dispatch_path<64>(dtype, path, a);
  return cudaErrorInvalidValue;
}

// Unscaled fp32 logits q^T k, [bh, t, t] contiguous, of bf16 q, k laid out
// as for ccdm_flash_attention's path 1, through that path's tiles and
// tensor-core fragments: a device check of the fragment mapping, not a step
// of the model.
extern "C" int ccdm_attention_logits(const void* q, const void* k, void* out, int bh, int t,
                                     int dh, long long q_sbh, long long q_sd,
                                     long long k_sbh, long long k_sd, void* stream) {
  if (bh <= 0 || t <= 0) return cudaErrorInvalidValue;
  const AttnArgs a{q, k, k, out, bh, t, q_sbh, q_sd, k_sbh, k_sd, k_sbh, k_sd, 1.f,
                   static_cast<cudaStream_t>(stream)};
  if (!async_ok(a)) return cudaErrorMisalignedAddress;
  const int tiles = (t + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned int>(bh) * tiles, tiles);
  auto s = static_cast<cudaStream_t>(stream);
  if (dh == 32)
    attn_logits_mma<32><<<grid, kMmaThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<float*>(out), t,
        tiles, q_sbh, q_sd, k_sbh, k_sd);
  else if (dh == 64)
    attn_logits_mma<64><<<grid, kMmaThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<float*>(out), t,
        tiles, q_sbh, q_sd, k_sbh, k_sd);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
