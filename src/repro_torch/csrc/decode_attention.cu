// Flash-decode attention for Hopper (sm_90a): one query token per
// sequence against a (B, Smax, Hkv, D) KV cache whose first `length`
// positions are valid.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (wrapper flash_decode_fwd).  Same function: fp32 scores scaled by
// D^-0.5, positions >= length masked with a finite -1e30, fp32 softmax
// statistics and accumulation, output in the input dtype.  One rounding
// differs: p goes to the tensor cores in bf16, as in the plain version and
// the JAX model's decode_attention (p cast to the cache dtype), where the
// TPU kernel keeps p in fp32.
//
// Bound: bytes.  Each key brings 2*D*2 bytes of K and V for 4*G*D FLOPs
// (about 6 FLOP/byte at G = 6), far below the card's ridge.  But the
// serving caches are small (2-5 MB), so a call's time is the length of
// its serial chain (launch, load, math, merge), not the bytes streamed.
// The design shortens that chain:
//   - one launch.  [0, length) is split into n_splits <= 8 ranges of
//     keys_per_split keys (any count, not whole tiles), one block each,
//     and the splits of one (batch, kv head) form one thread-block
//     cluster.  Each block owns a chunk of the G*D outputs and stores its
//     partial acc for every chunk straight into the owner's shared memory
//     (distributed shared memory), and its (m, l) into every block's; after
//     one cluster barrier each block merges its chunk from its own shared
//     memory in rank order: no scratch, no second kernel, and the same
//     order of sums on every call (bitwise deterministic);
//   - every load in flight at once.  Each of the 4 warps takes a
//     contiguous quarter of the block's keys and issues cp.async for all
//     of it up front, one commit group per 16-key step, into a ring of
//     NST <= 4 steps (deep enough for the serving shapes; longer ranges
//     refill the ring as it drains), and computes on the first step while
//     the rest land.  Nothing at or beyond `length` is read;
//   - both products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//     accumulate): A is one m16 tile of the kv head's q rows, the last
//     tile zero-padded (each thread holds rows g and g + 8 of its quad's
//     fragments, and both are carried through the softmax and the
//     merges); K fragments come from ldmatrix, V fragments from
//     ldmatrix.trans, and P is re-packed from the S accumulators in
//     registers, as in the prefill kernel's fragments.  The 4 warps merge
//     their (m, l, acc) through shared memory, every thread taking a
//     share;
//   - any G.  The grid's y axis runs over (kv head, tile of 16 q rows):
//     a kv head with G > 16 q heads takes ceil(G / 16) tiles, each its
//     own cluster of splits reading the same keys.  At G <= 16 there is
//     one tile and the kernel does what it did before tiles (the same
//     splits, the same sums in the same order);
//   - an optional log-sum-exp.  Given an fp32 (B, H) buffer, the block
//     that owns a q row's first output element writes the row's natural
//     log-sum-exp after the cluster merge, so a cache split over its
//     sequence across ranks can merge their partial outputs; a null
//     buffer leaves the output what it was without it.  length 0 (a
//     rank's slice with no valid key) gives output 0 and lse -inf.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 16;  // q rows per tile: one m16 tile of q heads
constexpr int kStep = 16;  // keys per MMA step
constexpr int kMaxSplits = 8;  // the largest portable cluster

// the two halves of cluster.sync(): arrive early, wait where it matters
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int D>
constexpr int smem_bytes(int n_stages) {
  // Q (16 padded rows) + per warp n_stages steps of K and V
  return (16 + 2 * kWarps * n_stages * kStep) * (D + 8) * 2;
}
// after the loop the K/V ring holds the warps' fp32 partial acc of every
// q row: the shallowest ring must be large enough
static_assert(smem_bytes<64>(1) - 16 * (64 + 8) * 2 >=
                  kWarps * kMaxG * 64 * 4, "wAcc overruns the ring (D 64)");
static_assert(smem_bytes<128>(1) - 16 * (128 + 8) * 2 >=
                  kWarps * kMaxG * 128 * 4, "wAcc overruns the ring (D 128)");

template <int D, int NST>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Smax, int length,
    int keys_per_split, float scale_log2) {
  constexpr int LD = D + 8;  // padded rows: conflict-free ldmatrix
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int STEP = kStep * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + 16 * LD;
  __nv_bfloat16* sV = sK + kWarps * NST * STEP;
  // after the loop the ring holds the warps' partial acc, fp32
  float* wAcc = reinterpret_cast<float*>(sK);
  __shared__ float wM[kWarps][kMaxG], wL[kWarps][kMaxG];
  // what the cluster's blocks send this one: (m, l) of every split and
  // acc of every split for this block's chunk of the outputs
  __shared__ float cM[kMaxSplits][kMaxG], cL[kMaxSplits][kMaxG];
  __shared__ float cAcc[kMaxG * D + kMaxSplits];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, b = blockIdx.z;
  const int NS = gridDim.x;  // = the cluster's size
  // this block's kv head and its tile of q rows: heads G0 .. G0 + G - 1
  // of the kv head's H / Hkv
  const int n_tiles = gridDim.y / Hkv;
  const int hk = blockIdx.y / n_tiles;
  const int G0 = (blockIdx.y % n_tiles) * kMaxG;
  const int G = min(kMaxG, H / Hkv - G0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  cluster_arrive();  // matched by the wait before the first remote write

  // Q: the tile's G q heads of this kv head in rows 0..G-1, rows G..15
  // zero
  const __nv_bfloat16* qb = q + ((long)b * H + (long)hk * (H / Hkv) + G0) * D;
  for (int i = tid; i < 16 * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    cp_async16(sQ + r * LD + c, r < G ? qb + r * D + c : qb, r < G);
  }
  cp_async_commit();

  // this warp's keys: a contiguous quarter of the block's range
  const int start = split * keys_per_split;
  const int stop = min(length, start + keys_per_split);
  const int per_warp = (stop - start + kWarps - 1) / kWarps;
  const int w_lo = start + warp * per_warp;
  const int w_hi = min(stop, w_lo + per_warp);
  const int n_steps = w_hi > w_lo ? (w_hi - w_lo + kStep - 1) / kStep : 0;
  const long rs = (long)Hkv * D;
  const __nv_bfloat16* kb = kc + (long)b * Smax * rs + (long)hk * D;
  const __nv_bfloat16* vb = vc + (long)b * Smax * rs + (long)hk * D;
  __nv_bfloat16* wK = sK + warp * NST * STEP;
  __nv_bfloat16* wV = sV + warp * NST * STEP;

  // one commit group per step; rows past this warp's keys are zeroed,
  // never read
  auto load = [&](int step) {
    const int k0 = w_lo + step * kStep;
    const int slot = (step % NST) * STEP;
    for (int i = lane; i < kStep * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = k0 + r < w_hi;
      const long off = (long)(k0 + r) * rs + c;
      cp_async16(wK + slot + r * LD + c, ok ? kb + off : kb, ok);
      cp_async16(wV + slot + r * LD + c, ok ? vb + off : vb, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < NST; ++s) {
    if (s < n_steps) load(s);
    cp_async_commit();
  }

  cp_async_wait<NST>();  // this thread's part of Q has landed
  __syncthreads();       // and everyone's
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], sQ + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                            kk * 16 + 8 * (lane >> 4));

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // this thread's rows: g and g + 8 (rows < G are real, the rest zero)
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int step = 0; step < n_steps; ++step) {  // kstruct: grid:kv_blocks
    cp_async_wait<NST - 1>();  // step `step` has landed
    __syncwarp();
    const __nv_bfloat16* tK = wK + (step % NST) * STEP;
    const __nv_bfloat16* tV = wV + (step % NST) * STEP;
    const int k0 = w_lo + step * kStep;

    // S = Q K^T over 16 keys: two n-tiles of 8
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bf[4];
      ldmatrix_x4(bf, tK + ((lane & 7) + 8 * (lane >> 4)) * LD + kk * 16 +
                          8 * ((lane >> 3) & 1));
      mma_bf16_16816(s[0], qf[kk], bf[0], bf[1]);
      mma_bf16_16816(s[1], qf[kk], bf[2], bf[3]);
    }

    // mask keys past this warp's range, online softmax in the log2 domain
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        const float x = kp < w_hi ? s[j][e] * scale_log2 : kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const float m_new = fmaxf(m_r[row], quad_max(mx[row]));
      alpha[row] = ex2(m_r[row] - m_new);
      m_r[row] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - m_r[e >> 1]);
        s[j][e] = p;
        rsum[e >> 1] += p;
      }
    }
    l_r[0] = l_r[0] * alpha[0] + rsum[0];
    l_r[1] = l_r[1] * alpha[1] + rsum[1];

    // O = O * alpha + P V: the S accumulators are the A fragment of one
    // 16-key k-step
    const uint32_t pa[4] = {pack_bf16x2(s[0][0], s[0][1]),
                            pack_bf16x2(s[0][2], s[0][3]),
                            pack_bf16x2(s[1][0], s[1][1]),
                            pack_bf16x2(s[1][2], s[1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
      acc[n + 1][0] *= alpha[0];
      acc[n + 1][1] *= alpha[0];
      acc[n + 1][2] *= alpha[1];
      acc[n + 1][3] *= alpha[1];
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, tV + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                n * 8 + 8 * (lane >> 4));
      mma_bf16_16816(acc[n], pa, bf[0], bf[1]);
      mma_bf16_16816(acc[n + 1], pa, bf[2], bf[3]);
    }
    __syncwarp();  // every lane is done with this slot
    if (step + NST < n_steps) load(step + NST);
    cp_async_commit();
  }

  // the warps' partials -> shared memory (the ring is free now): row g
  // from acc[n][0..1], row g + 8 from acc[n][2..3]
  const float l_w[2] = {quad_sum(l_r[0]), quad_sum(l_r[1])};
  __syncthreads();
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int gr = g + 8 * row;
    if (gr < G) {
      float* wa = wAcc + (warp * kMaxG + gr) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        wa[n * 8] = acc[n][2 * row];
        wa[n * 8 + 1] = acc[n][2 * row + 1];
      }
      if (t == 0) {
        wM[warp][gr] = m_r[row];
        wL[warp][gr] = l_w[row];
      }
    }
  }
  __syncthreads();

  // the block's partial, warps merged in order, every thread a share;
  // each value goes straight to the block of the cluster that owns its
  // output element (a chunk of G*D/NS), and (m, l) go to every block
  const int chunk = (G * D + NS - 1) / NS;
  cluster_wait();  // every block of the cluster has started
  for (int i = tid; i < G * D; i += kThreads) {
    const int gg = i / D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wM[w][gg]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a += wAcc[(w * kMaxG + gg) * D + i % D] * ex2(wM[w][gg] - m);
    const int owner = i / chunk;
    cluster.map_shared_rank(cAcc, owner)[split * chunk + i - owner * chunk] =
        a;
    if (i % D == 0) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) l += wL[w][gg] * ex2(wM[w][gg] - m);
      for (int r = 0; r < NS; ++r) {
        cluster.map_shared_rank(&cM[split][gg], r)[0] = m;
        cluster.map_shared_rank(&cL[split][gg], r)[0] = l;
      }
    }
  }
  cluster.sync();  // every partial has landed where it is merged

  // this block's chunk of the outputs: the splits merged in rank order
  __nv_bfloat16* ob = out + ((long)b * H + (long)hk * (H / Hkv) + G0) * D;
  for (int j = tid; j < chunk && split * chunk + j < G * D; j += kThreads) {
    const int i = split * chunk + j, gg = i / D;
    float m = kNegInf;
    for (int r = 0; r < NS; ++r) m = fmaxf(m, cM[r][gg]);
    float l = 0.f, a = 0.f;
    for (int r = 0; r < NS; ++r) {
      const float w = ex2(cM[r][gg] - m);
      l += cL[r][gg] * w;
      a += cAcc[r * chunk + j] * w;
    }
    ob[i] = __float2bfloat16(a / fmaxf(l, 1e-30f));  // kstruct: store 2
    // the row's natural log-sum-exp of its scaled scores, -inf when the
    // range holds no key (its weight in a merge across ranks is then 0)
    if (lse != nullptr && i % D == 0)
      lse[(long)b * H + (long)hk * (H / Hkv) + G0 + gg] =
          l > 0.f ? (m + log2f(l)) * 0.6931471805599453f : -INFINITY;
  }
}

template <int D, int NST>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* out,
                   void* lse, int B, int H, int Hkv, int Smax, int length,
                   int n_splits, int keys_per_split, cudaStream_t stream) {
  auto* kernel = flash_decode_kernel<D, NST>;
  constexpr int smem = smem_bytes<D>(NST);
  // once per instantiation: shared memory above 48 KB
  static const cudaError_t setup = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (setup != cudaSuccess) return setup;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, Hkv * ((H / Hkv + kMaxG - 1) / kMaxG), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Hkv, Smax, length, keys_per_split,
      scale_log2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the ring depth: every step of a warp in flight at once, up to 4 steps
template <int D>
cudaError_t launch_d(const void* q, const void* kc, const void* vc, void* out,
                     void* lse, int B, int H, int Hkv, int Smax, int length,
                     int n_splits, int keys_per_split, cudaStream_t stream) {
  const int per_warp = (keys_per_split + kWarps - 1) / kWarps;
  const int steps = (per_warp + kStep - 1) / kStep;
  switch (steps <= 1 ? 1 : steps == 2 ? 2 : steps == 3 ? 3 : 4) {
    case 1:
      return launch<D, 1>(q, kc, vc, out, lse, B, H, Hkv, Smax, length,
                          n_splits, keys_per_split, stream);
    case 2:
      return launch<D, 2>(q, kc, vc, out, lse, B, H, Hkv, Smax, length,
                          n_splits, keys_per_split, stream);
    case 3:
      return launch<D, 3>(q, kc, vc, out, lse, B, H, Hkv, Smax, length,
                          n_splits, keys_per_split, stream);
    default:
      return launch<D, 4>(q, kc, vc, out, lse, B, H, Hkv, Smax, length,
                          n_splits, keys_per_split, stream);
  }
}

}  // namespace
}  // namespace repro_torch

// q (B,H,D), caches (B,Smax,Hkv,D), out (B,H,D): bf16, contiguous,
// D = 64 or 128, any G = H/Hkv (ceil(G / 16) tiles of q rows a kv head).
// Split s covers keys [s*keys_per_split, (s+1)*keys_per_split) clipped to
// `length` (0 <= length <= Smax: at 0 the output is 0); n_splits <= 8 is
// the cluster size.  lse (B,H) fp32, or null: each row's natural
// log-sum-exp of its scaled scores over the valid keys (-inf at length 0),
// for a merge of partial attentions across ranks; with null the output is
// what it was before lse existed.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int flash_decode_fwd_bf16(const void* q, const void* kc,
                                     const void* vc, void* out, int B, int H,
                                     int Hkv, int Smax, int D, int length,
                                     int n_splits, int keys_per_split,
                                     void* lse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv != 0 || n_splits < 1 ||
      n_splits > repro_torch::kMaxSplits ||
      (long)Hkv * ((H / Hkv + repro_torch::kMaxG - 1) / repro_torch::kMaxG) >
          65535)
    return (int)cudaErrorInvalidValue;
  if (D == 64)
    return repro_torch::launch_d<64>(q, kc, vc, out, lse, B, H, Hkv, Smax,
                                     length, n_splits, keys_per_split, st);
  if (D == 128)
    return repro_torch::launch_d<128>(q, kc, vc, out, lse, B, H, Hkv, Smax,
                                      length, n_splits, keys_per_split, st);
  return (int)cudaErrorInvalidValue;
}
