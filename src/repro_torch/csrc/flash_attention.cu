// Flash attention forward for Hopper (sm_90a): causal GQA attention with
// an optional sliding window and a top-left q_offset.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_fwd_kernel
// (wrapper flash_attention_fwd).  Same function: scores scaled by D^-0.5,
// masked with a finite -1e30, online softmax with fp32 (m, l, acc) carried
// over kv tiles, output acc / max(l, 1e-30) in the input dtype.
//
// Bound: about 4*B*H*S^2*D/2 causal FLOPs against the q+k+v+o bytes.  At
// the serving prompt of 512 the two bounds are close (bytes slightly
// ahead); FLOPs grow as S^2 and take over for longer prompts and under a
// window.  So loads must overlap the products, and the products must run
// at the tensor cores' full rate, which on Hopper only wgmma reaches.
//
// Design.  One CTA owns one (batch, q head, 64-row q tile), the grid
// ordered heaviest (most kv tiles) first across all heads and batches,
// and walks its kv tiles with (m, l, acc) in registers.  It is
// warp-specialised:
//   - warp 4, the producer: one thread issues TMA loads, Q once, then the
//     K and V tiles of 64 keys into two rings of shared-memory stages,
//     each stage guarded by a full (bytes landed) and an empty (consumers
//     done) mbarrier.  K and V have separate rings, so the next K lands
//     while the current tile's softmax and P V run;
//   - warps 0-3, one consumer warpgroup of 64 q rows: S = Q K^T runs as
//     wgmma m64n64k16 with Q and K both read from shared memory; the
//     online softmax runs on the accumulator fragments (each thread holds
//     two rows, reduced across its quad; max on raw scores, the scale
//     folded into one FMA before ex2, and acc rescaled only when a row's
//     max moved); P is packed to bf16 in registers and O += P V runs as
//     wgmma m64n{D}k16 with A = P from registers and B = V read MN-major
//     (V is D-contiguous).
// The rings are shallow so that 3 (D = 128) or 4 (D = 64) CTAs share an
// SM and fill each other's gaps on the tensor cores (see Tiles).  Tiles
// are 128-byte swizzled: a box holds 64 columns (128 bytes), so at
// D = 128 every row block arrives as two boxes 8 KB apart, and the
// descriptors step over them (K-major: +32 bytes per k16 inside a box;
// MN-major V: LBO = 8 KB between the two column blocks).  TMA zero-fills
// rows beyond S or Sk; the per-element mask runs only on tiles that cross
// the causal, window or Sk bound.  kv tiles wholly above the diagonal or
// below the window are never loaded, the skip rule of the TPU kernel.

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;             // q rows per CTA: one consumer warpgroup
constexpr int kBK = 64;             // keys per kv tile
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kBox = 64 * 128;      // bytes of one 64-row x 64-column box

// Ring depths and CTAs per SM, chosen on the H100 at both serving shapes
// (PERF.md): more CTAs per SM beat deeper rings, since the CTAs fill each
// other's softmax gaps on the tensor cores.  D = 128: Q + 2 K + 1 V tiles
// (65 KB) give 3 CTAs per SM; D = 64: Q + 2 K + 2 V (41 KB) give 4; the
// launch bounds cap the registers to match.
template <int D>
struct Tiles {
  static constexpr int kStagesK = 2;
  static constexpr int kStagesV = D == 128 ? 1 : 2;
  static constexpr int kCtasPerSm = D == 128 ? 3 : 4;
  static constexpr int kTile = (D / 64) * kBox;  // one Q, K or V tile
  // Q, the K and V rings, and 1 KB to align the first tile
  static constexpr int kSmem = (1 + kStagesK + kStagesV) * kTile + 1024;
};

// the two rows of one consumer thread and what masks them
struct Rows {
  int qp0;  // absolute position of row g (row g + 8 is qp0 + 8)
  int Sk, causal, window, t;
  float scale_log2;
};

// mask (only tiles crossing a bound), then the online softmax in the log2
// domain over one 64-key tile of raw scores sc: sc[4j + e] is n-tile j
// (keys 8j..8j+7), row e >> 1, key 8j + 2t + (e & 1).  The max is taken
// on raw scores and the scale folded into one FMA before ex2.  Updates m
// (scaled) and the per-thread partial l (alpha is uniform across the
// quad), returns alpha and P in bf16 as the wgmma A fragments of the
// tile's 4 k-steps: the accumulators of n-tiles 2kk and 2kk+1 are exactly
// those of k-step kk.
__device__ __forceinline__ void online_softmax(float (&sc)[32],
                                               float (&m_r)[2],
                                               float (&l_r)[2],
                                               float (&alpha)[2],
                                               uint32_t (&pa)[kBK / 16][4],
                                               const Rows& r, int k_lo,
                                               bool interior) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!interior) {
        const int kp = k_lo + j * 8 + 2 * r.t + (e & 1);
        const int qp = r.qp0 + 8 * (e >> 1);
        const bool ok = kp < r.Sk && (!r.causal || kp <= qp) &&
                        (r.window <= 0 || kp > qp - r.window);
        sc[4 * j + e] = ok ? sc[4 * j + e] : kNegInf;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
  }
  float rs[2] = {0.f, 0.f}, m_use[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const float m_tile = quad_max(mx[row]);
    const float m_new = fmaxf(m_r[row], m_tile * r.scale_log2);
    alpha[row] = ex2(m_r[row] - m_new);
    m_r[row] = m_new;
    // a row with no visible key yet: its p are 0 (the FMA's rounding
    // residue of -1e30 * scale could otherwise reach ex2 as +1e22)
    m_use[row] = m_tile == kNegInf ? 0.f : m_new;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float p = ex2(fmaf(sc[j], r.scale_log2, -m_use[(j >> 1) & 1]));
    sc[j] = p;
    rs[(j >> 1) & 1] += p;
  }
  l_r[0] = l_r[0] * alpha[0] + rs[0];
  l_r[1] = l_r[1] * alpha[1] + rs[1];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// acc *= alpha per row, skipped when no row of the warp changed its max
// (alpha == 1 everywhere), as happens on most tiles once the max settles
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N],
                                        const float (&alpha)[2]) {
  if (__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) return;
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] *= alpha[(j >> 1) & 1];
}

// S = Q K^T for one tile: D/16 k-steps of wgmma m64n64k16, both operands
// K-major in shared memory (+32 bytes per k16 inside a 64-column box)
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t sQ,
                                         uint32_t sK) {
#pragma unroll
  for (int j = 0; j < 32; ++j) sc[j] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss_n64(sc, smem_desc(sQ + off, 16, 1024),
                 smem_desc(sK + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V for one tile: 4 k-steps of 16 keys (2 KB of V rows each),
// A = P from registers, B = V MN-major
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t sV) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t db = smem_desc(sV + kk * 2048, kBox, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128_tb(acc, pa[kk], db);
    else
      wgmma_rs_n64_tb(acc, pa[kk], db);
  }
  wgmma_commit();
}

// true when every key of the tile at k_lo is visible to every row of the
// CTA, so the tile needs no mask
__device__ __forceinline__ bool interior(int k_lo, int Sk, int causal,
                                         int window, int qpos_first,
                                         int qpos_last) {
  return k_lo + kBK <= Sk && (!causal || k_lo + kBK - 1 <= qpos_first) &&
         (window <= 0 || k_lo > qpos_last - window);
}

template <int D>
__global__ void __launch_bounds__(kThreads, Tiles<D>::kCtasPerSm)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, int S, int Sk, int H,
                     int Hkv, int causal, int window, int q_offset,
                     float scale_log2) {
  constexpr int NK = Tiles<D>::kStagesK, NV = Tiles<D>::kStagesV;
  constexpr int TILE = Tiles<D>::kTile;
  extern __shared__ unsigned char smem_raw[];
  // full: the tile's bytes have landed; empty: every consumer thread is
  // done with it.  K and V have their own, so K can be refilled as soon
  // as S = Q K^T is done
  __shared__ __align__(8) uint64_t bar_q, full_k[NK], full_v[NV],
      empty_k[NK], empty_v[NV];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + TILE, sV = sK + NK * TILE;

  // a 1-d grid in order of work: every (batch, head)'s last q tile (the
  // most kv tiles under causality) first, so the heaviest CTAs start in
  // the first wave and spread over the SMs
  const int n_q = (S + kBQ - 1) / kBQ;
  const int per_q = gridDim.x / n_q;  // H * B
  const int qt = n_q - 1 - (int)blockIdx.x / per_q;
  const int h = (int)blockIdx.x % per_q % H, b = (int)blockIdx.x % per_q / H;
  const int hk = h / (H / Hkv);
  const int q_lo = qt * kBQ;
  // kv tiles that can hold an allowed key for some row of this CTA
  const int qpos_first = q_offset + q_lo;
  const int qpos_last = q_offset + min(q_lo + kBQ, S) - 1;
  const int kv_end = causal ? min(Sk, qpos_last + 1) : Sk;
  const int kv_begin = window > 0 ? max(0, qpos_first - window + 1) : 0;
  const int t0 = kv_begin / kBK;
  const int n_tiles = max(0, (kv_end + kBK - 1) / kBK - t0);
  const int tid = threadIdx.x;

  if (tid == kConsumers) {
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
  }
  if (tid == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < NK; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&empty_k[s], kConsumers);
    }
    for (int s = 0; s < NV; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: one thread issues every load
    if (tid == kConsumers) {
      mbar_expect_tx(&bar_q, TILE);
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(sQ + c * kBox, &tq, &bar_q, c * 64, h, q_lo, b);
      for (int i = 0; i < n_tiles; ++i) {  // kstruct: grid:kv_blocks
        const int k_lo = (t0 + i) * kBK;
        const int sk = i % NK, sv = i % NV;
        mbar_wait(&empty_k[sk], ((i / NK) & 1) ^ 1);  // first round passes
        mbar_expect_tx(&full_k[sk], TILE);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sK + sk * TILE + c * kBox, &tk, &full_k[sk], c * 64, hk,
                      k_lo, b);
        mbar_wait(&empty_v[sv], ((i / NV) & 1) ^ 1);
        mbar_expect_tx(&full_v[sv], TILE);
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sV + sv * TILE + c * kBox, &tv, &full_v[sv], c * 64, hk,
                      k_lo, b);
      }
    }
    return;
  }

  // consumer warpgroup: warp w owns rows 16w..16w+15 of the q tile; this
  // thread holds rows g and g + 8 of them.  The tensor cores' idle time
  // during one CTA's softmax is filled by the other CTAs on the SM.
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Rows rows{qpos_first + warp * 16 + g, Sk, causal, window, t,
                  scale_log2};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  uint32_t pa[kBK / 16][4];  // P in bf16, the A operand of P V

  mbar_wait(&bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {  // kstruct: grid:kv_blocks
    const int k_lo = (t0 + i) * kBK;
    const int sk = i % NK, sv = i % NV;
    float sc[32];
    mbar_wait(&full_k[sk], (i / NK) & 1);
    issue_qk<D>(sc, sQ, sK + sk * TILE);
    wgmma_wait_all();
    reg_fence(sc);
    mbar_arrive(&empty_k[sk]);  // K can be refilled during the softmax
    float alpha[2];
    online_softmax(sc, m_r, l_r, alpha, pa, rows, k_lo,
                   interior(k_lo, Sk, causal, window, qpos_first, qpos_last));
    rescale(acc, alpha);
    mbar_wait(&full_v[sv], (i / NV) & 1);
    issue_pv<D>(acc, pa, sV + sv * TILE);
    wgmma_wait_all();
    reg_fence(acc);
    mbar_arrive(&empty_v[sv]);
  }

  // acc[4n + e]: n-tile n (columns 8n..8n+7), row e >> 1, column
  // 8n + 2t + (e & 1)
  const float inv[2] = {1.f / fmaxf(quad_sum(l_r[0]), 1e-30f),
                        1.f / fmaxf(quad_sum(l_r[1]), 1e-30f)};
  const long q_rs = (long)H * D;
  __nv_bfloat16* ob = o + (long)b * S * q_rs + (long)h * D;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = q_lo + warp * 16 + g + 8 * row;
    if (r >= S) continue;
    __nv_bfloat16* orow = ob + (long)r * q_rs;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =  // kstruct: store 4
          __floats2bfloat162_rn(acc[4 * n + 2 * row] * inv[row],
                                acc[4 * n + 2 * row + 1] * inv[row]);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// does not link against libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (B, rows, heads, D) bf16 tensor as a 4-d map, boxes of 64 columns of
// one head over `box_rows` rows, 128-byte swizzled
bool encode(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
            int D, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Sk, int H, int Hkv, int causal,
                   int window, int q_offset, cudaStream_t stream) {
  constexpr int smem = Tiles<D>::kSmem;
  // once per instantiation, not per launch
  static const cudaError_t setup = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (setup != cudaSuccess) return setup;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, S, H, D, kBQ) || !encode(&tk, k, B, Sk, Hkv, D, kBK) ||
      !encode(&tv, v, B, Sk, Hkv, D, kBK))
    return cudaErrorInvalidValue;
  const dim3 grid((S + kBQ - 1) / kBQ * H * B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Sk, H, Hkv, causal,
      window, q_offset, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// q (B,S,H,D), k/v (B,Sk,Hkv,D), o (B,S,H,D); all bf16, contiguous,
// D = 64 or 128.  Returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue if a tensor map cannot be encoded).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, int B, int S,
                                        int Sk, int H, int Hkv, int D,
                                        int causal, int window, int q_offset,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return repro_torch::launch<64>(q, k, v, o, B, S, Sk, H, Hkv, causal,
                                   window, q_offset, st);
  if (D == 128)
    return repro_torch::launch<128>(q, k, v, o, B, S, Sk, H, Hkv, causal,
                                    window, q_offset, st);
  return (int)cudaErrorInvalidValue;
}
