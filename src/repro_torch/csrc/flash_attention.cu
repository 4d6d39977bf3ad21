// Flash attention forward for Hopper (sm_90a): causal GQA attention with
// an optional sliding window and a top-left q_offset.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_fwd_kernel
// (wrapper flash_attention_fwd).  Same function: scores scaled by D^-0.5,
// masked with a finite -1e30, online softmax with fp32 (m, l, acc) carried
// over kv tiles, output acc / max(l, 1e-30) in the input dtype.
//
// Design.  On the TPU the kv axis is a sequential grid dimension that
// carries (m, l, acc) in VMEM scratch.  Here blocks run in parallel in no
// order, so one thread block owns one (batch, q head, 64-row q tile) and
// loops over the kv tiles itself, keeping (m, l, acc) in registers:
//   - 4 warps, each owning 16 q rows; Q fragments stay in registers;
//   - K and V tiles of 64 rows are staged in shared memory by cp.async
//     (rows padded by 16 bytes, so ldmatrix is free of bank conflicts);
//   - S = Q K^T and O += P V run on the tensor cores (mma.sync m16n8k16,
//     bf16 in, fp32 accumulate); P is re-packed from the S accumulators
//     in registers, never through shared memory;
//   - the loop visits only kv tiles inside the causal bound (and the
//     window bound), the skip rule of the TPU kernel at this tile size;
//   - ragged tails (S or Sk not a multiple of 64) are masked and
//     zero-filled instead of being asserted away.
// Bound: about 4*B*H*S^2*D/2 causal FLOPs against the q+k+v+o bytes.  At
// the serving prompt of 512 the two bounds are close (bytes slightly
// ahead); FLOPs grow as S^2 and take over for longer prompts.  So the
// design reads q, k and v from device memory once per block, keeps both
// products on the tensor cores and everything between them in
// registers.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 64;       // kv rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 rows

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int Sk, int H,
                     int Hkv, int causal, int window, int q_offset,
                     float scale_log2) {
  constexpr int LD = D + 8;   // padded smem row, elements
  constexpr int CH = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBQ * LD;
  __nv_bfloat16* sV = sK + kBK * LD;

  // largest (most kv tiles) q tiles first: better tail under causality
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q_lo = qt * kBQ;
  const long q_rs = (long)H * D, k_rs = (long)Hkv * D;
  const __nv_bfloat16* qb = q + (long)b * S * q_rs + (long)h * D;
  const __nv_bfloat16* kb = k + (long)b * Sk * k_rs + (long)hk * D;
  const __nv_bfloat16* vb = v + (long)b * Sk * k_rs + (long)hk * D;

  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = q_lo + r < S;
    cp_async16(sQ + r * LD + c, ok ? qb + (long)(q_lo + r) * q_rs + c : qb,
               ok);
  }
  cp_async_wait_all();
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], sQ + (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                            kk * 16 + 8 * (lane >> 4));

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // this thread's two rows: g and g + 8 of the warp's 16
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int qp[2] = {q_offset + q_lo + wr + g, q_offset + q_lo + wr + g + 8};

  // kv tiles that can hold an allowed key for some row of this block
  const int qpos_first = q_offset + q_lo;
  const int qpos_last = q_offset + min(q_lo + kBQ, S) - 1;
  const int kv_end = causal ? min(Sk, qpos_last + 1) : Sk;
  const int kv_begin = window > 0 ? max(0, qpos_first - window + 1) : 0;

  for (int k_lo = (kv_begin / kBK) * kBK; k_lo < kv_end; k_lo += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = k_lo + r < Sk;
      const long off = (long)(k_lo + r) * k_rs + c;
      cp_async16(sK + r * LD + c, ok ? kb + off : kb, ok);
      cp_async16(sV + r * LD + c, ok ? vb + off : vb, ok);
    }
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBK / 8; j += 2) {
        uint32_t bf[4];
        ldmatrix_x4(bf, sK + (j * 8 + (lane & 7) + 8 * (lane >> 4)) * LD +
                            kk * 16 + 8 * ((lane >> 3) & 1));
        mma_bf16_16816(s[j], qf[kk], bf[0], bf[1]);
        mma_bf16_16816(s[j + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // mask, then the online-softmax update in the log2 domain
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k_lo + j * 8 + 2 * t + (e & 1);
        const int row = e >> 1;
        const bool ok = kp < Sk && (!causal || kp <= qp[row]) &&
                        (window <= 0 || kp > qp[row] - window);
        const float x = ok ? s[j][e] * scale_log2 : kNegInf;
        s[j][e] = x;
        mx[row] = fmaxf(mx[row], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const float m_new = fmaxf(m_r[row], quad_max(mx[row]));
      alpha[row] = exp2f(m_r[row] - m_new);
      m_r[row] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_r[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
    // l stays a per-thread partial sum: alpha is uniform across the quad
    l_r[0] = l_r[0] * alpha[0] + rs[0];
    l_r[1] = l_r[1] * alpha[1] + rs[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the S accumulators of n-tiles 2kk, 2kk+1 are exactly the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, sV + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                    n * 8 + 8 * (lane >> 4));
        mma_bf16_16816(acc[n], pa, bf[0], bf[1]);
        mma_bf16_16816(acc[n + 1], pa, bf[2], bf[3]);
      }
    }
  }

  const float inv[2] = {1.f / fmaxf(quad_sum(l_r[0]), 1e-30f),
                        1.f / fmaxf(quad_sum(l_r[1]), 1e-30f)};
  __nv_bfloat16* ob = o + (long)b * S * q_rs + (long)h * D;
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = q_lo + wr + g + 8 * row;
    if (r >= S) continue;
    __nv_bfloat16* orow = ob + (long)r * q_rs;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * row] * inv[row],
                                acc[n][2 * row + 1] * inv[row]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Sk, int H, int Hkv, int causal,
                   int window, int q_offset, cudaStream_t stream) {
  const int smem = (kBQ + 2 * kBK) * (D + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, Sk, H, Hkv, causal, window, q_offset, scale_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// q (B,S,H,D), k/v (B,Sk,Hkv,D), o (B,S,H,D); all bf16, contiguous,
// D = 64 or 128.  Returns the launch's cudaError_t (0 on success).
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
