// Flash-decode attention for Hopper (sm_90a): one query token per
// sequence against a (B, Smax, Hkv, D) KV cache whose first `length`
// positions are valid.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (wrapper flash_decode_fwd).  Same function: fp32 scores scaled by
// D^-0.5, positions >= length masked with a finite -1e30, fp32 softmax
// weights, fp32 accumulation, output in the input dtype.
//
// Design.  The TPU grid walks kv blocks sequentially and merges (m, l, acc)
// in the same carry.  On the H100 blocks run in parallel in no order and
// B * Hkv blocks would leave most of the 132 SMs idle, so the cache range
// [0, length) is split (flash-decoding):
//   - flash_decode_split_kernel: one block per (split, kv head, batch)
//     covers all G q heads of that kv head, walks its range in 64-key
//     tiles staged in shared memory by cp.async (nothing at or beyond
//     `length` is read), and writes fp32 partial (m, l, acc) to scratch;
//   - flash_decode_combine_kernel: one block per (batch, q head) merges the
//     splits in a fixed order, so results are deterministic like the
//     reference's sequential carry.
// Bound: bytes.  Each key brings 2*D*2 bytes of K and V for 4*G*D FLOPs
// (about 6 FLOP/byte at G = 6), far below the card's ridge, so the
// products run on the CUDA cores in fp32 and the design only has to keep
// enough blocks in flight to stream the cache at full rate.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;
constexpr int kMaxG = 8;       // q heads per kv head

template <int D>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int H, int Hkv,
    int Smax, int length, int keys_per_split, float scale) {
  constexpr int LDK = D + 8;  // padded K rows: conflict-free 16-byte reads
  constexpr int CH = D / 8;
  __shared__ __align__(16) __nv_bfloat16 sK[kBK * LDK];
  __shared__ __align__(16) __nv_bfloat16 sV[kBK * D];
  __shared__ float sQ[kMaxG][D];
  __shared__ float sS[kMaxG][kBK];
  __shared__ float sM[kMaxG], sL[kMaxG], sA[kMaxG];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x;
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < G * D; i += kThreads)
    sQ[i / D][i % D] =
        __bfloat162float(q[((long)b * H + hk * G + i / D) * D + i % D]);
  if (tid < kMaxG) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg) acc[gg] = 0.f;

  const long rs = (long)Hkv * D;
  const __nv_bfloat16* kb = kc + (long)b * Smax * rs + (long)hk * D;
  const __nv_bfloat16* vb = vc + (long)b * Smax * rs + (long)hk * D;
  const int start = split * keys_per_split;
  const int stop = min(length, start + keys_per_split);

  for (int k_lo = start; k_lo < stop; k_lo += kBK) {
    __syncthreads();  // previous tile fully consumed; sQ/sM visible
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = k_lo + r < stop;
      const long off = (long)(k_lo + r) * rs + c;
      cp_async16(sK + r * LDK + c, ok ? kb + off : kb, ok);
      cp_async16(sV + r * D + c, ok ? vb + off : vb, ok);
    }
    cp_async_wait_all();
    __syncthreads();

    // scores: thread -> one key, half of the G heads
    {
      const int key = tid & (kBK - 1), gs = tid / kBK;
      const bool valid = k_lo + key < stop;
      for (int gg = gs; gg < G; gg += kThreads / kBK) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(sK + key * LDK + c);
          const __nv_bfloat162* p2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p2[e]);
            dot += f.x * sQ[gg][c + 2 * e] + f.y * sQ[gg][c + 2 * e + 1];
          }
        }
        sS[gg][key] = valid ? dot * scale : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax update: one warp per head
    for (int gg = warp; gg < G; gg += kThreads / 32) {
      const float s0 = sS[gg][lane], s1 = sS[gg][lane + 32];
      const float m_old = sM[gg];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sS[gg][lane] = p0;
      sS[gg][lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        sA[gg] = a;
        sL[gg] = sL[gg] * a + sum;
        sM[gg] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: thread -> one dim (at D = 64 the upper
    // half of the block idles here; correct, not yet fast)
    if (tid < D) {
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg) {
        if (gg < G) {
          float pv = 0.f;
#pragma unroll 8
          for (int key = 0; key < kBK; ++key)
            pv += sS[gg][key] * __bfloat162float(sV[key * D + tid]);
          acc[gg] = acc[gg] * sA[gg] + pv;
        }
      }
    }
  }
  __syncthreads();

  const long row0 = (long)b * H + hk * G;  // first q head of this kv head
  if (tid < D) {
#pragma unroll
    for (int gg = 0; gg < kMaxG; ++gg)
      if (gg < G) part_acc[((row0 + gg) * NS + split) * D + tid] = acc[gg];
  }
  if (tid < G) {
    part_m[(row0 + tid) * NS + split] = sM[tid];
    part_l[(row0 + tid) * NS + split] = sL[tid];
  }
}

// one block per (batch, q head): merge the splits in order
__global__ void flash_decode_combine_kernel(const float* __restrict__ part_m,
                                            const float* __restrict__ part_l,
                                            const float* __restrict__ part_acc,
                                            __nv_bfloat16* __restrict__ out,
                                            int NS, int D) {
  const long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + bh * NS;
  const float* pl = part_l + bh * NS;
  float m = kNegInf;
  for (int s = 0; s < NS; ++s) m = fmaxf(m, pm[s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < NS; ++s) {
    const float w = expf(pm[s] - m);
    l += pl[s] * w;
    a += part_acc[(bh * NS + s) * D + d] * w;
  }
  out[bh * D + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
}

template <int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* out,
                   float* part_m, float* part_l, float* part_acc, int B,
                   int H, int Hkv, int Smax, int length, int n_splits,
                   int keys_per_split, cudaStream_t stream) {
  const dim3 grid(n_splits, Hkv, B);
  flash_decode_split_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), part_m, part_l, part_acc, H, Hkv,
      Smax, length, keys_per_split, 1.f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<<<B * H, D, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<__nv_bfloat16*>(out), n_splits,
      D);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// q (B,H,D), caches (B,Smax,Hkv,D), out (B,H,D): bf16, contiguous,
// D = 64 or 128.
// part_m/part_l (B,H,n_splits) and part_acc (B,H,n_splits,D): fp32
// scratch.  Split s covers keys [s*keys_per_split, (s+1)*keys_per_split)
// clipped to `length`; keys_per_split is a multiple of 64.
// Returns the launches' cudaError_t (0 on success).
extern "C" int flash_decode_fwd_bf16(const void* q, const void* kc,
                                     const void* vc, void* out, void* part_m,
                                     void* part_l, void* part_acc, int B,
                                     int H, int Hkv, int Smax, int D,
                                     int length, int n_splits,
                                     int keys_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (H % Hkv != 0 || H / Hkv > repro_torch::kMaxG)
    return (int)cudaErrorInvalidValue;
  if (D == 64)
    return repro_torch::launch<64>(q, kc, vc, out, pm, pl, pa, B, H, Hkv,
                                   Smax, length, n_splits, keys_per_split, st);
  if (D == 128)
    return repro_torch::launch<128>(q, kc, vc, out, pm, pl, pa, B, H, Hkv,
                                    Smax, length, n_splits, keys_per_split,
                                    st);
  return (int)cudaErrorInvalidValue;
}
