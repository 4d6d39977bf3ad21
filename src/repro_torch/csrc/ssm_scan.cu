// Mamba-2 SSD chunked scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::_ssd_kernel (wrapper
// ssm_scan_fwd).  Same function: per head, with B and C shared across
// heads, an fp32 (hd, st) state carried over chunks in order, and for
// each chunk of c positions
//   cum   = cumsum(logdecay)                          (c,)
//   y     = (tril(exp(cum_t - cum_tau)) * C B^T) X    intra-chunk
//         + (C * exp(cum)) h^T                        inter-chunk
//   h     = exp(total) h + X^T (B * exp(total - cum)) state update
// every input cast to fp32 as the TPU kernel does; y in bf16, h_final fp32.
//
// Design.  The TPU grid (B, nh, chunks) runs the chunk axis in order and
// carries the state in VMEM scratch.  H100 blocks run in no order, and
// the chunk order is a true dependency, so one thread block owns one
// (head, batch) and loops over the chunks itself, the state in shared
// memory:
//   - each chunk's X (c x hd), B and C (c x st) and logdecay are staged
//     into shared memory as fp32, positions at or beyond S zero-filled
//     (logdecay 0, so the ragged last chunk needs no S % c == 0);
//   - cum is a warp scan; exp(total - cum) is computed once per chunk;
//   - y: one warp per output row t (rows dealt out so that every warp gets
//     long and short rows alike), each lane holding hd/32 columns.  The
//     lanes compute g[t, tau] = exp(cum_t - cum_tau) * (C_t . B_tau) for
//     32 keys tau at a time and broadcast them by shuffle; keys above the
//     diagonal are never passed to exp (select, not multiply), so a
//     strong decay cannot turn inf * 0 into NaN;
//   - the state update runs after every row has read the old state;
//   - 1024 threads per block: at serving shapes each SM runs one block,
//     and 32 warps are what hides the latency of the row loop's shuffles
//     and shared-memory reads (each warp's FMAs wait on both).
// B and C rows are padded to st + 1 floats, so the lanes' reads of 32
// different keys fall into 32 different banks.
//
// Bound.  At the serving shapes (B=4, S=1536, nh=25, hd=64, st=16) the
// kernel must move about 41 MB (xv and y 19.7 MB each, logdecay 0.6 MB,
// B/C 0.4 MB, h_final 0.4 MB): 0.012 ms at 3.35 TB/s.  Its operations
// (about 2.2 GFLOP at chunk 64) take 0.002 ms at the bf16 tensor-core
// peak, but about 0.033 ms at the fp32 CUDA-core rate this kernel runs
// at: the arithmetic is fp32 FMAs, as the reference's fp32 g and h
// require at this PR's tolerances.  B*nh = 100 blocks leave 32 of the 132
// SMs idle; splitting the scan into chunk-state, state-passing and
// chunk-output kernels would fill the card.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 1024;  // 32 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 256;
constexpr int kMaxHD = 128;
constexpr int kMaxST = 64;
constexpr int kPerLane = kMaxHD / 32;  // y columns per lane
constexpr int kMaxSmem = 232448;       // bytes a block may use on an H100

// shared floats: X (c x hd), B and C (c x (st+1)), cum and w (c), h (st x hd)
inline int smem_floats(int c, int hd, int st) {
  return c * hd + 2 * c * (st + 1) + 2 * c + st * hd;
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const __nv_bfloat16* __restrict__ xv,
                    const float* __restrict__ logdecay,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    const float* __restrict__ h0,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ h_out,
                    int S, int nh, int hd, int st, int c) {
  extern __shared__ __align__(16) float smem[];
  const int ldb = st + 1;
  float* sX = smem;              // [c][hd]
  float* sB = sX + c * hd;       // [c][st + 1]
  float* sC = sB + c * ldb;      // [c][st + 1]
  float* sCum = sC + c * ldb;    // [c]
  float* sW = sCum + c;          // [c]: exp(total - cum)
  float* sH = sW + c;            // [st][hd]: the state, transposed

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long x_rs = (long)nh * hd;  // xv / y stride between positions
  const __nv_bfloat16* xb = xv + (long)b * S * x_rs + (long)h * hd;
  __nv_bfloat16* yb = y + (long)b * S * x_rs + (long)h * hd;
  const float* ldp = logdecay + (long)b * S * nh + h;
  const __nv_bfloat16* Bb = Bm + (long)b * S * st;
  const __nv_bfloat16* Cb = Cm + (long)b * S * st;
  const long h_off = ((long)b * nh + h) * hd * st;

  for (int i = tid; i < hd * st; i += kThreads)  // i = d * st + s
    sH[(i % st) * hd + i / st] = h0 ? h0[h_off + i] : 0.f;

  const int xch = hd / 8;  // 16-byte chunks per X row
  const int n_chunks = (S + c - 1) / c;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int p0 = ci * c;
    const int valid = min(c, S - p0);
    __syncthreads();  // the previous chunk is done with the staging buffers

    for (int i = tid; i < c * xch; i += kThreads) {
      const int r = i / xch, col = (i % xch) * 8;
      float* dst = sX + r * hd + col;
      if (r < valid) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            xb + (long)(p0 + r) * x_rs + col);
        const __nv_bfloat162* p2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p2[e]);
          dst[2 * e] = f.x;
          dst[2 * e + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = 0.f;
      }
    }
    for (int i = tid; i < c * st; i += kThreads) {
      const int r = i / st, s = i % st;
      const bool ok = r < valid;
      const long off = (long)(p0 + r) * st + s;
      sB[r * ldb + s] = ok ? __bfloat162float(Bb[off]) : 0.f;
      sC[r * ldb + s] = ok ? __bfloat162float(Cb[off]) : 0.f;
    }
    if (warp == 0) {  // cum: inclusive scan of logdecay, 32 rows a step
      float carry = 0.f;
      for (int r0 = 0; r0 < c; r0 += 32) {
        const int r = r0 + lane;
        float v = r < valid ? ldp[(long)(p0 + r) * nh] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (r < c) sCum[r] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();

    const float total = sCum[c - 1];
    for (int r = tid; r < c; r += kThreads) sW[r] = expf(total - sCum[r]);

    // y: one warp per row t of the chunk.  Row t costs t + 1 keys, so
    // every other round of kWarps rows is dealt out in reverse, giving
    // each warp long and short rows alike.
    const int c_pad = (c + kWarps - 1) / kWarps * kWarps;
    for (int i = warp; i < c_pad; i += kWarps) {
      const int round = i / kWarps;
      const int t = (round & 1) ? round * kWarps + kWarps - 1 - warp : i;
      if (t >= valid) continue;  // warp-uniform: the shuffles stay converged
      const float cum_t = sCum[t];
      const float* ct = sC + t * ldb;
      float acc[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;
      // inter-chunk: exp(cum_t) * sum_s C[t, s] h[d, s]
      for (int s = 0; s < st; ++s) {
        const float cs = ct[s];
        const float* hs = sH + s * hd;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) acc[j] += cs * hs[d];
        }
      }
      const float et = expf(cum_t);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) acc[j] *= et;
      // intra-chunk: sum_{tau <= t} g[t, tau] X[tau, :]
      for (int k0 = 0; k0 <= t; k0 += 32) {
        const int k = k0 + lane;
        float gk = 0.f;
        if (k <= t) {  // mask before exp
          const float* bk = sB + k * ldb;
          float cb = 0.f;
          for (int s = 0; s < st; ++s) cb += ct[s] * bk[s];
          gk = expf(cum_t - sCum[k]) * cb;
        }
        const int kn = min(32, t - k0 + 1);
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          const float g = __shfl_sync(0xffffffffu, gk, kk);
          const float* xr = sX + (k0 + kk) * hd;
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) {
            const int d = lane + 32 * j;
            if (d < hd) acc[j] += g * xr[d];
          }
        }
      }
      __nv_bfloat16* yr = yb + (long)(p0 + t) * x_rs;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int d = lane + 32 * j;
        if (d < hd) yr[d] = __float2bfloat16(acc[j]);
      }
    }
    __syncthreads();  // every row has read the old state

    // state: h[d, s] = exp(total) h[d, s] + sum_r X[r, d] B[r, s] w[r]
    const float e_total = expf(total);
    for (int i = tid; i < hd * st; i += kThreads) {  // i = s * hd + d
      const int s = i / hd, d = i % hd;
      float a = 0.f;
#pragma unroll 4
      for (int r = 0; r < valid; ++r)
        a += sX[r * hd + d] * (sB[r * ldb + s] * sW[r]);
      sH[i] = sH[i] * e_total + a;
    }
  }
  __syncthreads();
  for (int i = tid; i < hd * st; i += kThreads)  // i = d * st + s
    h_out[h_off + i] = sH[(i % st) * hd + i / st];
}

}  // namespace
}  // namespace repro_torch

// xv (B,S,nh,hd) bf16, logdecay (B,S,nh) fp32, Bm/Cm (B,S,st) bf16, h0
// (B,nh,hd,st) fp32 or null (zero state), y (B,S,nh,hd) bf16, h_out
// (B,nh,hd,st) fp32; all contiguous.  hd % 8 == 0, hd <= 128, st <= 64,
// 1 <= chunk <= 256, S >= 1.  Returns the launch's cudaError_t (0 on
// success).
extern "C" int ssm_scan_fwd_bf16(const void* xv, const void* logdecay,
                                 const void* Bm, const void* Cm,
                                 const void* h0, void* y, void* h_out, int B,
                                 int S, int nh, int hd, int st, int chunk,
                                 void* stream) {
  using namespace repro_torch;
  if (S < 1 || hd % 8 != 0 || hd > kMaxHD || st < 1 || st > kMaxST ||
      chunk < 1 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  const int c = chunk < S ? chunk : S;
  const int smem = smem_floats(c, hd, st) * (int)sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nh, B);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xv),
      static_cast<const float*>(logdecay),
      static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(h0),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(h_out), S, nh, hd,
      st, c);
  return (int)cudaGetLastError();
}
