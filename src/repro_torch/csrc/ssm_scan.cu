// Mamba-2 SSD chunked scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::_ssd_kernel (wrapper
// ssm_scan_fwd).  Same function: per head, with B and C shared across
// heads, an fp32 (hd, st) state carried over chunks in order, and for
// each chunk of c positions
//   cum   = cumsum(logdecay)                          (c,)
//   y     = (L * C B^T) X + exp(cum) * (C h^T)        L = tril(exp(cum_t - cum_tau))
//   h     = exp(total) h + X^T (B * exp(total - cum)) state update
// y in bf16, h_final fp32; a ragged last chunk is zero-filled (logdecay 0).
//
// Bound.  At the serving shape (B=4, S=1536, nh=25, hd=64, st=16, chunk
// 64) the function moves about 41 MB (xv and y 19.7 MB each, logdecay
// 0.6 MB, B/C 0.4 MB, h_final 0.4 MB): 0.0122 ms at 3.35 TB/s.  Its 1.3
// GFLOP take 0.0013 ms on the bf16 tensor cores.  It is bound by bytes.
//
// Design: the SSD decomposition, three launches on the current stream,
// every part except the h recurrence parallel over (batch, chunk, head).
//   1. ssd_chunk_state_kernel, one block per (b, chunk, group of heads):
//      cum (a warp scan per head), total, and the chunk's own state
//      contribution S_i = X_i^T (B_i * exp(total - cum)) on the tensor
//      cores, written with exp(total) to an fp32 workspace.
//   2. ssd_state_pass_kernel, one thread per (b, head, d, s): the fp32
//      recurrence h_i = exp(total_i) h_{i-1} + S_i over the chunks in
//      order, writing the state that enters each chunk over S_i, and
//      h_final.  Loads run 8 chunks ahead of the FMA chain.
//   3. ssd_chunk_out_kernel, one block per (b, chunk, group of heads):
//      C B^T once per block for all heads of the group (B and C are
//      shared), then per head y = (L * C B^T) X + exp(cum) (C h^T).
// What each part does about the limits of the one-block-per-(head,
// batch) kernel it replaces:
//   - grid: B * chunks * groups blocks (1248 at the serving shape with 2
//     heads per block) instead of B * nh = 100 serial walks of 24 chunks;
//     only step 2's 102,400 short fp32 chains keep the chunk order;
//   - products: all four (X^T (B w), C B^T, G X, C h^T) run on mma.sync
//     m16n8k16 in bf16 with fp32 accumulation, fed by ldmatrix; B * w and
//     the split state are built once per block in shared memory, and the
//     output's causal row tiles are paired so that every warp does the
//     same work; nothing feeds an FMA from shared memory element by
//     element;
//   - stalls: every load of a block is issued up front with cp.async
//     (B, C, logdecay and the entering states in a first commit group,
//     then one group per head's X), so head h+1 loads while head h
//     computes; cum is a warp scan per head, all heads' in parallel;
//     y leaves in full 32-byte sectors;
//   - the fp32 CUDA-core rate no longer bounds it: the tensor cores do.
// Tried and measured on an H100 (700 W), kept out: heads per block 1 and
// 3-8 (2 is fastest at the serving shape); persistent blocks walking the
// items with a two-stage cp.async ring (the doubled shared memory halved
// the blocks per SM and was slower).  What holds it back is each block's
// serial chain of load, wait, compute and store at 4-8 blocks per SM;
// see PERF.md.
// Rounding: C B^T has bf16 operands and loses nothing; G = L * C B^T and
// B * w are fp32 and are rounded to bf16 as operands (2^-9 relative); the
// entering state h is split into bf16 hi + lo, two products, since
// rounded alone it fails the per-row check of the JAX package's
// tolerances on long prompts; the state carried between chunks is never
// rounded.  The mask goes in before exp, as a select, so a strong decay
// cannot make inf * 0.  No atomics: a repeat is bitwise equal.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;  // steps 1 and 3: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBand = 16 * kWarps;  // rows of C B^T a block holds at once
constexpr int kPassThreads = 256;   // step 2
constexpr int kPassAhead = 8;       // chunks step 2 loads ahead
constexpr int kMaxChunk = 256;
constexpr int kMaxHD = 128;
constexpr int kMaxST = 128;
constexpr int kMaxHeads = 2;  // heads per block: one per pair of warps
static_assert(kWarps == 2 * kMaxHeads, "step 3 gives each head two warps");
constexpr int kMaxSmem = 232448;       // bytes a block may use on an H100
constexpr float kLog2e = 1.4426950408889634f;

struct Dims {
  int B, S, nh, hd, st, c;         // c: positions per chunk
  int c_pad, hd_pad, st_pad;       // each rounded up to 16
  int n_chunks, hpb, n_groups;     // hpb: heads per block
  int ldx;                         // X row stride in shared memory
};

inline int up16(int x) { return (x + 15) / 16 * 16; }

// The shared-memory carve-up of steps 1 and 3: byte offsets of each
// region and where the last ends.  bf16 rows of B, C, B * w and the
// states are padded by 8 (16 bytes), so ldmatrix's 8 row reads fall into
// 8 different bank groups; X's row stride d.ldx comes from the launch
// plan (kernels/ssm_scan.py), whose byte counts the launcher holds
// against `end`.
struct StateSmem {
  int x, b, bw, w, end;  // X per head, B, B * w per head, w per head
};
struct OutSmem {
  // X per head, C, B, the entering states per head as bf16 hi and lo,
  // cum per head, and a region that holds first the entering states in
  // fp32, then one band of C B^T in fp32
  int x, c, b, hi, lo, cum, cb, end;
};

__host__ __device__ __forceinline__ StateSmem state_smem(const Dims& d) {
  const int ldb = d.st_pad + 8;
  StateSmem m;
  m.x = 0;
  m.b = m.x + 2 * d.hpb * d.c_pad * d.ldx;
  m.bw = m.b + 2 * d.c_pad * ldb;
  m.w = m.bw + 2 * d.hpb * d.c_pad * ldb;
  m.end = m.w + 4 * d.hpb * d.c_pad;
  return m;
}

__host__ __device__ __forceinline__ OutSmem out_smem(const Dims& d) {
  const int ldb = d.st_pad + 8;
  const int band = 4 * kBand * (d.c_pad + 8), h32 = 4 * d.hpb * d.hd * d.st;
  OutSmem m;
  m.x = 0;
  m.c = m.x + 2 * d.hpb * d.c_pad * d.ldx;
  m.b = m.c + 2 * d.c_pad * ldb;
  m.hi = m.b + 2 * d.c_pad * ldb;
  m.lo = m.hi + 2 * d.hpb * d.hd_pad * ldb;
  m.cum = m.lo + 2 * d.hpb * d.hd_pad * ldb;
  m.cb = m.cum + 4 * d.hpb * d.c_pad;
  m.end = m.cb + (band > h32 ? band : h32);
  return m;
}

// 4-byte global -> shared copy; with pred false the 4 bytes are zeroed
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// wait until at most n (0 <= n <= kMaxHeads) commit groups are pending
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<kMaxHeads>(); break;
  }
}

// The (row, col) cells of a [rows][cols] grid that thread t visits, t,
// t + kThreads, ...: one division when it starts, none per step.
struct Walk {
  int r, c;
  const int cols, dr, dc;
  __device__ __forceinline__ explicit Walk(int n_cols)
      : r(threadIdx.x / n_cols),
        c(threadIdx.x % n_cols),
        cols(n_cols),
        dr(kThreads / n_cols),
        dc(kThreads % n_cols) {}
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// Issue the X tiles of heads [h_first, h_first + nhb) of one chunk into
// sX ([head][c_pad][ldx] bf16), one cp.async commit group per head; rows
// at or beyond `valid` and columns at or beyond hd are zero-filled.
__device__ __forceinline__ void load_x(__nv_bfloat16* sX,
                                       const __nv_bfloat16* xv, const Dims& d,
                                       int b, int p0, int valid, int h_first,
                                       int nhb) {
  const int ldx = d.ldx, xch = d.hd_pad / 8;
  const long x_rs = (long)d.nh * d.hd;
  for (int hh = 0; hh < nhb; ++hh) {
    const __nv_bfloat16* src0 =
        xv + ((long)b * d.S + p0) * x_rs + (long)(h_first + hh) * d.hd;
    __nv_bfloat16* dst0 = sX + hh * d.c_pad * ldx;
    for (Walk w(xch); w.r < d.c_pad; w.next()) {
      const int col = w.c * 8;
      const bool ok = w.r < valid && col < d.hd;
      cp_async16(dst0 + w.r * ldx + col, ok ? src0 + w.r * x_rs + col : xv,
                 ok);
    }
    cp_async_commit();
  }
}

// Issue one chunk's rows of a (B, S, st) bf16 matrix into [c_pad][ldb]
// shared memory, zero-filled beyond `valid` rows and st columns: cp.async
// where rows are 16-byte aligned (st % 8 == 0), else plain loads.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          const Dims& d, int b, int p0,
                                          int valid) {
  const int ldb = d.st_pad + 8;
  const __nv_bfloat16* s0 = src + ((long)b * d.S + p0) * d.st;
  if (d.st % 8 == 0) {
    for (Walk w(d.st_pad / 8); w.r < d.c_pad; w.next()) {
      const int col = w.c * 8;
      const bool ok = w.r < valid && col < d.st;
      cp_async16(dst + w.r * ldb + col,
                 ok ? s0 + (long)w.r * d.st + col : src, ok);
    }
    return;
  }
  for (Walk w(d.st_pad); w.r < d.c_pad; w.next())
    dst[w.r * ldb + w.c] = (w.r < valid && w.c < d.st)
                               ? s0[(long)w.r * d.st + w.c]  // kstruct: load 2
                               : __float2bfloat16(0.f);
}

// Issue one chunk's logdecay of heads [h_first, h_first + nhb) into
// sLd ([head][c_pad]), 0 at and beyond `valid`.
__device__ __forceinline__ void load_logdecay(float* sLd,
                                              const float* logdecay,
                                              const Dims& d, int b, int p0,
                                              int valid, int h_first,
                                              int nhb) {
  const float* l0 = logdecay + ((long)b * d.S + p0) * d.nh + h_first;
  for (Walk w(nhb); w.r < d.c_pad; w.next()) {  // neighbours read
    const bool ok = w.r < valid;                  // neighbours
    cp_async4(sLd + w.c * d.c_pad + w.r,
              ok ? l0 + (long)w.r * d.nh + w.c : logdecay, ok);
  }
}

// cum in place over sCum ([head][c_pad], logdecay on entry), times
// `scale`: one warp per head, an inclusive scan 32 rows a step.
// sCum[hh][c_pad - 1] is then the chunk's total (times scale).
__device__ __forceinline__ void chunk_cumsum(float* sCum, const Dims& d,
                                             int nhb, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int hh = warp; hh < nhb; hh += kWarps) {
    float* cum = sCum + hh * d.c_pad;
    float carry = 0.f;
    for (int r0 = 0; r0 < d.c_pad; r0 += 32) {
      const int r = r0 + lane;
      float v = r < d.c_pad ? cum[r] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (r < d.c_pad) cum[r] = v * scale;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

// Step 1: S_i = X^T (B * exp(total - cum)) per head, (hd, st) fp32, into
// states[b][chunk][head]; exp(total) into decay[b][chunk][head].  B * w
// is built once per head into shared memory (bf16) and both operands come
// from ldmatrix.  KS is the number of 16-wide k tiles of st the
// accumulators hold.
template <int KS>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_kernel(const __nv_bfloat16* __restrict__ xv,
                           const float* __restrict__ logdecay,
                           const __nv_bfloat16* __restrict__ Bm,
                           float* __restrict__ states,
                           float* __restrict__ decay, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = d.ldx, ldb = d.st_pad + 8;
  const StateSmem m = state_smem(d);
  auto* sX = reinterpret_cast<__nv_bfloat16*>(smem + m.x);
  auto* sB = reinterpret_cast<__nv_bfloat16*>(smem + m.b);
  auto* sBw = reinterpret_cast<__nv_bfloat16*>(smem + m.bw);  // [head][tau][s]
  auto* sW = reinterpret_cast<float*>(smem + m.w);

  const int grp = blockIdx.x % d.n_groups;
  const int ci = (blockIdx.x / d.n_groups) % d.n_chunks;
  const int b = blockIdx.x / (d.n_groups * d.n_chunks);
  const int h_first = grp * d.hpb, nhb = min(d.hpb, d.nh - h_first);
  const int p0 = ci * d.c, valid = min(d.c, d.S - p0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;

  // every load is issued up front: B and logdecay first, then one
  // commit group per head's X
  load_rows(sB, Bm, d, b, p0, valid);
  load_logdecay(sW, logdecay, d, b, p0, valid, h_first, nhb);
  cp_async_commit();
  load_x(sX, xv, d, b, p0, valid, h_first, nhb);
  cp_async_wait_dyn(nhb);
  __syncthreads();  // B and logdecay are in shared memory
  chunk_cumsum(sW, d, nhb, 1.f);
  for (int hh = warp; hh < nhb; hh += kWarps) {  // w = exp(total - cum)
    float* w = sW + hh * d.c_pad;
    const float total = w[d.c_pad - 1];
    __syncwarp();
    for (int r = lane; r < d.c_pad; r += 32) w[r] = expf(total - w[r]);
    if (lane == 0)
      decay[((long)b * d.n_chunks + ci) * d.nh + h_first + hh] = expf(total);  // kstruct: store 4
  }
  __syncthreads();
  // B * w in bf16, two columns a thread at a time
  for (int hh = 0; hh < nhb; ++hh) {
    for (Walk w(d.st_pad / 2); w.r < d.c_pad; w.next()) {
      const int s = 2 * w.c;
      const float wr = sW[hh * d.c_pad + w.r];
      const float2 bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sB + w.r * ldb + s));
      *reinterpret_cast<uint32_t*>(sBw + (hh * d.c_pad + w.r) * ldb + s) =
          pack_bf16x2(bv.x * wr, bv.y * wr);
    }
  }

  const int n_kt = d.c_pad / 16, n_nt = d.st_pad / 8;
  for (int hh = 0; hh < nhb; ++hh) {
    cp_async_wait_dyn(nhb - 1 - hh);
    __syncthreads();  // head hh's X (and every B * w) is in shared memory
    const __nv_bfloat16* x = sX + hh * d.c_pad * ldx;
    const __nv_bfloat16* bw = sBw + hh * d.c_pad * ldb;
    float* out = states +
                 (((long)b * d.n_chunks + ci) * d.nh + h_first + hh) * d.hd *
                     d.st;
    // warp's m tiles: 16 rows of d each; k runs over the chunk's rows
    for (int mt = warp; mt < d.hd_pad / 16; mt += kWarps) {
      float acc[2 * KS][4];
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int kt = 0; kt < n_kt; ++kt) {
        uint32_t a[4];  // X^T: X is stored [tau][d], so transposed loads
        ldmatrix_x4_trans(a, x + (kt * 16 + (lane & 7) + 8 * (lane >> 4)) *
                                     ldx +
                                 mt * 16 + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int n = 0; n < 2 * KS; n += 2) {
          if (n < n_nt) {  // B * w is stored [tau][s]: transposed loads
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, bw + (kt * 16 + (lane & 7) +
                                        8 * ((lane >> 3) & 1)) * ldb +
                                      n * 8 + 8 * (lane >> 4));
            mma_bf16_16816(acc[n], a, bf[0], bf[1]);
            mma_bf16_16816(acc[n + 1], a, bf[2], bf[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        if (n < n_nt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int dd = mt * 16 + g + 8 * hf;
            const int s = n * 8 + 2 * q;
            float* o = out + dd * d.st + s;
            if (dd >= d.hd || s >= d.st) continue;
            if (d.st % 2 == 0) {  // a quad's 4 float2 fill a 32-byte sector
              *reinterpret_cast<float2*>(o) =  // kstruct: store 8
                  make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
            } else {
              o[0] = acc[n][2 * hf];  // kstruct: store 4
              if (s + 1 < d.st) o[1] = acc[n][2 * hf + 1];  // kstruct: store 4
            }
          }
        }
      }
    }
  }
}

// Step 2: one thread per (b, head, e = d * st + s).  states[b][i][head]
// holds S_i on entry and the state entering chunk i on exit.
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass_kernel(const float* __restrict__ h0,
                          float* __restrict__ states,
                          const float* __restrict__ decay,
                          float* __restrict__ h_out, int B, int nh, int hdst,
                          int n_chunks) {
  const long idx = (long)blockIdx.x * kPassThreads + threadIdx.x;
  if (idx >= (long)B * nh * hdst) return;
  const int e = (int)(idx % hdst);
  const long bh = idx / hdst;
  const int h = (int)(bh % nh), b = (int)(bh / nh);
  float* p = states + ((long)b * n_chunks * nh + h) * hdst + e;
  const float* a = decay + (long)b * n_chunks * nh + h;
  const long ps = (long)nh * hdst;  // stride of one chunk
  float hc = h0 ? h0[idx] : 0.f;  // kstruct: load 4
  for (int i0 = 0; i0 < n_chunks; i0 += kPassAhead) {  // kstruct: grid:chunks
    float sv[kPassAhead], av[kPassAhead];
#pragma unroll
    for (int j = 0; j < kPassAhead; ++j) {
      const bool ok = i0 + j < n_chunks;
      sv[j] = ok ? p[(i0 + j) * ps] : 0.f;  // kstruct: load 4
      av[j] = ok ? a[(long)(i0 + j) * nh] : 0.f;  // kstruct: load 4
    }
#pragma unroll
    for (int j = 0; j < kPassAhead; ++j) {
      if (i0 + j < n_chunks) {
        p[(i0 + j) * ps] = hc;  // kstruct: store 4
        hc = av[j] * hc + sv[j];
      }
    }
  }
  h_out[idx] = hc;  // kstruct: store 4
}

// The entering states of the group's heads, fp32 in shared memory as the
// workspace holds them ([head][d][s]), as bf16 hi + lo ([head][hd_pad][ldb],
// zero-padded) for ldmatrix.
__device__ __forceinline__ void split_states(__nv_bfloat16* sHi,
                                             __nv_bfloat16* sLo,
                                             const float* sH32, const Dims& d,
                                             int nhb) {
  const int ldb = d.st_pad + 8;
  for (int hh = 0; hh < nhb; ++hh) {
    for (Walk w(d.st_pad / 2); w.r < d.hd_pad; w.next()) {
      const int dd = w.r, s = 2 * w.c;
      const float* src = sH32 + (hh * d.hd + dd) * d.st + s;
      const bool ok = dd < d.hd;
      const float v0 = ok && s < d.st ? src[0] : 0.f;
      const float v1 = ok && s + 1 < d.st ? src[1] : 0.f;
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
      const float2 back = __bfloat1622float2(h2);
      const int off = (hh * d.hd_pad + dd) * ldb + s;
      *reinterpret_cast<__nv_bfloat162*>(sHi + off) = h2;
      *reinterpret_cast<uint32_t*>(sLo + off) =
          pack_bf16x2(v0 - back.x, v1 - back.y);
    }
  }
}

// Step 3: y = (L * C B^T) X + exp(cum) (C h^T) for each head of the group.
// The block walks the chunk in bands of 64 rows (4 tiles of 16).  Each
// warp computes one tile's rows of C B^T per band into sCB, once for all
// heads.  Then the group's heads (at most two) run together: warps 0-1
// take the first, warps 2-3 the second, and each warp owns the tiles
// {j, 3 - j} of the band, so every warp does 5 of the band's 10 causal
// (row, key) tiles.  NT is the number
// of 8-wide column tiles of hd the accumulators hold, KS the number of
// 16-wide k tiles of st.
template <int NT, int KS>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_out_kernel(const __nv_bfloat16* __restrict__ xv,
                         const float* __restrict__ logdecay,
                         const __nv_bfloat16* __restrict__ Bm,
                         const __nv_bfloat16* __restrict__ Cm,
                         const float* __restrict__ states,
                         __nv_bfloat16* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = d.ldx, ldb = d.st_pad + 8, ldcb = d.c_pad + 8;
  const OutSmem m = out_smem(d);
  auto* sX = reinterpret_cast<__nv_bfloat16*>(smem + m.x);
  auto* sC = reinterpret_cast<__nv_bfloat16*>(smem + m.c);
  auto* sB = reinterpret_cast<__nv_bfloat16*>(smem + m.b);
  auto* sHi = reinterpret_cast<__nv_bfloat16*>(smem + m.hi);  // [head][d][s]
  auto* sLo = reinterpret_cast<__nv_bfloat16*>(smem + m.lo);
  auto* sCum = reinterpret_cast<float*>(smem + m.cum);
  auto* sCB = reinterpret_cast<float*>(smem + m.cb);  // [band row][key]
  float* sH32 = sCB;  // the entering states, before the first band

  const int grp = blockIdx.x % d.n_groups;
  const int ci = (blockIdx.x / d.n_groups) % d.n_chunks;
  const int b = blockIdx.x / (d.n_groups * d.n_chunks);
  const int h_first = grp * d.hpb, nhb = min(d.hpb, d.nh - h_first);
  const int p0 = ci * d.c, valid = min(d.c, d.S - p0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;

  // every load is issued up front: C, B, logdecay and the entering states
  // (fp32, contiguous for the group) first, then one commit group per
  // head's X
  load_rows(sC, Cm, d, b, p0, valid);
  load_rows(sB, Bm, d, b, p0, valid);
  load_logdecay(sCum, logdecay, d, b, p0, valid, h_first, nhb);
  const float* hin =
      states + (((long)b * d.n_chunks + ci) * d.nh + h_first) * d.hd * d.st;
  for (int i = threadIdx.x; i < nhb * d.hd * d.st / 4; i += kThreads)
    cp_async16(sH32 + 4 * i, hin + 4 * i, true);
  cp_async_commit();
  load_x(sX, xv, d, b, p0, valid, h_first, nhb);
  cp_async_wait_dyn(nhb);
  __syncthreads();  // C, B, logdecay and the states are in shared memory
  split_states(sHi, sLo, sH32, d, nhb);
  chunk_cumsum(sCum, d, nhb, kLog2e);  // cum in log2 units, for ex2
  __syncthreads();  // sH32 is free for C B^T

  const int n_sk = d.st_pad / 16, n_nt = d.hd_pad / 8;
  for (int band = 0; band * kBand < d.c_pad; ++band) {
    if (band > 0) __syncthreads();  // every warp is done with sCB
    {  // this warp's tile of C B^T, keys up to its diagonal, fp32 (exact)
      const int mt = band * kWarps + warp;
      if (mt * 16 < d.c_pad) {
        uint32_t cf[KS][4];
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          if (kk < n_sk)
            ldmatrix_x4(cf[kk], sC + (mt * 16 + (lane & 7) +
                                      8 * ((lane >> 3) & 1)) * ldb +
                                    kk * 16 + 8 * (lane >> 4));
        float* cbw = sCB + warp * 16 * ldcb;
        for (int j = 0; j <= mt; ++j) {
          float s[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            if (kk < n_sk) {
              uint32_t bf[4];
              ldmatrix_x4(bf, sB + (j * 16 + (lane & 7) + 8 * (lane >> 4)) *
                                       ldb +
                                   kk * 16 + 8 * ((lane >> 3) & 1));
              mma_bf16_16816(s[0], cf[kk], bf[0], bf[1]);
              mma_bf16_16816(s[1], cf[kk], bf[2], bf[3]);
            }
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = j * 16 + n * 8 + 2 * q;
            *reinterpret_cast<float2*>(cbw + g * ldcb + col) =
                make_float2(s[n][0], s[n][1]);
            *reinterpret_cast<float2*>(cbw + (g + 8) * ldcb + col) =
                make_float2(s[n][2], s[n][3]);
          }
        }
      }
    }
    if (band > 0) __syncthreads();  // sCB is written (band 0: below)

    if (band == 0) {
      cp_async_wait<0>();
      __syncthreads();  // every head's X, and sCB, hi/lo, cum
    }
    {
      const int hh = warp >> 1;
      if (hh >= nhb) continue;
      const __nv_bfloat16* x = sX + hh * d.c_pad * ldx;
      const __nv_bfloat16* hi = sHi + hh * d.hd_pad * ldb;
      const __nv_bfloat16* lo = sLo + hh * d.hd_pad * ldb;
      const float* cum = sCum + hh * d.c_pad;
      __nv_bfloat16* yh = y + ((long)b * d.S + p0) * d.nh * d.hd +
                          (long)(h_first + hh) * d.hd;
#pragma unroll 1
      for (int side = 0; side < 2; ++side) {
        const int tb = side == 0 ? (warp & 1) : kWarps - 1 - (warp & 1);
        const int mt = band * kWarps + tb;
        if (mt * 16 >= d.c_pad) continue;
        const float* cbw = sCB + tb * 16 * ldcb;
        uint32_t cf[KS][4];
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          if (kk < n_sk)
            ldmatrix_x4(cf[kk], sC + (mt * 16 + (lane & 7) +
                                      8 * ((lane >> 3) & 1)) * ldb +
                                    kk * 16 + 8 * (lane >> 4));
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
          acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        // inter-chunk: C h^T with h as bf16 hi + lo (stored [d][s]), then
        // rows times exp(cum_t)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          if (kk < n_sk) {
#pragma unroll
            for (int n = 0; n < NT; n += 2) {
              if (n < n_nt) {
                const int off = (n * 8 + (lane & 7) + 8 * (lane >> 4)) * ldb +
                                kk * 16 + 8 * ((lane >> 3) & 1);
                uint32_t bh[4], bl[4];
                ldmatrix_x4(bh, hi + off);
                ldmatrix_x4(bl, lo + off);
                mma_bf16_16816(acc[n], cf[kk], bh[0], bh[1]);
                mma_bf16_16816(acc[n + 1], cf[kk], bh[2], bh[3]);
                mma_bf16_16816(acc[n], cf[kk], bl[0], bl[1]);
                mma_bf16_16816(acc[n + 1], cf[kk], bl[2], bl[3]);
              }
            }
          }
        }
        const int t0 = mt * 16 + g, t1 = t0 + 8;
        const float ct0 = cum[t0], ct1 = cum[t1];
        const float e0 = ex2(ct0), e1 = ex2(ct1);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][0] *= e0;
          acc[n][1] *= e0;
          acc[n][2] *= e1;
          acc[n][3] *= e1;
        }
        // intra-chunk: G = L * C B^T, rounded to bf16 in registers as the
        // A operand; keys above the diagonal are selected away before ex2
        for (int j = 0; j <= mt; ++j) {
          float gv[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int k = j * 16 + n * 8 + 2 * q;
            const float2 r0 =
                *reinterpret_cast<const float2*>(cbw + g * ldcb + k);
            const float2 r1 =
                *reinterpret_cast<const float2*>(cbw + (g + 8) * ldcb + k);
            const float2 ck = *reinterpret_cast<const float2*>(cum + k);
            gv[n][0] = k <= t0 ? ex2(ct0 - ck.x) * r0.x : 0.f;
            gv[n][1] = k + 1 <= t0 ? ex2(ct0 - ck.y) * r0.y : 0.f;
            gv[n][2] = k <= t1 ? ex2(ct1 - ck.x) * r1.x : 0.f;
            gv[n][3] = k + 1 <= t1 ? ex2(ct1 - ck.y) * r1.y : 0.f;
          }
          const uint32_t pa[4] = {pack_bf16x2(gv[0][0], gv[0][1]),
                                  pack_bf16x2(gv[0][2], gv[0][3]),
                                  pack_bf16x2(gv[1][0], gv[1][1]),
                                  pack_bf16x2(gv[1][2], gv[1][3])};
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            if (n < n_nt) {
              uint32_t bf[4];
              ldmatrix_x4_trans(bf, x + (j * 16 + (lane & 7) +
                                         8 * ((lane >> 3) & 1)) * ldx +
                                        n * 8 + 8 * (lane >> 4));
              mma_bf16_16816(acc[n], pa, bf[0], bf[1]);
              mma_bf16_16816(acc[n + 1], pa, bf[2], bf[3]);
            }
          }
        }
        // y: the lanes of a quad swap halves so that each holds 4
        // neighbouring columns (8 bytes) and a quad's store fills a 32-byte
        // sector
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          if (n < n_nt) {
            const int src = (lane & ~3) | ((q & 1) * 2);
            const int col = n * 8 + 4 * q;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const uint32_t a = pack_bf16x2(acc[n][2 * r], acc[n][2 * r + 1]);
              const uint32_t c2 =
                  pack_bf16x2(acc[n + 1][2 * r], acc[n + 1][2 * r + 1]);
              const uint32_t a0 = __shfl_sync(0xffffffffu, a, src);
              const uint32_t a1 = __shfl_sync(0xffffffffu, a, src + 1);
              const uint32_t c0 = __shfl_sync(0xffffffffu, c2, src);
              const uint32_t c1 = __shfl_sync(0xffffffffu, c2, src + 1);
              const int t = r ? t1 : t0;
              if (t < valid && col < d.hd)
                *reinterpret_cast<uint2*>(yh + (long)t * d.nh * d.hd + col) =  // kstruct: store 8
                    q < 2 ? make_uint2(a0, a1) : make_uint2(c0, c1);
            }
          }
        }
      }
    }
  }
}

inline Dims make_dims(int B, int S, int nh, int hd, int st, int chunk,
                      int hpb, int ldx) {
  Dims d;
  d.B = B;
  d.S = S;
  d.nh = nh;
  d.hd = hd;
  d.st = st;
  d.c = chunk < S ? chunk : S;
  d.c_pad = up16(d.c);
  d.hd_pad = up16(hd);
  d.st_pad = up16(st);
  d.n_chunks = (S + d.c - 1) / d.c;
  d.hpb = hpb;
  d.n_groups = (nh + hpb - 1) / hpb;
  d.ldx = ldx;
  return d;
}

struct Args {
  const __nv_bfloat16 *xv, *Bm, *Cm;
  const float *logdecay, *h0;
  __nv_bfloat16* y;
  float *h_out, *states, *decay;
};

// The three steps with the accumulators of NT 8-wide column tiles of hd
// and KS 16-wide k tiles of st.
template <int NT, int KS>
cudaError_t launch(const Args& a, const Dims& d1, const Dims& d3, int smem1,
                   int smem3, cudaStream_t s) {
  // once per instantiation, not per launch
  static const cudaError_t setup = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_state_kernel<KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(
                     ssd_chunk_out_kernel<NT, KS>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  }();
  if (setup != cudaSuccess) return setup;
  const int blocks = d1.B * d1.n_chunks * d1.n_groups;
  ssd_chunk_state_kernel<KS><<<blocks, kThreads, smem1, s>>>(
      a.xv, a.logdecay, a.Bm, a.states, a.decay, d1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long n_pass = (long)d1.B * d1.nh * d1.hd * d1.st;
  ssd_state_pass_kernel<<<(int)((n_pass + kPassThreads - 1) / kPassThreads),
                          kPassThreads, 0, s>>>(
      a.h0, a.states, a.decay, a.h_out, d1.B, d1.nh, d1.hd * d1.st,
      d1.n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_out_kernel<NT, KS><<<blocks, kThreads, smem3, s>>>(
      a.xv, a.logdecay, a.Bm, a.Cm, a.states, a.y, d3);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_hd(const Args& a, const Dims& d1, const Dims& d3,
                      int smem1, int smem3, cudaStream_t s) {
  return d1.hd_pad <= 32   ? launch<4, KS>(a, d1, d3, smem1, smem3, s)
         : d1.hd_pad <= 64 ? launch<8, KS>(a, d1, d3, smem1, smem3, s)
                           : launch<16, KS>(a, d1, d3, smem1, smem3, s);
}

}  // namespace
}  // namespace repro_torch

// xv (B,S,nh,hd) bf16, logdecay (B,S,nh) fp32, Bm/Cm (B,S,st) bf16, h0
// (B,nh,hd,st) fp32 or null (zero state), y (B,S,nh,hd) bf16, h_out
// (B,nh,hd,st) fp32, workspaces states (B,n_chunks,nh,hd,st) fp32 and
// decay (B,n_chunks,nh) fp32 with n_chunks = ceil(S / min(chunk, S)); all
// contiguous, xv 16-byte aligned and Bm/Cm too where st % 8 == 0.
// hd % 8 == 0, hd <= 128, st <= 128, 1 <= chunk <= 256,
// 1 <= heads_per_block <= 2, S >= 1.  ldx1/smem1 and ldx3/smem3 are the
// launch plan's X row stride (bf16) and shared-memory bytes of steps 1
// and 3; a plan whose bytes are not where the kernels' carve-up ends is
// refused.  Launches the three steps on `stream`; returns the first
// cudaError_t (0 on success).
extern "C" int ssm_scan_fwd_bf16(const void* xv, const void* logdecay,
                                 const void* Bm, const void* Cm,
                                 const void* h0, void* y, void* h_out,
                                 void* states, void* decay, int B, int S,
                                 int nh, int hd, int st, int chunk,
                                 int heads_per_block, int ldx1, int smem1,
                                 int ldx3, int smem3, void* stream) {
  using namespace repro_torch;
  if (B < 1 || S < 1 || nh < 1 || hd < 8 || hd % 8 != 0 || hd > kMaxHD ||
      st < 1 || st > kMaxST || chunk < 1 || chunk > kMaxChunk ||
      heads_per_block < 1 || heads_per_block > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  const Dims d1 = make_dims(B, S, nh, hd, st, chunk, heads_per_block, ldx1);
  const Dims d3 = make_dims(B, S, nh, hd, st, chunk, heads_per_block, ldx3);
  if (ldx1 < d1.hd_pad || ldx1 % 8 != 0 || ldx3 < d3.hd_pad ||
      ldx3 % 8 != 0 || smem1 > kMaxSmem || smem3 > kMaxSmem ||
      state_smem(d1).end != smem1 || out_smem(d3).end != smem3)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(xv),
               static_cast<const __nv_bfloat16*>(Bm),
               static_cast<const __nv_bfloat16*>(Cm),
               static_cast<const float*>(logdecay),
               static_cast<const float*>(h0),
               static_cast<__nv_bfloat16*>(y),
               static_cast<float*>(h_out),
               static_cast<float*>(states),
               static_cast<float*>(decay)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ks = d1.st_pad / 16;
  return (int)(ks == 1   ? launch_hd<1>(a, d1, d3, smem1, smem3, s)
               : ks == 2 ? launch_hd<2>(a, d1, d3, smem1, smem3, s)
               : ks <= 4 ? launch_hd<4>(a, d1, d3, smem1, smem3, s)
                         : launch_hd<8>(a, d1, d3, smem1, smem3, s));
}
