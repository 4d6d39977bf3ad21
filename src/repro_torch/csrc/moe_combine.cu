// The MoE dispatch's gated combine, forward (kernels/moe_combine.py):
// y[t] = sum over j = 0..k-1, in order, of eo[slot[t, j]] * w[t, j] in
// fp32, a slot outside [0, R) (the dump row R) adding nothing.
//
// Replaces no TPU kernel: the JAX package combines with XLA ops (gather,
// convert, multiply, add).  Bound by bytes: each kept row read once, y
// written once, 2 FLOPs an element.  One block a token; each thread owns V
// consecutive columns (one 16-byte load of eo a slot) and keeps their sums
// in registers across the k slots, so the fp32 (T, k, d) intermediate of
// the plain version never reaches memory.  The products and sums are
// __fmul_rn / __fadd_rn in the plain version's order from a zero start:
// no FMA contraction, so y is bitwise the plain version's.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// V elements of T from 16 bytes (V * sizeof(T) == 16) or one element
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);  // kstruct: load 16
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(p[i]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const T* __restrict__ eo, const int64_t* __restrict__ slot,
                   const float* __restrict__ w, float* __restrict__ y, int k,
                   int d, long R) {
  const long t = blockIdx.x;
  const int64_t* st = slot + t * k;
  const float* wt = w + t * k;
  for (int c = threadIdx.x * V; c < d; c += kThreads * V) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int j = 0; j < k; ++j) {
      const int64_t r = st[j];
      if (r < 0 || r >= R) continue;  // the dump row adds nothing
      const float g = wt[j];
      float v[V];
      load_row<T, V>(eo + r * d + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], g));
    }
    float* out = y + t * d + c;
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(out + i) =  // kstruct: store 16
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = acc[i];  // kstruct: store 4
    }
  }
}

template <typename T>
int launch(const void* eo, const int64_t* slot, const float* w, float* y,
           int T_, int k, int d, long R, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && reinterpret_cast<uintptr_t>(eo) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec)
    combine_kernel<T, V><<<T_, kThreads, 0, st>>>(
        static_cast<const T*>(eo), slot, w, y, k, d, R);
  else
    combine_kernel<T, 1><<<T_, kThreads, 0, st>>>(
        static_cast<const T*>(eo), slot, w, y, k, d, R);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (eo's); y (T, d) float32
extern "C" int moe_combine_launch(const void* eo, const void* slot,
                                  const void* w, void* y, int T, int k, int d,
                                  int64_t R, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || k < 1 || d < 1 || R < 0) return (int)cudaErrorInvalidValue;
  const int64_t* s = static_cast<const int64_t*>(slot);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  if (dtype == 0)
    return repro_torch::launch<float>(eo, s, wf, yf, T, k, d, R, st);
  if (dtype == 1)
    return repro_torch::launch<__nv_bfloat16>(eo, s, wf, yf, T, k, d, R, st);
  return (int)cudaErrorInvalidValue;
}
