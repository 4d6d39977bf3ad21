// The adjoint of the MoE dispatch's gated combine (kernels/moe_combine.py):
// d_eo[slot[t, j]] = w[t, j] * dy[t] for each kept (t, j), zero in every
// other row, and dw[t, j] = <dy[t], eo[slot[t, j]]> in fp32, 0 where the
// slot is the dump row (outside [0, R)).
//
// Replaces no TPU kernel: it is the backward of the combine's gather, which
// autograd runs as an index-put that sorts the T * k slots and adds every
// duplicate of the dump row serially into a row that nothing reads.  The
// kept slots of one call are distinct, so here d_eo is zero-filled and each
// kept row written once: no atomics, nothing accumulated, nothing done for a
// dropped assignment.  Bound by bytes (the fill, dy and the kept rows read
// once, the kept rows written once).  One warp a (t, j): each lane owns V
// columns a step (16-byte loads and stores), and the dot product for dw is a
// warp reduction.  A row is cast(0 + cast(w * dy)), the single add onto a
// zero row that the index-put makes, so d_eo is bitwise the plain
// version's.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      float4 q = *reinterpret_cast<const float4*>(p + i);  // kstruct: load 16
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];  // kstruct: load 4
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    uncombine_kernel(const float* __restrict__ dy, const T* __restrict__ eo,
                     const int64_t* __restrict__ slot,
                     const float* __restrict__ w, T* __restrict__ d_eo,
                     float* __restrict__ dw, int k, int d, long R, long P) {
  const long p = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (p >= P) return;
  const int lane = threadIdx.x % 32;
  const int64_t r = slot[p];
  if (r < 0 || r >= R) {  // the dump row: no row, no gate gradient
    if (lane == 0) dw[p] = 0.f;  // kstruct: store 4
    return;
  }
  const float g = w[p];
  const float* dyt = dy + (p / k) * d;
  const T* er = eo + r * d;
  T* out = d_eo + r * d;
  float dot = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) {
    float gy[V], e[V];
    load_f32<V>(dyt + c, gy);
    if constexpr (V * sizeof(T) == 16) {
      uint4 raw = *reinterpret_cast<const uint4*>(er + c);  // kstruct: load 16
      const T* ev = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = to_f(ev[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = to_f(er[c + i]);
    }
    __align__(16) T o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      dot = fmaf(gy[i], e[i], dot);
      o[i] = from_f<T>(__fadd_rn(0.f, to_f(from_f<T>(__fmul_rn(g, gy[i])))));
    }
    if constexpr (V * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(out + c) =  // kstruct: store 16
          *reinterpret_cast<const uint4*>(o);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) out[c + i] = o[i];  // kstruct: store 2
    }
  }
  dot = warp_sum(dot);
  if (lane == 0) dw[p] = dot;  // kstruct: store 4
}

template <typename T>
int launch(const float* dy, const void* eo, const int64_t* slot,
           const float* w, void* d_eo, float* dw, int T_, int k, int d,
           long R, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(d_eo, 0, (size_t)R * d * sizeof(T), st);
  if (err != cudaSuccess) return (int)err;
  const long P = (long)T_ * k;
  if (P == 0) return 0;
  const long blocks = (P + kWarps - 1) / kWarps;
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && reinterpret_cast<uintptr_t>(eo) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d_eo) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  if (vec)
    uncombine_kernel<T, V><<<blocks, kThreads, 0, st>>>(
        dy, static_cast<const T*>(eo), slot, w, static_cast<T*>(d_eo), dw, k,
        d, R, P);
  else
    uncombine_kernel<T, 1><<<blocks, kThreads, 0, st>>>(
        dy, static_cast<const T*>(eo), slot, w, static_cast<T*>(d_eo), dw, k,
        d, R, P);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (eo's and d_eo's); dy (T, d), dw (T, k)
// float32
extern "C" int moe_uncombine_launch(const void* dy, const void* eo,
                                    const void* slot, const void* w,
                                    void* d_eo, void* dw, int T, int k, int d,
                                    int64_t R, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 0 || k < 1 || d < 1 || R < 0) return (int)cudaErrorInvalidValue;
  const float* dyf = static_cast<const float*>(dy);
  const int64_t* s = static_cast<const int64_t*>(slot);
  const float* wf = static_cast<const float*>(w);
  float* dwf = static_cast<float*>(dw);
  if (dtype == 0)
    return repro_torch::launch<float>(dyf, eo, s, wf, d_eo, dwf, T, k, d, R,
                                      st);
  if (dtype == 1)
    return repro_torch::launch<__nv_bfloat16>(dyf, eo, s, wf, d_eo, dwf, T, k,
                                              d, R, st);
  return (int)cudaErrorInvalidValue;
}
