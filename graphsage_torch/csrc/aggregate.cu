// Fused gather + masked mean / max over fixed-fanout neighbourhoods, for
// Hopper (sm_90a).  Built by graphsage_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (plain C interface below); the Python wrappers are
// graphsage_torch/ops/aggregate.py::mean_aggregate / max_aggregate.
//
// Replaces the Pallas TPU kernels
//   graphsage_tpu/ops/pallas_aggregate.py::_mean_kernel  (gather_mean)
//   graphsage_tpu/ops/pallas_aggregate.py::_max_kernel   (gather_max)
// and computes what they compute:
//   mean: out[u] = sum_s mask[u,s] * embed[idx[u,s]] / max(sum_s mask[u,s], 1)
//   max:  out[u] = max over slots with mask[u,s] > 0 of embed[idx[u,s]];
//         0 for a row with no such slot
// with f32 accumulation and one rounding to the embed dtype at the store.
// The [U, S, D] gathered intermediate is never built.
//
// Bound: bytes.  A call reads the referenced embed rows (at most M*D
// elements), idx and mask (U*S*4 bytes each) and writes U*D elements; it
// does S multiply-adds per output element, far below the card's rate.  At
// the serving shape (U = M = 100000, S = 32, D = 128, f32) that is about
// 128 MB, about 38 us at 3.35 TB/s.
//
// Design, for the bytes: one warp per output row, eight rows per block.
// Each lane reads one slot's (idx, mask) once; the pair is broadcast to the
// warp with __shfl_sync, so the row's index list costs one coalesced load.
// Lanes stride over the columns (column c0 + lane + 32*k), so every embed
// row read is a run of coalesced accesses, whatever the row's alignment:
// there are no vector loads, so the 602-wide rows of MAX layer 1 (2408 B
// f32, 1204 B bf16, not 16-byte aligned) need no special case, and a row
// stride other than D (the strided z[:, H:] view of MEAN serving) costs
// nothing.  Four f32 accumulators per lane cover 128 columns per pass;
// wider rows take several passes.  Slots with mask 0 are skipped: no row
// is read for them.  This differs from the plain version only where the
// skipped embed row holds a non-finite value (the plain version adds
// 0 * inf = NaN); likewise fmaxf ignores a NaN where torch.maximum
// propagates it.  Index values of valid slots must lie in [0, M): they are
// not checked here, as the TPU kernel does not check them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kColsPerLane = 4;
constexpr int kColsPerPass = kWarp * kColsPerLane;
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind { kMean = 0, kMax = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, once
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
gather_reduce_kernel(const T* __restrict__ embed, int64_t embed_stride,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ mask, T* __restrict__ out,
                     int U, int S, int D) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= U) return;  // the whole warp leaves together
  const int32_t* row_idx = idx + row * S;
  const float* row_mask = mask + row * S;
  T* row_out = out + row * static_cast<int64_t>(D);
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));

  for (int c0 = 0; c0 < D; c0 += kColsPerPass) {
    float acc[kColsPerLane];
#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k)
      acc[k] = (KIND == kMean) ? 0.0f : neg_inf;
    float total = 0.0f;  // mean: sum of weights; max: 1 once a slot is valid

    for (int s0 = 0; s0 < S; s0 += kWarp) {
      int my_i = 0;
      float my_w = 0.0f;
      if (s0 + lane < S) {
        my_i = __ldg(row_idx + s0 + lane);
        my_w = __ldg(row_mask + s0 + lane);
      }
      const int n = min(kWarp, S - s0);
      for (int j = 0; j < n; ++j) {
        const int i = __shfl_sync(kFullMask, my_i, j);
        const float w = __shfl_sync(kFullMask, my_w, j);
        if (KIND == kMean) {
          total += w;
          if (w == 0.0f) continue;
        } else {
          if (!(w > 0.0f)) continue;
          total = 1.0f;
        }
        const T* src = embed + static_cast<int64_t>(i) * embed_stride;
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) {
          const int c = c0 + lane + k * kWarp;
          if (c < D) {
            const float v = load_f32(src + c);
            acc[k] = (KIND == kMean) ? acc[k] + w * v : fmaxf(acc[k], v);
          }
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int c = c0 + lane + k * kWarp;
      if (c < D) {
        const float v = (KIND == kMean) ? acc[k] / fmaxf(total, 1.0f)
                                        : (total > 0.0f ? acc[k] : 0.0f);
        store(row_out + c, v);
      }
    }
  }
}

template <typename T, int KIND>
int launch(int device, const void* embed, long long embed_stride,
           const void* idx, const void* mask, void* out, int U, int S, int D,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kWarp * kRowsPerBlock);
  const dim3 grid((U + kRowsPerBlock - 1) / kRowsPerBlock);
  gather_reduce_kernel<T, KIND><<<grid, block, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(embed), static_cast<int64_t>(embed_stride),
      static_cast<const int32_t*>(idx), static_cast<const float*>(mask),
      static_cast<T*>(out), U, S, D);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int dispatch(int dtype, int device, const void* embed, long long embed_stride,
             const void* idx, const void* mask, void* out, int U, int S,
             int D, void* stream) {
  if (dtype == 0)
    return launch<float, KIND>(device, embed, embed_stride, idx, mask, out, U,
                               S, D, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, KIND>(device, embed, embed_stride, idx, mask,
                                       out, U, S, D, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (embed and out).  idx int32 [U, S] and
// mask float32 [U, S] are contiguous; out [U, D] is contiguous; embed rows
// are embed_stride elements apart with unit column stride.  Launches on
// `stream` of `device` and returns cudaGetLastError() (0 on success).
int gs_gather_mean(int dtype, int device, const void* embed,
                   long long embed_stride, const void* idx, const void* mask,
                   void* out, int U, int S, int D, void* stream) {
  return dispatch<kMean>(dtype, device, embed, embed_stride, idx, mask, out, U,
                         S, D, stream);
}

int gs_gather_max(int dtype, int device, const void* embed,
                  long long embed_stride, const void* idx, const void* mask,
                  void* out, int U, int S, int D, void* stream) {
  return dispatch<kMax>(dtype, device, embed, embed_stride, idx, mask, out, U,
                        S, D, stream);
}

const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
