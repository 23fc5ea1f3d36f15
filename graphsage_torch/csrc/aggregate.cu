// Fused gather + masked mean / max over fixed-fanout neighbourhoods, for
// Hopper (sm_90a).  Built by graphsage_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (plain C interface below); the Python wrappers are
// graphsage_torch/ops/aggregate.py::mean_aggregate / max_aggregate, which
// also choose the launch plan (aggregate.py::aggregate_plan).
//
// Replaces the Pallas TPU kernels
//   graphsage_tpu/ops/pallas_aggregate.py::_mean_kernel  (gather_mean)
//   graphsage_tpu/ops/pallas_aggregate.py::_max_kernel   (gather_max)
// and computes what they compute:
//   mean: out[u] = sum_s mask[u,s] * embed[idx[u,s]] / max(sum_s mask[u,s], 1)
//   max:  out[u] = max over slots with mask[u,s] > 0 of embed[idx[u,s]];
//         0 for a row with no such slot
// with f32 accumulation, sums in slot order, and one rounding to the embed
// dtype at the store.  The [U, S, D] gathered intermediate is never built.
//
// Bound: bytes.  Counting each referenced embed row once, a call reads at
// most M*D elements, idx and mask (U*S*4 bytes each), and writes U*D
// elements; at the serving shape (U = M = 100000, S = 32, D = 128, f32)
// about 128 MB, 38 us at 3.35 TB/s.  But every slot reads its row again:
// the serving table is read 1.1 million times (572 MB), the refresh's
// [100000, 602] float32 table 0.74 million times (1.8 GB), at random.  What
// sets the time on this card is how many of those row reads are in flight
// and how many of them hit the 50 MB L2.
//
// Design, from measurements on the H100 (PERF.md, PR 4):
// - Vector loads.  A lane owns units of a row's columns: 16 bytes (4
//   float32 or 8 bfloat16) where the table's address, its row stride, the
//   row width and the output's address allow, else 8, 4 or 2 bytes (the
//   host picks the widest; a 602-wide float32 row, 2408 B, takes 8-byte
//   units, a 602-wide bfloat16 row 4-byte units).  A warp's access to a row
//   is one coalesced run.
// - Rows to lanes: LANES = 32 lanes a row, or 16 where a row has at most 16
//   units (a 128-wide bfloat16 row is 16 units of 16 bytes, so a warp takes
//   two rows and no lane idles).  A lane owns units sub, sub + LANES, ...,
//   KC of them a pass (KC 1, 2 or 4; a 301-unit row takes three passes of
//   128 units).
// - One slot at a time, a masked slot skipped: the slot's (idx, mask) pair
//   comes from the lane that loaded it (__shfl_sync within the row's lanes),
//   and a slot with a zero weight (mean) or a weight <= 0 (max) loads
//   nothing, so a non-finite value in an unreferenced row never reaches the
//   output (the plain version adds 0 * inf = NaN there; fmaxf ignores a NaN
//   where torch.maximum propagates it).  Kernels that issued the loads of
//   groups of 4-16 slots before adding any of them held more registers, so
//   fewer warps fitted on an SM, and they were slower at every shape that
//   reads a 602-wide table: the row reads are random, and more resident
//   warps keep more of them in flight than a deeper queue in each warp.
//   This kernel keeps its registers few, so that many warps fit.
// - One block size for every U: at U = 1,024 (compact layer 2, 128 blocks
//   of 256 threads) the time is a row's short chain of dependent loads,
//   and smaller blocks, more of them, did not shorten it.
// Index values of valid slots must lie in [0, M): they are not checked
// here, as the TPU kernel does not check them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads a block
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind { kMean = 0, kMax = 1 };

// A unit of UNIT bytes and its 32-bit words (UNIT 2: one half word).
template <int UNIT> struct Unit;
template <> struct Unit<16> {
  using type = uint4;
  static constexpr int kWords = 4;
  __device__ static void split(uint4 u, uint32_t* w) {
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  }
  __device__ static uint4 join(const uint32_t* w) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Unit<8> {
  using type = uint2;
  static constexpr int kWords = 2;
  __device__ static void split(uint2 u, uint32_t* w) { w[0] = u.x; w[1] = u.y; }
  __device__ static uint2 join(const uint32_t* w) {
    return make_uint2(w[0], w[1]);
  }
};
template <> struct Unit<4> {
  using type = unsigned int;
  static constexpr int kWords = 1;
  __device__ static void split(unsigned int u, uint32_t* w) { w[0] = u; }
  __device__ static unsigned int join(const uint32_t* w) { return w[0]; }
};
template <> struct Unit<2> {
  using type = unsigned short;
  static constexpr int kWords = 1;
  __device__ static void split(unsigned short u, uint32_t* w) { w[0] = u; }
  __device__ static unsigned short join(const uint32_t* w) {
    return static_cast<unsigned short>(w[0]);
  }
};

// The unit's elements as float32 (bfloat16 widens exactly).
template <typename T, int UNIT>
__device__ __forceinline__ void to_float(typename Unit<UNIT>::type u,
                                         float* f) {
  uint32_t w[Unit<UNIT>::kWords];
  Unit<UNIT>::split(u, w);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < Unit<UNIT>::kWords; ++k) f[k] = __uint_as_float(w[k]);
  } else if constexpr (UNIT == 2) {
    f[0] = __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int k = 0; k < Unit<UNIT>::kWords; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));  // round once
}

template <typename T, int UNIT>
__device__ __forceinline__ typename Unit<UNIT>::type from_float(
    const float* f) {
  uint32_t w[Unit<UNIT>::kWords];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < Unit<UNIT>::kWords; ++k) w[k] = __float_as_uint(f[k]);
  } else if constexpr (UNIT == 2) {
    w[0] = bf16_bits(f[0]);
  } else {
#pragma unroll
    for (int k = 0; k < Unit<UNIT>::kWords; ++k)
      w[k] = bf16_bits(f[2 * k]) | (bf16_bits(f[2 * k + 1]) << 16);
  }
  return Unit<UNIT>::join(w);
}

template <typename T, int KIND, int UNIT, int LANES, int KC>
__global__ void __launch_bounds__(kBlock)
gather_reduce_kernel(const char* __restrict__ embed, int64_t stride_bytes,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ mask, char* __restrict__ out,
                     int U, int S, int units) {
  using V = typename Unit<UNIT>::type;
  constexpr int kVec = UNIT / static_cast<int>(sizeof(T));
  const int sub = threadIdx.x % LANES;  // this lane within its row's lanes
  const int64_t thread =
      static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  // the whole warp leaves together; a warp of two rows whose second row
  // lies past U keeps its lanes for the shuffles, inactive
  if ((thread & ~int64_t{31}) / LANES >= U) return;
  const int64_t row = thread / LANES;
  const bool active = row < U;
  const int32_t* row_idx = idx + row * S;
  const float* row_mask = mask + row * S;
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));

  for (int c0 = 0; c0 < units; c0 += KC * LANES) {  // one pass unless wide
    float acc[KC][kVec];
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[k][e] = (KIND == kMean) ? 0.0f : neg_inf;
    float total = 0.0f;  // mean: sum of weights; max: 1 once a slot is valid

    for (int s0 = 0; s0 < S; s0 += LANES) {
      int my_i = 0;
      float my_w = 0.0f;
      if (active && s0 + sub < S) {
        my_i = __ldg(row_idx + s0 + sub);
        my_w = __ldg(row_mask + s0 + sub);
      }
      const int n = min(LANES, S - s0);
      for (int j = 0; j < n; ++j) {
        const int i = __shfl_sync(kFullMask, my_i, j, LANES);
        const float w = __shfl_sync(kFullMask, my_w, j, LANES);
        if (KIND == kMean) {
          total += w;
          if (w == 0.0f) continue;
        } else {
          if (!(w > 0.0f)) continue;
          total = 1.0f;
        }
        const V* src = reinterpret_cast<const V*>(
            embed + static_cast<int64_t>(i) * stride_bytes);
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int c = c0 + sub + k * LANES;
          if (c < units) {
            float f[kVec];
            to_float<T, UNIT>(__ldg(src + c), f);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              acc[k][e] = (KIND == kMean) ? acc[k][e] + w * f[e]
                                          : fmaxf(acc[k][e], f[e]);
          }
        }
      }
    }

    if (active) {
      V* dst = reinterpret_cast<V*>(out + row * static_cast<int64_t>(units) *
                                              UNIT);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int c = c0 + sub + k * LANES;
        if (c < units) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[k][e] = (KIND == kMean) ? acc[k][e] / fmaxf(total, 1.0f)
                                        : (total > 0.0f ? acc[k][e] : 0.0f);
          dst[c] = from_float<T, UNIT>(acc[k]);
        }
      }
    }
  }
}

struct Args {
  const char* embed;
  int64_t stride_bytes;
  const int32_t* idx;
  const float* mask;
  char* out;
  int U, S, units;
  cudaStream_t stream;
};

template <typename T, int KIND, int UNIT, int LANES, int KC>
int launch(const Args& a) {
  const int64_t threads = static_cast<int64_t>(a.U) * LANES;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  gather_reduce_kernel<T, KIND, UNIT, LANES, KC><<<grid, kBlock, 0, a.stream>>>(
      a.embed, a.stride_bytes, a.idx, a.mask, a.out, a.U, a.S, a.units);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KIND, int UNIT>
int by_lanes(int lanes, int kc, const Args& a) {
  if (lanes == 16) return launch<T, KIND, UNIT, 16, 1>(a);
  if (kc == 1) return launch<T, KIND, UNIT, 32, 1>(a);
  if (kc == 2) return launch<T, KIND, UNIT, 32, 2>(a);
  return launch<T, KIND, UNIT, 32, 4>(a);
}

template <typename T, int KIND>
int by_unit(int unit, int lanes, int kc, const Args& a) {
  switch (unit) {
    case 16:
      return by_lanes<T, KIND, 16>(lanes, kc, a);
    case 8:
      return by_lanes<T, KIND, 8>(lanes, kc, a);
    case 4:
      return by_lanes<T, KIND, 4>(lanes, kc, a);
    default:
      if constexpr (sizeof(T) == 2) return by_lanes<T, KIND, 2>(lanes, kc, a);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int KIND>
int dispatch(int dtype, int device, const void* embed, long long embed_stride,
             const void* idx, const void* mask, void* out, int U, int S,
             int D, int unit, int lanes, int kc, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t elt = dtype == 0 ? 4 : 2;
  const int64_t stride_bytes = static_cast<int64_t>(embed_stride) * elt;
  const int64_t row_bytes = static_cast<int64_t>(D) * elt;
  const bool unit_ok = (unit == 16 || unit == 8 || unit == 4 || unit == 2) &&
                       unit >= elt;
  // the plan must fit the tensors: the unit divides every address, stride
  // and the row width; 16 lanes a row only for rows of at most 16 units
  if (!unit_ok || reinterpret_cast<uintptr_t>(embed) % unit != 0 ||
      reinterpret_cast<uintptr_t>(out) % unit != 0 ||
      stride_bytes % unit != 0 || row_bytes % unit != 0 ||
      !((lanes == 16 && kc == 1 && row_bytes <= 16 * unit) ||
        (lanes == 32 && (kc == 1 || kc == 2 || kc == 4))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const char*>(embed), stride_bytes,
               static_cast<const int32_t*>(idx),
               static_cast<const float*>(mask), static_cast<char*>(out), U, S,
               static_cast<int>(row_bytes / unit),
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_unit<float, KIND>(unit, lanes, kc, a);
  return by_unit<__nv_bfloat16, KIND>(unit, lanes, kc, a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (embed and out).  idx int32 [U, S] and
// mask float32 [U, S] are contiguous; out [U, D] is contiguous; embed rows
// are embed_stride elements apart with unit column stride.  unit (bytes a
// lane loads from a row: 16, 8, 4 or 2), lanes (a row's lanes: 32, or 16
// for a row of at most 16 units) and kc (units a lane a pass: 1, 2 or 4)
// are the launch plan.  Launches on `stream` of `device` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a dtype
// or plan it does not take.
int gs_gather_mean(int dtype, int device, const void* embed,
                   long long embed_stride, const void* idx, const void* mask,
                   void* out, int U, int S, int D, int unit, int lanes, int kc,
                   void* stream) {
  return dispatch<kMean>(dtype, device, embed, embed_stride, idx, mask, out, U,
                         S, D, unit, lanes, kc, stream);
}

int gs_gather_max(int dtype, int device, const void* embed,
                  long long embed_stride, const void* idx, const void* mask,
                  void* out, int U, int S, int D, int unit, int lanes, int kc,
                  void* stream) {
  return dispatch<kMax>(dtype, device, embed, embed_stride, idx, mask, out, U,
                        S, D, unit, lanes, kc, stream);
}

const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
