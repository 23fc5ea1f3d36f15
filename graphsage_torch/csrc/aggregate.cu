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
//
// gather_max_bwd: the tie split of gather_max's backward, the custom VJP
// graphsage_tpu/ops/pallas_aggregate.py::_pallas_max_bwd up to its
// scatter:
//   t[u,s,d]  = embed[idx[u,s], d] == out[u,d] and mask[u,s] > 0
//   c[u,d]    = max(sum_s t[u,s,d], 1)    (rounded to bfloat16 in bfloat16)
//   contrib[u*S + s, d] = g[u,d] * t / c, rounded once to the embed dtype
// for every slot, masked ones too (their rows are g * 0 / c: +-0, or NaN
// where g is +-inf or NaN), so that the scatter that follows
// (ops/scatter.py: scatter_rows in bfloat16, index_add_ in float32) reads
// all U*S rows.  The product, the IEEE division (no fast math) and the one
// rounding are the plain composition's (ops/aggregate.py::
// max_tie_split_plain) operation for operation, so the two agree bit for
// bit; values are compared, so +0 and -0 tie as == has them tie.
// Bound: bytes.  It reads the valid slots' rows (each referenced row
// once), idx, mask, g and out, and writes U*S*D elements: at compact layer
// 2 (idx [1024, 11] over [8192, 128] float32) about 10 MB, 2.9 us.  It
// takes gather_max's launch plan (unit, lanes a row, units a lane a pass)
// and its loads: a valid slot's row is read once, compared with the
// lane's out columns, and the result kept as bit s of a 32-bit mask for
// each column the lane owns; __popc of the masks counts the ties.  A row
// of one unit a lane (width 128) issues the loads of four slots before
// comparing any, so that they are in flight together.  A column's two
// possible shares (g / c tied, g * 0 untied: g * 1 is g, and c >= 1 keeps
// +-0 and NaN) are computed and rounded once; the S contribution rows are
// then written with the same vector units, each word selected between
// them by the slot's bits.  With more than 32 slots a first pass counts
// the ties chunk by chunk and a second reloads each chunk's rows (from L2
// at the main path's sizes) to rebuild its masks before the stores.
// Measured on the H100 (PERF.md): a first version that divided
// and rounded once a slot and column (the composition's order of work)
// was latency-bound at compact layer 2, with 4-8 warps an SM; the grouped
// loads took 2-9% off the whole backward against the same kernel without
// them, in one call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads a block
constexpr unsigned kFullMask = 0xffffffffu;

enum Kind { kMean = 0, kMax = 1, kMaxBwd = 2 };

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

// The tie masks of the slots [b0, b0 + 32) of this lane's row: bit s - b0
// of bits[k][e] is set where slot s is valid and its row equals out in the
// lane's column (k, e).  Every lane of the warp calls it with one b0.
template <typename T, int UNIT, int LANES, int KC>
__device__ __forceinline__ void tie_bits(
    const char* __restrict__ embed, int64_t stride_bytes,
    const int32_t* __restrict__ row_idx, const float* __restrict__ row_mask,
    bool active, int sub, int c0, int S, int units, int b0,
    const float (&o)[KC][UNIT / sizeof(T)],
    uint32_t (&bits)[KC][UNIT / sizeof(T)]) {
  using V = typename Unit<UNIT>::type;
  constexpr int kVec = UNIT / static_cast<int>(sizeof(T));
#pragma unroll
  for (int k = 0; k < KC; ++k)
#pragma unroll
    for (int e = 0; e < kVec; ++e) bits[k][e] = 0u;
  // a row of at most one unit a lane reads kGroup slots' units before it
  // compares any, so that their loads are in flight together (a wider
  // row would hold KC times the registers)
  constexpr int kGroup = KC == 1 ? 4 : 1;
  const int end = min(S, b0 + 32);
  for (int s0 = b0; s0 < end; s0 += LANES) {
    int my_i = 0;
    float my_w = 0.0f;
    if (active && s0 + sub < end) {
      my_i = __ldg(row_idx + s0 + sub);
      my_w = __ldg(row_mask + s0 + sub);
    }
    const int n = min(LANES, end - s0);
    for (int j0 = 0; j0 < n; j0 += kGroup) {  // LANES is a multiple of 4
      V r[kGroup][KC];
      bool valid[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const int i = __shfl_sync(kFullMask, my_i, j0 + q, LANES);
        const float w = __shfl_sync(kFullMask, my_w, j0 + q, LANES);
        valid[q] = j0 + q < n && w > 0.0f;
        const V* src = reinterpret_cast<const V*>(
            embed + static_cast<int64_t>(valid[q] ? i : 0) * stride_bytes);
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int c = c0 + sub + k * LANES;
          r[q][k] = valid[q] && c < units ? __ldg(src + c) : V{};
        }
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (!valid[q]) continue;
        const uint32_t bit = 1u << (s0 - b0 + j0 + q);
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          float f[kVec];
          to_float<T, UNIT>(r[q][k], f);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            if (f[e] == o[k][e]) bits[k][e] |= bit;
        }
      }
    }
  }
}

template <typename T, int UNIT, int LANES, int KC>
__global__ void __launch_bounds__(kBlock)
gather_max_bwd_kernel(const char* __restrict__ embed, int64_t stride_bytes,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ mask,
                      const char* __restrict__ out,
                      const char* __restrict__ g, char* __restrict__ contrib,
                      int U, int S, int units) {
  using V = typename Unit<UNIT>::type;
  constexpr int kVec = UNIT / static_cast<int>(sizeof(T));
  const int sub = threadIdx.x % LANES;
  const int64_t thread =
      static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  // as in gather_reduce_kernel: whole warps leave, and a warp's second row
  // past U keeps its lanes for the shuffles, inactive
  if ((thread & ~int64_t{31}) / LANES >= U) return;
  const int64_t row = thread / LANES;
  const bool active = row < U;
  const int32_t* row_idx = idx + row * S;
  const float* row_mask = mask + row * S;
  const V* out_row = reinterpret_cast<const V*>(out) + row * units;
  const V* g_row = reinterpret_cast<const V*>(g) + row * units;
  V* dst = reinterpret_cast<V*>(contrib) + row * S * units;
  const int chunks = (S + 31) / 32;

  for (int c0 = 0; c0 < units; c0 += KC * LANES) {  // one pass unless wide
    float o[KC][kVec], gv[KC][kVec], cnt[KC][kVec];
    uint32_t bits[KC][kVec];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = c0 + sub + k * LANES;
      const bool here = active && c < units;
      to_float<T, UNIT>(here ? out_row[c] : V{}, o[k]);
      to_float<T, UNIT>(here ? g_row[c] : V{}, gv[k]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) cnt[k][e] = 0.0f;
    }
    // count the ties; with one chunk its masks stay for the stores
    for (int b = 0; b < chunks; ++b) {
      tie_bits<T, UNIT, LANES, KC>(embed, stride_bytes, row_idx, row_mask,
                                   active, sub, c0, S, units, 32 * b, o,
                                   bits);
#pragma unroll
      for (int k = 0; k < KC; ++k)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          cnt[k][e] += static_cast<float>(__popc(bits[k][e]));
    }
    // a slot's share is g * t / c with t in {0, 1}: g / c where it ties
    // (g * 1 is g), g * 0 where it does not (+-0 / c is +-0 and NaN / c
    // NaN, c >= 1), each rounded once to T; computed once a column, and
    // kept as T's words, which a slot's store selects from by its bits
    uint32_t tied[KC][Unit<UNIT>::kWords], untied[KC][Unit<UNIT>::kWords];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float q[kVec], z[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        // the composition's denominator: the count in g's dtype, at least 1
        float c = cnt[k][e];
        if constexpr (sizeof(T) == 2) c = __uint_as_float(bf16_bits(c) << 16);
        q[e] = __fdiv_rn(gv[k][e], fmaxf(c, 1.0f));
        z[e] = __fmul_rn(gv[k][e], 0.0f);
      }
      Unit<UNIT>::split(from_float<T, UNIT>(q), tied[k]);
      Unit<UNIT>::split(from_float<T, UNIT>(z), untied[k]);
    }
    for (int b = 0; b < chunks; ++b) {
      if (chunks > 1)
        tie_bits<T, UNIT, LANES, KC>(embed, stride_bytes, row_idx, row_mask,
                                     active, sub, c0, S, units, 32 * b, o,
                                     bits);
      if (!active) continue;
      const int end = min(S, 32 * b + 32);
      for (int s = 32 * b; s < end; ++s) {
        const int shift = s - 32 * b;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const int c = c0 + sub + k * LANES;
          if (c < units) {
            uint32_t w[Unit<UNIT>::kWords];
#pragma unroll
            for (int i = 0; i < Unit<UNIT>::kWords; ++i) {
              // the bits of word i that belong to a tied element
              uint32_t pick;
              if constexpr (sizeof(T) == 4) {
                pick = 0u - ((bits[k][i] >> shift) & 1u);
              } else {
                pick = 0xffffu & (0u - ((bits[k][2 * i] >> shift) & 1u));
                if constexpr (kVec > 1)
                  pick |= 0xffff0000u &
                          (0u - ((bits[k][2 * i + 1] >> shift) & 1u));
              }
              w[i] = (tied[k][i] & pick) | (untied[k][i] & ~pick);
            }
            dst[static_cast<int64_t>(s) * units + c] = Unit<UNIT>::join(w);
          }
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
  char* out;            // gather_max_bwd reads it (the forward's output)
  const char* g;        // gather_max_bwd only
  char* contrib;        // gather_max_bwd only
  int U, S, units;
  cudaStream_t stream;
};

template <typename T, int KIND, int UNIT, int LANES, int KC>
int launch(const Args& a) {
  const int64_t threads = static_cast<int64_t>(a.U) * LANES;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  if constexpr (KIND == kMaxBwd)
    gather_max_bwd_kernel<T, UNIT, LANES, KC><<<grid, kBlock, 0, a.stream>>>(
        a.embed, a.stride_bytes, a.idx, a.mask, a.out, a.g, a.contrib, a.U,
        a.S, a.units);
  else
    gather_reduce_kernel<T, KIND, UNIT, LANES, KC>
        <<<grid, kBlock, 0, a.stream>>>(a.embed, a.stride_bytes, a.idx,
                                        a.mask, a.out, a.U, a.S, a.units);
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
             const void* idx, const void* mask, const void* out,
             const void* g, void* contrib, int U, int S, int D, int unit,
             int lanes, int kc, void* stream) {
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
      reinterpret_cast<uintptr_t>(g) % unit != 0 ||
      reinterpret_cast<uintptr_t>(contrib) % unit != 0 ||
      stride_bytes % unit != 0 || row_bytes % unit != 0 ||
      !((lanes == 16 && kc == 1 && row_bytes <= 16 * unit) ||
        (lanes == 32 && (kc == 1 || kc == 2 || kc == 4))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const char*>(embed),
               stride_bytes,
               static_cast<const int32_t*>(idx),
               static_cast<const float*>(mask),
               static_cast<char*>(const_cast<void*>(out)),
               static_cast<const char*>(g),
               static_cast<char*>(contrib),
               U,
               S,
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
  return dispatch<kMean>(dtype, device, embed, embed_stride, idx, mask, out,
                         nullptr, nullptr, U, S, D, unit, lanes, kc, stream);
}

int gs_gather_max(int dtype, int device, const void* embed,
                  long long embed_stride, const void* idx, const void* mask,
                  void* out, int U, int S, int D, int unit, int lanes, int kc,
                  void* stream) {
  return dispatch<kMax>(dtype, device, embed, embed_stride, idx, mask, out,
                        nullptr, nullptr, U, S, D, unit, lanes, kc, stream);
}

// gather_max's backward up to its scatter: out [U, D] (the forward's
// output) and g [U, D] (its gradient), both contiguous in the embed dtype,
// give contrib [U*S, D] (contiguous, embed dtype): g split among the valid
// slots equal to out.  The other arguments and the return are
// gs_gather_max's; the unit must also divide g's and contrib's addresses.
int gs_gather_max_bwd(int dtype, int device, const void* embed,
                      long long embed_stride, const void* idx,
                      const void* mask, const void* out, const void* g,
                      void* contrib, int U, int S, int D, int unit, int lanes,
                      int kc, void* stream) {
  return dispatch<kMaxBwd>(dtype, device, embed, embed_stride, idx, mask, out,
                           g, contrib, U, S, D, unit, lanes, kc, stream);
}

const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
