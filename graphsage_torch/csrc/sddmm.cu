// Fused row-normalise + score block for the unsupervised losses, for Hopper
// (sm_90a).  Built by graphsage_torch/ops/build.py into its own library
// (nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC) and bound with ctypes (plain C interface below); the
// Python wrapper is graphsage_torch/ops/sddmm.py::pair_scores_kernel, which
// also chooses the launch plan (sddmm.py::scores_plan).
//
// Replaces the Pallas TPU kernel
//   graphsage_tpu/ops/sddmm.py::_scores_kernel  (pair_scores)
// and computes what it computes:
//   scores[b, u] = < emb[t_b] / max(|emb[t_b]|, eps),
//                    emb[u] / max(|emb[u]|, eps) >
// with t_b = target_rows[b], norms and products in float32 (full float32
// FMAs on the CUDA cores, no TF32), each element divided by its row's norm
// as the plain version divides, and one rounding to the emb dtype at the
// store.  A row of zero norm gives 0.  The kernel reads target_rows itself,
// so the [B, H] copy of the target rows that the TPU wrapper takes
// (sddmm.py:184) is never built, and the normalised table is never written
// to device memory.
//
// Bound, at the main path's shapes (H = 128, float32):
// - the compact step and cached (c)'s step, 20 targets x 1,024 rows: bytes,
//   0.52 MB of table read and 82 KB of scores written, 0.18 us at
//   3.35 TB/s; far below a launch's own latency;
// - the [512 x 2048] block: operations, 2*B*U*H = 268 MFLOP, 4.0 us at
//   67 TFLOP/s, against 1.6 us of bytes;
// - the ragged [3 x 1000], H = 100: bytes, 0.12 us.
//
// Design.  One block per tile of TB targets x TU table rows; the plan (TB,
// TU, the copy unit, the stage width, the store width) is chosen in Python
// (sddmm.py::scores_plan) and checked here.  What the previous kernel
// (32 x 64 tiles, scalar loads, one row after another per warp) lost time
// on, and what this one does, from measurements on the H100 (PERF.md):
// 1. Too few blocks.  At B <= 32, tiles of 8 targets x 8 table rows: the
//    20 x 1,024 step is 384 blocks.  One target tile of 32 (128 blocks)
//    took 0.0071 ms there, three of 8 0.0047, 8 x 16 tiles 0.0050: the time
//    is latency, and smaller blocks overlap more of it.  At B > 32, tiles
//    of 64 x 64 (512 x 2,048: 256 blocks; 64 x 128 tiles were slower).
// 2. A chain of memory round trips.  Every row of the tile goes to shared
//    memory in one round trip with every copy in flight: cp.async of 16
//    bytes (cp.async.cg) where the table's address, row stride and row
//    width allow, else 8 or 4 bytes (cp.async.ca), else (bfloat16 rows at
//    odd elements) 2-byte loads.  The table rows' copies start before the
//    target ids are read, so the ids' load overlaps their copies.  TMA bulk
//    copies were not tried: a row is 128-512 bytes, and the copies are not
//    what costs time (below).
//    Norms from shared memory: 8 lanes a row, 16-byte reads held in
//    registers, a shuffle reduction, max(sqrt(ss), eps), and the same
//    lanes write their chunks back divided by the norm (bfloat16: widened
//    into a float32 buffer); one __syncthreads.  The division is one
//    correctly rounded reciprocal a row and a corrected quotient an element
//    (div_by): the compiler's division, with its range check and slow path
//    an element, took 1.2-1.8 us of the 20 x 1,024 and 512 x 2,048 calls.
//    Rows wider than 256 columns go through two buffers in column stages
//    (one pass for the norms, one for the products, the next stage's copy
//    in flight while the current one is used).
// 3. Shared-memory-bound products.  Each thread keeps an RB x RU tile of
//    sums in registers (4 x 4 at B > 32; 1 x 1 at B <= 32, the four
//    components of a 16-byte chunk summed apart so the FMA chains stay
//    short) and reads 16-byte chunks: RB + RU shared loads for 4 * RB * RU
//    full float32 FMAs on the CUDA cores (no TF32, no tensor cores).  Rows
//    are padded to an odd number of 16-byte chunks and a thread's rows are
//    TU / RU apart, so the 8 lanes of a quarter warp read 8 neighbouring
//    rows, in 8 different bank groups: no bank conflicts.  At 512 x 2,048
//    the products still take about 8 us, half the call: 16-byte shared
//    loads at 2 bytes a FMA; larger register tiles (8 x 4, 8 x 8) spilled
//    or left too few warps, and were no faster.
// Store: the tile goes through shared memory and out in rows along U, 4
// elements a store (float4, or 8 bytes of bfloat16) where U is a multiple
// of 4, else one.  The launch bounds cap registers at 128 (4 blocks of 128
// threads or 2 of 256 on an SM); the plan keeps shared memory under 113 KB
// so that two blocks fit.
// Any H works, and any row stride with unit column stride.  Index values
// in target_rows must lie in [0, U): they are not checked here, as the TPU
// kernel does not check them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kNormLanes = 8;           // lanes a row in the norm pass
constexpr int kMaxStage = 256;          // columns a stage, at most
constexpr int kHold = kMaxStage / 4 / kNormLanes;  // chunks a lane a row
constexpr int kMaxBlockSmem = 232448;   // 227 KB a block on the H100

// Shared memory a block takes, dynamic part: the float32 stage buffers
// (bfloat16: one float32 buffer and the raw bfloat16 stage buffers), or
// the output tile if that is larger.  A stage is hs columns; rows are
// padded to an odd number of 16-byte chunks.  Mirrors
// graphsage_torch/ops/sddmm.py::scores_smem.
inline int64_t smem_bytes(int tb, int tu, int elt, int H, int hs) {
  const int64_t rows = tb + tu;
  const int64_t nbuf = H > hs ? 2 : 1;
  const int64_t sp4 = ((hs + 3) / 4) | 1;
  const int64_t fbuf = rows * sp4 * 16;
  const int64_t stage =
      elt == 4 ? nbuf * fbuf : fbuf + nbuf * rows * hs * 2;
  const int64_t tile = static_cast<int64_t>(tb) * (tu + 4) * 4;
  return stage > tile ? stage : tile;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest one has landed
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x / n, from y = 1 / n rounded to nearest: q = x * y, then one
// correction with the exact residual x - q * n (Markstein's step).  That is
// the correctly rounded quotient x / n but in rare cases, which are 1 ulp
// off it, with no branch: the compiler's division takes a range check and
// a slow path for every element, which serialised the normalisation.
__device__ __forceinline__ float div_by(float x, float n, float y) {
  const float q = x * y;
  return fmaf(fmaf(-q, n, x), y, q);
}

__device__ __forceinline__ float4 scale(float4 v, float n, float y) {
  return make_float4(div_by(v.x, n, y), div_by(v.y, n, y),
                     div_by(v.z, n, y), div_by(v.w, n, y));
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));  // round once
}

// Chunk c (4 elements) of a staged row as float32, elements at or past w
// set to 0 (they were never copied).
template <typename T>
__device__ __forceinline__ float4 load_chunk(const char* row, int c, int w) {
  float4 v;
  if constexpr (sizeof(T) == 4) {
    v = *reinterpret_cast<const float4*>(row + 16 * c);
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(row + 8 * c);
    v = make_float4(__uint_as_float(q.x << 16),
                    __uint_as_float(q.x & 0xffff0000u),
                    __uint_as_float(q.y << 16),
                    __uint_as_float(q.y & 0xffff0000u));
  }
  const int e = 4 * c;
  if (e + 4 > w) {
    if (e + 0 >= w) v.x = 0.0f;
    if (e + 1 >= w) v.y = 0.0f;
    if (e + 2 >= w) v.z = 0.0f;
    v.w = 0.0f;
  }
  return v;
}

template <typename T, int TB, int TU, int RB, int RU, int NT>
__global__ void __launch_bounds__(NT, NT <= 128 ? 4 : 2)
pair_scores_kernel(const char* __restrict__ emb, int64_t stride_bytes,
                   const int32_t* __restrict__ target_rows,
                   T* __restrict__ out, int B, int U, int H, float eps,
                   int hs, int unit, int vec) {
  constexpr int kRows = TB + TU;
  constexpr int kTX = TU / RU;          // product threads along U
  constexpr int kTY = TB / RB;          // and along B
  constexpr int kProd = kTX * kTY;
  constexpr int kPasses = (kRows * kNormLanes + NT - 1) / NT;
  constexpr int kRowsPass = NT / kNormLanes;
  constexpr int kParts = RB * RU >= 4 ? 1 : 4 / (RB * RU);
  constexpr int kElt = static_cast<int>(sizeof(T));
  static_assert(kProd <= NT && kTX >= 8 && NT % 32 == 0, "tile");

  extern __shared__ __align__(16) char smem[];
  __shared__ int64_t s_trow[TB];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int u0 = blockIdx.x * TU;
  const int b0 = blockIdx.y * TB;
  const int nst = (H + hs - 1) / hs;
  const int sp4 = ((hs + 3) / 4) | 1;            // float4 chunks a row
  const int fbuf = kRows * sp4 * 16;
  // raw stage k: float32 stages are the float buffers themselves
  const int raw_stride = kElt == 4 ? sp4 * 16 : hs * 2;
  const int raw_bytes = kElt == 4 ? fbuf : kRows * hs * 2;
  auto fstage = [&](int k) {
    return reinterpret_cast<float4*>(smem + (kElt == 4 ? k * fbuf : 0));
  };
  auto rstage = [&](int k) {
    return smem + (kElt == 4 ? 0 : fbuf) + k * raw_bytes;
  };
  auto width = [&](int s) { return min(hs, H - s * hs); };
  // the table row of tile row r, or -1 past B / U
  auto row_of = [&](int r) -> int64_t {
    if (r < TB) return s_trow[r];
    const int u = u0 + r - TB;
    return u < U ? u : -1;
  };

  // copy columns [s * hs, s * hs + width(s)) of tile rows [r0, r1) into
  // raw stage k, one warp a row, every copy in flight
  auto copy_stage = [&](int s, int k, int r0, int r1) {
    const int w_bytes = width(s) * kElt;
    const int64_t c0 = static_cast<int64_t>(s) * hs * kElt;
    char* raw = rstage(k);
    for (int r = r0 + warp; r < r1; r += NT / 32) {
      const int64_t row = row_of(r);
      if (row < 0) continue;
      const char* src = emb + row * stride_bytes + c0;
      char* dst = raw + r * raw_stride;
      if (unit == 16) {
        for (int o = 16 * lane; o < w_bytes; o += 16 * 32)
          cp_async16(dst + o, src + o);
      } else if (unit == 8) {
        for (int o = 8 * lane; o < w_bytes; o += 8 * 32)
          cp_async8(dst + o, src + o);
      } else if (unit == 4) {
        for (int o = 4 * lane; o < w_bytes; o += 4 * 32)
          cp_async4(dst + o, src + o);
      } else {
        for (int o = 2 * lane; o < w_bytes; o += 2 * 32)
          *reinterpret_cast<unsigned short*>(dst + o) =
              __ldg(reinterpret_cast<const unsigned short*>(src + o));
      }
    }
  };

  // stage 0: table rows first, then the ids, then the target rows
  copy_stage(0, 0, TB, kRows);
  if (tid < TB) {
    const int b = b0 + tid;
    s_trow[tid] = b < B ? static_cast<int64_t>(__ldg(target_rows + b)) : -1;
  }
  __syncthreads();
  copy_stage(0, 0, 0, TB);
  cp_async_commit();

  const int nl = tid % kNormLanes;       // this lane within its row's lanes
  const int rsub = tid / kNormLanes;     // its row within a pass
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  float acc[RB][RU][kParts];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < RU; ++j)
#pragma unroll
      for (int q = 0; q < kParts; ++q) acc[i][j][q] = 0.0f;

  // products of one normalised stage of c4 chunks into the register tile
  auto products = [&](const float4* f, int c4) {
    if (tid >= kProd) return;
#pragma unroll 4
    for (int c = 0; c < c4; ++c) {
      float4 a[RB], e[RU];
#pragma unroll
      for (int i = 0; i < RB; ++i) a[i] = f[(ty + i * kTY) * sp4 + c];
#pragma unroll
      for (int j = 0; j < RU; ++j) e[j] = f[(TB + tx + j * kTX) * sp4 + c];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int j = 0; j < RU; ++j)
            acc[i][j][k % kParts] =
                fmaf(comp(a[i], k), comp(e[j], k), acc[i][j][k % kParts]);
    }
  };
  // the norm of a row from its lanes' sums of squares
  auto row_norm = [&](float ss) {
#pragma unroll
    for (int off = kNormLanes / 2; off > 0; off /= 2)
      ss += __shfl_xor_sync(kFullMask, ss, off);
    return fmaxf(sqrtf(ss), eps);
  };

  if (nst == 1) {
    // 1. one stage: each lane holds its chunks of the row in registers,
    //    sums their squares, and writes them back divided by the norm
    cp_async_commit();
    cp_async_wait_but_one();
    __syncthreads();
    const char* raw = rstage(0);
    float4* f = fstage(0);
    const int c4 = (H + 3) / 4;
#pragma unroll 1
    for (int p = 0; p < kPasses; ++p) {
      const int r = p * kRowsPass + rsub;
      const bool valid = r < kRows && row_of(r) >= 0;
      float4 v[kHold];
      float ss = 0.0f;
#pragma unroll
      for (int k = 0; k < kHold; ++k) {
        const int c = nl + k * kNormLanes;
        v[k] = valid && c < c4 ? load_chunk<T>(raw + r * raw_stride, c, H)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        ss = fmaf(v[k].x, v[k].x, ss);
        ss = fmaf(v[k].y, v[k].y, ss);
        ss = fmaf(v[k].z, v[k].z, ss);
        ss = fmaf(v[k].w, v[k].w, ss);
      }
      const float n = row_norm(ss);
      const float y = __frcp_rn(n);
      if (r < kRows) {
#pragma unroll
        for (int k = 0; k < kHold; ++k) {
          const int c = nl + k * kNormLanes;
          if (c < c4) f[r * sp4 + c] = scale(v[k], n, y);
        }
      }
    }
    __syncthreads();
    // 2. products
    products(f, c4);
    __syncthreads();   // the store reuses the buffer
  } else {
    // 1. several stages: the sums of squares over every stage, with the
    //    next stage's copy in flight while one is read
    float norm[kPasses], recip[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) norm[p] = 0.0f;
    for (int s = 0; s < nst; ++s) {
      if (s + 1 < nst) copy_stage(s + 1, (s + 1) & 1, 0, kRows);
      cp_async_commit();
      cp_async_wait_but_one();
      __syncthreads();
      const char* raw = rstage(s & 1);
      const int w = width(s);
      const int c4 = (w + 3) / 4;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int r = p * kRowsPass + rsub;
        if (r < kRows && row_of(r) >= 0) {
#pragma unroll
          for (int k = 0; k < kHold; ++k) {
            const int c = nl + k * kNormLanes;
            if (c < c4) {
              const float4 v = load_chunk<T>(raw + r * raw_stride, c, w);
              norm[p] = fmaf(v.x, v.x, norm[p]);
              norm[p] = fmaf(v.y, v.y, norm[p]);
              norm[p] = fmaf(v.z, v.z, norm[p]);
              norm[p] = fmaf(v.w, v.w, norm[p]);
            }
          }
        }
      }
      __syncthreads();   // the buffer is refilled at s + 2
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      norm[p] = row_norm(norm[p]);
      recip[p] = __frcp_rn(norm[p]);
    }
    // 2. the stages again: divide each by the norms (the same lanes), sync,
    //    accumulate the products
    copy_stage(0, 0, 0, kRows);
    cp_async_commit();
    for (int s = 0; s < nst; ++s) {
      if (s + 1 < nst) copy_stage(s + 1, (s + 1) & 1, 0, kRows);
      cp_async_commit();
      cp_async_wait_but_one();
      __syncthreads();
      const char* raw = rstage(s & 1);
      float4* f = fstage(s & 1);
      const int w = width(s);
      const int c4 = (w + 3) / 4;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int r = p * kRowsPass + rsub;
        if (r < kRows) {
          const bool valid = row_of(r) >= 0;
#pragma unroll
          for (int k = 0; k < kHold; ++k) {
            const int c = nl + k * kNormLanes;
            if (c < c4)
              f[r * sp4 + c] =
                  valid ? scale(load_chunk<T>(raw + r * raw_stride, c, w),
                                norm[p], recip[p])
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
      }
      __syncthreads();
      products(f, c4);
      __syncthreads();   // the stage's buffers are refilled next
    }
  }

  // 3. store: the tile through shared memory, rows along U
  float* s_out = reinterpret_cast<float*>(smem);
  constexpr int kOutStride = TU + 4;
  if (tid < kProd) {
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < RU; ++j) {
        float v = acc[i][j][0];
#pragma unroll
        for (int q = 1; q < kParts; ++q) v += acc[i][j][q];
        s_out[(ty + i * kTY) * kOutStride + tx + j * kTX] = v;
      }
  }
  __syncthreads();
  if (vec == 4) {
    for (int q = tid; q < TB * TU / 4; q += NT) {
      const int b = q / (TU / 4);
      const int uu = 4 * (q % (TU / 4));
      if (b0 + b < B && u0 + uu < U) {
        const float4 v =
            *reinterpret_cast<const float4*>(s_out + b * kOutStride + uu);
        T* dst = out + static_cast<int64_t>(b0 + b) * U + u0 + uu;
        if constexpr (kElt == 4) {
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          *reinterpret_cast<uint2*>(dst) =
              make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                         bf16_bits(v.z) | (bf16_bits(v.w) << 16));
        }
      }
    }
  } else {
    for (int q = tid; q < TB * TU; q += NT) {
      const int b = q / TU;
      const int uu = q % TU;
      if (b0 + b < B && u0 + uu < U) {
        const float v = s_out[b * kOutStride + uu];
        T* dst = out + static_cast<int64_t>(b0 + b) * U + u0 + uu;
        if constexpr (kElt == 4)
          *dst = v;
        else
          *dst = __float2bfloat16_rn(v);
      }
    }
  }
}

struct Args {
  const char* emb;
  int64_t stride_bytes;
  const int32_t* target_rows;
  void* out;
  int B, U, H;
  float eps;
  int hs, unit, vec;
  int device;
  cudaStream_t stream;
};

template <typename T, int TB, int TU, int RB, int RU, int NT>
int launch(const Args& a) {
  const auto kernel = pair_scores_kernel<T, TB, TU, RB, RU, NT>;
  const int64_t smem = smem_bytes(TB, TU, sizeof(T), a.H, a.hs);
  constexpr int kLimit = kMaxBlockSmem - TB * 8;   // beside s_trow
  if (smem > kLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    static bool opted_in[64];   // per device, for this instantiation
    if (a.device >= 64) return static_cast<int>(cudaErrorInvalidValue);
    if (!opted_in[a.device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kLimit);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted_in[a.device] = true;
    }
  }
  const dim3 grid(
      static_cast<unsigned>((static_cast<int64_t>(a.U) + TU - 1) / TU),
      static_cast<unsigned>((a.B + TB - 1) / TB));
  kernel<<<grid, NT, static_cast<size_t>(smem), a.stream>>>(
      a.emb, a.stride_bytes, a.target_rows, static_cast<T*>(a.out), a.B,
      a.U, a.H, a.eps, a.hs, a.unit, a.vec);
  return static_cast<int>(cudaGetLastError());
}

// The tiles (TB x TU) and their register tiles (RB x RU) and block sizes;
// graphsage_torch/ops/sddmm.py::SCORE_TILES lists the same.
template <typename T>
int by_tile(int tb, int tu, const Args& a) {
  if (tb == 8 && tu == 8) return launch<T, 8, 8, 1, 1, 128>(a);
  if (tb == 64 && tu == 64) return launch<T, 64, 64, 4, 4, 256>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (emb and out).  emb rows are emb_stride
// elements apart with unit column stride; target_rows int32 [B] and out
// [B, U] are contiguous.  The launch plan: tb x tu, the tile of targets and
// table rows (one of the tiles in by_tile); unit, the bytes of one copy
// (16, 8, 4, or 2 for bfloat16), which must divide emb's address, its row
// stride and its row width in bytes; hs, the columns of a stage (a
// multiple of 8; rows wider than hs take several stages); vec, elements a
// store (4, for U a multiple of 4 and out aligned to 4 elements, or 1).
// Launches on `stream` of `device` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a dtype or plan it does not take.
int gs_pair_scores(int dtype, int device, const void* emb,
                   long long emb_stride, const void* target_rows, void* out,
                   int B, int U, int H, float eps, int tb, int tu, int unit,
                   int hs, int vec, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t elt = dtype == 0 ? 4 : 2;
  const int64_t stride_bytes = static_cast<int64_t>(emb_stride) * elt;
  const bool unit_ok = (unit == 16 || unit == 8 || unit == 4 || unit == 2) &&
                       unit >= elt;
  if (!unit_ok || reinterpret_cast<uintptr_t>(emb) % unit != 0 ||
      stride_bytes % unit != 0 || (H * elt) % unit != 0 || B < 1 || U < 1 ||
      H < 1 || hs < 8 || hs % 8 != 0 || hs > kMaxStage ||
      (vec != 1 && vec != 4) ||
      (vec == 4 && (U % 4 != 0 ||
                    reinterpret_cast<uintptr_t>(out) % (4 * elt) != 0)) ||
      tb < 1 || (static_cast<int64_t>(B) + tb - 1) / tb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const char*>(emb), stride_bytes,
               static_cast<const int32_t*>(target_rows), out, B, U, H, eps,
               hs, unit, vec, device, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_tile<float>(tb, tu, a);
  return by_tile<__nv_bfloat16>(tb, tu, a);
}

const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
