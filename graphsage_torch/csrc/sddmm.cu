// Fused row-normalise + score block for the unsupervised losses, for Hopper
// (sm_90a).  Built by graphsage_torch/ops/build.py into its own library
// (nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC) and bound with ctypes (plain C interface below); the
// Python wrapper is graphsage_torch/ops/sddmm.py::pair_scores_kernel.
//
// Replaces the Pallas TPU kernel
//   graphsage_tpu/ops/sddmm.py::_scores_kernel  (pair_scores)
// and computes what it computes:
//   scores[b, u] = < emb[t_b] / max(|emb[t_b]|, eps),
//                    emb[u] / max(|emb[u]|, eps) >
// with t_b = target_rows[b], norms and products in float32, and one
// rounding to the emb dtype at the store.  A row of zero norm gives 0.
// The kernel reads target_rows itself, so the [B, H] copy of the target
// rows that the TPU wrapper takes (sddmm.py:184) is never built, and the
// normalised table is never written to device memory.
//
// Bound: at the training shape (B = 20 targets, U = 4096 rows, H = 128,
// f32) bytes: 2.1 MB of table read and 0.33 MB of scores written, about
// 0.7 us at 3.35 TB/s, far below a launch's own latency.  At [512 x 2048]
// operations: 2*B*U*H = 268 MFLOP, about 4.0 us at 67 TFLOP/s (f32 on the
// CUDA cores), against 1.6 us of bytes.
//
// Design, simple first (wgmma and TMA are a later PR's work): one block of
// 256 threads per tile of kTB = 32 targets x kTU = 64 table rows.
// 1. Norms: each warp takes rows of the tile (targets, then table rows),
//    lanes stride over the columns (coalesced), the sum of squares is
//    reduced with __shfl_xor_sync, and max(sqrt(ss), eps) goes to shared
//    memory.
// 2. Products: the H columns are walked in chunks of kHC = 32.  The chunk
//    of every target and table row is loaded, divided by its row's norm
//    (a division, as the plain version divides), and staged in shared
//    memory (rows padded to kHC + 1 floats: no bank conflicts).  Each
//    thread owns one table row and kTB / 4 = 8 targets and accumulates
//    their dot products with f32 FMAs on the CUDA cores.
// 3. Store: a warp writes 32 neighbouring columns of one score row,
//    coalesced; rows and columns past B and U are masked.
// Any H works (columns past H are zero in the last chunk), and so does any
// row stride with unit column stride.  Index values in target_rows must lie
// in [0, U): they are not checked here, as the TPU kernel does not check
// them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kTB = 32;                      // targets per block
constexpr int kTU = 64;                      // table rows per block
constexpr int kHC = 32;                      // columns per chunk
constexpr int kTargetsPerThread = kTB / (kThreads / kTU);  // 8
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, once
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pair_scores_kernel(const T* __restrict__ emb, int64_t emb_stride,
                   const int32_t* __restrict__ target_rows,
                   T* __restrict__ out, int B, int U, int H, float eps) {
  __shared__ float s_t[kTB][kHC + 1];
  __shared__ float s_e[kTU][kHC + 1];
  __shared__ float s_tnorm[kTB];
  __shared__ float s_enorm[kTU];
  __shared__ int64_t s_trow[kTB];

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int u0 = blockIdx.x * kTU;   // x: up to 2^31 - 1 tiles of U
  const int b0 = blockIdx.y * kTB;   // y: up to 65535 tiles of B

  if (tid < kTB) {
    const int b = b0 + tid;
    s_trow[tid] = b < B ? static_cast<int64_t>(__ldg(target_rows + b)) : -1;
  }
  __syncthreads();

  // 1. norms of the tile's target rows and table rows, one warp per row
  for (int r = warp; r < kTB + kTU; r += kWarps) {
    int64_t row;
    if (r < kTB) {
      row = s_trow[r];
    } else {
      const int u = u0 + r - kTB;
      row = u < U ? u : -1;
    }
    float ss = 0.0f;
    if (row >= 0) {
      const T* src = emb + row * emb_stride;
      for (int c = lane; c < H; c += kWarp) {
        const float v = load_f32(src + c);
        ss = fmaf(v, v, ss);
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      ss += __shfl_xor_sync(kFullMask, ss, off);
    if (lane == 0) {
      const float norm = fmaxf(sqrtf(ss), eps);
      if (r < kTB)
        s_tnorm[r] = norm;
      else
        s_enorm[r - kTB] = norm;
    }
  }
  __syncthreads();

  // 2. products over column chunks
  const int tu = tid % kTU;                          // this thread's table row
  const int tb0 = (tid / kTU) * kTargetsPerThread;   // and its first target
  float acc[kTargetsPerThread];
#pragma unroll
  for (int i = 0; i < kTargetsPerThread; ++i) acc[i] = 0.0f;

  for (int h0 = 0; h0 < H; h0 += kHC) {
    // stage the chunk: lanes take neighbouring columns of one row
    for (int r = warp; r < kTB + kTU; r += kWarps) {
      const int c = h0 + lane;
      float v = 0.0f;
      if (r < kTB) {
        const int64_t row = s_trow[r];
        if (row >= 0 && c < H)
          v = load_f32(emb + row * emb_stride + c) / s_tnorm[r];
        s_t[r][lane] = v;
      } else {
        const int u = u0 + r - kTB;
        if (u < U && c < H)
          v = load_f32(emb + static_cast<int64_t>(u) * emb_stride + c) /
              s_enorm[r - kTB];
        s_e[r - kTB][lane] = v;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kHC; ++c) {
      const float e = s_e[tu][c];
#pragma unroll
      for (int i = 0; i < kTargetsPerThread; ++i)
        acc[i] = fmaf(s_t[tb0 + i][c], e, acc[i]);
    }
    __syncthreads();
  }

  // 3. store
  const int u = u0 + tu;
  if (u < U) {
#pragma unroll
    for (int i = 0; i < kTargetsPerThread; ++i) {
      const int b = b0 + tb0 + i;
      if (b < B) store(out + static_cast<int64_t>(b) * U + u, acc[i]);
    }
  }
}

template <typename T>
int launch(int device, const void* emb, long long emb_stride,
           const void* target_rows, void* out, int B, int U, int H,
           float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kThreads);
  const dim3 grid((U + kTU - 1) / kTU, (B + kTB - 1) / kTB);
  pair_scores_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(emb), static_cast<int64_t>(emb_stride),
      static_cast<const int32_t*>(target_rows), static_cast<T*>(out), B, U, H,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (emb and out).  emb rows are emb_stride
// elements apart with unit column stride; target_rows int32 [B] and out
// [B, U] are contiguous.  Launches on `stream` of `device` and returns
// cudaGetLastError() (0 on success).
int gs_pair_scores(int dtype, int device, const void* emb,
                   long long emb_stride, const void* target_rows, void* out,
                   int B, int U, int H, float eps, void* stream) {
  if (dtype == 0)
    return launch<float>(device, emb, emb_stride, target_rows, out, B, U, H,
                         eps, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(device, emb, emb_stride, target_rows, out, B,
                                 U, H, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
