// Row gather out[j] = table[idx[j]] for Hopper (sm_90a).  Built by
// graphsage_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (plain C interface below); the Python wrapper is
// graphsage_torch/ops/gather.py::gather_rows, which also chooses the unit
// (graphsage_torch/ops/aggregate.py::widest_unit).
//
// Replaces the Pallas TPU kernel
//   tools/pallas_microbench.py::gather_kernel
// (per-row async DMA copies HBM -> VMEM, 32 in flight), which measures the
// jnp.take(table, ids, axis=0) row gathers that carry layer 1 of the JAX
// package's leaf-cached pipeline (graphsage_tpu/train/cached.py:198-211).
// The DMA semaphores and the 2048-row tiles are TPU artefacts; this kernel
// recomputes the function, a pure copy of bytes, so it equals index_select
// bit for bit in every dtype and at any row stride.
//
// Bound: bytes.  A call reads the referenced table rows and idx and writes
// rows * D elements; it does no arithmetic.  The bound counts each distinct
// referenced row once, but a repeated id reads its row again, from L2 where
// it is still there: at the microbench shape (495,616 ids over [100000,
// 128] float32) the L2 serves 254 MB of row reads and takes 254 MB of
// writes, which it writes back to device memory.  That read-once,
// write-once traffic through L2, not the device memory rate, sets the time
// on this card.
//
// Design, from measurements on the H100 (PERF.md, PR 4): a warp a row and
// 64 warps an SM (at most 32 registers a thread; with more registers and
// fewer warps the copy was slower).  A lane loads up to kUnits units of the
// row (lane, lane + 32, ...) before it stores any of them, so a 602-wide
// float32 row is three rounds of loads then stores; each store carries the
// streaming hint (st.global.cs: the output is written once and should not
// evict table rows that later ids read).  The host picks the unit, the
// widest of 16, 8, 4 or 2 bytes that divides the table's address, its row
// stride in bytes, the output's address and the row width in bytes: a
// 128-wide float32 row is 32 16-byte units, one a lane; the 602-wide
// float32 rows of the raw features (2408 B, at 0 or 8 mod 16) go as 8-byte
// units.  Copies built around 16-byte transfers at any alignment (a funnel
// shift of two aligned 16-byte loads, or the row staged in shared memory by
// cp.async), and warps that carried a batch of rows each, were at most a
// few percent faster at 128 wide and slower at 602 wide: each needed more
// registers or instructions a row, and the copy is bound by the L2, not by
// the number of accesses.  Index values must lie in [0, M): they are not
// checked here, as the TPU kernel does not check them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;  // threads a block: eight rows
constexpr int kUnits = 4;    // units a lane loads before it stores
constexpr int kMinBlocks = 8;  // blocks an SM: at most 32 registers a thread

template <typename Unit>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
gather_rows_kernel(const char* __restrict__ table, int64_t stride_bytes,
                   const int32_t* __restrict__ idx, char* __restrict__ out,
                   int rows, int units) {
  const int lane = threadIdx.x % kWarp;
  const int64_t j =
      (static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  if (j >= rows) return;  // the whole warp leaves together
  const Unit* src = reinterpret_cast<const Unit*>(
      table + static_cast<int64_t>(__ldg(idx + j)) * stride_bytes);
  Unit* dst = reinterpret_cast<Unit*>(
      out + j * units * static_cast<int64_t>(sizeof(Unit)));
  for (int u0 = 0; u0 < units; u0 += kWarp * kUnits) {
    Unit v[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = u0 + lane + k * kWarp;
      if (u < units) v[k] = __ldg(src + u);
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = u0 + lane + k * kWarp;
      if (u < units) __stcs(dst + u, v[k]);
    }
  }
}

template <typename Unit>
int launch(const void* table, int64_t stride_bytes, const void* idx,
           void* out, int rows, int64_t row_bytes, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(rows) * kWarp;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  gather_rows_kernel<Unit><<<grid, kBlock, 0, stream>>>(
      static_cast<const char*>(table), stride_bytes,
      static_cast<const int32_t*>(idx), static_cast<char*>(out), rows,
      static_cast<int>(row_bytes / static_cast<int64_t>(sizeof(Unit))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (table and out).  idx int32 [rows] is
// contiguous; out [rows, D] is contiguous; table rows are table_stride
// elements apart with unit column stride.  unit (16, 8, 4 or 2 bytes, no
// narrower than an element) is the launch plan: it must divide the table's
// address, its row stride in bytes, the output's address and the row width
// in bytes.  Launches on `stream` of `device` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a dtype
// or plan it does not take.
int gs_gather_rows(int dtype, int device, const void* table,
                   long long table_stride, const void* idx, void* out,
                   int rows, int D, int unit, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t elt = dtype == 0 ? 4 : 2;
  const int64_t stride_bytes = static_cast<int64_t>(table_stride) * elt;
  const int64_t row_bytes = static_cast<int64_t>(D) * elt;
  if (!((unit == 16 || unit == 8 || unit == 4 || unit == 2) && unit >= elt) ||
      reinterpret_cast<uintptr_t>(table) % unit != 0 ||
      reinterpret_cast<uintptr_t>(out) % unit != 0 ||
      stride_bytes % unit != 0 || row_bytes % unit != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16:
      return launch<uint4>(table, stride_bytes, idx, out, rows, row_bytes, s);
    case 8:
      return launch<uint2>(table, stride_bytes, idx, out, rows, row_bytes, s);
    case 4:
      return launch<unsigned int>(table, stride_bytes, idx, out, rows,
                                  row_bytes, s);
    default:
      return launch<unsigned short>(table, stride_bytes, idx, out, rows,
                                    row_bytes, s);
  }
}

const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
