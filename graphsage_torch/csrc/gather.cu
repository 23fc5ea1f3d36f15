// Row gather out[j, :] = table[idx[j], :] for Hopper (sm_90a).  Built by
// graphsage_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (plain C interface below); the Python wrapper is
// graphsage_torch/ops/gather.py::gather_rows.
//
// Replaces the Pallas TPU kernel
//   tools/pallas_microbench.py::gather_kernel
// (one DMA per row, 32 in flight, tiles of 2048 rows), the probe of the
// jnp.take(table, ids, axis=0) row gathers that carry layer 1 of the JAX
// package's leaf-cached pipeline (graphsage_tpu/train/cached.py:198-211).
// The DMA semaphores and the 2048-row tiles are TPU artefacts; this kernel
// recomputes the function, a pure copy of rows.
//
// Bound: bytes.  A call reads the referenced table rows and idx and writes
// rows * D elements; it does no arithmetic.  At the microbench shape
// (495,616 ids into [100000, 128] float32) that is 2 x 254 MB plus 2 MB of
// indices, about 0.15 ms at 3.35 TB/s.
//
// Design, for the bytes: one warp per output row, eight rows per block.
// The copy is of bytes, not of values, so the result equals
// index_select bit for bit in every dtype.  The host picks the widest unit
// (16, 8, 4 or 2 bytes) that divides the table's address, its row stride
// in bytes, the output's address and the row width in bytes; lanes copy
// units lane, lane + 32, ..., so each row is read and written in coalesced
// runs.  A 128-wide float32 row is 32 16-byte units, one load and one
// store per lane; the 602-wide float32 rows of the raw features (2408 B,
// 8-byte aligned) go as 8-byte units.  Any row stride works (a strided view
// costs nothing).  Index values must lie in [0, M): they are not checked
// here, as the TPU kernel does not check them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

template <typename Unit>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
gather_rows_kernel(const char* __restrict__ table, int64_t stride_bytes,
                   const int32_t* __restrict__ idx, char* __restrict__ out,
                   int rows, int units) {
  const int lane = threadIdx.x % kWarp;
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (j >= rows) return;  // the whole warp leaves together
  const int64_t src_row = __ldg(idx + j);
  const Unit* src =
      reinterpret_cast<const Unit*>(table + src_row * stride_bytes);
  Unit* dst = reinterpret_cast<Unit*>(
      out + j * static_cast<int64_t>(units) * sizeof(Unit));
  for (int u = lane; u < units; u += kWarp) dst[u] = __ldg(src + u);
}

template <typename Unit>
int launch(const void* table, int64_t stride_bytes, const void* idx,
           void* out, int rows, int64_t row_bytes, cudaStream_t stream) {
  const dim3 block(kWarp * kRowsPerBlock);
  const dim3 grid(static_cast<unsigned>(
      (static_cast<int64_t>(rows) + kRowsPerBlock - 1) / kRowsPerBlock));
  gather_rows_kernel<Unit><<<grid, block, 0, stream>>>(
      static_cast<const char*>(table), stride_bytes,
      static_cast<const int32_t*>(idx), static_cast<char*>(out), rows,
      static_cast<int>(row_bytes / static_cast<int64_t>(sizeof(Unit))));
  return static_cast<int>(cudaGetLastError());
}

bool divides(int64_t unit, uintptr_t table, int64_t stride_bytes,
             uintptr_t out, int64_t row_bytes) {
  return table % unit == 0 && stride_bytes % unit == 0 && out % unit == 0 &&
         row_bytes % unit == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (table and out).  idx int32 [rows] is
// contiguous; out [rows, D] is contiguous; table rows are table_stride
// elements apart with unit column stride.  Launches on `stream` of
// `device` and returns cudaGetLastError() (0 on success).
int gs_gather_rows(int dtype, int device, const void* table,
                   long long table_stride, const void* idx, void* out,
                   int rows, int D, void* stream) {
  int64_t elt;
  if (dtype == 0) {
    elt = 4;
  } else if (dtype == 1) {
    elt = 2;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t stride_bytes = static_cast<int64_t>(table_stride) * elt;
  const int64_t row_bytes = static_cast<int64_t>(D) * elt;
  const uintptr_t t = reinterpret_cast<uintptr_t>(table);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (divides(16, t, stride_bytes, o, row_bytes))
    return launch<uint4>(table, stride_bytes, idx, out, rows, row_bytes, s);
  if (divides(8, t, stride_bytes, o, row_bytes))
    return launch<uint2>(table, stride_bytes, idx, out, rows, row_bytes, s);
  if (divides(4, t, stride_bytes, o, row_bytes))
    return launch<unsigned int>(table, stride_bytes, idx, out, rows,
                                row_bytes, s);
  return launch<unsigned short>(table, stride_bytes, idx, out, rows,
                                row_bytes, s);
}

const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
