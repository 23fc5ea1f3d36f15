// Ordered bfloat16 scatter-add for Hopper (sm_90a):
//   out[r] = g[j1] + g[j2] + ... over the rows j1 < j2 < ... with idx[j] = r,
// added one at a time in increasing j from a zero start, each add rounded
// to bfloat16.  Built by graphsage_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (plain C interface below); the Python wrapper is
// graphsage_torch/ops/scatter.py::scatter_rows_kernel, which sorts the keys
// between the two launches below (torch.sort, stable).
//
// This is the backward of every row gather that carries a gradient: the
// VJP of the Pallas aggregates (graphsage_tpu/ops/pallas_aggregate.py:147
// _pallas_mean_bwd and :173 _pallas_max_bwd) and of jnp.take, each an XLA
// scatter jnp.zeros_like(embed).at[idx].add(contrib) in the embed dtype.
// XLA on the CPU adds the contributions one at a time in index order, each
// add rounded to bfloat16 (tests/test_torch_bf16.py holds this port
// against the JAX package's VJPs bit for bit there; the TPU's order is not
// measured).  In bfloat16 the order
// decides the result: a running sum stops growing once it is about 256
// times a term, so a hub row of the power-law graph, thousands of
// contributions, ends far from its exact sum, and where it ends depends
// on the order.  Atomic adds (index_add_ on the card) add in a varying
// order; this kernel adds in JAX's.
//
// Design.  The order within a row is sequential by definition, so the
// parallelism is across rows and columns:
//   1. scatter_keys: a warp a contribution row; key = its target row, or
//      M when every element is +-0 (adding +-0 to a sum that started at +0
//      leaves it unchanged, so those rows are skipped exactly: the
//      sampler's padding slots send many zero rows to one id);
//   2. the host sorts the keys, stable, so each row's contributions keep
//      their index order;
//   3. row_starts: the CSR offsets of the sorted keys, a thread a key;
//   4. scatter_rows: a warp a (row, 64 columns); the lanes read 32 sorted
//      positions at once, then each lane loads the 32 contributions' two
//      columns (one 32-bit word; 16-bit loads for an odd width) and adds
//      them in order with the hardware's bfloat16 add (add.rn.bf16x2, one
//      instruction a pair of columns).  A row of more than kLong
//      contributions goes on a list instead;
//   5. scatter_long: a block a listed (row, 64 columns), its warps loading
//      the next 128 contributions into shared memory while one warp adds
//      the current 128.  A warp alone pays a load latency per 32 adds
//      (measured on the H100: ~3 us a batch, 1.4 ms for a row of 16,000);
//      a hub row of the power-law graph has thousands.
// Every output element is written, rows with no contribution as +0.
// Bound: bytes (each nonzero contribution read once, the output written
// once); a row with n contributions is a chain of n dependent adds, so a
// hub row's chain, not the bytes, can set the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLong = 256;   // a row with more contributions takes a block
constexpr int kStage = 128;  // contributions a block stages at a time
constexpr int kLongBlocks = 264;  // two a streaming multiprocessor

template <typename Word>
__global__ void __launch_bounds__(kBlock)
scatter_keys_kernel(const Word* __restrict__ g, int64_t words,
                    const int32_t* __restrict__ idx,
                    int32_t* __restrict__ keys, int64_t rows, int sentinel,
                    Word magnitude) {
  const int lane = threadIdx.x % kWarp;
  const int64_t j =
      (static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  if (j >= rows) return;  // the whole warp leaves together
  const Word* row = g + j * words;
  Word bits = 0;
  for (int64_t w = lane; w < words; w += kWarp) bits |= __ldg(row + w);
  const bool nonzero = __any_sync(kFull, (bits & magnitude) != 0);
  if (lane == 0) keys[j] = nonzero ? __ldg(idx + j) : sentinel;
}

// starts[r] = the first position k of the sorted keys with keys[k] >= r,
// for r in [0, M]; sentinel keys (M) sort last and start no row.  Also
// empties the long list.
__global__ void __launch_bounds__(kBlock)
row_starts_kernel(const int32_t* __restrict__ keys, int64_t n, int M,
                  long long* __restrict__ starts,
                  int* __restrict__ long_count) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (k == 0) *long_count = 0;
  if (k > n) return;
  const int prev = k == 0 ? -1 : __ldg(keys + k - 1);
  const int cur = k == n ? M : __ldg(keys + k);
  for (int r = prev + 1; r <= cur; ++r) starts[r] = k;
}

// The correctly rounded bfloat16 add (round to nearest even), two columns
// or one.  The CPU computes a float32 add rounded to bfloat16: the same
// value, since the exact sum of two bfloat16 numbers either fits in
// float32 or lies far from a bfloat16 rounding boundary.
__device__ __forceinline__ uint32_t add_bf16(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint16_t add_bf16(uint16_t a, uint16_t b) {
  uint16_t d;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

// The lane's columns of the contributions at sorted positions [k0, k0 +
// n), n <= 32, +0 past hi: adding +0 leaves a sum that started at +0
// unchanged.  Lane t reads position k0 + t, and the warp shares it.
template <int kN, typename Word>
__device__ __forceinline__ void load_batch(Word (&v)[kN],
                                           const uint16_t* __restrict__ g,
                                           int D, int col, bool active,
                                           const long long* __restrict__ order,
                                           long long k0, long long hi,
                                           int lane) {
  const int t0 = lane % kN;
  const long long mine = k0 + t0 < hi ? __ldg(order + k0 + t0) : -1;
#pragma unroll
  for (int t = 0; t < kN; ++t) {
    const long long j = __shfl_sync(kFull, mine, t);
    v[t] = j >= 0 && active
               ? __ldg(reinterpret_cast<const Word*>(
                     g + j * static_cast<int64_t>(D) + col))
               : Word(0);
  }
}

// Short rows (at most kLong contributions): a warp a (row, 32 * kVec
// columns), one batch of 32 contributions at a time.  A longer row's
// (row, chunk) goes on the long list for scatter_long_kernel.
template <int kVec>  // bfloat16 columns a lane: 2 (a 32-bit word) or 1
__global__ void __launch_bounds__(kBlock)
scatter_rows_kernel(const uint16_t* __restrict__ g, int D,
                    const long long* __restrict__ order,
                    const long long* __restrict__ starts,
                    uint16_t* __restrict__ out, int M, int chunks,
                    int* __restrict__ long_list,
                    int* __restrict__ long_count) {
  using Word =
      typename std::conditional<kVec == 2, uint32_t, uint16_t>::type;
  const int lane = threadIdx.x % kWarp;
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  if (w >= static_cast<int64_t>(M) * chunks) return;  // warp-uniform
  const int row = static_cast<int>(w / chunks);
  const int col = static_cast<int>(w % chunks) * kWarp * kVec + lane * kVec;
  const bool active = col < D;
  const long long lo = __ldg(starts + row);
  const long long hi = __ldg(starts + row + 1);
  if (hi - lo > kLong) {
    if (lane == 0)
      long_list[atomicAdd(long_count, 1)] = static_cast<int>(w);
    return;
  }
  Word acc = 0;
  for (long long k0 = lo; k0 < hi; k0 += kWarp) {
    Word v[kWarp];
    load_batch(v, g, D, col, active, order, k0, hi, lane);
#pragma unroll
    for (int t = 0; t < kWarp; ++t) acc = add_bf16(acc, v[t]);
  }
  if (active)
    *reinterpret_cast<Word*>(out + static_cast<int64_t>(row) * D + col) =
        acc;
}

// Long rows: a block an item of the long list, a (row, chunk) whose chain
// of adds is longer than kLong.  The block's warps load the next kStage
// contributions (each warp kStage / 8 of them) into registers while warp 0
// adds the current stage from shared memory; then they store the next
// stage into the other buffer.  So a stage's loads are in flight while the
// previous stage is added, 128 contributions at a time, where a warp alone
// would wait for one batch of 32 after another.  Persistent: the blocks
// loop over the list, whose length the short-row kernel wrote.
template <int kVec>
__global__ void __launch_bounds__(kBlock)
scatter_long_kernel(const uint16_t* __restrict__ g, int D,
                    const long long* __restrict__ order,
                    const long long* __restrict__ starts,
                    uint16_t* __restrict__ out, int chunks,
                    const int* __restrict__ long_list,
                    const int* __restrict__ long_count) {
  using Word =
      typename std::conditional<kVec == 2, uint32_t, uint16_t>::type;
  constexpr int kPerWarp = kStage / (kBlock / kWarp);
  __shared__ Word stage[2][kStage][kWarp];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int items = *long_count;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int w = long_list[item];
    const int row = w / chunks;
    const int col = (w % chunks) * kWarp * kVec + lane * kVec;
    const bool active = col < D;
    const long long lo = __ldg(starts + row);
    const long long hi = __ldg(starts + row + 1);
    Word v[kPerWarp];
    load_batch(v, g, D, col, active, order, lo + warp * kPerWarp, hi, lane);
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t)
      stage[0][warp * kPerWarp + t][lane] = v[t];
    __syncthreads();
    Word acc = 0;
    int buf = 0;
    for (long long k0 = lo; k0 < hi; k0 += kStage) {
      const bool more = k0 + kStage < hi;
      if (more)
        load_batch(v, g, D, col, active, order,
                   k0 + kStage + warp * kPerWarp, hi, lane);
      if (warp == 0) {
#pragma unroll 16
        for (int t = 0; t < kStage; ++t)
          acc = add_bf16(acc, stage[buf][t][lane]);
      }
      if (more) {
#pragma unroll
        for (int t = 0; t < kPerWarp; ++t)
          stage[buf ^ 1][warp * kPerWarp + t][lane] = v[t];
      }
      __syncthreads();
      buf ^= 1;
    }
    if (warp == 0 && active)
      *reinterpret_cast<Word*>(out + static_cast<int64_t>(row) * D + col) =
          acc;
  }
}

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kBlock - 1) / kBlock);
}

}  // namespace

extern "C" {

// Pass 1.  g: [J, D] bfloat16, contiguous; idx: [J] int32 in [0, M);
// keys: [J] int32, written.  Launches on `stream` of `device`; returns
// cudaGetLastError() (0 on success) or cudaErrorInvalidValue.
int gs_scatter_keys(int device, const void* g, const void* idx, void* keys,
                    long long J, int D, int M, void* stream) {
  if (J < 0 || D < 1 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (J == 0) return 0;
  const dim3 grid(blocks_for(J * kWarp));
  if (D % 2 == 0 && reinterpret_cast<uintptr_t>(g) % 4 == 0)
    scatter_keys_kernel<uint32_t><<<grid, kBlock, 0, s>>>(
        static_cast<const uint32_t*>(g), D / 2,
        static_cast<const int32_t*>(idx), static_cast<int32_t*>(keys), J, M,
        0x7fff7fffu);
  else
    scatter_keys_kernel<uint16_t><<<grid, kBlock, 0, s>>>(
        static_cast<const uint16_t*>(g), D,
        static_cast<const int32_t*>(idx), static_cast<int32_t*>(keys), J, M,
        static_cast<uint16_t>(0x7fffu));
  return static_cast<int>(cudaGetLastError());
}

// The int32 scratch that pass 2 needs for J contributions of D columns
// under plan vec: the long list's length, then its items, at most one a
// (row, chunk) with more than kLong contributions.
long long gs_scatter_work(long long J, int D, int vec) {
  const long long chunks = (D + kWarp * vec - 1) / (kWarp * vec);
  return 1 + J / (kLong + 1) * chunks;
}

// Pass 2, after the keys are sorted (stable): sorted_keys [J] int32, order
// [J] int64 (the positions of the sorted keys in g), starts [M + 1] int64
// and work [gs_scatter_work(J, D, vec)] int32 (scratch), out [M, D]
// bfloat16 contiguous, every element written.  vec (2 or 1) is the plan: 2
// needs D even and g and out at 4-byte addresses.
int gs_scatter_rows(int device, const void* g, const void* sorted_keys,
                    const void* order, void* starts, void* work, void* out,
                    long long J, int D, int M, int vec, void* stream) {
  if (J < 0 || D < 1 || M < 0 || (vec != 1 && vec != 2) ||
      (vec == 2 && (D % 2 != 0 || reinterpret_cast<uintptr_t>(g) % 4 != 0 ||
                    reinterpret_cast<uintptr_t>(out) % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* count = static_cast<int*>(work);
  int* list = count + 1;
  row_starts_kernel<<<blocks_for(J + 1), kBlock, 0, s>>>(
      static_cast<const int32_t*>(sorted_keys), J, M,
      static_cast<long long*>(starts), count);
  err = cudaGetLastError();
  if (err != cudaSuccess || M == 0) return static_cast<int>(err);
  const int chunks = (D + kWarp * vec - 1) / (kWarp * vec);
  const dim3 grid(blocks_for(static_cast<int64_t>(M) * chunks * kWarp));
  const uint16_t* g16 = static_cast<const uint16_t*>(g);
  const long long* order64 = static_cast<const long long*>(order);
  const long long* starts64 = static_cast<const long long*>(starts);
  uint16_t* out16 = static_cast<uint16_t*>(out);
  if (vec == 2) {
    scatter_rows_kernel<2><<<grid, kBlock, 0, s>>>(
        g16, D, order64, starts64, out16, M, chunks, list, count);
    scatter_long_kernel<2><<<kLongBlocks, kBlock, 0, s>>>(
        g16, D, order64, starts64, out16, chunks, list, count);
  } else {
    scatter_rows_kernel<1><<<grid, kBlock, 0, s>>>(
        g16, D, order64, starts64, out16, M, chunks, list, count);
    scatter_long_kernel<1><<<kLongBlocks, kBlock, 0, s>>>(
        g16, D, order64, starts64, out16, chunks, list, count);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
