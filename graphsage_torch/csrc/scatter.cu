// Ordered bfloat16 scatter-add for Hopper (sm_90a):
//   out[r] = g[j1] + g[j2] + ... over the rows j1 < j2 < ... with idx[j] = r,
// added one at a time in increasing j from a zero start, each add rounded
// to bfloat16.  Built by graphsage_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (plain C interface below); the Python wrapper is
// graphsage_torch/ops/scatter.py::scatter_rows_kernel, which chooses the
// launch plan (scatter_plan) and makes one call of gs_scatter_rows.
//
// This is the backward of every row gather that carries a gradient: the
// VJP of the Pallas aggregates (graphsage_tpu/ops/pallas_aggregate.py:147
// _pallas_mean_bwd and :173 _pallas_max_bwd) and of jnp.take, each an XLA
// scatter jnp.zeros_like(embed).at[idx].add(contrib) in the embed dtype.
// XLA on the CPU adds the contributions one at a time in index order, each
// add rounded to bfloat16 (tests/test_torch_bf16.py holds this port
// against the JAX package's VJPs bit for bit there; the TPU's order is not
// measured).  In bfloat16 the order decides the result: a running sum
// stops growing once it is about 256 times a term, so a hub row of the
// power-law graph, thousands of contributions, ends far from its exact
// sum, and where it ends depends on the order.  Atomic adds (index_add_ on
// the card) add in a varying order; this kernel adds in JAX's.
//
// Design: a counting sort by row in this file's own kernels, then each
// row's chain of adds.  The order within a row is sequential by
// definition, so the parallelism is across rows and columns.  One call is
// a memset of the scratch and three launches:
//   1. count: a group of lanes a contribution row reads it with the widest
//      load the plan allows (16 bytes a lane at width 128), four rows a
//      group at once; a row that is +-0 in every element is skipped (added
//      to a sum that started at +0 it leaves the sum unchanged; the
//      sampler's padding slots send many such rows to one id), the others
//      count one for their target row by atomicAdd and keep their key;
//   2. place: a block of 256 contributions gathers them by row in a shared
//      hash table, so a row takes one atomicAdd on its cursor a block (a
//      hub row's cursor would serialise the pass); the row's first arrival
//      allocates the row's segment from a bump counter (segments lie in
//      any order: only a row's own segment matters) and publishes it. A
//      block's share of a row is a run in index order, marked with its
//      block and length; the runs lie in the segment in arrival order.  A
//      row of more than k_long contributions goes on the long list;
//   3. sum, one launch for both kinds of row:
//      - short rows (at most k_long, 64): 16 lanes of 8 columns a row at
//        width 128 (two rows a warp, four add.rn.bf16x2 chains a lane),
//        else a warp a row.  The row's positions are sorted in registers
//        by a bitonic network over shuffles, only as many stages as n
//        needs; positions are distinct, so sorting them restores index
//        order exactly.  Up to 16 contributions' loads issue before the
//        first add, and a row adds exactly n;
//      - long rows: the first long_blocks blocks take the long list (then
//        the rest of it, an item at a time), a row's columns in two halves
//        on two blocks where there are two or more chunks of 64.  The block
//        sorts the row (at most 256 positions: one warp in registers; else
//        its runs ordered by block index, in windows of long_smem / 8
//        place blocks, every window re-reading the run marks, so a row
//        spread over more blocks than a window holds is still exact, in
//        more passes), then warps 1-7 stream the sorted contributions into
//        a ring of 64-contribution slots by cp.async while warp 0 adds: the
//        slots' full and empty waits are mbarriers, so the adding warp
//        waits on no block-wide barrier, and it reads its operands from
//        shared memory 8 adds ahead.
// Every output element is written, rows with no contribution as +0.
// Bound: bytes (g read once for the zero test, the ids, the output
// written once); a row with n contributions is a chain of n dependent
// adds (gs_scatter_add_latency measures one add's latency), so a hub row's
// chain, not the bytes, can set the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 256;
constexpr int kWarps = kBlock / kWarp;
constexpr int kPlace = 256;      // place pass: contributions a block
constexpr int kRunBits = 9;      // a run mark's length bits (runs <= kPlace)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCountRows = 4;    // count pass: rows a lane group reads at once
constexpr int kMaxLong = 256;    // short rows: at most 8 positions a lane
constexpr int kBatch = 16;       // short rows: loads issued before the adds
                                 // (fewer at 8 columns a lane or K = 8)
constexpr int kSlotRows = 64;    // long rows: contributions a ring slot holds
constexpr int kAhead = 8;        // long rows: operands read ahead of the adds
constexpr int kSortLoads = 8;    // long rows: run marks a thread reads at once
constexpr int kMaxSlots = 64;
constexpr int kMaxSmem = 200 * 1024;  // dynamic shared memory of a block
// scratch: bump, long count, long items taken, spare
constexpr int kHeader = 4;
constexpr int kNone = 0x7fffffff;

// ------------------------------------------------------------ bf16 adds

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

__device__ __forceinline__ uint2 add_bf16(uint2 a, uint2 b) {
  return make_uint2(add_bf16(a.x, b.x), add_bf16(a.y, b.y));
}

__device__ __forceinline__ uint4 add_bf16(uint4 a, uint4 b) {
  return make_uint4(add_bf16(a.x, b.x), add_bf16(a.y, b.y),
                    add_bf16(a.z, b.z), add_bf16(a.w, b.w));
}

// the bfloat16 columns a lane holds: 8 (four bf16x2 chains), 4, 2 or 1
template <int kVec>
using Word = typename std::conditional<
    kVec == 8, uint4,
    typename std::conditional<
        kVec == 4, uint2,
        typename std::conditional<kVec == 2, uint32_t,
                                  uint16_t>::type>::type>::type;

template <typename W>
__device__ __forceinline__ W zero_word() {
  return W{};
}

// ------------------------------------------------------------ pass 1

// the magnitude bits of a load unit: nonzero unless every element is +-0
__device__ __forceinline__ uint32_t magnitude(uint4 v) {
  return (v.x | v.y | v.z | v.w) & 0x7fff7fffu;
}
__device__ __forceinline__ uint32_t magnitude(uint2 v) {
  return (v.x | v.y) & 0x7fff7fffu;
}
__device__ __forceinline__ uint32_t magnitude(uint32_t v) {
  return v & 0x7fff7fffu;
}
__device__ __forceinline__ uint32_t magnitude(uint16_t v) {
  return v & 0x7fffu;
}

// A group of `group` lanes a contribution row, kCountRows rows a group at
// once (their loads all issue before the test).  key[j] = idx[j] for a
// nonzero row with an id in [0, M), else -1 (an id outside is not added).
template <typename Unit>
__global__ void __launch_bounds__(kBlock)
count_kernel(const Unit* __restrict__ g, int units, int group,
             const int32_t* __restrict__ idx, int64_t J, int M,
             int32_t* __restrict__ keys, int32_t* __restrict__ cnt) {
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % group;
  const int groups = kWarp / group;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  const int64_t first = warp * groups * kCountRows + lane / group;
  uint32_t bits[kCountRows] = {};
  for (int u = sub; u < units; u += group) {
#pragma unroll
    for (int r = 0; r < kCountRows; ++r) {
      const int64_t j = first + static_cast<int64_t>(r) * groups;
      if (j < J) bits[r] |= magnitude(__ldg(g + j * units + u));
    }
  }
  const unsigned mine =
      group == kWarp ? kFull : ((1u << group) - 1) << (lane - sub);
#pragma unroll
  for (int r = 0; r < kCountRows; ++r) {
    const bool nonzero = (__ballot_sync(kFull, bits[r] != 0) & mine) != 0;
    const int64_t j = first + static_cast<int64_t>(r) * groups;
    if (sub == 0 && j < J) {
      const int row = __ldg(idx + j);
      const bool keep =
          nonzero && static_cast<unsigned>(row) < static_cast<unsigned>(M);
      keys[j] = keep ? row : -1;
      if (keep) atomicAdd(cnt + row, 1);
    }
  }
}

// ------------------------------------------------------------ pass 2

// The block's exclusive prefix of v; *total gets the block's sum.
template <int kBlockWarps>
__device__ __forceinline__ int block_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int x = v;
#pragma unroll
  for (int o = 1; o < kWarp; o *= 2) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == kWarp - 1) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kBlockWarps ? scratch[lane] : 0;
#pragma unroll
    for (int o = 1; o < kBlockWarps; o *= 2) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kBlockWarps) scratch[lane] = s;
  }
  __syncthreads();
  *total = scratch[kBlockWarps - 1];
  return (warp == 0 ? 0 : scratch[warp - 1]) + x - v;
}

// A thread a contribution, kPlace a block: pos[segment of its row + its
// slot] = j.  The block first gathers its contributions by row in a shared
// hash table
// (one entry a distinct row, with its count from each warp), so a row
// takes one atomicAdd on its global cursor a block, however many of the
// block's contributions it has: a hub row's cursor is one address, and its
// atomics would serialise the pass.  Within the block a row's
// contributions keep their index order (warp by warp, lane by lane): each
// block's share of a row is a sorted run, whose first slot gets
// run = (block + 1) << kRunBits | its length (0 elsewhere) for the long
// rows' sort.  A row's first arrival takes the row's segment from the block's
// share of the bump counter (one atomicAdd a block) and publishes it;
// later arrivals wait for it, after their own block has published all of
// its own.  The runs lie in the segment in no particular order.
__global__ void __launch_bounds__(kPlace)
place_kernel(const int32_t* __restrict__ keys, int64_t J,
             const int32_t* __restrict__ cnt, int32_t* __restrict__ cur,
             int32_t* __restrict__ seg, int32_t* __restrict__ header,
             int32_t* __restrict__ long_list, int k_long,
             int32_t* __restrict__ pos, uint32_t* __restrict__ run) {
  constexpr int kPlaceWarps = kPlace / kWarp;
  __shared__ int table_key[kPlace], table_count[kPlace], table_at[kPlace];
  __shared__ int table_warp[kPlace * kPlaceWarps];  // a (row, warp)'s count
  __shared__ int scratch[kPlaceWarps];
  __shared__ int block_base;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  table_key[tid] = -1;
  for (int i = tid; i < kPlace * kPlaceWarps; i += kPlace) table_warp[i] = 0;
  __syncthreads();
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPlace + tid;
  const int key = j < J ? keys[j] : -1;
  const unsigned peers = __match_any_sync(kFull, key);
  const int leader = __ffs(peers) - 1;
  const int below = __popc(peers & ((1u << lane) - 1));
  int entry = 0;
  if (key >= 0 && lane == leader) {  // at most kPlace rows: an entry is free
    entry = static_cast<int>((static_cast<uint32_t>(key) * 2654435761u) >>
                             24) % kPlace;
    for (;;) {
      const int was = atomicCAS(table_key + entry, -1, key);
      if (was == -1 || was == key) break;
      entry = (entry + 1) % kPlace;
    }
    table_warp[entry * kPlaceWarps + warp] = __popc(peers);
  }
  entry = __shfl_sync(kFull, entry, leader);
  __syncthreads();
  // thread t: table entry t; its warps' counts become their prefix
  const int row = table_key[tid];
  int count = 0;
  if (row >= 0) {
#pragma unroll
    for (int w = 0; w < kPlaceWarps; ++w) {
      const int c = table_warp[tid * kPlaceWarps + w];
      table_warp[tid * kPlaceWarps + w] = count;
      count += c;
    }
    table_count[tid] = count;
  }
  const int c0 = row >= 0 ? atomicAdd(cur + row, count) : 0;
  const bool first = row >= 0 && c0 == 0;
  const int n = first ? cnt[row] : 0;
  int total;
  const int before = block_scan<kPlaceWarps>(n, scratch, &total);
  if (tid == 0 && total > 0) block_base = atomicAdd(header, total);
  __syncthreads();
  int base = 0;
  if (first) {  // the row's first arrival: allocate and publish
    base = block_base + before;
    if (n > k_long) long_list[atomicAdd(header + 1, 1)] = row;
    atomicExch(seg + row, base + 1);
  }
  __syncwarp();  // this warp's allocations are published before it waits
  if (row >= 0 && !first) {
    const volatile int32_t* published = seg + row;
    int s;
    while ((s = *published) == 0) __nanosleep(32);
    base = s - 1;
  }
  if (row >= 0) table_at[tid] = base + c0;
  __syncthreads();
  if (key >= 0) {
    const int rank = table_warp[entry * kPlaceWarps + warp] + below;
    const int at = table_at[entry] + rank;
    pos[at] = static_cast<int32_t>(j);
    run[at] = rank == 0
                  ? (static_cast<uint32_t>(blockIdx.x) + 1) << kRunBits |
                        static_cast<uint32_t>(table_count[entry])
                  : 0u;
  }
}

// ------------------------------------------------------------ pass 3

// Bitonic sort, ascending, within each segment of kLanes lanes, of
// element e = k * kLanes + lane % kLanes over the first power of two >= n
// elements (n the same in every segment; kNone beyond a segment's own count
// sorts last); the stages past that size are skipped.
template <int K, int kLanes>
__device__ __forceinline__ void warp_sort(int (&p)[K], int lane, int n) {
  constexpr int kLog = (kLanes == 32 ? 5 : 4) + (K == 1   ? 0
                                                 : K == 2 ? 1
                                                 : K == 4 ? 2
                                                          : 3);
  const int sl = lane % kLanes;
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
    const int size = 1 << ls;
    if (size / 2 >= n) break;
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int stride = 1 << lt;
      if (stride >= kLanes) {
        const int ks = stride / kLanes;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if ((k & ks) == 0) {
            const bool up = ((k * kLanes + sl) & size) == 0;
            const int a = p[k], b = p[k | ks];
            if ((a > b) == up) {
              p[k] = b;
              p[k | ks] = a;
            }
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int other = __shfl_xor_sync(kFull, p[k], stride);
          const bool up = ((k * kLanes + sl) & size) == 0;
          const bool lower = (sl & stride) == 0;
          p[k] = lower == up ? min(p[k], other) : max(p[k], other);
        }
      }
    }
  }
}

template <int kVec>
__device__ __forceinline__ void store_word(uint16_t* out, Word<kVec> v) {
  *reinterpret_cast<Word<kVec>*>(out) = v;
}

// Short rows: a segment of kLanes lanes a row (32, or 16 at vec 8: two
// rows a warp), the row's n contributions at pos[0, n), n_max the most of
// the warp's rows (every loop that shuffles runs to it; loads and adds stop
// at the row's own n); `mine`: the segment writes its row.
template <int kVec, int K, int kLanes>
__device__ __forceinline__ void short_row(const uint16_t* __restrict__ g,
                                          int D,
                                          const int32_t* __restrict__ pos,
                                          int n, int n_max,
                                          uint16_t* __restrict__ out,
                                          int lane, bool mine) {
  using W = Word<kVec>;
  // loads before the adds: at most 32 registers of them
  constexpr int kB0 = kVec == 8 ? kBatch / 2 : kBatch;
  constexpr int kB = K == 8 ? kB0 / 2 : kB0;
  const int sl = lane % kLanes;
  int p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = k * kLanes + sl;
    p[k] = e < n ? __ldg(pos + e) : kNone;
  }
  warp_sort<K, kLanes>(p, lane, n_max);
  for (int c0 = 0; c0 < D; c0 += kLanes * kVec) {
    const int col = c0 + sl * kVec;
    const bool active = col < D;
    W acc = zero_word<W>();
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int b0 = 0; b0 < kLanes; b0 += kB) {
        const int e0 = k * kLanes + b0;
        if (e0 >= n_max) break;
        W v[kB];
#pragma unroll
        for (int t = 0; t < kB; ++t) {
          const int j = __shfl_sync(kFull, p[k], b0 + t, kLanes);
          v[t] = e0 + t < n && active
                     ? __ldg(reinterpret_cast<const W*>(
                           g + static_cast<int64_t>(j) * D + col))
                     : zero_word<W>();
        }
#pragma unroll
        for (int t = 0; t < kB; ++t)
          if (e0 + t < n) acc = add_bf16(acc, v[t]);
      }
    }
    if (active && mine) store_word<kVec>(out + col, acc);
  }
}

// ---- mbarriers (shared::cta), for the long rows' ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrives once every cp.async this thread issued so far has landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
          smem_addr(bar))
      : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = smem_addr(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// The segment's n positions (distinct, in [0, J)) in increasing order,
// to sorted[0, n).  At most kMaxLong of them: one warp's bitonic sort in
// registers.  Else: the place pass left them in runs, one a place block
// and each already in order, with run[] marking each run's first slot
// with its block and length; so ordering the runs by block orders the
// positions.  A window of `window` blocks at a time: each run of the
// window puts its start and length at its block's entry in shared memory
// (every window re-reads the run marks, so a row spread over more blocks
// than a window holds is still exact, in more passes); the entries' prefix
// in block order gives each run its offset, and each warp copies its
// runs' positions out 32 outputs at a time.
__device__ void sort_long(const int32_t* __restrict__ pos,
                          const uint32_t* __restrict__ run,
                          int32_t* __restrict__ sorted, int n, int blocks,
                          int* start_of, int* len_of, int window,
                          int* scratch) {
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  if (n <= kMaxLong) {  // a warp sorts it in registers, as a short row
    if (warp == 0) {
      int p[kMaxLong / kWarp];
#pragma unroll
      for (int k = 0; k < kMaxLong / kWarp; ++k) {
        const int e = k * kWarp + lane;
        p[k] = e < n ? __ldg(pos + e) : kNone;
      }
      warp_sort<kMaxLong / kWarp, kWarp>(p, lane, n);
#pragma unroll
      for (int k = 0; k < kMaxLong / kWarp; ++k)
        if (k * kWarp + lane < n) sorted[k * kWarp + lane] = p[k];
    }
    __syncthreads();
    return;
  }
  int done = 0;
  for (int b0 = 0; b0 < blocks && done < n; b0 += window) {
    const int used = min(window, blocks - b0);
    for (int i = tid; i < used; i += kBlock) len_of[i] = 0;
    __syncthreads();
    for (int i0 = tid; i0 < n; i0 += kSortLoads * kBlock) {
      uint32_t mark[kSortLoads];  // the loads all issue before their use
#pragma unroll
      for (int u = 0; u < kSortLoads; ++u)
        mark[u] = i0 + u * kBlock < n ? __ldg(run + i0 + u * kBlock) : 0u;
#pragma unroll
      for (int u = 0; u < kSortLoads; ++u) {
        const int b = static_cast<int>(mark[u] >> kRunBits) - 1 - b0;
        if (mark[u] != 0 && b >= 0 && b < used) {
          start_of[b] = i0 + u * kBlock;
          len_of[b] = static_cast<int>(mark[u] & ((1u << kRunBits) - 1));
        }
      }
    }
    __syncthreads();
    // warp w places the runs of its eighth of the blocks, 32 a step, lane l
    // taking entry 32 i + l (no bank conflicts): the warps' counts, their
    // prefix over the block, then each step's prefix over its lanes and
    // the step's copies
    const int per = (used + kWarps - 1) / kWarps;
    const int lo = min(warp * per, used), hi = min(lo + per, used);
    int mine = 0;
    for (int e = lo + lane; e < hi; e += kWarp) mine += len_of[e];
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2)
      mine += __shfl_xor_sync(kFull, mine, o);
    int total;
    const int before =
        block_scan<kWarps>(lane == 0 ? mine : 0, scratch, &total);
    int at = done + __shfl_sync(kFull, before, 0);
    for (int step = lo; step < hi; step += kWarp) {
      const int e = step + lane;
      const int len = e < hi ? len_of[e] : 0;
      int x = len;
#pragma unroll
      for (int o = 1; o < kWarp; o *= 2) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      // the step's runs fill outputs [at, at + x of lane 31) in order:
      // output at + q comes from the first lane whose prefix passes q (a
      // binary search over the lanes), the warp copying 32 outputs a time
      const int from = len > 0 ? start_of[e] : 0;
      const int before_run = x - len;
      const int step_total = __shfl_sync(kFull, x, kWarp - 1);
#pragma unroll 4
      for (int q0 = 0; q0 < step_total; q0 += kWarp) {
        const int q = q0 + lane;
        int l = 0;
#pragma unroll
        for (int b = kWarp / 2; b > 0; b /= 2)
          if (__shfl_sync(kFull, x, l + b - 1) <= q) l += b;
        const int rf = __shfl_sync(kFull, from, l);
        const int rb = __shfl_sync(kFull, before_run, l);
        if (q < step_total) sorted[at + q] = __ldg(pos + rf + q - rb);
      }
      at += step_total;
    }
    done += total;
    __syncthreads();  // the entries are cleared again, or become the ring
  }
}

// Warps 1-7: fill ring slots k0 + s with the contributions sorted[s * 64,
// ...) of columns [c0, c0 + cols), by cp.async: where a chunk's rows are
// whole 16-byte units at 16-byte addresses, 16 bytes a lane and several
// rows an instruction, unrolled (the issue rate of these copies, not their
// bytes, limited the ring: a bulk copy a row by the tensor memory
// accelerator issued at half the rate); else the widest unit a lane, or
// 16-bit copies through registers.  A warp reads the positions of its next
// fill right after its arrive (whose release semantics would otherwise
// wait for those loads) and before it waits for the next slot.
template <int kVec>
__device__ __forceinline__ void produce(
    const uint16_t* __restrict__ g, int D, int c0, int cols,
    const int32_t* sorted, int n, unsigned char* ring, uint64_t* full,
    uint64_t* empty, int slots, uint32_t k0, int lane) {
  constexpr int kRowBytes = kWarp * kVec * 2;
  const int bytes = cols * 2;
  // the widest copy that divides g's address, its row, the column offset
  // and the chunk
  const unsigned low = static_cast<unsigned>(reinterpret_cast<uintptr_t>(g)) |
                       (D * 2) | (c0 * 2) | bytes;
  const int unit = min(16, static_cast<int>(low & (0u - low)));
  const int pieces = bytes / unit;
  const int nslots = (n + kSlotRows - 1) / kSlotRows;
  // warp 1 + me fills slots me, me + 7, ... round by round, so a parity
  // wait on a slot's empty barrier never looks more than one phase ahead
  const int me = threadIdx.x / kWarp - 1;
  if (me >= slots) return;
  uint32_t round = k0 / slots;
  int slot = me;
  uint32_t k = round * slots + slot;
  auto advance = [&]() {
    slot += kWarps - 1;
    if (slot >= slots) {
      slot = me;
      ++round;
    }
    k = round * slots + slot;
  };
  while (k < k0) advance();
  // a plain load: this block wrote the sorted positions in this launch
  auto position = [&](uint32_t fill, int half) {
    const int t =
        static_cast<int>(fill - k0) * kSlotRows + half * kWarp + lane;
    return fill < k0 + nslots && t < n ? sorted[t] : -1;
  };
  int mine[kSlotRows / kWarp];  // lane l: rows l and 32 + l of its fill
#pragma unroll
  for (int h = 0; h < kSlotRows / kWarp; ++h) mine[h] = position(k, h);
  while (k < k0 + nslots) {
    const int s = static_cast<int>(k - k0);
    mbar_wait(empty + slot, (round & 1) ^ 1);
    const int rows = min(kSlotRows, n - s * kSlotRows);
    unsigned char* dst = ring + static_cast<size_t>(slot) * kSlotRows *
                                    kRowBytes;
    if (unit == 16 && bytes == kRowBytes) {  // kAtOnce rows an instruction
      constexpr int kPieces = kRowBytes / 16 > 0 ? kRowBytes / 16 : 1;
      constexpr int kAtOnce = kWarp / kPieces;
      const int q = lane % kPieces;
#pragma unroll
      for (int t0 = 0; t0 < kSlotRows; t0 += kAtOnce) {
        const int t = t0 + lane / kPieces;
        const int j = __shfl_sync(kFull, mine[t0 / kWarp], t % kWarp);
        if (t < rows)
          copy_async(dst + t * kRowBytes + q * 16,
                     reinterpret_cast<const unsigned char*>(
                         g + static_cast<int64_t>(j) * D + c0) +
                         q * 16,
                     16);
      }
    } else {
      for (int t = 0; t < rows; ++t) {
        const int j =
            __shfl_sync(kFull, t < kWarp ? mine[0] : mine[1], t % kWarp);
        const unsigned char* src = reinterpret_cast<const unsigned char*>(
            g + static_cast<int64_t>(j) * D + c0);
        for (int q = lane; q < pieces; q += kWarp) {
          if (unit >= 4)
            copy_async(dst + t * kRowBytes + q * unit, src + q * unit, unit);
          else
            *reinterpret_cast<uint16_t*>(dst + t * kRowBytes + q * 2) =
                __ldg(reinterpret_cast<const uint16_t*>(src) + q);
        }
      }
    }
    if (unit >= 4)
      mbar_arrive_copies(full + slot);
    else
      mbar_arrive(full + slot);
    // after the arrive, whose release would wait for these loads
    advance();
#pragma unroll
    for (int h = 0; h < kSlotRows / kWarp; ++h) mine[h] = position(k, h);
  }
}

// Warp 0: the chain of n adds over ring slots k0, k0 + 1, ...  The
// operands are read from shared memory kAhead contributions ahead of the
// add that takes them, across slot boundaries (the next slot's full wait
// comes kAhead adds before the slot ends), so an add waits on no load.
template <int kVec>
__device__ __forceinline__ Word<kVec> add_ring(const unsigned char* ring,
                                               uint64_t* full,
                                               uint64_t* empty, int slots,
                                               uint32_t k0, int n, int lane) {
  using W = Word<kVec>;
  W acc = zero_word<W>();
  const int nslots = (n + kSlotRows - 1) / kSlotRows;
  int slot = static_cast<int>(k0 % slots);
  uint32_t phase = (k0 / slots) & 1;
  auto operands = [&](int slot) {
    return reinterpret_cast<const W*>(ring) +
           static_cast<size_t>(slot) * kSlotRows * kWarp + lane;
  };
  mbar_wait(full + slot, phase);
  const W* cur = operands(slot);
  W v[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) v[u] = cur[u * kWarp];
  for (int s = 0; s < nslots; ++s) {
    const int rows = min(kSlotRows, n - s * kSlotRows);
    int next_slot = slot + 1;
    uint32_t next_phase = phase;
    if (next_slot == slots) {
      next_slot = 0;
      next_phase ^= 1;
    }
    const W* next = cur;
    // a whole slot's adds take no predicate
    auto add_slot = [&](auto whole) {
#pragma unroll
      for (int t = 0; t < kSlotRows; ++t) {
        if (t == kSlotRows - kAhead && s + 1 < nslots) {
          mbar_wait(full + next_slot, next_phase);
          next = operands(next_slot);
        }
        if (decltype(whole)::value || t < rows)
          acc = add_bf16(acc, v[t % kAhead]);
        const int at = t + kAhead;
        v[t % kAhead] = at < kSlotRows ? cur[at * kWarp]
                                       : next[(at - kSlotRows) * kWarp];
      }
    };
    if (rows == kSlotRows)
      add_slot(std::true_type{});
    else
      add_slot(std::false_type{});
    mbar_arrive(empty + slot);
    slot = next_slot;
    phase = next_phase;
    cur = next;
  }
  return acc;
}

// Blocks [0, long_blocks) take the long list; each later block's warps take
// one short row each.
template <int kVec>
__global__ void __launch_bounds__(kBlock, 4)
sum_kernel(const uint16_t* __restrict__ g, int D, int64_t J, int M,
           const int32_t* __restrict__ cnt, const int32_t* __restrict__ seg,
           int32_t* __restrict__ header,
           const int32_t* __restrict__ long_list,
           const int32_t* __restrict__ pos,
           const uint32_t* __restrict__ run, int32_t* __restrict__ sorted,
           int32_t* __restrict__ sorted2, int k_long, int long_blocks,
           int slots, uint16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxSlots], empty[kMaxSlots];
  __shared__ int scratch[kWarps];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (static_cast<int>(blockIdx.x) >= long_blocks) {
    constexpr int kLanes = kVec == 8 ? 16 : kWarp;  // a row's lanes
    const int64_t row =
        (static_cast<int64_t>(blockIdx.x - long_blocks) * kWarps + warp) *
            (kWarp / kLanes) +
        lane / kLanes;
    const int n_row = row < M ? cnt[row] : 0;
    const bool mine = row < M && n_row <= k_long;  // else a long block's
    const int n = mine ? n_row : 0;
    const int n_max =
        kLanes == kWarp ? n : max(n, __shfl_xor_sync(kFull, n, kLanes));
    uint16_t* dst = out + (row < M ? row : 0) * D;
    const int32_t* p = pos + (n > 0 ? seg[row] - 1 : 0);
    if (n_max == 0) {
      if (mine)
        for (int c = lane % kLanes * kVec; c < D; c += kLanes * kVec)
          store_word<kVec>(dst + c, zero_word<Word<kVec>>());
    } else if (n_max <= kLanes) {
      short_row<kVec, 1, kLanes>(g, D, p, n, n_max, dst, lane, mine);
    } else if (n_max <= 2 * kLanes) {
      short_row<kVec, 2, kLanes>(g, D, p, n, n_max, dst, lane, mine);
    } else if (n_max <= 4 * kLanes) {
      short_row<kVec, 4, kLanes>(g, D, p, n, n_max, dst, lane, mine);
    } else {
      short_row<kVec, 8, kLanes>(g, D, p, n, n_max, dst, lane, mine);
    }
    return;
  }
  // a long row's columns in chains of 32 lanes x kLongVec columns (two at
  // most: the bytes an SM can bring in for one add set the rate first),
  // the chunks split between two blocks where there are two or more, each
  // block sorting the row into its own copy of the order
  constexpr int kLongVec = kVec < 2 ? kVec : 2;
  constexpr int kChunk = kWarp * kLongVec;
  const int chunks = (D + kChunk - 1) / kChunk;
  const int groups = chunks < 2 ? chunks : 2;
  const int items = header[1] * groups;
  if (static_cast<int>(blockIdx.x) >= items) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full + s, kWarp);
      mbar_init(empty + s, kWarp);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the sort's window: a start and a length a place block, in the ring
  const int window = slots * kSlotRows * kChunk * 2 / 8;
  const int blocks = static_cast<int>((J + kPlace - 1) / kPlace);
  int* start_of = reinterpret_cast<int*>(smem);
  uint32_t k0 = 0;  // ring slots used so far, the same in every warp
  __shared__ int next_item;
  for (int item = blockIdx.x;;) {
    const int row = long_list[item / groups];
    const int group = item % groups;
    const int n = cnt[row];
    const int base = seg[row] - 1;
    int32_t* order = (group == 0 ? sorted : sorted2) + base;
    sort_long(pos + base, run + base, order, n, blocks, start_of,
              start_of + window, window, scratch);
    for (int c0 = group * kChunk; c0 < D; c0 += groups * kChunk) {
      const int cols = min(kChunk, D - c0);
      if (warp == 0) {
        const Word<kLongVec> acc =
            add_ring<kLongVec>(smem, full, empty, slots, k0, n, lane);
        if (lane * kLongVec < cols)
          store_word<kLongVec>(out + static_cast<int64_t>(row) * D + c0 +
                                   lane * kLongVec,
                               acc);
      } else {
        produce<kLongVec>(g, D, c0, cols, order, n, smem, full, empty, slots,
                          k0, lane);
      }
      k0 += (n + kSlotRows - 1) / kSlotRows;
    }
    if (threadIdx.x == 0) next_item = long_blocks + atomicAdd(header + 2, 1);
    __syncthreads();  // the ring is idle before the next sort
    item = next_item;
    if (item >= items) break;
  }
}

// ------------------------------------------------------------ latency

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One warp, one chain of n dependent add.rn.bf16x2: out = {clock cycles,
// ns, the sum's bits}.
__global__ void add_latency_kernel(const uint32_t* __restrict__ in,
                                   long long n, long long* __restrict__ out) {
  uint32_t a = in[0];
  const uint32_t b = in[1];
  const long long c0 = clock64();
  const uint64_t t0 = global_ns();
  for (long long i = 0; i < n; i += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u)
      asm volatile("add.rn.bf16x2 %0, %0, %1;" : "+r"(a) : "r"(b));
  }
  const long long c1 = clock64();
  const uint64_t t1 = global_ns();
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = static_cast<long long>(t1 - t0);
    out[2] = a;
  }
}

unsigned blocks_for(int64_t items, int64_t per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

bool is_unit(int u) { return u == 2 || u == 4 || u == 8 || u == 16; }

// a ring slot of the long rows: kSlotRows contributions of one chunk
// (32 lanes x min(vec, 2) columns)
int slot_bytes(int vec) {
  return kSlotRows * kWarp * (vec < 2 ? vec : 2) * 2;
}

template <typename Unit>
void launch_count(const void* g, int D, int group, const void* idx,
                  int64_t J, int M, int32_t* keys, int32_t* cnt,
                  cudaStream_t s) {
  const int units = static_cast<int>(D * 2 / sizeof(Unit));
  const int64_t rows = static_cast<int64_t>(kWarps) * (kWarp / group) *
                       kCountRows;
  count_kernel<Unit><<<blocks_for(J, rows), kBlock, 0, s>>>(
      static_cast<const Unit*>(g), units, group,
      static_cast<const int32_t*>(idx), J, M, keys, cnt);
}

template <int kVec>
cudaError_t launch_sum(const void* g, int D, int64_t J, int M,
                       const int32_t* cnt, const int32_t* seg,
                       int32_t* header, const int32_t* long_list,
                       const int32_t* pos, const uint32_t* run,
                       int32_t* sorted, int32_t* sorted2, int k_long,
                       int long_blocks, int long_smem, void* out,
                       cudaStream_t s) {
  static int configured[64] = {};  // the dynamic shared memory set, a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && configured[device] < long_smem) {
    err = cudaFuncSetAttribute(sum_kernel<kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               long_smem);
    if (err != cudaSuccess) return err;
    configured[device] = long_smem;
  }
  const int slots = long_smem / slot_bytes(kVec);
  const int rows_a_block = kVec == 8 ? 2 * kWarps : kWarps;
  sum_kernel<kVec><<<long_blocks + blocks_for(M, rows_a_block), kBlock,
                     long_smem, s>>>(
      static_cast<const uint16_t*>(g), D, J, M, cnt, seg, header, long_list,
      pos, run, sorted, sorted2, k_long, long_blocks, slots,
      static_cast<uint16_t*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The int32 scratch gs_scatter_rows needs: the header, counts, cursors and
// segments of the M rows, the long list (at most J / (k_long + 1) rows),
// the keys (the first order of the long rows, once dead), the positions,
// the run marks and the second order.
long long gs_scatter_scratch(long long J, int M, int k_long) {
  return kHeader + 3LL * M + J / (k_long + 1) + 4 * J;
}

// g: [J, D] bfloat16, contiguous; idx: [J] int32; out: [M, D] bfloat16
// contiguous, every element written; scratch: at least
// gs_scatter_scratch(J, M, k_long) int32.  The plan, chosen by
// ops/scatter.py::scatter_plan and refused here unless it fits:
//   unit         count pass load, bytes: 2, 4, 8 or 16, dividing 2 D and
//                g's address;
//   group        count pass lanes a row: the power of two >= 2 D / unit,
//                at most 32;
//   vec          sum pass columns a lane: 1, 2, 4 or 8, dividing D, with g
//                and out at 2 vec-byte addresses; 8 (16 lanes a row, two
//                rows a warp) only where D <= 128;
//   k_long       a row of more contributions is a long row: 1 to 256 (to
//                128 at vec 8);
//   long_blocks  blocks that take the long list: 1 to 65536;
//   long_smem    a long block's ring (and its sort's window), bytes: a
//                multiple of 16, at most 200 KB, 2 to 64 ring slots of
//                32 contributions x 32 min(vec, 2) columns.
// Launches on `stream` of `device`; returns cudaGetLastError() (0 on
// success) or cudaErrorInvalidValue.
int gs_scatter_rows(int device, const void* g, const void* idx,
                    void* scratch, long long scratch_ints, void* out,
                    long long J, int D, int M, int unit, int group, int vec,
                    int k_long, int long_blocks, int long_smem,
                    void* stream) {
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const long long units = is_unit(unit) ? 2LL * D / unit : 0;
  int want_group = 1;
  while (want_group < units && want_group < kWarp) want_group *= 2;
  const int slot = slot_bytes(vec);
  if (J < 0 || J >= kNone || D < 1 || M < 0 || !is_unit(unit) ||
      (2LL * D) % unit != 0 || ga % unit != 0 || group != want_group ||
      (vec != 1 && vec != 2 && vec != 4 && vec != 8) || D % vec != 0 ||
      (vec == 8 && D > 16 * vec) || ga % (2 * vec) != 0 ||
      oa % (2 * vec) != 0 || k_long < 1 ||
      k_long > (vec == 8 ? kMaxLong / 2 : kMaxLong) || long_blocks < 1 ||
      long_blocks > 65536 ||
      long_smem % 16 != 0 || long_smem > kMaxSmem ||
      long_smem < 2 * slot || long_smem / slot > kMaxSlots ||
      scratch_ints < gs_scatter_scratch(J, M, k_long))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* header = static_cast<int32_t*>(scratch);
  int32_t* cnt = header + kHeader;
  int32_t* cur = cnt + M;
  int32_t* seg = cur + M;
  int32_t* long_list = seg + M;
  int32_t* keys = long_list + J / (k_long + 1);
  int32_t* pos = keys + J;
  uint32_t* run = reinterpret_cast<uint32_t*>(pos + J);
  int32_t* sorted2 = pos + 2 * J;
  err = cudaMemsetAsync(scratch, 0, (kHeader + 3LL * M) * sizeof(int32_t),
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (J > 0) {
    if (unit == 16)
      launch_count<uint4>(g, D, group, idx, J, M, keys, cnt, s);
    else if (unit == 8)
      launch_count<uint2>(g, D, group, idx, J, M, keys, cnt, s);
    else if (unit == 4)
      launch_count<uint32_t>(g, D, group, idx, J, M, keys, cnt, s);
    else
      launch_count<uint16_t>(g, D, group, idx, J, M, keys, cnt, s);
    place_kernel<<<blocks_for(J, kPlace), kPlace, 0, s>>>(
        keys, J, cnt, cur, seg, header, long_list, k_long, pos, run);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the sum pass writes the sorted long rows over the keys, dead by then
  if (vec == 8)
    err = launch_sum<8>(g, D, J, M, cnt, seg, header, long_list, pos,
                        run, keys, sorted2, k_long, long_blocks, long_smem,
                        out, s);
  else if (vec == 4)
    err = launch_sum<4>(g, D, J, M, cnt, seg, header, long_list, pos,
                        run, keys, sorted2, k_long, long_blocks, long_smem,
                        out, s);
  else if (vec == 2)
    err = launch_sum<2>(g, D, J, M, cnt, seg, header, long_list, pos,
                        run, keys, sorted2, k_long, long_blocks, long_smem,
                        out, s);
  else
    err = launch_sum<1>(g, D, J, M, cnt, seg, header, long_list, pos,
                        run, keys, sorted2, k_long, long_blocks, long_smem,
                        out, s);
  return static_cast<int>(err);
}

// The latency of one dependent add.rn.bf16x2: one warp adds in[1] to in[0]
// n times (n a multiple of 16); out [3] int64: SM clock cycles, ns
// (%globaltimer), the sum's bits.  in: [2] uint32 on the card.
int gs_scatter_add_latency(int device, const void* in, void* out,
                           long long n, void* stream) {
  if (n < 16 || n % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  add_latency_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), n, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
