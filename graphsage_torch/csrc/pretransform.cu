// MEAN's pretransform z = h @ W_part^T on the tensor cores, for Hopper
// (sm_90a), and the pool transform of GraphSAGE-pool, z = relu(h @ W_pool^T
// + b), the same product with a bias-and-relu epilogue.  Built by
// graphsage_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes (plain C interface below); the Python wrapper is
// graphsage_torch/ops/pretransform.py::pretransform, which splits the weight
// and chooses the launch plan (pretransform.py::pretransform_plan).
// gs_pretransform launches pretransform_kernel (no epilogue: MEAN);
// gs_pretransform_bias_relu launches pretransform_bias_relu_kernel, the same
// body whose epilogue adds a float32 bias to each column's float32 sum and
// takes the relu before the one rounding to bfloat16.
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA
// (jnp.dot of the bfloat16 table and the float32 weight with float32
// results, graphsage_tpu/models/layers.py:40-59).  It replaces the port's
// cuBLAS path for a bfloat16 table: the upcast of the table to float32, a
// float32 SGEMM at the CUDA-core rate and the cast of z back to bfloat16.
//
// Exactness.  Every element of the table h [N, K] is bfloat16.  The float32
// weight w [P, K] is the exact sum of three bfloat16 pieces
//   hi = bf16(w),  mid = bf16(w - hi),  lo = bf16(w - hi - mid)
// (each rounding to nearest; each piece holds 8 of the 24 significant
// bits, and bfloat16 has float32's exponent range; exact for |w| between
// 2^-110 and bfloat16's largest finite value, 3.39e38, and for 0).  A
// product of two bfloat16 numbers is exact in float32.  So
//   z[n, p] = sum over k and the three pieces of h[n, k] * piece[p, k],
// summed in one float32 accumulator and rounded once to bfloat16, is the
// float32 product h @ w^T with the sums in another order, as the float32
// SGEMM and the JAX reference compute it.
//
// Bound: operations.  The kernel does 3 x 2 N K P operations on the
// bfloat16 tensor cores (989 TFLOP/s): at serving's layer 1 (N = 1e6,
// K = 602, P = 256) 0.92 TFLOP, 0.94 ms; at layer 2 (K = 128) 0.20 TFLOP,
// 0.20 ms.  Its bytes (h read once, z written once, the pieces from L2)
// take 0.51 ms and 0.23 ms at 3.35 TB/s.
//
// Design.
// - One persistent block on each SM (a block walks over tiles blockIdx.x,
//   + gridDim.x, ...), three warpgroups: a producer and two consumers.  A
//   tile is BM = 128 rows by BN columns of z (BN = 256 for P = 256: one
//   tile wide; 64 or 128 for narrower z); consumer g owns rows 64g..64g+63
//   and keeps its 64 x BN float32 sums in registers (BN / 2 a thread).
// - K in slices of BK = 64 (128 bytes of bfloat16: one row of the 128-byte
//   swizzle).  A stage of shared memory holds the slice of h [128, 64] and
//   the slice of all three pieces [3, BN, 64]; each slice of h is loaded
//   once and multiplied against the three pieces by wgmma m64nBNk16 (4 k
//   steps x 3 pieces a warpgroup), all into the same accumulators.  Two
//   stages (2 x 112 KB at BN = 256), each with a full and an empty
//   mbarrier: the producer fills slice i + 1 while the consumers multiply
//   slice i; a consumer releases a slice's stage once its wgmma are done.
//   The slices of a block's tiles are one sequence, so the next tile's
//   first slice loads during this tile's last slice and epilogue.
// - The pieces: one bulk copy (cp.async.bulk, completing on the full
//   barrier's transaction count) of a slice's [3, BN, 64] run, which the
//   host lays out in the swizzled order (pack_kernel).
// - h: h's rows need not be 16-byte aligned: layer 1's rows are 1,204
//   bytes, 4 mod 16, so TMA cannot describe the table and 16-byte loads do
//   not align.  The producer copies it with cp.async in the widest unit of
//   16, 8, 4 or 2 bytes that divides h's address, its row stride and its
//   row width (the host's plan): 1,204-byte rows take 4-byte units (a
//   warp reads 128 contiguous bytes of one row), 256-byte rows 16-byte
//   units; 2-byte units (an odd K or stride) go through registers.  It
//   writes the 128-byte-swizzled layout the wgmma descriptors name (16-byte
//   chunk c of row r at chunk c ^ (r % 8)), waits for its copies, fences
//   them to the async proxy (fence.proxy.async) and arrives on the full
//   barrier.  It also prefetches into L2 the lines of h that the slice
//   AHEAD = 3 slices on reads.
// - K tail: K = 602 is 9 slices of 64 and 26.  A unit never straddles K
//   (it divides the row width), so a unit past K, or of a row past N, is
//   zero-filled (cp.async with source size 0); the pieces are zero past K
//   and past P.  Steps of 16 wholly past K are not issued.
// - Epilogue: the consumers round their sums to bfloat16 into the stage
//   the tile's last slice has just left (a [128, BN] tile, 16-byte chunks
//   swizzled by the row), then write whole rows of z with 16-byte stores
//   (rows past N and columns past P skipped) and release the stage.  z is
//   [N, P] contiguous, the SELF columns first.  A z whose rows are not
//   16-byte multiples takes each thread's pairs of columns straight from
//   its registers.  With the bias-and-relu epilogue each sum first becomes
//   relu(sum + bias[column]) in float32 (the bias read through the
//   read-only cache, a value a column), so z is rounded once, as the plain
//   version rounds relu(h @ w^T + b).
// Why a producer warpgroup: at [1M, 602] on the H100 the loads alone take
// 1.41 ms and the multiplications alone 1.27 ms; two warpgroups that both
// loaded and multiplied took 2.39 ms, this kernel 2.24-2.29 ms (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128;          // rows of z a tile
constexpr int BK = 64;           // K a slice (128 bytes of bfloat16)
constexpr int PIECES = 3;
constexpr int THREADS = 384;     // a producer and two consumer warpgroups
constexpr int ROW_BYTES = BK * 2;
constexpr int A_BYTES = BM * ROW_BYTES;

template <int BN>
struct Plan {
  static constexpr int B_BYTES = PIECES * BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // two stages, their four mbarriers, and room to align the first stage to
  // 1024 bytes (the swizzle's repeat, which the descriptors assume)
  static constexpr int SMEM_BYTES = 2 * STAGE_BYTES + 1024 + 32;
};

// A wgmma descriptor of a K-major operand in the 128-byte swizzle: rows
// 128 bytes apart, groups of 8 rows 1024 bytes apart (stride offset), the
// leading offset unused (1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// where byte `byte` of row `row` of a 128-byte-swizzled tile lies
__device__ __forceinline__ uint32_t swizzled(int row, int byte) {
  return static_cast<uint32_t>(row * ROW_BYTES +
                               ((((byte >> 4) ^ (row & 7))) << 4) +
                               (byte & 15));
}

template <int UNIT>
__device__ __forceinline__ void copy_unit(uint32_t dst, const char* src,
                                          bool valid) {
  const int bytes = valid ? UNIT : 0;
  if constexpr (UNIT == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes));
  } else if constexpr (UNIT == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes));
  } else if constexpr (UNIT == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes));
  } else {
    // cp.async has no 2-byte form: through a register
    const unsigned short v =
        valid ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v)
                 : "memory");
  }
}

// keeps the compiler from moving the sums while a wgmma owns them
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


// d[0 .. BN/2) += A (64 x 16, rows of the warpgroup) x B^T (BN x 16), or
// d = A x B^T where scale_d is 0.  A thread holds rows warp * 16 + lane / 4
// (+ 8) and columns 8 j + 2 (lane % 4) (+ 1): d[4 j .. 4 j + 3].
template <int BN>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db,
                                      int scale_d) {
  if constexpr (BN == 256) {
    wgmma_n256(d, da, db, scale_d);
  } else if constexpr (BN == 128) {
    wgmma_n128(d, da, db, scale_d);
  } else {
    wgmma_n64(d, da, db, scale_d);
  }
}

struct Args {
  const char* h;          // the table, bfloat16 [n, k]
  int64_t h_stride;       // its row stride in bytes
  const char* pieces;     // pack_kernel's [kt, ct, 3, BN, 64]
  __nv_bfloat16* z;       // bfloat16 [n, p], contiguous
  int n, k, p;
  int kt, ct;             // slices of K, tiles of z's columns
  int staged;             // z's rows take 16-byte stores (p % 8 == 0)
  const float* bias;      // float32 [p]: the epilogue's, or null
};

// the epilogue of a pair of columns (col, col + 1) of one row: nothing, or
// relu(sum + bias) with NaN kept, as torch.relu keeps it
template <bool BIAS_RELU>
__device__ __forceinline__ void epilogue(float& v0, float& v1, int col,
                                         const Args& a) {
  if constexpr (BIAS_RELU) {
    const float b0 = col < a.p ? __ldg(a.bias + col) : 0.0f;
    const float b1 = col + 1 < a.p ? __ldg(a.bias + col + 1) : 0.0f;
    v0 += b0;
    v1 += b1;
    v0 = v0 < 0.0f ? 0.0f : v0;
    v1 = v1 < 0.0f ? 0.0f : v1;
  }
}

// where byte `byte` of row `row` of a BN-wide bfloat16 tile of z lies in
// the staging buffer: 16-byte chunks swizzled by the row, so that the
// epilogue's writes (8 rows, one chunk each) and reads (a row's chunks)
// meet no bank conflict
template <int BN>
__device__ __forceinline__ uint32_t staged(int row, int byte) {
  return static_cast<uint32_t>(row * BN * 2 +
                               (((byte >> 4) ^ (row & 7)) << 4) +
                               (byte & 15));
}

__device__ __forceinline__ void st_shared_pair(uint32_t addr, float v0,
                                               float v1) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&pair))
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_chunk(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void store(__nv_bfloat16* z, int64_t row,
                                      int col, float v0, float v1,
                                      const Args& a) {
  __nv_bfloat16* dst = z + row * a.p + col;
  if ((a.p & 1) == 0) {
    if (col < a.p)
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < a.p) dst[0] = __float2bfloat16_rn(v0);
    if (col + 1 < a.p) dst[1] = __float2bfloat16_rn(v1);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// waits for the phase of parity `parity` to complete; a wait that never
// ends traps (an error at the next synchronisation) instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins == (1u << 24)) __trap();
  }
}

// one bulk copy of `bytes` contiguous bytes into shared memory, completing
// on `bar`'s transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const char* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

constexpr int AHEAD = 3;   // slices ahead whose rows of h go into L2

template <int BN, int UNIT, bool BIAS_RELU>
__device__ __forceinline__ void pretransform_body(const Args& a) {
  constexpr int NREG = BN / 2;
  constexpr int STAGE = Plan<BN>::STAGE_BYTES;
  constexpr int B_BYTES = Plan<BN>::B_BYTES;
  constexpr int PER_ROW = ROW_BYTES / UNIT;
  constexpr int A_COPIES = BM * PER_ROW / 128;

  extern __shared__ unsigned char smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t base = (raw + 1023) & ~1023u;
  // full[2] (thread 0's arrival with the pieces' bytes, then the
  // producer's 128 arrivals after its copies of h), then empty[2] (the
  // consumers' 256 arrivals)
  const uint32_t bars = base + 2 * STAGE;

  const int tid = threadIdx.x;
  const int tiles = (a.n + BM - 1) / BM * a.ct;
  if (static_cast<int>(blockIdx.x) >= tiles) return;
  const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int total = mine * a.kt;
  if (tid == 0) {
    mbar_init(bars, 129);
    mbar_init(bars + 8, 129);
    mbar_init(bars + 16, 256);
    mbar_init(bars + 24, 256);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer warpgroup: slice `it` into stage it % 2 once the
    // consumers have released slice it - 2
    const int64_t k_bytes = static_cast<int64_t>(a.k) * 2;
    for (int it = 0; it < total; ++it) {
      const int s = it & 1;
      const uint32_t full = bars + 8 * s;
      if (it >= 2) mbar_wait(bars + 16 + 8 * s, ((it >> 1) & 1) ^ 1);
      const int t = blockIdx.x + it / a.kt * gridDim.x;
      const int ks = it % a.kt;
      const uint32_t sa = base + s * STAGE;
      if (tid == 0) {
        mbar_arrive_expect_tx(full, B_BYTES);
        bulk_load(sa + A_BYTES,
                  a.pieces + (static_cast<int64_t>(ks) * a.ct + t % a.ct) *
                                 B_BYTES,
                  B_BYTES, full);
      }
      const int64_t row0 = static_cast<int64_t>(t / a.ct) * BM;
      const int64_t byte0 = static_cast<int64_t>(ks) * ROW_BYTES;
      if (it + AHEAD < total) {
        // the lines of h that slice it + AHEAD reads, into L2
        const int ahead = it + AHEAD;
        const int64_t prow = static_cast<int64_t>(
            (blockIdx.x + ahead / a.kt * gridDim.x) / a.ct) * BM + tid;
        const int64_t pbyte = static_cast<int64_t>(ahead % a.kt) * ROW_BYTES;
        if (prow < a.n && pbyte < k_bytes) {
          const char* p = a.h + prow * a.h_stride + pbyte;
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
          if (pbyte + ROW_BYTES < k_bytes)
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + ROW_BYTES -
                                                            1));
        }
      }
#pragma unroll 8
      for (int i = 0; i < A_COPIES; ++i) {
        const int c = tid + i * 128;
        const int row = c / PER_ROW;
        const int byte = c % PER_ROW * UNIT;
        const bool valid = row0 + row < a.n && byte0 + byte < k_bytes;
        const char* src =
            valid ? a.h + (row0 + row) * a.h_stride + byte0 + byte : a.h;
        copy_unit<UNIT>(sa + swizzled(row, byte), src, valid);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full);
    }
    return;
  }

  // the two consumer warpgroups
  const int ctid = tid - 128;
  const int wg = ctid >> 7;
  float acc[NREG];
#pragma unroll
  for (int i = 0; i < NREG; ++i) acc[i] = 0.0f;
  int held = -1;   // the stage whose wgmma may still run, not yet released
  for (int it = 0; it < total; ++it) {
    const int s = it & 1;
    const int ks = it % a.kt;
    mbar_wait(bars + 8 * s, (it >> 1) & 1);
    const int steps = min(4, (a.k - ks * BK + 15) / 16);
    const uint32_t sa = base + s * STAGE + wg * 64 * ROW_BYTES;
    const uint32_t sb = base + s * STAGE + A_BYTES;
    fence_operands<NREG>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < steps) {
#pragma unroll
        for (int q = 0; q < PIECES; ++q)
          wgmma<BN>(acc, sw128_desc(sa + j * 32),
                    sw128_desc(sb + q * BN * ROW_BYTES + j * 32),
                    (ks | j | q) != 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_operands<NREG>(acc);
    if (held >= 0) {
      // the previous slice's wgmma are done: release its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_operands<NREG>(acc);
      mbar_arrive(bars + 16 + 8 * held);
    }
    held = s;

    if (ks == a.kt - 1) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands<NREG>(acc);
      const int t = blockIdx.x + it / a.kt * gridDim.x;
      const int warp = (ctid & 127) >> 5;
      const int lane = ctid & 31;
      const int r = wg * 64 + warp * 16 + (lane >> 2);   // and r + 8
      const int64_t row0 = static_cast<int64_t>(t / a.ct) * BM;
      const int col0 = t % a.ct * BN;
      if (a.staged) {
        // the tile through this stage's buffer (both warpgroups' wgmma
        // on it are done), then 16-byte stores of whole rows
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        const uint32_t out = base + s * STAGE;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int byte = j * 16 + (lane & 3) * 4;
          float v0 = acc[4 * j], v1 = acc[4 * j + 1];
          float v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
          epilogue<BIAS_RELU>(v0, v1, col0 + byte / 2, a);
          epilogue<BIAS_RELU>(v2, v3, col0 + byte / 2, a);
          st_shared_pair(out + staged<BN>(r, byte), v0, v1);
          st_shared_pair(out + staged<BN>(r + 8, byte), v2, v3);
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        constexpr int ROW_CHUNKS = BN / 8;
#pragma unroll 4
        for (int i = 0; i < BM * ROW_CHUNKS / 256; ++i) {
          const int q = ctid + i * 256;
          const int row = q / ROW_CHUNKS;
          const int col = col0 + q % ROW_CHUNKS * 8;
          if (row0 + row < a.n && col < a.p)
            *reinterpret_cast<uint4*>(a.z + (row0 + row) * a.p + col) =
                ld_shared_chunk(out + staged<BN>(row, q % ROW_CHUNKS * 16));
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = col0 + j * 8 + (lane & 3) * 2;
          float v0 = acc[4 * j], v1 = acc[4 * j + 1];
          float v2 = acc[4 * j + 2], v3 = acc[4 * j + 3];
          epilogue<BIAS_RELU>(v0, v1, col, a);
          epilogue<BIAS_RELU>(v2, v3, col, a);
          if (row0 + r < a.n) store(a.z, row0 + r, col, v0, v1, a);
          if (row0 + r + 8 < a.n) store(a.z, row0 + r + 8, col, v2, v3, a);
        }
      }
      mbar_arrive(bars + 16 + 8 * s);
      held = -1;
    }
  }
}

// MEAN's pretransform: the body with no epilogue
template <int BN, int UNIT>
__global__ void __launch_bounds__(THREADS, 1)
    pretransform_kernel(const Args a) {
  pretransform_body<BN, UNIT, false>(a);
}

// the pool transform: the body with the bias-and-relu epilogue
template <int BN, int UNIT>
__global__ void __launch_bounds__(THREADS, 1)
    pretransform_bias_relu_kernel(const Args a) {
  pretransform_body<BN, UNIT, true>(a);
}

template <int BN, int UNIT>
int launch(const Args& a, int device, cudaStream_t stream) {
  constexpr int smem = Plan<BN>::SMEM_BYTES;
  const auto kernel = a.bias != nullptr
                          ? pretransform_bias_relu_kernel<BN, UNIT>
                          : pretransform_kernel<BN, UNIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.n + BM - 1) / BM * a.ct;
  const int grid = tiles < sms ? tiles : sms;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_unit(const Args& a, int unit, int device, cudaStream_t stream) {
  switch (unit) {
    case 16:
      return launch<BN, 16>(a, device, stream);
    case 8:
      return launch<BN, 8>(a, device, stream);
    case 4:
      return launch<BN, 4>(a, device, stream);
    default:
      return launch<BN, 2>(a, device, stream);
  }
}

// piece q (0 hi, 1 mid, 2 lo) of w: each the remainder rounded to
// bfloat16, a zero remainder taking w's sign (ops/pretransform.py::
// split_weight, operation for operation)
__device__ __forceinline__ __nv_bfloat16 piece_of(float w, int q) {
  const float signed_zero = w * 0.0f;
  float rest = w;
  __nv_bfloat16 piece = __float2bfloat16_rn(rest);
  for (int i = 0; i < q; ++i) {
    const float next = rest - __bfloat162float(piece);
    rest = next == 0.0f ? signed_zero : next;
    piece = __float2bfloat16_rn(rest);
  }
  return piece;
}

// The pieces of w [p, k] (float32, rows w_stride apart) in the main
// kernel's layout: [ceil(k / 64), ceil(p / bn), 3, bn, 64] bfloat16, zero
// past k and p, each 128-byte row's 16-byte chunk c at chunk c ^ (row % 8)
// (the wgmma descriptors' swizzle), so that one bulk copy places a
// slice's pieces in shared memory as they are read.
// ops/pretransform.py::pack_pieces(split_weight(w), bn) bit for bit.
__global__ void pack_kernel(const float* __restrict__ w, int64_t w_stride,
                            __nv_bfloat16* __restrict__ out, int p, int k,
                            int bn, int ct, int64_t count) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < count; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(i % BK);
    const int row = static_cast<int>(i / BK % bn);
    const int q = static_cast<int>(i / (BK * bn) % PIECES);
    const int64_t tile = i / (BK * bn * PIECES);    // ks * ct + column tile
    const int wr = static_cast<int>(tile % ct) * bn + row;
    const int wk = static_cast<int>(tile / ct) * BK +
                   (((col >> 3) ^ (row & 7)) << 3) + (col & 7);
    out[i] = wr < p && wk < k ? piece_of(w[wr * w_stride + wk], q)
                              : __float2bfloat16_rn(0.0f);
  }
}

// the checks and the launch of gs_pretransform and gs_pretransform_bias_relu
int pretransform_launch(int device, const void* h, long long h_stride,
                        const void* pieces, void* z, int n, int k, int p,
                        int bn, int unit, const float* bias, void* stream) {
  const int64_t stride_bytes = static_cast<int64_t>(h_stride) * 2;
  if (!(bn == 64 || bn == 128 || bn == 256) ||
      !(unit == 16 || unit == 8 || unit == 4 || unit == 2) || n < 1 ||
      k < 1 || p < 1 || reinterpret_cast<uintptr_t>(h) % unit != 0 ||
      stride_bytes % unit != 0 || (2 * static_cast<int64_t>(k)) % unit != 0 ||
      reinterpret_cast<uintptr_t>(pieces) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(z) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const char*>(h),
               stride_bytes,
               static_cast<const char*>(pieces),
               static_cast<__nv_bfloat16*>(z),
               n,
               k,
               p,
               (k + BK - 1) / BK,
               (p + bn - 1) / bn,
               p % 8 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0,
               bias};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 256:
      return launch_unit<256>(a, unit, device, s);
    case 128:
      return launch_unit<128>(a, unit, device, s);
    default:
      return launch_unit<64>(a, unit, device, s);
  }
}

}  // namespace

extern "C" {

// w: float32 [p, k], rows w_stride elements apart, unit column stride.
// out: bfloat16, ceil(k / 64) * ceil(p / bn) * 3 * bn * 64 elements,
// contiguous.  Launches pack_kernel on `stream` of `device` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a bn it
// does not take.
int gs_pretransform_pack(int device, const void* w, long long w_stride,
                         void* out, int p, int k, int bn, void* stream) {
  if (!(bn == 64 || bn == 128 || bn == 256) || p < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ct = (p + bn - 1) / bn;
  const int64_t count =
      static_cast<int64_t>((k + BK - 1) / BK) * ct * PIECES * bn * BK;
  const int64_t blocks = (count + 255) / 256;
  pack_kernel<<<static_cast<int>(blocks < 1024 ? blocks : 1024), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), w_stride,
      static_cast<__nv_bfloat16*>(out), p, k, bn, ct, count);
  return static_cast<int>(cudaGetLastError());
}

// h: bfloat16 [n, k], rows h_stride elements apart, unit column stride.
// pieces: gs_pretransform_pack's layout for this bn, 16-byte aligned.  z:
// bfloat16 [n, p], contiguous, 4-byte aligned.  bn (64, 128 or 256) and unit
// (16, 8, 4 or 2 bytes, dividing h's address, its row stride in bytes and its
// row width in bytes) are the launch plan.  Launches on `stream` of `device`
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a plan or layout it does not take.
int gs_pretransform(int device, const void* h, long long h_stride,
                    const void* pieces, void* z, int n, int k, int p, int bn,
                    int unit, void* stream) {
  return pretransform_launch(device, h, h_stride, pieces, z, n, k, p, bn,
                             unit, nullptr, stream);
}

// gs_pretransform with the epilogue: z = relu(h @ w^T + bias), bias float32
// [p], contiguous and not null.
int gs_pretransform_bias_relu(int device, const void* h, long long h_stride,
                              const void* pieces, void* z, int n, int k,
                              int p, int bn, int unit, const void* bias,
                              void* stream) {
  if (bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return pretransform_launch(device, h, h_stride, pieces, z, n, k, p, bn,
                             unit, static_cast<const float*>(bias), stream);
}

const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
