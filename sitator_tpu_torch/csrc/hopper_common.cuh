// Hopper building blocks shared by the tensor-core kernels (sims_wgmma.cu,
// assign_skew_wgmma.cu) and the FMA K1s (assign_skew.cu): mbarriers (CTA
// and cluster scope), cp.async, TMA tile loads and bulk copies between the
// CTAs of a cluster, the shared-memory matrix descriptor of a K-major tile
// in the 128-byte swizzle, wgmma.m64n256k16 on bf16 operands with its
// epilogue arg-max, and the host-side tensor-map encoder.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

constexpr int TBK = 64;  // sites per k-stage: 128 bytes of bf16, one
                         // swizzle row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The same wait with acquire semantics at cluster scope: the writes that
// other CTAs of the cluster released with their arrivals are visible after
// it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The shared::cluster address of the variable at local address ``local`` in
// the shared memory of CTA ``rank`` of this cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(local), "r"(rank));
  return out;
}

// Arrive on an mbarrier of any CTA of the cluster, releasing this thread's
// earlier writes at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t remote_bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote_bar)
      : "memory");
}

__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster_s32(uint32_t addr, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

// Make this thread's generic-proxy writes to its CTA's shared memory
// visible to the async proxy (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The bulk-copy engine copies ``bytes`` (a multiple of 16) of this CTA's
// shared memory at ``src`` to ``dst`` in the shared memory of a CTA of the
// cluster and signals the bytes to the mbarrier ``bar`` there (both
// shared::cluster addresses).
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, const void* src,
                                                  uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A 4-byte asynchronous copy from global to this CTA's shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// A 16-byte asynchronous copy from global to this CTA's shared memory,
// bypassing L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Every thread of every CTA of the cluster arrives, then waits.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of element (row, k) of a K-major bf16 tile of 64-element
// (128-byte) rows in the 128-byte swizzle, the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and smem_desc describes (tile 1024-aligned):
// the 16-byte chunk index k / 8 is XORed with row % 8.
__device__ __forceinline__ uint32_t swizzle128_offset(int row, int k) {
  return (uint32_t)(row * 128 + ((((k >> 3) ^ (row & 7)) << 4) | ((k & 7)
                                                                  << 1)));
}

// d (64 x 256, f32) += A (64 x 16, bf16, K-major) * B (16 x 256, bf16,
// K-major); the accumulator layout: d[4j + 2h + e] is row 8h + lane / 4 of
// the warp's 16 rows, column 8j + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// The per-row max of sims * inv over one 64 x 256 accumulator and its first
// arg-max (columns col0 .. col0 + 255, those >= n_valid masked), for the two
// rows (h = 0, 1) this thread holds: each thread scans its 64 columns in
// ascending order with a strict >, then the four threads that share a row
// reduce with the lowest index winning a tie.  Every thread returns its
// rows' results; lane % 4 == 0 holds them for writing.
__device__ __forceinline__ void tile_argmax(const float (&d)[128], int h,
                                            float inv, int col0, int n_valid,
                                            float& best, int& bi) {
  const int lane = threadIdx.x % 32;
  const int cl = col0 + 2 * (lane % 4);
  best = -INFINITY;
  bi = cl;
#pragma unroll
  for (int j = 0; j < 32; ++j) {   // columns ascend with (j, e): strict
#pragma unroll                     // > keeps the first of equal values
    for (int e = 0; e < 2; ++e) {
      const int col = cl + 8 * j + e;
      const float v = d[4 * j + 2 * h + e] * inv;
      if (col < n_valid && v > best) {
        best = v;
        bi = col;
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the 4 threads of a row
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ob > best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime (the
// library is not linked against libcuda).
static inline int encode_fn(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return 0;
}

// A 2-D bf16 tensor map over a row-major (rows x cols) matrix, boxes of
// box_rows x 64 in the 128-byte swizzle; reads past the last row give 0.
static inline int make_map(CUtensorMap* map, const void* ptr, int rows,
                           int cols, int box_rows) {
  EncodeTiled encode;
  const int err = encode_fn(&encode);
  if (err) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)TBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
