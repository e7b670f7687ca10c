// The similarity product and per-block arg-max of the cosine-assignment
// tail on the tensor cores, for bf16 similarity operands.
//
// Replaces the similarity half of sitator_tpu/ops/landmark_mxu.py::_kernel
// (K1, its tail after the lv tiles) and of
// sitator_tpu/ops/landmark_pallas.py::_kernel (K3): sims = bf16(lv) @
// bf16(C) with f32 accumulation (mxu_bf16=True), sims * inv_norm, then each
// row's max and its first arg-max over one block of centre columns.
// argmax_merge_kernel (assign_tail.cu) merges the blocks in column order.
//
// What bounds it on an H100: the product, 2 * rows * SP * KP flop (470
// GFLOP per 32-frame bench block: 24576 x 9344 x 1024), 0.48 ms at the
// 989 TFLOP/s bf16 tensor-core peak; reading the bf16 lv once (0.46 GB) takes
// 0.14 ms.  The previous kernel ran the product on the f32 FMA pipes (about
// 25 TFLOP/s achieved).
//
// Design: one block of 384 threads computes a 128-row x 256-centre tile.
//   - Operands: row_prep_kernel writes a bf16 copy of the clipped lv (rows x
//     SP, K-major); the wrapper rounds the centres once to a bf16 (KP x SP)
//     K-major copy.  TMA loads 128 x 64 and 256 x 64 boxes of the two into a
//     4-stage shared-memory ring (48 KB a stage) in the 128-byte swizzle that
//     wgmma reads; full/empty mbarriers hand the stages over.
//   - Warpgroup 2 is the producer (one thread issues the TMA loads, its
//     registers given back with setmaxnreg); warpgroups 0 and 1 each run
//     wgmma.m64n256k16 on 64 of the rows, four k-steps of 16 per stage, with
//     the 64 x 256 f32 accumulator in registers (128 a thread).
//   - Epilogue: each thread scales its two rows' 64 columns by inv_norm,
//     keeps the max and the first arg-max scanning its columns in ascending
//     order, and the four threads that share a row reduce with the lowest
//     index winning a tie; one writes part_val / part_idx.
//   - blockIdx.x runs over the column blocks of one row block, so the blocks
//     that read the same lv rows run together and share them through L2.
//   - KP is a multiple of 128, not always of 256: the last column block then
//     reads past KP, TMA fills those centre rows with zeros, and the
//     epilogue masks their columns; nothing is padded past KP in memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TBM = 128;     // rows per block
constexpr int TBN = 256;     // centres per block
constexpr int TBK = 64;      // sites per stage (128 bytes of bf16)
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int A_ELEMS = TBM * TBK;
constexpr int B_ELEMS = TBN * TBK;
constexpr uint32_t STAGE_BYTES = (A_ELEMS + B_ELEMS) * 2;
constexpr size_t SMEM_BYTES =
    1024 + STAGES * (size_t)STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);

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

__global__ void __launch_bounds__(THREADS, 1) sims_wgmma_kernel(
    const __grid_constant__ CUtensorMap lv_map,   // bf16 (rows, SP)
    const __grid_constant__ CUtensorMap ctr_map,  // bf16 (KP, SP)
    const float* __restrict__ inv_norm,           // (rows)
    float* __restrict__ part_val,                 // (rows, n_kb)
    int* __restrict__ part_idx, int KP, int n_kt) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* sB = sA + STAGES * A_ELEMS;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + STAGES * B_ELEMS);
  uint64_t* empty = full + STAGES;

  const int kb = blockIdx.x;
  const int n_kb = gridDim.x;
  const int row0 = blockIdx.y * TBM;
  const int col0 = kb * TBN;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (t == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(sA + s * A_ELEMS, &lv_map, kt * TBK, row0, &full[s]);
        tma_load_2d(sB + s * B_ELEMS, &ctr_map, kt * TBK, col0, &full[s]);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows row0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const __nv_bfloat16* a = sA + s * A_ELEMS + wg * 64 * TBK;
      const __nv_bfloat16* b = sB + s * B_ELEMS;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk)
        wgmma_m64n256k16(d, smem_desc(a + kk * 16), smem_desc(b + kk * 16));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (t == 0) mbar_arrive(&empty[s]);
    }

    const int lane = t % 32;
    const int rbase = row0 + wg * 64 + (t / 32) * 16 + lane / 4;
    const int cl = col0 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rbase + 8 * h;
      const float inv = inv_norm[row];
      float best = -INFINITY;
      int bi = cl;
#pragma unroll
      for (int j = 0; j < 32; ++j) {   // columns ascend with (j, e): strict
#pragma unroll                          // > keeps the first of equal values
        for (int e = 0; e < 2; ++e) {
          const int col = cl + 8 * j + e;
          const float v = d[4 * j + 2 * h + e] * inv;
          if (col < KP && v > best) {
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
      if (lane % 4 == 0) {
        part_val[(size_t)row * n_kb + kb] = best;
        part_idx[(size_t)row * n_kb + kb] = bi;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A 2-D bf16 tensor map over a row-major (rows x cols) matrix, boxes of
// box_rows x 64 in the 128-byte swizzle; reads past the last row give 0.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
             int rows, int cols, int box_rows) {
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

}  // namespace

// lvb (rows, SP) and ctr (KP, SP) bf16; rows % 128 == 0, SP % 64 == 0,
// KP % 128 == 0 (the wrapper checks).  part_val / part_idx are (rows,
// ceil(KP / 256)).
extern "C" int sit_sims_wgmma(const void* lvb, const void* ctr,
                              const float* inv_norm, float* part_val,
                              int* part_idx, int rows, int SP, int KP,
                              void* stream) {
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
  CUtensorMap lv_map, ctr_map;
  int err = make_map(encode, &lv_map, lvb, rows, SP, TBM);
  if (err) return err;
  err = make_map(encode, &ctr_map, ctr, KP, SP, TBN);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      sims_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((KP + TBN - 1) / TBN, rows / TBM);
  sims_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      lv_map, ctr_map, inv_norm, part_val, part_idx, KP, SP / TBK);
  return (int)cudaGetLastError();
}
