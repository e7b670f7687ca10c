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
//   - Operands: the landmark stage writes a bf16 copy of the lv (rows x SP,
//     K-major): lv_tile's whole-row form on K1's default route, lv_gather
//     on K3's, row_prep_kernel after the clip; the wrapper rounds the
//     centres once to a bf16 (KP x SP) K-major copy.  TMA loads 128 x 64 and 256 x 64 boxes of
//     the two into a 4-stage shared-memory ring (48 KB a stage) in the
//     128-byte swizzle that wgmma reads; full/empty mbarriers hand the
//     stages over.
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
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int TBM = 128;     // rows per block
constexpr int TBN = 256;     // centres per block
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int A_ELEMS = TBM * TBK;
constexpr int B_ELEMS = TBN * TBK;
constexpr uint32_t STAGE_BYTES = (A_ELEMS + B_ELEMS) * 2;
constexpr size_t SMEM_BYTES =
    1024 + STAGES * (size_t)STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);

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
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rbase + 8 * h;
      float best;
      int bi;
      tile_argmax(d, h, inv_norm[row], col0, KP, best, bi);
      if (lane % 4 == 0) {
        part_val[(size_t)row * n_kb + kb] = best;
        part_idx[(size_t)row * n_kb + kb] = bi;
      }
    }
  }
}

}  // namespace

// lvb (rows, SP) and ctr (KP, SP) bf16; rows % 128 == 0, SP % 64 == 0,
// KP % 128 == 0 (the wrapper checks).  part_val / part_idx are (rows,
// ceil(KP / 256)).
extern "C" int sit_sims_wgmma(const void* lvb, const void* ctr,
                              const float* inv_norm, float* part_val,
                              int* part_idx, int rows, int SP, int KP,
                              void* stream) {
  CUtensorMap lv_map, ctr_map;
  int err = make_map(&lv_map, lvb, rows, SP, TBM);
  if (err) return err;
  err = make_map(&ctr_map, ctr, KP, SP, TBN);
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
