// Cosine-assignment tail shared by the unique-atom (K1) and gather (K3)
// routes.
//
// Replaces the assignment half of sitator_tpu/ops/landmark_mxu.py::_kernel
// and sitator_tpu/ops/landmark_pallas.py::_kernel: with peak_evening='clip'
// every row is capped at its second-largest value (kernel_common.merge_top2's
// rule: a repeated maximum is its own second value); then norm² from the f32
// lv, sims = lv @ centres, sims * rsqrt(max(norm², 1e-24)), the arg-max over
// all KP padded centre columns with the lowest index winning a tie, and the
// threshold (label -1 below it).
//
// Design: the TPU kernel keeps a (MP x KP) f32 similarity accumulator in
// VMEM (3 MB at the bench shape); an SM has 227 KB of shared memory.  So the
// accumulator is never formed: the product is tiled over blocks of rows x
// centres, each reducing its own row-wise max and arg-max in the epilogue,
// and argmax_merge_kernel merges the partial results of every row in centre
// order.  Three launches, each its own C entry so that every stage can be
// timed alone:
//   - row_prep_kernel (one warp a row): the clip in place, inv_norm, and for
//     bf16 operands a bf16 copy of the clipped row.  Only the clip and f32
//     operands run it, on K1 and K3 alike: with bf16 operands and no clip
//     (the default) the landmark stage owns whole rows and writes the bf16
//     copy and inv_norm itself, in this kernel's order (lv_tile.cu's
//     whole-row form on K1, lv_gather.cu on K3);
//   - the product: with bf16 operands (the reference's mxu_bf16=True) on the
//     tensor cores, sims_wgmma.cu (128 x 256 blocks); with f32 operands
//     (mxu_bf16=False; wgmma has no full-f32 mode and TF32 is not the
//     reference's f32) sims_argmax_kernel below on the f32 FMA pipes (64 x
//     128 blocks).  The caller's dtype picks the kernel;
//   - argmax_merge_kernel.
//
// What bounds it on an H100: the similarity product, 2 * MP * SP * KP flop
// a frame (14.7 GFLOP at the 10k-atom bench config): 989 TFLOP/s in bf16 on
// the tensor cores, 67 TFLOP/s in f32 on the FMA pipes.  row_prep reads the
// f32 lv (once, twice with the clip) and writes the bf16 copy.
#include <cuda_bf16.h>
#include <math.h>

#include "landmark_common.cuh"

namespace {

constexpr int BM = 64;    // rows (frame x ion) per block
constexpr int BN = 128;   // centres per block
constexpr int BK = 32;    // sites per shared-memory slice
constexpr int THREADS = 256;

__global__ void row_prep_kernel(float* __restrict__ lv,
                                __nv_bfloat16* __restrict__ lvb,
                                float* __restrict__ inv_norm, int rows,
                                int cols, int clip) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps exit together
  float* r = lv + (size_t)row * cols;
  __nv_bfloat16* rb = lvb ? lvb + (size_t)row * cols : nullptr;
  float cap = 0.0f;
  if (clip) {
    // running top-2 of the row as a multiset (lv >= 0, so starting from
    // (0, 0) as the reference does changes nothing)
    float a1 = 0.0f, a2 = 0.0f;
    for (int c = lane; c < cols; c += 32) {
      const float x = r[c];
      if (x >= a1) {
        a2 = a1;
        a1 = x;
      } else if (x > a2) {
        a2 = x;
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float b1 = __shfl_xor_sync(0xffffffffu, a1, off);
      const float b2 = __shfl_xor_sync(0xffffffffu, a2, off);
      const float n2 = fmaxf(fminf(a1, b1), fmaxf(a2, b2));
      a1 = fmaxf(a1, b1);
      a2 = n2;
    }
    cap = a2;
  }
  float n2 = 0.0f;
  for (int c = lane; c < cols; c += 32) {
    float x = r[c];
    if (clip) {
      x = fminf(x, cap);
      r[c] = x;
    }
    if (rb) rb[c] = __float2bfloat16_rn(x);
    n2 = fmaf(x, x, n2);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    n2 += __shfl_xor_sync(0xffffffffu, n2, off);
  if (lane == 0) inv_norm[row] = rsqrtf(fmaxf(n2, 1e-24f));
}

__global__ void __launch_bounds__(THREADS) sims_argmax_kernel(
    const float* __restrict__ lv,        // (rows, cols)
    const float* __restrict__ inv_norm,  // (rows)
    const float* __restrict__ C,         // (cols, KP)
    float* __restrict__ part_val,        // (rows, KP / BN)
    int* __restrict__ part_idx, int rows, int cols, int KP) {
  const int kb = blockIdx.x;
  const int n_kb = gridDim.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = kb * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  __shared__ float As[BK][BM + 1];  // +1: the transposing store is
                                    // conflict-free
  __shared__ float Bs[BK][BN];

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < cols; k0 += BK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BK * BM / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e % BK, r = e / BK;
      float v = 0.0f;
      if (row0 + r < rows && k0 + k < cols)
        v = lv[(size_t)(row0 + r) * cols + k0 + k];
      As[k][r] = v;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / BN, c = e % BN;
      float v = 0.0f;
      if (k0 + k < cols) v = C[(size_t)(k0 + k) * KP + col0 + c];
      Bs[k][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], bb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    const float inv = row < rows ? inv_norm[row] : 0.0f;
    float best = -INFINITY;
    int bi = col0 + tx;
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // columns ascend with j: strict > keeps
      const float s = acc[i][j] * inv;  // the first of equal values
      if (s > best) {
        best = s;
        bi = col0 + tx + 16 * j;
      }
    }
    // merge across the 16 threads that share this row (one half-warp)
#pragma unroll
    for (int off = 8; off; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    if (tx == 0 && row < rows) {
      part_val[(size_t)row * n_kb + kb] = best;
      part_idx[(size_t)row * n_kb + kb] = bi;
    }
  }
}

__global__ void argmax_merge_kernel(const float* __restrict__ part_val,
                                    const int* __restrict__ part_idx,
                                    int rows, int n_kb, float thr,
                                    int* __restrict__ labels,
                                    float* __restrict__ confs) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float* pv = part_val + (size_t)row * n_kb;
  const int* pi = part_idx + (size_t)row * n_kb;
  float best = pv[0];
  int bi = pi[0];
  for (int kb = 1; kb < n_kb; ++kb) {  // blocks ascend: strict > keeps the
    if (pv[kb] > best) {               // lowest index on a tie
      best = pv[kb];
      bi = pi[kb];
    }
  }
  confs[row] = best;
  labels[row] = best >= thr ? bi : -1;
}

}  // namespace

extern "C" int sit_row_prep(float* lv, void* lvb, float* inv_norm, int rows,
                            int cols, int clip, void* stream) {
  row_prep_kernel<<<(rows + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      lv, static_cast<__nv_bfloat16*>(lvb), inv_norm, rows, cols, clip);
  return (int)cudaGetLastError();
}

// part_val / part_idx are (rows, KP / 128).
extern "C" int sit_sims_fma(const float* lv, const float* inv_norm,
                            const float* C, float* part_val, int* part_idx,
                            int rows, int cols, int KP, void* stream) {
  sims_argmax_kernel<<<dim3(KP / BN, (rows + BM - 1) / BM), THREADS, 0,
                       (cudaStream_t)stream>>>(lv, inv_norm, C, part_val,
                                               part_idx, rows, cols, KP);
  return (int)cudaGetLastError();
}

extern "C" int sit_argmax_merge(const float* part_val, const int* part_idx,
                                int* labels, float* confs, int rows, int n_kb,
                                float thr, void* stream) {
  argmax_merge_kernel<<<(rows + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part_val, part_idx, rows, n_kb, thr, labels, confs);
  return (int)cudaGetLastError();
}
