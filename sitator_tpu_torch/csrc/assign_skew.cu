// K1s with f32 similarity operands: the skewed, fused unique-atom assign
// kernel on the f32 FMA pipes.
//
// Replaces sitator_tpu/ops/landmark_mxu.py::_kernel_skew (peak_evening =
// 'none') where the similarity operands are f32 (mxu_bf16=False).  The bf16
// route, the default, is assign_skew_wgmma.cu on the tensor cores; wgmma has
// no full-f32 mode and TF32 is not the reference's f32, so this kernel stays
// the f32 route, as K1 keeps its FMA tail (assign_tail.cu).  The caller's
// dtype picks the kernel.  It computes what K1 (lv_tile.cu + assign_tail.cu)
// computes, in one kernel, and keeps the landmark vectors on chip: per
// (frame, ion) row the lv of every kd site tile (the shared core of
// landmark_common.cuh), the norm, sims = lv @ centres with f32 FMA
// accumulation, sims * rsqrt(max(norm², 1e-24)), the arg-max over the KP
// centre columns with the lowest index winning a tie, and the threshold
// (label -1 below it).
//
// The TPU kernel skews its grid by one site tile: step st computes tile st's
// lv while folding tile st-1's into the similarity accumulator.  Here that
// overlap is warp specialisation inside one block of 384 threads that owns
// 16 ion rows of one frame:
//   - producer warps 0-3 compute each 128-site lv tile into a
//     double-buffered shared-memory ring (the membership product is staged
//     through shared memory in 32-atom slices);
//   - consumer warps 4-11 fold the previous tile from the other buffer
//     against the centres, which stream through shared memory in 16-site
//     slices with cp.async (two stages), into 8 x (KC / 128) register
//     accumulators per thread: all KC centre columns of the block's rows
//     live in registers, so the (MP x KP) accumulator of the TPU kernel is
//     never formed;
//   - named barriers hand the ring buffers over (FULL: producer -> consumer,
//     EMPTY: consumer -> producer).
// More than 1024 centres are taken in chunks of 1024 columns; each chunk
// recomputes the lv tiles, and the running arg-max is carried across chunks.
//
// Agreement with K1's f32 route: every lv element is the same sequential
// fmaf over the tile's unique atoms in ascending order as lv_tile's (the
// shared core of landmark_common.cuh; lv_tile skips the zero terms, which
// leaves the sum bit-identical), and norm² is summed lane-strided (lane l
// takes columns = l mod 32, in order) and xor-shuffled, as row_prep_kernel
// does.  The similarity is a sequential fmaf over sites 0 .. SP-1, while K1's
// FMA tail sums in 32-site slices per thread tile, so confidences agree to
// f32 rounding of that order.
//
// What bounds it on an H100: the similarity product on the f32 FMA pipes,
// 2 * MP * SP * KP flop a frame (14.7 GFLOP at the 10k-atom bench config),
// and the centre stream: every 16-row block reads all SP x KP centres from
// L2 (38 MB at the bench config).  The lv never goes to device memory.
#include <limits.h>
#include <math.h>

#include "hopper_common.cuh"
#include "landmark_common.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait_all;

constexpr int R = 16;               // ion rows of one frame per block
constexpr int TILE = 128;           // sites per lv tile in the ring
constexpr int UK = 32;              // unique atoms per producer slice
constexpr int CK = 16;              // sites per centre slice
constexpr int PRODUCERS = 128;      // warps 0-3
constexpr int CONSUMERS = 256;      // warps 4-11
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int RPT = 8;              // rows per consumer thread
constexpr int RG = R / RPT;         // consumer row groups
constexpr int CG = CONSUMERS / RG;  // consumer threads per row group
constexpr int CW = CG / 32;         // consumer warps per row group

// Named barriers (0 is __syncthreads, unused here).
constexpr int BAR_PRODUCER = 1;
constexpr int BAR_CONSUMER = 2;
constexpr int BAR_FULL = 3;   // 3, 4: ring buffer filled, producer -> consumer
constexpr int BAR_EMPTY = 5;  // 5, 6: ring buffer drained, consumer -> producer

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// (v, i) beats (bv, bi): larger value, or the same value at a lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <int NJ>
__global__ void __launch_bounds__(THREADS, 1) assign_skew_kernel(
    const float* __restrict__ mob,      // (B, 3, MP)
    const float* __restrict__ vpu,      // (B, n_st, 3, UP)
    const float* __restrict__ A,        // (n_st, UP, s_tile)
    const float* __restrict__ kill,     // (n_st * s_tile)
    const float* __restrict__ anchors,  // (n_st, 3)
    const float* __restrict__ C,        // (n_st * s_tile, ldc), padded
    int* __restrict__ labels,           // (B * MP)
    float* __restrict__ confs,          // (B * MP)
    int MP, int n_st, int UP, int s_tile, int KP, int ldc, CellParams P,
    int r2, int preshift) {
  constexpr int KC = 128 * NJ;  // centre columns per chunk
  const int row0 = blockIdx.x * R;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int cpt = s_tile / TILE;       // ring tiles per kd site tile
  const int n_tiles = n_st * cpt;      // ring tiles per centre chunk
  const int n_kc = ldc / KC;           // centre chunks
  const int n_g = n_kc * n_tiles;      // ring tiles in all

  __shared__ __align__(16) float ring[2][TILE][R];
  __shared__ __align__(16) float As[UK][R];
  __shared__ __align__(16) float Bs[UK][TILE];
  __shared__ float ux[UK], uy[UK], uz[UK];
  __shared__ float sx[R], sy[R], sz[R];
  __shared__ float sinv[R];
  __shared__ float red_v[RG][RPT][CW];
  __shared__ int red_i[RG][RPT][CW];
  __shared__ float run_v[R];
  __shared__ int run_i[R];
  extern __shared__ __align__(16) float Cs[];  // (2, CK, KC)

  if (tid < PRODUCERS) {
    // ---- producers: lv tiles into the ring ------------------------------
    const int w = tid / 32, l = tid % 32;  // rows 4w + i, columns l + 32 j
    const float* mb = mob + (size_t)b * 3 * MP + row0;
    const float* vpb = vpu + (size_t)b * n_st * 3 * UP;
    float n2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int g = 0; g < n_g; ++g) {
      const int buf = g & 1;
      const int tt = g % n_tiles;
      const int t = tt / cpt, c0 = (tt % cpt) * TILE;
      if (g >= 2) bar_sync(BAR_EMPTY + buf, THREADS);
      if (tid < R) {
        float x = mb[tid], y = mb[MP + tid], z = mb[2 * MP + tid];
        tile_ion_position(x, y, z, anchors, t, P, preshift);
        sx[tid] = x;
        sy[tid] = y;
        sz[tid] = z;
      }
      const float* vp = vpb + (size_t)t * 3 * UP;
      const float* At = A + (size_t)t * UP * s_tile + c0;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < UP; k0 += UK) {
        bar_sync(BAR_PRODUCER, PRODUCERS);  // slice consumed; ions visible
        if (tid < UK) {
          ux[tid] = vp[k0 + tid];
          uy[tid] = vp[UP + k0 + tid];
          uz[tid] = vp[2 * UP + k0 + tid];
        }
#pragma unroll
        for (int i = 0; i < UK * TILE / 4 / PRODUCERS; ++i) {
          const int e = tid + i * PRODUCERS;
          const int k = e / (TILE / 4), c4 = e % (TILE / 4);
          *reinterpret_cast<float4*>(&Bs[k][4 * c4]) =
              *reinterpret_cast<const float4*>(At + (size_t)(k0 + k) * s_tile +
                                               4 * c4);
        }
        bar_sync(BAR_PRODUCER, PRODUCERS);
#pragma unroll
        for (int i = 0; i < UK * R / PRODUCERS; ++i) {
          const int e = tid + i * PRODUCERS;
          const int r = e % R, k = e / R;
          As[k][r] = unique_atom_log_factor(sx[r], sy[r], sz[r], ux[k],
                                            uy[k], uz[k], P, r2, preshift);
        }
        bar_sync(BAR_PRODUCER, PRODUCERS);
        membership_fma<4, 4, UK>(acc, &As[0][0], R, 4 * w, 1, &Bs[0][0], TILE,
                                 l, 32);
      }
      // exp + pad-kill; the norm (first chunk only: the lv repeats)
      const float* kl = kill + (size_t)t * s_tile + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = kl[l + 32 * j];
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = lv_value(acc[i][j], kv);
          if (g < n_tiles) n2[i] = fmaf(x[i], x[i], n2[i]);
        }
        *reinterpret_cast<float4*>(&ring[buf][l + 32 * j][4 * w]) =
            make_float4(x[0], x[1], x[2], x[3]);
      }
      if (g == n_tiles - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int off = 16; off; off >>= 1)
            n2[i] += __shfl_xor_sync(0xffffffffu, n2[i], off);
          if (l == 0) sinv[4 * w + i] = rsqrtf(fmaxf(n2[i], 1e-24f));
        }
      }
      __threadfence_block();
      bar_arrive(BAR_FULL + buf, THREADS);
    }
    return;
  }

  // ---- consumers: fold the ring against the centres ---------------------
  const int c = tid - PRODUCERS;
  const int rg = c / CG, cg = c % CG;  // rows RPT * rg + i, cols cg + 128 j
  const int cw = cg / 32, lane = c % 32;
  constexpr int SLICES = TILE / CK;
  const int total = n_g * SLICES;

  auto load_slice = [&](int q) {
    const int g = q / SLICES, s = q % SLICES;
    const int kc = g / n_tiles, tt = g % n_tiles;
    const float* src = C + (size_t)(tt * TILE + s * CK) * ldc + kc * KC;
    float* dst = Cs + (q & 1) * CK * KC;
#pragma unroll
    for (int i = 0; i < CK * KC / 4 / CONSUMERS; ++i) {
      const int e = c + i * CONSUMERS;
      const int k = e / (KC / 4), c4 = e % (KC / 4);
      cp_async16(dst + k * KC + 4 * c4, src + (size_t)k * ldc + 4 * c4);
    }
    cp_async_commit();
  };

  float acc[RPT][NJ];
  load_slice(0);
  int q = 0;
  for (int g = 0; g < n_g; ++g) {
    const int buf = g & 1;
    const int kc = g / n_tiles, tt = g % n_tiles;
    if (tt == 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
    }
    bar_sync(BAR_FULL + buf, THREADS);
    const float* rb = &ring[buf][0][RPT * rg];
    for (int s = 0; s < SLICES; ++s, ++q) {
      cp_async_wait_all();
      bar_sync(BAR_CONSUMER, CONSUMERS);  // slice q landed; q-1 consumed
      if (q + 1 < total) load_slice(q + 1);
      const float* cs = Cs + (q & 1) * CK * KC + cg;
#pragma unroll
      for (int k = 0; k < CK; ++k) {
        const float* ar = rb + (s * CK + k) * R;
        const float4 a0 = *reinterpret_cast<const float4*>(ar);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + 4);
        const float a[RPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bb[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bb[j] = cs[k * KC + 128 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
    if (g + 2 < n_g) bar_arrive(BAR_EMPTY + buf, THREADS);

    if (tt == n_tiles - 1) {
      // arg-max of this chunk: thread, warp, row group; then the running
      // result across chunks (later chunks hold higher indices)
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float inv = sinv[RPT * rg + i];
        float bv = -INFINITY;
        int bi = INT_MAX;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {  // columns ascend with j
          const int col = kc * KC + cg + 128 * j;
          const float sim = acc[i][j] * inv;
          if (col < KP && sim > bv) {
            bv = sim;
            bi = col;
          }
        }
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (lane == 0) {
          red_v[rg][i][cw] = bv;
          red_i[rg][i][cw] = bi;
        }
      }
      bar_sync(BAR_CONSUMER, CONSUMERS);
      if (c < R) {
        const int rr = c / RPT, ii = c % RPT;
        float v = red_v[rr][ii][0];
        int ix = red_i[rr][ii][0];
        for (int w2 = 1; w2 < CW; ++w2)
          if (better(red_v[rr][ii][w2], red_i[rr][ii][w2], v, ix)) {
            v = red_v[rr][ii][w2];
            ix = red_i[rr][ii][w2];
          }
        if (kc > 0 && !(v > run_v[c])) {
          v = run_v[c];
          ix = run_i[c];
        }
        run_v[c] = v;
        run_i[c] = ix;
        if (kc == n_kc - 1) {
          const size_t row = (size_t)b * MP + row0 + c;
          confs[row] = v;
          labels[row] = v >= P.thr ? ix : -1;
        }
      }
    }
  }
}

template <int NJ>
int launch(const float* mob, const float* vpu, const float* A,
           const float* kill, const float* anchors, const float* C,
           int* labels, float* confs, int B, int MP, int n_st, int UP,
           int s_tile, int KP, int ldc, const CellParams& P, int r2,
           int preshift, cudaStream_t stream) {
  const int smem = 2 * CK * 128 * NJ * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      assign_skew_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  assign_skew_kernel<NJ><<<dim3(MP / R, B), THREADS, smem, stream>>>(
      mob, vpu, A, kill, anchors, C, labels, confs, MP, n_st, UP, s_tile, KP,
      ldc, P, r2, preshift);
  return (int)cudaGetLastError();
}

}  // namespace

// nj: centre columns per chunk / 128, one of 1, 2, 4, 8; ldc (the padded
// centre row length) is a multiple of 128 * nj; KP <= ldc columns count.
extern "C" int sit_assign_skew(const float* mob, const float* vpu,
                               const float* A, const float* kill,
                               const float* anchors, const float* C,
                               int* labels, float* confs, int B, int MP,
                               int n_st, int UP, int s_tile, int KP, int ldc,
                               int nj, const float* params, int triclinic,
                               int r2, int preshift, void* stream) {
  const CellParams P = load_cell_params(params, triclinic);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nj) {
    case 1:
      return launch<1>(mob, vpu, A, kill, anchors, C, labels, confs, B, MP,
                       n_st, UP, s_tile, KP, ldc, P, r2, preshift, s);
    case 2:
      return launch<2>(mob, vpu, A, kill, anchors, C, labels, confs, B, MP,
                       n_st, UP, s_tile, KP, ldc, P, r2, preshift, s);
    case 4:
      return launch<4>(mob, vpu, A, kill, anchors, C, labels, confs, B, MP,
                       n_st, UP, s_tile, KP, ldc, P, r2, preshift, s);
    case 8:
      return launch<8>(mob, vpu, A, kill, anchors, C, labels, confs, B, MP,
                       n_st, UP, s_tile, KP, ldc, P, r2, preshift, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
