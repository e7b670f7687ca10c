// Per-vertex gather landmark-vector kernel: K3's first stage.
//
// Replaces the landmark half of sitator_tpu/ops/landmark_pallas.py::_kernel
// (K3); the assignment half is sims_wgmma.cu / assign_tail.cu.  For every
// (frame, ion, site): over the site's V vertex slots in order, the minimum
// image to that vertex, x = k (d - d0) (or the d² form), and q *= 1 +
// e^{max(x, -80)} with the slot's mask (or q += q e when every slot is
// valid).  lv = 1 / q: a far site overflows q to +inf and gets an exact 0.
// The lower clamp keeps e from flushing to 0, which would make inf * 0 = NaN
// once q is inf.  Mask row V kills padding sites.
//
// What bounds it on an H100: the arithmetic, one exp (and a sqrt on the
// plain logistic) and about 16 f32 operations per (ion, site, vertex):
// 1.8 G pair-vertices and 29 GFLOP per 32-frame bench block (9261 sites x 8
// vertices x 739 ions), 0.43 ms at the 67 TFLOP/s f32 peak; and the lv
// write, 4 B (f32) or 2 B (bf16) a (frame, ion, site).  As written the
// pair takes about 30 issued instructions (the minimum image rounds by two
// adds, the accurate expf is eight), 1.9 ms of issue at the bench block;
// chip_smoke.py measures 3.1 ms on the H100.
//
// Design: one warp owns R = 8 ion rows of one frame and sweeps the whole
// site axis; lane l takes columns l + 32 j in ascending order.  A lane
// loads its site's vertex coordinates and mask once per column and reuses
// them across the warp's 8 ions (the first form of this kernel ran one
// thread per pair and issued four global loads per pair and vertex), and
// the block's 4 warps
// sweep the same columns for other ions, so those loads hit L1.  Each
// pair's arithmetic is the per-pair formula in the same order, so the f32
// lv is the same whichever output the launch writes:
//   - f32 output (the clip, or f32 similarity operands): the lv row, for
//     row_prep and the FMA tail as before;
//   - bf16 output (bf16 operands, no clip: the default): because the warp
//     owns whole rows, it forms the norm itself in row_prep's order (lane l
//     sums fmaf(x, x, n2) over its columns ascending, then an xor-shuffle)
//     and writes only the bf16 copy and inv_norm = rsqrt(max(n2, 1e-24)).
//     The f32 lv never reaches device memory and row_prep drops out of the
//     route; the outputs are bit-equal to row_prep run on the f32 lv.
#include <cuda_bf16.h>

#include "landmark_common.cuh"

namespace {

constexpr int R = 8;       // ion rows per warp
constexpr int WARPS = 4;   // warps per block (rows R * WARPS of one frame)

template <bool BF16, bool TRI, bool R2, bool FULL>
__global__ void __launch_bounds__(32 * WARPS) lv_gather_kernel(
    const float* __restrict__ mob,    // (B, 3, MP)
    const float* __restrict__ vp,     // (B, 3, V, SP)
    const float* __restrict__ mask,   // (V + 1, SP)
    float* __restrict__ out,          // (B * MP, SP) f32, or
    __nv_bfloat16* __restrict__ outb, // (B * MP, SP) bf16 with
    float* __restrict__ inv_norm,     // (B * MP)
    int MP, int V, int SP, CellParams P) {
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * WARPS + threadIdx.x / 32) * R;
  const int b = row0 / MP, m0 = row0 % MP;  // MP % R == 0: one frame
  const float* mb = mob + (size_t)b * 3 * MP + m0;
  const float* vb = vp + (size_t)b * 3 * V * SP;
  float x[R], y[R], z[R], n2[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    x[i] = mb[i];
    y[i] = mb[MP + i];
    z[i] = mb[2 * MP + i];
    n2[i] = 0.0f;
  }
  for (int c = lane; c < SP; c += 32) {
    float q[R];
#pragma unroll
    for (int i = 0; i < R; ++i) q[i] = 1.0f;
    for (int v = 0; v < V; ++v) {
      const float vx = vb[(size_t)v * SP + c];
      const float vy = vb[(size_t)(V + v) * SP + c];
      const float vz = vb[(size_t)(2 * V + v) * SP + c];
      const bool on = FULL || mask[(size_t)v * SP + c] > 0.0f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float dx = x[i] - vx, dy = y[i] - vy, dz = z[i] - vz;
        min_image_t<TRI>(dx, dy, dz, P);
        const float e = expf(fmaxf(
            cutoff_arg_t<R2>(dist2(dx, dy, dz), P), -80.0f));
        if (FULL) {
          q[i] = __fmaf_rn(q[i], e, q[i]);
        } else {
          q[i] = q[i] * (on ? 1.0f + e : 1.0f);
        }
      }
    }
    const bool kill = mask[(size_t)V * SP + c] > 0.0f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float lv = kill ? 0.0f : 1.0f / q[i];
      const size_t at = (size_t)(row0 + i) * SP + c;
      if (BF16) {
        n2[i] = fmaf(lv, lv, n2[i]);
        outb[at] = __float2bfloat16_rn(lv);
      } else {
        out[at] = lv;
      }
    }
  }
  if (BF16) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int off = 16; off; off >>= 1)
        n2[i] += __shfl_xor_sync(0xffffffffu, n2[i], off);
      if (lane == 0) inv_norm[row0 + i] = rsqrtf(fmaxf(n2[i], 1e-24f));
    }
  }
}

// Every flag a template argument, so that the unrolled loop over the
// warp's 8 ions holds no branch.
template <bool BF16, bool TRI, bool R2, bool FULL>
int launch(const float* mob, const float* vp, const float* mask, float* out,
           void* lvb, float* inv_norm, int B, int MP, int V, int SP,
           const CellParams& P, cudaStream_t s) {
  lv_gather_kernel<BF16, TRI, R2, FULL><<<B * MP / (R * WARPS), 32 * WARPS,
                                          0, s>>>(
      mob, vp, mask, out, static_cast<__nv_bfloat16*>(lvb), inv_norm, MP, V,
      SP, P);
  return (int)cudaGetLastError();
}

template <bool BF16, bool TRI, bool R2>
int launch_mask(int full, const float* mob, const float* vp,
                const float* mask, float* out, void* lvb, float* inv_norm,
                int B, int MP, int V, int SP, const CellParams& P,
                cudaStream_t s) {
  return full ? launch<BF16, TRI, R2, true>(mob, vp, mask, out, lvb, inv_norm,
                                            B, MP, V, SP, P, s)
              : launch<BF16, TRI, R2, false>(mob, vp, mask, out, lvb,
                                             inv_norm, B, MP, V, SP, P, s);
}

template <bool BF16, bool TRI>
int launch_r2(int r2, int full, const float* mob, const float* vp,
              const float* mask, float* out, void* lvb, float* inv_norm,
              int B, int MP, int V, int SP, const CellParams& P,
              cudaStream_t s) {
  return r2 ? launch_mask<BF16, TRI, true>(full, mob, vp, mask, out, lvb,
                                           inv_norm, B, MP, V, SP, P, s)
            : launch_mask<BF16, TRI, false>(full, mob, vp, mask, out, lvb,
                                            inv_norm, B, MP, V, SP, P, s);
}

template <bool BF16>
int launch_tri(int tri, int r2, int full, const float* mob, const float* vp,
               const float* mask, float* out, void* lvb, float* inv_norm,
               int B, int MP, int V, int SP, const CellParams& P,
               cudaStream_t s) {
  return tri ? launch_r2<BF16, true>(r2, full, mob, vp, mask, out, lvb,
                                     inv_norm, B, MP, V, SP, P, s)
             : launch_r2<BF16, false>(r2, full, mob, vp, mask, out, lvb,
                                      inv_norm, B, MP, V, SP, P, s);
}

}  // namespace

// With lvb (bf16 (B * MP, SP)) the launch writes the bf16 copy and inv_norm
// (B * MP) and leaves out alone; else the f32 lv into out (B * MP, SP).
// MP % 32 == 0 (the wrapper checks).
extern "C" int sit_lv_gather(const float* mob, const float* vp,
                             const float* mask, float* out, void* lvb,
                             float* inv_norm, int B, int MP, int V, int SP,
                             const float* params, int triclinic, int r2,
                             int full_mask, void* stream) {
  const CellParams P = load_cell_params(params, triclinic);
  cudaStream_t s = (cudaStream_t)stream;
  if (lvb)
    return launch_tri<true>(triclinic, r2, full_mask, mob, vp, mask, nullptr,
                            lvb, inv_norm, B, MP, V, SP, P, s);
  return launch_tri<false>(triclinic, r2, full_mask, mob, vp, mask, out,
                           nullptr, nullptr, B, MP, V, SP, P, s);
}
