// Shared device helpers of the landmark kernels: the cell/params layout
// written by sitator_tpu_torch.ops.kernel_common.pack_cell_params, the
// minimum image, and the log cutoff.  Same math as the plain PyTorch
// versions in sitator_tpu_torch/ops/kernel_common.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Kernel arguments are copied at launch, so the params live in the launch
// (no device buffer, no host sync).
struct CellParams {
  float c[9];    // triclinic: rows are lattice vectors
  float ci[9];   // triclinic: inverse
  float l[3];    // orthorhombic: lengths
  float il[3];   // orthorhombic: 1 / lengths, rounded to float32
  float mid, steep, thr;
  int tri;
};

// params: 21 floats [cell(9), inv(9), mid, steep, thr] when triclinic,
// else 6 floats [lx, ly, lz, mid, steep, thr]; host memory.
static inline CellParams load_cell_params(const float* p, int tri) {
  CellParams k = {};
  k.tri = tri;
  if (tri) {
    for (int i = 0; i < 9; ++i) {
      k.c[i] = p[i];
      k.ci[i] = p[9 + i];
    }
    k.mid = p[18];
    k.steep = p[19];
    k.thr = p[20];
  } else {
    for (int i = 0; i < 3; ++i) {
      k.l[i] = p[i];
      k.il[i] = 1.0f / p[i];
    }
    k.mid = p[3];
    k.steep = p[4];
    k.thr = p[5];
  }
  return k;
}

// Every sum of products below is written out as fused multiply-adds in a
// fixed order, so that each kernel computes it with the same roundings
// (left to itself the compiler picks which product to fuse, and may pick
// differently in two kernels).
__device__ __forceinline__ float dot3(float x, float y, float z, float a,
                                      float b, float c) {
  return __fmaf_rn(z, c, __fmaf_rn(y, b, __fmul_rn(x, a)));
}

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return dot3(dx, dy, dz, dx, dy, dz);
}

// Round to the nearest integer, half to even, as rintf and the reference's
// round do, with two f32 adds on the full-rate pipe (rintf is a conversion
// instruction at a quarter of the f32 rate on Hopper, and the minimum image
// takes three a pair): adding 1.5 * 2^23 leaves no fraction bits, so the
// add rounds x to an integer in the current rounding mode (nearest even).
// Exact for |x| < 2^22 cell lengths (f32 coordinates that far apart carry
// no sub-cell information); the zero it returns for -0.5 < x < 0 is +0
// where rintf gives -0, which no distance below can see.
__device__ __forceinline__ float round_even(float x) {
  return __fsub_rn(__fadd_rn(x, 12582912.0f), 12582912.0f);
}

// The minimum image with the cell kind known at compile time (kernels
// whose inner loops unroll over several pairs take this form, so that no
// branch splits the pairs' instructions); min_image dispatches on P.tri.
template <bool TRI>
__device__ __forceinline__ void min_image_t(float& dx, float& dy, float& dz,
                                            const CellParams& P) {
  if (TRI) {
    float fx = dot3(dx, dy, dz, P.ci[0], P.ci[3], P.ci[6]);
    float fy = dot3(dx, dy, dz, P.ci[1], P.ci[4], P.ci[7]);
    float fz = dot3(dx, dy, dz, P.ci[2], P.ci[5], P.ci[8]);
    fx -= round_even(fx);
    fy -= round_even(fy);
    fz -= round_even(fz);
    dx = dot3(fx, fy, fz, P.c[0], P.c[3], P.c[6]);
    dy = dot3(fx, fy, fz, P.c[1], P.c[4], P.c[7]);
    dz = dot3(fx, fy, fz, P.c[2], P.c[5], P.c[8]);
  } else {
    dx = __fmaf_rn(-round_even(__fmul_rn(dx, P.il[0])), P.l[0], dx);
    dy = __fmaf_rn(-round_even(__fmul_rn(dy, P.il[1])), P.l[1], dy);
    dz = __fmaf_rn(-round_even(__fmul_rn(dz, P.il[2])), P.l[2], dz);
  }
}

__device__ __forceinline__ void min_image(float& dx, float& dy, float& dz,
                                          const CellParams& P) {
  if (P.tri) {
    min_image_t<true>(dx, dy, dz, P);
  } else {
    min_image_t<false>(dx, dy, dz, P);
  }
}

// Argument of the logistic: k (d - d0), or the slope-matched d² form
// k2 d² - k2 d0² with k2 = k / (2 d0).
template <bool R2>
__device__ __forceinline__ float cutoff_arg_t(float d2, const CellParams& P) {
  if (R2) {
    const float k2 = P.steep / (2.0f * P.mid);
    return __fmaf_rn(k2, d2, -__fmul_rn(k2, __fmul_rn(P.mid, P.mid)));
  }
  return P.steep * (sqrtf(d2) - P.mid);
}

__device__ __forceinline__ float cutoff_arg(float d2, const CellParams& P,
                                           int r2) {
  return r2 ? cutoff_arg_t<true>(d2, P) : cutoff_arg_t<false>(d2, P);
}

// log of the logistic: -softplus(x) = -(max(x, 0) + log1p(exp(-|x|))).
__device__ __forceinline__ float log_cutoff(float x) {
  return -(fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))));
}

// ---------------------------------------------------------------------------
// The unique-atom landmark-vector core, shared by lv_tile.cu (K2, K1's first
// stage), assign_skew_wgmma.cu and assign_skew.cu (K1s), so that they
// compute every lv element with the same operations in the same order (the
// cluster kernel writes steps 2 and 3 out for several pairs or columns at a
// time, with the same operations per element).  Per (ion, kd site tile t):
//   1. tile_ion_position: on the preshift route the ion moves to its image
//      nearest the tile anchor (one minimum image per (ion, tile));
//   2. unique_atom_log_factor: the log cutoff against one unique atom (one
//      minimum image per pair off the preshift route);
//   3. the membership sum lv_acc = sum_k logc[k] * A_t[k, c] as a sequential
//      f32 FMA in ascending k: over every unique atom (membership_fma, the
//      f32 K1s) or over the column's nonzeros only (membership_sparse,
//      lv_tile, and the same loop in the cluster K1s).  The
//      two are bit-identical: the accumulator starts at +0 and logc is
//      finite and <= 0, so fmaf(logc, 0, acc) == acc for every skipped k
//      (a -0 product added to +0 gives +0);
//   4. lv_value: exp, then 0 on padded site columns.

__device__ __forceinline__ void tile_ion_position_at(float& x, float& y,
                                                     float& z, float ax,
                                                     float ay, float az,
                                                     const CellParams& P) {
  float dx = x - ax, dy = y - ay, dz = z - az;
  min_image(dx, dy, dz, P);
  x = ax + dx;
  y = ay + dy;
  z = az + dz;
}

__device__ __forceinline__ void tile_ion_position(float& x, float& y,
                                                  float& z,
                                                  const float* anchors,
                                                  int t, const CellParams& P,
                                                  int preshift) {
  if (!preshift) return;
  tile_ion_position_at(x, y, z, anchors[3 * t], anchors[3 * t + 1],
                       anchors[3 * t + 2], P);
}

__device__ __forceinline__ float unique_atom_log_factor(
    float x, float y, float z, float ux, float uy, float uz,
    const CellParams& P, int r2, int preshift) {
  float dx = x - ux, dy = y - uy, dz = z - uz;
  if (!preshift) min_image(dx, dy, dz, P);
  return log_cutoff(cutoff_arg(dist2(dx, dy, dz), P, r2));
}

// acc[i][j] = fmaf(As[k][r0 + i * rs], Bs[k][c0 + j * cs], acc[i][j]) for
// k = 0 .. BK-1 in order; As is (BK x lda), Bs is (BK x ldb), both shared.
template <int RM, int RN, int BK>
__device__ __forceinline__ void membership_fma(float (&acc)[RM][RN],
                                               const float* As, int lda,
                                               int r0, int rs,
                                               const float* Bs, int ldb,
                                               int c0, int cs) {
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = As[k * lda + r0 + i * rs];
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = Bs[k * ldb + c0 + j * cs];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i] = fmaf(logc[(r0 + i) * ld + k_j], mult_j, acc[i]) over the
// column's nonzero membership rows k_j in ascending order; idx / mult hold
// the list with a stride of ``stride`` between entries, padded with -1 after
// its last entry (at most vmax entries).
template <int RM>
__device__ __forceinline__ void membership_sparse(float (&acc)[RM],
                                                  const float* logc, int ld,
                                                  int r0, const int* idx,
                                                  const float* mult,
                                                  int stride, int vmax) {
  for (int j = 0; j < vmax; ++j) {
    const int k = idx[j * stride];
    if (k < 0) break;
    const float a = mult[j * stride];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      acc[i] = fmaf(logc[(r0 + i) * ld + k], a, acc[i]);
  }
}

__device__ __forceinline__ float lv_value(float acc, float kill) {
  return kill > 0.0f ? 0.0f : expf(acc);
}
