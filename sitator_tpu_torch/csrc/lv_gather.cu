// Per-vertex gather landmark-vector kernel.
//
// Replaces the landmark half of sitator_tpu/ops/landmark_pallas.py::_kernel
// (K3); the assignment half is assign_tail.cu.  For every (frame, ion,
// site): over the site's V vertex slots, the minimum image to that vertex,
// x = k (d - d0) (or the d² form), and q *= 1 + e^{max(x, -80)} with the
// slot's mask (or q += q e when every slot is valid).  lv = 1 / q: a far
// site overflows q to +inf and gets an exact 0.  The lower clamp keeps e
// from flushing to 0, which would make inf * 0 = NaN once q is inf.  Mask
// row V kills padding sites.
//
// Design: one thread per (ion, site) pair; a block covers 128 sites x 8
// ions, so neighbouring threads read neighbouring vertex coordinates and
// write neighbouring lv entries.  The ion's coordinates are loaded once.
//
// What bounds it on an H100: the transcendental work, one exp (plus a sqrt
// on the plain logistic) per (ion, site, vertex) — 57 M per frame at the
// 10k-atom bench basis — and the lv write to scratch (MP * SP floats a
// frame), which assign_tail reads back.  It recomputes per pair what the
// unique-atom kernel shares across a tile, which is why it is the route
// only for bases without vertex sharing, and the exactness arbiter.
#include "landmark_common.cuh"

namespace {

constexpr int TS = 128;  // sites per block
constexpr int TM = 8;    // ions per block

__global__ void __launch_bounds__(TS * TM) lv_gather_kernel(
    const float* __restrict__ mob,   // (B, 3, MP)
    const float* __restrict__ vp,    // (B, 3, V, SP)
    const float* __restrict__ mask,  // (V + 1, SP)
    float* __restrict__ out,         // (B, MP, SP)
    int MP, int V, int SP, CellParams P, int r2, int full_mask) {
  const int s = blockIdx.x * TS + threadIdx.x;
  const int m = blockIdx.y * TM + threadIdx.y;
  const int b = blockIdx.z;
  if (s >= SP || m >= MP) return;
  const float* mb = mob + (size_t)b * 3 * MP;
  const float x = mb[m], y = mb[MP + m], z = mb[2 * MP + m];
  const float* vb = vp + (size_t)b * 3 * V * SP;
  float q = 1.0f;
  for (int v = 0; v < V; ++v) {
    float dx = x - vb[(size_t)v * SP + s];
    float dy = y - vb[(size_t)(V + v) * SP + s];
    float dz = z - vb[(size_t)(2 * V + v) * SP + s];
    min_image(dx, dy, dz, P);
    const float e = expf(fmaxf(cutoff_arg(dx * dx + dy * dy + dz * dz, P, r2),
                               -80.0f));
    if (full_mask) {
      q = q + q * e;
    } else {
      q = q * (mask[(size_t)v * SP + s] > 0.0f ? 1.0f + e : 1.0f);
    }
  }
  const float lv = mask[(size_t)V * SP + s] > 0.0f ? 0.0f : 1.0f / q;
  out[((size_t)b * MP + m) * SP + s] = lv;
}

}  // namespace

extern "C" int sit_lv_gather(const float* mob, const float* vp,
                             const float* mask, float* out, int B, int MP,
                             int V, int SP, const float* params, int triclinic,
                             int r2, int full_mask, void* stream) {
  const CellParams P = load_cell_params(params, triclinic);
  const dim3 grid((SP + TS - 1) / TS, (MP + TM - 1) / TM, B);
  lv_gather_kernel<<<grid, dim3(TS, TM), 0, (cudaStream_t)stream>>>(
      mob, vp, mask, out, MP, V, SP, P, r2, full_mask);
  return (int)cudaGetLastError();
}
