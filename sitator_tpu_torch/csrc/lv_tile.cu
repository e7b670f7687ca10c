// Unique-atom landmark-vector kernel.
//
// Replaces sitator_tpu/ops/landmark_mxu.py::_lv_kernel (K2) and is the
// first stage of ::_kernel (K1): the shared core ::_tile_lv.  For every
// (frame, ion, kd site tile): the log cutoff of the ion against each of the
// tile's unique static atoms (one minimum image per pair, or one per (ion,
// tile) on the preshift route), the product over each site's vertices as
// the log-space matmul logc (ions x UP) @ A_t (UP x s_tile) in f32 (no
// TF32: the preshift exactness bound and the gather <-> unique-atom label
// identity assume f32), then exp and the pad-kill.
//
// Design: A_t is a membership matrix: at most V nonzeros (small integer
// multiplicities) in a column of UP rows, 3% dense at the bench basis.  So
// the product runs over each column's nonzero list (ops/landmark_mxu.py::
// membership_lists: tile-local atom indices, ascending, padded with -1, and
// their multiplicities) instead of all UP rows: the same sequential f32 FMA
// in ascending k with the zero terms left out, bit-identical to the dense
// sum (landmark_common.cuh) with ~UP / V times fewer FMAs.  One block of
// 256 threads owns 32 ions x one whole site tile: it loads the tile's
// lists, computes the tile's logc (32 x n_u, n_u the atoms the lists use,
// at most UP) once into shared memory (one transcendental pair per (ion,
// unique atom); the pair index advances without an integer division), then
// each thread builds 8 ions x one site column at a time from the list, so a
// warp stores 32 neighbouring columns of one row.  The block is small in
// registers (4 blocks, 32 warps, an SM) so that one block's pair phase
// overlaps another's sums and stores (chip_smoke.py's stage timing on the
// H100: 3.2 ms per 32-frame bench block with 16 ions a thread, 2 blocks an
// SM and the pair index divided by UP; 1.9 ms so).
//
// What bounds it on an H100: the lv write, 4 B a (frame, ion, site) (0.92 GB
// per 32-frame bench block for K1, 109 MB for K2's 4 frames, 0.27 and 0.03
// ms at 3.35 TB/s), and the pair transcendentals (MP * UP * n_st pairs a
// frame).  The membership sum is 2 * nnz FMAs a row (nnz = 8 * S at the
// bench basis), no longer the bound.  For K1 the lv goes to scratch that
// assign_tail reads back; keeping it on chip is K1s's design
// (assign_skew_wgmma.cu).
#include "landmark_common.cuh"

namespace {

constexpr int BM = 32;        // ions per block
constexpr int THREADS = 256;
constexpr int LANES = 64;     // site columns in flight
constexpr int RM = BM / (THREADS / LANES);  // ions a thread accumulates

size_t lv_tile_smem(int UP, int s_tile, int vmax) {
  return sizeof(float) * ((size_t)BM * UP + 3 * BM + 3 * (size_t)UP) +
         (sizeof(int) + sizeof(float)) * (size_t)s_tile * vmax;
}

__global__ void __launch_bounds__(THREADS, 4) lv_tile_kernel(
    const float* __restrict__ mob,      // (B, 3, MP)
    const float* __restrict__ vpu,      // (B, n_st, 3, UP)
    const int* __restrict__ midx,       // (n_st, s_tile, vmax)
    const float* __restrict__ mmul,     // (n_st, s_tile, vmax)
    const float* __restrict__ kill,     // (n_st * s_tile)
    const float* __restrict__ anchors,  // (n_st, 3)
    const int* __restrict__ col_map,    // (n_st * s_tile)
    float* __restrict__ out,            // (B, M_out, out_cols)
    int MP, int M_out, int n_st, int UP, int s_tile, int vmax, int out_cols,
    CellParams P, int r2, int preshift) {
  const int t = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  extern __shared__ float sm[];
  __shared__ int n_used;  // unique atoms the lists use: 1 + their largest
  float* logc = sm;                      // (BM, UP)
  float* sx = logc + BM * UP;
  float* sy = sx + BM;
  float* sz = sy + BM;
  float* ux = sz + BM;
  float* uy = ux + UP;
  float* uz = uy + UP;
  int* sidx = reinterpret_cast<int*>(uz + UP);     // (vmax, s_tile)
  float* smul = reinterpret_cast<float*>(sidx + (size_t)vmax * s_tile);

  if (tid == 0) n_used = 0;
  __syncthreads();
  if (tid < BM) {
    const float* mb = mob + (size_t)b * 3 * MP;
    const int m = row0 + tid;
    float x = mb[m], y = mb[MP + m], z = mb[2 * MP + m];
    tile_ion_position(x, y, z, anchors, t, P, preshift);
    sx[tid] = x;
    sy[tid] = y;
    sz[tid] = z;
  }
  const float* vp = vpu + ((size_t)b * n_st + t) * 3 * UP;
  for (int k = tid; k < UP; k += THREADS) {
    ux[k] = vp[k];
    uy[k] = vp[UP + k];
    uz[k] = vp[2 * UP + k];
  }
  const int* gi = midx + (size_t)t * s_tile * vmax;
  const float* gm = mmul + (size_t)t * s_tile * vmax;
  int used = 0;
  for (int e = tid; e < s_tile * vmax; e += THREADS) {  // transpose: a
    const int c = e / vmax, j = e % vmax;              // warp reads one
    sidx[j * s_tile + c] = gi[e];                      // entry of 32
    smul[j * s_tile + c] = gm[e];                      // columns at once
    used = max(used, gi[e] + 1);
  }
  used = __reduce_max_sync(0xffffffffu, used);
  if (tid % 32 == 0) atomicMax(&n_used, used);
  __syncthreads();
  const int nu = n_used;  // 0 only on a tile without sites
  for (int r = nu ? tid / nu : BM, k = nu ? tid % nu : 0; r < BM;) {
    logc[r * UP + k] = unique_atom_log_factor(sx[r], sy[r], sz[r], ux[k],
                                              uy[k], uz[k], P, r2, preshift);
    k += THREADS;
    while (k >= nu) {
      k -= nu;
      ++r;
    }
  }
  __syncthreads();

  const int r0 = (tid / LANES) * RM;
  const float* kl = kill + (size_t)t * s_tile;
  const int* cm = col_map + (size_t)t * s_tile;
  for (int c = tid % LANES; c < s_tile; c += LANES) {
    const int oc = cm[c];
    if (oc < 0) continue;
    float acc[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) acc[i] = 0.0f;
    membership_sparse<RM>(acc, logc, UP, r0, sidx + c, smul + c, s_tile,
                          vmax);
    const float kc = kl[c];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = row0 + r0 + i;
      if (m < M_out)
        out[((size_t)b * M_out + m) * out_cols + oc] = lv_value(acc[i], kc);
    }
  }
}

}  // namespace

extern "C" int sit_lv_tile(const float* mob, const float* vpu,
                           const int* midx, const float* mmul,
                           const float* kill, const float* anchors,
                           const int* col_map, float* out, int B, int MP,
                           int M_out, int n_st, int UP, int s_tile, int vmax,
                           int out_cols, const float* params, int triclinic,
                           int r2, int preshift, void* stream) {
  const CellParams P = load_cell_params(params, triclinic);
  const size_t smem = lv_tile_smem(UP, s_tile, vmax);
  cudaError_t err = cudaFuncSetAttribute(
      lv_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_st, MP / BM, B);
  lv_tile_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      mob, vpu, midx, mmul, kill, anchors, col_map, out, MP, M_out, n_st, UP,
      s_tile, vmax, out_cols, P, r2, preshift);
  return (int)cudaGetLastError();
}

extern "C" const char* sit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
