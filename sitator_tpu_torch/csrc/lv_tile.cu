// Unique-atom landmark-vector kernel.
//
// Replaces sitator_tpu/ops/landmark_mxu.py::_lv_kernel (K2) and is the
// first stage of ::_kernel (K1): the shared core ::_tile_lv.  For every
// (frame, ion, kd site tile): the log cutoff of the ion against each of the
// tile's unique static atoms (one minimum image per pair, or one per (ion,
// tile) on the preshift route), the product over each site's vertices as
// the log-space matmul logc (ions x UP) @ A_t (UP x s_tile) in full f32
// FMAs (no TF32: the preshift exactness bound and the gather <-> unique-atom
// label identity assume f32), then exp and the pad-kill.
//
// Design: one block of 256 threads computes a 64-ion x 128-site output tile
// as a register-blocked product (4 x 8 outputs a thread), through the lv
// core of landmark_common.cuh that K1s (assign_skew.cu) runs too.  The A operand of
// the product, logc, is never stored: each 32-atom slice is computed into
// shared memory from the ion and atom coordinates, right before it is used.
// The B operand is the tile-local membership matrix, streamed through
// shared memory in 32 x 128 slices.
//
// What bounds it on an H100: the f32 FMA rate of the membership product
// (2 * MP * UP * SP flop a frame, 3.7 GFLOP at the 10k-atom bench basis)
// and the transcendental work of the cutoff (MP * UP * n_st pairs), once
// per 128-site column block.  The output write (MP * SP floats a frame) is
// the byte bound when the lv leaves the kernel, as it must for K2; for K1 it
// goes to scratch that assign_tail reads back (K1s keeps it on chip).
// Moving the product onto the tensor cores (A holds small integers, exact in
// bf16, but logc does not fit bf16) is later work.
#include "landmark_common.cuh"

namespace {

constexpr int BM = 64;    // ions per block
constexpr int BN = 128;   // sites per block
constexpr int BK = 32;    // unique atoms per shared-memory slice
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) lv_tile_kernel(
    const float* __restrict__ mob,      // (B, 3, MP)
    const float* __restrict__ vpu,      // (B, n_st, 3, UP)
    const float* __restrict__ A,        // (n_st, UP, s_tile)
    const float* __restrict__ kill,     // (n_st * s_tile)
    const float* __restrict__ anchors,  // (n_st, 3)
    const int* __restrict__ col_map,    // (n_st * s_tile)
    float* __restrict__ out,            // (B, M_out, out_cols)
    int MP, int M_out, int n_st, int UP, int s_tile, int out_cols,
    CellParams P, int r2, int preshift) {
  const int n_cb = (s_tile + BN - 1) / BN;
  const int t = blockIdx.x / n_cb;
  const int c0 = (blockIdx.x % n_cb) * BN;
  const int row0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  __shared__ float sx[BM], sy[BM], sz[BM];
  __shared__ float ux[BK], uy[BK], uz[BK];
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];

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
  const float* At = A + (size_t)t * UP * s_tile;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < UP; k0 += BK) {
    __syncthreads();  // previous slice consumed; ion coordinates visible
    if (tid < BK) {
      ux[tid] = vp[k0 + tid];
      uy[tid] = vp[UP + k0 + tid];
      uz[tid] = vp[2 * UP + k0 + tid];
    }
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int k = e / BN, c = e % BN;
      const int col = c0 + c;
      Bs[k][c] = col < s_tile ? At[(size_t)(k0 + k) * s_tile + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BK * BM / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e % BM, k = e / BM;
      As[k][r] = unique_atom_log_factor(sx[r], sy[r], sz[r], ux[k], uy[k],
                                        uz[k], P, r2, preshift);
    }
    __syncthreads();
    membership_fma<4, 8, BK>(acc, &As[0][0], BM, ty, 16, &Bs[0][0], BN, tx,
                             16);
  }

  const float* kl = kill + (size_t)t * s_tile;
  const int* cm = col_map + (size_t)t * s_tile;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = row0 + ty + 16 * i;
    if (m >= M_out) continue;
    float* orow = out + ((size_t)b * M_out + m) * out_cols;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= s_tile) continue;
      const int oc = cm[c];
      if (oc < 0) continue;
      orow[oc] = lv_value(acc[i][j], kl[c]);
    }
  }
}

}  // namespace

extern "C" int sit_lv_tile(const float* mob, const float* vpu, const float* A,
                           const float* kill, const float* anchors,
                           const int* col_map, float* out, int B, int MP,
                           int M_out, int n_st, int UP, int s_tile,
                           int out_cols, const float* params, int triclinic,
                           int r2, int preshift, void* stream) {
  const CellParams P = load_cell_params(params, triclinic);
  const int n_cb = (s_tile + BN - 1) / BN;
  const dim3 grid(n_st * n_cb, MP / BM, B);
  lv_tile_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      mob, vpu, A, kill, anchors, col_map, out, MP, M_out, n_st, UP, s_tile,
      out_cols, P, r2, preshift);
  return (int)cudaGetLastError();
}

extern "C" const char* sit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
