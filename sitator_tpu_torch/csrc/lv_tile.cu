// Unique-atom landmark-vector kernel, in two forms.
//
// Replaces sitator_tpu/ops/landmark_mxu.py::_lv_kernel (K2) and is the
// first stage of ::_kernel (K1): the shared core ::_tile_lv.  For every
// (frame, ion, kd site tile) it takes the log cutoff against the tile's
// unique static atoms, sums logc @ A_t over the tile's vertex memberships
// (the reference runs that product on the MXU; here it is the same
// ascending-k f32 sum written out, exact in f32 like the reference's
// TF32: the preshift exactness bound and the gather <-> unique-atom label
// identity assume f32), then exp and the pad-kill.
//
// Design common to both forms: A_t is a membership matrix: at most V
// nonzeros (small integer multiplicities) in a column of UP rows, 3% dense
// at the bench basis.  So the product runs over each column's nonzero list
// (ops/landmark_mxu.py::membership_lists: tile-local atom indices,
// ascending, padded with -1, and their multiplicities) instead of all UP
// rows: the same sequential f32 FMA in ascending k with the zero terms left
// out, bit-identical to the dense sum (landmark_common.cuh) with ~UP / V
// times fewer FMAs.  A block of 256 threads owns 32 ions of one frame; for a
// site tile it loads the tile's lists, computes the tile's logc (32 x n_u,
// n_u the atoms the lists use, at most UP) once into shared memory (one
// transcendental pair per (ion, unique atom)), then builds the tile's
// columns from the lists.  The pair loop is atom-major: a thread holds one
// unique atom in registers and sweeps the 32 ions (broadcast reads of
// shared memory, four pairs in flight), with the cutoff shape and the
// preshift route as template arguments (R2, PRE: unique_atom_log_factor,
// inlined, folds its branches on them); the atoms past n_u leave their
// threads idle there (n_u 110-240 of 256 at the bench basis).  The block is
// small in registers (4 blocks, 32 warps, an SM) so that one block's pair
// phase overlaps another's sums and stores.  Both forms compute every f32
// lv element with the same operations in the same order
// (landmark_common.cuh's helpers).
//
// The two forms, one kernel name (lv_tile_kernel<ROWS, R2, PRE>), so that
// a trace finds K1's landmark stage by that name either way:
//   - f32 (K2; K1 with the clip, f32 similarity operands or s_tile % 32
//     != 0): a block owns one site tile (the grid cuts the site axis into
//     n_st tiles); a thread builds 8 ions x one site column at a time, so
//     a warp stores 32 neighbouring columns of one row into out (B, M_out,
//     out_cols), column c of the tile at col_map[c] (K2's caller order;
//     K1's identity, and row_prep in assign_tail.cu then forms the norm
//     and the bf16 copy).  Bound on an H100: the f32 write, 4 B a (frame, ion,
//     site), 0.92 GB a 32-frame bench block and 29.4 GB a 1024-frame one
//     (0.27 and 8.8 ms at 3.35 TB/s), and the pair transcendentals,
//     MP * UP * n_st pairs a frame, which dominate: 1.63-1.70 ms a 32-frame
//     bench block on the H100 (chip_smoke.py's stage timing), row_prep
//     0.64-0.67 more on K1.
//   - whole rows (K1 with bf16 operands and no clip, the default): a block
//     walks all n_st tiles of its frame in ascending order, the loop that
//     takes the place of the TPU's sequential grid axis, so it holds whole
//     rows.  Warp w owns ions 4w .. 4w + 3 and lane l builds columns
//     l + 32 j of each tile; since s_tile % 32 == 0 lane l meets exactly the
//     row's columns l + 32 j in ascending global order, which is
//     row_prep's: it sums fmaf(x, x, n2) over them, then the xor-shuffle
//     16 .. 1, then inv_norm = rsqrt(max(n2, 1e-24)).  It writes only the
//     bf16 copy (B * MP, SP) and inv_norm (B * MP) that sims_wgmma.cu
//     reads, bit-equal to the f32 form + row_prep (chip_smoke.py's
//     k1_routes): the f32 lv never reaches device memory and row_prep
//     leaves the route.  Bound on an H100: the bf16 write, 2 B a (frame,
//     ion, site), 14.7 GB a 1024-frame block (4.4 ms), and the same pair
//     transcendentals, which dominate.  On the H100 it takes 1.87-1.96 ms a
//     bench block, and 0.81 s of a 16,384-frame sc10k pass where the f32
//     form and row_prep took 0.98 + 0.30 (traced benchmark runs).
#include <cuda_bf16.h>

#include "landmark_common.cuh"

namespace {

constexpr int BM = 32;        // ions per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 64;     // f32 form: site columns in flight
constexpr int RM = BM / (THREADS / LANES);  // f32 form: ions a thread
constexpr int RW = BM / WARPS;              // whole rows: ions a warp

size_t lv_tile_smem(int UP, int s_tile, int vmax) {
  return sizeof(float) * ((size_t)BM * UP + 3 * BM + 3 * (size_t)UP) +
         (sizeof(int) + sizeof(float)) * (size_t)s_tile * vmax;
}

// ROWS picks the form; R2 and PRE are the cutoff shape and the preshift
// route.
template <bool ROWS, bool R2, bool PRE>
__global__ void __launch_bounds__(THREADS, 4) lv_tile_kernel(
    const float* __restrict__ mob,      // (B, 3, MP)
    const float* __restrict__ vpu,      // (B, n_st, 3, UP)
    const int* __restrict__ midx,       // (n_st, s_tile, vmax)
    const float* __restrict__ mmul,     // (n_st, s_tile, vmax)
    const float* __restrict__ kill,     // (n_st * s_tile)
    const float* __restrict__ anchors,  // (n_st, 3)
    const int* __restrict__ col_map,    // f32: (n_st * s_tile)
    float* __restrict__ out,            // f32: (B, M_out, out_cols)
    __nv_bfloat16* __restrict__ outb,   // rows: (B * MP, n_st * s_tile)
    float* __restrict__ inv_norm,       // rows: (B * MP)
    int MP, int M_out, int n_st, int UP, int s_tile, int vmax, int out_cols,
    CellParams P) {
  const int row0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  extern __shared__ float sm[];
  __shared__ int warp_used[WARPS];  // per warp: 1 + the largest atom index
  float* logc = sm;                      // (BM, UP)
  float* sx = logc + BM * UP;
  float* sy = sx + BM;
  float* sz = sy + BM;
  float* ux = sz + BM;
  float* uy = ux + UP;
  float* uz = uy + UP;
  int* sidx = reinterpret_cast<int*>(uz + UP);     // (vmax, s_tile)
  float* smul = reinterpret_cast<float*>(sidx + (size_t)vmax * s_tile);

  float x0 = 0.0f, y0 = 0.0f, z0 = 0.0f;  // ion tid's position (tid < BM)
  if (tid < BM) {
    const float* mb = mob + (size_t)b * 3 * MP;
    const int m = row0 + tid;
    x0 = mb[m];
    y0 = mb[MP + m];
    z0 = mb[2 * MP + m];
  }
  float n2[RW];  // whole rows: lane's share of each of its ions' norm²
#pragma unroll
  for (int i = 0; i < RW; ++i) n2[i] = 0.0f;

  const int t_end = ROWS ? n_st : blockIdx.x + 1;
  for (int t = ROWS ? 0 : blockIdx.x; t < t_end; ++t) {
    if (tid < BM) {
      float x = x0, y = y0, z = z0;
      tile_ion_position(x, y, z, anchors, t, P, PRE);
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
    if (lane == 0) warp_used[tid / 32] = used;
    __syncthreads();
    int nu = 0;  // 0 only on a tile without sites
#pragma unroll
    for (int w = 0; w < WARPS; ++w) nu = max(nu, warp_used[w]);
    for (int k = tid; k < nu; k += THREADS) {
      const float ax = ux[k], ay = uy[k], az = uz[k];
#pragma unroll 4
      for (int r = 0; r < BM; ++r)
        logc[r * UP + k] = unique_atom_log_factor(sx[r], sy[r], sz[r], ax,
                                                  ay, az, P, R2, PRE);
    }
    __syncthreads();

    const float* kl = kill + (size_t)t * s_tile;
    if (ROWS) {
      const int r0 = (tid / 32) * RW;
      const size_t SP = (size_t)n_st * s_tile;
      __nv_bfloat16* ob =
          outb + ((size_t)b * MP + row0 + r0) * SP + (size_t)t * s_tile;
      for (int c = lane; c < s_tile; c += 32) {
        float acc[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i) acc[i] = 0.0f;
        membership_sparse<RW>(acc, logc, UP, r0, sidx + c, smul + c, s_tile,
                              vmax);
        const float kc = kl[c];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float lv = lv_value(acc[i], kc);
          n2[i] = fmaf(lv, lv, n2[i]);
          ob[i * SP + c] = __float2bfloat16_rn(lv);
        }
      }
      __syncthreads();  // the next tile overwrites the lists and logc
    } else {
      const int r0 = (tid / LANES) * RM;
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
            out[((size_t)b * M_out + m) * out_cols + oc] =
                lv_value(acc[i], kc);
        }
      }
    }
  }
  if (ROWS) {
    const int r0 = (tid / 32) * RW;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
#pragma unroll
      for (int off = 16; off; off >>= 1)
        n2[i] += __shfl_xor_sync(0xffffffffu, n2[i], off);
      if (lane == 0)
        inv_norm[(size_t)b * MP + row0 + r0 + i] =
            rsqrtf(fmaxf(n2[i], 1e-24f));
    }
  }
}

template <bool ROWS, bool R2, bool PRE>
int launch(const dim3& grid, size_t smem, cudaStream_t s, const float* mob,
           const float* vpu, const int* midx, const float* mmul,
           const float* kill, const float* anchors, const int* col_map,
           float* out, __nv_bfloat16* outb, float* inv_norm, int MP,
           int M_out, int n_st, int UP, int s_tile, int vmax, int out_cols,
           const CellParams& P) {
  cudaError_t err = cudaFuncSetAttribute(
      lv_tile_kernel<ROWS, R2, PRE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  lv_tile_kernel<ROWS, R2, PRE><<<grid, THREADS, smem, s>>>(
      mob, vpu, midx, mmul, kill, anchors, col_map, out, outb, inv_norm, MP,
      M_out, n_st, UP, s_tile, vmax, out_cols, P);
  return (int)cudaGetLastError();
}

// The instance of the form ROWS for the cutoff shape and the preshift route.
template <bool ROWS, typename... Args>
int launch_form(int r2, int preshift, Args... args) {
  if (r2)
    return preshift ? launch<ROWS, true, true>(args...)
                    : launch<ROWS, true, false>(args...);
  return preshift ? launch<ROWS, false, true>(args...)
                  : launch<ROWS, false, false>(args...);
}

}  // namespace

// With lvb (bf16 (B * MP, n_st * s_tile)) the whole-row form: every row's
// bf16 copy and inv_norm (B * MP); col_map, out, M_out and out_cols are not
// read.  Else the f32 form into out (B, M_out, out_cols) through col_map.
extern "C" int sit_lv_tile(const float* mob, const float* vpu,
                           const int* midx, const float* mmul,
                           const float* kill, const float* anchors,
                           const int* col_map, float* out, void* lvb,
                           float* inv_norm, int B, int MP, int M_out,
                           int n_st, int UP, int s_tile, int vmax,
                           int out_cols, const float* params, int triclinic,
                           int r2, int preshift, void* stream) {
  const CellParams P = load_cell_params(params, triclinic);
  const size_t smem = lv_tile_smem(UP, s_tile, vmax);
  cudaStream_t s = (cudaStream_t)stream;
  if (!lvb)
    return launch_form<false>(r2, preshift, dim3(n_st, MP / BM, B), smem, s,
                              mob, vpu, midx, mmul, kill, anchors, col_map,
                              out, (__nv_bfloat16*)nullptr, (float*)nullptr,
                              MP, M_out, n_st, UP, s_tile, vmax, out_cols, P);
  return launch_form<true>(r2, preshift, dim3(1, MP / BM, B), smem, s, mob,
                           vpu, midx, mmul, kill, anchors, (const int*)nullptr,
                           (float*)nullptr,
                           static_cast<__nv_bfloat16*>(lvb), inv_norm, MP,
                           MP, n_st, UP, s_tile, vmax, n_st * s_tile, P);
}

extern "C" const char* sit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
