// K1s with bf16 similarity operands: the skewed, fused unique-atom assign
// kernel on the tensor cores, the landmark vectors kept on chip.
//
// Replaces sitator_tpu/ops/landmark_mxu.py::_kernel_skew (peak_evening =
// 'none', mxu_bf16=True).  It computes what K1 computes (lv_tile.cu, then
// row_prep + sims_wgmma.cu + argmax_merge): per (frame, ion) row the lv of
// every kd site tile (the shared core of landmark_common.cuh), the norm,
// sims = bf16(lv) @ bf16(centres) with f32 accumulation, sims * rsqrt(max(
// norm², 1e-24)), the arg-max over the KP padded centre columns with the
// lowest index winning a tie, and the threshold (label -1 below it).  The
// f32 route (mxu_bf16=False) is assign_skew.cu: wgmma has no full-f32 mode.
//
// What bounds it on an H100: the similarity product, 2 * rows * SP * KP
// flop (470 GFLOP per 32-frame bench block, 0.48 ms at the 989 TFLOP/s
// bf16 peak), and the lv work K1's lv_tile does (one log-sigmoid per (ion,
// unique atom) of each tile, an exp and the membership sum per (ion,
// site)).  The lv never goes to device memory: K1 writes and reads back
// 0.92 GB of it per block, and the FMA form of this kernel (assign_skew.cu,
// now the f32 route) ran the product on the f32 FMA pipes (24 ms a block).
// Measured (chip_smoke.py, tools/kernel_variants.py; H100): about 7 ms a
// bench block, bound by its producers: 8 warps an SM (lv_tile runs 32)
// spend about half the time on the pair phase and a third on the lv
// elements, latency-bound in every part; the consumer's wgmma takes about
// a sixth.
//
// The design problem: the TPU kernel keeps a (MP x KP) f32 accumulator in
// VMEM (3 MB at the bench shape).  One wgmma accumulator of 64 rows x 256
// centres is 128 registers a thread of a warpgroup, so a CTA cannot hold a
// row tile's whole KP; computing the lv again for every 256-column block
// would repeat the lv work KP / 256 times.  So a thread-block cluster of
// NC CTAs (NC = the power of two >= KP / 256, at most 8) shares one 64-row
// tile of one frame, each CTA owning 256 centre columns:
//   - warpgroup 0 of each CTA is the consumer: wgmma.m64n256k16 over the
//     4 k-steps of each 64-site stage, in ascending site order, from a
//     shared-memory ring (bf16 lv tile 64 x 64 and the CTA's centres 256 x
//     64, both K-major in the 128-byte swizzle); the centres come by TMA
//     from the K-major bf16 copy (rows past KP read as zeros and are masked);
//   - warpgroups 1 and 2 (8 warps) are the lv producers.  The cluster's 64
//     rows are split across its CTAs, 64 / NC rows each, so every (ion,
//     unique atom) log-sigmoid and every lv element is computed once per
//     cluster.  Per kd tile a CTA has the tile's membership lists
//     (landmark_mxu.membership_lists) and unique atoms in shared memory
//     (cp.async brings the next tile's while this one's stages run) and
//     computes its rows' log cutoffs;
//     per stage each producer thread sums two columns of its rows over
//     their lists in one loop (each sum in membership_sparse's order, so
//     bit-identical to lv_tile's), applies the exp and the pad-kill and
//     stores the bf16 values into its own CTA's ring slot at the swizzled
//     offset.  The CTA's rows are one contiguous 64/NC x 128-byte slice of
//     the slot, so after a producer barrier one thread sends the slice to
//     every peer with the bulk-copy engine (cp.async.bulk shared::cta ->
//     shared::cluster), which signals its bytes to the peer's full barrier.
//     (Storing each bf16 value into every CTA with st.shared::cluster and
//     arriving on every CTA's barrier from each producer thread, this
//     kernel's first form, took 13.5 ms a bench block);
//   - the consumer keeps one wgmma group in flight and releases the slot
//     before it from NC threads at once (one remote arrive each);
//   - handover by mbarriers: a slot's full barrier in each CTA takes one
//     arrival, its own producers' (after fence.proxy.async and the
//     producer barrier), which expects the TMA's centre bytes and the
//     peers' slices; its empty barrier in each CTA counts one arrival
//     (release, cluster scope) from each CTA's consumer, and the producers
//     wait on it with acquire at cluster scope;
//   - the norm: the producer thread that owns a row owns columns = lane
//     mod 32 in ascending order, so fmaf(x, x, n2) then an xor-shuffle is
//     row_prep's order exactly; the owner stores inv_norm into every CTA;
//   - the epilogue: each CTA's consumer takes its rows' max and first
//     arg-max over its 256 columns (sims_wgmma's epilogue) and stores them
//     into CTA 0, which merges them in column (rank) order with a strict >,
//     as argmax_merge does, and applies the threshold.  More than 8 x 256
//     columns run as several launches of 8-CTA clusters (passes); the
//     running (value, index) is carried across passes in device memory and
//     a later pass wins only with a strictly larger value.
// The k-steps, the bf16 operands, inv_norm and the merge are K1's, so K1s
// computes K1's labels and confidences bit for bit when the hardware sums a
// wgmma the same way in both kernels (chip_smoke.py checks it).
#include <cuda_bf16.h>

#include "hopper_common.cuh"
#include "landmark_common.cuh"

namespace {

using namespace hopper;

constexpr int TM = 64;               // rows per cluster tile (wgmma M)
constexpr int TN = 256;              // centre columns per CTA (wgmma N)

// Warpgroup 0 consumes, warpgroups 1 and 2 produce.  (Sixteen producer
// warps do not fit: 640 threads leave 96 registers a thread at compile time,
// and the consumer's wgmma needs its 128-register accumulator live.)
constexpr int PRODUCERS = 256;
constexpr int THREADS = 128 + PRODUCERS;
constexpr int A_BYTES = TM * TBK * 2;   // 8 KB
constexpr int B_BYTES = TN * TBK * 2;   // 32 KB
constexpr int BAR_PRODUCER = 1;         // named barrier of the producers

// Byte offsets of the dynamic shared memory (after 1024-byte alignment);
// the same on host and device, and in every CTA, so that mapa finds a
// peer's copy of a buffer at the same offset.
struct Layout {
  int a, b, full, empty, inv, mval, midx, ion, atoms, logc, lidx, lmul, end;
};

__host__ __device__ inline Layout layout(int stages, int nc, int UP,
                                         int s_tile, int vmax) {
  const int rc = TM / nc;
  Layout L;
  L.a = 0;
  L.b = L.a + stages * A_BYTES;
  L.full = L.b + stages * B_BYTES;
  L.empty = L.full + 8 * stages;
  L.inv = L.empty + 8 * stages;
  L.mval = L.inv + 4 * TM;
  L.midx = L.mval + 4 * nc * TM;
  L.ion = L.midx + 4 * nc * TM;
  L.atoms = L.ion + 4 * 3 * rc;
  L.logc = L.atoms + 4 * 3 * UP;
  L.lidx = L.logc + 4 * rc * UP;
  L.lmul = L.lidx + 8 * s_tile * vmax;   // two buffers each
  L.end = L.lmul + 8 * s_tile * vmax;
  return L;
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync %0, %1;" ::"r"(BAR_PRODUCER), "r"(PRODUCERS)
               : "memory");
}

template <int NC>
__global__ void __launch_bounds__(THREADS, 1) assign_skew_wgmma_kernel(
    const __grid_constant__ CUtensorMap ctr_map,  // bf16 (KP, SP)
    const float* __restrict__ mob,                // (B, 3, MP)
    const float* __restrict__ vpu,                // (B, n_st, 3, UP)
    const int* __restrict__ gidx,                 // (n_st, s_tile, vmax)
    const float* __restrict__ gmul,               // (n_st, s_tile, vmax)
    const float* __restrict__ kill,               // (n_st * s_tile)
    const float* __restrict__ anchors,            // (n_st, 3)
    const int* __restrict__ tile_nu,              // (n_st)
    int* __restrict__ labels,                     // (B * MP)
    float* __restrict__ confs,                    // (B * MP)
    float* __restrict__ run_val,                  // (B * MP), passes > 1
    int* __restrict__ run_idx,                    // (B * MP), passes > 1
    int MP, int n_st, int UP, int s_tile, int vmax, int KP, int col_base,
    int first, int last, int stages, CellParams P, int r2, int preshift) {
  constexpr int RC = TM / NC;   // rows this CTA produces
  constexpr int RPW = RC / 8;   // rows per producer warp
  constexpr int SLICE_BYTES = RC * TBK * 2;  // this CTA's rows of a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = layout(stages, NC, UP, s_tile, vmax);
  uint8_t* sA = base + L.a;
  uint8_t* sB = base + L.b;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(base + L.empty);
  float* sinv = reinterpret_cast<float*>(base + L.inv);
  float* mval = reinterpret_cast<float*>(base + L.mval);
  int* midx = reinterpret_cast<int*>(base + L.midx);

  const int rank = (int)cluster_rank();
  const int row0 = blockIdx.y * TM;   // first global row of the tile
  const int b = row0 / MP, m0 = row0 % MP;
  const int n_kt = n_st * s_tile / TBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);   // the local producers' arrival
      mbar_init(&empty[s], NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();   // every peer's barriers exist before any remote arrive

  if (tid >= 128) {
    // ---- producers: this CTA's RC rows of every lv stage, into every
    //      CTA's ring ----------------------------------------------------
    const int p = tid - 128;
    const int pw = p / 32, lane = p % 32;
    const int r_loc = pw * RPW;          // first of this warp's rows
    float* sx = reinterpret_cast<float*>(base + L.ion);
    float* sy = sx + RC;
    float* sz = sy + RC;
    float* ux = reinterpret_cast<float*>(base + L.atoms);
    float* uy = ux + UP;
    float* uz = uy + UP;
    float* logc = reinterpret_cast<float*>(base + L.logc);
    int* sidx = reinterpret_cast<int*>(base + L.lidx);
    float* smul = reinterpret_cast<float*>(base + L.lmul);
    const int cpt = s_tile / TBK;        // stages per kd tile
    float n2[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) n2[i] = 0.0f;
    // the CTA's ions (the same rows in every tile)
    float ion_x = 0.0f, ion_y = 0.0f, ion_z = 0.0f;
    if (p < RC) {
      const float* mb = mob + (size_t)b * 3 * MP + m0 + rank * RC + p;
      ion_x = mb[0];
      ion_y = mb[MP];
      ion_z = mb[2 * MP];
    }
    // tile t's unique-atom coordinates and membership lists (transposed to
    // one row of s_tile columns per list entry) land in shared memory by
    // cp.async while the previous tile's stages run: the atoms into one
    // buffer (read only by the pair phase, which has finished), the lists
    // into the buffer of t's parity
    auto prefetch = [&](int t) {
      const float* vp = vpu + ((size_t)b * n_st + t) * 3 * UP;
      for (int k = p; k < 3 * UP; k += PRODUCERS) cp_async4(ux + k, vp + k);
      const int* gi = gidx + (size_t)t * s_tile * vmax;
      const float* gm = gmul + (size_t)t * s_tile * vmax;
      const int lb = (t & 1) * s_tile * vmax;
      for (int e = p; e < s_tile * vmax; e += PRODUCERS) {
        const int c = e / vmax, j = e % vmax;   // coalesced global reads
        cp_async4(sidx + lb + j * s_tile + c, gi + e);
        cp_async4(smul + lb + j * s_tile + c, gm + e);
      }
      cp_async_commit();
    };
    prefetch(0);
    // the next tile's atom count and anchor, loaded a tile ahead
    int nu_next = tile_nu[0];
    float ax = 0.0f, ay = 0.0f, az = 0.0f;
    if (preshift && p < RC) {
      ax = anchors[0];
      ay = anchors[1];
      az = anchors[2];
    }
    int g = 0;
    for (int t = 0; t < n_st; ++t) {
      if (p < RC) {   // sx is read only by the pair phase, long finished
        float x = ion_x, y = ion_y, z = ion_z;
        if (preshift) tile_ion_position_at(x, y, z, ax, ay, az, P);
        sx[p] = x;
        sy[p] = y;
        sz[p] = z;
      }
      const int nu = nu_next;   // atoms the lists use; 0: no sites
      if (t + 1 < n_st) {
        nu_next = tile_nu[t + 1];
        if (preshift && p < RC) {
          ax = anchors[3 * (t + 1)];
          ay = anchors[3 * (t + 1) + 1];
          az = anchors[3 * (t + 1) + 2];
        }
      }
      cp_async_wait_all();
      producer_sync();   // tile t's atoms, lists and ions are in place
      // the tile's (row, atom) log cutoffs (the pair index advances
      // without a division, as in lv_tile)
      for (int r = nu ? p / nu : RC, k = nu ? p % nu : 0; r < RC;) {
        logc[r * UP + k] = unique_atom_log_factor(
            sx[r], sy[r], sz[r], ux[k], uy[k], uz[k], P, r2, preshift);
        k += PRODUCERS;
        while (k >= nu) {
          k -= nu;
          ++r;
        }
      }
      producer_sync();   // logc is complete; the atoms are free
      if (t + 1 < n_st) prefetch(t + 1);

      const float* kl = kill + (size_t)t * s_tile;
      const int* tidx = sidx + (t & 1) * s_tile * vmax;
      const float* tmul = smul + (t & 1) * s_tile * vmax;
      for (int cs = 0; cs < cpt; ++cs, ++g) {
        const int slot = g % stages;
        if (g >= stages)
          mbar_wait_cluster(&empty[slot], ((g / stages) - 1) & 1);
        // columns lane and lane + 32 of the stage, both lists summed in one
        // loop (each column's own sum in ascending list order, as
        // membership_sparse sums it; a list's padding is -1 to its end)
        const int c0 = cs * TBK + lane, c1 = c0 + 32;
        float a0[RPW], a1[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i) a0[i] = a1[i] = 0.0f;
#pragma unroll 4
        for (int j = 0; j < vmax; ++j) {   // no early exit: the loads of
          const int k0 = tidx[j * s_tile + c0];   // later entries overlap
          const int k1 = tidx[j * s_tile + c1];
          const float w0 = tmul[j * s_tile + c0], w1 = tmul[j * s_tile + c1];
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            if (k0 >= 0) a0[i] = fmaf(logc[(r_loc + i) * UP + k0], w0, a0[i]);
            if (k1 >= 0) a1[i] = fmaf(logc[(r_loc + i) * UP + k1], w1, a1[i]);
          }
        }
        const float kv0 = kl[c0], kv1 = kl[c1];
        uint8_t* slot_a = sA + slot * A_BYTES;
#pragma unroll
        for (int i = 0; i < RPW; ++i) {   // columns ascend: the norm's order
          const int row = rank * RC + r_loc + i;
          const float x0 = lv_value(a0[i], kv0), x1 = lv_value(a1[i], kv1);
          n2[i] = fmaf(x0, x0, n2[i]);
          n2[i] = fmaf(x1, x1, n2[i]);
          *reinterpret_cast<__nv_bfloat16*>(
              slot_a + swizzle128_offset(row, lane)) = __float2bfloat16_rn(x0);
          *reinterpret_cast<__nv_bfloat16*>(
              slot_a + swizzle128_offset(row, lane + 32)) =
              __float2bfloat16_rn(x1);
        }
        fence_proxy_async();   // the slice, to wgmma and the bulk copies
        producer_sync();
        if (p == 0) {
          // this CTA's RC rows are one contiguous slice of the swizzled
          // slot (the swizzle moves chunks within a row): the bulk-copy
          // engine sends it to every peer, signalling the bytes to the
          // peer's full barrier; the local arrival expects the centres
          // and the peers' slices
          mbar_expect_tx(&full[slot], B_BYTES + (NC - 1) * SLICE_BYTES);
          tma_load_2d(sB + slot * B_BYTES, &ctr_map, g * TBK,
                      col_base + rank * TN, &full[slot]);
          const uint8_t* slice = slot_a + rank * SLICE_BYTES;
          const uint32_t dst = smem_u32(slice);
          const uint32_t fb = smem_u32(&full[slot]);
#pragma unroll
          for (int q = 1; q < NC; ++q) {
            const uint32_t peer = (rank + q) % NC;
            bulk_copy_cluster(cluster_addr(dst, peer), slice, SLICE_BYTES,
                              cluster_addr(fb, peer));
          }
        }
      }
    }
    // inv_norm of this warp's rows, row_prep's reduction, into every CTA
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
#pragma unroll
      for (int off = 16; off; off >>= 1)
        n2[i] += __shfl_xor_sync(0xffffffffu, n2[i], off);
      if (lane == 0) {
        const float inv = rsqrtf(fmaxf(n2[i], 1e-24f));
        const uint32_t at = smem_u32(&sinv[rank * RC + r_loc + i]);
#pragma unroll
        for (int q = 0; q < NC; ++q) st_cluster_f32(cluster_addr(at, q), inv);
      }
    }
    cluster_sync();   // 1: inv_norm everywhere
    cluster_sync();   // 2: every CTA's partial arg-max is in CTA 0
    if (rank == 0 && p < TM) {
      float v = mval[p];
      int ix = midx[p];
      for (int q = 1; q < NC; ++q) {     // ranks ascend with the columns:
        if (mval[q * TM + p] > v) {      // strict > keeps the lowest index
          v = mval[q * TM + p];
          ix = midx[q * TM + p];
        }
      }
      const size_t row = (size_t)row0 + p;
      if (!first && !(v > run_val[row])) {   // earlier passes: lower
        v = run_val[row];                    // columns
        ix = run_idx[row];
      }
      if (last) {
        confs[row] = v;
        labels[row] = v >= P.thr ? ix : -1;
      } else {
        run_val[row] = v;
        run_idx[row] = ix;
      }
    }
    return;
  }

  // ---- consumer warpgroup: the product on the tensor cores --------------
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  // one wgmma group stays in flight: stage g's group is issued before
  // stage g - 1's slot is released, and threads 0 .. NC-1 release it in
  // every CTA at once (a remote arrive is a round trip through the
  // cluster)
  for (int g = 0; g < n_kt; ++g) {
    const int slot = g % stages;
    mbar_wait_cluster(&full[slot], (g / stages) & 1);
    const __nv_bfloat16* a =
        reinterpret_cast<const __nv_bfloat16*>(sA + slot * A_BYTES);
    const __nv_bfloat16* bb =
        reinterpret_cast<const __nv_bfloat16*>(sB + slot * B_BYTES);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk)
      wgmma_m64n256k16(d, smem_desc(a + kk * 16), smem_desc(bb + kk * 16));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (g > 0 && tid < NC)
      mbar_arrive_cluster(
          cluster_addr(smem_u32(&empty[(g - 1) % stages]), tid));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  cluster_sync();   // 1
  const int lane = tid % 32;
  const int rbase = (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rbase + 8 * h;
    float best;
    int bi;
    tile_argmax(d, h, sinv[r], col_base + rank * TN, KP, best, bi);
    if (lane % 4 == 0) {
      st_cluster_f32(cluster_addr(smem_u32(&mval[rank * TM + r]), 0), best);
      st_cluster_s32(cluster_addr(smem_u32(&midx[rank * TM + r]), 0), bi);
    }
  }
  cluster_sync();   // 2
}

constexpr int SMEM_LIMIT = 232448;  // an H100 block's shared memory

// The ring depth that fits: 4 stages where they fit, at least 2.
int pick_stages(int nc, int UP, int s_tile, int vmax, int* smem) {
  for (int st = 4; st >= 2; --st) {
    const int bytes = 1024 + layout(st, nc, UP, s_tile, vmax).end;
    if (bytes <= SMEM_LIMIT) {
      *smem = bytes;
      return st;
    }
  }
  return 0;
}

template <int NC>
cudaLaunchConfig_t cluster_config(dim3 grid, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NC>
int launch(const CUtensorMap& map, const float* mob, const float* vpu,
           const int* gidx, const float* gmul, const float* kill,
           const float* anchors, const int* tile_nu, int* labels,
           float* confs, float* run_val, int* run_idx, int B, int MP,
           int n_st, int UP, int s_tile,
           int vmax, int KP, const CellParams& P, int r2, int preshift,
           cudaStream_t stream) {
  int smem = 0;
  const int stages = pick_stages(NC, UP, s_tile, vmax, &smem);
  if (!stages) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      assign_skew_wgmma_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int cols = NC * TN;
  const int passes = (KP + cols - 1) / cols;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config<NC>(dim3(NC, B * MP / TM), smem, stream, attr);
  for (int pass = 0; pass < passes; ++pass) {
    err = cudaLaunchKernelEx(&cfg, assign_skew_wgmma_kernel<NC>, map, mob,
                             vpu, gidx, gmul, kill, anchors, tile_nu, labels,
                             confs, run_val, run_idx, MP, n_st, UP, s_tile,
                             vmax, KP,
                             pass * cols, (int)(pass == 0),
                             (int)(pass == passes - 1), stages, P, r2,
                             preshift);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <int NC>
int occupancy(int UP, int s_tile, int vmax, int* stages, int* smem,
              int* clusters) {
  *stages = pick_stages(NC, UP, s_tile, vmax, smem);
  if (!*stages) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      assign_skew_wgmma_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config<NC>(dim3(NC, 1), *smem, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, assign_skew_wgmma_kernel<NC>, &cfg);
}

}  // namespace

// ctr: the centres' bf16 K-major copy (KP, SP), KP % 128 == 0; nc (1, 2, 4
// or 8) CTAs a cluster, each with 256 columns, KP / (256 nc) passes rounded
// up; run_val / run_idx (B * MP) carry the arg-max between passes.
// MP % 64 == 0, s_tile % 64 == 0, midx / mmul from membership_lists and
// tile_nu (n_st) one more than the largest atom index each tile's lists
// use (the wrapper checks and computes).
extern "C" int sit_assign_skew_wgmma(
    const float* mob, const float* vpu, const int* midx, const float* mmul,
    const float* kill, const float* anchors, const int* tile_nu,
    const void* ctr, int* labels, float* confs, float* run_val, int* run_idx,
    int B, int MP, int n_st, int UP, int s_tile, int vmax, int KP, int nc,
    const float* params, int triclinic, int r2, int preshift, void* stream) {
  const CellParams P = load_cell_params(params, triclinic);
  CUtensorMap map;
  const int err = make_map(&map, ctr, KP, n_st * s_tile, TN);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
#define SKEW_LAUNCH(N)                                                      \
  return launch<N>(map, mob, vpu, midx, mmul, kill, anchors, tile_nu,      \
                   labels, confs, run_val, run_idx, B, MP, n_st, UP, s_tile, \
                   vmax, KP, P, r2, preshift, s)
  switch (nc) {
    case 1: SKEW_LAUNCH(1);
    case 2: SKEW_LAUNCH(2);
    case 4: SKEW_LAUNCH(4);
    case 8: SKEW_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SKEW_LAUNCH
}

// The launch shape for nc CTAs a cluster: the ring depth, the dynamic shared
// memory of a CTA and cudaOccupancyMaxActiveClusters.
extern "C" int sit_assign_skew_wgmma_occupancy(int nc, int UP, int s_tile,
                                               int vmax, int* stages,
                                               int* smem, int* clusters) {
  switch (nc) {
    case 1: return occupancy<1>(UP, s_tile, vmax, stages, smem, clusters);
    case 2: return occupancy<2>(UP, s_tile, vmax, stages, smem, clusters);
    case 4: return occupancy<4>(UP, s_tile, vmax, stages, smem, clusters);
    case 8: return occupancy<8>(UP, s_tile, vmax, stages, smem, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}
