// Carried jump scan of one block of site labels, tallied into the caller's
// int64 jump statistics.
//
// Replaces no Pallas kernel: it is the hot-path form of the reference's
// lax.scan over frames (sitator_tpu/ops/jumps.py::_jump_stats, :99).  Its
// plain version (ops/jumps.py::_jump_scan) walks the frames in a Python loop
// of about twenty small PyTorch operations a frame and then tallies with
// index_put_(accumulate=True), which on a card sorts every (frame, ion) entry
// and sums each run of equal indices serially; every non-event goes to one
// dummy slot, so nearly all of a block's entries land in one run.
//
// Each ion's carry (last known site, residence so far) depends on that ion's
// labels alone, so one thread an ion walks the block's frames in order with
// the carry in registers.  The transitions are _jump_scan's: a known label
// after a different known site is a jump, closing a residence of `res`
// frames, and restarts res at 1; the same site adds 1; a first known label
// starts res at 1; an unknown label (-1) keeps the carry ('persist') or
// clears it ('break').  At a jump the thread adds 1 to n_ij[last, s], res to
// lag_sum[last, s] and res_sum[last], and 1 to res_cnt[last], by 64-bit
// integer atomics straight into the caller's int64 accumulators: integer
// sums commute, so the tallies are exact in any order.  Non-events write
// nothing.  The new carry goes to the caller's fresh arrays; the input carry
// is left as it was (the streaming engine keeps it for a rollback).
//
// What bounds it on an H100: the labels, 4 bytes a (frame, ion) read once
// (3.0 MB for a 1024 x 739 block, 0.9 us at 3.35 TB/s), and the carry; the
// jumps' atomics are a few thousand a block.  With one thread an ion a block
// has only a few hundred threads, so the walk is bound by the latency of its
// loads: each thread loads the next FRAMES labels of its ion while it scans
// the current ones, and each block is one warp, so the ions' warps spread
// over the SMs.  A frame's labels for neighbouring ions are neighbours, so a
// warp's loads coalesce.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;  // one warp a block
constexpr int FRAMES = 32;   // labels an ion holds in registers ahead

typedef unsigned long long u64;

__device__ __forceinline__ void load_frames(const int* __restrict__ col,
                                            int ld, int f0, int F,
                                            int (&s)[FRAMES]) {
#pragma unroll
  for (int u = 0; u < FRAMES; ++u)
    s[u] = f0 + u < F ? __ldg(col + (long long)(f0 + u) * ld) : -1;
}

__global__ void __launch_bounds__(THREADS)
    jump_fold_kernel(const int* __restrict__ labels, int F, int M, int ld,
                     const long long* __restrict__ last_in,
                     const long long* __restrict__ res_in,
                     long long* __restrict__ last_out,
                     long long* __restrict__ res_out, u64* __restrict__ n_ij,
                     u64* __restrict__ lag_sum, u64* __restrict__ res_sum,
                     u64* __restrict__ res_cnt, int S, int brk) {
  const int m = blockIdx.x * THREADS + threadIdx.x;
  if (m >= M) return;
  long long last = last_in[m];
  long long res = res_in[m];
  const int* col = labels + m;
  int cur[FRAMES], nxt[FRAMES];
  load_frames(col, ld, 0, F, cur);
  for (int f0 = 0; f0 < F; f0 += FRAMES) {
    load_frames(col, ld, f0 + FRAMES, F, nxt);
    const int n = min(FRAMES, F - f0);
#pragma unroll
    for (int u = 0; u < FRAMES; ++u) {
      if (u >= n) break;
      const int s = cur[u];
      if (s >= 0) {
        if (last >= 0 && s != last) {
          if (last < S && s < S) {  // labels lie in [-1, S); no stray write
            const long long ij = last * S + s;
            atomicAdd(n_ij + ij, 1ull);
            atomicAdd(lag_sum + ij, (u64)res);
            atomicAdd(res_sum + last, (u64)res);
            atomicAdd(res_cnt + last, 1ull);
          }
          res = 1;
        } else {
          res = last >= 0 ? res + 1 : 1;
        }
        last = s;
      } else if (brk) {
        last = -1;
        res = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < FRAMES; ++u) cur[u] = nxt[u];
  }
  last_out[m] = last;
  res_out[m] = res;
}

}  // namespace

// labels (F, M) int32 with row stride ld (elements); the carry and the new
// carry (M,) int64; n_ij, lag_sum (S, S) and res_sum, res_cnt (S,) int64,
// added to in place.  brk: unknown_policy 'break' (else 'persist').
extern "C" int sit_jump_fold(const int* labels, int F, int M, int ld,
                             const long long* last_in, const long long* res_in,
                             long long* last_out, long long* res_out,
                             long long* n_ij, long long* lag_sum,
                             long long* res_sum, long long* res_cnt, int S,
                             int brk, void* stream) {
  if (M == 0) return 0;
  jump_fold_kernel<<<(M + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(
      labels, F, M, ld, last_in, res_in, last_out, res_out,
      reinterpret_cast<u64*>(n_ij), reinterpret_cast<u64*>(lag_sum),
      reinterpret_cast<u64*>(res_sum), reinterpret_cast<u64*>(res_cnt), S,
      brk);
  return (int)cudaGetLastError();
}
