// fork_levels: the fork pipeline's two level scans, one launch each, for
// Hopper (sm_90a).
//
// Replaces the host loops over the schedule rows in
// babble_tpu_torch/ops/forks.py (level_scan_plain, which stays as the
// plain twin): the port of the JAX package's two lax.scans over the
// level schedule, babble_tpu/ops/forks.py:476 _la_scan and :536
// _fd_reverse, each of which XLA compiles into one device loop.  No TPU
// kernel stands behind them.  Both are one recurrence over the rows of
// the schedule sched[T, Bt] (event slots by level, -1 pads), on a table
// [E+1, C] int32 that the caller has seeded with each event's own row:
//
//   la (forward, rows 0 .. T-1), for each slot x of the row:
//       la[x, c] = max(la[x, c], la[sp(x), c], la[op(x), c])
//   fd (reverse, rows T-1 .. 0), for each slot y of the row:
//       fd[sp(y), c] = min(fd[sp(y), c], fd[y, c]),  the same for op(y)
//
// A pad lane (-1 in sched) and a missing parent (-1 in sp, op) do
// nothing; the host loop sent them to the sentinel row E, which the
// caller resets (set_sentinel) either way.  max and min are order-free,
// so the result is the host loop's bit for bit.  The schedule is by
// level: no slot of a row is a parent of another slot of the same row,
// so a row's reads never race its writes.
//
// Bounds.  At the byzantine cell (E+1 = 131,073 rows, C = 2,048 branch
// columns, T = 3,315 rows of Bt = 32, 100,000 events) the table goes in
// once and out once: 2 x 131,073 x 8 KiB = 2.15 GB, 0.64 ms at 3.35
// TB/s (each step also reads two parent rows, from L2).  But it is a chain
// of T dependent steps: a row reads what the rows before it wrote, so
// each step is at least one load from L2 (its parents were written a
// few rows back) and one block barrier.  At the cell's 3,315 rows that
// took 2.13 ms for la and 1.84 ms for fd on the H100 (0.64 and 0.55 us
// a row): the latency, not the bytes, is the bound.
//
// Design.  The columns are independent: row x's column c reads only
// column c of its parents' rows.  So a block owns a tile of TC
// consecutive columns and walks all T rows in order, with no dependence
// between blocks and no grid-wide sync.  A column of 131,073 rows does
// not fit shared memory (la_walk's layout), so the table stays in
// device memory, read and written through L2 (__ldcg, __stcg: the data
// changes under the kernel, so nothing is read through L1 or the
// read-only path).  Thread (x, y) of the block (TC x SY) takes column
// x of the tile and the lanes y, y + SY, ... of a row: a warp reads
// whole TC x 4-byte row segments, and TC = 16 makes a segment 64 bytes
// and 128 blocks at C = 2,048, about one per SM.  One __syncthreads
// ends each row; the rows a step reads were written by the same block
// at earlier steps, so the barrier orders them.  fd's children of one
// row may share a parent, so fd writes by atomicMin (a RED: nothing
// waits for it); la writes its own row only, and only where it grew.
//
// Staging.  The (slot, sp, op) triples of up to kStage lanes (a whole
// number of rows, or a part of one wider row) are read into shared
// memory between two barriers, so a step reads its indices from shared
// memory and only its table cells from L2.  While staging, each triple's
// own row segment is prefetched into L2 (its seed was written before
// the launch and is likely in device memory, not L2).  Parents are
// rows written a few steps back: L2 holds about 6,000 rows of 8 KiB.
//
// Tile width.  TC starts at 16 and doubles (to 64) while there are
// more tiles than the card holds resident at once, so that no block
// waits for another to finish: the only value that adapts is the tile
// count, from C.  The kernel allocates nothing.
//
// C interface (loaded with ctypes by ops/forks.py):
//   int fork_levels_launch(table, rows, cols, sched, T, Bt, sp, op,
//                          reverse, stream)
//     table int32 [rows, cols], sched int32 [T, Bt], sp, op int32
//     [rows], all contiguous; reverse 0 for la, 1 for fd.  Returns
//     cudaGetLastError() after the launch (0 = launched, or nothing to
//     do).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kStage = 2048;   // (slot, sp, op) triples staged at once
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void prefetch_l2(const int32_t* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <bool kReverse>
__global__ void fork_levels_kernel(int32_t* __restrict__ table, int rows,
                                   int cols,
                                   const int32_t* __restrict__ sched, int T,
                                   int Bt, const int32_t* __restrict__ sp,
                                   const int32_t* __restrict__ op) {
  __shared__ int32_t s_slot[kStage];
  __shared__ int32_t s_sp[kStage];
  __shared__ int32_t s_op[kStage];

  const int tc = blockDim.x;
  const int sy = blockDim.y;
  const int c0 = blockIdx.x * tc;
  const int c = c0 + threadIdx.x;
  const bool live = c < cols;
  const int tid = threadIdx.y * tc + threadIdx.x;
  const int nthr = tc * sy;
  // a stage holds `per` whole rows, or one piece of `width` lanes of a
  // row wider than kStage
  const int width = Bt < kStage ? Bt : kStage;
  const int pieces = (Bt + width - 1) / width;
  const int per = pieces == 1 ? kStage / Bt : 1;
  const int stages = (T + per - 1) / per;
  int32_t* const col = table + c;

  for (int si = 0; si < stages; ++si) {
    const int st = kReverse ? stages - 1 - si : si;
    const int r0 = st * per;
    const int nr = min(per, T - r0);
    for (int pc = 0; pc < pieces; ++pc) {
      const int l0 = pc * width;
      const int nl = min(width, Bt - l0);
      __syncthreads();   // the last stage's steps are done with it
      for (int i = tid; i < nr * nl; i += nthr) {
        const int r = i / nl;
        const int l = i - r * nl;
        int s = sched[(size_t)(r0 + r) * Bt + l0 + l];
        int a = -1, o = -1;
        if (s >= 0 && s < rows) {
          a = sp[s];
          o = op[s];
          if (a >= rows) a = -1;
          if (o >= rows) o = -1;
          prefetch_l2(table + (size_t)s * cols + c0);
        } else {
          s = -1;
        }
        s_slot[i] = s;
        s_sp[i] = a;
        s_op[i] = o;
      }
      __syncthreads();
      for (int k = 0; k < nr; ++k) {
        const int r = kReverse ? nr - 1 - k : k;
        if (live) {
          for (int l = threadIdx.y; l < nl; l += sy) {
            const int i = r * nl + l;
            const int s = s_slot[i];
            if (s < 0) continue;
            const int a = s_sp[i];
            const int o = s_op[i];
            int32_t* own = col + (size_t)s * cols;
            const int32_t v = __ldcg(own);
            if constexpr (!kReverse) {
              int32_t m = v;
              if (a >= 0) m = max(m, __ldcg(col + (size_t)a * cols));
              if (o >= 0) m = max(m, __ldcg(col + (size_t)o * cols));
              if (m != v) __stcg(own, m);
            } else {
              if (v == INT_MAX) continue;   // absorbs nothing
              if (a >= 0) atomicMin(col + (size_t)a * cols, v);
              if (o >= 0) atomicMin(col + (size_t)o * cols, v);
            }
          }
        }
        __syncthreads();   // this row's writes before the next row reads
      }
    }
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" int fork_levels_launch(void* table, int rows, int cols,
                                  const void* sched, int T, int Bt,
                                  const void* sp, const void* op,
                                  int reverse, void* stream) {
  if (T <= 0 || Bt <= 0 || rows <= 0 || cols <= 0) return 0;   // no work
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fn = reverse
      ? reinterpret_cast<const void*>(fork_levels_kernel<true>)
      : reinterpret_cast<const void*>(fork_levels_kernel<false>);
  int tc = 16, sy = 1, tiles = 1;
  for (;;) {
    sy = pow2_at_least(Bt);
    if (sy > kMaxThreads / tc) sy = kMaxThreads / tc;
    tiles = (cols + tc - 1) / tc;
    int resident = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn,
                                                        tc * sy, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tiles <= sms * resident || tc >= 64) break;
    tc *= 2;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles), block(tc, sy);
  int32_t* t = static_cast<int32_t*>(table);
  const int32_t* sc = static_cast<const int32_t*>(sched);
  const int32_t* a = static_cast<const int32_t*>(sp);
  const int32_t* o = static_cast<const int32_t*>(op);
  if (reverse) {
    fork_levels_kernel<true><<<grid, block, 0, s>>>(t, rows, cols, sc, T, Bt,
                                                    a, o);
  } else {
    fork_levels_kernel<false><<<grid, block, 0, s>>>(t, rows, cols, sc, T,
                                                     Bt, a, o);
  }
  return static_cast<int>(cudaGetLastError());
}
