// la_walk: one-pass last-ancestor fill over slot order, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_ingest.py
// _walk_kernel (driven by la_walk + unpack_la there).  Slot order is
// topological, so one sequential walk computes, for x = 0 .. n_events-1,
//
//     la[x] = max(la[sp(x)], la[op(x)]) ;  la[x, creator(x)] = seq(x)
//
// and rows at or past n_events are -1.  The output is the UNPACKED int32
// table [E+1, N]; the TPU kernel's packed int16 two-events-per-128-lanes
// layout was a VMEM artifact and is not carried over.
//
// Bound.  The function moves the four int32 index arrays once in and the
// [E+1, N] int32 table once out: about 17.8 MB at 64 x 65,536, so about
// 5.3 us at 3.35 TB/s.  But the walk is a dependency chain of n_events
// steps (a row may read the row written one step before it), so it is
// latency-bound, far above that byte bound.
//
// Design.  Each participant column is independent: la[x, c] depends only
// on la[sp(x), c], la[op(x), c] and the own-column overwrite.  So block 0
// runs one thread per column (n <= 64: two warps) and each thread walks
// its own column over every slot.  A thread reads only values it wrote
// itself, so the steps need no __syncthreads and no fence.  Neighbouring
// threads touch neighbouring words of one row, so each step's loads and
// store are coalesced.  The table stays in global memory (16.8 MB at
// 64 x 65,536: L2-resident on the 50 MB L2).  The block stages the index
// arrays through shared memory in chunks.  Blocks 1.. fill the tail rows
// [n_events, E+1) with -1 in parallel with the walk (disjoint rows).
//
// Later redesign: one block per column holding the whole column in shared
// memory as int16 (65,537 x 2 B = 128 KB < 227 KB; the s_cap < 32767 gate
// makes int16 exact), which takes the L2 round trip out of every step.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;        // one thread per column, walk_supported gate
constexpr int kChunk = 2048;     // slots staged in shared memory at a time
constexpr int kTailBlocks = 132; // one per SM for the -1 tail fill

__global__ void __launch_bounds__(kMaxN)
la_walk_kernel(const int* __restrict__ sp, const int* __restrict__ op,
               const int* __restrict__ creator, const int* __restrict__ seq,
               const int* __restrict__ n_events_ptr, int e1, int n,
               int* la) {
  int ne = *n_events_ptr;
  ne = ne < 0 ? 0 : (ne > e1 ? e1 : ne);

  if (blockIdx.x > 0) {
    const long long start = (long long)ne * n;
    const long long total = (long long)e1 * n;
    const long long stride = (long long)(gridDim.x - 1) * blockDim.x;
    for (long long k = start + (long long)(blockIdx.x - 1) * blockDim.x +
                       threadIdx.x;
         k < total; k += stride) {
      la[k] = -1;
    }
    return;
  }

  __shared__ int s_sp[kChunk];
  __shared__ int s_op[kChunk];
  __shared__ int s_cr[kChunk];
  __shared__ int s_sq[kChunk];

  const int c = threadIdx.x;
  for (int base = 0; base < ne; base += kChunk) {
    const int cnt = min(kChunk, ne - base);
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      s_sp[j] = sp[base + j];
      s_op[j] = op[base + j];
      s_cr[j] = creator[base + j];
      // the TPU kernel packs creator << 16 | max(seq, 0): keep its value
      s_sq[j] = max(seq[base + j], 0) & 0xFFFF;
    }
    __syncthreads();
    if (c < n) {
      for (int j = 0; j < cnt; ++j) {
        const int s = s_sp[j];
        const int o = s_op[j];
        // a parent outside [0, e1) is missing: -1, like the sentinel row
        const int a = ((unsigned)s < (unsigned)e1) ? la[(long long)s * n + c] : -1;
        const int b = ((unsigned)o < (unsigned)e1) ? la[(long long)o * n + c] : -1;
        const int v = (s_cr[j] == c) ? s_sq[j] : max(a, b);
        la[(long long)(base + j) * n + c] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// C ABI for ctypes.  Pointers are device pointers; n_events is a device
// int32 scalar (read by the kernel, so the host never synchronises).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int la_walk_launch(const int* sp, const int* op, const int* creator,
                              const int* seq, const int* n_events, int e1,
                              int n, int* la, void* stream) {
  if (n < 1 || n > kMaxN || e1 < 1) return (int)cudaErrorInvalidValue;
  la_walk_kernel<<<1 + kTailBlocks, kMaxN, 0, (cudaStream_t)stream>>>(
      sp, op, creator, seq, n_events, e1, n, la);
  return (int)cudaGetLastError();
}
