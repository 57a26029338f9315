// la_walk: one-pass last-ancestor fill over slot order, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_ingest.py
// _walk_kernel (driven by la_walk + unpack_la there).  Slot order is
// topological, so for x = 0 .. n_events-1
//
//     la[x] = max(la[sp(x)], la[op(x)]) ;  la[x, own(x)] = int16(seq(x))
//
// and rows at or past n_events are -1.  The values are the TPU kernel's:
// it packs meta = creator << 16 | max(seq, 0) in int32 and stores
// int16(meta & 0xFFFF) (sign-extended when read back) in lane meta >> 16,
// so the own column is creator for seq < 65,536 and the value wraps at
// 32,768.  The output is the unpacked int32 table [E+1, N] that the JAX
// package's la_walk followed by unpack_la computes.
//
// Bounds.  The function moves the four int32 index arrays once in and the
// [E+1, N] int32 table once out: 17.8 MB at 64 x 65,536, 5.3 us at
// 3.35 TB/s.  But it is a recurrence: its critical path is the DAG's
// topological depth (3,494 levels at 64 x 65,536), each level at least one
// dependent shared-memory load and store, some tens of ns: a floor of
// about 0.1 ms, far above the byte bound.
//
// Design.  The columns are independent: la[x, c] depends only on column c
// of the parent rows.  So block c owns column c (n <= 64 blocks, one per
// SM, all resident, no dependence between blocks) and holds the whole
// column in dynamic shared memory as int16: (E+1) cells and a spare, in
// whole 16-byte chunks (la_walk_dynamic_smem), 131,088 B at 64 x 65,536
// and 189,328 B at e_cap 94,661, the largest that walk_supported admits
// and so the largest the wrapper launches; beside the 32,768 B of static
// staging that is within the 232,448 B a block may use.  A column that
// does not fit is refused by the runtime at cudaFuncSetAttribute.  int16
// is exact: the TPU kernel stores int16 too.
//
// One warp walks the column.  Slot order goes in windows of kW = 1024
// slots; in a window, lane l owns the slots base + l + 32 j and resolves
// them in order, one per round at most.  A lane's next unresolved slot is
// its progress counter, and the lanes read each other's counters by
// shuffle: a parent p in [0, x) is resolved once the counter of lane
// p & 31 has passed it (a parent in an earlier window always has).  Each
// round a lane reads its parents' cells speculatively, and if both are
// resolved (or the slot overwrites its own column, which needs no parent)
// stores max(.,.) or the own value and moves on.  The round is branch-free
// (a lane with nothing to do stores into a spare cell past the column) and
// four rounds run between warp votes, so a round is one shuffle and one
// shared load deep: about 55 ns on the H100, against about 377 ns for a
// round of the 1,024-thread block barrier (__syncthreads_or over one slot
// a thread) that this design replaced.  The warp takes about 4,570 rounds
// at 64 x 65,536 (3,494 levels, plus the lanes' in-order coupling and 64
// window ends).  A parent outside [0, x) reads -1 and is never waited on
// (what la_walk_plain gives a row not yet written); the lowest unresolved
// slot then always resolves in the next round, so the walk ends even on
// input that is not topological.  Readiness is the counters, never a
// value of the column: wrapped seqs fill the whole int16 range.
//
// Staging.  Three more warps copy each window's sp, op, creator and seq
// into shared memory with cp.async, one window ahead, double buffered and
// handed over with named barriers (kBarStaged, kBarFree), so the walking
// warp never waits on global memory.  n_events is read on the device, so
// the host never synchronises.
//
// Output.  The int32 table is row-major, so one column is one 4-byte word
// per 256-byte row: written straight from each block, that strided store
// took about 0.07 ms at 64 x 65,536 after the walk, and slowed the walk
// about as much when the stagers wrote each finished window under it (the
// scattered stores queue in the load/store unit that also serves the
// walker's shared-memory accesses).  So the column goes out contiguous
// instead, int16 into this block's row of `cols` [n, pitch] (16-byte
// stores: the stagers write each window as soon as the walker is done
// with it, the block the last two after the walk), and after a grid-wide
// sync (the launch is cooperative: n <= 64 blocks, one per SM, resident
// together) every block transposes a share of the rows through stage_buf,
// reading 8 rows of one column a load and writing whole 256-byte rows of
// the table, sign-extended, -1 on rows at or past n_events.  That saves
// about 0.04 ms at 64 x 65,536 (epilogue 0.07 -> 0.027 ms) for the price
// of the cooperative launch and the scratch; the direct strided store is
// the simpler form to return to if the cooperative launch gets in the way.
// la_walk_phases (the prof buffer below) measures that epilogue.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;              // one block per column, walk_supported gate
constexpr int kW = 1024;               // slots staged and walked per window
constexpr int kThreads = 128;          // warp 0 walks, warps 1-3 stage
constexpr int kStagers = kThreads - 32;
constexpr int kTileRows = 2 * 4 * kW * 4 / (2 * kMaxN);  // transpose tile in stage_buf
constexpr int kLoads = 8;  // transpose loads in flight a thread
constexpr unsigned kFull = 0xFFFFFFFFu;
// named barriers, one pair per staging buffer b (a barrier is never
// arrived at twice before it is waited on): stagers arrive at
// kBarStaged + b and the walker waits there for the window in buffer b;
// the walker arrives at kBarFree + b when done with it and the stagers
// wait there before refilling it
constexpr int kBarStaged = 1;
constexpr int kBarFree = 3;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

// shared-memory accesses by 32-bit shared address
__device__ __forceinline__ int ld_s32(unsigned a) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ int ld_s16(unsigned a) {
  short v;
  asm volatile("ld.shared.s16 %0, [%1];" : "=h"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void st_s16(unsigned a, int v) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(a), "h"(static_cast<short>(v))
               : "memory");
}

__device__ __forceinline__ long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// low 16 bits as a signed int16, widened to int
__device__ __forceinline__ int sext16(unsigned v) {
  return static_cast<int>((v & 0xFFFFu) ^ 0x8000u) - 0x8000;
}

// 8 int16 cells [from, from + 8) of the shared column out to global memory
__device__ __forceinline__ void put8(short* dst, const short* col, int from) {
  *reinterpret_cast<int4*>(dst + from) = *reinterpret_cast<const int4*>(col + from);
}

__global__ void __launch_bounds__(kThreads, 1)
la_walk_kernel(const int* __restrict__ sp, const int* __restrict__ op,
               const int* __restrict__ creator, const int* __restrict__ seq,
               const int* __restrict__ n_events_ptr, int e1, int n,
               int* __restrict__ la, short* __restrict__ cols, int pitch,
               long long* __restrict__ prof) {
  __shared__ int stage_buf[2][4][kW];  // sp, op, creator, seq of two windows
  extern __shared__ __align__(16) short col[];  // the column: e1 cells + spare

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  short* const mine = cols + static_cast<long long>(c) * pitch;
  const long long t_start = prof ? now_ns() : 0;
  int ne = *n_events_ptr;
  ne = ne < 0 ? 0 : (ne > e1 ? e1 : ne);
  const int n_win = (ne + kW - 1) / kW;
  int rounds = 0;

  if (t >= 32) {
    // stagers: window k into buffer k & 1 once the walker is done with
    // k - 2, and window k - 2's finished cells out to this block's row of
    // `cols`
    for (int k = 0; k < n_win; ++k) {
      const int base = k * kW;
      if (k >= 2) {
        bar_sync(kBarFree + (k & 1));
        for (int x = base - 2 * kW + 8 * (t - 32); x < base - kW; x += 8 * kStagers) {
          put8(mine, col, x);
        }
      }
      int* dst = &stage_buf[k & 1][0][0];
      const int end = min(base + kW, ne);
      for (int x = base + t - 32; x < end; x += kStagers) {
        const int j = x - base;
        cp_async4(dst + j, sp + x);
        cp_async4(dst + kW + j, op + x);
        cp_async4(dst + 2 * kW + j, creator + x);
        cp_async4(dst + 3 * kW + j, seq + x);
      }
      cp_async_commit();
      cp_async_wait_all();
      bar_arrive(kBarStaged + (k & 1));
    }
  } else {
    const int lane = t;
    const unsigned col_s = static_cast<unsigned>(__cvta_generic_to_shared(col));
    const unsigned spare = col_s + 2u * static_cast<unsigned>(e1);
    const unsigned stage_s =
        static_cast<unsigned>(__cvta_generic_to_shared(&stage_buf[0][0][0]));
    for (int k = 0; k < n_win; ++k) {
      bar_sync(kBarStaged + (k & 1));
      const unsigned b = stage_s + static_cast<unsigned>((k & 1) * 4 * kW * 4);
      const int base = k * kW;
      const int end = min(base + kW, ne);
      // the staged sp, op and meta of window slot j (clamped into the
      // window: slots past `end` are never used)
      auto fetch = [&](int j, int& fs, int& fo, unsigned& fm) {
        const unsigned a = b + 4u * static_cast<unsigned>(min(j, kW - 1));
        fs = ld_s32(a);
        fo = ld_s32(a + kW * 4);
        fm = (static_cast<unsigned>(ld_s32(a + 2 * kW * 4)) << 16) |
             static_cast<unsigned>(max(ld_s32(a + 3 * kW * 4), 0));
      };
      // x: this lane's next unresolved slot; (s, o, meta) its fields and
      // (s2, o2, meta2) those of the lane's slot after it
      int x = base + lane;
      int s, o, s2, o2;
      unsigned meta, meta2;
      fetch(lane, s, o, meta);
      fetch(lane + 32, s2, o2, meta2);
      auto round = [&]() {
        const bool live = x < end;
        const bool s_in = static_cast<unsigned>(s) < static_cast<unsigned>(x);
        const bool o_in = static_cast<unsigned>(o) < static_cast<unsigned>(x);
        const int ns = __shfl_sync(kFull, x, s & 31);
        const int no = __shfl_sync(kFull, x, o & 31);
        const int ls = ld_s16(col_s + 2u * static_cast<unsigned>(s_in ? s : 0));
        const int lo = ld_s16(col_s + 2u * static_cast<unsigned>(o_in ? o : 0));
        const bool own = (static_cast<int>(meta) >> 16) == c;
        const bool go =
            live && (own || ((!s_in || ns > s) && (!o_in || no > o)));
        const int v = own ? sext16(meta) : max(s_in ? ls : -1, o_in ? lo : -1);
        st_s16(go ? col_s + 2u * static_cast<unsigned>(x) : spare, v);
        x = go ? x + 32 : x;
        s = go ? s2 : s;
        o = go ? o2 : o;
        meta = go ? meta2 : meta;
        int fs, fo;
        unsigned fm;
        fetch(x + 32 - base, fs, fo, fm);
        s2 = go ? fs : s2;
        o2 = go ? fo : o2;
        meta2 = go ? fm : meta2;
        __syncwarp();  // this round's stores before the next round's loads
      };
      do {
        round();
        round();
        round();
        round();
        rounds += 4;
      } while (__any_sync(kFull, x < end));
      if (k + 2 < n_win) bar_arrive(kBarFree + (k & 1));
    }
  }
  __syncthreads();  // every column cell written
  const long long t_walk = prof ? now_ns() : 0;

  // the last two windows out too (the stagers wrote every earlier one
  // while the walker went on); cells past n_events are never read
  for (int x = max(n_win - 2, 0) * kW + 8 * t; x < ne; x += 8 * kThreads) {
    put8(mine, col, x);
  }
  cooperative_groups::this_grid().sync();  // every column in `cols`

  // transpose: row chunks of kTileRows x n int16 through stage_buf, read
  // 8 rows of one column a load (kLoads loads in flight a thread), written
  // as whole rows of the int32 table, 4 cells a store
  short* const tile = reinterpret_cast<short*>(&stage_buf[0][0][0]);
  const int n_chunks = (e1 + kTileRows - 1) / kTileRows;
  const int groups = n * (kTileRows / 8);  // (column, 8 rows) loads a chunk
  for (int ch = c; ch < n_chunks; ch += n) {
    const int r0 = ch * kTileRows;
    for (int i0 = t; i0 < groups; i0 += kThreads * kLoads) {
      int4 w[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads;
        const int j = i % n;          // neighbouring threads: neighbouring columns
        const int x = r0 + 8 * (i / n);
        w[u] = make_int4(0, 0, 0, 0);
        if (i < groups && x < ne) {
          w[u] = *reinterpret_cast<const int4*>(
              cols + static_cast<long long>(j) * pitch + x);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads;
        const int j = i % n;
        const int x = r0 + 8 * (i / n);
        if (i < groups && x < ne) {
          const unsigned h2[4] = {static_cast<unsigned>(w[u].x), static_cast<unsigned>(w[u].y),
                                  static_cast<unsigned>(w[u].z), static_cast<unsigned>(w[u].w)};
#pragma unroll
          for (int h = 0; h < 8; ++h) {
            tile[(x - r0 + h) * n + j] = static_cast<short>(h2[h >> 1] >> (16 * (h & 1)));
          }
        }
      }
    }
    __syncthreads();
    // cell i of the chunk is row r0 + i / n, column i % n; r0 * n is a
    // multiple of 4, so 4 cells make one aligned 16-byte store
    const int cells = min(kTileRows, e1 - r0) * n;
    int* const out = la + static_cast<long long>(r0) * n;
    for (int i = 4 * t; i + 3 < cells; i += 4 * kThreads) {
      const short4 v = *reinterpret_cast<const short4*>(tile + i);
      int4 o;
      o.x = r0 + i / n < ne ? v.x : -1;
      o.y = r0 + (i + 1) / n < ne ? v.y : -1;
      o.z = r0 + (i + 2) / n < ne ? v.z : -1;
      o.w = r0 + (i + 3) / n < ne ? v.w : -1;
      *reinterpret_cast<int4*>(out + i) = o;
    }
    for (int i = cells / 4 * 4 + t; i < cells; i += kThreads) {
      out[i] = r0 + i / n < ne ? static_cast<int>(tile[i]) : -1;
    }
    __syncthreads();
  }

  if (prof) {
    __syncthreads();
    if (t == 0) {
      long long* p = prof + 4 * c;
      p[0] = t_start;
      p[1] = t_walk;
      p[2] = now_ns();
      p[3] = rounds;
    }
  }
}

}  // namespace

// C ABI for ctypes.  Pointers are device pointers; n_events is a device
// int32 scalar (read by the kernel, so the host never synchronises).
// cols is int16 scratch [n, pitch], 16-byte aligned, pitch a multiple of 8
// and at least e1.  prof is null, or a device int64 [n, 4] that receives,
// per block, the globaltimer (ns) at its start, at the end of the walk and
// at the end of the epilogue, and the walking warp's rounds.  Returns the cudaError_t of
// the attribute call or the launch (0 = cudaSuccess); a column too large
// for shared memory is refused by the attribute call.

// Dynamic shared memory of one block: E+1 column cells and the spare
// cell, int16, in whole 16-byte chunks.
extern "C" int la_walk_dynamic_smem(int e1) { return (e1 + 1 + 7) / 8 * 16; }

extern "C" int la_walk_launch(const int* sp, const int* op, const int* creator,
                              const int* seq, const int* n_events, int e1,
                              int n, int* la, short* cols, int pitch,
                              long long* prof, void* stream) {
  if (n < 1 || n > kMaxN || e1 < 1 || pitch % 8 != 0 || pitch < e1 ||
      reinterpret_cast<unsigned long long>(cols) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dyn = la_walk_dynamic_smem(e1);
  // above 48 KB of dynamic shared memory a launch is refused without this
  cudaError_t err = cudaFuncSetAttribute(
      la_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  // cooperative: all n blocks resident at once, for the grid-wide sync
  void* args[] = {&sp, &op, &creator, &seq, &n_events, &e1, &n, &la, &cols,
                  &pitch, &prof};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(la_walk_kernel),
                                    dim3(n), dim3(kThreads), args, dyn,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The compiled kernel's registers per thread, static shared memory bytes,
// local (spill) bytes per thread and largest block, from the runtime.
extern "C" int la_walk_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, la_walk_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  return 0;
}
