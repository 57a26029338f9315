// Blocked strongly-see compare-count, CUDA C++ for sm_90a.
//
// Replaces the non-TPU body of the JAX package's
// babble_tpu/ops/wide.py:209 _ss_partial, which is
// babble_tpu/ops/ss.py:52 ss_counts_compare: per column block of the
// wide engine's la/fd tensors,
//
//     acc[a, b] += sum_{g < G} sum_{k < W} [ A[g, a, k] >= B[g, b, k] ]
//
// with the rows compared as SIGNED values of the block's coordinate
// type (int8, int16 or int32), so that the -1 "below the window" floor
// and the fd_inf "no descendant" sentinel compare as in JAX.  XLA fuses
// the compare-reduce; written as plain tensor code it builds a
// [512, B, W] bool grid per chunk of 512 rows: 8.5 GB at the 10k-node
// config (A = B = 10,000, W = 1,667), rebuilt 20 times per block per
// tally.  G > 1 is the stacked layout [G, rows, W]: one launch sums the
// counts over all G blocks.
//
// acc is updated IN PLACE (JAX donates it to _ss_partial and rebinds the
// result; the port's wrapper returns the same tensor).  Each acc entry
// is owned by one thread of one block, so the read-modify-write has no
// race inside a launch, and launches on one stream run in order.
//
// What bounds it on the card: operations.  A launch does A*B*W*G signed
// compares (ISETP, the ALU pipe) and as many adds (counted on the FMA
// pipe beside them), and moves (A + B)*W*G input elements and 2*A*B acc
// words: at the 10k config's int8 block 1.67e11 compares against
// ~0.8 GB, so integer issue, not memory, is the limit.
//
// Design (simple and exact first, after csrc/fork_ss.cu at K = 1): one
// block of 256 threads owns a 64 x 64 output tile and keeps its 16
// counts per thread in registers.  It walks the columns in chunks of 64:
// the tile's 64 A rows and 64 B rows are staged in shared memory,
// sign-extended to int32, rows padded by one word so the row-strided
// reads fall in distinct banks; then each thread compares its 4 A rows
// against its 4 B rows column by column.  Columns past W stage as
// INT_MIN (A) and INT_MAX (B), so a ragged chunk adds nothing; rows past
// A or B are never stored.  Rows may be strided (lda/ldb elements
// between rows, sga/sgb between blocks); columns are contiguous.
//
// C interface (loaded with ctypes by ops/ss.py):
//   int ss_count_launch(a, b, acc, A, B, W, G, lda, ldb, sga, sgb,
//                       elem_bytes, stream)
//     a, b   int8/int16/int32 (elem_bytes 1/2/4), acc int32 [A, B]
//            contiguous.
//   Returns cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TA = 64;         // A rows per block
constexpr int TB = 64;         // B rows per block
constexpr int NT = 256;        // threads: 16 x 16, each 4 x 4 outputs
constexpr int COLS = 64;       // columns staged per chunk
constexpr int LD = COLS + 1;   // padded shared row stride

template <typename T>
__global__ void __launch_bounds__(NT)
ss_count_kernel(const T* __restrict__ a, const T* __restrict__ b,
                int32_t* __restrict__ acc, int A, int B, int W, int G,
                long long lda, long long ldb, long long sga,
                long long sgb) {
  __shared__ int32_t a_s[TA * LD];
  __shared__ int32_t b_s[TB * LD];

  const int a0 = blockIdx.y * TA;
  const int b0 = blockIdx.x * TB;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  int cnt[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cnt[i][j] = 0;

  for (int g = 0; g < G; ++g) {
    const T* a_g = a + (size_t)g * sga;
    const T* b_g = b + (size_t)g * sgb;
    for (int k0 = 0; k0 < W; k0 += COLS) {
      for (int i = tid; i < TA * COLS; i += NT) {
        const int r = i / COLS, col = i % COLS;
        const int x = a0 + r, k = k0 + col;
        a_s[r * LD + col] =
            (x < A && k < W) ? (int32_t)a_g[(size_t)x * lda + k] : INT_MIN;
      }
      for (int i = tid; i < TB * COLS; i += NT) {
        const int r = i / COLS, col = i % COLS;
        const int y = b0 + r, k = k0 + col;
        b_s[r * LD + col] =
            (y < B && k < W) ? (int32_t)b_g[(size_t)y * ldb + k] : INT_MAX;
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < COLS; ++c) {
        int av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a_s[(ty + 16 * i) * LD + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * LD + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cnt[i][j] += av[i] >= bv[j] ? 1 : 0;
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int x = a0 + ty + 16 * i;
    if (x >= A) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int y = b0 + tx + 16 * j;
      if (y < B) acc[(size_t)x * B + y] += cnt[i][j];
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, void* acc, int A, int B, int W,
            int G, long long lda, long long ldb, long long sga,
            long long sgb, cudaStream_t stream) {
  const dim3 grid((B + TB - 1) / TB, (A + TA - 1) / TA);
  ss_count_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<int32_t*>(acc), A, B, W, G, lda, ldb, sga, sgb);
}

}  // namespace

extern "C" int ss_count_launch(const void* a, const void* b, void* acc,
                               int A, int B, int W, int G, long long lda,
                               long long ldb, long long sga, long long sgb,
                               int elem_bytes, void* stream) {
  if (A <= 0 || B <= 0 || W <= 0 || G <= 0) return 0;   // nothing to add
  if ((A + TA - 1) / TA > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: launch<int8_t>(a, b, acc, A, B, W, G, lda, ldb, sga, sgb, s); break;
    case 2: launch<int16_t>(a, b, acc, A, B, W, G, lda, ldb, sga, sgb, s); break;
    case 4: launch<int32_t>(a, b, acc, A, B, W, G, lda, ldb, sga, sgb, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
