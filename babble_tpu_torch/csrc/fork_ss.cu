// Fork strongly-see compare-count, CUDA C++ for sm_90a.
//
// Replaces the JAX package's babble_tpu/ops/forks.py _ss_counts
// (lines 649-667), which XLA fuses on a TPU but which, written as plain
// tensor code, materializes an [X, W, N] grid: at the 1024-creator
// byzantine DAG (X = 131,073 events, W = 2,048 branch witnesses,
// N = 1,024 creators) that grid is 1.1 TB in i32.  This kernel computes
//
//     cnt[g, x, w] = sum_c [ (OR_k la[g, x, c*K+k] >= hw[g, w, c*K+k])
//                            AND NOT det[g, x, c] ]
//
// as a tiled semiring product: (>=, OR over K, AND NOT det, +) in place
// of (x, +).  Branch k of creator c sits at column c*K + k.
//
// What bounds it on the card: operations.  A call does X*W*B compares
// (B = N*K) and moves X*B + W*B + X*N input words and X*W output words
// once, so at the closure's shape it is ~5.5e11 compares against
// ~2.3 GB: integer issue, not memory, is the limit.
//
// Design (simple and exact first): one block of 256 threads owns a
// 64 x 64 output tile of one g and keeps its 16 counts per thread in
// registers.  It walks the creators in chunks of CC = 32/K (32 columns):
// the tile's 64 viewer rows of la, 64 witness rows of hw and 64 x CC
// det flags are staged in shared memory (rows padded by one word so the
// row-strided reads fall in distinct banks), then each thread compares
// its 4 viewer rows against its 4 witness rows creator by creator.  The
// [X, W, N] grid never exists.  Columns past B stage as INT_MIN / INT_MAX
// and det flags past N as "detected", so a ragged creator chunk adds
// nothing; rows past X or W are never stored.
//
// C interface (loaded with ctypes by ops/forks.py):
//   int fork_ss_launch(la, det, hw, out, G, X, W, N, K, stream)
//     la  int32 [G, X, N*K], det uint8/bool [G, X, N],
//     hw  int32 [G, W, N*K], out int32 [G, X, W], all contiguous.
//   Returns cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TX = 64;         // viewer rows per block
constexpr int TW = 64;         // witness rows per block
constexpr int NT = 256;        // threads: 16 x 16, each 4 x 4 outputs
constexpr int COLS = 32;       // la/hw columns staged per chunk

template <int K>
__global__ void __launch_bounds__(NT)
fork_ss_kernel(const int32_t* __restrict__ la,
               const uint8_t* __restrict__ det,
               const int32_t* __restrict__ hw,
               int32_t* __restrict__ out, int X, int W, int N) {
  constexpr int CC = COLS / K > 0 ? COLS / K : 1;   // creators per chunk
  constexpr int CK = CC * K;                        // columns per chunk
  constexpr int LD = CK + 1;                        // padded row stride
  __shared__ int32_t la_s[TX * LD];
  __shared__ int32_t hw_s[TW * LD];
  __shared__ int32_t nd_s[TX * CC];                 // 1 = not detected

  const long long B = (long long)N * K;
  const int g = blockIdx.z;
  const int x0 = blockIdx.y * TX;
  const int w0 = blockIdx.x * TW;
  const int32_t* la_g = la + (size_t)g * X * B;
  const uint8_t* det_g = det + (size_t)g * X * N;
  const int32_t* hw_g = hw + (size_t)g * W * B;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int c0 = 0; c0 < N; c0 += CC) {
    const long long b0 = (long long)c0 * K;
    for (int i = tid; i < TX * CK; i += NT) {
      const int r = i / CK, col = i % CK;
      const int x = x0 + r;
      const long long b = b0 + col;
      la_s[r * LD + col] =
          (x < X && b < B) ? la_g[(size_t)x * B + b] : INT_MIN;
    }
    for (int i = tid; i < TW * CK; i += NT) {
      const int r = i / CK, col = i % CK;
      const int w = w0 + r;
      const long long b = b0 + col;
      hw_s[r * LD + col] =
          (w < W && b < B) ? hw_g[(size_t)w * B + b] : INT_MAX;
    }
    for (int i = tid; i < TX * CC; i += NT) {
      const int r = i / CC, c = i % CC;
      const int x = x0 + r, cc = c0 + c;
      nd_s[r * CC + c] =
          (x < X && cc < N) ? (det_g[(size_t)x * N + cc] == 0) : 0;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < CC; ++c) {
      int a[4][K], h[4][K], m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        m[i] = nd_s[r * CC + c];
#pragma unroll
        for (int k = 0; k < K; ++k) a[i][k] = la_s[r * LD + c * K + k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
#pragma unroll
        for (int k = 0; k < K; ++k) h[j][k] = hw_s[r * LD + c * K + k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bool ok = a[i][0] >= h[j][0];
#pragma unroll
          for (int k = 1; k < K; ++k) ok = ok | (a[i][k] >= h[j][k]);
          acc[i][j] += ok ? m[i] : 0;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int x = x0 + ty + 16 * i;
    if (x >= X) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + tx + 16 * j;
      if (w < W) out[((size_t)g * X + x) * W + w] = acc[i][j];
    }
  }
}

template <int K>
void launch(const void* la, const void* det, const void* hw, void* out,
            int G, int X, int W, int N, cudaStream_t stream) {
  const dim3 grid((W + TW - 1) / TW, (X + TX - 1) / TX, G);
  fork_ss_kernel<K><<<grid, NT, 0, stream>>>(
      static_cast<const int32_t*>(la), static_cast<const uint8_t*>(det),
      static_cast<const int32_t*>(hw), static_cast<int32_t*>(out), X, W, N);
}

}  // namespace

extern "C" int fork_ss_launch(const void* la, const void* det, const void* hw,
                              void* out, int G, int X, int W, int N, int K,
                              void* stream) {
  if (G <= 0 || X <= 0 || W <= 0) return 0;   // nothing to count
  if (N <= 0 || G > 65535 || (X + TX - 1) / TX > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: launch<1>(la, det, hw, out, G, X, W, N, s); break;
    case 2: launch<2>(la, det, hw, out, G, X, W, N, s); break;
    case 3: launch<3>(la, det, hw, out, G, X, W, N, s); break;
    case 4: launch<4>(la, det, hw, out, G, X, W, N, s); break;
    case 5: launch<5>(la, det, hw, out, G, X, W, N, s); break;
    case 6: launch<6>(la, det, hw, out, G, X, W, N, s); break;
    case 7: launch<7>(la, det, hw, out, G, X, W, N, s); break;
    case 8: launch<8>(la, det, hw, out, G, X, W, N, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
