// Fork strongly-see compare-count, CUDA C++ for sm_90a.
//
// Replaces the JAX package's babble_tpu/ops/forks.py _ss_counts
// (lines 649-667), which XLA fuses on a TPU but which, written as plain
// tensor code, materializes an [X, W, N] grid: at the 1024-creator
// byzantine DAG (X = 131,073 events, W = 2,048 branch witnesses,
// N = 1,024 creators) that grid is 1.1 TB in i32.  Both kernels here
// compute
//
//     cnt[g, x, w] = sum_c [ (OR_k la[g, x, c*K+k] >= hw[g, w, c*K+k])
//                            AND NOT det[g, x, c] ]
//
// as a tiled semiring product: (>=, OR over K, AND NOT det, +) in place
// of (x, +).  The [X, W, N] grid never exists.
//
// What bounds it on the card: operations.  At the closure's shape a call
// compares X*W*N*K = 5.5e11 coordinate pairs against ~2.3 GB of int32
// inputs and outputs: integer issue, not memory, is the limit.  A lane
// operation reads at most one 32-bit word of each side, so at 16-bit
// coordinates any design needs one operation a word pair (two creators'
// branch k) and one a word of OR'd results that counts it.
//
// Two kernels:
//
// int32 (fork_ss_launch): the first design, for calls that bring no
// window.  One block of 256 threads owns a 64 x 64 output tile of one g
// and keeps its 16 counts per thread in registers.  It walks the
// creators in chunks of CC = 32/K (32 columns): the tile's 64 viewer
// rows of la, 64 witness rows of hw and 64 x CC det flags are staged in
// shared memory (rows padded by one word so the row-strided reads fall
// in distinct banks), then each thread compares its 4 viewer rows
// against its 4 witness rows creator by creator: K ISETPs, a SEL of the
// not-detected flag and half a three-term add a creator pair, all on the
// ALU pipe.  Columns past B stage as INT_MIN / INT_MAX and det flags
// past N as "detected", so a ragged creator chunk adds nothing.
//
// packed (fork_ss_packed_launch): window-relative 15-bit coordinates,
// two creators to a 32-bit word.  The wrapper (ops/forks.py) narrows
// each call's rows against the batch's chain window and folds NOT det
// into the viewer side: every value lies in [0, 0x7FFF], the viewer's
// 0 loses every compare (a detected creator, or no ancestor in the
// window) and the witness's 0x7FFF wins every one (no helper).  It lays
// each row out as K branch planes of Np creators (column k*Np + c,
// Np a multiple of 8, so every plane is whole 16-byte pieces), padded
// with 0 on the viewer side and 0x7FFF on the witness side, so a pad
// creator counts nothing.  Word q of plane k then holds branch k of
// creators 2q and 2q + 1.
//   - Per word pair, with H = 0x80008000 (the lanes' top bits) and the
//     witness word staged negated (c = -b):
//         d  = a + c + H           lane: a - b + 0x8000 in [1, 0xFFFF]
//                                  for lanes in [0, 0x7FFF], no carry
//                                  across lanes; its top bit is [a >= b]
//     then over the K planes and the count:
//         t  = (d_0 | ... | d_K-1) & H     LOP3 (one at K <= 2)
//         n  = dp4a(t, 0x01010101, n)      128 a creator that sees
//     and n >> 7 is the count.  At K = 2 that is 4 instructions a word
//     of two creators: two adds, a LOP3 and a dp4a.  (ss_count's signed
//     compare needs a majority LOP3 a word pair besides; these values
//     are never negative, so the top bit of the add is the compare.)
//   - The add is a three-term IADD3 (ALU pipe) for half the (witness
//     row, plane) words and IMAD.IADD (FMA pipe, ptxas's choice for a
//     plain add, with H pre-added to the word once per load) for the
//     other half; the LOP3 is ALU and the dp4a (IDP) FMA, so each pipe
//     takes half.
//   - A block of 256 threads owns a (16 TI) x (16 TJ) output tile, TI x
//     TJ words a thread: 8 x 8 for K <= 2 (64 counters and 16 K staged
//     words fit 128 registers, two blocks an SM), 8 x 4 for K = 3, 4
//     and 4 x 4 above.  Planes run in chunks of KW words (8 at K = 1, 4
//     above): each thread starts its 16-byte pieces of the next chunk
//     with cp.async, the block compares this chunk, then each thread
//     stores its landed pieces transposed (viewer raw, witness negated)
//     into the other buffer, one __syncthreads a chunk.
//   - The counts stay below 2^32 / 128: Np < 2^24.
//
// C interface (loaded with ctypes by ops/forks.py):
//   int fork_ss_launch(la, det, hw, out, G, X, W, N, K, stream)
//     la  int32 [G, X, N*K], det uint8/bool [G, X, N],
//     hw  int32 [G, W, N*K], out int32 [G, X, W], all contiguous.
//   int fork_ss_packed_launch(view, wit, out, G, X, W, Wq, K, stream)
//     view int16 [G, X, K, 2*Wq], wit int16 [G, W, K, 2*Wq], every lane
//     in [0, 0x7FFF]; out int32 [G, X, W]; all contiguous, the pointers
//     16-byte aligned, Wq (words a plane) a multiple of 4.
//   Each returns cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// ---------------------------------------------------------------- int32

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

// --------------------------------------------------------------- packed

constexpr uint32_t H = 0x80008000u;     // the lanes' top bits
constexpr uint32_t VPAD = 0u;           // viewer pad: loses every compare
constexpr uint32_t WPAD = 0x7FFF7FFFu;  // witness pad: wins every compare
constexpr int PNT = 256;                // threads: 16 x 16

template <int K>
struct Tile {
  static constexpr int TI = K <= 4 ? 8 : 4;    // viewer rows a thread
  static constexpr int TJ = K <= 2 ? 8 : 4;    // witness rows a thread
  static constexpr int KW = K == 1 ? 8 : 4;    // words a plane a chunk
  static constexpr int RA = 16 * TI;           // viewer rows a block
  static constexpr int RB = 16 * TJ;           // witness rows a block
  static constexpr int PR = K * KW / 4;        // 16-byte pieces a row
};

template <int K>
struct PSmem {
  using T = Tile<K>;
  // staged words, [buffer][plane][word][row]: viewer raw, witness negated
  uint32_t a[2][K][T::KW][T::RA];
  uint32_t c[2][K][T::KW][T::RB];
  // the raw 16-byte pieces cp.async lands, [row][plane * KW + word]
  uint32_t ra[T::RA][K * T::KW];
  uint32_t rb[T::RB][K * T::KW];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}

// x + y + H as one three-term add, hidden from the front end so that it
// cannot fold y + H into one value per word: ptxas emits IADD3
__device__ __forceinline__ uint32_t add3h(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("{\n\t.reg .u32 t;\n\tadd.u32 t, %1, %2;\n\tadd.u32 %0, t, %3;\n\t}"
      : "=r"(r) : "r"(x), "r"(y), "n"(H));
  return r;
}

// rows t*4 .. +3 of each 64-row half of a block's side
__device__ __forceinline__ int tile_row(int t, int i) {
  return (i / 4) * 64 + t * 4 + (i & 3);
}

__device__ __forceinline__ void put4(uint32_t* d, uint4 v) {
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

// the add of witness row j, plane k: three-term IADD3 on the ALU pipe for
// half of them, a plain add (IMAD.IADD, FMA pipe) for the other half
template <int K>
__device__ __forceinline__ constexpr bool alu_add(int j, int k) {
  return ((j * K + k) & 1) == 0;
}

// word q of a chunk, all K planes: the thread's TI x TJ words into its
// counters
template <int K>
__device__ __forceinline__ void compare_word(
    const PSmem<K>& s, int buf, int q, int ty, int tx,
    uint32_t (&n)[Tile<K>::TI][Tile<K>::TJ]) {
  constexpr int TI = Tile<K>::TI, TJ = Tile<K>::TJ;
  uint32_t av[K][TI], cv[K][TJ];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int h = 0; h < TI / 4; ++h)
      put4(av[k] + 4 * h,
           reinterpret_cast<const uint4*>(s.a[buf][k][q])[h * 16 + ty]);
#pragma unroll
    for (int h = 0; h < TJ / 4; ++h)
      put4(cv[k] + 4 * h,
           reinterpret_cast<const uint4*>(s.c[buf][k][q])[h * 16 + tx]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < TJ; ++j)
      if (!alu_add<K>(j, k)) cv[k][j] += H;
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      uint32_t u = 0;
#pragma unroll
      for (int k = 0; k < K; ++k)
        u |= alu_add<K>(j, k) ? add3h(av[k][i], cv[k][j])
                              : av[k][i] + cv[k][j];
      n[i][j] = __dp4a(u & H, 0x01010101u, n[i][j]);
    }
}

template <int K, int QN>
__device__ __forceinline__ void compare_chunk(
    const PSmem<K>& s, int buf, int ty, int tx,
    uint32_t (&n)[Tile<K>::TI][Tile<K>::TJ]) {
#pragma unroll 2
  for (int q = 0; q < QN; ++q) compare_word<K>(s, buf, q, ty, tx, n);
}

// view: [G, X, K, Wq] words, wit: [G, W, K, Wq] words, Wq % 4 == 0
template <int K>
__global__ void __launch_bounds__(PNT, 2)
fork_ss_packed_kernel(const uint32_t* __restrict__ view,
                      const uint32_t* __restrict__ wit,
                      int32_t* __restrict__ out, int X, int W, int Wq) {
  using T = Tile<K>;
  constexpr int TI = T::TI, TJ = T::TJ, KW = T::KW, PR = T::PR;
  constexpr int NPA = (T::RA * PR + PNT - 1) / PNT;   // pieces a thread
  constexpr int NPB = (T::RB * PR + PNT - 1) / PNT;
  __shared__ __align__(16) PSmem<K> s;

  const int g = blockIdx.z;
  const int x0 = blockIdx.y * T::RA;
  const int w0 = blockIdx.x * T::RB;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long ld = (long long)K * Wq;              // words a row
  const uint32_t* view_g = view + (size_t)g * X * ld;
  const uint32_t* wit_g = wit + (size_t)g * W * ld;
  const int chunks = (Wq + KW - 1) / KW;

  // piece p of a side: row p / PR, plane e / (KW / 4), words
  // (e % (KW / 4)) * 4 .. +3 of the chunk, e = p % PR; past the rows or
  // the words it is the side's pad
  auto fetch = [&](int it) {
    const int k0 = it * KW;
#pragma unroll
    for (int u = 0; u < NPA; ++u) {
      const int p = tid + u * PNT;
      if (p >= T::RA * PR) break;
      const int r = p / PR, e = p % PR;
      const int k = e / (KW / 4), w4 = (e % (KW / 4)) * 4;
      uint4* dst = reinterpret_cast<uint4*>(&s.ra[r][e * 4]);
      if (x0 + r < X && k0 + w4 < Wq) {
        cp_async16(dst, view_g + (size_t)(x0 + r) * ld + (size_t)k * Wq
                            + k0 + w4);
      } else {
        *dst = make_uint4(VPAD, VPAD, VPAD, VPAD);
      }
    }
#pragma unroll
    for (int u = 0; u < NPB; ++u) {
      const int p = tid + u * PNT;
      if (p >= T::RB * PR) break;
      const int r = p / PR, e = p % PR;
      const int k = e / (KW / 4), w4 = (e % (KW / 4)) * 4;
      uint4* dst = reinterpret_cast<uint4*>(&s.rb[r][e * 4]);
      if (w0 + r < W && k0 + w4 < Wq) {
        cp_async16(dst, wit_g + (size_t)(w0 + r) * ld + (size_t)k * Wq
                            + k0 + w4);
      } else {
        *dst = make_uint4(WPAD, WPAD, WPAD, WPAD);
      }
    }
    asm volatile("cp.async.commit_group;");
  };
  // the thread's landed pieces, transposed into buffer buf
  auto land = [&](int buf) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
#pragma unroll
    for (int u = 0; u < NPA; ++u) {
      const int p = tid + u * PNT;
      if (p >= T::RA * PR) break;
      const int r = p / PR, e = p % PR;
      const int k = e / (KW / 4), w4 = (e % (KW / 4)) * 4;
      const uint4 v = *reinterpret_cast<const uint4*>(&s.ra[r][e * 4]);
      s.a[buf][k][w4 + 0][r] = v.x;
      s.a[buf][k][w4 + 1][r] = v.y;
      s.a[buf][k][w4 + 2][r] = v.z;
      s.a[buf][k][w4 + 3][r] = v.w;
    }
#pragma unroll
    for (int u = 0; u < NPB; ++u) {
      const int p = tid + u * PNT;
      if (p >= T::RB * PR) break;
      const int r = p / PR, e = p % PR;
      const int k = e / (KW / 4), w4 = (e % (KW / 4)) * 4;
      const uint4 v = *reinterpret_cast<const uint4*>(&s.rb[r][e * 4]);
      s.c[buf][k][w4 + 0][r] = 0u - v.x;
      s.c[buf][k][w4 + 1][r] = 0u - v.y;
      s.c[buf][k][w4 + 2][r] = 0u - v.z;
      s.c[buf][k][w4 + 3][r] = 0u - v.w;
    }
  };

  uint32_t n[TI][TJ];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) n[i][j] = 0;

  fetch(0);
  land(0);
  __syncthreads();
  for (int it = 0; it < chunks; ++it) {
    if (it + 1 < chunks) fetch(it + 1);
    if constexpr (KW == 4) {
      compare_chunk<K, KW>(s, it & 1, ty, tx, n);
    } else if (Wq - it * KW >= KW) {
      compare_chunk<K, KW>(s, it & 1, ty, tx, n);
    } else {
      compare_chunk<K, KW / 2>(s, it & 1, ty, tx, n);   // Wq % 4 == 0
    }
    if (it + 1 < chunks) land((it + 1) & 1);
    __syncthreads();
  }

  // four consecutive witness rows a store where the row allows it
  const bool vec = (W & 3) == 0;
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int x = x0 + tile_row(ty, i);
    if (x >= X) continue;
    int32_t* row = out + ((size_t)g * X + x) * W;
#pragma unroll
    for (int h = 0; h < TJ / 4; ++h) {
      const int w = w0 + tile_row(tx, 4 * h);
      if (vec && w + 3 < W) {
        *reinterpret_cast<int4*>(row + w) = make_int4(
            (int32_t)(n[i][4 * h] >> 7), (int32_t)(n[i][4 * h + 1] >> 7),
            (int32_t)(n[i][4 * h + 2] >> 7), (int32_t)(n[i][4 * h + 3] >> 7));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (w + j < W) row[w + j] = (int32_t)(n[i][4 * h + j] >> 7);
      }
    }
  }
}

template <int K>
int launch_packed(const void* view, const void* wit, void* out, int G,
                  int X, int W, int Wq, cudaStream_t stream) {
  using T = Tile<K>;
  if ((X + T::RA - 1) / T::RA > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((W + T::RB - 1) / T::RB, (X + T::RA - 1) / T::RA, G);
  fork_ss_packed_kernel<K><<<grid, PNT, 0, stream>>>(
      static_cast<const uint32_t*>(view), static_cast<const uint32_t*>(wit),
      static_cast<int32_t*>(out), X, W, Wq);
  return 0;
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

extern "C" int fork_ss_packed_launch(const void* view, const void* wit,
                                     void* out, int G, int X, int W, int Wq,
                                     int K, void* stream) {
  if (G <= 0 || X <= 0 || W <= 0) return 0;   // nothing to count
  if (Wq <= 0 || Wq % 4 || Wq >= (1 << 23) || G > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(view) % 16 ||
      reinterpret_cast<uintptr_t>(wit) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  switch (K) {
    case 1: rc = launch_packed<1>(view, wit, out, G, X, W, Wq, s); break;
    case 2: rc = launch_packed<2>(view, wit, out, G, X, W, Wq, s); break;
    case 3: rc = launch_packed<3>(view, wit, out, G, X, W, Wq, s); break;
    case 4: rc = launch_packed<4>(view, wit, out, G, X, W, Wq, s); break;
    case 5: rc = launch_packed<5>(view, wit, out, G, X, W, Wq, s); break;
    case 6: rc = launch_packed<6>(view, wit, out, G, X, W, Wq, s); break;
    case 7: rc = launch_packed<7>(view, wit, out, G, X, W, Wq, s); break;
    case 8: rc = launch_packed<8>(view, wit, out, G, X, W, Wq, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
