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
// and the fd_inf "no descendant" sentinel compare as in JAX, and exact
// for any values of the type.  XLA fuses the compare-reduce; written as
// plain tensor code it builds a [512, B, W] bool grid per chunk of 512
// rows: 8.5 GB at the 10k-node config (A = B = 10,000, W = 1,667),
// rebuilt 20 times per block per tally.  G > 1 is the stacked layout
// [G, rows, W]: one launch sums the counts over all G blocks.
//
// acc is updated IN PLACE (JAX donates it to _ss_partial and rebinds the
// result; the port's wrapper returns the same tensor).  Each acc entry
// is owned by one thread of one block, so the read-modify-write has no
// race inside a launch, and launches on one stream run in order.
//
// What bounds it on the card: operations.  A launch compares A*B*W*G
// pairs and moves (A + B)*W*G input elements and 2*A*B acc words: at the
// 10k run's int16 block 5.3e10 pairs against ~0.8 GB.  The least time
// for the pairs: a lane operation reads at most one 32-bit word of each
// row, so 32/bits pairs; a word pair needs at least two, one that
// compares and one that adds the result into a count; an SM dispatches at
// most 128 lane operations a clock (4 schedulers x 32 lanes; each of
// the ALU and FMA pipes 64 at compute capability 9.0).  So one word pair
// per 64 lane operations a clock an SM.  Two designs that were reckoned
// lie above the one below:
//   - one compare per pair (ISETP) and one add per pair: 2 lane
//     operations a pair, the first design of this kernel (a 64 x 64
//     tile, columns staged sign-extended to int32), 0.17 of the bound at
//     the 10k run's shape and 0.09 at bench's int8 block;
//   - the JAX package's TPU branch, a one-hot product on the tensor
//     cores (babble_tpu/ops/wide.py:111-118, :213-233): 2*A*B*W*S1 int8
//     operations for S1 = s_cap + 1 seq buckets.  At the 10k run's
//     shape with S1 = 143 that is 7.6 ms at the 1,979 TOP/s dense int8
//     peak, and 2.6 ms even with a 48-wide band (S1 = 49), against the
//     packed bound of 1.6 ms; and it is exact only for values inside the
//     band, which this function does not assume.
//
// Design for int8 and int16 (4 or 2 coordinates a 32-bit word, SWAR):
//   - The wrapper hands rows whose columns are padded to 16 bytes (the
//     type's minimum on the A side, its maximum on the B side, so a pad
//     column meets only pad columns and min >= max counts nothing) and
//     whose rows start 16-byte aligned.  Columns are compared as whole
//     words; nothing pads to the chunk.
//   - Per word and H = the lanes' top bits (0x80808080 or 0x80008000),
//     formed once per block into shared memory:
//         A side: aL = a & ~H,      aH = ~a & H
//         B side: C  = -(b & ~H),   bH = b & H
//     Then per word pair, three instructions:
//         d  = aL + C + H              lane: a_lo + 2^(bits-1) - b_lo in
//                                      [1, 2^bits), no carry out; its top
//                                      bit is [a_lo >= b_lo]
//         ge = maj(aH, bH, d)          LOP3 0xE8; a lane's top bit is
//                                      [a >= b] signed (aH: the sign-
//                                      flipped a's top bit; bH: the
//                                      flipped b's top bit, inverted),
//                                      every other bit 0
//         n  = dp4a(ge, 0x01010101, n) 128 a lane that holds
//     and n >> 7 is the count.  The add is IADD3 (ALU pipe) for 4 of a
//     thread's 8 B rows and IMAD.IADD (FMA pipe, ptxas's choice) for the
//     other 4; the LOP3 is ALU, the dp4a (IDP) FMA, so each pipe takes
//     1.5 of the 3.
//   - A block of 256 threads owns a 128 x 128 output tile, 8 x 8 words a
//     thread (64 counters in registers; 128 registers, 2 blocks an SM),
//     so that each 16-byte shared load feeds 16 word pairs.  Columns run
//     in chunks of 8 words (32 int8 or 16 int16 columns): each thread
//     starts its two 16-byte pieces of the next chunk with cp.async, the
//     block compares this chunk, then each thread forms its landed pieces
//     into the other buffer, one __syncthreads a chunk.  (Staging through
//     registers instead spilled the prefetch at 128 registers.)
//   - The counts stay below 2^32 / 128: a launch takes at most 2^25 - 1
//     columns of the stack, more go to further launches; W >= 2^25 is
//     refused.
// int32 keeps the first design (one pair a word, nothing to pack).
//
// C interface (loaded with ctypes by ops/ss.py):
//   int ss_count_launch(a, b, acc, A, B, W, G, lda, ldb, sga, sgb,
//                       elem_bytes, stream)
//     a, b   int8/int16/int32 (elem_bytes 1/2/4), acc int32 [A, B]
//            contiguous; strides in elements.  For int8/int16, W, the
//            strides and both pointers must be multiples of 16 bytes.
//   Returns cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// ---------------------------------------------------------------- int32

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

// ------------------------------------------------------- int8 and int16

constexpr int RT = 8;          // rows a side a thread (8 x 8 word pairs)
constexpr int PT = 16 * RT;    // rows a side a block
constexpr int PNT = 256;       // threads: 16 x 16
constexpr int KW = 8;          // words a chunk (two 16-byte pieces a row)

// columns j of a thread's 8 whose add is the three-term IADD3 (ALU pipe);
// ptxas emits the other adds as IMAD.IADD (FMA pipe, beside the dp4a)
constexpr int ALU_ADDS = 4;

__device__ __forceinline__ uint32_t maj(uint32_t x, uint32_t y,
                                        uint32_t z) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xE8;" : "=r"(r) : "r"(x), "r"(y), "r"(z));
  return r;
}

// x + y + H as one three-term add, hidden from the front end so that it
// cannot fold y + H into one value per column: ptxas emits IADD3
template <uint32_t H>
__device__ __forceinline__ uint32_t add3(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("{\n\t.reg .u32 t;\n\tadd.u32 t, %1, %2;\n\tadd.u32 %0, t, %3;\n\t}"
      : "=r"(r) : "r"(x), "r"(y), "n"(H));
  return r;
}

struct Smem {
  // the four forms of a staged word, [buffer][word][row]
  uint32_t al[2][KW][PT], ah[2][KW][PT], c[2][KW][PT], bh[2][KW][PT];
  // the raw 16-byte pieces cp.async lands, [row][word]
  uint32_t ra[PT][KW], rb[PT][KW];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}

// rows t*4 .. +3 (i < 4) and 64 + t*4 .. +3 (i >= 4) of a block's side
__device__ __forceinline__ int tile_row(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

__device__ __forceinline__ void put4(uint32_t* d, uint4 v) {
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

// word k of a chunk: the thread's 8 x 8 word pairs into its counters
template <uint32_t H>
__device__ __forceinline__ void compare_word(const Smem& s, int buf, int k,
                                             int ty, int tx,
                                             uint32_t (&n)[RT][RT]) {
  uint32_t al[RT], ah[RT], c[RT], bh[RT];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    put4(al + 4 * h, reinterpret_cast<const uint4*>(s.al[buf][k])[h * 16 + ty]);
    put4(ah + 4 * h, reinterpret_cast<const uint4*>(s.ah[buf][k])[h * 16 + ty]);
    put4(c + 4 * h, reinterpret_cast<const uint4*>(s.c[buf][k])[h * 16 + tx]);
    put4(bh + 4 * h, reinterpret_cast<const uint4*>(s.bh[buf][k])[h * 16 + tx]);
  }
#pragma unroll
  for (int j = ALU_ADDS; j < RT; ++j) c[j] += H;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const uint32_t d = j < ALU_ADDS ? add3<H>(al[i], c[j]) : al[i] + c[j];
      n[i][j] = __dp4a(maj(ah[i], bh[j], d), 0x01010101u, n[i][j]);
    }
}

template <uint32_t H, int KN>
__device__ __forceinline__ void compare_chunk(const Smem& s, int buf, int ty,
                                              int tx, uint32_t (&n)[RT][RT]) {
#pragma unroll 2
  for (int k = 0; k < KN; ++k) compare_word<H>(s, buf, k, ty, tx, n);
}

// a, b: 32-bit words; Wq words a row; lda/ldb/sga/sgb in words, all
// multiples of 4; G * Wq * 32 / bits < 2^25 (the launcher splits the stack)
template <uint32_t H>
__global__ void __launch_bounds__(PNT, 2)
ss_count_packed_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       int32_t* __restrict__ acc, int A, int B, int Wq,
                       int G, long long lda, long long ldb, long long sga,
                       long long sgb) {
  __shared__ __align__(16) Smem s;

  const int a0 = blockIdx.y * PT;
  const int b0 = blockIdx.x * PT;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  // the 16-byte pieces of a chunk: thread t takes piece t of each side,
  // row t / 2, words (t % 2) * 4 .. +3
  const int row = tid / 2;
  const int k4 = tid % 2 * 4;
  const bool a_in = a0 + row < A;
  const bool b_in = b0 + row < B;
  const uint32_t* pa = a + (size_t)(a_in ? a0 + row : 0) * lda + k4;
  const uint32_t* pb = b + (size_t)(b_in ? b0 + row : 0) * ldb + k4;
  uint4* raw_a = reinterpret_cast<uint4*>(&s.ra[row][k4]);
  uint4* raw_b = reinterpret_cast<uint4*>(&s.rb[row][k4]);

  const int chunks = (Wq + KW - 1) / KW;
  const int steps = G * chunks;

  // chunk it's pieces on their way into raw_a / raw_b: the type's minimum
  // (A) and maximum (B) in every lane past the rows or the words
  auto fetch = [&](int it) {
    const int g = it / chunks;
    const int k = (it - g * chunks) * KW;
    if (a_in && k + k4 < Wq) cp_async16(raw_a, pa + (size_t)g * sga + k);
    else *raw_a = make_uint4(H, H, H, H);
    if (b_in && k + k4 < Wq) cp_async16(raw_b, pb + (size_t)g * sgb + k);
    else *raw_b = make_uint4(~H, ~H, ~H, ~H);
    asm volatile("cp.async.commit_group;");
  };
  // the landed pieces' four forms into buffer buf
  auto land = [&](int buf) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    const uint4 wa = *raw_a, wb = *raw_b;
    const uint32_t xa[4] = {wa.x, wa.y, wa.z, wa.w};
    const uint32_t xb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s.al[buf][k4 + q][row] = xa[q] & ~H;
      s.ah[buf][k4 + q][row] = ~xa[q] & H;
      s.c[buf][k4 + q][row] = 0u - (xb[q] & ~H);
      s.bh[buf][k4 + q][row] = xb[q] & H;
    }
  };

  uint32_t n[RT][RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) n[i][j] = 0;

  fetch(0);
  land(0);
  __syncthreads();
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) fetch(it + 1);
    if (Wq - it % chunks * KW >= KW) {
      compare_chunk<H, KW>(s, it & 1, ty, tx, n);
    } else {
      compare_chunk<H, KW / 2>(s, it & 1, ty, tx, n);   // Wq % 4 == 0
    }
    if (it + 1 < steps) land((it + 1) & 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int x = a0 + tile_row(ty, i);
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int y = b0 + tile_row(tx, j);
      if (x < A && y < B) acc[(size_t)x * B + y] += (int32_t)(n[i][j] >> 7);
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

template <uint32_t H>
int launch_packed(const void* a, const void* b, void* acc, int A, int B,
                  int W, int G, long long lda, long long ldb,
                  long long sga, long long sgb, int elem,
                  cudaStream_t stream) {
  const int per16 = 16 / elem;   // elements in 16 bytes
  const int per4 = 4 / elem;     // elements in a word
  if (W % per16 || lda % per16 || ldb % per16 || sga % per16 ||
      sgb % per16 || W >= (1 << 25)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if ((A + PT - 1) / PT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // at most 2^25 - 1 hits a launch: n (128 a hit) stays below 2^32
  const int g_launch = ((1 << 25) - 1) / W;
  const dim3 grid((B + PT - 1) / PT, (A + PT - 1) / PT);
  for (int g0 = 0; g0 < G; g0 += g_launch) {
    const int gn = G - g0 < g_launch ? G - g0 : g_launch;
    ss_count_packed_kernel<H><<<grid, PNT, 0, stream>>>(
        static_cast<const uint32_t*>(a) + g0 * (sga / per4),
        static_cast<const uint32_t*>(b) + g0 * (sgb / per4),
        static_cast<int32_t*>(acc), A, B, W / per4, gn, lda / per4,
        ldb / per4, sga / per4, sgb / per4);
  }
  return 0;
}

}  // namespace

extern "C" int ss_count_launch(const void* a, const void* b, void* acc,
                               int A, int B, int W, int G, long long lda,
                               long long ldb, long long sga, long long sgb,
                               int elem_bytes, void* stream) {
  if (A <= 0 || B <= 0 || W <= 0 || G <= 0) return 0;   // nothing to add
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  switch (elem_bytes) {
    case 1:
      rc = launch_packed<0x80808080u>(a, b, acc, A, B, W, G, lda, ldb, sga,
                                      sgb, 1, s);
      break;
    case 2:
      rc = launch_packed<0x80008000u>(a, b, acc, A, B, W, G, lda, ldb, sga,
                                      sgb, 2, s);
      break;
    case 4:
      if ((A + TA - 1) / TA > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      launch<int32_t>(a, b, acc, A, B, W, G, lda, ldb, sga, sgb, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
