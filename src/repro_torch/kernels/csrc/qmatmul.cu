// Dequantise-matmul over int8 / packed-int4 weight codes:
// out (M, N) = x (M, K) . (float(code) * scale), f32 accumulation, one
// rounding to x's dtype at the end.
//
// Replaces two TPU kernels, which compute the same contraction and differ
// only in where the scales sit:
// - repro/quant/kernel.py::quant_matmul_pallas (_qmm_kernel): int8 (K, N)
//   or packed int4 (K/2, N) codes, scales (1, N) per channel or (K/g, N)
//   per group of g rows of K;
// - repro/kernels/pim_mvm/kernel.py::pim_mvm_pallas (_pim_mvm_kernel): int8
//   codes with one scale per 128x128 crossbar tile, (K/128, N/128).
// One template covers both: scale row k / group_rows (group_rows = K per
// channel, g per group, 128 per tile), scale column n or n / 128.
//
// What bounds it on the H100: at serving's decode (M = 8 slots) the weight
// bytes.  qwen2.5-3b streams 2.78 GB of int8 codes a step, 0.83 ms at
// 3.35 TB/s (half that at int4), for 2 * M flops per code.  At the chunk
// step (M = 1024) it is the flops: about 5.7 TFLOP a step, whose bound is
// the bf16 tensor-core rate (989 TFLOP/s): the codes are exact in bf16, so
// mma on (x, codes) with f32 accumulation and the scales applied per
// column, group or tile computes the same function.  This kernel runs them
// on CUDA cores in f32 (67 TFLOP/s peak), about 15x below that bound: mma
// on the dequantised weight would round it to bf16, which the TPU kernel
// does not, and mma on the codes is later work.
//
// Design: one block of 256 threads per (BM-row, BN-column) output tile
// and K split.  A K loop stages 32 rows at a time: x into shared memory as
// f32, and the codes, read 16 bytes a thread coalesced along N, unpacked
// (int4: byte i of column n holds rows 2i in the low nibble and 2i+1 in
// the high one), dequantised as float(code) * scale and stored as f32.
// Each thread then accumulates a TM x TN register tile with FMA, reading
// its TM rows of x as float4 broadcasts.  Two tiles: at M <= 8 (decode at
// 8 slots) 8 x 256, every thread holding all rows of one column, so each
// weight read from shared memory feeds 8 FMAs and no row is computed for
// nothing; otherwise 64 x 128 with 8 x 4 a thread.  Ragged M, N and K are
// masked, so every shape runs (K = 11008 and M = 3 included).  With few
// output tiles (decode) K is split across blocks so the card has enough
// loads in flight (repro_dequant_matmul_k_split, which the wrapper asks
// before it sizes the workspace); the partial sums go to an f32 workspace
// and a second kernel adds them in a fixed order and rounds once.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;  // K rows per shared-memory stage

// A block's output tile: BM x BN, each thread TM contiguous rows and TN
// columns tx + TX j (TX threads along N).
template <int BM_, int BN_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, TX = BN / TN;
  static_assert(BM / TM * TX == kThreads, "one thread per TM x TN sub-tile");
  static_assert(TM % 4 == 0 && BN % 16 == 0, "float4 x reads, 16-column code loads");
};
using DecodeTile = Tile<8, 256, 8, 1>;  // M <= 8
using WideTile = Tile<64, 128, 8, 4>;

// The one place the tile is chosen: the launch and the K split both ask.
template <typename F>
auto with_tile(int M, F f) {
  return M <= DecodeTile::BM ? f(DecodeTile{}) : f(WideTile{});
}

union Codes16 {
  uint4 v;
  int8_t c[16];
};

template <typename T, int BITS, bool TILE, typename Cfg>
__global__ void __launch_bounds__(kThreads) dequant_matmul_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, T* __restrict__ out, float* __restrict__ ws,
    int M, int K, int N, long long x_sm, int group_rows, int k_split, int vec) {
  constexpr int BM = Cfg::BM, BN = Cfg::BN, TM = Cfg::TM, TN = Cfg::TN, TX = Cfg::TX;
  constexpr int kPack = BITS == 4 ? 2 : 1;          // K rows per code byte
  constexpr int kLoads = kBK / kPack * (BN / 16);   // 16-byte code loads a stage
  __shared__ __align__(16) float x_s[kBK][BM + 4];
  __shared__ __align__(16) float w_s[kBK][BN + 4];

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_beg = blockIdx.z * k_split;
  const int k_end = min(K, k_beg + k_split);
  const int s_cols = TILE ? N / 128 : N;         // length of a scale row

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_beg; k0 < k_end; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int m = e / kBK, kk = e % kBK;
      const int gm = m0 + m, gk = k0 + kk;
      x_s[kk][m] = (gm < M && gk < k_end) ? repro_to_f32(x[gm * x_sm + gk]) : 0.f;
    }
    for (int l = tid; l < kLoads; l += kThreads) {
      const int pr = l / (BN / 16);              // code-byte row in the stage
      const int c0 = (l % (BN / 16)) * 16;       // first column in the tile
      const int gk0 = k0 + pr * kPack;           // first K row of the byte row
      const int gn0 = n0 + c0;
      const long long row = (long long)(gk0 / kPack) * N;
      Codes16 b;
      if (gk0 < k_end && vec && gn0 + 16 <= N) {
        b.v = *reinterpret_cast<const uint4*>(q + row + gn0);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          b.c[i] = (gk0 < k_end && gn0 + i < N) ? q[row + gn0 + i] : 0;
      }
#pragma unroll
      for (int r = 0; r < kPack; ++r) {
        const int gk = gk0 + r;
        const float* srow = scale + (long long)(min(gk, K - 1) / group_rows) * s_cols;
        float s[16];
        if (TILE) {
          const float st = gn0 < N ? srow[gn0 / 128] : 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i) s[i] = st;
        } else if (vec && gn0 + 16 <= N) {
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4) {
            const float4 v4 = reinterpret_cast<const float4*>(srow + gn0)[i4];
            s[4 * i4] = v4.x; s[4 * i4 + 1] = v4.y; s[4 * i4 + 2] = v4.z; s[4 * i4 + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) s[i] = gn0 + i < N ? srow[gn0 + i] : 0.f;
        }
        float w[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          int c = b.c[i];
          if (BITS == 4) c = r == 0 ? static_cast<int8_t>((c & 0x0F) << 4) >> 4 : c >> 4;
          w[i] = gk < k_end ? static_cast<float>(c) * s[i] : 0.f;
        }
        float4* dst = reinterpret_cast<float4*>(&w_s[pr * kPack + r][c0]);
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4)
          dst[i4] = make_float4(w[4 * i4], w[4 * i4 + 1], w[4 * i4 + 2], w[4 * i4 + 3]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], bw[TN];
      const float4* x4 = reinterpret_cast<const float4*>(&x_s[kk][ty * TM]);
#pragma unroll
      for (int i4 = 0; i4 < TM / 4; ++i4) {
        const float4 v4 = x4[i4];  // one broadcast read: 4 rows of x
        a[4 * i4] = v4.x; a[4 * i4 + 1] = v4.y; a[4 * i4 + 2] = v4.z; a[4 * i4 + 3] = v4.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) bw[j] = w_s[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + TX * j;
      if (gn >= N) continue;
      if (ws)
        ws[((long long)blockIdx.z * M + gm) * N + gn] = acc[i][j];
      else
        out[(long long)gm * N + gn] = repro_from_f32<T>(acc[i][j]);
    }
  }
}

// out = the split partial sums, added in split order, rounded once
template <typename T>
__global__ void split_sum_kernel(const float* __restrict__ ws, T* __restrict__ out,
                                 int splits, long long mn) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    out[i] = repro_from_f32<T>(s);
  }
}

template <typename T, int BITS, bool TILE>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, void* ws,
                   int M, int K, int N, long long x_sm, int group_rows, int k_split,
                   int splits, cudaStream_t stream) {
  const int vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(scale) % 16 == 0 && N % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  float* wp = splits > 1 ? static_cast<float*>(ws) : nullptr;
  with_tile(M, [&](auto cfg) {
    using C = decltype(cfg);
    dequant_matmul_kernel<T, BITS, TILE, C>
        <<<dim3((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, splits), kThreads, 0,
           stream>>>(xp, qp, sp, op, wp, M, K, N, x_sm, group_rows, k_split, vec);
    return 0;
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  split_sum_kernel<T><<<blocks, 256, 0, stream>>>(wp, op, splits, mn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* q, const void* scale, void* out, void* ws,
                     int M, int K, int N, long long x_sm, int bits, int group_rows,
                     int tile, int k_split, int splits, cudaStream_t s) {
  if (tile && bits == 8)
    return launch<T, 8, true>(x, q, scale, out, ws, M, K, N, x_sm, group_rows, k_split,
                              splits, s);
  if (!tile && bits == 8)
    return launch<T, 8, false>(x, q, scale, out, ws, M, K, N, x_sm, group_rows, k_split,
                               splits, s);
  if (!tile && bits == 4)
    return launch<T, 4, false>(x, q, scale, out, ws, M, K, N, x_sm, group_rows, k_split,
                               splits, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// K rows per split of the grid (a multiple of 32).  When the output has
// few tiles (decode), about four blocks for each of the card's `sms` SMs
// so that enough loads are in flight, each split at least two stages
// long, and an f32 workspace of at most twice the int8 code bytes.
extern "C" int repro_dequant_matmul_k_split(int M, int K, int N, int sms) {
  const long long tiles = with_tile(M, [&](auto cfg) {
    using C = decltype(cfg);
    return (long long)((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
  });
  long long splits = (4LL * sms + tiles - 1) / tiles;
  splits = std::min<long long>(splits, K / (2 * kBK));
  splits = std::min<long long>(splits, K / (2LL * M));
  splits = std::max<long long>(splits, 1);
  const long long rows = (K + splits - 1) / splits;
  return (int)((rows + kBK - 1) / kBK * kBK);
}

// x (M, K) with row stride x_sm (elements) and a contiguous last dim; q
// contiguous codes, (K, N) int8 or (K/2, N) packed int4; scale contiguous
// f32, (K/group_rows, N), or (K/128, N/128) with tile = 1; out (M, N)
// contiguous, in x's dtype.  K is cut into splits of k_split rows (a
// multiple of 32); with splits > 1, ws holds splits * M * N floats.
// Returns the launches' cudaError_t.
extern "C" int repro_dequant_matmul(const void* x, const void* q, const void* scale,
                                    void* out, void* ws, int M, int K, int N,
                                    long long x_sm, int bits, int group_rows, int tile,
                                    int k_split, int splits, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group_rows <= 0 || splits < 1 || k_split % kBK ||
      (tile && N % 128) || (bits == 4 && K % 2))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return dispatch<__nv_bfloat16>(x, q, scale, out, ws, M, K, N, x_sm, bits, group_rows,
                                   tile, k_split, splits, s);
  if (dtype == REPRO_F32)
    return dispatch<float>(x, q, scale, out, ws, M, K, N, x_sm, bits, group_rows, tile,
                           k_split, splits, s);
  return cudaErrorInvalidValue;
}
