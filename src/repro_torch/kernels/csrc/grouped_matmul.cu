// Grouped matmul over rows sorted by group (expert):
//   y[i] = x[i] . w[e], for every row i in [offsets[e], offsets[e + 1]),
// x (T, K), w (E, K, N), y (T, N), f32 accumulation, one rounding to the
// element type.  offsets (E + 1,) int32 are nondecreasing with offsets[0] = 0
// and offsets[E] = T; they stay on the device, so a launch reads nothing back
// to the host and a CUDA graph can hold it.
//
// Replaces no TPU kernel.  It is the port's own kernel for
// jax.lax.ragged_dot, the three grouped products of the dropless MoE layer
// (repro/models/moe.py::_apply_dropless), which the reference leaves to XLA.
//
// What bounds it on the H100: the weight bytes of the experts that hold rows.
// At qwen3-moe-30b-a3b's decode (8 slots x top-8 = 64 rows, about 52 of the
// 128 experts selected) one product reads ~52 x 2048 x 768 x 2 B = 0.16 GB,
// ~0.049 ms at 3.35 TB/s, for 0.2 GFLOP; at a prefill of 384 tokens (3072
// rows, every expert selected) 0.40 GB against 9.7 GFLOP, 0.12 ms of bytes
// against 0.0098 ms of bf16 tensor-core time.  So the design streams each
// selected expert's weights once and skips the others.
//
// Two designs, chosen by the wrapper (repro_torch/kernels/grouped_matmul/
// kernel.py::plan) and checked here:
//
// 1. Tensor cores (bf16; K and N multiples of 8, 16-byte aligned rows):
//    one block per (expert, 64-column tile), 4 warps.  The block reads its
//    expert's row range from the offsets and returns at once when it is
//    empty.  It walks the rows in passes of up to 64 (four m16 tiles); a pass
//    streams the block's weight tile (K x 64) through a ring of 4 cp.async
//    stages of 64 K rows, with the pass's x rows beside it, and each warp
//    runs mma.sync m16n8k16 (bf16 in, f32 accumulate) on its 16 columns for
//    the m16 tiles that hold rows: a decode pass of 1-16 rows runs one.
//    An expert of more than 64 rows passes over its tile again, from L2 (a
//    tile is K x 128 bytes, 256 KB at K 2048).
// 2. CUDA cores (f32, or bf16 that design 1 does not take): the same grid;
//    passes of 16 rows, x and w staged in shared memory as f32 32 K rows at
//    a time, each thread 4 columns of one row by FMA.
//
// No split across blocks and no atomics: a row's sum runs in a fixed order
// inside one warp (design 1) or thread (design 2), whatever the other rows
// hold, so a replayed launch gives an eager one's bits.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
enum Design { kCudaCore = 0, kTensorCore = 1 };

__host__ __device__ inline long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// -- design 1: tensor cores ---------------------------------------------------
constexpr int kBM = 64, kBN = 64, kBK = 64, kStages = 4, kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;                       // bf16 elements a smem row is padded by
constexpr int kXS = kBK + kPad;               // x tile row stride (elements)
constexpr int kWS = kBN + kPad;               // w tile row stride (elements)
constexpr int kStageElems = kBM * kXS + kBK * kWS;
constexpr int kSmemTC = kStages * kStageElems * 2;

// One stage: x rows [m0, m0 + rows) of the pass (rows <= kBM; zero past
// `end` and K), w rows [k0, k0 + kBK) x columns [n0, n0 + kBN) of the
// expert (zero past K and N).  K and N are multiples of 8, so a 16-byte
// chunk is all in or all out.
__device__ __forceinline__ void load_stage(bf16* xs, bf16* ws, const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, long long x_sm,
                                           int m0, int rows, int end, int k0, int K,
                                           int n0, int N) {
  constexpr int XCH = kBK / 8;
  for (int c = threadIdx.x; c < rows * XCH; c += kThreads) {
    const int r = c / XCH, kk = (c % XCH) * 8, gm = m0 + r, gk = k0 + kk;
    const bool ok = gm < end && gk < K;
    cp_async16(xs + r * kXS + kk, ok ? x + gm * x_sm + gk : x, ok);
  }
  constexpr int WCH = kBN / 8;
  for (int c = threadIdx.x; c < kBK * WCH; c += kThreads) {
    const int r = c / WCH, nn = (c % WCH) * 8, gk = k0 + r, gn = n0 + nn;
    const bool ok = gk < K && gn < N;
    cp_async16(ws + r * kWS + nn, ok ? w + (long long)gk * N + gn : w, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
grouped_matmul_tc(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const int* __restrict__ offsets, bf16* __restrict__ y, int K, int N,
                  long long x_sm) {
  const int e = blockIdx.x, n0 = blockIdx.y * kBN;
  const int beg = offsets[e], end = offsets[e + 1];
  if (beg >= end) return;                     // an expert with no rows
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* base = reinterpret_cast<bf16*>(smem);
  const bf16* we = w + (long long)e * K * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp * 16;                   // the warp's 16 columns of the tile
  const int n_k = (int)cdiv(K, kBK);

  for (int m0 = beg; m0 < end; m0 += kBM) {
    const int n_mt = min(kBM / 16, (end - m0 + 15) / 16);   // m16 tiles holding rows
    const int rows = n_mt * 16;
    float acc[kBM / 16][2][4];
#pragma unroll
    for (int i = 0; i < kBM / 16; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_k) {
        bf16* st = base + s * kStageElems;
        load_stage(st, st + kBM * kXS, x, we, x_sm, m0, rows, end, s * kBK, K, n0, N);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int nk = kt + kStages - 1;        // refill the stage read last iteration
      if (nk < n_k) {
        bf16* st = base + (nk % kStages) * kStageElems;
        load_stage(st, st + kBM * kXS, x, we, x_sm, m0, rows, end, nk * kBK, K, n0, N);
      }
      cp_async_commit();
      const bf16* xs = base + (kt % kStages) * kStageElems;
      const bf16* ws = xs + kBM * kXS;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        // B: k rows kk..kk+15 x the warp's 16 columns, two n8 fragments
        uint32_t b[4];
        ldmatrix_x4_trans(b, ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kWS +
                                 wn + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < kBM / 16; ++mt) {
          if (mt < n_mt) {
            uint32_t a[4];
            ldmatrix_x4(a, xs + (mt * 16 + (lane & 15)) * kXS + kk + (lane >> 4) * 8);
            mma_bf16(acc[mt][0], a, b[0], b[1]);
            mma_bf16(acc[mt][1], a, b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                          // the next pass reuses the ring

    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < kBM / 16; ++mt) {
      if (mt >= n_mt) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + wn + nt * 8 + 2 * t;
        if (col >= N) continue;               // N is even: col + 1 < N too
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + mt * 16 + g + 8 * h;
          if (row < end)
            *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * N + col) =
                __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
    }
  }
}

// -- design 2: CUDA cores -----------------------------------------------------
constexpr int kCM = 16, kCN = 64, kCK = 32, kCThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCThreads)
grouped_matmul_cc(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ offsets, T* __restrict__ y, int K, int N,
                  long long x_sm) {
  const int e = blockIdx.x, n0 = blockIdx.y * kCN;
  const int beg = offsets[e], end = offsets[e + 1];
  if (beg >= end) return;
  __shared__ float xs[kCM][kCK];
  __shared__ float ws[kCK][kCN + 1];
  const T* we = w + (long long)e * K * N;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;   // row, 4 columns
  for (int m0 = beg; m0 < end; m0 += kCM) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += kCK) {
      for (int i = threadIdx.x; i < kCM * kCK; i += kCThreads) {
        const int r = i / kCK, kk = i % kCK, gm = m0 + r, gk = k0 + kk;
        xs[r][kk] = gm < end && gk < K ? repro_to_f32(x[gm * x_sm + gk]) : 0.f;
      }
      for (int i = threadIdx.x; i < kCK * kCN; i += kCThreads) {
        const int r = i / kCN, nn = i % kCN, gk = k0 + r, gn = n0 + nn;
        ws[r][nn] = gk < K && gn < N ? repro_to_f32(we[(long long)gk * N + gn]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kCK; ++kk) {
        const float xv = xs[ty][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(xv, ws[kk][tx * 4 + j], acc[j]);
      }
      __syncthreads();
    }
    const int row = m0 + ty;
    if (row < end) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < N) y[(long long)row * N + col] = repro_from_f32<T>(acc[j]);
      }
    }
  }
}

}  // namespace

// Returns the launch's cudaError_t.  design: 1 tensor cores (bf16 only; K
// and N multiples of 8, x, w and y 16-byte aligned, x_sm a multiple of 8),
// 0 CUDA cores (bf16 or f32, any shape).
extern "C" int repro_grouped_matmul(const void* x, const void* w, const void* offsets,
                                    void* y, int E, int K, int N, long long x_sm, int dtype,
                                    int design, void* stream) {
  if (E < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (design == kTensorCore) {
    const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    if (dtype != REPRO_BF16 || K % 8 || N % 8 || x_sm % 8 || !a16(x) || !a16(w) || !a16(y))
      return cudaErrorInvalidValue;
    const cudaError_t err = repro_smem_limit<grouped_matmul_tc>(kSmemTC);
    if (err != cudaSuccess) return err;
    const dim3 grid(E, (unsigned)cdiv(N, kBN));
    grouped_matmul_tc<<<grid, kThreads, kSmemTC, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), off,
        static_cast<bf16*>(y), K, N, x_sm);
    return cudaGetLastError();
  }
  if (design != kCudaCore) return cudaErrorInvalidValue;
  const dim3 grid(E, (unsigned)cdiv(N, kCN));
  if (dtype == REPRO_BF16)
    grouped_matmul_cc<bf16><<<grid, kCThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), off,
        static_cast<bf16*>(y), K, N, x_sm);
  else if (dtype == REPRO_F32)
    grouped_matmul_cc<float><<<grid, kCThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), off,
        static_cast<float*>(y), K, N, x_sm);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
