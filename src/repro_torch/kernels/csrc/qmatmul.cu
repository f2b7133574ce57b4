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
// Every kernel here reads scale row k / group_rows (group_rows = K per
// channel, g per group, 128 per tile) and scale column n >> col_shift
// (0, or 7 for the crossbar tiles).
//
// What bounds it on the H100.  At serving's decode (M = 8 slots) the
// weight bytes: qwen2.5-3b streams 2.78 GB of int8 codes a step, 0.83 ms
// at 3.35 TB/s (half that at int4), for 2 * M flops per code.  At the chunk
// step (M = 1024), packed prefill (M <= 128) and the crossbar (M = 256,
// 512) the operations, whose bound is the bf16 tensor-core rate (989
// TFLOP/s, about 0.047 ms for (1024, 2048, 11008)).
//
// The numerics that make tensor cores legal: codes are integers in
// [-128, 127], exact in bf16, and a bf16 x bf16 product is exact in f32.
// So mma on (bf16 x, codes as bf16) with f32 accumulation gives the exact
// products x * code, and the scale, constant over a scale block, is
// applied to each f32 partial sum of one block: per channel once in the
// epilogue, per group or crossbar tile at each group end (acc += scale *
// part, a second register accumulator).  Up to f32 rounding this is the
// plain version's function (dequantise in f32, f32 matmul); the weight is
// never rounded to bf16.
//
// Two designs, chosen in one place (make_plan, which the wrapper asks
// through repro_dequant_matmul_plan and which reports the design it chose):
//
// 1. Tensor cores (bf16 x, per channel or a group that is a multiple of
//    16, the crossbar tiles): mma.sync m16n8k16 bf16 -> f32.  x and the raw
//    code bytes go through a ring of cp.async stages in dynamic shared
//    memory (16-byte copies, zero-filled past M, N and the split's K range,
//    so every shape runs), one barrier a stage.  The codes never exist as
//    bf16 in memory: ldmatrix.trans over the byte tile hands each thread
//    the codes of two K rows in two adjacent columns, which it converts
//    exactly in registers (byte permutes: 2^23 + code + bias, minus 2^23 +
//    bias) into the fragments of two n8 tiles, one of the even columns and
//    one of the odd; for int4 the ldmatrix row order (packed rows 0, 4, 1,
//    5, ...) gives each thread the K rows of its fragment.  Two tiles:
//    - wide (M > 8): 128 x 128 (64 x 128 when there are fewer 128-row
//      tiles than SMs), K step 64 in 4 stages, 8 warps of
//      (BM/2) x 32, x as the A operand and the codes as B;
//    - decode (M <= 8): the operands swapped, out^T (N x M) = codes^T . x^T,
//      so the codes are the 16-row A operand and the <= 8 slots the 8-column
//      B operand; 128 columns a block (16 a warp), 64 code-byte rows a
//      stage in 4 stages, a small block so that several an SM keep the
//      code loads in flight.
//    Measured on the H100 (chip_probe_qmatmul.py): the decode tile streams
//    the codes at about half the HBM rate, below torch.matmul over bf16
//    weights; the wide tile reaches about a fifth of the tensor-core peak,
//    its time split between loading operands, converting codes and the
//    mma, which overlap little.  TMA loads and warp-specialised wgmma are
//    the route to the bound.
// 2. CUDA cores (f32 x, or a group that is not a multiple of 16): the
//    first port's loop.  A K loop stages 32 rows: x into shared memory as f32, the codes
//    dequantised as float(code) * scale into an f32 tile; each thread
//    accumulates a TM x TN register tile with FMA.  Tiles 8 x 256 at M <= 8
//    and 64 x 128 above.
//
// With few output tiles K is split across blocks (grid z).  Each block
// writes its f32 partial tile to a workspace; the last block of an output
// tile to finish (a __threadfence and an atomic ticket, reset for the next
// launch) adds the partials in split order and rounds once: no second
// launch, and the same sums from run to run.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
enum Design { kCudaCore = 0, kTensorCore = 1 };

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Pieces shared by the kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Code bytes -> bf16 mma fragments, in registers.  ldmatrix.trans over
// the raw code tile (two bytes read as one b16) gives a thread, for K rows
// k, k + 1 and columns n, n + 1, the bytes (k, n), (k, n + 1), (k + 1, n),
// (k + 1, n + 1).  Each code converts exactly: 0x4B000000 | (code + bias)
// is the f32 2^23 + code + bias, minus (2^23 + bias) gives the code, an
// integer of at most 8 significant bits, so its bf16 is the upper half of
// its f32 bits.
__device__ __forceinline__ float biased_byte(uint32_t u, uint32_t sel, float magic) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - magic;
}
__device__ __forceinline__ uint32_t bf16x2_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// int8: .x = bf16x2 {(k, n), (k + 1, n)}, .y = {(k, n + 1), (k + 1, n + 1)}
__device__ __forceinline__ uint2 int8_pairs(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;  // signed byte -> code + 128
  const float m = 8388736.f;           // 2^23 + 128
  return make_uint2(bf16x2_hi(biased_byte(u, 0x7440, m), biased_byte(u, 0x7442, m)),
                    bf16x2_hi(biased_byte(u, 0x7441, m), biased_byte(u, 0x7443, m)));
}

// int4: each of the 4 bytes holds K rows 2p (low nibble) and 2p + 1 (high);
// component i = bf16x2 {low, high} of byte i
__device__ __forceinline__ uint4 int4_pairs(uint32_t w) {
  const uint32_t lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;  // nibble -> code + 8
  const uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const float m = 8388616.f;                            // 2^23 + 8
  return make_uint4(bf16x2_hi(biased_byte(lo, 0x7440, m), biased_byte(hi, 0x7440, m)),
                    bf16x2_hi(biased_byte(lo, 0x7441, m), biased_byte(hi, 0x7441, m)),
                    bf16x2_hi(biased_byte(lo, 0x7442, m), biased_byte(hi, 0x7442, m)),
                    bf16x2_hi(biased_byte(lo, 0x7443, m), biased_byte(hi, 0x7443, m)));
}

// The int4 tile's 8 ldmatrix rows of a 16-row K step are packed rows
// 0, 4, 1, 5, 2, 6, 3, 7: a thread then reads packed rows p and p + 4, K
// rows 2p, 2p + 1 and 2p + 8, 2p + 9, the rows of its mma fragment.
__device__ __forceinline__ int int4_row(int r) { return (r >> 1) + 4 * (r & 1); }

// One stage of x: ROWS rows from m0, BK columns from k0, into xs (row
// stride XS elements); zero past M and k_end.  vec: 16-byte copies (x
// 16-byte aligned, x_sm and K multiples of 8, so a chunk is all in or all
// out); else element by element.
template <int ROWS, int BK, int XS>
__device__ __forceinline__ void load_x(bf16* xs, const bf16* __restrict__ x, int M,
                                       long long x_sm, int m0, int k0, int k_end, bool vec) {
  if (vec) {
    constexpr int CH = BK / 8;
    for (int c = threadIdx.x; c < ROWS * CH; c += kThreads) {
      const int r = c / CH, kk = (c % CH) * 8, gm = m0 + r, gk = k0 + kk;
      const bool ok = gm < M && gk < k_end;
      cp_async16(xs + r * XS + kk, ok ? x + gm * x_sm + gk : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * BK; e += kThreads) {
      const int r = e / BK, kk = e % BK, gm = m0 + r, gk = k0 + kk;
      xs[r * XS + kk] = gm < M && gk < k_end ? x[gm * x_sm + gk] : __float2bfloat16(0.f);
    }
  }
}

// One stage of codes: PROWS code-byte rows from p0, BN columns from n0,
// into qs (row stride QS); zero past N and p_end.  vec: 16-byte copies (q
// 16-byte aligned, N a multiple of 16).
template <int PROWS, int BN, int QS>
__device__ __forceinline__ void load_codes(int8_t* qs, const int8_t* __restrict__ q, int N,
                                           int p0, int p_end, int n0, bool vec) {
  if (vec) {
    constexpr int CH = BN / 16;
    for (int c = threadIdx.x; c < PROWS * CH; c += kThreads) {
      const int r = c / CH, cc = (c % CH) * 16, gp = p0 + r, gn = n0 + cc;
      const bool ok = gp < p_end && gn < N;
      cp_async16(qs + r * QS + cc, ok ? q + (long long)gp * N + gn : q, ok);
    }
  } else {
    for (int e = threadIdx.x; e < PROWS * BN; e += kThreads) {
      const int r = e / BN, cc = e % BN, gp = p0 + r, gn = n0 + cc;
      qs[r * QS + cc] = gp < p_end && gn < N ? q[(long long)gp * N + gn] : 0;
    }
  }
}

// Where the scales sit: scale row k / group_rows, column n >> col_shift.
struct Scales {
  const float* __restrict__ p;
  int group_rows, col_shift, cols;
  __device__ __forceinline__ const float* row(int k) const {
    return p + (long long)(k / group_rows) * cols;
  }
  __device__ __forceinline__ float at(const float* srow, int n, int N) const {
    return n < N ? __ldg(srow + (n >> col_shift)) : 0.f;
  }
};

// The scale groups of a block's K range [k_beg, k_end), walked 16 rows at
// a time with no division in the loop: start() at a 16-row step says
// whether a group begins there (and moves `srow` to its scale row), and
// end() after the step whether it was the group's last.  group_rows is a
// multiple of 16, and so are k_beg and, with grouped scales, K.
struct GroupWalk {
  const float* srow;
  int left, next, group_rows;
  __device__ __forceinline__ GroupWalk(const Scales& s, int k_beg)
      : srow(s.row(k_beg) - s.cols), left(0),
        next(s.group_rows - k_beg % s.group_rows), group_rows(s.group_rows) {}
  __device__ __forceinline__ bool start(const Scales& s, int gk, int k_end) {
    if (left > 0) return false;
    srow += s.cols;
    left = min(next, k_end - gk);
    next = group_rows;
    return true;
  }
  __device__ __forceinline__ bool end() { return (left -= 16) == 0; }
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

// (m, n .. n + 3) of a row-major M x N matrix; n is a multiple of 4
template <typename T>
__device__ __forceinline__ void put4(T* dst, int M, int N, int m, int n, float4 v) {
  if (m >= M || n >= N) return;
  T* p = dst + (long long)m * N + n;
  if (n + 3 < N && N % 4 == 0) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                *reinterpret_cast<const uint32_t*>(&hi));
    }
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
    for (int c = 0; c < 4 && n + c < N; ++c) put(p + c, e[c]);
  }
}

// After a block has written its partial tile (m0, n0, BM x BN) to split
// blockIdx.z of ws (splits x M x N f32): the last block of the tile to
// finish adds the splits in order, rounds once into out, and resets the
// tile's ticket for the next launch.  Each thread owns V runs of 4
// columns, taken VB at a time; it loads kBatch (split, run) pairs
// before adding them in split order, so that loads are in flight
// together.  The arrays are small: this code is part of every kernel, and
// its registers would cost the main loop blocks an SM.
template <int BM, int BN, typename T>
__device__ void reduce_splits(const float* ws, T* __restrict__ out, int* tickets, int M,
                              int N, int m0, int n0) {
  constexpr int V = (BM * BN / 4 + kThreads - 1) / kThreads, VB = V < 8 ? V : 8;
  constexpr int kBatch = BM > 8 ? VB : 4 * VB;
  static_assert(V % VB == 0, "runs in whole groups");
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* t = tickets + blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(t, 1) == (int)gridDim.z - 1;
    if (last) *t = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long mn = (long long)M * N;
  const int splits = gridDim.z;
  const bool vec = N % 4 == 0;
#pragma unroll 1
  for (int v0 = 0; v0 < V; v0 += VB) {
    float4 sum[VB];
    int col[VB], row[VB];
#pragma unroll
    for (int v = 0; v < VB; ++v) {
      const int e = (threadIdx.x + (v0 + v) * kThreads) * 4;
      sum[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      row[v] = e < BM * BN ? m0 + e / BN : M;  // M: nothing to do
      col[v] = n0 + e % BN;
    }
    for (int z0 = 0; z0 < splits; z0 += kBatch / VB) {
      float4 part[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {  // split z0 + b / VB, run b % VB
        const int z = z0 + b / VB, v = b % VB, m = row[v], n = col[v];
        part[b] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (z >= splits || m >= M || n >= N) continue;
        const float* p = ws + z * mn + (long long)m * N + n;
        if (vec) {
          part[b] = __ldcg(reinterpret_cast<const float4*>(p));
        } else {
          part[b].x = __ldcg(p);
          if (n + 1 < N) part[b].y = __ldcg(p + 1);
          if (n + 2 < N) part[b].z = __ldcg(p + 2);
          if (n + 3 < N) part[b].w = __ldcg(p + 3);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        float4& s = sum[b % VB];
        s.x += part[b].x; s.y += part[b].y; s.z += part[b].z; s.w += part[b].w;
      }
    }
#pragma unroll
    for (int v = 0; v < VB; ++v) put4(out, M, N, row[v], col[v], sum[v]);
  }
}

struct Args {
  const void* x;
  const int8_t* q;
  Scales s;
  void* out;
  float* ws;
  int* tickets;
  int M, K, N;
  long long x_sm;
  int k_split;
  bool vec_x, vec_q;
};

// ---------------------------------------------------------------------------
// Design 1, tensor cores, wide tile (M > 8)
// ---------------------------------------------------------------------------

template <int BM_, int BITS>
struct Wide {
  static constexpr int BM = BM_, BN = 128, BK = 64, STAGES = 4;
  static constexpr int MI = BM / 32, NI = 4;  // a warp's m16 and n8 tiles (2 x 4 warps)
  static constexpr int PACK = BITS == 4 ? 2 : 1, PROWS = BK / PACK;
  static constexpr int XS = BK + 8, QS = BN + 16;  // padded rows: ldmatrix without conflicts
  static constexpr size_t kXs = (size_t)STAGES * BM * XS * 2;
  static constexpr size_t kSmem = kXs + (size_t)STAGES * PROWS * QS;
};

// 2 x 4 warps, each (BM/2) x 32: MI m16 tiles of x (A, ldmatrix) by 4 n8
// tiles of codes (B, ldmatrix.trans on the raw bytes).  The n8 tiles come
// in pairs over 16 columns: tile 2p takes the even columns of pair p, tile
// 2p + 1 the odd ones, so a thread's accumulator holds columns
// wn*32 + 16p + 4t + {0, 1, 2, 3} (t = lane % 4) of rows g and g + 8.
template <typename C, int BITS, bool GROUPED>
__global__ void __launch_bounds__(kThreads, GROUPED && C::BM == 128 ? 1 : 2)
tc_wide_kernel(Args a) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, ST = C::STAGES, MI = C::MI, NI = C::NI;
  constexpr int PACK = C::PACK, PROWS = C::PROWS, XS = C::XS, QS = C::QS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);               // [ST][BM][XS]
  int8_t* qs = reinterpret_cast<int8_t*>(smem + C::kXs);  // [ST][PROWS][QS]

  const bf16* x = static_cast<const bf16*>(a.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_beg = blockIdx.z * a.k_split, k_end = min(a.K, k_beg + a.k_split);
  const int nk = (k_end - k_beg + BK - 1) / BK;
  const int ncol = n0 + wn * 32 + 4 * (lane & 3);  // + 16p + {0..3}: the thread's columns

  float acc[MI][NI][4], part[MI][NI][4], sc[2][4];
  GroupWalk gw(a.s, k_beg);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = part[i][j][c] = 0.f;

  auto load = [&](int it) {
    const int k0 = k_beg + it * BK, s = it % ST;
    load_x<BM, BK, XS>(xs + s * BM * XS, x, a.M, a.x_sm, m0, k0, k_end, a.vec_x);
    load_codes<PROWS, BN, QS>(qs + s * PROWS * QS, a.q, a.N, k0 / PACK, k_end / PACK, n0,
                              a.vec_q);
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // stage it landed; every warp is done with stage it - 1
    if (it + ST - 1 < nk) load(it + ST - 1);
    cp_async_commit();
    const bf16* xt = xs + (it % ST) * BM * XS;
    const int8_t* qt = qs + (it % ST) * PROWS * QS;
    const int k0 = k_beg + it * BK;
#pragma unroll
    for (int k32 = 0; k32 < BK / 32; ++k32) {
      if (k0 + k32 * 32 >= k_end) break;
      uint32_t bfr[2][NI][2];  // [k16 step][n8 tile][b0b1, b2b3]
      if (BITS == 8) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t r[4];  // pair 0 rows 0-7, 8-15; pair 1 rows 0-7, 8-15
          ldmatrix_x4_trans(r, qt + (k32 * 32 + h * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * QS +
                                   wn * 32 + (lane >> 4) * 16);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint2 lo = int8_pairs(r[2 * p]), hi = int8_pairs(r[2 * p + 1]);
            bfr[h][2 * p][0] = lo.x; bfr[h][2 * p][1] = hi.x;
            bfr[h][2 * p + 1][0] = lo.y; bfr[h][2 * p + 1][1] = hi.y;
          }
        }
      } else {
        uint32_t r[4];  // [k16 step h][pair p] at 2h + p
        ldmatrix_x4_trans(r, qt + (k32 * 16 + (lane >> 4) * 8 + int4_row(lane & 7)) * QS +
                                 wn * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint4 v = int4_pairs(r[2 * h + p]);
            bfr[h][2 * p][0] = v.x; bfr[h][2 * p][1] = v.z;
            bfr[h][2 * p + 1][0] = v.y; bfr[h][2 * p + 1][1] = v.w;
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gk = k0 + k32 * 32 + h * 16;
        if (gk >= k_end) break;
        if (GROUPED && gw.start(a.s, gk, k_end)) {
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[p][c] = a.s.at(gw.srow, ncol + 16 * p + c, a.N);
        }
        uint32_t af[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          ldmatrix_x4(af[i], xt + (wm * (BM / 2) + i * 16 + (lane & 15)) * XS + k32 * 32 +
                                 h * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
            mma_bf16(GROUPED ? part[i][j] : acc[i][j], af[i], bfr[h][j][0], bfr[h][j][1]);
        if (GROUPED && gw.end()) {
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) {  // column 16p + 2(c & 1) + e of tile j = 2p + e
                acc[i][j][c] = fmaf(sc[j >> 1][2 * (c & 1) + (j & 1)], part[i][j][c], acc[i][j][c]);
                part[i][j][c] = 0.f;
              }
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  bf16* out = static_cast<bf16*>(a.out);
  float* ws = a.ws + (long long)blockIdx.z * a.M * a.N;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = GROUPED ? 1.f : a.s.at(a.s.p, ncol + 16 * p + c, a.N);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * (BM / 2) + i * 16 + (lane >> 2) + h * 8;
        const float* ev = acc[i][2 * p];      // columns + 0, + 2
        const float* od = acc[i][2 * p + 1];  // columns + 1, + 3
        const float4 v = make_float4(ev[2 * h] * s[0], od[2 * h] * s[1],
                                     ev[2 * h + 1] * s[2], od[2 * h + 1] * s[3]);
        if (split)
          put4(ws, a.M, a.N, m, ncol + 16 * p, v);
        else
          put4(out, a.M, a.N, m, ncol + 16 * p, v);
      }
  }
  if (split) reduce_splits<BM, BN>(a.ws, out, a.tickets, a.M, a.N, m0, n0);
}

// ---------------------------------------------------------------------------
// Design 1, tensor cores, decode tile (M <= 8): out^T = codes^T . x^T
// ---------------------------------------------------------------------------

template <int BITS>
struct Dec {
  static constexpr int PACK = BITS == 4 ? 2 : 1;
  // 8 warps x 16 columns; 64 code-byte rows a stage (K step 64 or 128)
  static constexpr int BM = 8, BN = 128, BK = 64 * PACK, STAGES = 4, PROWS = BK / PACK;
  static constexpr int XS = BK + 8, QS = BN + 16;
  static constexpr size_t kXs = (size_t)STAGES * BM * XS * 2;
  static constexpr size_t kSmem = kXs + (size_t)STAGES * PROWS * QS;
};

// A warp's 16 columns are the 16 rows of the mma's A operand: row g is
// column 2g, row g + 8 column 2g + 1 (both halves of one ldmatrix.trans
// register), so a thread's accumulator holds columns nw + {0, 1}
// (nw = n0 + 16 warp + 2g) of slots 2t, 2t + 1.
template <int BITS, bool GROUPED>
__global__ void __launch_bounds__(kThreads) tc_decode_kernel(Args a) {
  using C = Dec<BITS>;
  constexpr int BN = C::BN, BK = C::BK, ST = C::STAGES, PACK = C::PACK, PROWS = C::PROWS;
  constexpr int XS = C::XS, QS = C::QS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);               // [ST][8][XS]
  int8_t* qs = reinterpret_cast<int8_t*>(smem + C::kXs);  // [ST][PROWS][QS]

  const bf16* x = static_cast<const bf16*>(a.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * BN;
  const int k_beg = blockIdx.z * a.k_split, k_end = min(a.K, k_beg + a.k_split);
  const int nk = (k_end - k_beg + BK - 1) / BK;
  const int nw = n0 + warp * 16 + 2 * (lane >> 2), cm = 2 * (lane & 3);

  float acc[4] = {0.f, 0.f, 0.f, 0.f}, part[4] = {0.f, 0.f, 0.f, 0.f}, sc[2];
  GroupWalk gw(a.s, k_beg);

  auto load = [&](int it) {
    const int k0 = k_beg + it * BK, s = it % ST;
    load_x<8, BK, XS>(xs + s * 8 * XS, x, a.M, a.x_sm, 0, k0, k_end, a.vec_x);
    load_codes<PROWS, BN, QS>(qs + s * PROWS * QS, a.q, a.N, k0 / PACK, k_end / PACK, n0,
                              a.vec_q);
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    if (it + ST - 1 < nk) load(it + ST - 1);
    cp_async_commit();
    const bf16* xt = xs + (it % ST) * 8 * XS;
    const int8_t* qt = qs + (it % ST) * PROWS * QS;
    const int k0 = k_beg + it * BK;
    uint32_t afr[BK / 16][4];  // codes^T fragments of the stage's k16 steps
    if (BITS == 8) {
#pragma unroll
      for (int k32 = 0; k32 < BK / 32; ++k32) {
        uint32_t r[4];  // K rows 0-7, 8-15 of step 2 k32, then of step 2 k32 + 1
        ldmatrix_x4_trans(r, qt + (k32 * 32 + (lane >> 3) * 8 + (lane & 7)) * QS + warp * 16);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 lo = int8_pairs(r[2 * h]), hi = int8_pairs(r[2 * h + 1]);
          afr[2 * k32 + h][0] = lo.x; afr[2 * k32 + h][1] = lo.y;
          afr[2 * k32 + h][2] = hi.x; afr[2 * k32 + h][3] = hi.y;
        }
      }
    } else {
#pragma unroll
      for (int k64 = 0; k64 < BK / 64; ++k64) {
        uint32_t r[4];  // one register a k16 step
        ldmatrix_x4_trans(r, qt + (k64 * 32 + (lane >> 3) * 8 + int4_row(lane & 7)) * QS +
                                 warp * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint4 v = int4_pairs(r[j]);
          afr[4 * k64 + j][0] = v.x; afr[4 * k64 + j][1] = v.y;
          afr[4 * k64 + j][2] = v.z; afr[4 * k64 + j][3] = v.w;
        }
      }
    }
#pragma unroll
    for (int k32 = 0; k32 < BK / 32; ++k32) {
      if (k0 + k32 * 32 >= k_end) break;
      uint32_t xf[4];  // x^T fragments of two k16 steps
      ldmatrix_x4(xf, xt + (lane & 7) * XS + k32 * 32 + (lane >> 3) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = 2 * k32 + h, gk = k0 + ks * 16;
        if (gk >= k_end) break;
        if (GROUPED && gw.start(a.s, gk, k_end)) {
          sc[0] = a.s.at(gw.srow, nw, a.N);
          sc[1] = a.s.at(gw.srow, nw + 1, a.N);
        }
        mma_bf16(GROUPED ? part : acc, afr[ks], xf[2 * h], xf[2 * h + 1]);
        if (GROUPED && gw.end()) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[c] = fmaf(sc[c >> 1], part[c], acc[c]);
            part[c] = 0.f;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  bf16* out = static_cast<bf16*>(a.out);
  float* ws = a.ws + (long long)blockIdx.z * a.M * a.N;
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // c: column nw + (c >> 1), slot cm + (c & 1)
    const int n = nw + (c >> 1), m = cm + (c & 1);
    if (m >= a.M || n >= a.N) continue;
    const float v = acc[c] * (GROUPED ? 1.f : a.s.at(a.s.p, n, a.N));
    if (split)
      ws[(long long)m * a.N + n] = v;
    else
      put(out + (long long)m * a.N + n, v);
  }
  if (split) reduce_splits<8, BN>(a.ws, out, a.tickets, a.M, a.N, 0, n0);
}

// ---------------------------------------------------------------------------
// Design 2, CUDA cores (f32 x, or a group that is not a multiple of 16)
// ---------------------------------------------------------------------------

// A block's output tile: BM x BN, each thread TM contiguous rows and TN
// columns tx + TX j (TX threads along N).
template <int BM_, int BN_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, TX = BN / TN;
  static_assert(BM / TM * TX == kThreads, "one thread per TM x TN sub-tile");
  static_assert(TM % 4 == 0 && BN % 16 == 0, "float4 x reads, 16-column code loads");
};
using CoreDecodeTile = Tile<8, 256, 8, 1>;  // M <= 8
using CoreWideTile = Tile<64, 128, 8, 4>;
constexpr int kCoreBK = 32;  // K rows per shared-memory stage

union Codes16 {
  uint4 v;
  int8_t c[16];
};

template <typename T, int BITS, typename Cfg>
__global__ void __launch_bounds__(kThreads) cuda_core_kernel(Args a) {
  constexpr int BM = Cfg::BM, BN = Cfg::BN, TM = Cfg::TM, TN = Cfg::TN, TX = Cfg::TX;
  constexpr int kBK = kCoreBK;
  constexpr int kPack = BITS == 4 ? 2 : 1;          // K rows per code byte
  constexpr int kLoads = kBK / kPack * (BN / 16);   // 16-byte code loads a stage
  __shared__ __align__(16) float x_s[kBK][BM + 4];
  __shared__ __align__(16) float w_s[kBK][BN + 4];

  const T* x = static_cast<const T*>(a.x);
  const int8_t* q = a.q;
  const int M = a.M, K = a.K, N = a.N;
  const bool vec = a.vec_q;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_beg = blockIdx.z * a.k_split;
  const int k_end = min(K, k_beg + a.k_split);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_beg; k0 < k_end; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int m = e / kBK, kk = e % kBK;
      const int gm = m0 + m, gk = k0 + kk;
      x_s[kk][m] = (gm < M && gk < k_end) ? repro_to_f32(x[gm * a.x_sm + gk]) : 0.f;
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
        const float* srow = a.s.row(min(gk, K - 1));
        float w[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          int c = b.c[i];
          if (BITS == 4) c = r == 0 ? static_cast<int8_t>((c & 0x0F) << 4) >> 4 : c >> 4;
          w[i] = gk < k_end ? static_cast<float>(c) * a.s.at(srow, gn0 + i, N) : 0.f;
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
      float av[TM], bw[TN];
      const float4* x4 = reinterpret_cast<const float4*>(&x_s[kk][ty * TM]);
#pragma unroll
      for (int i4 = 0; i4 < TM / 4; ++i4) {
        const float4 v4 = x4[i4];  // one broadcast read: 4 rows of x
        av[4 * i4] = v4.x; av[4 * i4 + 1] = v4.y; av[4 * i4 + 2] = v4.z; av[4 * i4 + 3] = v4.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) bw[j] = w_s[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
  T* out = static_cast<T*>(a.out);
  float* ws = a.ws + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + TX * j;
      if (gn >= N) continue;
      if (split)
        ws[(long long)gm * N + gn] = acc[i][j];
      else
        put(out + (long long)gm * N + gn, acc[i][j]);
    }
  }
  if (split) reduce_splits<BM, BN>(a.ws, out, a.tickets, M, N, m0, n0);
}

// ---------------------------------------------------------------------------
// The plan: design, tile, K split.  The one place these are chosen.
// ---------------------------------------------------------------------------

struct Plan {
  int design, bm, bn, bk, k_split, splits, tiles;
};

Plan make_plan(int M, int K, int N, int bits, int group_rows, int dtype, int sms) {
  Plan p{};
  p.design = dtype == REPRO_BF16 && (group_rows >= K || group_rows % 16 == 0)
                 ? kTensorCore : kCudaCore;
  long long target;          // blocks that keep the card busy
  long long max_splits;      // each split at least a few K steps long
  if (p.design == kCudaCore) {
    p.bm = M <= 8 ? 8 : 64;
    p.bn = M <= 8 ? 256 : 128;
    p.bk = kCoreBK;
    target = 4LL * sms;
    max_splits = std::min(K / (2 * p.bk), K / (2 * M));
  } else if (M <= 8) {
    p.bm = Dec<8>::BM; p.bn = Dec<8>::BN;
    p.bk = bits == 4 ? Dec<4>::BK : Dec<8>::BK;
    target = 2LL * sms;
    max_splits = K / (2 * p.bk);
  } else {
    // 128-row tiles when there is one for every SM, else 64-row tiles and
    // a K split for two blocks an SM.  Grouped scales keep a second
    // accumulator, so their 128-row tiles fit one block an SM.
    const bool grouped = group_rows < K;
    p.bm = cdiv(M, 128) * cdiv(N, 128) >= sms ? 128 : 64;
    p.bn = Wide<128, 8>::BN;
    p.bk = Wide<128, 8>::BK;
    target = grouped && p.bm == 128 ? sms : 2LL * sms;
    max_splits = K / (4 * p.bk);
  }
  const long long tiles = cdiv(M, p.bm) * cdiv(N, p.bn);
  long long splits = std::min(target / tiles, max_splits);
  // decode: the f32 workspace (splits * M * N) at most a quarter of the codes
  if (M <= 8) splits = std::min<long long>(splits, (long long)K * bits / (128LL * M));
  splits = std::max<long long>(splits, 1);
  p.k_split = (int)(cdiv(cdiv(K, splits), p.bk) * p.bk);
  p.splits = (int)cdiv(K, p.k_split);
  p.tiles = (int)tiles;
  return p;
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <auto kernel>
cudaError_t launch(const Plan& p, size_t smem, const Args& a, cudaStream_t stream) {
  // cudaFuncSetAttribute, once per kernel: raise the shared-memory limit, and ask
  // for the largest shared-memory carveout (the kernels keep their operands
  // in shared memory, not L1), so that as many blocks fit an SM as it allows
  static const cudaError_t attr = [&] {
    const cudaError_t e = repro_smem_limit(kernel, smem);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + p.bn - 1) / p.bn, (a.M + p.bm - 1) / p.bm, p.splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BITS, bool GROUPED>
cudaError_t launch_tensor_core(const Plan& p, const Args& a, cudaStream_t s) {
  if (p.bm == 8)
    return launch<tc_decode_kernel<BITS, GROUPED>>(p, Dec<BITS>::kSmem, a, s);
  if (p.bm == 64)
    return launch<tc_wide_kernel<Wide<64, BITS>, BITS, GROUPED>>(p, Wide<64, BITS>::kSmem, a, s);
  return launch<tc_wide_kernel<Wide<128, BITS>, BITS, GROUPED>>(p, Wide<128, BITS>::kSmem, a, s);
}

template <typename T, int BITS>
cudaError_t launch_cuda_core(const Plan& p, const Args& a, cudaStream_t s) {
  if (p.bm == CoreDecodeTile::BM)
    return launch<cuda_core_kernel<T, BITS, CoreDecodeTile>>(p, 0, a, s);
  return launch<cuda_core_kernel<T, BITS, CoreWideTile>>(p, 0, a, s);
}

bool valid_shape(int M, int K, int N, int bits, int group_rows, int tile) {
  return M > 0 && N > 0 && K > 0 && group_rows > 0 && (bits == 8 || bits == 4) &&
         !(tile && (N % 128 || bits != 8)) && !(bits == 4 && K % 2);
}

}  // namespace

// The plan for one call: out[0..6] = design (0 CUDA cores, 1 tensor
// cores), tile rows, tile columns, K step, K rows per split, splits, output
// tiles.  With splits > 1 the call needs a workspace of splits * M * N
// floats and `tiles` zeroed ints of tickets.  Returns a cudaError_t.
extern "C" int repro_dequant_matmul_plan(int M, int K, int N, int bits, int group_rows,
                                         int tile, int dtype, int sms, int* out) {
  if (!valid_shape(M, K, N, bits, group_rows, tile) || sms <= 0 ||
      (dtype != REPRO_BF16 && dtype != REPRO_F32))
    return cudaErrorInvalidValue;
  const Plan p = make_plan(M, K, N, bits, group_rows, dtype, sms);
  const int v[7] = {p.design, p.bm, p.bn, p.bk, p.k_split, p.splits, p.tiles};
  std::copy(v, v + 7, out);
  return cudaSuccess;
}

// x (M, K) with row stride x_sm (elements) and a contiguous last dim; q
// contiguous codes, (K, N) int8 or (K/2, N) packed int4; scale contiguous
// f32, (K/group_rows, N), or (K/128, N/128) with tile = 1; out (M, N)
// contiguous, in x's dtype.  The plan is repro_dequant_matmul_plan's for
// the same arguments; with splits > 1, ws holds splits * M * N floats and
// tickets `tiles` ints, zero before the launch and left zero after it.
// Returns the launch's cudaError_t.
extern "C" int repro_dequant_matmul(const void* x, const void* q, const void* scale,
                                    void* out, void* ws, void* tickets, int M, int K, int N,
                                    long long x_sm, int bits, int group_rows, int tile,
                                    int dtype, int sms, void* stream) {
  if (!valid_shape(M, K, N, bits, group_rows, tile) || sms <= 0)
    return cudaErrorInvalidValue;
  const Plan p = make_plan(M, K, N, bits, group_rows, dtype, sms);
  if (p.splits > 1 && (!ws || !tickets)) return cudaErrorInvalidValue;
  const int col_shift = tile ? 7 : 0;
  const size_t esz = dtype == REPRO_BF16 ? 2 : 4;
  Args a{x, static_cast<const int8_t*>(q),
         Scales{static_cast<const float*>(scale), group_rows, col_shift, N >> col_shift},
         out, static_cast<float*>(ws), static_cast<int*>(tickets), M, K, N, x_sm,
         p.k_split,
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && (x_sm * esz) % 16 == 0 &&
             (K * esz) % 16 == 0,
         reinterpret_cast<uintptr_t>(q) % 16 == 0 && N % 16 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool grouped = group_rows < K;
  if (p.design == kTensorCore) {
    if (bits == 8)
      return grouped ? launch_tensor_core<8, true>(p, a, s) : launch_tensor_core<8, false>(p, a, s);
    return grouped ? launch_tensor_core<4, true>(p, a, s) : launch_tensor_core<4, false>(p, a, s);
  }
  if (dtype == REPRO_BF16)
    return bits == 8 ? launch_cuda_core<bf16, 8>(p, a, s) : launch_cuda_core<bf16, 4>(p, a, s);
  if (dtype == REPRO_F32)
    return bits == 8 ? launch_cuda_core<float, 8>(p, a, s) : launch_cuda_core<float, 4>(p, a, s);
  return cudaErrorInvalidValue;
}
