// The dropless MoE layer's expert path over rows sorted by group (expert):
//
//   product:  y[i] = x[i] . w[e]                        for rows i of group e
//   scaled:   y[i] = bf16(bf16(x[i] . w[e]) * scale[i])
//   gate/up:  h[i] = bf16(act(bf16(x[r] . wg[e])) * bf16(x[r] . wu[e])), r = rows[i]
//   combine:  out[t] = ys[p0] + ys[p1] + ... + ys[p(k-1)], rounded after each add,
//             where p0 < p1 < ... are the sorted places of token t's k pairs
//
// x (T, K), w (E, K, N), y (T, N), f32 accumulation.  offsets (E + 1,) int32
// are nondecreasing with offsets[0] = 0 and offsets[E] = T; they stay on the
// device, so a launch reads nothing back to the host and a CUDA graph can
// hold it.  Rounding follows the chain of torch ops it replaces (each product
// rounded to the element type, the activation computed in f32 on the rounded
// gate with expf and a true divide, every multiply and add rounded once).
//
// Replaces no TPU kernel.  It is the port's own kernel for jax.lax.ragged_dot,
// the three grouped products of the dropless MoE layer
// (repro/models/moe.py::_apply_dropless), which the reference leaves to XLA,
// with the activation, the gate scale and the scatter-add fused in.
//
// What bounds it on the H100: the weight bytes of the experts that hold rows.
// At qwen3-moe-30b-a3b's decode (8 slots x top-8 = 64 rows, about 53 of the
// 128 experts selected) one bank is ~53 x 2048 x 768 x 2 B = 0.17 GB, ~0.050 ms
// at 3.35 TB/s, against 0.2 GFLOP; at a prefill of 384 tokens (3072 rows,
// every expert) 0.40 GB against 9.7 GFLOP: at most ~24 FLOP a byte, far under
// the card's ridge of ~295.  So every design streams each selected expert's
// weights once and keeps the HBM busy; the tensor cores are never the limit.
//
// Two designs for the products, chosen by the wrapper
// (repro_torch/kernels/grouped_matmul/kernel.py::plan) and checked here:
//
// 1. TMA (bf16; K and N multiples of 8 and at least 64, 16-byte aligned
//    operands, at most kTmaMaxExperts experts): persistent blocks,
//    kBlocksPerSM an SM, walk a list of work items (expert, pass of up to 64
//    rows, 64-column tile) that every block builds in shared memory
//    from the offsets (a scan of each expert's passes), so no block launches
//    only to exit and no wave is partly empty.  Lane 0 of warp 4 produces: it
//    keeps a ring of kStages weight stages full by TMA (cp.async.bulk.tensor
//    of a 64 K-row x 64-column box a bank, gate and up together, 128-byte
//    swizzle, the bytes counted on the stage's full mbarrier), across item
//    boundaries, so the down product's 12 K steps an item never drain it.
//    Warps 0-3 (one warpgroup) consume: they gather the pass's x rows through
//    the row index into a ring of their own by cp.async, kXStages - 1 K steps
//    ahead (TMA cannot gather rows), wait for the weight stage, and run
//    mma.sync m16n8k16 on the m16 tiles that hold rows (a decode pass holds
//    1-16; B read by ldmatrix.trans through the swizzle) or, on a pass of
//    more than kWgmmaRows rows, wgmma m64n64k16 with A from registers and B
//    from shared memory; each warp frees the stage on its empty mbarrier.
//    The epilogue (activation and multiply, or the gate scale) runs in
//    registers.  Measured on the H100 (chip_probe_grouped.py): one block's
//    boxes land one after another, ~1,100 cycles a 64-row box however deep
//    the ring and however many threads issue them, so three blocks an SM
//    stream the weights (two leave a decode's ~624 (pass, tile) items
//    unevenly shared, a block's last item at half the SM's rate; four give
//    the fused gate/up a ring too shallow).
// 2. CUDA cores (f32, or bf16 that design 1 does not take): a block per
//    (expert, 64 columns), passes of 16 rows, x and w staged in shared memory
//    as f32 32 K rows at a time, each thread 4 columns of one row by FMA.
//
// The combine is one launch: each block finds the places of its tokens' k
// pairs by one pass over `order` (the inverse permutation), sorts each
// token's k places (ascending place is ascending expert id) and sums the
// rows in that order, 16 bytes a thread.
//
// No split across blocks and no atomics: a row's sum runs in a fixed order
// inside one warp (design 1) or thread (design 2), whatever the other rows
// hold, and the combine adds in place order, so a replayed launch gives an
// eager one's bits.
#include <cstdint>

#include <cuda.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
enum Design { kCudaCore = 0, kTma = 1 };                  // kernel.py's DESIGNS
enum Mode { kProduct = 0, kScaled = 1, kGateUp = 2 };     // kernel.py's OPS
enum Act { kNoAct = 0, kSilu = 1, kGelu = 2, kRelu2 = 3 };  // kernel.py's ACTS

__host__ __device__ inline long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return repro_to_f32(repro_from_f32<T>(v));
}

// torch's CUDA activations in f32 (silu: x / (1 + exp(-x)); gelu with tanh;
// relu2 = square(relu(x)))
template <int kAct>
__device__ __forceinline__ float act_f32(float v) {
  if constexpr (kAct == kSilu) {
    return v / (1.0f + expf(-v));
  } else if constexpr (kAct == kGelu) {
    const float kBeta = 0.7978845608028654f, kKappa = 0.044715f;
    const float cube = v * v * v;
    return 0.5f * v * (1.0f + tanhf(kBeta * (v + kKappa * cube)));
  } else {
    const float r = fmaxf(v, 0.0f);
    return r * r;
  }
}

// The output value of one element before its last rounding: a0 (and a1, the
// up product) are the f32 sums, s the row's scale.
template <typename T, int kMode, int kAct>
__device__ __forceinline__ float finish(float a0, float a1, float s) {
  if constexpr (kMode == kGateUp) {
    const float up = round_to<T>(a1);
    return round_to<T>(act_f32<kAct>(round_to<T>(a0))) * up;
  } else if constexpr (kMode == kScaled) {
    return round_to<T>(a0) * s;
  } else {
    return a0;
  }
}

// -- design 1: TMA-fed persistent blocks ---------------------------------------
constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kConsumerWarps = 4, kConsumers = 32 * kConsumerWarps;
// blocks an SM: one block's TMA boxes land one after another
constexpr int kBlocksPerSM = 3;
constexpr int kTmaThreads = kConsumers + 32;        // and one producer warp
constexpr int kTmaMaxExperts = 512;
// passes of more rows run wgmma, the others mma.sync
constexpr int kWgmmaRows = 16;
constexpr int kXS = kBK + 8;                        // x tile row stride (elements)
constexpr int kWTileBytes = kBK * kBN * 2;          // 8 KB, 1024-byte aligned
constexpr int kXTileBytes = kBM * kXS * 2;          // 9216
constexpr int kXStages = 3;                         // the consumers' x ring
constexpr int kSmemBytes = 224 * 1024 / kBlocksPerSM;   // a block's shared memory
struct WeightMaps {
  CUtensorMap m[2];                                 // the bank, or gate and up
};

template <int kMode>
struct TmaShape {
  static constexpr bool kDual = kMode == kGateUp;
  static constexpr int kBanks = kDual ? 2 : 1;
  static constexpr int kStageBytes = kBanks * kWTileBytes;   // 1024 multiple
  // the weight ring: what is left after the x ring, the barriers, the offsets
  // and the alignment slack
  static constexpr int kFit =
      (kSmemBytes - kXStages * kXTileBytes - 1024 - 2 * (kTmaMaxExperts + 1) * 4 - 256) /
      kStageBytes;
  static constexpr int kStages = kFit < 12 ? kFit : 12;
  static_assert(kStages >= 2, "a ring of at least two stages");
  static size_t smem(int E) {
    return 1024 + (size_t)kStages * kStageBytes + (size_t)kXStages * kXTileBytes +
           2 * kStages * sizeof(uint64_t) + 2 * (size_t)(E + 1) * sizeof(int);
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Until the phase of the given parity has completed.  A wait that never
// ends (a ring whose two sides disagree) traps: a fault, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (long long spins = 0; !done; ++spins) {
    if (spins == (1ll << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
// The box (n0, k0, e) of a bank, 64 x 64, into a 128-byte-swizzled tile.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int n0, int k0, int e) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(n0), "r"(k0), "r"(e)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// B operand descriptor of a weight tile's 16 K rows: N-major (transposed),
// 128-byte swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return ((uint64_t)(smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(kWTileBytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// d (64 x 64, f32) += a (64 x 16, bf16, registers) . b (16 x 64, bf16, smem)
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc) {
  const int accumulate = 1;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}
// keep the compiler from reading the accumulators before the wait
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

struct Item {
  int e, m0, rows, n0;
};

// Work item u: the (pass, column tile) pair, column tile fastest, where the
// passes of expert e are cum[e] .. cum[e + 1) - 1.
__device__ __forceinline__ Item item_at(int u, int n_tiles, const int* cum, const int* offs,
                                        int E) {
  const int pi = u / n_tiles, nt = u - pi * n_tiles;
  int lo = 0, hi = E;                       // cum[lo] <= pi < cum[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] <= pi) lo = mid; else hi = mid;
  }
  const int m0 = offs[lo] + (pi - cum[lo]) * kBM;
  return {lo, m0, min(kBM, offs[lo + 1] - m0), nt * kBN};
}

// The consumers' x ring: this thread's share of the x rows of a pass, kc
// the 16-byte chunk of a 64-column stage row, rows r0 + 16 j.
struct XCursor {
  int u, kt;                                 // the item and K step the next load is for
  Item it;
  long long src[kBM / 16];                   // each row's offset in x, -1 past the pass
};

template <int kMode, int kAct>
__global__ void __launch_bounds__(kTmaThreads, kBlocksPerSM)
gmm_tma(const __grid_constant__ WeightMaps maps, const bf16* __restrict__ x,
        const long long* __restrict__ rows_idx, const int* __restrict__ offsets,
        const bf16* __restrict__ scale, bf16* __restrict__ y, int E, int K, int N,
        long long x_sm) {
  using S = TmaShape<kMode>;
  constexpr bool kDual = S::kDual;
  constexpr int kStages = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* xring = reinterpret_cast<bf16*>(base + kStages * S::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * S::kStageBytes +
                                               kXStages * kXTileBytes);
  uint64_t* empty = full + kStages;
  int* offs = reinterpret_cast<int*>(empty + kStages);
  int* cum = offs + E + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i <= E; i += kTmaThreads) offs[i] = offsets[i];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);               // the producer's expect_tx; TMA counts the bytes
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {                          // cum[e]: the passes of experts before e
    int carry = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      int v = e < E ? (int)cdiv(max(offs[e + 1] - offs[e], 0), kBM) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      if (e < E) cum[e + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) cum[0] = 0;
  }
  __syncthreads();
  const int n_tiles = (int)cdiv(N, kBN), n_k = (int)cdiv(K, kBK);
  const int total = cum[E] * n_tiles;

  if (warp == kConsumerWarps) {
    // ---- producer: one thread keeps the weight ring full by TMA
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < total; u += gridDim.x) {
        const Item it = item_at(u, n_tiles, cum, offs, E);
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = base + stage * S::kStageBytes;
          mbar_expect_tx(&full[stage], S::kStageBytes);
          tma_load_tile(st, &maps.m[0], &full[stage], it.n0, kt * kBK, it.e);
          if constexpr (kDual)
            tma_load_tile(st + kWTileBytes, &maps.m[1], &full[stage], it.n0, kt * kBK, it.e);
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // ---- consumers: warps 0-3, one warpgroup.  They gather the x rows of each
  // K step themselves (cp.async, kXStages - 1 steps ahead, across items) and
  // wait on the weight ring's full barriers.
  const int g = lane >> 2, t4 = lane & 3;
  const int kc = (tid % (kBK / 8)) * 8, r0 = tid / (kBK / 8);
  XCursor xc;
  const auto set_item = [&](int u) {
    xc.u = u;
    xc.kt = 0;
    if (u >= total) return;
    xc.it = item_at(u, n_tiles, cum, offs, E);
#pragma unroll
    for (int j = 0; j < kBM / 16; ++j) {
      const int r = r0 + 16 * j;
      xc.src[j] = r < xc.it.rows
                      ? (rows_idx ? rows_idx[xc.it.m0 + r] : xc.it.m0 + r) * x_sm : -1;
    }
  };
  // the x rows of the cursor's K step into ring slot `slot`, then the cursor on
  const auto load_x = [&](int slot) {
    if (xc.u < total) {
      bf16* xs = xring + slot * (kBM * kXS);
      const int loaded = (int)cdiv(xc.it.rows, 16) * 16;   // rows of the m16 tiles
      const int gk = xc.kt * kBK + kc;
#pragma unroll
      for (int j = 0; j < kBM / 16; ++j) {
        const int r = r0 + 16 * j;
        if (r < loaded) {
          const bool ok = xc.src[j] >= 0 && gk < K;
          cp_async16(xs + r * kXS + kc, ok ? x + xc.src[j] + gk : x, ok);
        }
      }
      if (++xc.kt == n_k) set_item(xc.u + gridDim.x);
    }
    cp_async_commit();
  };
  set_item(blockIdx.x);
#pragma unroll
  for (int s = 0; s < kXStages - 1; ++s) load_x(s);

  int stage = 0, q = 0;                     // q: the K steps consumed so far
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    const Item it = item_at(u, n_tiles, cum, offs, E);
    const auto store = [&](int rl, int col, float a0, float a1, float b0, float b1) {
      if (rl >= it.rows || col >= N) return;           // N % 8 == 0: col + 1 < N too
      const long long row = it.m0 + rl;
      const float s = kMode == kScaled ? __bfloat162float(scale[row]) : 1.0f;
      *reinterpret_cast<__nv_bfloat162*>(y + row * N + col) = __floats2bfloat162_rn(
          finish<bf16, kMode, kAct>(a0, b0, s), finish<bf16, kMode, kAct>(a1, b1, s));
    };
    // one K step: its x rows landed (every consumer's), the slot read last
    // step refilled, then its weight stage
    const auto next_step = [&]() -> const bf16* {
      cp_async_wait<kXStages - 2>();
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      load_x((q + kXStages - 1) % kXStages);
      mbar_wait(&full[stage], phase);
      return xring + (q % kXStages) * (kBM * kXS);
    };
    const auto release = [&]() {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) { stage = 0; phase ^= 1; }
      ++q;
    };
    if (it.rows > kWgmmaRows) {
      float d0[32], d1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0.f;
      for (int kt = 0; kt < n_k; ++kt) {
        const bf16* xs = next_step();
        const unsigned char* st = base + stage * S::kStageBytes;
        uint32_t a[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          ldmatrix_x4(a[kk], xs + (warp * 16 + (lane & 15)) * kXS + kk * 16 + (lane >> 4) * 8);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wgmma_64x64(d0, a[kk], wgmma_desc(st + kk * 16 * kBN * 2));
          if constexpr (kDual)
            wgmma_64x64(d1, a[kk], wgmma_desc(st + kWTileBytes + kk * 16 * kBN * 2));
        }
        wgmma_commit_wait();
        fence_operands(d0);
        if constexpr (kDual) fence_operands(d1);
        release();
      }
      // d[4j + v]: row warp * 16 + g (+8 for v >= 2), column 8j + 2 t4 (+1)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          store(warp * 16 + g + 8 * h, it.n0 + 8 * j + 2 * t4, d0[i], d0[i + 1], d1[i],
                d1[i + 1]);
        }
    } else {
      const int n_mt = (int)cdiv(it.rows, 16);
      const int wn = warp * 16;                // the warp's 16 columns of the tile
      float acc0[kBM / 16][2][4], acc1[kBM / 16][2][4];
#pragma unroll
      for (int i = 0; i < kBM / 16; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc0[i][j][v] = acc1[i][j][v] = 0.f;
      for (int kt = 0; kt < n_k; ++kt) {
        const bf16* xs = next_step();
        const unsigned char* st = base + stage * S::kStageBytes;
        const bf16* w0 = reinterpret_cast<const bf16*>(st);
        const bf16* w1 = reinterpret_cast<const bf16*>(st + kWTileBytes);
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          // B: k rows kk..kk+15 x the warp's 16 columns, two n8 fragments; the
          // 16-byte chunk c of tile row r sits at chunk c ^ (r % 8)
          const int kr = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int off = kr * kBN + ((((wn >> 3) + (lane >> 4)) ^ (kr & 7)) << 3);
          uint32_t b0[4], b1[4];
          ldmatrix_x4_trans(b0, w0 + off);
          if constexpr (kDual) ldmatrix_x4_trans(b1, w1 + off);
#pragma unroll
          for (int mt = 0; mt < kBM / 16; ++mt) {
            if (mt < n_mt) {
              uint32_t a[4];
              ldmatrix_x4(a, xs + (mt * 16 + (lane & 15)) * kXS + kk + (lane >> 4) * 8);
              mma_bf16(acc0[mt][0], a, b0[0], b0[1]);
              mma_bf16(acc0[mt][1], a, b0[2], b0[3]);
              if constexpr (kDual) {
                mma_bf16(acc1[mt][0], a, b1[0], b1[1]);
                mma_bf16(acc1[mt][1], a, b1[2], b1[3]);
              }
            }
          }
        }
        release();
      }
#pragma unroll
      for (int mt = 0; mt < kBM / 16; ++mt) {
        if (mt >= n_mt) continue;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store(mt * 16 + g + 8 * h, it.n0 + wn + nt * 8 + 2 * t4, acc0[mt][nt][2 * h],
                  acc0[mt][nt][2 * h + 1], acc1[mt][nt][2 * h], acc1[mt][nt][2 * h + 1]);
      }
    }
  }
  cp_async_wait<0>();                       // no copy outlives the block
}

// -- design 2: CUDA cores -----------------------------------------------------
constexpr int kCM = 16, kCN = 64, kCK = 32, kCThreads = 256;

template <typename T, int kMode, int kAct>
__global__ void __launch_bounds__(kCThreads)
gmm_cc(const T* __restrict__ x, const long long* __restrict__ rows_idx,
       const T* __restrict__ w0, const T* __restrict__ w1, const int* __restrict__ offsets,
       const T* __restrict__ scale, T* __restrict__ y, int K, int N, long long x_sm) {
  constexpr bool kDual = kMode == kGateUp;
  const int e = blockIdx.x, n0 = blockIdx.y * kCN;
  const int beg = offsets[e], end = offsets[e + 1];
  if (beg >= end) return;
  __shared__ float xs[kCM][kCK];
  __shared__ float ws0[kCK][kCN + 1];
  __shared__ float ws1[kDual ? kCK : 1][kCN + 1];
  const T* we0 = w0 + (long long)e * K * N;
  const T* we1 = kDual ? w1 + (long long)e * K * N : nullptr;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;   // row, 4 columns
  for (int m0 = beg; m0 < end; m0 += kCM) {
    float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += kCK) {
      for (int i = threadIdx.x; i < kCM * kCK; i += kCThreads) {
        const int r = i / kCK, kk = i % kCK, gm = m0 + r, gk = k0 + kk;
        float v = 0.f;
        if (gm < end && gk < K) {
          const long long src = rows_idx ? rows_idx[gm] : gm;
          v = repro_to_f32(x[src * x_sm + gk]);
        }
        xs[r][kk] = v;
      }
      for (int i = threadIdx.x; i < kCK * kCN; i += kCThreads) {
        const int r = i / kCN, nn = i % kCN, gk = k0 + r, gn = n0 + nn;
        const bool ok = gk < K && gn < N;
        ws0[r][nn] = ok ? repro_to_f32(we0[(long long)gk * N + gn]) : 0.f;
        if constexpr (kDual) ws1[r][nn] = ok ? repro_to_f32(we1[(long long)gk * N + gn]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kCK; ++kk) {
        const float xv = xs[ty][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc0[j] = fmaf(xv, ws0[kk][tx * 4 + j], acc0[j]);
          if constexpr (kDual) acc1[j] = fmaf(xv, ws1[kk][tx * 4 + j], acc1[j]);
        }
      }
      __syncthreads();
    }
    const int row = m0 + ty;
    if (row < end) {
      const float s = kMode == kScaled ? repro_to_f32(scale[row]) : 1.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < N)
          y[(long long)row * N + col] =
              repro_from_f32<T>(finish<T, kMode, kAct>(acc0[j], acc1[j], s));
      }
    }
  }
}

// -- the combine --------------------------------------------------------------
constexpr int kCombThreads = 128;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// Block (b, c): tokens [b * per_block, ...) and the c-th slice of columns.
template <typename T, int V>
__global__ void __launch_bounds__(kCombThreads)
combine_kernel(const T* __restrict__ ys, const long long* __restrict__ order,
               T* __restrict__ out, int n_tok, int k, int D, int per_block) {
  extern __shared__ int places[];              // per_block x k
  const int t0 = blockIdx.x * per_block, nt = min(per_block, n_tok - t0);
  if (nt <= 0) return;
  const long long n = (long long)n_tok * k, lo = (long long)t0 * k, hi = lo + (long long)nt * k;
  for (long long i = threadIdx.x; i < n; i += kCombThreads) {
    const long long f = order[i];              // sorted row i holds pair f = token * k + j
    if (f >= lo && f < hi) places[f - lo] = (int)i;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nt; t += kCombThreads) {
    int* p = places + t * k;                   // ascending place = ascending expert id
    for (int a = 1; a < k; ++a) {
      const int v = p[a];
      int b = a - 1;
      while (b >= 0 && p[b] > v) { p[b + 1] = p[b]; --b; }
      p[b + 1] = v;
    }
  }
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const int* p = places + t * k;
    for (int c = (blockIdx.y * kCombThreads + threadIdx.x) * V; c < D;
         c += gridDim.y * kCombThreads * V) {
      const Vec<T, V> first = *reinterpret_cast<const Vec<T, V>*>(ys + (long long)p[0] * D + c);
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = repro_to_f32(first.v[i]);
      for (int j = 1; j < k; ++j) {
        const Vec<T, V> r = *reinterpret_cast<const Vec<T, V>*>(ys + (long long)p[j] * D + c);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = round_to<T>(acc[i] + repro_to_f32(r.v[i]));
      }
      Vec<T, V> o;
#pragma unroll
      for (int i = 0; i < V; ++i) o.v[i] = repro_from_f32<T>(acc[i]);
      *reinterpret_cast<Vec<T, V>*>(out + (long long)(t0 + t) * D + c) = o;
    }
  }
}

// -- host side ----------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver function, reached through the runtime
// (no -lcuda); looked up once.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The bank w (E, K, N) bf16 as a 3-D tensor map of 64 x 64 boxes with the
// 128-byte swizzle; encoded for every launch from w's address (a CUDA graph
// keeps the map it captured: the engine's weights keep their storage).
bool weight_map(CUtensorMap* map, const void* w, int E, int K, int N) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {kBN, kBK, 1}, elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kMode, int kAct>
cudaError_t launch_tma(const void* x, const void* rows, const void* w0, const void* w1,
                       const int* off, const void* scale, void* y, int E, int K, int N,
                       long long x_sm, int sms, cudaStream_t s) {
  WeightMaps maps;
  if (!weight_map(&maps.m[0], w0, E, K, N)) return cudaErrorInvalidValue;
  if (kMode == kGateUp && !weight_map(&maps.m[1], w1, E, K, N)) return cudaErrorInvalidValue;
  const size_t smem = TmaShape<kMode>::smem(E);
  const cudaError_t err = repro_smem_limit<gmm_tma<kMode, kAct>>(smem);
  if (err != cudaSuccess) return err;
  gmm_tma<kMode, kAct><<<kBlocksPerSM * sms, kTmaThreads, smem, s>>>(
      maps, static_cast<const bf16*>(x), static_cast<const long long*>(rows), off,
      static_cast<const bf16*>(scale), static_cast<bf16*>(y), E, K, N, x_sm);
  return cudaGetLastError();
}

template <typename T, int kMode, int kAct>
cudaError_t launch_cc(const void* x, const void* rows, const void* w0, const void* w1,
                      const int* off, const void* scale, void* y, int E, int K, int N,
                      long long x_sm, cudaStream_t s) {
  const dim3 grid(E, (unsigned)cdiv(N, kCN));
  gmm_cc<T, kMode, kAct><<<grid, kCThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const long long*>(rows),
      static_cast<const T*>(w0), static_cast<const T*>(w1), off,
      static_cast<const T*>(scale), static_cast<T*>(y), K, N, x_sm);
  return cudaGetLastError();
}

template <int kMode, int kAct>
cudaError_t dispatch(int design, int dtype, const void* x, const void* rows, const void* w0,
                     const void* w1, const int* off, const void* scale, void* y, int E, int K,
                     int N, long long x_sm, int sms, cudaStream_t s) {
  if (design == kTma) {
    const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    if (dtype != REPRO_BF16 || K % 8 || N % 8 || K < kBK || N < kBN || x_sm % 8 ||
        E > kTmaMaxExperts || sms < 1 || !a16(x) || !a16(w0) || !a16(y) ||
        (kMode == kGateUp && !a16(w1)))
      return cudaErrorInvalidValue;
    return launch_tma<kMode, kAct>(x, rows, w0, w1, off, scale, y, E, K, N, x_sm, sms, s);
  }
  if (design != kCudaCore) return cudaErrorInvalidValue;
  if (dtype == REPRO_BF16)
    return launch_cc<bf16, kMode, kAct>(x, rows, w0, w1, off, scale, y, E, K, N, x_sm, s);
  if (dtype == REPRO_F32)
    return launch_cc<float, kMode, kAct>(x, rows, w0, w1, off, scale, y, E, K, N, x_sm, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the launch's cudaError_t.  op: 0 product, 1 scaled (scale (T,)),
// 2 gate/up (w1 the up bank, act 1 silu, 2 gelu, 3 relu2); rows (T,) int64
// names the x row of each output row (gate/up; null: row i).  design: 1 TMA
// (bf16 only; K and N multiples of 8 and at least 64, x, w and y 16-byte
// aligned, x_sm a multiple of 8, at most 512 experts; a grid of
// kBlocksPerSM x `sms` blocks), 0 CUDA cores (bf16 or f32, any shape).
extern "C" int repro_grouped_matmul(const void* x, const void* rows, const void* w0,
                                    const void* w1, const void* offsets, const void* scale,
                                    void* y, int E, int K, int N, long long x_sm, int dtype,
                                    int design, int op, int act, int sms, void* stream) {
  if (E < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
#define REPRO_DISPATCH(MODE, ACT)                                                           \
  dispatch<MODE, ACT>(design, dtype, x, rows, w0, w1, off, scale, y, E, K, N, x_sm, sms, s)
  if (op == kProduct && act == kNoAct && !rows) return REPRO_DISPATCH(kProduct, kNoAct);
  if (op == kScaled && act == kNoAct && !rows && scale) return REPRO_DISPATCH(kScaled, kNoAct);
  if (op == kGateUp && rows && w1) {
    if (act == kSilu) return REPRO_DISPATCH(kGateUp, kSilu);
    if (act == kGelu) return REPRO_DISPATCH(kGateUp, kGelu);
    if (act == kRelu2) return REPRO_DISPATCH(kGateUp, kRelu2);
  }
#undef REPRO_DISPATCH
  return cudaErrorInvalidValue;
}

// Returns the launch's cudaError_t.  ys (n_tok * k, D) sorted rows, order
// (n_tok * k,) int64 the pair each sorted row holds, out (n_tok, D); vec: 16-byte
// pieces (D a multiple of 8 bf16 / 4 f32 elements, ys and out 16-byte aligned);
// a grid of (n_tok / per_block, slices) blocks.
extern "C" int repro_grouped_combine(const void* ys, const void* order, void* out, int n_tok,
                                     int k, int D, int dtype, int per_block, int slices,
                                     int vec, void* stream) {
  if (n_tok < 1 || k < 1 || D < 1 || per_block < 1 || slices < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)per_block * k * sizeof(int);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)cdiv(n_tok, per_block), slices);
  const auto* o = static_cast<const long long*>(order);
  if (dtype == REPRO_BF16) {
    const auto* a = static_cast<const bf16*>(ys);
    auto* b = static_cast<bf16*>(out);
    if (vec) combine_kernel<bf16, 8><<<grid, kCombThreads, smem, s>>>(a, o, b, n_tok, k, D, per_block);
    else combine_kernel<bf16, 1><<<grid, kCombThreads, smem, s>>>(a, o, b, n_tok, k, D, per_block);
  } else if (dtype == REPRO_F32) {
    const auto* a = static_cast<const float*>(ys);
    auto* b = static_cast<float*>(out);
    if (vec) combine_kernel<float, 4><<<grid, kCombThreads, smem, s>>>(a, o, b, n_tok, k, D, per_block);
    else combine_kernel<float, 1><<<grid, kCombThreads, smem, s>>>(a, o, b, n_tok, k, D, per_block);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
