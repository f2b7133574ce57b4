// Flash-attention forward for prefill, with the packed ragged mode.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (_flash_fwd_kernel).  Same function: attention with
// an online softmax over key tiles, GQA through h / rep, causal and window
// masks on the packed token index, an optional tanh softcap, and with
// segments (B, S) (prompt id per token, -1 = pad) a same-segment predicate,
// so a query never attends across a prompt boundary and a pad query row
// gives exact zeros.  Scores and probabilities are f32 and the output is
// rounded once to the input dtype.  Q/K/V are read through their strides,
// so the (B, S, H, hd) activations need no transpose; ragged Sq and Skv are
// masked, so no shape falls back.  Key tiles of 32 that the causal edge or
// the window rules out are never visited, and with segments a tile whose
// mask is all false for the block's rows is skipped before it is loaded.
//
// What bounds it on the H100: at the serving shape (one 128-token packed
// stream, 16 query heads over 2 KV heads, head_dim 128) the work is tiny
// -- ~1 MiB of Q/K/V/out and ~70 MFLOP after the causal cut -- so launch
// latency and the warps in flight bound it, not the roofline (0.35 us of
// bytes).  At long prompts it is bound by operations (4 * S^2/2 * hd a
// head).  The CUDA-core design below (64 blocks of 4 warps at the serving
// shape, scalar f32 dot products out of shared memory) takes 0.082 ms on
// the H100, slower than its plain PyTorch version.
//
// Two designs; the wrapper's plan (flash_attention/kernel.py::
// prefill_plan) picks one and passes it, and the source refuses a design
// the inputs cannot take:
//
// 1. Tensor cores (bf16 q/k/v, hd == hdv == 64 or 128, rows 16-byte
//    aligned), FlashAttention-2 style with mma.sync m16n8k16 bf16
//    -> f32.  Each warp owns 16 query rows of one query head; a block is
//    `heads` query heads of one KV head times `rows` 16-row tiles, which
//    share each K/V tile: up to 4 warps, one an SM sub-partition, more
//    while the blocks fill a wave (4 x 1 at the serving shape: 32 blocks,
//    128 warps).  Q fragments
//    stay in registers for the whole sweep.  K/V tiles of 32 keys come in
//    through cp.async, double-buffered, and reach the mma through ldmatrix
//    (K rows are the col operand as stored) and ldmatrix.trans (V).  The S
//    accumulator's m16n8 layout is reused as the A fragment of P.V.  The
//    reference multiplies P in f32: P is split into three bf16 terms, each
//    the rounding of what the previous leave, whose sum is P exactly (24
//    significant bits, 8 a term), and each P.V k-step issues three mmas.
//    bf16 products are exact in f32, so S and P.V differ from the plain
//    version only in the order of f32 sums.  (Two terms keep P to 2^-17
//    of itself; on the H100 they left outputs in [1, 2) one bf16 ulp,
//    7.8e-3, off the plain version, four times the CUDA-core design's
//    largest error.)  Measured on the H100 at the serving shape
//    (chip_probe_attention.py): ~0.0097 ms with 4 warps a block, 0.0108
//    with one (128 one-warp blocks), 0.0126 with 8; 0.0046 without the
//    tiles' arithmetic; two P terms instead of three save ~0.0004 ms.
//    The head dim is a template parameter and the mask has no branch an
//    element: with run-time head-dim bounds in the unrolled loops and
//    branches in the mask, one-warp blocks read 0.026 ms (0.016 without).
// 2. CUDA cores (f32 inputs, or a head dim the tiles do not take): one
//    block per (32-row query tile, query head, batch row), scalar f32 dot
//    products and value sums out of shared memory, the port's first
//    design.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Design 2: CUDA cores (f32, or head dims the tensor-core tiles do not take)
// ---------------------------------------------------------------------------
namespace cuda_core {

constexpr int kThreads = 128;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 32;  // keys per tile == warp size (row update)

struct Masker {
  int Sq, Skv, causal, window;
  const int* qseg;  // shared, kBQ entries (nullptr when not segmented)
  const int* kseg;  // shared, kBK entries
  int q0, k0;
  __device__ __forceinline__ bool operator()(int i, int j) const {
    const int qi = q0 + i, kj = k0 + j;
    bool m = qi < Sq && kj < Skv;
    if (causal) m = m && kj <= qi;
    if (window) m = m && qi - kj < window;
    if (qseg) m = m && qseg[i] == kseg[j] && qseg[i] >= 0;
    return m;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) prefill_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, T* __restrict__ out, int Sq, int Skv, int rep,
    int hd, int hdv, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long g_sb, long long g_ss,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window,
    float softcap, float scale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;  // query head
  const int b = blockIdx.z;
  const int hk = h / rep;    // its KV head
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ld = hd + 1;     // padded Q/K rows: conflict-free column reads

  float* qs = smem;               // kBQ x (hd + 1)
  float* ks = qs + kBQ * ld;      // kBK x (hd + 1)
  float* vs = ks + kBK * ld;      // kBK x hdv
  float* ss = vs + kBK * hdv;     // kBQ x kBK  scores, then probabilities
  float* acc = ss + kBQ * kBK;    // kBQ x hdv
  float* m_s = acc + kBQ * hdv;   // kBQ
  float* l_s = m_s + kBQ;         // kBQ
  float* a_s = l_s + kBQ;         // kBQ
  int* qseg = reinterpret_cast<int*>(a_s + kBQ);  // kBQ
  int* kseg = qseg + kBQ;                         // kBK

  const int nq = min(kBQ, Sq - q0);
  const T* qb = q + b * q_sb + h * q_sh;
  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    qs[i * ld + d] = i < nq ? repro_to_f32(qb[(long long)(q0 + i) * q_ss + d]) : 0.f;
  }
  for (int e = tid; e < kBQ * hdv; e += kThreads) acc[e] = 0.f;
  if (tid < kBQ) {
    m_s[tid] = REPRO_NEG_INF;
    l_s[tid] = 0.f;
    if (seg) qseg[tid] = tid < nq ? seg[b * g_sb + (long long)(q0 + tid) * g_ss] : -1;
  }

  // key range: from the first tile the window reaches to the causal edge
  int k_end = Skv;
  if (causal) k_end = min(Skv, q0 + nq);
  int k_begin = 0;
  if (window) k_begin = max(0, q0 - window + 1) / kBK * kBK;

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  Masker mask{Sq, Skv, causal, window, seg ? qseg : nullptr, kseg, q0, 0};

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    mask.k0 = k0;
    __syncthreads();  // previous tile done; init visible on the first pass
    if (seg && tid < kBK)
      kseg[tid] = k0 + tid < Skv ? seg[b * g_sb + (long long)(k0 + tid) * g_ss] : -1;
    __syncthreads();
    int any = 0;
    for (int e = tid; e < kBQ * kBK && !any; e += kThreads)
      any = mask(e / kBK, e % kBK);
    if (!__syncthreads_or(any)) continue;  // all-false tile: no loads

    const int nk = min(kBK, Skv - k0);
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int j = e / hd, d = e % hd;
      ks[j * ld + d] = j < nk ? repro_to_f32(kb[(long long)(k0 + j) * k_ss + d]) : 0.f;
    }
    for (int e = tid; e < kBK * hdv; e += kThreads) {
      const int j = e / hdv, d = e % hdv;
      vs[e] = j < nk ? repro_to_f32(vb[(long long)(k0 + j) * v_ss + d]) : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < kBQ * kBK; e += kThreads) {
      const int i = e / kBK, j = e % kBK;
      float s = REPRO_NEG_INF;
      if (mask(i, j)) {
        const float* qr = qs + i * ld;
        const float* kr = ks + j * ld;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      ss[e] = s;
    }
    __syncthreads();

    // online-softmax update, one warp per query row (lane = key).  Masked
    // entries get an explicit zero: a row with no valid key in a computed
    // tile (a pad row in a mixed tile) has m_new == NEG_INF, where
    // exp(s - m_new) would be 1.
    for (int i = warp; i < kBQ; i += kThreads / 32) {
      const float s = ss[i * kBK + lane];
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, repro_warp_max(s));
      const float p = mask(i, lane) ? expf(s - m_new) : 0.f;
      const float tot = repro_warp_sum(p);
      ss[i * kBK + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + tot;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < kBQ * hdv; e += kThreads) {
      const int i = e / hdv, d = e % hdv;
      const float* pr = ss + i * kBK;
      float a = acc[e] * a_s[i];
      for (int j = 0; j < nk; ++j) a = fmaf(pr[j], vs[j * hdv + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();

  T* ob = out + b * o_sb + h * o_sh;
  for (int e = tid; e < kBQ * hdv; e += kThreads) {
    const int i = e / hdv;
    if (i >= nq) continue;
    float l = l_s[i];
    if (l == 0.f) l = 1.f;  // fully-masked (pad) rows -> exact zeros
    ob[(long long)(q0 + i) * o_ss + e % hdv] = repro_from_f32<T>(acc[e] / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg,
                   void* out, int B, int Sq, int Skv, int Hq, int Hkv, int hd,
                   int hdv, long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                   long long v_ss, long long v_sh, long long g_sb, long long g_ss,
                   long long o_sb, long long o_ss, long long o_sh, int causal,
                   int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * (hd + 1) + (size_t)kBK * (hd + 1) +
                       (size_t)kBK * hdv + (size_t)kBQ * kBK + (size_t)kBQ * hdv +
                       3 * (size_t)kBQ) +
      sizeof(int) * (kBQ + kBK);
  cudaError_t err = repro_smem_limit<prefill_attention_kernel<T>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  prefill_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      seg, static_cast<T*>(out), Sq, Skv, Hq / Hkv, hd, hdv, q_sb, q_ss, q_sh,
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, o_sb, o_ss, o_sh, causal,
      window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace cuda_core

// ---------------------------------------------------------------------------
// Design 1: tensor cores (bf16)
// ---------------------------------------------------------------------------
namespace tensor_core {

using bf16 = __nv_bfloat16;
constexpr int kBK = 32;         // keys a tile
constexpr int kMaxWarps = 8;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* seg;
  bf16* out;
  int Sq, Skv, rep, hd;  // hd: q/k and v head dim alike
  int heads, rows;  // a block: `heads` query heads of one KV head x `rows` 16-row tiles
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ uint32_t load_pair(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// x0, x1 (f32) as three bf16 pairs whose sums are x0, x1 exactly: each
// term takes the next 8 of the 24 significant bits, and each remainder is
// exact in f32
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
    const __nv_bfloat162 h = __halves2bfloat162(h0, h1);
    p[i] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __bfloat162float(h0);
    x1 -= __bfloat162float(h1);
  }
}

__host__ __device__ constexpr int row_elems(int hd) { return hd + 8; }  // ldmatrix rows in distinct banks
__host__ __device__ inline int live_words(int Skv) { return ((Skv + kBK - 1) / kBK + 31) / 32; }

__host__ __device__ inline size_t smem_bytes(int hd, int rows, int Skv) {
  return sizeof(bf16) * 2 * 2 * kBK * row_elems(hd)  // K and V, two buffers
         + sizeof(int) * (2 * kBK + 16 * rows)       // key and query segments
         + sizeof(unsigned) * live_words(Skv);       // one bit a live key tile
}

// Grid (query blocks of 16 * rows, Hkv * ceil(rep / heads), B); a warp
// each (head, 16-row tile) of the block.  A thread of a warp holds, as the
// m16n8 layout has it, rows g = lane / 4 and g + 8 and columns 2t, 2t + 1
// (t = lane % 4) of each 8-column tile.  HD, the head dim, is a template
// parameter, so a tile's body is one straight run of code.
template <int HD>
__global__ void __launch_bounds__(32 * kMaxWarps) prefill_tc_kernel(const Args a) {
  constexpr int kRow = row_elems(HD);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);          // [2][kBK][kRow]
  bf16* v_s = k_s + 2 * kBK * kRow;                   // [2][kBK][kRow]
  int* kseg = reinterpret_cast<int*>(v_s + 2 * kBK * kRow);  // [2][kBK]
  int* qseg = kseg + 2 * kBK;                         // [16 * rows]
  unsigned* live = reinterpret_cast<unsigned*>(qseg + 16 * a.rows);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int groups = (a.rep + a.heads - 1) / a.heads;
  const int hk = blockIdx.y / groups, b = blockIdx.z;
  const int hr = (blockIdx.y % groups) * a.heads + warp / a.rows;  // head within hk's group
  const int qb0 = blockIdx.x * 16 * a.rows, qb1 = min(a.Sq, qb0 + 16 * a.rows);
  const int q0 = qb0 + 16 * (warp % a.rows);  // the warp's first row
  const bool active = hr < a.rep && q0 < a.Sq;

  // the block's key tiles: from the first the window reaches to the causal edge
  const int k_end = a.causal ? min(a.Skv, qb1) : a.Skv;
  const int k_begin = a.window ? max(0, qb0 - a.window + 1) / kBK * kBK : 0;
  const int ntile = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int* sb = a.seg ? a.seg + b * a.g_sb : nullptr;

  // Q fragments, in registers for the whole sweep (zero past Sq); loaded
  // first, so that their latency overlaps what follows
  const long long head = (long long)hk * a.rep + hr;
  const bf16* qb = a.q + b * a.q_sb + head * a.q_sh;
  const int r0 = q0 + g, r1 = q0 + g + 8;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int d = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(qb + r0 * a.q_ss + d, active && r0 < a.Sq);
    qf[kk][1] = load_pair(qb + r1 * a.q_ss + d, active && r1 < a.Sq);
    qf[kk][2] = load_pair(qb + r0 * a.q_ss + d + 8, active && r0 < a.Sq);
    qf[kk][3] = load_pair(qb + r1 * a.q_ss + d + 8, active && r1 < a.Sq);
  }

  if (sb) {  // which tiles hold an unmasked (row, key) pair: lane = key
    for (int i = tid; i < 16 * a.rows; i += nthreads)
      qseg[i] = qb0 + i < a.Sq ? sb[(long long)(qb0 + i) * a.g_ss] : -1;
    for (int w = tid; w < (ntile + 31) / 32; w += nthreads) live[w] = 0u;
    __syncthreads();
    for (int t0 = warp; t0 < ntile; t0 += 4 * nwarps) {  // four tiles a pass
      int sk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {  // their key segments, loaded together
        const int tt = t0 + u * nwarps, kj = k_begin + tt * kBK + lane;
        sk[u] = tt < ntile && kj < a.Skv ? sb[(long long)kj * a.g_ss] : -1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tt = t0 + u * nwarps, kj = k_begin + tt * kBK + lane;
        bool any = false;
        if (sk[u] >= 0) {
#pragma unroll 8
          for (int i = 0; i < qb1 - qb0; ++i) {
            const int qi = qb0 + i;
            any |= (qseg[i] == sk[u]) & ((!a.causal) | (kj <= qi)) &
                   ((!a.window) | (qi - kj < a.window));
          }
        }
        if (tt < ntile && __any_sync(0xffffffffu, any) && lane == 0)
          atomicOr(live + tt / 32, 1u << (tt % 32));
      }
    }
    __syncthreads();
  }
  // without segments every tile of [k_begin, k_end) has an unmasked pair
  auto next_live = [&](int tt) {
    if (sb)
      while (tt < ntile && !((live[tt / 32] >> (tt % 32)) & 1u)) ++tt;
    return tt;
  };
  const int qs0 = sb ? qseg[r0 - qb0] : 0, qs1 = sb ? qseg[r1 - qb0] : 0;

  const bf16* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + hk * a.v_sh;
  auto load = [&](int tt, int s) {  // key tile tt into buffer s, zero past Skv
    constexpr int kCh = HD / 8;     // 16-byte pieces a row
    const int k0 = k_begin + tt * kBK;
    bf16* kd = k_s + s * kBK * kRow;
    bf16* vd = v_s + s * kBK * kRow;
    for (int c = tid; c < kBK * kCh; c += nthreads) {
      const int r = c / kCh, off = (c % kCh) * 8, j = k0 + r;
      const bool ok = j < a.Skv;
      cp_async16(kd + r * kRow + off, ok ? kb + j * a.k_ss + off : kb, ok);
      cp_async16(vd + r * kRow + off, ok ? vb + j * a.v_ss + off : vb, ok);
    }
    if (sb && tid < kBK) {
      const int j = k0 + tid;
      const bool ok = j < a.Skv;
      cp_async4(kseg + s * kBK + tid, ok ? sb + j * a.g_ss : sb, ok);
    }
  };

  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  int cur = next_live(0), s = 0;
  if (cur < ntile) load(cur, 0);
  cp_async_commit();
  while (cur < ntile) {
    const int nxt = next_live(cur + 1);
    cp_async_wait<0>();
    __syncthreads();  // tile cur landed; every warp is done with the other buffer
    if (nxt < ntile) load(nxt, s ^ 1);
    cp_async_commit();
    const int k0 = k_begin + cur * kBK;
    // the warp's rows reach this tile (its own causal edge and window)
    const bool need = active && (!a.causal || k0 <= min(q0 + 15, a.Sq - 1)) &&
                      (!a.window || q0 - (k0 + kBK - 1) < a.window);
    if (need) {
      const bf16* kt = k_s + s * kBK * kRow;
      const bf16* vt = v_s + s * kBK * kRow;
      // S = Q K^T: 16 rows x 32 keys, four n8 tiles
      float sc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[n][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {  // keys np*16 .. +15: two n8 tiles
          uint32_t r[4];
          ldmatrix_x4(r, kt + (np * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * kRow +
                             kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * np], qf[kk], r[0], r[1]);
          mma_bf16(sc[2 * np + 1], qf[kk], r[2], r[3]);
        }
      }
      // scale and softcap, then the mask (no branch an element); row
      // maxima over the quad that shares a row
      if (a.softcap > 0.f) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sc[n][c] = a.softcap * tanhf(sc[n][c] * a.scale / a.softcap);
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[n][c] *= a.scale;
      }
      const int* kst = kseg + s * kBK;
      const bool causal = a.causal, windowed = a.window > 0, segmented = sb != nullptr;
      float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
      unsigned okb = 0u;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c >> 1, col = 8 * n + 2 * t + (c & 1);
          const int qi = i ? r1 : r0, kj = k0 + col, qs = i ? qs1 : qs0;
          const bool ok = (qi < a.Sq) & (kj < a.Skv) & ((!causal) | (kj <= qi)) &
                          ((!windowed) | (qi - kj < a.window)) &
                          ((!segmented) | ((qs >= 0) & (qs == kst[col])));
          sc[n][c] = ok ? sc[n][c] : REPRO_NEG_INF;
          okb |= (unsigned)ok << (4 * n + c);
          mx[i] = fmaxf(mx[i], sc[n][c]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
      // probabilities, with an explicit zero where masked: a row with no
      // valid key yet has m == NEG_INF, where exp(s - m) would be 1
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = (okb >> (4 * n + c)) & 1u ? expf(sc[n][c] - m[c >> 1]) : 0.f;
          sc[n][c] = p;
          sum[c >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // O += (P_1 + P_2 + P_3) V, P's three bf16 terms: the S tiles 2kk,
      // 2kk + 1 are the A fragments of key step kk
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t f[4][3], pa[3][4];
        split3_bf16(sc[2 * kk][0], sc[2 * kk][1], f[0]);
        split3_bf16(sc[2 * kk][2], sc[2 * kk][3], f[1]);
        split3_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], f[2]);
        split3_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], f[3]);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) pa[i][j] = f[j][i];
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {  // dims np*16 .. +15: two n8 tiles
          uint32_t r[4];
          ldmatrix_x4_trans(r, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRow +
                                   np * 16 + ((lane >> 4) & 1) * 8);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            mma_bf16(o[2 * np], pa[i], r[0], r[1]);
            mma_bf16(o[2 * np + 1], pa[i], r[2], r[3]);
          }
        }
      }
    }
    cur = nxt;
    s ^= 1;
  }

  if (!active) return;
  bf16* ob = a.out + b * a.o_sb + head * a.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = i ? r1 : r0;
    if (qi >= a.Sq) continue;
    // times 1 / l (fully-masked pad rows: l == 0 -> 1, exact zeros); an
    // f32 division an element read 0.0044 ms slower (0.0141 against 0.0097)
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(ob + qi * a.o_ss + 8 * n + 2 * t) =
          pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int HD>
cudaError_t launch_hd(const Args& a, int B, int Hkv, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD, a.rows, a.Skv);
  cudaError_t err = repro_smem_limit<prefill_tc_kernel<HD>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + 16 * a.rows - 1) / (16 * a.rows),
                  Hkv * ((a.rep + a.heads - 1) / a.heads), B);
  prefill_tc_kernel<HD><<<grid, 32 * a.heads * a.rows, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int hdv, int B, int Hkv, cudaStream_t stream) {
  if (a.hd != hdv || a.heads < 1 || a.rows < 1 || a.heads * a.rows > kMaxWarps)
    return cudaErrorInvalidValue;
  // 16-byte K/V copies and 4-byte Q and output pairs
  const long long st[] = {a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh,
                          a.v_sb, a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh};
  for (long long x : st)
    if (x % 8) return cudaErrorMisalignedAddress;
  const void* ptrs[] = {a.q, a.k, a.v, a.out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  switch (a.hd) {
    case 64: return launch_hd<64>(a, B, Hkv, stream);
    case 128: return launch_hd<128>(a, B, Hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tensor_core

}  // namespace

// Strides are in elements; every tensor's last dimension is contiguous.
// q (B, Sq, Hq, hd): q_sb, q_ss, q_sh.  k/v (B, Skv, Hkv, hd): *_sb, *_ss,
// *_sh.  segments (B, S) int32 or null: g_sb, g_ss.  out (B, Sq, Hq, hdv):
// o_sb, o_ss, o_sh.  design: 0 CUDA cores, 1 tensor cores (bf16 only),
// with a block of `heads` query heads x `rows` 16-row tiles.  Returns the
// launch's cudaError_t.
extern "C" int repro_prefill_attention(
    const void* q, const void* k, const void* v, const void* segments, void* out,
    int B, int Sq, int Skv, int Hq, int Hkv, int hd, int hdv, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long g_sb, long long g_ss,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window,
    float softcap, float scale, int dtype, int design, int heads, int rows, void* stream) {
  const int* seg = static_cast<const int*>(segments);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 1) {
    if (dtype != REPRO_BF16) return cudaErrorInvalidValue;
    using tensor_core::bf16;
    const tensor_core::Args a{
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        seg, static_cast<bf16*>(out), Sq, Skv, Hq / Hkv, hd, heads, rows,
        q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, o_sb, o_ss, o_sh,
        causal, window, softcap, scale};
    return tensor_core::launch(a, hdv, B, Hkv, s);
  }
  if (design != 0) return cudaErrorInvalidValue;
  if (dtype == REPRO_BF16)
    return cuda_core::launch<__nv_bfloat16>(q, k, v, seg, out, B, Sq, Skv, Hq, Hkv, hd, hdv,
                                            q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                            v_sh, g_sb, g_ss, o_sb, o_ss, o_sh, causal,
                                            window, softcap, scale, s);
  if (dtype == REPRO_F32)
    return cuda_core::launch<float>(q, k, v, seg, out, B, Sq, Skv, Hq, Hkv, hd, hdv, q_sb,
                                    q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb,
                                    g_ss, o_sb, o_ss, o_sh, causal, window, softcap, scale,
                                    s);
  return cudaErrorInvalidValue;
}
