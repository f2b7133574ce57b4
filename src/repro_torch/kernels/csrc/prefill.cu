// Flash-attention forward for prefill, with the packed ragged mode.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (_flash_fwd_kernel).  Same function: attention with
// an online softmax over key tiles, GQA through h / rep, causal and window
// masks on the packed token index, an optional tanh softcap, and with
// segments (B, S) (prompt id per token, -1 = pad) a same-segment predicate,
// so a query never attends across a prompt boundary and a pad query row
// gives exact zeros.  Inputs are cast to f32, all arithmetic is f32, and the
// output is rounded once to the input dtype.
//
// What bounds it on the H100: at the serving shape (one 128-token stream,
// 16 query heads, head_dim 128) the work is tiny either way -- ~1 MiB of
// Q/K/V/out and ~70 MFLOP after the causal cut -- so launch latency and the
// few blocks in flight bound it, not the roofline.  At long prompts it is
// bound by operations (2 * S^2 * hd per head).
//
// Design: one block per (query tile of 32 rows, query head, batch row); the
// Q/K/V tensors are read through their strides, so the (B, S, H, hd)
// activations need no transpose.  The block walks key tiles of 32 from the
// start of the window to the causal edge and stops there (tiles past it are
// dead by structure), and skips a tile whose mask is all false at run time
// (segment-crossing or pad-only tiles) before loading it.  Ragged edges of
// Sq and Skv are masked, so no exact tiling is needed.  Scores and the
// value product run on CUDA cores in f32; tensor-core (wgmma) tiles and
// TMA loads are left to a later change.
#include "common.cuh"

namespace {

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
  cudaError_t err = repro_smem_limit(prefill_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  prefill_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      seg, static_cast<T*>(out), Sq, Skv, Hq / Hkv, hd, hdv, q_sb, q_ss, q_sh,
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, o_sb, o_ss, o_sh, causal,
      window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements; every tensor's last dimension is contiguous.
// q (B, Sq, Hq, hd): q_sb, q_ss, q_sh.  k/v (B, Skv, Hkv, hd): *_sb, *_ss,
// *_sh.  segments (B, S) int32 or null: g_sb, g_ss.  out (B, Sq, Hq, hdv):
// o_sb, o_ss, o_sh.  Returns the launch's cudaError_t.
extern "C" int repro_prefill_attention(
    const void* q, const void* k, const void* v, const void* segments, void* out,
    int B, int Sq, int Skv, int Hq, int Hkv, int hd, int hdv, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long g_sb, long long g_ss,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window,
    float softcap, float scale, int dtype, void* stream) {
  const int* seg = static_cast<const int*>(segments);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(q, k, v, seg, out, B, Sq, Skv, Hq, Hkv, hd, hdv,
                                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                 v_sh, g_sb, g_ss, o_sb, o_ss, o_sh, causal, window,
                                 softcap, scale, s);
  if (dtype == REPRO_F32)
    return launch<float>(q, k, v, seg, out, B, Sq, Skv, Hq, Hkv, hd, hdv, q_sb,
                         q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb,
                         g_ss, o_sb, o_ss, o_sh, causal, window, softcap, scale, s);
  return cudaErrorInvalidValue;
}
