// Decode attention over the slotted KV pool: one query token per slot.
//
// Replaces the TPU kernel repro/kernels/flash_attention/decode.py::
// flash_decode_fwd (_decode_kernel).  Same function: for slot b and KV head
// h, the rep = Hq/Hkv query heads sharing h attend over the pool entries
// whose kv_pos is valid (kv_pos >= 0 && kv_pos <= q_pos, and
// q_pos - kv_pos < window when windowed), with an optional tanh softcap.
// Entries need not be in order (ring caches).  An empty slot gives exact
// zeros (l == 0 -> 1).  Inputs are cast to f32, all arithmetic is f32, and
// the output is rounded once to the input dtype.
//
// What bounds it on the H100: bytes.  Each step reads the valid part of the
// K/V pool once (up to 8 MiB a layer for qwen2.5-3b at 8 slots x 1024
// entries in bf16) for 2 * rep flops per element, far below the ~295
// flops/byte where Hopper's tensor cores would be the limit.  So the design
// aims at streaming K/V once with enough loads in flight, on CUDA cores.
//
// Design: one block per (KV head, slot) holding the rep query rows, so K/V
// of a head is read once for all of its query heads (the TPU kernel's head
// folding).  The pool is read in place through its strides; the Pallas
// wrapper's transpose to (B, Hkv, Skv, hd) is gone.  The block's 8 warps
// split the entries in tiles of 32, each warp keeping its own f32 online
// softmax (m, l, acc) — the sequential grid axis of the TPU kernel becomes
// parallel warps, merged once at the end through shared memory.  Scores:
// lane i takes entry i of the tile and reads its K row with 16-byte loads
// against the query rows held in shared memory.  Values: lane i takes
// dimensions i, i+32, ... so each V row is read coalesced, with the
// probabilities broadcast from shared memory.  A tile whose entries are all
// masked is skipped before any K/V byte is loaded, as is every masked entry
// inside a tile (empty slots, entries beyond a slot's length or outside the
// window), and the ragged last tile is masked, so any Skv works.  Known
// limit: a grid of B * Hkv blocks (16 at B=8, Hkv=2) occupies 16 of 132
// SMs; a split-KV second pass across blocks is the fix, left to a later
// change.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;  // query rows per pass (rep > 8 takes several passes)
static_assert(kRows == 8, "the value loop reads a tile's probabilities as two float4");

template <typename T, int DPL>  // DPL: value dimensions per lane (hd <= 32*DPL)
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    T* __restrict__ out, int Skv, int rep, int hd, int hdv, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long qp_sb,
    long long kp_sb, long long kp_ss, long long o_sb, long long o_sh,
    int window, float softcap, float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                                  // kRows x hd
  float* p_s = q_s + kRows * hd;                      // kWarps x 32 x kRows
  float* acc_w = p_s + kWarps * kRows * 32;           // kWarps x kRows x hdv
  float* m_w = acc_w + kWarps * kRows * hdv;          // kWarps x kRows
  float* l_w = m_w + kWarps * kRows;                  // kWarps x kRows

  const int h = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // slot
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qp = q_pos[b * qp_sb];
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int* pb = kv_pos + b * kp_sb;
  float* pw = p_s + warp * 32 * kRows;  // this warp's probabilities, [entry][row]

  for (int r0 = 0; r0 < rep; r0 += kRows) {
    const int nr = min(kRows, rep - r0);
    const T* qb = q + b * q_sb + (long long)(h * rep + r0) * q_sh;
    for (int e = threadIdx.x; e < kRows * hd; e += kThreads) {
      const int r = e / hd;
      q_s[e] = r < nr ? repro_to_f32(qb[(long long)r * q_sh + e % hd]) : 0.f;
    }
    __syncthreads();

    float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = REPRO_NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
    }

    for (int j0 = warp * 32; j0 < Skv; j0 += kWarps * 32) {
      const int j = j0 + lane;
      bool valid = false;
      if (j < Skv) {
        const int p = pb[j * kp_ss];
        valid = p >= 0 && p <= qp && (window == 0 || qp - p < window);
      }
      const unsigned vmask = __ballot_sync(0xffffffffu, valid);
      if (vmask == 0) continue;  // tile fully masked: no K/V loads

      // scores: lane = entry, its K row against every query row
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.f;
      if (valid) {
        const T* kr = kb + (long long)j * k_ss;
#pragma unroll 2
        for (int d0 = 0; d0 < hd; d0 += kVec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + d0);
          const T* kv = reinterpret_cast<const T*>(&raw);
          float kf[kVec];
#pragma unroll
          for (int t = 0; t < kVec; ++t) kf[t] = repro_to_f32(kv[t]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4* q4 = reinterpret_cast<const float4*>(q_s + r * hd + d0);
#pragma unroll
            for (int t4 = 0; t4 < kVec / 4; ++t4) {
              const float4 qq = q4[t4];  // one broadcast read: 4 query values
              s[r] = fmaf(qq.x, kf[4 * t4], s[r]);
              s[r] = fmaf(qq.y, kf[4 * t4 + 1], s[r]);
              s[r] = fmaf(qq.z, kf[4 * t4 + 2], s[r]);
              s[r] = fmaf(qq.w, kf[4 * t4 + 3], s[r]);
            }
          }
        }
      }
      // online-softmax update of this warp's rows over the tile
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float sr = s[r] * scale;
        if (softcap > 0.f) sr = softcap * tanhf(sr / softcap);
        sr = valid ? sr : REPRO_NEG_INF;
        const float m_new = fmaxf(m[r], repro_warp_max(sr));
        const float p = valid ? expf(sr - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + repro_warp_sum(p);
        m[r] = m_new;
        pw[lane * kRows + r] = p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      }
      __syncwarp();
      // values: lane = dimensions lane, lane+32, ...; probabilities broadcast
#pragma unroll 4
      for (int jj = 0; jj < 32; ++jj) {
        if ((vmask >> jj) & 1u) {
          const float4* p4 = reinterpret_cast<const float4*>(pw + jj * kRows);
          const float4 pa = p4[0], pb2 = p4[1];
          const float pj[kRows] = {pa.x, pa.y, pa.z, pa.w, pb2.x, pb2.y, pb2.z, pb2.w};
          const T* vr = vb + (long long)(j0 + jj) * v_ss;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < hdv) {
              const float vf = repro_to_f32(vr[d]);
#pragma unroll
              for (int r = 0; r < kRows; ++r) acc[r][i] = fmaf(pj[r], vf, acc[r][i]);
            }
          }
        }
      }
      __syncwarp();
    }

    // merge the warps' partial softmax states
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (lane == 0) {
        m_w[warp * kRows + r] = m[r];
        l_w[warp * kRows + r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hdv) acc_w[(warp * kRows + r) * hdv + d] = acc[r][i];
      }
    }
    __syncthreads();
    T* ob = out + b * o_sb + (long long)(h * rep + r0) * o_sh;
    for (int e = threadIdx.x; e < nr * hdv; e += kThreads) {
      const int r = e / hdv, d = e % hdv;
      float mx = REPRO_NEG_INF;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w * kRows + r]);
      float lsum = 0.f, o = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(m_w[w * kRows + r] - mx);
        lsum += l_w[w * kRows + r] * f;
        o += acc_w[(w * kRows + r) * hdv + d] * f;
      }
      if (lsum == 0.f) lsum = 1.f;  // empty slot -> exact zeros
      ob[(long long)r * o_sh + d] = repro_from_f32<T>(o / lsum);
    }
    __syncthreads();  // q_s, m_w, acc_w are reused by the next row group
  }
}

template <typename T, int DPL>
cudaError_t launch_dpl(const void* q, const void* k, const void* v, const int* q_pos,
                       const int* kv_pos, void* out, int B, int Skv, int Hq, int Hkv,
                       int hd, int hdv, long long q_sb, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       long long qp_sb, long long kp_sb, long long kp_ss,
                       long long o_sb, long long o_sh, int window, float softcap,
                       float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kRows * hd + kWarps * kRows * 32 +
                                       (size_t)kWarps * kRows * hdv + 2 * kWarps * kRows);
  cudaError_t err = repro_smem_limit(decode_attention_kernel<T, DPL>, smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<T, DPL><<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      q_pos, kv_pos, static_cast<T*>(out), Skv, Hq / Hkv, hd, hdv, q_sb, q_sh,
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, qp_sb, kp_sb, kp_ss, o_sb, o_sh, window,
      softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_pos,
                   const int* kv_pos, void* out, int B, int Skv, int Hq, int Hkv,
                   int hd, int hdv, long long q_sb, long long q_sh, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, long long qp_sb, long long kp_sb, long long kp_ss,
                   long long o_sb, long long o_sh, int window, float softcap,
                   float scale, cudaStream_t stream) {
  // 16-byte K loads: the row length and every K offset must be whole vectors
  constexpr int kVec = 16 / sizeof(T);
  if (hd % kVec || k_sb % kVec || k_ss % kVec || k_sh % kVec ||
      reinterpret_cast<size_t>(k) % 16)
    return cudaErrorMisalignedAddress;
  if (hdv <= 128)
    return launch_dpl<T, 4>(q, k, v, q_pos, kv_pos, out, B, Skv, Hq, Hkv, hd, hdv,
                            q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, qp_sb,
                            kp_sb, kp_ss, o_sb, o_sh, window, softcap, scale, stream);
  if (hdv <= 256)
    return launch_dpl<T, 8>(q, k, v, q_pos, kv_pos, out, B, Skv, Hq, Hkv, hd, hdv,
                            q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, qp_sb,
                            kp_sb, kp_ss, o_sb, o_sh, window, softcap, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Strides are in elements; every tensor's last dimension is contiguous.
// q (B, 1, Hq, hd): q_sb, q_sh.  k/v (B, Skv, Hkv, hd): *_sb, *_ss, *_sh,
// with K rows 16-byte aligned.  q_pos (B, 1) int32: qp_sb.  kv_pos
// (B, Skv) int32: kp_sb, kp_ss.  out (B, 1, Hq, hdv): o_sb, o_sh.  Returns
// the launch's cudaError_t.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* out, int B, int Skv, int Hq, int Hkv, int hd,
    int hdv, long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long qp_sb, long long kp_sb, long long kp_ss, long long o_sb,
    long long o_sh, int window, float softcap, float scale, int dtype,
    void* stream) {
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(q, k, v, qp, kp, out, B, Skv, Hq, Hkv, hd, hdv,
                                 q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                                 qp_sb, kp_sb, kp_ss, o_sb, o_sh, window, softcap,
                                 scale, s);
  if (dtype == REPRO_F32)
    return launch<float>(q, k, v, qp, kp, out, B, Skv, Hq, Hkv, hd, hdv, q_sb,
                         q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, qp_sb, kp_sb,
                         kp_ss, o_sb, o_sh, window, softcap, scale, s);
  return cudaErrorInvalidValue;
}
