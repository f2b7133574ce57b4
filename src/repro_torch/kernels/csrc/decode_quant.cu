// Decode attention over the QUANTISED slot pool: one query token per slot.
//
// Replaces the TPU kernel repro/kernels/flash_attention/decode.py::
// flash_decode_quant_fwd (_decode_quant_kernel).  Same function as
// decode.cu (flash_decode_fwd), but the pool holds int8 codes
// (B, Skv, Hkv, hd), or two int4 codes a byte packed along the head dim
// (hd/2), with one f32 scale per (entry, head): for slot b and KV head h,
// the rep = Hq/Hkv query heads sharing h attend over the entries whose
// kv_pos is valid (kv_pos >= 0 && kv_pos <= q_pos, and q_pos - kv_pos <
// window when windowed), with an optional tanh softcap.  An empty slot
// gives exact zeros (l == 0 -> 1).  Each K/V value is dequantised in
// registers as float(code) * scale, all arithmetic is f32, and the output
// is rounded once to q's dtype: the fp pool never exists.
//
// What bounds it on the H100: bytes, as for the fp pool, but 1 or 0.5 bytes
// a K/V element instead of 2 (plus 4 bytes of scale per row of 128), so the
// bound is about 2x or 4x lower.
//
// Design: decode.cu's, with another K/V reader.  One block per (KV head,
// slot) holds the rep query rows; 8 warps split the entries in tiles of
// 32, each warp keeping its own f32 online softmax, merged at the end
// through shared memory.  The code planes and scales are read strided in
// place (no transpose, unlike the Pallas wrapper).  Scores: lane i takes
// entry i of the tile and reads its K row of codes with 16-byte loads (16
// int8 or 32 int4 codes each), unpacking int4 pairs (byte i holds
// dimension 2i in the low nibble, 2i+1 in the high one).  Values: lane i
// takes dimensions i, i+32, ... of each V row.  Fully masked tiles and
// masked entries load nothing, and a ragged Skv is masked.  Known limit,
// as in decode.cu: B * Hkv blocks (16 at B=8, Hkv=2) use 16 of 132 SMs.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;  // query rows per pass (rep > 8 takes several passes)
static_assert(kRows == 8, "the value loop reads a tile's probabilities as two float4");

// The pool reader.  bind(b, h) gives the reader of one (slot, KV head):
// kVec values of a K row from one 16-byte load of codes, and a V row read
// by dimension, dequantised to f32.

template <int BITS>  // the quantised pool: int8 codes (packed int4) + f32 scales
struct QuantPool {
  static constexpr int kPack = BITS == 4 ? 2 : 1;  // values per code byte
  static constexpr int kVec = 16 * kPack;          // values per 16-byte load
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;        // code strides (bytes)
  long long ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh;  // scale strides

  static __device__ __forceinline__ float code(int8_t byte, int d) {
    if (BITS == 8) return static_cast<float>(byte);
    const int c = (d & 1) ? byte >> 4 : static_cast<int8_t>((byte & 0x0F) << 4) >> 4;
    return static_cast<float>(c);
  }
  struct VRow {
    const int8_t* p;
    float s;
    __device__ __forceinline__ float operator[](int d) const {
      return code(__ldg(p + d / kPack), d) * s;
    }
  };
  struct Bound {
    const int8_t* __restrict__ kb;
    const int8_t* __restrict__ vb;
    const float* __restrict__ ksb;
    const float* __restrict__ vsb;
    long long k_ss, v_ss, ks_ss, vs_ss;
    __device__ __forceinline__ void k_load(int j, int d0, float* kf) const {
      const float s = __ldg(ksb + j * ks_ss);
      union {
        uint4 raw;
        int8_t c[16];
      } u;
      u.raw = __ldg(reinterpret_cast<const uint4*>(kb + j * k_ss + d0 / kPack));
#pragma unroll
      for (int t = 0; t < kVec; ++t) kf[t] = code(u.c[t / kPack], t) * s;
    }
    __device__ __forceinline__ VRow v_row(int j) const {
      return {vb + j * v_ss, __ldg(vsb + j * vs_ss)};
    }
  };
  __device__ __forceinline__ Bound bind(int b, int h) const {
    return {k + b * k_sb + h * k_sh, v + b * v_sb + h * v_sh, ks + b * ks_sb + h * ks_sh,
            vs + b * vs_sb + h * vs_sh, k_ss, v_ss, ks_ss, vs_ss};
  }
};

template <typename T, int BITS, int DPL>  // DPL: value dims per lane (hdv <= 32*DPL)
__global__ void __launch_bounds__(kThreads) decode_quant_kernel(
    const T* __restrict__ q, const QuantPool<BITS> pool, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, T* __restrict__ out, int Skv, int rep, int hd,
    int hdv, long long q_sb, long long q_sh, long long qp_sb, long long kp_sb,
    long long kp_ss, long long o_sb, long long o_sh, int window, float softcap,
    float scale) {
  constexpr int kVec = QuantPool<BITS>::kVec;  // K values per 16-byte load
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
  const typename QuantPool<BITS>::Bound kv = pool.bind(b, h);
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
#pragma unroll 2
        for (int d0 = 0; d0 < hd; d0 += kVec) {
          float kf[kVec];
          kv.k_load(j, d0, kf);
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
          const auto vr = kv.v_row(j0 + jj);
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < hdv) {
              const float vf = vr[d];
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

// Everything of a launch but the pool.
struct Launch {
  const void* q;
  const int* q_pos;
  const int* kv_pos;
  void* out;
  int B, Skv, Hq, Hkv, hd, hdv;
  long long q_sb, q_sh, qp_sb, kp_sb, kp_ss, o_sb, o_sh;
  int window;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int BITS, int DPL>
cudaError_t launch_dpl(const Launch& a, const QuantPool<BITS>& pool) {
  const size_t smem = sizeof(float) * ((size_t)kRows * a.hd + kWarps * kRows * 32 +
                                       (size_t)kWarps * kRows * a.hdv + 2 * kWarps * kRows);
  cudaError_t err = repro_smem_limit(decode_quant_kernel<T, BITS, DPL>, smem);
  if (err != cudaSuccess) return err;
  decode_quant_kernel<T, BITS, DPL><<<dim3(a.Hkv, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), pool, a.q_pos, a.kv_pos, static_cast<T*>(a.out), a.Skv,
      a.Hq / a.Hkv, a.hd, a.hdv, a.q_sb, a.q_sh, a.qp_sb, a.kp_sb, a.kp_ss, a.o_sb, a.o_sh,
      a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch(const Launch& a, const void* k_q, const void* k_s, const void* v_q,
                   const void* v_s, const long long* st) {
  // 16-byte K loads: the row length, the base and every K row offset
  // (in bytes of codes) whole vectors
  if (a.hd % QuantPool<BITS>::kVec || reinterpret_cast<uintptr_t>(k_q) % 16 ||
      st[0] % 16 || st[1] % 16 || st[2] % 16)
    return cudaErrorMisalignedAddress;
  const QuantPool<BITS> pool{static_cast<const int8_t*>(k_q), static_cast<const int8_t*>(v_q),
                             static_cast<const float*>(k_s), static_cast<const float*>(v_s),
                             st[0], st[1], st[2], st[3], st[4], st[5],
                             st[6], st[7], st[8], st[9], st[10], st[11]};
  if (a.hdv <= 128) return launch_dpl<T, BITS, 4>(a, pool);
  if (a.hdv <= 256) return launch_dpl<T, BITS, 8>(a, pool);
  return cudaErrorInvalidValue;
}

}  // namespace

// The quantised pool: k_q/v_q (B, Skv, Hkv, hd/pack) int8 codes, k_s/v_s
// (B, Skv, Hkv) f32 scales.  strides (12): k_q, v_q, k_s, v_s, each as
// (sb, ss, sh) in elements; K code rows 16-byte aligned.  hd and hdv are
// the unpacked head dims.  Otherwise as decode.cu's repro_decode_attention.
extern "C" int repro_decode_attention_quant(
    const void* q, const void* k_q, const void* k_s, const void* v_q, const void* v_s,
    const void* q_pos, const void* kv_pos, void* out, int B, int Skv, int Hq, int Hkv,
    int hd, int hdv, long long q_sb, long long q_sh, const long long* strides,
    long long qp_sb, long long kp_sb, long long kp_ss, long long o_sb, long long o_sh,
    int window, float softcap, float scale, int bits, int dtype, void* stream) {
  const Launch a{q, static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos), out,
                 B, Skv, Hq, Hkv, hd, hdv, q_sb, q_sh, qp_sb, kp_sb, kp_ss, o_sb, o_sh,
                 window, softcap, scale, static_cast<cudaStream_t>(stream)};
  const long long* st = strides;  // QuantPool order: codes k, v, then scales k, v
  if (dtype == REPRO_BF16 && bits == 8)
    return launch<__nv_bfloat16, 8>(a, k_q, k_s, v_q, v_s, st);
  if (dtype == REPRO_BF16 && bits == 4)
    return launch<__nv_bfloat16, 4>(a, k_q, k_s, v_q, v_s, st);
  if (dtype == REPRO_F32 && bits == 8) return launch<float, 8>(a, k_q, k_s, v_q, v_s, st);
  if (dtype == REPRO_F32 && bits == 4) return launch<float, 4>(a, k_q, k_s, v_q, v_s, st);
  return cudaErrorInvalidValue;
}
