// Decode attention over the QUANTISED slot pool: one query token per slot.
//
// Replaces the TPU kernel repro/kernels/flash_attention/decode.py::
// flash_decode_quant_fwd (_decode_quant_kernel).  Same function as
// decode.cu (flash_decode_fwd), but the pool holds int8 codes
// (B, Skv, Hkv, hd), or two int4 codes a byte packed along the head dim
// (hd/2, dimension 2i in the low nibble of byte i, 2i + 1 in the high one),
// with one f32 scale per (entry, head): for slot b and KV head h, the
// rep = Hq/Hkv query heads sharing h attend over the entries whose kv_pos
// is valid (kv_pos >= 0 && kv_pos <= q_pos, and q_pos - kv_pos < window
// when windowed), in any order (a ring), with an optional tanh softcap.
// An empty slot gives exact zeros (l == 0 -> 1).  All arithmetic is f32
// and the output is rounded once to q's dtype: the fp pool never exists.
//
// What bounds it on the H100.  Not bytes: at the serving shape (B = 8,
// Skv = 1024, Hkv = 2, hd = 128, rep = 8) the pool is about 2 MB of codes,
// 0.6 us at 3.35 TB/s, and ~36 MFLOP.  Latency and parallelism bound it.
// The first design gave each (slot, KV head) one block of 8 warps, 16
// blocks on 132 SMs, each warp walking its tiles through dependent strided
// loads (one byte an __ldg for V), and took 0.104 ms (kv8) / 0.082 ms
// (kv4); kv8, with more bytes, was the slower, as a latency-bound kernel
// is.
//
// Design: split-KV.
// - Grid (splits, Hkv, B).  A split is a contiguous range of pool INDICES
//   (not positions: ring entries are unordered), a whole number of 32-entry
//   tiles.  The plan is made in Python (flash_attention/decode.py::
//   decode_splits): enough splits that B * Hkv * splits fills one wave of
//   the SMs (11 splits of 3 tiles, 176 blocks, at the serving shape), one
//   split (no workspace, no ticket) when B * Hkv alone does.
// - A block of 8 warps covers the query rows of one row group of its KV
//   head (warp w rows w * RPW .., RPW = 1 or 2 for groups of up to 8, 16
//   rows) and keeps an f32 online-softmax state (m, l, acc) per row in
//   registers.  rep above 16 is cut into groups of 16 rows (the last one
//   possibly short), each a grid row and a merge unit of its own, as in
//   decode.cu: grid (splits, Hkv x row groups, B).
// - It first marks which of its tiles hold a valid entry (kv_pos, one
//   ballot a tile), then streams the live ones through two shared-memory
//   buffers: K codes, V codes and both scales of tile t + 1 come in with
//   cp.async (zero-filled past Skv) while tile t is computed.  Fully masked
//   tiles are never loaded.  A code row comes in 16-byte copies where its
//   length and alignment allow (every serving shape), else in 4-byte
//   copies, else byte by byte with plain loads and stores (any even head
//   dim: a K row at kv4 and hd 16 is 8 bytes).
// - Scores: lane j takes entry j, reads its K code row from shared memory
//   (rows padded to an odd number of 16-byte words: no bank conflicts;
//   the query rows padded with zeros to the same whole words, so whatever
//   code bytes the padding holds add an exact 0),
//   converts 16 bytes at a time exactly (a byte permute builds the f32
//   2^23 + code + bias), dots it with the f32 query rows (broadcast reads)
//   and multiplies the sum by the entry's K scale.  Values: lane i takes
//   dimensions i * DPL .. (DPL = 4, or 8 for hdv up to 256), reading 2-8
//   code bytes an entry with one load; the V scale is folded into the
//   probability (p * v_scale).  Converting a tile once for all warps,
//   into f32 shared memory, was tried: 0.0183 ms against 0.0155 (the
//   extra pass and barrier cost more than the conversions it saves).
// - Splits are merged in the same launch, in split order, by the last
//   block of each (slot, KV head) (split_kv.cuh): deterministic, no second
//   launch, so the engine still launches one kernel a layer a step.
// CUDA cores, not tensor cores: the work is ~36 MFLOP a call at the
// serving shape, and the mma was not tried.
//
// Measured on the H100 at the serving shape (chip_probe_attention.py,
// device time a call with a cold L2): ~0.0155 ms kv8 and ~0.016 kv4, of
// which ~0.007 is what a launch costs with no tile at all (prologue, the
// ticket, the merge); the split count, 1 to 32: 0.065, 0.040, 0.023,
// 0.0147 (8), 0.0155 (11), 0.018 (16), 0.024 ms (kv8), so 11 splits keep a
// full wave within 1 us of the fastest; blocks of 4 warps (2 rows each)
// read 0.0174 against 8 warps' 0.0155.
#include "common.cuh"
#include "split_kv.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // pool entries a tile: one a lane in the score loop

// Codes -> f32, exactly: 0x4B000000 | (code + bias) is the f32 2^23 + code
// + bias; minus 2^23 + bias gives the code.
__device__ __forceinline__ float biased(uint32_t u, uint32_t sel, float magic) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - magic;
}

template <int BITS>
struct Codes {
  static constexpr int kPack = BITS == 4 ? 2 : 1;  // values a code byte
  // the 4 * kPack values of one 32-bit word of codes, in dimension order
  static __device__ __forceinline__ void word(uint32_t w, float* f) {
    if (BITS == 8) {
      const uint32_t u = w ^ 0x80808080u;  // signed byte -> code + 128
      const float m = 8388736.f;           // 2^23 + 128
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = biased(u, 0x7440u + i, m);
    } else {
      const uint32_t lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;  // nibble -> code + 8
      const uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
      const float m = 8388616.f;                            // 2^23 + 8
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = biased(lo, 0x7440u + i, m);
        f[2 * i + 1] = biased(hi, 0x7440u + i, m);
      }
    }
  }
  // the DPL values of a lane's V codes (DPL / kPack bytes at p)
  template <int DPL>
  static __device__ __forceinline__ void values(const int8_t* p, float* f) {
    constexpr int kBytes = DPL / kPack;
    if constexpr (kBytes == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      word(w.x, f);
      word(w.y, f + 4 * kPack);
    } else if constexpr (kBytes == 4) {
      word(*reinterpret_cast<const uint32_t*>(p), f);
    } else {
      float g[8];
      word(*reinterpret_cast<const uint16_t*>(p), g);
#pragma unroll
      for (int i = 0; i < DPL; ++i) f[i] = g[i];
    }
  }
};

struct Params {
  const void* q;
  const int8_t* kq;
  const int8_t* vq;
  const float* ks;
  const float* vs;
  const int* q_pos;
  const int* kv_pos;
  void* out;
  float* lse;     // (B, Hq) f32 log-sum-exp of each query row, or null
  SplitKV split;  // workspace, tickets, splits, rows of a group, hdv rounded up to 8
  int Skv, Hkv, rep, groups, hd, hdv, tiles;  // tiles: 32-entry tiles a split
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;        // code strides (bytes)
  long long ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh;  // scale strides
  long long qp_sb, kp_sb, kp_ss, o_sb, o_sh;
  int window;
  float softcap, scale;
  int k_row, v_row;      // bytes of a K / V code row in shared memory
  int q_row;             // floats of a query row in shared memory (zero-padded)
  int k_piece, v_piece;  // bytes a K / V copy: 16, 4 or 1, as length and alignment allow
};

// Byte offsets of the block's shared memory.
struct Layout {
  int q, k, v, ksc, vsc, pw, masks, bytes;
  __host__ __device__ Layout(const Params& p, int rpw) {
    int o = 0;
    q = o;      o += kWarps * rpw * p.q_row * 4;   // f32 query rows
    k = o;      o += 2 * kTile * p.k_row;          // two buffers of K codes
    v = o;      o += 2 * kTile * p.v_row;          // and of V codes
    ksc = o;    o += 2 * kTile * 4;                // and of both scales
    vsc = o;    o += 2 * kTile * 4;
    pw = o;     o += kWarps * kTile * rpw * 4;     // p * v_scale, [warp][entry][row]
    masks = o;  o += (p.tiles * 4 + 15) & ~15;     // valid entries of each tile
    bytes = o;
  }
};

template <typename T, int BITS, int RPW, int DPL>
__global__ void __launch_bounds__(kThreads) decode_quant_kernel(const Params p) {
  using C = Codes<BITS>;
  constexpr int kPack = C::kPack;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(p, RPW);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  int8_t* k_s = reinterpret_cast<int8_t*>(smem + L.k);
  int8_t* v_s = reinterpret_cast<int8_t*>(smem + L.v);
  float* ksc_s = reinterpret_cast<float*>(smem + L.ksc);
  float* vsc_s = reinterpret_cast<float*>(smem + L.vsc);
  float* pw = reinterpret_cast<float*>(smem + L.pw);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + L.masks);

  const int split = blockIdx.x, h = blockIdx.y / p.groups, g = blockIdx.y % p.groups;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (p.Skv + kTile - 1) / kTile;
  const int t0 = split * p.tiles, nt = min(p.tiles, ntiles - t0);
  const int qp = p.q_pos[b * p.qp_sb];
  const int* pb = p.kv_pos + b * p.kp_sb;
  const int row0 = g * p.split.rows;                  // the group's first row of rep
  const int nrows = min(p.split.rows, p.rep - row0);  // and its rows
  const int hdq = p.hd / kPack, hdvq = p.hdv / kPack;  // code bytes of a K / V row
  const int8_t* kb = p.kq + b * p.k_sb + h * p.k_sh;
  const int8_t* vb = p.vq + b * p.v_sb + h * p.v_sh;
  const float* ksb = p.ks + b * p.ks_sb + h * p.ks_sh;
  const float* vsb = p.vs + b * p.vs_sb + h * p.vs_sh;

  // which entries of each tile are valid: one ballot a tile
  for (int t = warp; t < nt; t += kWarps) {
    const int j = (t0 + t) * kTile + lane;
    bool valid = false;
    if (j < p.Skv) {
      const int pos = pb[j * p.kp_ss];
      valid = pos >= 0 && pos <= qp && (p.window == 0 || qp - pos < p.window);
    }
    const unsigned m = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) masks[t] = m;
  }
  // the group's query rows in f32, zero past hd; warp w holds rows
  // w * RPW .. w * RPW + RPW - 1
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + (long long)(h * p.rep + row0) * p.q_sh;
  for (int e = tid; e < kWarps * RPW * p.q_row; e += kThreads) {
    const int r = e / p.q_row, d = e - r * p.q_row;
    q_s[e] = r < nrows && d < p.hd ? repro_to_f32(qb[r * p.q_sh + d]) : 0.f;
  }
  __syncthreads();

  // 32 code rows of `bytes` from src (row j at j * ss) into dst (row r at
  // r * row), zero past Skv, in pieces of `piece` bytes
  auto load_rows = [&](int8_t* dst, int row, const int8_t* src, long long ss, int bytes,
                       int piece, int j0) {
    if (piece == 16) {
      for (int c = tid; c < kTile * 16; c += kThreads) {  // rows of at most 16 x 16 bytes
        const int r = c >> 4, off = (c & 15) * 16, j = j0 + r;
        const bool ok = j < p.Skv;
        if (off < bytes) cp_async16(dst + r * row + off, ok ? src + j * ss + off : src, ok);
      }
    } else if (piece == 4) {
      const int n = bytes / 4;
      for (int c = tid; c < kTile * n; c += kThreads) {
        const int r = c / n, off = (c - r * n) * 4, j = j0 + r;
        const bool ok = j < p.Skv;
        cp_async4(dst + r * row + off, ok ? src + j * ss + off : src, ok);
      }
    } else {
      for (int c = tid; c < kTile * bytes; c += kThreads) {
        const int r = c / bytes, off = c - r * bytes, j = j0 + r;
        dst[r * row + off] = j < p.Skv ? src[j * ss + off] : int8_t(0);
      }
    }
  };
  // tile t of the split into buffer s: K and V code rows, then the scales
  auto load = [&](int t, int s) {
    const int j0 = (t0 + t) * kTile;
    load_rows(k_s + s * kTile * p.k_row, p.k_row, kb, p.k_ss, hdq, p.k_piece, j0);
    load_rows(v_s + s * kTile * p.v_row, p.v_row, vb, p.v_ss, hdvq, p.v_piece, j0);
    if (tid < 2 * kTile) {
      const int e = tid % kTile, j = j0 + e;
      const bool ok = j < p.Skv;
      const float* sb = tid < kTile ? ksb : vsb;
      const long long ss = tid < kTile ? p.ks_ss : p.vs_ss;
      float* sd = (tid < kTile ? ksc_s : vsc_s) + s * kTile + e;
      cp_async4(sd, ok ? sb + j * ss : sb, ok);
    }
  };
  auto next_live = [&](int t) {
    while (t < nt && masks[t] == 0u) ++t;
    return t;
  };

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = REPRO_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const bool active = warp * RPW < nrows;  // a warp with no query row only loads
  const float* qw = q_s + warp * RPW * p.q_row;
  float* pwl = pw + warp * kTile * RPW;    // this warp's p * v_scale, [entry][row]

  int cur = next_live(0), s = 0;
  if (cur < nt) load(cur, 0);
  cp_async_commit();
  while (cur < nt) {
    const int nxt = next_live(cur + 1);
    cp_async_wait<0>();
    __syncthreads();  // tile cur landed; every warp is done with the other buffer
    if (nxt < nt) load(nxt, s ^ 1);
    cp_async_commit();
    if (active) {
      const unsigned vmask = masks[cur];
      const bool valid = (vmask >> lane) & 1u;
      const int8_t* krow = k_s + (s * kTile + lane) * p.k_row;
      const int8_t* vt = v_s + s * kTile * p.v_row;

      // scores: lane = entry, its K row of codes against every query row,
      // four partial sums a row (independent chains); a row of fewer than
      // 16 bytes reads its padding against zero query values
      float sc[RPW][4];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[r][i] = 0.f;
#pragma unroll 2
      for (int c = 0; c < hdq; c += 16) {  // 16 code bytes: 16 * kPack dimensions
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
        float kf[16 * kPack];
        C::word(raw.x, kf);
        C::word(raw.y, kf + 4 * kPack);
        C::word(raw.z, kf + 8 * kPack);
        C::word(raw.w, kf + 12 * kPack);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float4* q4 = reinterpret_cast<const float4*>(qw + r * p.q_row + c * kPack);
#pragma unroll
          for (int t4 = 0; t4 < 4 * kPack; ++t4) {
            const float4 qq = q4[t4];  // one broadcast read: 4 query values
            sc[r][0] = fmaf(qq.x, kf[4 * t4], sc[r][0]);
            sc[r][1] = fmaf(qq.y, kf[4 * t4 + 1], sc[r][1]);
            sc[r][2] = fmaf(qq.z, kf[4 * t4 + 2], sc[r][2]);
            sc[r][3] = fmaf(qq.w, kf[4 * t4 + 3], sc[r][3]);
          }
        }
      }
      // online-softmax update of the warp's rows over the tile
      const float ksj = ksc_s[s * kTile + lane], vsj = vsc_s[s * kTile + lane];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float x = ((sc[r][0] + sc[r][1]) + (sc[r][2] + sc[r][3])) * ksj * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        x = valid ? x : REPRO_NEG_INF;
        const float m_new = fmaxf(m[r], repro_warp_max(x));
        const float pj = valid ? expf(x - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + repro_warp_sum(pj);
        m[r] = m_new;
        pwl[lane * RPW + r] = valid ? pj * vsj : 0.f;  // a masked entry adds an exact 0
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      }
      __syncwarp();
      // values: lane = dimensions lane * DPL ..; probabilities broadcast.
      // Codes are finite, so a masked entry's 0 * code adds nothing, and
      // the dimensions past hdv that a lane's last bytes hold are never
      // written out.
      if (lane * DPL < p.hdv) {
        const int8_t* vcol = vt + lane * DPL / kPack;
#pragma unroll 8
        for (int jj = 0; jj < kTile; ++jj) {
          float pr[RPW];
          if constexpr (RPW == 2) {
            const float2 t = *reinterpret_cast<const float2*>(pwl + jj * 2);
            pr[0] = t.x; pr[1] = t.y;
          } else {
            pr[0] = pwl[jj];
          }
          float vf[DPL];
          C::template values<DPL>(vcol + jj * p.v_row, vf);
#pragma unroll
          for (int r = 0; r < RPW; ++r)
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pr[r], vf[i], acc[r][i]);
        }
      }
      __syncwarp();  // pwl is rewritten by the next tile
    }
    cur = nxt;
    s ^= 1;
  }

  T* ob = static_cast<T*>(p.out) + b * p.o_sb + (long long)(h * p.rep + row0) * p.o_sh;
  const int d0 = lane * DPL;
  float* lb = p.lse ? p.lse + ((long long)b * p.Hkv + h) * p.rep + row0 : nullptr;
  if (p.split.splits == 1) {  // the whole pool: finish here
    if (active && d0 < p.hdv) {
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int row = warp * RPW + r;
        if (row >= nrows) break;
        const float lr = l[r] == 0.f ? 1.f : l[r];  // empty slot -> exact zeros
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          if (d0 + i < p.hdv) ob[row * p.o_sh + d0 + i] = repro_from_f32<T>(acc[r][i] / lr);
      }
    }
    if (lb && active && lane == 0) {  // each row's log-sum-exp; an empty slot's NEG_INF
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int row = warp * RPW + r;
        if (row >= nrows) break;
        lb[row] = l[r] == 0.f ? REPRO_NEG_INF : m[r] + logf(l[r]);
      }
    }
    return;
  }
  // this split's part (rows of hdv rounded up to 8), then the merge by the
  // last split to finish
  const int unit = (b * p.Hkv + h) * p.groups + g;
  const int rows = p.split.rows, hdp = p.split.hdv;
  float* part = p.split.part(unit, split);
  if (active) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      if (row >= nrows) break;
      if (d0 < p.hdv) {
#pragma unroll
        for (int i = 0; i < DPL; i += 4)
          *reinterpret_cast<float4*>(part + row * hdp + d0 + i) =
              make_float4(acc[r][i], acc[r][i + 1], acc[r][i + 2], acc[r][i + 3]);
      }
      if (lane == 0) {
        part[rows * hdp + row] = m[r];
        part[rows * hdp + rows + row] = l[r];
      }
    }
  }
  if (!split_kv_last(p.split, unit)) return;
  split_kv_merge<T>(p.split, unit, ob, p.o_sh, nrows, p.hdv, lb);
}

template <typename T, int BITS, int RPW, int DPL>
cudaError_t launch_kernel(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = Layout(p, RPW).bytes;
  cudaError_t err = repro_smem_limit<decode_quant_kernel<T, BITS, RPW, DPL>>(smem);
  if (err != cudaSuccess) return err;
  decode_quant_kernel<T, BITS, RPW, DPL>
      <<<dim3(p.split.splits, p.Hkv * p.groups, B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int BITS, int RPW>
cudaError_t launch_rows(const Params& p, int B, cudaStream_t stream) {
  if (p.hdv <= 128) return launch_kernel<T, BITS, RPW, 4>(p, B, stream);
  if (p.hdv <= 256) return launch_kernel<T, BITS, RPW, 8>(p, B, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int BITS>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  if (p.split.rows <= kWarps) return launch_rows<T, BITS, 1>(p, B, stream);
  if (p.split.rows <= 2 * kWarps) return launch_rows<T, BITS, 2>(p, B, stream);
  return cudaErrorInvalidValue;
}

// The largest copy (16 or 4 bytes) that divides a code row of `bytes` and
// its base and strides; else 1 (plain loads).
int piece_bytes(const void* base, const long long* st, int bytes) {
  for (int n = 16; n >= 4; n /= 4) {
    if (bytes % n == 0 && reinterpret_cast<uintptr_t>(base) % n == 0 && st[0] % n == 0 &&
        st[1] % n == 0 && st[2] % n == 0)
      return n;
  }
  return 1;
}

}  // namespace

// The quantised pool: k_q/v_q (B, Skv, Hkv, hd/pack) int8 codes, k_s/v_s
// (B, Skv, Hkv) f32 scales.  strides (12): k_q, v_q, k_s, v_s, each as
// (sb, ss, sh) in elements.  hd and hdv are the unpacked head dims, up to
// 256 and multiples of pack; code rows at any alignment.  The rep = Hq /
// Hkv query rows of a KV head go in groups of `rows` (1..16; the last group
// may be short).  The split plan: `splits` blocks a (slot, KV head, group),
// each over `tiles` 32-entry tiles of the pool (splits * tiles * 32 >=
// Skv); with splits > 1, ws holds B * Hkv * groups * splits parts of rows *
// hdv8 + 2 * rows f32 (rounded up to 4; hdv8 = hdv rounded up to 8) and
// tickets B * Hkv * groups zeros of this stream.  Otherwise as decode.cu's
// repro_decode_attention.
extern "C" int repro_decode_attention_quant(
    const void* q, const void* k_q, const void* k_s, const void* v_q, const void* v_s,
    const void* q_pos, const void* kv_pos, void* out, void* lse, void* ws, void* tickets, int B,
    int Skv, int Hq, int Hkv, int hd, int hdv, int rows, int splits, int tiles,
    long long q_sb, long long q_sh, const long long* strides, long long qp_sb,
    long long kp_sb, long long kp_ss, long long o_sb, long long o_sh, int window,
    float softcap, float scale, int bits, int dtype, void* stream) {
  const long long* st = strides;
  if ((bits != 4 && bits != 8) || Hkv < 1 || Hq % Hkv || hd < 1 || hdv < 1 || hd > 256 ||
      hdv > 256 || rows < 1 || rows > 2 * kWarps)
    return cudaErrorInvalidValue;
  const int pack = bits == 4 ? 2 : 1, hdq = hd / pack, hdvq = hdv / pack;
  const int rep = Hq / Hkv, groups = (rep + rows - 1) / rows;
  const int ntiles = (Skv + kTile - 1) / kTile;
  if (hd % pack || hdv % pack || splits < 1 || tiles < 1 ||
      (long long)splits * tiles < ntiles || (long long)(splits - 1) * tiles >= ntiles ||
      (splits > 1 && (!ws || !tickets)) || rows > rep)
    return cudaErrorInvalidValue;
  const int kw = (hdq + 15) / 16;  // K rows an odd number of 16-byte words: no bank conflicts
  Params p{q, static_cast<const int8_t*>(k_q), static_cast<const int8_t*>(v_q),
           static_cast<const float*>(k_s), static_cast<const float*>(v_s),
           static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos), out,
           static_cast<float*>(lse), SplitKV{static_cast<float*>(ws), static_cast<int*>(tickets), splits, rows,
                   (hdv + 7) & ~7},
           Skv, Hkv, rep, groups, hd, hdv, tiles, q_sb, q_sh,
           st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
           qp_sb, kp_sb, kp_ss, o_sb, o_sh, window, softcap, scale,
           16 * (kw | 1), (hdvq + 15) & ~15, 16 * kw * pack,
           piece_bytes(k_q, st, hdq), piece_bytes(v_q, st + 3, hdvq)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16 && bits == 8) return launch<__nv_bfloat16, 8>(p, B, s);
  if (dtype == REPRO_BF16 && bits == 4) return launch<__nv_bfloat16, 4>(p, B, s);
  if (dtype == REPRO_F32 && bits == 8) return launch<float, 8>(p, B, s);
  if (dtype == REPRO_F32 && bits == 4) return launch<float, 4>(p, B, s);
  return cudaErrorInvalidValue;
}
