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
// What bounds it on the H100.  Not bytes: at the serving shape (B = 8,
// Skv = 1024, Hkv = 2, hd = 128, rep = 8, bf16) the valid part of the pool
// is at most 8 MiB, ~2.5 us at 3.35 TB/s, for ~36 MFLOP.  Latency and
// parallelism bound it.  The first design gave each (slot, KV head) one
// block of 8 warps, 16 blocks on 132 SMs, each warp walking its tiles
// through dependent global loads (V one element a lane an entry): 0.090 ms.
//
// Design: split-KV, as decode_quant.cu (the two stay separate sources).
// - Grid (splits, Hkv x row groups, B).  A split is a contiguous range of
//   pool INDICES (not positions: ring entries are unordered), a whole
//   number of 32-entry tiles.  The plan is made in Python
//   (flash_attention/decode.py::decode_splits): enough splits that the
//   blocks fill one wave of the SMs (11 splits of 3 tiles, 176 blocks, at
//   the serving shape), one split (no workspace, no ticket) when the units
//   alone do.  A unit is a (slot, KV head, row group): rep above 16 is cut
//   into groups of 16 query rows, each a grid row and a merge unit of its
//   own, so any rep runs without a row loop inside the kernel.
// - A block of 8 warps covers the rows of its group (warp w rows
//   w * RPW .., RPW = 1 or 2 for up to 8, 16 rows) and keeps an f32
//   online-softmax state (m, l, acc) per row in registers.
// - It first marks which of its tiles hold a valid entry (kv_pos, one
//   ballot a tile), then streams the live ones through two shared-memory
//   buffers: the K and V rows of tile t + 1 come in with cp.async while
//   tile t is computed.  Wholly masked tiles are never loaded, and inside
//   a tile a masked entry (or one past Skv) is zero-filled, not read: its
//   probability is an exact 0 and its values 0, so it adds an exact 0
//   whatever the pool holds there.  K rows come in 16-byte copies (the
//   wrapper requires 16-byte aligned K rows); V rows in 16-, 4- or 2-byte
//   pieces, as V's base and strides allow.
// - Scores: lane j takes entry j, reads its K row from shared memory (rows
//   padded to an odd number of 16-byte words: no bank conflicts) 16 bytes
//   at a time and dots it with the f32 query rows (broadcast reads), four
//   partial sums a row.  Values: lane i takes dimensions i * DPL .. (DPL =
//   4, or 8 for hdv up to 256) of each entry's V row, with the
//   probabilities broadcast from shared memory.
// - Splits are merged in the same launch, in split order, by the last
//   block of each unit (split_kv.cuh): deterministic, no second launch, so
//   the engine still launches one kernel a layer a step.
// - A block holds the masks of at most kMaskTiles tiles at once and walks
//   a longer range in chunks, so any Skv fits in shared memory.  f32 at
//   hd = hdv = 256 needs up to ~151 KB of shared memory (two buffers of 32
//   K and V rows of 1 KB, and 16 query rows): the block takes the opt-in
//   limit (repro_smem_limit) rather than a shorter tile, so every dtype and
//   head dim shares one tile, one plan and one merge; one such block an SM
//   is enough, since the plan makes about one wave of blocks.
// CUDA cores, not tensor cores: the work is ~36 MFLOP a call at the
// serving shape.
#include <type_traits>

#include "common.cuh"
#include "split_kv.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;         // pool entries a tile: one a lane in the score loop
constexpr int kMaskTiles = 512;   // tile masks a block holds at once

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  void* out;
  SplitKV split;  // workspace, tickets, splits, rows of a group, hdv
  int Skv, Hkv, rep, groups, hd, hdv, tiles;  // tiles: 32-entry tiles a split
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // in elements
  long long qp_sb, kp_sb, kp_ss, o_sb, o_sh;
  int window;
  float softcap, scale;
  int k_row, v_row;  // bytes of a K / V row in shared memory
  int v_piece;       // bytes a V copy: 16, 4 or 2, as V's alignment allows
};

// Byte offsets of the block's shared memory.
struct Layout {
  int q, k, v, pw, masks, bytes;
  __host__ __device__ Layout(const Params& p, int rpw) {
    int o = 0;
    q = o;      o += kWarps * rpw * p.hd * 4;      // f32 query rows
    k = o;      o += 2 * kTile * p.k_row;          // two buffers of K rows
    v = o;      o += 2 * kTile * p.v_row;          // and of V rows
    pw = o;     o += kWarps * kTile * rpw * 4;     // probabilities, [warp][entry][row]
    const int held = p.tiles < kMaskTiles ? p.tiles : kMaskTiles;
    masks = o;  o += (held * 4 + 15) & ~15;         // valid entries of each tile held
    bytes = o;
  }
};

// 16 bytes of T as f32, in order (bf16 -> f32 exactly: the top half of a word)
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float* f) {
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  } else {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// the DPL values of a lane's part of a V row in shared memory
template <typename T, int DPL>
__device__ __forceinline__ void values(const unsigned char* p, float* f) {
  constexpr int kBytes = DPL * (int)sizeof(T);
  if constexpr (kBytes == 8) {  // bf16, 4 dims
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(w.x << 16);
    f[1] = __uint_as_float(w.x & 0xFFFF0000u);
    f[2] = __uint_as_float(w.y << 16);
    f[3] = __uint_as_float(w.y & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c)
      unpack16<T>(*reinterpret_cast<const uint4*>(p + 16 * c), f + c * (16 / (int)sizeof(T)));
  }
}

template <typename T, int RPW, int DPL>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);  // values in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(p, RPW);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  unsigned char* k_s = smem + L.k;
  unsigned char* v_s = smem + L.v;
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
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(
      static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(
      static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh);
  const long long kss = p.k_ss * (long long)sizeof(T), vss = p.v_ss * (long long)sizeof(T);
  const int kbytes = p.hd * (int)sizeof(T), vbytes = p.hdv * (int)sizeof(T);

  // the group's query rows in f32; warp w holds rows w * RPW .. w * RPW + RPW - 1
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + (long long)(h * p.rep + row0) * p.q_sh;
  for (int e = tid; e < kWarps * RPW * p.hd; e += kThreads) {
    const int r = e / p.hd;
    q_s[e] = r < nrows ? repro_to_f32(qb[r * p.q_sh + e % p.hd]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = REPRO_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  const bool active = warp * RPW < nrows;  // a warp with no query row only loads
  const float* qw = q_s + warp * RPW * p.hd;
  float* pwl = pw + warp * kTile * RPW;    // this warp's probabilities, [entry][row]

  // the split's tiles, kMaskTiles at a time (one chunk unless the range is long)
  for (int c0 = 0; c0 < nt; c0 += kMaskTiles) {
    const int cn = min(kMaskTiles, nt - c0);
    if (c0 > 0) __syncthreads();  // every warp is done with the masks and buffers
    // which entries of each tile are valid: one ballot a tile
    for (int t = warp; t < cn; t += kWarps) {
      const int j = (t0 + c0 + t) * kTile + lane;
      bool valid = false;
      if (j < p.Skv) {
        const int pos = pb[j * p.kp_ss];
        valid = pos >= 0 && pos <= qp && (p.window == 0 || qp - pos < p.window);
      }
      const unsigned vm = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) masks[t] = vm;
    }
    __syncthreads();

    // tile t of the chunk into buffer s: its valid K and V rows; masked
    // entries and those past Skv zero-filled
    auto load = [&](int t, int s) {
      const long long j0 = (long long)(t0 + c0 + t) * kTile;
      const unsigned vm = masks[t];
      unsigned char* kd = k_s + s * kTile * p.k_row;
      unsigned char* vd = v_s + s * kTile * p.v_row;
      const int kch = kbytes / 16;
      for (int c = tid; c < kTile * kch; c += kThreads) {
        const int r = c / kch, off = (c - r * kch) * 16;
        const bool ok = (vm >> r) & 1u;
        cp_async16(kd + r * p.k_row + off, ok ? kb + (j0 + r) * kss + off : kb, ok);
      }
      const int vp = p.v_piece, vch = vbytes / vp;
      for (int c = tid; c < kTile * vch; c += kThreads) {
        const int r = c / vch, off = (c - r * vch) * vp;
        const bool ok = (vm >> r) & 1u;
        unsigned char* dst = vd + r * p.v_row + off;
        const unsigned char* src = ok ? vb + (j0 + r) * vss + off : vb;
        if (vp == 16) {
          cp_async16(dst, src, ok);
        } else if (vp == 4) {
          cp_async4(dst, src, ok);
        } else {  // V only 2-byte aligned (bf16): a plain copy
          *reinterpret_cast<uint16_t*>(dst) = ok ? *reinterpret_cast<const uint16_t*>(src) : 0;
        }
      }
    };
    auto next_live = [&](int t) {
      while (t < cn && masks[t] == 0u) ++t;
      return t;
    };

    int cur = next_live(0), s = 0;
    if (cur < cn) load(cur, 0);
    cp_async_commit();
    while (cur < cn) {
      const int nxt = next_live(cur + 1);
      cp_async_wait<0>();
      __syncthreads();  // tile cur landed; every warp is done with the other buffer
      if (nxt < cn) load(nxt, s ^ 1);
      cp_async_commit();
      if (active) {
        const bool valid = (masks[cur] >> lane) & 1u;
        const unsigned char* krow = k_s + (s * kTile + lane) * p.k_row;
        const unsigned char* vt = v_s + s * kTile * p.v_row;

        // scores: lane = entry, its K row against every query row, four
        // partial sums a row (independent chains)
        float sc[RPW][4];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[r][i] = 0.f;
#pragma unroll 2
        for (int c = 0; c < kbytes; c += 16) {
          float kf[kVec];
          unpack16<T>(*reinterpret_cast<const uint4*>(krow + c), kf);
          const int d = c / (int)sizeof(T);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const float4* q4 = reinterpret_cast<const float4*>(qw + r * p.hd + d);
#pragma unroll
            for (int t4 = 0; t4 < kVec / 4; ++t4) {
              const float4 qq = q4[t4];  // one broadcast read: 4 query values
              sc[r][0] = fmaf(qq.x, kf[4 * t4], sc[r][0]);
              sc[r][1] = fmaf(qq.y, kf[4 * t4 + 1], sc[r][1]);
              sc[r][2] = fmaf(qq.z, kf[4 * t4 + 2], sc[r][2]);
              sc[r][3] = fmaf(qq.w, kf[4 * t4 + 3], sc[r][3]);
            }
          }
        }
        // softcap, mask, then the online-softmax update of the warp's rows
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          float x = ((sc[r][0] + sc[r][1]) + (sc[r][2] + sc[r][3])) * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          x = valid ? x : REPRO_NEG_INF;
          const float m_new = fmaxf(m[r], repro_warp_max(x));
          const float pj = valid ? expf(x - m_new) : 0.f;  // a masked entry adds an exact 0
          const float alpha = expf(m[r] - m_new);
          l[r] = l[r] * alpha + repro_warp_sum(pj);
          m[r] = m_new;
          pwl[lane * RPW + r] = pj;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
        }
        __syncwarp();
        // values: lane = dimensions lane * DPL ..; probabilities broadcast.
        // A masked entry's V row is zero-filled: 0 * 0 adds nothing.
        if (lane * DPL < p.hdv) {
          const unsigned char* vcol = vt + lane * DPL * (int)sizeof(T);
#pragma unroll 8
          for (int jj = 0; jj < kTile; ++jj) {
            float pr[RPW];
            if constexpr (RPW == 2) {
              const float2 t = *reinterpret_cast<const float2*>(pwl + jj * 2);
              pr[0] = t.x;
              pr[1] = t.y;
            } else {
              pr[0] = pwl[jj];
            }
            float vf[DPL];
            values<T, DPL>(vcol + jj * p.v_row, vf);
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
  }

  T* ob = static_cast<T*>(p.out) + b * p.o_sb + (long long)(h * p.rep + row0) * p.o_sh;
  const int d0 = lane * DPL;
  if (p.split.splits == 1) {  // the whole pool: finish here
    if (active && d0 < p.hdv) {
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int row = warp * RPW + r;
        if (row >= nrows) break;
        const float lr = l[r] == 0.f ? 1.f : l[r];  // empty slot -> exact zeros
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          ob[row * p.o_sh + d0 + i] = repro_from_f32<T>(acc[r][i] / lr);
      }
    }
    return;
  }
  // this split's part, then the merge by the last split to finish
  const int unit = (b * p.Hkv + h) * p.groups + g;
  const int rows = p.split.rows;
  float* part = p.split.part(unit, split);
  if (active) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      if (row >= nrows) break;
      if (d0 < p.hdv) {
#pragma unroll
        for (int i = 0; i < DPL; i += 4)
          *reinterpret_cast<float4*>(part + row * p.hdv + d0 + i) =
              make_float4(acc[r][i], acc[r][i + 1], acc[r][i + 2], acc[r][i + 3]);
      }
      if (lane == 0) {
        part[rows * p.hdv + row] = m[r];
        part[rows * p.hdv + rows + row] = l[r];
      }
    }
  }
  if (!split_kv_last(p.split, unit)) return;
  split_kv_merge<T>(p.split, unit, ob, p.o_sh, nrows);
}

template <typename T, int RPW, int DPL>
cudaError_t launch_kernel(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = Layout(p, RPW).bytes;
  cudaError_t err = repro_smem_limit<decode_attention_kernel<T, RPW, DPL>>(smem);
  if (err != cudaSuccess) return err;
  decode_attention_kernel<T, RPW, DPL>
      <<<dim3(p.split.splits, p.Hkv * p.groups, B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int RPW>
cudaError_t launch_rows(const Params& p, int B, cudaStream_t stream) {
  if (p.hdv <= 128) return launch_kernel<T, RPW, 4>(p, B, stream);
  if (p.hdv <= 256) return launch_kernel<T, RPW, 8>(p, B, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  // 16-byte K copies: base and every K row offset whole vectors
  if (reinterpret_cast<uintptr_t>(p.k) % 16 || p.k_sb % kVec || p.k_ss % kVec || p.k_sh % kVec)
    return cudaErrorMisalignedAddress;
  // V in the largest pieces its base and strides allow (hdv * sizeof(T) is
  // a multiple of 16)
  const long long es = sizeof(T);
  auto aligned = [&](int n) {
    return reinterpret_cast<uintptr_t>(p.v) % n == 0 && (p.v_sb * es) % n == 0 &&
           (p.v_ss * es) % n == 0 && (p.v_sh * es) % n == 0;
  };
  p.v_piece = aligned(16) ? 16 : aligned(4) ? 4 : 2;
  if (p.v_piece == 2 && (sizeof(T) != 2 || !aligned(2))) return cudaErrorMisalignedAddress;
  const int kw = p.hd * (int)sizeof(T) / 16;  // K rows an odd number of 16-byte words
  p.k_row = 16 * (kw | 1);
  p.v_row = p.hdv * (int)sizeof(T);
  if (p.split.rows <= kWarps) return launch_rows<T, 1>(p, B, stream);
  if (p.split.rows <= 2 * kWarps) return launch_rows<T, 2>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Strides are in elements; every tensor's last dimension is contiguous.
// q (B, 1, Hq, hd): q_sb, q_sh.  k/v (B, Skv, Hkv, hd/hdv): *_sb, *_ss,
// *_sh, with K rows 16-byte aligned (base and strides) and V rows at any
// element alignment.  q_pos (B, 1) int32: qp_sb.  kv_pos (B, Skv) int32:
// kp_sb, kp_ss.  out (B, 1, Hq, hdv): o_sb, o_sh.  hd and hdv multiples of
// 8 up to 256.  The rep = Hq / Hkv query rows of a KV head go in groups of
// `rows` (1..16; the last group may be short).  The split plan: `splits`
// blocks a (slot, KV head, group), each over `tiles` 32-entry tiles of the
// pool (splits * tiles * 32 >= Skv); with splits > 1, ws holds B * Hkv *
// groups * splits parts of rows * hdv + 2 * rows f32 (rounded up to 4) and
// tickets B * Hkv * groups zeros of this stream.  Returns the launch's
// cudaError_t.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* q_pos, const void* kv_pos,
    void* out, void* ws, void* tickets, int B, int Skv, int Hq, int Hkv, int hd, int hdv,
    int rows, int splits, int tiles, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long qp_sb, long long kp_sb, long long kp_ss, long long o_sb, long long o_sh,
    int window, float softcap, float scale, int dtype, void* stream) {
  if (Hkv < 1 || Hq % Hkv || hd % 8 || hdv % 8 || hd > 256 || hdv > 256 || rows < 1 ||
      rows > 2 * kWarps)
    return cudaErrorInvalidValue;
  const int rep = Hq / Hkv, groups = (rep + rows - 1) / rows;
  const int ntiles = (Skv + kTile - 1) / kTile;
  if (splits < 1 || tiles < 1 || (long long)splits * tiles < ntiles ||
      (long long)(splits - 1) * tiles >= ntiles || (splits > 1 && (!ws || !tickets)) ||
      rows > rep)
    return cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos), out,
           SplitKV{static_cast<float*>(ws), static_cast<int*>(tickets), splits, rows, hdv},
           Skv, Hkv, rep, groups, hd, hdv, tiles, q_sb, q_sh,
           k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, qp_sb, kp_sb, kp_ss, o_sb, o_sh,
           window, softcap, scale, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16) return launch<__nv_bfloat16>(p, B, s);
  if (dtype == REPRO_F32) return launch<float>(p, B, s);
  return cudaErrorInvalidValue;
}
