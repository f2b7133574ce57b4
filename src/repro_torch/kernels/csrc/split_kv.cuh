// Split-KV: one attention unit (a slot and KV head of a decode) swept by
// several blocks, each over a contiguous range of pool indices, and merged
// in the same launch.
//
// Each block keeps an f32 online-softmax state (m, l, acc) per query row
// over its range and writes it to the workspace as one part: acc (rows x
// hdv), then m (rows), then l (rows), padded to whole float4s.  The last
// block of a unit to finish (a __threadfence and an atomic ticket, reset
// for the next launch) merges the parts in split order:
//
//   M = max_s m_s,  f_s = exp(m_s - M),
//   out = (sum_s f_s acc_s) / (sum_s f_s l_s),   with l == 0 -> 1,
//
// so the result does not depend on which block finished last, and a unit
// whose every entry is masked (an empty slot) gives exact zeros.  A split
// with no valid entry carries m = REPRO_NEG_INF, l = 0, acc = 0 and adds
// nothing.  The tickets belong to the stream: launches on one stream run
// one after another and find them at zero.
#pragma once

#include "common.cuh"

struct SplitKV {
  float* ws;     // units x splits parts, f32
  int* tickets;  // one per unit, zero before and after every launch
  int splits, rows, hdv;

  // floats of one part: acc, m, l, padded to a multiple of 4
  __host__ __device__ long long part_floats() const {
    return (long long)rows * hdv + ((2 * rows + 3) & ~3);
  }
  __device__ float* part(int unit, int split) const {
    return ws + ((long long)unit * splits + split) * part_floats();
  }
};

// Called by every thread of the block after it wrote its part.  True in
// the block that finished last for `unit`, whose ticket it resets.
__device__ __forceinline__ bool split_kv_last(const SplitKV& kv, int unit) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* t = kv.tickets + unit;
    last = atomicAdd(t, 1) == kv.splits - 1;
    if (last) *t = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The merge, by the last block: out row r at out + r * o_sr (the rows of
// one unit; only the first `nrows` when given, for a unit of fewer rows
// than its part holds; only the first `ncols` columns when given, for
// parts whose rows are padded past the output's).  hdv is a multiple of 4.  Parts are read through
// L2 (__ldcg): other blocks wrote them.  A thread takes a float4 of acc and the m, l of
// its row from kChunk splits at once, all loads in flight together (one
// trip to L2 when splits <= kChunk; else a first pass finds M), and adds
// them in split order.
template <typename T>
__device__ void split_kv_merge(const SplitKV& kv, int unit, T* __restrict__ out,
                               long long o_sr, int nrows = -1, int ncols = -1) {
  constexpr int kChunk = 16;
  const int rows = kv.rows, hdv = kv.hdv, splits = kv.splits;
  const int n = nrows < 0 ? rows : nrows, cols = ncols < 0 ? hdv : ncols;
  const long long stride = kv.part_floats();
  const float* base = kv.part(unit, 0);
  for (int g = threadIdx.x; g < n * hdv / 4; g += blockDim.x) {
    const int e = 4 * g, r = e / hdv, d = e % hdv;
    const float* ml = base + (long long)rows * hdv + r;  // m at ml[0], l at ml[rows]
    float M = REPRO_NEG_INF;
    if (splits > kChunk) {
#pragma unroll 16
      for (int s = 0; s < splits; ++s) M = fmaxf(M, __ldcg(ml + s * stride));
    }
    float L = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += kChunk) {
      float mv[kChunk], lv[kChunk];
      float4 av[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (s0 + u >= splits) break;
        const long long off = (s0 + u) * stride;
        mv[u] = __ldcg(ml + off);
        lv[u] = __ldcg(ml + off + rows);
        av[u] = __ldcg(reinterpret_cast<const float4*>(base + off + e));
      }
      if (splits <= kChunk) {
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (u < splits) M = fmaxf(M, mv[u]);
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {  // in split order
        if (s0 + u >= splits) break;
        const float f = expf(mv[u] - M);
        L = fmaf(lv[u], f, L);
        o.x = fmaf(av[u].x, f, o.x);
        o.y = fmaf(av[u].y, f, o.y);
        o.z = fmaf(av[u].z, f, o.z);
        o.w = fmaf(av[u].w, f, o.w);
      }
    }
    if (L == 0.f) L = 1.f;  // empty unit -> exact zeros
    T* p = out + r * o_sr + d;
    const float v[4] = {o.x / L, o.y / L, o.z / L, o.w / L};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d + i < cols) p[i] = repro_from_f32<T>(v[i]);
  }
}
