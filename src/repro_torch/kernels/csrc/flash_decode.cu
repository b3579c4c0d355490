// flash_decode for Hopper (sm_90a): one-query attention over a preallocated
// K/V cache.
//
// Replaces the Pallas TPU kernel repro.kernels.decode_attention.flash_decode
// (src/repro/kernels/decode_attention.py:66, body _kernel :26-63).
//
// What bounds it: bytes.  Each cached key and value is read once and used
// for one multiply-add per query row of the GQA group (g = Hq/Hkv rows), so
// the arithmetic intensity is about g/2 flop per byte in bf16, far below the
// card's ~295 flop/byte ridge.  The time floor is the K/V bytes up to kv_len
// over 3.35 TB/s.
//
// Design:
//   * One block per (batch, KV head, KV split).  The block holds the g query
//     rows that share the KV head, so every K/V byte read from device memory
//     serves all g rows (the TPU kernel's "GQA group forms the q tile").
//   * The TPU grid's sequential KV axis, which carried (m, l, acc) in VMEM
//     scratch, becomes a loop over 64-key tiles inside the block; the tiles
//     are staged in shared memory as fp32 with a padded row stride so the
//     column reads of the score and PV phases are free of bank conflicts.
//     Each thread issues its 16-byte loads of a tile together, so a tile
//     costs about one trip to device memory, not one per element.
//   * Only tiles below kv_len are read: the cache past kv_len is never
//     touched, so the bytes moved follow the sequence, not the capacity.
//   * Split-KV: at batch 4 the (batch, KV head) grid has only 32 blocks for
//     132 SMs.  The wrapper splits the valid tiles over gridDim.z so the grid
//     fills the card; each split writes its fp32 (m, l, acc) partials and a
//     second small kernel merges them.  With one split the first kernel
//     writes the output directly.
//   * Online softmax in fp32 with the finite mask sentinel -1e30 (never
//     -inf), and the output divided by max(l, 1e-30), as on the TPU.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int NT = 128;             // threads per block (4 warps)
constexpr int BK = 64;              // keys per tile (two per lane in a warp)
constexpr int MAX_GHD = 2048;       // largest g * hd held in registers
constexpr int ACC_PER_THREAD = MAX_GHD / NT;
constexpr int LOAD_BATCH = 8;       // 16-byte loads in flight per tensor
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Convert one 16-byte vector of T to fp32 in shared memory.
__device__ __forceinline__ void store_vec(float* dst, const uint4& r, float) {
  const float* e = reinterpret_cast<const float*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = e[i];
}
__device__ __forceinline__ void store_vec(float* dst, const uint4& r,
                                          __nv_bfloat16) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct DecodeArgs {
  const void* q;          // (B, Hq, 1, hd)
  const void* k;          // (B, Hkv, T, hd), any strides with unit last dim
  const void* v;
  void* o;                // (B, Hq, 1, hd)
  float* part_acc;        // (B*Hq, n_split, hd)   when n_split > 1
  float* part_ml;         // (B*Hq, n_split, 2)
  int B, Hq, Hkv, T, hd, g;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh;
  int kv_len;             // 1 <= kv_len <= T
  float softcap, scale;
  int n_split, tiles_per_split;
};

template <typename T>
__global__ void __launch_bounds__(NT) decode_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd, g = a.g, ld = hd + 1;
  float* qs = smem;                 // g * hd, pre-scaled queries
  float* ks = qs + g * hd;          // BK * ld
  float* vs = ks + BK * ld;         // BK * ld
  float* ps = vs + BK * ld;         // g * BK scores, then probabilities
  float* row_m = ps + g * BK;       // g running max
  float* row_l = row_m + g;         // g running sum
  float* row_alpha = row_l + g;     // g rescale of this tile

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  for (int i = tid; i < g * hd; i += NT) {
    const int r = i / hd, d = i - r * hd;
    qs[i] = to_f(q[b * a.q_sb + (h * g + r) * a.q_sh + d]) * a.scale;
  }
  if (tid < g) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }
  float acc[ACC_PER_THREAD];
#pragma unroll
  for (int c = 0; c < ACC_PER_THREAD; ++c) acc[c] = 0.f;

  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte load
  const int vec_per_row = hd / VEC, n_vec = BK * vec_per_row;
  const int t_begin = split * a.tiles_per_split * BK;
  const int t_end = min(a.kv_len, t_begin + a.tiles_per_split * BK);
  for (int t0 = t_begin; t0 < t_end; t0 += BK) {
    __syncthreads();  // the previous tile is consumed; q and row state set
    // Stage the tile as fp32.  Each thread issues all its 16-byte loads
    // before it stores any, so the loads wait on device memory together
    // rather than one after another.
    for (int base = 0; base < n_vec; base += LOAD_BATCH * NT) {
      uint4 kr[LOAD_BATCH], vr[LOAD_BATCH];
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u) {
        const int i = base + u * NT + tid;
        const int j = i / vec_per_row, c = i - j * vec_per_row, t = t0 + j;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < n_vec && t < a.T) {
          kr[u] = *reinterpret_cast<const uint4*>(k + t * a.k_st + c * VEC);
          vr[u] = *reinterpret_cast<const uint4*>(v + t * a.v_st + c * VEC);
        }
      }
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u) {
        const int i = base + u * NT + tid;
        if (i < n_vec) {
          const int j = i / vec_per_row, c = i - j * vec_per_row;
          store_vec(ks + j * ld + c * VEC, kr[u], T());
          store_vec(vs + j * ld + c * VEC, vr[u], T());
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < g * BK; i += NT) {
      const int r = i / BK, j = i - r * BK;
      const float* qr = qs + r * hd;
      const float* kr = ks + j * ld;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;   // four chains
      for (int d = 0; d < hd; d += 4) {
        s0 = fmaf(qr[d], kr[d], s0);
        s1 = fmaf(qr[d + 1], kr[d + 1], s1);
        s2 = fmaf(qr[d + 2], kr[d + 2], s2);
        s3 = fmaf(qr[d + 3], kr[d + 3], s3);
      }
      float s = (s0 + s1) + (s2 + s3);
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      ps[i] = (t0 + j < a.kv_len) ? s : NEG_INF;
    }
    __syncthreads();
    for (int r = warp; r < g; r += NT / 32) {
      float* pr = ps + r * BK;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < ACC_PER_THREAD; ++c) {
      const int i = tid + c * NT;
      if (i < g * hd) {
        const int r = i / hd, d = i - r * hd;
        const float* pr = ps + r * BK;
        float s0 = 0.f, s1 = 0.f;                   // two chains
        for (int j = 0; j < BK; j += 2) {
          s0 = fmaf(pr[j], vs[j * ld + d], s0);
          s1 = fmaf(pr[j + 1], vs[(j + 1) * ld + d], s1);
        }
        acc[c] = fmaf(acc[c], row_alpha[r], s0 + s1);
      }
    }
  }
  __syncthreads();

  if (a.n_split == 1) {
    T* o = static_cast<T*>(a.o);
#pragma unroll
    for (int c = 0; c < ACC_PER_THREAD; ++c) {
      const int i = tid + c * NT;
      if (i < g * hd) {
        const int r = i / hd, d = i - r * hd;
        o[b * a.o_sb + (h * g + r) * a.o_sh + d] =
            from_f<T>(acc[c] / fmaxf(row_l[r], 1e-30f));
      }
    }
  } else {
    const long long row0 = (long long)b * a.Hq + h * g;
#pragma unroll
    for (int c = 0; c < ACC_PER_THREAD; ++c) {
      const int i = tid + c * NT;
      if (i < g * hd) {
        const int r = i / hd, d = i - r * hd;
        a.part_acc[((row0 + r) * a.n_split + split) * hd + d] = acc[c];
      }
    }
    if (tid < g) {
      float* ml = a.part_ml + ((row0 + tid) * a.n_split + split) * 2;
      ml[0] = row_m[tid];
      ml[1] = row_l[tid];
    }
  }
}

// Merge the split partials of one (batch, q head) row: one thread per dim.
template <typename T>
__global__ void decode_combine(DecodeArgs a) {
  const int row = blockIdx.x, d = threadIdx.x;
  const int b = row / a.Hq, hq = row - b * a.Hq;
  const float* ml = a.part_ml + (long long)row * a.n_split * 2;
  float m = NEG_INF;
  for (int s = 0; s < a.n_split; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < a.n_split; ++s) {
    const float w = expf(ml[2 * s] - m);
    l = fmaf(ml[2 * s + 1], w, l);
    acc = fmaf(a.part_acc[((long long)row * a.n_split + s) * a.hd + d], w, acc);
  }
  T* o = static_cast<T*>(a.o);
  o[b * a.o_sb + hq * a.o_sh + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T>
int launch(DecodeArgs a, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (a.g * a.hd + 2 * BK * (a.hd + 1) + a.g * BK + 3 * a.g);
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(decode_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         227 * 1024);
    opted_in = true;
  }
  decode_kernel<T><<<dim3(a.B, a.Hkv, a.n_split), NT, smem, stream>>>(a);
  if (a.n_split > 1) {
    decode_combine<T><<<a.B * a.Hq, a.hd, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_decode_launch(
    int is_bf16, const void* q, const void* k, const void* v, void* o,
    float* part_acc, float* part_ml, int B, int Hq, int Hkv, int T, int hd,
    const long long* strides, int kv_len, float softcap, int n_split,
    int tiles_per_split, void* stream) {
  const int g = Hq / Hkv;
  const int vec = is_bf16 ? 8 : 4;
  if (Hq % Hkv != 0 || g * hd > MAX_GHD || hd > 1024 || hd % vec != 0 ||
      kv_len < 1 || kv_len > T || n_split < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.part_acc = part_acc; a.part_ml = part_ml;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.T = T; a.hd = hd; a.g = g;
  a.q_sb = strides[0]; a.q_sh = strides[1];
  a.k_sb = strides[2]; a.k_sh = strides[3]; a.k_st = strides[4];
  a.v_sb = strides[5]; a.v_sh = strides[6]; a.v_st = strides[7];
  a.o_sb = strides[8]; a.o_sh = strides[9];
  a.kv_len = kv_len;
  a.softcap = softcap;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  a.n_split = n_split;
  a.tiles_per_split = tiles_per_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
