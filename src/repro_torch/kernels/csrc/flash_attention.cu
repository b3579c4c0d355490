// flash_attention for Hopper (sm_90a): blocked attention with an fp32
// online softmax.
//
// Replaces the Pallas TPU kernel repro.kernels.flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py:85, body _kernel :33-82), with its
// whole contract: causal masking with q_offset, a sliding window
// (q - k < window, with causal), an optional kv_len, padded keys, an
// optional tanh softcap, scale 1/sqrt(hd), and GQA (q head h reads KV head
// h / g).
//
// What bounds it: operations.  A causal prefill of S tokens does about
// 2 * S^2 * hd multiply-adds per head over S * hd inputs, far above the
// card's ridge.  This first version computes in fp32 on the CUDA cores (the
// fp32 sweep holds it to 2e-5, which TF32 or bf16 tensor cores could not
// meet); a later version moves the two products onto wgmma.
//
// Design:
//   * One block per (q tile of 64 rows, q head, batch).  At head dims 16,
//     32 and 64 one thread owns one query row, holding its scaled q, its
//     fp32 accumulator and the row's running max and sum in registers.  A
//     wider head would not fit in 255 registers (q and acc alone are 2 hd
//     floats), so from hd 128 a row is split over LANES = hd / 32
//     neighbouring lanes of a warp: each lane holds 32 dims of q and of
//     the accumulator (dims sub, sub + LANES, ..., so the lanes of a row
//     read neighbouring shared-memory words), a score is summed over the
//     lanes with __shfl_xor_sync, and the butterfly leaves the same sum,
//     hence the same running max and sum, on every lane of the row.  hd
//     128 runs 4 lanes a row, 256 threads a block.
//   * The TPU grid's sequential KV axis becomes a loop over KV tiles inside
//     the block.  Each tile is staged once in shared memory as fp32 and read
//     by every thread of the block at the same address (a broadcast), so a
//     K/V byte fetched from device memory serves all 64 rows of the tile.
//   * The loop runs only over tiles the block can see: up to the causal
//     limit of its last row, from the window's start for its first row, and
//     below kv_len.  Rows mask the rest element by element.
//   * Masked scores take the finite sentinel -1e30, never -inf, so a fully
//     masked leading tile is wiped later by alpha = exp(-1e30 - m) = 0; the
//     output is acc / max(l, 1e-30), written in q's dtype.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;              // query rows per block
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

struct AttnArgs {
  const void* q;          // (B, Hq, Sq, hd), any strides with unit last dim
  const void* k;          // (B, Hkv, Skv, hd)
  const void* v;
  void* o;                // (B, Hq, Sq, hd)
  int Sq, Skv, g;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window, q_offset, kv_lim;   // kv_lim = min(Skv, kv_len)
  float softcap, scale;
};

template <typename T, int HD, int BK, int LANES>
__global__ void __launch_bounds__(BQ * LANES) attn_kernel(AttnArgs a) {
  constexpr int DL = HD / LANES;      // dims of q and acc held per lane
  __shared__ __align__(16) float ks[BK][HD];
  __shared__ __align__(16) float vs[BK][HD];

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.g;
  const int sub = threadIdx.x % LANES;    // this lane's dims: sub + LANES*i
  const int row = qi * BQ + threadIdx.x / LANES;
  const bool live = row < a.Sq;
  const int q_pos = row + a.q_offset;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  float q[DL], acc[DL];
  {
    const T* qr = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                  (long long)row * a.q_ss;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      q[i] = live ? to_f(qr[i * LANES + sub]) * a.scale : 0.f;
      acc[i] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  // Key range the block can see.
  const int first_pos = qi * BQ + a.q_offset;
  const int last_pos = min(qi * BQ + BQ, a.Sq) - 1 + a.q_offset;
  int kv_end = a.kv_lim;
  int kv_begin = 0;
  if (a.causal) {
    kv_end = min(kv_end, last_pos + 1);
    if (a.window > 0) kv_begin = max(0, first_pos - a.window + 1) / BK * BK;
  }

  for (int t0 = kv_begin; t0 < kv_end; t0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < BK * HD; i += BQ * LANES) {
      const int j = i / HD, d = i - j * HD, t = t0 + j;
      ks[j][d] = t < a.Skv ? to_f(k[t * a.k_ss + d]) : 0.f;
      vs[j][d] = t < a.Skv ? to_f(v[t * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float x = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) x = fmaf(q[i], ks[j][i * LANES + sub], x);
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1) {
        x += __shfl_xor_sync(0xffffffffu, x, off);
      }
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      const int kp = t0 + j;
      bool keep = kp < a.kv_lim;
      if (a.causal) {
        keep = keep && kp <= q_pos;
        if (a.window > 0) keep = keep && (q_pos - kp) < a.window;
      }
      s[j] = keep ? x : NEG_INF;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        acc[i] = fmaf(p, vs[j][i * LANES + sub], acc[i]);
      }
    }
    m = m_new;
  }

  if (live) {
    T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh +
           (long long)row * a.o_ss;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      o[i * LANES + sub] = from_f<T>(acc[i] / denom);
    }
  }
}

template <typename T, int HD>
int launch_hd(const AttnArgs& a, int B, int Hq, cudaStream_t stream) {
  constexpr int BK = 32;              // keys per tile
  constexpr int LANES = HD <= 64 ? 1 : HD / 32;   // lanes per query row
  const dim3 grid((a.Sq + BQ - 1) / BQ, Hq, B);
  attn_kernel<T, HD, BK, LANES><<<grid, BQ * LANES, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const AttnArgs& a, int B, int Hq, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(a, B, Hq, stream);
    case 32: return launch_hd<T, 32>(a, B, Hq, stream);
    case 64: return launch_hd<T, 64>(a, B, Hq, stream);
    case 128: return launch_hd<T, 128>(a, B, Hq, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_launch(
    int is_bf16, const void* q, const void* k, const void* v, void* o, int B,
    int Hq, int Hkv, int Sq, int Skv, int hd, const long long* strides,
    int causal, int window, float softcap, int q_offset, int kv_len,
    void* stream) {
  if (Hq % Hkv != 0 || Sq < 1 || Skv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.Sq = Sq; a.Skv = Skv; a.g = Hq / Hkv;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_ss = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_ss = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_ss = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_ss = strides[11];
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.kv_lim = kv_len < Skv ? kv_len : Skv;
  a.softcap = softcap;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, B, Hq, hd, s)
                 : launch<float>(a, B, Hq, hd, s);
}
