// flash_decode for Hopper (sm_90a): one-query attention over a preallocated
// K/V cache, in one launch.
//
// Replaces the Pallas TPU kernel repro.kernels.decode_attention.flash_decode
// (src/repro/kernels/decode_attention.py:66, body _kernel :26-63).
//
// What bounds it: bytes.  Each cached key and value is read once and used
// for one multiply-add per query row of the GQA group (g = Hq/Hkv rows), so
// the arithmetic intensity is about g/2 flop per byte in bf16, far below the
// card's ~295 flop/byte ridge.  The time floor is the K/V bytes up to kv_len
// over 3.35 TB/s; at the serving shapes (a few hundred keys) that is under
// 2 us, so what a call costs is its chain of dependent latencies: the
// launch, one trip to device memory, the merge.
//
// Design:
//   * One block per (batch, KV head, group slice, KV split).  The block
//     holds up to gs query rows that share the KV head, so every K/V byte
//     read from device memory serves all of them (the TPU kernel's "GQA
//     group forms the q tile").  At a few rows the tensor cores would buy
//     nothing: CUDA cores, fp32 math.
//   * Group slices: a block keeps its rows' outputs in registers, at most
//     1,024 pairs of columns (8 a thread), so a group wider than that
//     (StarCoder's 48 heads at hd 128, Falcon-7B's 71 at hd 64) is cut into
//     ceil(g / gs) slices of gs <= 1024 / ceil(hd / 2) rows, each its own
//     block streaming the same K/V tiles, which L2 mostly catches.  The
//     wrapper's plan picks gs, the key tile (32 keys, 16 where two stages
//     of 32 would not fit the 227 KB: fp32 rows past hd 441) and the split.
//   * Split-KV: at batch 4 the (batch, KV head) grid has only 32 blocks for
//     132 SMs, so the wrapper's split_plan spreads the valid key tiles
//     over gridDim.z (at kv_len 272: 9 splits of one tile, 288 blocks).
//   * Bytes in flight: a block issues its first two K/V tiles (at the
//     serving shapes, its whole range) as cp.async 16-byte copies before it
//     touches q, then waits once; longer splits stream through the same
//     2-stage ring, a tile refilled as soon as it is consumed.  Tiles stay
//     in the input dtype in shared memory (bf16 is converted on read), each
//     row rounded up to whole 16-byte vectors and padded by 16 more bytes,
//     so that a warp's 16-byte row reads (one key a lane) and its column
//     reads are free of bank conflicts.  Where some K or V row is not
//     whole 16-byte vectors at 16-byte aligned addresses (an odd hd or
//     stride), the kernel's other instantiation reads each vector's values
//     one by one, zero past hd, and the thread stores them itself.
//     Keys at or past kv_len are never read (the copy zero-fills them), so
//     the bytes moved follow the sequence, not the cache's capacity.
//   * One launch: each split writes its fp32 (m, l, acc) partials; the last
//     block of a (batch, KV head, group slice) to finish merges them.
//     Every block fences its partials (one thread, after a barrier) and
//     draws a ticket from an int32 counter per (batch, KV head, group
//     slice) with an atomic add; the block that draws n_split - 1 merges
//     the partials in one pass and writes the output, then stores 0 back
//     into the counter.  So a call leaves the counters zeroed, and
//     the next call on the same stream, which stream order starts only
//     after this kernel has finished, finds them so with no memset.  Two
//     calls on two streams at once would share counters: the wrapper keeps
//     one counter tensor per (device, stream).  With one split the block
//     writes the output directly and draws no ticket.
//   * Online softmax in fp32 with the finite mask sentinel -1e30 (never
//     -inf), and the output divided by max(l, 1e-30), as on the TPU.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 128;             // threads per block (4 warps)
constexpr int NSTAGE = 2;           // tiles in flight
constexpr int MAX_GHD = 2048;       // largest gs * 2 ceil(hd / 2) in registers
constexpr int PAIRS = MAX_GHD / 2 / NT;   // output pairs per thread
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
// The bits of one element, for the copies that do not convert.
template <typename T> struct Raw;
template <> struct Raw<float> { using type = uint32_t; };
template <> struct Raw<__nv_bfloat16> { using type = uint16_t; };

// One 16-byte vector of a staged row as fp32.
__device__ __forceinline__ void load16(float* e, const unsigned char* p,
                                       float) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  e[0] = r.x; e[1] = r.y; e[2] = r.z; e[3] = r.w;
}
__device__ __forceinline__ void load16(float* e, const unsigned char* p,
                                       __nv_bfloat16) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    e[2 * i] = f.x;
    e[2 * i + 1] = f.y;
  }
}
// Two neighbouring elements of a staged row as fp32.
__device__ __forceinline__ float2 load2(const unsigned char* p, float) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const unsigned char* p,
                                        __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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
  float* part_acc;        // (B*Hq, n_split, 2 ceil(hd / 2)) when n_split > 1
  float* part_ml;         // (B*Hq, n_split, 2)
  int* tickets;           // (B*Hkv*ngs), zero between calls
  int B, Hq, Hkv, T, hd, g;
  int gs, ngs;            // rows of a group slice, slices of a group
  int vec;                // every K and V row 16-byte aligned, whole vectors
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh;
  int kv_len;             // 1 <= kv_len <= T
  float softcap, scale;
  int n_split, tiles_per_split;
};

// Elements of a staged row of q, K or V: hd rounded up to whole 16-byte
// vectors (zeros past hd).
__host__ __device__ constexpr int staged(int hd, int item) {
  return (hd * item + 15) / 16 * 16 / item;
}
// Bytes of one staged K or V row: the staged elements and a 16-byte pad.
__host__ __device__ constexpr int row_bytes(int hd, int item) {
  return staged(hd, item) * item + 16;
}

// Dynamic shared memory: NSTAGE (K tile, V tile) pairs of bk keys, then
// fp32 q, the tile's probabilities and the rows' running max, sum and
// rescale (decode_attention.smem_bytes on the host).
size_t smem_bytes(int gs, int hd, int item, int bk) {
  return static_cast<size_t>(NSTAGE) * 2 * bk * row_bytes(hd, item) +
         sizeof(float) * (gs * staged(hd, item) + gs * bk + 3 * gs);
}

template <typename T, int BK, bool ALIGNED>
__global__ void __launch_bounds__(NT, 4) decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte vector
  using R = typename Raw<T>::type;
  // ALIGNED rows are whole 16-byte vectors (hd * itemsize % 16 == 0).
  const int hd = a.hd, hdq = ALIGNED ? hd : staged(hd, sizeof(T));
  const int hp2 = (hd + 1) / 2;             // column pairs of a row
  const int rb = row_bytes(hd, sizeof(T)), tile_b = BK * rb;
  const int b = blockIdx.x, split = blockIdx.z;
  const int h = blockIdx.y / a.ngs, slice = blockIdx.y - h * a.ngs;
  const int qh0 = h * a.g + slice * a.gs;    // this block's first q head
  const int g = min(a.gs, a.g - slice * a.gs);   // its rows
  float* qs = reinterpret_cast<float*>(smem + NSTAGE * 2 * tile_b);
  float* ps = qs + a.gs * hdq;      // g * BK scores, then probabilities
  float* row_m = ps + a.gs * BK;    // g running max
  float* row_l = row_m + a.gs;      // g running sum
  float* row_alpha = row_l + a.gs;  // g rescale of this tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int t_begin = split * a.tiles_per_split * BK;
  const int t_end = min(a.kv_len, t_begin + a.tiles_per_split * BK);
  const int n_tiles = (t_end - t_begin + BK - 1) / BK;   // >= 1

  const int vpr = hdq / VEC;
  // Issue tile t's copies into its stage, one commit group per tile.
  auto issue = [&](int t) {
    unsigned char* ks = smem + (t % NSTAGE) * 2 * tile_b;
    unsigned char* vs = ks + tile_b;
    const int t0 = t_begin + t * BK;
    for (int i = tid; i < BK * vpr; i += NT) {
      const int j = i / vpr, c = i - j * vpr, key = t0 + j;
      const bool ok = key < t_end;
      if constexpr (ALIGNED) {
        cp_async16(ks + j * rb + c * 16, ok ? k + key * a.k_st + c * VEC : k,
                   ok ? 16 : 0);
        cp_async16(vs + j * rb + c * 16, ok ? v + key * a.v_st + c * VEC : v,
                   ok ? 16 : 0);
      } else {
        const R* kr = reinterpret_cast<const R*>(k + key * a.k_st);
        const R* vr = reinterpret_cast<const R*>(v + key * a.v_st);
        R* kd = reinterpret_cast<R*>(ks + j * rb + c * 16);
        R* vd = reinterpret_cast<R*>(vs + j * rb + c * 16);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int d = c * VEC + e;
          const bool in = ok && d < hd;
          kd[e] = in ? kr[d] : R(0);
          vd[e] = in ? vr[d] : R(0);
        }
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < NSTAGE && t < n_tiles; ++t) issue(t);

  // q, pre-scaled and zero past hd, while the first tiles are in flight.
  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < g * hdq; i += NT) {
    const int r = i / hdq, d = i - r * hdq;
    qs[i] = ALIGNED || d < hd
                ? to_f(q[b * a.q_sb + (qh0 + r) * a.q_sh + d]) * a.scale
                : 0.f;
  }
  for (int r = tid; r < g; r += NT) {
    row_m[r] = NEG_INF;
    row_l[r] = 0.f;
  }
  float acc[2 * PAIRS];
#pragma unroll
  for (int c = 0; c < 2 * PAIRS; ++c) acc[c] = 0.f;

  static_assert(NSTAGE == 2, "the waits below count one tile behind");
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      cp_async_wait<1>();           // all but tile t + 1 have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t in place for all; q and row state set
    const unsigned char* ks = smem + (t % NSTAGE) * 2 * tile_b;
    const unsigned char* vs = ks + tile_b;
    const int t0 = t_begin + t * BK;
    for (int i = tid; i < g * BK; i += NT) {
      const int r = i / BK, j = i - r * BK;
      const float* qr = qs + r * hdq;
      const unsigned char* kr = ks + j * rb;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;   // four chains
      for (int c = 0; c < vpr; ++c) {
        float e[VEC];
        load16(e, kr + c * 16, T());
        const float* qq = qr + c * VEC;
#pragma unroll
        for (int u = 0; u < VEC; u += 4) {
          s0 = fmaf(qq[u], e[u], s0);
          s1 = fmaf(qq[u + 1], e[u + 1], s1);
          s2 = fmaf(qq[u + 2], e[u + 2], s2);
          s3 = fmaf(qq[u + 3], e[u + 3], s3);
        }
      }
      float s = (s0 + s1) + (s2 + s3);
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      ps[i] = (t0 + j < t_end) ? s : NEG_INF;
    }
    __syncthreads();
    for (int r = warp; r < g; r += NT / 32) {
      const float s = lane < BK ? ps[r * BK + lane] : NEG_INF;
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < BK ? expf(s - m_new) : 0.f;
      if (lane < BK) ps[r * BK + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < PAIRS; ++c) {
      const int i = tid + c * NT;               // output pair
      if (i < g * hp2) {
        const int r = i / hp2, d = 2 * (i - r * hp2);
        const float* pr = ps + r * BK;
        const unsigned char* vc = vs + d * sizeof(T);
        float x0 = 0.f, x1 = 0.f;
#pragma unroll 8
        for (int j = 0; j < BK; ++j) {
          const float2 vv = load2(vc + j * rb, T());
          x0 = fmaf(pr[j], vv.x, x0);
          x1 = fmaf(pr[j], vv.y, x1);
        }
        acc[2 * c] = fmaf(acc[2 * c], row_alpha[r], x0);
        acc[2 * c + 1] = fmaf(acc[2 * c + 1], row_alpha[r], x1);
      }
    }
    __syncthreads();  // stage, probabilities and rescale consumed
    if (t + NSTAGE < n_tiles) issue(t + NSTAGE);
  }

  T* o = static_cast<T*>(a.o);
  if (a.n_split == 1) {
#pragma unroll
    for (int c = 0; c < PAIRS; ++c) {
      const int i = tid + c * NT;
      if (i < g * hp2) {
        const int r = i / hp2, d = 2 * (i - r * hp2);
        const float l = fmaxf(row_l[r], 1e-30f);
        T* od = o + b * a.o_sb + (qh0 + r) * a.o_sh + d;
        od[0] = from_f<T>(acc[2 * c] / l);
        if (d + 1 < hd) od[1] = from_f<T>(acc[2 * c + 1] / l);
      }
    }
    return;
  }

  // Partials of this split, then a ticket; the last split merges.  A
  // partial row holds 2 hp2 values, so its pairs stay 8-byte aligned.
  const long long row0 = (long long)b * a.Hq + qh0;
  const int pw = 2 * hp2;
#pragma unroll
  for (int c = 0; c < PAIRS; ++c) {
    const int i = tid + c * NT;
    if (i < g * hp2) {
      const int r = i / hp2, d = 2 * (i - r * hp2);
      float* pa = a.part_acc + ((row0 + r) * a.n_split + split) * pw + d;
      *reinterpret_cast<float2*>(pa) = make_float2(acc[2 * c], acc[2 * c + 1]);
    }
  }
  for (int r = tid; r < g; r += NT) {
    float* ml = a.part_ml + ((row0 + r) * a.n_split + split) * 2;
    ml[0] = row_m[r];
    ml[1] = row_l[r];
  }
  // The barrier orders every thread's partials before thread 0's
  // gpu-scope fence and ticket (a release, as one thread rather than 128
  // fences); the fence after the ticket makes the last block's reads see
  // every split's partials (an acquire).
  __syncthreads();
  int* ticket = a.tickets + ((long long)b * a.Hkv + h) * a.ngs + slice;
  if (tid == 0) {
    int old;
    asm volatile("fence.acq_rel.gpu;\n"
                 "atom.relaxed.gpu.global.add.s32 %0, [%1], 1;\n"
                 "fence.acq_rel.gpu;\n"
                 : "=r"(old) : "l"(ticket) : "memory");
    last_block = old == a.n_split - 1;
  }
  __syncthreads();
  if (!last_block) return;

  // Merge in one pass (online), the partials read past L1 (__ldcg).
  for (int i = tid; i < g * hp2; i += NT) {
    const int r = i / hp2, d = 2 * (i - r * hp2);
    const float* ml = a.part_ml + (row0 + r) * a.n_split * 2;
    const float* pa = a.part_acc + (row0 + r) * a.n_split * pw + d;
    float m = NEG_INF, l = 0.f, x0 = 0.f, x1 = 0.f;
#pragma unroll 4
    for (int s = 0; s < a.n_split; ++s) {
      const float2 ms = __ldcg(reinterpret_cast<const float2*>(ml + 2 * s));
      const float2 ps = __ldcg(reinterpret_cast<const float2*>(pa + s * pw));
      const float m_new = fmaxf(m, ms.x);
      const float wo = expf(m - m_new), wn = expf(ms.x - m_new);
      l = l * wo + ms.y * wn;
      x0 = x0 * wo + ps.x * wn;
      x1 = x1 * wo + ps.y * wn;
      m = m_new;
    }
    l = fmaxf(l, 1e-30f);
    T* od = o + b * a.o_sb + (qh0 + r) * a.o_sh + d;
    od[0] = from_f<T>(x0 / l);
    if (d + 1 < hd) od[1] = from_f<T>(x1 / l);
  }
  if (tid == 0) *ticket = 0;
}

template <typename T, int BK, bool ALIGNED>
int launch_bk(DecodeArgs a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.gs, a.hd, sizeof(T), BK);
  // Past 48 KB a launch needs the opt-in, which is per device: set it on
  // the current one to what this call needs (the kernel's static shared
  // memory counts against the same 227 KB).
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, BK, ALIGNED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel<T, BK, ALIGNED>
      <<<dim3(a.B, a.Hkv * a.ngs, a.n_split), NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(DecodeArgs a, int bk, cudaStream_t stream) {
  if (a.vec) {
    return bk == 32 ? launch_bk<T, 32, true>(a, stream)
                    : launch_bk<T, 16, true>(a, stream);
  }
  return bk == 32 ? launch_bk<T, 32, false>(a, stream)
                  : launch_bk<T, 16, false>(a, stream);
}

}  // namespace

extern "C" int flash_decode_launch(
    int is_bf16, const void* q, const void* k, const void* v, void* o,
    float* part_acc, float* part_ml, int* tickets, int B, int Hq, int Hkv,
    int T, int hd, const long long* strides, int kv_len, float softcap,
    int gs, int ngs, int bk, int n_split, int tiles_per_split,
    void* stream) {
  const int g = Hkv > 0 ? Hq / Hkv : 0;
  const int item = is_bf16 ? 2 : 4;
  if (Hkv < 1 || Hq % Hkv != 0 || hd < 1 || hd > 512 || gs < 1 ||
      gs > NT || gs * 2 * ((hd + 1) / 2) > MAX_GHD ||
      (long long)(ngs - 1) * gs >= g || (long long)ngs * gs < g ||
      (bk != 32 && bk != 16) || kv_len < 1 || kv_len > T || n_split < 1 ||
      (long long)(n_split - 1) * tiles_per_split * bk >= kv_len ||
      (long long)n_split * tiles_per_split * bk < kv_len ||
      smem_bytes(gs, hd, item, bk) > 227 * 1024 ||
      (n_split > 1 && (part_acc == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.part_acc = part_acc; a.part_ml = part_ml; a.tickets = tickets;
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.T = T; a.hd = hd; a.g = g;
  a.gs = gs; a.ngs = ngs;
  a.q_sb = strides[0]; a.q_sh = strides[1];
  a.k_sb = strides[2]; a.k_sh = strides[3]; a.k_st = strides[4];
  a.v_sb = strides[5]; a.v_sh = strides[6]; a.v_st = strides[7];
  a.o_sb = strides[8]; a.o_sh = strides[9];
  a.kv_len = kv_len;
  a.softcap = softcap;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  a.n_split = n_split;
  a.tiles_per_split = tiles_per_split;
  a.vec = hd * item % 16 == 0 &&
          (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
              16 == 0;
  for (int i = 2; i < 8; ++i) a.vec = a.vec && strides[i] * item % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, bk, s) : launch<float>(a, bk, s);
}
