// mlstm_scan for Hopper (sm_90a): chunkwise mLSTM (gated linear attention).
//
// Replaces the Pallas TPU kernel repro.kernels.mlstm_scan.mlstm_scan
// (src/repro/kernels/mlstm_scan.py:73, body _kernel :30-70).  Per (batch,
// head), with F the in-chunk cumulative log(f + 1e-8) and q scaled by
// 1/sqrt(hd):
//   intra:  y_t += sum_{s<=t} (q_t . k_s) exp(F_t - F_s) i_s v_s
//   inter:  y_t += exp(F_t) q_t C
//   state:  C   <- exp(F_c) C + sum_s exp(F_c - F_s) i_s k_s v_s^T
// and, when the caller passes n0, the normalizer with C's update at v = 1:
//           n   <- exp(F_c) n + sum_s exp(F_c - F_s) i_s k_s
//
// What bounds it: a prefill is bound by operations (4 hd^2 per token and
// head for the recurrence, more in the chunkwise form), which this kernel
// runs on the tensor cores; a one-token decode step reads and writes the
// hd x hd fp32 state for 4 hd^2 flops and is bound by bytes.
//
// Prefill (chunk > 1), two launches:
//   * score_kernel computes each chunk's causal score tile once:
//     P[t, s] = (q_t . k_s) / sqrt(hd) exp(F_t - F_s) i_s for s <= t, into a
//     scratch tensor the wrapper allocates (64 KiB per chunk and head),
//     rows in full (zero above the diagonal) so the scan kernel copies them
//     with cp.async while its inter-chunk products run.
//     Grid (B*H, chunks, 32-row blocks); the products skip the tiles above
//     the diagonal.
//   * scan_kernel walks the chunks in order.  The state does not fit in
//     shared memory (576 KiB of fp32 C per head at hd = 384), and its value
//     columns are independent, so block (batch*head, slab) keeps an hd x ET
//     slab of C in shared memory for the whole sequence.  ET is chosen so
//     the grid fills the card in whole waves: 48 at hd 384 and batch x
//     heads 16, 128 blocks for 132 SMs.  Per chunk the block computes
//     y = exp(F) q C + P V and C <- exp(F_c) C + K^T (r v) for its columns:
//     the score tile is read from the scratch, not recomputed per slab.
//   * Every product runs on the tensor cores as 3xTF32: each fp32 operand
//     is split into hi (its top 11 significant bits, a TF32 value) and
//     lo = x - hi, and lo.hi + hi.lo + hi.hi is summed in fp32 accumulators
//     (mma.sync m16n8k8), which keeps fp32 accuracy at a third of the TF32
//     rate.  Each warp owns 16 rows of every product (chunk rows for y,
//     state rows for C).  Operands sit in shared memory with row strides
//     that make every fragment read conflict-free.
//   * Staging stays off the critical path where it can: the next 64-deep q
//     or k tile is loaded into registers while this tile's products run,
//     and the chunk's scores and v columns are copied with cp.async while
//     q C runs.  (On an NVIDIA H100 80GB HBM3 at 700 W, 16 warps a block
//     and 64-deep score tiles both measured slower.)
//   * A ragged last chunk is masked, not padded: its missing rows count as
//     f = 1, i = 0, the identity update the TPU wrapper pads with.  A chunk
//     above 128 (the TPU kernel takes any) runs as chunks of 128: with that
//     identity padding it is the same function up to floating-point order.
//   * Any head dim from 1 to 512: the depth is padded to hdp, a multiple of
//     16, in shared memory only.  q and k are zero past hd in the staged
//     tiles, the state's rows past hd are zero and stay so (k is zero
//     there), and a slab's columns past hd (v zero, C zero) are never
//     stored.  Rows that are not 16-byte aligned (hd % 4 != 0, an odd
//     stride) take the kernels' other instantiation (VEC false), which
//     reads them value by value.  At hd 512 the hd x 56 slab of 48
//     columns does not fit beside the staged tiles, so pick_et takes 32.
//   * bf16 inputs are converted on load; the state and the math stay fp32.
// Decode (chunk == 1, step_kernel): the plain recurrence, bound by the
//   bytes of the state.  Block (batch*head, 32 value columns); each lane
//   holds 4 adjacent columns of rows r, r + 32, ... of C in registers, read
//   and written as 16-byte vectors.  q, k are staged once in shared memory;
//   y is reduced by warp shuffles and one barrier.  The block of columns 0
//   also updates n.  (16-column blocks, 384 of them, measured 3% slower on
//   an NVIDIA H100 80GB HBM3 at 700 W.)
// Every block reads its slab of c0 (and n0) before it writes the same slab
// of c_out (n_out), so the outputs may alias the inputs (the model's cache
// is updated in place).
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int MC = 128;           // largest chunk
constexpr int MAX_HD = 512;
// scan_kernel
constexpr int NT = 256;           // 8 warps x 16 rows = MC rows
constexpr int DTILE = 64;         // depth of a staged q or k tile
constexpr int LQ = DTILE + 4;     // row stride of the q tile
constexpr int LP = MC + 4;        // row stride of P
constexpr int LK = DTILE + 8;     // row stride of the k tile (read as K^T)
constexpr int UNION = MC * (LQ > LK ? LQ : LK);  // floats of a q or k tile
// score_kernel
constexpr int SNT = 256;          // 8 warps: 2 row groups x 4 key phases
constexpr int SROWS = 32;
constexpr int SD = 32;            // depth of a staged q/k tile
constexpr int LS = SD + 4;
// step_kernel
constexpr int STEP_NT = 256;
constexpr int STEP_W = STEP_NT / 32;
constexpr int STEP_COLS = 32;                 // value columns a block
constexpr int STEP_LPR = STEP_COLS / 4;       // lanes a row, 4 columns each
constexpr int STEP_RPW = 32 / STEP_LPR;       // rows a warp holds at once
constexpr int STEP_RPB = STEP_RPW * STEP_W;   // rows a block holds at once

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

// Four consecutive values as fp32 (16-byte fp32 or 8-byte bf16 load).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
// Four consecutive values, of which the first n > 0 are read (the rest 0).
// VEC (every row's vectors aligned, hd % 4 == 0, so n >= 4) reads one
// vector; otherwise the values are read one by one.
template <bool VEC, typename T>
__device__ __forceinline__ float4 load4n(const T* p, int n) {
  if constexpr (VEC) {
    return load4(p);
  } else {
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = j < n ? to_f(p[j]) : 0.f;
    return make_float4(x[0], x[1], x[2], x[3]);
  }
}
// The first n > 0 (up to four) values of v at p, as one vector with VEC.
template <bool VEC>
__device__ __forceinline__ void store4n(float* p, float4 v, int n) {
  if constexpr (VEC) {
    store4(p, v);
  } else {
    p[0] = v.x;
    if (n > 1) p[1] = v.y;
    if (n > 2) p[2] = v.z;
    if (n > 3) p[3] = v.w;
  }
}
// Columns e and e + 1 of a row of y, those below `end`: one pair store
// with VEC (hd even, so the pair is aligned), else one value at a time.
template <bool VEC, typename T>
__device__ __forceinline__ void store2n(T* p, float a, float b, int e,
                                        int end) {
  if (e >= end) return;
  if constexpr (VEC) {
    store2(p, a, b);
  } else {
    p[0] = from_f<T>(a);
    if (e + 1 < end) p[1] = from_f<T>(b);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
}

// 3xTF32: x = hi + lo exactly, hi the top 11 significant bits of x (a
// TF32 value) and lo the rest.  The tensor cores read a TF32 operand from
// the top 19 bits of its register, so lo enters the product truncated to
// its own top 11 bits; what is lost (and the lo.lo product) is about 2^-22
// of |x|.  Two instructions: cvt.rna.tf32.f32 is no single instruction on
// sm_90 (about seven).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc[i] (the 16 x 8 tile i) += A (16 x 8 ksteps) B (8 ksteps x
// 8 ntiles), in 3xTF32.  a(row, k) and b(k, col) read the operands.  The
// m16n8k8 fragments: lane = 4 g + tg holds A rows g, g + 8 at columns tg,
// tg + 4; B rows tg, tg + 4 at column g; C rows g, g + 8 at columns 2 tg,
// 2 tg + 1 (acc[i][0..1] row g, acc[i][2..3] row g + 8).  The three
// products of a tile accumulate into one register set, so each pass runs
// over all tiles before the next: consecutive mma are independent.
template <int NTILE, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NTILE][4], int ksteps,
                                         int ntiles, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  for (int kk = 0; kk < ksteps; ++kk) {
    const int k0 = kk * 8;
    uint32_t ah[4], al[4];
    split_tf32(a(g, k0 + tg), ah[0], al[0]);
    split_tf32(a(g + 8, k0 + tg), ah[1], al[1]);
    split_tf32(a(g, k0 + tg + 4), ah[2], al[2]);
    split_tf32(a(g + 8, k0 + tg + 4), ah[3], al[3]);
    uint32_t bh[NTILE][2], bl[NTILE][2];
#pragma unroll
    for (int i = 0; i < NTILE; ++i) {
      if (i < ntiles) {
        split_tf32(b(k0 + tg, 8 * i + g), bh[i][0], bl[i][0]);
        split_tf32(b(k0 + tg + 4, 8 * i + g), bh[i][1], bl[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < NTILE; ++i) {
      if (i < ntiles) mma_tf32(acc[i], al, bh[i][0], bh[i][1]);
    }
#pragma unroll
    for (int i = 0; i < NTILE; ++i) {
      if (i < ntiles) mma_tf32(acc[i], ah, bl[i][0], bl[i][1]);
    }
#pragma unroll
    for (int i = 0; i < NTILE; ++i) {
      if (i < ntiles) mma_tf32(acc[i], ah, bh[i][0], bh[i][1]);
    }
  }
}

struct Args {
  const void* q;          // (B, S, H, hd), 16-byte aligned rows
  const void* k;
  const void* v;
  const void* ig;         // (B, S, H), any strides
  const void* fg;
  const float* c0;        // (B, H, hd, hd) contiguous
  void* y;                // (B, S, H, hd) contiguous
  float* c_out;           // (B, H, hd, hd) contiguous, may be c0
  const float* n0;        // (B, H, hd) contiguous, or null: no normalizer
  float* n_out;           // (B, H, hd) contiguous, may be n0
  float* p;               // (B*H, n_chunks, chunk, ps) score scratch
  int B, S, H, hd, chunk, n_chunks, ps;   // ps: chunk rounded up to 8
  int hdp;                // hd rounded up to 16: the padded depth
  int vec;                // hd % 4 == 0, the rows of q, k, v and the
                          // states 16-byte aligned
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long i_sb, i_ss, i_sh, f_sb, f_ss, f_sh, y_sb, y_ss, y_sh;
  float scale;
};

// Warp 0: the chunk's input gates and in-chunk cumulative log forget, four
// rows a lane then an inclusive scan of the lane totals.  Rows past cl add
// log 1 = 0 and carry i = 0.  Every kernel runs this same code, so the score
// and scan kernels see bitwise-equal F.
template <typename T>
__device__ __forceinline__ void gate_scan(const Args& a, const T* ig,
                                          const T* fg, int t0, int cl,
                                          float* cum, float* igs) {
  const int lane = threadIdx.x & 31;
  float run = 0.f, part[MC / 32];
#pragma unroll
  for (int u = 0; u < MC / 32; ++u) {
    const int t = lane * (MC / 32) + u;
    float lf = 0.f, iv = 0.f;
    if (t < cl) {
      lf = logf(to_f(fg[(t0 + t) * a.f_ss]) + 1e-8f);
      iv = to_f(ig[(t0 + t) * a.i_ss]);
    }
    run += lf;
    part[u] = run;
    igs[t] = iv;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  const float base = incl - run;
#pragma unroll
  for (int u = 0; u < MC / 32; ++u) cum[lane * (MC / 32) + u] = base + part[u];
}

// Block (batch*head, chunk, 32-row block): rows t of the chunk's score
// tile, written to the scratch in full (zero for keys s > t, up to the row
// stride ps) so the scan kernel copies whole rows.  Warp w owns rows
// 16 (w % 2) .. + 15 of the block and the key tiles n = w / 2 (mod 4), and
// skips the tiles past its last row.  The next depth tile's loads are in
// flight (in registers) while the products of this one run.
template <typename T, bool VEC>
__global__ void __launch_bounds__(SNT) score_kernel(Args a) {
  constexpr int R4 = SD / 4;                          // float4s a tile row
  constexpr int PRE = (SROWS + MC) * R4 / SNT;        // float4s a thread
  constexpr int PH = SNT / 32 / (SROWS / 16);         // key phases
  __shared__ __align__(16) float qs[SROWS * LS];
  __shared__ __align__(16) float ks[MC * LS];
  __shared__ float cum[MC], igs[MC];
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int jc = blockIdx.y, t0 = jc * a.chunk;
  const int cl = min(a.chunk, a.S - t0);
  const int r0 = blockIdx.z * SROWS;
  if (r0 >= cl) return;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int rg = w % (SROWS / 16), par = w / (SROWS / 16);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* ig = static_cast<const T*>(a.ig) + b * a.i_sb + h * a.i_sh;
  const T* fg = static_cast<const T*>(a.fg) + b * a.f_sb + h * a.f_sh;
  if (w == 0) gate_scan(a, ig, fg, t0, cl, cum, igs);

  const int s_end = min(cl, r0 + SROWS);       // keys the block needs
  const int wrow = r0 + 16 * rg;                // the warp's first row
  const int tiles = wrow < cl ? (min(s_end, wrow + 16) + 7) / 8 : 0;
  const int ntiles = (tiles - par + PH - 1) / PH;     // this warp's tiles
  // Element u of this thread's prefetch: the q tile's rows, then k's.
  float4 pre[PRE];
  auto fetch = [&](int d0) {
    const int dn = min(SD, a.hd - d0);
#pragma unroll
    for (int u = 0; u < PRE; ++u) {
      const int i = tid + u * SNT, c4 = (i % R4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < SROWS * R4) {
        const int r = i / R4;
        if (r0 + r < cl && c4 < dn) {
          x = load4n<VEC>(q + (t0 + r0 + r) * a.q_ss + d0 + c4, dn - c4);
        }
      } else {
        const int r = i / R4 - SROWS;
        if (r < s_end && c4 < dn) {
          x = load4n<VEC>(k + (t0 + r) * a.k_ss + d0 + c4, dn - c4);
        }
      }
      pre[u] = x;
    }
  };
  float acc[MC / 8 / PH][4] = {};
  fetch(0);
  for (int d0 = 0; d0 < a.hd; d0 += SD) {
    const int dn = min(SD, a.hd - d0);
    __syncthreads();  // the previous tiles are consumed (and F is ready)
#pragma unroll
    for (int u = 0; u < PRE; ++u) {
      const int i = tid + u * SNT, c4 = (i % R4) * 4;
      store4(i < SROWS * R4 ? qs + (i / R4) * LS + c4
                            : ks + (i / R4 - SROWS) * LS + c4, pre[u]);
    }
    __syncthreads();
    if (d0 + SD < a.hd) fetch(d0 + SD);
    if (ntiles > 0) {
      warp_mma<MC / 8 / PH>(
          acc, (dn + 7) / 8, ntiles,
          [&](int r, int kk) { return qs[(16 * rg + r) * LS + kk]; },
          [&](int kk, int c) {
            return ks[(8 * PH * (c >> 3) + 8 * par + (c & 7)) * LS + kk];
          });
    }
  }
  float* P = a.p + (static_cast<long long>(bh) * a.n_chunks + jc) *
                       a.chunk * a.ps;
#pragma unroll
  for (int i = 0; i < MC / 8 / PH; ++i) {
    if (i < ntiles) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = wrow + g + 8 * (e >> 1);
        const int s = 8 * (PH * i + par) + 2 * tg + (e & 1);
        if (t < cl) {
          P[t * a.ps + s] =
              s <= t ? acc[i][e] * a.scale * (expf(cum[t] - cum[s]) * igs[s])
                     : 0.f;
        }
      }
    }
  }
  // Keys past the warp's tiles: zero, by the warps of phase 0.
  if (par == 0) {
    for (int i = lane; i < 16 * a.ps; i += 32) {
      const int t = wrow + i / a.ps, s = i % a.ps;
      if (t < cl && s >= 8 * tiles) P[t * a.ps + s] = 0.f;
    }
  }
}

// Dynamic shared memory of scan_kernel at padded depth hdp, slab width et.
size_t scan_smem_bytes(int hdp, int et) {
  const size_t lc = et + 8;
  return sizeof(float) *
         (static_cast<size_t>(hdp) * lc + MC * lc + MC * LP + UNION + 3 * MC +
          hdp);
}

// Block (batch*head = blockIdx.x, value columns [e0, e0 + ET) with e0 =
// blockIdx.y * ET): the chunks in order, this block's hd x ET slab of C in
// shared memory throughout.  Warp w owns chunk rows 16 w .. 16 w + 15 of y;
// per DTILE pass of the state update, warps w and w + 4 own state rows
// d0 + 16 (w % 4) .. + 15, the even and the odd column tiles.
template <typename T, int ET, bool VEC>
__global__ void __launch_bounds__(NT, 1) scan_kernel(Args a) {
  constexpr int NTILE = ET / 8, LC = ET + 8, E4 = ET / 4;
  extern __shared__ __align__(16) float smem[];
  const int hd = a.hd, hdp = a.hdp;
  float* cs = smem;               // hdp x LC: this block's columns of C
  float* vs = cs + hd * LC;       // MC x LC: v columns, later r * v
  float* pt = vs + MC * LC;       // MC x LP: the chunk's scores P
  float* us = pt + MC * LP;       // the q tile, then the k tile
  float* cum = us + UNION;        // MC: in-chunk cumulative log forget
  float* igs = cum + MC;          // MC: input gates
  float* rs = igs + MC;           // MC: exp(F_c - F_s) i_s
  float* ns = rs + MC;            // hdp: the normalizer (column block 0)

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int e0 = blockIdx.y * ET;
  const bool with_n = a.n0 != nullptr && blockIdx.y == 0;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3, row0 = 16 * w;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + e0;
  const T* ig = static_cast<const T*>(a.ig) + b * a.i_sb + h * a.i_sh;
  const T* fg = static_cast<const T*>(a.fg) + b * a.f_sb + h * a.f_sh;
  T* y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + e0;
  const long long cbase = static_cast<long long>(bh) * hd * hd + e0;
  const int ew = hd - e0;           // real columns of this slab (may be > ET)

  // A DTILE-deep tile of q or k rows (zero past cl and past hd), staged
  // through registers: fetch() issues the loads, put() stores them at row
  // stride ld.
  constexpr int R4 = DTILE / 4;                 // float4s a tile row
  constexpr int PRE = MC * R4 / NT;             // float4s a thread
  float4 pre[PRE];
  auto fetch = [&](const T* src, long long ss, int t0, int cl, int d0) {
    const int dn = min(DTILE, hd - d0);
#pragma unroll
    for (int u = 0; u < PRE; ++u) {
      const int i = tid + u * NT, r = i / R4, c4 = (i % R4) * 4;
      pre[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < cl && c4 < dn) {
        pre[u] = load4n<VEC>(src + (t0 + r) * ss + d0 + c4, dn - c4);
      }
    }
  };
  auto put = [&](int ld) {
#pragma unroll
    for (int u = 0; u < PRE; ++u) {
      const int i = tid + u * NT;
      store4(us + (i / R4) * ld + (i % R4) * 4, pre[u]);
    }
  };

  for (int i = tid; i < hdp * E4; i += NT) {
    const int d = i / E4, c4 = (i - d * E4) * 4;
    store4(cs + d * LC + c4,
           d < hd && c4 < ew
               ? load4n<VEC>(a.c0 + cbase + static_cast<long long>(d) * hd +
                                 c4, ew - c4)
               : make_float4(0.f, 0.f, 0.f, 0.f));
  }
  if (with_n) {
    for (int d = tid; d < hdp; d += NT) {
      ns[d] = d < hd ? a.n0[bh * hd + d] : 0.f;
    }
  }

  for (int jc = 0, t0 = 0; t0 < a.S; ++jc, t0 += a.chunk) {
    const int cl = min(a.chunk, a.S - t0);
    const int k8 = (cl + 7) & ~7;       // keys, padded to the mma depth
    const int r16 = (cl + 15) & ~15;    // rows, padded to whole warps
    const bool active = row0 < cl;
    __syncthreads();  // the previous chunk is done with every buffer
    if (w == 0) gate_scan(a, ig, fg, t0, cl, cum, igs);
    // The chunk's scores and v columns, for the intra-chunk term: copied
    // with cp.async (fp32 as they lie) while the inter-chunk term runs.
    const float* P = a.p + (static_cast<long long>(bh) * a.n_chunks + jc) *
                               a.chunk * a.ps;
    for (int i = tid; i < r16 * (a.ps / 4); i += NT) {
      const int t = i / (a.ps / 4), c4 = (i - t * (a.ps / 4)) * 4;
      if (t < cl) {
        cp_async16(pt + t * LP + c4, P + t * a.ps + c4);
      } else {
        store4(pt + t * LP + c4, make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
    for (int i = tid; i < k8 * E4; i += NT) {
      const int s = i / E4, c4 = (i - s * E4) * 4;
      if (s >= cl || c4 >= ew) {
        store4(vs + s * LC + c4, make_float4(0.f, 0.f, 0.f, 0.f));
      } else if constexpr (VEC && sizeof(T) == 4) {
        cp_async16(vs + s * LC + c4, v + (t0 + s) * a.v_ss + c4);
      } else {
        store4(vs + s * LC + c4,
               load4n<VEC>(v + (t0 + s) * a.v_ss + c4, ew - c4));
      }
    }

    // Inter-chunk: acc = q C over the depth, DTILE-deep q tiles, the next
    // tile's loads in flight while this one's products run.
    float acc[NTILE][4] = {};
    if (t0 == 0) fetch(q, a.q_ss, t0, cl, 0);   // later chunks: prefetched
    for (int d0 = 0; d0 < hd; d0 += DTILE) {
      const int dn = min(DTILE, hd - d0);
      __syncthreads();  // the previous q tile is consumed
      put(LQ);
      __syncthreads();
      if (d0 + DTILE < hd) fetch(q, a.q_ss, t0, cl, d0 + DTILE);
      if (active) {
        warp_mma<NTILE>(
            acc, (dn + 7) / 8, NTILE,
            [&](int r, int kk) { return us[(row0 + r) * LQ + kk]; },
            [&](int kk, int c) { return cs[(d0 + kk) * LC + c]; });
      }
    }
#pragma unroll
    for (int n = 0; n < NTILE; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] *= expf(cum[row0 + g + 8 * (e >> 1)]) * a.scale;
      }
    }
    // Intra-chunk: acc += P V, P from the score kernel (zero for s > t).
    // The state pass's first k tile is in flight meanwhile.
    cp_async_wait_all();
    __syncthreads();  // P and v have landed
    fetch(k, a.k_ss, t0, cl, 0);
    if (active) {
      const int kend = min(k8, row0 + 16);    // keys up to the warp's rows
      warp_mma<NTILE>(
          acc, kend / 8, NTILE,
          [&](int r, int kk) { return pt[(row0 + r) * LP + kk]; },
          [&](int kk, int c) { return vs[kk * LC + c]; });
#pragma unroll
      for (int n = 0; n < NTILE; ++n) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = row0 + g + 8 * half;
          if (t < cl) {
            store2n<VEC>(y + (t0 + t) * a.y_ss + 8 * n + 2 * tg,
                         acc[n][2 * half], acc[n][2 * half + 1],
                         8 * n + 2 * tg, ew);
          }
        }
      }
    }
    __syncthreads();  // P and v are consumed

    // State: C <- exp(F_c) C + K^T (r v), DTILE rows of C per pass.
    const float clast = cum[cl - 1];
    const float decay = expf(clast);
    if (tid < MC) rs[tid] = tid < cl ? expf(clast - cum[tid]) * igs[tid] : 0.f;
    __syncthreads();
    for (int i = tid; i < k8 * ET; i += NT) {
      const int s = i / ET;
      vs[s * LC + (i - s * ET)] *= rs[s];
    }
    for (int d0 = 0; d0 < hd; d0 += DTILE) {
      const int dn = min(DTILE, hd - d0);
      __syncthreads();  // r v is ready; the previous k tile is consumed
      put(LK);
      __syncthreads();
      if (d0 + DTILE < hd) {
        fetch(k, a.k_ss, t0, cl, d0 + DTILE);
      } else if (t0 + a.chunk < a.S) {    // the next chunk's first q tile
        fetch(q, a.q_ss, t0 + a.chunk, min(a.chunk, a.S - t0 - a.chunk), 0);
      }
      const int srow = 16 * (w & 3), par = w >> 2;
      if (srow < dn) {    // state rows past hd (k zero there) stay zero
        float u[NTILE / 2][4] = {};
        warp_mma<NTILE / 2>(
            u, k8 / 8, NTILE / 2,
            [&](int r, int kk) { return us[kk * LK + srow + r]; },
            [&](int kk, int c) {
              return vs[kk * LC + 16 * (c >> 3) + 8 * par + (c & 7)];
            });
#pragma unroll
        for (int i = 0; i < NTILE / 2; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = d0 + srow + g + 8 * (e >> 1);
            float* c = cs + d * LC + 16 * i + 8 * par + 2 * tg + (e & 1);
            *c = fmaf(*c, decay, u[i][e]);
          }
        }
      }
      if (with_n) {     // n: four threads a state row, keys s = part mod 4
        const int dl = tid >> 2, part = tid & 3;
        float sum = 0.f;
        if (dl < dn) {
          for (int s = part; s < cl; s += 4) {
            sum = fmaf(us[s * LK + dl], rs[s], sum);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0 && dl < dn) ns[d0 + dl] = fmaf(ns[d0 + dl], decay, sum);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < hd * E4; i += NT) {
    const int d = i / E4, c4 = (i - d * E4) * 4;
    if (c4 < ew) {
      store4n<VEC>(a.c_out + cbase + static_cast<long long>(d) * hd + c4,
                   *reinterpret_cast<const float4*>(cs + d * LC + c4),
                   ew - c4);
    }
  }
  if (with_n) {
    for (int d = tid; d < hd; d += NT) a.n_out[bh * hd + d] = ns[d];
  }
}

// Chunk 1: the recurrence one token at a time.  Block (batch*head =
// blockIdx.x, value columns blockIdx.y * STEP_COLS ..); lane l of warp w
// holds columns 4 (l % STEP_LPR) .. + 3 of rows STEP_RPW w + l / STEP_LPR +
// STEP_RPB j of C, j < ROWS (ROWS * STEP_RPB >= hd).
// The aligned kernel keeps to 128 registers (two blocks an SM); the other
// may take more, for its value-by-value loads.
template <typename T, int ROWS, bool VEC>
__global__ void __launch_bounds__(STEP_NT, VEC ? 2 : 1) step_kernel(Args a) {
  __shared__ float qs[MAX_HD], ks[MAX_HD];
  __shared__ __align__(16) float red[STEP_W][STEP_COLS];
  __shared__ float qk_red[STEP_W];
  const int hd = a.hd;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c4 = (lane % STEP_LPR) * 4;
  const int r0 = STEP_RPW * w + lane / STEP_LPR;
  const int e = blockIdx.y * STEP_COLS + c4;
  const bool live = e < hd;
  const bool with_n = a.n0 != nullptr && blockIdx.y == 0;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* ig = static_cast<const T*>(a.ig) + b * a.i_sb + h * a.i_sh;
  const T* fg = static_cast<const T*>(a.fg) + b * a.f_sb + h * a.f_sh;
  T* y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh;
  const long long cbase = static_cast<long long>(bh) * hd * hd + e;

  float4 c[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int d = r0 + STEP_RPB * j;
    c[j] = (live && d < hd)
               ? load4n<VEC>(a.c0 + cbase + static_cast<long long>(d) * hd,
                             hd - e)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float nr[2] = {0.f, 0.f};
  if (with_n) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int d = tid + STEP_NT * m;
      if (d < hd) nr[m] = a.n0[bh * hd + d];
    }
  }
  for (int t = 0; t < a.S; ++t) {
    // The previous step's readers of qs and ks passed its second barrier.
    for (int i = tid; i < hd; i += STEP_NT) {
      qs[i] = to_f(q[t * a.q_ss + i]) * a.scale;
      ks[i] = to_f(k[t * a.k_ss + i]);
    }
    const float decay = expf(logf(to_f(fg[t * a.f_ss]) + 1e-8f));
    const float iv = to_f(ig[t * a.i_ss]);
    const float4 vv = live ? load4n<VEC>(v + t * a.v_ss + e, hd - e)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    float4 yp = make_float4(0.f, 0.f, 0.f, 0.f);
    float qk = 0.f;
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int d = r0 + STEP_RPB * j;
      if (d < hd) {
        const float qd = qs[d], kd = ks[d], kv = kd * iv;
        yp.x = fmaf(qd, c[j].x, yp.x);
        yp.y = fmaf(qd, c[j].y, yp.y);
        yp.z = fmaf(qd, c[j].z, yp.z);
        yp.w = fmaf(qd, c[j].w, yp.w);
        qk = fmaf(qd, kd, qk);
        c[j].x = fmaf(c[j].x, decay, kv * vv.x);
        c[j].y = fmaf(c[j].y, decay, kv * vv.y);
        c[j].z = fmaf(c[j].z, decay, kv * vv.z);
        c[j].w = fmaf(c[j].w, decay, kv * vv.w);
      }
    }
    // The row groups of the warp (lanes STEP_LPR apart) share columns.
#pragma unroll
    for (int o = STEP_LPR; o < 32; o <<= 1) {
      yp.x += __shfl_xor_sync(0xffffffffu, yp.x, o);
      yp.y += __shfl_xor_sync(0xffffffffu, yp.y, o);
      yp.z += __shfl_xor_sync(0xffffffffu, yp.z, o);
      yp.w += __shfl_xor_sync(0xffffffffu, yp.w, o);
      qk += __shfl_xor_sync(0xffffffffu, qk, o);
    }
    if (lane < STEP_LPR) store4(&red[w][c4], yp);
    if (lane == 0) qk_red[w] = qk;
    if (with_n) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int d = tid + STEP_NT * m;
        if (d < hd) nr[m] = fmaf(nr[m], decay, iv * ks[d]);
      }
    }
    __syncthreads();
    if (tid < STEP_COLS) {
      const int col = blockIdx.y * STEP_COLS + tid;
      if (col < hd) {
        float ys = 0.f, qks = 0.f;
#pragma unroll
        for (int u = 0; u < STEP_W; ++u) {
          ys += red[u][tid];
          qks += qk_red[u];
        }
        y[t * a.y_ss + col] = from_f<T>(
            fmaf(decay, ys, qks * iv * to_f(v[t * a.v_ss + col])));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int d = r0 + STEP_RPB * j;
    if (live && d < hd) {
      store4n<VEC>(a.c_out + cbase + static_cast<long long>(d) * hd, c[j],
                   hd - e);
    }
  }
  if (with_n) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int d = tid + STEP_NT * m;
      if (d < hd) a.n_out[bh * hd + d] = nr[m];
    }
  }
}

// The slab width: of the ETs whose slab fits shared memory, the one whose
// grid (ceil(hd / ET) slabs a head) takes the fewest waves times columns
// (the time of one block is about linear in ET).
int pick_et(int bh, int hd, int hdp) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  int best = 0;
  long long best_cost = 0;
  const int ets[] = {48, 32, 16};
  for (int et : ets) {
    if (scan_smem_bytes(hdp, et) > 227 * 1024) continue;
    const long long blocks = static_cast<long long>(bh) * ((hd + et - 1) / et);
    const long long cost = (blocks + sms - 1) / sms * et;
    if (best == 0 || cost < best_cost) {
      best = et;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T, int ET, bool VEC>
int launch_scan(const Args& a, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(scan_kernel<T, ET, VEC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         227 * 1024);
    opted_in = true;
  }
  scan_kernel<T, ET, VEC><<<dim3(a.B * a.H, (a.hd + ET - 1) / ET), NT,
                            scan_smem_bytes(a.hdp, ET), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_vec(const Args& a, cudaStream_t stream) {
  const int bh = a.B * a.H;
  if (a.chunk == 1) {
    const dim3 grid(bh, (a.hd + STEP_COLS - 1) / STEP_COLS);
    if (a.hd <= 4 * STEP_RPB) {
      step_kernel<T, 4, VEC><<<grid, STEP_NT, 0, stream>>>(a);
    } else if (a.hd <= 8 * STEP_RPB) {
      step_kernel<T, 8, VEC><<<grid, STEP_NT, 0, stream>>>(a);
    } else if (a.hd <= 12 * STEP_RPB) {
      step_kernel<T, 12, VEC><<<grid, STEP_NT, 0, stream>>>(a);
    } else {
      step_kernel<T, 16, VEC><<<grid, STEP_NT, 0, stream>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  score_kernel<T, VEC>
      <<<dim3(bh, a.n_chunks, (a.chunk + SROWS - 1) / SROWS), SNT, 0,
         stream>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  switch (pick_et(bh, a.hd, a.hdp)) {
    case 48: return launch_scan<T, 48, VEC>(a, stream);
    case 32: return launch_scan<T, 32, VEC>(a, stream);
    default: return launch_scan<T, 16, VEC>(a, stream);
  }
}

// The kernels read and write whole 16-byte vectors where every row allows
// it (VEC), value by value otherwise.
template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  return a.vec ? launch_vec<T, true>(a, stream)
               : launch_vec<T, false>(a, stream);
}

}  // namespace

extern "C" int mlstm_scan_launch(
    int is_bf16, const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const float* c0, void* y, float* c_out, const float* n0,
    float* n_out, float* scores, int B, int S, int H, int hd, int chunk,
    const long long* strides, void* stream) {
  static_assert(16 * STEP_RPB >= MAX_HD, "the step kernel holds every row");
  if (B < 1 || S < 1 || H < 1 || hd < 1 || hd > MAX_HD ||
      chunk < 1 || chunk > MC || (chunk > 1 && scores == nullptr) ||
      (n0 == nullptr) != (n_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q; a.k = k; a.v = v; a.ig = ig; a.fg = fg;
  a.c0 = c0; a.y = y; a.c_out = c_out; a.n0 = n0; a.n_out = n_out;
  a.p = scores;
  a.B = B; a.S = S; a.H = H; a.hd = hd; a.chunk = chunk;
  a.hdp = (hd + 15) / 16 * 16;
  a.n_chunks = (S + chunk - 1) / chunk;
  a.ps = (chunk + 7) & ~7;
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_ss = strides[4]; a.k_sh = strides[5];
  a.v_sb = strides[6]; a.v_ss = strides[7]; a.v_sh = strides[8];
  a.i_sb = strides[9]; a.i_ss = strides[10]; a.i_sh = strides[11];
  a.f_sb = strides[12]; a.f_ss = strides[13]; a.f_sh = strides[14];
  a.y_sb = strides[15]; a.y_ss = strides[16]; a.y_sh = strides[17];
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  auto addr = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr); };
  bool vec = hd % 4 == 0 && (addr(q) | addr(k) | addr(v)) % 16 == 0;
  const long long item = is_bf16 ? 2 : 4;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] * item % 16 == 0;
  a.vec = vec &&
          (addr(c0) | addr(c_out) | addr(n0) | addr(n_out)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
