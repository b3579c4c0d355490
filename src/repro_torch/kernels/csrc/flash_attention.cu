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
// card's ridge.  Two kernels share the contract:
//
// bf16 (attn_wgmma_kernel): both products on the tensor cores.
//   * One warpgroup (128 threads) per (64-row query tile, q head, batch),
//     the longest causal tiles launched first across the whole grid.  The
//     block stages its Q tile once and streams 32-key K/V tiles through a
//     2-stage ring in shared memory: cp.async 16-byte copies issue tile
//     t+1 before tile t is computed.  cp.async rather than TMA: the model
//     hands in strided (B,S,N,hd) views whose every row is 16-byte
//     aligned, so plain copies need no tensor map built per call on the
//     host and no driver entry point, and rows past Sq (Q) or past
//     min(Skv, kv_len) (K, V) are zero-filled by the copy itself (src-size
//     0).  Zero rows matter: a garbage V row times p = 0 gives NaN on the
//     tensor cores.
//   * Why 32 keys and one stage of prefetch: at the serving shapes (a few
//     hundred keys) a block's time is the latency of its serial chain of
//     tiles, not the tensor cores' rate.  32-key tiles keep the registers
//     at 127 and the shared memory at 49 KB per block at hd 128, so four
//     blocks share an SM and the whole grid (512 blocks) is resident at
//     once; 64-key tiles, a deeper ring, and issuing Q.K^T of tile t+1
//     under P.V of tile t were all slower on the card.
//   * Head dim 256 (gemma2, gemma3): the Q tile and two stages of K and V
//     take 99,328 bytes of shared memory, so two blocks share an SM, not
//     four; gemma2's serving prefill (128 blocks) is still resident at once.
//     O is 64 x 256 fp32, 128 registers a thread, and P.V runs as two
//     m64n128k16 wgmmas a 16-key slice, each on its own half of O and of
//     V's columns, so no 128-register instruction form is needed.
//   * Head dim 112 (kimi-k2): a 224-byte row is not a whole number of
//     128-byte column blocks, so the tiles are laid out at HP 128: the
//     copies zero-fill each row's 16-byte chunks 14 and 15, Q.K^T runs over
//     the 7 real 16-dim k-slices, P.V at n = 128.  Shared memory is that of
//     hd 128, 50,176 bytes; P.V does 128/112 of the work a tight layout
//     would (QK^T none extra).
//   * Any head dim from 1 to 512: the kernel is instantiated per padded
//     tile width HP (16, 32 or 64 up to hd 64, then 128, 192, 256, 384 and
//     512: whole 128-byte column blocks, wgmma_width on the host), never per
//     hd.  The copies zero-fill every column past hd, so the padded columns
//     add nothing to Q.K^T and give zero output columns, which are not
//     stored; the scale stays 1/sqrt(hd) of the true hd.  Q.K^T runs over
//     the ceil(hd / 16) k-slices that hold real dims, one instantiation a
//     count (qk_slices): a wgmma behind a runtime branch would cost the
//     loop registers.  Rows that are not 16-byte aligned (an odd hd, a
//     view with an odd stride) take the kernel's other instantiation (VEC
//     false): 2-byte loads, stored to the tile by the threads themselves
//     and fenced for the async proxy as the copies are.  The aligned one
//     keeps to 128 registers up to HP 128, so four blocks share an SM as
//     before (on an NVIDIA H100 80GB HBM3 at 700 W, 135 registers made
//     Jamba's serving prefill 1.16x slower), and pins its two
//     reciprocals, which the compiler otherwise repeated at every store.
//   * Above hd 256 the output's columns are split across blocks: the
//     accumulator of a 64 x 512 tile does not fit one warpgroup's
//     registers.  Each of the HP / OW blocks of a (q tile, head) computes
//     the whole S = Q.K^T over all of hd from full-width Q and K tiles and
//     keeps only its OW = HP / 2 columns of V and O: at HP 512, 64 KB of Q,
//     two stages of 32 KB of K and 16 KB of V, 161 KB in all.
//   * Tiles sit in shared memory in wgmma's canonical layout: column blocks
//     of 32/64/128 bytes a row (HP 16/32/64; HP 128 is two and 256 four
//     128-byte blocks),
//     16-byte chunks XOR-swizzled by the row within each 8-row atom, the
//     descriptor's layout type matching the swizzle the copies wrote.
//   * S = Q.K^T is wgmma m64n32k16 with both operands in shared memory (K's
//     row-major (keys, hd) tile is already the K-major B operand).  The
//     softmax runs in registers on the accumulator fragment: a thread holds
//     two rows (lane/4 and lane/4 + 8 of its warp's 16), so a row's max is
//     two __shfl_xor_sync within the quad; scale (folded with log2 e for
//     the SFU's exp2), softcap (the SFU's tanh) and the causal/window/kv_len
//     masks act per element, the masks only on tiles that straddle a
//     boundary.
//   * O += P.V is wgmma with P from registers: the fp32 score fragment,
//     converted to bf16 pairs, is already the A operand's fragment.  V is
//     the B operand read MN-major (the transpose bit), so V needs no
//     transposed copy.  O (64 x hd fp32) stays in registers.
//
// fp32 (attn_kernel): the CUDA cores, since the fp32 sweep's 2e-5 rules out
// TF32.
//   * Instantiated per padded width HP (16, 32, 64, 112, 128, 256, 512:
//     fp32_width on the host); q, K and V are zero past hd and the output's
//     columns past hd are not stored.  One block per (q tile of RQ rows, q
//     head, batch).  At HP 16, 32 and 64 one thread owns one query row
//     (RQ 64), holding its scaled q, its fp32 accumulator and the row's
//     running max and sum in registers.  A wider head would not fit in 255
//     registers (q and acc alone are 2 HP floats), so from HP 112 a row is
//     split over LANES neighbouring lanes of a warp (lanes_per_row: a power
//     of two that divides HP, so that the butterfly below stays within the
//     row): each lane holds HP / LANES dims of q and of the accumulator
//     (dims sub, sub + LANES, ..., so the lanes of a row read neighbouring
//     shared-memory words), a score is summed over the lanes with
//     __shfl_xor_sync, and the butterfly leaves the same sum, hence the
//     same running max and sum, on every lane of the row.  HP 112 and 128
//     run 4 lanes a row (28 and 32 dims a lane), 256 threads a block; HP
//     256 runs 8 lanes a row, 512 threads a block, on 16-key tiles: 32-key
//     fp32 tiles of K and V would be 64 KiB, over the 48 KiB of static
//     shared memory, and a thread of a 512-thread block holds at most 128
//     registers (q, acc and the tile's scores are 32 + 32 + 16 of them).
//     HP 512 runs 16 lanes a row over 32-row q tiles (512 threads) on
//     8-key tiles, 32 KiB of K and V.
//   * The TPU grid's sequential KV axis becomes a loop over KV tiles inside
//     the block.  Each tile is staged once in shared memory as fp32 and read
//     by every thread of the block at the same address (a broadcast), so a
//     K/V byte fetched from device memory serves all 64 rows of the tile.
//
// Both loop only over tiles the block can see: up to the causal limit of
// its last row, from the window's start for its first row, and below
// kv_len.  Masked scores take the finite sentinel -1e30, never -inf, so a
// fully masked leading tile is wiped later by alpha = exp(-1e30 - m) = 0;
// the output is acc / max(l, 1e-30), written in q's dtype.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

struct AttnArgs {
  const void* q;          // (B, Hq, Sq, hd), any strides with unit last dim
  const void* k;          // (B, Hkv, Skv, hd)
  const void* v;
  void* o;                // (B, Hq, Sq, hd)
  int Sq, Skv, g, hd;
  int vec;                // Q/K/V rows 16-byte aligned and hd % 8 == 0
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window, q_offset, kv_lim;   // kv_lim = min(Skv, kv_len)
  float softcap, scale;
};

template <typename T, int HP, int BK, int LANES, int RQ>
__global__ void __launch_bounds__(RQ * LANES) attn_kernel(AttnArgs a) {
  constexpr int DL = HP / LANES;      // dims of q and acc held per lane
  __shared__ __align__(16) float ks[BK][HP];
  __shared__ __align__(16) float vs[BK][HP];

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.g, hd = a.hd;
  const int sub = threadIdx.x % LANES;    // this lane's dims: sub + LANES*i
  const int row = qi * RQ + threadIdx.x / LANES;
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
      const int d = i * LANES + sub;
      q[i] = live && d < hd ? to_f(qr[d]) * a.scale : 0.f;
      acc[i] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  // Key range the block can see.
  const int first_pos = qi * RQ + a.q_offset;
  const int last_pos = min(qi * RQ + RQ, a.Sq) - 1 + a.q_offset;
  int kv_end = a.kv_lim;
  int kv_begin = 0;
  if (a.causal) {
    kv_end = min(kv_end, last_pos + 1);
    if (a.window > 0) kv_begin = max(0, first_pos - a.window + 1) / BK * BK;
  }

  for (int t0 = kv_begin; t0 < kv_end; t0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < BK * HP; i += RQ * LANES) {
      const int j = i / HP, d = i - j * HP, t = t0 + j;
      const bool ok = t < a.Skv && d < hd;
      ks[j][d] = ok ? to_f(k[t * a.k_ss + d]) : 0.f;
      vs[j][d] = ok ? to_f(v[t * a.v_ss + d]) : 0.f;
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
      const int d = i * LANES + sub;
      if (d < hd) o[d] = from_f<T>(acc[i] / denom);
    }
  }
}

// Lanes that share one query row of the fp32 kernel: the row's scores are
// summed by a butterfly over them, so they must be a power of two that
// divides the padded width.
constexpr int lanes_per_row(int hp) {
  return hp <= 64 ? 1 : hp == 112 ? 4 : hp / 32;
}

// The fp32 kernel's padded width (fp32_width on the host).
int fp32_width(int hd) {
  const int widths[] = {16, 32, 64, 112, 128, 256, 512};
  for (int w : widths) {
    if (hd <= w) return w;
  }
  return 0;
}

template <typename T, int HP>
int launch_hp(const AttnArgs& a, int B, int Hq, cudaStream_t stream) {
  constexpr int BK = HP <= 128 ? 32 : HP <= 256 ? 16 : 8;   // keys per tile
  constexpr int LANES = lanes_per_row(HP);
  constexpr int RQ = HP <= 256 ? BQ : BQ / 2;             // q rows a block
  static_assert(HP % LANES == 0 && (LANES & (LANES - 1)) == 0,
                "LANES must be a power of two that divides the width");
  const dim3 grid((a.Sq + RQ - 1) / RQ, Hq, B);
  attn_kernel<T, HP, BK, LANES, RQ><<<grid, RQ * LANES, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const AttnArgs& a, int B, int Hq, cudaStream_t stream) {
  switch (fp32_width(a.hd)) {
    case 16: return launch_hp<T, 16>(a, B, Hq, stream);
    case 32: return launch_hp<T, 32>(a, B, Hq, stream);
    case 64: return launch_hp<T, 64>(a, B, Hq, stream);
    case 112: return launch_hp<T, 112>(a, B, Hq, stream);
    case 128: return launch_hp<T, 128>(a, B, Hq, stream);
    case 256: return launch_hp<T, 256>(a, B, Hq, stream);
    case 512: return launch_hp<T, 512>(a, B, Hq, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------
constexpr int BKW = 32;             // keys per K/V tile of the wgmma kernel
constexpr int WG = 128;             // threads of one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy from global to shared memory; src_bytes 0 reads
// nothing and fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Orders this thread's cp.async writes before reads by the async proxy,
// through which wgmma reads its shared-memory operands.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin register values in program order around the asynchronous wgmma, so
// the compiler neither moves a write past wgmma.fence nor reads a result
// before wgmma.wait_group.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// exp2 and tanh on the special-function unit (bf16 outputs; the fp32
// kernel keeps expf/tanhf).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 kernel's padded tile width for head dim hd (wgmma_width on the
// host): 16, 32 or 64 up to 64 (a 32-, 64- or 128-byte swizzled row), then
// whole 128-byte column blocks: 128, 192, 256, 384 or 512.  0 past 512.
int wgmma_width(int hd) {
  const int widths[] = {16, 32, 64, 128, 192, 256, 384, 512};
  for (int w : widths) {
    if (hd <= w) return w;
  }
  return 0;
}

// Output columns one block keeps: the whole row up to 256, half of it
// above (the O accumulator of 256 columns is 128 registers a thread).
constexpr int out_width(int hp) { return hp <= 256 ? hp : hp / 2; }

// A tile of ROWS rows of HP bf16 values in shared memory, laid out as wgmma
// reads it: in column blocks of ROWB bytes a row (the swizzle width), each
// block ROWS rows x ROWB bytes with the rows packed, and within each 8-row
// atom the 16-byte chunks of row r XOR-ed with r mod 8 (128 B), (r/2) mod 4
// (64 B) or (r/4) mod 2 (32 B), which is the hardware's swizzle of address
// bits 4-6 by bits 7-9.  Tile and block bases are 1024-byte aligned, so
// the swizzle of an offset is the swizzle of the address.
template <int HP_, int ROWS = 64>
struct TileLayout {
  static constexpr int HP = HP_;
  static constexpr int ROWB = HP * 2 < 128 ? HP * 2 : 128;
  static constexpr int CPB = ROWB / 16;       // 16-byte chunks a block row
  static constexpr int BLOCK = ROWS * ROWB;   // bytes of one column block
  static constexpr int BYTES = ROWS * HP * 2; // bytes of the tile
  static_assert(HP * 2 % ROWB == 0, "rows are whole column blocks");
  static_assert(BYTES % 1024 == 0, "tiles keep 1024-byte alignment");
  // Descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B.
  static constexpr uint64_t MODE = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;

  // Byte offset of 16-byte chunk c (of HP / 8) of row r.
  __device__ __forceinline__ static uint32_t chunk(int r, int c) {
    const uint32_t o = r * ROWB + (c % CPB) * 16;
    return (c / CPB) * BLOCK + (o ^ (((o >> 7) & (CPB - 1)) << 4));
  }
};

// Shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor Format"):
// start address, leading and stride byte offsets (all >> 4), layout type.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (mode << 62);
}

// Q (as A) or K (as B) K-major, k-slice kk of 16 head dims: 32 bytes into a
// block row; 8-row groups SBO = 8 rows apart (LBO is unused when swizzled).
template <int HP, int ROWS = 64>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = TileLayout<HP, ROWS>;
  constexpr int SPB = L::ROWB / 32;           // k-slices a block row
  return gmma_desc(tile + (kk / SPB) * L::BLOCK + (kk % SPB) * 32, 16,
                   8 * L::ROWB, L::MODE);
}

// V as the MN-major (transposed) B operand of P.V, k-slice kk of 16 keys:
// LBO steps to the next column block along hd, SBO to the next 8 keys.
template <int HP, int ROWS = 64>
__device__ __forceinline__ uint64_t desc_v(uint32_t tile, int kk) {
  using L = TileLayout<HP, ROWS>;
  return gmma_desc(tile + kk * 16 * L::ROWB, L::BLOCK, 8 * L::ROWB, L::MODE);
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Copy rows row0 .. row0 + ROWS - 1, columns 0 .. width - 1 of a (rows, *)
// bf16 matrix with the given row stride into a tile of width HP; rows at or
// past `rows`, and the columns past `width`, are filled with zeros.  With
// VEC (rows 16-byte aligned, width a multiple of 8) each 16-byte chunk is
// one cp.async; otherwise the thread loads the chunk's values one by one
// and stores them itself (the caller fences them for the async proxy with
// the copies).
template <int HP, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int rows, int width) {
  using L = TileLayout<HP, ROWS>;
  constexpr int CPR = HP / 8;                 // 16-byte chunks a tile row
  constexpr int CHUNKS = ROWS * CPR;
  constexpr int ITERS = (CHUNKS + WG - 1) / WG;
  // Where a thread's chunks all sit in one column (WG % CPR == 0), its
  // column test is made once.
  const bool col_ok = WG % CPR != 0 || 8 * (threadIdx.x % CPR) < width;
  auto copy = [&](int u) {
    const int i = u * WG + threadIdx.x;
    if (CHUNKS % WG != 0 && i >= CHUNKS) return;
    const int r = i / CPR, c = i % CPR;
    if constexpr (VEC) {
      const bool ok = row0 + r < rows &&
                      (WG % CPR == 0 ? col_ok : 8 * c < width);
      const __nv_bfloat16* g =
          ok ? src + (long long)(row0 + r) * row_stride + c * 8 : src;
      cp_async16(dst + L::chunk(r, c), g, ok ? 16 : 0);
    } else {
      const int n = row0 + r < rows ? min(8, width - 8 * c) : 0;
      const uint16_t* g = reinterpret_cast<const uint16_t*>(
          src + (long long)(row0 + r) * row_stride + c * 8);
      uint16_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = j < n ? g[j] : uint16_t(0);
      st_shared16(dst + L::chunk(r, c),
                  make_uint4(e[0] | (uint32_t(e[1]) << 16),
                             e[2] | (uint32_t(e[3]) << 16),
                             e[4] | (uint32_t(e[5]) << 16),
                             e[6] | (uint32_t(e[7]) << 16)));
    }
  };
  // Unrolled whole up to HP 256; wider tiles, and the value-by-value
  // copies, unroll less, so that their addresses and values do not crowd
  // out O's registers.
  if constexpr (!VEC) {
#pragma unroll 1
    for (int u = 0; u < ITERS; ++u) copy(u);
  } else if constexpr (HP <= 256) {
#pragma unroll
    for (int u = 0; u < ITERS; ++u) copy(u);
  } else {
#pragma unroll 4
    for (int u = 0; u < ITERS; ++u) copy(u);
  }
}

// The wgmma instructions, one per shape this kernel issues (PTX ISA,
// "wgmma.mma_async"): bf16 inputs, fp32 accumulators.

// S[64 x 32] (+)= A[64 x 16] * B[16 x 32], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x 16] += A[64 x 16] * B[16 x 16], A in registers, B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 32] += A[64 x 16] * B[16 x 32], A in registers, B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 64] += A[64 x 16] * B[16 x 64], A in registers, B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 128] += A[64 x 16] * B[16 x 128], A in registers, B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The fewest k-slices of Q.K^T a width takes: one more than the width
// below it holds.
__host__ __device__ constexpr int min_slices(int hp) {
  return hp <= 16 ? 1 : hp <= 32 ? 2 : hp <= 64 ? 3 : hp <= 128 ? 5
         : hp <= 192 ? 9 : hp <= 256 ? 13 : hp <= 384 ? 17 : 25;
}

// S = Q K^T over the first NK k-slices of 16 head dims, one wgmma pipeline
// (fence, NK wgmmas, commit, wait) in straight-line code: fragment s[4j +
// e] is row r0 (e < 2) or r0 + 8, key t0 + 8j + 2 (lane % 4) + e % 2.
template <int HP, int NK>
__device__ __forceinline__ void qk_product(float (&s)[BKW / 2], uint32_t sq,
                                           uint32_t sk) {
#pragma unroll
  for (int i = 0; i < BKW / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    wgmma_ss(s, desc_k<HP>(sq, kk), desc_k<HP, BKW>(sk, kk), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// S = Q K^T over the nk k-slices that hold real dims (LO <= nk <= NK): one
// instantiation a count, so that no wgmma sits behind a branch inside a
// pipeline.
template <int HP, int NK, int LO>
__device__ __forceinline__ void qk_slices(float (&s)[BKW / 2], uint32_t sq,
                                          uint32_t sk, int nk) {
  if constexpr (NK > LO) {
    if (nk < NK) {
      qk_slices<HP, NK - 1, LO>(s, sq, sk, nk);
      return;
    }
  }
  qk_product<HP, NK>(s, sq, sk);
}

// Up to HP 128 the aligned kernel keeps to 128 registers, so that four
// blocks share an SM (their shared memory allows four).
template <int HP, int OW, bool VEC>
__global__ void __launch_bounds__(WG, HP <= 128 && VEC ? 4 : 1)
    attn_wgmma_kernel(AttnArgs a) {
  using L = TileLayout<HP>;
  using KL = TileLayout<HP, BKW>;
  using VL = TileLayout<OW, BKW>;
  using bf16 = __nv_bfloat16;
  constexpr int NS = HP / OW;                 // blocks that split a row of O
  constexpr int STAGE = KL::BYTES + VL::BYTES;
  // Q tile (64 rows), then two stages of (K tile, V tile) of BKW rows, from
  // a 1024-aligned base.  The V tiles hold this block's OW columns only.
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t sq = base;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Blocks start in grid order, x fastest: the q tile is the slowest axis,
  // taken from the last, so every block of the longest causal rows starts
  // before any shorter one.
  const int qi = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x / NS, b = blockIdx.y, hk = h / a.g;
  const int col0 = (blockIdx.x - h * NS) * OW;    // this block's O columns
  const int hd = a.hd;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* v =
      static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh + col0;
  const int vw = min(OW, hd - col0);              // real columns of V here

  // Key range the block can see (as attn_kernel, in tiles of BKW).
  const int first_pos = qi * BQ + a.q_offset;
  const int last_pos = min(qi * BQ + BQ, a.Sq) - 1 + a.q_offset;
  int kv_end = a.kv_lim;
  int kv_begin = 0;
  if (a.causal) {
    kv_end = min(kv_end, last_pos + 1);
    if (a.window > 0) kv_begin = max(0, first_pos - a.window + 1) / BKW * BKW;
  }
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + BKW - 1) / BKW : 0;

  load_tile<HP, BQ, VEC>(sq, q, a.q_ss, qi * BQ, a.Sq, hd);
  if (n_tiles > 0) {
    load_tile<HP, BKW, VEC>(base + L::BYTES, k, a.k_ss, kv_begin, a.kv_lim,
                            hd);
    load_tile<OW, BKW, VEC>(base + L::BYTES + KL::BYTES, v, a.v_ss,
                            kv_begin, a.kv_lim, vw);
  }
  cp_async_commit();

  // This thread's rows of the tile: r0 and r0 + 8.  Running max (log2
  // units) and this thread's part of each row's sum.
  const int r0 = warp * 16 + (lane >> 2);
  const int qp0 = qi * BQ + r0 + a.q_offset, qp1 = qp0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const float sl2 = a.scale * LOG2E;
  const float cap_in = a.softcap > 0.f ? a.scale / a.softcap : 0.f;
  const float cap_out = a.softcap * LOG2E;
  // O fragment in NO parts, one per P.V wgmma of a 16-key slice (n = PW
  // <= 128 each) over the block's OW columns: o[c][4j + e] is column
  // col0 + PW c + 8 j + 2 (lane % 4) + e % 2 of row r0 (e < 2) or r0 + 8.
  constexpr int PW = OW <= 128 ? OW : OW % 128 == 0 ? 128 : 64;
  constexpr int ON = PW / 2;
  constexpr int NO = OW / PW;
  static_assert(NO == 1 || VL::ROWB == 128, "O parts are whole blocks");
  float o[NO][ON];
#pragma unroll
  for (int c = 0; c < NO; ++c) {
#pragma unroll
    for (int i = 0; i < ON; ++i) o[c][i] = 0.f;
  }
  const int nk = (hd + 15) / 16;     // k-slices of Q.K^T that hold real dims

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = kv_begin + t * BKW;
    const uint32_t sk = base + L::BYTES + (t & 1) * STAGE;
    const uint32_t sv = sk + KL::BYTES;
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();  // tile t in place; every warp done with tile t - 1
    if (t + 1 < n_tiles) {
      const uint32_t nk_tile = base + L::BYTES + ((t + 1) & 1) * STAGE;
      load_tile<HP, BKW, VEC>(nk_tile, k, a.k_ss, t0 + BKW, a.kv_lim, hd);
      load_tile<OW, BKW, VEC>(nk_tile + KL::BYTES, v, a.v_ss, t0 + BKW,
                              a.kv_lim, vw);
      cp_async_commit();
    }

    float s[BKW / 2];
    uint32_t sq_t = sq;
    if constexpr (HP > 256) {
      // Past 16 k-slices the Q descriptors, hoisted out of the loop, would
      // take 64 registers beside O's 128: an opaque copy of the tile's
      // address keeps them in the loop.
      asm volatile("mov.b32 %0, %0;" : "+r"(sq_t));
    }
    qk_slices<HP, HP / 16, min_slices(HP)>(s, sq_t, sk, nk);

    const bool full = t0 + BKW <= a.kv_lim &&
        (!a.causal || (t0 + BKW - 1 <= first_pos &&
                       (a.window <= 0 || last_pos - t0 < a.window)));
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BKW / 2; ++i) {
      float x = s[i];
      if (a.softcap > 0.f) {
        x = cap_out * tanh_approx(x * cap_in);
      } else {
        x *= sl2;
      }
      if (!full) {
        const int kp = t0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
        const int qp = (i & 2) ? qp1 : qp0;
        bool keep = kp < a.kv_lim;
        if (a.causal) {
          keep = keep && kp <= qp;
          if (a.window > 0) keep = keep && (qp - kp) < a.window;
        }
        x = keep ? x : NEG_INF;
      }
      s[i] = x;
      if (i & 2) {
        mx1 = fmaxf(mx1, x);
      } else {
        mx0 = fmaxf(mx0, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float al0 = ex2(m0 - mx0), al1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
    // P as the A operand: register pa[4 kk + i] holds s[8 kk + 2 i] and its
    // neighbour, which is exactly the m64k16 A fragment of keys 16 kk ...
    uint32_t pa[BKW / 4];
#pragma unroll
    for (int i = 0; i < BKW / 4; ++i) {
      const float mm = (i & 1) ? m1 : m0;
      const float p0 = ex2(s[2 * i] - mm), p1 = ex2(s[2 * i + 1] - mm);
      if (i & 1) {
        l1 += p0 + p1;
      } else {
        l0 += p0 + p1;
      }
      pa[i] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int c = 0; c < NO; ++c) {
#pragma unroll
      for (int i = 0; i < ON; ++i) o[c][i] *= (i & 2) ? al1 : al0;
    }

    // O += P V; part c of O takes V's columns from PW c, PW / 64 128-byte
    // column blocks further into the tile per part.
#pragma unroll
    for (int c = 0; c < NO; ++c) fence_regs(o[c]);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKW / 16; ++kk) {
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        wgmma_rs(o[c], pa + 4 * kk,
                 desc_v<OW, BKW>(sv + c * (PW * 2 / VL::ROWB) * VL::BLOCK,
                                 kk));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NO; ++c) fence_regs(o[c]);
  }
  cp_async_wait_all();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float d0 = 1.f / fmaxf(l0, 1e-30f), d1 = 1.f / fmaxf(l1, 1e-30f);
  // Pinned, so that the divisions stay here and are not repeated at each
  // store below.
  asm volatile("" : "+f"(d0), "+f"(d1));
  const int row0 = qi * BQ + r0, row1 = row0 + 8;
  bf16* out = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  // Pairs of columns as one 4-byte store where hd is even (the wrapper's
  // output rows are then 4-byte aligned), else one value at a time.  With
  // VEC hd % 8 == 0, so a group of 8 columns is stored whole or not at all.
  const bool pairs = VEC || (hd & 1) == 0;
  auto store = [&](int row, int col, float x0, float x1) {
    bf16* dst = out + row * a.o_ss + col;
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
    } else {
      dst[0] = __float2bfloat16(x0);
      if (col + 1 < hd) dst[1] = __float2bfloat16(x1);
    }
  };
#pragma unroll
  for (int j = 0; j < OW / 8; ++j) {
    const int col = col0 + 8 * j + 2 * (lane & 3);
    const int c = 8 * j / PW, i = 4 * (j % (PW / 8));
    if (VEC ? col0 + 8 * j < hd : col < hd) {
      if (row0 < a.Sq) store(row0, col, o[c][i] * d0, o[c][i + 1] * d0);
      if (row1 < a.Sq) store(row1, col, o[c][i + 2] * d1, o[c][i + 3] * d1);
    }
  }
}

// Dynamic shared memory of attn_wgmma_kernel<HP, OW>: the Q tile and two
// stages of K tiles at width HP, two stages of V tiles at width OW, and
// 1024 bytes to align the base.
constexpr int wgmma_smem_bytes(int hp, int ow) {
  return (BQ * hp + 2 * BKW * hp + 2 * BKW * ow) * 2 + 1024;
}

template <int HP, bool VEC>
int launch_wgmma_vec(const AttnArgs& a, int B, int Hq, cudaStream_t stream) {
  constexpr int OW = out_width(HP);
  constexpr int smem = wgmma_smem_bytes(HP, OW);
  static_assert(smem <= 227 * 1024, "the tiles fit one SM's shared memory");
  // Past 48 KB a launch needs the opt-in, which is per device: set it on
  // the current one at every such launch.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_wgmma_kernel<HP, OW, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Hq * (HP / OW), B, (a.Sq + BQ - 1) / BQ);
  attn_wgmma_kernel<HP, OW, VEC><<<grid, WG, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HP>
int launch_wgmma_hp(const AttnArgs& a, int B, int Hq, cudaStream_t stream) {
  return a.vec ? launch_wgmma_vec<HP, true>(a, B, Hq, stream)
               : launch_wgmma_vec<HP, false>(a, B, Hq, stream);
}

int launch_wgmma(const AttnArgs& a, int B, int Hq, cudaStream_t stream) {
  switch (wgmma_width(a.hd)) {
    case 16: return launch_wgmma_hp<16>(a, B, Hq, stream);
    case 32: return launch_wgmma_hp<32>(a, B, Hq, stream);
    case 64: return launch_wgmma_hp<64>(a, B, Hq, stream);
    case 128: return launch_wgmma_hp<128>(a, B, Hq, stream);
    case 192: return launch_wgmma_hp<192>(a, B, Hq, stream);
    case 256: return launch_wgmma_hp<256>(a, B, Hq, stream);
    case 384: return launch_wgmma_hp<384>(a, B, Hq, stream);
    case 512: return launch_wgmma_hp<512>(a, B, Hq, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_launch(
    int is_bf16, const void* q, const void* k, const void* v, void* o, int B,
    int Hq, int Hkv, int Sq, int Skv, int hd, const long long* strides,
    int causal, int window, float softcap, int q_offset, int kv_len,
    void* stream) {
  if (Hq % Hkv != 0 || Sq < 1 || Skv < 1 || hd < 1 || hd > 512) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.Sq = Sq; a.Skv = Skv; a.g = Hq / Hkv; a.hd = hd;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_ss = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_ss = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_ss = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_ss = strides[11];
  // The bf16 tiles are copied in 16-byte pieces where every Q, K and V row
  // starts 16-byte aligned and hd fills whole pieces.
  bool vec = hd % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 8 == 0;
  a.vec = vec;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.kv_lim = kv_len < Skv ? kv_len : Skv;
  a.softcap = softcap;
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_wgmma(a, B, Hq, s) : launch<float>(a, B, Hq, s);
}
