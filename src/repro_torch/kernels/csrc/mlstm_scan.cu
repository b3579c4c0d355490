// mlstm_scan for Hopper (sm_90a): chunkwise mLSTM (gated linear attention).
//
// Replaces the Pallas TPU kernel repro.kernels.mlstm_scan.mlstm_scan
// (src/repro/kernels/mlstm_scan.py:73, body _kernel :30-70).  Per (batch,
// head), with F the in-chunk cumulative log(f + 1e-8) and q scaled by
// 1/sqrt(hd):
//   intra:  y_t += sum_{s<=t} (q_t . k_s) exp(F_t - F_s) i_s v_s
//   inter:  y_t += exp(F_t) q_t C
//   state:  C   <- exp(F_c) C + sum_s exp(F_c - F_s) i_s k_s v_s^T
//
// What bounds it: a prefill chunk does 4 c^2 hd + 4 c hd^2 flops on c x hd
// inputs and is bound by operations; a one-token decode step reads and
// writes the hd x hd fp32 state for 4 hd^2 flops and is bound by bytes.
//
// Design:
//   * The state does not fit in shared memory: at hd = 384 one (batch, head)
//     holds 576 KiB of fp32 C, where the TPU kept all of it in VMEM.  The
//     columns of C are independent in the output (y[:, e] = q . C[:, e]) and
//     in the update, so the value dim e is split over blocks: grid (B*H,
//     hd/ET), each block holding an hd x ET slab of C in shared memory for
//     the whole sequence (96 KiB at ET = 64).  At batch 4 this also gives the
//     parallelism: 16 (batch, head) pairs alone would leave 116 of 132 SMs
//     idle, the split gives 96 blocks.
//   * The TPU grid's sequential chunk axis becomes a loop inside the block.
//     Each block recomputes the chunk's c x c scores over the full depth d
//     (the price of the split), streaming q and k in 16-deep tiles; the
//     inter-chunk product q . C uses the same q tiles in the same loop.
//     Outputs sit in registers as 8 x 8 (scores) and 8 x ET/16 (y) tiles per
//     thread, so each shared-memory read feeds several multiply-adds.
//   * fp32 on the CUDA cores for both dtypes: the fp32 parity of 2e-5 rules
//     out TF32.  bf16 inputs are converted on load; the state stays fp32.
//   * A ragged last chunk is masked, not padded: its missing rows count as
//     f = 1, i = 0, the identity update the TPU wrapper pads with.
//   * A chunk of 1 (decode, S = 1) runs step_kernel: the plain recurrence
//     with the block's columns of C in registers, one read and one write of
//     the state, which is what bounds it.
//   * Every block reads its slab of c0 before it writes the same slab of
//     c_out, so c_out may alias c0 (the model's cache is updated in place).
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int NT = 256;           // threads of the chunk kernel: 16 x 16
constexpr int MC = 128;           // largest chunk: rows of the score tile
constexpr int LDP = MC + 1;       // padded row stride of score and q/k tiles
constexpr int DT = 16;            // depth of one q/k tile in the score loop
constexpr int DK = 64;            // rows of C updated per pass
constexpr int LDK = DK + 1;       // padded row stride of the k rows
constexpr int MAX_HD = 448;       // the slab and tiles fill 227 KB at ET = 64
constexpr int STEP_NT = 256;      // threads of the step kernel: 8 warps
constexpr int STEP_W = STEP_NT / 32;
constexpr int STEP_ROWS = MAX_HD / STEP_W;   // rows of C per step thread

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

struct Args {
  const void* q;          // (B, S, H, hd), any strides with unit last dim
  const void* k;
  const void* v;
  const void* ig;         // (B, S, H), any strides
  const void* fg;
  const float* c0;        // (B, H, hd, hd) contiguous
  void* y;                // (B, S, H, hd)
  float* c_out;           // (B, H, hd, hd) contiguous, may be c0
  int B, S, H, hd, chunk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long i_sb, i_ss, i_sh, f_sb, f_ss, f_sh, y_sb, y_ss, y_sh;
  float scale;
};

size_t chunk_smem_bytes(int hd, int et) {
  return sizeof(float) *
         (static_cast<size_t>(hd) * et + MC * LDP + MC * et + 2 * DT * LDP +
          2 * MC);
}

// One block: (batch, head) = blockIdx.x, value columns [e0, e0 + ET) with
// e0 = blockIdx.y * ET.  Thread (ty, tx) of the 16 x 16 grid owns score rows
// t = ty + 16 i, score columns s = tx + 16 j and slab columns tx + 16 j.
template <typename T, int ET>
__global__ void __launch_bounds__(NT, 1) chunk_kernel(Args a) {
  constexpr int EJ = ET / 16;     // slab columns per thread
  extern __shared__ float smem[];
  const int hd = a.hd;
  float* cs = smem;               // hd x ET: this block's columns of C
  float* ps = cs + hd * ET;       // MC x LDP scores; later cl x LDK k rows
  float* vs = ps + MC * LDP;      // MC x ET: v columns, later times rem_s
  float* qt = vs + MC * ET;       // DT x LDP: q tile, transposed, scaled
  float* kt = qt + DT * LDP;      // DT x LDP: k tile, transposed
  float* cum = kt + DT * LDP;     // MC: in-chunk cumulative log forget
  float* igs = cum + MC;          // MC: input gates

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int e0 = blockIdx.y * ET;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + e0;
  const T* ig = static_cast<const T*>(a.ig) + b * a.i_sb + h * a.i_sh;
  const T* fg = static_cast<const T*>(a.fg) + b * a.f_sb + h * a.f_sh;
  T* y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh + e0;
  const long long cbase = static_cast<long long>(bh) * hd * hd + e0;

  for (int i = tid; i < hd * ET; i += NT) {
    const int d = i / ET, e = i - d * ET;
    cs[i] = a.c0[cbase + static_cast<long long>(d) * hd + e];
  }

  for (int t0 = 0; t0 < a.S; t0 += a.chunk) {
    const int cl = min(a.chunk, a.S - t0);
    __syncthreads();  // the previous chunk is done with every buffer

    // Gates and the in-chunk cumulative log forget: warp 0, four rows a
    // lane, then an inclusive scan of the lane totals.  Rows past cl add
    // log 1 = 0 and carry i = 0.
    if (tid < 32) {
      float run = 0.f, part[MC / 32];
#pragma unroll
      for (int u = 0; u < MC / 32; ++u) {
        const int t = tid * (MC / 32) + u;
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
        if (tid >= o) incl += n;
      }
      const float base = incl - run;
#pragma unroll
      for (int u = 0; u < MC / 32; ++u) cum[tid * (MC / 32) + u] = base + part[u];
    }

    // Scores q k^T and the inter-chunk product q C, over d in DT-deep tiles.
    float sc[8][8], yc[8][EJ];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < EJ; ++j) yc[i][j] = 0.f;
    }
    for (int d0 = 0; d0 < hd; d0 += DT) {
      __syncthreads();  // the previous tile is consumed
      for (int i = tid; i < DT * MC; i += NT) {
        const int r = i / DT, dd = i - r * DT;
        float qv = 0.f, kv = 0.f;
        if (r < cl) {
          qv = to_f(q[(t0 + r) * a.q_ss + d0 + dd]) * a.scale;
          kv = to_f(k[(t0 + r) * a.k_ss + d0 + dd]);
        }
        qt[dd * LDP + r] = qv;
        kt[dd * LDP + r] = kv;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < DT; ++dd) {
        float qa[8], kb[8], cc[EJ];
#pragma unroll
        for (int i = 0; i < 8; ++i) qa[i] = qt[dd * LDP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) kb[j] = kt[dd * LDP + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < EJ; ++j) cc[j] = cs[(d0 + dd) * ET + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
#pragma unroll
          for (int j = 0; j < EJ; ++j) yc[i][j] = fmaf(qa[i], cc[j], yc[i][j]);
        }
      }
    }

    // P = scores * D (zero above the diagonal and past cl); the inter term
    // takes its decay exp(F_t); the chunk's v columns are staged.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      const float ct = cum[t];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = tx + 16 * j;
        float p = 0.f;
        if (s <= t && t < cl) p = sc[i][j] * (expf(ct - cum[s]) * igs[s]);
        ps[t * LDP + s] = p;
      }
      const float et = expf(ct);
#pragma unroll
      for (int j = 0; j < EJ; ++j) yc[i][j] *= et;
    }
    for (int i = tid; i < cl * ET; i += NT) {
      const int s = i / ET, e = i - s * ET;
      vs[i] = to_f(v[(t0 + s) * a.v_ss + e]);
    }
    __syncthreads();

    // Intra-chunk: y += P V, then write the chunk's rows of y.
    for (int s = 0; s < cl; ++s) {
      float pa[8], vb[EJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) pa[i] = ps[(ty + 16 * i) * LDP + s];
#pragma unroll
      for (int j = 0; j < EJ; ++j) vb[j] = vs[s * ET + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < EJ; ++j) yc[i][j] = fmaf(pa[i], vb[j], yc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      if (t < cl) {
#pragma unroll
        for (int j = 0; j < EJ; ++j)
          y[(t0 + t) * a.y_ss + tx + 16 * j] = from_f<T>(yc[i][j]);
      }
    }
    __syncthreads();  // P and v are consumed

    // State: C <- exp(F_c) C + K^T (rem * V), DK rows of C per pass.
    const float clast = cum[cl - 1];
    const float decay = expf(clast);
    for (int i = tid; i < cl * ET; i += NT) {
      const int s = i / ET;
      vs[i] *= expf(clast - cum[s]) * igs[s];
    }
    for (int d0 = 0; d0 < hd; d0 += DK) {
      __syncthreads();  // v is scaled; the previous k rows are consumed
      for (int i = tid; i < cl * DK; i += NT) {
        const int s = i / DK, dd = i - s * DK;
        ps[s * LDK + dd] =
            d0 + dd < hd ? to_f(k[(t0 + s) * a.k_ss + d0 + dd]) : 0.f;
      }
      __syncthreads();
      float u[4][EJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < EJ; ++j) u[i][j] = 0.f;
      }
      for (int s = 0; s < cl; ++s) {
        float ka[4], vb[EJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) ka[i] = ps[s * LDK + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < EJ; ++j) vb[j] = vs[s * ET + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < EJ; ++j) u[i][j] = fmaf(ka[i], vb[j], u[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = d0 + ty + 16 * i;
        if (d < hd) {
#pragma unroll
          for (int j = 0; j < EJ; ++j) {
            float* c = cs + d * ET + tx + 16 * j;
            *c = fmaf(*c, decay, u[i][j]);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < hd * ET; i += NT) {
    const int d = i / ET, e = i - d * ET;
    a.c_out[cbase + static_cast<long long>(d) * hd + e] = cs[i];
  }
}

// Chunk 1: the recurrence one token at a time.  Block (batch, head) =
// blockIdx.x, value columns e = blockIdx.y * 32 + lane; warp w holds rows
// d = w + 8 r of those columns of C in registers.
template <typename T>
__global__ void __launch_bounds__(STEP_NT) step_kernel(Args a) {
  __shared__ float red[STEP_W][33];
  __shared__ float qk_red[STEP_W];
  const int hd = a.hd;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.y * 32 + lane;
  const bool live = e < hd;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* ig = static_cast<const T*>(a.ig) + b * a.i_sb + h * a.i_sh;
  const T* fg = static_cast<const T*>(a.fg) + b * a.f_sb + h * a.f_sh;
  T* y = static_cast<T*>(a.y) + b * a.y_sb + h * a.y_sh;
  const long long cbase = static_cast<long long>(bh) * hd * hd + e;

  float c[STEP_ROWS];
#pragma unroll
  for (int r = 0; r < STEP_ROWS; ++r) {
    const int d = w + STEP_W * r;
    c[r] = (live && d < hd) ? a.c0[cbase + static_cast<long long>(d) * hd]
                            : 0.f;
  }
  for (int t = 0; t < a.S; ++t) {
    const float decay = expf(logf(to_f(fg[t * a.f_ss]) + 1e-8f));
    const float iv = to_f(ig[t * a.i_ss]);
    const float ve = live ? to_f(v[t * a.v_ss + e]) : 0.f;
    float yp = 0.f, qk = 0.f;
#pragma unroll
    for (int r = 0; r < STEP_ROWS; ++r) {
      const int d = w + STEP_W * r;
      if (d < hd) {
        const float qd = to_f(q[t * a.q_ss + d]) * a.scale;
        const float kd = to_f(k[t * a.k_ss + d]);
        yp = fmaf(qd, c[r], yp);
        qk = fmaf(qd, kd, qk);
        c[r] = fmaf(c[r], decay, kd * iv * ve);
      }
    }
    red[w][lane] = yp;
    if (lane == 0) qk_red[w] = qk;
    __syncthreads();
    if (w == 0) {
      float ys = 0.f, qks = 0.f;
#pragma unroll
      for (int u = 0; u < STEP_W; ++u) {
        ys += red[u][lane];
        qks += qk_red[u];
      }
      if (live) y[t * a.y_ss + e] = from_f<T>(fmaf(decay, ys, qks * iv * ve));
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < STEP_ROWS; ++r) {
    const int d = w + STEP_W * r;
    if (live && d < hd) a.c_out[cbase + static_cast<long long>(d) * hd] = c[r];
  }
}

template <typename T, int ET>
int launch_chunk(const Args& a, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(chunk_kernel<T, ET>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         227 * 1024);
    opted_in = true;
  }
  chunk_kernel<T, ET><<<dim3(a.B * a.H, a.hd / ET), NT,
                        chunk_smem_bytes(a.hd, ET), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  if (a.chunk == 1) {
    step_kernel<T><<<dim3(a.B * a.H, (a.hd + 31) / 32), STEP_NT, 0,
                     stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.hd % 64 == 0) return launch_chunk<T, 64>(a, stream);
  if (a.hd % 32 == 0) return launch_chunk<T, 32>(a, stream);
  return launch_chunk<T, 16>(a, stream);
}

}  // namespace

extern "C" int mlstm_scan_launch(
    int is_bf16, const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const float* c0, void* y, float* c_out, int B, int S,
    int H, int hd, int chunk, const long long* strides, void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 16 || hd % 16 != 0 || hd > MAX_HD ||
      chunk < 1 || chunk > MC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q; a.k = k; a.v = v; a.ig = ig; a.fg = fg;
  a.c0 = c0; a.y = y; a.c_out = c_out;
  a.B = B; a.S = S; a.H = H; a.hd = hd; a.chunk = chunk;
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_ss = strides[4]; a.k_sh = strides[5];
  a.v_sb = strides[6]; a.v_ss = strides[7]; a.v_sh = strides[8];
  a.i_sb = strides[9]; a.i_ss = strides[10]; a.i_sh = strides[11];
  a.f_sb = strides[12]; a.f_ss = strides[13]; a.f_sh = strides[14];
  a.y_sb = strides[15]; a.y_ss = strides[16]; a.y_sh = strides[17];
  a.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
