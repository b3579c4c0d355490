// mamba_scan for Hopper (sm_90a): the selective scan of a Mamba layer.
//
// Replaces the Pallas TPU kernel repro.kernels.mamba_scan.mamba_scan
// (src/repro/kernels/mamba_scan.py:55, body _kernel :28-52).  Per batch row
// and channel d, with a state h of N values:
//   h_t = exp(dt_t a_d) * h_{t-1} + (dt_t b_t) u_t,   y_t = h_t . c_t
// u, dt: (B, S, di); a: (di, N) fp32; b, c: (B, S, N); h0: (B, di, N) fp32.
// Returns y (B, S, di) in u's dtype and h_last (B, di, N) fp32.
//
// What bounds it: bytes and the special-function units together.  A call
// reads u and dt and writes y, one value per (token, channel), and reads and
// writes the fp32 state once: at Jamba's prefill (4, 256, 8192, 16) fp32,
// 105.5 MB, 0.0315 ms at an H100's 3.35 TB/s.  Per value of u it takes N
// exps, one MUFU.EX2 each, and an H100 SM has 16 of those a clock: 134 M
// exps, 0.0321 ms on 132 SMs at 1.98 GHz.  The fp32 multiply-adds (4 N per
// value) fit under both.
//
// Design (prefill, scan_kernel):
//   * LPC lanes own one (batch, channel) pair, NPL = NP / LPC states each,
//     so a block of 256 threads covers 256 / LPC channels.  The kernel is
//     instantiated per padded state width NP (4, 8, 16, 32, 64, 128, 256:
//     state_width on the host): LPC is 4 up to NP 16 (NPL 1, 2 or 4), then
//     8, 16 and 32 lanes of 4 states, and 32 lanes of 8 at NP 256, so no
//     lane holds more than 8 states and 256-thread blocks stay resident.
//     At Jamba's N = 16 the grid (di / 64, B) puts 512 blocks, four an SM,
//     on the card: 4x the warps of one lane per channel.
//   * A state size below its width (N = 12 at NP 16) is padded in shared
//     memory: b and c are zero past N in every slot, a and h0 read as 0
//     there, so the padded states stay 0 and add 0 to y; h_last stores only
//     the first N.  A channel tail (di not a multiple of the block's
//     channels) is predicated: its lanes read zeros and store nothing.
//   * u, dt, b and c come off the dependent chain: each 16-step chunk's
//     tiles are copied into shared memory with cp.async through a ring of
//     three slots, so the next two chunks' 20 KB a block (80 KB an SM at
//     N = 16, what the memory's latency needs at its full rate) fly while
//     this chunk's steps run.  Within a step the exps do not depend on h;
//     only one multiply-add per state does.  Rows of u and dt that are not
//     16-byte aligned (an odd di), and rows of b and c that are not 4-byte
//     aligned, are read value by value and stored by the threads.
//   * The SFU's exps set the pace, so a step issues little else: b and c
//     are one vector load each, and each lane stores its partial y_t to
//     shared memory; the LPC lanes' partials are summed once per chunk and
//     y is written in 16-byte stores (where di % 4 == 0), consecutive
//     threads on consecutive channels.
//   * exp(dt a) is one ex2.approx of dt (a log2 e), a scaled once per thread
//     (a is a learned parameter: nothing assumes its value).
//   * A ragged last chunk is masked (the loop stops at S), not padded: the
//     TPU wrapper's dt = 0 padding is the identity update, so both give the
//     same y and h_last.  bf16 inputs are converted on read from shared
//     memory; the state and the arithmetic stay fp32.
// Design (decode, S = 1, step_kernel): the same lanes over N, the state and
//   a read and written as 16-byte vectors where N = NP (a warp's accesses
//   are 512 contiguous bytes at N = 16), b and c read straight from memory,
//   y summed by shuffles over the LPC lanes: no shared memory and no
//   barrier.
// In both, each thread reads its part of h0 before it writes the same part
// of h_out, so h_out may alias h0 (the decode step updates the model's cache
// in place).
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int TS = 16;            // time steps per staged chunk
constexpr int STAGES = 3;         // chunks in the ring: two in flight
constexpr float LOG2E = 1.4426950408889634f;

// Lanes per channel at padded state width NP, and so channels per block.
__host__ __device__ constexpr int lanes_per_channel(int np) {
  return np <= 16 ? 4 : np >= 128 ? 32 : np / 4;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The sum over the LPC neighbouring lanes of one channel.
template <int LPC>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int o = 1; o < LPC; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// NPL consecutive fp32 values as vector accesses (NPL = 1, 2, 4 or 8).
template <int NPL>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[NPL]) {
  if constexpr (NPL >= 4) {
#pragma unroll
    for (int i = 0; i < NPL; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x; v[i + 1] = x.y; v[i + 2] = x.z; v[i + 3] = x.w;
    }
  } else if constexpr (NPL == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = *p;
  }
}
template <int NPL>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[NPL]) {
  if constexpr (NPL >= 4) {
#pragma unroll
    for (int i = 0; i < NPL; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else if constexpr (NPL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// NPL consecutive values of b or c from shared memory as fp32, in vector
// accesses (16, 8 or 4 bytes of fp32; 8, 4 or 2 of bf16 each).
template <int NPL>
__device__ __forceinline__ void lds_vec(const float* p, float (&v)[NPL]) {
  load_vec<NPL>(p, v);
}
template <int NPL>
__device__ __forceinline__ void lds_vec(const __nv_bfloat16* p,
                                        float (&v)[NPL]) {
  if constexpr (NPL >= 4) {
#pragma unroll
    for (int i = 0; i < NPL; i += 4) {
      const uint2 r = *reinterpret_cast<const uint2*>(p + i);
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
      v[i] = lo.x; v[i + 1] = lo.y; v[i + 2] = hi.x; v[i + 3] = hi.y;
    }
  } else if constexpr (NPL == 2) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// cp.async of 16 bytes of which src_bytes are read (the rest zero-filled).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING));
}

struct ScanArgs {
  const void* u;          // (B, S, di), unit last dim
  const void* dt;         // (B, S, di)
  const float* a;         // (di, N), contiguous
  const void* b;          // (B, S, N), unit last dim
  const void* c;          // (B, S, N)
  const float* h0;        // (B, di, N), contiguous
  void* y;                // (B, S, di), contiguous
  float* h_out;           // (B, di, N), contiguous; may alias h0
  int S, di, N;
  int uvec;               // u, dt rows 16-byte aligned
  int bcvec;              // b, c rows 4-byte aligned, N * itemsize % 4 == 0
  int hvec;               // N == NP and a, h0, h_out 16-byte aligned
  long long u_sb, u_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

template <typename T, int NP>
constexpr size_t scan_smem_bytes() {
  constexpr int LPC = lanes_per_channel(NP), CH = NT / LPC;
  return STAGES * (2 * TS * CH + 2 * TS * NP) * sizeof(T) +
         TS * LPC * (CH + 8) * sizeof(float);
}

// The thread's NPL values of a (di, N) or (B, di, N) row at state q0, 0
// past N; vector loads where the row is whole (hvec).
template <int NPL>
__device__ __forceinline__ void load_states(const float* row, int q0, int N,
                                            bool hvec, float (&v)[NPL]) {
  if (hvec) {
    load_vec<NPL>(row + q0, v);
  } else {
#pragma unroll
    for (int k = 0; k < NPL; ++k) v[k] = q0 + k < N ? row[q0 + k] : 0.f;
  }
}

// Block (channel group blockIdx.x, batch row blockIdx.y); thread tid owns
// channel d = blockIdx.x * CH + tid / LPC and states (tid % LPC) * NPL + k.
template <typename T, int NP>
__global__ void __launch_bounds__(NT) scan_kernel(ScanArgs p) {
  constexpr int LPC = lanes_per_channel(NP), CH = NT / LPC, NPL = NP / LPC;
  constexpr int YL = CH + 8;        // row stride of one lane's partial y
  constexpr int YS = LPC * YL;      // row stride of a step's partial y
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  // Buffer k: u [TS][CH], dt [TS][CH], b [TS][NP], c [TS][NP].  ys holds
  // each lane's partial y, [TS][LPC][YL], summed at the end of the chunk;
  // the padded rows keep both the stores and the sums free of bank
  // conflicts.
  constexpr int BUF = 2 * TS * CH + 2 * TS * NP;
  float* ys = reinterpret_cast<float*>(smem + STAGES * BUF * sizeof(T));

  const int tid = threadIdx.x, ch = tid / LPC, qd = tid % LPC;
  const int bi = blockIdx.y, d0 = blockIdx.x * CH, d = d0 + ch;
  const int N = p.N, di = p.di, nch = min(CH, di - d0);   // live channels
  const bool live = ch < nch;
  const bool hvec = p.hvec != 0;
  const T* u = static_cast<const T*>(p.u) + bi * p.u_sb + d0;
  const T* dt = static_cast<const T*>(p.dt) + bi * p.dt_sb + d0;
  const T* b = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* c = static_cast<const T*>(p.c) + bi * p.c_sb;
  T* y = static_cast<T*>(p.y) + (long long)bi * p.S * di + d0;
  const long long hrow = ((long long)bi * di + (live ? d : 0)) * N;
  const int q0 = qd * NPL;

  float a2[NPL], h[NPL];
  load_states<NPL>(p.a + (long long)(live ? d : 0) * N, q0, N, hvec, a2);
  load_states<NPL>(p.h0 + hrow, q0, N, hvec, h);
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    a2[k] = live ? a2[k] * LOG2E : 0.f;
    h[k] = live ? h[k] : 0.f;
  }

  // b and c are zero past N in every slot; the copies never write there.
  if (N < NP) {
    for (int i = tid; i < STAGES * 2 * TS * (NP - N); i += NT) {
      const int row = i / (NP - N), n = N + i % (NP - N);
      const int slot = row / (2 * TS), rr = row % (2 * TS);
      tiles[slot * BUF + 2 * TS * CH + rr * NP + n] = zero<T>();
    }
  }

  // Copies chunk t0 / TS into ring slot buf and commits them as one group
  // (an empty group past the sequence, so the group count stays in step).
  auto issue = [&](int t0, int buf) {
    const int len = min(TS, p.S - t0);
    T* ut = tiles + buf * BUF;
    T* dtt = ut + TS * CH;
    T* bt = dtt + TS * CH;
    T* ct = bt + TS * NP;
    constexpr int PER16 = 16 / sizeof(T);
    constexpr int ROW16 = CH / PER16;              // 16-byte units a row
    for (int i = tid; i < len * ROW16; i += NT) {
      const int r = i / ROW16, k = (i - r * ROW16) * PER16;
      const int nv = min(PER16, nch - k);          // live channels here
      const T* us = u + (t0 + r) * p.u_ss + k;
      const T* ds = dt + (t0 + r) * p.dt_ss + k;
      if (p.uvec) {
        const int bytes = nv > 0 ? nv * static_cast<int>(sizeof(T)) : 0;
        cp_async16(ut + r * CH + k, nv > 0 ? us : u, bytes);
        cp_async16(dtt + r * CH + k, nv > 0 ? ds : dt, bytes);
      } else {
#pragma unroll
        for (int e = 0; e < PER16; ++e) {
          ut[r * CH + k + e] = e < nv ? us[e] : zero<T>();
          dtt[r * CH + k + e] = e < nv ? ds[e] : zero<T>();
        }
      }
    }
    if (p.bcvec) {
      const int row4 = N * static_cast<int>(sizeof(T)) / 4;   // 4-byte units
      constexpr int PER4 = 4 / sizeof(T);
      for (int i = tid; i < len * row4; i += NT) {
        const int r = i / row4, k = (i - r * row4) * PER4;
        cp_async4(bt + r * NP + k, b + (t0 + r) * p.b_ss + k);
        cp_async4(ct + r * NP + k, c + (t0 + r) * p.c_ss + k);
      }
    } else {
      for (int i = tid; i < len * N; i += NT) {
        const int r = i / N, k = i - r * N;
        bt[r * NP + k] = b[(t0 + r) * p.b_ss + k];
        ct[r * NP + k] = c[(t0 + r) * p.c_ss + k];
      }
    }
    cp_async_commit();
  };

  const int n_chunks = (p.S + TS - 1) / TS;
  for (int k = 0; k < STAGES - 1; ++k) issue(k * TS, k);
  for (int kc = 0; kc < n_chunks; ++kc) {
    const int t0 = kc * TS, len = min(TS, p.S - t0), buf = kc % STAGES;
    cp_async_wait<STAGES - 2>();  // chunk kc's group is complete
    __syncthreads();  // its tiles are visible; slot kc - 1 and ys are free
    issue(t0 + (STAGES - 1) * TS, (kc + STAGES - 1) % STAGES);
    const T* ut = tiles + buf * BUF + ch;
    const T* dtt = ut + TS * CH;
    const T* bt = tiles + buf * BUF + 2 * TS * CH + q0;
    const T* ct = bt + TS * NP;
    auto step = [&](int j) {
      const float dtv = to_f(dtt[j * CH]);
      const float du = dtv * to_f(ut[j * CH]);
      float bv[NPL], cv[NPL];
      lds_vec<NPL>(bt + j * NP, bv);
      lds_vec<NPL>(ct + j * NP, cv);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        h[k] = fmaf(ex2(dtv * a2[k]), h[k], du * bv[k]);
        acc = fmaf(h[k], cv[k], acc);
      }
      ys[j * YS + qd * YL + ch] = acc;
    };
    if (len == TS) {
#pragma unroll
      for (int j = 0; j < TS; ++j) step(j);
    } else {
      for (int j = 0; j < len; ++j) step(j);
    }
    __syncthreads();  // ys holds the chunk's partial y; the tiles are consumed
    // y rows, 4 channels a thread (the sum of each channel's LPC lanes):
    // consecutive threads write consecutive channels of one row.
    for (int i = tid; i < len * (CH / 4); i += NT) {
      const int r = i / (CH / 4), k = (i - r * (CH / 4)) * 4;
      if (k >= nch) continue;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < LPC; ++m) {
        const float4 x =
            *reinterpret_cast<const float4*>(ys + r * YS + m * YL + k);
        o[0] += x.x; o[1] += x.y; o[2] += x.z; o[3] += x.w;
      }
      T* dst = y + (long long)(t0 + r) * di + k;
      if (di % 4 != 0 || k + 4 > nch) {
        for (int e = 0; e < 4 && k + e < nch; ++e) {
          if constexpr (sizeof(T) == 4) {
            dst[e] = o[e];
          } else {
            dst[e] = __float2bfloat16(o[e]);
          }
        }
      } else if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
        __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
        uint2 v;
        v.x = *reinterpret_cast<unsigned*>(&lo);
        v.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(dst) = v;
      }
    }
  }
  if (live) {
    if (hvec) {
      store_vec<NPL>(p.h_out + hrow + q0, h);
    } else {
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        if (q0 + k < N) p.h_out[hrow + q0 + k] = h[k];
      }
    }
  }
}

// S = 1 (and any S, one step at a time): the same thread layout, straight
// from device memory.
template <typename T, int NP>
__global__ void __launch_bounds__(NT) step_kernel(ScanArgs p) {
  constexpr int LPC = lanes_per_channel(NP), CH = NT / LPC, NPL = NP / LPC;
  const int tid = threadIdx.x, qd = tid % LPC, q0 = qd * NPL;
  const int N = p.N;
  const int bi = blockIdx.y, d = blockIdx.x * CH + tid / LPC;
  const bool live = d < p.di;
  const bool hvec = p.hvec != 0;
  const int dd = live ? d : 0;
  const T* u = static_cast<const T*>(p.u) + bi * p.u_sb + dd;
  const T* dt = static_cast<const T*>(p.dt) + bi * p.dt_sb + dd;
  const T* b = static_cast<const T*>(p.b) + bi * p.b_sb + q0;
  const T* c = static_cast<const T*>(p.c) + bi * p.c_sb + q0;
  T* y = static_cast<T*>(p.y) + (long long)bi * p.S * p.di + dd;
  const long long hrow = ((long long)bi * p.di + dd) * N;

  float a2[NPL], h[NPL];
  load_states<NPL>(p.a + (long long)dd * N, q0, N, hvec, a2);
  load_states<NPL>(p.h0 + hrow, q0, N, hvec, h);
#pragma unroll
  for (int k = 0; k < NPL; ++k) a2[k] *= LOG2E;
  for (int t = 0; t < p.S; ++t) {
    const float dtv = to_f(dt[t * p.dt_ss]);
    const float du = dtv * to_f(u[t * p.u_ss]);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const bool in = q0 + k < N;
      const float e = ex2(dtv * a2[k]);
      h[k] = fmaf(e, h[k], in ? du * to_f(b[t * p.b_ss + k]) : 0.f);
      acc = fmaf(h[k], in ? to_f(c[t * p.c_ss + k]) : 0.f, acc);
    }
    acc = lane_sum<LPC>(acc);
    if (live && qd == 0) {
      if constexpr (sizeof(T) == 4) {
        y[(long long)t * p.di] = acc;
      } else {
        y[(long long)t * p.di] = __float2bfloat16(acc);
      }
    }
  }
  if (live) {
    if (hvec) {
      store_vec<NPL>(p.h_out + hrow + q0, h);
    } else {
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        if (q0 + k < N) p.h_out[hrow + q0 + k] = h[k];
      }
    }
  }
}

template <typename T, int NP>
int launch_np(ScanArgs p, int B, cudaStream_t stream) {
  constexpr int CH = NT / lanes_per_channel(NP);
  p.hvec = p.hvec && p.N == NP;
  const dim3 grid((p.di + CH - 1) / CH, B);
  if (p.S == 1) {
    step_kernel<T, NP><<<grid, NT, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr size_t smem = scan_smem_bytes<T, NP>();
  static_assert(smem <= 227 * 1024, "the ring fits one SM's shared memory");
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(scan_kernel<T, NP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    opted_in = true;
  }
  scan_kernel<T, NP><<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The padded state width (state_width on the host): 4, 8 or 16, then the
// powers of two up to 256.
int state_width(int n) {
  int w = 4;
  while (w < n) w *= 2;
  return w;
}

template <typename T>
int launch(const ScanArgs& p, int B, cudaStream_t stream) {
  switch (state_width(p.N)) {
    case 4: return launch_np<T, 4>(p, B, stream);
    case 8: return launch_np<T, 8>(p, B, stream);
    case 16: return launch_np<T, 16>(p, B, stream);
    case 32: return launch_np<T, 32>(p, B, stream);
    case 64: return launch_np<T, 64>(p, B, stream);
    case 128: return launch_np<T, 128>(p, B, stream);
    case 256: return launch_np<T, 256>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int mamba_scan_launch(
    int is_bf16, const void* u, const void* dt, const float* a, const void* b,
    const void* c, const float* h0, void* y, float* h_out, int B, int S,
    int di, int N, const long long* strides, void* stream) {
  if (B < 1 || S < 1 || di < 1 || N < 1 || N > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long item = is_bf16 ? 2 : 4;
  auto addr = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr); };
  ScanArgs p;
  p.u = u; p.dt = dt; p.a = a; p.b = b; p.c = c; p.h0 = h0;
  p.y = y; p.h_out = h_out;
  p.S = S; p.di = di; p.N = N;
  p.u_sb = strides[0]; p.u_ss = strides[1];
  p.dt_sb = strides[2]; p.dt_ss = strides[3];
  p.b_sb = strides[4]; p.b_ss = strides[5];
  p.c_sb = strides[6]; p.c_ss = strides[7];
  p.uvec = (addr(u) | addr(dt)) % 16 == 0 &&
           (p.u_sb * item) % 16 == 0 && (p.u_ss * item) % 16 == 0 &&
           (p.dt_sb * item) % 16 == 0 && (p.dt_ss * item) % 16 == 0;
  p.bcvec = (addr(b) | addr(c)) % 4 == 0 && (N * item) % 4 == 0 &&
            (p.b_sb * item) % 4 == 0 && (p.b_ss * item) % 4 == 0 &&
            (p.c_sb * item) % 4 == 0 && (p.c_ss * item) % 4 == 0;
  p.hvec = (addr(a) | addr(h0) | addr(h_out)) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, B, s) : launch<float>(p, B, s);
}
