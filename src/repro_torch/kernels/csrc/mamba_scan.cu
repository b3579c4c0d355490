// mamba_scan for Hopper (sm_90a): the selective scan of a Mamba layer.
//
// Replaces the Pallas TPU kernel repro.kernels.mamba_scan.mamba_scan
// (src/repro/kernels/mamba_scan.py:55, body _kernel :28-52).  Per batch row
// and channel d, with a state h of N values:
//   h_t = exp(dt_t a_d) * h_{t-1} + (dt_t b_t) u_t,   y_t = h_t . c_t
// u, dt: (B, S, di); a: (di, N) fp32; b, c: (B, S, N); h0: (B, di, N) fp32.
// Returns y (B, S, di) in u's dtype and h_last (B, di, N) fp32.
//
// What bounds it: bytes.  A call reads u and dt and writes y, one value per
// (token, channel), and reads and writes the fp32 state once; per value of
// u it does N exps and about 4 N flops, which the card's special-function
// units and fp32 cores clear in about the time the bytes take.
//
// Design:
//   * One thread owns one (batch, channel) pair and keeps that channel's N
//     state values and its row of a in registers for the whole sequence.
//     The recurrence is sequential in t but its N chains are independent,
//     which is the thread's instruction-level parallelism.  A block is 128
//     consecutive channels; the grid is (di / 128, B): 256 blocks at
//     Jamba's di = 8192 and batch 4, for prefill and decode alike.
//   * The TPU grid's sequential chunk axis becomes a loop inside the block.
//     Each chunk's b_t and c_t rows (CHUNK x N, the same for every channel
//     of a batch row) are staged once in shared memory as fp32 and read as
//     broadcasts; u and dt are read, and y written, straight from device
//     memory, consecutive threads on consecutive channels (coalesced).
//   * A ragged last chunk is masked (the loop stops at S), not padded: the
//     TPU wrapper's dt = 0 padding is the identity update, so both give the
//     same y and h_last.
//   * fp32 throughout, with the accurate expf: bf16 inputs are converted on
//     load, y is rounded to u's dtype on store.
//   * Each thread reads its h0 into registers before it writes h_last, so
//     h_last may alias h0 (the decode step updates the model's cache in
//     place).  One kernel covers S = 1.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;           // channels (threads) per block
constexpr int CHUNK = 64;         // time steps of b and c staged at once

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

struct ScanArgs {
  const void* u;          // (B, S, di), any batch/seq strides, unit last dim
  const void* dt;         // (B, S, di)
  const float* a;         // (di, N), contiguous
  const void* b;          // (B, S, N)
  const void* c;          // (B, S, N)
  const float* h0;        // (B, di, N), contiguous
  void* y;                // (B, S, di), contiguous
  float* h_out;           // (B, di, N), contiguous; may alias h0
  int S, di;
  long long u_sb, u_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
};

template <typename T, int N>
__global__ void __launch_bounds__(NT) scan_kernel(ScanArgs p) {
  __shared__ float bs[CHUNK][N];
  __shared__ float cs[CHUNK][N];

  const int bi = blockIdx.y;
  const int d = blockIdx.x * NT + threadIdx.x;
  const bool live = d < p.di;
  const T* u = static_cast<const T*>(p.u) + bi * p.u_sb + d;
  const T* dt = static_cast<const T*>(p.dt) + bi * p.dt_sb + d;
  const T* b = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* c = static_cast<const T*>(p.c) + bi * p.c_sb;
  T* y = static_cast<T*>(p.y) + (long long)bi * p.S * p.di + d;
  const long long hoff = ((long long)bi * p.di + d) * N;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? p.a[(long long)d * N + n] : 0.f;
    h[n] = live ? p.h0[hoff + n] : 0.f;
  }

  for (int t0 = 0; t0 < p.S; t0 += CHUNK) {
    const int len = min(CHUNK, p.S - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < len * N; i += NT) {
      const int j = i / N, n = i - j * N;
      bs[j][n] = to_f(b[(t0 + j) * p.b_ss + n]);
      cs[j][n] = to_f(c[(t0 + j) * p.c_ss + n]);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const int t = t0 + j;
      const float ut = to_f(u[t * p.u_ss]);
      const float dtt = to_f(dt[t * p.dt_ss]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtt * a[n]) * h[n] + dtt * bs[j][n] * ut;
        acc = fmaf(h[n], cs[j][n], acc);
      }
      y[(long long)t * p.di] = from_f<T>(acc);
    }
  }

  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) p.h_out[hoff + n] = h[n];
  }
}

template <typename T, int N>
int launch_n(const ScanArgs& p, int B, cudaStream_t stream) {
  const dim3 grid((p.di + NT - 1) / NT, B);
  scan_kernel<T, N><<<grid, NT, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const ScanArgs& p, int B, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch_n<T, 4>(p, B, stream);
    case 8: return launch_n<T, 8>(p, B, stream);
    case 16: return launch_n<T, 16>(p, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int mamba_scan_launch(
    int is_bf16, const void* u, const void* dt, const float* a, const void* b,
    const void* c, const float* h0, void* y, float* h_out, int B, int S,
    int di, int N, const long long* strides, void* stream) {
  if (B < 1 || S < 1 || di < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScanArgs p;
  p.u = u; p.dt = dt; p.a = a; p.b = b; p.c = c; p.h0 = h0;
  p.y = y; p.h_out = h_out;
  p.S = S; p.di = di;
  p.u_sb = strides[0]; p.u_ss = strides[1];
  p.dt_sb = strides[2]; p.dt_ss = strides[3];
  p.b_sb = strides[4]; p.b_ss = strides[5];
  p.c_sb = strides[6]; p.c_ss = strides[7];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, B, N, s)
                 : launch<float>(p, B, N, s);
}
