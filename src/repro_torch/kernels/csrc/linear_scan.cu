// Linear-recurrence scans for Hopper (sm_90a): RG-LRU and RWKV-6 WKV.
//
// Replace the JAX package's kernels/linear_scan.py::lru_scan_chunked and
// ::rwkv_scan_chunked (Pallas TPU, _lru_kernel and _rwkv_kernel).  There the
// time axis is a sequential grid dimension and the fp32 state stays in VMEM
// from one grid step to the next.  Blocks on a GPU run in no order, so here
// each block owns its whole time axis and loops over it itself, with the
// state in registers; nothing is carried between blocks.
//
// lru_scan: h_t = a_t * h_{t-1} + b_t, elementwise over (B, T, D).  One
// thread per channel, grid (D / block_d, B).  Per chunk of `chunk` time
// steps, the block stages its (chunk, block_d) slices of a and b in shared
// memory as fp32 (every load of the chunk is issued before the serial
// recurrence over it), then runs the chunk's steps with h in a register and
// writes hs in the input dtype.  What bounds it: memory, three passes over
// (B, T, D) (a and b read, hs written) against 2 FLOP per element.
//
// rwkv_scan: per (batch, head), with an fp32 (hd x hd) state S,
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] <- exp(lw_t[i]) S[i][j] + k_t[i] v_t[j]
// The exact per-token recurrence, not the TPU kernel's chunk form: that
// builds an (L, L, hd) fp32 tensor of cumulative-decay differences, 1 MiB at
// L = hd = 64, more than a block's shared memory.  Per token there are no
// decay differences, so nothing overflows at any decay.  One block per
// (batch, head), one thread per column j, S[:, j] in registers (hd is a
// template parameter so the column is a register array).  Per chunk the
// block stages r, k, v, exp(lw) and u*k for `chunk` tokens in shared memory
// (each thread computes one channel's exp and bonus), then every thread
// walks the chunk's tokens reading the row values as broadcasts.  What
// bounds it: operations, about 5 hd^2 fp32 FLOP per (token, head) on the
// CUDA cores against 2-4 bytes per (token, head, channel).  A chunked
// tensor-core form is later work.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success.  Launches go on the stream the caller passes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_SMEM = 232448;  // shared memory one block may use on Hopper (227 KB)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------------------------ RG-LRU
template <typename T>
__global__ void __launch_bounds__(1024)
lru_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
           T* __restrict__ hs, float* __restrict__ hT, int T_len, int D, int chunk) {
  extern __shared__ float lru_smem[];
  const int bd = blockDim.x;
  float* as = lru_smem;          // [chunk][bd]
  float* bs = lru_smem + chunk * bd;  // [chunk][bd]
  const int tid = threadIdx.x;
  const int d = blockIdx.x * bd + tid;
  const long long row = static_cast<long long>(blockIdx.y) * T_len;  // batch offset in steps
  float h = h0[static_cast<long long>(blockIdx.y) * D + d];
  for (int t0 = 0; t0 < T_len; t0 += chunk) {
    // each thread stages and later reads only its own channel: no barrier
    for (int t = 0; t < chunk; ++t) {
      const long long off = (row + t0 + t) * D + d;
      as[t * bd + tid] = to_float(a[off]);
      bs[t * bd + tid] = to_float(b[off]);
    }
    for (int t = 0; t < chunk; ++t) {
      h = fmaf(as[t * bd + tid], h, bs[t * bd + tid]);
      hs[(row + t0 + t) * D + d] = from_float<T>(h);
    }
  }
  hT[static_cast<long long>(blockIdx.y) * D + d] = h;
}

template <typename T>
int lru_launch(const void* a, const void* b, const void* h0, void* hs, void* hT, int B, int T_len,
               int D, int chunk, int block_d, void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0 || chunk <= 0 || block_d <= 0 || block_d > 1024 ||
      T_len % chunk || D % block_d)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(chunk) * block_d * sizeof(float);
  // The attribute is the block's limit, not this launch's need: the tuner launches one
  // kernel at several tiles from several threads, and a per-launch value set by one
  // thread would refuse another thread's larger launch ("invalid argument").
  cudaError_t err = cudaFuncSetAttribute(lru_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(D / block_d, B);
  lru_kernel<T><<<grid, block_d, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<T*>(hs), static_cast<float*>(hT), T_len, D, chunk);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ RWKV-6
// Shared memory per block: five [chunk][HD] fp32 arrays (r, k, v, exp(lw), u*k).
template <typename T, int HD>
__global__ void __launch_bounds__(64)
rwkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ lw, const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ sT, int T_len, int H, int chunk) {
  extern __shared__ float rwkv_smem[];
  float* rs = rwkv_smem;
  float* ks = rs + chunk * HD;
  float* vs = ks + chunk * HD;
  float* ws = vs + chunk * HD;
  float* uks = ws + chunk * HD;
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const long long bh = static_cast<long long>(bi) * H + h;
  const float uj = u[h * HD + j];

  float S[HD];  // column j of the state
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0[(bh * HD + i) * HD + j];

  for (int t0 = 0; t0 < T_len; t0 += chunk) {
    for (int t = 0; t < chunk; ++t) {
      const long long off = ((static_cast<long long>(bi) * T_len + t0 + t) * H + h) * HD + j;
      const float kj = to_float(k[off]);
      rs[t * HD + j] = to_float(r[off]);
      ks[t * HD + j] = kj;
      vs[t * HD + j] = to_float(v[off]);
      ws[t * HD + j] = expf(lw[off]);
      uks[t * HD + j] = uj * kj;
    }
    __syncthreads();
    for (int t = 0; t < chunk; ++t) {
      const float vj = vs[t * HD + j];
      const float* rt = rs + t * HD;
      const float* kt = ks + t * HD;
      const float* wt = ws + t * HD;
      const float* ukt = uks + t * HD;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = kt[i] * vj;
        acc = fmaf(rt[i], fmaf(ukt[i], vj, S[i]), acc);
        S[i] = fmaf(wt[i], S[i], kv);
      }
      const long long off = ((static_cast<long long>(bi) * T_len + t0 + t) * H + h) * HD + j;
      y[off] = from_float<T>(acc);
    }
    __syncthreads();  // the next chunk's staging overwrites these rows
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) sT[(bh * HD + i) * HD + j] = S[i];
}

template <typename T, int HD>
int rwkv_launch_hd(const void* r, const void* k, const void* v, const void* lw, const void* u,
                   const void* s0, void* y, void* sT, int B, int T_len, int H, int chunk,
                   void* stream) {
  const size_t smem = 5 * static_cast<size_t>(chunk) * HD * sizeof(float);
  // The attribute is the block's limit, not this launch's need: the tuner launches one
  // kernel at several tiles from several threads, and a per-launch value set by one
  // thread would refuse another thread's larger launch ("invalid argument").
  cudaError_t err = cudaFuncSetAttribute(rwkv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B);
  rwkv_kernel<T, HD><<<grid, HD, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lw), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sT), T_len, H, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rwkv_launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
                const void* s0, void* y, void* sT, int B, int T_len, int H, int hd, int chunk,
                void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || chunk <= 0 || T_len % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 8: return rwkv_launch_hd<T, 8>(r, k, v, lw, u, s0, y, sT, B, T_len, H, chunk, stream);
    case 16: return rwkv_launch_hd<T, 16>(r, k, v, lw, u, s0, y, sT, B, T_len, H, chunk, stream);
    case 32: return rwkv_launch_hd<T, 32>(r, k, v, lw, u, s0, y, sT, B, T_len, H, chunk, stream);
    case 64: return rwkv_launch_hd<T, 64>(r, k, v, lw, u, s0, y, sT, B, T_len, H, chunk, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int repro_lru_scan_f32(const void* a, const void* b, const void* h0, void* hs, void* hT, int B,
                       int T, int D, int chunk, int block_d, void* stream) {
  return lru_launch<float>(a, b, h0, hs, hT, B, T, D, chunk, block_d, stream);
}

int repro_lru_scan_bf16(const void* a, const void* b, const void* h0, void* hs, void* hT, int B,
                        int T, int D, int chunk, int block_d, void* stream) {
  return lru_launch<__nv_bfloat16>(a, b, h0, hs, hT, B, T, D, chunk, block_d, stream);
}

int repro_rwkv_scan_f32(const void* r, const void* k, const void* v, const void* lw, const void* u,
                        const void* s0, void* y, void* sT, int B, int T, int H, int hd, int chunk,
                        void* stream) {
  return rwkv_launch<float>(r, k, v, lw, u, s0, y, sT, B, T, H, hd, chunk, stream);
}

int repro_rwkv_scan_bf16(const void* r, const void* k, const void* v, const void* lw,
                         const void* u, const void* s0, void* y, void* sT, int B, int T, int H,
                         int hd, int chunk, void* stream) {
  return rwkv_launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, sT, B, T, H, hd, chunk, stream);
}

const char* repro_linear_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
