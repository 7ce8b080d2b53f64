// Linear-recurrence scans for Hopper (sm_90a): RG-LRU and RWKV-6 WKV.
//
// Replace the JAX package's kernels/linear_scan.py::lru_scan_chunked and
// ::rwkv_scan_chunked (Pallas TPU, _lru_kernel and _rwkv_kernel).  There the
// time axis is a sequential grid dimension and the fp32 state stays in VMEM
// from one grid step to the next.  Blocks on a GPU run in no order: the
// rwkv block owns its whole time axis and loops over it itself, with the
// state in registers; the lru scan splits the time axis into segments and
// carries the state from one segment's block to the next through device
// memory (below).
//
// lru_scan: h_t = a_t * h_{t-1} + b_t, elementwise over (B, T, D): a
// segmented scan with a chained carry.  What bounds it: memory, three
// passes over (B, T, D) (a and b read, hs written once) against 2 FLOP per
// element.  A block per channel column walking all T steps alone (the TPU
// kernel's shape) gives 160 blocks at recurrentgemma-2b's prefill, about 5
// warps per SM with a few loads in flight each: bound by latency, not bytes.
// So T is split into `nseg` segments of whole `chunk`s, and each block owns
// (block_d channels of one batch row, one segment):
//  1. it stages the segment's a and b in shared memory in the input dtype,
//     one cp.async group per chunk (16-byte copies for fp32, 8-byte for
//     bf16: each thread owns 4 neighbouring channels), and scans them as
//     the chunks land: the running product P = prod a and the local state
//     hloc from 0 (segment 0 starts from h0 and writes hs right away);
//  2. it waits for the preceding segment's inclusive state (its carry),
//     publishes its own, fma(P, carry, hloc), for the next segment, and
//  3. rescans the staged segment from the carry, writing hs once.
// The carry is looked back one segment only: each segment waits for its
// predecessor's inclusive state instead of combining the aggregates of
// several.  That keeps the output bit-identical from run to run (a
// replayed tuning record must reproduce its kernel's output exactly), and
// the chain advances faster than blocks are dispatched.  Forward progress:
// a block takes its segment from an atomic ticket in launch order, segment
// after segment over all columns, so it only ever waits on blocks that
// already run.  The ticket and the flags are zeroed on the caller's stream
// before each launch.  Within a segment the recurrence is exact; only the
// carry reassociates the product (rounding of P over one segment).
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

#include <cstdint>

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
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most n of this thread's cp.async groups are pending.  The
// count must be an immediate, so n > 7 waits as for 7: more than needed,
// never less.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// CPT neighbouring channels of one row: global -> shared.  CPT = 4 is one
// cp.async of 16 (fp32) or 8 (bf16) bytes; CPT = 1 (misaligned views, or a
// channel count that is not a multiple of 4) a plain element copy.
template <typename T, int CPT>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  if constexpr (CPT == 4) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if constexpr (sizeof(T) == 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    *dst = *src;
  }
}

template <typename T, int CPT>
__device__ __forceinline__ void read_row(const T* p, float (&x)[CPT]) {
  if constexpr (CPT == 4 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (CPT == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    x[0] = __low2float(lo); x[1] = __high2float(lo); x[2] = __low2float(hi); x[3] = __high2float(hi);
  } else {
    x[0] = to_float(p[0]);
  }
}

template <typename T, int CPT>
__device__ __forceinline__ void write_row(T* p, const float (&h)[CPT]) {
  if constexpr (CPT == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(h[0], h[1], h[2], h[3]);
  } else if constexpr (CPT == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(h[0], h[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(h[2], h[3]);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = v;
  } else {
    p[0] = from_float<T>(h[0]);
  }
}

// One block per (column, segment), block_d / CPT threads, CPT channels
// each.  A column is (batch row, channel block); ticket t is segment
// t / ncols of column t % ncols.  flags[0] is the ticket counter, flags[1 + t]
// says that carry[t * block_d ...] holds segment t's inclusive state.
// Shared memory: the ticket (16 bytes), then a and b of the segment,
// [rows][block_d] each, in the input dtype.
// Every thread stages and reads only its own channels, so no barrier sits
// between the copies and the scans.
template <typename T, int CPT>
__global__ void __launch_bounds__(1024)
lru_segment_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
                   T* __restrict__ hs, float* __restrict__ hT, int* __restrict__ flags,
                   float* __restrict__ carry, int T_len, int D, int bd, int chunk, int rows,
                   int nseg, int ncols) {
  extern __shared__ __align__(16) unsigned char lru_smem[];
  int* ticket_s = reinterpret_cast<int*>(lru_smem);  // 16 bytes, then the tiles
  T* as = reinterpret_cast<T*>(lru_smem + 16);
  T* bs = as + static_cast<size_t>(rows) * bd;
  if (threadIdx.x == 0) *ticket_s = atomicAdd(flags, 1);
  __syncthreads();
  const int ticket = *ticket_s;
  const int seg = ticket / ncols, col = ticket % ncols;
  const int nblk = D / bd;
  const int bi = col / nblk;
  const int lc = CPT * threadIdx.x;               // first channel of this thread in the block
  const int ch = (col % nblk) * bd + lc;          // ... and in the row
  const long long base = (static_cast<long long>(bi) * T_len + static_cast<long long>(seg) * rows) * D + ch;

  const int nch = rows / chunk;
  for (int c = 0; c < nch; ++c) {
    for (int r = c * chunk; r < (c + 1) * chunk; ++r) {
      stage<T, CPT>(as + r * bd + lc, a + base + static_cast<long long>(r) * D);
      stage<T, CPT>(bs + r * bd + lc, b + base + static_cast<long long>(r) * D);
    }
    cp_async_commit();
  }

  float h[CPT], P[CPT], av[CPT], bv[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    h[i] = seg == 0 ? h0[static_cast<long long>(bi) * D + ch + i] : 0.f;
    P[i] = 1.f;
  }
  // pass 1, chunk by chunk as the copies land: segment 0 is exact from h0
  // and writes hs; every other segment forms (P, hloc)
  for (int c = 0; c < nch; ++c) {
    cp_async_wait_upto(nch - 1 - c);
    for (int r = c * chunk; r < (c + 1) * chunk; ++r) {
      read_row<T, CPT>(as + r * bd + lc, av);
      read_row<T, CPT>(bs + r * bd + lc, bv);
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        P[i] *= av[i];
        h[i] = fmaf(av[i], h[i], bv[i]);
      }
      if (seg == 0) write_row<T, CPT>(hs + base + static_cast<long long>(r) * D, h);
    }
  }

  float* mine = carry + static_cast<long long>(ticket) * bd + lc;
  if (seg > 0) {
    // the predecessor's inclusive state; its block took an earlier ticket,
    // so it runs (or ran) and never waits on this one
    const float* prev = carry + static_cast<long long>(ticket - ncols) * bd + lc;
    const int* f = flags + 1 + (ticket - ncols);
    for (unsigned n = 0; ld_acquire(f) == 0; ++n) {
      if (n > (1u << 26)) __trap();  // a lost carry: fail, don't hang the card
      __nanosleep(64);
    }
    float cin[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) cin[i] = __ldcg(prev + i);
    if (seg < nseg - 1) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) mine[i] = fmaf(P[i], cin[i], h[i]);
    }
    // pass 2: the exact recurrence from the carry, hs written once
#pragma unroll
    for (int i = 0; i < CPT; ++i) h[i] = cin[i];
    if (seg < nseg - 1) {
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) st_release(flags + 1 + ticket, 1);
    }
    for (int r = 0; r < rows; ++r) {
      read_row<T, CPT>(as + r * bd + lc, av);
      read_row<T, CPT>(bs + r * bd + lc, bv);
#pragma unroll
      for (int i = 0; i < CPT; ++i) h[i] = fmaf(av[i], h[i], bv[i]);
      write_row<T, CPT>(hs + base + static_cast<long long>(r) * D, h);
    }
  } else if (nseg > 1) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) mine[i] = h[i];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(flags + 1 + ticket, 1);
  }
  if (seg == nseg - 1) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) hT[static_cast<long long>(bi) * D + ch + i] = h[i];
  }
}

template <typename T>
int lru_launch(const void* a, const void* b, const void* h0, void* hs, void* hT, void* flags,
               void* carry, int B, int T_len, int D, int chunk, int block_d, int nseg, int cpt,
               void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0 || chunk <= 0 || block_d <= 0 || block_d > 1024 ||
      nseg <= 0 || T_len % chunk || D % block_d || (T_len / chunk) % nseg ||
      (cpt != 1 && cpt != 4) || block_d % cpt)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = T_len / nseg;
  const int ncols = B * (D / block_d);
  const size_t smem = 16 + 2 * static_cast<size_t>(rows) * block_d * sizeof(T);
  if (smem > static_cast<size_t>(BLOCK_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flags, 0, (1 + static_cast<size_t>(ncols) * nseg) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The attribute is the block's limit, not this launch's need: the tuner launches one
  // kernel at several tiles from several threads, and a per-launch value set by one
  // thread would refuse another thread's larger launch ("invalid argument").
  auto kernel = cpt == 4 ? lru_segment_kernel<T, 4> : lru_segment_kernel<T, 1>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<ncols * nseg, block_d / cpt, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<T*>(hs), static_cast<float*>(hT), static_cast<int*>(flags),
      static_cast<float*>(carry), T_len, D, block_d, chunk, rows, nseg, ncols);
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

// flags: 1 + B * (D / block_d) * nseg int32 (zeroed here, on the stream);
// carry: B * (D / block_d) * nseg * block_d fp32.  cpt: channels per thread,
// 4 (a, b and hs on 4-element boundaries, D and block_d multiples of 4) or 1.
int repro_lru_scan_f32(const void* a, const void* b, const void* h0, void* hs, void* hT,
                       void* flags, void* carry, int B, int T, int D, int chunk, int block_d,
                       int nseg, int cpt, void* stream) {
  return lru_launch<float>(a, b, h0, hs, hT, flags, carry, B, T, D, chunk, block_d, nseg, cpt,
                           stream);
}

int repro_lru_scan_bf16(const void* a, const void* b, const void* h0, void* hs, void* hT,
                        void* flags, void* carry, int B, int T, int D, int chunk, int block_d,
                        int nseg, int cpt, void* stream) {
  return lru_launch<__nv_bfloat16>(a, b, h0, hs, hT, flags, carry, B, T, D, chunk, block_d, nseg,
                                   cpt, stream);
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
