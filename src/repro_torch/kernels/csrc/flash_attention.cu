// Flash-attention forward for Hopper (sm_90a): online softmax over KV tiles.
//
// Replaces the JAX package's kernels/flash_attention.py::flash_attention_fwd
// (Pallas TPU, _kernel).  There the KV tiles are a sequential grid axis and
// the (m, l, acc) carry persists in VMEM scratch between grid steps; here one
// thread block owns one (batch, query head, query tile) and loops over the
// KV tiles itself.  The arithmetic is the TPU kernel's: q is cast to fp32
// and scaled by 1/sqrt(hd) before the dot, the m/l/acc carry is fp32,
// causal masking keeps qi >= kj (aligned top-left) with -1e30 in masked
// slots, KV tiles wholly in the future are skipped, and rows whose l is 0
// give 0.  GQA: query head h reads KV head h / (H / Kh).  When lse is not
// null the block also writes each row's logsumexp of the scaled scores,
// m + log l (+inf where l is 0), which the backward (flash_attention_bwd.cu)
// recomputes P from.
//
// Layout: 8 threads per query row (block_q * 8 threads).  Thread t8 of row
// r keeps acc[r][t8 + 8j] (hd/8 fp32 values) and a copy of the row's m and
// l in registers.  Per KV tile the block stages K (one padding word per row,
// so the 8 rows a warp reads at once fall on different banks) and V in
// shared memory, computes its row's scores for columns t8 + 8i into a shared
// S tile, reduces the row max and row sum across the 8 threads with warp
// shuffles, rescales acc by alpha and accumulates P V into it.
//
// What bounds it: causal prefill at long sequence and head dim 128 does
// about 2*hd FLOP per byte of q/k/v/o it must move, so it is compute-bound
// on the card; this simple kernel does its FMAs on the CUDA cores out of
// shared memory and runs far below the tensor-core peak.  Tiles the design
// cannot run (block_q > 128, shared memory over the per-block limit) are
// refused by the Python wrapper before launch.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success.  Strides are in elements; the last dim is contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_SMEM = 232448;  // shared memory one block may use on Hopper (227 KB)

constexpr int TPR = 8;  // threads per query row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __host__ __device__ constexpr int k_pad() { return sizeof(T) == 2 ? 2 : 1; }

struct Strides {
  long long b, h, s;
};

template <typename T, int HD>
__global__ void __launch_bounds__(1024)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, float* __restrict__ lse, int H, int Kh, int Skv, Strides qs, Strides ks, Strides vs,
             Strides os, int block_q, int block_kv, int causal, float scale) {
  constexpr int ACC = HD / TPR;
  constexpr int LDQ = HD + 1;
  constexpr int LDK = HD + k_pad<T>();
  extern __shared__ unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [block_q][LDQ], scaled fp32
  float* Ss = Qs + block_q * LDQ;                  // [block_q][block_kv + 1]
  T* Ks = reinterpret_cast<T*>(Ss + block_q * (block_kv + 1));  // [block_kv][LDK]
  T* Vs = Ks + block_kv * LDK;                                  // [block_kv][HD]
  const int lds = block_kv + 1;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int r = tid / TPR;
  const int t8 = tid % TPR;
  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int q_start = iq * block_q;

  const T* qb = q + bb * qs.b + h * qs.h;
  const T* kb = k + bb * ks.b + kvh * ks.h;
  const T* vb = v + bb * vs.b + kvh * vs.h;
  T* ob = o + bb * os.b + h * os.h;

  for (int idx = tid; idx < block_q * HD; idx += nthreads) {
    const int rr = idx / HD, d = idx % HD;
    Qs[rr * LDQ + d] = to_float(qb[(q_start + rr) * qs.s + d]) * scale;
  }

  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;
  // lanes of this warp that exist (a block of 8 or 16 threads is one partial warp)
  const int warp_lanes = min(32, nthreads - (tid & ~31));
  const unsigned mask = warp_lanes == 32 ? 0xffffffffu : ((1u << warp_lanes) - 1u);

  const int n_kv = Skv / block_kv;
  for (int ikv = 0; ikv < n_kv; ++ikv) {
    const int kv_start = ikv * block_kv;
    if (causal && kv_start > q_start + block_q - 1) break;  // tile wholly in the future
    __syncthreads();  // previous tile's K/V/S reads are done (and Qs is staged)
    for (int idx = tid; idx < block_kv * HD; idx += nthreads) {
      const int c = idx / HD, d = idx % HD;
      Ks[c * LDK + d] = kb[(kv_start + c) * ks.s + d];
      Vs[idx] = vb[(kv_start + c) * vs.s + d];
    }
    __syncthreads();

    // scores for columns t8 + 8i of row r, and their max
    const float* qrow = Qs + r * LDQ;
    float* srow = Ss + r * lds;
    float rmax = NEG_INF;
    for (int c = t8; c < block_kv; c += TPR) {
      const T* krow = Ks + c * LDK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qrow[d], to_float(krow[d]), s);
      if (causal && q_start + r < kv_start + c) s = NEG_INF;
      srow[c] = s;
      rmax = fmaxf(rmax, s);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off /= 2) rmax = fmaxf(rmax, __shfl_xor_sync(mask, rmax, off));
    const float m_new = fmaxf(m, rmax);
    const float alpha = expf(m - m_new);
    float rsum = 0.f;
    for (int c = t8; c < block_kv; c += TPR) {
      const float p = expf(srow[c] - m_new);
      srow[c] = p;
      rsum += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off /= 2) rsum += __shfl_xor_sync(mask, rsum, off);
    l = l * alpha + rsum;
    m = m_new;
    __syncwarp(mask);  // the row's 8 threads (one warp) read each other's p below

#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] *= alpha;
    for (int c = 0; c < block_kv; ++c) {
      const float p = srow[c];
      const T* vrow = Vs + c * HD + t8;
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[j] = fmaf(p, to_float(vrow[TPR * j]), acc[j]);
    }
  }

  const float denom = l == 0.f ? 1.f : l;  // fully masked rows give 0
  if (lse != nullptr && t8 == 0)
    lse[(static_cast<long long>(bb) * H + h) * (gridDim.x * block_q) + q_start + r] =
        l == 0.f ? __int_as_float(0x7f800000) : m + logf(l);
  T* orow = ob + (q_start + r) * os.s;
#pragma unroll
  for (int j = 0; j < ACC; ++j) orow[t8 + TPR * j] = from_float<T>(acc[j] / denom);
}

template <typename T>
size_t smem_bytes(int hd, int block_q, int block_kv) {
  return sizeof(float) * (static_cast<size_t>(block_q) * (hd + 1) + static_cast<size_t>(block_q) * (block_kv + 1)) +
         sizeof(T) * (static_cast<size_t>(block_kv) * (hd + k_pad<T>()) + static_cast<size_t>(block_kv) * hd);
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Kh, int Sq,
              int Skv, Strides qs, Strides ks, Strides vs, Strides os, int block_q, int block_kv,
              int causal, float scale, void* stream) {
  const size_t smem = smem_bytes<T>(HD, block_q, block_kv);
  // The attribute is the block's limit, not this launch's need: the tuner launches one
  // kernel at several tiles from several threads, and a per-launch value set by one
  // thread would refuse another thread's larger launch ("invalid argument").
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Sq / block_q, H, B);
  dim3 block(block_q * TPR);
  flash_kernel<T, HD><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      lse, H, Kh, Skv, qs, ks, vs, os, block_q, block_kv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Kh, int Sq,
           int Skv, int hd, const long long* strides, int block_q, int block_kv, int causal,
           float scale, void* stream) {
  if (block_q <= 0 || block_kv <= 0 || Sq % block_q || Skv % block_kv || Kh <= 0 || H % Kh ||
      block_q * TPR > 1024 || block_kv % TPR)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{strides[0], strides[1], strides[2]}, ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]}, os{strides[9], strides[10], strides[11]};
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, o, lse, B, H, Kh, Sq, Skv, qs, ks, vs, os, block_q, block_kv, causal, scale, stream);
    case 32: return launch_hd<T, 32>(q, k, v, o, lse, B, H, Kh, Sq, Skv, qs, ks, vs, os, block_q, block_kv, causal, scale, stream);
    case 64: return launch_hd<T, 64>(q, k, v, o, lse, B, H, Kh, Sq, Skv, qs, ks, vs, os, block_q, block_kv, causal, scale, stream);
    case 128: return launch_hd<T, 128>(q, k, v, o, lse, B, H, Kh, Sq, Skv, qs, ks, vs, os, block_q, block_kv, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// strides: 12 int64 values, (batch, head, seq) for q, k, v and o in turn.
// lse: (B, H, Sq) fp32, written when not null.
int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                              int Kh, int Sq, int Skv, int hd, const long long* strides,
                              int block_q, int block_kv, int causal, float scale, void* stream) {
  return launch<float>(q, k, v, o, lse, B, H, Kh, Sq, Skv, hd, strides, block_q, block_kv, causal, scale, stream);
}

int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                               int Kh, int Sq, int Skv, int hd, const long long* strides,
                               int block_q, int block_kv, int causal, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, B, H, Kh, Sq, Skv, hd, strides, block_q, block_kv, causal,
                               scale, stream);
}

const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
