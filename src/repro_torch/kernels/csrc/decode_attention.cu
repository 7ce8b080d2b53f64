// Flash-decode for Hopper (sm_90a): one query token per head against a KV
// cache, with a masked online softmax over block_kv tiles.
//
// Replaces the JAX package's kernels/decode_attention.py::decode_attention_fwd
// (Pallas TPU, _kernel).  There the grid is (B, Kh, n_kv) with the KV tiles a
// sequential axis and the (m, l, acc) carry in VMEM scratch; here one thread
// block owns one (KV head, batch row) and walks the tiles itself.  The
// arithmetic is the TPU kernel's: q is cast to fp32 and scaled by 1/sqrt(hd)
// before the dot, a slot whose valid entry is not > 0 gets the finite -1e30
// (not -inf: a tile with no valid slot then gives p = exp(0) = 1, so a row
// with no valid slot averages V as the oracle's uniform softmax does, and a
// masked leading tile is wiped later when alpha = exp(-1e30 - m) reaches 0),
// m/l/acc are fp32, and the output is written in q's dtype.  GQA: the g =
// H / Kh query heads kvh*g .. kvh*g+g-1 share KV head kvh.
//
// Per tile, in three phases separated by __syncthreads:
//  1. scores: warp w takes slots w, w+16, ...; its lanes read the slot's K
//     row (lane + 32i, coalesced) once and form the dot with each of the g
//     scaled query rows held in shared memory, reduced across the warp with
//     shuffles, into an fp32 score tile S[g][block_kv] in shared memory;
//  2. softmax: one warp per head takes the tile's max, m_new, alpha and
//     p = exp(s - m_new) (written over s) and updates m and l;
//  3. P V: thread t owns column d = t % hd of slot phase r = t / hd (R =
//     512 / hd phases, each summing the slots c = r (mod R)), holds the
//     accumulators of up to GC heads in registers, rescales them by alpha
//     and adds p * v[c][d] for its slots.  The R partial sums are kept
//     apart in shared memory and added in order after the last tile (each
//     was scaled by the same alphas, so their sum is the carry).
// K and V are never staged whole, so block_kv is bounded only by the score
// tile in shared memory: the wrapper refuses tiles over 227 KB before launch.
//
// What bounds it: decode reads every cache byte once for 4*hd*g/(2*hd*2)
// FLOP per byte (a few), so it is memory-bound on the card.  This simple
// kernel has B*Kh blocks (32 at qwen2-7b batch 8) on 132 SMs, each holding
// few loads in flight, and reaches a small share of the bandwidth; splitting
// the cache across blocks (split-KV) is later work.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success.  Strides are in elements; the last dim is contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_SMEM = 232448;  // shared memory one block may use on Hopper (227 KB)

constexpr int NT = 512;  // threads per block
constexpr int NW = NT / 32;
constexpr int KMAX = 8;  // K elements per lane: hd <= 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

struct Strides {
  long long qb, qh, kb, kh, ks, vb, vh, vs, validb;
};

template <typename T, int GC>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ valid, T* __restrict__ o, int H, int g, int S, int hd,
              Strides st, int block_kv, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [g][hd], scaled fp32
  float* Ss = Qs + g * hd;               // [g][block_kv]: scores, then p
  float* Ms = Ss + g * block_kv;         // [g] running max
  float* Ls = Ms + g;                    // [g] running sum
  float* As = Ls + g;                    // [g] this tile's alpha
  float* Acc = As + g;                   // [g][NT]: per-thread partial acc

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.x;
  const int bb = blockIdx.y;
  const int R = NT / hd;  // slot phases of the P V step
  const int r = tid / hd;
  const int d = tid % hd;
  const int nk = (hd + 31) / 32;

  const T* qb = q + bb * st.qb + static_cast<long long>(kvh) * g * st.qh;
  const T* kb = k + bb * st.kb + kvh * st.kh;
  const T* vb = v + bb * st.vb + kvh * st.vh;
  const int* validb = valid + bb * st.validb;

  for (int idx = tid; idx < g * hd; idx += NT) {
    const int j = idx / hd, dd = idx % hd;
    Qs[idx] = to_float(qb[j * st.qh + dd]) * scale;
  }
  for (int j = tid; j < g; j += NT) {
    Ms[j] = NEG_INF;
    Ls[j] = 0.f;
  }
  for (int idx = tid; idx < g * NT; idx += NT) Acc[idx] = 0.f;
  __syncthreads();

  for (int kv0 = 0; kv0 < S; kv0 += block_kv) {
    // 1. scores of every head of the group for this tile's slots
    for (int c = warp; c < block_kv; c += NW) {
      const T* krow = kb + (kv0 + c) * st.ks;
      float kr[KMAX];
#pragma unroll
      for (int i = 0; i < KMAX; ++i)
        kr[i] = (i < nk && i * 32 + lane < hd) ? to_float(krow[i * 32 + lane]) : 0.f;
      const bool ok = validb[kv0 + c] > 0;
      for (int j = 0; j < g; ++j) {
        const float* qr = Qs + j * hd;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < KMAX; ++i)
          if (i < nk && i * 32 + lane < hd) s = fmaf(qr[i * 32 + lane], kr[i], s);
        s = warp_sum(s);
        if (lane == 0) Ss[j * block_kv + c] = ok ? s : NEG_INF;
      }
    }
    __syncthreads();

    // 2. online softmax update, one warp per head
    for (int j = warp; j < g; j += NW) {
      float* srow = Ss + j * block_kv;
      float mx = NEG_INF;
      for (int c = lane; c < block_kv; c += 32) mx = fmaxf(mx, srow[c]);
      mx = warp_max(mx);
      const float m_prev = Ms[j];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < block_kv; c += 32) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        As[j] = alpha;
        Ls[j] = Ls[j] * alpha + sum;
        Ms[j] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + p v over this thread's column and slot phase
    for (int j0 = 0; j0 < g; j0 += GC) {
      float acc[GC];
#pragma unroll
      for (int jj = 0; jj < GC; ++jj)
        acc[jj] = (j0 + jj < g) ? Acc[(j0 + jj) * NT + tid] * As[j0 + jj] : 0.f;
      const T* vcol = vb + kv0 * st.vs + d;
#pragma unroll 4
      for (int c = r; c < block_kv; c += R) {
        const float vv = to_float(vcol[c * st.vs]);
#pragma unroll
        for (int jj = 0; jj < GC; ++jj)
          if (j0 + jj < g) acc[jj] = fmaf(Ss[(j0 + jj) * block_kv + c], vv, acc[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < GC; ++jj)
        if (j0 + jj < g) Acc[(j0 + jj) * NT + tid] = acc[jj];
    }
    __syncthreads();  // the next tile overwrites Ss
  }

  // sum the slot phases in order and normalize; rows with l == 0 give 0
  T* ob = o + (static_cast<long long>(bb) * H + static_cast<long long>(kvh) * g) * hd;
  for (int idx = tid; idx < g * hd; idx += NT) {
    const int j = idx / hd, dd = idx % hd;
    float a = 0.f;
    for (int rr = 0; rr < R; ++rr) a += Acc[j * NT + rr * hd + dd];
    const float l = Ls[j] == 0.f ? 1.f : Ls[j];
    ob[idx] = from_float<T>(a / l);
  }
}

size_t smem_bytes(int g, int hd, int block_kv) {
  return sizeof(float) * (static_cast<size_t>(g) * hd + static_cast<size_t>(g) * block_kv +
                          3 * static_cast<size_t>(g) + static_cast<size_t>(g) * NT);
}

template <typename T, int GC>
int launch_gc(const void* q, const void* k, const void* v, const int* valid, void* o, int B, int H,
              int Kh, int S, int hd, const Strides& st, int block_kv, float scale, void* stream) {
  const int g = H / Kh;
  const size_t smem = smem_bytes(g, hd, block_kv);
  // The attribute is the block's limit, not this launch's need: the tuner launches one
  // kernel at several tiles from several threads, and a per-launch value set by one
  // thread would refuse another thread's larger launch ("invalid argument").
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, GC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Kh, B);
  decode_kernel<T, GC><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid,
      static_cast<T*>(o), H, g, S, hd, st, block_kv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* o, int B, int H,
           int Kh, int S, int hd, const long long* strides, int block_kv, float scale,
           void* stream) {
  if (block_kv <= 0 || S % block_kv || Kh <= 0 || H % Kh || hd < 16 || hd > 256 || NT % hd)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  const int* vd = static_cast<const int*>(valid);
  const int g = H / Kh;
  // the smallest register group of heads that holds the whole GQA group
  // (groups of more than 16 heads take several passes over V per tile)
  if (g <= 1) return launch_gc<T, 1>(q, k, v, vd, o, B, H, Kh, S, hd, st, block_kv, scale, stream);
  if (g <= 2) return launch_gc<T, 2>(q, k, v, vd, o, B, H, Kh, S, hd, st, block_kv, scale, stream);
  if (g <= 4) return launch_gc<T, 4>(q, k, v, vd, o, B, H, Kh, S, hd, st, block_kv, scale, stream);
  if (g <= 8) return launch_gc<T, 8>(q, k, v, vd, o, B, H, Kh, S, hd, st, block_kv, scale, stream);
  return launch_gc<T, 16>(q, k, v, vd, o, B, H, Kh, S, hd, st, block_kv, scale, stream);
}

}  // namespace

extern "C" {

// strides: 9 int64 values: q (batch, head), k (batch, head, slot),
// v (batch, head, slot), valid (batch).  o is contiguous (B, H, hd).
int repro_decode_attention_f32(const void* q, const void* k, const void* v, const void* valid,
                               void* o, int B, int H, int Kh, int S, int hd,
                               const long long* strides, int block_kv, float scale, void* stream) {
  return launch<float>(q, k, v, valid, o, B, H, Kh, S, hd, strides, block_kv, scale, stream);
}

int repro_decode_attention_bf16(const void* q, const void* k, const void* v, const void* valid,
                                void* o, int B, int H, int Kh, int S, int hd,
                                const long long* strides, int block_kv, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, valid, o, B, H, Kh, S, hd, strides, block_kv, scale,
                               stream);
}

const char* repro_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
