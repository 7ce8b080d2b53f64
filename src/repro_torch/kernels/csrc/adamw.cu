// AdamW for Hopper (sm_90a) over a whole tree of leaves at once: one pass
// for the global gradient norm, a one-block finish, and one update pass.
//
// Replaces no Pallas kernel.  It is the port's counterpart of XLA's fusion
// of the JAX package's repro/optim elementwise chain under jit (global-norm
// clip, then AdamW with bias correction and weight decay inside the step),
// which the eager port had run as some twenty fp32 passes a leaf.
//
// What bounds it: bytes.  The norm reads every gradient once (4 B a
// parameter in fp32); the update reads g, p, m and v and writes p, m and v
// (28 B): 32 B a parameter, a few FLOP each.  What the design does about it:
//  * Work list.  Every leaf is cut into CHUNK-element chunks, numbered
//    leaf after leaf, so thousands of chunks of the large leaves and one
//    chunk of each small leaf fill the SMs alike.  One table describes the
//    leaves (p, m, v and g pointers, length, dtype code, number of the first
//    chunk), uploaded each step (the gradients are new every step); a block
//    finds its chunk's leaf by binary search in it (a few KB, in cache), so
//    no per-chunk table holds device memory and nothing stays allocated
//    between steps.
//  * Norm pass.  A fixed grid: block b takes chunks b, b + grid, ... (its
//    leaf searched again only when a chunk lies past it); each thread
//    squares 8 neighbouring elements in fp32, sums them in order and
//    adds the sum to a double (4.3e9 squares would lose digits in an fp32
//    running sum); the block reduces in a fixed order and writes one
//    partial.  No atomics: the norm repeats bit for bit from run to run.
//  * Finish.  One block sums the partials in a fixed order and writes the
//    norm and the clip scale to two device floats; nothing goes to the host.
//  * Update pass.  One block per chunk.  Where p, g, m and v all start on
//    16-byte boundaries, each thread moves 8 elements per operand with
//    16-byte loads and stores (two for fp32, one for bf16); a leaf's ragged
//    end, and a leaf that is not so aligned, take element loads.
//  * Arithmetic.  fp32, in the order of the eager loop it replaces, with
//    round-to-nearest intrinsics so that nothing is contracted into an FMA:
//    given the same scale the update has the bits of PyTorch's eager passes.
//    The clipped gradient is rounded to g's dtype, as the loop's in-place
//    clip stores it, but it is not written back.  p, m and v are stored in
//    their own dtypes (fp32 or bf16, independently per leaf).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;               // elements a thread moves per step of the vector path
constexpr long long CHUNK = 16384;   // elements per work item (adamw.CHUNK)
constexpr int LEAF_WORDS = 7;        // p, m, v, length, dtype code, first chunk, g (adamw.LEAF_WORDS)
constexpr int FINISH_THREADS = 1024; // the finish block; at most this many partials
constexpr int P_BF16 = 1, G_BF16 = 2, S_BF16 = 4;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// 8 neighbouring elements at a 16-byte boundary, to fp32 and back
__device__ __forceinline__ void load8(const float* p, float (&x)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[VEC]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[VEC]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = bf16_bits(x[2 * i]) | (bf16_bits(x[2 * i + 1]) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the leaf of chunk c among the nleaves leaves from ``leaves`` on: the last
// whose first chunk is at most c (a leaf of no elements has no chunk and is
// never found)
__device__ __forceinline__ const long long* leaf_of(const long long* __restrict__ leaves, int nleaves,
                                                    long long c) {
  int lo = 0, hi = nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[static_cast<long long>(mid) * LEAF_WORDS + 5] <= c) lo = mid;
    else hi = mid - 1;
  }
  return leaves + static_cast<long long>(lo) * LEAF_WORDS;
}

// the sum over the block, in a fixed order (valid in thread 0)
template <int NT>
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) t += warp_sums[w];
  return t;
}

// this thread's squares of g[start, end)
template <typename G>
__device__ __forceinline__ double chunk_sumsq(const G* g, long long start, long long end) {
  double acc = 0.0;
  long long tail = start;
  if (aligned16(g)) {
    tail = start + (end - start) / VEC * VEC;
    for (long long i = start + threadIdx.x * VEC; i < tail; i += THREADS * VEC) {
      float x[VEC];
      load8(g + i, x);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) s = __fadd_rn(s, __fmul_rn(x[k], x[k]));
      acc += static_cast<double>(s);
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += THREADS) {
    const float x = to_f(g[i]);
    acc += static_cast<double>(__fmul_rn(x, x));
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
norm_kernel(const long long* __restrict__ leaves, int nleaves, int nchunks,
            double* __restrict__ partials) {
  double acc = 0.0;
  const long long* last = leaves + static_cast<long long>(nleaves - 1) * LEAF_WORDS;
  const long long* leaf = leaves;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x) {
    if (leaf < last && leaf[LEAF_WORDS + 5] <= c)  // past this leaf: search the leaves after it
      leaf = leaf_of(leaf, static_cast<int>((last - leaf) / LEAF_WORDS) + 1, c);
    const long long start = (c - leaf[5]) * CHUNK;
    const long long end = min(start + CHUNK, leaf[3]);
    const void* g = reinterpret_cast<const void*>(leaf[6]);
    acc += (leaf[4] & G_BF16) ? chunk_sumsq(static_cast<const __nv_bfloat16*>(g), start, end)
                              : chunk_sumsq(static_cast<const float*>(g), start, end);
  }
  const double total = block_sum<THREADS>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// out[0] = the global norm, out[1] = the clip scale: min(1, clip / (norm +
// 1e-12)) as the loop's torch.clamp(clip / (norm + 1e-12), max=1) computes
// it (a Python number over a tensor is the tensor's reciprocal times the
// number); 1 without clipping (clip <= 0)
__global__ void __launch_bounds__(FINISH_THREADS)
finish_kernel(const double* __restrict__ partials, int nparts, float clip, float* __restrict__ out) {
  double v = 0.0;
  for (int i = threadIdx.x; i < nparts; i += FINISH_THREADS) v += partials[i];
  const double total = block_sum<FINISH_THREADS>(v);
  if (threadIdx.x == 0) {
    const float norm = static_cast<float>(sqrt(total));
    float scale = 1.f;
    if (clip > 0.f) {
      const float r = __fmul_rn(__frcp_rn(__fadd_rn(norm, 1e-12f)), clip);
      scale = r > 1.f ? 1.f : r;  // a NaN passes, as through torch.clamp
    }
    out[0] = norm;
    out[1] = scale;
  }
}

// one element, in the eager loop's order:
//   g *= scale (rounded to g's dtype); m = b1 m + (1 - b1) g;
//   v = b2 v + (1 - b2) g^2; u = (m / c1) / (sqrt(v / c2) + eps);
//   u += wd p; p -= lr u
template <typename G>
__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v, const Hyper& h,
                                          float scale, float lr, float c1, float c2) {
  g = to_f(from_f<G>(__fmul_rn(g, scale)));
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(m, c1), denom);
  u = __fadd_rn(u, __fmul_rn(p, h.wd));
  u = __fmul_rn(u, lr);
  p = __fsub_rn(p, u);
}

template <typename P, typename G, typename S>
__device__ __forceinline__ void update_chunk(const long long* leaf, const void* gp, long long start,
                                             const Hyper& h, float scale, float lr, float c1,
                                             float c2) {
  P* p = reinterpret_cast<P*>(leaf[0]);
  S* m = reinterpret_cast<S*>(leaf[1]);
  S* v = reinterpret_cast<S*>(leaf[2]);
  const G* g = static_cast<const G*>(gp);
  const long long end = min(start + CHUNK, leaf[3]);
  long long tail = start;
  if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v)) {
    tail = start + (end - start) / VEC * VEC;
    for (long long i = start + threadIdx.x * VEC; i < tail; i += THREADS * VEC) {
      float pf[VEC], gf[VEC], mf[VEC], vf[VEC];
      load8(g + i, gf);
      load8(p + i, pf);
      load8(m + i, mf);
      load8(v + i, vf);
#pragma unroll
      for (int k = 0; k < VEC; ++k) adam_elem<G>(pf[k], gf[k], mf[k], vf[k], h, scale, lr, c1, c2);
      store8(p + i, pf);
      store8(m + i, mf);
      store8(v + i, vf);
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += THREADS) {
    float pf = to_f(p[i]), mf = to_f(m[i]), vf = to_f(v[i]);
    adam_elem<G>(pf, to_f(g[i]), mf, vf, h, scale, lr, c1, c2);
    p[i] = from_f<P>(pf);
    m[i] = from_f<S>(mf);
    v[i] = from_f<S>(vf);
  }
}

__global__ void __launch_bounds__(THREADS)
update_kernel(const long long* __restrict__ leaves, int nleaves,
              const float* __restrict__ norm_scale, const float* __restrict__ lr_p,
              const float* __restrict__ c1_p, const float* __restrict__ c2_p, Hyper h) {
  const long long* leaf = leaf_of(leaves, nleaves, blockIdx.x);
  const void* g = reinterpret_cast<const void*>(leaf[6]);
  const long long start = (blockIdx.x - leaf[5]) * CHUNK;
  const float scale = norm_scale[1], lr = *lr_p, c1 = *c1_p, c2 = *c2_p;
  typedef __nv_bfloat16 bf;
  switch (static_cast<int>(leaf[4])) {
    case 0: update_chunk<float, float, float>(leaf, g, start, h, scale, lr, c1, c2); break;
    case P_BF16: update_chunk<bf, float, float>(leaf, g, start, h, scale, lr, c1, c2); break;
    case G_BF16: update_chunk<float, bf, float>(leaf, g, start, h, scale, lr, c1, c2); break;
    case P_BF16 | G_BF16: update_chunk<bf, bf, float>(leaf, g, start, h, scale, lr, c1, c2); break;
    case S_BF16: update_chunk<float, float, bf>(leaf, g, start, h, scale, lr, c1, c2); break;
    case P_BF16 | S_BF16: update_chunk<bf, float, bf>(leaf, g, start, h, scale, lr, c1, c2); break;
    case G_BF16 | S_BF16: update_chunk<float, bf, bf>(leaf, g, start, h, scale, lr, c1, c2); break;
    default: update_chunk<bf, bf, bf>(leaf, g, start, h, scale, lr, c1, c2); break;
  }
}

}  // namespace

extern "C" {

// leaves: nleaves x LEAF_WORDS int64 (p, m, v pointers, length, dtype code:
// 1 p bf16, 2 g bf16, 4 m and v bf16; first chunk, the chunks numbered leaf
// after leaf; g pointer); nchunks: the chunks of all leaves; partials:
// norm_blocks doubles of scratch (1 <= norm_blocks <= 1024); out: two
// floats (norm, scale); lr, c1, c2: device floats.  Three launches on
// ``stream`` (two when there are no chunks); no host synchronisation.
int repro_adamw(const void* leaves, int nleaves, int nchunks, void* partials, int norm_blocks,
                void* out, const void* lr, const void* c1, const void* c2, float clip, float b1,
                float omb1, float b2, float omb2, float eps, float wd, void* stream) {
  if (nleaves < 1 || nchunks < 0 || norm_blocks < 1 || norm_blocks > FINISH_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* lv = static_cast<const long long*>(leaves);
  double* parts = static_cast<double*>(partials);
  float* ns = static_cast<float*>(out);
  norm_kernel<<<norm_blocks, THREADS, 0, s>>>(lv, nleaves, nchunks, parts);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  finish_kernel<<<1, FINISH_THREADS, 0, s>>>(parts, norm_blocks, clip, ns);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || nchunks == 0) return rc;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  update_kernel<<<nchunks, THREADS, 0, s>>>(lv, nleaves, ns, static_cast<const float*>(lr),
                                            static_cast<const float*>(c1),
                                            static_cast<const float*>(c2), h);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
