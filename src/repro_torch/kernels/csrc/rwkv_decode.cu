// RWKV-6's decode step (one token a sequence) for Hopper (sm_90a): the
// pointwise and small-reduction work of one layer's step as six kernels
// around the layer's ten weight products, which stay with the library.
//
// Replaces no Pallas kernel.  The JAX package's T = 1 step is the plain
// chain of models/rwkv6.py::rwkv_apply (the per-token oracle
// kernels/ref.py::rwkv_scan_ref with the layer norms, the token shift, the
// data-dependent interpolation, the decay's low-rank path, the group norm
// and the channel mix), which XLA fuses under jit.  The eager port ran that
// chain as ~97 small kernels a layer, each a graph node of a decode chunk.
//
// What bounds it: the launch and its latency.  At batch 8 and d_model 4096
// a kernel here touches at most a few hundred KB (the WKV state: 16 KB read
// and written a (row, head)), microseconds of bytes; what the design does
// is cut the count to six a layer, each holding its intermediates in
// registers and shared memory.  In order, with the products between them:
//
//   shift_mix   ln1 (the row held in registers, fp32 statistics in two
//               passes over it) -> xn (the new token-shift
//               state) and xxx = xn + (shift - xn) * mu_x        [x @ mix_w1]
//   lora_mix    tanh of the ddlerp's low-rank input, its five rank-R deltas
//               against mix_w2 summed in fp32, the five interpolations
//               xn + dx * (mu_5 + delta): xw in fp32 (the decay's product
//               takes fp32), xk, xv, xr, xg in the activation type
//                                           [wr, wk, wv, wg; xw @ w1 in fp32]
//   wkv_step    one block a (batch row, head): the decay
//               exp(-exp(w0 + tanh(a) w2)) for the head's channels, the exact
//               one-token WKV update of the fp32 state, the head's group
//               norm (eps 64e-5) with ln_x, times silu(g)          [@ wo]
//   cm_mix      the residual add, ln2, the channel mix's token shift
//               -> xk2, xr2                               [@ cm.wk, @ cm.wr]
//   relu_sq     relu(.)^2                                          [@ cm.wv]
//   cm_out      x + sigmoid(rr) * kv
//
// Arithmetic is fp32 throughout; a value is rounded to the activation type
// only where the plain chain hands it to a weight product or keeps it (the
// token-shift states, the residual stream, the block's output), so the
// chain's intermediate roundings are dropped, never added.  The WKV state
// stays fp32.  Every tensor is contiguous; the layer's products keep their
// library calls, weights and layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROW_THREADS = 1024; // shift_mix and cm_mix: one block a batch row
constexpr int ROW_PER = 16;       // the row held in registers: d_model up to ROW_THREADS * ROW_PER
constexpr int MIX_THREADS = 128;  // lora_mix: a thread a channel
constexpr int MIX_ROWS = 8;       // lora_mix: batch rows a block (mix_w2 read once for them)
constexpr int WKV_THREADS = 256;  // wkv_step: head dim x row groups
constexpr int MAX_DECAY_RANK = 256;
constexpr int EW_THREADS = 256;   // the elementwise kernels
constexpr int EW_MAX_BLOCKS = 2048;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T and read back
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// The sum of v over the block, in every thread (blockDim a multiple of 32);
// red: 32 floats of shared memory, free again when it returns.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  __syncthreads();  // a previous call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nw ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

// Mean and 1/sqrt(var + eps) of a row held ROW_PER values a thread (v[j]
// is element threadIdx.x + j * ROW_THREADS, 0 past D), two passes in fp32.
__device__ void held_stats(const float (&v)[ROW_PER], int D, float eps, float* red, float& mu,
                           float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < ROW_PER; ++j) s += v[j];
  mu = block_sum(s, red) / D;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < ROW_PER; ++j) {
    const float d = threadIdx.x + j * ROW_THREADS < D ? v[j] - mu : 0.f;
    q += d * d;
  }
  rstd = rsqrtf(block_sum(q, red) / D + eps);
}

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
shift_mix_kernel(const T* __restrict__ x, const T* __restrict__ shift, const float* __restrict__ ln_w,
                 const float* __restrict__ ln_b, const T* __restrict__ mu_x, int D, float eps,
                 T* __restrict__ xn_out, T* __restrict__ xxx_out) {
  __shared__ float red[32];
  const long long row = static_cast<long long>(blockIdx.x) * D;
  float v[ROW_PER];
#pragma unroll
  for (int j = 0; j < ROW_PER; ++j) {
    const int i = threadIdx.x + j * ROW_THREADS;
    v[j] = i < D ? to_f(x[row + i]) : 0.f;
  }
  float mu, rstd;
  held_stats(v, D, eps, red, mu, rstd);
#pragma unroll
  for (int j = 0; j < ROW_PER; ++j) {
    const int i = threadIdx.x + j * ROW_THREADS;
    if (i >= D) break;
    const float xn = round_to<T>((v[j] - mu) * rstd * ln_w[i] + ln_b[i]);
    const float dx = to_f(shift[row + i]) - xn;
    xn_out[row + i] = from_f<T>(xn);
    xxx_out[row + i] = from_f<T>(xn + dx * to_f(mu_x[i]));
  }
}

// grid (channel blocks, batch-row blocks, 5 interpolations); shared: the
// block's rows' tanh(z) for its interpolation, MIX_ROWS x R floats
template <typename T>
__global__ void __launch_bounds__(MIX_THREADS)
lora_mix_kernel(const T* __restrict__ zpre, const T* __restrict__ xn, const T* __restrict__ shift,
                const T* __restrict__ mix_w2, const T* __restrict__ mu5, int B, int D, int R,
                float* __restrict__ xw_out, T* __restrict__ xo_out) {
  extern __shared__ float z[];
  const int f = blockIdx.z;
  const int b0 = blockIdx.y * MIX_ROWS;
  const int nb = min(MIX_ROWS, B - b0);
  for (int i = threadIdx.x; i < MIX_ROWS * R; i += blockDim.x) {
    const int bb = i / R, r = i % R;
    z[i] = bb < nb ? tanhf(to_f(zpre[static_cast<long long>(b0 + bb) * 5 * R + f * R + r])) : 0.f;
  }
  __syncthreads();
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float acc[MIX_ROWS];
#pragma unroll
  for (int bb = 0; bb < MIX_ROWS; ++bb) acc[bb] = 0.f;
  const T* w = mix_w2 + static_cast<long long>(f) * R * D + d;
#pragma unroll 8
  for (int r = 0; r < R; ++r) {  // eight rows of mix_w2 in flight
    const float wv = to_f(w[static_cast<long long>(r) * D]);
#pragma unroll
    for (int bb = 0; bb < MIX_ROWS; ++bb) acc[bb] += z[bb * R + r] * wv;
  }
  const float m = to_f(mu5[static_cast<long long>(f) * D + d]);
#pragma unroll
  for (int bb = 0; bb < MIX_ROWS; ++bb) {
    if (bb >= nb) break;
    const long long at = static_cast<long long>(b0 + bb) * D + d;
    const float xv = to_f(xn[at]);
    const float v = xv + (to_f(shift[at]) - xv) * (m + acc[bb]);
    if (f == 0)
      xw_out[at] = v;
    else
      xo_out[static_cast<long long>(f - 1) * B * D + at] = from_f<T>(v);
  }
}

// one block a (batch row, head); thread t holds state column t % HD of rows
// (t / HD) * ROWS ... + ROWS - 1
template <typename T, int HD>
__global__ void __launch_bounds__(WKV_THREADS)
wkv_step_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ g, const float* __restrict__ a, const float* __restrict__ w0,
                const float* __restrict__ w2, const float* __restrict__ u, const float* __restrict__ s,
                const T* __restrict__ lnx_w, const T* __restrict__ lnx_b, int H, int L, float eps,
                T* __restrict__ out, float* __restrict__ s_out) {
  constexpr int KG = WKV_THREADS / HD;  // row groups
  constexpr int ROWS = HD / KG;         // state rows a thread
  __shared__ float ta[MAX_DECAY_RANK];
  __shared__ float rs[HD], ks[HD], us[HD], decay[HD];
  __shared__ float part[KG][HD];
  __shared__ float red[32];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int D = H * HD;
  const int t = threadIdx.x, c = t % HD, kg = t / HD;
  const long long base = static_cast<long long>(b) * D + h * HD;
  for (int j = t; j < L; j += WKV_THREADS) ta[j] = tanhf(a[static_cast<long long>(b) * L + j]);
  if (t < HD) {
    rs[t] = to_f(r[base + t]);
    ks[t] = to_f(k[base + t]);
    us[t] = u[h * HD + t];
  }
  __syncthreads();
  // the decay's low-rank product for channel c: its rows kg, kg + KG, ...
  float p = 0.f;
#pragma unroll 4
  for (int j = kg; j < L; j += KG) p += ta[j] * w2[static_cast<long long>(j) * D + h * HD + c];
  part[kg][c] = p;
  __syncthreads();
  if (t < HD) {
    float wl = w0[h * HD + t];
#pragma unroll
    for (int q = 0; q < KG; ++q) wl += part[q][t];
    decay[t] = expf(-expf(wl));  // exp(lw), lw = -exp(w0 + tanh(a) w2) <= 0
  }
  __syncthreads();
  const float vc = to_f(v[base + c]);
  const long long at = (static_cast<long long>(bh) * HD + kg * ROWS) * HD + c;
  const float* sp = s + at;
  float* so = s_out + at;
  float y = 0.f;
#pragma unroll 8
  for (int i = 0; i < ROWS; ++i) {
    const int row = kg * ROWS + i;
    const float sv = sp[i * HD];
    const float kv = ks[row] * vc;
    y += rs[row] * (sv + us[row] * kv);
    so[i * HD] = decay[row] * sv + kv;
  }
  part[kg][c] = y;  // the decay's partials were read before the last barrier
  __syncthreads();
  float yv = 0.f;
  if (t < HD) {
#pragma unroll
    for (int q = 0; q < KG; ++q) yv += part[q][t];
  }
  const float mu = block_sum(t < HD ? yv : 0.f, red) / HD;
  const float dv = t < HD ? yv - mu : 0.f;
  const float rstd = rsqrtf(block_sum(dv * dv, red) / HD + eps);
  if (t < HD) {
    const float yn = dv * rstd * to_f(lnx_w[h * HD + t]) + to_f(lnx_b[h * HD + t]);
    const float gv = to_f(g[base + t]);
    out[base + t] = from_f<T>(yn * (gv / (1.f + expf(-gv))));
  }
}

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
cm_mix_kernel(const T* __restrict__ x, const T* __restrict__ o, const T* __restrict__ shift,
              const float* __restrict__ ln_w, const float* __restrict__ ln_b,
              const T* __restrict__ mu_k, const T* __restrict__ mu_r, int B, int D, float eps,
              T* __restrict__ x1_out, T* __restrict__ xn_out, T* __restrict__ xkr_out) {
  __shared__ float red[32];
  const long long row = static_cast<long long>(blockIdx.x) * D;
  float v[ROW_PER];  // the residual stream after the time mix, in the activation type
#pragma unroll
  for (int j = 0; j < ROW_PER; ++j) {
    const int i = threadIdx.x + j * ROW_THREADS;
    v[j] = i < D ? round_to<T>(to_f(x[row + i]) + to_f(o[row + i])) : 0.f;
  }
  float mu, rstd;
  held_stats(v, D, eps, red, mu, rstd);
  const long long second = static_cast<long long>(B) * D;
#pragma unroll
  for (int j = 0; j < ROW_PER; ++j) {
    const int i = threadIdx.x + j * ROW_THREADS;
    if (i >= D) break;
    const float xn = round_to<T>((v[j] - mu) * rstd * ln_w[i] + ln_b[i]);
    const float dx = to_f(shift[row + i]) - xn;
    x1_out[row + i] = from_f<T>(v[j]);
    xn_out[row + i] = from_f<T>(xn);
    xkr_out[row + i] = from_f<T>(xn + dx * to_f(mu_k[i]));
    xkr_out[second + row + i] = from_f<T>(xn + dx * to_f(mu_r[i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
relu_sq_kernel(const T* __restrict__ h, long long n, T* __restrict__ out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float m = fmaxf(to_f(h[i]), 0.f);
    out[i] = from_f<T>(m * m);
  }
}

template <typename T>
__global__ void __launch_bounds__(EW_THREADS)
cm_out_kernel(const T* __restrict__ x1, const T* __restrict__ rr, const T* __restrict__ kv, long long n,
              T* __restrict__ out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = from_f<T>(to_f(x1[i]) + to_f(kv[i]) / (1.f + expf(-to_f(rr[i]))));
}

int ew_blocks(long long n) {
  const long long b = (n + EW_THREADS - 1) / EW_THREADS;
  return static_cast<int>(b < 1 ? 1 : (b > EW_MAX_BLOCKS ? EW_MAX_BLOCKS : b));
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

template <typename T, int HD>
int launch_wkv(int B, int H, int L, float eps, const void* r, const void* k, const void* v, const void* g,
               const void* a, const void* w0, const void* w2, const void* u, const void* s,
               const void* lnx_w, const void* lnx_b, void* out, void* s_out, cudaStream_t st) {
  wkv_step_kernel<T, HD><<<B * H, WKV_THREADS, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(a), static_cast<const float*>(w0),
      static_cast<const float*>(w2), static_cast<const float*>(u), static_cast<const float*>(s),
      static_cast<const T*>(lnx_w), static_cast<const T*>(lnx_b), H, L, eps, static_cast<T*>(out),
      static_cast<float*>(s_out));
  return last_error();
}

template <typename T>
int launch_wkv_hd(int hd, int B, int H, int L, float eps, const void* r, const void* k, const void* v,
                  const void* g, const void* a, const void* w0, const void* w2, const void* u,
                  const void* s, const void* lnx_w, const void* lnx_b, void* out, void* s_out,
                  cudaStream_t st) {
  switch (hd) {
#define REPRO_WKV_CASE(HD) \
    case HD:               \
      return launch_wkv<T, HD>(B, H, L, eps, r, k, v, g, a, w0, w2, u, s, lnx_w, lnx_b, out, s_out, st);
    REPRO_WKV_CASE(16)
    REPRO_WKV_CASE(64)
#undef REPRO_WKV_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Each entry point launches one kernel on ``stream`` and returns
// cudaGetLastError(); ``bf`` picks the activation type (1 bf16, 0 fp32).
// Tensors are contiguous: rows (B, D), the ddlerp's input (B, 5R), mix_w2
// (5, R, D), mu_5 (5, D), the decay's input a (B, L) and w2 (L, D) in fp32,
// u (H, hd), the states (B, H, hd, hd) in fp32; the layer norms' weights in
// fp32, every other weight in the activation type.
extern "C" {

int repro_rwkv_shift_mix(int bf, const void* x, const void* shift, const void* ln_w, const void* ln_b,
                         const void* mu_x, int B, int D, float eps, void* xn, void* xxx, void* stream) {
  if (B < 1 || D < 1 || D > ROW_THREADS * ROW_PER) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ln_w);
  const float* b = static_cast<const float*>(ln_b);
  if (bf)
    shift_mix_kernel<bf16><<<B, ROW_THREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(shift), w, b, static_cast<const bf16*>(mu_x),
        D, eps, static_cast<bf16*>(xn), static_cast<bf16*>(xxx));
  else
    shift_mix_kernel<float><<<B, ROW_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(shift), w, b,
        static_cast<const float*>(mu_x), D, eps, static_cast<float*>(xn), static_cast<float*>(xxx));
  return last_error();
}

int repro_rwkv_lora_mix(int bf, const void* zpre, const void* xn, const void* shift, const void* mix_w2,
                        const void* mu5, int B, int D, int R, void* xw, void* xo, void* stream) {
  if (B < 1 || D < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((D + MIX_THREADS - 1) / MIX_THREADS, (B + MIX_ROWS - 1) / MIX_ROWS, 5);
  const size_t smem = sizeof(float) * MIX_ROWS * R;
  if (bf)
    lora_mix_kernel<bf16><<<grid, MIX_THREADS, smem, st>>>(
        static_cast<const bf16*>(zpre), static_cast<const bf16*>(xn), static_cast<const bf16*>(shift),
        static_cast<const bf16*>(mix_w2), static_cast<const bf16*>(mu5), B, D, R, static_cast<float*>(xw),
        static_cast<bf16*>(xo));
  else
    lora_mix_kernel<float><<<grid, MIX_THREADS, smem, st>>>(
        static_cast<const float*>(zpre), static_cast<const float*>(xn), static_cast<const float*>(shift),
        static_cast<const float*>(mix_w2), static_cast<const float*>(mu5), B, D, R,
        static_cast<float*>(xw), static_cast<float*>(xo));
  return last_error();
}

int repro_rwkv_wkv_step(int bf, const void* r, const void* k, const void* v, const void* g, const void* a,
                        const void* w0, const void* w2, const void* u, const void* s, const void* lnx_w,
                        const void* lnx_b, int B, int H, int hd, int L, float eps, void* out, void* s_out,
                        void* stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_DECAY_RANK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf)
    return launch_wkv_hd<bf16>(hd, B, H, L, eps, r, k, v, g, a, w0, w2, u, s, lnx_w, lnx_b, out, s_out, st);
  return launch_wkv_hd<float>(hd, B, H, L, eps, r, k, v, g, a, w0, w2, u, s, lnx_w, lnx_b, out, s_out, st);
}

int repro_rwkv_cm_mix(int bf, const void* x, const void* o, const void* shift, const void* ln_w,
                      const void* ln_b, const void* mu_k, const void* mu_r, int B, int D, float eps,
                      void* x1, void* xn, void* xkr, void* stream) {
  if (B < 1 || D < 1 || D > ROW_THREADS * ROW_PER) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ln_w);
  const float* b = static_cast<const float*>(ln_b);
  if (bf)
    cm_mix_kernel<bf16><<<B, ROW_THREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(o), static_cast<const bf16*>(shift), w, b,
        static_cast<const bf16*>(mu_k), static_cast<const bf16*>(mu_r), B, D, eps, static_cast<bf16*>(x1),
        static_cast<bf16*>(xn), static_cast<bf16*>(xkr));
  else
    cm_mix_kernel<float><<<B, ROW_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(o), static_cast<const float*>(shift), w, b,
        static_cast<const float*>(mu_k), static_cast<const float*>(mu_r), B, D, eps,
        static_cast<float*>(x1), static_cast<float*>(xn), static_cast<float*>(xkr));
  return last_error();
}

int repro_rwkv_relu_sq(int bf, const void* h, long long n, void* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf)
    relu_sq_kernel<bf16><<<ew_blocks(n), EW_THREADS, 0, st>>>(static_cast<const bf16*>(h), n,
                                                               static_cast<bf16*>(out));
  else
    relu_sq_kernel<float><<<ew_blocks(n), EW_THREADS, 0, st>>>(static_cast<const float*>(h), n,
                                                                static_cast<float*>(out));
  return last_error();
}

int repro_rwkv_cm_out(int bf, const void* x1, const void* rr, const void* kv, long long n, void* out,
                      void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf)
    cm_out_kernel<bf16><<<ew_blocks(n), EW_THREADS, 0, st>>>(
        static_cast<const bf16*>(x1), static_cast<const bf16*>(rr), static_cast<const bf16*>(kv), n,
        static_cast<bf16*>(out));
  else
    cm_out_kernel<float><<<ew_blocks(n), EW_THREADS, 0, st>>>(
        static_cast<const float*>(x1), static_cast<const float*>(rr), static_cast<const float*>(kv), n,
        static_cast<float*>(out));
  return last_error();
}

const char* repro_rwkv_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
