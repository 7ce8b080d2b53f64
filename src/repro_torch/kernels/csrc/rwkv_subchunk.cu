// RWKV-6 WKV scan for Hopper (sm_90a), sub-chunked on the tensor cores.
//
// Replaces the JAX package's kernels/linear_scan.py::rwkv_scan_chunked
// (Pallas TPU, _rwkv_kernel) for bf16 r, k, v at head dim 64; fp32 calls and
// the other head dims keep the per-token kernel of linear_scan.cu.  Per
// (batch, head), with an fp32 (64 x 64) state S,
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] <- exp(lw_t[i]) S[i][j] + k_t[i] v_t[j]
//
// What bounds it: the per-token recurrence does about 5 hd^2 fp32 FLOP per
// (token, head) on the CUDA cores (21.5 GFLOP at rwkv6-7b's prefill, 0.32 ms
// at 67 TFLOP/s), while its bytes (bf16 r, k, v, y; fp32 lw; the states) take
// 0.245 ms at 3.35 TB/s.  This design moves the hd^2 work to the tensor cores
// so that the bytes can set the pace.  Per sub-chunk of LC = 16 tokens, with
// c_t = lw_0 + ... + lw_t restarted at the sub-chunk's start (so every
// exponent below is <= 0 and nothing overflows at any decay):
//  * inter:  y_t += (r_t * e^{c_{t-1}}) @ S                       (tensor cores)
//  * intra:  A[t][s] = sum_i r_t[i] k_s[i] e^{c_{t-1}[i] - c_s[i]} for s < t,
//            exactly per channel on the CUDA cores (the TPU kernel's
//            (L, L, hd) form at L = 16), one thread per pair (t, s) over all
//            64 channels, A[t][t] = sum_i r_t[i] u[i] k_t[i];
//            y += A @ v, fused with inter into one product over K = 64 + 16
//  * state:  S <- e^{c_15} * S + (k * e^{c_15 - c})^T @ v           (tensor cores)
// The products are mma.sync m16n8k8 in TF32 with fp32 accumulation.  y
// (rounded to bf16) takes one TF32 rounding of each operand; the state keeps
// fp32 accuracy: v is bf16 and so exact in TF32, and k * e^{c_15 - c} is
// split into a TF32 high and low part, two products.  The state lives in
// registers as the accumulators: warp w owns rows 16w .. 16w + 15.
//
// One block of 4 warps per (batch, head).  `lst` = max(chunk, 16) tokens of
// r, k, v and lw are staged per load through a two-stage cp.async ring
// (per (b, h) a token's 64 channels are contiguous and tokens lie H * 64
// apart), so the next stage's loads are in flight while the current one
// computes.  Shared arrays are padded so that the fragment loads of the
// products hit distinct banks.
//
// C interface (bound with ctypes): returns a cudaError_t code, 0 on success.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_SMEM = 232448;  // shared memory one block may use on Hopper (227 KB)
constexpr int HD = 64;              // head dim
constexpr int LC = 16;              // tokens per sub-chunk
constexpr int NT = 128;             // 4 warps
constexpr int NSTAGE = 2;           // ring stages
constexpr int RS = HD + 8;          // bf16 staging row: 144 bytes
constexpr int WS = HD + 4;          // fp32 lw / c staging row: 272 bytes
constexpr int TOK_BYTES = 3 * RS * 2 + WS * 4;  // staged bytes per token
constexpr int A_LD = HD + 4;        // rd [t][i], read as A[t][i]
constexpr int T_LD = HD + 8;        // kd [t][i] (read as A[i][t]), Sm [i][j] (read as B[i][j])
constexpr int SC_LD = LC + 4;       // intra scores [t][s]
constexpr int COMPUTE_FLOATS = HD * T_LD + LC * A_LD + LC * T_LD + LC * SC_LD + 2 * HD;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ uint32_t bf_bits(bf16 x) { return __float_as_uint(__bfloat162float(x)); }
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__global__ void __launch_bounds__(NT, 4)
rwkv_tc_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const float* __restrict__ lw, const float* __restrict__ u,
               const float* __restrict__ s0, bf16* __restrict__ y, float* __restrict__ sT,
               int T_len, int H, int lst) {
  extern __shared__ __align__(16) char smem[];
  float* Sm = reinterpret_cast<float*>(smem + NSTAGE * lst * TOK_BYTES);  // [HD][T_LD]
  float* rd = Sm + HD * T_LD;    // [LC][A_LD]: r * e^{c_{t-1}}
  float* kd = rd + LC * A_LD;    // [LC][T_LD]: k * e^{c_15 - c_t}
  float* sc = kd + LC * T_LD;    // [LC][SC_LD]: intra scores (0 above the diagonal)
  float* wl = sc + LC * SC_LD;   // [HD]: e^{c_15}
  float* u_s = wl + HD;          // [HD]: the bonus u of this head

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // mma group
  const int tq = lane & 3;   // thread in group
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const long long bh = static_cast<long long>(bi) * H + h;
  const long long tok_stride = static_cast<long long>(H) * HD;
  const long long base = (static_cast<long long>(bi) * T_len * H + h) * HD;  // token 0 of (bi, h)

  // the state as accumulators: S[nt] holds rows i0, i0 + 8 and columns 8 nt + 2 tq (+1)
  const int i0 = 16 * warp + g;
  float S[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * tq;
    const float2 a = *reinterpret_cast<const float2*>(s0 + (bh * HD + i0) * HD + col);
    const float2 b = *reinterpret_cast<const float2*>(s0 + (bh * HD + i0 + 8) * HD + col);
    S[nt][0] = a.x; S[nt][1] = a.y; S[nt][2] = b.x; S[nt][3] = b.y;
  }
  for (int idx = tid; idx < LC * SC_LD; idx += NT) sc[idx] = 0.f;
  // the intra step's pair of tokens (pt, ps), ps < pt, numbered row by row
  int pt = 1, ps = 0;
  for (int n = 0; n < tid && pt < LC; ++n)
    if (++ps == pt) { ++pt; ps = 0; }
  for (int i = tid; i < HD; i += NT) u_s[i] = u[h * HD + i];

  auto issue = [&](int st) {
    if (st * lst < T_len) {
      char* buf = smem + (st % NSTAGE) * lst * TOK_BYTES;
      bf16* rb = reinterpret_cast<bf16*>(buf);
      bf16* kb = rb + lst * RS;
      bf16* vb = kb + lst * RS;
      float* wb = reinterpret_cast<float*>(vb + lst * RS);
      const long long t0 = static_cast<long long>(st) * lst;
      for (int e = tid; e < lst * 8; e += NT) {
        const int t = e >> 3, pc = e & 7;
        const long long off = base + (t0 + t) * tok_stride + 8 * pc;
        cp_async16(rb + t * RS + 8 * pc, r + off);
        cp_async16(kb + t * RS + 8 * pc, k + off);
        cp_async16(vb + t * RS + 8 * pc, v + off);
      }
      for (int e = tid; e < lst * 16; e += NT) {
        const int t = e >> 4, pc = e & 15;
        cp_async16(wb + t * WS + 4 * pc, lw + base + (t0 + t) * tok_stride + 4 * pc);
      }
    }
    cp_async_commit();
  };

  const int nstage = T_len / lst;
  issue(0);
  for (int st = 0; st < nstage; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st landed; every thread is done with stage st - 1
    issue(st + 1);
    const char* buf = smem + (st % NSTAGE) * lst * TOK_BYTES;
    const bf16* rb = reinterpret_cast<const bf16*>(buf);
    const bf16* kb = rb + lst * RS;
    const bf16* vb = kb + lst * RS;
    float* wb = reinterpret_cast<float*>(const_cast<char*>(buf) + 3 * lst * RS * 2);
    for (int q = 0; q < lst / LC; ++q) {
      const bf16* rq = rb + q * LC * RS;
      const bf16* kq = kb + q * LC * RS;
      const bf16* vq = vb + q * LC * RS;
      float* cq = wb + q * LC * WS;
      if (q > 0) __syncthreads();  // the previous sub-chunk is done with Sm, rd, kd, sc

      // (a) the state at the sub-chunk's start to shared memory; decays to c in place
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = 8 * nt + 2 * tq;
        *reinterpret_cast<float2*>(Sm + i0 * T_LD + col) = make_float2(S[nt][0], S[nt][1]);
        *reinterpret_cast<float2*>(Sm + (i0 + 8) * T_LD + col) = make_float2(S[nt][2], S[nt][3]);
      }
      if (tid < HD) {
        float raw[LC];
#pragma unroll
        for (int t = 0; t < LC; ++t) raw[t] = cq[t * WS + tid];
        float c = 0.f;
#pragma unroll
        for (int t = 0; t < LC; ++t) {
          c += raw[t];
          cq[t * WS + tid] = c;
        }
        wl[tid] = expf(c);
      }
      __syncthreads();

      // (b) decay-weighted operands: rd for y (fast exp), kd for the state (accurate exp)
      for (int e = tid; e < LC * HD; e += NT) {
        const int t = e >> 6, i = e & (HD - 1);
        const float ct = cq[t * WS + i];
        const float cp = t > 0 ? cq[(t - 1) * WS + i] : 0.f;
        const float cl = cq[(LC - 1) * WS + i];
        rd[t * A_LD + i] = bf(rq[t * RS + i]) * __expf(cp);
        kd[t * T_LD + i] = bf(kq[t * RS + i]) * expf(cl - ct);
      }
      // (c) intra scores: thread tid < 120 takes the pair (pt, ps), ps < pt, over
      // all 64 channels; threads 120 .. 127 take the diagonals of two tokens each
      if (tid < 120) {
        const float* ct1 = cq + (pt - 1) * WS;
        const float* cs = cq + ps * WS;
        const bf16* rt = rq + pt * RS;
        const bf16* ks = kq + ps * RS;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int i = 0; i < HD; i += 4) {
          const float4 a = *reinterpret_cast<const float4*>(ct1 + i);
          const float4 b = *reinterpret_cast<const float4*>(cs + i);
          const uint2 rr = *reinterpret_cast<const uint2*>(rt + i);
          const uint2 kk = *reinterpret_cast<const uint2*>(ks + i);
          const float2 r01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rr.x));
          const float2 r23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rr.y));
          const float2 k01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kk.x));
          const float2 k23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kk.y));
          part[0] = fmaf(r01.x * k01.x, __expf(a.x - b.x), part[0]);
          part[1] = fmaf(r01.y * k01.y, __expf(a.y - b.y), part[1]);
          part[2] = fmaf(r23.x * k23.x, __expf(a.z - b.z), part[2]);
          part[3] = fmaf(r23.y * k23.y, __expf(a.w - b.w), part[3]);
        }
        sc[pt * SC_LD + ps] = (part[0] + part[1]) + (part[2] + part[3]);
      } else {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int t = 2 * (tid - 120) + d;
          float part = 0.f;
          for (int i = 0; i < HD; ++i) part = fmaf(bf(rq[t * RS + i]) * u_s[i], bf(kq[t * RS + i]), part);
          sc[t * SC_LD + t] = part;
        }
      }
      __syncthreads();

      // (d) y = [rd | sc] @ [S ; v] for this warp's columns 16 w .. 16 w + 15
      {
        float acc[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks) {
          const uint32_t a[4] = {tf32(rd[g * A_LD + 8 * ks + tq]), tf32(rd[(g + 8) * A_LD + 8 * ks + tq]),
                                 tf32(rd[g * A_LD + 8 * ks + tq + 4]),
                                 tf32(rd[(g + 8) * A_LD + 8 * ks + tq + 4])};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int j = 16 * warp + 8 * nt + g;
            const uint32_t b[2] = {tf32(Sm[(8 * ks + tq) * T_LD + j]), tf32(Sm[(8 * ks + tq + 4) * T_LD + j])};
            mma_tf32(acc[nt], a, b);
          }
        }
#pragma unroll
        for (int ks = 0; ks < LC / 8; ++ks) {
          const uint32_t a[4] = {tf32(sc[g * SC_LD + 8 * ks + tq]), tf32(sc[(g + 8) * SC_LD + 8 * ks + tq]),
                                 tf32(sc[g * SC_LD + 8 * ks + tq + 4]),
                                 tf32(sc[(g + 8) * SC_LD + 8 * ks + tq + 4])};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int j = 16 * warp + 8 * nt + g;
            const uint32_t b[2] = {bf_bits(vq[(8 * ks + tq) * RS + j]), bf_bits(vq[(8 * ks + tq + 4) * RS + j])};
            mma_tf32(acc[nt], a, b);
          }
        }
        const long long tok = static_cast<long long>(st) * lst + q * LC + g;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = 16 * warp + 8 * nt + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(y + base + tok * tok_stride + col) =
              __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<__nv_bfloat162*>(y + base + (tok + 8) * tok_stride + col) =
              __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
        }
      }

      // (e) S <- e^{c_15} * S + kd^T @ v, kd split into TF32 high and low parts
      {
        const float w0 = wl[i0], w1 = wl[i0 + 8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          S[nt][0] *= w0; S[nt][1] *= w0; S[nt][2] *= w1; S[nt][3] *= w1;
        }
#pragma unroll
        for (int ks = 0; ks < LC / 8; ++ks) {
          const float x[4] = {kd[(8 * ks + tq) * T_LD + i0], kd[(8 * ks + tq) * T_LD + i0 + 8],
                              kd[(8 * ks + tq + 4) * T_LD + i0], kd[(8 * ks + tq + 4) * T_LD + i0 + 8]};
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[e] = tf32(x[e]);
            lo[e] = tf32(x[e] - __uint_as_float(hi[e]));
          }
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int j = 8 * nt + g;
            const uint32_t b[2] = {bf_bits(vq[(8 * ks + tq) * RS + j]), bf_bits(vq[(8 * ks + tq + 4) * RS + j])};
            mma_tf32(S[nt], lo, b);
            mma_tf32(S[nt], hi, b);
          }
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * tq;
    *reinterpret_cast<float2*>(sT + (bh * HD + i0) * HD + col) = make_float2(S[nt][0], S[nt][1]);
    *reinterpret_cast<float2*>(sT + (bh * HD + i0 + 8) * HD + col) = make_float2(S[nt][2], S[nt][3]);
  }
}

size_t smem_bytes(int lst) {
  return static_cast<size_t>(NSTAGE) * lst * TOK_BYTES + sizeof(float) * COMPUTE_FLOATS;
}

}  // namespace

extern "C" {

// r, k, v, y: (B, T, H, 64) bf16, lw: (B, T, H, 64) fp32, u: (H, 64) fp32,
// s0, sT: (B, H, 64, 64) fp32, all contiguous and 16-byte aligned.  `chunk`
// is the staged tokens per load, raised to 16; T must be a multiple of it.
int repro_rwkv_scan_tc_bf16(const void* r, const void* k, const void* v, const void* lw,
                            const void* u, const void* s0, void* y, void* sT, int B, int T, int H,
                            int chunk, void* stream) {
  const int lst = chunk < LC ? LC : chunk;
  if (B <= 0 || T <= 0 || H <= 0 || lst % LC || T % lst) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(lst);
  if (smem > static_cast<size_t>(BLOCK_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  // The attribute is the block's limit, not this launch's need (several threads may launch).
  cudaError_t err = cudaFuncSetAttribute(rwkv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B);
  rwkv_tc_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(lw), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<bf16*>(y), static_cast<float*>(sT), T, H, lst);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_rwkv_subchunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
