// Flash-attention backward for Hopper (sm_90a): FlashAttention-2's
// recompute, without the (B, H, Sq, Skv) score buffer.
//
// The JAX package has no Pallas kernel for this gradient: its custom_vjp
// (kernels/ops.py::_flash_bwd) takes jax.vjp of the oracle, which builds
// the whole fp32 softmax.  Here P is recomputed tile by tile from the row
// logsumexp the forward wrote (flash_attention.cu / flash_attention_wgmma.cu,
// lse = m + log l of the scaled scores):
//
//   D  = rowsum(dO * O)                 P  = exp(S * scale - lse)
//   dV = P^T dO                         dP = dO V^T
//   dS = P * (dP - D)                   dQ = dS K * scale,  dK = dS^T Q * scale
//
// Two launches a call, each writing every output element once, so two
// calls on the same inputs give bit-identical gradients:
//
// - dq pass: one block per (query tile, query head, batch row).  Its
//   prologue computes D for its rows (written to a scratch buffer for the
//   next pass); it walks the KV tiles up to the causal bound, recomputing S
//   and dP, and accumulates dQ.
// - dkdv pass: one block per (KV tile, KV head, batch row).  It walks the
//   g query heads of its group and the query tiles the causal mask lets
//   reach the tile, recomputing S^T and dP^T, and accumulates dK and dV for
//   all g heads at once (GQA without atomics or per-head partials).
//
// That recomputes S and dP twice: 7 products per (query, key) pair against
// the 5 of FA-2 with an atomic dQ.  Causal masking keeps qi >= kj aligned
// top-left, as the forward kernels do; the oracle aligns bottom-right, and
// the two agree for Sq == Skv, which is every call the models make.
//
// Two designs (flash_attention.py::bwd_design):
// - "mma" (bf16, Sq and Skv multiples of 64, 16-byte rows): four warps a
//   block, each owning 16 rows; the five products run on the tensor cores
//   with mma.sync m16n8k16 (bf16 operands, fp32 accumulators), operands
//   read from padded shared memory with ldmatrix (row stride hd + 8: the 8
//   row addresses of one 8x8 matrix fall on distinct banks); the product
//   results are turned into the next product's A operand in registers (P
//   and dS rounded to bf16 there, which the plain version repeats).  The
//   streamed tiles (K/V in the dq pass, Q/dO/lse/D in the dkdv pass) are
//   double-buffered with cp.async.  Tiles: 64 query rows x 64 keys in the
//   dq pass; 64 keys x 64 query rows (32 at hd 128, to keep dK, dV, S^T
//   and dP^T in registers) in the dkdv pass.
// - "simt" (fp32, and every other shape): 8 threads a row, the dot
//   products reduced over them with shuffles, the streamed rows staged in
//   shared memory as fp32; bf16 inputs round P and dS as the "mma" design
//   does.  Any Sq and Skv.
//
// What bounds it: five products of 2 hd FLOP per pair make it compute-bound
// at every trained shape; mma.sync reaches a fraction of wgmma's rate, and
// the split pays two extra products.  wgmma, TMA rings and warp
// specialisation are later work.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success.  Strides are in elements; the last dim is contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BLOCK_SMEM = 232448;  // shared memory one block may use on Hopper (227 KB)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 128;
constexpr int TILE = 64;  // the mma design's tile of the sequences (flash_attention.py BWD_TILE)

struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dO;
  const float* lse;  // (B, H, Sq)
  float* D;          // (B, H, Sq) scratch: the dq pass writes it, the dkdv pass reads it
  void* dq;
  void* dk;
  void* dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int H, Kh, Sq, Skv, causal;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }
// x rounded to T, as a tensor-core operand of type T would hold it
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------ mma helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment addresses in a row-major shared tile of row stride LD (elements),
// for the 32 lanes of one ldmatrix.x4:
// A operand, 16 x 16 at (r0, c0): registers a0..a3 of mma's A fragment.
template <int LD> __device__ __forceinline__ const bf16* frag_a(const bf16* t, int r0, int c0, int lane) {
  return t + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
// B operand from a tile stored N x K (B = tile^T): two n8 tiles at rows n0
// and n0 + 8, k16 at column k0 -> {b0, b1} of n-tile n0, {b0, b1} of n0 + 8.
template <int LD> __device__ __forceinline__ const bf16* frag_b(const bf16* t, int n0, int k0, int lane) {
  return t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 + ((lane >> 3) & 1) * 8;
}
// B operand from a tile stored K x N (ldmatrix.trans): k16 at row k0, two
// n8 tiles at columns n0 and n0 + 8.
template <int LD> __device__ __forceinline__ const bf16* frag_bt(const bf16* t, int k0, int n0, int lane) {
  return t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8;
}

// rows x HD bf16 from global (row stride rs) into a shared tile of stride HD + 8
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long rs, int rows) {
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < rows * CPR; idx += THREADS) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    cp_async16(dst + r * (HD + 8) + c, src + r * rs + c);
  }
}

// C fragments of two adjacent n8 tiles (columns 16c .. 16c + 15) as the A
// fragment of the k16 chunk c of the next product, rounded to bf16
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// the 16 x (HD) accumulator of a warp, scaled, as bf16 pairs into dst (row stride rs)
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, long long rs, const float (&acc)[HD / 8][4], float mult,
                                           int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(dst + g * rs + col) = pack_bf16(acc[n][0] * mult, acc[n][1] * mult);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * rs + col) = pack_bf16(acc[n][2] * mult, acc[n][3] * mult);
  }
}

// D for the 64 rows of O and dO a block owns, two threads a row, into D
// (global) and Ds (shared)
template <int HD>
__device__ __forceinline__ void rowsum_do_o(const bf16* ob, long long os_s, const bf16* dob, long long dos_s,
                                            float* Dg, float* Ds) {
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;
  float d = 0.f;
  {  // THREADS / 2 == TILE rows
    const bf16* orow = ob + r * os_s + half * (HD / 2);
    const bf16* drow = dob + r * dos_s + half * (HD / 2);
#pragma unroll 8
    for (int c = 0; c < HD / 2; ++c) d = fmaf(to_float(drow[c]), to_float(orow[c]), d);
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  if (half == 0) {
    Dg[r] = d;
    Ds[r] = d;
  }
}

// ============================================================ "mma" design
template <int HD>
__global__ void __launch_bounds__(THREADS) dq_mma_kernel(Args a) {
  constexpr int LD = HD + 8, BQ = TILE, BKV = TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;    // 2 stages
  bf16* Vs = Ks + 2 * BKV * LD;  // 2 stages
  float* Ds = reinterpret_cast<float*>(Vs + 2 * BKV * LD);
  float* Ls = Ds + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int n_q = a.Sq / BQ;
  const int q0 = (a.causal ? n_q - 1 - blockIdx.x : blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (a.H / a.Kh);
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h + q0 * a.qs.s;
  const bf16* dob = static_cast<const bf16*>(a.dO) + b * a.dos.b + h * a.dos.h + q0 * a.dos.s;
  const bf16* ob = static_cast<const bf16*>(a.o) + b * a.os.b + h * a.os.h + q0 * a.os.s;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + kvh * a.vs.h;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq + q0;
  const int n_kv = a.causal ? min(a.Skv / BKV, (q0 + BQ - 1) / BKV + 1) : a.Skv / BKV;

  load_tile<HD>(Qs, qb, a.qs.s, BQ);
  load_tile<HD>(dOs, dob, a.dos.s, BQ);
  if (n_kv > 0) {
    load_tile<HD>(Ks, kb, a.ks.s, BKV);
    load_tile<HD>(Vs, vb, a.vs.s, BKV);
  }
  cp_commit();
  rowsum_do_o<HD>(ob, a.os.s, dob, a.dos.s, a.D + row0, Ds);
  if (threadIdx.x < BQ) Ls[threadIdx.x] = a.lse[row0 + threadIdx.x] * LOG2E;
  __syncthreads();
  const int r_lo = warp * 16 + g;  // this thread's two rows: r_lo and r_lo + 8
  const float lse2[2] = {Ls[r_lo], Ls[r_lo + 8]};
  const float Dr[2] = {Ds[r_lo], Ds[r_lo + 8]};
  const float c = a.scale * LOG2E;

  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    const int kv0 = t * BKV;
    if (t + 1 < n_kv) {  // the other stage was last read in iteration t - 1
      load_tile<HD>(Ks + ((t + 1) & 1) * BKV * LD, kb + (kv0 + BKV) * a.ks.s, a.ks.s, BKV);
      load_tile<HD>(Vs + ((t + 1) & 1) * BKV * LD, vb + (kv0 + BKV) * a.vs.s, a.vs.s, BKV);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + (t & 1) * BKV * LD;
    const bf16* Vt = Vs + (t & 1) * BKV * LD;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows
    float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm_x4(aq, frag_a<LD>(Qs, warp * 16, kk * 16, lane));
      ldsm_x4(ado, frag_a<LD>(dOs, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, frag_b<LD>(Kt, n * 16, kk * 16, lane));
        ldsm_x4(bv, frag_b<LD>(Vt, n * 16, kk * 16, lane));
        mma(s[2 * n], aq, bk[0], bk[1]);
        mma(s[2 * n + 1], aq, bk[2], bk[3]);
        mma(dp[2 * n], ado, bv[0], bv[1]);
        mma(dp[2 * n + 1], ado, bv[2], bv[3]);
      }
    }
    // P = exp(S scale - lse), dS = P (dP - D), into s
    const bool mask = a.causal && kv0 + BKV - 1 > q0 + warp * 16;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(s[n][e], c, -lse2[e >> 1]));
        if (mask && kv0 + n * 8 + 2 * t4 + (e & 1) > q0 + r_lo + 8 * (e >> 1)) p = 0.f;
        s[n][e] = p * (dp[n][e] - Dr[e >> 1]);
      }
    // dQ += dS K
#pragma unroll
    for (int ck = 0; ck < BKV / 16; ++ck) {
      uint32_t ads[4];
      to_a(ads, s[2 * ck], s[2 * ck + 1]);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        uint32_t bk[4];
        ldsm_x4_t(bk, frag_bt<LD>(Kt, ck * 16, n * 16, lane));
        mma(dq[2 * n], ads, bk[0], bk[1]);
        mma(dq[2 * n + 1], ads, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage is free for iteration t + 2's load
  }
  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h + (q0 + warp * 16) * a.dqs.s;
  store_rows<HD>(dqb, a.dqs.s, dq, a.scale, lane);
}

template <int HD, int BQ>
__global__ void __launch_bounds__(THREADS) dkdv_mma_kernel(Args a) {
  constexpr int LD = HD + 8, BKV = TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;      // 2 stages
  bf16* dOs = Qs + 2 * BQ * LD;  // 2 stages
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // 2 stages
  float* Ds = Ls + 2 * BQ;                                   // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int kv0 = blockIdx.x * BKV, kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.Kh;
  const int n_qt = a.Sq / BQ;
  // query tiles with a row qi >= kv0 (top-left causal); none when kv0 >= Sq
  const int q_first = a.causal ? min(kv0 / BQ, n_qt) : 0;
  const int per_head = n_qt - q_first;
  const int total = group * per_head;

  auto load = [&](int it, int stage) {
    const int hh = kvh * group + it / per_head;
    const int q0 = (q_first + it % per_head) * BQ;
    load_tile<HD>(Qs + stage * BQ * LD,
                  static_cast<const bf16*>(a.q) + b * a.qs.b + hh * a.qs.h + q0 * a.qs.s, a.qs.s, BQ);
    load_tile<HD>(dOs + stage * BQ * LD,
                  static_cast<const bf16*>(a.dO) + b * a.dos.b + hh * a.dos.h + q0 * a.dos.s, a.dos.s, BQ);
    const long long row0 = (static_cast<long long>(b) * a.H + hh) * a.Sq + q0;
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      cp_async4(Ls + stage * BQ + i, a.lse + row0 + i);
      cp_async4(Ds + stage * BQ + i, a.D + row0 + i);
    }
  };

  load_tile<HD>(Ks, static_cast<const bf16*>(a.k) + b * a.ks.b + kvh * a.ks.h + kv0 * a.ks.s, a.ks.s, BKV);
  load_tile<HD>(Vs, static_cast<const bf16*>(a.v) + b * a.vs.b + kvh * a.vs.h + kv0 * a.vs.s, a.vs.s, BKV);
  if (total > 0) load(0, 0);
  cp_commit();

  const float c = a.scale * LOG2E;
  const int j_lo = warp * 16 + g;  // this thread's two key rows: j_lo and j_lo + 8
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int q0 = (q_first + it % per_head) * BQ;
    if (it + 1 < total) {  // the other stage was last read in iteration it - 1
      load(it + 1, (it + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + (it & 1) * BQ * LD;
    const bf16* dOt = dOs + (it & 1) * BQ * LD;
    const float* Lt = Ls + (it & 1) * BQ;
    const float* Dt = Ds + (it & 1) * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, frag_a<LD>(Ks, warp * 16, kk * 16, lane));
      ldsm_x4(av, frag_a<LD>(Vs, warp * 16, kk * 16, lane));
#pragma unroll
      for (int n = 0; n < BQ / 16; ++n) {
        uint32_t bq[4], bdo[4];
        ldsm_x4(bq, frag_b<LD>(Qt, n * 16, kk * 16, lane));
        ldsm_x4(bdo, frag_b<LD>(dOt, n * 16, kk * 16, lane));
        mma(s[2 * n], ak, bq[0], bq[1]);
        mma(s[2 * n + 1], ak, bq[2], bq[3]);
        mma(dp[2 * n], av, bdo[0], bdo[1]);
        mma(dp[2 * n + 1], av, bdo[2], bdo[3]);
      }
    }
    // P^T = exp(S^T scale - lse) (0 where qi < kj)
    const bool mask = a.causal && q0 < kv0 + warp * 16 + 15;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        float p = exp2_approx(fmaf(s[n][e], c, -Lt[col] * LOG2E));
        if (mask && q0 + col < kv0 + j_lo + 8 * (e >> 1)) p = 0.f;
        s[n][e] = p;
      }
    // dV += P^T dO (P^T rounded to bf16 as the A operand)
#pragma unroll
    for (int ck = 0; ck < BQ / 16; ++ck) {
      uint32_t ap[4];
      to_a(ap, s[2 * ck], s[2 * ck + 1]);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        uint32_t bdo[4];
        ldsm_x4_t(bdo, frag_bt<LD>(dOt, ck * 16, n * 16, lane));
        mma(dv[2 * n], ap, bdo[0], bdo[1]);
        mma(dv[2 * n + 1], ap, bdo[2], bdo[3]);
      }
    }
    // dS^T = P^T (dP^T - D), then dK += dS^T Q
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - Dt[n * 8 + 2 * t4 + (e & 1)];
#pragma unroll
    for (int ck = 0; ck < BQ / 16; ++ck) {
      uint32_t ads[4];
      to_a(ads, s[2 * ck], s[2 * ck + 1]);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        uint32_t bq[4];
        ldsm_x4_t(bq, frag_bt<LD>(Qt, ck * 16, n * 16, lane));
        mma(dk[2 * n], ads, bq[0], bq[1]);
        mma(dk[2 * n + 1], ads, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is free for iteration it + 2's load
  }
  cp_wait<0>();  // nothing in flight at exit (total == 0 still loaded K and V)
  bf16* dkb = static_cast<bf16*>(a.dk) + b * a.dks.b + kvh * a.dks.h + (kv0 + warp * 16) * a.dks.s;
  bf16* dvb = static_cast<bf16*>(a.dv) + b * a.dvs.b + kvh * a.dvs.h + (kv0 + warp * 16) * a.dvs.s;
  store_rows<HD>(dkb, a.dks.s, dk, a.scale, lane);
  store_rows<HD>(dvb, a.dvs.s, dv, 1.f, lane);
}

// =========================================================== "simt" design
constexpr int TPR = 8;        // threads a row
constexpr int ROWS = THREADS / TPR;  // rows a block owns
constexpr int STAGE = 32;     // streamed rows staged in shared memory at once

__device__ __forceinline__ unsigned row_mask() { return 0xffu << (threadIdx.x & 24); }

__device__ __forceinline__ float row_sum(float x, unsigned m) {
  x += __shfl_xor_sync(m, x, 4);
  x += __shfl_xor_sync(m, x, 2);
  x += __shfl_xor_sync(m, x, 1);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) dq_simt_kernel(Args a) {
  constexpr int NC = HD / TPR;
  __shared__ float Ks[STAGE][HD + 1], Vs[STAGE][HD + 1];
  const int r = threadIdx.x / TPR, t8 = threadIdx.x % TPR;
  const int q_base = blockIdx.x * ROWS, qi = q_base + r;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (a.H / a.Kh);
  const bool valid = qi < a.Sq;
  const unsigned m = row_mask();
  const T* qrow = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h + static_cast<long long>(qi) * a.qs.s;
  const T* dorow = static_cast<const T*>(a.dO) + b * a.dos.b + h * a.dos.h + static_cast<long long>(qi) * a.dos.s;
  const T* orow = static_cast<const T*>(a.o) + b * a.os.b + h * a.os.h + static_cast<long long>(qi) * a.os.s;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + kvh * a.vs.h;
  const long long row = (static_cast<long long>(b) * a.H + h) * a.Sq + qi;

  float qv[NC], dov[NC], dq[NC], d = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = t8 + TPR * j;
    qv[j] = valid ? to_float(qrow[col]) : 0.f;
    dov[j] = valid ? to_float(dorow[col]) : 0.f;
    d = fmaf(dov[j], valid ? to_float(orow[col]) : 0.f, d);
    dq[j] = 0.f;
  }
  d = row_sum(d, m);
  if (valid && t8 == 0) a.D[row] = d;
  const float lse = valid ? a.lse[row] : 0.f;

  const int q_last = min(a.Sq, q_base + ROWS) - 1;
  const int kv_end = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += STAGE) {
    const int n = min(STAGE, a.Skv - kv0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * HD; idx += THREADS) {
      const int j = idx / HD, col = idx % HD;
      Ks[j][col] = to_float(kb[static_cast<long long>(kv0 + j) * a.ks.s + col]);
      Vs[j][col] = to_float(vb[static_cast<long long>(kv0 + j) * a.vs.s + col]);
    }
    __syncthreads();
    const int j_end = !valid ? 0 : (a.causal ? min(n, qi - kv0 + 1) : n);
    for (int j = 0; j < j_end; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s = fmaf(qv[c], Ks[j][t8 + TPR * c], s);
        dp = fmaf(dov[c], Vs[j][t8 + TPR * c], dp);
      }
      s = row_sum(s, m);
      dp = row_sum(dp, m);
      const float p = expf(fmaf(s, a.scale, -lse));
      const float ds = round_to<T>(p * (dp - d));
#pragma unroll
      for (int c = 0; c < NC; ++c) dq[c] = fmaf(ds, Ks[j][t8 + TPR * c], dq[c]);
    }
  }
  if (valid) {
    T* dqrow = static_cast<T*>(a.dq) + b * a.dqs.b + h * a.dqs.h + static_cast<long long>(qi) * a.dqs.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) dqrow[t8 + TPR * c] = from_float<T>(dq[c] * a.scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) dkdv_simt_kernel(Args a) {
  constexpr int NC = HD / TPR;
  __shared__ float Qs[STAGE][HD + 1], dOs[STAGE][HD + 1], Ls[STAGE], Ds[STAGE];
  const int r = threadIdx.x / TPR, t8 = threadIdx.x % TPR;
  const int kv_base = blockIdx.x * ROWS, kj = kv_base + r;
  const int kvh = blockIdx.y, b = blockIdx.z, group = a.H / a.Kh;
  const bool valid = kj < a.Skv;
  const unsigned m = row_mask();
  const T* krow = static_cast<const T*>(a.k) + b * a.ks.b + kvh * a.ks.h + static_cast<long long>(kj) * a.ks.s;
  const T* vrow = static_cast<const T*>(a.v) + b * a.vs.b + kvh * a.vs.h + static_cast<long long>(kj) * a.vs.s;
  float kv_k[NC], kv_v[NC], dk[NC], dv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    kv_k[c] = valid ? to_float(krow[t8 + TPR * c]) : 0.f;
    kv_v[c] = valid ? to_float(vrow[t8 + TPR * c]) : 0.f;
    dk[c] = dv[c] = 0.f;
  }
  const int q_start = a.causal ? kv_base : 0;  // earlier queries see none of this block's keys
  for (int hh = kvh * group; hh < (kvh + 1) * group; ++hh) {
    const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + hh * a.qs.h;
    const T* dob = static_cast<const T*>(a.dO) + b * a.dos.b + hh * a.dos.h;
    const long long row0 = (static_cast<long long>(b) * a.H + hh) * a.Sq;
    for (int q0 = q_start; q0 < a.Sq; q0 += STAGE) {
      const int n = min(STAGE, a.Sq - q0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < n * HD; idx += THREADS) {
        const int i = idx / HD, col = idx % HD;
        Qs[i][col] = to_float(qb[static_cast<long long>(q0 + i) * a.qs.s + col]);
        dOs[i][col] = to_float(dob[static_cast<long long>(q0 + i) * a.dos.s + col]);
      }
      for (int i = threadIdx.x; i < n; i += THREADS) {
        Ls[i] = a.lse[row0 + q0 + i];
        Ds[i] = a.D[row0 + q0 + i];
      }
      __syncthreads();
      const int i_start = !valid ? n : (a.causal ? max(0, min(n, kj - q0)) : 0);
      for (int i = i_start; i < n; ++i) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          s = fmaf(kv_k[c], Qs[i][t8 + TPR * c], s);
          dp = fmaf(kv_v[c], dOs[i][t8 + TPR * c], dp);
        }
        s = row_sum(s, m);
        dp = row_sum(dp, m);
        const float p = expf(fmaf(s, a.scale, -Ls[i]));
        const float pr = round_to<T>(p);
        const float ds = round_to<T>(p * (dp - Ds[i]));
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[c] = fmaf(pr, dOs[i][t8 + TPR * c], dv[c]);
          dk[c] = fmaf(ds, Qs[i][t8 + TPR * c], dk[c]);
        }
      }
    }
  }
  if (valid) {
    T* dkrow = static_cast<T*>(a.dk) + b * a.dks.b + kvh * a.dks.h + static_cast<long long>(kj) * a.dks.s;
    T* dvrow = static_cast<T*>(a.dv) + b * a.dvs.b + kvh * a.dvs.h + static_cast<long long>(kj) * a.dvs.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkrow[t8 + TPR * c] = from_float<T>(dk[c] * a.scale);
      dvrow[t8 + TPR * c] = from_float<T>(dv[c]);
    }
  }
}

// ================================================================ launches
template <int HD> constexpr int dkdv_bq() { return HD == 128 ? 32 : 64; }

template <int HD>
int launch_mma(const Args& a, int B, cudaStream_t stream) {
  constexpr int LD = HD + 8, BQ2 = dkdv_bq<HD>();
  const size_t smem_dq = sizeof(bf16) * (2 * TILE + 4 * TILE) * LD + sizeof(float) * 2 * TILE;
  const size_t smem_kv = sizeof(bf16) * (2 * TILE + 4 * BQ2) * LD + sizeof(float) * 4 * BQ2;
  // The attributes are the block's limit, not this launch's need (as in flash_attention.cu).
  cudaError_t err = cudaFuncSetAttribute(dq_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_mma_kernel<HD, BQ2>, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_mma_kernel<HD><<<dim3(a.Sq / TILE, a.H, B), THREADS, smem_dq, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_mma_kernel<HD, BQ2><<<dim3(a.Skv / TILE, a.Kh, B), THREADS, smem_kv, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_simt(const Args& a, int B, cudaStream_t stream) {
  dq_simt_kernel<T, HD><<<dim3((a.Sq + ROWS - 1) / ROWS, a.H, B), THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_simt_kernel<T, HD><<<dim3((a.Skv + ROWS - 1) / ROWS, a.Kh, B), THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(void* const* ptrs, const long long* st, int B, int H, int Kh, int Sq, int Skv, int hd, int causal,
           int use_mma, float scale, void* stream_) {
  if (B <= 0 || Kh <= 0 || H % Kh || Sq <= 0 || Skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = ptrs[0];
  a.k = ptrs[1];
  a.v = ptrs[2];
  a.o = ptrs[3];
  a.dO = ptrs[4];
  a.lse = static_cast<const float*>(ptrs[5]);
  a.D = static_cast<float*>(ptrs[6]);
  a.dq = ptrs[7];
  a.dk = ptrs[8];
  a.dv = ptrs[9];
  Strides* s[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.H = H;
  a.Kh = Kh;
  a.Sq = Sq;
  a.Skv = Skv;
  a.causal = causal;
  a.scale = scale;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (use_mma) {
    if (sizeof(T) != 2 || Sq % TILE || Skv % TILE) return static_cast<int>(cudaErrorInvalidValue);
    switch (hd) {
      case 16: return launch_mma<16>(a, B, stream);
      case 32: return launch_mma<32>(a, B, stream);
      case 64: return launch_mma<64>(a, B, stream);
      case 128: return launch_mma<128>(a, B, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (hd) {
    case 16: return launch_simt<T, 16>(a, B, stream);
    case 32: return launch_simt<T, 32>(a, B, stream);
    case 64: return launch_simt<T, 64>(a, B, stream);
    case 128: return launch_simt<T, 128>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// ptrs: 10 device pointers, q, k, v, o, dO (the input dtype), lse (fp32,
// (B, H, Sq)), D (fp32 scratch, (B, H, Sq)), dq, dk, dv (the input dtype).
// strides: 24 int64 values, (batch, head, seq) for q, k, v, o, dO, dq, dk
// and dv in turn.  use_mma: the tensor-core design (bf16 only; Sq and Skv
// multiples of 64, every stride a multiple of 8, 16-byte aligned tensors).
int repro_flash_attention_bwd_f32(void* const* ptrs, const long long* strides, int B, int H, int Kh, int Sq,
                                  int Skv, int hd, int causal, int use_mma, float scale, void* stream) {
  if (use_mma) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(ptrs, strides, B, H, Kh, Sq, Skv, hd, causal, 0, scale, stream);
}

int repro_flash_attention_bwd_bf16(void* const* ptrs, const long long* strides, int B, int H, int Kh, int Sq,
                                   int Skv, int hd, int causal, int use_mma, float scale, void* stream) {
  return launch<bf16>(ptrs, strides, B, H, Kh, Sq, Skv, hd, causal, use_mma, scale, stream);
}

const char* repro_flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
