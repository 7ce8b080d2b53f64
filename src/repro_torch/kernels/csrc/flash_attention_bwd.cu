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
// Every output element is written once, so two calls on the same inputs
// give bit-identical gradients (no atomics):
//
// - dq pass: one block per (query tile, query head, batch row).  Its
//   prologue computes D for its rows (written to a scratch buffer for the
//   next pass); it walks the KV tiles up to the causal bound, recomputing S
//   and dP, and accumulates dQ.
// - dK/dV pass: one block per (KV tile, KV head, batch row, head split).
//   It walks its split's query heads of the group and the query tiles the
//   causal mask lets reach the tile, recomputing S^T and dP^T, and
//   accumulates dK and dV over those heads.
//
// That recomputes S and dP twice: 7 products per (query, key) pair against
// the 5 of FA-2 with an atomic dQ.  Causal masking keeps qi >= kj aligned
// top-left, as the forward kernels do; the oracle aligns bottom-right, and
// the two agree for Sq == Skv, which is every call the models make.
//
// Two designs (flash_attention.py::bwd_design):
// - "wgmma" (bf16, Sq and Skv multiples of 64, 16-byte rows and starts):
//   three launches a call.  Both passes are warp-specialised like the
//   forward (flash_attention_wgmma.cu): the last warpgroup's first thread
//   loads the block's fixed tiles once and streams the others through a
//   ring of shared-memory stages with TMA (4-D tensor maps that carry the
//   strides; "full" mbarriers count the landed bytes, "empty" ones the
//   consumer warps done with a stage); one or two consumer warpgroups of 64
//   rows each run every product on wgmma with fp32 accumulators:
//     dq pass (Q and dO fixed, K and V streamed, 64 keys a stage):
//       S = Q K^T, dP = dO V^T (A and B K-major from shared memory);
//       dS = P * (dP - D) in registers, rounded to bf16 as the A fragment;
//       dQ += dS K (B = K MN-major).
//     dK/dV pass (K and V fixed, Q, dO and the tile's lse and D streamed,
//     64 queries a stage, lse and D by a 1-D bulk copy):
//       S^T = K Q^T, dP^T = V dO^T; P^T and dS^T in registers;
//       dV += P^T dO and dK += dS^T Q (A from registers, B MN-major).
//   P and dS are rounded to bf16 once, as the plain version repeats.  A
//   consumer skips the products of a streamed tile that the causal mask
//   hides from all its rows (it still releases the stage).  Under the
//   causal mask the KV tiles with the most query tiles, and the query
//   tiles with the most KV tiles, start first.
//   Head split: when B * Kh * (Skv / tile) blocks do not fill the SMs,
//   the g query heads of a group are split over `splits` blocks
//   (flash_attention.py::bwd_head_splits).  Every dK/dV block writes fp32
//   partials (splits, B, Kh, Skv, hd); the third launch sums them in split
//   order, scales dK and writes dk and dv in their dtype and strides.  It
//   runs at every split count, so a call is always three kernels.
// - "simt" (fp32, and every other shape): 8 threads a row, the dot
//   products reduced over them with shuffles, the streamed rows staged in
//   shared memory as fp32; bf16 inputs round P and dS as the "wgmma" design
//   does.  Any Sq and Skv.  Two launches a call.
//
// What bounds it: five products of 2 hd FLOP per pair make it compute-bound
// at every trained shape (the split pays two extra products).  Not done
// here (later work): overlapping one warpgroup's elementwise work with its
// own next products, a persistent grid.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success.  Strides are in elements; the last dim is contiguous.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BLOCK_SMEM = hopper::BLOCK_SMEM;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 128;
constexpr int TILE = 64;  // rows of a streamed tile (flash_attention.py BWD_TILE)
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;

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
  float* D;          // (B, H, Sq) scratch: the dq pass writes it, the dK/dV pass reads it
  void* dq;
  void* dk;
  void* dv;
  float* dk_part;    // (splits, B, Kh, Skv, hd) fp32 scratch of the wgmma design
  float* dv_part;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int B, H, Kh, Sq, Skv, causal, splits;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }
// x rounded to T, as a tensor-core operand of type T would hold it
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

// =========================================================== "wgmma" design
// Shared memory: `fixed` tiles of `rows` x HD loaded once, then `stages`
// stages of two streamed TILE x HD tiles, each rounded up to the 128-byte
// swizzle's 1024-byte period (hopper.cuh), then (dK/dV pass) each stage's
// lse and D rows, then the mbarriers; 1024 bytes to align the start.
template <int HD>
__host__ __device__ constexpr int tile_bytes(int rows) { return hopper::round_up(rows * HD * 2, 1024); }

// D and lse (log2 units) of this thread's two rows (row_base + r_lo and
// + 8; the 4 threads of a quad share them): each thread sums HD / 4
// columns of dO * O, then two shuffles.  The quad's first thread writes D.
template <int HD>
__device__ __forceinline__ void rows_d_lse(const Args& a, int b, int h, int row_base, int t_id, float (&Dr)[2],
                                           float (&L2)[2]) {
  const int r_lo = hopper::acc_row(t_id, 0), c0 = (t_id % 4) * (HD / 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = row_base + r_lo + 8 * r;
    const __nv_bfloat162* orow = reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const bf16*>(a.o) + b * a.os.b + h * a.os.h + row * a.os.s + c0);
    const __nv_bfloat162* drow = reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const bf16*>(a.dO) + b * a.dos.b + h * a.dos.h + row * a.dos.s + c0);
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const float2 of = __bfloat1622float2(orow[c]), df = __bfloat1622float2(drow[c]);
      d = fmaf(df.x, of.x, d);
      d = fmaf(df.y, of.y, d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    const long long gi = (static_cast<long long>(b) * a.H + h) * a.Sq + row;
    if (t_id % 4 == 0) a.D[gi] = d;
    Dr[r] = d;
    L2[r] = a.lse[gi] * LOG2E;
  }
}

// The accumulator fragment (fp32, m64nNk16 layout) as the A fragments of
// the next product's k16 chunks, rounded to bf16 pairs.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&dst)[N / 16][4], const float (&acc)[N / 2]) {
#pragma unroll
  for (int c = 0; c < N / 16; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[c][j] = hopper::pack_bf16(acc[8 * c + 2 * j], acc[8 * c + 2 * j + 1]);
    hopper::fence_regs(dst[c]);
  }
}

// One block per (query tile of block_q = 64 n_consumers rows, query head,
// batch row); block index order puts the query tiles that read the most KV
// tiles first under the causal mask.
template <int HD>
__global__ void __launch_bounds__(384, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                const Args a, int block_q, int stages) {
  constexpr int SW = hopper::swizzle_bytes(HD), CC = SW / 2, BKV = TILE;
  constexpr int KV_BYTES = tile_bytes<HD>(BKV);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const int q_bytes = tile_bytes<HD>(block_q);
  unsigned char* qs = smem;
  unsigned char* dos = qs + q_bytes;
  unsigned char* ring = dos + q_bytes;  // stage s: K at ring + 2 s KV_BYTES, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + stages * 2 * KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + stages;

  const int wg = threadIdx.x / 128;
  const int n_consumers = blockDim.x / 128 - 1;
  const int n_qt = a.Sq / block_q, rest = a.H * a.B;
  const int qt = a.causal ? n_qt - 1 - static_cast<int>(blockIdx.x) / rest : static_cast<int>(blockIdx.x) / rest;
  const int h = blockIdx.x % rest % a.H, b = blockIdx.x % rest / a.H;
  const int q0 = qt * block_q, kvh = h / (a.H / a.Kh);
  const int n_kv = a.causal ? min(a.Skv / BKV, (q0 + block_q - 1) / BKV + 1) : a.Skv / BKV;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * n_consumers);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == n_consumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == n_consumers * 128) {
      hopper::prefetch_map(&map_q);
      hopper::prefetch_map(&map_do);
      hopper::prefetch_map(&map_k);
      hopper::prefetch_map(&map_v);
      hopper::mbar_expect_tx(q_full, static_cast<uint32_t>(2 * block_q * HD * 2));
#pragma unroll
      for (int ch = 0; ch < HD / CC; ++ch) {
        hopper::tma_load_4d(qs + ch * block_q * SW, &map_q, q_full, ch * CC, q0, h, b);
        hopper::tma_load_4d(dos + ch * block_q * SW, &map_do, q_full, ch * CC, q0, h, b);
      }
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % stages;
        if (t >= stages) hopper::mbar_wait(&empty[s], ((t / stages) - 1) & 1);
        unsigned char* ks = ring + s * 2 * KV_BYTES;
        unsigned char* vs = ks + KV_BYTES;
        hopper::mbar_expect_tx(&full[s], static_cast<uint32_t>(2 * BKV * HD * 2));
#pragma unroll
        for (int ch = 0; ch < HD / CC; ++ch) {
          hopper::tma_load_4d(ks + ch * BKV * SW, &map_k, &full[s], ch * CC, t * BKV, kvh, b);
          hopper::tma_load_4d(vs + ch * BKV * SW, &map_v, &full[s], ch * CC, t * BKV, kvh, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int t_id = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    const int row_base = q0 + wg * 64;  // this warpgroup's first query row
    const float c = a.scale * LOG2E;
    float Dr[2], L2[2];
    rows_d_lse<HD>(a, b, h, row_base, t_id, Dr, L2);
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

    hopper::mbar_wait(q_full, 0);
    for (int t = 0; t < n_kv; ++t) {
      const int s = t % stages;
      const int kv0 = t * BKV;
      const unsigned char* ks = ring + s * 2 * KV_BYTES;
      const unsigned char* vs = ks + KV_BYTES;
      hopper::mbar_wait(&full[s], (t / stages) & 1);
      if (!(a.causal && kv0 > row_base + 63)) {  // else every key of the tile is in this warpgroup's future
        // S = Q K^T and dP = dO V^T
        float sacc[BKV / 2], dp[BKV / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int chunk = kk * 16 / CC, inner = (kk * 16 % CC) * 2;
          const uint64_t dq_ = hopper::desc(qs + chunk * block_q * SW + wg * 64 * SW + inner, 16, 8 * SW, SW);
          const uint64_t dk_ = hopper::desc(ks + chunk * BKV * SW + inner, 16, 8 * SW, SW);
          if (kk == 0) hopper::Wgmma<BKV>::template ss_overwrite<0>(sacc, dq_, dk_);
          else hopper::Wgmma<BKV>::template ss<0>(sacc, dq_, dk_, 1);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int chunk = kk * 16 / CC, inner = (kk * 16 % CC) * 2;
          const uint64_t ddo = hopper::desc(dos + chunk * block_q * SW + wg * 64 * SW + inner, 16, 8 * SW, SW);
          const uint64_t dv_ = hopper::desc(vs + chunk * BKV * SW + inner, 16, 8 * SW, SW);
          if (kk == 0) hopper::Wgmma<BKV>::template ss_overwrite<0>(dp, ddo, dv_);
          else hopper::Wgmma<BKV>::template ss<0>(dp, ddo, dv_, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sacc);
        hopper::fence_regs(dp);
        // P = exp(S scale - lse) (0 where qi < kj), dS = P (dP - D), into sacc
        const bool mask = a.causal && kv0 + BKV - 1 > row_base;
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int r = (i >> 1) & 1;
          float p = hopper::exp2_approx(fmaf(sacc[i], c, -L2[r]));
          if (mask && row_base + hopper::acc_row(t_id, i) < kv0 + hopper::acc_col(t_id, i)) p = 0.f;
          sacc[i] = p * (dp[i] - Dr[r]);
        }
        // dQ += dS K, dS from registers
        uint32_t da[BKV / 16][4];
        to_a<BKV>(da, sacc);
        hopper::wgmma_fence();
#pragma unroll
        for (int ck = 0; ck < BKV / 16; ++ck)
          hopper::Wgmma<HD>::template rs<1>(dq, da[ck], hopper::desc(ks + ck * 16 * SW, BKV * SW, 8 * SW, SW), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dq);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[s]);  // every product that read this stage is done
    }
    bf16* dqb = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const long long row = row_base + hopper::acc_row(t_id, i);
      const int col = hopper::acc_col(t_id, i);
      *reinterpret_cast<uint32_t*>(dqb + row * a.dqs.s + col) = hopper::pack_bf16(dq[i] * a.scale, dq[i + 1] * a.scale);
    }
  }
}

// One block per (KV tile of block_kv = 64 n_consumers keys, KV head, head
// split, batch row); block index order puts the KV tiles that the most query
// tiles reach first under the causal mask.  Writes fp32 partials.
template <int HD>
__global__ void __launch_bounds__(384, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                  const Args a, int block_kv, int stages) {
  constexpr int SW = hopper::swizzle_bytes(HD), CC = SW / 2, BQ = TILE;
  constexpr int QT_BYTES = tile_bytes<HD>(BQ);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const int kv_bytes = tile_bytes<HD>(block_kv);
  unsigned char* ks = smem;
  unsigned char* vs = ks + kv_bytes;
  unsigned char* ring = vs + kv_bytes;  // stage s: Q at ring + 2 s QT_BYTES, dO after it
  float* lsd = reinterpret_cast<float*>(ring + stages * 2 * QT_BYTES);  // stage s: lse at lsd + 2 s BQ, D after it
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(lsd + stages * 2 * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + stages;

  const int wg = threadIdx.x / 128;
  const int n_consumers = blockDim.x / 128 - 1;
  const int rest = a.Kh * a.splits * a.B;
  const int kt = blockIdx.x / rest, r2 = blockIdx.x % rest;
  const int kvh = r2 % a.Kh, split = r2 / a.Kh % a.splits, b = r2 / (a.Kh * a.splits);
  const int kv0 = kt * block_kv;
  const int gs = a.H / a.Kh / a.splits;  // query heads this block walks
  const int h_first = kvh * (a.H / a.Kh) + split * gs;
  const int n_qt = a.Sq / BQ;
  // query tiles with a row qi >= kv0 (top-left causal); none when kv0 >= Sq
  const int q_first = a.causal ? min(kv0 / BQ, n_qt) : 0;
  const int per_head = n_qt - q_first;
  const int total = gs * per_head;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * n_consumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == n_consumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == n_consumers * 128) {
      hopper::prefetch_map(&map_k);
      hopper::prefetch_map(&map_v);
      hopper::prefetch_map(&map_q);
      hopper::prefetch_map(&map_do);
      hopper::mbar_expect_tx(kv_full, static_cast<uint32_t>(2 * block_kv * HD * 2));
#pragma unroll
      for (int ch = 0; ch < HD / CC; ++ch) {
        hopper::tma_load_4d(ks + ch * block_kv * SW, &map_k, kv_full, ch * CC, kv0, kvh, b);
        hopper::tma_load_4d(vs + ch * block_kv * SW, &map_v, kv_full, ch * CC, kv0, kvh, b);
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % stages;
        if (it >= stages) hopper::mbar_wait(&empty[s], ((it / stages) - 1) & 1);
        const int hh = h_first + it / per_head;
        const int q0 = (q_first + it % per_head) * BQ;
        unsigned char* qst = ring + s * 2 * QT_BYTES;
        unsigned char* dost = qst + QT_BYTES;
        hopper::mbar_expect_tx(&full[s], static_cast<uint32_t>(2 * BQ * HD * 2 + 2 * BQ * 4));
#pragma unroll
        for (int ch = 0; ch < HD / CC; ++ch) {
          hopper::tma_load_4d(qst + ch * BQ * SW, &map_q, &full[s], ch * CC, q0, hh, b);
          hopper::tma_load_4d(dost + ch * BQ * SW, &map_do, &full[s], ch * CC, q0, hh, b);
        }
        const long long row0 = (static_cast<long long>(b) * a.H + hh) * a.Sq + q0;
        hopper::bulk_load(lsd + s * 2 * BQ, a.lse + row0, BQ * 4, &full[s]);
        hopper::bulk_load(lsd + s * 2 * BQ + BQ, a.D + row0, BQ * 4, &full[s]);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int t_id = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    const int kw = kv0 + wg * 64;  // this warpgroup's first key
    const float c = a.scale * LOG2E;
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    for (int it = 0; it < total; ++it) {
      const int s = it % stages;
      const int q0 = (q_first + it % per_head) * BQ;
      const unsigned char* qst = ring + s * 2 * QT_BYTES;
      const unsigned char* dost = qst + QT_BYTES;
      const float* Ls = lsd + s * 2 * BQ;
      const float* Ds = Ls + BQ;
      hopper::mbar_wait(&full[s], (it / stages) & 1);
      if (!(a.causal && q0 + BQ - 1 < kw)) {  // else every query of the tile precedes this warpgroup's keys
        // S^T = K Q^T and dP^T = V dO^T
        float st[BQ / 2], dpt[BQ / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int chunk = kk * 16 / CC, inner = (kk * 16 % CC) * 2;
          const uint64_t dk_ = hopper::desc(ks + chunk * block_kv * SW + wg * 64 * SW + inner, 16, 8 * SW, SW);
          const uint64_t dq_ = hopper::desc(qst + chunk * BQ * SW + inner, 16, 8 * SW, SW);
          if (kk == 0) hopper::Wgmma<BQ>::template ss_overwrite<0>(st, dk_, dq_);
          else hopper::Wgmma<BQ>::template ss<0>(st, dk_, dq_, 1);
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int chunk = kk * 16 / CC, inner = (kk * 16 % CC) * 2;
          const uint64_t dv_ = hopper::desc(vs + chunk * block_kv * SW + wg * 64 * SW + inner, 16, 8 * SW, SW);
          const uint64_t ddo = hopper::desc(dost + chunk * BQ * SW + inner, 16, 8 * SW, SW);
          if (kk == 0) hopper::Wgmma<BQ>::template ss_overwrite<0>(dpt, dv_, ddo);
          else hopper::Wgmma<BQ>::template ss<0>(dpt, dv_, ddo, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);
        // P^T = exp(S^T scale - lse) (0 where qi < kj) into st, dS^T = P^T (dP^T - D) into dpt;
        // register i holds query column 8 (i / 4) + 2 (t % 4) + i % 2
        const bool mask = a.causal && q0 < kw + 63;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * (t_id % 4) + e;
            const float l2 = Ls[col] * LOG2E, dd = Ds[col];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int i = 4 * j + 2 * rr + e;
              float p = hopper::exp2_approx(fmaf(st[i], c, -l2));
              if (mask && q0 + col < kw + hopper::acc_row(t_id, i)) p = 0.f;
              st[i] = p;
              dpt[i] = p * (dpt[i] - dd);
            }
          }
        // dV += P^T dO, dK += dS^T Q: A from registers, B MN-major
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        to_a<BQ>(pa, st);
        to_a<BQ>(da, dpt);
        hopper::wgmma_fence();
#pragma unroll
        for (int ck = 0; ck < BQ / 16; ++ck) {
          hopper::Wgmma<HD>::template rs<1>(dv, pa[ck], hopper::desc(dost + ck * 16 * SW, BQ * SW, 8 * SW, SW), 1);
          hopper::Wgmma<HD>::template rs<1>(dk, da[ck], hopper::desc(qst + ck * 16 * SW, BQ * SW, 8 * SW, SW), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv);
        hopper::fence_regs(dk);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    const long long base = ((static_cast<long long>(split) * a.B + b) * a.Kh + kvh) * a.Skv;
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const long long off = (base + kw + hopper::acc_row(t_id, i)) * HD + hopper::acc_col(t_id, i);
      *reinterpret_cast<float2*>(a.dk_part + off) = make_float2(dk[i], dk[i + 1]);
      *reinterpret_cast<float2*>(a.dv_part + off) = make_float2(dv[i], dv[i + 1]);
    }
  }
}

// dk = scale * sum of the splits' dK partials, dv = sum of the dV partials,
// in split order; four elements a thread, written in bf16 with dk's and
// dv's strides.
__global__ void __launch_bounds__(256) dkdv_sum_kernel(const Args a, int hd) {
  const long long n4 = static_cast<long long>(a.B) * a.Kh * a.Skv * hd / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n4) return;
  const long long e = idx * 4, per = n4 * 4;
  const int col = static_cast<int>(e % hd);
  const long long row = e / hd % a.Skv, kvh = e / hd / a.Skv % a.Kh, b = e / hd / a.Skv / a.Kh;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < a.splits; ++s) {
    const float4 pk = *reinterpret_cast<const float4*>(a.dk_part + s * per + e);
    const float4 pv = *reinterpret_cast<const float4*>(a.dv_part + s * per + e);
    sk.x += pk.x; sk.y += pk.y; sk.z += pk.z; sk.w += pk.w;
    sv.x += pv.x; sv.y += pv.y; sv.z += pv.z; sv.w += pv.w;
  }
  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dks.b + kvh * a.dks.h + row * a.dks.s + col;
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dvs.b + kvh * a.dvs.h + row * a.dvs.s + col;
  *reinterpret_cast<uint2*>(dkp) = make_uint2(hopper::pack_bf16(sk.x * a.scale, sk.y * a.scale),
                                              hopper::pack_bf16(sk.z * a.scale, sk.w * a.scale));
  *reinterpret_cast<uint2*>(dvp) = make_uint2(hopper::pack_bf16(sv.x, sv.y), hopper::pack_bf16(sv.z, sv.w));
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
template <int HD>
int launch_wgmma(const Args& a, const CUtensorMap* maps, int block_q, int block_kv, int dq_stages, int kv_stages,
                 cudaStream_t stream) {
  const size_t smem_dq = 1024 + 2 * tile_bytes<HD>(block_q) + static_cast<size_t>(dq_stages) * 2 * tile_bytes<HD>(TILE) +
                         8 * (1 + 2 * dq_stages);
  const size_t smem_kv = 1024 + 2 * tile_bytes<HD>(block_kv) +
                         static_cast<size_t>(kv_stages) * (2 * tile_bytes<HD>(TILE) + 2 * TILE * 4) +
                         8 * (1 + 2 * kv_stages);
  if (smem_dq > static_cast<size_t>(BLOCK_SMEM) || smem_kv > static_cast<size_t>(BLOCK_SMEM))
    return static_cast<int>(cudaErrorInvalidValue);
  // The attributes are the block's limit, not this launch's need (as in flash_attention_wgmma.cu).
  cudaError_t err = cudaFuncSetAttribute(dq_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_wgmma_kernel<HD><<<(a.Sq / block_q) * a.H * a.B, (block_q / 64 + 1) * 128, smem_dq, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a, block_q, dq_stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_wgmma_kernel<HD><<<(a.Skv / block_kv) * a.Kh * a.splits * a.B, (block_kv / 64 + 1) * 128, smem_kv, stream>>>(
      maps[4], maps[5], maps[6], maps[7], a, block_kv, kv_stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = static_cast<long long>(a.B) * a.Kh * a.Skv * HD / 4;
  dkdv_sum_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, stream>>>(a, HD);
  return static_cast<int>(cudaGetLastError());
}

// The eight tensor maps of the wgmma design: the dq pass's Q and dO (boxes
// of block_q rows), K and V (TILE rows); the dK/dV pass's K and V (block_kv
// rows), Q and dO (TILE rows).  One box is one column chunk of a tile.
int make_maps(CUtensorMap* maps, const Args& a, int hd, int block_q, int block_kv) {
  const int sw = hopper::swizzle_bytes(hd);
  const long long q_dims[4] = {hd, a.Sq, a.H, a.B}, k_dims[4] = {hd, a.Skv, a.Kh, a.B};
  const long long q_st[3] = {a.qs.s, a.qs.h, a.qs.b}, do_st[3] = {a.dos.s, a.dos.h, a.dos.b};
  const long long k_st[3] = {a.ks.s, a.ks.h, a.ks.b}, v_st[3] = {a.vs.s, a.vs.h, a.vs.b};
  const void* base[8] = {a.q, a.dO, a.k, a.v, a.k, a.v, a.q, a.dO};
  const long long* dims[8] = {q_dims, q_dims, k_dims, k_dims, k_dims, k_dims, q_dims, q_dims};
  const long long* st[8] = {q_st, do_st, k_st, v_st, k_st, v_st, q_st, do_st};
  const int rows[8] = {block_q, block_q, TILE, TILE, block_kv, block_kv, TILE, TILE};
  for (int i = 0; i < 8; ++i)
    if (int rc = hopper::make_map(&maps[i], base[i], 4, dims[i], st[i], sw / 2, rows[i], sw)) return rc;
  return 0;
}

template <typename T, int HD>
int launch_simt(const Args& a, cudaStream_t stream) {
  dq_simt_kernel<T, HD><<<dim3((a.Sq + ROWS - 1) / ROWS, a.H, a.B), THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_simt_kernel<T, HD><<<dim3((a.Skv + ROWS - 1) / ROWS, a.Kh, a.B), THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(void* const* ptrs, const long long* st, int B, int H, int Kh, int Sq, int Skv, int hd, int causal,
           const int* plan, float scale, void* stream_) {
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
  a.dk_part = static_cast<float*>(ptrs[10]);
  a.dv_part = static_cast<float*>(ptrs[11]);
  Strides* s[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.B = B;
  a.H = H;
  a.Kh = Kh;
  a.Sq = Sq;
  a.Skv = Skv;
  a.causal = causal;
  a.splits = 1;
  a.scale = scale;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (plan != nullptr) {  // the wgmma design: block_q, block_kv, splits, dq stages, dK/dV stages
    const int block_q = plan[0], block_kv = plan[1], dq_stages = plan[3], kv_stages = plan[4];
    a.splits = plan[2];
    if (sizeof(T) != 2 || (block_q != 64 && block_q != 128) || (block_kv != 64 && block_kv != 128) ||
        Sq % block_q || Skv % block_kv || a.splits <= 0 || (H / Kh) % a.splits || dq_stages < 2 || kv_stages < 2 ||
        a.dk_part == nullptr || a.dv_part == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (int rc = hopper::bind_context()) return rc;
    CUtensorMap maps[8];
    if (int rc = make_maps(maps, a, hd, block_q, block_kv)) return rc;
    switch (hd) {
      case 16: return launch_wgmma<16>(a, maps, block_q, block_kv, dq_stages, kv_stages, stream);
      case 32: return launch_wgmma<32>(a, maps, block_q, block_kv, dq_stages, kv_stages, stream);
      case 64: return launch_wgmma<64>(a, maps, block_q, block_kv, dq_stages, kv_stages, stream);
      case 128: return launch_wgmma<128>(a, maps, block_q, block_kv, dq_stages, kv_stages, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (hd) {
    case 16: return launch_simt<T, 16>(a, stream);
    case 32: return launch_simt<T, 32>(a, stream);
    case 64: return launch_simt<T, 64>(a, stream);
    case 128: return launch_simt<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// ptrs: 12 device pointers, q, k, v, o, dO (the input dtype), lse (fp32,
// (B, H, Sq)), D (fp32 scratch, (B, H, Sq)), dq, dk, dv (the input dtype),
// dk_part, dv_part (fp32 scratch, (splits, B, Kh, Skv, hd); the wgmma design
// only).  strides: 24 int64 values, (batch, head, seq) for q, k, v, o, dO,
// dq, dk and dv in turn.  plan: null for the SIMT design, else the wgmma
// design's 5 ints (bf16 only; every stride a multiple of 8, 16-byte aligned
// tensors): block_q (dq pass rows, 64 or 128, dividing Sq), block_kv (dK/dV
// pass rows, 64 or 128, dividing Skv), splits (dividing H / Kh), and the
// two passes' ring stages (>= 2).
int repro_flash_attention_bwd_f32(void* const* ptrs, const long long* strides, int B, int H, int Kh, int Sq,
                                  int Skv, int hd, int causal, const int* plan, float scale, void* stream) {
  if (plan != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(ptrs, strides, B, H, Kh, Sq, Skv, hd, causal, nullptr, scale, stream);
}

int repro_flash_attention_bwd_bf16(void* const* ptrs, const long long* strides, int B, int H, int Kh, int Sq,
                                   int Skv, int hd, int causal, const int* plan, float scale, void* stream) {
  return launch<bf16>(ptrs, strides, B, H, Kh, Sq, Skv, hd, causal, plan, scale, stream);
}

const char* repro_flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
