// Tensor-core flash-attention forward for Hopper (sm_90a): online softmax
// over KV tiles, bf16 q/k/v, fp32 scores and carry.  Query/key heads of
// width HDQK, value and output heads of width HDV: equal at 16-128, and
// (192, 128) for latent attention's prefill (models/mla.py: 128 + 64 rope
// query/key dims, 128 value dims).
//
// Replaces the JAX package's kernels/flash_attention.py::flash_attention_fwd
// (Pallas TPU, _kernel) for bf16 calls whose tile and strides the design can
// run (flash_attention.py::design); fp32 and the other tiles keep
// flash_attention.cu.  The TPU kernel runs two dot_generals per KV tile on
// the MXU with the m/l/acc carry in VMEM across a sequential grid axis.
// Here one block owns one (query tile, query head, batch row) and walks the
// KV tiles itself:
//
// - one consumer warpgroup per 64 query rows (block_q = 64 or 128) and a
//   producer warpgroup, the last, whose first thread loads the block's Q
//   tile once and then streams (block_kv, hd) K and V tiles through a ring
//   of shared-memory stages with TMA (4-D tensor maps that carry the
//   tensors' strides, so q may be the transposed view ops.flash_attention
//   hands in); "full" mbarriers count the landed bytes, "empty" ones the
//   consumer warps done with a stage.  GQA: head h reads KV head h / (H / Kh).
// - S = Q K^T is a wgmma m64n(block_kv)k16 from shared memory (K is the
//   K-major B operand) with fp32 accumulators; S is scaled by 1/sqrt(hd)
//   in fp32 after the product (times log2 e, for exp2).
// - the online softmax runs in registers: each thread holds two rows'
//   share of the accumulator fragment, and a row's max and sum are reduced
//   over the 4 threads of its quad with shuffles.  Same rules as the TPU
//   kernel: -1e30 in masked slots, top-left causal mask qi >= kj on the
//   tiles that reach the diagonal, tiles wholly in the future skipped,
//   rows with l == 0 give 0.
// - O += P V is a wgmma m64n(hd)k16 with P from registers (the score
//   fragment as bf16 pairs is the A fragment as it stands) and V from
//   shared memory as an MN-major B operand (the transpose bit).  Each
//   warpgroup waits for its own products (a P V left in flight across the
//   next S product made ptxas serialize every wgmma, C7515); the two
//   warpgroups' products and softmaxes interleave on the SM instead.  A
//   stage is released once both products that read it are done.
// - the output is written from registers in q's layout (any strides);
//   when lse is not null, each row's logsumexp of the scaled scores too
//   (m carries log2 units here: m ln 2 + log l; +inf where l is 0), for
//   the backward (flash_attention_bwd.cu).
//
// P in bf16 is the one numerical change against the plain version, whose
// P V is fp32 (l sums the unrounded p).  One rounding of P (2^-9) moves
// outputs by a bf16 step often enough to break the kernel-vs-plain limit
// at qwen2-7b's prefill shape, so P is split into a bf16 hi and a bf16 lo
// part and P V is two wgmmas (P to about 2^-17; a third more tensor-core
// work than one; scripts/probe_wgmma_shares.py times a copy without the lo
// part).
//
// What bounds it: causal prefill at qwen2-7b's shape (2048 tokens, head
// dim 128) does about 900 FLOP per byte of q/k/v/o it must move, so it is
// bound by the tensor cores' 989 TFLOP/s; both
// products run on them, and the softmax's exp2 on the SFU overlaps the
// other warpgroup's products.  Query tiles start heaviest first (the causal
// mask makes tile i read i + 1 KV tiles).  Not done here (later work): an
// intra-warpgroup overlap of softmax and the next S product (it needs a
// second score tile in registers), a persistent grid.
//
// C interface (bound with ctypes): returns a cudaError_t code, 0 on
// success.  Strides are in elements; the last dim is contiguous.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;

struct Strides {
  long long b, h, s;
};

template <int HDQK, int HDV, int BKV>
__global__ void __launch_bounds__(384, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o, float* __restrict__ lse,
                   Strides os, int H,
                   int Kh, int Skv, int block_q, int stages, int causal, float scale_log2) {
  // q/k and v tiles share one swizzle, so a 16-column chunk of either sits
  // at the same place in its SW-byte rows
  static_assert(hopper::swizzle_bytes(HDQK) == hopper::swizzle_bytes(HDV), "q/k and v swizzles differ");
  constexpr int SW = hopper::swizzle_bytes(HDQK), CC = SW / 2;
  constexpr int K_BYTES = hopper::round_up(BKV * HDQK * 2, 1024);
  constexpr int V_BYTES = hopper::round_up(BKV * HDV * 2, 1024);
  constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const int q_bytes = hopper::round_up(block_q * HDQK * 2, 1024);
  unsigned char* qs = smem;
  unsigned char* ring = smem + q_bytes;  // stage s: K at ring + s STAGE_BYTES, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + stages * STAGE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + stages;

  const int wg = threadIdx.x / 128;
  const int n_consumers = blockDim.x / 128 - 1;
  // heaviest query tiles first: under the causal mask tile i reads i + 1 KV
  // tiles, and the last blocks to start should be short ones
  const int q_start = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * block_q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int n_kv = causal ? min(Skv / BKV, (q_start + block_q - 1) / BKV + 1) : Skv / BKV;

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
      hopper::prefetch_map(&map_k);
      hopper::prefetch_map(&map_v);
      hopper::mbar_expect_tx(q_full, static_cast<uint32_t>(block_q * HDQK * 2));
#pragma unroll
      for (int ch = 0; ch < HDQK / CC; ++ch)
        hopper::tma_load_4d(qs + ch * block_q * SW, &map_q, q_full, ch * CC, q_start, h, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % stages;
        if (t >= stages) hopper::mbar_wait(&empty[s], ((t / stages) - 1) & 1);
        unsigned char* ks = ring + s * STAGE_BYTES;
        unsigned char* vs = ks + K_BYTES;
        hopper::mbar_expect_tx(&full[s], static_cast<uint32_t>(BKV * (HDQK + HDV) * 2));
#pragma unroll
        for (int ch = 0; ch < HDQK / CC; ++ch)
          hopper::tma_load_4d(ks + ch * BKV * SW, &map_k, &full[s], ch * CC, t * BKV, kvh, b);
#pragma unroll
        for (int ch = 0; ch < HDV / CC; ++ch)
          hopper::tma_load_4d(vs + ch * BKV * SW, &map_v, &full[s], ch * CC, t * BKV, kvh, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int t_id = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    const int row_base = q_start + wg * 64;  // this warpgroup's first query row
    float oacc[HDV / 2];
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) oacc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    hopper::mbar_wait(q_full, 0);
    for (int t = 0; t < n_kv; ++t) {
      const int s = t % stages;
      const int kv_start = t * BKV;
      const unsigned char* ks = ring + s * STAGE_BYTES;
      const unsigned char* vs = ks + K_BYTES;
      hopper::mbar_wait(&full[s], (t / stages) & 1);

      // S = Q K^T
      float sacc[BKV / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDQK / 16; ++kk) {
        const int chunk = kk * 16 / CC, inner = (kk * 16 % CC) * 2;
        const uint64_t dq = hopper::desc(qs + chunk * block_q * SW + wg * 64 * SW + inner, 16, 8 * SW, SW);
        const uint64_t dk = hopper::desc(ks + chunk * BKV * SW + inner, 16, 8 * SW, SW);
        if (kk == 0) {
          hopper::Wgmma<BKV>::template ss_overwrite<0>(sacc, dq, dk);
        } else {
          hopper::Wgmma<BKV>::template ss<0>(sacc, dq, dk, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);

      // online softmax on this thread's two rows (r and r + 8)
      // (on tiles that reach the diagonal the masked slots are scaled scores
      // -1e30 as in the plain version; elsewhere the scale is applied inside
      // the exponent below, and the row max of the raw scores, times the
      // positive scale, is the row max of the scaled ones)
      const bool mask = causal && kv_start + BKV - 1 > row_base;
      float mx[2] = {NEG_INF, NEG_INF};
      if (mask) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          float x = sacc[i] * scale_log2;
          if (row_base + hopper::acc_row(t_id, i) < kv_start + hopper::acc_col(t_id, i)) x = NEG_INF;
          sacc[i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
        mx[0] *= scale_log2;
        mx[1] *= scale_log2;
      }
      const float sl2 = mask ? 1.f : scale_log2;  // what still multiplies sacc
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = hopper::exp2_approx(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const float p = hopper::exp2_approx(fmaf(sacc[i], sl2, -m[(i >> 1) & 1]));
        sacc[i] = p;
        sum[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int i = 0; i < HDV / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
      hopper::fence_regs(oacc);  // the rescale stays before the fence below

      // O += P V, P from registers: the k16 chunk c of S is the A fragment
      uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hopper::split_bf16(sacc[8 * c + 2 * j], sacc[8 * c + 2 * j + 1], ph[c][j], pl[c][j]);
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c) {
        hopper::fence_regs(ph[c]);
        hopper::fence_regs(pl[c]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c) {
        const uint64_t dv = hopper::desc(vs + c * 16 * SW, BKV * SW, 8 * SW, SW);
        hopper::Wgmma<HDV>::template rs<1>(oacc, ph[c], dv, 1);
        hopper::Wgmma<HDV>::template rs<1>(oacc, pl[c], dv, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);  // both products that read this stage are done
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);  // fully masked rows give 0
    if (lse != nullptr && t_id % 4 == 0) {
      float* lrow = lse + (static_cast<long long>(b) * H + h) * (gridDim.x * block_q) + row_base;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lrow[hopper::acc_row(t_id, 2 * r)] = l[r] == 0.f ? __int_as_float(0x7f800000) : fmaf(m[r], LN2, logf(l[r]));
    }
    bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int i = 0; i < HDV / 2; i += 2) {
      const long long row = row_base + hopper::acc_row(t_id, i);
      const int col = hopper::acc_col(t_id, i);
      const float f = inv[(i >> 1) & 1];
      *reinterpret_cast<uint32_t*>(ob + row * os.s + col) = hopper::pack_bf16(oacc[i] * f, oacc[i + 1] * f);
    }
  }
}

template <int HDQK, int HDV, int BKV>
int launch_tile(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o, float* lse, Strides os,
                int B, int H, int Kh, int Sq, int Skv, int block_q, int stages, int causal, float scale_log2,
                void* stream) {
  auto kernel = flash_wgmma_kernel<HDQK, HDV, BKV>;
  const size_t smem = 1024 + hopper::round_up(block_q * HDQK * 2, 1024) +
                      static_cast<size_t>(stages) *
                          (hopper::round_up(BKV * HDQK * 2, 1024) + hopper::round_up(BKV * HDV * 2, 1024)) +
                      8 * (1 + 2 * stages);
  // The attribute is the block's limit, not this launch's need: the tuner launches one
  // kernel at several tiles from several threads, and a per-launch value set by one
  // thread would refuse another thread's larger launch ("invalid argument").
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, hopper::BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Sq / block_q, H, B);
  dim3 block((block_q / 64 + 1) * 128);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(mq, mk, mv, static_cast<bf16*>(o), lse, os, H, Kh,
                                                                    Skv, block_q, stages, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int HDQK, int HDV>
int launch_hd(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o, float* lse, Strides os, int B,
              int H, int Kh, int Sq, int Skv, int block_q, int block_kv, int stages, int causal,
              float scale_log2, void* stream) {
  switch (block_kv) {
    case 16: return launch_tile<HDQK, HDV, 16>(mq, mk, mv, o, lse, os, B, H, Kh, Sq, Skv, block_q, stages, causal, scale_log2, stream);
    case 32: return launch_tile<HDQK, HDV, 32>(mq, mk, mv, o, lse, os, B, H, Kh, Sq, Skv, block_q, stages, causal, scale_log2, stream);
    case 64: return launch_tile<HDQK, HDV, 64>(mq, mk, mv, o, lse, os, B, H, Kh, Sq, Skv, block_q, stages, causal, scale_log2, stream);
    case 128: return launch_tile<HDQK, HDV, 128>(mq, mk, mv, o, lse, os, B, H, Kh, Sq, Skv, block_q, stages, causal, scale_log2, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: (B, H, Sq, hd); k: (B, Kh, Skv, hd); v: (B, Kh, Skv, hd_v); o: (B, H,
// Sq, hd_v), bf16.  strides: 12 int64 values, (batch, head, seq) for q, k,
// v and o in turn, each a multiple of 8 elements.  block_q 64 or 128,
// block_kv 16, 32, 64 or 128, (hd, hd_v) (16, 16), (32, 32), (64, 64),
// (128, 128) or (192, 128); `stages` ring stages of K and V tiles.  lse:
// (B, H, Sq) fp32, written when not null.
int repro_flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                                     int Kh, int Sq, int Skv, int hd, int hd_v, const long long* strides,
                                     int block_q, int block_kv, int stages, int causal, float scale,
                                     void* stream) {
  if ((block_q != 64 && block_q != 128) || Sq % block_q || block_kv <= 0 || Skv % block_kv || Kh <= 0 ||
      H % Kh || stages < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides os{strides[9], strides[10], strides[11]};
  const int sw = hopper::swizzle_bytes(hd);
  if (int rc = hopper::bind_context()) return rc;
  CUtensorMap mq, mk, mv;
  const long long q_dims[4] = {hd, Sq, H, B}, q_strides[3] = {strides[2], strides[1], strides[0]};
  const long long k_dims[4] = {hd, Skv, Kh, B}, k_strides[3] = {strides[5], strides[4], strides[3]};
  const long long v_dims[4] = {hd_v, Skv, Kh, B}, v_strides[3] = {strides[8], strides[7], strides[6]};
  if (hopper::swizzle_bytes(hd_v) != sw) return static_cast<int>(cudaErrorInvalidValue);
  int rc = hopper::make_map(&mq, q, 4, q_dims, q_strides, sw / 2, block_q, sw);
  if (rc) return rc;
  rc = hopper::make_map(&mk, k, 4, k_dims, k_strides, sw / 2, block_kv, sw);
  if (rc) return rc;
  rc = hopper::make_map(&mv, v, 4, v_dims, v_strides, sw / 2, block_kv, sw);
  if (rc) return rc;
  const float scale_log2 = scale * LOG2E;
  if (hd == 192 && hd_v == 128)
    return launch_hd<192, 128>(mq, mk, mv, o, lse, os, B, H, Kh, Sq, Skv, block_q, block_kv, stages, causal, scale_log2, stream);
  if (hd != hd_v) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_hd<16, 16>(mq, mk, mv, o, lse, os, B, H, Kh, Sq, Skv, block_q, block_kv, stages, causal, scale_log2, stream);
    case 32: return launch_hd<32, 32>(mq, mk, mv, o, lse, os, B, H, Kh, Sq, Skv, block_q, block_kv, stages, causal, scale_log2, stream);
    case 64: return launch_hd<64, 64>(mq, mk, mv, o, lse, os, B, H, Kh, Sq, Skv, block_q, block_kv, stages, causal, scale_log2, stream);
    case 128: return launch_hd<128, 128>(mq, mk, mv, o, lse, os, B, H, Kh, Sq, Skv, block_q, block_kv, stages, causal, scale_log2, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_flash_attention_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
