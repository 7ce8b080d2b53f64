// Tensor-core matmul for Hopper (sm_90a): C = A @ B, bf16 in, fp32
// accumulation, bf16 out.
//
// Replaces the JAX package's kernels/matmul.py::matmul_tiled (Pallas TPU,
// _kernel) for bf16 tiles the design can run (matmul.py::design); fp32 and
// the other tiles keep matmul.cu.  The TPU kernel walks K as a sequential
// grid axis with an fp32 VMEM accumulator while the MXU multiplies and the
// next tiles are copied in.  Here one block owns one (bm, bn) output tile
// and walks K itself: a producer warp brings (bm, bk) tiles of A and
// (bk, bn) tiles of B into a ring of shared-memory stages with TMA, each
// stage guarded by a "full" mbarrier (TMA bytes landed) and an "empty" one
// (the consumers' wgmmas that read it are done); one or two consumer
// warpgroups run wgmma m64nBNk16 over their 64-row slices, the fp32
// accumulators in registers, and keep one wgmma group in flight while the
// next stage is awaited.  The epilogue rounds to bf16 from registers
// straight to device memory.
//
// Operands: A (M, K) row-major is K-major; B (K, N) row-major is MN-major
// (wgmma's transpose bit for B).  Tiles are stored in 32/64/128-byte
// swizzled column chunks (hopper.cuh).  Blocks are rastered along M first,
// so a wave of blocks shares a few column panels of B and reads all of A
// from the L2.
//
// What bounds it: at transformer FFN shapes the product does hundreds of
// FLOP per byte of device memory, so it is bound by the tensor cores'
// 989 TFLOP/s; the ring keeps loads in flight so that the tensor cores wait
// on TMA as little as the stage count allows.  Not done here (later work):
// a persistent grid that overlaps one tile's epilogue with the next tile's
// loads.  (Two CTAs of a cluster sharing each B tile by TMA multicast, which
// halves B's L2 traffic, ran slower at every tile it applied to, so the L2
// is not what holds this design back.)
//
// C interface (bound with ctypes): returns a cudaError_t code, 0 on
// success.  The wrapper picks the tile and the stage count and checks them.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;

// BN: the tile's width (the wgmma N); MS: 64-row slices per consumer
// warpgroup.  The block has bm / (64 MS) consumer warpgroups and one
// producer warpgroup, the last.
template <int BN, int MS>
__global__ void __launch_bounds__(384, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                    bf16* __restrict__ c, int N, int K, int bm, int bk, int stages, int a_bytes,
                    int b_bytes) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const int stage_bytes = a_bytes + b_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* empty = full + stages;

  const int wg = threadIdx.x / 128;
  const int n_consumers = blockDim.x / 128 - 1;
  const int nk = K / bk;
  const int m0 = blockIdx.x * bm;
  const int n0 = blockIdx.y * BN;
  const int swa = hopper::swizzle_bytes(bk), cca = swa / 2;
  constexpr int SWB = hopper::swizzle_bytes(BN), CCB = SWB / 2;

  if (threadIdx.x == 0) {
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
      hopper::prefetch_map(&map_a);
      hopper::prefetch_map(&map_b);
      const uint32_t tx = static_cast<uint32_t>((bm * bk + bk * BN) * 2);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % stages;
        if (kt >= stages) hopper::mbar_wait(&empty[s], ((kt / stages) - 1) & 1);
        unsigned char* as = smem + s * stage_bytes;
        unsigned char* bs = as + a_bytes;
        hopper::mbar_expect_tx(&full[s], tx);
        for (int ch = 0; ch < bk / cca; ++ch)
          hopper::tma_load_2d(as + ch * bm * swa, &map_a, &full[s], kt * bk + ch * cca, m0);
#pragma unroll
        for (int ch = 0; ch < BN / CCB; ++ch)
          hopper::tma_load_2d(bs + ch * bk * SWB, &map_b, &full[s], n0 + ch * CCB, kt * bk);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128;
    const int lane = threadIdx.x % 32;
    float acc[MS][BN / 2];
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[ms][i] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % stages;
      hopper::mbar_wait(&full[s], (kt / stages) & 1);
      const unsigned char* as = smem + s * stage_bytes;
      const unsigned char* bs = as + a_bytes;
      hopper::wgmma_fence();
      for (int kk = 0; kk < bk / 16; ++kk) {
        const int chunk = kk * 16 / cca, inner = (kk * 16 % cca) * 2;
        const uint64_t db = hopper::desc(bs + kk * 16 * SWB, bk * SWB, 8 * SWB, SWB);
#pragma unroll
        for (int ms = 0; ms < MS; ++ms) {
          const int row0 = (wg * MS + ms) * 64;
          const uint64_t da = hopper::desc(as + chunk * bm * swa + row0 * swa + inner, 16, 8 * swa, swa);
          hopper::Wgmma<BN>::template ss<1>(acc[ms], da, db, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous stage's products are done
      if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % stages]);
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int ms = 0; ms < MS; ++ms) {
      hopper::fence_regs(acc[ms]);
      const long long row0 = m0 + (wg * MS + ms) * 64;
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const long long row = row0 + hopper::acc_row(t, i);
        const int col = n0 + hopper::acc_col(t, i);
        *reinterpret_cast<uint32_t*>(c + row * N + col) = hopper::pack_bf16(acc[ms][i], acc[ms][i + 1]);
      }
    }
  }
}

template <int BN, int MS>
int launch_bn(const CUtensorMap& ma, const CUtensorMap& mb, void* c, int M, int N, int K, int bm, int bk,
              int stages, int a_bytes, int b_bytes, size_t smem, void* stream) {
  auto kernel = matmul_wgmma_kernel<BN, MS>;
  // The attribute is the block's limit, not this launch's need: the tuner launches one
  // kernel at several tiles from several threads, and a per-launch value set by one
  // thread would refuse another thread's larger launch ("invalid argument").
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, hopper::BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(M / bm, N / BN);
  dim3 block((bm / (64 * MS) + 1) * 128);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(ma, mb, static_cast<bf16*>(c), N, K, bm,
                                                                    bk, stages, a_bytes, b_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <int MS>
int launch_ms(const CUtensorMap& ma, const CUtensorMap& mb, void* c, int M, int N, int K, int bm, int bn,
              int bk, int stages, int a_bytes, int b_bytes, size_t smem, void* stream) {
  switch (bn) {
    case 16: return launch_bn<16, MS>(ma, mb, c, M, N, K, bm, bk, stages, a_bytes, b_bytes, smem, stream);
    case 32: return launch_bn<32, MS>(ma, mb, c, M, N, K, bm, bk, stages, a_bytes, b_bytes, smem, stream);
    case 64: return launch_bn<64, MS>(ma, mb, c, M, N, K, bm, bk, stages, a_bytes, b_bytes, smem, stream);
    case 128: return launch_bn<128, MS>(ma, mb, c, M, N, K, bm, bk, stages, a_bytes, b_bytes, smem, stream);
    case 256:
      if (MS == 1) return launch_bn<256, 1>(ma, mb, c, M, N, K, bm, bk, stages, a_bytes, b_bytes, smem, stream);
      return static_cast<int>(cudaErrorInvalidValue);  // 256 accumulators a thread
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// a: (M, K), b: (K, N), c: (M, N), all bf16 row-major.  bm in {64, 128,
// 256}, bn a power of two from 16 to 256, bk 16, 32 or a multiple of 64 up
// to 256 (whole swizzle rows of A);
// `stages` ring stages of round_up(2 bm bk, 1024) + round_up(2 bk bn, 1024)
// bytes each.
int repro_matmul_wgmma_bf16(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn,
                            int bk, int stages, void* stream) {
  if (bm % 64 || bm > 256 || bn < 16 || bn > 256 || (bn & (bn - 1)) || (bk != 16 && bk != 32 && bk % 64) ||
      bk > 256 || M % bm || N % bn || K % bk || stages < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ms = bm > 128 ? 2 : 1;
  const int swa = hopper::swizzle_bytes(bk), swb = hopper::swizzle_bytes(bn);
  const int a_bytes = hopper::round_up(bm * bk * 2, 1024);
  const int b_bytes = hopper::round_up(bk * bn * 2, 1024);
  const size_t smem = 1024 + static_cast<size_t>(stages) * (a_bytes + b_bytes + 16);
  if (int rc = hopper::bind_context()) return rc;
  CUtensorMap ma, mb;
  const long long a_dims[2] = {K, M}, a_strides[1] = {K};
  const long long b_dims[2] = {N, K}, b_strides[1] = {N};
  int rc = hopper::make_map(&ma, a, 2, a_dims, a_strides, swa / 2, bm, swa);
  if (rc) return rc;
  rc = hopper::make_map(&mb, b, 2, b_dims, b_strides, swb / 2, bk, swb);
  if (rc) return rc;
  return ms == 1 ? launch_ms<1>(ma, mb, c, M, N, K, bm, bn, bk, stages, a_bytes, b_bytes, smem, stream)
                 : launch_ms<2>(ma, mb, c, M, N, K, bm, bn, bk, stages, a_bytes, b_bytes, smem, stream);
}

const char* repro_matmul_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
