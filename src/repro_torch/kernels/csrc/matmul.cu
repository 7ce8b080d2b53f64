// Tiled matmul for Hopper (sm_90a): C = A @ B with fp32 accumulation.
//
// Replaces the JAX package's kernels/matmul.py::matmul_tiled (Pallas TPU,
// _kernel).  There the K dimension is a sequential grid axis carrying an
// fp32 VMEM accumulator from one grid step to the next; blocks on a GPU run
// in no order, so here each thread block owns one (bm, bn) output tile and
// loops over K in bk steps itself, with nothing carried between blocks.
//
// Per K step the block stages an (bm, bk) tile of A (transposed, one padding
// element per row so that the strided smem writes spread over the banks)
// and a (bk, bn) tile of B in shared memory.  Each thread keeps a 4x4
// micro-tile of fp32 accumulators in registers: rows ty + (bm/4)*i and
// columns tx + (bn/4)*j, so a warp reads neighbouring B columns and one
// broadcast A value per step.  The block has (bm/4)*(bn/4) threads.
//
// What bounds it: at the shapes of a transformer FFN the product is
// compute-bound on the card (hundreds of FLOP per byte of HBM traffic), but
// this simple kernel does its FMAs on the CUDA cores from shared memory, so
// it runs far below the tensor-core peak.  wgmma, TMA and pipelining are
// later work; tiles the design cannot run are refused by the Python wrapper
// before launch.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success.  Launches go on the stream the caller passes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_SMEM = 232448;  // shared memory one block may use on Hopper (227 KB)

constexpr int TM = 4;  // accumulator rows per thread
constexpr int TN = 4;  // accumulator columns per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Padding of each row of the transposed A tile, in elements: one 32-bit
// word, so consecutive rows start on different banks.
template <typename T> __host__ __device__ constexpr int a_pad() { return sizeof(T) == 2 ? 2 : 1; }

template <typename T>
__global__ void __launch_bounds__(1024)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
              int M, int N, int K, int bm, int bn, int bk) {
  extern __shared__ unsigned char smem_raw[];
  const int lda = bm + a_pad<T>();
  T* As = reinterpret_cast<T*>(smem_raw);  // [bk][lda], A tile transposed
  T* Bs = As + bk * lda;                    // [bk][bn]

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int cols = bn / TN;  // threads along N
  const int tx = tid % cols;
  const int ty = tid / cols;
  const int rstride = bm / TM;
  const int cstride = bn / TN;
  const long long m0 = static_cast<long long>(blockIdx.y) * bm;
  const long long n0 = static_cast<long long>(blockIdx.x) * bn;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    for (int idx = tid; idx < bm * bk; idx += nthreads) {
      const int r = idx / bk, kk = idx % bk;
      As[kk * lda + r] = a[(m0 + r) * K + k0 + kk];
    }
    for (int idx = tid; idx < bk * bn; idx += nthreads) {
      const int kk = idx / bn, col = idx % bn;
      Bs[kk * bn + col] = b[static_cast<long long>(k0 + kk) * N + n0 + col];
    }
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = to_float(As[kk * lda + ty + rstride * i]);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = to_float(Bs[kk * bn + tx + cstride * j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      c[(m0 + ty + rstride * i) * N + n0 + tx + cstride * j] = from_float<T>(acc[i][j]);
}

template <typename T>
int launch(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn, int bk,
           void* stream) {
  if (bm <= 0 || bn <= 0 || bk <= 0 || bm % TM || bn % TN || M % bm || N % bn || K % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(bk) * (bm + a_pad<T>()) + static_cast<size_t>(bk) * bn) * sizeof(T);
  // The attribute is the block's limit, not this launch's need: the tuner launches one
  // kernel at several tiles from several threads, and a per-launch value set by one
  // thread would refuse another thread's larger launch ("invalid argument").
  cudaError_t err = cudaFuncSetAttribute(matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(N / bn, M / bm);
  dim3 block((bm / TM) * (bn / TN));
  matmul_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), M, N, K, bm, bn, bk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int repro_matmul_f32(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn,
                     int bk, void* stream) {
  return launch<float>(a, b, c, M, N, K, bm, bn, bk, stream);
}

int repro_matmul_bf16(const void* a, const void* b, void* c, int M, int N, int K, int bm, int bn,
                      int bk, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, M, N, K, bm, bn, bk, stream);
}

const char* repro_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
