// Linear-recurrence scans for Hopper (sm_90a): RG-LRU and RWKV-6 WKV.
//
// Replace the JAX package's kernels/linear_scan.py::lru_scan_chunked and
// ::rwkv_scan_chunked (Pallas TPU, _lru_kernel and _rwkv_kernel).  There the
// time axis is a sequential grid dimension and the fp32 state stays in VMEM
// from one grid step to the next.  Blocks on a GPU run in no order: the
// rwkv block owns its whole time axis and loops over it itself, with the
// state in registers; the lru scan splits the time axis into segments and
// carries the state from one segment's block to the next through device
// memory (below).
//
// lru_scan: h_t = a_t * h_{t-1} + b_t, elementwise over (B, T, D): a
// segmented scan with a chained carry.  What bounds it: memory, three
// passes over (B, T, D) (a and b read, hs written once) against 2 FLOP per
// element.  A block per channel column walking all T steps alone (the TPU
// kernel's shape) gives 160 blocks at recurrentgemma-2b's prefill, about 5
// warps per SM with a few loads in flight each: bound by latency, not bytes.
// So T is split into `nseg` segments of whole `chunk`s, and each block owns
// (block_d channels of one batch row, one segment):
//  1. it stages the segment's a and b in shared memory in the input dtype,
//     one cp.async group per chunk (16-byte copies for fp32, 8-byte for
//     bf16: each thread owns 4 neighbouring channels), and scans them as
//     the chunks land: the running product P = prod a and the local state
//     hloc from 0 (segment 0 starts from h0 and writes hs right away);
//  2. it waits for the preceding segment's inclusive state (its carry),
//     publishes its own, fma(P, carry, hloc), for the next segment, and
//  3. rescans the staged segment from the carry, writing hs once.
// The carry is looked back one segment only: each segment waits for its
// predecessor's inclusive state instead of combining the aggregates of
// several.  That keeps the output bit-identical from run to run (a
// replayed tuning record must reproduce its kernel's output exactly), and
// the chain advances faster than blocks are dispatched.  Forward progress:
// a block takes its segment from an atomic ticket in launch order, segment
// after segment over all columns, so it only ever waits on blocks that
// already run.  The ticket and the flags are zeroed on the caller's stream
// before each launch.  Within a segment the recurrence is exact; only the
// carry reassociates the product (rounding of P over one segment).
//
// rwkv_scan: per (batch, head), with an fp32 (hd x hd) state S,
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] <- exp(lw_t[i]) S[i][j] + k_t[i] v_t[j]
// The exact per-token recurrence, not the TPU kernel's chunk form: that
// builds an (L, L, hd) fp32 tensor of cumulative-decay differences, 1 MiB at
// L = hd = 64, more than a block's shared memory.  Per token there are no
// decay differences, so nothing overflows at any decay.  One block per
// (batch, head), one thread per column j, S[:, j] in registers (hd is a
// template parameter so the column is a register array).  Per chunk the
// block stages r, k, v, exp(lw) and u*k for `chunk` tokens in shared memory
// (each thread computes one channel's exp and bonus), then every thread
// walks the chunk's tokens reading the row values as broadcasts.  What
// bounds it: operations, about 5 hd^2 fp32 FLOP per (token, head) on the
// CUDA cores against 2-4 bytes per (token, head, channel).  A chunked
// tensor-core form is later work.
//
// lru_scan's backward (lru_bwd_kernel below): one kernel a call, no
// memset, no hs in device memory.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success.  Launches go on the stream the caller passes.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK_SMEM = 232448;  // shared memory one block may use on Hopper (227 KB)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------------------------ RG-LRU
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most n of this thread's cp.async groups are pending.  The
// count must be an immediate, so n > 7 waits as for 7: more than needed,
// never less.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// CPT neighbouring channels of one row: global -> shared.  CPT = 4 is one
// cp.async of 16 (fp32) or 8 (bf16) bytes; CPT = 1 (misaligned views, or a
// channel count that is not a multiple of 4) a plain element copy.
template <typename T, int CPT>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  if constexpr (CPT == 4) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if constexpr (sizeof(T) == 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    *dst = *src;
  }
}

template <typename T, int CPT>
__device__ __forceinline__ void read_row(const T* p, float (&x)[CPT]) {
  if constexpr (CPT == 4 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (CPT == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    x[0] = __low2float(lo); x[1] = __high2float(lo); x[2] = __low2float(hi); x[3] = __high2float(hi);
  } else {
    x[0] = to_float(p[0]);
  }
}

template <typename T, int CPT>
__device__ __forceinline__ void write_row(T* p, const float (&h)[CPT]) {
  if constexpr (CPT == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(h[0], h[1], h[2], h[3]);
  } else if constexpr (CPT == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(h[0], h[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(h[2], h[3]);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = v;
  } else {
    p[0] = from_float<T>(h[0]);
  }
}

// One block per (column, segment), block_d / CPT threads, CPT channels
// each.  A column is (batch row, channel block); ticket t is segment
// t / ncols of column t % ncols.  flags[0] is the ticket counter, flags[1 + t]
// says that carry[t * block_d ...] holds segment t's inclusive state.
// Shared memory: the ticket (16 bytes), then a and b of the segment,
// [rows][block_d] each, in the input dtype.
// Every thread stages and reads only its own channels, so no barrier sits
// between the copies and the scans.
template <typename T, int CPT>
__global__ void __launch_bounds__(1024)
lru_segment_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
                   T* __restrict__ hs, float* __restrict__ hT, int* __restrict__ flags,
                   float* __restrict__ carry, int T_len, int D, int bd, int chunk, int rows, int nseg,
                   int ncols) {
  extern __shared__ __align__(16) unsigned char lru_smem[];
  int* ticket_s = reinterpret_cast<int*>(lru_smem);  // 16 bytes, then the tiles
  T* as = reinterpret_cast<T*>(lru_smem + 16);
  T* bs = as + static_cast<size_t>(rows) * bd;
  if (threadIdx.x == 0) *ticket_s = atomicAdd(flags, 1);
  __syncthreads();
  const int ticket = *ticket_s;
  const int seg = ticket / ncols, col = ticket % ncols;
  const int nblk = D / bd;
  const int bi = col / nblk;
  const int lc = CPT * threadIdx.x;               // first channel of this thread in the block
  const int ch = (col % nblk) * bd + lc;          // ... and in the row
  const long long col0 = static_cast<long long>(bi) * T_len * D + ch;
  const int s0 = seg * rows;                      // the segment's first step
  // element offset of the segment's row r
  auto row = [&](int r) -> long long { return col0 + (static_cast<long long>(s0) + r) * D; };

  const int nch = rows / chunk;
  for (int c = 0; c < nch; ++c) {
    for (int r = c * chunk; r < (c + 1) * chunk; ++r) {
      stage<T, CPT>(as + r * bd + lc, a + row(r));
      stage<T, CPT>(bs + r * bd + lc, b + row(r));
    }
    cp_async_commit();
  }

  float h[CPT], P[CPT], av[CPT], bv[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    h[i] = seg == 0 ? h0[static_cast<long long>(bi) * D + ch + i] : 0.f;
    P[i] = 1.f;
  }
  // pass 1, chunk by chunk as the copies land: segment 0 is exact from h0
  // and writes its rows; every other segment forms (P, hloc)
  for (int c = 0; c < nch; ++c) {
    cp_async_wait_upto(nch - 1 - c);
    for (int r = c * chunk; r < (c + 1) * chunk; ++r) {
      read_row<T, CPT>(as + r * bd + lc, av);
      read_row<T, CPT>(bs + r * bd + lc, bv);
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        P[i] *= av[i];
        h[i] = fmaf(av[i], h[i], bv[i]);
      }
      if (seg == 0) write_row<T, CPT>(hs + row(r), h);
    }
  }

  float* mine = carry + static_cast<long long>(ticket) * bd + lc;
  if (seg > 0) {
    // the predecessor's inclusive state; its block took an earlier ticket,
    // so it runs (or ran) and never waits on this one
    const float* prev = carry + static_cast<long long>(ticket - ncols) * bd + lc;
    const int* f = flags + 1 + (ticket - ncols);
    for (unsigned n = 0; ld_acquire(f) == 0; ++n) {
      if (n > (1u << 26)) __trap();  // a lost carry: fail, don't hang the card
      __nanosleep(64);
    }
    float cin[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) cin[i] = __ldcg(prev + i);
    if (seg < nseg - 1) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) mine[i] = fmaf(P[i], cin[i], h[i]);
    }
    // pass 2: the exact recurrence from the carry, each row written once
#pragma unroll
    for (int i = 0; i < CPT; ++i) h[i] = cin[i];
    if (seg < nseg - 1) {
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) st_release(flags + 1 + ticket, 1);
    }
    for (int r = 0; r < rows; ++r) {
      read_row<T, CPT>(as + r * bd + lc, av);
      read_row<T, CPT>(bs + r * bd + lc, bv);
#pragma unroll
      for (int i = 0; i < CPT; ++i) h[i] = fmaf(av[i], h[i], bv[i]);
      write_row<T, CPT>(hs + row(r), h);
    }
  } else if (nseg > 1) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) mine[i] = h[i];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(flags + 1 + ticket, 1);
  }
  if (seg == nseg - 1) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) hT[static_cast<long long>(bi) * D + ch + i] = h[i];
  }
}

template <typename T>
int lru_launch(const void* a, const void* b, const void* h0, void* hs, void* hT, void* flags,
               void* carry, int B, int T_len, int D, int chunk, int block_d, int nseg, int cpt,
               void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0 || chunk <= 0 || block_d <= 0 || block_d > 1024 ||
      nseg <= 0 || T_len % chunk || D % block_d || (T_len / chunk) % nseg ||
      (cpt != 1 && cpt != 4) || block_d % cpt)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = T_len / nseg;
  const int ncols = B * (D / block_d);
  const size_t smem = 16 + 2 * static_cast<size_t>(rows) * block_d * sizeof(T);
  if (smem > static_cast<size_t>(BLOCK_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flags, 0, (1 + static_cast<size_t>(ncols) * nseg) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The attribute is the block's limit, not this launch's need: the tuner launches one
  // kernel at several tiles from several threads, and a per-launch value set by one
  // thread would refuse another thread's larger launch ("invalid argument").
  auto kernel = cpt == 4 ? lru_segment_kernel<T, 4> : lru_segment_kernel<T, 1>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<ncols * nseg, block_d / cpt, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<T*>(hs), static_cast<float*>(hT), static_cast<int*>(flags),
      static_cast<float*>(carry), T_len, D, block_d, chunk, rows, nseg, ncols);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ RG-LRU backward
// The gradient of lru_scan with g = dL/dhs, g_T = dL/dh_T (null: zero),
// h_{-1} = h0:
//     G_t = g_t + a_{t+1} G_{t+1}   (G_{T-1} = g_{T-1} + g_T: a_T = 1)
//     db_t = G_t,  da_t = G_t h_{t-1},  dh0 = a_0 G_0.
// The JAX package's custom_vjp takes jax.vjp of its per-token lax.scan
// (src/repro/kernels/ops.py:98); it has no Pallas kernel to replace.  What
// bounds it: bytes, a, b and g read and da and db written once (5 passes over
// (B, T, D)) against 5 FLOP an element; at recurrentgemma-2b's training call
// (4, 256, 2560) fp32 that is 16 us of device memory, so the design is about
// keeping enough copies in flight and nothing else in device memory: one
// launch a call, no memset, hs never leaves the SM, no block waits on another.
//
// One block owns one batch row and `cw` channels over the whole of T; its
// threads split each tile of `tile` rows into `nsub` sub-segments, thread
// (q, s) owning CPT neighbouring channels of sub-segment s, so that every
// thread stages (cp.async, 16 bytes fp32 / 8 bytes bf16 when CPT = 4) and
// reads only its own rows: the only exchanges between threads are the
// sub-segments' carries, through shared memory.  Per tile, last tile first:
//  1. the forward recompute: each thread scans its rows to (P = prod a,
//     hloc from 0); thread s's carry is the tile's start state combined with
//     sub-segments 0 .. s-1 in order, c <- fma(P_j, c, hloc_j), which is
//     h_{lo-1}; it rescans its rows from it and overwrites b with h in shared
//     memory (in the input dtype, as the forward returns hs);
//  2. the reverse scan, the same way on a' = (a_1 .. a_{T-1}, 1) read
//     backwards (a thread's last row takes a' from the next row in device
//     memory), its carry G from the later sub-segments and from the later
//     tile; the rescan writes db = G and da = G h_{t-1} straight to device
//     memory in the dtype of (a, b), and the threads of sub-segment 0 write
//     dh0 = a_0 G_0.
// When T fits the shared memory (tile = T) a, b and g are read once.  When it
// does not, a first pass over the tiles scans a and b to each tile's start
// state (the combine over all its sub-segments), kept in `hst`, (B, tiles, D)
// fp32 scratch that this block alone writes and reads; the pass above then
// re-stages a and b: 7 passes in all, still one launch.  Every sum runs in a
// fixed order with no atomics, so two calls give the same bits; within a
// sub-segment the recurrence is exact, only the carries reassociate.
// linear_scan.py::lru_scan_bwd_segmented_plain is this arithmetic in PyTorch.
//
// Shared memory: P and hloc of each sub-segment, [nsub][cw] fp32 each (the
// reverse scan's aggregates reuse them), G's tile carry [2][cw] fp32, then
// a, b (then h) and g of the tile, [tile][cw] each in the input dtype.
template <typename T, int CPT>
__global__ void __launch_bounds__(1024)
lru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
               const T* __restrict__ g, const float* __restrict__ gT, T* __restrict__ da,
               T* __restrict__ db, float* __restrict__ dh0, float* __restrict__ hst, int T_len, int D,
               int cw, int nsub, int tile) {
  extern __shared__ __align__(16) unsigned char lru_bwd_smem[];
  float* aggP = reinterpret_cast<float*>(lru_bwd_smem);
  float* aggH = aggP + nsub * cw;
  float* gcar = aggH + nsub * cw;
  T* as = reinterpret_cast<T*>(gcar + 2 * cw);
  T* bs = as + static_cast<size_t>(tile) * cw;
  T* gs = bs + static_cast<size_t>(tile) * cw;
  const int ntiles = (T_len + tile - 1) / tile;
  const int nq = cw / CPT;  // threads a row
  const int q = threadIdx.x % nq, s = threadIdx.x / nq;
  const int lc = q * CPT;  // this thread's first channel in the block ...
  const int bi = blockIdx.y;
  const int ch = blockIdx.x * cw + lc;  // ... and in the row
  const long long col0 = static_cast<long long>(bi) * T_len * D + ch;
  const long long vec0 = static_cast<long long>(bi) * D + ch;  // h0, g_T, dh0
  auto grow = [&](int t) -> long long { return col0 + static_cast<long long>(t) * D; };
  auto srow = [&](int r) -> int { return r * cw + lc; };
  // this thread's rows [lo, hi) of the tile that starts at t0
  auto rows_of = [&](int t0, int& lo, int& hi) {
    const int n = min(tile, T_len - t0);
    const int rp = (n + nsub - 1) / nsub;
    lo = min(s * rp, n);
    hi = min(lo + rp, n);
  };
  // the start state of tile k: h0, or the first pass's
  auto tile_start = [&](int k, float (&c)[CPT]) {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      c[i] = k == 0 ? h0[vec0 + i] : __ldcg(hst + (static_cast<long long>(bi) * ntiles + k) * D + ch + i);
  };
  // P = prod a and h from 0 over this thread's staged rows
  auto fwd_local = [&](int lo, int hi) {
    float P[CPT], H[CPT], av[CPT], bv[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) P[i] = 1.f, H[i] = 0.f;
    for (int r = lo; r < hi; ++r) {
      read_row<T, CPT>(as + srow(r), av);
      read_row<T, CPT>(bs + srow(r), bv);
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        P[i] *= av[i];
        H[i] = fmaf(av[i], H[i], bv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) aggP[s * cw + lc + i] = P[i], aggH[s * cw + lc + i] = H[i];
  };
  // c <- fma(P_j, c, hloc_j) for j in [j0, j1), ascending or descending
  auto combine = [&](float (&c)[CPT], int j0, int j1, int step) {
    for (int j = j0; j != j1; j += step) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) c[i] = fmaf(aggP[j * cw + lc + i], c[i], aggH[j * cw + lc + i]);
    }
  };

  // the first pass when T is streamed: each tile's start state into hst
  for (int k = 0; k + 1 < ntiles; ++k) {
    const int t0 = k * tile;
    int lo, hi;
    rows_of(t0, lo, hi);
    for (int r = lo; r < hi; ++r) {
      stage<T, CPT>(as + srow(r), a + grow(t0 + r));
      stage<T, CPT>(bs + srow(r), b + grow(t0 + r));
    }
    cp_async_commit();
    cp_async_wait<0>();
    fwd_local(lo, hi);
    __syncthreads();
    if (s == 0) {
      float c[CPT];
      tile_start(k, c);
      combine(c, 0, nsub, 1);
#pragma unroll
      for (int i = 0; i < CPT; ++i) hst[(static_cast<long long>(bi) * ntiles + k + 1) * D + ch + i] = c[i];
    }
    __syncthreads();  // hst is written; aggP and aggH are read
  }

  for (int k = ntiles - 1; k >= 0; --k) {
    const int t0 = k * tile;
    int lo, hi;
    rows_of(t0, lo, hi);
    for (int r = lo; r < hi; ++r) {
      stage<T, CPT>(as + srow(r), a + grow(t0 + r));
      stage<T, CPT>(bs + srow(r), b + grow(t0 + r));
    }
    cp_async_commit();
    for (int r = lo; r < hi; ++r) stage<T, CPT>(gs + srow(r), g + grow(t0 + r));
    cp_async_commit();
    // a' of this thread's last row: a at the next row, 1 past the end of T
    float an[CPT];
    if (hi > lo && t0 + hi < T_len) {
      read_row<T, CPT>(a + grow(t0 + hi), an);
    } else {
#pragma unroll
      for (int i = 0; i < CPT; ++i) an[i] = 1.f;
    }
    cp_async_wait<1>();  // a and b; g may still be landing

    // 1. the forward recompute: h over this thread's rows, into bs
    fwd_local(lo, hi);
    __syncthreads();
    float hfirst[CPT];  // h_{t0 + lo - 1}: this sub-segment's carry
    tile_start(k, hfirst);
    combine(hfirst, 0, s, 1);
    {
      float h[CPT], av[CPT], bv[CPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i) h[i] = hfirst[i];
      for (int r = lo; r < hi; ++r) {
        read_row<T, CPT>(as + srow(r), av);
        read_row<T, CPT>(bs + srow(r), bv);
#pragma unroll
        for (int i = 0; i < CPT; ++i) h[i] = fmaf(av[i], h[i], bv[i]);
        write_row<T, CPT>(bs + srow(r), h);
      }
    }
    __syncthreads();  // every carry is formed: aggP and aggH are free
    cp_async_wait<0>();

    // 2. the reverse scan: G over this thread's rows, last row first
    auto aprime = [&](int r, float (&ap)[CPT]) {
      if (r + 1 < hi) {
        read_row<T, CPT>(as + srow(r + 1), ap);
      } else {
#pragma unroll
        for (int i = 0; i < CPT; ++i) ap[i] = an[i];
      }
    };
    {
      float P[CPT], G[CPT], ap[CPT], gv[CPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i) P[i] = 1.f, G[i] = 0.f;
      for (int r = hi - 1; r >= lo; --r) {
        aprime(r, ap);
        read_row<T, CPT>(gs + srow(r), gv);
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          P[i] *= ap[i];
          G[i] = fmaf(ap[i], G[i], gv[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < CPT; ++i) aggP[s * cw + lc + i] = P[i], aggH[s * cw + lc + i] = G[i];
    }
    __syncthreads();
    float G[CPT], ap[CPT], gv[CPT], hp[CPT], d[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      G[i] = k + 1 < ntiles ? gcar[(k & 1) * cw + lc + i] : (gT ? gT[vec0 + i] : 0.f);
    combine(G, nsub - 1, s, -1);
    if (s == 0 && k > 0) {  // G at the tile's first row, into the previous tile
#pragma unroll
      for (int i = 0; i < CPT; ++i) gcar[((k - 1) & 1) * cw + lc + i] = fmaf(aggP[lc + i], G[i], aggH[lc + i]);
    }
    for (int r = hi - 1; r >= lo; --r) {
      aprime(r, ap);
      read_row<T, CPT>(gs + srow(r), gv);
      if (r > lo) {
        read_row<T, CPT>(bs + srow(r - 1), hp);
      } else {
#pragma unroll
        for (int i = 0; i < CPT; ++i) hp[i] = hfirst[i];
      }
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        G[i] = fmaf(ap[i], G[i], gv[i]);
        d[i] = G[i] * hp[i];
      }
      write_row<T, CPT>(db + grow(t0 + r), G);
      write_row<T, CPT>(da + grow(t0 + r), d);
    }
    if (k == 0 && s == 0) {  // G is G_0
      float a0[CPT];
      read_row<T, CPT>(as + srow(0), a0);
#pragma unroll
      for (int i = 0; i < CPT; ++i) dh0[vec0 + i] = a0[i] * G[i];
    }
    if (ntiles > 1) __syncthreads();  // the next tile's rows may belong to other threads
  }
}

// smem: the block's dynamic shared memory (linear_scan.py::lru_bwd_smem_bytes)
template <typename T>
int lru_bwd_launch(const void* a, const void* b, const void* h0, const void* g, const void* gT,
                   void* da, void* db, void* dh0, void* hst, int B, int T_len, int D, int cw,
                   int nsub, int tile, int cpt, void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || D <= 0 || cw <= 0 || D % cw || nsub <= 0 || tile <= 0 ||
      (cpt != 1 && cpt != 4) || cw % cpt || (cw / cpt) * nsub > 1024 ||
      (tile < T_len && hst == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * static_cast<size_t>(nsub) * cw + 2 * cw) * sizeof(float) +
                      3 * static_cast<size_t>(tile) * cw * sizeof(T);
  if (smem > static_cast<size_t>(BLOCK_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = cpt == 4 ? lru_bwd_kernel<T, 4> : lru_bwd_kernel<T, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(D / cw, B), (cw / cpt) * nsub, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<const T*>(g), static_cast<const float*>(gT), static_cast<T*>(da), static_cast<T*>(db),
      static_cast<float*>(dh0), static_cast<float*>(hst), T_len, D, cw, nsub,
      tile < T_len ? tile : T_len);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ RWKV-6
// Shared memory per block: five [chunk][HD] fp32 arrays (r, k, v, exp(lw), u*k).
template <typename T, int HD>
__global__ void __launch_bounds__(64)
rwkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ lw, const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ sT, int T_len, int H, int chunk) {
  extern __shared__ float rwkv_smem[];
  float* rs = rwkv_smem;
  float* ks = rs + chunk * HD;
  float* vs = ks + chunk * HD;
  float* ws = vs + chunk * HD;
  float* uks = ws + chunk * HD;
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const long long bh = static_cast<long long>(bi) * H + h;
  const float uj = u[h * HD + j];

  float S[HD];  // column j of the state
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0[(bh * HD + i) * HD + j];

  for (int t0 = 0; t0 < T_len; t0 += chunk) {
    for (int t = 0; t < chunk; ++t) {
      const long long off = ((static_cast<long long>(bi) * T_len + t0 + t) * H + h) * HD + j;
      const float kj = to_float(k[off]);
      rs[t * HD + j] = to_float(r[off]);
      ks[t * HD + j] = kj;
      vs[t * HD + j] = to_float(v[off]);
      ws[t * HD + j] = expf(lw[off]);
      uks[t * HD + j] = uj * kj;
    }
    __syncthreads();
    for (int t = 0; t < chunk; ++t) {
      const float vj = vs[t * HD + j];
      const float* rt = rs + t * HD;
      const float* kt = ks + t * HD;
      const float* wt = ws + t * HD;
      const float* ukt = uks + t * HD;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = kt[i] * vj;
        acc = fmaf(rt[i], fmaf(ukt[i], vj, S[i]), acc);
        S[i] = fmaf(wt[i], S[i], kv);
      }
      const long long off = ((static_cast<long long>(bi) * T_len + t0 + t) * H + h) * HD + j;
      y[off] = from_float<T>(acc);
    }
    __syncthreads();  // the next chunk's staging overwrites these rows
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) sT[(bh * HD + i) * HD + j] = S[i];
}

template <typename T, int HD>
int rwkv_launch_hd(const void* r, const void* k, const void* v, const void* lw, const void* u,
                   const void* s0, void* y, void* sT, int B, int T_len, int H, int chunk,
                   void* stream) {
  const size_t smem = 5 * static_cast<size_t>(chunk) * HD * sizeof(float);
  // The attribute is the block's limit, not this launch's need: the tuner launches one
  // kernel at several tiles from several threads, and a per-launch value set by one
  // thread would refuse another thread's larger launch ("invalid argument").
  cudaError_t err = cudaFuncSetAttribute(rwkv_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B);
  rwkv_kernel<T, HD><<<grid, HD, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lw), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sT), T_len, H, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rwkv_launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
                const void* s0, void* y, void* sT, int B, int T_len, int H, int hd, int chunk,
                void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || chunk <= 0 || T_len % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 8: return rwkv_launch_hd<T, 8>(r, k, v, lw, u, s0, y, sT, B, T_len, H, chunk, stream);
    case 16: return rwkv_launch_hd<T, 16>(r, k, v, lw, u, s0, y, sT, B, T_len, H, chunk, stream);
    case 32: return rwkv_launch_hd<T, 32>(r, k, v, lw, u, s0, y, sT, B, T_len, H, chunk, stream);
    case 64: return rwkv_launch_hd<T, 64>(r, k, v, lw, u, s0, y, sT, B, T_len, H, chunk, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------- RWKV-6 backward
// The gradient of the per-token recurrence (rwkv_kernel above) with respect
// to r, k, v, lw, u and s0, in an fp32 state.  With w_t = exp(lw_t),
// akv_t = k_t v_t^T and dS_T = dL/dS_T, from t = T-1 down to 0:
//     dA      = dS_t + (u * r_t) gy_t^T
//     dr_t    = (S_{t-1} + diag(u) akv_t) gy_t      dk_t = dA v_t
//     dv_t    = dA^T k_t                            dlw_t = w_t * rowsum(dS_t * S_{t-1})
//     du     += r_t * k_t (v_t . gy_t)              dS_{t-1} = diag(w_t) dS_t + r_t gy_t^T
// and ds0 = dS_{-1}.  The recurrences of S and dS are independent per state
// row i (diag(w) scales rows), and so are dr, dk, dlw and du, the row sums;
// only dv, a column sum, crosses rows.  So the NS = hd / NR blocks of one
// (head, batch row) each own NR rows of S and dS for all hd columns
// (linear_scan.py::rwkv_bwd_slices: up to one block per SM) and form a
// thread-block cluster.  S_{t-1} cannot be had from S_t by dividing by w (w
// underflows), so a block first runs its rows of the recurrence forward and
// stores them at the start of every segment of `seg` tokens in `ck` (global
// scratch), then takes the segments last first: it runs the segment
// forward from its checkpoint, storing its rows at the start of each of the
// segment's chunks in `sub` (seg / chunk - 1 states a block, whatever T),
// then takes the segment's chunks last first: it reloads the chunk's
// start, recomputes the chunk's states into shared memory and walks the
// chunk backwards with no barrier a token.  Thread (i, q) owns row i and
// columns q, q + 4, ..., so the row sums (dr, dk, dlw, v . gy) are the
// thread's own plus two shuffles among the row's 4 lanes, written straight
// out; each element's dA k_i (dv's term) overwrites the state it was
// computed from.  At the chunk's end one cluster barrier, then each block
// sums dv for its NR of the columns over all hd rows, in row order, reading
// the other blocks' terms through distributed shared memory, and a second
// barrier before the terms are overwritten.  Every sum runs in the order of
// the one-block design (NS = 1), so the outputs are the same bits at every
// NS, and two calls give the same bits.  What bounds it: operations,
// about 26 hd^2 fp32 FLOP per (token, head) on the CUDA cores (the forward
// three times and the step above; the gradient needs 14), against a few
// bytes per (token, head, channel).  Shared memory: five [chunk][hd] fp32
// rows (r, k, v, exp(lw), gy) and the chunk's states of its rows
// [chunk][NR][hd + 4].
constexpr int RWKV_BWD_TPR = 4;  // threads per state row

template <typename T, int HD, int NR>
__global__ void __launch_bounds__(RWKV_BWD_TPR * NR)
rwkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ lw, const float* __restrict__ u,
                const float* __restrict__ s0, const T* __restrict__ gy,
                const float* __restrict__ gsT, T* __restrict__ dr, T* __restrict__ dk,
                T* __restrict__ dv, float* __restrict__ dlw, float* __restrict__ du_part,
                float* __restrict__ ds0, float* __restrict__ ck, float* __restrict__ sub,
                int T_len, int H, int chunk, int seg) {
  namespace cg = cooperative_groups;
  constexpr int TPR = RWKV_BWD_TPR, CW = HD / TPR, RS = HD + 4, NS = HD / NR;
  constexpr int THREADS_ = TPR * NR;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float rwkv_bwd_smem[];
  float* rs = rwkv_bwd_smem;
  float* ks = rs + chunk * HD;
  float* vs = ks + chunk * HD;
  float* ws = vs + chunk * HD;
  float* gs = ws + chunk * HD;
  float* hist = gs + chunk * HD;  // [chunk][NR][RS]
  const int tid = threadIdx.x;
  const int il = tid / TPR, q = tid % TPR;
  const int sl = static_cast<int>(cluster.block_rank());  // == blockIdx.x
  const int i = sl * NR + il;  // this thread's state row
  const int h = blockIdx.y, bi = blockIdx.z;
  const long long bh = static_cast<long long>(bi) * H + h;
  const long long blk = bh * NS + sl;
  const int nsub = seg / chunk;  // chunks per segment
  const int nseg = T_len / seg;
  const float ui = u[h * HD + i];
  const long long mat = (bh * HD + i) * HD + q;  // this thread's first element of s0, gsT, ds0
  // token t's row of a (B, T, H, HD) array
  auto tok = [&](int t) -> long long {
    return ((static_cast<long long>(bi) * T_len + t) * H + h) * HD;
  };
  // state n of this block's `slots` states in a scratch, this thread's
  // first element (element cc lies cc * NR * TPR further): consecutive
  // threads, consecutive words
  auto slot = [&](float* base, int slots, int n) -> float* {
    return base + ((blk * slots + n) * CW) * (NR * TPR) + tid;
  };
  auto load_rows = [&](int t0, bool all) {
    for (int e = tid; e < chunk * HD; e += THREADS_) {
      const long long o = tok(t0 + e / HD) + e % HD;
      ks[e] = to_float(k[o]);
      vs[e] = to_float(v[o]);
      ws[e] = expf(lw[o]);
      if (all) {
        rs[e] = to_float(r[o]);
        gs[e] = to_float(gy[o]);
      }
    }
  };

  float S[CW];
  // S from a scratch slot or into one; each thread reads back only what it wrote
  auto load_state = [&](const float* p) {
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) S[cc] = p[cc * NR * TPR];
  };
  auto store_state = [&](float* p) {
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) p[cc * NR * TPR] = S[cc];
  };
  auto load_s0 = [&]() {
#pragma unroll
    for (int cc = 0; cc < CW; ++cc) S[cc] = s0[mat + TPR * cc];
  };
  // S over the chunk that starts at t0
  auto advance = [&](int t0) {
    load_rows(t0, false);
    __syncthreads();
    for (int t = 0; t < chunk; ++t) {
      const float wi = ws[t * HD + i], ki = ks[t * HD + i];
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) S[cc] = fmaf(wi, S[cc], ki * vs[t * HD + q + TPR * cc]);
    }
    __syncthreads();  // the next chunk's staging overwrites these rows
  };

  // the forward recurrence, S stored at the start of segments 1 .. nseg-1
  load_s0();
  for (int c = 0; c < (nseg - 1) * nsub; ++c) {
    advance(c * chunk);
    if ((c + 1) % nsub == 0) store_state(slot(ck, nseg - 1, (c + 1) / nsub - 1));
  }

  float dS[CW];
#pragma unroll
  for (int cc = 0; cc < CW; ++cc) dS[cc] = gsT[mat + TPR * cc];
  float du_acc = 0.f;
  for (int c = nseg * nsub - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const int sg = c / nsub, cs = c % nsub;
    if (cs == nsub - 1) {
      // a new segment: S at the start of its chunks 1 .. nsub-1 into `sub`
      if (sg == 0) load_s0(); else load_state(slot(ck, nseg - 1, sg - 1));
      for (int c2 = 0; c2 + 1 < nsub; ++c2) {
        advance((sg * nsub + c2) * chunk);
        store_state(slot(sub, nsub - 1, c2));
      }
    }
    if (cs > 0) load_state(slot(sub, nsub - 1, cs - 1));
    else if (sg == 0) load_s0();
    else load_state(slot(ck, nseg - 1, sg - 1));
    load_rows(t0, true);  // the previous chunk ended on a cluster barrier
    __syncthreads();
    // the chunk's states S_{t-1}; each thread reads back only what it wrote
    for (int t = 0; t < chunk; ++t) {
      float* hrow = hist + (t * NR + il) * RS + q;
      const float wi = ws[t * HD + i], ki = ks[t * HD + i];
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) {
        hrow[TPR * cc] = S[cc];
        S[cc] = fmaf(wi, S[cc], ki * vs[t * HD + q + TPR * cc]);
      }
    }
    for (int t = chunk - 1; t >= 0; --t) {
      const float ri = rs[t * HD + i], ki = ks[t * HD + i], wi = ws[t * HD + i];
      const float ur = ui * ri, uk = ui * ki;
      float* hrow = hist + (t * NR + il) * RS + q;
      float dr_ = 0.f, dk_ = 0.f, dl_ = 0.f, vg = 0.f;
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) {
        const int j = q + TPR * cc;
        const float vj = vs[t * HD + j], gj = gs[t * HD + j], sj = hrow[TPR * cc];
        dr_ = fmaf(fmaf(uk, vj, sj), gj, dr_);
        const float dA = fmaf(ur, gj, dS[cc]);
        dk_ = fmaf(dA, vj, dk_);
        hrow[TPR * cc] = dA * ki;  // S_{t-1} is read; its slot takes the dv term
        dl_ = fmaf(dS[cc], sj, dl_);
        dS[cc] = fmaf(wi, dS[cc], ri * gj);
        vg = fmaf(vj, gj, vg);
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) {
        dr_ += __shfl_xor_sync(0xffffffffu, dr_, off);
        dk_ += __shfl_xor_sync(0xffffffffu, dk_, off);
        dl_ += __shfl_xor_sync(0xffffffffu, dl_, off);
        vg += __shfl_xor_sync(0xffffffffu, vg, off);
      }
      if (q == 0) {
        const long long o = tok(t0 + t) + i;
        dr[o] = from_float<T>(dr_);
        dk[o] = from_float<T>(dk_);
        dlw[o] = wi * dl_;
        du_acc = fmaf(ri * ki, vg, du_acc);
      }
    }
    cluster.sync();  // every block's dv terms of this chunk are in its shared memory
    for (int e = tid; e < chunk * NR; e += THREADS_) {
      const int t = e / NR, j = sl * NR + e % NR;  // this block sums columns sl * NR ..
      float acc = 0.f;
#pragma unroll
      for (int b2 = 0; b2 < NS; ++b2) {  // rows in order: block b2 holds rows b2 * NR ..
        const float* pc = cluster.map_shared_rank(hist, b2) + t * NR * RS + j;
#pragma unroll 8
        for (int ii = 0; ii < NR; ++ii) acc += pc[ii * RS];
      }
      dv[tok(t0 + t) + j] = from_float<T>(acc);
    }
    cluster.sync();  // the next chunk's states overwrite what other blocks have read
  }
#pragma unroll
  for (int cc = 0; cc < CW; ++cc) ds0[mat + TPR * cc] = dS[cc];
  if (q == 0) du_part[bh * HD + i] = du_acc;
}

template <typename T, int HD, int NR>
int rwkv_bwd_launch_nr(const void* const* in, void* const* out, void* ck, void* sub, int B, int T_len,
                       int H, int chunk, int seg, void* stream) {
  const size_t smem = (5 * static_cast<size_t>(chunk) * HD + static_cast<size_t>(chunk) * NR * (HD + 4)) *
                      sizeof(float);
  if (smem > static_cast<size_t>(BLOCK_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rwkv_bwd_kernel<T, HD, NR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(HD / NR, H, B);
  cfg.blockDim = dim3(RWKV_BWD_TPR * NR);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = HD / NR;  // the slices of one (head, batch row)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(in[0]), static_cast<const T*>(in[1]), static_cast<const T*>(in[2]),
      static_cast<const float*>(in[3]), static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<const T*>(in[6]), static_cast<const float*>(in[7]), static_cast<T*>(out[0]),
      static_cast<T*>(out[1]), static_cast<T*>(out[2]), static_cast<float*>(out[3]), static_cast<float*>(out[4]),
      static_cast<float*>(out[5]), static_cast<float*>(ck), static_cast<float*>(sub), T_len, H, chunk, seg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// slices: blocks a (head, batch row), 1, 2, 4 or 8, each at least 8 rows
template <typename T, int HD>
int rwkv_bwd_launch_hd(const void* const* in, void* const* out, void* ck, void* sub, int B, int T_len,
                       int H, int chunk, int seg, int slices, void* stream) {
  if (slices <= 0 || HD % slices || HD / slices < 8) return static_cast<int>(cudaErrorInvalidValue);
  switch (HD / slices) {
    case 8: return rwkv_bwd_launch_nr<T, HD, 8>(in, out, ck, sub, B, T_len, H, chunk, seg, stream);
    case 16:
      if constexpr (HD >= 16) return rwkv_bwd_launch_nr<T, HD, 16>(in, out, ck, sub, B, T_len, H, chunk, seg, stream);
      break;
    case 32:
      if constexpr (HD >= 32) return rwkv_bwd_launch_nr<T, HD, 32>(in, out, ck, sub, B, T_len, H, chunk, seg, stream);
      break;
    case 64:
      if constexpr (HD >= 64) return rwkv_bwd_launch_nr<T, HD, 64>(in, out, ck, sub, B, T_len, H, chunk, seg, stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int rwkv_bwd_launch(const void* const* in, void* const* out, void* ck, void* sub, int B, int T_len,
                    int H, int hd, int chunk, int seg, int slices, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || chunk <= 0 || seg <= 0 || seg % chunk || T_len % seg)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 8: return rwkv_bwd_launch_hd<T, 8>(in, out, ck, sub, B, T_len, H, chunk, seg, slices, stream);
    case 16: return rwkv_bwd_launch_hd<T, 16>(in, out, ck, sub, B, T_len, H, chunk, seg, slices, stream);
    case 32: return rwkv_bwd_launch_hd<T, 32>(in, out, ck, sub, B, T_len, H, chunk, seg, slices, stream);
    case 64: return rwkv_bwd_launch_hd<T, 64>(in, out, ck, sub, B, T_len, H, chunk, seg, slices, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// flags: 1 + B * (D / block_d) * nseg int32 (zeroed here, on the stream);
// carry: B * (D / block_d) * nseg * block_d fp32.  cpt: channels per thread,
// 4 (a, b and hs on 4-element boundaries, D and block_d multiples of 4) or 1.
int repro_lru_scan_f32(const void* a, const void* b, const void* h0, void* hs, void* hT,
                       void* flags, void* carry, int B, int T, int D, int chunk, int block_d,
                       int nseg, int cpt, void* stream) {
  return lru_launch<float>(a, b, h0, hs, hT, flags, carry, B, T, D, chunk, block_d, nseg, cpt,
                           stream);
}

int repro_lru_scan_bf16(const void* a, const void* b, const void* h0, void* hs, void* hT,
                        void* flags, void* carry, int B, int T, int D, int chunk, int block_d,
                        int nseg, int cpt, void* stream) {
  return lru_launch<__nv_bfloat16>(a, b, h0, hs, hT, flags, carry, B, T, D, chunk, block_d, nseg,
                                   cpt, stream);
}

int repro_rwkv_scan_f32(const void* r, const void* k, const void* v, const void* lw, const void* u,
                        const void* s0, void* y, void* sT, int B, int T, int H, int hd, int chunk,
                        void* stream) {
  return rwkv_launch<float>(r, k, v, lw, u, s0, y, sT, B, T, H, hd, chunk, stream);
}

int repro_rwkv_scan_bf16(const void* r, const void* k, const void* v, const void* lw,
                         const void* u, const void* s0, void* y, void* sT, int B, int T, int H,
                         int hd, int chunk, void* stream) {
  return rwkv_launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, sT, B, T, H, hd, chunk, stream);
}

// The lru backward: a, b, g (= dL/dhs), da and db in the input dtype; h0,
// g_T (= dL/dh_T, or null for zero) and dh0 fp32.  cw channels a block (a
// divisor of D), nsub sub-segments a tile of `tile` rows; hst: B * ceil(T /
// tile) * D fp32 scratch when tile < T, else unused.  cpt: channels a thread,
// 4 (a, b, g, da, db on 4-element boundaries, D and cw multiples of 4) or 1.
int repro_lru_scan_bwd_f32(const void* a, const void* b, const void* h0, const void* g, const void* gT,
                           void* da, void* db, void* dh0, void* hst, int B, int T, int D, int cw,
                           int nsub, int tile, int cpt, void* stream) {
  return lru_bwd_launch<float>(a, b, h0, g, gT, da, db, dh0, hst, B, T, D, cw, nsub, tile, cpt, stream);
}

int repro_lru_scan_bwd_bf16(const void* a, const void* b, const void* h0, const void* g, const void* gT,
                            void* da, void* db, void* dh0, void* hst, int B, int T, int D, int cw,
                            int nsub, int tile, int cpt, void* stream) {
  return lru_bwd_launch<__nv_bfloat16>(a, b, h0, g, gT, da, db, dh0, hst, B, T, D, cw, nsub, tile, cpt,
                                       stream);
}

// The RWKV-6 backward: in = (r, k, v, lw, u, s0, gy, gsT), out = (dr, dk, dv,
// dlw, du_part, ds0); r, k, v, gy, dr, dk, dv in the input dtype, the rest
// fp32; du_part (B, H, hd); seg: tokens per checkpoint segment, a multiple of
// chunk dividing T; slices: blocks (a cluster) per (batch row, head), each
// owning hd / slices >= 8 state rows; ck: B * H * max(1, T / seg - 1) *
// hd * hd fp32, sub: B * H * max(1, seg / chunk - 1) * hd * hd fp32.
int repro_rwkv_scan_bwd_f32(const void* const* in, void* const* out, void* ck, void* sub, int B,
                            int T, int H, int hd, int chunk, int seg, int slices, void* stream) {
  return rwkv_bwd_launch<float>(in, out, ck, sub, B, T, H, hd, chunk, seg, slices, stream);
}

int repro_rwkv_scan_bwd_bf16(const void* const* in, void* const* out, void* ck, void* sub, int B,
                             int T, int H, int hd, int chunk, int seg, int slices, void* stream) {
  return rwkv_bwd_launch<__nv_bfloat16>(in, out, ck, sub, B, T, H, hd, chunk, seg, slices, stream);
}

const char* repro_linear_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
