// Split-KV flash-decode for Hopper (sm_90a): one query token per head against
// a KV cache, with a masked online softmax over block_kv tiles.
//
// Replaces the JAX package's kernels/decode_attention.py::decode_attention_fwd
// (Pallas TPU, _kernel).  There the grid is (B, Kh, n_kv) with the KV tiles a
// sequential axis and the (m, l, acc) carry in VMEM scratch.  The arithmetic
// is the TPU kernel's: q is cast to fp32 and scaled by 1/sqrt(hd) before the
// dot, a slot whose valid entry is not > 0 gets the finite -1e30 (not -inf:
// a tile with no valid slot then gives p = exp(0) = 1, so a row with no
// valid slot averages V as the oracle's uniform softmax does, and a masked
// leading tile is wiped later when alpha = exp(-1e30 - m) reaches 0), m/l/acc
// are fp32, and the output is written in q's dtype.  GQA: the g = H / Kh
// query heads kvh*g .. kvh*g+g-1 share KV head kvh.
//
// What bounds it: decode reads every cache byte once for a few FLOP per byte
// (7 per byte at qwen2-7b's g = 7), so it is bound by memory bandwidth on
// the card.  What the design does about it:
//  * Split-KV.  One block per (head group, KV head, batch row, split); a
//    split is a contiguous run of whole block_kv tiles, and the wrapper picks
//    the number of splits from the shape and the SM count (about two blocks
//    per SM or more), so the whole card streams the cache, not B*Kh SMs.
//    Each split writes fp32 (m, l, acc) partials; a second small kernel
//    merges them per (row, head): M = max m_s, o = sum acc_s e^(m_s - M) /
//    sum l_s e^(m_s - M) (l == 0 gives 0).  A split with no valid slot has
//    m = -1e30 and is wiped by e^(-1e30 - M) when any split is valid; when
//    none is, every weight is 1 and the row is the mean of V.  With one
//    split the merge is o = acc / l: the one-pass computation.
//  * Streaming.  K and V flow through a ring of NSTAGE shared-memory stages
//    of CH_BYTES each, filled by cp.async 16-byte copies (neighbouring
//    threads on neighbouring 16-byte pieces of a slot's row), in the order
//    K chunks of a tile, then its V chunks, then the next tile's: the next
//    stage's loads stay in flight while a stage is scored or summed into
//    P V.  Two stages of 32 KB keep two blocks on an SM at every tile of the
//    space (a third stage left one block per SM at block_kv >= 512 and was
//    slower there).  Pieces are stored XOR-swizzled by row, so
//    the score step (threads on different slots, same piece) reads shared
//    memory without bank conflicts.  A view whose pointer or strides are not
//    multiples of 16 bytes takes the same kernel with element loads
//    (VEC = false) instead of cp.async.
//  * GQA.  Up to GMAX = 8 query heads of a group share each staged slot;
//    larger groups are split into head groups of at most 8 (more blocks,
//    the cache read once per head group).
//  * Arithmetic stays fp32 on the CUDA cores: the score step gives each
//    thread ST slots and a segment of the head dim, with the scaled q read
//    as fp32 broadcasts from shared memory and the segments' partial dots
//    summed by shuffles; P V gives each thread one 16-byte piece of the head
//    dim for all the block's heads (accumulators in registers) and a phase
//    of the slots, the phases summed once at the end.
//
// C interface (bound with ctypes): every function returns a cudaError_t
// code, 0 on success.  Strides are in elements; the last dim is contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_SMEM = 232448;  // shared memory one block may use on Hopper (227 KB)

constexpr int NT = 256;             // threads per block
constexpr int NW = NT / 32;
constexpr int GMAX = 8;             // query heads per block
constexpr int CH_BYTES = 32768;     // bytes of one ring stage
constexpr int NSTAGE = 2;           // ring stages (two keep two blocks on an SM at every tile)
constexpr int ST = 2;               // slots per thread in the score step
constexpr float NEG_INF = -1e30f;

template <typename T> struct Piece;  // one 16-byte piece of a row, as fp32
template <> struct Piece<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const char* p, float (&x)[N]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
};
template <> struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const char* p, float (&x)[N]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Index of 16-byte piece i of row `row` in a stage (P = 2^lp pieces a row):
// XOR-swizzled so that the 8 rows an 8-thread phase of the score step reads
// at one piece index fall in 8 different 16-byte bank groups.
__device__ __forceinline__ int swz(int row, int i, int lp) {
  const int P = 1 << lp;
  const int f = P >= 8 ? (row & 7) : ((row >> (3 - lp)) & (P - 1));
  return (row << lp) + (i ^ f);
}

struct Strides {
  long long qb, qh, kb, kh, ks, vb, vh, vs, validb;
};

struct Geom {     // per launch, from the host
  int H, g, hd, lp;        // heads, GQA group, head dim, log2(pieces per row)
  int block_kv, cs, tpsl;  // tile, slots per ring stage, threads per slot (score step)
  int hg, ngroups;         // query heads per block, head groups per KV head
  int tps, nsplit;         // tiles per split, splits
  float scale;
};

// Copy `rows` slots (row stride rs elements) into a ring stage; commits one
// cp.async group (empty in the element-load variant).
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(char* stage, const T* src, long long rs, int rows,
                                           const Geom& G) {
  const int P = 1 << G.lp;
  if (VEC) {
    for (int e = threadIdx.x; e < rows * P; e += NT) {
      const int row = e >> G.lp, i = e & (P - 1);
      cp_async16(stage + 16 * swz(row, i, G.lp),
                 reinterpret_cast<const char*>(src + row * rs) + 16 * i);
    }
  } else {
    constexpr int TPE = Piece<T>::N;
    for (int e = threadIdx.x; e < rows * G.hd; e += NT) {
      const int row = e / G.hd, d = e % G.hd;
      T* dst = reinterpret_cast<T*>(stage + 16 * swz(row, d / TPE, G.lp)) + d % TPE;
      *dst = src[row * rs + d];
    }
  }
  cp_async_commit();
}

template <typename T, int GC, bool VEC>
__global__ void __launch_bounds__(NT, 2)
split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ valid, float* __restrict__ part_acc,
             float* __restrict__ part_ml, Strides st, Geom G) {
  constexpr int TPE = Piece<T>::N;  // elements per 16-byte piece
  extern __shared__ __align__(16) char smem[];
  char* ring = smem;                                              // NSTAGE x CH_BYTES
  float* Qs = reinterpret_cast<float*>(smem + NSTAGE * CH_BYTES);  // [GC][hd], scaled
  float* Ss = Qs + GC * G.hd;                                      // [GC][block_kv]: scores, then p
  float* Ms = Ss + GC * G.block_kv;                                // [GC] running max
  float* Ls = Ms + GC;                                             // [GC] running sum
  float* As = Ls + GC;                                             // [GC] this tile's alpha

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.x / G.ngroups;
  const int grp = blockIdx.x % G.ngroups;
  const int bb = blockIdx.y;
  const int split = blockIdx.z;
  const int j0 = grp * G.hg;                 // first head of the group (within the GQA group)
  const int nh = min(G.hg, G.g - j0);        // heads of this block (<= GC)
  const int P = 1 << G.lp;
  const int slot0 = split * G.tps * G.block_kv;

  const T* qb = q + bb * st.qb + (static_cast<long long>(kvh) * G.g + j0) * st.qh;
  const T* kb = k + bb * st.kb + kvh * st.kh + static_cast<long long>(slot0) * st.ks;
  const T* vb = v + bb * st.vb + kvh * st.vh + static_cast<long long>(slot0) * st.vs;
  const int* validb = valid + bb * st.validb + slot0;

  const int cpt = G.block_kv / G.cs;    // ring stages per tile, for K and again for V
  const int nchunks = 2 * cpt * G.tps;  // K chunks then V chunks of each tile

  auto issue = [&](int n) {
    if (n < nchunks) {
      const int tl = n / (2 * cpt), r = n % (2 * cpt);
      const bool isv = r >= cpt;
      const int row0 = tl * G.block_kv + (r - (isv ? cpt : 0)) * G.cs;
      load_stage<T, VEC>(ring + (n % NSTAGE) * CH_BYTES,
                         isv ? vb + static_cast<long long>(row0) * st.vs
                             : kb + static_cast<long long>(row0) * st.ks,
                         isv ? st.vs : st.ks, G.cs, G);
    } else {
      cp_async_commit();  // keep one group per step so the wait count stays exact
    }
  };
#pragma unroll
  for (int n = 0; n < NSTAGE - 1; ++n) issue(n);

  for (int idx = tid; idx < nh * G.hd; idx += NT) {
    const int j = idx / G.hd, dd = idx % G.hd;
    Qs[idx] = to_float(qb[j * st.qh + dd]) * G.scale;
  }
  for (int idx = nh * G.hd + tid; idx < GC * G.hd; idx += NT) Qs[idx] = 0.f;
  for (int j = tid; j < GC; j += NT) {
    Ms[j] = NEG_INF;
    Ls[j] = 0.f;
  }

  // P V: this thread's piece of the head dim and slot phase
  const int pi = tid & (P - 1);
  const int ph = tid >> G.lp;
  const int nph = NT >> G.lp;
  float acc[GC][TPE];
#pragma unroll
  for (int j = 0; j < GC; ++j)
#pragma unroll
    for (int e = 0; e < TPE; ++e) acc[j][e] = 0.f;

  // score step: this thread's slot group and segment of the head dim
  const int sg = tid / G.tpsl;
  const int seg = tid % G.tpsl;
  const int nsg = NT / G.tpsl;
  const int pps = P / G.tpsl;

  for (int n = 0; n < nchunks; ++n) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // stage n landed for every thread; stage n - 1 is free
    issue(n + NSTAGE - 1);
    const char* stage = ring + (n % NSTAGE) * CH_BYTES;
    const int tl = n / (2 * cpt), r = n % (2 * cpt);
    if (r < cpt) {
      // 1. scores of this stage's slots for every head of the block
      const int c0 = r * G.cs;  // first slot of the stage within the tile
      for (int base = 0; base < G.cs; base += nsg * ST) {
        float s[ST][GC];
#pragma unroll
        for (int a = 0; a < ST; ++a)
#pragma unroll
          for (int j = 0; j < GC; ++j) s[a][j] = 0.f;
        for (int m = 0; m < pps; ++m) {
          const int i = seg + m * G.tpsl;
          float kr[ST][TPE];
#pragma unroll
          for (int a = 0; a < ST; ++a) {
            const int row = base + sg + a * nsg;
            if (row < G.cs) {
              Piece<T>::load(stage + 16 * swz(row, i, G.lp), kr[a]);
            } else {
#pragma unroll
              for (int e = 0; e < TPE; ++e) kr[a][e] = 0.f;
            }
          }
#pragma unroll
          for (int j = 0; j < GC; ++j) {
            const float* qp = Qs + j * G.hd + i * TPE;
            float qv[TPE];
#pragma unroll
            for (int e = 0; e < TPE; e += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qp + e);
              qv[e] = q4.x; qv[e + 1] = q4.y; qv[e + 2] = q4.z; qv[e + 3] = q4.w;
            }
#pragma unroll
            for (int a = 0; a < ST; ++a)
#pragma unroll
              for (int e = 0; e < TPE; ++e) s[a][j] = fmaf(qv[e], kr[a][e], s[a][j]);
          }
        }
        for (int off = G.tpsl / 2; off > 0; off /= 2)
#pragma unroll
          for (int a = 0; a < ST; ++a)
#pragma unroll
            for (int j = 0; j < GC; ++j) s[a][j] += __shfl_xor_sync(0xffffffffu, s[a][j], off);
        if (seg == 0) {
#pragma unroll
          for (int a = 0; a < ST; ++a) {
            const int row = base + sg + a * nsg;
            if (row < G.cs) {
              const int c = c0 + row;
              const bool ok = validb[tl * G.block_kv + c] > 0;
#pragma unroll
              for (int j = 0; j < GC; ++j)
                if (j < nh) Ss[j * G.block_kv + c] = ok ? s[a][j] : NEG_INF;
            }
          }
        }
      }
    } else {
      const int c0 = (r - cpt) * G.cs;
      if (c0 == 0) {
        // 2. the tile's online softmax update, one warp per head
        for (int j = warp; j < nh; j += NW) {
          float* srow = Ss + j * G.block_kv;
          float mx = NEG_INF;
          for (int c = lane; c < G.block_kv; c += 32) mx = fmaxf(mx, srow[c]);
          mx = warp_max(mx);
          const float m_prev = Ms[j];
          const float m_new = fmaxf(m_prev, mx);
          float sum = 0.f;
          for (int c = lane; c < G.block_kv; c += 32) {
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
#pragma unroll
        for (int j = 0; j < GC; ++j) {
          const float alpha = j < nh ? As[j] : 0.f;
#pragma unroll
          for (int e = 0; e < TPE; ++e) acc[j][e] *= alpha;
        }
      }
      // 3. acc += p v over this thread's piece and slot phase
      const float* prow = Ss + c0;
      for (int row = ph; row < G.cs; row += nph) {
        float vr[TPE];
        Piece<T>::load(stage + 16 * swz(row, pi, G.lp), vr);
#pragma unroll
        for (int j = 0; j < GC; ++j) {
          const float p = prow[j * G.block_kv + row];
#pragma unroll
          for (int e = 0; e < TPE; ++e) acc[j][e] = fmaf(p, vr[e], acc[j][e]);
        }
      }
    }
  }

  // sum the slot phases in order through the (now idle) ring; write the partials
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [nph][hd]
  const long long row_h = static_cast<long long>(bb) * G.H + static_cast<long long>(kvh) * G.g + j0;
#pragma unroll
  for (int j = 0; j < GC; ++j) {
    if (j < nh) {
#pragma unroll
      for (int e = 0; e < TPE; ++e) red[ph * G.hd + pi * TPE + e] = acc[j][e];
      __syncthreads();
      const long long part = (row_h + j) * G.nsplit + split;
      for (int d = tid; d < G.hd; d += NT) {
        float a = 0.f;
        for (int p = 0; p < nph; ++p) a += red[p * G.hd + d];
        part_acc[part * G.hd + d] = a;
      }
      if (tid == 0) {
        part_ml[2 * part] = Ms[j];
        part_ml[2 * part + 1] = Ls[j];
      }
      __syncthreads();
    }
  }
}

// Merge the splits of one (batch row, head): o = sum_s acc_s w_s / sum_s l_s w_s
// with w_s = exp(m_s - max m); a row with l == 0 gives 0.
template <typename T>
__global__ void __launch_bounds__(NT)
combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               T* __restrict__ o, int H, int hd, int nsplit) {
  const long long bh = static_cast<long long>(blockIdx.y) * H + blockIdx.x;
  const float* ml = part_ml + 2 * bh * nsplit;
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[2 * s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float L = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(ml[2 * s] - M);
      L = fmaf(ml[2 * s + 1], w, L);
      a = fmaf(part_acc[(bh * nsplit + s) * hd + d], w, a);
    }
    o[bh * hd + d] = from_float<T>(a / (L == 0.f ? 1.f : L));
  }
}

size_t smem_bytes(int gc, int hd, int block_kv) {
  return static_cast<size_t>(NSTAGE) * CH_BYTES +
         sizeof(float) * (static_cast<size_t>(gc) * hd + static_cast<size_t>(gc) * block_kv + 3 * gc);
}

template <typename T, int GC, bool VEC>
int launch_gc(const void* q, const void* k, const void* v, const int* valid, float* pacc,
              float* pml, int B, int Kh, const Strides& st, const Geom& G, cudaStream_t stream) {
  const size_t smem = smem_bytes(GC, G.hd, G.block_kv);
  if (smem > static_cast<size_t>(BLOCK_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  // The attribute is the block's limit, not this launch's need: the tuner launches one
  // kernel at several tiles from several threads, and a per-launch value set by one
  // thread would refuse another thread's larger launch ("invalid argument").
  cudaError_t err = cudaFuncSetAttribute(split_kernel<T, GC, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Kh * G.ngroups, B, G.nsplit);
  split_kernel<T, GC, VEC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid, pacc,
      pml, st, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_vec(const void* q, const void* k, const void* v, const int* valid, float* pacc,
               float* pml, int B, int Kh, const Strides& st, const Geom& G, cudaStream_t s) {
  switch (G.hg) {
    case 1: return launch_gc<T, 1, VEC>(q, k, v, valid, pacc, pml, B, Kh, st, G, s);
    case 2: return launch_gc<T, 2, VEC>(q, k, v, valid, pacc, pml, B, Kh, st, G, s);
    case 3: return launch_gc<T, 3, VEC>(q, k, v, valid, pacc, pml, B, Kh, st, G, s);
    case 4: return launch_gc<T, 4, VEC>(q, k, v, valid, pacc, pml, B, Kh, st, G, s);
    case 5: return launch_gc<T, 5, VEC>(q, k, v, valid, pacc, pml, B, Kh, st, G, s);
    case 6: return launch_gc<T, 6, VEC>(q, k, v, valid, pacc, pml, B, Kh, st, G, s);
    case 7: return launch_gc<T, 7, VEC>(q, k, v, valid, pacc, pml, B, Kh, st, G, s);
    case 8: return launch_gc<T, 8, VEC>(q, k, v, valid, pacc, pml, B, Kh, st, G, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int log2_exact(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return (1 << l) == x ? l : -1;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* o, void* pacc,
           void* pml, int B, int H, int Kh, int S, int hd, const long long* strides, int block_kv,
           int nsplit, int vec, float scale, void* stream) {
  if (block_kv <= 0 || S % block_kv || Kh <= 0 || H % Kh || hd < 16 || hd > 256 || nsplit <= 0 ||
      (S / block_kv) % nsplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = hd * static_cast<int>(sizeof(T));
  const int lp = log2_exact(row_bytes / 16);
  if (row_bytes % 16 || lp < 0) return static_cast<int>(cudaErrorInvalidValue);
  Geom G;
  G.H = H;
  G.g = H / Kh;
  G.hd = hd;
  G.lp = lp;
  G.block_kv = block_kv;
  G.cs = 1;  // the largest divisor of the tile that fits a stage
  for (int c = CH_BYTES / row_bytes; c >= 1; --c)
    if (block_kv % c == 0) {
      G.cs = c;
      break;
    }
  G.tpsl = 1;  // enough threads per slot to give all NT threads a slot group
  while (G.tpsl < 32 && G.tpsl < (1 << lp) && (NT / G.tpsl) * ST > G.cs) G.tpsl *= 2;
  G.ngroups = (G.g + GMAX - 1) / GMAX;
  G.hg = (G.g + G.ngroups - 1) / G.ngroups;
  G.tps = S / block_kv / nsplit;
  G.nsplit = nsplit;
  G.scale = scale;
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  const int* vd = static_cast<const int*>(valid);
  float* fa = static_cast<float*>(pacc);
  float* fm = static_cast<float*>(pml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = vec ? launch_vec<T, true>(q, k, v, vd, fa, fm, B, Kh, st, G, s)
               : launch_vec<T, false>(q, k, v, vd, fa, fm, B, Kh, st, G, s);
  if (rc != 0) return rc;
  combine_kernel<T><<<dim3(H, B), NT, 0, s>>>(fa, fm, static_cast<T*>(o), H, hd, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides: 9 int64 values: q (batch, head), k (batch, head, slot),
// v (batch, head, slot), valid (batch).  o is contiguous (B, H, hd); the
// partials are contiguous fp32 scratch, acc (B, H, nsplit, hd) and (m, l)
// (B, H, nsplit, 2).  nsplit must divide S / block_kv; vec = 1 takes
// 16-byte cp.async copies (pointers and strides multiples of 16 bytes),
// vec = 0 element loads.
int repro_decode_attention_f32(const void* q, const void* k, const void* v, const void* valid,
                               void* o, void* pacc, void* pml, int B, int H, int Kh, int S, int hd,
                               const long long* strides, int block_kv, int nsplit, int vec,
                               float scale, void* stream) {
  return launch<float>(q, k, v, valid, o, pacc, pml, B, H, Kh, S, hd, strides, block_kv, nsplit,
                       vec, scale, stream);
}

int repro_decode_attention_bf16(const void* q, const void* k, const void* v, const void* valid,
                                void* o, void* pacc, void* pml, int B, int H, int Kh, int S, int hd,
                                const long long* strides, int block_kv, int nsplit, int vec,
                                float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, valid, o, pacc, pml, B, H, Kh, S, hd, strides, block_kv,
                               nsplit, vec, scale, stream);
}

const char* repro_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
