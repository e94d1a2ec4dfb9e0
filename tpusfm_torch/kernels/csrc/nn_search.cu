// Brute-force nearest-neighbour search with a running top-2, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpusfm/kernels/distance.py:nn_search_pallas (body
// _nn_kernel). For each query row of q (B, Nq, D) it finds, over the rows of
// db (B, Ndb, D) that the mask marks valid, the index of the nearest row and
// the best and second-best distances: squared L2 for f32 and bf16 operands,
// Hamming for packed uint32 words. A leading batch axis B (one image pair per
// entry) is covered by one launch: grid.y walks it.
//
// Semantics:
//   * masked db rows never win; a query whose db is all masked gets idx -1
//     and best = second = 1e30;
//   * ties go to the LOWEST global db index: (dist, idx) is compared
//     lexicographically, in the per-thread updates (a thread visits its
//     columns in ascending index order, so a strict < suffices there) and in
//     the cross-thread merge. This is tpusfm's nn_search_xla rule; the TPU
//     kernel picks the lowest column of a tile, then the earliest tile, and
//     can return a higher index on ties;
//   * D is arbitrary (no padding): the staging loop zero-fills ragged edges.
//
// Design (right and simple first): a block takes a 64-query tile of one
// pair, loops over 64-row db tiles staged through shared memory in 32-wide
// D chunks, and each of its 256 threads accumulates a 4x4 register tile of
// dot products (L2: |q|^2 + |db|^2 - 2 q.db, the norms precomputed by
// prep_kernel; Hamming: popcount(a ^ b)). Each thread keeps a running
// (best, second, idx) per query in registers; at the end the 16 threads that
// share a query row merge with warp shuffles. The per-column accumulators of
// the TPU kernel existed because cross-lane reductions are costly on a TPU;
// here the reduction is a 4-step shuffle at the end.
//
// What bounds it on this card: at 10k x 10k x 128 in f32 the work is
// 2 * 10k * 10k * 128 FLOPs per direction and pair, done as FP32 FMAs on
// the CUDA cores (no TF32, no tensor cores), so it is compute-bound on the
// FP32 pipes and shared-memory bandwidth (two 16-byte shared loads feed
// 16 FMAs). wgmma on bf16/TF32-split operands and TMA-fed pipelines are
// later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;    // queries per block
constexpr int TD = 64;    // db rows per tile
constexpr int KC = 32;    // D chunk staged per step
constexpr int NT = 256;   // threads per block: 16 x 16, each a 4x4 tile
constexpr int PAD = 4;    // keeps rows 16-byte aligned for vector loads
constexpr float BIG = 1e30f;

template <typename T> struct Op;

template <> struct Op<float> {
  using S = float;
  using V = float4;
  __device__ static S load(const float* p, size_t i) { return p[i]; }
  __device__ static float acc(float a, S x, S y) { return fmaf(x, y, a); }
  __device__ static float sq(const float* p, size_t i) { float v = p[i]; return v * v; }
};

template <> struct Op<__nv_bfloat16> {
  using S = float;
  using V = float4;
  __device__ static S load(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }
  __device__ static float acc(float a, S x, S y) { return fmaf(x, y, a); }
  __device__ static float sq(const __nv_bfloat16* p, size_t i) {
    float v = __bfloat162float(p[i]);
    return v * v;
  }
};

template <> struct Op<uint32_t> {
  using S = uint32_t;
  using V = uint4;
  __device__ static S load(const uint32_t* p, size_t i) { return p[i]; }
  __device__ static float acc(float a, S x, S y) { return a + (float)__popc(x ^ y); }
  __device__ static float sq(const uint32_t*, size_t) { return 0.f; }
};

// Per-row |x|^2 (L2) and the db penalty row: out = |x|^2 where valid, BIG
// where masked. For Hamming the norms are 0.
template <typename T>
__global__ void prep_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                            float* __restrict__ out, int rows, int D) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float s = 0.f;
  for (int k = 0; k < D; ++k) s += Op<T>::sq(x, (size_t)r * D + k);
  out[r] = (mask == nullptr || mask[r] != 0.f) ? s : BIG;
}

template <typename T>
__global__ void __launch_bounds__(NT)
nn_top2_kernel(const T* __restrict__ q, const T* __restrict__ db,
               const float* __restrict__ qn, const float* __restrict__ pen,
               int* __restrict__ idx_out, float* __restrict__ best_out,
               float* __restrict__ second_out, int Nq, int Ndb, int D, int l2) {
  using S = typename Op<T>::S;
  using V = typename Op<T>::V;
  __shared__ __align__(16) S qs[KC][TQ + PAD];
  __shared__ __align__(16) S ds[KC][TD + PAD];
  __shared__ float pen_s[TD];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int t = threadIdx.x;
  const int tx = t % 16;   // db columns tx*4 .. tx*4+3 of each tile
  const int ty = t / 16;   // query rows ty*4 .. ty*4+3 of the block
  const T* qb = q + (size_t)b * Nq * D;
  const T* dbb = db + (size_t)b * Ndb * D;
  const float* penb = pen + (size_t)b * Ndb;

  float qn_r[4], best[4], second[4];
  int bidx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int qi = q0 + ty * 4 + i;
    qn_r[i] = (l2 && qi < Nq) ? qn[(size_t)b * Nq + qi] : 0.f;
    best[i] = BIG;
    second[i] = BIG;
    bidx[i] = -1;
  }

  for (int d0 = 0; d0 < Ndb; d0 += TD) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KC) {
      __syncthreads();  // every thread is done with the previous chunk and pen_s
      if (k0 == 0 && t < TD) pen_s[t] = (d0 + t < Ndb) ? penb[d0 + t] : BIG;
      for (int e = t; e < TQ * KC; e += NT) {
        int r = e / KC, k = e % KC;   // consecutive threads: consecutive k of one row
        int kk = k0 + k;
        int qi = q0 + r, dj = d0 + r;
        qs[k][r] = (qi < Nq && kk < D) ? Op<T>::load(qb, (size_t)qi * D + kk) : S(0);
        ds[k][r] = (dj < Ndb && kk < D) ? Op<T>::load(dbb, (size_t)dj * D + kk) : S(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        V av = *reinterpret_cast<const V*>(&qs[k][ty * 4]);
        V cv = *reinterpret_cast<const V*>(&ds[k][tx * 4]);
        S a[4] = {av.x, av.y, av.z, av.w};
        S c[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = Op<T>::acc(acc[i][j], a[i], c[j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int jl = tx * 4 + j;
      float p = pen_s[jl];
      if (p >= 0.5f * BIG) continue;  // masked or past the end: never wins
      int g = d0 + jl;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float dist = l2 ? fmaxf(qn_r[i] + p - 2.f * acc[i][j], 0.f) : acc[i][j];
        if (dist < best[i]) {
          second[i] = best[i];
          best[i] = dist;
          bidx[i] = g;
        } else if (dist < second[i]) {
          second[i] = dist;
        }
      }
    }
  }

  // Merge the 16 partial results of each query row (lanes tx = 0..15 of one
  // half-warp) lexicographically on (best, idx).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float bb = best[i], ss = second[i];
    int ix = bidx[i];
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      float ob = __shfl_xor_sync(0xffffffffu, bb, off);
      float os = __shfl_xor_sync(0xffffffffu, ss, off);
      int oi = __shfl_xor_sync(0xffffffffu, ix, off);
      bool take = (ob < bb) || (ob == bb && (unsigned)oi < (unsigned)ix);
      float loser = take ? bb : ob;
      ss = fminf(fminf(ss, os), loser);
      if (take) {
        bb = ob;
        ix = oi;
      }
    }
    int qi = q0 + ty * 4 + i;
    if (tx == 0 && qi < Nq) {
      size_t o = (size_t)b * Nq + qi;
      bool none = bb >= 0.5f * BIG;
      idx_out[o] = none ? -1 : ix;
      best_out[o] = none ? BIG : bb;
      second_out[o] = ss >= 0.5f * BIG ? BIG : ss;
    }
  }
}

template <typename T>
int launch(const void* q, const void* db, const float* mask, float* qn, float* pen,
           int* idx, float* best, float* second, int B, int Nq, int Ndb, int D, int l2,
           cudaStream_t s) {
  const int th = 256;
  if (l2) {
    int rq = B * Nq;
    prep_kernel<T><<<(rq + th - 1) / th, th, 0, s>>>(static_cast<const T*>(q), nullptr, qn, rq, D);
  }
  int rd = B * Ndb;
  if (rd > 0)
    prep_kernel<T><<<(rd + th - 1) / th, th, 0, s>>>(static_cast<const T*>(db), mask, pen,
                                                     rd, l2 ? D : 0);
  dim3 grid((Nq + TQ - 1) / TQ, B);
  nn_top2_kernel<T><<<grid, NT, 0, s>>>(static_cast<const T*>(q), static_cast<const T*>(db),
                                        qn, pen, idx, best, second, Nq, Ndb, D, l2);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 = f32 L2, 1 = bf16 L2, 2 = Hamming on uint32 words (D = words).
// q (B, Nq, D), db (B, Ndb, D), mask (B, Ndb) f32 nonzero = valid;
// qn (B, Nq) and pen (B, Ndb) f32 scratch; outputs idx (B, Nq) i32,
// best/second (B, Nq) f32. All contiguous, on the device of `stream`.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int tpusfm_nn_search(const void* q, const void* db, const void* mask, void* qn,
                                void* pen, void* idx, void* best, void* second, int B,
                                int Nq, int Ndb, int D, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* qnf = static_cast<float*>(qn);
  float* penf = static_cast<float*>(pen);
  int* ix = static_cast<int*>(idx);
  float* bo = static_cast<float*>(best);
  float* so = static_cast<float*>(second);
  switch (variant) {
    case 0: return launch<float>(q, db, m, qnf, penf, ix, bo, so, B, Nq, Ndb, D, 1, s);
    case 1: return launch<__nv_bfloat16>(q, db, m, qnf, penf, ix, bo, so, B, Nq, Ndb, D, 1, s);
    case 2: return launch<uint32_t>(q, db, m, qnf, penf, ix, bo, so, B, Nq, Ndb, D, 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
