// Brute-force nearest-neighbour search with a running top-2, for Hopper (sm_90a).
//
// Replaces the TPU kernel tpusfm/kernels/distance.py:nn_search_pallas (body
// _nn_kernel). For each query row of q (B, Nq, D) it finds, over the rows of
// db (B, Ndb, D) that the mask marks valid, the index of the nearest row and
// the best and second-best distances: squared L2 for f32 and bf16 operands,
// Hamming for packed uint32 words. A leading batch axis B (one image pair per
// entry) is covered by one call.
//
// Semantics:
//   * masked db rows never win; a query whose db is all masked gets idx -1
//     and best = second = 1e30;
//   * ties go to the LOWEST global db index: (dist, idx) is compared
//     lexicographically, in the per-thread updates (a thread visits its
//     columns in ascending index order, so a strict < suffices there) and in
//     every merge across threads and db slices. This is tpusfm's
//     nn_search_xla rule;
//   * D, Nq and Ndb are arbitrary: the prep kernel pads D with zeros to a
//     whole 128-byte K chunk and the row counts to whole 128-row tiles.
//
// What bounds it on this card. At B=2, 10000 x 10000 x 128 the L2 variants do
// 2 * B * Nq * Ndb * D = 5.12e10 multiply-adds' worth of FLOPs and move at
// most ~21 MB, so they are compute-bound by ~50x. In bf16 the tensor cores
// give 989 TFLOP/s (0.052 ms); f32 is computed as 3xTF32, three TF32
// products per term at 495 TFLOP/s (0.310 ms); the CUDA cores' 67 TFLOP/s
// f32 would need 0.764 ms. The design:
//
//   * Tensor cores through wgmma (m64n128, operands from shared memory, K
//     major, no swizzle). f32 is split x = hi + lo, hi = tf32(x) and
//     lo = tf32(x - hi), both rounded with cvt.rna, and each K step issues
//     q_hi.db_lo and q_lo.db_hi before q_hi.db_hi into one f32 accumulator:
//     ~22 significand bits against TF32's 11, the counterpart of the TPU's
//     Precision.HIGHEST. bf16 is one m64n128k16 pass (its products are exact
//     in f32).
//   * A prep kernel does the per-row work once, a warp per row: |x|^2 in f32
//     from the original values, the penalty row (+inf where masked or past
//     Ndb), and the operands re-laid in wgmma core-matrix order (8 rows x 16
//     bytes contiguous), cut into 128-row x 128-byte chunk tiles of 16 KB
//     that are contiguous in memory. So no tensor map is needed: one
//     cp.async.bulk per chunk moves it, and wgmma reads 128-byte core
//     matrices without bank conflicts.
//   * A block is 3 warpgroups: a producer and two consumers of 64 query rows
//     each (a 128-row query tile). The query tile is loaded once and stays
//     resident in shared memory for the block's whole db sweep when it fits
//     (f32: 128 rows x Dp x 8 bytes, Dp <= 128); db chunks stream through a
//     ring of mbarrier-guarded stages. Wider D streams the query chunk beside
//     each db chunk instead. Budget at f32, D = 128: 128 KB resident queries
//     + 3 stages x 32 KB (hi and lo of 128 db rows x 32 K) = 224 KB of the
//     227 KB; at bf16, D = 128: 32 KB + 8 stages x 16 KB.
//   * The top-2 epilogue stays in registers. Lane t of warp w of a consumer
//     holds rows 16w + t/4 and +8 at columns 8j + 2(t%4) + {0,1}; it keeps a
//     running (best, second, idx) for its two rows, visiting columns in
//     ascending order, and the four lanes of a quad merge at the end with
//     two shuffles. No distance block is ever written to memory. The
//     epilogue costs ~8 instructions a value (most at half rate), 64 values
//     a thread a tile: ~1,800 issue cycles a tile on each scheduler against
//     6,144 tensor cycles (f32) or 1,024 (bf16), and the two consumers run
//     it in step. Overlapping it with the next tile's products (ping-pong
//     consumers; a second accumulator) and skipping values above the quad's
//     running second were tried; none was faster at the main path's shape
//     (PERF.md), so bf16 stays bound by this epilogue.
//   * Full waves: one block fills an SM (224 KB), and B * ceil(Nq/128) query
//     tiles alone are 1.2 waves at B=2, Nq=10k. The db axis is split into S
//     slices chosen from the tile counts and the SM count so that the work
//     items come close to whole waves; each block writes a partial top-2 per
//     query and a merge kernel reduces the S partials lexicographically,
//     in the same C call.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): f32 0.48 ms
// (65% of its bound), bf16 0.18 ms (28%). ptxas -v (CUDA 12.8): the wgmma
// kernel uses 134 registers with no spills; its dynamic shared memory is
// 229,632 bytes at f32, D = 128 and 164,096 at bf16, D = 128.
//
// Hamming (variant 2) keeps the first port's CUDA-core kernel: a 64x64
// tile of 4x4 register blocks of popcount(a ^ b) over packed words staged
// through shared memory, with the same top-2 and tie rule. It stays off the
// tensor cores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e30f;

// ---------------------------------------------------------------- L2, wgmma
constexpr int ROWS = 128;                 // rows of a tile: the query tile and the wgmma N
constexpr int CHUNK = 128;                // bytes of K per row in one chunk tile
constexpr int TILE_BYTES = ROWS * CHUNK;  // one plane of one chunk tile: 16 KB
constexpr int NCONS = 2;                  // consumer warpgroups, 64 query rows each
constexpr int NTHREADS = 128 * (NCONS + 1);
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = 256;            // mbarriers at the start of shared memory
constexpr int SMEM_LIMIT = 232448;        // 227 KB a block can use on sm_90
constexpr int MAX_SPLITS = 32;

// f32 is stored as two planes (tf32 hi, lo), bf16 as one.
struct F32 {
  using T = float;
  static constexpr int planes = 2, elem = 4;
};
struct BF16 {
  using T = __nv_bfloat16;
  static constexpr int planes = 1, elem = 2;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void store_elem(F32, uint8_t* dst, float v) {
  uint32_t hi = tf32_rna(v);
  *reinterpret_cast<uint32_t*>(dst) = hi;
  *reinterpret_cast<uint32_t*>(dst + TILE_BYTES) = tf32_rna(v - __uint_as_float(hi));
}
__device__ __forceinline__ void store_elem(BF16, uint8_t* dst, float v) {
  *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16(v);  // exact: v came from bf16
}

// One warp per (pair, padded row): |x|^2, the operand in chunk-tile order,
// and for the db (pen != nullptr) the penalty row: |x|^2 where valid, +inf
// where masked or past N. For the queries norm (B, N) gets |x|^2.
// Chunk tile (b, tile, kc, plane) sits at ((b*ntiles + tile)*nkc + kc)*planes + plane
// in units of TILE_BYTES; element (r, k) of it at byte
// ((r/8)*8 + kb/16)*128 + (r%8)*16 + kb%16, kb = k * elem.
template <class V>
__global__ void prep_kernel(const typename V::T* __restrict__ x, const float* __restrict__ mask,
                            uint8_t* __restrict__ out, float* __restrict__ norm,
                            float* __restrict__ pen, int B, int N, int ntiles, int D, int nkc) {
  constexpr int KE = CHUNK / V::elem;  // elements of K per chunk
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int rows_p = ntiles * ROWS;
  if (warp >= B * rows_p) return;
  const int b = warp / rows_p, r = warp % rows_p, rr = r % ROWS;
  const bool live = r < N;
  const typename V::T* row = x + ((size_t)b * N + (live ? r : 0)) * D;
  uint8_t* base = out + (size_t)(b * ntiles + r / ROWS) * nkc * V::planes * TILE_BYTES +
                  ((rr / 8) * 8) * 128 + (rr % 8) * 16;
  float s = 0.f;
  for (int k = lane; k < nkc * KE; k += 32) {
    const float v = (live && k < D) ? to_float(row[k]) : 0.f;
    s = fmaf(v, v, s);
    const int kb = (k % KE) * V::elem;
    store_elem(V{}, base + (size_t)(k / KE) * V::planes * TILE_BYTES + (kb / 16) * 128 + kb % 16,
               v);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  if (pen != nullptr)
    pen[(size_t)b * rows_p + r] =
        (live && mask[(size_t)b * N + r] != 0.f) ? s : __int_as_float(0x7f800000);
  else if (live)
    norm[(size_t)b * N + r] = s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Contiguous global -> shared copy by the bulk-copy engine, completion
// counted in bytes on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, no swizzle, K major: core matrices of
// 8 rows x 16 bytes, the next one along K 128 bytes on (LBO), the next
// 8-row group 1024 bytes on (SBO: 8 core matrices per 128-byte chunk row).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32);
}

#define WG_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
#define WG_REGS                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) = [d +] A (64 x 8 tf32) . B (128 x 8 tf32)^T
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_REGS
      ", %64, %65, p, 1, 1;\n}\n"
      : WG_ACC
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) = [d +] A (64 x 16 bf16) . B (128 x 16 bf16)^T
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC
      : "l"(a), "l"(b), "r"(accumulate));
}

// One 128-byte K chunk into d: 4 wgmma K steps of 32 bytes, i.e. two core
// matrix columns (256 bytes on) each. a and b are the shared addresses of the
// chunk's first plane at this warpgroup's rows.
__device__ __forceinline__ void mma_chunk(F32, float* d, uint32_t a, uint32_t b, int first) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t ao = a + ks * 256, bo = b + ks * 256;
    // the two small terms first, then hi.hi
    wgmma_tf32(d, desc(ao), desc(bo + TILE_BYTES), !(first && ks == 0));
    wgmma_tf32(d, desc(ao + TILE_BYTES), desc(bo), 1);
    wgmma_tf32(d, desc(ao), desc(bo), 1);
  }
}
__device__ __forceinline__ void mma_chunk(BF16, float* d, uint32_t a, uint32_t b, int first) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_bf16(d, desc(a + ks * 256), desc(b + ks * 256), !(first && ks == 0));
}

__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Lexicographic (dist, idx) merge of two partial top-2s into (bb, ss, ix).
__device__ __forceinline__ void merge_top2(float& bb, float& ss, int& ix, float ob, float os,
                                           int oi) {
  const bool take = (ob < bb) || (ob == bb && (unsigned)oi < (unsigned)ix);
  const float loser = take ? bb : ob;
  ss = fminf(fminf(ss, os), loser);
  if (take) {
    bb = ob;
    ix = oi;
  }
}

// Work item blockIdx.x = (b * nqt + qt) * S + s: query tile qt of pair b
// against db tiles [s*ndt/S, (s+1)*ndt/S). qp/dp are the prepped operands,
// qn (B, Nq), pen (B, ndt*128). Outputs at ((b*S + s)*Nq + row): the final
// result when S == 1, partials for merge_kernel otherwise.
template <class V>
__global__ void __launch_bounds__(NTHREADS, 1)
nn_wgmma_kernel(const uint8_t* __restrict__ qp, const uint8_t* __restrict__ dp,
                const float* __restrict__ qn, const float* __restrict__ pen,
                int* __restrict__ idx_out, float* __restrict__ best_out,
                float* __restrict__ second_out, int Nq, int nqt, int ndt, int nkc, int S,
                int resident, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr uint32_t PLANE_SET = V::planes * TILE_BYTES;  // one chunk tile, all planes
  const uint32_t stage_bytes = (resident ? 1 : 2) * PLANE_SET;
  const uint32_t bars = smem_u32(smem);  // full[MAX_STAGES], empty[MAX_STAGES], q
  const uint32_t qbar = bars + 16 * MAX_STAGES;
  const uint32_t qres = bars + BAR_BYTES;
  const uint32_t ring = qres + (resident ? nkc * PLANE_SET : 0);

  int item = blockIdx.x;
  const int s = item % S;
  item /= S;
  const int qt = item % nqt, b = item / nqt;
  const int t0 = (int)((long long)s * ndt / S), t1 = (int)((long long)(s + 1) * ndt / S);

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (MAX_STAGES + i), 128 * NCONS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const uint8_t* qsrc = qp + (size_t)(b * nqt + qt) * nkc * PLANE_SET;
  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x != 0 || t0 == t1) return;
    if (resident) {
      mbar_expect_tx(qbar, nkc * PLANE_SET);
      bulk_load(qres, qsrc, nkc * PLANE_SET, qbar);
    }
    int stage = 0;
    uint32_t phase = 1;  // a fresh barrier counts as released
    for (int t = t0; t < t1; ++t) {
      const uint8_t* dsrc = dp + (size_t)(b * ndt + t) * nkc * PLANE_SET;
      for (int kc = 0; kc < nkc; ++kc) {
        mbar_wait(bars + 8 * (MAX_STAGES + stage), phase);
        const uint32_t full = bars + 8 * stage, dst = ring + stage * stage_bytes;
        mbar_expect_tx(full, stage_bytes);
        bulk_load(dst, dsrc + (size_t)kc * PLANE_SET, PLANE_SET, full);
        if (!resident) bulk_load(dst + PLANE_SET, qsrc + (size_t)kc * PLANE_SET, PLANE_SET, full);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup c owns query rows 64c .. 64c+63 of the tile.
  const int c = wg - 1, ct = threadIdx.x - 128 * wg;
  const int lane = ct & 31, quad = lane & 3;
  const int r0 = qt * ROWS + c * 64 + (ct >> 5) * 16 + (lane >> 2);  // and r0 + 8
  float qnr[2], best[2], second[2];
  int bidx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qnr[h] = r0 + 8 * h < Nq ? qn[(size_t)b * Nq + r0 + 8 * h] : 0.f;
    best[h] = BIG;
    second[h] = BIG;
    bidx[h] = -1;
  }

  if (t0 < t1) {
    if (resident) mbar_wait(qbar, 0);
    __syncwarp();  // reconverge before the .aligned wgmma instructions
    const uint32_t a_rows = c * 64 / 8 * 1024;  // this warpgroup's first 8-row group
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int t = t0; t < t1; ++t) {
      // Penalties of this thread's 32 columns, loaded while the products run.
      const float2* pt =
          reinterpret_cast<const float2*>(pen + ((size_t)b * ndt + t) * ROWS) + quad;
      float2 p[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) p[j] = __ldg(pt + 4 * j);

      for (int kc = 0; kc < nkc; ++kc) {
        mbar_wait(bars + 8 * stage, phase);
        __syncwarp();
        const uint32_t bsm = ring + stage * stage_bytes;
        const uint32_t asm_ = (resident ? qres + kc * PLANE_SET : bsm + PLANE_SET) + a_rows;
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        mma_chunk(V{}, d, asm_, bsm, kc == 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if (kc > 0) {  // the previous chunk's products are done: release its stage
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          mbar_arrive(bars + 8 * (MAX_STAGES + prev));
        }
        prev = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(d);
      mbar_arrive(bars + 8 * (MAX_STAGES + prev));

      // Top-2 over this tile: dist = max(|q|^2 + pen - 2 q.db, 0); pen is
      // +inf where masked, so those columns never win.
      const int col0 = t * ROWS + 2 * quad;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pp = e ? p[j].y : p[j].x;
          const int col = col0 + 8 * j + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float dist = fmaxf(fmaf(-2.f, d[4 * j + 2 * h + e], qnr[h] + pp), 0.f);
            const bool lt = dist < best[h];
            second[h] = lt ? best[h] : fminf(second[h], dist);
            bidx[h] = lt ? col : bidx[h];
            best[h] = lt ? dist : best[h];
          }
        }
      }
    }
  }

  // Merge the four lanes of a quad (they share rows), then write.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float bb = best[h], ss = second[h];
    int ix = bidx[h];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, bb, off);
      const float os = __shfl_xor_sync(0xffffffffu, ss, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
      merge_top2(bb, ss, ix, ob, os, oi);
    }
    const int row = r0 + 8 * h;
    if (quad == 0 && row < Nq) {
      const size_t o = ((size_t)b * S + s) * Nq + row;
      idx_out[o] = ix;
      best_out[o] = bb;
      second_out[o] = ss;
    }
  }
}

// Reduce the S partial top-2s of each query, lexicographically on (dist, idx).
__global__ void merge_kernel(const int* __restrict__ pi, const float* __restrict__ pb,
                             const float* __restrict__ ps, int* __restrict__ idx,
                             float* __restrict__ best, float* __restrict__ second, int B, int Nq,
                             int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * Nq) return;
  const int b = i / Nq, q = i % Nq;
  float bb = BIG, ss = BIG;
  int ix = -1;
  for (int s = 0; s < S; ++s) {
    const size_t o = ((size_t)b * S + s) * Nq + q;
    merge_top2(bb, ss, ix, pb[o], ps[o], pi[o]);
  }
  idx[i] = ix;
  best[i] = bb;
  second[i] = ss;
}

// ------------------------------------------------------ Hamming, CUDA cores
constexpr int TQ = 64;    // queries per block
constexpr int TD = 64;    // db rows per tile
constexpr int KC = 32;    // words staged per step
constexpr int NT = 256;   // threads per block: 16 x 16, each a 4x4 tile
constexpr int PAD = 4;    // keeps rows 16-byte aligned for vector loads

// pen[r] = 0 where valid, BIG where masked.
__global__ void hamming_pen_kernel(const float* __restrict__ mask, float* __restrict__ pen,
                                   int rows) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < rows) pen[r] = mask[r] != 0.f ? 0.f : BIG;
}

__global__ void __launch_bounds__(NT)
hamming_top2_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ db,
                    const float* __restrict__ pen, int* __restrict__ idx_out,
                    float* __restrict__ best_out, float* __restrict__ second_out, int Nq,
                    int Ndb, int D) {
  __shared__ __align__(16) uint32_t qs[KC][TQ + PAD];
  __shared__ __align__(16) uint32_t ds[KC][TD + PAD];
  __shared__ float pen_s[TD];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int t = threadIdx.x;
  const int tx = t % 16;   // db columns tx*4 .. tx*4+3 of each tile
  const int ty = t / 16;   // query rows ty*4 .. ty*4+3 of the block
  const uint32_t* qb = q + (size_t)b * Nq * D;
  const uint32_t* dbb = db + (size_t)b * Ndb * D;
  const float* penb = pen + (size_t)b * Ndb;

  float best[4], second[4];
  int bidx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
        int r = e / KC, k = e % KC;
        int kk = k0 + k;
        int qi = q0 + r, dj = d0 + r;
        qs[k][r] = (qi < Nq && kk < D) ? qb[(size_t)qi * D + kk] : 0u;
        ds[k][r] = (dj < Ndb && kk < D) ? dbb[(size_t)dj * D + kk] : 0u;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        uint4 av = *reinterpret_cast<const uint4*>(&qs[k][ty * 4]);
        uint4 cv = *reinterpret_cast<const uint4*>(&ds[k][tx * 4]);
        uint32_t a[4] = {av.x, av.y, av.z, av.w};
        uint32_t c[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += (float)__popc(a[i] ^ c[j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int jl = tx * 4 + j;
      if (pen_s[jl] >= 0.5f * BIG) continue;  // masked or past the end: never wins
      int g = d0 + jl;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float dist = acc[i][j];
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
      merge_top2(bb, ss, ix, ob, os, oi);
    }
    int qi = q0 + ty * 4 + i;
    if (tx == 0 && qi < Nq) {
      size_t o = (size_t)b * Nq + qi;
      idx_out[o] = ix;
      best_out[o] = bb;
      second_out[o] = ss;
    }
  }
}

// ------------------------------------------------------------------ host
size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

// The launch plan of one L2 call and the workspace regions it needs.
struct Plan {
  int nqt, ndt, nkc, S, resident, stages;
  size_t smem, qp, dp, qn, pen, part, total;  // byte offsets into the workspace
};

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Splits of the db axis: the S that minimises whole waves of work items
// (one block per SM) times the db tiles an item sweeps, plus one tile's
// worth of set-up and write-out per item.
int choose_splits(int items, int ndt, int nsm) {
  int best_s = 1;
  long long best_cost = -1;
  for (int s = 1; s <= ndt && s <= MAX_SPLITS; ++s) {
    long long waves = ((long long)items * s + nsm - 1) / nsm;
    long long cost = waves * ((ndt + s - 1) / s + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_s = s;
    }
  }
  return best_s;
}

Plan make_plan(int B, int Nq, int Ndb, int D, int variant) {
  Plan p{};
  const int planes = variant == 0 ? 2 : 1, elem = variant == 0 ? 4 : 2;
  const size_t set = (size_t)planes * TILE_BYTES;
  p.nqt = (Nq + ROWS - 1) / ROWS;
  p.ndt = (Ndb + ROWS - 1) / ROWS;
  p.nkc = (D * elem + CHUNK - 1) / CHUNK;
  const size_t qres = p.nkc * set;
  p.resident = BAR_BYTES + qres + 2 * set <= (size_t)SMEM_LIMIT;
  const size_t stage = p.resident ? set : 2 * set;
  size_t room = SMEM_LIMIT - BAR_BYTES - (p.resident ? qres : 0);
  p.stages = (int)(room / stage < MAX_STAGES ? room / stage : MAX_STAGES);
  p.smem = BAR_BYTES + (p.resident ? qres : 0) + p.stages * stage;
  p.S = p.ndt > 0 ? choose_splits(B * p.nqt, p.ndt, sm_count()) : 1;
  p.qp = 0;
  p.dp = align256(p.qp + (size_t)B * p.nqt * p.nkc * set);
  p.qn = align256(p.dp + (size_t)B * p.ndt * p.nkc * set);
  p.pen = align256(p.qn + (size_t)B * Nq * 4);
  p.part = align256(p.pen + (size_t)B * p.ndt * ROWS * 4);
  p.total = p.S > 1 ? align256(p.part + (size_t)3 * B * p.S * Nq * 4) : p.part;
  return p;
}

template <class V>
int launch_l2(const void* q, const void* db, const float* mask, uint8_t* ws, int* idx,
              float* best, float* second, int B, int Nq, int Ndb, int D, cudaStream_t st) {
  using T = typename V::T;
  const Plan p = make_plan(B, Nq, Ndb, D, V::planes == 2 ? 0 : 1);
  float* qn = reinterpret_cast<float*>(ws + p.qn);
  float* pen = reinterpret_cast<float*>(ws + p.pen);
  const int th = 256, rows_per_block = th / 32;
  prep_kernel<V><<<(B * p.nqt * ROWS + rows_per_block - 1) / rows_per_block, th, 0, st>>>(
      static_cast<const T*>(q), nullptr, ws + p.qp, qn, nullptr, B, Nq, p.nqt, D, p.nkc);
  if (p.ndt > 0)
    prep_kernel<V><<<(B * p.ndt * ROWS + rows_per_block - 1) / rows_per_block, th, 0, st>>>(
        static_cast<const T*>(db), mask, ws + p.dp, nullptr, pen, B, Ndb, p.ndt, D, p.nkc);
  cudaError_t e = cudaFuncSetAttribute(nn_wgmma_kernel<V>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  int* pi = idx;
  float *pb = best, *ps = second;
  if (p.S > 1) {
    pi = reinterpret_cast<int*>(ws + p.part);
    pb = reinterpret_cast<float*>(ws + p.part) + (size_t)B * p.S * Nq;
    ps = pb + (size_t)B * p.S * Nq;
  }
  nn_wgmma_kernel<V><<<B * p.nqt * p.S, NTHREADS, p.smem, st>>>(
      ws + p.qp, ws + p.dp, qn, pen, pi, pb, ps, Nq, p.nqt, p.ndt, p.nkc, p.S, p.resident,
      p.stages);
  if (p.S > 1)
    merge_kernel<<<(B * Nq + th - 1) / th, th, 0, st>>>(pi, pb, ps, idx, best, second, B, Nq,
                                                       p.S);
  return (int)cudaGetLastError();
}

int launch_hamming(const void* q, const void* db, const float* mask, uint8_t* ws, int* idx,
                   float* best, float* second, int B, int Nq, int Ndb, int D, cudaStream_t st) {
  float* pen = reinterpret_cast<float*>(ws);
  const int th = 256, rd = B * Ndb;
  if (rd > 0) hamming_pen_kernel<<<(rd + th - 1) / th, th, 0, st>>>(mask, pen, rd);
  dim3 grid((Nq + TQ - 1) / TQ, B);
  hamming_top2_kernel<<<grid, NT, 0, st>>>(static_cast<const uint32_t*>(q),
                                           static_cast<const uint32_t*>(db), pen, idx, best,
                                           second, Nq, Ndb, D);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 = f32 L2, 1 = bf16 L2, 2 = Hamming on uint32 words (D = words).
// Bytes of device workspace that tpusfm_nn_search needs for these shapes on
// the current device; *splits (if not null) gets the number of db slices.
extern "C" long long tpusfm_nn_workspace(int B, int Nq, int Ndb, int D, int variant,
                                         int* splits) {
  if (variant == 2) {
    if (splits) *splits = 1;
    return (long long)align256((size_t)B * (Ndb > 0 ? Ndb : 1) * 4);
  }
  const Plan p = make_plan(B, Nq, Ndb, D, variant);
  if (splits) *splits = p.S;
  return (long long)p.total;
}

// q (B, Nq, D), db (B, Ndb, D), mask (B, Ndb) f32 nonzero = valid; ws the
// workspace of tpusfm_nn_workspace's size; outputs idx (B, Nq) i32,
// best/second (B, Nq) f32. All contiguous, on the current device; kernels
// go to `stream`. Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int tpusfm_nn_search(const void* q, const void* db, const void* mask, void* ws,
                                void* idx, void* best, void* second, int B, int Nq, int Ndb,
                                int D, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  uint8_t* w = static_cast<uint8_t*>(ws);
  int* ix = static_cast<int*>(idx);
  float* bo = static_cast<float*>(best);
  float* so = static_cast<float*>(second);
  switch (variant) {
    case 0: return launch_l2<F32>(q, db, m, w, ix, bo, so, B, Nq, Ndb, D, s);
    case 1: return launch_l2<BF16>(q, db, m, w, ix, bo, so, B, Nq, Ndb, D, s);
    case 2: return launch_hamming(q, db, m, w, ix, bo, so, B, Nq, Ndb, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
