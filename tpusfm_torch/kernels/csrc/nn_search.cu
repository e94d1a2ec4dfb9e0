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
//     lexicographically, in the per-thread updates (an L2 thread visits its
//     columns in ascending index order, so a strict < suffices there;
//     Hamming ranks keys that hold the index in their low bits) and in every
//     merge across threads and db slices. This is tpusfm's nn_search_xla
//     rule;
//   * D, Nq and Ndb are arbitrary: the prep kernels pad D with zeros to a
//     whole 128-byte K chunk and the row counts to whole 128-row tiles.
//
// What bounds it on this card. At B=2, 10000 x 10000 x 128 the L2 variants do
// 2 * B * Nq * Ndb * D = 5.12e10 multiply-adds' worth of FLOPs and move at
// most ~21 MB, so they are compute-bound by ~50x. In bf16 the tensor cores
// give 989 TFLOP/s (0.052 ms); f32 is computed as 3xTF32, three TF32
// products per term at 495 TFLOP/s (0.310 ms); the CUDA cores' 67 TFLOP/s
// f32 would need 0.764 ms. Hamming over the dense ORB grid, 1 x 168,750 x
// 168,750 x 8 words, is 2.85e10 pairs of 256 bits: 1.46e13 bit products,
// 7.37 ms at the int8 tensor cores' 1,979 TOP/s, against 54.5 ms for one
// popcount a word pair at the CUDA cores' 16 popcounts a clock per SM. The
// design:
//
//   * Tensor cores through wgmma (m64n128, operands from shared memory, K
//     major, no swizzle). f32 is split x = hi + lo, hi = tf32(x) and
//     lo = tf32(x - hi), both rounded with cvt.rna, and each K step issues
//     q_hi.db_lo and q_lo.db_hi before q_hi.db_hi into one f32 accumulator:
//     ~22 significand bits against TF32's 11, the counterpart of the TPU's
//     Precision.HIGHEST. bf16 is one m64n128k16 pass (its products are exact
//     in f32). Hamming is the TPU kernel's idea on Hopper's integer path:
//     the words are unpacked to 0/1 bytes and multiplied by m64n128k32
//     u8.u8 into s32 accumulators, one word a K step, exact for any D, and
//     Hamming(a, b) = popc(a) + popc(b) - 2 a.b.
//   * Prep kernels do the per-row work once, a warp per row: the operands
//     re-laid in wgmma core-matrix order (8 rows x 16 bytes contiguous), cut
//     into 128-row x 128-byte chunk tiles of 16 KB that are contiguous in
//     memory, so no tensor map is needed: one cp.async.bulk per chunk moves
//     it, and wgmma reads 128-byte core matrices without bank conflicts. For
//     L2 also |x|^2 in f32 from the original values and the penalty row
//     (+inf where masked or past Ndb). For Hamming the popcounts and a key
//     row (below); masked rows are written as zeros, so their products are 0.
//   * A block is 3 warpgroups: a producer and two consumers of 64 query rows
//     each (a 128-row query tile). The query tile is loaded once and stays
//     resident in shared memory for the block's whole db sweep when it fits
//     (f32: 128 rows x Dp x 8 bytes, Dp <= 128); db chunks stream through a
//     ring of mbarrier-guarded stages. Wider D streams the query chunk beside
//     each db chunk instead. Budget at f32, D = 128: 128 KB resident queries
//     + 3 stages x 32 KB (hi and lo of 128 db rows x 32 K) = 224 KB of the
//     227 KB; at bf16, D = 128: 32 KB + 8 stages x 16 KB; Hamming at 8 words:
//     32 KB + 8 stages x 16 KB.
//   * The top-2 epilogue stays in registers. Lane t of warp w of a consumer
//     holds rows 16w + t/4 and +8 at columns 8j + 2(t%4) + {0,1}; it keeps a
//     running top-2 for its two rows, and the four lanes of a quad merge at
//     the end with two shuffles. No distance block is ever written to
//     memory. L2 keeps (best, second, idx) in f32 and visits columns in
//     ascending order: ~8 instructions a value (most at half rate), 64
//     values a thread a tile, ~1,800 issue cycles a tile on each scheduler
//     against 6,144 tensor cycles (f32) or 1,024 (bf16), and the two
//     consumers run it in step.
//   * bf16 where every block sweeps at least DUAL_SWEEP db tiles (the dense
//     searches: 1,319 tiles at 450x375, 22,921 in the portrait) runs
//     BF16Dual. Its fold first bounds each value from below with the same
//     operations rounded down (add.rm, fma.rm) and keeps each row's minimum,
//     3 instructions a value; only a warp with a lane whose minimum lies
//     below that row's running second, or is NaN, runs the full fold, so
//     the result is bit for bit the one-accumulator path's. Over a long
//     sweep few warp-tiles need it (1.2% at the portrait's). Two
//     accumulators let tile t be folded after tile t + 1's wgmma are issued.
//     Issuing a wgmma holds the warp until the tensor cores take it,
//     though, so the fold overlaps only the products still queued when the
//     issue ends; ping-pong consumers and a scan interleaved between the
//     wgmma did no better (PERF.md). Shorter sweeps keep one accumulator:
//     there the running seconds still skip little.
//   * Hamming's epilogue is integer. Each db column has a key base,
//     ((popc(db) + 32 D) << s) | column (the column is global, s the bits
//     the padded db needs), or the sentinel field 64 D + 1 in place of the
//     popcount term where masked or past Ndb. A column's key is then
//     base - (a.b << (s + 1)): its high field is the distance minus popc(q)
//     plus 32 D, in [0, 64 D], and the lowest index among equal distances is
//     the least key. The running top-2 is b2 = min(b2, max(b1, k)),
//     b1 = min(b1, k): one multiply-add and three integer min/max a value,
//     with no branch and no tie rule; the quad shuffles and the decode at
//     the write-out (popc(q) added back, exact in f32) follow. When the
//     field and the index do not fit 32 bits together the key is 64 bits:
//     the field above, the column below, the base row holding the field
//     only.
//   * Hamming at 8 words has only 1,024 tensor cycles of products a 128 x
//     128 tile (8 m64n128k32 a consumer) against ~700 issue cycles of that
//     epilogue on each scheduler, so the epilogue has to run beside the
//     products, not after them. Each consumer keeps two accumulators: the
//     products of db tile t + 1 are issued before the epilogue of tile t
//     (ptxas ends a wgmma group at each pass of the chunk loop, so the
//     wait_group 1 below also waits for tile t + 1's chunks: PERF.md). That
//     needs 128 accumulator and 64 key registers a thread: setmaxnreg gives
//     the consumers 232 registers a thread and the producer 40. The plan
//     takes this path (Bits<uint32_t, true>) where the queries are resident
//     and the ring holds two db tiles, which covers every ORB call (8
//     words); other Hamming shapes run products and epilogue in turn, as L2
//     does. Tried and not kept (PERF.md): the two consumers taking turns at
//     the tensor cores (ping-pong), two query tiles a block (fewer db
//     passes), more independent top-2 chains, a pairwise 3-input min.
//   * Full waves: one block fills an SM (224 KB), and B * ceil(Nq/128) query
//     tiles alone are 1.2 waves at B=2, Nq=10k. The db axis is split into S
//     slices chosen from the tile counts and the SM count so that the work
//     items come close to whole waves; each block writes a partial top-2 per
//     query and a merge kernel reduces the S partials lexicographically,
//     in the same C call.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUDA events): f32 0.48 ms
// (65% of its bound), bf16 0.18 ms (28%), Hamming at the dense ORB shape
// ~13.3 ms (55% of its int8 bound; the earlier CUDA-core popcount kernel
// took 240 ms), bf16 at 1 x 168,750^2 13.7 ms (20.3 ms on one accumulator)
// and at a portrait launch's sweep, 16,896 rows against 2,933,814, 23.0 ms
// against 35.3 (56% of its 12.83 ms bound).
// scripts/torch_nn_ablate.py: at the dense ORB shape the products and the db
// streaming alone take ~7.7 ms, the epilogue and the streaming alone
// ~9.9 ms, the streaming alone ~3.7 ms; at the portrait's sweep (BF16Dual)
// 15.8, 15.9 and 6.8 ms. ptxas -v, no spills anywhere: f32 134 registers,
// bf16 136, Hamming 130 (64-bit keys 134), the two-accumulator kernels 168
// at launch; dynamic shared memory 229,632 bytes at f32, D = 128, 164,096
// at bf16, D = 128 and at Hamming, 8 words.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float BIG = 1e30f;

constexpr int ROWS = 128;                 // rows of a tile: the query tile and the wgmma N
constexpr int CHUNK = 128;                // bytes of K per row in one chunk tile
constexpr int TILE_BYTES = ROWS * CHUNK;  // one plane of one chunk tile: 16 KB
constexpr int NCONS = 2;                  // consumer warpgroups, 64 query rows each
constexpr int NTHREADS = 128 * (NCONS + 1);
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = 256;            // mbarriers at the start of shared memory
constexpr int SMEM_LIMIT = 232448;        // 227 KB a block can use on sm_90
constexpr int MAX_SPLITS = 32;

// Operand kinds. planes: planes of a chunk tile; elem: bytes of prepped
// operand per input element; dual: two accumulators a consumer (see the
// kernel). f32 is stored as two planes (tf32 hi, lo), bf16 as one; a
// Hamming word as 32 bytes of 0/1, ranked on keys of type K.
struct F32 {
  using T = float;
  using Acc = float;
  static constexpr int planes = 2, elem = 4;
  static constexpr bool bits = false, dual = false;
};
struct BF16 {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int planes = 1, elem = 2;
  static constexpr bool bits = false, dual = false;
};
struct BF16Dual : BF16 {  // two accumulators and the skipping top-2 fold
  static constexpr bool dual = true;
};
struct BitsOperand {
  static constexpr int planes = 1, elem = 32;
};
template <class K, bool Dual = false>
struct Bits : BitsOperand {
  using T = uint32_t;
  using Acc = int;
  static constexpr bool bits = true, dual = Dual;
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

// One operand of a Hamming prep launch: rows x (B, N, D) cut into ntiles
// 128-row tiles at out; for the queries norm (B, N), for the db mask (B, N)
// and the key row pen (B, ntiles * 128). One launch preps both operands, the
// queries' rows first: a sparse ORB call is host work, and a launch less
// shows in it.
struct Operand {
  const void* x;
  const float* mask;
  uint8_t* out;
  float* norm;
  void* pen;
  int N, ntiles;
};

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

// Hamming prep, one warp per (pair, padded row) of D uint32 words: the words
// unpacked to 0/1 bytes in chunk-tile order (bit s of word w is byte 32w + s,
// the order of distance.unpack_bits; a word fills two 16-byte core-matrix
// rows), zeros past D, past N and, for the db, where masked. Queries
// (key == nullptr): norm (B, N) gets popc(row) - 32 D in f32. Db: key
// (B, rows_p) gets the row's key base (see the header) with f = popc(row) +
// 32 D where valid and f = ksent where not: (f << kshift) | r for 32-bit
// keys (kshift < 32), f alone for 64-bit keys (kshift == 32).
__global__ void prep_bits_kernel(Operand q, Operand d, int B, int D, int nkc, int kshift,
                                 int ksent) {
  const int lane = threadIdx.x & 31, qrows = B * q.ntiles * ROWS;
  int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // the queries' rows first
  const Operand op = w < qrows ? q : d;
  if (w >= qrows) w -= qrows;
  const int N = op.N, ntiles = op.ntiles, rows_p = ntiles * ROWS;
  if (w >= B * rows_p) return;
  const int b = w / rows_p, r = w % rows_p, rr = r % ROWS;
  uint8_t* out = op.out;
  float* norm = op.norm;
  uint32_t* key = static_cast<uint32_t*>(op.pen);
  const bool live = r < N && (key == nullptr || op.mask[(size_t)b * N + r] != 0.f);
  const uint32_t* row =
      static_cast<const uint32_t*>(op.x) + ((size_t)b * N + (r < N ? r : 0)) * D;
  uint8_t* base = out + (size_t)(b * ntiles + r / ROWS) * nkc * TILE_BYTES +
                  ((rr / 8) * 8) * 128 + (rr % 8) * 16;
  int pop = 0;
  for (int w = lane; w < nkc * 4; w += 32) {
    const uint32_t v = (live && w < D) ? row[w] : 0u;
    pop += __popc(v);
    uint8_t* dst = base + (size_t)(w / 4) * TILE_BYTES + (w % 4) * 256;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)  // 4 bits -> 4 bytes: bit i lands on bit 8i
        p[i] = (((v >> (16 * half + 4 * i)) & 0xFu) * 0x00204081u) & 0x01010101u;
      *reinterpret_cast<uint4*>(dst + half * 128) = make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
  pop = __reduce_add_sync(0xffffffffu, pop);
  if (lane != 0) return;
  if (key != nullptr) {
    const uint32_t f = live ? (uint32_t)(pop + 32 * D) : (uint32_t)ksent;
    key[(size_t)b * rows_p + r] = kshift < 32 ? (f << kshift) | (uint32_t)r : f;
  } else if (r < N) {
    norm[(size_t)b * N + r] = (float)(pop - 32 * D);
  }
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

// The 64 accumulator operands of a m64n128 wgmma: "+f" for f32, "+r" for s32.
#define WG_D8(c, i)                                                                     \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), \
      c(d[i + 7])
#define WG_ACC(c) \
  WG_D8(c, 0), WG_D8(c, 8), WG_D8(c, 16), WG_D8(c, 24), WG_D8(c, 32), WG_D8(c, 40), \
      WG_D8(c, 48), WG_D8(c, 56)
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
      : WG_ACC("+f")
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) = [d +] A (64 x 16 bf16) . B (128 x 16 bf16)^T
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC("+f")
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, s32) = [d +] A (64 x 32 u8) . B (128 x 32 u8)^T; integer
// wgmma takes no scale or transpose operands (both K major).
__device__ __forceinline__ void wgmma_u8(int* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 " WG_REGS
      ", %64, %65, p;\n}\n"
      : WG_ACC("+r")
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
template <class K, bool Dual>
__device__ __forceinline__ void mma_chunk(Bits<K, Dual>, int* d, uint32_t a, uint32_t b,
                                          int first) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)  // one word a K step
    wgmma_u8(d, desc(a + ks * 256), desc(b + ks * 256), !(first && ks == 0));
}

__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// The running top-2 of one consumer thread's two query rows (r0 and r0 + 8)
// over its columns 8j + 2 quad + {0, 1} of each db tile. load() reads this
// thread's 32 columns of the tile's penalty or key row (issued before the
// products, so the loads overlap them), update() folds in the tile's
// accumulators, result() merges the quad and yields (idx, best, second).

// Fold counts of the skipping L2 top-2 (BF16Dual), summed over every call on
// this device and never reset: warp-tiles that took the full fold, and all
// warp-tiles. Read by tpusfm_nn_fold_counts.
__device__ unsigned long long fold_counts[2];

// min that returns NaN if either input is NaN (fminf would drop it).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// L2: (best, second, idx) in f32, dist = max(|q|^2 + pen - 2 q.db, 0); pen
// is +inf where masked, so those columns never win. Columns come in
// ascending order, so a strict < keeps the lowest index.
// Skip (BF16Dual only): update() first bounds each value from below with
// the same operations rounded down, add.rm and fma.rm (monotone rounding:
// bound >= second implies value >= second), and keeps their minimum. A
// value at or above its row's running second (which is >= 0) changes
// nothing under the clamp, the strict < and the column order, so a warp in
// which no lane has a row whose minimum lies below its second skips the
// fold. NaN, which the clamp makes 0, keeps the minimum NaN, and the fold
// runs. The bound's own instructions also keep the compiler from holding
// its values for the fold. full and tiles count the warp-tiles folded and
// seen.
template <bool Skip = false>
struct L2Top2 {
  float qn[2], best[2], second[2];
  int bidx[2];
  float2 p[16];
  unsigned full = 0, tiles = 0;

  __device__ __forceinline__ L2Top2(const float* qnorm, int r0, int Nq, int, int) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qn[h] = r0 + 8 * h < Nq ? qnorm[r0 + 8 * h] : 0.f;
      best[h] = BIG;
      second[h] = BIG;
      bidx[h] = -1;
    }
  }
  __device__ __forceinline__ void load(const void* pen, size_t at, int quad) {
    const float2* pt = reinterpret_cast<const float2*>(static_cast<const float*>(pen) + at) + quad;
#pragma unroll
    for (int j = 0; j < 16; ++j) p[j] = __ldg(pt + 4 * j);
  }
  // Whether a value of the tile may lie below its row's running second.
  __device__ __forceinline__ bool below(const float* d) const {
    bool any = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m[4];  // four independent chains
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = __fadd_rd(qn[h], e ? p[j].y : p[j].x);
          const float v = __fmaf_rd(-2.f, d[4 * j + 2 * h + e], s);
          const int c = (2 * j + e) & 3;
          m[c] = j < 2 ? v : min_nan(m[c], v);
        }
      }
      any |= !(min_nan(min_nan(m[0], m[1]), min_nan(m[2], m[3])) >= second[h]);
    }
    return any;
  }
  __device__ __forceinline__ void update(const float* d, int col0) {
    if constexpr (Skip) {
      ++tiles;
      if (!__any_sync(0xffffffffu, below(d))) return;
      ++full;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pp = e ? p[j].y : p[j].x;
        const int col = col0 + 8 * j + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float dist = fmaxf(fmaf(-2.f, d[4 * j + 2 * h + e], qn[h] + pp), 0.f);
          const bool lt = dist < best[h];
          second[h] = lt ? best[h] : fminf(second[h], dist);
          bidx[h] = lt ? col : bidx[h];
          best[h] = lt ? dist : best[h];
        }
      }
    }
  }
  __device__ __forceinline__ void result(int h, int& ix, float& bb, float& ss) {
    bb = best[h];
    ss = second[h];
    ix = bidx[h];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, bb, off);
      const float os = __shfl_xor_sync(0xffffffffu, ss, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
      merge_top2(bb, ss, ix, ob, os, oi);
    }
  }
};

template <class K>
__device__ __forceinline__ K kmin(K a, K b) {
  return a < b ? a : b;
}
template <class K>
__device__ __forceinline__ K kmax(K a, K b) {
  return a < b ? b : a;
}

// Hamming: the two least keys (see the header). A 32-bit key is
// base + a.b * mul with mul = -(2 << kshift); a 64-bit key is
// (base - 2 a.b) << 32 | column. Keys are distinct (their columns differ),
// so min and max alone rank them, ties included.
template <class K, int NP>
struct KeyTop2 {
  float qn[2];  // popc(q) - 32 D
  K b1[2], b2[2];
  uint2 p[NP][16];
  int kshift;
  K sent;  // the least key of a masked column
  uint32_t mul;

  __device__ __forceinline__ KeyTop2(const float* qnorm, int r0, int Nq, int kshift_, int ksent)
      : kshift(kshift_), sent((K)ksent << kshift_), mul(0u - (2u << (kshift_ & 31))) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qn[h] = r0 + 8 * h < Nq ? qnorm[r0 + 8 * h] : 0.f;
      b1[h] = ~(K)0;
      b2[h] = ~(K)0;
    }
  }
  __device__ __forceinline__ void load(const void* key, size_t at, int quad, int slot = 0) {
    const uint2* pt = reinterpret_cast<const uint2*>(static_cast<const uint32_t*>(key) + at) + quad;
#pragma unroll
    for (int j = 0; j < 16; ++j) p[slot][j] = __ldg(pt + 4 * j);
  }
  __device__ __forceinline__ void update(const int* d, int col0, int slot = 0) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t pp = e ? p[slot][j].y : p[slot][j].x;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t dot = (uint32_t)d[4 * j + 2 * h + e];
          K k;
          if constexpr (sizeof(K) == 4)
            k = pp + dot * mul;
          else
            k = ((K)(pp - 2u * dot) << 32) | (uint32_t)(col0 + 8 * j + e);
          b2[h] = kmin(b2[h], kmax(b1[h], k));
          b1[h] = kmin(b1[h], k);
        }
      }
    }
  }
  __device__ __forceinline__ void result(int h, int& ix, float& bb, float& ss) {
    K k1 = b1[h], k2 = b2[h];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const K o1 = __shfl_xor_sync(0xffffffffu, k1, off);
      const K o2 = __shfl_xor_sync(0xffffffffu, k2, off);
      k2 = kmin(kmin(k2, o2), kmax(k1, o1));
      k1 = kmin(k1, o1);
    }
    const bool v1 = k1 < sent, v2 = k2 < sent;
    ix = v1 ? (int)(k1 & (((K)1 << kshift) - 1)) : -1;
    bb = v1 ? (float)(int)(k1 >> kshift) + qn[h] : BIG;
    ss = v2 ? (float)(int)(k2 >> kshift) + qn[h] : BIG;
  }
};

template <class V>
struct TopOf {
  using type = L2Top2<>;
};
template <>
struct TopOf<BF16Dual> {
  using type = L2Top2<true>;
};
template <class K, bool Dual>
struct TopOf<Bits<K, Dual>> {
  using type = KeyTop2<K, Dual ? 2 : 1>;
};

// Work item blockIdx.x = (b * nqt + qt) * S + s: query tile qt of pair b
// against db tiles [s*ndt/S, (s+1)*ndt/S). qp/dp are the prepped operands,
// qn (B, Nq), pen (B, ndt*128) the penalty row (L2, f32) or key row
// (Hamming, u32; kshift and ksent give its layout). Outputs at
// ((b*S + s)*Nq + row): the final result when S == 1, partials for
// merge_kernel otherwise.
template <class V>
__global__ void __launch_bounds__(NTHREADS, 1)
nn_wgmma_kernel(const uint8_t* __restrict__ qp, const uint8_t* __restrict__ dp,
                const float* __restrict__ qn, const void* __restrict__ pen,
                int* __restrict__ idx_out, float* __restrict__ best_out,
                float* __restrict__ second_out, int Nq, int nqt, int ndt, int nkc, int S,
                int resident, int stages, int kshift, int ksent) {
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
    // Producer: one thread keeps the ring full. With two accumulators a
    // consumer needs more than a third of the registers: the producer
    // warpgroup gives them up (40 + 2 x 232 registers a thread, 128 threads).
    if constexpr (V::dual) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
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

  if constexpr (V::dual) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  // Consumers: warpgroup c owns query rows 64c .. 64c+63 of the tile.
  const int c = wg - 1, ct = threadIdx.x - 128 * wg;
  const int lane = ct & 31, quad = lane & 3;
  const int r0 = qt * ROWS + c * 64 + (ct >> 5) * 16 + (lane >> 2);  // and r0 + 8
  typename TopOf<V>::type top(qn + (size_t)b * Nq, r0, Nq, kshift, ksent);

  if constexpr (V::dual && V::bits) {
    if (t0 < t1) {
      // Two accumulators: the products of tile t + 1 run while the epilogue
      // of tile t does, so the tensor cores always have queued work. The
      // plan takes this path where the queries are resident and the ring
      // holds two db tiles; a tile's stages are released once its products
      // are done.
      mbar_wait(qbar, 0);
      __syncwarp();
      const uint32_t a_rows = c * 64 / 8 * 1024;
      int acc0[64], acc1[64];  // no initial values: any non-wgmma write to them
                               // makes ptxas serialise the products (C7515)
      int stage = 0, rel = 0;
      uint32_t phase = 0;
      auto issue = [&](int* d) {
#pragma unroll 1
        for (int kc = 0; kc < nkc; ++kc) {
          mbar_wait(bars + 8 * stage, phase);
          __syncwarp();
          fence_acc(d);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
          mma_chunk(V{}, d, qres + kc * PLANE_SET + a_rows, ring + stage * stage_bytes, kc == 0);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      };
      auto release = [&]() {
#pragma unroll 1
        for (int kc = 0; kc < nkc; ++kc) {
          mbar_arrive(bars + 8 * (MAX_STAGES + rel));
          if (++rel == stages) rel = 0;
        }
      };
      top.load(pen, ((size_t)b * ndt + t0) * ROWS, quad, 0);
      issue(acc0);
      for (int t = t0; t < t1; t += 2) {
        const bool next = t + 1 < t1;
        if (next) {
          top.load(pen, ((size_t)b * ndt + t + 1) * ROWS, quad, 1);
          issue(acc1);
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        } else {
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        }
        fence_acc(acc0);
        release();
        top.update(acc0, t * ROWS + 2 * quad, 0);
        if (!next) break;
        const bool again = t + 2 < t1;
        if (again) {
          top.load(pen, ((size_t)b * ndt + t + 2) * ROWS, quad, 0);
          issue(acc0);
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        } else {
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        }
        fence_acc(acc1);
        release();
        top.update(acc1, (t + 1) * ROWS + 2 * quad, 1);
      }
    }
  } else if constexpr (V::dual) {
    if (t0 < t1) {
      // bf16, two accumulators: tile t is folded after the wgmma of tile
      // t + 1 are issued, and each half ends by waiting for every wgmma, so
      // that none is in flight where the loop turns. With a group in flight
      // there, as in the Hamming path above, ptxas ends a group at each pass
      // of the chunk loop and counts those in wait_group 1, which then waits
      // for the next tile's products too; with the chunks' wgmma issued in
      // one straight run, it serialises them (C7514). Issuing a wgmma holds
      // the warp until the tensor cores take it, so the fold overlaps only
      // the products still queued when the issue ends (PERF.md). The next
      // tile's penalty row is read after each fold.
      mbar_wait(qbar, 0);
      __syncwarp();
      const uint32_t a_rows = c * 64 / 8 * 1024;
      float acc0[64], acc1[64];  // no initial values (as in the Hamming path)
      int stage = 0, rel = 0;
      uint32_t phase = 0;
      auto issue = [&](float* d) {
#pragma unroll 1
        for (int kc = 0; kc < nkc; ++kc) {
          mbar_wait(bars + 8 * stage, phase);
          __syncwarp();
          fence_acc(d);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
          mma_chunk(V{}, d, qres + kc * PLANE_SET + a_rows, ring + stage * stage_bytes, kc == 0);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      };
      auto done = [&](float* d) {  // wait for the products, release their stages
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(d);
#pragma unroll 1
        for (int kc = 0; kc < nkc; ++kc) {
          mbar_arrive(bars + 8 * (MAX_STAGES + rel));
          if (++rel == stages) rel = 0;
        }
      };
      top.load(pen, ((size_t)b * ndt + t0) * ROWS, quad);
      issue(acc0);
      done(acc0);
      for (int t = t0; t < t1; t += 2) {
        const bool next = t + 1 < t1;
        if (next) issue(acc1);
        top.update(acc0, t * ROWS + 2 * quad);
        if (!next) break;
        top.load(pen, ((size_t)b * ndt + t + 1) * ROWS, quad);
        done(acc1);
        const bool again = t + 2 < t1;
        if (again) issue(acc0);
        top.update(acc1, (t + 1) * ROWS + 2 * quad);
        if (!again) break;
        top.load(pen, ((size_t)b * ndt + t + 2) * ROWS, quad);
        done(acc0);
      }
      if (lane == 0) {  // this warp's fold counts, for tpusfm_nn_fold_counts
        atomicAdd(&fold_counts[0], (unsigned long long)top.full);
        atomicAdd(&fold_counts[1], (unsigned long long)top.tiles);
      }
    }
  } else if (t0 < t1) {
    if (resident) mbar_wait(qbar, 0);
    __syncwarp();  // reconverge before the .aligned wgmma instructions
    const uint32_t a_rows = c * 64 / 8 * 1024;  // this warpgroup's first 8-row group
    typename V::Acc d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int t = t0; t < t1; ++t) {
      // This thread's 32 columns of the penalty or key row, loaded while
      // the products run.
      top.load(pen, ((size_t)b * ndt + t) * ROWS, quad);

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

      top.update(d, t * ROWS + 2 * quad);
    }
  }

  // Merge the four lanes of a quad (they share rows), then write.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int ix;
    float bb, ss;
    top.result(h, ix, bb, ss);
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

// ------------------------------------------------------------------ host
size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

int bit_length(long long v) {
  int n = 0;
  for (; v > 0; v >>= 1) ++n;
  return n;
}

// The launch plan of one call and the workspace regions it needs. Hamming
// with 32-bit keys takes two accumulators a consumer (dual) where the
// queries are resident and the ring holds two db tiles; so does bf16 L2,
// with the skipping fold and its own choice of slices, where besides every
// block sweeps at least DUAL_SWEEP db tiles. Hamming's key layout: kshift
// index bits below the field (32: 64-bit keys), ksent the field of a
// masked column.
struct Plan {
  int nqt, ndt, nkc, S, resident, stages, dual, kshift, ksent;
  size_t smem, qp, dp, qn, pen, part, total;  // byte offsets into the workspace
};

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Splits of the db axis: the S that minimises whole waves of work items
// (one block per SM) times the db tiles an item sweeps, plus `setup` tiles'
// worth of set-up and write-out per item, plus MERGE_TILES for the merge
// pass when S > 1 (its launch and its read of the partials), so that a
// small call, whose time is launches, takes none.
constexpr int MERGE_TILES = 3;
// bf16 with two accumulators and the skipping fold: a slice's first tiles
// skip little (its running seconds start at 1e30), so each item costs about
// DUAL_SETUP tiles more. On the portrait's launches a tile took 1.46 us at
// 848-tile slices (13.4% of warp-tiles folded in full) and 1.00 us at
// 22,921 (1.2%): DUAL_SETUP fits both. The path is taken where the slices
// so chosen are at least DUAL_SWEEP tiles: on unit random rows 96% of
// warp-tiles still fold in full at 64 tiles and 67% at 256, and one
// accumulator is faster up to 256 tiles and slower from 1,024
// (scripts/torch_nn_ablate.py gate).
constexpr int DUAL_SETUP = 400;
constexpr int DUAL_SWEEP = 512;
int choose_splits(int items, int ndt, int nsm, int setup) {
  int best_s = 1;
  long long best_cost = -1;
  for (int s = 1; s <= ndt && s <= MAX_SPLITS; ++s) {
    long long waves = ((long long)items * s + nsm - 1) / nsm;
    long long cost = waves * ((ndt + s - 1) / s + setup) + (s > 1 ? MERGE_TILES : 0);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_s = s;
    }
  }
  return best_s;
}

// variant: 0 = f32 L2, 1 = bf16 L2, 2 = Hamming on uint32 words (D = words).
Plan make_plan(int B, int Nq, int Ndb, int D, int variant) {
  Plan p{};
  const int planes = variant == 0 ? F32::planes : variant == 1 ? BF16::planes : BitsOperand::planes;
  const int elem = variant == 0 ? F32::elem : variant == 1 ? BF16::elem : BitsOperand::elem;
  const size_t set = (size_t)planes * TILE_BYTES;
  p.nqt = (Nq + ROWS - 1) / ROWS;
  p.ndt = (Ndb + ROWS - 1) / ROWS;
  p.nkc = (int)(((long long)D * elem + CHUNK - 1) / CHUNK);
  if (variant == 2) {
    p.ksent = 64 * D + 1;
    p.kshift = bit_length((long long)p.ndt * ROWS - 1);
    if (bit_length(p.ksent) + p.kshift > 32) p.kshift = 32;  // 64-bit keys
  }
  const size_t qres = p.nkc * set;
  p.resident = BAR_BYTES + qres + 2 * set <= (size_t)SMEM_LIMIT;
  const size_t stage = p.resident ? set : 2 * set;
  size_t room = SMEM_LIMIT - BAR_BYTES - (p.resident ? qres : 0);
  p.stages = (int)(room / stage < MAX_STAGES ? room / stage : MAX_STAGES);
  p.smem = BAR_BYTES + (p.resident ? qres : 0) + p.stages * stage;
  const int nsm = sm_count();
  p.S = p.ndt > 0 ? choose_splits(B * p.nqt, p.ndt, nsm, 1) : 1;
  p.dual = variant == 2 && p.kshift < 32 && p.resident && p.stages >= 2 * p.nkc;
  if (variant == 1 && p.ndt > 0 && p.resident && p.stages >= 2 * p.nkc) {
    const int s = choose_splits(B * p.nqt, p.ndt, nsm, DUAL_SETUP);
    if (p.ndt / s >= DUAL_SWEEP) {
      p.S = s;
      p.dual = 1;
    }
  }
  p.qp = 0;
  p.dp = align256(p.qp + (size_t)B * p.nqt * p.nkc * set);
  p.qn = align256(p.dp + (size_t)B * p.ndt * p.nkc * set);
  p.pen = align256(p.qn + (size_t)B * Nq * 4);
  p.part = align256(p.pen + (size_t)B * p.ndt * ROWS * 4);
  p.total = p.S > 1 ? align256(p.part + (size_t)3 * B * p.S * Nq * 4) : p.part;
  return p;
}

// The prep of both operands, a warp per padded row: one launch for Hamming,
// one an operand for L2.
template <class V>
void prep(const Plan& p, const Operand& q, const Operand& d, int B, int D, cudaStream_t st) {
  const int th = 256, rows_per_block = th / 32;
  auto grid = [&](int ntiles) { return (B * ntiles * ROWS + rows_per_block - 1) / rows_per_block; };
  if constexpr (V::bits) {
    prep_bits_kernel<<<grid(q.ntiles + d.ntiles), th, 0, st>>>(q, d, B, D, p.nkc, p.kshift,
                                                                p.ksent);
  } else {
    using P = std::conditional_t<V::dual, BF16, V>;  // BF16Dual preps as BF16
    using T = typename P::T;
    prep_kernel<P><<<grid(q.ntiles), th, 0, st>>>(static_cast<const T*>(q.x), nullptr, q.out,
                                                  q.norm, nullptr, B, q.N, q.ntiles, D, p.nkc);
    if (d.ntiles > 0)
      prep_kernel<P><<<grid(d.ntiles), th, 0, st>>>(static_cast<const T*>(d.x), d.mask, d.out,
                                                    nullptr, static_cast<float*>(d.pen), B, d.N,
                                                    d.ntiles, D, p.nkc);
  }
}

template <class V>
int launch(const Plan& p, const void* q, const void* db, const float* mask, uint8_t* ws,
           int* idx, float* best, float* second, int B, int Nq, int Ndb, int D,
           cudaStream_t st) {
  float* qn = reinterpret_cast<float*>(ws + p.qn);
  prep<V>(p, Operand{q, nullptr, ws + p.qp, qn, nullptr, Nq, p.nqt},
          Operand{db, mask, ws + p.dp, nullptr, ws + p.pen, Ndb, p.ndt}, B, D, st);
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
      ws + p.qp, ws + p.dp, qn, ws + p.pen, pi, pb, ps, Nq, p.nqt, p.ndt, p.nkc, p.S,
      p.resident, p.stages, p.kshift, p.ksent);
  if (p.S > 1) {
    const int th = 256;
    merge_kernel<<<(B * Nq + th - 1) / th, th, 0, st>>>(pi, pb, ps, idx, best, second, B, Nq,
                                                       p.S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 = f32 L2, 1 = bf16 L2, 2 = Hamming on uint32 words (D = words).
// Bytes of device workspace that tpusfm_nn_search needs for these shapes on
// the current device; *splits (if not null) gets the number of db slices,
// *overlap (if not null) 1 where a bf16 call takes the two-accumulator path.
extern "C" long long tpusfm_nn_workspace(int B, int Nq, int Ndb, int D, int variant,
                                         int* splits, int* overlap) {
  const Plan p = make_plan(B, Nq, Ndb, D, variant);
  if (splits) *splits = p.S;
  if (overlap) *overlap = variant == 1 && p.dual;
  return (long long)p.total;
}

// The fold counts of the bf16 two-accumulator path on the current device,
// summed over every call since the library was loaded: out[0] warp-tiles
// that took the full top-2 fold, out[1] all warp-tiles. Waits for the device.
extern "C" int tpusfm_nn_fold_counts(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, fold_counts, sizeof(fold_counts));
}

// Bits of the key index field of a Hamming call (32: 64-bit keys), for the
// plain version and the tests; -1 for an L2 variant.
extern "C" int tpusfm_nn_key_shift(int B, int Nq, int Ndb, int D, int variant) {
  return variant == 2 ? make_plan(B, Nq, Ndb, D, variant).kshift : -1;
}

// q (B, Nq, D), db (B, Ndb, D), mask (B, Ndb) f32 nonzero = valid; ws the
// workspace of tpusfm_nn_workspace's size; outputs idx (B, Nq) i32,
// best/second (B, Nq) f32. All contiguous, on the current device; kernels
// go to `stream`. Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int tpusfm_nn_search(const void* q, const void* db, const void* mask, void* ws,
                                void* idx, void* best, void* second, int B, int Nq, int Ndb,
                                int D, int variant, void* stream) {
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  uint8_t* w = static_cast<uint8_t*>(ws);
  int* ix = static_cast<int*>(idx);
  float* bo = static_cast<float*>(best);
  float* so = static_cast<float*>(second);
  const Plan p = make_plan(B, Nq, Ndb, D, variant);
  if (variant == 0) return launch<F32>(p, q, db, m, w, ix, bo, so, B, Nq, Ndb, D, s);
  if (variant == 1)
    return p.dual ? launch<BF16Dual>(p, q, db, m, w, ix, bo, so, B, Nq, Ndb, D, s)
                  : launch<BF16>(p, q, db, m, w, ix, bo, so, B, Nq, Ndb, D, s);
  if (p.dual) return launch<Bits<uint32_t, true>>(p, q, db, m, w, ix, bo, so, B, Nq, Ndb, D, s);
  if (p.kshift < 32) return launch<Bits<uint32_t>>(p, q, db, m, w, ix, bo, so, B, Nq, Ndb, D, s);
  return launch<Bits<unsigned long long>>(p, q, db, m, w, ix, bo, so, B, Nq, Ndb, D, s);
}
