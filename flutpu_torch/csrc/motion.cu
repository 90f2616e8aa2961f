// Full-search motion estimation with luma prediction (K3, and K6a at any
// block size), the hierarchical search (K5) in one launch, and 4:2:0
// chroma motion compensation of both planes (K4), for Hopper.
//
// motion_search_mc_kernel (r <= 32) and motion_search_banded_kernel
// (above) replace
// flutpu/codec/ops/motion_pallas.py:motion_search_mc_dxmajor_pallas (the
// Pallas TPU kernel `_search_mc_dxmajor_kernel`). The TPU kernel held a
// band of rows in VMEM and evaluated each candidate as whole-band lane
// and sublane rolls, summed SADs with block-diagonal ones-matrices on the
// MXU and padded widths to 128 lanes: workarounds for a machine whose
// lanes cannot index memory. Any plane size that is a multiple of the
// block size works here; nothing is padded.
//
// What bounds it on the H100: fp32 instruction issue. An absolute
// difference added to a column sum is two fp32 instructions at least (a
// subtract, and an add that takes |.| of its operands for free), and an
// SM issues 128 lanes of them a clock: 132 x 128 x 1,980 MHz = 33.45 T
// instructions/s, so the 3.48e10 differences of a 1088x1920 frame at r =
// 64 take 2.08 ms at best (the data sheet's 67 TFLOP/s counts an FMA as
// two operations; a SAD has none). At r = 7 a frame is 8,160 macroblocks
// x 225 candidates x 256 differences, 470 M, against 8 MB of device
// memory. Everything else a search issues (shared loads, column sums,
// costs, keys, index math) adds to that floor. A search that fetches both
// operands of every difference from shared memory is bound by
// shared-memory issue, 2 loads per difference, long before the
// arithmetic; and a thread per candidate leaves most of a block idle at
// small ranges (49 of 256 threads at 8x8 and r = 3).
//
// The design up to r = 32 (kWholeRange): register tiling of the SAD.
//   - A thread block (256 threads) owns a row of neighbouring
//     macroblocks, 128 columns wide (64 at r > 8), and stages ONE
//     wrap-around reference window of (MB + 2r) rows for all of them,
//     plus their current blocks, in shared memory, 16 bytes per thread
//     and step: the window starts up to 3 columns left of x0 - r, at a
//     multiple of 4, and only words outside the plane take the modulo.
//     Staging was a seventh of the kernel's time at 16x16 and r = 7, and
//     a third at 8x8 and r = 3, when it moved 4 bytes per thread and step.
//   - A work item is (macroblock, candidate row dy, 4 adjacent dx, 8
//     adjacent columns of the current block). Per row of the block it
//     loads 8 current values and 12 window values as five 16-byte words
//     and forms 32 absolute differences from registers: 0.16 shared
//     loads per difference instead of 2. Its 32 accumulators are the
//     column sums of 4 candidates x 8 columns, each summed down the rows
//     in order. (8 dx x 4 columns loads one word less per row but needs
//     four lanes per candidate in the step below, and was measured 5%
//     slower at r = 7 and 18% at r = 16. Two candidate rows per item,
//     sharing each window row, halve the loads again and were measured
//     no faster at twice the registers at r = 7 and 16: the loads are no
//     longer what the kernel waits for.)
//   - The MB/8 items that hold one candidate's columns sit in adjacent
//     lanes (one item at MB = 8, two at MB = 16); the column sums are
//     added left to right by passing the running sum from lane to lane
//     (__shfl_up), so the order of the contract below is kept. The last
//     lane forms the costs of its 4 candidates and folds the best into a
//     per-macroblock (cost, c) key with a 64-bit atomicMin in shared
//     memory: the result does not depend on arrival order.
//   - Items are numbered over the whole row of macroblocks, so the
//     block's threads stay busy whatever r and MB are: 8x8 at r = 3 is
//     224 items of one trip instead of 49 busy threads.
//     An item finds its macroblock, row and group with two products by
//     a reciprocal (div_by()), not two integer divisions.
//   - The same window then yields the prediction, stored 16 bytes at a
//     time.
//
// Above r = 32 the whole window outgrows a block, and at 10^10
// differences a frame every instruction an item adds to its differences
// counts; the 64-bit shared atomicMin is a compare-and-swap loop that one
// lane per macroblock, not a warp's, should enter; and a band staged
// before its search, with a barrier between, leaves the SM to the other
// block. motion_search_banded_kernel (and K5's wide kernel, on the pooled
// window):
//   - A lane takes (macroblock, PAIR of candidate rows, 4 dx): the window
//     row that row ey + 1 reads at block row i is the one row ey reads at
//     row i + 1, so each block row loads one current row and one window
//     row for 64 differences. It takes all the block's columns, 8 at a
//     time, carrying the 8 candidates' running sums from pass to pass: the
//     column sums stay in the contract's order with no lane handing a sum
//     to another, and an item is 2,048 differences at MB = 16.
//   - Each column sum starts at the first row's raw difference (|d0| +
//     |d1| is the first add), the costs take one min and one first-equal
//     scan, and each lane keeps its best (cost, c) across items: a warp
//     takes a contiguous run of items and folds its lanes' keys (two
//     redux instructions, then one atomicMin per macroblock) only when a
//     lane turns to another macroblock and after the last band.
//   - The pairs (r + 1 of them: row 2r + 1 is searched and dropped) are
//     split into bands as evenly as integer division splits them, no band
//     a single row, and staged by cp.async into two windows: the next band
//     loads while the block searches this one, one barrier a band.
//   - 256 threads, at most 128 registers, two blocks an SM, each within
//     ~100 KB of shared memory (kBandBudget for the two windows; the
//     launch raises the 48 KB limit and asks for the largest carveout).
//   - The prediction is read after the search from device memory, two
//     aligned 16-byte words per 16-byte store.
//   ptxas (sm_90a, -O3): motion_search_banded_kernel<16> 125 registers,
//   <8> 123, motion_search_hier_wide_kernel 125; no spill; shared memory
//   per block 49,312 B (K3 r = 33, one band) to 100,064 B (r = 126, 12
//   bands of 10-11 pairs); K5 31,488 B (r = 33) to 90,432 B (r = 126).
//   What holds it back (PERF.md): the SAD core alone issues short of the
//   floor, and the per-item rest, the partial last wave of blocks and the
//   bands' barriers take K3 at r = 64 to ~0.72 of it.
// No tensor cores: a SAD is sums of absolute differences, not products,
// and the contract fixes the order and rounding of every fp32 add.
//
// Contract (bit-identical to the plain PyTorch version,
// ops/motion_kernels.py:motion_search_mc_plain):
//   - candidate (dy, dx) predicts pixel (i, j) from
//     prev[(i - dy) mod H, (j - dx) mod W] (torch.roll's sign);
//   - SAD summed per column down the MB rows, then the MB column sums
//     left to right, every add rounded on its own (no FMA contraction);
//   - cost = SAD * 64 + |dy| + |dx| in fp32;
//   - least cost wins, ties to the first candidate in dy-major order
//     c = (dy + r) * (2r + 1) + (dx + r): the block reduces on the pair
//     (cost, c), never on arrival order;
//   - a cost that is NaN or +inf never wins; a block with no winner keeps
//     (0, 0).
//
// The search kernels are templates on the block size MB (16 or 8). The
// MB = 16 instances are K3 (entry flu_motion_search_mc). All instances
// serve K6a (flu_motion_search_mc_blocks), which replaces
// motion_pallas.py:motion_search_mc_pallas: K3's contract at any block
// size, the prediction shifting each MB x MB block by its full vector (as
// the TPU kernel does; motion_compensate would halve it at MB != 16). K5
// runs the same device routines (stage_*, search_blocks<8>; above r = 32
// search_band<8>) on the pooled window of its own kernel.
//
// motion_search_hier_kernel is K5 (flu_motion_search_hier): it replaces
// motion_pallas.py:motion_search_mc_hier_pallas, the coarse-to-fine
// search (a full search of +-rc = max(1, r / 2) with 8x8 blocks on the
// 2x2-mean-pooled planes, the coarse vector doubled and clipped to
// +-(r - 1) as each macroblock's base, then a +-1 refine at full
// resolution), whose refine stage rolled whole bands once per absolute
// candidate that some macroblock wanted and skipped the rest with
// lax.cond. Bound on the H100 by device memory: cur and prev read once,
// the prediction written (25 MB at 1088x1920, 7.5 us); its 44 M absolute
// differences at r = 7 take about a quarter of that at the fp32 rate.
// The first port ran it as about twelve launches (the pool in torch,
// K6a's 8x8 instance, which also wrote a prediction nobody read, the
// clip in torch, and a refine kernel with one 256-thread block per
// macroblock and one thread choosing), paced by the host. Here it is one
// launch:
//   - a 128-thread block owns K3's row of nb macroblocks (8, or 4 at
//     r > 8): the coarse stage's items (112 at r = 7) and the refine's
//     columns (128) keep most of its lanes busy, where 256 threads left
//     half of them idle in both (0.0228 against 0.0223 ms per 1088x1920
//     frame, PERF.md). It stages ONE wrap-around window of prev at full
//     resolution, rows y0 - R .. y0 + 15 + R and columns likewise with
//     R = max(r, 2 rc) (the coarse stage reaches +-2 rc full-resolution
//     pixels, the refine +-r), and the current rows, 16 bytes per thread
//     and step as K3 does; a plane smaller than the window wraps more
//     than once (a true modulo);
//   - it pools the window and the current rows into K6a's coarse window
//     and blocks in shared memory, in subsample_420's order ((a + b) + c)
//     + d, then / 4: the pooled window starts at an even full-resolution
//     row and column, so the full plane's wrap mod h equals the pooled
//     plane's mod h / 2;
//   - the coarse search is K3's device routine (search_blocks<8>) on that
//     window: K6a's contract, nothing written to device memory;
//   - the base clip, then the refine: a thread per macroblock column
//     walks its 16 rows once with a sliding 3-row register window and
//     sums the column for all nine candidates (4 shared loads per 9
//     differences), sixteen lanes per macroblock add the 16 column sums
//     of one candidate left to right, and a 4-step xor shuffle picks the
//     least (cost, candidate) key;
//   - the prediction comes from the same window, 16 bytes per store.
//
// chroma_mc_kernel replaces motion_pallas.py:chroma_mc_pallas (the Pallas
// TPU kernel `_chroma_mc_kernel`), which rolled a wrap-padded band once per
// distinct halved shift and selected per pixel. It is pure selection,
// bound by device memory (8.4 MB moved for both 544x960 planes, 2.5 us),
// and bit-identical to ops/motion.py:motion_compensate(prev, mv, mb=8):
// the luma vectors are floor-halved (-7 -> -4; C's `/` truncates, so the
// halving subtracts the low bit first). A thread takes one 8-wide row of
// an 8x8 block in both planes: it loads the block's vector once, finds
// its source row and first column with one modulo each, reads the 8
// source values (the row is contiguous except where it wraps, and w is a
// multiple of 4, so whole 16-byte words wrap as units) with three aligned
// 16-byte loads and a register shift, and writes two 16-byte words per
// plane. Eight 4-byte loads per row were measured too and were slower
// (0.0059-0.0061 against 0.0052-0.0054 ms per pair of 544x960 planes,
// PERF.md), so only the words remain. Threads walk the block rows
// grid-stride, at most a few waves of the card's SMs.
//
// A chunk axis, for GOP-chunk-parallel encoding (cudahype): each entry takes
// nc planes (or plane pairs) of one shape stored one after the other, one
// per GOP chunk, and one launch serves one frame step of all of them. The
// TPU build vmaps its per-chunk codec, which gives each Pallas kernel a
// batch grid axis; here the searches take the chunk as blockIdx.z and K4
// walks the rows of all chunks' planes. Each chunk's base is its index
// times its plane's size (a multiple of 16 bytes, as the 16-byte loads
// need), and the wrap-around stays inside the chunk's own plane, so every
// chunk gets exactly what a launch with nc = 1 gives it. Nothing else of
// the kernels changes.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "device.cuh"

namespace {

constexpr int kMB = 16;  // luma macroblock (K3, K5)
constexpr int kSearchThreads = 256;  // K3, K6a
constexpr int kHierThreads = 128;    // K5: each of its stages keeps most of them busy
constexpr int kHierBlocksPerSM = 6;  // what its shared memory allows at r <= 8
constexpr int kMaxRange = 126;     // the widest range the FVC encoder takes
constexpr int kWholeRange = 32;    // up to here a block stages its whole window
constexpr int kMaxChunks = 65535;  // the grid's z extent: one chunk per z
constexpr size_t kMaxSmem = 232448;  // what one block may ask for on Hopper
// above kWholeRange (K3, K6a, K5's coarse stage): 256 threads, two blocks
// an SM, each block's two band windows within kBandBudget bytes
constexpr int kBandThreads = 256;
constexpr int kBandBlocksPerSM = 2;
constexpr size_t kBandBudget = 96 * 1024;
constexpr int kBandCols = 64;      // K3's and K6a's full-resolution columns per block
constexpr int kHierWideCols = 128; // K5's

__device__ __forceinline__ int wrap(int v, int n) {
  const int m = v % n;
  return m < 0 ? m + n : m;
}

// (cost, index) of a strictly better candidate: lower cost, or equal cost
// scanned earlier
__device__ __forceinline__ bool better(float ca, int ia, float cb, int ib) {
  return ca < cb || (ca == cb && ia < ib);
}

constexpr int kShifts = 4;  // adjacent dx per work item
constexpr int kCols = 8;    // adjacent columns of the current block per work item
constexpr unsigned long long kNoWinner = ~0ull;

static_assert(kShifts == 4 && kCols % 4 == 0, "window and block rows move as 16-byte words");
static_assert(kHierThreads >= 128, "K5 takes a thread per column of its 8 macroblocks");

// what the host sizes for a launch and the kernel lays out the same way
struct SearchShape {
  int nb;       // macroblocks per thread block
  int off;      // spare window columns on the left: r + off is a multiple of 4
  int groups;   // groups of kShifts window columns that cover off + 2r + 1
  int stride;   // window row, words
  size_t smem;  // bytes
};

// the search's layout for nb macroblocks of mb x mb at range r
__host__ __device__ inline SearchShape search_shape(int mb, int r, int nb) {
  SearchShape s;
  s.nb = nb;
  // the window starts at plane column x0 - r - off, a multiple of 4, so
  // that it is staged 16 bytes at a time; the shifts are grouped by
  // window column, so an item's 16-byte loads stay aligned too
  s.off = (kShifts - r % kShifts) % kShifts;
  s.groups = (s.off + 2 * r + 1 + kShifts - 1) / kShifts;
  // an item reads up to column nb * mb + kShifts * groups - 1 (>= the
  // nb * mb + off + 2r the prediction needs); rows must not share all banks
  s.stride = s.nb * mb + kShifts * s.groups;
  if (s.stride % 32 == 0) s.stride += 4;
  s.smem = sizeof(float) * ((size_t)(mb + 2 * r) * s.stride + (size_t)mb * s.nb * mb) +
           sizeof(unsigned long long) * s.nb + sizeof(int) * 2 * s.nb;
  return s;
}

// K3's and K6a's: a row of 128 columns of blocks (64 at r > 8)
__host__ __device__ inline SearchShape search_shape(int mb, int r) {
  return search_shape(mb, r, (r <= 8 ? 128 : 64) / mb);
}

// The layout of a banded search (above kWholeRange) of nb blocks of mb x
// mb at range r. A work item takes a PAIR of adjacent candidate rows, and
// 2r + 1 is odd, so there are r + 1 pairs: the last pair's second row (ey
// = 2r + 1) is past the range, searched and dropped (1 row in 2r + 2).
// The pairs are split into nbands bands of at most band_pairs, as evenly
// as integer division splits them (no band is a single row); a band's
// window holds mb + 2 band_pairs - 1 rows. Two windows, the band being
// searched and the next one loading, fit in kBandBudget.
struct BandShape {
  int nb;          // macroblocks per thread block
  int off;         // spare window columns on the left: r + off is a multiple of 4
  int groups;      // groups of kShifts window columns that cover off + 2r + 1
  int stride;      // window row, words
  int pairs;       // candidate-row pairs: r + 1
  int nbands;      // bands of pairs, staged in turn
  int band_pairs;  // the most pairs a band holds
  int rows;        // window rows of a band: mb + 2 band_pairs - 1
  int nbuf;        // windows: 2, or 1 where one band holds every pair
  size_t window;   // bytes of the windows
};

__host__ __device__ inline BandShape band_shape(int mb, int r, int nb) {
  BandShape s;
  s.nb = nb;
  s.off = (kShifts - r % kShifts) % kShifts;
  s.groups = (s.off + 2 * r + 1 + kShifts - 1) / kShifts;
  // an item reads up to column nb * mb + kShifts * groups - 1
  s.stride = nb * mb + kShifts * s.groups;
  if (s.stride % 32 == 0) s.stride += 4;
  s.pairs = r + 1;
  const int most = ((int)(kBandBudget / (2 * sizeof(float) * s.stride)) - mb + 1) / 2;
  s.nbands = (s.pairs + most - 1) / most;
  s.band_pairs = (s.pairs + s.nbands - 1) / s.nbands;
  s.rows = mb + 2 * s.band_pairs - 1;
  s.nbuf = s.nbands > 1 ? 2 : 1;
  s.window = sizeof(float) * (size_t)s.nbuf * s.rows * s.stride;
  return s;
}

// the first pair of band k
__host__ __device__ inline int band_start(const BandShape& s, int k) {
  return k * s.pairs / s.nbands;
}

// K3's and K6a's banded search: the windows, the current blocks, best[]
// and the vectors
__host__ __device__ inline size_t banded_smem(int mb, int r) {
  const BandShape s = band_shape(mb, r, kBandCols / mb);
  return s.window + sizeof(float) * (size_t)mb * s.nb * mb + sizeof(unsigned long long) * s.nb +
         sizeof(int) * 2 * s.nb;
}

static_assert(kHierWideCols <= kBandThreads && kHierWideCols % 32 == 0,
              "K5 above kWholeRange takes a thread per column of its macroblocks");

// floor(a / d) from inv = 1 / d rounded to nearest, for 0 <= a < 2^20 and
// d <= 2^10: (a + 0.5) / d lies at least 0.5 / d from an integer, the two
// roundings move it by less than a / d * 2^-22. Three instructions where
// the integer division takes about forty.
__device__ __forceinline__ int div_by(int a, float inv) {
  return __float2int_rz(__fmul_rn((float)a + 0.5f, inv));
}

// dst[a * stride + b] = src[(row0 + a) mod h, (col0 + b) mod w] for a <
// rows, b < stride, 16 bytes per thread and step. stride and col0 are
// multiples of 4 and w of 8, so a word that starts at a multiple of 4
// lies inside the plane after the wrap; only words outside it take the
// modulo, which is a true one (a plane smaller than the window wraps more
// than once). NT: the block's threads.
template <int NT>
__device__ __forceinline__ void stage_window(float* dst, const float* __restrict__ src, int h,
                                             int w, int row0, int col0, int rows, int stride) {
  const int s4 = stride / 4;
  const float inv_s4 = __frcp_rn((float)s4);
  for (int k = threadIdx.x; k < rows * s4; k += NT) {
    const int a = div_by(k, inv_s4), b = 4 * (k - a * s4);
    int row = row0 + a, col = col0 + b;
    if (row < 0 || row >= h) row = wrap(row, h);
    if (col < 0 || col >= w) col = wrap(col, w);
    *reinterpret_cast<float4*>(dst + a * stride + b) =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)row * w + col));
  }
}

// dst[i * stride + b] = src[row0 + i, col0 + b] for i < rows, b < cols (a
// multiple of 4), 16 bytes per thread and step
template <int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int w,
                                           int row0, int col0, int rows, int cols, int stride) {
  const int c4 = cols / 4;
  const float inv_c4 = __frcp_rn((float)c4);
  for (int k = threadIdx.x; k < rows * c4; k += NT) {
    const int i = div_by(k, inv_c4), b = 4 * (k - i * c4);
    *reinterpret_cast<float4*>(dst + i * stride + b) =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + i) * w + col0 + b));
  }
}

// the 16 bytes at src into shared dst, asynchronously (cp.async; the
// caller commits the group and waits for it)
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// stage_window's layout and wrap, as cp.async requests
template <int NT>
__device__ __forceinline__ void stage_window_async(float* dst, const float* __restrict__ src, int h,
                                                   int w, int row0, int col0, int rows,
                                                   int stride) {
  const int s4 = stride / 4;
  const float inv_s4 = __frcp_rn((float)s4);
  for (int k = threadIdx.x; k < rows * s4; k += NT) {
    const int a = div_by(k, inv_s4), b = 4 * (k - a * s4);
    int row = row0 + a, col = col0 + b;
    if (row < 0 || row >= h) row = wrap(row, h);
    if (col < 0 || col >= w) col = wrap(col, w);
    copy_async16(dst + a * stride + b, src + (size_t)row * w + col);
  }
}

// stage_rows' layout, as cp.async requests
template <int NT>
__device__ __forceinline__ void stage_rows_async(float* dst, const float* __restrict__ src, int w,
                                                 int row0, int col0, int rows, int cols,
                                                 int stride) {
  const int c4 = cols / 4;
  const float inv_c4 = __frcp_rn((float)c4);
  for (int k = threadIdx.x; k < rows * c4; k += NT) {
    const int i = div_by(k, inv_c4), b = 4 * (k - i * c4);
    copy_async16(dst + i * stride + b, src + (size_t)(row0 + i) * w + col0 + b);
  }
}

// One row of a work item: 8 current values against 12 window values (the
// last is spare), the 32 absolute differences of 4 shifts x 8 columns
// added to their column sums.
__device__ __forceinline__ void sad_row(float (&acc)[kShifts][kCols], const float* cp,
                                        const float* wp) {
  const float4 c4 = *reinterpret_cast<const float4*>(cp);
  const float4 c5 = *reinterpret_cast<const float4*>(cp + 4);
  const float4 w0 = *reinterpret_cast<const float4*>(wp);
  const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
  const float4 w2 = *reinterpret_cast<const float4*>(wp + 8);
  const float cv[kCols] = {c4.x, c4.y, c4.z, c4.w, c5.x, c5.y, c5.z, c5.w};
  const float wv[12] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x, w2.y, w2.z, w2.w};
#pragma unroll
  for (int s = 0; s < kShifts; s++)
#pragma unroll
    for (int c = 0; c < kCols; c++)
      acc[s][c] = __fadd_rn(acc[s][c], fabsf(__fsub_rn(cv[c], wv[c + s])));
}

// The search of nbv blocks of MB x MB over the candidate rows ey0 ..
// ey0 + ney - 1 (dy = r - ey) staged under one window (win: MB + ney - 1
// rows of shape.stride, its row 0 the window row of candidate row ey0;
// blk: MB rows of shape.nb * MB, the current blocks): each block's least
// (cost, c) folded into best[] (kNoWinner beforehand) with a 64-bit
// atomicMin by the block's NT threads. The key carries the candidate's
// global index c, so the result does not depend on the order of the
// atomics. The caller synchronises before it reads best[].
template <int MB, int NT>
__device__ __forceinline__ void search_blocks(const float* win, const float* blk,
                                              const SearchShape& shape, int nbv, int r, int ey0,
                                              int ney, unsigned long long* best) {
  static_assert(MB % kCols == 0 && 32 % (MB / kCols) == 0,
                "the items of one candidate's columns share a warp");
  constexpr int JG = MB / kCols;  // items per candidate group
  const int stride = shape.stride, groups = shape.groups, off = shape.off;
  const int cstride = shape.nb * MB;
  const int t = threadIdx.x;

  // item = ((macroblock * ney + el) * groups + eg) * JG + jg, where candidate
  // row ey = ey0 + el (dy = r - ey) reads window rows el + i, and dx = r - e,
  // e = 4 eg + s - off, reads window columns mb * MB + j + off + e
  const int n = 2 * r + 1;
  const int total = nbv * ney * groups * JG;
  const float inv_groups = __frcp_rn((float)groups), inv_ney = __frcp_rn((float)ney);
  for (int base = 0; base < total; base += NT) {
    const int item = base + t;
    const bool valid = item < total;
    const int jg = item % JG;
    const int q = div_by(item / JG, inv_groups), eg = item / JG - q * groups;
    const int mbk = div_by(q, inv_ney), el = q - mbk * ney, ey = ey0 + el;

    // column sums: shift s, column c; 0 + x is x, so the sums start as
    // the contract's do, at the first difference
    float acc[kShifts][kCols];
#pragma unroll
    for (int s = 0; s < kShifts; s++)
#pragma unroll
      for (int c = 0; c < kCols; c++) acc[s][c] = 0.f;
    if (valid) {
      const float* wp = win + el * stride + mbk * MB + jg * kCols + eg * kShifts;
      const float* cp = blk + mbk * MB + jg * kCols;
      // unrolled by 4, not fully: the 16-row body outgrows the instruction
      // cache nearest the schedulers and was measured 11% slower
#pragma unroll 4
      for (int i = 0; i < MB; i++) sad_row(acc, cp + i * cstride, wp + i * stride);
    }

    // the MB column sums left to right: lane jg = 0 sums its columns, each
    // next lane takes the running sum from its left neighbour
    float sad[kShifts];
#pragma unroll
    for (int s = 0; s < kShifts; s++) {
      sad[s] = acc[s][0];
#pragma unroll
      for (int c = 1; c < kCols; c++) sad[s] = __fadd_rn(sad[s], acc[s][c]);
    }
#pragma unroll
    for (int k = 1; k < JG; k++)
#pragma unroll
      for (int s = 0; s < kShifts; s++) {
        float run = __shfl_up_sync(0xffffffffu, sad[s], 1);
        if (jg == k) {
#pragma unroll
          for (int c = 0; c < kCols; c++) run = __fadd_rn(run, acc[s][c]);
          sad[s] = run;
        }
      }

    if (valid && jg == JG - 1) {
      const int dy = r - ey;
      float lo = INFINITY;
      int lo_c = INT_MAX;
#pragma unroll
      for (int s = 0; s < kShifts; s++) {
        const int e = eg * kShifts + s - off;
        if (e < 0 || e >= n) continue;  // the first and last group's spare shifts
        const int dx = r - e;
        const float cost = __fadd_rn(__fmul_rn(sad[s], 64.f), (float)(abs(dy) + abs(dx)));
        const int c = (dy + r) * n + dx + r;
        // NaN and +inf fail the first test and never win
        if (cost < INFINITY && better(cost, c, lo, lo_c)) {
          lo = cost;
          lo_c = c;
        }
      }
      // costs are >= +0, so their bit patterns order as they do
      if (lo_c != INT_MAX)
        atomicMin(best + mbk, ((unsigned long long)__float_as_uint(lo) << 32) | (unsigned)lo_c);
    }
  }
}

// the (dy, dx) of a best[] key at range r; no winner (every cost NaN or
// +inf) keeps the plain version's initial (0, 0)
__device__ __forceinline__ int2 winner(unsigned long long key, int r) {
  const int n = 2 * r + 1;
  const int c = key == kNoWinner ? r * n + r : (int)(key & 0xffffffffu);
  return make_int2(c / n - r, c - (c / n) * n - r);
}

// x[k] = p[k] for k < 4N: N 16-byte shared words
template <int N>
__device__ __forceinline__ void load_words(float (&x)[4 * N], const float* p) {
#pragma unroll
  for (int k = 0; k < N; k++) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * k);
    x[4 * k] = v.x;
    x[4 * k + 1] = v.y;
    x[4 * k + 2] = v.z;
    x[4 * k + 3] = v.w;
  }
}

// One row of one candidate row of a banded item: the 32 differences
// d = cv[c] - wv[c + s] of 4 shifts x 8 columns. STEP 0, the block's first
// row: acc = d (raw). STEP 1, its second: acc = |acc| + |d|, the column's
// first add (the plain version's column sum starts at |d0|). Then acc +=
// |d|. Each difference is two fp32 instructions: a subtract, and an add
// that takes |.| of its operands for free.
template <int STEP>
__device__ __forceinline__ void band_row(float (&acc)[kShifts][kCols], const float (&cv)[kCols],
                                         const float (&wv)[12]) {
#pragma unroll
  for (int s = 0; s < kShifts; s++)
#pragma unroll
    for (int c = 0; c < kCols; c++) {
      const float d = __fsub_rn(cv[c], wv[c + s]);
      if (STEP == 0)
        acc[s][c] = d;
      else if (STEP == 1)
        acc[s][c] = __fadd_rn(fabsf(acc[s][c]), fabsf(d));
      else
        acc[s][c] = __fadd_rn(acc[s][c], fabsf(d));
    }
}

// A banded item's column sums: candidate rows ey (acc[0]) and ey + 1
// (acc[1]), 4 shifts x 8 columns each, over the MB rows of the current
// block (cp, rows cstride apart). Row i of the block meets window row i
// in row ey and window row i + 1 in row ey + 1 (wp: window row 0, rows
// stride apart), so the window row that row ey + 1 reads at block row i
// is the one row ey reads at row i + 1: each block row loads one current
// row and ONE window row (5 16-byte loads per 64 differences, against 5
// per 32 when an item took one candidate row), the two window registers
// trading roles.
template <int MB>
__device__ __forceinline__ void sad_pair(float (&acc)[2][kShifts][kCols], const float* cp,
                                         int cstride, const float* wp, int stride) {
  float cv[kCols], w0[12], w1[12];
  load_words<2>(cv, cp);
  load_words<3>(w0, wp);
  load_words<3>(w1, wp + stride);
  band_row<0>(acc[0], cv, w0);
  band_row<0>(acc[1], cv, w1);
  load_words<2>(cv, cp + cstride);
  load_words<3>(w0, wp + 2 * stride);
  band_row<1>(acc[0], cv, w1);
  band_row<1>(acc[1], cv, w0);
  // two rows a trip; not unrolled further (a fully unrolled 16-row body
  // outgrew the instruction cache nearest the schedulers in the r <= 32
  // kernel)
#pragma unroll 1
  for (int i = 2; i < MB; i += 2) {
    cp += 2 * cstride;
    wp += 2 * stride;
    load_words<2>(cv, cp);
    load_words<3>(w1, wp + stride);
    band_row<2>(acc[0], cv, w0);
    band_row<2>(acc[1], cv, w1);
    load_words<2>(cv, cp + cstride);
    load_words<3>(w0, wp + 2 * stride);
    band_row<2>(acc[0], cv, w1);
    band_row<2>(acc[1], cv, w0);
  }
}

// The least (cost, c) of an item's candidates: rows ey and ey + 1 x the
// shifts of group eg. cost = SAD * 64 + |dy| + |dx|, the centre bias
// added as the float of the integer (exact); a candidate past the range
// (the groups' spare shifts, row 2r + 1) gets a bias of +inf. The least
// cost is a min over all (NaN and +inf never win), then the first
// candidate at it in ascending c (dy-major): one compare and one select
// each, scanned in descending c so that the last match stands.
__device__ __forceinline__ void pick(float& lo, int& lo_c, const float (&sad)[2][kShifts], int ey,
                                     int eg, int off, int r) {
  const float rf = (float)r;
  const float fdy = (float)(r - ey), fdx = (float)(r + off - kShifts * eg);
  float by[2], bx[kShifts];
#pragma unroll
  for (int q = 0; q < 2; q++) {
    const float dy = __fsub_rn(fdy, (float)q);
    by[q] = dy >= -rf ? fabsf(dy) : INFINITY;
  }
#pragma unroll
  for (int s = 0; s < kShifts; s++) {
    const float dx = __fsub_rn(fdx, (float)s);
    bx[s] = fabsf(dx) <= rf ? fabsf(dx) : INFINITY;
  }
  float cost[2][kShifts];
  lo = INFINITY;
#pragma unroll
  for (int q = 0; q < 2; q++)
#pragma unroll
    for (int s = 0; s < kShifts; s++) {
      cost[q][s] = __fadd_rn(__fmul_rn(sad[q][s], 64.f), __fadd_rn(by[q], bx[s]));
      lo = fminf(lo, cost[q][s]);
    }
  // c falls as q and s rise
  int k = 0;
#pragma unroll
  for (int q = 0; q < 2; q++)
#pragma unroll
    for (int s = 0; s < kShifts; s++)
      if (cost[q][s] == lo) k = q * kShifts + s;
  const int n = 2 * r + 1;
  lo_c = (2 * r - ey - k / kShifts) * n + 2 * r + off - kShifts * eg - k % kShifts;
}

// Each lane's (lo, lo_c) for macroblock m folded into best[m] (kNoWinner
// beforehand): the warp's lanes of one macroblock reduce first (the least
// cost bits, then the least c among the lanes that hold it: two redux
// instructions; costs are >= +0, so their bit patterns order as they do),
// and one lane of them issues the 64-bit atomicMin (a compare-and-swap
// loop in shared memory: one lane per macroblock, not 16, enters it).
// Lanes that hold no finite cost take no part; each macroblock's lanes
// are folded in turn.
__device__ __forceinline__ void fold_keys(float lo, int lo_c, int m, unsigned long long* best) {
  const unsigned full = 0xffffffffu;
  const bool has = lo < INFINITY;
  unsigned pending = __ballot_sync(full, has);
  while (pending) {
    const int leader = __ffs(pending) - 1;
    const int lm = __shfl_sync(full, m, leader);
    const bool in = has && m == lm;
    const unsigned hi = in ? __float_as_uint(lo) : ~0u;
    const unsigned mh = __reduce_min_sync(full, hi);
    const unsigned mc = __reduce_min_sync(full, in && hi == mh ? (unsigned)lo_c : ~0u);
    if ((int)(threadIdx.x & 31) == leader)
      atomicMin(best + lm, ((unsigned long long)mh << 32) | mc);
    pending &= ~__ballot_sync(full, in);
  }
}

// A lane's least (cost, c) so far and its macroblock: a warp folds its
// lanes' keys only when one of them turns to another macroblock, and
// after the last band, so that most items end without a fold
struct LaneBest {
  float lo = INFINITY;
  int c = 0;
  int m = -1;
};

__device__ __forceinline__ void flush(LaneBest& b, unsigned long long* best) {
  fold_keys(b.lo, b.c, b.m, best);
  b.lo = INFINITY;
}

// The banded search of nbv blocks of MB x MB over the candidate-row pairs
// p0 .. p0 + np - 1 (rows ey = 2p, 2p + 1; dy = r - ey) under one band
// window (win: its row 0 the window row of candidate row 2 p0, rows
// s.stride apart; blk: MB rows of s.nb * MB, the current blocks), each
// block's least (cost, c) kept in b and folded into best[]. A work item,
// one lane's, is (macroblock, pair, group of 4 dx): 2 x 4 candidates, 64
// MB differences. The lane takes the block's columns 8 at a time, and
// adds each pass's column sums to the candidates' running sums before the
// next pass (so the sums run left to right over all MB columns, as the
// contract orders them, with no lane handing a sum to another). Each warp
// takes a contiguous run of items, so its lanes seldom change macroblock.
// The keys carry the candidate's index c, so bands searched one after the
// other keep the first-wins order.
template <int MB, int NT>
__device__ __forceinline__ void search_band(const float* win, const float* blk,
                                            const BandShape& s, int nbv, int r, int p0, int np,
                                            LaneBest& b, unsigned long long* best) {
  static_assert(MB % kCols == 0 && NT % 32 == 0, "whole passes, whole warps");
  constexpr int NW = NT / 32;
  const int groups = s.groups, stride = s.stride, cstride = s.nb * MB;
  const int lane = threadIdx.x & 31;
  // item q = (macroblock * np + pair) * groups + eg; each warp takes per
  // items, whole trips of 32
  const int items = nbv * np * groups;
  const int per = (items + NW * 32 - 1) / (NW * 32) * 32;
  const int q1 = min(items, (int)(threadIdx.x >> 5) * per + per);
  const float inv_groups = __frcp_rn((float)groups), inv_np = __frcp_rn((float)np);
  for (int q0 = (threadIdx.x >> 5) * per; q0 < q1; q0 += 32) {
    // a lane past the run searches its warp's first item and keeps
    // nothing, so that every lane runs the same instructions
    const bool valid = q0 + lane < q1;
    const int q = valid ? q0 + lane : q0;
    const int qq = div_by(q, inv_groups), eg = q - qq * groups;
    const int mbk = div_by(qq, inv_np), pl = qq - mbk * np;
    if (__any_sync(0xffffffffu, valid && mbk != b.m)) flush(b, best);
    if (valid) b.m = mbk;

    // the first pass's first column starts the sums (0 + x is x)
    float sad[2][kShifts];
    const float* cp = blk + mbk * MB;
    const float* wp = win + 2 * pl * stride + mbk * MB + eg * kShifts;
#pragma unroll 1
    for (int j = 0; j < MB; j += kCols) {
      float acc[2][kShifts][kCols];
      sad_pair<MB>(acc, cp + j, cstride, wp + j, stride);
#pragma unroll
      for (int k = 0; k < 2; k++)
#pragma unroll
        for (int sh = 0; sh < kShifts; sh++) {
          sad[k][sh] = j == 0 ? acc[k][sh][0] : __fadd_rn(sad[k][sh], acc[k][sh][0]);
#pragma unroll
          for (int c = 1; c < kCols; c++) sad[k][sh] = __fadd_rn(sad[k][sh], acc[k][sh][c]);
        }
    }
    if (valid) {
      float lo;
      int c;
      pick(lo, c, sad, 2 * (p0 + pl), eg, s.off, r);
      if (lo < b.lo || (lo == b.lo && c < b.c)) {
        b.lo = lo;
        b.c = c;
      }
    }
  }
}

// src[(col + q) mod w], q < 4, for 0 <= col < w (a multiple of 4): two
// aligned 16-byte words (the second wraps whole) and a register shift
__device__ __forceinline__ float4 read_quad(const float* __restrict__ src, int col, int w) {
  const int a = col & ~3, sh = col & 3;
  const float4 x = __ldg(reinterpret_cast<const float4*>(src + a));
  if (sh == 0) return x;
  const float4 y = __ldg(reinterpret_cast<const float4*>(src + (a + 4 == w ? 0 : a + 4)));
  if (sh == 1) return make_float4(x.y, x.z, x.w, y.x);
  if (sh == 2) return make_float4(x.z, x.w, y.x, y.y);
  return make_float4(x.w, y.x, y.y, y.z);
}

// r <= kWholeRange: one window of MB + 2r rows, and the prediction from it
template <int MB>
__global__ void __launch_bounds__(kSearchThreads, 4)
motion_search_mc_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                        int32_t* __restrict__ mv, float* __restrict__ pred, int h, int w,
                        int r) {
  extern __shared__ __align__(16) float smem[];
  // chunk blockIdx.z: its planes, vectors and prediction follow the
  // chunks before it; the wrap stays inside its own plane
  const size_t plane = (size_t)blockIdx.z * h * w;
  cur += plane;
  prev += plane;
  pred += plane;
  mv += (size_t)blockIdx.z * (h / MB) * (w / MB) * 2;
  const SearchShape shape = search_shape(MB, r);
  const int stride = shape.stride, off = shape.off;
  const int cstride = shape.nb * MB;
  const int n = 2 * r + 1;
  const int span = MB + 2 * r;
  float* win = smem;                  // span x stride
  float* blk = win + span * stride;   // MB x cstride: the current blocks
  unsigned long long* best = reinterpret_cast<unsigned long long*>(blk + MB * cstride);
  int* vec = reinterpret_cast<int*>(best + shape.nb);  // (dy, dx) per macroblock

  const int t = threadIdx.x;
  const int y0 = blockIdx.y * MB;
  const int mb0 = blockIdx.x * shape.nb;
  const int x0 = mb0 * MB;
  const int nbv = min(shape.nb, w / MB - mb0);  // macroblocks of this block

  // window element (a, b) = prev[(y0 - r + a) mod h, (x0 - r - off + b) mod w]
  stage_window<kSearchThreads>(win, prev, h, w, y0 - r, x0 - r - off, span, stride);
  stage_rows<kSearchThreads>(blk, cur, w, y0, x0, MB, nbv * MB, cstride);
  if (t < shape.nb) best[t] = kNoWinner;
  __syncthreads();
  search_blocks<MB, kSearchThreads>(win, blk, shape, nbv, r, 0, n, best);
  __syncthreads();

  if (t < nbv) {
    const int2 v = winner(best[t], r);
    vec[2 * t] = v.x;
    vec[2 * t + 1] = v.y;
    int32_t* out = mv + ((size_t)blockIdx.y * (w / MB) + mb0 + t) * 2;
    out[0] = v.x;
    out[1] = v.y;
  }
  __syncthreads();
  const int c4 = nbv * MB / 4;
  const float inv_c4 = __frcp_rn((float)c4);
  for (int k = t; k < MB * c4; k += kSearchThreads) {
    const int i = div_by(k, inv_c4), b = 4 * (k - i * c4);
    const int m = b / MB;
    const float* src = win + (i + r - vec[2 * m]) * stride + b + r + off - vec[2 * m + 1];
    *reinterpret_cast<float4*>(pred + (size_t)(y0 + i) * w + x0 + b) =
        make_float4(src[0], src[1], src[2], src[3]);
  }
}

// r > kWholeRange: bands of candidate-row pairs (band_shape) staged in
// turn with cp.async into two windows, the next band loading while the
// block searches this one; best[] carried across the bands; the
// prediction read from device memory after the search (the winner's rows
// are in no band that is still staged), two aligned words per 16-byte
// store.
template <int MB>
__global__ void __launch_bounds__(kBandThreads, kBandBlocksPerSM)
motion_search_banded_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                            int32_t* __restrict__ mv, float* __restrict__ pred, int h, int w,
                            int r) {
  extern __shared__ __align__(16) float smem[];
  // chunk blockIdx.z, as in motion_search_mc_kernel
  const size_t plane = (size_t)blockIdx.z * h * w;
  cur += plane;
  prev += plane;
  pred += plane;
  mv += (size_t)blockIdx.z * (h / MB) * (w / MB) * 2;
  constexpr int NT = kBandThreads;
  const BandShape s = band_shape(MB, r, kBandCols / MB);
  const int cstride = s.nb * MB;
  const int span = s.rows * s.stride;
  float* win = smem;                   // s.nbuf x span: band k in window k mod 2
  float* blk = win + s.nbuf * span;    // MB x cstride: the current blocks
  unsigned long long* best = reinterpret_cast<unsigned long long*>(blk + MB * cstride);
  int* vec = reinterpret_cast<int*>(best + s.nb);  // (dy, dx) per macroblock

  const int t = threadIdx.x;
  const int y0 = blockIdx.y * MB;
  const int mb0 = blockIdx.x * s.nb;
  const int x0 = mb0 * MB;
  const int nbv = min(s.nb, w / MB - mb0);  // macroblocks of this block

  // band k's window element (a, b) = prev[(y0 - r + 2 p0 + a) mod h,
  // (x0 - r - off + b) mod w], p0 = band_start(s, k)
  stage_rows_async<NT>(blk, cur, w, y0, x0, MB, nbv * MB, cstride);
  stage_window_async<NT>(win, prev, h, w, y0 - r, x0 - r - s.off, MB + 2 * band_start(s, 1) - 1,
                         s.stride);
  copy_commit();
  if (t < s.nb) best[t] = kNoWinner;
  LaneBest lb;
  for (int k = 0; k < s.nbands; k++) {
    const int p0 = band_start(s, k), p1 = band_start(s, k + 1);
    copy_wait_all();
    __syncthreads();  // band k landed for every thread; band k - 1's items are done
    if (k + 1 < s.nbands) {
      const int p2 = band_start(s, k + 2);
      stage_window_async<NT>(win + ((k + 1) & 1) * span, prev, h, w, y0 - r + 2 * p1,
                             x0 - r - s.off, MB + 2 * (p2 - p1) - 1, s.stride);
      copy_commit();
    }
    search_band<MB, NT>(win + (k & 1) * span, blk, s, nbv, r, p0, p1 - p0, lb, best);
  }
  flush(lb, best);
  __syncthreads();

  if (t < nbv) {
    const int2 v = winner(best[t], r);
    vec[2 * t] = v.x;
    vec[2 * t + 1] = v.y;
    *reinterpret_cast<int2*>(mv + ((size_t)blockIdx.y * (w / MB) + mb0 + t) * 2) = v;
  }
  __syncthreads();
  const int c4 = nbv * MB / 4;
  const float inv_c4 = __frcp_rn((float)c4);
  for (int k = t; k < MB * c4; k += NT) {
    const int i = div_by(k, inv_c4), b = 4 * (k - i * c4);
    const int m = b / MB;
    int row = y0 + i - vec[2 * m], col = x0 + b - vec[2 * m + 1];
    if (row < 0 || row >= h) row = wrap(row, h);
    if (col < 0 || col >= w) col = wrap(col, w);
    *reinterpret_cast<float4*>(pred + (size_t)(y0 + i) * w + x0 + b) =
        read_quad(prev + (size_t)row * w, col, w);
  }
}

constexpr int kColStride = kMB + 1;  // K5's refine column sums of one candidate

// what the host sizes for a launch of K5 and the kernel lays out the same way
struct HierShape {
  int nb;              // macroblocks per thread block (K3's count at r)
  int rc;              // the coarse range, max(1, r / 2)
  int rim;             // the window's rim R = max(r, 2 rc), full-resolution pixels
  int off;             // spare window columns on the left: rim + off is a multiple of 4
  int stride;          // full-resolution window row, words
  SearchShape coarse;  // the pooled window and blocks: K6a's layout at 8x8, rc and nb
  size_t smem;         // bytes
};

__host__ __device__ inline HierShape hier_shape(int r) {
  HierShape s;
  s.nb = search_shape(kMB, r).nb;
  s.rc = r / 2 > 1 ? r / 2 : 1;
  s.rim = r > 2 * s.rc ? r : 2 * s.rc;
  s.off = (4 - s.rim % 4) % 4;
  // the prediction reads up to column nb * 16 - 1 + off + 2 rim
  s.stride = (s.off + s.nb * kMB + 2 * s.rim + 3) / 4 * 4;
  if (s.stride % 32 == 0) s.stride += 4;
  s.coarse = search_shape(8, s.rc, s.nb);
  const size_t floats = (size_t)(kMB + 2 * s.rim) * s.stride + (size_t)kMB * s.nb * kMB +
                        (size_t)(8 + 2 * s.rc) * s.coarse.stride + (size_t)8 * s.nb * 8 +
                        (size_t)s.nb * 9 * kColStride;
  s.smem = sizeof(float) * floats + sizeof(unsigned long long) * s.nb + sizeof(int) * 2 * s.nb;
  return s;
}

// the 2x2 mean of p[0], p[1], p[s], p[s + 1] as subsample_420 takes it:
// ((a + b) + c) + d, then / 4 (a product with 0.25 rounds the same)
__device__ __forceinline__ float pool4(const float* p, int s) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), p[s]), p[s + 1]), 0.25f);
}

// x[q] = p[1 - q]: the window values that candidates ox = q - 1 read
__device__ __forceinline__ void load3(float (&x)[3], const float* p) {
  x[0] = p[1];
  x[1] = p[0];
  x[2] = p[-1];
}

// K5's refine, thread (m, j): column j of macroblock m (cp: its first
// current value, rows bstride apart) summed down its 16 rows for the nine
// candidates base + (oy, ox), c = 3 (oy + 1) + ox + 1, into cols[(m * 9 +
// c) * kColStride + j]. wp: the window value that candidate (0, 0) reads
// at row 0; candidate (oy, ox) reads row i - oy and column - ox from it,
// so each row of the walk loads one new window row of three values (a
// sliding 3-row register window, 4 shared loads per 9 differences).
__device__ __forceinline__ void refine_column(float* cols, const float* cp, int bstride,
                                              const float* wp, int stride, int m, int j) {
  float acc[9];
#pragma unroll
  for (int c = 0; c < 9; c++) acc[c] = 0.f;
  float up[3], mid[3], down[3];
  load3(up, wp - stride);
  load3(mid, wp);
#pragma unroll
  for (int i = 0; i < kMB; i++) {
    const float cv = cp[i * bstride];
    load3(down, wp + (i + 1) * stride);
#pragma unroll
    for (int q = 0; q < 3; q++) {
      acc[q] = __fadd_rn(acc[q], fabsf(__fsub_rn(cv, down[q])));        // oy = -1
      acc[3 + q] = __fadd_rn(acc[3 + q], fabsf(__fsub_rn(cv, mid[q])));  // oy = 0
      acc[6 + q] = __fadd_rn(acc[6 + q], fabsf(__fsub_rn(cv, up[q])));   // oy = 1
      up[q] = mid[q];
      mid[q] = down[q];
    }
  }
#pragma unroll
  for (int c = 0; c < 9; c++) cols[(m * 9 + c) * kColStride + j] = acc[c];
}

// K5's pick: lanes (m, c), 16 to a macroblock: candidate c < 9 adds its 16
// column sums left to right; the least (cost, c) key of the 16 lanes wins
// (the first in row-major order among equal costs, as a strict < scan
// keeps it; NaN and +inf never win). vec[2m], vec[2m + 1]: the base in,
// the vector out, also stored to mvrow[2m], mvrow[2m + 1]. nb * 16
// threads are whole warps.
__device__ __forceinline__ void pick_refined(const float* cols, int* vec, int32_t* mvrow, int nb,
                                             int nbv) {
  const int t = threadIdx.x;
  if (t < nb * kMB) {
    const int m = t >> 4, c = t & 15;
    unsigned long long key = kNoWinner;
    if (m < nbv && c < 9) {
      const float* cp = cols + (m * 9 + c) * kColStride;
      float sad = cp[0];
#pragma unroll
      for (int j = 1; j < kMB; j++) sad = __fadd_rn(sad, cp[j]);
      // SADs are >= +0, so their bit patterns order as they do
      if (sad < INFINITY) key = ((unsigned long long)__float_as_uint(sad) << 32) | (unsigned)c;
    }
#pragma unroll
    for (int s = 8; s; s >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, s);
      key = other < key ? other : key;
    }
    if (c == 0 && m < nbv) {
      int vy = 0, vx = 0;  // every cost NaN: the plain version keeps (0, 0)
      if (key != kNoWinner) {
        const int b = (int)(key & 0xffffffffu);
        vy = vec[2 * m] + b / 3 - 1;
        vx = vec[2 * m + 1] + b % 3 - 1;
      }
      vec[2 * m] = vy;
      vec[2 * m + 1] = vx;
      *reinterpret_cast<int2*>(mvrow + 2 * m) = make_int2(vy, vx);
    }
  }
}

__global__ void __launch_bounds__(kHierThreads, kHierBlocksPerSM)
motion_search_hier_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                          int32_t* __restrict__ mv, float* __restrict__ pred, int h, int w,
                          int r) {
  extern __shared__ __align__(16) float smem[];
  // chunk blockIdx.z, as in motion_search_mc_kernel
  const size_t plane = (size_t)blockIdx.z * h * w;
  cur += plane;
  prev += plane;
  pred += plane;
  mv += (size_t)blockIdx.z * (h / kMB) * (w / kMB) * 2;
  const HierShape shape = hier_shape(r);
  const SearchShape& cs = shape.coarse;
  const int nb = shape.nb, rc = shape.rc, rim = shape.rim, off = shape.off;
  const int stride = shape.stride, bstride = nb * kMB;
  const int span = kMB + 2 * rim, cspan = 8 + 2 * rc, cbstride = nb * 8;
  float* win = smem;                    // span x stride: prev at full resolution
  float* blk = win + span * stride;     // 16 x bstride: the current rows
  float* cwin = blk + kMB * bstride;    // cspan x cs.stride: the pooled window
  float* cblk = cwin + cspan * cs.stride;  // 8 x cbstride: the pooled current rows
  unsigned long long* best = reinterpret_cast<unsigned long long*>(cblk + 8 * cbstride);
  float* cols = reinterpret_cast<float*>(best + nb);  // nb x 9 x kColStride
  int* vec = reinterpret_cast<int*>(cols + nb * 9 * kColStride);  // (dy, dx) per macroblock

  const int t = threadIdx.x;
  const int y0 = blockIdx.y * kMB;
  const int mb0 = blockIdx.x * nb;
  const int x0 = mb0 * kMB;
  const int nbv = min(nb, w / kMB - mb0);  // macroblocks of this block

  // window element (a, b) = prev[(y0 - rim + a) mod h, (x0 - rim - off + b) mod w]
  stage_window<kHierThreads>(win, prev, h, w, y0 - rim, x0 - rim - off, span, stride);
  stage_rows<kHierThreads>(blk, cur, w, y0, x0, kMB, nbv * kMB, bstride);
  if (t < nb) best[t] = kNoWinner;
  __syncthreads();

  // pooled window element (a, b) = pooled prev[(y0/2 - rc + a) mod h/2,
  // (x0/2 - rc - cs.off + b) mod w/2]: for b = cs.off + k the mean of
  // window rows 2a + rim - 2rc (+1) and columns 2k + rim + off - 2rc (+1).
  // The columns no kept shift reads (the groups' spare ones) are 0.
  const int used = cs.off + nbv * 8 + 2 * rc;
  const float inv_cstride = __frcp_rn((float)cs.stride);
  for (int k = t; k < cspan * cs.stride; k += kHierThreads) {
    const int a = div_by(k, inv_cstride), b = k - a * cs.stride;
    cwin[k] = b >= cs.off && b < used
                  ? pool4(win + (2 * a + rim - 2 * rc) * stride + 2 * (b - cs.off) + rim + off -
                              2 * rc,
                          stride)
                  : 0.f;
  }
  const int cw = nbv * 8;
  const float inv_cw = __frcp_rn((float)cw);
  for (int k = t; k < 8 * cw; k += kHierThreads) {
    const int i = div_by(k, inv_cw), j = k - i * cw;
    cblk[i * cbstride + j] = pool4(blk + 2 * i * bstride + 2 * j, bstride);
  }
  __syncthreads();

  // the coarse search, K6a's contract at 8x8 and rc
  search_blocks<8, kHierThreads>(cwin, cblk, cs, nbv, rc, 0, 2 * rc + 1, best);
  __syncthreads();

  // the base: the coarse vector doubled, clipped to +-(r - 1)
  if (t < nbv) {
    const int2 c = winner(best[t], rc);
    vec[2 * t] = max(-(r - 1), min(r - 1, 2 * c.x));
    vec[2 * t + 1] = max(-(r - 1), min(r - 1, 2 * c.y));
  }
  __syncthreads();

  // the refine: thread (m, j) sums column j of macroblock m for the nine
  // candidates around its base
  if (t < nbv * kMB) {
    const int m = t >> 4, j = t & 15;
    refine_column(cols, blk + m * kMB + j, bstride,
                  win + (rim - vec[2 * m]) * stride + m * kMB + j + rim + off - vec[2 * m + 1],
                  stride, m, j);
  }
  __syncthreads();
  pick_refined(cols, vec, mv + ((size_t)blockIdx.y * (w / kMB) + mb0) * 2, nb, nbv);
  __syncthreads();

  // the prediction from the window, 16 bytes per store
  const int c4 = nbv * kMB / 4;
  const float inv_c4 = __frcp_rn((float)c4);
  for (int k = t; k < kMB * c4; k += kHierThreads) {
    const int i = div_by(k, inv_c4), b = 4 * (k - i * c4);
    const int m = b / kMB;
    const float* src = win + (i + rim - vec[2 * m]) * stride + b + rim + off - vec[2 * m + 1];
    *reinterpret_cast<float4*>(pred + (size_t)(y0 + i) * w + x0 + b) =
        make_float4(src[0], src[1], src[2], src[3]);
  }
}

constexpr int kLocRows = kMB + 2;  // K5 above kWholeRange: a macroblock's refine window
constexpr int kLocWords = 6;        // its row: the 16-byte words that hold 18 values from any column
constexpr int kLocStride = 4 * kLocWords + 4;

// what the host sizes for a launch of K5 above kWholeRange and the kernel
// lays out the same way
struct HierWideShape {
  int nb;            // macroblocks per thread block
  int rc;            // the coarse range, max(1, r / 2)
  BandShape coarse;  // the pooled windows: 8x8 blocks at rc, nb of them
  int region;        // floats of the windows, later the refine windows and column sums
  size_t smem;       // bytes
};

__host__ __device__ inline HierWideShape hier_wide_shape(int r) {
  HierWideShape s;
  s.nb = kHierWideCols / kMB;
  s.rc = r / 2 > 1 ? r / 2 : 1;
  s.coarse = band_shape(8, s.rc, s.nb);
  const int refine = s.nb * kLocRows * kLocStride + s.nb * 9 * kColStride;
  const int window = (int)(s.coarse.window / sizeof(float));
  s.region = ((window > refine ? window : refine) + 3) / 4 * 4;
  s.smem = sizeof(float) * ((size_t)s.region + (size_t)kMB * s.nb * kMB + (size_t)8 * s.nb * 8) +
           sizeof(unsigned long long) * s.nb + sizeof(int) * 5 * s.nb;
  return s;
}

// the 2x2 mean of (a, b) over (c, d) in subsample_420's order, as pool4
__device__ __forceinline__ float mean4(float a, float b, float c, float d) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d), 0.25f);
}

// dst[a * stride + b] = the pooled plane's (row0 + a) mod hh, (col0 + b)
// mod hw for a < rows, b < stride, pooled from the full-resolution plane
// src (w wide): a thread takes two adjacent pooled values from one 16-byte
// word of each of two rows. col0 is even and hw a multiple of 8, so the
// pair never straddles the wrap and its word is aligned. The loop is
// unrolled by 8, so a thread has 16 loads in flight (K5 was faster so
// than unrolled by 4, and slower unrolled by 16).
template <int NT>
__device__ __forceinline__ void pool_window(float* dst, const float* __restrict__ src, int w,
                                            int hh, int hw, int row0, int col0, int rows,
                                            int stride) {
  const int s2 = stride / 2;
  const float inv_s2 = __frcp_rn((float)s2);
#pragma unroll 8
  for (int k = threadIdx.x; k < rows * s2; k += NT) {
    const int a = div_by(k, inv_s2), b = 2 * (k - a * s2);
    int pa = row0 + a, pb = col0 + b;
    if (pa < 0 || pa >= hh) pa = wrap(pa, hh);
    if (pb < 0 || pb >= hw) pb = wrap(pb, hw);
    const float* p = src + (size_t)(2 * pa) * w + 2 * pb;
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + w));
    *reinterpret_cast<float2*>(dst + a * stride + b) =
        make_float2(mean4(u.x, u.y, v.x, v.y), mean4(u.z, u.w, v.z, v.w));
  }
}

// K5 above kWholeRange (r = 33 .. 126). The full-resolution window of
// motion_search_hier_kernel (rim r: (16 + 2r)^2 floats, 281 KB at r = 126)
// outgrows a block's 227 KB, and neither stage needs it: the coarse search
// reads the pooled plane, and the refine a +-1 neighbourhood of each
// macroblock's base. A 256-thread block owns a row of 8 macroblocks (128
// columns; 64 pooled, so the pooled window's 2 rc + 4 columns of rim are
// paid over twice the columns they were with 4). It pools its window
// straight from device memory (a 16-byte word of each of two rows gives
// two pooled values), in bands of candidate-row pairs where two windows
// would pass kBandBudget (rc >= 39), the next band pooled before this
// one's search; runs the banded search (search_band<8>) on it; then
// stages one 18-row window per macroblock around its base as whole
// aligned words, from which the refine, the pick and the prediction run.
// One launch per call, as below kWholeRange.
__global__ void __launch_bounds__(kBandThreads, kBandBlocksPerSM)
motion_search_hier_wide_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                               int32_t* __restrict__ mv, float* __restrict__ pred, int h, int w,
                               int r) {
  extern __shared__ __align__(16) float smem[];
  // chunk blockIdx.z, as in motion_search_mc_kernel
  const size_t plane = (size_t)blockIdx.z * h * w;
  cur += plane;
  prev += plane;
  pred += plane;
  mv += (size_t)blockIdx.z * (h / kMB) * (w / kMB) * 2;
  constexpr int NT = kBandThreads;
  const HierWideShape shape = hier_wide_shape(r);
  const BandShape& cs = shape.coarse;
  const int nb = shape.nb, rc = shape.rc;
  const int bstride = nb * kMB, cbstride = nb * 8;
  const int span = cs.rows * cs.stride;
  float* cwin = smem;                      // cs.nbuf x span: the pooled windows
  float* loc = smem;                       // after the coarse search: nb x kLocRows x kLocStride
  float* cols = loc + nb * kLocRows * kLocStride;  // and nb x 9 x kColStride
  float* blk = smem + shape.region;        // 16 x bstride: the current rows
  float* cblk = blk + kMB * bstride;       // 8 x cbstride: the pooled current rows
  unsigned long long* best = reinterpret_cast<unsigned long long*>(cblk + 8 * cbstride);
  int* vec = reinterpret_cast<int*>(best + nb);  // (dy, dx) per macroblock
  int* base = vec + 2 * nb;                      // the refine's base per macroblock
  int* shift = base + 2 * nb;                    // its window's first column mod 4

  const int t = threadIdx.x;
  const int y0 = blockIdx.y * kMB;
  const int mb0 = blockIdx.x * nb;
  const int x0 = mb0 * kMB;
  const int nbv = min(nb, w / kMB - mb0);  // macroblocks of this block
  const int hh = h / 2, hw = w / 2;

  // band k's pooled window element (a, b) = pooled prev[(y0/2 - rc + 2 p0
  // + a) mod h/2, (x0/2 - rc - cs.off + b) mod w/2], p0 = band_start(cs, k)
  stage_rows_async<NT>(blk, cur, w, y0, x0, kMB, nbv * kMB, bstride);
  copy_commit();
  if (t < nb) best[t] = kNoWinner;
  pool_window<NT>(cwin, prev, w, hh, hw, y0 / 2 - rc, x0 / 2 - rc - cs.off,
                  8 + 2 * band_start(cs, 1) - 1, cs.stride);
  copy_wait_all();
  __syncthreads();
  const int cw = nbv * 8;
  const float inv_cw = __frcp_rn((float)cw);
  for (int k = t; k < 8 * cw; k += NT) {
    const int i = div_by(k, inv_cw), j = k - i * cw;
    cblk[i * cbstride + j] = pool4(blk + 2 * i * bstride + 2 * j, bstride);
  }

  // the coarse search, K6a's contract at 8x8 and rc
  LaneBest lb;
  for (int k = 0; k < cs.nbands; k++) {
    const int p0 = band_start(cs, k), p1 = band_start(cs, k + 1);
    __syncthreads();  // band k (and cblk) pooled; band k - 1's items are done
    if (k + 1 < cs.nbands) {
      const int p2 = band_start(cs, k + 2);
      pool_window<NT>(cwin + ((k + 1) & 1) * span, prev, w, hh, hw, y0 / 2 - rc + 2 * p1,
                      x0 / 2 - rc - cs.off, 8 + 2 * (p2 - p1) - 1, cs.stride);
    }
    search_band<8, NT>(cwin + (k & 1) * span, cblk, cs, nbv, rc, p0, p1 - p0, lb, best);
  }
  flush(lb, best);
  __syncthreads();

  // the base: the coarse vector doubled, clipped to +-(r - 1); its refine
  // window starts at column x0 + 16 m - bx - 1, staged from the aligned
  // word at or left of it
  if (t < nbv) {
    const int2 c = winner(best[t], rc);
    const int by = max(-(r - 1), min(r - 1, 2 * c.x));
    const int bx = max(-(r - 1), min(r - 1, 2 * c.y));
    vec[2 * t] = base[2 * t] = by;
    vec[2 * t + 1] = base[2 * t + 1] = bx;
    shift[t] = wrap(x0 + t * kMB - bx - 1, w) & 3;
  }
  __syncthreads();

  // macroblock m's refine window: loc element (a, 4q + e) = prev[(y0 - by
  // - 1 + a) mod h, (c0 - c0 mod 4 + 4q + e) mod w], c0 = x0 + 16 m - bx - 1
  constexpr int kLoc = kLocRows * kLocWords;
  const float inv_loc = __frcp_rn((float)kLoc), inv_words = __frcp_rn((float)kLocWords);
  for (int k = t; k < nbv * kLoc; k += NT) {
    const int m = div_by(k, inv_loc), e = k - m * kLoc;
    const int a = div_by(e, inv_words), q = e - a * kLocWords;
    int row = y0 - base[2 * m] - 1 + a;
    if (row < 0 || row >= h) row = wrap(row, h);
    int col = (wrap(x0 + m * kMB - base[2 * m + 1] - 1, w) & ~3) + 4 * q;
    if (col >= w) col = wrap(col, w);
    *reinterpret_cast<float4*>(loc + (m * kLocRows + a) * kLocStride + 4 * q) =
        __ldg(reinterpret_cast<const float4*>(prev + (size_t)row * w + col));
  }
  __syncthreads();

  // the refine and the pick, as motion_search_hier_kernel's
  if (t < nbv * kMB) {
    const int m = t >> 4, j = t & 15;
    refine_column(cols, blk + m * kMB + j, bstride,
                  loc + (m * kLocRows + 1) * kLocStride + shift[m] + 1 + j, kLocStride, m, j);
  }
  __syncthreads();
  pick_refined(cols, vec, mv + ((size_t)blockIdx.y * (w / kMB) + mb0) * 2, nb, nbv);
  __syncthreads();

  // the prediction from each macroblock's refine window, 16 bytes per
  // store: vector base + (oy, ox) reads its row i + 1 - oy, column
  // shift + j + 1 - ox
  const int c4 = nbv * kMB / 4;
  const float inv_c4 = __frcp_rn((float)c4);
  for (int k = t; k < kMB * c4; k += NT) {
    const int i = div_by(k, inv_c4), b = 4 * (k - i * c4);
    const int m = b >> 4;
    const int oy = vec[2 * m] - base[2 * m], ox = vec[2 * m + 1] - base[2 * m + 1];
    const float* src =
        loc + (m * kLocRows + i + 1 - oy) * kLocStride + shift[m] + (b & 15) + 1 - ox;
    *reinterpret_cast<float4*>(pred + (size_t)(y0 + i) * w + x0 + b) =
        make_float4(src[0], src[1], src[2], src[3]);
  }
}

// floor(v / 2) for any sign
__device__ __forceinline__ int floor_half(int v) { return (v - (v & 1)) / 2; }

constexpr int kChromaThreads = 256;
constexpr int kChromaWaves = 4;  // resident blocks per SM the grid asks for

// o[k] = row[(sx + k) mod wc], k < 8, sx in 0..wc-1; w a multiple of 8.
// Three aligned 16-byte words cover the 8 values (a word past the end
// wraps whole, as wc is a multiple of 4) and a register shift by sx mod 4
// picks them.
__device__ __forceinline__ void read_row(float (&o)[8], const float* __restrict__ row, int sx,
                                         int wc) {
  const int a = sx & ~3, s = sx & 3;
  float v[12];
#pragma unroll
  for (int q = 0; q < 3; q++) {
    int col = a + 4 * q;
    if (col >= wc) col -= wc;
    const float4 x = __ldg(reinterpret_cast<const float4*>(row + col));
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
#pragma unroll
  for (int k = 0; k < 8; k++)
    o[k] = s == 0 ? v[k] : s == 1 ? v[k + 1] : s == 2 ? v[k + 2] : v[k + 3];
}

__device__ __forceinline__ void write_row(float* dst, const float (&o)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

__global__ void __launch_bounds__(kChromaThreads)
chroma_mc_kernel(const float* __restrict__ cb, const float* __restrict__ cr,
                 const int32_t* __restrict__ mv, float* __restrict__ pcb,
                 float* __restrict__ pcr, int nc, int hc, int wc) {
  const int bw = wc >> 3;
  // 8-wide rows of blocks, row-major, of nc chunks' planes one after the
  // other: rows of chunk k are k * hc .. k * hc + hc - 1, and a row's
  // source wraps inside its own chunk's plane
  const int rows = nc * hc * bw;
  for (int g = blockIdx.x * kChromaThreads + threadIdx.x; g < rows;
       g += gridDim.x * kChromaThreads) {
    const int yk = g / bw, bx = g - yk * bw;  // row of all chunks' planes
    const int k = yk / hc, y = yk - k * hc;
    const int2 v = __ldg(reinterpret_cast<const int2*>(mv) + (size_t)(yk >> 3) * bw + bx);
    int sy = y - floor_half(v.x), sx = bx * 8 - floor_half(v.y);
    if (sy < 0 || sy >= hc) sy = wrap(sy, hc);
    if (sx < 0 || sx >= wc) sx = wrap(sx, wc);
    const size_t src = ((size_t)k * hc + sy) * wc, dst = (size_t)yk * wc + bx * 8;
    float o[8];
    read_row(o, cb + src, sx, wc);
    write_row(pcb + dst, o);
    read_row(o, cr + src, sx, wc);
    write_row(pcr + dst, o);
  }
}

// a kernel above kWholeRange: room for `smem` bytes of shared memory a
// block (past the 48 KB a launch may ask for without it) and the SM's
// largest shared-memory carveout, so that two blocks fit
template <typename K>
cudaError_t allow_banded(K* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int MB>
int launch_search(const void* cur, const void* prev, void* mv, void* pred, int nc, int h, int w,
                  int r, void* stream) {
  if (h % MB || w % MB || r < 0 || r > kMaxRange) return (int)cudaErrorInvalidValue;
  if (nc < 0 || nc > kMaxChunks) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)cur | (uintptr_t)prev | (uintptr_t)pred) % 16) return (int)cudaErrorInvalidValue;
  if (nc == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  const int mbw = w / MB;
  if (r > kWholeRange) {
    const size_t smem = banded_smem(MB, r);
    const cudaError_t err = allow_banded(motion_search_banded_kernel<MB>, smem);
    if (err != cudaSuccess) return (int)err;
    const int nb = kBandCols / MB;
    const dim3 grid((mbw + nb - 1) / nb, h / MB, nc);
    motion_search_banded_kernel<MB><<<grid, kBandThreads, smem, (cudaStream_t)stream>>>(
        (const float*)cur, (const float*)prev, (int32_t*)mv, (float*)pred, h, w, r);
    return (int)cudaGetLastError();
  }
  const SearchShape shape = search_shape(MB, r);
  // the largest, MB = 16 at r = 32, is 45.3 KB: within what a launch may
  // ask for without cudaFuncSetAttribute
  if (shape.smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((mbw + shape.nb - 1) / shape.nb, h / MB, nc);
  motion_search_mc_kernel<MB><<<grid, kSearchThreads, shape.smem, (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)prev, (int32_t*)mv, (float*)pred, h, w, r);
  return (int)cudaGetLastError();
}

bool chroma_args_ok(const void* cb, const void* cr, const void* mv, const void* pcb,
                    const void* pcr, int hc, int wc) {
  return hc >= 0 && wc >= 0 && hc % 8 == 0 && wc % 8 == 0 &&
         ((uintptr_t)cb | (uintptr_t)cr | (uintptr_t)pcb | (uintptr_t)pcr) % 16 == 0 &&
         (uintptr_t)mv % 8 == 0;
}

int launch_chroma(const void* cb, const void* cr, const void* mv, void* pcb, void* pcr, int nc,
                  int hc, int wc, void* stream) {
  if (nc < 0 || !chroma_args_ok(cb, cr, mv, pcb, pcr, hc, wc)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)nc * hc * (wc / 8);
  if (rows == 0) return (int)cudaSuccess;
  if (rows > INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != (int)cudaSuccess) return err;
  const long long need = (rows + kChromaThreads - 1) / kChromaThreads;
  const long long room = (long long)sms * kChromaWaves;
  chroma_mc_kernel<<<(unsigned)(need < room ? need : room), kChromaThreads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)cb, (const float*)cr, (const int32_t*)mv, (float*)pcb, (float*)pcr, nc, hc,
      wc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry takes nc chunks' planes one after the other (one frame step of
// nc GOP chunks) and serves them in one launch; nc = 1 is one plane pair.
//
// cur, prev: (nc, h, w) float32, h and w multiples of 16; mv: (nc, h/16,
// w/16, 2) int32 out; pred: (nc, h, w) float32 out; 0 <= r <= 126 (above
// 32 the window is staged in bands of candidate rows); 0 <= nc <= 65535.
int flu_motion_search_mc(const void* cur, const void* prev, void* mv, void* pred, int nc, int h,
                         int w, int r, void* stream) {
  return launch_search<kMB>(cur, prev, mv, pred, nc, h, w, r, stream);
}

// flu_motion_search_mc at block size mb (8 or 16): h and w multiples of mb;
// mv: (nc, h/mb, w/mb, 2) int32 out.
int flu_motion_search_mc_blocks(const void* cur, const void* prev, void* mv, void* pred, int nc,
                                int h, int w, int r, int mb, void* stream) {
  if (mb == 16) return launch_search<16>(cur, prev, mv, pred, nc, h, w, r, stream);
  if (mb == 8) return launch_search<8>(cur, prev, mv, pred, nc, h, w, r, stream);
  return (int)cudaErrorInvalidValue;
}

// K5, the whole hier search: cur, prev (nc, h, w) float32, multiples of 16,
// 16-byte aligned; mv (nc, h/16, w/16, 2) int32 out; pred (nc, h, w)
// float32 out; 1 <= r <= 126 (above 32 motion_search_hier_wide_kernel).
// Above 48 KB of shared memory (r >= 24) the launch asks for more; a
// shape past the 227 KB a block may have is refused.
int flu_motion_search_hier(const void* cur, const void* prev, void* mv, void* pred, int nc, int h,
                           int w, int r, void* stream) {
  if (h % kMB || w % kMB || r < 1 || r > kMaxRange) return (int)cudaErrorInvalidValue;
  if (nc < 0 || nc > kMaxChunks) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)cur | (uintptr_t)prev | (uintptr_t)pred) % 16) return (int)cudaErrorInvalidValue;
  if (nc == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  if (r > kWholeRange) {
    const HierWideShape shape = hier_wide_shape(r);
    const cudaError_t err = allow_banded(motion_search_hier_wide_kernel, shape.smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((w / kMB + shape.nb - 1) / shape.nb, h / kMB, nc);
    motion_search_hier_wide_kernel<<<grid, kBandThreads, shape.smem, (cudaStream_t)stream>>>(
        (const float*)cur, (const float*)prev, (int32_t*)mv, (float*)pred, h, w, r);
    return (int)cudaGetLastError();
  }
  const HierShape shape = hier_shape(r);
  if (shape.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (shape.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        motion_search_hier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shape.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((w / kMB + shape.nb - 1) / shape.nb, h / kMB, nc);
  motion_search_hier_kernel<<<grid, kHierThreads, shape.smem, (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)prev, (int32_t*)mv, (float*)pred, h, w, r);
  return (int)cudaGetLastError();
}

// K4: cb, cr (nc, hc, wc) float32, multiples of 8, 16-byte aligned; mv
// (nc, hc/8, wc/8, 2) int32 luma vectors, 8-byte aligned; pcb, pcr (nc,
// hc, wc) float32 out, 16-byte aligned.
int flu_chroma_mc(const void* cb, const void* cr, const void* mv, void* pcb, void* pcr, int nc,
                  int hc, int wc, void* stream) {
  return launch_chroma(cb, cr, mv, pcb, pcr, nc, hc, wc, stream);
}

}  // extern "C"
