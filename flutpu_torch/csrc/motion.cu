// Full-search motion estimation with luma prediction (K3, and K6a at any
// block size), the hierarchical search's refine stage (K5), and 4:2:0
// chroma motion compensation of both planes (K4), for Hopper.
//
// motion_search_mc_kernel replaces
// flutpu/codec/ops/motion_pallas.py:motion_search_mc_dxmajor_pallas (the
// Pallas TPU kernel `_search_mc_dxmajor_kernel`). The TPU kernel held a
// band of rows in VMEM and evaluated each candidate as whole-band lane
// and sublane rolls, summed SADs with block-diagonal ones-matrices on the
// MXU and padded widths to 128 lanes: workarounds for a machine whose
// lanes cannot index memory. Any plane size that is a multiple of the
// block size works here; nothing is padded.
//
// What bounds it on the H100: by the data sheet, fp32 operations (at
// 1088x1920 and r = 7 a frame is 8,160 macroblocks x 225 candidates x 256
// absolute differences, 470 M, against 8 MB of device memory). In
// practice a search that fetches both operands of every difference from
// shared memory is bound by shared-memory issue, 2 loads per difference,
// long before the arithmetic; and a thread per candidate leaves most of a
// block idle at small ranges (49 of 256 threads at 8x8 and r = 3).
//
// The design: register tiling of the SAD.
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
//     no faster at twice the registers: the loads are no longer what the
//     kernel waits for.)
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
// The search kernel is a template on the block size MB (16 or 8). The
// MB = 16 instance is K3 (entry flu_motion_search_mc). Both instances
// serve K6a (flu_motion_search_mc_blocks), which replaces
// motion_pallas.py:motion_search_mc_pallas: K3's contract at any block
// size, the prediction shifting each MB x MB block by its full vector (as
// the TPU kernel does; motion_compensate would halve it at MB != 16). K5's
// coarse level is the MB = 8 instance on 2x2-pooled planes.
//
// motion_refine_mc_kernel is K5's refine stage (flu_motion_refine_mc); it
// replaces motion_pallas.py:_refine_mc_kernel of
// motion_search_mc_hier_pallas, which rolled whole bands once per
// absolute candidate that some macroblock wanted and skipped the rest
// with lax.cond. Here one thread block owns one 16x16 macroblock: it
// stages the 18x18 wrap-around window around the macroblock's base
// vector and the current block in shared memory, 144 threads sum the
// nine candidates' 16 column SADs (each down its 16 rows), nine threads
// sum each candidate's columns left to right (ops/motion.py:_mb_sums'
// order, every add rounded on its own), one thread scans the nine costs
// in (oy, ox) row-major order with a strict < (the first wins ties; the
// cost is the plain SAD, no centre bias), and the block writes the vector
// base + (oy, ox) and the prediction from the same window. Bound on the
// H100 by device memory: ~2.3 KB read and 1 KB written per macroblock,
// 2,304 absolute differences; the pooled coarse search costs far more.
//
// chroma_mc_kernel replaces motion_pallas.py:chroma_mc_pallas (the Pallas
// TPU kernel `_chroma_mc_kernel`), which rolled a wrap-padded band once per
// distinct halved shift and selected per pixel. Here each thread gathers
// its pixel directly. It is pure selection, bound by device memory
// (about 8 MB moved for both 544x960 planes), and bit-identical to
// ops/motion.py:motion_compensate(prev, mv, mb=8): the luma vectors are
// floor-halved (-7 -> -4; C's `/` truncates, so the halving subtracts the
// low bit first).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMB = 16;  // luma macroblock (K3, K5's refine)
constexpr int kSearchThreads = 256;
constexpr int kMaxRange = 32;

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

// what the host sizes for a launch and the kernel lays out the same way
struct SearchShape {
  int nb;       // macroblocks per thread block
  int off;      // spare window columns on the left: r + off is a multiple of 4
  int groups;   // groups of kShifts window columns that cover off + 2r + 1
  int stride;   // window row, words
  size_t smem;  // bytes
};

__host__ __device__ inline SearchShape search_shape(int mb, int r) {
  SearchShape s;
  s.nb = (r <= 8 ? 128 : 64) / mb;
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

// floor(a / d) from inv = 1 / d rounded to nearest, for 0 <= a < 2^20 and
// d <= 2^10: (a + 0.5) / d lies at least 0.5 / d from an integer, the two
// roundings move it by less than a / d * 2^-22. Three instructions where
// the integer division takes about forty.
__device__ __forceinline__ int div_by(int a, float inv) {
  return __float2int_rz(__fmul_rn((float)a + 0.5f, inv));
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

template <int MB>
__global__ void __launch_bounds__(kSearchThreads, 4)
motion_search_mc_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                        int32_t* __restrict__ mv, float* __restrict__ pred, int h, int w,
                        int r) {
  static_assert(MB % kCols == 0 && 32 % (MB / kCols) == 0,
                "the items of one candidate's columns share a warp");
  constexpr int JG = MB / kCols;  // items per candidate group
  extern __shared__ __align__(16) float smem[];
  const SearchShape shape = search_shape(MB, r);
  const int stride = shape.stride, groups = shape.groups, off = shape.off;
  const int cstride = shape.nb * MB;
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

  // window element (a, b) = prev[(y0 - r + a) mod h, (x0 - r - off + b) mod w],
  // 16 bytes per thread and step; w is a multiple of 8, so a word that
  // starts at a multiple of 4 lies inside the plane after the wrap
  const int s4 = stride / 4;
  const float inv_s4 = __frcp_rn((float)s4);
  for (int k = t; k < span * s4; k += kSearchThreads) {
    const int a = div_by(k, inv_s4), b = 4 * (k - a * s4);
    int row = y0 - r + a, col = x0 - r - off + b;
    if (row < 0 || row >= h) row = wrap(row, h);
    if (col < 0 || col >= w) col = wrap(col, w);
    *reinterpret_cast<float4*>(win + a * stride + b) =
        __ldg(reinterpret_cast<const float4*>(prev + (size_t)row * w + col));
  }
  const int c4 = nbv * MB / 4;
  const float inv_c4 = __frcp_rn((float)c4);
  for (int k = t; k < MB * c4; k += kSearchThreads) {
    const int i = div_by(k, inv_c4), b = 4 * (k - i * c4);
    *reinterpret_cast<float4*>(blk + i * cstride + b) =
        __ldg(reinterpret_cast<const float4*>(cur + (size_t)(y0 + i) * w + x0 + b));
  }
  if (t < shape.nb) best[t] = kNoWinner;
  __syncthreads();

  // item = ((macroblock * n + ey) * groups + eg) * JG + jg, where candidate
  // row dy = r - ey reads window rows ey + i, and dx = r - e, e = 4 eg + s - off,
  // reads window columns mb * MB + j + off + e
  const int n = 2 * r + 1;
  const int total = nbv * n * groups * JG;
  const float inv_groups = __frcp_rn((float)groups), inv_n = __frcp_rn((float)n);
  for (int base = 0; base < total; base += kSearchThreads) {
    const int item = base + t;
    const bool valid = item < total;
    const int jg = item % JG;
    const int q = div_by(item / JG, inv_groups), eg = item / JG - q * groups;
    const int mbk = div_by(q, inv_n), ey = q - mbk * n;

    // column sums: shift s, column c; 0 + x is x, so the sums start as
    // the contract's do, at the first difference
    float acc[kShifts][kCols];
#pragma unroll
    for (int s = 0; s < kShifts; s++)
#pragma unroll
      for (int c = 0; c < kCols; c++) acc[s][c] = 0.f;
    if (valid) {
      const float* wp = win + ey * stride + mbk * MB + jg * kCols + eg * kShifts;
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
  __syncthreads();

  if (t < nbv) {
    // no winner only when every cost is NaN or +inf; the plain version
    // then keeps its initial (0, 0)
    const int c = best[t] == kNoWinner ? r * n + r : (int)(best[t] & 0xffffffffu);
    const int dy = c / n - r;
    const int dx = c - (c / n) * n - r;
    vec[2 * t] = dy;
    vec[2 * t + 1] = dx;
    int32_t* out = mv + ((size_t)blockIdx.y * (w / MB) + mb0 + t) * 2;
    out[0] = dy;
    out[1] = dx;
  }
  __syncthreads();
  for (int k = t; k < MB * c4; k += kSearchThreads) {
    const int i = div_by(k, inv_c4), b = 4 * (k - i * c4);
    const int m = b / MB;
    const float* src = win + (i + r - vec[2 * m]) * stride + b + r + off - vec[2 * m + 1];
    *reinterpret_cast<float4*>(pred + (size_t)(y0 + i) * w + x0 + b) =
        make_float4(src[0], src[1], src[2], src[3]);
  }
}

constexpr int kWin = kMB + 2;  // K5's refine window: the macroblock and a 1-pixel rim

__global__ void __launch_bounds__(kSearchThreads)
motion_refine_mc_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                        const int32_t* __restrict__ base, int32_t* __restrict__ mv,
                        float* __restrict__ pred, int h, int w) {
  __shared__ float win[kWin * kWin];
  __shared__ float blk[kMB * kMB];
  __shared__ float cols[9 * kMB];
  __shared__ float cost[9];
  __shared__ int best_c;

  const int t = threadIdx.x;
  const size_t m = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int y0 = blockIdx.y * kMB;
  const int x0 = blockIdx.x * kMB;
  const int by = base[m * 2];
  const int bx = base[m * 2 + 1];

  // window element (a, b) = prev[(y0 - by - 1 + a) mod h, (x0 - bx - 1 + b) mod w]:
  // candidate base + (oy, ox) predicts pixel (i, j) from element (i + 1 - oy, j + 1 - ox)
  for (int k = t; k < kWin * kWin; k += kSearchThreads) {
    const int a = k / kWin;
    const int b = k - a * kWin;
    win[k] = prev[(size_t)wrap(y0 - by - 1 + a, h) * w + wrap(x0 - bx - 1 + b, w)];
  }
  blk[t] = cur[(size_t)(y0 + (t >> 4)) * w + x0 + (t & 15)];
  __syncthreads();

  if (t < 9 * kMB) {  // thread (c, j): column j of candidate c, down its 16 rows
    const int c = t >> 4;
    const int j = t & 15;
    const float* src = win + (1 - (c / 3 - 1)) * kWin + (1 - (c % 3 - 1));
    float col = fabsf(__fsub_rn(blk[j], src[j]));
#pragma unroll
    for (int i = 1; i < kMB; i++)
      col = __fadd_rn(col, fabsf(__fsub_rn(blk[i * kMB + j], src[i * kWin + j])));
    cols[t] = col;
  }
  __syncthreads();
  if (t < 9) {  // the 16 column sums left to right
    float sad = cols[t * kMB];
#pragma unroll
    for (int j = 1; j < kMB; j++) sad = __fadd_rn(sad, cols[t * kMB + j]);
    cost[t] = sad;
  }
  __syncthreads();
  if (t == 0) {
    float best = INFINITY;
    int bc = -1;
    for (int c = 0; c < 9; c++) {  // (oy, ox) row-major; strict < keeps the first
      if (cost[c] < best) {
        best = cost[c];
        bc = c;
      }
    }
    best_c = bc;
    // every cost NaN: the plain version keeps its initial (0, 0)
    mv[m * 2] = bc < 0 ? 0 : by + bc / 3 - 1;
    mv[m * 2 + 1] = bc < 0 ? 0 : bx + bc % 3 - 1;
  }
  __syncthreads();
  const int c = best_c;
  const int i = t >> 4;
  const int j = t & 15;
  pred[(size_t)(y0 + i) * w + x0 + j] =
      c < 0 ? prev[(size_t)(y0 + i) * w + x0 + j]
            : win[(i + 1 - (c / 3 - 1)) * kWin + (j + 1 - (c % 3 - 1))];
}

// floor(v / 2) for any sign
__device__ __forceinline__ int floor_half(int v) { return (v - (v & 1)) / 2; }

__global__ void __launch_bounds__(128)
chroma_mc_kernel(const float* __restrict__ cb, const float* __restrict__ cr,
                 const int32_t* __restrict__ mv, float* __restrict__ pcb,
                 float* __restrict__ pcr, int hc, int wc) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= wc) return;
  const int32_t* v = mv + ((size_t)(y >> 3) * (wc >> 3) + (x >> 3)) * 2;
  const int sy = wrap(y - floor_half(v[0]), hc);
  const int sx = wrap(x - floor_half(v[1]), wc);
  const float* src = blockIdx.z ? cr : cb;
  float* dst = blockIdx.z ? pcr : pcb;
  dst[(size_t)y * wc + x] = src[(size_t)sy * wc + sx];
}

template <int MB>
int launch_search(const void* cur, const void* prev, void* mv, void* pred, int h, int w, int r,
                  void* stream) {
  if (h % MB || w % MB || r < 0 || r > kMaxRange) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)cur | (uintptr_t)prev | (uintptr_t)pred) % 16) return (int)cudaErrorInvalidValue;
  if (h == 0 || w == 0) return (int)cudaSuccess;
  const SearchShape shape = search_shape(MB, r);
  // the largest, MB = 16 at r = 32, is 45.3 KB: within what a launch may
  // ask for without cudaFuncSetAttribute
  if (shape.smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int mbw = w / MB;
  const dim3 grid((mbw + shape.nb - 1) / shape.nb, h / MB);
  motion_search_mc_kernel<MB><<<grid, kSearchThreads, shape.smem, (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)prev, (int32_t*)mv, (float*)pred, h, w, r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cur, prev: (h, w) float32, h and w multiples of 16; mv: (h/16, w/16, 2)
// int32 out; pred: (h, w) float32 out; 0 <= r <= 32.
int flu_motion_search_mc(const void* cur, const void* prev, void* mv, void* pred, int h, int w,
                         int r, void* stream) {
  return launch_search<kMB>(cur, prev, mv, pred, h, w, r, stream);
}

// flu_motion_search_mc at block size mb (8 or 16): h and w multiples of mb;
// mv: (h/mb, w/mb, 2) int32 out.
int flu_motion_search_mc_blocks(const void* cur, const void* prev, void* mv, void* pred, int h,
                                int w, int r, int mb, void* stream) {
  if (mb == 16) return launch_search<16>(cur, prev, mv, pred, h, w, r, stream);
  if (mb == 8) return launch_search<8>(cur, prev, mv, pred, h, w, r, stream);
  return (int)cudaErrorInvalidValue;
}

// K5's refine: cur, prev (h, w) float32, multiples of 16; base (h/16, w/16, 2)
// int32, each in -(r-1)..r-1; mv (h/16, w/16, 2) int32 out; pred (h, w)
// float32 out. r bounds the base (the window is 18x18 whatever r is).
int flu_motion_refine_mc(const void* cur, const void* prev, void* mv, void* pred, int h, int w,
                         int r, const void* base, void* stream) {
  if (h % kMB || w % kMB || r < 1 || r > kMaxRange) return (int)cudaErrorInvalidValue;
  if (h == 0 || w == 0) return (int)cudaSuccess;
  const dim3 grid(w / kMB, h / kMB);
  motion_refine_mc_kernel<<<grid, kSearchThreads, 0, (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)prev, (const int32_t*)base, (int32_t*)mv, (float*)pred, h,
      w);
  return (int)cudaGetLastError();
}

// cb, cr: (hc, wc) float32, multiples of 8; mv: (hc/8, wc/8, 2) int32 luma
// vectors; pcb, pcr: (hc, wc) float32 out.
int flu_chroma_mc(const void* cb, const void* cr, const void* mv, void* pcb, void* pcr, int hc,
                  int wc, void* stream) {
  if (hc % 8 || wc % 8) return (int)cudaErrorInvalidValue;
  if (hc == 0 || wc == 0) return (int)cudaSuccess;
  const int threads = 128;
  const dim3 grid((wc + threads - 1) / threads, hc, 2);
  chroma_mc_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)cb, (const float*)cr, (const int32_t*)mv, (float*)pcb, (float*)pcr, hc, wc);
  return (int)cudaGetLastError();
}

}  // extern "C"
