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
// lanes cannot index memory. Here one thread block owns one 16x16
// macroblock: it stages the (16 + 2r)^2 wrap-around reference window and
// the current block in shared memory, each thread sums the SAD of its
// candidates from there, the block reduces to the winner, and the same
// window then yields the prediction. Any plane size that is a multiple of
// 16 works; nothing is padded.
//
// What bounds it on the H100: arithmetic on shared memory. At 1088x1920
// and r = 7 a frame is 8,160 macroblocks x 225 candidates x 256
// absolute differences (470 M), against 8 MB read from device memory;
// each difference is two shared loads, a subtract, an abs and an add.
// The window's row stride is chosen = 16 mod 32 words, so the three dy
// rows a warp's 32 candidates touch fall on different banks.
//
// Contract (bit-identical to the plain PyTorch version,
// ops/motion_kernels.py:motion_search_mc_plain):
//   - candidate (dy, dx) predicts pixel (i, j) from
//     prev[(i - dy) mod H, (j - dx) mod W] (torch.roll's sign);
//   - SAD summed per column down the 16 rows, then the 16 column sums
//     left to right, every add rounded on its own (no FMA contraction);
//   - cost = SAD * 64 + |dy| + |dx| in fp32;
//   - least cost wins, ties to the first candidate in dy-major order
//     c = (dy + r) * (2r + 1) + (dx + r): the block reduces on the pair
//     (cost, c), never on arrival order.
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
constexpr int kWarps = kSearchThreads / 32;
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

__host__ __device__ __forceinline__ int window_stride(int span) {
  return span + ((16 - span % 32) + 32) % 32;
}

template <int MB>
__global__ void __launch_bounds__(kSearchThreads)
motion_search_mc_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                        int32_t* __restrict__ mv, float* __restrict__ pred, int h, int w,
                        int r) {
  static_assert(MB * MB <= kSearchThreads && kSearchThreads % (MB * MB) == 0,
                "one pass of the block's threads covers a whole number of blocks");
  extern __shared__ float smem[];
  const int span = MB + 2 * r;
  const int stride = window_stride(span);
  float* win = smem;                       // span x stride
  float* blk = win + span * stride;        // MB x MB current block
  float* red_cost = blk + MB * MB;         // kWarps
  int* red_idx = reinterpret_cast<int*>(red_cost + kWarps);  // kWarps + 1

  const int t = threadIdx.x;
  const int y0 = blockIdx.y * MB;
  const int x0 = blockIdx.x * MB;

  // window element (a, b) = prev[(y0 - r + a) mod h, (x0 - r + b) mod w]
  for (int k = t; k < span * span; k += kSearchThreads) {
    const int a = k / span;
    const int b = k - a * span;
    win[a * stride + b] = prev[(size_t)wrap(y0 - r + a, h) * w + wrap(x0 - r + b, w)];
  }
  if (t < MB * MB) blk[t] = cur[(size_t)(y0 + t / MB) * w + x0 + t % MB];
  __syncthreads();

  const int n = 2 * r + 1;
  float best = INFINITY;
  int best_c = INT_MAX;
  for (int c = t; c < n * n; c += kSearchThreads) {  // ascending: strict < keeps the first
    const int dy = c / n - r;
    const int dx = c - (c / n) * n - r;
    const float* src = win + (r - dy) * stride + (r - dx);
    float sad = 0.f;
#pragma unroll 1
    for (int j = 0; j < MB; j++) {
      float col = fabsf(__fsub_rn(blk[j], src[j]));
#pragma unroll
      for (int i = 1; i < MB; i++)
        col = __fadd_rn(col, fabsf(__fsub_rn(blk[i * MB + j], src[i * stride + j])));
      sad = j == 0 ? col : __fadd_rn(sad, col);
    }
    const float cost = __fadd_rn(__fmul_rn(sad, 64.f), (float)(abs(dy) + abs(dx)));
    if (cost < best) {
      best = cost;
      best_c = c;
    }
  }

  // block argmin on (cost, c): warp shuffles, then warp 0 over the warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_c, off);
    if (better(oc, oi, best, best_c)) {
      best = oc;
      best_c = oi;
    }
  }
  if ((t & 31) == 0) {
    red_cost[t >> 5] = best;
    red_idx[t >> 5] = best_c;
  }
  __syncthreads();
  if (t < 32) {
    best = t < kWarps ? red_cost[t] : INFINITY;
    best_c = t < kWarps ? red_idx[t] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float oc = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_c, off);
      if (better(oc, oi, best, best_c)) {
        best = oc;
        best_c = oi;
      }
    }
    if (t == 0) red_idx[kWarps] = best_c;
  }
  __syncthreads();

  // no candidate beat +inf only when every cost is NaN; the plain version
  // then keeps its initial (0, 0)
  const int c = red_idx[kWarps] == INT_MAX ? r * n + r : red_idx[kWarps];
  const int dy = c / n - r;
  const int dx = c - (c / n) * n - r;
  if (t == 0) {
    int32_t* out = mv + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2;
    out[0] = dy;
    out[1] = dx;
  }
  if (t < MB * MB) {
    const int i = t / MB;
    const int j = t % MB;
    pred[(size_t)(y0 + i) * w + x0 + j] = win[(i + r - dy) * stride + (j + r - dx)];
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
  if (h == 0 || w == 0) return (int)cudaSuccess;
  const int span = MB + 2 * r;
  const size_t smem = sizeof(float) * ((size_t)span * window_stride(span) + MB * MB + kWarps) +
                      sizeof(int) * (kWarps + 1);
  const dim3 grid(w / MB, h / MB);
  motion_search_mc_kernel<MB><<<grid, kSearchThreads, smem, (cudaStream_t)stream>>>(
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
