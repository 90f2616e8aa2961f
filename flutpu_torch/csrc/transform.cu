// The FVC in-loop transform (K9): the 8x8 DCT-II of every block of a
// plane, and its inverse, for Hopper.
//
// Replaces no Pallas kernel: flutpu computes the per-block transform
// (flutpu/codec/ops/dct.py: plane_dct, plane_idct) with XLA matrix
// products. The port ran them as `c @ x @ c.T` through cuBLAS, whose
// summation order follows the batch shape; the FVC reference frame is
// rebuilt from that transform and is not integer-valued, so one ulp of
// difference carried into later frames, and a chunk coded in a batch of
// chunks, on a shard or on a row stripe came out with other bytes than
// the same chunk coded alone. These kernels fix the order instead.
//
// Contract (bit-identical to the plain PyTorch version on the CPU, ops/
// transform_kernels.py: block_dct_plain, block_idct_plain): with C the
// caller's (8, 8) float32 DCT matrix (dct_matrix(8), uploaded from the
// host, never recomputed here), per block
//   DCT:  t[u][j] = sum_k C[u][k] * X[k][j],  Y[u][v] = sum_k t[u][k] * C[v][k]
//   IDCT: t[x][j] = sum_u C[u][x] * D[u][j],  P[x][y] = sum_v t[x][v] * C[v][y]
// where every sum is a chain of fused multiply-adds, acc = fma(a_k, b_k,
// acc) for k = 0..7 in ascending order, starting from acc = +0. That is
// what PyTorch's CPU matrix product computes for float32 [..., 8, 8]
// operands at every batch shape (tests/test_torch_transform.py holds it
// to an explicit chain); starting from the first product instead would
// keep a -0 where the chain gives +0. Each multiply-add is an explicit
// __fmaf_rn, so the compiler's contraction of a separate multiply and add
// (nvcc's default -fmad=true) cannot change a single rounding.
//
// What bounds it on the H100: bytes. A 1088x1920 fp32 plane is read once
// and written once (16.7 MB, 5 us at 3.35 TB/s) for 2 x 8 multiply-adds
// per sample and product direction (67 MFLOP: 1 us at 67 TFLOP/s).
//
// The design, simple first (making it fast is later work):
//   - A thread block of 256 threads takes 32 neighbouring blocks of one
//     block row, 8 threads per block, all in one warp: the warp needs
//     no barrier other than __syncwarp.
//   - The first product: a thread per column of a block (the DCT reads
//     its 8 samples from the plane, 32 adjacent columns per warp and
//     row; the IDCT stages its blocks' rows in shared memory with 16-byte
//     loads and reads a column there). The intermediate goes through
//     shared memory, rows padded to 257 words so that neither the column
//     writes nor the row reads meet a bank conflict.
//   - The second product: a thread per row, stored as two 16-byte words
//     (the DCT's block rows are contiguous; the IDCT's plane rows are,
//     with W a multiple of 8).
//   - C sits in shared memory; every lane of a warp reads the same entry
//     at once (a broadcast).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = kThreads / 8;  // 8x8 blocks per thread block
constexpr int kStride = kThreads + 1;  // padded shared row, in words

struct Tile {
  int n, by, bx;
  bool live;
};

__device__ __forceinline__ Tile tile_of(int bh, int bw, int tiles_x) {
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int rest = tile / tiles_x;
  const int bx = tx * kBlocks + (threadIdx.x >> 3);
  return Tile{rest / bh, rest % bh, bx, bx < bw};
}

__device__ __forceinline__ void load_matrix(const float* __restrict__ cmat, float* c) {
  if (threadIdx.x < 64) c[threadIdx.x] = cmat[threadIdx.x];
  __syncthreads();
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  d4[0] = make_float4(v[0], v[1], v[2], v[3]);
  d4[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// x: (n, 8 bh, 8 bw) plane -> y: (n, bh, bw, 8, 8) blocks
__global__ void __launch_bounds__(kThreads)
    block_dct_kernel(const float* __restrict__ x, const float* __restrict__ cmat,
                     float* __restrict__ y, int bh, int bw, int tiles_x) {
  __shared__ float c[64];
  __shared__ float t[8 * kStride];
  load_matrix(cmat, c);
  const Tile tl = tile_of(bh, bw, tiles_x);
  const int lane = threadIdx.x;
  const int j = lane & 7;
  const long long w = 8LL * bw;
  float col[8];
  if (tl.live) {
    const float* src = x + ((long long)tl.n * bh + tl.by) * 8 * w + tl.bx * 8 + j;
#pragma unroll
    for (int k = 0; k < 8; k++) col[k] = src[k * w];
  } else {
#pragma unroll
    for (int k = 0; k < 8; k++) col[k] = 0.f;
  }
  // t[u][j] = sum_k C[u][k] * X[k][j]
#pragma unroll
  for (int u = 0; u < 8; u++) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; k++) acc = __fmaf_rn(c[u * 8 + k], col[k], acc);
    t[u * kStride + lane] = acc;
  }
  __syncwarp();
  // this thread's row u = j: Y[u][v] = sum_k t[u][k] * C[v][k]
  const float* row = t + j * kStride + (lane & ~7);
  float r[8], out[8];
#pragma unroll
  for (int k = 0; k < 8; k++) r[k] = row[k];
#pragma unroll
  for (int v = 0; v < 8; v++) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; k++) acc = __fmaf_rn(r[k], c[v * 8 + k], acc);
    out[v] = acc;
  }
  if (tl.live)
    store8(y + (((long long)tl.n * bh + tl.by) * bw + tl.bx) * 64 + j * 8, out);
}

// d: (n, bh, bw, 8, 8) blocks -> p: (n, 8 bh, 8 bw) plane
__global__ void __launch_bounds__(kThreads)
    block_idct_kernel(const float* __restrict__ d, const float* __restrict__ cmat,
                      float* __restrict__ p, int bh, int bw, int tiles_x) {
  __shared__ float c[64];
  __shared__ float s[8 * kStride];
  load_matrix(cmat, c);
  const Tile tl = tile_of(bh, bw, tiles_x);
  const int lane = threadIdx.x;
  const int j = lane & 7;
  const int base = lane & ~7;  // this block's first shared column
  // stage: this thread's row j of its block, two 16-byte words
  if (tl.live) {
    const float4* src = reinterpret_cast<const float4*>(
        d + (((long long)tl.n * bh + tl.by) * bw + tl.bx) * 64 + j * 8);
    const float4 a = src[0], b = src[1];
    float* dst = s + j * kStride + base;
    dst[0] = a.x, dst[1] = a.y, dst[2] = a.z, dst[3] = a.w;
    dst[4] = b.x, dst[5] = b.y, dst[6] = b.z, dst[7] = b.w;
  }
  __syncwarp();
  float dc[8];
#pragma unroll
  for (int u = 0; u < 8; u++) dc[u] = s[u * kStride + base + j];
  __syncwarp();
  // t[x][j] = sum_u C[u][x] * D[u][j]
#pragma unroll
  for (int xx = 0; xx < 8; xx++) {
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < 8; u++) acc = __fmaf_rn(c[u * 8 + xx], dc[u], acc);
    s[xx * kStride + lane] = acc;
  }
  __syncwarp();
  // this thread's row x = j: P[x][y] = sum_v t[x][v] * C[v][y]
  float r[8], out[8];
#pragma unroll
  for (int v = 0; v < 8; v++) r[v] = s[j * kStride + base + v];
#pragma unroll
  for (int yy = 0; yy < 8; yy++) {
    float acc = 0.f;
#pragma unroll
    for (int v = 0; v < 8; v++) acc = __fmaf_rn(r[v], c[v * 8 + yy], acc);
    out[yy] = acc;
  }
  if (tl.live)
    store8(p + (((long long)tl.n * bh + tl.by) * 8 + j) * (8LL * bw) + tl.bx * 8, out);
}

// The grid of a launch over n planes of (h, w): one thread block per 32
// blocks of a block row. 0 where there is nothing to do, -1 on bad sizes.
long long grid_of(int n, int h, int w, int* tiles_x) {
  if (n < 0 || h < 0 || w < 0 || h % 8 || w % 8) return -1;
  *tiles_x = (w / 8 + kBlocks - 1) / kBlocks;
  const long long total = (long long)n * (h / 8) * *tiles_x;
  return total > INT32_MAX ? -1 : total;
}

}  // namespace

extern "C" {

// x: (n, h, w) float32 planes, h and w multiples of 8; cmat: (8, 8) float32
// row-major on the device; y: (n, h/8, w/8, 8, 8) float32 out, 16-byte
// aligned.
int flu_block_dct(const void* x, const void* cmat, void* y, int n, int h, int w, void* stream) {
  int tiles_x = 0;
  const long long grid = grid_of(n, h, w, &tiles_x);
  if (grid < 0) return (int)cudaErrorInvalidValue;
  if (grid == 0) return (int)cudaSuccess;
  block_dct_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)cmat, (float*)y, h / 8, w / 8, tiles_x);
  return (int)cudaGetLastError();
}

// d: (n, h/8, w/8, 8, 8) float32 blocks, 16-byte aligned; cmat as above;
// p: (n, h, w) float32 planes out, 16-byte aligned; h, w multiples of 8.
int flu_block_idct(const void* d, const void* cmat, void* p, int n, int h, int w, void* stream) {
  int tiles_x = 0;
  const long long grid = grid_of(n, h, w, &tiles_x);
  if (grid < 0) return (int)cudaErrorInvalidValue;
  if (grid == 0) return (int)cudaSuccess;
  block_idct_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)cmat, (float*)p, h / 8, w / 8, tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
