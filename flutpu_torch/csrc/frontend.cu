// Fused JPEG front end for Hopper: u8 RGB planes [-> blend of a BGRA
// subtitle overlay] -> YCbCr -> 4:2:0 -> 8x8 DCT -> quantize -> zigzag,
// one pass over device memory.
//
// Replaces flutpu/codec/ops/frontend_pallas.py:front_end_pallas (the
// Pallas TPU kernel `_kernel`, its overlay blend included). The TPU kernel
// folded the DCT and the chroma pair-mean into block-diagonal matrices so
// that every product was a full 128x128 MXU tile; none of that is needed
// here, and the arithmetic is the plain per-block C * X * C^T.
//
// What bounds it on the H100: device-memory bytes. Each pixel is 3 bytes
// in and 3 bytes out (int16 Y plus a quarter each of Cb and Cr), 12.5 MB
// for a 1088x1920 frame, while the DCT is ~1 kFLOP per 8x8 block, far
// below the fp32 rate. The design reads each pixel once
// and keeps every intermediate (YCbCr, the subsampled chroma, the DCT
// rows) in shared memory: one thread block per 16x16 macroblock, 256
// threads, one pixel each. Zigzag and blockize are fused into the store,
// so the coefficients leave in the layout the entropy stage reads.
//
// The overlay (burn-in) variant blends each pixel in registers before the
// colour conversion, so the blended planes never exist in device memory.
// The TPU kernel took four zero-padded (H, W) planes because Mosaic cannot
// read an interleaved [..., 4] layout; here each thread loads its pixel's
// 4 BGRA bytes at once from the (oh, ow, 4) overlay as it is, and pixels
// at rows >= oh or columns >= ow keep their value (the zero-alpha pad).
// One overlay serves every frame of the launch and stays in L2 across
// them (8.4 MB at 1080p). The variant is a template instance: the launch
// without an overlay runs the code it ran before the blend existed.
//
// Numerics: every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, no FMA contraction) and quantization rounds half
// to even (rintf), so the kernel follows the plain PyTorch version
// (ops/frontend.py:front_end_plain) and differs from it only where a
// different summation order moves a coefficient across a rounding tie.
// The blend is a * ov + (1 - a) * p with a = alpha / 255, then
// floor(clip(o + 0.5, 0, 255)) (the u8 round of overlay_on_planes). For
// 8-bit p, ov and alpha, o + 0.5 lies at least 1/510 from an integer, far
// above fp32 rounding, so the blended pixel is exact however the sum is
// rounded: the overlay launch equals the plain launch on planes blended
// beforehand, bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ float c_dct[64];     // dct_matrix(8), row-major C[k][x]
__constant__ float c_rgb2ycc[9];  // _RGB2YCBCR, row-major
__constant__ int c_zigzag[64];    // zigzag position -> row-major index

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float blend(float p, float ov, float a) {
  const float o = add(mul(p, 1.0f - a), mul(ov, a));
  return floorf(fminf(fmaxf(o + 0.5f, 0.0f), 255.0f));
}

template <bool OVERLAY>
__global__ void __launch_bounds__(256)
front_end_kernel(const uint8_t* __restrict__ r, const uint8_t* __restrict__ g,
                 const uint8_t* __restrict__ b, const int32_t* __restrict__ qy,
                 const int32_t* __restrict__ qc, int16_t* __restrict__ y_out,
                 int16_t* __restrict__ cb_out, int16_t* __restrict__ cr_out,
                 int h, int w, const uchar4* __restrict__ ov, int oh, int ow) {
  // blocks 0..3: the four luma blocks (sy * 2 + sx); 4: Cb; 5: Cr
  __shared__ float pix[6][64];
  __shared__ float rows[6][64];
  __shared__ float chroma[2][16][17];
  __shared__ float qtab[2][64];
  __shared__ float dct[64];
  __shared__ int zigzag[64];

  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int mx = blockIdx.x, my = blockIdx.y, f = blockIdx.z;

  const size_t idx = ((size_t)f * h + (size_t)(my * 16 + ty)) * w + mx * 16 + tx;
  float rf = r[idx], gf = g[idx], bf = b[idx];
  if (OVERLAY) {
    const int row = my * 16 + ty, col = mx * 16 + tx;
    if (row < oh && col < ow) {
      const uchar4 o = __ldg(ov + (size_t)row * ow + col);  // b, g, r, a
      const float a = __fdiv_rn((float)o.w, 255.0f);
      rf = blend(rf, (float)o.z, a);
      gf = blend(gf, (float)o.y, a);
      bf = blend(bf, (float)o.x, a);
    }
  }
  const float* m = c_rgb2ycc;
  const float yv = add(add(mul(m[0], rf), mul(m[1], gf)), mul(m[2], bf));
  const float cbv = add(add(add(mul(m[3], rf), mul(m[4], gf)), mul(m[5], bf)), 128.0f);
  const float crv = add(add(add(mul(m[6], rf), mul(m[7], gf)), mul(m[8], bf)), 128.0f);
  pix[(ty >> 3) * 2 + (tx >> 3)][(ty & 7) * 8 + (tx & 7)] = yv - 128.0f;
  chroma[0][ty][tx] = cbv;
  chroma[1][ty][tx] = crv;
  if (t < 128) qtab[t >> 6][t & 63] = (float)(t < 64 ? qy[t] : qc[t - 64]);
  if (t < 64) {
    dct[t] = c_dct[t];
    zigzag[t] = c_zigzag[t];
  }
  __syncthreads();

  if (t < 128) {  // 4:2:0 pair mean, then the level shift
    const int c = t >> 6, p = t & 63, i = p >> 3, j = p & 7;
    const float (*s)[17] = chroma[c];
    const float sum = add(add(add(s[2 * i][2 * j], s[2 * i][2 * j + 1]),
                              s[2 * i + 1][2 * j]), s[2 * i + 1][2 * j + 1]);
    pix[4 + c][p] = mul(sum, 0.25f) - 128.0f;
  }
  __syncthreads();

  // rows[blk][u][x] = sum_k C[u][k] * pix[blk][k][x]
  for (int o = t; o < 6 * 64; o += 256) {
    const int blk = o >> 6, u = (o >> 3) & 7, x = o & 7;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; k++) acc = add(acc, mul(dct[u * 8 + k], pix[blk][k * 8 + x]));
    rows[blk][u * 8 + x] = acc;
  }
  __syncthreads();

  // coef[blk][u][v] = sum_x rows[blk][u][x] * C[v][x], quantized, stored
  // at its zigzag position
  const int bw = w >> 3, cw = w >> 4;
  for (int o = t; o < 6 * 64; o += 256) {
    const int blk = o >> 6, k = o & 63;
    const int p = zigzag[k], u = p >> 3, v = p & 7;
    float acc = 0.0f;
#pragma unroll
    for (int x = 0; x < 8; x++) acc = add(acc, mul(rows[blk][u * 8 + x], dct[v * 8 + x]));
    const float q = qtab[blk < 4 ? 0 : 1][p];
    const int16_t val = (int16_t)rintf(__fdiv_rn(acc, q));
    if (blk < 4) {
      const int by = my * 2 + (blk >> 1), bx = mx * 2 + (blk & 1);
      y_out[(((size_t)f * (h >> 3) + by) * bw + bx) * 64 + k] = val;
    } else {
      int16_t* out = blk == 4 ? cb_out : cr_out;
      out[(((size_t)f * (h >> 4) + my) * cw + mx) * 64 + k] = val;
    }
  }
}

}  // namespace

extern "C" {

// Upload the constants (DCT matrix, colour matrix, zigzag order) to the
// current device. Host pointers.
int flu_front_end_init(const float* dct, const float* rgb2ycc, const int* zigzag) {
  cudaError_t err = cudaMemcpyToSymbol(c_dct, dct, sizeof(float) * 64);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_rgb2ycc, rgb2ycc, sizeof(float) * 9);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_zigzag, zigzag, sizeof(int) * 64);
  return (int)err;
}

// r, g, b: (f, h, w) u8; qy, qc: (8, 8) int32 row-major; y: (f, h/8, w/8,
// 64) int16; cb, cr: (f, h/16, w/16, 64) int16. h and w multiples of 16.
// ov: null, or one (oh, ow, 4) u8 BGRA overlay (4-byte aligned, oh <= h,
// ow <= w) blended into every frame before the colour conversion.
int flu_front_end(const void* r, const void* g, const void* b, const void* qy,
                  const void* qc, void* y, void* cb, void* cr, int f, int h,
                  int w, const void* ov, int oh, int ow, void* stream) {
  dim3 grid(w / 16, h / 16, f);
  auto kernel = ov ? front_end_kernel<true> : front_end_kernel<false>;
  kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)r, (const uint8_t*)g, (const uint8_t*)b,
      (const int32_t*)qy, (const int32_t*)qc, (int16_t*)y, (int16_t*)cb,
      (int16_t*)cr, h, w, (const uchar4*)ov, oh, ow);
  return (int)cudaGetLastError();
}

}  // extern "C"
