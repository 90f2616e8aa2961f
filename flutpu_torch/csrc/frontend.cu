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
// What bounds it on the H100. By the data sheet, device-memory bytes:
// each pixel is 3 bytes in and 3 bytes out (int16 Y plus a quarter each
// of Cb and Cr), 12.5 MB for a 1088x1920 frame. In practice the fp32
// issue slots come close behind: the numerics contract below forbids
// FMA, so a coefficient costs 16 multiplies and 14 adds over the two DCT
// passes plus a division, about 2 G separate instructions per
// 16-frame GOP, which at 128 lanes per SM and clock is as long as the
// byte bound. What the kernel must not be bound by is shared memory: a
// thread that fetches both operands of every product from shared memory
// issues 16 shared loads per coefficient and pass, and that alone costs
// three times the byte bound.
//
// The design. A thread block (128 threads) walks strips of 8 macroblocks
// (16 rows x 128 columns: 32 luma and 16 chroma 8x8 blocks), grid-stride,
// and stages its tables once: each thread keeps its row of both
// quantization tables and of the inverse zigzag order in registers.
// Per strip:
//   1. load + colour: a thread loads 2 rows x 8 columns of each plane as
//      8-byte words (a warp covers 16 rows x 32 bytes: whole sectors),
//      blends the overlay, converts to YCbCr in registers, takes the
//      4:2:0 pair mean inside the thread (the 2x2 cells lie within its 2
//      rows), and writes level-shifted samples into 8x8 tiles in shared
//      memory. The loads of the next strip are issued before the DCT of
//      this one and land under it.
//   2. the DCT as two register-resident 1-D passes. Pass 1: a thread
//      owns one column of one block, reads its 8 samples, produces the 8
//      outputs with the DCT matrix as immediate operands of the multiplies
//      (the matrix is compiled in: no load, no register), and writes them
//      back in place. Pass 2: a
//      thread owns one row, reads 8 values, produces 8 coefficients. One
//      shared read and one write per element and pass instead of 16
//      reads. A tile is 8 rows of 9 words and tiles lie 72 words apart
//      (8 mod 32), which makes the column access of pass 1, the row
//      access of pass 2 and the stores of step 1 free of bank conflicts.
//   3. quantize (the IEEE quotient through the table's reciprocal, see
//      quotient(); round half to even) and scatter the int16
//      into a staging tile at its zigzag position; then each thread
//      stores 16 bytes, a warp 512 contiguous bytes of the coefficient
//      rows the entropy stage reads.
// The 8 threads of a block's column and row passes and the 8 that store
// it sit in one warp, so steps 2 and 3 need only __syncwarp; the tiles
// are double-buffered, so a strip costs one __syncthreads.
//
// No tensor cores: the TPU kernel computes in exact f32 (precision
// HIGHEST), and the contract here is one rounding per product and per
// sum. wgmma offers TF32 or bf16 inputs and fused accumulation; neither
// can reproduce that, and the products are 8 deep, far below a tile.
//
// The overlay (burn-in) variant blends each pixel in registers before the
// colour conversion, so the blended planes never exist in device memory.
// It reads the (oh, ow, 4) BGRA window as it is, 16 bytes (4 pixels) per
// load where ow is a multiple of 4 and pixel by pixel otherwise; rows
// >= oh and columns >= ow keep their value (the zero-alpha pad), and a
// pixel of alpha 0 skips the blend, which would return it unchanged. One
// overlay serves every frame of the launch and stays in L2 across them
// (8.4 MB at 1080p). The variant is a template instance: the launch
// without an overlay carries none of its code.
//
// With shared memory out of the way the kernel is bound by instruction
// issue, so the rest of the design removes instructions that are not the
// contract's multiplies and adds: strips are located by carries instead
// of divisions, a thread keeps the eight staging addresses of its zigzag
// scatter in registers, bytes become floats by one byte permute and one
// add, the blend rounds with two adds, and the quantizer divides in three
// instructions (quotient()).
//
// Numerics: every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn, no FMA contraction), each DCT output is summed
// k = 0..7 in order (the first product stands for 0 + product: only the
// sign of a zero can differ, and no integer sees it), pass 1 down the
// columns and pass 2 along the rows,
// the 2x2 chroma mean as ((tl + tr) + bl) + br, and quantization rounds
// the correctly rounded quotient half to even. That is the order of the
// one-macroblock-per-block kernel this one replaced, so the output is
// bit-identical to that kernel's (chip_smoke.py pins its hashes); it
// follows the plain PyTorch version (ops/frontend.py:front_end_plain) and
// differs from it only where a different summation order moves a
// coefficient across a rounding tie.
// The blend is a * ov + (1 - a) * p with a = alpha / 255, rounded to the
// nearest integer, which is overlay_on_planes' floor(clip(o + 0.5, 0,
// 255)): for 8-bit p, ov and alpha, o + 0.5 lies at least 1/510 from an
// integer, far above fp32 rounding, so the blended pixel is exact however
// the sum is rounded, and the overlay launch equals the plain launch on
// planes blended beforehand, bit for bit.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 4;
constexpr int kStripMB = 8;               // macroblocks per strip
constexpr int kStripW = 16 * kStripMB;    // columns per strip
constexpr int kTiles = 6 * kStripMB;      // 32 luma, 8 Cb, 8 Cr blocks
constexpr int kTileRow = 9;               // words per tile row (8 + 1 pad)
constexpr int kTile = 8 * kTileRow;       // 72 = 8 mod 32
constexpr int kTileWords = kTiles * kTile + 4;
constexpr int kStage = 80;                // int16 per staged block (64 + pad)

// dct_matrix(8), row-major C[u][k], as float32 literals: compiled in, the
// 960 multiplies of a strip take them as immediates instead of fetching
// constant memory; flu_front_end_init holds the caller's matrix to them
#define FLU_DCT8                                                                                \
  0.35355338f, 0.35355338f, 0.35355338f, 0.35355338f, 0.35355338f, 0.35355338f, 0.35355338f,   \
      0.35355338f, 0.49039263f, 0.4157348f, 0.27778512f, 0.09754516f, -0.09754516f,            \
      -0.27778512f, -0.4157348f, -0.49039263f, 0.46193975f, 0.19134171f, -0.19134171f,         \
      -0.46193975f, -0.46193975f, -0.19134171f, 0.19134171f, 0.46193975f, 0.4157348f,          \
      -0.09754516f, -0.49039263f, -0.27778512f, 0.27778512f, 0.49039263f, 0.09754516f,         \
      -0.4157348f, 0.35355338f, -0.35355338f, -0.35355338f, 0.35355338f, 0.35355338f,          \
      -0.35355338f, -0.35355338f, 0.35355338f, 0.27778512f, -0.49039263f, 0.09754516f,         \
      0.4157348f, -0.4157348f, -0.09754516f, 0.49039263f, -0.27778512f, 0.19134171f,           \
      -0.46193975f, 0.46193975f, -0.19134171f, -0.19134171f, 0.46193975f, -0.46193975f,        \
      0.19134171f, 0.09754516f, -0.27778512f, 0.4157348f, -0.49039263f, 0.49039263f,           \
      -0.4157348f, 0.27778512f, -0.09754516f

const float kDct8[64] = {FLU_DCT8};

__constant__ float c_rgb2ycc[9];  // _RGB2YCBCR, row-major
// 2^23 as a float's bits. In constant memory and not a literal, so that
// the byte permute of byte_of() keeps its selector as the immediate
// operand: with both known, the compiler moves the selector into a
// register before every permute, one more instruction per byte.
__constant__ uint32_t c_two23 = 0x4b000000u;
__device__ uint8_t g_izz[64];     // row-major index -> zigzag position

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// out[u] = sum over k = 0..7, in order, of C[u][k] * x[k]. Row 4 of the
// matrix is row 0 up to signs, and -(a * b) is (-a) * b bit for bit, so
// row 4 takes row 0's products with the sign in the add.
__device__ __forceinline__ void dct8(const float (&x)[8], float (&out)[8]) {
  constexpr float c[64] = {FLU_DCT8};
  float p0[8];
#pragma unroll
  for (int k = 0; k < 8; k++) p0[k] = mul(c[k], x[k]);
#pragma unroll
  for (int u = 0; u < 8; u++) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      float term;
      if (u == 0 || (u == 4 && c[32 + k] == c[k]))
        term = p0[k];
      else if (u == 4 && c[32 + k] == -c[k])
        term = -p0[k];
      else
        term = mul(c[u * 8 + k], x[k]);
      acc = k == 0 ? term : add(acc, term);
    }
    out[u] = acc;
  }
}

// a * ov + (1 - a) * p rounded to the nearest integer. For 8-bit p, ov
// and alpha the exact sum is a multiple of 1/255 and so at least 1/510
// from a tie, far above fp32 rounding: rounding to nearest (adding and
// subtracting 1.5 * 2^23) is floor(clip(o + 0.5, 0, 255)), the u8 round of
// overlay_on_planes, with two full-rate adds.
__device__ __forceinline__ float blend(float p, float ov, float a, float na) {
  const float o = add(mul(p, na), mul(ov, a));
  return add(add(o, 12582912.0f), -12582912.0f);
}

// a / b rounded to nearest, for a table entry b = 1..255 and y = RN(1 / b)
// (__frcp_rn): the product with the reciprocal, corrected once by the
// exact remainder. For every float 2^-3 <= |a| < 2^12 (a DCT coefficient
// of 8-bit samples stays below 2^11) and every such b this is
// __fdiv_rn(a, b) bit for bit: quotient_check_kernel below compares them
// all, 64 G pairs, on the card. Below 2^-3 it can differ in the last bit
// but stays under 1/4, so the quantized integer is 0 either way. Three
// instructions where the IEEE division takes about fifteen with its
// range check and slow-path call.
__device__ __forceinline__ float quotient(float a, float b, float y) {
  const float q0 = __fmul_rn(a, y);
  const float rem = __fmaf_rn(-q0, b, a);
  return __fmaf_rn(rem, y, q0);
}

// rint(acc / q), round half to even
__device__ __forceinline__ int16_t quantize(float acc, float q, float rq) {
  return (int16_t)__float2int_rn(quotient(acc, q, rq));
}

// counts[0] += pairs compared, counts[1] += pairs whose quotient() differs
// from __fdiv_rn in any bit: block (x, b - 1) takes divisor b, its threads
// every mantissa, exponents 2^-3 .. 2^11 and both signs
__global__ void quotient_check_kernel(unsigned long long* counts) {
  const float b = (float)(blockIdx.y + 1), y = __frcp_rn(b);
  unsigned long long n = 0, bad = 0;
  for (unsigned e = 127 - 3; e < 127 + 12; e++)
    for (unsigned m = blockIdx.x * blockDim.x + threadIdx.x; m < (1u << 23);
         m += gridDim.x * blockDim.x)
      for (unsigned sign = 0; sign < 2; sign++) {
        const float a = __uint_as_float((sign << 31) | (e << 23) | m);
        bad += __float_as_uint(quotient(a, b, y)) != __float_as_uint(__fdiv_rn(a, b));
        n++;
      }
  atomicAdd(counts, n);
  if (bad) atomicAdd(counts + 1, bad);
}

// word offset of tile b: the second luma block row is shifted by one bank
// so that the 32 lanes of a step-1 store (4 chunks x 8 row pairs) hit 32
// banks
__device__ __forceinline__ int tile_base(int b) { return b * kTile + (b >> 4); }

struct Strip {
  int f, my, sx;
};

__device__ __forceinline__ Strip locate(int s, int nsx, int mbh) {
  Strip p;
  p.sx = s % nsx;
  const int q = s / nsx;
  p.my = q % mbh;
  p.f = q / mbh;
  return p;
}

// the strip `step` strips after p, by carries instead of divisions
__device__ __forceinline__ Strip advance(Strip p, const Strip& step, int nsx, int mbh) {
  p.sx += step.sx;
  p.my += step.my;
  p.f += step.f;
  if (p.sx >= nsx) p.sx -= nsx, p.my++;
  if (p.my >= mbh) p.my -= mbh, p.f++;
  return p;
}

// 2 rows x 8 columns of each plane
struct Px {
  uint2 r[2], g[2], b[2];
};

__device__ __forceinline__ void load_px(Px& p, const uint8_t* __restrict__ r,
                                        const uint8_t* __restrict__ g,
                                        const uint8_t* __restrict__ b, size_t at, int w) {
#pragma unroll
  for (int d = 0; d < 2; d++) {
    p.r[d] = __ldg(reinterpret_cast<const uint2*>(r + at + (size_t)d * w));
    p.g[d] = __ldg(reinterpret_cast<const uint2*>(g + at + (size_t)d * w));
    p.b[d] = __ldg(reinterpret_cast<const uint2*>(b + at + (size_t)d * w));
  }
}

// byte j of 8 as a float: the byte becomes the low mantissa bits of 2^23,
// and 2^23 + byte - 2^23 is exact (a permute and a full-rate add instead
// of a shift, a mask and an integer-to-float conversion)
__device__ __forceinline__ float byte_of(uint32_t word, int j) {
  return __uint_as_float(__byte_perm(word, c_two23, 0x7650u + j)) - 8388608.0f;
}

__device__ __forceinline__ float byte_of(const uint2& v, int j) {
  return byte_of(j < 4 ? v.x : v.y, j & 3);
}

template <bool OVERLAY>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
front_end_kernel(const uint8_t* __restrict__ r, const uint8_t* __restrict__ g,
                 const uint8_t* __restrict__ b, const int32_t* __restrict__ qy,
                 const int32_t* __restrict__ qc, int16_t* __restrict__ y_out,
                 int16_t* __restrict__ cb_out, int16_t* __restrict__ cr_out,
                 int h, int w, int nsx, int total, const uint32_t* __restrict__ ov, int oh,
                 int ow) {
  __shared__ float tiles[2][kTileWords];
  __shared__ __align__(16) int16_t stage[kTiles * kStage];
  __shared__ float unit[OVERLAY ? 256 : 1];  // alpha / 255, divided once per block

  const int t = threadIdx.x;
  // steps 2 and 3: 8 threads per 8x8 block, 16 blocks per pass of the threads
  const int sub = t >> 3, l8 = t & 7;
  // step 1: 8-column chunk lc of the strip, row pair rp; a warp holds 4
  // neighbouring chunks x 8 row pairs
  const int lc = (t >> 5) * 4 + (t & 3);
  const int rp = (t >> 2) & 7;

  float qyr[8], qcr[8], ryr[8], rcr[8];  // row l8 of the tables, and reciprocals
#pragma unroll
  for (int v = 0; v < 8; v++) {
    qyr[v] = (float)__ldg(qy + l8 * 8 + v);
    qcr[v] = (float)__ldg(qc + l8 * 8 + v);
    ryr[v] = __frcp_rn(qyr[v]);
    rcr[v] = __frcp_rn(qcr[v]);
  }
  int16_t* zz[8];  // where row l8's coefficients go in block sub's staging tile
#pragma unroll
  for (int v = 0; v < 8; v++) zz[v] = stage + sub * kStage + g_izz[l8 * 8 + v];

  if constexpr (OVERLAY) {
    for (int a = t; a < 256; a += kThreads) unit[a] = __fdiv_rn((float)a, 255.0f);
    __syncthreads();
  }

  const int mbh = h >> 4, bw = w >> 3, cw = w >> 4;
  const float* m = c_rgb2ycc;

  int s = blockIdx.x;
  Strip cur = locate(s, nsx, mbh);
  const Strip step = locate(gridDim.x, nsx, mbh);
  Px px;
  if (cur.sx * kStripW + 8 * lc < w)
    load_px(px, r, g, b,
            ((size_t)cur.f * h + cur.my * 16 + 2 * rp) * w + cur.sx * kStripW + 8 * lc, w);

  for (int buf = 0; s < total; s += gridDim.x, buf ^= 1) {
    float* tl = tiles[buf];

    // -- 1. colour conversion of this thread's 2 x 8 pixels into the tiles
    const int col0 = cur.sx * kStripW + 8 * lc;
    if (col0 < w) {
      float* ty = tl + tile_base((rp >> 2) * 16 + lc);
      float cbs[4], crs[4], cb_even = 0.f, cr_even = 0.f;
#pragma unroll
      for (int d = 0; d < 2; d++) {
        const int row = cur.my * 16 + 2 * rp + d;
        uint32_t o[8];  // overlay pixels, bytes b, g, r, a from the low end
        if constexpr (OVERLAY) {
          const uint32_t* orow = ov + (size_t)row * ow + col0;
          if (row >= oh || col0 >= ow) {
#pragma unroll
            for (int j = 0; j < 8; j++) o[j] = 0;
          } else if ((ow & 3) == 0 && col0 + 8 <= ow) {
            const uint4 lo = __ldg(reinterpret_cast<const uint4*>(orow));
            const uint4 hi = __ldg(reinterpret_cast<const uint4*>(orow) + 1);
            o[0] = lo.x, o[1] = lo.y, o[2] = lo.z, o[3] = lo.w;
            o[4] = hi.x, o[5] = hi.y, o[6] = hi.z, o[7] = hi.w;
          } else {
#pragma unroll
            for (int j = 0; j < 8; j++) o[j] = col0 + j < ow ? __ldg(orow + j) : 0;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; j++) {
          float rf = byte_of(px.r[d], j), gf = byte_of(px.g[d], j), bf = byte_of(px.b[d], j);
          if constexpr (OVERLAY) {
            if (o[j] >> 24) {  // alpha 0 returns the pixel as it is
              const float a = unit[o[j] >> 24], na = 1.0f - a;
              rf = blend(rf, byte_of(o[j], 2), a, na);
              gf = blend(gf, byte_of(o[j], 1), a, na);
              bf = blend(bf, byte_of(o[j], 0), a, na);
            }
          }
          const float yv = add(add(mul(m[0], rf), mul(m[1], gf)), mul(m[2], bf));
          const float cbv = add(add(add(mul(m[3], rf), mul(m[4], gf)), mul(m[5], bf)), 128.0f);
          const float crv = add(add(add(mul(m[6], rf), mul(m[7], gf)), mul(m[8], bf)), 128.0f);
          ty[((2 * rp + d) & 7) * kTileRow + j] = yv - 128.0f;
          // 4:2:0 pair mean: ((top left + top right) + bottom left) + bottom right
          if (d == 0 && (j & 1) == 0) {
            cb_even = cbv;
            cr_even = crv;
          } else if (d == 0) {
            cbs[j >> 1] = add(cb_even, cbv);
            crs[j >> 1] = add(cr_even, crv);
          } else {
            cbs[j >> 1] = add(cbs[j >> 1], cbv);
            crs[j >> 1] = add(crs[j >> 1], crv);
          }
        }
      }
      float* tcb = tl + tile_base(4 * kStripMB + (lc >> 1)) + rp * kTileRow + (lc & 1) * 4;
      float* tcr = tcb + kStripMB * kTile;
#pragma unroll
      for (int jj = 0; jj < 4; jj++) {
        tcb[jj] = mul(cbs[jj], 0.25f) - 128.0f;
        tcr[jj] = mul(crs[jj], 0.25f) - 128.0f;
      }
    }

    // the next strip's pixels: in flight during this strip's DCT
    const Strip here = cur;
    if (s + gridDim.x < total) {
      cur = advance(cur, step, nsx, mbh);
      if (cur.sx * kStripW + 8 * lc < w)
        load_px(px, r, g, b,
                ((size_t)cur.f * h + cur.my * 16 + 2 * rp) * w + cur.sx * kStripW + 8 * lc, w);
    }
    __syncthreads();

    // items 0, 1: the strip's two luma block rows; 2: Cb (sub 0-7), Cr (8-15)
    const bool luma_in = here.sx * 2 * kStripMB + sub < bw;
    const bool chroma_in = here.sx * kStripMB + (sub & 7) < cw;
    const auto valid = [&](int it) { return it < 2 ? luma_in : chroma_in; };

    // -- 2a. pass 1, in place: column l8 of block (it, sub)
    //        out[u] = sum_k C[u][k] * x[k]
#pragma unroll
    for (int it = 0; it < 3; it++) {
      if (!valid(it)) continue;
      float* tp = tl + tile_base(it * 16 + sub) + l8;
      float x[8], acc[8];
#pragma unroll
      for (int k = 0; k < 8; k++) x[k] = tp[k * kTileRow];
      dct8(x, acc);
#pragma unroll
      for (int u = 0; u < 8; u++) tp[u * kTileRow] = acc[u];
    }
    __syncwarp();

    // -- 2b, 3. pass 2 on row l8: coef[v] = sum_x row[x] * C[v][x];
    //           quantize, stage at the zigzag position
#pragma unroll
    for (int it = 0; it < 3; it++) {
      if (!valid(it)) continue;
      const float* tp = tl + tile_base(it * 16 + sub) + l8 * kTileRow;
      float x[8], acc[8];
#pragma unroll
      for (int k = 0; k < 8; k++) x[k] = tp[k];
      dct8(x, acc);
#pragma unroll
      for (int v = 0; v < 8; v++)
        zz[v][it * 16 * kStage] =
            it < 2 ? quantize(acc[v], qyr[v], ryr[v]) : quantize(acc[v], qcr[v], rcr[v]);
    }
    __syncwarp();

    // -- 3. 16 bytes per thread: zigzag positions 8 * l8 .. 8 * l8 + 7
#pragma unroll
    for (int it = 0; it < 3; it++) {
      if (!valid(it)) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(stage + (it * 16 + sub) * kStage + l8 * 8);
      int16_t* dst;
      if (it < 2) {
        dst = y_out + (((size_t)here.f * (h >> 3) + here.my * 2 + it) * bw +
                       here.sx * 2 * kStripMB + sub) * 64;
      } else {
        dst = (sub < 8 ? cb_out : cr_out) +
              (((size_t)here.f * mbh + here.my) * cw + here.sx * kStripMB + (sub & 7)) * 64;
      }
      *reinterpret_cast<uint4*>(dst + l8 * 8) = v;
    }
  }
}

}  // namespace

extern "C" {

// Upload the constants (colour matrix, zigzag order) to the current
// device and hold the caller's DCT matrix to the one compiled in. Host
// pointers; zigzag[k] is the row-major index at zigzag position k.
int flu_front_end_init(const float* dct, const float* rgb2ycc, const int* zigzag) {
  uint8_t inverse[64];
  for (int k = 0; k < 64; k++) {
    if (zigzag[k] < 0 || zigzag[k] > 63) return (int)cudaErrorInvalidValue;
    inverse[zigzag[k]] = (uint8_t)k;
  }
  if (memcmp(dct, kDct8, sizeof(kDct8)) != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyToSymbol(c_rgb2ycc, rgb2ycc, sizeof(float) * 9);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_izz, inverse, sizeof(inverse));
  return (int)err;
}

// r, g, b: (f, h, w) u8, 8-byte aligned; qy, qc: (8, 8) int32 row-major;
// y: (f, h/8, w/8, 64) int16; cb, cr: (f, h/16, w/16, 64) int16, 16-byte
// aligned. h and w multiples of 16. ov: null, or one (oh, ow, 4) u8 BGRA
// overlay (16-byte aligned, oh <= h, ow <= w) blended into every frame
// before the colour conversion.
int flu_front_end(const void* r, const void* g, const void* b, const void* qy,
                  const void* qc, void* y, void* cb, void* cr, int f, int h,
                  int w, const void* ov, int oh, int ow, void* stream) {
  if (f < 0 || h < 0 || w < 0 || h % 16 || w % 16) return (int)cudaErrorInvalidValue;
  if (ov && (oh > h || ow > w || oh <= 0 || ow <= 0)) return (int)cudaErrorInvalidValue;
  const int nsx = (w + kStripW - 1) / kStripW;
  const long long total = (long long)nsx * (h / 16) * f;
  if (total == 0) return (int)cudaSuccess;
  if (total > INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != (int)cudaSuccess) return err;
  const long long resident = (long long)sms * kBlocksPerSM;
  const int grid = (int)(total < resident ? total : resident);
  auto kernel = ov ? front_end_kernel<true> : front_end_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)r, (const uint8_t*)g, (const uint8_t*)b,
      (const int32_t*)qy, (const int32_t*)qc, (int16_t*)y, (int16_t*)cb,
      (int16_t*)cr, h, w, nsx, (int)total, (const uint32_t*)ov, oh, ow);
  return (int)cudaGetLastError();
}

// Compare quotient() with __fdiv_rn on every pair the kernel can meet.
// counts: 2 x uint64 on the device, zeroed by the caller; on return
// (after the stream has run) [0] holds the pairs compared, [1] those that
// differ.
int flu_front_end_quotient_check(void* counts, void* stream) {
  quotient_check_kernel<<<dim3(64, 255), 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
