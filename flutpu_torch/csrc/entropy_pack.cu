// Baseline-JPEG Huffman packs of MCU-ordered blocks, for Hopper: per
// segment (K2) and per block (K7, K8a, K8b).
//
// K2 (`pack_segments_kernel`) replaces flutpu/codec/ops/entropy_pallas.py:
// pack_segments_fused (the Pallas TPU kernel `_fused_seg_kernel`), K7
// (`pack_blocks_kernel`) entropy_pallas.py:pack_block_bits_fused
// (`_fused_kernel`), the non-segment layout's pack. K7 is K2 at one block
// per segment and 64 words per buffer, so both run one device routine
// (`pack_lanes`) under names of their own, which a trace tells apart. The
// TPU kernels ran every segment (block) of a 512 (1024) lane tile in
// lockstep and placed each symbol with 96-bit one-hot word selects over
// the whole staging column, because a TPU lane cannot index memory.
//
// What bounds them on the H100: bytes. Per 16-frame 1080p GOP (783,360
// blocks) K2 reads the coefficients and flags (203 MB) and writes 48,960
// segments of 64 words and counts (13 MB): 216 MB, 0.065 ms at 3.35 TB/s.
// K7 writes every block's 64 words and count as well: 407 MB, 0.122 ms.
// The first port ran one thread per segment (per block) with a serial
// 64-bit bit accumulator: a warp's loads and stores then lay 256 B (K2:
// 4 KB) apart, 32 sectors per instruction, and K2 filled a fifth of the
// card's warp slots.
//
// The design: a lane per block, 32 blocks per warp step, and the
// segments assembled in shared memory. A warp per block was measured
// first (a ballot for the nonzero mask, a lane per coefficient, a warp
// scan of the item lengths): it issues some 200 instructions per block
// whatever the block holds, while a 1080p GOP's blocks hold about one AC
// coefficient each (chip_smoke.py phase 2 prints the shares), and it
// stayed near the first port's time (PERF.md).
//   - Loads: a warp copies its 32 consecutive blocks into a shared tile
//     with 512-byte loads (rows 68 words apart: 16-byte reads of one
//     offset by 8 lanes meet every bank once); the flags are one
//     coalesced load.
//   - Symbols: each lane builds its block's 64-bit nonzero mask from the
//     tile and codes the DC, each set bit (ZRLs, the (run, size) code,
//     the extra bits) and the EOB in order, as the contract reads; a
//     block costs its lane work in proportion to its coefficients, not
//     to 64 positions. The Huffman tables sit in shared memory.
//   - Offsets: where a segment has more than one block, the lanes count
//     their blocks' bits first, a segmented warp scan (5
//     `__shfl_up_sync`) gives each block its offset in its segment (at
//     seg_g > 32 a segment takes chunks of 32 blocks, its offset carried),
//     and the lanes code again, now writing.
//   - Placement: a lane's bits go into its segment's staging row in
//     shared memory word by word with `atomicOr` (a word at either end of
//     a block may hold a neighbour's; bit ranges are disjoint, so the
//     order does not matter). A row holds min(seg_words, ceil(seg_g *
//     1664 / 32) + 1) words (1664 bits bound a block:
//     JpegEncoder.BLOCK_BITS_BOUND); bits past it or past seg_words are
//     dropped while the count goes on.
//   - Stores: each row whole, 16 bytes per lane where seg_words is a
//     multiple of 4, every word written (unused ones as 0), none at or
//     past seg_words; then lane 0 writes the count. A CTA holds 2 warps
//     (the fastest of 2, 4 and 8), fewer where one warp's rows and tile
//     would not fit 227 KB of shared memory; the wrapper refuses them.
// A dense block (uniform noise) costs its lane 63 coefficients in turn:
// there the warp per block was faster.
//
// Contract (bit-identical to the TPU kernels and to the plain PyTorch
// versions, ops/entropy_kernels.py:pack_segments_plain):
//   - DC: size category (capped at 12) code, then `size` extra bits;
//   - AC: one ZRL per 16 zeros before a nonzero coefficient, then the
//     (run, size) code and `size` extra bits (size capped at 11); EOB only
//     when the last nonzero coefficient is below position 63;
//   - comp == 1 selects the chroma tables, comp == 0 luma, comp < 0 marks
//     a padding block that emits nothing;
//   - segbits counts every bit, also past seg_words * 32, but no word past
//     the buffer is written (the encoder redispatches at the reported
//     size); every word of the buffer is written, unused ones as 0.
//
// `pack_segments_serial_kernel` and `pack_blocks_serial_kernel` are the
// first port's thread-per-segment kernels, kept under these names for
// comparison in chip_smoke.py and the card tests only; no encoder path
// reaches them.
//
// K8a (`pack_slots64_kernel`) replaces pack_block_bits_pallas64
// (`_pack_kernel64`) and K8b (`pack_slots32_kernel`) pack_block_bits_pallas
// (`_pack_kernel`): the placement of precomputed slot tables, merged slots
// of up to 59 bits (hi:lo pairs, 65 per block) or 32-bit slots (191 per
// block). The TPU kernels ran 1024 blocks in lockstep and placed each slot
// with one-hot selects over a (64, 1024) word column, bounding each tile's
// loop by its last active slot. Here one thread walks one block's slot
// row and appends each active slot's bits through the serial kernels'
// BitSink; it reads every length but a slot's value only where the length
// is not 0, so its bytes follow the data (what the bound in chip_smoke
// counts: the slots up to each block's last active one). The tables
// arrive (B, S) row-major, so a warp reads 32 rows S words apart: each
// load touches 32 sectors and the L1 serves the following iterations from
// them. A transposed table or a warp per block (coalesced reads) is later
// work. Every word of the 64-word buffer is written and bits past nbits
// are 0: the block concat reads the word after the containing one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// (length << 16) | code, indexed [chroma][size] and [chroma][run<<4|size]:
// in constant memory for the serial kernels, in global memory (copied to
// each CTA's shared memory) for the warp kernels
__constant__ uint32_t c_dc[2][16];
__constant__ uint32_t c_ac[2][256];
constexpr int kDcWords = 2 * 16;
constexpr int kTableWords = kDcWords + 2 * 256;
__device__ uint32_t g_tables[kTableWords];

constexpr int kBlockWords = 64;
constexpr int kBlockBitsBound = 1664;    // JpegEncoder.BLOCK_BITS_BOUND
constexpr int kSmemBytes = 232448;       // Hopper's shared memory per block
constexpr int kWarpsPerCta = 2;

struct BitSink {
  uint32_t* out;
  int cap;
  uint64_t acc;  // pending bits are the low `nacc` bits
  int nacc;
  int widx;
  int total;

  // append the low `len` (<= 32) bits of `val`; at most 31 bits are
  // pending before, so at most 63 after
  __device__ __forceinline__ void put(uint32_t val, int len) {
    if (len == 0) return;
    acc = (acc << len) | (val & (0xFFFFFFFFu >> (32 - len)));
    nacc += len;
    total += len;
    if (nacc >= 32) {
      nacc -= 32;
      if (widx < cap) out[widx] = (uint32_t)(acc >> nacc);
      widx++;
    }
  }

  __device__ __forceinline__ void code(uint32_t entry) { put(entry & 0xFFFFu, (int)(entry >> 16)); }

  __device__ __forceinline__ void finish() {
    if (nacc > 0) {
      if (widx < cap) out[widx] = (uint32_t)(acc << (32 - nacc));
      widx++;
    }
    for (int k = widx; k < cap; k++) out[k] = 0u;
  }
};

__device__ __forceinline__ int magnitude(int v, int max_bits) {
  const int a = v < 0 ? -v : v;
  const int n = 32 - __clz(a);
  return n < max_bits ? n : max_bits;
}

// value bits of a coefficient of category `size`: v, or v - 1 in
// ones'-complement form when negative
__device__ __forceinline__ uint32_t extra_bits(int v, int size) {
  return (uint32_t)(v < 0 ? v + (1 << size) - 1 : v);
}

// -- the first port's kernels (comparison only) -----------------------------

// one thread's segment: blocks [s * seg_g, (s + 1) * seg_g) into
// segbuf[s], their bit count into segbits[s]
__device__ __forceinline__ void pack_segment(const int32_t* __restrict__ zz,
                                             const int32_t* __restrict__ comp,
                                             uint32_t* __restrict__ segbuf,
                                             int32_t* __restrict__ segbits, int s,
                                             int seg_g, int seg_words) {
  BitSink bs{segbuf + (size_t)s * seg_words, seg_words, 0ull, 0, 0, 0};
  for (int gi = 0; gi < seg_g; gi++) {
    const size_t blk = (size_t)s * seg_g + gi;
    const int c = comp[blk];
    if (c < 0) continue;
    const int tab = c == 1;
    const int4* z4 = reinterpret_cast<const int4*>(zz + blk * 64);

    int4 q = z4[0];
    const int dsize = magnitude(q.x, 12);
    bs.code(c_dc[tab][dsize]);
    if (dsize) bs.put(extra_bits(q.x, dsize), dsize);

    int prev = 0;
    for (int i = 0; i < 16; i++) {
      if (i) q = z4[i];
      const int v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; j++) {
        const int pos = i * 4 + j;
        if (pos == 0 || v[j] == 0) continue;
        const int run = pos - prev - 1;
        for (int zr = run >> 4; zr > 0; zr--) bs.code(c_ac[tab][0xF0]);
        const int asize = magnitude(v[j], 11);
        bs.code(c_ac[tab][((run & 15) << 4) | asize]);
        bs.put(extra_bits(v[j], asize), asize);
        prev = pos;
      }
    }
    if (prev < 63) bs.code(c_ac[tab][0x00]);
  }
  bs.finish();
  segbits[s] = bs.total;
}

__global__ void __launch_bounds__(64)
pack_segments_serial_kernel(const int32_t* __restrict__ zz, const int32_t* __restrict__ comp,
                            uint32_t* __restrict__ segbuf, int32_t* __restrict__ segbits,
                            int n_segs, int seg_g, int seg_words) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < n_segs) pack_segment(zz, comp, segbuf, segbits, s, seg_g, seg_words);
}

__global__ void __launch_bounds__(64)
pack_blocks_serial_kernel(const int32_t* __restrict__ zz, const int32_t* __restrict__ comp,
                          uint32_t* __restrict__ buf, int32_t* __restrict__ nbits, int n_blocks) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < n_blocks) pack_segment(zz, comp, buf, nbits, b, 1, kBlockWords);
}

// -- K2 and K7: a lane per block, segments assembled in shared memory -----

// words of a segment's staging row: the buffer, or all a segment can fill
__host__ __device__ __forceinline__ int staging_words(int seg_g, int seg_words) {
  const long long bound = ((long long)seg_g * kBlockBitsBound + 31) / 32 + 1;
  return bound < seg_words ? (int)bound : seg_words;
}

// segments a warp codes at once: as many as 32 lanes hold, else one
__host__ __device__ __forceinline__ int segs_per_warp(int seg_g) {
  return seg_g <= 32 ? 32 / seg_g : 1;
}

// a row as allocated: whole 16-byte chunks; where a warp holds several,
// 4 words off a multiple of 8 apart, so that 32 lanes writing into 32 rows
// meet at most 4 to a bank
__host__ __device__ __forceinline__ int row_stride(int staged, int spw) {
  const int s = (staged + 3) & ~3;
  return spw == 1 || (s & 7) ? s : s + 4;
}

// a warp's tile of the 32 blocks its lanes code: rows 68 words apart, so
// that 8 lanes reading 16 bytes each at one offset of their rows meet
// every bank once
constexpr int kTileStride = 68;
constexpr int kTileWords = 32 * kTileStride;

// What a kernel instance does, for chip_smoke.py's ablation: kFull is K2
// and K7; each other part leaves out what follows it in the list.
enum Part : int {
  kStaging = 0,   // the coefficients' loads and the rows' stores: no coding
  kSymbols = 1,   // + coding and offsets; nothing placed, the rows not stored
  kPlacement = 2, // + the atomics into the rows; the rows not stored
  kFull = 3,      // + the rows' stores
};

extern __shared__ __align__(16) uint32_t s_mem[];

// A lane's bit writer: appends MSB-first from bit `off` of a shared row,
// OR-ing each 32-bit word into it as it fills (the words at either end of
// the lane's bits may hold a neighbour's); words at or past `words` are
// dropped while `total` counts on. WRITE false only counts.
template <bool WRITE>
struct RowSink {
  uint32_t* row;
  int words;
  int widx;
  uint64_t acc;  // pending bits are the low `nacc`
  int nacc;
  int total;

  __device__ __forceinline__ RowSink(uint32_t* r, int w, int off)
      : row(r), words(w), widx(off >> 5), acc(0ull), nacc(off & 31), total(0) {}

  // append `len` (<= 32) bits `val` (nothing above them set)
  __device__ __forceinline__ void put(uint32_t val, int len) {
    total += len;
    if (!WRITE) return;
    acc = (acc << len) | val;
    nacc += len;
    if (nacc >= 32) {
      nacc -= 32;
      if (widx < words) atomicOr(row + widx, (uint32_t)(acc >> nacc));
      widx++;
    }
  }

  __device__ __forceinline__ void code(uint32_t entry) { put(entry & 0xFFFFu, (int)(entry >> 16)); }

  __device__ __forceinline__ void finish() {
    if (WRITE && nacc > 0 && widx < words) atomicOr(row + widx, (uint32_t)(acc << (32 - nacc)));
  }
};

// bit p set where AC coefficient p (1..63) of the block at z (64 words,
// 16-byte aligned) is not zero
__device__ __forceinline__ uint64_t ac_mask(const int32_t* z) {
  const int4* z4 = reinterpret_cast<const int4*>(z);
  uint32_t half[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; i++) {
    const int4 q = z4[i];
    half[i >> 3] |= ((uint32_t)(q.x != 0) | (uint32_t)(q.y != 0) << 1 | (uint32_t)(q.z != 0) << 2 |
                     (uint32_t)(q.w != 0) << 3)
                    << ((i & 7) * 4);
  }
  return (((uint64_t)half[1] << 32) | half[0]) & ~1ull;
}

// One block (64 coefficients at z) Huffman-coded into `out`, visiting the
// AC coefficients of `acmask` only; `tab` 1 selects the chroma tables.
template <bool WRITE>
__device__ __forceinline__ void code_block(const int32_t* __restrict__ z, uint64_t acmask,
                                           int tab, RowSink<WRITE>& out) {
  const uint32_t* dc_tab = s_mem + (tab << 4);
  const uint32_t* ac_tab = s_mem + kDcWords + (tab << 8);
  const int dc = z[0];
  const int dsize = magnitude(dc, 12);
  out.code(dc_tab[dsize]);
  out.put(extra_bits(dc, dsize) & ((1u << dsize) - 1), dsize);
  int prev = 0;
  while (acmask) {
    const int pos = __ffsll((long long)acmask) - 1;
    acmask &= acmask - 1;
    const int v = z[pos];
    const int run = pos - prev - 1;
    for (int zr = run >> 4; zr > 0; zr--) out.code(ac_tab[0xF0]);
    const int asize = magnitude(v, 11);
    out.code(ac_tab[((run & 15) << 4) | asize]);
    out.put(extra_bits(v, asize) & ((1u << asize) - 1), asize);
    prev = pos;
  }
  if (prev < 63) out.code(ac_tab[0x00]);
}

// Units of segs_per_warp(seg_g) segments, u = warp, warp + warps, ...:
// blocks [s * seg_g, (s + 1) * seg_g) into out[s] (seg_words words),
// their bit count into nbits[s]. A lane codes one block; at seg_g > 32 a
// segment takes chunks of 32 blocks, its offset carried from one to the
// next. `staged`: staging_words(seg_g, seg_words).
template <int PART>
__device__ __forceinline__ void pack_lanes(const int32_t* __restrict__ zz,
                                           const int32_t* __restrict__ comp,
                                           uint32_t* __restrict__ out,
                                           int32_t* __restrict__ nbits, int n_segs, int seg_g,
                                           int seg_words, int staged) {
  constexpr bool kWrite = PART >= kPlacement;
  const int lane = threadIdx.x & 31;
  const int wpc = blockDim.x >> 5;
  const int spw = segs_per_warp(seg_g);
  const int stride = row_stride(staged, spw);
  uint32_t* rows = s_mem + kTableWords + (threadIdx.x >> 5) * (spw * stride + kTileWords);
  int32_t* tile = reinterpret_cast<int32_t*>(rows + spw * stride);
  for (int i = threadIdx.x; i < kTableWords; i += blockDim.x) s_mem[i] = g_tables[i];
  for (int k = lane; k < spw * stride; k += 32) rows[k] = 0u;
  __syncthreads();

  const bool small = seg_g <= 32;
  const int head = small ? lane - lane % seg_g : 0;  // the first lane of the lane's segment
  const int j = small ? min(lane / seg_g, spw - 1) : 0;  // the lane's segment in the unit
  const bool lane_used = small ? lane < spw * seg_g : true;
  uint32_t* row = rows + j * stride;
  const int chunks = small ? 1 : (seg_g + 31) / 32;
  const int units = (n_segs + spw - 1) / spw;
  const int warps = gridDim.x * wpc;

  for (int u = blockIdx.x * wpc + (threadIdx.x >> 5); u < units; u += warps) {
    const int s0 = u * spw;
    int carry = 0;   // bits of the segment's earlier chunks (seg_g > 32)
    int seg_bits = 0;  // the lane's segment's bits (seg_g <= 32)
    for (int ch = 0; ch < chunks; ch++) {
      const int g = small ? lane - head : ch * 32 + lane;
      const int s = s0 + j;
      const bool valid = lane_used && g < seg_g && s < n_segs;
      const size_t blk = (size_t)s * seg_g + g;
      const int c = valid ? comp[blk] : -1;
      // the unit's blocks [b0, b0 + nb) into the tile, 512 bytes a load
      const size_t b0 = small ? (size_t)s0 * seg_g : (size_t)s0 * seg_g + ch * 32;
      const long long left = (small ? (long long)n_segs * seg_g : (long long)(s0 + 1) * seg_g) - (long long)b0;
      const int nb = left < (small ? spw * seg_g : 32) ? (int)left : (small ? spw * seg_g : 32);
      __syncwarp();
#pragma unroll 4
      for (int t = lane; t < nb * 16; t += 32) {
        const int4 q = reinterpret_cast<const int4*>(zz + (b0 + (t >> 4)) * 64)[t & 15];
        *reinterpret_cast<int4*>(tile + (t >> 4) * kTileStride + (t & 15) * 4) = q;
      }
      __syncwarp();
      const int32_t* z = tile + lane * kTileStride;
      int n = 0, incl = 0;
      if (PART == kStaging) {
        if (c >= 0) {
          const int4* z4 = reinterpret_cast<const int4*>(z);
#pragma unroll 4
          for (int i = 0; i < 16; i++) {
            const int4 q = z4[i];
            n += (q.x | q.y | q.z | q.w) != 0;
          }
        }
        incl = n;
      } else if (seg_g == 1) {  // every block a segment of its own: no offsets
        RowSink<kWrite> sink(row, staged, 0);
        if (c >= 0) {
          code_block<kWrite>(z, ac_mask(z), c == 1, sink);
          sink.finish();
        }
        n = incl = sink.total;
      } else {
        const uint64_t acmask = c >= 0 ? ac_mask(z) : 0ull;
        if (c >= 0) {  // the block's length first
          RowSink<false> len(row, 0, 0);
          code_block<false>(z, acmask, c == 1, len);
          n = len.total;
        }
        incl = n;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
          if (lane - d >= head) incl += t;
        }
        if (c >= 0 && n > 0) {  // then its bits, at their offset in the segment
          RowSink<kWrite> sink(row, staged, carry + incl - n);
          code_block<kWrite>(z, acmask, c == 1, sink);
          sink.finish();
        }
      }
      carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
      seg_bits = __shfl_sync(0xFFFFFFFFu, incl, min(head + seg_g - 1, 31));
    }

    __syncwarp();
    for (int jj = 0; jj < spw; jj++) {  // store the unit's rows
      const int s = s0 + jj;
      if (s >= n_segs) break;
      const int bits = small ? __shfl_sync(0xFFFFFFFFu, seg_bits, jj * seg_g) : carry;
      uint32_t* r = rows + jj * stride;
      if (PART != kSymbols) {
        const int used = min(stride, (bits + 31) >> 5);
        uint32_t* dst = out + (size_t)s * seg_words;
        if ((seg_words & 3) == 0) {
          for (int k = lane * 4; k < seg_words; k += 128) {
            uint4 q = make_uint4(0u, 0u, 0u, 0u);
            if (k < used) {
              uint4* r4 = reinterpret_cast<uint4*>(r + k);
              q = *r4;
              *r4 = make_uint4(0u, 0u, 0u, 0u);
            }
            if (PART != kPlacement) *reinterpret_cast<uint4*>(dst + k) = q;
          }
        } else {
          for (int k = lane; k < seg_words; k += 32) {
            uint32_t q = 0u;
            if (k < used) {
              q = r[k];
              r[k] = 0u;
            }
            if (PART != kPlacement) dst[k] = q;
          }
        }
      }
      if (lane == 0) nbits[s] = bits;
    }
    __syncwarp();
  }
}

// K2
template <int PART>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
pack_segments_kernel(const int32_t* __restrict__ zz, const int32_t* __restrict__ comp,
                     uint32_t* __restrict__ segbuf, int32_t* __restrict__ segbits, int n_segs,
                     int seg_g, int seg_words, int staged) {
  pack_lanes<PART>(zz, comp, segbuf, segbits, n_segs, seg_g, seg_words, staged);
}

// K7: K2 at one block per segment and 64 words, under a name of its own
template <int PART>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
pack_blocks_kernel(const int32_t* __restrict__ zz, const int32_t* __restrict__ comp,
                   uint32_t* __restrict__ buf, int32_t* __restrict__ nbits, int n_blocks) {
  pack_lanes<PART>(zz, comp, buf, nbits, n_blocks, 1, kBlockWords,
                   staging_words(1, kBlockWords));
}

// Launch shape of a kernel over `units` warp units of segments whose rows
// take `warp_words` words a warp: kWarpsPerCta warps per CTA, fewer where
// their rows would not fit, and as many CTAs as the card holds at once
// (the warps walk the units grid-stride). cudaErrorInvalidValue where one
// warp's rows do not fit.
cudaError_t warp_launch_shape(const void* kernel, int units, int warp_words, dim3* grid,
                              dim3* block, size_t* smem) {
  const long long fit = (kSmemBytes / 4 - kTableWords) / warp_words;
  if (fit < 1) return cudaErrorInvalidValue;
  const int wpc = fit < kWarpsPerCta ? (int)fit : kWarpsPerCta;
  *block = dim3(wpc * 32);
  *smem = (size_t)(kTableWords + wpc * warp_words) * 4;
  cudaError_t err = cudaSuccess;
  if (*smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wpc * 32, *smem);
  if (err != cudaSuccess) return err;
  const long long need = ((long long)units + wpc - 1) / wpc;
  const long long room = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  *grid = dim3((unsigned)(need < room ? need : room));
  return cudaSuccess;
}

template <int PART>
cudaError_t launch_segments(const void* zz, const void* comp, void* segbuf, void* segbits,
                            int n_segs, int seg_g, int seg_words, cudaStream_t stream) {
  if (n_segs <= 0) return cudaSuccess;
  const int staged = staging_words(seg_g, seg_words);
  const int spw = segs_per_warp(seg_g);
  dim3 grid, block;
  size_t smem;
  const void* kernel = (const void*)pack_segments_kernel<PART>;
  cudaError_t err =
      warp_launch_shape(kernel, (n_segs + spw - 1) / spw,
                        spw * row_stride(staged, spw) + kTileWords, &grid, &block, &smem);
  if (err != cudaSuccess) return err;
  pack_segments_kernel<PART><<<grid, block, smem, stream>>>(
      (const int32_t*)zz, (const int32_t*)comp, (uint32_t*)segbuf, (int32_t*)segbits, n_segs,
      seg_g, seg_words, staged);
  return cudaGetLastError();
}

template <int PART>
cudaError_t launch_blocks(const void* zz, const void* comp, void* buf, void* nbits,
                          int n_blocks, cudaStream_t stream) {
  if (n_blocks <= 0) return cudaSuccess;
  dim3 grid, block;
  size_t smem;
  const void* kernel = (const void*)pack_blocks_kernel<PART>;
  const int staged = staging_words(1, kBlockWords), spw = segs_per_warp(1);
  cudaError_t err =
      warp_launch_shape(kernel, (n_blocks + spw - 1) / spw,
                        spw * row_stride(staged, spw) + kTileWords, &grid, &block, &smem);
  if (err != cudaSuccess) return err;
  pack_blocks_kernel<PART><<<grid, block, smem, stream>>>(
      (const int32_t*)zz, (const int32_t*)comp, (uint32_t*)buf, (int32_t*)nbits, n_blocks);
  return cudaGetLastError();
}

// K8a: merged slots, value = low `len` (<= 64) bits of (hi << 32) | lo
__global__ void __launch_bounds__(64)
pack_slots64_kernel(const int32_t* __restrict__ lens, const uint32_t* __restrict__ his,
                    const uint32_t* __restrict__ los, uint32_t* __restrict__ buf,
                    int32_t* __restrict__ nbits, int n_blocks, int n_slots) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const size_t row = (size_t)b * n_slots;
  BitSink bs{buf + (size_t)b * kBlockWords, kBlockWords, 0ull, 0, 0, 0};
  for (int s = 0; s < n_slots; s++) {
    const int len = lens[row + s];
    if (len <= 0) continue;
    if (len > 32) {
      bs.put(his[row + s], len - 32);
      bs.put(los[row + s], 32);
    } else {
      bs.put(los[row + s], len);
    }
  }
  bs.finish();
  nbits[b] = bs.total;
}

// K8b: 32-bit slots, value = low `len` (<= 32) bits of vals
__global__ void __launch_bounds__(64)
pack_slots32_kernel(const int32_t* __restrict__ lens, const uint32_t* __restrict__ vals,
                    uint32_t* __restrict__ buf, int32_t* __restrict__ nbits, int n_blocks,
                    int n_slots) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const size_t row = (size_t)b * n_slots;
  BitSink bs{buf + (size_t)b * kBlockWords, kBlockWords, 0ull, 0, 0, 0};
  for (int s = 0; s < n_slots; s++) {
    const int len = lens[row + s];
    if (len > 0) bs.put(vals[row + s], len);
  }
  bs.finish();
  nbits[b] = bs.total;
}

}  // namespace

extern "C" {

// Upload the Huffman tables to the current device. Host pointers:
// dc (2, 16) and ac (2, 256) entries (length << 16) | code.
int flu_pack_init(const uint32_t* dc, const uint32_t* ac) {
  cudaError_t err = cudaMemcpyToSymbol(c_dc, dc, sizeof(uint32_t) * 2 * 16);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_ac, ac, sizeof(uint32_t) * 2 * 256);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_tables, dc, sizeof(uint32_t) * kDcWords);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_tables, ac, sizeof(uint32_t) * 2 * 256, sizeof(uint32_t) * kDcWords);
  return (int)err;
}

// zz: (n_segs * seg_g, 64) int32 DC-diffed MCU-ordered coefficients;
// comp: (n_segs * seg_g,) int32; segbuf: (n_segs, seg_words) uint32;
// segbits: (n_segs,) int32.
int flu_pack_segments(const void* zz, const void* comp, void* segbuf, void* segbits,
                      int n_segs, int seg_g, int seg_words, void* stream) {
  return (int)launch_segments<kFull>(zz, comp, segbuf, segbits, n_segs, seg_g, seg_words,
                                     (cudaStream_t)stream);
}

// zz: (n_blocks, 64) int32 DC-diffed MCU-ordered coefficients; comp:
// (n_blocks,) int32 (0 luma, 1 chroma); buf: (n_blocks, 64) uint32;
// nbits: (n_blocks,) int32.
int flu_pack_blocks(const void* zz, const void* comp, void* buf, void* nbits, int n_blocks,
                    void* stream) {
  return (int)launch_blocks<kFull>(zz, comp, buf, nbits, n_blocks, (cudaStream_t)stream);
}

// K2 (blocks == 0) or K7 (blocks != 0, seg_g and seg_words ignored) with
// only the parts up to `part` (enum Part), for timing; the outputs are
// not the function's unless part is 3. Arguments as flu_pack_segments.
int flu_pack_ablation(const void* zz, const void* comp, void* buf, void* bits, int n_segs,
                      int seg_g, int seg_words, int blocks, int part, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (blocks) {
    switch (part) {
      case kStaging: err = launch_blocks<kStaging>(zz, comp, buf, bits, n_segs, st); break;
      case kSymbols: err = launch_blocks<kSymbols>(zz, comp, buf, bits, n_segs, st); break;
      case kPlacement: err = launch_blocks<kPlacement>(zz, comp, buf, bits, n_segs, st); break;
      case kFull: err = launch_blocks<kFull>(zz, comp, buf, bits, n_segs, st); break;
    }
  } else {
    switch (part) {
      case kStaging:
        err = launch_segments<kStaging>(zz, comp, buf, bits, n_segs, seg_g, seg_words, st);
        break;
      case kSymbols:
        err = launch_segments<kSymbols>(zz, comp, buf, bits, n_segs, seg_g, seg_words, st);
        break;
      case kPlacement:
        err = launch_segments<kPlacement>(zz, comp, buf, bits, n_segs, seg_g, seg_words, st);
        break;
      case kFull:
        err = launch_segments<kFull>(zz, comp, buf, bits, n_segs, seg_g, seg_words, st);
        break;
    }
  }
  return (int)err;
}

// The first port's K2 and K7 (thread per segment), same arguments as
// flu_pack_segments and flu_pack_blocks.
int flu_pack_segments_serial(const void* zz, const void* comp, void* segbuf, void* segbits,
                             int n_segs, int seg_g, int seg_words, void* stream) {
  const int threads = 64;
  const int blocks = (n_segs + threads - 1) / threads;
  if (blocks > 0)
    pack_segments_serial_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)zz, (const int32_t*)comp, (uint32_t*)segbuf, (int32_t*)segbits,
        n_segs, seg_g, seg_words);
  return (int)cudaGetLastError();
}

int flu_pack_blocks_serial(const void* zz, const void* comp, void* buf, void* nbits,
                           int n_blocks, void* stream) {
  const int threads = 64;
  const int blocks = (n_blocks + threads - 1) / threads;
  if (blocks > 0)
    pack_blocks_serial_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)zz, (const int32_t*)comp, (uint32_t*)buf, (int32_t*)nbits, n_blocks);
  return (int)cudaGetLastError();
}

// lens, his, los: (n_blocks, n_slots) int32 (his/los uint32 bit patterns);
// buf: (n_blocks, 64) uint32; nbits: (n_blocks,) int32.
int flu_pack_slots64(const void* lens, const void* his, const void* los, void* buf,
                     void* nbits, int n_blocks, int n_slots, void* stream) {
  const int threads = 64;
  const int blocks = (n_blocks + threads - 1) / threads;
  if (blocks > 0)
    pack_slots64_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)lens, (const uint32_t*)his, (const uint32_t*)los, (uint32_t*)buf,
        (int32_t*)nbits, n_blocks, n_slots);
  return (int)cudaGetLastError();
}

// lens, vals: (n_blocks, n_slots) int32; buf: (n_blocks, 64) uint32;
// nbits: (n_blocks,) int32.
int flu_pack_slots32(const void* lens, const void* vals, void* buf, void* nbits,
                     int n_blocks, int n_slots, void* stream) {
  const int threads = 64;
  const int blocks = (n_blocks + threads - 1) / threads;
  if (blocks > 0)
    pack_slots32_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)lens, (const uint32_t*)vals, (uint32_t*)buf, (int32_t*)nbits,
        n_blocks, n_slots);
  return (int)cudaGetLastError();
}

}  // extern "C"
