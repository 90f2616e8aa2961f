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
// K8a (`pack_slots64_kernel`) replaces pack_block_bits_pallas64
// (`_pack_kernel64`) and K8b (`pack_slots32_kernel`) pack_block_bits_pallas
// (`_pack_kernel`): the placement of precomputed (B, S) slot tables, merged
// slots of up to 64 bits (hi:lo pairs, 65 per block from the encoder) or
// 32-bit slots (191 per block). The TPU kernels ran 1024 blocks in lockstep
// and placed each slot with one-hot selects over a (64, 1024) word column,
// bounding each tile's loop by its last active slot; that bound does not
// carry over, as the EOB sits in the last slot of almost every block.
//
// What bounds them on the H100: bytes. Every length is read (a 16-frame
// 1080p GOP's 783,360 blocks hold 204 MB of lengths in K8a's tables and
// 598 MB in K8b's), the values only where the length is not 0 (about 3
// merged slots per block on a smooth GOP), and each block's 64 words and
// count are written (204 MB). The first port walked a block's row on one
// thread: a warp's 32 rows lay S words apart, so every length load touched
// 32 sectors, and its word stores landed 256 B apart.
//
// The design: a unit of consecutive blocks per warp step, `lanes` lanes
// per block (a power of two, each lane at most 32 consecutive slots of
// its block: 4 lanes and 8 blocks per unit at 65 slots, 8 lanes and 4
// blocks at 191), and the blocks assembled in shared memory as K2 and K7
// assemble theirs.
//   - Lengths: a unit's rows are one contiguous span of the table, staged
//     into a shared tile with 16-byte cp.async requests from the 16-byte
//     word that holds its first slot (a unit of 4 blocks at 191 slots is
//     191 requests, 6 per lane). The next unit's span is requested into
//     a second tile before this one is walked. A lane per block over 32
//     blocks' rows was built first: a slice of rows S words apart is not
//     16-byte aligned at odd S, and its 4-byte cp.async requests alone
//     took longer than the whole kernel's byte bound.
//   - Values: each lane reads its slots of the tile (unrolled), keeps a
//     register mask of the nonzero lengths and their sum, and requests the
//     value words of those slots alone into a value tile (4-byte
//     cp.async: a few per block); a unit where a quarter of the slots or
//     more are not 0 (a dense GOP) stages its whole lo span as the
//     lengths' instead, and hi words come only where a length exceeds 32.
//   - Offsets: a segmented warp scan of the sums over a block's lanes
//     (K2's, log2(lanes) `__shfl_up_sync`) gives each lane the offset of
//     its first bit in the block.
//   - Placement: each lane walks the set bits of its mask and appends each
//     slot's bits, masked to its length (the tables may carry bits above
//     it), through K7's RowSink from its offset into the block's 64-word
//     staging row (`atomicOr`: the words at either end of a lane's bits
//     may hold a neighbour's); a slot of 33..64 bits goes in as two
//     pieces; bits past 64 words are dropped while the count goes on.
//   - Stores: K7's row-store loop (16 bytes a lane, every word written,
//     bits past the count 0: the block concat reads the word after the
//     containing one), then each block's count from its last lane.
// At most 1,024 slots per block (32 lanes of 32); the wrapper refuses
// more.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#include "device.cuh"

namespace {

// (length << 16) | code, indexed [chroma][size] and [chroma][run<<4|size],
// in global memory (copied to each CTA's shared memory)
constexpr int kDcWords = 2 * 16;
constexpr int kTableWords = kDcWords + 2 * 256;
__device__ uint32_t g_tables[kTableWords];

constexpr int kBlockWords = 64;
constexpr int kBlockBitsBound = 1664;    // JpegEncoder.BLOCK_BITS_BOUND
constexpr int kSmemBytes = 232448;       // Hopper's shared memory per block
constexpr int kWarpsPerCta = 2;

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

// A staged row into `words` words at dst, whose first `used` words hold
// bits: 16 bytes a lane where `words` is a multiple of 4, every word
// written (unused ones as 0). The staged words are zeroed for the next
// unit.
__device__ __forceinline__ void store_row(uint32_t* __restrict__ dst, uint32_t* r, int words,
                                          int used, int lane) {
  if ((words & 3) == 0) {
    for (int k = lane * 4; k < words; k += 128) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (k < used) {
        uint4* r4 = reinterpret_cast<uint4*>(r + k);
        q = *r4;
        *r4 = make_uint4(0u, 0u, 0u, 0u);
      }
      *reinterpret_cast<uint4*>(dst + k) = q;
    }
  } else {
    for (int k = lane; k < words; k += 32) {
      uint32_t q = 0u;
      if (k < used) {
        q = r[k];
        r[k] = 0u;
      }
      dst[k] = q;
    }
  }
}

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
__device__ __forceinline__ void pack_lanes(const int32_t* __restrict__ zz,
                                           const int32_t* __restrict__ comp,
                                           uint32_t* __restrict__ out,
                                           int32_t* __restrict__ nbits, int n_segs, int seg_g,
                                           int seg_words, int staged) {
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
      if (seg_g == 1) {  // every block a segment of its own: no offsets
        RowSink<true> sink(row, staged, 0);
        if (c >= 0) {
          code_block<true>(z, ac_mask(z), c == 1, sink);
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
          RowSink<true> sink(row, staged, carry + incl - n);
          code_block<true>(z, acmask, c == 1, sink);
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
      store_row(out + (size_t)s * seg_words, rows + jj * stride, seg_words,
                min(stride, (bits + 31) >> 5), lane);
      if (lane == 0) nbits[s] = bits;
    }
    __syncwarp();
  }
}

// K2
__global__ void __launch_bounds__(kWarpsPerCta * 32)
pack_segments_kernel(const int32_t* __restrict__ zz, const int32_t* __restrict__ comp,
                     uint32_t* __restrict__ segbuf, int32_t* __restrict__ segbits, int n_segs,
                     int seg_g, int seg_words, int staged) {
  pack_lanes(zz, comp, segbuf, segbits, n_segs, seg_g, seg_words, staged);
}

// K7: K2 at one block per segment and 64 words, under a name of its own
__global__ void __launch_bounds__(kWarpsPerCta * 32)
pack_blocks_kernel(const int32_t* __restrict__ zz, const int32_t* __restrict__ comp,
                   uint32_t* __restrict__ buf, int32_t* __restrict__ nbits, int n_blocks) {
  pack_lanes(zz, comp, buf, nbits, n_blocks, 1, kBlockWords, staging_words(1, kBlockWords));
}

// -- K8a and K8b: lanes per block from contiguous staged rows ------------

constexpr int kMaxSlots = 1024;  // slots per block: 32 lanes of 32 slots
constexpr int kRowStride = 68;   // row_stride(kBlockWords, 32)

// How a unit of blocks is cut: `lanes` (a power of two) per block, each
// taking `per_lane` (<= 32) consecutive slots of its block; `group`
// blocks per unit; `tile` words stage the unit's rows (up to 3 words
// before its first slot, from the 16-byte word that holds it, and whole
// 16-byte words)
struct SlotUnits {
  int lanes, per_lane, group, tile;
};

__host__ __device__ __forceinline__ SlotUnits slot_units(int n_slots) {
  int lanes = 1;
  while (lanes < 32 && lanes * 32 < n_slots) lanes *= 2;
  const int group = 32 / lanes;
  return SlotUnits{lanes, (n_slots + lanes - 1) / lanes, group,
                   (3 + group * n_slots + 3) & ~3};
}

// a warp's words: two length tiles, `nv` value tiles (each a multiple of
// 4 words, so the rows are 16-byte aligned) and the unit's staging rows
__host__ __device__ __forceinline__ int slot_warp_words(const SlotUnits& su, int nv) {
  return (2 + nv) * su.tile + su.group * kRowStride;
}

// 4 bytes at src into shared dst, asynchronously
__device__ __forceinline__ void copy_async4(uint32_t* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// the first `bytes` (<= 16) of the 16 at src into shared dst, the rest 0
__device__ __forceinline__ void copy_async16(uint32_t* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of the latest committed groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Request rows [b0, b0 + nb) of a (B, n_slots) table into `tile`: words
// from the 16-byte word that holds table[b0][0] on, 16 bytes a lane, none
// read past the unit's last slot (`table` is 16-byte aligned).
__device__ __forceinline__ void stage_span(uint32_t* tile, const void* table, size_t b0, int nb,
                                           int n_slots, int lane) {
  const uint32_t* t = static_cast<const uint32_t*>(table);
  const size_t first = b0 * n_slots, a = first & ~(size_t)3, end = first + (size_t)nb * n_slots;
  for (size_t w = a + 4 * lane; w < end; w += 128) {
    const size_t left = end - w;
    copy_async16(tile + (w - a), t + w, left < 4 ? (int)left * 4 : 16);
  }
}

// Units of su.group blocks, u = warp, warp + warps, ...: block b's slots
// (lens[b], the values lo[b] and, where NV is 2, hi[b]) into buf[b] (64
// words) and their bit count into nbits[b]; su.lanes lanes per block.
template <int NV>
__device__ __forceinline__ void pack_slot_lanes(const int32_t* __restrict__ lens,
                                                const uint32_t* __restrict__ hi,
                                                const uint32_t* __restrict__ lo,
                                                uint32_t* __restrict__ buf,
                                                int32_t* __restrict__ nbits, int n_blocks,
                                                int n_slots) {
  const int lane = threadIdx.x & 31;
  const SlotUnits su = slot_units(n_slots);
  uint32_t* len_tiles = s_mem + (threadIdx.x >> 5) * slot_warp_words(su, NV);
  uint32_t* val_tiles = len_tiles + 2 * su.tile;  // lo, then hi
  uint32_t* rows = val_tiles + NV * su.tile;
  for (int k = lane; k < su.group * kRowStride; k += 32) rows[k] = 0u;

  const int i = lane / su.lanes, p = lane % su.lanes;  // the lane's block and part
  const int j0 = p * su.per_lane;                       // the lane's first slot
  const int units = (n_blocks + su.group - 1) / su.group;
  const int warps = gridDim.x * (blockDim.x >> 5);
  int u = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (u >= units) return;
  stage_span(len_tiles, lens, (size_t)u * su.group, min(su.group, n_blocks - u * su.group),
             n_slots, lane);
  copy_commit();
  for (int cur = 0;; cur ^= 1) {
    const size_t b0 = (size_t)u * su.group;
    const int nb = min(su.group, n_blocks - u * su.group);
    // the lane's slots in the tiles and in the tables
    const int t0 = (int)((b0 * n_slots) & 3) + i * n_slots + j0;
    const size_t g0 = (b0 + i) * n_slots + j0;
    const int n = i < nb ? max(0, min(su.per_lane, n_slots - j0)) : 0;
    const uint32_t* lt = len_tiles + cur * su.tile + t0;
    copy_wait<0>();  // this unit's lengths
    __syncwarp();
    // the mask of nonzero lengths and their sum; the values requested
    uint32_t mask = 0;
    int bits = 0;
#pragma unroll 8
    for (int j = 0; j < n; j++) {
      const int len = (int)lt[j];
      if (len > 0) {
        mask |= 1u << j;
        bits += len;
      }
    }
    // a dense unit's lo words as a whole span, 16 bytes a lane; hi only
    // where a length exceeds 32
    const bool dense = 4 * __reduce_add_sync(0xFFFFFFFFu, __popc(mask)) >= nb * n_slots;
    if (dense) stage_span(val_tiles, lo, b0, nb, n_slots, lane);
    for (uint32_t m = mask; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      if (!dense) copy_async4(val_tiles + t0 + j, lo + g0 + j);
      if (NV == 2 && (int)lt[j] > 32) copy_async4(val_tiles + su.tile + t0 + j, hi + g0 + j);
    }
    copy_commit();
    // the next unit's lengths into the other tile
    const int nu = u + warps;
    if (nu < units)
      stage_span(len_tiles + (cur ^ 1) * su.tile, lens, (size_t)nu * su.group,
                 min(su.group, n_blocks - nu * su.group), n_slots, lane);
    copy_commit();
    // each part's offset in its block: a scan over the block's lanes
    int incl = bits;
    for (int d = 1; d < su.lanes; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (p >= d) incl += t;
    }
    RowSink<true> sink(rows + i * kRowStride, kBlockWords, incl - bits);
    copy_wait<1>();  // this unit's values
    __syncwarp();    // a dense unit's span came from every lane
    for (; mask; mask &= mask - 1) {
      const int j = __ffs(mask) - 1;
      const int len = (int)lt[j];
      const uint32_t v = val_tiles[t0 + j];
      if (len > 32) {  // 33..64 bits: the high ones from hi (none in K8b)
        sink.put(NV == 2 ? val_tiles[su.tile + t0 + j] & (0xFFFFFFFFu >> (64 - len)) : 0u,
                 len - 32);
        sink.put(v, 32);
      } else {
        sink.put(v & (0xFFFFFFFFu >> (32 - len)), len);
      }
    }
    sink.finish();
    __syncwarp();
    // store the unit's rows, then their counts (a block's last lane)
    for (int ii = 0; ii < nb; ii++) {
      const int total = __shfl_sync(0xFFFFFFFFu, incl, ii * su.lanes + su.lanes - 1);
      store_row(buf + (b0 + ii) * kBlockWords, rows + ii * kRowStride, kBlockWords,
                min(kBlockWords, (total + 31) >> 5), lane);
    }
    if (p == su.lanes - 1 && i < nb) nbits[b0 + i] = incl;
    __syncwarp();
    if (nu >= units) break;
    u = nu;
  }
}

// K8a: merged slots, value = low `len` (<= 64) bits of (hi << 32) | lo
__global__ void __launch_bounds__(kWarpsPerCta * 32)
pack_slots64_kernel(const int32_t* __restrict__ lens, const uint32_t* __restrict__ his,
                    const uint32_t* __restrict__ los, uint32_t* __restrict__ buf,
                    int32_t* __restrict__ nbits, int n_blocks, int n_slots) {
  pack_slot_lanes<2>(lens, his, los, buf, nbits, n_blocks, n_slots);
}

// K8b: 32-bit slots, value = low `len` (<= 32) bits of vals
__global__ void __launch_bounds__(kWarpsPerCta * 32)
pack_slots32_kernel(const int32_t* __restrict__ lens, const uint32_t* __restrict__ vals,
                    uint32_t* __restrict__ buf, int32_t* __restrict__ nbits, int n_blocks,
                    int n_slots) {
  pack_slot_lanes<1>(lens, nullptr, vals, buf, nbits, n_blocks, n_slots);
}

// CTAs of `kernel` at `threads` threads and `smem` bytes that the card
// holds at once, worked out once per device and shape (the queries cost
// host time on every launch otherwise); a kernel that a shape takes past
// 48 KB is first allowed all a block may have.
cudaError_t resident_ctas(const void* kernel, int threads, size_t smem, int* ctas) {
  struct Shape {
    int dev;
    const void* kernel;
    int threads;
    size_t smem;
    int ctas;
  };
  static std::mutex mutex;
  static Shape known[64];
  static int n_known = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < n_known; i++) {
    const Shape& k = known[i];
    if (k.dev == dev && k.kernel == kernel && k.threads == threads && k.smem == smem) {
      *ctas = k.ctas;
      return cudaSuccess;
    }
  }
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) err = (cudaError_t)sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *ctas = (per_sm > 0 ? per_sm : 1) * sms;
  if (n_known < 64) known[n_known++] = Shape{dev, kernel, threads, smem, *ctas};
  return cudaSuccess;
}

// Launch shape of a kernel over `units` warp units, each warp taking
// `warp_words` words of shared memory beside `head_words` a CTA shares:
// kWarpsPerCta warps per CTA, fewer where they would not fit, and as many
// CTAs as the card holds at once (the warps walk the units grid-stride).
// cudaErrorInvalidValue where one warp does not fit.
cudaError_t warp_launch_shape(const void* kernel, int units, int head_words, int warp_words,
                              dim3* grid, dim3* block, size_t* smem) {
  const long long fit = (kSmemBytes / 4 - head_words) / warp_words;
  if (fit < 1) return cudaErrorInvalidValue;
  const int wpc = fit < kWarpsPerCta ? (int)fit : kWarpsPerCta;
  *block = dim3(wpc * 32);
  *smem = (size_t)(head_words + wpc * warp_words) * 4;
  int room = 0;
  const cudaError_t err = resident_ctas(kernel, wpc * 32, *smem, &room);
  if (err != cudaSuccess) return err;
  const long long need = ((long long)units + wpc - 1) / wpc;
  *grid = dim3((unsigned)(need < room ? need : room));
  return cudaSuccess;
}

cudaError_t launch_segments(const void* zz, const void* comp, void* segbuf, void* segbits,
                            int n_segs, int seg_g, int seg_words, cudaStream_t stream) {
  if (n_segs <= 0) return cudaSuccess;
  const int staged = staging_words(seg_g, seg_words);
  const int spw = segs_per_warp(seg_g);
  dim3 grid, block;
  size_t smem;
  cudaError_t err = warp_launch_shape((const void*)pack_segments_kernel, (n_segs + spw - 1) / spw,
                                      kTableWords, spw * row_stride(staged, spw) + kTileWords,
                                      &grid, &block, &smem);
  if (err != cudaSuccess) return err;
  pack_segments_kernel<<<grid, block, smem, stream>>>((const int32_t*)zz, (const int32_t*)comp,
                                                      (uint32_t*)segbuf, (int32_t*)segbits,
                                                      n_segs, seg_g, seg_words, staged);
  return cudaGetLastError();
}

cudaError_t launch_blocks(const void* zz, const void* comp, void* buf, void* nbits, int n_blocks,
                          cudaStream_t stream) {
  if (n_blocks <= 0) return cudaSuccess;
  dim3 grid, block;
  size_t smem;
  cudaError_t err = warp_launch_shape((const void*)pack_blocks_kernel, n_blocks, kTableWords,
                                      32 * row_stride(staging_words(1, kBlockWords), 32) +
                                          kTileWords,
                                      &grid, &block, &smem);
  if (err != cudaSuccess) return err;
  pack_blocks_kernel<<<grid, block, smem, stream>>>((const int32_t*)zz, (const int32_t*)comp,
                                                    (uint32_t*)buf, (int32_t*)nbits, n_blocks);
  return cudaGetLastError();
}

// K8a (nv 2: his and los) or K8b (nv 1: vals in los)
cudaError_t launch_slots(int nv, const void* lens, const void* his, const void* los, void* buf,
                         void* nbits, int n_blocks, int n_slots, cudaStream_t stream) {
  if (n_blocks <= 0) return cudaSuccess;
  if (n_slots < 1 || n_slots > kMaxSlots || ((uintptr_t)lens | (uintptr_t)los) % 16)
    return cudaErrorInvalidValue;
  const void* kernel = nv == 2 ? (const void*)pack_slots64_kernel : (const void*)pack_slots32_kernel;
  const SlotUnits su = slot_units(n_slots);
  dim3 grid, block;
  size_t smem;
  cudaError_t err = warp_launch_shape(kernel, (n_blocks + su.group - 1) / su.group, 0,
                                      slot_warp_words(su, nv), &grid, &block, &smem);
  if (err != cudaSuccess) return err;
  if (nv == 2)
    pack_slots64_kernel<<<grid, block, smem, stream>>>(
        (const int32_t*)lens, (const uint32_t*)his, (const uint32_t*)los, (uint32_t*)buf,
        (int32_t*)nbits, n_blocks, n_slots);
  else
    pack_slots32_kernel<<<grid, block, smem, stream>>>((const int32_t*)lens, (const uint32_t*)los,
                                                       (uint32_t*)buf, (int32_t*)nbits, n_blocks,
                                                       n_slots);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Upload the Huffman tables to the current device. Host pointers:
// dc (2, 16) and ac (2, 256) entries (length << 16) | code.
int flu_pack_init(const uint32_t* dc, const uint32_t* ac) {
  cudaError_t err = cudaMemcpyToSymbol(g_tables, dc, sizeof(uint32_t) * kDcWords);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_tables, ac, sizeof(uint32_t) * 2 * 256, sizeof(uint32_t) * kDcWords);
  return (int)err;
}

// zz: (n_segs * seg_g, 64) int32 DC-diffed MCU-ordered coefficients;
// comp: (n_segs * seg_g,) int32; segbuf: (n_segs, seg_words) uint32;
// segbits: (n_segs,) int32.
int flu_pack_segments(const void* zz, const void* comp, void* segbuf, void* segbits,
                      int n_segs, int seg_g, int seg_words, void* stream) {
  return (int)launch_segments(zz, comp, segbuf, segbits, n_segs, seg_g, seg_words,
                              (cudaStream_t)stream);
}

// zz: (n_blocks, 64) int32 DC-diffed MCU-ordered coefficients; comp:
// (n_blocks,) int32 (0 luma, 1 chroma); buf: (n_blocks, 64) uint32;
// nbits: (n_blocks,) int32.
int flu_pack_blocks(const void* zz, const void* comp, void* buf, void* nbits, int n_blocks,
                    void* stream) {
  return (int)launch_blocks(zz, comp, buf, nbits, n_blocks, (cudaStream_t)stream);
}

// lens, his, los: (n_blocks, n_slots) int32 (his/los uint32 bit patterns);
// buf: (n_blocks, 64) uint32; nbits: (n_blocks,) int32.
int flu_pack_slots64(const void* lens, const void* his, const void* los, void* buf,
                     void* nbits, int n_blocks, int n_slots, void* stream) {
  return (int)launch_slots(2, lens, his, los, buf, nbits, n_blocks, n_slots,
                           (cudaStream_t)stream);
}

// lens, vals: (n_blocks, n_slots) int32; buf: (n_blocks, 64) uint32;
// nbits: (n_blocks,) int32.
int flu_pack_slots32(const void* lens, const void* vals, void* buf, void* nbits,
                     int n_blocks, int n_slots, void* stream) {
  return (int)launch_slots(1, lens, nullptr, vals, buf, nbits, n_blocks, n_slots,
                           (cudaStream_t)stream);
}

}  // extern "C"
