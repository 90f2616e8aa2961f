// Baseline-JPEG Huffman packs of MCU-ordered blocks, for Hopper: per
// segment (K2) and per block (K7, K8a, K8b).
//
// K2 replaces flutpu/codec/ops/entropy_pallas.py:pack_segments_fused (the
// Pallas TPU kernel `_fused_seg_kernel`). The TPU kernel ran every segment
// of a 512-lane tile in lockstep and placed each symbol with 96-bit
// one-hot word selects over the whole staging column, because a TPU lane
// cannot index memory. Here each thread owns one segment and walks its
// seg_g blocks sequentially with a 64-bit accumulator, storing each 32-bit
// word once when it fills.
//
// What bounds it on the H100: the serial bit dependency inside a segment
// and the reads of the coefficients (seg_g * 256 bytes per segment, about
// 200 MB for a 16-frame 1080p GOP). A 1080p GOP has 48,960 segments, so
// one thread per segment fills only a fraction of the card's thread slots;
// the design keeps the per-coefficient work to one compare for zeros,
// reads 16 bytes per load, and keeps the Huffman tables in constant
// memory. A coalesced output layout or several threads per segment is
// later work.
//
// Contract (bit-identical to the TPU kernel and to the plain PyTorch
// version, ops/entropy_kernels.py:pack_segments_plain):
//   - DC: size category (capped at 12) code, then `size` extra bits;
//   - AC: one ZRL per 16 zeros before a nonzero coefficient, then the
//     (run, size) code and `size` extra bits; EOB only when the last
//     nonzero coefficient is below position 63;
//   - comp == 1 selects the chroma tables, comp == 0 luma, comp < 0 marks
//     a padding block that emits nothing;
//   - segbits counts every bit, also past seg_words * 32, but no word past
//     the buffer is written (the encoder redispatches at the reported
//     size); every word of the buffer is written, unused ones as 0.
//
// K7 (`pack_blocks_kernel`) replaces entropy_pallas.py:pack_block_bits_fused
// (`_fused_kernel`), the non-segment layout's pack: K2's per-segment body
// run at seg_g = 1 and seg_words = 64 is that function (one block per
// thread, its own 64-word buffer, every word written, EOB rule as above),
// so K7 shares K2's source under a kernel name of its own. What bounds it: 520 bytes per block (its 64 coefficients, its
// comp flag, its 64 words and its count), 407 MB per 16-frame 1080p GOP.
//
// K8a (`pack_slots64_kernel`) replaces pack_block_bits_pallas64
// (`_pack_kernel64`) and K8b (`pack_slots32_kernel`) pack_block_bits_pallas
// (`_pack_kernel`): the placement of precomputed slot tables, merged slots
// of up to 59 bits (hi:lo pairs, 65 per block) or 32-bit slots (191 per
// block). The TPU kernels ran 1024 blocks in lockstep and placed each slot
// with one-hot selects over a (64, 1024) word column, bounding each tile's
// loop by its last active slot. Here one thread walks one block's slot
// row and appends each active slot's bits through the same BitSink as K2;
// it reads every length but a slot's value only where the length is not
// 0, so its bytes follow the data (what the bound in chip_smoke counts:
// the slots up to each block's last active one). The tables arrive (B, S)
// row-major, so a warp reads 32 rows S words apart: each load touches 32
// sectors and the L1 serves the following iterations from them. A
// transposed table or a warp per block (coalesced reads) is later work.
// Every word of the 64-word buffer is written and bits past nbits are 0:
// the block concat reads the word after the containing one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// (length << 16) | code, indexed [chroma][size] and [chroma][run<<4|size]
__constant__ uint32_t c_dc[2][16];
__constant__ uint32_t c_ac[2][256];

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

// K2
__global__ void __launch_bounds__(64)
pack_segments_kernel(const int32_t* __restrict__ zz, const int32_t* __restrict__ comp,
                     uint32_t* __restrict__ segbuf, int32_t* __restrict__ segbits,
                     int n_segs, int seg_g, int seg_words) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < n_segs) pack_segment(zz, comp, segbuf, segbits, s, seg_g, seg_words);
}

constexpr int kBlockWords = 64;

// K7: K2's body at one block per segment, under a name of its own so a
// trace tells the two layouts apart
__global__ void __launch_bounds__(64)
pack_blocks_kernel(const int32_t* __restrict__ zz, const int32_t* __restrict__ comp,
                   uint32_t* __restrict__ buf, int32_t* __restrict__ nbits, int n_blocks) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < n_blocks) pack_segment(zz, comp, buf, nbits, b, 1, kBlockWords);
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
  return (int)err;
}

// zz: (n_segs * seg_g, 64) int32 DC-diffed MCU-ordered coefficients;
// comp: (n_segs * seg_g,) int32; segbuf: (n_segs, seg_words) uint32;
// segbits: (n_segs,) int32.
int flu_pack_segments(const void* zz, const void* comp, void* segbuf, void* segbits,
                      int n_segs, int seg_g, int seg_words, void* stream) {
  const int threads = 64;
  const int blocks = (n_segs + threads - 1) / threads;
  if (blocks > 0)
    pack_segments_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)zz, (const int32_t*)comp, (uint32_t*)segbuf, (int32_t*)segbits,
        n_segs, seg_g, seg_words);
  return (int)cudaGetLastError();
}

// zz: (n_blocks, 64) int32 DC-diffed MCU-ordered coefficients; comp:
// (n_blocks,) int32 (0 luma, 1 chroma); buf: (n_blocks, 64) uint32;
// nbits: (n_blocks,) int32.
int flu_pack_blocks(const void* zz, const void* comp, void* buf, void* nbits, int n_blocks,
                    void* stream) {
  const int threads = 64;
  const int blocks = (n_blocks + threads - 1) / threads;
  if (blocks > 0)
    pack_blocks_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
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
