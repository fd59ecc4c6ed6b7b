// The syncmer extraction chain around the selection kernel on NVIDIA Hopper
// (sm_90a), CUDA C++: the decode of 2-bit packed reads in front of it (K3d)
// and the ordered compaction with the per-selected details behind it (K4).
//
// Counterparts in the JAX package, where both are parts of one XLA program
// per chunk (oatk_tpu/kernels/syncmer.py:extract_hoco_fused_pallas):
//   K3d  the blob split (:598-605) and _extract_hoco_packed_impl's unpack,
//        read-end mask and N mark (:534-577), less the selection kernel;
//   K4   _selected_details (:419): compaction in ascending flat order, the
//        boundary s-mer payload, the window's 2-bit pack, its reverse
//        complement and MurmurHash64A, into the packed result of :462-470;
//        on the key route also the device count's per-chunk key decode
//        (oatk_tpu/index/devcount.py:67 keys_jit, :114 write_jit).
// What the JAX program does only to run well on the TPU is not carried over:
// the MXU one-hot N mask (a scatter here), the sort-funnel compaction with
// its inflated overflow report (an exact scan here), the aligned-block window
// gather and the packed-byte funnel shift of the reverse complement (the
// kernel reads each window's codes and builds both strands from them).
//
// K3d, a row gather, two launches (the N scatter must follow the decode).
// Its input is a stream of 2-bit codes (base 4j in bits 7-6 of byte j of a
// row), a row table (each row's first byte in the stream, or none: row r at
// r*Lp/4, the padded blob of the packed route) and its hoco lengths hl, and
// up to kBuckets buckets (first row, rows B, padded length Lp, byte offset
// of its output, a multiple of 16).  Bucket j's output is K1's input,
// codes_padded uint8 [B, Wd], Wd = 1 + Lp + w + 2, at out + out_off[j]: the
// loader's unit of parse segments, one output per length bucket.
//   blob_decode_kernel     column 0 and every column from 1 + hl on hold 5,
//                          column 1 + p < 1 + hl the 2-bit base p.  Block
//                          (x, y, z): bucket z, rows y, y + gridDim.y, ...;
//                          one thread per 16-byte chunk of the bucket's
//                          output that starts in the row.  A thread tests
//                          for a row end once per chunk and splits the
//                          chunk where it crosses one; per row segment it
//                          reads the row's start and hl once and takes its
//                          (at most 16) bases from two aligned 32-bit loads
//                          of the stream, byte-swapped into one 64-bit
//                          stream and shifted into place; four bytes of
//                          codes come out of one packed byte by a
//                          shift-or-mask, and byte masks pick 5 where a
//                          column holds no base.  One 16-byte store;
//   blob_n_scatter_kernel  every N entry sets its column to 4: on the packed
//                          route an i32 v = b*Lp + p (row v/Lp, the
//                          sentinel B*Lp dropped), on the stream route an
//                          i64 r<<32 | p of row r of the table (an entry
//                          whose row is in no bucket of the launch, or with
//                          p >= Lp, is dropped).
// The two word loads take the 4-aligned words that hold a row's bases: the
// caller keeps 8 bytes of the buffer past each row's last packed byte (the
// padded blob's int32 fields; the loader's stream rows start 16-aligned and
// every segment's stream ends in 16 spare bytes).
//
// K4, one launch, no host read:
//   sel_tiles_kernel       a single-pass compaction by decoupled look-back,
//                          with the per-selected details in the same block.
//                          A block takes its tile from an atomic ticket
//                          counter, so the tiles it waits on are already
//                          running.  Tiles never straddle a row: a row of
//                          L codes is ceil(L / kTile) tiles, the last one
//                          short.  The block reads its tile of sel once,
//                          four codes a lane with 16-byte loads, 8 rounds a
//                          warp, and ranks the nonzeros in ascending order
//                          by a warp scan of the lanes' counts per round; a
//                          lane keeps one word per round.  The block
//                          publishes the tile's aggregate in a status word,
//                          and writes its selections into shared memory (16
//                          bits each).  Warp 0 then looks back over the
//                          status words of the tiles before it, 32 at a
//                          time, until an inclusive prefix and the row's
//                          first tile are behind it, and publishes the
//                          inclusive prefix.  The look-back yields two
//                          prefixes: all selections before the tile (the
//                          result lane j of each selection) and those of
//                          the same row (its rank idx within the read), so
//                          every selection knows j, its row b, its column p
//                          and idx with no division and no search.
//                          Meanwhile the other warps take the tile's first
//                          kEarly windows, one a warp, into shared memory;
//                          once the prefix is known the block writes them
//                          and takes the rest.  Per window: lanes j < s
//                          read the boundary s-mer's codes and OR-reduce
//                          its forward and reverse-complement codes
//                          (payload min(fwd, rev)<<1 | z, ^1 for a close;
//                          z = fwd > rev); lane i packs Murmur block i of
//                          the oriented window (32 bases, 8 bytes,
//                          little-endian, zero past the window), of the
//                          reverse complement when z by reading the window
//                          from its other end; each lane mixes its block,
//                          and the h chain runs over the lanes in order;
//                          for more than 32 blocks the warp loops in
//                          strides of 32.  The grid holds a few tail blocks
//                          beyond the tiles: they wait until every tile has
//                          published, each reads the exact n_sel from the
//                          last tile's status word, writes its share of the
//                          lanes from min(n_sel, max_out) to max_out, and
//                          zeroes its share of the other status words; the
//                          last tail block to finish zeroes the last tile's
//                          word and the counters for the next call (no
//                          memset per call).  A tail block may start after
//                          the others have finished, so that word outlives
//                          every tail block's read of it.
// Two outputs: the packed int64 [3, max_out+1] (rows flat<<1|z, payload,
// hash; slot [0, max_out] the exact n_sel; lanes from min(n_sel, max_out) on
// zero), or the device count's five key lanes of max_out entries: hash, low
// = sid<<32 | idx<<1 | z, smer = payload, m32 = p<<1 | z, invalid = 0; lanes
// j >= n = min(n_sel, max_out) hold 0, sids[0]<<32 | (j-n)<<1, 0, 0, 1, and
// the exact n_sel goes to its own slot.
// A window's codes come straight from codes_padded (column 1 + p on, & 3):
// the selection kernel selects only windows whose w codes are all below 4.
//
// Bound: bytes.  K3d reads the packed rows and writes codes_padded; K4 reads sel
// once, the selected windows, and writes 24 B (packed) or 36 B (keys) per
// lane.  The per-window work is a few dozen 32-bit instructions per 32
// bases.  What the designs do about it: K3d makes two word loads per 16
// output bytes; K4 reads sel once, 128 B a lane in flight, in tiles of
// 8,192 codes (4,096 tiles at the bench chunk, 2048 x 16384), its first
// windows' details overlap its look-back, and its registers are capped for
// kTileBlocks blocks per SM.  What keeps it above its bound is latency on
// each block's path (the ticket, the look-back and the windows' dependent
// loads) with too few bytes in flight per SM; larger tiles, a wider
// look-back and a dedicated look-back warp measured no faster (PERF.md).
//
// Entry points: syncmer_decode_launch(), syncmer_details_launch() and
// syncmer_details_tiles(), a plain C interface bound with ctypes.  The
// launches run on the stream they are given, allocate nothing, synchronise
// nothing, and return cudaGetLastError().  The details' status words and
// counters are the caller's: zero before the first call on a stream, and
// left zero by every call that runs to its end.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDecodeBytes = 16;               // output bytes per decode thread
constexpr int kBuckets = 32;                   // K3d's buckets a launch, at most
constexpr int kRounds = 8;                     // rounds of 4 codes a lane per warp
constexpr int kWarpSpan = 32 * 4 * kRounds;    // sel entries per warp: 1024
constexpr int kTileWarps = kThreads / 32;
constexpr int kTile = kTileWarps * kWarpSpan;  // sel entries per tile: 8192
constexpr int kEarly = 64;                     // a tile's windows done during its look-back, at most
constexpr int kTileBlocks = 4;                 // tiles' blocks per SM the registers allow
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kM = 0xC6A4A7935BD1E995ull; // MurmurHash64A's multiplier
constexpr uint64_t kSeed = 1234;               // kernels/hashes.py:MURMUR_SEED
// a tile's status word: flag (bits 63-62: 0 none yet, 1 aggregate, 2
// inclusive prefix), its selections (bits 61-47, at most kTile) and its
// inclusive prefix (bits 46-0)
constexpr int kAggShift = 47;
constexpr uint64_t kAggMask = (1ull << (62 - kAggShift)) - 1;
constexpr uint64_t kInclMask = (1ull << kAggShift) - 1;
constexpr uint64_t kFlagAgg = 1ull << 62;
constexpr uint64_t kFlagIncl = 2ull << 62;

// the four 2-bit codes of a packed byte (the first in bits 7-6) as four
// bytes, the first in byte 0
__device__ __forceinline__ uint32_t spread4(uint32_t bb) {
  return ((bb >> 6) | (bb << 4) | (bb << 14) | (bb << 24)) & 0x03030303u;
}

// 0xFF in byte i for each bit i of a nibble
__device__ __forceinline__ uint32_t byte_mask(uint32_t nib) {
  return ((nib * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// Bytes t0 <= t < t1 of a 16-byte output chunk are columns c0 + t - t0 of
// a row whose packed bases start at byte at0 of src and whose first h
// bases are read: column 0 and the columns past them hold 5, column 1 + p
// base p.  The bases come from the two aligned words that hold the first
// of them (16 bases span at most 5 packed bytes).
__device__ __forceinline__ void decode_segment(const uint8_t* __restrict__ src, long long at0,
                                               int h, int c0, int t0, int t1, uint32_t word[4]) {
  const int p0 = c0 - 1 - t0;  // output byte t holds base p0 + t
  const int lo = max(t0, -p0), hi = min(t1, h - p0);
  uint32_t z = 0;  // the base of output byte t in bits 31-2t .. 30-2t
  if (lo < hi) {
    const long long at = at0 + ((p0 + lo) >> 2);
    const long long a0 = at & ~3LL;  // the caller keeps 8 bytes past a row's last packed byte
    const uint32_t w0 = __ldg(reinterpret_cast<const uint32_t*>(src + a0));
    const uint32_t w1 = __ldg(reinterpret_cast<const uint32_t*>(src + a0 + 4));
    // 32 bases in order from bit 63 down
    const uint64_t x = (static_cast<uint64_t>(__byte_perm(w0, 0, 0x0123)) << 32) |
                       __byte_perm(w1, 0, 0x0123);
    const int u0 = 4 * static_cast<int>(at - a0) + ((p0 + lo) & 3);  // x's base for byte lo
    z = static_cast<uint32_t>(((x << (2 * u0)) >> (2 * lo)) >> 32);
  }
  const uint32_t seg = ((1u << t1) - 1u) & ~((1u << t0) - 1u);
  const uint32_t bas = lo < hi ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
#pragma unroll  // constant indices keep word[] in registers
  for (int k = 0; k < 4; ++k) {
    const uint32_t codes = spread4((z >> (24 - 8 * k)) & 0xFFu);
    const uint32_t mb = byte_mask((bas >> (4 * k)) & 0xFu);
    const uint32_t ms = byte_mask((seg >> (4 * k)) & 0xFu);
    word[k] = (word[k] & ~ms) | (ms & ((codes & mb) | (0x05050505u & ~mb)));
  }
}

// A launch's buckets, by value: bucket j is rows row0[j] .. row0[j] +
// rows[j] - 1 of the row table, padded to Lp[j] columns, its output at
// out + out_off[j]
struct Buckets {
  int n;
  int Lp[kBuckets];
  long long row0[kBuckets], rows[kBuckets], out_off[kBuckets];
};

__global__ void __launch_bounds__(kThreads)
blob_decode_kernel(const uint8_t* __restrict__ src, const long long* __restrict__ row_off,
                   const int32_t* __restrict__ hl, Buckets bk, uint8_t* __restrict__ out, int w) {
  // bucket z's output, flat over [B, Wd], in 16-byte chunks at multiples
  // of 16 (its offset is 16-aligned): row b0 (blockIdx.y on) writes the
  // chunks that start in it, one per thread, one 16-byte store each; a
  // chunk's bytes may run into the next rows of the bucket
  const int j = blockIdx.z;
  const long long B = bk.rows[j], row0 = bk.row0[j];
  const int Lp = bk.Lp[j], Wd = 1 + Lp + w + 2;
  uint8_t* o = out + bk.out_off[j];
  const long long total = B * Wd;
  const long long row_bytes = Lp / 4;  // the packed route's rows
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long b0 = blockIdx.y; b0 < B; b0 += gridDim.y) {
    const long long r0 = b0 * Wd;
    const long long f0 = ((r0 + kDecodeBytes - 1) & ~static_cast<long long>(kDecodeBytes - 1)) +
                         kDecodeBytes * k;
    if (f0 >= r0 + Wd) continue;  // no chunk of this row left for the thread
    const int nb = total - f0 < kDecodeBytes ? static_cast<int>(total - f0) : kDecodeBytes;
    uint32_t word[kDecodeBytes / 4] = {};
    long long b = b0;
    int c = static_cast<int>(f0 - r0);
    for (int t = 0; t < nb; ++b, c = 0) {  // one segment per row the chunk touches
      const int len = min(nb - t, Wd - c);
      const long long r = row0 + b;
      const long long at0 = row_off ? __ldg(row_off + r) : r * row_bytes;
      decode_segment(src, at0, min(__ldg(hl + r), Lp), c, t, t + len, word);
      t += len;
    }
    if (nb == kDecodeBytes) {
      *reinterpret_cast<uint4*>(o + f0) = make_uint4(word[0], word[1], word[2], word[3]);
    } else {
#pragma unroll
      for (int t = 0; t < kDecodeBytes; ++t)
        if (t < nb) o[f0 + t] = static_cast<uint8_t>(word[t >> 2] >> (8 * (t & 3)));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
blob_n_scatter_kernel(const int32_t* __restrict__ n32, const long long* __restrict__ n64,
                      int n_cap, Buckets bk, uint8_t* __restrict__ out, int w) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_cap) return;
  long long r, p;
  if (n32) {  // the packed route: one bucket, v = b*Lp + p
    const long long v = __ldg(n32 + i);
    if (v < 0) return;
    r = v / bk.Lp[0];
    p = v - r * bk.Lp[0];
  } else {
    const long long v = __ldg(n64 + i);
    if (v < 0) return;
    r = v >> 32;
    p = v & 0xFFFFFFFFLL;
  }
  for (int j = 0; j < bk.n; ++j) {
    const long long b = r - bk.row0[j];
    if (b >= 0 && b < bk.rows[j]) {
      if (p < bk.Lp[j]) out[bk.out_off[j] + b * (1 + bk.Lp[j] + w + 2) + 1 + p] = 4;
      return;
    }
  }  // the sentinel, or a row of another launch's buckets
}

// The 32 codes at window offsets lo .. lo+31 as eight little-endian words
// (offset lo + 4j + t in byte t of word j).  Only aligned words that
// overlap the window [0, w) are loaded (an aligned word that holds a byte
// of the tensor lies inside its allocation); the others read as 0, and
// bytes outside the window are masked by the caller.
__device__ __forceinline__ void load_codes32(const uint8_t* win, int w, int lo, uint32_t x[8]) {
  const uintptr_t begin = reinterpret_cast<uintptr_t>(win);
  const uintptr_t end = begin + static_cast<uintptr_t>(w);
  const uintptr_t at = begin + lo;  // lo may be negative: wraps, as intended
  const uintptr_t a0 = at & ~uintptr_t(3);
  const int sh = static_cast<int>(at & 3) * 8;
  uint32_t wd[9];
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    const uintptr_t a = a0 + 4 * m;
    wd[m] = (a + 4 > begin && a < end) ? __ldg(reinterpret_cast<const uint32_t*>(a)) : 0u;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = __funnelshift_r(wd[j], wd[j + 1], sh);
}

// The bits of a Murmur block that hold its first nv bases (nv in 0..32):
// base u sits in byte u/4 at bits 6 - 2(u%4) .. 7 - 2(u%4).
__device__ __forceinline__ uint64_t valid_mask(int nv) {
  if (nv >= 32) return ~0ull;
  if (nv <= 0) return 0ull;
  const int full = nv >> 2, part = nv & 3;
  uint64_t m = full ? (~0ull >> (64 - 8 * full)) : 0ull;
  if (part) m |= static_cast<uint64_t>((0xFFu << (8 - 2 * part)) & 0xFFu) << (8 * full);
  return m;
}

// Murmur block i of the window: bases 32i .. 32i+31 (forward) or of its
// reverse complement, whose base t is 3 - code[w-1-t].
__device__ __forceinline__ uint64_t window_block(const uint8_t* win, int w, int i, bool rc) {
  uint32_t x[8];
  uint64_t blk = 0;
  if (!rc) {
    load_codes32(win, w, 32 * i, x);
#pragma unroll
    for (int j = 0; j < 8; ++j)  // byte j = c0<<6 | c1<<4 | c2<<2 | c3
      blk |= static_cast<uint64_t>(((x[j] & 0x03030303u) * 0x40100401u) >> 24) << (8 * j);
  } else {
    // rc bases 32i .. 32i+31 are the forward offsets w-1-32i down to
    // w-32-32i: byte j of the block is word 7-j of those 32 codes in
    // reverse order, complemented
    load_codes32(win, w, w - 32 * (i + 1), x);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t b = (((x[7 - j] & 0x03030303u) * 0x01041040u) >> 24) ^ 0xFFu;
      blk |= static_cast<uint64_t>(b & 0xFFu) << (8 * j);
    }
  }
  return blk & valid_mask(w - 32 * i);
}

__device__ __forceinline__ uint64_t warp_or(uint64_t v) {
  for (int d = 16; d > 0; d >>= 1) v |= __shfl_xor_sync(kFull, v, d);
  return v;
}


// The boundary s-mer payload, the strand z and MurmurHash64A of the oriented
// window at win (w codes, selection code oc: 1 open, 2 close); every lane of
// the warp takes part, and each gets the results.
__device__ __forceinline__ void window_details(const uint8_t* win, int w, int s, int oc, bool& z,
                                               uint64_t& payload, uint64_t& h) {
  const int lane = threadIdx.x & 31;
  const int q = w - s + 1;
  const int n_bytes = (w - 1) / 4 + 1;
  const int n_full = n_bytes >> 3;
  const int nblk = (n_bytes + 7) >> 3;

  // the boundary s-mer: forward and reverse-complement codes, lane j
  // contributing base j
  uint64_t f = 0, r = 0;
  if (lane < s) {
    const uint64_t c = __ldg(win + (oc == 1 ? 0 : q - 1) + lane) & 3;
    f = c << (2 * (s - 1 - lane));
    r = (3 - c) << (2 * lane);
  }
  f = warp_or(f);
  r = warp_or(r);
  z = f > r;
  payload = ((z ? r : f) << 1) | (z ? 1 : 0);
  if (oc == 2) payload ^= 1;

  // MurmurHash64A over the oriented window
  h = kSeed ^ (static_cast<uint64_t>(n_bytes) * kM);
  for (int g = 0; g < nblk; g += 32) {
    const int blk = g + lane;
    const uint64_t v = blk < nblk ? window_block(win, w, blk, z) : 0;
    uint64_t k = v * kM;
    k ^= k >> 47;
    k *= kM;
    const int cnt = nblk - g < 32 ? nblk - g : 32;
    for (int j = 0; j < cnt; ++j) {
      const uint64_t kj = __shfl_sync(kFull, k, j);
      const uint64_t vj = __shfl_sync(kFull, v, j);
      h = (h ^ (g + j < n_full ? kj : vj)) * kM;  // the tail block is not mixed
    }
  }
  h ^= h >> 47;
  h *= kM;
  h ^= h >> 47;
}

// Where K4 writes: the packed result, or the device count's key lanes.
struct Out {
  long long* packed;            // [3, max_out+1]; null on the key route
  long long *bh, *bl, *bs, *bm; // the key route's lanes at the chunk's offset
  int32_t* bv;
  long long* n_sel;             // the key route's exact n_sel
  const long long* sids;        // the key route's read id of each row
  long long n_sids;
  long long max_out;
};

__device__ __forceinline__ void put_selected(const Out& o, long long j, long long b, int p, int L,
                                             long long idx, bool z, uint64_t payload, uint64_t h) {
  if (o.packed) {
    const long long row1 = o.max_out + 1;
    o.packed[j] = ((b * L + p) << 1) | (z ? 1 : 0);
    o.packed[row1 + j] = static_cast<long long>(payload);
    o.packed[2 * row1 + j] = static_cast<long long>(h);
  } else {
    const uint64_t sid = static_cast<uint64_t>(o.sids[b < o.n_sids ? b : o.n_sids - 1]);
    o.bh[j] = static_cast<long long>(h);
    o.bl[j] = static_cast<long long>((sid << 32) | (static_cast<uint64_t>(idx) << 1) | (z ? 1 : 0));
    o.bs[j] = static_cast<long long>(payload);
    o.bm[j] = (static_cast<long long>(p) << 1) | (z ? 1 : 0);
    o.bv[j] = 0;
  }
}

// lane j >= n_eff: zero, or an invalid key lane as the plain decode gives it
__device__ __forceinline__ void put_tail(const Out& o, long long j, long long n_eff) {
  if (o.packed) {
    const long long row1 = o.max_out + 1;
    o.packed[j] = 0;
    o.packed[row1 + j] = 0;
    o.packed[2 * row1 + j] = 0;
  } else {
    o.bh[j] = 0;
    o.bl[j] = static_cast<long long>((static_cast<uint64_t>(o.sids[0]) << 32) |
                                     (static_cast<uint64_t>(j - n_eff) << 1));
    o.bs[j] = 0;
    o.bm[j] = 0;
    o.bv[j] = 1;
  }
}

__device__ __forceinline__ void put_count(const Out& o, long long n_sel) {
  if (o.packed) {
    const long long row1 = o.max_out + 1;
    o.packed[o.max_out] = n_sel;
    o.packed[row1 + o.max_out] = 0;
    o.packed[2 * row1 + o.max_out] = 0;
  } else {
    *o.n_sel = n_sel;
  }
}

__device__ __forceinline__ uint64_t ld_status(const uint64_t* p) {
  return *reinterpret_cast<const volatile uint64_t*>(p);
}

__device__ __forceinline__ void st_status(uint64_t* p, uint64_t v) {
  *reinterpret_cast<volatile uint64_t*>(p) = v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// Warp 0 of tile t: the selections of all tiles before t (g) and of those
// from row_first on (r, the tiles of t's row before it), from their status
// words, 32 tiles at a time, nearest first.  g stops at the nearest
// inclusive prefix; r needs every tile of the row, so the walk goes on
// until both are complete.  Before tile 0 stands an inclusive prefix of 0.
__device__ void look_back(const uint64_t* status, long long t, long long row_first,
                          long long& g, long long& r) {
  const int lane = threadIdx.x & 31;
  g = 0;
  r = 0;
  bool done = false;
  for (long long hi = t - 1; !done || hi >= row_first; hi -= 32) {
    const long long j = hi - lane;
    const bool need = j >= 0 && (!done || j >= row_first);
    uint64_t wd;
    do {
      wd = need ? ld_status(status + j) : kFlagIncl;
    } while (__any_sync(kFull, (wd >> 62) == 0));
    const long long agg = static_cast<long long>((wd >> kAggShift) & kAggMask);
    if (!done) {
      const unsigned incl = __ballot_sync(kFull, (wd >> 62) == 2);
      const int f = incl ? __ffs(incl) - 1 : 32;  // the nearest inclusive prefix
      g += warp_sum(lane < f ? agg : (lane == f ? static_cast<long long>(wd & kInclMask) : 0));
      done = incl != 0;
    }
    r += warp_sum(j >= row_first ? agg : 0);
  }
}

// A tail block of the one-launch K4 (z of Z): once every tile has published
// its inclusive prefix (then no tile reads a status word any more), the
// exact n_sel from the last tile's word, the lanes past min(n_sel, max_out),
// and the other status words zeroed.  The last tail block to finish zeroes
// the last tile's word and the counters: every tail block has read that word
// and every block has taken its ticket by then.  Were the word zeroed with
// the others, a tail block that starts late would read an n_sel of 0 and
// mark its share of the selected lanes invalid.
__device__ void tail_block(long long z, long long Z, long long n_tiles, uint64_t* status,
                           unsigned* ctr, const Out& o) {
  __shared__ long long s_n;
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<volatile unsigned*>(ctr + 1) < static_cast<unsigned>(n_tiles))
      __nanosleep(128);
    s_n = n_tiles ? static_cast<long long>(ld_status(status + n_tiles - 1) & kInclMask) : 0;
  }
  __syncthreads();
  const long long n_sel = s_n;
  const long long n_eff = n_sel < o.max_out ? n_sel : o.max_out;
  if (z == 0 && threadIdx.x == 0) put_count(o, n_sel);
  const long long gt = z * kThreads + threadIdx.x, nt = Z * kThreads;
  for (long long j = n_eff + gt; j < o.max_out; j += nt) put_tail(o, j, n_eff);
  for (long long i = gt; i < n_tiles - 1; i += nt) status[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctr + 2, 1u) == static_cast<unsigned>(Z - 1)) {
      if (n_tiles) status[n_tiles - 1] = 0;
      ctr[0] = 0;
      ctr[1] = 0;
      ctr[2] = 0;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kTileBlocks)
sel_tiles_kernel(const int32_t* __restrict__ sel, const uint8_t* __restrict__ codes, int L,
                 int Wd, int w, int s, int tiles_per_row, long long n_tiles, uint64_t* status,
                 unsigned* ctr, Out o) {
  __shared__ unsigned s_ticket;
  __shared__ int s_wcnt[kTileWarps];
  __shared__ long long s_g, s_r;
  __shared__ uint16_t s_list[kTile];  // the tile's selections: column in the tile << 2 | code
  __shared__ uint64_t s_pay[kEarly], s_hash[kEarly];
  __shared__ bool s_z[kEarly];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ctr, 1u);
  __syncthreads();
  const long long t = s_ticket;
  if (t >= n_tiles) {
    tail_block(t - n_tiles, gridDim.x - n_tiles, n_tiles, status, ctr, o);
    return;
  }
  const long long b = t / tiles_per_row;  // once per block
  const long long row_first = b * tiles_per_row;
  const int p_lo = static_cast<int>(t - row_first) * kTile;
  const int p_hi = min(L - p_lo, kTile);  // the tile's codes, from p_lo on
  const int32_t* row = sel + b * L + p_lo;
  // warp wid owns the tile's codes pw + 128 r + c, in that order; per
  // round a lane keeps one word: its nonzero codes (bits 0-3), their
  // values (bits 4-11) and the warp's inclusive count up to it (12-19)
  const int pw = wid * kWarpSpan + 4 * lane;
  uint32_t pk[kRounds];
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int p = pw + 128 * r;
    int4 v = make_int4(0, 0, 0, 0);
    if (kVec) {
      if (p < p_hi) v = __ldg(reinterpret_cast<const int4*>(row + p));  // L % 4 == 0
    } else {
      if (p < p_hi) v.x = __ldg(row + p);
      if (p + 1 < p_hi) v.y = __ldg(row + p + 1);
      if (p + 2 < p_hi) v.z = __ldg(row + p + 2);
      if (p + 3 < p_hi) v.w = __ldg(row + p + 3);
    }
    const uint32_t m = (v.x != 0) | (v.y != 0) << 1 | (v.z != 0) << 2 | (v.w != 0) << 3;
    int incl = __popc(m);
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    pk[r] = m | (v.x & 3) << 4 | (v.y & 3) << 6 | (v.z & 3) << 8 | (v.w & 3) << 10 |
            static_cast<uint32_t>(incl) << 12;
    cnt += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) s_wcnt[wid] = cnt;
  __syncthreads();
  int at = 0, agg = 0;  // at: the tile-local rank of the warp's first selection
  for (int k = 0; k < kTileWarps; ++k) {
    at += k < wid ? s_wcnt[k] : 0;
    agg += s_wcnt[k];
  }
  if (threadIdx.x == 0 && t > 0)
    st_status(status + t, kFlagAgg | (static_cast<uint64_t>(agg) << kAggShift));
  // the selections into shared memory, in order
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t m = pk[r] & 15u;
    const int incl = static_cast<int>(pk[r] >> 12);
    int k = at + incl - __popc(m);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if ((m >> c) & 1u)
        s_list[k++] = static_cast<uint16_t>(((pw + 128 * r + c) << 2) | ((pk[r] >> (4 + 2 * c)) & 3u));
    at += __shfl_sync(kFull, incl, 31);
  }
  __syncthreads();
  const int n_early = agg < kEarly ? agg : kEarly;
  const uint8_t* crow = codes + b * Wd + 1 + p_lo;
  if (wid == 0) {  // the prefixes
    long long g = 0, r = 0;
    if (t > 0) look_back(status, t, row_first, g, r);
    if (lane == 0) {
      st_status(status + t, kFlagIncl | (static_cast<uint64_t>(agg) << kAggShift) |
                                static_cast<uint64_t>(g + agg));
      __threadfence();
      atomicAdd(ctr + 1, 1u);
      s_g = g;
      s_r = r;
    }
  } else {  // meanwhile the other warps take the first windows
    for (int k = wid - 1; k < n_early; k += kTileWarps - 1) {
      const uint32_t e = s_list[k];
      bool z;
      uint64_t payload, h;
      window_details(crow + (e >> 2), w, s, static_cast<int>(e & 3u), z, payload, h);
      if (lane == 0) {
        s_pay[k] = payload;
        s_hash[k] = h;
        s_z[k] = z;
      }
    }
  }
  __syncthreads();
  // the results at their lanes, once the prefix is known; the rest of
  // the windows one a warp
  const long long g = s_g, ridx = s_r;
  const long long room = o.max_out - g;
  const long long n_loc = agg < room ? agg : room;
  for (int k = threadIdx.x; k < n_early && k < n_loc; k += kThreads)
    put_selected(o, g + k, b, p_lo + (s_list[k] >> 2), L, ridx + k, s_z[k], s_pay[k], s_hash[k]);
  for (long long k = n_early + wid; k < n_loc; k += kTileWarps) {
    const uint32_t e = s_list[k];
    bool z;
    uint64_t payload, h;
    window_details(crow + (e >> 2), w, s, static_cast<int>(e & 3u), z, payload, h);
    if (lane == 0) put_selected(o, g + k, b, p_lo + static_cast<int>(e >> 2), L, ridx + k, z, payload, h);
  }
}

}  // namespace

extern "C" long long syncmer_details_tiles(long long B, int L) {
  return B * ((static_cast<long long>(L) + kTile - 1) / kTile);
}

// K3d over n_buckets buckets (row0, rows, Lp and out_off host arrays of
// that length), in launches of kBuckets.  row_off null: the packed route's
// blob, row r's bases at src + r*Lp/4 (one bucket).  N entries: n_cap of
// them, i32 at n32 (the packed route) or i64 r<<32|p at n64.
extern "C" int syncmer_decode_launch(const void* src, const void* row_off, const void* hl,
                                     int n_buckets, const long long* row0, const long long* rows,
                                     const int* Lp, const long long* out_off, const void* n32,
                                     const void* n64, int n_cap, int w, void* out, void* stream) {
  if (n_buckets < 0 || w < 1 || n_cap < 0 || (n_cap > 0 && !n32 == !n64) ||
      (!row_off && n_buckets > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // the output 16-byte aligned, the stream and hl 4-byte aligned
  if ((reinterpret_cast<uintptr_t>(out) & 15) || (reinterpret_cast<uintptr_t>(src) & 3) ||
      (reinterpret_cast<uintptr_t>(hl) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int j0 = 0; j0 < n_buckets; j0 += kBuckets) {
    Buckets bk{};
    bk.n = n_buckets - j0 < kBuckets ? n_buckets - j0 : kBuckets;
    long long max_b = 0;
    int max_wd = 0;
    for (int j = 0; j < bk.n; ++j) {
      const int lp = Lp[j0 + j];
      if (lp < 0 || (lp & 3) || rows[j0 + j] < 0 || row0[j0 + j] < 0 || (out_off[j0 + j] & 15))
        return static_cast<int>(cudaErrorInvalidValue);
      bk.Lp[j] = lp;
      bk.row0[j] = row0[j0 + j];
      bk.rows[j] = rows[j0 + j];
      bk.out_off[j] = out_off[j0 + j];
      max_b = rows[j0 + j] > max_b ? rows[j0 + j] : max_b;
      max_wd = 1 + lp + w + 2 > max_wd ? 1 + lp + w + 2 : max_wd;
    }
    if (max_b == 0) continue;
    const int per_row = max_wd / kDecodeBytes + 1;  // chunks that start in one row, at most
    const dim3 grid((per_row + kThreads - 1) / kThreads,
                    static_cast<unsigned>(max_b < 65535 ? max_b : 65535), bk.n);
    blob_decode_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(src), static_cast<const long long*>(row_off),
        static_cast<const int32_t*>(hl), bk, static_cast<uint8_t*>(out), w);
    if (n_cap > 0)
      blob_n_scatter_kernel<<<(n_cap + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          static_cast<const int32_t*>(n32), static_cast<const long long*>(n64), n_cap, bk,
          static_cast<uint8_t*>(out), w);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4 into the packed result (packed non-null) or the key lanes (bh, bl,
// bs, bm, bv, n_sel and sids non-null, n_sids >= 1).  status holds
// syncmer_details_tiles(B, L) words and ctr 3 counters, zero on entry and
// zero again when the launch ends.
extern "C" int syncmer_details_launch(const void* codes_padded, const void* sel, long long B, int L,
                                      int w, int s, long long max_out, void* packed, void* bh,
                                      void* bl, void* bs, void* bm, void* bv, void* n_sel,
                                      const void* sids, long long n_sids, void* status, void* ctr,
                                      void* stream) {
  if (B < 0 || L < 0 || L >= (1 << 29) || B >= (1LL << 31) || max_out < 0 || s < 1 || s > 31 ||
      w < s)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool keys = packed == nullptr;
  if (keys && (!bh || !bl || !bs || !bm || !bv || !n_sel || !sids || n_sids < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = syncmer_details_tiles(B, L);
  const long long n_tail = (max_out + 2047) / 2048;
  const long long Z = n_tail < 1 ? 1 : (n_tail < 264 ? n_tail : 264);
  if (n_tiles + Z >= (1LL << 31) || B * L >= (1LL << kAggShift))
    return static_cast<int>(cudaErrorInvalidValue);
  Out o{static_cast<long long*>(packed), static_cast<long long*>(bh), static_cast<long long*>(bl),
        static_cast<long long*>(bs), static_cast<long long*>(bm), static_cast<int32_t*>(bv),
        static_cast<long long*>(n_sel), static_cast<const long long*>(sids), n_sids, max_out};
  const int32_t* sl = static_cast<const int32_t*>(sel);
  const uint8_t* cp = static_cast<const uint8_t*>(codes_padded);
  uint64_t* stw = static_cast<uint64_t*>(status);
  unsigned* cn = static_cast<unsigned*>(ctr);
  const int Wd = 1 + L + w + 2;
  const int tpr = (L + kTile - 1) / kTile;
  const bool vec = (L % 4 == 0) && (reinterpret_cast<uintptr_t>(sel) % 16 == 0);
  const unsigned grid = static_cast<unsigned>(n_tiles + Z);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    sel_tiles_kernel<true><<<grid, kThreads, 0, st>>>(sl, cp, L, Wd, w, s, tpr, n_tiles, stw, cn, o);
  else
    sel_tiles_kernel<false><<<grid, kThreads, 0, st>>>(sl, cp, L, Wd, w, s, tpr, n_tiles, stw, cn, o);
  return static_cast<int>(cudaGetLastError());
}
