// The syncmer extraction chain around the selection kernel on NVIDIA Hopper
// (sm_90a), CUDA C++: the upload blob's decode in front of it (K3d) and the
// ordered compaction with the per-selected details behind it (K4).
//
// Counterparts in the JAX package, where both are parts of one XLA program
// per chunk (oatk_tpu/kernels/syncmer.py:extract_hoco_fused_pallas):
//   K3d  the blob split (:598-605) and _extract_hoco_packed_impl's unpack,
//        read-end mask and N mark (:534-577), less the selection kernel;
//   K4   _selected_details (:419): compaction in ascending flat order, the
//        boundary s-mer payload, the window's 2-bit pack, its reverse
//        complement and MurmurHash64A, into the packed result of :462-470.
// What the JAX program does only to run well on the TPU is not carried over:
// the MXU one-hot N mask (a scatter here), the sort-funnel compaction with
// its inflated overflow report (an exact scan here), the aligned-block window
// gather and the packed-byte funnel shift of the reverse complement (the
// kernel reads each window's codes and builds both strands from them).
//
// K3d, two launches (the N scatter must follow the decode):
//   blob_decode_kernel     blob [B*Lp/4 | hl i32[B] | n_pos i32[n_cap]] ->
//                          codes_padded uint8 [B, Wd], Wd = 1 + Lp + w + 2:
//                          column 0 and every column from 1 + hl[b] on hold
//                          5, column 1 + p < 1 + hl[b] the 2-bit base p
//                          (base 4j in bits 7-6 of packed byte j); a row
//                          of blocks per row, one thread per 16-byte chunk
//                          of the output that starts in the row (no
//                          division), one 16-byte store;
//   blob_n_scatter_kernel  every n_pos entry v in [0, B*Lp) sets column
//                          1 + v%Lp of row v/Lp to 4 (the sentinel B*Lp is
//                          dropped).
//
// K4, four launches, no host read between them:
//   sel_count_kernel       per tile of kTile sel entries (flat index b*L + p):
//                          its nonzero count;
//   sel_scan_kernel        one block: the exclusive scan of the tile counts
//                          in place, and the total (the exact n_sel) into
//                          slot [0, max_out] of the result;
//   sel_compact_kernel     each tile re-reads its sel; each warp owns kRounds
//                          rounds of 32 consecutive entries, ranks its
//                          nonzeros with __ballot_sync/__popc, and the warps'
//                          counts are scanned in the block; lane j of the
//                          result (j < max_out) takes flat in row 0 and the
//                          selection code (1 open, 2 close) in row 1, in
//                          ascending flat order;
//   sel_details_kernel     one warp per result lane below min(n_sel,
//                          max_out), n_sel read from the result: lanes j < s
//                          read the boundary s-mer's codes and OR-reduce its
//                          forward and reverse-complement codes (payload
//                          min(fwd, rev)<<1 | z, ^1 for a close; z = fwd >
//                          rev); lane i packs Murmur block i of the oriented
//                          window (32 bases, 8 bytes, little-endian, zero
//                          past the window), of the reverse complement when
//                          z by reading the window from its other end; each
//                          lane mixes its block, and the h chain runs over
//                          the lanes in order; for more than 32 blocks the
//                          warp loops in strides of 32.  Rows 0-2 of the
//                          lane become flat<<1 | z, the payload and the
//                          hash.  Lanes from min(n_sel, max_out) to max_out
//                          are zeroed.
// A window's codes come straight from codes_padded (column 1 + p on, & 3):
// the selection kernel selects only windows whose w codes are all below 4.
//
// Bound: bytes.  K3d reads the blob and writes codes_padded; K4 reads sel
// and the selected windows and writes 24 B per lane (sel_compact_kernel reads
// sel a second time).  The per-window work is a few dozen 32-bit
// instructions per 32 bases.
//
// Entry points: syncmer_decode_launch(), syncmer_details_launch() and
// syncmer_details_tiles(), a plain C interface bound with ctypes.  The
// launches run on the stream they are given, allocate nothing, synchronise
// nothing, and return cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDecodeBytes = 16;               // output bytes per decode thread
constexpr int kRounds = 16;                    // rounds of 32 entries per warp
constexpr int kTile = kThreads * kRounds;      // sel entries per tile (block)
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;                  // tile counts per scan thread
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kM = 0xC6A4A7935BD1E995ull; // MurmurHash64A's multiplier
constexpr uint64_t kSeed = 1234;               // kernels/hashes.py:MURMUR_SEED

__global__ void __launch_bounds__(kThreads)
blob_decode_kernel(const uint8_t* __restrict__ blob, uint8_t* __restrict__ out, long long B,
                   int Lp, int Wd) {
  // codes_padded, flat over [B, Wd], in 16-byte chunks at multiples of 16
  // (the wrapper's output is 16-byte aligned): row b0 (blockIdx.y)
  // writes the chunks that start in it, one per thread, one 16-byte
  // store each; a chunk's bytes may run into the next rows
  const long long total = B * Wd;
  const long long row_bytes = Lp / 4;
  const int32_t* hl = reinterpret_cast<const int32_t*>(blob + B * row_bytes);
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long b0 = blockIdx.y; b0 < B; b0 += gridDim.y) {
    const long long r0 = b0 * Wd;
    const long long f0 = ((r0 + kDecodeBytes - 1) & ~static_cast<long long>(kDecodeBytes - 1)) +
                         kDecodeBytes * k;
    if (f0 >= r0 + Wd) continue;  // no chunk of this row left for the thread
    long long b = b0;
    int c = static_cast<int>(f0 - r0);
    int h = min(__ldg(hl + b), Lp);
    const uint8_t* row = blob + b * row_bytes;
    uint32_t word[kDecodeBytes / 4] = {};
    const int nb = total - f0 < kDecodeBytes ? static_cast<int>(total - f0) : kDecodeBytes;
#pragma unroll  // constant indices keep word[] in registers
    for (int t = 0; t < kDecodeBytes; ++t, ++c) {
      if (t < nb) {
        if (c == Wd) {
          c = 0;
          h = min(__ldg(hl + ++b), Lp);
          row += row_bytes;
        }
        const int p = c - 1;
        uint32_t v = 5;
        if (p >= 0 && p < h) v = (__ldg(row + (p >> 2)) >> (6 - 2 * (p & 3))) & 3;
        word[t >> 2] |= v << (8 * (t & 3));
      }
    }
    if (nb == kDecodeBytes) {
      *reinterpret_cast<uint4*>(out + f0) = make_uint4(word[0], word[1], word[2], word[3]);
    } else {
#pragma unroll
      for (int t = 0; t < kDecodeBytes; ++t)
        if (t < nb) out[f0 + t] = static_cast<uint8_t>(word[t >> 2] >> (8 * (t & 3)));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
blob_n_scatter_kernel(const uint8_t* __restrict__ blob, uint8_t* __restrict__ out,
                      long long B, int Lp, int Wd, int n_cap) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_cap) return;
  const long long v = __ldg(reinterpret_cast<const int32_t*>(blob + B * (Lp / 4)) + B + i);
  if (v < 0 || v >= B * Lp) return;  // the pad sentinel B*Lp
  const long long b = v / Lp;
  out[b * Wd + 1 + (v - b * Lp)] = 4;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads)
sel_count_kernel(const int32_t* __restrict__ sel, long long n, long long* __restrict__ tile) {
  __shared__ int wsum[kThreads / 32];
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  int c = 0;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r) {
    const long long i = t0 + r * kThreads + threadIdx.x;
    c += i < n && __ldg(sel + i) != 0;
  }
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int j = 0; j < kThreads / 32; ++j) t += wsum[j];
    tile[blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kScanThreads)
sel_scan_kernel(long long* __restrict__ tile, long long n_tiles, long long* __restrict__ out,
                long long max_out) {
  __shared__ long long wsum[kScanThreads / 32];
  __shared__ long long total;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  long long carry = 0;
  for (long long base = 0; base < n_tiles; base += kScanThreads * kScanItems) {
    const long long i0 = base + static_cast<long long>(threadIdx.x) * kScanItems;
    long long v[kScanItems];
    long long local = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      v[j] = i0 + j < n_tiles ? tile[i0 + j] : 0;
      local += v[j];
    }
    long long incl = local;
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) wsum[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      long long x = wsum[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const long long u = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += u;
      }
      wsum[lane] = x - wsum[lane];  // exclusive over the warps
      if (lane == 31) total = x;
    }
    __syncthreads();
    long long run = carry + wsum[wid] + incl - local;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      if (i0 + j < n_tiles) tile[i0 + j] = run;
      run += v[j];
    }
    carry += total;
    __syncthreads();  // wsum and total are rewritten by the next chunk
  }
  if (threadIdx.x == 0) out[max_out] = carry;  // row 0's slot: the exact n_sel
}

__global__ void __launch_bounds__(kThreads)
sel_compact_kernel(const int32_t* __restrict__ sel, long long n,
                   const long long* __restrict__ tile, long long* __restrict__ out,
                   long long max_out) {
  __shared__ int wcnt[kThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  // warp wid owns entries w0 .. w0 + 32 kRounds - 1 of the tile, in order
  const long long w0 = static_cast<long long>(blockIdx.x) * kTile + wid * (32 * kRounds);
  unsigned nz[kRounds];
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = w0 + r * 32 + lane;
    nz[r] = __ballot_sync(kFull, i < n && __ldg(sel + i) != 0);
    cnt += __popc(nz[r]);
  }
  if (lane == 0) wcnt[wid] = cnt;
  __syncthreads();
  long long at = tile[blockIdx.x];
  for (int j = 0; j < wid; ++j) at += wcnt[j];
  const unsigned below = (1u << lane) - 1u;
  const long long row1 = max_out + 1;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if ((nz[r] >> lane) & 1u) {
      const long long j = at + __popc(nz[r] & below);
      if (j < max_out) {
        const long long i = w0 + r * 32 + lane;
        out[j] = i;
        out[row1 + j] = __ldg(sel + i);  // a cache hit: read in the first loop
      }
    }
    at += __popc(nz[r]);
  }
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

__global__ void __launch_bounds__(kThreads)
sel_details_kernel(const uint8_t* __restrict__ codes, long long* __restrict__ out, int L,
                   int Wd, int w, int s, long long max_out) {
  const long long row1 = max_out + 1, row2 = 2 * (max_out + 1);
  const long long n_sel = out[max_out];
  const long long n_eff = n_sel < max_out ? n_sel : max_out;
  const long long gt = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_threads = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = n_eff + gt; i < max_out; i += n_threads) {
    out[i] = 0;
    out[row1 + i] = 0;
    out[row2 + i] = 0;
  }
  if (gt == 0) {
    out[row1 + max_out] = 0;
    out[row2 + max_out] = 0;
  }

  const int lane = threadIdx.x & 31;
  const int q = w - s + 1;
  const int n_bytes = (w - 1) / 4 + 1;
  const int n_full = n_bytes >> 3;
  const int nblk = (n_bytes + 7) >> 3;
  const uint64_t h0 = kSeed ^ (static_cast<uint64_t>(n_bytes) * kM);
  for (long long i = gt >> 5; i < n_eff; i += n_threads >> 5) {
    const long long flat = out[i];
    const long long oc = out[row1 + i];
    const long long b = flat / L;
    const uint8_t* win = codes + b * Wd + 1 + (flat - b * L);

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
    const bool z = f > r;
    uint64_t payload = ((z ? r : f) << 1) | (z ? 1 : 0);
    if (oc == 2) payload ^= 1;

    // MurmurHash64A over the oriented window
    uint64_t h = h0;
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
    if (lane == 0) {
      out[i] = (flat << 1) | (z ? 1 : 0);
      out[row1 + i] = static_cast<long long>(payload);
      out[row2 + i] = static_cast<long long>(h);
    }
  }
}

}  // namespace

extern "C" long long syncmer_details_tiles(long long n) { return (n + kTile - 1) / kTile; }

extern "C" int syncmer_decode_launch(const void* blob, void* codes_padded, long long B, int Lp,
                                     int n_cap, int w, void* stream) {
  if (B <= 0) return 0;
  if (Lp < 0 || (Lp & 3) || w < 1 || n_cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  // the output 16-byte aligned, the read lengths 4-byte aligned (B*Lp/4
  // packed bytes precede them)
  if ((reinterpret_cast<uintptr_t>(codes_padded) & 15) ||
      ((reinterpret_cast<uintptr_t>(blob) + B * (Lp / 4)) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Wd = 1 + Lp + w + 2;
  const int per_row = Wd / kDecodeBytes + 1;  // chunks that start in one row, at most
  const dim3 grid((per_row + kThreads - 1) / kThreads, static_cast<unsigned>(B < 65535 ? B : 65535));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  blob_decode_kernel<<<grid, kThreads, 0, st>>>(static_cast<const uint8_t*>(blob),
                                                 static_cast<uint8_t*>(codes_padded), B, Lp, Wd);
  if (n_cap > 0)
    blob_n_scatter_kernel<<<(n_cap + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(blob), static_cast<uint8_t*>(codes_padded), B, Lp, Wd, n_cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int syncmer_details_launch(const void* codes_padded, const void* sel, void* out,
                                      void* tiles, long long B, int L, int w, int s,
                                      long long max_out, void* stream) {
  if (B <= 0 || L <= 0 || max_out < 0 || s < 1 || s > 31 || w < s)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = B * L;
  const long long n_tiles = syncmer_details_tiles(n);
  if (n_tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* sl = static_cast<const int32_t*>(sel);
  long long* tl = static_cast<long long*>(tiles);
  long long* o = static_cast<long long*>(out);
  sel_count_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, st>>>(sl, n, tl);
  sel_scan_kernel<<<1, kScanThreads, 0, st>>>(tl, n_tiles, o, max_out);
  sel_compact_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, st>>>(sl, n, tl, o, max_out);
  // one warp per lane, at most 4,224 blocks (32 per SM on 132 SMs); the
  // kernel strides over the rest
  const long long want = (max_out + kThreads / 32 - 1) / (kThreads / 32);
  const unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : (want < 4224 ? want : 4224));
  sel_details_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const uint8_t*>(codes_padded), o,
                                                  L, 1 + L + w + 2, w, s, max_out);
  return static_cast<int>(cudaGetLastError());
}
