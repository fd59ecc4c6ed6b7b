// Closed-syncmer selection on NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel oatk_tpu/kernels/syncmer_pallas.py:
// syncmer_select_pallas (Pallas call at :439, body _select_body at :301).
// It computes WHAT _select_body computes, not how Mosaic tiled it: native
// uint64_t replaces the (hi, lo) uint32 pairs and _compose_pow_u32, which
// exist only because the TPU has no 64-bit lanes.
//
// Input  codes [B, Lp] uint8, Lp = 1 + L + w + 2: 0-3 base, 4 N, 5 pad
//        (column 0 and the right pad are 5).
// Output sel   [B, L]  int32: 0 none, 1 open, 2 close (open XOR close).
//
// For every extended column e (column e of the row is position e - 1):
//   M[e]  = Thomas-Wang hash of the canonical 2s-bit s-mer code at e under
//           the 2s-bit mask, or the all-ones sentinel when the s-mer is
//           palindromic or touches a code >= 4;
//   C2[e] = min M[e .. e+q-3]  (q = w - s + 1; sliding minimum)
// and for output position p the open/close rules of _select_body
// (syncmer_pallas.py:338-377), with the same index offsets.
//
// Design: one block per (row, tile of TILE outputs).  The block stages
// the tile plus its w+3 halo of u8 codes in shared memory, then builds in
// shared memory the invalid-code prefix count (any-N in a window is one
// subtraction), M by a rolling per-thread s-mer, and C2 by a doubling
// sparse table (log2(q-2) passes, two ping-pong buffers, __syncthreads
// between passes, as _table_min does).  Everything between the 1 B/code
// input and the 4 B/position output stays on chip.
//
// Bound: integer operations, not bytes.  About 1 B is read and 4 B are
// written per position, against tens of 64-bit integer operations per
// position (s-mer roll, hash, ~log2(q) sliding-min steps).  The halo is
// recomputed by each tile: (w+3)/TILE extra work, about 0.5x at k=1001
// with TILE=2048.  Making it fast (register-blocked minima, fewer
// passes, larger tiles) is later work.
//
// Entry point: syncmer_select_launch(), a plain C interface bound with
// ctypes.  It launches on the stream it is given, allocates nothing,
// synchronises nothing, and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kSent = ~0ull;

__device__ __forceinline__ uint64_t hash64(uint64_t key, uint64_t mask) {
  // Thomas Wang 64-bit mix under the 2s-bit mask (kernels/hashes.py)
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = (key + (key << 3) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = (key + (key << 2) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

__device__ __forceinline__ uint64_t umin(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
syncmer_select_kernel(const uint8_t* __restrict__ codes,
                      int32_t* __restrict__ out, int Lp, int L, int w, int s,
                      int tile, int n_tiles, int ext) {
  // shared layout: M[ext] | A[ext] | Bf[ext] (u64) | cnt[ext+1] (i32) |
  // code[ext] (u8)
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* M = reinterpret_cast<uint64_t*>(smem);
  uint64_t* A = M + ext;
  uint64_t* Bf = A + ext;
  int32_t* cnt = reinterpret_cast<int32_t*>(Bf + ext);
  uint8_t* code = reinterpret_cast<uint8_t*>(cnt + ext + 1);
  __shared__ int32_t warp_off[kThreads / 32];

  const int tid = threadIdx.x;
  const long long row = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x % n_tiles) * tile;  // first extended column
  const uint8_t* src = codes + row * static_cast<long long>(Lp);

  // 1. stage the tile and its halo; columns past the row read as pad
  for (int e = tid; e < ext; e += kThreads) {
    const int col = t0 + e;
    code[e] = col < Lp ? src[col] : 5;
  }
  __syncthreads();

  // 2. cnt[e] = number of codes >= 4 in [0, e): contiguous per-thread
  //    segments, then a block-wide exclusive scan of the segment counts
  const int per = (ext + kThreads - 1) / kThreads;
  const int e0 = min(tid * per, ext);
  const int e1 = min(e0 + per, ext);
  int local = 0;
  for (int e = e0; e < e1; ++e) local += code[e] >= 4;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  int incl = local;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_off[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    const int v = lane < kThreads / 32 ? warp_off[lane] : 0;
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += u;
    }
    if (lane < kThreads / 32) warp_off[lane] = x - v;
  }
  __syncthreads();
  int run = warp_off[wid] + incl - local;
  for (int e = e0; e < e1; ++e) {
    cnt[e] = run;
    run += code[e] >= 4;
  }
  if (tid == kThreads - 1) cnt[ext] = run;
  __syncthreads();

  // 3. M[e], rolling the forward and reverse-complement s-mer codes along
  //    this thread's segment (an s-mer running past the halo is never
  //    read by an output of this tile; it gets the sentinel)
  const uint64_t mask = (1ull << (2 * s)) - 1;  // s <= 31
  if (e0 < e1) {
    uint64_t F = 0, R = 0;
    for (int j = 0; j < s; ++j) {
      const int e = e0 + j;
      const uint64_t c = (e < ext && code[e] < 4) ? code[e] : 0;
      F = (F << 2) | c;
      R |= (3ull - c) << (2 * j);
    }
    for (int e = e0; e < e1; ++e) {
      if (e > e0) {
        const int en = e + s - 1;
        const uint64_t c = (en < ext && code[en] < 4) ? code[en] : 0;
        F = ((F << 2) | c) & mask;
        R = (R >> 2) | ((3ull - c) << (2 * (s - 1)));
      }
      const bool bad = (e + s > ext) || (cnt[e + s] - cnt[e] > 0) || F == R;
      M[e] = bad ? kSent : hash64(R < F ? R : F, mask);
    }
  }
  __syncthreads();

  // 4. C2 = sliding min of M over width q-2: doubling sparse table,
  //    ping-ponging between A and Bf (M itself is never overwritten)
  const int q = w - s + 1;
  const int W2 = q - 2;
  const uint64_t* C2 = nullptr;  // nullptr: empty window, all sentinel
  if (W2 >= 1) {
    const uint64_t* cur = M;
    uint64_t* dst = A;
    int span = 1;
    while (span * 2 <= W2) {
      for (int e = tid; e < ext; e += kThreads)
        dst[e] = umin(cur[e], e + span < ext ? cur[e + span] : kSent);
      __syncthreads();
      cur = dst;
      dst = (dst == A) ? Bf : A;
      span *= 2;
    }
    if (span < W2) {
      const int d = W2 - span;
      for (int e = tid; e < ext; e += kThreads)
        dst[e] = umin(cur[e], e + d < ext ? cur[e + d] : kSent);
      __syncthreads();
      cur = dst;
    }
    C2 = cur;
  }

  // 5. open/close rules per output position p (extended column p + 1)
  for (int p = tid; p < tile; p += kThreads) {
    const int P = t0 + p;
    if (P >= L) break;
    const uint64_t Mp = M[p + 1];      // M[p]   (position coordinates)
    const uint64_t Mm1 = M[p];         // M[p-1]
    const uint64_t La = M[p + q];      // M[p+q-1]
    const uint64_t C1 = C2 ? C2[p + 2] : kSent;  // min M[p+1 .. p+q-2]
    // Bq1 = min M[p .. p+q-2], D = min M[p+1 .. p+q-1]
    const uint64_t Bq1 = q >= 2 ? umin(Mp, C1) : kSent;
    const uint64_t D =
        q >= 2 ? umin(M[p + 2], C2 ? C2[p + 3] : kSent) : kSent;
    const bool noN = cnt[p + 1 + w] - cnt[p + 1] == 0;  // [p, p+w-1] clean
    const bool open_ = Mp != kSent && Mp <= D && noN && code[p + w + 1] != 4;
    const bool case2 = La <= Mm1 && La <= Bq1;
    const bool case3 = !case2 && Mm1 <= Bq1 && Mm1 != kSent &&
                       (La < Bq1 || (Mp == La && Mp <= C1));
    const bool close_ = La != kSent && noN && (case2 || case3);
    out[row * L + P] = open_ != close_ ? (open_ ? 1 : 2) : 0;
  }
}

}  // namespace

extern "C" size_t syncmer_select_smem_bytes(int tile, int w) {
  const size_t ext = static_cast<size_t>(tile) + w + 3;
  return 3 * 8 * ext + 4 * (ext + 1) + ext;
}

extern "C" int syncmer_select_launch(const void* codes, void* out,
                                     long long B, int Lp, int L, int w, int s,
                                     int tile, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const int n_tiles = (L + tile - 1) / tile;
  const long long blocks = B * n_tiles;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int ext = tile + w + 3;
  const size_t smem = syncmer_select_smem_bytes(tile, w);
  cudaError_t err = cudaFuncSetAttribute(
      syncmer_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  syncmer_select_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<int32_t*>(out), Lp, L,
      w, s, tile, n_tiles, ext);
  return static_cast<int>(cudaGetLastError());
}
