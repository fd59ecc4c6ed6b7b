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
//   C2[e] = min M[e .. e+W2-1]  (W2 = q - 2, q = w - s + 1; sliding min)
// and for output position p the open/close rules of _select_body
// (syncmer_pallas.py:338-377), with the same index offsets.
//
// Design: one block per (row, tile of T outputs); the block's extent is
// E = T + w + 4 extended columns, cut into nr runs of R columns (the
// wrapper picks R <= W2 with nr about the thread count).  Each thread owns
// a few consecutive runs and walks them once: a rolling forward and
// reverse s-mer read straight from global memory, a bit window of invalid
// codes, the hash, and in registers the run's prefix minimum P, its
// minimum and its last invalid column.  The sliding minimum is van Herk /
// Gil-Werman over runs:
//   C2[x] = min(S[x], min runmin[a+1 .. b-1], P[x+W2-1])
// (run a holds x, run b holds x+W2-1; S the suffix minimum within a run;
// exact for R <= W2), the middle term from a doubling table over the run
// minima, which has log2(W2/R) levels over nr entries, not over E columns.
// Only the two ends of the tile keep per-column state in shared memory:
// the head (M and S at columns 0 .. T+3) and the tail (M and P at columns
// q-1 .. T+q, the in-run last invalid column at w .. T+w-1).  Columns in
// between are hashed in registers and never stored, so shared memory is
// 36 T bytes plus the run table, whatever w is.  "Any N in [p+1, p+w]" is
// the last invalid column at p+w (an exclusive prefix max over runs plus
// the in-run value) compared with p+1.
//
// The rolling s-mer starts each thread's segment from its first s-1 codes
// (the forward code and invalid bits only; the reverse complement is
// derived once by a bit reverse), and loads each code one column ahead.
// C2 is formed once per column of the head, in place over P, before the
// rules read it.
//
// Bound: integer instructions, not bytes.  About 1 B is read and 4 B are
// written per position, against about 88 32-bit instructions of the
// function's own work per position where every s-mer and window is clean
// (s-mer roll, 64-bit hash, sliding minimum, rules, N test;
// chip_smoke.py:K1_OPS); this kernel's per-column and per-output loop
// bodies hold about 190 SASS instructions per position.  Each tile
// rehashes its (w+4)-column halo: (T + w + 4) / T of the columns, 1.36 at
// T = 2816 and k = 1001.  Shared memory is about 36 T bytes plus the run table; the
// wrapper takes the largest T (in steps of 256, up to 4096) at which two
// blocks fit on an SM, 2816 at k = 1001 (PERF.md has the measured tiles).
//
// Entry points: syncmer_select_launch() and two planning helpers, a plain
// C interface bound with ctypes.  The launch runs on the stream it is
// given, allocates nothing, synchronises nothing, and returns
// cudaGetLastError().
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

__host__ __device__ __forceinline__ int n_runs(int tile, int w, int R) {
  return (tile + w + 4 + R - 1) / R;
}

__host__ __device__ __forceinline__ int n_head_runs(int tile, int R) {
  return (tile + 4 + R - 1) / R;
}

__device__ __forceinline__ int floor_log2(int v) { return 31 - __clz(v); }

__global__ void __launch_bounds__(kThreads)
syncmer_select_kernel(const uint8_t* __restrict__ codes,
                      int32_t* __restrict__ out, int Lp, int L, int w, int s,
                      int tile, int R, int n_tiles) {
  const int q = w - s + 1;
  const int W2 = q - 2;
  const int NH = tile + 4;  // head columns 0 .. T+3
  const int NT = tile + 2;  // tail columns q-1 .. T+q
  const int nr = n_runs(tile, w, R);
  const int nhead = n_head_runs(tile, R);

  // shared layout (u64 first): headM, headS [NH] | tailM, tailP [NT] |
  // runmin, bufA, bufB [nr] | mid0, mid1 [nhead] | tailLB [T], runlast [nr]
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* headM = reinterpret_cast<uint64_t*>(smem);
  uint64_t* headS = headM + NH;
  uint64_t* tailM = headS + NH;
  uint64_t* tailP = tailM + NT;
  uint64_t* runmin = tailP + NT;
  uint64_t* bufA = runmin + nr;
  uint64_t* bufB = bufA + nr;
  uint64_t* mid0 = bufB + nr;
  uint64_t* mid1 = mid0 + nhead;
  int32_t* tailLB = reinterpret_cast<int32_t*>(mid1 + nhead);
  int32_t* runlast = tailLB + tile;
  __shared__ int32_t warp_off[kThreads / 32];

  const int tid = threadIdx.x;
  const long long row = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x % n_tiles) * tile;  // first extended column
  const uint8_t* src = codes + row * static_cast<long long>(Lp);

  // 1. one pass over this thread's runs: M, P, run minimum, last invalid
  //    column; the head and tail columns go to shared memory
  const uint64_t mask = (1ull << (2 * s)) - 1;  // s <= 31
  const uint32_t smask = (1u << s) - 1;
  const int G = (nr + kThreads - 1) / kThreads;
  const int a0 = tid * G;
  const int a1 = min(a0 + G, nr);
  if (a0 < a1) {
    const uint8_t* row_t = src + t0;
    const int lim = Lp - t0;  // columns at or past it read as pad
    auto code_at = [&](int e) -> int { return e < lim ? __ldg(row_t + e) : 5; };
    // warm up on the first s-1 codes with the forward code and the
    // invalid bits only; the reverse complement follows from F once:
    // complement, reverse the 2-bit groups (bit reverse, swap bit pairs)
    const int c0 = a0 * R;
    uint64_t F = 0;
    uint32_t inv = 0;  // bit j: code at column (newest - j) is >= 4
    int j = 0;
    if (c0 + s + 7 <= lim) {
      // four codes per 32-bit word (aligned loads, funnel-shifted to
      // column c0 + j): a code is >= 4 iff its bit 2 is set, and one
      // multiply gathers four 2-bit codes (or four flags) oldest first
      const uintptr_t at = reinterpret_cast<uintptr_t>(row_t + c0);
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(at & ~uintptr_t(3));
      const int sh8 = static_cast<int>(at & 3) * 8;
      uint32_t lo = __ldg(wp);
      for (; j + 4 <= s - 1; j += 4) {
        const uint32_t hi = __ldg(++wp);
        const uint32_t x = __funnelshift_r(lo, hi, sh8);
        lo = hi;
        const uint32_t bad4 = (x >> 2) & 0x01010101u;
        const uint32_t val4 = x & 0x03030303u & ~(bad4 * 3u);
        F = (F << 8) | ((val4 * 0x40100401u) >> 24);
        inv = (inv << 4) | (((bad4 * 0x08040201u) >> 24) & 0xFu);
      }
    }
    for (; j < s - 1; ++j) {
      const int c = code_at(c0 + j);
      F = (F << 2) | static_cast<uint64_t>(c >= 4 ? 0 : c);
      inv = (inv << 1) | (c >= 4);
    }
    uint64_t Rv = __brevll(F ^ ((1ull << (2 * (s - 1))) - 1));
    Rv = (((Rv >> 1) & 0x5555555555555555ull) | ((Rv & 0x5555555555555555ull) << 1)) >> (64 - 2 * s);
    const int sh = 2 * (s - 1);
    // the code pushed for column e is loaded one column ahead, so the
    // load's latency overlaps the previous column's hash
    int c_next = code_at(c0 + s - 1);
    auto push = [&](int e) {
      const int c = c_next;
      c_next = code_at(e + 1);
      const int bad = c >= 4;
      const uint64_t cc = bad ? 0 : c;
      F = (F << 2) | cc;
      Rv = (Rv >> 2) | ((3ull - cc) << sh);
      inv = (inv << 1) | bad;
    };
    for (int a = a0; a < a1; ++a) {
      const int e0 = a * R;
      uint64_t pmin = kSent, beyond = kSent;
      int last = -1;
#pragma unroll 1  // one column per iteration: chip_smoke.py counts this body
      for (int e = e0; e < e0 + R; ++e) {
        push(e + s - 1);
        F &= mask;
        const bool bad = (inv & smask) != 0 || F == Rv;
        const uint64_t Me = bad ? kSent : hash64(Rv < F ? Rv : F, mask);
        if ((inv >> (s - 1)) & 1u) last = e;
        pmin = umin(pmin, Me);
        if (e < NH)
          headM[e] = Me;
        else
          beyond = umin(beyond, Me);
        const int ti = e - (q - 1);
        if (ti >= 0 && ti < NT) {
          tailM[ti] = Me;
          tailP[ti] = pmin;
        }
        const int li = e - w;
        if (li >= 0 && li < tile) tailLB[li] = last;
      }
      runmin[a] = pmin;
      runlast[a] = last;
      // S over the run's head columns, seeded with the run's columns
      // past the head (same thread wrote them: no barrier needed)
      if (e0 < NH) {
        uint64_t sfx = beyond;
        for (int e = min(e0 + R, NH) - 1; e >= e0; --e) {
          sfx = umin(sfx, headM[e]);
          headS[e] = sfx;
        }
      }
    }
  }
  __syncthreads();

  // 2. runlast -> exclusive prefix max over runs (contiguous per-thread
  //    segments, a warp scan, then a scan of the warps' maxima)
  {
    const int per = (nr + kThreads - 1) / kThreads;
    const int i0 = min(tid * per, nr);
    const int i1 = min(i0 + per, nr);
    int local = -1;
    for (int i = i0; i < i1; ++i) local = max(local, runlast[i]);
    const int lane = tid & 31;
    const int wid = tid >> 5;
    int incl = local;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = max(incl, v);
    }
    int excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = -1;
    if (lane == 31) warp_off[wid] = incl;
    __syncthreads();
    if (wid == 0) {
      const int v = lane < kThreads / 32 ? warp_off[lane] : -1;
      int x = v;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x = max(x, u);
      }
      int ex = __shfl_up_sync(0xffffffffu, x, 1);
      if (lane == 0) ex = -1;
      if (lane < kThreads / 32) warp_off[lane] = ex;
    }
    __syncthreads();
    int run = max(warp_off[wid], excl);
    for (int i = i0; i < i1; ++i) {
      const int v = runlast[i];
      runlast[i] = run;
      run = max(run, v);
    }
  }

  // 3. middle terms for each head run a: mid0[a] = min runmin[a+1 ..
  //    a+D0-1], mid1[a] = min runmin[a+1 .. a+D0] (D0 = (W2-1) / R), by a
  //    doubling table over the run minima, queried at the level of each
  //    length
  const int d = W2 - 1;
  const int D0 = W2 >= 1 ? d / R : 0;
  const int dm = W2 >= 1 ? d - D0 * R : 0;
  {
    const int len0 = D0 - 1, len1 = D0;
    const int k0 = len0 >= 1 ? floor_log2(len0) : -1;
    const int k1 = len1 >= 1 ? floor_log2(len1) : -1;
    for (int a = tid; a < nhead; a += kThreads) {
      if (k0 < 0) mid0[a] = kSent;
      if (k1 < 0) mid1[a] = kSent;
    }
    const uint64_t* cur = runmin;
    uint64_t* dst = bufA;
    for (int j = 0; j <= k1; ++j) {
      if (j > 0) {
        const int span = 1 << (j - 1);
        for (int i = tid; i < nr; i += kThreads)
          dst[i] = umin(cur[i], i + span < nr ? cur[i + span] : kSent);
        __syncthreads();
        cur = dst;
        dst = (dst == bufA) ? bufB : bufA;
      }
      if (j == k0 || j == k1) {
        for (int a = tid; a < nhead; a += kThreads) {
          if (j == k0) mid0[a] = umin(cur[a + 1], cur[a + 1 + len0 - (1 << j)]);
          if (j == k1) mid1[a] = umin(cur[a + 1], cur[a + 1 + len1 - (1 << j)]);
        }
      }
    }
  }
  __syncthreads();

  // 4. C2[x] for x = 2 .. T+2 in place over tailP[x-2] (= P[x+W2-1]);
  //    x = a R + r advances without division
  const int Qs = kThreads / R, Rs = kThreads - Qs * R;
  if (W2 >= 1) {
    int a = (tid + 2) / R, r = tid + 2 - a * R;
#pragma unroll 1
    for (int x = tid + 2; x < tile + 3; x += kThreads) {
      tailP[x - 2] = umin(umin(headS[x], r + dm >= R ? mid1[a] : mid0[a]), tailP[x - 2]);
      a += Qs;
      r += Rs;
      if (r >= R) { r -= R; ++a; }
    }
  }
  __syncthreads();

  // 5. open/close rules per output position p (extended column p + 1);
  //    p + w = al R + rl advances without division
  int al = (tid + w) / R, rl = tid + w - al * R;
#pragma unroll 1  // one output per iteration: chip_smoke.py counts this body
  for (int p = tid; p < tile; p += kThreads) {
    const int P = t0 + p;
    if (P >= L) break;
    const uint64_t Mm1 = headM[p];       // M[p-1] (position coordinates)
    const uint64_t Mp = headM[p + 1];    // M[p]
    const uint64_t M2 = headM[p + 2];    // M[p+1]
    const uint64_t La = tailM[p + 1];    // M[p+q-1]
    const uint64_t C1 = W2 >= 1 ? tailP[p] : kSent;      // C2[p+2]
    const uint64_t C3 = W2 >= 1 ? tailP[p + 1] : kSent;  // C2[p+3]
    // Bq1 = min M[p .. p+q-2], D = min M[p+1 .. p+q-1]
    const uint64_t Bq1 = q >= 2 ? umin(Mp, C1) : kSent;
    const uint64_t D = q >= 2 ? umin(M2, C3) : kSent;
    const int lb = max(runlast[al], tailLB[p]);  // last invalid <= p+w
    const bool noN = lb < p + 1;                 // [p, p+w-1] clean
    const bool open_ = Mp != kSent && Mp <= D && noN && __ldg(src + P + w + 1) != 4;
    const bool case2 = La <= Mm1 && La <= Bq1;
    const bool case3 = !case2 && Mm1 <= Bq1 && Mm1 != kSent &&
                       (La < Bq1 || (Mp == La && Mp <= C1));
    const bool close_ = La != kSent && noN && (case2 || case3);
    out[row * L + P] = open_ != close_ ? (open_ ? 1 : 2) : 0;
    al += Qs;
    rl += Rs;
    if (rl >= R) { rl -= R; ++al; }
  }
}

}  // namespace

extern "C" size_t syncmer_select_smem_bytes(int tile, int w, int R) {
  const size_t nr = n_runs(tile, w, R), nhead = n_head_runs(tile, R);
  return 8 * (2 * (static_cast<size_t>(tile) + 4) + 2 * (tile + 2) + 3 * nr + 2 * nhead) +
         4 * (static_cast<size_t>(tile) + nr);
}

static int set_smem(size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      syncmer_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

extern "C" int syncmer_select_occupancy(int tile, int w, int R, int* blocks) {
  const size_t smem = syncmer_select_smem_bytes(tile, w, R);
  *blocks = 0;
  if (smem > 0x7FFFFFFF || set_smem(smem) != 0) {
    cudaGetLastError();  // a tile that does not fit reports 0 blocks
    return 0;
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, syncmer_select_kernel, kThreads, smem));
}

extern "C" int syncmer_select_launch(const void* codes, void* out,
                                     long long B, int Lp, int L, int w, int s,
                                     int tile, int R, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const int W2 = w - s - 1;
  if (tile < 1 || R < 1 || (W2 >= 1 && R > W2))
    return static_cast<int>(cudaErrorInvalidValue);  // decomposition exact only for R <= W2
  const int n_tiles = (L + tile - 1) / tile;
  const long long blocks = B * n_tiles;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = syncmer_select_smem_bytes(tile, w, R);
  const int err = set_smem(smem);
  if (err != 0) return err;
  syncmer_select_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<int32_t*>(out), Lp, L,
      w, s, tile, R, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
