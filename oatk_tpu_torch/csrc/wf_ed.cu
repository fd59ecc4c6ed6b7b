// Banded LV89 edit-distance wavefront on NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel oatk_tpu/kernels/wavefront_pallas.py:
// wf_ed_core_pallas_batch (Pallas call at :185, kernel _wf_kernel at :55).
// It computes WHAT _wf_kernel computes, not how Mosaic did it: the TPU
// kernel materialises a next-mismatch table of (TL+QL+1) x (TL+1) int32
// so that each diagonal's match run is one gather, and that table is why
// its single-state entry (wf_ed_core_pallas) caps both lengths at 512.
// Here each diagonal's run is found by comparing 32 positions at a time
// across a warp, so nothing grows with tl x ql and there is no length cap.
//
// One launch runs a ragged round: B items of any lengths, block b reading
// its own descriptor desc[b * 12 ...] (all offsets into the base pointers
// the launch is given; ts/qs in bytes, the rest in int32 words):
//   0 ts_off  1 qs_off  2 meta_off  3 k_off  4 out_meta_off  5 out_k_off
//   6 scratch_off (-1: the shared-memory route)  7 S (the item's width of
//   k, out_k and the wave)  8 TL  9 QL (the widths ts and qs may use)
// Per item, the contract of wf_ed_core_pallas_batch (:169-203):
//   meta     int32 [8] = tl, ql, is_ext, bw, score, d0, n, 0
//   k        int32 [n], the wavefront of diagonals d0..d0+n-1
//   out_meta int32 [8] = score, d0, n, hit, t_end_raw, q_end_raw, err, 0
//   out_k    int32 [S], out_k[:n] the new wavefront, -BIG after it
// err is 0, or 1 when the input does not fit (n outside [1, S], tl > TL
// or ql > QL), or 2 when a wave would leave [1, S]; out_k is then all
// -BIG.  The round driver (kernels/wf_ed.py) packs every item into one
// buffer with S = min(d_cap, n + 2 * max(1, bw - score + 1)): a band stops
// the loop after bw - score + 1 steps of at most 2 new diagonals each, so
// 2 cannot happen.  The padded batch contract is the same launch with
// descriptors that stride over [B, TL], [B, QL], [B, 8] and [B, D_cap].
//
// Per step, as _wf_kernel's while_loop body (:85-147):
//   1. extension: one warp per live diagonal (warps stride over j); a
//      position past max_k = min(ql-d, tl)-1 or with a negative query
//      index counts as a mismatch (`ok`, :75); diagonals with k >= tl or
//      k+d >= ql are skipped (:90).  __ballot_sync + __ffs give the first
//      mismatch of each 32-position window.  Results go to E[].
//   2. first hit: block-wide minimum j over the diagonals whose end is at
//      the query or target end, under is_ext or both ends (:95-98), by a
//      shared atomicMin.  On a hit, diagonals below it take E, the rest
//      keep K, and the kernel stops with (t_hit, q_hit) (:99-104).
//   3. next wave from the three candidates (:107-112), then the band,
//      including the reference's max_d = max(xdb, ql) quirk (:116-135),
//      written shifted by stt back into K; score += 1; stop once bw >= 0
//      and score > bw.
// __syncthreads separates the phases; K and E are ping-ponged so that no
// phase reads what it writes.
//
// Routes, chosen per item by the driver: ts, qs, K and E in dynamic
// shared memory (round16(8 S) + round16(tl) + round16(ql) bytes; the
// launch takes the largest such item of the round, above 48 KB through
// cudaFuncSetAttribute), ts/qs staged with 16-byte vector loads; an item
// that does not fit the card's per-block limit reads ts/qs from global
// memory and keeps K/E in a global scratch at its own offset.  No length
// cap and no host fallback.  cp.async would not pay: the staging is the
// block's first work and every step needs all of it.
//
// Block width: kThreads is 128 or 256 (both instantiated; the driver's
// THREADS picks one, from the measurement chip_smoke.py prints).  EC's
// waves start narrow (n = 1 at a block's first call, n <= 2 bw + 3
// after), which argues for 128; measured on an H100 over a round of
// 2,000 EC-shaped states, 256 is faster (0.41 against 0.67 ms): the
// 128-thread build spills, and restarts bring waves of up to ~220
// diagonals that keep eight warps busy.
//
// Bound: not bytes (a round moves a few KB per item) and not operations
// (byte compares and a data-dependent loop; tensor cores do not apply).
// Error correction's DFS runs every read's next extension in one round,
// so what bounds the kernel now is the host work per round (the Python
// DFS, packing, unpacking) and one round trip per round, not one round
// trip per call.
//
// Entry points, a plain C interface bound with ctypes: wf_ed_smem_limit()
// and wf_ed_launch().  The launch allocates nothing, synchronises nothing,
// and returns cudaGetLastError().
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 0x3FFFFFFF;
constexpr int kDescWords = 12;

__device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// dst (16-byte aligned shared memory) <- src[0, len)
template <int kThreads>
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src, int len, int tid) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n16 = len >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < n16; i += kThreads) d[i] = s[i];
    done = n16 << 4;
  }
  for (int i = done + tid; i < len; i += kThreads) dst[i] = src[i];
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
wf_ed_kernel(const int32_t* __restrict__ desc, const uint8_t* __restrict__ ts_base,
             const uint8_t* __restrict__ qs_base, const int32_t* __restrict__ meta_base,
             const int32_t* __restrict__ k_base, int32_t* __restrict__ om_base,
             int32_t* __restrict__ ok_base, int32_t* __restrict__ scratch) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_fh[2];
  const int32_t* dsc = desc + (size_t)blockIdx.x * kDescWords;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int S = dsc[7];
  const int32_t* m = meta_base + dsc[2];
  const int tl = m[0], ql = m[1], is_ext = m[2], bw = m[3];
  int score = m[4], d0 = m[5], n = m[6];
  int hit = 0, t_end = -1, q_end = -1;
  int err = (n < 1 || n > S || tl < 0 || ql < 0 || tl > dsc[8] || ql > dsc[9]) ? 1 : 0;

  const uint8_t* ts_g = ts_base + dsc[0];
  const uint8_t* qs_g = qs_base + dsc[1];
  const uint8_t* ts;
  const uint8_t* qs;
  int32_t* K;
  int32_t* E;
  if (dsc[6] < 0) {
    K = reinterpret_cast<int32_t*>(smem);
    E = K + S;
    uint8_t* ts_s = smem + round16(8 * S);
    uint8_t* qs_s = ts_s + round16(tl);
    if (!err) {
      stage<kThreads>(ts_s, ts_g, tl, tid);
      stage<kThreads>(qs_s, qs_g, ql, tid);
    }
    ts = ts_s;
    qs = qs_s;
  } else {
    K = scratch + dsc[6];
    E = K + S;
    ts = ts_g;
    qs = qs_g;
  }
  if (!err) {
    const int32_t* kin = k_base + dsc[3];
    for (int j = tid; j < n; j += kThreads) K[j] = kin[j];
  }
  if (tid == 0) {
    s_fh[0] = INT_MAX;
    s_fh[1] = INT_MAX;
  }

  int p = 0;
  while (!err) {
    __syncthreads();  // K and s_fh[p] are ready

    // 1. extension, one warp per diagonal
    for (int j = warp; j < n; j += kWarps) {
      const int kj = K[j];
      const int dj = d0 + j;
      int e = kj;
      bool h = false;
      if (!(kj >= tl || kj + dj >= ql)) {
        const int max_k = min(ql - dj, tl) - 1;
        for (int base = kj + 1;; base += 32) {
          const int kp = base + lane;
          const int qi = dj + kp;
          const bool eq = kp >= 0 && kp <= max_k && qi >= 0 && ts[kp] == qs[qi];
          const unsigned miss = __ballot_sync(0xffffffffu, !eq);
          if (miss) {
            e = base + __ffs(miss) - 2;
            break;
          }
        }
        const bool at_q = e + dj == ql - 1;
        const bool at_t = e == tl - 1;
        h = (at_q || at_t) && (is_ext || (at_q && at_t));
      }
      if (lane == 0) {
        E[j] = e;
        if (h) atomicMin(&s_fh[p], j);
      }
    }
    __syncthreads();  // E and s_fh[p] are complete

    // 2. first hit
    const int fh = s_fh[p];
    if (tid == 0) s_fh[p ^ 1] = INT_MAX;  // nobody reads it until the next step
    if (fh != INT_MAX) {
      for (int j = tid; j < fh; j += kThreads) K[j] = E[j];
      hit = 1;
      t_end = E[fh];
      q_end = E[fh] + d0 + fh;
      break;
    }

    // 3. next wave and band (every thread computes the same scalars)
    const int n2 = n + 2;
    const int nd0 = d0 - 1;
    const bool grow = bw < 0 || n < 2 * bw + 1;
    int mdb, xdb;
    if (is_ext) {
      mdb = -bw;
      xdb = bw;
    } else {
      mdb = ql < tl ? ql - tl - bw : tl - ql - bw;
      xdb = tl > ql ? tl - ql + bw : ql - tl + bw;
    }
    const int min_d = grow ? -tl : max(mdb, -tl);
    const int max_d = grow ? ql : max(xdb, ql);
    const int stt = min(max(min_d - nd0, 0), n2);
    const int rtrim = min(max(nd0 + n2 - 1 - max_d, 0), n2);
    const int n_new = n2 - stt - rtrim;
    if (n_new < 1 || n_new > S) {
      err = 2;
      break;
    }
    for (int j = tid; j < n_new; j += kThreads) {
      const int i = j + stt;  // index in the untrimmed wave of n + 2
      int v = -kBig;
      if (i >= 2) v = E[i - 2];                           // insertion
      if (i >= 1 && i - 1 < n) v = max(v, E[i - 1] + 1);  // mismatch
      if (i < n) v = max(v, E[i] + 1);                    // deletion
      K[j] = v;
    }
    n = n_new;
    d0 = nd0 + stt;
    score += 1;
    p ^= 1;
    if (bw >= 0 && score > bw) break;
  }
  __syncthreads();  // K is final

  int32_t* ok = ok_base + dsc[5];
  for (int j = tid; j < S; j += kThreads) ok[j] = (!err && j < n) ? K[j] : -kBig;
  if (tid == 0) {
    int32_t* om = om_base + dsc[4];
    om[0] = score;
    om[1] = d0;
    om[2] = n;
    om[3] = hit;
    om[4] = t_end;
    om[5] = q_end;
    om[6] = err;
    om[7] = 0;
  }
}

template <int kThreads>
int launch(const void* desc, const void* ts, const void* qs, const void* meta, const void* k,
           void* out_meta, void* out_k, void* scratch, int B, int smem_bytes, void* stream) {
  static int opted = 48 * 1024;
  if (smem_bytes > opted) {
    cudaError_t e = cudaFuncSetAttribute(wf_ed_kernel<kThreads>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
    opted = smem_bytes;
  }
  wf_ed_kernel<kThreads><<<B, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(desc), static_cast<const uint8_t*>(ts),
      static_cast<const uint8_t*>(qs), static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(k), static_cast<int32_t*>(out_meta),
      static_cast<int32_t*>(out_k), static_cast<int32_t*>(scratch));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block may opt into on the current device.
int wf_ed_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return bytes;
}

// B blocks of `threads` (128 or 256) threads, each with smem_bytes of
// dynamic shared memory (at least the largest shared-memory item's need);
// scratch may be null only when no descriptor names a scratch offset.
int wf_ed_launch(const void* desc, const void* ts, const void* qs, const void* meta,
                 const void* k, void* out_meta, void* out_k, void* scratch, int B,
                 int smem_bytes, int threads, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (threads == 128)
    return launch<128>(desc, ts, qs, meta, k, out_meta, out_k, scratch, B, smem_bytes, stream);
  if (threads == 256)
    return launch<256>(desc, ts, qs, meta, k, out_meta, out_k, scratch, B, smem_bytes, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
