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
// Contract (the same as wf_ed_core_pallas_batch, :169-203):
//   ts       uint8 [B, TL], qs uint8 [B, QL]  (TL >= tl, QL >= ql, any width)
//   meta     int32 [B, 8]  = tl, ql, is_ext, bw, score, d0, n, 0
//   k        int32 [B, D_cap], k[:n] the wavefront of diagonals d0..d0+n-1
//   out_meta int32 [B, 8]  = score, d0, n, hit, t_end_raw, q_end_raw, err, 0
//   out_k    int32 [B, D_cap], out_k[:n] the new wavefront, -BIG after it
// err is 0, or 1 when the input does not fit (n outside [1, D_cap], tl > TL
// or ql > QL), or 2 when a wave would leave [1, D_cap]; out_k is then all
// -BIG.  The caller sizes D_cap so that 2 cannot happen (kernels/wf_ed.py).
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
// One block per alignment (grid = B), 256 threads.  ts, qs, K and E live
// in dynamic shared memory (8 * D_cap + TL + QL bytes: about 110 KB at the
// largest error block measured at k=1001, tl 5,669 and ql 6,542; above
// 48 KB through cudaFuncSetAttribute).  Where that exceeds the card's
// per-block limit the same kernel reads ts/qs from global memory and
// keeps K/E in a global scratch buffer the caller allocates: no refusal
// and no host fallback.
//
// Bound: latency, not bytes or operations.  Error correction's graph DFS
// calls the core once per branch extension, each call depending on the
// one before, with about 1-15 KB in: one small launch, a few tens of
// wavefront steps, and a read-back.  Batching the DFS leaves of many
// reads, keeping the state resident on the card, and CUDA graphs are the
// ways to make it fast, and later work.
//
// Entry points, a plain C interface bound with ctypes: wf_ed_smem_limit()
// and wf_ed_launch().  The launch allocates nothing, synchronises nothing,
// and returns cudaGetLastError().
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 0x3FFFFFFF;

__global__ void __launch_bounds__(kThreads)
wf_ed_kernel(const uint8_t* __restrict__ ts_g, const uint8_t* __restrict__ qs_g,
             const int32_t* __restrict__ meta_g, const int32_t* __restrict__ k_g,
             int32_t* __restrict__ out_meta, int32_t* __restrict__ out_k,
             int32_t* __restrict__ scratch, int TL, int QL, int D_cap, int in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_fh[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int32_t* m = meta_g + (size_t)b * 8;
  const int tl = m[0], ql = m[1], is_ext = m[2], bw = m[3];
  int score = m[4], d0 = m[5], n = m[6];
  int hit = 0, t_end = -1, q_end = -1;
  int err = (n < 1 || n > D_cap || tl < 0 || ql < 0 || tl > TL || ql > QL) ? 1 : 0;

  const uint8_t* ts;
  const uint8_t* qs;
  int32_t* K;
  int32_t* E;
  if (in_smem) {
    K = reinterpret_cast<int32_t*>(smem);
    E = K + D_cap;
    uint8_t* ts_s = reinterpret_cast<uint8_t*>(E + D_cap);
    uint8_t* qs_s = ts_s + TL;
    if (!err) {
      for (int i = tid; i < tl; i += kThreads) ts_s[i] = ts_g[(size_t)b * TL + i];
      for (int i = tid; i < ql; i += kThreads) qs_s[i] = qs_g[(size_t)b * QL + i];
    }
    ts = ts_s;
    qs = qs_s;
  } else {
    K = scratch + (size_t)b * 2 * D_cap;
    E = K + D_cap;
    ts = ts_g + (size_t)b * TL;
    qs = qs_g + (size_t)b * QL;
  }
  if (!err) {
    for (int j = tid; j < n; j += kThreads) K[j] = k_g[(size_t)b * D_cap + j];
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
    if (n_new < 1 || n_new > D_cap) {
      err = 2;
      break;
    }
    for (int j = tid; j < n_new; j += kThreads) {
      const int i = j + stt;  // index in the untrimmed wave of n + 2
      int v = -kBig;
      if (i >= 2) v = E[i - 2];                       // insertion
      if (i >= 1 && i - 1 < n) v = max(v, E[i - 1] + 1);  // mismatch
      if (i < n) v = max(v, E[i] + 1);                // deletion
      K[j] = v;
    }
    n = n_new;
    d0 = nd0 + stt;
    score += 1;
    p ^= 1;
    if (bw >= 0 && score > bw) break;
  }
  __syncthreads();  // K is final

  int32_t* ok = out_k + (size_t)b * D_cap;
  for (int j = tid; j < D_cap; j += kThreads) ok[j] = (!err && j < n) ? K[j] : -kBig;
  if (tid == 0) {
    int32_t* om = out_meta + (size_t)b * 8;
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

// smem_bytes > 0: stage in that much dynamic shared memory (at least
// 8 * D_cap + TL + QL); 0: the global route, scratch int32 [B, 2, D_cap].
int wf_ed_launch(const void* ts, const void* qs, const void* meta, const void* k,
                 void* out_meta, void* out_k, void* scratch, int B, int TL, int QL,
                 int D_cap, int smem_bytes, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (smem_bytes == 0 && scratch == nullptr) return cudaErrorInvalidValue;
  static int opted = 48 * 1024;
  if (smem_bytes > opted) {
    cudaError_t e = cudaFuncSetAttribute(wf_ed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
    if (e != cudaSuccess) return e;
    opted = smem_bytes;
  }
  wf_ed_kernel<<<B, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ts), static_cast<const uint8_t*>(qs),
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(k),
      static_cast<int32_t*>(out_meta), static_cast<int32_t*>(out_k),
      static_cast<int32_t*>(scratch), TL, QL, D_cap, smem_bytes > 0 ? 1 : 0);
  return cudaGetLastError();
}

}  // extern "C"
