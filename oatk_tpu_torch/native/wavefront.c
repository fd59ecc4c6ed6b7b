/* Banded Landau-Vishkin wavefront edit distance core (native).
 *
 * Semantics are the stepwise-restart wavefront of
 * oatk_tpu/kernels/wavefront.py (itself validated bit-for-bit against
 * the reference levdist.c:48-440 harness): diagonals extend in order,
 * the first end hit aborts the step with the hitting diagonal left
 * unextended, and the caller may grow the query between calls.
 *
 * State is caller-owned so Python keeps snapshot/restore trivial:
 *   hdr = int64[5] {score, t_end_raw, q_end_raw, d0, n}
 *   k   = int64[cap] best target positions per diagonal (d = d0 + j)
 * Returns 1 when an end was reached (t_end/q_end raw set), 0 when the
 * band was exceeded, -1 when cap is too small (caller must regrow).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

int64_t wf_ed_core_native(const uint8_t *ts, int64_t tl,
                          const uint8_t *qs, int64_t ql,
                          int64_t is_ext, int64_t bw,
                          int64_t *hdr, int64_t *k, int64_t cap)
{
    int64_t score = hdr[0];
    int64_t d0 = hdr[3];
    int64_t n = hdr[4];
    int64_t stack_nk[4096];
    int64_t *nk = stack_nk;
    int64_t nk_cap = 4096;

    for (;;) {
        /* ---- one wavefront step ---- */
        int64_t j;
        for (j = 0; j < n; ++j) {
            int64_t kj = k[j], dj = d0 + j;
            if (kj >= tl || kj + dj >= ql) continue;
            /* extend along exact matches */
            int64_t max_k = (ql - dj < tl ? ql - dj : tl) - 1;
            int64_t kk = kj;
            const uint8_t *t = ts + kk + 1, *q = qs + dj + kk + 1;
            int64_t span = max_k - kk;
            while (span > 0 && *t == *q) { ++t; ++q; --span; ++kk; }
            if (kk + dj == ql - 1 || kk == tl - 1) {
                if (is_ext || (kk + dj == ql - 1 && kk == tl - 1)) {
                    hdr[0] = score; hdr[1] = kk; hdr[2] = kk + dj;
                    hdr[3] = d0; hdr[4] = n;
                    if (nk != stack_nk) free(nk);
                    return 1;
                }
            }
            k[j] = kk;
        }

        /* ---- next wave ---- */
        if (n + 2 > nk_cap) {
            nk_cap = (n + 2) * 2;
            int64_t *p = (int64_t *)malloc(nk_cap * sizeof(int64_t));
            if (!p) { if (nk != stack_nk) free(nk); return -1; }
            if (nk != stack_nk) free(nk);
            nk = p;
        }
        int64_t nd0 = d0 - 1;
        nk[0] = k[0] + 1;
        nk[1] = ((n == 1 || k[0] > k[1]) ? k[0] : k[1]) + 1;
        for (j = 2; j < n; ++j)
            nk[j] = max64(k[j - 2], max64(k[j - 1] + 1, k[j] + 1));
        if (n >= 2)
            nk[n] = max64(k[n - 2], k[n - 1] + 1);
        nk[n + 1] = k[n - 1];

        /* ---- band trimming ---- */
        int64_t stt = 0, en = n + 2;
        if (bw < 0 || n < 2 * bw + 1) {
            if (nd0 < -tl) ++stt;
            if (nd0 + n + 1 > ql) --en;
        } else {
            int64_t min_d, max_d;
            if (is_ext) { min_d = -bw; max_d = bw; }
            else {
                min_d = (ql < tl) ? (ql - tl - bw) : (tl - ql - bw);
                max_d = (tl > ql) ? (tl - ql + bw) : (ql - tl + bw);
            }
            min_d = max64(min_d, -tl);
            max_d = max64(max_d, ql); /* reference quirk kept verbatim */
            while (nd0 + stt < min_d) ++stt;
            while (nd0 + en - 1 > max_d) --en;
        }
        n = en - stt;
        d0 = nd0 + stt;
        if (n > cap) {  /* caller buffer too small: report, don't corrupt */
            if (nk != stack_nk) free(nk);
            hdr[0] = score; hdr[3] = d0; hdr[4] = 0;
            return -1;
        }
        memcpy(k, nk + stt, n * sizeof(int64_t));

        ++score;
        if (bw >= 0 && score > bw) {
            hdr[0] = score; hdr[1] = -1; hdr[2] = -1;
            hdr[3] = d0; hdr[4] = n;
            if (nk != stack_nk) free(nk);
            return 0;
        }
    }
}
