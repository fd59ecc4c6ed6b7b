/* Threaded stable LSD radix sort over 64-bit keys.
 *
 * The assembler sorts occurrence streams at every stage (global hash
 * sort for id assignment, adjacency pair counting, inverted-index
 * builds; the reference does the same with qsort/radix on 128-bit keys,
 * syncmer.c:1397-1451).  NumPy's 64-bit mergesort is the slowest host
 * stage at scale, so this provides:
 *
 *   radix_sort_u64(keys, n, nt)                 -- in-place value sort
 *   radix_argsort_u64(keys, n, idx_out, nt)     -- stable permutation
 *
 * Parallel scheme per 8-bit pass: each thread histograms a contiguous
 * chunk, a serial scan turns (bucket, thread) counts into scatter
 * bases, then each thread scatters its chunk in order -- chunk order +
 * in-chunk order preserved = stable.  Passes whose digit is constant
 * across all keys are skipped (common for high bytes).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <pthread.h>

typedef int64_t i64;
typedef uint64_t u64;

#define NB 256
#define MAXT 16

typedef struct {
    const u64 *src_k; const i64 *src_v;
    u64 *dst_k; i64 *dst_v;
    i64 lo, hi;
    int shift;
    i64 hist[NB];     /* filled in phase 1 */
    i64 base[NB];     /* scatter bases, filled between phases */
} pass_job_t;

static void *hist_worker(void *arg) {
    pass_job_t *j = (pass_job_t *)arg;
    memset(j->hist, 0, sizeof j->hist);
    const u64 *k = j->src_k;
    int sh = j->shift;
    for (i64 i = j->lo; i < j->hi; i++) j->hist[(k[i] >> sh) & 0xff]++;
    return NULL;
}

static void *scatter_worker(void *arg) {
    pass_job_t *j = (pass_job_t *)arg;
    const u64 *k = j->src_k; const i64 *v = j->src_v;
    u64 *dk = j->dst_k; i64 *dv = j->dst_v;
    int sh = j->shift;
    i64 base[NB];
    memcpy(base, j->base, sizeof base);
    if (v) {
        for (i64 i = j->lo; i < j->hi; i++) {
            int b = (int)((k[i] >> sh) & 0xff);
            i64 p = base[b]++;
            dk[p] = k[i]; dv[p] = v[i];
        }
    } else {
        for (i64 i = j->lo; i < j->hi; i++) {
            int b = (int)((k[i] >> sh) & 0xff);
            dk[base[b]++] = k[i];
        }
    }
    return NULL;
}

/* one radix pass; returns 1 if the pass was skipped (constant digit) */
static int radix_pass(const u64 *sk, const i64 *sv, u64 *dk, i64 *dv,
                      i64 n, int shift, int nt, pass_job_t *jobs) {
    for (int t = 0; t < nt; t++) {
        jobs[t].src_k = sk; jobs[t].src_v = sv;
        jobs[t].dst_k = dk; jobs[t].dst_v = dv;
        jobs[t].lo = n * t / nt; jobs[t].hi = n * (t + 1) / nt;
        jobs[t].shift = shift;
    }
    if (nt == 1) {
        hist_worker(&jobs[0]);
    } else {
        pthread_t tids[MAXT]; int sp = 0;
        for (int t = 0; t < nt; t++)
            if (pthread_create(&tids[t], NULL, hist_worker, &jobs[t]) == 0) sp++;
            else { hist_worker(&jobs[t]); }
        for (int t = 0; t < sp; t++) pthread_join(tids[t], NULL);
    }
    /* skip constant-digit passes */
    i64 tot[NB]; memset(tot, 0, sizeof tot);
    for (int t = 0; t < nt; t++)
        for (int b = 0; b < NB; b++) tot[b] += jobs[t].hist[b];
    int nz = 0;
    for (int b = 0; b < NB && nz < 2; b++) if (tot[b]) nz++;
    if (nz < 2) return 1;
    /* scatter bases: bucket-major, thread-minor */
    i64 run = 0;
    for (int b = 0; b < NB; b++)
        for (int t = 0; t < nt; t++) { jobs[t].base[b] = run; run += jobs[t].hist[b]; }
    if (nt == 1) {
        scatter_worker(&jobs[0]);
    } else {
        pthread_t tids[MAXT]; int sp = 0;
        for (int t = 0; t < nt; t++)
            if (pthread_create(&tids[t], NULL, scatter_worker, &jobs[t]) == 0) sp++;
            else { scatter_worker(&jobs[t]); }
        for (int t = 0; t < sp; t++) pthread_join(tids[t], NULL);
    }
    return 0;
}

/* keys: modified in place (sorted).  idx: NULL, or an int64 array of n
 * entries filled with the stable argsort permutation. */
static int radix_core(u64 *keys, i64 n, i64 *idx, int nt) {
    if (n <= 1) { if (idx && n == 1) idx[0] = 0; return 0; }
    if (nt < 1) nt = 1;
    if (nt > MAXT) nt = MAXT;
    if (n < (i64)1 << 16) nt = 1;
    u64 *kbuf = (u64 *)malloc((size_t)n * sizeof(u64));
    i64 *vbuf = idx ? (i64 *)malloc((size_t)n * sizeof(i64)) : NULL;
    if (!kbuf || (idx && !vbuf)) { free(kbuf); free(vbuf); return -1; }
    if (idx) for (i64 i = 0; i < n; i++) idx[i] = i;
    pass_job_t *jobs = (pass_job_t *)malloc(sizeof(pass_job_t) * (size_t)nt);
    if (!jobs) { free(kbuf); free(vbuf); return -1; }
    u64 *ka = keys, *kb = kbuf;
    i64 *va = idx, *vb = vbuf;
    for (int pass = 0; pass < 8; pass++) {
        if (!radix_pass(ka, va, kb, vb, n, pass * 8, nt, jobs)) {
            u64 *tk = ka; ka = kb; kb = tk;
            i64 *tv = va; va = vb; vb = tv;
        }
    }
    if (ka != keys) {
        memcpy(keys, ka, (size_t)n * sizeof(u64));
        if (idx) memcpy(idx, va, (size_t)n * sizeof(i64));
    }
    free(kbuf); free(vbuf); free(jobs);
    return 0;
}

int radix_sort_u64(u64 *keys, i64 n, int nt) {
    return radix_core(keys, n, NULL, nt);
}

/* keys are NOT modified: sorts a scratch copy, emits the permutation */
int radix_argsort_u64(const u64 *keys, i64 n, i64 *idx_out, int nt) {
    u64 *tmp = (u64 *)malloc((size_t)(n > 0 ? n : 1) * sizeof(u64));
    if (!tmp) return -1;
    memcpy(tmp, keys, (size_t)n * sizeof(u64));
    int r = radix_core(tmp, n, idx_out, nt);
    free(tmp);
    return r;
}
