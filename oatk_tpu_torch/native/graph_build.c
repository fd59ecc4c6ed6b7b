/* Native dup-free arc construction for make_syncmer_graph.
 *
 * The syncmer graph's arc table is a deterministic function of the
 * sorted unique canonical pair keys (pk = s0<<32|s1) and their counts
 * (reference builds the same table arc-by-arc with asmg_arc_add +
 * asmg_finalize, syncasm.c:116-368 + asmg.c).  The Python fast path
 * (asm/scg.py dup_free branch) materializes comp keys, argsorts the
 * fwd+comp union and scatters six 8-byte arrays through the inverse
 * permutation -- ~1.3 s/Gbp of single-thread NumPy.  This C version
 * exploits that pk is ALREADY sorted: radix-sort only the comp keys,
 * then a threaded two-list merge (co-rank partitioned) writes every
 * output row exactly once, in place, in parallel.
 *
 *   graph_build_arcs(pk, sc, nf, av, aw, acov, acomp, partner, &total, nt)
 *     -> 0 built (dup-free), 1 duplicate keys seen (caller falls back
 *        to the generic finalize path), 2 allocation failure.
 *
 * Output arrays are caller-allocated with capacity 2*nf (total <= 2*nf).
 * Semantics mirror the Python construction bit for bit: fwd arcs carry
 * acomp=0 (palindromes acomp=1, partner=self), comp arcs acomp=1,
 * partner links fwd<->comp rows.
 */
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef int64_t i64;
typedef uint64_t u64;
typedef uint8_t u8;

extern int radix_argsort_u64(const u64 *keys, i64 n, i64 *idx_out, int nt);

#define MAXT 16

typedef struct {
    const u64 *pk;
    const i64 *sc;
    i64 nf;
    const u64 *ck;
    const i64 *cs;
    i64 nc;
    u64 *av, *aw;
    i64 *acov;
    u8 *acomp;
    i64 *partner;
    i64 *posF, *posC;
    i64 lo, hi;      /* input ranges (phase A / dup / partner) */
    i64 cnt;         /* phase A count result */
    u64 *ck_buf;     /* phase A fill target */
    i64 *cs_buf;
    i64 out_lo, out_hi, i0, j0; /* merge partition */
    int dup;
} job_t;

static void *count_comp_worker(void *arg) {
    job_t *j = (job_t *)arg;
    i64 c = 0;
    for (i64 i = j->lo; i < j->hi; i++) {
        u64 key = j->pk[i];
        u64 s0 = key >> 32, s1 = key & 0xffffffffu;
        c += ((s1 ^ 1) != s0);
    }
    j->cnt = c;
    return NULL;
}

static void *fill_comp_worker(void *arg) {
    job_t *j = (job_t *)arg;
    u64 *ck = j->ck_buf;
    i64 *cs = j->cs_buf;
    i64 w = 0;
    for (i64 i = j->lo; i < j->hi; i++) {
        u64 key = j->pk[i];
        u64 s0 = key >> 32, s1 = key & 0xffffffffu;
        if ((s1 ^ 1) != s0) {
            ck[w] = ((s1 ^ 1) << 32) | (s0 ^ 1);
            cs[w] = i;
            w++;
        }
    }
    return NULL;
}

static void *dup_worker(void *arg) {
    /* any comp key present in pk => duplicate (each half is internally
     * unique: pk by construction, comp keys injectively derived) */
    job_t *j = (job_t *)arg;
    const u64 *pk = j->pk;
    i64 nf = j->nf;
    for (i64 i = j->lo; i < j->hi; i++) {
        u64 k = j->ck[i];
        i64 lo = 0, hi = nf;
        while (lo < hi) {
            i64 mid = (lo + hi) >> 1;
            if (pk[mid] < k)
                lo = mid + 1;
            else
                hi = mid;
        }
        if (lo < nf && pk[lo] == k) {
            j->dup = 1;
            return NULL;
        }
    }
    return NULL;
}

static void corank(i64 m, const u64 *a, i64 na, const u64 *b, i64 nb,
                   i64 *ai, i64 *bj) {
    /* strict total order (no ties: dup check ran first) */
    i64 lo = m > nb ? m - nb : 0;
    i64 hi = m < na ? m : na;
    while (lo < hi) {
        i64 i = (lo + hi) >> 1;
        i64 j = m - i;
        if (j > 0 && a[i] < b[j - 1])
            lo = i + 1;
        else if (i > 0 && j < nb && b[j] < a[i - 1])
            hi = i;
        else {
            lo = i;
            break;
        }
    }
    *ai = lo;
    *bj = m - lo;
}

static void *merge_worker(void *arg) {
    job_t *j = (job_t *)arg;
    const u64 *pk = j->pk;
    const u64 *ck = j->ck;
    const i64 *cs = j->cs;
    const i64 *sc = j->sc;
    i64 nf = j->nf, nc = j->nc;
    i64 i = j->i0, jj = j->j0;
    for (i64 p = j->out_lo; p < j->out_hi; p++) {
        int take_fwd = (jj >= nc) || (i < nf && pk[i] < ck[jj]);
        if (take_fwd) {
            u64 key = pk[i];
            u64 s0 = key >> 32, s1 = key & 0xffffffffu;
            j->av[p] = s0;
            j->aw[p] = s1;
            j->acov[p] = sc[i];
            int pal = ((s1 ^ 1) == s0);
            j->acomp[p] = (u8)pal;
            if (pal) j->partner[p] = p;
            j->posF[i] = p;
            i++;
        } else {
            i64 src = cs[jj];
            u64 key = pk[src];
            u64 s0 = key >> 32, s1 = key & 0xffffffffu;
            j->av[p] = s1 ^ 1;
            j->aw[p] = s0 ^ 1;
            j->acov[p] = sc[src];
            j->acomp[p] = 1;
            j->posC[jj] = p;
            jj++;
        }
    }
    return NULL;
}

static void *partner_worker(void *arg) {
    job_t *j = (job_t *)arg;
    for (i64 x = j->lo; x < j->hi; x++) {
        i64 pf = j->posF[j->cs[x]];
        i64 pc = j->posC[x];
        j->partner[pc] = pf;
        j->partner[pf] = pc;
    }
    return NULL;
}

static void run_jobs(void *(*fn)(void *), job_t *jobs, int nt) {
    pthread_t th[MAXT];
    for (int t = 1; t < nt; t++) pthread_create(&th[t], NULL, fn, &jobs[t]);
    fn(&jobs[0]);
    for (int t = 1; t < nt; t++) pthread_join(th[t], NULL);
}

typedef struct {
    const u64 *av;
    const i64 *partner;
    i64 *idx_p, *idx_n;
    u64 *alink;
    i64 n, lo, hi, cnt, base;
} idx_job_t;

static void *index_worker(void *arg) {
    /* av is sorted; each thread owns the runs STARTING in its range */
    idx_job_t *j = (idx_job_t *)arg;
    const u64 *av = j->av;
    i64 n = j->n;
    for (i64 i = j->lo; i < j->hi; i++) {
        if (i == 0 || av[i] != av[i - 1]) {
            i64 e = i + 1;
            while (e < n && av[e] == av[i]) e++;
            j->idx_p[av[i]] = i;
            j->idx_n[av[i]] = e - i;
        }
    }
    return NULL;
}

static void *rank_count_worker(void *arg) {
    idx_job_t *j = (idx_job_t *)arg;
    i64 c = 0;
    for (i64 i = j->lo; i < j->hi; i++) c += (i <= j->partner[i]);
    j->cnt = c;
    return NULL;
}

static void *rank_fill_worker(void *arg) {
    idx_job_t *j = (idx_job_t *)arg;
    i64 r = j->base;
    for (i64 i = j->lo; i < j->hi; i++)
        if (i <= j->partner[i]) j->alink[i] = (u64)r++;
    return NULL;
}

static void *link_copy_worker(void *arg) {
    idx_job_t *j = (idx_job_t *)arg;
    for (i64 i = j->lo; i < j->hi; i++)
        if (i > j->partner[i]) j->alink[i] = j->alink[j->partner[i]];
    return NULL;
}

/* Combined arc_index + shrink_link_id for bulk-built graphs (av sorted,
 * complement partners known): idx_p/idx_n get each vertex's arc run,
 * alink the rank of each pair's smaller member -- identical to the
 * Python fast paths in graph/asmg.py, without their ~5 full-size NumPy
 * temporaries (first-touch page faults dominate those at Gbp scale). */
int graph_index_link(const u64 *av, const i64 *partner, i64 n, i64 n_dir,
                     i64 *idx_p, i64 *idx_n, u64 *alink, int nt) {
    (void)n_dir;
    if (nt < 1) nt = 1;
    if (nt > MAXT) nt = MAXT;
    if (n == 0) return 0;
    idx_job_t jobs[MAXT];
    memset(jobs, 0, sizeof(jobs));
    for (int t = 0; t < nt; t++) {
        jobs[t].av = av;
        jobs[t].partner = partner;
        jobs[t].idx_p = idx_p;
        jobs[t].idx_n = idx_n;
        jobs[t].alink = alink;
        jobs[t].n = n;
        jobs[t].lo = n * t / nt;
        jobs[t].hi = n * (t + 1) / nt;
    }
    {
        pthread_t th[MAXT];
        for (int t = 1; t < nt; t++)
            pthread_create(&th[t], NULL, index_worker, &jobs[t]);
        index_worker(&jobs[0]);
        for (int t = 1; t < nt; t++) pthread_join(th[t], NULL);
        for (int t = 1; t < nt; t++)
            pthread_create(&th[t], NULL, rank_count_worker, &jobs[t]);
        rank_count_worker(&jobs[0]);
        for (int t = 1; t < nt; t++) pthread_join(th[t], NULL);
        i64 base = 0;
        for (int t = 0; t < nt; t++) {
            jobs[t].base = base;
            base += jobs[t].cnt;
        }
        for (int t = 1; t < nt; t++)
            pthread_create(&th[t], NULL, rank_fill_worker, &jobs[t]);
        rank_fill_worker(&jobs[0]);
        for (int t = 1; t < nt; t++) pthread_join(th[t], NULL);
        for (int t = 1; t < nt; t++)
            pthread_create(&th[t], NULL, link_copy_worker, &jobs[t]);
        link_copy_worker(&jobs[0]);
        for (int t = 1; t < nt; t++) pthread_join(th[t], NULL);
    }
    return 0;
}

int graph_build_arcs(const u64 *pk, const i64 *sc, i64 nf, u64 *av, u64 *aw,
                     i64 *acov, u8 *acomp, i64 *partner, i64 *total_out,
                     int nt) {
    if (nt < 1) nt = 1;
    if (nt > MAXT) nt = MAXT;
    if (nf == 0) {
        *total_out = 0;
        return 0;
    }
    job_t jobs[MAXT];
    memset(jobs, 0, sizeof(jobs));
    for (int t = 0; t < nt; t++) {
        jobs[t].pk = pk;
        jobs[t].sc = sc;
        jobs[t].nf = nf;
        jobs[t].lo = nf * t / nt;
        jobs[t].hi = nf * (t + 1) / nt;
    }
    run_jobs(count_comp_worker, jobs, nt);
    i64 nc = 0, off[MAXT];
    for (int t = 0; t < nt; t++) {
        off[t] = nc;
        nc += jobs[t].cnt;
    }
    u64 *ck0 = NULL, *ck = NULL;
    i64 *cs0 = NULL, *cs = NULL, *perm = NULL;
    int rc = 2;
    if (nc) {
        ck0 = malloc((size_t)nc * 8);
        cs0 = malloc((size_t)nc * 8);
        ck = malloc((size_t)nc * 8);
        cs = malloc((size_t)nc * 8);
        perm = malloc((size_t)nc * 8);
        i64 *posF = malloc((size_t)nf * 8);
        i64 *posC = malloc((size_t)nc * 8);
        if (!ck0 || !cs0 || !ck || !cs || !perm || !posF || !posC) {
            free(posF);
            free(posC);
            goto out;
        }
        for (int t = 0; t < nt; t++) {
            jobs[t].ck_buf = ck0 + off[t];
            jobs[t].cs_buf = cs0 + off[t];
        }
        run_jobs(fill_comp_worker, jobs, nt);
        if (radix_argsort_u64(ck0, nc, perm, nt) != 0) {
            free(posF);
            free(posC);
            goto out;
        }
        for (i64 x = 0; x < nc; x++) {
            ck[x] = ck0[perm[x]];
            cs[x] = cs0[perm[x]];
        }
        for (int t = 0; t < nt; t++) {
            jobs[t].ck = ck;
            jobs[t].cs = cs;
            jobs[t].nc = nc;
            jobs[t].lo = nc * t / nt;
            jobs[t].hi = nc * (t + 1) / nt;
            jobs[t].dup = 0;
        }
        run_jobs(dup_worker, jobs, nt);
        for (int t = 0; t < nt; t++)
            if (jobs[t].dup) {
                rc = 1;
                free(posF);
                free(posC);
                goto out;
            }
        i64 total = nf + nc;
        for (int t = 0; t < nt; t++) {
            jobs[t].av = av;
            jobs[t].aw = aw;
            jobs[t].acov = acov;
            jobs[t].acomp = acomp;
            jobs[t].partner = partner;
            jobs[t].posF = posF;
            jobs[t].posC = posC;
            jobs[t].out_lo = total * t / nt;
            jobs[t].out_hi = total * (t + 1) / nt;
            corank(jobs[t].out_lo, pk, nf, ck, nc, &jobs[t].i0, &jobs[t].j0);
        }
        run_jobs(merge_worker, jobs, nt);
        for (int t = 0; t < nt; t++) {
            jobs[t].lo = nc * t / nt;
            jobs[t].hi = nc * (t + 1) / nt;
        }
        run_jobs(partner_worker, jobs, nt);
        *total_out = total;
        rc = 0;
        free(posF);
        free(posC);
    } else {
        /* every pair is palindromic */
        i64 *posF = malloc((size_t)nf * 8);
        if (!posF) goto out;
        for (int t = 0; t < nt; t++) {
            jobs[t].av = av;
            jobs[t].aw = aw;
            jobs[t].acov = acov;
            jobs[t].acomp = acomp;
            jobs[t].partner = partner;
            jobs[t].posF = posF;
            jobs[t].ck = NULL;
            jobs[t].cs = NULL;
            jobs[t].nc = 0;
            jobs[t].out_lo = nf * t / nt;
            jobs[t].out_hi = nf * (t + 1) / nt;
            jobs[t].i0 = jobs[t].out_lo;
            jobs[t].j0 = 0;
        }
        run_jobs(merge_worker, jobs, nt);
        *total_out = nf;
        rc = 0;
        free(posF);
    }
out:
    free(ck0);
    free(cs0);
    free(ck);
    free(cs);
    free(perm);
    return rc;
}
