/* Native read->graph alignment chaining + LCS block matching.
 *
 * C port of the per-read host loops of oatk_tpu/asm/align.py
 * (_align_one: fragment construction from sorted anchors, exact-overlap
 * chaining across graph arcs, multi-optimal backtrace) and
 * oatk_tpu/asm/coverage.py (_find_lcs), which together dominate the
 * post-extraction host wall clock.  Semantics (iteration order, tie
 * handling, stable sorts) replicate the Python reference exactly; the
 * Python implementations remain as fallbacks and as the oracle for the
 * randomized equivalence tests.
 *
 * Reads are independent, so the batch runs on a dynamic work-stealing
 * thread pool (the kt_for analogue, reference/kthread.c:48-65;
 * reference threads the same stage at alignment.c:636-676).  Results
 * land in per-read slots and merge in read order, so the output is
 * bit-identical to the single-threaded run.
 *
 * Reference behavior: reference/alignment.c:159-691 (chaining),
 * reference/syncasm.c:1750-1832 (LCS blocks).
 */
#include <pthread.h>
#include <stdatomic.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef int64_t i64;
typedef uint64_t u64;

/* ---------------- arc lookup: sorted (v<<32|w) keys ---------------- */

static i64 arc_lookup(const u64 *keys, const i64 *vals, i64 n, u64 key) {
    i64 lo = 0, hi = n;
    while (lo < hi) {
        i64 mid = (lo + hi) >> 1;
        if (keys[mid] < key) lo = mid + 1; else hi = mid;
    }
    if (lo < n && keys[lo] == key) return vals[lo];
    return -1;
}

/* ---------------- per-read fragment state ---------------- */

typedef struct {
    i64 uid, u_beg, u_end, s_beg, s_end, s_cnt;
    i64 score0, score;
    i64 prev_head;   /* index into prev pool, -1 = none */
    i64 orig;        /* append order for stable sort */
} frag_t;

typedef struct { i64 to, next; } prevlink_t;

typedef struct {
    frag_t *frags;
    prevlink_t *pool;
    i64 n_pool, cap_pool;
} fragctx_t;

static int push_prev(fragctx_t *c, i64 b, i64 a) {
    if (c->n_pool == c->cap_pool) {
        c->cap_pool = c->cap_pool ? c->cap_pool * 2 : 64;
        prevlink_t *np = (prevlink_t *)realloc(c->pool, c->cap_pool * sizeof(prevlink_t));
        if (!np) return -1;
        c->pool = np;
    }
    /* append at TAIL to preserve python list.append order */
    i64 idx = c->n_pool++;
    c->pool[idx].to = a;
    c->pool[idx].next = -1;
    i64 h = c->frags[b].prev_head;
    if (h < 0) c->frags[b].prev_head = idx;
    else {
        while (c->pool[h].next >= 0) h = c->pool[h].next;
        c->pool[h].next = idx;
    }
    return 0;
}

static int frag_cmp(const void *pa, const void *pb) {
    const frag_t *a = (const frag_t *)pa, *b = (const frag_t *)pb;
    if (a->s_beg != b->s_beg) return a->s_beg < b->s_beg ? -1 : 1;
    if (a->s_end != b->s_end) return a->s_end < b->s_end ? -1 : 1;
    return a->orig < b->orig ? -1 : (a->orig > b->orig ? 1 : 0);
}

/* ---------------- per-read result slot ---------------- */

typedef struct {
    i64 n_chain, n_frag, max_score;
    i64 *chain_len;  /* [n_chain] */
    i64 *frag6;      /* [n_frag * 6] */
} rres_t;

/* growable i64 buffer */
typedef struct { i64 *p; i64 n, cap; } ibuf_t;

static int ib_push(ibuf_t *b, i64 v) {
    if (b->n == b->cap) {
        i64 nc = b->cap ? b->cap * 2 : 256;
        i64 *np = (i64 *)realloc(b->p, nc * sizeof(i64));
        if (!np) return -1;
        b->p = np; b->cap = nc;
    }
    b->p[b->n++] = v;
    return 0;
}

/* ---------------- backtrace (multi-optimal) ---------------- */

typedef struct {
    const fragctx_t *c;
    i64 *acc; i64 n_acc;
    ibuf_t chain_frag;   /* flat fragment indices */
    ibuf_t chain_cut;    /* boundaries (chain_cut.p[0] = 0) */
    int oom;
} bt_t;

static void backtrace(bt_t *bt, i64 node) {
    if (bt->oom) return;
    bt->acc[bt->n_acc++] = node;
    i64 h = bt->c->frags[node].prev_head;
    if (h < 0) {
        for (i64 i = bt->n_acc - 1; i >= 0; i--)
            if (ib_push(&bt->chain_frag, bt->acc[i]) < 0) { bt->oom = 1; return; }
        if (ib_push(&bt->chain_cut, bt->chain_frag.n) < 0) { bt->oom = 1; return; }
    } else {
        for (; h >= 0; h = bt->c->pool[h].next) {
            backtrace(bt, bt->c->pool[h].to);
            bt->n_acc--;
            if (bt->oom) return;
        }
    }
}

/* ---------------- shared job + worker scratch ---------------- */

typedef struct {
    const i64 *uid_a, *upos_a, *spos_a, *aoff;
    i64 n_reads;
    const i64 *n_scm, *min_score, *ulen;
    const u64 *arc_key;
    const i64 *arc_aln;
    i64 n_arc;
    rres_t *slots;
    atomic_llong next;
    atomic_int err;
} job_t;

typedef struct {
    i64 *nxt; unsigned char *used; frag_t *frags; i64 *pos_v; i64 *acc;
    fragctx_t ctx;
    bt_t bt;
    i64 max_m;
} scratch_t;

static int align_one(job_t *jb, scratch_t *sc, i64 r) {
    rres_t *res = &jb->slots[r];
    res->n_chain = 0; res->n_frag = 0; res->max_score = 0;
    res->chain_len = NULL; res->frag6 = NULL;
    i64 a0 = jb->aoff[r], a1 = jb->aoff[r + 1];
    i64 m = a1 - a0;
    if (m == 0) return 0;
    const i64 *uid = jb->uid_a + a0, *upos = jb->upos_a + a0, *spos = jb->spos_a + a0;
    i64 *nxt = sc->nxt;
    unsigned char *used = sc->used;
    frag_t *frags = sc->frags;
    i64 *pos_v = sc->pos_v;
    memset(used, 0, m);
    for (i64 i = 0; i < m; i++) nxt[i] = -1;

    /* ---- fragment construction ---- */
    i64 mf = 0;
    sc->ctx.frags = frags;
    sc->ctx.n_pool = 0;
    i64 j = 0;
    while (j < m) {
        i64 u = uid[j], p = j;
        while (p < m && uid[p] == u) p++;
        i64 npos = 0;
        pos_v[npos++] = j;
        for (i64 t = j + 1; t < p; t++)
            if (spos[t] != spos[pos_v[npos - 1]]) pos_v[npos++] = t;
        pos_v[npos] = p;
        for (i64 k = 0; k + 2 <= npos; k++) {
            i64 s1 = pos_v[k], s2 = pos_v[k + 1];
            while (s1 < pos_v[k + 1]) {
                while (s2 < pos_v[k + 2] && upos[s2] <= upos[s1]) s2++;
                if (s2 < pos_v[k + 2] && upos[s2] > upos[s1]) {
                    nxt[s1] = s2;
                    used[s2] = 1;
                }
                s1++;
            }
        }
        for (i64 k = j; k < p; k++) {
            if (used[k]) continue;
            i64 s_cnt = 1, u_gap = 0, s_gap = 0, t = k;
            while (nxt[t] >= 0) {
                i64 n2 = nxt[t];
                i64 du = upos[n2] - upos[t]; if (du < 0) du = -du;
                i64 ds = spos[n2] - spos[t]; if (ds < 0) ds = -ds;
                u_gap += du - 1;
                s_gap += ds - 1;
                s_cnt++;
                t = n2;
            }
            if (s_cnt == 1) continue;
            i64 gap = u_gap > s_gap ? u_gap : s_gap;
            if (gap < 0) gap = 0;
            i64 score = s_cnt - gap;
            if (score >= 0) {
                frag_t *f = &frags[mf];
                f->uid = u; f->u_beg = upos[k]; f->u_end = upos[t];
                f->s_beg = spos[k]; f->s_end = spos[t];
                f->s_cnt = s_cnt; f->score0 = score; f->score = score;
                f->prev_head = -1; f->orig = mf;
                mf++;
                used[k] = 1;
                for (t = k; nxt[t] >= 0; ) { t = nxt[t]; used[t] = 1; }
            }
        }
        for (i64 k = j; k < p; k++) {
            if (!used[k] && nxt[k] < 0) {
                frag_t *f = &frags[mf];
                f->uid = u; f->u_beg = upos[k]; f->u_end = upos[k];
                f->s_beg = spos[k]; f->s_end = spos[k];
                f->s_cnt = 1; f->score0 = 1; f->score = 1;
                f->prev_head = -1; f->orig = mf;
                mf++;
            }
        }
        j = p;
    }
    if (mf == 0) return 0;

    qsort(frags, mf, sizeof(frag_t), frag_cmp);
    sc->ctx.n_pool = 0;
    for (i64 i = 0; i < mf; i++) frags[i].prev_head = -1;

    /* ---- chaining across arcs ---- */
    for (i64 a = 0; a < mf; a++) {
        frag_t *f = &frags[a];
        i64 pend = f->s_end;
        if (jb->ulen[f->uid >> 1] - f->u_end - 1 > 0) continue;
        i64 score = f->score;
        for (i64 b = a + 1; b < mf; b++) {
            frag_t *f1 = &frags[b];
            if (f1->u_beg > 0) continue;
            i64 aln = arc_lookup(jb->arc_key, jb->arc_aln, jb->n_arc,
                                 ((u64)f->uid << 32) | (u64)f1->uid);
            if (aln < 0) continue;
            i64 u_ovl = aln < pend + 1 ? aln : pend + 1;
            i64 p1 = f1->s_beg;
            if (p1 > pend + 1) break;
            if (p1 + u_ovl != pend + 1) continue;
            i64 score1 = score + f1->score0 - u_ovl;
            if (score1 <= score || score1 < f1->score ||
                (score1 == f1->score && f1->prev_head < 0))
                continue;
            if (score1 > f1->score) {
                f1->score = score1;
                f1->prev_head = -1;
            }
            if (push_prev(&sc->ctx, b, a) < 0) return -2;
        }
    }

    i64 max_score = frags[0].score;
    for (i64 i = 1; i < mf; i++)
        if (frags[i].score > max_score) max_score = frags[i].score;
    res->max_score = max_score;
    if (max_score < jb->min_score[r]) return 0;

    /* ---- multi-optimal backtrace + coverage filter ---- */
    bt_t *bt = &sc->bt;
    bt->c = &sc->ctx;
    bt->acc = sc->acc;
    bt->chain_frag.n = 0;
    bt->chain_cut.n = 0;
    bt->oom = 0;
    if (ib_push(&bt->chain_cut, 0) < 0) return -2;
    for (i64 a = 0; a < mf; a++) {
        if (frags[a].score == max_score) {
            bt->n_acc = 0;
            backtrace(bt, a);
        }
        if (bt->oom) return -2;
    }

    ibuf_t keep_len = {0}, keep_frag = {0};
    i64 nch = bt->chain_cut.n - 1;
    for (i64 c = 0; c < nch; c++) {
        i64 c0 = bt->chain_cut.p[c], c1 = bt->chain_cut.p[c + 1];
        i64 cov = 0;
        for (i64 t = c0; t < c1; t++) cov += frags[bt->chain_frag.p[t]].s_cnt;
        if (10 * cov < 9 * jb->n_scm[r]) continue;
        if (ib_push(&keep_len, c1 - c0) < 0) goto oom;
        for (i64 t = c0; t < c1; t++) {
            frag_t *f = &frags[bt->chain_frag.p[t]];
            if (ib_push(&keep_frag, f->uid) < 0 || ib_push(&keep_frag, f->u_beg) < 0 ||
                ib_push(&keep_frag, f->u_end) < 0 || ib_push(&keep_frag, f->s_beg) < 0 ||
                ib_push(&keep_frag, f->s_end) < 0 || ib_push(&keep_frag, f->s_cnt) < 0)
                goto oom;
        }
    }
    res->n_chain = keep_len.n;
    res->n_frag = keep_frag.n / 6;
    res->chain_len = keep_len.p;
    res->frag6 = keep_frag.p;
    return 0;
oom:
    free(keep_len.p); free(keep_frag.p);
    return -2;
}

static void *worker(void *arg) {
    job_t *jb = (job_t *)arg;
    /* per-worker scratch sized to the largest read */
    i64 max_m = 0;
    for (i64 r = 0; r < jb->n_reads; r++) {
        i64 m = jb->aoff[r + 1] - jb->aoff[r];
        if (m > max_m) max_m = m;
    }
    scratch_t sc;
    memset(&sc, 0, sizeof(sc));
    sc.max_m = max_m;
    sc.nxt = (i64 *)malloc((max_m ? max_m : 1) * sizeof(i64));
    sc.used = (unsigned char *)malloc(max_m ? max_m : 1);
    sc.frags = (frag_t *)malloc((max_m ? max_m : 1) * sizeof(frag_t));
    sc.pos_v = (i64 *)malloc((max_m + 2) * sizeof(i64));
    sc.acc = (i64 *)malloc((max_m + 1) * sizeof(i64));
    if (!sc.nxt || !sc.used || !sc.frags || !sc.pos_v || !sc.acc) {
        atomic_store(&jb->err, 2);
        goto done;
    }
    for (;;) {
        i64 r = atomic_fetch_add(&jb->next, 1);
        if (r >= jb->n_reads || atomic_load(&jb->err)) break;
        int rc = align_one(jb, &sc, r);
        if (rc < 0) { atomic_store(&jb->err, 2); break; }
    }
done:
    free(sc.nxt); free(sc.used); free(sc.frags); free(sc.pos_v); free(sc.acc);
    free(sc.ctx.pool);
    free(sc.bt.chain_frag.p); free(sc.bt.chain_cut.p);
    return NULL;
}

/* ---------------- main batched entry ----------------
 *
 * anchors are pre-sorted per read by (uid, spos, upos); reads delimited
 * by aoff.  Outputs: per-chain fragments (6 i64 fields), chain cuts per
 * read, per-read (max_score, n_chains_emitted).
 * Returns total fragments written, or -1 on capacity overflow (caller
 * regrows), -2 on malloc failure. */
i64 align_batch(
    const i64 *uid_a, const i64 *upos_a, const i64 *spos_a,
    const i64 *aoff, i64 n_reads,
    const i64 *n_scm, const i64 *min_score,
    const i64 *ulen,
    const u64 *arc_key, const i64 *arc_aln, i64 n_arc,
    i64 n_threads,
    /* outputs */
    i64 *out_frag,      /* [cap_frag * 6] uid,u_beg,u_end,s_beg,s_end,s_cnt */
    i64 *out_chain_cut, /* [cap_chain+1] frag boundaries (global) */
    i64 *out_read_cut,  /* [n_reads+1] chain boundaries per read */
    i64 *out_max_score, /* [n_reads] */
    i64 cap_frag, i64 cap_chain)
{
    job_t jb;
    jb.uid_a = uid_a; jb.upos_a = upos_a; jb.spos_a = spos_a; jb.aoff = aoff;
    jb.n_reads = n_reads;
    jb.n_scm = n_scm; jb.min_score = min_score; jb.ulen = ulen;
    jb.arc_key = arc_key; jb.arc_aln = arc_aln; jb.n_arc = n_arc;
    jb.slots = (rres_t *)calloc(n_reads ? n_reads : 1, sizeof(rres_t));
    if (!jb.slots) return -2;
    atomic_init(&jb.next, 0);
    atomic_init(&jb.err, 0);

    if (n_threads < 1) n_threads = 1;
    if (n_threads > 32) n_threads = 32;
    if (n_threads == 1) {
        worker(&jb);
    } else {
        pthread_t tids[32];
        i64 spawned = 0;
        for (i64 t = 0; t < n_threads; t++) {
            if (pthread_create(&tids[t], NULL, worker, &jb) != 0) break;
            spawned++;
        }
        if (spawned == 0) worker(&jb);
        for (i64 t = 0; t < spawned; t++) pthread_join(tids[t], NULL);
    }

    i64 ret;
    if (atomic_load(&jb.err)) { ret = -2; goto cleanup; }

    /* ---- ordered merge ---- */
    {
        i64 total_frag = 0, total_chain = 0;
        out_read_cut[0] = 0;
        out_chain_cut[0] = 0;
        ret = 0;
        for (i64 r = 0; r < n_reads; r++) {
            rres_t *res = &jb.slots[r];
            out_max_score[r] = res->max_score;
            if (total_chain + res->n_chain > cap_chain ||
                total_frag + res->n_frag > cap_frag) { ret = -1; break; }
            memcpy(out_frag + total_frag * 6, res->frag6,
                   (size_t)res->n_frag * 6 * sizeof(i64));
            for (i64 c = 0; c < res->n_chain; c++) {
                total_chain++;
                out_chain_cut[total_chain] =
                    out_chain_cut[total_chain - 1] + res->chain_len[c];
            }
            total_frag += res->n_frag;
            out_read_cut[r + 1] = total_chain;
        }
        if (ret == 0) ret = total_frag;
    }
cleanup:
    for (i64 r = 0; r < n_reads; r++) {
        free(jb.slots[r].chain_len);
        free(jb.slots[r].frag6);
    }
    free(jb.slots);
    return ret;
}

/* ---------------- multi-alignment blocks (coverage EM input) --------
 *
 * Port of coverage.py _make_ma_blocks for one read: per-alignment LCS
 * block lists (via find_lcs below) then the synchronized merge walk.
 * frag6 rows are (uid, u_beg, u_end, s_beg, s_end, s_cnt) as emitted by
 * align_batch; aln_cut delimits alignments.  Outputs n_match[] and the
 * uid matrix [n_blocks x n_aln].  Returns n_blocks, -1 on capacity,
 * -2 on alloc failure. */
i64 find_lcs(const i64 *, i64, const i64 *, i64, i64, i64 *, i64);

i64 ma_blocks(
    const i64 *scm, i64 n_scm_read,
    const i64 *frag6, const i64 *aln_cut, i64 n_aln,
    const u64 *va_flat, const i64 *va_off,
    i64 *out_nmatch, i64 *out_uids, i64 cap_blocks)
{
    if (n_aln == 0) return 0;
    /* per-alignment LCS block lists */
    i64 **blk = (i64 **)calloc(n_aln, sizeof(i64 *));
    i64 *nblk = (i64 *)calloc(n_aln, sizeof(i64));
    i64 *u_tmp = NULL, u_cap = 0;
    i64 ret = -2;
    if (!blk || !nblk) goto out;
    for (i64 a = 0; a < n_aln; a++) {
        i64 f0 = aln_cut[a], f1 = aln_cut[a + 1];
        i64 cap = 8;
        for (i64 f = f0; f < f1; f++)
            cap += 2 * (frag6[f * 6 + 4] - frag6[f * 6 + 3] + 2)
                 + 2 * (frag6[f * 6 + 2] - frag6[f * 6 + 1] + 2);
        blk[a] = (i64 *)malloc(cap * 2 * sizeof(i64));
        if (!blk[a]) goto out;
        i64 nb = 0;
        for (i64 f = f0; f < f1; f++) {
            i64 uid = frag6[f * 6 + 0];
            i64 ub = frag6[f * 6 + 1], ue = frag6[f * 6 + 2];
            i64 sb = frag6[f * 6 + 3], se = frag6[f * 6 + 4];
            i64 un = ue - ub + 1;
            if (un > u_cap) {
                i64 *nu = (i64 *)realloc(u_tmp, un * sizeof(i64));
                if (!nu) goto out;
                u_tmp = nu; u_cap = un;
            }
            const u64 *ua = va_flat + va_off[uid >> 1] + ub;
            if (uid & 1) {
                for (i64 t = 0; t < un; t++)
                    u_tmp[t] = (i64)(ua[un - 1 - t] >> 1);
            } else {
                for (i64 t = 0; t < un; t++)
                    u_tmp[t] = (i64)(ua[t] >> 1);
            }
            i64 got = find_lcs(scm + sb, se - sb + 1, u_tmp, un, sb,
                               blk[a] + nb * 2, cap - nb);
            if (got < 0) { ret = got; goto out; }
            /* merge with previous frag's trailing block (python
             * extends one list then merges adjacent lazily -- replicate
             * by merging across the frag boundary) */
            if (nb > 0 && got > 0 &&
                blk[a][(nb - 1) * 2] + blk[a][(nb - 1) * 2 + 1] == blk[a][nb * 2]) {
                /* python's _find_lcs merges only within one call; the
                 * outer extend keeps boundary blocks separate */
            }
            nb += got;
        }
        nblk[a] = nb;
    }

    /* synchronized merge walk */
    i64 *lcsb = (i64 *)calloc(n_aln, sizeof(i64));
    i64 *frgs = (i64 *)calloc(n_aln, sizeof(i64));
    i64 *begs = (i64 *)calloc(n_aln, sizeof(i64));
    i64 *lens = (i64 *)calloc(n_aln, sizeof(i64));
    i64 *uids = (i64 *)calloc(n_aln, sizeof(i64));
    i64 nout = 0;
    if (!lcsb || !frgs || !begs || !lens || !uids) {
        free(lcsb); free(frgs); free(begs); free(lens); free(uids);
        goto out;
    }
#define SHIFT(i, ok) do { \
    if (lcsb[i] >= nblk[i]) { ok = 0; } else { \
        begs[i] = blk[i][lcsb[i] * 2]; \
        lens[i] = blk[i][lcsb[i] * 2 + 1]; \
        while (frag6[(aln_cut[i] + frgs[i]) * 6 + 4] < begs[i]) frgs[i]++; \
        uids[i] = frag6[(aln_cut[i] + frgs[i]) * 6 + 0] >> 1; \
        ok = 1; } } while (0)
    int alive = 1;
    for (i64 i = 0; i < n_aln && alive; i++) {
        int ok;
        if (nblk[i] == 0) { alive = 0; break; }
        SHIFT(i, ok);
        if (!ok) alive = 0;
    }
    while (alive) {
        i64 s_beg = begs[0];
        for (i64 i = 1; i < n_aln; i++) if (begs[i] > s_beg) s_beg = begs[i];
        i64 m_ext = lens[0] - s_beg + begs[0];
        for (i64 i = 1; i < n_aln; i++) {
            i64 e = lens[i] - s_beg + begs[i];
            if (e < m_ext) m_ext = e;
        }
        if (m_ext > 0) {
            if (nout >= cap_blocks) {
                ret = -1;
                free(lcsb); free(frgs); free(begs); free(lens); free(uids);
                goto out;
            }
            out_nmatch[nout] = m_ext;
            for (i64 i = 0; i < n_aln; i++)
                out_uids[nout * n_aln + i] = uids[i];
            nout++;
            int done = 0;
            for (i64 i = 0; i < n_aln; i++) {
                i64 ext = lens[i] - s_beg + begs[i];
                if (ext == m_ext) {
                    lcsb[i]++;
                    int ok;
                    SHIFT(i, ok);
                    if (!ok) { done = 1; break; }
                } else {
                    begs[i] = s_beg + m_ext;
                    lens[i] = ext - m_ext;
                }
            }
            if (done) break;
        } else {
            i64 imin = 0;
            for (i64 i = 1; i < n_aln; i++) if (begs[i] < begs[imin]) imin = i;
            lcsb[imin]++;
            int ok;
            SHIFT(imin, ok);
            if (!ok) break;
        }
    }
#undef SHIFT
    free(lcsb); free(frgs); free(begs); free(lens); free(uids);
    ret = nout;
out:
    for (i64 a = 0; a < n_aln; a++) free(blk[a]);
    free(blk); free(nblk); free(u_tmp);
    return ret;
}

/* ---------------- LCS match blocks ----------------
 *
 * Port of coverage.py _find_lcs: head/tail trim, O(sn*un) LCS DP on the
 * middle, backtrace to unit blocks, merge adjacent.  Output blocks as
 * (start_in_read, length) pairs; returns count or -1 on capacity. */
i64 find_lcs(
    const i64 *s_ids, i64 s_n,
    const i64 *u_ids, i64 u_n,
    i64 offset,
    i64 *out_blocks, i64 cap_blocks /* pairs */)
{
    i64 nb = 0;
    i64 start = 0;
    i64 s_end = s_n - 1, u_end = u_n - 1;
    while (start < s_n && start < u_n && s_ids[start] == u_ids[start]) start++;
    while (start <= s_end && start <= u_end && s_ids[s_end] == u_ids[u_end]) {
        s_end--; u_end--;
    }
    if (start > 0) {
        if (nb >= cap_blocks) return -1;
        out_blocks[nb * 2] = offset; out_blocks[nb * 2 + 1] = start; nb++;
    }
    i64 sn = s_end - start + 1, un = u_end - start + 1;
    if (sn > 0 && un > 0) {
        const i64 *sa = s_ids + start, *ua = u_ids + start;
        int32_t *L = (int32_t *)calloc((size_t)(sn + 1) * (un + 1), sizeof(int32_t));
        if (!L) return -2;
        for (i64 i = 1; i <= sn; i++) {
            const i64 si = sa[i - 1];
            int32_t *Li = L + i * (un + 1), *Lp = L + (i - 1) * (un + 1);
            for (i64 jj = 1; jj <= un; jj++) {
                if (si == ua[jj - 1]) Li[jj] = Lp[jj - 1] + 1;
                else Li[jj] = Lp[jj] > Li[jj - 1] ? Lp[jj] : Li[jj - 1];
            }
        }
        i64 nb0 = nb;
        i64 i = sn, jj = un;
        while (i > 0 && jj > 0) {
            if (sa[i - 1] == ua[jj - 1]) {
                if (nb >= cap_blocks) { free(L); return -1; }
                out_blocks[nb * 2] = i - 1 + offset + start;
                out_blocks[nb * 2 + 1] = 1;
                nb++;
                i--; jj--;
            } else if (L[i * (un + 1) + (jj - 1)] > L[(i - 1) * (un + 1) + jj]) {
                jj--;
            } else {
                i--;
            }
        }
        free(L);
        for (i64 x = nb0, y = nb - 1; x < y; x++, y--) {
            i64 t0 = out_blocks[x * 2], t1 = out_blocks[x * 2 + 1];
            out_blocks[x * 2] = out_blocks[y * 2];
            out_blocks[x * 2 + 1] = out_blocks[y * 2 + 1];
            out_blocks[y * 2] = t0; out_blocks[y * 2 + 1] = t1;
        }
    }
    if (start + (s_end - start + 1) < s_n) {
        if (nb >= cap_blocks) return -1;
        out_blocks[nb * 2] = offset + s_end + 1;
        out_blocks[nb * 2 + 1] = s_n - s_end - 1;
        nb++;
    }
    i64 mg = 0;
    for (i64 x = 0; x < nb; x++) {
        if (mg > 0 &&
            out_blocks[(mg - 1) * 2] + out_blocks[(mg - 1) * 2 + 1] == out_blocks[x * 2]) {
            out_blocks[(mg - 1) * 2 + 1] += out_blocks[x * 2 + 1];
        } else {
            out_blocks[mg * 2] = out_blocks[x * 2];
            out_blocks[mg * 2 + 1] = out_blocks[x * 2 + 1];
            mg++;
        }
    }
    return mg;
}

/* ---------------- batched multi-alignment blocks ----------------
 *
 * One call for ALL reads: the per-read ma_blocks runs on the same
 * dynamic work-stealing pool as align_batch (reads are independent;
 * results merge in read order, so output is thread-count invariant).
 * aln_cut values are GLOBAL frag6 row indices; read_aln_off[r] selects
 * the alignment-cut span of read r, scm_off[r] its syncmer-id span.
 * Eliminates the per-read ctypes dispatch overhead that dominated
 * scg_ra_utg_coverage (coverage.py) at ~25 us x n_reads. */

typedef struct {
    i64 *nm;    /* [nb] */
    i64 *uids;  /* [nb * n_aln] */
    i64 nb, n_aln;
} mares_t;

typedef struct {
    const i64 *scm_flat, *scm_off;
    const i64 *frag6, *aln_cut, *read_aln_off;
    i64 n_reads;
    const u64 *va_flat;
    const i64 *va_off;
    mares_t *slots;
    atomic_llong next;
    atomic_int err;
} majob_t;

static int ma_one(majob_t *jb, i64 r) {
    i64 a0 = jb->read_aln_off[r], a1 = jb->read_aln_off[r + 1];
    i64 n_aln = a1 - a0;
    mares_t *res = &jb->slots[r];
    res->n_aln = n_aln;
    res->nb = 0;
    if (n_aln == 0) return 0;
    i64 n_scm = jb->scm_off[r + 1] - jb->scm_off[r];
    i64 cap = 64 + 2 * n_scm;
    for (;;) {
        i64 *nm = (i64 *)malloc((size_t)cap * sizeof(i64));
        i64 *ui = (i64 *)malloc((size_t)cap * (size_t)n_aln * sizeof(i64));
        if (!nm || !ui) { free(nm); free(ui); return -2; }
        i64 got = ma_blocks(
            jb->scm_flat + jb->scm_off[r], n_scm,
            jb->frag6, jb->aln_cut + a0, n_aln,
            jb->va_flat, jb->va_off,
            nm, ui, cap);
        if (got == -2) { free(nm); free(ui); return -2; }
        if (got >= 0) { res->nm = nm; res->uids = ui; res->nb = got; return 0; }
        free(nm); free(ui);
        cap *= 4;
    }
}

static void *ma_worker(void *arg) {
    majob_t *jb = (majob_t *)arg;
    for (;;) {
        i64 r = atomic_fetch_add(&jb->next, 1);
        if (r >= jb->n_reads || atomic_load(&jb->err)) break;
        if (ma_one(jb, r) < 0) { atomic_store(&jb->err, 2); break; }
    }
    return NULL;
}

i64 ma_blocks_batch(
    const i64 *scm_flat, const i64 *scm_off,
    const i64 *frag6, const i64 *aln_cut, const i64 *read_aln_off,
    i64 n_reads,
    const u64 *va_flat, const i64 *va_off,
    i64 n_threads,
    i64 *out_nm, i64 *out_uids, i64 *out_read_cut,
    i64 cap_blocks, i64 cap_uids)
{
    majob_t jb;
    memset(&jb, 0, sizeof(jb));
    jb.scm_flat = scm_flat; jb.scm_off = scm_off;
    jb.frag6 = frag6; jb.aln_cut = aln_cut; jb.read_aln_off = read_aln_off;
    jb.n_reads = n_reads;
    jb.va_flat = va_flat; jb.va_off = va_off;
    jb.slots = (mares_t *)calloc(n_reads ? n_reads : 1, sizeof(mares_t));
    if (!jb.slots) return -2;
    atomic_init(&jb.next, 0);
    atomic_init(&jb.err, 0);
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 32) n_threads = 32;
    if (n_threads == 1) {
        ma_worker(&jb);
    } else {
        pthread_t tids[32];
        i64 spawned = 0;
        for (i64 t = 0; t < n_threads; t++) {
            if (pthread_create(&tids[t], NULL, ma_worker, &jb) != 0) break;
            spawned++;
        }
        if (spawned == 0) ma_worker(&jb);
        for (i64 t = 0; t < spawned; t++) pthread_join(tids[t], NULL);
    }
    i64 ret;
    if (atomic_load(&jb.err)) { ret = -2; goto cleanup; }
    {
        i64 tb = 0, tu = 0;
        out_read_cut[0] = 0;
        ret = 0;
        for (i64 r = 0; r < n_reads; r++) {
            mares_t *res = &jb.slots[r];
            if (tb + res->nb > cap_blocks ||
                tu + res->nb * res->n_aln > cap_uids) { ret = -1; break; }
            memcpy(out_nm + tb, res->nm, (size_t)res->nb * sizeof(i64));
            memcpy(out_uids + tu, res->uids,
                   (size_t)(res->nb * res->n_aln) * sizeof(i64));
            tb += res->nb;
            tu += res->nb * res->n_aln;
            out_read_cut[r + 1] = tb;
        }
        if (ret == 0) ret = tb;
    }
cleanup:
    for (i64 r = 0; r < n_reads; r++) { free(jb.slots[r].nm); free(jb.slots[r].uids); }
    free(jb.slots);
    return ret;
}
