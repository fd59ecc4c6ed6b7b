/* Native graph-path read error correction (asm/ec.py port).
 *
 * Per-read error-block correction: DFS over live graph arcs extending an
 * incremental banded wavefront edit distance (wf_ed_core_native from
 * wavefront.c), SUCCESS/AMBISNQ/AMBISEQ/FAILURE classification, and
 * in-read syncmer-path splicing.  Semantics replicate asm/ec.py
 * (_correct_read/_dfs_search/_ec_path_search) statement-for-statement,
 * including the reference-faithful quirks (status reset on every
 * in-band sink visit, the c_path pop on partial tail matches, and the
 * k_mer[end] check when scanning for the next bad syncmer); the Python
 * implementation remains the fallback and the oracle for equivalence
 * tests.  Reference behavior: reference/syncerr.c:144-668.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

typedef int64_t i64;
typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

extern i64 wf_ed_core_native(const u8 *ts, i64 tl, const u8 *qs, i64 ql,
                             i64 is_ext, i64 bw, i64 *hdr, i64 *k, i64 cap);

#define EC_FAILURE 0
#define EC_SUCCESS 1
#define EC_AMBISNQ 2
#define EC_AMBISEQ 3
#define MAX_DFS_PATH 10000
#define MIN_ERR_SEQ_LEN 10
#define MIN_ERR_BASE 6

static const u8 NT[4] = {'A', 'C', 'G', 'T'};
static u8 COMP[256];

/* growable byte/int64 buffers */
typedef struct { u8 *p; i64 n, cap; } bbuf_t;
typedef struct { i64 *p; i64 n, cap; } ibuf_t;

static int bb_reserve(bbuf_t *b, i64 need) {
    if (b->n + need <= b->cap) return 0;
    i64 nc = b->cap ? b->cap : 1024;
    while (nc < b->n + need) nc *= 2;
    u8 *np = (u8 *)realloc(b->p, nc);
    if (!np) return -1;
    b->p = np; b->cap = nc;
    return 0;
}

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

/* wavefront state (the Python WfState wrapper convention: t_end/q_end
 * are the +1'd endpoints, 0 = band exceeded) */
typedef struct {
    const u8 *ts; i64 tl;
    i64 bw;
    i64 score, t_end, q_end;
    i64 d0, n;
    i64 *k; i64 kcap;
} wf_t;

typedef struct {
    int status;
    i64 n_path;
    i64 edist, s_edist;
    bbuf_t c_seq;
    bbuf_t opt_seq;
    ibuf_t c_path;
    ibuf_t opt_path;
} dfs_t;

typedef struct {
    /* graph (oriented-vertex CSR) */
    const i64 *idx_p, *idx_n;
    i64 n_vtx2;
    const u64 *aw;
    const i64 *als;
    const u8 *adel;
    const u8 *seq_flat;
    const i64 *seq_off;   /* [n_vtx+1] */
    const i64 *vtx_len;
    const u8 *scm_del;
    /* lazy vertex consensus (single-syncmer hoco graphs): per-vertex
     * (hoco-stream offset, rev) instead of a materialized ASCII buffer;
     * active when lsrc != NULL (then seq_flat/seq_off are unused) */
    const i64 *lsrc;
    const u8 *lrv;
    const u8 *codes;
    /* scratch */
    wf_t wf;
    dfs_t dfs;
    i64 *snap_arena; i64 snap_n, snap_cap;
    int oom;
} ctx_t;

static int wf_run(ctx_t *c, dfs_t *d) {
    /* conf.qs = c_seq; wf_ed_core(conf) */
    wf_t *w = &c->wf;
    i64 hdr[5] = {w->score, -1, -1, w->d0, w->n};
    i64 ret = wf_ed_core_native(w->ts, w->tl, d->c_seq.p, d->c_seq.n,
                                1 /*is_ext*/, w->bw, hdr, w->k, w->kcap);
    if (ret < 0) return -1;
    w->score = hdr[0];
    w->d0 = hdr[3];
    w->n = hdr[4];
    if (ret == 1) { w->t_end = hdr[1] + 1; w->q_end = hdr[2] + 1; }
    else { w->t_end = 0; w->q_end = 0; }
    return 0;
}

static int snap_save(ctx_t *c, i64 *slot) {
    wf_t *w = &c->wf;
    i64 need = 5 + w->n;
    if (c->snap_n + need > c->snap_cap) {
        i64 nc = c->snap_cap ? c->snap_cap * 2 : 4096;
        while (nc < c->snap_n + need) nc *= 2;
        i64 *np = (i64 *)realloc(c->snap_arena, nc * sizeof(i64));
        if (!np) return -1;
        c->snap_arena = np; c->snap_cap = nc;
    }
    i64 *s = c->snap_arena + c->snap_n;
    s[0] = w->score; s[1] = w->t_end; s[2] = w->q_end; s[3] = w->d0; s[4] = w->n;
    memcpy(s + 5, w->k, w->n * sizeof(i64));
    *slot = c->snap_n;
    c->snap_n += need;
    return 0;
}

static void snap_restore(ctx_t *c, i64 slot) {
    /* copy the state back out but KEEP this snapshot live (the caller
     * restores once per arc from the same snapshot); only snapshots
     * taken by deeper recursion levels are released */
    wf_t *w = &c->wf;
    i64 *s = c->snap_arena + slot;
    w->score = s[0]; w->t_end = s[1]; w->q_end = s[2]; w->d0 = s[3]; w->n = s[4];
    memcpy(w->k, s + 5, w->n * sizeof(i64));
    c->snap_n = slot + 5 + s[4];
}

static void dfs_search(ctx_t *c, i64 sink) {
    dfs_t *d = &c->dfs;
    if (d->n_path >= MAX_DFS_PATH || c->oom) return;
    i64 l0 = d->c_seq.n;
    i64 n0 = d->c_path.n;
    i64 source = d->c_path.p[n0 - 1];
    i64 slot;
    if (snap_save(c, &slot) < 0) { c->oom = 1; return; }
    i64 t_end0 = c->wf.t_end;

    i64 p0 = (source < c->n_vtx2) ? c->idx_p[source] : 0;
    i64 pn = (source < c->n_vtx2) ? c->idx_n[source] : 0;
    for (i64 ai = p0; ai < p0 + pn; ++ai) {
        if (c->adel[ai]) continue;
        i64 w = (i64)c->aw[ai];
        i64 ls = c->als[ai];
        i64 vid = w >> 1;
        i64 l_seq = c->vtx_len[vid];

        if (ib_push(&d->c_path, w) < 0) { c->oom = 1; break; }
        i64 add = l_seq - ls;
        if (add < 0) add = 0;  /* python slices clamp to empty */
        if (bb_reserve(&d->c_seq, add) < 0) { c->oom = 1; break; }
        if (c->lsrc) {
            /* decode the needed window straight from the hoco codes:
             * vertex consensus byte j = NT[codes[src+j]] (rev=0) or
             * NT[3-codes[src+L-1-j]] (rev=1); appending either the
             * suffix k_seq[ls:] (w fwd) or COMP[reverse(k_seq[:add])]
             * (w rev) collapses to the four direct loops below */
            i64 src = c->lsrc[vid];
            u8 *dst = d->c_seq.p + d->c_seq.n;
            if (src < 0) {
                memset(dst, 'N', add);
            } else if (!(w & 1)) {
                if (!c->lrv[vid])
                    for (i64 t = 0; t < add; ++t)
                        dst[t] = NT[c->codes[src + ls + t]];
                else
                    for (i64 t = 0; t < add; ++t)
                        dst[t] = NT[3 - c->codes[src + l_seq - 1 - ls - t]];
            } else {
                if (!c->lrv[vid])
                    for (i64 t = 0; t < add; ++t)
                        dst[t] = NT[3 - c->codes[src + add - 1 - t]];
                else
                    for (i64 t = 0; t < add; ++t)
                        dst[t] = NT[c->codes[src + l_seq - add + t]];
            }
            d->c_seq.n += add;
        } else {
            const u8 *k_seq = c->seq_flat + c->seq_off[vid];
            if (w & 1) {
                /* complemented reverse of k_seq[:l_seq-ls] */
                for (i64 t = add - 1; t >= 0; --t)
                    d->c_seq.p[d->c_seq.n++] = COMP[k_seq[t]];
            } else {
                memcpy(d->c_seq.p + d->c_seq.n, k_seq + ls, add);
                d->c_seq.n += add;
            }
        }

        if (wf_run(c, d) < 0) { c->oom = 1; break; }
        wf_t *wf = &c->wf;

        i64 score = wf->score + wf->tl - wf->t_end;
        if (score <= wf->bw && (sink == -1 || sink == w)) {
            d->status = EC_SUCCESS;
            if (score <= d->edist) {
                if (wf->t_end > t_end0) d->s_edist = d->edist;
                d->edist = score;
                if (sink == -1 && wf->q_end < d->c_seq.n)
                    d->c_path.n--;  /* pop */
                if (d->edist == d->s_edist) {
                    if (wf->q_end != d->opt_seq.n ||
                        memcmp(d->c_seq.p, d->opt_seq.p, wf->q_end) != 0)
                        d->status = EC_AMBISEQ;
                    if (d->status == EC_SUCCESS &&
                        !(d->c_path.n == d->opt_path.n &&
                          memcmp(d->c_path.p, d->opt_path.p,
                                 d->c_path.n * sizeof(i64)) == 0))
                        d->status = EC_AMBISNQ;
                }
                d->opt_seq.n = 0;
                if (bb_reserve(&d->opt_seq, wf->q_end) < 0) { c->oom = 1; break; }
                memcpy(d->opt_seq.p, d->c_seq.p, wf->q_end);
                d->opt_seq.n = wf->q_end;
                d->opt_path.n = 0;
                for (i64 t = 0; t < d->c_path.n; ++t)
                    if (ib_push(&d->opt_path, d->c_path.p[t]) < 0) { c->oom = 1; break; }
                if (c->oom) break;
            } else if (score < d->s_edist) {
                d->s_edist = score;
            }
        }

        if (wf->score <= wf->bw &&
            d->c_seq.n - l_seq <= wf->tl + wf->bw &&
            ((sink != -1 && sink != w) || wf->t_end < wf->tl)) {
            dfs_search(c, sink);
            if (c->oom) break;
        } else {
            d->n_path++;
        }

        d->c_path.n = n0;
        d->c_seq.n = l0;
        snap_restore(c, slot);
    }
    c->snap_n = slot;  /* release this level's snapshot */
}

static int ec_path_search(ctx_t *c, i64 source, i64 sink) {
    dfs_t *d = &c->dfs;
    d->status = EC_FAILURE;
    d->n_path = 0;
    d->edist = (i64)1 << 30;
    d->s_edist = (i64)1 << 30;
    d->c_seq.n = 0;
    d->opt_seq.n = 0;
    d->c_path.n = 0;
    d->opt_path.n = 0;
    if (ib_push(&d->c_path, source) < 0) { c->oom = 1; return EC_FAILURE; }
    dfs_search(c, sink);
    return d->status;
}

/* Build conf.ts = ASCII hoco window, reverse-complemented when rev. */
static void hoco_dna(const u8 *codes, i64 pos, i64 l, int rev, u8 *out) {
    if (rev) {
        for (i64 i = 0; i < l; ++i)
            out[i] = NT[3 - codes[pos + l - 1 - i]];
    } else {
        for (i64 i = 0; i < l; ++i)
            out[i] = NT[codes[pos + i]];
    }
}

/* ---------------- threaded batch driver ----------------
 *
 * Reads are independent; a dynamic work-stealing pool (kt_for analogue,
 * reference/kthread.c:48-65; the reference threads EC at
 * syncerr.c:882) fills per-read result slots which merge in read order,
 * so output and stats are identical to a single-threaded run. */
#include <pthread.h>
#include <stdatomic.h>

typedef struct { i64 n; i64 *ck; i64 *cm; u8 upd; } ec_slot_t;

typedef struct {
    const i64 *idx_p, *idx_n; i64 n_vtx2;
    const u64 *aw; const i64 *als; const u8 *adel;
    const u8 *seq_flat; const i64 *seq_off; const i64 *vtx_len;
    const u8 *scm_del;
    const i64 *lsrc; const u8 *lrv; const u8 *lcodes;
    const u64 *kflat; const u32 *mflat; const i64 *moff; i64 n_reads;
    const u8 *code_flat; const i64 *hoff; const i64 *hoco_l;
    i64 w; double max_edist;
    i64 max_hoco;
    ec_slot_t *slots;
    i64 stats[32][11]; /* per-worker */
    atomic_llong next;
    atomic_int err;
} ec_job_t;

static int ec_one(ec_job_t *jb, ctx_t *c, u8 *ts_buf, i64 *stats, i64 r,
                  ibuf_t *ck, ibuf_t *cm) {
    const u64 *k_mer = jb->kflat + jb->moff[r];
    const u32 *m_pos = jb->mflat + jb->moff[r];
    i64 n_scm = jb->moff[r + 1] - jb->moff[r];
    const u8 *codes = jb->code_flat + jb->hoff[r];
    i64 hl = jb->hoco_l[r];
    i64 w = jb->w;
    ck->n = 0; cm->n = 0;
    int updated = 1;
    i64 beg = -1;

    for (;;) {
        i64 beg_pos = (beg < 1) ? 0 : ((i64)(m_pos[beg - 1] >> 1) + w);
        beg_pos += MIN_ERR_SEQ_LEN;
        i64 end = beg + 1;
        while (end < n_scm) {
            u64 km = k_mer[end];
            if (!jb->scm_del[km >> 1] && !(km & 1) &&
                (i64)(m_pos[end] >> 1) >= beg_pos)
                break;
            end++;
        }

        if (beg >= 0 || end < n_scm) {
            i64 beg_utg, end_utg, l;
            int rv;
            if (beg < 0) {
                beg = end;
                beg_utg = (i64)((k_mer[beg] & ~(u64)1) |
                                ((m_pos[beg] & 1) ? 0 : 1));
                beg_pos = 0;
                end_utg = -1;
                l = (i64)(m_pos[beg] >> 1);
                rv = 1;
            } else {
                beg -= 1;
                beg_utg = (i64)((k_mer[beg] & ~(u64)1) | (m_pos[beg] & 1));
                beg_pos = (i64)(m_pos[beg] >> 1) + w;
                if (end >= n_scm) {
                    end_utg = -1;
                    l = hl - beg_pos;
                } else {
                    end_utg = (i64)((k_mer[end] & ~(u64)1) | (m_pos[end] & 1));
                    l = (i64)(m_pos[end] >> 1) - beg_pos;
                }
                rv = 0;
            }

            int err_c1;
            if (l >= MIN_ERR_SEQ_LEN) {
                hoco_dna(codes, beg_pos, l, rv, ts_buf);
                i64 bw = (i64)ceil(l * jb->max_edist);
                if (bw < MIN_ERR_BASE) bw = MIN_ERR_BASE;
                wf_t *wf = &c->wf;
                wf->ts = ts_buf; wf->tl = l; wf->bw = bw;
                wf->score = 0; wf->t_end = 0; wf->q_end = 0;
                wf->d0 = 0; wf->n = 1;
                i64 need = 2 * bw + 16;
                if (need > wf->kcap) {
                    i64 *nk = (i64 *)realloc(wf->k, need * sizeof(i64));
                    if (!nk) return -2;
                    wf->k = nk; wf->kcap = need;
                }
                wf->k[0] = -1;
                err_c1 = ec_path_search(c, beg_utg, end_utg);
                if (c->oom) return -2;
                if (end_utg == -1) { stats[0]++; stats[1 + err_c1]++; }
                else { stats[5]++; stats[6 + err_c1]++; }
            } else {
                err_c1 = EC_FAILURE;
                stats[10]++;
            }

            if (err_c1 == EC_SUCCESS) {
                i64 n = c->dfs.opt_path.n;
                const i64 *op = c->dfs.opt_path.p;
                if (rv) {
                    for (i64 jx = n - 1; jx > 0; --jx) {
                        if (ib_push(ck, (i64)((op[jx] & ~(i64)1) | 1)) < 0 ||
                            ib_push(cm, (i64)(0xFFFFFFFFu ^ (u32)(op[jx] & 1))) < 0)
                            return -2;
                    }
                } else {
                    for (i64 jx = 1; jx < n - 1; ++jx) {
                        if (ib_push(ck, (i64)((op[jx] & ~(i64)1) | 1)) < 0 ||
                            ib_push(cm, (i64)(0xFFFFFFFEu | (u32)(op[jx] & 1))) < 0)
                            return -2;
                    }
                    if (end_utg == -1 && n > 1) {
                        if (ib_push(ck, (i64)((op[n - 1] & ~(i64)1) | 1)) < 0 ||
                            ib_push(cm, (i64)(0xFFFFFFFEu | (u32)(op[n - 1] & 1))) < 0)
                            return -2;
                    }
                }
            } else {
                if (rv) {
                    for (i64 x = 0; x < beg; ++x) {
                        if (ib_push(ck, (i64)k_mer[x]) < 0 ||
                            ib_push(cm, (i64)m_pos[x]) < 0) return -2;
                    }
                } else if (beg + 1 < n_scm) {
                    for (i64 x = beg + 1; x < end; ++x) {
                        if (ib_push(ck, (i64)k_mer[x]) < 0 ||
                            ib_push(cm, (i64)m_pos[x]) < 0) return -2;
                    }
                }
            }
        } else {
            updated = 0;
        }

        /* next bad syncmer (k_mer[end] check kept reference-faithful) */
        beg = end + 1;
        while (beg < n_scm) {
            if (jb->scm_del[k_mer[beg] >> 1] || (k_mer[end] & 1))
                break;
            beg++;
        }
        if (beg > n_scm) break;
        for (i64 x = end; x < beg; ++x) {
            if (ib_push(ck, (i64)k_mer[x]) < 0 ||
                ib_push(cm, (i64)m_pos[x]) < 0) return -2;
        }
    }

    ec_slot_t *sl = &jb->slots[r];
    sl->upd = (u8)updated;
    sl->n = 0;
    if (updated && ck->n) {
        sl->ck = (i64 *)malloc(ck->n * sizeof(i64));
        sl->cm = (i64 *)malloc(cm->n * sizeof(i64));
        if (!sl->ck || !sl->cm) return -2;
        memcpy(sl->ck, ck->p, ck->n * sizeof(i64));
        memcpy(sl->cm, cm->p, cm->n * sizeof(i64));
        sl->n = ck->n;
    }
    return 0;
}

typedef struct { ec_job_t *jb; i64 wid; } ec_warg_t;

static void *ec_worker(void *arg) {
    ec_warg_t *wa = (ec_warg_t *)arg;
    ec_job_t *jb = wa->jb;
    ctx_t c;
    memset(&c, 0, sizeof(c));
    c.idx_p = jb->idx_p; c.idx_n = jb->idx_n; c.n_vtx2 = jb->n_vtx2;
    c.aw = jb->aw; c.als = jb->als; c.adel = jb->adel;
    c.seq_flat = jb->seq_flat; c.seq_off = jb->seq_off; c.vtx_len = jb->vtx_len;
    c.scm_del = jb->scm_del;
    c.lsrc = jb->lsrc; c.lrv = jb->lrv; c.codes = jb->lcodes;
    u8 *ts_buf = (u8 *)malloc(jb->max_hoco ? jb->max_hoco : 1);
    ibuf_t ck = {0}, cm = {0};
    if (!ts_buf) { atomic_store(&jb->err, 2); goto done; }
    for (;;) {
        i64 r = atomic_fetch_add(&jb->next, 1);
        if (r >= jb->n_reads || atomic_load(&jb->err)) break;
        if (ec_one(jb, &c, ts_buf, jb->stats[wa->wid], r, &ck, &cm) < 0) {
            atomic_store(&jb->err, 2);
            break;
        }
    }
done:
    free(ts_buf);
    free(ck.p); free(cm.p);
    free(c.wf.k);
    free(c.dfs.c_seq.p); free(c.dfs.opt_seq.p);
    free(c.dfs.c_path.p); free(c.dfs.opt_path.p);
    free(c.snap_arena);
    return NULL;
}

/* returns total emitted (kmer,mpos) count, -1 = out capacity, -2 = alloc */
i64 ec_correct_reads(
    const i64 *idx_p, const i64 *idx_n, i64 n_vtx2,
    const u64 *aw, const i64 *als, const u8 *adel,
    const u8 *seq_flat, const i64 *seq_off, const i64 *vtx_len,
    const u8 *scm_del,
    const i64 *lsrc, const u8 *lrev, const u8 *lcodes,
    const u64 *kflat, const u32 *mflat, const i64 *moff, i64 n_reads,
    const u8 *code_flat, const i64 *hoff, const i64 *hoco_l,
    i64 w, double max_edist, i64 n_threads,
    i64 *stats,
    u64 *out_kmer, u32 *out_mpos, i64 *out_cut, u8 *out_upd,
    i64 cap_out)
{
    COMP['A'] = 'T'; COMP['C'] = 'G'; COMP['G'] = 'C'; COMP['T'] = 'A';
    ec_job_t *jb = (ec_job_t *)calloc(1, sizeof(ec_job_t));
    if (!jb) return -2;
    jb->idx_p = idx_p; jb->idx_n = idx_n; jb->n_vtx2 = n_vtx2;
    jb->aw = aw; jb->als = als; jb->adel = adel;
    jb->seq_flat = seq_flat; jb->seq_off = seq_off; jb->vtx_len = vtx_len;
    jb->scm_del = scm_del;
    jb->lsrc = lsrc; jb->lrv = lrev; jb->lcodes = lcodes;
    jb->kflat = kflat; jb->mflat = mflat; jb->moff = moff; jb->n_reads = n_reads;
    jb->code_flat = code_flat; jb->hoff = hoff; jb->hoco_l = hoco_l;
    jb->w = w; jb->max_edist = max_edist;
    jb->max_hoco = 0;
    for (i64 r = 0; r < n_reads; ++r)
        if (hoco_l[r] > jb->max_hoco) jb->max_hoco = hoco_l[r];
    jb->slots = (ec_slot_t *)calloc(n_reads ? n_reads : 1, sizeof(ec_slot_t));
    if (!jb->slots) { free(jb); return -2; }
    atomic_init(&jb->next, 0);
    atomic_init(&jb->err, 0);

    if (n_threads < 1) n_threads = 1;
    if (n_threads > 32) n_threads = 32;
    ec_warg_t wargs[32];
    if (n_threads == 1) {
        wargs[0].jb = jb; wargs[0].wid = 0;
        ec_worker(&wargs[0]);
    } else {
        pthread_t tids[32];
        i64 spawned = 0;
        for (i64 t = 0; t < n_threads; t++) {
            wargs[t].jb = jb; wargs[t].wid = t;
            if (pthread_create(&tids[t], NULL, ec_worker, &wargs[t]) != 0) break;
            spawned++;
        }
        if (spawned == 0) { wargs[0].jb = jb; wargs[0].wid = 0; ec_worker(&wargs[0]); }
        for (i64 t = 0; t < spawned; t++) pthread_join(tids[t], NULL);
    }

    i64 rc = atomic_load(&jb->err) ? -2 : 0;
    i64 total = 0;
    out_cut[0] = 0;
    if (!rc) {
        for (i64 t = 0; t < 32; t++)
            for (int s = 0; s < 11; s++) stats[s] += jb->stats[t][s];
        for (i64 r = 0; r < n_reads; ++r) {
            ec_slot_t *sl = &jb->slots[r];
            out_upd[r] = sl->upd;
            if (sl->upd) {
                if (total + sl->n > cap_out) { rc = -1; break; }
                for (i64 x = 0; x < sl->n; ++x) {
                    out_kmer[total + x] = (u64)sl->ck[x];
                    out_mpos[total + x] = (u32)sl->cm[x];
                }
                total += sl->n;
            }
            out_cut[r + 1] = total;
        }
    }
    for (i64 r = 0; r < n_reads; ++r) { free(jb->slots[r].ck); free(jb->slots[r].cm); }
    free(jb->slots);
    free(jb);
    return rc ? rc : total;
}
