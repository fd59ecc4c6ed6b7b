/* Error correction's per-read DFS as a resumable state machine that feeds
 * the wavefront kernel (K2, csrc/wf_ed.cu) one ragged round at a time.
 *
 * Per read it computes what native/ec.c's ec_one computes (error blocks
 * between good anchors, DFS over live graph arcs from the block's start,
 * MAX_DFS_PATH, the SUCCESS/AMBISNQ/AMBISEQ/FAILURE rules and the 11
 * stats, the in-read splice), step for step as the Python generators
 * asm/ec.py:_correct_read and _dfs_search do.  Two things differ from
 * ec.c:
 *
 * - the recursion is an explicit stack of frames (source, arc cursor,
 *   l0, n0, snapshot slot, t_end0, the current arc's w and l_seq), so a
 *   read can stop inside its DFS and resume later;
 * - where ec.c ran the wavefront on the host (wf_run), the read stops:
 *   the arc's bases are in c_seq and its wavefront state (score, d0, n,
 *   k, t_end/q_end) must be advanced by one K2 item first.
 *
 * Reads are admitted in read order, at most `inflight` at once (0: all),
 * exactly as asm/ec.py:_correct_reads_lockstep admits them: a read that
 * makes no request finishes at admission and takes no place, and reads
 * that finish make room after each round.  A round is:
 *
 *   ecl_layout  resume every read whose item came back, retire finished
 *               reads, admit new ones, and lay the round out as
 *               kernels/wf_ed.py:round_layout does (slot widths, the
 *               16-byte aligned parts, the shared-memory or global route
 *               of each item, the int32 check);
 *   ecl_pack    write the round's input words (descriptors, metas, then
 *               each item's k, ts and qs) as kernels/wf_ed.py:pack_round
 *               does, with every padding byte zero;
 *   ecl_unpack  apply each item's out_meta and out_k (t_end/q_end +1 after
 *               a hit, else 0), or name the first item whose err is set;
 *               it also counts the kernel's work (ecl_work).
 *
 * ecl_finish then gives native/ec.c:ec_correct_reads's outputs.  Reads
 * run independently (the graph is read-only during EC), so resuming,
 * admitting, packing and unpacking run over n_threads threads (started
 * once, kept until ecl_free) once a round holds enough items; a round's
 * bytes do not depend on the thread count.
 *
 * Memory: every buffer of a read comes from the handle's slabs (one list
 * per thread), which only ecl_free gives back; a buffer that grows moves
 * to a new place and leaves the old one unused.  With every read in
 * flight tens of thousands of buffers grow during a run, and the C
 * library's heap growing and trimming under them cost several times the
 * DFS itself on the H100's host (PERF.md).
 * Reference behaviour: reference/syncerr.c:144-668.
 */
#include <pthread.h>
#include <stdatomic.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

typedef int64_t i64;
typedef int32_t i32;
typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;

#define EC_FAILURE 0
#define EC_SUCCESS 1
#define EC_AMBISNQ 2
#define EC_AMBISEQ 3
#define MAX_DFS_PATH 10000
#define MIN_ERR_SEQ_LEN 10
#define MIN_ERR_BASE 6

#define DESC_WORDS 12
#define META_WORDS 8
#define I32_MAX 2147483647LL
#define MAX_THREADS 32
/* items a thread takes at a time, and the least items worth threads */
#define PAR_GRAIN 16
#define PAR_MIN 64
/* reads started at once when admitting: the states of those that finish
 * at once are reused by the next batch */
#define ADMIT_BATCH 1024
#define SLAB_BYTES ((size_t)8 << 20)

#define ECL_OOM (-2)
#define ECL_I32 (-3)
#define ECL_STATE (-4)

static const u8 NT[4] = {'A', 'C', 'G', 'T'};

/* complement of A, C, G, T; every other byte is kept, as Python's
 * bytes.translate(bytes.maketrans(b"ACGT", b"TGCA")) keeps it */
static u8 comp(u8 c) {
    switch (c) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    default: return c;
    }
}

/* ---------------- memory ---------------- */

typedef struct slab { struct slab *next; size_t used, cap; max_align_t data[]; } slab_t;
typedef struct { slab_t *head; } arena_t;

static void *arena_alloc(arena_t *A, size_t n) {
    n = (n + 15) & ~(size_t)15;
    slab_t *s = A->head;
    if (!s || s->cap - s->used < n) {
        size_t cap = n > SLAB_BYTES ? n : SLAB_BYTES;
        s = (slab_t *)malloc(sizeof(slab_t) + cap);
        if (!s) return NULL;
        s->next = A->head;
        s->used = 0;
        s->cap = cap;
        A->head = s;
    }
    void *p = (char *)s->data + s->used;
    s->used += n;
    return p;
}

static void arena_free(arena_t *A) {
    while (A->head) {
        slab_t *s = A->head;
        A->head = s->next;
        free(s);
    }
}

/* make room for need elements of elem bytes (doubling from first) */
static int grow(arena_t *A, void **p, i64 *cap, i64 need, i64 elem, i64 first) {
    if (need <= *cap) return 0;
    i64 nc = *cap ? *cap : first;
    while (nc < need) nc *= 2;
    void *np = arena_alloc(A, (size_t)(nc * elem));
    if (!np) return -1;
    if (*cap) memcpy(np, *p, (size_t)(*cap * elem));
    *p = np;
    *cap = nc;
    return 0;
}

typedef struct { u8 *p; i64 n, cap; } bbuf_t;
typedef struct { i64 *p; i64 n, cap; } ibuf_t;

static int bb_reserve(arena_t *A, bbuf_t *b, i64 more) {
    return grow(A, (void **)&b->p, &b->cap, b->n + more, 1, 1024);
}

static int ib_push(arena_t *A, ibuf_t *b, i64 v) {
    if (grow(A, (void **)&b->p, &b->cap, b->n + 1, sizeof(i64), 256)) return -1;
    b->p[b->n++] = v;
    return 0;
}

/* one level of the DFS (a call of asm/ec.py:_dfs_search) */
typedef struct {
    i64 ai, ai_end;   /* arc cursor and end */
    i64 l0, n0;       /* c_seq and c_path lengths at entry */
    i64 slot;         /* wavefront snapshot at entry */
    i64 t_end0;
    i64 w, l_seq;     /* the arc being extended */
} frame_t;

enum { BLK_NONE, BLK_SHORT, BLK_SEARCH };

/* one read in flight */
typedef struct {
    i64 r;
    arena_t *A;       /* the running thread's slabs */
    /* the read's block scan (asm/ec.py:_correct_read) */
    i64 beg, end, end_utg, l;
    int rv, updated;
    int pending;      /* waits on a wavefront item */
    ibuf_t ck, cm;
    i64 stats[11];
    /* wavefront state (WfState: t_end/q_end +1'd, 0 = none) */
    u8 *ts; i64 ts_cap, tl;
    i64 bw, score, t_end, q_end, d0, n;
    i64 *k; i64 kcap;
    /* DFS */
    int status;
    i64 n_path, edist, s_edist;
    bbuf_t c_seq, opt_seq;
    ibuf_t c_path, opt_path;
    i64 *snap; i64 snap_n, snap_cap;
    frame_t *fr; i64 depth, fr_cap;
} rd_t;

typedef struct { i64 n; i64 *ck, *cm; u8 upd; } slot_t;

/* an item's place in the round (kernels/wf_ed.py:round_layout) */
typedef struct { i64 start, kb, tb, qb, S, om, scr; } lay_t;

typedef struct ecl ecl_t;
typedef struct par par_t;
typedef struct { ecl_t *L; i64 wid; } helper_arg_t;

/* the handle's helper threads: each waits for the next par_for */
typedef struct {
    pthread_t tid[MAX_THREADS];
    i64 n;                /* helpers started (worker ids 1..n) */
    pthread_mutex_t mu;
    pthread_cond_t go, done;
    par_t *job;
    u64 gen;              /* par_for calls so far */
    i64 busy;             /* helpers still on the current job */
    int stop;
} crew_t;

struct ecl {
    /* graph (oriented-vertex CSR) and vertex sequences: seq_flat/seq_off,
     * or, when lsrc is set, windows of the hoco code stream lcodes */
    const i64 *idx_p, *idx_n; i64 n_vtx2;
    const u64 *aw; const i64 *als; const u8 *adel;
    const u8 *seq_flat; const i64 *seq_off; const i64 *vtx_len;
    const u8 *scm_del;
    const i64 *lsrc; const u8 *lrv; const u8 *lcodes;
    /* reads */
    const u64 *kflat; const u32 *mflat; const i64 *moff; i64 n_reads;
    const u8 *code_flat; const i64 *hoff; const i64 *hoco_l;
    i64 w; double max_edist;
    i64 cap, n_threads;
    /* scheduler */
    i64 next_read;
    rd_t **live; i64 n_live;
    rd_t **adm;               /* reads being admitted */
    rd_t **spare; i64 n_spare; /* retired read states, reused */
    int resume;               /* the live reads' items came back */
    slot_t *slots;
    i64 stats[11];
    /* the round */
    lay_t *lay; i64 lay_cap;
    i64 B, in_words, out_words;
    int laid;
    i64 extensions;
    i64 work[4]; /* the kernel's work: see ecl_work */
    /* threads and their slabs (worker 0 is the calling thread) */
    crew_t crew;
    helper_arg_t helper[MAX_THREADS];
    arena_t arena[MAX_THREADS];
};

/* ---------------- the DFS ---------------- */

static int snap_save(rd_t *R, i64 *slot) {
    i64 need = 5 + R->n;
    if (grow(R->A, (void **)&R->snap, &R->snap_cap, R->snap_n + need, sizeof(i64), 256)) return -1;
    i64 *s = R->snap + R->snap_n;
    s[0] = R->score; s[1] = R->t_end; s[2] = R->q_end; s[3] = R->d0; s[4] = R->n;
    memcpy(s + 5, R->k, (size_t)R->n * sizeof(i64));
    *slot = R->snap_n;
    R->snap_n += need;
    return 0;
}

/* back to the snapshot, which stays live (each arc of the frame restores
 * from it); only deeper frames' snapshots are released */
static void snap_restore(rd_t *R, i64 slot) {
    const i64 *s = R->snap + slot;
    R->score = s[0]; R->t_end = s[1]; R->q_end = s[2]; R->d0 = s[3]; R->n = s[4];
    memcpy(R->k, s + 5, (size_t)R->n * sizeof(i64));
    R->snap_n = slot + 5 + s[4];
}

/* the end of one arc of frame f: del c_path[n0:], del c_seq[l0:],
 * conf.restore(snap), next arc */
static void arc_done(rd_t *R, frame_t *f) {
    R->c_path.n = f->n0;
    R->c_seq.n = f->l0;
    snap_restore(R, f->slot);
    f->ai++;
}

/* a call of _dfs_search: 0 when it returns at once (MAX_DFS_PATH), 1
 * when its frame was pushed, -1 on allocation failure */
static int dfs_enter(const ecl_t *L, rd_t *R) {
    if (R->n_path >= MAX_DFS_PATH) return 0;
    if (grow(R->A, (void **)&R->fr, &R->fr_cap, R->depth + 1, sizeof(frame_t), 64)) return -1;
    frame_t *f = &R->fr[R->depth];
    f->l0 = R->c_seq.n;
    f->n0 = R->c_path.n;
    i64 source = R->c_path.p[f->n0 - 1];
    if (snap_save(R, &f->slot)) return -1;
    f->t_end0 = R->t_end;
    f->ai = source < L->n_vtx2 ? L->idx_p[source] : 0;
    f->ai_end = f->ai + (source < L->n_vtx2 ? L->idx_n[source] : 0);
    R->depth++;
    return 1;
}

/* append the bases of arc ai's head vertex to c_seq (ec.c:dfs_search) */
static int append_arc(const ecl_t *L, rd_t *R, i64 w, i64 ls, i64 l_seq) {
    i64 vid = w >> 1;
    i64 add = l_seq - ls;
    if (add < 0) add = 0;  /* Python slices clamp to empty */
    if (bb_reserve(R->A, &R->c_seq, add)) return -1;
    u8 *dst = R->c_seq.p + R->c_seq.n;
    if (L->lsrc) {
        /* vertex byte j is NT[codes[src+j]] (rev 0) or NT[3-codes[src+L-1-j]]
         * (rev 1); the suffix k_seq[ls:] (w forward) or the complemented
         * reverse of k_seq[:add] (w reverse) in four direct loops */
        i64 src = L->lsrc[vid];
        const u8 *c = L->lcodes;
        if (src < 0) {
            memset(dst, 'N', (size_t)add);
        } else if (!(w & 1)) {
            if (!L->lrv[vid])
                for (i64 t = 0; t < add; ++t) dst[t] = NT[c[src + ls + t]];
            else
                for (i64 t = 0; t < add; ++t) dst[t] = NT[3 - c[src + l_seq - 1 - ls - t]];
        } else {
            if (!L->lrv[vid])
                for (i64 t = 0; t < add; ++t) dst[t] = NT[3 - c[src + add - 1 - t]];
            else
                for (i64 t = 0; t < add; ++t) dst[t] = NT[c[src + l_seq - add + t]];
        }
    } else {
        const u8 *k_seq = L->seq_flat + L->seq_off[vid];
        if (w & 1)
            for (i64 t = 0; t < add; ++t) dst[t] = comp(k_seq[add - 1 - t]);
        else
            memcpy(dst, k_seq + ls, (size_t)add);
    }
    R->c_seq.n += add;
    return 0;
}

/* what _dfs_search does once the arc's wavefront came back */
static int after_extension(rd_t *R, const frame_t *f) {
    i64 sink = R->end_utg, w = f->w;
    i64 score = R->score + R->tl - R->t_end;
    if (score <= R->bw && (sink == -1 || sink == w)) {
        R->status = EC_SUCCESS;
        if (score <= R->edist) {
            if (R->t_end > f->t_end0) R->s_edist = R->edist;
            R->edist = score;
            if (sink == -1 && R->q_end < R->c_seq.n) R->c_path.n--;  /* pop */
            if (R->edist == R->s_edist) {
                if (R->q_end != R->opt_seq.n ||
                    memcmp(R->c_seq.p, R->opt_seq.p, (size_t)R->q_end) != 0)
                    R->status = EC_AMBISEQ;
                if (R->status == EC_SUCCESS &&
                    !(R->c_path.n == R->opt_path.n &&
                      memcmp(R->c_path.p, R->opt_path.p, (size_t)R->c_path.n * sizeof(i64)) == 0))
                    R->status = EC_AMBISNQ;
            }
            R->opt_seq.n = 0;
            if (bb_reserve(R->A, &R->opt_seq, R->q_end)) return -1;
            memcpy(R->opt_seq.p, R->c_seq.p, (size_t)R->q_end);
            R->opt_seq.n = R->q_end;
            if (grow(R->A, (void **)&R->opt_path.p, &R->opt_path.cap, R->c_path.n, sizeof(i64), 256))
                return -1;
            memcpy(R->opt_path.p, R->c_path.p, (size_t)R->c_path.n * sizeof(i64));
            R->opt_path.n = R->c_path.n;
        } else if (score < R->s_edist) {
            R->s_edist = score;
        }
    }
    return 0;
}

/* Run the read's DFS until it needs a wavefront item (1), ends (0) or
 * fails to allocate (ECL_OOM).  `resumed`: the top frame's item came
 * back. */
static int dfs_run(const ecl_t *L, rd_t *R, int resumed) {
    frame_t *f;
    if (resumed) goto result;
    for (;;) {
        if (R->depth == 0) return 0;
        f = &R->fr[R->depth - 1];
        while (f->ai < f->ai_end && L->adel[f->ai]) f->ai++;
        if (f->ai >= f->ai_end) {
            /* this level returns: release its snapshot */
            R->snap_n = f->slot;
            R->depth--;
            if (R->depth) arc_done(R, &R->fr[R->depth - 1]);
            continue;
        }
        {
            i64 w = (i64)L->aw[f->ai];
            i64 l_seq = L->vtx_len[w >> 1];
            if (ib_push(R->A, &R->c_path, w) || append_arc(L, R, w, L->als[f->ai], l_seq))
                return ECL_OOM;
            f->w = w;
            f->l_seq = l_seq;
        }
        return 1;  /* conf.qs = c_seq; yield conf */
    result:
        f = &R->fr[R->depth - 1];
        if (after_extension(R, f)) return ECL_OOM;
        if (R->score <= R->bw && R->c_seq.n - f->l_seq <= R->tl + R->bw &&
            ((R->end_utg != -1 && R->end_utg != f->w) || R->t_end < R->tl)) {
            int e = dfs_enter(L, R);
            if (e < 0) return ECL_OOM;
            if (e == 0) arc_done(R, &R->fr[R->depth - 1]);
        } else {
            R->n_path++;
            arc_done(R, f);
        }
    }
}

/* ---------------- the read ---------------- */

/* hoco window of the read as ASCII, reverse-complemented when rev */
static void hoco_dna(const u8 *codes, i64 pos, i64 l, int rev, u8 *out) {
    if (rev)
        for (i64 i = 0; i < l; ++i) out[i] = NT[3 - codes[pos + l - 1 - i]];
    else
        for (i64 i = 0; i < l; ++i) out[i] = NT[codes[pos + i]];
}

/* The top of _correct_read's loop: find the block; when it is long
 * enough, set up the wavefront state and the DFS.  Returns the block's
 * kind, or ECL_OOM. */
static int block_begin(const ecl_t *L, rd_t *R) {
    i64 r = R->r;
    const u64 *k_mer = L->kflat + L->moff[r];
    const u32 *m_pos = L->mflat + L->moff[r];
    i64 n_scm = L->moff[r + 1] - L->moff[r];
    i64 w = L->w;
    i64 beg = R->beg;
    i64 beg_pos = (beg < 1) ? 0 : ((i64)(m_pos[beg - 1] >> 1) + w);
    beg_pos += MIN_ERR_SEQ_LEN;
    i64 end = beg + 1;
    while (end < n_scm) {
        u64 km = k_mer[end];
        if (!L->scm_del[km >> 1] && !(km & 1) && (i64)(m_pos[end] >> 1) >= beg_pos) break;
        end++;
    }
    R->end = end;
    if (!(beg >= 0 || end < n_scm)) {
        R->updated = 0;
        return BLK_NONE;
    }
    i64 beg_utg;
    if (beg < 0) {
        beg = end;  /* good syncmer */
        beg_utg = (i64)((k_mer[beg] & ~(u64)1) | ((m_pos[beg] & 1) ? 0 : 1));
        beg_pos = 0;
        R->end_utg = -1;
        R->l = (i64)(m_pos[beg] >> 1);
        R->rv = 1;
    } else {
        beg -= 1;  /* good syncmer */
        beg_utg = (i64)((k_mer[beg] & ~(u64)1) | (m_pos[beg] & 1));
        beg_pos = (i64)(m_pos[beg] >> 1) + w;
        if (end >= n_scm) {
            R->end_utg = -1;
            R->l = L->hoco_l[r] - beg_pos;
        } else {
            R->end_utg = (i64)((k_mer[end] & ~(u64)1) | (m_pos[end] & 1));
            R->l = (i64)(m_pos[end] >> 1) - beg_pos;
        }
        R->rv = 0;
    }
    R->beg = beg;
    if (R->l < MIN_ERR_SEQ_LEN) return BLK_SHORT;

    /* conf.reset(ts), is_ext, bw; _ec_path_search: dfs.reset(), c_path = [source] */
    i64 l = R->l;
    if (grow(R->A, (void **)&R->ts, &R->ts_cap, l, 1, 1024)) return ECL_OOM;
    hoco_dna(L->code_flat + L->hoff[r], beg_pos, l, R->rv, R->ts);
    R->tl = l;
    i64 bw = (i64)ceil((double)l * L->max_edist);
    R->bw = bw < MIN_ERR_BASE ? MIN_ERR_BASE : bw;
    R->score = R->t_end = R->q_end = 0;
    R->d0 = 0;
    R->n = 1;
    if (grow(R->A, (void **)&R->k, &R->kcap, 2 * R->bw + 16, sizeof(i64), 64)) return ECL_OOM;
    R->k[0] = -1;
    R->status = EC_FAILURE;
    R->n_path = 0;
    R->edist = R->s_edist = (i64)1 << 30;
    R->c_seq.n = R->opt_seq.n = R->c_path.n = R->opt_path.n = 0;
    R->snap_n = 0;
    R->depth = 0;
    if (ib_push(R->A, &R->c_path, beg_utg)) return ECL_OOM;
    return BLK_SEARCH;
}

static int push2(rd_t *R, i64 k, i64 m) {
    return ib_push(R->A, &R->ck, k) || ib_push(R->A, &R->cm, m) ? -1 : 0;
}

/* The rest of _correct_read's loop after the block's search: stats, the
 * splice, the scan to the next bad syncmer.  Returns 1 when the read
 * goes on, 0 when it is done, or ECL_OOM. */
static int block_end(const ecl_t *L, rd_t *R, int kind) {
    i64 r = R->r;
    const u64 *k_mer = L->kflat + L->moff[r];
    const u32 *m_pos = L->mflat + L->moff[r];
    i64 n_scm = L->moff[r + 1] - L->moff[r];
    i64 beg = R->beg, end = R->end;
    if (kind != BLK_NONE) {
        int err_c1 = EC_FAILURE;
        if (kind == BLK_SEARCH) {
            err_c1 = R->status;
            if (R->end_utg == -1) { R->stats[0]++; R->stats[1 + err_c1]++; }
            else { R->stats[5]++; R->stats[6 + err_c1]++; }
        } else {
            R->stats[10]++;
        }
        if (err_c1 == EC_SUCCESS) {
            i64 n = R->opt_path.n;
            const i64 *op = R->opt_path.p;
            if (R->rv) {
                for (i64 j = n - 1; j > 0; --j)
                    if (push2(R, (op[j] & ~(i64)1) | 1, (i64)(0xFFFFFFFFu ^ (u32)(op[j] & 1))))
                        return ECL_OOM;
            } else {
                for (i64 j = 1; j < n - 1; ++j)
                    if (push2(R, (op[j] & ~(i64)1) | 1, (i64)(0xFFFFFFFEu | (u32)(op[j] & 1))))
                        return ECL_OOM;
                if (R->end_utg == -1 && n > 1 &&
                    push2(R, (op[n - 1] & ~(i64)1) | 1, (i64)(0xFFFFFFFEu | (u32)(op[n - 1] & 1))))
                    return ECL_OOM;
            }
        } else if (R->rv) {
            for (i64 x = 0; x < beg; ++x)
                if (push2(R, (i64)k_mer[x], (i64)m_pos[x])) return ECL_OOM;
        } else if (beg + 1 < n_scm) {
            for (i64 x = beg + 1; x < end; ++x)
                if (push2(R, (i64)k_mer[x], (i64)m_pos[x])) return ECL_OOM;
        }
    }
    /* next bad syncmer (the reference's k_mer[end] check kept) */
    beg = end + 1;
    while (beg < n_scm) {
        if (L->scm_del[k_mer[beg] >> 1] || (k_mer[end] & 1)) break;
        beg++;
    }
    R->beg = beg;
    if (beg > n_scm) return 0;
    for (i64 x = end; x < beg; ++x)
        if (push2(R, (i64)k_mer[x], (i64)m_pos[x])) return ECL_OOM;
    return 1;
}

/* Run the read until it needs a wavefront item (1), is done (0; its
 * result is in its slot) or fails to allocate (ECL_OOM). */
static int read_run(ecl_t *L, rd_t *R, int resumed) {
    for (;;) {
        int kind, rc;
        if (resumed) {
            rc = dfs_run(L, R, 1);
            if (rc) return rc;
            kind = BLK_SEARCH;
            resumed = 0;
        } else {
            kind = block_begin(L, R);
            if (kind < 0) return kind;
            if (kind == BLK_SEARCH) {
                /* _ec_path_search's call of _dfs_search (n_path is 0) */
                if (dfs_enter(L, R) < 0) return ECL_OOM;
                rc = dfs_run(L, R, 0);
                if (rc) return rc;
            }
        }
        rc = block_end(L, R, kind);
        if (rc < 0) return rc;
        if (rc == 0) break;
    }
    /* done: the slot takes the corrected arrays when the read changed */
    slot_t *sl = &L->slots[R->r];
    sl->upd = (u8)R->updated;
    if (R->updated && R->ck.n) {
        sl->ck = R->ck.p; sl->cm = R->cm.p; sl->n = R->ck.n;
        memset(&R->ck, 0, sizeof(R->ck));
        memset(&R->cm, 0, sizeof(R->cm));
    }
    return 0;
}

static void read_start(rd_t *R, i64 r) {
    R->r = r;
    R->beg = -1;
    R->updated = 1;
    R->ck.n = R->cm.n = 0;
    memset(R->stats, 0, sizeof(R->stats));
}

/* ---------------- threads ---------------- */

struct par {
    void (*fn)(par_t *, i64, arena_t *);
    ecl_t *L;
    rd_t **reads;
    i32 *dst;
    const i32 *src;
    i64 n;
    int resumed;
    atomic_llong next;
    atomic_int err;
};

static void par_worker(par_t *p, i64 wid) {
    arena_t *A = &p->L->arena[wid];
    for (;;) {
        i64 i0 = atomic_fetch_add(&p->next, PAR_GRAIN);
        if (i0 >= p->n || atomic_load(&p->err)) break;
        i64 i1 = i0 + PAR_GRAIN < p->n ? i0 + PAR_GRAIN : p->n;
        for (i64 i = i0; i < i1; ++i) p->fn(p, i, A);
    }
}

static void *helper_main(void *arg) {
    helper_arg_t *h = (helper_arg_t *)arg;
    crew_t *C = &h->L->crew;
    u64 seen = 0;
    pthread_mutex_lock(&C->mu);
    for (;;) {
        while (!C->stop && C->gen == seen) pthread_cond_wait(&C->go, &C->mu);
        if (C->stop) break;
        seen = C->gen;
        par_t *job = C->job;
        pthread_mutex_unlock(&C->mu);
        par_worker(job, h->wid);
        pthread_mutex_lock(&C->mu);
        if (--C->busy == 0) pthread_cond_signal(&C->done);
    }
    pthread_mutex_unlock(&C->mu);
    return NULL;
}

/* p->fn(p, i, arena) for every i < p->n, over the handle's threads when
 * there are enough items (what each i writes is its own) */
static int par_for(par_t *p) {
    ecl_t *L = p->L;
    crew_t *C = &L->crew;
    atomic_init(&p->next, 0);
    atomic_init(&p->err, 0);
    if (p->n >= PAR_MIN && L->n_threads > 1 && C->n == 0) {
        for (i64 t = 1; t < L->n_threads; ++t) {
            L->helper[t].L = L;
            L->helper[t].wid = t;
            if (pthread_create(&C->tid[C->n], NULL, helper_main, &L->helper[t]) != 0) break;
            C->n++;
        }
    }
    if (p->n < PAR_MIN || C->n == 0) {
        par_worker(p, 0);
        return atomic_load(&p->err);
    }
    pthread_mutex_lock(&C->mu);
    C->job = p;
    C->busy = C->n;
    C->gen++;
    pthread_cond_broadcast(&C->go);
    pthread_mutex_unlock(&C->mu);
    par_worker(p, 0);
    pthread_mutex_lock(&C->mu);
    while (C->busy) pthread_cond_wait(&C->done, &C->mu);
    pthread_mutex_unlock(&C->mu);
    return atomic_load(&p->err);
}

static void run_one(par_t *p, i64 i, arena_t *A) {
    rd_t *R = p->reads[i];
    R->A = A;
    int rc = read_run(p->L, R, p->resumed);
    if (rc < 0) atomic_store(&p->err, -rc);
    R->pending = rc > 0;
}

/* ---------------- the handle ---------------- */

void ecl_free(ecl_t *L);

ecl_t *ecl_new(
    const i64 *idx_p, const i64 *idx_n, i64 n_vtx2,
    const u64 *aw, const i64 *als, const u8 *adel,
    const u8 *seq_flat, const i64 *seq_off, const i64 *vtx_len,
    const u8 *scm_del,
    const i64 *lsrc, const u8 *lrev, const u8 *lcodes,
    const u64 *kflat, const u32 *mflat, const i64 *moff, i64 n_reads,
    const u8 *code_flat, const i64 *hoff, const i64 *hoco_l,
    i64 w, double max_edist, i64 inflight, i64 n_threads)
{
    ecl_t *L = (ecl_t *)calloc(1, sizeof(ecl_t));
    if (!L) return NULL;
    L->idx_p = idx_p; L->idx_n = idx_n; L->n_vtx2 = n_vtx2;
    L->aw = aw; L->als = als; L->adel = adel;
    L->seq_flat = seq_flat; L->seq_off = seq_off; L->vtx_len = vtx_len;
    L->scm_del = scm_del;
    L->lsrc = lsrc; L->lrv = lrev; L->lcodes = lcodes;
    L->kflat = kflat; L->mflat = mflat; L->moff = moff; L->n_reads = n_reads;
    L->code_flat = code_flat; L->hoff = hoff; L->hoco_l = hoco_l;
    L->w = w; L->max_edist = max_edist;
    L->cap = (inflight <= 0 || inflight > n_reads) ? n_reads : inflight;
    L->n_threads = n_threads < 1 ? 1 : (n_threads > MAX_THREADS ? MAX_THREADS : n_threads);
    pthread_mutex_init(&L->crew.mu, NULL);
    pthread_cond_init(&L->crew.go, NULL);
    pthread_cond_init(&L->crew.done, NULL);
    L->slots = (slot_t *)calloc(n_reads ? n_reads : 1, sizeof(slot_t));
    i64 cap = L->cap ? L->cap : 1;
    L->live = (rd_t **)calloc(cap, sizeof(rd_t *));
    L->adm = (rd_t **)calloc(cap, sizeof(rd_t *));
    L->spare = (rd_t **)calloc(cap, sizeof(rd_t *));
    if (!L->slots || !L->live || !L->adm || !L->spare) {
        ecl_free(L);
        return NULL;
    }
    return L;
}

void ecl_free(ecl_t *L) {
    if (!L) return;
    crew_t *C = &L->crew;
    pthread_mutex_lock(&C->mu);
    C->stop = 1;
    pthread_cond_broadcast(&C->go);
    pthread_mutex_unlock(&C->mu);
    for (i64 t = 0; t < C->n; ++t) pthread_join(C->tid[t], NULL);
    pthread_mutex_destroy(&C->mu);
    pthread_cond_destroy(&C->go);
    pthread_cond_destroy(&C->done);
    for (i64 t = 0; t < MAX_THREADS; ++t) arena_free(&L->arena[t]);
    free(L->slots); free(L->live); free(L->adm); free(L->spare);
    free(L);
}

static void retire(ecl_t *L, rd_t *R) {
    for (int s = 0; s < 11; ++s) L->stats[s] += R->stats[s];
    L->spare[L->n_spare++] = R;
}

static i64 r16(i64 x) { return (x + 15) / 16 * 16; }

/* kernels/wf_ed.py:slot_width with d_cap_for (is_ext is always set) */
static i64 slot_width(i64 tl, i64 ql, i64 n, i64 bw, i64 score) {
    i64 xdb = bw >= 0 ? bw : 0;
    i64 need = tl + (ql > xdb ? ql : xdb) + 1;
    if (n > need) need = n;
    i64 cap = (need + 31) / 32 * 32;
    if (bw < 0) return cap;
    i64 steps = bw - score + 1;
    if (steps < 1) steps = 1;
    i64 s = n + 2 * steps;
    return s < cap ? s : cap;
}

/* Advance every read to its next request and lay the round out.  out[6]:
 * B, in_words, out_words, scratch_words, smem, items on the global
 * route.  Returns 0, ECL_OOM, or ECL_I32 when the round's offsets do not
 * fit int32 (out[0] holds B then). */
i64 ecl_layout(ecl_t *L, i64 smem_limit, i64 force_global, i64 *out) {
    memset(out, 0, 6 * sizeof(i64));
    par_t p;
    memset(&p, 0, sizeof(p));
    p.fn = run_one;
    p.L = L;
    if (L->resume) {
        p.reads = L->live;
        p.n = L->n_live;
        p.resumed = 1;
        if (par_for(&p)) return ECL_OOM;
        L->resume = 0;
        i64 kept = 0;
        for (i64 i = 0; i < L->n_live; ++i) {
            if (L->live[i]->pending) L->live[kept++] = L->live[i];
            else retire(L, L->live[i]);
        }
        L->n_live = kept;
    }
    /* admit in read order; a read that makes no request takes no place */
    while (L->n_live < L->cap && L->next_read < L->n_reads) {
        i64 m = L->cap - L->n_live;
        if (m > L->n_reads - L->next_read) m = L->n_reads - L->next_read;
        if (m > ADMIT_BATCH) m = ADMIT_BATCH;
        for (i64 j = 0; j < m; ++j) {
            rd_t *R;
            if (L->n_spare) {
                R = L->spare[--L->n_spare];
            } else {
                R = (rd_t *)arena_alloc(&L->arena[0], sizeof(rd_t));
                if (!R) {
                    while (j > 0) L->spare[L->n_spare++] = L->adm[--j];
                    return ECL_OOM;
                }
                memset(R, 0, sizeof(rd_t));
            }
            read_start(R, L->next_read + j);
            L->adm[j] = R;
        }
        p.reads = L->adm;
        p.n = m;
        p.resumed = 0;
        int err = par_for(&p);
        for (i64 j = 0; j < m; ++j) {
            rd_t *R = L->adm[j];
            if (!err && R->pending) L->live[L->n_live++] = R;
            else retire(L, R);
        }
        if (err) return ECL_OOM;
        L->next_read += m;
    }

    i64 B = L->n_live;
    if (grow(&L->arena[0], (void **)&L->lay, &L->lay_cap, B ? B : 1, sizeof(lay_t), 256)) return ECL_OOM;
    i64 pos = B * (DESC_WORDS + META_WORDS) * 4, ow = 0, sw = 0, smem = 0, n_glob = 0;
    for (i64 i = 0; i < B; ++i) {
        const rd_t *R = L->live[i];
        lay_t *y = &L->lay[i];
        i64 ql = R->c_seq.n;
        y->S = slot_width(R->tl, ql, R->n, R->bw, R->score);
        y->kb = r16(4 * R->n);
        y->tb = r16(R->tl);
        y->qb = r16(ql);
        y->start = pos;
        pos += y->kb + y->tb + y->qb;
        y->om = ow;
        ow += 8 + y->S;
        i64 need = r16(8 * y->S) + y->tb + y->qb;
        if (force_global || need > smem_limit) {
            y->scr = sw;
            sw += 2 * y->S;
            n_glob++;
        } else {
            y->scr = -1;
            if (need > smem) smem = need;
        }
    }
    out[0] = B;
    if (pos > I32_MAX || 4 * ow > I32_MAX || 4 * sw > I32_MAX) return ECL_I32;
    out[1] = pos / 4;
    out[2] = ow;
    out[3] = sw;
    out[4] = smem;
    out[5] = n_glob;
    L->B = B;
    L->in_words = pos / 4;
    L->out_words = ow;
    L->laid = 1;
    return 0;
}

static void pack_one(par_t *p, i64 i, arena_t *A) {
    (void)A;
    const ecl_t *L = p->L;
    const rd_t *R = L->live[i];
    const lay_t *y = &L->lay[i];
    i64 B = L->B, ql = R->c_seq.n;
    i32 *d = p->dst + i * DESC_WORDS;
    d[0] = (i32)(y->start + y->kb);
    d[1] = (i32)(y->start + y->kb + y->tb);
    d[2] = (i32)(B * DESC_WORDS + META_WORDS * i);
    d[3] = (i32)(y->start / 4);
    d[4] = (i32)y->om;
    d[5] = (i32)(y->om + 8);
    d[6] = (i32)y->scr;
    d[7] = (i32)y->S;
    d[8] = (i32)R->tl;
    d[9] = (i32)ql;
    d[10] = d[11] = 0;
    i32 *m = p->dst + B * DESC_WORDS + META_WORDS * i;
    m[0] = (i32)R->tl; m[1] = (i32)ql; m[2] = 1; m[3] = (i32)R->bw;
    m[4] = (i32)R->score; m[5] = (i32)R->d0; m[6] = (i32)R->n; m[7] = 0;
    u8 *b = (u8 *)p->dst + y->start;
    i32 *k = (i32 *)b;
    for (i64 j = 0; j < R->n; ++j) k[j] = (i32)R->k[j];
    memset(b + 4 * R->n, 0, (size_t)(y->kb - 4 * R->n));
    b += y->kb;
    memcpy(b, R->ts, (size_t)R->tl);
    memset(b + R->tl, 0, (size_t)(y->tb - R->tl));
    b += y->tb;
    memcpy(b, R->c_seq.p, (size_t)ql);
    memset(b + ql, 0, (size_t)(y->qb - ql));
}

/* Write the laid-out round's in_words input words into dst. */
i64 ecl_pack(ecl_t *L, i32 *dst) {
    if (!L->laid) return ECL_STATE;
    par_t p;
    memset(&p, 0, sizeof(p));
    p.fn = pack_one;
    p.L = L;
    p.dst = dst;
    p.n = L->B;
    par_for(&p);
    return 0;
}

static void unpack_one(par_t *p, i64 i, arena_t *A) {
    rd_t *R = p->L->live[i];
    const lay_t *y = &p->L->lay[i];
    const i32 *om = p->src + y->om;
    i64 n = om[2];
    if (grow(A, (void **)&R->k, &R->kcap, n, sizeof(i64), 64)) {
        atomic_store(&p->err, 1);
        return;
    }
    R->score = om[0];
    R->d0 = om[1];
    R->n = n;
    const i32 *k = om + 8;
    for (i64 j = 0; j < n; ++j) R->k[j] = k[j];
    if (om[3]) {
        R->t_end = (i64)om[4] + 1;
        R->q_end = (i64)om[5] + 1;
    } else {
        R->t_end = R->q_end = 0;
    }
}

/* Apply the round's output words.  Returns -1, the index of the first
 * item whose err is set (nothing is applied then), or ECL_OOM. */
i64 ecl_unpack(ecl_t *L, const i32 *src) {
    if (!L->laid) return ECL_STATE;
    for (i64 i = 0; i < L->B; ++i)
        if (src[L->lay[i].om + 6]) return i;
    for (i64 i = 0; i < L->B; ++i) {
        /* the item's meta in as ecl_pack wrote it, before it is applied */
        const rd_t *R = L->live[i];
        const i32 *om = src + L->lay[i].om;
        L->work[0] += R->tl + R->c_seq.n;
        L->work[1] += R->n;
        L->work[2] += om[2];
        L->work[3] += ((i64)om[0] - R->score) * (R->n + om[2]);
    }
    par_t p;
    memset(&p, 0, sizeof(p));
    p.fn = unpack_one;
    p.L = L;
    p.src = src;
    p.n = L->B;
    if (par_for(&p)) return ECL_OOM;
    L->laid = 0;
    L->resume = 1;
    L->extensions += L->B;
    return -1;
}

/* The corrected syncmers' count once every read is done, else ECL_STATE. */
i64 ecl_out_size(const ecl_t *L) {
    if (L->n_live || L->next_read < L->n_reads) return ECL_STATE;
    i64 total = 0;
    for (i64 r = 0; r < L->n_reads; ++r)
        if (L->slots[r].upd) total += L->slots[r].n;
    return total;
}

/* native/ec.c:ec_correct_reads's outputs: stats[11] (added to), the
 * updated reads' syncmers in read order, out_cut[n_reads+1], out_upd.
 * Returns the count written, -1 when it exceeds cap_out, or ECL_STATE. */
i64 ecl_finish(const ecl_t *L, i64 *stats, u64 *out_kmer, u32 *out_mpos,
               i64 *out_cut, u8 *out_upd, i64 cap_out) {
    if (L->n_live || L->next_read < L->n_reads) return ECL_STATE;
    for (int s = 0; s < 11; ++s) stats[s] += L->stats[s];
    i64 total = 0;
    out_cut[0] = 0;
    for (i64 r = 0; r < L->n_reads; ++r) {
        const slot_t *sl = &L->slots[r];
        out_upd[r] = sl->upd;
        if (sl->upd) {
            if (total + sl->n > cap_out) return -1;
            for (i64 x = 0; x < sl->n; ++x) {
                out_kmer[total + x] = (u64)sl->ck[x];
                out_mpos[total + x] = (u32)sl->cm[x];
            }
            total += sl->n;
        }
        out_cut[r + 1] = total;
    }
    return total;
}

/* the extensions made: items applied */
i64 ecl_extensions(const ecl_t *L) {
    return L->extensions;
}

/* The kernel's work over the items applied, from each item's meta in and
 * out_meta alone: out[0] the target and query bases (sum of tl + ql),
 * out[1] and out[2] the diagonals of the waves in and out (sums of n),
 * out[3] twice the wave cells, sum of (score out - score in) x (n in +
 * n out). */
void ecl_work(const ecl_t *L, i64 *out) {
    for (int j = 0; j < 4; ++j) out[j] = L->work[j];
}
