/* Native consensus hot loops (syncasm.c:465-1046 semantics as realized
 * by oatk_tpu/asm/consensus.py, which is byte-parity-validated against
 * the reference binaries).
 *
 * Both functions operate on flat concatenations of the per-read arrays
 * (built once per scg_consensus call):
 *   kflat[moff[sid]+idx]  u64 syncmer id<<1|ec_flag per read syncmer
 *   mflat[moff[sid]+idx]  u32 hoco_pos<<1|rev per read syncmer
 *   code_flat[hoff[sid]+p] u8 hoco base codes
 *   rl_flat[hoff[sid]+p]   u8 homopolymer run length MINUS ONE,
 *                          saturated at 255 (reference sr_t layout);
 *                          exact values for saturated entries live in
 *                          the sorted (rl_ovf_pos, rl_ovf_len) overflow
 *                          list threaded through every entry point
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define SCM_IDX_MASK 0x7FFFFFFFLL

/* run length - 1 at a global hoco position: the u8 value, or the exact
 * overflow entry when saturated (255 always has one by construction) */
static inline int64_t rl_m1_at(const uint8_t *rl, int64_t pos,
                               const int64_t *ovf_pos, const int64_t *ovf_len,
                               int64_t n_ovf)
{
    uint8_t v = rl[pos];
    if (v != 255) return v;
    int64_t lo = 0, hi = n_ovf;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (ovf_pos[mid] < pos) lo = mid + 1; else hi = mid;
    }
    if (lo < n_ovf && ovf_pos[lo] == pos) return ovf_len[lo];
    return 255; /* saturated with no entry (foreign stream): best effort */
}

/* Mode of per-read adjacent distances between two syncmers; ties break
 * count desc then distance asc.  pos arrays are sorted by read id. */
int64_t scm_overlap_mode(const uint64_t *pos1, int64_t n1,
                         const uint64_t *pos2, int64_t n2,
                         int64_t rc1, int64_t rc2,
                         const uint64_t *kflat, const uint32_t *mflat,
                         const int64_t *moff)
{
    int64_t stack_d[1024];
    int64_t *dv = stack_d;
    int64_t cap = 1024, nd = 0;
    int64_t p2 = 0, a, j;

    for (a = 0; a < n1; ++a) {
        uint64_t e1 = pos1[a];
        int64_t r1 = (int64_t)(e1 >> 32);
        int64_t i1 = (int64_t)(e1 >> 1) & SCM_IDX_MASK;
        int64_t c1 = (int64_t)(e1 & 1);
        int64_t g1 = moff[r1] + i1;
        if (kflat[g1] & 1) continue; /* error-corrected */
        int64_t l1 = (int64_t)(mflat[g1] >> 1);
        while (p2 < n2 && (int64_t)(pos2[p2] >> 32) < r1) ++p2;
        for (j = p2; j < n2; ++j) {
            uint64_t e2 = pos2[j];
            int64_t r2 = (int64_t)(e2 >> 32);
            if (r2 != r1) break;
            int64_t i2 = (int64_t)(e2 >> 1) & SCM_IDX_MASK;
            int64_t g2 = moff[r2] + i2;
            if (kflat[g2] & 1) continue;
            int64_t l2 = (int64_t)(mflat[g2] >> 1);
            int64_t c2 = (int64_t)(e2 & 1);
            int64_t d;
            if (i1 == i2 + 1 && c1 != rc1 && c2 != rc2) d = l1 - l2;
            else if (i1 + 1 == i2 && c1 == rc1 && c2 == rc2) d = l2 - l1;
            else continue;
            if (nd == cap) {
                cap *= 2;
                if (dv == stack_d) {
                    dv = (int64_t *)malloc(cap * sizeof(int64_t));
                    if (!dv) return 0;
                    memcpy(dv, stack_d, nd * sizeof(int64_t));
                } else {
                    int64_t *p = (int64_t *)realloc(dv, cap * sizeof(int64_t));
                    if (!p) { free(dv); return 0; }
                    dv = p;
                }
            }
            dv[nd++] = d;
        }
    }
    if (nd == 0) { if (dv != stack_d) free(dv); return 0; }

    /* insertion sort is fine (distance lists are short and clustered) */
    for (a = 1; a < nd; ++a) {
        int64_t key = dv[a];
        for (j = a - 1; j >= 0 && dv[j] > key; --j) dv[j + 1] = dv[j];
        dv[j + 1] = key;
    }
    int64_t best_d = dv[0], best_c = 1, cur_c = 1;
    for (a = 1; a < nd; ++a) {
        if (dv[a] == dv[a - 1]) ++cur_c;
        else cur_c = 1;
        if (cur_c > best_c) { best_c = cur_c; best_d = dv[a]; }
    }
    if (dv != stack_d) free(dv);
    return best_d;
}

/* Consensus inputs for one syncmer window of length l starting at
 * offset beg (>=0) within the k-mer.  Fills base_out[l] with hoco codes
 * from the first un-corrected occurrence and (when need_rl) accumulates
 * totrl_out[l] += run_length-1 over all un-corrected occurrences.
 * Returns the number of contributing occurrences (0 => caller emits N). */
int64_t scm_consensus_fill(const uint64_t *mpos, int64_t n_occ,
                           int64_t rev, int64_t beg, int64_t l,
                           const uint64_t *kflat, const uint32_t *mflat,
                           const int64_t *moff,
                           const uint8_t *code_flat, const uint8_t *rl_flat,
                           const int64_t *hoff,
                           const int64_t *rl_ovf_pos, const int64_t *rl_ovf_len,
                           int64_t n_rl_ovf,
                           int64_t need_rl, int64_t hoco_total,
                           uint8_t *base_out, int64_t *totrl_out)
{
    int64_t m_seq = 0, a, j;
    int have_base = 0;
    for (a = 0; a < n_occ; ++a) {
        uint64_t e = mpos[a];
        int64_t sid = (int64_t)(e >> 32);
        int64_t idx = (int64_t)(e >> 1) & SCM_IDX_MASK;
        int64_t g = moff[sid] + idx;
        if (kflat[g] & 1) continue;
        uint32_t praw = mflat[g];
        int64_t r = (int64_t)(praw & 1) ^ rev;
        int64_t p = (int64_t)(praw >> 1);
        if (!r) p += beg;
        int64_t st = hoff[sid] + p;
        if (st < 0 || st + l > hoco_total) continue; /* corrupt entry guard */
        if (!have_base) {
            if (r)
                for (j = 0; j < l; ++j) base_out[j] = 3 - code_flat[st + l - 1 - j];
            else
                memcpy(base_out, code_flat + st, l);
            have_base = 1;
            if (!need_rl) return 1;
        }
        if (r)
            for (j = 0; j < l; ++j)
                totrl_out[j] += rl_m1_at(rl_flat, st + l - 1 - j,
                                         rl_ovf_pos, rl_ovf_len, n_rl_ovf);
        else
            for (j = 0; j < l; ++j)
                totrl_out[j] += rl_m1_at(rl_flat, st + j,
                                         rl_ovf_pos, rl_ovf_len, n_rl_ovf);
        ++m_seq;
    }
    return have_base ? m_seq : 0;
}

/* Full unitig consensus emission: overlap-mode stitching of the oriented
 * syncmer list v[nv], per-window base fill + run-length means, ASCII
 * output (hoco_seq => one char per hoco base; else run-length expanded).
 * Mirrors unitig_consensus + syncmer_consensus in asm/consensus.py.
 * Returns emitted length, or -1 when out_cap is too small. */
#include <math.h>

int64_t utg_consensus_emit(const uint64_t *v, int64_t nv,
                           int64_t w, int64_t hoco_seq,
                           const uint64_t *mp_flat, const int64_t *mp_off,
                           const uint64_t *kflat, const uint32_t *mflat,
                           const int64_t *moff,
                           const uint8_t *code_flat, const uint8_t *rl_flat,
                           const int64_t *hoff,
                           const int64_t *rl_ovf_pos, const int64_t *rl_ovf_len,
                           int64_t n_rl_ovf, int64_t hoco_total,
                           uint8_t *out, int64_t out_cap)
{
    static const char NT[4] = {'A', 'C', 'G', 'T'};
    if (nv == 0) return 0;
    int64_t *pos = (int64_t *)malloc(nv * sizeof(int64_t));
    uint8_t *base = (uint8_t *)malloc(w);
    int64_t *totrl = (int64_t *)malloc(w * sizeof(int64_t));
    if (!pos || !base || !totrl) { free(pos); free(base); free(totrl); return -1; }
    pos[0] = 0;
    int64_t i, j;
    for (i = 1; i < nv; ++i) {
        int64_t m1 = (int64_t)(v[i - 1] >> 1), rc1 = (int64_t)(v[i - 1] & 1);
        int64_t m2 = (int64_t)(v[i] >> 1), rc2 = (int64_t)(v[i] & 1);
        pos[i] = pos[i - 1] + scm_overlap_mode(
            mp_flat + mp_off[m1], mp_off[m1 + 1] - mp_off[m1],
            mp_flat + mp_off[m2], mp_off[m2 + 1] - mp_off[m2],
            rc1, rc2, kflat, mflat, moff);
    }

    int64_t outp = 0, end_pos = 0;
    i = 0;
    while (i < nv) {
        while (i + 1 < nv && pos[i + 1] <= end_pos) ++i;
        int64_t beg_pos = pos[i];
        int64_t beg = end_pos - beg_pos;
        int64_t s = (int64_t)(v[i] >> 1), rev = (int64_t)(v[i] & 1);
        if (beg < 0) {
            if (outp - beg > out_cap) goto full;
            memset(out + outp, 'N', -beg);
            outp -= beg;
            beg = 0;
        }
        int64_t l = w - beg;
        memset(totrl, 0, l * sizeof(int64_t));
        int64_t m_seq = scm_consensus_fill(
            mp_flat + mp_off[s], mp_off[s + 1] - mp_off[s], rev, beg, l,
            kflat, mflat, moff, code_flat, rl_flat, hoff,
            rl_ovf_pos, rl_ovf_len, n_rl_ovf,
            !hoco_seq, hoco_total, base, totrl);
        if (m_seq == 0) {
            if (outp + l > out_cap) goto full;
            memset(out + outp, 'N', l);
            outp += l;
        } else if (hoco_seq) {
            if (outp + l > out_cap) goto full;
            for (j = 0; j < l; ++j) out[outp + j] = NT[base[j] & 3];
            outp += l;
        } else {
            for (j = 0; j < l; ++j) {
                int64_t rep = 1 + (int64_t)floor((double)totrl[j] / (double)m_seq + 0.5);
                if (outp + rep > out_cap) goto full;
                memset(out + outp, NT[base[j] & 3], rep);
                outp += rep;
            }
        }
        end_pos = beg_pos + w;
        ++i;
    }
    free(pos); free(base); free(totrl);
    return outp;
full:
    free(pos); free(base); free(totrl);
    return -1;
}

/* Batched whole-graph consensus, staged for parallelism at BOTH
 * granularities:
 *   A (parallel): adjacent-syncmer overlap modes for every live vertex,
 *     flattened into one task list (the expensive per-pair distance
 *     mode), so a single huge unitig still uses every core;
 *   B (sequential, cheap): the window plan -- exactly the windows the
 *     sequential scan would emit, with their (entry, beg, l, N-pad);
 *   C (parallel): window emission into per-thread buffers balanced by
 *     planned output size, merged in window order.
 * Output is byte-identical to the sequential loop for any thread
 * count.  Returns total emitted length, -1 if out_cap is too small,
 * -2 on allocation failure. */
#include <pthread.h>

typedef struct {
    int64_t w, hoco_seq;
    const uint64_t *mp_flat; const int64_t *mp_off;
    const uint64_t *kflat; const uint32_t *mflat; const int64_t *moff;
    const uint8_t *code_flat; const uint8_t *rl_flat;
    const int64_t *hoff; int64_t hoco_total;
    const int64_t *rl_ovf_pos, *rl_ovf_len; int64_t n_rl_ovf;
    /* stage A range */
    const uint64_t *pair_a, *pair_b;
    int64_t *pair_d;
    int64_t pa0, pa1;
    /* stage C range */
    const uint64_t *win_s;
    const int64_t *win_beg, *win_l, *win_pad;
    int64_t *win_len;
    int64_t w0, w1;
    uint8_t *buf; int64_t buf_cap, emitted;
    int err;
} cons2_t;

static void *cons_pair_worker(void *arg) {
    cons2_t *r = (cons2_t *)arg;
    for (int64_t p = r->pa0; p < r->pa1; ++p) {
        int64_t m1 = (int64_t)(r->pair_a[p] >> 1), rc1 = (int64_t)(r->pair_a[p] & 1);
        int64_t m2 = (int64_t)(r->pair_b[p] >> 1), rc2 = (int64_t)(r->pair_b[p] & 1);
        r->pair_d[p] = scm_overlap_mode(
            r->mp_flat + r->mp_off[m1], r->mp_off[m1 + 1] - r->mp_off[m1],
            r->mp_flat + r->mp_off[m2], r->mp_off[m2 + 1] - r->mp_off[m2],
            rc1, rc2, r->kflat, r->mflat, r->moff);
    }
    return NULL;
}

static int cons2_reserve(cons2_t *r, int64_t need) {
    if (r->emitted + need <= r->buf_cap) return 0;
    int64_t nc = r->buf_cap * 2 + need + 4096;
    uint8_t *nb = (uint8_t *)realloc(r->buf, nc);
    if (!nb) return -1;
    r->buf = nb; r->buf_cap = nc;
    return 0;
}

static void *cons_win_worker(void *arg) {
    static const char NT[4] = {'A', 'C', 'G', 'T'};
    cons2_t *r = (cons2_t *)arg;
    int64_t w = r->w;
    uint8_t *base = (uint8_t *)malloc(w);
    int64_t *totrl = (int64_t *)malloc(w * sizeof(int64_t));
    if (!base || !totrl) { free(base); free(totrl); r->err = 1; return NULL; }
    for (int64_t q = r->w0; q < r->w1; ++q) {
        int64_t start = r->emitted;
        int64_t pad = r->win_pad[q], beg = r->win_beg[q], l = r->win_l[q];
        int64_t s = (int64_t)(r->win_s[q] >> 1), rev = (int64_t)(r->win_s[q] & 1);
        memset(totrl, 0, l * sizeof(int64_t));
        int64_t m_seq = scm_consensus_fill(
            r->mp_flat + r->mp_off[s], r->mp_off[s + 1] - r->mp_off[s],
            rev, beg, l,
            r->kflat, r->mflat, r->moff, r->code_flat, r->rl_flat, r->hoff,
            r->rl_ovf_pos, r->rl_ovf_len, r->n_rl_ovf,
            !r->hoco_seq, r->hoco_total, base, totrl);
        int64_t body;
        if (m_seq == 0 || r->hoco_seq) {
            body = l;
        } else {
            body = 0;
            for (int64_t j = 0; j < l; ++j)
                body += 1 + (int64_t)floor((double)totrl[j] / (double)m_seq + 0.5);
        }
        if (cons2_reserve(r, pad + body) != 0) { r->err = 1; break; }
        uint8_t *o = r->buf + r->emitted;
        if (pad) { memset(o, 'N', pad); o += pad; }
        if (m_seq == 0) {
            memset(o, 'N', l); o += l;
        } else if (r->hoco_seq) {
            for (int64_t j = 0; j < l; ++j) o[j] = NT[base[j] & 3];
            o += l;
        } else {
            for (int64_t j = 0; j < l; ++j) {
                int64_t rep = 1 + (int64_t)floor((double)totrl[j] / (double)m_seq + 0.5);
                memset(o, NT[base[j] & 3], rep);
                o += rep;
            }
        }
        r->emitted = o - r->buf;
        r->win_len[q] = r->emitted - start;
    }
    free(base); free(totrl);
    return NULL;
}

int64_t utg_consensus_emit_batch(
    const uint64_t *va_flat, const int64_t *va_off,
    const uint8_t *live, int64_t n_vtx,
    int64_t w, int64_t hoco_seq,
    const uint64_t *mp_flat, const int64_t *mp_off,
    const uint64_t *kflat, const uint32_t *mflat, const int64_t *moff,
    const uint8_t *code_flat, const uint8_t *rl_flat,
    const int64_t *hoff,
    const int64_t *rl_ovf_pos, const int64_t *rl_ovf_len, int64_t n_rl_ovf,
    int64_t hoco_total,
    int64_t n_threads,
    uint8_t *out, int64_t out_cap, int64_t *cuts)
{
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    int64_t total_scm = n_vtx ? va_off[n_vtx] : 0;
    /* approx workload ~ syncmer mass * window size; below ~64k the
     * pthread spawn cost outweighs any split */
    if (total_scm * w < 65536) n_threads = 1;

    int64_t ret = -2;
    uint64_t *pair_a = NULL, *pair_b = NULL;
    int64_t *pair_d = NULL, *pair_voff = NULL, *pos = NULL;
    uint64_t *win_s = NULL;
    int64_t *win_beg = NULL, *win_l = NULL, *win_pad = NULL, *win_len = NULL;
    int64_t *wv_off = NULL;
    cons2_t rg[16];
    memset(rg, 0, sizeof(rg));

    /* ---- stage A: flatten adjacent pairs over live vertices ---- */
    pair_voff = (int64_t *)malloc((n_vtx + 1) * sizeof(int64_t));
    if (!pair_voff) goto done;
    int64_t n_pair = 0, max_nv = 1;
    for (int64_t i = 0; i < n_vtx; ++i) {
        pair_voff[i] = n_pair;
        int64_t nv = va_off[i + 1] - va_off[i];
        if (live[i] && nv > 0) {
            n_pair += nv - 1;
            if (nv > max_nv) max_nv = nv;
        }
    }
    pair_voff[n_vtx] = n_pair;
    pair_a = (uint64_t *)malloc((n_pair ? n_pair : 1) * sizeof(uint64_t));
    pair_b = (uint64_t *)malloc((n_pair ? n_pair : 1) * sizeof(uint64_t));
    pair_d = (int64_t *)malloc((n_pair ? n_pair : 1) * sizeof(int64_t));
    if (!pair_a || !pair_b || !pair_d) goto done;
    for (int64_t i = 0; i < n_vtx; ++i) {
        if (!live[i]) continue;
        const uint64_t *v = va_flat + va_off[i];
        int64_t nv = va_off[i + 1] - va_off[i];
        int64_t b0 = pair_voff[i];
        for (int64_t j = 1; j < nv; ++j) {
            pair_a[b0 + j - 1] = v[j - 1];
            pair_b[b0 + j - 1] = v[j];
        }
    }
    for (int64_t t = 0; t < 16; ++t) {
        rg[t].w = w; rg[t].hoco_seq = hoco_seq;
        rg[t].mp_flat = mp_flat; rg[t].mp_off = mp_off;
        rg[t].kflat = kflat; rg[t].mflat = mflat; rg[t].moff = moff;
        rg[t].code_flat = code_flat; rg[t].rl_flat = rl_flat;
        rg[t].hoff = hoff; rg[t].hoco_total = hoco_total;
        rg[t].rl_ovf_pos = rl_ovf_pos; rg[t].rl_ovf_len = rl_ovf_len;
        rg[t].n_rl_ovf = n_rl_ovf;
        rg[t].pair_a = pair_a; rg[t].pair_b = pair_b; rg[t].pair_d = pair_d;
    }
    {
        int64_t tA = n_threads;
        if (tA > n_pair) tA = n_pair > 0 ? n_pair : 1;
        for (int64_t t = 0; t < tA; ++t) {
            rg[t].pa0 = n_pair * t / tA;
            rg[t].pa1 = n_pair * (t + 1) / tA;
        }
        if (tA <= 1) {
            if (n_pair) cons_pair_worker(&rg[0]);
        } else {
            pthread_t tid[16];
            int64_t spawned = 0;
            for (int64_t t = 0; t < tA; ++t) {
                if (pthread_create(&tid[t], NULL, cons_pair_worker, &rg[t]) != 0) break;
                spawned++;
            }
            for (int64_t t = spawned; t < tA; ++t) cons_pair_worker(&rg[t]);
            for (int64_t t = 0; t < spawned; ++t) pthread_join(tid[t], NULL);
        }
    }

    /* ---- stage B: window plan (cheap sequential scan) ---- */
    pos = (int64_t *)malloc(max_nv * sizeof(int64_t));
    win_s = (uint64_t *)malloc((total_scm ? total_scm : 1) * sizeof(uint64_t));
    win_beg = (int64_t *)malloc((total_scm ? total_scm : 1) * sizeof(int64_t));
    win_l = (int64_t *)malloc((total_scm ? total_scm : 1) * sizeof(int64_t));
    win_pad = (int64_t *)malloc((total_scm ? total_scm : 1) * sizeof(int64_t));
    win_len = (int64_t *)malloc((total_scm ? total_scm : 1) * sizeof(int64_t));
    wv_off = (int64_t *)malloc((n_vtx + 1) * sizeof(int64_t));
    if (!pos || !win_s || !win_beg || !win_l || !win_pad || !win_len || !wv_off)
        goto done;
    int64_t n_win = 0;
    for (int64_t i = 0; i < n_vtx; ++i) {
        wv_off[i] = n_win;
        if (!live[i]) continue;
        const uint64_t *v = va_flat + va_off[i];
        int64_t nv = va_off[i + 1] - va_off[i];
        if (nv == 0) continue;
        pos[0] = 0;
        const int64_t *pd = pair_d + pair_voff[i];
        for (int64_t j = 1; j < nv; ++j) pos[j] = pos[j - 1] + pd[j - 1];
        int64_t j = 0, end_pos = 0;
        while (j < nv) {
            while (j + 1 < nv && pos[j + 1] <= end_pos) ++j;
            int64_t beg_pos = pos[j];
            int64_t beg = end_pos - beg_pos, padn = 0;
            if (beg < 0) { padn = -beg; beg = 0; }
            win_s[n_win] = v[j];
            win_beg[n_win] = beg;
            win_l[n_win] = w - beg;
            win_pad[n_win] = padn;
            ++n_win;
            end_pos = beg_pos + w;
            ++j;
        }
    }
    wv_off[n_vtx] = n_win;

    /* ---- stage C: window emission, balanced by planned output ---- */
    {
        int64_t tC = n_threads;
        if (tC > n_win) tC = n_win > 0 ? n_win : 1;
        int64_t plan_total = 0;
        for (int64_t q = 0; q < n_win; ++q)
            plan_total += win_pad[q] + win_l[q];
        int64_t q = 0, acc = 0;
        for (int64_t t = 0; t < tC; ++t) {
            rg[t].win_s = win_s; rg[t].win_beg = win_beg;
            rg[t].win_l = win_l; rg[t].win_pad = win_pad;
            rg[t].win_len = win_len;
            rg[t].w0 = q;
            int64_t target = plan_total * (t + 1) / tC;
            while (q < n_win && acc < target) acc += win_pad[q] + win_l[q], ++q;
            if (t == tC - 1) q = n_win;
            rg[t].w1 = q;
            int64_t mass = 0;
            for (int64_t x = rg[t].w0; x < rg[t].w1; ++x)
                mass += win_pad[x] + win_l[x];
            rg[t].buf_cap = mass * 2 + 4096;
            rg[t].buf = (uint8_t *)malloc(rg[t].buf_cap);
            rg[t].emitted = 0; rg[t].err = 0;
            if (!rg[t].buf) goto done;
        }
        if (tC <= 1) {
            if (n_win) cons_win_worker(&rg[0]);
        } else {
            pthread_t tid[16];
            int64_t spawned = 0;
            for (int64_t t = 0; t < tC; ++t) {
                if (pthread_create(&tid[t], NULL, cons_win_worker, &rg[t]) != 0) break;
                spawned++;
            }
            for (int64_t t = spawned; t < tC; ++t) cons_win_worker(&rg[t]);
            for (int64_t t = 0; t < spawned; ++t) pthread_join(tid[t], NULL);
        }
        int err = 0;
        int64_t total = 0;
        for (int64_t t = 0; t < tC; ++t) { err |= rg[t].err; total += rg[t].emitted; }
        if (err) { ret = -2; goto done; }
        if (total > out_cap) { ret = -1; goto done; }
        int64_t outp = 0;
        for (int64_t t = 0; t < tC; ++t) {
            memcpy(out + outp, rg[t].buf, rg[t].emitted);
            outp += rg[t].emitted;
        }
        cuts[0] = 0;
        {
            int64_t accw = 0, qq = 0;
            for (int64_t i = 0; i < n_vtx; ++i) {
                for (; qq < wv_off[i + 1]; ++qq) accw += win_len[qq];
                cuts[i + 1] = accw;
            }
        }
        ret = total;
    }
done:
    for (int64_t t = 0; t < 16; ++t) free(rg[t].buf);
    free(pair_a); free(pair_b); free(pair_d); free(pair_voff);
    free(pos); free(win_s); free(win_beg); free(win_l); free(win_pad);
    free(win_len); free(wv_off);
    return ret;
}

/* Batched arc overlap-length computation: mirrors the arc loop of
 * asm/consensus.py scg_consensus (ln>0 => sub-unitig consensus length;
 * else boundary-syncmer overlap mode, + single-window consensus length
 * when the overlap is < w).  out_als[ai] = computed l for processed
 * arcs, untouched otherwise.  Returns 0, or -1 when scratch_cap is too
 * small for a sub-unitig emission (caller regrows). */
typedef struct {
    const uint64_t *av, *aw; const int64_t *aln;
    const uint8_t *adel, *acomp; int64_t n_arc;
    const uint64_t *va_flat; const int64_t *va_off, *vtx_len;
    int64_t w, hoco_seq;
    const uint64_t *mp_flat; const int64_t *mp_off;
    const uint64_t *kflat; const uint32_t *mflat; const int64_t *moff;
    const uint8_t *code_flat, *rl_flat;
    const int64_t *hoff;
    const int64_t *rl_ovf_pos, *rl_ovf_len; int64_t n_rl_ovf;
    int64_t hoco_total;
    int64_t scratch_cap;
    int64_t *out_als;
    _Atomic long long next;
    _Atomic int err;  /* 1 = scratch too small, 2 = alloc failure */
} aob_t;

#include <stdatomic.h>

static void *aob_worker(void *argp) {
    aob_t *c = (aob_t *)argp;
    int64_t w = c->w;
    uint8_t *base = (uint8_t *)malloc(w);
    int64_t *totrl = (int64_t *)malloc(w * sizeof(int64_t));
    uint8_t *scratch = (uint8_t *)malloc(c->scratch_cap ? c->scratch_cap : 1);
    if (!base || !totrl || !scratch) {
        free(base); free(totrl); free(scratch);
        atomic_store(&c->err, 2);
        return NULL;
    }
    const uint64_t *av = c->av, *aw = c->aw;
    const int64_t *aln = c->aln;
    for (;;) {
        int64_t a0 = atomic_fetch_add(&c->next, 256);
        if (a0 >= c->n_arc || atomic_load(&c->err)) break;
        int64_t a1 = a0 + 256 < c->n_arc ? a0 + 256 : c->n_arc;
        for (int64_t ai = a0; ai < a1; ++ai) {
        if (c->adel[ai] || c->acomp[ai]) continue;
        int64_t v = (int64_t)av[ai], t = (int64_t)aw[ai];
        int64_t ln = aln[ai];
        int64_t l;
        const uint64_t *a = c->va_flat + c->va_off[v >> 1];
        int64_t na = c->va_off[(v >> 1) + 1] - c->va_off[v >> 1];
        if (ln > 0) {
            const uint64_t *sub = (v & 1) ? a : a + (na - ln);
            l = utg_consensus_emit(sub, ln, w, c->hoco_seq,
                                   c->mp_flat, c->mp_off, c->kflat, c->mflat, c->moff,
                                   c->code_flat, c->rl_flat, c->hoff,
                                   c->rl_ovf_pos, c->rl_ovf_len, c->n_rl_ovf,
                                   c->hoco_total, scratch, c->scratch_cap);
            if (l < 0) { atomic_store(&c->err, 1); break; }
        } else {
            int64_t z = v & 1;
            int64_t vv = (int64_t)(z ? a[0] : a[na - 1]) ^ z;
            const uint64_t *a2 = c->va_flat + c->va_off[t >> 1];
            int64_t na2 = c->va_off[(t >> 1) + 1] - c->va_off[t >> 1];
            int64_t z2 = t & 1;
            int64_t tt = (int64_t)(z2 ? a2[na2 - 1] : a2[0]) ^ z2;
            int64_t m1 = vv >> 1, rc1 = vv & 1, m2 = tt >> 1, rc2 = tt & 1;
            l = scm_overlap_mode(c->mp_flat + c->mp_off[m1], c->mp_off[m1 + 1] - c->mp_off[m1],
                                 c->mp_flat + c->mp_off[m2], c->mp_off[m2 + 1] - c->mp_off[m2],
                                 rc1, rc2, c->kflat, c->mflat, c->moff);
            if (l < w) {
                /* syncmer_consensus(vv>>1, vv&1, beg=l) emitted length */
                int64_t beg = l, bl = 0;
                if (beg < 0) { bl = -beg; beg = 0; }
                int64_t win = w - beg;
                bl += win;
                memset(totrl, 0, win * sizeof(int64_t));
                int64_t m_seq = scm_consensus_fill(
                    c->mp_flat + c->mp_off[m1], c->mp_off[m1 + 1] - c->mp_off[m1],
                    rc1, beg, win,
                    c->kflat, c->mflat, c->moff, c->code_flat, c->rl_flat, c->hoff,
                    c->rl_ovf_pos, c->rl_ovf_len, c->n_rl_ovf,
                    !c->hoco_seq, c->hoco_total, base, totrl);
                if (m_seq > 0 && !c->hoco_seq) {
                    for (int64_t j = 0; j < win; ++j)
                        bl += (int64_t)floor((double)totrl[j] / (double)m_seq + 0.5);
                }
                l = bl;
            } else {
                l = 0;
            }
        }
        int64_t lv = c->vtx_len[v >> 1], lt = c->vtx_len[t >> 1];
        if (l > lv) l = lv;
        if (l > lt) l = lt;
        c->out_als[ai] = l;
        }
    }
    free(base); free(totrl); free(scratch);
    return NULL;
}

int64_t arc_overlap_batch(
    const uint64_t *av, const uint64_t *aw, const int64_t *aln,
    const uint8_t *adel, const uint8_t *acomp, int64_t n_arc,
    const uint64_t *va_flat, const int64_t *va_off, const int64_t *vtx_len,
    int64_t w, int64_t hoco_seq,
    const uint64_t *mp_flat, const int64_t *mp_off,
    const uint64_t *kflat, const uint32_t *mflat, const int64_t *moff,
    const uint8_t *code_flat, const uint8_t *rl_flat,
    const int64_t *hoff,
    const int64_t *rl_ovf_pos, const int64_t *rl_ovf_len, int64_t n_rl_ovf,
    int64_t hoco_total,
    uint8_t *scratch, int64_t scratch_cap,
    int64_t *out_als, int64_t n_threads)
{
    (void)scratch;  /* workers allocate their own (kept for ABI shape) */
    aob_t c;
    memset(&c, 0, sizeof(c));
    c.av = av; c.aw = aw; c.aln = aln; c.adel = adel; c.acomp = acomp;
    c.n_arc = n_arc; c.va_flat = va_flat; c.va_off = va_off;
    c.vtx_len = vtx_len; c.w = w; c.hoco_seq = hoco_seq;
    c.mp_flat = mp_flat; c.mp_off = mp_off;
    c.kflat = kflat; c.mflat = mflat; c.moff = moff;
    c.code_flat = code_flat; c.rl_flat = rl_flat; c.hoff = hoff;
    c.rl_ovf_pos = rl_ovf_pos; c.rl_ovf_len = rl_ovf_len; c.n_rl_ovf = n_rl_ovf;
    c.hoco_total = hoco_total; c.scratch_cap = scratch_cap;
    c.out_als = out_als;
    atomic_init(&c.next, 0);
    atomic_init(&c.err, 0);
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    if (n_arc < 4096) n_threads = 1;
    if (n_threads == 1) {
        aob_worker(&c);
    } else {
        pthread_t tid[16];
        int64_t spawned = 0;
        for (int64_t t = 0; t < n_threads; ++t) {
            if (pthread_create(&tid[t], NULL, aob_worker, &c) != 0) break;
            spawned++;
        }
        if (spawned == 0) aob_worker(&c);
        for (int64_t t = 0; t < spawned; ++t) pthread_join(tid[t], NULL);
    }
    int e = atomic_load(&c.err);
    return e ? (e == 1 ? -1 : -2) : 0;
}

