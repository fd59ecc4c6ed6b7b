/* Native FASTA/FASTQ parse + homopolymer compression (runtime hot path).
 *
 * The TPU compute path consumes 2-bit packed hoco codes; this C stage
 * replaces the Python per-read parse+compress loop (the host-side
 * bottleneck once device kernels are fast).  Semantics match
 * oatk_tpu.kernels.oracle.hoco_compress_np exactly: runs of an
 * identical valid base collapse to one position (run length recorded),
 * ambiguous bases are kept uncompressed with code 0 and flagged.
 *
 * Build: cc -O3 -shared -fPIC fastx_hoco.c -o libfastx_hoco.so
 */
#include <stdint.h>
#include <stddef.h>

static const uint8_t NT4[256] = {
    /* A=0 C=1 G=2 T/U=3, else 4; lower case folded */
    [0 ... 255] = 4,
    ['A'] = 0, ['a'] = 0, ['C'] = 1, ['c'] = 1,
    ['G'] = 2, ['g'] = 2, ['T'] = 3, ['t'] = 3,
    ['U'] = 3, ['u'] = 3,
};

/* Parse records from a FASTA or FASTQ text buffer and hoco-compress.
 *
 * Outputs (caller-allocated):
 *   codes   [max_hoco]  u8: hoco base codes (0-3; ambiguous -> 0)
 *   rl      [max_hoco]  u8: run length MINUS ONE per hoco position,
 *           saturated at 255 (the reference sr_t layout,
 *           reference/syncmer.h:56): 255 always has an exact
 *           entry in the overflow list below
 *   isn_pos [max_isn] i64: hoco positions (relative to this call's
 *           output) of ambiguous bases, sorted; count in *n_isn_out.
 *           Ns are rare, so the sparse list replaces a raw-length
 *           dense byte array (1 GB/Gbp of peak RSS)
 *   offs    [max_reads+1] i64: per-read start offsets into the above
 *   rawlen  [max_reads] i64: raw (uncompressed) read length
 *   hdr_beg/hdr_end [max_reads] i64: header name spans in `data`
 *   ovf_pos/ovf_len [max_ovf] i64: overflow entries (hoco position
 *           relative to this call's output, exact run length - 1) for
 *           every run with run-1 >= 255; count in *n_ovf_out
 *
 * Returns number of reads parsed, -1 if hoco/read capacity exceeded
 * (n_hoco_out then holds the required hoco capacity lower bound),
 * -3 if the overflow list capacity is exceeded, -4 if the ambiguous
 * position list capacity is exceeded.
 */
/* ---- AVX-512 homopolymer compression of one clean sequence line ----
 *
 * SIMD formulation of the scalar hoco loop (bit-identical outputs):
 * a hoco-base boundary sits at byte x iff fold(x) != fold(x-1) or x or
 * x-1 is ambiguous, where fold = byte|0x20 (equal folded bytes always
 * map to the same NT4 code; distinct folded bytes can only share a
 * code when both are ambiguous, and ambiguous bytes are boundaries
 * anyway).  Boundaries come out of vpcmpb as 64-bit masks consumed
 * with tzcnt -- per-byte work is ~6 vector ops / 64 bytes, per-emitted-
 * base work is a short dependency-free scalar sequence.  Measured ~3x
 * the branchy scalar loop on 2.1 GHz Icelake (the c==prev branch
 * mispredicts roughly once per homopolymer run).
 *
 * Ambiguity detection: exp = vpermb(lower_tab, b) (vpermb indexes by
 * the LOW 6 BITS of each byte; lower_tab holds 'a','c','g','t' at the
 * low-6-bit values of both cases of ACGT) -- fold==exp iff the byte is
 * an upper/lowercase ACGT, because only 0x41/0x61 ('A'/'a') fold to
 * 0x61 among bytes whose low 6 bits select the 'a' entries, etc.
 *
 * State contract matches the scalar loop exactly: prev is the NT4 code
 * of the previous byte (255 = none/after-N), run the open homopolymer
 * length; both are read on entry and written back on exit so lines,
 * records and the \r fallback path interleave freely. */
#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>

static int hoco_avx512_ok = -1;

static int hoco_use_avx512(void)
{
    if (hoco_avx512_ok < 0)
        hoco_avx512_ok =
            __builtin_cpu_supports("avx512f") &&
            __builtin_cpu_supports("avx512bw") &&
            __builtin_cpu_supports("avx512vbmi");
    return hoco_avx512_ok;
}

__attribute__((target("avx512f,avx512bw,avx512vbmi")))
static int64_t hoco_line_avx512(
    const uint8_t *src, int64_t nn,
    uint8_t *codes, uint8_t *rl,
    int64_t *h_io, int64_t *run_io, uint8_t *prev_io,
    int64_t *isn_pos, int64_t max_isn, int64_t *n_isn_io,
    int64_t *ovf_pos, int64_t *ovf_len, int64_t max_ovf, int64_t *n_ovf_io)
{
    /* U/u ('U'=0x55 low6=0x15, 'u'=0x75 low6=0x35) map to 't': NT4
     * codes them 3 like T, so the folded-byte compare must see them as
     * 't' too -- fold() below remaps 0x75->0x74 to match. */
    static const uint8_t lower_tab_a[64] = {
        [0x01] = 'a', [0x03] = 'c', [0x07] = 'g', [0x14] = 't',
        [0x21] = 'a', [0x23] = 'c', [0x27] = 'g', [0x34] = 't',
        [0x15] = 't', [0x35] = 't',
    };
    const __m512i lower_tab = _mm512_loadu_si512(lower_tab_a);
    const __m512i v20 = _mm512_set1_epi8(0x20);
    const __m512i vlu = _mm512_set1_epi8(0x75); /* 'u' */
    const __m512i v01 = _mm512_set1_epi8(1);

    /* fold(b) = (b|0x20), with 'u' canonicalized to 't' so T and U
     * (both NT4 code 3) never split a homopolymer run */
#define HOCO_FOLD(vb, out) do { \
        __m512i f_ = _mm512_or_si512((vb), v20); \
        __mmask64 u_ = _mm512_cmpeq_epi8_mask(f_, vlu); \
        (out) = _mm512_mask_sub_epi8(f_, u_, f_, v01); \
    } while (0)

    int64_t h = *h_io, run = *run_io, n_isn = *n_isn_io, n_ovf = *n_ovf_io;
    uint8_t prev = *prev_io;
    /* prev as fold/amb for the vector compares */
    uint8_t prev_fold = prev < 4 ? (uint8_t)("acgt"[prev]) : 0;
    int prev_amb = prev >= 4;
    int64_t lastb = -1; /* line-local position of the last boundary */

    for (int64_t base = 0; base < nn; base += 64) {
        int64_t nb = nn - base < 64 ? nn - base : 64;
        __mmask64 lm = nb == 64 ? ~(__mmask64)0 : ((((__mmask64)1) << nb) - 1);
        __m512i b = _mm512_maskz_loadu_epi8(lm, src + base);
        __m512i fold;
        HOCO_FOLD(b, fold);
        __m512i exp = _mm512_permutexvar_epi8(b, lower_tab);
        __mmask64 amb = _mm512_cmpneq_epi8_mask(fold, exp) & lm;
        __mmask64 neq;
        if (base == 0) {
            uint8_t tmpbuf[65];
            tmpbuf[0] = prev_fold;
            _mm512_mask_storeu_epi8(tmpbuf + 1, lm, fold);
            __m512i sh = _mm512_maskz_loadu_epi8(lm, tmpbuf);
            neq = _mm512_cmpneq_epi8_mask(fold, sh) & lm;
        } else {
            /* masked load keeps the trailing lanes from faulting past
             * the buffer end on the final partial block */
            __m512i bp = _mm512_maskz_loadu_epi8(lm, src + base - 1);
            __m512i foldp;
            HOCO_FOLD(bp, foldp);
            neq = _mm512_cmpneq_epi8_mask(fold, foldp) & lm;
        }
        uint64_t m = (neq | amb | (amb << 1) | (__mmask64)(prev_amb & 1)) & lm;
        prev_amb = (int)((amb >> (nb - 1)) & 1);
        while (m) {
            int64_t p = base + (int64_t)__builtin_ctzll(m);
            m &= m - 1;
            /* close the open run (its length: carried `run` plus the
             * bytes of this line up to p) */
            int64_t closed = lastb < 0 ? run + p : p - lastb;
            if (closed > 0) {
                int64_t r = closed - 1;
                rl[h - 1] = r < 255 ? (uint8_t)r : 255;
                if (r >= 255) {
                    if (n_ovf >= max_ovf) return -3;
                    ovf_pos[n_ovf] = h - 1;
                    ovf_len[n_ovf] = r;
                    ++n_ovf;
                }
            }
            uint8_t c = NT4[src[p]];
            codes[h] = c & 3;
            rl[h] = 0;
            if (c == 4) {
                if (n_isn >= max_isn) return -4;
                isn_pos[n_isn++] = h;
            }
            ++h;
            lastb = p;
        }
    }
    run = lastb < 0 ? run + nn : nn - lastb;
    uint8_t last = NT4[src[nn - 1]];
    *prev_io = last == 4 ? 255 : last;
    *h_io = h;
    *run_io = run;
    *n_isn_io = n_isn;
    *n_ovf_io = n_ovf;
    return 0;
#undef HOCO_FOLD
}
#else
static int hoco_use_avx512(void) { return 0; }

static int64_t hoco_line_avx512(
    const uint8_t *src, int64_t nn,
    uint8_t *codes, uint8_t *rl,
    int64_t *h_io, int64_t *run_io, uint8_t *prev_io,
    int64_t *isn_pos, int64_t max_isn, int64_t *n_isn_io,
    int64_t *ovf_pos, int64_t *ovf_len, int64_t max_ovf, int64_t *n_ovf_io)
{
    (void)src; (void)nn; (void)codes; (void)rl; (void)h_io; (void)run_io;
    (void)prev_io; (void)isn_pos; (void)max_isn; (void)n_isn_io;
    (void)ovf_pos; (void)ovf_len; (void)max_ovf; (void)n_ovf_io;
    return -2; /* unreachable: hoco_use_avx512() is 0 off x86 */
}
#endif

int64_t parse_fastx_hoco(
    const uint8_t *data, int64_t len,
    uint8_t *codes, uint8_t *rl,
    int64_t *isn_pos, int64_t max_isn, int64_t *n_isn_out,
    int64_t *offs, int64_t *rawlen,
    int64_t *hdr_beg, int64_t *hdr_end,
    int64_t max_reads, int64_t max_hoco,
    int64_t *n_hoco_out,
    int64_t *ovf_pos, int64_t *ovf_len, int64_t max_ovf,
    int64_t *n_ovf_out)
{
    int64_t n_isn = 0;
    int64_t i = 0, n_reads = 0, h = 0, n_ovf = 0;
    int64_t run = 0; /* current homopolymer run length (codes[h-1]) */

#define CLOSE_RUN() do { \
        if (run >= 256) { \
            rl[h - 1] = 255; \
            if (n_ovf >= max_ovf) return -3; \
            ovf_pos[n_ovf] = h - 1; ovf_len[n_ovf] = run - 1; ++n_ovf; \
        } else if (run > 0) { \
            rl[h - 1] = (uint8_t)(run - 1); \
        } \
        run = 0; \
    } while (0)

    while (i < len) {
        /* skip blank lines */
        while (i < len && (data[i] == '\n' || data[i] == '\r')) ++i;
        if (i >= len) break;
        int is_fq = data[i] == '@';
        if (data[i] != '>' && !is_fq) return -2; /* malformed */
        if (n_reads >= max_reads) return -1;
        ++i;
        int64_t hb = i;
        while (i < len && data[i] != '\n' && data[i] != ' ' && data[i] != '\t'
               && data[i] != '\r') ++i;
        int64_t he = i;
        while (i < len && data[i] != '\n') ++i; /* rest of header */
        ++i;

        offs[n_reads] = h;
        hdr_beg[n_reads] = hb;
        hdr_end[n_reads] = he;

        /* sequence lines until next record (or +-line for FASTQ) */
        int64_t raw = 0;
        uint8_t prev = 255;
        while (i < len && data[i] != '>' && data[i] != '+' &&
               !(is_fq && data[i] == '@')) {
            /* line extent up front (memchr beats a per-byte compare);
             * a trailing \r is stripped, embedded \r (pathological)
             * falls back to the byte-skipping scan */
            const uint8_t *nlp = memchr(data + i, '\n', len - i);
            int64_t q = nlp ? (int64_t)(nlp - data) : len;
            int64_t qq = (q > i && data[q - 1] == '\r') ? q - 1 : q;
            if (memchr(data + i, '\r', qq - i) != NULL) {
                while (i < qq) {
                    uint8_t b = data[i++];
                    if (b == '\r') continue;
                    uint8_t c = NT4[b];
                    ++raw;
                    if (c == 4) {
                        CLOSE_RUN();
                        if (h >= max_hoco) goto overflow;
                        codes[h] = 0;
                        rl[h] = 0;
                        if (n_isn >= max_isn) return -4;
                        isn_pos[n_isn++] = h;
                        ++h;
                        prev = 255;
                    } else if (c == prev) {
                        ++run;
                    } else {
                        CLOSE_RUN();
                        if (h >= max_hoco) goto overflow;
                        codes[h] = c;
                        ++h;
                        run = 1;
                        prev = c;
                    }
                }
            } else {
                int64_t nn = qq - i;
                raw += nn;
                if (h + nn > max_hoco) goto overflow;
                const uint8_t *src = data + i;
                if (nn > 0 && hoco_use_avx512()) {
                    int64_t rc = hoco_line_avx512(
                        src, nn, codes, rl, &h, &run, &prev,
                        isn_pos, max_isn, &n_isn,
                        ovf_pos, ovf_len, max_ovf, &n_ovf);
                    if (rc < 0) return rc;
                } else {
                    for (int64_t x = 0; x < nn; ++x) {
                        uint8_t c = NT4[src[x]];
                        if (c == prev) {
                            ++run;
                            continue;
                        }
                        CLOSE_RUN();
                        if (c == 4) {
                            codes[h] = 0;
                            rl[h] = 0;
                            if (n_isn >= max_isn) return -4;
                            isn_pos[n_isn++] = h;
                            ++h;
                            prev = 255;
                        } else {
                            codes[h] = c;
                            ++h;
                            run = 1;
                            prev = c;
                        }
                    }
                }
            }
            i = q + 1;
            if (!is_fq) continue;
            break; /* FASTQ: exactly one sequence line */
        }
        CLOSE_RUN();
        if (is_fq) {
            /* skip '+' line and quality line */
            while (i < len && data[i] != '\n') ++i;
            ++i;
            while (i < len && data[i] != '\n') ++i;
            ++i;
        }
        rawlen[n_reads] = raw;
        ++n_reads;
    }
    offs[n_reads] = h;
    *n_hoco_out = h;
    *n_ovf_out = n_ovf;
    *n_isn_out = n_isn;
    return n_reads;

overflow:
    *n_hoco_out = h + (len - i); /* generous lower bound */
    return -1;
#undef CLOSE_RUN
}

/* 2-bit pack concatenated hoco codes per read into per-read padded rows.
 * rows: [n_reads, row_bytes] u8, first base of each read at bits 7-6 of
 * its row's byte 0.  Used to build the device upload batch in one pass. */
/* AVX-512 fast path: 64 codes -> 16 packed bytes per iteration via the
 * classic maddubs/madd/narrow ladder.  Target byte = c0<<6|c1<<4|c2<<2|c3
 * = ((c0*4+c1)*16) + (c2*4+c3): vpmaddubsw with (4,1) byte weights folds
 * base pairs, vpmaddwd with (16,1) word weights folds pair-pairs, and
 * vpmovdb narrows the 32-bit lanes to the output bytes.  The scalar
 * loop runs ~300 MB/s; this runs at memory speed (pack_work was ~3.3 s
 * of worker CPU per Gbp, ~30% of parse_work). */
__attribute__((target("avx512f,avx512bw")))
static void pack_row_avx512(const uint8_t *src, int64_t n, uint8_t *dst)
{
    const __m512i w41 = _mm512_set1_epi16(0x0104);   /* bytes (4,1)  */
    const __m512i w16 = _mm512_set1_epi32(0x00010010); /* words (16,1) */
    int64_t b = 0;
    for (; b + 64 <= n; b += 64) {
        __m512i v = _mm512_loadu_si512((const void *)(src + b));
        __m512i p = _mm512_maddubs_epi16(v, w41);
        __m512i q = _mm512_madd_epi16(p, w16);
        _mm_storeu_si128((__m128i *)(dst + (b >> 2)),
                         _mm512_cvtepi32_epi8(q));
    }
    if (b < n) {
        __mmask64 m = (n - b >= 64) ? ~(__mmask64)0
                                    : (((__mmask64)1 << (n - b)) - 1);
        __m512i v = _mm512_maskz_loadu_epi8(m, (const void *)(src + b));
        __m512i p = _mm512_maddubs_epi16(v, w41);
        __m512i q = _mm512_madd_epi16(p, w16);
        uint8_t out[16];
        _mm_storeu_si128((__m128i *)out, _mm512_cvtepi32_epi8(q));
        int64_t nb = (n - b + 3) >> 2;
        for (int64_t j = 0; j < nb; ++j)
            dst[(b >> 2) + j] = out[j];
    }
}

static inline void pack_one_row(
    const uint8_t *src, int64_t n, uint8_t *dst)
{
    if (hoco_use_avx512() && n >= 64) {
        pack_row_avx512(src, n, dst);
        return;
    }
    int64_t b = 0;
    for (; b + 4 <= n; b += 4) {
        dst[b >> 2] = (uint8_t)(src[b] << 6 | src[b + 1] << 4 |
                                src[b + 2] << 2 | src[b + 3]);
    }
    if (b < n) {
        uint8_t v = 0;
        for (int64_t j = b; j < n; ++j)
            v |= src[j] << ((3 - (j & 3)) << 1);
        dst[b >> 2] = v;
    }
}

void pack_rows(
    const uint8_t *codes, const int64_t *offs,
    int64_t row0, int64_t n_rows, int64_t row_bytes,
    uint8_t *rows)
{
    for (int64_t r = 0; r < n_rows; ++r)
        pack_one_row(codes + offs[row0 + r],
                     offs[row0 + r + 1] - offs[row0 + r],
                     rows + r * row_bytes);
}

/* Gather variant: rows pack an arbitrary subset of reads (length
 * bucketing scatters reads of one device chunk through the segment).
 * One native call replaces a per-read Python/FFI loop. */
void pack_rows_gather(
    const uint8_t *codes, const int64_t *starts, const int64_t *ends,
    int64_t n_rows, int64_t row_bytes, uint8_t *rows)
{
    for (int64_t r = 0; r < n_rows; ++r)
        pack_one_row(codes + starts[r], ends[r] - starts[r],
                     rows + r * row_bytes);
}

/* GIL-free byte scans for the loader's critical path: counting record
 * headers ("\n>"/"\n@") to bound allocation, and locating a 2-byte
 * pattern to validate optimistic FASTA segment splits.  ctypes releases
 * the GIL around these calls, so they overlap parse worker threads
 * instead of serializing on bytes.count. */
#include <string.h>

int64_t count_byte2(const uint8_t *p, int64_t n, uint8_t a, uint8_t b)
{
    int64_t cnt = 0;
    const uint8_t *end = p + n;
    while (p < end - 1) {
        const uint8_t *q = memchr(p, a, end - p - 1);
        if (!q) break;
        cnt += (q[1] == b);
        p = q + 1;
    }
    return cnt;
}

int64_t find_byte2(const uint8_t *p, int64_t n, uint8_t a, uint8_t b)
{
    const uint8_t *base = p, *end = p + n;
    while (p < end - 1) {
        const uint8_t *q = memchr(p, a, end - p - 1);
        if (!q) break;
        if (q[1] == b) return q - base;
        p = q + 1;
    }
    return -1;
}
