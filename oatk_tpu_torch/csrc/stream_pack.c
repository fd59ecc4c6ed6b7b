/* The key route's stream pack (oatk_tpu_torch/asm/stream_pack.py): one
 * parse segment's reads written back to back as 2-bit codes, with the
 * row table and the N entries that the row gather (K3d,
 * csrc/syncmer_details.cu) reads.  Host C, one call per segment, so the
 * parse workers pack without holding the interpreter lock.
 *
 * It replaces no kernel of the JAX package: the JAX loader packs each
 * segment's chunks into padded per-bucket blobs on the host
 * (oatk_tpu/asm/reads.py:_pack_chunks), and the port's packed route
 * still does.  Bound: bytes, one read of the codes and one write of a
 * quarter of them; the pack takes four codes a 32-bit load and one
 * multiply, and the compiler vectorises the loop.
 *
 * Read i (hoco codes codes[offs[i] .. offs[i+1]), 0-3 each) goes to
 * stream byte row_off[i], a multiple of 16, base 4j in bits 7-6 of byte
 * j; the bytes from its last base to the next multiple of 16, and 16
 * spare bytes after the last read, are zero.  hl[i] is its length,
 * lp[i] its padded length bucket (asm/reads.py:_bucket_len of
 * max(hl, min_len)), and each N at hoco position isn[k] (sorted) becomes
 * n_rows[k] = i<<32 | (isn[k] - offs[i]).  Returns the stream's bytes. */
#include <stdint.h>
#include <string.h>

static int32_t bucket_len(int64_t L)
{
    if (L <= 512) return 512;
    if (L <= 4096) {
        int32_t p = 1024;
        while (p < L) p <<= 1;
        return p;
    }
    return (int32_t)((L + 2047) / 2048 * 2048);
}

int64_t stream_pack(const uint8_t *codes, const int64_t *offs, int64_t n,
                    const int64_t *isn, int64_t n_isn, int64_t min_len,
                    uint8_t *stream, int64_t *row_off, int32_t *hl, int32_t *lp,
                    int64_t *n_rows)
{
    int64_t at = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t *c = codes + offs[i];
        const int64_t h = offs[i + 1] - offs[i];
        const int64_t full = h >> 2;
        uint8_t *d = stream + at;
        for (int64_t j = 0; j < full; ++j) {
            uint32_t v;
            memcpy(&v, c + 4 * j, 4);  /* little-endian: code 4j in byte 0 */
            d[j] = (uint8_t)(((v & 0x03030303u) * 0x40100401u) >> 24);
        }
        const int64_t nb = (h + 63) >> 6 << 4;  /* the read's 16-byte blocks */
        if (h & 3) {
            uint8_t b = 0;
            for (int64_t k = 0; k < (h & 3); ++k)
                b |= (uint8_t)(c[4 * full + k] << (6 - 2 * k));
            d[full] = b;
            memset(d + full + 1, 0, (size_t)(nb - full - 1));
        } else {
            memset(d + full, 0, (size_t)(nb - full));
        }
        row_off[i] = at;
        hl[i] = (int32_t)h;
        lp[i] = bucket_len(h > min_len ? h : min_len);
        at += nb;
    }
    memset(stream + at, 0, 16);
    int64_t i = 0;
    for (int64_t k = 0; k < n_isn; ++k) {
        while (i + 1 < n && offs[i + 1] <= isn[k]) ++i;
        n_rows[k] = (i << 32) | (isn[k] - offs[i]);
    }
    return at + 16;
}
