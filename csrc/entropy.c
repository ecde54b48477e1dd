/* JPEG-grade entropy coding for quantized coefficient maps (.tdc codec 2).
 *
 * The reference never persists its compressed payload at all (the only
 * artifact is a quality-100 libjpeg re-encode of the reconstruction,
 * utils.cu:98-147), so its compression factor is unmeasurable end-to-end.
 * tpudct's .tdc container stores the quantized map; round 1 entropy-coded
 * it as spectral-reorder + zlib.  This module is the round-2 upgrade to
 * the real JPEG entropy stage (ITU-T T.81 §F): per-block zig-zag scan,
 * DC delta + AC (run,size) symbols with appended magnitude bits, and
 * OPTIMAL canonical Huffman tables built from the image's own symbol
 * histogram (the §K.2 two-pass algorithm libjpeg runs under -optimize).
 *
 * Differences from an interchange JPEG stream (this is a container
 * payload, not a .jpg): no marker segments, no 0xFF byte stuffing, DC
 * symbols may exceed 11 (int16 deltas reach size 17), AC sizes may reach
 * 15, and the two table descriptors are stored raw (BITS[16] + HUFFVAL).
 *
 * Stream layout:
 *   u8  version (=1)
 *   DC table: 16 x u8 BITS, then sum(BITS) x u8 HUFFVAL
 *   AC table: same
 *   u32le payload_bits
 *   ceil(payload_bits/8) bytes of MSB-first bitstream
 *
 * Exported (ctypes, see tpudct/utils/entropy.py):
 *   tpudct_huff_encode(coeffs, h, w, out, cap) -> bytes written | -1
 *   tpudct_huff_decode(data, n, h, w, out)     -> 0 | negative error
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define NSYM 256 /* symbol alphabet: DC size / AC (run<<4|size) bytes */

/* zig-zag index -> row-major index within an 8x8 block (ITU-T T.81 Fig 5) */
static const uint8_t ZZ[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

static int bit_size(int v) { /* JPEG magnitude category */
    int a = v < 0 ? -v : v, s = 0;
    while (a) { s++; a >>= 1; }
    return s;
}

/* Nonzero bitmask of a 64-coefficient zig-zag block (bit k set iff
 * zz[k] != 0).  The block scan below iterates SET BITS via ctz instead
 * of stepping through all 64 positions one at a time — symbolization
 * (not rANS coding) is 64-82% of encode on this host (pass-split
 * instrumentation, round 5), and most positions are zero on real
 * content.  SSE2 when available: 8 loads + 8 compares + 4 pack/movemask
 * for the whole block; scalar fallback is bit-for-bit identical. */
#if defined(__SSE2__)
#include <emmintrin.h>
static inline uint64_t nz_mask64(const int16_t *zz) {
    uint64_t m = 0;
    int c;
    const __m128i zero = _mm_setzero_si128();
    for (c = 0; c < 4; c++) {
        __m128i a = _mm_loadu_si128((const __m128i *)(zz + 16 * c));
        __m128i b = _mm_loadu_si128((const __m128i *)(zz + 16 * c + 8));
        __m128i ez = _mm_packs_epi16(_mm_cmpeq_epi16(a, zero),
                                     _mm_cmpeq_epi16(b, zero));
        m |= (uint64_t)(uint16_t)~_mm_movemask_epi8(ez) << (16 * c);
    }
    return m;
}
#else
static inline uint64_t nz_mask64(const int16_t *zz) {
    uint64_t m = 0;
    int k;
    for (k = 0; k < 64; k++) m |= (uint64_t)(zz[k] != 0) << k;
    return m;
}
#endif

/* ---- optimal code lengths (ITU-T T.81 Annex K.2, as in libjpeg) ---------- */

static void count_code_sizes(long freq[NSYM + 1], int codesize[NSYM + 1]) {
    int others[NSYM + 1];
    int i;
    for (i = 0; i <= NSYM; i++) { codesize[i] = 0; others[i] = -1; }
    freq[NSYM] = 1; /* reserved symbol guarantees no all-ones code */
    for (;;) {
        int c1 = -1, c2 = -1;
        long v1 = 0x7fffffffL, v2 = 0x7fffffffL;
        for (i = 0; i <= NSYM; i++) {
            if (freq[i] && freq[i] <= v1) { v2 = v1; c2 = c1; v1 = freq[i]; c1 = i; }
            else if (freq[i] && freq[i] <= v2) { v2 = freq[i]; c2 = i; }
        }
        if (c2 < 0) break;
        freq[c1] += freq[c2];
        freq[c2] = 0;
        codesize[c1]++;
        while (others[c1] >= 0) { c1 = others[c1]; codesize[c1]++; }
        others[c1] = c2;
        codesize[c2]++;
        while (others[c2] >= 0) { c2 = others[c2]; codesize[c2]++; }
    }
}

static int build_table(const long *histogram, uint8_t bits[17], uint8_t *huffval) {
    long freq[NSYM + 1];
    int codesize[NSYM + 1];
    int counts[65] = {0};
    int i, j, n = 0;
    memcpy(freq, histogram, sizeof(long) * NSYM);
    count_code_sizes(freq, codesize);
    for (i = 0; i <= NSYM; i++)
        if (codesize[i]) counts[codesize[i] > 64 ? 64 : codesize[i]]++;
    /* limit code length to 16 (T.81 Figure K.3) */
    for (i = 64; i > 16; i--) {
        while (counts[i] > 0) {
            j = i - 2;
            while (counts[j] == 0) j--;
            counts[i] -= 2;
            counts[i - 1]++;
            counts[j + 1] += 2;
            counts[j]--;
        }
    }
    while (i > 0 && counts[i] == 0) i--;
    if (i > 0) counts[i]--; /* drop the reserved symbol's slot */
    memset(bits, 0, 17);
    for (i = 1; i <= 16; i++) bits[i] = (uint8_t)counts[i];
    /* symbols sorted by (codesize, value); reserved NSYM excluded */
    for (i = 1; i <= 64; i++)
        for (j = 0; j < NSYM; j++)
            if (codesize[j] == i) huffval[n++] = (uint8_t)j;
    return n;
}

/* canonical code assignment (T.81 Figure C.2) */
static void assign_codes(const uint8_t bits[17], const uint8_t *huffval,
                         uint16_t ecode[NSYM], uint8_t esize[NSYM]) {
    int i, k = 0;
    uint16_t code = 0;
    memset(esize, 0, NSYM);
    for (i = 1; i <= 16; i++) {
        int n = bits[i];
        while (n--) {
            ecode[huffval[k]] = code++;
            esize[huffval[k]] = (uint8_t)i;
            k++;
        }
        code <<= 1;
    }
}

/* ---- bit I/O ------------------------------------------------------------- */

typedef struct {
    uint8_t *buf;
    long cap, pos;  /* bytes */
    uint64_t acc;
    int nbits;
    int overflow;
} BitWriter;

static void bw_put(BitWriter *w, uint32_t v, int n) {
    if (!n || w->overflow) return;  /* sticky: once over, stop accumulating
                                     * (unbounded nbits growth would be
                                     * signed-overflow UB on huge inputs) */
    w->acc = (w->acc << n) | (v & ((1u << n) - 1));
    w->nbits += n;
    while (w->nbits >= 8) {
        if (w->pos >= w->cap) { w->overflow = 1; return; }
        w->buf[w->pos++] = (uint8_t)(w->acc >> (w->nbits - 8));
        w->nbits -= 8;
    }
}

static long bw_flush(BitWriter *w) { /* returns total BITS written */
    long bits = w->pos * 8 + w->nbits;
    if (w->nbits) {
        if (w->pos >= w->cap) { w->overflow = 1; return bits; }
        w->buf[w->pos++] = (uint8_t)(w->acc << (8 - w->nbits));
        w->nbits = 0;
    }
    return bits;
}

/* Windowed bit reader for the rANS magnitude streams: up to 64 bits
 * buffered left-justified in an accumulator, refilled bytewise only when
 * short.  MSB-first; n == 0 -> 0; reading past the declared bit budget
 * -> -1, without consuming.  Replaced the round-4 per-call multi-chunk
 * bit reader — whose assembly work was the decode loops' largest
 * non-symbol cost (the magnitude read runs once per nonzero
 * coefficient) — in BOTH the rANS and Huffman decoders (round 5). */
typedef struct {
    const uint8_t *buf;
    long nbytes;   /* payload bytes available */
    long nbits;    /* declared bit budget */
    long bitpos;   /* consumed bits */
    long bytepos;  /* next byte to load into acc */
    uint64_t acc;  /* upcoming bits, left-justified */
    int navail;
} FastBits;

static void fb_init(FastBits *f, const uint8_t *buf, long nbits, long nbytes) {
    f->buf = buf;
    f->nbits = nbits;
    f->nbytes = nbytes;
    f->bitpos = 0;
    f->bytepos = 0;
    f->acc = 0;
    f->navail = 0;
}

/* Peek the next n bits WITHOUT consuming (bits past the declared budget
 * read as zero — acc keeps zeros below navail by construction, so no
 * masking is needed; consumption stays bounds-checked in fb_skip). */
static inline long fb_peek(FastBits *f, int n) {
    if (f->navail < n) {
        while (f->navail <= 56 && f->bytepos < f->nbytes) {
            f->acc |= (uint64_t)f->buf[f->bytepos++] << (56 - f->navail);
            f->navail += 8;
        }
    }
    return (long)(f->acc >> (64 - n));
}

static inline int fb_skip(FastBits *f, int n) { /* 0 ok / -1 past budget */
    if (f->bitpos + n > f->nbits) return -1;
    f->acc <<= n;
    f->navail -= n;
    f->bitpos += n;
    return 0;
}

static long fb_take(FastBits *f, int n) {
    long v;
    if (n == 0) return 0;
    if (n < 0 || f->bitpos + n > f->nbits) return -1;
    if (f->navail < n) {
        /* refill to capacity so ~7 bytes of takes skip this branch */
        do {
            if (f->bytepos >= f->nbytes) return -1; /* unreachable given
                                                     * the budget check;
                                                     * kept as the hard
                                                     * buffer bound */
            f->acc |= (uint64_t)f->buf[f->bytepos++] << (56 - f->navail);
            f->navail += 8;
        } while (f->navail <= 56 && f->bytepos < f->nbytes);
        if (f->navail < n) return -1;
    }
    v = (long)(f->acc >> (64 - n));
    f->acc <<= n;
    f->navail -= n;
    f->bitpos += n;
    return v;
}

/* A -32768 coefficient has magnitude category 16, which overflows the
 * 4-bit AC size field — the symbol model cannot represent it.  Unreachable
 * through tpudct's serializer (it validates |c| <= 32767 before narrowing,
 * utils/serialize.py), but refuse defensively instead of emitting a
 * stream that cannot decode. */
static int has_int16_min(const int16_t *c, long n) {
    long i;
    for (i = 0; i < n; i++)
        if (c[i] == -32768) return 1;
    return 0;
}

/* ---- per-block symbolization --------------------------------------------- */

/* table: 0=DC 1=AC.  kpos: zig-zag position where the symbol is emitted
 * (0 for DC; the position the decoder's scan cursor sits at for AC) —
 * consumed by the rANS coder's positional contexts, ignored by Huffman. */
typedef void (*SymbolSink)(void *ctx, int table, int kpos, int sym,
                           int extra_bits, uint32_t extra);

/* The ONE copy of the T.81 block-scan symbolization, instantiated per
 * sink via macro so hot sinks inline.  The indirect per-symbol sink call
 * measured 82% of the whole rANS encode on this host (65 ms of 79 at
 * 2048², pass-split instrumentation, round 5) — the rANS collector gets
 * a direct instantiation below; the Huffman paths keep the generic
 * function-pointer wrapper. */
#define EMIT_BLOCKS_BODY(CTX, SINK)                                          \
    do {                                                                     \
        int by_, bx_, k_;                                                    \
        int prev_dc_ = 0;                                                    \
        for (by_ = 0; by_ < h / 8; by_++) {                                  \
            for (bx_ = 0; bx_ < w / 8; bx_++) {                              \
                const int16_t *blk_ = c + (long)by_ * 8 * w + bx_ * 8;       \
                int16_t zz_[64];                                             \
                int diff_, s_, run_, last_, kcur_;                           \
                for (k_ = 0; k_ < 64; k_++)                                  \
                    zz_[k_] = blk_[(ZZ[k_] >> 3) * (long)w + (ZZ[k_] & 7)];  \
                diff_ = zz_[0] - prev_dc_;                                   \
                prev_dc_ = zz_[0];                                           \
                s_ = bit_size(diff_);                                        \
                SINK(CTX, 0, 0, s_, s_,                                      \
                     (uint32_t)(diff_ < 0 ? diff_ + ((1L << s_) - 1) : diff_)); \
                /* mask-driven scan: visit only the nonzero AC positions   \
                 * (ctz over nz_mask64) — emits the IDENTICAL symbol       \
                 * sequence as stepping every position (runs come from bit \
                 * gaps, ZRLs at the decoder cursor, EOB iff bit 63 clear  \
                 * at the end), asserted byte-identical in tests/fuzz */   \
                {                                                            \
                    uint64_t nz_ = nz_mask64(zz_) & ~1ull;                   \
                    kcur_ = 1; /* decoder's scan cursor at the next symbol */\
                    while (nz_) {                                            \
                        k_ = __builtin_ctzll(nz_);                           \
                        nz_ &= nz_ - 1;                                      \
                        run_ = k_ - kcur_;                                   \
                        while (run_ > 15) {                                  \
                            SINK(CTX, 1, kcur_, 0xF0, 0, 0);                 \
                            run_ -= 16;                                      \
                            kcur_ += 16;                                     \
                        }                                                    \
                        s_ = bit_size(zz_[k_]);                              \
                        SINK(CTX, 1, kcur_, (run_ << 4) | s_, s_,            \
                             (uint32_t)(zz_[k_] < 0                          \
                                            ? zz_[k_] + ((1 << s_) - 1)      \
                                            : zz_[k_]));                     \
                        kcur_ = k_ + 1;                                      \
                    }                                                        \
                    (void)last_;                                             \
                    if (kcur_ < 64) SINK(CTX, 1, kcur_, 0x00, 0, 0); /*EOB*/ \
                }                                                            \
            }                                                                \
        }                                                                    \
    } while (0)

#define SINK_CALL(CTX, t, kp, sym, eb, ev) sink(CTX, t, kp, sym, eb, ev)

static void emit_blocks(const int16_t *c, int h, int w, SymbolSink sink, void *ctx) {
    EMIT_BLOCKS_BODY(ctx, SINK_CALL);
}

typedef struct { long dc[NSYM]; long ac[NSYM]; } Hist;

static void hist_sink(void *ctx, int table, int kpos, int sym, int eb, uint32_t ev) {
    Hist *hs = (Hist *)ctx;
    (void)kpos; (void)eb; (void)ev;
    (table ? hs->ac : hs->dc)[sym]++;
}

typedef struct {
    BitWriter *w;
    uint16_t dcode[NSYM]; uint8_t dsize[NSYM];
    uint16_t acode[NSYM]; uint8_t asize[NSYM];
    int bad;
} EncCtx;

static void enc_sink(void *ctx, int table, int kpos, int sym, int eb, uint32_t ev) {
    EncCtx *e = (EncCtx *)ctx;
    const uint16_t *codes = table ? e->acode : e->dcode;
    const uint8_t *sizes = table ? e->asize : e->dsize;
    (void)kpos;
    if (!sizes[sym]) { e->bad = 1; return; }
    bw_put(e->w, codes[sym], sizes[sym]);
    if (eb) bw_put(e->w, ev, eb);
}

/* ---- public API ---------------------------------------------------------- */

long tpudct_huff_encode(const int16_t *coeffs, int h, int w,
                        uint8_t *out, long cap) {
    Hist hist;
    uint8_t dbits[17], abits[17], dval[NSYM], aval[NSYM];
    int ndc, nac;
    long head, bits_pos, total_bits;
    EncCtx e;
    BitWriter bw;
    if (h <= 0 || w <= 0 || (h % 8) || (w % 8)) return -1;
    if (has_int16_min(coeffs, (long)h * w)) return -1;
    memset(&hist, 0, sizeof(hist));
    emit_blocks(coeffs, h, w, hist_sink, &hist);
    ndc = build_table(hist.dc, dbits, dval);
    nac = build_table(hist.ac, abits, aval);
    head = 1 + 16 + ndc + 16 + nac + 4;
    if (cap < head) return -1;
    out[0] = 1;
    memcpy(out + 1, dbits + 1, 16);
    memcpy(out + 17, dval, ndc);
    memcpy(out + 17 + ndc, abits + 1, 16);
    memcpy(out + 33 + ndc, aval, nac);
    bits_pos = 33 + ndc + nac;
    memset(&e, 0, sizeof(e));
    assign_codes(dbits, dval, e.dcode, e.dsize);
    assign_codes(abits, aval, e.acode, e.asize);
    bw.buf = out + head;
    bw.cap = cap - head;
    bw.pos = 0; bw.acc = 0; bw.nbits = 0; bw.overflow = 0;
    e.w = &bw;
    emit_blocks(coeffs, h, w, enc_sink, &e);
    total_bits = bw_flush(&bw);
    if (e.bad || bw.overflow) return -1;
    if ((unsigned long)total_bits > 0xFFFFFFFFul)
        return -1;  /* the u32le header field cannot express it (the rANS
                     * path refuses oversized fields the same way) */
    out[bits_pos + 0] = (uint8_t)(total_bits & 0xff);
    out[bits_pos + 1] = (uint8_t)((total_bits >> 8) & 0xff);
    out[bits_pos + 2] = (uint8_t)((total_bits >> 16) & 0xff);
    out[bits_pos + 3] = (uint8_t)((total_bits >> 24) & 0xff);
    return head + bw.pos;
}

/* decode-side table (T.81 Figure F.15) */
typedef struct {
    long mincode[17], maxcode[18];
    int valptr[17];
    uint8_t huffval[NSYM];
} DecTable;

static void dec_table(const uint8_t bits[17], const uint8_t *huffval, DecTable *t) {
    int i, k = 0;
    long code = 0;
    memcpy(t->huffval, huffval, NSYM);
    for (i = 1; i <= 16; i++) {
        t->valptr[i] = k;
        t->mincode[i] = code;
        code += bits[i];
        k += bits[i];
        t->maxcode[i] = code - 1;
        code <<= 1;
        if (!bits[i]) t->maxcode[i] = -1;
    }
    t->maxcode[17] = 0x7fffffffL;
}

/* First-HUF_LUT_BITS lookup decode (round 5): one peek + one table hit
 * resolves every code of length <= HUF_LUT_BITS (the overwhelming
 * majority — optimal tables put frequent symbols at short codes);
 * longer codes walk the canonical ranges from length LUT+1 up.  2 KB
 * per table, L1-resident.  Replaces the bit-by-bit dec_sym walk that
 * made Huffman the slowest decoder leg (~508 MB/s vs rANS's 620-1270
 * after the round-5 work; measured 2.2x on the study maps). */
#define HUF_LUT_BITS 10

typedef struct {
    uint16_t lut[1 << HUF_LUT_BITS]; /* sym << 8 | len; 0 = longer code */
} DecLut;

/* Returns 0, or -1 for a table whose per-length counts overflow the
 * canonical code space (code >= 2^l at some length).  The shipped
 * encoder can never emit such BITS (the K.2 builder satisfies Kraft);
 * only corrupt streams reach it — and without this check the fill loop
 * below would index past the 1024-entry lut (review finding: a stream
 * with bits[1] = 255 smashed the stack where the old bit-by-bit walk
 * returned an error). */
static int dec_lut(const uint8_t bits[17], const uint8_t *huffval, DecLut *t) {
    int l, k = 0;
    uint32_t code = 0;
    memset(t->lut, 0, sizeof(t->lut));
    for (l = 1; l <= 16; l++) {
        int n = bits[l];
        while (n--) {
            if (code >= (1u << l)) return -1; /* non-canonical: corrupt */
            if (l <= HUF_LUT_BITS) {
                uint32_t base = code << (HUF_LUT_BITS - l);
                uint32_t span = 1u << (HUF_LUT_BITS - l), j;
                for (j = 0; j < span; j++)
                    t->lut[base + j] = (uint16_t)((huffval[k] << 8) | l);
            }
            code++;
            k++;
        }
        code <<= 1;
    }
    return 0;
}

static int dec_sym_fast(FastBits *f, const DecLut *lu, const DecTable *t) {
    long p = fb_peek(f, 16);
    uint16_t e = lu->lut[p >> (16 - HUF_LUT_BITS)];
    int l;
    if (e) {
        if (fb_skip(f, e & 0xff)) return -1;
        return e >> 8;
    }
    for (l = HUF_LUT_BITS + 1; l <= 16; l++) {
        long code = p >> (16 - l);
        if (t->maxcode[l] >= 0 && code <= t->maxcode[l]) {
            if (fb_skip(f, l)) return -1;
            return t->huffval[t->valptr[l] + (int)(code - t->mincode[l])];
        }
    }
    return -1;
}

static long extend(long v, int s) { /* T.81 F.12: magnitude bits -> value */
    return (s && v < (1L << (s - 1))) ? v - (1L << s) + 1 : v;
}

int tpudct_huff_decode(const uint8_t *data, long n, int h, int w, int16_t *out) {
    DecTable dct, act;
    DecLut dlut, alut;
    uint8_t dbits[17] = {0}, abits[17] = {0}, dval[NSYM], aval[NSYM];
    int ndc = 0, nac = 0, i;
    long off, total_bits, prev_dc = 0;
    FastBits fb;
    int by, bx, k;
    if (h <= 0 || w <= 0 || (h % 8) || (w % 8)) return -2;
    if (n < 1 || data[0] != 1) return -3;
    if (n < 17) return -4;
    for (i = 1; i <= 16; i++) { dbits[i] = data[i]; ndc += data[i]; }
    if (ndc > NSYM || n < 17 + ndc + 16) return -4;
    memset(dval, 0, NSYM);
    memcpy(dval, data + 17, ndc);
    for (i = 1; i <= 16; i++) { abits[i] = data[17 + ndc + i - 1]; nac += abits[i]; }
    if (nac > NSYM || n < 33 + ndc + nac + 4) return -4;
    memset(aval, 0, NSYM);
    memcpy(aval, data + 33 + ndc, nac);
    off = 33 + ndc + nac;
    total_bits = (long)data[off] | ((long)data[off + 1] << 8) |
                 ((long)data[off + 2] << 16) | ((long)data[off + 3] << 24);
    off += 4;
    if ((n - off) * 8 < total_bits) return -4;
    dec_table(dbits, dval, &dct);
    dec_table(abits, aval, &act);
    if (dec_lut(dbits, dval, &dlut) || dec_lut(abits, aval, &alut))
        return -4; /* table counts overflow the canonical code space */
    fb_init(&fb, data + off, total_bits, n - off);
    memset(out, 0, sizeof(int16_t) * (long)h * w);
    for (by = 0; by < h / 8; by++) {
        for (bx = 0; bx < w / 8; bx++) {
            int16_t *blk = out + (long)by * 8 * w + bx * 8;
            int s = dec_sym_fast(&fb, &dlut, &dct);
            long v;
            if (s < 0) return -5;
            if (s > 17) return -5; /* DC size category bound (int16 deltas);
                                    * a corrupt table can hand any byte here
                                    * and extend()'s shift would be UB */
            v = s ? fb_take(&fb, s) : 0;
            if (v < 0) return -5;
            prev_dc += extend(v, s);
            blk[0] = (int16_t)prev_dc;
            k = 1;
            while (k < 64) {
                int sym = dec_sym_fast(&fb, &alut, &act);
                int run, size;
                if (sym < 0) return -5;
                if (sym == 0x00) break; /* EOB */
                run = sym >> 4;
                size = sym & 15;
                if (sym == 0xF0) { k += 16; continue; }
                k += run;
                if (k > 63) return -6;
                v = fb_take(&fb, size);
                if (v < 0) return -5;
                blk[(ZZ[k] >> 3) * (long)w + (ZZ[k] & 7)] = (int16_t)extend(v, size);
                k++;
            }
        }
    }
    return 0;
}

/* ---- rANS stage with positional contexts (.tdc codec 3) ------------------ */
/*
 * Same ITU-T T.81 symbolization as the Huffman stage above (shared
 * emit_blocks), entropy-coded with a byte-wise static rANS (range
 * asymmetric numeral system; Duda 2013, the public ryg_rans construction)
 * instead of prefix codes.  Two structural wins over Huffman:
 *   - sub-bit coding: symbol costs are not rounded up to whole bits
 *     (a p=0.9 EOB costs 0.15 bits, not 1);
 *   - positional contexts: AC symbols are modeled with separate frequency
 *     tables per zig-zag band (k in [1,5] / [6,20] / [21,63]), which a
 *     single-table Huffman coder cannot express.  The decoder knows the
 *     scan position at every step, so contexts need no side information.
 *
 * Stream v2 is MULTI-BAND: the block rows are split into up to 16
 * horizontal bands that encode and decode on one pthread each (DC
 * prediction and the rANS state reset per band, so bands are fully
 * independent; frequency tables stay global, so the model quality is
 * unchanged).  Small maps use 1 band — same compression as v1 within
 * the per-band DC-reset rounding.  Output bytes are deterministic for
 * a given input regardless of thread scheduling.
 *
 * Stream v3 (round 4) refines the positional model: SIX AC zig-zag band
 * contexts (k in [1,2] / [3,5] / [6,10] / [11,20] / [21,35] / [36,63])
 * instead of three.  Measured on 512² std-Q maps (entropy-model sweep,
 * sizes only): -2.6% photo, -3.5% circuit, -1.5% noise
 * net of the three extra tables' overhead; richer schemes (prev-block
 * activity, prev-DC-size, per-position tables) measured worse once
 * table bytes are counted — static tables already capture what those
 * contexts would add.  The v3 bands nest exactly inside v2's, so the
 * encoder computes the Shannon cost of BOTH layouts from one histogram
 * pass and emits whichever is smaller including table bytes (small maps
 * keep v2 — three extra tables cost ~300 B, which outweighs the ~2%
 * model gain below ~15 KB of symbol payload).  The decoders (C and the
 * pure-Python fallback) accept v2 and v3.
 *
 * Stream v4 (round 5) INTERLEAVES FOUR rANS STATES per band (the public
 * ryg_rans construction): symbol i is coded by state i mod 4, the encoder
 * runs in reverse emitting renormalization bytes into one shared stream,
 * and the decoder reads them forward — byte order works out because each
 * symbol's renorm-emit happens immediately before its (reverse-order)
 * encode step.  Compression is unchanged (same tables, same contexts; the
 * only size delta is 1 flags byte + three extra 4-byte seeds per band):
 * the POINT is throughput.  The v2/v3 decode loop's critical path is one
 * serial chain of ~5-cycle multiply/renormalize steps per symbol;
 * interleaving gives the CPU four independent chains to overlap, which is
 * ILP (useful on this 1-core host), not thread parallelism (the pthread
 * bands above).  The encoder's pass B has no other cross-symbol
 * dependency at all, so it pipelines fully.  v4 is an explicit OPT-IN
 * via the encoder's `interleave` argument and applies stream-globally
 * (the version byte covers every band); the v2-vs-v3 CONTEXT choice
 * stays independent and rides a v4 flags bit.
 *
 * Stream layout (payload of .tdc codec 3, version 2, 3 or 4):
 *   u8  version (2 = 4 contexts, 3 = 7 contexts, 4 = interleaved)
 *   [v4 only] u8 flags: low nibble = n_states (4), bit 4 set = 7-context
 *             layout (clear = the v2 4-context fold)
 *   u8  n_bands
 *   u32le rows_per_band  (pixel rows, multiple of 8; last band: remainder)
 *   NCTX tables (DC, then the AC bands in k order), each:
 *       u16le n_entries, then n_entries x { u8 symbol, u16le freq }
 *       (freqs normalized to sum 1<<RANS_BITS; entries sorted by symbol)
 *   per band: u32le rans_bytes, u32le extra_bits
 *   per band: rans bytes (read forward; 4-byte big-endian seeds first —
 *             one for v2/v3, n_states in state order for v4),
 *             then ceil(extra_bits/8) bytes MSB-first
 *
 * The rANS state stream carries only the symbols; magnitude ("extra")
 * bits are incompressible by construction and ride a plain bit stream.
 */

#include <math.h>
#include <pthread.h>
#include <unistd.h>

#define RANS_BITS 12
#define RANS_M (1u << RANS_BITS)
#define RANS_L (1u << 23) /* normalization lower bound */
#define NCTX_V2 4 /* DC + 3 AC zig-zag bands */
#define NCTX_V3 7 /* DC + 6 AC zig-zag bands */
#define NCTX_MAX NCTX_V3
#define RANS_MAX_BANDS 16
#define RANS_NSTATES 4 /* v4 interleave width (power of two; & mask below) */

static int rans_ctx_of_v2(int table, int kpos) {
    if (!table) return 0;
    if (kpos <= 5) return 1;
    if (kpos <= 20) return 2;
    return 3;
}

static int rans_ctx_of_v3(int table, int kpos) {
    if (!table) return 0;
    if (kpos <= 2) return 1;
    if (kpos <= 5) return 2;
    if (kpos <= 10) return 3;
    if (kpos <= 20) return 4;
    if (kpos <= 35) return 5;
    return 6;
}

typedef struct {
    uint32_t freq[NSYM];  /* normalized; 0 = absent */
    uint32_t start[NSYM]; /* cumulative start */
} RansTable;

/* Scale a raw histogram to sum exactly RANS_M, keeping every present
 * symbol at freq >= 1.  Returns number of present symbols (0 if empty). */
static int rans_normalize(const long *hist, RansTable *t) {
    long total = 0;
    uint32_t sum = 0;
    int i, n = 0, imax = -1;
    memset(t, 0, sizeof(*t));
    for (i = 0; i < NSYM; i++) total += hist[i];
    if (!total) return 0;
    for (i = 0; i < NSYM; i++) {
        if (!hist[i]) continue;
        uint32_t f = (uint32_t)(((unsigned long long)hist[i] * RANS_M) / (unsigned long long)total);
        if (!f) f = 1;
        t->freq[i] = f;
        sum += f;
        n++;
        if (imax < 0 || hist[i] > hist[imax]) imax = i;
    }
    /* push the rounding drift onto the most frequent symbol */
    if (sum != RANS_M) {
        long d = (long)RANS_M - (long)sum;
        if ((long)t->freq[imax] + d < 1) {
            /* drift too large to absorb (many rare symbols): steal from
             * every symbol above 1 until it fits */
            for (i = 0; i < NSYM && (long)t->freq[imax] + d < 1; i++) {
                while (i != imax && t->freq[i] > 1 && (long)t->freq[imax] + d < 1) {
                    t->freq[i]--;
                    d++;
                }
            }
        }
        t->freq[imax] = (uint32_t)((long)t->freq[imax] + d);
    }
    sum = 0;
    for (i = 0; i < NSYM; i++) { t->start[i] = sum; sum += t->freq[i]; }
    return n;
}

typedef struct { uint8_t tab; uint8_t sym; } RansSym;

static long put_u32le(uint8_t *p, unsigned long v) {
    p[0] = (uint8_t)(v & 0xff);
    p[1] = (uint8_t)((v >> 8) & 0xff);
    p[2] = (uint8_t)((v >> 16) & 0xff);
    p[3] = (uint8_t)((v >> 24) & 0xff);
    return 4;
}

/* Default band count: ~1 band per 4 Mpixel, 1..16, never more than the
 * block rows or the online CPU count (a band per pthread only pays on
 * multi-core hosts; the 1-core CI host measured -17% decode at 16 bands
 * from table-locality overhead, so single-core stays single-band).
 * Output bytes are deterministic per (input, host CPU count); pass
 * force_bands for host-independent output. */
static int rans_band_count(int h, int w) {
    long nb_rows = h / 8;
    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    long bands = ((long)h * w) >> 22;
    if (ncpu >= 1 && bands > ncpu) bands = ncpu;
    if (bands < 1) bands = 1;
    if (bands > RANS_MAX_BANDS) bands = RANS_MAX_BANDS;
    if (bands > nb_rows) bands = nb_rows;
    return (int)bands;
}

/* ---- encode ---------------------------------------------------------------
 * Pass A (parallel per band): symbolize -> RansSym list + histogram +
 * forward extra-bit stream.  Pass B (parallel per band): rANS-encode the
 * symbol list in reverse against the merged global tables. */

typedef struct {
    /* in */
    const int16_t *c;
    int w, rows;
    const RansTable *tabs;
    const uint8_t *ctx_map; /* v3 context id -> emitted table id */
    const uint64_t (*recip)[NSYM]; /* ceil(2^48/freq) per context symbol */
    /* pass A out */
    RansSym *syms;
    long n, cap;
    long hist[NCTX_MAX][NSYM];
    BitWriter xw;
    long xbits_total;
    /* pass B out */
    uint8_t *rbuf;
    long rcap, rans_n;
    int nstates; /* 1 (v2/v3) or RANS_NSTATES (v4 interleave) */
    int bad;
} RansBand;

/* Direct (inlined-sink) instantiation of the block scan for the rANS
 * collector — same semantics as routing rans_collect_sink through the
 * generic emit_blocks, minus the per-symbol indirect call (the 82%;
 * measured 2.8x faster pass A).  Fuzz + roundtrip tests pin the two
 * code paths together. */
#define SINK_RANS(B, T, KP, SYM, EB, EV)                                     \
    do {                                                                     \
        int rc_ = rans_ctx_of_v3((T), (KP));                                 \
        if ((B)->n >= (B)->cap) { (B)->bad = 1; }                            \
        else {                                                               \
            (B)->syms[(B)->n].tab = (uint8_t)rc_;                            \
            (B)->syms[(B)->n].sym = (uint8_t)(SYM);                          \
            (B)->n++;                                                        \
            (B)->hist[rc_][(SYM)]++;                                         \
            if (EB) bw_put(&(B)->xw, (EV), (EB));                            \
        }                                                                    \
    } while (0)

static void *rans_collect_worker(void *arg) {
    RansBand *b = (RansBand *)arg;
    const int16_t *c = b->c;
    int h = b->rows, w = b->w;
    EMIT_BLOCKS_BODY(b, SINK_RANS);
    b->xbits_total = bw_flush(&b->xw);
    if (b->xw.overflow) b->bad = 1;
    return NULL;
}

static void *rans_encode_worker(void *arg) {
    RansBand *b = (RansBand *)arg;
    long i, rpos = b->rcap;
    uint32_t st[RANS_NSTATES] = {RANS_L, RANS_L, RANS_L, RANS_L};
    const unsigned mask = (unsigned)b->nstates - 1; /* nstates is 1 or 4 */
    int j;
    for (i = b->n - 1; i >= 0; i--) {
        int tab = b->ctx_map[b->syms[i].tab];
        const RansTable *t = &b->tabs[tab];
        uint32_t f = t->freq[b->syms[i].sym];
        uint32_t x_max = ((RANS_L >> RANS_BITS) << 8) * f;
        uint32_t q, state = st[i & mask];
        if (!f) { b->bad = 1; return NULL; }
        /* symbol i rides state i mod n (ryg interleave): renorm-emit
         * right before the reverse-order encode step is exactly what the
         * forward decoder consumes right after its decode step, so the
         * shared byte stream orders itself */
        while (state >= x_max) {
            if (rpos <= 4 * b->nstates) { b->bad = 1; return NULL; }
            b->rbuf[--rpos] = (uint8_t)(state & 0xff);
            state >>= 8;
        }
        /* division-free floor(state/f): reciprocal multiply, exact for
         * state < 2^31 with ceil(2^48/f) since 48 >= 31 + log2(f<=2^12)
         * (Granlund-Montgomery bound).  The hardware div/mod pair was the
         * encoder's hottest instruction. */
        q = (uint32_t)(((__uint128_t)state *
                        b->recip[tab][b->syms[i].sym]) >> 48);
        st[i & mask] =
            (q << RANS_BITS) + (state - q * f) + t->start[b->syms[i].sym];
    }
    if (rpos < 4 * b->nstates) { b->bad = 1; return NULL; }
    /* seeds flush backwards state (n-1)..0, landing front-to-back as
     * state 0..n-1 — the order the decoder reads them */
    for (j = b->nstates - 1; j >= 0; j--) {
        b->rbuf[--rpos] = (uint8_t)(st[j] & 0xff);
        b->rbuf[--rpos] = (uint8_t)((st[j] >> 8) & 0xff);
        b->rbuf[--rpos] = (uint8_t)((st[j] >> 16) & 0xff);
        b->rbuf[--rpos] = (uint8_t)((st[j] >> 24) & 0xff);
    }
    b->rans_n = b->rcap - rpos;
    /* move to buffer start so the assembler can memcpy(rbuf, rans_n) */
    memmove(b->rbuf, b->rbuf + rpos, b->rans_n);
    return NULL;
}

static void rans_bands_free(RansBand *bs, int n) {
    int i;
    for (i = 0; i < n; i++) {
        free(bs[i].syms);
        free(bs[i].xw.buf);
        free(bs[i].rbuf);
    }
}

/* force_bands: 0 = size-based default (rans_band_count); 1..16 = explicit
 * band count (clamped to the block-row count) — lets tests exercise the
 * multi-band layout on small maps.
 * interleave: 0/1 = single-state v2/v3 stream (the measured default);
 * RANS_NSTATES = the 4-way interleaved v4 stream (opt-in, see above). */
long tpudct_rans_encode(const int16_t *coeffs, int h, int w,
                        uint8_t *out, long cap, int force_bands,
                        int interleave) {
    int nbands, bi, c;
    long rpb, pos, i;
    RansBand bands[RANS_MAX_BANDS];
    pthread_t tids[RANS_MAX_BANDS];
    long hist[NCTX_V3][NSYM];
    RansTable tabs[NCTX_V3];
    int version_out = 3, nctx_out = NCTX_V3;
    const uint8_t *ctx_map = NULL;
    uint64_t recip[NCTX_V3][NSYM]; /* per-call: concurrent encodes are legal
                                 * (ctypes releases the GIL) */
    if (h <= 0 || w <= 0 || (h % 8) || (w % 8)) return -1;
    if (force_bands < 0 || force_bands > RANS_MAX_BANDS) return -1;
    if (interleave != 0 && interleave != 1 && interleave != RANS_NSTATES)
        return -1;
    if (has_int16_min(coeffs, (long)h * w)) return -1;
    nbands = force_bands ? force_bands : rans_band_count(h, w);
    if (nbands > h / 8) nbands = h / 8;
    rpb = (((long)h / 8) / nbands) * 8;
    memset(bands, 0, sizeof(bands));
    for (bi = 0; bi < nbands; bi++) {
        RansBand *b = &bands[bi];
        long row0 = rpb * bi;
        b->c = coeffs + row0 * w;
        b->w = w;
        b->rows = (int)(bi == nbands - 1 ? h - row0 : rpb);
        b->cap = (((long)b->rows / 8) * ((long)w / 8)) * 65;
        b->syms = (RansSym *)malloc(sizeof(RansSym) * b->cap);
        b->xw.cap = (long)b->rows * w * 2 + 4096;
        b->xw.buf = (uint8_t *)malloc(b->xw.cap);
        if (!b->syms || !b->xw.buf) { rans_bands_free(bands, nbands); return -1; }
    }
    for (bi = 0; bi < nbands; bi++)
        if (pthread_create(&tids[bi], NULL, rans_collect_worker, &bands[bi])) {
            int j;
            for (j = 0; j < bi; j++) pthread_join(tids[j], NULL);
            rans_bands_free(bands, nbands);
            return -1;
        }
    for (bi = 0; bi < nbands; bi++) pthread_join(tids[bi], NULL);
    memset(hist, 0, sizeof(hist));
    for (bi = 0; bi < nbands; bi++) {
        if (bands[bi].bad) { rans_bands_free(bands, nbands); return -1; }
        for (c = 0; c < NCTX_V3; c++)
            for (i = 0; i < NSYM; i++) hist[c][i] += bands[bi].hist[c][i];
    }
    /* v2's AC bands are the pairwise union of v3's, so both layouts cost
     * out exactly from this one histogram: Shannon bits + table bytes.
     * Emit whichever is smaller (rANS with 12-bit tables tracks the
     * Shannon sum within ~0.1%). */
    {
        long hist2[NCTX_V2][NSYM];
        double cost2 = 0, cost3 = 0;
        int s;
        static const uint8_t fold[NCTX_V3] = {0, 1, 1, 2, 2, 3, 3};
        static const uint8_t ident[NCTX_V3] = {0, 1, 2, 3, 4, 5, 6};
        memset(hist2, 0, sizeof(hist2));
        for (c = 0; c < NCTX_V3; c++)
            for (s = 0; s < NSYM; s++) hist2[fold[c]][s] += hist[c][s];
        for (c = 0; c < NCTX_V3; c++) {
            long tot = 0;
            int npres = 0;
            for (s = 0; s < NSYM; s++) tot += hist[c][s];
            for (s = 0; s < NSYM; s++)
                if (hist[c][s]) {
                    npres++;
                    cost3 -= (double)hist[c][s] *
                             log2((double)hist[c][s] / (double)tot);
                }
            cost3 += (2 + 3.0 * npres) * 8.0;
        }
        for (c = 0; c < NCTX_V2; c++) {
            long tot = 0;
            int npres = 0;
            for (s = 0; s < NSYM; s++) tot += hist2[c][s];
            for (s = 0; s < NSYM; s++)
                if (hist2[c][s]) {
                    npres++;
                    cost2 -= (double)hist2[c][s] *
                             log2((double)hist2[c][s] / (double)tot);
                }
            cost2 += (2 + 3.0 * npres) * 8.0;
        }
        if (cost3 < cost2) {
            version_out = 3;
            nctx_out = NCTX_V3;
            ctx_map = ident;
            for (c = 0; c < NCTX_V3; c++) rans_normalize(hist[c], &tabs[c]);
        } else {
            version_out = 2;
            nctx_out = NCTX_V2;
            ctx_map = fold;
            for (c = 0; c < NCTX_V2; c++) rans_normalize(hist2[c], &tabs[c]);
        }
    }
    for (c = 0; c < nctx_out; c++)
        for (i = 0; i < NSYM; i++)
            recip[c][i] = tabs[c].freq[i]
                ? (uint64_t)((((__uint128_t)1 << 48) + tabs[c].freq[i] - 1) /
                             tabs[c].freq[i])
                : 0;
    /* v4 interleave is an explicit OPT-IN (interleave == RANS_NSTATES),
     * not the default: on a 1-core Xeon host the 4-way decoder
     * measured 0.72-0.89x the serial one (the decode loop is
     * THROUGHPUT-bound at ~40 cycles/symbol —
     * bit reads, scan branches, block scatter — so removing the ~15-
     * cycle state chain buys nothing and the extra state bookkeeping
     * costs).  The knob stays because the construction is sound and a
     * wide out-of-order host may invert the result; streams decode
     * everywhere either way (both C decoders + the Python fallback). */
    for (bi = 0; bi < nbands; bi++)
        bands[bi].nstates = interleave == RANS_NSTATES ? RANS_NSTATES : 1;
    for (bi = 0; bi < nbands; bi++) {
        RansBand *b = &bands[bi];
        b->tabs = tabs;
        b->ctx_map = ctx_map;
        b->recip = (const uint64_t (*)[NSYM])recip;
        b->rcap = b->n * 4 + 64;
        b->rbuf = (uint8_t *)malloc(b->rcap);
        if (!b->rbuf) { rans_bands_free(bands, nbands); return -1; }
    }
    for (bi = 0; bi < nbands; bi++)
        if (pthread_create(&tids[bi], NULL, rans_encode_worker, &bands[bi])) {
            int j;
            for (j = 0; j < bi; j++) pthread_join(tids[j], NULL);
            rans_bands_free(bands, nbands);
            return -1;
        }
    for (bi = 0; bi < nbands; bi++) pthread_join(tids[bi], NULL);
    for (bi = 0; bi < nbands; bi++)
        if (bands[bi].bad) { rans_bands_free(bands, nbands); return -1; }
    /* assemble */
    pos = 0;
    if (cap < 7) goto fail;
    if (bands[0].nstates > 1) {
        out[pos++] = 4; /* interleaved layout; context choice in flags */
        out[pos++] = (uint8_t)(bands[0].nstates |
                               (version_out == 3 ? 0x10 : 0));
    } else {
        out[pos++] = (uint8_t)version_out;
    }
    out[pos++] = (uint8_t)nbands;
    pos += put_u32le(out + pos, (unsigned long)rpb);
    for (c = 0; c < nctx_out; c++) {
        int n = 0, s;
        for (s = 0; s < NSYM; s++) n += tabs[c].freq[s] != 0;
        if (pos + 2 + 3L * n > cap) goto fail;
        out[pos++] = (uint8_t)(n & 0xff);
        out[pos++] = (uint8_t)(n >> 8);
        for (s = 0; s < NSYM; s++) {
            if (!tabs[c].freq[s]) continue;
            out[pos++] = (uint8_t)s;
            out[pos++] = (uint8_t)(tabs[c].freq[s] & 0xff);
            out[pos++] = (uint8_t)(tabs[c].freq[s] >> 8);
        }
    }
    if (pos + 8L * nbands > cap) goto fail;
    for (bi = 0; bi < nbands; bi++) {
        /* the header fields are u32: refuse (never truncate) a band whose
         * rans stream or magnitude-bit stream exceeds 2^32-1 (a ~537 MB
         * single-band bit stream; possible for dense 300+ Mpixel maps on
         * a 1-CPU host).  serialize.py's `auto` falls back to another
         * stage on the resulting error. */
        if (bands[bi].rans_n > 0xffffffffL ||
            bands[bi].xbits_total > 0xffffffffL)
            goto fail;
        pos += put_u32le(out + pos, (unsigned long)bands[bi].rans_n);
        pos += put_u32le(out + pos, (unsigned long)bands[bi].xbits_total);
    }
    for (bi = 0; bi < nbands; bi++) {
        long xb = (bands[bi].xbits_total + 7) / 8;
        if (pos + bands[bi].rans_n + xb > cap) goto fail;
        memcpy(out + pos, bands[bi].rbuf, bands[bi].rans_n);
        pos += bands[bi].rans_n;
        memcpy(out + pos, bands[bi].xw.buf, xb);
        pos += xb;
    }
    rans_bands_free(bands, nbands);
    return pos;
fail:
    rans_bands_free(bands, nbands);
    return -1;
}

/* ---- decode --------------------------------------------------------------- */

typedef struct {
    uint8_t slot_sym[RANS_M]; /* slot -> symbol */
    uint32_t freq[NSYM], start[NSYM];
    int empty;
} RansDec;

typedef struct {
    const RansDec *tabs;
    const uint8_t *ac_ctx; /* zig-zag position -> AC context (per version) */
    const uint8_t *rb;     /* this band's rans bytes */
    long rans_n;
    FastBits xr;
    int16_t *out; /* first pixel row of this band */
    int rows, w;
    int nstates; /* 1 (v2/v3) or RANS_NSTATES (v4) */
    int rc; /* 0 ok / negative error */
} RansDecBand;

static void *rans_decode_worker(void *arg) {
    RansDecBand *d = (RansDecBand *)arg;
    const RansDec *tabs = d->tabs;
    const uint8_t *rb = d->rb;
    long rcur, prev_dc = 0;
    uint32_t state;
    int by, bx;
    d->rc = -5;
    if (d->rans_n < 4) return NULL;
    state = ((uint32_t)rb[0] << 24) | ((uint32_t)rb[1] << 16) |
            ((uint32_t)rb[2] << 8) | (uint32_t)rb[3];
    rcur = 4;
    memset(d->out, 0, sizeof(int16_t) * (long)d->rows * d->w);
    for (by = 0; by < d->rows / 8; by++) {
        for (bx = 0; bx < d->w / 8; bx++) {
            int16_t *blk = d->out + (long)by * 8 * d->w + bx * 8;
            int k, s, sym;
            long v;
            /* decode one symbol from context ctx.  A non-empty table's
             * freqs sum to exactly RANS_M, so every slot maps to a
             * symbol — no sentinel check needed beyond `empty`. */
#define RANS_NEXT(ctx, dst)                                                  \
            do {                                                             \
                const RansDec *t = &tabs[ctx];                               \
                uint32_t slot = state & (RANS_M - 1);                        \
                int _s;                                                      \
                if (t->empty) return NULL;                                   \
                _s = t->slot_sym[slot];                                      \
                state = t->freq[_s] * (state >> RANS_BITS) + slot -          \
                        t->start[_s];                                        \
                while (state < RANS_L) {                                     \
                    if (rcur >= d->rans_n) return NULL;                      \
                    state = (state << 8) | rb[rcur++];                       \
                }                                                            \
                (dst) = _s;                                                  \
            } while (0)
            RANS_NEXT(0, s);
            if (s > 17) return NULL;
            v = s ? fb_take(&d->xr, s) : 0;
            if (v < 0) return NULL;
            prev_dc += extend(v, s);
            blk[0] = (int16_t)prev_dc;
            k = 1;
            while (k < 64) {
                int run, size;
                RANS_NEXT(d->ac_ctx[k], sym);
                if (sym == 0x00) break; /* EOB */
                if (sym == 0xF0) { k += 16; continue; }
                run = sym >> 4;
                size = sym & 15;
                if (!size) return NULL;
                k += run;
                if (k > 63) return NULL;
                v = fb_take(&d->xr, size);
                if (v < 0) return NULL;
                blk[(ZZ[k] >> 3) * (long)d->w + (ZZ[k] & 7)] =
                    (int16_t)extend(v, size);
                k++;
            }
#undef RANS_NEXT
        }
    }
    d->rc = 0;
    return NULL;
}

/* v4 interleaved twin of rans_decode_worker: RANS_NSTATES round-robin
 * states over ONE shared byte stream.  Kept as a separate function (not a
 * runtime nstates branch in the hot loop) so the single-state v2/v3
 * decoder keeps its state in a register; here the four states give the
 * CPU independent multiply/renormalize chains to overlap — the ILP the
 * serial chain could not expose. */
static void *rans_decode_worker_il(void *arg) {
    RansDecBand *d = (RansDecBand *)arg;
    const RansDec *tabs = d->tabs;
    const uint8_t *rb = d->rb;
    long rcur, prev_dc = 0;
    uint32_t r0, r1, r2, r3, rt;
    int by, bx;
    d->rc = -5;
    if (d->rans_n < 4 * RANS_NSTATES) return NULL;
    /* The four states live in ROTATING named locals: r0 always holds the
     * next symbol's state, and a 4-way register rotation follows every
     * decode step.  Register renaming makes the rotation ~free, and the
     * rotation keeps each physical state's multiply/renormalize chain
     * four symbols apart — the ILP this layout exists for.  (An indexed
     * st[si & 3] array costs a store-to-load hop INSIDE every chain and
     * measured SLOWER than the serial v3 decoder, 0.72-0.80x.) */
#define RD_SEED(j) (((uint32_t)rb[4 * (j)] << 24) |                          \
                    ((uint32_t)rb[4 * (j) + 1] << 16) |                      \
                    ((uint32_t)rb[4 * (j) + 2] << 8) |                       \
                    (uint32_t)rb[4 * (j) + 3])
    r0 = RD_SEED(0); r1 = RD_SEED(1); r2 = RD_SEED(2); r3 = RD_SEED(3);
#undef RD_SEED
    rcur = 4 * RANS_NSTATES;
    memset(d->out, 0, sizeof(int16_t) * (long)d->rows * d->w);
    for (by = 0; by < d->rows / 8; by++) {
        for (bx = 0; bx < d->w / 8; bx++) {
            int16_t *blk = d->out + (long)by * 8 * d->w + bx * 8;
            int k, s, sym;
            long v;
#define RANS_NEXT_IL(ctx, dst)                                               \
            do {                                                             \
                const RansDec *t = &tabs[ctx];                               \
                uint32_t slot = r0 & (RANS_M - 1);                           \
                int _s;                                                      \
                if (t->empty) return NULL;                                   \
                _s = t->slot_sym[slot];                                      \
                rt = t->freq[_s] * (r0 >> RANS_BITS) + slot - t->start[_s];  \
                while (rt < RANS_L) {                                        \
                    if (rcur >= d->rans_n) return NULL;                      \
                    rt = (rt << 8) | rb[rcur++];                             \
                }                                                            \
                r0 = r1; r1 = r2; r2 = r3; r3 = rt;                          \
                (dst) = _s;                                                  \
            } while (0)
            RANS_NEXT_IL(0, s);
            if (s > 17) return NULL;
            v = s ? fb_take(&d->xr, s) : 0;
            if (v < 0) return NULL;
            prev_dc += extend(v, s);
            blk[0] = (int16_t)prev_dc;
            k = 1;
            while (k < 64) {
                int run, size;
                RANS_NEXT_IL(d->ac_ctx[k], sym);
                if (sym == 0x00) break; /* EOB */
                if (sym == 0xF0) { k += 16; continue; }
                run = sym >> 4;
                size = sym & 15;
                if (!size) return NULL;
                k += run;
                if (k > 63) return NULL;
                v = fb_take(&d->xr, size);
                if (v < 0) return NULL;
                blk[(ZZ[k] >> 3) * (long)d->w + (ZZ[k] & 7)] =
                    (int16_t)extend(v, size);
                k++;
            }
#undef RANS_NEXT_IL
        }
    }
    d->rc = 0;
    return NULL;
}

int tpudct_rans_decode(const uint8_t *data, long n, int h, int w, int16_t *out) {
    RansDec *tabs;
    RansDecBand dbs[RANS_MAX_BANDS];
    pthread_t tids[RANS_MAX_BANDS];
    uint8_t ac_ctx[64];
    long pos = 0, rpb, off;
    int c, bi, nbands, nctx, version, nstates = 1, v2ctx, rc = 0;
    if (h <= 0 || w <= 0 || (h % 8) || (w % 8)) return -2;
    if (n < 6) return -3;
    version = data[pos++];
    if (version != 2 && version != 3 && version != 4) return -3;
    if (version == 4) {
        int flags;
        if (n < 7) return -3;
        flags = data[pos++];
        nstates = flags & 0x0f;
        if (nstates != RANS_NSTATES) return -3; /* only 4-way is emitted */
        v2ctx = !(flags & 0x10);
    } else {
        v2ctx = version == 2;
    }
    nctx = v2ctx ? NCTX_V2 : NCTX_V3;
    for (c = 1; c < 64; c++)
        ac_ctx[c] = (uint8_t)(v2ctx ? rans_ctx_of_v2(1, c)
                                    : rans_ctx_of_v3(1, c));
    ac_ctx[0] = 0;
    nbands = data[pos++];
    rpb = (long)data[pos] | ((long)data[pos + 1] << 8) |
          ((long)data[pos + 2] << 16) | ((long)data[pos + 3] << 24);
    pos += 4;
    if (nbands < 1 || nbands > RANS_MAX_BANDS || (rpb % 8) || rpb < 8)
        return -3;
    if (rpb * (nbands - 1) >= h && nbands > 1) return -3;
    if (nbands == 1 && rpb > (long)h) return -3;
    tabs = (RansDec *)malloc(sizeof(RansDec) * nctx);
    if (!tabs) return -1;
    for (c = 0; c < nctx; c++) {
        int ne, i;
        uint32_t sum = 0;
        memset(tabs[c].slot_sym, 0xff, RANS_M);
        memset(tabs[c].freq, 0, sizeof(tabs[c].freq));
        if (pos + 2 > n) goto corrupt;
        ne = data[pos] | (data[pos + 1] << 8);
        pos += 2;
        if (ne > NSYM || pos + 3L * ne > n) goto corrupt;
        tabs[c].empty = ne == 0;
        for (i = 0; i < ne; i++) {
            int s = data[pos];
            uint32_t f = (uint32_t)(data[pos + 1] | (data[pos + 2] << 8));
            pos += 3;
            if (!f || tabs[c].freq[s]) goto corrupt;
            tabs[c].freq[s] = f;
            tabs[c].start[s] = sum;
            if (sum + f > RANS_M) goto corrupt;
            memset(tabs[c].slot_sym + sum, s, f);
            sum += f;
        }
        if (ne && sum != RANS_M) goto corrupt;
    }
    if (pos + 8L * nbands > n) goto corrupt;
    off = pos + 8L * nbands;
    for (bi = 0; bi < nbands; bi++) {
        RansDecBand *d = &dbs[bi];
        long rans_n, xbits, xb;
        long row0 = rpb * bi;
        rans_n = (long)data[pos] | ((long)data[pos + 1] << 8) |
                 ((long)data[pos + 2] << 16) | ((long)data[pos + 3] << 24);
        pos += 4;
        xbits = (long)data[pos] | ((long)data[pos + 1] << 8) |
                ((long)data[pos + 2] << 16) | ((long)data[pos + 3] << 24);
        pos += 4;
        xb = (xbits + 7) / 8;
        if (rans_n < 4L * nstates || xbits < 0 || off + rans_n + xb > n)
            goto corrupt;
        d->tabs = tabs;
        d->ac_ctx = ac_ctx;
        d->rb = data + off;
        d->rans_n = rans_n;
        fb_init(&d->xr, data + off + rans_n, xbits, xb);
        d->out = out + row0 * w;
        d->rows = (int)(bi == nbands - 1 ? h - row0 : rpb);
        d->w = w;
        d->nstates = nstates;
        d->rc = -5;
        if (d->rows <= 0 || (bi == nbands - 1 && rpb * bi + d->rows != h))
            goto corrupt;
        off += rans_n + xb;
    }
    for (bi = 0; bi < nbands; bi++)
        if (pthread_create(&tids[bi], NULL,
                           nstates > 1 ? rans_decode_worker_il
                                       : rans_decode_worker,
                           &dbs[bi])) {
            int j;
            for (j = 0; j < bi; j++) pthread_join(tids[j], NULL);
            free(tabs);
            return -1;
        }
    for (bi = 0; bi < nbands; bi++) pthread_join(tids[bi], NULL);
    for (bi = 0; bi < nbands; bi++)
        if (dbs[bi].rc) rc = dbs[bi].rc;
    free(tabs);
    return rc;
corrupt:
    free(tabs);
    return -5;
}
