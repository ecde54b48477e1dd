/* Native JPEG codec for tpudct.
 *
 * Re-design of the reference's host image I/O
 * (load_jpeg_as_matrix, /root/reference/utils.cu:38-95;
 * save_grayscale_jpeg, utils.cu:98-147).  Differences by design:
 *   - decode can force grayscale conversion in-codec (the reference returns
 *     native channels and its drivers then index RGB data as if it were
 *     single-channel — a latent bug we do not replicate);
 *   - encode-to-memory is provided so the framework can measure compressed
 *     sizes without touching the filesystem (compression-factor metric);
 *   - errors return codes instead of exit() (the reference's CHECK_* macros
 *     print-and-exit, main_cublass.cu:10-29).
 *
 * Exposed via ctypes (no pybind11 in this image); see tpudct/utils/imageio.py.
 */

#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

/* libjpeg's default error handler calls exit(); trampoline back instead. */
struct tpudct_err_mgr {
    struct jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

static void tpudct_error_exit(j_common_ptr cinfo) {
    struct tpudct_err_mgr *err = (struct tpudct_err_mgr *)cinfo->err;
    longjmp(err->setjmp_buffer, 1);
}

/* Decode `filename`.  force_gray!=0 requests JCS_GRAYSCALE output (libjpeg
 * does the colorspace conversion).  On success returns 0 and fills *out
 * (malloc'd, h*w*channels bytes, caller frees via tpudct_free), *w, *h,
 * *channels.  Returns nonzero on failure. */
int tpudct_jpeg_decode(const char *filename, unsigned char **out, int *w,
                       int *h, int *channels, int force_gray) {
    struct jpeg_decompress_struct cinfo;
    struct tpudct_err_mgr jerr;
    FILE *infile = fopen(filename, "rb");
    /* volatile: modified between setjmp and longjmp (C11 7.13.2.1p3) */
    unsigned char *volatile buf = NULL;

    if (!infile) return 1;

    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = tpudct_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        fclose(infile);
        free(buf);
        return 2;
    }

    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, infile);
    jpeg_read_header(&cinfo, TRUE);
    if (force_gray) cinfo.out_color_space = JCS_GRAYSCALE;
    jpeg_start_decompress(&cinfo);

    *w = (int)cinfo.output_width;
    *h = (int)cinfo.output_height;
    *channels = (int)cinfo.output_components;

    size_t stride = (size_t)(*w) * (size_t)(*channels);
    buf = (unsigned char *)malloc(stride * (size_t)(*h));
    if (!buf) {
        jpeg_destroy_decompress(&cinfo);
        fclose(infile);
        return 3;
    }

    while (cinfo.output_scanline < cinfo.output_height) {
        unsigned char *row = buf + (size_t)cinfo.output_scanline * stride;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }

    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(infile);
    *out = buf;
    return 0;
}

static int encode_common(struct jpeg_compress_struct *cinfo,
                         const unsigned char *data, int w, int h,
                         int channels, int quality) {
    cinfo->image_width = (JDIMENSION)w;
    cinfo->image_height = (JDIMENSION)h;
    cinfo->input_components = channels;
    cinfo->in_color_space = channels == 3 ? JCS_RGB : JCS_GRAYSCALE;
    jpeg_set_defaults(cinfo);
    jpeg_set_quality(cinfo, quality, TRUE);
    jpeg_start_compress(cinfo, TRUE);
    size_t stride = (size_t)w * (size_t)channels;
    while (cinfo->next_scanline < cinfo->image_height) {
        const unsigned char *row = data + (size_t)cinfo->next_scanline * stride;
        jpeg_write_scanlines(cinfo, (JSAMPARRAY)&row, 1);
    }
    jpeg_finish_compress(cinfo);
    return 0;
}

/* Encode a grayscale (channels=1) or interleaved-RGB (channels=3) buffer
 * to `filename` at `quality` (0-100).  0 on success (generalization of
 * save_grayscale_jpeg, utils.cu:98-147 — the reference has no color
 * output path at all, utils.cu:70-72). */
int tpudct_jpeg_encode_ch(const char *filename, const unsigned char *data,
                          int w, int h, int channels, int quality) {
    struct jpeg_compress_struct cinfo;
    struct tpudct_err_mgr jerr;
    FILE *outfile = fopen(filename, "wb");
    if (!outfile) return 1;

    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = tpudct_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_compress(&cinfo);
        fclose(outfile);
        return 2;
    }

    jpeg_create_compress(&cinfo);
    jpeg_stdio_dest(&cinfo, outfile);
    encode_common(&cinfo, data, w, h, channels, quality);
    jpeg_destroy_compress(&cinfo);
    fclose(outfile);
    return 0;
}

/* Back-compat grayscale entry point. */
int tpudct_jpeg_encode(const char *filename, const unsigned char *data, int w,
                       int h, int quality) {
    return tpudct_jpeg_encode_ch(filename, data, w, h, 1, quality);
}

/* Encode to a malloc'd memory buffer; fills *out and *out_size.  Used for
 * compressed-size measurement without filesystem round-trips. */
/* channels: 1 = grayscale, 3 = interleaved RGB (libjpeg converts to
 * YCbCr and 4:2:0-subsamples by default — the standard color anchor the
 * BD-rate comparison measures against). */
int tpudct_jpeg_encode_mem(const unsigned char *data, int w, int h,
                           int channels, int quality, unsigned char **out,
                           unsigned long *out_size) {
    struct jpeg_compress_struct cinfo;
    struct tpudct_err_mgr jerr;
    *out = NULL;
    *out_size = 0;

    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = tpudct_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_compress(&cinfo);
        free(*out);
        *out = NULL;
        return 2;
    }

    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, out, out_size);
    encode_common(&cinfo, data, w, h, channels, quality);
    jpeg_destroy_compress(&cinfo);
    return 0;
}

void tpudct_free(unsigned char *p) { free(p); }

/* ABI version probe: bumped whenever ANY exported signature changes
 * (round 5: tpudct_jpeg_encode_mem gained `channels`, tpudct_rans_encode
 * gained `interleave`).  The Python loader refuses/rebuilds a library
 * whose version disagrees — a NAME-presence probe cannot catch a
 * signature-only change, and calling through a stale signature silently
 * misreads arguments (review finding: an old .so would have read the
 * new channels argument as `quality`). */
int tpudct_abi_version(void) { return 5; }

/* ---- coefficient-domain JPEG I/O (lossless transcode) -------------------
 *
 * The reference's only persistence is a pixel-domain quality-100 re-encode
 * (save_grayscale_jpeg, utils.cu:98-147) — a generation-loss step.  These
 * two functions move the already-quantized DCT coefficients directly
 * between .jpg entropy streams and tpudct coefficient maps (the JPEG
 * equivalent of jpegtran): no IDCT, no re-quantization, bit-exact.
 *
 * Layout contract with the Python side: per component, one int16 map of
 * shape (height_in_blocks*8, width_in_blocks*8) where block (by,bx)
 * occupies rows by*8..by*8+8 and cols bx*8..bx*8+8, coefficients in
 * natural (row-major) order — exactly the .tdc coefficient-map layout.
 * Quantization tables are 64 uint16 in natural order. */

#define TPUDCT_MAX_COMPS 4

/* Decode the coefficient arrays of `filename` without any IDCT.
 * Fills per-component malloc'd maps (caller frees each via tpudct_free),
 * map dims, quant tables, sampling factors, component count and pixel
 * dims.  All out-arrays must hold TPUDCT_MAX_COMPS entries (qtabs
 * TPUDCT_MAX_COMPS*64).  Returns 0 ok; 1 open; 2 libjpeg error; 3 alloc;
 * 4 unsupported colorspace/component count; 5 missing quant table. */
int tpudct_jpeg_read_coefs(const char *filename, short **coef_bufs,
                           int *comp_w, int *comp_h, unsigned short *qtabs,
                           int *h_samp, int *v_samp, int *ncomp,
                           int *img_w, int *img_h) {
    struct jpeg_decompress_struct cinfo;
    struct tpudct_err_mgr jerr;
    FILE *infile = fopen(filename, "rb");
    int c;

    if (!infile) return 1;
    for (c = 0; c < TPUDCT_MAX_COMPS; c++) coef_bufs[c] = NULL;

    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = tpudct_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        fclose(infile);
        for (c = 0; c < TPUDCT_MAX_COMPS; c++) {
            free(coef_bufs[c]);
            coef_bufs[c] = NULL;
        }
        return 2;
    }

    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, infile);
    jpeg_read_header(&cinfo, TRUE);
    if ((cinfo.jpeg_color_space != JCS_GRAYSCALE &&
         cinfo.jpeg_color_space != JCS_YCbCr) ||
        cinfo.num_components < 1 ||
        cinfo.num_components > TPUDCT_MAX_COMPS) {
        jpeg_destroy_decompress(&cinfo);
        fclose(infile);
        return 4;
    }

    jvirt_barray_ptr *arrays = jpeg_read_coefficients(&cinfo);
    *ncomp = cinfo.num_components;
    *img_w = (int)cinfo.image_width;
    *img_h = (int)cinfo.image_height;

    for (c = 0; c < cinfo.num_components; c++) {
        jpeg_component_info *comp = &cinfo.comp_info[c];
        JQUANT_TBL *qt = comp->quant_table
                             ? comp->quant_table
                             : cinfo.quant_tbl_ptrs[comp->quant_tbl_no];
        if (!qt) {
            jpeg_destroy_decompress(&cinfo);
            fclose(infile);
            for (int k = 0; k < c; k++) {
                free(coef_bufs[k]);
                coef_bufs[k] = NULL;
            }
            return 5;
        }
        int wb = (int)comp->width_in_blocks;
        int hb = (int)comp->height_in_blocks;
        comp_w[c] = wb * 8;
        comp_h[c] = hb * 8;
        h_samp[c] = comp->h_samp_factor;
        v_samp[c] = comp->v_samp_factor;
        for (int i = 0; i < 64; i++) qtabs[c * 64 + i] = qt->quantval[i];

        short *map = (short *)malloc((size_t)hb * 8 * (size_t)wb * 8 *
                                     sizeof(short));
        if (!map) {
            jpeg_destroy_decompress(&cinfo);
            fclose(infile);
            for (int k = 0; k < c; k++) {
                free(coef_bufs[k]);
                coef_bufs[k] = NULL;
            }
            return 3;
        }
        coef_bufs[c] = map;
        size_t stride = (size_t)wb * 8;
        for (int by = 0; by < hb; by++) {
            JBLOCKARRAY rows = (cinfo.mem->access_virt_barray)(
                (j_common_ptr)&cinfo, arrays[c], (JDIMENSION)by, 1, FALSE);
            for (int bx = 0; bx < wb; bx++) {
                JCOEFPTR blk = rows[0][bx];
                for (int i = 0; i < 8; i++)
                    for (int j = 0; j < 8; j++)
                        map[((size_t)by * 8 + i) * stride + (size_t)bx * 8 + j] =
                            blk[i * 8 + j];
            }
        }
    }

    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(infile);
    return 0;
}

/* Entropy-encode coefficient maps straight into `filename` (no FDCT, no
 * requantization).  Per-component map dims must equal libjpeg's
 * width/height_in_blocks*8 for (img_w, img_h) and the sampling factors —
 * validated, returns 6 on mismatch.  Returns 0 ok; 1 open; 2 libjpeg
 * error (includes coefficients outside the Huffman category range);
 * 4 bad component count.
 *
 * `flags` selects the entropy coding, jpegtran-style: bit 0 = two-pass
 * optimal Huffman tables (jpegtran -optimize), bit 1 = progressive scan
 * script (jpegtran -progressive; implies optimize, as jpegtran does —
 * libjpeg has no canned progressive Huffman tables), bit 2 = arithmetic
 * coding (jpegtran -arithmetic; supersedes Huffman optimization, may
 * combine with progressive).  All are bit-lossless re-codings of the
 * same coefficients. */
#define TPUDCT_WC_OPTIMIZE 1
#define TPUDCT_WC_PROGRESSIVE 2
#define TPUDCT_WC_ARITH 4

int tpudct_jpeg_write_coefs_ex(const char *filename, const short **coef_bufs,
                               const int *comp_w, const int *comp_h,
                               const unsigned short *qtabs, const int *h_samp,
                               const int *v_samp, int ncomp, int img_w,
                               int img_h, int flags) {
    struct jpeg_compress_struct cinfo;
    struct tpudct_err_mgr jerr;
    FILE *outfile;
    int c;

    if (ncomp != 1 && ncomp != 3) return 4;
    outfile = fopen(filename, "wb");
    if (!outfile) return 1;

    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = tpudct_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        /* A mid-stream libjpeg abort (e.g. a coefficient outside the
         * Huffman category range) must not leave a truncated .jpg that a
         * resumable bulk job would then treat as a finished output. */
        jpeg_destroy_compress(&cinfo);
        fclose(outfile);
        remove(filename);
        return 2;
    }

    jpeg_create_compress(&cinfo);
    jpeg_stdio_dest(&cinfo, outfile);
    cinfo.image_width = (JDIMENSION)img_w;
    cinfo.image_height = (JDIMENSION)img_h;
    cinfo.input_components = ncomp;
    cinfo.in_color_space = ncomp == 3 ? JCS_YCbCr : JCS_GRAYSCALE;
    jpeg_set_defaults(&cinfo);

    for (c = 0; c < ncomp; c++) {
        unsigned int basic[64];
        for (int i = 0; i < 64; i++) basic[i] = qtabs[c * 64 + i];
        /* force_baseline=FALSE keeps table values up to 32767 intact */
        jpeg_add_quant_table(&cinfo, c, basic, 100, FALSE);
        cinfo.comp_info[c].quant_tbl_no = c;
        cinfo.comp_info[c].h_samp_factor = h_samp[c];
        cinfo.comp_info[c].v_samp_factor = v_samp[c];
    }

    if (flags & TPUDCT_WC_PROGRESSIVE) {
        /* After the component loop: the scan script is built from the
         * final num_components.  Progressive Huffman coding requires
         * table optimization (no canned progressive tables exist). */
        jpeg_simple_progression(&cinfo);
        cinfo.optimize_coding = TRUE;
    }
    if (flags & TPUDCT_WC_OPTIMIZE) cinfo.optimize_coding = TRUE;
    if (flags & TPUDCT_WC_ARITH) {
        /* Arithmetic entropy coding has no tables to optimize. */
        cinfo.arith_code = TRUE;
        cinfo.optimize_coding = FALSE;
    }

    /* Request per-component coefficient arrays (padded to MCU multiples;
     * pre-zeroed so dummy edge blocks are valid), realized by
     * jpeg_write_coefficients; the entropy pass happens inside
     * jpeg_finish_compress, after the maps are copied in. */
    jvirt_barray_ptr arrays[TPUDCT_MAX_COMPS];
    for (c = 0; c < ncomp; c++) {
        JDIMENSION wb_pad =
            (JDIMENSION)(((comp_w[c] / 8 + h_samp[c] - 1) / h_samp[c]) *
                         h_samp[c]);
        JDIMENSION hb_pad =
            (JDIMENSION)(((comp_h[c] / 8 + v_samp[c] - 1) / v_samp[c]) *
                         v_samp[c]);
        arrays[c] = (cinfo.mem->request_virt_barray)(
            (j_common_ptr)&cinfo, JPOOL_IMAGE, TRUE, wb_pad, hb_pad,
            (JDIMENSION)v_samp[c]);
    }
    jpeg_write_coefficients(&cinfo, arrays);

    for (c = 0; c < ncomp; c++) {
        int wb = comp_w[c] / 8, hb = comp_h[c] / 8;
        if (wb != (int)cinfo.comp_info[c].width_in_blocks ||
            hb != (int)cinfo.comp_info[c].height_in_blocks) {
            jpeg_destroy_compress(&cinfo);
            fclose(outfile);
            remove(filename);
            return 6;
        }
        size_t stride = (size_t)wb * 8;
        const short *map = coef_bufs[c];
        for (int by = 0; by < hb; by++) {
            JBLOCKARRAY rows = (cinfo.mem->access_virt_barray)(
                (j_common_ptr)&cinfo, arrays[c], (JDIMENSION)by, 1, TRUE);
            for (int bx = 0; bx < wb; bx++) {
                JCOEFPTR blk = rows[0][bx];
                for (int i = 0; i < 8; i++)
                    for (int j = 0; j < 8; j++)
                        blk[i * 8 + j] =
                            (JCOEF)map[((size_t)by * 8 + i) * stride +
                                       (size_t)bx * 8 + j];
            }
        }
    }

    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    fclose(outfile);
    return 0;
}

/* Baseline-Huffman write with canned tables (flags=0 shorthand). */
int tpudct_jpeg_write_coefs(const char *filename, const short **coef_bufs,
                            const int *comp_w, const int *comp_h,
                            const unsigned short *qtabs, const int *h_samp,
                            const int *v_samp, int ncomp, int img_w,
                            int img_h) {
    return tpudct_jpeg_write_coefs_ex(filename, coef_bufs, comp_w, comp_h,
                                      qtabs, h_samp, v_samp, ncomp, img_w,
                                      img_h, 0);
}

/* ---- threaded batch decode (the data-loader path) ----------------------
 *
 * The device side of the codec runs at ~0.1 ms/image; host JPEG decode is
 * the bulk-encoding bottleneck.  A pthread pool decodes N files in
 * parallel (libjpeg contexts are per-thread, so this is safe); work is
 * claimed with an atomic counter.  Per-file return codes land in rcs[];
 * the function returns the number of failures (0 = all decoded). */

#include <pthread.h>

struct batch_ctx {
    const char **filenames;
    int n;
    int force_gray;
    unsigned char **outs;
    int *ws, *hs, *chs, *rcs;
    int next; /* atomic work index */
};

static void *batch_worker(void *arg) {
    struct batch_ctx *ctx = (struct batch_ctx *)arg;
    for (;;) {
        int i = __atomic_fetch_add(&ctx->next, 1, __ATOMIC_RELAXED);
        if (i >= ctx->n) break;
        ctx->rcs[i] = tpudct_jpeg_decode(ctx->filenames[i], &ctx->outs[i],
                                         &ctx->ws[i], &ctx->hs[i],
                                         &ctx->chs[i], ctx->force_gray);
    }
    return NULL;
}

int tpudct_jpeg_decode_batch(const char **filenames, int n, int n_threads,
                             unsigned char **outs, int *ws, int *hs, int *chs,
                             int *rcs, int force_gray) {
    if (n <= 0) return 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = n;

    struct batch_ctx ctx = {filenames, n, force_gray, outs, ws, hs, chs, rcs, 0};
    for (int i = 0; i < n; i++) {
        outs[i] = NULL;
        rcs[i] = -1;
    }

    pthread_t threads[64];
    if (n_threads > 64) n_threads = 64;
    int spawned = 0;
    for (int t = 0; t < n_threads; t++) {
        if (pthread_create(&threads[t], NULL, batch_worker, &ctx) != 0) break;
        spawned++;
    }
    if (spawned == 0) batch_worker(&ctx); /* fall back to inline */
    for (int t = 0; t < spawned; t++) pthread_join(threads[t], NULL);

    int failures = 0;
    for (int i = 0; i < n; i++)
        if (rcs[i] != 0) failures++;
    return failures;
}
