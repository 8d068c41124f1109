/* Exact substring keyword rescorer — the host-side hot path of certified
 * search. For each candidate chunk, computes the fraction of query terms
 * byte-substring-contained in the (pre-lowercased, UTF-8) content — the
 * exact semantics of the reference's KeywordScore
 * (src/OmniRecall.Api/Services/RecallSearchService.cs:90-113; byte-level
 * match on valid UTF-8 equals character-level ordinal match because UTF-8
 * is self-synchronizing).
 *
 * Built as a plain shared library (no Python.h) and loaded via ctypes, so
 * the scan loop runs without the GIL from the caller's perspective.
 *
 * Build: cc -O3 -shared -fPIC -o libomni_keyword.so keyword_scorer.c
 */

#define _GNU_SOURCE
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

/* ABI version, checked by the ctypes loader (ops/native.py) before any
 * other call: bump on ANY exported-signature change. A stale .so whose
 * mtime beats the source would otherwise be called with mismatched
 * marshalling (e.g. a weight double landing where the old ABI expected the
 * out pointer -> segfault). */
#define OMNI_NATIVE_ABI 7
int omni_abi_version(void) { return OMNI_NATIVE_ABI; }

/* Two-way/memmem is glibc; provide a fallback for other libcs. */
static const char *find_sub(const char *hay, size_t hay_len,
                            const char *needle, size_t needle_len) {
#ifdef __GLIBC__
    return (const char *)memmem(hay, hay_len, needle, needle_len);
#else
    if (needle_len == 0 || needle_len > hay_len) {
        return needle_len == 0 ? hay : NULL;
    }
    const char first = needle[0];
    const char *end = hay + hay_len - needle_len;
    for (const char *p = hay; p <= end; p++) {
        if (*p == first && memcmp(p, needle, needle_len) == 0) {
            return p;
        }
    }
    return NULL;
#endif
}

/* contents: n_contents buffers (lowercased UTF-8), terms: n_terms buffers
 * (lowercased UTF-8, distinct). out[i] = matches_i / n_terms.
 * Returns 0 on success. */
int keyword_scores(const char **contents, const long *content_lens,
                   long n_contents, const char **terms, const long *term_lens,
                   long n_terms, double *out) {
    if (n_terms <= 0) {
        for (long i = 0; i < n_contents; i++) out[i] = 0.0;
        return 0;
    }
    for (long i = 0; i < n_contents; i++) {
        const char *content = contents[i];
        long content_len = content_lens[i];
        long matches = 0;
        if (content_len > 0) {
            for (long t = 0; t < n_terms; t++) {
                if (term_lens[t] > 0 &&
                    find_sub(content, (size_t)content_len, terms[t],
                             (size_t)term_lens[t]) != NULL) {
                    matches++;
                }
            }
        }
        out[i] = (double)matches / (double)n_terms;
    }
    return 0;
}

/* ---- bloom signature construction (ingest hot path) ----
 *
 * Mirrors ops/hashing.py exactly: FNV-1a 64-bit over UTF-8 gram bytes with
 * seeds 1/2 (h ^= seed*GOLDEN at init), double hashing for n_hashes probe
 * positions, gram lengths {1, 2, ngram} skipping whitespace-containing
 * grams, packed layout word = pos % W, bit = pos / W. Byte-level gram
 * extraction over UTF-8 is identical to the Python character-level
 * extraction for ASCII content; multi-byte graphemes hash differently, so
 * the Python path remains the reference for non-ASCII content (the loader
 * routes non-ASCII contents to Python).
 */

#include <stdint.h>
#include <pthread.h>

static uint64_t fnv1a_seeded(const unsigned char *data, long len, uint64_t seed) {
    uint64_t h = 0xCBF29CE484222325ULL ^ (seed * 0x9E3779B97F4A7C15ULL);
    for (long i = 0; i < len; i++) {
        h ^= data[i];
        h *= 0x100000001B3ULL;
    }
    return h;
}

static int is_space(unsigned char c) {
    /* ASCII whitespace (str.isspace for ASCII) */
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' || c == '\v'
        || c == 0x1c || c == 0x1d || c == 0x1e || c == 0x1f || c == 0x0b;
}

static void set_gram(const unsigned char *gram, long glen, long bloom_bits,
                     long n_hashes, long w_bytes, unsigned char *out) {
    uint64_t h1 = fnv1a_seeded(gram, glen, 1);
    uint64_t h2 = fnv1a_seeded(gram, glen, 2) | 1ULL;
    for (long i = 0; i < n_hashes; i++) {
        uint64_t pos = (h1 + (uint64_t)i * h2) % (uint64_t)bloom_bits;
        out[pos % (uint64_t)w_bytes] |= (unsigned char)(1u << (pos / (uint64_t)w_bytes));
    }
}

/* Build packed bloom signatures for n_contents lowercased ASCII contents.
 * out is n_contents * (bloom_bits/8) bytes, zeroed by the caller. */
typedef struct {
    const char **contents;
    const long *content_lens;
    long lo, hi, bloom_bits, ngram, n_hashes;
    unsigned char *out;
} sig_job;

static void sig_range(const char **contents, const long *content_lens,
                      long lo, long hi, long bloom_bits, long ngram,
                      long n_hashes, unsigned char *out) {
    long w_bytes = bloom_bits / 8;
    long lens[3] = {1, 2, ngram};
    for (long i = lo; i < hi; i++) {
        const unsigned char *s = (const unsigned char *)contents[i];
        long slen = content_lens[i];
        unsigned char *row = out + i * w_bytes;
        for (int li = 0; li < 3; li++) {
            long gl = lens[li];
            /* dedupe lengths KEEPING the first occurrence (matches
             * hashing.py dict.fromkeys((1, 2, ngram))): for ngram<=2 the
             * li==2 entry duplicates an earlier length and is skipped; the
             * li==1 (length-2) pass always runs so ngram=2 signatures
             * keep their 2-gram bits (soundness) */
            if (li == 2 && (ngram == 1 || ngram == 2)) continue;
            for (long p = 0; p + gl <= slen; p++) {
                int ws = 0;
                for (long j = 0; j < gl; j++) {
                    if (is_space(s[p + j])) { ws = 1; break; }
                }
                if (!ws) set_gram(s + p, gl, bloom_bits, n_hashes, w_bytes, row);
            }
        }
    }
}

static void *sig_worker(void *argp) {
    sig_job *j = (sig_job *)argp;
    sig_range(j->contents, j->content_lens, j->lo, j->hi, j->bloom_bits,
              j->ngram, j->n_hashes, j->out);
    return NULL;
}

/* Threaded over contents (each row independent); thread count mirrors the
 * rescorer's policy (>= 4: quota'd hosts under-report cores). */
int chunk_signatures(const char **contents, const long *content_lens,
                     long n_contents, long bloom_bits, long ngram,
                     long n_hashes, unsigned char *out) {
    long n_threads = 4;
    if (n_contents < 1024) n_threads = 1;
    if (n_threads == 1) {
        sig_range(contents, content_lens, 0, n_contents, bloom_bits, ngram,
                  n_hashes, out);
        return 0;
    }
    sig_job jobs[16];
    pthread_t tids[16];
    int created[16] = {0};
    long per = (n_contents + n_threads - 1) / n_threads;
    for (long w = 0; w < n_threads; w++) {
        long lo = w * per;
        long hi = lo + per < n_contents ? lo + per : n_contents;
        if (lo >= hi) break;
        jobs[w] = (sig_job){contents, content_lens, lo, hi, bloom_bits,
                            ngram, n_hashes, out};
        if (pthread_create(&tids[w], NULL, sig_worker, &jobs[w]) != 0) {
            /* thread spawn failed: do this range inline */
            sig_range(contents, content_lens, lo, hi, bloom_bits, ngram,
                      n_hashes, out);
        } else {
            created[w] = 1;
        }
    }
    for (long w = 0; w < n_threads; w++)
        if (created[w]) pthread_join(tids[w], NULL);
    return 0;
}

/* Multi-query batch: content i is scored against the term slice of query
 * content_query[i]; query q's terms are terms[term_offsets[q] ..
 * term_offsets[q+1]). One call rescore for a whole search batch. */
int keyword_scores_multi(const char **contents, const long *content_lens,
                         const long *content_query, long n_contents,
                         const char **terms, const long *term_lens,
                         const long *term_offsets, long n_queries,
                         double *out) {
    for (long i = 0; i < n_contents; i++) {
        long q = content_query[i];
        if (q < 0 || q >= n_queries) {
            return 1;
        }
        long t_lo = term_offsets[q];
        long t_hi = term_offsets[q + 1];
        long n_terms = t_hi - t_lo;
        if (n_terms <= 0) {
            out[i] = 0.0;
            continue;
        }
        const char *content = contents[i];
        long content_len = content_lens[i];
        long matches = 0;
        if (content_len > 0) {
            for (long t = t_lo; t < t_hi; t++) {
                if (term_lens[t] > 0 &&
                    find_sub(content, (size_t)content_len, terms[t],
                             (size_t)term_lens[t]) != NULL) {
                    matches++;
                }
            }
        }
        out[i] = (double)matches / (double)n_terms;
    }
    return 0;
}

/* ---- full hybrid rescore (certified-exact path hot loop) ----
 *
 * One call scores every (query, candidate-row) pair of a search batch:
 *   out[i] = w_cos * cosine(q_emb[owner[i]], raw_emb[rows[i]])
 *          + w_kw * keyword(terms of owner[i], arena content of rows[i])
 * (the caller adds the 0.1 * recency term — kept in numpy so its exp()
 * matches the numpy oracle bit-for-bit).
 *
 * The cosine dot replicates numpy's pairwise summation (PW_BLOCKSIZE=128,
 * 8-wide partials) over float32 products accumulated in float64, so scores
 * are bit-identical to the numpy reference path (ops/oracle.py /
 * engine._exact_hits_multi). The loader verifies this equivalence on random
 * probes at startup and disables the native path if numpy's algorithm ever
 * changes. MUST be compiled with -ffp-contract=off: FMA contraction of
 * (double)(a*b) would change results.
 */

#include <math.h>

static double pairwise_prod_f64_scalar(const float *a, const float *b, long n) {
    if (n < 8) {
        double res = 0.0;
        for (long i = 0; i < n; i++) res += (double)(a[i] * b[i]);
        return res;
    }
    if (n <= 128) {
        double r[8];
        for (int j = 0; j < 8; j++) r[j] = (double)(a[j] * b[j]);
        long i;
        for (i = 8; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; j++) r[j] += (double)(a[i + j] * b[i + j]);
        double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                     ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; i++) res += (double)(a[i] * b[i]);
        return res;
    }
    long n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_prod_f64_scalar(a, b, n2) +
           pairwise_prod_f64_scalar(a + n2, b + n2, n - n2);
}

/* AVX2 replica of the numpy pairwise order, selected at runtime. The 8
 * independent accumulators r[0..7] live in two 4-lane f64 vectors; each
 * lane sees EXACTLY the scalar loop's add sequence (vmulps rounds the f32
 * product once, vcvtps2pd widens exactly, vaddpd accumulates lane-wise),
 * and the final combine is the same scalar tree — so results are
 * bit-identical to the scalar path AND to numpy (enforced by the loader's
 * startup probe AND asserted scalar-vs-avx2 on every build, see
 * pairwise_dot_selftest). Intrinsics are target-gated so the file still
 * builds with baseline -O3 and runs on CPUs without AVX2. */
#if defined(__x86_64__) && (defined(__GNUC__) || defined(__clang__))
#define OMNI_DOT_AVX2 1
#include <immintrin.h>

__attribute__((target("avx2")))
static double pairwise_prod_f64_avx2(const float *a, const float *b, long n) {
    if (n < 8) {
        double res = 0.0;
        for (long i = 0; i < n; i++) res += (double)(a[i] * b[i]);
        return res;
    }
    if (n <= 128) {
        __m256d r03 = _mm256_cvtps_pd(
            _mm_mul_ps(_mm_loadu_ps(a), _mm_loadu_ps(b)));
        __m256d r47 = _mm256_cvtps_pd(
            _mm_mul_ps(_mm_loadu_ps(a + 4), _mm_loadu_ps(b + 4)));
        long i;
        for (i = 8; i < n - (n % 8); i += 8) {
            r03 = _mm256_add_pd(r03, _mm256_cvtps_pd(
                _mm_mul_ps(_mm_loadu_ps(a + i), _mm_loadu_ps(b + i))));
            r47 = _mm256_add_pd(r47, _mm256_cvtps_pd(
                _mm_mul_ps(_mm_loadu_ps(a + i + 4), _mm_loadu_ps(b + i + 4))));
        }
        double r[8];
        _mm256_storeu_pd(r, r03);
        _mm256_storeu_pd(r + 4, r47);
        double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                     ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; i++) res += (double)(a[i] * b[i]);
        return res;
    }
    long n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_prod_f64_avx2(a, b, n2) +
           pairwise_prod_f64_avx2(a + n2, b + n2, n - n2);
}
#endif

typedef double (*omni_dot_fn)(const float *, const float *, long);
static omni_dot_fn omni_dot = pairwise_prod_f64_scalar;

__attribute__((constructor))
static void omni_dot_init(void) {
#ifdef OMNI_DOT_AVX2
    if (__builtin_cpu_supports("avx2")) omni_dot = pairwise_prod_f64_avx2;
#endif
}

static double pairwise_prod_f64(const float *a, const float *b, long n) {
    return omni_dot(a, b, n);
}

/* scalar-vs-selected equivalence probe, called by the loader alongside its
 * numpy probe: returns 1 if the selected implementation is bit-identical
 * to the scalar replica on the given operands. */
int pairwise_dot_selftest(const float *a, const float *b, long n) {
    double s = pairwise_prod_f64_scalar(a, b, n);
    double v = omni_dot(a, b, n);
    return memcmp(&s, &v, sizeof(double)) == 0;
}

/* exposed for the loader's numpy-equivalence self-check */
int pairwise_dot_f64(const float *a, const float *b, long n, double *out) {
    *out = pairwise_prod_f64(a, b, n);
    return 0;
}

typedef struct {
    const float *raw_emb;
    const double *norm_sq;
    long dim;
    const char *arena;
    const long long *arena_off;
    const long long *rows;
    const long long *owner;
    long total;
    double w_cos;
    double w_kw;
    const float *q_emb;
    const double *q_norm;
    const char *terms_flat;
    const long long *term_off;
    const long long *query_term_off;
    double *out;
    long lo, hi;
    /* int8-backed embedding column (compact host store,
     * index/compact.py): when emb8 != NULL the worker dequantizes each
     * candidate row into deq (per-worker scratch) as
     * fl32((float)e8[k] * scale[row]) — bit-identical to the numpy
     * materialization emb8[rows].astype(f32) * scale[rows, None] under
     * -ffp-contract=off — and runs the same pairwise dot on it. */
    const signed char *emb8;
    const float *scale;
    float *deq;
} rescore_job;

static void *rescore_worker(void *argp) {
    rescore_job *j = (rescore_job *)argp;
    /* keyword-only mode (raw_emb == NULL): the device-exact cosine stage
     * (ops/exact_cos.py) already streamed the embeddings on the device, so
     * this call scores ONLY w_kw * keyword — no embedding/norm reads at
     * all, cutting host bytes/pair from ~dim*4 to the content bytes. */
    int with_cos = j->raw_emb != NULL || j->emb8 != NULL;
    int is_int8 = j->emb8 != NULL;
    for (long i = j->lo; i < j->hi; i++) {
        if (i + 1 < j->hi) {
            /* candidate rows are scattered through a matrix far larger than
             * LLC: prefetch the NEXT pair's embedding row (dim*4 bytes) and
             * content bytes so their DRAM latency overlaps this pair's
             * compute — measured ~2.3x on the dot throughput at d=768 */
            long long nrow = j->rows[i + 1];
            if (is_int8) {
                const char *pe = (const char *)(j->emb8 + (size_t)nrow * j->dim);
                for (long o = 0; o < j->dim; o += 256) __builtin_prefetch(pe + o, 0, 0);
                __builtin_prefetch((const char *)(j->norm_sq + nrow), 0, 0);
            } else if (with_cos) {
                const char *pe = (const char *)(j->raw_emb + (size_t)nrow * j->dim);
                long pb = j->dim * (long)sizeof(float);
                for (long o = 0; o < pb; o += 256) __builtin_prefetch(pe + o, 0, 0);
                __builtin_prefetch((const char *)(j->norm_sq + nrow), 0, 0);
            }
            __builtin_prefetch(j->arena + j->arena_off[nrow], 0, 0);
        }
        long long row = j->rows[i];
        long q = (long)j->owner[i];
        double cos = 0.0;
        if (with_cos) {
            double qn = j->q_norm[q];
            double ns = j->norm_sq[row];
            if (qn > 0.0 && ns > 0.0) {
                const float *rowp;
                if (is_int8) {
                    const signed char *e = j->emb8 + (size_t)row * j->dim;
                    float s = j->scale[row];
                    for (long k = 0; k < j->dim; k++)
                        j->deq[k] = (float)e[k] * s;
                    rowp = j->deq;
                } else {
                    rowp = j->raw_emb + (size_t)row * j->dim;
                }
                double dot = pairwise_prod_f64(j->q_emb + (size_t)q * j->dim,
                                               rowp, j->dim);
                cos = dot / (sqrt(qn) * sqrt(ns));
            }
        }
        double kw = 0.0;
        long long t_lo = j->query_term_off[q], t_hi = j->query_term_off[q + 1];
        long n_terms = (long)(t_hi - t_lo);
        if (n_terms > 0) {
            const char *content = j->arena + j->arena_off[row];
            long clen = (long)(j->arena_off[row + 1] - j->arena_off[row]);
            long matches = 0;
            if (clen > 0) {
                for (long long t = t_lo; t < t_hi; t++) {
                    const char *term = j->terms_flat + j->term_off[t];
                    long tlen = (long)(j->term_off[t + 1] - j->term_off[t]);
                    if (tlen > 0 &&
                        find_sub(content, (size_t)clen, term, (size_t)tlen))
                        matches++;
                }
            }
            kw = (double)matches / (double)n_terms;
        }
        j->out[i] = j->w_cos * cos + j->w_kw * kw;
    }
    return NULL;
}

/* w_cos/w_kw arrive from the caller (ops/oracle.py COSINE_WEIGHT /
 * KEYWORD_WEIGHT) so the fusion weights have ONE source of truth — a C
 * literal here silently diverged from a retuned oracle constant. owner is
 * int64 to match the numpy marshalling on every platform (c_long is 32-bit
 * on Windows). */
int hybrid_rescore(const float *raw_emb, const double *norm_sq, long dim,
                   const char *arena, const long long *arena_off,
                   const long long *rows, const long long *owner, long total,
                   const float *q_emb, const double *q_norm, long nq,
                   const char *terms_flat, const long long *term_off,
                   const long long *query_term_off, long n_threads,
                   double w_cos, double w_kw,
                   double *out) {
    (void)nq;
    if (total <= 0) return 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    if (total < 256) n_threads = 1;
    rescore_job jobs[16];
    pthread_t tids[16];
    long per = (total + n_threads - 1) / n_threads;
    long started = 0;
    for (long w = 0; w < n_threads; w++) {
        long lo = w * per;
        long hi = lo + per < total ? lo + per : total;
        if (lo >= hi) break;
        jobs[w] = (rescore_job){raw_emb, norm_sq, dim, arena, arena_off,
                                rows, owner, total, w_cos, w_kw,
                                q_emb, q_norm,
                                terms_flat, term_off, query_term_off,
                                out, lo, hi};
        if (w == n_threads - 1 || hi == total) {
            rescore_worker(&jobs[w]);  /* run the last slice inline */
            started = w;
            break;
        }
        if (pthread_create(&tids[w], NULL, rescore_worker, &jobs[w]) != 0) {
            /* thread spawn failed: run remaining slice inline */
            jobs[w].hi = total;
            rescore_worker(&jobs[w]);
            started = w;
            break;
        }
        started = w + 1;
    }
    for (long w = 0; w < started; w++) pthread_join(tids[w], NULL);
    return 0;
}

/* int8-backed variant for the compact host store (index/compact.py): the
 * embedding column is the int8 plane + per-row f32 scale; each worker
 * dequantizes candidate rows into its own scratch buffer and reuses the
 * exact pairwise dot, so scores stay bit-identical to the numpy
 * materialized path (engine._exact_rescore_rows compact branch). */
int hybrid_rescore_int8(const signed char *emb8, const float *scale,
                        const double *norm_sq, long dim,
                        const char *arena, const long long *arena_off,
                        const long long *rows, const long long *owner,
                        long total,
                        const float *q_emb, const double *q_norm, long nq,
                        const char *terms_flat, const long long *term_off,
                        const long long *query_term_off, long n_threads,
                        double w_cos, double w_kw,
                        double *out) {
    (void)nq;
    if (total <= 0) return 0;
    if (dim <= 0 || emb8 == NULL || scale == NULL) return 1;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    if (total < 256) n_threads = 1;
    float *scratch = (float *)malloc((size_t)n_threads * dim * sizeof(float));
    if (scratch == NULL) return 1;
    rescore_job jobs[16];
    pthread_t tids[16];
    long per = (total + n_threads - 1) / n_threads;
    long started = 0;
    for (long w = 0; w < n_threads; w++) {
        long lo = w * per;
        long hi = lo + per < total ? lo + per : total;
        if (lo >= hi) break;
        jobs[w] = (rescore_job){NULL, norm_sq, dim, arena, arena_off,
                                rows, owner, total, w_cos, w_kw,
                                q_emb, q_norm,
                                terms_flat, term_off, query_term_off,
                                out, lo, hi,
                                emb8, scale, scratch + (size_t)w * dim};
        if (w == n_threads - 1 || hi == total) {
            rescore_worker(&jobs[w]);  /* run the last slice inline */
            started = w;
            break;
        }
        if (pthread_create(&tids[w], NULL, rescore_worker, &jobs[w]) != 0) {
            jobs[w].hi = total;
            rescore_worker(&jobs[w]);
            started = w;
            break;
        }
        started = w + 1;
    }
    for (long w = 0; w < started; w++) pthread_join(tids[w], NULL);
    free(scratch);
    return 0;
}

/* Batched query bit-weight builder (mirrors ops/hashing.py
 * query_bit_weights bit-for-bit for ASCII terms — the caller routes
 * non-ASCII terms to the Python builder):
 *   - term_grams: lengths {1, 2, ngram}; >16 grams sampled via numpy
 *     linspace(0, G-1, 16).astype(int) semantics (endpoint forced),
 *   - per-term position set = union of double-hash probes over grams,
 *   - weight inv_t / n_positions accumulated into f32 exactly like
 *     numpy's f32 += f64 (upcast, add, round once per add),
 *   - a term with no probe positions adds inv_t to the bias.
 * weights is [n_queries * bloom_bits] f32, bias [n_queries] f64 — both
 * zeroed by the caller. */
int query_bit_weights_batch(const char **terms, const long *term_lens,
                            const long *query_term_off, long n_queries,
                            long bloom_bits, long ngram, long n_hashes,
                            float *weights, double *bias) {
    if (bloom_bits <= 0 || n_hashes <= 0) return 1;
    /* position set buffer: <= 16 grams * n_hashes probes per term. The
     * common configs (n_hashes <= 8) use the stack; larger probe counts
     * heap-allocate so EVERY probe runs — silently capping would break the
     * bit-identical contract with ops/hashing.py query_bit_weights. */
    uint64_t pos_stack[16 * 8];
    uint64_t *pos_set = pos_stack;
    uint64_t *pos_heap = NULL;
    if (n_hashes > 8) {
        pos_heap = (uint64_t *)malloc(16 * (size_t)n_hashes * sizeof(uint64_t));
        if (!pos_heap) return 1; /* caller falls back to the Python builder */
        pos_set = pos_heap;
    }
    for (long q = 0; q < n_queries; q++) {
        long t0 = query_term_off[q], t1 = query_term_off[q + 1];
        long n_terms = t1 - t0;
        if (n_terms <= 0) continue;
        double inv_t = 1.0 / (double)n_terms;
        float *wrow = weights + q * bloom_bits;
        for (long t = t0; t < t1; t++) {
            const unsigned char *s = (const unsigned char *)terms[t];
            long L = term_lens[t];
            long glen, g_count;
            if (L <= 0) { bias[q] += inv_t; continue; }
            if (L == 1) { glen = 1; g_count = 1; }
            else if (L < ngram) { glen = 2; g_count = L - 1; }
            else { glen = ngram; g_count = L - glen + 1; }
            /* gram start offsets, linspace-sampled when > 16 */
            long starts[16];
            long n_sel;
            if (g_count > 16) {
                double step = (double)(g_count - 1) / 15.0;
                for (long i = 0; i < 16; i++)
                    starts[i] = (i == 15) ? (g_count - 1)
                                          : (long)((double)i * step);
                n_sel = 16;
            } else {
                n_sel = g_count;
                for (long i = 0; i < n_sel; i++) starts[i] = i;
            }
            long n_pos = 0;
            for (long g = 0; g < n_sel; g++) {
                uint64_t h1 = fnv1a_seeded(s + starts[g], glen, 1);
                uint64_t h2 = fnv1a_seeded(s + starts[g], glen, 2) | 1ULL;
                for (long i = 0; i < n_hashes; i++) {
                    uint64_t pos = (h1 + (uint64_t)i * h2) % (uint64_t)bloom_bits;
                    int dup = 0;
                    for (long j = 0; j < n_pos; j++)
                        if (pos_set[j] == pos) { dup = 1; break; }
                    if (!dup) pos_set[n_pos++] = pos;
                }
            }
            if (n_pos == 0) { bias[q] += inv_t; continue; }
            /* numpy's arr[pos] += w casts w to f32 FIRST, then adds in
             * f32 (verified bit-for-bit in tests/test_native.py) */
            float w = (float)(inv_t / (double)n_pos);
            for (long j = 0; j < n_pos; j++) {
                long p = (long)pos_set[j];
                wrow[p] = wrow[p] + w;
            }
        }
    }
    free(pos_heap);
    return 0;
}

/* Sparse variant of query_bit_weights_batch: emits, per query, the dense
 * row's nonzero cells as (bit index, f32 value) pairs in first-touch order —
 * the serving path scatters them back to dense ON DEVICE
 * (search/engine.py _densify_kw), skipping the [n_queries * bloom_bits]
 * host materialization entirely (~6 MB/serving batch of fresh pages + a
 * full nonzero scan, the dispatch phase's dominant host cost).
 *
 * Value bits are identical to the dense builder's cells: the f32
 * accumulation (acc[p] = acc[p] + w) runs in the exact same term/position
 * order as the dense wrow[p] += w.
 *
 * idx_out i32[n_queries * t_pad] (caller-filled with -1) and
 * val_out f32[n_queries * t_pad] (caller-zeroed) receive the pairs;
 * count_out[q] reports the query's TRUE nonzero count — when it exceeds
 * t_pad the row is left empty and the caller retries with a wider pad (or
 * falls back to the dense builder). Bias semantics match the dense
 * builder. */
int query_bit_weights_sparse_batch(const char **terms, const long *term_lens,
                                   const long *query_term_off, long n_queries,
                                   long bloom_bits, long ngram, long n_hashes,
                                   long t_pad,
                                   int32_t *idx_out, float *val_out,
                                   long *count_out, double *bias) {
    if (bloom_bits <= 0 || n_hashes <= 0 || t_pad <= 0) return 1;
    uint64_t pos_stack[16 * 8];
    uint64_t *pos_set = pos_stack;
    uint64_t *pos_heap = NULL;
    if (n_hashes > 8) {
        pos_heap = (uint64_t *)malloc(16 * (size_t)n_hashes * sizeof(uint64_t));
        if (!pos_heap) return 1;
        pos_set = pos_heap;
    }
    /* epoch-stamped accumulator: no per-query memset of a [bloom_bits]
     * buffer (stamp[p] == q+1 marks p as touched by query q) */
    float *acc = (float *)malloc((size_t)bloom_bits * sizeof(float));
    long *stamp = (long *)calloc((size_t)bloom_bits, sizeof(long));
    long *touched = (long *)malloc((size_t)bloom_bits * sizeof(long));
    if (!acc || !stamp || !touched) {
        free(pos_heap); free(acc); free(stamp); free(touched);
        return 1;
    }
    int rc = 0;
    for (long q = 0; q < n_queries; q++) {
        long t0 = query_term_off[q], t1 = query_term_off[q + 1];
        long n_terms = t1 - t0;
        count_out[q] = 0;
        if (n_terms <= 0) continue;
        double inv_t = 1.0 / (double)n_terms;
        long n_touched = 0;
        for (long t = t0; t < t1; t++) {
            const unsigned char *s = (const unsigned char *)terms[t];
            long L = term_lens[t];
            long glen, g_count;
            if (L <= 0) { bias[q] += inv_t; continue; }
            if (L == 1) { glen = 1; g_count = 1; }
            else if (L < ngram) { glen = 2; g_count = L - 1; }
            else { glen = ngram; g_count = L - glen + 1; }
            long starts[16];
            long n_sel;
            if (g_count > 16) {
                double step = (double)(g_count - 1) / 15.0;
                for (long i = 0; i < 16; i++)
                    starts[i] = (i == 15) ? (g_count - 1)
                                          : (long)((double)i * step);
                n_sel = 16;
            } else {
                n_sel = g_count;
                for (long i = 0; i < n_sel; i++) starts[i] = i;
            }
            long n_pos = 0;
            for (long g = 0; g < n_sel; g++) {
                uint64_t h1 = fnv1a_seeded(s + starts[g], glen, 1);
                uint64_t h2 = fnv1a_seeded(s + starts[g], glen, 2) | 1ULL;
                for (long i = 0; i < n_hashes; i++) {
                    uint64_t pos = (h1 + (uint64_t)i * h2) % (uint64_t)bloom_bits;
                    int dup = 0;
                    for (long j = 0; j < n_pos; j++)
                        if (pos_set[j] == pos) { dup = 1; break; }
                    if (!dup) pos_set[n_pos++] = pos;
                }
            }
            if (n_pos == 0) { bias[q] += inv_t; continue; }
            float w = (float)(inv_t / (double)n_pos);
            for (long j = 0; j < n_pos; j++) {
                long p = (long)pos_set[j];
                if (stamp[p] != q + 1) {
                    stamp[p] = q + 1;
                    acc[p] = 0.0f;
                    touched[n_touched++] = p;
                }
                acc[p] = acc[p] + w; /* same f32 order as the dense builder */
            }
        }
        count_out[q] = n_touched;
        if (n_touched <= t_pad) {
            int32_t *irow = idx_out + q * t_pad;
            float *vrow = val_out + q * t_pad;
            for (long j = 0; j < n_touched; j++) {
                irow[j] = (int32_t)touched[j];
                vrow[j] = acc[touched[j]];
            }
        }
        /* n_touched > t_pad: row left at (-1, 0); caller retries wider */
    }
    free(pos_heap);
    free(acc);
    free(stamp);
    free(touched);
    return rc;
}
