"""int8 upper-bound scan: the bound constructions, the plain XLA scan and
the scan entry points the engine calls.

Replaces the reference's per-chunk C# scoring loop
(src/OmniRecall.Api/Services/RecallSearchService.cs:28-37). One pass over
the index computes, per query b and row c, a SOUND UPPER BOUND of the
reference's hybrid score

    ub[b, c] = cos term + kw term + add_row[c] + q_bias[b] + CERT_EPS_INT8
    cos term = (q8[b] . emb8[c]) * qs[b] * scale_row[c]      (exact int32 dot)
    kw term  = 0.2 * min(1, (kw_w8[b] . bits(bloom[c])) / 127 + kw_b[b])

with one of three term sets: ``"cos_kw"`` (the full hybrid bound),
``"cos"`` (the coarse prepass: the keyword term is replaced by its
per-query cap, folded into q_bias — coarse_q_bias) and ``"kw"``
(keyword-only queries, whose cosine is exactly 0). Rows are cut into
slices of ``sub`` consecutive rows, and each slice emits its top-t rows
plus its (t+1)-th value, a bound on every unemitted row of the slice:

    vals f32[S, B, t+1], idxs i32[S, B, t+1]   (S = N / sub; idx -2 on the
                                                bound entry)

Ties inside a slice resolve to the lowest row. No [B, N] score matrix is
kept: ``merge_topm`` reduces the slices to the engine's top-m + boundary.

Two implementations satisfy that contract (ops/routes.py picks one per
platform): ``scan_xla`` below — blocked XLA, the CPU route and the
reference the GPU kernel is compared with — and the Pallas/Triton kernel
in ops/triton_scan.py.

Soundness (engine certificate, search/engine.py): the integer dots are
exact; quantization error is covered by the explicit eq/ec folding, built
ONLY by prepare_int8_query / coarse_q_bias / quantize_kw_weights (shared
with parallel/sharded.py); CERT_EPS_INT8 covers the f32 epilogue rounding
(~1e-6 relative, any evaluation order or FMA contraction).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from omni_recall_tpu.ops.merge import top_k_with_payload
from omni_recall_tpu.ops.oracle import (
    COSINE_WEIGHT,
    KEYWORD_WEIGHT,
    RECENCY_HALF_LIFE_DAYS,
    RECENCY_WEIGHT,
)

NEG_INF = -1e30  # finite mask value inside the scan; mapped to -inf by the merge

# The integer dots are exact and quantization error is folded explicitly,
# leaving only f32 epilogue arithmetic (~1e-6 relative): the margin is
# ample there and keeps coarse-certificate resolution tight.
CERT_EPS_INT8 = 4e-3

TERM_SETS = ("cos_kw", "cos", "kw")

# Slice width: the Triton kernel's row tile (ops/triton_scan.py). The XLA
# scan uses the same width so both routes emit the same candidates.
ROW_TILE = 128
MIN_ROW_TILE = 16  # the smallest tile a tensor-core dot takes

# Rows per lax.map step of the XLA scan: bounds the [B, rows] f32 score
# block that the step materializes (0.4 GB at B=1536).
XLA_BLOCK_ROWS = 1 << 16


def scan_slice(n_rows: int) -> int:
    """Slice width for an index of ``n_rows`` rows: the row tile, halved
    until it divides the row count; 0 when no usable width divides it."""
    sub = ROW_TILE
    while sub >= MIN_ROW_TILE:
        if n_rows % sub == 0:
            return sub
        sub //= 2
    return 0


def epilogue(cosd, kwd, qs, scale_row, kw_b, add_row, q_bias):
    """f32 upper bound of one [Bq, R] block from its integer dots. Shared
    by both scan implementations, so they evaluate the same expression.
    ``cosd``/``kwd`` are None when their term is off; ``qs`` is the query
    dequant scale pre-multiplied by COSINE_WEIGHT."""
    s = None
    if cosd is not None:
        s = cosd.astype(jnp.float32) * qs[:, None] * scale_row[None, :]
    if kwd is not None:
        kw = KEYWORD_WEIGHT * jnp.minimum(
            kwd.astype(jnp.float32) * (1.0 / 127.0) + kw_b[:, None], 1.0
        )
        s = kw if s is None else s + kw
    s = s + add_row[None, :]
    if q_bias is not None:
        s = s + q_bias[:, None]
    return s + CERT_EPS_INT8


def bloom_bits(words: jax.Array) -> jax.Array:
    """u8[R, W] -> i8[R, 8W] bits in the index's plane-major order
    (bit j = bit j // W of word j % W — ops/hashing.py)."""
    w = words.astype(jnp.int32)
    return jnp.concatenate([(w >> p) & 1 for p in range(8)], axis=-1).astype(
        jnp.int8
    )


def _int_dot(a, b):
    """[B, K] x [R, K] -> [B, R] exact int32 sums of int8 operands."""
    return jax.lax.dot_general(
        a, b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


@functools.partial(jax.jit, static_argnames=("terms", "sub", "t"))
def scan_xla(emb8, bloom, q8, kw_w8, kw_b, add_row, scale_row, qs, q_bias,
             *, terms: str, sub: int, t: int):
    """Blocked XLA scan: lax.map over row blocks of XLA_BLOCK_ROWS, each an
    int8 x int8 -> int32 dot_general, the shared epilogue, and lax.top_k
    (stable: the lowest row wins ties) per slice. Operands of a term that
    is off are None. Returns the module's [S, B, t+1] contract."""
    cos, kw = "cos" in terms, "kw" in terms
    n = add_row.shape[0]
    b = (q8 if cos else kw_w8).shape[0]
    if n % sub:
        raise ValueError(f"row count {n} is not a multiple of the slice {sub}")
    t1 = t + 1
    r = math.gcd(n, XLA_BLOCK_ROWS) if sub <= XLA_BLOCK_ROWS else n
    r = max(r, sub)
    nblk = n // r
    xs = {
        "add": add_row.reshape(nblk, r),
        "base": jnp.arange(nblk, dtype=jnp.int32) * r,
    }
    if cos:
        xs["emb"] = emb8.reshape(nblk, r, emb8.shape[1])
        xs["scale"] = scale_row.reshape(nblk, r)
    if kw:
        xs["bloom"] = bloom.reshape(nblk, r, bloom.shape[1])
    slice_base = jnp.arange(r // sub, dtype=jnp.int32)[None, :, None] * sub

    def block(x):
        cosd = _int_dot(q8, x["emb"]) if cos else None
        kwd = _int_dot(kw_w8, bloom_bits(x["bloom"])) if kw else None
        s = epilogue(cosd, kwd, qs, x.get("scale"), kw_b, x["add"], q_bias)
        v, i = jax.lax.top_k(s.reshape(b, r // sub, sub), t1)
        i = i + slice_base + x["base"]
        i = i.at[:, :, t].set(-2)  # bound entry: not a candidate
        return jnp.swapaxes(v, 0, 1), jnp.swapaxes(i, 0, 1)

    v, i = jax.lax.map(block, xs)  # [nblk, r/sub, B, t1]
    return v.reshape(n // sub, b, t1), i.reshape(n // sub, b, t1)


def merge_topm(vals: jax.Array, idxs: jax.Array, m: int):
    """[S, B, t+1] slices -> (ub_values[B, m+1], row_indices[B, m+1]):
    the top-m candidates, then the certificate boundary (index -1) =
    max((m+1)-th candidate, every slice bound)."""
    s, b, t1 = vals.shape
    t = t1 - 1
    if m > s * t:
        raise ValueError(f"m={m} exceeds emitted candidates slices*t={s * t}")
    cand_v = jnp.swapaxes(vals[:, :, :t], 0, 1).reshape(b, s * t)
    cand_i = jnp.swapaxes(idxs[:, :, :t], 0, 1).reshape(b, s * t)
    k = min(m + 1, s * t)
    top_v, top_i = top_k_with_payload(cand_v, cand_i, k)
    top_v = jnp.where(top_v <= NEG_INF / 2, -jnp.inf, top_v)
    boundary_emitted = top_v[:, m] if k > m else jnp.full((b,), -jnp.inf)
    bounds = vals[:, :, t]
    slice_max = jnp.max(jnp.where(bounds <= NEG_INF / 2, -jnp.inf, bounds), axis=0)
    boundary = jnp.maximum(boundary_emitted, slice_max)
    out_v = jnp.concatenate([top_v[:, :m], boundary[:, None]], axis=1)
    out_i = jnp.concatenate(
        [top_i[:, :m], jnp.full((b, 1), -1, dtype=jnp.int32)], axis=1
    )
    return out_v, out_i


def make_add_row(
    created: jax.Array, valid: jax.Array, now_days, window_start, row_offset=0,
    err_term: jax.Array | None = None,
) -> jax.Array:
    """Per-row additive term f32[N]: 0.1*recency (+ optional per-row
    quantization error bound) for live in-window rows, NEG_INF otherwise."""
    n = created.shape[0]
    rec = jnp.exp(jnp.minimum(created - now_days, 0.0) / RECENCY_HALF_LIFE_DAYS)
    live = RECENCY_WEIGHT * rec
    if err_term is not None:
        live = live + err_term
    rows = jnp.arange(n, dtype=jnp.int32) + row_offset
    mask = valid & (rows >= window_start)
    return jnp.where(mask, live, NEG_INF)


def quantize_queries_int8(q: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Per-query symmetric int8 quantization + sound error-norm bound
    (shared by the full and coarse scans). Returns (q8, q_scale [B, 1],
    eq [B, 1])."""
    q_absmax = jnp.max(jnp.abs(q), axis=1, keepdims=True)  # [B, 1]
    q_scale = q_absmax / 127.0
    safe = jnp.where(q_scale > 0, q_scale, 1.0)
    q8 = jnp.clip(jnp.round(q / safe), -127, 127).astype(jnp.int8)
    eq = jnp.linalg.norm(q - q8.astype(jnp.float32) * q_scale, axis=1, keepdims=True)
    eq = eq * (1.0 + 1e-6)
    return q8, q_scale, eq


def prepare_int8_query(q: jax.Array, err_row: jax.Array):
    """Quantize queries + fold the sound error terms. THE single source of
    the int8 certificate's error construction — the single-device scans
    and the sharded path (parallel/sharded.py) must all build their bounds
    here, or a future change leaves one path with an unsound bound.

    Returns (q8, q_scale, eq, err_term) with
    err_term = COSINE_WEIGHT * (1 + max(eq)) * err_row — covers
    |q.dc| + |dq.c_hat| for the quantization deltas (ops/quantize.py)."""
    q8, q_scale, eq = quantize_queries_int8(q)
    err_term = COSINE_WEIGHT * (1.0 + jnp.max(eq)) * err_row
    return q8, q_scale, eq, err_term


def coarse_q_bias(eq, kw_weights, kw_bias):
    """Per-query additive bias of the coarse scan: the cosine quantization
    error plus the keyword cap KEYWORD_WEIGHT*min(1, sum_w + bias). Note
    query_bit_weights distributes exactly 1/T mass per term, so sum_w (+
    stopword-fallback bias) is 1 for every query WITH terms — the cap is
    effectively a flat KEYWORD_WEIGHT for termful queries and 0 otherwise;
    coarse resolution therefore rides on cosine separation. Shared by the
    single-device and sharded coarse paths (soundness-critical)."""
    kw_cap = jnp.minimum(jnp.sum(kw_weights, axis=1) + kw_bias, 1.0)[:, None]
    return COSINE_WEIGHT * eq + KEYWORD_WEIGHT * kw_cap


def quantize_kw_weights(kw_weights: jax.Array) -> jax.Array:
    """Ceil-quantize keyword weights to int8 (w8/127 >= w: sound).
    Shared by the single-device and sharded full-fused int8 paths."""
    return jnp.clip(jnp.ceil(kw_weights * 127.0), 0, 127).astype(jnp.int8)


def scan_operands(terms, emb8, bloom, scale_row, err_row, created, valid, q,
              kw_weights, kw_bias, now_days, window_start, row_offset=0):
    """Scan operands of one term set, every bound term built by the shared
    constructions above: (emb8, bloom, q8, kw_w8, kw_b, add_row,
    scale_row, qs, q_bias), None where the term set does not read it."""
    if terms == "kw":
        add_row = make_add_row(created, valid, now_days, window_start,
                               row_offset=row_offset)
        return (None, bloom, None, quantize_kw_weights(kw_weights), kw_bias,
                add_row, None, None, None)
    q8, q_scale, eq, err_term = prepare_int8_query(q, err_row)
    add_row = make_add_row(created, valid, now_days, window_start,
                           row_offset=row_offset, err_term=err_term)
    qs = (COSINE_WEIGHT * q_scale)[:, 0]
    if terms == "cos":
        q_bias = coarse_q_bias(eq, kw_weights, kw_bias)[:, 0]
        return (emb8, None, q8, None, None, add_row, scale_row, qs, q_bias)
    q_bias = (COSINE_WEIGHT * eq)[:, 0]
    return (emb8, bloom, q8, quantize_kw_weights(kw_weights), kw_bias,
            add_row, scale_row, qs, q_bias)


@functools.partial(jax.jit, static_argnames=("terms", "m", "t", "sub", "scan"))
def score_topm(
    emb8: jax.Array | None,       # i8[N, d] (None for terms="kw")
    scale_row: jax.Array | None,  # f32[N] per-row dequant scale
    err_row: jax.Array | None,    # f32[N] per-row quantization error norm
    bloom: jax.Array | None,      # u8[N, W] (None for terms="cos")
    created: jax.Array,
    valid: jax.Array,
    q: jax.Array | None,          # f32[B, d] normalized query embeddings
    kw_weights: jax.Array,        # f32[B, bits]
    kw_bias: jax.Array,           # f32[B]
    now_days: jax.Array,
    window_start: jax.Array,
    *,
    terms: str,
    m: int,
    t: int,
    sub: int,
    scan=scan_xla,
) -> tuple[jax.Array, jax.Array]:
    """Scan entry: (ub_values[B, m+1], row_indices[B, m+1]), entry m the
    certificate boundary (index -1). ``scan`` is the implementation
    (ops/routes.py). Interface-compatible with ops/xla_scorer.score_topm.

    ``terms="cos"`` (coarse): keyword bounded by 0.2 * min(1, sum(weights)
    + bias) per query — a sound bound on the bloom keyword score, which
    itself bounds the reference's substring score; queries whose
    certificate fails escalate to the full scan. ``terms="kw"``: queries
    WITHOUT an embedding (their cosine is exactly 0, so no emb read and no
    quantization error term)."""
    ops = scan_operands(terms, emb8, bloom, scale_row, err_row, created, valid,
                    q, kw_weights, kw_bias, now_days, window_start)
    vals, idxs = scan(*ops, terms=terms, sub=sub, t=t)
    return merge_topm(vals, idxs, m)
