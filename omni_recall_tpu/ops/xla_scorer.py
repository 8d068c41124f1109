"""Pure-XLA batched upper-bound scorer + top-M candidate selection.

This is the jnp reference implementation of the device scoring pass over
f32 storage (the int8 slice scan is ops/scan.py). It computes, for every valid chunk row inside the candidate
window, a *sound upper bound* of the reference's hybrid score
(RecallSearchService.cs:59-67):

    ub = 0.7 * cos + 0.2 * min(1, bits @ w_kw + bias) + 0.1 * recency + eps

- cos is exact (f32 HIGHEST-precision matmul of L2-normalized vectors),
- the keyword term uses the bloom upper bound (ops/hashing.py),
- recency = exp(min(0, created - now) / 30) — exactly the reference's
  exp(-max(0, age_days)/30) (RecallSearchService.cs:115-119),
- eps absorbs device-vs-host float divergence so ub >= host-exact score.

Masked rows (invalid or outside the window) get -inf. Returns the top
(m+1) per query: the first m are the candidate set, the last value is the
certificate boundary (max upper bound over excluded rows).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from omni_recall_tpu.ops.merge import top_k_with_payload
from omni_recall_tpu.ops.oracle import (
    COSINE_WEIGHT,
    KEYWORD_WEIGHT,
    RECENCY_HALF_LIFE_DAYS,
    RECENCY_WEIGHT,
)

CERT_EPS = 1e-4  # certificate float-divergence margin (scores round to 4dp
#                  at the DTO edge, RecallSearchService.cs:51)

# top-k switches to a blocked two-stage reduction above this row count
_TOPK_BLOCK = 16384


def unpack_bloom_bits(bloom_u8: jax.Array) -> jax.Array:
    """u8[N, W] -> f32[N, W*8] bit expansion; bit pos j = plane (j div W) of
    word (j mod W), i.e. a lane-aligned concat of 8 shift-AND planes (same
    layout as ops/hashing.chunk_signature)."""
    words = bloom_u8.astype(jnp.int32)
    planes = [((words >> b) & 1) for b in range(8)]
    return jnp.concatenate(planes, axis=-1).astype(jnp.float32)


def _topk_rows(scores: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """top-k along the last axis of [B, N]; two-stage blocked reduction for
    large N (avoids a full sort over millions of lanes)."""
    b, n = scores.shape
    k = min(k, n)
    if n <= 2 * _TOPK_BLOCK or n % _TOPK_BLOCK != 0 or k > _TOPK_BLOCK:
        return jax.lax.top_k(scores, k)
    blocks = n // _TOPK_BLOCK
    blocked = scores.reshape(b, blocks, _TOPK_BLOCK)
    loc_v, loc_i = jax.lax.top_k(blocked, k)  # [B, blocks, k]
    base = (jnp.arange(blocks, dtype=jnp.int32) * _TOPK_BLOCK)[None, :, None]
    glob_i = loc_i + base
    flat_v = loc_v.reshape(b, blocks * k)
    flat_i = glob_i.reshape(b, blocks * k)
    return top_k_with_payload(flat_v, flat_i, k)


def ub_scores(
    emb: jax.Array,       # f32[n, d] L2-normalized (zero rows = no embedding)
    bloom: jax.Array,     # u8[n, W]
    created: jax.Array,   # f32[n] days since index epoch
    valid: jax.Array,     # bool[n]
    q: jax.Array,         # f32[B, d] normalized query embeddings (zero = none)
    kw_weights: jax.Array,  # f32[B, bits]
    kw_bias: jax.Array,     # f32[B]
    now_days: jax.Array,    # f32 scalar
    window_start: jax.Array,  # i32 scalar, first GLOBAL row inside the window
    row_offset: jax.Array | int = 0,  # global row id of local row 0 (sharding)
) -> jax.Array:
    """Masked upper-bound scores [B, n] (-inf outside window/invalid)."""
    n = emb.shape[0]

    cos = jax.lax.dot_general(
        q, emb,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [B, n]

    bits = unpack_bloom_bits(bloom)  # [n, bits]
    kw = jax.lax.dot_general(
        kw_weights, bits,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        # HIGHEST like the cosine dot above: a reduced-precision default
        # (bf16, or TF32 on a GPU) rounds the weights by ~1e-3, which
        # exceeds CERT_EPS=1e-4 and would make this "sound upper bound"
        # unsound
        precision=jax.lax.Precision.HIGHEST,
    )  # [B, n]
    kw = jnp.minimum(kw + kw_bias[:, None], 1.0)

    rec = jnp.exp(jnp.minimum(created - now_days, 0.0) / RECENCY_HALF_LIFE_DAYS)  # [n]

    ub = (
        COSINE_WEIGHT * cos
        + KEYWORD_WEIGHT * kw
        + RECENCY_WEIGHT * rec[None, :]
        + CERT_EPS
    )

    rows = jnp.arange(n, dtype=jnp.int32) + row_offset
    mask = valid & (rows >= window_start)
    return jnp.where(mask[None, :], ub, -jnp.inf)


@partial(jax.jit, static_argnames=("m",))
def score_topm(
    emb: jax.Array,
    bloom: jax.Array,
    created: jax.Array,
    valid: jax.Array,
    q: jax.Array,
    kw_weights: jax.Array,
    kw_bias: jax.Array,
    now_days: jax.Array,
    window_start: jax.Array,
    m: int,
) -> tuple[jax.Array, jax.Array]:
    """Returns (ub_values[B, m+1], row_indices[B, m+1]); entry m is the
    certificate boundary (max upper bound over excluded rows)."""
    ub = ub_scores(
        emb, bloom, created, valid, q, kw_weights, kw_bias, now_days, window_start
    )
    return _topk_rows(ub, min(m + 1, emb.shape[0]))
