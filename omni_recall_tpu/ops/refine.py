"""Device-assisted exact rescore: tight sound bounds for scan candidates.

The certified-exact path (search/engine.py) is structurally host-bound: the
int8 scan's upper bounds are ~4e-3 loose (quantization error + cert eps),
so the host float64 rescore must score ~33 candidates per query before the
two-phase prune can cut the tail. This stage re-scores the top-m candidate
ROWS on device with bounds ~50x tighter, shrinking the host's exact work to
roughly the requested top-k:

- **cosine** — two-plane residual int8 (ops/quantize.py
  quantize_rows_int8_residual): c ~= c1*s1 + c2*s2 and q ~= q1*t1 + q2*t2,
  so q.c is reconstructed from FOUR exact integer dot products
  (|dot| <= d*127^2 = 1.2e7 << 2^31: int32 accumulation never overflows).
  The only approximation is the residual after two planes:

      q.c = (q_hat + rq).(c_hat + rc)       q_hat = q1*t1 + q2*t2, |rq| <= eq2
          = q_hat.c_hat + rq.c_hat + q.rc   c_hat = c1*s1 + c2*s2, |rc| <= ec2
      |q.c - q_hat.c_hat| <= eq2*(1 + ec2) + |q|*ec2

  with eq2, ec2 ~ 3e-5 at d=768 (vs 8e-3 for one plane). The f32 evaluation
  of t_i*s_j*dot_ij and the 3 adds rounds at ~1e-6 relative on O(1) values
  (covered by REFINE_EPS below).
- **keyword** — the same bloom upper-bound dot as the scan
  (ceil-quantized weights: w8/127 >= w, min(.,1) cap): tight up to bloom
  false positives, exactly as sound as the scan's own keyword term.
- **recency** — f32 exp over f32 created-days. The engine's exact recency
  uses integer microseconds; f32 day rounding shifts the age by <= ~9e-5
  days => <= 3e-6 on exp(-age/30) (derivative <= 1/30), covered by
  REFINE_EPS.

REFINE_EPS also covers the gap between the device operands and the host
oracle's float64 math: the stored normalized embedding is
f32(raw / ||raw||_f64) (per-element rounding: vector error <= 6e-8) and the
oracle's f64-accumulated dot of f32 products is within ~3e-7 of the real
q_unit.c_unit — in total well under 1e-5.

The refined value is a SOUND upper bound on the true hybrid score:

    refined_ub = 0.7*(q_hat.c_hat + delta) + 0.2*kw_ub + 0.1*rec
               + REFINE_EPS,     delta = eq2*(1+ec2) + ||q||*ec2

and typically within 1e-4 + 0.2*(kw_ub - kw_true) of it. The engine feeds
these bounds (min'ed with the scan bounds) to the two-phase host rescore,
whose prune then keeps only ~k candidates (search/engine.py). The
certificate semantics are unchanged — the scan boundary still bounds all
EXCLUDED rows; refine only tightens bounds on included candidates.

Reference anchor: this accelerates the exact ranked-citation contract of
RecallSearchService.cs:28-37; no reference counterpart (the reference
scores every chunk on the host).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from omni_recall_tpu.ops.oracle import (
    COSINE_WEIGHT,
    KEYWORD_WEIGHT,
    RECENCY_HALF_LIFE_DAYS,
    RECENCY_WEIGHT,
)

# f32 combine rounding (~1e-6) + normalized-vs-oracle cosine gap (~3e-7)
# + f32 recency-day rounding (~3e-6 on the weighted term) + exp ulp,
# with ~5x headroom. Tightening it below 1e-5 buys nothing: the residual
# quantization terms (~6e-5) dominate the refined bound.
REFINE_EPS = 3e-5


def _refine_dispatch(
    emb1, scale1, emb2, scale2, err2, bloom, created, valid,
    q, kw_w8, kw_bias, now_days, rows, vals,
):
    """The platform's refine implementation (ops/routes.py)."""
    from omni_recall_tpu.ops import routes

    return routes.current().refine(
        emb1, scale1, emb2, scale2, err2, bloom, created, valid,
        q, kw_w8, kw_bias, now_days, rows, vals,
    )


@jax.jit
def refine_ub_from_scan(
    emb1, scale1, emb2, scale2, err2, bloom, created, valid,
    q, kw_weights, kw_bias, now_days, vals_full, idxs_full,
):
    """Engine entry: takes the scan/merge output [B, m+1] directly (entry m
    is the certificate boundary, not a candidate) plus the f32 keyword
    weights, and returns refined bounds [B, m]. Chained after the scan in
    the same dispatch stream — the engine reads all three arrays back in
    one sync."""
    from omni_recall_tpu.ops.scan import quantize_kw_weights

    kw_w8 = quantize_kw_weights(kw_weights)
    return _refine_dispatch(
        emb1, scale1, emb2, scale2, err2, bloom, created, valid,
        q, kw_w8, kw_bias, now_days,
        idxs_full[:, :-1], vals_full[:, :-1],
    )


@functools.partial(jax.jit, static_argnames=("t_out", "r"))
def refine_select_from_scan(
    emb1, scale1, emb2, scale2, err2, bloom, created, valid,
    q, kw_weights, kw_bias, now_days, vals_full, idxs_full,
    t_out: int = 32,
    r: int | None = None,
):
    """Refine + device-side candidate selection in one dispatch.

    Computes the refined bounds for the top-``r`` scan candidates (by scan
    bound; the scan/merge output arrives sorted descending — ops/merge.py
    top_k_with_payload), co-sorts those rows by min(scan bound, refined
    bound) ON DEVICE, and returns only the compact top-t_out slice plus a
    single certificate bound:

        (rows [B, k], ubs [B, k], bound [B]),  k = min(t_out, r)
        bound = max(scan boundary,            # rows the scan excluded
                    (r+1)-th scan bound,      # candidates refine skipped
                    (t_out+1)-th refined)     # candidates select dropped

    ``bound`` is a sound upper bound on EVERY row not in the returned
    slice, so the engine's certificate check ``exact kth > bound`` retains
    its exact semantics while the readback shrinks from 3x[B, m+1] to
    ~3x[B, 32] (the dominant per-batch transport cost at serving batch
    sizes). ``r`` < m additionally halves-or-better the refine stage's
    gather + dot cost ([B, r, d] x2 int8 rows): on discriminative corpora
    the exact kth sits far above the (r+1)-th scan bound, so certificates
    keep resolving; near-tie corpora escalate exactly as before.
    bound == -inf still means the returned slice covers the whole snapshot
    (nothing live was excluded anywhere)."""
    from omni_recall_tpu.ops.merge import top_k_with_payload
    from omni_recall_tpu.ops.scan import quantize_kw_weights

    kw_w8 = quantize_kw_weights(kw_weights)
    b, m1 = vals_full.shape
    m = m1 - 1
    r = m if r is None else max(1, min(r, m))
    refined = _refine_dispatch(
        emb1, scale1, emb2, scale2, err2, bloom, created, valid,
        q, kw_w8, kw_bias, now_days, idxs_full[:, :r], vals_full[:, :r],
    )
    return compact_select(vals_full, idxs_full, refined, t_out, r)


def compact_select(vals_full, idxs_full, refined, t_out: int, r: int):
    """Device-side compact selection tail, shared by the single-device
    refine_select_from_scan and the sharded serving stage
    (parallel/sharded.py refine_select_dd): co-sort the top-``r`` scan
    candidates by min(scan bound, refined bound), return the top-t_out
    slice plus the single certificate bound (docstring above — soundness
    is unchanged because every dropped row stays covered by one of the
    three max'ed bounds)."""
    from omni_recall_tpu.ops.merge import top_k_with_payload

    b, m1 = vals_full.shape
    m = m1 - 1
    rows = idxs_full[:, :r]
    vals = vals_full[:, :r]
    ubs = jnp.minimum(vals, refined)  # min of sound bounds is sound
    k = min(t_out, r)
    top_v, top_i = top_k_with_payload(ubs, rows, min(t_out + 1, r))
    tail = (
        top_v[:, k] if top_v.shape[1] > k
        else jnp.full((b,), -jnp.inf, dtype=top_v.dtype)
    )
    bound = jnp.maximum(vals_full[:, -1], tail)
    if r < m:
        # first refine-skipped candidate: sound over positions r..m-1
        # (sorted descending)
        bound = jnp.maximum(bound, vals_full[:, r])
    return top_i[:, :k], top_v[:, :k], bound


@functools.partial(jax.jit, static_argnames=("t_out",))
def direct_select_from_scan(vals_full, idxs_full, t_out: int):
    """Compact selection STRAIGHT from the scan/merge output — no refine.

    The scan candidates arrive sorted descending by scan bound
    (ops/merge.py top_k_with_payload), so the top-t_out slice plus

        bound = max(scan boundary,        # rows the scan excluded
                    (t_out+1)-th scan bound)  # candidates the slice dropped

    satisfies exactly the compact_select coverage contract: every row not
    in the returned slice has a sound upper bound <= ``bound`` (the
    boundary covers scan-excluded rows; sorted order covers dropped
    candidates). The engine's certificate check is unchanged.

    This is the Engine:DirectSelect serving fast path: it skips the
    residual-int8 refine gather + kernel (the serving stage's
    second-largest device cost after the scan itself) at the price of a
    certificate bound ~4e-3 looser (scan bounds carry the int8
    quantization slack and the coarse keyword cap that refine would have
    tightened). On corpora whose kth exact score clears that slack the
    certificate resolves identically; misses re-certify at the full scan
    width (the engine's wide rescue, scan bounds only) and then the
    refine-assisted rescue-scan loop, so exactness is never at risk —
    only throughput. Also the only compact path for indexes built WITHOUT
    residual planes (DeviceIndex(refine=False), e.g. the 10M single-chip
    capacity config where the second int8 plane would not fit HBM)."""
    b, m1 = vals_full.shape
    m = m1 - 1
    k = min(t_out, m)
    rows = idxs_full[:, :k]
    ubs = vals_full[:, :k]
    tail = (
        vals_full[:, k] if m > k
        else jnp.full((b,), -jnp.inf, dtype=vals_full.dtype)
    )
    bound = jnp.maximum(vals_full[:, -1], tail)
    return rows, ubs, bound


def quantize_queries_int8_residual(q: jax.Array):
    """Two-plane residual int8 query quantization on device.

    Returns (q1 i8[B,d], t1 f32[B,1], q2 i8[B,d], t2 f32[B,1], eq2 f32[B,1])
    with q ~= q1*t1 + q2*t2 and ||q - q1*t1 - q2*t2|| <= eq2. The norm is
    evaluated in f32; the (1 + 1e-4) relative + 3e-7 absolute slack covers
    the f32 rounding of the residual representation and the norm itself
    (the residual elements are exact to ~1e-7: int8*f32 products round once
    per plane on O(1e-2) values)."""

    def one_plane(x):
        absmax = jnp.max(jnp.abs(x), axis=1, keepdims=True)
        scale = absmax / 127.0
        safe = jnp.where(scale > 0, scale, 1.0)
        q8 = jnp.clip(jnp.round(x / safe), -127, 127).astype(jnp.int8)
        return q8, scale

    q1, t1 = one_plane(q)
    resid = q - q1.astype(jnp.float32) * t1
    q2, t2 = one_plane(resid)
    resid2 = resid - q2.astype(jnp.float32) * t2
    eq2 = jnp.linalg.norm(resid2, axis=1, keepdims=True)
    eq2 = eq2 * (1.0 + 1e-4) + 3e-7
    return q1, t1, q2, t2, eq2


@jax.jit
def refine_ub(
    emb1: jax.Array,     # i8 [N, d] scan plane (shared with the scan)
    scale1: jax.Array,   # f32 [N]
    emb2: jax.Array,     # i8 [N, d] residual plane
    scale2: jax.Array,   # f32 [N]
    err2: jax.Array,     # f32 [N] second-order residual norm bound
    bloom: jax.Array,    # u8 [N, W]
    created: jax.Array,  # f32 [N] days
    valid: jax.Array,    # bool [N]
    q: jax.Array,        # f32 [B, d] normalized (or zero) query embeddings
    kw_w8: jax.Array,    # i8 [B, bits] ceil-quantized keyword weights
    kw_bias: jax.Array,  # f32 [B] stopword-fallback bias
    now_days: jax.Array,
    rows: jax.Array,     # i32 [B, m] scan candidate rows (<0 = sentinel)
    vals: jax.Array,     # f32 [B, m] scan bounds (-inf = no candidate)
) -> jax.Array:
    """Refined sound upper bounds [B, m] for the scan's candidate rows
    (-inf where the slot holds no live candidate). See module docstring
    for the soundness derivation. Pure XLA (gather + 4 batched int8 dots +
    one bloom dot): ~m/N of the scan's work, fused into the same device
    dispatch chain — no extra host round trip."""
    safe_rows = jnp.maximum(rows, 0)
    c1 = jnp.take(emb1, safe_rows, axis=0)   # [B, m, d] i8
    c2 = jnp.take(emb2, safe_rows, axis=0)   # [B, m, d] i8
    s1 = jnp.take(scale1, safe_rows)         # [B, m]
    s2 = jnp.take(scale2, safe_rows)
    ec2 = jnp.take(err2, safe_rows)
    ok = (rows >= 0) & jnp.take(valid, safe_rows) & (vals > -jnp.inf)

    q1, t1, q2, t2, eq2 = quantize_queries_int8_residual(q)

    def bdot(qq, cc):  # [B, d] x [B, m, d] -> [B, m], exact int32 sums
        return jax.lax.dot_general(
            qq, cc,
            dimension_numbers=(((1,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        ).astype(jnp.float32)

    cos_hat = (
        (t1 * s1) * bdot(q1, c1)
        + (t1 * s2) * bdot(q1, c2)
        + (t2 * s1) * bdot(q2, c1)
        + (t2 * s2) * bdot(q2, c2)
    )
    qn = jnp.linalg.norm(q, axis=1, keepdims=True) * (1.0 + 1e-6)
    delta = eq2 * (1.0 + ec2) + qn * ec2  # [B, m]

    bits = jnp.concatenate(
        [((jnp.take(bloom, safe_rows, axis=0).astype(jnp.int32) >> b) & 1)
         for b in range(8)],
        axis=2,
    ).astype(jnp.int8)  # [B, m, 8W]
    kwd = jax.lax.dot_general(
        kw_w8, bits,
        dimension_numbers=(((1,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32)
    kw = jnp.minimum(kwd * (1.0 / 127.0) + kw_bias[:, None], 1.0)

    rec = jnp.exp(
        jnp.minimum(jnp.take(created, safe_rows) - now_days, 0.0)
        / RECENCY_HALF_LIFE_DAYS
    )

    refined = (
        COSINE_WEIGHT * (cos_hat + delta)
        + KEYWORD_WEIGHT * kw
        + RECENCY_WEIGHT * rec
        + REFINE_EPS
    )
    return jnp.where(ok, refined, -jnp.inf)
