"""Device-exact cosine: double-float compensated dot over candidate rows.

The certified-exact serving path's remaining host cost is the float64
rescore: per (query, candidate) pair the host streams the row's raw f32
embedding (d*4 bytes) to reproduce the oracle cosine
``np.sum((q * c).astype(f64 pairwise))`` bit-for-bit
(search/engine.py _exact_rescore_rows; reference contract
src/OmniRecall.Api/Services/RecallSearchService.cs:59-75). At d=768 that is
~3 KB/pair — the embedding stream is ~95% of the host rescore's bytes and
pins certified end-to-end throughput to host memory bandwidth.

This module moves that stream onto the device, which computes the dot in
**double-float (compensated) f32 arithmetic** — every op correctly
rounded, so the result is reproducible bit for bit (dd_sum_products_np):

- products ``p_i = fl32(q_i * c_i)`` are the EXACT same IEEE-f32 products
  the numpy oracle forms (numpy multiplies in f32, then widens),
- the p_i are summed with a two-float (hi, lo) pairwise tree using Knuth's
  TwoSum (exact error recovery without FMA), giving
  ``|(hi + lo) - sum_true(p)| <= DD_SUM_REL * sum|p_i|``,
- ``sum|p_i|`` itself is returned (f32 tree sum, inflated by its own
  rounding bound) so the host can evaluate the error bound in f64.

The host then finishes in f64 exactly as the oracle does —
``cos = dot / (sqrt(q_norm_sq) * sqrt(row_norm_sq))``, fused with the exact
keyword + recency terms — and certifies, per query, that the oracle's f64
result could not differ visibly:

- the oracle's pairwise-f64 summation deviates from the true sum by
  <= NP_SUM_REL * sum|p_i| (numpy pairwise, blocksize 128, depth <= 12 at
  d <= 8192: (12+2) * 2^-53 < 1.6e-15),
- so |score_dd - score_np| <= margin where
  margin = COSINE_WEIGHT * (DD_SUM_REL + NP_SUM_REL) * sabs_ub / denom
  (+ a 1-ulp f64 slack for the shared combine expression),
- ranking is certified when every adjacent pair in the sorted order is
  separated by more than the two margins (pairs with margin 0 on both
  sides — cosine-free queries, zero rows — are exact and fall through to
  the created/seq tie-break, which both paths apply identically),
- the DTO value is certified when round(score - margin, 4) ==
  round(score + margin, 4) (round is monotone, so every value in the
  interval rounds identically — matching the reference's 4-decimal edge,
  Contracts/RecallSearchResponse round-trip).

Any query failing a certificate escalates to the existing host float64
rescore of its candidate rows (the bit-exact numpy/native path) — identical
semantics, just slower; with margins ~1e-11 the escalation rate is the
probability of two scores landing within ~1e-11 of each other or of a
0.00005 rounding midpoint.

DD_SUM_REL derivation: Knuth TwoSum is exact in IEEE f32 (no fast-math —
XLA does not reassociate explicit float graphs). At every tree level the
only rounding is the lo-part accumulation (3 f32 adds on values
<= 2u * partial-sum magnitudes). A standard Sum2-style bound for the
pairwise variant is ``|err| <= (log2(n)+2)^2 * u^2 * sum|p|`` with
u = 2^-24; at n = 8192 that is 196 * 3.55e-15 < 7e-13. DD_SUM_REL = 1e-8
keeps four orders of magnitude of headroom (a LOOSER margin only raises
escalations, never unsoundness).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# sound relative bounds on |computed - true| / sum|p_i| (see module docstring)
DD_SUM_REL = 1e-8     # double-float pairwise tree (provable ~7e-13; 4 oom slack)
NP_SUM_REL = 1.6e-15  # numpy pairwise-f64 over exact f32 products, d <= 8192
SABS_REL = 1e-4       # f32 tree-sum rounding on sum|p| itself (d*u ~ 5e-5)
# Device-computed query self-norm (device-resident query pipeline): the
# engine's qn = hi + lo from dd_sum_products(q, q). For a self-dot every
# product is non-negative, so sum|p| == sum p == qn_true and the DD bound
# gives |qn_dd - qn_true| <= DD_SUM_REL * qn_true; the oracle's numpy
# pairwise sum deviates by <= NP_SUM_REL * qn_true. Through the cosine's
# 1/sqrt(qn) the relative effect halves, so
# |cos(qn_dd) - cos(qn_np)| <= 0.5 * (DD_SUM_REL + NP_SUM_REL) / (1 - e)
# * |cos| — QN_DD_REL = 2e-8 keeps ~4x headroom on top of DD_SUM_REL's own
# four orders of magnitude.
QN_DD_REL = 2e-8


def _two_sum(a: jax.Array, b: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Knuth TwoSum: s + err == a + b EXACTLY (IEEE, any magnitudes)."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def _dd_fold(hi: jax.Array, lo: jax.Array) -> tuple[jax.Array, jax.Array]:
    """One pairwise-tree level: fold the last axis in half, combining
    double-float values (hi, lo) with TwoSum + compensated lo accumulation."""
    half = hi.shape[-1] // 2
    h1, h2 = hi[..., :half], hi[..., half:]
    l1, l2 = lo[..., :half], lo[..., half:]
    s, e = _two_sum(h1, h2)
    lo_new = e + (l1 + l2)
    # renormalize so |lo| stays ~<= ulp(hi): TwoSum again (s and lo_new can
    # be any magnitudes after cancellation; TwoSum is exact either way)
    return _two_sum(s, lo_new)


def dd_sum_products(q: jax.Array, c: jax.Array):
    """Double-float sum of the f32 products q*c over the last axis.

    q: f32[..., d] broadcastable against c: f32[..., d]. Returns
    (hi f32[...], lo f32[...], sabs f32[...]) with
    |(hi + lo) - sum_true(fl32(q_i*c_i))| <= DD_SUM_REL * sabs and
    sabs >= sum|fl32(q_i*c_i)| / (1 + SABS_REL).

    The products are bit-identical to the numpy oracle's f32 multiplies;
    only the summation differs (tree-DD here vs pairwise-f64 there), which
    the host margin accounts for."""
    # exact same IEEE-f32 products as the host oracle. Fused into the
    # first fold's add, the backend contracts a product and an add into one
    # FMA (XLA's CPU backend does, with no flag to stop it), which sums the
    # UNROUNDED product and breaks DD_SUM_REL against the oracle's fl32
    # products. The data-dependent select keeps the rounded product between
    # the two (p == p for every finite product; an optimization barrier
    # does not survive to code generation). dd_sum_products_np pins the
    # bits (tests/test_scan.py, tests/test_chip.py).
    p = q * c
    p = jnp.where(p == p, p, 0.0)
    d = p.shape[-1]
    pad = 1
    while pad < d:
        pad *= 2
    if pad != d:
        pw = [(0, 0)] * (p.ndim - 1) + [(0, pad - d)]
        p = jnp.pad(p, pw)
    hi = p
    lo = jnp.zeros_like(p)
    # Fold by halving slices down to 128 wide, then by ROTATION at a
    # constant 128 width: position 0 of the rolled fold sees EXACTLY the
    # same operand pairs in the same order as the halving tree (s[i] =
    # x[i] + x[i+half] for i < half), so the returned values are
    # bit-identical to the pure halving tree (the lanes >= half compute
    # wrapped values that are never read).
    while hi.shape[-1] > 128:
        hi, lo = _dd_fold(hi, lo)
    half = hi.shape[-1] // 2
    while half >= 1:
        h2 = jnp.roll(hi, -half, axis=-1)
        l2 = jnp.roll(lo, -half, axis=-1)
        s, e = _two_sum(hi, h2)
        lo_new = e + (lo + l2)
        hi, lo = _two_sum(s, lo_new)
        half //= 2
    sabs = jnp.sum(jnp.abs(p), axis=-1)  # f32 reduce; SABS_REL covers rounding
    return hi[..., 0], lo[..., 0], sabs


def dd_sum_products_np(q: np.ndarray, c: np.ndarray):
    """numpy float32 mirror of dd_sum_products' (hi, lo): the same products
    and the same fold tree, op for op, in IEEE f32 with no contraction. The
    device result must equal it bit for bit on every platform; a device
    compiler that fuses a product into the first fold (FMA) or flushes
    subnormals breaks that, and with it DD_SUM_REL."""
    p = (np.asarray(q, np.float32) * np.asarray(c, np.float32)).astype(np.float32)
    d = p.shape[-1]
    pad = 1 << max(0, (d - 1).bit_length())
    if pad != d:
        p = np.concatenate(
            [p, np.zeros(p.shape[:-1] + (pad - d,), np.float32)], axis=-1
        )

    def two_sum(a, b):
        s = a + b
        bp = s - a
        return s, (a - (s - bp)) + (b - bp)

    hi, lo = p, np.zeros_like(p)
    while hi.shape[-1] > 128:
        half = hi.shape[-1] // 2
        s, e = two_sum(hi[..., :half], hi[..., half:])
        hi, lo = two_sum(s, e + (lo[..., :half] + lo[..., half:]))
    half = hi.shape[-1] // 2
    while half >= 1:
        s, e = two_sum(hi, np.roll(hi, -half, axis=-1))
        hi, lo = two_sum(s, e + (lo + np.roll(lo, -half, axis=-1)))
        half //= 2
    return hi[..., 0], lo[..., 0]


@functools.partial(jax.jit, static_argnames=())
def exact_cos_rows(raw: jax.Array, rows: jax.Array, q_raw: jax.Array):
    """Per-(query, candidate-row) double-float dot against the device raw
    f32 plane.

    raw:   f32[N, d] — bitwise copy of the host raw_emb mirror
    rows:  i32[B, t] — candidate rows (<0 = empty slot; gathered at row 0,
           masked by the caller via its own row bookkeeping)
    q_raw: f32[B, d] — bitwise copy of the host raw query matrix

    Returns (hi, lo, sabs) f32[B, t] (see dd_sum_products). The host owns
    the norms, the f64 division, the keyword/recency terms, and the
    certificate — this op only replaces the embedding stream."""
    safe = jnp.maximum(rows, 0)
    c = jnp.take(raw, safe, axis=0)           # [B, t, d]
    return dd_rows(q_raw, c)


def dd_rows(q_raw: jax.Array, c: jax.Array):
    """Per-row DD dot of q_raw f32[B, d] against gathered rows c
    f32[B, t, d] through the platform's route (ops/routes.py). EVERY DD
    consumer (single-device exact_cos_rows AND the sharded
    parallel/sharded.py refine_select_dd) comes through here, so both
    produce the same bits."""
    from omni_recall_tpu.ops import routes

    return routes.current().dd(q_raw[:, None, :], c)


# ---- host-side finalization helpers (numpy; exact f64) ----


@functools.partial(jax.jit, static_argnames=())
def self_norm_dd(q_raw: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Double-float squared L2 norms of the raw query rows, ON DEVICE.

    q_raw: f32[B, d]. Returns (hi, lo) f32[B] with
    |(hi + lo) - sum_true(fl32(q_i^2))| <= DD_SUM_REL * qn_true (self-dot
    products are non-negative, so sabs == the sum itself — see QN_DD_REL).
    The device-resident query pipeline reads these 8 bytes/query back
    instead of the [B, d] raw matrix; escalations that need the oracle's
    exact numpy norm materialize the raw rows lazily."""
    hi, lo, _ = dd_sum_products(q_raw, q_raw)
    return hi, lo


def finish_cosines(
    hi: np.ndarray, lo: np.ndarray, sabs: np.ndarray,
    q_norm_sq: np.ndarray, row_norm_sq: np.ndarray,
    qn_rel: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """f64 cosines + sound margins vs the numpy-oracle cosine.

    hi/lo/sabs: f32[P] device outputs for P pairs; q_norm_sq f64[P]
    (owner-expanded), row_norm_sq f64[P]. Returns (cos f64[P],
    margin f64[P]) with |cos - cos_oracle| <= margin, margin == 0.0 exactly
    where the oracle's cosine is forced to 0 (zero norms — both paths guard
    identically).

    ``qn_rel`` (optional f64[P]): per-pair relative uncertainty of
    q_norm_sq vs the oracle's numpy-computed norm — nonzero for
    device-embedded queries whose norm came from self_norm_dd (QN_DD_REL)
    — folded into the margin as qn_rel * |cos| (the true sensitivity is
    0.5 * rel; the 2x slack is deliberate)."""
    dot = hi.astype(np.float64) + lo.astype(np.float64)
    ok = (q_norm_sq > 0.0) & (row_norm_sq > 0.0)
    # same f64 expression the oracle evaluates: sqrt(qn) * sqrt(ns), then
    # divide (engine._exact_rescore_rows numpy branch / native hybrid_rescore)
    denom = np.sqrt(np.where(ok, q_norm_sq, 1.0)) * np.sqrt(
        np.where(ok, row_norm_sq, 1.0)
    )
    cos = np.where(ok, dot / denom, 0.0)
    sabs_ub = sabs.astype(np.float64) * (1.0 + SABS_REL)
    # summation-order deviation, through the shared f64 divide (the divide
    # itself is the same expression both paths evaluate; 2 ulps slack for
    # its rounding interacting with the dot perturbation)
    margin = np.where(
        ok,
        (DD_SUM_REL + NP_SUM_REL) * sabs_ub / denom + 4e-16 * np.abs(cos),
        0.0,
    )
    if qn_rel is not None:
        margin = margin + np.where(ok, qn_rel * np.abs(cos), 0.0)
    return cos, margin


def round4_certified(scores: np.ndarray, margins: np.ndarray) -> np.ndarray:
    """True where the 4-decimal DTO rounding is PROVABLY invariant over
    [score-m, score+m] — for python's builtin ``round``, the function the
    DTO serialization applies (search/service.py round(hit.score, 4),
    mirroring the reference's Math.Round in RecallSearchService.cs:33).

    ``round(x, 4)`` (correctly rounded over the double's exact decimal
    value) can only change output where the real value crosses a decimal
    midpoint (2n+1)/2e4, so it is constant on any interval bounded away
    from every midpoint. The test computes the distance from score*1e4 to
    the nearest half-integer and requires it to exceed the margin plus this
    evaluation's own f64 error:

    - fl(score*1e4) carries <= |g| * 2^-52 absolute error;
    - g - floor(g) is exact (Sterbenz) and the half-integer shift adds
      < 2^-53 relative slop, covered by the 1e-15 constant;
    - the margin scale-up is padded by 1e-4 relative.

    NOTE np.round is NOT usable here: its scale-rint-unscale algorithm is
    documented inexact near the very midpoints this certificate is about,
    so np.round endpoint equality does not transfer to builtin round.
    Non-finite scores (padded -inf cells) certify trivially, as does
    margin == 0 (the two paths' values are then bit-identical, so any
    deterministic rounding of them agrees)."""
    with np.errstate(invalid="ignore"):
        g = scores * 1e4
        d = np.abs((g - np.floor(g)) - 0.5)
        slack = np.abs(g) * 2.3e-16 + margins * 1.0001e4 + 1e-15
        return (d > slack) | (margins == 0.0) | ~np.isfinite(scores)
