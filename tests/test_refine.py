"""Device-assisted exact rescore (ops/refine.py): soundness + effect.

The refined bound must be a sound upper bound on the float64 oracle score
for EVERY (query, candidate) pair — otherwise the engine's certificate can
silently drop a true top-k row — while sitting ~50x closer to the true
score than the int8 scan bound, which is what lets the host rescore prune
to ~k pairs. Mirrors the scan-bound soundness strategy of
tests/test_quantized_scan.py."""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from omni_recall_tpu.config import EngineOptions  # noqa: E402
from omni_recall_tpu.index.device_index import EPOCH, DeviceIndex, to_days  # noqa: E402
from omni_recall_tpu.index.records import ChunkRecord  # noqa: E402
from omni_recall_tpu.index.store import InMemoryIngestionStore  # noqa: E402
from omni_recall_tpu.ops import hashing, oracle, refine  # noqa: E402
from omni_recall_tpu.ops.quantize import (  # noqa: E402
    quantize_rows_int8,
    quantize_rows_int8_residual,
)
from omni_recall_tpu.search.engine import RecallEngine  # noqa: E402


def test_residual_quantization_bounds():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 768)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q1, s1, err1, q2, s2, err2 = quantize_rows_int8_residual(x)
    # first plane bit-identical to the plain quantizer (shared by the scan)
    p1, ps, pe = quantize_rows_int8(x)
    assert np.array_equal(q1, p1) and np.array_equal(s1, ps)
    assert np.array_equal(err1, pe)
    # err2 is a true bound on the two-plane residual, and ~100x tighter
    deq = (
        q1.astype(np.float64) * s1.astype(np.float64)[:, None]
        + q2.astype(np.float64) * s2.astype(np.float64)[:, None]
    )
    true = np.sqrt(np.sum((x.astype(np.float64) - deq) ** 2, axis=1))
    assert np.all(true <= err2.astype(np.float64))
    assert np.median(err2) < np.median(err1) / 50


def _build_corpus(n=2048, d=64, seed=3, noise=0.3):
    rng = np.random.default_rng(seed)
    n_clusters = 64
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, size=n)
    emb = centers[assign] + noise * rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    chunks = [
        ChunkRecord(
            id=f"c:{i}", document_id="doc", chunk_index=i,
            content=f"topic t{assign[i]}z payload words",
            embedding=emb[i],
            created_at_utc=EPOCH + timedelta(days=float(i) / 37.0),
            seq=i,
        )
        for i in range(n)
    ]
    return centers, assign, emb, chunks


def test_refined_bounds_are_sound_and_tight():
    centers, assign, emb, chunks = _build_corpus()
    n, d = emb.shape
    dix = DeviceIndex(d, bloom_bits=256, capacity_block=n, scan_dtype="int8",
                      refine=True)
    dix.append(chunks)
    dev = dix.device_arrays()
    assert dev.emb2 is not None

    now = EPOCH + timedelta(days=80.0)
    rng = np.random.default_rng(7)
    b, m = 16, 64
    queries, q = [], np.zeros((b, d), dtype=np.float32)
    weights = np.zeros((b, 256), dtype=np.float32)
    biases = np.zeros(b, dtype=np.float32)
    for i in range(b):
        cl = int(rng.integers(64))
        v = centers[cl] + 0.2 * rng.standard_normal(d).astype(np.float32)
        q[i] = v / np.linalg.norm(v)
        queries.append(f"t{cl}z payload")
        terms = oracle.query_terms(queries[i])
        weights[i], biases[i] = hashing.query_bit_weights(
            terms, dix.bloom_bits, dix.ngram, dix.bloom_hashes
        )
    rows = rng.integers(0, n, size=(b, m)).astype(np.int32)
    vals = np.zeros((b, m), dtype=np.float32)  # "live" markers

    kw_w8 = np.clip(np.ceil(weights * 127.0), 0, 127).astype(np.int8)
    refined = np.asarray(refine.refine_ub(
        dev.emb, dev.scale, dev.emb2, dev.scale2, dev.err2,
        dev.bloom, dev.created, dev.valid,
        jnp.asarray(q), jnp.asarray(kw_w8), jnp.asarray(biases),
        jnp.float32(to_days(now)), jnp.asarray(rows), jnp.asarray(vals),
    ))

    gaps = []
    for i in range(b):
        for j in range(m):
            c = chunks[int(rows[i, j])]
            exact = oracle.score_chunk(
                queries[i], q[i], c.embedding, c.content, c.created_at_utc, now
            )
            assert refined[i, j] >= exact, (
                f"refined bound {refined[i, j]} < exact {exact} "
                f"(query {i}, row {rows[i, j]})"
            )
            gaps.append(refined[i, j] - exact)
    # tight: the scan's int8 bound is >= 4e-3 loose (cert eps alone); the
    # refined bound must sit within ~1e-3 even counting bloom false
    # positives on the median pair
    assert np.median(gaps) < 1e-3


def test_refine_zero_query_adds_no_cosine_slack():
    """Keyword-only queries (zero embedding) must not inherit the residual
    error of candidate rows: |q|=0 makes the whole cosine term exactly 0."""
    _, _, emb, chunks = _build_corpus(n=512)
    d = emb.shape[1]
    dix = DeviceIndex(d, bloom_bits=256, capacity_block=512, scan_dtype="int8",
                      refine=True)
    dix.append(chunks)
    dev = dix.device_arrays()
    now = EPOCH + timedelta(days=80.0)
    terms = oracle.query_terms("t3z")
    w, bias = hashing.query_bit_weights(terms, 256, dix.ngram, dix.bloom_hashes)
    kw_w8 = np.clip(np.ceil(w * 127.0), 0, 127).astype(np.int8)
    rows = np.arange(64, dtype=np.int32)[None, :]
    refined = np.asarray(refine.refine_ub(
        dev.emb, dev.scale, dev.emb2, dev.scale2, dev.err2,
        dev.bloom, dev.created, dev.valid,
        jnp.zeros((1, d), dtype=jnp.float32), jnp.asarray(kw_w8[None, :]),
        jnp.asarray([bias], dtype=jnp.float32),
        jnp.float32(to_days(now)), jnp.asarray(rows),
        jnp.zeros((1, 64), dtype=jnp.float32),
    ))
    for j in range(64):
        c = chunks[j]
        exact = oracle.score_chunk("t3z", None, c.embedding, c.content,
                                   c.created_at_utc, now)
        assert refined[0, j] >= exact
        # no cosine => the only slack is the bloom bound + REFINE_EPS;
        # far below the scan's 4e-3 certificate epsilon
        kw_exact = oracle.keyword_score("t3z", c.content)
        slack = refined[0, j] - exact
        assert slack < 2e-4 + 0.2 * (1.0 - kw_exact)


def _engine(chunks, d, refine_on: bool):
    opts = EngineOptions(
        backend="pallas", embedding_dim=d, recent_window=0, candidate_m=64,
        bloom_bits=256, scan_dtype="int8", capacity_block=4096,
        refine=refine_on,
    )
    eng = RecallEngine(InMemoryIngestionStore(), options=opts)
    eng.device_index.append(chunks)
    return eng


def test_engine_results_identical_with_and_without_refine():
    # well-separated clusters (d=128, low noise): certificates resolve on
    # the first pass, so the pair counts isolate the refine effect
    centers, assign, emb, chunks = _build_corpus(d=128, noise=0.1)
    d = emb.shape[1]
    eng_ref = _engine(chunks, d, refine_on=True)
    eng_base = _engine(chunks, d, refine_on=False)
    assert eng_ref.device_index.device_arrays().emb2 is not None
    assert eng_base.device_index.device_arrays().emb2 is None

    now = EPOCH + timedelta(days=80.0)
    rng = np.random.default_rng(11)
    reqs = []
    for _ in range(24):
        cl = int(rng.integers(64))
        v = centers[cl] + 0.1 * rng.standard_normal(d).astype(np.float32)
        reqs.append((f"t{cl}z payload", (v / np.linalg.norm(v)).tolist(), 10))
    out_ref = eng_ref.search_batch(reqs, now=now)
    out_base = eng_base.search_batch(reqs, now=now)
    for hr, hb in zip(out_ref, out_base):
        assert [h.chunk.id for h in hr] == [h.chunk.id for h in hb]
        assert [h.score for h in hr] == [h.score for h in hb]

    # the refined bounds must cut the host's exact-rescore width on the
    # certificate-resolved embedding queries: with k=10 and
    # phase1_refined=12 the refined engine rescores barely more than k
    # pairs/query while the base engine pays the full phase-1 window.
    # (queries that exhaust the certificate fall back to a full host scan
    # — n pairs each, identical in both engines — and would swamp the
    # comparison, so the fallback contribution is subtracted out.)
    n = len(chunks)
    assert eng_ref.stats["host_fallbacks_total"] == (
        eng_base.stats["host_fallbacks_total"]
    )
    fb = eng_ref.stats["host_fallbacks_total"]
    resolved = len(reqs) - fb
    assert resolved > 0

    def resolved_pairs(eng):
        return (eng.stats["rescore_pairs_total"] - n * fb) / resolved

    pairs_ref = resolved_pairs(eng_ref)
    pairs_base = resolved_pairs(eng_base)
    assert pairs_ref < pairs_base * 0.55, (pairs_ref, pairs_base)
    assert pairs_ref < 16  # ~k=10 + phase-2 stragglers

    special = [("t5z", None, 10), ("", None, 5)]  # keyword-/recency-only
    out_ref = eng_ref.search_batch(special, now=now)
    out_base = eng_base.search_batch(special, now=now)
    for hr, hb in zip(out_ref, out_base):
        assert [h.chunk.id for h in hr] == [h.chunk.id for h in hb]
        assert [h.score for h in hr] == [h.score for h in hb]


def test_pipelined_batches_match_sequential():
    """search_batches_pipelined dispatches every batch's scans before any
    finalize — results must equal per-batch search_batch calls exactly."""
    centers, assign, emb, chunks = _build_corpus(d=128, noise=0.1)
    d = emb.shape[1]
    eng = _engine(chunks, d, refine_on=True)
    now = EPOCH + timedelta(days=80.0)
    rng = np.random.default_rng(23)

    def make_batch(nb):
        reqs = []
        for _ in range(nb):
            cl = int(rng.integers(64))
            v = centers[cl] + 0.1 * rng.standard_normal(d).astype(np.float32)
            reqs.append((f"t{cl}z payload", (v / np.linalg.norm(v)).tolist(), 7))
        return reqs

    batches = [make_batch(6), make_batch(9), [("t9z", None, 4)], []]
    piped = eng.search_batches_pipelined(batches, now=now)
    seq = [eng.search_batch(b, now=now) for b in batches]
    assert len(piped) == len(seq)
    for pb, sb in zip(piped, seq):
        assert len(pb) == len(sb)
        for hp, hs in zip(pb, sb):
            assert [h.chunk.id for h in hp] == [h.chunk.id for h in hs]
            assert [h.score for h in hp] == [h.score for h in hs]
