"""Scan kernel tests: the Triton kernel (ops/triton_scan.py) in interpret
mode on CPU, and the engine's pallas backend against the oracle.

The kernel emits per-slice top-t candidates + a per-slice bound; exactness
comes from the engine certificate, so the key property tested here is
SOUNDNESS: every row excluded from the candidate set has true upper-bound
score <= the returned boundary."""

import functools
import random
import string
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np

from omni_recall_tpu.config import EngineOptions
from omni_recall_tpu.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu.index.store import InMemoryIngestionStore
from omni_recall_tpu.models import hash_embedder
from omni_recall_tpu.ops import scan, triton_scan, xla_scorer
from omni_recall_tpu.ops.quantize import quantize_rows_int8
from omni_recall_tpu.search.engine import RecallEngine

DIM = 128
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)

_KERNEL = functools.partial(triton_scan.scan_triton, interpret=True)


def _random_inputs(rng, n, b=4, bloom_bits=256):
    w = bloom_bits // 8
    emb = rng.standard_normal((n, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[rng.random(n) < 0.1] = 0.0
    bloom = rng.integers(0, 256, size=(n, w), dtype=np.uint8)
    created = np.sort((rng.random(n) * 100).astype(np.float32))
    valid = rng.random(n) > 0.15
    q = rng.standard_normal((b, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kw_w = np.zeros((b, bloom_bits), dtype=np.float32)
    for i in range(b):
        idx = rng.choice(bloom_bits, size=24, replace=False)
        kw_w[i, idx] = rng.random(24).astype(np.float32) * 0.1
    kw_b = rng.random(b).astype(np.float32) * 0.05
    return emb, bloom, created, valid, q, kw_w, kw_b


def _kernel_topm(emb, bloom, created, valid, q, kw_w, kw_b, now, r0, m, t):
    """The full hybrid bound through the Triton kernel over int8 rows."""
    q8, scale, err = quantize_rows_int8(emb)
    n = emb.shape[0]
    return scan.score_topm(
        jnp.asarray(q8), jnp.asarray(scale), jnp.asarray(err),
        jnp.asarray(bloom), jnp.asarray(created), jnp.asarray(valid),
        jnp.asarray(q), jnp.asarray(kw_w), jnp.asarray(kw_b),
        jnp.float32(now), jnp.int32(r0),
        terms="cos_kw", m=m, t=t, sub=scan.scan_slice(n), scan=_KERNEL,
    )


def test_boundary_soundness_vs_exact_scores():
    rng = np.random.default_rng(13)
    n, b, m, t = 2048, 4, 24, 16  # 16 slices of 128 -> 256 candidates emitted
    inputs = _random_inputs(rng, n, b)
    vals, idxs = _kernel_topm(*inputs, 50.0, 100, m=m, t=t)
    vals, idxs = np.asarray(vals), np.asarray(idxs)
    # exact (f32, HIGHEST precision) scores without any certificate margin
    exact = np.asarray(
        xla_scorer.ub_scores(*(jnp.asarray(x) for x in inputs),
                             jnp.float32(50.0), jnp.int32(100))
    ) - xla_scorer.CERT_EPS  # [B, n]

    for bi in range(b):
        cands = set(idxs[bi, :m][vals[bi, :m] > -np.inf].tolist())
        boundary = vals[bi, m]
        assert idxs[bi, m] == -1
        for row in range(n):
            if row not in cands and np.isfinite(exact[bi, row]):
                assert exact[bi, row] <= boundary + 1e-6, (bi, row)
        # candidates carry their own (margined) scores
        for j in range(m):
            if vals[bi, j] > -np.inf:
                row = idxs[bi, j]
                assert vals[bi, j] >= exact[bi, row] - 1e-6


def test_masking_window_and_invalid_rows():
    rng = np.random.default_rng(17)
    n, b = 1024, 2
    emb, bloom, created, valid, q, kw_w, kw_b = _random_inputs(rng, n, b)
    valid[:] = True
    valid[700] = False
    vals, idxs = _kernel_topm(emb, bloom, created, valid, q, kw_w, kw_b,
                              50.0, 512, m=16, t=8)
    vals, idxs = np.asarray(vals), np.asarray(idxs)
    live = vals[:, :16] > -np.inf
    assert live.any()
    rows = idxs[:, :16][live]
    assert rows.min() >= 512
    assert 700 not in set(rows.tolist())


def test_m_exceeding_block_capacity_raises():
    rng = np.random.default_rng(19)
    inputs = _random_inputs(rng, 256, 2)
    try:
        _kernel_topm(*inputs, 50.0, 0, m=64, t=8)
        raised = False
    except ValueError:
        raised = True
    assert raised  # 256 rows -> 2 slices * 8 < 64


def _seed_engine_corpus(store, rng, n_chunks):
    vocab = ["".join(rng.choices(string.ascii_lowercase, k=rng.randint(2, 8))) for _ in range(50)]
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    chunks = [
        ChunkRecord(
            id=f"d:{i:04d}", document_id="d", chunk_index=i,
            content=" ".join(rng.choices(vocab, k=rng.randint(4, 20))),
            embedding=hash_embedder.embed_text(f"c{i}", DIM) if rng.random() > 0.1 else None,
            created_at_utc=T0 + timedelta(minutes=i),
        )
        for i in range(n_chunks)
    ]
    store.upsert_chunks(chunks)
    return vocab, chunks


def test_engine_pallas_backend_parity_vs_oracle():
    rng = random.Random(29)
    store = InMemoryIngestionStore()
    engine = RecallEngine(
        store,
        options=EngineOptions(
            backend="pallas", embedding_dim=DIM, capacity_block=128,
            candidate_m=16, bloom_bits=256, recent_window=0,
        ),
    )
    oracle_engine = RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=0))
    vocab, chunks = _seed_engine_corpus(store, rng, 600)  # cap 640 -> 5 blocks
    engine.on_chunks_upserted(chunks, new=True)

    for trial in range(5):
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 3)))
        q_emb = hash_embedder.embed_text(query, DIM)
        hits = engine.search(query, q_emb, 8, now=NOW)
        expected = oracle_engine.search(query, q_emb, 8, now=NOW)
        assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]
        for a, b in zip(hits, expected):
            assert a.score == b.score


def test_engine_pallas_falls_back_to_xla_on_tiny_index():
    rng = random.Random(31)
    store = InMemoryIngestionStore()
    engine = RecallEngine(
        store,
        options=EngineOptions(
            backend="pallas", embedding_dim=DIM, capacity_block=128,
            candidate_m=64, bloom_bits=256,
        ),
    )
    oracle_engine = RecallEngine(store, None, EngineOptions(backend="oracle"))
    vocab, chunks = _seed_engine_corpus(store, rng, 40)  # 1 block * 8 < m=64
    engine.on_chunks_upserted(chunks, new=True)
    query = " ".join(rng.choices(vocab, k=2))
    q_emb = hash_embedder.embed_text(query, DIM)
    hits = engine.search(query, q_emb, 10, now=NOW)
    expected = oracle_engine.search(query, q_emb, 10, now=NOW)
    assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]


def test_certificate_detects_concurrent_embedding_update():
    """A reindex (in-place embedding update) landing between the device
    snapshot and the host rescore must NOT produce a 'certified' ranking
    mixing stale bounds with fresh scores — the engine detects the update
    via DeviceIndex.update_seq and serializes after it through the exact
    host scan."""
    rng = random.Random(77)
    store = InMemoryIngestionStore()
    engine = RecallEngine(
        store,
        options=EngineOptions(
            backend="pallas", embedding_dim=DIM, capacity_block=128,
            candidate_m=8, bloom_bits=256,
        ),
    )
    vocab, chunks = _seed_engine_corpus(store, rng, 200)
    engine.on_chunks_upserted(chunks, new=True)

    query = " ".join(rng.choices(vocab, k=2))
    q_emb = hash_embedder.embed_text(query, DIM)

    # inject an update between the scan and the rescore: wrap the rescore
    # entry point so the first call flips a chunk's embedding to be a
    # near-perfect match for the query
    target = chunks[0]
    original = engine._exact_rescore_rows
    fired = {"n": 0}

    def updating_rescore(*args, **kwargs):
        if fired["n"] == 0:
            fired["n"] = 1
            engine.on_chunks_upserted(
                [ChunkRecord(
                    id=target.id, document_id=target.document_id,
                    chunk_index=target.chunk_index, content=target.content,
                    embedding=q_emb, created_at_utc=target.created_at_utc,
                    seq=target.seq,
                )],
                new=False,
            )
        return original(*args, **kwargs)

    engine._exact_rescore_rows = updating_rescore
    try:
        hits = engine.search(query, q_emb, 5, now=NOW)
    finally:
        engine._exact_rescore_rows = original

    # exact vs the post-update state: the updated chunk must now rank first
    oracle_engine = RecallEngine(store, None, EngineOptions(backend="oracle"))
    expected = oracle_engine.search(query, q_emb, 5, now=NOW)
    assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]
    assert hits[0].chunk.id == target.id
