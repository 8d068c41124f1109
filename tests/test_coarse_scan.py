"""Coarse (cosine-only, keyword-capped) int8 prepass: soundness + parity.

The coarse kernel replaces the per-chunk bloom keyword score with a sound
per-query cap 0.2*min(1, sum_w + bias) (ops/scan.py, term set "cos"; the
Triton kernel runs in interpret mode here).
These tests verify (a) every emitted value/bound is >= the true exact hybrid
score, (b) the engine with the prepass enabled stays bit-identical to the
oracle, including keyword-only queries (which skip the prepass), and (c) the
sharded coarse mode merges identically.
"""

import functools
import string
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest

from omni_recall_tpu.config import EngineOptions
from omni_recall_tpu.index.device_index import DeviceIndex, to_days
from omni_recall_tpu.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu.index.store import InMemoryIngestionStore
from omni_recall_tpu.models import hash_embedder
from omni_recall_tpu.ops import hashing, oracle, scan, triton_scan
from omni_recall_tpu.ops.quantize import quantize_rows_int8
from omni_recall_tpu.search.engine import RecallEngine

DIM = 64
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)


def _random_corpus(rng, n, dim=DIM):
    vocab = [
        "".join(rng.choice(list(string.ascii_lowercase), size=rng.integers(3, 9)))
        for _ in range(40)
    ] + ["card", "kernel", "recall"]
    contents, embs, created = [], [], []
    for i in range(n):
        words = rng.choice(vocab, size=rng.integers(4, 20))
        contents.append(" ".join(words))
        embs.append(hash_embedder.embed_text(contents[-1], dim))
        created.append(T0 + timedelta(minutes=int(i)))
    return contents, embs, created


def test_coarse_kernel_values_are_sound_upper_bounds():
    rng = np.random.default_rng(0)
    n, bits = 256, 128
    contents, embs, created = _random_corpus(rng, n)

    emb = np.stack(embs).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q_emb = np.stack([
        hash_embedder.embed_text("card kernel recall", DIM),
        hash_embedder.embed_text(contents[17], DIM),
    ]).astype(np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    queries = ["card kernel recall", contents[17][:20]]

    emb8, scale, err = quantize_rows_int8(emb)
    created_days = np.array([to_days(c) for c in created], dtype=np.float32)
    valid = np.ones(n, dtype=bool)
    w = np.zeros((2, bits), dtype=np.float32)
    b = np.zeros(2, dtype=np.float32)
    for qi, qtext in enumerate(queries):
        w[qi], b[qi] = hashing.query_bit_weights(oracle.query_terms(qtext), bits, 4, 1)

    m = 16
    vals, idxs = scan.score_topm(
        jnp.asarray(emb8), jnp.asarray(scale), jnp.asarray(err), None,
        jnp.asarray(created_days), jnp.asarray(valid),
        jnp.asarray(q_emb), jnp.asarray(w), jnp.asarray(b),
        jnp.float32(to_days(NOW)), jnp.int32(0),
        terms="cos", m=m, t=6, sub=64,
        scan=functools.partial(triton_scan.scan_triton, interpret=True),
    )
    vals, idxs = np.asarray(vals), np.asarray(idxs)

    # exact scores per (query, chunk) via the float64 oracle
    for qi, qtext in enumerate(queries):
        exact = np.array([
            oracle.score_chunk(
                qtext, q_emb[qi], embs[ci], contents[ci], created[ci], NOW
            )
            for ci in range(n)
        ])
        # every candidate's emitted value bounds its own exact score
        for j in range(m):
            row = idxs[qi, j]
            if row >= 0:
                assert vals[qi, j] >= exact[row] - 1e-7
        # the boundary bounds every non-candidate row
        cand = {int(r) for r in idxs[qi, :m] if r >= 0}
        excluded_max = max(
            (exact[ci] for ci in range(n) if ci not in cand), default=-np.inf
        )
        assert vals[qi, m] >= excluded_max - 1e-7


def _build_engine(rng, n, *, mesh=None, coarse=True):
    store = InMemoryIngestionStore()
    opts = EngineOptions(
        backend="pallas", embedding_dim=DIM, capacity_block=256,
        candidate_m=8, bloom_bits=256, recent_window=0,
        scan_dtype="int8", coarse_prepass=coarse,
    )
    engine = RecallEngine(store, options=opts, mesh=mesh)
    contents, embs, created = _random_corpus(rng, n)
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    chunks = [
        ChunkRecord(
            id=f"d:{i:04d}", document_id="d", chunk_index=i,
            content=contents[i], embedding=embs[i], created_at_utc=created[i],
        )
        for i in range(n)
    ]
    store.upsert_chunks(chunks)
    engine.on_chunks_upserted(chunks, new=True)
    oracle_engine = RecallEngine(
        store, None, EngineOptions(backend="oracle", recent_window=0)
    )
    return engine, oracle_engine, contents


def test_engine_with_coarse_prepass_matches_oracle():
    """Near-tie random corpus: the coarse cert fails, the engine falls
    through to the full fused scan, and results stay bit-identical."""
    rng = np.random.default_rng(1)
    engine, oracle_engine, contents = _build_engine(rng, 500)
    for qtext in [contents[3][:25], "gpu kernel", contents[450][:15]]:
        q = hash_embedder.embed_text(qtext, DIM)
        got = engine.search(qtext, q, 5, now=NOW)
        want = oracle_engine.search(qtext, q, 5, now=NOW)
        assert [h.chunk.id for h in got] == [h.chunk.id for h in want]
        assert [h.score for h in got] == [h.score for h in want]


def _clustered_engine(n_topics=25, per_topic=20):
    """Corpus with real retrieval structure: chunks of a topic share most of
    their text (high mutual cosine + full keyword match on the topic token);
    cross-topic similarity is low, so scores have decisive margins."""
    store = InMemoryIngestionStore()
    opts = EngineOptions(
        backend="pallas", embedding_dim=DIM, capacity_block=256,
        candidate_m=8, bloom_bits=256, recent_window=0,
        scan_dtype="int8", coarse_prepass=True,
    )
    engine = RecallEngine(store, options=opts)
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    chunks = []
    for t in range(n_topics):
        phrase = f"topic{t:03d} discusses subject matter {t} in depth"
        for j in range(per_topic):
            # graded dilution: variant j appends j filler words, so
            # within-topic cosines are well separated (the certificate needs
            # margins above the int8 quantization slack, ~0.02)
            filler = " ".join(f"fill{t}x{j}w{w}" for w in range(3 * j))
            content = f"{phrase} {filler}".strip()
            i = t * per_topic + j
            chunks.append(
                ChunkRecord(
                    id=f"d:{i:04d}", document_id="d", chunk_index=i,
                    content=content,
                    embedding=hash_embedder.embed_text(content, DIM),
                    created_at_utc=T0 + timedelta(minutes=i),
                )
            )
    store.upsert_chunks(chunks)
    engine.on_chunks_upserted(chunks, new=True)
    oracle_engine = RecallEngine(
        store, None, EngineOptions(backend="oracle", recent_window=0)
    )
    return engine, oracle_engine


def test_coarse_prepass_resolves_on_clustered_corpus():
    engine, oracle_engine = _clustered_engine()
    for t in (2, 11, 24):
        qtext = f"topic{t:03d} discusses subject matter {t} in depth"
        q = hash_embedder.embed_text(qtext, DIM)
        got = engine.search(qtext, q, 3, now=NOW)
        want = oracle_engine.search(qtext, q, 3, now=NOW)
        assert [h.chunk.id for h in got] == [h.chunk.id for h in want]
        assert [h.score for h in got] == [h.score for h in want]
        assert engine.last_coarse_resolved == 1, "prepass should certify here"
        assert engine.last_escalations == 0


def test_coarse_gate_disables_after_sustained_failures():
    rng = np.random.default_rng(5)
    engine, _, contents = _build_engine(rng, 500)
    # 40 near-tie queries: cert fails every time -> gate closes
    for i in range(40):
        qtext = contents[i][:20]
        engine.search(qtext, hash_embedder.embed_text(qtext, DIM), 5, now=NOW)
        if not engine._coarse_gate_open():
            break
    assert not engine._coarse_gate_open(), "gate should close on failures"
    # while closed, searches skip the prepass entirely but stay exact
    engine.search(contents[0][:20], hash_embedder.embed_text(contents[0][:20], DIM), 5, now=NOW)
    assert engine.last_coarse_resolved == 0


def test_keyword_only_queries_skip_prepass_and_stay_exact():
    rng = np.random.default_rng(2)
    engine, oracle_engine, contents = _build_engine(rng, 500)
    qtext = contents[42].split()[0]
    got = engine.search(qtext, None, 5, now=NOW)
    want = oracle_engine.search(qtext, None, 5, now=NOW)
    assert engine.last_coarse_resolved == 0
    assert [h.chunk.id for h in got] == [h.chunk.id for h in want]
    assert [h.score for h in got] == [h.score for h in want]


def test_mixed_batch_embedding_and_keyword_queries_exact():
    rng = np.random.default_rng(3)
    engine, oracle_engine, contents = _build_engine(rng, 500)
    reqs = [
        (contents[7][:20], hash_embedder.embed_text(contents[7][:20], DIM), 4),
        (contents[99].split()[0], None, 3),
        ("gpu recall", hash_embedder.embed_text("gpu recall", DIM), 5),
    ]
    got = engine.search_batch(reqs, now=NOW)
    for (qtext, qemb, k), hits in zip(reqs, got):
        want = oracle_engine.search(qtext, qemb, k, now=NOW)
        assert [h.chunk.id for h in hits] == [h.chunk.id for h in want]
        assert [h.score for h in hits] == [h.score for h in want]


def test_sharded_coarse_mode_matches_oracle():
    import jax

    from omni_recall_tpu.parallel.mesh import shards_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    rng = np.random.default_rng(4)
    mesh = shards_mesh(devices=jax.devices()[:4])
    engine, oracle_engine, contents = _build_engine(rng, 1024, mesh=mesh)
    for qtext in [contents[11][:20], "kernel gpu"]:
        q = hash_embedder.embed_text(qtext, DIM)
        got = engine.search(qtext, q, 5, now=NOW)
        want = oracle_engine.search(qtext, q, 5, now=NOW)
        assert [h.chunk.id for h in got] == [h.chunk.id for h in want]
        assert [h.score for h in got] == [h.score for h in want]




def test_kw_only_prepass_matches_oracle_and_resolves():
    """Keyword-only queries (no embedding) are served by the bloom-only
    scan: results identical to the oracle on any corpus (ties escalate),
    and a unique term at k=1 certifies on device without the full hybrid scan."""
    rng = np.random.default_rng(21)
    # parity on the tie-heavy corpus (certificate escalates, stays exact)
    engine, oracle_engine, contents = _build_engine(rng, 200)
    for trial in range(4):
        term = contents[int(rng.integers(len(contents)))].split()[0]
        hits = engine.search(term, None, 5, now=NOW)
        expected = oracle_engine.search(term, None, 5, now=NOW)
        assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected], term

    # resolution on a discriminative corpus: disjoint contents, wide bloom
    store = InMemoryIngestionStore()
    engine2 = RecallEngine(store, options=EngineOptions(
        backend="pallas", embedding_dim=DIM, capacity_block=256,
        candidate_m=8, bloom_bits=1024, recent_window=0, scan_dtype="int8",
    ))
    oracle2 = RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=0))
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    recs = [
        ChunkRecord(
            id=f"d:{i:04d}", document_id="d", chunk_index=i,
            content=f"zq{i}unique wfill{i}", embedding=None,
            created_at_utc=T0 + timedelta(minutes=i),
        )
        for i in range(96)
    ]
    store.upsert_chunks(recs)
    engine2.on_chunks_upserted(recs, new=True)
    hits = engine2.search("zq42unique", None, 1, now=NOW)
    expected = oracle2.search("zq42unique", None, 1, now=NOW)
    assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]
    assert hits[0].chunk.id == "d:0042"
    assert engine2.stats["kw_only_resolved_total"] == 1, engine2.stats
    assert engine2.last_escalations == 0


def test_sharded_kw_only_mode_matches_oracle():
    import jax

    from omni_recall_tpu.parallel.mesh import shards_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    rng = np.random.default_rng(6)
    mesh = shards_mesh(devices=jax.devices()[:4])
    engine, oracle_engine, contents = _build_engine(rng, 1024, mesh=mesh)
    for qtext in [contents[7].split()[0], "kernel", "gpu recall"]:
        got = engine.search(qtext, None, 5, now=NOW)  # keyword-only
        want = oracle_engine.search(qtext, None, 5, now=NOW)
        assert [h.chunk.id for h in got] == [h.chunk.id for h in want], qtext
        assert [h.score for h in got] == [h.score for h in want]
