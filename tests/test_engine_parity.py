"""Device search vs host oracle: exact ranking parity.

The certified-exact engine (XLA upper-bound pass + host rescore) must return
EXACTLY the same chunks, order, and scores as the full host oracle scan, for
randomized corpora including missing embeddings, deletions, tie scores, and
candidate-window truncation.
"""

import random
import string
from datetime import datetime, timedelta, timezone

import pytest

from omni_recall_tpu.config import EngineOptions
from omni_recall_tpu.index.device_index import DeviceIndex
from omni_recall_tpu.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu.index.store import InMemoryIngestionStore
from omni_recall_tpu.models import hash_embedder
from omni_recall_tpu.search.engine import RecallEngine

DIM = 64
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)


def _build(n_chunks, rng, *, missing_emb_rate=0.15, window=300, candidate_m=16):
    store = InMemoryIngestionStore()
    dix = DeviceIndex(DIM, capacity_block=256, bloom_bits=512, ngram=4, bloom_hashes=1)
    opts = EngineOptions(
        backend="xla", embedding_dim=DIM, recent_window=window, candidate_m=candidate_m
    )
    engine = RecallEngine(store, dix, opts)
    oracle_engine = RecallEngine(
        store, None, EngineOptions(backend="oracle", recent_window=window)
    )

    vocab = [
        "".join(rng.choices(string.ascii_lowercase, k=rng.randint(2, 9)))
        for _ in range(80)
    ] + ["optimization", "gpu", "kernel", "recall", "memory"]

    for d in range(max(1, n_chunks // 4)):
        doc_id = f"doc_{d}"
        created = T0 + timedelta(minutes=d)
        store.upsert_document(
            DocumentRecord(id=doc_id, file_name=f"f{d}.txt", created_at_utc=created)
        )
    docs = store.list_documents(10**6)

    chunks = []
    for i in range(n_chunks):
        doc = docs[i % len(docs)]
        content = " ".join(rng.choices(vocab, k=rng.randint(5, 40)))
        emb = None if rng.random() < missing_emb_rate else hash_embedder.embed_text(content, DIM)
        created = T0 + timedelta(minutes=i)  # monotone like real ingest
        chunks.append(
            ChunkRecord(
                id=f"{doc.id}:{i:04d}",
                document_id=doc.id,
                chunk_index=i,
                content=content,
                embedding=emb,
                created_at_utc=created,
            )
        )
    store.upsert_chunks(chunks)
    engine.on_chunks_upserted(chunks, new=True)
    return store, engine, oracle_engine, vocab


def _assert_same(hits_dev, hits_oracle, top_k):
    k = max(1, top_k)
    assert [h.chunk.id for h in hits_dev] == [h.chunk.id for h in hits_oracle[:k]]
    for a, b in zip(hits_dev, hits_oracle):
        assert a.score == pytest.approx(b.score, abs=0.0), (a.chunk.id, a.score, b.score)


def test_parity_randomized_queries():
    rng = random.Random(7)
    store, engine, oracle_engine, vocab = _build(120, rng)
    for trial in range(25):
        q_words = rng.choices(vocab, k=rng.randint(1, 4))
        if rng.random() < 0.3:
            q_words.append("the")
        query = " ".join(q_words)
        q_emb = hash_embedder.embed_text(query, DIM) if rng.random() < 0.7 else []
        top_k = rng.choice([1, 3, 5, 10])
        dev = engine.search(query, q_emb, top_k, now=NOW)
        orc = oracle_engine.search(query, q_emb, top_k, now=NOW)
        _assert_same(dev, orc, top_k)


def test_parity_with_tiny_candidate_m_forces_escalation():
    rng = random.Random(11)
    store, engine, oracle_engine, vocab = _build(100, rng, candidate_m=2)
    total_esc = 0
    for trial in range(10):
        query = " ".join(rng.choices(vocab, k=2))
        q_emb = hash_embedder.embed_text(query, DIM)
        dev = engine.search(query, q_emb, 5, now=NOW)
        total_esc += engine.last_escalations
        orc = oracle_engine.search(query, q_emb, 5, now=NOW)
        _assert_same(dev, orc, 5)
    assert total_esc > 0  # the tiny M must actually exercise escalation


def test_parity_all_ties_zero_embeddings_same_timestamp():
    store = InMemoryIngestionStore()
    dix = DeviceIndex(DIM, capacity_block=256, bloom_bits=512)
    engine = RecallEngine(store, dix, EngineOptions(backend="xla", embedding_dim=DIM, candidate_m=3))
    oracle_engine = RecallEngine(store, None, EngineOptions(backend="oracle"))
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    chunks = [
        ChunkRecord(id=f"d:{i:04d}", document_id="d", chunk_index=i,
                    content="same words here", embedding=None, created_at_utc=T0)
        for i in range(20)
    ]
    store.upsert_chunks(chunks)
    engine.on_chunks_upserted(chunks, new=True)
    dev = engine.search("words", [], 5, now=NOW)
    orc = oracle_engine.search("words", [], 5, now=NOW)
    _assert_same(dev, orc, 5)


def test_recent_window_excludes_old_chunks():
    rng = random.Random(3)
    store, engine, oracle_engine, vocab = _build(350, rng, window=300)
    # a query strongly matching the OLDEST chunk should not surface it
    oldest = store.get_recent_chunks(10**6)[-1]
    query = oldest.content.split()[0]
    dev = engine.search(query, hash_embedder.embed_text(query, DIM), 10, now=NOW)
    orc = oracle_engine.search(query, hash_embedder.embed_text(query, DIM), 10, now=NOW)
    _assert_same(dev, orc, 10)
    assert all(h.chunk.id != oldest.id for h in dev)


def test_parity_after_delete():
    rng = random.Random(5)
    store, engine, oracle_engine, vocab = _build(80, rng)
    victim = store.list_documents(10**6)[0].id
    store.delete_document(victim)
    engine.on_document_deleted(victim)
    query = " ".join(rng.choices(vocab, k=3))
    q_emb = hash_embedder.embed_text(query, DIM)
    dev = engine.search(query, q_emb, 10, now=NOW)
    orc = oracle_engine.search(query, q_emb, 10, now=NOW)
    _assert_same(dev, orc, 10)
    assert all(h.chunk.document_id != victim for h in dev)


def test_parity_after_reindex_style_embedding_update():
    rng = random.Random(9)
    store, engine, oracle_engine, vocab = _build(60, rng)
    # true reindex semantics: a document's WHOLE chunk list is re-upserted
    # (upsert_chunks REPLACES per document, InMemoryIngestionStore.cs:17-25
    # — a partial list would drop the document's other chunks)
    doc_id = store.list_documents(10**6)[0].id
    chunks = store.get_chunks_by_document_id(doc_id)
    assert chunks
    for c in chunks:
        c.embedding = hash_embedder.embed_text(c.content + " updated", DIM)
    store.upsert_chunks(chunks)
    engine.on_chunks_upserted(chunks, new=False)
    query = " ".join(rng.choices(vocab, k=2))
    q_emb = hash_embedder.embed_text(query, DIM)
    _assert_same(
        engine.search(query, q_emb, 8, now=NOW),
        oracle_engine.search(query, q_emb, 8, now=NOW),
        8,
    )


def test_empty_index_returns_empty():
    store = InMemoryIngestionStore()
    dix = DeviceIndex(DIM)
    engine = RecallEngine(store, dix, EngineOptions(backend="xla", embedding_dim=DIM))
    assert engine.search("anything", [], 5, now=NOW) == []
