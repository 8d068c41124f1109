"""Batched search: one device pass for many queries, per-query exactness."""

import random
import string
from datetime import datetime, timedelta, timezone

from omni_recall_tpu.config import EngineOptions
from omni_recall_tpu.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu.index.store import InMemoryIngestionStore
from omni_recall_tpu.models import hash_embedder
from omni_recall_tpu.search.engine import RecallEngine

DIM = 32
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)


def _setup(rng, backend="xla", n=150, **opts):
    store = InMemoryIngestionStore()
    engine = RecallEngine(
        store,
        options=EngineOptions(
            backend=backend, embedding_dim=DIM, capacity_block=128,
            bloom_bits=256, recent_window=0,
            **{"candidate_m": 8, **opts},
        ),
    )
    oracle_engine = RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=0))
    vocab = ["".join(rng.choices(string.ascii_lowercase, k=rng.randint(2, 8))) for _ in range(40)]
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    chunks = [
        ChunkRecord(
            id=f"d:{i:04d}", document_id="d", chunk_index=i,
            content=" ".join(rng.choices(vocab, k=rng.randint(4, 15))),
            embedding=hash_embedder.embed_text(f"c{i}", DIM),
            created_at_utc=T0 + timedelta(minutes=i),
        )
        for i in range(n)
    ]
    store.upsert_chunks(chunks)
    engine.on_chunks_upserted(chunks, new=True)
    return engine, oracle_engine, vocab


def test_batch_matches_sequential_and_oracle():
    rng = random.Random(61)
    engine, oracle_engine, vocab = _setup(rng)
    requests = []
    for _ in range(9):
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 3)))
        emb = hash_embedder.embed_text(query, DIM) if rng.random() < 0.7 else []
        requests.append((query, emb, rng.choice([1, 3, 10])))

    batch = engine.search_batch(requests, now=NOW)
    assert len(batch) == len(requests)
    for (query, emb, k), hits in zip(requests, batch):
        expected = oracle_engine.search(query, emb, k, now=NOW)
        assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]
        assert [h.score for h in hits] == [h.score for h in expected]
        single = engine.search(query, emb, k, now=NOW)
        assert [h.chunk.id for h in hits] == [h.chunk.id for h in single]


def test_batch_mixed_topk_and_escalation_int8():
    rng = random.Random(67)
    engine, oracle_engine, vocab = _setup(rng, backend="pallas", n=300, scan_dtype="int8")
    requests = [
        (" ".join(rng.choices(vocab, k=2)), hash_embedder.embed_text(f"q{i}", DIM), 5)
        for i in range(6)
    ]
    batch = engine.search_batch(requests, now=NOW)
    for (query, emb, k), hits in zip(requests, batch):
        expected = oracle_engine.search(query, emb, k, now=NOW)
        assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]


def test_empty_batch_and_empty_index():
    rng = random.Random(71)
    engine, _, _ = _setup(rng, n=1)
    assert engine.search_batch([]) == []
    empty_engine = RecallEngine(
        InMemoryIngestionStore(),
        options=EngineOptions(backend="xla", embedding_dim=DIM, capacity_block=128),
    )
    assert empty_engine.search_batch([("q", [], 5)], now=NOW) == [[]]


def test_approximate_profile_ranks_by_upper_bound():
    rng = random.Random(81)
    engine, oracle_engine, vocab = _setup(rng, backend="xla", n=200, exact=False)
    query = " ".join(rng.choices(vocab, k=2))
    emb = hash_embedder.embed_text(query, DIM)
    hits = engine.search(query, emb, 10, now=NOW)
    assert len(hits) == 10
    # approximate top-k should strongly overlap the exact top-k
    exact = oracle_engine.search(query, emb, 10, now=NOW)
    overlap = len({h.chunk.id for h in hits} & {h.chunk.id for h in exact})
    assert overlap >= 7
    # scores are sound upper bounds of the exact scores
    exact_by_id = {h.chunk.id: h.score for h in oracle_engine.search(query, emb, 200, now=NOW)}
    for h in hits:
        assert h.score + 1e-9 >= exact_by_id[h.chunk.id]


def test_rescue_scan_sliced_to_pending_parity():
    """A prepass-certificate miss of a few queries re-scans at the sliced
    pending width (bucketed pow2 gather) — results must stay bit-identical
    to the oracle after re-homing the sliced rows at their batch indices."""
    rng = random.Random(97)
    engine, oracle_engine, vocab = _setup(
        rng, backend="pallas", n=300, scan_dtype="int8", candidate_m=4,
    )
    # most queries ask k=1 (resolve in the prepass at m=4); a minority ask
    # k=10 > m, which cannot certify at the prepass width and must escalate
    # into the while-loop rescue — len(pending) <= b//2 triggers slicing
    requests = []
    for i in range(12):
        k = 10 if i in (3, 7) else 1
        query = " ".join(rng.choices(vocab, k=2))
        requests.append((query, hash_embedder.embed_text(f"q{i}", DIM), k))
    before = engine.stats["rescue_sliced_total"]
    batch = engine.search_batch(requests, now=NOW)
    assert engine.stats["rescue_sliced_total"] > before
    for (query, emb, k), hits in zip(requests, batch):
        expected = oracle_engine.search(query, emb, k, now=NOW)
        assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]
        assert [h.score for h in hits] == [h.score for h in expected]


def test_coarse_layout_overrides_and_shallow():
    from omni_recall_tpu.search.engine import SCAN_MAX_T, _scan_layout

    # shallow (the coarse prepass): depth 2 once there are >= 2048 slices;
    # below that threshold it keeps the auto deep layout
    assert _scan_layout(1 << 20, 128, shallow=True) == (128, 2)
    auto_small = _scan_layout(1 << 16, 128)
    assert _scan_layout(1 << 16, 128, shallow=True) == auto_small
    # an explicit depth is honored and clamped to the scan's bound
    assert _scan_layout(1 << 20, 128, t_override=3) == (128, 3)
    assert _scan_layout(1 << 20, 128, t_override=99)[1] <= SCAN_MAX_T
    # infeasible override (extraction budget below m) yields no layout
    assert _scan_layout(4096, 512, t_override=1) is None


def test_rebuild_index_atomic_swap_compacts_tombstones():
    from omni_recall_tpu.index.records import DocumentRecord, ChunkRecord
    from datetime import timedelta

    rng = random.Random(91)
    engine, oracle_engine, vocab = _setup(rng, n=120)
    store = engine.store
    store.upsert_document(DocumentRecord(id="d2", file_name="d2.txt", created_at_utc=T0))
    fresh = [
        ChunkRecord(id=f"d2:{i:04d}", document_id="d2", chunk_index=i,
                    content=f"fresh topic{i % 3} text",
                    embedding=hash_embedder.embed_text(f"fresh{i}", DIM),
                    created_at_utc=T0 + timedelta(days=2, minutes=i))
        for i in range(20)
    ]
    store.upsert_chunks(fresh)
    engine.on_chunks_upserted(fresh, new=True)
    store.delete_document("d")
    engine.on_document_deleted("d")
    n_rows_before = engine.device_index.n_rows
    assert engine.device_index.n_valid == 20

    engine.rebuild_index()
    assert engine.device_index.n_rows == 20  # tombstones compacted
    assert engine.device_index.n_rows < n_rows_before

    query = "fresh topic1"
    hits = engine.search(query, hash_embedder.embed_text(query, DIM), 5, now=NOW)
    expected = oracle_engine.search(query, hash_embedder.embed_text(query, DIM), 5, now=NOW)
    assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]
