"""int8/bf16 quantized scan path: quantization soundness + engine parity."""

import random
import string
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from omni_recall_tpu.config import EngineOptions
from omni_recall_tpu.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu.index.store import InMemoryIngestionStore
from omni_recall_tpu.models import hash_embedder
from omni_recall_tpu.ops.quantize import ceil_quantize_weights_int8, quantize_rows_int8
from omni_recall_tpu.search.engine import RecallEngine

DIM = 64
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)


def test_quantize_rows_roundtrip_and_error_norm_sound():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((50, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[7] = 0.0
    q, scale, err = quantize_rows_int8(x)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    deq = q.astype(np.float64) * scale[:, None].astype(np.float64)
    true_err = np.sqrt(((x.astype(np.float64) - deq) ** 2).sum(axis=1))
    assert (err.astype(np.float64) + 1e-12 >= true_err).all()  # never optimistic
    assert err[7] == 0.0 and scale[7] == 0.0 and (q[7] == 0).all()
    # typical error for unit rows with per-row scale is small
    assert np.median(err[np.arange(50) != 7]) < 0.03


def test_ceil_quantized_weights_never_undershoot():
    rng = np.random.default_rng(6)
    w = rng.random(256).astype(np.float32) * 0.8
    w8 = ceil_quantize_weights_int8(w)
    assert (w8.astype(np.float64) / 127.0 + 1e-12 >= w).all()


def _corpus(rng, store, n=600):
    vocab = ["".join(rng.choices(string.ascii_lowercase, k=rng.randint(2, 8))) for _ in range(50)]
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    chunks = [
        ChunkRecord(
            id=f"d:{i:04d}", document_id="d", chunk_index=i,
            content=" ".join(rng.choices(vocab, k=rng.randint(4, 20))),
            embedding=hash_embedder.embed_text(f"c{i}", DIM) if rng.random() > 0.1 else None,
            created_at_utc=T0 + timedelta(minutes=i),
        )
        for i in range(n)
    ]
    store.upsert_chunks(chunks)
    return vocab, chunks


@pytest.mark.parametrize("scan_dtype", ["int8"])
def test_engine_quantized_pallas_parity_vs_oracle(scan_dtype):
    rng = random.Random(37)
    store = InMemoryIngestionStore()
    engine = RecallEngine(
        store,
        options=EngineOptions(
            backend="pallas", embedding_dim=DIM, capacity_block=128,
            candidate_m=16, bloom_bits=256, recent_window=0,
            scan_dtype=scan_dtype,
        ),
    )
    oracle_engine = RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=0))
    vocab, chunks = _corpus(rng, store)
    engine.on_chunks_upserted(chunks, new=True)
    assert engine.device_index.scan_dtype == scan_dtype

    for trial in range(5):
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 3)))
        q_emb = hash_embedder.embed_text(query, DIM)
        hits = engine.search(query, q_emb, 8, now=NOW)
        expected = oracle_engine.search(query, q_emb, 8, now=NOW)
        assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]
        for a, b in zip(hits, expected):
            assert a.score == b.score


def test_quantized_engine_fallback_to_host_oracle_when_budget_exhausted():
    rng = random.Random(41)
    store = InMemoryIngestionStore()
    engine = RecallEngine(
        store,
        options=EngineOptions(
            backend="pallas", embedding_dim=DIM, capacity_block=128,
            candidate_m=200, bloom_bits=256, recent_window=0, scan_dtype="int8",
        ),
    )
    oracle_engine = RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=0))
    vocab, chunks = _corpus(rng, store, n=100)  # slices*t too small for m=200
    engine.on_chunks_upserted(chunks, new=True)
    query = " ".join(rng.choices(vocab, k=2))
    q_emb = hash_embedder.embed_text(query, DIM)
    hits = engine.search(query, q_emb, 10, now=NOW)
    expected = oracle_engine.search(query, q_emb, 10, now=NOW)
    assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]


def test_quantized_updates_and_deletes_stay_in_sync():
    rng = random.Random(43)
    store = InMemoryIngestionStore()
    engine = RecallEngine(
        store,
        options=EngineOptions(
            backend="pallas", embedding_dim=DIM, capacity_block=128,
            candidate_m=16, bloom_bits=256, recent_window=0, scan_dtype="int8",
        ),
    )
    oracle_engine = RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=0))
    vocab, chunks = _corpus(rng, store, n=300)
    engine.on_chunks_upserted(chunks, new=True)
    engine.search("warmup", hash_embedder.embed_text("warmup", DIM), 3, now=NOW)

    # in-place embedding update (reindex path) after first device sync —
    # a document's WHOLE chunk list, matching upsert_chunks' per-document
    # replace semantics (InMemoryIngestionStore.cs:17-25)
    doc_id = store.get_recent_chunks(1)[0].document_id
    updated = store.get_chunks_by_document_id(doc_id)
    for c in updated:
        c.embedding = hash_embedder.embed_text(c.content + " v2", DIM)
    store.upsert_chunks(updated)
    engine.on_chunks_upserted(updated, new=False)

    query = " ".join(rng.choices(vocab, k=2))
    q_emb = hash_embedder.embed_text(query, DIM)
    assert [h.chunk.id for h in engine.search(query, q_emb, 8, now=NOW)] == \
        [h.chunk.id for h in oracle_engine.search(query, q_emb, 8, now=NOW)]


def test_bulk_load_exact_fit_alias_unaliases_on_update():
    """An exact-fit bulk_load adopts the caller's array for BOTH emb and
    raw_emb (zero-copy). In-place embedding updates must un-alias first:
    emb keeps the normalized value, raw_emb the raw one."""
    import numpy as np

    from datetime import datetime, timezone

    from omni_recall_tpu.index.device_index import DeviceIndex
    from omni_recall_tpu.index.records import ChunkRecord

    d, n = 16, 256  # capacity_block floor is 128 -> cap 256 == n exact fit
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    bloom = np.zeros((n, 16), dtype=np.uint8)
    created = np.linspace(0.0, 10.0, n).astype(np.float32)
    t0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
    meta = [
        ChunkRecord(id=f"c:{i}", document_id="doc", chunk_index=i,
                    content="x", embedding=emb[i], created_at_utc=t0, seq=i)
        for i in range(n)
    ]
    dix = DeviceIndex(d, capacity_block=128, bloom_bits=128, scan_dtype="int8")
    dix.bulk_load(emb, bloom, created, meta)
    assert dix._raw_aliased and dix.emb is dix.raw_emb

    raw_new = (np.arange(d) + 1.0).astype(np.float32)
    assert dix.update_embedding("c:7", raw_new.tolist())
    assert not dix._raw_aliased and dix.emb is not dix.raw_emb
    # emb row normalized, raw row keeps raw values
    assert np.allclose(np.linalg.norm(dix.emb[7]), 1.0, atol=1e-6)
    assert np.array_equal(dix.raw_emb[7], raw_new)
    # untouched rows unchanged in both views
    assert np.array_equal(dix.emb[8], emb[8])
    assert np.array_equal(dix.raw_emb[8], emb[8])

    # deletes are alias-safe (same value both views) on a fresh index
    dix2 = DeviceIndex(d, capacity_block=128, bloom_bits=128, scan_dtype="int8")
    dix2.bulk_load(emb.copy(), bloom, created, [
        ChunkRecord(id=f"e:{i}", document_id="doc2", chunk_index=i,
                    content="x", embedding=emb[i], created_at_utc=t0, seq=i)
        for i in range(n)
    ])
    assert dix2._raw_aliased
    assert dix2.delete_document("doc2") == n
    assert not dix2.emb[:n].any() and not dix2.raw_emb[:n].any()
