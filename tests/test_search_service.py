"""Recall search service tests, mirroring RecallSearchServiceTests.cs:
orthogonal-embedding ranking, keyword fallback when the query embedding is
empty, stop-word dilution, snippet/rounding DTO edges."""

from datetime import datetime, timedelta, timezone

import pytest

from omni_recall_tpu.config import EngineOptions
from omni_recall_tpu.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu.index.store import InMemoryIngestionStore
from omni_recall_tpu.ingest.embedding import EmbeddingResult, EmbeddingStatus
from omni_recall_tpu.search.engine import RecallEngine
from omni_recall_tpu.search.service import RecallSearchService

NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)
T0 = NOW - timedelta(days=1)


class StubQueryEmbeddingClient:
    def __init__(self, vector):
        self.vector = vector

    def embed(self, text):
        status = EmbeddingStatus.SUCCESS if self.vector else EmbeddingStatus.EMPTY
        return EmbeddingResult(list(self.vector), status, model="stub")


def _seed(store):
    """3 docs with orthogonal embeddings (reference test fixture shape)."""
    embs = {
        "doc_a": [1.0, 0.0, 0.0],
        "doc_b": [0.0, 1.0, 0.0],
        "doc_c": [0.0, 0.0, 1.0],
    }
    contents = {
        "doc_a": "alpha notes about gpu kernels",
        "doc_b": "beta journal regarding gardens",
        "doc_c": "gamma memo concerning finance",
    }
    chunks = []
    for i, (doc_id, emb) in enumerate(embs.items()):
        store.upsert_document(
            DocumentRecord(id=doc_id, file_name=f"{doc_id}.txt", created_at_utc=T0)
        )
        chunks.append(
            ChunkRecord(
                id=f"{doc_id}:0000", document_id=doc_id, chunk_index=0,
                content=contents[doc_id], embedding=emb,
                created_at_utc=T0 + timedelta(minutes=i),
            )
        )
    store.upsert_chunks(chunks)
    return chunks


def _service(store, query_vector, backend="xla"):
    opts = EngineOptions(backend=backend, embedding_dim=3, capacity_block=128)
    engine = RecallEngine(store, options=opts)
    chunks = store.get_recent_chunks(10**6)
    if engine.device_index is not None and chunks:
        engine.on_chunks_upserted(sorted(chunks, key=lambda c: c.seq), new=True)
    return RecallSearchService(engine, StubQueryEmbeddingClient(query_vector))


@pytest.mark.parametrize("backend", ["oracle", "xla"])
def test_embedding_similarity_dominates_ranking(backend):
    store = InMemoryIngestionStore()
    _seed(store)
    svc = _service(store, [0.0, 1.0, 0.0], backend=backend)
    response = svc.search("unrelated words", 3, now=NOW)
    assert response.citations[0].document_id == "doc_b"
    assert response.citations[0].file_name == "doc_b.txt"
    assert response.query == "unrelated words"


@pytest.mark.parametrize("backend", ["oracle", "xla"])
def test_keyword_fallback_when_query_embedding_empty(backend):
    store = InMemoryIngestionStore()
    _seed(store)
    svc = _service(store, [], backend=backend)
    response = svc.search("gardens journal", 3, now=NOW)
    assert response.citations[0].document_id == "doc_b"


def test_stop_word_dilution():
    store = InMemoryIngestionStore()
    _seed(store)
    svc = _service(store, [])
    # stop words filtered: only "finance" counts
    response = svc.search("what is the finance", 3, now=NOW)
    assert response.citations[0].document_id == "doc_c"


def test_topk_clamped_to_at_least_one():
    store = InMemoryIngestionStore()
    _seed(store)
    svc = _service(store, [1.0, 0.0, 0.0])
    response = svc.search("anything", 0, now=NOW)
    assert len(response.citations) == 1


def test_score_rounded_to_4_decimals_and_snippet_truncated():
    store = InMemoryIngestionStore()
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    long_content = "word " * 100
    store.upsert_chunks([
        ChunkRecord(id="d:0000", document_id="d", chunk_index=0,
                    content=long_content, embedding=[1.0, 0.0, 0.0], created_at_utc=T0)
    ])
    svc = _service(store, [1.0, 0.0, 0.0])
    response = svc.search("word", 1, now=NOW)
    cit = response.citations[0]
    assert cit.score == round(cit.score, 4)
    assert len(cit.snippet) == 183  # 180 + "..."
    assert cit.snippet.endswith("...")


def test_unknown_document_filename():
    store = InMemoryIngestionStore()
    store.upsert_chunks([
        ChunkRecord(id="ghost:0000", document_id="ghost", chunk_index=0,
                    content="orphan chunk", embedding=None, created_at_utc=T0)
    ])
    svc = _service(store, [])
    response = svc.search("orphan", 1, now=NOW)
    assert response.citations[0].file_name == "unknown"


def test_whitespace_query_rejected():
    store = InMemoryIngestionStore()
    svc = _service(store, [])
    with pytest.raises(ValueError):
        svc.search("   ", 5)
