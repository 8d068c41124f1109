"""Two-phase exact-rescore prune: correctness vs the full rescore.

The prune (engine._exact_rescore_rows with ub_lists/ks) may skip tail
candidates whose device upper bound is strictly below the provisional kth
exact score. The returned subset must contain the true top-k in identical
order and report an identical kth score — including under exact score ties,
where the recency/seq tie-break decides and ub == kth rows must survive.
"""

import random
import string
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from omni_recall_tpu.config import EngineOptions
from omni_recall_tpu.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu.index.store import InMemoryIngestionStore
from omni_recall_tpu.models import hash_embedder
from omni_recall_tpu.search.engine import RecallEngine

T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)
DIM = 48


def _engine(rng, n=150, duplicate_every=0, **opt_overrides):
    store = InMemoryIngestionStore()
    kw = dict(
        backend="xla", embedding_dim=DIM, recent_window=0,
        candidate_m=64, bloom_bits=128, capacity_block=256,
    )
    kw.update(opt_overrides)
    opts = EngineOptions(**kw)
    engine = RecallEngine(store, options=opts)
    store.upsert_document(DocumentRecord(id="d", file_name="d", created_at_utc=T0))
    vocab = ["gpu", "kernel", "recall", "data"] + [
        "".join(rng.choices(string.ascii_lowercase, k=rng.randint(2, 8)))
        for _ in range(25)
    ]
    chunks = []
    for i in range(n):
        if duplicate_every and i % duplicate_every:
            # exact duplicate of the previous content+embedding: identical
            # score, ranked purely by the (created, seq) tie-break
            content = chunks[-1].content
            emb = chunks[-1].embedding
        else:
            content = " ".join(rng.choices(vocab, k=rng.randint(1, 20)))
            emb = hash_embedder.embed_text(content, DIM)
        chunks.append(
            ChunkRecord(
                id=f"d:{i:04d}", document_id="d", chunk_index=i,
                content=content, embedding=emb,
                created_at_utc=T0 + timedelta(seconds=(i * 13) % 997),
            )
        )
    store.upsert_chunks(chunks)
    engine.on_chunks_upserted(chunks, new=True)
    return engine, vocab


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("duplicate_every", [0, 3])
def test_pruned_rescore_matches_full_topk(seed, duplicate_every):
    rng = random.Random(seed)
    engine, vocab = _engine(rng, duplicate_every=duplicate_every)
    nrng = np.random.default_rng(seed)
    n_rows = engine.device_index.n_rows

    queries, row_lists, ks = [], [], []
    for _ in range(10):
        qtext = " ".join(rng.choices(vocab, k=rng.randint(0, 4)))
        queries.append((qtext, hash_embedder.embed_text(qtext or "x", DIM)))
        row_lists.append(
            nrng.choice(n_rows, size=min(n_rows, 120), replace=False).astype(np.int64)
        )
        ks.append(rng.randint(1, 10))

    full = engine._exact_rescore_rows(queries, row_lists, NOW)

    # sound ub per candidate: true score + nonneg slack (often exactly 0,
    # mimicking a tight device bound); rows ordered ub-descending as the
    # device merge emits them
    ub_lists, sorted_rows = [], []
    for qi, (rows, (fr, fs)) in enumerate(zip(row_lists, full)):
        score_of = dict(zip(fr.tolist(), fs.tolist()))
        scores = np.asarray([score_of[r] for r in rows.tolist()])
        slack = nrng.uniform(0.0, 0.05, size=len(rows))
        slack[nrng.random(len(rows)) < 0.5] = 0.0
        ubs = scores + slack
        order = np.argsort(-ubs, kind="stable")
        sorted_rows.append(rows[order])
        ub_lists.append(ubs[order])

    pruned = engine._exact_rescore_rows(
        queries, sorted_rows, NOW, ub_lists=ub_lists, ks=ks
    )
    assert engine.stats["rescore_pairs_saved_total"] > 0
    for qi, ((fr, fs), (pr, ps)) in enumerate(zip(full, pruned)):
        k = ks[qi]
        assert np.array_equal(fr[:k], pr[:k]), f"query {qi} top-k rows differ"
        assert np.array_equal(fs[:k], ps[:k]), f"query {qi} top-k scores differ"
        # the kth (certificate comparand) must equal the full-set kth
        assert fs[k - 1] == ps[k - 1]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_engine_results_identical_with_and_without_prune(backend):
    rng = random.Random(5)
    engine_on, vocab = _engine(rng, backend=backend, rescore_prune=True)
    rng = random.Random(5)
    engine_off, _ = _engine(rng, backend=backend, rescore_prune=False)

    reqs = []
    qrng = random.Random(11)
    for _ in range(8):
        qtext = " ".join(qrng.choices(vocab, k=qrng.randint(1, 3)))
        reqs.append((qtext, hash_embedder.embed_text(qtext, DIM), qrng.randint(1, 10)))

    hits_on = engine_on.search_batch(reqs, now=NOW)
    hits_off = engine_off.search_batch(reqs, now=NOW)
    for a, b in zip(hits_on, hits_off):
        assert [(h.chunk.id, h.score) for h in a] == [
            (h.chunk.id, h.score) for h in b
        ]
    # the pruned engine must actually have skipped tail work on this corpus
    assert engine_on.stats["rescore_pairs_saved_total"] > 0
    assert engine_off.stats["rescore_pairs_saved_total"] == 0
