"""The synthetic serving corpus and its float64 oracle
(omni_recall_tpu/eval/synthetic.py), which chip_smoke.py and bench.py
check the served results against."""

import numpy as np
import pytest

from omni_recall_tpu.config import EngineOptions
from omni_recall_tpu.eval import synthetic
from omni_recall_tpu.ops import oracle
from omni_recall_tpu.search.engine import SearchHit, _sort_key


@pytest.fixture(scope="module")
def built():
    opts = EngineOptions(
        backend="pallas", embedding_dim=64, recent_window=0, candidate_m=32,
        bloom_bits=256, scan_dtype="int8", capacity_block=8192,
        device_exact_cos=True, direct_select=True,
    )
    return synthetic.build_engine(opts, 1 << 13, seed=3)


def _dto(hits):
    return [(h.chunk.id, round(h.score, 4)) for h in hits]


@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("hybrid", [True, False])
def test_oracle_equals_per_row_scoring(built, window, hybrid):
    """The prefiltered oracle returns what scoring every chunk with
    ops/oracle.py returns."""
    _, corpus = built
    for token, q, k in synthetic.make_requests(corpus, 5, 3):
        q = q if hybrid else None
        got = synthetic.oracle_search(corpus, [], token, q, k, window, corpus.now)
        rows = corpus.meta[-window:] if window else corpus.meta
        full = sorted(
            (SearchHit(m, oracle.score_chunk(token, q, m.embedding, m.content,
                                             m.created_at_utc, corpus.now))
             for m in rows),
            key=_sort_key,
        )
        assert _dto(got) == _dto(full[:k])


def test_served_batch_equals_oracle(built):
    engine, corpus = built
    reqs = synthetic.make_requests(corpus, 7, 8)
    res = engine.search_batch(reqs, now=corpus.now)
    for (token, q, k), hits in zip(reqs, res):
        want = synthetic.oracle_search(corpus, [], token, q, k, 0, corpus.now)
        assert _dto(hits) == _dto(want)


def test_corpus_embedding_client(built):
    _, corpus = built
    client = synthetic.CorpusEmbeddingClient(corpus)
    vec = client.embed(corpus.cluster_token(5)).vector
    assert np.array_equal(np.asarray(vec, np.float32), corpus.centers[5])
    other = client.embed("zebra quartz").vector
    assert len(other) == corpus.emb.shape[1]
    assert not np.array_equal(np.asarray(other, np.float32), corpus.centers[5])
