"""Compact host store (index/compact.py + DeviceIndex.bulk_load_compact,
VERDICT r4 #4): the 10M hybrid serving configuration's storage layer.

Pins, at CPU-test scale:
- host (numpy) and device (jnp) corpus generation are bit-identical — the
  determinism contract that replaces the multi-GB embedding transfer;
- an engine over the compact store serves HYBRID queries (cosine + real
  keyword + recency) with ranked results identical to a reference engine
  built through the standard bulk_load with materialized f32 rows;
- CompactMeta materializes correct ChunkRecords lazily;
- the compact index is serving-only (append raises).
"""

from __future__ import annotations

import numpy as np
import pytest

from omni_recall_tpu.index import compact

N = 1 << 15
D = 128


@pytest.fixture(scope="module")
def built():
    engine, make_requests, now, n_clusters = compact.build_compact_engine(
        N, D, slab=1 << 13
    )
    return engine, make_requests, now, n_clusters


def test_host_device_generation_bit_identical(built):
    engine, _, _, _ = built
    dix = engine.device_index
    dev_emb8 = np.asarray(dix.device_arrays().emb)
    assert dev_emb8.dtype == np.int8
    assert np.array_equal(dev_emb8, dix.emb8_host)
    # and the scale/err/created planes are the uploaded host columns
    assert np.array_equal(np.asarray(dix.device_arrays().scale), dix.scale_host)
    assert np.array_equal(np.asarray(dix.device_arrays().created), dix.created)


def test_compact_meta_materializes_records(built):
    engine, _, _, n_clusters = built
    dix = engine.device_index
    meta = dix.meta
    assert len(meta) == N
    r = 12345
    rec = meta[r]
    assert rec.id == f"bulk:{r:08d}"
    assert rec.chunk_index == r and rec.seq == r
    cid = compact.row_ids_np(r, r + 1, n_clusters, 4096)[0][0]
    assert rec.content == compact.cluster_contents(n_clusters)[cid]
    want = dix.emb8_host[r].astype(np.float32) * dix.scale_host[r]
    assert np.array_equal(np.asarray(rec.embedding, dtype=np.float32), want)
    from omni_recall_tpu.index.device_index import to_micros

    assert to_micros(rec.created_at_utc) == dix.created_us[r]
    # slices work (dim-mismatch fallback path)
    assert [c.id for c in meta[5:8]] == [f"bulk:{i:08d}" for i in range(5, 8)]


def test_serving_only_guards(built):
    engine, _, _, _ = built
    from omni_recall_tpu.index.records import ChunkRecord

    with pytest.raises(RuntimeError, match="serving-only"):
        engine.device_index.append(
            [ChunkRecord(id="x", document_id="d", chunk_index=0, content="c")]
        )


def _reference_engine(compact_engine):
    """Standard-path engine over the SAME data: materialized f32 rows +
    real per-row records through bulk_load."""
    from omni_recall_tpu.config import EngineOptions
    from omni_recall_tpu.index.records import ChunkRecord, DocumentRecord
    from omni_recall_tpu.index.store import InMemoryIngestionStore
    from omni_recall_tpu.search.engine import RecallEngine

    dix = compact_engine.device_index
    opts = compact_engine.options
    ref_opts = EngineOptions(**{**opts.__dict__})
    store = InMemoryIngestionStore()
    store.upsert_document(DocumentRecord(id="bulk", file_name="bulk.txt"))
    ref = RecallEngine(store, options=ref_opts)
    emb = dix.emb8_host.astype(np.float32) * dix.scale_host[:, None]
    meta = [dix.meta[i] for i in range(N)]
    for m, row in zip(meta, emb):
        m.embedding = row  # exact f32 rows, zero-copy views
    bloom = np.asarray(dix.device_arrays().bloom)
    ref.device_index.bulk_load(
        np.ascontiguousarray(emb), np.asarray(bloom), dix.created.copy(), meta
    )
    return ref


def test_hybrid_serving_matches_standard_engine(built):
    engine, make_requests, now, _ = built
    ref = _reference_engine(engine)
    reqs = make_requests(3, 16, kw_frac=0.5)
    out_c = engine.search_batch(reqs, now=now)
    out_r = ref.search_batch(reqs, now=now)
    assert sum(len(h) for h in out_c) == 16 * 10
    for hc, hr in zip(out_c, out_r):
        assert [h.chunk.id for h in hc] == [h.chunk.id for h in hr]
        for a, b in zip(hc, hr):
            # identical ranking; scores agree to the documented storage
            # contract: compact raw_norm_sq = scale^2 * S2 differs from the
            # reference's sum(fl32(q8*scale)^2) by O(2^-24) relative per
            # element -> cosine deviates O(1e-7) relative, absorbed by the
            # 3e-7 err_row slack (index/compact.py soundness note)
            assert a.score == pytest.approx(b.score, rel=2e-7)


def test_hybrid_keyword_term_is_live(built):
    """The keyword term must actually contribute: a query whose text names
    the target cluster outranks the same embedding without it."""
    engine, _, now, n_clusters = built
    c = 7
    base = None
    from omni_recall_tpu.index import compact as _c

    center8, _ = _c.make_tables(n_clusters, D)
    base = center8[c].astype(np.float32)
    base /= np.linalg.norm(base)
    with_kw = engine.search_batch(
        [(f"c{c:07d}x topic", base, 5)], now=now
    )[0]
    without = engine.search_batch([("zz qq", base, 5)], now=now)[0]
    token = f"c{c:07d}x"
    assert token in with_kw[0].chunk.content
    # same top chunk, strictly higher score with the matching keyword
    assert with_kw[0].score > without[0].score


def test_make_tables_rejects_non_power_of_two_noise():
    """Row derivation masks the noise id with noise_k - 1, which only
    spans every noise row when noise_k is a power of two."""
    with pytest.raises(ValueError, match="power of two"):
        compact.make_tables(16, 8, noise_k=3000)
    center8, noise8 = compact.make_tables(16, 8, noise_k=64)
    assert noise8.shape == (64, 8)
