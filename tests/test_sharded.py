"""Multi-chip sharded search parity on an 8-device (virtual CPU) mesh.

The sharded path (per-shard top-k + all-gather merge) must return exactly
the same ranking as the single-device path and the host oracle — the
determinism requirement from SURVEY.md §5 (fixed shard->chunk assignment,
stable tie-breaks)."""

import os
import random
import string
from datetime import datetime, timedelta, timezone

import jax
import pytest

from omni_recall_tpu.config import EngineOptions
from omni_recall_tpu.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu.index.store import InMemoryIngestionStore
from omni_recall_tpu.models import hash_embedder
from omni_recall_tpu.parallel.mesh import shards_mesh
from omni_recall_tpu.search.engine import RecallEngine

DIM = 32
T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return shards_mesh(8)


def _corpus(n, rng, store):
    vocab = ["".join(rng.choices(string.ascii_lowercase, k=rng.randint(2, 8))) for _ in range(60)]
    store.upsert_document(DocumentRecord(id="d", file_name="d.txt", created_at_utc=T0))
    chunks = []
    for i in range(n):
        content = " ".join(rng.choices(vocab, k=rng.randint(4, 25)))
        emb = hash_embedder.embed_text(content, DIM) if rng.random() > 0.1 else None
        chunks.append(
            ChunkRecord(
                id=f"d:{i:04d}", document_id="d", chunk_index=i, content=content,
                embedding=emb, created_at_utc=T0 + timedelta(minutes=i),
            )
        )
    store.upsert_chunks(chunks)
    return vocab, chunks


def _engines(mesh, window=300, candidate_m=8):
    store = InMemoryIngestionStore()
    sharded = RecallEngine(
        store,
        options=EngineOptions(
            backend="xla", embedding_dim=DIM, capacity_block=128,
            recent_window=window, candidate_m=candidate_m, bloom_bits=256,
        ),
        mesh=mesh,
    )
    oracle = RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=window))
    single = RecallEngine(
        store,
        options=EngineOptions(
            backend="xla", embedding_dim=DIM, capacity_block=128,
            recent_window=window, candidate_m=candidate_m, bloom_bits=256,
        ),
    )
    return store, sharded, single, oracle


def test_sharded_matches_single_and_oracle(mesh):
    rng = random.Random(21)
    store, sharded, single, oracle = _engines(mesh)
    vocab, chunks = _corpus(200, rng, store)
    sharded.on_chunks_upserted(chunks, new=True)
    single.on_chunks_upserted(chunks, new=True)

    assert sharded.device_index.capacity_block % 8 == 0

    for trial in range(12):
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 3)))
        q_emb = hash_embedder.embed_text(query, DIM)
        top_k = rng.choice([1, 5, 10])
        hits_sh = sharded.search(query, q_emb, top_k, now=NOW)
        hits_si = single.search(query, q_emb, top_k, now=NOW)
        hits_or = oracle.search(query, q_emb, top_k, now=NOW)
        ids_sh = [h.chunk.id for h in hits_sh]
        assert ids_sh == [h.chunk.id for h in hits_si]
        assert ids_sh == [h.chunk.id for h in hits_or]
        for a, b in zip(hits_sh, hits_or):
            assert a.score == b.score


def test_sharded_escalation_still_exact(mesh):
    rng = random.Random(33)
    store, sharded, single, oracle = _engines(mesh, candidate_m=2)
    vocab, chunks = _corpus(120, rng, store)
    sharded.on_chunks_upserted(chunks, new=True)
    query = " ".join(rng.choices(vocab, k=2))
    q_emb = hash_embedder.embed_text(query, DIM)
    hits = sharded.search(query, q_emb, 10, now=NOW)
    expected = oracle.search(query, q_emb, 10, now=NOW)
    assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]


def test_sharded_window_and_delete(mesh):
    rng = random.Random(55)
    store, sharded, single, oracle = _engines(mesh, window=100)
    vocab, chunks = _corpus(150, rng, store)
    sharded.on_chunks_upserted(chunks, new=True)
    store.delete_document("d")  # delete everything, re-add fresh docs
    sharded.on_document_deleted("d")
    store.upsert_document(DocumentRecord(id="e", file_name="e.txt", created_at_utc=T0))
    fresh = [
        ChunkRecord(id=f"e:{i:04d}", document_id="e", chunk_index=i,
                    content=" ".join(rng.choices(vocab, k=10)),
                    embedding=hash_embedder.embed_text(f"fresh {i}", DIM),
                    created_at_utc=T0 + timedelta(days=1, minutes=i))
        for i in range(40)
    ]
    store.upsert_chunks(fresh)
    sharded.on_chunks_upserted(fresh, new=True)
    query = " ".join(rng.choices(vocab, k=2))
    q_emb = hash_embedder.embed_text(query, DIM)
    hits = sharded.search(query, q_emb, 5, now=NOW)
    expected = oracle.search(query, q_emb, 5, now=NOW)
    assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]
    assert all(h.chunk.document_id == "e" for h in hits)


@pytest.mark.parametrize("scan_dtype", ["f32", "int8"])
def test_sharded_pallas_kernel_matches_oracle(mesh, scan_dtype):
    rng = random.Random(77)
    store = InMemoryIngestionStore()
    sharded = RecallEngine(
        store,
        options=EngineOptions(
            backend="pallas", embedding_dim=DIM, capacity_block=1024,
            recent_window=0, candidate_m=8, bloom_bits=256,
            scan_dtype=scan_dtype,
        ),
        mesh=mesh,
    )
    oracle = RecallEngine(store, None, EngineOptions(backend="oracle", recent_window=0))
    vocab, chunks = _corpus(300, rng, store)
    sharded.on_chunks_upserted(chunks, new=True)
    assert sharded.device_index.scan_dtype == scan_dtype

    for trial in range(6):
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 3)))
        q_emb = hash_embedder.embed_text(query, DIM)
        hits = sharded.search(query, q_emb, 5, now=NOW)
        expected = oracle.search(query, q_emb, 5, now=NOW)
        assert [h.chunk.id for h in hits] == [h.chunk.id for h in expected]
        for a, b in zip(hits, expected):
            assert a.score == b.score

    # the int8 slice scan (not a fallback) must actually have run in
    # shard_map; f32 storage is served by the exact XLA pass
    expected = {"cos_kw", "cos", "kw"} if scan_dtype == "int8" else {"xla"}
    assert any(key[0] in expected for key in sharded._sharded_scorer._fns)


def test_multihost_initialize_noop_when_unconfigured(monkeypatch):
    from omni_recall_tpu.parallel.distributed import initialize_multihost

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    initialize_multihost()  # must be a harmless no-op on a single host


def test_sharded_merge_at_10m_rows(mesh):
    """BASELINE configs[4] scale proof on the virtual mesh: the per-shard
    top-k + all-gather merge and the global window threshold are validated
    at 10M rows (small dim keeps the CPU run tractable; the kernel math is
    row-count independent). The sharded result must equal the single-device
    XLA scorer on the same global arrays."""
    import numpy as np
    import jax.numpy as jnp

    from omni_recall_tpu.ops import xla_scorer
    from omni_recall_tpu.parallel.sharded import ShardedScorer

    # the run peaks around ~8 GiB of host buffers; skip on small machines
    try:
        avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        avail = 1 << 62
    if avail < 16 * (1 << 30):
        pytest.skip("needs >=16 GiB available RAM")

    n, d, bits, b, m = 10 * (1 << 20), 8, 64, 2, 16
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    bloom = rng.integers(0, 256, size=(n, bits // 8), dtype=np.uint8)
    created = np.linspace(0.0, 365.0, n).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[rng.integers(0, n, size=1000)] = False  # scattered tombstones
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kw_w = np.zeros((b, bits), dtype=np.float32)
    kw_w[:, rng.integers(0, bits, size=6)] = 0.17
    kw_b = np.zeros(b, dtype=np.float32)
    now_days, r0 = jnp.float32(365.0), jnp.int32(n // 2 + 12345)  # window
    # starts mid-shard-4: exercises the global row offset in the mask

    ss = ShardedScorer(mesh)
    got_v, got_i = ss.score_topm(
        jnp.asarray(emb), jnp.asarray(bloom), jnp.asarray(created),
        jnp.asarray(valid), jnp.asarray(q), jnp.asarray(kw_w),
        jnp.asarray(kw_b), now_days, r0, m=m, mode="xla",
    )
    want_v, want_i = xla_scorer.score_topm(
        jnp.asarray(emb), jnp.asarray(bloom), jnp.asarray(created),
        jnp.asarray(valid), jnp.asarray(q), jnp.asarray(kw_w),
        jnp.asarray(kw_b), now_days, r0, m=m,
    )
    got_v, got_i = np.asarray(got_v), np.asarray(got_i)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    # same candidate VALUES in order; indices may permute only within exact
    # value ties, and every returned row must be in-window and valid
    assert np.array_equal(got_v[:, :m], want_v[:, :m])
    for qi in range(b):
        assert set(got_i[qi, :m]) == set(want_i[qi, :m]) or np.array_equal(
            np.sort(got_v[qi, :m]), np.sort(want_v[qi, :m])
        )
        assert (got_i[qi, :m] >= int(r0)).all()
        assert valid[got_i[qi, :m]].all()
    # boundaries must agree (both bound the same excluded set)
    assert np.allclose(got_v[:, m], want_v[:, m], rtol=0, atol=0)


def _dd_engine_opts():
    return EngineOptions(
        backend="pallas", embedding_dim=DIM, capacity_block=1024,
        recent_window=0, candidate_m=8, bloom_bits=256, scan_dtype="int8",
        device_exact_cos=True,
    )


def test_sharded_refine_select_dd_matches_single_and_oracle(mesh):
    """Sharded compact serving (parallel/sharded.py refine_select_dd):
    refine + compact selection + device-exact cosine inside shard_map must
    serve the SAME ranked citations as the single-device DD path and the
    float64 oracle — including keyword-only queries (zero-DD marker) and
    certificate escalations."""
    rng = random.Random(33)
    store = InMemoryIngestionStore()
    sharded = RecallEngine(store, options=_dd_engine_opts(), mesh=mesh)
    single = RecallEngine(store, options=_dd_engine_opts())
    oracle = RecallEngine(
        store, None, EngineOptions(backend="oracle", recent_window=0)
    )
    vocab, chunks = _corpus(300, rng, store)
    sharded.on_chunks_upserted(chunks, new=True)
    single.on_chunks_upserted(chunks, new=True)
    assert sharded.device_index.exact_cos and sharded.device_index.refine
    assert sharded.device_index.device_arrays().raw is not None

    reqs = []
    for _ in range(24):
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 3)))
        emb = (
            hash_embedder.embed_text(query, DIM)
            if rng.random() > 0.25 else None
        )
        reqs.append((query, emb, 5))
    outs_s = sharded.search_batch(reqs, now=NOW)
    outs_1 = single.search_batch(reqs, now=NOW)
    outs_o = oracle.search_batch(reqs, now=NOW)
    for hs, h1, ho in zip(outs_s, outs_1, outs_o):
        assert [h.chunk.id for h in hs] == [h.chunk.id for h in ho]
        assert [h.score for h in hs] == [h.score for h in ho]
        assert [h.chunk.id for h in h1] == [h.chunk.id for h in ho]
    # the sharded compact stage must actually have run (not a fallback)
    assert any(
        k[0] == "refine_select_dd" for k in sharded._sharded_scorer._fns
    )


def test_sharded_refine_select_dd_op_bit_parity(mesh):
    """Op-level: the sharded refine/select output is BIT-identical to the
    single-device refine_select_from_scan (psum adds exact zeros; the
    owner's local refine is the same XLA program over the same row bits),
    and the DD triple matches exact_cos_rows on every live slot."""
    import numpy as np

    import jax.numpy as jnp

    from omni_recall_tpu.ops import exact_cos, hashing, refine

    rng = random.Random(5)
    store = InMemoryIngestionStore()
    sharded = RecallEngine(store, options=_dd_engine_opts(), mesh=mesh)
    single = RecallEngine(store, options=_dd_engine_opts())
    vocab, chunks = _corpus(260, rng, store)
    sharded.on_chunks_upserted(chunks, new=True)
    single.on_chunks_upserted(chunks, new=True)
    dev_s = sharded.device_index.device_arrays()
    dev_1 = single.device_index.device_arrays()

    b, m = 8, 8
    queries = [
        " ".join(rng.choices(vocab, k=rng.randint(1, 3))) for _ in range(b)
    ]
    q_raw = np.stack(
        [hash_embedder.embed_text(t, DIM) for t in queries]
    ).astype(np.float32)
    qn = np.sqrt(np.sum(q_raw.astype(np.float64) ** 2, axis=1))
    q = (q_raw / np.where(qn[:, None] > 0, qn[:, None], 1.0)).astype(
        np.float32
    )
    from omni_recall_tpu.ops import oracle as oracle_mod

    terms = [oracle_mod.query_terms(t) for t in queries]
    w, bias = hashing.query_bit_weights_batch(
        terms, sharded.device_index.bloom_bits,
        sharded.device_index.ngram, sharded.device_index.bloom_hashes,
    )
    w = w.astype(np.float32)
    bias = bias.astype(np.float32)
    now_days = np.float32(17.0)

    # one scan (single-device kernels) provides the candidate input; both
    # refine paths consume the identical [B, m+1] candidates
    scorer, _ = single._select_scorer(m, int(dev_1.emb.shape[0]))
    vals, idxs = scorer(
        dev_1, jnp.asarray(q), jnp.asarray(w), jnp.asarray(bias),
        jnp.asarray(now_days), jnp.int32(0), m,
    )
    vals_h, idxs_h = np.asarray(vals), np.asarray(idxs)

    t_out, r = 8, 8
    rows_1, ubs_1, bound_1 = refine.refine_select_from_scan(
        dev_1.emb, dev_1.scale, dev_1.emb2, dev_1.scale2, dev_1.err2,
        dev_1.bloom, dev_1.created, dev_1.valid,
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(bias),
        jnp.asarray(now_days), jnp.asarray(vals_h), jnp.asarray(idxs_h),
        t_out=t_out, r=r,
    )
    out = sharded._sharded_scorer.refine_select_dd(
        dev_s, jnp.asarray(q), jnp.asarray(w), jnp.asarray(bias),
        jnp.asarray(now_days), jnp.asarray(vals_h), jnp.asarray(idxs_h),
        t_out=t_out, r=r, q_raw=jnp.asarray(q_raw),
    )
    rows_s, ubs_s, bound_s, hi_s, lo_s, sabs_s = map(np.asarray, out)
    assert (rows_s == np.asarray(rows_1)).all()
    assert (np.asarray(ubs_1) == ubs_s).all()
    assert (np.asarray(bound_1) == bound_s).all()

    hi_1, lo_1, sabs_1 = map(
        np.asarray,
        exact_cos.exact_cos_rows(
            dev_1.raw, jnp.asarray(rows_s), jnp.asarray(q_raw)
        ),
    )
    live = (rows_s >= 0) & (ubs_s > -np.inf)
    assert (hi_s[live] == hi_1[live]).all()
    assert (lo_s[live] == lo_1[live]).all()
    assert (sabs_s[live] == sabs_1[live]).all()


def test_sharded_serving_dd_at_10m_rows(mesh):
    """BASELINE configs[4] as a SERVED system (VERDICT r3 #4): the sharded
    compact serving stage — refine + compact selection + device-exact
    cosine inside shard_map — validated at 10M rows on the virtual mesh,
    bit-identical to the single-device ops. Small dim keeps the CPU run
    tractable; the op math is row-count independent, but the global->local
    row mapping, the psum exact-zero combine, and the owner gathers are
    exactly what 10M sharded serving exercises."""
    import numpy as np
    import jax.numpy as jnp

    from omni_recall_tpu.index.device_index import (
        DeviceArrays,
        _device_quantize_keep,
    )
    from omni_recall_tpu.ops import exact_cos as _ec
    from omni_recall_tpu.ops import refine as _refine
    from omni_recall_tpu.parallel.sharded import ShardedScorer

    try:
        avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        avail = 1 << 62
    if avail < 16 * (1 << 30):
        pytest.skip("needs >=16 GiB available RAM")

    n, d, bits, b, m, t_out, r = 10 * (1 << 20), 8, 64, 2, 16, 8, 16
    rng = np.random.default_rng(7)
    raw = rng.standard_normal((n, d)).astype(np.float32)
    raw /= np.linalg.norm(raw, axis=1, keepdims=True)
    raw_dev = jnp.asarray(raw)
    del raw
    conv = _device_quantize_keep(raw_dev, True)
    bloom = jnp.asarray(
        rng.integers(0, 256, size=(n, bits // 8), dtype=np.uint8)
    )
    created = jnp.linspace(0.0, 365.0, n, dtype=jnp.float32)
    valid = jnp.ones((n,), dtype=bool)
    dev = DeviceArrays(
        emb=conv["emb"], bloom=bloom, created=created, valid=valid,
        scale=conv["scale"], err=conv["err"], emb2=conv["emb2"],
        scale2=conv["scale2"], err2=conv["err2"], raw=raw_dev,
    )

    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q = jnp.asarray(q)
    q_raw = q * jnp.float32(1.7)
    kw_w = np.zeros((b, bits), dtype=np.float32)
    kw_w[:, rng.integers(0, bits, size=4)] = 0.25
    kw_w = jnp.asarray(kw_w)
    kw_b = jnp.zeros((b,), dtype=jnp.float32)
    now_days = jnp.float32(365.0)

    # synthesized scan output: distinct rows spread across ALL shards,
    # bounds sorted descending, boundary entry at position m (the
    # refine/select contract — ops/merge.py top_k_with_payload order)
    idxs = np.stack([
        rng.choice(n, size=m, replace=False).astype(np.int32)
        for _ in range(b)
    ])
    vals = np.sort(
        rng.uniform(0.3, 0.9, size=(b, m)).astype(np.float32), axis=1
    )[:, ::-1]
    vals_full = jnp.asarray(
        np.concatenate([vals, np.full((b, 1), 0.25, np.float32)], axis=1)
    )
    idxs_full = jnp.asarray(
        np.concatenate([idxs, np.full((b, 1), -1, np.int32)], axis=1)
    )

    ss = ShardedScorer(mesh)
    rs, us, bs, hi, lo, sa = map(np.asarray, ss.refine_select_dd(
        dev, q, kw_w, kw_b, now_days, vals_full, idxs_full,
        t_out=t_out, r=r, q_raw=q_raw,
    ))
    r1, u1, b1 = map(np.asarray, _refine.refine_select_from_scan(
        dev.emb, dev.scale, dev.emb2, dev.scale2, dev.err2, dev.bloom,
        dev.created, dev.valid, q, kw_w, kw_b, now_days,
        vals_full, idxs_full, t_out=t_out, r=r,
    ))
    hi1, lo1, sa1 = map(np.asarray, _ec.exact_cos_rows(
        dev.raw, jnp.asarray(r1), q_raw
    ))
    assert np.array_equal(rs, r1)
    assert np.array_equal(us, u1)
    assert np.array_equal(bs, b1)
    live = (rs >= 0) & (us > -np.inf)
    assert np.array_equal(hi[live], hi1[live])
    assert np.array_equal(lo[live], lo1[live])
    assert np.array_equal(sa[live], sa1[live])
