"""Native hybrid rescorer: bit-parity vs the numpy reference path.

The native path (native/keyword_scorer.c hybrid_rescore) must produce
bit-identical scores and orderings to the numpy fallback inside
engine._exact_rescore_rows for arbitrary corpora — including unicode
contents, missing/mismatched embeddings, empty queries, and knife-edge
ties — because the exactness certificate and cross-backend parity both
assume a single canonical scorer.
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
from omni_recall_tpu.ops import native
from omni_recall_tpu.search.engine import RecallEngine

T0 = datetime(2026, 8, 1, tzinfo=timezone.utc)
NOW = datetime(2026, 8, 16, tzinfo=timezone.utc)
DIM = 48

pytestmark = pytest.mark.skipif(
    not native.rescore_available(), reason="native rescorer unavailable"
)


def test_pairwise_dot_matches_numpy_across_shapes():
    rng = np.random.default_rng(7)
    import ctypes

    lib = native._load()
    for n in list(range(1, 40)) + [64, 96, 127, 128, 129, 200, 768, 769, 3071]:
        a = (rng.standard_normal(n) * rng.uniform(1e-3, 1e3)).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        out = ctypes.c_double()
        lib.pairwise_dot_f64(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, ctypes.byref(out),
        )
        want = float(np.sum(a * b, dtype=np.float64))
        assert out.value == want, n


def _fuzz_engine(rng, n=120):
    store = InMemoryIngestionStore()
    opts = EngineOptions(
        backend="xla", embedding_dim=DIM, recent_window=0,
        candidate_m=16, bloom_bits=128, capacity_block=128,
    )
    engine = RecallEngine(store, options=opts)
    store.upsert_document(DocumentRecord(id="d", file_name="d", created_at_utc=T0))
    vocab = ["gpu", "kernel", "récall", "memoria", "深層", "data"] + [
        "".join(rng.choices(string.ascii_lowercase, k=rng.randint(2, 8)))
        for _ in range(30)
    ]
    chunks = []
    for i in range(n):
        content = " ".join(rng.choices(vocab, k=rng.randint(1, 25)))
        r = rng.random()
        if r < 0.15:
            emb = None
        elif r < 0.25:
            emb = hash_embedder.embed_text(content, DIM + 5)  # mismatched dim
        else:
            emb = hash_embedder.embed_text(content, DIM)
        chunks.append(
            ChunkRecord(
                id=f"d:{i:04d}", document_id="d", chunk_index=i,
                content=content, embedding=emb,
                created_at_utc=T0 + timedelta(seconds=i * 7),
            )
        )
    store.upsert_chunks(chunks)
    engine.on_chunks_upserted(chunks, new=True)
    return engine, vocab


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_rescore_bit_identical_to_numpy(seed):
    rng = random.Random(seed)
    engine, vocab = _fuzz_engine(rng)
    nrng = np.random.default_rng(seed)

    queries = []
    row_lists = []
    for _ in range(12):
        qtext = " ".join(rng.choices(vocab + ["the", "and"], k=rng.randint(0, 5)))
        r = rng.random()
        if r < 0.3:
            qemb = None
        elif r < 0.4:
            qemb = [0.0] * DIM  # zero-norm
        else:
            qemb = hash_embedder.embed_text(qtext or "x", DIM)
        queries.append((qtext, qemb))
        row_lists.append(nrng.integers(0, engine.device_index.n_rows, size=20))

    got = engine._exact_rescore_rows(queries, row_lists, NOW)
    native._rescore_verified = False
    try:
        want = engine._exact_rescore_rows(queries, row_lists, NOW)
    finally:
        native._rescore_verified = True
    for (gr, gs), (wr, ws) in zip(got, want):
        assert np.array_equal(gr, wr)
        assert np.array_equal(gs, ws)


def test_native_rescore_after_delete_and_update():
    rng = random.Random(9)
    engine, vocab = _fuzz_engine(rng)
    dix = engine.device_index
    # delete a slice of rows, update an embedding, then rescore remaining
    engine.on_document_deleted("nonexistent")
    dix.update_embedding("d:0005", hash_embedder.embed_text("fresh", DIM))
    live_rows = np.asarray(
        [r for r in range(dix.n_rows) if dix.meta[r] is not None][:30],
        dtype=np.int64,
    )
    q = [("gpu kernel", hash_embedder.embed_text("gpu kernel", DIM))]
    got = engine._exact_rescore_rows(q, [live_rows], NOW)
    native._rescore_verified = False
    try:
        want = engine._exact_rescore_rows(q, [live_rows], NOW)
    finally:
        native._rescore_verified = True
    assert np.array_equal(got[0][1], want[0][1])


def test_native_int8_rescore_bit_identical_to_numpy_materialized():
    """Compact host store (index/compact.py): the native int8 rescorer's
    workers dequantize fl32(e8 * scale) rows in C scratch; scores must be
    BIT-identical to the numpy chain the engine's compact fallback runs
    (materialize rows -> f32 products -> pairwise f64 sum)."""
    import numpy as np

    from omni_recall_tpu.ops import oracle

    if not native.rescore_available():
        import pytest

        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(77)
    n, d, nq, t = 400, 768, 8, 24
    emb8 = rng.integers(-112, 113, size=(n, d)).astype(np.int8)
    scale = (1.0 / np.sqrt(
        np.einsum("ij,ij->i", emb8.astype(np.float64), emb8.astype(np.float64))
    )).astype(np.float32)
    raw = emb8.astype(np.float32) * scale[:, None]
    norm_sq = np.einsum(
        "ij,ij->i", raw.astype(np.float64), raw.astype(np.float64)
    )
    contents = [f"c{i % 13:04d}x filler words".encode() for i in range(n)]
    arena = b"".join(contents)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(c) for c in contents], out=off[1:])
    q = rng.standard_normal((nq, d)).astype(np.float32)
    qn = np.einsum("ij,ij->i", q.astype(np.float64), q.astype(np.float64))
    rows = rng.integers(0, n, size=nq * t).astype(np.int64)
    owner = np.repeat(np.arange(nq), t).astype(np.int64)
    term_lists = [[f"c{i % 13:04d}x", "filler"] for i in range(nq)]
    flat = [tm.encode() for terms in term_lists for tm in terms]
    term_off = np.zeros(len(flat) + 1, dtype=np.int64)
    np.cumsum([len(t_) for t_ in flat], out=term_off[1:])
    q_term_off = np.arange(nq + 1, dtype=np.int64) * 2

    got = native.hybrid_rescore_int8(
        emb8, scale, norm_sq, arena, off, rows, owner, q, qn,
        b"".join(flat), term_off, q_term_off,
    )
    assert got is not None
    # numpy chain: exactly what engine._exact_rescore_rows' compact
    # fallback computes (and what the f32-mirror native path computes on
    # the materialized rows)
    sel = emb8[rows].astype(np.float32) * scale[rows, None]
    dot = np.sum(sel * q[owner], axis=1, dtype=np.float64)
    cos = dot / (np.sqrt(qn[owner]) * np.sqrt(norm_sq[rows]))
    kw = np.zeros(len(rows))
    for i, r in enumerate(rows):
        terms = term_lists[owner[i]]
        c = contents[r].decode()
        kw[i] = sum(tm in c for tm in terms) / len(terms)
    want = oracle.COSINE_WEIGHT * cos + oracle.KEYWORD_WEIGHT * kw
    assert np.array_equal(got, want)
