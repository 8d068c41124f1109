"""Cluster-structured synthetic corpus at serving scale, and a float64
oracle over it.

Real corpora have topic structure; isotropic noise would make every score
a near-tie and (correctly) drive the exactness certificate to full scans.
Rows here belong to clusters of ~64 (cluster density held constant across
sizes: a cluster larger than candidate_m makes every query structurally
escalate). Embeddings come from the deterministic integer recipe of
index/compact.py (rows = fl32(int8 row * scale)), chunk contents carry
their cluster token, and blooms are the real signatures of those contents,
so the device keyword bound is sound and tight against the host rescore.
Shared by bench.py and chip_smoke.py; everything derives from ``seed``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import datetime, timedelta

import numpy as np

from omni_recall_tpu.config import EngineOptions
from omni_recall_tpu.index import compact as compact_mod
from omni_recall_tpu.index.device_index import EPOCH, to_micros
from omni_recall_tpu.index.records import ChunkRecord
from omni_recall_tpu.index.store import InMemoryIngestionStore
from omni_recall_tpu.ingest.embedding import EmbeddingResult, EmbeddingStatus
from omni_recall_tpu.models import hash_embedder
from omni_recall_tpu.ops import hashing, oracle
from omni_recall_tpu.search.engine import RecallEngine, SearchHit, _sort_key

DAYS = 365.0  # the corpus spans one year; "now" is its last day


@dataclass
class Corpus:
    n: int
    n_clusters: int
    emb: np.ndarray          # f32[n, d] unit rows (host mirror)
    assign: np.ndarray       # i64[n] cluster of each row
    contents: list[str]      # per cluster
    centers: np.ndarray      # f32[n_clusters, d] unit query centres
    created_us: np.ndarray   # i64[n]
    now: datetime
    meta: list[ChunkRecord]  # the bulk-loaded records, row order

    def cluster_token(self, cluster: int) -> str:
        return f"c{cluster:05d}x"


def _contents(n_clusters: int) -> list[str]:
    # fixed width (zero-padded id) so the lowercased arena builds as one
    # vectorized gather; queries carry the same token
    return [f"topic c{cid:05d}x synthetic chunk" for cid in range(n_clusters)]


def build_engine(options: EngineOptions, n: int, seed: int = 0, mesh=None):
    """A RecallEngine over an n-row corpus built with ``options`` (bulk
    loaded: rows in (created, seq) order, the store stays empty — uploads
    through the app add to both). Returns (engine, corpus)."""
    d = options.embedding_dim
    n_clusters = max(4096, n // 64)
    center8, noise8 = compact_mod.make_tables(n_clusters, d, seed=seed, spread=True)
    noise_k = noise8.shape[0]
    emb = np.empty((n, d), dtype=np.float32)
    s2 = np.empty(n, dtype=np.float32)
    assign = np.empty(n, dtype=np.int64)
    slab = 1 << 16
    for s0 in range(0, n, slab):
        s1 = min(n, s0 + slab)
        cid, nid = compact_mod.row_ids_np(s0, s1, n_clusters, noise_k)
        q8 = np.take(center8, cid, axis=0, mode="clip")
        q8 += np.take(noise8, nid, axis=0, mode="clip")  # wrap-free
        e = emb[s0:s1]
        np.copyto(e, q8, casting="unsafe")  # int8 -> f32, exact
        np.einsum("ij,ij->i", e, e, out=s2[s0:s1])  # exact (< 2^24)
        assign[s0:s1] = cid
    scale = (1.0 / np.sqrt(np.where(s2 > 0, s2, 1.0).astype(np.float64))).astype(
        np.float32
    )
    emb *= scale[:, None]  # rows = fl32(q8 * scale), unit norm +- 1e-7
    centers = center8.astype(np.float32)
    centers /= np.sqrt(np.einsum("ij,ij->i", centers, centers))[:, None]

    contents = _contents(n_clusters)
    # 3-decimal days: the record datetimes are built from the ROUNDED value,
    # so the device created column encodes the same instant
    created_days = np.round(np.linspace(0.0, DAYS, n), 3).astype(np.float32)
    millidays = np.round(created_days.astype(np.float64) * 1000.0).astype(np.int64)
    created_us = to_micros(EPOCH) + millidays * 86_400_000
    day_cache: dict[int, datetime] = {}
    meta = []
    for i in range(n):
        md = int(millidays[i])
        when = day_cache.get(md)
        if when is None:
            when = day_cache[md] = EPOCH + timedelta(microseconds=md * 86_400_000)
        meta.append(ChunkRecord(
            id=f"s:{i}", document_id="synthetic", chunk_index=i,
            content=contents[assign[i]], embedding=emb[i],
            created_at_utc=when, seq=i,
        ))
    # vectorized bulk_load columns: millidays * 86_400_000 is the exact
    # integer microseconds of each record's datetime, and timestamp() is
    # f64(total_us) / 1e6, so both equal the record-derived values
    fixed = np.array(contents, dtype="S")
    aux = {
        "created_us": created_us,
        "created_ts": created_us.astype(np.float64) / 1e6,
        "seqs": np.arange(n, dtype=np.int64),
        "lower_arena": fixed[assign].tobytes(),
        "lower_off": np.arange(n + 1, dtype=np.int64) * fixed.dtype.itemsize,
    }
    engine = RecallEngine(InMemoryIngestionStore(), options=options, mesh=mesh)
    dix = engine.device_index
    # signatures MUST use the index's exact bloom parameters, or the device
    # keyword score is not a sound upper bound
    from omni_recall_tpu.ops import native

    sigs = native.chunk_signatures(
        [c.lower().encode() for c in contents],
        dix.bloom_bits, dix.ngram, dix.bloom_hashes,
    )
    if sigs is None:
        sigs = np.stack([
            hashing.chunk_signature(c.lower(), dix.bloom_bits, dix.ngram,
                                    dix.bloom_hashes)
            for c in contents
        ])
    dix.bulk_load(emb, sigs[assign], created_days, meta, aux=aux)
    dix.device_arrays()
    corpus = Corpus(
        n=n, n_clusters=n_clusters, emb=emb, assign=assign, contents=contents,
        centers=centers, created_us=created_us,
        now=EPOCH + timedelta(days=DAYS), meta=meta,
    )
    return engine, corpus


def make_requests(corpus: Corpus, seed: int, nb: int, k: int = 10,
                  noise: float = 0.2):
    """Hybrid requests (text, embedding, k): each targets a cluster centre
    plus noise, and its text is the cluster token, so keyword and cosine
    scores discriminate like real retrieval."""
    r = np.random.default_rng(seed)
    d = corpus.emb.shape[1]
    reqs = []
    for _ in range(nb):
        cluster = int(r.integers(corpus.n_clusters))
        qn = r.standard_normal(d).astype(np.float32)
        qn /= np.linalg.norm(qn)
        q = corpus.centers[cluster] + np.float32(noise) * qn
        q /= np.linalg.norm(q)
        reqs.append((corpus.cluster_token(cluster), q, k))
    return reqs


class CorpusEmbeddingClient:
    """Embedding provider for serving the synthetic corpus over HTTP: a
    query that is a cluster token embeds to that cluster's centre (so the
    hybrid certificate resolves on device); any other text gets the
    deterministic hash embedding (models/hash_embedder.py)."""

    def __init__(self, corpus: Corpus) -> None:
        self.corpus = corpus
        self.dim = corpus.emb.shape[1]

    def embed(self, text: str) -> EmbeddingResult:
        t = text.strip()
        if len(t) == 7 and t[0] == "c" and t[-1] == "x" and t[1:6].isdigit():
            cluster = int(t[1:6])
            if cluster < self.corpus.n_clusters:
                vec = self.corpus.centers[cluster].tolist()
                return EmbeddingResult(vec, EmbeddingStatus.SUCCESS, model="corpus")
        vec = hash_embedder.embed_text(text, self.dim)
        if not vec:
            return EmbeddingResult([], EmbeddingStatus.EMPTY, model="corpus")
        return EmbeddingResult(vec, EmbeddingStatus.SUCCESS, model="corpus")


# |f32 BLAS dot - exact dot| <= d * 2^-24 * |q||c| ~ 5e-5 for unit rows at
# d=768; the prefilter keeps every row within 40x that of the kth score
_PREFILTER_MARGIN = 2e-3


def oracle_search(corpus: Corpus, extra: list[ChunkRecord], query: str,
                  q_emb, k: int, window: int, now: datetime) -> list[SearchHit]:
    """The float64 oracle (ops/oracle.py semantics) over every corpus row
    plus ``extra`` chunks (uploads): cosine as float32 products accumulated
    in float64, keyword per distinct content, recency per row; the
    ``window`` most recent chunks are candidates (<= 0: all). Returns the
    top-k hits in the engine's order.

    A float32 matrix-vector pass first discards the rows whose score is
    more than _PREFILTER_MARGIN below the approximate kth (no such row can
    reach the exact kth); the survivors get the exact float64 scores."""
    n = corpus.n
    lo = 0
    if window > 0:
        lo = max(0, n - max(0, window - len(extra)))
        extra = sorted(extra, key=lambda c: (c.created_at_utc, c.seq))[-window:]
    kw_cluster = np.array(
        [oracle.keyword_score(query, c) for c in corpus.contents], dtype=np.float64
    )
    age_days = np.maximum(
        0.0, ((to_micros(now) - corpus.created_us[lo:]) / 1e6) / 86400.0
    )
    base = (oracle.KEYWORD_WEIGHT * kw_cluster[corpus.assign[lo:]]
            + oracle.RECENCY_WEIGHT * np.exp(-age_days / oracle.RECENCY_HALF_LIFE_DAYS))
    use_cos = q_emb is not None and len(q_emb) == corpus.emb.shape[1]
    if use_cos:
        qv = np.asarray(q_emb, dtype=np.float32)
        qn = float(np.sum((qv * qv).astype(np.float64)))
        approx = base + oracle.COSINE_WEIGHT * (
            (corpus.emb[lo:] @ qv) / max(math.sqrt(qn), 1e-30)
        )
        kk = min(k, len(approx))
        kth = np.partition(approx, -kk)[-kk] if kk else np.inf
        rows = lo + np.nonzero(approx >= kth - _PREFILTER_MARGIN)[0]
        c = corpus.emb[rows]
        dot = np.sum((c * qv).astype(np.float64), axis=1)
        nb = np.sum((c * c).astype(np.float64), axis=1)
        ok = (nb > 0.0) & (qn > 0.0)
        cos = np.where(
            ok, dot / (math.sqrt(qn) * np.sqrt(np.where(ok, nb, 1.0))), 0.0
        )
        scores = base[rows - lo] + oracle.COSINE_WEIGHT * cos
    else:
        rows = np.arange(lo, n)
        scores = base
    # every row tied with the kth score takes part in the tie-break
    kk = min(k, len(scores))
    kth = np.partition(scores, -kk)[-kk] if kk else np.inf
    hits = []
    for i in np.nonzero(scores >= kth)[0]:
        r = int(rows[i])
        hits.append(SearchHit(corpus.meta[r], float(scores[i])))
    for c in extra:
        hits.append(SearchHit(c, oracle.score_chunk(
            query, q_emb, c.embedding, c.content, c.created_at_utc, now)))
    hits.sort(key=_sort_key)
    return hits[:k]
