"""Compact host store for very large bulk corpora (VERDICT r4 #4).

The standard DeviceIndex keeps f32/f64 host mirrors (raw_emb, per-chunk
python ChunkRecords, an id->row dict) that cost ~6 KB/chunk — ~60 GB at 10M
chunks, far outside the single-core host's in-bench budget. This module
provides the compact alternative used by the 10M certified HYBRID serving
config:

- the embedding column is the int8 plane itself (+ f32 scale): the store's
  embedding IS the quantized vector (a storage-precision contract, like
  bf16 storage in any production vector database) and the host
  materializes exact f32 rows on demand for the f64 rescore;
- timestamps are i64 micros / f32 days / f64 ts columns (24 B/chunk);
- contents live in the standard lowercased arena (native keyword rescorer
  reads it in place);
- chunk metadata is a LAZY sequence (CompactMeta) that builds ChunkRecord
  objects on access — the engine only ever touches the few selected rows
  per query, so 10M python objects are never constructed.

Total: ~850 B/chunk -> ~8.5 GB at 10M, built in a streamed slab loop.

Determinism contract for the synthetic corpus builder (build tables once on
the HOST, upload; per-row derivation is pure integer arithmetic): the host
slab loop (numpy) and the device fill (jnp) compute bit-identical int8
planes from the same tables, so no multi-GB embedding transfer ever
crosses the host<->device link — the host store is authoritative and the
device planes are PROVABLY the same bits (tests/test_compact_store.py
asserts equality row for row).

Soundness of the int8-backed embedding column: the scan kernel's
certificate treats the true row as a unit vector c with
||c - c_hat|| <= err_row, c_hat = dequantized q8*scale
(ops/scan.py prepare_int8_query). Here the host's exact score
normalizes the materialized row (cos = q.c_hat / (|q||c_hat|)), i.e. the
"true" row is c = c_hat/||c_hat||, and

    ||c - c_hat|| = | ||c_hat|| - 1 |.

The builder chooses scale = fl32(1/sqrt(S2)) with S2 = sum(q8^2) (exact
integer), so ||c_hat|| = 1 + O(2^-23), and stores
err_row = |sqrt(S2)*scale - 1| * 1.000001 + 3e-7 — a sound upper bound
that also covers the f32 elementwise rounding of q8*scale and the
raw_norm_sq shortcut below. raw_norm_sq is stored as (f64 scale)^2 * S2;
it differs from sum(fl32(q8*scale)^2) by at most ~2^-23 relative, which
the same 3e-7 slack absorbs.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np

from omni_recall_tpu.index.records import ChunkRecord

# micros per 3-decimal day step (0.001 day = 86.4 s exactly)
_US_PER_MILLIDAY = 86_400_000


class CompactMeta:
    """Lazy ChunkRecord sequence backed by the compact columns.

    Supports the engine's access patterns: len(), meta[int], meta[slice]
    (dim-mismatch fallback only), and `is not None` checks (every row of a
    compact bulk corpus is live; the index is serving-only and rejects
    delete/append, so no tombstones exist)."""

    def __init__(
        self,
        doc_id: str,
        emb8: np.ndarray,        # i8 [n, d]
        scale: np.ndarray,       # f32 [n]
        arena,                   # lowercased contents (bytes or bytearray)
        content_off: np.ndarray, # i64 [n+1]
        created_us: np.ndarray,  # i64 [n]
        epoch_us: int,
    ) -> None:
        self.doc_id = doc_id
        self._emb8 = emb8
        self._scale = scale
        self._arena = arena
        self._off = content_off
        self._created_us = created_us
        self._epoch_us = epoch_us
        self._n = int(emb8.shape[0])

    def __len__(self) -> int:
        return self._n

    def _one(self, r: int) -> ChunkRecord:
        from omni_recall_tpu.index.device_index import EPOCH

        content = self._arena[self._off[r] : self._off[r + 1]].decode(
            "utf-8", errors="surrogatepass"
        )
        # numpy row, NOT .tolist(): hit finalization materializes top-k
        # records per query, and a 768-element python float list per record
        # measured ~100x the cost of the array op (ChunkRecord.embedding
        # accepts arrays throughout — the bench corpus does the same)
        emb = self._emb8[r].astype(np.float32) * np.float32(self._scale[r])
        when = EPOCH + timedelta(
            microseconds=int(self._created_us[r]) - self._epoch_us
        )
        return ChunkRecord(
            id=f"{self.doc_id}:{r:08d}",
            document_id=self.doc_id,
            chunk_index=r,
            content=content,
            embedding=emb,
            created_at_utc=when,
            seq=r,
        )

    def __getitem__(self, key):
        if isinstance(key, slice):
            return [self._one(r) for r in range(*key.indices(self._n))]
        r = int(key)
        if r < 0:
            r += self._n
        if not 0 <= r < self._n:
            raise IndexError(r)
        return self._one(r)


# ---------------------------------------------------------------------------
# Deterministic synthetic corpus (benchmark/test builder)
# ---------------------------------------------------------------------------

# multiplicative-hash constant for the row -> cluster assignment (odd, so
# the map i -> i*K mod 2^32 is a bijection and clusters are well scattered)
_CID_MULT = np.uint32(2654435761)


def make_tables(
    n_clusters: int, d: int, noise_k: int = 4096, seed: int = 0,
    amp_center: int = 90, amp_noise: int = 22, spread: bool = False,
):
    """Small host-built tables (uploaded once): int8 cluster centers
    [C, d] and int8 noise rows [K, d]. All per-row derivation from these is
    integer arithmetic, identical on host and device.

    ``spread``: scale noise row k by a factor in [0.3, 1] (linear in k) so
    in-cluster radii VARY per row — real corpora have heterogeneous
    cluster tightness, and constant-radius clusters make the top-10 vs
    certificate-bound gap artificially uniform (the 1M e2e corpus keeps
    the r2-r4 0.2-0.8 spread character through this)."""
    # amplitude invariant: center + noise <= 127, so row derivation is a
    # single wrap-free int8 add (no int16 widening, no clip pass — at 10M
    # the widening alone costs ~10 s of host memory traffic)
    if amp_center + amp_noise > 127:
        raise ValueError("amp_center + amp_noise must stay <= 127")
    if noise_k < 1 or noise_k & (noise_k - 1):
        # row_ids_np/rows_jnp pick a noise row with a mask (& (noise_k-1))
        raise ValueError(f"noise_k must be a power of two, got {noise_k}")
    rng = np.random.default_rng(seed)
    center8 = rng.integers(
        -amp_center, amp_center + 1, size=(n_clusters, d), dtype=np.int16
    ).astype(np.int8)
    noise16 = rng.integers(
        -amp_noise, amp_noise + 1, size=(noise_k, d), dtype=np.int16
    )
    if spread:
        fac = 0.3 + 0.7 * np.arange(noise_k) / max(1, noise_k - 1)
        noise16 = np.rint(noise16 * fac[:, None]).astype(np.int16)
    noise8 = noise16.astype(np.int8)
    return center8, noise8


def row_ids_np(lo: int, hi: int, n_clusters: int, noise_k: int):
    """(cid, nid) for rows [lo, hi) — numpy side of the shared recipe."""
    i = np.arange(lo, hi, dtype=np.uint32)
    cid = (i * _CID_MULT) % np.uint32(n_clusters)
    nid = (i * np.uint32(40503) + np.uint32(2531)) & np.uint32(noise_k - 1)
    return cid.astype(np.int64), nid.astype(np.int64)


def rows_np(
    lo: int, hi: int, center8: np.ndarray, noise8: np.ndarray
) -> np.ndarray:
    """int8 rows [lo, hi) — numpy side. MUST stay the exact mirror of
    rows_jnp (integer ops only; tests assert bit-equality)."""
    cid, nid = row_ids_np(lo, hi, center8.shape[0], noise8.shape[0])
    # wrap-free by the make_tables amplitude invariant (|sum| <= 112)
    return center8[cid] + noise8[nid]


def rows_jnp(lo, size: int, center8_dev, noise8_dev, n_clusters: int,
             noise_k: int):
    """int8 rows [lo, lo+size) — device side of the shared recipe (jnp).
    Integer arithmetic only, bit-identical to rows_np by construction.
    ``size`` is static (one compile per slab shape); ``lo`` is traced."""
    import jax.numpy as jnp

    i = jnp.arange(size, dtype=jnp.uint32) + jnp.uint32(lo)
    cid = (i * _CID_MULT) % jnp.uint32(n_clusters)
    nid = (i * jnp.uint32(40503) + jnp.uint32(2531)) & jnp.uint32(noise_k - 1)
    # wrap-free int8 add by the make_tables amplitude invariant
    return (
        jnp.take(center8_dev, cid.astype(jnp.int32), axis=0)
        + jnp.take(noise8_dev, nid.astype(jnp.int32), axis=0)
    )


def derive_columns(s2: np.ndarray):
    """Per-row (scale f32, err f32, raw_norm_sq f64) from the exact integer
    sum of squares — the soundness construction in the module docstring."""
    s2_64 = s2.astype(np.float64)
    safe = np.where(s2_64 > 0, s2_64, 1.0)
    scale = (1.0 / np.sqrt(safe)).astype(np.float32)
    norm = np.sqrt(safe) * scale.astype(np.float64)
    err = (np.abs(norm - 1.0) * 1.000001 + 3e-7).astype(np.float32)
    raw_norm_sq = (scale.astype(np.float64) ** 2) * s2_64
    raw_norm_sq[s2_64 == 0] = 0.0
    return scale, err, raw_norm_sq


def cluster_contents(n_clusters: int) -> list[str]:
    """Fixed-width lowercased contents, one per cluster; the cluster token
    c{cid}x matches the 1M bench corpus convention so queries can carry a
    real keyword."""
    return [f"c{c:07d}x topic synthetic chunk" for c in range(n_clusters)]


def created_columns(n: int, epoch_us: int, span_days: float = 365.0):
    """(created_days f32, created_us i64, created_ts f64) on the 3-decimal
    day grid the 1M corpus uses (exactly representable in micros)."""
    millidays = np.round(
        np.linspace(0.0, span_days * 1000.0, n)
    ).astype(np.int64)
    created_days = (millidays.astype(np.float64) / 1000.0).astype(np.float32)
    created_us = epoch_us + millidays * _US_PER_MILLIDAY
    from omni_recall_tpu.index.device_index import EPOCH

    created_ts = EPOCH.timestamp() + millidays.astype(np.float64) * 86.4
    return created_days, created_us, created_ts


def build_compact_engine(
    n: int,
    d: int = 768,
    *,
    rows_per_cluster: int = 64,
    opts=None,
    slab: int = 1 << 19,
    checkpoint=None,
    doc_id: str = "bulk",
):
    """Build a serving engine over a compact-store corpus of ``n`` rows:
    HOST columns via the streamed slab loop (checkpoint() ticked per slab),
    DEVICE planes generated on device from the same integer tables —
    bit-identical, no [n, d] transfer. Returns (engine, make_requests, now,
    n_clusters).

    The engine profile is the 10M capacity configuration: int8 coarse scan
    + direct compact selection (the only compact path without residual
    planes) + exact f64 host rescore with certificates; hybrid scoring is
    REAL — queries carry the target cluster's keyword token, blooms are
    real signatures of the contents, recency is live."""
    import jax.numpy as jnp
    from datetime import timedelta
    from functools import partial

    import jax

    from omni_recall_tpu.config import EngineOptions
    from omni_recall_tpu.index.device_index import (
        EPOCH,
        DeviceArrays,
        to_micros,
    )
    from omni_recall_tpu.index.store import InMemoryIngestionStore
    from omni_recall_tpu.index.records import DocumentRecord
    from omni_recall_tpu.ops import hashing
    from omni_recall_tpu.search.engine import RecallEngine

    slab = min(slab, n)
    if n % slab != 0:
        raise ValueError(
            f"n ({n}) must be a multiple of the build slab ({slab}) — one "
            "compiled fill shape serves every slab"
        )
    n_clusters = max(64, n // rows_per_cluster)
    opts = opts or EngineOptions(
        backend="pallas", embedding_dim=d, recent_window=0,
        candidate_m=128, bloom_bits=512, scan_dtype="int8",
        capacity_block=max(8192, n // 64),
        refine=False, device_exact_cos=False, direct_select=True,
        coarse_t=2 if n >= (1 << 20) else 0,
        select_t_out=32,
    )
    store = InMemoryIngestionStore()
    store.upsert_document(
        DocumentRecord(id=doc_id, file_name=f"{doc_id}.txt", chunk_count=n)
    )
    engine = RecallEngine(store, options=opts)
    dix = engine.device_index

    # --- shared tables (host-built, uploaded: single source of truth) ---
    center8, noise8 = make_tables(n_clusters, d)
    contents = cluster_contents(n_clusters)
    # one signature per DISTINCT content (cluster), native batch builder
    # when available (~50x the python loop; contents are ASCII by
    # construction so byte-grams == char-grams; bit-identity with the
    # python builder is pinned by tests/test_native.py)
    from omni_recall_tpu.ops import native

    sig_table = native.chunk_signatures(
        [c.encode() for c in contents],
        dix.bloom_bits, dix.ngram, dix.bloom_hashes,
    )
    if sig_table is None:
        sig_table = np.stack([
            hashing.chunk_signature(
                c, dix.bloom_bits, dix.ngram, dix.bloom_hashes
            )
            for c in contents
        ])

    # --- host columns (streamed slab loop) ---
    # scratch buffers are REUSED across slabs: a fresh allocation per slab
    # pays the quota'd host's degraded first-touch page path every time
    # (measured: the int8->f32 cast alone ran 3.7 s/slab on fresh buffers
    # vs ~0.3 s into a reused one); only emb8 itself faults fresh pages,
    # written exactly once by the take(out=) gather
    emb8 = np.empty((n, d), dtype=np.int8)
    s2f = np.empty(n, dtype=np.float32)
    cid_all = np.empty(n, dtype=np.int64)
    noise_k = noise8.shape[0]
    tmp8 = np.empty((slab, d), dtype=np.int8)
    qf = np.empty((slab, d), dtype=np.float32)
    for lo in range(0, n, slab):
        hi = lo + slab
        cid, nid = row_ids_np(lo, hi, n_clusters, noise_k)
        dst = emb8[lo:hi]
        np.take(center8, cid, axis=0, out=dst, mode="clip")
        np.take(noise8, nid, axis=0, out=tmp8, mode="clip")
        dst += tmp8  # wrap-free by the make_tables amplitude invariant
        # EXACT f32 sum of squares (SIMD path): elements <= 112^2 and row
        # sums <= d * 127^2 < 2^24, both exactly representable in f32
        np.copyto(qf, dst, casting="unsafe")
        np.einsum("ij,ij->i", qf, qf, out=s2f[lo:hi])
        cid_all[lo:hi] = cid
        if checkpoint is not None:
            checkpoint()
    s2 = s2f.astype(np.int64)
    del tmp8, qf, s2f
    scale, err, raw_norm_sq = derive_columns(s2)
    epoch_us = to_micros(EPOCH)
    created_days, created_us, created_ts = created_columns(n, epoch_us)
    contents_fixed = np.array(contents, dtype="S")
    stride = contents_fixed.dtype.itemsize
    arena = contents_fixed[cid_all].tobytes()
    content_off = np.arange(n + 1, dtype=np.int64) * stride
    if checkpoint is not None:
        checkpoint()

    # --- device planes (same bits, generated on device) ---
    center8_dev = jnp.asarray(center8)
    noise8_dev = jnp.asarray(noise8)
    sig_dev = jnp.asarray(sig_table)
    noise_k = noise8.shape[0]

    # tables ride as ARGUMENTS (closing over device buffers bakes them into
    # the executable as XLA constants: minutes-long remote compiles)
    @partial(jax.jit, donate_argnums=(0,))
    def fill(plane, c8, n8, lo):
        rows = rows_jnp(lo, slab, c8, n8, n_clusters, noise_k)
        return jax.lax.dynamic_update_slice(
            plane, rows, (lo.astype(jnp.int32), jnp.int32(0))
        )

    emb8_dev = jnp.zeros((n, d), dtype=jnp.int8)
    for lo in range(0, n, slab):
        emb8_dev = fill(emb8_dev, center8_dev, noise8_dev, jnp.uint32(lo))
        if checkpoint is not None:
            checkpoint()
    bloom_dev = jnp.take(sig_dev, jnp.asarray(cid_all, dtype=jnp.int32), axis=0)
    dev = DeviceArrays(
        emb=emb8_dev,
        bloom=bloom_dev,
        created=jnp.asarray(created_days),
        valid=jnp.ones(n, dtype=bool),
        scale=jnp.asarray(scale),
        err=jnp.asarray(err),
    )
    dix.bulk_load_compact(
        emb8=emb8, scale=scale, raw_norm_sq=raw_norm_sq,
        created_days=created_days, created_us=created_us,
        created_ts=created_ts, arena=arena, content_off=content_off,
        doc_id=doc_id, device=dev,
    )

    def make_requests(seed: int, nb: int, kw_frac: float = 1.0):
        """Hybrid query batch: embedding near a cluster center (unit f32)
        plus, for a kw_frac fraction, the target cluster's keyword token in
        the query text (real hybrid scoring: the host rescore computes the
        exact substring keyword term; the device bloom bound covers it)."""
        r = np.random.default_rng(seed)
        reqs = []
        for i in range(nb):
            c = int(r.integers(n_clusters))
            base = center8[c].astype(np.float32)
            base /= np.linalg.norm(base)
            qn = r.standard_normal(d).astype(np.float32)
            qn /= np.linalg.norm(qn)
            q = base + 0.25 * qn
            q /= np.linalg.norm(q)
            # the cluster token alone: it is a substring of exactly the
            # target cluster's contents, so the exact keyword term is 1.0
            # for target rows and 0.0 elsewhere — maximal hybrid
            # discrimination (a corpus-wide word like "topic" would give
            # every row kw=0.5 and compress the certificate margin; a term
            # matching NOTHING keeps the coarse scan's flat 0.2 cap on
            # every excluded row and structurally fails the compact
            # certificate into the full fused scan). The non-kw fraction
            # is the embedding-only profile (empty text, kw exactly 0).
            text = f"c{c:07d}x" if r.random() < kw_frac else ""
            reqs.append((text, q.astype(np.float32), 10))
        return reqs

    now = EPOCH + timedelta(days=365.0)
    return engine, make_requests, now, n_clusters
