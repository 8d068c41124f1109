"""HBM-resident chunk index (structure-of-arrays).

This is the device-resident replacement for the reference's per-chunk record scan
(src/OmniRecall.Api/Services/InMemoryIngestionStore.cs:57-66 feeding
RecallSearchService.cs:28-37). Rows are append-only in (created_at, seq)
order — which is monotone because created_at is assigned at ingest time — so
the reference's "300 most recent chunks" candidate window
(RecallSearchService.cs:26) is a row-index threshold computed on the host and
passed to the kernel as a scalar. Deletions clear the valid mask (tombstones);
reindex overwrites embeddings in place (content, bloom and created_at are
unchanged by reindex, DocumentIngestionService.cs:268-278).

Per row the device holds:
- ``emb``      f32[cap, d]   L2-normalized embedding (zeros when the chunk has
                             no usable embedding — dot against anything is 0,
                             matching the reference's cosine-of-missing = 0),
- ``bloom``    u8[cap, W]   char-n-gram bloom signature (ops/hashing.py),
- ``created``  f32[cap]      days since epoch (recency term),
- ``valid``    bool[cap]     liveness mask.

Capacity grows in ``capacity_block`` row blocks so jitted consumers see a
bounded set of shapes. Host mirrors live in numpy; device sync uploads dirty
block-aligned slabs via a donated jitted row-slab update.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from datetime import datetime, timezone
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from omni_recall_tpu.index.records import ChunkRecord
from omni_recall_tpu.ops import hashing, oracle

EPOCH = datetime(2024, 1, 1, tzinfo=timezone.utc)
_EPOCH70 = datetime(1970, 1, 1, tzinfo=timezone.utc)
_MIN_UTC = datetime.min.replace(tzinfo=timezone.utc)
_MIN_TS = _MIN_UTC.timestamp()

logger = logging.getLogger(__name__)


def _aware(dt: datetime | None) -> datetime:
    if dt is None:
        return _MIN_UTC
    return dt if dt.tzinfo is not None else dt.replace(tzinfo=timezone.utc)


def to_micros(dt: datetime | None) -> int:
    """Exact integer epoch microseconds. (now_us - created_us) / 1e6 / 86400
    in float64 reproduces (now - created).total_seconds() / 86400 bit-for-bit
    for any timestamp within f64's 2^53 integer range (realistic dates), so
    the vectorized recency rescore matches the per-pair oracle exactly."""
    td = _aware(dt) - _EPOCH70
    return (td.days * 86400 + td.seconds) * 1_000_000 + td.microseconds

# row granularity of the valid-count blocks backing window_start_row; fixed
# (independent of capacity_block) so the window cost is bounded by
# O(n/VALID_BLOCK) numpy + one <=VALID_BLOCK python-free in-block scan
VALID_BLOCK = 4096


def to_days(dt: datetime | None) -> float:
    if dt is None:
        return 0.0
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return (dt - EPOCH).total_seconds() / 86400.0


# NOT donated: searches may still hold references to the previous device
# arrays while an ingest thread syncs dirty slabs — donation would delete
# buffers out from under them (functional snapshot semantics instead; the
# copy is on the ingest path, not the query path)
@jax.jit
def _set_slab(dev: jax.Array, slab: jax.Array, start: jax.Array) -> jax.Array:
    return jax.lax.dynamic_update_slice_in_dim(dev, slab, start, axis=0)


@partial(jax.jit, donate_argnums=(0,))
def _set_slab_donated(dev: jax.Array, slab: jax.Array, start: jax.Array) -> jax.Array:
    return jax.lax.dynamic_update_slice_in_dim(dev, slab, start, axis=0)


# full uploads above this size go through _upload_slabbed
_SLAB_UPLOAD_BYTES = 256 << 20

# Optional per-slab tick for _upload_slabbed, called between slab transfers
# (no arguments). A multi-GB restore can spend a long time inside ONE
# device_arrays() call; a deadline-aware caller (bench.py st_restore) sets
# this to its checkpoint function so the upload can abort cleanly at a slab
# boundary instead of overrunning its budget. Exceptions propagate to the
# device_arrays() caller; the index is left device-dirty but host-intact
# (the next device_arrays() re-derives).
UPLOAD_TICK = None


def _upload_slabbed(host: np.ndarray, slab_bytes: int = 64 << 20) -> jax.Array:
    """Upload a large host array in ~64 MB slabs assembled on device.

    ``jnp.asarray`` on a multi-GB array allocates a same-sized fresh host
    staging buffer; on hosts with a degraded first-touch page path
    (measured as low as ~10 MB/s) that staging allocation alone can take
    minutes. Slab-wise transfers reuse malloc'd same-size staging buffers
    (only the first slab faults fresh pages) and assemble into one device
    buffer via donated dynamic_update_slice — same result, page-fault cost
    O(slab) instead of O(total)."""
    rows = host.shape[0]
    row_bytes = max(1, int(np.prod(host.shape[1:], dtype=np.int64)) * host.itemsize)
    slab = max(1 if slab_bytes < (64 << 20) else 1024, slab_bytes // row_bytes)
    if rows <= slab:
        return jnp.asarray(host)
    dev = jnp.zeros(host.shape, dtype=host.dtype)
    for i in range(0, rows, slab):
        if UPLOAD_TICK is not None:
            UPLOAD_TICK()
        piece = jnp.asarray(np.ascontiguousarray(host[i : i + slab]))
        dev = _set_slab_donated(dev, piece, jnp.int32(i))
    return dev


def _device_quantize_impl(x: jax.Array, refine: bool) -> dict[str, jax.Array]:
    """int8 (+residual) quantization ON DEVICE for large full uploads: the
    host quantizer (ops/quantize.py) streams multiple f64 passes over the
    whole matrix — ~10s per 65k rows on a burstable 1-core host — while the
    device does it in milliseconds; uploading f32 rows once at H2D rates is
    far cheaper.

    Soundness of the f32-evaluated error norms (the host version uses exact
    f64 + round-up): the residual elements carry <= u*|x| ~ 6e-8 absolute
    representation error and the f32 norm accumulates gamma_d ~ d*u ~ 5e-5
    relative error, so err * (1 + 1e-4) + 3e-7 is >= the true residual norm
    — the same construction (and constants) as the device-side query
    quantizer, ops/refine.py quantize_queries_int8_residual. A slightly
    larger stored bound only loosens the scan's upper bound (exactness is
    preserved via the certificate); it never understates the error."""

    def plane(v):
        am = jnp.max(jnp.abs(v), axis=1, keepdims=True)
        s = am / 127.0
        safe = jnp.where(s > 0, s, 1.0)
        q = jnp.clip(jnp.round(v / safe), -127, 127).astype(jnp.int8)
        return q, s

    def errn(r):
        return jnp.linalg.norm(r, axis=1) * (1.0 + 1e-4) + 3e-7

    q1, s1 = plane(x)
    r1 = x - q1.astype(jnp.float32) * s1
    out = {"emb": q1, "scale": s1[:, 0], "err": errn(r1)}
    if refine:
        q2, s2 = plane(r1)
        r2 = r1 - q2.astype(jnp.float32) * s2
        out.update(emb2=q2, scale2=s2[:, 0], err2=errn(r2))
    return out


_device_quantize = partial(
    jax.jit, static_argnames=("refine",), donate_argnums=(0,)
)(_device_quantize_impl)
# non-donating twin: the exact-cosine raw plane keeps the uploaded f32
# rows alive as dev.raw when raw_emb aliases emb (bulk_load fast path)
_device_quantize_keep = partial(
    jax.jit, static_argnames=("refine",)
)(_device_quantize_impl)


@dataclass
class DeviceArrays:
    emb: jax.Array            # f32 | int8 rows, per scan_dtype
    bloom: jax.Array
    created: jax.Array
    valid: jax.Array
    scale: jax.Array | None = None  # int8: per-row dequant scale
    err: jax.Array | None = None    # int8: per-row quantization error norm
    # residual int8 plane for the device-assisted exact rescore
    # (ops/refine.py): emb ~= emb*scale + emb2*scale2, ||resid|| <= err2
    emb2: jax.Array | None = None
    scale2: jax.Array | None = None
    err2: jax.Array | None = None
    # bitwise copy of the host raw_emb mirror (f32) for the device-exact
    # cosine stage (ops/exact_cos.py); costs d*4 bytes/row of HBM
    raw: jax.Array | None = None


class DeviceIndex:
    def __init__(
        self,
        dim: int,
        *,
        capacity_block: int = 8192,
        bloom_bits: int = 1024,
        ngram: int = 4,
        bloom_hashes: int = 1,
        mesh=None,
        scan_dtype: str = "f32",  # f32 | int8 device storage
        refine: bool = False,     # keep a residual int8 plane (ops/refine.py)
        exact_cos: bool = False,  # keep a raw-f32 plane (ops/exact_cos.py)
    ) -> None:
        if bloom_bits % 8 != 0:
            raise ValueError("bloom_bits must be a multiple of 8")
        if scan_dtype not in ("f32", "int8"):
            raise ValueError(
                f"unsupported scan_dtype {scan_dtype!r}: use 'int8' or 'f32'"
            )
        self.dim = dim
        self.mesh = mesh
        self.scan_dtype = scan_dtype
        self.refine = bool(refine) and scan_dtype == "int8"
        # raw-f32 device plane for the device-exact cosine: single-device
        # (ops/exact_cos.py) or row-sharded over the mesh for the sharded
        # serving stage (parallel/sharded.py refine_select_dd)
        self.exact_cos = bool(exact_cos)
        capacity_block = max(128, capacity_block)
        if mesh is not None:
            # even row sharding: capacity must divide by the shard count
            n_shards = int(mesh.devices.size)
            capacity_block = ((capacity_block + n_shards - 1) // n_shards) * n_shards
        self.capacity_block = capacity_block
        self.bloom_bits = bloom_bits
        self.ngram = ngram
        self.bloom_hashes = bloom_hashes

        self._cap = 0
        self._n = 0  # rows allocated (including tombstones)
        self._n_valid = 0
        self.emb = np.zeros((0, dim), dtype=np.float32)
        self.bloom = np.zeros((0, bloom_bits // 8), dtype=np.uint8)
        self.created = np.zeros((0,), dtype=np.float32)
        self.valid = np.zeros((0,), dtype=bool)
        # Host-side mirrors for the vectorized exact rescore (the certified
        # path's hot loop, search/engine.py _exact_rescore_rows): raw f32
        # embeddings + exact f64 norms reproduce the oracle's cosine
        # bit-for-bit without per-candidate python list conversion; exact
        # integer micros reproduce its recency; timestamp()/seq drive the
        # tie-break identically to _sort_key.
        self.raw_emb = np.zeros((0, dim), dtype=np.float32)
        self.raw_norm_sq = np.zeros((0,), dtype=np.float64)
        self.created_us = np.full((0,), to_micros(None), dtype=np.int64)
        self.created_ts = np.zeros((0,), dtype=np.float64)
        self.seqs = np.zeros((0,), dtype=np.int64)
        # content arena: all rows' lowercased UTF-8 content concatenated,
        # row r at bytes [content_off[r], content_off[r+1]). Lets the native
        # rescorer read candidate contents with zero per-row marshalling.
        # Deleted rows keep their bytes (compacted by rebuild_index); the
        # arena is only read under self._lock (bytearray growth reallocates).
        self._arena = bytearray()
        self.content_off = np.zeros((1,), dtype=np.int64)
        self.meta: list[ChunkRecord | None] = []
        self._row_by_chunk_id: dict[str, int] = {}
        # bumped (under _lock) on every in-place embedding update; the
        # engine compares it across a search to detect reindex races
        self._update_seq = 0
        # O(1)-amortized auxiliary structures (a 10M-row index with heavy
        # tombstones must not pay an O(n) python scan per search/delete):
        # - per-VALID_BLOCK counts of valid rows -> window_start_row is
        #   O(n/VALID_BLOCK) vectorized + one in-block scan
        # - doc_id -> row list -> delete touches only the doc's own rows
        self._block_valid = np.zeros((0,), dtype=np.int64)
        self._rows_by_doc: dict[str, list[int]] = {}

        # compact bulk mode (bulk_load_compact): int8+scale embedding
        # columns replace the f32 mirrors; serving-only
        self.host_compact = False
        self.emb8_host: np.ndarray | None = None
        self.scale_host: np.ndarray | None = None

        self._device: DeviceArrays | None = None
        # one-shot pre-quantized device planes injected by load_slabs
        # (snapshot fast restore); consumed by the next full upload
        self._preconverted: dict[str, np.ndarray] | None = None
        # emb and raw_emb may share storage after an exact-fit bulk_load
        # (rows pre-normalized, raw == emb); see _unalias_raw
        self._raw_aliased = False
        # dirty tracking is per capacity-block: a single [lo, hi) interval
        # would collapse one low-row update + one tail append into a sync of
        # every block in between (GBs of H2D for a handful of changed rows)
        self._dirty_blocks: set[int] = set()
        self._device_cap = -1
        # guards host-mirror mutation vs device sync: the HTTP server is
        # thread-per-request, so a search's dirty-slab upload must never
        # observe a concurrent append/delete mid-write
        self._lock = threading.RLock()

    # ---- sizing ----

    @property
    def n_rows(self) -> int:
        return self._n

    @property
    def n_valid(self) -> int:
        return self._n_valid

    @property
    def update_seq(self) -> int:
        return self._update_seq

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self._cap:
            return
        # geometric growth (>= 1/8 of current capacity): growing a live
        # index COPIES every array — block-by-block growth at a 1M-row
        # index would re-copy ~7 GB per small append batch. Amortized O(1);
        # block alignment keeps the jitted shape set bounded either way.
        needed = max(needed, self._cap + self._cap // 8)
        new_cap = ((needed + self.capacity_block - 1) // self.capacity_block) * self.capacity_block
        grow = new_cap - self._cap

        if self._n == 0:
            # empty index (bulk/rebuild hot path): fresh zero allocations are
            # calloc'd lazily by the OS — np.pad would eagerly WRITE zeros
            # over the full capacity (hundreds of MB of memory traffic)
            self.emb = np.zeros((new_cap, self.dim), dtype=np.float32)
            self.bloom = np.zeros((new_cap, self.bloom_bits // 8), dtype=np.uint8)
            self.created = np.zeros(new_cap, dtype=np.float32)
            self.valid = np.zeros(new_cap, dtype=bool)
            self.raw_emb = np.zeros((new_cap, self.dim), dtype=np.float32)
            self.raw_norm_sq = np.zeros(new_cap, dtype=np.float64)
            self.created_us = np.full(new_cap, to_micros(None), dtype=np.int64)
            self.created_ts = np.full(new_cap, _MIN_TS, dtype=np.float64)
            self.seqs = np.zeros(new_cap, dtype=np.int64)
        else:

            def pad(a: np.ndarray) -> np.ndarray:
                pad_width = [(0, grow)] + [(0, 0)] * (a.ndim - 1)
                return np.pad(a, pad_width)

            self.emb = pad(self.emb)
            self.bloom = pad(self.bloom)
            self.created = pad(self.created)
            self.valid = pad(self.valid)
            self.raw_emb = pad(self.raw_emb)
            self._raw_aliased = False  # the two pads are independent copies
            self.raw_norm_sq = pad(self.raw_norm_sq)
            self.created_us = np.concatenate(
                [self.created_us, np.full(grow, to_micros(None), dtype=np.int64)]
            )
            self.created_ts = np.concatenate(
                [self.created_ts, np.full(grow, _MIN_TS, dtype=np.float64)]
            )
            self.seqs = pad(self.seqs)
        off = np.full(new_cap + 1, self.content_off[self._n], dtype=np.int64)
        off[: self.content_off.shape[0]] = self.content_off
        self.content_off = off
        n_blocks = (new_cap + VALID_BLOCK - 1) // VALID_BLOCK
        if n_blocks > self._block_valid.shape[0]:
            self._block_valid = np.pad(
                self._block_valid, (0, n_blocks - self._block_valid.shape[0])
            )
        self._cap = new_cap
        self._device = None  # capacity changed -> full re-upload
        self._device_cap = -1

    def _count_valid_added(self, lo: int, hi: int) -> None:
        """Credit rows [lo, hi) — all newly valid — to their blocks."""
        if hi <= lo:
            return
        b_lo, b_hi = lo // VALID_BLOCK, (hi - 1) // VALID_BLOCK
        if b_lo == b_hi:
            self._block_valid[b_lo] += hi - lo
            return
        self._block_valid[b_lo] += (b_lo + 1) * VALID_BLOCK - lo
        self._block_valid[b_lo + 1 : b_hi] += VALID_BLOCK
        self._block_valid[b_hi] += hi - b_hi * VALID_BLOCK

    def _mark_dirty(self, lo: int, hi: int) -> None:
        if hi <= lo:
            return
        block = self.capacity_block
        self._dirty_blocks.update(range(lo // block, (hi + block - 1) // block))

    # ---- mutation ----

    def _normalize(self, embedding: list[float] | None) -> np.ndarray | None:
        if embedding is None or len(embedding) != self.dim:
            return None
        out = self._normalize_vec(np.asarray(embedding, dtype=np.float32))
        return out[0] if out is not None else None

    def _normalize_vec(
        self, vec: np.ndarray
    ) -> tuple[np.ndarray, float] | None:
        """(normalized f32, exact f64 norm_sq) for an f32 vector of the
        index dim, or None for zero norm. Split from _normalize so callers
        that already converted the list can reuse the array AND the norm
        (the exact rescore needs both; list->array conversion is the
        dominant per-query dispatch cost at serving batch sizes)."""
        norm_sq = float(np.sum((vec * vec).astype(np.float64)))
        if norm_sq <= 0.0:
            return None
        return (vec.astype(np.float64) / np.sqrt(norm_sq)).astype(np.float32), norm_sq

    def append(self, chunks: list[ChunkRecord]) -> None:
        if not chunks:
            return
        if getattr(self, "host_compact", False):
            raise RuntimeError(
                "compact bulk index is serving-only (bulk_load_compact)"
            )
        with self._lock:
            self._append_locked(chunks)

    def _derive_columns(self, chunks: list[ChunkRecord]) -> dict:
        """Batch-derive every per-chunk column _append_locked installs:
        lowercased UTF-8 encodings, bloom signatures, timestamp columns,
        seqs, and the (normalized, raw, norm_sq) embedding planes. Pure —
        no index state is touched (beyond prepopulating each record's lazy
        content cache), so a failure mid-derivation can never corrupt the
        meta-index == row-index alignment. Shared by _append_locked and
        append_from_index (the compaction miss path)."""
        nc = len(chunks)
        lows = [oracle.lower_invariant(c.content) for c in chunks]
        encs = []
        for c, low in zip(chunks, lows):
            if c._lower_utf8 is None:  # prepopulate the record's lazy cache
                c._lower_utf8 = low.encode("utf-8", errors="surrogatepass")
            encs.append(c._lower_utf8)
        sigs = hashing.chunk_signatures_batch(
            lows, self.bloom_bits, self.ngram, self.bloom_hashes
        )
        days = np.fromiter(
            (to_days(c.created_at_utc) for c in chunks), dtype=np.float64, count=nc
        )
        us = np.fromiter(
            (to_micros(c.created_at_utc) for c in chunks), dtype=np.int64, count=nc
        )
        ts = np.fromiter(
            (_aware(c.created_at_utc).timestamp() for c in chunks),
            dtype=np.float64, count=nc,
        )
        seqs = np.fromiter((c.seq for c in chunks), dtype=np.int64, count=nc)
        lens = np.fromiter((len(e) for e in encs), dtype=np.int64, count=nc)

        # batch-normalize the common case (correct-dimension embeddings);
        # row-wise float64 norms are identical to _normalize per row
        # (np.sum(f32, dtype=f64) pairwise-accumulates exactly like
        # .astype(f64).sum() without materializing the f64 copy)
        dim_ok = [
            offset for offset, c in enumerate(chunks)
            if c.embedding is not None and len(c.embedding) == self.dim
        ]
        n_mismatched = sum(
            1 for c in chunks
            if c.embedding is not None and len(c.embedding) not in (0, self.dim)
        )
        if n_mismatched:
            # stored as zero rows (device cosine 0); search routes queries
            # whose embedding dim also mismatches to the exact host scan so
            # the certificate stays sound (search/engine.py)
            logger.warning(
                "%d chunk embedding(s) do not match the index dim %d; "
                "stored as zero vectors (cosine contributes 0). Check "
                "Embeddings:Dim vs Engine:EmbeddingDim.",
                n_mismatched, self.dim,
            )
        a = normed = norm_sq = None
        if dim_ok:
            a = np.asarray([chunks[o].embedding for o in dim_ok], dtype=np.float32)
            norm_sq = np.sum(a * a, axis=1, dtype=np.float64)
            # f32 reciprocal-multiply normalization: one f32 pass instead of
            # three f64 passes (the burstable host throttles hard on f64
            # traffic). Differs from _normalize's f64 divide by ~2 ulp per
            # element — irrelevant for soundness: the device scan/refine
            # bounds budget >= 3e-7 for the unit-row representation error
            # (ops/refine.py REFINE_EPS derivation), and the exact rescore
            # reads raw_emb/raw_norm_sq, which keep the oracle-exact bits.
            with np.errstate(divide="ignore"):
                inv = np.where(
                    norm_sq > 0.0, 1.0 / np.sqrt(norm_sq), 0.0
                ).astype(np.float32)
            normed = a * inv[:, None]  # zero-norm rows normalize to zeros
        return {
            "encs": encs, "sigs": sigs, "days": days, "us": us, "ts": ts,
            "seqs": seqs, "lens": lens, "dim_ok": dim_ok,
            "a": a, "normed": normed, "norm_sq": norm_sq,
        }

    def _append_locked(self, chunks: list[ChunkRecord]) -> None:
        start = self._n
        nc = len(chunks)
        end = start + nc
        self._ensure_capacity(end)
        # compute EVERY fallible per-chunk value BEFORE any state mutation:
        # an exception mid-append would otherwise leave meta/valid/row maps
        # partially updated with _n unchanged, permanently corrupting the
        # meta-index == row-index alignment (rows would be reused)
        d = self._derive_columns(chunks)
        sigs, days, us, ts = d["sigs"], d["days"], d["us"], d["ts"]
        seqs, lens, dim_ok = d["seqs"], d["lens"], d["dim_ok"]
        a, normed, norm_sq = d["a"], d["normed"], d["norm_sq"]
        arena_add = b"".join(d["encs"])
        ids = [c.id for c in chunks]
        rows_ok = (
            np.asarray(dim_ok, dtype=np.int64) + start if dim_ok else None
        )

        # -- mutation (array slice-assignments; nothing below can raise) --
        self.bloom[start:end] = sigs
        if dim_ok:
            if len(dim_ok) == nc:  # contiguous: avoid the fancy scatter
                self.emb[start:end] = normed
                self.raw_emb[start:end] = a
                self.raw_norm_sq[start:end] = norm_sq
            else:
                self.emb[rows_ok] = normed
                self.raw_emb[rows_ok] = a
                self.raw_norm_sq[rows_ok] = norm_sq
        self.created[start:end] = days
        self.created_us[start:end] = us
        self.created_ts[start:end] = ts
        self.seqs[start:end] = seqs
        base = len(self._arena)
        self._arena.extend(arena_add)
        self.content_off[start + 1 : end + 1] = base + np.cumsum(lens)
        self.valid[start:end] = True
        self.meta.extend(chunks)
        self._row_by_chunk_id.update(zip(ids, range(start, end)))
        by_doc = self._rows_by_doc
        for offset, c in enumerate(chunks):
            by_doc.setdefault(c.document_id, []).append(start + offset)
        self._n = end
        self._n_valid += nc
        self._count_valid_added(start, end)
        self._mark_dirty(start, end)

    def append_from_index(
        self, old: "DeviceIndex", chunks: list[ChunkRecord]
    ) -> None:
        """Compaction fast path for RecallEngine.rebuild_index: fill this
        (empty) index from ``chunks``, REUSING ``old``'s derived columns —
        bloom signatures, normalized/raw embeddings, f64 norms, timestamp
        columns, and arena bytes — for every chunk whose record OBJECT is
        the one ``old`` indexed. Object identity guarantees the old row's
        columns were derived from exactly this record's current state:
        in-place embedding updates go through update_embedding (which keeps
        the arrays in sync and leaves meta[row] as the same object), and a
        store upsert that REPLACES a record fails the identity test, so its
        chunk re-derives through the normal path. Rebuild therefore costs a
        host-side array gather instead of re-hashing + re-normalizing +
        re-quantizing the corpus, and — when the old index has current
        single-device planes — the device slabs compact ON DEVICE via one
        gather (no host quantization, no re-upload; ~ms at 10M rows).

        Requirements: ``chunks`` in (created_at, seq) order (rebuild_index
        sorts); this index empty; derivation parameters matching ``old``'s.
        """
        nc = len(chunks)
        if nc == 0:
            return
        if (
            self.dim, self.bloom_bits, self.ngram,
            self.bloom_hashes, self.scan_dtype,
        ) != (
            old.dim, old.bloom_bits, old.ngram,
            old.bloom_hashes, old.scan_dtype,
        ):
            raise ValueError(
                "append_from_index requires matching index parameters"
            )
        with self._lock:
            if self._n != 0:
                raise ValueError("append_from_index requires an empty index")
            self._ensure_capacity(nc)

            src = np.full(nc, -1, dtype=np.int64)
            with old._lock:
                row_of, ometa, ovalid = old._row_by_chunk_id, old.meta, old.valid
                for i, c in enumerate(chunks):
                    r = row_of.get(c.id)
                    if r is not None and ometa[r] is c and ovalid[r]:
                        src[i] = r
                hit_dst = np.nonzero(src >= 0)[0]
                hit_src = src[hit_dst]
                if hit_dst.size:
                    # gather every reused column while old's arrays are
                    # stable (the arena-read-under-lock contract)
                    self.emb[hit_dst] = old.emb[hit_src]
                    self.raw_emb[hit_dst] = old.raw_emb[hit_src]
                    self.raw_norm_sq[hit_dst] = old.raw_norm_sq[hit_src]
                    self.bloom[hit_dst] = old.bloom[hit_src]
                    self.created[hit_dst] = old.created[hit_src]
                    self.created_us[hit_dst] = old.created_us[hit_src]
                    self.created_ts[hit_dst] = old.created_ts[hit_src]
                    self.seqs[hit_dst] = old.seqs[hit_src]
                h_start = old.content_off[hit_src]
                h_len = old.content_off[hit_src + 1] - h_start
                old_arena = np.frombuffer(old._arena, dtype=np.uint8)

                miss_dst = np.nonzero(src < 0)[0]
                miss = [chunks[int(i)] for i in miss_dst]
                d = self._derive_columns(miss) if miss else None

                lens = np.zeros(nc, dtype=np.int64)
                lens[hit_dst] = h_len
                if d is not None:
                    lens[miss_dst] = d["lens"]
                out_off = np.zeros(nc + 1, dtype=np.int64)
                np.cumsum(lens, out=out_off[1:])
                arena = np.empty(int(out_off[-1]), dtype=np.uint8)
                # hit bytes: sources ascend (rows are in seq order), so
                # coalesce adjacent ranges into runs — one memcpy per
                # tombstone gap instead of per row. A run must be contiguous
                # at BOTH ends: in the source arena (no deleted-row bytes
                # between) and in the output rows (no interleaved miss, whose
                # bytes would otherwise be overwritten).
                if hit_dst.size:
                    brk = np.nonzero(
                        (h_start[1:] != h_start[:-1] + h_len[:-1])
                        | (hit_dst[1:] != hit_dst[:-1] + 1)
                    )[0] + 1
                    run_lo = np.concatenate(([0], brk))
                    run_hi = np.concatenate((brk, [hit_dst.size]))
                    for lo, hi in zip(run_lo, run_hi):
                        s = int(h_start[lo])
                        o = int(out_off[hit_dst[lo]])
                        ln = int(h_start[hi - 1] + h_len[hi - 1]) - s
                        arena[o : o + ln] = old_arena[s : s + ln]
                if d is not None:
                    for k, i in enumerate(miss_dst):
                        e = d["encs"][k]
                        o = int(out_off[i])
                        arena[o : o + len(e)] = np.frombuffer(e, dtype=np.uint8)

            # -- mutation outside old's lock (no more old reads) --
            if d is not None:
                self.bloom[miss_dst] = d["sigs"]
                self.created[miss_dst] = d["days"]
                self.created_us[miss_dst] = d["us"]
                self.created_ts[miss_dst] = d["ts"]
                self.seqs[miss_dst] = d["seqs"]
                if d["dim_ok"]:
                    rows_ok = miss_dst[np.asarray(d["dim_ok"], dtype=np.int64)]
                    self.emb[rows_ok] = d["normed"]
                    self.raw_emb[rows_ok] = d["a"]
                    self.raw_norm_sq[rows_ok] = d["norm_sq"]
            self._arena = bytearray(memoryview(arena))
            self.content_off[: nc + 1] = out_off
            self.valid[:nc] = True
            self.meta.extend(chunks)
            self._row_by_chunk_id.update(
                zip((c.id for c in chunks), range(nc))
            )
            by_doc = self._rows_by_doc
            for row, c in enumerate(chunks):
                by_doc.setdefault(c.document_id, []).append(row)
            self._n = nc
            self._n_valid = nc
            self._count_valid_added(0, nc)
            self._mark_dirty(0, nc)

            # device-side plane compaction: when every row reuses an old row
            # and old's single-device planes are current, the new planes are
            # one jnp.take over the old ones — no host quantization pass, no
            # H2D re-upload. Old buffers stay untouched (searches in flight
            # on the old index keep valid data; _set_slab never donates).
            if (
                self.mesh is None and old.mesh is None
                and self.refine == old.refine
                and miss_dst.size == 0
            ):
                with old._lock:
                    odev = old._device
                    planes_ok = (
                        odev is not None
                        and old._device_cap == old._cap
                        and not old._dirty_blocks
                    )
                if planes_ok:
                    try:
                        self._adopt_compacted_planes(odev, src)
                    except Exception:
                        # e.g. HBM exhaustion holding both plane sets at
                        # very large n: the standard upload path still works
                        logger.warning(
                            "on-device index compaction failed; falling "
                            "back to host-side upload", exc_info=True,
                        )

    def _adopt_compacted_planes(self, odev: DeviceArrays, src: np.ndarray) -> None:
        """Install this index's device planes as a row-gather of ``odev``'s
        (src[i] = old row for new row i; pad rows gather row 0 and are
        masked by valid=False). created/valid ride up from the (tiny) host
        mirrors so they are authoritative for pad rows."""
        cap = self._cap
        idx = np.zeros(cap, dtype=np.int32)
        idx[: src.shape[0]] = src
        idx_dev = jnp.asarray(idx)

        def take(p):
            return None if p is None else jnp.take(p, idx_dev, axis=0)

        self._device = DeviceArrays(
            emb=take(odev.emb),
            bloom=take(odev.bloom),
            created=jnp.asarray(self.created),
            valid=jnp.asarray(self.valid),
            scale=take(odev.scale),
            err=take(odev.err),
            emb2=take(odev.emb2),
            scale2=take(odev.scale2),
            err2=take(odev.err2),
            raw=take(odev.raw),
        )
        self._device_cap = cap
        self._dirty_blocks.clear()

    def bulk_load(
        self,
        emb_normalized: np.ndarray,       # f32 [n, d], rows already L2-normalized (or zero)
        bloom: np.ndarray,                # u8 [n, W]
        created_days: np.ndarray,         # f32 [n], nondecreasing
        meta: list[ChunkRecord],
        aux: dict | None = None,
    ) -> None:
        """Bulk array injection for large-scale restore/benchmarks: bypasses
        per-chunk python hashing/normalization. Rows must already be in
        (created, seq) order; the index must be empty.

        CONTRACT: ``bloom`` rows must be signatures built with THIS index's
        exact parameters — ``chunk_signature(content.lower(), self.bloom_bits,
        self.ngram, self.bloom_hashes)`` — otherwise the device keyword score
        is not a sound upper bound and 'certified-exact' results can be
        silently wrong. The width is asserted; ngram/hash count cannot be
        recovered from the arrays and are the caller's responsibility.

        ``aux`` (optional) provides pre-vectorized columns the default path
        derives with per-record python iteration (~45 s at 1M rows on the
        quota'd host): keys ``created_us`` i64[n], ``created_ts`` f64[n],
        ``seqs`` i64[n], ``lower_arena`` bytes, ``lower_off`` i64[n+1].
        SAME contract as the record-derived values — to_micros/timestamp of
        each record's created_at_utc, record seq, and the concatenated
        lowercased UTF-8 contents — callers own the equivalence (the bench
        corpus computes both sides from the same day grid)."""
        with self._lock:
            if self._n != 0:
                raise ValueError("bulk_load requires an empty index")
            self._bulk_load_locked(
                emb_normalized, bloom, created_days, meta, aux
            )

    def _bulk_load_locked(self, emb_normalized, bloom, created_days, meta,
                          aux=None) -> None:
        n = emb_normalized.shape[0]
        if not (len(meta) == n == bloom.shape[0] == created_days.shape[0]):
            raise ValueError("bulk_load arrays must have matching row counts")
        if bloom.shape[1] != self.bloom_bits // 8:
            raise ValueError(
                f"bloom width {bloom.shape[1]} != index bloom_bits/8 "
                f"({self.bloom_bits // 8}); signatures must be built with "
                "this index's (bloom_bits, ngram, bloom_hashes)"
            )
        self._ensure_capacity(n)
        # exact-rescore mirrors: bulk_load rows ARE the records' embeddings
        # (callers pass the same arrays they put in meta), so raw == emb
        # here. When the caller's array exactly fills capacity, ADOPT it for
        # both (aliased) instead of copying twice — at 10M x 768 that skips
        # ~60 GB of fresh-page writes. The alias is safe: deletes write the
        # same value (0) to both views, capacity growth np.pads each into
        # its own fresh copy, and the one in-place writer that would
        # diverge them (update_embedding) un-aliases first via _unalias_raw.
        if (
            self._cap == n
            and isinstance(emb_normalized, np.ndarray)
            and emb_normalized.dtype == np.float32
            and emb_normalized.flags.c_contiguous
        ):
            self.emb = emb_normalized
            self.raw_emb = emb_normalized
            self._raw_aliased = True
        else:
            self.emb[:n] = emb_normalized
            self.raw_emb[:n] = emb_normalized
        self.bloom[:n] = bloom
        self.created[:n] = created_days
        self.valid[:n] = True
        self.raw_norm_sq[:n] = np.sum(
            emb_normalized * emb_normalized, axis=1, dtype=np.float64
        )
        if aux is not None:
            self.created_us[:n] = aux["created_us"]
            self.created_ts[:n] = aux["created_ts"]
            self.seqs[:n] = aux["seqs"]
            self._arena.extend(aux["lower_arena"])
            self.content_off[1 : n + 1] = np.asarray(
                aux["lower_off"], dtype=np.int64
            )[1 : n + 1]
        else:
            self.created_us[:n] = np.fromiter(
                (to_micros(c.created_at_utc) for c in meta), dtype=np.int64, count=n
            )
            self.created_ts[:n] = np.fromiter(
                (_aware(c.created_at_utc).timestamp() for c in meta),
                dtype=np.float64, count=n,
            )
            self.seqs[:n] = np.fromiter((c.seq for c in meta), dtype=np.int64, count=n)
            encs = [c.content_lower_utf8() for c in meta]
            self._arena.extend(b"".join(encs))
            self.content_off[1 : n + 1] = np.cumsum(
                np.fromiter((len(e) for e in encs), dtype=np.int64, count=n)
            )
        self.meta.extend(meta)
        self._row_by_chunk_id.update(zip((c.id for c in meta), range(n)))
        by_doc = self._rows_by_doc
        for row, c in enumerate(meta):
            by_doc.setdefault(c.document_id, []).append(row)
        self._n = n
        self._n_valid = n
        self._count_valid_added(0, n)
        self._mark_dirty(0, n)

    def load_slabs(
        self,
        meta: list[ChunkRecord],
        *,
        emb_norm: np.ndarray,      # f32 [n, d] normalized (or zero) rows
        raw_emb: np.ndarray,       # f32 [n, d] raw mirror (exact rescore)
        raw_norm_sq: np.ndarray,   # f64 [n]
        bloom: np.ndarray,         # u8 [n, W]
        created: np.ndarray,       # f32 [n] days
        created_us: np.ndarray,    # i64 [n] exact micros
        created_ts: np.ndarray,    # f64 [n] timestamp() mirror
        seqs: np.ndarray,          # i64 [n]
        lower_arena: bytes,        # concatenated lowercased UTF-8 contents
        lower_off: np.ndarray,     # i64 [n + 1]
        converted: dict[str, np.ndarray] | None = None,
    ) -> None:
        """Snapshot fast-restore injection (index/snapshot.py): installs
        EVERY host mirror from persisted arrays — no hashing, normalization,
        quantization or per-chunk python work. ``converted`` carries the
        pre-quantized device planes (matching _convert_emb's output keys);
        the first device upload consumes them instead of re-quantizing.

        CONTRACT: arrays must be mutually consistent and derived with this
        index's exact parameters (the snapshot layer verifies a random
        sample bit-for-bit before calling, and falls back to the rebuild
        path otherwise). Rows must be in (created_at, seq) order; the index
        must be empty.

        The arrays are ADOPTED as the index storage (capacity == n exactly;
        the next append grows by capacity blocks as usual). Copy-on-write
        mmap arrays work as-is: restore pays page-in only for rows a later
        rescore/upload actually touches, and mutations never reach the
        snapshot files."""
        n = len(meta)
        with self._lock:
            if self._n != 0:
                raise ValueError("load_slabs requires an empty index")
            if not (
                n == emb_norm.shape[0] == bloom.shape[0] == created.shape[0]
                == raw_emb.shape[0] == seqs.shape[0]
            ):
                raise ValueError("load_slabs arrays must have matching rows")
            if bloom.shape[1] != self.bloom_bits // 8 or emb_norm.shape[1] != self.dim:
                raise ValueError("slab geometry mismatch")
            cap = n
            if self.mesh is not None:
                # row-sharded planes need a shard-divisible capacity; pad
                # the adopted arrays (valid=False rows). This copies the
                # mmaps — only the sharded topology pays it.
                s = int(self.mesh.devices.size)
                cap = ((n + s - 1) // s) * s
            if cap != n:
                def _padr(a: np.ndarray) -> np.ndarray:
                    out = np.zeros((cap,) + a.shape[1:], dtype=a.dtype)
                    out[:n] = a
                    return out

                emb_norm, raw_emb, bloom = map(_padr, (emb_norm, raw_emb, bloom))
                created, created_us, created_ts, raw_norm_sq, seqs = map(
                    _padr, (created, created_us, created_ts, raw_norm_sq, seqs)
                )
                lower_off = np.concatenate([
                    np.asarray(lower_off, dtype=np.int64),
                    np.full(cap - n, int(lower_off[-1]), dtype=np.int64),
                ])
                if converted is not None:
                    converted = {k: _padr(v) for k, v in converted.items()}
            self.emb = emb_norm
            self.bloom = bloom
            self.created = np.asarray(created, dtype=np.float32)
            self.valid = np.zeros(cap, dtype=bool)
            self.valid[:n] = True
            self.raw_emb = raw_emb
            self.raw_norm_sq = np.asarray(raw_norm_sq, dtype=np.float64)
            self.created_us = np.asarray(created_us, dtype=np.int64)
            self.created_ts = np.asarray(created_ts, dtype=np.float64)
            self.seqs = np.asarray(seqs, dtype=np.int64)
            self._arena = bytearray(lower_arena)
            self.content_off = np.array(lower_off, dtype=np.int64)
            self.meta.extend(meta)
            self._row_by_chunk_id.update(
                zip((c.id for c in meta), range(n))
            )
            by_doc = self._rows_by_doc
            for row, c in enumerate(meta):
                by_doc.setdefault(c.document_id, []).append(row)
            self._cap = cap
            self._device = None
            self._device_cap = -1
            self._dirty_blocks.clear()
            self._n = n
            self._n_valid = n
            nb = (cap + VALID_BLOCK - 1) // VALID_BLOCK
            self._block_valid = np.zeros(max(nb, 1), dtype=np.int64)
            self._count_valid_added(0, n)
            if converted is not None:
                self._preconverted = dict(converted)

    def bulk_load_compact(
        self,
        *,
        emb8: np.ndarray,         # i8 [n, d] — the embedding column itself
        scale: np.ndarray,        # f32 [n] dequant scales
        raw_norm_sq: np.ndarray,  # f64 [n] (see index/compact.py soundness)
        created_days: np.ndarray, # f32 [n]
        created_us: np.ndarray,   # i64 [n]
        created_ts: np.ndarray,   # f64 [n]
        arena: bytes,             # lowercased contents, concatenated
        content_off: np.ndarray,  # i64 [n+1]
        doc_id: str,
        device: "DeviceArrays",   # pre-built device planes (same bits)
    ) -> None:
        """Compact bulk injection for very large corpora (VERDICT r4 #4;
        index/compact.py module docstring): the host keeps int8+scale
        embedding columns, timestamp columns, and the content arena —
        ~850 B/chunk instead of ~6 KB — and chunk metadata is a LAZY
        CompactMeta sequence. The device planes are passed in pre-built
        (generated on device from the same deterministic recipe as the host
        columns, index/compact.py rows_np/rows_jnp), so no multi-GB
        embedding transfer crosses the link.

        The index becomes SERVING-ONLY: append/update/snapshot raise;
        delete/update-by-id are no-ops (no id map). Engine serving reads:
        valid/window (real columns), the arena (native keyword rescore),
        created_us/_ts/seqs (recency + tie-breaks), materialize_raw_rows
        (exact f64 cosine of selected rows), and meta[row] for the final
        Hit construction."""
        from omni_recall_tpu.index.compact import CompactMeta

        n = int(emb8.shape[0])
        with self._lock:
            if self._n != 0:
                raise ValueError("bulk_load_compact requires an empty index")
            if emb8.shape[1] != self.dim:
                raise ValueError("emb8 dim mismatch")
            if self.mesh is not None:
                raise ValueError(
                    "bulk_load_compact is single-device (shard the corpus "
                    "before building per-shard indexes)"
                )
            self.host_compact = True
            self.emb8_host = np.ascontiguousarray(emb8)
            self.scale_host = np.asarray(scale, dtype=np.float32)
            # poison the f32 mirrors: any code path that still reads them
            # under compact mode must fail loudly, not silently serve zeros
            self.emb = None
            self.raw_emb = None
            self.bloom = None
            self.raw_norm_sq = np.asarray(raw_norm_sq, dtype=np.float64)
            self.created = np.asarray(created_days, dtype=np.float32)
            self.created_us = np.asarray(created_us, dtype=np.int64)
            self.created_ts = np.asarray(created_ts, dtype=np.float64)
            self.seqs = np.arange(n, dtype=np.int64)
            self.valid = np.ones(n, dtype=bool)
            self._arena = bytearray(arena)
            self.content_off = np.asarray(content_off, dtype=np.int64)
            # the arena bytearray is shared (no copy): compact mode never
            # appends, so it can never reallocate under a reader
            self.meta = CompactMeta(
                doc_id, self.emb8_host, self.scale_host, self._arena,
                self.content_off, self.created_us, to_micros(EPOCH),
            )
            self._cap = n
            self._n = n
            self._n_valid = n
            nb = (n + VALID_BLOCK - 1) // VALID_BLOCK
            self._block_valid = np.zeros(max(nb, 1), dtype=np.int64)
            self._count_valid_added(0, n)
            # adopt the caller's device planes: the sync path short-circuits
            # (capacity matches, no dirty blocks)
            self._device = device
            self._device_cap = n
            self._dirty_blocks.clear()

    def install_device_planes(self, dev: "DeviceArrays") -> None:
        """Adopt externally-built device planes for a bulk-loaded index.

        CONTRACT: the planes must be BIT-identical to what the standard
        upload + on-device quantization would produce from this index's
        host mirrors (raw = fl32 of the same values, quantization via
        _device_quantize(_keep), bloom = the same signatures, created/valid
        the same columns) — callers generate them on device from a
        deterministic integer recipe (bench.py build_e2e_engine,
        index/compact.py) to skip a multi-GB host->device transfer, and
        sample-verify the equality. A mismatch would silently break the
        exactness certificate (device bounds vs host rescore), which is
        why this is not a general-purpose setter."""
        with self._lock:
            if dev.emb.shape[0] != self._cap:
                raise ValueError(
                    f"device planes rows {dev.emb.shape[0]} != capacity "
                    f"{self._cap}"
                )
            self._device = dev
            self._device_cap = self._cap
            self._dirty_blocks.clear()

    def materialize_raw_rows(self, rows: np.ndarray) -> np.ndarray:
        """Compact-mode exact-rescore gather: f32 rows for the selected
        candidates, fl32(q8 * scale) — exactly the embedding column the
        compact store defines (index/compact.py soundness note)."""
        sel = self.emb8_host[rows]
        return sel.astype(np.float32) * self.scale_host[rows, None]

    def update_embedding(self, chunk_id: str, embedding: list[float] | None) -> bool:
        with self._lock:
            return self._update_embedding_locked(chunk_id, embedding)

    def _unalias_raw(self) -> None:
        """Break the emb/raw_emb storage alias from an exact-fit bulk_load
        before an in-place write that would diverge them (one-time copy)."""
        if self._raw_aliased:
            self.raw_emb = self.raw_emb.copy()
            self._raw_aliased = False

    def _update_embedding_locked(self, chunk_id: str, embedding) -> bool:
        row = self._row_by_chunk_id.get(chunk_id)
        if row is None or not self.valid[row]:
            return False
        self._unalias_raw()
        # bump BEFORE writing: a search that reads any updated value is
        # guaranteed to observe the new seq when it checks afterwards
        # (engine.rescore_and_certify); searches whose rescore ran entirely
        # before this lock acquisition serialize before the update
        self._update_seq += 1
        vec = self._normalize(embedding)
        self.emb[row] = 0.0 if vec is None else vec
        if embedding is not None and len(embedding) == self.dim:
            raw = np.asarray(embedding, dtype=np.float32)
            self.raw_emb[row] = raw
            self.raw_norm_sq[row] = float(np.sum((raw * raw).astype(np.float64)))
        else:
            self.raw_emb[row] = 0.0
            self.raw_norm_sq[row] = 0.0
        meta = self.meta[row]
        if meta is not None:
            meta.embedding = embedding
        self._mark_dirty(row, row + 1)
        return True

    def delete_document(self, document_id: str) -> int:
        with self._lock:
            return self._delete_document_locked(document_id)

    def _delete_document_locked(self, document_id: str) -> int:
        removed = 0
        for row in self._rows_by_doc.pop(document_id, []):
            chunk = self.meta[row]
            if chunk is not None and self.valid[row]:
                self.valid[row] = False
                self.emb[row] = 0.0
                self.bloom[row] = 0
                self.raw_emb[row] = 0.0
                self.raw_norm_sq[row] = 0.0
                self.meta[row] = None
                self._row_by_chunk_id.pop(chunk.id, None)
                self._block_valid[row // VALID_BLOCK] -= 1
                self._mark_dirty(row, row + 1)
                removed += 1
        self._n_valid -= removed
        return removed

    # ---- candidate window ----

    def window_start_row(self, window: int) -> int:
        """Smallest row r0 such that rows [r0, n) contain <= window valid
        chunks and they are exactly the `window` most recent (rows are in
        (created, seq) order). window <= 0 means no window.

        Cost: O(n/VALID_BLOCK) numpy over the per-block valid counts plus one
        in-block nonzero — sub-millisecond even at 10M rows with 50%
        tombstones (the naive reverse python scan was O(n))."""
        if window <= 0 or self._n_valid <= window:
            return 0
        nb = (self._n + VALID_BLOCK - 1) // VALID_BLOCK
        counts = self._block_valid[:nb]
        # suffix[b] = number of valid rows in blocks >= b
        suffix = np.cumsum(counts[::-1])[::-1]
        hits = np.nonzero(suffix >= window)[0]
        if hits.size == 0:
            return 0
        b = int(hits[-1])  # deepest block whose suffix still covers window
        after = int(suffix[b + 1]) if b + 1 < nb else 0
        need = window - after  # valid rows still needed inside block b
        hi = min(self._n, (b + 1) * VALID_BLOCK)
        in_block = np.nonzero(self.valid[b * VALID_BLOCK : hi])[0]
        if in_block.size == 0:
            # concurrent delete emptied the block between the suffix read and
            # here (readers are lock-free): start at the block boundary — a
            # slightly wider window is safe (the old O(n) scan was equally
            # stale under races)
            return b * VALID_BLOCK
        need = min(need, int(in_block.size))
        return b * VALID_BLOCK + int(in_block[-need])

    # ---- device sync ----

    def _put(self, host: np.ndarray) -> jax.Array:
        if self.mesh is None:
            if (
                isinstance(host, np.ndarray)
                and host.nbytes > _SLAB_UPLOAD_BYTES
            ):
                return _upload_slabbed(host)
            return jnp.asarray(host)
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = P("shards", *([None] * (host.ndim - 1)))
        return jax.device_put(host, NamedSharding(self.mesh, spec))

    def _convert_emb(self, emb_slab: np.ndarray) -> dict[str, np.ndarray]:
        """Host f32 rows -> device scan format (+ int8 scale/err sidecars;
        + the residual refine plane when enabled)."""
        if self.scan_dtype == "int8":
            from omni_recall_tpu.ops.quantize import (
                quantize_rows_int8,
                quantize_rows_int8_residual,
            )

            if self.refine:
                q, scale, err, q2, scale2, err2 = quantize_rows_int8_residual(
                    emb_slab
                )
                return {
                    "emb": q, "scale": scale, "err": err,
                    "emb2": q2, "scale2": scale2, "err2": err2,
                }
            q, scale, err = quantize_rows_int8(emb_slab)
            return {"emb": q, "scale": scale, "err": err}
        return {"emb": emb_slab}

    def device_arrays(self) -> DeviceArrays:
        """Upload pending host changes and return the device-resident SoA.
        Thread-safe against concurrent mutation (shared lock)."""
        with self._lock:
            return self._device_arrays_locked()

    # full uploads at/above this row count quantize ON DEVICE (host f64
    # quantization costs ~10s/65k rows on the burstable host); below it the
    # host path keeps small tests/indexes bit-stable with ops/quantize.py
    _DEVICE_QUANTIZE_MIN_ROWS = 1 << 16

    def _device_arrays_locked(self) -> DeviceArrays:
        if self._device is None or self._device_cap != self._cap:
            pre = self._preconverted
            raw_dev = None
            if pre is not None and pre["emb"].shape[0] == self._cap:
                converted = pre  # snapshot restore: skip re-quantization
                if self.exact_cos:
                    raw_dev = self._put(self.raw_emb)
            elif (
                self.scan_dtype == "int8"
                and self._cap >= self._DEVICE_QUANTIZE_MIN_ROWS
            ):
                # row-sharded indexes upload sharded; the quantizer is
                # row-wise, so its planes keep the row sharding
                up = (
                    _upload_slabbed(self.emb) if self.mesh is None
                    else self._put(self.emb)
                )
                if self.exact_cos and self._raw_aliased:
                    # raw_emb IS emb (bulk_load fast path): ONE f32 upload
                    # serves both the raw plane and the device quantizer
                    # (non-donating twin keeps the buffer alive)
                    raw_dev = up
                    converted = _device_quantize_keep(up, self.refine)
                else:
                    converted = _device_quantize(up, self.refine)
                    if self.exact_cos:
                        raw_dev = self._put(self.raw_emb)
            else:
                converted = self._convert_emb(self.emb)
                if self.exact_cos:
                    raw_dev = self._put(self.raw_emb)
            self._preconverted = None
            self._device = DeviceArrays(
                emb=self._put(converted["emb"]),
                bloom=self._put(self.bloom),
                created=self._put(self.created),
                valid=self._put(self.valid),
                scale=self._put(converted["scale"]) if "scale" in converted else None,
                err=self._put(converted["err"]) if "err" in converted else None,
                emb2=self._put(converted["emb2"]) if "emb2" in converted else None,
                scale2=self._put(converted["scale2"]) if "scale2" in converted else None,
                err2=self._put(converted["err2"]) if "err2" in converted else None,
                raw=raw_dev,
            )
            self._device_cap = self._cap
            self._dirty_blocks.clear()
            return self._device

        if self._dirty_blocks:
            block = self.capacity_block
            dev = self._device
            for b in sorted(self._dirty_blocks):
                b_lo = b * block
                if b_lo >= self._cap:
                    continue
                b_hi = min(b_lo + block, self._cap)
                start = jnp.int32(b_lo)
                converted = self._convert_emb(self.emb[b_lo:b_hi])
                dev = DeviceArrays(
                    emb=_set_slab(dev.emb, jnp.asarray(converted["emb"]), start),
                    bloom=_set_slab(dev.bloom, jnp.asarray(self.bloom[b_lo:b_hi]), start),
                    created=_set_slab(dev.created, jnp.asarray(self.created[b_lo:b_hi]), start),
                    valid=_set_slab(dev.valid, jnp.asarray(self.valid[b_lo:b_hi]), start),
                    scale=(
                        _set_slab(dev.scale, jnp.asarray(converted["scale"]), start)
                        if dev.scale is not None else None
                    ),
                    err=(
                        _set_slab(dev.err, jnp.asarray(converted["err"]), start)
                        if dev.err is not None else None
                    ),
                    emb2=(
                        _set_slab(dev.emb2, jnp.asarray(converted["emb2"]), start)
                        if dev.emb2 is not None else None
                    ),
                    scale2=(
                        _set_slab(dev.scale2, jnp.asarray(converted["scale2"]), start)
                        if dev.scale2 is not None else None
                    ),
                    err2=(
                        _set_slab(dev.err2, jnp.asarray(converted["err2"]), start)
                        if dev.err2 is not None else None
                    ),
                    raw=(
                        _set_slab(
                            dev.raw, jnp.asarray(self.raw_emb[b_lo:b_hi]), start
                        )
                        if dev.raw is not None else None
                    ),
                )
            self._device = dev
            self._dirty_blocks.clear()
        return self._device
