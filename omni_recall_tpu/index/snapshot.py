"""Index snapshot / restore.

The reference delegates durability to Cosmos/Blob and loses the in-memory
store on restart (SURVEY.md §5 "checkpoint/resume — none in-app"). This
rebuild makes persistence first-class: ONE atomically-renamed archive
(``snapshot.npz``) holds the store AND, optionally, the device index's
derived arrays, so a restore is an array upload instead of a re-derivation.

Format v2 (columnar):
- ``meta_json`` — documents + version + per-chunk string dictionaries.
- chunk columns — ids/contents as byte arenas + offsets, doc index,
  chunk index, seq, exact integer-microsecond timestamps, and all chunk
  embeddings as a flat f64 array + offsets (ragged-safe). f64 keeps the
  oracle/host float64 scoring bit-identical across a restore; restored
  records hold zero-copy views into the flat array.
- optional device slabs (``save_snapshot(..., device_index=...)``) — the
  bloom planes, int8 quantization planes (+ the residual refine plane) and
  recency/tie-break columns, in store seq order, with the producing
  parameters. Restoring them (``restore_engine``) skips bloom hashing and
  re-quantization entirely: the 10M-chunk restore drops from ~18 minutes of
  re-derivation to array I/O + upload. A sampled integrity check verifies
  K random rows (bloom signatures, recency/tie-break columns and the
  lowercased arena bit-compared against a re-derivation; quantization
  planes checked for SOUNDNESS — f64 residual norms within the stored
  error bounds) and falls back to the full rebuild on any mismatch — or
  on any exception from malformed arrays — so a stale/foreign slab can
  never produce an unsound index.

The legacy v1 layouts (single-archive JSON-chunks and the two-file
meta.json + embeddings.npz) are still loadable.

``load_snapshot`` rebuilds the host store with identical seq ordering, so a
restored device index reproduces bit-identical rankings (rows are appended
in (created_at, seq) order). Raw blobs are the raw-document store's concern
(LocalFileRawDocumentStore already persists to disk)."""

from __future__ import annotations

import contextlib
import json
import logging
import os
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np

from omni_recall_tpu.contracts import iso_utc
from omni_recall_tpu.index.records import ChunkRecord, DocumentRecord
from omni_recall_tpu.index.store import InMemoryIngestionStore

FORMAT_VERSION = 3
# bumped when the signature/quantization derivation changes incompatibly —
# slabs from another derivation version fall back to the full rebuild
# (v2: f32-evaluated quantization error bounds, ops/quantize.py)
SLAB_VERSION = 2
# v3 layout: a DIRECTORY (snapshot.d) holding meta.json + one .npy per
# array, swapped in with directory renames. Arrays load with
# mmap_mode="c" (copy-on-write): restore pays page-in only for what it
# touches — the scan planes stream to the device, while the f64 embedding
# store and f32 mirrors stay lazy until a rescore touches their rows.

_EPOCH70 = datetime(1970, 1, 1, tzinfo=timezone.utc)
_INTEGRITY_SAMPLE = 64

logger = logging.getLogger(__name__)


def _parse_dt(value: str | None) -> datetime | None:
    if not value:
        return None
    return datetime.fromisoformat(value.replace("Z", "+00:00"))


def _collect(store: InMemoryIngestionStore):
    # one consistent read: the store's lock (when present) makes the
    # documents and their chunk lists a single atomic view — without it a
    # concurrent delete between list_documents and get_chunks leaves a
    # ghost document with chunkCount > 0 but no chunks in the snapshot
    lock = getattr(store, "_lock", None) or contextlib.nullcontext()
    with lock:
        documents = store.list_documents(2**31 - 1)
        chunks: list[ChunkRecord] = []
        for doc in documents:
            chunks.extend(store.get_chunks_by_document_id(doc.id))
    chunks.sort(key=lambda c: c.seq)
    return documents, chunks


def _byte_arena(items: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    off = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in items], out=off[1:])
    return np.frombuffer(b"".join(items), dtype=np.uint8), off


def save_snapshot(
    store: InMemoryIngestionStore,
    path: str | Path,
    device_index=None,
) -> None:
    """Write ``snapshot.npz`` atomically. When ``device_index`` is given and
    covers every live chunk, its derived arrays are embedded so a matching
    engine restores without re-deriving (see restore_engine)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    documents, chunks = _collect(store)
    n = len(chunks)

    ids_arena, ids_off = _byte_arena([c.id.encode("utf-8") for c in chunks])
    contents_arena, contents_off = _byte_arena(
        [c.content.encode("utf-8", errors="surrogatepass") for c in chunks]
    )
    doc_order = {d.id: i for i, d in enumerate(documents)}
    doc_idx = np.asarray([doc_order[c.document_id] for c in chunks], dtype=np.int32)
    chunk_index = np.asarray([c.chunk_index for c in chunks], dtype=np.int32)
    seq = np.asarray([c.seq for c in chunks], dtype=np.int64)
    has_created = np.asarray([c.created_at_utc is not None for c in chunks], dtype=bool)
    created_us = np.asarray(
        [
            _to_us(c.created_at_utc) if c.created_at_utc is not None else 0
            for c in chunks
        ],
        dtype=np.int64,
    )
    # string dictionaries for the (practically constant) cosmos-shape fields
    pk_values = sorted({c.partition_key for c in chunks}) or ["user:default"]
    type_values = sorted({c.type for c in chunks}) or ["chunk"]
    pk_idx = np.asarray(
        [pk_values.index(c.partition_key) for c in chunks], dtype=np.int16
    )
    type_idx = np.asarray(
        [type_values.index(c.type) for c in chunks], dtype=np.int16
    )

    flat: list[np.ndarray] = []
    offsets = np.zeros(n + 1, dtype=np.int64)
    has_emb = np.zeros(n, dtype=bool)
    for i, chunk in enumerate(chunks):
        # f64: the oracle/host-scan paths score the RAW embedding values in
        # float64, so an f32 round-trip would shift post-restore scores in
        # the low bits (near-ties could swap rank across a restart)
        e = chunk.embedding
        has_emb[i] = e is not None
        vec = (
            np.asarray(e, dtype=np.float64)
            if e is not None else np.zeros(0, dtype=np.float64)
        )
        flat.append(vec)
        offsets[i + 1] = offsets[i] + vec.size
    emb_flat = np.concatenate(flat) if flat else np.zeros(0, dtype=np.float64)

    meta = {
        "version": FORMAT_VERSION,
        "documents": [
            {
                "id": d.id, "fileName": d.file_name, "sourceType": d.source_type,
                "blobPath": d.blob_path, "contentHash": d.content_hash,
                "chunkCount": d.chunk_count,
                "createdAtUtc": iso_utc(d.created_at_utc) if d.created_at_utc else None,
            }
            for d in documents
        ],
        "pk_values": pk_values,
        "type_values": type_values,
        "n_chunks": n,
    }

    arrays = {
        "ids_arena": ids_arena, "ids_off": ids_off,
        "contents_arena": contents_arena, "contents_off": contents_off,
        "doc_idx": doc_idx, "chunk_index": chunk_index, "seq": seq,
        "has_created": has_created, "created_us": created_us,
        "pk_idx": pk_idx, "type_idx": type_idx,
        "emb_flat": emb_flat, "offsets": offsets, "has_emb": has_emb,
    }

    slabs = _gather_slabs(device_index, chunks) if device_index is not None else None
    if slabs is not None:
        meta["slabs"] = slabs.pop("params")
        arrays.update({f"slab_{k}": v for k, v in slabs.items()})

    # ONE archive directory + directory renames: meta and arrays are
    # written fully into a temp dir, then swapped in — a crash mid-save
    # leaves the previous good snapshot untouched (at worst a fully-written
    # snapshot.d.old survives alongside, which the loader also accepts).
    # Separate uncompressed .npy members let the loader mmap them
    # copy-on-write (lazy page-in); zlib over multi-GB slabs would dominate
    # the save and defeat the mmap restore.
    tmp = path / f".snapshot.{os.getpid()}.tmp"
    if tmp.exists():
        import shutil

        shutil.rmtree(tmp)
    tmp.mkdir()
    (tmp / "meta.json").write_text(json.dumps(meta), encoding="utf-8")
    for k, v in arrays.items():
        np.save(tmp / f"{k}.npy", v)
    final = path / "snapshot.d"
    old = path / f"snapshot.d.old.{os.getpid()}"
    if final.exists():
        os.replace(final, old)
    os.replace(tmp, final)
    if old.exists():
        import shutil

        shutil.rmtree(old)
    # clean up legacy layouts so stale versions can't be loaded
    for legacy in ("meta.json", "embeddings.npz", "snapshot.npz"):
        with contextlib.suppress(OSError):
            (path / legacy).unlink()


def _to_us(dt: datetime) -> int:
    from omni_recall_tpu.index.device_index import to_micros

    return to_micros(dt)


def _gather_slabs(dix, chunks: list[ChunkRecord]) -> dict | None:
    """Derived arrays for the store's live chunks, in seq order, from the
    device index's host mirrors. Returns None (slabs omitted, restore falls
    back to rebuild) when the index doesn't cover the chunk list exactly.

    The quantization planes come from (fastest available first):
    1. the staged pre-quantized planes a snapshot restore injected
       (``_preconverted``) — zero cost;
    2. the LIVE device planes, read back in one transfer — array I/O
       instead of a multi-pass host re-quantization (which dominated saves:
       ~1 min at 256k rows on the burstable host). The readback is exactly
       what the scan/refine kernels score against, so the saved planes are
       sound by construction (restore re-verifies a sample, f64);
    3. host re-quantization of the normalized mirrors (cold fallback, e.g.
       when rows were mutated since the last device sync)."""
    from omni_recall_tpu.ops.quantize import (
        quantize_rows_int8,
        quantize_rows_int8_residual,
    )

    if dix.scan_dtype != "int8":
        return None  # f32/bf16 restores re-upload the mirrors anyway
    with dix._lock:
        rows = []
        for c in chunks:
            r = dix._row_by_chunk_id.get(c.id)
            if r is None or not dix.valid[r]:
                return None
            rows.append(r)
        rows = np.asarray(rows, dtype=np.int64)
        emb_norm = dix.emb[rows]
        bloom = dix.bloom[rows]
        created = dix.created[rows]
        created_ts = dix.created_ts[rows]
        raw_emb = dix.raw_emb[rows]
        raw_norm_sq = dix.raw_norm_sq[rows]
        lower = [
            bytes(dix._arena[dix.content_off[r] : dix.content_off[r + 1]])
            for r in rows
        ]
        # capture plane sources under the lock; the actual readback happens
        # outside it (device snapshots are immutable — a concurrent sync
        # builds NEW DeviceArrays, it never mutates these buffers)
        pre = dix._preconverted
        if pre is not None and (
            pre["emb"].shape[0] < dix.n_rows
            or bool(dix.refine) != ("emb2" in pre)
            # a mutation since the restore (append consumed above; in-place
            # embedding update) leaves dirty blocks — the staged planes no
            # longer match the mirrors for those rows
            or dix._dirty_blocks
        ):
            pre = None
        dev = None
        if pre is None:
            dev = dix._device
            if (
                dev is None or dix._device_cap != dix._cap
                or dix._dirty_blocks or dev.scale is None
                or (dix.refine and dev.emb2 is None)
            ):
                dev = None
        n_rows_snap = dix.n_rows
    lower_arena, lower_off = _byte_arena(lower)
    out = {
        "emb_norm": emb_norm, "bloom": bloom,
        "created": created, "created_ts": created_ts,
        # persisted exact-rescore mirrors: a v3 restore adopts these as
        # copy-on-write mmaps instead of re-deriving them from the f64 store
        "raw_emb": raw_emb, "raw_norm_sq": raw_norm_sq,
        "lower_arena": lower_arena, "lower_off": lower_off,
    }
    if pre is None and dev is not None:
        # Probe the device->host transfer before committing to the
        # readback: over PCIe the readback beats host re-quantization by an
        # order of magnitude, but a slow device link can make it slower
        # than re-quantizing on the host. The probe costs one ~0.4 MB
        # transfer. OMNI_SNAPSHOT_PLANES=device|host|auto overrides.
        import time as _time

        import jax

        mode = os.environ.get("OMNI_SNAPSHOT_PLANES", "auto")
        plane_bytes_all = len(rows) * dix.dim * (2 if dix.refine else 1)
        if mode == "host":
            dev = None
        elif mode == "auto" and plane_bytes_all >= (8 << 20):
            probe_rows = min(512, n_rows_snap)
            t0 = _time.perf_counter()
            jax.device_get(dev.emb[:probe_rows])
            dt = max(_time.perf_counter() - t0, 1e-9)
            bw = probe_rows * dix.dim / dt  # bytes/s (int8 plane)
            # host fallback re-quantizes len(rows) f32 rows in ~5 passes at
            # O(100 MB/s); prefer the readback only when its estimate wins
            host_est = len(rows) * dix.dim * 4 * 5 / 100e6
            if plane_bytes_all / bw > host_est:
                dev = None
    deriv = "host"
    if pre is not None:
        deriv = "staged"
        out.update(
            q1=pre["emb"][rows], s1=pre["scale"][rows], e1=pre["err"][rows]
        )
        if dix.refine:
            out.update(
                q2=pre["emb2"][rows], s2=pre["scale2"][rows],
                e2=pre["err2"][rows],
            )
    elif dev is not None:
        deriv = "device"
        import jax

        nr = n_rows_snap
        if len(rows) == nr and np.array_equal(rows, np.arange(nr)):
            parts = [dev.emb[:nr], dev.scale[:nr], dev.err[:nr]]
            if dix.refine:
                parts += [dev.emb2[:nr], dev.scale2[:nr], dev.err2[:nr]]
            host = jax.device_get(parts)
        else:
            # snapshot covers a subset/permutation of the index rows:
            # gather ON DEVICE so the transfer moves only the snapshot's
            # rows, not the whole (possibly much larger) index
            import jax.numpy as jnp

            rows_d = jnp.asarray(rows)
            parts = [dev.emb[rows_d], dev.scale[rows_d], dev.err[rows_d]]
            if dix.refine:
                parts += [
                    dev.emb2[rows_d], dev.scale2[rows_d], dev.err2[rows_d]
                ]
            host = jax.device_get(parts)
        out.update(q1=host[0], s1=host[1], e1=host[2])
        if dix.refine:
            out.update(q2=host[3], s2=host[4], e2=host[5])
    elif dix.refine:
        q1, s1, e1, q2, s2, e2 = quantize_rows_int8_residual(emb_norm)
        out.update(q1=q1, s1=s1, e1=e1, q2=q2, s2=s2, e2=e2)
    else:
        q1, s1, e1 = quantize_rows_int8(emb_norm)
        out.update(q1=q1, s1=s1, e1=e1)
    out["params"] = {
        "deriv": deriv,
        "slab_version": SLAB_VERSION,
        "dim": dix.dim, "bloom_bits": dix.bloom_bits, "ngram": dix.ngram,
        "bloom_hashes": dix.bloom_hashes, "scan_dtype": dix.scan_dtype,
        "refine": dix.refine,
    }
    return out


def snapshot_exists(path: str | Path) -> bool:
    """True when ``path`` holds a loadable snapshot in ANY supported layout
    (v3 directory, crash-leftover .old directory, v1/v2 archives)."""
    path = Path(path)
    return (
        (path / "snapshot.d").is_dir()
        or any(path.glob("snapshot.d.old.*"))
        or (path / "snapshot.npz").is_file()
        or (path / "meta.json").is_file()
    )


def load_snapshot(path: str | Path) -> InMemoryIngestionStore:
    store, _ = load_snapshot_full(path)
    return store


def load_snapshot_full(path: str | Path):
    """Returns (store, aux). ``aux`` is None for legacy snapshots; for v2 it
    carries the raw arrays (chunk list in seq order, flat f64 embeddings,
    slab arrays when present) that restore_engine uses for the fast path."""
    path = Path(path)
    snap_dir = path / "snapshot.d"
    if not snap_dir.is_dir():
        # crash between the two save renames: accept a fully-written .old
        olds = sorted(path.glob("snapshot.d.old.*"))
        if olds:
            snap_dir = olds[-1]
    bundle = path / "snapshot.npz"
    if snap_dir.is_dir():
        meta = json.loads((snap_dir / "meta.json").read_text(encoding="utf-8"))
        # copy-on-write mmap: open cost is O(1); pages fault in on first
        # touch and writes never reach the snapshot files
        arrays = {
            p.stem: np.load(p, mmap_mode="c")
            for p in snap_dir.glob("*.npy")
        }
    elif bundle.is_file():
        # v1/v2 single-archive layout — context-manage the NpzFile: np.load
        # keeps the underlying file handle open for the process lifetime
        # otherwise
        with np.load(bundle) as npz:
            meta = json.loads(bytes(npz["meta_json"].tobytes()).decode("utf-8"))
            arrays = {k: npz[k] for k in npz.files if k != "meta_json"}
    else:  # legacy two-file layout (pre-atomic-save snapshots)
        meta = json.loads((path / "meta.json").read_text(encoding="utf-8"))
        with np.load(path / "embeddings.npz") as npz:
            arrays = {k: npz[k] for k in npz.files}
    version = meta.get("version")
    if version == 1:
        return _load_v1(meta, arrays), None
    if version not in (2, FORMAT_VERSION):
        raise ValueError(f"Unsupported snapshot version: {version}")

    documents = [
        DocumentRecord(
            id=d["id"], file_name=d["fileName"], source_type=d["sourceType"],
            blob_path=d["blobPath"], content_hash=d["contentHash"],
            chunk_count=d["chunkCount"], created_at_utc=_parse_dt(d["createdAtUtc"]),
        )
        for d in meta["documents"]
    ]
    n = int(meta["n_chunks"])
    ids_b = arrays["ids_arena"].tobytes()
    ids_off = arrays["ids_off"]
    contents_b = arrays["contents_arena"].tobytes()
    contents_off = arrays["contents_off"]
    doc_idx = arrays["doc_idx"]
    chunk_index = arrays["chunk_index"]
    seq = arrays["seq"]
    has_created = arrays["has_created"]
    created_us = arrays["created_us"]
    pk_values = meta["pk_values"]
    type_values = meta["type_values"]
    pk_idx = arrays["pk_idx"]
    type_idx = arrays["type_idx"]
    emb_flat, offsets, has_emb = (
        arrays["emb_flat"], arrays["offsets"], arrays["has_emb"],
    )

    doc_ids = [d.id for d in documents]
    chunks: list[ChunkRecord] = []
    chunks_by_doc: dict[str, list[ChunkRecord]] = {d.id: [] for d in documents}
    for i in range(n):
        cid = ids_b[ids_off[i] : ids_off[i + 1]].decode("utf-8")
        content = contents_b[contents_off[i] : contents_off[i + 1]].decode(
            "utf-8", errors="surrogatepass"
        )
        # exact integer-microsecond reconstruction (timedelta arithmetic:
        # no float rounding, unlike fromtimestamp)
        created = (
            _EPOCH70 + timedelta(microseconds=int(created_us[i]))
            if has_created[i] else None
        )
        doc_id = doc_ids[doc_idx[i]]
        rec = ChunkRecord(
            id=cid, document_id=doc_id, chunk_index=int(chunk_index[i]),
            content=content,
            # zero-copy f64 view: python-list conversion at 1M+ chunks costs
            # tens of seconds; every consumer handles array sequences
            embedding=emb_flat[offsets[i] : offsets[i + 1]] if has_emb[i] else None,
            created_at_utc=created,
            partition_key=pk_values[pk_idx[i]],
            type=type_values[type_idx[i]],
            seq=int(seq[i]),
        )
        chunks.append(rec)
        chunks_by_doc.setdefault(doc_id, []).append(rec)

    store = InMemoryIngestionStore()
    # per-document lists were accumulated in global seq order; the store
    # contract (bulk_restore docstring / upsert_chunks sorting,
    # InMemoryIngestionStore.cs:17-25) wants chunk_index order — they differ
    # for documents whose chunk ids were ever replaced (fresh seq mid-list).
    # sorted() is stable, so equal chunk_index keeps seq order.
    for doc_chunks in chunks_by_doc.values():
        doc_chunks.sort(key=lambda c: c.chunk_index)
    store.bulk_restore(documents, chunks_by_doc, next_seq=int(seq.max()) + 1 if n else 0)

    aux = {
        "meta": meta,
        "chunks": chunks,  # seq order (save order)
        "emb_flat": emb_flat, "offsets": offsets, "has_emb": has_emb,
        "seq": seq, "created_us": created_us, "has_created": has_created,
        "slabs": (
            {k[5:]: v for k, v in arrays.items() if k.startswith("slab_")}
            | {"params": meta["slabs"]}
            if "slabs" in meta else None
        ),
    }
    return store, aux


def _load_v1(meta: dict, arrays: dict) -> InMemoryIngestionStore:
    emb_flat, offsets, has_emb = arrays["emb_flat"], arrays["offsets"], arrays["has_emb"]
    store = InMemoryIngestionStore()
    for d in meta["documents"]:
        store.upsert_document(
            DocumentRecord(
                id=d["id"], file_name=d["fileName"], source_type=d["sourceType"],
                blob_path=d["blobPath"], content_hash=d["contentHash"],
                chunk_count=d["chunkCount"], created_at_utc=_parse_dt(d["createdAtUtc"]),
            )
        )
    chunks: list[ChunkRecord] = []
    for i, c in enumerate(meta["chunks"]):
        vec = emb_flat[offsets[i] : offsets[i + 1]]
        chunks.append(
            ChunkRecord(
                id=c["id"], document_id=c["documentId"], chunk_index=c["chunkIndex"],
                content=c["content"],
                embedding=vec.tolist() if bool(has_emb[i]) else None,
                created_at_utc=_parse_dt(c["createdAtUtc"]),
                seq=c["seq"],
            )
        )
    store.upsert_chunks(chunks)  # seq preserved: records carry their seq
    store._seq = max((c.seq for c in chunks), default=-1) + 1
    return store


def restore_engine(store: InMemoryIngestionStore, engine, aux=None) -> None:
    """Rebuild the device index from a restored store, preserving row order.

    With ``aux`` from load_snapshot_full (v2 + slabs + matching engine
    parameters + passing integrity sample), the index is bulk-loaded from
    the persisted derived arrays — no bloom hashing, no re-quantization, no
    per-chunk python append. Any mismatch falls back to the exact rebuild."""
    if aux is not None and aux.get("slabs") is not None:
        try:
            ok = _try_restore_slabs(store, engine, aux)
        except Exception:
            # malformed/truncated arrays raise (shape errors from load_slabs,
            # decode errors, ...) — degrade to the exact rebuild instead of
            # letting the caller's broad except boot an EMPTY index.
            # load_slabs validates shapes BEFORE mutating, so the index is
            # still empty here and the rebuild path below is safe.
            logger.exception("snapshot slab restore raised; rebuilding")
            ok = False
        if ok:
            return
        logger.warning(
            "snapshot slabs unusable (parameter/integrity mismatch); "
            "falling back to full index rebuild"
        )
    chunks: list[ChunkRecord] = []
    for doc in store.list_documents(2**31 - 1):
        chunks.extend(store.get_chunks_by_document_id(doc.id))
    chunks.sort(key=lambda c: c.seq)
    engine.on_chunks_upserted(chunks, new=True)


def _try_restore_slabs(store, engine, aux) -> bool:
    from omni_recall_tpu.ops import hashing

    dix = engine.device_index
    if dix is None or dix.n_rows != 0:
        return False
    slabs = aux["slabs"]
    p = slabs["params"]
    if (
        p.get("slab_version") != SLAB_VERSION
        or p.get("dim") != dix.dim
        or p.get("bloom_bits") != dix.bloom_bits
        or p.get("ngram") != dix.ngram
        or p.get("bloom_hashes") != dix.bloom_hashes
        or p.get("scan_dtype") != dix.scan_dtype
        or bool(p.get("refine")) != dix.refine
    ):
        return False
    chunks = aux["chunks"]
    n = len(chunks)
    if n == 0:
        return True  # nothing to load
    if slabs["q1"].shape[0] != n:
        return False
    emb_flat, offsets, has_emb = aux["emb_flat"], aux["offsets"], aux["has_emb"]
    sizes = np.diff(offsets)
    uniform = bool(np.all(sizes[has_emb] == dix.dim)) if has_emb.any() else True
    if not uniform:
        return False  # mixed-dimension embeddings: rare, use the rebuild

    rng = np.random.default_rng(0)
    sample = np.sort(rng.choice(n, size=min(_INTEGRITY_SAMPLE, n), replace=False))
    from omni_recall_tpu.ops.oracle import lower_invariant

    if "raw_emb" in slabs:
        # v3: mirrors persisted (adopted as copy-on-write mmaps — lazy).
        # Soundness requires emb_norm to BE the normalization of raw_emb
        # (the device bounds derive from emb_norm while the exact rescore
        # reads raw_emb; a mismatched pair could exclude a true top-k row),
        # so the sample check verifies the raw<->f64-store and
        # raw<->emb_norm relations as well as the derived planes below.
        emb_norm, raw_emb, raw_norm_sq = (
            slabs["emb_norm"], slabs["raw_emb"], slabs["raw_norm_sq"],
        )
        if emb_norm.shape != (n, dix.dim) or raw_emb.shape != (n, dix.dim):
            return False
        for i in sample:
            seg = emb_flat[offsets[i] : offsets[i + 1]].astype(np.float32)
            if has_emb[i] and seg.size == dix.dim:
                if not np.array_equal(seg, raw_emb[i]):
                    return False
                nsq = float(np.sum(seg * seg, dtype=np.float64))
                if nsq != float(raw_norm_sq[i]):
                    return False
                if nsq > 0.0:
                    unit = (seg.astype(np.float64) / np.sqrt(nsq)).astype(
                        np.float64
                    )
                    # tolerate the <= ~2-ulp difference between the f64-
                    # divide and f32-reciprocal normalization variants; the
                    # scan/refine error budgets cover far more (ops/refine.py)
                    if not np.allclose(
                        emb_norm[i].astype(np.float64), unit,
                        rtol=5e-7, atol=1e-9,
                    ):
                        return False
            elif np.any(raw_emb[i]) or raw_norm_sq[i] != 0.0 or np.any(emb_norm[i]):
                return False
    else:
        # v2 archives: derive the mirrors from the f64 store — vectorized,
        # bit-identical to DeviceIndex._normalize / _append_locked's batch
        # path (f32 cast -> f64 norm -> f64 divide -> f32)
        raw_emb = np.zeros((n, dix.dim), dtype=np.float32)
        raw_norm_sq = np.zeros(n, dtype=np.float64)
        emb_norm = np.zeros((n, dix.dim), dtype=np.float32)
        if has_emb.any():
            rows = np.nonzero(has_emb)[0]
            # emb-less chunks occupy zero-size segments, so emb_flat is
            # exactly the concatenation of the embedded rows' vectors
            a = emb_flat.astype(np.float32).reshape(len(rows), dix.dim)
            # _normalize computes the norm from the f32-cast values
            nsq = np.sum(a * a, axis=1, dtype=np.float64)
            ok = nsq > 0.0
            normed = np.zeros_like(a)
            normed[ok] = (
                a[ok].astype(np.float64) / np.sqrt(nsq[ok])[:, None]
            ).astype(np.float32)
            raw_emb[rows] = a
            raw_norm_sq[rows] = nsq
            emb_norm[rows] = normed

    # integrity sample: re-derive K rows and bit-compare against the slabs —
    # a stale or foreign slab archive must never produce an unsound index

    if (
        slabs["bloom"].shape != (n, dix.bloom_bits // 8)
        or slabs["created"].shape != (n,)
        or slabs["created_ts"].shape != (n,)
        or slabs["lower_off"].shape != (n + 1,)
        or int(slabs["lower_off"][0]) != 0
        or not bool(np.all(np.diff(slabs["lower_off"]) >= 0))
        or int(slabs["lower_off"][n]) != slabs["lower_arena"].shape[0]
    ):
        return False
    lows = [lower_invariant(chunks[i].content) for i in sample]
    sig = hashing.chunk_signatures_batch(
        lows, dix.bloom_bits, dix.ngram, dix.bloom_hashes,
    )
    if not np.array_equal(sig, slabs["bloom"][sample]):
        return False
    # recency/tie-break columns and the lowercased arena feed the device
    # recency term, the ranking tie-break, and the exact keyword rescore —
    # a stale created column understates the scan's upper bound (recency
    # grows toward now), which could silently exclude a true top-k row, so
    # they are part of the sample, not trusted from the archive
    from omni_recall_tpu.index.device_index import _aware, to_days

    lower_b = slabs["lower_arena"].tobytes()
    lower_off = slabs["lower_off"]
    for i, low in zip(sample, lows):
        c = chunks[i]
        if np.float32(to_days(c.created_at_utc)) != np.float32(
            slabs["created"][i]
        ):
            return False
        if _aware(c.created_at_utc).timestamp() != float(
            slabs["created_ts"][i]
        ):
            return False
        if (
            lower_b[int(lower_off[i]) : int(lower_off[i + 1])]
            != low.encode("utf-8", errors="surrogatepass")
        ):
            return False
    # Quantization planes: verify SOUNDNESS, not bit-equality. The saved
    # planes may come from the host quantizer (ops/quantize.py), the
    # on-device quantizer (index/device_index.py _device_quantize) or a
    # device readback — numerically interchangeable but not bit-identical.
    # The scan/refine bounds stay sound for ANY (q, s, e) planes satisfying
    #   || emb_norm[i] - q1[i]*s1[i] ||            <= e1[i]
    #   || emb_norm[i] - q1[i]*s1[i] - q2[i]*s2[i] || <= e2[i]
    # (the kernels' error folding assumes only these inequalities plus
    # ||emb_norm|| <= 1, which the raw<->emb_norm relation above pins), so
    # the sample check evaluates the residual norms in f64 against the
    # stored bounds — a foreign/stale plane that could exclude a true
    # top-k row cannot pass, while a tighter-or-looser legitimate
    # derivation restores cleanly.
    plane_names = ("q1", "s1", "e1") + (("q2", "s2", "e2") if dix.refine else ())
    for name in plane_names:
        a = slabs.get(name)
        if a is None or a.shape[0] != n:
            return False
        if name[0] == "q":
            if a.dtype != np.int8 or a.shape != (n, dix.dim):
                return False
        elif a.dtype != np.float32 or a.ndim != 1:
            return False
    x = emb_norm[sample].astype(np.float64)
    q1 = slabs["q1"][sample].astype(np.float64)
    s1 = slabs["s1"][sample].astype(np.float64)[:, None]
    sf = (slabs["s1"][sample], slabs["e1"][sample])
    r1 = x - q1 * s1
    # `<=` (not `not >`): a NaN scale/bound must FAIL the check
    if not np.all(
        np.sqrt(np.sum(r1 * r1, axis=1))
        <= slabs["e1"][sample].astype(np.float64)
    ) or not all(np.all(np.isfinite(a)) for a in sf):
        return False
    if dix.refine:
        q2 = slabs["q2"][sample].astype(np.float64)
        s2 = slabs["s2"][sample].astype(np.float64)[:, None]
        r2 = r1 - q2 * s2
        if not np.all(
            np.sqrt(np.sum(r2 * r2, axis=1))
            <= slabs["e2"][sample].astype(np.float64)
        ) or not all(
            np.all(np.isfinite(slabs[k][sample])) for k in ("s2", "e2")
        ):
            return False
        converted = {
            "emb": slabs["q1"], "scale": slabs["s1"], "err": slabs["e1"],
            "emb2": slabs["q2"], "scale2": slabs["s2"], "err2": slabs["e2"],
        }
    else:
        converted = {
            "emb": slabs["q1"], "scale": slabs["s1"], "err": slabs["e1"],
        }

    # device mirror wants to_micros(None) (datetime.min) for missing stamps
    created_us = np.where(
        aux["has_created"], aux["created_us"], _to_us(None)
    ).astype(np.int64)

    dix.load_slabs(
        chunks,
        emb_norm=emb_norm, raw_emb=raw_emb, raw_norm_sq=raw_norm_sq,
        bloom=slabs["bloom"], created=slabs["created"],
        created_us=created_us, created_ts=slabs["created_ts"],
        seqs=np.asarray(aux["seq"], dtype=np.int64),
        lower_arena=slabs["lower_arena"].tobytes(),
        lower_off=np.asarray(slabs["lower_off"], dtype=np.int64),
        converted=converted,
    )
    return True
