"""Certified-exact hybrid search engine.

The reference scores every candidate chunk on the host
(RecallSearchService.cs:28-37). Here the device computes a *sound upper
bound* per chunk (ops/xla_scorer.py / ops/scan.py) and returns the
top-M candidate rows; the host then exact-rescores only those M candidates
with the float64 oracle (substring keyword semantics included) and verifies a
certificate:

    exact_score(k-th hit)  >  max upper bound over all excluded rows

If the certificate fails (adversarially tight score distributions), M is
escalated x4 until the candidate set covers the whole window, at which point
the excluded set is empty and the result is trivially exact. The returned
ranking is therefore identical to scoring every chunk exactly.

Final ordering: score desc, then created_at desc (reference tie-break,
RecallSearchService.cs:34-35), then insertion seq desc (determinism beyond
the reference, whose final tie order is ConcurrentDictionary enumeration
order — i.e. unspecified).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from datetime import datetime, timezone
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from omni_recall_tpu.config import EngineOptions
from omni_recall_tpu.index.device_index import DeviceIndex, to_days
from omni_recall_tpu.index.records import ChunkRecord
from omni_recall_tpu.index.store import InMemoryIngestionStore
from omni_recall_tpu.ops import hashing, oracle, xla_scorer

# deepest per-slice extraction of the scan (ops/scan.py)
SCAN_MAX_T = 8


def _start_host_copies(arrays) -> None:
    """Kick off device->host transfers asynchronously (jax Array
    copy_to_host_async): the pipelined executor dispatches every batch's
    scans before finalizing any, so by finalize time the compact candidate
    slices are already on the host and device_get returns without paying
    the per-readback transport round trip."""
    for a in arrays:
        fn = getattr(a, "copy_to_host_async", None)
        if fn is not None:
            try:
                fn()
            except Exception:  # transfer still happens synchronously later
                pass


@jax.jit
def _normalize_q(q_raw: jax.Array, inv_norm: jax.Array) -> jax.Array:
    """Normalize the raw query matrix ON DEVICE with host-computed f64
    inverse norms rounded to f32 (6 KB instead of a second [B, d] f32
    upload). q_raw * f32(1/sqrt(qn)) differs
    from the host's f32(f64(q_raw)/sqrt(qn)) by <= ~2 ulps per element
    (vector error ~3e-7) — inside the documented normalized-vs-oracle slack
    of both bound budgets (ops/refine.py REFINE_EPS, ops/scan.py
    CERT_EPS_INT8): a slightly different device query only shifts the
    SOUND upper bounds, never the host-exact scores."""
    return q_raw * inv_norm[:, None]


@jax.jit
def _assemble_q(enc_rows: jax.Array, enc_idx: jax.Array,
                host_rows: jax.Array, host_idx: jax.Array,
                base: jax.Array) -> jax.Array:
    """Assemble the raw [B, d] query matrix ON DEVICE from device-embedded
    rows (the local encoder's forward output — never leaves the device) and
    the (usually empty) minority of host-supplied rows, uploaded as a
    compact [h, d] slab. ``base`` is a zeros template carrying the target
    shape."""
    out = base.at[enc_idx].set(enc_rows)
    return out.at[host_idx].set(host_rows)


@jax.jit
def _normalize_q_dd(q_raw: jax.Array, qhi: jax.Array) -> jax.Array:
    """Normalize device-resident raw queries with the double-float self-norm
    hi word (ops/exact_cos.self_norm_dd): inv = 1/sqrt(qhi) in f32 deviates
    from the host path's f32(1/sqrt(qn_f64)) by <= ~2 ulps + 0.5*DD_SUM_REL
    (~1.3e-7 relative) — inside the same documented normalized-vs-oracle
    slack of the scan/refine bound budgets as _normalize_q (ops/refine.py
    REFINE_EPS, ops/scan.py CERT_EPS_INT8). Zero-norm rows
    normalize to 0, exactly like the host path."""
    inv = jnp.where(qhi > 0.0, 1.0 / jnp.sqrt(qhi), 0.0)
    return q_raw * inv[:, None]


def _rehome_rows(
    b: int, pending: list[int], arrays_fills
) -> list[np.ndarray]:
    """Scatter per-pending-row arrays back to their full-batch positions
    (the certify helpers index by batch position). Non-pending rows get the
    fill value (-inf bounds / -1 row ids), which every consumer treats as
    dead lanes."""
    out = []
    for a, fill in arrays_fills:
        f = np.full((b,) + a.shape[1:], fill, a.dtype)
        f[pending] = a[: len(pending)]
        out.append(f)
    return out


@partial(jax.jit, static_argnames=("bits",))
def _densify_kw(idx: jax.Array, val: jax.Array, bits: int) -> jax.Array:
    """Scatter the sparse per-query keyword weights (idx i32[B, T] with -1
    padding, val f32[B, T]) into the dense [B, bits] matrix the kernels
    consume. Indices are UNIQUE per query (np.nonzero extraction), so the
    scatter-add reproduces the host-built dense weights bit-for-bit: each
    real cell receives exactly one add onto 0.0, pads add 0.0 at column 0.
    Cuts the dominant per-batch upload ([B, bits] f32, 6.3 MB at B=1536)
    to ~T*8 bytes/query."""
    b, t = idx.shape
    rows = jnp.broadcast_to(jnp.arange(b)[:, None], (b, t))
    safe = jnp.maximum(idx, 0)
    zeros = jnp.zeros((b, bits), dtype=val.dtype)
    return zeros.at[rows, safe].add(jnp.where(idx >= 0, val, 0.0))


def _dd_certify_batch(
    scores_s: np.ndarray,
    margins_s: np.ndarray,
    seg: np.ndarray,
    lens: np.ndarray,
    k_arr: np.ndarray,
    bnd: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized device-exact-cosine certification over a batch of queries
    (the per-query python loop was the serving pipeline's host bottleneck at
    B=1536 on quota'd hosts).

    Inputs are the owner-contiguous flat candidate arrays (``scores_s``,
    ``margins_s`` sorted descending within each segment; ``seg`` the P+1
    segment offsets; ``lens`` per-query candidate counts; ``k_arr`` requested
    top-k; ``bnd`` the per-query device certificate bound, -inf when the
    candidate slice covers the whole snapshot). Returns boolean masks
    ``(resolved, provable_fail, kk)``:

    - ``provable_fail`` — the exact kth (which lies within the margin)
      cannot beat the device bound; the bit-exact host rescore would fail
      identically, so the caller skips it and goes straight to the scan
      escalation.
    - ``resolved`` — every certificate holds: kth-above-bound with margin,
      adjacent ranking non-overlap among the top k (or exact zero-margin
      ties — both paths tie-break alike), tail domination of every dropped
      candidate, and 4-decimal DTO-rounding invariance.
    - queries in neither mask escalate to the bit-exact host rescore
      (margin failures: only exact scores can decide).

    Every comparison is the same f64 arithmetic as the scalar loop it
    replaced (tests/test_device_exact_cos.py pins equivalence against a
    scalar reference)."""
    from omni_recall_tpu.ops.exact_cos import round4_certified

    p = len(lens)
    total = int(seg[-1])
    lmax = max(int(lens.max()), 1)
    rowix = np.arange(p)
    col = np.arange(lmax)[None, :]
    owner_flat = np.repeat(rowix, lens)
    pos_flat = np.arange(total) - np.repeat(seg[:-1], lens)
    s = np.full((p, lmax), -np.inf)
    m = np.zeros((p, lmax))
    s[owner_flat, pos_flat] = scores_s
    m[owner_flat, pos_flat] = margins_s
    kk_arr = np.minimum(k_arr, lens)

    has_b = bnd != -np.inf
    idxk = np.clip(k_arr - 1, 0, lmax - 1)
    sk, mk = s[rowix, idxk], m[rowix, idxk]
    # provable fail: a sound UPPER bound on the exact kth score is the kth
    # LARGEST of the per-candidate upper bounds s+m (order statistics are
    # monotone under elementwise domination) — NOT s_k + m_k, which can
    # undershoot it when a lower-DD-ranked candidate carries a larger
    # margin. If even that bound cannot beat the device boundary, the
    # bit-exact host rescore provably fails too and the caller skips it.
    # (padded cells are -inf + 0 = -inf and sort last)
    uk = (-np.sort(-(s + m), axis=1))[rowix, idxk]
    provable = has_b & ((lens < k_arr) | (uk <= bnd))
    # kth-above-bound: sound because `resolved` ALSO requires the ranking
    # certificates below — they pin the DD kth as the exact kth candidate,
    # whose exact score is >= s_k - m_k
    margin_fail = has_b & ~provable & ~(sk - mk > bnd)

    # ranking: adjacent non-overlap among the top k (+1) entries
    # (pairs j, j+1 for j < min(kk, len-1))
    n_pairs = np.minimum(kk_arr, np.maximum(lens - 1, 0))
    if lmax > 1:
        # errstate: padded cells are -inf, so (-inf) - (-inf) = nan in
        # lanes the pair mask drops anyway (nan > x is False either way)
        with np.errstate(invalid="ignore"):
            gap_ok = s[:, :-1] - s[:, 1:] > m[:, :-1] + m[:, 1:]
        tie_ok = (
            (s[:, :-1] == s[:, 1:]) & (m[:, :-1] == 0.0) & (m[:, 1:] == 0.0)
        )
        pair_m = col[:, : lmax - 1] < n_pairs[:, None]
        rank_fail = (~(gap_ok | tie_ok) & pair_m).any(axis=1)
    else:
        rank_fail = np.zeros(p, dtype=bool)
    # tail domination: the kth strictly above every dropped row (or
    # exact-tied with margin 0 — both paths tie-break alike)
    idxkk = np.clip(kk_arr - 1, 0, lmax - 1)
    top_s, top_m = s[rowix, idxkk][:, None], m[rowix, idxkk][:, None]
    tail_mask = (col >= kk_arr[:, None]) & (col < lens[:, None])
    tail_bad = ~(
        ((top_s - top_m) > s + m)
        | ((s == top_s) & (m == 0.0) & (top_m == 0.0))
    )
    tail_fail = (tail_bad & tail_mask).any(axis=1) & (kk_arr >= 1)
    # DTO rounding: the 4-decimal edge must be margin-invariant (padded
    # cells are -inf/0: round4 certifies them trivially)
    r4_fail = (
        ~round4_certified(s, m) & (col < kk_arr[:, None])
    ).any(axis=1)

    resolved = ~provable & ~margin_fail & ~(rank_fail | tail_fail | r4_fail)
    return resolved, provable, kk_arr


def _scan_layout(n_rows: int, m: int, shallow: bool = False,
                 t_override: int = 0) -> tuple[int, int] | None:
    """(sub, t) for a slice scan of ``n_rows`` rows emitting ``m``
    candidates: the slice is the kernel's row tile (ops/scan.py
    scan_slice) and t the per-slice extraction depth, or None when the
    rows cannot be sliced or slices*t cannot cover m.

    t covers ~4m candidates for certificate headroom, floored at 4: on
    clustered corpora a query's top rows can share a slice, and a slice
    that holds more than t of them loses one, whose slice bound then
    exceeds the exact kth (the certificate fails and the query escalates).
    ``shallow`` (the coarse prepass) takes depth 2 once there are >= 2048
    slices: the per-slice collision mass is then low enough, and each
    extraction round is a full pass over the score tile.
    ``t_override`` (EngineOptions.coarse_t) forces the depth; a forced
    layout can only cost throughput (escalations), never exactness."""
    from omni_recall_tpu.ops.scan import scan_slice

    sub = scan_slice(n_rows)
    if not sub:
        return None
    slices = n_rows // sub
    if t_override:
        t = min(t_override, SCAN_MAX_T, sub - 1)
    elif shallow and slices >= 2048:
        t = 2
    else:
        t = min(SCAN_MAX_T, sub - 1, max(4, math.ceil(4 * m / slices)))
    if m > slices * t:
        return None
    return sub, t


@dataclass(frozen=True)
class SearchHit:
    chunk: ChunkRecord
    score: float  # exact, unrounded


def _sort_key(hit: SearchHit):
    ts = hit.chunk.created_at_utc or datetime.min.replace(tzinfo=timezone.utc)
    return (-hit.score, -ts.timestamp(), -hit.chunk.seq)


class RecallEngine:
    def __init__(
        self,
        store: InMemoryIngestionStore,
        device_index: DeviceIndex | None = None,
        options: EngineOptions | None = None,
        mesh=None,
    ) -> None:
        self.store = store
        self.options = options or EngineOptions()
        if device_index is None and self.options.backend != "oracle":
            device_index = DeviceIndex(
                self.options.embedding_dim,
                capacity_block=self.options.capacity_block,
                bloom_bits=self.options.bloom_bits,
                ngram=self.options.ngram,
                bloom_hashes=self.options.bloom_hashes,
                mesh=mesh,
                scan_dtype=self.options.scan_dtype if self.options.backend == "pallas" else "f32",
                refine=getattr(self.options, "refine", False),
                exact_cos=(
                    getattr(self.options, "device_exact_cos", False)
                    and getattr(self.options, "refine", False)
                    and self.options.backend == "pallas"
                    and self.options.scan_dtype == "int8"
                ),
            )
        self.device_index = device_index
        self.mesh = mesh if mesh is not None else (
            device_index.mesh if device_index is not None else None
        )
        # device stage implementations for this platform (ops/routes.py)
        from omni_recall_tpu.ops import routes

        self.route = routes.current()
        self._sharded_scorer = None
        if self.mesh is not None:
            from omni_recall_tpu.parallel.sharded import ShardedScorer

            self._sharded_scorer = ShardedScorer(self.mesh, self.route)
        if self.device_index is not None:
            # warm the native library (compile + bit-identity self-check)
            # OUTSIDE any index lock: a cold cc compile takes seconds and
            # must not stall the first ingest/search holding DeviceIndex._lock
            from omni_recall_tpu.ops import native as _native

            _native.rescore_available()
        # device-resident query pipeline (attach_device_embedder): when set,
        # requests arriving WITHOUT an embedding are embedded on device and
        # the raw query matrix never crosses the host boundary on certified
        # queries (escalations materialize rows lazily)
        self._device_embedder = None
        self.last_escalations = 0  # observability: cert escalations on the last search
        self.last_coarse_resolved = 0  # queries resolved by the coarse prepass
        # cumulative counters for /metrics (single-writer-ish; GIL-atomic
        # increments are sufficient for monitoring fidelity)
        self.stats = {
            "searches_total": 0,          # queries served
            "coarse_resolved_total": 0,   # resolved by the coarse prepass
            "escalation_rounds_total": 0, # certificate escalation rounds
            "host_fallbacks_total": 0,    # queries finished by the host scan
            "rescore_pairs_total": 0,       # (query,row) pairs exact-rescored
            "rescore_pairs_saved_total": 0, # pairs skipped by the 2-phase prune
            "kw_only_resolved_total": 0,    # resolved by the keyword-only scan
            "dd_resolved_total": 0,         # certified via device-exact cosine
            "dd_escalations_total": 0,      # DD margin failures -> host rescore
            "rescue_sliced_total": 0,       # rescue scans run at sliced width
            "rescue_wide_total": 0,         # wide re-reads of dispatch scans
        }
        # Adaptive prepass gate: on corpora with near-tie score distributions
        # the coarse certificate keeps failing and the prepass only adds
        # d/(d+bits) of wasted scan. Track a rolling success rate; disable
        # the prepass when it underperforms and re-probe periodically.
        self._coarse_outcomes: list[int] = []
        self._coarse_skip_until = 0
        self._coarse_query_count = 0
        # gate state is a cross-thread read-modify-write under the pipelined
        # executor (dispatcher thread advances the clock in
        # _dispatch_device_batch while the finalize worker records outcomes)
        self._coarse_gate_lock = threading.Lock()
        # Adaptive DIRECT-SELECT gate (same shape as the coarse gate): the
        # direct compact selection's certificate bound is the (t_out+1)-th
        # SCAN bound — on corpora with fat cross-cluster similarity tails
        # (measured: the localq trained-encoder corpus, resolution 0.47)
        # it keeps failing and every batch pays the rescue; the refine
        # path's tightened bounds resolve there. Track the rolling compact
        # resolution under direct mode; fall back to the refine selection
        # when it underperforms and re-probe periodically. Exactness is
        # identical either way — this gates THROUGHPUT only.
        self._direct_outcomes: list[int] = []
        self._direct_skip_until = 0
        self._direct_query_count = 0
        # exponential re-probe backoff: a failed re-probe costs a
        # rescue-heavy batch, so consecutive failures double the skip
        # horizon (measured: a 2048-query horizon oscillated — one bad
        # batch per ~1.3 good ones on the localq corpus); a healthy
        # window resets it
        self._direct_skip_h = 2048
        self._last_select_direct: bool | None = None
        # Serializes index mutation (append/update/delete) against shadow
        # rebuild: the ingestion service shares this lock so a chunk upserted
        # to the store can never be appended to the OLD index after the
        # rebuild snapshotted the store but before the atomic swap (which
        # would silently drop it from the new index). Searches never take it.
        self.mutation_lock = threading.RLock()

    def attach_device_embedder(self, embedder) -> None:
        """Enable the device-resident query pipeline: requests whose
        query_embedding is None (and whose text is non-blank) are embedded
        ON DEVICE by ``embedder.embed_device(texts) -> f32[B, dim]`` and
        chained straight into the scan dispatch — no per-query vector
        upload, no embedding readback on certified queries. The exactness
        contract is unchanged: every certificate is evaluated against the
        materialized bits of the device forward (the canonical query
        embedding), and escalations read those bits back losslessly.

        Requires a single-device engine (the sharded path replicates
        host-built operands) and a non-oracle backend. NEW vs the
        reference, whose query embeddings are remote HTTPS round trips
        (GeminiEmbeddingClient.cs → RecallSearchService.cs:25)."""
        if embedder is None:
            self._device_embedder = None
            return
        if self.options.backend == "oracle" or self.device_index is None:
            raise ValueError("device embedder requires a device backend")
        if self._sharded_scorer is not None:
            raise ValueError("device embedder is single-device only")
        dim = getattr(embedder, "dim", None)
        if dim != self.device_index.dim:
            raise ValueError(
                f"embedder dim {dim} != index dim {self.device_index.dim}"
            )
        self._device_embedder = embedder

    # -- index lifecycle hooks (called by the ingestion service) --

    def on_chunks_upserted(self, chunks: list[ChunkRecord], *, new: bool) -> None:
        with self.mutation_lock:
            # device_index is re-read under the lock so a concurrent rebuild's
            # swap is either fully before (we append to the new index) or
            # fully after (the rebuild's store snapshot already has us)
            if self.device_index is None:
                return
            if new:
                self.device_index.append(chunks)
            else:
                for chunk in chunks:
                    self.device_index.update_embedding(chunk.id, chunk.embedding)

    def on_document_deleted(self, document_id: str) -> None:
        with self.mutation_lock:
            if self.device_index is not None:
                self.device_index.delete_document(document_id)

    # refine gathers [B, m, d] int8 rows x2; beyond this m the gather
    # bytes rival the scan itself and the escalation path is rare anyway
    _REFINE_MAX_M = 2048
    # certificate-escalation ceiling for the DEVICE loop: queries still
    # unresolved at this candidate width are near-tie pathologies — another
    # x4 scan + a [B, m]-wide readback costs more than exact host scans for
    # the (few) stragglers, and extraction depth t grows with m
    _ESCALATION_MAX_M = 2048

    @staticmethod
    def _sparse_w_dev(weights: np.ndarray, b: int, bits: int):
        """SPARSE keyword-weight upload: most of the [B, bits] f32 matrix is
        zeros (a query probes a few dozen bloom bits), so upload (index,
        value) pairs and densify on device bit-for-bit (_densify_kw).
        Pathologically dense queries fall back to the dense upload."""
        nzq, nzb = np.nonzero(weights)
        counts = np.bincount(nzq, minlength=b) if len(nzq) else np.zeros(b, np.int64)
        t_max = int(counts.max()) if len(nzq) else 0
        t_pad = max(16, 1 << (t_max - 1).bit_length()) if t_max else 16
        if t_pad > bits // 4:
            return jnp.asarray(weights)
        off = np.zeros(b + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        pos = np.arange(len(nzq), dtype=np.int64) - off[nzq]
        idx = np.full((b, t_pad), -1, dtype=np.int32)
        val = np.zeros((b, t_pad), dtype=np.float32)
        idx[nzq, pos] = nzb
        val[nzq, pos] = weights[nzq, nzb]
        return _densify_kw(jnp.asarray(idx), jnp.asarray(val), bits)

    def _refine_call(self, dev, q_dev, w_dev, bias_dev, now_dev, vals_d, idxs_d, m):
        """Dispatch the device-assisted rescore over the scan's candidate
        rows (ops/refine.py) and return the [B, m] refined-bound device
        array, or None when unavailable (no residual plane / sharded index /
        oversized m). Chained onto the scan dispatch — no host sync."""
        if (
            dev.emb2 is None
            or self._sharded_scorer is not None
            or m > self._REFINE_MAX_M
        ):
            return None
        from omni_recall_tpu.ops import refine as _refine

        return _refine.refine_ub_from_scan(
            dev.emb, dev.scale, dev.emb2, dev.scale2, dev.err2,
            dev.bloom, dev.created, dev.valid,
            q_dev, w_dev, bias_dev, now_dev, vals_d, idxs_d,
        )

    def _refine_select_call(self, dev, q_dev, w_dev, bias_dev, now_dev,
                            vals_d, idxs_d, m, max_k, q_raw_dev=None):
        """Compact refine + device-side selection (ops/refine.py
        refine_select_from_scan, or the sharded shard_map equivalent
        parallel/sharded.py refine_select_dd): returns ``(sel, dd)`` where
        ``sel`` is the (rows, ubs, bound) device triple — or None when
        refine is unavailable — and ``dd`` is the device-exact cosine
        triple when it was computed INSIDE the sharded dispatch
        (``q_raw_dev`` given, raw plane sharded); single-device callers
        chain DD separately (chain_dd). Shrinks the per-batch readback
        from 3x[B, m+1] to ~3x[B, 32] — the dominant transport cost."""
        from omni_recall_tpu.ops import refine as _refine

        # t_out must cover the largest requested k with phase-2 headroom;
        # round up to a power of two to bound the jit-shape variety
        t_base = getattr(self.options, "select_t_out", 0)
        if t_base:
            t_out = max(t_base, max_k + 4)
        else:
            t_out = max(
                32, getattr(self.options, "rescore_phase1_refined", 12) + 4,
                max_k + 8,
            )
        t_out = 1 << (t_out - 1).bit_length()
        direct_opt = (
            getattr(self.options, "direct_select", False)
            and self._sharded_scorer is None
        )
        # the adaptive gate falls back to the refine selection when the
        # direct bounds keep missing — unless refine is impossible (no
        # residual planes), where direct is the only compact path
        use_direct = direct_opt and (
            dev.emb2 is None or m > self._REFINE_MAX_M
            or self._direct_gate_open()
        )
        self._last_select_direct = use_direct if direct_opt else None
        if use_direct:
            # Engine:DirectSelect — compact slice straight from the scan
            # bounds, refine skipped (ops/refine.py direct_select_from_scan
            # docstring: same coverage contract, bound ~4e-3 looser; misses
            # rescue through the refine path). Also serves indexes without
            # residual planes (DeviceIndex(refine=False), 10M capacity).
            return _refine.direct_select_from_scan(
                vals_d, idxs_d, min(t_out, max(1, m - 1))
            ), None
        if dev.emb2 is None or m > self._REFINE_MAX_M:
            return None, None
        # refine width: re-scoring only the top-r scan candidates halves the
        # stage's gather+kernel cost at r = m/2 (ops/refine.py docstring);
        # the (r+1)-th scan bound folds into the certificate bound
        r = getattr(self.options, "refine_width", 0) or m
        r = max(t_out, min(r, m))
        if self._sharded_scorer is not None:
            want_dd = (
                q_raw_dev is not None
                and dev.raw is not None
                and getattr(self.options, "device_exact_cos", False)
            )
            out = self._sharded_scorer.refine_select_dd(
                dev, q_dev, w_dev, bias_dev, now_dev, vals_d, idxs_d,
                t_out=t_out, r=min(r, m),
                q_raw=q_raw_dev if want_dd else None,
            )
            if want_dd:
                return tuple(out[:3]), tuple(out[3:])
            return tuple(out), None
        return _refine.refine_select_from_scan(
            dev.emb, dev.scale, dev.emb2, dev.scale2, dev.err2,
            dev.bloom, dev.created, dev.valid,
            q_dev, w_dev, bias_dev, now_dev, vals_d, idxs_d,
            t_out=t_out, r=min(r, m),
        ), None

    def rebuild_index(self) -> None:
        """Shadow rebuild + atomic swap (BASELINE.json config 3): construct a
        fresh device index from the store's current chunks (compacting
        tombstones; unchanged records reuse the old index's derived columns
        and device planes, records the store replaced re-derive — see
        DeviceIndex.append_from_index), then swap it in atomically. Searches
        in flight keep using the old index's arrays — device buffers are
        immutable — so there is no torn state.

        Holds ``mutation_lock`` for the whole snapshot→build→swap so a
        concurrent ingest cannot append to the old index between the store
        read and the swap (its append either lands in the store before our
        snapshot, or blocks and lands in the new index after the swap)."""
        with self.mutation_lock:
            if self.device_index is None:
                return
            old = self.device_index
            shadow = DeviceIndex(
                old.dim,
                capacity_block=self.options.capacity_block,
                bloom_bits=old.bloom_bits,
                ngram=old.ngram,
                bloom_hashes=old.bloom_hashes,
                mesh=old.mesh,
                scan_dtype=old.scan_dtype,
                refine=old.refine,
                exact_cos=old.exact_cos,
            )
            chunks: list[ChunkRecord] = []
            for doc in self.store.list_documents(2**31 - 1):
                chunks.extend(self.store.get_chunks_by_document_id(doc.id))
            chunks.sort(key=lambda c: c.seq)
            # compaction fast path: reuse the old index's derived columns
            # (and, single-device, its quantized planes via one on-device
            # gather) for unchanged records; replaced records re-derive
            shadow.append_from_index(old, chunks)
            shadow.device_arrays()  # upload before the swap so search never waits
            self.device_index = shadow

    # -- search --

    def search(
        self,
        query: str,
        query_embedding: list[float] | None,
        top_k: int,
        now: datetime | None = None,
    ) -> list[SearchHit]:
        return self.search_batch([(query, query_embedding, top_k)], now=now)[0]

    def search_batch(
        self,
        requests: list[tuple[str, list[float] | None, int]],
        now: datetime | None = None,
    ) -> list[list[SearchHit]]:
        """Score a batch of queries in one device pass (the QPS path: the
        scan cost is shared across the batch; certificates and rescores stay
        per-query). Each request is (query, query_embedding, top_k)."""
        now = now or datetime.now(timezone.utc)
        window = self.options.recent_window
        if not requests:
            return []
        self.stats["searches_total"] += len(requests)
        if self.options.backend == "oracle" or self.device_index is None:
            return [
                self._search_oracle(q, emb, max(1, k), window, now)
                for q, emb, k in requests
            ]
        return self._search_device_batch(requests, window, now)

    def _select_scorer(self, m: int, n_rows_padded: int):
        """Pick the scoring pass for this escalation round.

        Returns (call(dev, q, w, bias, now, r0, m) -> (vals, idxs),
        full_coverage) where full_coverage=True means that once
        m >= window rows, EVERY live window row is among the candidates
        (the certificate then passes trivially). The int8 slice scan only
        emits per-slice top-t, so it never guarantees full coverage; when
        it runs out of budget the engine falls back to the exact XLA
        scorer (f32 storage) or the host oracle (quantized storage)."""
        scan_dtype = self.device_index.scan_dtype if self.device_index else "f32"
        if self.options.backend == "pallas" and scan_dtype == "int8":
            layout = _scan_layout(self._scan_rows(n_rows_padded), m)
            if layout is not None:
                sub, t = layout
                return self._scan_call("cos_kw", m, sub, t), False
        if scan_dtype != "f32":
            # quantized device storage cannot feed the exact XLA pass
            return None, True

        if self._sharded_scorer is not None:
            ss = self._sharded_scorer

            def sharded_xla(dev, q, w, bias, now_days, r0, m):
                return ss.score_topm(
                    dev.emb, dev.bloom, dev.created, dev.valid, q, w, bias,
                    now_days, r0, m=m, mode="xla",
                )
            return sharded_xla, True

        def xla(dev, q, w, bias, now_days, r0, m):
            return xla_scorer.score_topm(
                dev.emb, dev.bloom, dev.created, dev.valid,
                q, w, bias, now_days, r0, m=m,
            )
        return xla, True

    def _scan_rows(self, n_rows_padded: int) -> int:
        """Rows one scan call walks: the whole index, or one shard's."""
        if self._sharded_scorer is not None:
            return self._sharded_scorer.local_rows(n_rows_padded)
        return n_rows_padded

    def _scan_call(self, terms: str, m: int, sub: int, t: int):
        """Scan pass of one term set (ops/scan.py) through this platform's
        route, single-device or sharded."""
        if self._sharded_scorer is not None:
            ss = self._sharded_scorer

            def sharded(dev, q, w, bias, now_days, r0, m):
                return ss.score_topm(
                    dev.emb, dev.bloom, dev.created, dev.valid, q, w, bias,
                    now_days, r0, m=m, mode=terms, t=t, sub=sub,
                    scale=dev.scale, err=dev.err,
                )
            return sharded
        from omni_recall_tpu.ops import scan

        impl = self.route.scan

        def single(dev, q, w, bias, now_days, r0, m):
            return scan.score_topm(
                dev.emb, dev.scale, dev.err, dev.bloom, dev.created,
                dev.valid, q, w, bias, now_days, r0,
                terms=terms, m=m, t=t, sub=sub, scan=impl,
            )
        return single

    def _coarse_gate_open(self) -> bool:
        with self._coarse_gate_lock:
            return self._coarse_query_count >= self._coarse_skip_until

    def _coarse_gate_advance(self, attempted: int) -> None:
        """Advance the gate clock for skipped prepasses (closed gate) so the
        re-probe horizon is reached; called from the dispatcher thread."""
        with self._coarse_gate_lock:
            self._coarse_query_count += attempted

    def _coarse_gate_record(self, resolved: int, attempted: int) -> None:
        with self._coarse_gate_lock:
            self._coarse_query_count += attempted
            self._coarse_outcomes.extend(
                [1] * resolved + [0] * (attempted - resolved)
            )
            if len(self._coarse_outcomes) > 128:
                self._coarse_outcomes = self._coarse_outcomes[-128:]
            if (
                len(self._coarse_outcomes) >= 32
                and sum(self._coarse_outcomes) / len(self._coarse_outcomes) < 0.5
            ):
                # underperforming: skip the prepass for a while, then
                # re-probe with a fresh window (the corpus/score
                # distribution may change)
                self._coarse_skip_until = self._coarse_query_count + 2048
                self._coarse_outcomes = []

    def _direct_gate_open(self) -> bool:
        with self._coarse_gate_lock:
            return self._direct_query_count >= self._direct_skip_until

    def _direct_gate_advance(self, attempted: int) -> None:
        with self._coarse_gate_lock:
            self._direct_query_count += attempted

    def _direct_gate_record(self, resolved: int, attempted: int) -> None:
        """Compact-certificate outcomes under DIRECT selection: close the
        gate (fall back to the refine selection) when the rolling
        resolution drops below 0.9 — at that point >=10% of queries pay a
        rescue round-trip, which costs more than refining every query."""
        with self._coarse_gate_lock:
            self._direct_query_count += attempted
            self._direct_outcomes.extend(
                [1] * resolved + [0] * (attempted - resolved)
            )
            if len(self._direct_outcomes) > 128:
                self._direct_outcomes = self._direct_outcomes[-128:]
            if (
                len(self._direct_outcomes) >= 32
                and sum(self._direct_outcomes)
                / len(self._direct_outcomes) < 0.9
            ):
                self._direct_skip_until = (
                    self._direct_query_count + self._direct_skip_h
                )
                self._direct_skip_h = min(self._direct_skip_h * 2, 1 << 18)
                self._direct_outcomes = []
            elif len(self._direct_outcomes) >= 32:
                self._direct_skip_h = 2048  # healthy window: reset backoff

    def _select_coarse_scorer(self, m: int, n_rows_padded: int):
        """Cosine-only int8 prepass scorer (keyword capped per query), or
        None when unavailable. Only meaningful on the exact profile — the
        approximate profile ranks by the device bound directly, and the
        coarse bound's flat keyword cap would distort that ranking."""
        if not (
            self.options.exact
            and self.options.coarse_prepass
            and self.options.backend == "pallas"
            and self.device_index is not None
            and self.device_index.scan_dtype == "int8"
        ):
            return None
        layout = _scan_layout(self._scan_rows(n_rows_padded), m, shallow=True,
                              t_override=self.options.coarse_t)
        if layout is None:
            return None
        return self._scan_call("cos", m, *layout)

    def _select_kw_scorer(self, m: int, n_rows_padded: int):
        """Keyword-only scan (bloom + recency, no emb read) for queries
        with no embedding. Works for every scan_dtype (the bloom planes are
        always u8), single-device and sharded."""
        if not (
            self.options.exact
            and self.options.backend == "pallas"
            and self.device_index is not None
        ):
            return None
        layout = _scan_layout(self._scan_rows(n_rows_padded), m)
        if layout is None:
            return None
        call = self._scan_call("kw", m, *layout)

        def kw_only(dev, w, bias, now_days, r0, m):
            return call(dev, None, w, bias, now_days, r0, m)
        return kw_only

    def _exact_hits(
        self,
        chunks: list[ChunkRecord],
        query: str,
        query_embedding: list[float] | None,
        now: datetime,
    ) -> list[SearchHit]:
        return self._exact_hits_multi([(query, query_embedding)], [chunks], now)[0]

    def _exact_hits_multi(
        self,
        queries: list[tuple[str, list[float] | None]],
        chunk_lists: list[list[ChunkRecord]],
        now: datetime,
    ) -> list[list[SearchHit]]:
        """Exact hybrid scores for all queries' candidate sets in one pass —
        float64 math identical to ops/oracle.py, with ONE multi-query native
        keyword call and one flattened numpy block for cosine/recency, so the
        rescore amortizes python overhead across the whole batch."""
        nq = len(queries)
        flat_chunks: list[ChunkRecord] = []
        owner: list[int] = []
        for qi, chunks in enumerate(chunk_lists):
            flat_chunks.extend(chunks)
            owner.extend([qi] * len(chunks))
        total = len(flat_chunks)
        if total == 0:
            return [[] for _ in range(nq)]

        # keyword: one native multi-query call, Python fallback
        term_lists = [
            oracle.query_terms(q) if q.strip() else [] for q, _ in queries
        ]
        kw = np.zeros(total, dtype=np.float64)
        if any(term_lists):
            from omni_recall_tpu.ops import native

            flat_terms: list[bytes] = []
            offsets = [0]
            for terms in term_lists:
                flat_terms.extend(t.encode("utf-8") for t in terms)
                offsets.append(len(flat_terms))
            scores = native.keyword_scores_multi(
                [c.content_lower_utf8() for c in flat_chunks],
                owner, flat_terms, offsets,
            )
            if scores is not None:
                kw = np.asarray(scores, dtype=np.float64)
            else:
                for i, c in enumerate(flat_chunks):
                    terms = term_lists[owner[i]]
                    if terms and c.content.strip():
                        kw[i] = oracle.keyword_score_terms(terms, oracle.lower_invariant(c.content))

        # cosine: one flattened block for rows whose embedding matches their
        # query's dimension; everything else is 0 by reference semantics
        # (mismatch/missing/zero norms). Row-wise float64 sums are identical
        # to the per-pair oracle math regardless of batching.
        cos = np.zeros(total, dtype=np.float64)
        qvs: list[np.ndarray | None] = []
        q_norms = np.zeros(nq, dtype=np.float64)
        for q, emb in queries:
            if emb is not None and len(emb) > 0:
                qv = np.asarray(emb, dtype=np.float32)
                qvs.append(qv)
                q_norms[len(qvs) - 1] = float(np.sum((qv * qv).astype(np.float64)))
            else:
                qvs.append(None)
        dims = [qv.size if qv is not None else -1 for qv in qvs]
        rows = [
            i for i, c in enumerate(flat_chunks)
            if dims[owner[i]] > 0
            and c.embedding is not None and len(c.embedding) == dims[owner[i]]
            and q_norms[owner[i]] > 0.0
        ]
        if rows:
            same_dim = len({dims[owner[i]] for i in rows}) == 1
            if same_dim:
                a = np.asarray([flat_chunks[i].embedding for i in rows], dtype=np.float32)
                dq = a.shape[1]
                q_matrix = np.zeros((nq, dq), dtype=np.float32)
                for qi, qv in enumerate(qvs):
                    if qv is not None and qv.size == dq:
                        q_matrix[qi] = qv
                owner_rows = np.asarray(owner, dtype=np.int64)[rows]
                qm = q_matrix[owner_rows]
                # f64-accumulated sums over f32 products: identical pairwise
                # summation to .astype(f64).sum() without the f64 copies
                dot = np.sum(a * qm, axis=1, dtype=np.float64)
                norm_a = np.sum(a * a, axis=1, dtype=np.float64)
                ok = norm_a > 0.0
                vals = np.zeros(len(rows), dtype=np.float64)
                nq_rows = q_norms[owner_rows]
                denom = np.sqrt(nq_rows[ok]) * np.sqrt(norm_a[ok])
                vals[ok] = dot[ok] / denom
                cos[rows] = vals
            else:  # mixed dimensions: per-row (rare)
                for i in rows:
                    cos[i] = oracle.cosine_similarity(
                        qvs[owner[i]], flat_chunks[i].embedding
                    )

        # recency: exact per-chunk age (timedelta arithmetic), batched exp
        min_dt = datetime.min.replace(tzinfo=timezone.utc)

        def _aware(dt):
            if dt is None:
                return min_dt
            return dt if dt.tzinfo is not None else dt.replace(tzinfo=timezone.utc)

        ages = np.asarray(
            [
                max(0.0, (now - _aware(c.created_at_utc)).total_seconds() / 86400.0)
                for c in flat_chunks
            ],
            dtype=np.float64,
        )
        rec = np.exp(-ages / oracle.RECENCY_HALF_LIFE_DAYS)

        scores = (
            oracle.COSINE_WEIGHT * cos
            + oracle.KEYWORD_WEIGHT * kw
            + oracle.RECENCY_WEIGHT * rec
        )
        out: list[list[SearchHit]] = [[] for _ in range(nq)]
        for i, (chunk, s) in enumerate(zip(flat_chunks, scores)):
            out[owner[i]].append(SearchHit(chunk, float(s)))
        return out

    _RESCORE_PHASE1 = 32  # candidates exact-rescored before the ub prune

    def _exact_rescore_rows(
        self,
        queries: list[tuple[str, list[float] | None]],
        row_lists: list[np.ndarray],
        now: datetime,
        dix=None,
        ub_lists: list[np.ndarray] | None = None,
        ks: list[int] | None = None,
        phase1: int | None = None,
        q_matrix: np.ndarray | None = None,
        q_norms: np.ndarray | None = None,
        term_lists: list[list[str]] | None = None,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Vectorized exact rescore over device-index ROW indices: returns,
        per query, (rows_sorted, scores_sorted) ordered by the full ranking
        key (score desc, created desc, seq desc). Bit-identical to
        _exact_hits_multi / ops/oracle.py — cosine uses the raw f32 mirror
        with f64 accumulation, recency uses exact integer micros, keyword
        uses the native substring scorer — but with zero per-candidate python
        object work, which is what capped the certified path at ~700 QPS in
        round 1 (VERDICT weak #3).

        ``dix`` MUST be the caller's index snapshot when the row ids come
        from a device scan: a concurrent rebuild_index swap would otherwise
        make old-index row ids dereference the new (compacted) index.

        Two-phase prune: when ``ub_lists`` (sound per-row upper bounds,
        aligned with ``row_lists`` and sorted descending) and ``ks`` are
        given, only the top _RESCORE_PHASE1 candidates are rescored first;
        the tail is rescored only where ub >= the provisional kth exact
        score. The returned arrays then cover a SUBSET of the input rows
        that provably contains the true top-k in identical order AND whose
        kth score equals the full-set kth (a skipped row has
        true <= ub < kth_phase1 <= kth_full, strictly below the kth, so it
        can neither enter the top-k nor shift the kth; ties at the kth keep
        ub == kth rows in). Callers that consume more than the top-k plus
        the kth value must not pass ub_lists."""
        from omni_recall_tpu.index.device_index import to_micros

        if dix is None:
            dix = self.device_index
        assert dix is not None

        if ub_lists is not None and ks is not None:
            if phase1 is None:
                phase1 = getattr(self.options, "rescore_phase1", self._RESCORE_PHASE1)
            p1s = [
                min(len(rows), max(phase1, ks[qi]))
                for qi, rows in enumerate(row_lists)
            ]
            if any(len(rows) > p1 for rows, p1 in zip(row_lists, p1s)):
                return self._exact_rescore_rows_pruned(
                    queries, row_lists, now, dix, ub_lists, ks, p1s,
                    q_matrix=q_matrix, q_norms=q_norms,
                    term_lists=term_lists,
                )
        nq = len(queries)
        lens = [len(r) for r in row_lists]
        total = int(sum(lens))
        empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float64))
        self.stats["rescore_pairs_total"] += total
        if total == 0:
            return [empty] * nq
        rows = np.concatenate([np.asarray(r, dtype=np.int64) for r in row_lists])
        owner = np.repeat(np.arange(nq), lens)

        from omni_recall_tpu.ops import native

        if term_lists is None:
            term_lists = [
                oracle.query_terms(q) if q.strip() else [] for q, _ in queries
            ]
        if q_matrix is None or q_norms is None:
            # fallback: convert per query (serving paths pass the batch
            # matrices precomputed at dispatch — the list->array conversion
            # dominates this function at serving batch sizes otherwise)
            q_matrix = np.zeros((nq, dix.dim), dtype=np.float32)
            q_norms = np.zeros(nq, dtype=np.float64)
            for qi, (_, emb) in enumerate(queries):
                if emb is not None and len(emb) == dix.dim:
                    qv = np.asarray(emb, dtype=np.float32)
                    q_matrix[qi] = qv
                    q_norms[qi] = float(np.sum((qv * qv).astype(np.float64)))

        # recency: exact integer-micros age (bit-identical to timedelta math)
        now_us = to_micros(now)
        age = np.maximum(
            0.0, ((now_us - dix.created_us[rows]).astype(np.float64) / 1e6) / 86400.0
        )
        rec = np.exp(-age / oracle.RECENCY_HALF_LIFE_DAYS)

        partial = None
        compact = getattr(dix, "host_compact", False)
        if dix.dim <= 8192 and native.rescore_available():
            # one native call computes 0.7*cos + 0.2*kw for every pair,
            # threaded, reading the index arrays/arena in place. Holding the
            # index lock keeps the arena buffer stable (appends reallocate).
            # Compact indexes route to the int8 variant: workers dequantize
            # candidate rows from the int8+scale embedding column in native
            # scratch, bit-identical to the numpy materialized chain.
            flat_terms: list[bytes] = []
            q_term_off = [0]
            for terms in term_lists:
                flat_terms.extend(t.encode("utf-8") for t in terms)
                q_term_off.append(len(flat_terms))
            term_off = np.zeros(len(flat_terms) + 1, dtype=np.int64)
            np.cumsum([len(t) for t in flat_terms], out=term_off[1:])
            with dix._lock:
                if compact:
                    partial = native.hybrid_rescore_int8(
                        dix.emb8_host, dix.scale_host, dix.raw_norm_sq,
                        dix._arena, dix.content_off,
                        rows, owner, q_matrix, q_norms,
                        b"".join(flat_terms), term_off,
                        np.asarray(q_term_off, dtype=np.int64),
                    )
                else:
                    partial = native.hybrid_rescore(
                        dix.raw_emb, dix.raw_norm_sq, dix._arena, dix.content_off,
                        rows, owner, q_matrix, q_norms,
                        b"".join(flat_terms), term_off,
                        np.asarray(q_term_off, dtype=np.int64),
                    )
        if partial is not None:
            scores = partial + oracle.RECENCY_WEIGHT * rec
        else:
            # fallback when the fused native path is out (lib absent, dim
            # above the native cap, or a load/ABI failure): the keyword
            # term comes from the SHARED helper — _kw_scores_flat is also
            # the DD path's host half, so the two paths' keyword bits stay
            # identical by construction (it tries the native keyword-only
            # rescore first, then the same numpy/python fallbacks)
            kw_term = self._kw_scores_flat(rows, owner, term_lists, dix)

            # cosine: raw f32 products, f64 accumulation (== oracle.cosine).
            # Compact bulk indexes (index/compact.py) materialize the
            # selected rows from the int8+scale embedding columns — the
            # materialized bits ARE the store's embedding by definition
            raw = (
                dix.materialize_raw_rows(rows) if compact
                else dix.raw_emb[rows]
            )
            dot = np.sum(raw * q_matrix[owner], axis=1, dtype=np.float64)
            ns = dix.raw_norm_sq[rows]
            qn = q_norms[owner]
            ok = (ns > 0.0) & (qn > 0.0)
            cos = np.zeros(total, dtype=np.float64)
            cos[ok] = dot[ok] / (np.sqrt(qn[ok]) * np.sqrt(ns[ok]))
            # same f64 expression order as the oracle: fl(fl(0.7c)+fl(0.2kw))
            # + fl(0.1r) — kw_term already carries the KEYWORD_WEIGHT factor
            scores = (
                oracle.COSINE_WEIGHT * cos + kw_term
            ) + oracle.RECENCY_WEIGHT * rec
        # ONE global lexsort (owner-major, then the ranking key) instead of
        # a python loop of per-query lexsorts — the loop dominated the host
        # stage at serving batch sizes. Within each owner segment the order
        # is identical to the per-query sort (stable keys, same comparisons)
        order = np.lexsort((-dix.seqs[rows], -dix.created_ts[rows], -scores, owner))
        rows_s = rows[order]
        scores_s = scores[order]
        bounds = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(lens, out=bounds[1:])
        return [
            (rows_s[bounds[qi] : bounds[qi + 1]], scores_s[bounds[qi] : bounds[qi + 1]])
            if lens[qi] else empty
            for qi in range(nq)
        ]

    def _kw_scores_flat(
        self,
        rows: np.ndarray,
        owner: np.ndarray,
        term_lists: list[list[str]],
        dix,
    ) -> np.ndarray:
        """KEYWORD_WEIGHT * exact-substring keyword score per (query, row)
        pair — the host half of the device-exact-cosine path. Native
        keyword-only rescore (hybrid_rescore with a NULL embedding plane:
        zero embedding bytes streamed) with the same numpy/python fallbacks
        as _exact_rescore_rows; values are bit-identical to the full host
        path's keyword term either way."""
        from omni_recall_tpu.ops import native

        total = len(rows)
        nq = len(term_lists)
        if total == 0:
            return np.zeros(0, dtype=np.float64)
        if native.rescore_available():
            flat_terms: list[bytes] = []
            q_term_off = [0]
            for terms in term_lists:
                flat_terms.extend(t.encode("utf-8") for t in terms)
                q_term_off.append(len(flat_terms))
            term_off = np.zeros(len(flat_terms) + 1, dtype=np.int64)
            np.cumsum([len(t) for t in flat_terms], out=term_off[1:])
            dummy_q = np.zeros((nq, 1), dtype=np.float32)
            dummy_qn = np.zeros(nq, dtype=np.float64)
            with dix._lock:  # arena stability (bytearray growth reallocates)
                out = native.hybrid_rescore(
                    None, None, dix._arena, dix.content_off,
                    rows, owner, dummy_q, dummy_qn,
                    b"".join(flat_terms), term_off,
                    np.asarray(q_term_off, dtype=np.int64),
                )
            if out is not None:
                return out
        kw = np.zeros(total, dtype=np.float64)
        if any(term_lists):
            meta = dix.meta
            contents = [
                m.content_lower_utf8() if (m := meta[r]) is not None else b""
                for r in rows
            ]
            flat_terms = []
            offsets = [0]
            for terms in term_lists:
                flat_terms.extend(t.encode("utf-8") for t in terms)
                offsets.append(len(flat_terms))
            kws = native.keyword_scores_multi(
                contents, owner.tolist(), flat_terms, offsets
            )
            if kws is not None:
                kw = np.asarray(kws, dtype=np.float64)
            else:  # pure-python fallback (no native lib at all)
                for i, r in enumerate(rows):
                    terms = term_lists[owner[i]]
                    m = meta[r]
                    if m is not None and terms and m.content.strip():
                        kw[i] = oracle.keyword_score_terms(
                            terms, oracle.lower_invariant(m.content)
                        )
        return oracle.KEYWORD_WEIGHT * kw

    def _exact_rescore_rows_pruned(
        self,
        queries: list[tuple[str, list[float] | None]],
        row_lists: list[np.ndarray],
        now: datetime,
        dix,
        ub_lists: list[np.ndarray],
        ks: list[int],
        p1s: list[int],
        q_matrix: np.ndarray | None = None,
        q_norms: np.ndarray | None = None,
        term_lists: list[list[str]] | None = None,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Two-phase body of _exact_rescore_rows (see its docstring for the
        soundness argument). Phase 1 rescores the top-p1 candidates by device
        upper bound; phase 2 rescores only tail candidates whose ub reaches
        the provisional kth exact score."""
        phase1 = [rows[:p1] for rows, p1 in zip(row_lists, p1s)]
        ranked1 = self._exact_rescore_rows(
            queries, phase1, now, dix=dix, q_matrix=q_matrix, q_norms=q_norms,
            term_lists=term_lists,
        )

        phase2 = []
        for qi, rows in enumerate(row_lists):
            p1, k = p1s[qi], ks[qi]
            _, s1 = ranked1[qi]
            kth1 = float(s1[k - 1]) if len(s1) >= k else -np.inf
            tail_rows = np.asarray(rows[p1:], dtype=np.int64)
            tail_ubs = np.asarray(ub_lists[qi][p1:], dtype=np.float64)
            # keep ties: ub == kth1 may still win on the recency tie-break
            phase2.append(tail_rows[tail_ubs >= kth1])
        saved = sum(len(r) - p for r, p in zip(row_lists, p1s)) - sum(
            len(p) for p in phase2
        )
        self.stats["rescore_pairs_saved_total"] += int(saved)
        ranked2 = self._exact_rescore_rows(
            queries, phase2, now, dix=dix, q_matrix=q_matrix, q_norms=q_norms,
            term_lists=term_lists,
        )

        out: list[tuple[np.ndarray, np.ndarray]] = []
        for qi in range(len(queries)):
            r1, s1 = ranked1[qi]
            r2, s2 = ranked2[qi]
            if len(r2) == 0:
                out.append((r1, s1))
                continue
            r = np.concatenate([r1, r2])
            s = np.concatenate([s1, s2])
            order = np.lexsort((-dix.seqs[r], -dix.created_ts[r], -s))
            out.append((r[order], s[order]))
        return out

    def _search_oracle(
        self,
        query: str,
        query_embedding: list[float] | None,
        k: int,
        window: int,
        now: datetime,
    ) -> list[SearchHit]:
        max_count = window if window > 0 else 2**31 - 1
        candidates = self.store.get_recent_chunks(max_count)
        hits = self._exact_hits(candidates, query, query_embedding, now)
        hits.sort(key=_sort_key)
        return hits[:k]

    def _search_full_host(
        self,
        query: str,
        query_embedding: list[float] | None,
        k: int,
        window: int,
        now: datetime,
    ) -> list[SearchHit]:
        """Exact host scan over the device index's own row list (the
        certificate-exhausted fallback). Uses index metadata rather than the
        store so bulk-loaded indexes behave identically; rows are already in
        (created, seq) order, so the window is the row tail. Runs through
        the vectorized/native row rescorer, so even a full 1M-row exact scan
        is a single batched call rather than a python loop."""
        dix = self.device_index
        if dix is None:
            return self._search_oracle(query, query_embedding, k, window, now)
        r0 = dix.window_start_row(window)
        meta = dix.meta
        if query_embedding is not None and 0 < len(query_embedding) != dix.dim:
            # dim-mismatched query: true cosines against any same-dim chunk
            # embeddings live only in the chunk records, not the raw mirror
            chunks = [c for c in meta[r0:] if c is not None]
            hits = self._exact_hits(chunks, query, query_embedding, now)
            hits.sort(key=_sort_key)
            return hits[:k]
        # valid[r] is False exactly when meta[r] is None (delete clears both
        # under the index lock); vectorized selection instead of an O(n) loop
        rows = r0 + np.nonzero(dix.valid[r0 : dix.n_rows])[0].astype(np.int64)
        (rows_sorted, scores_sorted), = self._exact_rescore_rows(
            [(query, query_embedding)], [rows], now, dix=dix,
        )
        return [
            SearchHit(meta[int(r)], float(s))
            for r, s in zip(rows_sorted[:k], scores_sorted[:k])
            if meta[int(r)] is not None
        ]

    def _search_device_batch(
        self,
        requests: list[tuple[str, list[float] | None, int]],
        window: int,
        now: datetime,
    ) -> list[list[SearchHit]]:
        return self._finalize_device_batch(
            self._dispatch_device_batch(requests, window, now)
        )

    def search_batches_pipelined(
        self,
        batches: list[list[tuple[str, list[float] | None, int]]],
        now: datetime | None = None,
    ) -> list[list[list[SearchHit]]]:
        """Pipelined serving executor: dispatch EVERY batch's device scans
        before finalizing any batch, so the host-side exact rescore (and the
        candidate readback transport) of batch i overlaps the device scan of
        batches i+1... jax dispatch is asynchronous, so the scans queue on
        the device back-to-back; per-batch round-trip latency is pipelined
        instead of paid serially. Semantically identical to
        calling search_batch per batch: same certificates, same concurrent-
        mutation handling (each batch snapshots the index at ITS dispatch)."""
        now = now or datetime.now(timezone.utc)
        window = self.options.recent_window
        if self.options.backend == "oracle" or self.device_index is None:
            return [self.search_batch(reqs, now=now) for reqs in batches]
        # One finalize worker thread: batch i's host rescore (native C call
        # + device readback — both release the GIL) overlaps batch i+1's
        # host-side query prep AND its device dispatch. A single worker
        # keeps finalizes in order and bounds engine concurrency at two
        # threads — no more than two concurrent HTTP requests already
        # exercise (the server is thread-per-request). Serial fallback when
        # there is nothing to overlap.
        if len(batches) <= 1:
            ctxs = []
            for reqs in batches:
                self.stats["searches_total"] += len(reqs)
                ctxs.append(self._dispatch_device_batch(reqs, window, now))
            return [self._finalize_device_batch(ctx) for ctx in ctxs]
        from concurrent.futures import ThreadPoolExecutor

        futures = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            for reqs in batches:
                self.stats["searches_total"] += len(reqs)
                ctx = self._dispatch_device_batch(reqs, window, now)
                futures.append(pool.submit(self._finalize_device_batch, ctx))
            return [f.result() for f in futures]

    def _dispatch_device_batch(
        self,
        requests: list[tuple[str, list[float] | None, int]],
        window: int,
        now: datetime,
    ) -> dict:
        """Phase 1 of a device-batch search: snapshot the index, build the
        query operands, and dispatch the prepass scans (+ device refine)
        asynchronously. Returns a context consumed by
        _finalize_device_batch; no device readback happens here."""
        import jax.numpy as jnp

        dix = self.device_index
        assert dix is not None
        b = len(requests)
        ctx: dict = {"requests": requests, "window": window, "now": now, "dix": dix}
        if b == 0 or dix.n_rows == 0 or dix.n_valid == 0:
            ctx["empty"] = True
            return ctx
        ctx["empty"] = False

        ks = [max(1, k) for _, _, k in requests]
        q_raw = np.zeros((b, dix.dim), dtype=np.float32)
        host_only: list[int] = []
        has_vec = np.zeros(b, dtype=bool)
        dev_embed_idx: list[int] = []
        use_dev_embed = (
            self._device_embedder is not None and self._sharded_scorer is None
        )
        for i, (query, query_embedding, _) in enumerate(requests):
            if (
                query_embedding is not None
                and len(query_embedding) == dix.dim
            ):
                # one list->f32 conversion per request, reused by the device
                # operands AND the exact rescore (raw values + exact norm)
                q_raw[i] = query_embedding
                has_vec[i] = True
            elif query_embedding is not None and len(query_embedding) > 0:
                # The query has an embedding the index can't represent (dim
                # mismatch with the configured index dim). The device cosine
                # bound would be 0, but the host exact rescore computes real
                # cosines for any chunk whose stored embedding dim equals
                # the query dim — so the device bound is NOT a sound upper
                # bound and the certificate would be vacuous. Route this
                # query to the exact host scan instead.
                host_only.append(i)
            elif query_embedding is None and use_dev_embed and query.strip():
                # device-resident query pipeline: embed on device below.
                # ONLY for None (caller delegated embedding to the engine);
                # an explicit empty vector keeps the reference's
                # embed-failure semantics — keyword-only scoring
                # (RecallSearchService.cs:70-71)
                dev_embed_idx.append(i)
        # batch normalization, bit-identical to _normalize per row (f32
        # products f64-accumulated, f64 divide, f32 round). Host-side
        # normalized rows are ONLY needed by the sharded upload branch;
        # the single-device serving path normalizes on device
        # (_normalize_q / _normalize_q_dd), so skip the [B, d] f64 work.
        q_norms = np.sum(q_raw * q_raw, axis=1, dtype=np.float64)
        ok = has_vec & (q_norms > 0.0)
        q = None
        if self._sharded_scorer is not None:
            q = np.zeros((b, dix.dim), dtype=np.float32)
            if ok.any():
                q[ok] = (
                    q_raw[ok].astype(np.float64) / np.sqrt(q_norms[ok])[:, None]
                ).astype(np.float32)
        # zero-norm vectors of matching dim also go host-only (the device
        # bound would be vacuous, exactly as with a dim mismatch)
        host_only.extend(int(i) for i in np.nonzero(has_vec & ~ok)[0])

        # Device-resident query embeddings (attach_device_embedder): one
        # forward for the batch's embedding-less queries; the rows stay on
        # device. A forward failure degrades those queries to keyword-only
        # scoring — the reference's embed-failure semantics (empty vector →
        # cosine 0, RecallSearchService.cs:70-71 / IEmbeddingClient.cs).
        dev_embedded = np.zeros(b, dtype=bool)
        q_enc = None
        n_dev = len(dev_embed_idx)
        if dev_embed_idx:
            # mixed batches pad the embed list to a power-of-two bucket:
            # every distinct row count otherwise compiles a fresh
            # slice/assemble executable (once per batch, since the
            # explicit-vector minority varies). Padded rows embed "" —
            # finite by construction (masked pool, norm floor) — and their
            # scatter indices are out of bounds below, so XLA drops them.
            dev_bucket = b if n_dev == b else 1 << (n_dev - 1).bit_length()
            texts_dev = [requests[i][0] for i in dev_embed_idx]
            texts_dev += [""] * (dev_bucket - n_dev)
            try:
                q_enc = self._device_embedder.embed_device(texts_dev)
            except Exception:
                q_enc = None
            if q_enc is not None:
                dev_embedded[np.asarray(dev_embed_idx)] = True
        terms_all = [oracle.query_terms(query) for query, _, _ in requests]
        # SPARSE keyword weights end-to-end (single-device): the native
        # builder emits (bit index, value) pairs directly and the device
        # scatters them dense (_densify_kw) — the [B, bits] f32 matrix
        # (6.3 MB/batch at 1536x1024, fresh pages + a full nonzero scan)
        # never exists on the host. Values are bit-identical to the dense
        # builder (tests/test_native.py). The sharded path (replicated
        # mesh uploads) and pathologically dense queries keep the dense
        # builder.
        weights = kw_idx = kw_val = None
        if self._sharded_scorer is None:
            sparse_kw = hashing.query_bit_weights_sparse_batch(
                terms_all, dix.bloom_bits, dix.ngram, dix.bloom_hashes,
            )
            if sparse_kw is not None:
                kw_idx, kw_val, bias64 = sparse_kw
                biases = bias64.astype(np.float32)
        if kw_idx is None:
            weights, bias64 = hashing.query_bit_weights_batch(
                terms_all, dix.bloom_bits, dix.ngram, dix.bloom_hashes,
            )
            weights = weights.astype(np.float32, copy=False)
            biases = bias64.astype(np.float32)

        r0 = dix.window_start_row(window)
        window_rows = dix.n_valid if window <= 0 else min(window, dix.n_valid)

        upd_seq0 = dix.update_seq  # read BEFORE the snapshot (reindex race)
        dev = dix.device_arrays()
        qn_dd_dev = None
        if self._sharded_scorer is not None:
            # multi-chip path: operands must carry the mesh sharding that
            # shard_map expects — keep the direct replicated uploads
            q_dev = jnp.asarray(q)
            w_dev = jnp.asarray(weights)
            if (
                getattr(self.options, "device_exact_cos", False)
                and dev.raw is not None
            ):
                # raw query bits for the sharded device-exact cosine
                # (refine_select_dd chains it into the same dispatch)
                ctx["q_raw_dev"] = jnp.asarray(q_raw)
        elif q_enc is not None:
            # device-embedded batch: assemble the raw query matrix on
            # device (encoder rows never leave the device; any explicit
            # host vectors upload as a compact minority slab), take the
            # double-float self-norms (8 B/query readback instead of the
            # [B, d] matrix), and normalize on device
            from omni_recall_tpu.ops import exact_cos as _ec

            host_idx = np.nonzero(ok)[0]
            if n_dev == b:
                q_raw_dev = q_enc
            else:
                # bucketed assemble: index pads point AT b (out of bounds),
                # which XLA scatter drops — so executables are shared
                # across batches with different embed/vector splits
                enc_idx = np.full(dev_bucket, b, dtype=np.int32)
                enc_idx[:n_dev] = dev_embed_idx
                h = len(host_idx)
                h_bucket = 1 << max(h - 1, 0).bit_length() if h else 1
                hi = np.full(h_bucket, b, dtype=np.int32)
                hi[:h] = host_idx
                hr = np.zeros((h_bucket, dix.dim), dtype=np.float32)
                hr[:h] = q_raw[host_idx]
                q_raw_dev = _assemble_q(
                    q_enc, jnp.asarray(enc_idx),
                    jnp.asarray(hr), jnp.asarray(hi),
                    jnp.zeros((b, dix.dim), dtype=jnp.float32),
                )
            ctx["q_raw_dev"] = q_raw_dev
            qn_dd_dev = _ec.self_norm_dd(q_raw_dev)
            _start_host_copies(qn_dd_dev)
            q_dev = _normalize_q_dd(q_raw_dev, qn_dd_dev[0])
            w_dev = (
                _densify_kw(jnp.asarray(kw_idx), jnp.asarray(kw_val),
                            dix.bloom_bits)
                if kw_idx is not None
                else self._sparse_w_dev(weights, b, dix.bloom_bits)
            )
        else:
            # upload-lean operands: ONE raw [B, d] f32 query upload + 4-byte inverse norms,
            # normalized on device (_normalize_q soundness note), and
            # SPARSE keyword weights (_sparse_w_dev)
            inv = np.zeros(b, dtype=np.float32)
            if ok.any():
                inv[ok] = (1.0 / np.sqrt(q_norms[ok])).astype(np.float32)
            q_raw_dev = ctx["q_raw_dev"] = jnp.asarray(q_raw)
            q_dev = _normalize_q(q_raw_dev, jnp.asarray(inv))
            w_dev = (
                _densify_kw(jnp.asarray(kw_idx), jnp.asarray(kw_val),
                            dix.bloom_bits)
                if kw_idx is not None
                else self._sparse_w_dev(weights, b, dix.bloom_bits)
            )
        bias_dev = jnp.asarray(biases)
        now_dev = jnp.float32(to_days(now))
        r0_dev = jnp.int32(r0)
        m = min(max(self.options.candidate_m, max(ks)), window_rows)

        ctx.update(
            ks=ks, q=q, q_raw=q_raw, q_norms=q_norms, terms=terms_all,
            host_only=host_only, r0=r0, window_rows=window_rows,
            upd_seq0=upd_seq0, dev=dev, q_dev=q_dev, w_dev=w_dev,
            bias_dev=bias_dev, now_dev=now_dev, r0_dev=r0_dev, m=m,
            kw_scan=None, coarse_scan=None,
            dev_embedded=dev_embedded if q_enc is not None else None,
            qn_dd_dev=qn_dd_dev,
            # host-materialized mask for the lazy query readback: host rows
            # already carry exact values; device rows materialize on demand
            q_ready=(~dev_embedded if q_enc is not None else None),
        )
        if not self.options.exact:
            return ctx
        host_set = set(host_only)
        # embedding-backed queries: nonzero host vector, or device-embedded
        q_live = ok | dev_embedded

        # Keyword-only prepass (exact profile): queries WITHOUT an embedding
        # have cosine exactly 0 (RecallSearchService.cs:70-71), so a
        # bloom+recency-only kernel produces the same sound bounds at
        # ~bits/(d+bits) of the fused scan cost with no emb stream. This is
        # the primary serving path of the default Embeddings:Provider=None
        # config. Certificate failures continue into the full fused loop.
        def chain_dd(sel, zero: bool = False):
            """Chain the device-exact cosine stage onto a compact selection
            (ops/exact_cos.py): DD-dot the selected rows against the RAW
            query matrix, in the same dispatch stream. Returns the (hi, lo,
            sabs) device triple or None when the raw plane is absent.

            ``zero``: the keyword-only selection — every pending query's
            raw row is exactly zero, so the DD triple is provably all-zero
            (and finish_cosines' q_norm==0 guard forces cos=0, margin=0
            regardless of it). Skip the [B, t_out, d] raw-plane gather and
            the 3-array readback; finalize synthesizes the zeros."""
            if dev.raw is None or not getattr(
                self.options, "device_exact_cos", False
            ):
                return None
            if zero:
                return ("zero",)
            from omni_recall_tpu.ops import exact_cos as _ec

            q_raw_dev = ctx.get("q_raw_dev")
            if q_raw_dev is None:
                q_raw_dev = ctx["q_raw_dev"] = jnp.asarray(q_raw)
            dd = _ec.exact_cos_rows(dev.raw, sel[0], q_raw_dev)
            _start_host_copies(dd)
            return dd

        kw_only = [
            i for i in range(b)
            if i not in host_set and not q_live[i]
        ]
        if kw_only:
            kw_scorer = self._select_kw_scorer(m, int(dev.emb.shape[0]))
            if kw_scorer is not None:
                k_vals, k_idxs = kw_scorer(dev, w_dev, bias_dev, now_dev, r0_dev, m)
                sel, _ = self._refine_select_call(
                    dev, q_dev, w_dev, bias_dev, now_dev, k_vals, k_idxs,
                    m, max(ks),
                )
                # which selection the direct gate chose for the kw batch:
                # its compact outcomes feed the direct gate too (ADVICE r4:
                # a kw-heavy workload whose direct bounds keep missing
                # previously paid the rescue round-trip every batch with no
                # adaptive fallback)
                ctx["kw_select_direct"] = self._last_select_direct
                if sel is not None:
                    ctx["kw_dd"] = chain_dd(sel, zero=True)
                    _start_host_copies(sel)
                    ctx["kw_scan"] = ("compact", kw_only, *sel)
                    # full [B, m+1] scan candidates stay device-resident:
                    # compact-certificate misses re-read just their rows
                    # (wide rescue) before paying a fresh rescue scan
                    ctx["kw_full"] = (k_vals, k_idxs)
                else:
                    k_ref = self._refine_call(
                        dev, q_dev, w_dev, bias_dev, now_dev, k_vals, k_idxs, m
                    )
                    ctx["kw_scan"] = ("full", kw_only, k_vals, k_idxs, k_ref)

        # Coarse prepass (exact profile): cosine-only scan with a sound
        # per-query keyword cap. Resolves nearly all embedding-backed queries
        # at ~(d)/(d+bits) of the full scan cost; certificate failures (and
        # keyword-only queries, whose coarse bound is vacuous) continue into
        # the full fused loop in the finalize phase.
        prepass = [
            i for i in range(b)
            if i not in host_set and q_live[i]
        ]
        if prepass and not self._coarse_gate_open():
            # closed gate: still advance the clock so the gate re-opens
            # after the skip horizon (re-probe), per _coarse_gate_record
            self._coarse_gate_advance(len(prepass))
            prepass = []
        if prepass:
            coarse = self._select_coarse_scorer(m, int(dev.emb.shape[0]))
            if coarse is not None:
                c_vals, c_idxs = coarse(dev, q_dev, w_dev, bias_dev, now_dev, r0_dev, m)
                sel, dd_inline = self._refine_select_call(
                    dev, q_dev, w_dev, bias_dev, now_dev, c_vals, c_idxs,
                    m, max(ks), q_raw_dev=ctx.get("q_raw_dev"),
                )
                # which selection the direct gate chose for THIS batch (the
                # finalize worker attributes compact-certificate outcomes
                # to the gate; single dispatcher thread, so the read-after-
                # call is race-free)
                ctx["select_direct"] = self._last_select_direct
                if sel is not None:
                    if dd_inline is not None:  # sharded: DD rode the dispatch
                        ctx["coarse_dd"] = dd_inline
                        _start_host_copies(dd_inline)
                    else:
                        ctx["coarse_dd"] = chain_dd(sel)
                    _start_host_copies(sel)
                    ctx["coarse_scan"] = ("compact", prepass, *sel)
                    ctx["coarse_full"] = (c_vals, c_idxs)  # wide rescue
                else:
                    c_ref = self._refine_call(
                        dev, q_dev, w_dev, bias_dev, now_dev, c_vals, c_idxs, m
                    )
                    ctx["coarse_scan"] = ("full", prepass, c_vals, c_idxs, c_ref)
        return ctx

    def _finalize_device_batch(self, ctx: dict) -> list[list[SearchHit]]:
        requests = ctx["requests"]
        if ctx["empty"]:
            return [[] for _ in requests]
        window, now, dix = ctx["window"], ctx["now"], ctx["dix"]
        ks, host_only = ctx["ks"], ctx["host_only"]
        window_rows, upd_seq0 = ctx["window_rows"], ctx["upd_seq0"]
        dev = ctx["dev"]
        q_dev, w_dev, bias_dev = ctx["q_dev"], ctx["w_dev"], ctx["bias_dev"]
        now_dev, r0_dev, m = ctx["now_dev"], ctx["r0_dev"], ctx["m"]
        b = len(requests)

        results: list[list[SearchHit] | None] = [None] * b
        self.last_escalations = 0

        # ONE fused device readback for everything this finalize consumes
        # unconditionally (query self-norms + both prepass candidate slices
        # + DD triples): each separate jax.device_get pays the transport's
        # per-sync round trip even with the dispatch-phase async copies in
        # flight. The ctx leaves are replaced with host arrays;
        # the downstream device_get calls pass numpy through untouched.
        prefetch: dict = {}
        for key in ("qn_dd_dev", "kw_dd", "coarse_dd"):
            v = ctx.get(key)
            if v is not None and len(v) != 1:  # skip chain_dd zero marker
                prefetch[key] = tuple(v)
        for key in ("kw_scan", "coarse_scan"):
            v = ctx.get(key)
            if v is not None:
                prefetch[key] = tuple(v[2:])  # device arrays only
        if prefetch:
            host_pre = jax.device_get(prefetch)
            for key, val in host_pre.items():
                if key.endswith("_scan"):
                    ctx[key] = tuple(ctx[key][:2]) + tuple(val)
                else:
                    ctx[key] = val

        # Device-resident query pipeline (attach_device_embedder): the raw
        # query rows live on device; only their double-float self-norms come
        # back eagerly (8 B/query). Exact rows + oracle norms materialize
        # lazily via ensure_host_q — only escalations pay that readback.
        dev_embedded = ctx.get("dev_embedded")
        q_ready = ctx.get("q_ready")
        qn_rel: np.ndarray | None = None
        suspect_q: list[int] = []
        if dev_embedded is not None:
            qhi, qlo = jax.device_get(ctx["qn_dd_dev"])
            qn_dd = qhi.astype(np.float64) + qlo.astype(np.float64)
            ctx["q_norms"][dev_embedded] = qn_dd[dev_embedded]
            # margin for the DD certificate: the device norm deviates from
            # the oracle's numpy norm by <= QN_DD_REL relative (exact_cos)
            from omni_recall_tpu.ops import exact_cos as _ec_mod

            qn_rel = np.where(dev_embedded, _ec_mod.QN_DD_REL, 0.0)
            # Sub-relative-regime guard: QN_DD_REL (and the scan bounds'
            # device normalization) are RELATIVE bounds — f32 underflow in
            # the self-dot could break them for pathologically tiny rows
            # (the encoder emits unit-norm rows, so this is defensive).
            # Such queries bypass every bound-based path: exact host scan.
            suspect_q = [
                int(i) for i in np.nonzero(dev_embedded & (qn_dd < 1e-26))[0]
            ]

        def ensure_host_q(indices) -> None:
            """Materialize exact f32 query rows + oracle f64 norms for
            device-embedded queries (lossless device->host copy of the
            canonical forward bits; np.sum matches the dispatch-phase host
            expression bit-for-bit). The gather index is padded to a
            power-of-two bucket: every distinct index-vector length is a
            fresh executable (one per batch, since escalation counts vary),
            while
            a padded gather re-reads a few duplicate rows."""
            if dev_embedded is None:
                return
            need = [i for i in indices if dev_embedded[i] and not q_ready[i]]
            if not need:
                return
            bucket = 1 << (len(need) - 1).bit_length()
            idx = np.zeros(bucket, dtype=np.int32)
            idx[: len(need)] = need
            rows = np.asarray(
                jnp.take(ctx["q_raw_dev"], jnp.asarray(idx), axis=0)
            )[: len(need)]
            ctx["q_raw"][need] = rows
            ctx["q_norms"][need] = np.sum(rows * rows, axis=1, dtype=np.float64)
            q_ready[need] = True

        def emb_for(i):
            """The request's embedding for host-oracle use: explicit vectors
            pass through; device-embedded queries hand back their
            materialized canonical bits."""
            query, emb, _ = requests[i]
            if dev_embedded is not None and dev_embedded[i]:
                ensure_host_q([i])
                return ctx["q_raw"][i].tolist()
            return emb

        def oracle_fill(indices):
            self.stats["host_fallbacks_total"] += len(indices)
            ensure_host_q(indices)
            for i in indices:
                query, _, _ = requests[i]
                results[i] = self._search_full_host(
                    query, emb_for(i), ks[i], window, now
                )

        if host_only:
            oracle_fill(host_only)
        if suspect_q:
            oracle_fill(suspect_q)

        meta = dix.meta

        def rescore_and_certify(pending, all_vals, all_idxs, m, all_ref=None):
            """Exact-rescore pending queries' candidates; fill results where
            the certificate passes (or the scan itself proves total coverage:
            boundary == -inf means the excluded set was empty IN THE
            SNAPSHOT — never inferred from a separately-read row count,
            which a concurrent append can make stale). Returns the
            still-unresolved indices.

            ``all_ref`` (optional [B, m]) carries the device-refined sound
            bounds (ops/refine.py), aligned with all_idxs[:, :m]. Candidates
            are then re-sorted by min(scan bound, refined bound) and the
            two-phase prune runs at the narrow refined phase-1 width — the
            refined bounds are within ~1e-4 of truth, so barely more than
            the requested k candidates survive the prune."""
            row_lists, ub_lists = [], []
            for i in pending:
                vals, idxs = all_vals[i], all_idxs[i]
                live = vals[:m] > -np.inf
                rows = idxs[:m][live]
                ubs = vals[:m][live]  # descending (top_k order) — the
                # two-phase prune in _exact_rescore_rows relies on it
                if all_ref is not None:
                    # min of two sound upper bounds is a sound upper bound
                    ubs = np.minimum(ubs, all_ref[i][live])
                keep = rows >= 0
                rows, ubs = rows[keep], ubs[keep]
                if len(rows):
                    # drop rows tombstoned between the device scan and now
                    # (concurrent delete); their exclusion can only be
                    # correct — deleted chunks must not be returned.
                    # valid[r] is False exactly when meta[r] is None (racy
                    # read is fine: a late tombstone is filtered again at
                    # SearchHit construction)
                    keep = dix.valid[rows]
                    if not keep.all():
                        rows, ubs = rows[keep], ubs[keep]
                if all_ref is not None and len(rows):
                    # restore the descending-ub invariant under the
                    # tightened bounds (stable: preserves scan order on ties)
                    order = np.argsort(-ubs, kind="stable")
                    rows, ubs = rows[order], ubs[order]
                row_lists.append(rows.astype(np.int64))
                ub_lists.append(ubs)
            prune = self.options.rescore_prune
            ensure_host_q(pending)  # exact query bits for the f64 rescore
            ranked = self._exact_rescore_rows(
                [(requests[i][0], requests[i][1]) for i in pending],
                row_lists, now, dix=dix,
                ub_lists=ub_lists if prune else None,
                ks=[ks[i] for i in pending] if prune else None,
                phase1=(
                    getattr(self.options, "rescore_phase1_refined", None)
                    if all_ref is not None else None
                ),
                q_matrix=ctx["q_raw"][pending],
                q_norms=ctx["q_norms"][pending],
                term_lists=[ctx["terms"][i] for i in pending],
            )
            if dix.update_seq != upd_seq0:
                # embeddings were updated in place (reindex) after the
                # device snapshot: exclusions rest on stale bounds while the
                # rescore read live rows — NO consistent state certifies the
                # combination. Serialize after the update via the exact host
                # scan. (The rescore reads under dix._lock and the seq bumps
                # before any write, so a rescore that saw updated values is
                # guaranteed to observe the new seq here.)
                oracle_fill(pending)
                return []
            unresolved = []
            for pi, i in enumerate(pending):
                k = ks[i]
                vals = all_vals[i]
                boundary = vals[m] if vals.shape[0] > m else -np.inf
                rows_sorted, scores_sorted = ranked[pi]
                if boundary == -np.inf:
                    pass  # candidates covered the whole snapshot: accept
                else:
                    kth = scores_sorted[k - 1] if len(scores_sorted) >= k else -np.inf
                    if not kth > boundary:
                        unresolved.append(i)
                        continue
                results[i] = [
                    SearchHit(meta[int(r)], float(s))
                    for r, s in zip(rows_sorted[:k], scores_sorted[:k])
                    if meta[int(r)] is not None
                ]
            return unresolved

        def rescore_and_certify_compact(pending, rows_a, ubs_a, bounds_a):
            """Certify from the compact device selection (ops/refine.py
            refine_select_from_scan): candidate rows arrive pre-sorted by
            their refined bound, and ``bounds_a[i]`` is the single sound
            bound over EVERY row not in the slice (scan-excluded rows AND
            device-dropped candidates), so the certificate check is
            unchanged: exact kth > bound => globally exact. bound == -inf
            means the slice covers the whole snapshot."""
            row_lists, ub_lists = [], []
            for i in pending:
                rows, ubs = rows_a[i], ubs_a[i]
                live = (ubs > -np.inf) & (rows >= 0)
                rows, ubs = rows[live], ubs[live]
                if len(rows):
                    keep = dix.valid[rows]  # concurrent-delete tombstones
                    if not keep.all():
                        rows, ubs = rows[keep], ubs[keep]
                row_lists.append(rows.astype(np.int64))
                ub_lists.append(ubs)
            prune = self.options.rescore_prune
            ensure_host_q(pending)  # exact query bits for the f64 rescore
            ranked = self._exact_rescore_rows(
                [(requests[i][0], requests[i][1]) for i in pending],
                row_lists, now, dix=dix,
                ub_lists=ub_lists if prune else None,
                ks=[ks[i] for i in pending] if prune else None,
                phase1=getattr(self.options, "rescore_phase1_refined", None),
                q_matrix=ctx["q_raw"][pending],
                q_norms=ctx["q_norms"][pending],
                term_lists=[ctx["terms"][i] for i in pending],
            )
            if dix.update_seq != upd_seq0:
                oracle_fill(pending)  # reindex race: same as the full path
                return []
            unresolved = []
            for pi, i in enumerate(pending):
                k = ks[i]
                boundary = bounds_a[i]  # device arrays cover the full batch
                rows_sorted, scores_sorted = ranked[pi]
                if boundary == -np.inf:
                    pass  # slice covered the whole snapshot: accept
                else:
                    kth = scores_sorted[k - 1] if len(scores_sorted) >= k else -np.inf
                    if not kth > boundary:
                        unresolved.append(i)
                        continue
                results[i] = [
                    SearchHit(meta[int(r)], float(s))
                    for r, s in zip(rows_sorted[:k], scores_sorted[:k])
                    if meta[int(r)] is not None
                ]
            return unresolved

        def rescore_and_certify_compact_dd(
            pending, rows_a, ubs_a, bounds_a, hi_a, lo_a, sabs_a
        ):
            """Certify from the compact selection using the DEVICE-exact
            cosines (ops/exact_cos.py): the host computes only keyword (via
            the native keyword-only rescorer — no embedding stream) and
            recency, fuses in f64 with the device double-float cosines, and
            certifies per query that the numpy-oracle scores could not
            rank or round differently (margins from finish_cosines; see the
            exact_cos module docstring). Queries failing any certificate —
            near-tie scores, rounding-midpoint proximity, kth-vs-bound
            margin — escalate to rescore_and_certify_compact (the bit-exact
            host float64 path) over the same candidate slice. Returns the
            still-unresolved indices."""
            from omni_recall_tpu.ops import exact_cos as _ec
            from omni_recall_tpu.index.device_index import to_micros

            # vectorized candidate assembly (a per-query python loop is
            # slow at serving batch sizes): row-major boolean
            # flattening preserves each query's candidate order exactly as
            # the per-query np.nonzero extraction did
            pend = np.asarray(pending)
            rows_p = rows_a[pend]                      # [P, t]
            live = (ubs_a[pend] > -np.inf) & (rows_p >= 0)
            safe = np.where(live, rows_p, 0)
            live &= dix.valid[safe]  # concurrent-delete tombstones
            lens = live.sum(axis=1).astype(np.int64)
            total = int(lens.sum())
            if total == 0:
                return rescore_and_certify_compact(
                    pending, rows_a, ubs_a, bounds_a
                )
            rows_flat = rows_p[live].astype(np.int64)
            owner = np.repeat(np.arange(len(pending)), lens)
            own_q = pend[owner]  # batch-level query index
            hi = hi_a[pend][live]
            lo = lo_a[pend][live]
            sabs = sabs_a[pend][live]

            cos, m_cos = _ec.finish_cosines(
                hi, lo, sabs, ctx["q_norms"][own_q], dix.raw_norm_sq[rows_flat],
                qn_rel=qn_rel[own_q] if qn_rel is not None else None,
            )
            kw_term = self._kw_scores_flat(
                rows_flat, owner, [ctx["terms"][i] for i in pending], dix
            )
            now_us = to_micros(now)
            age = np.maximum(
                0.0,
                ((now_us - dix.created_us[rows_flat]).astype(np.float64) / 1e6)
                / 86400.0,
            )
            rec = np.exp(-age / oracle.RECENCY_HALF_LIFE_DAYS)
            # EXACTLY the oracle expression order (fl(fl(0.7c)+fl(0.2kw)) +
            # fl(0.1rec)): given equal cosines the result is bit-identical
            # to the host float64 path
            scores = (
                oracle.COSINE_WEIGHT * cos + kw_term
            ) + oracle.RECENCY_WEIGHT * rec
            # score-level margin: 0 where the cosine is exact (zero-norm
            # guard / zero products) — equal scores then certify as ties
            margins = np.where(
                m_cos > 0.0,
                oracle.COSINE_WEIGHT * m_cos + 4e-16 * (np.abs(scores) + 1.0),
                0.0,
            )
            if dix.update_seq != upd_seq0:
                oracle_fill(pending)  # reindex race: same as the host path
                return []

            order = np.lexsort(
                (-dix.seqs[rows_flat], -dix.created_ts[rows_flat], -scores, owner)
            )
            rows_s = rows_flat[order]
            scores_s = scores[order]
            margins_s = margins[order]
            seg = np.zeros(len(pending) + 1, dtype=np.int64)
            np.cumsum(lens, out=seg[1:])

            k_arr = np.asarray([ks[i] for i in pending], dtype=np.int64)
            bnd = np.asarray([bounds_a[i] for i in pending], dtype=np.float64)
            resolved, provable, kk_arr = _dd_certify_batch(
                scores_s, margins_s, seg,
                np.asarray(lens, dtype=np.int64), k_arr, bnd,
            )
            unresolved = [pending[pi] for pi in np.nonzero(provable)[0]]
            esc_mask = ~provable & ~resolved
            escalate = [pending[pi] for pi in np.nonzero(esc_mask)[0]]
            if escalate or unresolved:
                # both sets need exact host query bits next (escalate: the
                # bit-exact rescore below; unresolved: the wide rescue /
                # rescue scan) — materialize them in ONE bucketed gather
                # instead of two device round trips
                ensure_host_q(escalate + unresolved)
            # count DD-rescored pairs once: escalated queries' pairs are
            # re-counted by the bit-exact host path (_exact_rescore_rows)
            # that re-rescores the same rows
            self.stats["rescore_pairs_total"] += total - int(
                np.asarray(lens, dtype=np.int64)[esc_mask].sum()
            )
            self.stats["dd_resolved_total"] += int(resolved.sum())
            for pi in np.nonzero(resolved)[0]:
                i = pending[pi]
                kk = int(kk_arr[pi])
                lo = seg[pi]
                results[i] = [
                    SearchHit(meta[int(row)], float(sc))
                    for row, sc in zip(
                        rows_s[lo: lo + kk], scores_s[lo: lo + kk]
                    )
                    if meta[int(row)] is not None
                ]
            if escalate:
                self.stats["dd_escalations_total"] += len(escalate)
                unresolved.extend(
                    rescore_and_certify_compact(escalate, rows_a, ubs_a, bounds_a)
                )
            return unresolved

        def consume_prepass(scan, dd=None):
            import jax as _jax

            tag, pending = scan[0], scan[1]
            # skip queries already resolved ahead of the prepass (the
            # sub-relative-regime guard routes them to the exact host scan;
            # their device bounds must not overwrite those results)
            pending = [i for i in pending if results[i] is None]
            if not pending:
                return pending, []
            if tag == "compact":
                # ONE batched readback: per-array np.asarray costs a device
                # round trip each; the dispatch
                # phase already started the host copies asynchronously
                if dd is not None:
                    if len(dd) == 1:  # chain_dd's ("zero",) marker
                        # keyword-only DD (chain_dd zero): the triple is
                        # provably all-zero — synthesize it host-side
                        rows_h, ubs_h, bound_h = _jax.device_get(
                            (scan[2], scan[3], scan[4])
                        )
                        z = np.zeros(rows_h.shape, dtype=np.float32)
                        hi_h = lo_h = sabs_h = z
                    else:
                        rows_h, ubs_h, bound_h, hi_h, lo_h, sabs_h = (
                            _jax.device_get(
                                (scan[2], scan[3], scan[4], dd[0], dd[1], dd[2])
                            )
                        )
                    return pending, rescore_and_certify_compact_dd(
                        pending, rows_h, ubs_h, bound_h, hi_h, lo_h, sabs_h
                    )
                rows_h, ubs_h, bound_h = _jax.device_get(
                    (scan[2], scan[3], scan[4])
                )
                return pending, rescore_and_certify_compact(
                    pending, rows_h, ubs_h, bound_h
                )
            vals_d, idxs_d, ref_d = scan[2], scan[3], scan[4]
            vals_h, idxs_h, ref_h = _jax.device_get((vals_d, idxs_d, ref_d))
            return pending, rescore_and_certify(
                pending, vals_h, idxs_h, m, all_ref=ref_h
            )

        # Keyword-only prepass results (dispatched in _dispatch_device_batch)
        if ctx["kw_scan"] is not None:
            kw_only, unresolved = consume_prepass(
                ctx["kw_scan"], ctx.get("kw_dd")
            )
            self.stats["kw_only_resolved_total"] += (
                len(kw_only) - len(unresolved)
            )
            # kw-only compact outcomes feed the direct gate exactly like
            # coarse-prepass ones (never the coarse gate — kw batches did
            # not run the coarse scan)
            if ctx.get("kw_select_direct"):
                self._direct_gate_record(
                    len(kw_only) - len(unresolved), len(kw_only)
                )
            elif ctx.get("kw_select_direct") is False:
                self._direct_gate_advance(len(kw_only))

        # Coarse prepass results (dispatched in _dispatch_device_batch)
        self.last_coarse_resolved = 0
        if ctx["coarse_scan"] is not None:
            prepass, unresolved = consume_prepass(
                ctx["coarse_scan"], ctx.get("coarse_dd")
            )
            self.last_coarse_resolved = len(prepass) - len(unresolved)
            self.stats["coarse_resolved_total"] += self.last_coarse_resolved
            if ctx.get("select_direct"):
                # direct-selection misses must NOT poison the COARSE gate
                # (the scan is fine — the looser (t_out+1)-th bound is what
                # missed; measured: the coarse gate closed on direct misses
                # and the engine abandoned the prepass entirely, 25x
                # slower). Direct batches are neutral for the coarse gate
                # and feed the direct gate instead.
                self._coarse_gate_advance(len(prepass))
                self._direct_gate_record(
                    self.last_coarse_resolved, len(prepass)
                )
            else:
                self._coarse_gate_record(
                    self.last_coarse_resolved, len(prepass)
                )
                if ctx.get("select_direct") is False:
                    # refine selection while the direct gate is closed:
                    # advance its clock toward the re-probe horizon
                    self._direct_gate_advance(len(prepass))

        def wide_rescue(full_key: str, scan_key: str) -> None:
            """Compact-prepass misses re-certified at the FULL scan width
            without a fresh scan: the dispatch's [B, m+1] scan candidates
            are still device-resident, so gather just the pending queries'
            rows (one small readback) and run the standard full-width
            certificate. Most compact failures are the (t_out+1)-th refined
            bound sitting in a co-located cluster — at width m the boundary
            is the scan's own (m+1)-th bound, which usually clears. Queries
            whose scan boundary itself is too tight proceed to the rescue
            scan exactly as before."""
            scan = ctx.get(scan_key)
            if ctx.get(full_key) is None or scan is None:
                return
            members = set(scan[1])
            pending = [
                i for i, r in enumerate(results) if r is None and i in members
            ]
            # near-full-width pending means the prepass certificate is
            # failing broadly (near-tie corpus) — the coarse bounds won't
            # clear at width m either, so skip the extra round trip and let
            # the rescue-scan loop run its tighter fused bounds
            if not pending or len(pending) > max(8, b // 2):
                return
            self.stats["rescue_wide_total"] += 1
            vals_d, idxs_d = ctx[full_key]
            pb = 1 << (len(pending) - 1).bit_length()
            sel = np.zeros(pb, dtype=np.int32)
            sel[: len(pending)] = pending
            sel_dev = jnp.asarray(sel)
            vals_p, idxs_p = jax.device_get((
                jnp.take(vals_d, sel_dev, axis=0),
                jnp.take(idxs_d, sel_dev, axis=0),
            ))
            vf, xf = _rehome_rows(
                b, pending, ((vals_p, -np.inf), (idxs_p, -1))
            )
            rescore_and_certify(pending, vf, xf, m, all_ref=None)

        if self.options.exact and any(r is None for r in results):
            wide_rescue("kw_full", "kw_scan")
            wide_rescue("coarse_full", "coarse_scan")

        while any(r is None for r in results):
            pending = [i for i, r in enumerate(results) if r is None]
            scorer, full_coverage = self._select_scorer(m, int(dev.emb.shape[0]))
            if scorer is None:
                # quantized storage with no fast path left: exact host scan
                oracle_fill(pending)
                break
            # Slice the rescue scan to the PENDING queries (bucketed pow2
            # width, duplicate-of-first pads): the fused scan streams the
            # same index bytes regardless of batch width, but the refine
            # width, readback bytes, and host
            # rescore all scale with it — a prepass-certificate miss of a
            # few queries out of 1536 previously re-paid the WHOLE batch.
            # Full-width batches (e.g. prepass disabled) skip the gather.
            sliced = self.options.exact and len(pending) <= b // 2
            if sliced:
                self.stats["rescue_sliced_total"] += 1
                pb = 1 << (len(pending) - 1).bit_length()
                sel = np.zeros(pb, dtype=np.int32)
                sel[: len(pending)] = pending
                sel_dev = jnp.asarray(sel)
                q_s = jnp.take(q_dev, sel_dev, axis=0)
                w_s = jnp.take(w_dev, sel_dev, axis=0)
                bias_s = jnp.take(bias_dev, sel_dev, axis=0)
            else:
                q_s, w_s, bias_s = q_dev, w_dev, bias_dev
            all_vals, all_idxs = scorer(dev, q_s, w_s, bias_s, now_dev, r0_dev, m)
            all_ref = (
                self._refine_call(
                    dev, q_s, w_s, bias_s, now_dev, all_vals, all_idxs, m
                )
                if self.options.exact else None
            )
            all_vals = np.asarray(all_vals)
            all_idxs = np.asarray(all_idxs)
            all_ref = np.asarray(all_ref) if all_ref is not None else None
            if sliced:
                all_vals, all_idxs = _rehome_rows(
                    b, pending, ((all_vals, -np.inf), (all_idxs, -1))
                )
                if all_ref is not None:
                    (all_ref,) = _rehome_rows(b, pending, ((all_ref, -np.inf),))

            if not self.options.exact:
                # approximate profile: rank by the device upper bound
                for i in pending:
                    vals, idxs = all_vals[i], all_idxs[i]
                    live = vals[:m] > -np.inf
                    hits = []
                    for row, ub in zip(idxs[:m][live], vals[:m][live]):
                        chunk = dix.meta[int(row)]
                        if chunk is not None:
                            hits.append(SearchHit(chunk, float(ub)))
                    results[i] = hits[: ks[i]]
                break

            unresolved = rescore_and_certify(
                pending, all_vals, all_idxs, m, all_ref=all_ref
            )
            if m >= window_rows and not full_coverage:
                # partial-coverage scorer exhausted: exact host scan
                oracle_fill(unresolved)
                unresolved = []

            if any(r is None for r in results):
                if m >= window_rows or m >= self._ESCALATION_MAX_M:
                    oracle_fill([i for i, r in enumerate(results) if r is None])
                    break
                m = min(m * 4, window_rows)
                self.last_escalations += 1
                self.stats["escalation_rounds_total"] += 1

        return results  # type: ignore[return-value]
