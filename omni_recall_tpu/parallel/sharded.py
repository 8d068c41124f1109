"""Multi-chip sharded scoring: per-shard top-k + all-gather merge.

The chunk index rows shard over a 1-D ``'shards'`` mesh (every card reaches
every other at the same rate, so the mesh follows the algorithm alone).
Each shard scores its local rows — with either the pure-XLA upper-bound
pass (f32 storage) or the platform's int8 slice scan (ops/routes.py) —
takes a LOCAL top-(m+1), and the small [S, B, m+1] candidate tensors are
all-gathered and merged into the global top-m + boundary. Exact because
scoring is pointwise per row: the global top-k is contained in the union of per-shard top-k's, and
the merged boundary (max of the (m+1)-th merged candidate and every shard's
own boundary) bounds every excluded row. Determinism: ties inside a shard
resolve to the lowest local row, the merge re-sorts on (value, gather
order), and the final ranking comes from the host's exact rescore, which is
shard-count independent (tests/test_sharded.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from omni_recall_tpu.ops import scan, xla_scorer
from omni_recall_tpu.ops.merge import top_k_with_payload


def _globalize_and_merge(out_v, out_i, row_offset, m):
    """All-gather per-shard [B, m+1] (candidates + boundary at entry m) and
    merge into the global [B, m+1]."""
    gi = jnp.where(out_i >= 0, out_i + row_offset, out_i)
    all_v = jax.lax.all_gather(out_v, "shards")  # [S, B, m+1]
    all_i = jax.lax.all_gather(gi, "shards")
    s, b, _ = all_v.shape
    cand_v = jnp.transpose(all_v[:, :, :m], (1, 0, 2)).reshape(b, s * m)
    cand_i = jnp.transpose(all_i[:, :, :m], (1, 0, 2)).reshape(b, s * m)
    shard_bounds = jnp.max(all_v[:, :, m], axis=0)  # [B]

    k = min(m + 1, s * m)
    top_v, top_i = top_k_with_payload(cand_v, cand_i, k)
    boundary_emitted = top_v[:, m] if k > m else jnp.full((b,), -jnp.inf)
    boundary = jnp.maximum(boundary_emitted, shard_bounds)
    out_v = jnp.concatenate([top_v[:, :m], boundary[:, None]], axis=1)
    out_i = jnp.concatenate(
        [top_i[:, :m], jnp.full((b, 1), -1, dtype=jnp.int32)], axis=1
    )
    return out_v, out_i


class ShardedScorer:
    """Caches jitted shard_map scorers per (mode, m, t, sub). ``route`` is
    the platform's device route (ops/routes.py; default: the current
    platform's)."""

    def __init__(self, mesh: Mesh, route=None) -> None:
        if route is None:
            from omni_recall_tpu.ops import routes

            route = routes.current()
        self.mesh = mesh
        self.n_shards = int(mesh.devices.size)
        self.route = route
        self._fns: dict[tuple, object] = {}

    def row_sharding(self, ndim: int) -> NamedSharding:
        from omni_recall_tpu.parallel.mesh import row_sharding

        return row_sharding(self.mesh, ndim)  # one source for the layout

    # -- local shard bodies --

    def _local_xla(self, m):
        k_local = m + 1

        def local_fn(emb, bloom, created, valid, q, kw_w, kw_b, now_days, window_start):
            n_local = emb.shape[0]
            shard = jax.lax.axis_index("shards")
            row_offset = (shard * n_local).astype(jnp.int32)
            ub = xla_scorer.ub_scores(
                emb, bloom, created, valid, q, kw_w, kw_b,
                now_days, window_start, row_offset=row_offset,
            )
            k = min(k_local, n_local)
            vals, idxs = xla_scorer._topk_rows(ub, k)
            if k < k_local:
                pad = k_local - k
                vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=-jnp.inf)
                idxs = jnp.pad(idxs, ((0, 0), (0, pad)), constant_values=-1 - int(1e9))
            # entry m doubles as the shard boundary: the (m+1)-th local value
            # bounds every unemitted local row; mark it bound-only (-2 is
            # the non-candidate sentinel, also applied to padded entries)
            idxs_b = idxs.at[:, k_local - 1].set(-2) if k == k_local else idxs
            out_i = jnp.where(idxs_b >= 0, idxs_b, -2)
            return _globalize_and_merge(vals, out_i, row_offset, m)

        return local_fn

    def _local_scan(self, terms, m, t, sub):
        """int8 slice scan of one term set over the local rows; the bound
        operands come from the shared constructions (ops/scan.py
        scan_operands, soundness-critical)."""
        impl = self.route.scan

        def local_fn(*args):
            if terms == "kw":  # no embedding operands at all
                emb = scale = err = q = None
                bloom, created, valid, kw_w, kw_b, now_days, window_start = args
            else:
                (emb, scale, err, bloom, created, valid, q, kw_w, kw_b,
                 now_days, window_start) = args
            n_local = created.shape[0]
            shard = jax.lax.axis_index("shards")
            row_offset = (shard * n_local).astype(jnp.int32)
            ops = scan.scan_operands(
                terms, emb, bloom, scale, err, created, valid, q, kw_w, kw_b,
                now_days, window_start, row_offset=row_offset,
            )
            vals, idxs = impl(*ops, terms=terms, sub=sub, t=t)
            out_v, out_i = scan.merge_topm(vals, idxs, m)
            return _globalize_and_merge(out_v, out_i, row_offset, m)

        return local_fn

    # -- public --

    def local_rows(self, n_rows_padded: int) -> int:
        return n_rows_padded // self.n_shards

    def refine_select_dd(
        self, dev, q, kw_w, kw_b, now_days, vals_full, idxs_full,
        t_out: int, r: int, q_raw=None,
    ):
        """Sharded compact serving stage: device-assisted refine of the
        merged scan candidates + compact selection (+ the device-exact
        cosine triple when ``q_raw`` is given and the raw plane exists),
        in ONE shard_map dispatch.

        The merged candidates' global row indices are replicated; each row
        lives on exactly one shard. Every shard maps the indices to LOCAL
        coordinates (non-owned rows -> the ``-1`` sentinel the single-device
        refine already treats as dead) and runs the UNCHANGED refine
        dispatch (ops/refine.py) over its local planes, so the soundness
        derivation applies verbatim. The per-candidate refined bounds
        combine with ``psum``: exactly one shard contributes a finite value
        and the rest contribute exact +0.0 (IEEE x + 0.0 == x), so the
        combined bound is BIT-IDENTICAL to the owner's local value. The
        compact selection then runs replicated (identical on every shard),
        and the DD stage gathers each selected row on its owner and psums
        the (hi, lo, sabs) triple the same exact-zero way — the double-float
        error bounds (ops/exact_cos.py DD_SUM_REL et al.) are untouched.

        Returns (rows [B, k], ubs [B, k], bound [B]) or, with DD,
        (rows, ubs, bound, hi, lo, sabs). No reference counterpart (the
        reference is single-process; this serves the 10M+ sharded scale)."""
        from omni_recall_tpu.ops import exact_cos as _ec
        from omni_recall_tpu.ops import refine as _refine

        want_dd = q_raw is not None and dev.raw is not None
        m1 = int(vals_full.shape[1])
        key = ("refine_select_dd", t_out, r, want_dd, m1)
        fn = self._fns.get(key)
        if fn is None:
            row = P("shards", None)
            vec = P("shards")
            rep = P()

            def local_fn(*args):
                if want_dd:
                    (emb1, scale1, emb2, scale2, err2, bloom, created,
                     valid, raw, q_, kw_w_, kw_b_, now_, vals_f, idxs_f,
                     q_raw_) = args
                else:
                    (emb1, scale1, emb2, scale2, err2, bloom, created,
                     valid, q_, kw_w_, kw_b_, now_, vals_f, idxs_f) = args
                n_local = emb1.shape[0]
                shard = jax.lax.axis_index("shards")
                row_offset = (shard * n_local).astype(jnp.int32)
                rows_g = idxs_f[:, :r]
                loc = rows_g - row_offset
                owned = (rows_g >= 0) & (loc >= 0) & (loc < n_local)
                rows_local = jnp.where(owned, loc, -1)
                vals_local = jnp.where(owned, vals_f[:, :r], -jnp.inf)
                kw_w8 = scan.quantize_kw_weights(kw_w_)
                refined_local = _refine._refine_dispatch(
                    emb1, scale1, emb2, scale2, err2, bloom, created, valid,
                    q_, kw_w8, kw_b_, now_, rows_local, vals_local,
                )
                live = refined_local > -jnp.inf
                total = jax.lax.psum(
                    jnp.where(live, refined_local, 0.0), "shards"
                )
                n_own = jax.lax.psum(live.astype(jnp.int32), "shards")
                refined = jnp.where(n_own > 0, total, -jnp.inf)
                rows_sel, ubs_sel, bound = _refine.compact_select(
                    vals_f, idxs_f, refined, t_out, r
                )
                if not want_dd:
                    return rows_sel, ubs_sel, bound
                loc_s = rows_sel - row_offset
                owned_s = (rows_sel >= 0) & (loc_s >= 0) & (loc_s < n_local)
                safe_s = jnp.where(owned_s, loc_s, 0)
                c = jnp.take(raw, safe_s, axis=0)          # [B, k, d]
                # SAME routed DD as the single-device exact_cos_rows, so
                # the two paths produce the same bits
                hi, lo, sabs = _ec.dd_rows(q_raw_, c)
                hi = jax.lax.psum(jnp.where(owned_s, hi, 0.0), "shards")
                lo = jax.lax.psum(jnp.where(owned_s, lo, 0.0), "shards")
                sabs = jax.lax.psum(jnp.where(owned_s, sabs, 0.0), "shards")
                return rows_sel, ubs_sel, bound, hi, lo, sabs

            in_specs = (row, vec, row, vec, vec, row, vec, vec) + (
                (row,) if want_dd else ()
            ) + (rep,) * (6 + (1 if want_dd else 0))
            out_specs = (rep,) * (6 if want_dd else 3)
            fn = self._fns[key] = jax.jit(
                jax.shard_map(
                    local_fn, mesh=self.mesh,
                    in_specs=in_specs, out_specs=out_specs, check_vma=False,
                )
            )
        args = (
            dev.emb, dev.scale, dev.emb2, dev.scale2, dev.err2,
            dev.bloom, dev.created, dev.valid,
        )
        if want_dd:
            args = args + (dev.raw,)
        args = args + (q, kw_w, kw_b, now_days, vals_full, idxs_full)
        if want_dd:
            args = args + (q_raw,)
        return fn(*args)

    def score_topm(
        self, emb, bloom, created, valid, q, kw_w, kw_b, now_days,
        window_start, m: int, mode: str = "xla", t: int = 8, sub: int = 128,
        scale=None, err=None,
    ):
        """Sharded (ub_values[B, m+1], row_indices[B, m+1]). ``mode`` is
        "xla" (f32 storage) or a scan term set (ops/scan.py TERM_SETS)."""
        key = (mode, m, t, sub)
        fn = self._fns.get(key)
        if fn is None:
            row = P("shards", None)
            vec = P("shards")
            rep = P()
            if mode == "xla":
                local = self._local_xla(m)
                in_specs = (row, row, vec, vec, rep, rep, rep, rep, rep)
            elif mode == "kw":
                local = self._local_scan(mode, m, t, sub)
                in_specs = (row, vec, vec) + (rep,) * 4
            else:
                local = self._local_scan(mode, m, t, sub)
                in_specs = (row, vec, vec, row, vec, vec) + (rep,) * 5
            fn = self._fns[key] = jax.jit(
                jax.shard_map(
                    local, mesh=self.mesh,
                    in_specs=in_specs, out_specs=(rep, rep), check_vma=False,
                )
            )
        if mode == "xla":
            return fn(emb, bloom, created, valid, q, kw_w, kw_b, now_days,
                      window_start)
        if mode == "kw":
            return fn(bloom, created, valid, kw_w, kw_b, now_days, window_start)
        return fn(emb, scale, err, bloom, created, valid, q, kw_w, kw_b,
                  now_days, window_start)
