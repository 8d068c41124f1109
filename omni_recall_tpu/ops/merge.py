"""Top-k-with-payload: one stable co-sort instead of top_k + gather.

A single stable ``lax.sort`` carrying the payload replaces ``lax.top_k``
followed by a ``take_along_axis`` gather of the payload.

Tie semantics match ``lax.top_k``: the sort is stable, so equal values keep
their original (ascending-position) order — the engine's deterministic
lowest-row-index-wins contract.
"""

from __future__ import annotations

import jax


def top_k_with_payload(vals: jax.Array, payload: jax.Array, k: int):
    """Descending top-k of ``vals`` along the last axis with the aligned
    ``payload`` rows co-sorted. Returns (top_vals, top_payload), each
    ``vals.shape[:-1] + (k,)``."""
    neg, pay = jax.lax.sort(
        (-vals, payload), dimension=vals.ndim - 1, num_keys=1
    )
    return -neg[..., :k], pay[..., :k]
