"""Hopper scan kernel: Pallas through Triton.

Computes the ops/scan.py contract — per query, the top-t rows of every
slice plus the slice's (t+1)-th value — without writing the [B, N] score
matrix to device memory. The grid is query tiles x row tiles; one program
owns a [BQ, BN] tile, and its row tile IS one extraction slice:

- cosine: a loop over K-chunks of d, ``pl.dot`` of int8 operands with
  int32 accumulation (exact: |sum| <= d * 127^2);
- keyword: a loop over chunks of ``WK`` bloom words. The words are
  decoded to bits in registers and dotted with the int8 keyword weights,
  whose columns were permuted once outside the kernel (``permute_kw``) so
  that each word chunk's 8*WK bits are contiguous. A permutation of the
  summation index leaves the integer dot exact;
- epilogue: ops/scan.py ``epilogue`` on the tile (the same f32 expression
  the XLA scan evaluates), then t+1 rounds of max/mask extraction along
  the row axis; ties go to the lowest row, as with lax.top_k.

The query batch is padded to the query tile; the row count must be a
multiple of the slice (ops/scan.py scan_slice). The tile sizes below
compile and beat the XLA scan on an H100 (PERF.md); they have not been
swept.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from omni_recall_tpu.ops.scan import epilogue

BQ_MAX = 128  # query tile
BK_MAX = 128  # int8 K-chunk of the cosine dot
WK_MAX = 16   # bloom words per keyword K-chunk (8 * WK bits)
NUM_WARPS = 8
NUM_STAGES = 3


def _pow2_divisor(n: int, cap: int, floor: int) -> int:
    """Largest power of two <= cap dividing n, or 0 if below floor."""
    p = cap
    while p >= floor:
        if n % p == 0:
            return p
        p //= 2
    return 0


def permute_kw(kw_w8: jax.Array, wk: int) -> jax.Array:
    """Reorder keyword-weight columns from the index's plane-major bit order
    (column p*W + w = bit p of word w) to word-chunk order: chunk c holds
    the 8*wk bits of words [c*wk, (c+1)*wk), plane-major within the chunk
    (column c*8*wk + p*wk + w % wk) — the order the kernel decodes them."""
    b, bits = kw_w8.shape
    w = bits // 8
    x = kw_w8.reshape(b, 8, w // wk, wk)          # [b, p, c, wl]
    return jnp.transpose(x, (0, 2, 1, 3)).reshape(b, bits)


def _kernel(*refs, cos: bool, kw: bool, t1: int, d: int, bk: int,
            w: int, wk: int, bq: int, bn: int):
    it = iter(refs)
    if cos:
        q_ref, emb_ref, qs_ref, scale_ref, qb_ref = (next(it) for _ in range(5))
    if kw:
        kwp_ref, bloom_ref, kwb_ref = (next(it) for _ in range(3))
    add_ref, vals_ref, idxs_ref = next(it), next(it), next(it)

    cosd = kwd = None
    if cos:
        def cos_step(k, acc):
            q = q_ref[:, pl.ds(k * bk, bk)]
            e = emb_ref[:, pl.ds(k * bk, bk)]
            return acc + pl.dot(q, e, trans_b=True)

        cosd = jax.lax.fori_loop(
            0, d // bk, cos_step, jnp.zeros((bq, bn), jnp.int32)
        )
    if kw:
        plane = jax.lax.broadcasted_iota(jnp.int32, (1, 8, 1), 1)

        def kw_step(c, acc):
            words = bloom_ref[:, pl.ds(c * wk, wk)].astype(jnp.int32)
            bits = ((words[:, None, :] >> plane) & 1).astype(jnp.int8)
            wq = kwp_ref[:, pl.ds(c * 8 * wk, 8 * wk)]
            return acc + pl.dot(wq, bits.reshape(bn, 8 * wk), trans_b=True)

        kwd = jax.lax.fori_loop(
            0, w // wk, kw_step, jnp.zeros((bq, bn), jnp.int32)
        )
    s = epilogue(
        cosd, kwd,
        qs_ref[...] if cos else None, scale_ref[...] if cos else None,
        kwb_ref[...] if kw else None, add_ref[...],
        qb_ref[...] if cos else None,
    )
    lane = jax.lax.broadcasted_iota(jnp.int32, (bq, bn), 1)
    base = pl.program_id(1) * bn
    for r in range(t1):
        v = jnp.max(s, axis=1)
        vals_ref[0, :, r] = v
        if r == t1 - 1:  # the slice bound: value only
            idxs_ref[0, :, r] = jnp.full((bq,), -2, jnp.int32)
            break
        idx = jnp.min(jnp.where(s == v[:, None], lane, bn), axis=1)
        idxs_ref[0, :, r] = idx + base
        # -inf, below every masked row's NEG_INF: masked slices still
        # emit their rows lowest first, as lax.top_k does
        s = jnp.where(lane == idx[:, None], -jnp.inf, s)


@functools.partial(
    jax.jit, static_argnames=("terms", "sub", "t", "interpret")
)
def scan_triton(emb8, bloom, q8, kw_w8, kw_b, add_row, scale_row, qs, q_bias,
                *, terms: str, sub: int, t: int, interpret: bool = False):
    """The Triton scan; same operands and [S, B, t+1] result as
    ops/scan.py scan_xla. ``sub`` is the row tile."""
    cos, kw = "cos" in terms, "kw" in terms
    n = add_row.shape[0]
    b = (q8 if cos else kw_w8).shape[0]
    if n % sub or sub & (sub - 1) or sub < 16:
        raise ValueError(f"row tile {sub} must be a power of two >= 16 dividing {n}")
    t1 = t + 1
    bq = min(BQ_MAX, max(16, 1 << (b - 1).bit_length()))
    bp = -(-b // bq) * bq

    def padq(x):  # pad the query axis to the query tile
        return jnp.pad(x, [(0, bp - b)] + [(0, 0)] * (x.ndim - 1))

    d = bk = w = wk = 0
    args, specs = [], []
    if cos:
        d = emb8.shape[1]
        bk = _pow2_divisor(d, BK_MAX, 32)
        if not bk:
            raise ValueError(f"embedding width {d} is not a multiple of 32")
        args += [padq(q8), emb8, padq(qs), scale_row, padq(q_bias)]
        specs += [
            pl.BlockSpec((bq, d), lambda i, j: (i, 0)),
            pl.BlockSpec((sub, d), lambda i, j: (j, 0)),
            pl.BlockSpec((bq,), lambda i, j: (i,)),
            pl.BlockSpec((sub,), lambda i, j: (j,)),
            pl.BlockSpec((bq,), lambda i, j: (i,)),
        ]
    if kw:
        w = bloom.shape[1]
        wk = _pow2_divisor(w, WK_MAX, 4)
        if not wk:
            raise ValueError(f"bloom width {w} bytes is not a multiple of 4")
        args += [padq(permute_kw(kw_w8, wk)), bloom, padq(kw_b)]
        specs += [
            pl.BlockSpec((bq, 8 * w), lambda i, j: (i, 0)),
            pl.BlockSpec((sub, w), lambda i, j: (j, 0)),
            pl.BlockSpec((bq,), lambda i, j: (i,)),
        ]
    args.append(add_row)
    specs.append(pl.BlockSpec((sub,), lambda i, j: (j,)))
    s = n // sub
    out_spec = pl.BlockSpec((1, bq, t1), lambda i, j: (j, i, 0))
    vals, idxs = pl.pallas_call(
        functools.partial(
            _kernel, cos=cos, kw=kw, t1=t1, d=d, bk=bk, w=w, wk=wk,
            bq=bq, bn=sub,
        ),
        grid=(bp // bq, s),
        in_specs=specs,
        out_specs=[out_spec, out_spec],
        out_shape=[
            jax.ShapeDtypeStruct((s, bp, t1), jnp.float32),
            jax.ShapeDtypeStruct((s, bp, t1), jnp.int32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name=f"scan_{terms}",
    )(*args)
    return vals[:, :b], idxs[:, :b]
