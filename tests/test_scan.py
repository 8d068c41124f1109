"""The int8 slice scan (ops/scan.py), its Triton kernel in interpret mode
(ops/triton_scan.py), the route table (ops/routes.py), the compile-cache
rule and the double-float dot's numpy mirror — the CPU side of what
tests/test_chip.py and chip_smoke.py check on the card."""

import functools
from datetime import datetime, timedelta, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omni_recall_tpu.ops import exact_cos, hashing, oracle, routes, scan, triton_scan, xla_scorer
from omni_recall_tpu.ops.quantize import quantize_rows_int8

_KERNEL = functools.partial(triton_scan.scan_triton, interpret=True)


def _inputs(seed, n, b, d=64, bits=256):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    bloom = (rng.integers(0, 256, (n, bits // 8)) & rng.integers(0, 256, (n, bits // 8))).astype(np.uint8)
    created = np.sort(rng.random(n) * 100).astype(np.float32)
    valid = rng.random(n) > 0.1
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kw = np.zeros((b, bits), np.float32)
    for i in range(b):
        kw[i, rng.choice(bits, 12, replace=False)] = 1.0 / 12
    kb = (rng.random(b) * 0.05).astype(np.float32)
    return emb, bloom, created, valid, q, kw, kb


def _operands(terms, emb, bloom, created, valid, q, kw, kb, r0=0):
    q8, scale, err = quantize_rows_int8(emb)
    return scan.scan_operands(
        terms, jnp.asarray(q8), jnp.asarray(bloom), jnp.asarray(scale),
        jnp.asarray(err), jnp.asarray(created), jnp.asarray(valid),
        jnp.asarray(q), jnp.asarray(kw), jnp.asarray(kb),
        jnp.float32(100.0), jnp.int32(r0),
    )


@pytest.mark.parametrize("terms", scan.TERM_SETS)
@pytest.mark.parametrize("n,b,sub", [(512, 20, 128), (192, 5, 64)])
def test_kernel_matches_xla_scan(terms, n, b, sub):
    """The Triton kernel (interpret mode) and the XLA scan emit the same
    [S, B, t+1] bounds and rows, also where B is no multiple of the query
    tile and the slice is narrower than the full row tile."""
    ops = _operands(terms, *_inputs(1, n, b), r0=n // 4)
    assert scan.scan_slice(n) == sub
    want = scan.scan_xla(*ops, terms=terms, sub=sub, t=3)
    got = _KERNEL(*ops, terms=terms, sub=sub, t=3)
    assert got[0].shape == want[0].shape == (n // sub, b, 4)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=0, atol=1e-6)
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert (np.asarray(got[1])[:, :, 3] == -2).all()  # bound entries


def test_kernel_rejects_a_tile_that_does_not_divide_the_rows():
    ops = _operands("kw", *_inputs(2, 192, 3))
    with pytest.raises(ValueError):
        _KERNEL(*ops, terms="kw", sub=128, t=2)
    with pytest.raises(ValueError):
        scan.scan_xla(*ops, terms="kw", sub=128, t=2)


def test_xla_scan_bounds_xla_scorer_and_oracle():
    """Every emitted bound covers the exact f32 score of its row
    (xla_scorer minus its margin) and the boundary covers every excluded
    row; the float64 oracle's top rows are candidates or under the
    boundary."""
    n, b, m = 1024, 3, 16
    emb, bloom, created, valid, q, kw, kb = _inputs(3, n, b)
    ops = _operands("cos_kw", emb, bloom, created, valid, q, kw, kb)
    vals, idxs = scan.merge_topm(*scan.scan_xla(*ops, terms="cos_kw", sub=128, t=4), m)
    vals, idxs = np.asarray(vals), np.asarray(idxs)
    exact = np.asarray(xla_scorer.ub_scores(
        jnp.asarray(emb), jnp.asarray(bloom), jnp.asarray(created),
        jnp.asarray(valid), jnp.asarray(q), jnp.asarray(kw), jnp.asarray(kb),
        jnp.float32(100.0), jnp.int32(0),
    )) - xla_scorer.CERT_EPS
    for i in range(b):
        cand = idxs[i, :m]
        assert (vals[i, :m] >= exact[i, cand] - 1e-6).all()
        out = np.setdiff1d(np.nonzero(np.isfinite(exact[i]))[0], cand)
        assert (exact[i, out] <= vals[i, m] + 1e-6).all()
    # float64 oracle over texts whose bloom signatures are the index's own
    words = ["alpha", "beta", "gamma", "delta", "omega"]
    texts = [" ".join(words[j % 5] for j in range(r % 4 + 1)) + f" r{r}" for r in range(n)]
    sig = np.stack([hashing.chunk_signature(t, 256, 4, 1) for t in texts])
    w, bias = hashing.query_bit_weights(oracle.query_terms("gamma delta"), 256, 4, 1)
    kwq = np.repeat(w[None], b, 0).astype(np.float32)
    kbq = np.full(b, bias, np.float32)
    ops = _operands("cos_kw", emb, sig, created, np.ones(n, bool), q, kwq, kbq)
    vals, idxs = scan.merge_topm(*scan.scan_xla(*ops, terms="cos_kw", sub=128, t=4), m)
    vals, idxs = np.asarray(vals), np.asarray(idxs)
    epoch = datetime(2024, 1, 1, tzinfo=timezone.utc)
    now = epoch + timedelta(days=100)
    for i in range(b):
        scores = np.array([
            oracle.score_chunk("gamma delta", q[i], emb[r], texts[r],
                               epoch + timedelta(days=float(created[r])), now)
            for r in range(n)
        ])
        top = np.argsort(-scores, kind="stable")[:5]
        for r in top:
            assert r in idxs[i, :m] or scores[r] <= vals[i, m]
            if r in idxs[i, :m]:
                assert vals[i, list(idxs[i, :m]).index(r)] >= scores[r]


def test_scan_slice_and_merge_budget():
    assert scan.scan_slice(1 << 20) == scan.ROW_TILE
    assert scan.scan_slice(96) == 32
    assert scan.scan_slice(24) == 0
    v = jnp.zeros((2, 1, 3))
    i = jnp.zeros((2, 1, 3), jnp.int32)
    with pytest.raises(ValueError):
        scan.merge_topm(v, i, 5)  # 2 slices * t=2 < 5


def test_route_table():
    cpu = routes.for_platform("cpu")
    assert cpu.scan is scan.scan_xla
    gpu = routes.for_platform("gpu")
    assert gpu.scan is triton_scan.scan_triton
    assert gpu.refine is cpu.refine and gpu.dd is cpu.dd
    assert routes.current().platform == jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="'tpu'"):
        routes.for_platform("tpu")


@pytest.mark.parametrize("wk", [4, 8, 16])
def test_kw_column_permutation_keeps_the_integer_dot(wk):
    """permute_kw reorders the plane-major weight columns into word-chunk
    order; dotting each chunk's in-register bit decode with its permuted
    columns sums to the plane-major dot exactly."""
    rng = np.random.default_rng(wk)
    n, b, w = 40, 3, 32
    words = rng.integers(0, 256, (n, w)).astype(np.uint8)
    kw8 = rng.integers(0, 128, (b, 8 * w)).astype(np.int8)
    want = np.asarray(kw8, np.int64) @ np.asarray(scan.bloom_bits(jnp.asarray(words)), np.int64).T
    perm = np.asarray(triton_scan.permute_kw(jnp.asarray(kw8), wk), np.int64)
    got = np.zeros((b, n), np.int64)
    for c in range(w // wk):
        chunk = words[:, c * wk:(c + 1) * wk].astype(np.int64)
        bits = ((chunk[:, None, :] >> np.arange(8)[None, :, None]) & 1).reshape(n, 8 * wk)
        got += perm[:, c * 8 * wk:(c + 1) * 8 * wk] @ bits.T
    assert np.array_equal(got, want)


def test_compile_cache_path_rule(monkeypatch):
    from omni_recall_tpu.utils import compile_cache

    assert compile_cache.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None
    repo_cache = compile_cache.compile_cache_dir({})
    assert repo_cache.name == ".jax_cache"
    assert (repo_cache.parent / "omni_recall_tpu").is_dir()
    # with the variable set, enabling sets nothing in code
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere")
    before = jax.config.jax_compilation_cache_dir
    compile_cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("d", [768, 100, 128])
def test_dd_tree_matches_numpy_mirror(d):
    """dd_sum_products' (hi, lo) equal the numpy float32 mirror bit for
    bit (the products are not contracted into the first fold)."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((16, d)).astype(np.float32)
    c = (rng.standard_normal((16, 8, d)) * rng.random((16, 8, 1)) * 3).astype(np.float32)
    hi, lo, _ = jax.jit(lambda a, b: exact_cos.dd_sum_products(a[:, None, :], b))(q, c)
    want_hi, want_lo = exact_cos.dd_sum_products_np(q[:, None, :], c)
    assert np.array_equal(np.asarray(hi).view(np.uint32), want_hi.view(np.uint32))
    assert np.array_equal(np.asarray(lo).view(np.uint32), want_lo.view(np.uint32))
