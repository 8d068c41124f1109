"""Checks that need the card: the compiled Triton scan against the XLA scan,
and the double-float dot against its numpy mirror, as the GPU compiles
them. Run on the card with ``pytest -m chip -p no:xdist tests/`` (the
first phase of chip_smoke.py); they skip anywhere else."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omni_recall_tpu.ops import exact_cos, routes, scan, triton_scan

pytestmark = pytest.mark.chip


def test_gpu_route_is_the_compiled_kernel(gpu):
    route = routes.current()
    assert route.platform == "gpu"
    assert route.scan is triton_scan.scan_triton


@pytest.mark.parametrize("terms", scan.TERM_SETS)
def test_compiled_kernel_matches_xla_scan(gpu, terms):
    """Bounds within 1e-6 (f32 epilogue rounding and FMA), rows identical
    except among bounds tied within that tolerance."""
    n, d, bits, b = 1 << 16, 768, 2048, 200
    k = jax.random.split(jax.random.PRNGKey(0), 6)
    emb8 = jax.random.randint(k[0], (n, d), -127, 128).astype(jnp.int8)
    e = emb8.astype(jnp.float32)
    scale = 1.0 / jnp.sqrt(jnp.sum(e * e, axis=1))
    bloom = (jax.random.randint(k[1], (n, bits // 8), 0, 256)
             & jax.random.randint(k[2], (n, bits // 8), 0, 256)).astype(jnp.uint8)
    q = jax.random.normal(k[3], (b, d))
    q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
    kw = (jax.random.uniform(k[4], (b, bits)) < 0.004).astype(jnp.float32) * 0.125
    ops = scan.scan_operands(
        terms, emb8, bloom, scale, jnp.full((n,), 1e-6),
        jax.random.uniform(k[5], (n,), maxval=365.0), jnp.ones((n,), bool),
        q, kw, jnp.zeros((b,)), jnp.float32(365.0), jnp.int32(0),
    )
    want_v, want_i = (np.asarray(x) for x in scan.scan_xla(*ops, terms=terms, sub=128, t=4))
    got_v, got_i = (np.asarray(x) for x in triton_scan.scan_triton(*ops, terms=terms, sub=128, t=4))
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6)
    for s, qb, r in zip(*np.nonzero(got_i != want_i)):
        tied = np.nonzero(want_i[s, qb] == got_i[s, qb, r])[0]
        assert tied.size and abs(want_v[s, qb, tied[0]] - got_v[s, qb, r]) <= 1e-6


@pytest.mark.parametrize("d", [768, 128, 100])
def test_dd_bit_parity_on_card(gpu, d):
    """The card's double-float dot equals the numpy float32 mirror bit for
    bit: no product contracted into an FMA, no flushed subnormal."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((512, d)).astype(np.float32)
    c = (rng.standard_normal((512, 32, d)) * np.float32(0.03)).astype(np.float32)
    c[0, 0, :8] = np.float32(1e-38)  # subnormal products
    hi, lo, _ = exact_cos.exact_cos_rows(
        jnp.asarray(c.reshape(-1, d)),
        jnp.asarray(np.arange(512 * 32, dtype=np.int32).reshape(512, 32)),
        jnp.asarray(q),
    )
    want_hi, want_lo = exact_cos.dd_sum_products_np(q[:, None, :], c)
    assert np.array_equal(np.asarray(hi).view(np.uint32), want_hi.view(np.uint32))
    assert np.array_equal(np.asarray(lo).view(np.uint32), want_lo.view(np.uint32))
