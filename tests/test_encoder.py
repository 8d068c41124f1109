"""Local transformer embedder tests: shapes, determinism, masking, training
step convergence, and dp x tp sharded training on the virtual mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from omni_recall_tpu.models import encoder

CFG = encoder.EncoderConfig(
    vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
    max_len=16, out_dim=32,
)


@pytest.fixture(scope="module")
def params():
    return encoder.init_params(jax.random.PRNGKey(0), CFG)


def test_forward_shape_and_normalization(params):
    ids = jnp.asarray(encoder.tokenize_batch(["hello world", "gpu kernels go brr"], CFG))
    z = encoder.forward(params, ids, CFG)
    assert z.shape == (2, CFG.out_dim)
    norms = np.linalg.norm(np.asarray(z), axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


def test_forward_deterministic_and_padding_invariant(params):
    ids1 = jnp.asarray(encoder.tokenize_batch(["same text"], CFG))
    ids2 = jnp.asarray(encoder.tokenize_batch(["same text"], CFG))
    z1 = encoder.forward(params, ids1, CFG)
    z2 = encoder.forward(params, ids2, CFG)
    np.testing.assert_array_equal(np.asarray(z1), np.asarray(z2))


def test_tokenize_hashes_and_pads():
    ids = encoder.tokenize("alpha beta", CFG)
    assert ids.shape == (CFG.max_len,)
    assert (ids[:2] > 0).all() and (ids[2:] == 0).all()
    long = encoder.tokenize("w " * 100, CFG)
    assert (long > 0).all()


def test_train_step_reduces_loss(params):
    queries = [f"question about topic {i}" for i in range(8)]
    chunks = [f"document content topic {i}" for i in range(8)]
    q_ids = jnp.asarray(encoder.tokenize_batch(queries, CFG))
    c_ids = jnp.asarray(encoder.tokenize_batch(chunks, CFG))
    p = params
    first = None
    for step in range(12):
        p, loss = encoder.sgd_train_step(p, q_ids, c_ids, CFG, lr=0.05)
        if first is None:
            first = float(loss)
    assert float(loss) < first


def test_sharded_train_step_dp_tp():
    devices = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devices, axis_names=("data", "model"))
    params = encoder.init_params(jax.random.PRNGKey(1), CFG)
    specs = encoder.param_specs(CFG)
    params = jax.tree.map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params, specs
    )
    q_ids = jax.device_put(
        encoder.tokenize_batch([f"q {i}" for i in range(8)], CFG),
        NamedSharding(mesh, P("data", None)),
    )
    c_ids = jax.device_put(
        encoder.tokenize_batch([f"c {i}" for i in range(8)], CFG),
        NamedSharding(mesh, P("data", None)),
    )
    new_params, loss = encoder.sgd_train_step(params, q_ids, c_ids, CFG)
    assert np.isfinite(float(loss))
    # TP params keep their sharding through the update
    w1 = new_params["layers"][0]["w1"]
    assert not w1.sharding.is_fully_replicated


def test_optax_train_step():
    _, train_step = encoder.make_train_step(CFG)
    import optax

    optimizer = optax.adamw(1e-3)
    optimizer, train_step = encoder.make_train_step(CFG, optimizer)
    params = encoder.init_params(jax.random.PRNGKey(2), CFG)
    opt_state = optimizer.init(params)
    q_ids = jnp.asarray(encoder.tokenize_batch(["a b c"] * 4, CFG))
    c_ids = jnp.asarray(encoder.tokenize_batch(["x y z"] * 4, CFG))
    params, opt_state, loss = jax.jit(train_step)(params, opt_state, q_ids, c_ids)
    assert np.isfinite(float(loss))
