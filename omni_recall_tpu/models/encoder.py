"""Local trainable text embedder: a compact pure-JAX transformer encoder.

The reference has no local model — every embedding/LLM call is remote HTTPS
(SURVEY.md §2.3). This module is the framework's local model family: a
hashed-vocabulary transformer encoder producing L2-normalized text embeddings
compatible with the device index, plus a contrastive (InfoNCE) training step
so users can fine-tune their own memory embedder on the device.

Design:
- all matmuls carry ``preferred_element_type=float32`` and run in bf16 via a
  configurable compute dtype,
- parameters carry ``jax.sharding.PartitionSpec``s for tensor parallelism
  (attention heads / FFN hidden on the 'model' axis, vocabulary rows on the
  'model' axis) while the batch shards over 'data' — the standard dp x tp
  mesh recipe; pipeline/expert parallelism are deliberately out of scope at
  this model size (SURVEY.md §2.3),
- static shapes everywhere; tokenization pads/truncates to ``max_len``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from omni_recall_tpu.ops.hashing import fnv1a


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 1024
    max_len: int = 128
    out_dim: int = 768
    compute_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def tokenize(text: str, cfg: EncoderConfig) -> np.ndarray:
    """Hash words to token ids in [1, vocab); 0 is padding."""
    ids = [
        1 + fnv1a(w.encode("utf-8", errors="surrogatepass"), seed=11) % (cfg.vocab_size - 1)
        for w in text.lower().split()[: cfg.max_len]
    ]
    out = np.zeros(cfg.max_len, dtype=np.int32)
    out[: len(ids)] = ids
    return out


def tokenize_batch(texts: list[str], cfg: EncoderConfig) -> np.ndarray:
    return np.stack([tokenize(t, cfg) for t in texts])


def init_params(key: jax.Array, cfg: EncoderConfig) -> dict:
    keys = iter(jax.random.split(key, 4 + 8 * cfg.n_layers))

    def dense(k, shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return (jax.random.normal(k, shape, dtype=jnp.float32) * scale)

    params: dict = {
        "tok_embed": dense(next(keys), (cfg.vocab_size, cfg.d_model), scale=0.02),
        "pos_embed": dense(next(keys), (cfg.max_len, cfg.d_model), scale=0.02),
        "out_proj": dense(next(keys), (cfg.d_model, cfg.out_dim)),
        "final_ln": {"scale": jnp.ones(cfg.d_model), "bias": jnp.zeros(cfg.d_model)},
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append(
            {
                "ln1": {"scale": jnp.ones(cfg.d_model), "bias": jnp.zeros(cfg.d_model)},
                "ln2": {"scale": jnp.ones(cfg.d_model), "bias": jnp.zeros(cfg.d_model)},
                "wq": dense(next(keys), (cfg.d_model, cfg.d_model)),
                "wk": dense(next(keys), (cfg.d_model, cfg.d_model)),
                "wv": dense(next(keys), (cfg.d_model, cfg.d_model)),
                "wo": dense(next(keys), (cfg.d_model, cfg.d_model)),
                "w1": dense(next(keys), (cfg.d_model, cfg.d_ff)),
                "b1": jnp.zeros(cfg.d_ff),
                "w2": dense(next(keys), (cfg.d_ff, cfg.d_model)),
                "b2": jnp.zeros(cfg.d_model),
            }
        )
    return params


def param_specs(cfg: EncoderConfig) -> dict:
    """PartitionSpecs over a ('data', 'model') mesh: TP on heads/FFN/vocab."""
    layer = {
        "ln1": {"scale": P(), "bias": P()},
        "ln2": {"scale": P(), "bias": P()},
        "wq": P(None, "model"),
        "wk": P(None, "model"),
        "wv": P(None, "model"),
        "wo": P("model", None),
        "w1": P(None, "model"),
        "b1": P("model"),
        "w2": P("model", None),
        "b2": P(),
    }
    return {
        "tok_embed": P("model", None),
        "pos_embed": P(),
        "out_proj": P(None, "model"),
        "final_ln": {"scale": P(), "bias": P()},
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }


def _layer_norm(x, scale, bias, eps=1e-6):
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * scale + bias


def _attention(x, layer, mask, cfg: EncoderConfig):
    b, l, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim

    def heads(w):
        return jnp.einsum("bld,dk->blk", x, w, preferred_element_type=jnp.float32).reshape(b, l, h, hd)

    q, k, v = heads(layer["wq"]), heads(layer["wk"]), heads(layer["wv"])
    logits = jnp.einsum("blhe,bmhe->bhlm", q, k, preferred_element_type=jnp.float32)
    logits = logits / np.sqrt(hd)
    logits = jnp.where(mask[:, None, None, :], logits, -1e30)
    weights = jax.nn.softmax(logits, axis=-1).astype(x.dtype)
    out = jnp.einsum("bhlm,bmhe->blhe", weights, v, preferred_element_type=jnp.float32)
    return jnp.einsum(
        "blk,kd->bld", out.reshape(b, l, h * hd).astype(x.dtype), layer["wo"],
        preferred_element_type=jnp.float32,
    )


def forward(params: dict, token_ids: jax.Array, cfg: EncoderConfig) -> jax.Array:
    """token_ids i32[B, L] -> L2-normalized embeddings f32[B, out_dim]."""
    dtype = jnp.dtype(cfg.compute_dtype)
    mask = token_ids > 0  # [B, L]
    x = params["tok_embed"][token_ids] + params["pos_embed"][None, : token_ids.shape[1]]
    x = x.astype(dtype)
    for layer in params["layers"]:
        layer = jax.tree.map(lambda p: p.astype(dtype), layer)
        h = _layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
        x = x + _attention(h, layer, mask, cfg).astype(dtype)
        h = _layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
        ff = jnp.einsum("bld,df->blf", h, layer["w1"], preferred_element_type=jnp.float32)
        ff = jax.nn.gelu(ff + layer["b1"]).astype(dtype)
        ff = jnp.einsum("blf,fd->bld", ff, layer["w2"], preferred_element_type=jnp.float32)
        x = x + (ff + layer["b2"]).astype(dtype)
    x = _layer_norm(
        x.astype(jnp.float32), params["final_ln"]["scale"], params["final_ln"]["bias"]
    )
    denom = jnp.maximum(jnp.sum(mask, axis=1, keepdims=True), 1)
    pooled = jnp.sum(x * mask[:, :, None], axis=1) / denom  # mean over real tokens
    z = pooled @ params["out_proj"]
    return z / jnp.maximum(jnp.linalg.norm(z, axis=-1, keepdims=True), 1e-6)


def info_nce_loss(params: dict, query_ids: jax.Array, chunk_ids: jax.Array, cfg: EncoderConfig, temperature: float = 0.05):
    """Symmetric in-batch-negatives contrastive loss."""
    zq = forward(params, query_ids, cfg)
    zc = forward(params, chunk_ids, cfg)
    logits = (zq @ zc.T) / temperature
    labels = jnp.arange(logits.shape[0])
    loss_qc = jnp.mean(-jax.nn.log_softmax(logits, axis=1)[labels, labels])
    loss_cq = jnp.mean(-jax.nn.log_softmax(logits, axis=0)[labels, labels])
    return 0.5 * (loss_qc + loss_cq)


@partial(jax.jit, static_argnames=("cfg", "lr"))
def sgd_train_step(params, query_ids, chunk_ids, cfg: EncoderConfig, lr: float = 1e-3):
    loss, grads = jax.value_and_grad(info_nce_loss)(params, query_ids, chunk_ids, cfg)
    params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    return params, loss


def make_train_step(cfg: EncoderConfig, optimizer=None):
    """Optax training step factory (adamw by default)."""
    import optax

    optimizer = optimizer or optax.adamw(1e-3)

    def train_step(params, opt_state, query_ids, chunk_ids):
        loss, grads = jax.value_and_grad(info_nce_loss)(params, query_ids, chunk_ids, cfg)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return optimizer, train_step


# -- checkpointing ----------------------------------------------------------

def save_params(path: str, params: dict, cfg: EncoderConfig) -> None:
    """Persist params + config as a single .npz (flattened pytree paths).

    Deliberately dependency-light (numpy only): the encoder is small enough
    that a full-copy save is cheap; sharded/async checkpointing (orbax) is
    unnecessary at this size."""
    import json

    flat: dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    flat["__config__"] = np.frombuffer(
        json.dumps(cfg.__dict__).encode("utf-8"), dtype=np.uint8
    )
    # write through a file object: np.savez(str_path) appends '.npz' when
    # missing, so saving to '/tmp/ckpt' would create '/tmp/ckpt.npz' while
    # load_params('/tmp/ckpt') fails — the exact path must round-trip
    with open(path, "wb") as fh:
        np.savez(fh, **flat)


def load_checkpoint(path: str, cfg_cls):
    """Inverse of save_params for any config dataclass sharing the .npz
    scheme (EncoderConfig, decoder.DecoderConfig)."""
    import json

    with np.load(path) as data:
        cfg = cfg_cls(
            **json.loads(bytes(data["__config__"].tobytes()).decode("utf-8"))
        )
        params: dict = {"layers": [{} for _ in range(cfg.n_layers)]}
        for key in data.files:
            if key == "__config__":
                continue
            arr = jnp.asarray(data[key])
            parts = key.split(".")
            node = params
            for part in parts[:-1]:
                if part.isdigit():
                    node = node[int(part)]
                else:
                    node = node.setdefault(part, {})
            node[parts[-1]] = arr
    return params, cfg


def load_params(path: str) -> tuple[dict, EncoderConfig]:
    return load_checkpoint(path, EncoderConfig)
