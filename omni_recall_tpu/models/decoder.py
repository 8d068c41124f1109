"""Local generative chat model: a compact pure-JAX causal transformer.

The reference's chat path is remote-only (GeminiChatClient.cs /
GitHubModelsChatClient.cs over HTTPS). Together with the local encoder
(models/encoder.py as the embedding provider) this module completes the
fully self-contained on-device stack: ingestion, recall, AND answer generation all
run on the device with zero network dependency. Selected with
Ai:Provider=Local (chat/local.py wraps it in the IAiChatClient contract).

Serving design:
- **byte-level reversible vocabulary** (PAD/BOS/EOS + 256 bytes, padded to
  384 rows, a multiple of the matrix tile) — generation must detokenize,
  so the encoder's hashed vocabulary is not reusable here,
- **left-padded prompts**: every row of a batch ends at the same position,
  so the KV cache advances with ONE scalar position per step instead of
  per-row dynamic scatters (the standard serving layout),
- **prefill/decode split**: prefill runs the full prompt in one batched pass and writes the KV cache; decode is a `lax.scan` of
  single-token steps against the static-shape cache — no Python loop, no
  recompiles, one compilation per (batch, prompt_len, n_steps) bucket,
- matmuls carry ``preferred_element_type=float32`` with bf16 compute/cache,
- `param_specs` shards heads/FFN/vocab on 'model' and the batch on 'data'
  (same dp x tp recipe as the encoder).

Positional caveat: positions are absolute over the left-padded buffer, so a
prompt's token positions depend on its bucket width. Train with
`pad_left_batch` at the same bucket widths you serve (tools/train_chat_demo.py
does); the serving client picks the bucket deterministically from the prompt
length, so generation stays reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

PAD, BOS, EOS = 0, 1, 2
_BYTE0 = 3  # byte b encodes as _BYTE0 + b


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 384  # 259 used; padded to a lane-friendly width
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 1024
    max_len: int = 640  # prompt buffer + generated tokens
    compute_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# -- tokenization (reversible, byte-level) ----------------------------------

def encode_text(text: str, max_bytes: int | None = None) -> list[int]:
    data = text.encode("utf-8", errors="surrogatepass")
    if max_bytes is not None and len(data) > max_bytes:
        # keep the tail: recency matters for chat (and max_bytes=0 must
        # truncate to nothing — data[-0:] would keep everything)
        data = data[len(data) - max_bytes:]
    return [BOS] + [_BYTE0 + b for b in data]


def decode_tokens(tokens) -> str:
    data = bytes(
        int(t) - _BYTE0 for t in tokens if _BYTE0 <= int(t) < _BYTE0 + 256
    )
    return data.decode("utf-8", errors="replace")


def pad_left_batch(token_lists: list[list[int]], length: int) -> np.ndarray:
    """Left-pad to [B, length] so all rows end at position length-1."""
    out = np.zeros((len(token_lists), length), dtype=np.int32)
    for i, toks in enumerate(token_lists):
        toks = toks[-length:]
        out[i, length - len(toks):] = toks
    return out


# -- parameters -------------------------------------------------------------

def init_params(key: jax.Array, cfg: DecoderConfig) -> dict:
    keys = iter(jax.random.split(key, 3 + 8 * cfg.n_layers))

    def dense(k, shape, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return jax.random.normal(k, shape, dtype=jnp.float32) * scale

    params: dict = {
        "tok_embed": dense(next(keys), (cfg.vocab_size, cfg.d_model), scale=0.02),
        "pos_embed": dense(next(keys), (cfg.max_len, cfg.d_model), scale=0.02),
        "lm_head": dense(next(keys), (cfg.d_model, cfg.vocab_size)),
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


def param_specs(cfg: DecoderConfig) -> dict:
    """PartitionSpecs over a ('data', 'model') mesh (encoder.py recipe)."""
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
        "lm_head": P(None, "model"),
        "final_ln": {"scale": P(), "bias": P()},
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }


def _layer_norm(x, scale, bias, eps=1e-6):
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * scale + bias


# -- training forward (teacher forcing, causal mask) ------------------------

def forward(params: dict, token_ids: jax.Array, cfg: DecoderConfig) -> jax.Array:
    """token_ids i32[B, L] -> logits f32[B, L, vocab]. PAD positions attend
    to nothing and nothing attends to them."""
    dtype = jnp.dtype(cfg.compute_dtype)
    b, l = token_ids.shape
    valid = token_ids != PAD  # [B, L]
    x = params["tok_embed"][token_ids] + params["pos_embed"][None, :l]
    x = x.astype(dtype)
    causal = jnp.tril(jnp.ones((l, l), dtype=bool))
    mask = causal[None, :, :] & valid[:, None, :]  # [B, Lq, Lk]
    for layer in params["layers"]:
        layer = jax.tree.map(lambda p: p.astype(dtype), layer)
        h = _layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
        x = x + _attention_full(h, layer, mask, cfg).astype(dtype)
        h = _layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
        x = x + _ffn(h, layer).astype(dtype)
    x = _layer_norm(
        x.astype(jnp.float32), params["final_ln"]["scale"], params["final_ln"]["bias"]
    )
    return jnp.einsum(
        "bld,dv->blv", x, params["lm_head"], preferred_element_type=jnp.float32
    )


def _attention_full(x, layer, mask, cfg: DecoderConfig):
    b, l, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim

    def heads(w):
        return jnp.einsum(
            "bld,dk->blk", x, w, preferred_element_type=jnp.float32
        ).reshape(b, l, h, hd)

    q, k, v = heads(layer["wq"]), heads(layer["wk"]), heads(layer["wv"])
    logits = jnp.einsum("blhe,bmhe->bhlm", q, k, preferred_element_type=jnp.float32)
    logits = logits / np.sqrt(hd)
    logits = jnp.where(mask[:, None, :, :], logits, -1e30)
    weights = jax.nn.softmax(logits, axis=-1).astype(x.dtype)
    out = jnp.einsum("bhlm,bmhe->blhe", weights, v, preferred_element_type=jnp.float32)
    return jnp.einsum(
        "blk,kd->bld", out.reshape(b, l, h * hd).astype(x.dtype), layer["wo"],
        preferred_element_type=jnp.float32,
    )


def _ffn(h, layer):
    ff = jnp.einsum("bld,df->blf", h, layer["w1"], preferred_element_type=jnp.float32)
    ff = jax.nn.gelu(ff + layer["b1"]).astype(h.dtype)
    ff = jnp.einsum("blf,fd->bld", ff, layer["w2"], preferred_element_type=jnp.float32)
    return ff + layer["b2"]


# -- serving: prefill + KV-cache decode -------------------------------------

def init_cache(cfg: DecoderConfig, batch: int) -> list[dict]:
    dtype = jnp.dtype(cfg.compute_dtype)
    return [
        {
            "k": jnp.zeros((batch, cfg.max_len, cfg.n_heads, cfg.head_dim), dtype),
            "v": jnp.zeros((batch, cfg.max_len, cfg.n_heads, cfg.head_dim), dtype),
        }
        for _ in range(cfg.n_layers)
    ]


def prefill(params: dict, token_ids: jax.Array, cfg: DecoderConfig):
    """Left-padded prompt i32[B, Lp] -> (last-position logits f32[B, vocab],
    cache filled for positions [0, Lp))."""
    dtype = jnp.dtype(cfg.compute_dtype)
    b, lp = token_ids.shape
    valid = token_ids != PAD
    x = params["tok_embed"][token_ids] + params["pos_embed"][None, :lp]
    x = x.astype(dtype)
    causal = jnp.tril(jnp.ones((lp, lp), dtype=bool))
    mask = causal[None, :, :] & valid[:, None, :]
    cache = init_cache(cfg, b)
    for li, layer in enumerate(params["layers"]):
        layer = jax.tree.map(lambda p: p.astype(dtype), layer)
        h = _layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
        hh, hd = cfg.n_heads, cfg.head_dim

        def heads(w, src=h):
            return jnp.einsum(
                "bld,dk->blk", src, w, preferred_element_type=jnp.float32
            ).reshape(b, lp, hh, hd)

        q, k, v = heads(layer["wq"]), heads(layer["wk"]), heads(layer["wv"])
        cache[li]["k"] = jax.lax.dynamic_update_slice(
            cache[li]["k"], k.astype(dtype), (0, 0, 0, 0)
        )
        cache[li]["v"] = jax.lax.dynamic_update_slice(
            cache[li]["v"], v.astype(dtype), (0, 0, 0, 0)
        )
        logits = jnp.einsum("blhe,bmhe->bhlm", q, k, preferred_element_type=jnp.float32)
        logits = logits / np.sqrt(hd)
        logits = jnp.where(mask[:, None, :, :], logits, -1e30)
        weights = jax.nn.softmax(logits, axis=-1).astype(dtype)
        out = jnp.einsum("bhlm,bmhe->blhe", weights, v, preferred_element_type=jnp.float32)
        att = jnp.einsum(
            "blk,kd->bld", out.reshape(b, lp, hh * hd).astype(dtype), layer["wo"],
            preferred_element_type=jnp.float32,
        )
        x = x + att.astype(dtype)
        h = _layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
        x = x + _ffn(h, layer).astype(dtype)
    x_last = _layer_norm(
        x[:, -1].astype(jnp.float32),
        params["final_ln"]["scale"], params["final_ln"]["bias"],
    )
    logits_last = x_last @ params["lm_head"]
    return logits_last, cache


@partial(jax.jit, donate_argnums=(1,), static_argnames=("cfg", "start"))
def prefill_block(params: dict, cache: list[dict], block: jax.Array,
                  first_real: jax.Array, cfg: DecoderConfig, start: int):
    """One CHUNKED-PREFILL block: run prompt positions [start, start+T) of a
    left-padded prompt batch against the cache prefix, writing this block's
    k/v into the cache. ``first_real`` i32[B] is each row's first non-PAD
    position (left padding ⇒ a prefix of PADs), which masks attention to
    padded cache cells exactly as prefill()'s valid mask does.

    Chaining blocks start=0, T, 2T, … over a fresh init_cache reproduces
    prefill() up to cache-dtype rounding: PREVIOUS blocks' keys/values are
    read back from the compute-dtype (bf16) cache — the same numerics
    decode_step uses for every generated token — whereas the whole-prompt
    prefill keeps them in f32 registers. Not bit-identical to prefill();
    "decode-grade" for the cross-block terms. Executables are shaped by
    (start, T) and are BUCKET-INDEPENDENT (the cache is [B, max_len, ...]),
    so every prompt bucket shares the same block executables.

    Purpose: iteration-level scheduling (chat/serving.py) — a long prompt's
    admission no longer stalls in-flight decode slots for the whole prefill;
    the scheduler interleaves one block per loop iteration with decode
    chunks. Returns (last-position logits f32[B, vocab], cache)."""
    dtype = jnp.dtype(cfg.compute_dtype)
    b, t = block.shape
    al = start + t
    h_, hd = cfg.n_heads, cfg.head_dim
    x = params["tok_embed"][block] + params["pos_embed"][None, start:al]
    x = x.astype(dtype)
    jpos = jnp.arange(al)[None, None, :]                  # [1, 1, al]
    qpos = (start + jnp.arange(t))[None, :, None]         # [1, T, 1]
    mask = (jpos <= qpos) & (jpos >= first_real[:, None, None])  # [B, T, al]
    for li, layer in enumerate(params["layers"]):
        layer = jax.tree.map(lambda p: p.astype(dtype), layer)
        h = _layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])

        def proj(w, src=h):
            return jnp.einsum(
                "btd,dk->btk", src, w, preferred_element_type=jnp.float32
            ).reshape(b, t, h_, hd)

        q = proj(layer["wq"])
        k = proj(layer["wk"]).astype(dtype)
        v = proj(layer["wv"]).astype(dtype)
        ck = jax.lax.dynamic_update_slice(cache[li]["k"], k, (0, start, 0, 0))
        cv = jax.lax.dynamic_update_slice(cache[li]["v"], v, (0, start, 0, 0))
        cache[li] = {"k": ck, "v": cv}
        # static prefix read: only [0, al) streams (same bound decode uses)
        logits = jnp.einsum("bthe,bmhe->bhtm", q.astype(dtype), ck[:, :al],
                            preferred_element_type=jnp.float32)
        logits = logits / np.sqrt(hd)
        logits = jnp.where(mask[:, None, :, :], logits, -1e30)
        weights = jax.nn.softmax(logits, axis=-1).astype(dtype)
        out = jnp.einsum("bhtm,bmhe->bthe", weights, cv[:, :al],
                         preferred_element_type=jnp.float32)
        att = jnp.einsum(
            "btk,kd->btd", out.reshape(b, t, h_ * hd).astype(dtype),
            layer["wo"], preferred_element_type=jnp.float32,
        )
        x = x + att.astype(dtype)
        h = _layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
        x = x + _ffn(h, layer).astype(dtype)
    x_last = _layer_norm(
        x[:, -1].astype(jnp.float32),
        params["final_ln"]["scale"], params["final_ln"]["bias"],
    )
    return x_last @ params["lm_head"], cache


def prefill_chunked(params: dict, token_ids, cfg: DecoderConfig, chunk: int):
    """prefill() via prefill_block chunks (host loop; test/oracle helper —
    the serving scheduler drives prefill_block itself to interleave decode
    chunks between blocks). Returns (last-position logits, cache)."""
    b, lp = token_ids.shape
    valid = token_ids != PAD
    # all-PAD rows get first_real = lp (nothing attendable), not argmax's 0
    first_real = jnp.where(
        valid.any(axis=1), jnp.argmax(valid, axis=1), lp
    ).astype(jnp.int32)
    cache = init_cache(cfg, b)
    logits = None
    for start in range(0, lp, chunk):
        t = min(chunk, lp - start)
        logits, cache = prefill_block(
            params, cache, jnp.asarray(token_ids[:, start:start + t]),
            first_real, cfg, start,
        )
    return logits, cache


def decode_step(params: dict, cache: list[dict], token: jax.Array,
                pos: jax.Array, cfg: DecoderConfig,
                key_valid: jax.Array | None = None,
                attend_len: int | None = None):
    """One token i32[B] at scalar position `pos` -> (logits f32[B, vocab],
    updated cache). Attention reads the static-shape cache masked to
    positions <= pos (scan-compatible; no dynamic shapes). `key_valid`
    bool[B, max_len] marks cache positions that hold real tokens —
    left-PAD prompt positions MUST be excluded or their (non-zero) cached
    k/v corrupt the attention.

    ``attend_len`` (static) bounds the cache READ window: generate() knows
    prompt_len + n_steps at trace time, so attention only streams the
    first attend_len cache positions instead of all max_len — decode is
    KV-cache-stream-bound (docs/STATUS_R2.md roofline), so a generation
    filling 1/4 of the position window reads ~1/4 the bytes. Positions
    >= attend_len are provably never written within the call."""
    dtype = jnp.dtype(cfg.compute_dtype)
    b = token.shape[0]
    h_, hd = cfg.n_heads, cfg.head_dim
    al = cfg.max_len if attend_len is None else min(attend_len, cfg.max_len)
    x = params["tok_embed"][token] + params["pos_embed"][pos]
    x = x.astype(dtype)  # [B, d]
    pos_mask = (jnp.arange(al) <= pos)[None, :]  # [1, al]
    if key_valid is not None:
        pos_mask = pos_mask & key_valid[:, :al]
    for li, layer in enumerate(params["layers"]):
        layer = jax.tree.map(lambda p: p.astype(dtype), layer)
        h = _layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])
        def proj(w, src=h):
            return jnp.einsum("bd,dk->bk", src, w,
                              preferred_element_type=jnp.float32)

        q = proj(layer["wq"]).reshape(b, h_, hd)
        k = proj(layer["wk"]).reshape(b, 1, h_, hd).astype(dtype)
        v = proj(layer["wv"]).reshape(b, 1, h_, hd).astype(dtype)
        ck = jax.lax.dynamic_update_slice(cache[li]["k"], k, (0, pos, 0, 0))
        cv = jax.lax.dynamic_update_slice(cache[li]["v"], v, (0, pos, 0, 0))
        cache[li] = {"k": ck, "v": cv}
        # static prefix slice: only the attend window streams from HBM
        logits = jnp.einsum("bhe,bmhe->bhm", q.astype(dtype), ck[:, :al],
                            preferred_element_type=jnp.float32)
        logits = logits / np.sqrt(hd)
        logits = jnp.where(pos_mask[:, None, :], logits, -1e30)
        weights = jax.nn.softmax(logits, axis=-1).astype(dtype)
        out = jnp.einsum("bhm,bmhe->bhe", weights, cv[:, :al],
                         preferred_element_type=jnp.float32)
        att = jnp.einsum("bk,kd->bd", out.reshape(b, h_ * hd).astype(dtype),
                         layer["wo"], preferred_element_type=jnp.float32)
        x = x + att.astype(dtype)
        h = _layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
        ff = jnp.einsum("bd,df->bf", h, layer["w1"],
                        preferred_element_type=jnp.float32)
        ff = jax.nn.gelu(ff + layer["b1"]).astype(dtype)
        ff = jnp.einsum("bf,fd->bd", ff, layer["w2"],
                        preferred_element_type=jnp.float32)
        x = x + (ff + layer["b2"]).astype(dtype)
    x = _layer_norm(
        x.astype(jnp.float32), params["final_ln"]["scale"], params["final_ln"]["bias"]
    )
    return x @ params["lm_head"], cache


@partial(jax.jit, static_argnames=("cfg", "n_steps", "temperature", "full_window"))
def generate(params: dict, prompt_ids: jax.Array, cfg: DecoderConfig,
             n_steps: int, key: jax.Array, temperature: float = 0.0,
             full_window: bool = False):
    """Left-padded prompts i32[B, Lp] -> generated tokens i32[B, n_steps].

    Greedy when temperature <= 0, else categorical sampling. Generation
    continues to n_steps (static shape); tokens after a row's EOS are
    forced to PAD so the host-side detokenizer needs no length handling."""
    b, lp = prompt_ids.shape
    if lp + n_steps > cfg.max_len:
        # fail loudly: out of range, dynamic_update_slice would silently
        # clamp into the last cache slot and corrupt generation (in-repo
        # callers guard via _bucket_for, but the API must not fail silently)
        raise ValueError(
            f"prompt length {lp} + n_steps {n_steps} exceeds "
            f"cfg.max_len {cfg.max_len}"
        )
    logits0, cache = prefill(params, prompt_ids, cfg)
    # cache-key validity: left-PAD prompt positions never become attendable;
    # generated positions are real tokens (post-EOS PADs are masked per-row)
    key_valid = jnp.concatenate(
        [prompt_ids != PAD,
         jnp.ones((b, cfg.max_len - lp), dtype=bool)], axis=1,
    )

    # only bytes and EOS are emittable: PAD/BOS and the padded vocab tail
    # (ids >= 259) are structural, never generated
    emit_ok = jnp.zeros((cfg.vocab_size,), dtype=bool)
    emit_ok = emit_ok.at[EOS].set(True).at[_BYTE0:_BYTE0 + 256].set(True)

    def sample(logits, k):
        logits = jnp.where(emit_ok[None, :], logits, -1e30)
        if temperature <= 0.0:
            return jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return jax.random.categorical(k, logits / temperature, axis=-1).astype(jnp.int32)

    # attention window: the cache can only ever hold lp + n_steps live
    # positions in this call — a static read bound (rounded up to a lane
    # multiple) cuts the per-step cache stream proportionally; decode is
    # cache-stream-bound (docs/STATUS_R2.md roofline). full_window=True
    # restores the whole-cache read (tools/bench_decode.py comparison).
    attend = (
        cfg.max_len if full_window
        else min(cfg.max_len, -(-(lp + n_steps) // 128) * 128)
    )

    def body(carry, step):
        cache, logits, done, kv, k = carry
        k, sub = jax.random.split(k)
        tok = sample(logits, sub)
        tok = jnp.where(done, PAD, tok)
        done = done | (tok == EOS)
        kv = kv & ~((jnp.arange(cfg.max_len) == lp + step)[None, :] & (tok == PAD)[:, None])
        logits, cache = decode_step(
            params, cache, tok, lp + step, cfg, kv, attend_len=attend
        )
        return (cache, logits, done, kv, k), tok

    done0 = jnp.zeros((b,), dtype=bool)
    (_, _, _, _, _), toks = jax.lax.scan(
        body, (cache, logits0, done0, key_valid, key), jnp.arange(n_steps)
    )
    return toks.T  # [B, n_steps]


# -- serving: per-slot continuous decode (chat/serving.py) ------------------

def decode_step_multi(params: dict, cache: list[dict], token: jax.Array,
                      pos: jax.Array, cfg: DecoderConfig,
                      key_valid: jax.Array, attend_len: int):
    """decode_step with a PER-SLOT position vector ``pos`` i32[S] instead of
    one shared scalar: each slot (row) writes its k/v at its own cache
    position and attends to its own prefix. The per-row cache write is a
    batched scatter — O(S) rows of a few hundred bytes, negligible next to
    the cache stream — which is exactly what the shared-position layout
    avoids for uniform batches; continuous batching needs the general form
    because slots join and leave at different depths.

    Math per row is identical to decode_step's (attention is row-local), so
    a slot's output stream does not depend on what the other slots are
    doing — the isolation property chat/serving.py's tests pin down."""
    dtype = jnp.dtype(cfg.compute_dtype)
    s = token.shape[0]
    h_, hd = cfg.n_heads, cfg.head_dim
    al = min(attend_len, cfg.max_len)
    rows = jnp.arange(s)
    x = params["tok_embed"][token] + params["pos_embed"][pos]
    x = x.astype(dtype)  # [S, d]
    pos_mask = (jnp.arange(al)[None, :] <= pos[:, None]) & key_valid[:, :al]
    for li, layer in enumerate(params["layers"]):
        layer = jax.tree.map(lambda p: p.astype(dtype), layer)
        h = _layer_norm(x, layer["ln1"]["scale"], layer["ln1"]["bias"])

        def proj(w, src=h):
            return jnp.einsum("sd,dk->sk", src, w,
                              preferred_element_type=jnp.float32)

        q = proj(layer["wq"]).reshape(s, h_, hd)
        k = proj(layer["wk"]).reshape(s, h_, hd).astype(dtype)
        v = proj(layer["wv"]).reshape(s, h_, hd).astype(dtype)
        ck = cache[li]["k"].at[rows, pos].set(k)
        cv = cache[li]["v"].at[rows, pos].set(v)
        cache[li] = {"k": ck, "v": cv}
        logits = jnp.einsum("she,smhe->shm", q.astype(dtype), ck[:, :al],
                            preferred_element_type=jnp.float32)
        logits = logits / np.sqrt(hd)
        logits = jnp.where(pos_mask[:, None, :], logits, -1e30)
        weights = jax.nn.softmax(logits, axis=-1).astype(dtype)
        out = jnp.einsum("shm,smhe->she", weights, cv[:, :al],
                         preferred_element_type=jnp.float32)
        att = jnp.einsum("sk,kd->sd", out.reshape(s, h_ * hd).astype(dtype),
                         layer["wo"], preferred_element_type=jnp.float32)
        x = x + att.astype(dtype)
        h = _layer_norm(x, layer["ln2"]["scale"], layer["ln2"]["bias"])
        ff = jnp.einsum("sd,df->sf", h, layer["w1"],
                        preferred_element_type=jnp.float32)
        ff = jax.nn.gelu(ff + layer["b1"]).astype(dtype)
        ff = jnp.einsum("sf,fd->sd", ff, layer["w2"],
                        preferred_element_type=jnp.float32)
        x = x + (ff + layer["b2"]).astype(dtype)
    x = _layer_norm(
        x.astype(jnp.float32), params["final_ln"]["scale"], params["final_ln"]["bias"]
    )
    return x @ params["lm_head"], cache


@partial(jax.jit, donate_argnums=(1, 2, 3, 4, 5, 6),
         static_argnames=("cfg", "n_steps", "temperature", "attend_len"))
def decode_chunk(params: dict, cache: list[dict], logits: jax.Array,
                 pos: jax.Array, done: jax.Array, key_valid: jax.Array,
                 keys: jax.Array, cfg: DecoderConfig, n_steps: int,
                 temperature: float, attend_len: int):
    """``n_steps`` continuous-batching decode steps over S independent
    slots (the chat/serving.py scheduler's inner loop).

    State per slot: ``logits`` f32[S, vocab] (the next-token distribution),
    ``pos`` i32[S] (next cache position to write), ``done`` bool[S],
    ``key_valid`` bool[S, max_len], ``keys`` u32[S, 2] per-slot sampling
    keys (per-REQUEST reproducibility: a slot's stream depends only on its
    own seed and step index, never on batch composition). Emits tokens
    i32[S, n_steps]; rows of finished/empty slots emit PAD. State arrays
    are donated — the scheduler threads them through chunk after chunk."""
    emit_ok = jnp.zeros((cfg.vocab_size,), dtype=bool)
    emit_ok = emit_ok.at[EOS].set(True).at[_BYTE0:_BYTE0 + 256].set(True)
    s = pos.shape[0]
    rows = jnp.arange(s)

    def sample(lg, ks):
        lg = jnp.where(emit_ok[None, :], lg, -1e30)
        if temperature <= 0.0:
            return jnp.argmax(lg, axis=-1).astype(jnp.int32)
        smp = jax.vmap(
            lambda k_, l_: jax.random.categorical(k_, l_ / temperature)
        )(ks, lg)
        return smp.astype(jnp.int32)

    def body(carry, _):
        cache, logits, pos, done, kv, keys = carry
        # overflow guard: a slot whose position window is exhausted freezes
        # (the scheduler enforces the budget; this keeps the device state
        # well-formed even if it retires a slot late)
        done = done | (pos >= cfg.max_len)
        wp = jnp.minimum(pos, cfg.max_len - 1)
        keys, subs = jnp.split(
            jax.vmap(lambda k_: jax.random.split(k_, 2))(keys), 2, axis=1
        )
        keys, subs = keys[:, 0], subs[:, 0]
        tok = sample(logits, subs)
        tok = jnp.where(done, PAD, tok)
        done = done | (tok == EOS)
        # a PAD write never becomes attendable
        kv = kv.at[rows, wp].set(tok != PAD)
        logits, cache = decode_step_multi(
            params, cache, tok, wp, cfg, kv, attend_len=attend_len
        )
        # done slots stop consuming positions (their PAD writes land on the
        # frozen cell with key_valid False; the next insert resets the row)
        pos = jnp.where(done, pos, pos + 1)
        return (cache, logits, pos, done, kv, keys), tok

    (cache, logits, pos, done, kv, keys), toks = jax.lax.scan(
        body, (cache, logits, pos, done, key_valid, keys),
        xs=None, length=n_steps,
    )
    return cache, logits, pos, done, kv, keys, toks.T  # toks [S, n_steps]


@partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4, 5), static_argnames=("cfg",))
def insert_slot(cache: list[dict], key_valid: jax.Array, logits: jax.Array,
                pos: jax.Array, done: jax.Array, keys: jax.Array,
                prefill_cache: list[dict], prefill_logits: jax.Array,
                prompt_ids: jax.Array, seed_key: jax.Array,
                slot: jax.Array, cfg: DecoderConfig):
    """Install a freshly prefilled request (batch-1 prefill cache, its
    last-position logits, its left-padded prompt and sampling key) into
    slot ``slot`` of the serving state, in one dispatch. Serving-state
    arrays are donated and threaded. One executable per prompt bucket."""
    lp = prompt_ids.shape[1]
    for li in range(cfg.n_layers):
        for kv in ("k", "v"):
            cache[li][kv] = jax.lax.dynamic_update_slice(
                cache[li][kv], prefill_cache[li][kv], (slot, 0, 0, 0)
            )
    row_valid = jnp.concatenate(
        [prompt_ids[0] != PAD,
         jnp.zeros((cfg.max_len - lp,), dtype=bool)]
    )
    key_valid = jax.lax.dynamic_update_slice(
        key_valid, row_valid[None, :], (slot, 0)
    )
    logits = jax.lax.dynamic_update_slice(
        logits, prefill_logits.astype(logits.dtype), (slot, jnp.int32(0))
    )
    pos = jax.lax.dynamic_update_slice(
        pos, jnp.full((1,), lp, dtype=pos.dtype), (slot,)
    )
    done = jax.lax.dynamic_update_slice(
        done, jnp.zeros((1,), dtype=bool), (slot,)
    )
    keys = jax.lax.dynamic_update_slice(
        keys, seed_key[None, :].astype(keys.dtype), (slot, jnp.int32(0))
    )
    return cache, key_valid, logits, pos, done, keys


# -- training ---------------------------------------------------------------

def lm_loss(params: dict, token_ids: jax.Array, cfg: DecoderConfig) -> jax.Array:
    """Next-token cross-entropy over non-PAD targets."""
    logits = forward(params, token_ids[:, :-1], cfg)
    targets = token_ids[:, 1:]
    # exclude positions whose INPUT is PAD too: a left-padded row's last
    # PAD position targets BOS, but its fully-masked attention softmax
    # degenerates to uniform over ALL keys (including future answer
    # tokens) — training that term backpropagates acausal leakage
    mask = (targets != PAD) & (token_ids[:, :-1] != PAD)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[:, :, None], axis=-1)[:, :, 0]
    return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1)


def make_train_step(cfg: DecoderConfig, optimizer=None):
    import optax

    optimizer = optimizer or optax.adamw(3e-4)

    def train_step(params, opt_state, token_ids):
        loss, grads = jax.value_and_grad(lm_loss)(params, token_ids, cfg)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return optimizer, train_step


# -- checkpointing (same .npz scheme as the encoder) ------------------------

def save_params(path: str, params: dict, cfg: DecoderConfig) -> None:
    from omni_recall_tpu.models import encoder

    encoder.save_params(path, params, cfg)  # format is config-class-agnostic


def load_params(path: str) -> tuple[dict, DecoderConfig]:
    from omni_recall_tpu.models import encoder

    return encoder.load_checkpoint(path, DecoderConfig)
