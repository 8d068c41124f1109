"""Local causal decoder (models/decoder.py) + the Local chat provider
(chat/local.py): KV-cache/full-forward equivalence, causality, training,
checkpoint round-trip, and the IAiChatClient contract."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from omni_recall_tpu.chat.local import LocalDecoderChatClient
from omni_recall_tpu.contracts import AiChatRequest
from omni_recall_tpu.models import decoder

TINY = decoder.DecoderConfig(
    d_model=64, n_layers=2, n_heads=2, d_ff=128, max_len=96,
    compute_dtype="float32",
)


@pytest.fixture(scope="module")
def tiny_params():
    return decoder.init_params(jax.random.PRNGKey(0), TINY)


def test_tokenizer_round_trip():
    text = "Hello, GPU wörld! é中"
    toks = decoder.encode_text(text)
    assert toks[0] == decoder.BOS
    assert decoder.decode_tokens(toks) == text


def test_pad_left_batch_alignment():
    out = decoder.pad_left_batch([[1, 5, 6], [1, 7]], 6)
    assert out.shape == (2, 6)
    assert list(out[0]) == [0, 0, 0, 1, 5, 6]
    assert list(out[1]) == [0, 0, 0, 0, 1, 7]
    # rows longer than the buffer keep their tail (recency)
    out = decoder.pad_left_batch([[1, 2, 3, 4, 5]], 3)
    assert list(out[0]) == [3, 4, 5]


def test_forward_is_causal(tiny_params):
    ids = decoder.pad_left_batch([decoder.encode_text("abcdef")], 16)
    logits_a = decoder.forward(tiny_params, jnp.asarray(ids), TINY)
    ids2 = ids.copy()
    ids2[0, -1] = decoder._BYTE0 + ord("z")  # mutate the LAST token
    logits_b = decoder.forward(tiny_params, jnp.asarray(ids2), TINY)
    # all REAL positions before the mutated one are unchanged (left-PAD
    # query rows are undefined by design: all-masked softmax; the loss
    # masks them and prefill reads only the last position)
    real = ids[0] != decoder.PAD
    real[-1] = False
    np.testing.assert_allclose(
        np.asarray(logits_a[0])[real], np.asarray(logits_b[0])[real], rtol=1e-6
    )
    assert not np.allclose(np.asarray(logits_a[0, -1]), np.asarray(logits_b[0, -1]))


def test_kv_cache_decode_matches_full_forward(tiny_params):
    """Greedy generation through prefill+cached decode_step must equal a
    greedy rollout that re-runs the full teacher-forcing forward each step."""
    prompts = ["hello world", "gpu"]
    lp, steps = 32, 8
    ids = decoder.pad_left_batch([decoder.encode_text(p) for p in prompts], lp)

    fast = np.asarray(
        decoder.generate(
            tiny_params, jnp.asarray(ids), TINY, steps, jax.random.PRNGKey(0),
            temperature=0.0,
        )
    )

    seq = ids.copy()
    slow = []
    done = np.zeros(len(prompts), dtype=bool)
    emit_ok = np.zeros(TINY.vocab_size, dtype=bool)
    emit_ok[decoder.EOS] = True
    emit_ok[decoder._BYTE0:decoder._BYTE0 + 256] = True
    for _ in range(steps):
        logits = np.asarray(decoder.forward(tiny_params, jnp.asarray(seq), TINY))
        last = np.where(emit_ok[None, :], logits[:, -1], -1e30)
        tok = last.argmax(-1).astype(np.int32)
        tok = np.where(done, decoder.PAD, tok)
        done = done | (tok == decoder.EOS)
        slow.append(tok)
        seq = np.concatenate([seq, tok[:, None]], axis=1)
    slow = np.stack(slow, axis=1)
    # note offset: generate() samples from the pre-step logits, so fast[:, i]
    # is the token APPENDED at step i — same as slow[:, i]
    np.testing.assert_array_equal(fast, slow)


def test_generate_pads_after_eos(tiny_params):
    """Force EOS as the argmax everywhere: output must be EOS then PADs."""
    params = jax.tree.map(lambda x: x, tiny_params)
    head = np.zeros_like(np.asarray(params["lm_head"]))
    head[:, decoder.EOS] = 1.0
    # final-LN bias of 1 makes sum(x_final) ~= d_model > 0, so the EOS
    # column (sum of x) strictly beats every zero column
    params = {**params, "lm_head": jnp.asarray(head),
              "final_ln": {"scale": jnp.ones(TINY.d_model),
                           "bias": jnp.ones(TINY.d_model)}}
    ids = decoder.pad_left_batch([decoder.encode_text("x")], 16)
    out = np.asarray(
        decoder.generate(params, jnp.asarray(ids), TINY, 5,
                         jax.random.PRNGKey(0), temperature=0.0)
    )
    assert out[0, 0] == decoder.EOS
    assert (out[0, 1:] == decoder.PAD).all()


def test_training_reduces_loss_and_memorizes():
    cfg = TINY
    text = "the index lives in hbm. "
    ids = decoder.pad_left_batch([decoder.encode_text(text * 3)], cfg.max_len)
    ids = jnp.asarray(ids)
    params = decoder.init_params(jax.random.PRNGKey(1), cfg)
    optimizer, train_step = decoder.make_train_step(cfg)
    train_step = jax.jit(train_step)
    opt_state = optimizer.init(params)
    losses = []
    for _ in range(60):
        params, opt_state, loss = train_step(params, opt_state, ids)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses[::20]


def test_checkpoint_round_trip(tiny_params, tmp_path):
    path = str(tmp_path / "dec.npz")
    decoder.save_params(path, tiny_params, TINY)
    params2, cfg2 = decoder.load_params(path)
    assert cfg2 == TINY
    ids = jnp.asarray(decoder.pad_left_batch([decoder.encode_text("abc")], 16))
    a = decoder.generate(tiny_params, ids, TINY, 4, jax.random.PRNGKey(0))
    b = decoder.generate(params2, ids, cfg2, 4, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_param_specs_match_param_tree(tiny_params):
    specs = decoder.param_specs(TINY)
    jax.tree.map(lambda p, s: None, tiny_params, specs)  # same structure


def test_sharded_generation_dp_tp_matches_unsharded(tiny_params):
    """Greedy generation with params sharded over a 4x2 ('data','model')
    mesh (TP on heads/FFN/vocab, DP on the batch) must produce the same
    tokens as the unsharded run — XLA inserts the collectives."""
    from jax.sharding import Mesh, NamedSharding

    ids = decoder.pad_left_batch(
        [decoder.encode_text(f"prompt number {i}") for i in range(8)], 32
    )
    ref = np.asarray(decoder.generate(
        tiny_params, jnp.asarray(ids), TINY, 6, jax.random.PRNGKey(0),
        temperature=0.0,
    ))

    devices = np.array(jax.devices()[:8]).reshape(4, 2)
    mesh = Mesh(devices, axis_names=("data", "model"))
    specs = decoder.param_specs(TINY)
    sharded_params = jax.tree.map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
        tiny_params, specs,
    )
    ids_sharded = jax.device_put(
        jnp.asarray(ids),
        NamedSharding(mesh, jax.sharding.PartitionSpec("data", None)),
    )
    out = np.asarray(decoder.generate(
        sharded_params, ids_sharded, TINY, 6, jax.random.PRNGKey(0),
        temperature=0.0,
    ))
    np.testing.assert_array_equal(out, ref)


# -- provider contract ------------------------------------------------------

def test_local_client_returns_response(tiny_params):
    client = LocalDecoderChatClient(params=tiny_params, cfg=TINY, max_new_tokens=8)
    resp = client.complete(AiChatRequest("say something"))
    assert resp.provider == "local"
    assert resp.model == "local-decoder"
    assert isinstance(resp.text, str) and resp.text


def test_local_client_deterministic(tiny_params):
    client = LocalDecoderChatClient(params=tiny_params, cfg=TINY, max_new_tokens=8)
    a = client.complete(AiChatRequest("same prompt"))
    b = client.complete(AiChatRequest("same prompt"))
    assert a.text == b.text


def test_local_client_empty_output_raises(tiny_params):
    """A head that always emits EOS yields empty text -> provider raises
    (router treats it as non-transient -> recall-only fallback)."""
    head = np.zeros_like(np.asarray(tiny_params["lm_head"]))
    head[:, decoder.EOS] = 1.0
    params = {**tiny_params, "lm_head": jnp.asarray(head),
              "final_ln": {"scale": jnp.ones(TINY.d_model),
                           "bias": jnp.ones(TINY.d_model)}}
    client = LocalDecoderChatClient(params=params, cfg=TINY, max_new_tokens=4)
    with pytest.raises(RuntimeError, match="empty answer"):
        client.complete(AiChatRequest("anything"))


def test_local_client_warmup(tiny_params):
    client = LocalDecoderChatClient(params=tiny_params, cfg=TINY, max_new_tokens=8)
    t = client.warmup_async()
    t.join(timeout=120)
    assert not t.is_alive()
    # warm cache: a maximal-length prompt now completes without recompiling
    long_prompt = "y" * (TINY.max_len - client.max_new_tokens - 1)
    resp = client.complete(AiChatRequest(long_prompt))
    assert resp.provider == "local"


def test_local_client_checkpoint_load(tiny_params, tmp_path):
    path = str(tmp_path / "dec.npz")
    decoder.save_params(path, tiny_params, TINY)
    client = LocalDecoderChatClient(checkpoint=path, max_new_tokens=8)
    assert client.cfg == TINY
    assert path in client.model


def test_router_falls_back_when_local_fails(tiny_params):
    from omni_recall_tpu.chat.router import AiChatRouter
    from omni_recall_tpu.config import AiRoutingOptions
    from omni_recall_tpu.contracts import AiChatResponse

    head = np.zeros_like(np.asarray(tiny_params["lm_head"]))
    head[:, decoder.EOS] = 1.0
    params = {**tiny_params, "lm_head": jnp.asarray(head),
              "final_ln": {"scale": jnp.ones(TINY.d_model),
                           "bias": jnp.ones(TINY.d_model)}}
    local = LocalDecoderChatClient(params=params, cfg=TINY, max_new_tokens=4)

    class FakeFallback:
        provider_name = "fake"

        def complete(self, request):
            return AiChatResponse("fallback answer", "fake-model", "fake")

    router = AiChatRouter(local, FakeFallback(), AiRoutingOptions(
        max_attempts_per_provider=1, retry_base_delay_ms=0
    ), sleep=lambda s: None)
    resp = router.complete(AiChatRequest("hi"))
    assert resp.provider == "fake"


def test_health_local_mode_skips_remote_ai_probes():
    """With Ai:Provider=Local, missing remote API keys must not degrade
    health — chat is served on-device (the remote chain is only fallback)."""
    from omni_recall_tpu.config import load_config
    from omni_recall_tpu.server.app import OmniRecallApp

    cfg = load_config(settings_file=None, env={}, overrides={
        "Ai:Provider": "Local",
        "Ai:LocalMaxNewTokens": "4",
        "Ai:LocalWarmup": "false",
        "Embeddings:Provider": "Hash",
        "Engine:Backend": "oracle",
    })
    app = OmniRecallApp(cfg)
    health = app.health_service.probe()
    names = {d.name: d.status for d in health.dependencies}
    assert names.get("ai-local") == "healthy"
    assert "ai-gemini" not in names
    assert health.status == "healthy"


def test_health_local_mode_keeps_gemini_probe_for_embeddings():
    """Gemini stays a probed (degraded-when-unconfigured) dependency when it
    serves the embeddings path, even with on-device chat."""
    from omni_recall_tpu.config import load_config
    from omni_recall_tpu.server.app import OmniRecallApp

    cfg = load_config(settings_file=None, env={}, overrides={
        "Ai:Provider": "Local",
        "Ai:LocalMaxNewTokens": "4",
        "Ai:LocalWarmup": "false",
        "Embeddings:Provider": "Gemini",
        "Engine:Backend": "oracle",
    })
    app = OmniRecallApp(cfg)
    health = app.health_service.probe()
    names = {d.name: d.status for d in health.dependencies}
    assert names.get("ai-local") == "healthy"
    assert names.get("ai-gemini") == "degraded"  # key not configured
    assert health.status == "degraded"


def test_local_mode_fallback_chain_keeps_github_models(tiny_params):
    """Local primary failing must still reach GitHub Models (nested remote
    router), not just Gemini."""
    from omni_recall_tpu.chat.router import AiChatRouter
    from omni_recall_tpu.config import AiRoutingOptions
    from omni_recall_tpu.contracts import AiChatResponse

    head = np.zeros_like(np.asarray(tiny_params["lm_head"]))
    head[:, decoder.EOS] = 1.0
    params = {**tiny_params, "lm_head": jnp.asarray(head),
              "final_ln": {"scale": jnp.ones(TINY.d_model),
                           "bias": jnp.ones(TINY.d_model)}}
    local = LocalDecoderChatClient(params=params, cfg=TINY, max_new_tokens=4)

    class FailingGemini:
        provider_name = "gemini"

        def complete(self, request):
            raise ValueError("Gemini API key is not configured.")

    class WorkingGitHub:
        provider_name = "github-models"

        def complete(self, request):
            return AiChatResponse("github answer", "gh-model", "github-models")

    opts = AiRoutingOptions(max_attempts_per_provider=1, retry_base_delay_ms=0)
    remote = AiChatRouter(FailingGemini(), WorkingGitHub(), opts, sleep=lambda s: None)
    router = AiChatRouter(local, remote, opts, sleep=lambda s: None)
    resp = router.complete(AiChatRequest("hi"))
    assert resp.provider == "github-models"
    assert resp.text == "github answer"


def test_coarse_layout_adapts_sub_to_corpus_size():
    """The scan layout must keep >= m candidates at every corpus size: the
    slice is the kernel's row tile (halved until it divides the rows) and
    the depth grows as the slice count shrinks."""
    from omni_recall_tpu.search.engine import _scan_layout

    # 1M rows: t floored at 4 — per-slice top-1 loses co-located cluster
    # rows and collapses certificate resolution
    assert _scan_layout(1 << 20, 128) == (128, 4)
    # 256k rows: the budget still covers >= 4m
    sub, t = _scan_layout(1 << 18, 128)
    assert ((1 << 18) // sub) * t >= 4 * 128
    # 8k rows: depth grows to keep the prepass available
    sub, t = _scan_layout(8192, 128)
    assert (8192 // sub) * t >= 128 and t > 4
    # a row count no tile divides has no layout
    assert _scan_layout(100, 8) is None
    # a row count the full tile does not divide takes a narrower slice
    assert _scan_layout(64 * 3, 8)[0] == 64


def test_encode_text_max_bytes_zero():
    assert decoder.encode_text("hello", max_bytes=0) == [decoder.BOS]
    assert decoder.encode_text("hello", max_bytes=3)[1:] == [
        decoder._BYTE0 + b for b in b"llo"
    ]


def test_app_wires_local_provider(tmp_path):
    from omni_recall_tpu.config import load_config
    from omni_recall_tpu.server.app import OmniRecallApp

    cfg = load_config(overrides={
        "Ai:Provider": "Local",
        "Ai:LocalMaxNewTokens": "4",
        "Ai:LocalWarmup": "false",
        "Embeddings:Provider": "Hash",
        "Engine:Backend": "oracle",
    })
    app = OmniRecallApp(cfg)
    assert app.chat_router._primary.provider_name == "local"


def test_concurrent_chat_requests_batch_and_match_serial(tiny_params):
    """The request queue coalesces concurrent prompts into batched
    generations; greedy answers must be identical to serial calls."""
    import threading

    client = LocalDecoderChatClient(params=tiny_params, cfg=TINY, max_new_tokens=8)
    prompts = [f"prompt number {i}" for i in range(5)]
    serial = {p: client.complete(AiChatRequest(p)).text for p in prompts}

    results: dict[str, str] = {}
    errors: list[Exception] = []

    def worker(p):
        try:
            results[p] = client.complete(AiChatRequest(p)).text
        except Exception as exc:  # pragma: no cover - failure reporting
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(p,)) for p in prompts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors
    assert results == serial


def test_generate_attend_window_matches_full_window(tiny_params):
    """Position-blocked cache reads (attend_len) must not change outputs:
    a short generation in a small prefix of the position window produces
    the same tokens whether attention streams the whole cache or only the
    attend window (decode_step attend_len=None vs the generate default)."""
    import jax

    prompt = decoder.pad_left_batch(
        [decoder.encode_text("check the window")], 16
    )
    out_gated = decoder.generate(
        tiny_params, jnp.asarray(prompt), TINY, 8, jax.random.PRNGKey(0)
    )
    # full-window reference: step decode_step manually with attend_len=None
    logits, cache = decoder.prefill(tiny_params, jnp.asarray(prompt), TINY)
    kv = jnp.concatenate(
        [jnp.asarray(prompt) != decoder.PAD,
         jnp.ones((1, TINY.max_len - 16), dtype=bool)], axis=1,
    )
    toks = []
    done = False
    for step in range(8):
        emit = np.full((TINY.vocab_size,), -1e30, dtype=np.float32)
        emit[decoder.EOS] = 0.0
        emit[decoder._BYTE0 : decoder._BYTE0 + 256] = 0.0
        tok = int(np.argmax(np.asarray(logits)[0] + emit))
        if done:
            tok = decoder.PAD
        done = done or tok == decoder.EOS
        toks.append(tok)
        kv = kv & ~(
            (jnp.arange(TINY.max_len) == 16 + step)[None, :]
            & jnp.asarray([tok == decoder.PAD])[:, None]
        )
        logits, cache = decoder.decode_step(
            tiny_params, cache, jnp.asarray([tok], dtype=jnp.int32),
            16 + step, TINY, kv,
        )
    assert np.asarray(out_gated)[0].tolist() == toks
