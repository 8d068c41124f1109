"""Local chat decoder training demo: train the causal transformer on
grounded-QA rows shaped EXACTLY like the serving path (the orchestration
layer's grounded prompt, tail-truncated and left-padded the same way
chat/local.py does), then answer through the real LocalDecoderChatClient —
the "train your own on-device chat model" workflow end to end.

Run: PYTHONPATH=. python tools/train_chat_demo.py [--save [path]]
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from omni_recall_tpu.chat.local import LocalDecoderChatClient
from omni_recall_tpu.chat.orchestration import build_grounded_prompt
from omni_recall_tpu.contracts import AiChatRequest, RecallCitation
from omni_recall_tpu.models import decoder

MAX_NEW = 48

PAIRS = [
    ("where does the index live?",
     "The index lives in device HBM as int8 slabs.",
     " In device HBM as int8 slabs. [1]"),
    ("what bounds the keyword term?",
     "The keyword term is bounded by the per-query bloom cap.",
     " The per-query bloom cap. [1]"),
    ("how is exactness kept?",
     "Exactness is kept by a runtime certificate check.",
     " A runtime certificate check. [1]"),
    ("what merges shard results?",
     "Shard results are merged by a stable co-sort on scores.",
     " A stable co-sort on scores. [1]"),
]


def grounded(question: str, snippet: str) -> str:
    citation = RecallCitation(
        document_id="doc_demo", file_name="notes.txt", chunk_id="doc_demo:0000",
        chunk_index=0, snippet=snippet, score=0.5,
        created_at_utc="2026-01-01T00:00:00Z",
    )
    return build_grounded_prompt(question, [citation])


def make_batch(cfg: decoder.DecoderConfig, client: LocalDecoderChatClient):
    """Rows laid out exactly as serving sees them: the grounded prompt
    tail-truncated + left-padded to the client's bucket, answer+EOS after,
    right-PAD to max_len (PAD targets are masked in the loss)."""
    rows = []
    bucket = None
    for question, snippet, answer in PAIRS:
        toks = decoder.encode_text(
            grounded(question, snippet), max_bytes=cfg.max_len - MAX_NEW - 1
        )
        b = client._bucket_for(len(toks))
        assert bucket in (None, b), "all demo prompts must share one bucket"
        bucket = b
        head = decoder.pad_left_batch([toks], b)[0]
        tail = [decoder._BYTE0 + c for c in answer.encode()] + [decoder.EOS]
        row = np.zeros(cfg.max_len, dtype=np.int32)
        row[:b] = head
        row[b:b + len(tail)] = tail
        rows.append(row)
    return jnp.asarray(np.stack(rows)), bucket


def main() -> None:
    cfg = decoder.DecoderConfig(
        d_model=128, n_layers=3, n_heads=4, d_ff=512, max_len=320
    )
    params = decoder.init_params(jax.random.PRNGKey(0), cfg)
    client = LocalDecoderChatClient(params=params, cfg=cfg, max_new_tokens=MAX_NEW)
    batch, bucket = make_batch(cfg, client)
    print(f"training at serve bucket {bucket} (max_len {cfg.max_len})", flush=True)

    optimizer, train_step = decoder.make_train_step(cfg)
    opt_state = optimizer.init(params)
    step_fn = jax.jit(train_step)

    t0 = time.perf_counter()
    loss0 = None
    for step in range(400):
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if loss0 is None:
            loss0 = float(loss)
        if step % 100 == 0:
            print(f"step {step:3d}: loss {float(loss):.4f}", flush=True)
    print(f"trained 400 steps in {time.perf_counter() - t0:.1f}s "
          f"(loss {loss0:.3f} -> {float(loss):.3f})", flush=True)
    assert float(loss) < loss0 * 0.2, "training must reduce loss 5x+"

    # answer through the REAL provider (same truncation/bucket/decode path
    # the server uses)
    client.params = params
    hits = 0
    for question, snippet, answer in PAIRS:
        resp = client.complete(AiChatRequest(grounded(question, snippet)))
        ok = resp.text.strip().startswith(answer.strip()[:20])
        hits += ok
        print(f"{'OK ' if ok else 'MISS'} {question!r} -> {resp.text[:50]!r}",
              flush=True)
    print(f"recovered {hits}/{len(PAIRS)} grounded answers via the provider",
          flush=True)
    assert hits >= len(PAIRS) - 1, "provider decode must recover trained answers"

    if len(sys.argv) > 1 and sys.argv[1] == "--save":
        path = sys.argv[2] if len(sys.argv) > 2 else "/tmp/chat_decoder.npz"
        decoder.save_params(path, params, cfg)
        print(f"saved checkpoint to {path} — serve it with "
              f"OMNI__Ai__Provider=Local "
              f"OMNI__Ai__LocalCheckpoint={path}", flush=True)


if __name__ == "__main__":
    main()
