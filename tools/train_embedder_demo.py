"""Local embedder fine-tuning demo: train the transformer encoder
contrastively on synthetic (query, chunk) pairs and show retrieval accuracy
improving — the "train your own memory embedder" workflow end to end.

Run: PYTHONPATH=. python tools/train_embedder_demo.py
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from omni_recall_tpu.models import encoder


def make_dataset(rng, n_topics=64, per_topic=4):
    """Paraphrase-style pairs: queries and chunks share topic tokens."""
    topics = [
        [f"t{t}w{j}" for j in range(6)] for t in range(n_topics)
    ]
    queries, chunks, labels = [], [], []
    for t, words in enumerate(topics):
        for i in range(per_topic):
            q = " ".join(rng.permutation(words)[:3].tolist() + [f"q{i}"])
            c = " ".join(rng.permutation(words)[:5].tolist() + [f"detail{i}", "filler"])
            queries.append(q)
            chunks.append(c)
            labels.append(t)
    return queries, chunks, np.asarray(labels)


def retrieval_accuracy(params, cfg, queries, chunks, labels):
    q = encoder.forward(params, jnp.asarray(encoder.tokenize_batch(queries, cfg)), cfg)
    c = encoder.forward(params, jnp.asarray(encoder.tokenize_batch(chunks, cfg)), cfg)
    sims = np.asarray(q @ c.T)
    top1 = sims.argmax(axis=1)
    return float((labels[top1] == labels).mean())


def main() -> None:
    cfg = encoder.EncoderConfig(
        vocab_size=8192, d_model=128, n_layers=2, n_heads=4, d_ff=256,
        max_len=24, out_dim=128,
    )
    rng = np.random.default_rng(0)
    queries, chunks, labels = make_dataset(rng)
    params = encoder.init_params(jax.random.PRNGKey(0), cfg)

    acc0 = retrieval_accuracy(params, cfg, queries, chunks, labels)
    print(f"before training: top-1 same-topic retrieval accuracy = {acc0:.3f}", flush=True)

    import optax

    optimizer, train_step = encoder.make_train_step(cfg, optax.adamw(3e-4))
    opt_state = optimizer.init(params)
    step_fn = jax.jit(train_step)

    batch = 64
    order = np.arange(len(queries))
    t0 = time.perf_counter()
    for step in range(60):
        rng.shuffle(order)
        idx = order[:batch]
        q_ids = jnp.asarray(encoder.tokenize_batch([queries[i] for i in idx], cfg))
        c_ids = jnp.asarray(encoder.tokenize_batch([chunks[i] for i in idx], cfg))
        params, opt_state, loss = step_fn(params, opt_state, q_ids, c_ids)
        if step % 20 == 0:
            print(f"step {step:3d}: loss {float(loss):.4f}", flush=True)
    print(f"trained 60 steps in {time.perf_counter() - t0:.1f}s", flush=True)

    acc1 = retrieval_accuracy(params, cfg, queries, chunks, labels)
    print(f"after training:  top-1 same-topic retrieval accuracy = {acc1:.3f}", flush=True)
    assert acc1 > acc0, "training must improve retrieval"

    import sys
    if len(sys.argv) > 1 and sys.argv[1] == "--save":
        path = sys.argv[2] if len(sys.argv) > 2 else "/tmp/embedder.npz"
        encoder.save_params(path, params, cfg)
        print(f"saved checkpoint to {path} — serve it with "
              f"OMNI__Embeddings__Provider=Local "
              f"OMNI__Embeddings__Checkpoint={path}", flush=True)


if __name__ == "__main__":
    main()
