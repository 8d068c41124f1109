"""Inverse-cloze self-supervised fine-tuning of the local encoder.

The objective: a random 3-8 word span of a chunk (plus filler-word
augmentation) must retrieve its own chunk against in-batch negatives —
entirely self-supervised, no labeled queries. This is what turns the
untrained local encoder (recall@10 ~0.65 on the real-corpus campaign) into
the best measured provider (~0.96), and it is the engine behind the
``POST /api/documents/train`` admin route (the on-device upgrade of the
reference's reindex re-embed + swap semantics,
DocumentIngestionService.cs:220-291: there the vectors come back from a
remote API; here the provider itself is trained on the ingested corpus and
then every chunk is re-embedded through the normal reindex path).

Shared by eval/real_corpus.py (the quality campaign) and
ingest/service.py train_embedder (the serving path) so the campaign
measures exactly what the route ships.
"""

from __future__ import annotations

import random


def inverse_cloze_finetune(
    contents: list[str],
    cfg,
    steps: int = 300,
    seed: int = 0,
    batch: int = 64,
    params=None,
):
    """Fine-tune (or train from seed init when ``params`` is None) the
    models/encoder.py transformer on ``contents`` with the inverse-cloze
    contrastive objective. Returns the trained params pytree."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from omni_recall_tpu.models import encoder

    if not contents:
        raise ValueError("inverse_cloze_finetune requires a non-empty corpus")
    rng = random.Random(seed)

    def _rand_word() -> str:
        import string as _s

        return "".join(rng.choices(_s.ascii_lowercase, k=rng.randint(3, 9)))

    def make_pair(content: str) -> tuple[str, str]:
        words = content.split()
        span = rng.randint(3, 8)
        if len(words) > span:
            s0 = rng.randint(0, len(words) - span)
            q_words = words[s0 : s0 + span]
        else:
            q_words = list(words)
        for _ in range(rng.randint(0, 2)):
            q_words.insert(rng.randint(0, len(q_words)), _rand_word())
        return " ".join(q_words), content

    if params is None:
        params = encoder.init_params(jax.random.PRNGKey(seed), cfg)
    optimizer, train_step = encoder.make_train_step(cfg, optax.adamw(3e-4))
    opt_state = optimizer.init(params)
    step_fn = jax.jit(train_step)
    nrng = np.random.default_rng(seed)
    batch = min(batch, max(2, len(contents)))
    for _ in range(steps):
        idx = nrng.integers(0, len(contents), size=batch)
        pairs = [make_pair(contents[i]) for i in idx]
        q_ids = jnp.asarray(encoder.tokenize_batch([p[0] for p in pairs], cfg))
        c_ids = jnp.asarray(encoder.tokenize_batch([p[1] for p in pairs], cfg))
        params, opt_state, _ = step_fn(params, opt_state, q_ids, c_ids)
    return params
