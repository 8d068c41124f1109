"""Local on-device chat provider: models/decoder.py behind the IAiChatClient
contract (complete(AiChatRequest) -> AiChatResponse, IAiChatClient.cs:5-9).

NEW vs the reference, whose chat providers are all remote HTTPS
(GeminiChatClient.cs / GitHubModelsChatClient.cs). With
Embeddings:Provider=Local this makes the whole stack self-contained on the
device: no API key, no network. Selected with Ai:Provider=Local; quality is
whatever the configured checkpoint was trained to do (Ai:LocalCheckpoint,
models/decoder.py save_params format, e.g. from tools/train_chat_demo.py) —
the seed-0 default is an UNTRAINED model and is only useful for smoke tests
and as a template for fine-tuning.

Serving mechanics (the device-relevant part):
- prompts are left-padded into power-of-two length buckets, so jit compiles
  once per bucket and every later call reuses the compiled executables,
- the default scheduler is CONTINUOUS BATCHING (chat/serving.py): requests
  join/leave a persistent S-slot decode loop at chunk boundaries, so a
  request arriving mid-generation waits ~one chunk (default 16 tokens), not
  a whole generation, and EOS frees a slot early.
  Ai:LocalScheduler=coalesce keeps the leader/follower whole-generation
  batcher (_run_batch below),
- generation is deterministic greedy by default (temperature 0) so answers
  are reproducible; sampling is opt-in via Ai:LocalTemperature and stays
  reproducible PER REQUEST under both schedulers.
"""

from __future__ import annotations

import logging
import threading

from omni_recall_tpu.contracts import AiChatRequest, AiChatResponse

logger = logging.getLogger(__name__)

_PROMPT_BUCKETS = (128, 256, 512)


class LocalDecoderChatClient:
    provider_name = "local"

    def __init__(
        self,
        checkpoint: str = "",
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        seed: int = 0,
        cfg=None,
        params=None,
        scheduler: str = "continuous",
        slots: int = 4,
        chunk_tokens: int = 16,
        prefill_chunk: int = 0,
        prefill_budget: int = 0,
    ) -> None:
        import jax

        from omni_recall_tpu.models import decoder

        self._dec = decoder
        self._jax = jax
        self._scheduler = (scheduler or "continuous").strip().lower()
        self._slots = max(1, int(slots))
        self._chunk_tokens = max(1, int(chunk_tokens))
        self._prefill_chunk = max(0, int(prefill_chunk))
        self._prefill_budget = max(0, int(prefill_budget))
        self._batcher = None  # chat/serving.py, created lazily
        # serializes ALL generations, not just compiles: the chip executes
        # one program at a time anyway, and holding the lock across the
        # whole call also prevents duplicate cold compiles of one bucket
        self._lock = threading.Lock()
        # request queue for concurrent prompts: whoever holds the gen lock
        # drains up to _MAX_BATCH waiting requests into ONE batched
        # prefill+decode (greedy mode) instead of serializing generations
        self._queue_lock = threading.Lock()
        self._queue: list[dict] = []
        if params is not None:
            self.params, self.cfg = params, cfg or decoder.DecoderConfig()
            self.model = "local-decoder"
        elif checkpoint:
            self.params, self.cfg = decoder.load_params(checkpoint)
            self.model = f"local-decoder:{checkpoint}"
        else:
            self.cfg = cfg or decoder.DecoderConfig()
            self.params = decoder.init_params(jax.random.PRNGKey(seed), self.cfg)
            self.model = "local-decoder"
        # cap generation at half the position window so the prompt always
        # keeps at least as much room as the answer (a checkpoint with a
        # small max_len otherwise ends up with a 0-byte prompt budget)
        self.max_new_tokens = max(1, min(max_new_tokens, self.cfg.max_len // 2))
        self.temperature = float(temperature)

    def _bucket_for(self, n_tokens: int) -> int:
        # the fallback is NOT capped at _PROMPT_BUCKETS[-1]: encode_text
        # already truncated to max_len - max_new - 1 bytes, and a smaller
        # fallback would silently re-truncate the grounded context
        return next(
            (b for b in _PROMPT_BUCKETS
             if b >= n_tokens and b + self.max_new_tokens <= self.cfg.max_len),
            self.cfg.max_len - self.max_new_tokens,
        )

    def warmup_async(self) -> threading.Thread:
        """Compile the serving executable in the background so the first
        user request doesn't pay it. Grounded prompts are almost always
        truncated to the maximum length, so warming the maximal bucket
        covers the common case (one compile per (bucket, steps) pair)."""
        def _warm():
            try:
                max_prompt = "x" * (self.cfg.max_len - self.max_new_tokens - 1)
                toks = self._dec.encode_text(
                    max_prompt,
                    max_bytes=self.cfg.max_len - self.max_new_tokens - 1,
                )
                if self._scheduler == "continuous":
                    # one full-budget generation through the batcher
                    # compiles prefill at the maximal bucket + insert_slot +
                    # every attend-bucket decode_chunk a max-length request
                    # walks; shallower buckets compile on demand
                    self._get_batcher().generate_sync(
                        toks, 0, self.max_new_tokens
                    )
                    return
                # compile WITHOUT the instance lock (generate is pure and
                # the jit cache is thread-safe): a first request for a
                # different bucket must not block behind this compile
                prompt = self._dec.pad_left_batch([toks], self._bucket_for(len(toks)))
                self._dec.generate(
                    self.params, prompt, self.cfg, self.max_new_tokens,
                    self._jax.random.PRNGKey(0), temperature=self.temperature,
                )
            except Exception as exc:  # compile/generation problems surface
                logger.warning("Local decoder warmup failed: %s", exc)

        t = threading.Thread(target=_warm, daemon=True, name="local-chat-warmup")
        t.start()
        return t

    _MAX_BATCH = 8  # power-of-two serving batches: 1, 2, 4, 8

    def _get_batcher(self):
        """Lazily build the continuous batcher (chat/serving.py). Double
        construction is prevented by the queue lock; the batcher owns its
        own scheduler thread and device state."""
        if self._batcher is None:
            with self._queue_lock:
                if self._batcher is None:
                    from omni_recall_tpu.chat.serving import ContinuousBatcher

                    self._batcher = ContinuousBatcher(
                        self._dec, self._jax, self.params, self.cfg,
                        slots=self._slots, chunk=self._chunk_tokens,
                        temperature=self.temperature,
                        prompt_buckets=_PROMPT_BUCKETS,
                        prefill_chunk=self._prefill_chunk,
                        prefill_budget=self._prefill_budget,
                    )
        return self._batcher

    def complete(self, request: AiChatRequest) -> AiChatResponse:
        # stable across processes (built-in hash() is salted per process,
        # which would make temperature>0 sampling non-reproducible)
        from omni_recall_tpu.ops.hashing import fnv1a

        toks = self._dec.encode_text(
            request.prompt, max_bytes=self.cfg.max_len - self.max_new_tokens - 1
        )
        if self._scheduler == "continuous":
            seed = fnv1a(
                request.prompt.encode("utf-8", "surrogatepass")
            ) % (1 << 31)
            out = self._get_batcher().generate_sync(
                toks, seed, self.max_new_tokens
            )
            text = self._dec.decode_tokens(out).strip()
            if not text:
                raise RuntimeError(
                    "Local decoder produced an empty answer "
                    "(untrained or out-of-domain checkpoint)."
                )
            return AiChatResponse(text, self.model, self.provider_name)
        entry = {
            "toks": toks,
            "seed": fnv1a(request.prompt.encode("utf-8", "surrogatepass")) % (1 << 31),
            "event": threading.Event(),
            "text": None, "err": None,
        }
        with self._queue_lock:
            self._queue.append(entry)
        # leader/follower: each thread that wins the gen lock drains the
        # queue (its own entry included) into one batched generation;
        # threads whose entry was already served just return. Concurrent
        # chat prompts therefore share a single prefill + decode scan —
        # one compiled executable per (batch, prompt-bucket) pair.
        while not entry["event"].is_set():
            with self._lock:
                if entry["event"].is_set():
                    break
                with self._queue_lock:
                    batch = self._queue[: self._MAX_BATCH]
                    del self._queue[: len(batch)]
                if batch:
                    self._run_batch(batch)
        if entry["err"] is not None:
            raise entry["err"]
        return AiChatResponse(entry["text"], self.model, self.provider_name)

    def _run_batch(self, batch: list[dict]) -> None:
        """Run one generation for up to _MAX_BATCH queued requests. Greedy
        decoding (temperature 0, the default) batches freely; with
        temperature > 0 each request keeps ITS OWN sampling key (the
        reproducible-sampling contract), so sampled requests run
        one-per-generation."""
        import numpy as np

        try:
            if self.temperature > 0 and len(batch) > 1:
                for e in batch:
                    self._run_batch([e])
                return
            # pad the request count to a power-of-two serving batch and the
            # prompts to the widest requested bucket
            nb = 1
            while nb < len(batch):
                nb *= 2
            bucket = max(self._bucket_for(len(e["toks"])) for e in batch)
            tok_lists = [e["toks"] for e in batch]
            tok_lists += [tok_lists[-1]] * (nb - len(batch))  # filler rows
            prompt = self._dec.pad_left_batch(tok_lists, bucket)
            key = self._jax.random.PRNGKey(batch[0]["seed"])
            out = self._dec.generate(
                self.params, prompt, self.cfg, self.max_new_tokens, key,
                temperature=self.temperature,
            )
            rows = np.asarray(out)
            for i, e in enumerate(batch):
                text = self._dec.decode_tokens(rows[i]).strip()
                if not text:
                    # contract: providers raise on empty output; the router
                    # treats it as a non-transient provider failure ->
                    # recall-only fallback (GeminiChatClient.cs:170-204)
                    e["err"] = RuntimeError(
                        "Local decoder produced an empty answer "
                        "(untrained or out-of-domain checkpoint)."
                    )
                else:
                    e["text"] = text
        except Exception as exc:  # surface per-request (router handles)
            for e in batch:
                if e["err"] is None and e["text"] is None:
                    e["err"] = exc
        finally:
            for e in batch:
                e["event"].set()
