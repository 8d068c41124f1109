"""On-chip serving benchmark for the local chat decoder: prefill tokens/s
and KV-cache decode tokens/s at an LLM-scale config (params are seed-init;
throughput does not depend on training).

The whole generation (prefill + n_steps decode) is ONE device program
(models/decoder.py generate = prefill + lax.scan), so the per-dispatch
overhead is paid once per batch, not per token — the same megastep
discipline bench.py uses.

Usage: PYTHONPATH=. python tools/bench_decode.py
Knobs: OMNI_DECODE_{D,LAYERS,HEADS,FF,B,PROMPT,STEPS,WDTYPE}
  WDTYPE: float32 (default) | bfloat16 — resident weight dtype; decode is
  HBM-bound, so bf16 weights halve the per-step parameter stream.
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from omni_recall_tpu.models import decoder


def main() -> None:
    d = int(os.environ.get("OMNI_DECODE_D", 1024))
    n_layers = int(os.environ.get("OMNI_DECODE_LAYERS", 12))
    n_heads = int(os.environ.get("OMNI_DECODE_HEADS", 16))
    d_ff = int(os.environ.get("OMNI_DECODE_FF", 4096))
    b = int(os.environ.get("OMNI_DECODE_B", 32))
    prompt_len = int(os.environ.get("OMNI_DECODE_PROMPT", 448))
    steps = int(os.environ.get("OMNI_DECODE_STEPS", 128))

    max_len = int(os.environ.get("OMNI_DECODE_MAXLEN", prompt_len + steps))
    cfg = decoder.DecoderConfig(
        d_model=d, n_layers=n_layers, n_heads=n_heads, d_ff=d_ff,
        max_len=max(max_len, prompt_len + steps),
    )
    params = decoder.init_params(jax.random.PRNGKey(0), cfg)
    n_params = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
    print(f"model: d={d} L={n_layers} H={n_heads} ff={d_ff} "
          f"({n_params / 1e6:.0f}M params), B={b}, prompt={prompt_len}, "
          f"decode={steps}, backend={jax.default_backend()}", flush=True)
    wdtype = os.environ.get("OMNI_DECODE_WDTYPE", "float32")
    if wdtype != "float32":
        params = jax.tree.map(lambda p: p.astype(jnp.dtype(wdtype)), params)
        print(f"weights cast to {wdtype}", flush=True)
    ids = np.random.default_rng(0).integers(
        decoder._BYTE0, decoder._BYTE0 + 256, size=(b, prompt_len), dtype=np.int32
    )
    ids = jnp.asarray(ids)

    prefill_jit = jax.jit(lambda p, i: decoder.prefill(p, i, cfg)[0])
    t0 = time.perf_counter()
    _ = np.asarray(prefill_jit(params, ids)[:1, :1])
    print(f"prefill compile+first run: {time.perf_counter() - t0:.1f}s", flush=True)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = prefill_jit(params, ids)
    _ = np.asarray(out[:1, :1])
    dt = (time.perf_counter() - t0) / reps
    prefill_tps = b * prompt_len / dt
    print(f"prefill: {dt * 1000:.1f} ms/batch = {prefill_tps:,.0f} tokens/s",
          flush=True)

    key = jax.random.PRNGKey(1)
    t0 = time.perf_counter()
    toks = decoder.generate(params, ids, cfg, steps, key, temperature=0.0)
    _ = np.asarray(toks[:1, :1])
    print(f"generate compile+first run: {time.perf_counter() - t0:.1f}s", flush=True)
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        toks = decoder.generate(params, ids, cfg, steps, key, temperature=0.0)
    _ = np.asarray(toks[:1, :1])
    dt = (time.perf_counter() - t0) / reps
    gen_tps = b * steps / dt
    # subtract the (measured) prefill share to isolate decode steps/s
    decode_ms = dt * 1000 - (b * prompt_len / prefill_tps) * 1000
    print(f"generate (prefill + {steps} steps): {dt * 1000:.1f} ms/batch = "
          f"{gen_tps:,.0f} new tokens/s "
          f"(~{decode_ms / steps:.2f} ms/decode-step @ B={b})", flush=True)

    if cfg.max_len > prompt_len + steps:
        # blocked vs full cache reads (VERDICT r2 #9): generate defaults to
        # the attend window (round_up(prompt+steps, 128)); full_window=True
        # streams the whole max_len cache every step
        t0 = time.perf_counter()
        toks = decoder.generate(params, ids, cfg, steps, key, temperature=0.0,
                                full_window=True)
        _ = np.asarray(toks[:1, :1])
        print(f"full-window compile+first: {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        for _ in range(reps):
            toks = decoder.generate(params, ids, cfg, steps, key,
                                    temperature=0.0, full_window=True)
        _ = np.asarray(toks[:1, :1])
        dt_full = (time.perf_counter() - t0) / reps
        decode_full_ms = dt_full * 1000 - (b * prompt_len / prefill_tps) * 1000
        attend = min(cfg.max_len, -(-(prompt_len + steps) // 128) * 128)
        print(
            f"cache reads @ max_len={cfg.max_len}: blocked(attend={attend}) "
            f"{decode_ms / steps:.2f} ms/step vs full {decode_full_ms / steps:.2f} "
            f"ms/step ({decode_full_ms / max(decode_ms, 1e-9):.2f}x)",
            flush=True,
        )


if __name__ == "__main__":
    main()
