"""omni_recall_tpu — a device-accelerated hybrid recall (RAG) framework.

Re-implements the full capability surface of the Omni Recall reference
application (ASP.NET Core + Angular) as a framework whose search runs on
an accelerator:

- the per-chunk hybrid scoring loop (0.7 cosine + 0.2 keyword + 0.1 recency,
  reference: src/OmniRecall.Api/Services/RecallSearchService.cs:59-119) becomes
  a device-resident structure-of-arrays index queried by a fused int8
  kernel with certified-exact top-k,
- ingestion (chunking, SHA-256 dedupe, batched embedding) becomes a vectorized
  pipeline appending into the device index,
- multi-chip scaling shards the chunk axis over a `jax.sharding.Mesh` with
  per-shard top-k and an all-gather merge,
- the HTTP API, chat orchestration, provider routing/failover, health probes
  and eval harness are behavior-compatible host-side components.
"""

__version__ = "0.1.0"

from omni_recall_tpu.stopwords import STOP_WORDS  # noqa: F401
