"""Layered configuration.

Mirrors the reference's ASP.NET configuration model: typed option classes
bound from a layered key/value view (src/OmniRecall.Api/Program.cs:32-34),
with defaults from code (AiRoutingOptions.cs:5-7, IngestionOptions.cs:5-8,
ChatQualityOptions.cs:5-13), then an optional ``appsettings.json``-style file,
then environment variables with ``__`` separators
(e.g. ``OMNI__Ingestion__ChunkSizeWords=200`` — reference README.md:77 uses
bare ``Section__Key``; we namespace with an ``OMNI__`` prefix to avoid
collisions).

Reference gotchas preserved: the code default for
``EnableRecallOnlyFallbackOnProviderFailure`` is False while appsettings ships
True; parallelism code default 3 vs appsettings 2. Our code defaults mirror
the reference *code* defaults; a shipped ``appsettings.json`` can override
them exactly as in the reference.

New (device engine) section: ``Engine`` configures the device index and kernel.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any

ENV_PREFIX = "OMNI"


@dataclass
class AiRoutingOptions:
    """AiRoutingOptions.cs:5-7."""

    max_attempts_per_provider: int = 2
    retry_base_delay_ms: int = 500
    retry_max_delay_ms: int = 5_000


@dataclass
class AiOptions:
    """Chat provider selection. NEW vs the reference (its chat path is
    always remote Gemini->GitHub, Program.cs:36-49): 'Local' serves the
    on-device decoder (models/decoder.py via chat/local.py) as the primary
    provider, with the remote chain as fallback."""

    provider: str = "Remote"  # Remote | Local
    local_checkpoint: str = ""  # models/decoder.py save_params .npz
    local_max_new_tokens: int = 128
    local_temperature: float = 0.0  # 0 = deterministic greedy
    # compile the decode executable in a background thread at startup;
    # disable in tests/lightweight configs that never chat
    local_warmup: bool = True
    # serving scheduler: 'continuous' = slot-based continuous batching
    # (chat/serving.py — join/leave at chunk boundaries, EOS frees slots
    # early); 'coalesce' = the round-3 leader/follower whole-generation
    # batcher (chat/local.py _run_batch)
    local_scheduler: str = "continuous"
    local_slots: int = 4          # continuous: concurrent decode slots
    local_chunk_tokens: int = 16  # continuous: admission granularity
    # continuous: CHUNKED PREFILL block size in tokens (0 = whole-prompt).
    # Bounds the stall a long prompt's prefill causes for in-flight decode
    # slots to one block; opt-in because cross-block attention reads the
    # bf16 cache (decode-grade numerics; see decoder.prefill_block)
    local_prefill_chunk: int = 0
    # continuous: max prefill blocks advanced per scheduler iteration across
    # ALL in-progress chunked admissions (0 = unlimited); bounds the decode
    # stall under many simultaneous long-prompt admissions
    local_prefill_budget: int = 0


@dataclass
class IngestionOptions:
    """IngestionOptions.cs:5-8."""

    chunk_size_words: int = 120
    chunk_overlap_words: int = 24
    max_upload_bytes: int = 10 * 1024 * 1024
    embedding_parallelism: int = 3


@dataclass
class ChatQualityOptions:
    """ChatQualityOptions.cs:5-13."""

    minimum_citation_count: int = 1
    minimum_strong_citation_score: float = 0.25
    insufficient_evidence_message: str = (
        "Insufficient evidence in current indexed snippets. "
        "Try uploading more relevant documents or increasing TopK."
    )
    enable_recall_only_fallback_on_provider_failure: bool = False
    recall_only_fallback_max_citations: int = 4
    recall_only_fallback_message: str = (
        "AI providers are temporarily unavailable on free tier. "
        "Returning retrieval-only answer from indexed snippets."
    )


@dataclass
class GeminiOptions:
    """appsettings.json Gemini section + GeminiChatClient.cs:14-21 defaults."""

    api_key: str = ""
    model: str = "gemini-2.5-flash"
    fallback_models: list[str] = field(
        default_factory=lambda: [
            "gemini-2.5-flash-lite",
            "gemini-flash-latest",
            "gemini-flash-lite-latest",
            "gemini-3-flash-preview",
        ]
    )
    embedding_model: str = "gemini-embedding-001"
    base_url: str = "https://generativelanguage.googleapis.com/v1beta"


@dataclass
class GitHubModelsOptions:
    """appsettings.json GitHubModels + GitHubModelsChatClient.cs:12."""

    token: str = ""
    model: str = "deepseek/DeepSeek-V3-0324"
    base_url: str = "https://models.github.ai/inference"


@dataclass
class OcrOptions:
    """appsettings.json Ocr + PdfPigTextExtractor.cs:16 and
    AzureDocumentIntelligenceOcrTextExtractor.cs:23-24 defaults."""

    provider: str = "None"
    pdf_text_min_chars: int = 120
    api_version: str = "2024-11-30"
    poll_ms: int = 800
    max_poll_attempts: int = 20
    endpoint: str = ""
    key: str = ""


@dataclass
class StorageOptions:
    provider: str = "InMemory"  # InMemory | LocalDisk
    root: str = ".omni_recall_data"
    # when set, the server restores the store + device index from
    # <snapshot_dir>/snapshot.npz at startup (device-slab fast path when the
    # archive carries matching derived arrays) and POST /api/snapshot saves
    # one atomically (index/snapshot.py)
    snapshot_dir: str = ""


@dataclass
class EmbeddingsOptions:
    # None | Gemini | Hash | Local  (Hash/Local are new deterministic
    # device-side embedders; the reference only has None | Gemini,
    # Program.cs:50-57)
    provider: str = "None"
    dim: int = 768
    # optional fine-tuned local-encoder checkpoint (models/encoder.py
    # save_params format); used only when provider == "Local"
    checkpoint: str = ""
    # device-resident query pipeline (provider == "Local" + device engine
    # only): query embeddings are computed ON DEVICE inside the search
    # dispatch — no host embed round trip, no per-query vector upload;
    # certificate escalations materialize the rows lazily
    # (search/engine.py attach_device_embedder)
    device_query: bool = True
    # default optimization steps for POST /api/documents/train (the
    # inverse-cloze self-supervised fine-tune over the ingested corpus,
    # models/finetune.py; a request body {"steps": N} overrides). 300 is
    # the real-corpus campaign setting that reaches recall@10 ~0.96.
    train_steps: int = 300


@dataclass
class CorsOptions:
    allowed_origins_csv: str = ""


@dataclass
class HealthOptions:
    probe_external_ai: bool = False


@dataclass
class EngineOptions:
    """Device-engine knobs (new scope; no reference equivalent)."""

    # scoring backend: oracle (host NumPy) | xla (jnp) | pallas (the int8
    # slice scan, through the platform's route — ops/routes.py)
    backend: str = "xla"
    # >0: row-shard the device index over the first N local devices on a
    # 1-D 'shards' mesh (parallel/mesh.py) — the multi-chip serving mode.
    # Scan, refine, compact selection and the device-exact cosine all run
    # inside shard_map (parallel/sharded.py); results are bit-identical to
    # single-device serving. 0 (default) = single device.
    shards: int = 0
    embedding_dim: int = 768
    # index capacity grows in these row blocks (bounds recompilation)
    capacity_block: int = 8192
    # reference candidate window (RecallSearchService.cs:26); <=0 disables the
    # window and scores the whole index (the device-scale mode)
    recent_window: int = 300
    # device candidates fetched per query for host exact-rescore; certificate
    # escalation multiplies by 4 until exact
    candidate_m: int = 128
    # keyword bloom signature: bits per chunk and char-n-gram size
    bloom_bits: int = 2048
    ngram: int = 4
    bloom_hashes: int = 2
    # device embedding storage for the scan: f32 | int8. int8 quarters the
    # scan's memory traffic; exactness is preserved via the certificate
    # (per-row error norms, ops/scan.py).
    scan_dtype: str = "f32"
    # >0 enables the request-coalescing executor: concurrent searches within
    # this window share one device pass (search/coalesce.py)
    coalesce_window_ms: float = 0.0
    # largest coalesced batch per device pass
    coalesce_max_batch: int = 1536
    # exact=True (default): certified-exact ranking (device candidates +
    # float64 host rescore + certificate). exact=False: approximate profile —
    # rank directly by the device upper bound, skipping the host rescore;
    # end-to-end throughput then matches the raw scan rate. Scores are upper
    # bounds (slightly inflated); ranking differs from exact only within the
    # bound slack (bloom false positives + quantization error).
    exact: bool = True
    # two-phase exact rescore (exact profile): rescore the top-32-by-device-
    # bound candidates first, then only the remaining candidates whose upper
    # bound reaches the provisional kth exact score. Sound: a candidate with
    # ub < kth cannot enter the top-k (true score <= ub), and the kth over
    # the pruned union equals the kth over all candidates. Cuts the host
    # float64 rescore work ~3-4x on discriminative corpora.
    rescore_prune: bool = True
    # phase-1 width of the two-phase rescore (clamped up to the request's k)
    rescore_phase1: int = 32
    # device-assisted exact rescore (pallas + int8 + exact only): re-score
    # the scan's top-m candidate rows on device with two-plane residual-int8
    # cosine + bloom keyword + recency — sound upper bounds ~50x tighter
    # than the scan's (ops/refine.py) — so the host float64 rescore prunes
    # to ~k pairs per query instead of ~33. Costs a second int8 copy of the
    # index in HBM (+d bytes/row).
    refine: bool = True
    # phase-1 width when refined device bounds are available (the bounds are
    # within ~1e-4 of truth, so barely more than k candidates can survive)
    rescore_phase1_refined: int = 12
    # device refine width: only the top-r scan candidates (by scan bound)
    # are re-scored by the residual-int8 refine stage; the (r+1)-th scan
    # bound joins the certificate bound, so exactness is unchanged while
    # the refine gather+kernel cost scales with r (ops/refine.py). 0 = the
    # full scan width m.
    refine_width: int = 64
    # device-exact cosine (pallas + int8 + refine + exact only): a raw-f32
    # device plane (+d*4 bytes/row HBM) lets the device compute the final
    # cosines in double-float arithmetic (ops/exact_cos.py); the host then
    # scores only keyword+recency (zero embedding bytes streamed) and
    # certifies that the float64 oracle could not rank or round the DTO
    # differently, escalating near-ties to the bit-exact host rescore.
    # Results are DTO-identical to the oracle (ranking + 4-decimal scores);
    # raw SearchHit.score may differ from the oracle float64 by < ~1e-10
    # on certified queries (the margin the certificate enforces).
    device_exact_cos: bool = False
    # direct compact selection (pallas + int8 + exact only): select the
    # compact candidate slice straight from the scan bounds and skip the
    # residual-int8 refine stage entirely — the serving fast path when the
    # corpus separates well (ops/refine.py direct_select_from_scan). The
    # certificate bound is then the (t_out+1)-th SCAN bound (~4e-3 looser
    # than the refined bound), so exactness is unchanged; misses rescue
    # through the refine path on the still-device-resident full candidates
    # (wide rescue) and then the fused rescan, exactly as before. Saves the
    # refine gather + kernel (the serving stage's second-largest device
    # cost) per batch.
    direct_select: bool = False
    # compact-selection width override (0 = auto, 32): smaller slices cut
    # the DD raw-plane gather and the host keyword width per query; the
    # certificate bound becomes the (t_out+1)-th bound, so thin margins
    # escalate more — sweep per corpus. Clamped to >= max requested k + 4.
    select_t_out: int = 0
    # coarse prepass (pallas + int8 + exact only): first scan computes
    # cosine + recency with the keyword term bounded per query by
    # 0.2*min(1, sum_w + bias); the certificate still guarantees exactness
    # and failures escalate to the full fused scan. Cuts per-query scan work
    # from 2N(d + bloom_bits) to 2Nd ops on embedding-backed queries.
    coarse_prepass: bool = True
    # coarse-scan extraction depth override (0 = auto, search/engine.py
    # _scan_layout). Depth trades extraction passes (scan cost grows with
    # t) against collision safety (a true top row is lost only when > t of
    # a query's top rows land in one slice — the certificate then fails
    # and the query escalates, so exactness is never at risk, only
    # throughput).
    coarse_t: int = 0


@dataclass
class AppConfig:
    ai: AiOptions = field(default_factory=AiOptions)
    ai_routing: AiRoutingOptions = field(default_factory=AiRoutingOptions)
    ingestion: IngestionOptions = field(default_factory=IngestionOptions)
    chat_quality: ChatQualityOptions = field(default_factory=ChatQualityOptions)
    gemini: GeminiOptions = field(default_factory=GeminiOptions)
    github_models: GitHubModelsOptions = field(default_factory=GitHubModelsOptions)
    ocr: OcrOptions = field(default_factory=OcrOptions)
    storage: StorageOptions = field(default_factory=StorageOptions)
    embeddings: EmbeddingsOptions = field(default_factory=EmbeddingsOptions)
    cors: CorsOptions = field(default_factory=CorsOptions)
    health: HealthOptions = field(default_factory=HealthOptions)
    engine: EngineOptions = field(default_factory=EngineOptions)


_SECTION_NAMES = {
    "Ai": "ai",
    "AiRouting": "ai_routing",
    "Ingestion": "ingestion",
    "ChatQuality": "chat_quality",
    "Gemini": "gemini",
    "GitHubModels": "github_models",
    "Ocr": "ocr",
    "Storage": "storage",
    "Embeddings": "embeddings",
    "Cors": "cors",
    "Health": "health",
    "Engine": "engine",
}


def _pascal_to_snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0 and (not name[i - 1].isupper() or (i + 1 < len(name) and name[i + 1].islower())):
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def _coerce(value: Any, target_type: Any) -> Any:
    if target_type is bool:
        if isinstance(value, bool):
            return value
        token = str(value).strip().lower()
        if token in ("1", "true", "yes", "on"):
            return True
        if token in ("0", "false", "no", "off"):
            return False
        # fail fast like ASP.NET options binding: a typo ('enabled',
        # 'ture') silently coercing to False could flip safety-critical
        # flags such as Engine:Exact
        raise ValueError(f"invalid boolean config value: {value!r}")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if target_type is str:
        return str(value)
    if isinstance(value, str) and target_type in (list, list[str]):
        return [v.strip() for v in value.split(",") if v.strip()]
    return value


_TYPE_NAMES: dict[str, Any] = {
    "int": int,
    "float": float,
    "bool": bool,
    "str": str,
    "list[str]": list,
}


def _apply(section_obj: Any, key: str, value: Any) -> None:
    # case-insensitive key match (ASP.NET IConfiguration binds keys
    # case-insensitively; an exact-case requirement silently drops
    # mis-cased but valid settings)
    attr = _pascal_to_snake(key).lower()
    for f in fields(section_obj):
        if f.name.lower() == attr:
            # With `from __future__ import annotations` field types are
            # strings; resolve the handful we use.
            base = f.type if isinstance(f.type, type) else _TYPE_NAMES.get(str(f.type))
            if base is None:
                current = getattr(section_obj, f.name)
                base = type(current) if current is not None else str
            setattr(section_obj, f.name, _coerce(value, base))
            return
    # Unknown keys are ignored (matches IConfiguration behavior).


def load_config(
    settings_file: str | Path | None = None,
    env: dict[str, str] | None = None,
    overrides: dict[str, Any] | None = None,
) -> AppConfig:
    """Build an AppConfig from code defaults <- JSON file <- env <- overrides.

    ``overrides`` uses ``Section:Key`` (or ``Section__Key``) flat keys, the
    same addressing as the reference's in-memory test configuration
    (tests/.../DocumentEndpointTests.cs:47-58).
    """
    cfg = AppConfig()

    if settings_file is None:
        candidate = Path(os.environ.get("OMNI_SETTINGS_FILE", "appsettings.json"))
        settings_file = candidate if candidate.is_file() else None
    section_lookup = {k.lower(): v for k, v in _SECTION_NAMES.items()}

    if settings_file is not None:
        data = json.loads(Path(settings_file).read_text(encoding="utf-8"))
        for section, values in data.items():
            attr = section_lookup.get(section.lower())
            if attr is None or not isinstance(values, dict):
                continue
            section_obj = getattr(cfg, attr)
            for key, value in values.items():
                _apply(section_obj, key, value)

    env = dict(os.environ if env is None else env)
    for raw_key, value in env.items():
        parts = raw_key.split("__")
        if len(parts) != 3 or parts[0] != ENV_PREFIX:
            continue
        attr = section_lookup.get(parts[1].lower())
        if attr is None:
            continue
        _apply(getattr(cfg, attr), parts[2], value)

    for flat_key, value in (overrides or {}).items():
        parts = flat_key.replace("__", ":").split(":")
        if len(parts) != 2:
            continue
        attr = section_lookup.get(parts[0].lower())
        if attr is None:
            continue
        _apply(getattr(cfg, attr), parts[1], value)

    return cfg
