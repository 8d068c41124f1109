"""Application composition root + HTTP routes.

Mirrors the reference's Program.cs + Endpoints/: DI wiring by configuration
(provider switches, Program.cs:40-69), the 9 REST routes
(DocumentEndpoints.cs, RecallEndpoints.cs, ChatEndpoints.cs, /health at
Program.cs:104-115), a swagger.json document, CORS, and the global
exception -> ProblemDetails handler (server/http.py).

``build_app`` accepts overrides for every dependency so tests can boot the
whole app in-process with fakes — the reference's WebApplicationFactory
pattern (tests/.../ChatEndpointTests.cs:27-126).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

from omni_recall_tpu.chat.orchestration import ChatOrchestrationService
from omni_recall_tpu.chat.providers import GeminiChatClient, GitHubModelsChatClient
from omni_recall_tpu.chat.router import AiChatRouter, AiProviderUnavailableError
from omni_recall_tpu.config import AppConfig, load_config
from omni_recall_tpu.extract.pdf import NoOpOcrTextExtractor, PdfTextExtractor
from omni_recall_tpu.index.store import (
    InMemoryIngestionStore,
    InMemoryRawDocumentStore,
    LocalFileRawDocumentStore,
)
from omni_recall_tpu.ingest.embedding import (
    GeminiEmbeddingClient,
    HashEmbeddingClient,
    NoOpEmbeddingClient,
)
from omni_recall_tpu.ingest.service import DocumentIngestionService, IngestionError
from omni_recall_tpu.search.engine import RecallEngine
from omni_recall_tpu.search.service import RecallSearchService
from omni_recall_tpu.server.health import HealthProbeService
from omni_recall_tpu.server.http import Request, Response, Router, WsgiApp
from omni_recall_tpu.server.openapi import build_openapi_document

ALLOWED_EXTENSIONS = {".pdf", ".txt", ".md", ".markdown"}  # DocumentEndpoints.cs:8-14


def _parse_top_k(value) -> int | None:
    """Validate user-supplied topK: accept ints (and integral floats/strings,
    matching ASP.NET model binding's leniency); None on anything else so the
    handler returns 400 rather than a 500 ProblemDetails."""
    if isinstance(value, bool):
        return None
    try:
        as_int = int(value)
    except (TypeError, ValueError, OverflowError):  # inf -> OverflowError
        return None
    if isinstance(value, float) and value != as_int:
        return None
    return as_int


class OmniRecallApp(WsgiApp):
    """WSGI app exposing the full Omni Recall REST surface."""

    def __init__(
        self,
        config: AppConfig,
        *,
        store=None,
        raw_store=None,
        embedding_client=None,
        chat_router=None,
        pdf_extractor=None,
        engine=None,
        health_service=None,
    ) -> None:
        self.config = config
        self.store = store if store is not None else InMemoryIngestionStore()

        if raw_store is not None:
            self.raw_store = raw_store
        elif (config.storage.provider or "").strip().lower() == "localdisk":
            self.raw_store = LocalFileRawDocumentStore(Path(config.storage.root))
        else:
            self.raw_store = InMemoryRawDocumentStore()

        if embedding_client is not None:
            self.embedding_client = embedding_client
        else:
            provider = (config.embeddings.provider or "").strip().lower()
            if provider == "gemini":
                self.embedding_client = GeminiEmbeddingClient(
                    config.gemini, output_dim=config.embeddings.dim
                )
            elif provider == "hash":
                self.embedding_client = HashEmbeddingClient(config.embeddings.dim)
            elif provider == "local":
                from omni_recall_tpu.ingest.embedding import (
                    LocalEncoderEmbeddingClient,
                )

                self.embedding_client = LocalEncoderEmbeddingClient(
                    config.embeddings.dim,
                    checkpoint=config.embeddings.checkpoint,
                )
            else:
                self.embedding_client = NoOpEmbeddingClient()

        if engine is not None:
            self.engine = engine
        else:
            mesh = None
            if config.engine.shards > 0:
                # multi-chip serving: row-shard the index over a 1-D
                # 'shards' mesh (Engine:Shards devices); scan + refine +
                # device-exact cosine run inside shard_map
                # (parallel/sharded.py) with bit-identical results
                from omni_recall_tpu.parallel.mesh import shards_mesh

                mesh = shards_mesh(config.engine.shards)
            self.engine = RecallEngine(
                self.store, options=config.engine, mesh=mesh
            )
        if config.embeddings.dim != config.engine.embedding_dim:
            # Mismatched dims are handled soundly (zero device rows + host
            # full-scan routing for mismatched queries) but silently disable
            # the fast path — surface the misconfiguration loudly at wiring.
            logging.getLogger(__name__).warning(
                "Embeddings:Dim (%d) != Engine:EmbeddingDim (%d): embeddings "
                "will not land in the device index and searches with "
                "mismatched query embeddings fall back to the exact host "
                "scan. Align the two settings.",
                config.embeddings.dim, config.engine.embedding_dim,
            )
        # snapshot restore (new scope: the reference loses its in-memory
        # store on restart, SURVEY.md §5): load the archived store and
        # device index before any service wiring. The device-slab fast path
        # skips bloom hashing + re-quantization entirely; a failed restore
        # logs and boots empty (serving must come up regardless).
        self.snapshot_dir = (config.storage.snapshot_dir or "").strip() or None
        if self.snapshot_dir:
            try:
                from omni_recall_tpu.index import snapshot as snap

                p = Path(self.snapshot_dir)
                if snap.snapshot_exists(p):
                    restored, aux = snap.load_snapshot_full(p)
                    with restored._lock:
                        self.store.bulk_restore(
                            list(restored._documents.values()),
                            restored._chunks, restored._seq,
                        )
                    snap.restore_engine(self.store, self.engine, aux=aux)
                    logging.getLogger(__name__).info(
                        "restored snapshot from %s (%d documents)",
                        p, len(self.store.list_documents(2**31 - 1)),
                    )
            except Exception:
                logging.getLogger(__name__).exception(
                    "snapshot restore from %s failed; starting empty",
                    self.snapshot_dir,
                )
        self.search_executor = None
        if config.engine.coalesce_window_ms > 0 and config.engine.backend != "oracle":
            from omni_recall_tpu.search.coalesce import CoalescingSearchExecutor

            self.search_executor = CoalescingSearchExecutor(
                self.engine,
                window_ms=config.engine.coalesce_window_ms,
                max_batch=max(1, config.engine.coalesce_max_batch),
            )
        # device-resident query pipeline: with the local on-device encoder
        # and a device engine, query embeddings are computed inside the
        # search dispatch — no host embed round trip, no per-query vector
        # upload (engine.attach_device_embedder docstring)
        device_query = False
        if (
            config.embeddings.device_query
            and (config.embeddings.provider or "").strip().lower() == "local"
            and config.engine.backend != "oracle"
            and self.engine.device_index is not None
            and self.engine._sharded_scorer is None
            and getattr(self.embedding_client, "dim", None)
            == self.engine.device_index.dim
        ):
            try:
                self.engine.attach_device_embedder(self.embedding_client)
                device_query = True
            except ValueError:
                logging.getLogger(__name__).exception(
                    "device query pipeline unavailable; using host embeds"
                )
        self.search_service = RecallSearchService(
            self.engine, self.embedding_client, executor=self.search_executor,
            device_query=device_query,
        )
        self.ingestion_service = DocumentIngestionService(
            self.store, self.raw_store, self.embedding_client,
            config.ingestion, engine=self.engine,
        )
        if chat_router is not None:
            self.chat_router = chat_router
        elif (config.ai.provider or "").strip().lower() == "local":
            from omni_recall_tpu.chat.local import LocalDecoderChatClient

            # local on-device decoder is primary; the FULL remote chain
            # (Gemini -> GitHub Models) stays as fallback by nesting a
            # remote router as the fallback client — routers satisfy the
            # IAiChatClient contract, so they compose. Without API keys the
            # nested router fails -> recall-only fallback.
            local_client = LocalDecoderChatClient(
                checkpoint=config.ai.local_checkpoint,
                max_new_tokens=config.ai.local_max_new_tokens,
                temperature=config.ai.local_temperature,
                scheduler=getattr(config.ai, "local_scheduler", "continuous"),
                slots=getattr(config.ai, "local_slots", 4),
                chunk_tokens=getattr(config.ai, "local_chunk_tokens", 16),
                prefill_chunk=getattr(config.ai, "local_prefill_chunk", 0),
                prefill_budget=getattr(config.ai, "local_prefill_budget", 0),
            )
            if getattr(config.ai, "local_warmup", True):
                local_client.warmup_async()  # compile overlaps server startup
            remote_chain = AiChatRouter(
                GeminiChatClient(config.gemini),
                GitHubModelsChatClient(config.github_models),
                config.ai_routing,
            )
            self.chat_router = AiChatRouter(
                local_client, remote_chain, config.ai_routing,
            )
        else:
            self.chat_router = AiChatRouter(
                GeminiChatClient(config.gemini),
                GitHubModelsChatClient(config.github_models),
                config.ai_routing,
            )
        self.chat_service = ChatOrchestrationService(
            self.search_service, self.chat_router, config.chat_quality
        )
        if pdf_extractor is not None:
            self.pdf_extractor = pdf_extractor
        else:
            ocr_provider = (config.ocr.provider or "").strip().lower()
            if ocr_provider in ("documentintelligence", "azuredocumentintelligence"):
                from omni_recall_tpu.extract.ocr import DocumentIntelligenceOcrTextExtractor

                ocr = DocumentIntelligenceOcrTextExtractor(config.ocr)
            else:
                ocr = NoOpOcrTextExtractor()
            self.pdf_extractor = PdfTextExtractor(ocr, config.ocr.pdf_text_min_chars)
        self.health_service = health_service if health_service is not None else HealthProbeService(
            config, self.store, self.raw_store, self.engine
        )

        router = Router()
        router.add("POST", "/api/documents/upload", self._upload_document)
        router.add("GET", "/api/documents", self._list_documents)
        router.add("GET", "/api/documents/{document_id}", self._get_document)
        router.add("GET", "/api/documents/{document_id}/chunks", self._get_document_chunks)
        router.add("DELETE", "/api/documents/{document_id}", self._delete_document)
        router.add("POST", "/api/documents/{document_id}/reindex", self._reindex_document)
        router.add("POST", "/api/documents/train", self._train_embedder)
        router.add("POST", "/api/recall/search", self._search_recall)
        router.add("POST", "/api/chat", self._complete_chat)
        router.add("GET", "/health", self._health)
        router.add("GET", "/metrics", self._metrics)
        router.add("POST", "/api/snapshot", self._save_snapshot)
        router.add("GET", "/swagger/v1/swagger.json", self._swagger)
        router.add("GET", "/swagger", self._swagger_ui)
        router.add("GET", "/", self._index)
        origins = [
            o.strip()
            for o in (config.cors.allowed_origins_csv or "").split(",")
            if o.strip()
        ]
        # body cap at the WSGI layer (before buffering): upload limit plus
        # multipart framing slack; mirrors Kestrel MaxRequestBodySize
        super().__init__(
            router, allowed_origins=origins,
            max_body_bytes=max(1, config.ingestion.max_upload_bytes) + (64 << 10),
        )

    # -- documents (DocumentEndpoints.cs) --

    def _upload_document(self, request: Request) -> Response:
        max_upload = max(1, self.config.ingestion.max_upload_bytes)
        if request.content_length and request.content_length > max_upload:
            return Response.problem(
                "Payload too large", f"Max upload size is {max_upload} bytes.", 413
            )
        try:
            fields, files = request.form()
        except ValueError:
            return Response.error("Expected multipart form data.")

        file = next((f for f in files if f.name == "file"), files[0] if files else None)
        if file is None or len(file.data) == 0:
            return Response.error("File is required.")
        if len(file.data) > max_upload:
            return Response.problem(
                "Payload too large", f"Max upload size is {max_upload} bytes.", 413
            )

        extension = os.path.splitext(file.filename)[1].lower()
        if not extension and file.filename.startswith("."):
            # dotfiles: Path.GetExtension(".txt") returns ".txt" in the
            # reference (DocumentEndpoints.cs allowlist accepts them);
            # splitext treats the name as extensionless
            extension = file.filename.lower()
        if extension not in ALLOWED_EXTENSIONS:
            return Response(415, b"", {})

        if extension == ".pdf":
            content = self.pdf_extractor.extract_text(file.data)
        else:
            content = file.data.decode("utf-8", errors="replace")
        if not content or not content.strip():
            return Response.error("Uploaded file produced no readable text content.")

        source_type = fields.get("sourceType", "").strip() or "file"
        try:
            result = self.ingestion_service.ingest(file.filename, content, source_type)
        except IngestionError as exc:
            return Response.error(str(exc))
        return Response.json(
            result, 201, {"Location": f"/api/documents/{result.document_id}"}
        )

    def _get_document(self, request: Request) -> Response:
        document = self.ingestion_service.get_document(request.path_params["document_id"])
        if document is None:
            return Response.error("Document not found.", 404)
        return Response.json(document)

    def _list_documents(self, request: Request) -> Response:
        max_count = request.query_int("maxCount") or 0
        docs = self.ingestion_service.list_documents(max_count if max_count > 0 else 100)
        return Response.json(docs)

    def _get_document_chunks(self, request: Request) -> Response:
        document_id = request.path_params["document_id"]
        if self.ingestion_service.get_document(document_id) is None:
            return Response.error("Document not found.", 404)
        max_count = request.query_int("maxCount") or 0
        chunks = self.ingestion_service.get_document_chunks(
            document_id, max_count if max_count > 0 else 200
        )
        return Response.json(chunks)

    def _delete_document(self, request: Request) -> Response:
        deleted = self.ingestion_service.delete_document(request.path_params["document_id"])
        if not deleted:
            return Response.error("Document not found.", 404)
        return Response.no_content()

    def _reindex_document(self, request: Request) -> Response:
        result = self.ingestion_service.reindex_document(request.path_params["document_id"])
        if result is None:
            return Response.error("Document not found.", 404)
        return Response.json(result)

    def _train_embedder(self, request: Request) -> Response:
        """POST /api/documents/train: fine-tune the local encoder on the
        ingested corpus and re-embed everything (ingest/service.py
        train_embedder). Admin route, synchronous — the fine-tune takes
        seconds to minutes depending on steps x corpus size."""
        try:
            payload = request.json() or {}
        except ValueError:
            return Response.error("Invalid JSON body.")
        if not isinstance(payload, dict):
            return Response.error("Request body must be a JSON object.")
        steps = payload.get("steps", self.config.embeddings.train_steps)
        seed = payload.get("seed", 0)
        if not isinstance(steps, int) or isinstance(steps, bool) or steps <= 0:
            return Response.error("steps must be a positive integer.")
        if not isinstance(seed, int) or isinstance(seed, bool):
            return Response.error("seed must be an integer.")
        try:
            result = self.ingestion_service.train_embedder(
                steps=steps, seed=seed
            )
        except IngestionError as exc:
            return Response.error(str(exc))
        if result is None:
            return Response.problem(
                "Embedding provider is not trainable.",
                "POST /api/documents/train requires "
                "Embeddings:Provider=Local (the on-device encoder).",
                409,
            )
        return Response.json(result)

    # -- recall (RecallEndpoints.cs:20-30) --

    def _search_recall(self, request: Request) -> Response:
        try:
            payload = request.json() or {}
        except ValueError:
            return Response.error("Invalid JSON body.")
        if not isinstance(payload, dict):
            # model-binding parity: a non-object body is a 400, not a 500
            return Response.error("Request body must be a JSON object.")
        query = payload.get("query") or ""
        if not isinstance(query, str) or not query.strip():
            return Response.error("Query is required.")
        top_k = _parse_top_k(payload.get("topK", 5))
        if top_k is None:
            return Response.error("topK must be an integer.")
        result = self.search_service.search(query, top_k)
        return Response.json(result)

    # -- chat (ChatEndpoints.cs:21-41) --

    def _complete_chat(self, request: Request) -> Response:
        try:
            payload = request.json() or {}
        except ValueError:
            return Response.error("Invalid JSON body.")
        if not isinstance(payload, dict):
            return Response.error("Request body must be a JSON object.")
        prompt = payload.get("prompt") or ""
        if not isinstance(prompt, str) or not prompt.strip():
            return Response.error("Prompt is required.")
        top_k = _parse_top_k(payload.get("topK", 5))
        if top_k is None:
            return Response.error("topK must be an integer.")
        try:
            result = self.chat_service.complete(prompt, top_k)
        except AiProviderUnavailableError as exc:
            return Response.problem("AI provider unavailable", str(exc), 503)
        return Response.json(result)

    # -- health (Program.cs:104-115) --

    def _health(self, request: Request) -> Response:
        report = self.health_service.probe()
        status_code = 503 if report.status == "unhealthy" else 200
        return Response.json(report, status_code)

    def _save_snapshot(self, request: Request) -> Response:
        """POST /api/snapshot — persist the store + device-index slabs
        atomically to Storage:SnapshotDir (new scope: first-class
        checkpoint/resume, SURVEY.md §5). Holds the engine mutation lock so
        the store view and the gathered slabs are one consistent state; a
        restart with the same config restores via the slab fast path."""
        if not self.snapshot_dir:
            return Response.problem(
                "Snapshots not configured",
                "Set Storage:SnapshotDir to enable snapshot persistence.",
                409,
            )
        from omni_recall_tpu.index import snapshot as snap

        with self.engine.mutation_lock:
            snap.save_snapshot(
                self.store, self.snapshot_dir,
                device_index=self.engine.device_index,
            )
        docs = self.store.list_documents(2**31 - 1)
        return Response.json(
            {
                "path": str(Path(self.snapshot_dir) / "snapshot.d"),
                "documents": len(docs),
                "chunks": sum(d.chunk_count for d in docs),
            },
            200,
        )

    def _metrics(self, request: Request) -> Response:
        """Prometheus text exposition of the engine/index counters (new
        scope: the reference exports no metrics, SURVEY.md §5; this is the
        observability surface a production serving deployment needs)."""
        engine = self.engine
        dix = engine.device_index
        lines = [
            "# TYPE omni_searches_total counter",
            f"omni_searches_total {engine.stats['searches_total']}",
            "# TYPE omni_coarse_resolved_total counter",
            f"omni_coarse_resolved_total {engine.stats['coarse_resolved_total']}",
            "# TYPE omni_escalation_rounds_total counter",
            f"omni_escalation_rounds_total {engine.stats['escalation_rounds_total']}",
            "# TYPE omni_host_fallbacks_total counter",
            f"omni_host_fallbacks_total {engine.stats['host_fallbacks_total']}",
            "# TYPE omni_index_rows gauge",
            f"omni_index_rows {dix.n_rows if dix is not None else 0}",
            "# TYPE omni_index_valid_rows gauge",
            f"omni_index_valid_rows {dix.n_valid if dix is not None else 0}",
            "# TYPE omni_index_capacity_rows gauge",
            f"omni_index_capacity_rows {dix._cap if dix is not None else 0}",
        ]
        return Response(
            200, ("\n".join(lines) + "\n").encode("utf-8"),
            {"Content-Type": "text/plain; version=0.0.4; charset=utf-8"},
        )

    def _swagger(self, request: Request) -> Response:
        return Response.json(build_openapi_document())

    def _index(self, request: Request) -> Response:
        from omni_recall_tpu.server.ui import INDEX_HTML

        return Response(
            200, INDEX_HTML.encode("utf-8"),
            {"Content-Type": "text/html; charset=utf-8"},
        )

    def _swagger_ui(self, request: Request) -> Response:
        """Self-contained API docs page (Swagger-UI parity, Program.cs:74-75,
        without CDN assets — this environment is offline)."""
        from omni_recall_tpu.server.ui import SWAGGER_HTML

        return Response(
            200, SWAGGER_HTML.encode("utf-8"),
            {"Content-Type": "text/html; charset=utf-8"},
        )


def build_app(
    config: AppConfig | None = None,
    overrides: dict | None = None,
    **dependencies,
) -> OmniRecallApp:
    if config is None:
        config = load_config(overrides=overrides)
    return OmniRecallApp(config, **dependencies)
