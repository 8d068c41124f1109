"""Health probes.

Mirrors src/OmniRecall.Api/Services/HealthProbeService.cs: sequential
probes (ingestion store, raw storage, then the AI providers in use) each
timed and mapped to healthy/degraded/unhealthy; overall status = worst
(:33-37); AI probes report degraded when unconfigured and only hit the
network when ``Health:ProbeExternalAi`` is true (:89-159, 3s timeout).

Departures from the reference (new scope): with Ai:Provider=Local the
chat path is on-device, so the remote probes are replaced by a synthetic
healthy 'ai-local' row — except Gemini, which stays probed whenever it
still serves the embeddings path. A device-engine probe reports the
device platform and kind and the index state.
"""

from __future__ import annotations

import logging
import time
from datetime import datetime, timezone

from omni_recall_tpu.config import AppConfig
from omni_recall_tpu.contracts import HealthDependency, HealthResponse
from omni_recall_tpu.ingest.embedding import Transport, urllib_transport

logger = logging.getLogger(__name__)

HEALTHY = "healthy"
DEGRADED = "degraded"
UNHEALTHY = "unhealthy"


class HealthProbeService:
    def __init__(
        self,
        config: AppConfig,
        store,
        raw_store,
        engine=None,
        transport: Transport | None = None,
    ) -> None:
        self.config = config
        self.store = store
        self.raw_store = raw_store
        self.engine = engine
        self.transport = transport or urllib_transport

    def probe(self) -> HealthResponse:
        dependencies = [
            self._probe_store(),
            self._probe_raw_storage(),
        ]
        chat_local = (self.config.ai.provider or "").strip().lower() == "local"
        uses_gemini = (
            not chat_local
            or (self.config.embeddings.provider or "").strip().lower() == "gemini"
        )
        if chat_local:
            # chat is served on-device: the remote chain is only a fallback,
            # so missing API keys must not degrade overall health...
            dependencies.append(HealthDependency(
                "ai-local", HEALTHY, "Chat served by the on-device decoder.", 0
            ))
        if uses_gemini:
            # ...but Gemini stays a REQUIRED dependency whenever it still
            # serves the embeddings path
            dependencies.append(self._probe_gemini())
        if not chat_local:
            dependencies.append(self._probe_github_models())
        if self.engine is not None:
            dependencies.append(self._probe_engine())
        statuses = [d.status for d in dependencies]
        overall = (
            UNHEALTHY if UNHEALTHY in statuses
            else DEGRADED if DEGRADED in statuses
            else HEALTHY
        )
        return HealthResponse(overall, datetime.now(timezone.utc), dependencies)

    def _timed(self, name: str, fn) -> HealthDependency:
        start = time.monotonic()
        status, detail = fn()
        return HealthDependency(name, status, detail, int((time.monotonic() - start) * 1000))

    def _probe_store(self) -> HealthDependency:
        def run():
            try:
                self.store.list_documents(1)
                return HEALTHY, "Ingestion store reachable."
            except Exception as exc:
                logger.warning("Health probe failed for ingestion store: %s", exc)
                return UNHEALTHY, f"Ingestion store probe failed: {exc}"
        return self._timed("storage-store", run)

    def _probe_raw_storage(self) -> HealthDependency:
        def run():
            provider = (self.config.storage.provider or "").strip().lower()
            if provider != "localdisk":
                return HEALTHY, "Raw storage probe skipped (Storage:Provider is not LocalDisk)."
            try:
                from pathlib import Path
                root = Path(self.config.storage.root)
                root.mkdir(parents=True, exist_ok=True)
                return HEALTHY, f"Raw storage root '{root}' is writable."
            except Exception as exc:
                logger.warning("Health probe failed for raw storage: %s", exc)
                return UNHEALTHY, f"Raw storage probe failed: {exc}"
        return self._timed("storage-raw", run)

    def _probe_gemini(self) -> HealthDependency:
        def run():
            api_key = self.config.gemini.api_key
            if not api_key or not api_key.strip():
                return DEGRADED, "Gemini API key is not configured."
            if not self.config.health.probe_external_ai:
                return HEALTHY, "Gemini is configured (external probe disabled)."
            url = f"{self.config.gemini.base_url.rstrip('/')}/models?key={api_key}"
            try:
                resp = self.transport("GET", url, {}, None, 3.0)
                status = HEALTHY if resp.status < 500 else DEGRADED
                return status, f"Gemini endpoint reachable (HTTP {resp.status})."
            except Exception as exc:
                logger.warning("Health probe failed for Gemini endpoint: %s", exc)
                return UNHEALTHY, f"Gemini probe failed: {exc}"
        return self._timed("ai-gemini", run)

    def _probe_github_models(self) -> HealthDependency:
        def run():
            token = self.config.github_models.token
            if not token or not token.strip():
                return DEGRADED, "GitHub Models token is not configured."
            if not self.config.health.probe_external_ai:
                return HEALTHY, "GitHub Models is configured (external probe disabled)."
            url = f"{self.config.github_models.base_url.rstrip('/')}/models"
            try:
                resp = self.transport("GET", url, {"Authorization": f"Bearer {token}"}, None, 3.0)
                status = HEALTHY if resp.status < 500 else DEGRADED
                return status, f"GitHub Models endpoint reachable (HTTP {resp.status})."
            except Exception as exc:
                logger.warning("Health probe failed for GitHub Models endpoint: %s", exc)
                return UNHEALTHY, f"GitHub Models probe failed: {exc}"
        return self._timed("ai-github-models", run)

    def _probe_engine(self) -> HealthDependency:
        def run():
            try:
                dix = self.engine.device_index
                if dix is None:
                    return HEALTHY, f"Engine backend={self.engine.options.backend} (host oracle)."
                import jax

                device = jax.devices()[0]
                return HEALTHY, (
                    f"Engine backend={self.engine.options.backend} on "
                    f"{device.platform} ({device.device_kind}); device index "
                    f"{dix.n_valid}/{dix.n_rows} valid rows, dim={dix.dim}."
                )
            except Exception as exc:
                return UNHEALTHY, f"Engine probe failed: {exc}"
        return self._timed("device-engine", run)
