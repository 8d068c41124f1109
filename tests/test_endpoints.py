"""In-process endpoint tests (WebApplicationFactory analog): the whole app
booted with real in-memory stores and fake providers, exercised over the
HTTP layer. Mirrors tests/OmniRecall.Api.Tests/Endpoints/*."""

import pytest

from omni_recall_tpu.chat.router import AiChatRouter, AiRateLimitError
from omni_recall_tpu.config import load_config
from omni_recall_tpu.contracts import AiChatResponse
from omni_recall_tpu.ingest.embedding import EmbeddingResult, EmbeddingStatus, FakeEmbeddingClient
from omni_recall_tpu.server.app import build_app
from omni_recall_tpu.server.testing import TestClient


class ScriptedClient:
    def __init__(self, name, steps):
        self.provider_name = name
        self.steps = list(steps)

    def complete(self, request):
        if not self.steps:
            raise AiRateLimitError("exhausted")
        step = self.steps.pop(0)
        if isinstance(step, Exception):
            raise step
        return step


def _app(overrides=None, chat_steps=None, fallback_steps=None, **kwargs):
    config = load_config(settings_file=None, env={}, overrides=overrides or {})
    router = AiChatRouter(
        ScriptedClient("primary", chat_steps or []),
        ScriptedClient("fallback", fallback_steps or []),
        config.ai_routing,
        sleep=lambda s: None,
    )
    kwargs.setdefault(
        "embedding_client",
        FakeEmbeddingClient(default=EmbeddingResult([1.0, 0.0, 0.0], EmbeddingStatus.SUCCESS)),
    )
    app = build_app(config, chat_router=router, **kwargs)
    return app, TestClient(app)


DEFAULT_OVERRIDES = {
    "Engine:EmbeddingDim": 3,
    "Engine:CapacityBlock": 128,
    "AiRouting:RetryBaseDelayMs": 0,
    "AiRouting:MaxAttemptsPerProvider": 1,
}


def test_document_lifecycle_upload_get_list_chunks_delete_reindex():
    app, client = _app(DEFAULT_OVERRIDES)
    resp = client.upload(
        "/api/documents/upload",
        filename="notes.txt",
        data=b"alpha beta gamma delta epsilon zeta eta theta",
        fields={"sourceType": "note"},
    )
    assert resp.status == 201
    doc = resp.json()
    doc_id = doc["documentId"]
    assert resp.headers["Location"] == f"/api/documents/{doc_id}"
    assert doc["sourceType"] == "note"
    assert doc["chunkCount"] >= 1

    got = client.get(f"/api/documents/{doc_id}")
    assert got.status == 200
    assert got.json()["fileName"] == "notes.txt"

    listed = client.get("/api/documents")
    assert listed.status == 200
    assert [d["documentId"] for d in listed.json()] == [doc_id]

    chunks = client.get(f"/api/documents/{doc_id}/chunks")
    assert chunks.status == 200
    assert chunks.json()[0]["hasEmbedding"] is True

    reindexed = client.post(f"/api/documents/{doc_id}/reindex")
    assert reindexed.status == 200
    assert reindexed.json()["embeddedCount"] == doc["chunkCount"]

    deleted = client.delete(f"/api/documents/{doc_id}")
    assert deleted.status == 204
    assert client.get(f"/api/documents/{doc_id}").status == 404
    assert client.delete(f"/api/documents/{doc_id}").status == 404
    assert client.post(f"/api/documents/{doc_id}/reindex").status == 404
    assert client.get(f"/api/documents/{doc_id}/chunks").status == 404


def test_upload_error_codes():
    app, client = _app(DEFAULT_OVERRIDES)
    # 415 unsupported extension
    resp = client.upload("/api/documents/upload", filename="evil.exe", data=b"x")
    assert resp.status == 415
    # 413 content-length too large (multipart envelope counts, like the
    # reference's Content-Length guard, DocumentEndpoints.cs:53-59)
    app413, client413 = _app({**DEFAULT_OVERRIDES, "Ingestion:MaxUploadBytes": 64})
    resp = client413.upload(
        "/api/documents/upload", filename="big.txt", data=b"y" * 512
    )
    assert resp.status == 413
    # 400 missing file
    resp = client.post(
        "/api/documents/upload",
        body=b"--b\r\n--b--\r\n",
        headers={"content-type": "multipart/form-data; boundary=b"},
    )
    assert resp.status == 400
    # 400 non-multipart
    resp = client.post("/api/documents/upload", json_body={"nope": 1})
    assert resp.status == 400
    # 400 whitespace-only content
    resp = client.upload("/api/documents/upload", filename="empty.txt", data=b"   ")
    assert resp.status == 400


def test_upload_dedupe_returns_existing_doc():
    app, client = _app(DEFAULT_OVERRIDES)
    first = client.upload("/api/documents/upload", filename="a.txt", data=b"same content here")
    second = client.upload("/api/documents/upload", filename="b.txt", data=b"same content here")
    assert first.json()["documentId"] == second.json()["documentId"]


def test_sharded_serving_through_the_server():
    """Engine:Shards=N boots the multi-chip serving engine (row-sharded
    index, shard_map scan — parallel/sharded.py) behind the same HTTP
    surface; results match the single-device app bit-for-bit."""
    overrides = dict(DEFAULT_OVERRIDES)
    overrides["Engine:Shards"] = 8
    app_s, client_s = _app(overrides)
    app_1, client_1 = _app(DEFAULT_OVERRIDES)
    assert app_s.engine._sharded_scorer is not None
    assert app_s.engine.device_index.mesh is not None
    for client in (client_s, client_1):
        client.upload("/api/documents/upload", filename="gpu.txt",
                      data=b"gpu kernels are fast and use the tensor cores")
        client.upload("/api/documents/upload", filename="mem.txt",
                      data=b"personal memory recall over uploaded notes")
    body = {"query": "memory recall", "topK": 2}
    r_s = client_s.post("/api/recall/search", json_body=body)
    r_1 = client_1.post("/api/recall/search", json_body=body)
    assert r_s.status == 200
    # upload timestamps differ between the two apps (the recency term then
    # differs by ~1e-8), so compare the ranking exactly and scores loosely
    cits_s, cits_1 = r_s.json()["citations"], r_1.json()["citations"]
    assert [(c["fileName"], c["chunkIndex"], c["snippet"]) for c in cits_s] \
        == [(c["fileName"], c["chunkIndex"], c["snippet"]) for c in cits_1]
    for a, b_ in zip(cits_s, cits_1):
        assert abs(a["score"] - b_["score"]) < 1e-3
    assert cits_s[0]["fileName"] == "mem.txt"


def test_recall_search_roundtrip_and_validation():
    app, client = _app(DEFAULT_OVERRIDES)
    client.upload("/api/documents/upload", filename="gpu.txt",
                  data=b"gpu kernels are fast and use the tensor cores")
    resp = client.post("/api/recall/search", json_body={"query": "gpu kernels", "topK": 3})
    assert resp.status == 200
    payload = resp.json()
    assert payload["query"] == "gpu kernels"
    assert payload["citations"][0]["fileName"] == "gpu.txt"
    assert payload["citations"][0]["score"] > 0
    assert "createdAtUtc" in payload["citations"][0]

    assert client.post("/api/recall/search", json_body={"query": "  "}).status == 400
    assert client.post("/api/recall/search", json_body={}).status == 400


def test_chat_guard_path_without_documents():
    app, client = _app(DEFAULT_OVERRIDES)
    resp = client.post("/api/chat", json_body={"prompt": "anything", "topK": 3})
    assert resp.status == 200
    payload = resp.json()
    assert payload["provider"] == "guard"
    assert payload["model"] == "insufficient-evidence"


def test_chat_grounded_path():
    app, client = _app(
        DEFAULT_OVERRIDES,
        chat_steps=[AiChatResponse("grounded [1] answer", "model-a", "primary")],
    )
    client.upload("/api/documents/upload", filename="facts.txt",
                  data=b"the sky is blue and water is wet")
    resp = client.post("/api/chat", json_body={"prompt": "sky blue water", "topK": 2})
    assert resp.status == 200
    payload = resp.json()
    assert payload["provider"] == "primary"
    assert "[1]" in payload["answer"]
    assert len(payload["citations"]) == 1


def test_chat_503_when_providers_down_and_fallback_disabled():
    app, client = _app(
        {**DEFAULT_OVERRIDES, "ChatQuality:EnableRecallOnlyFallbackOnProviderFailure": False},
        chat_steps=[AiRateLimitError("p")],
        fallback_steps=[AiRateLimitError("f")],
    )
    client.upload("/api/documents/upload", filename="facts.txt",
                  data=b"the sky is blue and water is wet")
    resp = client.post("/api/chat", json_body={"prompt": "sky blue water"})
    assert resp.status == 503
    assert resp.json()["title"] == "AI provider unavailable"


def test_chat_recall_only_fallback_enabled():
    app, client = _app(
        {**DEFAULT_OVERRIDES, "ChatQuality:EnableRecallOnlyFallbackOnProviderFailure": True},
        chat_steps=[AiRateLimitError("p")],
        fallback_steps=[AiRateLimitError("f")],
    )
    client.upload("/api/documents/upload", filename="facts.txt",
                  data=b"the sky is blue and water is wet")
    resp = client.post("/api/chat", json_body={"prompt": "sky blue water"})
    assert resp.status == 200
    assert resp.json()["provider"] == "recall-only"


def test_chat_validation():
    app, client = _app(DEFAULT_OVERRIDES)
    assert client.post("/api/chat", json_body={"prompt": " "}).status == 400


def test_global_exception_handler_returns_problem_500():
    class ThrowingStore:
        def __getattr__(self, name):
            def boom(*args, **kwargs):
                raise RuntimeError("store exploded")
            return boom

    app, client = _app(DEFAULT_OVERRIDES, store=ThrowingStore())
    resp = client.get("/api/documents")
    assert resp.status == 500
    payload = resp.json()
    assert payload["title"] == "Unexpected server error"
    assert payload["status"] == 500


def test_health_endpoint_and_swagger():
    app, client = _app(DEFAULT_OVERRIDES)
    resp = client.get("/health")
    assert resp.status == 200
    payload = resp.json()
    assert payload["status"] in ("healthy", "degraded")
    names = [d["name"] for d in payload["dependencies"]]
    assert "storage-store" in names
    assert "ai-gemini" in names
    assert "device-engine" in names
    engine_row = next(d for d in payload["dependencies"] if d["name"] == "device-engine")
    assert "cpu" in engine_row["detail"]

    swagger = client.get("/swagger/v1/swagger.json")
    assert swagger.status == 200
    assert "/api/recall/search" in swagger.json()["paths"]


def test_health_503_when_store_unhealthy():
    class ThrowingStore:
        def list_documents(self, n):
            raise RuntimeError("down")

        def __getattr__(self, name):
            def ok(*args, **kwargs):
                return []
            return ok

    from omni_recall_tpu.server.health import HealthProbeService

    config = load_config(settings_file=None, env={}, overrides=DEFAULT_OVERRIDES)
    app, client = _app(DEFAULT_OVERRIDES)
    app.health_service = HealthProbeService(config, ThrowingStore(), app.raw_store, app.engine)
    resp = client.get("/health")
    assert resp.status == 503
    assert resp.json()["status"] == "unhealthy"


def test_unknown_route_404_and_cors():
    app, client = _app({**DEFAULT_OVERRIDES, "Cors:AllowedOriginsCsv": "http://localhost:4200"})
    assert client.get("/api/nope").status == 404
    resp = client.post(
        "/api/recall/search",
        json_body={"query": "x"},
        headers={"Origin": "http://localhost:4200"},
    )
    assert resp.headers.get("Access-Control-Allow-Origin") == "http://localhost:4200"
    resp2 = client.post(
        "/api/recall/search", json_body={"query": "x"}, headers={"Origin": "http://evil.com"}
    )
    assert "Access-Control-Allow-Origin" not in resp2.headers


def test_pdf_upload_extracts_text():
    import zlib

    text_ops = b"BT /F1 12 Tf (alpha beta gamma delta epsilon zeta eta theta words) Tj ET"
    stream = zlib.compress(text_ops)
    pdf = (
        b"%PDF-1.4\n1 0 obj\n<< /Length " + str(len(stream)).encode()
        + b" /Filter /FlateDecode >>\nstream\n" + stream + b"endstream\nendobj\n%%EOF"
    )
    app, client = _app({**DEFAULT_OVERRIDES, "Ocr:PdfTextMinChars": 10})
    resp = client.upload("/api/documents/upload", filename="doc.pdf", data=pdf)
    assert resp.status == 201
    doc_id = resp.json()["documentId"]
    chunks = client.get(f"/api/documents/{doc_id}/chunks").json()
    assert "alpha beta gamma" in chunks[0]["snippet"]


def test_dotfile_upload_accepted():
    """Path.GetExtension('.md') == '.md' in the reference: dotfiles whose
    whole name is an allowed extension must upload, not 415."""
    app, client = _app(DEFAULT_OVERRIDES)
    resp = client.upload("/api/documents/upload", filename=".md", data=b"hello dot")
    assert resp.status == 201, resp.body


def test_non_object_json_bodies_return_400():
    app, client = _app(DEFAULT_OVERRIDES)
    for body in ([1, 2], "hi", 5):
        assert client.post("/api/recall/search", json_body=body).status == 400
        assert client.post("/api/chat", json_body=body).status == 400
    # non-string query/prompt -> 400, not 500
    assert client.post("/api/recall/search", json_body={"query": 5}).status == 400
    assert client.post("/api/chat", json_body={"prompt": ["x"]}).status == 400


def test_route_literals_are_regex_escaped():
    app, client = _app(DEFAULT_OVERRIDES)
    assert client.get("/swagger/v1/swagger.json").status == 200
    assert client.get("/swagger/v1/swaggerXjson").status == 404


def test_wsgi_body_cap_rejects_before_reading():
    """A huge Content-Length must 413 at the WSGI layer WITHOUT buffering
    the body (the reference's Kestrel MaxRequestBodySize equivalent)."""
    app, _client = _app(DEFAULT_OVERRIDES)

    class ExplodingInput:
        def read(self, n):
            raise AssertionError("body must not be read")

    status_box = {}

    def start_response(status, headers):
        status_box["status"] = status

    out = app({
        "REQUEST_METHOD": "POST",
        "PATH_INFO": "/api/documents/upload",
        "QUERY_STRING": "",
        "CONTENT_LENGTH": str(8 << 30),
        "CONTENT_TYPE": "multipart/form-data; boundary=b",
        "wsgi.input": ExplodingInput(),
    }, start_response)
    assert status_box["status"].startswith("413"), status_box
    assert b"Payload too large" in b"".join(out)


def test_raw_store_path_traversal_contained(tmp_path):
    from omni_recall_tpu.index.store import LocalFileRawDocumentStore

    store = LocalFileRawDocumentStore(tmp_path)
    rel = store.save("../../../../etc/passwd.md", "content", "a" * 16)
    target = (tmp_path / rel).resolve()
    assert target.is_relative_to(tmp_path.resolve())
    assert target.is_file()
    # reads are contained too
    assert store.get("../../etc/passwd") is None
