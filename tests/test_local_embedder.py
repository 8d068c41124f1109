"""Local on-device embedding provider (models/encoder.py behind the
IEmbeddingClient contract) + checkpoint round-trip + ingestion batch path.

NEW vs the reference (all of whose embeddings are remote HTTPS,
GeminiEmbeddingClient.cs); the never-raise status contract mirrors
IEmbeddingClient.cs:3-16.
"""

import numpy as np
import pytest

from omni_recall_tpu.ingest.embedding import (
    EmbeddingStatus,
    LocalEncoderEmbeddingClient,
)
from omni_recall_tpu.models import encoder

CFG = encoder.EncoderConfig(
    vocab_size=512, d_model=32, n_layers=1, n_heads=2, d_ff=64,
    max_len=16, out_dim=24,
)


@pytest.fixture(scope="module")
def client():
    return LocalEncoderEmbeddingClient(dim=24, cfg=CFG)


def test_embed_returns_normalized_dim_vector(client):
    res = client.embed("gpu kernels are fast")
    assert res.status == EmbeddingStatus.SUCCESS
    assert res.model == "local-encoder"
    assert len(res.vector) == 24
    assert abs(float(np.linalg.norm(res.vector)) - 1.0) < 1e-4


def test_embed_deterministic_for_same_seed(client):
    other = LocalEncoderEmbeddingClient(dim=24, cfg=CFG)
    a = client.embed("recall engine")
    b = other.embed("recall engine")
    assert a.vector == b.vector


def test_empty_and_whitespace_text_is_empty_status(client):
    assert client.embed("").status == EmbeddingStatus.EMPTY
    assert client.embed("   ").status == EmbeddingStatus.EMPTY


def test_embed_batch_matches_single_calls(client):
    texts = ["alpha beta", "", "gamma delta epsilon", "zeta"]
    batch = client.embed_batch(texts)
    assert [r.status for r in batch] == [
        EmbeddingStatus.SUCCESS, EmbeddingStatus.EMPTY,
        EmbeddingStatus.SUCCESS, EmbeddingStatus.SUCCESS,
    ]
    for text, from_batch in zip(texts, batch):
        if text.strip():
            single = client.embed(text)
            assert np.allclose(single.vector, from_batch.vector, atol=1e-6)


def test_checkpoint_round_trip(tmp_path, client):
    path = str(tmp_path / "enc.npz")
    encoder.save_params(path, client.params, client.cfg)
    reloaded = LocalEncoderEmbeddingClient(dim=24, checkpoint=path)
    assert reloaded.model.startswith("local-encoder:")
    a = client.embed("checkpoint parity")
    b = reloaded.embed("checkpoint parity")
    assert np.allclose(a.vector, b.vector, atol=1e-6)


def test_checkpoint_dim_mismatch_raises(tmp_path, client):
    path = str(tmp_path / "enc.npz")
    encoder.save_params(path, client.params, client.cfg)
    with pytest.raises(ValueError, match="out_dim"):
        LocalEncoderEmbeddingClient(dim=99, checkpoint=path)


def test_ingestion_uses_batch_path_and_search_round_trips(client):
    from omni_recall_tpu.config import AppConfig
    from omni_recall_tpu.server.app import OmniRecallApp

    config = AppConfig()
    config.embeddings.provider = "Local"
    config.embeddings.dim = 24
    config.engine.backend = "xla"
    config.engine.embedding_dim = 24
    app = OmniRecallApp(config, embedding_client=client)

    calls = {"batch": 0}
    orig = client.embed_batch

    def counting_batch(texts):
        calls["batch"] += 1
        return orig(texts)

    client.embed_batch = counting_batch
    try:
        doc = app.ingestion_service.ingest(
            "notes.txt", "the recall engine certifies exactness on gpu", "file"
        )
        assert calls["batch"] == 1
        resp = app.search_service.search("certifies exactness", top_k=3)
        assert resp.citations
        assert resp.citations[0].document_id == doc.document_id
    finally:
        client.embed_batch = orig


def test_app_provider_switch_builds_local_client():
    from omni_recall_tpu.config import AppConfig
    from omni_recall_tpu.server.app import OmniRecallApp

    config = AppConfig()
    config.embeddings.provider = "Local"
    config.embeddings.dim = 24
    # tiny encoder via checkpoint-less default would be 32k-vocab; keep the
    # wiring test light by just asserting the client type
    app = OmniRecallApp(config)
    assert type(app.embedding_client).__name__ == "LocalEncoderEmbeddingClient"
