"""Opt-in live-provider smoke tests (VERDICT r4 #7).

Mirror of the reference's self-skipping live integration test
(tests/OmniRecall.Api.Tests/Integration/AzureIngestionIntegrationTests.cs:13-15:
read env config, return early when unconfigured): when ``GEMINI_API_KEY``
is set, round-trip ONE real embed and ONE real chat against the Gemini API;
skip cleanly otherwise (CI and the zero-egress dev image always skip).
``GITHUB_MODELS_TOKEN`` gates the GitHub Models chat round trip the same
way.

Every other provider test in this suite uses scripted transports — these
are the only tests that can catch real wire-format drift. The wire
contracts they pin:

- Gemini embedContent (GeminiEmbeddingClient.cs:29-40 semantics):
  ``POST {base}/models/{model}:embedContent?key=...`` with
  ``{"content": {"parts": [{"text": ...}]}}`` (+ ``outputDimensionality``
  on models that support it) -> ``{"embedding": {"values": [float...]}}``.
- Gemini generateContent (GeminiChatClient.cs:37-53 semantics):
  ``POST {base}/models/{model}:generateContent?key=...`` with
  ``{"contents": [{"parts": [{"text": ...}]}]}`` ->
  ``candidates[0].content.parts[].text``.
- GitHub Models (GitHubModelsChatClient.cs:24-38 semantics): OpenAI-style
  ``POST {base}/chat/completions`` with Bearer auth ->
  ``choices[0].message.content`` (string or text-part array).
"""

from __future__ import annotations

import os

import pytest

_GEMINI_KEY = os.environ.get("GEMINI_API_KEY", "").strip()
_GH_TOKEN = os.environ.get("GITHUB_MODELS_TOKEN", "").strip()


@pytest.mark.skipif(not _GEMINI_KEY, reason="GEMINI_API_KEY not set")
def test_live_gemini_embed_round_trip():
    from omni_recall_tpu.config import GeminiOptions
    from omni_recall_tpu.ingest.embedding import (
        EmbeddingStatus,
        GeminiEmbeddingClient,
    )

    client = GeminiEmbeddingClient(
        GeminiOptions(api_key=_GEMINI_KEY), output_dim=768
    )
    result = client.embed("GPU tensor cores multiply matrices.")
    # RateLimited is a legitimate live outcome (free-tier quota) — the
    # never-throw contract still holds; anything else must be a SUCCESS
    # with a usable, finite vector of the requested dimensionality
    if result.status == EmbeddingStatus.RATE_LIMITED:
        pytest.skip("live API rate-limited (contract still honored)")
    assert result.status == EmbeddingStatus.SUCCESS, (
        result.status, result.message
    )
    assert len(result.vector) == 768
    assert all(isinstance(v, float) for v in result.vector[:8])
    assert any(v != 0.0 for v in result.vector)


@pytest.mark.skipif(not _GEMINI_KEY, reason="GEMINI_API_KEY not set")
def test_live_gemini_chat_round_trip():
    from omni_recall_tpu.chat.providers import GeminiChatClient
    from omni_recall_tpu.chat.router import AiRateLimitError
    from omni_recall_tpu.contracts import AiChatRequest
    from omni_recall_tpu.config import GeminiOptions

    client = GeminiChatClient(GeminiOptions(api_key=_GEMINI_KEY))
    try:
        response = client.complete(
            AiChatRequest("Reply with the single word: pong")
        )
    except AiRateLimitError:
        pytest.skip("live API rate-limited (contract still honored)")
    assert response.provider == "gemini"
    assert response.model  # the model chain resolved to a concrete model
    assert response.text and response.text.strip()


@pytest.mark.skipif(not _GH_TOKEN, reason="GITHUB_MODELS_TOKEN not set")
def test_live_github_models_chat_round_trip():
    from omni_recall_tpu.chat.providers import GitHubModelsChatClient
    from omni_recall_tpu.chat.router import AiRateLimitError
    from omni_recall_tpu.contracts import AiChatRequest
    from omni_recall_tpu.config import GitHubModelsOptions

    client = GitHubModelsChatClient(GitHubModelsOptions(token=_GH_TOKEN))
    try:
        response = client.complete(
            AiChatRequest("Reply with the single word: pong")
        )
    except AiRateLimitError:
        pytest.skip("live API rate-limited (contract still honored)")
    assert response.provider == "github-models"
    assert response.text and response.text.strip()
