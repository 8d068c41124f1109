"""Bloom signature soundness: kw_ub >= exact keyword score, always."""

import random
import string

import numpy as np

from omni_recall_tpu.ops import hashing, oracle

BLOOM_BITS = 1024
NGRAM = 4
HASHES = 1


def _kw_ub(terms, content_lower):
    weights, bias = hashing.query_bit_weights(terms, BLOOM_BITS, NGRAM, HASHES)
    sig = hashing.chunk_signature(content_lower, BLOOM_BITS, NGRAM, HASHES)
    bits = hashing.unpack_bits(sig, BLOOM_BITS)
    return min(1.0, float(bits @ weights) + bias)


def test_present_terms_always_fully_matched():
    content = "the quick brown fox jumps over the lazy dog"
    terms = oracle.query_terms("quick fox lazy")
    assert _kw_ub(terms, content) >= 1.0 - 1e-6


def test_substring_terms_matched():
    content = "great optimization tips for gpu kernels"
    # "optim" is a substring of "optimization"; "gpu" exact short token
    terms = oracle.query_terms("optim gpu")
    assert _kw_ub(terms, content) >= 1.0 - 1e-6


def test_short_terms_matched():
    content = "x y ab abc word"
    for q in ("x", "ab", "abc", "b", "bc"):
        terms = oracle.query_terms(q)
        exact = oracle.keyword_score(q, content)
        assert _kw_ub(terms, content) + 1e-6 >= exact, q


def test_randomized_soundness():
    rng = random.Random(42)
    vocab = ["".join(rng.choices(string.ascii_lowercase, k=rng.randint(1, 10))) for _ in range(200)]
    for trial in range(300):
        content = " ".join(rng.choices(vocab, k=rng.randint(3, 60)))
        n_terms = rng.randint(1, 6)
        terms_src = []
        for _ in range(n_terms):
            if rng.random() < 0.5:
                terms_src.append(rng.choice(vocab))
            else:
                # random junk term, possibly a substring of content
                w = rng.choice(vocab)
                lo = rng.randint(0, max(0, len(w) - 1))
                hi = rng.randint(lo + 1, len(w))
                terms_src.append(w[lo:hi] if rng.random() < 0.5 else
                                 "".join(rng.choices(string.ascii_lowercase, k=rng.randint(1, 8))))
        query = " ".join(terms_src)
        terms = oracle.query_terms(query)
        exact = oracle.keyword_score(query, content)
        ub = _kw_ub(terms, content)
        assert ub + 1e-6 >= exact, (query, content, exact, ub)


def test_weight_vector_sums_to_one_over_terms():
    terms = ["alpha", "beta", "gamma", "x"]
    weights, bias = hashing.query_bit_weights(terms, BLOOM_BITS, NGRAM, HASHES)
    # matching every bit yields at least 1.0 (exact kw is capped at 1)
    assert float(np.sum(weights)) + bias >= 1.0 - 1e-6


def test_signature_deterministic():
    a = hashing.chunk_signature("hello world", BLOOM_BITS, NGRAM, HASHES)
    b = hashing.chunk_signature("hello world", BLOOM_BITS, NGRAM, HASHES)
    assert np.array_equal(a, b)


def _kw_ub_cfg(terms, content_lower, bits, ngram, hashes):
    weights, bias = hashing.query_bit_weights(terms, bits, ngram, hashes)
    sig = hashing.chunk_signature(content_lower, bits, ngram, hashes)
    unpacked = hashing.unpack_bits(sig, bits)
    return min(1.0, float(unpacked @ weights) + bias)


def test_soundness_non_power_of_two_bits_multi_hash():
    """The double-hash probe must wrap mod 2^64 like the C builder: with
    unbounded Python ints, h1 + i*h2 diverges for every non-power-of-two
    bloom_bits once bloom_hashes >= 2, and a PRESENT term's upper bound
    dropped below its exact score (unsound certificate)."""
    for bits in (1528, 3072, 8000):
        for content in ("the quick brown fox", "alpha beta gamma delta"):
            for term in content.split():
                ub = _kw_ub_cfg([term], content, bits, 4, 2)
                assert ub >= 1.0 - 1e-6, (bits, term, ub)


def test_soundness_ngram_two():
    """ngram=2 signatures must contain 2-gram bits: the old length-dedupe
    skipped BOTH length-2 passes, leaving kw_ub = 0 for present terms."""
    content = "the quick brown fox"
    for term in ("quick", "brown", "ox"):
        ub = _kw_ub_cfg([term], content, BLOOM_BITS, 2, 1)
        assert ub >= 1.0 - 1e-6, (term, ub)


def test_native_builder_bit_identical_non_power_of_two():
    """C builder == Python builder for non-pow2 bits / multi-hash / ngram=2
    (the configs where the two previously diverged)."""
    from omni_recall_tpu.ops import native

    if not native.native_available():
        import pytest
        pytest.skip("native builder unavailable")
    contents = ["the quick brown fox", "pack my box with five dozen jugs"]
    for bits, ngram, hashes in ((1528, 4, 2), (3072, 2, 2), (8000, 3, 3)):
        py = np.stack([
            hashing.chunk_signature(c, bits, ngram, hashes) for c in contents
        ])
        nat = native.chunk_signatures(
            [c.encode() for c in contents], bits, ngram, hashes
        )
        np.testing.assert_array_equal(py, nat)
