"""Native (C) keyword rescorer: builds, and matches the Python oracle
exactly on randomized inputs including unicode and embedded edge cases."""

import random
import string

import pytest

from omni_recall_tpu.ops import native, oracle


@pytest.fixture(scope="module")
def lib_available():
    ok = native.native_available()
    if not ok:
        pytest.skip("no C toolchain in this environment")
    return ok


def _native_kw(terms, content):
    scores = native.keyword_scores(
        [t.encode("utf-8") for t in terms], [content.lower().encode("utf-8")]
    )
    assert scores is not None
    return scores[0]


def test_native_builds_and_basic_scores(lib_available):
    terms = oracle.query_terms("optim gpu missing")
    content = "great optimization tips for gpu kernels"
    assert _native_kw(terms, content) == pytest.approx(2 / 3)


def test_native_matches_oracle_randomized(lib_available):
    rng = random.Random(99)
    vocab = ["".join(rng.choices(string.ascii_lowercase, k=rng.randint(1, 9))) for _ in range(100)]
    vocab += ["naïve", "café", "日本語", "ünïcode"]
    for trial in range(300):
        content = " ".join(rng.choices(vocab, k=rng.randint(0, 40)))
        query = " ".join(rng.choices(vocab, k=rng.randint(1, 5)))
        terms = oracle.query_terms(query)
        expected = oracle.keyword_score(query, content)
        if not content.strip():
            expected = 0.0
        got = _native_kw(terms, content) if terms else 0.0
        assert got == pytest.approx(expected, abs=1e-12), (query, content)


def test_native_batch_multiple_contents(lib_available):
    terms = ["cat", "dog"]
    contents = [b"the cat sat", b"dogs and cats everywhere", b"", b"nothing here"]
    scores = native.keyword_scores([t.encode() for t in terms], contents)
    assert scores == pytest.approx([0.5, 1.0, 0.0, 0.0])


def test_native_embedded_nul_and_long_content(lib_available):
    content = ("word " * 500 + "\x00hidden needle").lower().encode("utf-8")
    scores = native.keyword_scores([b"needle", b"absent!"], [content])
    assert scores == pytest.approx([0.5])


def test_engine_uses_cached_lower_utf8():
    from omni_recall_tpu.index.records import ChunkRecord

    c = ChunkRecord(id="x", document_id="d", chunk_index=0, content="HeLLo Wörld")
    assert c.content_lower_utf8() == "hello wörld".encode("utf-8")
    assert c.content_lower_utf8() is c.content_lower_utf8()  # cached


def test_native_multi_query_batch(lib_available):
    from omni_recall_tpu.ops import native

    # query 0: terms [cat, dog]; query 1: terms [fish]
    terms = [b"cat", b"dog", b"fish"]
    offsets = [0, 2, 3]
    contents = [b"the cat sat", b"fish are wet", b"cat dog fish", b""]
    content_query = [0, 1, 0, 1]
    scores = native.keyword_scores_multi(contents, content_query, terms, offsets)
    assert scores is not None
    import pytest as _pytest
    assert scores == _pytest.approx([0.5, 1.0, 1.0, 0.0])


def test_native_multi_matches_single(lib_available):
    import random, string
    from omni_recall_tpu.ops import native, oracle

    rng = random.Random(7)
    vocab = ["".join(rng.choices(string.ascii_lowercase, k=rng.randint(2, 7))) for _ in range(40)]
    queries = [" ".join(rng.choices(vocab, k=rng.randint(1, 4))) for _ in range(5)]
    term_lists = [oracle.query_terms(q) for q in queries]
    contents, cq = [], []
    for qi in range(5):
        for _ in range(8):
            contents.append(" ".join(rng.choices(vocab, k=10)).encode())
            cq.append(qi)
    flat_terms, offsets = [], [0]
    for ts in term_lists:
        flat_terms.extend(t.encode() for t in ts)
        offsets.append(len(flat_terms))
    multi = native.keyword_scores_multi(contents, cq, flat_terms, offsets)
    for i, (content, qi) in enumerate(zip(contents, cq)):
        single = native.keyword_scores([t.encode() for t in term_lists[qi]], [content])
        assert multi[i] == single[0]


def test_native_chunk_signatures_match_python(lib_available):
    import random, string
    import numpy as np
    from omni_recall_tpu.ops import hashing, native

    rng = random.Random(13)
    contents = []
    for _ in range(60):
        words = ["".join(rng.choices(string.ascii_lowercase + "0123456789", k=rng.randint(1, 12)))
                 for _ in range(rng.randint(0, 30))]
        contents.append(" ".join(words))
    contents += ["", "   ", "a", "x\ty\nz"]
    for bits, ngram, hashes in ((1024, 4, 1), (512, 4, 2), (256, 2, 1)):
        native_sigs = native.chunk_signatures(
            [c.encode("ascii") for c in contents], bits, ngram, hashes
        )
        for i, c in enumerate(contents):
            expected = hashing.chunk_signature(c, bits, ngram, hashes)
            np.testing.assert_array_equal(native_sigs[i], expected, err_msg=repr(c))


def test_signatures_batch_routes_non_ascii_to_python():
    import numpy as np
    from omni_recall_tpu.ops import hashing

    contents = ["plain ascii text", "unicodé contênt", "日本語テキスト"]
    batch = hashing.chunk_signatures_batch(contents, 256, 4, 1)
    for i, c in enumerate(contents):
        np.testing.assert_array_equal(
            batch[i], hashing.chunk_signature(c, 256, 4, 1), err_msg=c
        )


def test_native_query_bit_weights_batch_bit_identical():
    """The native batched weight builder must match the Python builder
    bit-for-bit (soundness: device keyword bounds derive from these)."""
    import numpy as np

    from omni_recall_tpu.ops import hashing, native

    if not native.native_available():
        import pytest

        pytest.skip("no native lib")
    import random
    import string

    rng = random.Random(7)
    term_lists = []
    for _ in range(64):
        n_terms = rng.randint(0, 6)
        term_lists.append([
            "".join(rng.choices(string.ascii_lowercase + string.digits,
                                k=rng.randint(1, 24)))
            for _ in range(n_terms)
        ])
    term_lists.append(["x"])                     # single char
    term_lists.append(["ab"])                    # 2-gram only
    term_lists.append(["a" * 40])                # >16 grams: sampled
    term_lists.append(["dup", "dup"])            # duplicate terms
    for bits, ngram, hashes in ((256, 4, 1), (1024, 4, 2), (520, 3, 3)):
        w_batch, b_batch = hashing.query_bit_weights_batch(
            term_lists, bits, ngram, hashes
        )
        for i, terms in enumerate(term_lists):
            w_ref, b_ref = hashing.query_bit_weights(terms, bits, ngram, hashes)
            assert np.array_equal(w_batch[i], w_ref), (i, terms, bits)
            assert b_batch[i] == b_ref, (i, terms)


def test_native_query_bit_weights_many_hashes_bit_identical():
    """n_hashes > 8 must run EVERY probe (the native builder once silently
    capped at 8, diverging from ops/hashing.query_bit_weights)."""
    import random
    import string

    import numpy as np

    from omni_recall_tpu.ops import hashing, native

    if not native.native_available():
        import pytest

        pytest.skip("no C toolchain")
    rng = random.Random(9)
    term_lists = [
        ["hello", "world"],
        ["quantization", "soundness"],
        ["a" * 40],  # sampled grams
        [
            "".join(rng.choices(string.ascii_lowercase, k=rng.randint(1, 20)))
            for _ in range(4)
        ],
    ]
    for hashes in (9, 12, 16):
        out = native.query_bit_weights_batch(
            [[t.encode("ascii") for t in ts] for ts in term_lists],
            1024, 3, hashes,
        )
        assert out is not None
        w_n, b_n = out
        for i, ts in enumerate(term_lists):
            w_p, b_p = hashing.query_bit_weights(ts, 1024, 3, hashes)
            assert np.array_equal(w_n[i], w_p), (i, ts, hashes)
            assert b_n[i] == b_p, (i, ts, hashes)
