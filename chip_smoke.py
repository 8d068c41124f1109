#!/usr/bin/env python3
"""Smoke run of the search engine on NVIDIA GPUs: the quickest proof that the
system still starts, compiles and answers exactly on the card.

    python chip_smoke.py              # one card
    python chip_smoke.py --shards 4   # Engine:Shards=4 over four cards

One card, in order (any failure fails the run):

1. the chip-marked tests (``pytest -m chip``) in a child process, before
   this process touches JAX (a JAX process reserves most of the card's
   memory); then the card's name and power limit, JAX's version and
   ``device_kind``, and the native host rescorer (required);
2. each scan term set (ops/scan.py) compiled for the card at real widths
   (N=2^20 rows, d=768, 2048 bloom bits, B=1536) and compared once with
   the XLA scan: bounds within SCAN_ATOL, candidate rows identical except
   among bounds tied within it, every bound >= the float64 score of its
   row;
3. the default configuration (f32 storage, ``backend=xla``, keyword-only
   queries) served by the real threaded WSGI server on localhost over a
   2^20-chunk corpus made from ``--seed``: every response equals the
   float64 oracle's (ranked citations and 4-decimal scores);
4. the serving profile (int8 scan, coarse prepass, direct select,
   device-exact cosine) served the same way: hybrid queries, keyword-only
   queries, an upload and a search that finds it, and one batch of 1536;
   every result equals the oracle's, and the device double-float dot is
   bit-identical to its numpy mirror over the batch's gathered rows;
5. the Triton scan kernel timed against the XLA scan (kernel, XLA, XLA,
   kernel) at B=448 and B=1536, then one served batch of 1536 each way.

``--shards 4`` runs only the multi-device path and what it is compared
with: phases 3 and 4 at 2^22 rows (2^20 per card) on a 1-D mesh of four
cards, with each card's bytes of every plane.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the run fails before it prints any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
import uuid

REPO = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 1 << 20
DIM = 768
BLOOM_BITS = 2048
BATCH = 1536
SCAN_ATOL = 1e-6  # kernel vs XLA bounds: f32 epilogue rounding and FMA


class SmokeFailure(Exception):
    pass


def log(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    """``name, power.limit`` of every card, from nvidia-smi (a child that
    stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---- phase 1: chip tests ----


def phase_chip_tests() -> None:
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "chip", "-p", "no:xdist",
         "-p", "no:cacheprovider", "-rs", "tests/"],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    log("chip tests:", tail[0])
    if proc.returncode != 0:
        log(proc.stdout[-4000:], proc.stderr[-2000:])
    check(proc.returncode == 0, f"chip tests exited {proc.returncode}")
    passed = [w for w in tail[0].replace(",", " ").split()]
    n_passed = int(passed[passed.index("passed") - 1]) if "passed" in passed else 0
    check(n_passed >= 1, "no chip test passed on the card")


# ---- phase 2: kernels at real widths ----


def make_scan_operands(key, n: int, d: int, bits: int, b: int):
    """Random index planes and queries on the device at real widths: int8
    rows with their dequant scale, sparse bloom words, sparse keyword
    weights. Returns (planes dict, queries dict)."""
    import jax
    import jax.numpy as jnp

    k = jax.random.split(key, 8)
    emb8 = jax.random.randint(k[0], (n, d), -127, 128, jnp.int32).astype(jnp.int8)
    e = emb8.astype(jnp.float32)
    scale = 1.0 / jnp.sqrt(jnp.sum(e * e, axis=1))
    w = bits // 8
    byte = lambda kk: jax.random.randint(kk, (n, w), 0, 256, jnp.int32)
    bloom = (byte(k[1]) & byte(k[2]) & byte(k[3])).astype(jnp.uint8)
    created = jax.random.uniform(k[4], (n,), jnp.float32, 0.0, 365.0)
    q = jax.random.normal(k[5], (b, d), jnp.float32)
    q = q / jnp.linalg.norm(q, axis=1, keepdims=True)
    pos = jax.random.randint(k[6], (b, 8), 0, bits)
    kw = jnp.zeros((b, bits), jnp.float32).at[jnp.arange(b)[:, None], pos].set(0.125)
    planes = dict(emb8=emb8, scale=scale, err=jnp.full((n,), 1e-6, jnp.float32),
                  bloom=bloom, created=created, valid=jnp.ones((n,), bool))
    queries = dict(q=q, kw=kw, kb=jnp.zeros((b,), jnp.float32))
    return planes, queries


def _operands(terms, planes, queries):
    import jax.numpy as jnp

    from omni_recall_tpu.ops import scan

    return scan.scan_operands(
        terms, planes["emb8"], planes["bloom"], planes["scale"], planes["err"],
        planes["created"], planes["valid"], queries["q"], queries["kw"],
        queries["kb"], jnp.float32(365.0), jnp.int32(0),
    )


SCAN_DEPTH = {"cos_kw": 4, "cos": 2, "kw": 4}


def compare_scans(terms, ref, got, planes, queries, n_oracle: int = 16) -> None:
    """Kernel result ``got`` against the XLA scan ``ref`` and the float64
    oracle, at the tolerances of the module docstring."""
    import numpy as np

    from omni_recall_tpu.ops.oracle import COSINE_WEIGHT, KEYWORD_WEIGHT

    rv, ri = (np.asarray(x) for x in ref)
    gv, gi = (np.asarray(x) for x in got)
    check(rv.shape == gv.shape and ri.shape == gi.shape, f"{terms}: shapes differ")
    check(bool(np.all(np.isfinite(gv))), f"{terms}: non-finite bounds")
    dv = float(np.max(np.abs(rv - gv)))
    check(dv <= SCAN_ATOL, f"{terms}: bounds differ by {dv}")
    swapped = ri != gi
    # a differing row is a tie swap: the XLA scan's bound for that slot
    # equals the kernel's within the tolerance (checked above) and the
    # kernel's row appears in the XLA scan's slice at a tied bound
    tie_ok = True
    for s, b, r in zip(*np.nonzero(swapped)):
        hit = np.nonzero(ri[s, b] == gi[s, b, r])[0]
        if hit.size == 0 or abs(rv[s, b, hit[0]] - gv[s, b, r]) > SCAN_ATOL:
            tie_ok = False
            break
    check(tie_ok, f"{terms}: candidate rows differ beyond ties")
    # soundness: every emitted bound >= the float64 score of its row
    t = gv.shape[2] - 1
    emb8 = planes["emb8"]
    scale = np.asarray(planes["scale"], np.float64)
    bloom = np.asarray(planes["bloom"])
    created = np.asarray(planes["created"], np.float64)
    q = np.asarray(queries["q"], np.float32)
    kw = np.asarray(queries["kw"], np.float64)
    worst = np.inf
    for b in range(n_oracle):
        rows = gi[:, b, :t].reshape(-1)
        bounds = gv[:, b, :t].reshape(-1).astype(np.float64)
        score = 0.1 * np.exp(np.minimum(created[rows] - 365.0, 0.0) / 30.0)
        if "cos" in terms:
            c = (np.asarray(emb8[rows], np.float32) * scale[rows, None].astype(np.float32))
            dot = np.sum((c * q[b]).astype(np.float64), axis=1)
            nrm = np.sqrt(np.sum((c * c).astype(np.float64), axis=1))
            score += COSINE_WEIGHT * dot / (nrm * np.linalg.norm(q[b].astype(np.float64)))
        if "kw" in terms:
            word = bloom[rows]
            bitsv = np.concatenate([(word >> p) & 1 for p in range(8)], axis=1)
            score += KEYWORD_WEIGHT * np.minimum(1.0, bitsv @ kw[b])
        worst = min(worst, float(np.min(bounds - score)))
    check(worst >= 0.0, f"{terms}: a bound is below its row's float64 score by {-worst}")
    log(f"  {terms}: max |kernel - xla| {dv:.3g}, tie swaps {int(swapped.sum())}, "
        f"min(bound - f64 score) {worst:.4g} over {n_oracle} queries")


def phase_kernels(seed: int) -> None:
    import jax

    from omni_recall_tpu.ops import routes, scan

    route = routes.current()
    check(route.scan is not scan.scan_xla, "the GPU route runs the XLA scan")
    planes, queries = make_scan_operands(
        jax.random.PRNGKey(seed), N_ROWS, DIM, BLOOM_BITS, BATCH
    )
    sub = scan.scan_slice(N_ROWS)
    for terms in scan.TERM_SETS:
        ops = _operands(terms, planes, queries)
        t = SCAN_DEPTH[terms]
        t0 = time.perf_counter()
        compiled = route.scan.lower(*ops, terms=terms, sub=sub, t=t).compile()
        log(f"  {terms}: compiled in {time.perf_counter() - t0:.1f} s; "
            f"memory {compiled.memory_analysis()}")
        got = compiled(*ops)
        ref = scan.scan_xla(*ops, terms=terms, sub=sub, t=t)
        compare_scans(terms, ref, got, planes, queries)


# ---- phases 3 and 4: served through the HTTP server ----


class Server:
    """The app behind the real threaded WSGI server on a free localhost
    port."""

    def __init__(self, app) -> None:
        from wsgiref.simple_server import make_server

        from omni_recall_tpu.server.__main__ import ThreadingWSGIServer

        self.httpd = make_server("127.0.0.1", 0, app, server_class=ThreadingWSGIServer)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def post_json(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    def upload(self, name: str, text: str) -> dict:
        boundary = uuid.uuid4().hex
        body = (
            f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{name}\"\r\nContent-Type: text/plain\r\n\r\n{text}\r\n"
            f"--{boundary}--\r\n"
        ).encode()
        req = urllib.request.Request(
            self.url + "/api/documents/upload", data=body, method="POST",
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
        )
        with urllib.request.urlopen(req, timeout=600) as resp:
            check(resp.status == 201, f"upload answered {resp.status}")
            return json.loads(resp.read())

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)


def _dto(hits) -> list[tuple[str, float]]:
    return [(h.chunk.id, round(h.score, 4)) for h in hits]


def served_search(server, app, corpus, query, emb, k, window) -> list:
    """One /api/recall/search request, checked against the oracle."""
    from datetime import datetime, timezone

    from omni_recall_tpu.eval.synthetic import oracle_search

    now = datetime.now(timezone.utc)
    resp = server.post_json("/api/recall/search", {"query": query, "topK": k})
    got = [(c["chunkId"], c["score"]) for c in resp["citations"]]
    extra = app.store.get_recent_chunks(1 << 30)
    want = _dto(oracle_search(corpus, extra, query, emb, k, window, now))
    check(got == want, f"search {query!r}: served {got} != oracle {want}")
    return got


def _build(options, n: int, seed: int, mesh=None):
    from omni_recall_tpu.eval.synthetic import build_engine

    t0 = time.perf_counter()
    engine, corpus = build_engine(options, n, seed=seed, mesh=mesh)
    log(f"  corpus of {n} rows built and placed in {time.perf_counter() - t0:.1f} s")
    return engine, corpus


def print_plane_bytes(engine) -> None:
    dev = engine.device_index.device_arrays()
    for f in dataclasses.fields(dev):
        arr = getattr(dev, f.name)
        if arr is None:
            continue
        per = {}
        for s in arr.addressable_shards:
            per[str(s.device)] = per.get(str(s.device), 0) + s.data.nbytes
        log(f"  plane {f.name}: " + ", ".join(f"{d} {b}" for d, b in sorted(per.items())))


def phase_serve_default(seed: int, n: int, shards: int) -> None:
    """Phase 3: the default configuration (xla backend, f32 storage,
    recent window, no embedding provider: keyword-only queries)."""
    import numpy as np

    from omni_recall_tpu.config import load_config
    from omni_recall_tpu.server.app import build_app

    config = load_config(overrides={"Engine:Shards": str(shards)} if shards else None)
    check(config.engine.backend == "xla", "the default backend is not xla")
    mesh = _mesh(shards)
    engine, corpus = _build(config.engine, n, seed, mesh)
    if mesh is not None:
        print_plane_bytes(engine)
    app = build_app(config, store=engine.store, engine=engine)
    server = Server(app)
    try:
        rng = np.random.default_rng(seed)
        window = config.engine.recent_window
        for i in range(4):
            token = corpus.cluster_token(int(rng.integers(corpus.n_clusters)))
            query = f"{token} synthetic" if i % 2 else token
            t0 = time.perf_counter()
            got = served_search(server, app, corpus, query, None, 5, window)
            log(f"  default search {query!r}: {len(got)} citations equal the oracle "
                f"({(time.perf_counter() - t0) * 1e3:.1f} ms incl. oracle)")
    finally:
        server.close()
    log("  engine stats:", json.dumps(engine.stats))


def _mesh(shards: int):
    if not shards:
        return None
    from omni_recall_tpu.parallel.mesh import shards_mesh

    return shards_mesh(shards)


def serving_options(n: int, shards: int):
    from omni_recall_tpu.config import EngineOptions

    return EngineOptions(
        backend="pallas", shards=shards, embedding_dim=DIM, recent_window=0,
        candidate_m=128, bloom_bits=BLOOM_BITS, scan_dtype="int8",
        capacity_block=max(8192, n // 64),
        device_exact_cos=True, direct_select=True,
    )


def dd_parity(engine, reqs) -> None:
    """Device double-float dot vs its numpy float32 mirror, bit for bit,
    over each query's top-32 scan rows."""
    import jax.numpy as jnp
    import numpy as np

    from omni_recall_tpu.ops import exact_cos, scan

    dix = engine.device_index
    dev = dix.device_arrays()
    q = np.stack([r[1] for r in reqs]).astype(np.float32)
    n = dev.emb.shape[0]
    b = q.shape[0]
    _, idxs = scan.score_topm(
        dev.emb, dev.scale, dev.err, None, dev.created, dev.valid,
        jnp.asarray(q), jnp.zeros((b, dix.bloom_bits), jnp.float32),
        jnp.zeros((b,), jnp.float32), jnp.float32(365.0), jnp.int32(0),
        terms="cos", m=32, t=2, sub=scan.scan_slice(n), scan=engine.route.scan,
    )
    rows = np.asarray(idxs)[:, :32]
    check(bool(np.all(rows >= 0)), "DD parity: fewer than 32 candidates")
    hi, lo, _ = exact_cos.exact_cos_rows(dev.raw, jnp.asarray(rows), jnp.asarray(q))
    raw = dix.raw_emb[rows]
    want_hi, want_lo = exact_cos.dd_sum_products_np(q[:, None, :], raw)
    hi, lo = np.asarray(hi), np.asarray(lo)
    bad = int(np.sum((hi.view(np.uint32) != want_hi.view(np.uint32))
                     | (lo.view(np.uint32) != want_lo.view(np.uint32))))
    log(f"  DD parity over {rows.size} gathered rows: {bad} differ from the numpy mirror")
    check(bad == 0, "DD hi/lo differ from the numpy float32 mirror")


def phase_serve_profile(seed: int, n: int, shards: int, timing: bool) -> None:
    """Phase 4: the serving profile, and (one card) phase 5's served-batch
    timing on the same engine."""
    import numpy as np

    from omni_recall_tpu.config import load_config
    from omni_recall_tpu.eval.synthetic import (
        CorpusEmbeddingClient,
        make_requests,
        oracle_search,
    )
    from omni_recall_tpu.server.app import build_app

    config = load_config(overrides={"Embeddings:Dim": str(DIM)})
    config.engine = serving_options(n, shards)
    engine, corpus = _build(config.engine, n, seed, _mesh(shards))
    if shards:
        print_plane_bytes(engine)
    client = CorpusEmbeddingClient(corpus)
    app = build_app(config, store=engine.store, engine=engine,
                    embedding_client=client)
    server = Server(app)
    try:
        rng = np.random.default_rng(seed + 1)
        for _ in range(4):
            cluster = int(rng.integers(corpus.n_clusters))
            token = corpus.cluster_token(cluster)
            t0 = time.perf_counter()
            got = served_search(server, app, corpus, token,
                                corpus.centers[cluster], 10, 0)
            log(f"  hybrid search {token!r}: {len(got)} citations equal the oracle "
                f"({(time.perf_counter() - t0) * 1e3:.1f} ms incl. oracle)")
        up = server.upload("smoke-note.txt",
                           "zebra quartz lantern: a note uploaded during the smoke run.")
        query = "zebra quartz lantern"
        got = served_search(server, app, corpus, query,
                            client.embed(query).vector, 5, 0)
        top = app.store.get_chunks_by_document_id(up["documentId"])
        check(bool(got) and got[0][0] in {c.id for c in top},
              f"the uploaded document is not the top hit: {got[:2]}")
        log(f"  upload {up['documentId']} found first by {query!r}; results equal the oracle")
    finally:
        server.close()
    # keyword-only queries (no embedding) and one full batch, below the
    # HTTP layer on the same served engine
    extra = app.store.get_recent_chunks(1 << 30)
    reqs = make_requests(corpus, seed + 2, BATCH)
    kw_reqs = [(token, None, 10) for token, _, _ in reqs[:8]]
    res = engine.search_batch(kw_reqs, now=corpus.now)
    for (token, _, k), hits in zip(kw_reqs, res):
        want = _dto(oracle_search(corpus, extra, token, None, k, 0, corpus.now))
        check(_dto(hits) == want, f"keyword-only {token!r}: {_dto(hits)} != {want}")
    log(f"  {len(kw_reqs)} keyword-only searches equal the oracle")
    t0 = time.perf_counter()
    res = engine.search_batch(reqs, now=corpus.now)
    log(f"  search_batch B={len(reqs)}: {time.perf_counter() - t0:.2f} s (first call)")
    for i in range(0, len(reqs), max(1, len(reqs) // 16)):
        token, emb, k = reqs[i]
        want = _dto(oracle_search(corpus, extra, token, emb, k, 0, corpus.now))
        check(_dto(res[i]) == want, f"batch query {i}: {_dto(res[i])} != {want}")
    check(all(len(h) == 10 for h in res), "a batch query returned fewer than 10 hits")
    log(f"  batch B={len(reqs)}: {len(range(0, len(reqs), max(1, len(reqs) // 16)))} "
        "sampled queries equal the oracle")
    log("  engine stats:", json.dumps(engine.stats))
    if not shards:
        dd_parity(engine, reqs)
    if timing:
        time_served_batch(engine, reqs, corpus.now)


# ---- phase 5: kernel vs XLA scan ----


def _timed(fn, reps: int = 5) -> float:
    """Median wall time (ms) of fn() after one warm call; fn blocks."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


def phase_scan_timing(seed: int, card: str) -> None:
    import jax

    from omni_recall_tpu.ops import routes, scan

    kernel = routes.current().scan
    sub = scan.scan_slice(N_ROWS)
    for b in (448, BATCH):
        planes, queries = make_scan_operands(
            jax.random.PRNGKey(seed), N_ROWS, DIM, BLOOM_BITS, b
        )
        for terms in scan.TERM_SETS:
            ops = _operands(terms, planes, queries)
            t = SCAN_DEPTH[terms]
            runs = {}
            for name, impl in (("kernel", kernel), ("xla", scan.scan_xla),
                               ("xla", scan.scan_xla), ("kernel", kernel)):
                ms = _timed(lambda: jax.block_until_ready(
                    impl(*ops, terms=terms, sub=sub, t=t)))
                runs.setdefault(name, []).append(ms)
            log(f"  scan {terms} N={N_ROWS} d={DIM} B={b} t={t}: "
                f"kernel {runs['kernel']} ms, xla {runs['xla']} ms [{card}]")
        del planes, queries


def time_served_batch(engine, reqs, now) -> None:
    """One served batch each way, the route's scan entry swapped in place."""
    from omni_recall_tpu.ops import scan

    kernel_route = engine.route
    xla_route = dataclasses.replace(kernel_route, scan=scan.scan_xla)
    runs = {}
    for name, route in (("kernel", kernel_route), ("xla", xla_route),
                        ("xla", xla_route), ("kernel", kernel_route)):
        engine.route = route
        runs.setdefault(name, []).append(
            _timed(lambda: engine.search_batch(reqs, now=now), reps=3))
    engine.route = kernel_route
    log(f"  served batch B={len(reqs)}: kernel {runs['kernel']} ms, "
        f"xla {runs['xla']} ms [{card_line()}]")
    trace_served_batch(engine, reqs, now)


def trace_served_batch(engine, reqs, now) -> None:
    """Profile one served batch and print the device time per operation
    (the largest first)."""
    import glob
    import tempfile

    import jax

    per: dict[str, float] = {}
    with tempfile.TemporaryDirectory(dir=REPO) as out:
        with jax.profiler.trace(out):
            engine.search_batch(reqs, now=now)
        for path in glob.glob(os.path.join(out, "plugins", "profile", "*", "*.xplane.pb")):
            for plane in jax.profiler.ProfileData.from_file(path).planes:
                if not plane.name.startswith("/device:GPU"):
                    continue
                for line in plane.lines:
                    for ev in line.events:
                        per[ev.name] = per.get(ev.name, 0.0) + ev.duration_ns
    check(bool(per), "the trace of a served batch holds no device operation")
    total = sum(per.values())
    log(f"  trace of one served batch: {total / 1e6:.2f} ms of device operations "
        "(summed over streams)")
    for name, ns in sorted(per.items(), key=lambda kv: -kv[1])[:15]:
        log(f"    {ns / 1e6:9.3f} ms  {name[:100]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shards", type=int, default=0,
                        help="run only the Engine:Shards=N path over N cards")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not os.path.isdir(os.path.join(REPO, "omni_recall_tpu")):
        log("chip_smoke: the omni_recall_tpu package is not beside this script")
        return 2
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError) as exc:
        log(f"chip_smoke: no NVIDIA GPU visible ({exc})")
        return 2
    if not args.shards:
        phase_chip_tests()

    import jax

    from omni_recall_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        log(f"chip_smoke: JAX found no GPU (platform {platform!r})")
        return 2
    from omni_recall_tpu.ops import native

    log(card)
    log(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}")
    log(f"native host rescorer: {native.rescore_available()}")
    check(native.rescore_available(), "the native host rescorer did not load")
    if args.shards:
        check(len(devices) >= args.shards, f"{len(devices)} cards < --shards {args.shards}")
        n = N_ROWS * args.shards
        log(f"phase 3 x{args.shards}: default configuration, {n} rows")
        phase_serve_default(args.seed, n, args.shards)
        gc.collect()
        log(f"phase 4 x{args.shards}: serving profile, {n} rows")
        phase_serve_profile(args.seed, n, args.shards, timing=False)
    else:
        log("phase 2: scan kernels at real widths")
        phase_kernels(args.seed)
        gc.collect()
        log("phase 3: default configuration served over HTTP")
        phase_serve_default(args.seed, N_ROWS, 0)
        gc.collect()
        log("phase 4: serving profile served over HTTP (+ phase 5 served batch)")
        phase_serve_profile(args.seed, N_ROWS, 0, timing=True)
        gc.collect()
        log("phase 5: scan kernel vs XLA scan")
        phase_scan_timing(args.seed, card)
    log(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        log(f"chip_smoke FAILED: {exc}")
        sys.exit(1)
