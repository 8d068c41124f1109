"""Ingestion-at-scale micro-benchmark (BASELINE.json config 2): measures the
index append pipeline — native bloom signature construction, normalization,
host mirror writes, and the quantized device upload — in chunks/second.
Run: PYTHONPATH=. python tools/bench_ingest.py"""

from __future__ import annotations

import time
from datetime import timedelta

import numpy as np

from omni_recall_tpu.index.device_index import EPOCH, DeviceIndex
from omni_recall_tpu.index.records import ChunkRecord


def main(n: int = 100_000, d: int = 768) -> None:
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n, d), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    words = [f"word{i}" for i in range(5000)]
    contents = [
        " ".join(words[(i * 7 + j) % 5000] for j in range(100)) for i in range(200)
    ]
    when = EPOCH + timedelta(days=1)
    chunks = [
        ChunkRecord(
            id=f"c:{i}", document_id=f"doc_{i % 500}", chunk_index=i,
            content=contents[i % 200], embedding=emb[i].tolist(),
            created_at_utc=when, seq=i,
        )
        for i in range(n)
    ]

    for scan_dtype in ("f32", "int8"):
        dix = DeviceIndex(d, capacity_block=16384, bloom_bits=1024, scan_dtype=scan_dtype)
        t0 = time.perf_counter()
        dix.append(chunks)
        append_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev = dix.device_arrays()
        import jax

        jax.block_until_ready(dev.emb)
        upload_s = time.perf_counter() - t0
        print(
            f"{scan_dtype}: append {n / append_s:,.0f} chunks/s "
            f"({append_s:.2f}s), device upload {upload_s:.2f}s "
            f"-> end-to-end {n / (append_s + upload_s):,.0f} chunks/s",
            flush=True,
        )


if __name__ == "__main__":
    main()
