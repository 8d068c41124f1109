"""Which implementation of each device stage runs on which platform.

The one place the program decides by platform. Keyed by
``jax.devices()[0].platform``:

- ``"gpu"``: the Triton scan kernel (ops/triton_scan.py), compiled;
- ``"cpu"``: the plain XLA scan (ops/scan.py scan_xla) — the tests' route
  and the reference the GPU kernel is compared with.

The refine stage (ops/refine.py refine_ub) and the double-float cosine
(ops/exact_cos.py dd_sum_products) are plain XLA on both. Any other
platform raises: nothing runs interpreted, and nothing quietly falls back
to a reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax


@dataclass(frozen=True)
class Route:
    platform: str
    scan: Callable    # ops/scan.py contract: (*operands, terms, sub, t)
    refine: Callable  # ops/refine.py refine_ub signature
    dd: Callable      # ops/exact_cos.py dd_sum_products signature


def for_platform(platform: str) -> Route:
    from omni_recall_tpu.ops import exact_cos, refine, scan

    if platform == "gpu":
        from omni_recall_tpu.ops import triton_scan

        return Route("gpu", triton_scan.scan_triton, refine.refine_ub,
                     exact_cos.dd_sum_products)
    if platform == "cpu":
        return Route("cpu", scan.scan_xla, refine.refine_ub,
                     exact_cos.dd_sum_products)
    raise RuntimeError(
        f"no device route for platform {platform!r} (supported: gpu, cpu)"
    )


def current() -> Route:
    """The route of the default device's platform."""
    return for_platform(jax.devices()[0].platform)
