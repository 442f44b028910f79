"""Multi-tenant scenario serving: the port's copy of the JAX package's
``serving/``.

The front-end layer over ``sweepd.py``'s resident single-shape engine:
shape-bucketed serving with a bounded LRU bucket cache and persisted
bucket-runner records (buckets.py), plus the request lifecycle —
admission control, deadlines, bounded retry, graceful drain, and
preemption-surviving long scenarios (frontend.py)."""

from .buckets import (                                      # noqa: F401
    BucketSpec, BucketLRU, quantize_shape, bucket_fingerprint,
    aot_blob_path, export_bucket_runner, make_aot_runner)
from .frontend import (                                     # noqa: F401
    FrontendConfig, ScenarioFrontend)

__all__ = [
    "BucketSpec", "BucketLRU", "quantize_shape",
    "bucket_fingerprint", "aot_blob_path", "export_bucket_runner",
    "make_aot_runner", "FrontendConfig", "ScenarioFrontend",
]
