"""Histogram-percentile helper (host side, stdlib only).

The port's copy of the JAX package's ``histutil.py``: the bucket-
percentile rank convention of the telemetry summaries
(``models/telemetry.py``), rank = min(k - 1, (k * p) // 100), the same
convention as percentiles over the expanded sorted sample, so a
unit-width-bucket histogram yields exactly the percentiles of the
underlying integer sample.  Kept torch- and numpy-free.
"""

from __future__ import annotations


def hist_percentiles(hist, pcts=(50, 90, 99)) -> dict:
    """{"p50": ..., ..., "count": k} percentile BUCKET values from
    bucket counts (bucket value = index).  All-zero histograms report
    count 0 and percentiles None."""
    counts = [int(c) for c in hist]
    k = sum(counts)
    out = {"count": k}
    if k == 0:
        out.update({f"p{p}": None for p in pcts})
        return out
    cum = []
    run = 0
    for c in counts:
        run += c
        cum.append(run)
    for p in pcts:
        rank = min(k - 1, (k * p) // 100)
        out[f"p{p}"] = next(i for i, c in enumerate(cum)
                            if c >= rank + 1)
    return out
