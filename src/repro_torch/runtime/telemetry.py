"""The part of ``repro.runtime.telemetry`` the paged engine needs.

Only :class:`Histogram` (observe and merge), which
``runtime.paged_kv.EngineMetrics`` keeps per priority class.  The flight
recorder, Perfetto export, metrics server and tick profiler come with a
later slice of the port.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

#: Bucket index of samples <= 0 (below every real bucket).
ZERO_BUCKET = -(10 ** 9)


class Histogram:
    """Log-bucketed mergeable histogram.

    Bucket ``i`` holds samples in ``(base**(i-1), base**i]``; samples
    <= 0 land in a dedicated zero bucket below every real one.  Merging
    is pure per-bucket count addition, so it is associative and
    commutative.  The quantile queries and serialization of the JAX
    package's class come with the port's telemetry plane."""

    def __init__(self, base: float = 2.0):
        if base <= 1.0:
            raise ValueError(f"histogram base must be > 1, got {base}")
        self.base = base
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def bucket_index(self, x: float) -> int:
        """The bucket a sample lands in (monotone in ``x``)."""
        if x <= 0.0:
            return ZERO_BUCKET
        # round() guards float fuzz at exact powers of the base so
        # x == base**k maps to bucket k, not k+1
        return math.ceil(round(math.log(x, self.base), 9))

    def observe(self, x: float) -> None:
        i = self.bucket_index(x)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.count += 1
        self.sum += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)

    def merge(self, other: "Histogram") -> "Histogram":
        """A new histogram holding both operands' samples."""
        if other.base != self.base:
            raise ValueError(f"cannot merge histograms with bases "
                             f"{self.base} and {other.base}")
        out = Histogram(self.base)
        out.counts = dict(self.counts)
        for i, n in other.counts.items():
            out.counts[i] = out.counts.get(i, 0) + n
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        mins = [m for m in (self.min, other.min) if m is not None]
        maxs = [m for m in (self.max, other.max) if m is not None]
        out.min = min(mins) if mins else None
        out.max = max(maxs) if maxs else None
        return out
