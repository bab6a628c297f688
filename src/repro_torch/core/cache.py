"""Analytic L1 cache model (paper Table II: 512 KB, 2-way, 64 B lines).

Two components:

* **D-side**: access count equals the number of memory-type instructions
  (that is the paper's definition of the mem column); miss counts come from
  a per-layer working-set sweep model.  The -O0 stack traffic hits a few
  hot lines and never misses; array traffic misses on first touch (cold)
  and, when a layer's streamed operand exceeds the cache, once per sweep
  (capacity).
* **I-side**: the in-order front end fetches ``fetch_bytes`` per L1I access
  along the fall-through path and issues one extra access per taken
  control-flow redirect, which reproduces gem5's "overall cache access"
  accounting on top of the D-side accesses.
"""
from __future__ import annotations

from dataclasses import dataclass

from .program import ConvLayer, FCLayer, Layer

LINE_BYTES = 64
L1_BYTES = 512 * 1024


@dataclass(frozen=True)
class CacheStats:
    d_accesses: int
    d_misses: int
    i_accesses: int

    @property
    def overall_accesses(self) -> int:
        return self.d_accesses + self.i_accesses


def data_misses(layer: Layer) -> int:
    """Cold + capacity misses for one layer's array traffic."""
    cold = (layer.input_bytes + layer.filter_bytes + layer.output_bytes) // LINE_BYTES
    capacity = 0
    if isinstance(layer, ConvLayer):
        # Per output filter i, the full input plane is re-swept; if the
        # input plane plus the filter block exceeds L1, each re-sweep
        # misses on the excess.
        ws = layer.input_bytes + layer.filter_bytes // max(layer.M, 1)
        if ws > L1_BYTES:
            capacity += (layer.M - 1) * ((ws - L1_BYTES) // LINE_BYTES)
        # Per output position, the filter bank row is re-read; only an issue
        # for enormous filter banks (pointwise convs with many channels).
        if layer.filter_bytes > L1_BYTES:
            sweeps = layer.Ho * layer.Wo
            capacity += (sweeps - 1) * ((layer.filter_bytes - L1_BYTES) // LINE_BYTES)
    else:
        if layer.filter_bytes > L1_BYTES:
            # Weight matrix streamed once (row per output) - no reuse sweeps.
            pass
    return cold + capacity


def instruction_accesses(
    instruction_bytes: int,
    redirects: int,
    fetch_bytes: int,
) -> int:
    """L1I accesses: sequential line-buffer fetches plus redirect fetches."""
    return instruction_bytes // fetch_bytes + redirects
