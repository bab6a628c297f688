"""The one-device half of the JAX package's ``repro.roofline.analysis``:
the three-term roofline, the depth extrapolation and the analytic
traffic and FLOP counts of a cell.

    compute    = flops       / peak_flops
    memory     = hbm_bytes   / hbm_bw
    collective = wire_bytes  / (links_per_chip x ici_bw_per_link)

Every quantity is per device, and every rate comes from a
:class:`~repro_torch.roofline.hw.HardwareProfile` of the port
(``h100_sxm``, ``cpu``): :class:`RooflineTerms` takes ``links_per_chip``
from its profile unless it is given.  The HLO readers of the JAX module
(``parse_collectives``, ``cost_from_compiled``, ``CollectiveStats``) read
XLA's compiled programs for the multi-device dry run and are not here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from . import hw


@dataclasses.dataclass
class RooflineTerms:
    """The roofline of one device's share of a step: ``flops``,
    ``hbm_bytes`` and ``wire_bytes`` per device over ``chips`` devices.
    ``profile=None`` resolves :func:`~.hw.get_profile` (a card's when one
    is present); ``links_per_chip=None`` takes the profile's."""

    flops: float          # per-device
    hbm_bytes: float      # per-device
    wire_bytes: float     # per-device
    chips: int
    links_per_chip: Optional[int] = None
    profile: Optional[hw.HardwareProfile] = None

    def _hw(self) -> hw.HardwareProfile:
        return self.profile if self.profile is not None else hw.get_profile()

    @property
    def links(self) -> int:
        return (self._hw().links_per_chip if self.links_per_chip is None
                else self.links_per_chip)

    @property
    def t_compute(self) -> float:
        return self.flops / self._hw().peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self._hw().hbm_bw

    @property
    def t_collective(self) -> float:
        link_bw = self._hw().ici_bw_per_link
        if link_bw <= 0 or self.links <= 0:
            return 0.0
        return self.wire_bytes / (self.links * link_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "wire_bytes_per_device": self.wire_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def extrapolate(c1: float, c2: float, depth: int, multiplier: float = 1.0) -> float:
    """cost(full) = c1 + (depth-1)*(c2-c1), optionally x microbatches."""
    per_layer = max(c2 - c1, 0.0)
    return (c1 + (depth - 1) * per_layer) * multiplier


def analytic_hbm_bytes(cfg, shape, chips: int, *, param_count: int,
                       cache_bytes: int = 0, microbatches: int = 1) -> float:
    """Per-device main-memory traffic of a step with every elementwise op
    fused into its producer (a lower bound):

    train:  3x param reads (fwd + remat + bwd) + grad write/read (fp32)
            + optimizer state read/write + layer-boundary activations
            (x3: fwd write, bwd read, remat re-write) + logits
    prefill: param read + boundary activations + KV-cache write
    decode:  param read + full cache read + token write
    """
    p_dev = param_count * 2 / chips  # bf16 resident
    d, v = cfg.d_model, cfg.vocab_size
    tokens_dev = shape.global_batch * shape.seq_len / chips * \
        (1 if shape.kind != "decode" else 0)
    layers = cfg.num_layers + (cfg.encoder_layers or 0)

    if shape.kind == "train":
        param_traffic = 3 * p_dev + 4 * p_dev  # reads + fp32 grad w/r
        opt_traffic = (2 * p_dev) if cfg.optimizer == "adafactor" else 12 * p_dev
        act = tokens_dev * d * 2 * layers * 3  # boundary x (fwd,bwd,remat)
        logits = tokens_dev * v * 2 * 3
        return param_traffic + opt_traffic + act + logits
    if shape.kind == "prefill":
        act = tokens_dev * d * 2 * layers * 2
        return p_dev + act + cache_bytes / max(chips, 1) + tokens_dev * v * 2
    # decode: weights once + cache streamed once
    return p_dev + cache_bytes / max(chips, 1) + shape.global_batch * v * 2 / chips


def model_flops(cfg, shape, training: bool) -> float:
    """Analytic 6*N_active*D (train) / 2*N_active*D (inference) per step."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return cfg.model_flops_per_token(training=True) * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return cfg.model_flops_per_token(training=False) * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return cfg.model_flops_per_token(training=False) * tokens
