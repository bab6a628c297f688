"""Named hardware profiles for the analytic cost model (``repro_torch.cost``).

A copy of the JAX package's ``repro.roofline.hw`` registry with the port's
two targets instead of its TPU ones:

* ``h100_sxm`` -- one NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU
  datasheet; Hopper architecture white paper): 989 TFLOP/s dense bf16 on
  the tensor cores, 3.35 TB/s of HBM3, 80 GB of it, 228 KB of shared
  memory per SM in the ``vmem_bytes`` slot (the on-chip scratch a tile
  lives in), 18 NVLink 4 links at 25 GB/s each way (900 GB/s both ways in
  all), 132 SMs (the count the kernels' untuned defaults assume).  The
  rates assume the card's full 700 W power limit.
* ``cpu`` -- the plain PyTorch path on the CPU.  Its numbers are a small
  proxy (the plain path is not a hardware target): only the *order* of
  candidates means anything, which is all the pruner needs there.

Selection: :func:`get_profile` takes an explicit name, else
``$REPRO_TORCH_HW_PROFILE``, else the profile of ``device`` (``cuda`` ->
``h100_sxm``, ``cpu`` -> ``cpu``; with no device, ``h100_sxm`` when a card
is present).  The port reads its own variable, so a ``tpu_v5e`` chosen for
the JAX package through ``REPRO_HW_PROFILE`` never reaches it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

_ENV_VAR = "REPRO_TORCH_HW_PROFILE"
#: profile of each device type
DEVICE_PROFILES = {"cuda": "h100_sxm", "cpu": "cpu"}


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """Analytic description of one execution target.

    All rates are per device; the collective term combines
    ``ici_bw_per_link`` with ``links_per_chip``.
    """

    name: str
    peak_flops: float            # FLOP/s (the dominant matmul dtype)
    hbm_bw: float                # bytes/s main-memory bandwidth
    vmem_bytes: int              # on-chip scratch ceiling (tile residency)
    hbm_bytes: int               # main-memory capacity
    ici_bw_per_link: float = 0.0  # bytes/s per interconnect link
    links_per_chip: int = 0
    sms: int = 0                 # streaming multiprocessors (0: not a GPU)
    description: str = ""

    @property
    def ridge_intensity(self) -> float:
        """FLOP/byte where compute and memory time balance."""
        return self.peak_flops / self.hbm_bw


_PROFILES: Dict[str, HardwareProfile] = {}


def register_profile(profile: HardwareProfile) -> HardwareProfile:
    if profile.name in _PROFILES:
        raise ValueError(f"hardware profile {profile.name!r} already "
                         "registered")
    _PROFILES[profile.name] = profile
    return profile


def get_profile(name: Optional[str] = None, *,
                device=None) -> HardwareProfile:
    """Resolve a profile: explicit ``name`` > ``$REPRO_TORCH_HW_PROFILE`` >
    the profile of ``device`` (a card's when ``device`` is None and one is
    present, else the CPU's)."""
    resolved = name or os.environ.get(_ENV_VAR)
    if not resolved:
        if device is None:
            import torch
            kind = "cuda" if torch.cuda.is_available() else "cpu"
        else:
            kind = getattr(device, "type", None) or str(device).split(":")[0]
        resolved = DEVICE_PROFILES[kind]
    try:
        return _PROFILES[resolved]
    except KeyError:
        raise KeyError(f"no hardware profile {resolved!r}; "
                       f"known: {sorted(_PROFILES)}") from None


def all_profiles() -> Dict[str, HardwareProfile]:
    return dict(_PROFILES)


register_profile(HardwareProfile(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    vmem_bytes=228 * 1024,
    hbm_bytes=80 * 1024**3,
    ici_bw_per_link=25e9,
    links_per_chip=18,
    sms=132,
    description="one NVIDIA H100 SXM5 (dense bf16 tensor-core peak, HBM3, "
                "shared memory per SM, NVLink 4)",
))

register_profile(HardwareProfile(
    name="cpu",
    peak_flops=5e9,
    hbm_bw=20e9,
    vmem_bytes=16 * 1024 * 1024,
    hbm_bytes=8 * 1024**3,
    description="the plain PyTorch path on the CPU -- ordering-only proxy; "
                "absolute estimates are not hardware predictions",
))
