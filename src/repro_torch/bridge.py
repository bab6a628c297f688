"""Weight bridge: numpy arrays (e.g. ``np.asarray`` of the JAX package's
params) to torch tensors, name for name.

numpy has no bfloat16 of its own; JAX hands its bf16 arrays over as the
``ml_dtypes`` ``bfloat16`` dtype.  Those bytes are reinterpreted through a
``uint16`` view, so the bridge needs neither jax nor ml_dtypes.  An int8
weight (the JAX package's ``QuantizedTensor``) arrives as the pair of its
arrays ``(q, scale)`` and becomes the port's :class:`QuantizedTensor`.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .quant import QuantizedTensor


def tensor_from_numpy(a: np.ndarray, device="cpu",
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One array to a tensor on ``device``: bf16 bit for bit, every other
    dtype through :func:`torch.from_numpy`; ``dtype`` casts afterwards.
    The array is copied first: arrays from JAX are read-only, and the port
    writes its KV pools in place."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def params_from_numpy(
        arrays: Mapping[str, Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]],
        device="cpu", dtype: Optional[torch.dtype] = None
) -> Dict[str, Union[torch.Tensor, QuantizedTensor]]:
    """A dict of named arrays (params keyed ``blk.0.attn.wq`` ..., the
    audio family's ``pos_enc``, ``pos_dec``, ``enc.*``, ``dec.self.*``,
    ``dec.cross.*``, ``dec.ln3`` and ``enc_final``, or a cache's pools)
    to the same dict of tensors.  A ``(q, scale)``
    pair becomes a :class:`QuantizedTensor` (int8 codes and fp32 scales as
    they are; ``dtype`` casts only the plain arrays)."""
    out = {}
    for name, a in arrays.items():
        if isinstance(a, tuple):
            q, scale = a
            out[name] = QuantizedTensor(q=tensor_from_numpy(q, device),
                                        scale=tensor_from_numpy(scale, device))
        else:
            out[name] = tensor_from_numpy(a, device, dtype)
    return out
