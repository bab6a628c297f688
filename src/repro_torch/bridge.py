"""Weight bridge: numpy arrays (e.g. ``np.asarray`` of the JAX package's
params) to torch tensors, name for name, and optimizer states between the
packages (:func:`opt_state_from_numpy`, :func:`opt_state_to_numpy`).

numpy has no bfloat16 of its own; JAX hands its bf16 arrays over as the
``ml_dtypes`` ``bfloat16`` dtype.  Those bytes are reinterpreted through a
``uint16`` view, so the bridge needs neither jax nor ml_dtypes.  An int8
weight (the JAX package's ``QuantizedTensor``) arrives as the pair of its
arrays ``(q, scale)`` and becomes the port's :class:`QuantizedTensor`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .optim import AdafactorState, AdamWState
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


#: the port's optimizer states by their fields (the JAX package's
#: ``AdamWState`` and ``AdafactorState`` have the same fields in order)
_OPT_STATES = {AdamWState._fields: AdamWState,
               AdafactorState._fields: AdafactorState}


def opt_state_from_numpy(state, device="cpu"):
    """An optimizer state whose leaves are numpy arrays (e.g.
    ``jax.tree.map(np.asarray, ...)`` of the JAX package's ``AdamWState``
    or ``AdafactorState``, or a dict of its fields) as the port's state of
    the same fields, on ``device``: ``step`` a 0-d int32 tensor, every
    other field a dict of named fp32 tensors, bit for bit."""
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    cls = _OPT_STATES.get(tuple(fields))
    if cls is None:
        raise ValueError(f"no optimizer state has the fields {tuple(fields)}")
    return cls(**{name: tensor_from_numpy(value, device) if name == "step"
                  else params_from_numpy(value, device)
                  for name, value in fields.items()})


def opt_state_to_numpy(state) -> Dict[str, Any]:
    """The inverse of :func:`opt_state_from_numpy`: the state's fields, in
    order, as numpy arrays (``step``) and dicts of named arrays, ready for
    the JAX package's state of the same name (``AdamWState(**fields)``
    after ``jnp.asarray`` of each leaf).  Optimizer states hold fp32 and
    int32 only."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().copy()
    return {name: host(value) if name == "step"
            else {k: host(v) for k, v in value.items()}
            for name, value in state._asdict().items()}
