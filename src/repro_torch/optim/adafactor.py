"""Adafactor (factored second moment, no momentum), as the JAX package's
``repro.optim.adafactor`` -- the choice for the 400-480B MoE archs: state
is O(rows+cols) per matrix instead of O(rows*cols).

New params keep each param's own dtype.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from .tree import tree_leaves, tree_map, tree_unflatten


class AdafactorState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    vr: Any   # row factors (or full v for <2D leaves)
    vc: Any   # col factors (zeros((1,)) sentinel for <2D leaves)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params) -> AdafactorState:
    def row(p):
        shape = tuple(p.shape[:-1]) if _factored(p.shape) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def col(p):
        shape = (tuple(p.shape[:-2]) + tuple(p.shape[-1:])
                 if _factored(p.shape) else (1,))
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        vr=tree_map(row, params),
        vc=tree_map(col, params),
    )


def adafactor_update(
    grads, state: AdafactorState, params, lr,
    *, decay=0.99, eps=1e-30, clip_threshold=1.0, weight_decay=0.0,
) -> Tuple[Any, AdafactorState]:
    step = state.step + 1

    def upd(g, vr, vc, p):
        g = g.float()
        g2 = g * g + eps
        if _factored(g.shape):
            vr = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
            vc = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
            r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                 min=eps)
            u = g / torch.sqrt(torch.clamp(r[..., None] * vc[..., None, :],
                                           min=eps))
        else:
            vr = decay * vr + (1 - decay) * g2
            u = g / torch.sqrt(torch.clamp(vr, min=eps))
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        pf = p.float()
        new_p = pf - lr * u - lr * weight_decay * pf
        return vr, vc, new_p.to(p.dtype)

    out = [upd(g, r, c, p) for g, r, c, p in zip(
        tree_leaves(grads), tree_leaves(state.vr), tree_leaves(state.vc),
        tree_leaves(params))]
    new_vr = tree_unflatten(grads, [o[0] for o in out])
    new_vc = tree_unflatten(grads, [o[1] for o in out])
    new_params = tree_unflatten(grads, [o[2] for o in out])
    return new_params, AdafactorState(step, new_vr, new_vc)
