"""AdamW with fp32 state, bf16 params -- functional, as the JAX package's
``repro.optim.adamw`` (its ZeRO-1 sharding of the state waits for the
port's ``parallel/``).

The update repeats the JAX op order: the global-norm clip, the ``b1`` /
``b2`` moments, the bias corrections ``1 - b ** step`` in fp32, decoupled
weight decay on the fp32 master, and new params cast to bf16 whatever
their input dtype.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from .tree import (SLICE_ELEMENTS, clear_tree, tree_leaves, tree_map,
                   tree_unflatten)


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: Any
    v: Any
    master: Any          # fp32 master copy of params


def adamw_init(params) -> AdamWState:
    device = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        master=tree_map(lambda p: p.to(torch.float32, copy=True), params),
    )


def global_norm_sq(leaves) -> torch.Tensor:
    """``sum(sum(square(g.float())) for g in leaves)``: one fp32 sum of
    squares a leaf, added in leaf order, as the JAX expression does.  A
    leaf of more than :data:`~.tree.SLICE_ELEMENTS` elements is summed
    in runs of that many (their fp32 sums added in order), so that no fp32
    copy of a whole leaf is made."""
    total = 0
    for g in leaves:
        total = total + sum(torch.sum(torch.square(run.float()))
                            for run in g.reshape(-1).split(SLICE_ELEMENTS))
    return total


def adamw_update(
    grads, state: AdamWState, lr,
    *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0,
    donate: bool = False,
) -> Tuple[Any, AdamWState]:
    """New bf16 params and state from ``grads`` (a tree like the params).
    ``lr`` is a float or a 0-d fp32 tensor.  ``donate`` gives ``grads`` and
    ``state`` up, as JAX's ``donate_argnums`` does: their containers are
    emptied first, so each old leaf is freed once its new one is made and
    the update holds one copy of the state rather than two."""
    step = state.step + 1
    flat_g = tree_leaves(grads)
    gnorm = torch.sqrt(global_norm_sq(flat_g) + 1e-12)
    scale = torch.clamp(grad_clip / gnorm, max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    flat_m = tree_leaves(state.m)
    flat_v = tree_leaves(state.v)
    flat_p = tree_leaves(state.master)
    like = state.m
    if donate:
        like = tree_map(lambda x: None, state.m)
        for tree in (grads, state.m, state.v, state.master):
            clear_tree(tree)
    new_m, new_v, new_p = [], [], []
    for i in range(len(flat_g)):
        g, m, v, p = flat_g[i], flat_m[i], flat_v[i], flat_p[i]
        flat_g[i] = flat_m[i] = flat_v[i] = flat_p[i] = None
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        p = p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)
        new_m.append(m)
        new_v.append(v)
        new_p.append(p)
    params = tree_unflatten(like, [p.to(torch.bfloat16) for p in new_p])
    return params, AdamWState(step, tree_unflatten(like, new_m),
                              tree_unflatten(like, new_v),
                              tree_unflatten(like, new_p))
