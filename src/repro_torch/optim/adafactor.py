"""Adafactor (factored second moment, no momentum), as the JAX package's
``repro.optim.adafactor`` -- the choice for the 400-480B MoE archs: state
is O(rows+cols) per matrix instead of O(rows*cols).

New params keep each param's own dtype.  A leaf is updated in slices of at
most :data:`SLICE_ELEMENTS` elements -- runs of its leading dims, or of a
larger matrix's rows -- so that no fp32 temporary spans a whole leaf (an
expert leaf of arctic-480b is 17.9 GB in fp32).  Every element takes the
JAX ops in the JAX order; only the sums that cross slices are reassociated
in fp32: the update clip's RMS (a whole-leaf mean of ``u²``, summed slice
by slice in a pass of its own before the apply) and, for a matrix cut by
rows, its column moments.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import torch

from .tree import (SLICE_ELEMENTS, clear_tree, tree_leaves, tree_map,
                   tree_unflatten)


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


def _slices(lead: int, rows: int, cols: int) -> List[tuple]:
    """Index pairs over a ``(lead, rows, cols)`` view: runs of whole
    matrices of at most :data:`SLICE_ELEMENTS` elements, or, for a larger
    matrix, runs of its rows (one matrix a slice)."""
    if rows * cols <= SLICE_ELEMENTS:
        step = max(1, SLICE_ELEMENTS // (rows * cols))
        return [(slice(i, i + step), slice(None))
                for i in range(0, lead, step)]
    step = max(1, SLICE_ELEMENTS // cols)
    return [(slice(i, i + 1), slice(r, r + step))
            for i in range(lead) for r in range(0, rows, step)]


def _update(g, vr, vc, p, dst, lr, decay, eps, clip_threshold,
            weight_decay):
    """New ``vr``, ``vc`` of one leaf, its new param written into ``dst``
    (a tensor of ``p``'s shape and dtype), slice by slice."""
    factored = _factored(g.shape)
    if factored:
        rows, cols = g.shape[-2:]
        view = (-1, rows, cols)
        vr, vc = vr.reshape(-1, rows), vc.reshape(-1, cols)
        slices = _slices(g.numel() // (rows * cols), rows, cols)
    else:   # elementwise: runs of the flat leaf
        view = (-1,)
        vr = vr.reshape(-1)
        slices = [(slice(i, i + SLICE_ELEMENTS),)
                  for i in range(0, max(g.numel(), 1), SLICE_ELEMENTS)]
    gm, pm, dm = g.reshape(view), p.view(view), dst.view(view)
    new_vr = torch.empty_like(vr)
    col_sums = None
    if factored:
        new_vc = torch.empty_like(vc)
        if slices[0][1] != slice(None):       # a matrix cut by rows
            col_sums = torch.zeros_like(vc)
    for s in slices:
        gs = gm[s].float()
        g2 = gs * gs + eps
        if not factored:
            new_vr[s] = decay * vr[s] + (1 - decay) * g2
            continue
        new_vr[s] = decay * vr[s] + (1 - decay) * torch.mean(g2, dim=-1)
        if col_sums is None:
            new_vc[s[0]] = (decay * vc[s[0]]
                            + (1 - decay) * torch.mean(g2, dim=-2))
        else:
            col_sums[s[0]] += torch.sum(g2, dim=-2)
    if col_sums is not None:
        new_vc = decay * vc + (1 - decay) * (col_sums / rows)
    if factored:
        r = new_vr / torch.clamp(torch.mean(new_vr, dim=-1, keepdim=True),
                                 min=eps)

    def u_of(s):
        gs = gm[s].float()
        if factored:
            return gs / torch.sqrt(torch.clamp(
                r[s][..., None] * new_vc[s[0]][..., None, :], min=eps))
        return gs / torch.sqrt(torch.clamp(new_vr[s], min=eps))

    whole = None
    if len(slices) == 1:
        whole = u_of(slices[0])
        ms = torch.mean(torch.square(whole))
    else:
        ms = sum(torch.sum(torch.square(u_of(s))) for s in slices) \
            / g.numel()
    rms = torch.sqrt(ms + 1e-12)
    for s in slices:
        u = (u_of(s) if whole is None else whole) \
            / torch.clamp(rms / clip_threshold, min=1.0)
        pf = pm[s].float()
        dm[s] = (pf - lr * u - lr * weight_decay * pf).to(p.dtype)
    if factored:
        return (new_vr.reshape(g.shape[:-1]),
                new_vc.reshape(g.shape[:-2] + g.shape[-1:]))
    return new_vr.reshape(g.shape), vc


def adafactor_update(
    grads, state: AdafactorState, params, lr,
    *, decay=0.99, eps=1e-30, clip_threshold=1.0, weight_decay=0.0,
    donate: bool = False,
) -> Tuple[Any, AdafactorState]:
    """New params (each in its own dtype) and state from ``grads`` (a tree
    like the params).  ``donate`` gives ``params`` and ``grads`` up, as
    JAX's ``donate_argnums`` does: each new param is written into the old
    one's storage (the returned tree holds those tensors, bit for bit the
    new params the update makes without ``donate``) and the grads'
    containers are emptied first, so each gradient leaf is freed once it
    is applied."""
    step = state.step + 1
    flat_g = tree_leaves(grads)
    flat_r, flat_c = tree_leaves(state.vr), tree_leaves(state.vc)
    flat_p = tree_leaves(params)
    like = grads
    if donate:
        like = tree_map(lambda x: None, grads)
        clear_tree(grads)
    out = []
    for i in range(len(flat_g)):
        g, p = flat_g[i], flat_p[i]
        flat_g[i] = None
        dst = p if donate else torch.empty_like(p)
        vr, vc = _update(g, flat_r[i], flat_c[i], p, dst, lr, decay, eps,
                         clip_threshold, weight_decay)
        del g
        out.append((vr, vc, dst))
    new_vr = tree_unflatten(like, [o[0] for o in out])
    new_vc = tree_unflatten(like, [o[1] for o in out])
    new_params = tree_unflatten(like, [o[2] for o in out])
    return new_params, AdafactorState(step, new_vr, new_vc)
