"""The train step on one device, as the JAX package's ``repro.train.step``
builds it: masked next-token cross entropy, gradient accumulation over
microbatches, then the optimizer update (AdamW or Adafactor).

The gradient is ``torch.autograd.grad`` of the loss over the parameter
dict.  On the card every projection's forward and both products of its
backward run on ``apr_matmul`` (``AprMatmulFunction``), the recurrences'
forwards and backwards on ``rwkv6_wkv`` / ``rwkv6_wkv_backward``
(``Rwkv6Function``) and ``mamba2_ssd`` / ``mamba2_ssd_backward``
(``Mamba2Function``), and each block the JAX forward checkpoints is
recomputed in the backward under ``cfg.remat``.  Families: ``dense``,
``moe``, ``vlm``, ``ssm``, ``mamba``, ``hybrid`` and ``audio``; an MoE
layer's stacked expert leaves each get their gradient as one tensor
(``models.moe.ExpertMatmulFunction``), so that arctic-480b's single layer
and llama4-maverick's single super-block train at published widths on one
80 GB card under Adafactor with ``donate``.  The sharded pieces of the JAX
module (``assemble_shardings``, ``cache_spec``, ZeRO-1 specs, cross-pod
gradient compression) and the MoE layer's expert parallelism need the
port's ``parallel/`` and are not here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from ..models.registry import ModelBundle
from ..optim import (adafactor_init, adafactor_update, adamw_init,
                     adamw_update, global_norm_sq, warmup_cosine)

#: the families the port trains (on one device; the whole of a published
#: moe model needs expert parallelism over several cards, ROADMAP A.12)
TRAIN_FAMILIES = ("dense", "moe", "vlm", "ssm", "mamba", "hybrid", "audio")


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    num_microbatches: int = 1
    compress_cross_pod: bool = False


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask=None) -> torch.Tensor:
    """Mean next-token cross entropy in fp32 (masked mean under ``mask``):
    logsumexp less the label's logit.  The JAX function contracts the
    logits with a one-hot of the labels; a ``gather`` of the label's logit
    is the same number for finite logits (padded vocab slots hold -1e30)
    and makes no (B, S, V) one-hot."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    correct = logits.gather(-1, labels.long()[..., None])[..., 0]
    ll = correct - lse
    if mask is not None:
        return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return -torch.mean(ll)


def _loss_fn(bundle: ModelBundle, params, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
    """The JAX ``_loss_fn`` over the port's forward: the batch dict's
    ``tokens`` (and a vlm's ``vision_embeds`` as ``prefix_embeds``, an
    audio model's ``frames``), the vision prefix's positions masked out of
    the loss."""
    cfg = bundle.cfg
    vlm = cfg.family == "vlm"
    logits = bundle.forward(
        params, batch["tokens"],
        prefix_embeds=batch["vision_embeds"] if vlm else None,
        frames=batch["frames"] if cfg.family == "audio" else None)
    mask = None
    if vlm:   # vision prefix positions carry no labels
        s = logits.shape[1]
        mask = (torch.arange(s, device=logits.device) >= cfg.vision_tokens
                )[None, :].float().expand(logits.shape[:2])
    return cross_entropy_loss(logits, batch["labels"], mask)


def microbatches_for(cfg: ModelConfig, shape: ShapeSpec,
                     dp_degree: int = 1) -> int:
    """Grad-accum depth: cap the per-DP-shard microbatch at
    ``cfg.max_microbatch_tokens`` tokens (one device: ``dp_degree`` 1)."""
    local_batch = max(1, shape.global_batch // max(dp_degree, 1))
    tokens = local_batch * shape.seq_len
    mb = max(1, -(-tokens // cfg.max_microbatch_tokens))
    while local_batch % mb:
        mb += 1
    return min(mb, local_batch)


def init_optimizer(cfg: ModelConfig, params):
    if cfg.optimizer == "adafactor":
        return adafactor_init(params)
    return adamw_init(params)


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError``, by name, for a family the port does
    not train."""
    if cfg.family not in TRAIN_FAMILIES:
        raise NotImplementedError(
            f"training the {cfg.family!r} family ({cfg.name}) is not ported; "
            f"the port trains {', '.join(TRAIN_FAMILIES)}")


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``data.pipeline``) or tensors on
    ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def loss_and_grads(bundle: ModelBundle, params, batch: Dict[str, Any],
                   num_microbatches: int = 1
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and the gradient of every parameter (in its own dtype; in
    fp32 over ``num_microbatches`` > 1: the JAX scan's fp32 accumulation,
    divided by the count).  ``params`` are not modified: the gradient is
    taken over detached leaves."""
    check_trainable(bundle.cfg)
    batch = batch_to_device(batch, bundle.device)
    names = sorted(params)
    leaves = {k: params[k].detach().requires_grad_(True) for k in names}

    def one(mb):
        loss = _loss_fn(bundle, leaves, mb)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return loss.detach(), dict(zip(names, grads))

    nmb = num_microbatches
    if nmb <= 1:
        return one(batch)
    loss = torch.zeros((), dtype=torch.float32, device=bundle.device)
    acc = {k: torch.zeros(params[k].shape, dtype=torch.float32,
                          device=bundle.device) for k in names}
    for i in range(nmb):
        mb = {k: v.reshape(nmb, v.shape[0] // nmb, *v.shape[1:])[i]
              for k, v in batch.items()}
        mb_loss, grads = one(mb)
        loss = loss + mb_loss
        acc = {k: acc[k] + grads[k].float() for k in names}
    return loss / nmb, {k: acc[k] / nmb for k in names}


def make_train_step(bundle: ModelBundle, hyper: TrainHyper, *,
                    donate: bool = False) -> Callable:
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``; ``metrics`` holds 0-d device tensors ``loss``,
    ``lr`` and ``grad_norm`` (over the leaves in JAX's tree order).
    ``batch`` is a dict of numpy arrays or tensors, moved to the bundle's
    device in the step.  ``donate`` gives the update what JAX's
    ``donate_argnums`` would: AdamW ``opt_state`` (it frees each old state
    leaf as it makes the new one), Adafactor ``params`` (each new param is
    written into the old one's storage); either frees each gradient leaf
    once it is applied.  The caller must not use what it gave again."""
    cfg = bundle.cfg
    check_trainable(cfg)
    if hyper.compress_cross_pod:
        raise NotImplementedError(
            "compress_cross_pod: cross-pod gradient compression needs the "
            "port's parallel/ (a mesh of pods), which is not ported")

    def train_step(params, opt_state, batch, step):
        step = torch.as_tensor(step, dtype=torch.int32).to(bundle.device)
        lr = warmup_cosine(step, peak_lr=hyper.peak_lr, warmup=hyper.warmup,
                           total=hyper.total_steps)
        loss, grads = loss_and_grads(bundle, params, batch,
                                     hyper.num_microbatches)
        gnorm = torch.sqrt(global_norm_sq([grads[k] for k in sorted(grads)]))
        if cfg.optimizer == "adafactor":
            new_params, new_opt = adafactor_update(grads, opt_state, params,
                                                   lr, donate=donate)
        else:
            new_params, new_opt = adamw_update(grads, opt_state, lr,
                                               donate=donate)
        metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm}
        return new_params, new_opt, metrics

    return train_step
