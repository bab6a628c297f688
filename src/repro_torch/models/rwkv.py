"""RWKV-6 (Finch) blocks, in PyTorch: time mixing with per-channel
data-dependent decay, and channel mixing.

Port of the JAX package's ``repro.models.rwkv``.  The WKV recurrence
(:func:`wkv_chunked`) launches the hand-written ``rwkv6_wkv`` kernel once
over all T steps on CUDA tensors (and, under a gradient, its backward
kernel once in the backward); on CPU tensors it computes the JAX
package's chunked matmul formula op for op, so the CPU tests compare like
with like.  The JAX layer's TP head padding (``rwkv_pad_heads_to``, a
layout knob for a sharded mesh) is not ported: a config that sets it is
refused.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rwkv6 import rwkv6_wkv, rwkv6_wkv_grad
from .layers import ParamSpecs, Params, fan_in_scale, grad_wanted, linear, \
    rms_norm, sigmoid, silu, use_scan_kernel

W_LORA = 32


def _k(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def check_config(cfg: ModelConfig) -> None:
    if cfg.rwkv_pad_heads_to:
        raise NotImplementedError(
            f"{cfg.name}: rwkv_pad_heads_to={cfg.rwkv_pad_heads_to} is the "
            "JAX package's tensor-parallel head padding, not ported")


def rwkv_params(prefix: str, cfg: ModelConfig,
                layers: Optional[int]) -> ParamSpecs:
    """Shapes and init scales of one (or ``layers`` stacked) RWKV-6 blocks,
    name for name as the JAX ``rwkv_params`` lays them out."""
    check_config(cfg)
    d, ff, dh = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
    h = d // dh
    lead = () if layers is None else (layers,)
    shapes = {}
    # time mixing
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0", "ln_x",
                 "mu_ck", "mu_cr"):
        shapes[name] = (lead + (d,), 0.0)
    for name in ("wr", "wk", "wv", "wg", "wo", "cr"):
        shapes[name] = (lead + (d, d), None)
    shapes["wA"] = (lead + (d, W_LORA), None)
    shapes["wB"] = (lead + (W_LORA, d), None)
    shapes["u"] = (lead + (h, dh), 0.1)
    # channel mixing
    shapes["ck"] = (lead + (d, ff), None)
    shapes["cv"] = (lead + (ff, d), None)
    return {f"{prefix}.{name}": (shape, fan_in_scale(shape) if scale is None
                                 else scale)
            for name, (shape, scale) in shapes.items()}


def _token_shift(x: torch.Tensor,
                 last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Previous-token embedding; ``last`` carries across decode steps."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :x.shape[1]]
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, shifted, mu):
    return x + (shifted - x) * mu


def _wkv_one_chunk(rc, kc, vc, lw, uf, state):
    """One chunk of the JAX chunked formula, fp32 inputs (B, C, H, D) and
    state (B, H, D, D): every exponent is a difference of the
    non-increasing cumulative log decay, so none is positive."""
    cum = torch.cumsum(lw, dim=1)                       # (B,C,H,D)
    cum_prev = cum - lw                                 # cumW_{i-1}
    diff = cum_prev[:, :, None] - cum[:, None, :]       # (B,C,C,H,D)
    c = rc.shape[1]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=rc.device),
                      diagonal=-1)[None, :, :, None, None]
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    scores = torch.einsum("bihd,bijhd,bjhd->bhij", rc, decay, kc)
    y = torch.einsum("bhij,bjhv->bihv", scores, vc)
    # diagonal (current token) bonus term
    coef = torch.einsum("bihd,hd,bihd->bih", rc, uf, kc)
    y = y + coef[..., None] * vc
    # carry-in from previous chunks
    rin = rc * torch.exp(cum_prev)
    y = y + torch.einsum("bihd,bhdv->bihv", rin, state)
    # state update to the end of the chunk
    decay_end = torch.exp(cum[:, -1:] - cum)            # <= 1
    state = (torch.exp(cum[:, -1])[..., None] * state
             + torch.einsum("bihd,bihv->bhdv", kc * decay_end, vc))
    return y, state


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, *, chunk: int,
                s_init: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """The WKV recurrence over (B, T, H, D) streams with log decay ``logw``
    (<= 0) and bonus ``u`` (H, D), from state ``s_init`` (B, H, D, D) fp32
    or zeros; returns y and, with ``return_state``, the final state.

    CUDA tensors: one ``rwkv6_wkv`` launch over all T with ``w =
    exp(logw)`` in fp32 (y in r's dtype, which the caller rounds to anyway);
    under a gradient (:func:`.layers.grad_wanted`) through
    ``Rwkv6Function``, whose backward is the ``rwkv6_wkv_backward`` kernel
    (no state in or out), exp's own backward chaining dw to log w.
    CPU tensors: the JAX chunked formula in fp32, chunk by chunk."""
    if use_scan_kernel(r):
        w = torch.exp(logw.float())
        if grad_wanted(r, k, v, w, u):
            return rwkv6_wkv_grad(r, k, v, w, u, s_init=s_init,
                                  return_state=return_state)
        return rwkv6_wkv(r, k, v, w, u, s_init=s_init,
                         return_state=return_state)
    bsz, t, h, d = r.shape
    nchunks = -(-t // chunk)
    pad = nchunks * chunk - t
    if pad:
        r, k, v, logw = (F.pad(x, (0, 0, 0, 0, 0, pad))
                         for x in (r, k, v, logw))
    state = (s_init if s_init is not None else
             torch.zeros((bsz, h, d, d), dtype=torch.float32,
                         device=r.device))
    uf = u.float()
    ys = []
    for ci in range(nchunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        y, state = _wkv_one_chunk(r[:, sl].float(), k[:, sl].float(),
                                  v[:, sl].float(), logw[:, sl].float(), uf,
                                  state)
        ys.append(y)
    out = torch.cat(ys, dim=1)[:, :t]
    return (out, state) if return_state else out


def _decay_logw(p: Params, prefix: str, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay: w = exp(-exp(w0 + lora(xw))), returns log w."""
    lora = linear(xw, p[_k(prefix, "wA")])
    lora = linear(torch.tanh(lora), p[_k(prefix, "wB")])
    return -torch.exp(torch.clamp(p[_k(prefix, "w0")].float() + lora.float(),
                                  -8.0, 4.0))


def rwkv6_time_mix(p: Params, prefix: str, cfg: ModelConfig, x: torch.Tensor,
                   *, chunk: int = 64, last_x: Optional[torch.Tensor] = None,
                   s_init: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """Time mixing of x (B, T, d).  With ``return_state`` also returns the
    carry: the last input row (the next call's token shift) and the WKV
    state."""
    check_config(cfg)
    bsz, t, d = x.shape
    h, dh = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    sx = _token_shift(x, last_x)
    xr = _mix(x, sx, p[_k(prefix, "mu_r")])
    xk = _mix(x, sx, p[_k(prefix, "mu_k")])
    xv = _mix(x, sx, p[_k(prefix, "mu_v")])
    xw = _mix(x, sx, p[_k(prefix, "mu_w")])
    xg = _mix(x, sx, p[_k(prefix, "mu_g")])

    r = linear(xr, p[_k(prefix, "wr")]).reshape(bsz, t, h, dh)
    k = linear(xk, p[_k(prefix, "wk")]).reshape(bsz, t, h, dh)
    v = linear(xv, p[_k(prefix, "wv")]).reshape(bsz, t, h, dh)
    g = silu(linear(xg, p[_k(prefix, "wg")]))
    logw = _decay_logw(p, prefix, xw).reshape(bsz, t, h, dh)

    res = wkv_chunked(r, k, v, logw, p[_k(prefix, "u")], chunk=chunk,
                      s_init=s_init, return_state=return_state)
    y, state = res if return_state else (res, None)
    y = y.reshape(bsz, t, d).to(x.dtype)
    y = rms_norm(y, p[_k(prefix, "ln_x")] + 1.0, cfg.norm_eps) * g
    out = linear(y, p[_k(prefix, "wo")])
    if return_state:
        return out, x[:, -1], state
    return out


def rwkv6_channel_mix(p: Params, prefix: str, cfg: ModelConfig,
                      x: torch.Tensor, last_x: Optional[torch.Tensor] = None,
                      return_last: bool = False):
    sx = _token_shift(x, last_x)
    xk = _mix(x, sx, p[_k(prefix, "mu_ck")])
    xr = _mix(x, sx, p[_k(prefix, "mu_cr")])
    kk = torch.relu(linear(xk, p[_k(prefix, "ck")]))
    vv = linear(kk * kk, p[_k(prefix, "cv")])
    rr = sigmoid(linear(xr, p[_k(prefix, "cr")]))
    out = rr * vv
    if return_last:
        return out, x[:, -1]
    return out
