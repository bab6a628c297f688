"""Mamba-2 (SSD) blocks and the pure-recurrent ``mamba`` language model, in
PyTorch.

Port of the JAX package's ``repro.models.ssm``.  The SSD recurrence
launches the hand-written ``mamba2_ssd`` kernel on CUDA tensors: once over
all T steps in :func:`ssd_chunked` (forward, prefill; under a gradient its
backward kernel once in the backward), and at T = 1 with the
state in and out for the state step of :func:`mamba2_decode`.  On CPU
tensors both keep the JAX package's formulas op for op: the chunked matmul
formula in :func:`ssd_chunked`, the inline step in :func:`mamba2_decode`.
:func:`mamba2_mixer` is the whole block body, which the hybrid family
(``models/hybrid.py``) reuses with :func:`mamba2_decode`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.mamba2 import mamba2_ssd, mamba2_ssd_grad
from .layers import ParamSpecs, Params, fan_in_scale, grad_wanted, linear, \
    mask_vocab_logits, rematerialised, remat_wanted, rms_norm, silu, \
    softplus, use_scan_kernel
from .paged_state import gather_state, scatter_state, split_state_tables

CONV_K = 4

State = Dict[str, torch.Tensor]


def ssm_params(prefix: str, cfg: ModelConfig,
               layers: Optional[int]) -> ParamSpecs:
    """Shapes and init scales of one (or ``layers`` stacked) Mamba-2
    mixers, name for name as the JAX ``ssm_params``."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    lead = () if layers is None else (layers,)
    w_in = lead + (d, 2 * di + 2 * n + h)
    w_out = lead + (di, d)
    return {
        f"{prefix}.w_in": (w_in, fan_in_scale(w_in)),
        f"{prefix}.conv": (lead + (CONV_K, di + 2 * n), 0.5),
        f"{prefix}.a_log": (lead + (h,), 0.0),
        f"{prefix}.d_skip": (lead + (h,), 0.0),
        f"{prefix}.dt_bias": (lead + (h,), 0.0),
        f"{prefix}.norm": (lead + (di,), 0.0),
        f"{prefix}.w_out": (w_out, fan_in_scale(w_out)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel CONV_K.  x: (B, T, C); w: (K, C).  The
    JAX layer's sum of shifted products, in its order and dtype."""
    out = x * w[CONV_K - 1]
    for k in range(1, CONV_K):
        out = out + F.pad(x, (0, 0, k, 0))[:, :x.shape[1]] * w[CONV_K - 1 - k]
    return out


def _segsum_exp(s: torch.Tensor) -> torch.Tensor:
    """exp(s_i - s_j) masked to j <= i.  s: (B, H, C)."""
    c = s.shape[-1]
    diff = s[..., :, None] - s[..., None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=s.device))
    return torch.where(mask, torch.exp(diff), 0.0)


def _ssd_one_chunk(xc, bc, cc, dtc, a, d_skip, hstate):
    """One SSD chunk: (B, C, ...) fp32 inputs + (B, H, P, N) state ->
    (y, state)."""
    g = a[None, None, :] * dtc                       # (B,C,H) <= 0
    s = torch.cumsum(g, dim=1)                       # non-increasing
    sh = s.transpose(1, 2)                           # (B,H,C)

    scores_nb = torch.einsum("bin,bjn->bij", cc, bc)  # shared over heads
    m = _segsum_exp(sh) * scores_nb[:, None]          # (B,H,C,C)
    dtx = dtc[..., None] * xc                         # (B,C,H,P)
    y_intra = torch.einsum("bhij,bjhp->bihp", m, dtx)

    decay_in = torch.exp(sh).transpose(1, 2)          # (B,C,H)
    y_inter = torch.einsum("bhpn,bin,bih->bihp", hstate, cc, decay_in)

    decay_to_end = torch.exp(sh[..., -1:] - sh).transpose(1, 2)  # (B,C,H)
    upd = torch.einsum("bih,bin,bihp->bhpn", decay_to_end * dtc, bc, xc)
    hstate = torch.exp(sh[..., -1])[..., None, None] * hstate + upd

    y = y_intra + y_inter + d_skip[None, None, :, None] * xc
    return y, hstate


def ssd_chunked(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                dt: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor, *,
                chunk: int, h_init: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """The SSD recurrence: x (B, T, H, P) post-conv, b/c (B, T, N), dt
    (B, T, H) positive, a (H,) negative, d_skip (H,), from state ``h_init``
    (B, H, P, N) fp32 or zeros; returns y and, with ``return_state``, the
    final state.

    CUDA tensors: one ``mamba2_ssd`` launch over all T (y in x's dtype,
    which the caller rounds to anyway); under a gradient
    (:func:`.layers.grad_wanted`) through ``Mamba2Function``, whose
    backward is the ``mamba2_ssd_backward`` kernel (no state in or out).
    CPU tensors: the JAX chunked formula in fp32."""
    if use_scan_kernel(x):
        if grad_wanted(x, b, c, dt, a, d_skip):
            return mamba2_ssd_grad(x, b, c, dt, a, d_skip, h_init=h_init,
                                   return_state=return_state)
        return mamba2_ssd(x, b, c, dt, a, d_skip, h_init=h_init,
                          return_state=return_state)
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    nchunks = -(-t // chunk)
    pad = nchunks * chunk - t
    if pad:
        x, b, c, dt = (F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
                       for v in (x, b, c, dt))
    hstate = (h_init if h_init is not None else
              torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device))
    af, df = a.float(), d_skip.float()
    ys = []
    for ci in range(nchunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        y, hstate = _ssd_one_chunk(x[:, sl].float(), b[:, sl].float(),
                                   c[:, sl].float(), dt[:, sl].float(), af,
                                   df, hstate)
        ys.append(y)
    out = torch.cat(ys, dim=1)[:, :t]
    return (out, hstate) if return_state else out


def mamba2_mixer(p: Params, prefix: str, cfg: ModelConfig, x: torch.Tensor,
                 *, chunk: int = 256, return_state: bool = False):
    """Full Mamba-2 block body (forward/prefill): x (B, T, d) -> (B, T, d).
    ``return_state=True`` also yields the serving carry -- the last
    CONV_K-1 conv-input rows (fp32) and the final SSD state -- so a prefill
    can hand off to O(1) decode."""
    di, n, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = linear(x, p[f"{prefix}.w_in"])
    z, xc, bmat, cmat, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)
    conv_out = silu(_causal_conv(conv_in, p[f"{prefix}.conv"]))
    xc, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)

    dt = softplus(dt.float() + p[f"{prefix}.dt_bias"])
    a = -torch.exp(p[f"{prefix}.a_log"].float())
    bsz, t = x.shape[:2]
    y = ssd_chunked(xc.reshape(bsz, t, h, ph), bmat, cmat, dt, a,
                    p[f"{prefix}.d_skip"].float(), chunk=chunk,
                    return_state=return_state)
    if return_state:
        y, hstate = y
        window = torch.cat([torch.zeros((bsz, CONV_K - 1, conv_in.shape[-1]),
                                        dtype=torch.float32,
                                        device=x.device),
                            conv_in.float()], dim=1)
        conv_state = window[:, window.shape[1] - (CONV_K - 1):]
    y = y.reshape(bsz, t, di).to(x.dtype) * silu(z)
    y = rms_norm(y, p[f"{prefix}.norm"] + 1.0, cfg.norm_eps)
    out = linear(y, p[f"{prefix}.w_out"])
    if return_state:
        return out, conv_state, hstate
    return out


# ---------------------------------------------------------------------------
# Single-token decode with carried (conv_state, ssm_state).
# ---------------------------------------------------------------------------


def _conv_step(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The depthwise conv over one decode window (B, CONV_K, C) with taps
    w (CONV_K, C), as the FMA chain XLA computes for the JAX layer's
    ``einsum("bkc,kc->bc")``: bit-equal to it on the CPU, and row-major.
    ``torch.einsum`` returns it channel-major, and the x, b and c sliced
    from it then fail the ``mamba2_ssd`` kernel's contiguous-last-axis
    check (``chip_smoke.py --ablate``)."""
    conv = window[:, 0] * w[0]
    for k in range(1, CONV_K):
        conv = torch.addcmul(conv, window[:, k], w[k])
    return conv


def mamba2_decode(p: Params, prefix: str, cfg: ModelConfig,
                  x: torch.Tensor,            # (B, 1, d)
                  conv_state: torch.Tensor,   # (B, CONV_K-1, di+2N) fp32
                  ssm_state: torch.Tensor,    # (B, H, P, N) fp32
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token: the mixer output (B, 1, d) and the new conv window and
    SSD state (the old ones are not written).  The state step is one
    ``mamba2_ssd`` launch at T = 1 on CUDA tensors, JAX's inline formula on
    CPU tensors."""
    di, n, h, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    bsz = x.shape[0]
    zxbcdt = linear(x, p[f"{prefix}.w_in"])[:, 0]
    z, xc, bmat, cmat, dt = torch.split(zxbcdt, [di, di, n, n, h], dim=-1)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)               # (B, ch)
    window = torch.cat([conv_state, conv_in[:, None].to(conv_state.dtype)],
                       dim=1)                                   # (B, K, ch)
    conv_out = silu(_conv_step(window, p[f"{prefix}.conv"].to(window.dtype)))
    new_conv_state = window[:, 1:]
    xc, bmat, cmat = torch.split(conv_out, [di, n, n], dim=-1)

    dt = softplus(dt.float() + p[f"{prefix}.dt_bias"])          # (B, H)
    a = -torch.exp(p[f"{prefix}.a_log"].float())
    d_skip = p[f"{prefix}.d_skip"].float()
    if use_scan_kernel(x):
        y, ssm_state = mamba2_ssd(
            xc.float().reshape(bsz, 1, h, ph), bmat.float()[:, None],
            cmat.float()[:, None], dt[:, None], a, d_skip, h_init=ssm_state,
            return_state=True)
    else:
        xh = xc.reshape(bsz, h, ph).float()
        decay = torch.exp(a[None] * dt)                          # (B, H)
        upd = dt[..., None, None] * (xh[..., None]
                                     * bmat[:, None, None, :].float())
        ssm_state = decay[..., None, None] * ssm_state + upd
        y = torch.einsum("bhpn,bn->bhp", ssm_state, cmat.float())
        y = y + d_skip[None, :, None] * xh
    y = y.reshape(bsz, 1, di).to(x.dtype) * silu(z)[:, None]
    y = rms_norm(y, p[f"{prefix}.norm"] + 1.0, cfg.norm_eps)
    out = linear(y, p[f"{prefix}.w_out"])
    return out, new_conv_state, ssm_state


# ---------------------------------------------------------------------------
# Mamba-2 language model (the pure-recurrent ``mamba`` family): a stack of
# pre-norm mixer blocks with residuals -- no attention, no FFN.
# ---------------------------------------------------------------------------


def build_lm_params(cfg: ModelConfig) -> ParamSpecs:
    """Shapes and init scales, name for name as the JAX
    ``build_lm_params``."""
    if cfg.family != "mamba":
        raise ValueError(f"{cfg.name} is not a mamba2 (mamba) config")
    d, n, v = cfg.d_model, cfg.num_layers, cfg.padded_vocab
    specs: ParamSpecs = {"embed": ((v, d), 0.02)}
    specs.update(ssm_params("blk.ssm", cfg, n))
    specs["blk.ln"] = ((n, d), 0.0)
    specs["final_norm"] = ((d,), 0.0)
    specs["lm_head"] = ((d, v), fan_in_scale((d, v)))
    return specs


def _layers(params: Params, cfg: ModelConfig):
    """Per-layer parameter dicts (slice ``[i]`` of every stacked ``blk.*``
    tensor, named without the ``blk.`` prefix)."""
    blk = {k[len("blk."):]: w for k, w in params.items()
           if k.startswith("blk.")}
    return [{k: w[i] for k, w in blk.items()} for i in range(cfg.num_layers)]


def _lm_head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"] + 1.0, cfg.norm_eps)
    return mask_vocab_logits(linear(x, params["lm_head"]), cfg.vocab_size)


def mamba_layer(cfg: ModelConfig, x: torch.Tensor, lp: Params,
                chunk: int) -> torch.Tensor:
    """One pre-norm mixer block with its residual (``lp``: its ``ln`` and
    ``ssm.*`` parameters), the layer of the mamba and hybrid families."""
    h = rms_norm(x, lp["ln"] + 1.0, cfg.norm_eps)
    return x + mamba2_mixer(lp, "ssm", cfg, h, chunk=chunk)


def mamba_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                  chunk: int = 256) -> torch.Tensor:
    """Logits (B, T, V) of the whole sequence ``tokens`` (B, T); under a
    gradient each layer recomputed in the backward when ``cfg.remat``
    (:func:`.layers.remat_wanted`), all of it whatever
    ``cfg.remat_policy`` says, as the JAX forward wraps it in
    ``jax.checkpoint`` with ``nothing_saveable``."""
    remat = remat_wanted(cfg, params)
    x = params["embed"][tokens.long()]
    for lp in _layers(params, cfg):
        x = rematerialised(remat, mamba_layer, cfg, x, lp, chunk)
    return _lm_head(params, cfg, x)


def init_lm_state(cfg: ModelConfig, batch: int, device="cpu") -> State:
    """The decode carry of ``batch`` sequences, zeros (fp32, as in JAX)."""
    ch = cfg.d_inner + 2 * cfg.ssm_state
    n, h, p, s = (cfg.num_layers, cfg.ssm_heads, cfg.ssm_head_dim,
                  cfg.ssm_state)
    return {
        "conv": torch.zeros((n, batch, CONV_K - 1, ch), dtype=torch.float32,
                            device=device),
        "ssm": torch.zeros((n, batch, h, p, s), dtype=torch.float32,
                           device=device),
    }


def mamba_decode_step(params: Params, cfg: ModelConfig, state: State,
                      tokens: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """One token per row, tokens (B, 1): logits (B, 1, V) and the new
    carry (the old one is not written).  O(1) in context length."""
    x = params["embed"][tokens.long()]
    conv, ssm = [], []
    for i, lp in enumerate(_layers(params, cfg)):
        h = rms_norm(x, lp["ln"] + 1.0, cfg.norm_eps)
        out, c, s = mamba2_decode(lp, "ssm", cfg, h, state["conv"][i],
                                  state["ssm"][i])
        x = x + out
        conv.append(c)
        ssm.append(s)
    return _lm_head(params, cfg, x), {"conv": torch.stack(conv),
                                      "ssm": torch.stack(ssm)}


def mamba_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                  chunk: int = 256) -> Tuple[torch.Tensor, State]:
    """The whole prompt (B, T) at once: last-position logits (B, 1, V) and
    the decode carry after it."""
    x = params["embed"][tokens.long()]
    conv, ssm = [], []
    for lp in _layers(params, cfg):
        h = rms_norm(x, lp["ln"] + 1.0, cfg.norm_eps)
        out, c, s = mamba2_mixer(lp, "ssm", cfg, h, chunk=chunk,
                                 return_state=True)
        x = x + out
        conv.append(c)
        ssm.append(s)
    return _lm_head(params, cfg, x[:, -1:]), {"conv": torch.stack(conv),
                                              "ssm": torch.stack(ssm)}


# ---------------------------------------------------------------------------
# Paged serving: state pools behind the StateCache contract.
# ---------------------------------------------------------------------------


def init_paged_state(cfg: ModelConfig, state_slots: int,
                     state_dtype: str = "float32", device="cpu") -> State:
    """State pools, physical state slot at axis 1.  ``state_dtype="int8"``
    stores the SSD state int8 with per-(layer, slot, head) scales; the conv
    window stays fp32 (small, and re-quantizing a sliding window every
    token would compound)."""
    ch = cfg.d_inner + 2 * cfg.ssm_state
    n, s = cfg.num_layers, state_slots
    shape = (n, s, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    pools = {"conv": torch.zeros((n, s, CONV_K - 1, ch), dtype=torch.float32,
                                 device=device)}
    if state_dtype == "int8":
        pools["ssm"] = torch.zeros(shape, dtype=torch.int8, device=device)
        pools["ssm_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                         device=device)
    elif state_dtype == "float32":
        pools["ssm"] = torch.zeros(shape, dtype=torch.float32, device=device)
    else:
        raise ValueError(f"unsupported state_dtype {state_dtype!r}")
    return pools


def mamba_decode_paged(params: Params, cfg: ModelConfig, cache: State,
                       tokens: torch.Tensor, lengths: torch.Tensor,
                       new_counts: torch.Tensor,
                       block_tables: torch.Tensor) -> torch.Tensor:
    """Paged decode/prefill chunk, tokens (B, T): the same per-token
    recurrence as the slot engine (identical greedy outputs), the state
    gathered from the combined block table's read column and scattered to
    its write columns, in place."""
    _, read, writes = split_state_tables(block_tables, tokens.shape[1])
    state = gather_state(cache, read)
    outs = []
    for t in range(tokens.shape[1]):
        logits, state = mamba_decode_step(params, cfg, state,
                                          tokens[:, t:t + 1])
        scatter_state(cache, state, writes[:, t])
        outs.append(logits)
    return torch.cat(outs, dim=1)
