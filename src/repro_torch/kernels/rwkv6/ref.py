"""Plain PyTorch version of the RWKV-6 WKV recurrence: a scan over time in
fp32 (mirror of the JAX ``ref.py``), extended by an initial state in and
the final state out."""
from typing import Optional

import torch


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, *,
              s_init: Optional[torch.Tensor] = None,
              return_state: bool = False):
    """r/k/v/w: (B, T, H, D), w the decay in (0, 1); u: (H, D); s_init:
    (B, H, D, D) fp32 or None (zeros).  Returns y (B, T, H, D) in r's
    dtype, and with ``return_state`` also the final fp32 state.  Per step
    ``y_t = (S + diag(u) k_t v_tᵀ)ᵀ r_t``, then ``S = diag(w_t) S +
    k_t v_tᵀ``."""
    b, t, h, d = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    state = (torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
             if s_init is None else s_init.float())
    ys = []
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]        # (B,H,D,D)
        ys.append(torch.einsum("bhij,bhi->bhj",
                               state + uf[None, :, :, None] * kv, rf[:, i]))
        state = wf[:, i, :, :, None] * state + kv
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((b, 0, h, d), device=r.device)).to(r.dtype)
    return (y, state) if return_state else y
