"""Plain PyTorch version of the Mamba-2 SSD recurrence: a scan over time in
fp32 (mirror of the JAX ``ref.py``), extended by an initial state in and
the final state out."""
from typing import Optional

import torch


def mamba2_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor, *,
               h_init: Optional[torch.Tensor] = None,
               return_state: bool = False):
    """x: (B, T, H, P); b/c: (B, T, N), per batch row and shared by every
    head; dt: (B, T, H); a/d: (H,); h_init: (B, H, P, N) fp32 or None
    (zeros).  Returns y (B, T, H, P) in x's dtype, and with
    ``return_state`` also the final fp32 state.  Per step ``h = exp(a·dt) h
    + dt x bᵀ``, then ``y = h c + d x``."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    xf, bf, cf, dtf = (v.float() for v in (x, b, c, dt))
    af, df = a.float(), d.float()
    hstate = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device)
              if h_init is None else h_init.float())
    ys = []
    for i in range(t):
        dtt = dtf[:, i]                                        # (B, H)
        decay = torch.exp(af[None, :] * dtt)[..., None, None]
        upd = dtt[..., None, None] * (xf[:, i, :, :, None]
                                      * bf[:, i, None, None, :])
        hstate = decay * hstate + upd
        ys.append(torch.einsum("bhpn,bn->bhp", hstate, cf[:, i])
                  + df[None, :, None] * xf[:, i])
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((bsz, 0, h, p), device=x.device)).to(x.dtype)
    return (y, hstate) if return_state else y
