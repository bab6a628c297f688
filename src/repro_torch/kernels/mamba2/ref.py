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


def mamba2_ref_bwd(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   dt: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                   dy: torch.Tensor):
    """The gradient of :func:`mamba2_ref` (from a zero state, none out)
    with respect to x, b, c, dt, a and d, given ``dy`` (B, T, H, P): fp32
    step by step, a forward sweep for the states ``h_t``, then a reverse
    sweep for ``G_t = dL/dh_t = dy_t c_tᵀ + e^{a dt_{t+1}} G_{t+1}``.  Per
    step

        dx_t = dt_t G_t b_t + d·dy_t
        db_t = Σ_h dt_t G_tᵀ x_t,   dc_t = Σ_h h_tᵀ dy_t
        ddt_t = Σ G_t⊙(a·e^{a dt_t} h_{t-1} + x_t b_tᵀ)

    and ``da = Σ_{b,t} dt_t e^{a dt_t} Σ G_t⊙h_{t-1}``, ``dd = Σ_{b,t,p}
    dy_t⊙x_t``.  Returns (dx, db, dc, ddt, da, dd) in fp32."""
    bsz, t, h, p = x.shape
    xf, bf, cf, dtf, dyf = (v.float() for v in (x, b, c, dt, dy))
    af, df = a.float(), d.float()
    decay = torch.exp(af[None, None, :] * dtf)                  # (B,T,H)
    hstate = torch.zeros((bsz, h, p, b.shape[-1]), dtype=torch.float32,
                         device=x.device)
    states = [hstate]                           # h_{-1}, h_0, ..., h_{T-1}
    for i in range(t):
        hstate = (decay[:, i, :, None, None] * hstate
                  + dtf[:, i, :, None, None] * (xf[:, i, :, :, None]
                                                * bf[:, i, None, None, :]))
        states.append(hstate)
    dx, db, dc, ddt = (torch.zeros_like(v) for v in (xf, bf, cf, dtf))
    da, dd = torch.zeros_like(af), torch.zeros_like(df)
    carry = torch.zeros_like(hstate)            # e^{a dt_{t+1}} G_{t+1}
    for i in reversed(range(t)):
        g = carry + dyf[:, i, :, :, None] * cf[:, i, None, None, :]
        dc[:, i] = torch.einsum("bhpn,bhp->bn", states[i + 1], dyf[:, i])
        gb = torch.einsum("bhpn,bn->bhp", g, bf[:, i])          # G_t b_t
        dx[:, i] = dtf[:, i, :, None] * gb + df[None, :, None] * dyf[:, i]
        db[:, i] = torch.einsum("bhpn,bhp,bh->bn", g, xf[:, i], dtf[:, i])
        q = decay[:, i] * (g * states[i]).sum((-1, -2))  # dL/d(a dt_t)
        ddt[:, i] = af[None, :] * q + (xf[:, i] * gb).sum(-1)
        da = da + (dtf[:, i] * q).sum(0)
        dd = dd + (dyf[:, i] * xf[:, i]).sum((0, 2))
        carry = decay[:, i, :, None, None] * g
    return dx, db, dc, ddt, da, dd
