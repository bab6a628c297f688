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


def rwkv6_ref_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor):
    """The gradient of :func:`rwkv6_ref` (from a zero state, none out)
    with respect to r, k, v, w and u, given ``dy`` (B, T, H, D): fp32 step
    by step, a forward sweep for the states, then a reverse sweep for the
    state gradient ``G_t = dL/dS_t``, ``G_{t-1} = diag(w_t) G_t + r_t
    dy_tᵀ``.  Per step

        dr_t = S_{t-1} dy_t + u⊙k_t (v_t·dy_t)
        dk_t = G_t v_t + u⊙r_t (v_t·dy_t)
        dv_t = G_tᵀ k_t + (Σ_i u_i r_ti k_ti) dy_t
        dw_t[i] = Σ_j G_t[i,j] S_{t-1}[i,j]

    and ``du = Σ_{b,t} r_t⊙k_t (v_t·dy_t)``.  Returns (dr, dk, dv, dw, du)
    in fp32."""
    b, t, h, d = r.shape
    rf, kf, vf, wf, dyf = (x.float() for x in (r, k, v, w, dy))
    uf = u.float()
    state = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    prev = []                                   # S_{t-1} of every step
    for i in range(t):
        prev.append(state)
        state = (wf[:, i, :, :, None] * state
                 + kf[:, i, :, :, None] * vf[:, i, :, None, :])
    vdy = (vf * dyf).sum(-1)[..., None]                         # (B,T,H,1)
    beta = (rf * uf * kf).sum(-1)[..., None]                    # (B,T,H,1)
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    g = torch.zeros_like(state)
    for i in reversed(range(t)):
        dr[:, i] = (torch.einsum("bhij,bhj->bhi", prev[i], dyf[:, i])
                    + uf * kf[:, i] * vdy[:, i])
        dk[:, i] = (torch.einsum("bhij,bhj->bhi", g, vf[:, i])
                    + uf * rf[:, i] * vdy[:, i])
        dv[:, i] = (torch.einsum("bhij,bhi->bhj", g, kf[:, i])
                    + beta[:, i] * dyf[:, i])
        dw[:, i] = (g * prev[i]).sum(-1)
        g = (wf[:, i, :, :, None] * g
             + rf[:, i, :, :, None] * dyf[:, i, :, None, :])
    du = (rf * kf * vdy).sum((0, 1))
    return dr, dk, dv, dw, du
