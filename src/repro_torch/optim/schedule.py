"""LR schedules (pure functions of the step counter), as the JAX
package's ``repro.optim.schedule`` computes them, in fp32."""
import math

import torch


def warmup_cosine(step, *, peak_lr=3e-4, warmup=100, total=10_000, floor=0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine to
    ``floor * peak_lr`` at ``total``.  ``step`` is an int or a tensor; the
    result is a 0-d fp32 tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(step / warmup, max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, peak_lr * cos)
