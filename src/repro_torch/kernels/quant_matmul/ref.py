"""Plain PyTorch versions of ``quant_matmul`` and ``quant_matmul_fused``
(mirror of the JAX ``ref.py``), and the split-K form the CUDA kernel sums
in (:func:`quant_matmul_split_ref`).

The same arithmetic as the kernels: per-row dynamic activation
quantization, an exact integer contraction, and the two fp32 scale
multiplies on the integer total, then bias and activation.  The integer
sum is taken in fp64, where every partial sum of int8 products is an exact
integer (|sum| <= 127·127·K < 2^53), so it equals the int32 total on every
device (CUDA has no int32 matmul); converting it to fp32 rounds as the
kernels' int32 -> fp32 conversion does.
"""
import torch

from ...quant import INT8_MAX
from ..apr_matmul.ref import activation_ref, split_range

#: 1/127, rounded to fp32 where it multiplies
INV_INT8_MAX = 1.0 / 127.0
#: split-K ranges of the CUDA kernel are whole multiples of this many K
#: rows, the largest block_k it compiles
K_RANGE = 256


def quantize_activations(x: torch.Tensor):
    """Dynamic per-row symmetric int8: (M, K) float -> int8 codes + (M, 1)
    fp32 scales, as the JAX package's jitted ``quantize_activations``
    computes them: XLA folds its ``amax / 127`` into a multiply by
    :data:`INV_INT8_MAX`, while ``x / scale`` stays a true fp32 division,
    rounded half to even and clipped to +-127.  The CUDA kernel makes the
    same codes and scales inside its launch."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a Python scalar multiplies an fp32 tensor in fp32, on either device,
    # and needs no copy to the card
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) * INV_INT8_MAX
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def int8_total(x_q: torch.Tensor, y_q: torch.Tensor) -> torch.Tensor:
    """``x_q (M, K) @ y_q (K, N)`` of int8 codes, exactly, as fp32."""
    return torch.matmul(x_q.double(), y_q.double()).float()


def int8_split_total(x_q: torch.Tensor, y_q: torch.Tensor,
                     splits: int) -> torch.Tensor:
    """The integer total as the split-K kernel forms it: one exact partial
    per :func:`~repro_torch.kernels.apr_matmul.ref.split_range` range of
    :data:`K_RANGE`-row multiples (an empty range adds 0), the partials
    added, then rounded once to fp32 -- the same value at every split
    count."""
    k = x_q.shape[1]
    rng = split_range(k, splits, K_RANGE)
    total = None
    for s in range(splits):
        lo, hi = min(k, s * rng), min(k, (s + 1) * rng)
        part = torch.matmul(x_q[:, lo:hi].double(), y_q[lo:hi].double())
        total = part if total is None else total + part
    return total.float()


def _scaled(total, x_scale, y_scale, n, out_dtype):
    return (total * x_scale * y_scale.reshape(1, n).float()).to(out_dtype)


def quant_matmul_ref(x, y_q, y_scale=None, out_dtype=torch.float32):
    if hasattr(y_q, "q"):                       # QuantizedTensor
        y_q, y_scale = y_q.q, y_q.scale
    x_q, x_scale = quantize_activations(x)
    return _scaled(int8_total(x_q, y_q), x_scale, y_scale, y_q.shape[1],
                   out_dtype)


def quant_matmul_split_ref(x, y_q, y_scale, splits: int,
                           out_dtype=torch.float32):
    """:func:`quant_matmul_ref` over :func:`int8_split_total`: the split-K
    kernel's order of sums, which equals the unsplit one bit for bit."""
    x_q, x_scale = quantize_activations(x)
    return _scaled(int8_split_total(x_q, y_q, splits), x_scale, y_scale,
                   y_q.shape[1], out_dtype)


def quant_matmul_fused_ref(x, y_q, y_scale=None, bias=None,
                           activation="relu", out_dtype=torch.float32):
    acc = quant_matmul_ref(x, y_q, y_scale, out_dtype=torch.float32)
    if bias is not None:
        acc = acc + bias.reshape(1, -1).float()
    return activation_ref(acc, activation).to(out_dtype)
