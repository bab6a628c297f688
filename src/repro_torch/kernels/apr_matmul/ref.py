"""Plain PyTorch versions of ``apr_matmul`` and its fused-epilogue variant
(mirror of the JAX ``ref.py``)."""
import torch
import torch.nn.functional as F


def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ y`` accumulated in fp32 and rounded once to ``out_dtype``.

    The operands are widened to fp32 before the product, so a bf16 input
    never meets a bf16 accumulator.  On a GPU the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` False, or the product rounds
    its inputs to TF32."""
    return torch.matmul(x.float(), y.float()).to(out_dtype)


#: epilogue activations, by name, with their codes in the CUDA kernels
ACTIVATIONS = {"none": 0, "relu": 1, "silu": 2, "gelu": 3}


def activation_ref(x: torch.Tensor, activation: str) -> torch.Tensor:
    """Epilogue activations in the order the fused kernels apply them.
    ``gelu`` is the tanh approximation, the default of ``jax.nn.gelu``."""
    if activation == "none":
        return x
    if activation == "relu":
        return torch.clamp_min(x, 0.0)
    if activation == "silu":
        return x * torch.sigmoid(x)
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {activation!r}")


def matmul_fused_ref(x: torch.Tensor, y: torch.Tensor,
                     bias=None, activation: str = "relu",
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``activation(x @ y + bias)``: fp32 accumulator, bias first, then the
    activation, rounded once to ``out_dtype``."""
    acc = torch.matmul(x.float(), y.float())
    if bias is not None:
        acc = acc + bias.reshape(1, -1).float()
    return activation_ref(acc, activation).to(out_dtype)
