"""Plain PyTorch version of ``apr_matmul`` (mirror of the JAX ``ref.py``)."""
import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ y`` accumulated in fp32 and rounded once to ``out_dtype``.

    The operands are widened to fp32 before the product, so a bf16 input
    never meets a bf16 accumulator.  On a GPU the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` False, or the product rounds
    its inputs to TF32."""
    return torch.matmul(x.float(), y.float()).to(out_dtype)
