"""Plain PyTorch versions of ``apr_matmul`` and its fused-epilogue variant
(mirror of the JAX ``ref.py``), and their split-K forms: the CUDA kernels
cut K into ``splits`` ranges of whole multiples of :data:`K_RANGE` rows
(:func:`split_range`), keep one fp32 partial per range and add the
partials in split order (:func:`matmul_split_ref`,
:func:`matmul_fused_split_ref`)."""
import torch
import torch.nn.functional as F

from .._leaf import graph_leaf


def _fp32_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x (M, K) @ y (K, N)`` on fp32 operands.  On the CPU a single row
    is taken from a product of two: PyTorch's CPU matmul sums a lone row
    (its matrix-vector path) in another order than the rows of a larger
    product, one fp32 ulp apart now and then, so without it a row's bits
    would depend on its batch -- a paged prefill chunk of one row against
    the slot engine's batch of all slots -- and the engines' bf16 greedy
    tokens part (``tests/test_torch_state.py``, zamba2).
    ``tests/test_torch_forward.py`` holds a row's bits equal at M = 1, 2,
    4 and 16."""
    x, y = x.float(), y.float()
    if x.dim() == 2 and x.shape[0] == 1 and x.device.type == "cpu":
        return torch.matmul(x.expand(2, -1), y)[:1]
    return torch.matmul(x, y)


@graph_leaf
def matmul_ref(x: torch.Tensor, y: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ y`` accumulated in fp32 and rounded once to ``out_dtype``.

    The operands are widened to fp32 before the product, so a bf16 input
    never meets a bf16 accumulator, and each row's sum is that of a
    multi-row product (:func:`_fp32_matmul`).  On a GPU the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` False, or the product rounds
    its inputs to TF32."""
    return _fp32_matmul(x, y).to(out_dtype)


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
    acc = _fp32_matmul(x, y)
    if bias is not None:
        acc = acc + bias.reshape(1, -1).float()
    return activation_ref(acc, activation).to(out_dtype)


#: split-K ranges are whole multiples of this many K rows (the largest
#: block_k the kernels compile), so every tile cuts K alike
K_RANGE = 128


def split_range(k: int, splits: int, unit: int = K_RANGE) -> int:
    """K rows per split range: ``ceil(ceil(K / unit) / splits) * unit``
    (``unit`` 128 here, 256 for ``quant_matmul``: the largest block_k each
    family compiles).  Split ``s`` takes rows ``[s * range, min(K, (s + 1)
    * range))``; the last ones may be short or empty."""
    return -(-(-(-k // unit)) // splits) * unit


def _split_partials(x: torch.Tensor, y: torch.Tensor, splits: int
                    ) -> torch.Tensor:
    """fp32 ``x @ y``: one fp32 partial per split range (an empty range
    adds exactly 0), added in split order."""
    k = x.shape[1]
    rng = split_range(k, splits)
    acc = None
    for s in range(splits):
        lo, hi = min(k, s * rng), min(k, (s + 1) * rng)
        part = _fp32_matmul(x[:, lo:hi], y[lo:hi])
        acc = part if acc is None else acc + part
    return acc


def matmul_split_ref(x: torch.Tensor, y: torch.Tensor, splits: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ y`` as the split-K kernels sum it: the fp32 partials of the
    ``splits`` ranges of :func:`split_range`, added in split order, rounded
    once to ``out_dtype``.  At one split it is :func:`matmul_ref`."""
    return _split_partials(x, y, splits).to(out_dtype)


def matmul_fused_split_ref(x: torch.Tensor, y: torch.Tensor, splits: int,
                           bias=None, activation: str = "relu",
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """``activation(x @ y + bias)`` with the product of
    :func:`matmul_split_ref`: the split partials added in split order, then
    the bias, then the activation, rounded once to ``out_dtype``."""
    acc = _split_partials(x, y, splits)
    if bias is not None:
        acc = acc + bias.reshape(1, -1).float()
    return activation_ref(acc, activation).to(out_dtype)
