"""The paper's three benchmark CNNs, LeNet-5, ResNet-20 and MobileNet-V1,
in PyTorch.

Port of the JAX package's ``repro.models.cnn``: NHWC activations, HWIO
filters and the JAX parameter names, so bridged JAX params load name for
name.  Every dense convolution goes through :func:`apr_conv2d`, which
launches the hand-written ``apr_conv`` kernel for CUDA tensors and computes
the plain version for CPU tensors -- so the device picks the path, and the
JAX ``conv_impl`` switch has no counterpart.  ``conv=`` swaps in another
conv with the same signature (the memory-resident baseline, or the plain
version on the card).  ReLU, pooling and the FC products stay plain torch,
as the JAX package computes them outside any kernel.

MobileNet-V1's depthwise convs stay plain PyTorch too
(``F.conv2d(groups=C)``, :func:`depthwise`): the JAX model computes them
with ``lax.conv_general_dilated`` under every ``conv_impl`` (its
``"pallas"`` branch falls through to ``lax``), outside any Pallas kernel,
so there is no TPU kernel to port there.  Its first conv and its 13
pointwise convs run on ``apr_conv``: 14 launches a forward.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..kernels._leaf import graph_leaf
from ..kernels.apr_conv import apr_conv2d, conv2d_ref

Params = Dict[str, torch.Tensor]
#: name -> (shape, init scale)
ParamSpecs = Dict[str, Tuple[Tuple[int, ...], float]]
Conv = Callable[..., torch.Tensor]


def _scale(shape: Tuple[int, ...]) -> float:
    """The JAX ``ParamBuilder`` rule, kept as it is: ``fan_in`` is
    ``shape[-2]``, which for an HWIO filter is C, not Hf·Wf·C."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return fan_in ** -0.5


def _specs(shapes: Dict[str, Tuple[int, ...]]) -> ParamSpecs:
    return {name: (shape, _scale(shape)) for name, shape in shapes.items()}


def init_params(specs: ParamSpecs, generator: Optional[torch.Generator],
                device) -> Params:
    """``normal * scale`` in fp32, drawn in sorted-name order (as the JAX
    builder splits its key) from ``generator``, which lives on ``device``
    (default: a generator seeded 0)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return {name: torch.randn(shape, generator=generator,
                              dtype=torch.float32, device=dev) * scale
            for name, (shape, scale) in sorted(specs.items())}


def _avgpool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // k, k, w // k, k, c).mean(dim=(2, 4))


def _gap(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


# ---------------------------------------------------------------- LeNet-5
def lenet_param_specs() -> ParamSpecs:
    return _specs({"c1": (5, 5, 1, 6), "c2": (5, 5, 6, 16),
                   "f1": (400, 120), "f2": (120, 84), "f3": (84, 10)})


def lenet_params(generator: Optional[torch.Generator] = None, *,
                 device="cuda") -> Params:
    return init_params(lenet_param_specs(), generator, device)


def lenet_forward(p: Params, x: torch.Tensor, *,
                  conv: Conv = apr_conv2d) -> torch.Tensor:
    """x: (B, 32, 32, 1) -> logits (B, 10)."""
    x = torch.relu(conv(x, p["c1"], stride=1, padding=0))   # 28x28x6
    x = _avgpool(x)                                         # 14x14x6
    x = torch.relu(conv(x, p["c2"], stride=1, padding=0))   # 10x10x16
    x = _avgpool(x)                                         # 5x5x16
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ p["f1"])
    x = torch.relu(x @ p["f2"])
    return x @ p["f3"]


# ------------------------------------------------------- ResNet-20 (CIFAR)
def resnet20_param_specs() -> ParamSpecs:
    shapes = {"conv1": (3, 3, 3, 16)}
    ch_in = 16
    for stage, ch in enumerate((16, 32, 64)):
        for b in range(3):
            cin = ch_in if b == 0 else ch
            shapes[f"s{stage}b{b}c1"] = (3, 3, cin, ch)
            shapes[f"s{stage}b{b}c2"] = (3, 3, ch, ch)
            if cin != ch:
                shapes[f"s{stage}b{b}sc"] = (1, 1, cin, ch)
        ch_in = ch
    shapes["fc"] = (64, 10)
    return _specs(shapes)


def resnet20_params(generator: Optional[torch.Generator] = None, *,
                    device="cuda") -> Params:
    return init_params(resnet20_param_specs(), generator, device)


def resnet20_forward(p: Params, x: torch.Tensor, *,
                     conv: Conv = apr_conv2d) -> torch.Tensor:
    """x: (B, 32, 32, 3) -> logits (B, 10)."""
    x = torch.relu(conv(x, p["conv1"], stride=1, padding=1))
    for stage in range(3):
        for b in range(3):
            stride = 2 if (stage > 0 and b == 0) else 1
            h = torch.relu(conv(x, p[f"s{stage}b{b}c1"], stride=stride,
                                padding=1))
            h = conv(h, p[f"s{stage}b{b}c2"], stride=1, padding=1)
            sc = p.get(f"s{stage}b{b}sc")
            shortcut = (conv(x, sc, stride=stride, padding=0)
                        if sc is not None else x)
            x = torch.relu(h + shortcut)
    return _gap(x) @ p["fc"]


# ------------------------------------- MobileNet-V1 (32x32, "(Scaled)")
#: (cin, cout, stride) of each depthwise-separable pair, the JAX model's
_MOBILENET_CFG = [
    (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
    (256, 256, 1), (256, 512, 2),
    (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
    (512, 1024, 2), (1024, 1024, 1),
]


def mobilenet_param_specs() -> ParamSpecs:
    """The JAX builder's names, shapes and scales.  ``dw{i}`` keeps its
    as-built ``(3, 3, cin, 1)`` layout: channel ``c``'s filter is
    ``[:, :, c, 0]``."""
    shapes = {"conv1": (3, 3, 3, 32)}
    for i, (cin, cout, _s) in enumerate(_MOBILENET_CFG):
        shapes[f"dw{i}"] = (3, 3, cin, 1)
        shapes[f"pw{i}"] = (1, 1, cin, cout)
    shapes["fc"] = (1024, 10)
    return _specs(shapes)


def mobilenet_params(generator: Optional[torch.Generator] = None, *,
                     device="cuda") -> Params:
    return init_params(mobilenet_param_specs(), generator, device)


@graph_leaf
def depthwise(x: torch.Tensor, f: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 depthwise conv, padding 1, of NHWC ``x`` with the ``(3, 3, C,
    1)`` filter ``f`` (channel ``c``'s filter ``f[:, :, c, 0]``): one
    filter a channel, ``F.conv2d(groups=C)``, plain PyTorch on every
    device, as the JAX model computes it with ``lax`` outside any kernel
    (exact fp32 products where cuDNN's TF32 is off, as the launchers and
    ``chip_smoke.py`` set it).  The graph tracer records it as one
    NHWC ``conv2d`` node with ``feature_group_count = C``, the JAX model's
    grouped conv, which no fused kernel serves."""
    c = x.shape[-1]
    w = f[:, :, :, 0].permute(2, 0, 1)[:, None]         # (C, 1, 3, 3)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=1,
                 groups=c)
    return y.permute(0, 2, 3, 1)


def mobilenet_forward(p: Params, x: torch.Tensor, *, conv: Conv = apr_conv2d,
                      dw: Callable[..., torch.Tensor] = depthwise
                      ) -> torch.Tensor:
    """x: (B, 32, 32, 3) -> logits (B, 10).  ``conv`` takes the first and
    the pointwise convs, ``dw`` the depthwise ones."""
    x = torch.relu(conv(x, p["conv1"], stride=1, padding=1))
    for i, (_cin, _cout, s) in enumerate(_MOBILENET_CFG):
        x = torch.relu(dw(x, p[f"dw{i}"], s))
        x = torch.relu(conv(x, p[f"pw{i}"], stride=1, padding=0))
    return _gap(x) @ p["fc"]


CNNS: Dict[str, Dict] = {
    "lenet": {"params": lenet_params, "forward": lenet_forward,
              "specs": lenet_param_specs, "input": (32, 32, 1)},
    "resnet20": {"params": resnet20_params, "forward": resnet20_forward,
                 "specs": resnet20_param_specs, "input": (32, 32, 3)},
    "mobilenet_v1": {"params": mobilenet_params, "forward": mobilenet_forward,
                     "specs": mobilenet_param_specs, "input": (32, 32, 3)},
}


def conv_geometries(name: str, batch: int = 1) -> List[Dict]:
    """Every conv of one forward of ``CNNS[name]`` at ``batch`` that goes
    through ``conv=`` (the ``apr_conv`` launches; not MobileNet's plain
    depthwise convs), in order: ``dict(param, x_shape, f_shape, stride,
    padding)``.  The forward runs on meta tensors, so nothing is
    computed."""
    spec = CNNS[name]
    params = {n: torch.empty(shape, device="meta")
              for n, (shape, _) in spec["specs"]().items()}
    by_id = {id(t): n for n, t in params.items()}
    calls: List[Dict] = []

    def record(x, f, *, stride, padding):
        calls.append(dict(param=by_id[id(f)], x_shape=tuple(x.shape),
                          f_shape=tuple(f.shape), stride=stride,
                          padding=padding))
        return conv2d_ref(x, f, stride=stride, padding=padding)

    x = torch.empty((batch,) + spec["input"], device="meta")
    spec["forward"](params, x, conv=record)
    return calls


def hbm_conv(x: torch.Tensor, f: torch.Tensor, *, stride: int = 1,
             padding: int = 0) -> torch.Tensor:
    """``apr_conv2d`` with the memory-resident baseline (``conv=`` of the
    forwards): the paper's F-extension comparison point."""
    return apr_conv2d(x, f, stride=stride, padding=padding, residency="hbm")
