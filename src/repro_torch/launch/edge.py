"""The paper's edge-inference scenario on the port, both levels.

Level B: LeNet-5, ResNet-20 and MobileNet-V1 inference with every dense
convolution on the ``apr_conv`` kernel (on the GPU unless ``--device
cpu``; MobileNet's depthwise convs stay plain PyTorch, as the JAX model
computes them outside any kernel), each forward checked against the plain
path -- the same weights and device, the conv
computed by :func:`conv2d_ref` -- and reported with its logits shape,
argmax, ms per forward and kernel launches.

Level A: the reproduced Table III (RV64F vs Baseline vs RV64R on the
modelled 5-stage edge core), from :mod:`repro_torch.core`.

    PYTHONPATH=src python -m repro_torch.launch.edge
    PYTHONPATH=src python -m repro_torch.launch.edge --device cpu --quick
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

SEED = 0
#: |forward - plain forward| <= LOGITS_RTOL * max |plain logit|: the two sum
#: the same fp32 products in another order (ResNet-20 has no normalisation,
#: so its logits reach ~1e6 and only a relative bound means anything)
LOGITS_RTOL = 1e-4


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_level_b(names: List[str], batch: int, device,
                iters: int = 5) -> List[dict]:
    from .._device import resolve_device
    from ..kernels.apr_conv import apr_conv2d, conv2d_ref
    from ..models.cnn import CNNS

    dev = resolve_device(device)
    if dev.type == "cuda":
        # the plain path is exact fp32: cuDNN would otherwise round the
        # conv inputs to TF32 (its default), 5e-4 off at LeNet's logits
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"=== Level B: CNN inference on {dev} (batch {batch}) ===")
    rows = []
    for name in names:
        spec = CNNS[name]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = spec["params"](gen, device=dev)
        x = torch.randn((batch,) + spec["input"], generator=gen, device=dev)
        fwd = spec["forward"]
        fwd(params, x)                                  # warm: builds
        _sync(dev)
        apr_conv2d.launches = 0
        t0 = time.perf_counter()
        for _ in range(iters):
            logits = fwd(params, x)
        _sync(dev)
        ms = (time.perf_counter() - t0) / iters * 1e3
        launches = apr_conv2d.launches // iters
        ref = fwd(params, x, conv=conv2d_ref)
        scale = float(ref.abs().max())
        err = float((logits - ref).abs().max()) / max(scale, 1e-30)
        pred = logits.argmax(-1)
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{name}: non-finite logits")
        if err > LOGITS_RTOL or not torch.equal(pred, ref.argmax(-1)):
            raise RuntimeError(f"{name}: forward differs from the plain "
                               f"path (max |diff| / max |logit| {err:.3g})")
        row = dict(net=name, batch=batch, device=str(dev),
                   logits_shape=tuple(logits.shape), ms=ms,
                   images_per_s=batch / ms * 1e3,
                   apr_conv_launches=launches, rel_err=err)
        rows.append(row)
        print(f"{name:9s} logits {tuple(logits.shape)} argmax "
              f"{pred[:8].tolist()} {ms:9.3f} ms/forward "
              f"({row['images_per_s']:.1f} img/s), apr_conv launches "
              f"{launches}/forward, max|diff|/max|logit| vs plain {err:.2e}")
    return rows


def run_level_a(models) -> None:
    from ..core.isa import Isa
    from ..core.simulate import enhancement, simulate_model

    print("\n=== Level A: reproduced Table III (per model) ===")
    print(f"{'model':13s} {'ISA':9s} {'runtime':>9s} {'IC':>13s} "
          f"{'IPC':>6s} {'mem':>13s} {'L1':>13s}")
    for model in models:
        rows = {isa: simulate_model(model, isa) for isa in Isa}
        for isa, m in rows.items():
            print(f"{model:13s} {isa.pretty:9s} {m.runtime_s:8.3f}s "
                  f"{m.instructions:13,} {m.ipc:6.3f} {m.mem_instrs:13,} "
                  f"{m.l1_accesses:13,}")
        e = enhancement(rows[Isa.RV64F], rows[Isa.RV64R])
        print(f"{'':13s} RV64R over RV64F: runtime -{e['runtime']:.1f}%  "
              f"IC -{e['IC']:.1f}%  IPC +{e['IPC']:.1f}%  "
              f"mem -{e['mem_instrs']:.1f}%")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--net", choices=("lenet", "resnet20", "mobilenet_v1"),
                    default=None, help="one net (default: all three)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--quick", action="store_true",
                    help="LeNet only, at both levels")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; the apr_conv kernel) or 'cpu' "
                         "(its plain PyTorch version)")
    args = ap.parse_args(argv)
    names = (["lenet"] if args.quick else
             [args.net] if args.net else ["lenet", "resnet20",
                                          "mobilenet_v1"])
    run_level_b(names, args.batch, args.device)
    run_level_a(("lenet",) if args.quick else
                ("lenet", "resnet20", "mobilenet_v1"))


if __name__ == "__main__":
    main()
