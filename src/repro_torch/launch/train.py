"""Training launcher of the port: the train step (``train/step.py``) under
the fault-tolerant controller (``runtime/``), with checkpoints in the JAX
package's layout, on the GPU unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
        --steps 50 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --resume --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
        --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch arctic-480b \\
        --device cpu --steps 4

It trains the arch's smoke config (``--full``: the published one) from
random weights (seed 0) on ``SyntheticLMSource`` batches, with the
config's optimizer (AdamW, or Adafactor for the moe archs), warmup 10
steps and a cosine over ``--total-steps`` (default ``--steps``, as the JAX
launcher's schedule; a run split by ``--resume`` passes the whole run's
length to every part so that its schedule, and its losses, are those of
one uninterrupted run).  The families it trains are
``train.step.TRAIN_FAMILIES``: the dense and vlm archs, arctic-480b and
llama4-maverick-400b-a17b (``moe``), rwkv6-3b (``ssm``), mamba2-2.7b
(``mamba``), zamba2-1.2b (``hybrid``) and whisper-large-v3 (``audio``, on
stub frames).  ``--full`` on a moe arch is refused by name: its 35 or 48
published layers need expert parallelism over several cards (ROADMAP
A.12).  The JAX launcher's ``--host-devices`` (a mesh of host devices)
needs the port's ``parallel/`` and is refused.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    """Run the launcher on ``argv`` (the command line by default) and
    return the controller's ``RunReport``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    help="a registry arch: dense, vlm, the moe archs "
                         "(arctic-480b, llama4-maverick-400b-a17b; smoke "
                         "config only), rwkv6-3b, mamba2-2.7b, zamba2-1.2b, "
                         "whisper-large-v3")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; the hand-written kernels) or "
                         "'cpu' (their plain PyTorch versions)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--total-steps", type=int, default=None,
                    help="the schedule's length (default: --steps)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--host-devices", type=int, default=0,
                    help="refused: a host-device mesh needs the port's "
                         "parallel/")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    if args.host_devices:
        raise NotImplementedError(
            "--host-devices: training over a mesh of devices needs the "
            "port's parallel/, which is not ported; the port trains on one "
            "device")

    from .._device import resolve_device
    from ..checkpoint import CheckpointManager
    from ..configs import get_config
    from ..configs.shapes import ShapeSpec
    from ..data import DataCursor, SyntheticLMSource
    from ..models import build_model
    from ..runtime import TrainController
    from ..train.step import TrainHyper, init_optimizer, make_train_step

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "moe" and not args.smoke:
        raise NotImplementedError(
            f"--full on {args.arch}: its {cfg.num_layers} published layers "
            f"of {cfg.num_experts} experts outgrow one card; training the "
            f"whole model needs expert parallelism over several cards "
            f"(ROADMAP A.12), which is not ported")
    device = resolve_device(args.device)
    bundle = build_model(cfg, device=device)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    params = bundle.init_params()
    opt = init_optimizer(cfg, params)
    hyper = TrainHyper(peak_lr=args.lr, warmup=10,
                       total_steps=args.total_steps or args.steps)
    train_step = make_train_step(bundle, hyper)

    def step_fn(state, batch, step):
        params, opt = state
        params, opt, metrics = train_step(params, opt, batch, step)
        return (params, opt), metrics

    ckpt = CheckpointManager(args.ckpt_dir)
    cursor = DataCursor()
    state = (params, opt)
    if args.resume and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(target=state)
        cursor = DataCursor.from_dict(meta["cursor"])
        print(f"resumed from step {cursor.step}")

    source = SyntheticLMSource(cfg, shape)
    controller = TrainController(
        step_fn, ckpt, ckpt_every=args.ckpt_every,
        heartbeat_path=os.path.join(args.ckpt_dir, "heartbeat.json"))
    state, report = controller.run(state, source, cursor, args.steps)
    print(f"done: {report.steps_completed} steps; "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}; "
          f"restarts={report.restarts} straggles={report.straggle_events}")
    return report


if __name__ == "__main__":
    main()
