"""The port's training runtime (``repro_torch.runtime``) and launcher
(``repro_torch.launch.train``) on the CPU: the JAX package's
fault-tolerance tests (``tests/test_fault_tolerance.py``) mirrored over
the port's checkpoints and data; the launcher with ``--device cpu`` for a
few steps, and a run split by ``--resume`` against the same run in one
piece (losses equal bit for bit, as ``chip_smoke.py`` phase 9c holds them
on the card); its refusals."""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import DataCursor, Prefetcher, SyntheticLMSource
from repro_torch.launch import train as launch_train
from repro_torch.runtime import (FaultInjector, Heartbeat, StragglerDetector,
                                 TrainController)


def counting_step(fail_on=()):
    def step(state, batch, step_idx):
        return state + 1, {"loss": float(100 - state)}
    return step


def _source():
    cfg = get_config("llama3-8b", smoke=True)
    return SyntheticLMSource(cfg, ShapeSpec("t", 16, 2, "train"))


def test_run_completes_and_checkpoints(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ctl = TrainController(counting_step(), ckpt, ckpt_every=5)
    state, report = ctl.run(torch.zeros(()), _source(), DataCursor(), 12)
    assert report.steps_completed == 12
    assert int(state) == 12
    assert ckpt.latest_step() == 10


def test_transient_failure_retried(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    inj = FaultInjector(fail_steps=(3,))
    ctl = TrainController(counting_step(), ckpt, ckpt_every=100,
                          max_retries=1, injector=inj)
    state, report = ctl.run(torch.zeros(()), _source(), DataCursor(), 6)
    assert int(state) == 6          # no step lost
    assert report.restarts == 0     # retry, not restore


def test_fatal_failure_restores_from_checkpoint(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))

    calls = {"n": 0}

    def step(state, batch, step_idx):
        calls["n"] += 1
        if step_idx == 7 and calls["n"] < 20:  # fails repeatedly at step 7
            if calls.setdefault("fails", 0) < 2:
                calls["fails"] = calls.get("fails", 0) + 1
                raise RuntimeError("boom")
        return state + 1, {"loss": 0.0}

    ctl = TrainController(step, ckpt, ckpt_every=5, max_retries=0)
    state, report = ctl.run(torch.zeros(()), _source(), DataCursor(), 10)
    assert report.restarts >= 1
    # state is consistent with the number of *committed* steps after replay
    assert int(state) == 10


def test_straggler_detector_flags_sustained_outliers():
    det = StragglerDetector(window=16, threshold=3.0, sustained=3)
    for _ in range(12):
        assert not det.observe(0.10)
    flagged = [det.observe(1.0) for _ in range(4)]
    assert any(flagged)


def test_straggler_tolerates_noise():
    det = StragglerDetector(window=16, threshold=3.0, sustained=3)
    rng = np.random.default_rng(0)
    flags = [det.observe(0.1 + 0.01 * rng.random()) for _ in range(50)]
    assert not any(flags)


def test_heartbeat_staleness(tmp_path):
    hb = Heartbeat(str(tmp_path / "hb.json"))
    assert hb.is_stale(0.5)
    hb.beat(3, loss=1.0)
    assert not hb.is_stale(5.0)
    assert hb.read()["step"] == 3


def test_data_cursor_determinism():
    src = _source()
    b1 = src.batch_at(5)
    b2 = src.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = src.batch_at(6)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_prefetcher_orders_batches():
    src = _source()
    cur = DataCursor(step=3)
    pf = Prefetcher(src, cur, depth=2)
    b3 = next(pf)
    b4 = next(pf)
    pf.close()
    np.testing.assert_array_equal(b3["tokens"], src.batch_at(3)["tokens"])
    np.testing.assert_array_equal(b4["tokens"], src.batch_at(4)["tokens"])
    assert cur.step == 5


# ------------------------------------------------------------ the launcher
def _args(ckpt, steps, *more):
    return ["--device", "cpu", "--steps", str(steps), "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(ckpt), "--ckpt-every", "2",
            "--total-steps", "6", *more]


def test_launcher_resume_equals_one_run(tmp_path, capsys):
    """4 steps (checkpoints every 2) then ``--resume`` for 2 more from the
    step-4 checkpoint, against 6 steps in one run: the same schedule
    (``--total-steps 6``, warmup 10: the learning rate still rising) and
    the same losses, bit for bit."""
    whole = launch_train.main(_args(tmp_path / "whole", 6))
    assert whole.steps_completed == 6 and len(whole.losses) == 6
    assert all(np.isfinite(whole.losses))
    first = launch_train.main(_args(tmp_path / "split", 4))
    assert first.losses == whole.losses[:4]
    assert CheckpointManager(str(tmp_path / "split")).latest_step() == 4
    second = launch_train.main(_args(tmp_path / "split", 2, "--resume"))
    assert "resumed from step 4" in capsys.readouterr().out
    assert second.losses == whole.losses[4:]
    hb = Heartbeat(str(tmp_path / "split" / "heartbeat.json")).read()
    assert hb["step"] == 5


def test_launcher_refuses_host_devices(tmp_path):
    with pytest.raises(NotImplementedError, match="--host-devices"):
        launch_train.main(_args(tmp_path, 1, "--host-devices", "4"))


def test_launcher_refuses_untrained_families(tmp_path):
    """The moe archs train their smoke configs (``tests/
    test_torch_train_moe.py``); ``--full`` on one is refused by name
    before any weight is made: the whole published model needs expert
    parallelism (ROADMAP A.12)."""
    for arch in ("arctic-480b", "llama4-maverick-400b-a17b"):
        with pytest.raises(NotImplementedError, match="--full.*A.12"):
            launch_train.main(_args(tmp_path, 1, "--arch", arch, "--full"))
    assert not (tmp_path / "heartbeat.json").exists()
