"""The port's checkpoint manager (``repro_torch.checkpoint``): the JAX
package's checkpoint tests (``tests/test_checkpoint.py``) mirrored, and
checkpoints interchanged with ``repro.checkpoint`` both ways -- a training
state (bf16 params, an ``AdamWState``) written by one package restores in
the other with every leaf's bits and dtype, and the same files."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.optim import adamw_init as j_adamw_init
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import AdamWState, adamw_init


def make_state():
    params = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones((2,))}}
    return (params, adamw_init(params))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = make_state()
    mgr.save(7, state, metadata={"cursor": {"step": 7, "seed": 0}})
    assert mgr.latest_step() == 7
    restored, meta = mgr.restore(target=state)
    assert meta["cursor"]["step"] == 7
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # NamedTuple structure preserved
    assert type(restored[1]).__name__ == "AdamWState"


def test_retention_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = make_state()
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = make_state()
    mgr.save_async(11, state, metadata={"cursor": {"step": 11, "seed": 0}})
    mgr.wait()
    restored, meta = mgr.restore(target=state)
    assert meta["cursor"]["step"] == 11


def test_async_save_snapshots_before_returning(tmp_path):
    """A leaf changed in place after ``save_async`` returns does not reach
    the checkpoint: the host copy is taken at the call."""
    mgr = CheckpointManager(str(tmp_path))
    state = make_state()
    mgr.save_async(1, state)
    state[0]["a"].add_(100.0)
    mgr.wait()
    restored, _ = mgr.restore(target=state)
    assert torch.equal(restored[0]["a"], torch.arange(12.0).reshape(3, 4))


def test_crash_leaves_previous_checkpoint_intact(tmp_path):
    """Stage dirs (.tmp-*) are invisible to latest_step / restore."""
    mgr = CheckpointManager(str(tmp_path))
    state = make_state()
    mgr.save(1, state)
    os.makedirs(os.path.join(str(tmp_path), ".tmp-dead-123"))  # simulated crash
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(target=state)
    assert restored is not None


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore()


def test_restore_into_another_structure_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state())
    with pytest.raises(KeyError, match="differ"):
        mgr.restore(target=({"a": torch.zeros(3, 4)}, make_state()[1]))


def _train_state(seed):
    """bf16 params of mixed shapes (a 3-D stacked leaf, a vector, a 0-d
    scalar) and an AdamW state whose moments hold numbers, as numpy."""
    rng = np.random.default_rng(seed)
    params = {"blk.0.attn.wq": rng.standard_normal((2, 8, 4)),
              "embed": rng.standard_normal((16, 8)),
              "final_norm": rng.standard_normal((8,)),
              "scalar": rng.standard_normal(())}
    return {k: jnp.asarray(v, jnp.float32).astype(jnp.bfloat16)
            for k, v in params.items()}, rng


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jparams, rng = _train_state(0)
    jopt = j_adamw_init(jparams)
    jopt = jopt._replace(m={k: jnp.asarray(rng.standard_normal(v.shape),
                                           jnp.float32)
                            for k, v in jopt.m.items()},
                         step=jnp.asarray(5, jnp.int32))
    JCheckpointManager(str(tmp_path)).save(
        5, (jparams, jopt), metadata={"cursor": {"step": 5, "seed": 0}})
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()})
    target = (tparams, adamw_init(tparams))
    restored, meta = CheckpointManager(str(tmp_path)).restore(target=target)
    assert meta == {"cursor": {"step": 5, "seed": 0}}
    assert isinstance(restored[1], AdamWState)
    assert restored[1].step.dtype == torch.int32 and int(restored[1].step) == 5
    for k, v in jparams.items():
        got = restored[0][k]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == v.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(v).view(np.int16))
        np.testing.assert_array_equal(restored[1].m[k].numpy(),
                                      np.asarray(jopt.m[k]))
        np.testing.assert_array_equal(restored[1].master[k].numpy(),
                                      np.asarray(jopt.master[k]))


def test_port_checkpoint_restores_in_jax(tmp_path):
    jparams, _ = _train_state(1)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()})
    topt = adamw_init(tparams)
    topt = topt._replace(step=torch.tensor(9, dtype=torch.int32),
                         v={k: torch.rand(v.shape) for k, v in topt.v.items()})
    CheckpointManager(str(tmp_path)).save(
        9, (tparams, topt), metadata={"cursor": {"step": 9, "seed": 3}})
    jmgr = JCheckpointManager(str(tmp_path))
    target = (jparams, j_adamw_init(jparams))
    restored, meta = jmgr.restore(target=target)
    assert meta == {"cursor": {"step": 9, "seed": 3}}
    assert int(restored[1].step) == 9 and restored[1].step.dtype == jnp.int32
    for k, t in tparams.items():
        got = restored[0][k]
        assert got.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(got).view(np.int16),
                                      t.view(torch.int16).numpy())
        np.testing.assert_array_equal(np.asarray(restored[1].v[k]),
                                      topt.v[k].numpy())
    # the same files: one manifest, one .npy a leaf, bf16 as uint16 bits
    d = os.path.join(str(tmp_path), "step_00000009")
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    info = manifest["arrays"]["0/embed"]
    assert info == {"file": "0__embed.npy", "shape": [16, 8],
                    "dtype": "bfloat16"}
    assert np.load(os.path.join(d, info["file"])).dtype == np.uint16
    assert manifest["arrays"]["1/0"]["dtype"] == "int32"
    assert len(os.listdir(d)) == 1 + len(manifest["arrays"])
