"""Checkpoints across the two packages: a training state the JAX package's
``CheckpointManager`` saved restores bit-exact into the port (params and
AdamW state, through ``models.bridge``), and the port's restores bit-exact
into the JAX package.  The leaf paths are read off a real JAX save's
manifest, dataclass fields included.  Then the port's own manager:
checksum rejection, the fall-back past a damaged newest checkpoint,
config and structure checks, idempotent re-saves and ``keep_last``."""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpointing.ckpt import CheckpointManager as JManager
from repro.checkpointing.ckpt import _flatten_with_paths as jflatten
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.checkpointing.ckpt import (CheckpointManager,
                                            CheckpointMismatchError,
                                            _flatten_with_paths,
                                            tree_fingerprint, tree_paths)
from repro_torch.launch.train import init_state, load_state, train_state
from repro_torch.models import bridge
from repro_torch.optim import adamw

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX training state after one AdamW step (non-zero moments)."""
    cfg = jconfigs.smoke_config("llama3-8b")
    params = jtf.init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), params)
    params, opt, _ = jadamw.update(jadamw.AdamWConfig(), grads,
                                   jadamw.init(params), params)
    return {"params": params, "opt": opt}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _port():
    cfg = configs.smoke_config("llama3-8b")
    model, opt = init_state(cfg, 7, "cpu")
    return cfg, model, opt


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_jax_checkpoint_restores_bit_exact_into_the_port(tmp_path,
                                                         jax_state):
    JManager(str(tmp_path)).save(5, jax_state, extra={"step": 5},
                                 config="llama3-8b")
    cfg, model, opt = _port()
    like = train_state(model, opt)
    # the leaf paths, dataclass fields (".mu", ".nu", ".count") included,
    # are the ones the JAX save wrote
    manifest = _manifest(tmp_path, 5)
    assert sorted(manifest["leaves"]) == tree_paths(like)
    assert manifest["fingerprint"] == tree_fingerprint(like)
    state, extra = CheckpointManager(str(tmp_path)).restore(
        5, like, config="llama3-8b")
    assert extra == {"step": 5}
    model, opt = load_state(cfg, state, "cpu")
    back = _leaves(train_state(model, opt)["params"])
    want = _leaves(jax.tree.map(np.asarray, jax_state["params"]))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    jopt = jax_state["opt"]
    assert int(opt.count) == int(jopt.count) == 1
    for port_m, jax_m in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        got = _leaves(bridge.to_jax_tree(port_m))
        for k, w in _leaves(jax_m).items():
            np.testing.assert_array_equal(got[k], w)


def test_port_checkpoint_restores_bit_exact_into_jax(tmp_path, jax_state):
    cfg, model, opt = _port()
    grads = {n: torch.randn_like(p) for n, p in model.named_parameters()}
    adamw.update(adamw.AdamWConfig(), grads, opt,
                 dict(model.named_parameters()))
    state = train_state(model, opt)
    CheckpointManager(str(tmp_path)).save(3, state, extra={"step": 3},
                                          config="llama3-8b")
    restored, extra = JManager(str(tmp_path)).restore(3, jax_state,
                                                      config="llama3-8b")
    assert extra == {"step": 3}
    assert isinstance(restored["opt"], jadamw.AdamWState)
    got = {k: np.asarray(x) for k, x in jflatten(restored).items()}
    want = _flatten_with_paths(state)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def _corrupt(mgr, step):
    path = os.path.join(mgr._step_dir(step), "shards_00000.npz")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))       # always a change


def test_checksums_reject_corruption_and_fall_back(tmp_path):
    _, model, opt = _port()
    mgr = CheckpointManager(str(tmp_path), keep_last=5)
    state = train_state(model, opt)
    mgr.save(1, state, extra={"step": 1})
    mgr.save(2, state, extra={"step": 2})
    assert mgr.verify(2)
    _corrupt(mgr, 2)
    assert not mgr.verify(2) and mgr.verify(1)
    with pytest.raises(CheckpointMismatchError, match="checksum"):
        mgr.restore(2, state)
    with pytest.warns(UserWarning, match="step 2 .* failed verification"):
        assert mgr.latest_intact_step() == 1
    with pytest.warns(UserWarning):
        step, restored, extra = mgr.restore_latest(state)
    assert step == 1 and extra == {"step": 1}
    _corrupt(mgr, 1)
    with pytest.warns(UserWarning), pytest.raises(FileNotFoundError):
        mgr.restore_latest(state)


def test_config_structure_and_resave_checks(tmp_path):
    _, model, opt = _port()
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    state = train_state(model, opt)
    mgr.save(1, state, config="llama3-8b")
    mgr.save(1, state, config="llama3-8b")        # identical: a no-op
    with pytest.raises(CheckpointMismatchError, match="config"):
        mgr.restore(1, state, config="whisper-base")
    smaller = {"params": dict(state["params"]), "opt": state["opt"]}
    smaller["params"]["embed"] = smaller["params"]["embed"][:10]
    with pytest.raises(CheckpointMismatchError, match="does not fit"):
        mgr.restore(1, smaller)
    with pytest.raises(CheckpointMismatchError, match="DIFFERENT"):
        mgr.save(1, smaller)
    for s in (2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
