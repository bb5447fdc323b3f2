"""The paper's CIFAR E-D slice on the CPU: ``examples/cifar_optorch_torch.py``
``train()`` for the four pipelines (baseline, ED, ED+SC, ED+SC+MP) against
the JAX example's step (``examples/cifar_optorch.py``, rebuilt here with
the JAX package's modules as the example builds it) at smoke size: a
narrow ResNet on 16x16 images, the same bridged weights, the same SBS
batches from each package's own loader, three AdamW steps.

Tolerances on every step's loss: 1e-4 relative in f32 (two
implementations that sum in different orders, compounded over three
updates); 1e-2 for ED+SC+MP, whose bf16 rounds in other places (XLA once
per fused chain, PyTorch after every op).  The S-C plan must be the JAX
example's exactly.
"""
from __future__ import annotations

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as jplan
from repro.core.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.data.pipeline import ParallelEncodedLoader as JLoader
from repro.models import cnn as jcnn
from repro.optim import adamw as jadamw
from repro_torch.data.synthetic import make_cifar_like
from repro_torch.models import bridge, cnn

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 3
KW = dict(arch_id="narrow", stage_sizes=(1, 1, 1, 1), widths=(8, 16, 32, 64),
          groups=4)
TOL = {"baseline": 1e-4, "ED": 1e-4, "ED+SC": 1e-4, "ED+SC+MP": 1e-2}


def _load_example():
    spec = importlib.util.spec_from_file_location(
        "cifar_optorch_torch", ROOT / "examples" / "cifar_optorch_torch.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod                 # dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


EX = _load_example()


def _jax_train(pipeline, imgs, labels, steps, jcfg, params):
    """The JAX example's ``train`` (``examples/cifar_optorch.py:25-81``) on
    ``jcfg`` and ``params``, returning every step's loss."""
    opt = jadamw.init(params)
    ocfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps,
                              weight_decay=0.0)
    use_ed, use_sc, use_mp = ("ED" in pipeline, "SC" in pipeline,
                              "MP" in pipeline)
    remat = plan = None
    if use_sc:
        img_sds = jax.ShapeDtypeStruct((32,) + imgs.shape[1:], jnp.float32)
        plan = jplan.plan_min_peak(
            jplan.profile_resnet(params, jcfg, img_sds), 5)
        remat = JCheckpointConfig(plan=plan)

    @jax.jit
    def step(params, opt, im, lb):
        def lossp(p):
            if use_mp:
                p = jax.tree_util.tree_map(
                    lambda x: x.astype(jnp.bfloat16)
                    if jnp.issubdtype(x.dtype, jnp.floating) else x, p)
            return jcnn.loss_fn(p, jcfg, im, lb, remat=remat,
                                decode_backend="ref" if use_ed else None)
        (l, aux), g = jax.value_and_grad(lossp, has_aux=True)(params)
        g = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)
        params, opt, _ = jadamw.update(ocfg, g, opt, params)
        return params, opt, l, aux["acc"]

    weights = {c: (2.0 if c == 0 else 1.0) for c in range(10)}
    losses = []
    with JLoader(imgs, labels, 32, codec="u32" if use_ed else "none",
                 class_weights=weights, prefetch=4) as dl:
        for _ in range(steps):
            enc, lb = next(dl)
            params, opt, l, _ = step(params, opt, jnp.asarray(enc),
                                     jnp.asarray(lb))
            losses.append(float(l))
    return losses, plan


@pytest.fixture(scope="module")
def data():
    imgs, labels = make_cifar_like(n=256, hw=16, seed=0)
    jcfg = jcnn.ResNetConfig(**KW)
    jp = jcnn.init_params(jcfg, jax.random.PRNGKey(0))
    return imgs, labels, jcfg, jp


@pytest.mark.parametrize("pipeline", EX.PIPELINES)
def test_pipeline_steps_match_the_jax_example(data, pipeline):
    imgs, labels, jcfg, jp = data
    want, jplan_ = _jax_train(pipeline, imgs, labels, STEPS, jcfg, jp)
    params = bridge.load_cnn_params(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    got = EX.train(pipeline, imgs, labels, STEPS, device="cpu",
                   cfg=cnn.ResNetConfig(**KW), params=params, log_every=0)
    assert len(got.losses) == len(got.accs) == len(got.step_s) == STEPS
    assert got.peak_bytes is None                  # no card, no device peak
    np.testing.assert_allclose(got.losses, want, rtol=TOL[pipeline], atol=0)
    if "SC" in pipeline:
        assert got.plan.boundaries == jplan_.boundaries
        assert len(got.plan.boundaries) == 5
    else:
        assert got.plan is None
    assert got.acc == pytest.approx(np.mean(got.accs[-20:]))


def test_pipeline_flags():
    assert EX.pipeline_flags("baseline") == (False, False, False)
    assert EX.pipeline_flags("ED+SC+MP") == (True, True, True)
    assert EX.pipeline_flags("ED+SC") == (True, True, False)


def test_example_exits_nonzero_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert EX.main(["--steps", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_example_cli_prints_the_table_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "cifar_optorch_torch.py"),
         "--device", "cpu", "--steps", "2"], env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [ln.split()[0] for ln in out.stdout.splitlines()
            if ln.split() and ln.split()[0] in EX.PIPELINES]
    assert rows == list(EX.PIPELINES)
    assert "within 0.1 accuracy of baseline" in out.stdout
