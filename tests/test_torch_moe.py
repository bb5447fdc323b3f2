"""The port's MoE FFN (``models/moe.py``) and the MoE archs against the JAX
package on the CPU, from the same weights (``bridge``) and the same numpy
inputs: the router (weights, indices exactly, aux), the capacity dispatch
(the default) with and without drops, the dropless dispatch, capacity
against dropless when nothing drops, smoke deepseek-moe-16b and
granite-moe-3b-a800m through the forward, the loss with its MoE aux and
every gradient (f32 and bf16), remat against no remat, the greedy engine
token for token with overflowing experts, the analytic parameter counts
of all ten archs, and the planner's profile of both MoE archs.

Tolerances, each with its reason:
  * f32 outputs and losses: 1e-4 of the largest magnitude (two f32
    implementations that sum in different orders; the combine sums a
    token's k expert outputs over a (T, k, D) view where JAX scatter-adds);
  * f32 gradients: 1e-4 of each leaf's largest entry;
  * bf16: 5e-2 of the largest logit and 1e-2 on the loss (both sides round
    to bf16 after every product, at different points: XLA fuses, PyTorch
    runs op by op), gradients 5e-2 of each leaf's largest entry;
  * router indices and the engine's greedy tokens: exact.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import plan as jplan
from repro.core.mixed_precision import Policy as JPolicy
from repro.models import config as jmodel_config
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serve import ServeEngine as JServeEngine
from repro.serve import synthetic_trace as jsynthetic_trace
from repro_torch import configs, plan
from repro_torch.core.checkpoint import CheckpointConfig
from repro_torch.core.mixed_precision import Policy, scaled_value_and_grad
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models import bridge, moe
from repro_torch.models import config as model_config
from repro_torch.models import transformer as tf
from repro_torch.serve import ServeEngine, synthetic_trace

torch.set_num_threads(2)
MOE_ARCHS = ["deepseek-moe-16b", "granite-moe-3b-a800m"]
F32_TOL = 1e-4
BF16_TOL = 5e-2
BF16_LOSS_TOL = 1e-2


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(1e-12,
                                                   np.max(np.abs(want))))


def _moe_cfgs(arch, **moe_kw):
    jcfg = jconfigs.smoke_config(arch)
    cfg = configs.smoke_config(arch)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              **moe_kw)),
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             **moe_kw)))


def _layer0(arch, seed=0):
    """Layer 0's FFN leaves of a smoke model: (JAX dict, port dict)."""
    jcfg = jconfigs.smoke_config(arch)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    p = jax.tree.map(lambda a: np.asarray(a[0]), params["blocks"]["ffn"])
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def _x(b, s, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)) \
        .astype(np.float32)


# --------------------------------------------------------------------------
# The FFN alone.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("t", [1, 37, 256])
def test_router_topk_matches_jax(arch, t):
    jp, p = _layer0(arch)
    k = configs.smoke_config(arch).moe.top_k
    x = _x(1, t, 64, seed=t)[0]
    jw, ji, jaux = jmoe.router_topk(jnp.asarray(x), jp["router"], k)
    w, i, aux = moe.router_topk(torch.from_numpy(x), p["router"], k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    assert w.dtype == torch.float32


def _drops(cfg, top_i, t):
    _, keep = moe.dispatch_slots(top_i, cfg.moe.num_experts,
                                 moe.capacity(t, cfg))
    return int((~keep).sum())


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf,b,s", [(1.25, 2, 24), (1.0, 2, 24),
                                    (1.0, 4, 64), (0.0, 2, 24),
                                    (0.0, 3, 50)])
def test_moe_ffn_matches_jax(arch, cf, b, s):
    """Capacity dispatch (cf > 0; at 1.0 tokens drop) and dropless (cf 0)
    against JAX's ``moe_ffn``, output and aux."""
    jcfg, cfg = _moe_cfgs(arch, capacity_factor=cf)
    jp, p = _layer0(arch, seed=1)
    x = _x(b, s, 64, seed=s)
    want, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    assert got.shape == (b, s, 64)
    assert _rel_err(got.numpy(), want) <= F32_TOL
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    if cf == 1.0:
        _, top_i, _ = moe.router_topk(torch.from_numpy(x).reshape(-1, 64),
                                      p["router"], cfg.moe.top_k)
        assert _drops(cfg, top_i, b * s) > 0       # the test drops tokens


def test_capacity_equals_dropless_when_uncapped():
    """The port-side twin of the JAX package's test: at capacity factor 8
    nothing drops, and the two dispatches compute the same loss."""
    cfg = configs.smoke_config("deepseek-moe-16b")
    cap = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.0))
    model = tf.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 33)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    l1, a1 = tf.loss_fn(model, cap, batch)
    l2, a2 = tf.loss_fn(model, drop, batch)
    assert abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l2))
    assert float(a1["moe_aux"]) == float(a2["moe_aux"])


def test_mesh_and_expert_parallel_raise():
    """Without a mesh ``expert_mode`` is ignored, as in the reference: an
    EP config computes what the TP config computes, bit for bit.  On a
    model axis that does not divide a split dim the MoE raises, naming the
    leaf, and whole weights on a model axis are refused."""
    from repro_torch.launch.mesh import Mesh
    cfg = configs.smoke_config("granite-moe-3b-a800m")
    _, p = _layer0("granite-moe-3b-a800m")
    x = torch.from_numpy(_x(1, 4, 64))
    ep = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, expert_mode="ep"))
    out_tp, aux_tp = moe.moe_ffn(p, x, cfg)
    out_ep, aux_ep = moe.moe_ffn(p, x, ep)
    torch.testing.assert_close(out_ep, out_tp, rtol=0, atol=0)
    assert float(aux_ep) == float(aux_tp)
    for c, leaf in ((cfg, "F of 32"), (ep, "E of 8")):
        with pytest.raises(ValueError, match=f"ffn.w_gate splits its {leaf}"):
            tf.check_mesh(c, Mesh(data=1, model=3))
    with pytest.raises(ValueError, match="w_gate block"):
        moe.expert_layout(p, cfg, Mesh(data=1, model=2))


# --------------------------------------------------------------------------
# The smoke models: forward, loss, gradients, remat.
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    arch = request.param
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               attn_backend="interpret")
    cfg = configs.smoke_config(arch)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, tree


def _batch(cfg, b=2, s=24, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s + 1)) \
        .astype(np.int32)
    return toks[:, :-1].copy(), toks[:, 1:].copy()


def test_bridge_round_trip_stacks_experts(pair):
    _, cfg, _, tree = pair
    model = bridge.load_jax_params(cfg, tree, device="cpu")
    assert isinstance(model.blocks[0].ffn, tf.MoE)
    back = bridge.export_params(model)
    m = cfg.moe
    assert back["blocks"]["ffn"]["w_gate"].shape == (
        cfg.n_layers, m.num_experts, cfg.d_model, m.d_expert)
    assert ("shared_gate" in back["blocks"]["ffn"]) == bool(m.num_shared)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    named = bridge.from_jax_tree(tree)
    assert named.keys() == dict(model.named_parameters()).keys()


def test_init_params_shapes_match_jax(pair):
    jcfg, cfg, params, _ = pair
    model = tf.init_params(cfg, 0, device="cpu")
    want = {jax.tree_util.keystr(p): leaf.shape for p, leaf in
            jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(p): leaf.shape for p, leaf in
           jax.tree_util.tree_leaves_with_path(bridge.export_params(model))}
    assert got == want
    # the experts' fan-in is D (in_axis=1), as the JAX init draws them
    w = model.blocks[0].ffn.w_gate
    scale = cfg.d_model ** -0.5
    assert abs(float(w.std()) - scale) < 0.2 * scale


def _jax_routing(monkeypatch, jcfg, params, tokens, jpol):
    """JAX's top-k indices at every layer of a forward, in layer order."""
    rec = []
    real = jmoe.router_topk

    def spy(x, w, k):
        out = real(x, w, k)
        jax.debug.callback(lambda i: rec.append(np.asarray(i)), out[1],
                           ordered=True)
        return out
    monkeypatch.setattr(jmoe, "router_topk", spy)
    jax.effects_barrier()
    jtf.forward(params, jcfg, {"tokens": jnp.asarray(tokens)}, policy=jpol)
    jax.effects_barrier()
    monkeypatch.setattr(jmoe, "router_topk", real)
    assert len(rec) == jcfg.n_layers
    return rec


def _port_routing_spy(monkeypatch, model, dtype, force=None):
    """Record the port's own top-k indices and router probabilities at
    every call, by layer (found by the router's weights); with ``force``
    (one (T, k) index array a layer), route as those indices say: the
    weights renormalised over the port's probabilities there, the aux
    counted from them."""
    routers = [blk.ffn.router.detach().to(dtype) for blk in model.blocks]
    rec = []
    real = moe.router_topk

    def spy(x, w, k):
        layer = next(i for i, r in enumerate(routers) if torch.equal(w, r))
        weights, idx, aux = real(x, w, k)
        probs = torch.softmax(x.float() @ w.float(), dim=-1)
        rec.append((layer, idx.clone(), probs.detach().clone()))
        if force is None:
            return weights, idx, aux
        idx = torch.from_numpy(np.array(force[layer])).long()
        top_p = probs.gather(1, idx)
        weights = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        e = w.shape[-1]
        f = torch.bincount(idx.reshape(-1), minlength=e).float()
        f = f / f.sum().clamp_min(1.0)
        return weights, idx, e * (f * probs.mean(0)).sum()
    monkeypatch.setattr(moe, "router_topk", spy)
    return rec


def _loss_grads_vs_jax(jcfg, cfg, params, model, t, lab, jpol, pol):
    """(loss, aux, grads as a JAX-layout dict) of both sides."""
    jbatch = {"tokens": jnp.asarray(t), "labels": jnp.asarray(lab)}
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, jbatch, policy=jpol),
        has_aux=True)(params)
    vg = scaled_value_and_grad(lambda m, b: tf.loss_fn(m, cfg, b,
                                                       policy=pol))
    (loss, aux), grads, finite = vg(
        model, {"tokens": torch.from_numpy(t),
                "labels": torch.from_numpy(lab)})
    assert bool(finite)
    # the loss carries 0.01 x the layers' mean aux, as JAX's does
    assert float(aux["nll"]) == float(loss.detach())
    got = dict(jax.tree_util.tree_leaves_with_path(bridge.to_jax_tree(grads)))
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jgrads)))
    assert got.keys() == want.keys()
    return ((float(loss), float(aux["moe_aux"]), got),
            (float(jl), float(jaux["moe_aux"]), want))


def _check_forward(jcfg, cfg, params, model, t, jpol, pol, tol, aux_tol):
    want, jaux = jtf.forward(params, jcfg, {"tokens": jnp.asarray(t)},
                             policy=jpol)
    with torch.no_grad():
        got, aux = tf.forward(model, cfg, {"tokens": torch.from_numpy(t)},
                              policy=pol)
    live = slice(0, cfg.vocab)
    assert _rel_err(got.numpy()[..., live], np.asarray(want)[..., live]) \
        <= tol
    assert abs(float(aux["moe_aux"]) - float(jaux["moe_aux"])) \
        <= aux_tol * float(jaux["moe_aux"])


def test_f32_forward_loss_and_grads_match_jax(pair, monkeypatch):
    """Policy full: the same experts at every layer, token for token; the
    logits, the loss with its aux, and every gradient within f32 sums."""
    jcfg, cfg, params, tree = pair
    t, lab = _batch(cfg)
    jpol, pol = JPolicy.full(), Policy.full()
    routing = _jax_routing(monkeypatch, jcfg, params, t, jpol)
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    rec = _port_routing_spy(monkeypatch, model, torch.float32)
    _check_forward(jcfg, cfg, params, model, t, jpol, pol, F32_TOL, 1e-5)
    for layer, idx, _ in rec:
        np.testing.assert_array_equal(idx.numpy(), routing[layer])
    (loss, aux, got), (jl, jaux, want) = _loss_grads_vs_jax(
        jcfg, cfg, params, model, t, lab, jpol, pol)
    assert abs(loss - jl) <= F32_TOL * abs(jl)
    assert abs(aux - jaux) <= 1e-5 * jaux
    for path, g in got.items():
        assert _rel_err(g, want[path]) <= F32_TOL, path


def test_bf16_forward_loss_and_grads_match_jax(pair, monkeypatch):
    """Policy bf16.  The two packages round the router's bf16 input at
    different points (XLA fuses the norm, PyTorch runs it op by op), so a
    choice at a near-tie of the k-th and (k+1)-th probability can flip,
    and under capacity dispatch one flip re-ranks every later assignment
    of its experts.  So the port routes as JAX routed (its own
    probabilities, JAX's indices), and its own choices must differ from
    JAX's only at near-ties: within 2^-7 (two bf16 ulps at 1).  Logits,
    the loss with its aux and every gradient at the bf16 tolerances."""
    jcfg, cfg, params, tree = pair
    t, lab = _batch(cfg)
    jpol, pol = JPolicy.bf16(), Policy.bf16()
    routing = _jax_routing(monkeypatch, jcfg, params, t, jpol)
    model = bridge.load_jax_params(cfg, tree, device="cpu").requires_grad_()
    rec = _port_routing_spy(monkeypatch, model, torch.bfloat16,
                            force=routing)
    _check_forward(jcfg, cfg, params, model, t, jpol, pol, BF16_TOL,
                   BF16_LOSS_TOL)
    k = cfg.moe.top_k
    for layer, idx, probs in rec:
        own = np.sort(idx.numpy(), -1)
        differ = (own != np.sort(routing[layer], -1)).any(-1)
        ranked = np.sort(probs.numpy(), -1)[:, ::-1]
        gaps = ranked[differ, k - 1] - ranked[differ, k]
        assert (gaps <= 2.0 ** -7).all(), (layer, gaps)
    (loss, aux, got), (jl, jaux, want) = _loss_grads_vs_jax(
        jcfg, cfg, params, model, t, lab, jpol, pol)
    assert abs(loss - jl) <= BF16_LOSS_TOL * abs(jl)
    assert abs(aux - jaux) <= BF16_LOSS_TOL * jaux
    for path, g in got.items():
        assert _rel_err(g, want[path]) <= BF16_TOL, path


def test_remat_recomputes_the_same_routing(pair):
    """Remat off and full on every block: equal losses and gradients, and
    the recompute picks the same experts and drops the same assignments
    as the forward (the router's indices recorded at every call)."""
    _, cfg, _, tree = pair
    tight = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))                 # assignments drop
    model = bridge.load_jax_params(tight, tree, device="cpu")
    model.requires_grad_()
    t, lab = _batch(tight, seed=3)
    batch = {"tokens": torch.from_numpy(t), "labels": torch.from_numpy(lab)}
    seen = []
    real = moe.dispatch_slots

    def spy(top_i, e, cap):
        dst, keep = real(top_i, e, cap)
        seen.append((top_i.clone(), keep.clone()))
        return dst, keep

    out = {}
    for name, remat in (("off", CheckpointConfig(enabled=False)),
                        ("full", CheckpointConfig())):
        seen.clear()
        moe.dispatch_slots = spy
        try:
            vg = scaled_value_and_grad(lambda m, b: tf.loss_fn(
                m, tight, b, remat=remat))
            (loss, _), grads, _ = vg(model, batch)
        finally:
            moe.dispatch_slots = real
        out[name] = (float(loss), grads, list(seen))
    (l0, g0, s0), (l1, g1, s1) = out["off"], out["full"]
    L = tight.n_layers
    # the forward in layer order, then the backward's recomputes in reverse
    assert len(s0) == L and len(s1) == 2 * L
    assert any(int((~keep).sum()) > 0 for _, keep in s0)
    for i in range(L):
        for fwd, rec in ((s0[i], s1[i]), (s1[i], s1[2 * L - 1 - i])):
            assert torch.equal(fwd[0], rec[0]) and torch.equal(fwd[1], rec[1])
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for n, g in g1.items():
        assert float((g - g0[n]).abs().max()) <= 1e-6 * max(
            1e-12, float(g0[n].abs().max())), n


def test_decode_steps_match_jax(pair):
    """Prefill then per-slot decode with an active mask: the decode round
    routes every row, a frozen one too, as JAX's does."""
    jcfg, cfg, params, tree = pair
    model = bridge.load_jax_params(cfg, tree, device="cpu")
    rng = np.random.default_rng(5)
    b, s_max = 3, 32
    prompt = rng.integers(0, cfg.vocab, (b, 8)).astype(np.int32)
    _, jaux = jtf.forward(params, jcfg, {"tokens": jnp.asarray(prompt)},
                          build_cache=True)
    jcache = jtf.grow_cache(jaux["cache"], s_max)
    cache = {n: torch.from_numpy(np.array(a)) for n, a in jcache.items()}
    pos = np.asarray([8, 5, 3], np.int32)
    jcache["pos"] = jnp.asarray(pos)
    cache["pos"] = torch.from_numpy(pos.copy())
    jdecode = jax.jit(lambda p, c, t, a: jtf.decode_step(
        p, jcfg, c, t, quantized=True, active=a))
    for step in range(6):
        toks = rng.integers(0, cfg.vocab, (b,)).astype(np.int32)
        active = np.asarray([True, step % 2 == 0, step < 3])
        want, jcache = jdecode(params, jcache, jnp.asarray(toks),
                               jnp.asarray(active))
        got, cache = tf.decode_step(model, cfg, cache,
                                    torch.from_numpy(toks), quantized=True,
                                    active=torch.from_numpy(active))
        live = slice(0, cfg.vocab)
        assert _rel_err(got.numpy()[:, live],
                        np.asarray(want)[:, live]) <= 1e-3, step


# --------------------------------------------------------------------------
# The engine, token for token, with experts that overflow.
# --------------------------------------------------------------------------
TRACE_KW = dict(vocab=256, mean_prompt=12, max_prompt=32, mean_gen=10,
                max_gen=24)


def test_engine_greedy_tokens_match_jax_with_overflow():
    """Smoke deepseek-moe-16b in both engines (f32, greedy, JAX's plain
    decode path).  16 slots and 6 requests: every decode round routes the
    free slots too, whose identical rows overflow the capacity of 8, and
    the bucket-padded prefills overflow theirs; the tokens must still
    agree exactly."""
    arch = "deepseek-moe-16b"
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(11))
    model = bridge.load_jax_params(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    kw = dict(max_slots=16, max_len=64, policy_name="full")
    jeng = JServeEngine(params, jcfg, kv_backend="ref", **kw)
    jsum = jeng.run(jsynthetic_trace(6, seed=4, **TRACE_KW))
    drops = {"prefill": 0, "decode": 0}
    real = moe.dispatch_slots

    def spy(top_i, e, cap):
        dst, keep = real(top_i, e, cap)
        kind = "decode" if top_i.shape[0] == kw["max_slots"] else "prefill"
        drops[kind] += int((~keep).sum())
        return dst, keep

    eng = ServeEngine(model, cfg, **kw)
    moe.dispatch_slots = spy
    try:
        summ = eng.run(synthetic_trace(6, seed=4, **TRACE_KW))
    finally:
        moe.dispatch_slots = real
    assert summ["n_done"] == jsum["n_done"] == 6
    assert drops["prefill"] > 0 and drops["decode"] > 0
    want = {r.rid: r.tokens for r in jeng._requests_done}
    got = {r.rid: r.tokens for r in eng._requests_done}
    assert got == want
    assert summ["n_steps"] == jsum["n_steps"]


# --------------------------------------------------------------------------
# Sizing: parameter counts and the planner's profile.
# --------------------------------------------------------------------------
def _port_config(jcfg) -> model_config.ModelConfig:
    """The port's ModelConfig with every field of a JAX one (its
    sub-configs rebuilt as the port's classes)."""
    subs = {jmodel_config.MoEConfig: model_config.MoEConfig,
            jmodel_config.MLAConfig: model_config.MLAConfig,
            jmodel_config.SSMConfig: model_config.SSMConfig,
            jmodel_config.EncoderConfig: model_config.EncoderConfig}
    kw = {}
    for f in dataclasses.fields(model_config.ModelConfig):
        v = getattr(jcfg, f.name)
        kw[f.name] = subs[type(v)](**dataclasses.asdict(v)) \
            if type(v) in subs else v
    return model_config.ModelConfig(**kw)


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_param_counts_equal_jax(arch):
    for jcfg in (jconfigs.get_config(arch), jconfigs.smoke_config(arch)):
        cfg = _port_config(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", configs.list_archs())
def test_ported_configs_equal_jax(arch):
    """Every ported arch's config, and its smoke reduction (the MoE
    branch: 8 experts, top-2, d_expert 32, d_shared 64, d_ff 0), field
    for field as the JAX package's."""
    assert configs.get_config(arch) == _port_config(jconfigs.get_config(arch))
    assert configs.smoke_config(arch) == _port_config(
        jconfigs.smoke_config(arch))


@pytest.mark.parametrize("arch,total,active", [
    ("deepseek-moe-16b", 16_879_568_896, 2_830_747_648),
    ("granite-moe-3b-a800m", 3_374_295_552, 958_376_448),
    ("glm4-9b", 9_399_767_040, 9_399_767_040)])
def test_ported_archs_build_at_their_sizes(arch, total, active):
    cfg = configs.get_config(arch)
    assert (cfg.param_count(), cfg.active_param_count()) == (total, active)
    # the meta model holds what the count says, the padded vocab aside
    model = tf.init_params(cfg, 0, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == total + 2 * (cfg.padded_vocab - cfg.vocab) * cfg.d_model


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("b,s", [(1, 128), (2, 256)])
def test_profile_equals_jax(monkeypatch, arch, b, s):
    """Carry and residual bytes, labels and FLOPs (every expert's
    parameters in the per-block products, as JAX counts them) equal the
    JAX planner's, at its 128 x 128 tiles."""
    monkeypatch.setattr(flash_ops, "BQ", 128)
    monkeypatch.setattr(flash_ops, "BK", 128)
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               attn_backend="interpret")
    cfg = configs.smoke_config(arch)
    for kw in ({}, {"dtype_bytes": 4}):
        jp = jplan.profile_transformer(
            jcfg, {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}, **kw)
        tp = plan.profile_transformer(
            cfg, {"tokens": torch.empty((b, s), dtype=torch.int32,
                                        device="meta")}, **kw)
        assert tp.act_bytes == jp.act_bytes
        assert tp.resid_bytes == jp.resid_bytes
        assert tp.labels == jp.labels
        assert tp.flops == jp.flops
