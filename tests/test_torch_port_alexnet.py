"""clsurvey_torch's AlexNet against clsurvey_tpu's on the CPU, at 96 px (the
final map is 2x2x256, so a wrong flatten order or a mis-laid ``fc_0`` row
shows; at 1x1 every order agrees), float32, from JAX-made weights and
numpy-made inputs:

- the backbone's eval features and conv features within 1e-5 of their
  largest entry (float32 sums in another order);
- one engine SGD step with the JAX run's dropout keep-masks handed in:
  every updated weight and momentum leaf within 1e-5 of its largest entry
  (the gradients of the step, so the pools' ties and the dropout placement
  are held, not only the forward);
- the ``models/convert.py`` round trip, bit for bit; ``load_pretrained``
  from an npz the test writes, leaf for leaf equal to the JAX package's;
  the spec, the init pickle and the dropout-mask widths;
- one EBLL step (a teacher and an autoencoder on the 1,024-wide conv
  output), one HAT step at task 2 (``mask_back`` from task 1) and one
  PathNet epoch step, each with the JAX run's masks, within 1e-5 of each
  leaf's largest entry;
- a 2-task ``alexnet`` finetuning run of the port's CLI on a small RecogSeq
  tree (64 px), whose models the JAX package's CLI evaluates to the same
  result dicts (within 1e-4)."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.data import recogseq as trs
from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.framework import main as tmain
from clsurvey_torch.methods import ebll as tebll, hat as that, \
    pathnet as tpath
from clsurvey_torch.methods.base import UpdateRule as TRule
from clsurvey_torch.models import backbones as tbb, convert, \
    registry as treg
from clsurvey_torch.utils import config as tconfig, io as tio
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.framework.common import RunArgs as JRunArgs
from clsurvey_tpu.framework.main import main as jmain
from clsurvey_tpu.methods import ebll as jebll, hat as jhat, \
    pathnet as jpath
from clsurvey_tpu.methods.base import UpdateRule as JRule
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.ops import preprocess as jpp
from clsurvey_tpu.utils import config as jconfig, io as jio

PX, B = 96, 8
PPX = 80  # PathNet's: kernels px // 8, px // 10 and 2
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The suite runs in several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jnp(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def _close(got, want, rel=1e-5, what=""):
    want = np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol,
                               err_msg=what)


def _close_trees(got, want, rel=1e-5):
    for key_path, w in jax.tree_util.tree_flatten_with_path(
            jio.to_host(want))[0]:
        g = got
        for k in key_path:
            g = g[k.key]
        _close(g, w, rel, jax.tree_util.keystr(key_path))


@pytest.fixture(scope="module")
def model():
    """A JAX-made AlexNet init model at 96 px (numpy), 2 tasks x 4
    classes, its head bank drawn from numpy so every class logit moves."""
    spec = jreg.parse_model_name("", "alexnet", (PX, PX))
    m = jio.to_host(jreg.init_model_state(
        spec, jax.random.PRNGKey(3), max_tasks=2, classes_per_task=4))
    rng = np.random.default_rng(0)
    m["heads"]["kernel"] = rng.normal(0, 0.05, m["heads"]["kernel"].shape
                                      ).astype(np.float32)
    return m


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, PX, PX, 3), dtype=np.uint8),
            rng.integers(0, 4, (B,)).astype(np.int32))


def test_spec_matches_the_jax_package(tmp_path):
    for name in ("alexnet", "alexnet_pretrained"):
        spec_j = jreg.parse_model_name(str(tmp_path), name, (224, 224))
        spec_t = treg.parse_model_name(str(tmp_path), name, (224, 224))
        assert (spec_t.arch, spec_t.pretrained, spec_t.path,
                spec_t.feature_dim, spec_t.uses_dropout,
                spec_t.has_batch_stats) == (
            spec_j.arch, spec_j.pretrained, spec_j.path, spec_j.feature_dim,
            spec_j.uses_dropout, spec_j.has_batch_stats)
    assert spec_t.path.endswith(os.path.join("alexnet",
                                             "alexnet_pretrained.pth.tar"))
    net = spec_t.make_backbone()
    assert tbb.alexnet_smid(224) == 6 and tbb.alexnet_smid(PX) == 2
    assert net.drop_dims == (9216, 4096)
    assert net.fc_0.in_features == 6 * 6 * 256


def test_init_pickle_and_convert_round_trip(model, tmp_path):
    """The port's init pickle has the JAX tree's layout and shapes; the
    JAX tree converts to the port's names and back bit for bit."""
    spec_t = treg.parse_model_name(str(tmp_path), "alexnet", (PX, PX))
    path = treg.create_init_model(spec_t, 3, max_tasks=2,
                                  classes_per_task=4)
    mine = jio.load(path)["params"]
    assert set(mine) == set(model["params"]) == {
        "conv_0", "conv_1", "conv_2", "conv_3", "conv_4", "fc_0", "fc_1"}
    for layer, leaves in model["params"].items():
        for leaf, v in leaves.items():
            assert mine[layer][leaf].shape == v.shape, (layer, leaf)
            assert mine[layer][leaf].dtype == v.dtype
    port = convert.params_from_jax(model["params"])
    assert port["conv_0.weight"].shape == (64, 3, 11, 11)
    assert port["conv_0.weight"].is_contiguous(
        memory_format=torch.channels_last)
    assert set(port) == set(dict(spec_t.make_backbone().named_parameters()))
    back = convert.params_to_jax(port)
    for layer, leaves in model["params"].items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(back[layer][leaf], v)
    # scratch init draws from the JAX package's distributions
    std = float(mine["conv_1"]["kernel"].std())
    assert abs(std - (2.0 / (192 * 25)) ** 0.5) < 0.05 * std
    assert abs(float(mine["fc_1"]["kernel"].std()) - 0.01) < 5e-4
    assert treg.count_parameters(jio.load(path)) == jreg.count_parameters(
        model)


def test_load_pretrained_reads_the_jax_layout_npz(model, tmp_path,
                                                  monkeypatch):
    """The same flat ``'conv_0/kernel'``-keyed npz gives both packages the
    same weights; a leaf the file lacks or holds in another shape keeps
    its init; without the file both raise, unless scratch is allowed."""
    rng = np.random.default_rng(5)
    flat = {f"{layer}/{leaf}": rng.normal(0, 1, v.shape).astype(np.float32)
            for layer, leaves in model["params"].items()
            for leaf, v in leaves.items()}
    del flat["fc_1/bias"]
    flat["fc_1/kernel"] = flat["fc_1/kernel"][:10]  # wrong shape
    np.savez(tmp_path / "alexnet_imagenet.npz", **flat)
    spec_t = treg.parse_model_name(str(tmp_path), "alexnet_pretrained",
                                   (PX, PX))
    spec_j = jreg.parse_model_name(str(tmp_path), "alexnet_pretrained",
                                   (PX, PX))
    got = treg.load_pretrained(spec_t, model["params"])
    want = jio.to_host(jreg.load_pretrained(spec_j, _jnp(model["params"])))
    for layer, leaves in want.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(got[layer][leaf], v)
    np.testing.assert_array_equal(got["conv_0"]["kernel"],
                                  flat["conv_0/kernel"])
    np.testing.assert_array_equal(got["fc_1"]["kernel"],
                                  model["params"]["fc_1"]["kernel"])
    state = treg.init_model_state(spec_t, 3, max_tasks=2,
                                  classes_per_task=4)
    np.testing.assert_array_equal(state["params"]["conv_2"]["bias"],
                                  flat["conv_2/bias"])

    os.remove(tmp_path / "alexnet_imagenet.npz")
    monkeypatch.delenv("CLSURVEY_ALLOW_SCRATCH_PRETRAINED", raising=False)
    for pkg, spec in ((treg, spec_t), (jreg, spec_j)):
        with pytest.raises(FileNotFoundError,
                           match="CLSURVEY_ALLOW_SCRATCH_PRETRAINED"):
            pkg.load_pretrained(spec, model["params"])
    monkeypatch.setenv("CLSURVEY_ALLOW_SCRATCH_PRETRAINED", "1")
    assert treg.load_pretrained(spec_t, model["params"]) is model["params"]


def test_features_match_flax(model):
    """Eval features and the NHWC-flattened conv output (EBLL's space)."""
    x = np.random.default_rng(2).normal(0, 1, (B, PX, PX, 3)).astype(
        np.float32)
    spec_j = jreg.parse_model_name("", "alexnet", (PX, PX))
    feats_j = spec_j.make_backbone().apply(
        {"params": _jnp(model["params"])}, jnp.asarray(x))
    conv_j = jebll.conv_feats(spec_j, _jnp(model["params"]), jnp.asarray(x))
    net = treg.parse_model_name("", "alexnet", (PX, PX)).make_backbone()
    params = convert.params_from_jax(model["params"])
    with torch.no_grad():
        feats_t = torch.func.functional_call(net, params,
                                             (torch.from_numpy(x),))
        conv_t = tebll.conv_feats(net, params, torch.from_numpy(x))
    assert conv_t.shape == (B, 2 * 2 * 256)
    _close(conv_t.numpy(), conv_j)
    _close(feats_t.numpy(), feats_j)
    assert float(np.abs(np.asarray(feats_j)).max()) > 0


def _jax_dropout_masks(module, variables, x, rng, *args, prefix=()):
    """The keep-masks flax drew under ``rng``: where a ``Dropout`` output
    is nonzero (where its input is 0 the mask does not matter: the pool
    or ReLU before it passes no gradient there)."""
    _, mut = jax.jit(lambda v, x, *a: module.apply(
        v, x, *a, train=True, rngs={"dropout": rng},
        mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: "Dropout" in (mdl.name or "")))(
            variables, x, *args)
    inter = mut["intermediates"]
    for k in prefix:
        inter = inter[k]
    return [torch.from_numpy(np.array(
        inter[f"Dropout_{j}"]["__call__"][0] != 0)) for j in range(2)]


def _contexts(jrule, trule, task=0, n_tasks=1):
    common = dict(task=task, n_tasks=n_tasks, class_counts=[4, 4],
                  mean=MEAN, std=STD, augment=False)
    ctx_j = jtrain.make_context(jreg.parse_model_name("", "alexnet",
                                                      (PX, PX)),
                                update_rule=jrule, mesh=None, **common)
    ctx_t = ttrain.make_context(treg.parse_model_name("", "alexnet",
                                                      (PX, PX)),
                                update_rule=trule, device="cpu", **common)
    return ctx_j, ctx_t


def _engine_step(model, jrule, trule, jkw, tkw, hyper, task=0, n_tasks=1):
    """One engine step in each package from the same weights, a nonzero
    momentum and the JAX step's dropout masks; returns (port state, JAX
    state, port metrics, JAX metrics)."""
    x, y = _batch()
    rng = np.random.default_rng(3)
    tr = {"params": model["params"],
          "heads": {k: model["heads"][k] for k in ("kernel", "bias")}}
    mom = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1e-3, np.shape(a)).astype(np.float32), tr)
    lr, key = 0.01, jax.random.PRNGKey(11)
    ctx_j, ctx_t = _contexts(jrule, trule, task, n_tasks)
    state_j = jtrain.TrainState(_jnp(tr), {}, _jnp(mom),
                                jrule.init_state(_jnp(tr), hyper, ctx_j,
                                                 **jkw))
    new_j, m_j = jax.jit(jtrain.Engine(ctx_j)._train_step)(
        state_j, jnp.asarray(x), jnp.asarray(y), key, jnp.float32(lr))
    # the dropout key the JAX step used: rng -> (pre, step) -> (drop, extra)
    rng_drop = jax.random.split(jax.random.split(key)[1])[0]
    masks = _jax_dropout_masks(ctx_j.backbone,
                               {"params": _jnp(model["params"])},
                               jpp.normalize(jnp.asarray(x), MEAN, STD),
                               rng_drop)
    assert [tuple(m.shape) for m in masks] == [(B, 1024), (B, 4096)]
    state_t = ttrain.TrainState(
        ttrain.trainable_from_host(tr, "cpu", requires_grad=True), {},
        ttrain.trainable_from_host(mom, "cpu", requires_grad=False),
        trule.init_state(None, hyper, ctx_t, **tkw))
    new_t, m_t = ttrain.Engine(ctx_t)._train_step(
        state_t, torch.from_numpy(x), torch.from_numpy(y).long(), lr,
        dropout_masks=masks)
    return new_t, new_j, m_t, m_j


def _compare_step(new_t, new_j, m_t, m_j):
    _close_trees(ttrain.trainable_to_host(new_t.trainable), new_j.trainable)
    _close_trees(ttrain.trainable_to_host(new_t.momentum), new_j.momentum)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)


def test_one_sgd_step_matches_the_jax_engine(model):
    new_t, new_j, m_t, m_j = _engine_step(model, JRule(), TRule(), {}, {},
                                          {})
    _compare_step(new_t, new_j, m_t, m_j)
    # the step moved every conv and FC layer
    for layer in model["params"]:
        assert not np.array_equal(
            convert.params_to_jax(new_t.trainable["params"])[layer]["kernel"],
            model["params"][layer]["kernel"]), layer


def test_one_ebll_step_on_alexnet_matches(model):
    """EBLL at task 2: the LwF term against a teacher (the model with
    perturbed weights) plus the code term of one autoencoder on the
    1,024-wide conv output."""
    rng = np.random.default_rng(7)
    teacher = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.02, a.shape) * (np.abs(a).max() + 1e-3)
                   ).astype(np.float32), model["params"])
    prev = {**model, "params": teacher}
    ae = {"enc": {"kernel": rng.normal(0, 0.05, (1024, 16)).astype(
        np.float32), "bias": np.zeros(16, np.float32)},
          "dec": {"kernel": rng.normal(0, 0.05, (16, 1024)).astype(
              np.float32), "bias": np.zeros(1024, np.float32)}}
    spec_j = jreg.parse_model_name("", "alexnet", (PX, PX))
    kw = {"prev_model": prev, "encoders": [ae]}
    new_t, new_j, m_t, m_j = _engine_step(
        model, jebll.EBLLRule(spec_j), tebll.EBLLRule(), kw, kw,
        {"reg_lambda": 1.0, "ebll_reg_alpha": 10.0}, task=1, n_tasks=2)
    _compare_step(new_t, new_j, m_t, m_j)


def test_one_hat_step_on_alexnet_matches(model):
    """HATAlexNet at task 2 outside finetune_mode: gates, sparsity term,
    mask_back from task 1's embeddings (``fc_0``'s NHWC tiling over the
    2x2 map), the JAX run's flips and dropout masks."""
    smax, task, n_tasks = 400.0, 1, 2
    spec_j = jreg.parse_model_name("", "alexnet", (PX, PX))
    spec_t = treg.parse_model_name("", "alexnet", (PX, PX))
    net_j = jhat.make_hat_model(spec_j, n_tasks)
    net_t = that.make_hat_model(spec_t, n_tasks)
    assert isinstance(net_t, that.HATAlexNet) and net_t.smid_hw == (2, 2)
    params = jio.to_host(jax.jit(net_j.init)(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, PX, PX, 3)), 0,
        jnp.float32(1.0))["params"])
    rng = np.random.default_rng(8)
    for name in params:
        if name.startswith("emb_"):
            params[name] = rng.uniform(-1.0, 1.5, params[name].shape).astype(
                np.float32)
    @jax.jit
    def jax_masks(prm):
        pre = jhat.compute_mask_pre(net_j, prm, task, smax)
        return pre, jhat.compute_mask_back(net_j, prm, pre, (PX, PX))

    pre_j, back_j = jax_masks(_jnp(params))
    p_t = convert.hat_params_from_jax(params)
    pre_t = that.compute_mask_pre(p_t, net_t.emb_names, task, smax)
    back_t = that.compute_mask_back(net_t, p_t, pre_t)
    _close_trees(convert.hat_params_to_jax(back_t), back_j, rel=1e-6)

    eng_j = jhat.HATEngine(net_j, spec_j, task, [4, 4], MEAN, STD, smax,
                           None, pre_j, back_j)
    eng_t = that.HATEngine(net_t, spec_t, task, [4, 4], MEAN, STD, smax,
                           pre_t, back_t, device="cpu")
    tr = {"params": params, "heads": {
        "kernel": rng.normal(0, 0.05, (n_tasks, 4096, 4)).astype(np.float32),
        "bias": np.zeros((n_tasks, 4), np.float32)}}
    mom = jax.tree_util.tree_map(np.zeros_like, tr)
    x, y = _batch(4)
    key, lr, lamb, s = jax.random.PRNGKey(2), 0.01, 0.75, 50.0
    new_j, m_j = jax.jit(eng_j._train_step)(
        (_jnp(tr), _jnp(mom)), jnp.asarray(x), jnp.asarray(y), key,
        jnp.float32(lr), jnp.float32(s), jnp.float32(lamb))
    pre_key, drop_key = jax.random.split(key)
    flip = np.asarray(jax.random.bernoulli(pre_key, 0.5, (B, 1, 1, 1))
                      ).reshape(B).astype(np.uint8)
    masks = _jax_dropout_masks(
        net_j, {"params": _jnp(params)},
        jpp.preprocess(pre_key, jnp.asarray(x), MEAN, STD, augment=True),
        drop_key, task, jnp.float32(s))
    assert [tuple(m.shape) for m in masks] == [(B, 1024), (B, 4096)]
    state_t = (that.hat_from_host(tr, "cpu", True),
               that.hat_from_host(mom, "cpu", False))
    new_t, m_t = eng_t.train_step(
        state_t, torch.from_numpy(x), torch.from_numpy(y).long(), lr, s,
        lamb, flip=torch.from_numpy(flip), dropout_masks=masks)
    for which in (0, 1):
        _close_trees(that.hat_to_host(new_t[which]), new_j[which])
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)


def test_one_pathnet_step_on_alexnet_matches(monkeypatch):
    """PathNetAlexNet (M 4, N 2, kernels 10, 8 and 2 at 80 px): one epoch
    of one 32-row step at task 2 with a module frozen, the JAX run's flip
    and its five dropout masks (the keys of its ``jax.random.bernoulli``
    calls under the step's key, drawn again here). The JAX step runs in
    float64 (``jax.enable_x64``, float64 modules and weights; features and
    heads stay float32 in both packages) and is held against the port's
    float64 step within 1e-5 of each leaf's largest entry; the port's
    float32 step is held against its float64 step at the same tolerance.
    In float32 the 10x10 conv's weight gradient sums 32 x 71 x 71 terms
    with heavy cancellation: the JAX package's float32 step and oneDNN's
    (PyTorch's default CPU conv) are up to 2e-3 of conv_0's largest update
    off float64, so the port's float32 step runs on PyTorch's native CPU
    conv (within 2e-6)."""
    M, N = 4, 2
    net_t = tpath.PathNetAlexNet(PPX, M)
    assert net_t.ksizes == (10, 8, 2) and net_t.feature_dim == 528
    params = jio.to_host(jax.jit(jpath.PathNetAlexNet(
        input_px=PPX, M=M, N=N).init)(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((2, PPX, PPX, 3)),
        jnp.zeros((5, N), jnp.int32))["params"])
    p_t = convert.pathnet_params_from_jax(params)
    assert {k: tuple(v.shape) for k, v in p_t.items()} == {
        k: tuple(v.shape) for k, v in
        dict(net_t.named_parameters()).items()}
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (32, PPX, PPX, 3), dtype=np.uint8)
    y = rng.integers(0, 4, (32,)).astype(np.int32)
    perm = rng.permutation(32)  # one step of the whole 32 rows
    path = np.asarray([[0, 2], [1, 1], [3, 0], [2, 1], [0, 3]], np.int32)
    frozen = np.zeros((5, M), np.float32)
    frozen[:, 1] = 1.0
    tr = {"params": params, "heads": {
        "kernel": rng.normal(0, 0.05, (2, 528, 4)).astype(np.float32),
        "bias": np.zeros((2, 4), np.float32)}}
    tr64 = {"params": {k: v.astype(np.float64) for k, v in params.items()},
            "heads": tr["heads"]}
    key, lr = jax.random.PRNGKey(5), 0.01
    calls, bernoulli = [], jax.random.bernoulli

    def spy(k, p=0.5, shape=None):
        calls.append((k, p, shape))
        return bernoulli(k, p, shape)

    with jax.enable_x64(True):
        net_j = jpath.PathNetAlexNet(input_px=PPX, M=M, N=N,
                                     dtype=jnp.float64)
        train_j, eval_j = jpath.PathNet()._make_fns(net_j, MEAN, STD,
                                                    [4, 4], 1)
        new_j, mom_j = train_j(
            _jnp(tr64), jax.tree_util.tree_map(jnp.zeros_like, _jnp(tr64)),
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(perm),
            jnp.asarray(path),
            jpath.module_train_mask(_jnp(tr64["params"]), path, frozen, 3),
            key, jnp.asarray(lr))
        assert new_j["params"]["conv_0_kernel"].dtype == jnp.float64

        _, sub, pre = jax.random.split(key, 3)  # the epoch's one step
        flip = np.asarray(jax.random.bernoulli(pre, 0.5, (32, 1, 1, 1))
                          ).reshape(32).astype(np.uint8)

        # the step's dropout draws: the keys, probabilities and shapes of
        # the model's ``bernoulli`` calls under the step's dropout key
        # (traced once), then the same draws made here
        def keys_of(prm):
            net_j.apply({"params": prm}, jnp.zeros((32, PPX, PPX, 3)),
                        jnp.asarray(path), train=True, rngs={"dropout": sub})
            return [k for k, _, _ in calls]

        monkeypatch.setattr(jax.random, "bernoulli", spy)
        keys = jax.jit(keys_of)(_jnp(tr64["params"]))
        monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
        drawn = [torch.from_numpy(np.array(bernoulli(k, p, shape)))
                 for k, (_, p, shape) in zip(keys, calls)]
        acc_j = float(eval_j(new_j, jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(path)))
        new_j, mom_j = jio.to_host(new_j), jio.to_host(mom_j)
    assert [tuple(m.shape) for m in drawn] == [
        s for s, _ in net_t.drop_shapes(32, N)]

    def port_epoch(dtype):
        net = tpath.PathNetAlexNet(PPX, M, dtype=dtype)
        fns = tpath.PathNetFns(net, MEAN, STD, [4, 4], 1,
                               torch.device("cpu"))
        fns.draw = lambda gen, b: torch.from_numpy(flip)
        fns.draw_dropout = lambda gen, b, n: drawn
        tr_t = ttrain.trainable_from_host(tr, "cpu", True,
                                         convert.pathnet_params_from_jax)
        tr_t["params"] = {k: v.detach().to(dtype).requires_grad_()
                          for k, v in tr_t["params"].items()}
        with torch.backends.mkldnn.flags(enabled=False):
            return fns, fns.train_epoch(
                tr_t, ttrain.tree_zeros_like(tr_t), torch.from_numpy(x),
                torch.from_numpy(y).long(), torch.from_numpy(perm), path,
                tpath.module_train_mask(tr_t["params"], path, frozen, 3),
                None, lr)

    _, (new_t, mom_t) = port_epoch(torch.float32)
    fns, (exact, mom_e) = port_epoch(torch.float64)
    for got_t, got_e, want in ((new_t, exact, new_j), (mom_t, mom_e, mom_j)):
        g, e = (convert.pathnet_params_to_jax(t["params"])
                for t in (got_t, got_e))
        assert set(e) == set(want["params"])
        for k, w in want["params"].items():
            _close(e[k], w, 1e-5, k)
            _close(g[k], e[k], 1e-5, k)
        for k in ("kernel", "bias"):
            e_k = got_e["heads"][k].detach().numpy()
            _close(e_k, want["heads"][k], 1e-5, k)
            _close(got_t["heads"][k].detach().numpy(), e_k, 1e-5, k)
    # eval of the path, no dropout: the same accuracy
    assert fns.eval_acc(exact, torch.from_numpy(x), y, path) == \
        pytest.approx(acc_j)


# ---------------------------------------------------------------------------
# the CLI on a small RecogSeq tree
# ---------------------------------------------------------------------------

CLI_PX = 64


def _use(root):
    os.environ["CLSURVEY_ROOT"] = str(root)
    for mod in (jconfig, tconfig):
        mod.set_config(None)
        mod.load_config(refresh=True)


@pytest.fixture
def restore_env():
    old = os.environ.get("CLSURVEY_ROOT")
    yield
    if old is None:
        os.environ.pop("CLSURVEY_ROOT", None)
    else:
        os.environ["CLSURVEY_ROOT"] = old
    jconfig.set_config(None)
    tconfig.set_config(None)


def _results(root):
    parent = os.path.join(str(root), "results", "test", "results",
                          "recogseq", "finetuning", "alexnet", "demo")
    (exp,) = os.listdir(parent)
    return {fn: jio.load(os.path.join(parent, exp, fn))
            for fn in sorted(os.listdir(os.path.join(parent, exp)))}


def test_alexnet_cli_on_recogseq_is_read_by_the_jax_package(
        restore_env, tmp_path, monkeypatch, capsys):
    """``alexnet --method_name finetuning --ds_name recogseq`` through the
    port's CLI for 2 tasks (unequal class counts: 2 and 3), then the JAX
    CLI over a copy of the run: it trains nothing and writes the same
    eval results."""
    from PIL import Image

    raw = tmp_path / "raw"
    rng = np.random.default_rng(0)
    for k, name in enumerate(trs.TASKS[:2]):
        for c in range(2 + k):
            for split, n in (("train", 12), ("test", 10)):
                d = raw / name / split / f"cls{c}"
                d.mkdir(parents=True)
                for j in range(n):
                    img = np.clip(rng.normal(60 * c + 40, 30, (32, 32, 3)),
                                  0, 255).astype(np.uint8)
                    Image.fromarray(img).save(d / f"{j}.png")
    for name in trs.TASKS[2:]:  # later tasks: one tiny class each
        for split, n in (("train", 1), ("test", 2)):
            d = raw / name / split / "c"
            d.mkdir(parents=True)
            for j in range(n):
                Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
                    d / f"{j}.png")
    _use(tmp_path / "port")
    monkeypatch.setattr(trs, "IMG_SIZE", CLI_PX)
    trs.prepare(str(raw), tconfig.load_config().ds_root_path)
    argv = ["alexnet", "--method_name", "finetuning", "--ds_name",
            "recogseq", "--num_epochs", "2", "--batch_size", "8",
            "--lr_grid", "1e-3", "--max_task_count", "2", "--test",
            "--device", "cpu", "--gridsearch_name", "demo"]
    manager = tmain.cli(argv)
    assert manager.dataset.input_size == (CLI_PX, CLI_PX)
    assert manager.dataset.class_count_list()[:2] == [2, 3]
    best = tio.load(manager.best_model_path(2, create=False))
    assert best["params"]["fc_0"]["kernel"].shape == (256, 4096)
    want = _results(tmp_path / "port")
    assert len(want) == 2

    shutil.copytree(tmp_path / "port", tmp_path / "jax", symlinks=True,
                    ignore=shutil.ignore_patterns("test"))
    _use(tmp_path / "jax")
    capsys.readouterr()
    jmain(JRunArgs(model_name="alexnet", ds_name="recogseq",
                   method_name="finetuning", num_epochs=2, batch_size=8,
                   lr_grid=(1e-3,), max_task_count=2, test=True,
                   gridsearch_name="demo"))
    assert "epoch 0:" not in capsys.readouterr().out  # nothing trained
    got = _results(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    for fn, w in want.items():
        g, w = got[fn]["finetuning"], w["finetuning"]
        for key in ("seq_res", "seq_forgetting"):
            assert list(g[key]) == list(w[key])
            for i in w[key]:
                np.testing.assert_allclose(g[key][i], w[key][i], rtol=0,
                                           atol=1e-4)
