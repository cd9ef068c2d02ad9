"""clsurvey_torch's batch-norm and dropout backbones against clsurvey_tpu's
on the CPU (tiny_CNN_cl_32_32_BN_DROP at 32 px, float32, numpy-made inputs).

- eval and train forwards of a JAX-made BN model with nonzero running
  statistics: eval features within rtol 1e-4 / atol 1e-5 (float32 convs
  summed in another order, then normalized); train features within rtol
  1e-4 / atol 2e-4, which is 2e-5 of their largest value of about 10 (the
  two variance formulas differ by about 1e-6 relative, and two
  normalizations and the kaiming-initialised trunk carry that through
  sums that cancel);
- the running statistics after three train-mode forwards: within rtol 1e-5 /
  atol 1e-6 of flax's. flax's batch variance is ``mean(x^2) - mean(x)^2``
  and the port's is two-pass, which costs about 1e-6 relative here; the
  update uses the *biased* variance, so the result is NOT
  ``nn.BatchNorm2d``'s: on 8 values per channel its unbiased update is
  0.1 * var / 7 away after a single step, while flax's is within 1e-6;
- one full engine train step of the ``_BN_DROP`` model, the dropout masks
  taken from the JAX run: params, momentum and new ``batch_stats`` within
  atol 2e-5;
- ``batch_stats`` and ``bn_<i>/{scale,bias}`` through ``models/convert.py``
  in both directions, the init pickle in the other package, and an epoch
  checkpoint that resumes with its statistics;
- ``ewc_fisher`` and ``mas_importance`` (``torch.func.vmap(grad)``) on the
  BN_DROP model: eval mode, running statistics, within rtol 1e-4 / atol
  1e-7 of the JAX package's;
- a bf16 BN model normalizes in float32, and a dropout model without masks
  raises; a float64 one (the card checks' CPU reference) normalizes in
  float64, 1e-12 of a float64 batch-norm written out, and keeps float32
  running statistics;
- the finetuning CLI on ``tiny_CNN_cl_32_32_BN_DROP`` on the CPU, two tasks,
  two epochs, with ``--test``: its best models, read by the JAX package and
  run under the flax backbone with their ``batch_stats``, score the val
  accuracy the port recorded (within one val sample)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.data import registry as tdata
from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.framework import main as tmain
from clsurvey_torch.methods.base import UpdateRule as TRule
from clsurvey_torch.models import convert, registry as treg
from clsurvey_torch.ops import importance as timp
from clsurvey_torch.utils import config as tconfig, io as tio
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.methods.base import UpdateRule as JRule
from clsurvey_tpu.models import heads as jheads, registry as jreg
from clsurvey_tpu.ops import importance as jimp, preprocess as jpp
from clsurvey_tpu.utils import io as jio

NAME, PX = "tiny_CNN_cl_32_32_BN_DROP", 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture(autouse=True)
def port_config():
    tconfig.set_config(None)
    yield tconfig.load_config(refresh=True)
    tconfig.set_config(None)


@pytest.fixture(scope="module")
def shared_model():
    """A JAX-made BN_DROP model (numpy) whose scale, bias and running
    statistics are moved off their init values."""
    spec = jreg.parse_model_name("", NAME, (PX, PX))
    model = jio.to_host(jreg.init_model_state(
        spec, jax.random.PRNGKey(3), max_tasks=2, classes_per_task=4))
    rng = np.random.default_rng(1)
    for i in (0, 2):
        bn = model["params"]["features"][f"bn_{i}"]
        bn["scale"] = rng.uniform(0.5, 1.5, bn["scale"].shape).astype(
            np.float32)
        bn["bias"] = rng.normal(0, 0.1, bn["bias"].shape).astype(np.float32)
        st = model["batch_stats"]["features"][f"bn_{i}"]
        st["mean"] = rng.normal(0, 0.2, st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    return model


def _jnp(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def _trainable(model):
    return {"params": model["params"],
            "heads": {k: model["heads"][k] for k in ("kernel", "bias")}}


def _assert_trees_close(port_tree, jax_tree, **tol):
    flat = jax.tree_util.tree_flatten_with_path(jio.to_host(jax_tree))[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(port_tree))
    for key_path, want in flat:
        got = port_tree
        for k in key_path:
            got = got[k.key]
        np.testing.assert_allclose(got, want, **tol,
                                   err_msg=jax.tree_util.keystr(key_path))


def _jax_dropout_masks(backbone, variables, x, rng):
    """The keep-masks flax draws under ``rng``: where a ``Dropout`` output
    is nonzero. Where its input is 0 the mask does not matter."""
    _, mut = backbone.apply(
        variables, x, train=True, rngs={"dropout": rng},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: "Dropout" in (mdl.name or ""))
    trunk = mut["intermediates"]["trunk"]
    return [np.asarray(trunk[f"Dropout_{j}"]["__call__"][0] != 0)
            for j in range(2)]


def test_bn_forward_eval_and_train_match_flax(shared_model):
    x = np.random.default_rng(0).normal(0, 1, (16, PX, PX, 3)).astype(
        np.float32)
    backbone_j = jreg.parse_model_name("", NAME, (PX, PX)).make_backbone()
    variables = {"params": _jnp(shared_model["params"]),
                 "batch_stats": _jnp(shared_model["batch_stats"])}
    backbone_t = treg.parse_model_name("", NAME, (PX, PX)).make_backbone()
    params = convert.params_from_jax(shared_model["params"])
    stats = convert.batch_stats_from_jax(shared_model["batch_stats"])
    call = lambda **kw: torch.func.functional_call(
        backbone_t, params, (torch.from_numpy(x),),
        {"batch_stats": stats, **kw})

    want = backbone_j.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = call()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)

    rng = jax.random.PRNGKey(5)
    want, mut = backbone_j.apply(variables, jnp.asarray(x), train=True,
                                 rngs={"dropout": rng},
                                 mutable=["batch_stats"])
    masks = _jax_dropout_masks(backbone_j, variables, jnp.asarray(x), rng)
    assert 0.1 < masks[0].mean() < 0.6  # about half of the nonzero units
    with torch.no_grad():
        got, new_stats = call(train=True, dropout_masks=[
            torch.tensor(m) for m in masks])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-4)
    _assert_trees_close(convert.batch_stats_to_jax(new_stats),
                        mut["batch_stats"], rtol=1e-5, atol=1e-6)
    # the call returned new tensors: the statistics handed in are untouched
    _assert_trees_close(convert.batch_stats_to_jax(stats),
                        shared_model["batch_stats"], rtol=0, atol=0)


def test_running_stats_after_three_steps_are_flax_biased_ones(shared_model):
    rng = np.random.default_rng(2)
    backbone_j = jreg.parse_model_name("", NAME, (PX, PX)).make_backbone()
    backbone_t = treg.parse_model_name("", NAME, (PX, PX)).make_backbone()
    params = convert.params_from_jax(shared_model["params"])
    stats_t = convert.batch_stats_from_jax(shared_model["batch_stats"])
    stats_j = _jnp(shared_model["batch_stats"])
    ones = [torch.ones(8, 32), torch.ones(8, 32)]
    after_one = None
    for _ in range(3):
        # a small batch, so biased and unbiased variances are far apart
        x = rng.normal(0.3, 2.0, (8, PX, PX, 3)).astype(np.float32)
        _, mut = backbone_j.apply(
            {"params": _jnp(shared_model["params"]),
             "batch_stats": stats_j}, jnp.asarray(x), train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        stats_j = mut["batch_stats"]
        with torch.no_grad():
            _, stats_t = torch.func.functional_call(
                backbone_t, params, (torch.from_numpy(x),),
                {"batch_stats": stats_t, "train": True,
                 "dropout_masks": ones})
        after_one = after_one or (x, dict(stats_t))
    _assert_trees_close(convert.batch_stats_to_jax(stats_t), stats_j,
                        rtol=1e-5, atol=1e-6)



def test_the_running_variance_is_flax_biased_one_not_batchnorm2d():
    """On 2x2x2 = 8 values per channel the unbiased variance is 8/7 of the
    biased one: after a single step the port's running variance equals
    flax's within 1e-6 and is 0.1 * var / 7 away from nn.BatchNorm2d's."""
    import flax.linen as nn

    rng = np.random.default_rng(4)
    x = rng.normal(0.5, 2.0, (2, 2, 2, 8)).astype(np.float32)  # NHWC
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5)
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want_y, mut = flax_bn.apply(variables, jnp.asarray(x),
                                mutable=["batch_stats"])

    backbone = treg.parse_model_name("", NAME, (PX, PX)).make_backbone()
    new_stats: dict = {}
    x_nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_y = backbone._bn(x_nchw, 0, backbone.init_batch_stats(), True,
                             new_stats)
    np.testing.assert_allclose(got_y.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new_stats["features.bn_0.mean"].numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(new_stats["features.bn_0.var"].numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)

    bn2d = torch.nn.BatchNorm2d(8, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        bn2d(x_nchw)
    batch_var = x_nchw.var(dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(
        bn2d.running_var - new_stats["features.bn_0.var"],
        0.1 * batch_var / 7, rtol=1e-4, atol=1e-6)
    assert float((bn2d.running_var
                  - new_stats["features.bn_0.var"]).min()) > 1e-3


def _contexts():
    common = dict(task=0, n_tasks=1, class_counts=[4, 4], mean=MEAN, std=STD,
                  augment=False)
    ctx_j = jtrain.make_context(jreg.parse_model_name("", NAME, (PX, PX)),
                                update_rule=JRule(), mesh=None, **common)
    ctx_t = ttrain.make_context(treg.parse_model_name("", NAME, (PX, PX)),
                                update_rule=TRule(), device="cpu", **common)
    return ctx_j, ctx_t


def test_one_bn_drop_train_step_matches_the_jax_engine(shared_model):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (16, PX, PX, 3), dtype=np.uint8)
    y = rng.integers(0, 4, (16,)).astype(np.int32)
    trainable = _trainable(shared_model)
    momentum = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1e-2, np.shape(a)).astype(np.float32),
        trainable)
    lr, key = 0.05, jax.random.PRNGKey(11)
    ctx_j, ctx_t = _contexts()

    state_j = jtrain.TrainState(
        _jnp(trainable), _jnp(shared_model["batch_stats"]), _jnp(momentum),
        JRule().init_state(None, {}, ctx_j))
    new_j, m_j = jax.jit(jtrain.Engine(ctx_j)._train_step)(
        state_j, jnp.asarray(x), jnp.asarray(y), key, jnp.float32(lr))

    # the dropout key the JAX step used: rng -> (pre, step) -> (drop, extra)
    rng_drop = jax.random.split(jax.random.split(key)[1])[0]
    from clsurvey_tpu.ops import importance as jimp, preprocess as jpp
    masks = _jax_dropout_masks(
        ctx_j.backbone, {"params": _jnp(shared_model["params"]),
                         "batch_stats": _jnp(shared_model["batch_stats"])},
        jpp.normalize(jnp.asarray(x), MEAN, STD), rng_drop)

    state_t = ttrain.TrainState(
        ttrain.trainable_from_host(trainable, "cpu", requires_grad=True),
        convert.batch_stats_from_jax(shared_model["batch_stats"]),
        ttrain.trainable_from_host(momentum, "cpu", requires_grad=False),
        TRule().init_state(None, {}, ctx_t))
    new_t, m_t = ttrain.Engine(ctx_t)._train_step(
        state_t, torch.from_numpy(x), torch.from_numpy(y).long(), lr,
        dropout_masks=[torch.tensor(m) for m in masks])

    _assert_trees_close(ttrain.trainable_to_host(new_t.trainable),
                        new_j.trainable, rtol=0, atol=2e-5)
    _assert_trees_close(ttrain.trainable_to_host(new_t.momentum),
                        new_j.momentum, rtol=0, atol=2e-5)
    _assert_trees_close(convert.batch_stats_to_jax(new_t.batch_stats),
                        new_j.batch_stats, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    # the step moved the batch-norm scale and the statistics
    assert not np.allclose(
        new_t.trainable["params"]["features.bn_0.scale"].detach().numpy(),
        shared_model["params"]["features"]["bn_0"]["scale"], atol=1e-6)


@pytest.mark.parametrize("name", ["tiny_CNN_cl_32_32_BN",
                                  "tiny_CNN_cl_32_32_DROP",
                                  "small_VGG9_cl_128_128_BN_DROP"])
def test_init_pickles_load_in_the_other_package(tmp_path, name):
    spec_t = treg.parse_model_name(str(tmp_path), name, (PX, PX))
    spec_j = jreg.parse_model_name(str(tmp_path), name, (PX, PX))
    assert (spec_t.batch_norm, spec_t.dropout, spec_t.has_batch_stats,
            spec_t.uses_dropout, spec_t.path) == (
        spec_j.batch_norm, spec_j.dropout, spec_j.has_batch_stats,
        spec_j.uses_dropout, spec_j.path)
    treg.create_init_model(spec_t, 7, max_tasks=2, classes_per_task=4)
    ours = jio.load(spec_t.path)  # the JAX package reads the port's file
    ref = jio.to_host(jreg.init_model_state(spec_j, jax.random.PRNGKey(7),
                                            2, 4))
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)
    assert shapes(ours["params"]) == shapes(ref["params"])
    assert shapes(ours["batch_stats"]) == shapes(ref["batch_stats"])
    assert treg.count_parameters(ours) == jreg.count_parameters(ref)
    for tree in (ours, ref):  # scale 1, bias 0, mean 0, var 1 in both
        for layer, st in tree["batch_stats"].get("features", {}).items():
            assert not st["mean"].any() and (st["var"] == 1).all()
            bn = tree["params"]["features"][layer]
            assert (bn["scale"] == 1).all() and not bn["bias"].any()
    # both directions through the converter are exact
    back = convert.batch_stats_to_jax(
        convert.batch_stats_from_jax(ref["batch_stats"]))
    _assert_trees_close(back, ref["batch_stats"], rtol=0, atol=0)
    _assert_trees_close(
        convert.params_to_jax(convert.params_from_jax(ref["params"])),
        ref["params"], rtol=0, atol=0)
    # the JAX backbone runs on the port's init
    x = jnp.zeros((2, PX, PX, 3))
    variables = {"params": _jnp(ours["params"])}
    if spec_j.has_batch_stats:
        variables["batch_stats"] = _jnp(ours["batch_stats"])
    feats = spec_j.make_backbone().apply(variables, x, train=False)
    assert feats.shape == (2, spec_j.feature_dim)


def test_bn_checkpoint_resumes_with_its_statistics(shared_model, tmp_path):
    td = tdata.parse("synthetic_2t_4c_32px").get_task_dataset(1)
    _, ctx_t = _contexts()
    engine = ttrain.Engine(ctx_t)
    job = ttrain.TrainJob(exp_dir=str(tmp_path), num_epochs=2,
                          batch_size=32, lr=1e-2, saving_freq=1)
    state = ttrain.state_from_model(shared_model, {"hyper": {}}, "cpu")
    best, _, final = ttrain.train_task(engine, job, state, td,
                                       log=lambda *_: None)
    ck = jio.load(str(tmp_path / "epoch.pth.tar"))
    assert set(ck["batch_stats"]["features"]) == {"bn_0", "bn_2"}
    _, resumed = ttrain._load_resume(str(tmp_path / "epoch.pth.tar"), "cpu")
    for k, v in final.batch_stats.items():
        torch.testing.assert_close(resumed.batch_stats[k], v, rtol=0, atol=0)
        assert bool((v > 0).all()) or k.endswith("mean")
    # training moved the statistics, and the best model carries them in the
    # JAX layout
    on_disk = tio.load(str(tmp_path / "best_model.pth.tar"))
    assert not np.allclose(
        on_disk["batch_stats"]["features"]["bn_0"]["mean"],
        shared_model["batch_stats"]["features"]["bn_0"]["mean"])
    # two runs from one seed draw the same dropout masks: same best model
    job2 = ttrain.TrainJob(exp_dir=str(tmp_path / "again"), num_epochs=2,
                           batch_size=32, lr=1e-2, saving_freq=1)
    state = ttrain.state_from_model(shared_model, {"hyper": {}}, "cpu")
    best2, _, _ = ttrain.train_task(engine, job2, state, td,
                                    log=lambda *_: None)
    np.testing.assert_array_equal(
        best["params"]["trunk"]["fc_1"]["kernel"],
        best2["params"]["trunk"]["fc_1"]["kernel"])


@pytest.mark.parametrize("which", ["ewc", "mas"])
def test_importance_passes_on_a_bn_model_match(shared_model, which):
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (20, PX, PX, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (20,)).astype(np.int32)
    ctx_j, ctx_t = _contexts()
    params_j = _jnp(shared_model["params"])
    stats_j = _jnp(shared_model["batch_stats"])
    bank_j = {"kernel": jnp.asarray(shared_model["heads"]["kernel"]),
              "bias": jnp.asarray(shared_model["heads"]["bias"]),
              "class_counts": shared_model["heads"]["class_counts"]}
    params_t = convert.params_from_jax(shared_model["params"])
    stats_t = convert.batch_stats_from_jax(shared_model["batch_stats"])
    if which == "ewc":  # batch 8: a ragged tail of 4
        want = jimp.ewc_fisher(ctx_j, params_j, stats_j, bank_j, 0,
                               jnp.asarray(images), jnp.asarray(labels), 8)
        got = timp.ewc_fisher(ctx_t, params_t, stats_t,
                              shared_model["heads"], 0, images, labels, 8)
    else:
        want = jimp.mas_importance(ctx_j, params_j, stats_j, bank_j, 0,
                                   jnp.asarray(images), chunk=8)
        got = timp.mas_importance(ctx_t, params_t, stats_t,
                                  shared_model["heads"], 0, images, chunk=8)
    _assert_trees_close(convert.params_to_jax(got), want, rtol=1e-4,
                        atol=1e-7)
    # the batch-norm scale has an importance of its own
    assert float(got["features.bn_0.scale"].max()) > 0


def test_bf16_bn_normalizes_in_float32_and_dropout_needs_masks():
    spec = treg.parse_model_name("", NAME, (PX, PX),
                                 compute_dtype=torch.bfloat16)
    backbone = spec.make_backbone()
    stats = backbone.init_batch_stats()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (4, PX, PX, 3)).astype(np.float32))
    seen = []
    hook = torch.nn.functional.batch_norm

    def spy(inp, *a, **k):
        seen.append(inp.dtype)
        return hook(inp, *a, **k)

    torch.nn.functional.batch_norm = spy
    try:
        with torch.no_grad():
            feats, new_stats = backbone(
                x, stats, train=True,
                dropout_masks=[torch.ones(4, 32), torch.ones(4, 32)])
    finally:
        torch.nn.functional.batch_norm = hook
    assert seen == [torch.float32, torch.float32]
    assert feats.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in new_stats.values())
    with pytest.raises(ValueError, match="keep-mask"):
        backbone(x, stats, train=True)


def test_float64_bn_normalizes_in_float64_with_float32_statistics():
    spec = treg.parse_model_name("", NAME, (PX, PX),
                                 compute_dtype=torch.float64)
    backbone = spec.make_backbone()
    with torch.no_grad():
        for name, layer in backbone.features.items():
            if name.startswith("bn_"):
                layer.scale.uniform_(0.5, 1.5)
                layer.bias.uniform_(-0.5, 0.5)
    stats = backbone.init_batch_stats()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (6, 8, 5, 5)))
    for train in (True, False):
        new_stats = {}
        got = backbone._bn(x, 0, stats, train, new_stats)
        mean, var = ((x.mean((0, 2, 3)), x.var((0, 2, 3), correction=0))
                     if train else (stats["features.bn_0.mean"].double(),
                                    stats["features.bn_0.var"].double()))
        layer = backbone.features["bn_0"]
        want = ((x - mean.view(1, -1, 1, 1))
                * torch.rsqrt(var.view(1, -1, 1, 1) + 1e-5)
                * layer.scale.double().view(1, -1, 1, 1)
                + layer.bias.double().view(1, -1, 1, 1))
        assert got.dtype == torch.float64
        assert float((got - want).abs().max()) <= \
            1e-12 * float(want.abs().max())
        assert all(v.dtype == torch.float32 for v in new_stats.values())
        assert len(new_stats) == (2 if train else 0)


def test_bn_drop_finetune_cli_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("CLSURVEY_ROOT", str(tmp_path))
    tconfig.set_config(None)
    manager = tmain.cli([
        NAME, "--method_name", "finetuning", "--ds_name",
        "synthetic_2t_4c_32px", "--num_epochs", "2", "--batch_size", "32",
        "--lr_grid", "1e-2", "--device", "cpu", "--test"])
    assert sorted(manager.extras["task_seconds"]) == [1, 2]
    assert [len(r["seq_res"]) for r in manager.extras["eval_results"]] \
        == [2, 1]
    spec = jreg.parse_model_name("", NAME, (PX, PX))
    seq = tdata.parse("synthetic_2t_4c_32px")
    for task in (1, 2):
        model = jio.load(manager.best_model_path(task, create=False))
        stats = model["batch_stats"]["features"]
        assert sorted(stats) == ["bn_0", "bn_2"]
        assert all((st["var"] > 0).all() and st["mean"].any()
                   for st in stats.values())
        val = seq.get_task_dataset(task).val
        feats = spec.make_backbone().apply(
            {"params": _jnp(model["params"]),
             "batch_stats": _jnp(model["batch_stats"])},
            jpp.normalize(jnp.asarray(val.images), seq.mean, seq.std),
            train=False)
        logits = jheads.forward(model["heads"], feats, task - 1)
        acc = float(np.mean(np.asarray(jnp.argmax(logits, -1))
                            == val.labels))
        assert abs(acc - model["meta"]["val_acc"]) <= 1.0 / val.size + 1e-9
