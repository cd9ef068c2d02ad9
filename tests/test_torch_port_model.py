"""clsurvey_torch models, data, paths and IO against clsurvey_tpu on the
CPU: the weight converter, logits on a JAX-written init pickle (rtol 1e-4,
atol 1e-5: float32 convs summed in another order), the head bank and its
init schemes, byte-identical synthetic data, identical path strings and
checkpoints that load in either package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.data import registry as tdata
from clsurvey_torch.models import convert, heads as theads, \
    registry as treg
from clsurvey_torch.utils import config as tconfig, io as tio, \
    paths as tpaths
from clsurvey_tpu.data import registry as jdata
from clsurvey_tpu.models import heads as jheads, registry as jreg
from clsurvey_tpu.utils import config as jconfig, io as jio, \
    paths as jpaths


@pytest.fixture(autouse=True)
def port_config():
    """Point the port's config at the same CLSURVEY_ROOT as the JAX one."""
    tconfig.set_config(None)
    yield tconfig.load_config(refresh=True)
    tconfig.set_config(None)


def _jax_model(tmp_path, name, px, seed=3, max_tasks=2, classes=4):
    spec = jreg.parse_model_name(str(tmp_path), name, (px, px))
    state = jreg.init_model_state(spec, jax.random.PRNGKey(seed),
                                  max_tasks=max_tasks,
                                  classes_per_task=classes)
    path = os.path.join(str(tmp_path), "init.pth.tar")
    jio.save(state, path)
    return spec, path


@pytest.mark.parametrize("name,px", [("tiny_CNN_cl_32_32", 32),
                                     ("small_VGG9_cl_128_128", 32)])
def test_logits_on_jax_written_init_pickle(tmp_path, name, px):
    spec_j, path = _jax_model(tmp_path, name, px)
    model = tio.load(path)  # the port reads the JAX package's pickle
    spec_t = treg.parse_model_name(str(tmp_path), name, (px, px))
    x = np.random.default_rng(0).normal(0, 1, (8, px, px, 3)).astype(
        np.float32)

    bank_j = {**model["heads"]}
    feats_j = spec_j.make_backbone().apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, model["params"])},
        jnp.asarray(x), train=False)
    want = np.asarray(jheads.forward(bank_j, feats_j, 1))

    backbone = spec_t.make_backbone()
    params = convert.params_from_jax(model["params"])
    bank_t = {"kernel": torch.tensor(model["heads"]["kernel"]),
              "bias": torch.tensor(model["heads"]["bias"]),
              "class_counts": model["heads"]["class_counts"]}
    with torch.no_grad():
        feats_t = torch.func.functional_call(backbone, params,
                                             (torch.from_numpy(x),))
        got = theads.forward(bank_t, feats_t, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_converter_round_trip(tmp_path):
    _, path = _jax_model(tmp_path, "small_VGG9_cl_128_128", 32)
    tree = tio.load(path)["params"]
    params = convert.params_from_jax(tree)
    assert params["features.conv_0.weight"].shape == (64, 3, 3, 3)
    assert params["features.conv_0.weight"].is_contiguous(
        memory_format=torch.channels_last)
    assert params["trunk.fc_0.weight"].shape == (128, 2 * 2 * 128)
    back = convert.params_to_jax(params)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for key_path, leaf in flat:
        got = back
        for k in key_path:
            got = got[k.key]
        np.testing.assert_array_equal(got, leaf)
    # the port's own module has exactly these parameter names and shapes
    module = treg.parse_model_name("", "small_VGG9_cl_128_128",
                                   (32, 32)).make_backbone()
    assert {k: tuple(v.shape) for k, v in module.named_parameters()} == \
        {k: tuple(v.shape) for k, v in params.items()}


def test_port_init_model_has_the_jax_layout(tmp_path):
    spec_t = treg.parse_model_name(str(tmp_path), "small_VGG9_cl_128_128",
                                   (64, 64))
    spec_j = jreg.parse_model_name(str(tmp_path), "small_VGG9_cl_128_128",
                                   (64, 64))
    assert spec_t.path == spec_j.path
    treg.create_init_model(spec_t, 7, max_tasks=3, classes_per_task=5)
    ours = jio.load(spec_t.path)  # the JAX package reads the port's file
    ref = jreg.init_model_state(spec_j, jax.random.PRNGKey(7), 3, 5)
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)
    assert shapes(ours["params"]) == shapes(ref["params"])
    assert np.shape(ours["heads"]["kernel"]) == (3, 128, 5)
    assert ours["meta"] == ref["meta"]
    assert treg.count_parameters(ours) == jreg.count_parameters(ref)
    # kaiming-normal (fan_out) conv init, N(0, 0.01) dense init
    w = ours["params"]["features"]["conv_4"]["kernel"]
    assert abs(w.std() - (2.0 / (9 * 64)) ** 0.5) < 0.01
    assert abs(ours["params"]["trunk"]["fc_0"]["kernel"].std() - 0.01) < 1e-3


def test_pinned_heads_are_bit_identical(monkeypatch):
    scheme = "torch_pinned:100"
    monkeypatch.setattr(jheads, "HEAD_INIT_SCHEME", scheme)
    monkeypatch.setattr(theads, "HEAD_INIT_SCHEME", scheme)
    bank_j = jheads.init_head_bank(jax.random.PRNGKey(0), 3, 16, 5)
    bank_t = theads.init_head_bank(torch.Generator(), 3, 16, 5)
    np.testing.assert_array_equal(bank_t["kernel"].numpy(),
                                  np.asarray(bank_j["kernel"]))
    np.testing.assert_array_equal(bank_t["bias"].numpy(),
                                  np.asarray(bank_j["bias"]))
    zero = {k: (v * 0 if k != "class_counts" else v)
            for k, v in bank_j.items()}
    re_j = jheads.reinit_head(zero, 1, jax.random.PRNGKey(1))
    re_t = theads.reinit_head({**bank_t, "kernel": bank_t["kernel"] * 0,
                               "bias": bank_t["bias"] * 0}, 1,
                              torch.Generator())
    np.testing.assert_array_equal(re_t["kernel"].numpy(),
                                  np.asarray(re_j["kernel"]))


@pytest.mark.parametrize("scheme", ["legacy", "torch_default"])
def test_head_schemes_match_in_distribution(scheme):
    bank = theads.init_head_bank(torch.Generator().manual_seed(0), 4, 256,
                                 50, scheme=scheme)
    k, b = bank["kernel"].numpy(), bank["bias"].numpy()
    if scheme == "legacy":
        assert abs(k.std() - 0.01) < 5e-4 and not b.any()
    else:
        bound = (1.0 / 256) ** 0.5
        assert k.min() >= -bound and k.max() <= bound
        assert abs(k.std() - bound / 3 ** 0.5) < 2e-3


def test_masked_heads_match_jax():
    rng = np.random.default_rng(0)
    kernel = rng.normal(0, 1, (3, 6, 5)).astype(np.float32)
    bias = rng.normal(0, 1, (3, 5)).astype(np.float32)
    counts = np.array([5, 3, 4], np.int32)
    feats = rng.normal(0, 1, (4, 6)).astype(np.float32)
    bj = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias),
          "class_counts": counts}
    bt = {"kernel": torch.from_numpy(kernel), "bias": torch.from_numpy(bias),
          "class_counts": counts}
    ft, fj = torch.from_numpy(feats), jnp.asarray(feats)
    for t in range(3):
        np.testing.assert_allclose(theads.forward(bt, ft, t).numpy(),
                                   np.asarray(jheads.forward(bj, fj, t)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(theads.shared_logits(bt, ft, 3).numpy(),
                               np.asarray(jheads.shared_logits(bj, fj, 3)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ds_name", ["synthetic_2t_4c_32px",
                                     "synthetic_2t_3c_16px_hd200_ts50"])
def test_synthetic_data_is_byte_identical(ds_name):
    seq_t, seq_j = tdata.parse(ds_name), jdata.parse(ds_name)
    assert seq_t.class_count_list() == seq_j.class_count_list()
    for task in (1, 2):
        td_t, td_j = seq_t.get_task_dataset(task), \
            seq_j.get_task_dataset(task)
        for split in ("train", "val", "test"):
            a, b = getattr(td_t, split), getattr(td_j, split)
            assert a.images.tobytes() == b.images.tobytes()
            np.testing.assert_array_equal(a.labels, b.labels)


def test_paths_are_identical():
    jcfg = jconfig.load_config(refresh=True)
    assert tconfig.load_config().tr_results_root_path == \
        jcfg.tr_results_root_path
    args = ("synthetic_2t_4c_32px", "finetuning", "tiny_CNN_cl_32_32",
            "demo", "default")
    assert tpaths.get_train_results_path(*args, task_counter=2,
                                         create=False) == \
        jpaths.get_train_results_path(*args, task_counter=2, create=False)
    assert tpaths.get_starting_model_path("d", "m", "e=1") == \
        jpaths.get_starting_model_path("d", "m", "e=1")
    assert tpaths.lr_dirname(5e-3) == jpaths.lr_dirname(5e-3)
    assert tpaths.SUCCESS_FLAG == jpaths.SUCCESS_FLAG


def test_io_files_load_in_either_package(tmp_path):
    obj = {"params": {"a": torch.arange(6.0).view(2, 3)},
           "meta": {"epoch": 3, "val_acc": 0.5},
           "bf16": torch.ones(2, dtype=torch.bfloat16)}
    path = str(tmp_path / "port.pth.tar")
    tio.save(obj, path)
    back = jio.load(path)
    np.testing.assert_array_equal(back["params"]["a"],
                                  np.arange(6.0).reshape(2, 3))
    assert back["bf16"].dtype == np.float32
    jpath = str(tmp_path / "jax.pth.tar")
    jio.save({"x": jnp.ones(3), "meta": {"k": 1}}, jpath)
    assert tio.load(jpath)["meta"] == {"k": 1}
    zpath = str(tmp_path / "zip.pth")
    torch.save({"seq_res": [1.0, 2.0]}, zpath)  # torch.save zip format
    assert tio.load(zpath) == {"seq_res": [1.0, 2.0]}


@pytest.mark.parametrize("name", ["small_VGG9_cl_128_128_BN",
                                  "small_VGG9_cl_128_128_DROP", "alexnet"])
def test_unported_models_raise(tmp_path, name):
    """The models that once raised, naming their ROADMAP item, now build:
    the ``_BN`` and ``_DROP`` variants (at 32 px) and AlexNet (at 96 px,
    a 2x2 final map): the init pickle loads in the JAX package and gives,
    under the JAX backbone, the port's eval features (rtol 1e-4, atol
    1e-5)."""
    px = 96 if name == "alexnet" else 32
    spec_t = treg.parse_model_name(str(tmp_path), name, (px, px))
    spec_j = jreg.parse_model_name(str(tmp_path), name, (px, px))
    assert (spec_t.batch_norm, spec_t.dropout) == \
        (spec_j.batch_norm, spec_j.dropout) == \
        (name.endswith("_BN"), name.endswith("_DROP"))
    treg.create_init_model(spec_t, 7, max_tasks=2, classes_per_task=4)
    model = jio.load(spec_t.path)
    x = np.random.default_rng(0).normal(0, 1, (4, px, px, 3)).astype(
        np.float32)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray,
                                                  model["params"])}
    if spec_j.has_batch_stats:
        variables["batch_stats"] = jax.tree_util.tree_map(
            jnp.asarray, model["batch_stats"])
    want = spec_j.make_backbone().apply(variables, jnp.asarray(x),
                                        train=False)
    params = convert.params_from_jax(model["params"])
    assert convert.params_to_jax(params).keys() == model["params"].keys()
    with torch.no_grad():
        got = torch.func.functional_call(
            spec_t.make_backbone(), params, (torch.from_numpy(x),),
            {"batch_stats": convert.batch_stats_from_jax(
                model["batch_stats"])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
