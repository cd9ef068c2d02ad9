"""clsurvey_torch's engine against clsurvey_tpu's on the CPU, from shared
numpy-made states and inputs (tiny_CNN at 32 px, batch a multiple of 8 so
the JAX package's batch rounding on its 8-device test mesh never applies).

- one ``_train_step``: params and momentum within atol 1e-5 (float32, sums
  in another order), under plain, L2, L1 and freeze settings;
- a 3-epoch ``train_task`` with the JAX package's permutations handed in
  and ``augment=False``: per-epoch train loss within 1e-3 relative, val
  accuracy within one val sample;
- ``evaluate``: the same accuracy and per-class counters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.data import registry as tdata
from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.methods.base import UpdateRule as TRule
from clsurvey_torch.models import registry as treg
from clsurvey_torch.utils import config as tconfig, io as tio
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.methods.base import UpdateRule as JRule
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.utils import io as jio

NAME, PX = "tiny_CNN_cl_32_32", 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture(autouse=True)
def port_config():
    tconfig.set_config(None)
    yield tconfig.load_config(refresh=True)
    tconfig.set_config(None)


@pytest.fixture(scope="module")
def shared_model():
    """A JAX-made init model (numpy), max_tasks 2 x 4 classes."""
    spec = jreg.parse_model_name("", NAME, (PX, PX))
    return jio.to_host(jreg.init_model_state(
        spec, jax.random.PRNGKey(3), max_tasks=2, classes_per_task=4))


def _contexts(**kw):
    spec_j = jreg.parse_model_name("", NAME, (PX, PX))
    spec_t = treg.parse_model_name("", NAME, (PX, PX))
    common = dict(task=0, n_tasks=1, class_counts=[4, 4], mean=MEAN,
                  std=STD, augment=False, **kw)
    ctx_j = jtrain.make_context(spec_j, update_rule=JRule(), mesh=None,
                                **common)
    ctx_t = ttrain.make_context(spec_t, update_rule=TRule(), device="cpu",
                                **common)
    return ctx_j, ctx_t


def _jax_trainable(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def _assert_trees_close(port_tree, jax_tree, atol):
    flat = jax.tree_util.tree_flatten_with_path(jio.to_host(jax_tree))[0]
    for key_path, want in flat:
        got = port_tree
        for k in key_path:
            got = got[k.key]
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(key_path))


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 1e-2},
                                {"weight_decay": 1e-2, "l1_decay": True},
                                {"freeze_backbone": True}],
                         ids=["plain", "l2", "l1", "freeze"])
def test_one_train_step_matches(shared_model, kw):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (16, PX, PX, 3), dtype=np.uint8)
    y = rng.integers(0, 4, (16,)).astype(np.int32)
    trainable = {"params": shared_model["params"],
                 "heads": {k: shared_model["heads"][k]
                           for k in ("kernel", "bias")}}
    # a nonzero starting momentum, so buf = m*buf + g is exercised
    momentum = jax.tree_util.tree_map(
        lambda a: (rng.normal(0, 1e-2, np.shape(a))).astype(np.float32),
        trainable)
    lr = 0.05
    ctx_j, ctx_t = _contexts(**kw)

    state_j = jtrain.TrainState(_jax_trainable(trainable), {},
                                _jax_trainable(momentum),
                                JRule().init_state(None, {}, ctx_j))
    new_j, m_j = jtrain.Engine(ctx_j)._train_step(
        state_j, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0),
        jnp.float32(lr))

    state_t = ttrain.TrainState(
        ttrain.trainable_from_host(trainable, "cpu", requires_grad=True),
        {}, ttrain.trainable_from_host(momentum, "cpu",
                                       requires_grad=False),
        TRule().init_state(None, {}, ctx_t))
    new_t, m_t = ttrain.Engine(ctx_t)._train_step(
        state_t, torch.from_numpy(x), torch.from_numpy(y).long(), lr)

    _assert_trees_close(ttrain.trainable_to_host(new_t.trainable),
                        new_j.trainable, atol=1e-5)
    _assert_trees_close(ttrain.trainable_to_host(new_t.momentum),
                        new_j.momentum, atol=1e-5)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    assert float(m_t["acc"]) == float(m_j["acc"])


def _record(engine, name, out):
    fn = getattr(engine, name)

    def wrapped(*a, **k):
        res = fn(*a, **k)
        out.append(float(res[1]["loss"]) if name == "train_epoch"
                   else res[0])
        return res

    setattr(engine, name, wrapped)


def test_three_epoch_train_task_matches(shared_model, tmp_path):
    td = tdata.parse("synthetic_2t_4c_32px").get_task_dataset(1)
    n_train, n_val = td.train.size, td.val.size
    seed, epochs = 5, 3
    ctx_j, ctx_t = _contexts()

    # the JAX package's epoch permutations, handed to the port
    def jax_perm(epoch):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
        return np.asarray(jax.random.permutation(
            jax.random.split(key)[0], n_train))

    trainable = {"params": shared_model["params"],
                 "heads": {k: shared_model["heads"][k]
                           for k in ("kernel", "bias")}}
    # a small lr keeps the losses well above zero, where 1e-3 relative
    # is a meaningful bound
    job = dict(num_epochs=epochs, batch_size=32, lr=1e-3, seed=seed)

    eng_j, log_j = jtrain.Engine(ctx_j), {"loss": [], "acc": []}
    _record(eng_j, "train_epoch", log_j["loss"])
    _record(eng_j, "evaluate", log_j["acc"])
    state_j = jtrain.TrainState(_jax_trainable(trainable), {},
                                jtrain.tree_zeros_like(
                                    _jax_trainable(trainable)),
                                JRule().init_state(None, {}, ctx_j))
    best_j, acc_j, _ = jtrain.train_task(
        eng_j, jtrain.TrainJob(exp_dir=str(tmp_path / "jax"), **job),
        state_j, td, log=lambda *_: None)

    eng_t, log_t = ttrain.Engine(ctx_t), {"loss": [], "acc": []}
    _record(eng_t, "train_epoch", log_t["loss"])
    _record(eng_t, "evaluate", log_t["acc"])
    state_t = ttrain.state_from_model(shared_model, None, "cpu")
    state_t.mstate = TRule().init_state(None, {}, ctx_t)
    best_t, acc_t, _ = ttrain.train_task(
        eng_t, ttrain.TrainJob(exp_dir=str(tmp_path / "port"), **job),
        state_t, td, log=lambda *_: None, perms=jax_perm)

    assert len(log_t["loss"]) == len(log_j["loss"]) == epochs
    np.testing.assert_allclose(log_t["loss"], log_j["loss"], rtol=1e-3)
    np.testing.assert_allclose(log_t["acc"], log_j["acc"], rtol=0,
                               atol=1.0 / n_val + 1e-9)
    assert abs(acc_t - acc_j) <= 1.0 / n_val + 1e-9
    # both best models are JAX-layout files the other package reads
    on_disk = jio.load(str(tmp_path / "port" / "best_model.pth.tar"))
    assert on_disk["meta"]["epoch"] == best_t["meta"]["epoch"]
    assert set(on_disk) == set(best_j) - {"method_aux"}
    assert tio.load(str(tmp_path / "jax" / "best_model.pth.tar"))[
        "meta"]["val_acc"] == acc_j


def test_evaluate_matches(shared_model):
    td = tdata.parse("synthetic_2t_4c_32px").get_task_dataset(2)
    ctx_j, ctx_t = _contexts()
    trainable = {"params": shared_model["params"],
                 "heads": {k: shared_model["heads"][k]
                           for k in ("kernel", "bias")}}
    acc_j, pcc_j, pct_j = jtrain.Engine(ctx_j).evaluate(
        _jax_trainable(trainable), {}, jnp.asarray(td.val.images),
        jnp.asarray(td.val.labels), 48)
    acc_t, pcc_t, pct_t = ttrain.Engine(ctx_t).evaluate(
        ttrain.trainable_from_host(trainable, "cpu", requires_grad=False),
        {}, torch.from_numpy(td.val.images), td.val.labels, 48)
    assert acc_t == acc_j
    np.testing.assert_array_equal(pcc_t, pcc_j)
    np.testing.assert_array_equal(pct_t, pct_j)


def test_resume_checkpoint_round_trip(shared_model, tmp_path):
    """A port-written epoch checkpoint (JAX layout, plain pickle) resumes
    to the same state, and an Orbax-pointing one raises clearly."""
    td = tdata.parse("synthetic_2t_4c_32px").get_task_dataset(1)
    _, ctx_t = _contexts()
    engine = ttrain.Engine(ctx_t)
    job = ttrain.TrainJob(exp_dir=str(tmp_path), num_epochs=2,
                          batch_size=32, lr=1e-2, saving_freq=1)
    state = ttrain.state_from_model(shared_model, {"hyper": {}}, "cpu")
    _, _, final = ttrain.train_task(engine, job, state, td,
                                    log=lambda *_: None)
    ck = jio.load(str(tmp_path / "epoch.pth.tar"))
    assert ck["epoch"] == 1 and set(ck["trainable"]) == {"params", "heads"}
    _, resumed = ttrain._load_resume(str(tmp_path / "epoch.pth.tar"), "cpu")
    _assert_trees_close(ttrain.trainable_to_host(resumed.momentum),
                        ttrain.trainable_to_host(final.momentum), atol=0)
    tio.save({**ck, "orbax_state": "elsewhere"},
             str(tmp_path / "epoch.pth.tar"))
    with pytest.raises(RuntimeError, match="Orbax"):
        ttrain.train_task(engine, job, state, td, log=lambda *_: None)
