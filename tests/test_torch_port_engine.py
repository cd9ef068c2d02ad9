"""clsurvey_torch's engine against clsurvey_tpu's on the CPU, from shared
numpy-made states and inputs (tiny_CNN at 32 px, batch a multiple of 8 so
the JAX package's batch rounding on its 8-device test mesh never applies).

- one ``_train_step``: params and momentum within atol 1e-5 (float32, sums
  in another order), under plain, L2, L1 and freeze settings;
- a 3-epoch ``train_task`` with the JAX package's permutations handed in
  and ``augment=False``: per-epoch train loss within 1e-3 relative, val
  accuracy within one val sample;
- ``evaluate``: the same accuracy and per-class counters."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.data import registry as tdata
from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.methods.base import UpdateRule as TRule
from clsurvey_torch.models import convert as tconvert, registry as treg
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


def _leaves_equal(got, want, where: str = "") -> None:
    """Two host trees (dicts, lists, numpy arrays, Python scalars) with the
    same structure and bit-equal leaves."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _leaves_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _leaves_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


def _jax_orbax_checkpoint(tmp_path, name, jrule, trtrule, hyper, epochs,
                          init_kw=None, model=None):
    """The JAX engine trains task 1 of synthetic_2t_4c_32px for ``epochs``
    epochs with ``jrule`` (its ``init_state`` given ``init_kw``), a resume
    checkpoint every epoch: where orbax is importable it leaves
    ``epoch.pth.tar`` with its trees in ``epoch.pth.tar.orbax``. Returns
    (task data, the port's context with ``trtrule``, the init model, JAX-made
    unless ``model`` is given, the job's keyword arguments)."""
    spec_j = jreg.parse_model_name("", name, (PX, PX))
    spec_t = treg.parse_model_name("", name, (PX, PX))
    if model is None:
        model = jio.to_host(jreg.init_model_state(
            spec_j, jax.random.PRNGKey(3), max_tasks=2, classes_per_task=4))
    common = dict(task=0, n_tasks=1, class_counts=[4, 4], mean=MEAN,
                  std=STD, augment=False)
    ctx_j = jtrain.make_context(spec_j, update_rule=jrule, mesh=None,
                                **common)
    ctx_t = ttrain.make_context(spec_t, update_rule=trtrule, device="cpu",
                                **common)
    td = tdata.parse("synthetic_2t_4c_32px").get_task_dataset(1)
    trainable = _jax_trainable({"params": model["params"],
                                "heads": {k: model["heads"][k]
                                          for k in ("kernel", "bias")}})
    state_j = jtrain.TrainState(
        trainable, _jax_trainable(model.get("batch_stats", {})),
        jtrain.tree_zeros_like(trainable),
        jrule.init_state(trainable, hyper, ctx_j, **(init_kw or {})))
    job = dict(exp_dir=str(tmp_path), batch_size=32, lr=1e-2, saving_freq=1)
    jtrain.train_task(jtrain.Engine(ctx_j),
                      jtrain.TrainJob(num_epochs=epochs, **job), state_j, td,
                      log=lambda *_: None)
    return td, ctx_t, model, job


def _resumes_from_orbax(tmp_path, name, jrule, trule, hyper):
    """The JAX engine stops after 2 of 3 epochs, leaving an Orbax resume
    directory; the port reads it to the trees that the JAX package's
    ``orbax_io.load`` gives, leaf for leaf, builds its state from them
    exactly, and its ``train_task`` finishes the last epoch. Returns the
    resumed and the final state."""
    from clsurvey_torch.utils import orbax_io as torbax
    from clsurvey_tpu.utils import orbax_io as jorbax

    if not jorbax.available():
        pytest.skip("orbax is not installed: the JAX engine writes a "
                    "plain pickle")
    td, ctx_t, model, job = _jax_orbax_checkpoint(tmp_path, name, jrule,
                                                  trule, hyper, epochs=2)
    ckpt = str(tmp_path / "epoch.pth.tar")
    ck = jio.load(ckpt)
    assert ck["epoch"] == 1 and os.path.isdir(ck["orbax_state"])
    assert "trainable" not in ck
    want = jorbax.load(ck["orbax_state"])
    _leaves_equal(torbax.load(ck["orbax_state"]), want)
    _, resumed = ttrain._load_resume(ckpt, "cpu", trule)
    _leaves_equal(ttrain.trainable_to_host(resumed.trainable),
                  want["trainable"])
    _leaves_equal(ttrain.trainable_to_host(resumed.momentum),
                  want["momentum"])
    _leaves_equal(tconvert.batch_stats_to_jax(resumed.batch_stats),
                  want["batch_stats"])
    _leaves_equal(tio.to_host(trule.mstate_to_jax(resumed.mstate)),
                  want["mstate"])

    lines = []
    state = ttrain.state_from_model(model, None, "cpu")
    state.mstate = trule.init_state(state.trainable, hyper, ctx_t)
    _, _, final = ttrain.train_task(
        ttrain.Engine(ctx_t), ttrain.TrainJob(num_epochs=3, **job), state,
        td, log=lines.append)
    assert any("resumed epoch 2" in line for line in lines)
    after = jio.load(ckpt)  # the port writes a plain pickle
    assert after["epoch"] == 2 and "orbax_state" not in after
    with open(tmp_path / "error_history.json") as f:
        assert len(json.load(f)["error_history"]) == 3
    return resumed, final


def test_resume_checkpoint_round_trip(shared_model, tmp_path):
    """A port-written epoch checkpoint (JAX layout, plain pickle) resumes
    to the same state, and so does one the JAX engine wrote through
    Orbax."""
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
    _resumes_from_orbax(tmp_path / "orbax", NAME, JRule(), TRule(), {})


def test_resume_si_with_batch_stats_from_orbax(tmp_path):
    """SI's method state (nested dicts: the hyperparameter scalars and
    three params-shaped trees, which the port keeps in its own layout) and
    a batch-norm model's statistics, resumed from the JAX engine's Orbax
    directory; the port's own checkpoint of the finished epoch holds them
    in the JAX layout again."""
    from clsurvey_torch.methods.reg_based import SIRule as TSIRule
    from clsurvey_tpu.methods.reg_based import SIRule as JSIRule

    resumed, final = _resumes_from_orbax(
        tmp_path, NAME + "_BN", JSIRule(), TSIRule(), {"lambda": 0.5})
    assert set(resumed.mstate) == {"hyper", "omega", "theta_star", "w"}
    assert set(resumed.mstate["w"]) == set(resumed.trainable["params"])
    assert bool(resumed.mstate["w"]["features.conv_0.weight"].abs().sum())
    assert resumed.batch_stats and all(
        bool(torch.isfinite(v).all()) for v in final.batch_stats.values())
    ck = jio.load(str(tmp_path / "epoch.pth.tar"))
    assert set(ck["mstate"]["w"]) == set(ck["trainable"]["params"])


RULES = ["LwFRule", "EBLLRule", "PackNetRule", "GEMRule", "ReplayRule",
         "ICarlRule"]


def _rule_case(rule_name, model):
    """(JAX rule, port rule, hyperparameters, the JAX rule's init_state
    keywords, the port rule's) for one of the six rules whose method state
    holds more than trees shaped like the weights: LwF's and EBLL's teacher
    (EBLL with one autoencoder), PackNet's uint8 masks of task 1, the
    memory of GEM and of a replay baseline, iCaRL's exemplar store (filled
    with random rows, so a mis-laid leaf shows)."""
    from clsurvey_torch.methods import ebll as tebll, lwf as tlwf, \
        packnet as tpacknet, rehearsal as treh
    from clsurvey_tpu.methods import ebll as jebll, lwf as jlwf, \
        packnet as jpacknet, rehearsal as jreh
    from clsurvey_tpu.ops import masks as jmasks

    rng = np.random.default_rng(11)
    spec_j = jreg.parse_model_name("", NAME, (PX, PX))
    if rule_name == "LwFRule":
        kw = {"prev_model": model}
        return jlwf.LwFRule(), tlwf.LwFRule(), {"lambda": 0.5}, kw, kw
    if rule_name == "EBLLRule":
        flat = (PX // 4) ** 2 * 16  # tiny_CNN's conv output, 8x8x16
        ae = {"enc": {"kernel": rng.normal(0, .1, (flat, 8)).astype(
            np.float32), "bias": np.zeros(8, np.float32)},
              "dec": {"kernel": rng.normal(0, .1, (8, flat)).astype(
                  np.float32), "bias": np.zeros(flat, np.float32)}}
        kw = {"prev_model": model, "encoders": [ae]}
        return (jebll.EBLLRule(spec_j), tebll.EBLLRule(),
                {"reg_lambda": 0.5, "ebll_reg_alpha": 0.1}, kw, kw)
    if rule_name == "PackNetRule":
        masks = jmasks.claim_free(jmasks.init_masks(
            _jax_trainable(model["params"])), 1)
        return (jpacknet.PackNetRule(task_id=1),
                tpacknet.PackNetRule(task_id=1), {}, {"masks": masks},
                {"masks": tconvert.params_from_jax(jio.to_host(masks),
                                                   dtype=None)})
    if rule_name == "GEMRule":
        return (jreh.GEMRule(n_memories=8), treh.GEMRule(n_memories=8),
                {"margin": 0.5}, {}, {})
    if rule_name == "ReplayRule":
        return (jreh.ReplayRule(n_memories=8, n_append=4),
                treh.ReplayRule(n_memories=8, n_append=4), {}, {}, {})
    ex = {"images": rng.integers(0, 256, (8, PX, PX, 3), dtype=np.uint8),
          "targets": rng.normal(0, 1, (8, 8)).astype(np.float32),
          "labels": rng.integers(0, 4, 8).astype(np.int32),
          "task_ids": np.zeros(8, np.int32), "count": np.int32(5)}
    return (jreh.ICarlRule(n_append=4), treh.ICarlRule(n_append=4),
            {"lambda": 1.0}, {"exemplars": _jax_trainable(ex)},
            {"exemplars": ex})


def _same_layout(got, want, where: str = "") -> None:
    """Two host trees with the same structure, and leaves of the same
    dtype and shape (the values may differ)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _same_layout(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_layout(g, w, f"{where}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (where, g.dtype,
                                                          w.dtype)


def _jax_written_resumes(tmp_path, rule_name):
    """The JAX engine trains 1 epoch with the rule and leaves its epoch
    checkpoint; the port resumes it to the JAX state leaf for leaf (its
    ``mstate_to_jax`` gives back exactly the JAX tree) and trains the
    second epoch, writing a JAX-layout file of its own."""
    spec_j = jreg.parse_model_name("", NAME, (PX, PX))
    model = jio.to_host(jreg.init_model_state(
        spec_j, jax.random.PRNGKey(3), max_tasks=2, classes_per_task=4))
    jrule, trule, hyper, jkw, tkw = _rule_case(rule_name, model)
    td, ctx_t, _, job = _jax_orbax_checkpoint(
        tmp_path, NAME, jrule, trule, hyper, epochs=1, init_kw=jkw,
        model=model)
    ckpt = str(tmp_path / "epoch.pth.tar")
    ck = jio.load(ckpt)
    if ck.get("orbax_state"):
        from clsurvey_tpu.utils import orbax_io as jorbax
        want = jorbax.load(ck["orbax_state"])
    else:
        want = ck
    _, resumed = ttrain._load_resume(ckpt, "cpu", trule)
    _leaves_equal(tio.to_host(trule.mstate_to_jax(resumed.mstate)),
                  jio.to_host(want["mstate"]))
    _leaves_equal(ttrain.trainable_to_host(resumed.trainable),
                  want["trainable"])

    lines = []
    state = ttrain.state_from_model(model, None, "cpu")
    state.mstate = trule.init_state(state.trainable, hyper, ctx_t, **tkw)
    ttrain.train_task(ttrain.Engine(ctx_t),
                      ttrain.TrainJob(num_epochs=2, **job), state, td,
                      log=lines.append)
    assert any("resumed epoch 1" in line for line in lines)
    after = jio.load(ckpt)
    assert after["epoch"] == 1 and "orbax_state" not in after
    _same_layout(after["mstate"], want["mstate"])
    return ck


@pytest.mark.parametrize("rule_name", RULES)
def test_orbax_resume_of_an_unconverted_method_state_raises(tmp_path,
                                                            rule_name):
    """These six rules' method states once had no conversion from the JAX
    layout, and a JAX-written Orbax epoch checkpoint of theirs raised. Each
    now resumes it: the port reads the Orbax directory to the JAX engine's
    method state, leaf for leaf, and finishes the task."""
    from clsurvey_tpu.utils import orbax_io as jorbax

    if not jorbax.available():
        pytest.skip("orbax is not installed: the JAX engine writes a "
                    "plain pickle")
    ck = _jax_written_resumes(tmp_path, rule_name)
    assert os.path.isdir(ck["orbax_state"]) and "mstate" not in ck


@pytest.mark.parametrize("rule_name", RULES)
def test_resume_jax_plain_pickle_epoch_file(tmp_path, monkeypatch,
                                            rule_name):
    """Where orbax is not importable the JAX engine writes the trees into
    the epoch pickle itself; the port resumes that file to the JAX state
    too (it once handed the JAX-layout tree straight to the rule)."""
    from clsurvey_tpu.utils import orbax_io as jorbax

    monkeypatch.setattr(jorbax, "available", lambda: False)
    ck = _jax_written_resumes(tmp_path, rule_name)
    assert "orbax_state" not in ck and "mstate" in ck


@pytest.mark.parametrize("rule_name", RULES)
def test_jax_engine_resumes_the_ports_epoch_file(tmp_path, rule_name):
    """The port trains 1 epoch with the rule; its epoch checkpoint holds the
    method state in the layout of the JAX rule's own ``init_state`` (dtypes
    and shapes included), and the JAX engine resumes it and trains the
    second epoch."""
    spec_j = jreg.parse_model_name("", NAME, (PX, PX))
    spec_t = treg.parse_model_name("", NAME, (PX, PX))
    model = jio.to_host(jreg.init_model_state(
        spec_j, jax.random.PRNGKey(3), max_tasks=2, classes_per_task=4))
    jrule, trule, hyper, jkw, tkw = _rule_case(rule_name, model)
    common = dict(task=0, n_tasks=1, class_counts=[4, 4], mean=MEAN,
                  std=STD, augment=False)
    ctx_t = ttrain.make_context(spec_t, update_rule=trule, device="cpu",
                                **common)
    ctx_j = jtrain.make_context(spec_j, update_rule=jrule, mesh=None,
                                **common)
    td = tdata.parse("synthetic_2t_4c_32px").get_task_dataset(1)
    job = dict(exp_dir=str(tmp_path), batch_size=32, lr=1e-2, saving_freq=1)
    state = ttrain.state_from_model(model, None, "cpu")
    state.mstate = trule.init_state(state.trainable, hyper, ctx_t, **tkw)
    ttrain.train_task(ttrain.Engine(ctx_t),
                      ttrain.TrainJob(num_epochs=1, **job), state, td,
                      log=lambda *_: None)
    written = jio.load(str(tmp_path / "epoch.pth.tar"))["mstate"]

    trainable = _jax_trainable({"params": model["params"],
                                "heads": {k: model["heads"][k]
                                          for k in ("kernel", "bias")}})
    jinit = jrule.init_state(trainable, hyper, ctx_j, **jkw)
    _same_layout(written, jio.to_host(jinit))
    lines = []
    _, _, final = jtrain.train_task(
        jtrain.Engine(ctx_j), jtrain.TrainJob(num_epochs=2, **job),
        jtrain.TrainState(trainable, {}, jtrain.tree_zeros_like(trainable),
                          jinit), td, log=lines.append)
    assert any("resumed epoch 1" in line for line in lines)
    _same_layout(jio.to_host(final.mstate), jio.to_host(jinit))
    with open(tmp_path / "error_history.json") as f:
        assert len(json.load(f)["error_history"]) == 2


@pytest.mark.parametrize("rule_name", RULES)
def test_resume_epoch_file_in_the_ports_older_layout(shared_model, tmp_path,
                                                     rule_name):
    """Epoch checkpoints of earlier port versions hold these rules' method
    states in the port's own layout (flat torch names, host ints); they
    still resume, to the same tensors and ints."""
    _, trule, hyper, _, tkw = _rule_case(rule_name, shared_model)
    _, ctx_t = _contexts()
    state = ttrain.state_from_model(shared_model, None, "cpu")
    mstate = trule.init_state(state.trainable, hyper, ctx_t, **tkw)
    gen = torch.Generator().manual_seed(0)
    if "memory" in mstate:  # a filled memory, its ring position at 3
        mem = mstate["memory"]
        mem["mem_images"].copy_(torch.randint(
            0, 256, mem["mem_images"].shape, generator=gen))
        mem["mem_count"].fill_(3)
        mem["mem_cnt"] = 3
    old = tio.to_host(mstate)
    tio.save({"epoch": 0, "lr": 1e-2, "best_acc": 0.0, "val_beat_counts": 0,
              "trainable": ttrain.trainable_to_host(state.trainable),
              "batch_stats": {},
              "momentum": ttrain.trainable_to_host(state.momentum),
              "mstate": old}, str(tmp_path / "epoch.pth.tar"))
    _, resumed = ttrain._load_resume(str(tmp_path / "epoch.pth.tar"), "cpu",
                                     trule)
    _leaves_equal(tio.to_host(resumed.mstate), old)
    _same_layout(tio.to_host(trule.mstate_to_jax(resumed.mstate)),
                 tio.to_host(trule.mstate_to_jax(mstate)))


@pytest.mark.parametrize("fmt", ["pickle", "orbax"])
def test_resume_refuses_a_rule_without_conversion(tmp_path, fmt):
    """A rule with method state of its own but no ``mstate_from_jax`` is
    refused, Orbax pointer or plain pickle, with an error that names it,
    rather than handed a tree it would mis-read."""
    class StubRule(TRule):
        def init_state(self, trainable, hyperparams, ctx):
            return {**super().init_state(trainable, hyperparams, ctx),
                    "extra": torch.zeros(3)}

    ck = {"epoch": 0, "lr": 1e-2, "best_acc": 0.0, "val_beat_counts": 0}
    if fmt == "orbax":
        ck["orbax_state"] = str(tmp_path / "epoch.pth.tar.orbax")
    else:
        ck.update(trainable={}, batch_stats={}, momentum={},
                  mstate={"hyper": {}, "extra": np.zeros(3, np.float32)})
    tio.save(ck, str(tmp_path / "epoch.pth.tar"))
    with pytest.raises(RuntimeError, match="StubRule.*no conversion"):
        ttrain._load_resume(str(tmp_path / "epoch.pth.tar"), "cpu",
                            StubRule())


def test_resume_si_epoch_file_in_the_ports_own_layout(shared_model,
                                                      tmp_path):
    """SI's epoch checkpoints written by earlier port versions hold
    omega / theta_star / w in the port's flat layout; they still resume,
    to the same tensors."""
    from clsurvey_torch.methods.reg_based import SIRule as TSIRule

    _, ctx_t = _contexts()
    state = ttrain.state_from_model(shared_model, None, "cpu")
    rule = TSIRule()
    mstate = rule.init_state(state.trainable, {"lambda": 0.5}, ctx_t)
    gen = torch.Generator().manual_seed(0)
    for k in TSIRule.PARAM_TREES:
        mstate[k] = {n: torch.randn(t.shape, generator=gen)
                     for n, t in mstate[k].items()}
    tio.save({"epoch": 0, "lr": 1e-2, "best_acc": 0.0, "val_beat_counts": 0,
              "trainable": ttrain.trainable_to_host(state.trainable),
              "batch_stats": {},
              "momentum": ttrain.trainable_to_host(state.momentum),
              "mstate": tio.to_host(mstate)},
             str(tmp_path / "epoch.pth.tar"))
    _, resumed = ttrain._load_resume(str(tmp_path / "epoch.pth.tar"), "cpu",
                                     rule)
    for k in TSIRule.PARAM_TREES:
        assert set(resumed.mstate[k]) == set(mstate[k])
        for n, t in mstate[k].items():
            assert torch.equal(resumed.mstate[k][n], t), (k, n)
    assert float(resumed.mstate["hyper"]["lambda"]) == 0.5


def test_orbax_resume_without_tensorstore_names_it(tmp_path, monkeypatch):
    """Where tensorstore is not importable, an Orbax-pointing epoch
    checkpoint raises, and the message says what is missing."""
    tio.save({"epoch": 0, "lr": 1e-2, "best_acc": 0.0, "val_beat_counts": 0,
              "orbax_state": str(tmp_path / "epoch.pth.tar.orbax")},
             str(tmp_path / "epoch.pth.tar"))
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(RuntimeError, match="tensorstore"):
        ttrain._load_resume(str(tmp_path / "epoch.pth.tar"), "cpu")
