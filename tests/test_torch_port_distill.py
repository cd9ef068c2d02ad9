"""clsurvey_torch's distillation losses and LwF against clsurvey_tpu's on the
CPU (float32, numpy-made inputs).

- ``lwf_distill``, ``lwf_distill_multi`` (one head's invalid slots masked to
  -1e10) and ``icarl_distill`` (masked rows): values within rtol 1e-5 and
  gradients within rtol 1e-4 / atol 1e-7;
- one ``LwFRule`` train step at task 3 (two previous heads, a teacher that
  differs from the student), on the plain and on the batch-norm tiny_CNN:
  params and momentum within atol 1e-5 (2e-5 with batch-norm), and the step
  differs from a lambda-0 step;
- the LWF CLI on the CPU, two tasks, two epochs, with and without the
  head warm-up: decay state, SUCCESS token, best model, result dicts; the
  warm-up leaves the backbone untouched and its head is kept."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.framework import main as tmain
from clsurvey_torch.methods import lwf as tlwf
from clsurvey_torch.models import convert, registry as treg
from clsurvey_torch.ops import distill as tdistill
from clsurvey_torch.utils import config as tconfig, io as tio, paths as tpaths
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.methods import lwf as jlwf
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.ops import distill as jdistill
from clsurvey_tpu.utils import io as jio

PX = 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture(autouse=True)
def port_config():
    tconfig.set_config(None)
    yield tconfig.load_config(refresh=True)
    tconfig.set_config(None)


@pytest.mark.parametrize("fn", ["lwf_distill", "lwf_distill_multi",
                                "icarl_distill"])
def test_distillation_values_and_gradients_match(fn):
    rng = np.random.default_rng(0)
    shape = (6, 3, 5) if fn == "lwf_distill_multi" else (6, 5)
    s = rng.normal(0, 2, shape).astype(np.float32)
    t = rng.normal(0, 2, shape).astype(np.float32)
    if fn == "lwf_distill_multi":  # the second head has 3 valid classes
        s[:, 1, 3:] = t[:, 1, 3:] = -1e10
    if fn == "icarl_distill":  # rows restricted to one task's class region
        s[:3, 3:] = t[:3, 3:] = -1e10
    want, want_grad = jax.value_and_grad(getattr(jdistill, fn))(
        jnp.asarray(s), jnp.asarray(t), 2.0)
    st = torch.tensor(s, requires_grad=True)
    got = getattr(tdistill, fn)(st, torch.tensor(t), 2.0)
    got.backward()
    assert got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=1e-7)
    assert np.isfinite(st.grad.numpy()).all()


def _models(name):
    """A JAX-made student init and a teacher that differs from it in every
    weight, head and running statistic (numpy)."""
    spec = jreg.parse_model_name("", name, (PX, PX))
    student = jio.to_host(jreg.init_model_state(
        spec, jax.random.PRNGKey(3), max_tasks=3, classes_per_task=4,
        class_counts=[4, 3, 4]))
    teacher = jio.to_host(jreg.init_model_state(
        spec, jax.random.PRNGKey(4), max_tasks=3, classes_per_task=4,
        class_counts=[4, 3, 4]))
    rng = np.random.default_rng(1)
    for model in (student, teacher):
        for st in model["batch_stats"].get("features", {}).values():
            st["mean"] = rng.normal(0, 0.2, st["mean"].shape).astype(
                np.float32)
            st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(
                np.float32)
    return student, teacher


def _jnp(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def _trainable(model):
    return {"params": model["params"],
            "heads": {k: model["heads"][k] for k in ("kernel", "bias")}}


def _assert_trees_close(port_tree, jax_tree, atol):
    for key_path, want in jax.tree_util.tree_flatten_with_path(
            jio.to_host(jax_tree))[0]:
        got = port_tree
        for k in key_path:
            got = got[k.key]
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(key_path))


def lwf_style_steps(name, rule_j, rule_t, hyper, init_kw_j, init_kw_t,
                    lr=0.05):
    """One train step of a teacher-carrying rule in both packages at task 3
    (n_tasks 3), from one numpy-made state; returns both new states (the
    JAX one is None when ``rule_j`` is)."""
    student, teacher = _models(name)
    common = dict(task=2, n_tasks=3, class_counts=[4, 3, 4], mean=MEAN,
                  std=STD, augment=False)
    ctx_j = rule_j and jtrain.make_context(
        jreg.parse_model_name("", name, (PX, PX)), update_rule=rule_j,
        mesh=None, **common)
    ctx_t = ttrain.make_context(treg.parse_model_name("", name, (PX, PX)),
                                update_rule=rule_t, device="cpu", **common)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (16, PX, PX, 3), dtype=np.uint8)
    y = rng.integers(0, 4, (16,)).astype(np.int32)
    tr = _trainable(student)

    new_j = m_j = None
    if rule_j is not None:
        st_j = jtrain.TrainState(
            _jnp(tr), _jnp(student["batch_stats"]),
            jtrain.tree_zeros_like(_jnp(tr)),
            rule_j.init_state(_jnp(tr), hyper, ctx_j, prev_model=teacher,
                              **init_kw_j))
        new_j, m_j = jax.jit(jtrain.Engine(ctx_j)._train_step)(
            st_j, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0),
            jnp.float32(lr))

    tr_t = ttrain.trainable_from_host(tr, "cpu", requires_grad=True)
    st_t = ttrain.TrainState(
        tr_t, convert.batch_stats_from_jax(student["batch_stats"]),
        ttrain.tree_zeros_like(tr_t),
        rule_t.init_state(tr_t, hyper, ctx_t, prev_model=teacher,
                          **init_kw_t))
    new_t, m_t = ttrain.Engine(ctx_t)._train_step(
        st_t, torch.from_numpy(x), torch.from_numpy(y).long(), lr)
    if m_j is not None:
        np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                                   rtol=1e-5)
    return new_j, new_t


@pytest.mark.parametrize("name,atol", [("tiny_CNN_cl_32_32", 1e-5),
                                       ("tiny_CNN_cl_32_32_BN", 2e-5)])
def test_one_lwf_step_with_two_previous_heads_matches(name, atol):
    new_j, new_t = lwf_style_steps(name, jlwf.LwFRule(), tlwf.LwFRule(),
                                   {"lambda": 10.0}, {}, {})
    _assert_trees_close(ttrain.trainable_to_host(new_t.trainable),
                        new_j.trainable, atol)
    _assert_trees_close(ttrain.trainable_to_host(new_t.momentum),
                        new_j.momentum, atol)
    _assert_trees_close(convert.batch_stats_to_jax(new_t.batch_stats),
                        new_j.batch_stats, atol)
    # the distillation moved the previous heads, which CE alone leaves still
    _, new_0 = lwf_style_steps(name, None, tlwf.LwFRule(),
                               {"lambda": 0.0}, {}, {})
    moved = (new_t.trainable["heads"]["kernel"][:2]
             - new_0.trainable["heads"]["kernel"][:2]).detach().abs().max()
    assert float(moved) > 1e-4
    assert tlwf.TEMPERATURE == jlwf.TEMPERATURE == 2.0


ARGV = ["tiny_CNN_cl_32_32", "--ds_name", "synthetic_2t_4c_32px",
        "--num_epochs", "2", "--batch_size", "32", "--lr_grid", "1e-2",
        "--boot_lr_grid", "1e-2", "--device", "cpu"]


@pytest.mark.parametrize("warmup", [0, 1])
def test_lwf_cli_on_the_cpu(tmp_path, monkeypatch, warmup):
    monkeypatch.setenv("CLSURVEY_ROOT", str(tmp_path))
    tconfig.set_config(None)
    base = tmain.cli(ARGV + ["--method_name", "SI", "--runmode",
                             "first_task_basemodel_dump"])
    base_model = tio.load(base.best_model_path(1, create=False))
    extra = ["--static_hyperparams", "1"] if warmup else []
    manager = tmain.cli(ARGV + ["--method_name", "LWF",
                                "--max_attempts_per_task", "2", "--test"]
                        + extra)
    exp_dir = manager.task_training_dir(2, create=False)
    assert tpaths.has_success(exp_dir)
    ck = tio.load(os.path.join(exp_dir, "hyperparams.pth.tar"))
    assert ck["state"]["hyperparams"]["lambda"] == \
        10 * 0.5 ** ck["state"]["attempts"]
    model = jio.load(os.path.join(exp_dir, "best_model.pth.tar"))
    assert "method_aux" not in model  # LwF carries nothing between tasks
    assert [len(r["seq_res"]) for r in manager.extras["eval_results"]] \
        == [2, 1]
    warm_dir = exp_dir + "_head_warmup"
    assert os.path.isdir(warm_dir) == bool(warmup)
    if warmup:
        warm = tio.load(os.path.join(warm_dir, "best_model.pth.tar"))
        # head-only training: the backbone is the base model's, bit for bit,
        # and task 2's head moved off its fresh init scale
        np.testing.assert_array_equal(
            warm["params"]["features"]["conv_0"]["kernel"],
            base_model["params"]["features"]["conv_0"]["kernel"])
        np.testing.assert_array_equal(
            warm["params"]["trunk"]["fc_1"]["kernel"],
            base_model["params"]["trunk"]["fc_1"]["kernel"])
        assert not np.array_equal(warm["heads"]["kernel"][1],
                                  base_model["heads"]["kernel"][1])
        with open(os.path.join(warm_dir, "error_history.json")) as f:
            import json
            assert len(json.load(f)["error_history"]) == 1  # num_epochs=1
