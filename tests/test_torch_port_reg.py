"""clsurvey_torch's importance-regularised update rules against
clsurvey_tpu's on the CPU, from shared numpy-made states and inputs
(tiny_CNN at 32 px, float32).

- one ``QuadRegRule`` train step (nonzero omega, theta away from
  theta_star, with and without weight decay; ``MASRule`` with the orth-reg
  hook): params and momentum within atol 1e-5 (sums in another order);
- three ``SIRule`` steps: params within 1e-5, the path integral ``w`` within
  rtol 1e-3 / atol 1e-7 (a product of two small float32 differences);
- ``si_consolidate`` with a NaN and a negative entry: equal within 1e-6;
- ``orth_reg_grad`` on the port's (out,in,kh,kw) layout: within 1e-6;
- ``method_aux`` through ``models/convert.py`` in both directions: a model
  written by either package consolidates / continues in the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.methods import reg_based as treg_m
from clsurvey_torch.models import registry as treg
from clsurvey_torch.models.convert import params_from_jax, params_to_jax
from clsurvey_torch.utils import io as tio
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.methods import reg_based as jreg_m
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.utils import io as jio

NAME, PX = "tiny_CNN_cl_32_32", 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture(scope="module")
def shared():
    """A JAX-made init model plus numpy-made omega / theta_star / batches."""
    spec = jreg.parse_model_name("", NAME, (PX, PX))
    model = jio.to_host(jreg.init_model_state(
        spec, jax.random.PRNGKey(3), max_tasks=2, classes_per_task=4))
    rng = np.random.default_rng(0)
    like = lambda fn: jax.tree_util.tree_map(
        lambda a: fn(np.shape(a)).astype(np.float32), model["params"])
    omega = like(lambda s: np.abs(rng.normal(0, 1.0, s)))
    theta_star = jax.tree_util.tree_map(
        lambda a, d: a + d, model["params"],
        like(lambda s: rng.normal(0, 1e-2, s)))
    batches = [(rng.integers(0, 256, (16, PX, PX, 3), dtype=np.uint8),
                rng.integers(0, 4, (16,)).astype(np.int32))
               for _ in range(3)]
    return model, omega, theta_star, batches


def _contexts(rule_j, rule_t, **kw):
    common = dict(task=0, n_tasks=1, class_counts=[4, 4], mean=MEAN,
                  std=STD, augment=False, **kw)
    ctx_j = jtrain.make_context(jreg.parse_model_name("", NAME, (PX, PX)),
                                update_rule=rule_j, mesh=None, **common)
    ctx_t = ttrain.make_context(treg.parse_model_name("", NAME, (PX, PX)),
                                update_rule=rule_t, device="cpu", **common)
    return ctx_j, ctx_t


def _jnp(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def _trainable(model):
    return {"params": model["params"],
            "heads": {k: model["heads"][k] for k in ("kernel", "bias")}}


def _assert_close(port_jax_layout, jax_tree, **tol):
    for key_path, want in jax.tree_util.tree_flatten_with_path(
            jio.to_host(jax_tree))[0]:
        got = port_jax_layout
        for k in key_path:
            got = got[k.key]
        np.testing.assert_allclose(got, want, **tol,
                                   err_msg=jax.tree_util.keystr(key_path))


def _run_steps(shared, rule_j, rule_t, n_steps, hyper, lr=0.05, **ctx_kw):
    """``n_steps`` train steps in both packages from the same state;
    returns (jax final state, port final state)."""
    model, omega, theta_star, batches = shared
    ctx_j, ctx_t = _contexts(rule_j, rule_t, **ctx_kw)
    tr = _trainable(model)
    st_j = jtrain.TrainState(
        _jnp(tr), {}, jtrain.tree_zeros_like(_jnp(tr)),
        rule_j.init_state(_jnp(tr), hyper, ctx_j, omega=_jnp(omega),
                          theta_star=_jnp(theta_star)))
    tr_t = ttrain.trainable_from_host(tr, "cpu", requires_grad=True)
    st_t = ttrain.TrainState(
        tr_t, {}, ttrain.tree_zeros_like(tr_t),
        rule_t.init_state(tr_t, hyper, ctx_t,
                          omega=params_from_jax(omega),
                          theta_star=params_from_jax(theta_star)))
    eng_j, eng_t = jtrain.Engine(ctx_j), ttrain.Engine(ctx_t)
    for x, y in batches[:n_steps]:
        st_j, _ = eng_j._train_step(st_j, jnp.asarray(x), jnp.asarray(y),
                                    jax.random.PRNGKey(0), jnp.float32(lr))
        st_t, _ = eng_t._train_step(st_t, torch.from_numpy(x),
                                    torch.from_numpy(y).long(), lr)
    return st_j, st_t


@pytest.mark.parametrize("kind,ctx_kw", [
    ("quad", {}), ("quad", {"weight_decay": 1e-2}),
    ("mas_orth", {"weight_decay": 1e-2})], ids=["plain", "l2", "mas_orth"])
def test_one_quadreg_step_matches(shared, kind, ctx_kw):
    if kind == "quad":
        rule_j, rule_t = jreg_m.QuadRegRule(), treg_m.QuadRegRule()
    else:
        rule_j = jreg_m.MASRule(orth_reg=True)
        rule_t = treg_m.MASRule(orth_reg=True)
    st_j, st_t = _run_steps(shared, rule_j, rule_t, 1, {"lambda": 3.0},
                            **ctx_kw)
    _assert_close(ttrain.trainable_to_host(st_t.trainable), st_j.trainable,
                  rtol=0, atol=1e-5)
    _assert_close(ttrain.trainable_to_host(st_t.momentum), st_j.momentum,
                  rtol=0, atol=1e-5)
    # the penalty moved the step: it differs from a lambda-0 step
    _, st_0 = _run_steps(shared, rule_j, rule_t, 1, {"lambda": 0.0},
                         **ctx_kw)
    name = "features.conv_0.weight"
    assert not torch.allclose(st_t.trainable["params"][name],
                              st_0.trainable["params"][name], atol=1e-4)
    # the rule returned new tensors: theta_star and omega are untouched
    _assert_close(params_to_jax(st_t.mstate["omega"]), shared[1], rtol=0,
                  atol=0)


def test_three_si_steps_match_with_w(shared):
    st_j, st_t = _run_steps(shared, jreg_m.SIRule(), treg_m.SIRule(), 3,
                            {"lambda": 1.0}, lr=0.02)
    _assert_close(ttrain.trainable_to_host(st_t.trainable), st_j.trainable,
                  rtol=0, atol=1e-5)
    _assert_close(params_to_jax(st_t.mstate["w"]), st_j.mstate["w"],
                  rtol=1e-3, atol=1e-7)
    assert any(float(v.abs().max()) > 0 for v in st_t.mstate["w"].values())
    # w reads the weights and raw gradients, never the momentum buffers:
    # the momentum the step returned is a different tensor from w
    for k, w in st_t.mstate["w"].items():
        assert w.data_ptr() != st_t.momentum["params"][k].data_ptr()
    # export_aux is the JAX layout, ready for disk
    aux = treg_m.SIRule().export_aux(st_t.mstate)
    assert set(aux) == {"omega", "theta_star", "w"}
    assert aux["w"]["features"]["conv_0"]["kernel"].shape == (3, 3, 3, 8)


def test_si_consolidate_with_a_nan_and_a_negative_entry(shared):
    model, omega, theta_star, _ = shared
    rng = np.random.default_rng(5)
    w = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1e-3, np.shape(a)).astype(np.float32),
        model["params"])
    w["features"]["conv_0"]["kernel"][0, 0, 0, 0] = np.nan
    w["features"]["conv_0"]["kernel"][0, 0, 0, 1] = -5.0  # clamps to 0
    carried = jax.tree_util.tree_map(np.copy, omega)
    carried["trunk"]["fc_0"]["bias"][0] = np.inf  # carried state too
    aux = {"omega": carried, "w": w, "theta_star": theta_star}
    want = jreg_m.si_consolidate(_jnp(model["params"]), aux)
    got = treg_m.si_consolidate(
        params_from_jax(model["params"]),
        {k: params_from_jax(v) for k, v in aux.items()})
    _assert_close(params_to_jax(got), want, rtol=1e-6, atol=1e-6)
    flat = params_to_jax(got)
    assert np.isfinite(flat["trunk"]["fc_0"]["bias"]).all()
    assert flat["features"]["conv_0"]["kernel"][0, 0, 0, 0] == \
        carried["features"]["conv_0"]["kernel"][0, 0, 0, 0]
    assert treg_m.SI_XI == jreg_m.SI_XI == 1e-3


def test_orth_reg_grad_matches(shared):
    kernel = shared[0]["params"]["features"]["conv_2"]["kernel"]  # HWIO
    want = np.asarray(jreg_m.orth_reg_grad(jnp.asarray(kernel), 0.01))
    weight = torch.tensor(kernel.transpose(3, 2, 0, 1))  # OIHW
    got = treg_m.orth_reg_grad(weight, 0.01).numpy()
    np.testing.assert_allclose(got.transpose(2, 3, 1, 0), want, rtol=1e-5,
                               atol=1e-6)


def test_method_aux_round_trips_between_the_packages(shared, tmp_path):
    model, omega, theta_star, _ = shared
    # port -> JAX: a port-written best model's aux consolidates in JAX
    st_j, st_t = _run_steps(shared, jreg_m.SIRule(), treg_m.SIRule(), 2,
                            {"lambda": 1.0}, lr=0.02)
    ctx_t = _contexts(jreg_m.SIRule(), treg_m.SIRule())[1]
    path = str(tmp_path / "port_model.pth.tar")
    tio.save(ttrain.model_state_dict(ctx_t, st_t, meta={"n_tasks": 1}),
             path)
    port_model = jio.load(path)
    assert jax.tree_util.tree_structure(port_model["method_aux"]["w"]) == \
        jax.tree_util.tree_structure(model["params"])
    want = jreg_m.si_consolidate(st_j.trainable["params"], {
        "omega": st_j.mstate["omega"], "w": st_j.mstate["w"],
        "theta_star": st_j.mstate["theta_star"]})
    got = jreg_m.si_consolidate(_jnp(port_model["params"]),
                                port_model["method_aux"])
    _assert_close(jio.to_host(got), want, rtol=1e-3, atol=1e-5)

    # JAX -> port: a JAX-written model's aux loads into the port's layout
    ctx_j = _contexts(jreg_m.SIRule(), treg_m.SIRule())[0]
    path = str(tmp_path / "jax_model.pth.tar")
    jio.save(jtrain.model_state_dict(ctx_j, st_j, meta={"n_tasks": 1}),
             path)
    jax_model = tio.load(path)
    for key in ("omega", "theta_star", "w"):
        tree = params_from_jax(jax_model["method_aux"][key])
        assert set(tree) == set(st_t.trainable["params"])
        assert tree["features.conv_0.weight"].shape == (8, 3, 3, 3)
        _assert_close(params_to_jax(tree), jax_model["method_aux"][key],
                      rtol=0, atol=0)
    got = treg_m.si_consolidate(
        params_from_jax(jax_model["params"]),
        {k: params_from_jax(jax_model["method_aux"][k])
         for k in ("omega", "w", "theta_star")})
    _assert_close(params_to_jax(got), want, rtol=1e-6, atol=1e-6)
