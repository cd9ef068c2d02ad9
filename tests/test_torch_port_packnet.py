"""clsurvey_torch's PackNet against clsurvey_tpu's on the CPU (tiny_CNN at
32 px, float32, inputs made from numpy seeds):

- the mask operations on the batch-norm tiny_CNN, from one set of numpy
  weights (rounded, so |w| ties at the cutoff) and owners (30 weights of
  the pruned task in a layer, where 0.45 * 30 rounds differently in float32
  and float64): ``init_masks``, ``claim_free``, ``prune_masks`` at a decayed
  percentage, ``apply_eval_mask``, ``zero_pruned``, ``mask_grads`` with and
  without ``train_bn``, ``capacity_report``: masks (uint8, 0-d sentinels)
  and weights equal;
- one PackNet step at task 2 with momentum from an earlier step: params and
  momentum within 1e-5 of the JAX step, and every weight the task does not
  own, and every other task's head, bit-equal to its start;
- a PackNet two-task sequence trained by the JAX package, evaluated by the
  port's CLI (the masks of each evaluated task applied by the port):
  ``seq_res`` / ``seq_forgetting`` within 1e-4, per-class counters equal;
- masks from each package's files in the other's: uint8 trees in the JAX
  layout, equal."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.framework import main as tmain
from clsurvey_torch.methods import packnet as tpack
from clsurvey_torch.models import convert, registry as treg
from clsurvey_torch.ops import masks as tmasks
from clsurvey_torch.utils import config as tconfig, io as tio
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.framework.common import RunArgs as JRunArgs
from clsurvey_tpu.framework.main import main as jmain
from clsurvey_tpu.methods import packnet as jpack
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.ops import masks as jmasks
from clsurvey_tpu.utils import config as jconfig, io as jio

PX = 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models on the CPU: one intra-op thread. The suite runs in
    several worker processes at once, where torch's thread pool
    oversubscribes the cores (these CLI runs took 20x longer so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jnp(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def _model(name):
    return jio.to_host(jreg.init_model_state(
        jreg.parse_model_name("", name, (PX, PX)), jax.random.PRNGKey(3),
        max_tasks=3, classes_per_task=4, class_counts=[4, 3, 4]))


def _owners(rng, params, n_task2=30) -> dict:
    """Numpy masks in the JAX layout: owners 0..2 at random, exactly
    ``n_task2`` weights of task 2 in every layer big enough."""
    def one(a):
        if a.ndim < 2:
            return np.uint8(jmasks._SENTINEL)
        m = rng.integers(0, 2, a.shape).astype(np.uint8).ravel()
        m[rng.permutation(m.size)[:n_task2]] = 2
        return m.reshape(a.shape)
    return jax.tree_util.tree_map(one, params)


def _same(port_tree: dict, jax_tree, what: str):
    """A port-layout dict (masks or weights) equals a JAX-layout tree,
    dtypes and 0-d leaves included."""
    got = convert.params_to_jax(port_tree)
    for key_path, w in jax.tree_util.tree_flatten_with_path(
            jio.to_host(jax_tree))[0]:
        g = got
        for k in key_path:
            g = g[k.key]
        w = np.asarray(w)
        assert (np.asarray(g).dtype, np.shape(g)) == (w.dtype, w.shape), \
            (what, key_path)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {key_path}")


def _port(tree) -> dict:
    return convert.params_from_jax(tree, "cpu", dtype=None)


def test_mask_operations_match():
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda a: np.round(a, 2),
                                    _model("tiny_CNN_cl_32_32_BN")["params"])
    p_t = _port(params)
    assert p_t["features.conv_0.weight"].dtype == torch.float32
    _same(tmasks.init_masks(p_t, owner=1),
          jmasks.init_masks(_jnp(params), owner=1), "init")

    masks = _owners(rng, params)
    m_t = _port(masks)
    assert m_t["features.bn_0.scale"].shape == ()
    assert m_t["features.conv_0.weight"].dtype == torch.uint8
    _same(tmasks.claim_free(m_t, 2), jmasks.claim_free(_jnp(masks), 2),
          "claim_free")
    # 0.45 * 30 = 13.5 in float32 (k = 14), 13.49999964 in float64
    assert round(float(np.float64(np.float32(0.45)) * 30)) == 13
    new_p, new_m = tmasks.prune_masks(p_t, m_t, 2, 0.45)
    want_p, want_m = jax.jit(jmasks.prune_masks, static_argnums=(2, 3))(
        _jnp(params), _jnp(masks), 2, 0.45)
    _same(new_m, want_m, "pruned masks")
    _same(new_p, want_p, "pruned weights")
    removed = int((m_t["trunk.fc_1.weight"] == 2).sum()
                  - (new_m["trunk.fc_1.weight"] == 2).sum())
    assert removed >= 14  # ties at the cutoff go too
    for task in (1, 2):
        _same(tmasks.apply_eval_mask(new_p, new_m, task),
              jax.jit(jmasks.apply_eval_mask, static_argnums=2)(
                  want_p, want_m, task), f"eval {task}")
    _same(tmasks.zero_pruned(p_t, new_m),
          jmasks.zero_pruned(_jnp(params), want_m), "zero_pruned")
    grads = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1, a.shape).astype(np.float32), params)
    for train_bn in (False, True):
        _same(tmasks.mask_grads(_port(grads), new_m, 2, train_bn),
              jax.jit(jmasks.mask_grads, static_argnums=(2, 3))(
                  _jnp(grads), want_m, 2, train_bn),
              f"mask_grads train_bn={train_bn}")
    assert tmasks.capacity_report(new_m, 2) == \
        jmasks.capacity_report(want_m, 2)


def test_one_packnet_step_matches_and_freezes_the_rest():
    name, task_id, lr = "tiny_CNN_cl_32_32", 2, 0.05
    model = _model(name)
    masks = _owners(np.random.default_rng(1), model["params"])
    common = dict(task=task_id - 1, n_tasks=task_id,
                  class_counts=[4, 3, 4], mean=MEAN, std=STD, augment=False)
    rule_j, rule_t = jpack.PackNetRule(task_id), tpack.PackNetRule(task_id)
    ctx_j = jtrain.make_context(jreg.parse_model_name("", name, (PX, PX)),
                                update_rule=rule_j, mesh=None, **common)
    ctx_t = ttrain.make_context(treg.parse_model_name("", name, (PX, PX)),
                                update_rule=rule_t, device="cpu", **common)
    tr = {"params": model["params"],
          "heads": {k: model["heads"][k] for k in ("kernel", "bias")}}
    rng = np.random.default_rng(0)
    mom = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32), tr)
    x = rng.integers(0, 256, (16, PX, PX, 3), dtype=np.uint8)
    y = rng.integers(0, 3, (16,)).astype(np.int32)
    st_j = jtrain.TrainState(_jnp(tr), {}, _jnp(mom), rule_j.init_state(
        _jnp(tr), {}, ctx_j, masks=_jnp(masks)))
    new_j, _ = jax.jit(jtrain.Engine(ctx_j)._train_step)(
        st_j, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0),
        jnp.float32(lr))
    tr_t = ttrain.trainable_from_host(tr, "cpu", requires_grad=True)
    st_t = ttrain.TrainState(
        tr_t, {}, ttrain.trainable_from_host(mom, "cpu", False),
        rule_t.init_state(None, {}, ctx_t, masks=_port(masks)))
    new_t, _ = ttrain.Engine(ctx_t)._train_step(
        st_t, torch.from_numpy(x), torch.from_numpy(y).long(), lr)
    for attr in ("trainable", "momentum"):
        got = ttrain.trainable_to_host(getattr(new_t, attr))
        for key_path, want in jax.tree_util.tree_flatten_with_path(
                jio.to_host(getattr(new_j, attr)))[0]:
            g = got
            for k in key_path:
                g = g[k.key]
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(key_path))
    # exact freezing: other owners' weights, biases, other heads
    for k, m in _port(masks).items():
        before, after = tr_t["params"][k], new_t.trainable["params"][k]
        frozen = (m != task_id) if m.dim() else torch.ones_like(
            before, dtype=torch.bool)
        assert torch.equal(after[frozen], before[frozen]), k
        if m.dim():
            assert not torch.equal(after, before), k
    for k in ("kernel", "bias"):
        h0, h1 = tr_t["heads"][k], new_t.trainable["heads"][k]
        assert torch.equal(h1[[0, 2]], h0[[0, 2]])
        assert not torch.equal(h1[1], h0[1])


def _use(root):
    os.environ["CLSURVEY_ROOT"] = str(root)
    for mod in (jconfig, tconfig):
        mod.set_config(None)
        mod.load_config(refresh=True)


MODEL, DS = "tiny_CNN_cl_32_32", "synthetic_2t_4c_32px_nz50"
TRAIN = dict(model_name=MODEL, ds_name=DS, num_epochs=2, batch_size=32,
             lr_grid=(1e-2,))
ARGV = [MODEL, "--ds_name", DS, "--num_epochs", "2", "--batch_size", "32",
        "--lr_grid", "1e-2", "--device", "cpu"]


def _results(root):
    parent = os.path.join(str(root), "results", "test", "results", DS,
                          "packnet", MODEL, "demo")
    (exp,) = os.listdir(parent)
    return {fn: jio.load(os.path.join(parent, exp, fn))
            for fn in sorted(os.listdir(os.path.join(parent, exp)))}


@pytest.fixture(scope="module")
def jax_packnet(tmp_path_factory):
    """The JAX package trains and evaluates PackNet on two tasks (one
    post-prune epoch); returns (root, results)."""
    old = os.environ.get("CLSURVEY_ROOT")
    root = tmp_path_factory.mktemp("jax_packnet")
    _use(root)
    jmain(JRunArgs(method_name="packnet", static_hyperparams="1",
                   max_attempts_per_task=1, test=True, **TRAIN))
    yield root, _results(root)
    if old is not None:
        os.environ["CLSURVEY_ROOT"] = old
    jconfig.set_config(None)
    tconfig.set_config(None)


def test_the_port_evaluates_a_jax_trained_packnet_sequence(jax_packnet,
                                                           tmp_path, capsys):
    root, want = jax_packnet
    shutil.copytree(root, tmp_path / "port", symlinks=True,
                    ignore=shutil.ignore_patterns("test", "jax_cache"))
    _use(tmp_path / "port")
    tmain.cli(ARGV + ["--method_name", "packnet", "--static_hyperparams",
                      "1", "--max_attempts_per_task", "1", "--test"])
    assert "epoch 0:" not in capsys.readouterr().out  # nothing trained
    got = _results(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for fn, w in want.items():
        g, w = got[fn]["packnet"], w["packnet"]
        for key in ("seq_res", "seq_forgetting"):
            assert list(g[key]) == list(w[key])
            for i in w[key]:
                np.testing.assert_allclose(g[key][i], w[key][i], rtol=0,
                                           atol=1e-4)
        assert g["seq_per_class"] == w["seq_per_class"]
    _use(root)


def test_masks_cross_between_packages(jax_packnet, tmp_path):
    root, _ = jax_packnet
    (path,) = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
               if f == "best_model.pth.tar" and "task_2" in d
               and "TASK_TRAINING" in d]
    want = jio.load(path)["method_aux"]["masks"]
    model, masks = tpack.load_with_masks(path, "cpu")
    assert {int(v) for m in masks.values() if m.dim() for v in m.unique()} \
        <= {0, 1, 2}
    rule = tpack.PackNetRule(2)
    aux = rule.export_aux({"masks": masks})
    _same(convert.params_from_jax(aux["masks"], dtype=None), want, "back")
    # the port's file, read by the JAX package's loader
    tio.save({**model, "method_aux": aux}, str(tmp_path / "m.pth"))
    _, masks_j = jpack.PackNet()._load_with_masks(str(tmp_path / "m.pth"))
    _same(masks, masks_j, "read by the JAX package")
