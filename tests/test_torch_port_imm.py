"""clsurvey_torch's IMM against clsurvey_tpu's on the CPU, and each package
on the other's files (tiny_CNN at 32 px, float32).

- ``imm_mode_fisher`` on a batch-norm model over two splits (tails dropped),
  with the labels the JAX run sampled handed in: within rtol 1e-3 / atol
  1e-8 (squares of float32 gradients; the floor is 1e-8); the port's own
  draw is reproducible from its generator;
- ``merge_mean`` and ``merge_mode`` on the same numpy models and precisions:
  bit-equal (float64 sums in the same order, float32 result);
- the mean_IMM and mode_IMM CLIs on the CPU, two tasks: merged models,
  precision caches, result dicts under the eval name, and the staleness rule
  of ``eval_model_preprocessing`` by file times (a cached merge is kept, a
  newer prefix model or ``--test_overwrite_mode`` rewrites it, the
  preprocessing time is written only when work was done);
- a LWF and a mean_IMM two-task sequence trained ONCE by the JAX package
  (from its own SI base model): the port's CLI fast-forwards through a copy
  of that tree, merges again, evaluates, and gets the JAX package's
  ``seq_res`` / ``seq_forgetting`` within 1e-4 (percent) and the same merged
  weights bit for bit."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.framework import main as tmain
from clsurvey_torch.methods import imm as timm
from clsurvey_torch.methods.base import UpdateRule as TRule
from clsurvey_torch.models import convert, registry as treg
from clsurvey_torch.ops import importance as timp
from clsurvey_torch.utils import config as tconfig, timing
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.framework.common import RunArgs as JRunArgs
from clsurvey_tpu.framework.main import main as jmain
from clsurvey_tpu.methods import imm as jimm
from clsurvey_tpu.methods.base import UpdateRule as JRule
from clsurvey_tpu.models import heads as jheads, registry as jreg
from clsurvey_tpu.ops import importance as jimp, preprocess as jpp
from clsurvey_tpu.utils import config as jconfig, io as jio

MODEL, DS, PX = "tiny_CNN_cl_32_32", "synthetic_2t_4c_32px", 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
ARGV = [MODEL, "--ds_name", DS, "--num_epochs", "2", "--batch_size", "32",
        "--lr_grid", "1e-2", "--boot_lr_grid", "1e-2", "--device", "cpu"]
TRAIN = dict(model_name=MODEL, ds_name=DS, num_epochs=2, batch_size=32,
             lr_grid=(1e-2,), boot_lr_grid=(1e-2,))


def _use(root):
    os.environ["CLSURVEY_ROOT"] = str(root)
    for mod in (jconfig, tconfig):
        mod.set_config(None)
        mod.load_config(refresh=True)


@pytest.fixture(autouse=True)
def restore_root():
    old = os.environ.get("CLSURVEY_ROOT")
    yield
    if old is None:
        os.environ.pop("CLSURVEY_ROOT", None)
    else:
        os.environ["CLSURVEY_ROOT"] = old
    jconfig.set_config(None)
    tconfig.set_config(None)


def test_mode_fisher_with_the_jax_runs_labels_matches():
    name, bsz, task = "tiny_CNN_cl_32_32_BN", 32, 1
    spec_j = jreg.parse_model_name("", name, (PX, PX))
    model = jio.to_host(jreg.init_model_state(
        spec_j, jax.random.PRNGKey(3), max_tasks=2, classes_per_task=4,
        class_counts=[4, 3]))
    rng = np.random.default_rng(0)
    for st in model["batch_stats"]["features"].values():
        st["mean"] = rng.normal(0, 0.2, st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    splits = [rng.integers(0, 256, (70, PX, PX, 3), dtype=np.uint8),
              rng.integers(0, 256, (40, PX, PX, 3), dtype=np.uint8)]
    common = dict(task=task, n_tasks=2, class_counts=[4, 3], mean=MEAN,
                  std=STD, augment=False)
    ctx_j = jtrain.make_context(spec_j, update_rule=JRule(), mesh=None,
                                **common)
    ctx_t = ttrain.make_context(treg.parse_model_name("", name, (PX, PX)),
                                update_rule=TRule(), device="cpu", **common)
    params_j = jax.tree_util.tree_map(jnp.asarray, model["params"])
    stats_j = jax.tree_util.tree_map(jnp.asarray, model["batch_stats"])
    bank_j = {"kernel": jnp.asarray(model["heads"]["kernel"]),
              "bias": jnp.asarray(model["heads"]["bias"]),
              "class_counts": model["heads"]["class_counts"]}
    key = jax.random.PRNGKey(9)
    want = jimp.imm_mode_fisher(ctx_j, params_j, stats_j, bank_j, task,
                                splits, bsz, key)

    # the labels that run sampled: one key per split, one per whole batch
    sampled = []
    for images in splits:
        key, r = jax.random.split(key)
        labels = []
        for b in range(len(images) // bsz):
            r, sub = jax.random.split(r)
            x = jpp.normalize(jnp.asarray(images[b * bsz:(b + 1) * bsz]),
                              MEAN, STD)
            feats, _ = ctx_j.forward_feats(params_j, stats_j, x, False,
                                           jax.random.PRNGKey(0))
            labels.append(np.asarray(jax.random.categorical(
                sub, jheads.forward(bank_j, feats, task))))
        sampled.append(np.concatenate(labels))
    assert [len(s) for s in sampled] == [64, 32]
    assert max(s.max() for s in sampled) <= 2  # the masked class never drawn

    args = (ctx_t, convert.params_from_jax(model["params"]),
            convert.batch_stats_from_jax(model["batch_stats"]),
            model["heads"], task, splits, bsz)
    got = convert.params_to_jax(timp.imm_mode_fisher(
        *args, sampled_labels=sampled))
    for key_path, w in jax.tree_util.tree_flatten_with_path(
            jio.to_host(want))[0]:
        g = got
        for k in key_path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-8,
                                   err_msg=jax.tree_util.keystr(key_path))
        assert (g >= 1e-8).all()
    assert got["features"]["conv_0"]["kernel"].max() > 1e-6

    # the port's own draw: reproducible from the generator, another sample
    own = [timp.imm_mode_fisher(
        *args, generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    name0 = "trunk.fc_1.weight"
    assert torch.equal(own[0][name0], own[1][name0])
    assert float(own[0][name0].min()) >= float(np.float32(1e-8))
    assert not np.allclose(own[0][name0].numpy(),
                           got["trunk"]["fc_1"]["kernel"].T, rtol=1e-3)


@pytest.mark.parametrize("mode", ["mean", "mode"])
def test_merges_are_bit_equal(mode):
    rng = np.random.default_rng(3)
    spec = jreg.parse_model_name("", MODEL, (PX, PX))
    base = jio.to_host(jreg.init_model_state(
        spec, jax.random.PRNGKey(0), max_tasks=3, classes_per_task=4))
    like = lambda scale, positive=False: jax.tree_util.tree_map(
        lambda a: (np.abs(rng.normal(0, scale, a.shape)) + 1e-8 if positive
                   else rng.normal(0, scale, a.shape)).astype(np.float32),
        base["params"])
    models = [{**base, "params": like(0.1), "meta": {"task": t}}
              for t in range(3)]
    if mode == "mean":
        want, got = jimm.merge_mean(models), timm.merge_mean(models)
    else:
        precisions = [like(1e-3, positive=True) for _ in range(3)]
        want = jimm.merge_mode(models, precisions)
        got = timm.merge_mode(models, precisions)
    assert got["meta"] == want["meta"] == {"task": 2}  # the last model's
    assert got["heads"] is models[-1]["heads"]
    for key_path, w in jax.tree_util.tree_flatten_with_path(
            want["params"])[0]:
        g = got["params"]
        for k in key_path:
            g = g[k.key]
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.fixture()
def port_root_with_si_dump(tmp_path):
    _use(tmp_path)
    tmain.cli(ARGV + ["--method_name", "SI", "--runmode",
                      "first_task_basemodel_dump"])
    return tmp_path


@pytest.mark.parametrize("method", ["mean_IMM", "mode_IMM"])
def test_imm_cli_on_the_cpu_and_the_staleness_rule(port_root_with_si_dump,
                                                   method):
    root = port_root_with_si_dump
    mode = method.split("_")[0]
    manager = tmain.cli(ARGV + ["--method_name", method, "--test"])
    # Phase 1 only, trained under the method's own name, evaluated under
    # the eval name
    assert manager.method.name == "IMM" and manager.method.no_framework
    dirs = [manager.task_training_dir(t, create=False) for t in (1, 2)]
    assert all(os.path.islink(d) for d in dirs)
    merge = os.path.join(dirs[1], f"best_model_{mode}_IMM_merge.pth.tar")
    merged = jio.load(merge)
    models = [jio.load(os.path.join(d, "best_model.pth.tar")) for d in dirs]
    np.testing.assert_array_equal(merged["heads"]["kernel"],
                                  models[1]["heads"]["kernel"])
    assert not os.path.exists(os.path.join(
        dirs[0], f"best_model_{mode}_IMM_merge.pth.tar"))
    caches = [os.path.join(d, timm.PRECISION_FILENAME) for d in dirs]
    if mode == "mean":
        want = timm.merge_mean(models)
        assert not any(os.path.exists(c) for c in caches)
    else:
        precisions = [jio.load(c) for c in caches]
        for prec in precisions:
            assert all(np.isfinite(leaf).all() and (leaf >= 1e-8).all()
                       for leaf in jax.tree_util.tree_leaves(prec))
        want = jimm.merge_mode(models, precisions)
    np.testing.assert_array_equal(
        merged["params"]["trunk"]["fc_0"]["kernel"],
        np.asarray(want["params"]["trunk"]["fc_0"]["kernel"]))
    res_dir = os.path.join(str(root), "results", "test", "results", DS,
                           method, MODEL, "demo")
    (exp,) = os.listdir(res_dir)
    assert sorted(os.listdir(os.path.join(res_dir, exp))) == [
        f"test_method_performances{method}0.pth",
        f"test_method_performances{method}1.pth"]
    assert [len(r["seq_res"]) for r in manager.extras["eval_results"]] \
        == [2, 1]

    # the staleness rule, by file times
    args, paths = manager.args, [os.path.join(d, "best_model.pth.tar")
                                 for d in dirs]
    prep = os.path.join(dirs[1], timing.PREPROCESS_TIME_FILENAME)
    stamp = lambda p: os.stat(p).st_mtime_ns
    before = {p: stamp(p) for p in [merge, prep] + (
        caches if mode == "mode" else [])}
    out = manager.method.eval_model_preprocessing(args, manager, paths)
    assert out == [paths[0], merge]
    assert {p: stamp(p) for p in before} == before  # all cached: no work
    # task 1's model becomes newer than the merge (and than its precision)
    later = os.stat(merge).st_mtime + 10
    os.utime(paths[0], (later, later))
    manager.method.eval_model_preprocessing(args, manager, paths)
    assert stamp(merge) > before[merge] and stamp(prep) > before[prep]
    if mode == "mode":
        assert stamp(caches[0]) > before[caches[0]]   # stale: recomputed
        assert stamp(caches[1]) == before[caches[1]]  # still fresh
    again = stamp(merge)
    args.test_overwrite_mode = True
    manager.method.eval_model_preprocessing(args, manager, paths)
    assert stamp(merge) > again


def _results(root, method):
    parent = os.path.join(str(root), "results", "test", "results", DS,
                          method, MODEL, "demo")
    (exp,) = os.listdir(parent)
    exp_dir = os.path.join(parent, exp)
    return {fn: jio.load(os.path.join(exp_dir, fn))
            for fn in sorted(os.listdir(exp_dir))}


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """The JAX package dumps its SI base model, then trains and evaluates
    LWF and mean_IMM; returns (root, {method: result dicts})."""
    old = os.environ.get("CLSURVEY_ROOT")
    root = tmp_path_factory.mktemp("jax_trained")
    _use(root)
    jmain(JRunArgs(method_name="SI", runmode="first_task_basemodel_dump",
                   **TRAIN))
    for method in ("LWF", "mean_IMM"):
        jmain(JRunArgs(method_name=method, max_attempts_per_task=1,
                       test=True, **TRAIN))
    want = {m: _results(root, m) for m in ("LWF", "mean_IMM")}
    yield root, want
    if old is not None:
        os.environ["CLSURVEY_ROOT"] = old


@pytest.mark.parametrize("method", ["LWF", "mean_IMM"])
def test_the_port_evaluates_a_jax_trained_sequence(jax_trained, tmp_path,
                                                   method, capsys):
    root, want = jax_trained
    # without the JAX package's eval results and merged models: the port
    # merges and evaluates itself
    shutil.copytree(root, tmp_path / "port", symlinks=True,
                    ignore=shutil.ignore_patterns("test", "jax_cache",
                                                  "*_IMM_merge*"))
    _use(tmp_path / "port")
    manager = tmain.cli(ARGV + ["--method_name", method,
                                "--max_attempts_per_task", "1", "--test"])
    out = capsys.readouterr().out
    assert "RESTORED lr=" in out and "epoch 0:" not in out  # nothing trained
    if method == "LWF":
        assert "Already successful run. Skipping phase 2." in out
    got = _results(tmp_path / "port", method)
    assert sorted(got) == sorted(want[method])
    for fn, w in want[method].items():
        g, w = got[fn][method], w[method]
        for key in ("seq_res", "seq_forgetting"):
            assert list(g[key]) == list(w[key])
            for idx in w[key]:
                np.testing.assert_allclose(g[key][idx], w[key][idx], rtol=0,
                                           atol=1e-4)
        assert g["seq_per_class"] == w["seq_per_class"]
    if method == "mean_IMM":
        rel = os.path.relpath(
            os.path.join(manager.task_training_dir(2, create=False),
                         "best_model_mean_IMM_merge.pth.tar"),
            str(tmp_path / "port"))
        ours, theirs = (jio.load(os.path.join(str(r), rel))
                        for r in (tmp_path / "port", root))
        for key_path, w in jax.tree_util.tree_flatten_with_path(
                theirs["params"])[0]:
            g = ours["params"]
            for k in key_path:
                g = g[k.key]
            np.testing.assert_array_equal(g, np.asarray(w))
