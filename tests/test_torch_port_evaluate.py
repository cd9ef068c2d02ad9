"""clsurvey_torch's eval matrix against clsurvey_tpu's on the CPU.

A finetuning sequence and a joint model are trained ONCE by the JAX package
(tiny_CNN at 32 px, synthetic_2t_4c_32px); the port's CLI is then pointed at
a copy of that tree, fast-forwards through training on the JAX package's
grid checkpoints, and evaluates the JAX-trained models:

- the same result files and keys, ``seq_res`` / ``seq_forgetting`` within
  1e-4 (accuracies in percent; float32 logits in another summation order
  may move an argmax only at a tie), per-class counters equal;
- Joint's single full-batch artifact, the same way;
- ``--test_set``, the task range and the overwrite guard;
- the port's result tree loads in ``clsurvey_tpu.utilities.postprocessing``
  and in the port's own ``utilities.postprocessing``, with equal curves;
- ``Engine.evaluate``'s ``predict`` / ``target_labels`` /
  ``n_counter_classes`` against the JAX engine;
- a split above the device data budget raises, naming streaming."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.framework import evaluate as tevaluate, main as tmain
from clsurvey_torch.methods.base import UpdateRule as TRule
from clsurvey_torch.models import registry as treg
from clsurvey_torch.utilities import postprocessing as tpost
from clsurvey_torch.utils import config as tconfig, io as tio
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.framework.common import RunArgs as JRunArgs
from clsurvey_tpu.framework.main import main as jmain
from clsurvey_tpu.methods.base import UpdateRule as JRule
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.utilities import postprocessing as jpost
from clsurvey_tpu.utils import config as jconfig, io as jio

MODEL, DS, GRID = "tiny_CNN_cl_32_32", "synthetic_2t_4c_32px", "evalgrid"
TRAIN = dict(model_name=MODEL, ds_name=DS, num_epochs=2, batch_size=32,
             lr_grid=(1e-2,), gridsearch_name=GRID)
ARGV = [MODEL, "--ds_name", DS, "--num_epochs", "2", "--batch_size", "32",
        "--lr_grid", "1e-2", "--gridsearch_name", GRID, "--device", "cpu"]


def _use(root):
    os.environ["CLSURVEY_ROOT"] = str(root)
    for mod in (jconfig, tconfig):
        mod.set_config(None)
        mod.load_config(refresh=True)


def _results(root, method, subset=""):
    """{file name: loaded dict} of one experiment's test results."""
    parent = os.path.join(str(root), "results", "test", "results", DS,
                          method, MODEL, GRID)
    (exp,) = [d for d in os.listdir(parent) if d.endswith(subset)
              and (subset or not d.endswith(("_val", "_train")))]
    exp_dir = os.path.join(parent, exp)
    return exp_dir, {fn: jio.load(os.path.join(exp_dir, fn))
                     for fn in sorted(os.listdir(exp_dir))}


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """The JAX package trains and evaluates finetuning (test and val) and
    joint; returns (root, {name: results})."""
    old = os.environ.get("CLSURVEY_ROOT")
    root = tmp_path_factory.mktemp("jax_trained")
    _use(root)
    jmain(JRunArgs(method_name="finetuning", test=True, **TRAIN))
    jmain(JRunArgs(method_name="finetuning", test=True, test_set="val",
                   test_max_task_count=1, **TRAIN))
    jmain(JRunArgs(method_name="joint", test=True, **TRAIN))
    want = {"test": _results(root, "finetuning")[1],
            "val": _results(root, "finetuning", "_val")[1],
            "joint": _results(root, "joint")[1]}
    yield root, want
    if old is not None:
        os.environ["CLSURVEY_ROOT"] = old
    jconfig.set_config(None)
    tconfig.set_config(None)


@pytest.fixture()
def port_root(jax_trained, tmp_path):
    """A copy of the JAX-trained tree without its eval results, as the
    port's CLSURVEY_ROOT."""
    root, want = jax_trained
    shutil.copytree(root, tmp_path / "port", symlinks=True,
                    ignore=shutil.ignore_patterns("test", "jax_cache"))
    _use(tmp_path / "port")
    yield tmp_path / "port", want
    _use(root)


def _assert_result_dicts_match(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for fn in want:
        (method,) = want[fn]
        g, w = got[fn][method], want[fn][method]
        assert sorted(g) == sorted(w), fn
        for key in ("seq_res", "seq_forgetting"):
            if key not in w:
                continue
            if isinstance(w[key], dict):
                assert list(g[key]) == list(w[key])
                for idx in w[key]:
                    np.testing.assert_allclose(g[key][idx], w[key][idx],
                                               rtol=0, atol=1e-4)
            else:
                np.testing.assert_allclose(g[key], w[key], rtol=0,
                                           atol=1e-4)
        if "seq_per_class" in w:
            assert g["seq_per_class"] == w["seq_per_class"]
            assert g["seq_head_acc"] == w["seq_head_acc"] == []


def test_eval_matrix_of_a_jax_trained_sequence_matches(port_root, capsys):
    root, want = port_root
    manager = tmain.cli(ARGV + ["--method_name", "finetuning", "--test"])
    out = capsys.readouterr().out
    assert out.count("RESTORED lr=") == 2  # nothing was trained again
    _, got = _results(root, "finetuning")
    assert sorted(got) == ["test_method_performancesfinetuning0.pth",
                           "test_method_performancesfinetuning1.pth"]
    _assert_result_dicts_match(got, want["test"])
    res = manager.extras["eval_results"]
    assert [len(r["seq_res"]) for r in res] == [2, 1]
    # the files are in torch.save format, as the reference's reader needs
    exp_dir, _ = _results(root, "finetuning")
    raw = torch.load(os.path.join(exp_dir, sorted(got)[0]),
                     weights_only=False)
    assert list(raw["finetuning"]["seq_res"]) == [0]


def test_joint_artifact_matches(port_root):
    root, want = port_root
    tmain.cli(ARGV + ["--method_name", "joint", "--test"])
    _, got = _results(root, "joint")
    assert sorted(got) == ["test_method_performancesJOINT_FULL_BATCH.pth"]
    _assert_result_dicts_match(got, want["joint"])
    assert len(got[sorted(got)[0]]["joint"]["seq_res"]) == 2


def test_test_set_task_range_and_overwrite_guard(port_root, capsys):
    root, want = port_root
    argv = ARGV + ["--method_name", "finetuning", "--test"]
    tmain.cli(argv + ["--test_set", "val", "--test_max_task_count", "1"])
    exp_dir, got = _results(root, "finetuning", "_val")
    assert exp_dir.endswith("_val")
    assert sorted(got) == ["test_method_performancesfinetuning0.pth"]
    _assert_result_dicts_match(got, want["val"])

    # the range's start: only ref task 2, under its 0-based index
    tmain.cli(argv + ["--test_starting_task_count", "2"])
    exp_dir, got = _results(root, "finetuning")
    assert sorted(got) == ["test_method_performancesfinetuning1.pth"]
    art = os.path.join(exp_dir, sorted(got)[0])
    stamp = os.stat(art).st_mtime_ns

    # a second eval refuses to rewrite; overwrite mode does
    capsys.readouterr()
    tmain.cli(argv + ["--test_starting_task_count", "2"])
    assert "EVAL already done" in capsys.readouterr().out
    assert os.stat(art).st_mtime_ns == stamp
    tmain.cli(argv + ["--test_starting_task_count", "2",
                      "--test_overwrite_mode"])
    assert os.stat(art).st_mtime_ns > stamp
    with pytest.raises(AssertionError, match="evaluating"):
        tmain.cli(argv + ["--cleanup_exp"])


def test_result_tree_loads_in_both_postprocessings(port_root):
    root, _ = port_root
    tmain.cli(ARGV + ["--method_name", "finetuning", "--test"])
    tmain.cli(ARGV + ["--method_name", "joint", "--test"])
    test_root = os.path.join(str(root), "results", "test")
    for method in ("finetuning", "joint"):
        entries = [lib.collect_gridsearch_exp_entries(
            test_root, DS, method, MODEL, GRID) for lib in (jpost, tpost)]
        (e_j,), (e_t,) = entries
        assert e_t.task_count == e_j.task_count == 2
        assert e_t.seq_acc == e_j.seq_acc
        assert e_t.seq_forgetting == e_j.seq_forgetting
        assert e_t.avg_acc == e_j.avg_acc
        assert (e_t.linestyle, e_t.marker, e_t.single_dot) == \
            (e_j.linestyle, e_j.marker, e_j.single_dot)
        assert tpost.print_exp_statistics([e_t]) == \
            jpost.print_exp_statistics([e_j])


def _engines(n_tasks=2):
    common = dict(task=1, n_tasks=n_tasks, class_counts=[4, 3],
                  mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                  augment=False)
    ctx_j = jtrain.make_context(
        jreg.parse_model_name("", MODEL, (32, 32)), update_rule=JRule(),
        mesh=None, **common)
    ctx_t = ttrain.make_context(
        treg.parse_model_name("", MODEL, (32, 32)), update_rule=TRule(),
        device="cpu", **common)
    return jtrain.Engine(ctx_j), ttrain.Engine(ctx_t)


@pytest.mark.parametrize("mode", ["shared", "callable", "target_labels"])
def test_engine_evaluate_modes_match(mode):
    spec = jreg.parse_model_name("", MODEL, (32, 32))
    model = jio.to_host(jreg.init_model_state(
        spec, jax.random.PRNGKey(2), max_tasks=2, classes_per_task=4,
        class_counts=[4, 3]))
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (40, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (40,)).astype(np.int32)
    eng_j, eng_t = _engines()
    kw_j, kw_t = {}, {}
    if mode == "shared":  # labels offset into the second head's slots
        kw_j = kw_t = dict(predict="shared", target_labels=labels + 4)
    elif mode == "callable":
        kw_j = dict(predict=lambda c, tr, f: jnp.where(
            jnp.arange(4) < 2, c.task_logits(tr, f), -1e10),
            n_counter_classes=6)
        kw_t = dict(predict=lambda c, tr, f: c.task_logits(tr, f)
                    .masked_fill(torch.arange(4) >= 2, -1e10),
                    n_counter_classes=6)
    else:
        kw_j = kw_t = dict(target_labels=(labels + 1) % 3)
    tr = {"params": model["params"],
          "heads": {k: model["heads"][k] for k in ("kernel", "bias")}}
    want = eng_j.evaluate(jax.tree_util.tree_map(jnp.asarray, tr), {},
                          jnp.asarray(images), jnp.asarray(labels), 16,
                          **kw_j)
    got = eng_t.evaluate(
        ttrain.trainable_from_host(tr, "cpu", requires_grad=False), {},
        torch.from_numpy(images), labels, 16, **kw_t)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert len(got[1]) == {"shared": 8, "callable": 6,
                           "target_labels": 4}[mode]
    feats = torch.zeros(2, 32)
    bank_tr = ttrain.trainable_from_host(tr, "cpu", requires_grad=False)
    assert eng_t.ctx.all_logits(bank_tr, feats).shape == (2, 2, 4)
    assert eng_t.ctx.shared_logits(bank_tr, feats).shape == (2, 8)


def test_a_split_over_the_budget_raises_naming_streaming(monkeypatch):
    """A split over the device data budget streams through chunks (it
    raised before streaming was ported; the name is kept): at a budget of
    0 each chunk is one batch of 16 rows, the last one short, and the
    counters equal the JAX package's resident eval of the same split."""
    spec = jreg.parse_model_name("", MODEL, (32, 32))
    model = jio.to_host(jreg.init_model_state(
        spec, jax.random.PRNGKey(5), max_tasks=2, classes_per_task=4,
        class_counts=[4, 3]))
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (40, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (40,)).astype(np.int32)
    eng_j, eng_t = _engines()
    tr = {"params": model["params"],
          "heads": {k: model["heads"][k] for k in ("kernel", "bias")}}
    want = eng_j.evaluate(jax.tree_util.tree_map(jnp.asarray, tr), {},
                          jnp.asarray(images), jnp.asarray(labels), 16)
    monkeypatch.setenv("CLSURVEY_DATA_BUDGET_MB", "0")
    got = tevaluate._evaluate_split(
        eng_t, ttrain.trainable_from_host(tr, "cpu", requires_grad=False),
        {}, images, labels, 16)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
