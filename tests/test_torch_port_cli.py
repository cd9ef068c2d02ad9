"""clsurvey_torch's CLI against clsurvey_tpu's on the CPU, and the port's
import boundary.

- the finetuning CLI on synthetic_2t_4c_32px (2 epochs, ``--device cpu``)
  leaves the same directory tree as the JAX CLI (but for the JAX package's
  compilation cache and Orbax resume directories), and its best models load
  with ``clsurvey_tpu.utils.io`` and score, under the JAX backbone, the
  val accuracy the port recorded (within one val sample);
- importing every ``clsurvey_torch`` module loads no JAX, flax, optax or
  ``clsurvey_tpu`` module;
- the SI first-task base-model dump followed by ``EWC ... --test`` (and MAS,
  SI) on ``--device cpu``, two tasks: the decay state, the SUCCESS token,
  best models with ``method_aux`` in the JAX layout, the result dicts, and
  a tree that both ``postprocessing`` modules read; the JAX CLI continues
  from the port's base model;
- timing_mode on a 2-task sequence trains both tasks;
- asking for ``cuda`` without a card raises, and what is not ported yet
  raises ``NotImplementedError`` naming its ROADMAP item."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.framework import main as tmain
from clsurvey_torch.utilities import postprocessing as tpost
from clsurvey_torch.utils import config as tconfig, paths as tpaths
from clsurvey_tpu.data import registry as jdata
from clsurvey_tpu.framework.common import RunArgs as JRunArgs
from clsurvey_tpu.framework.main import main as jmain
from clsurvey_tpu.models import heads as jheads, registry as jreg
from clsurvey_tpu.ops import preprocess as jpp
from clsurvey_tpu.utilities import postprocessing as jpost
from clsurvey_tpu.utils import config as jconfig, io as jio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["tiny_CNN_cl_32_32", "--method_name", "finetuning",
        "--ds_name", "synthetic_2t_4c_32px", "--num_epochs", "2",
        "--lr_grid", "1e-2,1e-3", "--batch_size", "32"]


@pytest.fixture()
def two_roots(tmp_path, monkeypatch):
    """Separate CLSURVEY_ROOTs for the two CLIs; both configs reset."""
    def use(root):
        monkeypatch.setenv("CLSURVEY_ROOT", str(root))
        jconfig.set_config(None)
        jconfig.load_config(refresh=True)
        tconfig.set_config(None)
        tconfig.load_config(refresh=True)
        return root

    yield use, tmp_path / "jax", tmp_path / "port"
    jconfig.set_config(None)
    tconfig.set_config(None)


def _tree(root) -> list:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out += [os.path.join(rel, d) + "/" for d in dirnames]
        out += [os.path.join(rel, f) for f in filenames]
    # not compared: the JAX package's compilation cache, and the Orbax
    # directory it keeps beside epoch.pth.tar (the port writes resume
    # state into the plain pickle itself)
    return sorted(os.path.normpath(p) for p in out
                  if "jax_cache" not in p and ".orbax" not in p)


def test_cli_tree_and_models_match_the_jax_cli(two_roots):
    use, jax_root, port_root = two_roots
    use(jax_root)
    jmain(JRunArgs(model_name="tiny_CNN_cl_32_32",
                   ds_name="synthetic_2t_4c_32px",
                   method_name="finetuning", num_epochs=2,
                   lr_grid=(1e-2, 1e-3), batch_size=32))
    use(port_root)
    manager = tmain.cli(ARGV + ["--device", "cpu"])
    assert _tree(port_root) == _tree(jax_root)
    assert sorted(manager.extras["task_seconds"]) == [1, 2]

    spec = jreg.parse_model_name("", "tiny_CNN_cl_32_32", (32, 32))
    seq = jdata.parse("synthetic_2t_4c_32px")
    for task in (1, 2):
        model = jio.load(manager.best_model_path(task, create=False))
        val = seq.get_task_dataset(task).val
        x = jpp.normalize(jnp.asarray(val.images), seq.mean, seq.std)
        feats = spec.make_backbone().apply(
            {"params": jax.tree_util.tree_map(jnp.asarray,
                                              model["params"])}, x)
        logits = jheads.forward(model["heads"], feats, task - 1)
        acc = float(np.mean(np.asarray(jnp.argmax(logits, -1))
                            == val.labels))
        assert abs(acc - model["meta"]["val_acc"]) <= 1.0 / val.size + 1e-9


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import clsurvey_torch\n"
        "for m in pkgutil.walk_packages(clsurvey_torch.__path__, "
        "'clsurvey_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'clsurvey_tpu'))\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('clsurvey_torch.')]))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module was imported


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tmain.cli(ARGV)  # --device defaults to cuda


def test_timing_mode_runs_a_shorter_sequence_whole(two_roots):
    """timing_mode asks for 4 tasks; on a 2-task sequence the port trains
    both (the JAX CLI asks the data for task 3 and fails)."""
    use, _, port_root = two_roots
    use(port_root)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        manager = tmain.cli(ARGV[:5] + ["--runmode", "timing_mode",
                                        "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert manager.args.max_task_count == 2
    assert sorted(manager.extras["task_seconds"]) == [1, 2]


ALEX_ARGV = ["--ds_name", "synthetic_2t_4c_64px_16n", "--num_epochs", "1",
             "--batch_size", "16", "--lr_grid", "1e-2",
             "--max_attempts_per_task", "1"]


@pytest.mark.parametrize("model,extra,match", [
    (ARGV[0], ["--profile"], "item 4: profiling"),
    pytest.param("alexnet", ["--method_name", "HAT"] + ALEX_ARGV, None,
                 id="alexnet-extra1-item 2: AlexNet"),
    pytest.param("alexnet", ["--method_name", "pathnet",
                             "--static_hyperparams", "4;1"] + ALEX_ARGV,
                 None, id="alexnet-extra2-item 2: AlexNet"),
    pytest.param(ARGV[0], ["--ds_name", "tiny"], "tinyimagenet.prepare",
                 id="tiny_CNN_cl_32_32-extra3-item 2: AlexNet and the "
                    "datasets")])
def test_later_slices_raise(two_roots, model, extra, match):
    """Only the items of later slices raise ``NotImplementedError``, naming
    the item: ``--profile`` (item 4). Item 2's cases, which raised before it
    was ported, now run: HAT and PathNet on AlexNet (64 px, one epoch)
    through the CLI leave their AlexNet models, and ``--ds_name tiny``
    looks for its prepared bundles under the config's ``ds_root_path`` and
    says how to prepare them."""
    use, _, port_root = two_roots
    use(port_root)
    argv = [model] + ARGV[1:] + ["--device", "cpu"] + extra
    if match == "item 4: profiling":
        with pytest.raises(NotImplementedError, match=match):
            tmain.cli(argv)
    elif match is not None:
        with pytest.raises(FileNotFoundError, match=match):
            tmain.cli(argv)
    else:
        threads = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            manager = tmain.cli(argv)
        finally:
            torch.set_num_threads(threads)
        best = jio.load(manager.best_model_path(2, create=False))
        if "HAT" in extra:
            assert best["meta"]["hat"]
            assert best["params"]["conv_0"]["kernel"].shape == (11, 11, 3,
                                                                 64)
            assert best["params"]["fc_0"]["kernel"].shape == (256, 4096)
        else:  # PathNetAlexNet at 64 px: kernels 8, 6 and 2
            assert best["meta"]["pathnet"]
            assert best["params"]["conv_0_kernel"].shape == (4, 8, 8, 3, 16)
            assert best["params"]["fc_0_kernel"].shape == (4, 5 * 5 * 66,
                                                           528)


REG_ARGV = [ARGV[0], "--ds_name", "synthetic_2t_4c_32px", "--num_epochs", "2",
            "--batch_size", "32", "--lr_grid", "1e-2", "--boot_lr_grid",
            "1e-2", "--device", "cpu"]


@pytest.fixture()
def port_root_with_si_dump(two_roots):
    use, _, port_root = two_roots
    use(port_root)
    manager = tmain.cli(REG_ARGV + ["--method_name", "SI", "--runmode",
                                    "first_task_basemodel_dump"])
    return use, port_root, manager.best_model_path(1, create=False)


def test_si_dump_then_ewc_with_test(port_root_with_si_dump, capsys):
    use, port_root, base_path = port_root_with_si_dump
    base = jio.load(base_path)
    assert set(base["method_aux"]) == {"omega", "theta_star", "w"}
    assert np.abs(base["method_aux"]["w"]["features"]["conv_0"]["kernel"]
                  ).max() > 0  # the path integral ran during task 1
    # a second dump refuses to overwrite
    capsys.readouterr()
    tmain.cli(REG_ARGV + ["--method_name", "SI", "--runmode",
                          "first_task_basemodel_dump"])
    assert "refusing overwrite" in capsys.readouterr().out

    manager = tmain.cli(REG_ARGV + [
        "--method_name", "EWC", "--max_attempts_per_task", "2", "--test"])
    assert "USING SI AS MODEL FOR FIRST TASK" in capsys.readouterr().out
    exp_dir = manager.task_training_dir(2, create=False)
    assert tpaths.has_success(exp_dir) and not os.path.islink(exp_dir)
    ck = torch.load(os.path.join(exp_dir, "hyperparams.pth.tar"),
                    weights_only=False)
    assert set(ck) == {"acc_threshold", "val_acc", "state"}
    assert ck["state"]["attempts"] in (0, 1, 2)
    assert ck["state"]["hyperparams"]["lambda"] == \
        400 * 0.5 ** ck["state"]["attempts"]
    for fn in ("best_model.pth.tar", "preprocess_time.pth.tar"):
        assert os.path.isfile(os.path.join(exp_dir, fn))
    assert sorted(jio.load(os.path.join(
        manager.task_dir(2, create=False), "phase_timing.pth.tar"))) == (
            ["convergence_iteration", "phase1", "postprocess", "presteps"]
            if ck["state"]["attempts"] < 2 else
            ["phase1", "postprocess", "presteps"])
    # the best model carries omega and theta_star in the JAX layout:
    # theta_star is the base model's weights, omega its Fisher (>= 0)
    model = jio.load(os.path.join(exp_dir, "best_model.pth.tar"))
    aux = model["method_aux"]
    assert set(aux) == {"omega", "theta_star"}
    for group, layers in base["params"].items():
        for layer, leaves in layers.items():
            for leaf, value in leaves.items():
                np.testing.assert_array_equal(
                    aux["theta_star"][group][layer][leaf], value)
                om = aux["omega"][group][layer][leaf]
                assert om.shape == value.shape and (om >= 0).all()
    assert aux["omega"]["features"]["conv_0"]["kernel"].max() > 0

    # the eval matrix: model 1 is the shared SI model
    res = manager.extras["eval_results"]
    assert [len(r["seq_res"]) for r in res] == [2, 1]
    test_root = os.path.join(str(port_root), "results", "test")
    for lib in (jpost, tpost):
        (entry,) = lib.collect_gridsearch_exp_entries(
            test_root, "synthetic_2t_4c_32px", "EWC", ARGV[0], "demo")
        assert entry.task_count == 2 and sorted(entry.seq_acc) == [1, 2]
        counts = lib.collect_hyperparams(entry, "EWC")
        assert entry.hyperparams["lambda"] == [
            ck["state"]["hyperparams"]["lambda"]]
        assert counts["lambda"] == 1
        assert "lambda" in lib.print_hyperparam_table([entry])


@pytest.mark.parametrize("method", ["MAS", "SI"])
def test_si_dump_then_mas_and_si(port_root_with_si_dump, method):
    _, port_root, _ = port_root_with_si_dump
    manager = tmain.cli(REG_ARGV + [
        "--method_name", method, "--max_attempts_per_task", "1", "--test"])
    exp_dir = manager.task_training_dir(2, create=False)
    assert tpaths.has_success(exp_dir)
    aux = jio.load(os.path.join(exp_dir, "best_model.pth.tar"))["method_aux"]
    assert set(aux) == ({"omega", "theta_star", "w"} if method == "SI"
                        else {"omega", "theta_star"})
    for tree in aux.values():
        for layers in tree.values():
            for leaves in layers.values():
                assert all(np.isfinite(v).all() for v in leaves.values())
    assert [len(r["seq_res"]) for r in manager.extras["eval_results"]] \
        == [2, 1]


def test_the_jax_cli_continues_from_the_ports_si_dump(
        port_root_with_si_dump):
    """A base model written by the port (``method_aux`` through
    ``models/convert.py``) is what the JAX package's SI consolidates."""
    use, port_root, base_path = port_root_with_si_dump
    manager = jmain(JRunArgs(
        model_name=ARGV[0], ds_name="synthetic_2t_4c_32px",
        method_name="SI", num_epochs=2, batch_size=32, lr_grid=(1e-2,),
        boot_lr_grid=(1e-2,), max_attempts_per_task=1))
    assert manager.previous_task_model_path.endswith(
        os.path.join("task_2", "TASK_TRAINING", "best_model.pth.tar"))
    aux = jio.load(manager.previous_task_model_path)["method_aux"]
    base = jio.load(base_path)
    np.testing.assert_array_equal(
        aux["theta_star"]["trunk"]["fc_0"]["kernel"],
        base["params"]["trunk"]["fc_0"]["kernel"])
    assert np.isfinite(aux["omega"]["trunk"]["fc_0"]["kernel"]).all()


def test_joint_trains_one_merged_head(two_roots):
    use, _, port_root = two_roots
    use(port_root)
    manager = tmain.cli(ARGV[:2] + ["joint"] + ARGV[3:]
                        + ["--device", "cpu", "--num_epochs", "1"])
    assert sorted(manager.extras["task_seconds"]) == [1]  # one merged task
    model = jio.load(manager.best_model_path(1, create=False))
    # 2 tasks x 4 classes in one head; the bank keeps its task slots
    assert np.shape(model["heads"]["kernel"]) == (2, 32, 8)
    assert list(model["heads"]["class_counts"]) == [8, 0]
