"""The port's CLI on the CPU for this slice's methods (tiny_CNN at 32 px,
two tasks, one epoch, 8 memories a task), from one SI base model:

- ``methods.parse`` returns GEM, ICARL, both replay baselines and packnet;
- GEM: task 1's wrapped model carries a buffer of 8 task-1 rows, task 2's
  both buffers; the epoch history records the share of projected steps;
- ICARL: the exemplar store after each task (16 rows: 4, then 2 a class)
  with targets over the heads of the class's task and -1e10 beyond;
- the replay baselines: each task's model carries the buffers so far;
- packnet: owners in {0, 1, 2}, the pruned weights exactly 0, task 2's
  Phase-1 winner kept;
- every run leaves the eval matrix (two result dicts)."""

import json
import os

import numpy as np
import pytest
import torch

from clsurvey_torch import methods
from clsurvey_torch.framework import main as tmain
from clsurvey_torch.models.convert import params_from_jax
from clsurvey_torch.utils import config as tconfig, io as tio, paths

ARGV = ["tiny_CNN_cl_32_32", "--ds_name", "synthetic_2t_4c_32px",
        "--num_epochs", "1", "--batch_size", "32", "--lr_grid", "1e-2",
        "--boot_lr_grid", "1e-2", "--device", "cpu",
        "--max_attempts_per_task", "1", "--test"]
NAMES = ("GEM", "ICARL", "finetuning_rehearsal_partial_mem",
         "finetuning_rehearsal_full_mem", "packnet")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models on the CPU: one intra-op thread. The suite runs in
    several worker processes at once, where torch's thread pool
    oversubscribes the cores (these CLI runs took 20x longer so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_parse_returns_the_new_methods():
    assert [methods.parse(n).name for n in NAMES] == list(NAMES)


@pytest.fixture(scope="module")
def si_root(tmp_path_factory):
    old = os.environ.get("CLSURVEY_ROOT")
    root = tmp_path_factory.mktemp("port_rehearsal")
    os.environ["CLSURVEY_ROOT"] = str(root)
    tconfig.set_config(None)
    tmain.cli(ARGV[:-3] + ["--method_name", "SI", "--runmode",
                           "first_task_basemodel_dump"])
    yield root
    if old is not None:
        os.environ["CLSURVEY_ROOT"] = old
    tconfig.set_config(None)


def _run(si_root, method, static="8"):
    os.environ["CLSURVEY_ROOT"] = str(si_root)
    tconfig.set_config(None)
    extra = ["--static_hyperparams", static] if static else []
    manager = tmain.cli(ARGV + ["--method_name", method] + extra)
    assert [len(r["seq_res"]) for r in manager.extras["eval_results"]] \
        == [2, 1]
    return manager


def _memory(manager, task):
    return tio.load(manager.best_model_path(task, create=False))[
        "method_aux"]["memory"]


def test_gem_cli(si_root):
    manager = _run(si_root, "GEM")
    assert list(_memory(manager, 1)["mem_count"]) == [8, 0]
    mem = _memory(manager, 2)
    assert list(mem["mem_count"]) == [8, 8]
    assert mem["mem_images"].dtype == np.uint8 and \
        mem["mem_cnt"].dtype == np.int32
    with open(os.path.join(manager.task_training_dir(2, create=False),
                           "error_history.json")) as f:
        (share,) = json.load(f)["rule_metrics"]["projected"]
    assert 0.0 <= share <= 1.0


def test_icarl_cli(si_root):
    manager = _run(si_root, "ICARL")
    for task, per_class in ((1, 4), (2, 2)):
        path = manager.best_model_path(task, create=False)
        if task > 1:
            path = path.replace(paths.BEST_MODEL_FILENAME,
                                paths.BEST_MODEL_POSTPROCESSED_FILENAME)
        ex = tio.load(path)["method_aux"]["exemplars"]
        n = int(ex["count"])
        assert n == 16 and ex["images"].shape[0] == 16
        assert list(np.bincount(ex["labels"][:n])) == [per_class] * 4 * task
        width = 4 * (ex["task_ids"][:n] + 1)
        inside = np.arange(8)[None, :] < width[:, None]
        assert np.isfinite(ex["targets"][:n][inside]).all()
        assert (ex["targets"][:n][~inside] == np.float32(-1e10)).all()


@pytest.mark.parametrize("method", ["finetuning_rehearsal_partial_mem",
                                    "finetuning_rehearsal_full_mem"])
def test_replay_cli(si_root, method):
    manager = _run(si_root, method)
    assert list(_memory(manager, 1)["mem_count"]) == [8, 0]
    assert list(_memory(manager, 2)["mem_count"]) == [8, 8]


def test_packnet_cli(si_root):
    manager = _run(si_root, "packnet", static="1")
    for task in (1, 2):
        model = tio.load(manager.best_model_path(task, create=False))
        masks = params_from_jax(model["method_aux"]["masks"], dtype=None)
        weights = params_from_jax(model["params"])
        for k, m in masks.items():
            if m.dim():
                assert int(m.max()) <= task and int((m == task).sum()) > 0
                assert not weights[k][m == 0].any()
    assert os.path.isfile(manager.extras["packnet_ft_model_path"])
