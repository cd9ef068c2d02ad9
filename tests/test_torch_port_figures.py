"""clsurvey_torch's ``--profile`` and figures on the CPU.

- ``--profile`` writes a Chrome trace of the first task (as
  ``tests/test_profile_flag.py`` checks the JAX package's), and the
  program's spans of it beside the trace;
- ``analyze_experiments`` on the port's own results (finetuning and Joint
  through the port's CLI with ``--test``, two tasks) writes ``_acc.png``
  and ``_forgetting.png``, a ``_v2`` beside a figure that exists, and
  prints the JAX package's summary table on the same entries;
- the demo plot config renders the port's results;
- without matplotlib, rendering raises an ``ImportError`` naming it."""

import glob
import json
import os
import sys

import pytest
import torch

from clsurvey_torch.framework import main as tmain
from clsurvey_torch.framework.common import RunArgs
from clsurvey_torch.utilities import postprocessing as tpost
from clsurvey_torch.utilities.plot_configs import demo as tdemo
from clsurvey_torch.utils import config as tconfig
from clsurvey_tpu.utilities import postprocessing as jpost

MODEL, DS, GRID = "tiny_CNN_cl_32_32", "synthetic_2t_4c_32px", "figgrid"


@pytest.fixture()
def port_root(tmp_path, monkeypatch):
    monkeypatch.setenv("CLSURVEY_ROOT", str(tmp_path))
    tconfig.set_config(None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tconfig.load_config(refresh=True)
    torch.set_num_threads(threads)
    tconfig.set_config(None)


def test_profile_writes_trace(port_root):
    tmain.main(RunArgs(model_name=MODEL, ds_name=DS,
                       method_name="finetuning", num_epochs=2,
                       batch_size=32, lr_grid=(1e-2,),
                       gridsearch_name="profilegrid", max_task_count=1,
                       profile=True, device="cpu"))
    trace_dir = os.path.join(port_root.tr_results_root_path, "profile",
                             f"{DS}_finetuning")
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(traces) == 1, os.listdir(trace_dir)
    with open(traces[0]) as f:
        assert '"traceEvents"' in f.read()
    # the program's spans of the task, beside the trace: every train step
    # numbered in turn, the evals, and the model's pools (the convs' spans
    # are the card's route's)
    with open(traces[0].replace(".pt.trace.json", ".spans.json")) as f:
        got = json.load(f)
    assert got["dropped"] == 0
    steps = [r for r in got["records"] if r["name"] == "train.step"]
    assert steps and [r["step"] for r in steps] == \
        list(range(1, len(steps) + 1))
    assert {r["name"] for r in got["records"]} == {"train.step", "eval",
                                                   "pool"}
    assert all(r["end_ns"] >= r["start_ns"] > 0 and r["n"] > 0
               for r in got["records"])


@pytest.fixture()
def port_results(port_root):
    for method in ("finetuning", "joint"):
        tmain.cli([MODEL, "--method_name", method, "--ds_name", DS,
                   "--num_epochs", "1", "--batch_size", "32", "--lr_grid",
                   "1e-2", "--gridsearch_name", GRID, "--test", "--device",
                   "cpu"])
    return port_root


def _entries(lib, cfg):
    return [e for method in ("finetuning", "joint")
            for e in lib.collect_gridsearch_exp_entries(
                cfg.test_results_root_path, DS, method, MODEL, GRID)]


def test_analyze_experiments_renders_and_matches_the_jax_table(
        port_results, tmp_path):
    entries = _entries(tpost, port_results)
    assert len(entries) == 2 and all(e.task_count == 2 for e in entries)
    stem = str(tmp_path / "figs" / "port")
    table = tpost.analyze_experiments(entries, plot_seq_forgetting=True,
                                      save_img_path=stem)
    assert os.path.getsize(stem + "_acc.png") > 0
    assert os.path.getsize(stem + "_forgetting.png") > 0
    tpost.analyze_experiments(entries, save_img_path=stem,
                              all_diff_color_force=True)
    assert os.path.getsize(stem + "_acc_v2.png") > 0
    assert not os.path.exists(stem + "_forgetting_v2.png")
    want = jpost.analyze_experiments(_entries(jpost, port_results))
    assert table == want
    assert tpost.get_colors(18) == jpost.get_colors(18)


def test_demo_config_renders_the_ports_results(port_results, tmp_path):
    stem = str(tmp_path / "demo_plot")
    entries = tdemo.main(DS, MODEL, GRID, save_img=stem)
    assert sorted(e.eval_name for e in entries) == ["finetuning", "joint"]
    assert os.path.getsize(stem + "_acc.png") > 0
    assert os.path.getsize(stem + "_forgetting.png") > 0


def test_rendering_without_matplotlib_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "clsurvey_torch.utilities.plot",
                        raising=False)
    with pytest.raises(ImportError, match="matplotlib"):
        import clsurvey_torch.utilities.plot  # noqa: F401
