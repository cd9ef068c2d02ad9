"""clsurvey_torch's survey script (``clsurvey_torch/scripts/
run_survey_demo.py``) against the JAX package's ``scripts/run_survey_demo.py``
on the CPU.

- the renderer: the same entries and row stores through both scripts'
  ``_merge_rows``, ``_write_markdown``, ``_carried_entries``,
  ``_hp_entries`` and ``postprocess`` give byte-equal markdown, rows JSON
  and side files, in each case of ``tests/test_survey_demo_merge.py``
  (partial refresh, fresh rows overwrite, carried rows with notes, curve
  persistence, monotone canonical coverage, IMM out of the hyperparameter
  table, an empty tree that touches no figure);
- a tiny sweep: the port's script with ``--device cpu`` on
  tiny_CNN_cl_32_32 / synthetic_2t_4c_32px, 2 epochs, finetuning, joint and
  EWC, then the JAX script's ``postprocess`` over the port's results tree:
  the same table, rows and summary; a second render keeps every row's
  ``commit`` / ``date``;
- without matplotlib, ``postprocess`` writes the table, rows and summary
  and leaves the figures as they were;
- the script's defaults: ``--device cuda``, an ``--out`` under
  ``CLSURVEY_ROOT`` and not under ``docs/``; without a card the sweep
  raises."""

import json
import os
import sys
import time
from types import SimpleNamespace

import pytest
import torch

import scripts.run_survey_demo as jrsd
from clsurvey_torch.scripts import run_survey_demo as trsd
from clsurvey_torch.utils import config as tconfig
from clsurvey_tpu.utils import config as jconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"jax": (jrsd, "clsurvey_tpu"), "port": (trsd, "clsurvey_torch")}


@pytest.fixture(autouse=True)
def _one_day(monkeypatch):
    """Both scripts stamp rows with today's date: hold it still."""
    real = time.strftime
    monkeypatch.setattr(time, "strftime",
                        lambda fmt, *a: "2026-01-02" if not a
                        else real(fmt, *a))


def _entry(name, acc, forg=1.0, tasks=2):
    # shaped like the live collector's (tests/test_survey_demo_merge.py)
    seq_acc = {t: [acc + forg, acc][:tasks - t + 1] if t == 1 else [acc]
               for t in range(1, tasks + 1)}
    return SimpleNamespace(eval_name=name, exp_name="default",
                           avg_acc=acc, avg_forgetting=forg,
                           single_dot=False, seq_acc=seq_acc,
                           task_count=tasks,
                           hyperparams={"lambda": [400.0] * tasks})


def _seed_store(out):
    rows = {
        "EWC": {"exp": "lambda=400", "avg_acc": 45.11,
                "avg_forgetting": 0.63, "commit": "aaaaaaa",
                "date": "2026-08-18"},
        "finetuning": {"exp": "default", "avg_acc": 46.83,
                       "avg_forgetting": 7.87, "commit": "aaaaaaa",
                       "date": "2026-08-18"},
    }
    with open(out + "_rows.json", "w") as f:
        json.dump(rows, f)


def _fake_post(monkeypatch, rsd, pkg, pool, saved, empty_ok=True):
    """``pkg``'s postprocessing module replaced by one whose collector
    returns the entries of ``pool`` and whose renderer records the stem it
    was given, as ``tests/test_survey_demo_merge.py`` does."""
    import importlib

    real = importlib.import_module(f"{pkg}.utilities.postprocessing")

    class _Post:
        ExperimentDataEntry = real.ExperimentDataEntry

        @staticmethod
        def collect_gridsearch_exp_entries(root, ds, name, model, grid):
            return [e for e in pool if e.eval_name == name]

        @staticmethod
        def collect_hyperparams(*a, **k):
            return None

        @staticmethod
        def pad_hyperparams(*a, **k):
            return None

        @staticmethod
        def analyze_experiments(entries, save_img_path=None, **k):
            if not empty_ok:
                raise AssertionError("must not render figures")
            saved.append(os.path.basename(save_img_path))
            return "SUMMARY"

        @staticmethod
        def print_hyperparam_table(entries):
            return "HP"

    utilities = importlib.import_module(f"{pkg}.utilities")
    monkeypatch.setattr(utilities, "postprocessing", _Post, raising=False)
    monkeypatch.setitem(sys.modules, f"{pkg}.utilities.postprocessing",
                        _Post)
    methods = importlib.import_module(f"{pkg}.methods")
    monkeypatch.setattr(methods, "parse", lambda n: SimpleNamespace(name=n))
    monkeypatch.setattr(rsd, "METHODS",
                        [("EWC", None, None), ("LWF", None, None)])


def case_partial_refresh(rsd, pkg, out, monkeypatch):
    _seed_store(out)
    rows, fresh = rsd._merge_rows([_entry("LWF", 40.0)], out)
    rows2, fresh2 = rsd._merge_rows([], out)
    rsd._write_markdown(rows2, fresh2, out, ds_name="synthetic_x", epochs=70)
    return [rows, sorted(fresh), rows2, sorted(fresh2)]


def case_fresh_rows_overwrite(rsd, pkg, out, monkeypatch):
    _seed_store(out)
    rows, fresh = rsd._merge_rows([_entry("EWC", 50.0)], out)
    rsd._write_markdown(rows, fresh, out)
    return [rows, sorted(fresh)]


def case_carried_rows_with_notes(rsd, pkg, out, monkeypatch):
    _seed_store(out)
    with open(out + "_notes.md", "w") as f:
        f.write("## curated note\nsurvives regeneration")
    with open(out + "_flags.json", "w") as f:
        json.dump({"EWC": "carried from an older sweep"}, f)
    rows, fresh = rsd._merge_rows([_entry("LWF", 40.0)], out)
    rsd._write_markdown(rows, fresh, out, ds_name="synthetic_x", epochs=70)
    first = open(out + ".md").read()
    open(out + "_latestrun_acc.png", "wb").close()
    rsd._write_markdown(rows, fresh, out, ds_name="synthetic_x", epochs=70)
    return [first]


def case_curve_persistence(rsd, pkg, out, monkeypatch):
    rsd._merge_rows([_entry("EWC", 45.0, forg=2.0),
                     _entry("LWF", 41.5, forg=-0.5, tasks=3)], out)
    rows = json.load(open(out + "_rows.json"))
    rows["old"] = {"exp": "x", "avg_acc": 1.0, "avg_forgetting": None,
                   "commit": "", "date": ""}
    carried = rsd._carried_entries(rows, fresh={"LWF"})
    carried += rsd._carried_entries(rows, fresh=set())
    return [(e.eval_name, e.exp_name, e.seq_acc, e.seq_forgetting,
             e.task_count, e.hyperparams, e.avg_acc, e.avg_forgetting)
            for e in carried]


def case_monotone_canonical_coverage(rsd, pkg, out, monkeypatch):
    saved, pool = [], [_entry("EWC", 45.0), _entry("LWF", 40.0)]
    _fake_post(monkeypatch, rsd, pkg, pool, saved)
    rsd.postprocess("synthetic_x", out, epochs=70)
    pool[:] = [_entry("EWC", 50.0)]
    rsd.postprocess("synthetic_x", out, epochs=70)
    rows = json.load(open(out + "_rows.json"))
    rows["LWF"].pop("curves")
    json.dump(rows, open(out + "_rows.json", "w"))
    pool[:] = [_entry("EWC", 51.0)]
    entries, summary = rsd.postprocess("synthetic_x", out, epochs=70)
    assert saved == ["tbl", "tbl", "tbl_latestrun"]
    return [saved, summary, [e.eval_name for e in entries]]


def case_imm_out_of_the_hyperparameter_table(rsd, pkg, out, monkeypatch):
    framework = SimpleNamespace(eval_name="EWC",
                                hyperparams={"lambda": [400.0]})
    imm = [SimpleNamespace(eval_name=n, hyperparams={})
           for n in ("mean_IMM", "mode_IMM")]
    kept = rsd._hp_entries([imm[0], framework, imm[1]])
    assert kept == [framework]
    return [[e.eval_name for e in kept], rsd._hp_entries([])]


def case_empty_tree_touches_no_figure(rsd, pkg, out, monkeypatch):
    _seed_store(out)
    for suffix in ("_acc.png", "_forgetting.png", "_summary.txt"):
        with open(out + suffix, "w") as f:
            f.write("committed-artifact")
    _fake_post(monkeypatch, rsd, pkg, [], [], empty_ok=False)
    entries, summary = rsd.postprocess("synthetic_x", out, epochs=70)
    for suffix in ("_acc.png", "_forgetting.png", "_summary.txt"):
        assert open(out + suffix).read() == "committed-artifact"
    return [entries, summary]


CASES = [case_partial_refresh, case_fresh_rows_overwrite,
         case_carried_rows_with_notes, case_curve_persistence,
         case_monotone_canonical_coverage,
         case_imm_out_of_the_hyperparameter_table,
         case_empty_tree_touches_no_figure]


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_renderer_matches_the_jax_script(case, tmp_path, monkeypatch):
    got = {}
    for side, (rsd, pkg) in SCRIPTS.items():
        d = tmp_path / side
        d.mkdir()
        with monkeypatch.context() as m:
            value = case(rsd, pkg, str(d / "tbl"), m)
        got[side] = (value, _files(d))
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][1] or case is case_imm_out_of_the_hyperparameter_table


def test_without_matplotlib_the_rest_is_rendered(tmp_path, monkeypatch,
                                                 capsys):
    """Where matplotlib does not import, the port's ``postprocess`` writes
    the table, the row store and the summary through the real
    postprocessing, says why there are no figures, and leaves the figures
    and the canonical record as they were."""
    from clsurvey_torch.utilities import postprocessing as post

    monkeypatch.setenv("CLSURVEY_ROOT", str(tmp_path / "root"))
    tconfig.set_config(None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "clsurvey_torch.utilities.plot", None)
    monkeypatch.setattr(post, "collect_gridsearch_exp_entries",
                        lambda *a: [])
    (tmp_path / "out").mkdir()
    out = str(tmp_path / "out" / "tbl")
    trsd._merge_rows([_entry("EWC", 45.0), _entry("LWF", 40.0, tasks=3)],
                     out)
    for suffix in ("_acc.png", "_forgetting.png"):
        with open(out + suffix, "w") as f:
            f.write("committed-artifact")
    entries, summary = trsd.postprocess("synthetic_x", out, epochs=70)
    tconfig.set_config(None)
    assert sorted(e.eval_name for e in entries) == ["EWC", "LWF"]
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert summary in open(out + "_summary.txt").read()
    assert "| EWC |" in open(out + ".md").read()
    assert sorted(json.load(open(out + "_rows.json"))) == ["EWC", "LWF"]
    for suffix in ("_acc.png", "_forgetting.png"):
        assert open(out + suffix).read() == "committed-artifact"
    assert sorted(os.listdir(tmp_path / "out")) == [
        "tbl.md", "tbl_acc.png", "tbl_forgetting.png",
        "tbl_rows.json", "tbl_summary.txt"]


SWEEP = ["--model", "tiny_CNN_cl_32_32", "--tasks", "2", "--classes", "4",
         "--px", "32", "--epochs", "2", "--batch_size", "32",
         "--methods", "finetuning,joint,EWC", "--device", "cpu"]
DS = "synthetic_2t_4c_32px"


@pytest.fixture()
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("CLSURVEY_ROOT", str(tmp_path / "root"))
    for cfg in (tconfig, jconfig):
        cfg.set_config(None)
    monkeypatch.setattr(trsd, "MODEL", trsd.MODEL)
    monkeypatch.setattr(trsd, "GRID", trsd.GRID)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(threads)
    for cfg in (tconfig, jconfig):
        cfg.set_config(None)


def test_the_jax_script_renders_the_ports_sweep_alike(root, monkeypatch):
    port_out = str(root / "port" / "survey_demo")
    trsd.main(SWEEP + ["--out", port_out])
    status = json.load(open(port_out + "_status.json"))
    assert [status[m]["ok"] for m in ("finetuning", "joint", "EWC")] == \
        [True] * 3
    rows = json.load(open(port_out + "_rows.json"))
    assert sorted(rows) == ["EWC", "finetuning", "joint"]
    for row in rows.values():
        assert row["task_count"] == 2 and set(row["curves"]) == {"1", "2"}
        assert {"exp", "avg_acc", "avg_forgetting", "hyperparams",
                "commit", "date"} <= set(row)
    assert rows["EWC"]["hyperparams"]

    jax_out = str(root / "jax" / "survey_demo")
    monkeypatch.setattr(jrsd, "MODEL", "tiny_CNN_cl_32_32")
    jentries, jsummary = jrsd.postprocess(DS, jax_out, epochs=2)
    assert sorted(e.eval_name for e in jentries) == sorted(rows)
    for suffix in (".md", "_rows.json", "_summary.txt", "_canonical.json"):
        assert open(jax_out + suffix).read() == \
            open(port_out + suffix).read(), suffix
    for suffix in ("_acc.png", "_forgetting.png"):
        assert os.path.getsize(port_out + suffix) > 0

    # a second render keeps the rows' "produced at"
    trsd.main(SWEEP + ["--out", port_out, "--postprocess_only"])
    again = json.load(open(port_out + "_rows.json"))
    assert {k: (r["commit"], r["date"]) for k, r in again.items()} == \
        {k: (r["commit"], r["date"]) for k, r in rows.items()}
    assert not os.path.exists(port_out + "_acc_v2.png")


def test_defaults_are_the_card_and_a_path_under_the_root(root, monkeypatch):
    seen = {}

    def fake_run_all(ds_name, epochs, batch_size, **kw):
        seen.update(kw, ds_name=ds_name)
        return {"_total_secs": 0}

    monkeypatch.setattr(trsd, "run_all", fake_run_all)
    monkeypatch.setattr(trsd, "postprocess",
                        lambda ds, out, epochs=None: seen.update(out=out))
    trsd.main(["--methods", "SI"])
    assert seen["device"] == "cuda"
    assert seen["ds_name"] == "synthetic_10t_10c_64px"
    assert seen["out"] == os.path.join(str(root / "root"), "survey",
                                       "survey_demo")
    assert not os.path.realpath(seen["out"]).startswith(
        os.path.join(REPO, "docs"))


def test_without_a_card_the_sweep_raises(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        trsd.run_all(DS, 1, 32, only={"finetuning"})
