"""clsurvey_torch's other survey scripts against the JAX package's, on the
CPU.

- the timing table: both scripts' ``collect`` over one tree of
  ``phase_timing.pth.tar`` files give the same table but for the title
  line, which names the device (CPU here), in each case of
  ``tests/test_timing_mode_script.py`` (per-task rows and dashes, a
  collect-only run without artifacts, an unknown method refused);
- the family report: both scripts' ``build_report`` give equal lines and
  checks in each case of ``tests/test_family_report.py``; the port's
  ``main`` takes the rows and the output path and refuses ``docs/``;
- the three protocol scripts: run with a ``python`` that records its
  arguments, each port script's command lines are the JAX script's with
  ``clsurvey_torch.framework.main`` for ``clsurvey_tpu.framework.main`` and
  ``--device`` (``cuda`` unless ``DEVICE`` says otherwise) at the end;
- the port's survey script renders a results tree the JAX CLI wrote
  (finetuning and joint) to the JAX script's table."""

import json
import os
import subprocess
import sys

import pytest

import scripts.hd200_family_report as jfam
import scripts.run_survey_demo as jrsd
import scripts.run_timing_mode as jtim
from clsurvey_torch.scripts import hd200_family_report as tfam
from clsurvey_torch.scripts import run_survey_demo as trsd
from clsurvey_torch.scripts import run_timing_mode as ttim
from clsurvey_torch.utils import config as tconfig
from clsurvey_tpu.framework.common import RunArgs as JRunArgs
from clsurvey_tpu.framework.main import main as jmain
from clsurvey_tpu.utils import config as jconfig, io as jio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def root(tmp_path, monkeypatch):
    """One CLSURVEY_ROOT that both packages' configs read."""
    monkeypatch.setenv("CLSURVEY_ROOT", str(tmp_path / "root"))
    for cfg in (tconfig, jconfig):
        cfg.set_config(None)
    yield jconfig.load_config(refresh=True)
    for cfg in (tconfig, jconfig):
        cfg.set_config(None)


# --- timing table ------------------------------------------------------------

def _plant(cfg, ds, method, task, times):
    d = os.path.join(cfg.tr_results_root_path, ds, method, jtim.MODEL,
                     "gridsearch", jtim.GRID, "lam=1", task)
    os.makedirs(d, exist_ok=True)
    jio.save(times, os.path.join(d, "phase_timing.pth.tar"))


def _tables(tmp_path, run):
    """``run(script, out)`` for both scripts; their tables, split into the
    title line and the rest, and their status files."""
    out = {}
    for side, script in (("jax", jtim), ("port", ttim)):
        stem = str(tmp_path / side / "timing")
        os.makedirs(os.path.dirname(stem), exist_ok=True)
        run(script, stem)
        lines = open(stem + ".md").read().split("\n")
        out[side] = (lines[0], lines[1:],
                     json.load(open(stem + "_status.json")))
    return out


def timing_collect_builds_table(root, tmp_path):
    ds = "synthetic_4t_5c_64px"
    _plant(root, ds, "SI", "task_2",
           {"phase1": 12.5, "presteps": 0.0,
            "convergence_iteration": 30.25, "postprocess": 1.0})
    _plant(root, ds, "SI", "task_3",
           {"phase1": 11.0, "convergence_iteration": 29.0,
            "postprocess": None})
    statuses = {"SI": {"ok": True, "secs": 123},
                "EWC": {"ok": False, "error": "boom", "secs": 4}}

    def run(script, stem):
        kw = {"device": "cpu"} if script is ttim else {}
        script.collect(ds, ["SI", "EWC"], statuses, stem, **kw)

    got = _tables(tmp_path, run)
    assert "| SI | task_2 | 12.5 | 0.0 | 30.2 | 1.0 | 123 |" in \
        got["port"][1]
    assert "|  | task_3 | 11.0 | — | 29.0 | — |  |" in got["port"][1]
    assert "| EWC | — | | | | | 4 |" in got["port"][1]
    return got


def timing_collect_only_without_artifacts(root, tmp_path):
    def run(script, stem):
        argv = ["--collect_only", "--methods", "SI", "--out", stem]
        script.main(argv + (["--device", "cpu"] if script is ttim else []))

    return _tables(tmp_path, run)


@pytest.mark.parametrize("case", [timing_collect_builds_table,
                                  timing_collect_only_without_artifacts],
                         ids=["collect_builds_table",
                              "collect_only_without_artifacts"])
def test_timing_table_matches_the_jax_scripts(case, root, tmp_path):
    got = case(root, tmp_path)
    assert got["port"][1:] == got["jax"][1:]
    assert got["jax"][0] == \
        "# timing_mode — per-phase wall-clock (real TPU v5e)"
    assert got["port"][0] == "# timing_mode — per-phase wall-clock (CPU)"


def test_timing_unknown_method_rejected(tmp_path):
    for script in (jtim, ttim):
        with pytest.raises(SystemExit) as e:
            script.main(["--collect_only", "--methods", "nope", "--out",
                         str(tmp_path / "x")])
        assert e.value.code == 2
    assert ttim.METHODS == jtim.METHODS


def test_timing_default_out_is_under_the_root(root, monkeypatch):
    seen = {}
    monkeypatch.setattr(ttim, "collect",
                        lambda ds, methods, statuses, out, device:
                        seen.update(out=out, device=device, ds=ds))
    ttim.main(["--collect_only", "--methods", "finetuning"])
    assert seen == {"out": os.path.join(os.environ["CLSURVEY_ROOT"],
                                        "survey", "timing_mode"),
                    "device": "cuda", "ds": "synthetic_10t_20c_64px_400n"}


def test_timing_run_without_a_card_raises(root):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttim.run("synthetic_2t_4c_32px", ["finetuning"], 1)
    # the title's device line asks nvidia-smi, never says CPU for cuda
    from clsurvey_torch.utils.device import describe

    with pytest.raises((FileNotFoundError, subprocess.CalledProcessError)):
        describe("cuda")


# --- family report -----------------------------------------------------------

def _row(acc, forg):
    return {"exp": "x", "avg_acc": acc, "avg_forgetting": forg}


FULL = {
    "joint": _row(59.0, None),
    "finetuning": _row(46.8, 7.9),
    "EWC": _row(45.1, 0.6), "SI": _row(44.2, 1.3),
    "MAS": _row(44.1, -0.6),
    "LWF": _row(46.8, -1.6), "EBLL": _row(45.5, -0.5),
    "mean_IMM": _row(43.8, -6.9), "mode_IMM": _row(44.2, -4.0),
    "GEM": _row(46.5, 0.2), "ICARL": _row(47.0, -2.0),
    "finetuning_rehearsal_partial_mem": _row(46.0, -1.0),
    "finetuning_rehearsal_full_mem": _row(46.2, -1.2),
    "packnet": _row(43.0, 0.0), "HAT": _row(42.0, 0.0),
    "pathnet": _row(40.0, 0.0),
}
VIOLATING = {**FULL, "joint": _row(40.0, None), "EWC": _row(45.1, 9.9),
             "packnet": _row(43.0, 3.0)}
PARTIAL = {k: FULL[k] for k in ("joint", "finetuning", "EWC", "SI", "MAS",
                                "LWF")}


@pytest.mark.parametrize("rows,want", [
    (FULL, {f"F{i}": True for i in range(1, 8)}),
    (VIOLATING, {"F1": False, "F2": False, "F4": False, "F6": False}),
    (PARTIAL, {"F1": True, "F2": True, "F4": True, "F5": True})],
    ids=["full_conforming", "violations", "partial"])
def test_family_report_matches_the_jax_scripts(rows, want):
    got = tfam.build_report(rows)
    assert got == jfam.build_report(rows)
    checks = {fid: ok for fid, _, ok in got[1]}
    assert {k: checks.get(k) for k in want} == want
    if rows is PARTIAL:
        assert not {"F3", "F6", "F7"} & set(checks)
    assert tfam.FAMILIES == jfam.FAMILIES


def test_family_report_main_writes_where_told_and_never_docs(tmp_path):
    rows_path = tmp_path / "rows.json"
    rows_path.write_text(json.dumps(FULL))
    out = tmp_path / "report" / "family.md"
    tfam.main([str(rows_path), str(out)])
    assert out.read_text() == "\n".join(jfam.build_report(FULL)[0]) + "\n"
    docs = os.path.join(REPO, "docs", "hd200_family.md")
    before = open(docs).read()
    with pytest.raises(SystemExit) as e:
        tfam.main([os.path.join(REPO, "docs", "soak_hd200_rows.json"),
                   docs])
    assert e.value.code == 2 and open(docs).read() == before


# --- the three protocol scripts ---------------------------------------------

def _commands(script, tmp_path, args, env_extra=None):
    """The argument lists ``script`` hands ``python``, run with a
    ``python`` on PATH that records them instead."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    log = tmp_path / "calls.jsonl"
    log.write_text("")
    fake = bin_dir / "python"
    fake.write_text(f"#!{sys.executable}\nimport json, sys\n"
                    f"open({str(log)!r}, 'a').write("
                    "json.dumps(sys.argv[1:]) + '\\n')\n")
    fake.chmod(0o755)
    env = {k: v for k, v in os.environ.items() if k != "DEVICE"}
    env.update(PATH=f"{bin_dir}:{env['PATH']}", **(env_extra or {}))
    subprocess.run(["bash", os.path.join(REPO, script), *args], env=env,
                   check=True, timeout=60)
    return [json.loads(line) for line in log.read_text().splitlines()]


@pytest.mark.parametrize("protocol", ["tinyimagenet", "inaturalist",
                                      "recogseq"])
@pytest.mark.parametrize("args,device", [([], None), (["EWC"], None),
                                         (["MAS", "small_VGG9_cl_128_128"],
                                          "cpu")])
def test_shell_scripts_run_the_jax_commands_on_the_port(protocol, args,
                                                        device, tmp_path):
    jax = _commands(f"scripts/main_{protocol}.sh", tmp_path, args)
    port = _commands(f"clsurvey_torch/scripts/main_{protocol}.sh", tmp_path,
                     args, device and {"DEVICE": device})
    assert len(jax) == 2
    want = [["-m", "clsurvey_torch.framework.main"] + cmd[2:]
            + ["--device", device or "cuda"] for cmd in jax]
    assert all(cmd[:2] == ["-m", "clsurvey_tpu.framework.main"]
               for cmd in jax)
    assert port == want


# --- the port rendering a JAX-written tree ----------------------------------

def test_the_port_renders_a_jax_written_tree_alike(root, tmp_path,
                                                   monkeypatch):
    import time

    real = time.strftime  # both scripts stamp rows with today's date
    monkeypatch.setattr(time, "strftime",
                        lambda fmt, *a: "2026-01-02" if not a
                        else real(fmt, *a))
    ds = "synthetic_2t_4c_32px"
    for method in ("finetuning", "joint"):
        jmain(JRunArgs(model_name="tiny_CNN_cl_32_32", ds_name=ds,
                       method_name=method, num_epochs=1, batch_size=32,
                       lr_grid=(1e-2,), gridsearch_name=jrsd.GRID,
                       test=True))
    for rsd in (jrsd, trsd):
        monkeypatch.setattr(rsd, "MODEL", "tiny_CNN_cl_32_32")
    outs = {side: str(tmp_path / side / "survey_demo")
            for side in ("jax", "port")}
    jrsd.postprocess(ds, outs["jax"], epochs=1)
    entries, _ = trsd.postprocess(ds, outs["port"], epochs=1)
    assert sorted(e.eval_name for e in entries) == ["finetuning", "joint"]
    for suffix in (".md", "_rows.json", "_summary.txt", "_canonical.json"):
        assert open(outs["port"] + suffix).read() == \
            open(outs["jax"] + suffix).read(), suffix
    assert os.path.getsize(outs["port"] + "_acc.png") > 0
