"""The benchmark's files and names: every entry of ``BENCHMARK.json``
resolves to its files by name, names and units keep to their characters,
the counts of operations and bytes are right, a cell added as data is
found without a code edit, and nothing the benchmark imports is JAX or the
JAX package."""

from __future__ import annotations

import ast
import json
import math
import os
import re
import subprocess
import sys

import pytest

from clbench import flops
from clbench.reference import net
from clbench.spec import PKG_DIR, REPO_DIR, Spec
from clbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "clsurvey_tpu"}
COMPARED = {"loss_gap", "head_grad_diff", "grad_diff", "grad_diff_worst",
            "change_gap_worst", "eval_logit_gap", "eval_hits_off"}


@pytest.fixture(scope="module")
def spec():
    return Spec()


def test_every_entry_resolves(spec):
    used = set()
    for cell in spec.bench["workloads"]:
        wl = spec.workload(cell["name"])
        cfg = spec.config(wl["config"])
        used.add(cfg["name"])
        assert cell["chips"] == 1
        for folder in ("methods", "reference/methods"):
            assert os.path.isfile(os.path.join(PKG_DIR, folder,
                                               f"{wl['method']}.py"))
        assert set(wl["limits"]) == COMPARED
        assert wl["limits"]["eval_hits_off"] == 0
        metrics = {m["name"] for m in spec.per_layer(cell["name"])}
        assert metrics, cell["name"]
        assert {"setup_s", "train_img_per_s"} <= {
            m["name"] for m in spec.end_to_end(cell["name"])}
    for cfg in spec.bench["configs"]:
        assert cfg["file"] == f"clbench/configs/{cfg['name']}.json"
        assert cfg["name"] in used
        assert cfg["reduced"] == spec.config(cfg["name"])["reduced"]
    for m in spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
        assert set(m["workloads"]) <= {w["name"] for w in
                                       spec.bench["workloads"]}


def test_names_and_units(spec):
    b = spec.bench
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    for name in names:
        assert NAME.match(name), name
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for k in ("workloads", "configs"):
        for x in b[k]:
            assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    assert len({m["layer"] for m in b["per_layer"]}) <= len(b["per_layer"])
    assert len(set(names[:len(names) - 2 * len(b["workloads"])])) == \
        len(names) - 2 * len(b["workloads"])
    assert os.path.getsize(os.path.join(REPO_DIR, "BENCHMARK.json")) \
        <= 64 << 10


@pytest.mark.parametrize("config,classes,gflop", [
    ("alexnet224", 25, 4.26116928), ("small_vgg9_64", 20, 0.468827136)])
def test_train_flops(spec, config, classes, gflop):
    cfg = (tiny.SMALL_VGG9 if config == tiny.SMALL_VGG9["name"]
           else spec.config(config))
    assert cfg["classes_per_task"] == classes
    assert flops.train_flops(cfg) == pytest.approx(gflop * 1e9, rel=1e-12)
    assert flops.train_flops(cfg, 1) == pytest.approx(
        gflop * 1e9 * 4 / 3, rel=1e-12)


def test_bytes():
    px = 224
    assert flops.preprocess_bytes(200, px, True) == \
        200 * px * px * 3 * 5 + 200
    assert flops.preprocess_bytes(50, px, False) == 50 * px * px * 3 * 5


def test_shapes_of_the_configurations(spec):
    alex = spec.config("alexnet224")
    assert net.feature_dim(alex) == 4096
    assert net.dropout_widths(alex) == [9216, 4096]
    shapes = net.param_shapes(alex)
    assert shapes["fc_0.weight"] == (4096, 9216)
    assert shapes["heads.kernel"] == (10, 4096, 25)
    # torchvision's AlexNet has 61,100,840 parameters, 4,097,000 of them
    # in its 1000-class layer, which the head bank replaces
    assert sum(math.prod(s) for k, s in shapes.items()
               if not k.startswith("heads.")) == 61100840 - 4097000
    vgg = tiny.SMALL_VGG9
    assert net.feature_dim(vgg) == 128
    assert [s for layer, s, _ in net.shapes(vgg) if layer["op"] == "fc"] \
        == [(2048,), (128,)]
    assert net.dropout_widths(vgg) == []


def test_a_cell_added_as_data_is_found(tmp_path):
    spec = tiny.make(str(tmp_path))
    for cell in tiny.CELLS:
        wl = spec.workload(cell)
        assert spec.config(wl["config"])["name"] == wl["config"]
        assert "mfu" in {m["name"] for m in spec.per_layer(cell)}
    with pytest.raises(KeyError):
        spec.workload("no-such-cell")


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(folder: str):
    for root, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources(PKG_DIR):
        assert not (_imports(path) & BANNED), path
    for path in _sources(os.path.join(PKG_DIR, "reference")):
        assert "clsurvey_torch" not in _imports(path), path


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run on the CPU, in a process of its own, leaves no
    module of JAX or the JAX package loaded, by whole top-level names."""
    code = (
        "import json, sys\n"
        "from clbench.tests import tiny\n"
        "from clbench import harness\n"
        f"spec = tiny.make({str(tmp_path)!r})\n"
        "harness.run(spec, 'tiny-vgg-finetune', 5, 0.01, False, "
        "device='cpu', log=lambda m: None)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        "print(json.dumps(harness.banned_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_DIR,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.splitlines()
    loaded = set(json.loads(out[-2]))
    assert "clsurvey_torch" in loaded
    assert not loaded & BANNED
    assert json.loads(out[-1]) == []
