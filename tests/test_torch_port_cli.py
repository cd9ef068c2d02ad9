"""clsurvey_torch's CLI against clsurvey_tpu's on the CPU, and the port's
import boundary.

- the finetuning CLI on synthetic_2t_4c_32px (2 epochs, ``--device cpu``)
  leaves the same directory tree as the JAX CLI (but for the JAX package's
  compilation cache and Orbax resume directories), and its best models load
  with ``clsurvey_tpu.utils.io`` and score, under the JAX backbone, the
  val accuracy the port recorded (within one val sample);
- importing every ``clsurvey_torch`` module loads no JAX, flax, optax or
  ``clsurvey_tpu`` module;
- asking for ``cuda`` without a card raises, and the flags of later slices
  raise ``NotImplementedError``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.framework import main as tmain
from clsurvey_torch.utils import config as tconfig
from clsurvey_tpu.data import registry as jdata
from clsurvey_tpu.framework.common import RunArgs as JRunArgs
from clsurvey_tpu.framework.main import main as jmain
from clsurvey_tpu.models import heads as jheads, registry as jreg
from clsurvey_tpu.ops import preprocess as jpp
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
        "('jax', 'jaxlib', 'flax', 'optax', 'clsurvey_tpu'))\n"
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


@pytest.mark.parametrize("extra,match", [
    (["--test"], "evaluate.py"), (["--profile"], "profiling"),
    (["--method_name", "EWC"], "methods")])
def test_later_slices_raise(extra, match):
    with pytest.raises(NotImplementedError, match=match):
        tmain.cli(ARGV + ["--device", "cpu"] + extra)


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
