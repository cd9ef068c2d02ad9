"""clsurvey_torch's rehearsal methods against clsurvey_tpu's on the CPU
(tiny_CNN at 32 px, float32, inputs made from numpy seeds):

- the ring buffer over a sequence of batches that fills and wraps it, and
  ``fill_buffer_from_data`` with one seed: images, labels, counts and the
  ring position equal;
- herding order on features whose costs are well separated, and the class
  means: equal;
- GEM's memory gradients of two past tasks (one buffer full, one partly
  filled; one chunk and chunks with a remainder), the port's flat layout
  cut back into the JAX layout: rtol 1e-4 (atol 1e-7 for entries near 0,
  about 1e-6 of the largest); the chunk GEM's run takes: 128 rows with
  batch-norm, at most 1,024 without;
- one GEM step at task 3 (two QP constraints), one replay step at task 3
  per baseline (per-task rows and a remainder row), one iCaRL step at task
  3, with the JAX run's draws handed to the port (no augmentation, no
  dropout): params and momentum within 1e-5, the memory after the step
  equal;
- an iCaRL two-task sequence trained by the JAX package, evaluated by the
  port's CLI (NCM heads synthesized by the port): ``seq_res`` /
  ``seq_forgetting`` within 1e-4, per-class counters equal;
- memories and exemplar stores from each package's files in the other's:
  equal arrays and dtypes."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.framework import main as tmain
from clsurvey_torch.methods import rehearsal as treh
from clsurvey_torch.models import registry as treg
from clsurvey_torch.ops import herding as therd
from clsurvey_torch.utils import config as tconfig, io as tio
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.framework.common import RunArgs as JRunArgs
from clsurvey_tpu.framework.main import main as jmain
from clsurvey_tpu.methods import rehearsal as jreh
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.ops import herding as jherd
from clsurvey_tpu.utils import config as jconfig, io as jio

MODEL, PX = "tiny_CNN_cl_32_32", 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
COUNTS = [4, 3, 4]
NEG_INF = -1e10


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


def _memory(rng, n_mem=24, counts=(24, 17, 0), cnt=5) -> dict:
    """A numpy memory in the on-disk layout, labels within each task's
    classes."""
    labels = np.stack([rng.integers(0, c, n_mem) for c in COUNTS])
    return {"mem_images": rng.integers(0, 256, (3, n_mem, PX, PX, 3),
                                       dtype=np.uint8),
            "mem_labels": labels.astype(np.int32),
            "mem_count": np.asarray(counts, np.int32),
            "mem_cnt": np.int32(cnt)}


def _assert_memory_equal(port_mem: dict, jax_mem: dict):
    got, want = treh.memory_to_host(port_mem), jio.to_host(jax_mem)
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ring_buffer_fills_and_wraps_like_the_jax_one():
    rng = np.random.default_rng(0)
    mem = _memory(rng, n_mem=8, counts=(8, 3, 0), cnt=3)
    mem_j, mem_t = _jnp(mem), treh.memory_on(mem, "cpu")
    for bsz in (5, 7, 5, 7):  # fills, wraps, writes a prefix, wraps
        x = rng.integers(0, 256, (bsz, PX, PX, 3), dtype=np.uint8)
        y = rng.integers(0, 3, bsz)
        mem_j = jreh.ring_buffer_update(mem_j, 1, jnp.asarray(x),
                                        jnp.asarray(y))
        mem_t = treh.ring_buffer_update(mem_t, 1, torch.from_numpy(x),
                                        torch.from_numpy(y))
        _assert_memory_equal(mem_t, mem_j)
    assert isinstance(mem_t["mem_cnt"], int)  # the position stays on host


@pytest.mark.parametrize("n_rows", [5, 40])
def test_fill_buffer_from_data_matches(n_rows):
    rng = np.random.default_rng(n_rows)
    images = rng.integers(0, 256, (n_rows, PX, PX, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, n_rows).astype(np.int32)
    mem_j = jreh.fill_buffer_from_data(
        jreh.fresh_task_memory(3, 24, (PX, PX)), 0, images, labels, seed=7)
    mem_t = treh.fill_buffer_from_data(
        treh.fresh_task_memory(3, 24, (PX, PX)), 0, images, labels, seed=7)
    _assert_memory_equal(mem_t, mem_j)


def test_herding_order_and_class_means_match():
    rng = np.random.default_rng(0)
    # distinct scales per row: the greedy costs are far apart at every step
    feats = (rng.normal(0, 1, (60, 16))
             * rng.uniform(0.5, 3.0, (60, 1))).astype(np.float32)
    want = np.asarray(jherd.herd(jnp.asarray(feats), jnp.ones(60), 25))
    got = therd.herd(torch.from_numpy(feats), torch.ones(60), 25)
    assert got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)
    labels = rng.integers(0, 5, 60)
    (m_j, c_j), (m_t, c_t) = (
        jherd.class_means(jnp.asarray(feats), jnp.asarray(labels), 6),
        therd.class_means(torch.from_numpy(feats), torch.from_numpy(labels),
                          6))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def _setup(rule_j, rule_t, task: int):
    """(JAX ctx, port ctx, numpy model) at ``task`` (0-based), without
    augmentation."""
    spec = jreg.parse_model_name("", MODEL, (PX, PX))
    model = jio.to_host(jreg.init_model_state(
        spec, jax.random.PRNGKey(3), max_tasks=3, classes_per_task=4,
        class_counts=COUNTS))
    common = dict(task=task, n_tasks=task + 1, class_counts=COUNTS,
                  mean=MEAN, std=STD, augment=False)
    ctx_j = jtrain.make_context(spec, update_rule=rule_j, mesh=None,
                                **common)
    ctx_t = ttrain.make_context(treg.parse_model_name("", MODEL, (PX, PX)),
                                update_rule=rule_t, device="cpu", **common)
    return ctx_j, ctx_t, model


def _trainable(model):
    return {"params": model["params"],
            "heads": {k: model["heads"][k] for k in ("kernel", "bias")}}


@pytest.mark.parametrize("mem_batch", [24, 7])
def test_gem_memory_grads_match_on_the_port_layout(mem_batch):
    mem = _memory(np.random.default_rng(1))
    rule_j = jreh.GEMRule(24, mem_batch=mem_batch)
    rule_t = treh.GEMRule(24, mem_batch=mem_batch)
    ctx_j, ctx_t, model = _setup(rule_j, rule_t, task=2)
    tr = _trainable(model)
    ms_j = rule_j.init_state(_jnp(tr), {"margin": 0.5}, ctx_j,
                             memory=_jnp(mem))
    want = np.asarray(rule_j._memory_grads_all(ctx_j, _jnp(tr), {}, ms_j,
                                               jax.random.PRNGKey(0)))
    tr_t = ttrain.trainable_from_host(tr, "cpu", requires_grad=True)
    ms_t = rule_t.init_state(None, {"margin": 0.5}, ctx_t, memory=mem)
    got = rule_t.memory_grads(ctx_t, tr_t, {}, ms_t)
    assert got.shape == want.shape == (2, want.shape[1])
    for row_t, row_j in zip(got, want):
        back = ttrain.trainable_to_host(treh._unflat(tr_t, row_t))
        np.testing.assert_allclose(np.asarray(ravel_pytree(back)[0]), row_j,
                                   rtol=1e-4, atol=1e-7)
    assert np.abs(want).max() > 1e-3


def test_gem_chunks_128_rows_with_batch_norm_and_at_most_1024_without():
    assert treh.gem_chunk_rows(24, batch_norm=False) == 24
    assert treh.gem_chunk_rows(5000, batch_norm=False) == 1024
    assert treh.gem_chunk_rows(1024, batch_norm=True) == 128
    assert treh.gem_chunk_rows(24, batch_norm=True) == 24


def _steps(rule_j, rule_t, task, init_kw, hyper, draws=None, lr=0.05,
           bsz=16):
    """One train step in both packages from one numpy state; ``draws``
    (the JAX run's, made from its key) are handed to the port's rule."""
    ctx_j, ctx_t, model = _setup(rule_j, rule_t, task)
    tr = _trainable(model)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (bsz, PX, PX, 3), dtype=np.uint8)
    y = rng.integers(0, COUNTS[task], (bsz,)).astype(np.int32)
    st_j = jtrain.TrainState(
        _jnp(tr), {}, jtrain.tree_zeros_like(_jnp(tr)),
        rule_j.init_state(_jnp(tr), hyper, ctx_j,
                          **{k: _jnp(v) for k, v in init_kw.items()}))
    new_j, m_j = jax.jit(jtrain.Engine(ctx_j)._train_step)(
        st_j, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0),
        jnp.float32(lr))
    if draws is not None:
        rule_t.draw = lambda *args: draws
    tr_t = ttrain.trainable_from_host(tr, "cpu", requires_grad=True)
    st_t = ttrain.TrainState(
        tr_t, {}, ttrain.tree_zeros_like(tr_t),
        rule_t.init_state(None, hyper, ctx_t, **init_kw))
    new_t, m_t = ttrain.Engine(ctx_t)._train_step(
        st_t, torch.from_numpy(x), torch.from_numpy(y).long(), lr)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    for attr in ("trainable", "momentum"):
        got = ttrain.trainable_to_host(getattr(new_t, attr))
        for key_path, want in jax.tree_util.tree_flatten_with_path(
                jio.to_host(getattr(new_j, attr)))[0]:
            g = got
            for k in key_path:
                g = g[k.key]
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(key_path))
    return new_j, m_j, new_t, m_t


def _extra_key():
    """The key the JAX step hands ``extra_loss`` for PRNGKey(0)."""
    _, rng_step = jax.random.split(jax.random.PRNGKey(0))
    return jax.random.split(rng_step)[1]


def test_one_gem_step_at_task_3_matches():
    mem = _memory(np.random.default_rng(2))
    new_j, m_j, new_t, m_t = _steps(
        jreh.GEMRule(24, mem_batch=7), treh.GEMRule(24, mem_batch=7), 2,
        {"memory": mem}, {"margin": 0.5})
    assert float(m_t["projected"]) == float(m_j["projected"]) == 1.0
    _assert_memory_equal(new_t.mstate["memory"], new_j.mstate["memory"])


@pytest.mark.parametrize("per_task_mem", [None, 10])
def test_one_replay_step_at_task_3_matches(per_task_mem):
    mem = _memory(np.random.default_rng(3))
    n_append, t = 5, 2
    base, rem = treh._exemplar_split(n_append, t)
    assert (base, rem) == jreh._exemplar_split(n_append, t) == (2, 1)
    # the JAX rule's draws (ReplayRule.extra_loss, _sample_remainder_rows)
    limit = jnp.maximum(jnp.asarray(mem["mem_count"][:t]), 1)
    if per_task_mem is not None:
        limit = jnp.minimum(limit, per_task_mem)
    rng, idx = _extra_key(), []
    for tt in range(t):
        rng, r_idx, _, _ = jax.random.split(rng, 4)
        idx.append(torch.tensor(np.asarray(jax.random.randint(
            r_idx, (base,), 0, limit[tt]))).long())
    _, r_s, _, _ = jax.random.split(rng, 4)
    r_task, r_idx = jax.random.split(r_s)
    tasks = jax.random.randint(r_task, (rem,), 0, t)
    slots = jnp.floor(jax.random.uniform(r_idx, (rem,))
                      * limit[tasks]).astype(jnp.int32)
    draws = {"idx": idx, "rem_task": torch.tensor(np.asarray(tasks)).long(),
             "rem_idx": torch.tensor(np.asarray(slots)).long(),
             "masks": [(None, None)] * (t + 1)}
    new_j, _, new_t, _ = _steps(
        jreh.ReplayRule(24, n_append, per_task_mem),
        treh.ReplayRule(24, n_append, per_task_mem), 2, {"memory": mem}, {},
        draws=draws)
    _assert_memory_equal(new_t.mstate["memory"], new_j.mstate["memory"])


def _exemplar_store(rng, K=24, count=20) -> dict:
    """A numpy store of tasks 1-2's exemplars whose targets are masked to
    each row's class region, padded to the full shared width."""
    task_ids = rng.integers(0, 2, K).astype(np.int32)
    labels = np.asarray([4 * t + rng.integers(0, COUNTS[t])
                         for t in task_ids], np.int32)
    targets = np.full((K, 12), NEG_INF, np.float32)
    for r, t in enumerate(task_ids):
        targets[r, 4 * t: 4 * t + COUNTS[t]] = rng.normal(0, 2, COUNTS[t])
    return {"images": rng.integers(0, 256, (K, PX, PX, 3), dtype=np.uint8),
            "targets": targets, "labels": labels, "task_ids": task_ids,
            "count": np.int32(count)}


def test_one_icarl_step_at_task_3_matches():
    store = _exemplar_store(np.random.default_rng(4))
    n_append = 6
    r_idx = jax.random.split(_extra_key(), 3)[0]
    idx = jax.random.randint(r_idx, (n_append,), 0, jnp.int32(20))
    draws = {"idx": torch.tensor(np.asarray(idx)).long(),
             "masks": (None, None)}
    _, _, new_t, m_t = _steps(
        jreh.ICarlRule(n_append), treh.ICarlRule(n_append), 2,
        {"exemplars": store}, {"lambda": 1.0}, draws=draws, lr=0.01)
    assert new_t.mstate["exemplars"]["count"] == 20


def _use(root):
    os.environ["CLSURVEY_ROOT"] = str(root)
    for mod in (jconfig, tconfig):
        mod.set_config(None)
        mod.load_config(refresh=True)


DS = "synthetic_2t_4c_32px_nz50"
TRAIN = dict(model_name=MODEL, ds_name=DS, num_epochs=2, batch_size=32,
             lr_grid=(1e-2,), boot_lr_grid=(1e-2,))
ARGV = [MODEL, "--ds_name", DS, "--num_epochs", "2", "--batch_size", "32",
        "--lr_grid", "1e-2", "--boot_lr_grid", "1e-2", "--device", "cpu"]


def _results(root, method):
    parent = os.path.join(str(root), "results", "test", "results", DS,
                          method, MODEL, "demo")
    (exp,) = os.listdir(parent)
    return {fn: jio.load(os.path.join(parent, exp, fn))
            for fn in sorted(os.listdir(os.path.join(parent, exp)))}


@pytest.fixture(scope="module")
def jax_icarl(tmp_path_factory):
    """The JAX package dumps its SI base model, then trains and evaluates
    iCaRL (8 exemplars per task) on two tasks; returns (root, results)."""
    old = os.environ.get("CLSURVEY_ROOT")
    root = tmp_path_factory.mktemp("jax_icarl")
    _use(root)
    jmain(JRunArgs(method_name="SI", runmode="first_task_basemodel_dump",
                   **TRAIN))
    jmain(JRunArgs(method_name="ICARL", static_hyperparams="8",
                   max_attempts_per_task=1, test=True, **TRAIN))
    yield root, _results(root, "ICARL")
    if old is not None:
        os.environ["CLSURVEY_ROOT"] = old
    jconfig.set_config(None)
    tconfig.set_config(None)


def test_the_port_evaluates_a_jax_trained_icarl_sequence(jax_icarl,
                                                         tmp_path, capsys):
    root, want = jax_icarl
    shutil.copytree(root, tmp_path / "port", symlinks=True,
                    ignore=shutil.ignore_patterns("test", "jax_cache"))
    _use(tmp_path / "port")
    tmain.cli(ARGV + ["--method_name", "ICARL", "--static_hyperparams", "8",
                      "--max_attempts_per_task", "1", "--test"])
    out = capsys.readouterr().out
    assert "epoch 0:" not in out  # nothing trained, nothing herded again
    got = _results(tmp_path / "port", "ICARL")
    assert sorted(got) == sorted(want)
    for fn, w in want.items():
        g, w = got[fn]["ICARL"], w["ICARL"]
        for key in ("seq_res", "seq_forgetting"):
            assert list(g[key]) == list(w[key])
            for i in w[key]:
                np.testing.assert_allclose(g[key][i], w[key][i], rtol=0,
                                           atol=1e-4)
        assert g["seq_per_class"] == w["seq_per_class"]
    _use(root)


def test_memories_and_exemplars_cross_between_packages(jax_icarl, tmp_path):
    root, _ = jax_icarl
    # a JAX-written exemplar store (task 2's postprocessed best model)
    (path,) = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
               if f == "best_model_postprocessed.pth.tar"]
    ex = jio.load(path)["method_aux"]["exemplars"]
    back = treh.exemplars_to_host(treh.exemplars_on(tio.load(path)[
        "method_aux"]["exemplars"], "cpu"))
    assert int(back["count"]) == int(ex["count"]) > 0
    for k in ex:
        assert np.asarray(back[k]).dtype == np.asarray(ex[k]).dtype, k
        np.testing.assert_array_equal(back[k], ex[k])

    # a memory the port wrote, read by the JAX package, and back
    rng = np.random.default_rng(5)
    mem_t = treh.memory_on(_memory(rng), "cpu")
    mem_t = treh.ring_buffer_update(
        mem_t, 2, torch.from_numpy(rng.integers(0, 256, (3, PX, PX, 3),
                                                dtype=np.uint8)),
        torch.tensor([0, 1, 2]))
    tio.save({"method_aux": {"memory": treh.memory_to_host(mem_t)}},
             str(tmp_path / "m.pth"))
    mem_j = jax.tree_util.tree_map(
        jnp.asarray, jio.load(str(tmp_path / "m.pth"))["method_aux"]["memory"])
    _assert_memory_equal(mem_t, mem_j)
    x = rng.integers(0, 256, (4, PX, PX, 3), dtype=np.uint8)
    mem_j = jreh.ring_buffer_update(mem_j, 2, jnp.asarray(x),
                                    jnp.arange(4))
    jio.save({"memory": mem_j}, str(tmp_path / "j.pth"))
    mem_t = treh.ring_buffer_update(
        treh.memory_on(tio.load(str(tmp_path / "m.pth"))["method_aux"][
            "memory"], "cpu"), 2, torch.from_numpy(x), torch.arange(4))
    _assert_memory_equal(
        treh.memory_on(tio.load(str(tmp_path / "j.pth"))["memory"], "cpu"),
        mem_j)
    _assert_memory_equal(mem_t, mem_j)


@pytest.mark.parametrize("task", [1, 2])
def test_a_lost_memory_is_loud_from_task_2_on(task, recwarn):
    """A previous model without ``method_aux``: at task 1 it is the shared
    base model or a fresh init and a fresh memory is right; from task 2 on
    the method trained it itself, so the fresh memory loses every earlier
    task's replay, and a warning names the file."""
    import types

    lines = []
    manager = types.SimpleNamespace(
        task_counter=task, log=lines.append,
        previous_task_model_path="/runs/task_1/best_model.pth.tar")
    fresh = {"mem_cnt": 0}
    assert treh._load_memory(manager, {"params": {}}, lambda: fresh) is fresh
    warned = [str(w.message) for w in recwarn.list
              if issubclass(w.category, RuntimeWarning)]
    if task == 1:
        assert not warned and not lines
    else:
        assert len(warned) == 1 and warned == lines
        assert "/runs/task_1/best_model.pth.tar" in warned[0]
        assert "method_aux['memory']" in warned[0]
    # a model that carries its memory loads it, silently
    kept = {"mem_cnt": 5}
    assert treh._load_memory(manager, {"method_aux": {"memory": kept}},
                             lambda: fresh) is kept
    assert len(lines) == (task > 1)
