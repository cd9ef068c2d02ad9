"""clsurvey_torch's data parallel (``clsurvey_torch/parallel/mesh.py``) on
the CPU: dp-2, two processes in a gloo group, against dp-1, one process
without a group, and against the JAX package's 2-device mesh.

The scenarios live in ``tests/torch_dp_scenarios.py`` (torch only). One
spawn of three processes serves every check: dp-1, and the two ranks of
dp-2, which meet at a ``file://`` store in the test's directory (no TCP
port to collide under xdist), each on one thread and under a wall-clock
limit; every group has a timeout. Inside the ranks each final state goes
through ``assert_replicated``, which raises when the ranks drifted apart.

Tolerances. dp-2 differs from dp-1 only in the order of float32 sums (each
rank's half-batch sums, then the all-reduce; batch-norm's moments from
summed halves): over one epoch of four steps the gap measured up to 2.6e-5
of a tree's largest entry (GEM, whose QP projection amplifies it), so
trees are held within 1e-4 of their largest entry, metrics within 1e-5
relative, eval counters exactly. Batch-norm running statistics are held
within rtol 1e-3 as the JAX package's own dp test holds them
(``tests/test_models_bn_dp.py``). Against the JAX package's 2-device mesh
the same 1e-4 of a tree's largest entry holds (float32 throughout, the
permutation handed in, augmentation off)."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.ops import importance as timp
from clsurvey_torch.parallel import mesh as tmesh
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.methods.base import UpdateRule as JRule
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.parallel import mesh as jmesh
from clsurvey_tpu.utils import io as jio
from tests import torch_dp_scenarios as scn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["plain", "bn", "si", "gem", "replay", "icarl", "ebll",
         "importance", "evaluate", "streamed", "resident_padded", "hat",
         "pathnet", "drift", "cli"]
SPAWN_TIMEOUT_S = 240
TREE_REL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"dp1": results, "dp2": (rank 0's, rank 1's)} of every scenario."""
    out = str(tmp_path_factory.mktemp("dp"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    script = os.path.join(REPO, "tests", "torch_dp_scenarios.py")
    procs = [subprocess.Popen(
        [sys.executable, script, out, str(world), str(rank)] + NAMES,
        env=env, cwd=out, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for world, rank in ((1, 0), (2, 0), (2, 1))]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]

    def load(name):
        with open(os.path.join(out, name), "rb") as f:
            return pickle.load(f)

    return {"dp1": load("w1_r0.pkl"),
            "dp2": (load("w2_r0.pkl"), load("w2_r1.pkl"))}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _close_tree(got, want, rel=TREE_REL, what=""):
    """Every leaf within ``rel`` times the tree's largest entry."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want), what
    scale = max([float(np.abs(np.asarray(w, np.float64)).max())
                 for w in want.values() if np.size(w)] + [1e-30])
    for path, w in want.items():
        np.testing.assert_allclose(np.asarray(got[path], np.float64),
                                   np.asarray(w, np.float64), rtol=0,
                                   atol=rel * scale, err_msg=what + path)


def _equal_trees(a, b, what=""):
    for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=what + path)


def _close_state(got, want, what):
    """A scenario's results: trees within 1e-4 of their largest entry,
    batch-norm statistics within rtol 1e-3, metrics within 1e-5."""
    for key, w in want.items():
        g = got[key]
        if key == "metrics":
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           err_msg=f"{what} {k}")
        elif key == "batch_stats":
            for (p, x), (_, y) in zip(_leaves(g), _leaves(w)):
                np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-5,
                                           err_msg=what + p)
        elif key in ("memory", "val_acc", "acc", "pcc", "pct"):
            _equal_trees(g, w, f"{what} {key}")
        else:
            _close_tree(g, w, what=f"{what} {key}")


# ---------------------------------------------------------------------------
# pure functions, no group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd", [2, 8])
@pytest.mark.parametrize("bs,n", [(30, 1000), (5, 1000), (16, 1000),
                                  (64, 41), (1, 1000)])
def test_round_batch_matches_the_jax_engine(bs, n, nd):
    """Train batches round down to a multiple of the ranks, at least one
    row a rank, as the JAX engine's ``_round_batch`` on an nd-device mesh
    (30 -> 24 and 5 -> 8 at nd 8)."""
    spec = jreg.parse_model_name("", scn.NAME, (scn.PX, scn.PX))
    ctx = jtrain.make_context(
        spec, task=0, n_tasks=1, class_counts=[4, 4], mean=scn.MEAN,
        std=scn.STD, update_rule=JRule(),
        mesh=jmesh.make_mesh(jax.devices()[:nd]))
    assert tmesh.round_batch(bs, n, nd) == \
        jtrain.Engine(ctx)._round_batch(bs, n)
    assert tmesh.round_batch(bs, n, 1) == min(bs, n)


@pytest.mark.parametrize("bs,n,nd,want", [
    (30, 1000, 8, 32), (30, 1000, 2, 30), (5, 1000, 8, 8), (41, 41, 2, 42),
    (30, 1000, 1, 30), (64, 41, 8, 48)])
def test_round_eval_batch_rounds_up(bs, n, nd, want):
    """Eval batches round UP to a multiple of the ranks (the JAX engine's
    ``evaluate``: 30 -> 32 at nd 8); the padded rows weigh 0."""
    assert tmesh.round_eval_batch(bs, n, nd) == want


@pytest.mark.parametrize("size", [2, 3, 8])
def test_shard_slices_cover_every_row_once(size):
    """Contiguous ``[r*b/N, (r+1)*b/N)`` slices over the ranks, whose mean
    scales sum to 1; a batch of fewer rows than ranks goes whole to every
    rank, counted once."""
    group = object()
    for b in (1, 2, 7, 16, 41):
        shards = [tmesh.Mesh(r, size, group).shard(b) for r in range(size)]
        if b < size:
            assert all(s == (0, b, 1 / size, 1 / size) for s in shards)
            continue
        assert shards[0].lo == 0 and shards[-1].hi == b
        assert all(a.hi == c.lo for a, c in zip(shards, shards[1:]))
        assert all(s.sum_scale == 1.0 and s.hi > s.lo for s in shards)
        assert sum(s.mean_scale for s in shards) == pytest.approx(1.0)


def test_a_one_device_mesh_takes_todays_path(monkeypatch):
    """Without a group nothing is sliced, scaled or reduced, and an epoch
    with flips, dropout and batch-norm, an evaluation, and the EWC / MAS
    passes call no collective at all (they would raise here)."""
    def forbidden(*_a, **_k):
        raise AssertionError("a collective on a one-device mesh")

    for fn in ("all_reduce", "broadcast", "barrier", "init_process_group"):
        monkeypatch.setattr(torch.distributed, fn, forbidden)
    mesh = tmesh.Mesh()
    x = torch.arange(6.0)
    assert tmesh.constrain_batch(x, mesh) is x
    assert tmesh.share(x, mesh.batch_scale) is x
    assert mesh.shard(7) == (0, 7, 1.0, 1.0)
    ts = [x]
    assert tmesh.all_reduce_sum(ts, mesh) is ts
    assert tmesh.eval_rows(x, x, 2, 5, mesh)[2] is None
    assert tmesh.make_mesh("cpu") == mesh  # no torchrun environment
    torch.set_num_threads(1)
    name = scn.NAME + "_BN_DROP"
    ctx = scn.context(mesh, name, augment=True)
    state = ttrain.state_from_model(scn.model(name), None, "cpu")
    state.mstate = ctx.update_rule.init_state(None, {}, ctx)
    images, labels = scn.rows(32, 0)
    engine = ttrain.Engine(ctx)
    state, metrics = engine.train_epoch(
        state, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.arange(32), torch.Generator().manual_seed(1), 0.01, 16)
    assert np.isfinite(float(metrics["loss"]))
    engine.evaluate(state.trainable, state.batch_stats,
                    torch.from_numpy(images), labels, 30)
    m = scn.model(name)
    timp.ewc_fisher(ctx, state.trainable["params"], state.batch_stats,
                    m["heads"], 0, images, labels, 16)
    timp.mas_importance(ctx, state.trainable["params"], state.batch_stats,
                        m["heads"], 0, images[:8], chunk=8)


def test_make_mesh_refuses_cuda_without_a_card(monkeypatch):
    """Under a torchrun environment ``cuda`` without a card raises; it
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="cpu"):
        tmesh.make_mesh("cuda")


# ---------------------------------------------------------------------------
# dp-2 against dp-1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["plain", "bn", "si", "gem", "replay",
                                  "icarl", "ebll", "importance", "evaluate",
                                  "hat", "pathnet"])
def test_dp2_matches_dp1(runs, name):
    """Both ranks end bit-equal (each also held by ``assert_replicated``
    inside the run), and within the stated tolerance of dp-1."""
    r0, r1 = runs["dp2"]
    _equal_trees(r0[name], r1[name], f"{name} rank 0 vs rank 1")
    want = runs["dp1"][name]
    if name == "importance":
        for k in want:
            _close_tree(r0[name][k], want[k], what=f"importance {k}")
    else:
        _close_state(r0[name], want, name)


def test_dp2_streamed_epoch_matches_the_dp1_resident_epoch(runs):
    """A streamed epoch on two ranks (every rank gathers and copies the
    whole chunk, then runs its rows) equals the one-device resident epoch
    over the wrap-padded permutation."""
    _close_state(runs["dp2"][0]["streamed"], runs["dp1"]["resident_padded"],
                 "streamed")
    _close_state(runs["dp2"][0]["streamed"], runs["dp2"][0][
        "resident_padded"], "streamed vs resident on two ranks")


def test_assert_replicated_raises_on_every_rank(runs):
    assert runs["dp1"]["drift"]["raised"] is None
    for r in runs["dp2"]:
        assert "differ in [1] entries" in r["drift"]["raised"]


def test_cli_on_two_ranks(runs):
    """The finetuning CLI on two tasks: the same eval result dicts and the
    best model's batch-norm statistics, one set of files (the same names as
    the one-device run's, no temporary leftovers), all written by rank 0."""
    one = runs["dp1"]["cli"]
    r0, r1 = (r["cli"] for r in runs["dp2"])
    assert r0["results"] and r0["results"] == one["results"]
    assert r0["files"] == r1["files"] == one["files"]
    assert not any(f.endswith(".tmp") for f in r0["files"])
    assert r1["writes"] == 0 and r0["writes"] == one["writes"] > 0
    for (p, x), (_, y) in zip(_leaves(r0["best_batch_stats"]),
                              _leaves(one["best_batch_stats"])):
        np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-5, err_msg=p)


# ---------------------------------------------------------------------------
# dp-2 against the JAX package's 2-device mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["plain", "bn"])
def test_dp2_epoch_matches_the_jax_2_device_mesh(runs, name):
    """The port's dp-2 epoch against JAX's ``train_epoch`` on
    ``make_mesh(jax.devices()[:2])``, from the same numpy model, rows and
    permutation, augmentation off."""
    model_name = scn.NAME + ("_BN" if name == "bn" else "")
    spec = jreg.parse_model_name("", model_name, (scn.PX, scn.PX))
    mesh = jmesh.make_mesh(jax.devices()[:2])
    ctx = jtrain.make_context(
        spec, task=0, n_tasks=1, class_counts=[4], mean=scn.MEAN,
        std=scn.STD, update_rule=JRule(), augment=False, mesh=mesh)
    model = scn.model(model_name)
    state = jtrain.state_from_model(model, JRule().init_state(None, {},
                                                              ctx))
    state = jax.device_put(state, jmesh.replicated(mesh))
    images, labels = scn.rows(scn.N_TRAIN, 0)
    state, metrics = jtrain.Engine(ctx).train_epoch(
        state, jnp.asarray(images), jnp.asarray(labels),
        jnp.asarray(scn.perm(scn.N_TRAIN)), jax.random.PRNGKey(0), 0.05,
        scn.BS)
    got = runs["dp2"][0][name]
    _close_tree(got["trainable"], jio.to_host(state.trainable),
                what=f"{name} trainable")
    _close_tree(got["momentum"], jio.to_host(state.momentum),
                what=f"{name} momentum")
    stats = dict(_leaves(got["batch_stats"]))
    for p, y in _leaves(jio.to_host(state.batch_stats)):
        np.testing.assert_allclose(stats[p], y, rtol=1e-3, atol=1e-5,
                                   err_msg=p)
    np.testing.assert_allclose(got["metrics"]["loss"],
                               float(metrics["loss"]), rtol=1e-4)
