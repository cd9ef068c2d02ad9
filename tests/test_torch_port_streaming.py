"""clsurvey_torch's streamed data path against clsurvey_tpu's on the CPU
(tiny_CNN at 32 px, float32), and against its own resident path:

- ``utils/rowgather.gather_rows``: numpy's result for 1 to 8 threads, into
  a given tensor, ``IndexError`` out of range, and the numpy route for the
  layouts the native route does not take, each call counted by route;
- a streamed epoch equals the resident epoch over the wrap-padded
  permutation with the same generator, flips (and dropout) on: exactly;
- ``train_epoch_chunked`` against the JAX package's on 96 and 100 rows
  (the second wrap-padded) in chunks of 48, augmentation off: rtol 1e-5,
  atol 1e-6 (``tests/test_streaming.py``'s); a feed of other rows refused;
- ``evaluate_chunked`` with a ragged last chunk: the resident counters and
  the JAX package's chunked ones, exactly;
- ``train_task`` over a split above the budget against the JAX package's,
  its permutations handed in: the same best val accuracy, the best model
  within atol 1e-5 (the engine tests' step tolerance);
- EWC's Fisher and MAS's omega (rtol 1e-4, atol 1e-7, the resident
  importance tests') and the mode-IMM Fisher with the JAX run's labels
  handed in (rtol 1e-3, atol 1e-8, the IMM test's) streamed in both
  packages;
- a streamed step's gradients belong to the step alone: dead when the
  next step starts (the card's streamed peak memory depends on it)."""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.data import registry as tdata
from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.methods.base import UpdateRule as TRule
from clsurvey_torch.models import registry as treg
from clsurvey_torch.models.convert import params_from_jax, params_to_jax
from clsurvey_torch.ops import importance as timp
from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils import rowgather
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.methods.base import UpdateRule as JRule
from clsurvey_tpu.models import heads as jheads, registry as jreg
from clsurvey_tpu.ops import importance as jimp, preprocess as jpp
from clsurvey_tpu.utils import io as jio

NAME, PX = "tiny_CNN_cl_32_32", 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
COUNTS = [4, 3]


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side on one thread: fast under the parallel test run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(name=NAME, seed=3):
    spec = jreg.parse_model_name("", name, (PX, PX))
    return jio.to_host(jreg.init_model_state(
        spec, jax.random.PRNGKey(seed), max_tasks=2, classes_per_task=4,
        class_counts=COUNTS))


def _contexts(name=NAME, augment=False, task=0):
    common = dict(task=task, n_tasks=1, class_counts=COUNTS, mean=MEAN,
                  std=STD, augment=augment)
    ctx_j = jtrain.make_context(jreg.parse_model_name("", name, (PX, PX)),
                                update_rule=JRule(), mesh=None, **common)
    ctx_t = ttrain.make_context(treg.parse_model_name("", name, (PX, PX)),
                                update_rule=TRule(), device="cpu", **common)
    return ctx_j, ctx_t


def _port_state(model, ctx_t):
    state = ttrain.state_from_model(model, None, "cpu")
    state.mstate = TRule().init_state(None, {}, ctx_t)
    return state


def _jax_state(model, ctx_j):
    tr = {"params": jax.tree_util.tree_map(jnp.array, model["params"]),
          "heads": {k: jnp.array(model["heads"][k])
                    for k in ("kernel", "bias")}}
    bs = jax.tree_util.tree_map(jnp.array, model.get("batch_stats", {}))
    return jtrain.TrainState(tr, bs, jtrain.tree_zeros_like(tr),
                             JRule().init_state(None, {}, ctx_j))


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, PX, PX, 3), dtype=np.uint8),
            rng.integers(0, 3, (n,)).astype(np.int32))


def _assert_close(port_tree, jax_tree, rtol, atol):
    for key_path, want in jax.tree_util.tree_flatten_with_path(
            jio.to_host(jax_tree))[0]:
        got = port_tree
        for k in key_path:
            got = got[k.key]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(key_path))


# ---------------------------------------------------------------------------
# rowgather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_threads", [1, 2, 3, 8])
def test_gather_rows_matches_numpy(n_threads):
    src, _ = _rows(50, seed=n_threads)
    idx = np.random.default_rng(n_threads).integers(0, 50, 37)
    rowgather.reset_routes()
    got = rowgather.gather_rows(src, idx, n_threads)
    np.testing.assert_array_equal(got, src[idx])
    assert got.flags["C_CONTIGUOUS"]
    out = torch.empty((37, PX, PX, 3), dtype=torch.uint8)
    assert rowgather.gather_rows(src, idx, n_threads, out=out) is out
    np.testing.assert_array_equal(out.numpy(), src[idx])
    assert rowgather.ROUTES == {"native": 2, "numpy": 0}
    with pytest.raises(IndexError):
        rowgather.gather_rows(src, np.array([0, 50]), n_threads)
    with pytest.raises(IndexError):
        rowgather.gather_rows(src, np.array([-1]), n_threads, out=out[:1])


def test_gather_rows_numpy_route_and_bad_out():
    src, _ = _rows(20)
    idx = np.array([3, 1, 19, 3])
    rowgather.reset_routes()
    as_float = src.astype(np.float32)
    np.testing.assert_array_equal(rowgather.gather_rows(as_float, idx),
                                  as_float[idx])
    strided = src[:, ::2]  # not C-contiguous
    out = torch.empty((4,) + strided.shape[1:], dtype=torch.uint8)
    rowgather.gather_rows(strided, idx, out=out)
    np.testing.assert_array_equal(out.numpy(), strided[idx])
    assert rowgather.ROUTES == {"native": 0, "numpy": 2}
    with pytest.raises(ValueError, match="out is"):
        rowgather.gather_rows(src, idx, out=torch.empty(
            (3, PX, PX, 3), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# the streamed epoch and eval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [NAME, NAME + "_BN_DROP"])
def test_streamed_epoch_equals_the_resident_epoch(name):
    """Flips, dropout masks and batch-norm statistics on: 100 rows in
    chunks of 48 (three batches of 16) train on the permutation padded to
    144 rows, exactly as the resident epoch over that padded permutation
    with the same generator."""
    _, ctx_t = _contexts(name, augment=True)
    model = _model(name)
    engine = ttrain.Engine(ctx_t)
    images, labels = _rows(100)
    perm = np.random.default_rng(1).permutation(100)
    streamed, m_s = engine.train_epoch_chunked(
        _port_state(model, ctx_t), images, labels, perm,
        torch.Generator().manual_seed(4), 1e-2, 16, 48,
        ttrain.ChunkFeed(images.shape[1:], 48, "cpu"))
    padded = np.concatenate([perm, perm[:44]])
    resident, m_r = engine.train_epoch(
        _port_state(model, ctx_t), torch.from_numpy(images),
        torch.from_numpy(labels).long(), torch.from_numpy(padded),
        torch.Generator().manual_seed(4), 1e-2, 16)
    for a, b in zip(ttrain.tree_leaves(streamed.trainable)
                    + ttrain.tree_leaves(streamed.momentum)
                    + ttrain.tree_leaves(streamed.batch_stats),
                    ttrain.tree_leaves(resident.trainable)
                    + ttrain.tree_leaves(resident.momentum)
                    + ttrain.tree_leaves(resident.batch_stats)):
        assert torch.equal(a, b)
    assert m_s.keys() == m_r.keys()
    assert all(torch.equal(m_s[k], m_r[k]) for k in m_s)


def test_a_steps_gradients_die_with_the_step(monkeypatch):
    """``mesh_lib.global_grads`` hands the step gradients that nothing else
    refers to (use count 1, no ``.grad`` left on a leaf), so over a
    streamed epoch each step's gradients are dead (weakrefs) when the next
    step starts, and after the epoch. ``torch.autograd.grad``'s were also
    held by its finished graph task, which on the card autograd's device
    thread released only when it next ran: under host load after the next
    step's forward had begun, 36 MB over stream224's usual peak."""
    _, ctx_t = _contexts(augment=True)
    engine = ttrain.Engine(ctx_t)
    images, labels = _rows(100)
    refs, alive = [], []
    real_grads, real_step = mesh_lib.global_grads, ttrain.Engine._train_step

    def grads(loss, leaves, mesh=None, allow_unused=False):
        out = real_grads(loss, leaves, mesh, allow_unused)
        assert [g._use_count() for g in out] == [1] * len(out)
        assert all(leaf.grad is None for leaf in leaves)
        refs.extend(weakref.ref(g) for g in out)
        return out

    def step(self, *args, **kwargs):
        alive.append(sum(r() is not None for r in refs))
        return real_step(self, *args, **kwargs)

    monkeypatch.setattr(mesh_lib, "global_grads", grads)
    monkeypatch.setattr(ttrain.Engine, "_train_step", step)
    engine.train_epoch_chunked(
        _port_state(_model(), ctx_t), images, labels,
        np.random.default_rng(1).permutation(100),
        torch.Generator().manual_seed(4), 1e-2, 16, 48,
        ttrain.ChunkFeed(images.shape[1:], 48, "cpu"))
    assert alive == [0] * 9  # 144 padded rows, batches of 16
    assert refs and all(r() is None for r in refs)


@pytest.mark.parametrize("allow_unused", [False, True])
def test_global_grads_take_no_graph_tasks_value(monkeypatch, allow_unused):
    """The mechanism behind the test above, which the CPU cannot show
    failing (its backward runs on the caller's thread, so nothing outlives
    the call there): ``global_grads`` takes the gradients through
    ``.grad``, never as the value of ``torch.autograd.grad``'s graph task,
    which on the card autograd's device thread held until it next ran. The
    same values as ``torch.autograd.grad``; an unused leaf's gradient is
    zeros, or an error without ``allow_unused``."""
    gen = torch.Generator().manual_seed(3)
    leaves = [torch.randn(6, 6, generator=gen, dtype=torch.float64)
              .requires_grad_() for _ in range(3)]
    x = torch.randn(4, 6, generator=gen, dtype=torch.float64)
    used = leaves if not allow_unused else leaves[:2]

    def loss():
        h = x
        for w in used:
            h = torch.tanh(h @ w)
        return h.square().sum()

    want = torch.autograd.grad(loss(), used)

    def refused(*args, **kwargs):
        raise AssertionError("torch.autograd.grad called")

    monkeypatch.setattr(torch.autograd, "grad", refused)
    got = mesh_lib.global_grads(loss(), leaves, allow_unused=allow_unused)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if allow_unused:
        assert torch.equal(got[2], torch.zeros(6, 6, dtype=torch.float64))
    else:
        with pytest.raises(RuntimeError, match="allow_unused"):
            mesh_lib.global_grads(loss() + 0 * leaves[0].sum(),
                                  leaves + [torch.ones(2).requires_grad_()])
    assert all(leaf.grad is None for leaf in leaves)


@pytest.mark.parametrize("n", [96, 100])
def test_chunked_epoch_matches_the_jax_package(n):
    ctx_j, ctx_t = _contexts()
    model = _model()
    images, labels = _rows(n, seed=n)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(2), n))
    want, m_j = jtrain.Engine(ctx_j).train_epoch_chunked(
        _jax_state(model, ctx_j), images, labels, perm,
        jax.random.PRNGKey(3), 1e-2, 16, chunk_rows=48)
    got, m_t = ttrain.Engine(ctx_t).train_epoch_chunked(
        _port_state(model, ctx_t), images, labels, perm,
        torch.Generator().manual_seed(3), 1e-2, 16, 48,
        ttrain.ChunkFeed(images.shape[1:], 48, "cpu"))
    _assert_close(ttrain.trainable_to_host(got.trainable), want.trainable,
                  rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_t["acc"]), float(m_j["acc"]),
                               rtol=1e-5)


def test_chunked_epoch_refuses_a_feed_of_other_rows():
    """The feed is made once for the split's chunks; one of other rows is
    refused, not replaced by a new one."""
    _, ctx_t = _contexts()
    images, labels = _rows(96)
    with pytest.raises(ValueError, match="32-row chunks"):
        ttrain.Engine(ctx_t).train_epoch_chunked(
            _port_state(_model(), ctx_t), images, labels, np.arange(96),
            torch.Generator().manual_seed(3), 1e-2, 16, 48,
            ttrain.ChunkFeed(images.shape[1:], 32, "cpu"))


def test_chunked_eval_has_the_resident_counters():
    ctx_j, ctx_t = _contexts()
    model = _model()
    images, labels = _rows(90, seed=5)
    tr = {"params": model["params"],
          "heads": {k: model["heads"][k] for k in ("kernel", "bias")}}
    trainable = ttrain.trainable_from_host(tr, "cpu", requires_grad=False)
    engine = ttrain.Engine(ctx_t)
    resident = engine.evaluate(trainable, {}, torch.from_numpy(images),
                               labels, 32)
    chunked = engine.evaluate_chunked(trainable, {}, images, labels, 32,
                                      40)  # chunks of 40, 40 and 10 rows
    want = jtrain.Engine(ctx_j).evaluate_chunked(
        jax.tree_util.tree_map(jnp.asarray, tr), {}, images, labels, 32,
        chunk_rows=40)
    for got in (chunked, want):
        assert got[0] == resident[0]
        np.testing.assert_array_equal(got[1], resident[1])
        np.testing.assert_array_equal(got[2], resident[2])


@pytest.mark.parametrize("budget_mb", ["1", "0"])
def test_train_task_over_the_budget_matches_the_jax_package(
        tmp_path, monkeypatch, budget_mb):
    """800 train rows (2.3 MiB) at batch 48: a 1 MiB budget streams the
    train split in 144-row chunks (six, the last 64 rows wrap-padded) and
    keeps the val split resident; a 0 budget streams both, a batch a
    chunk."""
    monkeypatch.setenv("CLSURVEY_DATA_BUDGET_MB", budget_mb)
    td = tdata.parse("synthetic_2t_4c_32px_200n").get_task_dataset(1)
    seed, n_train = 5, td.train.size
    ctx_j, ctx_t = _contexts()
    model = _model()
    job = dict(num_epochs=2, batch_size=48, lr=1e-3, seed=seed)

    def jax_perm(epoch):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
        return np.asarray(jax.random.permutation(
            jax.random.split(key)[0], n_train))

    logs = []
    best_j, acc_j, _ = jtrain.train_task(
        jtrain.Engine(ctx_j), jtrain.TrainJob(
            exp_dir=str(tmp_path / "jax"), **job),
        _jax_state(model, ctx_j), td, log=lambda *_: None)
    best_t, acc_t, _ = ttrain.train_task(
        ttrain.Engine(ctx_t), ttrain.TrainJob(
            exp_dir=str(tmp_path / "port"), **job),
        _port_state(model, ctx_t), td, log=logs.append, perms=jax_perm)
    assert logs[0] == (f"streaming train split (2 MiB > budget "
                       f"{budget_mb} MiB): "
                       f"{170 if budget_mb == '1' else 1}-row chunks")
    assert acc_t == acc_j
    assert best_t["meta"]["epoch"] == best_j["meta"]["epoch"]
    _assert_close({"params": best_t["params"], "heads": best_t["heads"]},
                  {"params": best_j["params"], "heads": best_j["heads"]},
                  rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the importance passes
# ---------------------------------------------------------------------------

def _jax_bank(model):
    return {"kernel": jnp.asarray(model["heads"]["kernel"]),
            "bias": jnp.asarray(model["heads"]["bias"]),
            "class_counts": np.asarray(model["heads"]["class_counts"])}


@pytest.mark.parametrize("which", ["ewc", "mas"])
def test_streamed_importance_matches_the_jax_package(monkeypatch, which):
    """A 0 budget: 44 rows in chunks of one batch (EWC, batch 16) or one
    vmap chunk (MAS, 16), the last 12 rows."""
    monkeypatch.setenv("CLSURVEY_DATA_BUDGET_MB", "0")
    ctx_j, ctx_t = _contexts(task=1)
    model = _model()
    images, labels = _rows(44, seed=4)
    params_j = jax.tree_util.tree_map(jnp.asarray, model["params"])
    params_t = params_from_jax(model["params"])
    if which == "ewc":
        want = jimp.ewc_fisher(ctx_j, params_j, {}, _jax_bank(model), 1,
                               images, labels, 16)
        got = timp.ewc_fisher(ctx_t, params_t, {}, model["heads"], 1,
                              images, labels, 16)
    else:
        want = jimp.mas_importance(ctx_j, params_j, {}, _jax_bank(model), 1,
                                   images, chunk=16)
        got = timp.mas_importance(ctx_t, params_t, {}, model["heads"], 1,
                                  images, chunk=16)
    _assert_close(params_to_jax(got), want, rtol=1e-4, atol=1e-7)


def test_streamed_mode_fisher_with_the_jax_runs_labels(monkeypatch):
    """Two splits of 70 and 40 rows at batch 16 (64 and 32 usable rows) in
    one-batch chunks; the labels are the ones the JAX run sampled (one key
    a split, one a chunk, one a batch)."""
    monkeypatch.setenv("CLSURVEY_DATA_BUDGET_MB", "0")
    ctx_j, ctx_t = _contexts(task=1)
    model = _model()
    splits = [_rows(70, seed=7)[0], _rows(40, seed=8)[0]]
    params_j = jax.tree_util.tree_map(jnp.asarray, model["params"])
    bank = _jax_bank(model)
    key = jax.random.PRNGKey(9)
    want = jimp.imm_mode_fisher(ctx_j, params_j, {}, bank, 1, splits, 16,
                                key)
    sampled = []
    for images in splits:
        labels = []
        for b in range(len(images) // 16):
            key, sub = jax.random.split(key)
            _, sub = jax.random.split(sub)
            x = jpp.normalize(jnp.asarray(images[b * 16:(b + 1) * 16]),
                              MEAN, STD)
            feats, _ = ctx_j.forward_feats(params_j, {}, x, False,
                                           jax.random.PRNGKey(0))
            labels.append(np.asarray(jax.random.categorical(
                sub, jheads.forward(bank, feats, 1))))
        sampled.append(np.concatenate(labels))
    got = timp.imm_mode_fisher(ctx_t, params_from_jax(model["params"]), {},
                               model["heads"], 1, splits, 16,
                               sampled_labels=sampled)
    _assert_close(params_to_jax(got), want, rtol=1e-3, atol=1e-8)
