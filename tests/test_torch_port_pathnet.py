"""clsurvey_torch's PathNet against clsurvey_tpu's on the CPU (tiny_CNN,
float32, inputs made from numpy seeds):

- ``module_conv`` / ``module_dense``: outputs and gradients within 1e-5,
  with distinct modules and with a path that repeats modules (N > M);
- ``module_train_mask``: the same gates;
- ``_evolve`` at task 2 with training and eval stubbed to give both
  packages the same accuracies (and a NaN epoch): the same paths, lrs and
  gates handed to every epoch, the same winner and ``best_paths``, and the
  same re-initialised weights, bit for bit;
- one train epoch with the JAX run's permutation and flips, a path that
  repeats modules and frozen modules: weights and momentum within 1e-5 of
  each leaf's largest entry;
- a candidate that diverges (lr 1e6) leaves the frozen modules finite and
  bit-identical; the decay operator adds a module;
- files: a PathNet sequence trained by the JAX package evaluated by the
  port's CLI, and one trained by the port's CLI (``--static_hyperparams
  "4;2"``) evaluated by the JAX package's: result dicts within 1e-4."""

import os
import shutil
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.data import registry as tdata
from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.framework import common as tcommon, main as tmain
from clsurvey_torch.methods import pathnet as tpath
from clsurvey_torch.models import convert, registry as treg
from clsurvey_torch.utils import config as tconfig, io as tio
from clsurvey_tpu.data import registry as jdata
from clsurvey_tpu.framework import common as jcommon
from clsurvey_tpu.framework.main import main as jmain
from clsurvey_tpu.methods import pathnet as jpath
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.utils import config as jconfig, io as jio

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models on the CPU: one intra-op thread (the suite runs in
    several worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jnp(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def _jax_name(port_name: str) -> str:
    layer, suffix = port_name.split(".")
    return f"{layer}_{'kernel' if suffix == 'weight' else 'bias'}"


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("sel", [[0, 2], [1, 1, 3, 1, 0]],
                         ids=["distinct", "repeated"])
def test_module_conv_and_dense_match(sel):
    rng = np.random.default_rng(0)
    M, out_w, in_w = 4, 3, 5
    x = rng.normal(0, 1, (2, 8, 8, in_w)).astype(np.float32)
    k = rng.normal(0, 0.3, (M, 3, 3, in_w, out_w)).astype(np.float32)
    b = rng.normal(0, 0.1, (M, out_w)).astype(np.float32)
    sel_j, sel_t = jnp.asarray(sel, jnp.int32), torch.tensor(sel)
    for pool in (True, False):
        fn = lambda x_, k_, b_: jpath._module_conv(
            x_, k_, b_, sel_j, out_w, jnp.float32, strides=(1, 1),
            padding="SAME", pool=(2, 2) if pool else None)
        out_j, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(k),
                             jnp.asarray(b))
        ct = rng.normal(0, 1, out_j.shape).astype(np.float32)
        dx_j, dk_j, db_j = vjp(jnp.asarray(ct))
        p = convert.pathnet_params_from_jax({"c_kernel": k, "c_bias": b})
        x_t = torch.from_numpy(x).requires_grad_()
        w_t = p["c.weight"].requires_grad_()
        b_t = p["c.bias"].requires_grad_()
        out_t = tpath.module_conv(x_t.permute(0, 3, 1, 2), w_t, b_t, sel_t,
                                  pool).permute(0, 2, 3, 1)
        out_t.backward(torch.from_numpy(ct))
        _close(out_t.detach().numpy(), out_j, 1e-5, f"conv pool={pool}")
        grads = convert.pathnet_params_to_jax({"c.weight": w_t.grad,
                                               "c.bias": b_t.grad})
        _close(x_t.grad.numpy(), dx_j, 1e-5, "conv dx")
        _close(grads["c_kernel"], dk_j, 1e-5, "conv dk")
        _close(grads["c_bias"], db_j, 1e-5, "conv db")

    xd = rng.normal(0, 1, (6, 12)).astype(np.float32)
    kd = rng.normal(0, 0.3, (M, 12, out_w)).astype(np.float32)
    fn = lambda x_, k_, b_: jpath._module_dense(x_, k_, b_, sel_j, out_w,
                                                jnp.float32)
    out_j, vjp = jax.vjp(fn, jnp.asarray(xd), jnp.asarray(kd),
                         jnp.asarray(b))
    ct = rng.normal(0, 1, out_j.shape).astype(np.float32)
    dx_j, dk_j, db_j = vjp(jnp.asarray(ct))
    p = convert.pathnet_params_from_jax({"d_kernel": kd, "d_bias": b})
    x_t = torch.from_numpy(xd).requires_grad_()
    w_t = p["d.weight"].requires_grad_()
    b_t = p["d.bias"].requires_grad_()
    out_t = tpath.module_dense(x_t, w_t, b_t, sel_t)
    out_t.backward(torch.from_numpy(ct))
    _close(out_t.detach().numpy(), out_j, 1e-5, "dense")
    grads = convert.pathnet_params_to_jax({"d.weight": w_t.grad,
                                           "d.bias": b_t.grad})
    _close(x_t.grad.numpy(), dx_j, 1e-5, "dense dx")
    _close(grads["d_kernel"], dk_j, 1e-5, "dense dk")
    _close(grads["d_bias"], db_j, 1e-5, "dense db")


PX, M = 32, 4
NAME = "tiny_CNN_cl_32_32"


def _jax_init(N, seed=0) -> dict:
    """JAX-initialised PathNet weights (numpy) of ``NAME``."""
    net = jpath.PathNetVGG(cfg_name="tiny_CNN", classifier_dims=(32, 32),
                           M=M, N=N)
    v = net.init({"params": jax.random.PRNGKey(seed)},
                 jnp.zeros((2, PX, PX, 3)),
                 jnp.zeros((net.n_layers, N), jnp.int32))
    return jio.to_host(v["params"]), net


def test_module_train_mask_matches():
    params, net = _jax_init(2)
    rng = np.random.default_rng(1)
    L = net.n_layers
    frozen = (rng.uniform(size=(L, M)) < 0.4).astype(np.float32)
    path = rng.integers(0, M, (L, 3))
    want = jpath.module_train_mask(_jnp(params), path, frozen, 2)
    got = tpath.module_train_mask(convert.pathnet_params_from_jax(params),
                                  path, frozen, 2)
    assert sorted(_jax_name(n) for n in got) == sorted(want)
    for n, g in got.items():
        w = np.asarray(want[_jax_name(n)])
        assert g.shape == w.shape, n
        np.testing.assert_array_equal(g.numpy(), w, err_msg=n)


def _managers(tmp_path, prev_path):
    """A JAX and a port Manager at task 2 of synthetic_2t_4c_32px, whose
    previous model is ``prev_path``."""
    out = {}
    for pkg, common, reg, data in (("jax", jcommon, jreg, jdata),
                                   ("port", tcommon, treg, tdata)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        args = common.RunArgs(model_name=NAME,
                              ds_name="synthetic_2t_4c_32px", num_epochs=2,
                              batch_size=32, lr_grid=(1e-2,), **kw)
        m = common.Manager(args=args, dataset=data.parse(args.ds_name),
                           method=None, model_spec=reg.parse_model_name(
                               str(tmp_path / "models"), NAME, (PX, PX)))
        m.set_dataset(2)
        m.previous_task_model_path = prev_path
        m.extras["lr"] = 1e-2
        out[pkg] = m
    return out


NAN = float("nan")
ACCS = [0.3, 0.5, 0.2, 0.2, 0.6, 0.6, 0.1, 0.7, 0.7, 0.7, 0.2, 0.1]
NAN_CALLS = (3, 9)


def _stubbed(pkg, pn, calls):
    """``pn``'s train epoch returns the weights unchanged (NaN at
    ``NAN_CALLS``) and records its path, lr and gates; eval gives
    ``ACCS`` in turn."""
    evals = []

    def record(path, lr, gates, name_of):
        calls.append((np.asarray(path).tolist(), float(np.float32(lr)),
                      {name_of(n): np.asarray(g).ravel().tolist()
                       for n, g in gates.items()}))
        return len(calls) - 1 in NAN_CALLS

    if pkg == "jax":
        def train_epoch(tr, mom, images, labels, perm, path, gates, key,
                        lr):
            if record(path, lr, gates, str):
                tr = jax.tree_util.tree_map(lambda a: a * NAN, tr)
            return tr, mom

        def eval_acc(tr, images, labels, path, batch_size=256):
            evals.append(1)
            return ACCS[len(evals) - 1]

        pn._make_fns = lambda *a, **k: (train_epoch, eval_acc)
    else:
        class Fns:
            def train_epoch(self, tr, mom, images, labels, perm, path,
                            gates, gen, lr):
                if record(path, lr, gates, _jax_name):
                    tr = {k: {n: t * NAN for n, t in v.items()}
                          for k, v in tr.items()}
                return tr, mom

            def eval_acc(self, tr, images, labels, path, batch_size=256):
                evals.append(1)
                return ACCS[len(evals) - 1]

        pn._make_fns = lambda *a, **k: Fns()
    return pn


def test_evolve_matches_with_stubbed_training(tmp_path):
    """Task 2 after a task-1 model whose weights moved from their init:
    the modules on task 1's best path stay, the others start again from
    ``init_params``; 3 generations of 2 candidates, 2 epochs each."""
    N = 2
    params, net = _jax_init(N)
    rng = np.random.default_rng(2)
    moved = {k: (v + rng.normal(0, 0.5, v.shape)).astype(np.float32)
             for k, v in params.items()}
    counts = np.asarray([4, 4], np.int32)
    prev = {"params": moved, "init_params": params, "batch_stats": {},
            "heads": {"kernel": rng.normal(0, 0.1, (2, 8, 4)).astype(
                np.float32), "bias": np.zeros((2, 4), np.float32),
                "class_counts": counts},
            "meta": {"pathnet": True, "task": 0, "N": N},
            "method_aux": {"best_paths": [
                rng.integers(0, M, (net.n_layers, N)).astype(np.int32)]}}
    prev_path = str(tmp_path / "prev.pth.tar")
    jio.save(prev, prev_path)
    managers = _managers(tmp_path, prev_path)
    out = {}
    for pkg, mod in (("jax", jpath), ("port", tpath)):
        calls = []
        pn = _stubbed(pkg, mod.PathNet(static_hyperparams=OrderedDict(
            {"M": M, "generations": 3})), calls)
        pn.lr_patience = 2  # lr / 3 after one epoch without a gain
        res, acc = pn._evolve(managers[pkg].args, managers[pkg], N=N,
                              generations=3, nepochs_per_gen=2,
                              exp_dir=str(tmp_path / pkg), seed=13)
        out[pkg] = (calls, acc, res)
    (calls_t, acc_t, res_t), (calls_j, acc_j, res_j) = out["port"], \
        out["jax"]
    assert calls_t == calls_j and len(calls_t) == 12
    assert len({tuple(map(tuple, c[0])) for c in calls_t}) > 2  # mutated
    assert len({c[1] for c in calls_t}) > 1  # the lrs moved
    assert acc_t == acc_j == 0.7
    for a, b in zip(res_t["method_aux"]["best_paths"],
                    res_j["method_aux"]["best_paths"]):
        np.testing.assert_array_equal(a, b)
    assert len(res_t["method_aux"]["best_paths"]) == 2
    for tree in ("params", "init_params"):
        assert sorted(res_t[tree]) == sorted(res_j[tree])
        for k, w in res_j[tree].items():
            np.testing.assert_array_equal(res_t[tree][k], np.asarray(w), k)
    # the re-initialisation moved exactly the modules task 1 did not use
    bp = prev["method_aux"]["best_paths"][0]
    for k in params:
        layer = jpath._layer_index(k, 2)
        for mod in range(M):
            want = moved if mod in bp[layer] else params
            np.testing.assert_array_equal(res_t["params"][k][mod],
                                          want[k][mod], f"{k}[{mod}]")
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(res_t["heads"][k],
                                      np.asarray(res_j["heads"][k]))


def test_one_train_epoch_matches():
    """Two steps of 64 at task 2 (head 1), a path that repeats modules, a
    quarter of the modules frozen, momentum from zero."""
    N = 3
    params, net = _jax_init(N, seed=3)
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (128, PX, PX, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (128,)).astype(np.int32)
    perm = rng.permutation(128)
    path = np.asarray([[0, 0, 1], [2, 2, 2], [3, 1, 3], [1, 0, 2]],
                      np.int32)
    frozen = np.zeros((net.n_layers, M), np.float32)
    frozen[:, 1] = 1.0
    tr = {"params": params, "heads": {
        "kernel": rng.normal(0, 0.1, (2, 8, 4)).astype(np.float32),
        "bias": rng.normal(0, 0.1, (2, 4)).astype(np.float32)}}
    counts, key, lr = [4, 4], jax.random.PRNGKey(5), 0.01
    train_j, _ = jpath.PathNet()._make_fns(net, MEAN, STD, counts, 1)
    gates_j = jpath.module_train_mask(_jnp(params), path, frozen, 2)
    new_j, mom_j = train_j(
        _jnp(tr), jax.tree_util.tree_map(jnp.zeros_like, _jnp(tr)),
        jnp.asarray(images), jnp.asarray(labels), jnp.asarray(perm),
        jnp.asarray(path), gates_j, key, jnp.float32(lr))

    net_t = tpath.PathNetVGG("tiny_CNN", (32, 32), (PX, PX), M)
    fns = tpath.PathNetFns(net_t, MEAN, STD, counts, 1, torch.device("cpu"))
    flips, r = [], key
    for _ in range(2):  # the JAX epoch's per-step keys: (r, sub, pre)
        r, _, pre = jax.random.split(r, 3)
        flips.append(torch.from_numpy(np.asarray(jax.random.bernoulli(
            pre, 0.5, (64, 1, 1, 1))).reshape(64).astype(np.uint8)))
    fns.draw = lambda gen, b: flips.pop(0)
    tr_t = ttrain.trainable_from_host(tr, "cpu", True,
                                     convert.pathnet_params_from_jax)
    start = {k: v.clone() for k, v in tr_t["params"].items()}
    gates_t = tpath.module_train_mask(tr_t["params"], path, frozen, 2)
    new_t, mom_t = fns.train_epoch(
        tr_t, ttrain.tree_zeros_like(tr_t), torch.from_numpy(images),
        torch.from_numpy(labels).long(), torch.from_numpy(perm), path,
        gates_t, None, lr)
    assert not flips
    for got, want in ((new_t, new_j), (mom_t, mom_j)):
        g_params = convert.pathnet_params_to_jax(got["params"])
        for k, w in jio.to_host(want["params"]).items():
            _close(g_params[k], w, 1e-5, k)
        for k in ("kernel", "bias"):
            _close(got["heads"][k].detach().numpy(),
                   np.asarray(want["heads"][k]), 1e-5, k)
    for k, v in start.items():  # frozen and unused modules: unchanged
        keep = (gates_t[k] > 0).view(-1)
        assert torch.equal(new_t["params"][k][~keep], v[~keep]), k
        assert not torch.equal(new_t["params"][k][keep], v[keep]), k


def test_a_diverged_candidate_leaves_frozen_modules_alone(tmp_path):
    """Task 1 at lr 1e-2, then task 2 at lr 1e6, whose candidates produce
    NaN: task 1's modules are finite and bit-identical afterwards."""
    m = _managers(tmp_path, None)["port"]
    m.set_dataset(1)
    pn = tpath.PathNet(static_hyperparams=OrderedDict(
        {"M": 2, "generations": 2}))
    out1, _ = pn._evolve(m.args, m, N=1, generations=1, nepochs_per_gen=2,
                         exp_dir=str(tmp_path / "t1"), seed=7)
    m.set_dataset(2)
    m.previous_task_model_path = str(tmp_path / "t1" / "best_model.pth.tar")
    m.extras["lr"] = 1e6
    out2, _ = pn._evolve(m.args, m, N=1, generations=2, nepochs_per_gen=2,
                         exp_dir=str(tmp_path / "t2"), seed=7)
    (bp,) = out1["method_aux"]["best_paths"]
    for name, a in out1["params"].items():
        b = out2["params"][name]
        assert np.isfinite(b).all(), name
        layer = jpath._layer_index(name, 2)
        for mod in bp[layer]:
            np.testing.assert_array_equal(a[mod], b[mod],
                                          f"{name}[{mod}]")


@pytest.mark.parametrize("n", [1, 3, 20])
def test_decay_operator_matches(n):
    assert tpath.PathNet().decay_operator(n, 0.5) == \
        jpath.PathNet().decay_operator(n, 0.5) == n + 1


# ---------------------------------------------------------------------------
# files: each package evaluates the other's PathNet sequence
# ---------------------------------------------------------------------------

DS = "synthetic_2t_4c_32px"
TRAIN = dict(model_name=NAME, ds_name=DS, num_epochs=2, batch_size=32,
             lr_grid=(1e-2,), hyperparams="2", static_hyperparams="4;2",
             max_attempts_per_task=1, test=True)
ARGV = [NAME, "--ds_name", DS, "--num_epochs", "2", "--batch_size", "32",
        "--lr_grid", "1e-2", "--device", "cpu", "--method_name", "pathnet",
        "--hyperparams", "2", "--static_hyperparams", "4;2",
        "--max_attempts_per_task", "1", "--test"]


def _use(root):
    os.environ["CLSURVEY_ROOT"] = str(root)
    for mod in (jconfig, tconfig):
        mod.set_config(None)
        mod.load_config(refresh=True)


def _results(root):
    parent = os.path.join(str(root), "results", "test", "results", DS,
                          "pathnet", NAME, "demo")
    (exp,) = os.listdir(parent)
    return {fn: jio.load(os.path.join(parent, exp, fn))
            for fn in sorted(os.listdir(os.path.join(parent, exp)))}


def _same_results(got, want):
    assert sorted(got) == sorted(want) and len(want) == 2
    for fn, w in want.items():
        g, w = got[fn]["pathnet"], w["pathnet"]
        for key in ("seq_res", "seq_forgetting"):
            assert list(g[key]) == list(w[key])
            for i in w[key]:
                assert len(g[key][i]) == len(w[key][i])
                np.testing.assert_allclose(g[key][i], w[key][i], rtol=0,
                                           atol=1e-4)


@pytest.fixture(scope="module")
def restore_env():
    old = os.environ.get("CLSURVEY_ROOT")
    yield
    if old is not None:
        os.environ["CLSURVEY_ROOT"] = old
    jconfig.set_config(None)
    tconfig.set_config(None)


def _copy(root, dst):
    shutil.copytree(root, dst, symlinks=True,
                    ignore=shutil.ignore_patterns("test", "jax_cache"))
    return dst


def test_the_port_evaluates_a_jax_trained_pathnet_sequence(
        restore_env, tmp_path, capsys):
    _use(tmp_path / "jax")
    jmain(jcommon.RunArgs(method_name="pathnet", **TRAIN))
    want = _results(tmp_path / "jax")
    _use(_copy(tmp_path / "jax", tmp_path / "port"))
    capsys.readouterr()
    tmain.cli(ARGV)
    assert "ATTEMPT" not in capsys.readouterr().out  # nothing trained
    _same_results(_results(tmp_path / "port"), want)


def test_the_jax_package_evaluates_a_port_trained_pathnet_sequence(
        restore_env, tmp_path, capsys):
    _use(tmp_path / "port")
    manager = tmain.cli(ARGV)  # the CLI on the CPU, from scratch
    assert [len(r["seq_res"]) for r in manager.extras["eval_results"]] \
        == [2, 1]
    models = [tio.load(manager.best_model_path(t, create=False))
              for t in (1, 2)]
    bps = models[1]["method_aux"]["best_paths"]
    # N grows by the decay operator when an attempt is retained
    assert len(bps) == 2 and all(np.shape(p)[0] == 4 and np.shape(p)[1] >= 2
                                 for p in bps)
    assert models[1]["params"]["conv_1_kernel"].shape == (M, 3, 3, 2, 4)
    for name, a in models[0]["params"].items():  # task 1's modules stay
        layer = jpath._layer_index(name, 2)
        for mod in bps[0][layer]:
            np.testing.assert_array_equal(
                a[mod], models[1]["params"][name][mod], f"{name}[{mod}]")
    want = _results(tmp_path / "port")
    _use(_copy(tmp_path / "port", tmp_path / "jax"))
    capsys.readouterr()
    jmain(jcommon.RunArgs(method_name="pathnet", **TRAIN))
    assert "ATTEMPT" not in capsys.readouterr().out
    _same_results(_results(tmp_path / "jax"), want)
