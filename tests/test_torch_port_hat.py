"""clsurvey_torch's HAT against clsurvey_tpu's on the CPU (tiny_CNN at
16 px, float32, inputs and embeddings made from numpy seeds):

- ``HATVGG``: features and gates within 1e-5 at ``s`` in {1/smax, 1,
  smax}, with learnt and with all-ones gates, and a ``_DROP`` model's
  train-mode features with the JAX run's keep-masks;
- ``compute_mask_pre`` / ``compute_mask_back`` within 1e-6 and with the
  same exact zeros, after one previous task and after two that claim
  different halves (``fc_0``'s tiling included); ``sparsity_reg`` at the
  first and the second task; ``capacity_report``;
- one train step at the first step of an epoch (``smax / s = smax**2``),
  in and outside ``finetune_mode``, at task 1 and at task 2 (``mask_back``,
  weight decay), with the JAX run's flips: every leaf of the weights and
  the momentum within 1e-5 of its largest entry, and the weights that
  ``mask_back`` blocks bit-unchanged; a 4-step epoch with ``s`` annealing
  within 1e-4;
- the controller (``hat_train_task``) on stub engines fed the same loss
  and val sequences: the same log lines (lr, lambda, containment, warm-up
  exit, min-epoch guard), the same states handed to each epoch, the same
  epoch checkpoints, and the same resume from one;
- files: a HAT sequence trained by the JAX package evaluated by the port's
  CLI, and one trained by the port's CLI evaluated by the JAX package's:
  result dicts within 1e-4."""

import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.framework import main as tmain
from clsurvey_torch.methods import hat as that
from clsurvey_torch.models import convert, registry as treg
from clsurvey_torch.parallel.mesh import Mesh
from clsurvey_torch.utils import config as tconfig, io as tio
from clsurvey_torch.utils.paths import EPOCH_CKPT_FILENAME
from clsurvey_tpu.framework.common import RunArgs as JRunArgs
from clsurvey_tpu.framework.main import main as jmain
from clsurvey_tpu.methods import hat as jhat
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.utils import config as jconfig, io as jio

NAME, PX, N_TASKS, SMAX = "tiny_CNN_cl_16_16", 16, 3, 800.0
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
COUNTS = [4, 3, 4]


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


@pytest.fixture(scope="module")
def nets():
    spec_j = jreg.parse_model_name("", NAME, (PX, PX))
    spec_t = treg.parse_model_name("", NAME, (PX, PX))
    net_j = jhat.make_hat_model(spec_j, N_TASKS)
    net_t = that.HATVGG(spec_t.arch, spec_t.classifier_dims, N_TASKS,
                        (PX, PX))
    return spec_j, spec_t, net_j, net_t


def _params(net_j, seed=0, halves=False) -> dict:
    """JAX-initialised weights (numpy) with embeddings drawn from numpy:
    uniform(-1, 2), or with ``halves`` task 0 claiming the first half of
    every layer and task 1 the second (+-6, the clamp)."""
    v = net_j.init({"params": jax.random.PRNGKey(seed)},
                   jnp.zeros((1, PX, PX, 3)), 0, jnp.float32(1.0))
    params = jio.to_host(v["params"])
    rng = np.random.default_rng(seed)
    for name in params:
        if name.startswith("emb_"):
            e = rng.uniform(-1.0, 2.0, params[name].shape)
            if halves:
                c = e.shape[1] // 2
                e[0, :c], e[0, c:], e[1, :c], e[1, c:] = 6, -6, -6, 6
            params[name] = e.astype(np.float32)
    return params


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("s", [1 / SMAX, 1.0, SMAX])
@pytest.mark.parametrize("ones", [False, True], ids=["gates", "ones"])
def test_hatvgg_forward_matches(nets, s, ones):
    _, _, net_j, net_t = nets
    params = _params(net_j)
    x = np.random.default_rng(1).normal(0, 1, (8, PX, PX, 3)).astype(
        np.float32)
    feats_j, gates_j = net_j.apply({"params": _jnp(params)}, jnp.asarray(x),
                                   1, jnp.float32(s), ones_gates=ones)
    with torch.no_grad():
        feats_t, gates_t = torch.func.functional_call(
            net_t, convert.hat_params_from_jax(params),
            (torch.from_numpy(x), 1, float(np.float32(s))),
            {"ones_gates": ones})
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j),
                               rtol=0, atol=1e-5)
    assert len(gates_t) == len(gates_j) == 4
    for gt, gj in zip(gates_t, gates_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                                   atol=1e-5)


def test_hatvgg_dropout_forward_matches():
    """A ``_DROP`` model in train mode, with the keep-masks flax drew
    under the JAX run's key handed to the port."""
    spec = jreg.parse_model_name("", NAME + "_DROP", (PX, PX))
    net_j = jhat.make_hat_model(spec, N_TASKS)
    net_t = that.HATVGG("tiny_CNN", (16, 16), N_TASKS, (PX, PX),
                        dropout=True)
    params = _params(net_j, seed=9)
    x = jnp.asarray(np.random.default_rng(2).normal(
        0, 1, (8, PX, PX, 3)).astype(np.float32))
    rng = jax.random.PRNGKey(4)
    call = lambda **kw: net_j.apply(
        {"params": _jnp(params)}, x, 1, jnp.float32(1.0), train=True,
        rngs={"dropout": rng}, **kw)
    (feats_j, _), mut = call(
        mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: "Dropout" in (mdl.name or ""))
    masks = [torch.from_numpy(np.asarray(
        mut["intermediates"][f"Dropout_{j}"]["__call__"][0] != 0).astype(
            np.uint8)) for j in range(2)]
    assert 0.1 < float(masks[0].float().mean()) < 0.6
    with torch.no_grad():
        feats_t, _ = torch.func.functional_call(
            net_t, convert.hat_params_from_jax(params),
            (torch.tensor(np.asarray(x)), 1, 1.0),
            {"train": True, "dropout_masks": masks})
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j),
                               rtol=0, atol=1e-5)


def _masks(nets, params, task):
    _, _, net_j, net_t = nets
    pre_j = jhat.compute_mask_pre(net_j, _jnp(params), task, SMAX)
    back_j = jhat.compute_mask_back(net_j, _jnp(params), pre_j, (PX, PX))
    p_t = convert.hat_params_from_jax(params)
    pre_t = that.compute_mask_pre(p_t, net_t.emb_names, task, SMAX)
    back_t = that.compute_mask_back(net_t, p_t, pre_t)
    return (pre_j, back_j), (pre_t, back_t), p_t


@pytest.mark.parametrize("halves", [False, True],
                         ids=["one_previous", "two_halves"])
def test_mask_pre_and_mask_back_match(nets, halves):
    params = _params(nets[2], seed=2, halves=halves)
    task = 2 if halves else 1
    (pre_j, back_j), (pre_t, back_t), _ = _masks(nets, params, task)
    for mt, mj in zip(pre_t, pre_j):
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0,
                                   atol=1e-6)
    got = convert.hat_params_to_jax(back_t)
    n_zero = 0
    for key_path, want in jax.tree_util.tree_flatten_with_path(
            jio.to_host(back_j))[0]:
        g = got
        for k in key_path:
            g = g[k.key]
        what = jax.tree_util.keystr(key_path)
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-6, err_msg=what)
        np.testing.assert_array_equal(g == 0, want == 0, err_msg=what)
        n_zero += int((want == 0).sum())
    assert n_zero > 0  # some weights are blocked
    if halves:  # each half is claimed: every unit's gate saturated
        for mt in pre_t:
            assert bool((mt == 1.0).all())
        assert not got["fc_0"]["kernel"].any()  # fc_0 wholly blocked


@pytest.mark.parametrize("task", [0, 1])
def test_sparsity_reg_and_capacity_report_match(nets, task):
    params = _params(nets[2], seed=3)
    (pre_j, back_j), (pre_t, back_t), p_t = _masks(nets, params, task)
    rng = np.random.default_rng(4)
    gates = [rng.uniform(0, 1, np.shape(p)[1:]).astype(np.float32)
             for n, p in params.items() if n.startswith("emb_")]
    order = [n for n in params if n.startswith("emb_")]
    by_name = dict(zip(order, gates))
    gates = [by_name[n] for n in nets[3].emb_names]
    want = float(jhat.sparsity_reg([jnp.asarray(g) for g in gates], pre_j))
    got = float(that.sparsity_reg([torch.from_numpy(g) for g in gates],
                                  pre_t))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    rep_j = jhat.capacity_report(nets[2], _jnp(params), task, SMAX, back_j,
                                 log=lambda *_: None)
    rep_t = that.capacity_report(p_t, task, SMAX, back_t,
                                 log=lambda *_: None)
    assert sorted(rep_t) == sorted(rep_j)
    for k, v in rep_j.items():
        if isinstance(v, dict):
            assert rep_t[k] == v, k
        else:
            np.testing.assert_allclose(rep_t[k], v, rtol=1e-6, err_msg=k)


def _engines(nets, params, task, finetune, wd):
    spec_j, spec_t, net_j, net_t = nets
    (pre_j, back_j), (pre_t, back_t), _ = _masks(nets, params, task)
    eng_j = jhat.HATEngine(net_j, spec_j, task, COUNTS, MEAN, STD, SMAX,
                           None, pre_j, back_j, weight_decay=wd,
                           finetune_mode=finetune)
    eng_t = that.HATEngine(net_t, spec_t, task, COUNTS, MEAN, STD, SMAX,
                           pre_t, back_t, weight_decay=wd,
                           finetune_mode=finetune, device="cpu")
    return eng_j, eng_t


def _trainable(params, rng, mask_back=None):
    """(trainable, momentum) numpy trees in the JAX layout; the momentum is
    0 wherever ``mask_back`` blocks, as it is in a run."""
    tr = {"params": params, "heads": {
        "kernel": rng.normal(0, 0.1, (N_TASKS, 16, 4)).astype(np.float32),
        "bias": rng.normal(0, 0.1, (N_TASKS, 4)).astype(np.float32)}}
    mom = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1e-2, np.shape(a)).astype(np.float32), tr)
    if mask_back is not None:
        mom["params"] = jax.tree_util.tree_map(
            lambda m, b: (m * (np.asarray(b) > 0)).astype(np.float32),
            mom["params"], jio.to_host(mask_back))
    return tr, mom


def _flip(key, b):
    """The JAX step's flip mask: ``random_flip`` under the step's
    preprocess key."""
    return np.asarray(jax.random.bernoulli(key, 0.5, (b, 1, 1, 1))).reshape(
        b).astype(np.uint8)


def _compare_states(new_t, new_j, rel):
    for which in (0, 1):
        got = that.hat_to_host(new_t[which])
        for key_path, want in jax.tree_util.tree_flatten_with_path(
                jio.to_host(new_j[which]))[0]:
            g = got
            for k in key_path:
                g = g[k.key]
            _close(g, want, rel, f"{which} {jax.tree_util.keystr(key_path)}")


@pytest.mark.parametrize("finetune,task,wd", [
    (True, 0, 0.0), (True, 1, 1e-3), (False, 0, 0.0), (False, 1, 1e-3)],
    ids=["finetune-task1", "finetune-task2", "hat-task1", "hat-task2"])
def test_one_train_step_matches(nets, finetune, task, wd):
    params = _params(nets[2], seed=5)
    eng_j, eng_t = _engines(nets, params, task, finetune, wd)
    rng = np.random.default_rng(6)
    tr, mom = _trainable(params, rng, eng_j.mask_back if task else None)
    x = rng.integers(0, 256, (16, PX, PX, 3), dtype=np.uint8)
    y = rng.integers(0, 3, (16,)).astype(np.int32)
    key, lr, lamb = jax.random.PRNGKey(0), 0.05, 2.5
    s = that.anneal_s(SMAX, 0, 40)
    assert np.float32(SMAX) / np.float32(s) == pytest.approx(SMAX ** 2)
    new_j, m_j = jax.jit(eng_j._train_step)(
        (_jnp(tr), _jnp(mom)), jnp.asarray(x), jnp.asarray(y), key,
        jnp.float32(lr), jnp.float32(s), jnp.float32(lamb))
    state_t = (that.hat_from_host(tr, "cpu", True),
               that.hat_from_host(mom, "cpu", False))
    before = {k: v.clone() for k, v in state_t[0]["params"].items()}
    new_t, m_t = eng_t.train_step(
        state_t, torch.from_numpy(x), torch.from_numpy(y).long(), lr, s,
        lamb, flip=torch.from_numpy(_flip(jax.random.split(key)[0], 16)))
    _compare_states(new_t, new_j, 1e-5)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    if task:
        blocked = 0
        for k, m in eng_t.mask_back.items():
            after = new_t[0]["params"][k]
            assert torch.equal(after[m == 0], before[k][m == 0]), k
            blocked += int((m == 0).sum())
        assert blocked > 0
    embs = [v for k, v in new_t[0]["params"].items() if k.startswith("emb")]
    assert max(float(e.detach().abs().max()) for e in embs) <= \
        that.THRES_EMB


def test_four_step_epoch_matches(nets):
    params = _params(nets[2], seed=7)
    eng_j, eng_t = _engines(nets, params, 1, False, 0.0)
    rng = np.random.default_rng(8)
    tr, mom = _trainable(params, rng, eng_j.mask_back)
    images = rng.integers(0, 256, (64, PX, PX, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (64,)).astype(np.int32)
    perm = rng.permutation(64)
    key, lr, lamb = jax.random.PRNGKey(9), 0.02, 2.5
    new_j, m_j = eng_j._train_epoch(
        (_jnp(tr), _jnp(mom)), jnp.asarray(images), jnp.asarray(labels),
        jnp.asarray(perm), key, jnp.float32(lr), jnp.float32(lamb), 16)
    flips, r = [], key
    for _ in range(4):  # the JAX epoch's per-step keys
        r, sub = jax.random.split(r)
        flips.append(torch.from_numpy(_flip(jax.random.split(sub)[0], 16)))
    eng_t.draw = lambda gen, b: (flips.pop(0), None)
    new_t, m_t = eng_t.train_epoch(
        (that.hat_from_host(tr, "cpu", True),
         that.hat_from_host(mom, "cpu", False)),
        torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.from_numpy(perm), None, lr, lamb, 16)
    assert not flips
    _compare_states(new_t, new_j, 1e-4)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the controller, on stub engines
# ---------------------------------------------------------------------------

def _stub_tree():
    """A small HAT-shaped trainable (JAX layout)."""
    return {"params": {"fc_0": {"kernel": np.zeros((4, 3), np.float32),
                                "bias": np.zeros(3, np.float32)},
                       "emb_fc_0": np.zeros((2, 3), np.float32)},
            "heads": {"kernel": np.zeros((2, 3, 2), np.float32),
                      "bias": np.zeros((2, 2), np.float32)}}


def _run_controller(pkg, exp_dir, losses, vals, **kw):
    """``hat_train_task`` of ``pkg`` on a stub engine: epoch e returns the
    weights filled with e + 1 and loss ``losses[e]``, eval gives
    ``vals[e]``. Returns (log lines, the fill of the weights each epoch
    started from, the lr / lambda of each epoch, result, checkpoint)."""
    seen, calls, lines = [], [], []

    if pkg == "jax":
        class Engine:
            smax = SMAX

            def _train_epoch(self, state, images, labels, perm, key, lr,
                             lamb, bsz):
                e = len(seen)
                seen.append(float(state[0]["params"]["emb_fc_0"][0, 0]))
                calls.append((float(lr), float(lamb)))
                fill = lambda t: jax.tree_util.tree_map(
                    lambda a: jnp.full_like(a, e + 1.0), t)
                return (fill(state[0]), fill(state[1])), {
                    "loss": jnp.float32(losses[e])}

            def evaluate(self, params, images, labels, bsz):
                return vals[len(seen) - 1]

        trainable = _jnp(_stub_tree())
        train = jhat.hat_train_task
    else:
        class Engine:
            smax = SMAX
            device = torch.device("cpu")
            mesh = Mesh()

            def train_epoch(self, state, images, labels, perm, gen, lr,
                            lamb, bsz):
                e = len(seen)
                seen.append(float(
                    state[0]["params"]["emb_fc_0"][0, 0].detach()))
                calls.append((float(np.float32(lr)),
                              float(np.float32(lamb))))
                fill = lambda t: {k: ({n: torch.full_like(a, e + 1.0)
                                       for n, a in v.items()})
                                  for k, v in t.items()}
                return (fill(state[0]), fill(state[1])), {
                    "loss": torch.tensor(losses[e])}

            def evaluate(self, trainable, images, labels, bsz):
                return vals[len(seen) - 1]

        trainable = that.hat_from_host(_stub_tree(), "cpu", True)
        train = that.hat_train_task
    data = np.zeros((8, 4, 4, 3), np.uint8)
    lab = np.zeros(8, np.int32)
    td = types.SimpleNamespace(
        train=types.SimpleNamespace(images=data, labels=lab),
        val=types.SimpleNamespace(images=data, labels=lab))
    best, acc = train(Engine(), str(exp_dir), trainable, td, batch_size=4,
                      log=lines.append, **kw)
    ck = jio.load(os.path.join(str(exp_dir), EPOCH_CKPT_FILENAME))
    ck = {k: ck[k] for k in ("epoch", "lr", "patience", "best_acc",
                             "warmup")}
    best_fill = float(np.asarray(best["params"]["emb_fc_0"])[0, 0])
    return lines, seen, calls, (acc, best_fill), ck


NAN = float("nan")
CONTROLLER_CASES = {
    # a NaN epoch inside the warm-up: containment, then the warm-up exit on
    # that epoch, capped at the cut lr, and the periodic checkpoint
    "containment_warmup": (
        [1.0, 0.9, NAN, 0.8, 0.8, 0.8], [0.5, 0.6, 0.0, 0.55, 0.55, 0.55],
        dict(nepochs=6, lr=1.0, lamb=0.1, warmup=True, warmup_lr=0.01,
             warmup_epochs=2)),
    # no val gain after epoch 1: lr / 3 at half patience, then the
    # min-epoch guard keeps training past patience 0 until epoch 14
    "patience_min_epochs": (
        [1.0 - 0.01 * e for e in range(20)], [0.5, 0.6] + [0.6] * 18,
        dict(nepochs=20, lr=0.1, lamb=0.5, min_epochs=14)),
    # a soft divergence (finite, above 2 best + 2) before any best model:
    # the task-start weights come back; then one below the lr floor stops
    "soft_divergence_floor": (
        [1.0, 5.0, 0.9, 50.0, 0.9], [0.0, 0.2, 0.3, 0.4, 0.5],
        dict(nepochs=5, lr=8e-5, lamb=0.5)),
}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_controller_decisions_match(tmp_path, case):
    losses, vals, kw = CONTROLLER_CASES[case]
    out = {pkg: _run_controller(pkg, tmp_path / pkg, losses, vals, **kw)
           for pkg in ("jax", "port")}
    for got, want in zip(out["port"], out["jax"]):
        assert got == want
    lines = out["port"][0]
    assert any("diverged" in ln for ln in lines) == (case != "patience_"
                                                     "min_epochs")


def test_controller_resumes_from_the_epoch_checkpoint(tmp_path):
    """Both packages stop after 7 epochs (checkpoints at epochs 5 and 6),
    then resume to 16: the same decisions, from the same checkpoint; each
    also resumes from the other's checkpoint."""
    losses = [1.0 - 0.01 * e for e in range(16)]
    vals = [0.1 * e for e in range(4)] + [0.35] * 12
    kw = dict(lr=0.1, lamb=0.5, warmup=True, warmup_epochs=3)
    out = {}
    for pkg in ("jax", "port"):
        _run_controller(pkg, tmp_path / pkg, losses, vals, nepochs=7, **kw)
        # the stub counts epochs from 0: hand it the resumed tail
        out[pkg] = _run_controller(pkg, tmp_path / pkg, losses[7:],
                                   vals[7:], nepochs=16, **kw)
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == "HAT resumed epoch 7 lr=0.1"
    assert out["port"][1][0] == 7.0  # the checkpoint's weights came back
    # cross: the port resumes the JAX package's checkpoint and vice versa
    for pkg, other in (("port", "jax"), ("jax", "port")):
        d = tmp_path / f"{pkg}_from_{other}"
        _run_controller(other, d, losses, vals, nepochs=7, **kw)
        assert _run_controller(pkg, d, losses[7:], vals[7:], nepochs=16,
                               **kw) == out[pkg]


# ---------------------------------------------------------------------------
# files: each package evaluates the other's HAT sequence
# ---------------------------------------------------------------------------

MODEL, DS = "tiny_CNN_cl_32_32", "synthetic_2t_4c_32px"
TRAIN = dict(model_name=MODEL, ds_name=DS, num_epochs=2, batch_size=32,
             lr_grid=(1e-2,))
ARGV = [MODEL, "--ds_name", DS, "--num_epochs", "2", "--batch_size", "32",
        "--lr_grid", "1e-2", "--device", "cpu", "--method_name", "HAT",
        "--max_attempts_per_task", "1", "--test"]


def _use(root):
    os.environ["CLSURVEY_ROOT"] = str(root)
    for mod in (jconfig, tconfig):
        mod.set_config(None)
        mod.load_config(refresh=True)


def _results(root):
    parent = os.path.join(str(root), "results", "test", "results", DS,
                          "HAT", MODEL, "demo")
    (exp,) = os.listdir(parent)
    return {fn: jio.load(os.path.join(parent, exp, fn))
            for fn in sorted(os.listdir(os.path.join(parent, exp)))}


def _same_results(got, want):
    assert sorted(got) == sorted(want) and len(want) == 2
    for fn, w in want.items():
        g, w = got[fn]["HAT"], w["HAT"]
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


def test_the_port_evaluates_a_jax_trained_hat_sequence(restore_env,
                                                       tmp_path, capsys):
    _use(tmp_path / "jax")
    jmain(JRunArgs(method_name="HAT", max_attempts_per_task=1, test=True,
                   **TRAIN))
    want = _results(tmp_path / "jax")
    _use(_copy(tmp_path / "jax", tmp_path / "port"))
    capsys.readouterr()
    tmain.cli(ARGV)
    assert "HAT epoch" not in capsys.readouterr().out  # nothing trained
    _same_results(_results(tmp_path / "port"), want)


def test_the_jax_package_evaluates_a_port_trained_hat_sequence(
        restore_env, tmp_path, capsys):
    _use(tmp_path / "port")
    manager = tmain.cli(ARGV)  # the CLI on the CPU, from scratch
    assert [len(r["seq_res"]) for r in manager.extras["eval_results"]] \
        == [2, 1]
    best = tio.load(manager.best_model_path(2, create=False))
    assert best["meta"]["hat"] and set(best["params"]) == {
        "conv_0", "conv_1", "fc_0", "fc_1", "emb_conv_0", "emb_conv_1",
        "emb_fc_0", "emb_fc_1"}
    assert best["params"]["conv_1"]["kernel"].shape == (3, 3, 8, 16)
    assert max(float(np.abs(v).max()) for k, v in best["params"].items()
               if k.startswith("emb_")) <= that.THRES_EMB
    want = _results(tmp_path / "port")
    _use(_copy(tmp_path / "port", tmp_path / "jax"))
    capsys.readouterr()
    jmain(JRunArgs(method_name="HAT", max_attempts_per_task=1, test=True,
                   **TRAIN))
    assert "HAT epoch" not in capsys.readouterr().out
    _same_results(_results(tmp_path / "jax"), want)


def test_splits_are_placed_whole_at_any_budget(restore_env, tmp_path,
                                               monkeypatch):
    """HAT places its splits on the device whole, whatever the data
    budget, as the JAX package does: at a budget of 0 the CLI trains a
    task and evaluates it."""
    monkeypatch.setenv("CLSURVEY_DATA_BUDGET_MB", "0")
    _use(tmp_path)
    manager = tmain.cli(ARGV + ["--max_task_count", "1"])
    assert [len(r["seq_res"]) for r in manager.extras["eval_results"]] \
        == [1]
    assert tio.load(manager.best_model_path(1, create=False))["meta"]["hat"]
