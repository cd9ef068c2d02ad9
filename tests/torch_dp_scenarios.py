"""Data-parallel scenarios of clsurvey_torch, run by
``tests/test_torch_port_dp.py`` once in a process without a group (dp-1)
and once in each rank of a 2-process gloo group on the CPU (dp-2).

Each scenario builds its inputs from numpy seeds, runs one piece of the
port under the installed mesh and returns numpy results; under a group it
also holds the final state with ``mesh.assert_replicated``, which raises on
every rank when the ranks drifted apart. This module imports torch and
clsurvey_torch only, never JAX, so that a rank starts in seconds.

    python tests/torch_dp_scenarios.py OUT_DIR WORLD RANK NAMES...

writes ``OUT_DIR/w{WORLD}_r{RANK}.pkl`` ({name: results}). With WORLD 2 the
ranks meet at the ``file://`` store ``OUT_DIR/store``."""

from __future__ import annotations

import glob
import os
import pickle
import sys
from collections import OrderedDict

import numpy as np
import torch

from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.methods import ebll as tebll, hat as that
from clsurvey_torch.methods import pathnet as tpath
from clsurvey_torch.methods import rehearsal as treh
from clsurvey_torch.methods.base import UpdateRule
from clsurvey_torch.methods.reg_based import SIRule
from clsurvey_torch.models import registry as treg
from clsurvey_torch.models.convert import (
    batch_stats_to_jax, pathnet_params_to_jax)
from clsurvey_torch.ops import importance as timp
from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils import io as tio

NAME, PX = "tiny_CNN_cl_32_32", 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
N_TRAIN, N_VAL, BS = 64, 41, 16
CLI_ARGV = ["tiny_CNN_cl_32_32_BN", "--method_name", "finetuning",
            "--ds_name", "synthetic_2t_4c_32px_16n", "--num_epochs", "2",
            "--batch_size", "16", "--lr_grid", "1e-2", "--device", "cpu",
            "--test"]


def rows(n, seed, classes=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, PX, PX, 3), dtype=np.uint8),
            rng.integers(0, classes, (n,)).astype(np.int32))


def perm(n, seed=1):
    return np.random.default_rng(seed).permutation(n)


def model(name=NAME, max_tasks=2, seed=3) -> dict:
    spec = treg.parse_model_name("", name, (PX, PX))
    return treg.init_model_state(spec, seed, max_tasks, 4, [4] * max_tasks)


def context(mesh, name=NAME, rule=None, task=0, augment=False):
    spec = treg.parse_model_name("", name, (PX, PX))
    return ttrain.make_context(
        spec, task=task, n_tasks=task + 1, class_counts=[4] * (task + 1),
        mean=MEAN, std=STD, update_rule=rule or UpdateRule(), device="cpu",
        mesh=mesh, augment=augment)


def _state(ctx, m, mstate):
    state = ttrain.state_from_model(m, None, "cpu")
    state.mstate = mstate
    return state


def _state_out(ctx, state, metrics, mesh, extra=None) -> dict:
    mesh_lib.assert_replicated(
        [state.trainable, state.batch_stats, state.momentum, state.mstate],
        mesh, "train state")
    out = {"trainable": ttrain.trainable_to_host(state.trainable),
           "momentum": ttrain.trainable_to_host(state.momentum),
           "batch_stats": batch_stats_to_jax(state.batch_stats),
           "metrics": {k: float(v) for k, v in metrics.items()}}
    out.update(extra or {})
    return out


def _epoch(mesh, name, rule, mstate_fn, task=0, augment=True, seed=0,
           max_tasks=2):
    """One epoch of ``rule`` on N_TRAIN random rows at batch BS."""
    ctx = context(mesh, name, rule, task, augment)
    m = model(name, max_tasks)
    state = _state(ctx, m, mstate_fn(ctx, m))
    images, labels = rows(N_TRAIN, seed, 4)
    state, metrics = ttrain.Engine(ctx).train_epoch(
        state, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.from_numpy(perm(N_TRAIN)), torch.Generator().manual_seed(5),
        0.05, BS)
    return ctx, state, metrics


def base_state(ctx, m):
    return UpdateRule().init_state(None, {}, ctx)


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def scn_plain(mesh):
    """No augmentation, the given permutation: JAX's 2-device mesh too."""
    ctx, state, metrics = _epoch(mesh, NAME, None, base_state,
                                 augment=False)
    return _state_out(ctx, state, metrics, mesh)


def scn_bn(mesh):
    ctx, state, metrics = _epoch(mesh, NAME + "_BN", None, base_state,
                                 augment=False)
    return _state_out(ctx, state, metrics, mesh)


def scn_si(mesh):
    """SI on a batch-norm dropout model with flips: global draws, global
    moments, and the global gradient in ``post_step``."""
    rule = SIRule()
    ctx, state, metrics = _epoch(
        mesh, NAME + "_BN_DROP", rule,
        lambda ctx, m: rule.init_state(
            ttrain.trainable_from_host(m, "cpu", False),
            OrderedDict(**{"lambda": 0.5}), ctx))
    return _state_out(ctx, state, metrics, mesh, {
        "w": {k: v.detach().numpy() for k, v in state.mstate["w"].items()}})


def _memory(n_tasks, m_rows, filled, seed):
    mem = treh.fresh_task_memory(n_tasks, m_rows, (PX, PX))
    for t, n in enumerate(filled):
        imgs, labs = rows(n, seed + t)
        mem["mem_images"][t, :n] = torch.from_numpy(imgs)
        mem["mem_labels"][t, :n] = torch.from_numpy(labs)
        mem["mem_count"][t] = n
    return mem


def scn_gem(mesh):
    """GEM at task 2 on a batch-norm dropout model: memory chunks of 10
    rows of which 7 are valid, the QP, the ring."""
    rule = treh.GEMRule(10, mem_batch=10)
    ctx, state, metrics = _epoch(
        mesh, NAME + "_BN_DROP", rule,
        lambda ctx, m: rule.init_state(None, {"margin": 0.5}, ctx,
                                       memory=_memory(2, 10, [7], 11)),
        task=1)
    mem = treh.memory_to_host(state.mstate["memory"])
    return _state_out(ctx, state, metrics, mesh, {"memory": mem})


def scn_replay(mesh):
    """The partial-memory replay baseline at task 3: 5 exemplar rows a
    batch, 2 from each past task and 1 remainder row (fewer rows than
    ranks: every rank takes it, counted once)."""
    rule = treh.ReplayRule(8, 5)
    ctx, state, metrics = _epoch(
        mesh, NAME + "_BN", rule,
        lambda ctx, m: rule.init_state(None, {}, ctx,
                                       memory=_memory(3, 8, [8, 6], 21)),
        task=2, max_tasks=3)
    return _state_out(ctx, state, metrics, mesh, {
        "memory": treh.memory_to_host(state.mstate["memory"])})


def scn_icarl(mesh):
    rule = treh.ICarlRule(5)
    images, labels = rows(12, 31)
    rng = np.random.default_rng(32)
    store = {"images": images, "labels": labels,
             "targets": rng.normal(0, 1, (12, 8)).astype(np.float32),
             "task_ids": np.zeros(12, np.int32), "count": np.int32(12)}
    ctx, state, metrics = _epoch(
        mesh, NAME + "_BN", rule,
        lambda ctx, m: rule.init_state(None, {"lambda": 2.0}, ctx,
                                       exemplars=store), task=1)
    return _state_out(ctx, state, metrics, mesh)


def scn_ebll(mesh):
    """EBLL at task 2: the teacher's distillation plus one encoder's code
    term, both batch means."""
    rule = tebll.EBLLRule()
    teacher = model(NAME, seed=9)
    spec = treg.parse_model_name("", NAME, (PX, PX))
    x_dim = int(tebll.conv_feats(
        spec.make_backbone(), ttrain.trainable_from_host(
            teacher, "cpu", False)["params"],
        torch.zeros(1, PX, PX, 3)).shape[-1])
    ae = tio.to_host(tebll.init_autoencoder(
        torch.Generator().manual_seed(4), x_dim, 16))
    ctx, state, metrics = _epoch(
        mesh, NAME, rule,
        lambda ctx, m: rule.init_state(
            None, {"reg_lambda": 1.0, "ebll_reg_alpha": 0.5}, ctx,
            prev_model=teacher, encoders=[ae]), task=1)
    return _state_out(ctx, state, metrics, mesh)


def scn_importance(mesh):
    """EWC's Fisher, MAS's omega and mode-IMM's precision of a batch-norm
    model, resident and (EWC, MAS) streamed at a data budget of 0."""
    ctx = context(mesh, NAME + "_BN")
    m = model(NAME + "_BN")
    state = ttrain.state_from_model(m, None, "cpu")
    params = state.trainable["params"]
    images, labels = rows(N_VAL, 41)
    out = {}
    args = (ctx, params, state.batch_stats, m["heads"], 0)
    for where, budget in (("resident", None), ("streamed", "0")):
        if budget is not None:
            os.environ["CLSURVEY_DATA_BUDGET_MB"] = budget
        x = images if budget is not None else torch.from_numpy(images)
        try:
            out[f"ewc_{where}"] = timp.ewc_fisher(*args, x, labels, BS)
            out[f"mas_{where}"] = timp.mas_importance(*args, x, chunk=8)
        finally:
            os.environ.pop("CLSURVEY_DATA_BUDGET_MB", None)
    out["imm"] = timp.imm_mode_fisher(
        *args, [images, images[:20]], BS,
        generator=torch.Generator().manual_seed(6))
    out = {k: {n: t.detach().numpy() for n, t in v.items()}
           for k, v in out.items()}
    mesh_lib.assert_replicated(out, mesh, "importance")
    return out


def scn_evaluate(mesh):
    """Per-class counters at batch 30 on 41 rows (the last batch of 11
    padded to a multiple of the ranks)."""
    ctx = context(mesh, NAME + "_BN")
    state = ttrain.state_from_model(model(NAME + "_BN"), None, "cpu")
    images, labels = rows(N_VAL, 42)
    acc, pcc, pct = ttrain.Engine(ctx).evaluate(
        state.trainable, state.batch_stats, torch.from_numpy(images),
        labels, 30)
    return {"acc": acc, "pcc": pcc, "pct": pct}


def scn_streamed(mesh):
    """A streamed epoch of 100 rows in chunks of 48 (three batches of 16),
    flips, dropout and batch-norm on."""
    name = NAME + "_BN_DROP"
    ctx = context(mesh, name, augment=True)
    state = _state(ctx, model(name), UpdateRule().init_state(None, {}, ctx))
    images, labels = rows(100, 51)
    state, metrics = ttrain.Engine(ctx).train_epoch_chunked(
        state, images, labels, perm(100), torch.Generator().manual_seed(4),
        1e-2, 16, 48, ttrain.ChunkFeed(images.shape[1:], 48, "cpu"))
    return _state_out(ctx, state, metrics, mesh)


def scn_resident_padded(mesh):
    """The resident epoch over the streamed epoch's wrap-padded
    permutation, with the same generator."""
    name = NAME + "_BN_DROP"
    ctx = context(mesh, name, augment=True)
    state = _state(ctx, model(name), UpdateRule().init_state(None, {}, ctx))
    images, labels = rows(100, 51)
    p = perm(100)
    state, metrics = ttrain.Engine(ctx).train_epoch(
        state, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.from_numpy(np.concatenate([p, p[:44]])),
        torch.Generator().manual_seed(4), 1e-2, 16)
    return _state_out(ctx, state, metrics, mesh)


def scn_hat(mesh):
    """A HAT epoch at task 2 (mask_pre, mask_back, the sparsity term)
    with flips, then eval at batch 30 on 41 rows."""
    spec = treg.parse_model_name("", NAME, (PX, PX))
    net = that.HATVGG(spec.arch, spec.classifier_dims, 2, (PX, PX))
    net.reset_parameters(torch.Generator().manual_seed(2))
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    smax = 50.0
    pre = that.compute_mask_pre(params, net.emb_names, 1, smax)
    back = that.compute_mask_back(net, params, pre)
    eng = that.HATEngine(net, spec, 1, [4, 4], MEAN, STD, smax, pre, back,
                         weight_decay=1e-3, device="cpu", mesh=mesh)
    rng = np.random.default_rng(7)
    tr = {"params": params, "heads": {
        "kernel": torch.from_numpy(
            rng.normal(0, 0.1, (2, 32, 4)).astype(np.float32)),
        "bias": torch.zeros(2, 4)}}
    for t in ttrain.tree_leaves(tr):
        t.requires_grad_()
    images, labels = rows(N_TRAIN, 8)
    state, metrics = eng.train_epoch(
        (tr, ttrain.tree_zeros_like(tr)), torch.from_numpy(images),
        torch.from_numpy(labels).long(), torch.from_numpy(perm(N_TRAIN)),
        torch.Generator().manual_seed(3), 0.05, 0.75, BS)
    mesh_lib.assert_replicated(list(state), mesh, "HAT state")
    val, val_labels = rows(N_VAL, 9)
    return {"trainable": that.hat_to_host(state[0]),
            "momentum": that.hat_to_host(state[1]),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "val_acc": eng.evaluate(state[0], torch.from_numpy(val),
                                    val_labels, 30)}


def scn_pathnet(mesh):
    """A PathNet epoch at task 2 (128 rows: two batches of 64, a path that
    repeats a module, a frozen module), then the tournament's eval."""
    M = 4
    net = tpath.PathNetVGG("tiny_CNN", (32, 32), (PX, PX), M)
    net.reset_parameters(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(4)
    tr = {"params": {k: v.detach().clone()
                     for k, v in net.named_parameters()},
          "heads": {"kernel": torch.from_numpy(rng.normal(
              0, 0.1, (2, 8, 4)).astype(np.float32)),
              "bias": torch.zeros(2, 4)}}
    for t in ttrain.tree_leaves(tr):
        t.requires_grad_()
    path = np.asarray([[0, 0], [2, 1], [3, 1], [1, 2]], np.int32)
    frozen = np.zeros((net.n_layers, M), np.float32)
    frozen[:, 1] = 1.0
    fns = tpath.PathNetFns(net, MEAN, STD, [4, 4], 1, torch.device("cpu"),
                           mesh=mesh)
    images, labels = rows(128, 12)
    gates = tpath.module_train_mask(tr["params"], path, frozen, 2)
    tr, mom = fns.train_epoch(
        tr, ttrain.tree_zeros_like(tr), torch.from_numpy(images),
        torch.from_numpy(labels).long(), torch.from_numpy(perm(128)), path,
        gates, torch.Generator().manual_seed(3), 0.05)
    mesh_lib.assert_replicated([tr, mom], mesh, "PathNet state")
    val, val_labels = rows(N_VAL, 13)
    return {"params": pathnet_params_to_jax(tr["params"]),
            "heads": tio.to_host(tr["heads"]),
            "val_acc": fns.eval_acc(tr, torch.from_numpy(val), val_labels,
                                    path)}


def scn_cli(mesh, root):
    """The finetuning CLI on two tasks with ``--test``: its eval result
    dicts, the files it leaves, and this process's writes."""
    from clsurvey_torch.framework import main as tmain
    from clsurvey_torch.utils import config as tconfig

    os.environ["CLSURVEY_ROOT"] = root
    tconfig.set_config(None)
    tconfig.load_config(refresh=True)
    manager = tmain.cli(list(CLI_ARGV))
    sys.stdout = sys.__stdout__  # non-writer ranks: the CLI silenced it
    mesh_lib.barrier(mesh)
    results = {os.path.relpath(p, root): tio.load(p) for p in sorted(
        glob.glob(os.path.join(root, "**", "test_method_performances*"),
                  recursive=True))}
    files = sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, "**", "*"), recursive=True)
        if os.path.isfile(p))
    best = manager.previous_task_model_path
    return {"results": results, "files": files,
            "writes": tio.WRITES["files"],
            "best_batch_stats": tio.load(best)["batch_stats"]}


def scn_drift(mesh):
    """Rank 1's copy of a tensor made to differ: ``assert_replicated``
    must raise on every rank."""
    t = torch.arange(6.0)
    if mesh.rank == 1:
        t[4] += 1e-6
    try:
        mesh_lib.assert_replicated({"t": t}, mesh)
    except AssertionError as e:
        return {"raised": str(e)}
    return {"raised": None}


SCENARIOS = {k[4:]: v for k, v in dict(globals()).items()
             if k.startswith("scn_")}


def run(names, mesh, out_dir) -> dict:
    torch.manual_seed(0)
    out = {}
    for name in names:
        if name == "cli":
            out[name] = scn_cli(mesh, os.path.join(
                out_dir, f"cli_root_w{mesh.size if mesh.distributed else 1}"))
        else:
            out[name] = SCENARIOS[name](mesh)
    return out


def main(argv):
    out_dir, world, rank, names = argv[0], int(argv[1]), int(argv[2]), \
        argv[3:]
    torch.set_num_threads(1)
    if world > 1:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world))
        mesh = mesh_lib.make_mesh(
            "cpu", init_method="file://" + os.path.join(out_dir, "store"))
    else:
        mesh = mesh_lib.Mesh()
    mesh_lib.set_mesh(mesh)
    results = run(names, mesh, out_dir)
    with open(os.path.join(out_dir, f"w{world}_r{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    mesh_lib.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
