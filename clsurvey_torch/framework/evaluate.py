"""Evaluation — the (ref task x trained model) accuracy matrix.

Counterpart of ``clsurvey_tpu/framework/evaluate.py``; behavior of
ref:src/framework/eval.py:11-247: for each reference task i, evaluate every
model trained at task >= i on task i's test split (with task i's head),
compute per-task forgetting ``acc_first_model - acc_current``, and save
per-ref-task result dicts

    {eval_name: {'seq_res': [...], 'seq_forgetting': [...],
                 'seq_head_acc': [...]}}

to ``test_method_performances<method><i>.pth`` — the exact artifact shape the
reference's postprocessing/plot pipeline consumes
(ref:src/framework/eval.py:176-185). A split above the device data budget
streams through the engine's ``evaluate_chunked``. Under a process group
every rank evaluates its rows of every batch, the counters are all-reduced
(``Engine.evaluate``), and the writer writes the result files."""

from __future__ import annotations

import os
import traceback
from collections import OrderedDict

import numpy as np
import torch

from clsurvey_torch.engine.train import (
    Engine, data_budget_bytes, make_context, place, stream_chunk_rows,
    trainable_from_host)
from clsurvey_torch.methods.base import UpdateRule
from clsurvey_torch.models.convert import batch_stats_from_jax
from clsurvey_torch.utils import io, paths as paths_lib


def _eval_split(manager, task_data):
    """Pick the evaluated split (``--test_set``,
    ref:src/framework/main.py:74 + inference.py subset arg)."""
    subset = getattr(manager.args, "test_set", "test")
    return getattr(task_data, subset)


def _eval_engine(manager, model: dict, task: int, n_tasks: int):
    """(engine, trainable, batch_stats) for a model dict, on the run's
    device, without augmentation."""
    ctx = make_context(
        spec=manager.model_spec, task=task, n_tasks=n_tasks,
        class_counts=np.asarray(model["heads"]["class_counts"]),
        mean=manager.dataset.mean, std=manager.dataset.std,
        update_rule=UpdateRule(), device=manager.args.device,
        augment=False)
    trainable = trainable_from_host(model, ctx.device, requires_grad=False)
    batch_stats = batch_stats_from_jax(model.get("batch_stats"), ctx.device)
    return Engine(ctx), trainable, batch_stats


def default_inference_eval(manager, model, ref_task: int) -> float:
    """Evaluate a trained model dict on ref_task's chosen split with
    ref_task's head (ref:src/framework/inference.py:8-87 +
    ref:src/methods/method.py:1066-1087)."""
    task_data = manager.dataset.get_task_dataset(ref_task)
    split = _eval_split(manager, task_data)
    n_tasks = max(ref_task, int(model["meta"].get("n_tasks", ref_task)))
    engine, trainable, batch_stats = _eval_engine(manager, model,
                                                  ref_task - 1, n_tasks)
    acc, per_class_c, per_class_t = _evaluate_split(
        engine, trainable, batch_stats, split.images, split.labels,
        manager.args.batch_size)
    # per-class counters: printed by the reference per eval
    # (ref:src/framework/inference.py:60-80) and stashed for the result
    # dict's 'seq_per_class' entry
    per_class_acc = per_class_c / np.maximum(per_class_t, 1)
    manager.extras["last_per_class"] = {
        "correct": per_class_c.astype(int).tolist(),
        "total": per_class_t.astype(int).tolist(),
    }
    # per-class accuracy named like the reference's printout
    # (ref:src/framework/inference.py:78-81 'Accuracy of <class> ...')
    names = list(task_data.classes) or [
        str(i) for i in range(int(task_data.num_classes))]
    shown = ", ".join(
        f"{n}={a:.2f}" for n, a in
        zip(names, per_class_acc[: int(task_data.num_classes)]))
    print(f"    per-class acc: [{shown}]")
    return acc


def eval_task_steps_accuracy(args, manager, ref_task: int,
                             model_paths: list) -> dict:
    """Accuracy of every model >= ref_task on ref_task
    (ref:src/framework/eval.py:204-247). Matching the reference's artifact
    exactly: ``seq_forgetting`` has no self-comparison entry (len =
    len(seq_res)-1) and ``seq_head_acc`` stays empty (head_accuracy is
    never set in the reference either, eval.py:214,239-240)."""
    seq_res: list = []
    seq_head_acc: list = []
    seq_per_class: list = []
    for trained_idx in range(ref_task, len(model_paths) + 1):
        model_path = model_paths[trained_idx - 1]
        manager.extras.pop("last_per_class", None)
        try:
            if hasattr(manager.method, "inference_eval"):
                acc = manager.method.inference_eval(
                    manager, model_path, ref_task, trained_idx)
            else:
                acc = default_inference_eval(
                    manager, _load_model_cached(manager, model_path),
                    ref_task)
        except Exception:
            # a broken model aborts only the remaining models of this ref
            # task; the partial sequence is kept
            # (ref:src/framework/eval.py:240-247)
            print(f"ERROR in Testing model, trained until TASK "
                  f"{trained_idx}")
            traceback.print_exc()
            break
        print(f"  ref_task {ref_task} @ model {trained_idx}: acc={acc:.4f}")
        seq_res.append(acc * 100.0)  # reference stores percentages
        seq_per_class.append(manager.extras.pop("last_per_class", None))
    return {"seq_res": seq_res, "seq_head_acc": seq_head_acc,
            "seq_per_class": seq_per_class}


def _load_model_cached(manager, model_path):
    """The (task x model) matrix revisits model k for every ref task <= k
    — O(T^2) pickle loads without a cache. Small LRU in manager.extras."""
    if not isinstance(model_path, str):
        return model_path
    cache = manager.extras.setdefault("eval_model_cache", OrderedDict())
    model = cache.get(model_path)
    if model is None:
        model = io.load(model_path)
        cache[model_path] = model
    cache.move_to_end(model_path)
    while len(cache) > 4:
        cache.popitem(last=False)
    return model


def eval_all_models_all_tasks(args, manager, model_paths: list,
                              out_dir: str) -> list:
    results = []
    # eval range control (ref:src/framework/eval.py:156:
    # range(test_starting_task_count - 1, test_max_task_count))
    t_start = getattr(args, "test_starting_task_count", 1) or 1
    t_max = getattr(args, "test_max_task_count", None) or len(model_paths)
    for ref_task in range(t_start, min(t_max, len(model_paths)) + 1):
        # the reference names artifacts by 0-based dataset_index
        # (ref:src/utilities/utils.py:220-228 get_perf_output_filename)
        out_path = os.path.join(
            out_dir, f"test_method_performances"
            f"{manager.method.eval_name}{ref_task - 1}.pth")
        if (not getattr(args, "test_overwrite_mode", False)
                and not getattr(args, "debug", False)
                and io.exists(out_path)):
            # safety check (ref:src/framework/eval.py:161-164)
            print("EVAL already done, can only rerun in overwrite mode")
            break
        try:
            res = eval_task_steps_accuracy(args, manager, ref_task,
                                           model_paths)
            first = res["seq_res"][0]
            res["seq_forgetting"] = [first - acc
                                     for acc in res["seq_res"][1:]]
            # reference shape: seq_res/seq_forgetting are one-key dicts
            # {dataset_index: [...]} (ref:src/framework/eval.py:204-214,
            # 178-180); seq_head_acc stays a flat list
            out = {manager.method.eval_name: {
                "seq_res": {ref_task - 1: res["seq_res"]},
                "seq_forgetting": {ref_task - 1: res["seq_forgetting"]},
                "seq_head_acc": res["seq_head_acc"],
                "seq_per_class": res["seq_per_class"],
            }}
            # debug runs never persist results (ref:eval.py:182-184)
            if not getattr(args, "debug", False):
                io.save_compat(out, out_path)
            results.append(res)
        except Exception as e:
            print(f"EVAL ERROR task {ref_task}: {e}")
            traceback.print_exc()
            break
    return results


def eval_single_model_all_tasks(args, manager, model_path, out_dir: str
                                ) -> list:
    """Joint: one model, per-task masked shared output
    (ref:src/framework/eval.py:69-143)."""
    model = io.load(model_path) if isinstance(model_path, str) else model_path
    results = []
    offset = 0
    counts = np.asarray(model["heads"]["class_counts"])
    engine, trainable, batch_stats = _eval_engine(manager, model, 0, 1)
    seq_res: list = []
    t_start = getattr(args, "test_starting_task_count", 1) or 1
    t_max = (getattr(args, "test_max_task_count", None)
             or manager.dataset.task_count)
    for ref_task in range(1, manager.dataset.task_count + 1):
        td = manager.dataset.get_task_dataset(ref_task)
        ncls = td.num_classes
        lo = offset
        if not (t_start <= ref_task <= t_max):
            offset += ncls  # class offsets still advance outside the range
            continue
        split = _eval_split(manager, td)

        def predict(ctx_, tr, feats, lo=lo, ncls=ncls):
            logits = ctx_.task_logits(tr, feats)
            cols = torch.arange(logits.shape[-1], device=logits.device)
            return logits.masked_fill((cols < lo) | (cols >= lo + ncls),
                                      -1e10)

        acc, _, _ = _evaluate_split(
            engine, trainable, batch_stats, split.images,
            np.asarray(split.labels) + lo, args.batch_size,
            predict=predict,
            n_counter_classes=int(np.max(counts)))
        seq_res.append((ref_task - 1, acc * 100.0))
        results.append({"seq_res": [acc * 100.0], "seq_forgetting": [],
                        "seq_head_acc": []})
        offset += ncls
        print(f"  JOINT ref_task {ref_task}: acc={acc:.4f}")
    # single full-batch artifact, the reference's Joint format
    # (ref:src/framework/eval.py:116-141 + utils.py:225-226); debug runs
    # never persist results (ref:eval.py:136-138)
    if not getattr(args, "debug", False):
        if t_start <= 1 and t_max >= manager.dataset.task_count:
            # full range: the reference's flat list, task 1 first
            payload = [acc for _, acc in seq_res]
        else:
            # restricted range: a flat list would silently re-anchor at
            # task 1 in every consumer — key by 0-based dataset_index
            payload = {di: [acc] for di, acc in seq_res}
        io.save_compat(
            {manager.method.eval_name: {"seq_res": payload}},
            os.path.join(out_dir,
                         "test_method_performancesJOINT_FULL_BATCH.pth"))
    return results


def _evaluate_split(engine, trainable, batch_stats, images, labels,
                    batch_size, **kwargs):
    """Eval of one split: resident on the engine's device, or streamed in
    chunks of half the device data budget where the split is above it
    (the same counters either way)."""
    images = np.asarray(images)
    labels = np.asarray(labels)
    if images.nbytes > data_budget_bytes():
        return engine.evaluate_chunked(
            trainable, batch_stats, images, labels, batch_size,
            stream_chunk_rows(images.nbytes // max(images.shape[0], 1)),
            **kwargs)
    return engine.evaluate(trainable, batch_stats,
                           place(images, engine.ctx.device), labels,
                           batch_size, **kwargs)


def main(args, manager, ds_paths, model_paths):
    """ref:src/framework/eval.py:11-66."""
    out_dir = paths_lib.get_test_results_path(
        manager.dataset.name, manager.method.eval_name,
        manager.model_spec.name, manager.gridsearch_name, manager.exp_name,
        subset=getattr(args, "test_set", "test"))
    if hasattr(manager.method, "eval_model_preprocessing"):
        model_paths = manager.method.eval_model_preprocessing(
            args, manager, model_paths)
    if not model_paths:
        # task 1 failed with a caught RuntimeError -> the loop broke with
        # nothing trained; report instead of IndexError deep in eval
        print("EVAL SKIPPED: no trained models to evaluate")
        return []
    if manager.method.name == "joint":
        return eval_single_model_all_tasks(args, manager, model_paths[-1],
                                           out_dir)
    return eval_all_models_all_tasks(args, manager, model_paths, out_dir)
