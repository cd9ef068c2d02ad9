"""Task-loop entry point (ref:src/framework/main.py:77-300).

Drives a method over a task sequence: parse method/dataset/model, set up the
shared first-task base model, then per task dispatch to the LR grid
(``no_framework`` methods) or the two-phase hyperparameter framework.
Counterpart of ``clsurvey_tpu/framework/main.py``: the same flags plus
``--device`` (default ``cuda``), and ``--test`` runs the eval matrix
afterwards. ``--profile`` traces the first task with ``torch.profiler``
(the CPU, and the card's kernels on ``cuda``) into a Chrome trace under
``<tr_results_root_path>/profile/<ds_name>_<method_name>/``, and writes the
program's spans of the task (``utils/spans.py``: each train step, conv
forward, input and weight gradient, pool call, eval and chunk gather and
wait, with device ms on the card) beside it as ``<stamp>-<pid>.spans.json``.

Data parallel: under ``torchrun`` the run is data parallel over its ranks
(``parallel/mesh.py``), with no flag, as the JAX CLI is over its mesh.
Every rank runs the whole program; rank 0 alone writes the files, prints
and profiles (the other ranks' standard output goes to ``os.devnull``):

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m clsurvey_torch.framework.main tiny_CNN_cl_32_32 \
        --method_name finetuning --ds_name synthetic_2t_4c_32px --device cpu

    python -m clsurvey_torch.framework.main small_VGG9_cl_128_128 \
        --method_name SI --ds_name synthetic_4t_20c_64px_400n \
        --runmode first_task_basemodel_dump --num_epochs 10 \
        --lr_grid 5e-3 --boot_lr_grid 5e-3
    python -m clsurvey_torch.framework.main small_VGG9_cl_128_128 \
        --method_name EWC --ds_name synthetic_4t_20c_64px_400n \
        --runmode timing_mode --gridsearch_name timing_mode --test
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from clsurvey_torch import methods as methods_lib
from clsurvey_torch.data import registry as data_lib
from clsurvey_torch.framework import hyperparam, lr_grid
from clsurvey_torch.framework.common import Manager, RunArgs
from clsurvey_torch.models import registry as models_lib
from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils import device as device_lib
from clsurvey_torch.utils import io, paths as paths_lib, rng as rng_lib
from clsurvey_torch.utils import spans, timing
from clsurvey_torch.utils.config import load_config


def _si_base_model_path(args: RunArgs, manager: Manager) -> str:
    """The shared SI first-task base model every non-scratch method starts
    from (ref:src/framework/main.py:226-233 + utils.py:146-163)."""
    spec = manager.model_spec
    base = paths_lib.get_starting_model_path(
        manager.dataset.name, spec.name,
        init_model_name=models_lib.get_init_modelname(
            args.num_epochs, args.batch_size,
            list(args.boot_lr_grid or args.lr_grid),
            args.weight_decay, spec.name))
    if not io.exists(base):
        raise FileNotFoundError(
            f"First-task base model missing: {base}\nRun with "
            f"--runmode first_task_basemodel_dump first "
            f"(ref:src/main_tinyimagenet.sh:28-33).")
    return base


def resolve_task_model_path(args: RunArgs, manager: Manager,
                            task_counter: int) -> str:
    """The on-disk best model that chained out of ``task_counter``.

    iCaRL (and GEM's task-1 wrap) postprocess their best model — the
    exemplar/memory aux rides inside — under a different name; prefer it
    (ref:src/framework/main.py:234-236 resolves best_model.pth.tar)."""
    base = manager.best_model_path(task_counter, create=False)
    postprocessed = base.replace(
        paths_lib.BEST_MODEL_FILENAME,
        paths_lib.BEST_MODEL_POSTPROCESSED_FILENAME)
    for candidate in (postprocessed, base):
        if io.exists(candidate):
            return candidate
    if task_counter == 1 and not manager.method.start_scratch:
        # non-scratch methods reuse the SI base model at task 1 and write
        # nothing of their own under task_1/
        return _si_base_model_path(args, manager)
    raise FileNotFoundError(
        f"NOT EXISTING previous_task_model_path = {base} "
        f"(requires task {task_counter}'s completed best model, "
        f"ref:src/framework/main.py:237-238)")


def get_init_model_path(args: RunArgs, manager: Manager) -> str:
    """First-task init: methods that don't start from scratch reuse the SI
    first-task base model; a mid-sequence restart
    (``--starting_task_count > 1``) resumes from the previous task's best
    model instead (ref:src/framework/main.py:226-241)."""
    if args.starting_task_count > 1 and args.runmode != \
            "first_task_basemodel_dump":
        # Resume from task N-1's best model (ref:src/framework/main.py:
        # 234-236), failing loudly if the sequence up to N-1 is incomplete.
        path = resolve_task_model_path(args, manager,
                                       args.starting_task_count - 1)
        print("Starting from model =", path)
        return path
    if manager.method.start_scratch or args.runmode == \
            "first_task_basemodel_dump":
        return manager.model_spec.path  # the pickled init network
    return _si_base_model_path(args, manager)


def overwrite_dump_args(args: RunArgs, manager: Manager) -> None:
    """first_task_basemodel_dump: train task 1 with SI, shared grid name
    (ref:src/framework/main.py:280-286)."""
    args.max_task_count = 1
    args.starting_task_count = 1
    args.gridsearch_name = "first_task_basemodel"
    args.exp_name = models_lib.get_init_modelname(
        args.num_epochs, args.batch_size,
        list(args.boot_lr_grid or args.lr_grid), args.weight_decay,
        args.model_name)
    # force training of task 1 (the whole point of the dump,
    # ref:src/framework/main.py:280-286)
    manager.method.start_scratch = True


def _start_profiler(device):
    """A started ``torch.profiler`` profile: host activity, and the card's
    kernels and copies when the run is on ``cuda``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    spans.reset()
    prof.start()
    return prof


def main(args: RunArgs):
    # under torchrun: join the process group once, before anything else
    if not mesh_lib.is_writer(mesh_lib.get_mesh(args.device)):
        sys.stdout = open(os.devnull, "w")
    rng_lib.set_random(args.seed)
    cfg = load_config()
    device = device_lib.resolve(args.device)  # no card for "cuda": raise
    args.apply_runmode()

    method = methods_lib.parse(args.method_name)
    dataset = data_lib.parse(args.ds_name)
    spec = models_lib.parse_model_name(
        cfg.models_root_path, args.model_name, dataset.input_size)

    # timing_mode asks for 4 tasks: a shorter sequence runs all it has
    if args.max_task_count is None or \
            args.max_task_count > dataset.task_count:
        args.max_task_count = dataset.task_count
    if hasattr(method, "train_args_overwrite"):
        method.train_args_overwrite(args)
    method.set_hyperparams(args.hyperparams)
    method.set_hyperparams(args.static_hyperparams, static=True)

    manager = Manager(
        args=args, dataset=dataset, method=method, model_spec=spec,
        gridsearch_name=args.gridsearch_name,
        exp_name=args.exp_name or paths_lib.get_exp_name(method.hyperparams),
    )

    if args.cleanup_exp:
        assert not args.test, "Can't remove experiment results while " \
            "evaluating (ref:src/framework/main.py:143)"
        import shutil

        parent = os.path.dirname(manager.task_dir(1))

        def clean():
            if os.path.isdir(parent):
                shutil.rmtree(parent)
                print("=====> CLEANING UP EXP: starting from scratch <=====")

        mesh_lib.writer_does(clean)

    if args.runmode == "first_task_basemodel_dump":
        overwrite_dump_args(args, manager)
        manager.gridsearch_name = args.gridsearch_name
        manager.exp_name = args.exp_name
        existing = manager.best_model_path(1, create=False)
        if io.exists(existing):
            print("Base model already dumped, refusing overwrite:", existing)
            return manager

    # create-and-pickle the init network if missing (idempotent)
    models_lib.create_init_model(
        spec, args.seed,
        max_tasks=manager.max_tasks,
        classes_per_task=dataset.max_classes_per_task,
        class_counts=dataset.class_count_list() + [0] * (
            manager.max_tasks - dataset.task_count))

    manager.previous_task_model_path = get_init_model_path(args, manager)

    timer = timing.PhaseTimer()
    task_seconds = manager.extras.setdefault("task_seconds", {})
    profiler = None
    ds_paths, model_paths = [], []
    # mid-sequence restart: the earlier tasks' models already exist on
    # disk — seed the eval lists so --test still produces the full
    # (task x model) matrix (the reference instead requires a follow-up
    # rerun from task 1 whose SUCCESS flags fast-forward the loop)
    for done_task in range(1, args.starting_task_count):
        ds_paths.append(done_task)
        model_paths.append(resolve_task_model_path(args, manager,
                                                   done_task))
    for task_counter in range(args.starting_task_count,
                              args.max_task_count + 1):
        print("\n" + "*" * 70 + f"\nTRAINING Task {task_counter}\n" + "*" * 70)
        manager.set_dataset(task_counter)
        if args.profile and task_counter == args.starting_task_count \
                and mesh_lib.is_writer():
            trace_dir = os.path.join(cfg.tr_results_root_path, "profile",
                                     f"{args.ds_name}_{args.method_name}")
            os.makedirs(trace_dir, exist_ok=True)
            profiler = _start_profiler(device)
            print(f"[profiler] tracing first task -> {trace_dir}")
        try:
            with timer.phase(f"task_{task_counter}"):
                if method.no_framework:
                    # Phase-1-only methods still report a phase timing
                    # entry (ref prints phase1 time for every task,
                    # ref:src/framework/framework_train.py:237-240)
                    p1_start = time.time()
                    lr_grid.lr_grid_single_task(args, manager,
                                                save_models_mode="all")
                    hyperparam.report_phase_timing(
                        {"phase1": time.time() - p1_start},
                        manager.task_dir())
                else:
                    hyperparam.framework_single_task(args, manager)
            ds_paths.append(task_counter)
            model_paths.append(manager.previous_task_model_path)
            task_seconds[task_counter] = timer.elapsed[f"task_{task_counter}"]
            print(f"[task {task_counter}] host RSS "
                  f"{timing.host_rss_gib():.2f} GiB", flush=True)
        except RuntimeError as e:  # resumable: rerun continues mid-sequence
            print("ERROR:", e)
            traceback.print_exc()
            break
        finally:
            if profiler is not None:
                profiler.stop()
                stem = os.path.join(trace_dir, time.strftime(
                    "%Y%m%d-%H%M%S") + f"-{os.getpid()}")
                profiler.export_chrome_trace(stem + ".pt.trace.json")
                with open(stem + ".spans.json", "w") as f:
                    json.dump(spans.dump(), f)
                profiler = None
    timer.print_timing()
    timing.print_stats()

    if args.test:
        from clsurvey_torch.framework import evaluate as test_lib
        manager.extras["eval_results"] = test_lib.main(
            args, manager, ds_paths, model_paths)
    mesh = mesh_lib.get_mesh()
    if mesh.distributed:
        # every rank: the files it wrote, its kernels' launches and batches
        from clsurvey_torch.ops import _kernels
        print(f"[rank {mesh.rank}/{mesh.size}] " + json.dumps({
            "writes": io.WRITES["files"], "launches": _kernels.LAUNCHES,
            "batches": {k: sorted(v) for k, v in _kernels.BATCHES.items()}}),
            file=sys.stderr, flush=True)
    return manager


def build_argparser() -> argparse.ArgumentParser:
    """CLI flags (ref:src/framework/main.py:17-74)."""
    p = argparse.ArgumentParser("clsurvey_torch")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("model_name", nargs="?",
                   default="small_VGG9_cl_128_128")
    p.add_argument("--method_name", default="finetuning")
    p.add_argument("--ds_name", default="tiny")
    p.add_argument("--num_epochs", type=int, default=70)
    p.add_argument("--batch_size", type=int, default=200)
    p.add_argument("--lr_grid", default="1e-2,5e-3,1e-3,5e-4,1e-4")
    p.add_argument("--boot_lr_grid", default=None)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--drop_margin", type=float, default=0.2)
    p.add_argument("--decaying_factor", type=float, default=0.5)
    p.add_argument("--max_attempts_per_task", type=int, default=10)
    p.add_argument("--finetune_iterations", type=int, default=1)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--starting_task_count", type=int, default=1)
    p.add_argument("--max_task_count", type=int, default=None)
    p.add_argument("--saving_freq", type=int, default=5)
    p.add_argument("--gridsearch_name", default="demo")
    p.add_argument("--exp_name", default=None)
    p.add_argument("--runmode", default="default")
    p.add_argument("--test", action="store_true")
    p.add_argument("--hyperparams", default=None)
    p.add_argument("--static_hyperparams", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--cleanup_exp", action="store_true")
    p.add_argument("--test_set", default="test",
                   choices=("test", "val", "train"),
                   help="evaluated split (ref:src/framework/main.py:74); "
                        "non-test results land in <exp>_<subset> dirs")
    p.add_argument("--test_starting_task_count", type=int, default=1,
                   help="first ref task to evaluate "
                        "(ref:src/framework/main.py:72)")
    p.add_argument("--test_max_task_count", type=int, default=None,
                   help="last ref task to evaluate "
                        "(ref:src/framework/main.py:71)")
    p.add_argument("--test_overwrite_mode", action="store_true",
                   help="recompute eval artifacts / IMM merge caches even "
                        "if present (ref:src/framework/main.py:37)")
    p.add_argument("--grid_storage_policy", default="only_keep_best",
                   choices=("all", "only_keep_best", "keep_none"),
                   help="Phase-1 LR-grid model retention "
                        "(ref:src/framework/lr_grid_train.py StoragePolicy)")
    p.add_argument("--no_augment", dest="augment", action="store_false",
                   help="Disable train-time horizontal flip (the "
                        "reference's framework path trains un-flipped: "
                        "rnd_transform=False, ref:src/framework/main.py:"
                        "163,197; use for head-to-head parity runs)")
    p.add_argument("--save_models_FT_heuristic", action="store_true",
                   help="Keep every chkpt model of the framework's FT "
                        "phase (ref:src/framework/main.py:39-40, "
                        "framework_train.py:229-231)")
    return p


def cli(argv=None):
    ns = build_argparser().parse_args(argv)
    kwargs = vars(ns)
    for grid_key in ("lr_grid", "boot_lr_grid"):
        if isinstance(kwargs.get(grid_key), str):
            kwargs[grid_key] = tuple(
                float(x) for x in kwargs[grid_key].split(","))
    return main(RunArgs(**kwargs))


if __name__ == "__main__":
    cli()
    mesh_lib.shutdown()
