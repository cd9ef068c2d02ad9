"""One run of one cell: set-up, the measured window, the traced readings,
and the check against the plain reference.

Set-up builds the program's CUDA kernels where the checkout holds none
yet (reported apart: only the first run in a checkout builds), then the
cell the way the program's CLI would (``clsurvey_torch.utils.device.
resolve``: float32 with TF32 off, cuDNN's algorithm search on), with the
inputs and weights from the seed, and the method's rule. Its one train
step object (engine, model, momentum and method state) is driven from the
seed through the window's own calls: the first epoch, whose first steps
the probe reads for the check, and the eval after it, whose logits the
probe reads; together they warm up every shape the window uses. The
window then repeats what ``engine/train.py:train_task`` does each epoch,
less its checkpoint writes and the controller's decisions: a train epoch
over the epoch's permutation (``Engine.train_epoch``, or
``train_epoch_chunked`` through a ``ChunkFeed`` for a split above the
device data budget), the epoch's loss and accuracy read back, and
``Engine.evaluate`` over the val split, back to back in one closed loop,
until ``seconds`` have passed at an epoch's end. The rate is all the train
images over all the window's time. Once the window has closed and the
peak memory is read, the program's state is freed and the reference
follows the first steps, and computes the eval from the weights it ran
on."""

from __future__ import annotations

import gc
import importlib
import math
import os
import sys
import time
from dataclasses import dataclass, field

import torch

from clbench import check, probe as probe_lib, seeds, traffic, weights
from clbench import trace as trace_lib
from clbench.reference import net
from clbench.reference import train as ref

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "clsurvey_tpu")


def banned_modules() -> list[str]:
    """Modules loaded whose top-level name is one the benchmark's process
    may not hold, compared whole (``clsurvey_torch`` is not
    ``clsurvey_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


@dataclass
class Record:
    """What a run measured, for the per-layer readers."""

    cfg: dict
    workload: dict
    method: object
    device: torch.device
    batch: int = 0
    window_s: float = 0.0
    epochs: int = 0
    train_steps: int = 0
    train_images: int = 0
    val_images: int = 0
    val_batches: list = field(default_factory=list)
    eval_s: float = 0.0
    epoch_s: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)
    chunk_loads: int = 0
    chunk_bytes: int = 0
    trace: trace_lib.Trace | None = None


def _trainable(ctx, w: dict) -> dict:
    """The program's trainable tree from the drawn weights, laid out as the
    program's loader lays them (conv weights channels_last)."""
    names = dict(ctx.backbone.named_parameters())
    drawn = {k: v for k, v in w.items() if not k.startswith("heads.")}
    if {k: tuple(v.shape) for k, v in names.items()} != \
            {k: tuple(v.shape) for k, v in drawn.items()}:
        raise ValueError("the configuration's layers do not match the "
                         "program's model: "
                         f"{sorted(names)} against {sorted(drawn)}")

    def leaf(t):
        if t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return t.clone().requires_grad_()

    return {"params": {k: leaf(drawn[k]) for k in names},
            "heads": {"kernel": leaf(w["heads.kernel"]),
                      "bias": leaf(w["heads.bias"])}}


class Cell:
    """The program's side of a cell: the engine and its state, the inputs,
    and the epoch and eval calls the window makes."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device: str):
        from clsurvey_torch.engine import train as eng
        from clsurvey_torch.models.registry import parse_model_name
        from clsurvey_torch.utils import device as device_lib

        self.cfg, self.wl, self.seed = cfg, wl, seed
        self.dev = device_lib.resolve(device)
        dtype = getattr(torch, wl["dtype"])
        if wl["dtype"] != cfg["dtype"]:
            raise ValueError(f"traffic in {wl['dtype']} on a {cfg['dtype']} "
                             "configuration")
        self.method = importlib.import_module(
            f"clbench.methods.{wl['method']}")
        px = int(cfg["input_px"])
        spec = parse_model_name("", cfg["program_model"], (px, px),
                                compute_dtype=dtype)
        self.train = traffic.make_split(wl, cfg, seed, "train", self.dev)
        self.val = traffic.make_split(wl, cfg, seed, "val", self.dev)
        w = weights.make(cfg, seed, seeds.WEIGHTS, self.dev)
        teacher = (weights.make(cfg, seed, seeds.TEACHER, self.dev)
                   if self.method.TEACHER else None)
        self.rule = self.method.program_rule()
        ctx = eng.make_context(
            spec, task=int(wl["task"]) - 1, n_tasks=int(wl["task"]),
            class_counts=[cfg["classes_per_task"]] * cfg["max_tasks"],
            mean=cfg["mean"], std=cfg["std"], update_rule=self.rule,
            device=self.dev, augment=bool(wl.get("augment", True)))
        drops = list(ctx.backbone.drop_dims) if spec.uses_dropout else []
        if drops != net.dropout_widths(cfg):
            raise ValueError("the configuration's dropout layers do not "
                             "match the program's model")
        trainable = _trainable(ctx, w)
        del w
        self.state = eng.TrainState(trainable, {},
                                    eng.tree_zeros_like(trainable), None)
        self.state.mstate = self.method.program_state(
            self.rule, ctx, wl.get("hyper", {}), teacher)
        del teacher
        self.engine = eng.Engine(ctx)
        self.batch = int(wl["batch_size"])
        self.lr = float(wl["lr"])
        budget = eng.data_budget_bytes()
        self.streamed = self.train.nbytes > budget
        if self.streamed != (wl["residency"] == "stream"):
            raise ValueError(
                f"the traffic says {wl['residency']}, but the program "
                f"{'streams' if self.streamed else 'keeps resident'} "
                f"{self.train.nbytes} bytes at a {budget}-byte budget")
        if self.val.nbytes > budget:
            raise ValueError("a val split above the data budget: the "
                             "harness keeps val resident")
        n = self.train.rows
        self.feed = None
        if self.streamed:
            self.chunk_rows = eng.stream_chunk_rows(self.train.nbytes // n)
            self.batch, rows = eng.chunk_plan(n, self.batch,
                                              self.chunk_rows)
            self.feed = eng.ChunkFeed(self.train.images.shape[1:], rows,
                                      self.dev)
            self.chunks = -(-n // rows)
            self.steps = self.chunks * rows // self.batch
        else:
            self.batch = min(self.batch, n)
            self.steps = n // self.batch

    def epoch(self, e: int):
        perm = seeds.permutation(self.seed, e, self.train.rows)
        gen = seeds.draw_generator(self.seed, e, self.dev)
        if self.streamed:
            return self.engine.train_epoch_chunked(
                self.state, self.train.images, self.train.labels,
                perm.numpy(), gen, self.lr, self.batch, self.chunk_rows,
                self.feed)
        return self.engine.train_epoch(self.state, self.train.images,
                                       self.train.labels, perm, gen,
                                       self.lr, self.batch)

    def evaluate(self):
        return self.engine.evaluate(
            self.state.trainable, self.state.batch_stats, self.val.images,
            self.val.labels, int(self.wl["batch_size"]))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict:
    from clsurvey_torch.ops import _kernels

    return dict(_kernels.LAUNCHES)


def first_steps(cell: Cell) -> dict:
    """The program's readings for the check, taken in set-up through the
    window's own calls: the first epoch, whose first steps the probe
    reads, then the eval after it (its hits and rows by class, and the
    task logits), with the weights that eval ran on, on the host. Both
    warm up the shapes the window uses."""
    probe = probe_lib.StepProbe(cell.rule, cell.state)
    cell.state, metrics = cell.epoch(0)
    float(metrics["loss"])
    if not probe.done:
        raise RuntimeError(f"the first epoch ran {probe.calls} steps; the "
                           f"check reads {probe_lib.STEPS + 1}")
    logits = probe_lib.EvalProbe(cell.engine.ctx)
    try:
        _, hits, rows = cell.evaluate()
    finally:
        logits = logits.release()
    return {"losses": probe.losses, "first_grad": probe.first_grad,
            "params": probe.params,
            "eval": {"hits": hits, "rows": rows, "logits": logits},
            "eval_params": probe_lib.host(cell.state.trainable)}


def reference_inputs(cell: Cell, prog: dict) -> dict:
    """What the reference reads of the inputs: the rows and labels of the
    first steps (on the host), the val split, the seed, and the weights the
    program's eval ran on (taken out of ``prog``)."""
    problem = ref.Problem(cell.cfg, cell.wl, cell.dev)
    rows_u8, labels = traffic.rows(
        cell.train, ref.step_rows(problem, cell.seed, probe_lib.STEPS))
    return {"rows": rows_u8, "labels": labels, "val": cell.val,
            "seed": cell.seed, "eval_params": prog.pop("eval_params")}


def reference(cfg: dict, wl: dict, dev, inputs: dict,
              dtype=torch.float64, tf32: bool = False,
              fault: str | None = None) -> tuple[dict, dict]:
    """(the plain reference's readings, the starting weights), in
    ``dtype``, with the weights drawn again from the seed."""
    seed = inputs["seed"]
    problem = ref.Problem(cfg, wl, dev)
    if importlib.import_module(f"clbench.methods.{wl['method']}").TEACHER:
        problem.teacher = weights.make(cfg, seed, seeds.TEACHER, dev)
    p0 = weights.make(cfg, seed, seeds.WEIGHTS, dev)
    with ref.precision(tf32=tf32):
        losses, grad, params = ref.follow(
            problem, p0, inputs["rows"], inputs["labels"], seed, dtype,
            probe_lib.STEPS, fault=fault)
        val = inputs["val"]
        counts = ref.eval_counts(problem, inputs["eval_params"], val.images,
                                 val.labels, dtype)
    return ({"losses": losses, "first_grad": grad, "params": params,
             "eval": counts}, p0)


def _libraries() -> set[str]:
    """The libraries in the program's build folder inside the checkout."""
    from clsurvey_torch.ops import _kernels

    if not os.path.isdir(_kernels.BUILD_DIR):
        return set()
    return {f for f in os.listdir(_kernels.BUILD_DIR) if f.endswith(".so")}


def build_kernels(dev) -> float:
    """The seconds it took to build every CUDA library of the program not
    yet in the checkout's build folder, all at once: only the first run in
    a checkout builds."""
    if dev.type != "cuda":
        return 0.0
    from clsurvey_torch.ops import _kernels

    t0 = time.perf_counter()
    return time.perf_counter() - t0 if _kernels.build() else 0.0


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(spec, name: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t_start: float | None = None,
        log=print) -> tuple[dict, list[str]]:
    """One run of cell ``name``. Returns (the result's fields, the check's
    lines for standard error)."""
    t_start = time.perf_counter() if t_start is None else t_start
    wl = spec.workload(name)
    cfg = spec.config(wl["config"])
    libraries = _libraries()
    build_s = build_kernels(torch.device(device))
    cell = Cell(cfg, wl, seed, device)
    dev = cell.dev
    rec = Record(cfg, wl, cell.method, dev)

    prog = first_steps(cell)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    built = sorted(_libraries() - libraries)
    log(f"clbench: {name} seed {seed}: set-up {setup_s:.3f} s")
    if built:
        log(f"clbench: this run built {', '.join(built)} in its set-up "
            f"(the first run in a checkout), the CUDA ones in "
            f"{build_s:.3f} s")

    # the window
    failed = 0
    before = _launches()
    prof = trace_lib.start() if traced else None
    with trace_lib.span("window", traced):
        _sync(dev)
        t0 = time.perf_counter()
        e = 1
        while True:
            t_epoch = time.perf_counter()
            with trace_lib.span("train_epoch", traced):
                cell.state, metrics = cell.epoch(e)
            with trace_lib.span("epoch_boundary", traced):
                loss = float(metrics["loss"])
                float(metrics["acc"])
            with trace_lib.span("eval", traced):
                te = time.perf_counter()
                cell.evaluate()
                rec.eval_s += time.perf_counter() - te
            if not math.isfinite(loss):
                failed += cell.steps
            rec.epochs += 1
            rec.epoch_s.append(time.perf_counter() - t_epoch)
            e += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(dev)
        rec.window_s = time.perf_counter() - t0
    if prof is not None:
        rec.trace = trace_lib.read(prof)
    after = _launches()
    rec.launches = {k: after[k] - before.get(k, 0) for k in after}
    rec.batch = cell.batch
    rec.train_steps = rec.epochs * cell.steps
    rec.train_images = rec.train_steps * cell.batch
    n_val = cell.val.rows
    rec.val_images = rec.epochs * n_val
    b = int(wl["batch_size"])
    rec.val_batches = [min(b, n_val - lo) for lo in range(0, n_val, b)]
    if cell.streamed:
        rec.chunk_loads = rec.epochs * cell.chunks
        rec.chunk_bytes = cell.feed.chunk_rows * int(
            math.prod(cell.train.images.shape[1:]))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)

    # free the program's state, then the reference
    inputs = reference_inputs(cell, prog)
    cell_steps = cell.steps
    del cell, metrics
    _free(dev)
    t_ref = time.perf_counter()
    ref_readings, p0 = reference(cfg, wl, dev, inputs)
    values = check.numbers(prog, ref_readings, p0)
    log(f"clbench: window {rec.window_s:.3f} s, {rec.epochs} epochs of "
        f"{cell_steps} steps, each epoch's seconds (train, boundary, eval) "
        + " ".join(f"{x:.4f}" for x in rec.epoch_s))
    log(f"clbench: reference {time.perf_counter() - t_ref:.3f} s")
    ok, table, reported = check.verdict(values, wl["limits"])
    correct = ok and failed == 0

    result = {"correct": correct, "attempted": rec.train_steps,
              "failed": failed}
    units = {m["name"]: m["unit"] for m in spec.bench["end_to_end"]
             + spec.bench["per_layer"]}
    if traced:
        metrics_out = {}
        for m in spec.per_layer(name):
            value = spec.reader(m["name"]).read(rec)
            if value is not None:
                metrics_out[m["name"]] = {"value": value,
                                          "unit": m["unit"]}
    else:
        e2e = {"train_img_per_s": rec.train_images / rec.window_s,
               "setup_s": setup_s}
        metrics_out = {m["name"]: {"value": e2e[m["name"]],
                                   "unit": units[m["name"]]}
                       for m in spec.end_to_end(name)}
    result["metrics"] = metrics_out
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": peak}
    if rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s()
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    result["setup_build"] = {"built": built, "cuda_build_s": build_s}
    result["checks"] = table
    lines = [f"reported {k} {v!r} (not compared)"
             for k, v in reported.items()]
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}"
              for k, v in table.items()]
    return result, lines
