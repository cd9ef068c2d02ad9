"""Drive clsurvey_torch on one NVIDIA GPU and hold its kernels to account.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero without the final ``ok`` line:

1. card: name and power limit, then build every kernel (one nvcc per
   source, all started together) and print the ptxas report;
2. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (f32 and bf16, tie-heavy pool inputs, one odd
   pool shape), then its device time (CUPTI, via torch.profiler) and its
   CUDA-event time over back-to-back calls, beside the plain version's,
   the library call's where one exists, and the bound;
3. cli: the timing_mode finetuning CLI on small_VGG9_cl_128_128, with the
   launch counters zeroed just before and read just after; every kernel
   must have launched, every task must have left a best model that
   ``clsurvey_torch.utils.io.load`` reads back;
4. protocol: bench.py's throughput point (20k random uint8 rows, batch
   200) through the port's Engine in bf16 and float32, each with a short
   profiler breakdown.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# main-path inputs of each 2x2 pool of small_VGG9 at 64 px, batch 200
POOL_SHAPES = ((200, 64, 64, 64), (200, 32, 32, 64), (200, 16, 16, 64),
               (200, 8, 8, 128))
ODD_POOL_SHAPE = (6, 9, 7, 64)
PREPROCESS_SHAPE = (200, 64, 64, 3)


def log(*msg) -> None:
    print(*msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _device_kernel_us(prof) -> float:
    """Total device time (us) of the kernels a profiler saw."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", "")))


def time_ms(fn, iters: int = 50, warmup: int = 5) -> tuple[float, float]:
    """(device_ms, event_ms) per call of ``fn``. device_ms is the summed
    device time of the kernels ``fn`` launches (CUPTI, through
    torch.profiler); event_ms is CUDA-event time over ``iters``
    back-to-back calls, which for a short kernel is bounded by the host's
    time per call rather than by the kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device_ms = _device_kernel_us(prof) / 1e3 / iters
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return device_ms, event_ms


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def phase_card(card: str) -> None:
    from clsurvey_torch.ops import _kernels

    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0),
        "count", torch.cuda.device_count())
    t0 = time.perf_counter()
    logs = _kernels.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(sorted(logs)) or 'cached'})")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "ptxas" in line:
                log(f"  [{name}] {line.strip()}")


def _ulp_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Every element within one float32 ulp of ``want``."""
    ulp = (torch.nextafter(want, torch.full_like(want, float("inf")))
           - want).abs()
    return bool(((got - want).abs() <= ulp).all())


def _timings(row: dict, kernel, plain, library) -> dict:
    """Fill ``row`` with device and event times of the three versions."""
    for name, fn in (("kernel", kernel), ("plain", plain),
                     ("library", library)):
        if fn is None:
            row[f"{name}_ms"] = row[f"{name}_event_ms"] = None
        else:
            row[f"{name}_ms"], row[f"{name}_event_ms"] = time_ms(fn)
    return row


def check_preprocess(gen) -> dict:
    from clsurvey_torch.ops import preprocess as pp

    x = torch.randint(0, 256, PREPROCESS_SHAPE, dtype=torch.uint8,
                      device="cuda", generator=gen)
    flip = torch.randint(0, 2, (PREPROCESS_SHAPE[0],), dtype=torch.uint8,
                         device="cuda", generator=gen)
    rows, err = [], 0.0
    for dtype in (torch.float32, torch.bfloat16):
        got = pp.preprocess(x, MEAN, STD, flip, dtype)
        want = pp.normalize_flip_plain(x, MEAN, STD, flip, dtype)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs().max().item()
        err = max(err, diff)
        # bf16: both round the same float32 value once -> bit-equal.
        # float32: torch's mul and sub are separate kernels and the kernel
        # uses __fmul_rn/__fsub_rn, so no FMA on either side; allow 1 ulp
        # all the same, the bound the JAX package's XLA CPU path needs.
        ok = torch.equal(got, want) if dtype == torch.bfloat16 \
            else _ulp_ok(got, want)
        if not ok:
            raise AssertionError(f"kernel A disagrees with its plain "
                                 f"version in {dtype}: max |diff| {diff}")
        nbytes = x.numel() + flip.numel() + got.numel() * got.element_size()
        rows.append(_timings(
            {"shape": list(PREPROCESS_SHAPE), "dtype": str(dtype),
             "exact": bool(torch.equal(got, want)), "max_abs_err": diff,
             "bound_ms": bound_ms(nbytes)},
            kernel=lambda d=dtype: pp.preprocess(x, MEAN, STD, flip, d),
            plain=lambda d=dtype: pp.normalize_flip_plain(x, MEAN, STD,
                                                          flip, d),
            library=None))
    return {"err": err, "rows": rows}


def check_pool(gen) -> tuple[dict, dict]:
    import torch.nn.functional as F

    from clsurvey_torch.ops import pool

    fwd_rows, bwd_rows, err = [], [], 0.0
    for shape in POOL_SHAPES + (ODD_POOL_SHAPE,):
        for dtype in (torch.float32, torch.bfloat16):
            # small integers: frequent in-window ties
            x = torch.randint(0, 3, shape, device="cuda",
                              generator=gen).to(dtype)
            val, code = pool.pool_fwd(x)
            pval, pcode = pool.pool_fwd_plain(x)
            g = torch.randn(val.shape, device="cuda", generator=gen,
                            dtype=torch.float32).to(dtype)
            dx = pool.pool_bwd(g, code, x.shape)
            pdx = pool.pool_bwd_plain(g, pcode, x.shape)
            torch.cuda.synchronize()
            if not (torch.equal(val, pval) and torch.equal(code, pcode)):
                raise AssertionError(f"kernel B1 disagrees at {shape} "
                                     f"{dtype}")
            if not torch.equal(dx, pdx):
                raise AssertionError(f"kernel B2 disagrees at {shape} "
                                     f"{dtype}")
            if shape == ODD_POOL_SHAPE:
                continue
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy
            lib_out, lib_idx = F.max_pool2d(x_nchw, 2, 2,
                                            return_indices=True)
            g_nchw = g.permute(0, 3, 1, 2)
            esz = x.element_size()
            fwd_bytes = x.numel() * esz + val.numel() * (esz + 1)
            bwd_bytes = g.numel() * (esz + 1) + x.numel() * esz
            fwd_rows.append(_timings(
                {"shape": list(shape), "dtype": str(dtype),
                 "bound_ms": bound_ms(fwd_bytes)},
                kernel=lambda: pool.pool_fwd(x),
                plain=lambda: pool.pool_fwd_plain(x),
                library=lambda: F.max_pool2d(x_nchw, 2, 2)))
            bwd_rows.append(_timings(
                {"shape": list(shape), "dtype": str(dtype),
                 "bound_ms": bound_ms(bwd_bytes)},
                kernel=lambda: pool.pool_bwd(g, code, x.shape),
                plain=lambda: pool.pool_bwd_plain(g, code, x.shape),
                library=lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                    g_nchw, x_nchw, [2, 2], [2, 2], [0, 0], [1, 1], False,
                    lib_idx)))
            del lib_out
    return {"err": err, "rows": fwd_rows}, {"err": err, "rows": bwd_rows}


def _kernel_row(name, source, replaces, check, launches, dtype) -> dict:
    """One record per kernel: its device time per training step at the
    main path's shapes in ``dtype`` (the sum over the shapes it runs at
    once per step), with every (shape, dtype) measured kept under
    ``shapes``."""
    rows = [r for r in check["rows"] if r["dtype"] == str(dtype)]
    total = lambda key: (None if any(r[key] is None for r in rows)
                         else sum(r[key] for r in rows))
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "tpu_counterpart": replaces,
        "launches": launches, "max_abs_err": check["err"],
        "ms": total("kernel_ms"), "kernel_ms": total("kernel_ms"),
        "event_ms": total("kernel_event_ms"),
        "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": "bytes", "library_ms": total("library_ms"),
        "dtype": str(dtype), "shape": [r["shape"] for r in rows],
        "shapes": check["rows"],
    }


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {"normalize_flip": check_preprocess(gen)}
    checks["pool_fwd"], checks["pool_bwd"] = check_pool(gen)
    log("kernels agree with their plain versions "
        "(preprocess f32 <= 1 ulp, bf16 exact; pool fwd/bwd exact)")
    return checks


def phase_cli(root: str) -> dict:
    from clsurvey_torch.framework import main as cli_main
    from clsurvey_torch.ops import _kernels
    from clsurvey_torch.utils import io

    argv = ["small_VGG9_cl_128_128", "--method_name", "finetuning",
            "--ds_name", "synthetic_4t_20c_64px_400n",
            "--runmode", "timing_mode", "--device", "cuda"]
    log("cli: python -m clsurvey_torch.framework.main", " ".join(argv))
    os.environ["CLSURVEY_ROOT"] = root
    from clsurvey_torch.utils import config
    config.set_config(None)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    manager = cli_main.cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    log(f"cli wall {wall:.2f} s; kernel launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    for task, secs in manager.extras["task_seconds"].items():
        path = manager.best_model_path(task, create=False)
        model = io.load(path)
        log(f"task {task}: {secs:.2f} s, best val_acc "
            f"{model['meta']['val_acc']:.4f} (epoch "
            f"{model['meta']['epoch']}) <- {path}")
    if len(manager.extras["task_seconds"]) != 4:
        raise AssertionError("timing_mode must train 4 tasks")
    check_cli_model(manager, model)
    return launches


def check_cli_model(manager, model: dict) -> None:
    """The last task's best model: finite weights, and logits on 64 of its
    val images on the card (kernels A, B1) equal to the CPU's (the plain
    versions, another conv library), within float32 summation-order
    tolerance."""
    from clsurvey_torch.engine.train import state_from_model
    from clsurvey_torch.models import heads
    from clsurvey_torch.ops import preprocess as pp

    for layers in model["params"].values():
        for leaves in layers.values():
            for leaf in leaves.values():
                if not torch.isfinite(torch.as_tensor(leaf)).all():
                    raise AssertionError("non-finite weights in the best "
                                         "model")
    seq = manager.dataset
    images = torch.from_numpy(
        seq.get_task_dataset(seq.task_count).val.images[:64])
    task = seq.task_count - 1
    logits = {}
    for dev in ("cpu", "cuda"):
        backbone = manager.model_spec.make_backbone().to(dev)
        state = state_from_model(model, None, dev)
        with torch.no_grad():
            x = pp.preprocess(images.to(dev), seq.mean, seq.std)
            feats = torch.func.functional_call(
                backbone, state.trainable["params"], (x,))
            bank = {**state.trainable["heads"],
                    "class_counts": model["heads"]["class_counts"]}
            logits[dev] = heads.forward(bank, feats, task).cpu()
    diff = (logits["cuda"] - logits["cpu"]).abs().max().item()
    log(f"task {seq.task_count} best model: logits on 64 val images, "
        f"card vs CPU max |diff| {diff:.3g}")
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4,
                               atol=1e-4)


def phase_protocol(card: str) -> None:
    """bench.py's workload through the port's Engine: small_VGG9 at 64 px,
    20k random uint8 rows, batch 200, lr 5e-3, flips on; best of three
    timed epochs after one warm-up epoch, in bf16 (bench.py's point) and
    float32 (the CLI's), then 10 profiled steps of each."""
    from torch.profiler import ProfilerActivity, profile

    from clsurvey_torch.engine.train import (Engine, make_context,
                                             state_from_model)
    from clsurvey_torch.methods.base import UpdateRule
    from clsurvey_torch.models.registry import ModelSpec, init_model_state

    bs, n, lr = 200, 20000, 5e-3
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randint(0, 255, (n, 64, 64, 3), dtype=torch.uint8,
                           device="cuda", generator=gen)
    labels = torch.randint(0, 20, (n,), device="cuda", generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        spec = ModelSpec(name="small_VGG9_cl_128_128", arch="small_VGG9",
                         input_size=(64, 64), classifier_dims=(128, 128),
                         compute_dtype=dtype)
        model = init_model_state(spec, seed=0, max_tasks=10,
                                 classes_per_task=20)
        rule = UpdateRule()
        ctx = make_context(spec, task=0, n_tasks=1, class_counts=[20] * 10,
                           mean=MEAN, std=STD, update_rule=rule,
                           augment=True, device="cuda")
        engine = Engine(ctx)
        state = state_from_model(model, None, ctx.device)
        state.mstate = rule.init_state(state.trainable, {}, ctx)
        torch.cuda.reset_peak_memory_stats()
        per_epoch = []
        for epoch in range(4):  # epoch 0 warms up cuDNN's algorithm choice
            perm = torch.randperm(n, device="cuda", generator=gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = engine.train_epoch(state, images, labels, perm,
                                                gen, lr, bs)
            loss = float(metrics["loss"])
            per_epoch.append(time.perf_counter() - t0)
            if loss != loss or abs(loss) == float("inf"):
                raise AssertionError(f"protocol epoch {epoch}: loss {loss}")
        steps = n // bs
        best = min(per_epoch[1:])
        log(json.dumps({
            "protocol": "small_VGG9_cl_128_128 64px bs200 train",
            "dtype": str(dtype), "img_per_s": steps * bs / best,
            "ms_per_step": best / steps * 1e3, "epoch_s": per_epoch,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "card": card}))

        perm = torch.randperm(n, device="cuda", generator=gen)[: 10 * bs]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = engine.train_epoch(state, images, labels, perm,
                                                gen, lr, bs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if "CUDA" in str(getattr(e, "device_type", ""))]
        device_ms = _device_kernel_us(prof) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        log(json.dumps({
            "profile": f"10 steps {dtype}", "wall_ms": wall_ms,
            "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "kernel_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:80],
                     "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top]}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import clsurvey_torch  # noqa: F401  (fail before printing anything)

    card = card_line()
    phase_card(card)
    checks = phase_kernels()
    with tempfile.TemporaryDirectory() as root:
        launches = phase_cli(root)
    phase_protocol(card)
    sources = {"normalize_flip": "clsurvey_torch/csrc/preprocess.cu",
               "pool_fwd": "clsurvey_torch/csrc/pool.cu",
               "pool_bwd": "clsurvey_torch/csrc/pool.cu"}
    replaces = {"normalize_flip": "clsurvey_tpu/ops/preprocess.py:61",
                "pool_fwd": "clsurvey_tpu/ops/pool_pallas.py:82",
                "pool_bwd": "clsurvey_tpu/ops/pool_pallas.py:113"}
    log(json.dumps({"kernels": [
        _kernel_row(name, sources[name], replaces[name], checks[name],
                    launches[name], torch.float32)
        for name in sources]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
