"""Drive clsurvey_torch on one NVIDIA GPU and hold its kernels to account.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero without the final ``ok`` line
(``--phases a,b`` runs a subset, always after ``card``, and prints no
``ok`` line):

1. card: name and power limit, then build every kernel (one nvcc per
   source, all started together) and print the ptxas report;
2. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (f32 and bf16, tie-heavy pool inputs, one odd
   pool shape; kernel A's vector and scalar kernels, an unaligned pointer;
   the pool pair's vec route and its scalar route, at C not a multiple of
   8 and an input one element off, each launch on the route its C and
   alignment call for) and at the shapes MAS's importance pass gives them
   (chunks of 16, the pool pair also under ``torch.func.vmap(grad)``),
   then its device time (CUPTI, via torch.profiler) and its CUDA-event
   time over back-to-back calls (warm: the input stays in the 50 MB L2
   where it fits), and for the pool pair also a cold-L2 device time (a
   128 MiB buffer overwritten before each call, its kernel left out by
   name), beside the plain version's, the library call's where one
   exists, the bound, and an empty kernel's time;
3. cli: the timing_mode finetuning CLI on small_VGG9_cl_128_128, with the
   launch counters zeroed just before and read just after; every kernel
   must have launched, every pool launch on the vec route, and every task
   must have left a best model that ``clsurvey_torch.utils.io.load``
   reads back;
4. framework: after the SI first-task base-model dump (made once, for
   this phase and the next), SI, EWC and MAS through Phase 1, Phase 2 and
   ``--test`` under timing_mode, counters zeroed before each method;
   checks the decay state, SUCCESS tokens, best models with their
   importance trees, the result dicts, and one eval entry, EWC's Fisher
   and MAS's omega on the card against the CPU;
5. methods: from that base model, LWF and EBLL (collapsed autoencoder
   grid) through both phases and ``--test``, mean_IMM and mode_IMM through
   Phase 1 and the eval-time merges, and finetuning on
   small_VGG9_cl_128_128_BN_DROP, counters zeroed before each; checks the
   encoders in EBLL's models, the merged models and precision caches, the
   batch-norm statistics, the result dicts, and one distillation value and
   one mode-IMM Fisher on the card against the CPU;
6. rehearsal: on synthetic_3t_20c_64px_160n with its own SI base model,
   GEM and ICARL (1024 memories a task), the two replay baselines and
   PackNet through the timing_mode CLI with ``--test`` and one attempt a
   task, counters zeroed before each; checks the memories in the best
   models, iCaRL's exemplar store (153, 76, 51 a class) and its targets,
   PackNet's masks against a re-pruning of its Phase-1 winner and its
   pruned weights at exactly 0,
   prints GEM's share of projected steps, the batch sizes the kernels saw
   and each run's peak device memory, and holds GEM's projected gradient
   at task 3 (the run's model, one pass of 1024 rows a past task, and
   small_VGG9_cl_128_128_BN_DROP from random weights, chunks of 128 rows),
   one iCaRL NCM entry and one PackNet masked eval on the card against the
   CPU;
7. masks: HAT (the timing script's row: smax 800, c 2.5) and PathNet (M
   20, N 3, ``--static_hyperparams "20;6"``: generations cut from 35 to
   6, of one epoch a candidate) from scratch through the timing_mode CLI
   with ``--test``, two tasks and up to two attempts a task, counters zeroed before each (HAT must
   launch A, B1 and B2, PathNet A and no pool kernel); checks HAT's
   embeddings (within +-6), that the weights ``mask_back`` blocks at task
   2 and task 1's embedding row are bit-unchanged, prints the capacity
   report, and holds one eval entry on the card against the CPU and one
   task-2 step's processed gradient (float32 on the card) against a
   float64 step on the CPU, with the step's launches and times; checks PathNet's two best paths, that task 1's modules are
   bit-identical in task 2's model, prints the card-vs-CPU gap of its
   eval batch layer by layer with cuDNN's autotuner on and off, holds one
   eval entry card vs CPU, and times one batch-64 step;
8. alexnet: kernel A held exact and timed (warm, cold L2, byte bound) at
   AlexNet's (200, 224, 224, 3); the port's float32 convs (AlexNet's and
   small_VGG9's, batch 200) against float64; bench.py's AlexNet point (224
   px, batch 200, 25 classes, 4,000 random rows) through the port's Engine
   in bf16 and float32 (img/s, ``mfu`` against the dense peak, device busy share,
   launches a step, top kernels, the first conv's cost, peak memory; A
   launches, no pool kernel); a RecogSeq-shaped tree of 224-px JPEGs
   prepared by the port and ``alexnet`` finetuning on ``recogseq`` through
   the timing_mode CLI (A only; one eval entry card vs CPU); a fake
   tiny-imagenet-200 prepared by the port and small_VGG9 finetuning on
   ``tiny`` for 2 tasks (A, B1, B2, the vec route); a HATAlexNet step's
   gradient (float32 on the card against float64 on the CPU on the card's
   ReLU and pool decisions, float64 against float64), a PathNetAlexNet
   eval entry and EBLL's code term on AlexNet's conv features, card vs
   CPU at 224 px on ``VARIANT_ROWS`` images;
9. streaming: splits above the device data budget. ``stream224``:
   bench.py's AlexNet point through the port's Engine on 21,000 random
   rows on the host (3,013 MiB), streamed at the default 2,048 MiB budget
   in 7,000-row chunks, then resident, in bf16 and float32 on cuDNN's
   default algorithms: a warm-up epoch, then three timed epochs a leg in
   bf16 and two in float32 (each leg's epoch seconds, img/s and ms a step
   of its best epoch, the overlap share, the streamed leg's busy share,
   one chunk's gather and H2D rates, both legs' peak memory; the two legs'
   weights equal after the first timed epoch in bf16, and in float32
   after one more, untimed epoch a leg with cuDNN's deterministic
   algorithms; the streamed peak below the resident one by the split less
   two chunks; every gather native; A, no pool kernel). ``stream-cli``:
   finetuning small_VGG9_cl_128_128 through the timing_mode CLI with
   ``--test --profile`` at a 16 MiB budget, so that train, val and test
   stream (A, B1, B2 on the vec route, the best models, the result dicts,
   a trace of the first task naming A's kernel), then EWC's Fisher and
   MAS's omega streamed against resident;
10. dp: data parallel over torch.distributed (``clsurvey_torch/parallel``).
   ``dp-bench``: ``python -m clsurvey_torch.parallel.dp_bench``, bench.py's
   point (small_VGG9_cl_128_128, 64 px, batch 200, flips, float32 without
   TF32) on 8,000 random resident rows, in one process without a group
   and in a world-1 NCCL group, interleaved epoch by epoch, then as two
   ranks sharing the card over gloo, each rank a subprocess with its own
   environment and log. One compared epoch under cuDNN's deterministic
   algorithms (world-1 group against no group within 1e-6 of each leaf's
   largest entry; dp-2 against dp-1 within ``DP_RANKS_REL_TOL`` of each
   tree's largest entry, printed beside its gap; ``assert_replicated`` on
   the ranks), and five steps of small_VGG9_cl_128_128_BN (global moments:
   the world-1 group against ``F.batch_norm`` and dp-2 against the world-1
   group, each within ``DP_BN_REL_TOL``), then four epochs on the default
   algorithms (the first a warm-up, the best of three reported): ms a
   step and img/s of both one-process legs, the port's and the device's
   launches a step, each rank's peak memory; the two ranks' time is printed as two
   ranks sharing one card, not as a throughput. A, B1 and B2 must launch
   on every leg and rank. ``dp-cli``: the timing_mode finetuning CLI on
   small_VGG9_cl_128_128_BN and ``synthetic_2t_20c_64px_100n`` (10
   steps an epoch) with ``--test`` under ``torch.distributed.run --nproc_per_node 2`` (gloo),
   then in this process: the same file names, rank 1 writing none and
   rank 0 as many as the one process, A, B1 and B2 launched on each rank,
   eval matrices and the best models' batch-norm statistics within
   ``DP_CLI_ACC_TOL`` / ``DP_CLI_STATS_REL_TOL``, per-task seconds;
11. survey: the survey's scripts (``clsurvey_torch/scripts``).
   ``run_survey_demo.main`` in this process: small_VGG9_cl_128_128 at full
   width on synthetic 64-px tasks of 10 classes (64 / 32 / 32 rows a
   class), batch 100, the SI dump, then all 16 method variants through
   the two-phase framework (``--lr_grid 5e-2,1e-2``, ``--max_attempts
   2``) and the eval matrix into one results tree, cut to
   ``SURVEY_TASKS`` tasks of 2 epochs (``SURVEY_CUTS``), the kernels'
   counters zeroed before each run; every status ``ok``, every variant
   trained every task, a 16-row table, the row store's fields, the
   summary and, where matplotlib imports, both figures (else the script
   renders the rest and says why), and a ``--postprocess_only`` render
   that keeps every row's commit and date; A launched by every variant,
   B1 and B2 by every variant but PathNet (which pools with
   ``F.max_pool2d``). Then ``run_timing_mode.main`` for
   finetuning on 2 tasks of 100 rows a class (one row a trained task, the
   card in its title) and ``hd200_family_report.build_report`` over the
   sweep's rows (printed, not held: at 2 epochs the order is noise);
12. protocol: bench.py's throughput point (20k random uint8 rows, batch
   200) through the port's Engine in bf16 and float32, each with a short
   profiler breakdown.

The framework, methods and masks phases run two tasks
(synthetic_2t_20c_64px_400n, one Phase-2 task each), the cli phase four.
The kernels phase also holds A, B1 and B2 at batch sizes 1, 67, 128 and
1024 (``REHEARSAL_BATCHES``); every other size the rehearsal and masks
phases hand them (iCaRL's 144 + 56 split, the baselines' exemplar rows,
herding and val tails, PathNet's batch of 64 and its tournament's 256-row
eval and tail, the tiny run's, the stream-cli run's eval tails, the
survey's batch of 100 and its tails) is held right after those phases,
and A at 224 px at every size of the RecogSeq and stream224 runs, so
every size the path used is held.

Each phase ends with a ``{"phase": ..., "seconds": ...}`` line. The line
before the last is the ``{"kernels": [...]}`` record (A in float32, B1 and
B2 in float32 and bfloat16; ``ms`` warm, ``cold_ms`` on a cold L2, summed
over the step's shapes, ``shape_routes`` the route of each): ``launches``
is the count of the ``cli`` run, ``launches_framework``,
``launches_methods``, ``launches_rehearsal``, ``launches_masks``,
``launches_alexnet``, ``launches_streaming``, ``launches_dp`` (per leg
and rank) and ``launches_survey`` (per variant) hold each run's own count
(in a partial run the counts are null for the phases that did not run;
A's rows at AlexNet's shape are under ``shapes``), ``held_batches`` the
batch sizes held against the plain versions; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

from clsurvey_torch.utils.device import describe
from clsurvey_torch.utils.devtime import (
    cold_ms, device_events, kernel_us, time_ms)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# main-path inputs of each 2x2 pool of small_VGG9 at 64 px, batch 200
POOL_SHAPES = ((200, 64, 64, 64), (200, 32, 32, 64), (200, 16, 16, 64),
               (200, 8, 8, 128))
ODD_POOL_SHAPE = (6, 9, 7, 64)
# the pool pair's scalar route: C not a multiple of 8 (C 12: the vec route
# in float32, the scalar one in bfloat16; C 5: scalar in both), and the
# main path's first pool input one element past an aligned pointer
SCALAR_POOL_SHAPES = ((6, 10, 12, 12), (6, 9, 7, 5))
# written over before each cold-L2 launch: above the H100's 50 MB L2
FLUSH_BYTES = 128 << 20
PREPROCESS_SHAPE = (200, 64, 64, 3)
# what MAS's importance pass gives the kernels: chunks of 16 samples, which
# the pool's vmap rule folds from (16, 1, H, W, C) into one batch of 16
MAS_CHUNK = 16
MAS_PREPROCESS_SHAPE = (MAS_CHUNK,) + PREPROCESS_SHAPE[1:]
MAS_POOL_SHAPES = tuple((MAS_CHUNK,) + s[1:] for s in POOL_SHAPES)
# a row width that is not a multiple of 8: kernel A's scalar route
SCALAR_PREPROCESS_SHAPE = (200, 64, 60, 3)
# batch sizes besides 200 that the kernels phase holds up front: one row,
# an odd size, GEM's 128-row chunks (batch-norm) and its 1024-row pass. The
# rehearsal phase records the sizes it hands the kernels (iCaRL's split
# batch, the baselines' exemplar rows, herding and val tails) and holds
# each one not held here right after it ends.
REHEARSAL_BATCHES = (1, 67, 128, 1024)


def log(*msg) -> None:
    print(*msg, flush=True)


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def phase_card(card: str) -> None:
    from clsurvey_torch.ops import _kernels
    from clsurvey_torch.utils.device import resolve

    resolve("cuda")  # the port's numerics (TF32 off) for every phase
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


def _preprocess_agrees(got, want, dtype, what) -> float:
    """bf16: both round the same float32 value once -> bit-equal. float32:
    torch's mul and sub are separate kernels and the kernel uses
    __fmul_rn/__fsub_rn, so no FMA on either side; allow 1 ulp all the
    same, the bound the JAX package's XLA CPU path needs."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().max().item()
    ok = torch.equal(got, want) if dtype == torch.bfloat16 \
        else _ulp_ok(got, want)
    if not ok:
        raise AssertionError(f"kernel A ({what}) disagrees with its plain "
                             f"version in {dtype}: max |diff| {diff}")
    return diff


def _unaligned_u8(shape, gen) -> torch.Tensor:
    """Random uint8 images whose base pointer is 1 past a 16-byte boundary:
    kernel A's C entry point routes them to its scalar kernel."""
    n = 1
    for d in shape:
        n *= d
    flat = torch.randint(0, 256, (n + 1,), dtype=torch.uint8, device="cuda",
                         generator=gen)
    x = flat[1:].view(shape)
    if x.data_ptr() % 16 == 0:
        raise AssertionError("the unaligned case is aligned")
    return x


def check_preprocess(gen) -> dict:
    """Kernel A against its plain version, with and without a flip mask,
    in both dtypes: the vector kernel at the main path's shape and at the
    shape of MAS's chunks, the scalar kernel at the main path's shape
    (through a base pointer that is not 16-byte aligned) and at a width
    that is not a multiple of 8. Timed: the vector kernel at the main
    path's shape (the rows the ``kernels`` record reports), the scalar
    kernel at width 60, and an empty kernel on one warp."""
    from clsurvey_torch.ops import _kernels, preprocess as pp

    def aligned(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device="cuda", generator=gen)

    cases = (("vec", aligned(PREPROCESS_SHAPE), True),
             ("vec, MAS chunk", aligned(MAS_PREPROCESS_SHAPE), False),
             ("scalar, same shape", _unaligned_u8(PREPROCESS_SHAPE, gen),
              False),
             ("scalar, width 60", aligned(SCALAR_PREPROCESS_SHAPE), True))
    rows, err = [], 0.0
    for what, x, timed in cases:
        flip = torch.randint(0, 2, (x.shape[0],), dtype=torch.uint8,
                             device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            for mask in (flip, None):
                got = pp.preprocess(x, MEAN, STD, mask, dtype)
                want = pp.normalize_flip_plain(x, MEAN, STD, mask, dtype)
                diff = _preprocess_agrees(got, want, dtype, what)
                err = max(err, diff)
            if not timed:
                continue
            nbytes = x.numel() + got.numel() * got.element_size()
            rows.append(_timings(
                {"shape": list(x.shape), "dtype": str(dtype), "path": what,
                 "main": what == "vec", "max_abs_err": diff,
                 "bound_ms": bound_ms(nbytes + flip.numel())},
                kernel=lambda d=dtype: pp.preprocess(x, MEAN, STD, flip, d),
                plain=(lambda d=dtype: pp.normalize_flip_plain(
                    x, MEAN, STD, flip, d)) if what == "vec" else None,
                library=None))
    empty = _kernels.lib("preprocess").clsurvey_empty_launch
    stream = torch.cuda.current_stream().cuda_stream
    floor = dict(zip(("device_ms", "event_ms"),
                     time_ms(lambda: empty(1, 32, stream))))
    for r in rows:
        log(f"kernel A [{r['path']}] {r['dtype']} {r['shape']}: "
            f"{r['kernel_ms']:.5f} ms device (bound {r['bound_ms']:.5f}, "
            f"{100 * r['bound_ms'] / r['kernel_ms']:.0f}% of it reached)")
    log("empty kernel, one warp:", json.dumps(floor))
    return {"err": err, "rows": rows, "empty_kernel": floor}


def check_pool_under_vmap(shape, dtype, gen) -> None:
    """The pool pair as MAS's importance pass reaches it: under
    ``torch.func.vmap(grad)`` over ``shape[0]`` samples of batch 1, whose
    vmap rule folds them into one launch of B1 and one of B2. Values and
    per-sample dx bit-equal to the plain versions on the folded batch."""
    from clsurvey_torch.ops import _kernels, pool

    v = shape[0]
    x = torch.randint(0, 3, shape, device="cuda", generator=gen).to(dtype)
    pval, pcode = pool.pool_fwd_plain(x)
    g = torch.randn(pval.shape, device="cuda", generator=gen,
                    dtype=torch.float32).to(dtype)
    pdx = pool.pool_bwd_plain(g, pcode, x.shape)
    per_sample = lambda t: t.view(v, 1, *t.shape[1:])
    before = dict(_kernels.LAUNCHES)
    val = torch.func.vmap(pool.pool2x2)(per_sample(x))
    # d/dx1 of sum(pool(x1) * g1) is B2's routing of g1 itself
    dx = torch.func.vmap(torch.func.grad(
        lambda x1, g1: (pool.pool2x2(x1) * g1).sum()))(
            per_sample(x), per_sample(g))
    torch.cuda.synchronize()
    launched = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
    if launched != {"normalize_flip": 0, "pool_fwd": 2, "pool_bwd": 1}:
        raise AssertionError(f"pool under vmap at {shape}: launches "
                             f"{launched}, not one per pool call")
    if not (torch.equal(val, per_sample(pval))
            and torch.equal(dx, per_sample(pdx))):
        raise AssertionError(f"the pool under vmap disagrees with its "
                             f"plain version at {shape} {dtype}")


def _at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t``'s values in a tensor whose base pointer is ``offset`` elements
    past an allocation's start (1: not 16-byte aligned)."""
    if not offset:
        return t
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return flat[offset:].view(t.shape).copy_(t)


def _routes_of(call) -> tuple:
    """Run ``call`` and return the routes it launched B1 / B2 on."""
    from clsurvey_torch.ops import _kernels

    before = dict(_kernels.ROUTES)
    out = call()
    return out, tuple(sorted(k for k in before
                             if _kernels.ROUTES[k] > before[k]))


def check_pool(gen) -> tuple[dict, dict]:
    """B1 and B2 bit-equal to their plain versions at the main path's four
    pool inputs, the odd shape, MAS's chunk shapes (also under
    ``vmap(grad)``), and on the scalar route (``SCALAR_POOL_SHAPES`` and an
    unaligned input), in both dtypes, each on the route its C and
    alignment call for. Timed at the main path's shapes (warm: back-to-back
    calls on one input; cold: the L2 overwritten before each call) and on
    the scalar route at the first of them, beside the plain versions and
    the library calls."""
    import torch.nn.functional as F

    from clsurvey_torch.ops import pool

    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flush = scratch.bitwise_not_
    cases = ([(s, 0) for s in POOL_SHAPES + (ODD_POOL_SHAPE,)
              + MAS_POOL_SHAPES + SCALAR_POOL_SHAPES]
             + [(POOL_SHAPES[0], 1)])
    fwd_rows, bwd_rows, err = [], [], 0.0
    for shape, offset in cases:
        for dtype in (torch.float32, torch.bfloat16):
            # small integers: frequent in-window ties
            x = _at_offset(torch.randint(0, 3, shape, device="cuda",
                                         generator=gen).to(dtype), offset)
            (val, code), fwd_route = _routes_of(lambda: pool.pool_fwd(x))
            pval, pcode = pool.pool_fwd_plain(x)
            g = _at_offset(torch.randn(val.shape, device="cuda",
                                       generator=gen).to(dtype), offset)
            dx, bwd_route = _routes_of(lambda: pool.pool_bwd(g, code,
                                                             x.shape))
            pdx = pool.pool_bwd_plain(g, pcode, x.shape)
            torch.cuda.synchronize()
            route = "vec" if not offset \
                and shape[3] % pool.VEC_WIDTH[dtype] == 0 else "scalar"
            if (fwd_route, bwd_route) != ((f"pool_fwd_{route}",),
                                          (f"pool_bwd_{route}",)):
                raise AssertionError(
                    f"the pool pair at {shape} {dtype} (offset {offset}) "
                    f"took routes {fwd_route} {bwd_route}, not {route}")
            if not (torch.equal(val, pval) and torch.equal(code, pcode)):
                raise AssertionError(f"kernel B1 [{route}] disagrees at "
                                     f"{shape} {dtype}")
            if not torch.equal(dx, pdx):
                raise AssertionError(f"kernel B2 [{route}] disagrees at "
                                     f"{shape} {dtype}")
            if shape in MAS_POOL_SHAPES:
                check_pool_under_vmap(shape, dtype, gen)
            main = shape in POOL_SHAPES and not offset
            if not (main or offset):
                continue  # exactness only: not timed
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy
            lib_out, lib_idx = F.max_pool2d(x_nchw, 2, 2,
                                            return_indices=True)
            g_nchw = g.permute(0, 3, 1, 2)
            esz = x.element_size()
            fwd_bytes = x.numel() * esz + val.numel() * (esz + 1)
            bwd_bytes = g.numel() * (esz + 1) + x.numel() * esz
            for rows, nbytes, kernel, plain, library in (
                    (fwd_rows, fwd_bytes, lambda: pool.pool_fwd(x),
                     lambda: pool.pool_fwd_plain(x),
                     lambda: F.max_pool2d(x_nchw, 2, 2)),
                    (bwd_rows, bwd_bytes,
                     lambda: pool.pool_bwd(g, code, x.shape),
                     lambda: pool.pool_bwd_plain(g, code, x.shape),
                     lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                         g_nchw, x_nchw, [2, 2], [2, 2], [0, 0], [1, 1],
                         False, lib_idx))):
                row = _timings(
                    {"shape": list(shape), "dtype": str(dtype),
                     "route": route, "main": main,
                     "bound_ms": bound_ms(nbytes)},
                    kernel=kernel, plain=plain if main else None,
                    library=library if main else None)
                row["cold_ms"] = cold_ms(kernel, flush)
                rows.append(row)
            del lib_out
    del scratch
    for what, rows in (("B1", fwd_rows), ("B2", bwd_rows)):
        for r in rows:
            log(f"kernel {what} [{r['route']}] {r['dtype']} {r['shape']}: "
                f"{r['kernel_ms']:.5f} ms warm, {r['cold_ms']:.5f} ms cold "
                f"(bound {r['bound_ms']:.5f}: "
                f"{100 * r['bound_ms'] / r['cold_ms']:.0f}% of it reached "
                f"cold, {100 * r['bound_ms'] / r['kernel_ms']:.0f}% warm)"
                + ("" if r["library_ms"] is None else
                   f"; library {r['library_ms']:.5f} ms warm"))
    return {"err": err, "rows": fwd_rows}, {"err": err, "rows": bwd_rows}


def _kernel_row(name, source, replaces, check, launches, dtype) -> dict:
    """One record per kernel: its device time per training step at the
    main path's shapes in ``dtype`` (the sum over the shapes it runs at
    once per step), with every (shape, dtype) measured kept under
    ``shapes``."""
    rows = [r for r in check["rows"]
            if r["dtype"] == str(dtype) and r.get("main", True)]
    total = lambda key: (None if any(r.get(key) is None for r in rows)
                         else sum(r[key] for r in rows))
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "tpu_counterpart": replaces,
        "launches": launches, "max_abs_err": check["err"],
        "ms": total("kernel_ms"), "kernel_ms": total("kernel_ms"),
        "cold_ms": total("cold_ms"), "event_ms": total("kernel_event_ms"),
        "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": "bytes", "library_ms": total("library_ms"),
        "dtype": str(dtype), "shape": [r["shape"] for r in rows],
        "shape_routes": [r.get("route", r.get("path")) for r in rows],
        "shapes": [r for r in check["rows"] if r["dtype"] == str(dtype)],
    }


def check_batches(gen, sizes) -> list:
    """Kernel A (vector kernel, with and without a flip mask) and the pool
    pair B1/B2 at the four pool inputs of small_VGG9 at 64 px, each at
    every batch size in ``sizes``, float32 (the rehearsal path's dtype),
    against their plain versions: A within 1 ulp, B1 and B2 exact.
    Returns the sizes held."""
    from clsurvey_torch.ops import pool, preprocess as pp

    for b in sorted(sizes):
        x = torch.randint(0, 256, (b,) + PREPROCESS_SHAPE[1:],
                          dtype=torch.uint8, device="cuda", generator=gen)
        flip = torch.randint(0, 2, (b,), dtype=torch.uint8, device="cuda",
                             generator=gen)
        for mask in (flip, None):
            _preprocess_agrees(pp.preprocess(x, MEAN, STD, mask),
                               pp.normalize_flip_plain(x, MEAN, STD, mask),
                               torch.float32, f"batch {b}")
        for shape in POOL_SHAPES:
            x = torch.randint(0, 3, (b,) + shape[1:], device="cuda",
                              generator=gen).float()
            val, code = pool.pool_fwd(x)
            pval, pcode = pool.pool_fwd_plain(x)
            g = torch.randn(val.shape, device="cuda", generator=gen)
            if not (torch.equal(val, pval) and torch.equal(code, pcode)
                    and torch.equal(pool.pool_bwd(g, code, x.shape),
                                    pool.pool_bwd_plain(g, pcode, x.shape))):
                raise AssertionError(f"kernel B1/B2 disagrees at batch {b}, "
                                     f"{tuple(x.shape)}")
    return sorted(sizes)


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {"normalize_flip": check_preprocess(gen)}
    checks["pool_fwd"], checks["pool_bwd"] = check_pool(gen)
    checks["held_batches"] = check_batches(gen, REHEARSAL_BATCHES)
    log("kernels agree with their plain versions "
        "(preprocess f32 <= 1 ulp, bf16 exact; pool fwd/bwd exact); "
        f"also at batch sizes {checks['held_batches']}")
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
    routes = dict(_kernels.ROUTES)
    log(f"cli wall {wall:.2f} s; kernel launches {launches}; pool routes "
        f"{routes}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    for name in ("pool_fwd", "pool_bwd"):
        if routes[f"{name}_vec"] != launches[name]:
            raise AssertionError(f"{name}: {routes[f'{name}_scalar']} of "
                                 f"{launches[name]} main-path launches "
                                 f"took the scalar route")
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


def _logits_on(manager, model: dict, images, task: int, dev: str):
    """Logits of ``task``'s head for uint8 ``images`` under ``model``, on
    ``dev``: kernels A and B1 on the card, their plain versions (and
    another conv library) on the CPU."""
    from clsurvey_torch.engine.train import state_from_model
    from clsurvey_torch.models import heads
    from clsurvey_torch.ops import preprocess as pp

    seq = manager.dataset
    backbone = manager.model_spec.make_backbone().to(dev)
    state = state_from_model(model, None, dev)
    with torch.no_grad():
        x = pp.preprocess(torch.as_tensor(images).to(dev), seq.mean,
                          seq.std)
        feats = torch.func.functional_call(
            backbone, state.trainable["params"], (x,),
            {"batch_stats": state.batch_stats})
        bank = {**state.trainable["heads"],
                "class_counts": model["heads"]["class_counts"]}
        return heads.forward(bank, feats, task).cpu()


def _finite_tree(tree, what: str, nonneg: bool = False) -> None:
    """Every leaf of a nested dict of arrays is finite (and >= 0)."""
    if isinstance(tree, dict):
        for v in tree.values():
            _finite_tree(v, what, nonneg)
        return
    t = torch.as_tensor(tree)
    if not torch.isfinite(t).all() or (nonneg and bool((t < 0).any())):
        raise AssertionError(f"{what}: non-finite"
                             + (" or negative" if nonneg else "")
                             + " values")


def check_cli_model(manager, model: dict) -> None:
    """The last task's best model: finite weights, and logits on 64 of its
    val images on the card equal to the CPU's, within float32
    summation-order tolerance."""
    _finite_tree(model["params"], "the best model's weights")
    seq = manager.dataset
    images = seq.get_task_dataset(seq.task_count).val.images[:64]
    task = seq.task_count - 1
    logits = {dev: _logits_on(manager, model, images, task, dev)
              for dev in ("cpu", "cuda")}
    diff = (logits["cuda"] - logits["cpu"]).abs().max().item()
    log(f"task {seq.task_count} best model: logits on 64 val images, "
        f"card vs CPU max |diff| {diff:.3g}")
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4,
                               atol=1e-4)


FRAMEWORK_MODEL = "small_VGG9_cl_128_128"
FRAMEWORK_DS = "synthetic_2t_20c_64px_400n"  # two tasks: one Phase-2 task
# GEM's QP: two constraints. 160 train rows a class, not 400, to keep the
# whole script under 600 s beside the alexnet and streaming phases: still
# above iCaRL's 153 exemplars a class and GEM's 1,024 memories a task
REHEARSAL_DS = "synthetic_3t_20c_64px_160n"
FRAMEWORK_METHODS = ("SI", "EWC", "MAS")
MAX_ATTEMPTS = 2
# one attempt a task in the rehearsal phase: the cut that keeps the whole
# script near half its time limit since the masks phase came
REHEARSAL_ATTEMPTS = 1
LOGITS_TOL = 1e-4  # card vs CPU logits, absolute and relative
IMPORTANCE_REL_TOL = 1e-3  # card vs CPU Fisher / omega, of its largest entry


def _framework_common(ds: str = FRAMEWORK_DS) -> list:
    return [FRAMEWORK_MODEL, "--ds_name", ds, "--device", "cuda"]


def si_base_model(root: str, card: str, ds: str = FRAMEWORK_DS) -> str:
    """Dumps the SI first-task base model of ``ds`` under ``root`` through
    the CLI (once for the ``framework`` and ``methods`` phases, once for
    ``rehearsal``); returns its path."""
    from clsurvey_torch.framework import main as cli_main
    from clsurvey_torch.utils import config, io

    os.environ["CLSURVEY_ROOT"] = root
    config.set_config(None)
    dump = _framework_common(ds) + [
        "--method_name", "SI", "--runmode", "first_task_basemodel_dump",
        "--num_epochs", "10", "--batch_size", "200", "--lr_grid", "5e-3",
        "--boot_lr_grid", "5e-3"]
    log("framework: python -m clsurvey_torch.framework.main", " ".join(dump))
    t0 = time.perf_counter()
    base_manager = cli_main.cli(dump)
    torch.cuda.synchronize()
    log(json.dumps({"framework": "SI dump",
                    "seconds": time.perf_counter() - t0, "card": card}))
    base_path = base_manager.best_model_path(1, create=False)
    _finite_tree(io.load(base_path)["method_aux"]["w"], "the dump's SI w")
    return base_path


def run_method(method: str, extra: list, model: str = FRAMEWORK_MODEL,
               ds: str = FRAMEWORK_DS, required=None):
    """One method through the timing_mode CLI with ``--test``, the launch
    counters zeroed just before and read just after; every kernel in
    ``required`` (default: all) must have launched. Returns (manager,
    launches, wall seconds); the batch sizes the kernels saw stay in
    ``_kernels.BATCHES``."""
    from clsurvey_torch.framework import main as cli_main
    from clsurvey_torch.ops import _kernels

    argv = [model] + _framework_common(ds)[1:] + [
        "--method_name", method, "--runmode", "timing_mode",
        "--gridsearch_name", "timing_mode", "--test"] + extra
    log("framework: python -m clsurvey_torch.framework.main", " ".join(argv))
    _kernels.reset_launches()
    t0 = time.perf_counter()
    manager = cli_main.cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    for name in required or launches:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in "
                                 f"{method}'s run")
    return manager, launches, wall


def eval_matrix(manager) -> list:
    """The run's result dicts, one reference-shaped dict per ref task:
    n(n+1)/2 entries in all for n tasks (3 for 2, 6 for 3)."""
    from clsurvey_torch.utils import io, paths

    name = manager.method.eval_name
    n = manager.args.max_task_count or manager.dataset.task_count
    out_dir = paths.get_test_results_path(
        manager.dataset.name, name, manager.model_spec.name, "timing_mode",
        manager.exp_name, create=False)
    matrix = []
    for i in range(n):
        res = io.load(os.path.join(
            out_dir, f"test_method_performances{name}{i}.pth"))[name]
        series = res["seq_res"][i]
        if len(series) != n - i or len(res["seq_forgetting"][i]) != \
                n - 1 - i or not all(0.0 <= a <= 100.0 for a in series):
            raise AssertionError(f"{name}: malformed result dict "
                                 f"{i}: {res}")
        matrix.append(series)
    return matrix


def phase2_task(manager, method: str, task: int,
                max_attempts: int = MAX_ATTEMPTS):
    """Task ``task`` of a two-phase method: SUCCESS token, decay state,
    best model, phase seconds. Returns (model, its directory, record for
    the log)."""
    from clsurvey_torch.framework.hyperparam import PHASE_TIMING_FILENAME
    from clsurvey_torch.utils import io, paths

    exp_dir = manager.task_training_dir(task, create=False)
    if not paths.has_success(exp_dir):
        raise AssertionError(f"{method} task {task}: no SUCCESS token in "
                             f"{exp_dir}")
    hp = io.load(os.path.join(exp_dir, paths.HYPERPARAMS_CKPT_FILENAME))
    model = io.load(os.path.join(exp_dir, paths.BEST_MODEL_FILENAME))
    _finite_tree(model["params"], f"{method} task {task} weights")
    phases = io.load(os.path.join(manager.task_dir(task, create=False),
                                  PHASE_TIMING_FILENAME))
    return model, exp_dir, {
        "framework": method, "task": task, **phases,
        "attempts": min(int(hp["state"]["attempts"]) + 1, max_attempts),
        **hp["state"]["hyperparams"]}


def phase_framework(base_path: str, card: str) -> dict:
    """The per-method timing protocol of the JAX package's
    ``scripts/run_timing_mode.py``: from the SI first-task base model at
    ``base_path``, SI, EWC and MAS through Phase 1, Phase 2 (at most
    ``MAX_ATTEMPTS`` attempts) and the eval matrix, on the card at full
    width. Accuracies are not checked (plain SGD at lr 5e-3 without BN is
    unsteady on this data, so the number of attempts varies); artifacts,
    shapes, launch counts and card-vs-CPU agreement are. Returns
    {method: launches}."""
    from clsurvey_torch.utils import io, timing

    all_launches = {}
    for method in FRAMEWORK_METHODS:
        manager, launches, wall = run_method(
            method, ["--max_attempts_per_task", str(MAX_ATTEMPTS)])
        all_launches[method] = launches
        # task 2: decay state, SUCCESS token, a loadable best model
        for task in (2,):
            model, exp_dir, record = phase2_task(manager, method, task)
            aux = model["method_aux"]
            _finite_tree(aux["omega"], f"{method} task {task} omega",
                         nonneg=True)
            if method == "SI":
                _finite_tree(aux["w"], f"SI task {task} w")
            prep = io.load(os.path.join(
                exp_dir, timing.PREPROCESS_TIME_FILENAME))["preprocess_time"]
            log(json.dumps({**record, "importance_s": prep, "card": card}))
        matrix = eval_matrix(manager)
        log(json.dumps({"framework": method, "seconds": wall,
                        "launches": launches, "eval_matrix": matrix,
                        "card": card}))
        if method == "EWC":
            check_eval_entry(manager, model, matrix)
            check_importance(manager, io.load(base_path))
    return all_launches


def check_eval_entry(manager, model: dict, matrix: list) -> None:
    """Entry (ref task 1, last model) of the eval matrix again, on the CPU
    with the plain versions: logits within ``LOGITS_TOL`` of the card's,
    and the accuracy the matrix holds within one test image."""
    test = manager.dataset.get_task_dataset(1).test
    logits = {dev: _logits_on(manager, model, test.images, 0, dev)
              for dev in ("cpu", "cuda")}
    diff = (logits["cuda"] - logits["cpu"]).abs().max().item()
    acc = float((logits["cpu"].argmax(-1).numpy() == test.labels).mean())
    log(f"eval entry (ref task 1, last model): card vs CPU logits max "
        f"|diff| "
        f"{diff:.3g} on {len(test.labels)} test images; accuracy "
        f"{100 * acc:.2f} (CPU) vs {matrix[0][-1]:.2f} (matrix)")
    torch.testing.assert_close(logits["cuda"], logits["cpu"],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    if abs(100 * acc - matrix[0][-1]) > 100.0 / len(test.labels) + 1e-6:
        raise AssertionError("the eval matrix's entry differs from the "
                             "CPU's by more than one image")


# the CPU pass a card's float32 gradients are held against: the model's
# convs, dense trunk layers and batch-norm in float64; the features, heads
# and loss stay float32 (``models/backbones.py``), about 1e-7 relative,
# far below the 1e-3 the checks hold. The float32 CPU passes are no
# reference: oneDNN's float32 weight gradient is up to 3e-3 of its largest
# entry off float64 (``tests/test_torch_port_alexnet.py``), and the native
# convs' (oneDNN off) sum a large batch's samples one after the other
EXACT_CPU = "cpu64"


def _on_both_devices(manager, rule, task_counter: int, run,
                     exact: bool = False) -> dict:
    """``run(ctx)`` under an augment-free engine context of the run's model
    on the CPU (plain versions of the kernels) and on the card; with
    ``exact`` also on the CPU in float64 (``EXACT_CPU``). Logs each pass's
    seconds."""
    import dataclasses

    from clsurvey_torch.methods import common

    out, spec = {}, manager.model_spec
    passes = ("cpu",) + ((EXACT_CPU,) if exact else ()) + ("cuda",)
    for name in passes:
        manager.args.device = "cuda" if name == "cuda" else "cpu"
        if name == EXACT_CPU:
            manager.model_spec = dataclasses.replace(
                spec, compute_dtype=torch.float64)
        try:
            ctx = common.build_engine(manager, rule, task_counter,
                                      augment=False).ctx
        finally:
            manager.model_spec = spec
        t0 = time.perf_counter()
        out[name] = run(ctx)
        if name == "cuda":
            torch.cuda.synchronize()
        log(f"  on {name}: {time.perf_counter() - t0:.2f} s")
    manager.args.device = "cuda"
    return out


def _abs_gap(got: dict, want: dict) -> tuple[float, float]:
    """(max |got - want| over the leaves, the largest |want| entry)."""
    return (max(float((got[k] - v).abs().max()) for k, v in want.items()),
            max(float(v.abs().max()) for v in want.values()))


def _held_against_exact(what: str, out: dict, tol: float) -> None:
    """Holds the card's tree in ``out`` within ``tol`` of the largest entry
    of the ``EXACT_CPU`` pass's; logs the float32 CPU pass's gap to it
    beside, not held."""
    worst, top = _abs_gap(out["cuda"], out[EXACT_CPU])
    cpu32, _ = _abs_gap(out["cpu"], out[EXACT_CPU])
    log(f"{what}, card vs CPU float64: max |diff| {worst:.3g}, largest "
        f"entry {top:.3g} (tolerance {tol:g} of it); the float32 CPU "
        f"pass: {cpu32:.3g} (logged, not held)")
    if not worst <= tol * top:
        raise AssertionError(f"{what}: the card differs from the CPU")


def check_importance(manager, base_model: dict) -> None:
    """The importance passes of the base model on task 1's first train
    rows, on the card (kernels A, B1, B2; the port's exact float32 weight
    gradient, under ``vmap(grad)`` for MAS) and on the CPU (plain versions):
    EWC's Fisher on 400 rows in batches of 200, and MAS's omega on 32 rows
    in vmapped chunks of ``MAS_CHUNK`` per-sample gradients (the pool's
    vmap fold). Every entry within ``IMPORTANCE_REL_TOL`` of the largest
    of the ``EXACT_CPU`` pass's; the float32 CPU pass's gap logged."""
    from clsurvey_torch.methods.base import UpdateRule
    from clsurvey_torch.models.convert import params_from_jax
    from clsurvey_torch.ops import importance

    train = manager.dataset.get_task_dataset(1).train
    heads = base_model["heads"]
    passes = {
        "Fisher on 400 rows": lambda ctx, p: importance.ewc_fisher(
            ctx, p, {}, heads, 0, train.images[:400], train.labels[:400],
            200),
        "MAS omega on 32 rows": lambda ctx, p: importance.mas_importance(
            ctx, p, {}, heads, 0, train.images[:32], chunk=MAS_CHUNK),
    }
    for what, run in passes.items():
        log(f"{what} of the base model:")
        omega = _on_both_devices(
            manager, UpdateRule(), 2,
            lambda ctx, run=run: {k: v.cpu() for k, v in run(
                ctx, params_from_jax(base_model["params"],
                                     ctx.device)).items()},
            exact=True)
        _held_against_exact(what, omega, IMPORTANCE_REL_TOL)


BN_MODEL = "small_VGG9_cl_128_128_BN_DROP"
EBLL_STATIC = "0.01;10;1e-2;100"  # lr; epochs; alpha; dim: one AE per task
DISTILL_REL_TOL = 1e-4  # card vs CPU distillation value


def phase_methods(base_path: str, card: str) -> dict:
    """LWF and EBLL (two phases), mean_IMM and mode_IMM (Phase 1, merges at
    eval time) from the SI base model at ``base_path``, and finetuning on
    the batch-norm and dropout model, each through the timing_mode CLI with
    ``--test`` on the card at full width. Artifacts and numbers are
    checked, not accuracies. Returns {method: launches}."""
    from clsurvey_torch.framework.hyperparam import PHASE_TIMING_FILENAME
    from clsurvey_torch.methods.imm import PRECISION_FILENAME
    from clsurvey_torch.utils import io, timing

    all_launches = {}
    attempts = ["--max_attempts_per_task", str(MAX_ATTEMPTS)]
    for method, extra in (
            ("LWF", attempts),
            ("EBLL", attempts + ["--static_hyperparams", EBLL_STATIC])):
        manager, launches, wall = run_method(method, extra)
        all_launches[method] = launches
        models = {}
        for task in (2,):
            models[task], _, record = phase2_task(manager, method, task)
            if method == "EBLL":
                encoders = models[task]["method_aux"]["encoders"]
                if len(encoders) != task - 1:
                    raise AssertionError(
                        f"EBLL task {task}: {len(encoders)} encoders in "
                        f"the best model, not {task - 1}")
                _finite_tree({str(i): e for i, e in enumerate(encoders)},
                             f"EBLL task {task} encoders")
                conv_dim = models[task]["params"]["trunk"]["fc_0"][
                    "kernel"].shape[0]  # 2048 for small_VGG9 at 64 px
                if encoders[-1]["enc"]["kernel"].shape != (conv_dim, 100):
                    raise AssertionError("EBLL: encoder of another shape")
            log(json.dumps({**record, "card": card}))
        log(json.dumps({"framework": method, "seconds": wall,
                        "launches": launches,
                        "eval_matrix": eval_matrix(manager), "card": card}))
        if method == "LWF":
            check_distillation(manager, io.load(base_path), models[2])

    for method in ("mean_IMM", "mode_IMM"):
        manager, launches, wall = run_method(method, [])
        all_launches[method] = launches
        mode = manager.method.mode
        for task in (2,):
            task_dir = manager.task_training_dir(task, create=False)
            merged = io.load(os.path.join(
                task_dir, f"best_model_{mode}_IMM_merge.pth.tar"))
            _finite_tree(merged["params"], f"{method} merge {task}")
            phases = io.load(os.path.join(
                manager.task_dir(task, create=False), PHASE_TIMING_FILENAME))
            log(json.dumps({"framework": method, "task": task, **phases,
                            "card": card}))
        if mode == "mode":
            # IMM trains task 1 too (L2 transfer from the base model)
            for d in (manager.task_training_dir(t, create=False)
                      for t in (1, 2)):
                prec = io.load(os.path.join(d, PRECISION_FILENAME))
                _finite_tree(prec, f"precision in {d}", nonneg=True)
                if min(float(torch.as_tensor(v).min()) for v in
                       _leaves(prec)) <= 0:
                    raise AssertionError(f"precision in {d} is not positive")
        merge_s = io.load(os.path.join(
            manager.task_training_dir(2, create=False),
            timing.PREPROCESS_TIME_FILENAME))["preprocess_time"]
        log(json.dumps({"framework": method, "seconds": wall,
                        "merge_s": merge_s, "launches": launches,
                        "eval_matrix": eval_matrix(manager), "card": card}))
        if mode == "mode":
            check_mode_fisher(manager, io.load(base_path))

    manager, launches, wall = run_method("finetuning", [], model=BN_MODEL)
    all_launches["finetuning_BN_DROP"] = launches
    for task in (1, 2):
        exp_dir = manager.task_training_dir(task, create=False)
        model = io.load(os.path.join(exp_dir, "best_model.pth.tar"))
        _finite_tree(model["params"], f"BN model, task {task}: weights")
        _finite_tree(model["batch_stats"], f"BN model, task {task}: stats")
        stats = model["batch_stats"]["features"]
        if sorted(stats) != ["bn_0", "bn_2", "bn_4", "bn_5", "bn_7", "bn_8"] \
                or any(float(st["var"].min()) <= 0 for st in stats.values()):
            raise AssertionError(f"BN model, task {task}: batch_stats "
                                 f"{sorted(stats)} or a variance <= 0")
        with open(os.path.join(exp_dir, "error_history.json")) as f:
            history = json.load(f)
        log(json.dumps({
            "framework": "finetuning_BN_DROP", "task": task,
            "seconds": manager.extras["task_seconds"][task],
            "val_acc": model["meta"].get("val_acc"),
            "epochs": len(history["error_history"]),
            "last_train_loss": history["train_loss"],
            "never_improved": bool(model["meta"].get("failed_attempt")),
            "card": card}))
    log(json.dumps({"framework": "finetuning_BN_DROP", "seconds": wall,
                    "launches": launches,
                    "eval_matrix": eval_matrix(manager),
                    "card": card}))
    check_cli_model(manager, model)
    return all_launches


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def check_distillation(manager, teacher_model: dict, model: dict) -> None:
    """LwF's distillation term of task 2's model against the base model
    (one previous head, lambda 1) on task 2's first 200 train rows, on the
    card and on the CPU: equal within ``DISTILL_REL_TOL`` relative."""
    from clsurvey_torch.engine.train import state_from_model
    from clsurvey_torch.methods.lwf import LwFRule

    rule = LwFRule()
    images = manager.dataset.get_task_dataset(2).train.images[:200]

    def run(ctx):
        mstate = rule.init_state(None, {"lambda": 1.0}, ctx,
                                 prev_model=teacher_model)
        state = state_from_model(model, mstate, ctx.device)
        with torch.no_grad():
            x = ctx.preprocess(torch.from_numpy(images).to(ctx.device))
            feats, _ = ctx.forward_feats(state.trainable["params"],
                                         state.batch_stats, x, False)
            return float(rule.distill_term(ctx, state.trainable, feats,
                                           (x, None), mstate))

    log("distillation term on 200 rows, one previous head:")
    value = _on_both_devices(manager, rule, 2, run)
    log(f"distillation term, card vs CPU: {value['cuda']:.7g} vs "
        f"{value['cpu']:.7g} (tolerance {DISTILL_REL_TOL:g} relative)")
    if not value["cpu"] > 0 or abs(value["cuda"] - value["cpu"]) > \
            DISTILL_REL_TOL * abs(value["cpu"]):
        raise AssertionError("the distillation term on the card differs "
                             "from the CPU's")


def check_mode_fisher(manager, base_model: dict) -> None:
    """mode-IMM's Fisher of the base model on task 1's first 400 train rows
    in batches of 200, with one set of labels (sampled on the CPU from the
    model's softmax) handed to every run: every entry on the card within
    ``IMPORTANCE_REL_TOL`` of the largest entry of the ``EXACT_CPU``
    pass's; the float32 CPU pass's gap logged."""
    from clsurvey_torch.methods.base import UpdateRule
    from clsurvey_torch.models.convert import params_from_jax
    from clsurvey_torch.ops import importance

    images = manager.dataset.get_task_dataset(1).train.images[:400]
    logits = _logits_on(manager, base_model, images, 0, "cpu")
    labels = torch.multinomial(
        torch.softmax(logits, -1), 1,
        generator=torch.Generator().manual_seed(0)).squeeze(1).numpy()

    def run(ctx):
        out = importance.imm_mode_fisher(
            ctx, params_from_jax(base_model["params"], ctx.device), {},
            base_model["heads"], 0, [images], 200, sampled_labels=[labels])
        return {k: v.cpu() for k, v in out.items()}

    log("mode-IMM Fisher on 400 rows:")
    omega = _on_both_devices(manager, UpdateRule(), 2, run, exact=True)
    _held_against_exact("mode-IMM Fisher on 400 rows", omega,
                        IMPORTANCE_REL_TOL)


MEM_PER_TASK = 1024  # scripts/run_timing_mode.py's for GEM and ICARL
REHEARSAL_METHODS = tuple(
    (m, ["--static_hyperparams", str(MEM_PER_TASK)]) for m in (
        "GEM", "ICARL", "finetuning_rehearsal_partial_mem",
        "finetuning_rehearsal_full_mem")) + (("packnet", []),)
NEG_INF = -1e10


def phase_rehearsal(root: str, card: str) -> tuple[dict, list]:
    """GEM and iCaRL (wrapping their own SI base model of
    ``REHEARSAL_DS``), the two replay baselines and PackNet, each through
    the timing_mode CLI with ``--test`` on the card at full width, three
    tasks, counters zeroed before each. Checks the memories, exemplar
    stores and masks in the best models, the result dicts, and GEM's
    projected gradient, one iCaRL NCM entry and one PackNet masked eval on
    the card against the CPU. Returns ({method: launches}, the batch sizes
    the kernels saw)."""
    from clsurvey_torch.ops import _kernels
    from clsurvey_torch.utils import config

    si_base_model(root, card, REHEARSAL_DS)
    checks = {"GEM": check_gem, "ICARL": check_icarl,
              "finetuning_rehearsal_partial_mem": check_replay,
              "finetuning_rehearsal_full_mem": check_replay,
              "packnet": check_packnet}
    all_launches, seen = {}, set()
    for method, extra in REHEARSAL_METHODS:
        os.environ["CLSURVEY_ROOT"] = root
        config.set_config(None)
        torch.cuda.reset_peak_memory_stats()
        manager, launches, wall = run_method(
            method, ["--max_attempts_per_task", str(REHEARSAL_ATTEMPTS)]
            + extra, ds=REHEARSAL_DS)
        peak = torch.cuda.max_memory_allocated()
        batches = sorted(set().union(*_kernels.BATCHES.values()))
        seen.update(batches)
        all_launches[method] = launches
        matrix = eval_matrix(manager)
        extra_record = checks[method](manager, matrix, card)
        log(json.dumps({"rehearsal": method, "seconds": wall,
                        "max_memory_allocated": peak,
                        "launches": launches, "batches": batches,
                        "eval_matrix": matrix, **extra_record,
                        "card": card}))
    log(f"rehearsal: the kernels saw batch sizes {sorted(seen)}")
    return all_launches, sorted(seen)


def _phase_records(manager, method: str, card: str, tasks=(2, 3),
                   max_attempts: int = REHEARSAL_ATTEMPTS) -> None:
    for task in tasks:
        log(json.dumps({**phase2_task(manager, method, task,
                                      max_attempts)[2], "card": card}))


def check_gem(manager, matrix, card) -> dict:
    """Every task's best model carries the memory: task t's and the earlier
    buffers full (1024 rows each), the later ones empty; the share of
    projected steps per task; then the projected gradient of task 3's first
    batch on the card against the CPU, with and without batch-norm."""
    from clsurvey_torch.utils import io

    _phase_records(manager, "GEM", card)
    share = {}
    for t in (1, 2, 3):
        exp_dir = manager.task_training_dir(t, create=False)
        mem = io.load(os.path.join(exp_dir, "best_model.pth.tar"))[
            "method_aux"]["memory"]
        want = [MEM_PER_TASK] * t + [0] * (3 - t)
        if list(mem["mem_count"]) != want or mem["mem_images"].shape != \
                (3, MEM_PER_TASK, *manager.dataset.input_size, 3):
            raise AssertionError(f"GEM task {t}: memory counts "
                                 f"{list(mem['mem_count'])}, not {want}")
        if t > 1:
            with open(os.path.join(exp_dir, "error_history.json")) as f:
                per_epoch = json.load(f)["rule_metrics"]["projected"]
            share[t] = sum(per_epoch) / len(per_epoch)
    log(f"GEM: share of projected steps per task {share}")
    check_gem_projection(manager)
    return {"projected_share": share}


def check_gem_projection(manager) -> None:
    """GEM's gradient of task 3's first 200 train rows with the memory of
    task 2's best model (two past tasks of 1024 rows, a two-constraint QP),
    on the card (kernels A, B1, B2) and on the CPU (plain versions; float32,
    and float64 for the held pass), in the chunks GEM's run uses: for that
    model (one pass of 1024 rows a task) and for ``BN_MODEL`` from random
    weights (chunks of 128 rows; card vs CPU on the first
    ``GEM_BN_COMPARE_ROWS`` rows of each memory, which saves the CPU 12 of
    its 17 passes)."""
    from clsurvey_torch.models.registry import (init_model_state,
                                                parse_model_name)
    from clsurvey_torch.utils import io

    model = io.load(manager.best_model_path(2, create=False))
    gem_step(manager, model, MEM_PER_TASK)
    seq, run_spec = manager.dataset, manager.model_spec
    manager.model_spec = parse_model_name("", BN_MODEL, seq.input_size)
    try:
        gem_step(manager, {**init_model_state(
            manager.model_spec, 0, manager.max_tasks,
            seq.max_classes_per_task,
            seq.class_count_list() + [0] * (manager.max_tasks
                                           - seq.task_count)),
            "method_aux": model["method_aux"]}, GEM_BN_COMPARE_ROWS)
    finally:
        manager.model_spec = run_spec


GEM_BN_COMPARE_ROWS = 256  # two 128-row chunks a past task


def gem_step(manager, model: dict, compare_rows: int) -> None:
    """One GEM step of task 3 under ``model`` and ``manager.model_spec`` on
    both devices, with the first ``compare_rows`` rows of each memory and
    one set of dropout keep-masks (drawn on the CPU) for every pass: the
    card's projected gradient within 1e-3 of the largest entry of the
    ``EXACT_CPU`` pass's, with the same projection decision (the float32
    CPU pass's gap and decision logged, not held). On the card, with the whole
    memory, also the launches and peak memory of one step, and the device
    and event time of the step and of the projection alone."""
    from clsurvey_torch.engine.train import Engine, state_from_model
    from clsurvey_torch.methods import rehearsal
    from clsurvey_torch.ops import _kernels
    from clsurvey_torch.ops.qp import gem_project_if_violating

    spec = manager.model_spec
    train = manager.dataset.get_task_dataset(3).train
    chunk = rehearsal.gem_chunk_rows(MEM_PER_TASK, spec.batch_norm)
    rule = rehearsal.GEMRule(MEM_PER_TASK, mem_batch=chunk)
    memory = model["method_aux"]["memory"]
    compared = {**memory,
                "mem_images": memory["mem_images"][:, :compare_rows],
                "mem_labels": memory["mem_labels"][:, :compare_rows],
                "mem_count": memory["mem_count"].clip(max=compare_rows)}

    def run(ctx):
        masks_gen = torch.Generator().manual_seed(0)

        def keep(n):
            if not spec.uses_dropout:
                return None
            return [torch.randint(0, 2, (n, int(d)), dtype=torch.uint8,
                                  generator=masks_gen).to(ctx.device)
                    for d in spec.classifier_dims]

        rule.draw = lambda ctx_, gen, n: (None, keep(n))  # no flips
        batch = (ctx.preprocess(torch.from_numpy(train.images[:200]).to(
            ctx.device)), torch.from_numpy(train.labels[:200]).to(
                ctx.device).long())
        base_fn = functools.partial(Engine(ctx)._base_loss_and_grads,
                                    dropout_masks=keep(200))

        def step_with(mem):
            mstate = rule.init_state(None, {"margin": 1.0}, ctx, memory=mem)
            state = state_from_model(model, mstate, ctx.device)
            return state, mstate, lambda: rule.compute_grads(
                ctx, state.trainable, state.batch_stats, batch, mstate,
                base_fn)

        _, grads, _, metrics = step_with(compared)[2]()
        out = {"grad": rehearsal._flat(grads).cpu(),
               "projected": float(metrics["projected"])}
        if ctx.device.type == "cuda":
            state, mstate, step = step_with(memory)
            _kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            _, grads, _, _ = step()
            out["launches"] = dict(_kernels.LAUNCHES)
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            out["step_ms"] = time_ms(step, iters=3, warmup=1)
            g = rehearsal._flat(grads).detach()
            G = rule.memory_grads(ctx, state.trainable, state.batch_stats,
                                  mstate)
            margin = mstate["hyper"]["margin"]
            out["qp_ms"] = time_ms(
                lambda: gem_project_if_violating(g, G, margin), iters=10)
        return out

    what = (f"{spec.name}, task 3, batch 200, 2 memories of "
            f"{MEM_PER_TASK} rows in chunks of {chunk}")
    log(f"GEM gradient of task 3's first batch ({what}; card vs CPU on "
        f"{compare_rows} rows a memory):")
    out = _on_both_devices(manager, rule, 3, run, exact=True)
    want = out[EXACT_CPU]["grad"]
    top = float(want.abs().max())
    diff = float((out["cuda"]["grad"] - want).abs().max())
    log(json.dumps({
        "gem_step": what, "compared_rows": compare_rows,
        "projected": {d: out[d]["projected"] for d in out},
        "max_abs_diff": diff, "largest": top,
        "cpu32_max_abs_diff": float(
            (out["cpu"]["grad"] - want).abs().max()),
        "launches_per_step": out["cuda"]["launches"],
        "max_memory_allocated": out["cuda"]["max_memory_allocated"],
        **{f"{part}_{clock}_ms": ms for part in ("step", "qp")
           for clock, ms in zip(("device", "event"),
                                out["cuda"].get(f"{part}_ms", ()))}}))
    if not diff <= 1e-3 * top or \
            out[EXACT_CPU]["projected"] != out["cuda"]["projected"]:
        raise AssertionError(f"GEM's projected gradient on the card differs "
                             f"from the CPU's ({spec.name})")


def check_icarl(manager, matrix, card) -> dict:
    """The exemplar store after each task: K // classes seen rows per class
    (153, then 76, then 51 of K = 3072 over 20-class tasks), in class
    order, each row's targets finite over the heads of its herding task and
    -1e10 beyond, padded to the full width; then entry (ref task 1, model
    3) by NCM on the card and on the CPU against the matrix."""
    import numpy as np

    from clsurvey_torch.utils import io

    _phase_records(manager, "ICARL", card)
    c = manager.dataset.class_count_list()[0]
    per_class = {t: 3 * MEM_PER_TASK // (c * t) for t in (1, 2, 3)}
    paths = {1: manager.best_model_path(1, create=False)}
    for t in (2, 3):
        paths[t] = os.path.join(manager.task_training_dir(t, create=False),
                                "best_model_postprocessed.pth.tar")
    for t, path in paths.items():
        ex = io.load(path)["method_aux"]["exemplars"]
        n = int(ex["count"])
        labels = np.asarray(ex["labels"])[:n]
        counts = np.bincount(labels, minlength=c * t)
        targets = np.asarray(ex["targets"])[:n]
        width = c * (np.asarray(ex["task_ids"])[:n] + 1)
        inside = np.arange(3 * c)[None, :] < width[:, None]
        if n != c * t * per_class[t] or set(counts) != {per_class[t]} \
                or targets.shape[1] != 3 * c \
                or not np.isfinite(targets[inside]).all() \
                or not (targets[~inside] == np.float32(NEG_INF)).all() \
                or list(labels) != sorted(labels):
            raise AssertionError(f"iCaRL task {t}: exemplar store of {n} "
                                 f"rows, per-class counts {set(counts)}")
    log(f"iCaRL: exemplars per class {per_class} (store of "
        f"{3 * MEM_PER_TASK})")
    check_ncm_entry(manager, paths[3], matrix)
    return {"exemplars_per_class": per_class}


def check_ncm_entry(manager, model_path: str, matrix: list) -> None:
    """Entry (ref task 1, model 3) of iCaRL's matrix again, NCM heads and
    all, on the card and on the CPU: each within one test image of the
    matrix."""
    n_test = len(manager.dataset.get_task_dataset(1).test.labels)
    acc = {}
    for dev in ("cpu", "cuda"):
        manager.args.device = dev
        t0 = time.perf_counter()
        acc[dev] = 100 * manager.method.inference_eval(manager, model_path,
                                                       1, 3)
        log(f"  iCaRL NCM entry on {dev}: {acc[dev]:.4f} "
            f"({time.perf_counter() - t0:.2f} s)")
    manager.args.device = "cuda"
    log(f"iCaRL NCM entry (ref task 1, model 3): card {acc['cuda']:.4f}, "
        f"CPU {acc['cpu']:.4f}, matrix {matrix[0][-1]:.4f}")
    if max(abs(a - matrix[0][-1]) for a in acc.values()) > \
            100.0 / n_test + 1e-6:
        raise AssertionError("iCaRL's NCM entry differs by more than one "
                             "test image")


def check_replay(manager, matrix, card) -> dict:
    """Every task's best model (the LR grid's winner) carries the memory:
    the buffers of the tasks so far full, the later ones empty."""
    from clsurvey_torch.utils import io

    for t in (1, 2, 3):
        mem = io.load(manager.best_model_path(t, create=False))[
            "method_aux"]["memory"]
        want = [MEM_PER_TASK] * t + [0] * (3 - t)
        if list(mem["mem_count"]) != want:
            raise AssertionError(f"{manager.method.name} task {t}: memory "
                                 f"counts {list(mem['mem_count'])}")
    return {"task_seconds": manager.extras["task_seconds"]}


def check_packnet(manager, matrix, card) -> dict:
    """Per task, the Phase-2 best model's masks: owners in {0..t}; the task's
    weights exactly those its Phase-1 winner keeps when pruned at one of
    the percentages the decay can reach by then (none below that cutoff
    left); every pruned weight exactly 0. Then entry (ref task 1, model
    3)'s logits with task 1's mask applied, on the card against the
    CPU."""
    import glob

    from clsurvey_torch.models.convert import params_from_jax
    from clsurvey_torch.ops import masks as masks_lib
    from clsurvey_torch.utils import io, paths

    _phase_records(manager, "packnet", card, tasks=(1, 2, 3))
    capacity = {}
    for t in (1, 2, 3):
        model = io.load(manager.best_model_path(t, create=False))
        masks = params_from_jax(model["method_aux"]["masks"], dtype=None)
        params = params_from_jax(model["params"])
        (ft_path,) = glob.glob(os.path.join(
            manager.task_dir(t, create=False), paths.LR_GRID_DIRNAME, "*",
            paths.BEST_MODEL_FILENAME))
        ft = io.load(ft_path)
        ft_masks = params_from_jax(ft["method_aux"]["masks"], dtype=None)
        repruned = [masks_lib.prune_masks(params_from_jax(ft["params"]),
                                          ft_masks, t, 0.9 * 0.5 ** a)[1]
                    # a retained attempt's decay carries to the next task
                    for a in range(3 * REHEARSAL_ATTEMPTS)]
        maskable = [k for k, m in masks.items() if m.dim()]
        if any(int(masks[k].max()) > t for k in maskable) \
                or not any(all(torch.equal(r[k], masks[k]) for k in maskable)
                           for r in repruned) \
                or any(bool((params[k][masks[k] == 0] != 0).any())
                       for k in maskable):
            raise AssertionError(f"PackNet task {t}: masks or pruned "
                                 f"weights are off")
        capacity[t] = masks_lib.capacity_report(masks, t)
    log(f"PackNet: capacity per owner after each task {capacity}")
    check_packnet_logits(manager)
    return {"capacity": capacity}


def check_packnet_logits(manager) -> None:
    """Task 3's PackNet model with task 1's mask applied: logits of task
    1's test images on the card and on the CPU, within ``LOGITS_TOL``."""
    from clsurvey_torch.methods.packnet import load_with_masks
    from clsurvey_torch.models.convert import params_from_jax, params_to_jax
    from clsurvey_torch.ops import masks as masks_lib

    model, masks = load_with_masks(manager.best_model_path(3, create=False),
                                   "cpu")
    masked = {**model, "params": params_to_jax(masks_lib.apply_eval_mask(
        params_from_jax(model["params"]), masks, 1))}
    test = manager.dataset.get_task_dataset(1).test
    logits = {dev: _logits_on(manager, masked, test.images, 0, dev)
              for dev in ("cpu", "cuda")}
    diff = (logits["cuda"] - logits["cpu"]).abs().max().item()
    log(f"PackNet masked eval (ref task 1, model 3): card vs CPU logits max "
        f"|diff| {diff:.3g} on {len(test.labels)} test images")
    torch.testing.assert_close(logits["cuda"], logits["cpu"],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


MASK_METHODS = (
    # the timing script's HAT row: smax 800, c 2.5 (scripts/
    # run_timing_mode.py:47); PathNet at M 20, N 3, generations cut 35 -> 6:
    # timing_mode's 10 epochs give each generation 10 // 6 = 1 epoch a
    # candidate, 12 a tournament ("20;5" gives 2 and 20)
    ("HAT", [], ("normalize_flip", "pool_fwd", "pool_bwd")),
    ("pathnet", ["--static_hyperparams", "20;6"], ("normalize_flip",)))
STEP_REL_TOL = 1e-3  # card vs CPU processed gradient, of its largest entry


def phase_masks(root: str, card: str) -> tuple[dict, list]:
    """HAT and PathNet from scratch, each through the timing_mode CLI with
    ``--test`` on the card at full width, two tasks, counters zeroed
    before each. HAT must launch A, B1 and B2; PathNet A and neither pool
    kernel (it pools with ``F.max_pool2d``, as the JAX package pools it
    with XLA's ``reduce_window``). Then each method's own checks. Returns
    ({method: launches}, the batch sizes the kernels saw)."""
    from clsurvey_torch.ops import _kernels
    from clsurvey_torch.utils import config

    checks = {"HAT": check_hat, "pathnet": check_pathnet}
    all_launches, seen = {}, set()
    for method, extra, required in MASK_METHODS:
        os.environ["CLSURVEY_ROOT"] = root
        config.set_config(None)
        torch.cuda.reset_peak_memory_stats()
        manager, launches, wall = run_method(
            method, ["--max_attempts_per_task", str(MAX_ATTEMPTS)] + extra,
            required=required)
        peak = torch.cuda.max_memory_allocated()
        batches = sorted(set().union(*_kernels.BATCHES.values()))
        seen.update(batches)
        if method == "pathnet" and (launches["pool_fwd"]
                                    or launches["pool_bwd"]):
            raise AssertionError(f"PathNet launched a pool kernel: "
                                 f"{launches}")
        all_launches[method] = launches
        matrix = eval_matrix(manager)
        _phase_records(manager, method, card, tasks=(1, 2),
                       max_attempts=MAX_ATTEMPTS)
        extra_record = checks[method](manager, matrix)
        log(json.dumps({"masks": method, "seconds": wall,
                        "max_memory_allocated": peak,
                        "launches": launches, "batches": batches,
                        "eval_matrix": matrix, **extra_record,
                        "card": card}))
    log(f"masks: the kernels saw batch sizes {sorted(seen)}")
    return all_launches, sorted(seen)


def _task_models(manager) -> list:
    from clsurvey_torch.utils import io

    return [io.load(manager.best_model_path(t, create=False))
            for t in (1, 2)]


def _mask_logits(manager, model: dict, task: int, dev: str):
    """Logits of task 1's test images under a HAT or PathNet model, with
    ``task``'s gates or best path and head, on ``dev``."""
    from clsurvey_torch.engine.train import trainable_from_host
    from clsurvey_torch.models import convert, heads
    from clsurvey_torch.ops import preprocess as pp

    seq = manager.dataset
    images = seq.get_task_dataset(task + 1).test.images
    net = manager.method._net(manager)
    if model["meta"].get("hat"):
        tr = trainable_from_host(model, dev, False,
                                 convert.hat_params_from_jax)
        args = (task, float(model["meta"]["smax"]))
    else:
        tr = trainable_from_host(model, dev, False,
                                 convert.pathnet_params_from_jax)
        args = (torch.as_tensor(model["method_aux"]["best_paths"][task],
                                dtype=torch.long, device=dev),)
    bank = {**tr["heads"], "class_counts": model["heads"]["class_counts"]}
    with torch.no_grad():
        x = pp.preprocess(torch.as_tensor(images).to(dev), seq.mean,
                          seq.std)  # kernel A on the card
        out = torch.func.functional_call(net, tr["params"], (x, *args))
        feats = out[0] if isinstance(out, tuple) else out
        return heads.forward(bank, feats, task).cpu()


def check_mask_entry(manager, model: dict, matrix: list) -> None:
    """Entry (ref task 1, model 2) again: logits on the card and on the
    CPU within ``LOGITS_TOL``, the CPU's accuracy within one test image of
    the matrix."""
    labels = manager.dataset.get_task_dataset(1).test.labels
    logits = {dev: _mask_logits(manager, model, 0, dev)
              for dev in ("cpu", "cuda")}
    diff = (logits["cuda"] - logits["cpu"]).abs().max().item()
    acc = float((logits["cpu"].argmax(-1).numpy() == labels).mean())
    log(f"{manager.method.name} eval entry (ref task 1, model 2): card vs "
        f"CPU logits max |diff| {diff:.3g} on {len(labels)} test images; "
        f"accuracy {100 * acc:.2f} (CPU) vs {matrix[0][-1]:.2f} (matrix)")
    torch.testing.assert_close(logits["cuda"], logits["cpu"],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    if abs(100 * acc - matrix[0][-1]) > 100.0 / len(labels) + 1e-6:
        raise AssertionError("the eval matrix's entry differs from the "
                             "CPU's by more than one image")


def _hat_engine(manager, prev: dict, smax: float, dev: str,
                dtype=torch.float32):
    """Task 2's HAT engine on ``dev`` computing in ``dtype`` up to the
    features, its masks from task 1's model as the CLI computes them, in
    float32 (at smax 800 float32's sigmoid saturates to exactly 1 where
    float64's does not, and the sparsity term's normalisation counts the
    units left free)."""
    from clsurvey_torch.methods import hat
    from clsurvey_torch.models.convert import hat_params_from_jax

    net = manager.method._net(manager)
    params = hat_params_from_jax(prev["params"], dev)
    mask_pre = hat.compute_mask_pre(params, net.emb_names, 1, smax)
    mask_back = hat.compute_mask_back(net, params, mask_pre)
    net.dtype = dtype
    mask_pre = [m.to(dtype) for m in mask_pre]
    mask_back = {k: m.to(dtype) for k, m in mask_back.items()}
    seq = manager.dataset
    return hat.HATEngine(net, manager.model_spec, 1,
                         prev["heads"]["class_counts"], seq.mean, seq.std,
                         smax, mask_pre, mask_back, device=dev)


def check_hat(manager, matrix) -> dict:
    """Every embedding within +-6; wherever task 2's ``mask_back`` is 0,
    task 2's best model equals task 1's bit for bit, and so does task 1's
    embedding row; the capacity report; the eval entry (ref task 1, model
    2) on the card against the CPU; then :func:`hat_step`."""
    from clsurvey_torch.methods import hat
    from clsurvey_torch.models.convert import hat_params_from_jax

    models = _task_models(manager)
    for t, m in enumerate(models, 1):
        _finite_tree(m["params"], f"HAT task {t} weights")
        worst = max(float(abs(v).max()) for k, v in m["params"].items()
                    if k.startswith("emb_"))
        if worst > hat.THRES_EMB:
            raise AssertionError(f"HAT task {t}: an embedding at {worst}")
    smax = float(models[1]["meta"]["smax"])
    mask_back = _hat_engine(manager, models[0], smax, "cpu").mask_back
    p1, p2 = (hat_params_from_jax(m["params"]) for m in models)
    blocked = 0
    for name, m in mask_back.items():
        same = (p2[name][0].equal(p1[name][0]) if name.startswith("emb_")
                else p2[name][m == 0].equal(p1[name][m == 0]))
        if not same:
            raise AssertionError(f"HAT: {name} moved where task 1 holds it")
        blocked += int((m == 0).sum())
    log(f"HAT: the {blocked} weights task 2 may not move, and task 1's "
        f"embedding rows, are bit-unchanged")
    report = hat.capacity_report(p2, 1, smax, mask_back, log=log)
    check_mask_entry(manager, models[1], matrix)
    return {"blocked_weights": blocked,
            "capacity_left_avg": report.get("capacity_left/avg"),
            **hat_step(manager, models, smax)}


def hat_step(manager, models: list, smax: float) -> dict:
    """One task-2 step of task 2's model on task 2's first 200 train rows
    at s = 1/smax (an epoch's first step: smax / s = smax**2), no flips:
    the processed gradient of the card's float32 step against the CPU's
    float64 step (PyTorch's native convs; the features, as on the card,
    go to the float32 head bank), with and without ``mask_back``, each
    leaf within ``STEP_REL_TOL`` of the largest entry of its float64
    gradient without ``mask_back`` (the mask only zeroes or scales
    entries, so that is the scale of the sums behind them); on the card
    the launches of the step and its device and event ms. The gap of a
    float32 CPU step on oneDNN's convs, the CPU's default, is logged and
    not held: its weight gradients lose digits to cancellation (up to 3e-3
    of their largest entry against float64,
    ``tests/test_torch_port_alexnet.py``). Every gap is logged before any
    is held."""
    from clsurvey_torch.engine.train import tree_zeros_like
    from clsurvey_torch.methods import hat
    from clsurvey_torch.ops import _kernels

    train = manager.dataset.get_task_dataset(2).train
    lamb = float(manager.method.hyperparams["c"])
    s = hat.anneal_s(smax, 0, 40)
    grads, out = {}, {}
    # (name, device, dtype, oneDNN convs on the CPU, with mask_back only)
    for name, dev, dtype, mkldnn, only_blocked in (
            ("cpu64", "cpu", torch.float64, False, False),
            ("cpu32_onednn", "cpu", torch.float32, True, True),
            ("card32", "cuda", torch.float32, False, False)):
        engine = _hat_engine(manager, models[0], smax, dev, dtype)
        tr = hat.hat_from_host(models[1], dev, True)
        tr["params"] = {k: v.detach().to(dtype).requires_grad_()
                        for k, v in tr["params"].items()}
        x = torch.from_numpy(train.images[:200]).to(dev)
        y = torch.from_numpy(train.labels[:200]).to(dev).long()
        mask_back = engine.mask_back
        for blocked in (True,) if only_blocked else (True, False):
            engine.mask_back = mask_back if blocked else None
            with torch.backends.mkldnn.flags(enabled=mkldnn):
                g, _ = engine.grads(tr, x, y, s, lamb)
            grads[name, blocked] = {
                **{k: v.double().cpu() for k, v in g["params"].items()},
                **{f"heads.{k}": v.double().cpu()
                   for k, v in g["heads"].items()}}
        engine.mask_back = mask_back
        if dev == "cuda":
            state = (tr, tree_zeros_like(tr))
            step = lambda: engine.train_step(state, x, y, 1e-5, s, lamb)
            _kernels.reset_launches()
            step()
            torch.cuda.synchronize()
            out["launches_per_step"] = dict(_kernels.LAUNCHES)
            out["step_device_ms"], out["step_event_ms"] = time_ms(
                step, iters=10, warmup=2)
    tops = {k: float(v.abs().max()) for k, v in grads["cpu64", False].items()}
    worst, failed = {}, []
    for got_of, blocked, held in (("card32", True, True),
                                  ("card32", False, True),
                                  ("cpu32_onednn", True, False)):
        key = (f"{got_of}_vs_cpu64_"
               f"{'with_mask_back' if blocked else 'without'}")
        worst[key] = ("", 0.0)
        for k, want in grads["cpu64", blocked].items():
            diff = float((grads[got_of, blocked][k] - want).abs().max())
            if held and not diff <= STEP_REL_TOL * tops[k]:
                failed.append(f"{key}: {k}: {diff} (largest entry "
                              f"{tops[k]})")
            if tops[k] and diff / tops[k] >= worst[key][1]:
                worst[key] = (k, diff / tops[k])
    out["worst_diff_of_largest"] = worst
    log(json.dumps({"hat_step": "task 2, batch 200, s = 1/smax, no flips; "
                    "held: card32 vs cpu64", **out}))
    if failed:
        raise AssertionError("HAT step differs on the card from the CPU's "
                             "float64 step: " + "; ".join(failed))
    return out


def pathnet_layer_gaps(manager, model: dict) -> list:
    """Where the card's PathNet logits leave the CPU's. Task 1's test
    images on its best path, layer by layer: each layer's raw product
    (conv or dense, before ReLU) and its whole module (ReLU, pool, sum
    over the path's N modules) on the card against the CPU, both fed the
    CPU's input to that layer, with cuDNN's autotuner on (the port's
    setting) and off; then the gap carried to the features (each device's
    own activations). Gaps are max |card - CPU| and that over max |CPU|.
    Restores the autotuner's setting."""
    import torch.nn.functional as F

    from clsurvey_torch.methods import pathnet
    from clsurvey_torch.models.convert import pathnet_params_from_jax
    from clsurvey_torch.ops import preprocess as pp

    seq = manager.dataset
    net = manager.method._net(manager)
    params = pathnet_params_from_jax(model["params"])
    path = torch.as_tensor(model["method_aux"]["best_paths"][0],
                           dtype=torch.long)
    images = torch.as_tensor(seq.get_task_dataset(1).test.images)
    x = pp.preprocess(images, seq.mean, seq.std).permute(0, 3, 1, 2)

    def gap(card, cpu) -> list:
        d = (card.float().cpu() - cpu).abs().max().item()
        return [d, d / max(cpu.abs().max().item(), 1e-30)]

    layers, pools = [], []
    for ci, v in enumerate(net.cfg):
        if v != "M":
            layers.append("conv")
            pools.append(ci + 1 < len(net.cfg) and net.cfg[ci + 1] == "M")
    layers += ["fc"] * len(net.fc_widths)
    pools += [False] * len(net.fc_widths)
    saved = torch.backends.cudnn.benchmark
    rows, carried = [], {True: x.cuda(), False: x.cuda()}
    try:
        for i, (kind, pool) in enumerate(zip(layers, pools)):
            name = f"conv_{i}" if kind == "conv" else \
                f"fc_{i - net.n_convs}"
            w, b = params[f"{name}.weight"], params[f"{name}.bias"]
            sel = path[i]
            if kind == "fc" and i == net.n_convs:  # NHWC flatten
                x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
                carried = {k: c.permute(0, 2, 3, 1).reshape(c.shape[0], -1)
                           for k, c in carried.items()}

            def raw(xx, ww, bb, ss):
                n, out_w = ss.shape[0], ww.shape[1]
                k = ww.index_select(0, ss).reshape(n * out_w,
                                                   *ww.shape[2:])
                bias = bb.index_select(0, ss).reshape(n * out_w)
                return (F.conv2d(xx, k, bias, padding=1) if kind == "conv"
                        else F.linear(xx, k, bias))

            def module(xx, ww, bb, ss):
                return (pathnet.module_conv(xx, ww, bb, ss, pool)
                        if kind == "conv"
                        else pathnet.module_dense(xx, ww, bb, ss))

            with torch.no_grad():
                cpu_raw, cpu_out = raw(x, w, b, sel), module(x, w, b, sel)
                row = {"layer": name, "shape": list(cpu_out.shape)}
                on_card = (x.cuda(), w.cuda(), b.cuda(), sel.cuda())
                for bench in (True, False):
                    torch.backends.cudnn.benchmark = bench
                    key = "autotune_on" if bench else "autotune_off"
                    row[f"raw_{key}"] = gap(raw(*on_card), cpu_raw)
                    row[f"module_{key}"] = gap(module(*on_card), cpu_out)
                    carried[bench] = module(carried[bench], *on_card[1:])
                    row[f"carried_{key}"] = gap(carried[bench], cpu_out)
            rows.append(row)
            x = cpu_out
    finally:
        torch.backends.cudnn.benchmark = saved
    for row in rows:
        log(json.dumps({"pathnet_layer_gap": row}))
    return rows


def check_pathnet(manager, matrix) -> dict:
    """Two best paths of L layers; every module on task 1's best path
    bit-identical in task 2's model; the eval entry (ref task 1, model 2)
    on the card against the CPU; the launches, device and event ms of one
    batch-64 step of task 2's path."""
    import numpy as np

    from clsurvey_torch.engine.train import (tree_zeros_like,
                                             trainable_from_host)
    from clsurvey_torch.methods import pathnet
    from clsurvey_torch.models.convert import pathnet_params_from_jax
    from clsurvey_torch.ops import _kernels

    models = _task_models(manager)
    net = manager.method._net(manager)
    bps = [np.asarray(p) for p in models[1]["method_aux"]["best_paths"]]
    if len(bps) != 2 or any(p.ndim != 2 or p.shape[0] != net.n_layers
                            for p in bps):
        raise AssertionError(f"PathNet: best paths {bps}")
    p1, p2 = (pathnet_params_from_jax(m["params"]) for m in models)
    frozen = 0
    for name, a in p1.items():
        for mod in set(bps[0][pathnet.layer_index(name, net.n_convs)]):
            if not a[mod].equal(p2[name][mod]):
                raise AssertionError(f"PathNet: {name}[{mod}] of task 1's "
                                     f"path moved at task 2")
            frozen += 1
    log(f"PathNet: best paths {[p.tolist() for p in bps]}; task 1's "
        f"{frozen} module slices are bit-identical in task 2's model")
    pathnet_layer_gaps(manager, models[1])
    check_mask_entry(manager, models[1], matrix)

    seq = manager.dataset
    train = seq.get_task_dataset(2).train
    fns = pathnet.PathNetFns(net, seq.mean, seq.std,
                             models[1]["heads"]["class_counts"], 1,
                             torch.device("cuda"))
    tr = trainable_from_host(models[1], "cuda", True,
                             pathnet_params_from_jax)
    mom = tree_zeros_like(tr)
    keep = {k: v > 0 for k, v in pathnet.module_train_mask(
        tr["params"], bps[1], pathnet.frozen_modules(bps[:1],
                                                     net.n_layers, net.M),
        net.n_convs).items()}
    path = torch.as_tensor(bps[1], dtype=torch.long, device="cuda")
    x = torch.from_numpy(train.images[:pathnet.TRAIN_BATCH]).cuda()
    y = torch.from_numpy(train.labels[:pathnet.TRAIN_BATCH]).cuda().long()
    step = lambda: fns.train_step(tr, mom, x, y, path, keep, 1e-5)
    _kernels.reset_launches()
    step()
    torch.cuda.synchronize()
    out = {"launches_per_step": dict(_kernels.LAUNCHES)}
    out["step_device_ms"], out["step_event_ms"] = time_ms(step, iters=10,
                                                          warmup=2)
    log(json.dumps({"pathnet_step": "task 2, batch 64", **out}))
    return {"frozen_module_slices": frozen, **out}


# ---------------------------------------------------------------------------
# alexnet: AlexNet at 224 px, and the image-folder datasets
# ---------------------------------------------------------------------------

ALEX_PX, ALEX_BS, ALEX_CLASSES, ALEX_ROWS = 224, 200, 25, 4000
ALEX_SHAPE = (ALEX_BS, ALEX_PX, ALEX_PX, 3)
# NVIDIA's H100 SXM data sheet, dense: bf16 on the tensor cores; float32
# outside them (TF32 stays off for parity)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the RecogSeq-shaped tree: classes a task (3-6), and 224-px images a
# class in each dataset's train and test list. timing_mode trains the
# first 4 tasks, of 3 and 4 classes; their image counts give each of them
# 96 train, 84 val and 12 test rows (``recogseq.prepare`` keeps int(0.9 n)
# of a class's n test images for val), so cuDNN's autotuner meets one set
# of batch shapes (each new one costs it seconds at 224 px) while the
# head widths differ. The other 4 tasks are only prepared.
RECOGSEQ_CLASSES = (3, 4, 3, 4, 5, 6, 5, 6)
RECOGSEQ_IMAGES = {3: (32, 32), 4: (24, 24)}  # (train, test) a class
RECOGSEQ_UNTRAINED_IMAGES = (4, 4)


def alexnet_train_flops_per_img(n_classes: int = ALEX_CLASSES) -> float:
    """Forward + backward FLOPs of one 224-px image through AlexNet and a
    head of ``n_classes``: 2*H*W*k^2*Cin*Cout per conv and 2*in*out per
    dense layer forward, x3 for training (``bench.py:52-65``'s count)."""
    convs = [(55, 11, 3, 64), (27, 5, 64, 192), (13, 3, 192, 384),
             (13, 3, 384, 256), (13, 3, 256, 256)]
    flops = sum(2.0 * hw * hw * k * k * cin * cout
                for hw, k, cin, cout in convs)
    feat = 6 * 6 * 256
    for d in (4096, 4096, n_classes):
        flops += 2.0 * feat * d
        feat = d
    return 3.0 * flops


def check_preprocess_224(gen) -> list:
    """Kernel A at AlexNet's batch (200, 224, 224, 3), with and without a
    flip mask, in both dtypes, against its plain version (f32 <= 1 ulp,
    bf16 exact), then timed warm and on a cold L2 against its byte bound
    (each input byte read once, each output byte written once). Returns
    one row per dtype for the ``kernels`` record."""
    from clsurvey_torch.ops import preprocess as pp

    x = torch.randint(0, 256, ALEX_SHAPE, dtype=torch.uint8, device="cuda",
                      generator=gen)
    flip = torch.randint(0, 2, (ALEX_BS,), dtype=torch.uint8, device="cuda",
                         generator=gen)
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        err = 0.0
        for mask in (flip, None):
            err = max(err, _preprocess_agrees(
                pp.preprocess(x, MEAN, STD, mask, dtype),
                pp.normalize_flip_plain(x, MEAN, STD, mask, dtype), dtype,
                "alexnet 224"))
        out_bytes = x.numel() * (4 if dtype == torch.float32 else 2)
        kernel = lambda d=dtype: pp.preprocess(x, MEAN, STD, flip, d)
        row = _timings(
            {"shape": list(ALEX_SHAPE), "dtype": str(dtype),
             "path": "vec, alexnet 224", "main": False,
             "max_abs_err": err,
             "bound_ms": bound_ms(x.numel() + flip.numel() + out_bytes)},
            kernel=None,
            plain=lambda d=dtype: pp.normalize_flip_plain(x, MEAN, STD, flip,
                                                          d),
            library=None)
        row["kernel_ms"], row["kernel_event_ms"] = time_ms(kernel)
        row["cold_ms"] = cold_ms(kernel, scratch.bitwise_not_)
        log(f"kernel A [alexnet 224] {dtype} {list(ALEX_SHAPE)}: "
            f"{row['kernel_ms']:.5f} ms warm, {row['cold_ms']:.5f} ms cold "
            f"(bound {row['bound_ms']:.5f}, "
            f"{100 * row['bound_ms'] / row['cold_ms']:.0f}% of it reached "
            f"cold); plain {row['plain_ms']:.5f} ms; max |diff| {err}")
        rows.append(row)
    return rows


def _no_pool_launches(launches: dict, what: str) -> None:
    if launches["normalize_flip"] <= 0:
        raise AssertionError(f"{what}: kernel A never launched")
    if launches["pool_fwd"] or launches["pool_bwd"]:
        raise AssertionError(f"{what}: a pool kernel launched on AlexNet's "
                             f"path: {launches}")


def _first_conv_ms(dtype, gen) -> dict:
    """AlexNet's first conv (C_in 3, 11x11/4, 64 out) alone at batch 200,
    through the port's ``ops.conv.conv2d``: forward and weight gradient (a
    step computes no input gradient there), device and event ms, and its
    FLOP bound."""
    from clsurvey_torch.ops.conv import conv2d

    x = torch.randn(ALEX_BS, 3, ALEX_PX, ALEX_PX, device="cuda",
                    generator=gen).to(dtype).contiguous(
                        memory_format=torch.channels_last)
    w = (torch.randn(64, 3, 11, 11, device="cuda", generator=gen) * 0.01).to(
        dtype).contiguous(memory_format=torch.channels_last).requires_grad_()
    b = torch.zeros(64, device="cuda", dtype=dtype, requires_grad=True)

    def step():
        y = torch.relu(conv2d(x, w, b, stride=4, padding=2))
        torch.autograd.grad(y.float().sum(), (w, b))

    device_ms, event_ms = time_ms(step, iters=10, warmup=3)
    flops = 2 * 2.0 * ALEX_BS * 55 * 55 * 121 * 3 * 64  # fwd + wgrad
    return {"device_ms": device_ms, "event_ms": event_ms,
            "flop_bound_ms": flops / PEAK_FLOPS[dtype] * 1e3}


def alexnet_protocol(card: str) -> dict:
    """bench.py's AlexNet point (``bench.py:226-268``) through the port's
    Engine: 224 px, batch 200, 25 classes, lr 5e-3, flips on, 4,000 random
    uint8 rows on the card; best of three timed epochs after a warm-up, in
    bf16 and in float32, then 10 profiled steps of each, with the launch
    counters zeroed before each dtype's epochs (kernel A must launch, no
    pool kernel). Returns {run: launches}."""
    from torch.profiler import ProfilerActivity, profile

    from clsurvey_torch.engine.train import (Engine, make_context,
                                             state_from_model)
    from clsurvey_torch.methods.base import UpdateRule
    from clsurvey_torch.models.registry import ModelSpec, init_model_state
    from clsurvey_torch.ops import _kernels

    gen = torch.Generator(device="cuda").manual_seed(2)
    images = torch.randint(0, 255, (ALEX_ROWS, ALEX_PX, ALEX_PX, 3),
                           dtype=torch.uint8, device="cuda", generator=gen)
    labels = torch.randint(0, ALEX_CLASSES, (ALEX_ROWS,), device="cuda",
                           generator=gen)
    flops_img = alexnet_train_flops_per_img()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        spec = ModelSpec(name="alexnet", arch="alexnet",
                         input_size=(ALEX_PX, ALEX_PX), compute_dtype=dtype)
        model = init_model_state(spec, seed=7, max_tasks=10,
                                 classes_per_task=ALEX_CLASSES)
        rule = UpdateRule()
        ctx = make_context(spec, task=0, n_tasks=1,
                           class_counts=[ALEX_CLASSES] * 10, mean=MEAN,
                           std=STD, update_rule=rule, augment=True,
                           device="cuda")
        engine = Engine(ctx)
        state = state_from_model(model, None, ctx.device)
        state.mstate = rule.init_state(state.trainable, {}, ctx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        per_epoch = []
        for epoch in range(4):  # epoch 0 warms up cuDNN's algorithm choice
            perm = torch.randperm(ALEX_ROWS, device="cuda", generator=gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = engine.train_epoch(state, images, labels, perm,
                                                gen, 5e-3, ALEX_BS)
            loss = float(metrics["loss"])
            per_epoch.append(time.perf_counter() - t0)
            if loss != loss or abs(loss) == float("inf"):
                raise AssertionError(f"alexnet224 {tag} epoch {epoch}: "
                                     f"loss {loss}")
        launches = dict(_kernels.LAUNCHES)
        _no_pool_launches(launches, f"alexnet224 {tag}")
        out[f"alexnet224_{tag}"] = launches
        steps = ALEX_ROWS // ALEX_BS
        best = min(per_epoch[1:])
        img_s = steps * ALEX_BS / best
        peak = torch.cuda.max_memory_allocated()

        perm = torch.randperm(ALEX_ROWS, device="cuda",
                              generator=gen)[: 10 * ALEX_BS]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = engine.train_epoch(state, images, labels, perm,
                                                gen, 5e-3, ALEX_BS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        device_ms = sum(kernel_us(prof).values()) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
        conv0 = _first_conv_ms(dtype, gen)
        log(json.dumps({
            "alexnet224": f"Engine train, bs {ALEX_BS}, {ALEX_CLASSES} "
                          f"classes, {ALEX_ROWS} rows, flips on",
            "dtype": str(dtype), "img_per_s": img_s,
            "ms_per_step": best / steps * 1e3, "epoch_s": per_epoch,
            "train_gflop_per_img": flops_img / 1e9,
            "model_tflop_per_s": flops_img * img_s / 1e12,
            "mfu": flops_img * img_s / PEAK_FLOPS[dtype],
            "peak_flops": PEAK_FLOPS[dtype],
            "max_memory_allocated": peak, "launches": launches,
            "profile": {
                "steps": 10, "wall_ms": wall_ms, "device_ms": device_ms,
                "device_busy_share": device_ms / wall_ms if wall_ms else None,
                "launches_per_step": sum(e.count for e in events) / 10,
                "top": [{"name": e.key[:80],
                         "ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in top]},
            "first_conv_fwd_wgrad": {
                **conv0, "share_of_step_device_ms":
                    conv0["device_ms"] / (device_ms / 10)},
            "card": card}))
        del state, engine, ctx
    return out


def _write_jpegs(jobs) -> None:
    """Write (path, uint8 HWC array) pairs as JPEGs, 8 at a time (PIL's
    encoder releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def write(job):
        Image.fromarray(job[1]).save(job[0], quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))


def _recogseq_tree(raw: str) -> int:
    """RecogSeq's layout (``<raw>/<dataset>/{train,test}/<class>/<img>``):
    8 datasets of 3-6 classes, 224-px JPEGs: a colour per class, and per
    image a ramp of its own slope (smooth images: quick to encode, and to
    compress into the npz). Returns the number of images."""
    import numpy as np

    from clsurvey_torch.data.recogseq import TASKS

    rng = np.random.default_rng(5)
    ramp = np.linspace(0, 1, ALEX_PX, dtype=np.float32)
    jobs = []
    for task, (name, n_cls) in enumerate(zip(TASKS, RECOGSEQ_CLASSES)):
        counts = (RECOGSEQ_IMAGES[n_cls] if task < 4
                  else RECOGSEQ_UNTRAINED_IMAGES)
        for c in range(n_cls):
            base = rng.uniform(30, 190, 3).astype(np.float32)
            for split, n in zip(("train", "test"), counts):
                d = os.path.join(raw, name, split, f"class_{c}")
                os.makedirs(d)
                for j in range(n):
                    slope = rng.uniform(-60, 60, 2).astype(np.float32)
                    img = (base[None, None, :]
                           + slope[0] * ramp[:, None, None]
                           + slope[1] * ramp[None, :, None])
                    jobs.append((os.path.join(d, f"{j}.jpg"),
                                 np.clip(img, 0, 255).astype(np.uint8)))
    _write_jpegs(jobs)
    return len(jobs)


def _hold_preprocess_224(sizes) -> None:
    """Kernel A at every batch size the RecogSeq run used, at 224 px,
    against its plain version (f32 within 1 ulp)."""
    from clsurvey_torch.ops import preprocess as pp

    gen = torch.Generator(device="cuda").manual_seed(3)
    for b in sorted(sizes):
        x = torch.randint(0, 256, (b, ALEX_PX, ALEX_PX, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
        flip = torch.randint(0, 2, (b,), dtype=torch.uint8, device="cuda",
                             generator=gen)
        for mask in (flip, None):
            _preprocess_agrees(pp.preprocess(x, MEAN, STD, mask),
                               pp.normalize_flip_plain(x, MEAN, STD, mask),
                               torch.float32, f"alexnet batch {b}")


def alexnet_recogseq_cli(root: str, card: str) -> dict:
    """A RecogSeq-shaped tree prepared by the port's ``recogseq.prepare``,
    then ``alexnet`` finetuning on ``recogseq`` through the timing_mode CLI
    with ``--test`` (timing_mode trains 4 tasks, whatever
    ``--max_task_count`` says), the launch counters zeroed just before and
    read just after: kernel A must launch, no pool kernel; one eval entry
    on the card against the CPU at ``LOGITS_TOL``; A held at the run's
    batch sizes. Returns the launches."""
    from clsurvey_torch.data import recogseq
    from clsurvey_torch.framework import main as cli_main
    from clsurvey_torch.ops import _kernels
    from clsurvey_torch.utils import config, io

    os.environ["CLSURVEY_ROOT"] = root
    config.set_config(None)
    raw = os.path.join(root, "raw_recogseq")
    t0 = time.perf_counter()
    n_images = _recogseq_tree(raw)
    t1 = time.perf_counter()
    out_dir = recogseq.prepare(raw, config.load_config().ds_root_path)
    log(f"recogseq tree: {sum(RECOGSEQ_CLASSES)} classes, {n_images} "
        f"224-px images written in {t1 - t0:.2f} s, prepared in "
        f"{time.perf_counter() - t1:.2f} s -> {out_dir}")
    argv = ["alexnet", "--method_name", "finetuning", "--ds_name",
            "recogseq", "--runmode", "timing_mode", "--max_task_count", "2",
            "--test", "--device", "cuda", "--gridsearch_name", "timing_mode"]
    log("alexnet: python -m clsurvey_torch.framework.main", " ".join(argv))
    _kernels.reset_launches()
    t0 = time.perf_counter()
    manager = cli_main.cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    sizes = set(_kernels.BATCHES["normalize_flip"])
    _no_pool_launches(launches, "recogseq CLI")
    n = manager.args.max_task_count
    model = io.load(manager.best_model_path(n, create=False))
    _finite_tree(model["params"], "recogseq CLI, last best model")
    matrix = eval_matrix(manager)
    log(json.dumps({"recogseq_cli": "alexnet finetuning, timing_mode",
                    "seconds": wall, "tasks": n,
                    "class_counts": manager.dataset.class_count_list(),
                    "task_seconds": manager.extras["task_seconds"],
                    "launches": launches, "batch_sizes": sorted(sizes),
                    "eval_matrix": matrix, "card": card}))
    check_eval_entry(manager, model, matrix)
    _hold_preprocess_224(sizes)
    log(f"kernel A agrees at 224 px at the RecogSeq run's batch sizes "
        f"{sorted(sizes)}")
    return launches


def _tiny_tree(raw: str) -> None:
    """A fake ``tiny-imagenet-200``: the 200 wnids of the port's copy of
    the survey order, 5 train and 2 val 64-px JPEGs each."""
    import numpy as np

    from clsurvey_torch.data.tinyimagenet import SURVEY_ORDER_FILE

    with open(SURVEY_ORDER_FILE) as f:
        wnids = [line.strip() for line in f if line.strip()]
    with open(os.path.join(raw, "wnids.txt"), "w") as f:
        f.write("\n".join(sorted(wnids)))
    rng = np.random.default_rng(6)
    os.makedirs(os.path.join(raw, "val", "images"))
    ann, jobs = [], []
    for ci, wnid in enumerate(wnids):
        d = os.path.join(raw, "train", wnid, "images")
        os.makedirs(d)
        base = rng.uniform(30, 220, 3)
        for j in range(7):
            img = np.clip(base + rng.normal(0, 20, (64, 64, 3)), 0,
                          255).astype(np.uint8)
            if j < 5:
                jobs.append((os.path.join(d, f"{wnid}_{j}.JPEG"), img))
            else:
                fn = f"val_{ci * 2 + j - 5}.JPEG"
                jobs.append((os.path.join(raw, "val", "images", fn), img))
                ann.append(f"{fn}\t{wnid}\t0\t0\t0\t0")
    _write_jpegs(jobs)
    with open(os.path.join(raw, "val", "val_annotations.txt"), "w") as f:
        f.write("\n".join(ann))


def tiny_cli(root: str, card: str) -> tuple[dict, set]:
    """A fake tiny-imagenet-200 tree prepared by the port's
    ``tinyimagenet.prepare``, then small_VGG9_cl_128_128 finetuning on
    ``tiny`` for 2 tasks, the counters zeroed just before and read just
    after: A, B1 and B2 must launch, every pool launch on the vec route.
    Returns (launches, the batch sizes the kernels saw)."""
    from clsurvey_torch.data import tinyimagenet
    from clsurvey_torch.framework import main as cli_main
    from clsurvey_torch.ops import _kernels
    from clsurvey_torch.utils import config

    os.environ["CLSURVEY_ROOT"] = root
    config.set_config(None)
    raw = os.path.join(root, "tiny-imagenet-200")
    os.makedirs(raw)
    t0 = time.perf_counter()
    _tiny_tree(raw)
    t1 = time.perf_counter()
    out_dir = tinyimagenet.prepare(raw, config.load_config().ds_root_path)
    log(f"tiny tree: 200 wnids x 7 64-px images written in {t1 - t0:.2f} s, "
        f"prepared in {time.perf_counter() - t1:.2f} s -> {out_dir}")
    argv = ["small_VGG9_cl_128_128", "--method_name", "finetuning",
            "--ds_name", "tiny", "--max_task_count", "2", "--num_epochs",
            "2", "--batch_size", "200", "--lr_grid", "5e-3", "--device",
            "cuda"]
    log("tiny: python -m clsurvey_torch.framework.main", " ".join(argv))
    _kernels.reset_launches()
    t0 = time.perf_counter()
    manager = cli_main.cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = dict(_kernels.LAUNCHES), dict(_kernels.ROUTES)
    sizes = set().union(*_kernels.BATCHES.values())
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"tiny CLI: kernel {name} never launched")
    for name in ("pool_fwd", "pool_bwd"):
        if routes[f"{name}_vec"] != launches[name]:
            raise AssertionError(f"tiny CLI: {routes[f'{name}_scalar']} of "
                                 f"{launches[name]} {name} launches took "
                                 f"the scalar route")
    log(json.dumps({"tiny_cli": "small_VGG9_cl_128_128 finetuning, 2 tasks",
                    "seconds": wall,
                    "classes": manager.dataset.class_count_list()[:2],
                    "task_seconds": manager.extras["task_seconds"],
                    "launches": launches, "routes": routes,
                    "batch_sizes": sorted(sizes), "card": card}))
    return launches, sizes


def _gap(got, want) -> tuple[float, float]:
    """(max |diff|, largest |want|) of two tensors, on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()), float(want.abs().max())


class _Decisions:
    """Stands in for ``torch`` or ``torch.nn.functional`` inside
    ``methods/hat.py`` for one step: ``relu`` and ``max_pool2d`` record
    their decisions on ``tape`` (which entries were positive, which entry
    of each window was largest) or, with ``replay``, take them from it in
    the same order; everything else is the module's own."""

    def __init__(self, module, tape: list, replay: bool):
        self._module, self._tape, self._replay = module, tape, replay

    def __getattr__(self, name):
        return getattr(self._module, name)

    def relu(self, x):
        if self._replay:
            return x * self._tape.pop(0).to(x.device, x.dtype)
        self._tape.append((x > 0).cpu())
        return self._module.relu(x)

    def max_pool2d(self, x, kernel_size, stride):
        if self._replay:
            idx = self._tape.pop(0).to(x.device)
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        y, idx = self._module.max_pool2d(x, kernel_size, stride,
                                         return_indices=True)
        self._tape.append(idx.cpu())
        return y


# the variants' batch: their CPU side (float64 HAT steps, PathNet's 28 x 28
# first conv, AlexNet's conv features, on PyTorch's native convs) costs
# in proportion to it
VARIANT_ROWS = 8


def check_alexnet_variants(card: str) -> dict:
    """AlexNet's method variants at 224 px and full width, card against
    CPU (kernel A on the card, its plain version on the CPU; the CPU's
    convs are PyTorch's native ones, not oneDNN's, whose float32 weight
    gradients lose up to 3e-3 of their largest entry to cancellation
    against a float64 reference, ``tests/test_torch_port_alexnet.py``), on
    ``VARIANT_ROWS`` random images: a HATAlexNet step's processed gradient (task 2,
    mask_back from task 1's embeddings, the same dropout masks on both),
    with and without mask_back, each leaf within ``STEP_REL_TOL`` of the
    largest entry of the float64 gradient without mask_back: the card's
    float32 step (the CLI's dtype) against the CPU's float64 step on the
    card's ReLU and pool decisions (:class:`_Decisions`), and the card's
    float64 step against the CPU's; a PathNetAlexNet
    eval entry (M 20, N 3) within ``LOGITS_TOL``; EBLL's code term on
    AlexNet's 9,216-wide conv features within ``DISTILL_REL_TOL``. Every
    gap is logged."""
    with torch.backends.mkldnn.flags(enabled=False):
        return _alexnet_variants(card)


def _alexnet_variants(card: str) -> dict:
    """The body of :func:`check_alexnet_variants`."""
    import numpy as np

    from clsurvey_torch.methods import ebll, hat, pathnet
    from clsurvey_torch.models import convert, heads
    from clsurvey_torch.models.registry import ModelSpec, init_model_state
    from clsurvey_torch.ops import preprocess as pp
    from clsurvey_torch.utils import rng as rng_lib

    spec = ModelSpec(name="alexnet", arch="alexnet",
                     input_size=(ALEX_PX, ALEX_PX))
    rng = np.random.default_rng(8)
    b = VARIANT_ROWS
    images = torch.from_numpy(rng.integers(0, 256, (b, ALEX_PX, ALEX_PX, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 4, b)).long()
    out, t0 = {}, time.perf_counter()

    # HAT: task 2 of two, smax 800, c 2.5, s at an epoch's first step
    smax, lamb = 800.0, 2.5
    net_cpu = hat.make_hat_model(spec, 2)
    net_cpu.reset_parameters(rng_lib.generator(8, 0))
    params = {k: v.detach().clone() for k, v in net_cpu.named_parameters()}
    for name in net_cpu.emb_names:  # task 1 holds part of every layer
        params[name] = torch.from_numpy(rng.uniform(
            -0.02, 0.03, tuple(params[name].shape)).astype(np.float32))
    tree = {"params": convert.hat_params_to_jax(params),
            "heads": {"kernel": rng.normal(0, 0.01, (2, 4096, 4)).astype(
                np.float32), "bias": np.zeros((2, 4), np.float32)}}
    drop = [torch.randint(0, 2, (b, d), dtype=torch.uint8,
                          generator=rng_lib.generator(8, 1))
            for d in net_cpu.drop_dims]
    s = hat.anneal_s(smax, 0, 40)
    nets = {}

    def grads_of(dev, dtype, blocked, tape=None, replay=False):
        """The processed gradient (leaf -> float64 CPU tensor); with a
        ``tape``, ReLU and the pools record or replay their decisions."""
        if (dev, dtype) not in nets:
            net = hat.make_hat_model(spec, 2).to(dev)
            net.dtype = dtype
            p = {k: v.to(dev, dtype) for k, v in params.items()}
            mask_pre = hat.compute_mask_pre(p, net.emb_names, 1, smax)
            nets[dev, dtype] = hat.HATEngine(
                net, spec, 1, [4, 4], MEAN, STD, smax, mask_pre,
                hat.compute_mask_back(net, p, mask_pre), augment=False,
                device=dev)
        engine = nets[dev, dtype]
        mask_back = engine.mask_back
        engine.mask_back = mask_back if blocked else None
        tr = hat.hat_from_host(tree, dev, False)
        tr["params"] = {k: v.to(dtype).requires_grad_()
                        for k, v in tr["params"].items()}
        for v in tr["heads"].values():
            v.requires_grad_()
        saved = hat.torch, hat.F
        if tape is not None:
            hat.torch = _Decisions(torch, tape, replay)
            hat.F = _Decisions(torch.nn.functional, tape, replay)
        try:
            g, _ = engine.grads(tr, images.to(dev), labels.to(dev), s, lamb,
                                dropout_masks=[m.to(dev) for m in drop])
        finally:
            hat.torch, hat.F = saved
            engine.mask_back = mask_back
        return {**{k: v.double().cpu() for k, v in g["params"].items()},
                **{f"heads.{k}": v.double().cpu()
                   for k, v in g["heads"].items()}}

    # The float32 card step (the CLI's dtype) records where its ReLUs and
    # pools decided; the float64 CPU step replays those decisions, so the
    # two differ in arithmetic only, and are held to STEP_REL_TOL. A
    # near-tie that float32 and float64 break differently moves a whole
    # input patch's term from one weight gradient entry to another (about
    # 4e-3 of conv_0's largest entry at 224 px on an H100): the
    # plain float64 step's distance, and how many decisions differ, are
    # logged. The float64 card step is held to the plain float64 CPU step.
    tapes, grads = {}, {}
    for blocked in (True, False):
        tapes[blocked] = []
        grads["card32", blocked] = grads_of("cuda", torch.float32, blocked,
                                            tapes[blocked])
        grads["ref", blocked] = grads_of("cpu", torch.float64, blocked,
                                         list(tapes[blocked]), replay=True)
        own = []
        grads["cpu64", blocked] = grads_of("cpu", torch.float64, blocked,
                                           own)
        grads["card64", blocked] = grads_of("cuda", torch.float64, blocked)
    differ = [int((a != b).sum()) for a, b in zip(tapes[True], own)]
    blocked_weights = sum(int((v == 0).sum()) for v in
                          nets["cuda", torch.float32].mask_back.values())
    # each leaf against the largest entry of its float64 gradient without
    # mask_back, as the small_VGG9 HAT step check scales it
    worst = {}
    tops = {w: {k: float(v.abs().max()) for k, v in grads[w, False].items()}
            for w in ("ref", "cpu64")}
    for got_of, want_of, held in (("card32", "ref", True),
                                  ("card64", "cpu64", True),
                                  ("card32", "cpu64", False)):
        for blocked in (True, False):
            key = (f"{got_of}_vs_{want_of}_"
                   f"{'with_mask_back' if blocked else 'without'}")
            worst[key] = ("", 0.0)
            for k, want in grads[want_of, blocked].items():
                top = tops[want_of][k]
                got = grads[got_of, blocked][k]
                diff = float((got - want).abs().max())
                if top and diff / top >= worst[key][1]:
                    worst[key] = (k, diff / top)
                # one pass over the leaf: its largest gap against the
                # tolerance (NaN fails, as in assert_close)
                if held and not diff <= STEP_REL_TOL * top:
                    raise AssertionError(
                        f"HATAlexNet step, {key}: {k}: max |diff| {diff} "
                        f"> {STEP_REL_TOL} x {top}")
    out["hat_step_worst_diff_of_largest"] = worst
    out["hat_step_decisions_differing"] = differ
    log(f"HATAlexNet step (task 2, batch {b}, 224 px, {blocked_weights} "
        f"weights blocked), each leaf's worst gap over its largest float64 "
        f"entry without mask_back (held: card32 vs ref, the float64 CPU "
        f"step on the card's ReLU and pool decisions, and card64 vs cpu64; "
        f"tolerance {STEP_REL_TOL:g}): " + ", ".join(
            f"{key} {leaf} {r:.3g}" for key, (leaf, r) in worst.items())
        + f"; ReLU / pool decisions of the plain float64 CPU step that "
        f"differ from the float32 card's, in forward order: {differ}")

    parts = {"hat_s": time.perf_counter() - t0}
    t0 = time.perf_counter()

    # PathNet: M 20 modules a layer, a path of 3, one eval batch
    net_cpu = pathnet.PathNetAlexNet(ALEX_PX, 20)
    net_cpu.reset_parameters(rng_lib.generator(8, 2))
    p_cpu = {k: v.detach() for k, v in net_cpu.named_parameters()}
    bank = {"kernel": torch.from_numpy(rng.normal(
        0, 0.05, (2, net_cpu.feature_dim, 4)).astype(np.float32)),
        "bias": torch.zeros(2, 4)}
    path = torch.from_numpy(rng.integers(0, 20, (5, 3))).long()
    logits = {}
    for dev in ("cpu", "cuda"):
        net = net_cpu if dev == "cpu" else pathnet.PathNetAlexNet(
            ALEX_PX, 20).to(dev)
        with torch.no_grad():
            x = pp.preprocess(images.to(dev), MEAN, STD)
            feats = torch.func.functional_call(
                net, {k: v.to(dev) for k, v in p_cpu.items()},
                (x, path.to(dev)))
            logits[dev] = heads.forward(
                {**{k: v.to(dev) for k, v in bank.items()},
                 "class_counts": np.asarray([4, 4])}, feats, 0).cpu()
    diff, top = _gap(logits["cuda"], logits["cpu"])
    out["pathnet_logits_gap"] = [diff, top]
    log(f"PathNetAlexNet eval entry ({b} images, 224 px, M 20, N 3, kernels "
        f"{net_cpu.ksizes}): card vs CPU logits max |diff| {diff:.3g} "
        f"(largest {top:.3g}; tolerance {LOGITS_TOL:g} abs + rel)")
    torch.testing.assert_close(logits["cuda"], logits["cpu"],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)

    parts["pathnet_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # EBLL: the code term of one autoencoder (9,216 -> 100) between the
    # model's conv features and a teacher's
    model = init_model_state(spec, seed=9, max_tasks=2, classes_per_task=4)
    teacher = {layer: {leaf: (v + rng.normal(
        0, 0.05 * float(np.abs(v).max()) + 1e-4, v.shape)).astype(np.float32)
        for leaf, v in leaves.items()}
        for layer, leaves in model["params"].items()}
    ae = ebll.init_autoencoder(rng_lib.generator(9, 1), 9216, 100)
    terms, feats = {}, {}
    for dev in ("cpu", "cuda"):
        backbone = spec.make_backbone().to(dev)
        with torch.no_grad():
            x = pp.preprocess(images.to(dev), MEAN, STD)
            cur = ebll.conv_feats(backbone, convert.params_from_jax(
                model["params"], dev), x)
            frz = ebll.conv_feats(backbone, convert.params_from_jax(
                teacher, dev), x)
            a = ebll.autoencoder_on(ae, dev)
            terms[dev] = float(torch.nn.functional.mse_loss(
                ebll.encode(a, cur), ebll.encode(a, frz)))
            feats[dev] = cur.cpu()
    fdiff, ftop = _gap(feats["cuda"], feats["cpu"])
    out["ebll_code_term"] = terms
    out["ebll_conv_feats_gap"] = [fdiff, ftop]
    log(f"EBLL code term on AlexNet conv features ({b} x 9216): card vs CPU "
        f"{terms['cuda']:.7g} vs {terms['cpu']:.7g} (tolerance "
        f"{DISTILL_REL_TOL:g} relative); conv features max |diff| "
        f"{fdiff:.3g} of {ftop:.3g}")
    if not terms["cpu"] > 0 or abs(terms["cuda"] - terms["cpu"]) > \
            DISTILL_REL_TOL * terms["cpu"]:
        raise AssertionError("EBLL's code term on AlexNet differs on the "
                             "card from the CPU's")
    parts["ebll_s"] = time.perf_counter() - t0
    log(json.dumps({"alexnet_variants": "224 px, card vs CPU", **out,
                    "parts_s": parts, "card": card}))
    return out


CONV_REL_TOL = 1e-4  # card float32 conv against float64, of its largest


def check_conv_precision(card: str) -> dict:
    """The port's float32 convs (``ops/conv.py``: cuDNN's forward and input
    gradient, the weight gradient a cuBLAS GEMM; TF32 off): forward, input
    and weight gradient of AlexNet's and small_VGG9's convs at batch 200,
    and each sample's input and weight gradient through MAS's ``vmap(grad)``
    over ``MAS_CHUNK`` samples of one row, against float64 on the card
    (``utils/conv_precision.py``), each within ``CONV_REL_TOL`` of the
    largest float64 entry (a sample's own, per sample). cuDNN's per-sample
    route is logged beside the port's, not held (``python -m
    clsurvey_torch.utils.conv_precision`` measures cuDNN's batch-200 route
    too)."""
    from clsurvey_torch.utils import conv_precision

    convs = conv_precision.measure(("port",))
    log(json.dumps({"conv_precision": "float32 vs float64, batch 200",
                    **convs, "card": card}))
    per_sample = conv_precision.measure_per_sample(("port", "cudnn"),
                                                   chunk=MAS_CHUNK)
    log(json.dumps({"conv_precision": f"float32 vs float64, per sample, "
                                      f"vmap(grad) over {MAS_CHUNK}",
                    **per_sample, "card": card}))
    for what, rows in (("", convs["port"]),
                       (" per sample", per_sample["port"])):
        for name, row in rows.items():
            for part, rel in row.items():
                if not rel <= CONV_REL_TOL:
                    raise AssertionError(
                        f"{name} {part}{what}: the port's float32 conv on "
                        f"the card is {rel:.3g} of its largest entry off "
                        f"float64 (tolerance {CONV_REL_TOL:g})")
    return {"batch": convs, "per_sample": per_sample}


def phase_alexnet(card: str) -> dict:
    """AlexNet at 224 px and the image-folder datasets: kernel A held and
    timed at (200, 224, 224, 3); the port's float32 convs against float64;
    the AlexNet Engine point in bf16 and float32; the RecogSeq and
    Tiny-ImageNet CLI runs from trees prepared by the port; the HAT,
    PathNet and EBLL variants card against CPU.
    Returns {"rows": A's rows, "launches": {run: launches}, "sizes": the
    batch sizes the tiny run's kernels saw}."""
    parts, t0 = {}, time.perf_counter()

    def done(part):
        nonlocal t0
        torch.cuda.synchronize()
        parts[part], t0 = time.perf_counter() - t0, time.perf_counter()

    rows = check_preprocess_224(torch.Generator(device="cuda").manual_seed(4))
    done("kernel_a")
    check_conv_precision(card)
    done("conv_precision")
    launches = alexnet_protocol(card)
    done("alexnet224")
    with tempfile.TemporaryDirectory() as root:
        launches["recogseq_cli"] = alexnet_recogseq_cli(root, card)
    done("recogseq_cli")
    with tempfile.TemporaryDirectory() as root:
        launches["tiny_cli"], sizes = tiny_cli(root, card)
    done("tiny_cli")
    check_alexnet_variants(card)
    done("variants")
    log(json.dumps({"alexnet_parts_s": parts, "card": card}))
    return {"rows": rows, "launches": launches, "sizes": sizes}


# ---------------------------------------------------------------------------
# streaming: splits above the device data budget
# ---------------------------------------------------------------------------

# an iNaturalist-sized task at 224 px: 21,000 rows are 3,013 MiB, above
# the default 2,048 MiB budget, so they stream in chunks of half of it
# (7,133 rows, 7,000 in whole batches): three chunks an epoch, no padding
STREAM_ROWS = 21000
# the stream-cli run's budget: 8,000 train rows at 64 px (94 MiB) stream in
# 600-row chunks, the 2,000-row val and test splits in 682-row ones
STREAM_CLI_BUDGET_MB = 16
# the importance passes, streamed against resident: 700 of task 1's train
# rows (8.2 MiB) at an 8 MiB budget stream in chunks of 200 (EWC) and 336
# (MAS) rows
STREAM_IMPORTANCE = (700, 8)
WEIGHT_REL_TOL = 1e-5  # streamed vs resident epoch, of a leaf's largest
# a stream224 leg's timed epochs after its warm-up epoch: bf16's, host-bound
# in part, vary more from epoch to epoch than fp32's (within 1%)
STREAM_TIMED_EPOCHS = {"bf16": 3, "fp32": 2}


def _host_state(state):
    """The train state's trainable and momentum leaves, copied to the
    host: the start of both legs' epochs."""
    from clsurvey_torch.engine.train import tree_map

    return {"trainable": tree_map(lambda t: t.detach().cpu().clone(),
                                  state.trainable),
            "momentum": tree_map(lambda t: t.detach().cpu().clone(),
                                 state.momentum),
            "batch_stats": state.batch_stats, "mstate": state.mstate}


def _device_state(host):
    from clsurvey_torch.engine.train import TrainState, tree_map

    trainable = tree_map(lambda t: t.cuda().requires_grad_(),
                         host["trainable"])
    return TrainState(trainable, host["batch_stats"],
                      tree_map(lambda t: t.cuda(), host["momentum"]),
                      host["mstate"])


def _peaks() -> dict:
    """Peak device memory since the last reset: ``allocated`` (what
    ``max_memory_allocated`` reads: blocks, each of which may carry up to
    1 MiB the caching allocator did not split off) and ``requested`` (the
    bytes the program asked for)."""
    stats = torch.cuda.memory_stats()
    return {"allocated": stats["allocated_bytes.all.peak"],
            "requested": stats["requested_bytes.all.peak"]}


def _profiled_epoch(run) -> dict:
    """One epoch under the profiler: wall ms, kernel ms (copies left
    out), the share of the wall the card spent in kernels, and the
    host-to-device copies' ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    us = kernel_us(prof)
    kernel_ms = sum(v for k, v in us.items()
                    if not k.startswith(("Memcpy", "Memset"))) / 1e3
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "device_busy_share": kernel_ms / wall_ms,
            "h2d_ms": sum(v for k, v in us.items()
                          if k.startswith("Memcpy HtoD")) / 1e3}


def _timed_epochs(epoch, start, n: int):
    """``n`` epochs, ``epoch(state, e)`` for e = 1, 2, ..., n, from the host
    state ``start`` put on the card, with the peak memory counters reset
    after it. As in a task, only an epoch's input state and the state it
    builds are alive. Returns each epoch's seconds, the trainable leaves on
    the host after the first, and the bytes allocated at the start."""
    from clsurvey_torch.engine.train import tree_leaves

    state = _device_state(start)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    seconds, first = [], None
    for e in range(1, n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = epoch(state, e)
        loss = float(metrics["loss"])
        seconds.append(time.perf_counter() - t0)
        if loss != loss or abs(loss) == float("inf"):
            raise AssertionError(f"epoch {e}: loss {loss}")
        if first is None:
            first = [t.detach().cpu() for t in tree_leaves(state.trainable)]
    return seconds, first, start_bytes


def _leaf_gap(got, want) -> float:
    """The largest gap of two lists of leaves, each leaf's over its
    largest entry in ``want``."""
    return max(float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
               for a, b in zip(got, want))


def _cudnn_deterministic_leaves(run) -> list:
    """The trainable leaves on the host after ``run()``, which returns a
    (state, metrics) pair, with cuDNN's deterministic algorithms; the flag
    is restored after."""
    from clsurvey_torch.engine.train import tree_leaves

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state, _ = run()
        return [t.detach().cpu() for t in tree_leaves(state.trainable)]
    finally:
        torch.backends.cudnn.deterministic = saved


def stream224(card: str) -> dict:
    """bench.py's AlexNet point (224 px, batch 200, 25 classes, lr 5e-3,
    flips on) through the port's Engine on ``STREAM_ROWS`` random uint8
    rows on the host, streamed at the default data budget, in bf16 and in
    float32, on cuDNN's default algorithms: one streamed warm-up epoch,
    then ``STREAM_TIMED_EPOCHS`` timed epochs streamed and as many resident
    (the whole split on the card), both legs from the same start with the
    same permutations and generator seeds, and two streamed chunks
    profiled (alexnet224 profiles the resident leg). Checks the two legs'
    weights after the first timed epoch (bf16: ``WEIGHT_REL_TOL`` of each
    leaf's largest entry); in float32, whose default cuDNN algorithms differ
    run to run, the same check on one more, untimed epoch of each leg with
    cuDNN's deterministic algorithms; the peak memory requested (streamed
    below resident by the split less two chunks); that every gather took
    the native route; and that A launched at (200, 224, 224, 3) and no pool
    kernel. Prints each leg's epoch seconds, img/s and ms a step of its
    best epoch, the overlap share (best against best, and median against
    median), the streamed leg's busy share, the gather and H2D rates of one
    chunk. Returns {run: launches}."""
    import numpy as np

    from clsurvey_torch.engine.train import (
        ChunkFeed, Engine, chunk_plan, data_budget_bytes, make_context,
        place, state_from_model, stream_chunk_rows)
    from clsurvey_torch.methods.base import UpdateRule
    from clsurvey_torch.models.registry import ModelSpec, init_model_state
    from clsurvey_torch.ops import _kernels
    from clsurvey_torch.utils import rowgather

    os.environ.pop("CLSURVEY_DATA_BUDGET_MB", None)  # the default budget
    gen = torch.Generator(device="cuda").manual_seed(5)
    t0 = time.perf_counter()
    images = np.empty((STREAM_ROWS, ALEX_PX, ALEX_PX, 3), np.uint8)
    for lo in range(0, STREAM_ROWS, 3000):
        n = min(3000, STREAM_ROWS - lo)
        images[lo: lo + n] = torch.randint(
            0, 255, (n, ALEX_PX, ALEX_PX, 3), dtype=torch.uint8,
            device="cuda", generator=gen).cpu().numpy()
    labels = np.random.default_rng(5).integers(
        0, ALEX_CLASSES, STREAM_ROWS).astype(np.int32)
    make_s = time.perf_counter() - t0
    budget = data_budget_bytes()
    row_bytes = images.nbytes // STREAM_ROWS
    chunk_rows = stream_chunk_rows(row_bytes)
    bs, rows = chunk_plan(STREAM_ROWS, ALEX_BS, chunk_rows)
    if not images.nbytes > budget or (bs, rows) != (ALEX_BS, 7000):
        raise AssertionError(f"stream224: {images.nbytes} bytes against a "
                             f"{budget}-byte budget, chunks {rows}")
    n_chunks = -(-STREAM_ROWS // rows)
    steps = n_chunks * rows // bs
    perms = [np.random.default_rng(10 + e).permutation(STREAM_ROWS)
             for e in range(max(STREAM_TIMED_EPOCHS.values()) + 1)]
    seed = lambda e: torch.Generator(device="cuda").manual_seed(20 + e)
    out, records = {}, []
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        spec = ModelSpec(name="alexnet", arch="alexnet",
                         input_size=(ALEX_PX, ALEX_PX), compute_dtype=dtype)
        model = init_model_state(spec, seed=7, max_tasks=10,
                                 classes_per_task=ALEX_CLASSES)
        rule = UpdateRule()
        ctx = make_context(spec, task=0, n_tasks=1,
                           class_counts=[ALEX_CLASSES] * 10, mean=MEAN,
                           std=STD, update_rule=rule, augment=True,
                           device="cuda")
        engine = Engine(ctx)
        state = state_from_model(model, None, ctx.device)
        state.mstate = rule.init_state(state.trainable, {}, ctx)
        streamed = lambda st, e: engine.train_epoch_chunked(
            st, images, labels, perms[e], seed(e), 5e-3, ALEX_BS,
            chunk_rows, feed)
        # streamed leg: the feed's buffers made once, as train_task does
        parts, t0 = {}, time.perf_counter()

        def done(part):
            nonlocal t0
            torch.cuda.synchronize()
            parts[part], t0 = time.perf_counter() - t0, time.perf_counter()

        feed = ChunkFeed(images.shape[1:], rows, "cuda")
        done("feed_alloc")
        _kernels.reset_launches()
        rowgather.reset_routes()
        state, _ = streamed(state, 0)  # warm-up epoch
        start = _host_state(state)
        del state
        gc.collect()  # earlier runs' states in reference cycles
        done("warmup_epoch")
        memory = {"streamed_free": torch.cuda.memory_allocated()}
        timed = STREAM_TIMED_EPOCHS[tag]
        streamed_s, got, memory["streamed_start"] = _timed_epochs(
            streamed, start, timed)
        peak_streamed = _peaks()
        done("streamed_epochs")
        launches = dict(_kernels.LAUNCHES)
        routes = dict(rowgather.ROUTES)
        _no_pool_launches(launches, f"stream224 {tag}")
        if _kernels.BATCHES["normalize_flip"] != {ALEX_BS}:
            raise AssertionError(f"stream224 {tag}: A at batch sizes "
                                 f"{_kernels.BATCHES['normalize_flip']}")
        if routes["numpy"] or routes["native"] != (1 + timed) * n_chunks:
            raise AssertionError(f"stream224 {tag}: gather routes {routes}")
        out[f"stream224_{tag}"] = launches
        # two chunks (70 steps) under the profiler: one chunk boundary
        st = _device_state(start)
        prof_streamed = _profiled_epoch(lambda: engine.train_epoch_chunked(
            st, images, labels, perms[0][: 2 * rows], seed(0), 5e-3,
            ALEX_BS, chunk_rows, feed))
        done("streamed_profile")
        # one chunk alone: the native gather into the pinned buffer, and
        # its copy to the card
        t0 = time.perf_counter()
        rowgather.gather_rows(images, perms[1][:rows], out=feed.host[0])
        gather_s = time.perf_counter() - t0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        feed.dev[0].copy_(feed.host[0], non_blocking=True)
        ev[1].record()
        torch.cuda.synchronize()
        h2d_ms = ev[0].elapsed_time(ev[1])
        chunk_bytes = feed.host[0].numel()
        done("one_chunk")
        if dtype == torch.float32:
            det_streamed = _cudnn_deterministic_leaves(
                lambda: streamed(_device_state(start), 1))
            done("deterministic_streamed_epoch")
        del st, feed
        gc.collect()

        # resident leg: the whole split on the card
        memory["resident_free"] = torch.cuda.memory_allocated()
        dev_images = place(images, "cuda")
        dev_labels = place(labels, "cuda").long()
        resident = lambda sr, e: engine.train_epoch(
            sr, dev_images, dev_labels, torch.from_numpy(perms[e]).cuda(),
            seed(e), 5e-3, ALEX_BS)
        done("place_split")
        resident_s, want, memory["resident_start"] = _timed_epochs(
            resident, start, timed)
        peak_resident = _peaks()
        done("resident_epochs")
        gaps = {"weight_gap_max_rel": _leaf_gap(got, want)}
        if dtype == torch.float32:
            gaps["weight_gap_deterministic_max_rel"] = _leaf_gap(
                det_streamed, _cudnn_deterministic_leaves(
                    lambda: resident(_device_state(start), 1)))
            done("deterministic_resident_epoch")
        del dev_images, dev_labels, engine, ctx
        best_s, best_r = min(streamed_s), min(resident_s)
        record = {
            "stream224": f"Engine train, bs {ALEX_BS}, {ALEX_CLASSES} "
                         f"classes, {STREAM_ROWS} host rows "
                         f"({images.nbytes} bytes), {rows}-row chunks, "
                         f"flips on, cuDNN's default algorithms",
            "dtype": str(dtype), "steps": steps,
            "streamed_epoch_s": streamed_s, "resident_epoch_s": resident_s,
            "streamed_img_per_s": steps * bs / best_s,
            "resident_img_per_s": steps * bs / best_r,
            "streamed_ms_per_step": best_s / steps * 1e3,
            "resident_ms_per_step": best_r / steps * 1e3,
            "overlap_share": best_r / best_s,
            "overlap_share_median": float(np.median(resident_s)
                                          / np.median(streamed_s)),
            "streamed_profile": prof_streamed,
            "gather_gb_per_s": chunk_bytes / gather_s / 1e9,
            "h2d_gb_per_s": chunk_bytes / h2d_ms / 1e6,
            "chunk_bytes": chunk_bytes, "parts_s": parts,
            "peak_streamed": peak_streamed,
            "peak_resident": peak_resident, "memory_allocated": memory,
            **gaps, "launches": launches,
            "gather_routes": routes, "host_split_make_s": make_s,
            "card": card}
        log(json.dumps(record))
        records.append(record)
    for record in records:
        tag = record["dtype"]
        gap = record.get("weight_gap_deterministic_max_rel",
                         record["weight_gap_max_rel"])
        if not gap <= WEIGHT_REL_TOL:
            raise AssertionError(f"stream224 {tag}: the streamed epoch's "
                                 f"weights are {gap} off the resident one's")
        need = images.nbytes - 2 * record["chunk_bytes"]
        below = record["peak_resident"]["requested"] \
            - record["peak_streamed"]["requested"]
        if not below >= need:
            raise AssertionError(
                f"stream224 {tag}: peak {record['peak_streamed']} streamed "
                f"against {record['peak_resident']} resident, {below} "
                f"bytes below, not {need}")
    return out


class _Tee(io.TextIOBase):
    """Standard output that is also kept."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def stream_cli(root: str, card: str) -> tuple[dict, set]:
    """finetuning small_VGG9_cl_128_128 on ``FRAMEWORK_DS`` (two tasks)
    through the timing_mode CLI with ``--test --profile`` at a
    ``STREAM_CLI_BUDGET_MB`` budget, so that train, val and test stream,
    the counters zeroed just before and read just after: the streaming
    line, A, B1 and B2 launched (every pool launch on the vec route), every
    gather native, chunked evals, the best models and result dicts, and a
    trace of the first task that names A's device kernel. Then EWC's
    Fisher and MAS's omega on ``STREAM_IMPORTANCE`` rows, streamed against
    resident. Returns (launches, the batch sizes the kernels saw)."""
    import contextlib

    from clsurvey_torch.engine import train as train_lib
    from clsurvey_torch.framework import main as cli_main
    from clsurvey_torch.methods import common
    from clsurvey_torch.methods.base import UpdateRule
    from clsurvey_torch.models.convert import params_from_jax
    from clsurvey_torch.ops import _kernels, importance
    from clsurvey_torch.utils import config, io as io_lib, rowgather

    os.environ["CLSURVEY_ROOT"] = root
    config.set_config(None)
    argv = [FRAMEWORK_MODEL, "--method_name", "finetuning", "--ds_name",
            FRAMEWORK_DS, "--runmode", "timing_mode", "--gridsearch_name",
            "timing_mode", "--test", "--profile", "--device", "cuda"]
    log(f"stream-cli: CLSURVEY_DATA_BUDGET_MB={STREAM_CLI_BUDGET_MB} python "
        f"-m clsurvey_torch.framework.main", " ".join(argv))
    chunked = {"evaluate_chunked": 0, "_accumulate_chunked": 0}
    spies = [(train_lib.Engine, "evaluate_chunked"),
             (importance, "_accumulate_chunked")]
    originals = [getattr(owner, name) for owner, name in spies]

    def spy(name, fn):
        def counted(*args, **kwargs):
            chunked[name] += 1
            return fn(*args, **kwargs)
        return counted

    tee = _Tee(sys.stdout)
    os.environ["CLSURVEY_DATA_BUDGET_MB"] = str(STREAM_CLI_BUDGET_MB)
    try:
        for (owner, name), fn in zip(spies, originals):
            setattr(owner, name, spy(name, fn))
        _kernels.reset_launches()
        rowgather.reset_routes()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            manager = cli_main.cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = dict(_kernels.LAUNCHES), dict(_kernels.ROUTES)
        gathers = dict(rowgather.ROUTES)
        sizes = set().union(*_kernels.BATCHES.values())
        evals = chunked["evaluate_chunked"]
        text = "".join(tee.parts)
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(f"stream-cli: kernel {name} never "
                                     f"launched")
        for name in ("pool_fwd", "pool_bwd"):
            if routes[f"{name}_vec"] != launches[name]:
                raise AssertionError(f"stream-cli: {name} launches off the "
                                     f"vec route: {routes}")
        if "streaming train split (" not in text:
            raise AssertionError("stream-cli: no streaming line in the log")
        # a val eval an epoch, then the test matrix's 3 entries
        epochs = len(re.findall(r"epoch \d+: loss=", text))
        if gathers["numpy"] or not gathers["native"] or \
                evals < epochs + 3:
            raise AssertionError(f"stream-cli: gathers {gathers}, "
                                 f"{evals} chunked evals, {epochs} epochs")
        models = [io_lib.load(manager.best_model_path(t, create=False))
                  for t in (1, 2)]
        for model in models:
            _finite_tree(model["params"], "stream-cli best model")
        matrix = eval_matrix(manager)
        trace_dir = os.path.join(config.load_config().tr_results_root_path,
                                 "profile", f"{FRAMEWORK_DS}_finetuning")
        traces = [f for f in os.listdir(trace_dir)
                  if f.endswith(".pt.trace.json")]
        trace_bytes = 0
        for fn in traces:
            trace_bytes += os.path.getsize(os.path.join(trace_dir, fn))
            with open(os.path.join(trace_dir, fn)) as f:
                named = "normalize_flip_vec_kernel" in f.read()
        if len(traces) != 1 or not named:
            raise AssertionError(f"stream-cli: traces {traces} in "
                                 f"{trace_dir}, A's kernel not named")

        # the importance passes on part of task 1's train split, streamed
        # (a smaller budget) against resident, on the card
        n_rows, budget_mb = STREAM_IMPORTANCE
        train = manager.dataset.get_task_dataset(1).train
        images, labels = train.images[:n_rows], train.labels[:n_rows]
        ctx = common.build_engine(manager, UpdateRule(), 1,
                                  augment=False).ctx
        params = params_from_jax(models[0]["params"], ctx.device)
        heads = models[0]["heads"]
        passes = {
            "ewc_fisher": lambda: importance.ewc_fisher(
                ctx, params, {}, heads, 0, images, labels, 200),
            "mas_importance": lambda: importance.mas_importance(
                ctx, params, {}, heads, 0, images, chunk=MAS_CHUNK)}
        gaps = {}
        for name, run in passes.items():
            os.environ["CLSURVEY_DATA_BUDGET_MB"] = str(budget_mb)
            before = chunked["_accumulate_chunked"]
            got = run()
            if chunked["_accumulate_chunked"] != before + 1:
                raise AssertionError(f"{name} did not stream")
            os.environ.pop("CLSURVEY_DATA_BUDGET_MB")
            want = run()
            gaps[name] = max(
                float((got[k] - v).abs().max() / max(float(v.abs().max()),
                                                      1e-30))
                for k, v in want.items())
            if not gaps[name] <= WEIGHT_REL_TOL:
                raise AssertionError(f"{name}: streamed {gaps[name]:.3g} of "
                                     f"a leaf's largest entry off resident")
    finally:
        for (owner, name), fn in zip(spies, originals):
            setattr(owner, name, fn)
        os.environ.pop("CLSURVEY_DATA_BUDGET_MB", None)
    log(json.dumps({"stream_cli": f"finetuning, timing_mode, 2 tasks, "
                                  f"{STREAM_CLI_BUDGET_MB} MiB budget, "
                                  f"--test --profile",
                    "seconds": wall,
                    "task_seconds": manager.extras["task_seconds"],
                    "launches": launches, "pool_routes": routes,
                    "gather_routes": gathers, "chunked_evals": evals,
                    "batch_sizes": sorted(sizes), "eval_matrix": matrix,
                    "trace_bytes": trace_bytes,
                    "importance_streamed_vs_resident_max_rel": gaps,
                    "card": card}))
    return launches, sizes


def phase_streaming(card: str) -> dict:
    """Splits above the device data budget: ``stream224`` (AlexNet at 224
    px through the Engine, streamed against resident) and ``stream_cli``
    (the timing_mode CLI streaming every split, with ``--profile``; the
    importance passes streamed). Returns {"launches": {run: launches},
    "sizes": the batch sizes stream-cli's kernels saw}."""
    parts, t0 = {}, time.perf_counter()
    launches = stream224(card)
    parts["stream224"], t0 = time.perf_counter() - t0, time.perf_counter()
    _hold_preprocess_224([ALEX_BS])
    with tempfile.TemporaryDirectory() as root:
        launches["stream_cli"], sizes = stream_cli(root, card)
    parts["stream_cli"] = time.perf_counter() - t0
    log(json.dumps({"streaming_parts_s": parts, "card": card}))
    return {"launches": launches, "sizes": sizes}


# ---------------------------------------------------------------------------
# dp: data parallel over torch.distributed (clsurvey_torch/parallel/)
# ---------------------------------------------------------------------------

# the world-1 group against no group, of each leaf's largest entry: only
# the sum / global-count scaling and a one-rank all-reduce differ
DP_GROUP_REL_TOL = 1e-6
# dp-2 against dp-1 after the compared epoch (40 steps), of each tree's
# largest entry: the CPU test reads 2.6e-5 after one 4-step epoch from the
# order of float32 sums alone (tests/test_torch_port_dp.py); 40 steps on
# cuDNN's per-shape deterministic algorithms (batch 100 against 200) add
# that error once a step
DP_RANKS_REL_TOL = 1e-3
# small_VGG9_BN's compared steps (``dp_bench.BN_COMPARED_STEPS``), of each
# tree's largest entry, both for the world-1 group (batch-norm on summed
# moments, ``models/backbones.py:_bn_global``) against no group
# (``F.batch_norm``) and for dp-2 against the world-1 group: batch-norm's
# backward subtracts the batch means of the incoming gradient, a
# cancellation that turns float32 rounding into about 1e-4 of a weight
# gradient (an H100 read 9.4e-5 and 1.3e-4 after 5 steps, 1.1e-3 and
# 1.4e-3 after 40), where the model without batch-norm reads 1.8e-5
# after 40
DP_BN_REL_TOL = 1e-3
# 100 train rows a class: 10 steps an epoch, 100 a task, so that the two
# ranks' collectives (four a batch-norm layer a step, through the host)
# stay inside the phase's budget
DP_CLI_DS = "synthetic_2t_20c_64px_100n"
DP_CLI_ARGV = ["small_VGG9_cl_128_128_BN", "--method_name", "finetuning",
               "--ds_name", DP_CLI_DS, "--runmode", "timing_mode",
               "--test", "--device", "cuda"]
# the two-rank CLI against the one-process CLI after 10 epochs a task:
# eval entries in accuracy points, the best models' batch-norm statistics
# of each model's largest one. The two runs take different float32 sums
# from the first step on, and the steps carry the trajectories apart (an
# H100 read 0.15-0.5 points and 1.7e-2 to 3.6e-2 after 800 steps at 400
# rows a class): these bound that drift, not the rounding of one step,
# which dp-bench and the CPU tests hold
DP_CLI_ACC_TOL = 2.0
DP_CLI_STATS_REL_TOL = 5e-2
DP_TIMEOUT_S = 600


def _repo_env(**extra) -> dict:
    """This process's environment, the checkout on ``PYTHONPATH``, no
    torchrun variables of its own."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    env.update(extra)
    return env


def _run_procs(cmds, logs, envs, what: str) -> None:
    """Start every command with its environment and log, wait for all
    under one wall-clock limit; any nonzero exit or timeout fails ``what``
    with the log's tail. Every process started is stopped."""
    procs = []
    try:
        for cmd, path, env in zip(cmds, logs, envs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    cmd, env=env, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DP_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, path in zip(procs, logs):
        if p.returncode != 0:
            with open(path) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"{what}: {' '.join(p.args)} exited "
                                 f"{p.returncode}\n{tail}")


def _tree_gap(got, want, per_leaf: bool) -> float:
    """max |got - want| over a nested dict of arrays, over each leaf's
    largest entry (``per_leaf``) or the tree's."""
    import numpy as np

    pairs = list(zip(_leaves(got), _leaves(want)))
    scale = max(float(np.abs(np.asarray(w)).max()) for _, w in pairs)
    gap = 0.0
    for g, w in pairs:
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        d = float(np.abs(g - w).max())
        gap = max(gap, d / max(float(np.abs(w).max()) if per_leaf
                               else scale, 1e-30))
    return gap


def _launched_all(launches: dict, what: str) -> None:
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{what}: kernel {name} never launched")


def dp_bench(card: str, tmp: str) -> dict:
    """``clsurvey_torch.parallel.dp_bench``: no group and a world-1 NCCL
    group interleaved in one process, then two ranks sharing the card over
    gloo, each rank started here with its own environment and log."""
    import pickle

    from clsurvey_torch.parallel.dp_bench import free_port

    module = "clsurvey_torch.parallel.dp_bench"
    single = os.path.join(tmp, "bench_single.pkl")
    t0 = time.perf_counter()
    _run_procs([[sys.executable, "-m", module, single, "single"]],
               [os.path.join(tmp, "bench_single.log")], [_repo_env()],
               "dp-bench single")
    t1 = time.perf_counter()
    ranks = os.path.join(tmp, "bench_ranks.pkl")
    port = str(free_port())
    _run_procs([[sys.executable, "-m", module, ranks, "ranks"]
                for _ in range(2)],
               [os.path.join(tmp, f"bench_rank{r}.log") for r in range(2)],
               [_repo_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                          LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=port) for r in range(2)],
               "dp-bench ranks")
    parts = {"single_s": t1 - t0, "ranks_s": time.perf_counter() - t1}
    with open(single, "rb") as f:
        one = pickle.load(f)
    reps = []
    for r in range(2):
        with open(f"{ranks}.r{r}", "rb") as f:
            reps.append(pickle.load(f))
    def gap(got, want):
        return max(_tree_gap(got[k], want[k], per_leaf=False)
                   for k in want if want[k])

    base = one["compared"]["nogroup"]
    group_gap = _tree_gap(one["compared"]["group"]["trainable"],
                          base["trainable"], per_leaf=True)
    group_gap = max(group_gap, _tree_gap(
        one["compared"]["group"]["momentum"], base["momentum"],
        per_leaf=True))
    rank_gap = gap(reps[0]["compared"]["dp"], base)
    bn_formula_gap = gap(one["compared"]["group_bn"],
                         one["compared"]["nogroup_bn"])
    bn_rank_gap = gap(reps[0]["compared"]["dp_bn"],
                      one["compared"]["group_bn"])
    launches = {"nogroup": one["legs"]["nogroup"]["launches"],
                "group": one["legs"]["group"]["launches"]}
    for r, rep in enumerate(reps):
        launches[f"dp2_rank{r}"] = rep["legs"]["dp"]["launches"]
    for leg, counts in launches.items():
        _launched_all(counts, f"dp-bench {leg}")
    sizes = {b for rep in reps for b in rep["legs"]["dp"]["batches"]}
    legs = {name: {k: leg[k] for k in (
        "ms_per_step", "img_per_s", "epoch_s", "launches_per_step",
        "device_launches_per_step")} for name, leg in one["legs"].items()}
    log(json.dumps({
        "dp_bench": "small_VGG9_cl_128_128 64px bs200 fp32 flips, "
                    f"{one['rows']} rows", "card": card,
        "nogroup": legs["nogroup"], "world1_nccl": legs["group"],
        "group_overhead_ms_per_step": legs["group"]["ms_per_step"]
        - legs["nogroup"]["ms_per_step"],
        "two_ranks_sharing_one_card_gloo": {
            f"rank{r}": {k: rep["legs"]["dp"][k] for k in (
                "ms_per_step", "epoch_s", "launches_per_step",
                "device_launches_per_step")} | {
                "peak_bytes": rep["peak_bytes"]}
            for r, rep in enumerate(reps)},
        "peak_bytes_single": one["peak_bytes"], "parts_s": {
            **parts, "single": one["parts_s"], "rank0": reps[0]["parts_s"]},
        "group_vs_nogroup_gap": group_gap, "group_tol": DP_GROUP_REL_TOL,
        "dp2_vs_dp1_gap": rank_gap, "dp2_tol": DP_RANKS_REL_TOL,
        "bn_group_vs_nogroup_gap": bn_formula_gap,
        "bn_tol": DP_BN_REL_TOL,
        "bn_dp2_vs_group_gap": bn_rank_gap}))
    for what, got, tol in (
            ("world-1 group vs no group", group_gap, DP_GROUP_REL_TOL),
            ("dp-2 vs dp-1", rank_gap, DP_RANKS_REL_TOL),
            ("batch-norm, world-1 group vs no group", bn_formula_gap,
             DP_BN_REL_TOL),
            ("batch-norm, dp-2 vs the world-1 group", bn_rank_gap,
             DP_BN_REL_TOL)):
        if not got <= tol:
            raise AssertionError(f"dp-bench {what}: {got:.3g} > {tol}")
    return {"launches": launches, "sizes": sizes}


def _seq_res(res: dict) -> list:
    """The accuracies (points) of a result dict, in order."""
    return [a for r in res.values() for i in sorted(r["seq_res"])
            for a in r["seq_res"][i]]


def _cli_tree(root: str) -> tuple[list, dict, dict]:
    """(the files under ``root``, the result dicts, every best model's
    batch-norm statistics), by path relative to ``root``."""
    from clsurvey_torch.utils import io

    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    results = {f: io.load(os.path.join(root, f)) for f in files
               if "test_method_performances" in f}
    stats = {f: io.load(os.path.join(root, f))["batch_stats"] for f in files
             if os.path.basename(f) == "best_model.pth.tar"}
    return files, results, stats


def dp_cli(card: str, tmp: str) -> dict:
    """The timing_mode finetuning CLI on ``DP_CLI_DS`` under
    ``torch.distributed.run --nproc_per_node 2`` (two ranks on the card:
    gloo), then the same CLI in this process; their eval matrices, best
    models' batch-norm statistics and files, and each rank's writes and
    launches."""
    from clsurvey_torch.framework import main as cli_main
    from clsurvey_torch.ops import _kernels
    from clsurvey_torch.utils import config, io

    root2, root1 = os.path.join(tmp, "cli2"), os.path.join(tmp, "cli1")
    logs = os.path.join(tmp, "cli2_logs")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "--redirects", "3", "--log-dir", logs,
           "-m", "clsurvey_torch.framework.main"] + DP_CLI_ARGV
    log("dp-cli:", " ".join(cmd[1:]))
    t0 = time.perf_counter()
    try:
        _run_procs([cmd], [os.path.join(tmp, "cli2.log")],
                   [_repo_env(CLSURVEY_ROOT=root2)], "dp-cli two ranks")
    except AssertionError:
        for d, _, fs in os.walk(logs):  # each rank's own log
            for f in fs:
                with open(os.path.join(d, f)) as fh:
                    log(f"--- {os.path.join(d, f)}\n{fh.read()[-3000:]}")
        raise
    wall2 = time.perf_counter() - t0
    rank_lines, task_s2 = {}, {}
    for d, _, fs in os.walk(logs):
        for f in fs:
            with open(os.path.join(d, f)) as fh:
                for line in fh:
                    m = re.search(r"\[rank (\d+)/2\] (\{.*\})", line)
                    if m:
                        rank_lines[int(m.group(1))] = json.loads(m.group(2))
                    m = re.match(r"task_(\d+) elapsed_time = ([\d.]+)s",
                                 line.strip())
                    if m:
                        task_s2[int(m.group(1))] = float(m.group(2))
    if sorted(rank_lines) != [0, 1]:
        raise AssertionError(f"dp-cli: a rank's last line is missing "
                             f"({sorted(rank_lines)}); logs under {logs}")
    os.environ["CLSURVEY_ROOT"] = root1
    config.set_config(None)
    io.WRITES["files"] = 0
    _kernels.reset_launches()
    t0 = time.perf_counter()
    manager = cli_main.cli(list(DP_CLI_ARGV))
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    writes1, launches1 = io.WRITES["files"], dict(_kernels.LAUNCHES)
    files2, res2, stats2 = _cli_tree(root2)
    files1, res1, stats1 = _cli_tree(root1)
    acc_gap = max(abs(a - b) for f in res1 for a, b in zip(
        _seq_res(res1[f]), _seq_res(res2[f])))
    stats_gap = max(_tree_gap(stats2[f], stats1[f], per_leaf=False)
                    for f in stats1)
    log(json.dumps({
        "dp_cli": " ".join(DP_CLI_ARGV), "card": card,
        "two_ranks_wall_s": wall2, "one_process_wall_s": wall1,
        "task_s_two_ranks": task_s2,
        "task_s_one_process": manager.extras["task_seconds"],
        "writes": {"rank0": rank_lines[0]["writes"],
                   "rank1": rank_lines[1]["writes"], "one_process": writes1},
        "launches": {"rank0": rank_lines[0]["launches"],
                     "rank1": rank_lines[1]["launches"],
                     "one_process": launches1},
        "files": len(files1), "eval_gap_points": acc_gap,
        "eval_tol": DP_CLI_ACC_TOL, "bn_stats_gap": stats_gap,
        "bn_stats_tol": DP_CLI_STATS_REL_TOL}))
    if files1 != files2 or any(f.endswith(".tmp") for f in files2):
        raise AssertionError(f"dp-cli: the two-rank run's files differ: "
                             f"{sorted(set(files1) ^ set(files2))}")
    if sorted(res1) != sorted(res2) or len(res1) != 2 or len(stats1) < 2:
        raise AssertionError(f"dp-cli: result dicts {sorted(res2)}, best "
                             f"models {sorted(stats2)}")
    if rank_lines[1]["writes"] != 0 or rank_lines[0]["writes"] != writes1:
        raise AssertionError(f"dp-cli: writes {rank_lines} against "
                             f"{writes1} in one process")
    for r in (0, 1):
        _launched_all(rank_lines[r]["launches"], f"dp-cli rank {r}")
    if acc_gap > DP_CLI_ACC_TOL or stats_gap > DP_CLI_STATS_REL_TOL:
        raise AssertionError(f"dp-cli: eval gap {acc_gap} points, "
                             f"batch-norm statistics gap {stats_gap:.3g}")
    return {"launches": {f"cli_rank{r}": rank_lines[r]["launches"]
                         for r in (0, 1)},
            "sizes": {b for r in (0, 1)
                      for bs in rank_lines[r]["batches"].values()
                      for b in bs}}


def phase_dp(card: str) -> dict:
    """dp-bench, then dp-cli (``PHASES``' docstring entry 10)."""
    with tempfile.TemporaryDirectory() as tmp:
        bench = dp_bench(card, tmp)
        cli = dp_cli(card, tmp)
    return {"launches": {**bench["launches"], **cli["launches"]},
            "sizes": bench["sizes"] | cli["sizes"]}


SURVEY_TASKS = 3
SURVEY_EPOCHS = 2
# the survey script's protocol (Phase 1 on two learning rates, Phase 2 up
# to two attempts) at its default data (10 classes, 64 / 32 / 32 rows a
# class, 64 px) and batch, cut in depth only
SURVEY_ARGV = [
    "--tasks", str(SURVEY_TASKS), "--epochs", str(SURVEY_EPOCHS),
    "--lr_grid", "5e-2,1e-2", "--max_attempts", "2",
    "--epochs_override", f"HAT={SURVEY_EPOCHS}",
    "--epochs_override", f"pathnet={SURVEY_EPOCHS}",
    "--shp", f"pathnet=8;{SURVEY_EPOCHS}", "--device", "cuda"]
SURVEY_CUTS = {
    "tasks": f"10 -> {SURVEY_TASKS}",
    "epochs a task": f"12 -> {SURVEY_EPOCHS}",
    "HAT epochs": f"60 -> {SURVEY_EPOCHS} (--epochs_override)",
    "pathnet epochs": f"30 -> {SURVEY_EPOCHS} (--epochs_override)",
    "pathnet generations": f"5 -> {SURVEY_EPOCHS}, one epoch a candidate "
                           f"(--shp pathnet=8;{SURVEY_EPOCHS})",
    "timing_mode": "finetuning only, 2 tasks, 100 train rows a class, "
                   "1 attempt"}
SURVEY_TIMING_ARGV = ["--methods", "finetuning", "--tasks", "2", "--n",
                      "100", "--max_attempts", "1", "--device", "cuda"]


def _survey_main(argv: list, records: dict) -> None:
    """``run_survey_demo.main(argv)``, each CLI run it makes with the
    kernels' counters zeroed just before and read just after (into
    ``records``, by method)."""
    from clsurvey_torch.framework import main as cli_main
    from clsurvey_torch.ops import _kernels
    from clsurvey_torch.scripts import run_survey_demo as rsd

    real_main = cli_main.main

    def counted(args):
        _kernels.reset_launches()
        t0 = time.perf_counter()
        manager = real_main(args)
        torch.cuda.synchronize()
        key = ("SI dump" if args.runmode == "first_task_basemodel_dump"
               else args.method_name)
        records[key] = {
            "seconds": time.perf_counter() - t0,
            "launches": dict(_kernels.LAUNCHES),
            "batches": sorted(set().union(*_kernels.BATCHES.values()))}
        return manager

    cli_main.main = counted
    try:
        rsd.main(argv)
    finally:
        cli_main.main = real_main


def _table_rows(md: str) -> list:
    """The method names of a survey table's rows (after its header)."""
    lines = [ln for ln in md.splitlines() if ln.startswith("| ")]
    return [ln.split("|")[1].strip() for ln in lines[1:]]


def phase_survey(card: str) -> dict:
    """The survey's scripts on the card (``PHASES``' docstring entry 11).
    Returns {"launches": {variant: launches}, "sizes": batch sizes}."""
    import importlib.util

    from clsurvey_torch.scripts import hd200_family_report as family
    from clsurvey_torch.scripts import run_survey_demo as rsd
    from clsurvey_torch.scripts import run_timing_mode as timing
    from clsurvey_torch.utils import config

    figures = importlib.util.find_spec("matplotlib") is not None
    log("survey: matplotlib " + ("imports: the figures are rendered"
                                 if figures else
                                 "is not installed: the script renders "
                                 "the table, rows and summary without "
                                 "the figures"))
    log(json.dumps({"survey_cuts": SURVEY_CUTS, "card": card}))
    variants = [name for name, _, _ in rsd.METHODS]
    with tempfile.TemporaryDirectory() as root:
        os.environ["CLSURVEY_ROOT"] = root
        config.set_config(None)
        out = os.path.join(root, "survey", "survey_demo")
        records: dict = {}
        log("survey: python -m clsurvey_torch.scripts.run_survey_demo",
            " ".join(SURVEY_ARGV))
        t0 = time.perf_counter()
        _survey_main(SURVEY_ARGV, records)
        sweep_s = time.perf_counter() - t0
        with open(out + "_status.json") as f:
            status = json.load(f)
        failed = {m: status.get(m) for m in variants
                  if not status.get(m, {}).get("ok")}
        if failed:
            raise AssertionError(f"survey: variants failed: {failed}")
        with open(out + "_rows.json") as f:
            rows = json.load(f)
        with open(out + ".md") as f:
            table = _table_rows(f.read())
        if sorted(table) != sorted(variants) or sorted(rows) != \
                sorted(variants):
            raise AssertionError(f"survey: table rows {table}, row store "
                                 f"{sorted(rows)}; want {variants}")
        keys = {"exp", "avg_acc", "avg_forgetting", "curves", "task_count",
                "hyperparams"}
        for name, row in rows.items():  # every task trained and evaluated
            if not keys <= set(row) or row["task_count"] != SURVEY_TASKS:
                raise AssertionError(f"survey: row {name}: {row}")
        want = [out + "_summary.txt"] + (
            [out + "_acc.png", out + "_forgetting.png"] if figures else [])
        missing = [p for p in want if not os.path.isfile(p)]
        if missing:
            raise AssertionError(f"survey: not rendered: {missing}")
        for name in variants:
            rec = records[name]
            # PathNet pools with F.max_pool2d, as the JAX package pools it
            # with XLA's reduce_window: no pool kernel on its path
            zero = sorted(k for k, n in rec["launches"].items() if n <= 0)
            if zero != (["pool_bwd", "pool_fwd"] if name == "pathnet"
                        else []):
                raise AssertionError(f"survey: {name} launched "
                                     f"{rec['launches']}")
        stamps = {k: (r.get("commit"), r.get("date"))
                  for k, r in rows.items()}
        t1 = time.perf_counter()
        _survey_main(SURVEY_ARGV + ["--postprocess_only"], {})
        render_s = time.perf_counter() - t1
        with open(out + "_rows.json") as f:
            again = {k: (r.get("commit"), r.get("date"))
                     for k, r in json.load(f).items()}
        if again != stamps:
            raise AssertionError(f"survey: a second render moved the rows' "
                                 f"commit/date: {stamps} -> {again}")

        log("survey: python -m clsurvey_torch.scripts.run_timing_mode",
            " ".join(SURVEY_TIMING_ARGV))
        t2 = time.perf_counter()
        timing.main(SURVEY_TIMING_ARGV)
        timing_s = time.perf_counter() - t2
        with open(os.path.join(root, "survey", "timing_mode.md")) as f:
            lines = f.read().splitlines()
        task_rows = [ln for ln in lines if "| task_" in ln]
        if card not in lines[0] or len(task_rows) != 2:
            raise AssertionError(f"survey: timing table {lines}")
        for ln in [lines[0]] + task_rows:
            log("  " + ln)

        _, checks = family.build_report(rows)
        log("survey: family checks (not held at 2 epochs): " + json.dumps(
            {fid: ok for fid, _, ok in checks}))
    seen = set()
    for rec in records.values():
        seen.update(rec["batches"])
    log(json.dumps({
        "survey": {name: {"seconds": records[name]["seconds"],
                          "avg_acc": rows[name]["avg_acc"],
                          "avg_forgetting": rows[name]["avg_forgetting"],
                          "launches": records[name]["launches"]}
                   for name in variants},
        "si_dump_s": records["SI dump"]["seconds"], "sweep_s": sweep_s,
        "render_s": render_s, "timing_mode_s": timing_s,
        "figures": figures, "batches": sorted(seen), "cuts": SURVEY_CUTS,
        "card": card}))
    return {"launches": {name: records[name]["launches"]
                         for name in variants}, "sizes": seen}


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
        events = device_events(prof)
        device_ms = sum(kernel_us(prof).values()) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        log(json.dumps({
            "profile": f"10 steps {dtype}", "wall_ms": wall_ms,
            "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "kernel_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:80],
                     "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top]}))


PHASES = ("card", "kernels", "cli", "framework", "methods", "rehearsal",
          "masks", "alexnet", "streaming", "dp", "survey", "protocol")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of " + ",".join(PHASES) + " (default: "
                         "all; the final ok line needs a full run)")
    phases = [p for p in ap.parse_args(argv).phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; choose from {list(PHASES)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # one npz cache of the synthetic tasks for the whole run: a task is
    # generated once (about 5 s of host numpy at 64 px), not once per CLI
    # run that touches it
    with tempfile.TemporaryDirectory() as cache:
        os.environ["CLSURVEY_SYNTH_CACHE"] = cache
        return run(phases)


def run(phases: list) -> int:
    card = describe("cuda")

    def timed(name, run, *args):
        t0 = time.perf_counter()
        out = run(*args)
        torch.cuda.synchronize()
        log(json.dumps({"phase": name,
                        "seconds": time.perf_counter() - t0, "card": card}))
        return out

    # always: every other phase needs the kernels built
    timed("card", phase_card, card)
    # None: the phase did not run
    checks = launches = fw_launches = method_launches = None
    reh_launches = mask_launches = alex = stream = dp = survey = None
    seen = set()  # batch sizes the rehearsal and masks phases used
    if "kernels" in phases:
        checks = timed("kernels", phase_kernels)
    if "cli" in phases:
        with tempfile.TemporaryDirectory() as root:
            launches = timed("cli", phase_cli, root)
    if {"framework", "methods"} & set(phases):
        # one root and one base model for both phases
        with tempfile.TemporaryDirectory() as root:
            base_path = si_base_model(root, card)
            if "framework" in phases:
                fw_launches = timed("framework", phase_framework, base_path,
                                    card)
            if "methods" in phases:
                method_launches = timed("methods", phase_methods, base_path,
                                        card)
    if "rehearsal" in phases:
        with tempfile.TemporaryDirectory() as root:
            reh_launches, sizes = timed("rehearsal", phase_rehearsal, root,
                                        card)
        seen.update(sizes)
    if "masks" in phases:
        with tempfile.TemporaryDirectory() as root:
            mask_launches, sizes = timed("masks", phase_masks, root, card)
        seen.update(sizes)
    if "alexnet" in phases:
        alex = timed("alexnet", phase_alexnet, card)
        seen.update(alex["sizes"])
    if "streaming" in phases:
        stream = timed("streaming", phase_streaming, card)
        seen.update(stream["sizes"])
    if "dp" in phases:
        dp = timed("dp", phase_dp, card)
        seen.update(dp["sizes"])
    if "survey" in phases:
        survey = timed("survey", phase_survey, card)
        seen.update(survey["sizes"])
    held = set(checks["held_batches"]) if checks else set()
    late = sorted(seen - held - {PREPROCESS_SHAPE[0]})
    if late:  # a size the kernels phase did not hold: hold it now
        check_batches(torch.Generator(device="cuda").manual_seed(1), late)
        log(f"kernels agree at the other batch sizes the rehearsal, "
            f"masks, alexnet, streaming, dp and survey phases used: "
            f"{late}")
        if checks:
            checks["held_batches"] = sorted(held | set(late))
    if "protocol" in phases:
        timed("protocol", phase_protocol, card)
    if checks is not None:
        sources = {"normalize_flip": "clsurvey_torch/csrc/preprocess.cu",
                   "pool_fwd": "clsurvey_torch/csrc/pool.cu",
                   "pool_bwd": "clsurvey_torch/csrc/pool.cu"}
        replaces = {"normalize_flip": "clsurvey_tpu/ops/preprocess.py:61",
                    "pool_fwd": "clsurvey_tpu/ops/pool_pallas.py:82",
                    "pool_bwd": "clsurvey_tpu/ops/pool_pallas.py:113"}
        # A in float32; B1 and B2 in float32 and in bfloat16, the dtype of
        # the protocol's headline throughput
        dtypes = {"normalize_flip": (torch.float32,),
                  "pool_fwd": (torch.float32, torch.bfloat16),
                  "pool_bwd": (torch.float32, torch.bfloat16)}
        if alex is not None:  # A at AlexNet's shape, beside the others
            checks["normalize_flip"]["rows"].extend(alex["rows"])
        log(card)
        log(json.dumps({"kernels": [
            {**_kernel_row(name, sources[name], replaces[name],
                           checks[name], launches and launches[name],
                           dtype),
             "launches_framework": fw_launches and {
                 m: n[name] for m, n in fw_launches.items()},
             "launches_methods": method_launches and {
                 m: n[name] for m, n in method_launches.items()},
             "launches_rehearsal": reh_launches and {
                 m: n[name] for m, n in reh_launches.items()},
             "launches_masks": mask_launches and {
                 m: n[name] for m, n in mask_launches.items()},
             "launches_alexnet": alex and {
                 m: n[name] for m, n in alex["launches"].items()},
             "launches_streaming": stream and {
                 m: n[name] for m, n in stream["launches"].items()},
             "launches_dp": dp and {
                 m: n[name] for m, n in dp["launches"].items()},
             "launches_survey": survey and {
                 m: n[name] for m, n in survey["launches"].items()},
             "held_batches": checks["held_batches"]}
            for name in sources for dtype in dtypes[name]]}))
    if set(phases) >= set(PHASES):
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
    else:
        log("partial run (--phases): no ok line")
    return 0


if __name__ == "__main__":
    sys.exit(main())
