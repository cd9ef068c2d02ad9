"""Data parallel on the card: bench.py's point through the port's Engine
under a mesh (``parallel/mesh.py``).

small_VGG9_cl_128_128 at full width, 64 px, batch 200, flips on, float32
without TF32, on random rows resident on the card, made there from a seed
(the same rows in every process and rank), 20 classes.

    python -m clsurvey_torch.parallel.dp_bench OUT single
        two legs in this process, interleaved epoch by epoch: ``nogroup``
        (no process group) and ``group`` (a world-1 NCCL group it starts)
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m clsurvey_torch.parallel.dp_bench OUT ranks
        one leg, ``dp``, on each rank of the launcher's group (two ranks
        on one card: gloo)

Every leg trains one epoch from the initial weights under cuDNN's
deterministic algorithms (the compared epoch, whose state goes to the
output), and small_VGG9_cl_128_128_BN its first ``BN_COMPARED_STEPS``
steps on the same mesh (batch-norm on the global batch's moments); then
``EPOCHS`` epochs on the default algorithms, timed; the first warms
cuDNN's autotuner, the best of the others is reported. Then five steps
under ``torch.profiler`` count the device's kernel launches a step of
each one-process leg. A rank's state goes through ``assert_replicated``
after its compared epochs and at the end. Writes ``OUT`` (``OUT.r<rank>``
for a rank) as a pickle: the compared states, epoch seconds, ms a step,
img/s, the port's kernel launches a step, device launches a step and the
peak memory."""

from __future__ import annotations

import argparse
import os
import pickle
import socket
import time

import torch

from clsurvey_torch.engine.train import (
    Engine, make_context, state_from_model, trainable_to_host)
from clsurvey_torch.methods.base import UpdateRule
from clsurvey_torch.models.convert import batch_stats_to_jax
from clsurvey_torch.models.registry import init_model_state, parse_model_name
from clsurvey_torch.ops import _kernels
from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils.devtime import device_events

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BS, LR, CLASSES, PX = 200, 5e-3, 20, 64
ROWS, EPOCHS = 8000, 4
MODEL = "small_VGG9_cl_128_128"
PROFILED_STEPS = 5
# a batch-norm model's float32 gap between two legs grows with the steps
# (1e-4 of a tree's largest entry after 5, 1.1e-3 to 1.4e-3 after 40 on an
# H100), so its compared run is short
BN_COMPARED_STEPS = 5


def free_port() -> int:
    """A free TCP port on localhost (a group's ``MASTER_PORT``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world1_mesh() -> mesh_lib.Mesh:
    """A world-1 group on this process's card (NCCL: one rank, one
    card)."""
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    return mesh_lib.make_mesh("cuda")


class Leg:
    """One mesh's engine, state and tallies."""

    def __init__(self, name: str, mesh: mesh_lib.Mesh, model: str = MODEL):
        self.name, self.mesh = name, mesh
        spec = parse_model_name("", model, (PX, PX))
        ctx = make_context(spec, task=0, n_tasks=1,
                           class_counts=[CLASSES] * 10, mean=MEAN, std=STD,
                           update_rule=UpdateRule(), augment=True,
                           mesh=mesh)
        self.engine = Engine(ctx)
        self.state = state_from_model(
            init_model_state(spec, seed=0, max_tasks=10,
                             classes_per_task=CLASSES), None, ctx.device)
        self.state.mstate = ctx.update_rule.init_state(None, {}, ctx)
        self.epoch_s: list = []
        self.launches = dict.fromkeys(_kernels.LAUNCHES, 0)
        self.batches: set = set()
        self.steps = 0

    def epoch(self, images, labels, epoch: int, n_rows=None) -> float:
        """One epoch over the first ``n_rows`` of epoch ``epoch``'s
        permutation (the same on every leg and rank); its seconds."""
        n = int(images.shape[0])
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(
            epoch))[:n_rows]
        gen = torch.Generator(device=images.device).manual_seed(100 + epoch)
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.state, metrics = self.engine.train_epoch(
            self.state, images, labels, perm, gen, LR, BS)
        loss = float(metrics["loss"])  # waits for the epoch's last step
        seconds = time.perf_counter() - t0
        if loss != loss or abs(loss) == float("inf"):
            raise AssertionError(f"{self.name} epoch {epoch}: loss {loss}")
        for k, v in _kernels.LAUNCHES.items():
            self.launches[k] += v
        self.batches.update(*_kernels.BATCHES.values())
        self.steps += int(perm.shape[0]) // BS
        return seconds

    def host_state(self) -> dict:
        s = self.state
        mesh_lib.assert_replicated(
            [s.trainable, s.batch_stats, s.momentum], self.mesh, self.name)
        return {"trainable": trainable_to_host(s.trainable),
                "momentum": trainable_to_host(s.momentum),
                "batch_stats": batch_stats_to_jax(s.batch_stats)}


def _device_launches_per_step(leg: Leg, images, labels) -> float | None:
    """None for a rank of a group of more than one (the profiler's start
    costs seconds a process; the number that matters is the one-process
    legs')."""
    from torch.profiler import ProfilerActivity, profile

    if leg.mesh.size > 1:
        return None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        leg.epoch(images, labels, 99, PROFILED_STEPS * BS)
        torch.cuda.synchronize()
    return sum(e.count for e in device_events(prof)) / PROFILED_STEPS


def run(out: str, mode: str) -> dict:
    if mode == "single":
        mesh_lib.set_mesh(mesh_lib.Mesh())
        meshes = {"nogroup": mesh_lib.Mesh(), "group": _world1_mesh()}
    else:
        mesh = mesh_lib.make_mesh("cuda")
        mesh_lib.set_mesh(mesh)
        meshes = {"dp": mesh}
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randint(0, 255, (ROWS, PX, PX, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    labels = torch.randint(0, CLASSES, (ROWS,), device=dev, generator=gen)
    legs = {name: Leg(name, m) for name, m in meshes.items()}
    compared, parts, t0 = {}, {}, time.perf_counter()
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for name, leg in legs.items():
            leg.epoch(images, labels, 0)
            compared[name] = leg.host_state()
            bn = Leg(name + "_bn", leg.mesh, MODEL + "_BN")
            bn.epoch(images, labels, 0, BN_COMPARED_STEPS * BS)
            compared[bn.name] = bn.host_state()
            del bn
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    parts["compared_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    for e in range(1, EPOCHS + 1):  # interleaved, leg by leg
        for leg in legs.values():
            leg.epoch_s.append(leg.epoch(images, labels, e))
    parts["timed_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    report = {"mode": mode, "rows": ROWS, "batch": BS, "parts_s": parts,
              "peak_bytes": torch.cuda.max_memory_allocated(dev),
              "compared": compared, "legs": {}}
    steps = ROWS // BS
    for name, leg in legs.items():
        best = min(leg.epoch_s[1:] or leg.epoch_s)
        report["legs"][name] = {
            "rank": leg.mesh.rank, "world": leg.mesh.size,
            "epoch_s": leg.epoch_s, "ms_per_step": best / steps * 1e3,
            "img_per_s": steps * BS / best,
            "launches": dict(leg.launches),
            "batches": sorted(leg.batches),
            "launches_per_step": {k: v / leg.steps
                                  for k, v in leg.launches.items()},
            "device_launches_per_step": _device_launches_per_step(
                leg, images, labels)}
        leg.host_state()  # the ranks still agree at the end
    parts["profiled_s"] = time.perf_counter() - t0
    rank = next(iter(legs.values())).mesh.rank
    path = out if mode == "single" else f"{out}.r{rank}"
    with open(path, "wb") as f:
        pickle.dump(report, f)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("mode", choices=("single", "ranks"))
    a = ap.parse_args(argv)
    run(a.out, a.mode)
    mesh_lib.shutdown()


if __name__ == "__main__":
    main()
