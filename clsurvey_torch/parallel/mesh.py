"""Data parallel over ``torch.distributed``: the port's communication layer.

Counterpart of ``clsurvey_tpu/parallel/mesh.py``. The JAX package shards
each batch over a 1-D ``data`` mesh and lets GSPMD insert the reductions.
Here every rank runs the same host program on the same global data: the
same permutation, the same generator seeds, the whole split on its own
device. Each step draws the GLOBAL batch's flips, dropout masks and rule
draws from the epoch generator, exactly as one device does, and then keeps
its own contiguous rows ``[r*b/N, (r+1)*b/N)`` of the rows and of the draws
(:meth:`Mesh.shard`). The reductions GSPMD inserts become ``all_reduce``
SUMs with global denominators:

- a term that is a mean over the batch is the rank's local sum over the
  global count (:func:`share` of the local mean by ``mean_scale``);
- a term that does not depend on the batch is counted once (scaled by
  ``1/N`` on every rank, or added after the all-reduce);
- the gradient is all-reduced once a step, in one flat buffer
  (:func:`global_grads`), before anything that acts on replicated state;
- an evaluation pads each batch to a multiple of N with rows of weight 0
  and all-reduces its counters once (:func:`count_hits`);
- batch-norm's moments go through :func:`all_reduce_sum_grad`, whose
  backward all-reduces too.

dp-N therefore differs from dp-1 only in the order of its sums.

A :class:`Mesh` without a process group (the default outside ``torchrun``)
issues no collective, and every caller keeps its one-device path bit for
bit. Under a group, even one of world size 1, the collective path runs.

Collectives: ``all_reduce`` (SUM), ``broadcast`` and ``barrier``, nothing
else. That is the set gloo also runs on CUDA tensors, so two ranks that
share one card (gloo) run the same code as one rank a card (NCCL).

Backend: NCCL where every rank of the node owns a card (``LOCAL_WORLD_SIZE
<= torch.cuda.device_count()``), gloo where ranks share a card or run on
the CPU. NCCL that fails to start raises; nothing falls back to gloo.

Writer: rank 0 writes every file (``utils/io.py``) and runs the other file
system side effects (:func:`writer_does`); every rank then passes a
barrier, so the files a rank reads next exist. Every rank calls these at
the same program points."""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

# every group's timeout: a rank that skips a collective fails the run
# instead of hanging it
TIMEOUT = timedelta(minutes=30)


class Shard(NamedTuple):
    """This rank's rows ``[lo, hi)`` of a global batch of ``b`` rows. A sum
    over them times ``sum_scale``, or a mean over them times
    ``mean_scale``, is this rank's share of the global sum or mean."""

    lo: int
    hi: int
    sum_scale: float
    mean_scale: float


@dataclass(frozen=True)
class Mesh:
    """The rank, the world size, the process group (None: one device, no
    collective) and the rank's device (None without a group)."""

    rank: int = 0
    size: int = 1
    group: Any = None
    device: torch.device | None = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def batch_scale(self) -> float:
        """``mean_scale`` of a batch that divides evenly over the ranks
        (every train batch: :func:`round_batch`)."""
        return 1.0 / self.size if self.distributed else 1.0

    def shard(self, b: int) -> Shard:
        """The rows of a global batch of ``b`` this rank takes. With fewer
        rows than ranks every rank takes them all, counted once (scale
        ``1/N``), so no rank runs an empty batch."""
        b = int(b)
        if not self.distributed:
            return Shard(0, b, 1.0, 1.0)
        if b < self.size:
            return Shard(0, b, 1.0 / self.size, 1.0 / self.size)
        lo = self.rank * b // self.size
        hi = (self.rank + 1) * b // self.size
        return Shard(lo, hi, 1.0, (hi - lo) / b)


_MESH: Mesh | None = None


def make_mesh(device: str | torch.device = "cuda",
              init_method: str | None = None) -> Mesh:
    """The mesh of this process: from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) when
    it is set, joining the process group (or starting it, at
    ``init_method``, default ``env://``); else one device with no group.
    Under a group the rank's device is ``cuda:{LOCAL_RANK % cards}``, or
    the CPU when ``device`` asks for it."""
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        return Mesh()
    rank = int(os.environ.get("RANK", "0"))
    size = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", str(size)))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested for rank {rank} but "
                f"torch.cuda.is_available() is False; pass --device cpu to "
                f"run the ranks on the CPU")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if local_size <= n_cards else "gloo"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    if not dist.is_initialized():
        kwargs = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=size, timeout=TIMEOUT, **kwargs)
    mesh = Mesh(dist.get_rank(), dist.get_world_size(), dist.group.WORLD,
                dev)
    barrier(mesh)  # the group works before anything relies on it
    return mesh


def get_mesh(device: str | torch.device = "cuda") -> Mesh:
    """The installed mesh, made by :func:`make_mesh` on first use."""
    global _MESH
    if _MESH is None:
        _MESH = make_mesh(device)
    return _MESH


def set_mesh(mesh: Mesh | None) -> None:
    global _MESH
    _MESH = mesh


def shutdown() -> None:
    """Leave the process group, if this process joined one (at the end of
    a ``torchrun`` entry point), and forget the installed mesh."""
    global _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None


def is_writer(mesh: Mesh | None = None) -> bool:
    return (mesh or get_mesh()).rank == 0


def writer_log(log: Callable, mesh: Mesh | None = None) -> Callable:
    """``log`` on the writer, a function that prints nothing elsewhere."""
    return log if is_writer(mesh) else (lambda *_a, **_k: None)


def barrier(mesh: Mesh | None = None) -> None:
    mesh = mesh or get_mesh()
    if mesh.distributed:
        dist.barrier(group=mesh.group)


def writer_does(fn: Callable, *args, mesh: Mesh | None = None, **kwargs):
    """``fn(*args, **kwargs)`` on the writer alone, then a barrier on
    every rank. Returns ``fn``'s result on the writer, None elsewhere."""
    mesh = mesh or get_mesh()
    out = fn(*args, **kwargs) if mesh.rank == 0 else None
    barrier(mesh)
    return out


def _comm_device(mesh: Mesh) -> torch.device:
    """Where a collective's buffer lives: the rank's device (NCCL takes
    only CUDA tensors; gloo takes both)."""
    return mesh.device if mesh.device is not None else torch.device("cpu")


def agree(flag: bool, mesh: Mesh | None = None) -> bool:
    """The writer's ``flag`` on every rank (one broadcast)."""
    mesh = mesh or get_mesh()
    if not mesh.distributed:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=_comm_device(mesh))
    dist.broadcast(t, src=0, group=mesh.group)
    return bool(t.item())


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def share(x, scale: float):
    """``x * scale``; ``x`` itself where ``scale`` is 1, so that the
    one-device path computes exactly what it computed before."""
    return x if scale == 1.0 else x * scale


def constrain_batch(x, mesh: Mesh | None = None):
    """This rank's rows of a global batch: a tensor's leading rows, each
    tensor's of a list (dropout masks), None for None."""
    mesh = mesh or get_mesh()
    if x is None or not mesh.distributed:
        return x
    if isinstance(x, (list, tuple)):
        return [constrain_batch(t, mesh) for t in x]
    sh = mesh.shard(x.shape[0])
    return x[sh.lo:sh.hi]


def eval_rows(images, labels, lo: int, hi: int,
              mesh: Mesh | None = None):
    """This rank's rows of the eval batch ``[lo, hi)``: (uint8 rows,
    labels, weights). On one device the slices themselves and weight
    None. Under a group the batch is padded to a multiple of N with
    repeats of row ``lo`` at weight 0, and each rank takes ``ceil(b/N)``
    rows of it (the JAX package's padded eval batches)."""
    mesh = mesh or get_mesh()
    if not mesh.distributed:
        return images[lo:hi], labels[lo:hi], None
    k = -(-(hi - lo) // mesh.size)
    pos = torch.arange(lo + mesh.rank * k, lo + (mesh.rank + 1) * k,
                       device=images.device)
    valid = pos < hi
    pos = torch.where(valid, pos, lo)
    return (images.index_select(0, pos),
            labels.index_select(0, pos.to(labels.device)),
            valid.to(torch.float32))


def count_hits(images, labels, batch_size: int, logits_of: Callable,
               n_classes: int | None = None, mesh: Mesh | None = None):
    """The eval counters ``(hits, rows)`` of ``logits_of`` (uint8 rows ->
    logits) over ``images`` and ``labels`` in batches of ``batch_size``:
    per class (indexed by the label) with ``n_classes``, else two scalars.
    Each rank counts its rows of every batch (:func:`eval_rows`, padded
    rows weigh 0) and the counters are all-reduced once, so every rank
    returns the global counts."""
    mesh = mesh or get_mesh()
    n = int(images.shape[0])
    shape = () if n_classes is None else (int(n_classes),)
    hits = torch.zeros(shape, device=labels.device)
    rows = torch.zeros(shape, device=labels.device)
    with torch.no_grad():
        for lo in range(0, n, batch_size):
            x_u8, y, w = eval_rows(images, labels, lo,
                                   min(lo + batch_size, n), mesh)
            hit = (logits_of(x_u8).argmax(-1) == y).to(torch.float32)
            one = torch.ones_like(hit) if w is None else w
            if w is not None:
                hit = hit * w
            if n_classes is None:
                hits += hit.sum()
                rows += one.sum()
            else:
                hits.index_add_(0, y, hit)
                rows.index_add_(0, y, one)
    all_reduce_sum([hits, rows], mesh)
    return hits, rows


def round_batch(batch_size: int, n: int, nd: int) -> int:
    """Train batch: at most ``n`` rows, rounded DOWN to a multiple of the
    ``nd`` ranks, at least ``nd`` (``clsurvey_tpu/engine/train.py:
    Engine._round_batch``): 30 -> 24 and 5 -> 8 at nd 8."""
    batch_size = min(int(batch_size), int(n))
    if nd > 1 and batch_size % nd:
        batch_size = max((batch_size // nd) * nd, nd)
    return batch_size


def round_eval_batch(batch_size: int, n: int, nd: int) -> int:
    """Eval batch: at most ``n`` rows, rounded UP to a multiple of the
    ``nd`` ranks; the padded rows weigh 0 (``clsurvey_tpu/engine/
    train.py:Engine.evaluate``): 30 -> 32 at nd 8."""
    batch_size = min(int(batch_size), int(n))
    if nd > 1 and batch_size % nd:
        batch_size += nd - batch_size % nd
    return batch_size


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def all_reduce_sum(tensors: list, mesh: Mesh | None = None) -> list:
    """Sum each tensor over the ranks, in place, through ONE flat buffer
    (one collective for a step's gradient, not one per leaf). Returns the
    tensors; without a group they are returned untouched."""
    mesh = mesh or get_mesh()
    if not mesh.distributed or not tensors:
        return tensors
    dev = _comm_device(mesh)
    with torch.no_grad():
        if len(tensors) == 1 and tensors[0].device == dev \
                and tensors[0].is_contiguous():
            dist.all_reduce(tensors[0], group=mesh.group)
            return tensors
        dtype = tensors[0].dtype
        if any(t.dtype != dtype for t in tensors):
            dtype = torch.float32
        flat = torch.cat([t.reshape(-1).to(dev, dtype) for t in tensors])
        dist.all_reduce(flat, group=mesh.group)
        i = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[i:i + n].view(t.shape))
            i += n
    return tensors


def global_grads(loss, leaves: list, mesh: Mesh | None = None,
                 allow_unused: bool = False) -> list:
    """The global batch's gradient with respect to ``leaves``, from
    ``loss``, the rank's share of the global loss (:func:`share`): the
    rank's autograd, then one all-reduce (:func:`all_reduce_sum`), the
    counterpart of the psum GSPMD inserts. An unused leaf's gradient is
    zeros (``allow_unused``)."""
    grads = grads_of(loss, leaves, allow_unused)
    if allow_unused:
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
    return all_reduce_sum(grads, mesh)


def grads_of(loss, leaves: list, allow_unused: bool = False) -> list:
    """d ``loss`` / d ``leaves``, owned by the caller alone: accumulated
    into each leaf's ``.grad`` and taken out again (None for an unused
    leaf, which raises unless ``allow_unused``).

    ``torch.autograd.grad`` returns the same values, but its finished
    graph task holds them too (as its future's value) until the thread
    that completed it lets go. For a CUDA graph that is autograd's device
    thread, which wakes the caller first: under host load it can be off
    the CPU for milliseconds, and the step's gradients then outlive the
    step into the next forward, whose peak memory depended on it."""
    for leaf in leaves:
        leaf.grad = None
    torch.autograd.backward(loss, inputs=list(leaves))
    grads = [leaf.grad for leaf in leaves]
    for leaf in leaves:
        leaf.grad = None
    if not allow_unused and any(g is None for g in grads):
        raise RuntimeError("a leaf does not take part in the loss "
                           "(allow_unused=False)")
    return grads


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum_grad(x: torch.Tensor,
                        mesh: Mesh | None = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the backward
    all-reduces the incoming gradient (the global batch's moments in
    batch-norm). ``x`` itself without a group."""
    mesh = mesh or get_mesh()
    if not mesh.distributed:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def _tensor_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def replicated(tree, mesh: Mesh | None = None):
    """Broadcast rank 0's tensors of ``tree`` into every rank's, in place
    (one broadcast per dtype); the counterpart of ``device_put(...,
    replicated)`` at a task's start. Returns ``tree``."""
    mesh = mesh or get_mesh()
    if not mesh.distributed:
        return tree
    by_dtype: dict = {}
    for t in _tensor_leaves(tree):
        by_dtype.setdefault(t.dtype, []).append(t)
    dev = _comm_device(mesh)
    with torch.no_grad():
        for leaves in by_dtype.values():
            flat = torch.cat([t.reshape(-1).to(dev) for t in leaves])
            dist.broadcast(flat, src=0, group=mesh.group)
            i = 0
            for t in leaves:
                n = t.numel()
                t.copy_(flat[i:i + n].view(t.shape))
                i += n
    return tree


def assert_replicated(tree, mesh: Mesh | None = None,
                      what: str = "state") -> None:
    """Raise on every rank when a tensor of ``tree`` differs between the
    ranks (bit for bit, NaN equal to NaN): drift between ranks is the
    failure data parallel hides. Each rank counts its leaves' entries that
    differ from rank 0's broadcast copy; the counts are all-reduced."""
    mesh = mesh or get_mesh()
    if not mesh.distributed:
        return
    leaves = _tensor_leaves(tree)
    diffs = []
    with torch.no_grad():
        dev = _comm_device(mesh)
        for t in leaves:  # NCCL takes contiguous tensors only
            t = t.detach().to(dev).contiguous()
            ref = t.clone()
            dist.broadcast(ref, src=0, group=mesh.group)
            ne = t != ref
            if t.is_floating_point():
                ne &= ~(torch.isnan(t) & torch.isnan(ref))
            diffs.append(ne.sum().to(torch.float64))
        counts = (torch.stack(diffs) if diffs
                  else torch.zeros(0, dtype=torch.float64, device=dev))
        dist.all_reduce(counts, group=mesh.group)
    bad = [i for i, c in enumerate(counts.tolist()) if c]
    if bad:
        raise AssertionError(
            f"{what} is not replicated over the {mesh.size} ranks: leaves "
            f"{bad} of {len(leaves)} differ in "
            f"{[int(counts[i]) for i in bad]} entries")
