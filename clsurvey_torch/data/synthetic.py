"""Synthetic task sequences — the framework's CPU-runnable test dataset.

Counterpart of ``clsurvey_tpu/data/synthetic.py``: the same numpy
generator calls, so the uint8 arrays are byte-identical in both packages.

The reference has no test data generator (its de-facto smoke test is the
``debug`` runmode on real Tiny-ImageNet, ref:src/framework/main.py:269-277).
We provide a deterministic class-conditional image generator so the full
framework — grid search, hyperparameter decay, every method — runs end-to-end
in seconds on CPU or a single GPU, and so unit tests have learnable
structure (each class is a distinct smooth color/gradient pattern + noise)."""

from __future__ import annotations

import os

import numpy as np

from clsurvey_torch.data.registry import (
    SplitData, TaskData, TaskSequence, register_dataset)


def _class_image(rng: np.random.Generator, proto: np.ndarray,
                 n: int, noise: float) -> np.ndarray:
    imgs = proto[None] + rng.normal(0, noise * 255.0, (n,) + proto.shape)
    return np.clip(imgs, 0, 255).astype(np.uint8)


_BASIS_K = 24


def _shared_basis(h: int, w: int) -> np.ndarray:
    """Global (task-independent) bank of oriented plane waves. In ``hard``
    mode every task's class signal is a combination of THESE patterns, so
    early conv features genuinely transfer across tasks — the structure
    importance-based CL methods exploit on natural images (and which the
    easy solid-color prototypes lack entirely)."""
    rng = np.random.default_rng(987654321)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    basis = []
    for _ in range(_BASIS_K):
        f = rng.uniform(2.0, 6.0, 2)
        phase = rng.uniform(0, 2 * np.pi)
        pat = np.sin(2 * np.pi * (f[0] * xx / w + f[1] * yy / h) + phase)
        basis.append(pat)
    return np.stack(basis)  # (K, h, w)


def _task_basis(h: int, w: int, task: int, k: int) -> np.ndarray:
    """k plane-wave patterns PRIVATE to one task (seeded by the task id,
    disjoint from the shared bank's seed). When part of a task's class
    signal rides these, later tasks — whose classes never use them — give
    the backbone no reason to keep their detectors, so finetuning drifts
    them away and forgets. This is the interference structure the
    survey's real task sequences have (task-specific discriminative
    features) that a fully-shared basis lacks."""
    # integer-frequency plane waves are exactly orthogonal on the periodic
    # grid, so different tasks' private banks (disjoint frequency slots)
    # share no span; the 7..15 band also stays clear of the shared bank's
    # 2-6 band. One global shuffle assigns each task its slot slice.
    fx, fy = np.meshgrid(np.arange(7, 16), np.arange(-15, 16))
    pairs = np.stack([fx.ravel(), fy.ravel()], axis=1)
    pairs = pairs[np.random.default_rng(24680).permutation(len(pairs))]
    start = ((task - 1) * k) % max(len(pairs) - k, 1)
    rng = np.random.default_rng(7919 * task + 13)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    basis = []
    for f in pairs[start:start + k]:
        phase = rng.uniform(0, 2 * np.pi)
        pat = np.sin(2 * np.pi * (f[0] * xx / w + f[1] * yy / h) + phase)
        basis.append(pat)
    return np.stack(basis)  # (k, h, w)


def _hard_images(rng: np.random.Generator, basis: np.ndarray,
                 class_w: np.ndarray, n: int, amp: float, rho: float,
                 noise: float) -> np.ndarray:
    """n images of one class in hard mode. Class signal = ``class_w``
    (unit-ish gaussian coefficient vector) on the shared basis at
    amplitude ``amp``; nuisance = per-image gaussian coefficients IN THE
    SAME SUBSPACE at ``rho * amp`` (so it cannot be averaged away — the
    Bayes error is set by rho, not the pixel count), plus a per-image
    global color offset (kills any mean-color shortcut) and white noise."""
    k, h, w = basis.shape
    coeff = class_w[None] + rho * rng.normal(0, 1, (n, k))
    # normalize per image: the class information is the DIRECTION of the
    # coefficient vector (angular separation sets the Bayes error), and a
    # fixed field energy keeps amp*field inside the u8 range un-clipped
    coeff = coeff / np.linalg.norm(coeff, axis=1, keepdims=True) \
        * np.sqrt(2.0)
    fields = np.tensordot(coeff, basis, axes=(1, 0))   # (n, h, w)
    color = rng.uniform(-30, 30, (n, 1, 1, 3))
    imgs = (128.0 + color + amp * fields[..., None]
            + rng.normal(0, noise * 255.0, (n, h, w, 3)))
    return np.clip(imgs, 0, 255).astype(np.uint8)


class SyntheticSequence(TaskSequence):
    """``synthetic[_<tasks>t_<classes>c_<size>px]``, e.g. synthetic_3t_5c_32px.

    ``<classes>`` may be a dash-separated list for unequal per-task class
    counts (the RecogSeq regime of padded+masked heads), e.g.
    ``synthetic_3t_5-3-4c_32px``.

    An ``<n>n`` segment sets the per-class train-image count (val/test get
    a quarter each), e.g. ``synthetic_10t_20c_64px_400n`` reproduces the
    Tiny-ImageNet protocol scale: 20 classes x 400 train/100 val/100 test
    per task (ref:src/data/tinyimgnet_dataprep.py 80/20 split)."""

    def __init__(self, ds_name: str = "synthetic", task_count: int = 3,
                 classes_per_task_n: int = 5, input_px: int = 32,
                 n_train: int = 64, n_val: int = 32, n_test: int = 32,
                 noise: float = 0.08, seed: int = 7, **_):
        counts_list = None
        hard_rho = None
        task_frac = 0.0
        # parse inline options from the name
        for seg in ds_name.split("_")[1:]:
            if seg.endswith("t"):
                task_count = int(seg[:-1])
            elif seg.endswith("c"):
                body = seg[:-1]
                if "-" in body:
                    counts_list = [int(x) for x in body.split("-")]
                else:
                    classes_per_task_n = int(body)
            elif seg.endswith("px"):
                input_px = int(seg[:-2])
            elif seg.startswith("nz"):
                # difficulty knob: per-pixel noise as a % of full scale
                # (default 8). Trivially-separable data degenerates the
                # path-integral importance methods (omega = w/(dtheta^2+xi)
                # explodes when loss -> 0 in a few steps); nz30+ gives a
                # Tiny-ImageNet-like convergence profile.
                noise = int(seg[2:]) / 100.0
            elif seg.startswith("hd"):
                # hard mode: shared-basis class signal with in-subspace
                # nuisance at ratio hd<rho*100> (e.g. hd500 -> rho=5.0).
                # Accuracy is Bayes-limited by rho and tasks share conv
                # features — the regime where the survey's method ordering
                # (replay > mask > importance > finetune) is meaningful.
                hard_rho = int(seg[2:]) / 100.0
            elif seg.startswith("ts"):
                # hard-mode interference knob: fraction of the basis that
                # is PRIVATE to each task (ts50 -> half). Shared-only
                # (ts0/absent) maximizes transfer — finetuning barely
                # forgets; a task-specific share restores the survey's
                # interference regime where protecting old-task weights
                # pays in accuracy, not just forgetting.
                task_frac = int(seg[2:]) / 100.0
            elif seg.endswith("n"):
                n_train = int(seg[:-1])
                n_val = n_test = max(n_train // 4, 8)
        self.name = ds_name
        if counts_list is not None:
            task_count = len(counts_list)
        self.task_count = task_count
        self.input_size = (input_px, input_px)
        if counts_list is not None:
            self.classes_per_task = {
                str(t): counts_list[t - 1]
                for t in range(1, task_count + 1)}
        else:
            self.classes_per_task = {
                str(t): classes_per_task_n for t in range(1, task_count + 1)}
        self._n = (n_train, n_val, n_test)
        self._noise = noise
        self._hard_rho = hard_rho
        self._task_frac = task_frac
        self._seed = seed
        self._cache: dict[int, TaskData] = {}

    # In-memory task cache budget. Unbounded caching OOM-killed the r4
    # RecogSeq-scale run: 8 tasks x 224px x up-to-200 classes is >100 GB
    # of uint8 host arrays if every generated task stays referenced.
    # Insertion-order eviction when over budget; evicted tasks reload
    # from the npz disk cache (if enabled) or regenerate.
    _MEM_BUDGET_BYTES = int(float(os.environ.get(
        "CLSURVEY_SYNTH_MEM_BUDGET_MB", "16384")) * 2 ** 20)

    @staticmethod
    def _td_nbytes(td: "TaskData") -> int:
        return sum(s.images.nbytes + s.labels.nbytes
                   for s in (td.train, td.val, td.test))

    def _cache_put(self, task: int, td: "TaskData") -> None:
        self._cache[task] = td
        total = sum(self._td_nbytes(v) for v in self._cache.values())
        for t in list(self._cache):
            if total <= self._MEM_BUDGET_BYTES or t == task:
                continue
            total -= self._td_nbytes(self._cache.pop(t))

    def get_task_dataset(self, task: int) -> TaskData:
        if task in self._cache:
            return self._cache[task]
        assert 1 <= task <= self.task_count, task
        disk = self._disk_cache_path(task)
        if disk is not None and os.path.exists(disk):
            z = np.load(disk)
            td = TaskData(
                SplitData(z["tr_x"], z["tr_y"]),
                SplitData(z["va_x"], z["va_y"]),
                SplitData(z["te_x"], z["te_y"]),
                classes=[str(c) for c in z["classes"]])
            self._cache_put(task, td)
            return td
        td = self._generate(task)
        if disk is not None:
            tmp = disk + ".tmp.npz"
            np.savez(tmp, tr_x=td.train.images, tr_y=td.train.labels,
                     va_x=td.val.images, va_y=td.val.labels,
                     te_x=td.test.images, te_y=td.test.labels,
                     classes=np.asarray(td.classes))
            os.replace(tmp, disk)  # atomic: concurrent runs see all/none
        self._cache_put(task, td)
        return td

    def _disk_cache_path(self, task: int) -> str | None:
        """Opt-in npz cache (CLSURVEY_SYNTH_CACHE=<dir>): generation of a
        protocol-scale 224px task costs minutes of single-core numpy; the
        data is a pure function of (name, seed, task)."""
        root = os.environ.get("CLSURVEY_SYNTH_CACHE", "")
        if not root:
            return None
        os.makedirs(root, exist_ok=True)
        return os.path.join(root, f"{self.name}_s{self._seed}_t{task}.npz")

    def _generate(self, task: int) -> TaskData:
        h, w = self.input_size
        ncls = self.classes_per_task[str(task)]
        rng = np.random.default_rng(self._seed * 1000 + task)
        if self._hard_rho is not None:
            basis = _shared_basis(h, w)
            k_ts = round(_BASIS_K * self._task_frac)
            if k_ts:
                basis = np.concatenate(
                    [basis[:_BASIS_K - k_ts], _task_basis(h, w, task, k_ts)])
            class_ws = rng.normal(0, 1, (ncls, _BASIS_K))
            splits = []
            for n_per in self._n:
                images = np.concatenate(
                    [_hard_images(rng, basis, class_ws[c], n_per,
                                  amp=45.0, rho=self._hard_rho,
                                  noise=self._noise)
                     for c in range(ncls)], axis=0)
                labels = np.repeat(np.arange(ncls, dtype=np.int32), n_per)
                perm = rng.permutation(len(labels))
                splits.append(SplitData(images[perm], labels[perm]))
            return TaskData(*splits,
                            classes=[f"c{c}" for c in range(ncls)])
        # distinct smooth prototype per (task, class): random low-frequency
        # gradient field, so a small conv net separates classes quickly
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        protos = []
        for c in range(ncls):
            # strong class identity: a distinct solid color anchor plus a
            # class-specific low-frequency spatial pattern
            color = rng.uniform(40, 215, 3)
            freq = rng.uniform(1.0, 3.0, 2)
            phase = rng.uniform(0, 2 * np.pi, 2)
            pattern = (np.sin(2 * np.pi * freq[0] * xx / w + phase[0])
                       + np.sin(2 * np.pi * freq[1] * yy / h + phase[1]))
            base = color[None, None, :] + 40.0 * pattern[..., None]
            protos.append(np.clip(base, 0, 255).astype(np.float32))
        splits = []
        for n_per in self._n:
            images = np.concatenate(
                [_class_image(rng, protos[c], n_per, self._noise)
                 for c in range(ncls)], axis=0)
            labels = np.repeat(np.arange(ncls, dtype=np.int32), n_per)
            perm = rng.permutation(len(labels))
            splits.append(SplitData(images[perm], labels[perm]))
        return TaskData(*splits, classes=[f"c{c}" for c in range(ncls)])


register_dataset("synthetic", SyntheticSequence)
