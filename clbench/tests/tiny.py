"""Cells small enough for the CPU, in a temporary copy of the benchmark's
files: the program's tiny_CNN at 16 px and AlexNet at its published widths
on 64-px images, resident and streamed (at a 1 MiB data
budget). The harness finds them by name, as it finds the real cells."""

from __future__ import annotations

import copy
import json
import os
import shutil

from clbench.spec import PKG_DIR, REPO_DIR, Spec

# the tiny cells are held to the limits of this cell's traffic file
LIMITS_OF = "alexnet224-finetune-fp32"
# the survey's small_VGG9_cl_128_128 at 64 px, for the count of its
# operations (not a cell yet)
SMALL_VGG9 = {
    "name": "small_vgg9_64", "input_px": 64, "classes_per_task": 20,
    "layers": [
        *[layer for c in (64, "M", 64, "M", 64, 64, "M", 128, 128, "M")
          for layer in ([{"op": "maxpool", "k": 2, "stride": 2}]
                        if c == "M" else
                        [{"op": "conv", "out": c, "k": 3, "stride": 1,
                          "pad": 1}, {"op": "relu"}])],
        {"op": "flatten"},
        {"op": "fc", "out": 128}, {"op": "relu"},
        {"op": "fc", "out": 128}, {"op": "relu"}]}
TINY_VGG = {
    "name": "tiny_cnn16", "source": "tests", "program_model":
    "tiny_CNN_cl_16_16", "input_px": 16, "max_tasks": 4,
    "classes_per_task": 5, "dtype": "float32", "tf32": False,
    "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225],
    "layers": [
        {"op": "conv", "name": "features.conv_0", "out": 8, "k": 3,
         "stride": 1, "pad": 1},
        {"op": "relu"},
        {"op": "maxpool", "k": 2, "stride": 2},
        {"op": "conv", "name": "features.conv_2", "out": 16, "k": 3,
         "stride": 1, "pad": 1},
        {"op": "relu"},
        {"op": "maxpool", "k": 2, "stride": 2},
        {"op": "flatten"},
        {"op": "fc", "name": "trunk.fc_0", "out": 16}, {"op": "relu"},
        {"op": "fc", "name": "trunk.fc_1", "out": 16}, {"op": "relu"}],
    "assumed": [], "reduced": []}
# tiny cell -> (config, traffic)
CELLS = {
    "tiny-vgg-finetune": ("tiny_cnn16", {
        "method": "finetune", "task": 1, "train_rows": 64,
        "val_rows": 40, "residency": "resident", "batch_size": 16}),
    "tiny-alexnet-finetune": ("alexnet64", {
        "method": "finetune", "task": 1, "train_rows": 64, "val_rows": 20,
        "residency": "resident", "batch_size": 16}),
    "tiny-alexnet-stream": ("alexnet64", {
        "method": "finetune", "task": 1, "train_rows": 100,
        "val_rows": 20, "residency": "stream", "batch_size": 16}),
}
BUDGET_MB = "1"  # 100 rows of 12,288 bytes stream in 32-row chunks


def make(tmp: str) -> Spec:
    """A copy of the benchmark's folder and ``BENCHMARK.json`` under
    ``tmp`` with the tiny cells added; the spec that reads it."""
    root = os.path.join(tmp, "clbench")
    shutil.copytree(PKG_DIR, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root, "workloads", f"{LIMITS_OF}.json")) as f:
        limits = json.load(f)["limits"]
    with open(os.path.join(root, "configs", "alexnet224.json")) as f:
        alex = json.load(f)
    configs = {"tiny_cnn16": TINY_VGG,
               "alexnet64": {**copy.deepcopy(alex), "name": "alexnet64",
                             "input_px": 64, "max_tasks": 3,
                             "classes_per_task": 6}}
    for name, cfg in configs.items():
        with open(os.path.join(root, "configs", f"{name}.json"), "w") as f:
            json.dump(cfg, f)
    for cell, (config, traffic) in CELLS.items():
        wl = {"config": config, "hyper": {}, "lr": 0.005, "augment": True,
              "dtype": "float32", "limits": limits, **traffic}
        with open(os.path.join(root, "workloads", f"{cell}.json"),
                  "w") as f:
            json.dump(wl, f)
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": cell, "chips": 1,
                                   "why": "a CPU test"})
        for m in bench["per_layer"]:
            m["workloads"].append(cell)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return Spec(bench=path, root=root)
