"""VGG-16 (configuration D, with dropout) on the port, against the
benchmark's plain reference, on the CPU:

- ``clbench/configs/vgg16_224.json`` resolves against the program's model
  ``16normal_DROP_cl_4096_4096`` at 224 px (built on the meta device):
  parameter names and shapes, 134,260,544 backbone parameters
  (torchvision's 138,357,544 less its 1000-class layer's 4,097,000),
  dropout widths [4096, 4096], and 92.80192512 GFLOP a train image;
- a copy of that configuration at 32 px (every width kept; the five pools
  leave 1x1x512), in float64 on seeded random weights: the program's
  backbone and head bank (``ops/conv.py``'s CPU route, ``pool2x2``'s plain
  twin) against ``clbench/reference/net.py``: the eval forward, and one
  train step's loss and every parameter's gradient with handed-in flip and
  dropout masks;
- a whole harness run of that 32-px cell on the CPU reads ``correct``
  under the VGG-16 cell's own limits."""

import json
import math
import os
import shutil

import pytest
import torch

from clbench import flops, harness, seeds, weights
from clbench.reference import net
from clbench.reference import train as ref
from clbench.spec import PKG_DIR, REPO_DIR, Spec
from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.methods.base import UpdateRule
from clsurvey_torch.models import registry as treg

CONFIG, CELL = "vgg16_224", "vgg16-224-finetune-fp32"
SMALL_PX = 32
# the program's backbone in float64 against the float64 reference; its
# features, heads and loss stay float32 (models/backbones.py), each
# rounded at 6e-8 of its size, which the 4,096-wide head product and the
# backward carry to 3e-7 of a leaf's largest entry at most here; 1e-5
# leaves room for a float32 sum of 4,096 terms (4e-6 at worst on a random
# walk), while a wrong layer, mask, flip or name moves a leaf by its size
F64_RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(px: int | None = None) -> dict:
    cfg = Spec().config(CONFIG)
    return cfg if px is None else {**cfg, "input_px": px}


def test_the_configuration_is_the_programs_vgg16():
    cfg = _cfg()
    spec = treg.parse_model_name("", cfg["program_model"], (224, 224))
    assert (spec.arch, spec.batch_norm, spec.dropout) == \
        ("16normal", False, True)
    with torch.device("meta"):
        backbone = spec.make_backbone()
    got = {k: tuple(v.shape) for k, v in backbone.named_parameters()}
    want = {k: v for k, v in net.param_shapes(cfg).items()
            if not k.startswith("heads.")}
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == 138357544 - 4097000
    assert list(backbone.drop_dims) == net.dropout_widths(cfg) == \
        [4096, 4096]
    assert net.feature_dim(cfg) == backbone.feature_dim == 4096
    assert net.param_shapes(cfg)["heads.kernel"] == (8, 4096, 200)
    assert flops.train_flops(cfg) == pytest.approx(92.80192512e9,
                                                   rel=1e-12)
    assert sum(1 for layer in cfg["layers"] if layer["op"] == "conv") == 13


def _program(cfg: dict, w: dict):
    """The program's context in float64 on the CPU, with the drawn
    weights laid out as the harness lays them."""
    px = cfg["input_px"]
    spec = treg.parse_model_name("", cfg["program_model"], (px, px),
                                 compute_dtype=torch.float64)
    ctx = ttrain.make_context(
        spec, task=0, n_tasks=1,
        class_counts=[cfg["classes_per_task"]] * cfg["max_tasks"],
        mean=cfg["mean"], std=cfg["std"], update_rule=UpdateRule(),
        device="cpu", augment=True)
    return ctx, harness._trainable(ctx, w)


def _inputs(cfg: dict, rows: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    px = cfg["input_px"]
    u8 = torch.randint(0, 256, (rows, px, px, 3), dtype=torch.uint8,
                       generator=gen)
    y = torch.randint(0, cfg["classes_per_task"], (rows,), generator=gen)
    flip = torch.randint(0, 2, (rows,), dtype=torch.uint8, generator=gen)
    masks = [torch.randint(0, 2, (rows, d), dtype=torch.uint8,
                           generator=gen) for d in net.dropout_widths(cfg)]
    return u8, y, flip, masks


def _close(got, want, what):
    scale = float(want.abs().max())
    err = float((got.detach() - want.detach()).abs().max())
    assert err <= F64_RTOL * scale, (what, err, scale)


def test_the_program_matches_the_reference_in_float64_at_32px():
    cfg = _cfg(SMALL_PX)
    drawn = weights.make(cfg, 11, seeds.WEIGHTS, "cpu")
    w = {k: v.double() for k, v in drawn.items()}  # the reference's
    # the program's backbone in float64, its head bank float32
    ctx, trainable = _program(cfg, {k: v if k.startswith("heads.") else
                                    v.double() for k, v in drawn.items()})
    params = {**trainable["params"],
              **{f"heads.{k}": v for k, v in trainable["heads"].items()}}
    u8, y, flip, masks = _inputs(cfg, 6, seed=3)

    # the eval forward: features and the task head
    x_eval = ctx.preprocess(u8)
    feats, _ = ctx.forward_feats(trainable["params"], {}, x_eval, False)
    want = net.features(cfg, w, ref.preprocess(u8, cfg, None,
                                               torch.float64))
    _close(feats, want, "features")
    _close(ctx.task_logits(trainable, feats), net.head_logits(w, want, 0),
           "logits")

    # one train step's loss and gradient, flips and dropout handed in
    engine = ttrain.Engine(ctx)
    mstate = UpdateRule().init_state(None, {}, ctx)
    loss, grads, _, _ = engine._base_loss_and_grads(
        trainable, {}, (ctx.preprocess(u8, flip), y), mstate,
        dropout_masks=masks)
    problem = ref.Problem(cfg, {"method": "finetune", "task": 1,
                                "batch_size": 6, "train_rows": 6},
                          torch.device("cpu"))
    w_ref = {k: v.clone().requires_grad_() for k, v in w.items()}
    ref_loss = ref.loss_of(problem, w_ref,
                           ref.preprocess(u8, cfg, flip, torch.float64), y,
                           masks, None)
    ref_grads = dict(zip(w_ref, torch.autograd.grad(ref_loss,
                                                    list(w_ref.values()))))
    assert abs(float(loss.detach()) - float(ref_loss.detach())) <= \
        F64_RTOL * float(ref_loss.detach())
    got = {**grads["params"],
           **{f"heads.{k}": v for k, v in grads["heads"].items()}}
    assert set(got) == set(ref_grads) == set(params)
    for k, g in ref_grads.items():
        assert float(g.abs().max()) > 0, k
        _close(got[k], g, k)


def _small_cell(tmp) -> Spec:
    """A copy of the benchmark's folder with the VGG-16 cell at 32 px: 32
    train rows in batches of 8, 16 val, the cell's own limits."""
    root = os.path.join(tmp, "clbench")
    shutil.copytree(PKG_DIR, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = {**_cfg(SMALL_PX), "name": "vgg16_32"}
    with open(os.path.join(root, "configs", "vgg16_32.json"), "w") as f:
        json.dump(cfg, f)
    wl = {**Spec().workload(CELL), "config": "vgg16_32", "train_rows": 32,
          "val_rows": 16, "batch_size": 8}
    with open(os.path.join(root, "workloads", "vgg16-32.json"), "w") as f:
        json.dump(wl, f)
    bench["workloads"].append({"name": "vgg16-32", "config": "vgg16_32",
                               "traffic": "vgg16-32", "chips": 1,
                               "why": "a CPU test"})
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return Spec(bench=path, root=root)


def test_a_harness_run_of_the_32px_cell_is_correct(tmp_path):
    spec = _small_cell(str(tmp_path))
    result, lines = harness.run(spec, "vgg16-32", 2 ** 33 + 5, 0.05, False,
                                device="cpu", log=lambda m: None)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    # every number of the cell is compared against its limit
    limits = Spec().workload(CELL)["limits"]
    assert None not in limits.values()
    assert set(result["checks"]) == set(limits)
