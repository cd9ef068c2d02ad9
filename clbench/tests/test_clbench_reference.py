"""The plain reference against the program's Engine at tiny widths on the
CPU, through a whole run of the harness: every cell kind (a VGG and
AlexNet, finetuning and LwF, resident and streamed across a chunk boundary
with a wrap-padded last chunk) comes out correct, and the reference's own
pieces agree with the program's."""

from __future__ import annotations

import pytest
import torch

from clbench import harness, seeds
from clbench.reference import train as ref
from clbench.tests import tiny


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("clbench")))


@pytest.fixture()
def budget(monkeypatch):
    monkeypatch.setenv("CLSURVEY_DATA_BUDGET_MB", tiny.BUDGET_MB)


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_a_run_is_correct(spec, budget, cell):
    torch.manual_seed(0)
    result, lines = harness.run(spec, cell, 2 ** 33 + 7, 0.05, False,
                                device="cpu", log=lambda m: None)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_img_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert all(line.startswith(("check", "reported")) for line in lines)


def test_a_traced_run_reads_no_device_metric_on_the_cpu(spec):
    result, _ = harness.run(spec, "tiny-vgg-finetune", 3, 0.05, True,
                            device="cpu", log=lambda m: None)
    assert result["correct"]
    assert result["metrics"] == {}  # a CPU run writes no device metric
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_reference_preprocess_is_the_programs():
    from clsurvey_torch.ops import preprocess as pp

    cfg = {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}
    gen = torch.Generator().manual_seed(1)
    u8 = torch.randint(0, 256, (6, 8, 10, 3), dtype=torch.uint8,
                       generator=gen)
    flip = torch.tensor([0, 1, 1, 0, 1, 0], dtype=torch.uint8)
    want = pp.normalize_flip_plain(u8, cfg["mean"], cfg["std"], flip)
    got = ref.preprocess(u8, cfg, flip, torch.float64)
    assert torch.allclose(got.float(), want, rtol=0, atol=1e-6)


def test_the_chunk_plan_is_the_programs(spec, budget):
    """The rows of a streamed epoch's first steps, as the reference works
    them out, are those the program's streamed epoch trains on."""
    from clsurvey_torch.engine import train as eng

    wl = spec.workload("tiny-alexnet-stream")
    p = ref.Problem(spec.config(wl["config"]), wl, torch.device("cpu"))
    n, b = wl["train_rows"], wl["batch_size"]
    row = 64 * 64 * 3
    perm = seeds.permutation(5, 0, n).numpy()
    bs, chunk = eng.chunk_plan(n, b, eng.stream_chunk_rows(row))
    use = -(-n // chunk) * chunk
    padded = list(perm) + list(perm[:use - n])
    steps = use // bs
    got = ref.step_rows(p, 5, steps)
    assert got.tolist() == padded[:steps * bs]
    assert use > n  # the last chunk is wrap-padded
