"""clsurvey_torch's Continual Hyperparameter Framework against
clsurvey_tpu's, as host code on stub methods (no training): the two classes
are driven with the same scripted accuracies and must take the same
decisions and leave the same files.

- ``hyperparamDecay`` for 1 and 2 hyperparameters: the same sequence of
  values (one by one, then all together), exactly;
- ``stabilityDecay`` with a method that fails twice: attempts, decayed
  values, cleaned-up artifacts, ``hyperparams.pth.tar`` (read back with
  ``torch.load``) and the SUCCESS token; the retained-last-attempt branch;
- checkpoint and resume: a second framework object picks the decay state
  up, either package from the other's file, and a finished phase is
  skipped;
- ``framework_single_task``: the order of the method hooks, the phase
  timing file and the model hand-over, for a scratch method, a method that
  starts from the shared first-task model, and one that wraps it."""

import os
import types
from collections import OrderedDict

import pytest
import torch

from clsurvey_torch.framework import hyperparam as thp
from clsurvey_torch.utils import io as tio
from clsurvey_tpu.framework import hyperparam as jhp
from clsurvey_tpu.utils import io as jio

PACKAGES = {"jax": jhp, "port": thp}


def _args(**kw):
    base = dict(drop_margin=0.2, decaying_factor=0.5,
                max_attempts_per_task=5, grid_storage_policy="keep_none",
                save_models_FT_heuristic=False)
    return types.SimpleNamespace(**{**base, **kw})


class StubMethod:
    """Records every hook call; ``train`` replays scripted accuracies and
    leaves an artifact in the attempt's directory."""

    def __init__(self, hyperparams, accs, start_scratch=False,
                 wrap_first_task_model=False, calls=None):
        self.name = "stub"
        self.hyperparams = OrderedDict(hyperparams)
        self.start_scratch = start_scratch
        self.wrap_first_task_model = wrap_first_task_model
        self.accs = list(accs)
        self.calls = calls if calls is not None else []
        self.trained_with = []

    def prestep(self, args, manager):
        self.calls.append("prestep")

    def train(self, args, manager, hyperparams):
        self.calls.append("train")
        self.trained_with.append(dict(hyperparams))
        exp_dir = manager.extras["heuristic_exp_dir"]
        with open(os.path.join(exp_dir, "best_model.pth.tar"), "w") as f:
            f.write(f"attempt {len(self.trained_with)}")
        os.makedirs(os.path.join(exp_dir, "scratch_dir"), exist_ok=True)
        return None, self.accs.pop(0)

    def poststep(self, args, manager):
        self.calls.append("poststep")


class StubManager:
    def __init__(self, root, method, task_counter=2):
        self.root, self.method, self.task_counter = str(root), method, \
            task_counter
        self.extras = {}
        self.previous_task_model_path = "previous-model"

    def task_dir(self, *a, **k):
        os.makedirs(self.root, exist_ok=True)
        return self.root


def _decay_sequence(pkg, hyperparams, n):
    method = StubMethod(hyperparams, [])
    hf = pkg.HyperparameterFramework(method)
    seq = []
    for _ in range(n):
        hf.hyperparamDecay(_args(), None)
        seq.append((tuple(hf.hyperparams.values()), hf.hyperparam_idx,
                    tuple(hf.hyperparams_backup.values())))
    return seq


@pytest.mark.parametrize("hyperparams", [
    {"lambda": 400.0}, {"lambda": 8.0, "alpha": 0.5}],
    ids=["one", "two"])
def test_hyperparam_decay_sequence_matches(hyperparams):
    want = _decay_sequence(jhp, hyperparams, 7)
    got = _decay_sequence(thp, hyperparams, 7)
    assert got == want
    if len(hyperparams) == 2:
        # one by one (the other restored), then all together
        assert [v for v, _, _ in got[:3]] == [(4.0, 0.5), (8.0, 0.25),
                                              (4.0, 0.25)]


def _run_phase2(pkg, root, accs, hyperparams=None, **arg_kw):
    method = StubMethod(hyperparams or {"lambda": 400.0}, accs)
    manager = StubManager(root, method)
    hf = pkg.HyperparameterFramework(method)
    hf.stabilityDecay(_args(**arg_kw), manager, 5e-3, 0.9)
    return method, manager, hf


def _listing(root):
    return sorted(os.listdir(os.path.join(root, "TASK_TRAINING")))


@pytest.mark.parametrize("name", ["jax", "port"])
def test_stability_decay_with_a_method_that_fails_twice(tmp_path, name):
    """Threshold 0.9 * 0.8 = 0.72: two failures, then 0.75 converges."""
    method, manager, hf = _run_phase2(PACKAGES[name], tmp_path,
                                      [0.10, 0.50, 0.75])
    assert [h["lambda"] for h in method.trained_with] == [400.0, 200.0,
                                                          100.0]
    assert hf.attempts == 2 and method.calls == ["prestep"] + ["train"] * 3
    assert _listing(tmp_path) == ["SUCCESS.FLAG", "best_model.pth.tar",
                                  "hyperparams.pth.tar", "scratch_dir"]
    with open(tmp_path / "TASK_TRAINING" / "best_model.pth.tar") as f:
        assert f.read() == "attempt 3"  # failed attempts were cleaned up
    ck = torch.load(tmp_path / "TASK_TRAINING" / "hyperparams.pth.tar",
                    weights_only=False)  # the reference's reader
    assert ck["val_acc"] == 0.75 and abs(ck["acc_threshold"] - 0.72) < 1e-12
    assert ck["state"] == {"hyperparams": {"lambda": 100.0},
                           "hyperparams_backup": {"lambda": 400.0},
                           "hyperparam_idx": 0, "attempts": 2}
    assert manager.extras["lr"] == 5e-3
    assert manager.extras["best_model_path"].endswith(
        os.path.join("TASK_TRAINING", "best_model.pth.tar"))
    assert "convergence_iteration_elapsed_time" in manager.extras


def test_stability_decay_files_match_the_jax_package(tmp_path):
    for name, pkg in PACKAGES.items():
        _run_phase2(pkg, tmp_path / name, [0.10, 0.50, 0.75],
                    {"lambda": 8.0, "alpha": 0.5})
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    read = lambda n: jio.load(str(tmp_path / n / "TASK_TRAINING"
                                  / "hyperparams.pth.tar"))
    assert read("port") == read("jax")


@pytest.mark.parametrize("name", ["jax", "port"])
def test_last_attempt_is_retained(tmp_path, name):
    method, manager, hf = _run_phase2(PACKAGES[name], tmp_path,
                                      [0.1, 0.2], max_attempts_per_task=2)
    # the retained model trained with 200, the decayed 100 is carried on
    assert [h["lambda"] for h in method.trained_with] == [400.0, 200.0]
    assert hf.hyperparams["lambda"] == 100.0 and hf.attempts == 2
    assert "SUCCESS.FLAG" in _listing(tmp_path)
    assert "convergence_iteration_elapsed_time" not in manager.extras
    with open(tmp_path / "TASK_TRAINING" / "best_model.pth.tar") as f:
        assert f.read() == "attempt 2"


@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("port", "jax"),
                                           ("jax", "port")])
def test_checkpoint_and_resume(tmp_path, writer, reader):
    """A run that dies inside its third attempt resumes from the decay
    state of the second; a finished phase is skipped."""
    class Died(Exception):
        pass

    method = StubMethod({"lambda": 400.0}, [0.1, 0.2])
    manager = StubManager(tmp_path, method)
    hf = PACKAGES[writer].HyperparameterFramework(method)
    with pytest.raises(IndexError):  # the script runs out: attempt 3 dies
        hf.stabilityDecay(_args(), manager, 5e-3, 0.9)
    assert "SUCCESS.FLAG" not in _listing(tmp_path)

    method2 = StubMethod({"lambda": 400.0}, [0.8])
    manager2 = StubManager(tmp_path, method2)
    hf2 = PACKAGES[reader].HyperparameterFramework(method2)
    hf2.stabilityDecay(_args(), manager2, 5e-3, 0.9)
    assert method2.trained_with == [{"lambda": 100.0}]
    assert hf2.attempts == 2 and "SUCCESS.FLAG" in _listing(tmp_path)

    method3 = StubMethod({"lambda": 400.0}, [])
    hf3 = PACKAGES[reader].HyperparameterFramework(method3)
    hf3.stabilityDecay(_args(), StubManager(tmp_path, method3), 5e-3, 0.9)
    assert method3.calls == []  # nothing ran: SUCCESS token honoured
    assert method3.hyperparams["lambda"] == 100.0  # state restored


def test_a_corrupt_checkpoint_starts_fresh(tmp_path):
    exp_dir = tmp_path / "TASK_TRAINING"
    exp_dir.mkdir()
    tio.save({"state": {"renamed": 1}}, str(exp_dir / "hyperparams.pth.tar"))
    method, _, hf = _run_phase2(thp, tmp_path, [0.9])
    assert method.trained_with == [{"lambda": 400.0}] and hf.attempts == 0


def _single_task(pkg, root, monkeypatch, task_counter, **method_kw):
    calls = []
    method = StubMethod({"lambda": 400.0}, [0.1, 0.9], calls=calls,
                        **method_kw)
    manager = StubManager(root, method, task_counter=task_counter)

    def phase1(args, manager_):
        calls.append("phase1")
        manager_.extras["phase1_elapsed_time"] = 1.5
        return 5e-3, 0.9

    monkeypatch.setattr(pkg.HyperparameterFramework,
                        "maximalPlasticitySearch", staticmethod(phase1))
    pkg.framework_single_task(_args(), manager)
    timing = os.path.join(str(root), pkg.PHASE_TIMING_FILENAME)
    phases = sorted(jio.load(timing)) if os.path.isfile(timing) else None
    return calls, phases, manager.previous_task_model_path


@pytest.mark.parametrize("task_counter,method_kw", [
    (2, {}), (1, {"start_scratch": True}), (1, {}),
    (1, {"wrap_first_task_model": True})],
    ids=["task2", "task1_scratch", "task1_shared_model", "task1_wrap"])
def test_framework_single_task_hook_order_matches(tmp_path, monkeypatch,
                                                  task_counter, method_kw):
    want = _single_task(jhp, tmp_path / "jax", monkeypatch, task_counter,
                        **method_kw)
    got = _single_task(thp, tmp_path / "port", monkeypatch, task_counter,
                       **method_kw)
    strip = lambda r, root: (r[0], r[1], r[2].replace(str(root), ""))
    assert strip(got, tmp_path / "port") == strip(want, tmp_path / "jax")
    calls, phases, handed_over = got
    if task_counter == 1 and not method_kw:
        # non-scratch methods take the shared SI model for task 1
        assert calls == [] and handed_over == "previous-model"
    elif method_kw.get("wrap_first_task_model"):
        assert calls == ["poststep"] and phases is None
    else:
        assert calls == ["phase1", "prestep", "train", "train", "poststep"]
        assert phases == ["convergence_iteration", "phase1", "postprocess",
                          "presteps"]
        assert handed_over.endswith("best_model.pth.tar")
