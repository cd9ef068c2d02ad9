"""clsurvey_torch's EBLL against clsurvey_tpu's on the CPU (tiny_CNN at
32 px, float32, numpy-made inputs; the autoencoder space is 8*8*16 = 1024).

- ``encode`` / ``decode`` / ``conv_feats`` / ``trunk_head_logits`` on one
  numpy-made autoencoder: within rtol 1e-4 / atol 1e-5;
- one ``EBLLRule`` train step at task 3 with two previous heads and two
  encoders, on the plain and on the batch-norm model: params and momentum
  within atol 1e-5 (2e-5 with batch-norm); the code term moves the step;
- ``train_autoencoder`` over one epoch of five Adadelta steps, from the JAX
  package's init and permutation handed in: the autoencoder within rtol
  1e-3 / atol 1e-5 of the JAX one (``optax.adadelta`` and
  ``torch.optim.Adadelta`` agree step for step: rho 0.9, eps 1e-6), the
  same val accuracy within one sample;
- the EBLL CLI on the CPU, two tasks: the encoder grid's files, its resume,
  ``method_aux['encoders']`` in the best model; the JAX package loads that
  model and its ``EBLLRule`` gives the port's extra loss on it (rtol 1e-4);
- glorot-uniform init bounds, and AlexNet still raising its ROADMAP item."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_distill import (
    ARGV, MEAN, PX, STD, _assert_trees_close, _models, lwf_style_steps)

from clsurvey_torch.data import registry as tdata
from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.framework import main as tmain
from clsurvey_torch.methods import ebll as tebll
from clsurvey_torch.models import convert, heads as theads, registry as treg
from clsurvey_torch.utils import config as tconfig, io as tio, paths as tpaths
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.methods import ebll as jebll
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.ops import preprocess as jpp
from clsurvey_tpu.utils import io as jio

X_DIM = 8 * 8 * 16


@pytest.fixture(autouse=True)
def port_config():
    tconfig.set_config(None)
    yield tconfig.load_config(refresh=True)
    tconfig.set_config(None)


def _encoders(n, h_dim=12, seed=7):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    return [{"enc": {"kernel": f32(rng.normal(0, 0.05, (X_DIM, h_dim))),
                     "bias": f32(rng.normal(0, 0.1, (h_dim,)))},
             "dec": {"kernel": f32(rng.normal(0, 0.05, (h_dim, X_DIM))),
                     "bias": f32(rng.normal(0, 0.1, (X_DIM,)))}}
            for _ in range(n)]


@pytest.mark.parametrize("name", ["tiny_CNN_cl_32_32",
                                  "tiny_CNN_cl_32_32_BN_DROP"])
def test_autoencoder_pieces_match(name):
    student, _ = _models(name)
    (ae,) = _encoders(1)
    x = np.random.default_rng(0).normal(0, 1, (8, PX, PX, 3)).astype(
        np.float32)
    spec_j = jreg.parse_model_name("", name, (PX, PX))
    params_j = jax.tree_util.tree_map(jnp.asarray, student["params"])
    flat_j = jebll.conv_feats(spec_j, params_j, jnp.asarray(x),
                              batch_stats=student["batch_stats"])
    code_j = jebll.encode(ae, flat_j)
    recon_j = jebll.decode(ae, code_j)
    logits_j = jebll.trunk_head_logits(spec_j, student["heads"], params_j,
                                       recon_j, 1)

    backbone = treg.parse_model_name("", name, (PX, PX)).make_backbone()
    params_t = convert.params_from_jax(student["params"])
    ae_t = tebll.autoencoder_on(ae, "cpu")
    bank = {"kernel": torch.tensor(student["heads"]["kernel"]),
            "bias": torch.tensor(student["heads"]["bias"]),
            "class_counts": student["heads"]["class_counts"]}
    with torch.no_grad():
        flat_t = tebll.conv_feats(
            backbone, params_t, torch.from_numpy(x),
            convert.batch_stats_from_jax(student["batch_stats"]))
        code_t = tebll.encode(ae_t, flat_t)
        recon_t = tebll.decode(ae_t, code_t)
        logits_t = tebll.trunk_head_logits(backbone, bank, params_t,
                                           recon_t, 1)
    assert flat_t.shape == (8, X_DIM)
    for got, want in ((flat_t, flat_j), (code_t, code_j),
                      (recon_t, recon_j), (logits_t, logits_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    # the second head has 3 valid classes: its fourth slot is masked
    assert float(logits_t[:, 3].max()) == theads.NEG_INF


@pytest.mark.parametrize("name,atol", [("tiny_CNN_cl_32_32", 1e-5),
                                       ("tiny_CNN_cl_32_32_BN", 2e-5)])
def test_one_ebll_step_with_two_heads_and_two_encoders_matches(name, atol):
    hyper = {"reg_lambda": 10.0, "ebll_reg_alpha": 50.0}
    encoders = _encoders(2)
    spec_j = jreg.parse_model_name("", name, (PX, PX))
    new_j, new_t = lwf_style_steps(
        name, jebll.EBLLRule(spec_j), tebll.EBLLRule(), hyper,
        {"encoders": encoders}, {"encoders": encoders})
    _assert_trees_close(ttrain.trainable_to_host(new_t.trainable),
                        new_j.trainable, atol)
    _assert_trees_close(ttrain.trainable_to_host(new_t.momentum),
                        new_j.momentum, atol)
    # the code anchoring moved the convs beyond what distillation does
    _, new_0 = lwf_style_steps(
        name, None, tebll.EBLLRule(), {**hyper, "ebll_reg_alpha": 0.0},
        {}, {"encoders": encoders})
    moved = (new_t.trainable["params"]["features.conv_2.weight"]
             - new_0.trainable["params"]["features.conv_2.weight"])
    assert float(moved.detach().abs().max()) > 1e-5
    # export_aux: the encoders, as the JAX rule exports them
    aux = tio.to_host(tebll.EBLLRule().export_aux(new_t.mstate))
    assert len(aux["encoders"]) == 2
    np.testing.assert_array_equal(aux["encoders"][1]["enc"]["kernel"],
                                  encoders[1]["enc"]["kernel"])
    assert tebll.EBLLRule.LAMBDA_KEY == jebll.EBLLRule.LAMBDA_KEY


def test_five_adadelta_steps_from_the_jax_init_and_permutation_match():
    name, seed, h_dim, bsz = "tiny_CNN_cl_32_32", 5, 10, 32
    student, _ = _models(name)
    td = tdata.parse("synthetic_2t_4c_32px").get_task_dataset(1)
    n = 5 * bsz
    images, labels = td.train.images[:n], td.train.labels[:n]
    val_images, val_labels = td.val.images[:64], td.val.labels[:64]
    kw = dict(h_dim=h_dim, alpha=0.1, lr=1.0, epochs=1, batch_size=bsz,
              seed=seed)

    spec_j = jreg.parse_model_name("", name, (PX, PX))
    bank_j = {"kernel": jnp.asarray(student["heads"]["kernel"]),
              "bias": jnp.asarray(student["heads"]["bias"]),
              "class_counts": student["heads"]["class_counts"]}
    ae_j, acc_j = jebll.train_autoencoder(
        spec_j, student, bank_j, 0, images, labels, val_images, val_labels,
        MEAN, STD, **kw)

    # what the JAX run drew: its init and its epoch-0 permutation
    init = jio.to_host(jebll.init_autoencoder(jax.random.PRNGKey(seed),
                                              X_DIM, h_dim))
    perm = np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.PRNGKey(seed + 1), 0), n))
    keep = jax.tree_util.tree_map(np.copy, init)
    ae_t, acc_t = tebll.train_autoencoder(
        treg.parse_model_name("", name, (PX, PX)), student, 0, images,
        labels, val_images, val_labels, MEAN, STD, device="cpu",
        init_ae=init, perms=lambda e: perm, **kw)
    assert acc_j > 0  # the JAX run returned its trained autoencoder
    assert abs(acc_t - acc_j) <= 1.0 / 64 + 1e-9
    for part in ("enc", "dec"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(
                ae_t[part][leaf], np.asarray(ae_j[part][leaf]), rtol=1e-3,
                atol=1e-5, err_msg=f"{part}/{leaf}")
            # five steps moved it, and the handed-in init was not touched
            assert np.abs(ae_t[part][leaf] - init[part][leaf]).max() > 1e-3
            np.testing.assert_array_equal(init[part][leaf],
                                          keep[part][leaf])


def test_own_init_and_permutations_and_alexnet(tmp_path, monkeypatch):
    ae = tebll.init_autoencoder(torch.Generator().manual_seed(0), 1024, 100)
    bound = (6.0 / 1124) ** 0.5
    for part, shape in (("enc", (1024, 100)), ("dec", (100, 1024))):
        k = ae[part]["kernel"]
        assert k.shape == shape and not ae[part]["bias"].any()
        assert float(k.abs().max()) <= bound
        assert abs(float(k.std()) - bound / 3 ** 0.5) < 2e-3
    # without handed-in draws two runs from one seed agree bit for bit
    student, _ = _models("tiny_CNN_cl_32_32")
    td = tdata.parse("synthetic_2t_4c_32px").get_task_dataset(1)
    run = lambda: tebll.train_autoencoder(
        treg.parse_model_name("", "tiny_CNN_cl_32_32", (PX, PX)), student,
        0, td.train.images[:64], td.train.labels[:64], td.val.images[:32],
        td.val.labels[:32], MEAN, STD, h_dim=6, alpha=0.1, lr=0.05,
        epochs=2, batch_size=32, seed=3, device="cpu")
    (ae1, acc1), (ae2, acc2) = run(), run()
    assert acc1 == acc2
    np.testing.assert_array_equal(ae1["dec"]["kernel"], ae2["dec"]["kernel"])
    # AlexNet is ported: EBLL on alexnet_pretrained reaches the pretrained
    # weights, and without <models_root>/alexnet_imagenet.npz it says so
    monkeypatch.setenv("CLSURVEY_ROOT", str(tmp_path))
    monkeypatch.delenv("CLSURVEY_ALLOW_SCRATCH_PRETRAINED", raising=False)
    tconfig.set_config(None)
    with pytest.raises(FileNotFoundError, match="alexnet_imagenet.npz"):
        tmain.cli(["alexnet_pretrained"] + ARGV[1:]
                  + ["--method_name", "EBLL", "--ds_name",
                     "synthetic_2t_4c_64px_16n"])


def test_ebll_cli_on_the_cpu_and_its_model_in_the_jax_package(
        tmp_path, monkeypatch):
    monkeypatch.setenv("CLSURVEY_ROOT", str(tmp_path))
    tconfig.set_config(None)
    tmain.cli(ARGV + ["--method_name", "SI", "--runmode",
                      "first_task_basemodel_dump"])
    manager = tmain.cli(ARGV + [
        "--method_name", "EBLL", "--max_attempts_per_task", "2", "--test",
        "--static_hyperparams", "0.01;2;1e-1,1e-2;10"])
    exp_dir = manager.task_training_dir(2, create=False)
    assert tpaths.has_success(exp_dir)
    ck = tio.load(os.path.join(exp_dir, "hyperparams.pth.tar"))
    assert list(ck["state"]["hyperparams"]) == ["reg_lambda",
                                                "ebll_reg_alpha"]
    enc_dir = os.path.join(manager.task_dir(1, create=False),
                           "ENCODER_TRAINING")
    grid = jio.load(os.path.join(enc_dir, "grid_checkpoint.pth"))
    assert sorted(grid) == [(10.0, 0.01, 0.01), (10.0, 0.1, 0.01)]
    best_ae = jio.load(os.path.join(enc_dir, "best_model.pth.tar"))
    assert best_ae["enc"]["kernel"].shape == (X_DIM, 10)
    assert [len(r["seq_res"]) for r in manager.extras["eval_results"]] \
        == [2, 1]

    # the grid resumes from its checkpoint: nothing trains again
    monkeypatch.setattr(tebll, "train_autoencoder", lambda *a, **k: 1 / 0)
    manager.set_dataset(2)
    manager.method.prestep(manager.args, manager)
    np.testing.assert_array_equal(
        manager.extras["ebll_new_encoder"]["dec"]["bias"],
        best_ae["dec"]["bias"])

    # the best model carries task 1's encoder, in the JAX package's layout
    model = jio.load(os.path.join(exp_dir, "best_model.pth.tar"))
    (enc,) = model["method_aux"]["encoders"]
    np.testing.assert_array_equal(enc["enc"]["kernel"],
                                  best_ae["enc"]["kernel"])

    # ... and the JAX rule, built from that file, gives the port's loss
    hyper = {"reg_lambda": 10.0, "ebll_reg_alpha": 1.0}
    common = dict(task=1, n_tasks=2, class_counts=[4, 4], mean=MEAN,
                  std=STD, augment=False)
    spec_j = jreg.parse_model_name("", ARGV[0], (PX, PX))
    rule_j, rule_t = jebll.EBLLRule(spec_j), tebll.EBLLRule()
    ctx_j = jtrain.make_context(spec_j, update_rule=rule_j, mesh=None,
                                **common)
    ctx_t = ttrain.make_context(treg.parse_model_name("", ARGV[0], (PX, PX)),
                                update_rule=rule_t, device="cpu", **common)
    base = jio.load(tmain._si_base_model_path(manager.args, manager))
    x_u8 = np.random.default_rng(0).integers(
        0, 256, (16, PX, PX, 3), dtype=np.uint8)
    tr = {"params": model["params"],
          "heads": {k: model["heads"][k] for k in ("kernel", "bias")}}

    tr_j = jax.tree_util.tree_map(jnp.asarray, tr)
    ms_j = rule_j.init_state(tr_j, hyper, ctx_j, prev_model=base,
                             encoders=model["method_aux"]["encoders"])
    x_j = jpp.normalize(jnp.asarray(x_u8), MEAN, STD)
    feats_j, _ = ctx_j.forward_feats(tr_j["params"], {}, x_j, False,
                                     jax.random.PRNGKey(0))
    want = rule_j.extra_loss(ctx_j, tr_j, feats_j, (x_j, None), ms_j,
                             jax.random.PRNGKey(0), batch_stats={})

    tr_t = ttrain.trainable_from_host(tr, "cpu", requires_grad=False)
    ms_t = rule_t.init_state(tr_t, hyper, ctx_t, prev_model=base,
                             encoders=model["method_aux"]["encoders"])
    with torch.no_grad():
        x_t = ctx_t.preprocess(torch.from_numpy(x_u8))
        feats_t, _ = ctx_t.forward_feats(tr_t["params"], {}, x_t, False)
        got = rule_t.extra_loss(ctx_t, tr_t, feats_t, (x_t, None), ms_t,
                                batch_stats={})
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
