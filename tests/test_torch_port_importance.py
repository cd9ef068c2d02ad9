"""clsurvey_torch's importance estimators against clsurvey_tpu's on the CPU:
``ewc_fisher`` and ``mas_importance`` from the same numpy-made model and
rows (tiny_CNN at 32 px, float32), rtol 1e-4 and atol 1e-7 (sums in another
order). Each case includes a ragged last batch (the padded rows carry
weight 0). A split above the device data budget streams through chunks
and gives the resident values (to float32 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsurvey_torch.engine import train as ttrain
from clsurvey_torch.methods.base import UpdateRule as TRule
from clsurvey_torch.models import backbones as tbackbones
from clsurvey_torch.models import registry as treg
from clsurvey_torch.models.convert import params_from_jax, params_to_jax
from clsurvey_torch.ops import conv as tconv
from clsurvey_torch.ops import importance as timp
from clsurvey_tpu.engine import train as jtrain
from clsurvey_tpu.methods.base import UpdateRule as JRule
from clsurvey_tpu.models import registry as jreg
from clsurvey_tpu.ops import importance as jimp
from clsurvey_tpu.utils import io as jio

NAME, PX = "tiny_CNN_cl_32_32", 32
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
COUNTS = [4, 3]  # task 1's head has a masked slot


@pytest.fixture(scope="module")
def setup():
    spec_j = jreg.parse_model_name("", NAME, (PX, PX))
    spec_t = treg.parse_model_name("", NAME, (PX, PX))
    model = jio.to_host(jreg.init_model_state(
        spec_j, jax.random.PRNGKey(11), max_tasks=2, classes_per_task=4,
        class_counts=COUNTS))
    common = dict(n_tasks=2, class_counts=COUNTS, mean=MEAN, std=STD,
                  augment=False)
    ctx_j = jtrain.make_context(spec_j, task=0, update_rule=JRule(),
                                mesh=None, **common)
    ctx_t = ttrain.make_context(spec_t, task=0, update_rule=TRule(),
                                device="cpu", **common)
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (44, PX, PX, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (44,)).astype(np.int32)
    return model, ctx_j, ctx_t, images, labels


def _jax_inputs(model):
    params = jax.tree_util.tree_map(jnp.asarray, model["params"])
    bank = {"kernel": jnp.asarray(model["heads"]["kernel"]),
            "bias": jnp.asarray(model["heads"]["bias"]),
            "class_counts": np.asarray(model["heads"]["class_counts"])}
    return params, bank


def _assert_tree_close(port_tree: dict, jax_tree, rtol, atol):
    got = params_to_jax(port_tree)
    for key_path, want in jax.tree_util.tree_flatten_with_path(
            jio.to_host(jax_tree))[0]:
        leaf = got
        for k in key_path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, want, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(key_path))


# 44 rows: batch 16 leaves a ragged tail of 12, batch 11 none
@pytest.mark.parametrize("task,batch", [(0, 16), (1, 16), (0, 11)])
def test_ewc_fisher_matches_the_jax_package(setup, task, batch):
    model, ctx_j, ctx_t, images, labels = setup
    params, bank = _jax_inputs(model)
    want = jimp.ewc_fisher(ctx_j, params, {}, bank, task,
                           jnp.asarray(images), jnp.asarray(labels), batch)
    got = timp.ewc_fisher(ctx_t, params_from_jax(model["params"]), {},
                          model["heads"], task, images, labels, batch)
    _assert_tree_close(got, want, rtol=1e-4, atol=1e-7)
    assert all(bool((v >= 0).all()) for v in got.values())


# 44 rows: chunk 16 leaves a ragged tail, chunk 4 none
@pytest.mark.parametrize("task,chunk", [(0, 16), (1, 16), (1, 4)])
def test_mas_importance_matches_the_jax_package(setup, task, chunk):
    model, ctx_j, ctx_t, images, _ = setup
    params, bank = _jax_inputs(model)
    want = jimp.mas_importance(ctx_j, params, {}, bank, task,
                               jnp.asarray(images), chunk=chunk)
    got = timp.mas_importance(ctx_t, params_from_jax(model["params"]), {},
                              model["heads"], task, images, chunk=chunk)
    _assert_tree_close(got, want, rtol=1e-4, atol=1e-7)


def test_mas_through_the_exact_conv_function_matches_f_conv2d(
        setup, monkeypatch):
    """MAS's ``vmap(grad)`` with every conv forced through
    ``Conv2dExactWeightGrad`` (the card's float32 route, its weight
    gradient one batched GEMM a chunk) against the CPU's ``F.conv2d``
    route, both with the convs in float64: 1e-12 of each leaf's largest
    entry."""
    model, _, _, images, _ = setup
    spec = treg.parse_model_name("", NAME, (PX, PX),
                                 compute_dtype=torch.float64)
    ctx = ttrain.make_context(spec, task=0, n_tasks=2, class_counts=COUNTS,
                              mean=MEAN, std=STD, update_rule=TRule(),
                              augment=False, device="cpu")
    params = {k: v.double()
              for k, v in params_from_jax(model["params"]).items()}

    def omega():  # 20 rows in chunks of 8: the last one ragged
        return timp.mas_importance(ctx, params, {}, model["heads"], 1,
                                   images[:20], chunk=8)

    want = omega()
    grads = []
    monkeypatch.setattr(
        tbackbones, "conv2d",
        lambda x, w, b=None, stride=1, padding=0:
        tconv.Conv2dExactWeightGrad.apply(x, w, b, stride, padding))
    monkeypatch.setattr(tconv, "weight_grad",
                        lambda *a, **k: grads.append(a[0].dtype)
                        or _weight_grad(*a, **k))
    got = omega()
    n_convs = sum(name.startswith("conv_") for name in ctx.backbone.features)
    assert grads == [torch.float64] * (3 * n_convs)  # a call a conv a chunk
    for k, v in want.items():
        tol = 1e-12 * float(v.abs().max())
        assert float((got[k] - v).abs().max()) <= tol, k


_weight_grad = tconv.weight_grad


def test_fisher_is_the_squared_batch_sum_not_the_mean_of_squares(setup):
    """One batch of all rows against per-row batches: the estimator squares
    the batch-summed gradient, so the two differ."""
    model, _, ctx_t, images, labels = setup
    params = params_from_jax(model["params"])
    whole = timp.ewc_fisher(ctx_t, params, {}, model["heads"], 0,
                            images[:8], labels[:8], 8)
    rows = timp.ewc_fisher(ctx_t, params, {}, model["heads"], 0,
                           images[:8], labels[:8], 1)
    name = "trunk.fc_1.weight"
    assert not torch.allclose(whole[name], rows[name], rtol=1e-2, atol=0)


def test_importance_takes_tensors_already_on_the_device(setup):
    model, _, ctx_t, images, labels = setup
    params = params_from_jax(model["params"])
    a = timp.ewc_fisher(ctx_t, params, {}, model["heads"], 0, images,
                        labels, 16)
    b = timp.ewc_fisher(ctx_t, params, {}, model["heads"], 0,
                        torch.from_numpy(images), torch.from_numpy(labels),
                        16)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("which", ["ewc", "mas"])
def test_a_split_over_the_budget_raises_naming_streaming(setup, which,
                                                         monkeypatch):
    """A split over the device data budget streams through chunks (it
    raised before streaming was ported; the name is kept): at a budget of
    0 each chunk is one batch, the last one short, and the chunks' rescaled
    sum is the resident value, rtol 1e-5 (float32 sums in another
    order)."""
    model, _, ctx_t, images, labels = setup
    params = params_from_jax(model["params"])

    def run():
        if which == "ewc":
            return timp.ewc_fisher(ctx_t, params, {}, model["heads"], 0,
                                   images, labels, 16)
        return timp.mas_importance(ctx_t, params, {}, model["heads"], 0,
                                   images)

    resident = run()
    chunks = []
    accumulate = timp._accumulate_chunked
    monkeypatch.setattr(timp, "_accumulate_chunked", lambda f, x, y, rows: (
        chunks.append(rows), accumulate(f, x, y, rows))[1])
    monkeypatch.setenv("CLSURVEY_DATA_BUDGET_MB", "0")
    streamed = run()
    assert chunks == [16]  # one batch (EWC) or vmap chunk (MAS) a chunk
    for k, v in resident.items():
        torch.testing.assert_close(streamed[k], v, rtol=1e-5, atol=1e-9)
