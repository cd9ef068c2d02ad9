"""2-D convolution whose float32 weight gradient on the card is exact to
float32.

cuDNN 9.2, through PyTorch's v8/v9 engine interface (the only one that
runs bf16 convolutions), chose for float32 weight gradients engines far
less exact than float32 on an H100: AlexNet's 5x5 conv at batch 200 came
out 1.7e-2 of the largest entry off float64, small_VGG9's 3x3 convs up to
8.4e-5, while the forward and the input gradient stayed within 2.5e-6
(``python -m clsurvey_torch.utils.conv_precision`` measures both routes).

So :func:`conv2d` keeps cuDNN's forward and input gradient, and computes a
float32 weight gradient on the card as one GEMM over (batch x output
pixels) in cuBLAS, TF32 off (``utils/device.py``): the input's patches
written out a chunk of rows at a time, each chunk's product added into
the gradient. Under ``torch.func.vmap(grad)`` (MAS's per-sample pass,
``ops/importance.py``) the ``vmap`` rules fold the samples into the
batch, as ``ops/pool.py``'s do: one ``F.conv2d`` forward, one input
gradient, and each sample's weight gradient ``dy_v^T @ patches_v`` as one
batched GEMM a chunk of samples. bfloat16 and the CPU go to ``F.conv2d``
unchanged."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# bytes of patches a chunk of rows may write out
CHUNK_BYTES = 256 << 20


def weight_grad(x: torch.Tensor, dy: torch.Tensor, w_shape, stride: int,
                padding: int, samples: int | None = None,
                chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """d loss / d weight of ``F.conv2d(x, w, stride=, padding=)`` given the
    output cotangent ``dy``: the sum over rows and output pixels of ``dy``
    times the input patch, ``dy^T @ patches``, a chunk of rows at a time.
    The patches are strided windows of the NHWC input (``Tensor.unfold``),
    written out once as a (pixels, C_in kh kw) matrix for the GEMM. With
    ``samples`` = V the rows are V samples' one after another, and the
    result is each sample's gradient, (V, *w_shape): a chunk of whole
    samples a batched GEMM."""
    cout, cin, kh, kw = w_shape
    n, _, oh, ow = dy.shape
    v = samples or 1
    per = n // v  # rows of one sample
    width = cin * kh * kw
    rows = max(1, chunk_bytes // (oh * ow * width * x.element_size()))
    if samples:
        rows = max(per, rows // per * per)
    x_nhwc = x.permute(0, 2, 3, 1)  # free for channels_last
    dy_rows = dy.permute(0, 2, 3, 1)
    gw = torch.zeros(v, cout, width, device=x.device, dtype=x.dtype)
    for i in range(0, n, rows):
        xp = x_nhwc[i:i + rows]
        if padding:
            xp = F.pad(xp, (0, 0, padding, padding, padding, padding))
        patches = xp.unfold(1, kh, stride).unfold(2, kw, stride)
        k = xp.shape[0] // per  # samples in the chunk
        if samples:
            gw[i // per:i // per + k].baddbmm_(
                dy_rows[i:i + rows].reshape(k, -1, cout).transpose(1, 2),
                patches.reshape(k, -1, width))
        else:
            gw[0].addmm_(dy_rows[i:i + rows].reshape(-1, cout).t(),
                         patches.reshape(-1, width))  # (b oh ow, C_in kh kw)
    return gw.view(v, *w_shape) if samples else gw.view(w_shape)


def _fold(t: torch.Tensor, dim: int | None, v: int) -> torch.Tensor:
    """A vmapped operand ``(.., V at dim, ..)`` -> ``(V*B, C, H, W)``; one
    that is not batched (``dim`` None) is repeated."""
    t = t.unsqueeze(0).expand(v, *t.shape) if dim is None \
        else t.movedim(dim, 0)
    return t.reshape(v * t.shape[1], *t.shape[2:])


def _unbatched(in_dims, what: str) -> None:
    if any(d is not None for d in in_dims):
        raise NotImplementedError(
            f"conv2d under vmap: a batched {what} (only the input and its "
            "cotangent may carry the vmapped dimension)")


class Conv2dBackward(torch.autograd.Function):
    """The backward of :class:`Conv2dExactWeightGrad` as a function of its
    own, so that its ``vmap`` rule sees real tensors under ``torch.func``
    (the pool's ``MaxPool2x2Backward`` pattern). Returns (input, weight,
    bias) gradients, None where ``needs`` says so."""

    @staticmethod
    def forward(x, weight, dy, stride: int, padding: int, needs: tuple):
        gx = gw = gb = None
        if needs[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, weight, dy,
                                            stride=stride, padding=padding)
        if needs[1]:
            gw = weight_grad(x, dy, weight.shape, stride, padding)
        if needs[2]:
            gb = dy.sum((0, 2, 3))
        return gx, gw, gb

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "conv2d's exact weight gradient is differentiable once")

    @staticmethod
    def vmap(info, in_dims, x, weight, dy, stride, padding, needs):
        _unbatched(in_dims[1:2], "weight")
        v = info.batch_size
        xf, dyf = _fold(x, in_dims[0], v), _fold(dy, in_dims[2], v)
        gx = gw = gb = None
        if needs[0]:
            gx = torch.nn.grad.conv2d_input(xf.shape, weight, dyf,
                                            stride=stride, padding=padding)
            gx = gx.view(v, -1, *gx.shape[1:])
        if needs[1]:
            gw = weight_grad(xf, dyf, weight.shape, stride, padding,
                             samples=v)
        if needs[2]:
            gb = dyf.view(v, -1, *dyf.shape[1:]).sum((1, 3, 4))
        return (gx, gw, gb), tuple(None if g is None else 0
                                   for g in (gx, gw, gb))


class Conv2dExactWeightGrad(torch.autograd.Function):
    """``F.conv2d`` forward and input gradient; :func:`weight_grad`. Under
    ``torch.func.vmap`` the samples fold into the batch: one ``F.conv2d``
    forward, and :class:`Conv2dBackward`'s rule for the gradients."""

    @staticmethod
    def forward(x, weight, bias, stride: int, padding: int):
        return F.conv2d(x, weight, bias, stride=stride, padding=padding)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, bias, stride, padding = inputs
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.padding = stride, padding
        ctx.has_bias = bias is not None

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                 ctx.has_bias and ctx.needs_input_grad[2])
        gx, gw, gb = Conv2dBackward.apply(x, weight, dy, ctx.stride,
                                          ctx.padding, needs)
        return gx, gw, gb, None, None

    @staticmethod
    def vmap(info, in_dims, x, weight, bias, stride, padding):
        _unbatched(in_dims[1:3], "weight or bias")
        v = info.batch_size
        y = F.conv2d(_fold(x, in_dims[0], v), weight, bias, stride=stride,
                     padding=padding)
        return y.view(v, -1, *y.shape[1:]), 0


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """``F.conv2d`` (square stride and padding), with an exact float32
    weight gradient on the card (:class:`Conv2dExactWeightGrad`)."""
    if (x.is_cuda and x.dtype == torch.float32
            and weight.dtype == torch.float32):
        return Conv2dExactWeightGrad.apply(x, weight, bias, stride, padding)
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)
