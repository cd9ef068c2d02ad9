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
the gradient. bfloat16, the CPU, and ``torch.func`` transforms (the
importance passes' ``vmap(grad)``) go to ``F.conv2d`` unchanged."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# bytes of patches a chunk of rows may write out
CHUNK_BYTES = 256 << 20


def weight_grad(x: torch.Tensor, dy: torch.Tensor, w_shape, stride: int,
                padding: int, chunk_bytes: int = CHUNK_BYTES
                ) -> torch.Tensor:
    """d loss / d weight of ``F.conv2d(x, w, stride=, padding=)`` given the
    output cotangent ``dy``: the sum over rows and output pixels of ``dy``
    times the input patch, ``dy^T @ patches``, a chunk of rows at a time.
    The patches are strided windows of the NHWC input (``Tensor.unfold``),
    written out once as a (pixels, C_in kh kw) matrix for the GEMM."""
    cout, cin, kh, kw = w_shape
    n, _, oh, ow = dy.shape
    width = cin * kh * kw
    rows = max(1, chunk_bytes // (oh * ow * width * x.element_size()))
    x_nhwc = x.permute(0, 2, 3, 1)  # free for channels_last
    dy_rows = dy.permute(0, 2, 3, 1)
    gw = torch.zeros(cout, width, device=x.device, dtype=x.dtype)
    for i in range(0, n, rows):
        xp = x_nhwc[i:i + rows]
        if padding:
            xp = F.pad(xp, (0, 0, padding, padding, padding, padding))
        patches = xp.unfold(1, kh, stride).unfold(2, kw, stride)
        gw.addmm_(dy_rows[i:i + rows].reshape(-1, cout).t(),
                  patches.reshape(-1, width))  # (b oh ow, C_in kh kw)
    return gw.view(w_shape)


class Conv2dExactWeightGrad(torch.autograd.Function):
    """``F.conv2d`` forward and input gradient; :func:`weight_grad`."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride: int, padding: int):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.padding = stride, padding
        ctx.has_bias = bias is not None
        return F.conv2d(x, weight, bias, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, weight, dy,
                                            stride=ctx.stride,
                                            padding=ctx.padding)
        if ctx.needs_input_grad[1]:
            gw = weight_grad(x, dy, weight.shape, ctx.stride, ctx.padding)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = dy.sum((0, 2, 3))
        return gx, gw, gb, None, None


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """``F.conv2d`` (square stride and padding), with an exact float32
    weight gradient on the card (:class:`Conv2dExactWeightGrad`)."""
    if (x.is_cuda and x.dtype == torch.float32
            and weight.dtype == torch.float32
            and not torch._C._are_functorch_transforms_active()):
        return Conv2dExactWeightGrad.apply(x, weight, bias, stride, padding)
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)
