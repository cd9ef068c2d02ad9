"""2x2 stride-2 max-pool on NHWC with an argmax-routed backward.

Counterpart of ``clsurvey_tpu/ops/pool_pallas.py`` (``maxpool2x2`` and
``pool2x2``). The forward stores a 1-byte argmax code per output cell
(0..3, row-major in the window); the backward routes the cotangent to that
position and writes 0 at the other three. On a CUDA tensor the pair runs
kernels B1 and B2 (``csrc/pool.cu``); on a CPU tensor it runs the plain
PyTorch versions :func:`pool_fwd_plain` / :func:`pool_bwd_plain`.
:func:`pool_route` picks each launch's route: ``vec`` (16-byte accesses, V
channels a thread) where C and the pointers allow it, else ``scalar``.

Ties go to the first maximum in window order, through the same three
compares as the JAX kernel (``a>=b``, ``d>=e``, top ``>=`` bottom), which
is XLA select-and-scatter's rule. Odd H or W pool with VALID floor
semantics; the dropped row / column gets a zero gradient.

Unlike the JAX package there is no ``CLSURVEY_PALLAS_POOL`` gate: the pool
always goes through this pair, whose max equals ``reduce_window``'s."""

from __future__ import annotations

import torch

from clsurvey_torch.ops import _kernels

_DTYPES = (torch.float32, torch.bfloat16)
# channels a thread of the vec route owns: 16 bytes of one window position
VEC_WIDTH = {torch.float32: 4, torch.bfloat16: 8}
ROUTE_CODES = {"scalar": 0, "vec": 1}


def pool_route(x_shape, dtype: torch.dtype, data_ptrs, code_ptr: int) -> str:
    """The route of a B1 / B2 launch on an input of ``x_shape`` (NHWC) in
    ``dtype``: ``"vec"`` where C is a multiple of V (8 bfloat16 or 4
    float32 channels, 16 bytes), every data pointer (B1: input and values;
    B2: cotangent and dx) is 16-byte aligned, the code pointer V-byte
    aligned and the sizes fit its 32-bit index math; else ``"scalar"``.
    ``csrc/pool.cu`` refuses a vec launch this does not allow."""
    b, h, w, c = x_shape
    v = VEC_WIDTH.get(dtype)
    if (v is None or c % v or any(p % 16 for p in data_ptrs) or code_ptr % v
            or b * (h // 2) >= 2 ** 31 or w * c >= 2 ** 24):
        return "scalar"
    return "vec"


def pool_fwd_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel B1: (values, uint8 codes), both NHWC."""
    b, h, w, c = x.shape
    ho, wo = h // 2, w // 2
    win = x[:, :2 * ho, :2 * wo, :].reshape(b, ho, 2, wo, 2, c)
    a, bb = win[:, :, 0, :, 0], win[:, :, 0, :, 1]
    d, e = win[:, :, 1, :, 0], win[:, :, 1, :, 1]
    zero = torch.zeros((), dtype=torch.uint8, device=x.device)
    one, two, three = zero + 1, zero + 2, zero + 3
    t_ge = a >= bb
    val_t, idx_t = torch.where(t_ge, a, bb), torch.where(t_ge, zero, one)
    b_ge = d >= e
    val_b, idx_b = torch.where(b_ge, d, e), torch.where(b_ge, two, three)
    f_ge = val_t >= val_b
    return torch.where(f_ge, val_t, val_b), torch.where(f_ge, idx_t, idx_b)


def pool_bwd_plain(g: torch.Tensor, code: torch.Tensor,
                   x_shape) -> torch.Tensor:
    """Plain version of kernel B2: scatter ``g`` to the coded positions."""
    b, h, w, c = x_shape
    ho, wo = h // 2, w // 2
    zero = torch.zeros_like(g)
    parts = [torch.where(code == k, g, zero) for k in range(4)]
    # (b, ho, wo, c, 2, 2) -> (b, ho, 2, wo, 2, c): code k = 2*row + col
    win = torch.stack(parts, dim=-1).view(b, ho, wo, c, 2, 2)
    win = win.permute(0, 1, 4, 2, 5, 3).reshape(b, 2 * ho, 2 * wo, c)
    if (h, w) == (2 * ho, 2 * wo):
        return win.contiguous()
    dx = g.new_zeros((b, h, w, c))
    dx[:, :2 * ho, :2 * wo] = win
    return dx


def _check_input(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous NHWC float32/bfloat16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")


def _pool_fwd_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _check_input(x, "kernel B1")
    b, h, w, c = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"kernel B1 needs H, W >= 2, got {tuple(x.shape)}")
    out_shape = (b, h // 2, w // 2, c)
    val = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    code = torch.empty(out_shape, dtype=torch.uint8, device=x.device)
    route = pool_route(x.shape, x.dtype, (x.data_ptr(), val.data_ptr()),
                       code.data_ptr())
    fn = _kernels.lib("pool").clsurvey_pool_fwd_route
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), val.data_ptr(), code.data_ptr(), b, h, w, c,
                int(x.dtype == torch.bfloat16), ROUTE_CODES[route],
                torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.record_launch(rc, "pool_fwd", b, route)
    return val, code


def _pool_bwd_cuda(g: torch.Tensor, code: torch.Tensor,
                   x_shape) -> torch.Tensor:
    _check_input(g, "kernel B2")
    b, h, w, c = x_shape
    out_shape = (b, h // 2, w // 2, c)
    if tuple(g.shape) != out_shape or tuple(code.shape) != out_shape \
            or code.dtype != torch.uint8 or not code.is_contiguous() \
            or code.device != g.device:
        raise ValueError(f"kernel B2: cotangent {tuple(g.shape)} and code "
                         f"{tuple(code.shape)} must both be {out_shape}")
    dx = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    route = pool_route(x_shape, g.dtype, (g.data_ptr(), dx.data_ptr()),
                       code.data_ptr())
    fn = _kernels.lib("pool").clsurvey_pool_bwd_route
    with torch.cuda.device(g.device):
        rc = fn(g.data_ptr(), code.data_ptr(), dx.data_ptr(), b, h, w, c,
                int(g.dtype == torch.bfloat16), ROUTE_CODES[route],
                torch.cuda.current_stream(g.device).cuda_stream)
    _kernels.record_launch(rc, "pool_bwd", b, route)
    return dx


def pool_fwd(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return _pool_fwd_cuda(x)
    if x.device.type != "cpu":
        raise ValueError(f"no pool path for {x.device}")
    return pool_fwd_plain(x)


def pool_bwd(g: torch.Tensor, code: torch.Tensor, x_shape) -> torch.Tensor:
    """Kernel B2 on a CUDA tensor, its plain version on a CPU tensor."""
    if g.device.type == "cuda":
        return _pool_bwd_cuda(g, code, x_shape)
    if g.device.type != "cpu":
        raise ValueError(f"no pool path for {g.device}")
    return pool_bwd_plain(g, code, x_shape)


def _fold(t: torch.Tensor, dim: int | None, v: int) -> torch.Tensor:
    """A vmapped operand ``(.., V at dim, ..)`` -> ``(V*B, H, W, C)``: the
    pool is independent per sample, so the vmapped dimension folds into the
    batch. An operand that is not batched (``dim`` None) is repeated."""
    t = t.unsqueeze(0).expand(v, *t.shape) if dim is None \
        else t.movedim(dim, 0)
    return t.reshape(v * t.shape[1], *t.shape[2:]).contiguous()


class MaxPool2x2Backward(torch.autograd.Function):
    """Kernel B2 as a function of its own, so that the backward of
    :class:`MaxPool2x2` also runs under ``torch.func`` transforms (its
    ``vmap`` is the only place that sees real tensors there)."""

    @staticmethod
    def forward(g, code, x_shape):
        return pool_bwd(g.contiguous(), code, x_shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, gg):
        raise NotImplementedError(
            "pool2x2 is differentiable once: no double backward")

    @staticmethod
    def vmap(info, in_dims, g, code, x_shape):
        v = info.batch_size
        dx = pool_bwd(_fold(g, in_dims[0], v), _fold(code, in_dims[1], v),
                      (v * x_shape[0], *x_shape[1:]))
        return dx.view(v, *x_shape), 0


class MaxPool2x2(torch.autograd.Function):
    """The forward / backward pair, joined for autograd and for
    ``torch.func.vmap`` / ``grad`` (per-sample gradients): under ``vmap``
    one launch of B1 or B2 handles the folded ``(V*B, H, W, C)`` batch."""

    @staticmethod
    def forward(x):
        return pool_fwd(x)  # (values, codes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, code = output
        ctx.mark_non_differentiable(code)
        # or every backward is handed a zero tensor shaped like the codes
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(code)
        ctx.x_shape = tuple(inputs[0].shape)

    @staticmethod
    def backward(ctx, g, _g_code):
        if g is None:
            return None
        (code,) = ctx.saved_tensors
        return MaxPool2x2Backward.apply(g, code, ctx.x_shape)

    @staticmethod
    def vmap(info, in_dims, x):
        v = info.batch_size
        val, code = pool_fwd(_fold(x, in_dims[0], v))
        shape = (v, val.shape[0] // v, *val.shape[1:])
        return (val.view(shape), code.view(shape)), (0, 0)


def pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool of an NHWC tensor, differentiable."""
    return MaxPool2x2.apply(x)[0]
