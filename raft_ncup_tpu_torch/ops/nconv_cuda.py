"""Fused normalized convolution: the wrapper around the CUDA kernel
``csrc/nconv.cu`` and its plain PyTorch version.

Counterpart of ``raft_ncup_tpu/ops/nconv_pallas.py``'s ``nconv2d_fused``
(Pallas kernel ``_kernel``). The function, on NCHW planes with an OIHW
non-negative weight, stride 1 and SAME zero padding:

    out      = conv(data * conf, w) / (conv(conf, w) + eps) + bias
    conf_out = conv(conf, w) / sum(w)   (per output channel)

:func:`nconv2d_fused` is the wrapper. For a CPU tensor it runs the plain
version, :func:`nconv2d_plain` (the two-convolution composition of the
JAX package's ``ops/nconv.py``); for a CUDA tensor it launches the kernel
or raises. ``nconv2d_fused.launches`` counts the launches. The kernel has
no size gate; it takes odd k <= 7 and at most 8 output channels, which
covers every NCUP layer.

When an input needs a gradient, the call goes through an
``autograd.Function`` whose backward is :func:`nconv2d_backward`: the
hand-written backward kernel ``csrc/nconv_bwd.cu`` on the card
(``.launches`` counts it), the plain :func:`nconv2d_backward_plain` on
the CPU. Both compute the VJP that the JAX op takes of its XLA
composition (``nconv_pallas.py:179``) by JAX's own formulas, so a window
without confidence gives the NaN that ``jax.vjp`` gives there.

``rows=(first, count)`` keeps only those output rows (a band of rows
extended by its neighbours' halos, ``ops/nconv.py``): the kernel runs on
the whole input, and the backward sees the dropped rows as outputs with
zero gradient whose saved denominator is nonzero, so they add exactly
nothing, where their windows (which may hold no confidence at a band's
edge) would otherwise bring JAX's NaN into the kept rows' gradients.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from raft_ncup_tpu_torch.ops import cuda_build
from raft_ncup_tpu_torch.utils.device import f32_precision

KERNEL = "nconv"
KERNEL_BWD = "nconv_bwd"
SOURCE = "raft_ncup_tpu_torch/csrc/nconv.cu"
KERNEL_SIZES = (1, 3, 5, 7)
MAX_COUT = 8
MAX_WEIGHTS = 4096


@f32_precision()
def nconv2d_plain(
    data: torch.Tensor,
    conf: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    eps: float = 1e-20,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: two convolutions (TF32 off), a divide
    and a scale. data, conf: (B, Cin, H, W); weight: (Cout, Cin, k, k)."""
    pad = weight.shape[-1] // 2
    denom = F.conv2d(conf, weight, padding=pad)
    nomin = F.conv2d(data * conf, weight, padding=pad)
    out = nomin / (denom + eps)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    s = weight.sum(dim=(1, 2, 3))
    return out, denom / s.view(1, -1, 1, 1)


@f32_precision()
def nconv2d_backward_plain(
    data, conf, weight, bias, out, conf_out, g_out, g_conf, eps: float = 1e-20
):
    """Plain version of the backward kernel: ``(d data, d conf, d weight,
    d bias)`` from the forward's operands, its outputs and their upstream
    gradients (None for zero), by the explicit formulas of
    ``csrc/nconv_bwd.cu`` with PyTorch's convolution gradients (TF32 off).
    d bias is None without a bias. N and D are recovered from the outputs:
    D = conf_out * s and N = (out - bias) * (D + eps); gD takes JAX's
    division VJP term for term, (-g * N) * (1 / (D + eps)^2)."""
    pad = weight.shape[-1] // 2
    s = weight.sum(dim=(1, 2, 3)).view(1, -1, 1, 1)
    go = torch.zeros_like(out) if g_out is None else g_out
    gc = torch.zeros_like(out) if g_conf is None else g_conf
    y = conf_out * s + eps
    n = (out if bias is None else out - bias.view(1, -1, 1, 1)) * y
    g_n = go / y
    g_d = (-go * n) * (1.0 / (y * y)) + gc / s
    conv_in = torch.nn.grad.conv2d_input
    conv_w = torch.nn.grad.conv2d_weight
    g_dc = conv_in(data.shape, weight, g_n, padding=pad)
    g_c = conv_in(conf.shape, weight, g_d, padding=pad)
    d_weight = conv_w(data * conf, weight.shape, g_n, padding=pad) + conv_w(
        conf, weight.shape, g_d, padding=pad
    )
    d_weight = d_weight - ((gc * conf_out).sum(dim=(0, 2, 3)) / s.view(-1)).view(-1, 1, 1, 1)
    d_bias = None if bias is None else go.sum(dim=(0, 2, 3))
    return g_dc * conf, g_dc * data + g_c, d_weight, d_bias


_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = cuda_build.load(KERNEL)
        fn = lib.nconv_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p,
        ]
        _fn = (lib, fn)
    return _fn


def _check_operands(data, conf, weight, bias) -> None:
    tensors = [data, conf, weight] + ([] if bias is None else [bias])
    for t in tensors:
        if t.device != data.device:
            raise ValueError(f"nconv: tensors on {t.device} and {data.device}")
        if t.dtype != torch.float32:
            # The upsampler runs f32 under every precision preset.
            raise TypeError(f"nconv: f32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("nconv: operands must be contiguous")
    if data.dim() != 4 or conf.shape != data.shape:
        raise ValueError(
            f"nconv: data {tuple(data.shape)} / conf {tuple(conf.shape)} "
            "are not one (B, Cin, H, W) shape"
        )
    cout, cin, kh, kw = weight.shape
    if (
        cin != data.shape[1] or kh != kw or kh not in KERNEL_SIZES
        or cout > MAX_COUT or cout * cin * kh * kw > MAX_WEIGHTS
    ):
        raise ValueError(
            f"nconv: weight {tuple(weight.shape)} unsupported for data "
            f"{tuple(data.shape)} (odd square k in {KERNEL_SIZES}, "
            f"Cout <= {MAX_COUT})"
        )
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f"nconv: bias {tuple(bias.shape)} is not ({cout},)")


def nconv2d_fused(
    data: torch.Tensor,
    conf: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    eps: float = 1e-20,
    rows: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: (B, Cin, H, W) data and conf, (Cout, Cin, k, k)
    weight -> ``(out, conf_out)``, each (B, Cout, H, W) f32, or only the
    output rows ``rows = (first, count)``.

    A CPU tensor takes :func:`nconv2d_plain`; a CUDA tensor launches the
    kernel on the current stream or raises. With an input that needs a
    gradient the call is differentiable (:class:`_NConv`)."""
    inputs = (data, conf, weight) + (() if bias is None else (bias,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _NConv.apply(data, conf, weight, bias, eps, rows)
    out, conf_out = _nconv_forward(data, conf, weight, bias, eps)
    if rows is None:
        return out, conf_out
    return _keep_rows(out, rows), _keep_rows(conf_out, rows)


def _keep_rows(t: torch.Tensor, rows: tuple[int, int]) -> torch.Tensor:
    return t[:, :, rows[0]:rows[0] + rows[1]].contiguous()


nconv2d_fused.launches = 0
# A list while ``inference.costs.counting_flops`` counts a run: each launch
# appends its operations (``nconv_work``).
nconv2d_fused.work_log = None


def nconv_work(B, H, W, k, cin, cout) -> tuple[int, int]:
    """(bytes, operations) of one fused NConv2d: data, conf and weight read
    once, out and conf_out written once; per in-bounds tap and input
    channel one multiply (data*conf) and two multiply-adds per output
    channel, plus a divide, a bias add and a scale per output."""
    p = k // 2

    def along(n):  # in-bounds taps along one axis of n pixels
        return sum(max(0, n - abs(d)) for d in range(-p, p + 1))

    taps = along(H) * along(W)  # in-bounds, per plane
    nbytes = 4 * (2 * B * cin * H * W + cout * cin * k * k + 2 * B * cout * H * W)
    flops = B * cin * taps * (1 + 4 * cout) + 3 * B * cout * H * W
    return nbytes, flops


def _nconv_forward(data, conf, weight, bias, eps):
    if data.device.type == "cpu":
        return nconv2d_plain(data, conf, weight, bias, eps)
    if data.device.type != "cuda":
        raise ValueError(f"nconv: unsupported device {data.device}")
    _check_operands(data, conf, weight, bias)
    lib, fn = _launcher()
    B, cin, H, W = data.shape
    cout, _, k, _ = weight.shape
    out = torch.empty((B, cout, H, W), dtype=torch.float32, device=data.device)
    conf_out = torch.empty_like(out)
    rc = fn(
        data.data_ptr(), conf.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(), conf_out.data_ptr(), B, cin, cout, H, W, k, eps,
        data.device.index, torch.cuda.current_stream(data.device).cuda_stream,
    )
    cuda_build.check(rc, lib, "nconv_f32")
    nconv2d_fused.launches += 1
    if nconv2d_fused.work_log is not None:
        nconv2d_fused.work_log.append(nconv_work(B, H, W, k, cin, cout)[1])
    return out, conf_out


class _NConv(torch.autograd.Function):
    """The fused NConv2d with its backward: the forward kernel (or plain
    version) forward, :func:`nconv2d_backward` backward. Saves its inputs
    and outputs, from which the backward recovers N and D. With ``rows``
    it returns those output rows only; the saved outputs of the others
    read as D = 1 (``conf_out = 1 / sum(w)``) and N = 0, and their
    gradients are zero, so the backward adds nothing from them."""

    @staticmethod
    def forward(ctx, data, conf, weight, bias, eps, rows=None):
        out, conf_out = _nconv_forward(data, conf, weight, bias, eps)
        ctx.eps, ctx.rows = eps, rows
        saved_out, saved_conf = out, conf_out
        if rows is not None:
            first, count = rows
            dropped = torch.ones(out.shape[2], dtype=torch.bool, device=out.device)
            dropped[first:first + count] = False
            dropped = dropped.view(1, 1, -1, 1)
            s = weight.sum(dim=(1, 2, 3)).view(1, -1, 1, 1)
            saved_conf = torch.where(dropped, 1.0 / s, conf_out)
            saved_out = torch.where(dropped, torch.zeros_like(out) if bias is None
                                    else bias.view(1, -1, 1, 1).expand_as(out), out)
            out, conf_out = _keep_rows(out, rows), _keep_rows(conf_out, rows)
        ctx.save_for_backward(data, conf, weight, bias, saved_out, saved_conf)
        ctx.set_materialize_grads(False)
        return out, conf_out

    @staticmethod
    def backward(ctx, g_out, g_conf):
        data, conf, weight, bias, out, conf_out = ctx.saved_tensors
        if ctx.rows is not None:
            g_out, g_conf = (None if g is None else _full_rows(g, ctx.rows, out.shape[2])
                             for g in (g_out, g_conf))
        d_data, d_conf, d_weight, d_bias = nconv2d_backward(
            data, conf, weight, bias, out, conf_out,
            None if g_out is None else g_out.contiguous(),
            None if g_conf is None else g_conf.contiguous(), ctx.eps,
        )
        return d_data, d_conf, d_weight, d_bias, None, None


def _full_rows(g: torch.Tensor, rows: tuple[int, int], height: int) -> torch.Tensor:
    """The gradient of kept rows ``rows`` placed in zeros of ``height`` rows."""
    full = g.new_zeros(g.shape[:2] + (height,) + g.shape[3:])
    full[:, :, rows[0]:rows[0] + rows[1]] = g
    return full


_bwd_fn = None


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        lib = cuda_build.load(KERNEL_BWD)
        fn = lib.nconv_bwd_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        scratch = lib.nconv_bwd_scratch_floats
        scratch.restype = ctypes.c_longlong
        scratch.argtypes = [ctypes.c_int] * 6
        _bwd_fn = (lib, fn, scratch)
    return _bwd_fn


def nconv2d_backward(
    data, conf, weight, bias, out, conf_out, g_out, g_conf, eps: float = 1e-20
):
    """The backward kernel's wrapper: the forward's operands, its outputs
    and their upstream gradients (each (B, Cout, H, W) f32 or None for
    zero) -> ``(d data, d conf, d weight, d bias)``; d bias is None without
    a bias.

    A CPU tensor takes :func:`nconv2d_backward_plain`; a CUDA tensor
    launches the kernel on the current stream or raises. d weight and
    d bias are summed over the kernel's tiles in a fixed order, so they
    are equal bit for bit from run to run."""
    if data.device.type == "cpu":
        return nconv2d_backward_plain(
            data, conf, weight, bias, out, conf_out, g_out, g_conf, eps
        )
    if data.device.type != "cuda":
        raise ValueError(f"nconv: unsupported device {data.device}")
    _check_operands(data, conf, weight, bias)
    B, cin, H, W = data.shape
    cout, _, k, _ = weight.shape
    for t in (out, conf_out, g_out, g_conf):
        if t is not None and (
            t.device != data.device or t.dtype != torch.float32
            or not t.is_contiguous() or t.shape != (B, cout, H, W)
        ):
            raise ValueError(
                f"nconv backward: {tuple(t.shape)} {t.dtype} is not a contiguous "
                f"f32 ({B}, {cout}, {H}, {W}) on {data.device}"
            )
    lib, fn, scratch = _bwd_launcher()
    d_data = torch.empty_like(data)
    d_conf = torch.empty_like(conf)
    d_weight = torch.empty_like(weight)
    d_bias = None if bias is None else torch.empty_like(bias)
    # Each block's partial sums of d weight, d bias and the weight-sum term,
    # which the kernel's second launch adds up in a fixed order.
    part = torch.empty(
        max(scratch(B, cin, cout, H, W, k), 1), dtype=torch.float32, device=data.device
    )

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = fn(
        data.data_ptr(), conf.data_ptr(), weight.data_ptr(), ptr(bias),
        out.data_ptr(), conf_out.data_ptr(), ptr(g_out), ptr(g_conf),
        d_data.data_ptr(), d_conf.data_ptr(), d_weight.data_ptr(), ptr(d_bias),
        part.data_ptr(), B, cin, cout, H, W, k, eps,
        data.device.index, torch.cuda.current_stream(data.device).cuda_stream,
    )
    cuda_build.check(rc, lib, "nconv_bwd_f32")
    nconv2d_backward.launches += 1
    return d_data, d_conf, d_weight, d_bias


nconv2d_backward.launches = 0
