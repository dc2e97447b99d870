"""The benchmark's yardstick of work: analytic FLOPs of a configuration,
frozen copies of the kernels' operation and byte counts, and the card's
peaks. Worked out from shapes (and, for the lookup, coordinates), so the
same work reads the same whatever implements it.

FLOPs count 2 per multiply-add of the convolutions and of the
correlation lookup's dot products (2 C per window tap, (2r+1)^2 taps a
level); elementwise work, norms and the bilinear blends are not counted.
The test-mode forward runs the upsampler once, after the loop; training
runs it every iteration. NCUP's NConv2d is two convolutions.

``lookup_work_from`` and ``nconv_work`` are copies of the port's
``ops/corr_cuda.lookup_work`` and ``ops/nconv_cuda.nconv_work``, the
first taking shapes and coordinates where the port's takes the tensors
(held equal to them by ``tests/test_flowbench_work.py``);
``lookup_bwd_work`` and ``nconv_bwd_work`` are copies of the backward
counts of the port's kernel smoke script (``chip_smoke.py``).
"""

from __future__ import annotations

import torch

# H100 SXM data sheet, dense, at 700 W: f32 outside the tensor cores (TF32
# is off under the f32 preset) and HBM3.
PEAKS = {"H100": {"f32_flops": 67e12, "bytes_per_s": 3.35e12}}


def peaks(device_name: str) -> dict:
    """The peaks of the card named ``device_name``; raises for another."""
    for fragment, p in PEAKS.items():
        if fragment in device_name:
            return p
    raise ValueError(f"no peak rates for {device_name!r}")


def conv(k: int, cin: int, cout: int, h: int, w: int, kw: int | None = None) -> float:
    return 2.0 * k * (k if kw is None else kw) * cin * cout * h * w


def encoder_flops(h: int, w: int, out_dim: int) -> float:
    """BasicEncoder on one (h, w) image."""
    h2, w2, h4, w4, h8, w8 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    f = conv(7, 3, 64, h2, w2) + 4 * conv(3, 64, 64, h2, w2)
    f += conv(3, 64, 96, h4, w4) + 3 * conv(3, 96, 96, h4, w4) + conv(1, 64, 96, h4, w4)
    f += conv(3, 96, 128, h8, w8) + 3 * conv(3, 128, 128, h8, w8) + conv(1, 96, 128, h8, w8)
    return f + conv(1, 128, out_dim, h8, w8)


def iteration_flops(cfg: dict, h8: int, w8: int) -> float:
    """One refinement iteration on one image: the lookup's dot products,
    the motion encoder, the SepConvGRU (hidden + context + motion input
    channels) and the flow head."""
    hdim, cdim = cfg["hidden_dim"], cfg["context_dim"]
    taps = cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2
    f = 2.0 * taps * cfg["fnet_dim"] * h8 * w8
    f += conv(1, taps, 256, h8, w8) + conv(3, 256, 192, h8, w8) + conv(7, 2, 128, h8, w8)
    f += conv(3, 128, 64, h8, w8) + conv(3, 256, 126, h8, w8)
    f += 6 * conv(1, hdim + cdim + 128, hdim, h8, w8, kw=5)
    return f + conv(3, hdim, 256, h8, w8) + conv(3, 256, 2, h8, w8)


def upsampler_flops(cfg: dict, H: int, W: int) -> float:
    """One upsampling of one image: RAFT's mask head, or NCUP's weights
    net at the x4 grid and its NConvUNet on each flow channel at full
    resolution (two convolutions per NConv2d)."""
    h8, w8 = H // 8, W // 8
    hdim = cfg["hidden_dim"]
    if cfg["model"] == "raft":
        return conv(3, hdim, 256, h8, w8) + conv(1, 256, 576, h8, w8)
    up = cfg["upsampler"]
    h4, w4 = H // 4, W // 4
    chans = (hdim + 2,) + tuple(up["weights_est_num_ch"]) + (2,)
    f = sum(conv(k, ci, co, h4, w4) for k, ci, co in
            zip(up["weights_est_filter_sz"], chans[:-1], chans[1:]))
    m = up["channels_multiplier"]
    ke, kd, ko = up["encoder_filter_sz"], up["decoder_filter_sz"], up["out_filter_sz"]
    unet = conv(ke, 1, m, H, W) + conv(ke, m, m, H, W) + conv(kd, 2 * m, m, H, W)
    unet += conv(ko, m, 1, H, W)
    return f + 2 * 2 * unet


def forward_flops(cfg: dict, batch: int, H: int, W: int, iters: int,
                  train: bool = False) -> float:
    """One forward of ``batch`` pairs at (H, W), padded size."""
    h8, w8 = H // 8, W // 8
    f = 2 * encoder_flops(H, W, cfg["fnet_dim"])
    f += encoder_flops(H, W, cfg["hidden_dim"] + cfg["context_dim"])
    f += iters * iteration_flops(cfg, h8, w8)
    f += (iters if train else 1) * upsampler_flops(cfg, H, W)
    return batch * f


def train_step_flops(cfg: dict, batch: int, H: int, W: int, iters: int) -> float:
    """Forward and backward as three forwards; the recompute is not counted."""
    return 3.0 * forward_flops(cfg, batch, H, W, iters, train=True)


# ------------------------------------------------------ frozen kernel work


def _along(n: int, p: int) -> int:
    return sum(max(0, n - abs(d)) for d in range(-p, p + 1))


def lookup_positions(coords: torch.Tensor, level_hw, radius: int) -> int:
    """In-bounds positions of the (2r+2)^2 patches of (..., 2) ``coords``
    over levels of sizes ``level_hw``."""
    K = 2 * radius + 1
    k1 = torch.arange(K + 1, device=coords.device, dtype=torch.float32)
    positions = 0
    for lvl, (hl, wl) in enumerate(level_hw):
        o = torch.floor(coords.reshape(-1, 2).float() / float(2 ** lvl)) - radius
        cx = (((o[:, 0:1] + k1) >= 0) & ((o[:, 0:1] + k1) < wl)).sum(1)
        cy = (((o[:, 1:2] + k1) >= 0) & ((o[:, 1:2] + k1) < hl)).sum(1)
        positions += int((cx * cy).sum())
    return positions


def level_sizes(h: int, w: int, levels: int) -> list:
    out = [(h, w)]
    for _ in range(levels - 1):
        out.append((out[-1][0] // 2, out[-1][1] // 2))
    return out


def lookup_work_from(coords, levels: int, radius: int, channels: int,
                     feature_bytes: int = 4, grid_hw=None) -> tuple[int, int]:
    """(bytes, operations) of one lookup, from shapes and (B, h, w, 2)
    ``coords`` on the level-0 grid: every input read once (features at
    ``feature_bytes``) and the output written once; two operations per
    multiply-add at in-bounds patch positions, plus 7 per output tap for
    the bilinear blend.
    ``grid_hw``: the whole level-0 grid, when ``coords`` are a band of its
    rows (the pyramid is the whole image's)."""
    B, h, w, _ = coords.shape
    K = 2 * radius + 1
    sizes = level_sizes(*(grid_hw or (h, w)), levels)
    n_out = B * h * w * levels * K * K
    nbytes = (feature_bytes * B * h * w * channels + 4 * coords.numel()
              + sum(feature_bytes * B * a * b * channels for a, b in sizes) + 4 * n_out)
    return nbytes, 2 * channels * lookup_positions(coords, sizes, radius) + 7 * n_out


def lookup_bwd_work(coords, levels: int, radius: int, channels: int,
                    with_coords: bool = False) -> tuple[int, int]:
    """(bytes, operations) of the lookup's backward: the forward's reads
    (the upstream gradient in place of its output), d f1s and each d level
    written once (and d coords); per in-bounds position 2C operations into
    d f1s and 2C into d f2 (plus 2C for d coords), per tap 8 (plus 12)."""
    B, h, w, _ = coords.shape
    C = channels
    K = 2 * radius + 1
    n_taps = B * h * w * levels * K * K
    nbytes, fwd_ops = lookup_work_from(coords, levels, radius, C)
    positions = (fwd_ops - 7 * n_taps) // (2 * C)
    sizes = level_sizes(h, w, levels)
    nbytes += 4 * (B * h * w * C + sum(B * a * b * C for a, b in sizes))
    if with_coords:
        nbytes += 4 * coords.numel()
    ops = 4 * C * positions + 8 * n_taps
    if with_coords:
        ops += 2 * C * positions + 12 * n_taps
    return nbytes, ops


def nconv_work(B, H, W, k, cin, cout) -> tuple[int, int]:
    """(bytes, operations) of one fused NConv2d: data, conf and weight read
    once, out and conf_out written once; per in-bounds tap and input
    channel one multiply and two multiply-adds per output channel, plus a
    divide, a bias add and a scale per output."""
    taps = _along(H, k // 2) * _along(W, k // 2)
    nbytes = 4 * (2 * B * cin * H * W + cout * cin * k * k + 2 * B * cout * H * W)
    return nbytes, B * cin * taps * (1 + 4 * cout) + 3 * B * cout * H * W


def nconv_bwd_work(B, H, W, k, cin, cout, bias=False, with_gc=True) -> tuple[int, int]:
    """(bytes, operations) of the NConv2d backward: data, conf, weight, out,
    conf_out, the upstream gradients read once, d data, d conf, d weight
    written once; per in-bounds tap and input channel 8 operations per
    output channel and one multiply; 12 per output, 3 per input."""
    taps = _along(H, k // 2) * _along(W, k // 2)
    n_in, n_out = B * cin * H * W, B * cout * H * W
    nw = cout * cin * k * k
    nbytes = 4 * (2 * n_in + nw + (3 + with_gc) * n_out + 2 * n_in + nw)
    if bias:
        nbytes += 4 * 2 * cout
    return nbytes, B * cin * taps * (1 + 8 * cout) + 12 * n_out + 3 * n_in


def ncup_layers(cfg: dict) -> list:
    """The NConv2d layers of NCUP's U-Net at one downsampling, in order:
    ``(k, cin, cout)``, each run on every flow channel at full size."""
    up = cfg["upsampler"]
    m = up["channels_multiplier"]
    return [(up["encoder_filter_sz"], 1, m), (up["encoder_filter_sz"], m, m),
            (up["decoder_filter_sz"], 2 * m, m), (up["out_filter_sz"], m, 1)]


def bound_s(nbytes: float, ops: float, pk: dict) -> float:
    """The least time the card could take: bytes or operations at peak."""
    return max(nbytes / pk["bytes_per_s"], ops / pk["f32_flops"])
