"""Plain PyTorch reference of the two benchmark configurations.

RAFT (Teed & Deng, ECCV 2020, princeton-vl/RAFT ``core/raft.py``) and
RAFT-NCUP (Eldesokey & Felsberg, VISAPP 2021, abdo-eldesokey/RAFT-NCUP
``core/raft_nc_dbl.py``), written from the papers' code as functions of a
dict of tensors: no module of the program is imported, no kernel, cache
or batching. Parameter names are the reference repositories' module
paths, so one dict of weights loads into the program by name.

The configuration dict is a file of ``flowbench/configs`` (widths,
pyramid, upsampler flags). Layouts: images (B, H, W, 3) in [0, 255],
flows (B, H, W, 2), x first; NCHW inside.

Departures from the published code, each of no effect on the result:

- BatchNorm runs with its running statistics (evaluation, and training
  at every stage but chairs, where RAFT freezes it);
- NCUP's U-Net at one downsampling: its half-resolution encoder stage is
  overwritten by the first decoder before anything reads it (the
  reference's ``x[i + nds]`` indexing), so it is not computed;
- the correlation lookup samples the pooled fmap2 at the window taps and
  contracts with fmap1 (:func:`lookup_windowed`), which equals sampling
  the pooled all-pairs volume (:func:`lookup_volume`) because correlation
  is linear in fmap2; the volume is the faster of the two where it fits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
NCONV_EPS = 1e-20


# ------------------------------------------------------------------ spec


def _conv_spec(name, cin, cout, kh, kw=None, rule="uniform", bias=True):
    kw = kh if kw is None else kw
    out = [(f"{name}.weight", (cout, cin, kh, kw), rule)]
    if bias:
        out.append((f"{name}.bias", (cout,), "bias"))
    return out


def _bn_spec(name, ch):
    return [(f"{name}.weight", (ch,), "ones"), (f"{name}.bias", (ch,), "zeros"),
            (f"{name}.running_mean", (ch,), "zeros"), (f"{name}.running_var", (ch,), "ones"),
            (f"{name}.num_batches_tracked", (), "count")]


def _encoder_spec(prefix, out_dim, norm):
    spec = _conv_spec(f"{prefix}.conv1", 3, 64, 7, rule="kaiming")
    bn = (lambda n, c: _bn_spec(n, c)) if norm == "batch" else (lambda n, c: [])
    spec += bn(f"{prefix}.norm1", 64)
    cin = 64
    for li, (dim, stride) in enumerate(zip((64, 96, 128), (1, 2, 2)), start=1):
        for bi in range(2):
            p = f"{prefix}.layer{li}.{bi}"
            s = stride if bi == 0 else 1
            spec += _conv_spec(f"{p}.conv1", cin, dim, 3, rule="kaiming") + bn(f"{p}.norm1", dim)
            spec += _conv_spec(f"{p}.conv2", dim, dim, 3, rule="kaiming") + bn(f"{p}.norm2", dim)
            if s != 1:
                spec += _conv_spec(f"{p}.downsample.0", cin, dim, 1, rule="kaiming")
                spec += bn(f"{p}.downsample.1", dim)
            cin = dim
    spec += _conv_spec(f"{prefix}.conv2", 128, out_dim, 1, rule="kaiming")
    return spec


def param_spec(cfg: dict) -> list:
    """``[(name, shape, rule)]`` of every tensor of the configuration, in
    the reference's module order. Rules: ``kaiming`` N(0, 2 / fan_out),
    ``uniform`` and ``bias`` U(+-1/sqrt(fan_in)), ``nconv`` the NCUP
    kernel's raw parameter, 2 + N(0, 2 / (k k cout)) through the
    positivity map, ``ones``, ``zeros`` and ``count`` (BatchNorm)."""
    hdim, cdim = cfg["hidden_dim"], cfg["context_dim"]
    planes = cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2
    spec = _encoder_spec("fnet", cfg["fnet_dim"], "instance")
    spec += _encoder_spec("cnet", hdim + cdim, "batch")
    u = "update_block"
    spec += _conv_spec(f"{u}.encoder.convc1", planes, 256, 1)
    spec += _conv_spec(f"{u}.encoder.convc2", 256, 192, 3)
    spec += _conv_spec(f"{u}.encoder.convf1", 2, 128, 7)
    spec += _conv_spec(f"{u}.encoder.convf2", 128, 64, 3)
    spec += _conv_spec(f"{u}.encoder.conv", 64 + 192, 128 - 2, 3)
    gru_in = hdim + cdim + 128
    for suffix, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
        for gate in "zrq":
            spec += _conv_spec(f"{u}.gru.conv{gate}{suffix}", gru_in, hdim, kh, kw)
    spec += _conv_spec(f"{u}.flow_head.conv1", hdim, 256, 3)
    spec += _conv_spec(f"{u}.flow_head.conv2", 256, 2, 3)
    if cfg["model"] == "raft":
        spec += _conv_spec(f"{u}.mask.0", hdim, 256, 3)
        spec += _conv_spec(f"{u}.mask.2", 256, 64 * 9, 1)
        return spec
    up = _ncup_flags(cfg)
    w = "upsampler.weights_est_net"
    cin = hdim + 2
    for i, ch in enumerate(up["weights_est_num_ch"]):
        spec += _conv_spec(f"{w}.conv.{i}.0", cin, ch, up["weights_est_filter_sz"][i])
        if cfg["dataset"] == "sintel":
            spec += _bn_spec(f"{w}.conv.{i}.1", ch)
        cin = ch
    spec += _conv_spec(f"{w}.out", cin, 2, up["weights_est_filter_sz"][-1])
    m = up["channels_multiplier"]
    n = "upsampler.interpolation_net"
    ke, kd, ko = up["encoder_filter_sz"], up["decoder_filter_sz"], up["out_filter_sz"]
    for name, cin, cout, k in ((f"{n}.nconv_in", 1, m, ke), (f"{n}.nconv_x2.0", m, m, ke),
                               (f"{n}.decoder.0", 2 * m, m, kd), (f"{n}.nconv_out", m, 1, ko)):
        spec.append((f"{name}.weight_p", (cout, cin, k, k), "nconv"))
    return spec


def _ncup_flags(cfg: dict) -> dict:
    """The NCUP flags this reference implements (those of
    ``scripts/eval_raft_nc_sintel.sh``); another setting raises."""
    up = cfg["upsampler"]
    want = {"kind": "nconv", "scale": 4, "use_data_for_guidance": True,
            "channels_to_batch": True, "use_residuals": False, "est_on_high_res": False,
            "num_downsampling": 1, "use_bias": False, "data_pooling": "conf_based",
            "shared_encoder": True, "pos_fn": "softplus", "weights_est_net": "simple"}
    bad = {k: up.get(k) for k, v in want.items() if up.get(k) != v}
    if bad:
        raise ValueError(f"the reference implements NCUP as {want}; got {bad}")
    return up


# --------------------------------------------------------------- pieces


def conv(p: dict, name: str, x, stride=1, padding=None, dilation=1):
    w = p[f"{name}.weight"]
    kh, kw = w.shape[2], w.shape[3]
    if padding is None:
        padding = (kh // 2 * dilation, kw // 2 * dilation)
    return F.conv2d(x, w, p.get(f"{name}.bias"), stride, padding, dilation)


def batch_norm(p: dict, name: str, x):
    """BatchNorm with its running statistics."""
    return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0, BN_EPS)


def _norm(p, name, x, kind):
    if kind == "instance":
        return F.instance_norm(x, eps=BN_EPS)
    return batch_norm(p, name, x)


def encoder(p: dict, prefix: str, x, kind: str):
    """BasicEncoder (RAFT ``core/extractor.py``): 7x7/2 stem, residual
    stages 64, 96, 128 at strides 1, 2, 2, 1x1 head."""
    x = torch.relu(_norm(p, f"{prefix}.norm1", conv(p, f"{prefix}.conv1", x, stride=2), kind))
    for li, stride in zip((1, 2, 3), (1, 2, 2)):
        for bi in range(2):
            b = f"{prefix}.layer{li}.{bi}"
            s = stride if bi == 0 else 1
            y = torch.relu(_norm(p, f"{b}.norm1", conv(p, f"{b}.conv1", x, stride=s), kind))
            y = torch.relu(_norm(p, f"{b}.norm2", conv(p, f"{b}.conv2", y), kind))
            if s != 1:
                x = _norm(p, f"{b}.downsample.1", conv(p, f"{b}.downsample.0", x, stride=s),
                          kind)
            x = torch.relu(x + y)
    return conv(p, f"{prefix}.conv2", x)


def coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    """(B, 2, h, w) pixel coordinates, x first."""
    y, x = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                          torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    return torch.stack([x, y])[None].expand(b, 2, h, w)


def _window(radius: int, device) -> torch.Tensor:
    """(K, K, 2) offsets: tap (i, j) moves x by i - r and y by j - r, the
    x-major tap order of RAFT's ``CorrBlock``."""
    d = torch.arange(-radius, radius + 1, device=device, dtype=torch.float32)
    di, dj = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([di, dj], dim=-1)


def _sample(img, pts):
    """Bilinear samples of (N, C, h, w) at pixel points (N, a, b, 2), each
    corner outside the image contributing zero: a one-pixel zero border
    and ``align_corners`` sampling."""
    img = F.pad(img, (1, 1, 1, 1))
    h, w = img.shape[2], img.shape[3]
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=pts.device)
    grid = (pts + 1.0) * scale - 1.0
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def pool2(x):
    """2x2 means of (N, C, h, w), an odd last row or column dropped (a
    level may come out empty)."""
    n, c, h, w = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, :, :2 * h2, :2 * w2].reshape(n, c, h2, 2, w2, 2).mean(dim=(3, 5))


def pool_levels(f2, levels: int) -> list:
    """The fmap2 pyramid, (B, C, h / 2^l, w / 2^l)."""
    out = [f2]
    for _ in range(levels - 1):
        out.append(pool2(out[-1]))
    return out


def lookup_volume(f1, f2, coords, levels: int, radius: int):
    """RAFT's ``CorrBlock``: the all-pairs volume of (B, C, h, w) maps over
    sqrt(C), pooled into ``levels`` levels, sampled in a (2r+1)^2 window
    around ``coords / 2^l`` (B, 2, h, w). Returns (B, L K K, h, w)."""
    B, C, h, w = f1.shape
    corr = torch.einsum("bcq,bcp->bqp", f1.reshape(B, C, -1), f2.reshape(B, C, -1))
    vol = (corr / math.sqrt(C)).reshape(B * h * w, 1, f2.shape[2], f2.shape[3])
    win = _window(radius, f1.device)
    cq = coords.permute(0, 2, 3, 1).reshape(B * h * w, 1, 1, 2)
    out = []
    for lvl in range(levels):
        s = _sample(vol, cq / 2 ** lvl + win)  # (BQ, 1, K, K)
        out.append(s.reshape(B, h, w, -1))
        if lvl + 1 < levels:
            vol = pool2(vol)
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2)


def lookup_windowed(f1, f2, coords, levels: int, radius: int, rows: int = 8):
    """The same lookup without the volume: each level of the pooled fmap2
    sampled at the window taps and contracted with fmap1 over sqrt(C),
    ``rows`` query rows at a time."""
    B, C, h, w = f1.shape
    win = _window(radius, f1.device).reshape(1, 1, -1, 2)
    f2_levels = pool_levels(f2, levels)
    f1s = f1 / math.sqrt(C)
    blocks = []
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        q = coords[:, :, r0:r1].permute(0, 2, 3, 1).reshape(B, -1, 1, 2)
        f1q = f1s[:, :, r0:r1].reshape(B, C, -1)
        out = []
        for lvl, f2l in enumerate(f2_levels):
            taps = _sample(f2l, q / 2 ** lvl + win)  # (B, C, Q, K K)
            out.append(torch.einsum("bcqk,bcq->bqk", taps, f1q))
        blocks.append(torch.cat(out, dim=-1).reshape(B, r1 - r0, w, -1))
    return torch.cat(blocks, dim=1).permute(0, 3, 1, 2)


def update_block(p: dict, net, inp, corr, flow):
    """BasicUpdateBlock: motion encoder, SepConvGRU (1x5 then 5x1 over
    hidden + input channels), flow head."""
    u = "update_block.encoder"
    cor = torch.relu(conv(p, f"{u}.convc1", corr))
    cor = torch.relu(conv(p, f"{u}.convc2", cor))
    flo = torch.relu(conv(p, f"{u}.convf1", flow))
    flo = torch.relu(conv(p, f"{u}.convf2", flo))
    motion = torch.cat([torch.relu(conv(p, f"{u}.conv", torch.cat([cor, flo], 1))), flow], 1)
    x = torch.cat([inp, motion], 1)
    g = "update_block.gru"
    for s in "12":
        hx = torch.cat([net, x], 1)
        z = torch.sigmoid(conv(p, f"{g}.convz{s}", hx))
        r = torch.sigmoid(conv(p, f"{g}.convr{s}", hx))
        q = torch.tanh(conv(p, f"{g}.convq{s}", torch.cat([r * net, x], 1)))
        net = (1 - z) * net + z * q
    delta = conv(p, "update_block.flow_head.conv2",
                 torch.relu(conv(p, "update_block.flow_head.conv1", net)))
    return net, delta


def convex_upsample(p: dict, flow, net):
    """RAFT's mask head (scaled by 0.25) and convex upsampling x8."""
    mask = 0.25 * conv(p, "update_block.mask.2", torch.relu(conv(p, "update_block.mask.0", net)))
    B, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(B, 1, 9, 8, 8, h, w), dim=2)
    patches = F.unfold(8 * flow, [3, 3], padding=1).reshape(B, 2, 9, 1, 1, h, w)
    up = (m * patches).sum(dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, 8 * h, 8 * w)


def _zero_stuff(x, s: int):
    out = x.new_zeros(x.shape[0], x.shape[1], x.shape[2] * s, x.shape[3] * s)
    out[:, :, s // 2::s, s // 2::s] = x
    return out


def nconv(p: dict, name: str, data, conf):
    """Normalized convolution with the softplus(10 x) / 10 kernel:
    conv(data conf, w) / (conv(conf, w) + eps), confidence conv(conf, w)
    / sum(w)."""
    w = F.softplus(10.0 * p[f"{name}.weight_p"]) / 10.0
    pad = w.shape[-1] // 2
    den = F.conv2d(conf, w, padding=pad)
    num = F.conv2d(data * conf, w, padding=pad)
    return num / (den + NCONV_EPS), den / w.sum(dim=(1, 2, 3)).view(1, -1, 1, 1)


def ncup(p: dict, cfg: dict, flow_lr, net):
    """RAFT-NCUP's upsampling of the (B, 2, h, w) low-res flow: nearest x2,
    NCUP x4 (weights net on the flow and the GRU state, NConvUNet on each
    flow channel), x8 in value."""
    up = _ncup_flags(cfg)
    flow2 = flow_lr.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    B, C, h4, w4 = flow2.shape
    guid = net.repeat_interleave(h4 // net.shape[2], dim=2).repeat_interleave(
        w4 // net.shape[3], dim=3)
    x = torch.cat([flow2, guid], 1)
    wn = "upsampler.weights_est_net"
    for i, _ in enumerate(up["weights_est_num_ch"]):
        x = conv(p, f"{wn}.conv.{i}.0", x)
        if cfg["dataset"] == "sintel":
            x = batch_norm(p, f"{wn}.conv.{i}.1", x)
        x = torch.relu(x)
    conf = torch.sigmoid(conv(p, f"{wn}.out", x))
    s = up["scale"]
    d = _zero_stuff(flow2, s).reshape(B * C, 1, h4 * s, w4 * s)
    c = _zero_stuff(conf, s).reshape(B * C, 1, h4 * s, w4 * s)
    n = "upsampler.interpolation_net"
    d, c = nconv(p, f"{n}.nconv_in", d, c)
    d, c = nconv(p, f"{n}.nconv_x2.0", d, c)
    d, c = nconv(p, f"{n}.decoder.0", torch.cat([d, d], 1), torch.cat([c, c], 1))
    d, _ = nconv(p, f"{n}.nconv_out", d, c)
    return 8.0 * d.reshape(B, C, h4 * s, w4 * s)


def upsample(p: dict, cfg: dict, flow_lr, net):
    if cfg["model"] == "raft":
        return convex_upsample(p, flow_lr, net)
    return ncup(p, cfg, flow_lr, net)


# -------------------------------------------------------------- forward


def _encode(p, cfg, image1, image2):
    img1 = (2.0 * (image1.float() / 255.0) - 1.0).permute(0, 3, 1, 2)
    img2 = (2.0 * (image2.float() / 255.0) - 1.0).permute(0, 3, 1, 2)
    B = img1.shape[0]
    fmap1, fmap2 = encoder(p, "fnet", torch.cat([img1, img2]), "instance").split(B)
    c = encoder(p, "cnet", img1, "batch")
    hdim = cfg["hidden_dim"]
    return fmap1, fmap2, torch.tanh(c[:, :hdim]), torch.relu(c[:, hdim:])


def forward(p: dict, cfg: dict, image1, image2, iters: int, lookup: str = "volume",
            train: bool = False, on_coords=None):
    """The test-mode forward: (B, H, W, 2) flow at the input's size (H and
    W divisible by 8); with ``train`` the (iters, B, H, W, 2) upsampled
    flow of every iteration, coordinates detached at each iteration's
    start. ``lookup`` is ``volume`` or ``windowed``. ``on_coords`` sees
    each iteration's lookup coordinates, (B, h, w, 2)."""
    fmap1, fmap2, net, inp = _encode(p, cfg, image1, image2)
    B, _, h, w = fmap1.shape
    levels, radius = cfg["corr_levels"], cfg["corr_radius"]
    if lookup == "volume":
        f2 = fmap2

        def corr_fn(c):
            return lookup_volume(fmap1, f2, c, levels, radius)
    else:
        def corr_fn(c):
            return lookup_windowed(fmap1, fmap2, c, levels, radius)
    coords0 = coords_grid(B, h, w, fmap1.device)
    coords1 = coords0.clone()
    preds = []
    for _ in range(int(iters)):
        if train:
            coords1 = coords1.detach()
        if on_coords is not None:
            on_coords(coords1.detach().permute(0, 2, 3, 1))
        corr = corr_fn(coords1)
        net, delta = update_block(p, net, inp, corr, coords1 - coords0)
        coords1 = coords1 + delta
        if train:
            preds.append(upsample(p, cfg, coords1 - coords0, net).permute(0, 2, 3, 1))
    if train:
        return torch.stack(preds)
    return upsample(p, cfg, coords1 - coords0, net).permute(0, 2, 3, 1)


def pad_sintel(images, divisor: int = 8):
    """Edge-pad (B, H, W, 3) to multiples of 8 in W and ``divisor`` in H,
    the vertical and horizontal padding centred (``InputPadder`` in
    'sintel' mode); returns the padded images and ((top, bottom), (left,
    right))."""
    H, W = images.shape[1], images.shape[2]
    ph, pw = -H % divisor, -W % 8
    pads = ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2))
    x = F.pad(images.permute(0, 3, 1, 2).float(),
              (pads[1][0], pads[1][1], pads[0][0], pads[0][1]), mode="replicate")
    return x.permute(0, 2, 3, 1), pads


def serve(p: dict, cfg: dict, image1, image2, iters: int, lookup: str = "volume",
          divisor: int = 8, on_coords=None):
    """A served answer: pad, the test-mode forward, crop back to the
    frames' size. Images (B, H, W, 3)."""
    (i1, pads), (i2, _) = pad_sintel(image1, divisor), pad_sintel(image2, divisor)
    flow = forward(p, cfg, i1, i2, iters, lookup, on_coords=on_coords)
    (t, b), (le, r) = pads
    return flow[:, t:flow.shape[1] - b, le:flow.shape[2] - r]
