"""Validation and leaderboard-submission drivers (port of
``raft_ncup_tpu/evaluation.py``).

``validate_chairs`` (EPE at 24 iterations), ``validate_sintel`` (clean
and final EPE and 1/3/5 px at 32), ``validate_sintel_warm`` (the same with
each frame warm-started from the previous one), ``validate_kitti`` (EPE
and F1 at 24), ``validate_synthetic`` and ``validate_synthetic_rigid``
(held-out procedural pairs, the second with a boundary-band EPE), and
the Sintel and KITTI submission writers.

Built on ``inference/``: validators stream batches through
:class:`EvalPipeline` (decode, pad on the host, copy to the card, all
off the dispatch thread) and fold the metric on the card inside the
cached CUDA graph of the forward (:class:`ShapeCachedForward`); a pass
pulls its handful of sums once, at its end. Submissions copy each flow
field to the host through :class:`AsyncDrain`, behind the next frame's
dispatch.

One card, one process: the JAX package's ``_HostShard`` and
``_shard_for_validation`` split a dataset across hosts and agree on its
length; with no mesh and one process they reduce to the whole dataset,
so every validator here reads the whole dataset and needs no reduction.

Each validator and writer takes ``fwd``, the :class:`ShapeCachedForward`
to run through (by default a new one over ``model``), so a caller can
read its captures, hits and evictions.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from raft_ncup_tpu_torch.config import DataConfig
from raft_ncup_tpu_torch.data import datasets as ds_mod
from raft_ncup_tpu_torch.data.synthetic import SyntheticFlowDataset, flow_boundary_mask
from raft_ncup_tpu_torch.inference import metrics as metrics_mod
from raft_ncup_tpu_torch.inference.pipeline import (
    AsyncDrain,
    DispatchThrottle,
    EvalPipeline,
    SamplePrefetcher,
    ShapeCachedForward,
)
from raft_ncup_tpu_torch.io import write_flo, write_flow_kitti, write_png
from raft_ncup_tpu_torch.ops.padding import InputPadder
from raft_ncup_tpu_torch.ops.warmstart import forward_interpolate_batch
from raft_ncup_tpu_torch.viz import flow_to_image


def _pad_host(pad_spec, *arrays: np.ndarray) -> list[np.ndarray]:
    """Apply an InputPadder spec with ``np.pad`` (edges replicated) on the
    staging thread, so padding puts no device work there."""
    (t, b), (le, r) = pad_spec
    spec = ((0, 0), (t, b), (le, r), (0, 0))
    return [np.pad(x, spec, mode="edge") for x in arrays]


def _forward_for(model, cfg: DataConfig, precision, fwd) -> ShapeCachedForward:
    if fwd is not None:
        return fwd
    return ShapeCachedForward(model, cache_size=cfg.eval_cache_size, policy=precision)


def _pull(acc: torch.Tensor) -> np.ndarray:
    """The pass's one copy to the host: a few float32 sums."""
    return acc.cpu().numpy().astype(np.float64)


def _run_metric_pass(
    fwd: ShapeCachedForward,
    dataset,
    *,
    kind: str,
    iters: int,
    batch_size: int,
    pad_mode: Optional[str] = None,
    bucket: int = 0,
    with_valid: bool = False,
    band_fn=None,
    num_workers: int = 4,
    depth: int = 2,
) -> np.ndarray:
    """One validation pass: ``dataset`` through an :class:`EvalPipeline`,
    each batch folded into a ``kind`` accumulator on the card inside the
    cached forward, and the sums pulled once at the end. ``pad_mode``
    None skips padding (the synthetic and chairs shapes divide by 8);
    otherwise images pad on the staging thread and the pad spec rides the
    batch's meta, so the fold crops the prediction. ``band_fn`` (epe_band)
    makes the boundary mask while staging."""

    def stage(group: list) -> tuple:
        img1 = np.stack([np.asarray(s["image1"]) for s in group]).astype(np.float32)
        img2 = np.stack([np.asarray(s["image2"]) for s in group]).astype(np.float32)
        arrays = {"flow": np.stack([np.asarray(s["flow"]) for s in group]).astype(np.float32)}
        if with_valid:
            arrays["valid"] = np.stack([np.asarray(s["valid"]) for s in group]).astype(
                np.float32)
        if band_fn is not None:
            arrays["band"] = np.stack([band_fn(s["flow"]) for s in group]).astype(np.float32)
        pad = None
        if pad_mode is not None:
            pad = InputPadder(img1.shape, mode=pad_mode, bucket=bucket).pad_spec
            img1, img2 = _pad_host(pad, img1, img2)
        arrays["image1"], arrays["image2"] = img1, img2
        return arrays, {"pad": pad}

    acc = metrics_mod.init_acc(kind, fwd.device)
    throttle = DispatchThrottle()
    with EvalPipeline(dataset, stage, device=fwd.device, batch_size=batch_size, depth=depth,
                      num_workers=num_workers) as pipe:
        for batch, meta in pipe:
            acc = fwd.metrics(batch, iters=iters, acc=acc, kind=kind, pad=meta["pad"])
            throttle.push(acc)
    return _pull(acc)


def _run_warmstart_metric_pass(
    fwd: ShapeCachedForward,
    dataset,
    *,
    kind: str,
    iters: int,
    pad_mode: str = "sintel",
    num_workers: int = 4,
    sequence_of=None,
) -> np.ndarray:
    """Warm-start validation: frames in order, one at a time; each frame's
    metric folds on the card, and the next frame's ``flow_init`` is the
    splat (``ops/warmstart``) of this frame's low-res flow, on the card. A
    new sequence (``sequence_of(sample)``, by default the first element of
    ``extra_info``) starts cold: a zero ``flow_init`` through the same
    cached forward, which is the cold start exactly."""
    if sequence_of is None:
        def sequence_of(s):
            info = s.get("extra_info")
            return info[0] if info else None

    acc = metrics_mod.init_acc(kind, fwd.device)
    throttle = DispatchThrottle()
    flow_prev = None
    seq_prev = object()  # never equal to a real sequence name
    with SamplePrefetcher(dataset, num_workers=num_workers) as samples:
        for s in samples:
            sequence = sequence_of(s)
            if sequence != seq_prev:
                flow_prev = None
            img1 = np.asarray(s["image1"], np.float32)[None]
            img2 = np.asarray(s["image2"], np.float32)[None]
            gt = np.asarray(s["flow"], np.float32)[None]
            pad = InputPadder(img1.shape, mode=pad_mode).pad_spec
            img1, img2 = _pad_host(pad, img1, img2)
            if flow_prev is None:
                h8, w8 = img1.shape[1] // 8, img1.shape[2] // 8
                flow_prev = torch.zeros((1, h8, w8, 2), dtype=torch.float32,
                                        device=fwd.device)
            batch = {"image1": img1, "image2": img2, "flow": gt}
            acc, flow_lr = fwd.metrics(batch, iters=iters, acc=acc, kind=kind, pad=pad,
                                       flow_init=flow_prev)
            flow_prev = forward_interpolate_batch(flow_lr)
            throttle.push(acc)
            seq_prev = sequence
    return _pull(acc)


def validate_chairs(model, data_cfg: Optional[DataConfig] = None, iters: int = 24,
                    batch_size: int = 4, precision: Optional[str] = None, fwd=None) -> dict:
    """FlyingChairs validation-split EPE (reference: evaluate.py:90-108)."""
    cfg = data_cfg or DataConfig()
    dataset = ds_mod.FlyingChairs(split="validation", root=cfg.root_chairs,
                                  split_file=cfg.chairs_split_file)
    if len(dataset) == 0:
        print(f"validate_chairs: no data under {cfg.root_chairs}, skipping")
        return {}
    acc = _run_metric_pass(
        _forward_for(model, cfg, precision, fwd), dataset, kind="epe", iters=iters,
        batch_size=batch_size, num_workers=cfg.num_workers, depth=cfg.device_prefetch)
    epe = metrics_mod.finalize("epe", acc)["epe"]
    print(f"Validation Chairs EPE: {epe:f}")
    return {"chairs": epe}


def validate_sintel(model, data_cfg: Optional[DataConfig] = None, iters: int = 32,
                    batch_size: int = 2, warm_start: bool = False,
                    precision: Optional[str] = None, fwd=None) -> dict:
    """Sintel training-split clean and final EPE and 1/3/5 px (reference:
    evaluate.py:111-143). ``warm_start=True`` is the video case: frames
    one at a time, each warm-started from the splat of the previous
    frame's low-res flow, cold at a new sequence; its keys take a
    ``warm_`` prefix."""
    cfg = data_cfg or DataConfig()
    fwd = _forward_for(model, cfg, precision, fwd)
    results = {}
    prefix = "warm_" if warm_start else ""
    for dstype in ("clean", "final"):
        dataset = ds_mod.MpiSintel(split="training", root=cfg.root_sintel, dstype=dstype)
        if len(dataset) == 0:
            print(f"validate_sintel: no {dstype} data under {cfg.root_sintel}, skipping")
            continue
        if warm_start:
            acc = _run_warmstart_metric_pass(fwd, dataset, kind="px", iters=iters,
                                             num_workers=cfg.num_workers)
        else:
            acc = _run_metric_pass(
                fwd, dataset, kind="px", iters=iters, batch_size=batch_size,
                pad_mode="sintel", num_workers=cfg.num_workers, depth=cfg.device_prefetch)
        m = metrics_mod.finalize("px", acc)
        print(f"Validation ({prefix}{dstype}) EPE: {m['epe']:f}, 1px: {m['1px']:f}, "
              f"3px: {m['3px']:f}, 5px: {m['5px']:f}")
        results[f"{prefix}{dstype}"] = m["epe"]
        results.update({f"{prefix}{dstype}_{k}": m[k] for k in ("1px", "3px", "5px")})
    return results


def validate_sintel_warm(model, data_cfg: Optional[DataConfig] = None, **kwargs) -> dict:
    """Sintel warm-start (video) validation; see :func:`validate_sintel`."""
    return validate_sintel(model, data_cfg, warm_start=True, **kwargs)


def validate_kitti(model, data_cfg: Optional[DataConfig] = None, iters: int = 24,
                   batch_size: int = 2, precision: Optional[str] = None, fwd=None) -> dict:
    """KITTI-2015 training-split EPE and F1 (reference: evaluate.py:146-182):
    EPE averaged per frame, F1 the share of valid pixels with EPE > 3 and
    EPE / |flow| > 0.05, pooled. Frames batch per native shape."""
    cfg = data_cfg or DataConfig()
    dataset = ds_mod.KITTI(split="training", root=cfg.root_kitti)
    if len(dataset) == 0:
        print(f"validate_kitti: no data under {cfg.root_kitti}, skipping")
        return {}
    acc = _run_metric_pass(
        _forward_for(model, cfg, precision, fwd), dataset, kind="kitti", iters=iters,
        batch_size=batch_size, pad_mode="kitti", bucket=cfg.eval_pad_bucket,
        with_valid=True, num_workers=cfg.num_workers, depth=cfg.device_prefetch)
    m = metrics_mod.finalize("kitti", acc)
    print(f"Validation KITTI: {m['epe']:f}, {m['f1']:f}")
    return {"kitti-epe": m["epe"], "kitti-f1": m["f1"]}


def create_sintel_submission(model, data_cfg: Optional[DataConfig] = None, iters: int = 32,
                             warm_start: bool = False, output_path: str = "sintel_submission",
                             write_png: bool = False, precision: Optional[str] = None,
                             fwd=None) -> None:
    """Write Sintel test-split ``.flo`` files (reference: evaluate.py:22-57),
    and with ``write_png`` their colour images under ``<output_path>_png``.
    With ``warm_start`` each frame starts from the splat of the previous
    frame's low-res flow, on the card. Each field reaches the host through
    an :class:`AsyncDrain`, behind the next frame's dispatch."""
    cfg = data_cfg or DataConfig()
    fwd = _forward_for(model, cfg, precision, fwd)
    for dstype in ("clean", "final"):
        dataset = ds_mod.MpiSintel(split="test", root=cfg.root_sintel, dstype=dstype)
        flow_prev, sequence_prev = None, None
        with SamplePrefetcher(dataset, num_workers=cfg.num_workers) as samples, \
                AsyncDrain(depth=cfg.device_prefetch) as drain:
            for s in samples:
                sequence, frame = s["extra_info"]
                if sequence != sequence_prev:
                    flow_prev = None
                img1 = np.asarray(s["image1"], np.float32)[None]
                img2 = np.asarray(s["image2"], np.float32)[None]
                padder = InputPadder(img1.shape)
                img1, img2 = _pad_host(padder.pad_spec, img1, img2)
                flow_lr, flow_up = fwd.forward(img1, img2, iters, flow_init=flow_prev)
                if warm_start:
                    flow_prev = forward_interpolate_batch(flow_lr)
                drain.submit(flow_up, _sintel_writer(padder, output_path, dstype, sequence,
                                                     frame, write_png))
                sequence_prev = sequence


def _sintel_writer(padder, output_path, dstype, sequence, frame, png: bool):
    """Drain callback: crop on the host and write the frame's ``.flo`` (and
    its colour PNG)."""

    def write_cb(flow_up: np.ndarray) -> None:
        flow = padder.unpad(flow_up)[0]
        out_dir = os.path.join(output_path, dstype, sequence)
        os.makedirs(out_dir, exist_ok=True)
        write_flo(os.path.join(out_dir, f"frame{frame + 1:04d}.flo"), flow)
        if png:
            png_dir = os.path.join(output_path + "_png", dstype, sequence)
            os.makedirs(png_dir, exist_ok=True)
            write_png(os.path.join(png_dir, f"frame{frame + 1:04d}.png"), flow_to_image(flow))

    return write_cb


def create_kitti_submission(model, data_cfg: Optional[DataConfig] = None, iters: int = 24,
                            output_path: str = "kitti_submission", write_png: bool = False,
                            precision: Optional[str] = None, fwd=None) -> None:
    """Write KITTI test-split 16-bit flow PNGs (reference:
    evaluate.py:60-87), and with ``write_png`` colour images under
    ``<output_path>_png``; fields reach the host through an
    :class:`AsyncDrain`."""
    cfg = data_cfg or DataConfig()
    dataset = ds_mod.KITTI(split="testing", root=cfg.root_kitti)
    fwd = _forward_for(model, cfg, precision, fwd)
    os.makedirs(output_path, exist_ok=True)
    if write_png:
        os.makedirs(output_path + "_png", exist_ok=True)
    with SamplePrefetcher(dataset, num_workers=cfg.num_workers) as samples, \
            AsyncDrain(depth=cfg.device_prefetch) as drain:
        for s in samples:
            (frame_id,) = s["extra_info"]
            img1 = np.asarray(s["image1"], np.float32)[None]
            img2 = np.asarray(s["image2"], np.float32)[None]
            padder = InputPadder(img1.shape, mode="kitti", bucket=cfg.eval_pad_bucket)
            img1, img2 = _pad_host(padder.pad_spec, img1, img2)
            _, flow_up = fwd.forward(img1, img2, iters)
            drain.submit(flow_up, _kitti_writer(padder, output_path, frame_id, write_png))


def _kitti_writer(padder, output_path: str, frame_id: str, png: bool):
    """Drain callback: crop and write one KITTI 16-bit submission PNG."""

    def write_cb(flow_up: np.ndarray) -> None:
        flow = padder.unpad(flow_up)[0]
        write_flow_kitti(os.path.join(output_path, frame_id), flow)
        if png:
            write_png(os.path.join(output_path + "_png", frame_id), flow_to_image(flow))

    return write_cb


def validate_synthetic(model, data_cfg: Optional[DataConfig] = None, iters: int = 12,
                       batch_size: int = 4, size_hw: tuple[int, int] = (96, 128),
                       length: int = 32, style: Optional[str] = None, seed: int = 999,
                       precision: Optional[str] = None, fwd=None) -> dict:
    """EPE on a held-out procedural split (seed 999, away from the
    trainer's 0), for runs without datasets; no reference analogue.
    ``style`` defaults to ``data_cfg.synthetic_style``; ``"rigid"`` adds
    the EPE of the band within 3 px of a flow discontinuity and of its
    complement (the band mask made while staging). The port's procedural
    pairs are its own (``data/synthetic.py``), not the JAX package's.
    Frames pad as Sintel's do, so ``size_hw`` need not divide by 8 (the
    JAX validator does not pad): at 436x1024 it runs at Sintel's padded
    shape, and a size that divides by 8 pads nothing."""
    if style is None:
        style = data_cfg.synthetic_style if data_cfg else "smooth"
    prefix = "synthetic" if style == "smooth" else f"synthetic_{style}"
    dataset = SyntheticFlowDataset(size_hw, length=length, seed=seed, style=style)
    if len(dataset) == 0:
        print("validate_synthetic: no frames, skipping")
        return {}
    cfg = data_cfg or DataConfig()
    kind = "epe_band" if style == "rigid" else "epe"
    acc = _run_metric_pass(
        _forward_for(model, cfg, precision, fwd), dataset, kind=kind, iters=iters,
        batch_size=batch_size, pad_mode="sintel",
        band_fn=flow_boundary_mask if style == "rigid" else None,
        num_workers=cfg.num_workers, depth=cfg.device_prefetch)
    m = metrics_mod.finalize(kind, acc)
    out = {prefix: m["epe"]}
    if style == "rigid":
        out[f"{prefix}_bnd"] = m["bnd"]
        out[f"{prefix}_interior"] = m["interior"]
        print(f"Validation Synthetic[{style}] EPE: {m['epe']:f}, boundary: {m['bnd']:f}, "
              f"interior: {m['interior']:f}")
    else:
        print(f"Validation Synthetic EPE: {m['epe']:f}")
    return out


def validate_synthetic_rigid(model, data_cfg: Optional[DataConfig] = None, **kwargs) -> dict:
    """The held-out piecewise-rigid split with the boundary-band EPE; see
    :func:`validate_synthetic`."""
    return validate_synthetic(model, data_cfg, style="rigid", **kwargs)


VALIDATORS = {
    "chairs": validate_chairs,
    "sintel": validate_sintel,
    "sintel_warm": validate_sintel_warm,
    "kitti": validate_kitti,
    "synthetic": validate_synthetic,
    "synthetic_rigid": validate_synthetic_rigid,
}
