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
pulls its handful of sums once, at its end, through the sanctioned
``analysis.guards.host_read``, so a pass reads nothing else on the host
and, warm, captures nothing (``tests/test_torch_guards.py``). Submissions
copy each flow field to the host through :class:`AsyncDrain`, behind the
next frame's dispatch.

Processes, one per card (``parallel/``), split a validation as the JAX
package's host-local plan does (:func:`_shard_for_validation`): the ranks
agree on the dataset's length (the smallest any of them sees, so a rank
missing frames makes every rank skip alike), each data index validates
the frames ``d::data`` (:class:`_HostShard`) through its own cached
forward, with no collective inside a captured graph, and the fixed-size
sums and counts of the metric are summed over the data indices
(``allreduce_sum_across_hosts`` on ``mesh.data_group``), so every rank
returns the global metrics. Under a mesh with a spatial axis above 1
(``fwd.mesh``) the ranks of one data index see the same frames and split
each forward by rows; their sums are equal and summed once, never over
the spatial ranks. Under a pipe axis each pipe index runs that pass on
its own ranks, as JAX replicates it over ``pipe``, and sums over its own
data group only, so every pipe index holds the one-process sums. Images
then pad to a multiple of 8 times the spatial size (``fwd.pad_divisor``). Only the main process prints the metrics and
writes submissions (the ranks of its data index run the forwards with
it); warm-start validation, a serial chain through each sequence, stays
on one process. One process reads the whole dataset.

Each validator and writer takes ``fwd``, the :class:`ShapeCachedForward`
to run through (by default a new one over ``model``), so a caller can
read its captures, hits and evictions.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from raft_ncup_tpu_torch.analysis.guards import host_read
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
from raft_ncup_tpu_torch.parallel.mesh import data_group
from raft_ncup_tpu_torch.parallel.multihost import (
    agreed_min,
    allreduce_sum_across_hosts,
    is_main_process,
    is_multihost,
    process_count,
    process_index,
)
from raft_ncup_tpu_torch.viz import flow_to_image


class _HostShard:
    """This rank's frames of a dataset, indices ``index::count`` of the
    first ``n_global`` (the length the ranks agreed on): by default the
    rank's of the world, under a mesh its data index's of the data size."""

    def __init__(self, dataset, n_global: int, index: Optional[int] = None,
                 count: Optional[int] = None):
        self._ds = dataset
        self._n = n_global
        self._pi = process_index() if index is None else int(index)
        self._pc = process_count() if count is None else int(count)

    def __len__(self) -> int:
        return (self._n - self._pi + self._pc - 1) // self._pc

    def sample(self, index: int, *a, **kw):
        return self._ds.sample(self._pi + index * self._pc, *a, **kw)


def _shard_for_validation(dataset, mesh=None):
    """``(this rank's view, the agreed length, whether to reduce)``: the
    whole dataset with no reduction on one process; with several, the
    smallest length any rank sees, this rank's frames of it (its data
    index's under ``mesh``), and a reduction of the sums
    (:func:`_reduce`)."""
    n = len(dataset)
    if not is_multihost():
        return dataset, n, False
    n = agreed_min(n)
    if mesh is None:
        return _HostShard(dataset, n), n, True
    return _HostShard(dataset, n, mesh.data_index, mesh.data), n, True


def _reduce(acc: np.ndarray, fwd: ShapeCachedForward) -> np.ndarray:
    """The sums of a sharded pass over the data indices: over the world
    without a mesh, else over this rank's data group (the ranks of its
    spatial and pipe index), so that the spatial ranks of a data index,
    which hold the same sums, and the pipe indices, each a replica of the
    ``(data, spatial)`` pass, count once. A pipe axis with a data size of
    1 needs no reduction: each rank ran the whole pass."""
    mesh = fwd.mesh
    if mesh is not None and mesh.pipe > 1 and mesh.data == 1:
        return acc
    return allreduce_sum_across_hosts(acc, group=data_group(mesh))


def _print_main(msg: str) -> None:
    """A validator's console line, from the main process only."""
    if is_main_process():
        print(msg)


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
    """The pass's one read on the host, a few float32 sums, through the
    sanctioned ``guards.host_read``: a validation window is clean under the
    runtime guards."""
    return host_read(acc).astype(np.float64)


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
            pad = InputPadder(img1.shape, mode=pad_mode, divisor=fwd.pad_divisor,
                              bucket=bucket).pad_spec
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
            pad = InputPadder(img1.shape, mode=pad_mode, divisor=fwd.pad_divisor).pad_spec
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
    fwd = _forward_for(model, cfg, precision, fwd)
    dataset, n, reduce = _shard_for_validation(dataset, fwd.mesh)
    if n == 0:
        _print_main(f"validate_chairs: no data under {cfg.root_chairs}, skipping")
        return {}
    acc = _run_metric_pass(
        fwd, dataset, kind="epe", iters=iters,
        batch_size=batch_size, num_workers=cfg.num_workers, depth=cfg.device_prefetch)
    if reduce:
        acc = _reduce(acc, fwd)
    epe = metrics_mod.finalize("epe", acc)["epe"]
    _print_main(f"Validation Chairs EPE: {epe:f}")
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
    if warm_start and is_multihost():
        raise ValueError("warm-start validation is a serial chain through each sequence: "
                         "one process, not sharded across ranks")
    fwd = _forward_for(model, cfg, precision, fwd)
    results = {}
    prefix = "warm_" if warm_start else ""
    for dstype in ("clean", "final"):
        dataset = ds_mod.MpiSintel(split="training", root=cfg.root_sintel, dstype=dstype)
        dataset, n, reduce = _shard_for_validation(dataset, fwd.mesh)
        if n == 0:
            _print_main(f"validate_sintel: no {dstype} data under {cfg.root_sintel}, skipping")
            continue
        if warm_start:
            acc = _run_warmstart_metric_pass(fwd, dataset, kind="px", iters=iters,
                                             num_workers=cfg.num_workers)
        else:
            acc = _run_metric_pass(
                fwd, dataset, kind="px", iters=iters, batch_size=batch_size,
                pad_mode="sintel", num_workers=cfg.num_workers, depth=cfg.device_prefetch)
        if reduce:
            acc = _reduce(acc, fwd)
        m = metrics_mod.finalize("px", acc)
        _print_main(f"Validation ({prefix}{dstype}) EPE: {m['epe']:f}, 1px: {m['1px']:f}, "
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
    fwd = _forward_for(model, cfg, precision, fwd)
    dataset, n, reduce = _shard_for_validation(dataset, fwd.mesh)
    if n == 0:
        _print_main(f"validate_kitti: no data under {cfg.root_kitti}, skipping")
        return {}
    acc = _run_metric_pass(
        fwd, dataset, kind="kitti", iters=iters,
        batch_size=batch_size, pad_mode="kitti", bucket=cfg.eval_pad_bucket,
        with_valid=True, num_workers=cfg.num_workers, depth=cfg.device_prefetch)
    if reduce:
        acc = _reduce(acc, fwd)
    m = metrics_mod.finalize("kitti", acc)
    _print_main(f"Validation KITTI: {m['epe']:f}, {m['f1']:f}")
    return {"kitti-epe": m["epe"], "kitti-f1": m["f1"]}


def create_sintel_submission(model, data_cfg: Optional[DataConfig] = None, iters: int = 32,
                             warm_start: bool = False, output_path: str = "sintel_submission",
                             write_png: bool = False, precision: Optional[str] = None,
                             fwd=None) -> None:
    """Write Sintel test-split ``.flo`` files (reference: evaluate.py:22-57),
    and with ``write_png`` their colour images under ``<output_path>_png``.
    With ``warm_start`` each frame starts from the splat of the previous
    frame's low-res flow, on the card. Each field reaches the host through
    an :class:`AsyncDrain`, behind the next frame's dispatch. Only the
    main process runs it (with the ranks of its data index under a spatial
    axis, whose forwards it needs), and it alone writes: one writer keeps
    ranks from interleaving the same files."""
    cfg = data_cfg or DataConfig()
    fwd = _forward_for(model, cfg, precision, fwd)
    runs, writes = _submission_roles(fwd)
    if not runs:
        return
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
                padder = InputPadder(img1.shape, divisor=fwd.pad_divisor)
                img1, img2 = _pad_host(padder.pad_spec, img1, img2)
                flow_lr, flow_up = fwd.forward(img1, img2, iters, flow_init=flow_prev)
                if warm_start:
                    flow_prev = forward_interpolate_batch(flow_lr)
                if writes:
                    drain.submit(flow_up, _sintel_writer(padder, output_path, dstype,
                                                         sequence, frame, write_png))
                sequence_prev = sequence


def _submission_roles(fwd: ShapeCachedForward) -> tuple[bool, bool]:
    """``(runs the forwards, writes the files)`` of this rank in a
    submission: the main process does both; under a spatial axis the other
    ranks of its data index run the forwards with it."""
    mesh = fwd.mesh
    writes = is_main_process()
    return writes or (mesh is not None and mesh.spatial > 1 and mesh.data_index == 0), writes


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
    :class:`AsyncDrain`; the main process only, as
    :func:`create_sintel_submission`."""
    cfg = data_cfg or DataConfig()
    fwd = _forward_for(model, cfg, precision, fwd)
    runs, writes = _submission_roles(fwd)
    if not runs:
        return
    dataset = ds_mod.KITTI(split="testing", root=cfg.root_kitti)
    if writes:
        os.makedirs(output_path, exist_ok=True)
    if writes and write_png:
        os.makedirs(output_path + "_png", exist_ok=True)
    with SamplePrefetcher(dataset, num_workers=cfg.num_workers) as samples, \
            AsyncDrain(depth=cfg.device_prefetch) as drain:
        for s in samples:
            (frame_id,) = s["extra_info"]
            img1 = np.asarray(s["image1"], np.float32)[None]
            img2 = np.asarray(s["image2"], np.float32)[None]
            padder = InputPadder(img1.shape, mode="kitti", divisor=fwd.pad_divisor,
                                 bucket=cfg.eval_pad_bucket)
            img1, img2 = _pad_host(padder.pad_spec, img1, img2)
            _, flow_up = fwd.forward(img1, img2, iters)
            if writes:
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
    cfg = data_cfg or DataConfig()
    fwd = _forward_for(model, cfg, precision, fwd)
    dataset, n, reduce = _shard_for_validation(dataset, fwd.mesh)
    if n == 0:
        _print_main("validate_synthetic: no frames, skipping")
        return {}
    kind = "epe_band" if style == "rigid" else "epe"
    acc = _run_metric_pass(
        fwd, dataset, kind=kind, iters=iters,
        batch_size=batch_size, pad_mode="sintel",
        band_fn=flow_boundary_mask if style == "rigid" else None,
        num_workers=cfg.num_workers, depth=cfg.device_prefetch)
    if reduce:
        acc = _reduce(acc, fwd)
    m = metrics_mod.finalize(kind, acc)
    out = {prefix: m["epe"]}
    if style == "rigid":
        out[f"{prefix}_bnd"] = m["bnd"]
        out[f"{prefix}_interior"] = m["interior"]
        _print_main(f"Validation Synthetic[{style}] EPE: {m['epe']:f}, boundary: {m['bnd']:f}, "
              f"interior: {m['interior']:f}")
    else:
        _print_main(f"Validation Synthetic EPE: {m['epe']:f}")
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
