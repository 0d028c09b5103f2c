"""Training, validation and cycgen orchestration of the port (counterpart of
the JAX package's ``train/runner.py``; the reference's
runners/InterTrainer.py and ExtraTrainer.py) for ``syn_type inter`` and
``extra``:

- per-epoch training with a checkpoint each epoch, under the reference's
  filename contract, and ``--r`` resume;
- ``--split val`` and the ``--checkepoch_range`` sweep;
- ``--split cycgen`` (the synthetic PNG tree, or the reference's tree
  contract with ``--cycgen_load_dir``) and ``--split mycycgen``;
- tensorboardX (or ``torch.utils.tensorboard``) scalars and images with
  the reference's writer naming
  ``{split}_int_{interval}_len_{vid_len}_{dataset}_logs``
  (InterTrainer.py:108-112) where either is installed, and the load/comp
  wall-time split in the log (InterTrainer.py:375-381).

InterNet, InterRefineNet and InterStage3Net train and validate
(``train/inter.py``; the refine stages log ``refine_<scale>_*`` and
``stage3_<scale>_*`` losses and validate ``refine_*`` and ``stage3_*``
metrics), and run cycgen and mycycgen on their serving forward.
InterGANNet (recipe 4) trains through ``train/inter_gan.py`` (with
``--track_gen``, its track generator beside the coarse model; with
``--track_obj_loss``, a frozen ResNet101 built once beside the VGG19) and
validates, runs cycgen and logs its image panel through its coarse model
in eval mode (``inter_gan.GanEvalAdapter``), the VAE's z drawn from the runner's
generator (seeded by ``--seed``); its checkpoints hold every
discriminator and its Adam state under the reference's names.  A
VAEHRNet under InterNet or ExtraNet (the plain VAE) trains with its KL
term, eps from the same generator, and evaluates through the same
adapter.
ExtraNet and ExtraInpaintNet (EXTRA, recipe 6) train and validate on
``train/extra.py`` over clips of ``2 + num_pred_once * num_pred_step``
frames, and their cycgen extrapolates from each val clip's first two
frames (every predicted frame appended, ``--fix_init_frames`` honoured);
ExtraInpaintNet's checkpoints hold ``inpaint_model`` and its optimizer.  A stage
starts from the previous stage's experiment through ``--load_dir`` and
``--load_coarse`` / ``--load_refine`` (``--load_model`` names that
experiment's model).  Batches
reach the card through pinned host memory and a side stream
(``_device_prefetch``); losses stay on the card and are read back once per
``disp_interval``.  With ``DVIE_PROFILE_DIR`` set, steps 2-6 of the first
epoch are traced by ``torch.profiler`` (the host, and on the card its
kernels) into a Chrome trace in that directory, once per runner, as the
JAX runner traces them (runner.py:404-427).  The vimeo and ucf101 triplet
sets (``--mode xx2x``) carry no segmentation; ucf101 has a val split only,
so its runner validates and sweeps ``--checkepoch_range`` and ``train``
raises.

Data parallelism (``--num_data_shards``, one process a rank in a group
``parallel/dist.init_from_env`` started; runner.py:64-81, 219-233,
476-490 of the JAX package): every rank reads the same global batches
and takes its rows of each (``_host_batches``), so an epoch is the
one-process epoch; a step runs on its shard (``dist.sharded``: BatchNorm
statistics and random draws of the global batch), the optimizers step on
gradients averaged over the ranks (``train/state.apply_updates``), and the
logged losses and val metrics are reduced across the ranks.  A val batch
that does not divide over the ranks runs whole on every rank and counts
once, as JAX runs it replicated.  Only rank 0 writes checkpoints (the
others wait for it) and TensorBoard scalars.

Spatial sharding (``--num_spatial_shards S``, recipe 1: InterNet on HRNet;
runner.py:73-81, 219-231 of the JAX package): a world of D x S ranks, spatial
innermost; each rank takes its data shard's rows of every global batch and
its band of their H rows (frames and seg-id maps; ``_host_batches``), and
its step runs on the band (``parallel/spatial.banded``) on the plain route
(``registry.build_model``).  Its losses and metrics are the band's shares,
reduced for the log only (summed over the group, averaged over the data
shards); the gradients likewise (``dist.average_grads``), so the group
steps on the one-process step's gradient.  The image panel is gathered to
the group's first rank.  Every other model, ``--highres_large``,
``--remat``, cycgen and mycycgen raise ``NotImplementedError`` with their
ROADMAP item (10) before any step.
"""

from __future__ import annotations

import contextlib
import logging
import os
import pickle
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deep_video_interpolation_extrapolation_tpu_torch import serve
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    check_spatial,
)
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.core.seg import (
    oh_ids,
    seg_oh,
)
from deep_video_interpolation_extrapolation_tpu_torch.data import (
    datasets as data_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.data.cityscapes import (
    N_CLASSES,
    vis_seg_ids,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.native import png
from deep_video_interpolation_extrapolation_tpu_torch.parallel import (
    dist,
    spatial,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    checkpoint as ckpt_lib,
    extra as extra_lib,
    inter as inter_lib,
    inter_gan as gan_lib,
    state as state_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    get_inter_inputs,
    init_resnet_frozen,
    init_vgg_frozen,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.metrics import (
    MetricBank,
)

logger = logging.getLogger("dvie")

_QUEUE = "ROADMAP.md queue 1"
_MAX_CLIPS = 61           # the reference's cycgen cap (InterTrainer.py:699)


def _writer(cfg, exp_dir: str):
    """The TensorBoard writer, or None where neither tensorboardX nor
    tensorboard is installed: logging only, never a step, depends on it."""
    try:
        from tensorboardX import SummaryWriter
    except Exception:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception:
            return None
    name = f"{cfg.split}_int_{int(cfg.interval)}_len_{cfg.vid_length}_{cfg.dataset}_logs"
    return SummaryWriter(os.path.join(exp_dir, name))


def _check_supported(cfg) -> None:
    """Spatial sharding is ported for recipe 1 (InterNet on HRNet, the
    train and val splits); anything else under it raises, and so does an S
    the bands cannot take (``cli/options.check_spatial``)."""
    check_spatial(cfg)
    if cfg.num_spatial_shards <= 1:
        return
    rest = [name for name, off in (
        (f"--model {cfg.model}", cfg.model != "InterNet"),
        (f"--coarse_model {cfg.coarse_model}", cfg.coarse_model != "HRNet"),
        ("--highres_large", cfg.highres_large), ("--remat", cfg.remat),
        (f"--split {cfg.split}", cfg.split in ("cycgen", "mycycgen")))
        if off]
    if rest:
        raise NotImplementedError(
            f"spatial sharding (--num_spatial_shards) with "
            f"{', '.join(rest)} is not ported yet ({_QUEUE}, item 10)")


def _seg_ids(path: str) -> np.ndarray:
    ids = png.read_png(path, 1)
    if ids.max(initial=0) >= N_CLASSES:
        # e.g. Cityscapes 255-ignore dumps, or the reference's own saved seg
        # trees (save_image writes 255 for every id >= 1)
        raise ValueError(
            f"{path}: seg ids up to {int(ids.max())} — not a "
            f"{N_CLASSES}-class id map (cycgen_load_dir must point at "
            "myseg_id-style trees)")
    return ids


class Runner:
    """The INTER and EXTRA runner of the port, on ``device`` (the card
    unless the caller asks for the CPU; without a card it raises)."""

    def __init__(self, cfg, exp_dir: str, device="cuda"):
        _check_supported(cfg)
        self.cfg = cfg
        self.exp_dir = exp_dir
        self.device = hw.entry_device(device)
        # the data axis: the ranks of the group (1 without one) over the
        # spatial shards, each taking an equal part of every global batch;
        # the spatial axis: this rank's band of every map (None for one)
        self.spatial = cfg.num_spatial_shards
        dist.local_batch_size(cfg.batch_size, dist.data_shards(
            cfg.num_data_shards, self.spatial))
        self.band = dist.spatial_band(self.spatial)
        self.is_gan = cfg.model == "InterGANNet"
        self.is_extra = cfg.syn_type == "extra"
        # a VAEHRNet coarse (the GAN's, or the plain VAE's) evaluates
        # through the adapter, z from the generator
        self.vae_eval = (cfg.coarse_model == "VAEHRNet" and cfg.model in
                         ("InterGANNet", "InterNet", "ExtraNet"))
        # the VAE's eps and z and the sync_neg offsets; reseeded at each
        # epoch and each validation (``_reseed``)
        self.generator = torch.Generator(self.device)
        self._reseed(0)
        self.epoch = cfg.start_epoch
        # an extrapolation clip: two input frames and every predicted one
        # (runner.py:86-89); the models are built at their widths from the
        # config (conv1 by --fix_init_frames, the heads by --num_pred_once
        # and --inpaint_mask), so no example batch initialises them
        self.vid_len = (2 + cfg.num_pred_once * cfg.num_pred_step
                        if self.is_extra else 3)
        self.train_step = self.eval_step = None
        self._build_model_and_state()
        self._maybe_load()
        self.writer = _writer(cfg, exp_dir) if dist.is_main() else None
        self._train_loader = None
        self._val_loader = None
        self._copy_stream = None
        self._profiled = False     # the DVIE_PROFILE_DIR trace is taken once

    # ------------------------------------------------------------- build
    def _build_model_and_state(self) -> None:
        cfg = self.cfg
        # the refine and stage-3 bundles weigh their VGG term by
        # refine_vgg_weight: gate the frozen VGG on every weight in use
        uses_refine_vgg = (cfg.model in ("InterRefineNet", "InterStage3Net")
                           and cfg.refine_vgg_weight > 0)
        vgg = None
        if (cfg.vgg_weight > 0 or uses_refine_vgg
                or cfg.split in ("val", "test")):
            vgg = init_vgg_frozen(cfg, seed=cfg.seed + 1, device=self.device)
        resnet = None
        if self.is_gan and cfg.track_obj_loss:
            # the track-object loss's frozen ResNet101 (runner.py:126-130)
            resnet = init_resnet_frozen(cfg, seed=cfg.seed + 2,
                                        device=self.device)
        self.model = registry.build_model(cfg, device=self.device,
                                          seed=cfg.seed)
        if self.band is not None:
            logger.info("spatial sharding: band %d of %d, on the plain "
                        "route (no kernel)", self.band.index,
                        self.band.count)
        self.state = state_lib.create_train_state(cfg, self.model, vgg,
                                                  resnet)
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info("model %s: %d params, submodels=%s", cfg.model, n_params,
                    [n for n, _ in self.model.named_children()])

    def _maybe_load(self) -> None:
        cfg = self.cfg
        if cfg.torch_ckpt:
            # the submodels carry the reference's state_dict names
            ckpt = ckpt_lib.load_checkpoint(cfg.torch_ckpt, self.device)
            names = ckpt_lib.selective_load(self.state, ckpt, load_opt=False)
            logger.info("loaded torch checkpoint %s (submodels: %s)",
                        cfg.torch_ckpt, names)
        wants_load = (cfg.resume or cfg.load_coarse or cfg.load_refine
                      or cfg.load_stage3 or cfg.load_inpaint
                      or cfg.load_frame_disc or cfg.load_frame_det_disc
                      or cfg.load_video_disc or cfg.load_video_det_disc)
        if not wants_load:
            return
        name = ckpt_lib.checkpoint_name(
            cfg.replace(model=cfg.load_model, session=cfg.checksession),
            cfg.checkepoch, cfg.checkpoint)
        path = os.path.join(ckpt_lib.checkpoint_dir(cfg.load_dir), name)
        ckpt = ckpt_lib.load_checkpoint(path, self.device)
        sel = None if cfg.resume else ckpt_lib.submodels_to_load(cfg)
        ckpt_lib.selective_load(self.state, ckpt, submodels=sel)
        if cfg.resume:
            # the file stores its finished epoch + 1 (runner.py:194-197 of
            # the JAX package asserts the same)
            if ckpt["epoch"] - 1 != cfg.checkepoch:
                raise ValueError(
                    f"{path} holds epoch {ckpt['epoch'] - 1}, not "
                    f"--checkepoch {cfg.checkepoch}")
            self.epoch = ckpt["epoch"]
        logger.info("loaded checkpoint %s (submodels=%s)", path, sel or "all")

    def _reseed(self, tag: int) -> None:
        """The generator's draws of an epoch (tag = epoch) or of a
        validation (tag = 0) follow from ``--seed`` and the tag alone, so a
        resumed run draws what the uninterrupted one drew, and a
        checkpoint validates the same in a sweep and on its own."""
        self.generator.manual_seed(self.cfg.seed * 100003 + tag)

    def _eval_model(self):
        """The model of eval, cycgen and the image panels: a VAEHRNet coarse
        (the GAN's, or the plain VAE's) behind ``GanEvalAdapter`` (the JAX
        runner's ``_GanEvalAdapter``, runner.py:949), else the model."""
        if self.vae_eval:
            return gan_lib.GanEvalAdapter(self.model.coarse_model,
                                          self.generator)
        return self.model

    def _build_steps(self, train: bool) -> None:
        """The train or eval step, built on first use; the GAN evaluates
        its coarse model on the INTER eval step."""
        cfg = self.cfg
        steps = extra_lib if self.is_extra else inter_lib
        if train and self.train_step is None:
            self.train_step = (gan_lib if self.is_gan else steps
                               ).make_train_step(cfg, self.model,
                                                 self.generator)
        if not train and self.eval_step is None:
            self.eval_step = (
                inter_lib.make_eval_step(cfg.replace(model="InterNet"),
                                         self._eval_model())
                if self.is_gan else steps.make_eval_step(
                    cfg, self._eval_model()))

    # ------------------------------------------------------------- data
    def _host_batches(self, loader, depth: int, shard: bool = True):
        """``(n, batch)``: the loader's batches of ``n`` samples as CPU
        tensors, produced by a thread that runs up to ``depth`` batches
        ahead of the consumer, so the host's data work (decode,
        augmentation, synthetic draws) overlaps the step's dispatch; on the
        card each batch is copied into pinned memory there.  With ``shard``
        each rank keeps its rows of a batch that divides over the ranks
        (``dist.shard_of``), the whole of one that does not, and under
        spatial sharding its band of their frames and seg-id maps (the
        JAX ``Runner._shard``).  The thread stops when the consumer stops,
        and its errors are raised in the consumer."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()
        pin = self.device.type == "cuda"

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def produce():
            try:
                for batch in loader:
                    if stop.is_set():
                        return
                    n = len(next(iter(batch.values())))
                    part = dist.shard_of(n, self.spatial) if shard else None
                    rows = part.rows(n) if part is not None else slice(None)
                    host = {k: torch.from_numpy(v[rows])
                            for k, v in batch.items()}
                    if shard and self.band is not None:
                        host = {k: self._band_of(k, v)
                                for k, v in host.items()}
                    if pin:
                        host = {k: t.pin_memory() for k, t in host.items()}
                    put((n, host))
            except Exception as e:     # raised in the consumer below
                put(e)
                return
            put(None)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def _band_of(self, key: str, v: torch.Tensor) -> torch.Tensor:
        """This rank's band of a (B,H,W,C) frame or (B,H,W) seg-id map
        (``v`` itself without spatial sharding or for any other key)."""
        if (self.band is None or not key.startswith(("frame", "seg"))
                or v.dim() not in (3, 4)):
            return v
        return v[:, self.band.rows(v.shape[1])].contiguous()

    @contextlib.contextmanager
    def _on_shard(self, n: int):
        """The context a step on an ``n``-row global batch runs in: this
        rank's data shard and band."""
        with dist.sharded(dist.shard_of(n, self.spatial)), \
                spatial.banded(self.band):
            yield

    def _device_prefetch(self, loader, depth: int = 2, shard: bool = True):
        """``(n, batch)``: batches of ``n`` samples (this rank's rows, with
        ``shard``) on the device.  A producer thread builds them on the
        host up to ``depth`` ahead (``_host_batches``).  On the card each
        pinned batch is sent by non-blocking copies on a side stream as
        soon as the step before it has been issued; the step's stream waits
        on the copy's event, and the device tensors are recorded on it
        (``record_stream``) so their memory is not reused early.  Each
        pinned buffer is kept until its copy's event has fired.  On the CPU
        the host tensors are the batch."""
        batches = self._host_batches(loader, depth, shard)
        if self.device.type != "cuda":
            yield from batches
            return
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        stream = self._copy_stream
        compute = torch.cuda.current_stream(self.device)
        inflight: List = []            # (event, pinned batch)

        def upload(item):
            if item is None:
                return None
            n, host = item
            with torch.cuda.stream(stream):
                dev = {k: t.to(self.device, non_blocking=True)
                       for k, t in host.items()}
                done = torch.cuda.Event()
                done.record(stream)
            inflight.append((done, host))
            return n, dev, done

        nxt = upload(next(batches, None))
        while nxt is not None:
            n, dev, done = nxt
            compute.wait_event(done)
            for t in dev.values():
                t.record_stream(compute)
            inflight[:] = [(e, h) for e, h in inflight if not e.query()]
            yield n, dev               # the step that reads it is issued
            nxt = upload(next(batches, None))
        inflight.clear()

    def _read_back(self, pending, reduce: bool = True
                   ) -> List[Dict[str, float]]:
        """Scalar dicts kept on the device -> floats, in one transfer (it
        fences the device); with ``reduce`` averaged over the ranks (every
        rank calls it with its own), the bands' shares summed over each
        spatial group."""
        if not pending:
            return []
        keys = list(pending[0])
        rows = torch.stack([torch.stack([d[k].float() for k in keys])
                            for d in pending])
        if reduce:
            rows = dist.mean_over_ranks(rows, self.spatial)
        rows = rows.cpu().tolist()
        return [dict(zip(keys, row)) for row in rows]

    # ------------------------------------------------------------- train
    def _log_images(self, batch, step: int) -> None:
        """Input/pred/GT + seg-vis grid every 30 steps
        (InterTrainer.py:499-513); in extrapolation the two input frames,
        the first predicted frame, its ground truth frame3 and their
        segs.  Under spatial sharding every rank runs the forward on its
        band and the first sample's maps are gathered to the group's first
        rank."""
        if not (self.writer or self.band):
            return
        from deep_video_interpolation_extrapolation_tpu_torch.utils.vis import (
            make_grid,
            seg_to_rgb,
            to01,
        )
        gt = f"seg{'3' if self.is_extra else '2'}"
        with torch.no_grad(), spatial.banded(self.band):
            x, seg = self._inputs(batch)
            pred_rgb, pred_seg = serve.final_output(self._eval_model()(x,
                                                                       seg))
            # the first sample of each map, whole on the group's first rank
            maps = {k: spatial.gather_rows(t[:1]) for k, t in (
                ("pred_rgb", pred_rgb), ("pred_seg", pred_seg),
                *((k, batch[k].float()) for k in ("frame1", "frame2",
                                                  "frame3", gt)))}
        if not self.writer:
            return

        def first(k):
            return maps[k][0].float().cpu().numpy()
        frames = (["frame1", "frame2", "pred_rgb"] if self.is_extra else
                  ["frame1", "pred_rgb", "frame2"])
        row = make_grid([
            *(to01(first(k)[..., :3]) for k in frames),
            to01(first("frame3")),
            seg_to_rgb(first("pred_seg")[..., :N_CLASSES]),
            vis_seg_ids(oh_ids(maps[gt][0].to(batch[gt].dtype)).long()
                        .cpu().numpy()).astype(np.float32),
        ])
        self.writer.add_image("train/in_pred_gt", row, step)

    def _inputs(self, batch):
        """The first forward's (rgb, seg) of a batch: frames 1 and 3 in
        interpolation; frames 1 and 2 in extrapolation, behind frame 2
        under ``--fix_init_frames``."""
        if not self.is_extra:
            x, seg, _, _ = get_inter_inputs(batch)
            return x, seg
        pair = ("1", "2") if not self.cfg.fix_init_frames else ("2", "1", "2")
        return (torch.cat([batch[f"frame{i}"] for i in pair], dim=-1),
                torch.cat([seg_oh(batch[f"seg{i}"]) for i in pair], dim=-1))

    def _local_disc_maps(self, batch, pred_rgb, pred_seg) -> List:
        """The local discriminators' probability maps on the panel's sample
        (real, then fake; frame then video family) for the ``--local_disc``
        heatmap row (InterGANTrainer.py:228-239,535-544; runner.py:236-279
        of the JAX package): eval passes, nothing stored.  Empty when no
        family gives a spatial map."""
        from deep_video_interpolation_extrapolation_tpu_torch.utils.vis import (
            prob_heatmap,
        )
        cfg = self.cfg
        x, seg, gt_x, gt_seg = get_inter_inputs(batch)
        fake_rgb = torch.clamp(pred_rgb, -1, 1)
        fake_seg = torch.softmax(pred_seg, dim=-1)
        maps = []
        with torch.no_grad():
            for flag, attr, video in (("frame_disc", "frame_disc_model",
                                       False),
                                      ("video_disc", "video_disc_model",
                                       True)):
                if not getattr(cfg, flag):
                    continue
                disc = getattr(self.model, attr)
                extra = (x, seg) if video else ()
                for img, s in ((gt_x, gt_seg), (fake_rgb, fake_seg)):
                    o = disc(img, s, *extra, bboxes=batch.get("bboxes"),
                             train=False)
                    if o.dim() == 4:
                        # clamped, then (x + 1) / 2 (InterGANTrainer.py:536)
                        p = (torch.clamp(o[0].float(), -1, 1) + 1) / 2
                        maps.append(prob_heatmap(p.cpu().numpy()))
        return maps

    def _log_gan_images(self, batch, step: int) -> None:
        """The GAN trainer's panel (InterGANTrainer.py:209-259;
        runner.py:281-323 of the JAX package): a 4-wide grid of the ground
        truth frames with the coarse frame inserted, their seg maps, the
        box overlays where a box consumer is on, and the local
        discriminators' heatmaps under ``--local_disc``."""
        from deep_video_interpolation_extrapolation_tpu_torch.utils.vis import (
            draw_bbox,
            make_grid,
            seg_to_rgb,
            to01,
        )
        cfg = self.cfg
        with torch.no_grad():
            x, seg, _, _ = get_inter_inputs(batch)
            pred_rgb, pred_seg = self._eval_model()(x, seg)

        def first(t):
            return t[0].float().cpu().numpy()
        f = [to01(first(batch[f"frame{i}"])) for i in (1, 2, 3)]
        s = [vis_seg_ids(oh_ids(batch[f"seg{i}"][0]).long().cpu().numpy()
                         ).astype(np.float32) for i in (1, 2, 3)]
        rgbs = [f[0], f[1], to01(first(pred_rgb)), f[2]]
        imgs = rgbs + [s[0], s[1], seg_to_rgb(first(pred_seg)), s[2]]
        need_bbox = (cfg.frame_det_disc or cfg.video_det_disc
                     or cfg.track_obj_loss or cfg.track_gen
                     or "Det" in cfg.frame_disc_model
                     or "Det" in cfg.video_disc_model)
        if need_bbox and "bboxes" in batch:
            bb = batch["bboxes"][0].float().cpu().numpy()
            # rows 0/1/2 of the track tensor; the coarse tile takes the
            # mid frame's boxes (InterGANTrainer.py:243-251)
            brow = [draw_bbox(rgbs[0], bb[0, :, -4:]),
                    draw_bbox(rgbs[1], bb[1, :, -4:]),
                    draw_bbox(rgbs[2], bb[1, :, -4:]),
                    draw_bbox(rgbs[3], bb[2, :, -4:])]
            imgs = imgs[:4] + brow + imgs[4:]
        if cfg.local_disc and cfg.split == "train":
            imgs += self._local_disc_maps(batch, pred_rgb, pred_seg)
        self.writer.add_image("train/gan_panel", make_grid(imgs, nrow=4),
                              step)

    def _start_trace(self):
        """``torch.profiler`` over the host and, on the card, the device
        (runner.py:404-427 of the JAX package traces with
        ``jax.profiler``)."""
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._profiled = True
        return prof

    def _stop_trace(self, prof, profile_dir: str, last: int) -> None:
        """Ends the trace once the device has run the traced steps, and
        writes it as a Chrome trace into ``profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"dvie_trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        logger.info("trace of steps 2-%d written to %s", last, path)

    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        self._build_steps(train=True)
        if self._train_loader is None:
            # built once across epochs; set_epoch reshuffles
            dataset, _ = data_lib.get_dataset(cfg, vid_len=self.vid_len)
            if dataset is None:
                raise ValueError(f"--dataset {cfg.dataset} has no train "
                                 "split (it is val only)")
            self._train_loader = data_lib.make_loader(cfg, dataset)
        loader = self._train_loader
        loader.set_epoch(self.epoch)
        self._reseed(self.epoch)
        bank = MetricBank([])
        load_t = comp_t = epoch_load = epoch_comp = 0.0
        t_start = t0 = time.time()
        last: Dict[str, float] = {}
        pending = []      # loss dicts on the device, read at disp_interval
        n_samples = 0
        # DVIE_PROFILE_DIR: one trace of steps 2-6 per runner (one a
        # process, through the launcher); an epoch of fewer than 7 steps
        # ends it at the epoch's end
        profile_dir = (None if self._profiled
                       else os.environ.get("DVIE_PROFILE_DIR"))
        prof = None
        for i, (n, batch) in enumerate(self._device_prefetch(loader)):
            if profile_dir and i == 2:
                prof = self._start_trace()
            load_t += time.time() - t0
            t0 = time.time()
            with self._on_shard(n):
                self.state, losses = self.train_step(self.state, batch)
            pending.append(losses)
            n_samples += n
            comp_t += time.time() - t0
            if prof is not None and i == 6:
                self._stop_trace(prof, profile_dir, i)
                prof = None
            t0 = time.time()  # the readback below is timed on its own
            if i % cfg.disp_interval == 0:
                for d in self._read_back(pending):
                    last = d
                    bank.update(d)
                pending = []
                comp_t += time.time() - t0  # the readback fences the device
                logger.info(
                    "[epoch %2d][iter %4d] loss: %.4f, load: %.3fs, comp: %.3fs",
                    self.epoch, i, last["loss_all"], load_t, comp_t)
                epoch_load += load_t
                epoch_comp += comp_t
                load_t = comp_t = 0.0
                if self.writer:
                    step = self.epoch * len(loader) + i
                    self.writer.add_scalars("losses", bank.averages(), step)
                    bank = MetricBank([])
            if ((self.writer or self.band) and i % 30 == 0
                    and cfg.dataset != "synthetic"):
                log = self._log_gan_images if self.is_gan else \
                    self._log_images
                log(batch, self.epoch * len(loader) + i)
            t0 = time.time()
        if prof is not None:
            self._stop_trace(prof, profile_dir, i)
        for d in self._read_back(pending):
            last = d
            bank.update(d)
        epoch_comp += comp_t + time.time() - t0
        epoch_load += load_t
        wall = time.time() - t_start
        logger.info(
            "[epoch %2d] %d samples in %.3fs: %.4f samples/s, load: %.3fs, "
            "comp: %.3fs", self.epoch, n_samples, wall,
            n_samples / max(wall, 1e-9), epoch_load, epoch_comp)
        return last

    def train_epochs(self) -> None:
        cfg = self.cfg
        while self.epoch <= cfg.epochs:
            self.train()
            if dist.is_main():
                t0 = time.time()
                path = ckpt_lib.save_checkpoint(cfg, self.exp_dir,
                                                self.state, self.epoch, 0)
                logger.info("saved checkpoint %s in %.3fs", path,
                            time.time() - t0)
            dist.barrier()             # the file exists for every rank
            self.epoch += 1

    # ------------------------------------------------------------- val
    def validate(self) -> Dict[str, float]:
        """Metrics over the val split, whatever split the runner was built
        for (a train runner validates too)."""
        cfg = self.cfg
        self._build_steps(train=False)
        if self._val_loader is None:
            vcfg = cfg.replace(split="val")
            _, dataset = data_lib.get_dataset(vcfg, vid_len=self.vid_len)
            self._val_loader = data_lib.make_loader(vcfg, dataset,
                                                    shuffle=False)
        bank = MetricBank([])
        self._reseed(0)
        for n, batch in self._device_prefetch(self._val_loader):
            with self._on_shard(n):
                metrics = self.eval_step(self.state, batch)
            # one transfer per batch; weighted by the true batch size so
            # the tail batch does not skew the means.  A sharded batch's
            # equal parts average over the ranks; a whole one (every rank
            # ran it) counts once; the bands' shares always add up
            reduce = (dist.shard_of(n, self.spatial) is not None
                      or self.band is not None)
            bank.update(self._read_back([metrics], reduce=reduce)[0], n=n)
        avg = bank.averages()
        logger.info("[val epoch %d] %s", self.epoch,
                    " ".join(f"{k}: {v:.4f}" for k, v in avg.items()))
        if self.writer:
            for k, v in avg.items():
                self.writer.add_scalar(f"val/{k}", v, self.epoch)
        return avg

    def validate_range(self) -> Dict[int, Dict[str, float]]:
        """--checkepoch_range sweep (main.py:100-106)."""
        cfg = self.cfg
        results = {}
        for ep in range(cfg.checkepoch_low, cfg.checkepoch_up + 1):
            name = ckpt_lib.checkpoint_name(
                cfg.replace(model=cfg.load_model, session=cfg.checksession),
                ep, cfg.checkpoint)
            path = os.path.join(ckpt_lib.checkpoint_dir(cfg.load_dir), name)
            if not os.path.exists(path):
                logger.warning("skip missing checkpoint %s", path)
                continue
            ckpt = ckpt_lib.load_checkpoint(path, self.device)
            ckpt_lib.selective_load(self.state, ckpt)
            self.epoch = ep
            results[ep] = self.validate()
        return results

    # ------------------------------------------------------------- cycgen
    def _forward(self, x: torch.Tensor, seg: torch.Tensor):
        """The serving forward's final (rgb, seg logits)
        (``Runner._final_output``)."""
        return serve.forward(self._eval_model(), x, seg)

    def cycgen(self) -> str:
        """Recursive generation + PNG tree writer (InterTrainer.py:691-856).

        With ``--cycgen_load_dir`` it runs the reference contract
        (``_cycgen_reference``).  Without one it interpolates the midpoint
        of each val clip (up to 61), or extrapolates ``num_pred_step``
        steps from its first two frames (runner.py:573-611), and writes
        rgb / seg-id / seg-vis PNGs ``clip_NNNNN/{rgb,seg,seg_vis}/TTT.png``
        under ``<exp>/cycgen/<dataset>/<HxW>/<split>/``.
        """
        if self.cfg.cycgen_load_dir:
            return self._cycgen_reference()
        cfg = self.cfg
        out_root = os.path.join(
            self.exp_dir, "cycgen", cfg.dataset,
            f"{cfg.input_h}x{cfg.input_w}", cfg.split)
        os.makedirs(out_root, exist_ok=True)
        vcfg = cfg.replace(split="val")
        dataset, val_ds = data_lib.get_dataset(vcfg, vid_len=self.vid_len)
        loader = data_lib.make_loader(vcfg, val_ds or dataset, shuffle=False)
        n_clips = 0
        for _, batch in self._device_prefetch(loader, shard=False):
            frames, ids = (self._extrapolate(batch) if self.is_extra
                           else self._interpolate(batch))
            frames = [f.float().cpu().numpy() for f in frames]
            # a frame with no segmentation is written as class 0, the
            # argmax of the JAX package's all-zero one-hot
            ids = [oh_ids(i).to(torch.uint8).cpu().numpy() for i in ids]
            for b in range(frames[0].shape[0]):
                if n_clips >= _MAX_CLIPS:
                    break
                clip_dir = os.path.join(out_root, f"clip_{n_clips:05d}")
                for kind in ("rgb", "seg", "seg_vis"):
                    os.makedirs(os.path.join(clip_dir, kind), exist_ok=True)
                for t, (fr, sg) in enumerate(zip(frames, ids)):
                    rgb8 = ((fr[b] + 1) * 127.5).clip(0, 255).astype(np.uint8)
                    name = f"{t:03d}.png"
                    png.save_png(os.path.join(clip_dir, "rgb", name), rgb8)
                    png.save_png(os.path.join(clip_dir, "seg", name), sg[b])
                    vis = (vis_seg_ids(sg[b]) * 255).astype(np.uint8)
                    png.save_png(os.path.join(clip_dir, "seg_vis", name), vis)
                n_clips += 1
            if n_clips >= _MAX_CLIPS:
                break
        logger.info("cycgen: wrote %d clips under %s", n_clips, out_root)
        return out_root

    def _interpolate(self, batch):
        """A clip's frames and seg ids for cycgen: the midpoint predicted
        from the clip's endpoints."""
        imgs = [batch["frame1"], batch["frame3"]]
        segs = [batch["seg1"], batch["seg3"]]
        mid_rgb, mid_seg = self._forward(
            torch.cat(imgs, dim=-1),
            torch.cat([seg_oh(s) for s in segs], dim=-1))
        return ([imgs[0], torch.clamp(mid_rgb, -1, 1), imgs[1]],
                [segs[0], torch.argmax(mid_seg, dim=-1), segs[1]])

    def _extrapolate(self, batch):
        """A clip's frames and seg ids for cycgen in extrapolation: frames
        1 and 2, then every frame of ``num_pred_step`` forwards, each on
        the two newest frames (clipped to [-1, 1]), behind frame 2 under
        ``--fix_init_frames`` (runner.py:590-611)."""
        cfg = self.cfg
        frames = [batch["frame1"], batch["frame2"]]
        ids = [batch["seg1"].long(), batch["seg2"].long()]
        for _ in range(cfg.num_pred_step):
            window = [1] * cfg.fix_init_frames + [-2, -1]
            x = torch.cat([frames[i] for i in window], dim=-1)
            seg = torch.cat([seg_oh(ids[i]) for i in window], dim=-1)
            rgb, seg_logits = self._forward(x, seg)
            for j in range(cfg.num_pred_once):
                frames.append(torch.clamp(rgb[..., 3 * j:3 * j + 3], -1, 1))
                ids.append(torch.argmax(
                    seg_logits[..., N_CLASSES * j:N_CLASSES * (j + 1)],
                    dim=-1))
        return frames, ids

    def _clip_dirs(self, load_img_dir: str) -> List[str]:
        """``root_clip.pkl``'s first 61 ``val`` entries
        (InterTrainer.py:693-706), else the sorted clip directories of the
        load tree."""
        root_clip = os.path.join(data_lib.data_root(), "load_files",
                                 "root_clip.pkl")
        if os.path.exists(root_clip):
            with open(root_clip, "rb") as f:
                clips = pickle.load(f)
            return [row[0] if isinstance(row, (list, tuple)) else row
                    for row in clips["val"][:_MAX_CLIPS]]
        dirs = []
        for base, _dirs, files in os.walk(load_img_dir):
            if any(f.endswith(".png") for f in files):
                dirs.append(os.path.relpath(base, load_img_dir))
        return sorted(dirs)[:_MAX_CLIPS]

    def _cycgen_reference(self) -> str:
        """The reference's cycgen tree contract (InterTrainer.py:691-783).

        - Reads frames ``{NN:0>2d}.0.png`` at NN = 0 and ``interval`` from
          ``<cycgen_load_dir>/rgb/<clipdir>/`` and seg-id PNGs from
          ``<cycgen_load_dir>/seg/<clipdir>/``.
        - Runs ``_mini_test``'s sliding-window rollout ``num_pred_step``
          times (InterTrainer.py:786-856).
        - Writes ``<exp>/cycgen/<dataset>/<HxW>/
          extra_int_{interval}_len_{vid_length}_nearest/{rgb,seg,vis_seg}/
          <clipdir>/NN.0.png`` with NN = i * interval for i in
          range(vid_length + 2).

        As in the JAX package, the seg trees hold the uint8 ids (the
        reference's ``save_image`` wrote 255 for every id >= 1).
        """
        cfg = self.cfg
        load_img_dir = os.path.join(cfg.cycgen_load_dir, "rgb")
        load_seg_dir = os.path.join(cfg.cycgen_load_dir, "seg")
        split_name = (f"extra_int_{int(cfg.interval)}_len_{cfg.vid_length}"
                      "_nearest")
        out_root = os.path.join(
            self.exp_dir, "cycgen", cfg.dataset,
            f"{cfg.input_h}x{cfg.input_w}", split_name)
        save_dirs = {k: os.path.join(out_root, k)
                     for k in ("rgb", "seg", "vis_seg")}
        first_index = 0
        second_index = first_index + int(cfg.interval)

        def to_device(a):
            return torch.from_numpy(a).to(self.device)[None]

        n_done = 0
        for clip_dir in self._clip_dirs(load_img_dir):
            img_files = [os.path.join(load_img_dir, clip_dir, f"{i:0>2d}.0.png")
                         for i in (first_index, second_index)]
            seg_files = [os.path.join(load_seg_dir, clip_dir, f"{i:0>2d}.0.png")
                         for i in (first_index, second_index)]
            if not all(os.path.exists(p) for p in img_files + seg_files):
                logger.warning("cycgen: skip %s (missing input frames)",
                               clip_dir)
                continue
            rgb01 = [png.read_png(p, 3).astype(np.float32) / 255.0
                     for p in img_files]
            ids = [_seg_ids(p) for p in seg_files]
            pred_imgs, pred_ids = self._mini_test(
                [to_device(a) for a in rgb01], [to_device(a) for a in ids])
            save_imgs = rgb01 + [p[0].float().cpu().numpy() for p in pred_imgs]
            save_ids = ids + [p[0].to(torch.uint8).cpu().numpy()
                              for p in pred_ids]
            n_save = cfg.vid_length + 2
            assert len(save_imgs) >= n_save, (len(save_imgs), n_save)
            for k in save_dirs.values():
                os.makedirs(os.path.join(k, clip_dir), exist_ok=True)
            for i in range(n_save):
                name = f"{int(first_index + i * cfg.interval):0>2d}.0.png"
                rgb8 = (save_imgs[i] * 255.0 + 0.5).clip(0, 255).astype(
                    np.uint8)          # rounded (InterTrainer.py:745-779)
                png.save_png(os.path.join(save_dirs["rgb"], clip_dir, name),
                             rgb8)
                png.save_png(os.path.join(save_dirs["seg"], clip_dir, name),
                             save_ids[i])
                vis = (vis_seg_ids(save_ids[i]) * 255).astype(np.uint8)
                png.save_png(os.path.join(save_dirs["vis_seg"], clip_dir,
                                          name), vis)
            n_done += 1
        logger.info("cycgen: wrote %d clips under %s", n_done, out_root)
        return out_root

    def _mini_test(self, img_list, seg_list):
        """Sliding-window rollout (InterTrainer.py:786-856).

        img_list: two (B,H,W,3) frames in [0, 1]; seg_list: two (B,H,W)
        uint8 id maps.  Returns ``num_pred_step * num_pred_once`` predicted
        frames in [0, 1] and their uint8 id maps: ``serve.rollout``, whose
        window slides by one at ``num_pred_once == 1`` and otherwise takes
        the two newest predictions (runner.py:844-852 of the JAX package),
        with the second input frame before every window under
        extrapolation's ``--fix_init_frames`` (runner.py:827-836); on the
        serving forward (``_forward``).
        """
        cfg = self.cfg
        return serve.rollout_with(self._forward, img_list, seg_list,
                                  cfg.num_pred_step, cfg.num_pred_once,
                                  self.is_extra and cfg.fix_init_frames)

    def mycycgen(self, first_index: int = 25) -> str:
        """Legacy Refiner ``mycycgen`` (runners/refiner.py:835-1010): read
        frames ``{first_index}.0.png`` and ``{first_index+2}.0.png`` (plus
        ``seg/`` id PNGs in xs2xs mode) from an existing cycgen PNG tree,
        interpolate the middle frame with one forward, and write
        ``{first_index+1}.0.png`` (rgb) and its argmax-seg id PNG back into
        the same tree.  The tree root is ``--cycgen_load_dir`` (any clip
        subdirectory, capped at 61); a cycgen-written tree (rgb/seg/vis_seg
        siblings) is read through its ``rgb`` directory.
        """
        cfg = self.cfg
        root = cfg.cycgen_load_dir or os.path.join(
            self.exp_dir, "cycgen", cfg.dataset,
            f"{cfg.input_h}x{cfg.input_w}", "extra_wing")
        if not os.path.isdir(root):
            raise SystemExit(f"mycycgen: load tree {root!r} does not exist")
        seg_root = os.path.join(root, "seg")
        if os.path.isdir(os.path.join(root, "rgb")):
            root = os.path.join(root, "rgb")
        clip_dirs = []
        for base, _dirs, files in os.walk(root):
            if any(f.endswith(".png") for f in files):
                clip_dirs.append(os.path.relpath(base, root))
        clip_dirs = sorted(d for d in clip_dirs
                           if d != "seg" and not d.startswith("seg/"))
        clip_dirs = clip_dirs[:_MAX_CLIPS]

        def load_rgb(path):
            arr = png.read_png(path, 3).astype(np.float32)
            return torch.from_numpy(arr / 127.5 - 1.0).to(self.device)[None]

        def load_seg(path):
            return seg_oh(torch.from_numpy(_seg_ids(path)).to(
                self.device))[None]

        i0, i2 = first_index, first_index + 2
        n_done = 0
        for clip in clip_dirs:
            f0 = os.path.join(root, clip, f"{i0:0>2d}.0.png")
            f2 = os.path.join(root, clip, f"{i2:0>2d}.0.png")
            if not (os.path.exists(f0) and os.path.exists(f2)):
                logger.warning("mycycgen: skip %s (missing %02d/%02d)",
                               clip, i0, i2)
                continue
            x = torch.cat([load_rgb(f0), load_rgb(f2)], dim=-1)
            seg: Optional[torch.Tensor] = None
            if cfg.mode == "xs2xs":
                seg = torch.cat([
                    load_seg(os.path.join(seg_root, clip, f"{i:0>2d}.0.png"))
                    for i in (i0, i2)], dim=-1)
            pred_rgb, pred_seg = self._forward(x, seg)
            rgb8 = ((pred_rgb[0].float().cpu().numpy().clip(-1, 1) + 1)
                    * 127.5).astype(np.uint8)
            png.save_png(os.path.join(root, clip, f"{i0 + 1:0>2d}.0.png"),
                         rgb8)
            if pred_seg is not None:
                ids = torch.argmax(pred_seg[0], dim=-1).to(torch.uint8)
                seg_dir = os.path.join(seg_root, clip)
                os.makedirs(seg_dir, exist_ok=True)
                png.save_png(os.path.join(seg_dir, f"{i0 + 1:0>2d}.0.png"),
                             ids.cpu().numpy())
            n_done += 1
        logger.info("mycycgen: interpolated frame %02d.0 for %d clips under %s",
                    first_index + 1, n_done, root)
        return root
