"""Training, validation and cycgen orchestration of the port (counterpart of
the JAX package's ``train/runner.py``; the reference's
runners/InterTrainer.py) for ``syn_type inter``:

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

InterNet trains and validates (``train/inter.py``); InterRefineNet and
InterStage3Net run cycgen and mycycgen on their serving forward.  Batches
reach the card through pinned host memory and a side stream
(``_device_prefetch``); losses stay on the card and are read back once per
``disp_interval``.  The paths the port does not have yet raise
``NotImplementedError`` with their ROADMAP item: the GAN runner (item 5),
EXTRA (item 6), ``--remat`` (item 4) and sharding (item 9).
"""

from __future__ import annotations

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
from deep_video_interpolation_extrapolation_tpu_torch.core import hw
from deep_video_interpolation_extrapolation_tpu_torch.core.seg import seg_oh
from deep_video_interpolation_extrapolation_tpu_torch.data import (
    datasets as data_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.data.cityscapes import (
    N_CLASSES,
    vis_seg_ids,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.native import png
from deep_video_interpolation_extrapolation_tpu_torch.train import (
    checkpoint as ckpt_lib,
    inter as inter_lib,
    state as state_lib,
)
from deep_video_interpolation_extrapolation_tpu_torch.train.common import (
    get_inter_inputs,
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
    if cfg.model == "InterGANNet" or cfg.gan:
        raise NotImplementedError(
            "the GAN runner (InterGANNet, local-disc maps, GAN image panels) "
            f"is not ported yet ({_QUEUE}, item 5)")
    if cfg.runner == "EXTRA" or cfg.syn_type == "extra":
        raise NotImplementedError(
            f"EXTRA / syn_type extra is not ported yet ({_QUEUE}, item 6)")
    if cfg.remat:
        raise NotImplementedError(
            f"--remat is not ported yet ({_QUEUE}, item 4)")
    if cfg.num_data_shards > 1 or cfg.num_spatial_shards > 1:
        raise NotImplementedError(
            f"data and spatial sharding (DDP) are not ported yet ({_QUEUE}, "
            "item 9)")


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
    """The INTER runner of the port, on ``device`` (the card unless the
    caller asks for the CPU; without a card it raises)."""

    def __init__(self, cfg, exp_dir: str, device="cuda"):
        _check_supported(cfg)
        self.cfg = cfg
        self.exp_dir = exp_dir
        self.device = hw.entry_device(device)
        self.epoch = cfg.start_epoch
        self.vid_len = 3
        self.train_step = self.eval_step = None
        self._build_model_and_state()
        self._maybe_load()
        self.writer = _writer(cfg, exp_dir)
        self._train_loader = None
        self._val_loader = None
        self._copy_stream = None

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
        self.model = registry.build_model(cfg, device=self.device,
                                          seed=cfg.seed)
        if cfg.model == "InterNet":
            self.state = state_lib.create_train_state(cfg, self.model, vgg)
        else:      # served composites: no train state ported yet
            self.state = state_lib.TrainState(model=self.model, optimizers={},
                                              frozen_vgg=vgg)
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

    def _build_steps(self, train: bool) -> None:
        """The train or eval step, built on first use: train/inter.py has
        InterNet's and raises for the models whose steps are not ported."""
        if train and self.train_step is None:
            self.train_step = inter_lib.make_train_step(self.cfg, self.model)
        if not train and self.eval_step is None:
            self.eval_step = inter_lib.make_eval_step(self.cfg, self.model)

    # ------------------------------------------------------------- data
    def _host_batches(self, loader, depth: int):
        """The loader's batches as CPU tensors, produced by a thread that
        runs up to ``depth`` batches ahead of the consumer, so the host's
        data work (decode, augmentation, synthetic draws) overlaps the
        step's dispatch; on the card each batch is copied into pinned
        memory there.  The thread stops when the consumer stops, and its
        errors are raised in the consumer."""
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
                    host = {k: torch.from_numpy(v) for k, v in batch.items()}
                    if pin:
                        host = {k: t.pin_memory() for k, t in host.items()}
                    put(host)
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

    def _device_prefetch(self, loader, depth: int = 2):
        """Batches on the device.  A producer thread builds them on the
        host up to ``depth`` ahead (``_host_batches``).  On the card each
        pinned batch is sent by non-blocking copies on a side stream as
        soon as the step before it has been issued; the step's stream waits
        on the copy's event, and the device tensors are recorded on it
        (``record_stream``) so their memory is not reused early.  Each
        pinned buffer is kept until its copy's event has fired.  On the CPU
        the host tensors are the batch."""
        batches = self._host_batches(loader, depth)
        if self.device.type != "cuda":
            yield from batches
            return
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        stream = self._copy_stream
        compute = torch.cuda.current_stream(self.device)
        inflight: List = []            # (event, pinned batch)

        def upload(host):
            if host is None:
                return None
            with torch.cuda.stream(stream):
                dev = {k: t.to(self.device, non_blocking=True)
                       for k, t in host.items()}
                done = torch.cuda.Event()
                done.record(stream)
            inflight.append((done, host))
            return dev, done

        nxt = upload(next(batches, None))
        while nxt is not None:
            dev, done = nxt
            compute.wait_event(done)
            for t in dev.values():
                t.record_stream(compute)
            inflight[:] = [(e, h) for e, h in inflight if not e.query()]
            yield dev                  # the step that reads it is issued
            nxt = upload(next(batches, None))
        inflight.clear()

    @staticmethod
    def _read_back(pending) -> List[Dict[str, float]]:
        """Scalar dicts kept on the device -> floats, in one transfer (it
        fences the device)."""
        if not pending:
            return []
        keys = list(pending[0])
        rows = torch.stack([torch.stack([d[k].float() for k in keys])
                            for d in pending]).cpu().tolist()
        return [dict(zip(keys, row)) for row in rows]

    # ------------------------------------------------------------- train
    def _log_images(self, batch, step: int) -> None:
        """Input/pred/GT + seg-vis grid every 30 steps
        (InterTrainer.py:499-513)."""
        if not self.writer:
            return
        from deep_video_interpolation_extrapolation_tpu_torch.utils.vis import (
            make_grid,
            seg_to_rgb,
            to01,
        )
        with torch.no_grad():
            x, seg, _, _ = get_inter_inputs(batch)
            pred_rgb, pred_seg = serve.final_output(self.model(x, seg))

        def first(t):
            return t[0].float().cpu().numpy()
        row = make_grid([
            to01(first(batch["frame1"])), to01(first(pred_rgb)),
            to01(first(batch["frame2"])), to01(first(batch["frame3"])),
            seg_to_rgb(first(pred_seg)),
            vis_seg_ids(batch["seg2"][0].long().cpu().numpy()).astype(
                np.float32),
        ])
        self.writer.add_image("train/in_pred_gt", row, step)

    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        self._build_steps(train=True)
        if self._train_loader is None:
            # built once across epochs; set_epoch reshuffles
            dataset, _ = data_lib.get_dataset(cfg, vid_len=self.vid_len)
            self._train_loader = data_lib.make_loader(cfg, dataset)
        loader = self._train_loader
        loader.set_epoch(self.epoch)
        bank = MetricBank([])
        load_t = comp_t = epoch_load = epoch_comp = 0.0
        t_start = t0 = time.time()
        last: Dict[str, float] = {}
        pending = []      # loss dicts on the device, read at disp_interval
        n_samples = 0
        for i, batch in enumerate(self._device_prefetch(loader)):
            load_t += time.time() - t0
            t0 = time.time()
            self.state, losses = self.train_step(self.state, batch)
            pending.append(losses)
            n_samples += int(batch["frame1"].shape[0])
            comp_t += time.time() - t0
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
            if (self.writer and i % 30 == 0
                    and cfg.dataset != "synthetic"):
                self._log_images(batch, self.epoch * len(loader) + i)
            t0 = time.time()
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
            t0 = time.time()
            path = ckpt_lib.save_checkpoint(cfg, self.exp_dir, self.state,
                                            self.epoch, 0)
            logger.info("saved checkpoint %s in %.3fs", path,
                        time.time() - t0)
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
        for batch in self._device_prefetch(self._val_loader):
            n = int(batch["frame1"].shape[0])
            metrics = self.eval_step(self.state, batch)
            # one transfer per batch; weighted by the true batch size so
            # the tail batch does not skew the means
            bank.update(self._read_back([metrics])[0], n=n)
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
        return serve.forward(self.model, x, seg)

    def cycgen(self) -> str:
        """Recursive generation + PNG tree writer (InterTrainer.py:691-856).

        With ``--cycgen_load_dir`` it runs the reference contract
        (``_cycgen_reference``).  Without one it interpolates the midpoint
        of each val clip (up to 61) and writes rgb / seg-id / seg-vis PNGs
        ``clip_NNNNN/{rgb,seg,seg_vis}/TTT.png`` under
        ``<exp>/cycgen/<dataset>/<HxW>/<split>/``.
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
        for batch in self._device_prefetch(loader):
            # interpolation conditions on the clip's endpoints
            imgs = [batch["frame1"], batch["frame3"]]
            segs = [batch["seg1"], batch["seg3"]]
            mid_rgb, mid_seg = self._forward(
                torch.cat(imgs, dim=-1),
                torch.cat([seg_oh(s) for s in segs], dim=-1))
            frames = [imgs[0], torch.clamp(mid_rgb, -1, 1), imgs[1]]
            ids = [segs[0], torch.argmax(mid_seg, dim=-1), segs[1]]
            frames = [f.float().cpu().numpy() for f in frames]
            ids = [i.to(torch.uint8).cpu().numpy() for i in ids]
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
        frames in [0, 1] and their uint8 id maps.  With ``num_pred_once
        == 1`` the window slides by one (img1 <- img2, img2 <- pred), as
        ``serve.rollout`` does; otherwise both slots take the two newest
        predictions (runner.py:844-852 of the JAX package).
        """
        cfg = self.cfg
        if cfg.num_pred_once == 1:
            return serve.rollout(self.model, img_list, seg_list,
                                 cfg.num_pred_step)
        img1, img2 = [im * 2.0 - 1.0 for im in img_list]
        seg1, seg2 = [seg_oh(s) for s in seg_list]
        pred_imgs, pred_ids = [], []
        for _ in range(cfg.num_pred_step):
            img, seg_logits = self._forward(torch.cat([img1, img2], dim=-1),
                                            torch.cat([seg1, seg2], dim=-1))
            for j in range(cfg.num_pred_once):
                pred_imgs.append(torch.clamp(
                    (img[..., 3 * j:3 * j + 3] + 1.0) / 2.0, 0, 1))
                pred_ids.append(torch.argmax(
                    seg_logits[..., N_CLASSES * j:N_CLASSES * (j + 1)],
                    dim=-1).to(torch.uint8))
            img1 = pred_imgs[-2] * 2.0 - 1.0
            img2 = pred_imgs[-1] * 2.0 - 1.0
            seg1, seg2 = seg_oh(pred_ids[-2]), seg_oh(pred_ids[-1])
        return pred_imgs, pred_ids

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
