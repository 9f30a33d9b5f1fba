"""Training: the losses, the train step and the epoch loop (port of
``csof_tpu/training/trainer.py``, every model kind: ``"segflow"``,
``"unet2d"``, ``"unet3d"``, ``"raft"`` and ``"voxelmorph"``).

A SegFlow step is: batch to the device, the batched SegFlow forward, the
loss of each video (means over the batch of per-video losses, as the JAX
package's ``vmap`` gives), backward (K1 forward, K2 backward in every skip
fuse on CUDA tensors), clip by global norm, AdamW under the warm-up cosine
schedule. A U-Net step is nnU-Net's recipe: the channels-last patch batch
moved to NCHW (NCDHW for ``unet3d``) on the device, the deep-supervision Dice + CE over the heads,
backward (K6 forward and dx where ``CSOF_CONV2D_IMPL=pallas`` routes a conv
to it), clip 12, SGD with Nesterov momentum under the poly schedule; the
validation batches' Dice statistics give the online foreground Dice. With
``config.data.do_data_aug`` a train step first augments its batch on the
device (:mod:`csof_tpu_torch.data.augment`: ``augment_batch_2d`` for the
2D U-Net, ``augment_video`` for SegFlow, whose unlabelled frames stay -1;
the 3D U-Net is not augmented, as in JAX), from
a generator of the seed and the step, as the JAX step does; validation
batches are not augmented. The epoch loop keeps the JAX trainer's
best-criterion EMA, patience and checkpoint cadence; ``load_checkpoint``
reads the port's ``.pt`` triad or the JAX package's msgpack one. SegFlow
trains in every ``corr_fuse`` mode but the forward-only ``fused_cm``, with
``fuse_q_hoist``, ``deep_supervision`` (its loss branch),
``dec_upsample="linear"`` and ``remat``; under ``CSOF_CONV2D_IMPL=pallas``
its routed convs run K6 both ways. A RAFT step takes "image1" and
"image2" (B, H, W, C): the sequence loss over the iterations where the
batch holds "flow_gt", else the NCC of "image2" warped (border) by the last
flow against "image1" plus its smoothness; a VoxelMorph step takes
"moving" and "fixed" (B, H, W, C): ``image_flow_global`` x NCC(registered,
fixed) + ``regularization_xy`` x the flow's smoothness. Neither is
augmented, as in JAX; both run the library's convs. ``run_training``
writes the JAX trainer's observability files beside the checkpoints:
``debug.json`` and ``network_architecture.txt`` at its start
(:meth:`Trainer.save_debug_information`), the timestamped
``training_log_<Y>_<M>_<D>_<hh>_<mm>_<ss>.txt`` and ``progress.png`` after
each epoch (:mod:`csof_tpu_torch.utils.logging`); with ``tensorboard=True``
also ``loss/train``, ``loss/val`` and ``metric/fg_dice`` each epoch to a
TensorBoard event file in ``tb/`` (the port's own writer,
:class:`csof_tpu_torch.utils.visualization.TensorBoardVisualizer`).

Under an initialized ``torch.distributed`` process group the trainer is
data parallel, as the JAX trainer on a mesh: its :class:`Mesh` comes from
``config.mesh_data`` / ``config.mesh_model`` (the data size cut to a divisor
of the global batch, as JAX clamps it), every rank takes the global host
batch and keeps its rows (its augmentation draws are the global batch's
rows), the model trains wrapped in ``DistributedDataParallel``, the U-Net's
batch Dice and its validation statistics are summed over the global batch
(:func:`csof_tpu_torch.parallel.mesh.global_batch_dice_stats`), losses are
averaged over the ranks, and only rank 0 writes the logs, ``debug.json``,
``progress.png``, TensorBoard and the checkpoints, so every rank takes the
same early-stop and checkpoint decisions. Not ported: compile-draw
autotuning.

While a ``torch.profiler`` records, a train step opens its phases as
spans (:func:`csof_tpu_torch.utils.profiling.span`), all inside
``csof:train.step``: ``train.input`` (the batch fitted to the mesh, sharded
and copied to the device), ``train.augment``, ``train.forward`` (the
network's forward; for the kinds other than the U-Net's, the whole loss),
``train.loss`` (the U-Net's deep-supervision loss and Dice statistics),
``train.backward`` (zero_grad and backward, DDP's all-reduce included),
``train.optimizer`` and ``train.loss_read`` (the loss to the host, averaged
over the ranks). An evaluation opens none.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from csof_tpu_torch.compat.flax_import import load_flax_train_state
from csof_tpu_torch.config.experiment import ExperimentConfig
from csof_tpu_torch.data.augment import augment_batch_2d, augment_video, step_generator
from csof_tpu_torch.models.blocks import kernel_switches
from csof_tpu_torch.models.raft import RAFT
from csof_tpu_torch.models.segflow import SegFlow
from csof_tpu_torch.models.unet import GenericUNet, unet_from_plans
from csof_tpu_torch.models.voxelmorph import VoxelMorph
from csof_tpu_torch.ops import losses as L
from csof_tpu_torch.ops.warp import warp_batch, warp_image_cm
from csof_tpu_torch.parallel.mesh import (Mesh, all_mean, fit_batch, global_batch_dice_stats,
                                          make_mesh, shard_batch)
from csof_tpu_torch.training import checkpoint as ckpt
from csof_tpu_torch.training.schedules import build_optimizer
from csof_tpu_torch.utils import profiling
from csof_tpu_torch.utils.logging import TrainingLog, count_parameters, model_summary, plot_progress
from csof_tpu_torch.utils.visualization import TensorBoardVisualizer

TRAINED_CORR_FUSE = ("concat", "split", "project", "mean1", "concat_cm")
TRAINED_KINDS = ("segflow", "unet2d", "unet3d", "raft", "voxelmorph")
UNET_KINDS = ("unet2d", "unet3d")
#: the kinds whose train step augments its batch (as in JAX)
AUGMENTED_KINDS = ("unet2d", "segflow")


def build_model(config: ExperimentConfig, num_classes: int | None = None,
                generator: torch.Generator | None = None, plans=None) -> torch.nn.Module:
    """The model of ``config``: SegFlow, RAFT or 2D VoxelMorph on one-channel
    frames, or the U-Net of ``plans`` (without
    plans the JAX package's default: base 16, 4 pools of 2 and kernels of 3
    in every axis, 2-D for ``unet2d`` and 3-D for ``unet3d``, no remat). The
    models read their kernel switches from the environment as the JAX
    package reads them (``CSOF_CONV2D_IMPL``, ``CSOF_CONV3D_IMPL``,
    ``CSOF_FUSED_NORM``, and for plans ``CSOF_REMAT_POLICY``)."""
    kind = config.model
    if kind == "segflow":
        return SegFlow(config.segflow, num_classes or 4, generator=generator)
    if kind == "raft":
        return RAFT(config.raft, 1, generator)
    if kind == "voxelmorph":
        return VoxelMorph(config.voxelmorph, 1, 2, generator)
    if kind in UNET_KINDS:
        if plans is not None:
            return unet_from_plans(plans, deep_supervision=config.deep_supervision,
                                   generator=generator)
        nd = 2 if kind == "unet2d" else 3
        switches = kernel_switches(nd)
        return GenericUNet(num_classes=num_classes or 4, base_num_features=16,
                           pool_kernel_sizes=((2,) * nd,) * 4, conv_kernel_sizes=((3,) * nd,) * 5,
                           deep_supervision=config.deep_supervision,
                           fused_norm_act=switches.fused_norm_act, conv_impl=switches.conv_impl,
                           generator=generator)
    raise ValueError(f"unknown model kind {kind!r}")


def _check_trainable(config: ExperimentConfig, for_training: bool = True) -> None:
    if config.model not in TRAINED_KINDS:
        raise NotImplementedError(f"training model {config.model!r} is not ported "
                                  f"(ported: {TRAINED_KINDS})")
    if not for_training:
        return
    if config.model == "segflow" and config.segflow.corr_fuse not in TRAINED_CORR_FUSE:
        raise NotImplementedError(
            f"training with corr_fuse={config.segflow.corr_fuse!r} is not ported: kernel K3 "
            f"has no backward, in the JAX package either (trained: {TRAINED_CORR_FUSE})")
    # K5 runs on 2D blocks only (InstanceNorm on a 4-D tensor in JAX): a 3D
    # U-Net trains with the switch set, as it does in the JAX package, and so
    # do RAFT and VoxelMorph, which never run it
    if config.model in ("unet2d", "segflow") and kernel_switches(2).fused_norm_act:
        raise NotImplementedError(
            "CSOF_FUSED_NORM=1 (fused_norm_act) runs kernel K5, which has no backward: the "
            "JAX package uses it for inference only. Unset it to train.")


def make_seg_loss(config: ExperimentConfig, mesh: Mesh | None = None):
    """loss_fn(model, batch) -> (loss, {"tp", "fp", "fn"}) of the U-Net:
    the deep-supervision Dice + CE over the heads against the seg map
    downsampled to each head's scale, and the soft Dice statistics of the
    full-resolution head summed over the batch (per class). batch: "data"
    (B, C, H, W) float32 and "seg" (B, H, W) int, on the model's device.
    With the ``mesh`` of a process group, the batch Dice and the
    statistics are the global batch's. The JAX loss fences the heads with
    an XLA scheduling barrier (``fence_outputs``); it computes the identity
    and has no counterpart here."""

    def head_loss(logits, target):
        return L.dice_and_ce_loss(logits, target, mesh=mesh)

    def loss_fn(model: torch.nn.Module, batch: dict):
        # a train step's spans; an evaluation runs under no_grad and opens none
        span = profiling.span if torch.is_grad_enabled() else profiling.no_span
        with span("train.forward"):
            outs = model(batch["data"])
        with span("train.loss"):
            if not isinstance(outs, tuple):
                outs = (outs,)
            outs = [o.movedim(1, -1) for o in outs]  # channels last at the loss boundary
            seg = batch["seg"]
            pools = getattr(model, "module", model).pool_kernel_sizes  # through a DDP wrapper
            targets = L.downsample_seg_for_ds(seg, pools)[: len(outs)]
            loss = L.deep_supervision_loss(outs, targets, head_loss)
            with torch.no_grad():
                tp, fp, fn, _ = L.get_tp_fp_fn_tn(torch.softmax(outs[0], -1), seg)
                tp, fp, fn = global_batch_dice_stats(tp, fp, fn, mesh)
        return loss, {"tp": tp, "fp": fp, "fn": fn}

    return loss_fn


def make_segflow_loss(config: ExperimentConfig):
    """loss_fn(model, batch) -> (loss, metrics), both means over the batch of
    the per-video values. batch: "video" (B, T, H, W, 1), "seg" (B, T, H, W)
    int (-1 where unlabelled), "labeled_mask" (B, T), optional "distance"
    (B, T) and "loss_mask" (B, T, H, W), all tensors on the model's device.
    With deep supervision, the auxiliary heads join the NCC, CE and Dice
    terms as in the JAX loss: weights 1/2^i normalised to sum 1 (the main
    head first), each auxiliary flow integrated by a cumulative sum over the
    frames and scored by the NCC of the frames it warps (unmasked)."""
    w = config.loss_weights
    deep_supervision = config.segflow.deep_supervision

    def one_video(out, video, seg, labeled_mask, loss_mask=None):
        """The losses of one video from its model outputs: video (T, H, W, 1),
        seg (T, H, W), labeled_mask (T,), loss_mask (T, H, W) or None (the ED
        frame's map weights every per-pixel loss)."""
        x0 = video[0]
        m0 = None if loss_mask is None else loss_mask[0]
        reg = out["registered"][1:, :, :, None]
        fixed = x0.expand_as(reg)
        cum = out["cum_flow"][1:]  # (T-1, 2, H, W)
        if m0 is None:
            ncc = L.ncc_loss(reg, fixed)
            smooth_xy = L.spatial_gradient_penalty(cum, channel_axis=1)
            smooth_t = L.temporal_gradient_penalty(cum, channel_axis=-3)
        else:
            ncc = (L.ncc_loss(reg, fixed, reduction="none") * m0[None, :, :, None]).mean()
            smooth_xy = (L.spatial_gradient_penalty(cum, reduction="none", channel_axis=1)
                         * m0[None]).mean()
            smooth_t = (L.temporal_gradient_penalty(cum[:, None], reduction="none",
                                                    channel_axis=-3) * m0[None, None]).mean()
        logits = out["seg_logits"]
        seg_ce = L.cross_entropy_loss(logits, seg, ignore_index=-1)
        seg_dice = L.soft_dice_loss(logits, seg.clamp_min(0), batch_dice=True,
                                    mask=labeled_mask[:, None, None])
        if deep_supervision and "seg_ds" in out:
            ws = [1.0 / 2.0 ** i for i in range(1 + len(out["seg_ds"]))]
            ws = [x / sum(ws) for x in ws]
            ncc, seg_ce, seg_dice = ws[0] * ncc, ws[0] * seg_ce, ws[0] * seg_dice
            for i, (seg_aux, flow_aux) in enumerate(zip(out["seg_ds"], out["flow_ds"])):
                seg_ce = seg_ce + ws[i + 1] * L.cross_entropy_loss(seg_aux, seg, ignore_index=-1)
                seg_dice = seg_dice + ws[i + 1] * L.soft_dice_loss(
                    seg_aux, seg.clamp_min(0), batch_dice=True, mask=labeled_mask[:, None, None])
                reg_aux = warp_image_cm(video.permute(0, 3, 1, 2), flow_aux.cumsum(0),
                                        padding="border").permute(0, 2, 3, 1)
                ncc = ncc + ws[i + 1] * L.ncc_loss(reg_aux[1:], x0.expand_as(reg_aux[1:]))
        loss = (w.image_flow_global * ncc + w.regularization_xy * smooth_xy
                + w.regularization_z * smooth_t + w.segmentation * (seg_ce + seg_dice))
        metrics = {"ncc": ncc, "smooth_xy": smooth_xy, "smooth_t": smooth_t,
                   "seg_ce": seg_ce, "seg_dice": seg_dice}
        if w.seg_registered:
            # the last frame's one-hot ground truth warped back to frame 0 by
            # the cumulative flow, scored against frame 0's; gated on both
            # ends being labelled
            oh_last = L.one_hot(seg[-1].clamp_min(0), logits.shape[-1]).permute(2, 0, 1)
            warped = warp_image_cm(oh_last[None], out["cum_flow"][-1][None])[0]
            seg_reg = L.soft_dice_loss(warped.permute(1, 2, 0)[None], seg[0].clamp_min(0)[None],
                                       batch_dice=True, probs_input=True)
            seg_reg = seg_reg * (labeled_mask[0] * labeled_mask[-1])
            loss = loss + w.seg_registered * seg_reg
            metrics["seg_registered"] = seg_reg
        return loss, metrics

    def loss_fn(model: torch.nn.Module, batch: dict):
        out = model(batch["video"], batch.get("distance"))
        loss_mask = batch.get("loss_mask")
        per_video = [
            one_video({k: tuple(x[b] for x in v) if isinstance(v, tuple) else v[b]
                       for k, v in out.items()}, batch["video"][b], batch["seg"][b],
                      batch["labeled_mask"][b], None if loss_mask is None else loss_mask[b])
            for b in range(batch["video"].shape[0])
        ]
        loss = torch.stack([lv for lv, _ in per_video]).mean()
        metrics = {k: torch.stack([m[k] for _, m in per_video]).mean() for k in per_video[0][1]}
        return loss, metrics

    return loss_fn


def make_voxelmorph_loss(config: ExperimentConfig):
    """loss_fn(model, batch) -> (image_flow_global * NCC(registered, fixed) +
    regularization_xy * smoothness of the flow, {"ncc", "smooth"}). batch:
    "moving", "fixed" (B, *spatial, C)."""
    w = config.loss_weights

    def loss_fn(model: torch.nn.Module, batch: dict):
        out = model(batch["moving"], batch["fixed"])
        ncc = L.ncc_loss(out["registered"], batch["fixed"])
        smooth = L.spatial_gradient_penalty(out["flow"])
        return w.image_flow_global * ncc + w.regularization_xy * smooth, {"ncc": ncc,
                                                                          "smooth": smooth}

    return loss_fn


def make_raft_loss(config: ExperimentConfig):
    """loss_fn(model, batch) -> (loss, metrics). batch: "image1", "image2"
    (B, H, W, C) and optionally "flow_gt" (B, H, W, 2): with it, the sequence
    loss over the iterations (gamma ``raft_sequence_gamma``); without, NCC of
    image2 warped (border) by the last flow against image1, plus that flow's
    smoothness."""
    gamma = config.loss_weights.raft_sequence_gamma

    def loss_fn(model: torch.nn.Module, batch: dict):
        flows = model(batch["image1"], batch["image2"])  # (iters, B, H, W, 2)
        if "flow_gt" in batch:
            loss = L.raft_sequence_loss(flows, batch["flow_gt"], gamma=gamma)
            return loss, {"seq_loss": loss}
        final = flows[-1]
        warped = warp_batch(batch["image2"], final, padding="border")
        ncc = L.ncc_loss(warped, batch["image1"])
        smooth = L.spatial_gradient_penalty(final)
        return ncc + smooth, {"ncc": ncc, "smooth": smooth}

    return loss_fn


def make_loss_fn(config: ExperimentConfig, mesh: Mesh | None = None):
    """The loss of ``config.model``: loss_fn(model, batch) -> (loss, aux).
    Only the U-Net's sums over the global batch of ``mesh``: the others are
    means over the batch of per-sample losses, which DDP's average over
    equal shards reproduces."""
    if config.model in UNET_KINDS:
        return make_seg_loss(config, mesh)
    if config.model == "segflow":
        return make_segflow_loss(config)
    if config.model == "voxelmorph":
        return make_voxelmorph_loss(config)
    if config.model == "raft":
        return make_raft_loss(config)
    raise ValueError(f"unknown model kind {config.model!r}")


@dataclass
class TrainerHistory:
    train_losses: list = field(default_factory=list)
    val_losses: list = field(default_factory=list)
    eval_metrics: list = field(default_factory=list)
    epoch_times: list = field(default_factory=list)
    #: host seconds of each train iteration, ending in the loss read (a sync)
    step_times: list = field(default_factory=list)


class Trainer:
    """Config-driven trainer of any model kind on one device
    (``"cuda"`` unless told otherwise), data parallel over the ranks of an
    initialized process group. ``train_iter`` / ``val_iter`` yield
    host (numpy) batch dicts with a leading batch axis, as
    :class:`csof_tpu_torch.data.loaders.VideoChunkLoader` and
    :class:`csof_tpu_torch.data.loaders.SegPatchLoader` do: on every rank
    the global batch, of which the rank keeps its rows. ``plans`` builds
    the U-Net of a plans file; ``mesh`` defaults to ``make_mesh(
    config.mesh_data, config.mesh_model)`` over the process group."""

    # EMA / patience constants of the JAX trainer
    train_loss_ma_alpha = 0.93
    val_eval_criterion_alpha = 0.9
    patience = 50
    train_loss_ma_eps = 5e-4
    checkpoint_every = 50
    #: raise on a non-finite loss
    nan_guard: bool = True

    def __init__(self, config: ExperimentConfig, output_folder: str | Path, plans=None,
                 num_classes: int | None = None, device: torch.device | str = "cuda",
                 for_training: bool = True, mesh: Mesh | None = None):
        # a trainer restored to serve (for_training=False) may hold a model
        # that cannot train: a forward-only kernel switch or corr_fuse mode
        _check_trainable(config, for_training)
        self.config = config
        self.output_folder = Path(output_folder)
        self.output_folder.mkdir(parents=True, exist_ok=True)
        self.plans = plans
        self.num_classes = num_classes
        self.device = torch.device(device)
        self.for_training = for_training
        if mesh is None:  # one process: one device, whatever the config's mesh
            mesh = (make_mesh(config.mesh_data, config.mesh_model, self.device)
                    if dist.is_initialized() else Mesh(1, devices=(str(self.device),)))
        self.mesh = mesh
        self.loss_fn = make_loss_fn(config, self.mesh)
        self.history = TrainerHistory()
        self.epoch = 0
        self.model: torch.nn.Module | None = None
        self._ddp: DistributedDataParallel | None = None
        self.optimizer = None
        #: "pt" or "msgpack": the format the last load_checkpoint read
        self.checkpoint_format: str | None = None

    @property
    def total_steps(self) -> int:
        return self.config.max_num_epochs * self.config.num_batches_per_epoch

    def _new_model(self, seed: int) -> torch.nn.Module:
        gen = torch.Generator().manual_seed(seed)
        return build_model(self.config, self.num_classes, gen, self.plans).to(self.device)

    @property
    def train_model(self) -> torch.nn.Module:
        """The module a train step runs: the model, or its DDP wrapper."""
        return self.model if self._ddp is None else self._ddp

    @property
    def is_main_process(self) -> bool:
        """Rank 0 alone writes logs, figures and checkpoints."""
        return self.mesh.rank == 0

    def initialize(self, example_batch: dict | None = None):
        """Draw the weights from ``config.seed`` and build the optimizer; under
        a process group, wrap the model in DDP, which looks for parameters
        without a gradient each step: a zero-weight deep-supervision head
        gets none on any rank, and ``Optimizer.step`` decays it as on one
        rank. ``example_batch``, the global batch, fits the mesh to its
        size; torch modules need no example input."""
        self.model = self._new_model(self.config.seed)
        self.optimizer = build_optimizer(self.config.optim, self.total_steps,
                                         self.model.parameters())
        if dist.is_initialized() and self.for_training:
            # device_ids None: the inputs are on the model's device already
            self._ddp = DistributedDataParallel(self.model, find_unused_parameters=True)
        if example_batch is not None:
            self._fit_mesh(example_batch)
        return self

    def _fit_mesh(self, batch: dict) -> int:
        """Cut the mesh's data size to a divisor of the global batch; returns
        the batch's size."""
        n = len(next(v for v in batch.values() if v is not None))
        mesh = fit_batch(self.mesh, n)
        if mesh is not self.mesh:
            self.mesh = mesh
            self.loss_fn = make_loss_fn(self.config, mesh)
        return n

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            if v is None:
                continue
            t = torch.as_tensor(v).to(self.device, non_blocking=True)
            if k == "data" and self.config.model in UNET_KINDS:
                t = t.movedim(-1, 1).contiguous()  # channels-last patches -> NC(D)HW
            out[k] = t
        return out

    def augment(self, batch: dict, rows: tuple[int, slice] | None = None) -> dict:
        """The batch (on the device) augmented as the JAX train step augments
        it, from the generator of the seed and the step count; ``rows`` =
        (n, sl) when the batch is rows ``sl`` of a global batch of n."""
        gen = step_generator(self.config.seed, self.optimizer.count, self.device)
        if self.config.model == "unet2d":
            data, seg = augment_batch_2d(gen, batch["data"], batch["seg"], rows=rows)
            return {**batch, "data": data, "seg": seg}
        video, seg = augment_video(gen, batch["video"], batch["seg"], rows=rows)
        # unlabelled frames stay -1 (the warp's zero padding would label them)
        seg = torch.where(batch["labeled_mask"][:, :, None, None] > 0, seg, -1)
        return {**batch, "video": video, "seg": seg}

    def run_iteration(self, batch: dict, train: bool = True):
        """One train step (or a loss evaluation) on the global host batch;
        returns (loss, metrics), the loss averaged over the ranks. A train
        step opens the ``csof:train.*`` spans while a profiler records; an
        evaluation opens none."""
        if self.model is None:
            raise RuntimeError("initialize() first")
        span = profiling.span if train else profiling.no_span
        t0 = time.perf_counter()
        with span("train.step"):
            with span("train.input"):
                n = self._fit_mesh(batch)
                rows = None if self.mesh.n_data == 1 else (n, self.mesh.rows(n))
                batch = self._to_device(shard_batch(batch, self.mesh))
            # the JAX step augments only the 2D U-Net's and SegFlow's batches
            if train and self.config.data.do_data_aug and self.config.model in AUGMENTED_KINDS:
                with span("train.augment"):
                    batch = self.augment(batch, rows)
            if train:
                # the U-Net's loss opens train.forward and train.loss itself
                whole = profiling.no_span if self.config.model in UNET_KINDS else span
                with whole("train.forward"):
                    loss, aux = self.loss_fn(self.train_model, batch)
                with span("train.backward"):
                    self.optimizer.zero_grad()
                    loss.backward()  # DDP's gradient average completes inside
                with span("train.optimizer"):
                    self.optimizer.step()
            else:
                with torch.no_grad():
                    loss, aux = self.loss_fn(self.model, batch)
            with span("train.loss_read"):
                loss = all_mean(float(loss.detach()), self.mesh)
        if train:
            self.history.step_times.append(time.perf_counter() - t0)
        if self.nan_guard and not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} at epoch {self.epoch}: check data/LR")
        return loss, aux

    def _validate(self, val_iter: Iterator[dict]) -> None:
        """Mean validation loss, and the foreground Dice of the summed
        tp/fp/fn where the loss reports them (the U-Net's); both over the
        global batches, the same on every rank."""
        losses, stats = [], None
        for _ in range(self.config.num_val_batches_per_epoch):
            loss, aux = self.run_iteration(next(val_iter), train=False)
            losses.append(loss)
            if "tp" in aux:
                s = tuple(aux[k].cpu().numpy() for k in ("tp", "fp", "fn"))
                stats = s if stats is None else tuple(a + b for a, b in zip(stats, s))
        self.history.val_losses.append(float(np.mean(losses)))
        if stats is not None:
            tp, fp, fn = (a[1:] for a in stats)
            fg_dice = (2 * tp / np.maximum(2 * tp + fp + fn, 1e-8)).mean()
            self.history.eval_metrics.append(float(fg_dice))

    def save_debug_information(self) -> None:
        """``debug.json`` (the config, the folder, the epoch, the model's
        class, the mesh's shape and every rank's device, the trainer's
        constants, the parameter count, this rank's device and its name) and
        ``network_architecture.txt`` (:func:`model_summary`) in the output
        folder, as the JAX trainer writes them at the start of training; the
        device and its name stand where JAX writes its backend."""
        dev = self.device
        dct = {
            "config": dataclasses.asdict(self.config),
            "output_folder": str(self.output_folder),
            "epoch": self.epoch,
            "model_class": type(self.model).__name__,
            "mesh_shape": self.mesh.shape,
            "devices": list(self.mesh.devices),
            "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else dev.type),
            "trainer_constants": {
                "train_loss_ma_alpha": self.train_loss_ma_alpha,
                "val_eval_criterion_alpha": self.val_eval_criterion_alpha,
                "patience": self.patience,
                "train_loss_ma_eps": self.train_loss_ma_eps,
                "checkpoint_every": self.checkpoint_every,
                "nan_guard": self.nan_guard,
            },
        }
        if self.model is not None:
            dct["num_parameters"] = count_parameters(self.model)
            (self.output_folder / "network_architecture.txt").write_text(
                model_summary(self.model))
        (self.output_folder / "debug.json").write_text(json.dumps(dct, indent=2, default=str))

    def run_training(self, train_iter: Iterator[dict], val_iter: Iterator[dict] | None = None,
                     max_epochs: int | None = None,
                     log_fn: Callable[[str], None] | None = None,
                     tensorboard: bool = False) -> TrainerHistory:
        """The epoch loop; ``log_fn`` (default: a :class:`TrainingLog` in the
        output folder) takes each epoch's line. The debug files and the
        progress figure never stop training: a failure to write them is
        logged with its exception, as the JAX trainer skips them. With
        ``tensorboard``, each epoch's losses and foreground Dice go to an
        event file in ``output_folder/tb``, as the JAX trainer logs them."""
        if self.model is None:
            self.initialize()
        main = self.is_main_process
        # the other ranks print their lines (rank-0 file IO, as in JAX)
        log_fn = log_fn or (TrainingLog(self.output_folder) if main else print)
        try:
            if main:
                self.save_debug_information()
        except Exception as e:  # noqa: BLE001 - the dumps must never kill training
            log_fn(f"debug information not written: {e!r}")
        tb = TensorBoardVisualizer(self.output_folder / "tb") if tensorboard and main else None
        cfg = self.config
        max_epochs = max_epochs or cfg.max_num_epochs
        criterion_ma = None  # EMA of the epoch criterion, advanced every epoch
        best_ma = None
        best_epoch = 0
        while self.epoch < max_epochs:
            t0 = time.time()
            ep_losses = [self.run_iteration(next(train_iter))[0]
                         for _ in range(cfg.num_batches_per_epoch)]
            self.history.train_losses.append(float(np.mean(ep_losses)))
            if val_iter is not None:
                self._validate(val_iter)
            self.history.epoch_times.append(time.time() - t0)
            self.epoch += 1
            self._maybe_momentum_rescue(log_fn)

            criterion = (self.history.val_losses or self.history.train_losses)[-1]
            criterion_ma = criterion if criterion_ma is None else (
                self.val_eval_criterion_alpha * criterion_ma
                + (1 - self.val_eval_criterion_alpha) * criterion)
            if best_ma is None or criterion_ma < best_ma - self.train_loss_ma_eps:
                best_ma, best_epoch = criterion_ma, self.epoch
                self.save_checkpoint(ckpt.BEST)
            if self.epoch % self.checkpoint_every == 0:
                self.save_checkpoint(ckpt.LATEST)
            hist = self.history
            log_fn(f"epoch {self.epoch}: train {hist.train_losses[-1]:.4f}"
                   + (f" val {hist.val_losses[-1]:.4f}" if hist.val_losses else "")
                   + (f" fg-dice {hist.eval_metrics[-1]:.4f}" if hist.eval_metrics else "")
                   + f" ({hist.epoch_times[-1]:.1f}s)")
            if tb is not None:
                scalars = {"loss/train": hist.train_losses[-1]}
                if hist.val_losses:
                    scalars["loss/val"] = hist.val_losses[-1]
                if hist.eval_metrics:
                    scalars["metric/fg_dice"] = hist.eval_metrics[-1]
                tb.log_scalars(scalars, self.epoch)
            try:
                if main:
                    plot_progress(self.output_folder, hist.train_losses, hist.val_losses,
                                  hist.eval_metrics)
            except Exception as e:  # noqa: BLE001 - plotting must never kill training
                log_fn(f"progress.png not written: {e!r}")
            if self.epoch - best_epoch > self.patience:
                log_fn(f"early stop: no improvement for {self.patience} epochs")
                break
        if tb is not None:
            tb.close()
        self.save_checkpoint(ckpt.FINAL)
        return self.history

    def _maybe_momentum_rescue(self, log_fn=print) -> bool:
        """nnU-Net's SGD rescue: if the online foreground dice is still 0
        when the epoch numbered ``optim.momentum_rescue_epoch`` from zero has
        finished (``self.epoch``, the count of finished epochs, is one more),
        drop the momentum to ``optim.momentum_rescue_value`` and draw the
        weights anew (seed + epoch); the optimizer restarts with fresh
        buffers at the same schedule position. nnUNetTrainerV2.on_epoch_end
        compares its epoch counter before run_training increments it, so it
        fires after 101 finished epochs at the default 100; the JAX trainer
        compares after the increment and fires one epoch earlier (ROADMAP
        fault F5). The port follows nnU-Net."""
        ocfg = self.config.optim
        if (ocfg.optimizer != "sgd" or ocfg.momentum_rescue_epoch <= 0
                or self.epoch != ocfg.momentum_rescue_epoch + 1
                or not self.history.eval_metrics or self.history.eval_metrics[-1] != 0):
            return False
        new_optim = dataclasses.replace(ocfg, sgd_momentum=ocfg.momentum_rescue_value)
        self.config = dataclasses.replace(self.config, optim=new_optim)
        count = self.optimizer.count
        self.model.load_state_dict(self._new_model(self.config.seed + self.epoch).state_dict())
        self.optimizer = build_optimizer(new_optim, self.total_steps, self.model.parameters())
        self.optimizer.count = count
        log_fn(f"after epoch {self.epoch - 1} (numbered from 0) the mean foreground Dice was "
               f"0: SGD momentum reduced {ocfg.sgd_momentum} -> {ocfg.momentum_rescue_value} "
               "and network weights reinitialized")
        return True

    def save_checkpoint(self, name: str = ckpt.LATEST):
        """Rank 0 writes the checkpoint and its sidecar; the others nothing."""
        if not self.is_main_process:
            return None
        meta = {"epoch": self.epoch, "config_model": self.config.model,
                "train_losses": self.history.train_losses[-5:],
                "val_losses": self.history.val_losses[-5:]}
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "step": self.optimizer.count}
        return ckpt.save_checkpoint(self.output_folder, state, name=name, meta=meta)

    def load_checkpoint(self, name: str | None = None) -> dict:
        """Restore model, optimizer and epoch from ``name`` (by default the
        first of final, latest, best; at each, the port's ``.pt``, then the
        JAX package's ``.msgpack``); returns the sidecar metadata and sets
        ``checkpoint_format``."""
        if self.model is None:
            self.initialize()
        state, meta, fmt = ckpt.load_checkpoint(self.output_folder, name,
                                                map_location=self.device)
        if fmt == "pt":
            self.model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
        else:
            load_flax_train_state(self.model, self.optimizer, state)
        self.checkpoint_format = fmt
        self.epoch = int(meta.get("epoch", 0))
        return meta
