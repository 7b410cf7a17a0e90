"""The trainers of both stages and the Long-term Feature Bank build.

Port of `tmrnet_tpu/train/loop.py`: `train_stage1` (:578) and
`train_stage2` (:761) over the shared epoch machinery (`EpochStats`,
`_make_memory_fn`, `_run_epoch_train`, `_run_epoch_eval`, `_fit`,
`_epoch_loop`, :55-575) on one card: class-balanced weighted CE on each
clip's last frame, two learning-rate groups, shuffled batches through a
`ClipLoader` and `device_prefetch`, a full validation pass per epoch, the
best checkpoint by val accuracy (train accuracy breaking ties), StepLR or
ReduceLROnPlateau between epochs, resume from the latest checkpoint (the
plateau state and the best tracker re-seeded from the checkpoints'
metadata), early stop, one-batch mid-epoch validation, image logging, and
preemption (train.preempt_save: SIGTERM/SIGINT finish the step, save a
checkpoint marked for the epoch's replay and return; a second signal
interrupts), checkpoints written in the background under
train.async_checkpoint (durable before the trainer returns), and the
backbone's blocks recomputed in the backward pass under train.remat (the
model is built with model.remat = train.remat, as JAX's trainers build
it, :582-583, :772-773). Dropout masks come from a torch generator seeded per step
from train.seed, the epoch and the step (`step_generator`), where JAX
folds epoch * 100003 + step into its key: the same schedule of seeds, not
the same masks.

`mesh=` (a `parallel/mesh.py::DataMesh`, the (data x model) grid, one
process a card) trains as JAX's trainers do over a mesh that spans
processes (`_BatchFeed` :116-179, `_global_stop` :181-206, `shard_state`
through `_maybe_shard` :64-72): every rank derives the same seeded batches
and assembles only the rows of its data index of each
(`ClipLoader(local_rows=)`; the ranks of a model group the same rows),
gathers the memory windows of those rows alone, starts from rank 0's
weights, keeps its slices of the parameters that the TP rules shard
(`parallel/tensor.py::shard_model_`, model_parallel M > 1) and sums its
gradients over the data group (`train/state.py`); the metrics are summed
over the data group before they are read, the val pass runs the sharded
model, gathers the data ranks' predictions and losses and takes the
labels from `ds.clip_labels`, a preemption check runs over every rank
every `_STOP_CHECK_EVERY` steps and after each epoch, and rank 0 writes
the checkpoints, whole (`utils/checkpoint.py`). A grid's run computes
what a one-process run over the same global batches computes.

And `build_lfb`, port of `tmrnet_tpu/train/loop.py::build_lfb` (:589-684),
`framewise_transform_for_video_build` (:687-700), `load_video_frames`
(:703-722) and the body of `_build_lfb_video` (:725-760). Two engines
fill the same bank, one row per clip position:
- clip: the frozen extractor (head `lfb`) over every clip of a dataset,
  `data.batch_clips` clips a batch through a `ClipLoader` and
  `device_prefetch`, each batch's rows written with `update_bank` (a
  padded last batch writes only its real rows);
- video: per video, `VideoInference.bank_features` (the extractor's
  backbone once per frame, its LSTM over every sliding window);
  `build_lfb_video` takes the videos' frames or zero-arg loaders of them.
Under `mesh=`, the clip engine runs each rank over its rows of every batch
and gathers the bank rows; the video engine partitions the videos over
the ranks (`eval/distributed.py::run_lfb_distributed`). Rank 0 writes the
cache. Under `devices=` (one process, JAX's `build_lfb(mesh=)` over a
process-local mesh, :589-660) the clip engine keeps an extractor replica
on each listed device and cuts each loader batch into contiguous shards,
one a device (`eval/infer.py::run_shards`), the features gathered on the
first; a batch that does not divide runs whole on the first (:651-655);
the video engine runs its sequence-parallel pass.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tmrnet_torch.config import ExperimentConfig
from tmrnet_torch.data.device_feed import DevicePrep, device_prefetch
from tmrnet_torch.data.indexing import quirk_window_table
from tmrnet_torch.data.pipeline import ClipDataset, ClipLoader
from tmrnet_torch.device import resolve_device
from tmrnet_torch.eval.infer import (VideoInference, corpus_lengths,
                                     load_video, load_weights, replicas,
                                     run_shards, shard_devices)
from tmrnet_torch.memory.lfb import (FeatureBank, gather_memory_windows,
                                     load_bank, save_bank, update_bank)
from tmrnet_torch.parallel.mesh import (DataMesh, all_gather_host,
                                        all_reduce_host, broadcast_module,
                                        process_local_bounds)
from tmrnet_torch.parallel.tensor import shard_model_
from tmrnet_torch.train.losses import balanced_class_weights
from tmrnet_torch.train.optim import (make_optimizer, make_schedule,
                                      set_learning_rate, slow_modules_for_head)
from tmrnet_torch.train.state import TrainState
from tmrnet_torch.train.steps import make_stage1_steps, make_stage2_steps
from tmrnet_torch.utils.checkpoint import BestTracker, CheckpointManager
from tmrnet_torch.utils.logging import MetricLogger, Timer


def build_lfb(cfg: ExperimentConfig,
              extractor_state_dict: Mapping[str, torch.Tensor],
              ds: ClipDataset, cache_path: Optional[str] = None,
              force: bool = False, engine: str = "clip", device="cuda",
              fused_kernel: str = "block",
              mesh: Optional[DataMesh] = None,
              devices: Optional[Sequence] = None) -> FeatureBank:
    """The bank of a dataset from the frozen extractor's weights (head
    `lfb`: trunk and LSTM), f32, on `device`. The `.npz` at `cache_path`
    (default `memory.cache_path`) is read instead where it exists, under
    `memory.load_cached` and unless `force`; a build writes it.

    engine 'clip' runs the extractor over every clip with the dataset's
    transform; 'video' runs its backbone once per frame and needs a
    deterministic frame-wise transform (`EvalTransform` crop types 1/2/3).
    The two give the same features up to rounding. fused_kernel as in
    `ClipInference`.

    mesh: data-parallel over processes, on the mesh's device (`device` is
    not read). The clip engine runs each rank over its rows
    `process_local_bounds` of every batch of `data.batch_clips` and gathers
    the rows; the video engine partitions the videos
    (`eval/distributed.py::run_lfb_distributed`). Every rank returns the
    whole bank; rank 0 writes the cache. devices: in one process, the
    clip engine's batches sharded over them, or the video engine's
    sequence-parallel pass (`VideoInference(devices=)`); the first is the
    bank's device (`device` is not read), and the bank is the one-device
    build's. A mesh beside them raises."""
    path = cache_path or cfg.memory.cache_path
    devices = shard_devices(devices, mesh, "build_lfb")
    if devices:
        device = devices[0]
    if mesh is not None:
        device = mesh.device
    if path and os.path.exists(path) and cfg.memory.load_cached and not force:
        return load_bank(path, device=device)
    if engine == "video" and mesh is not None:
        from tmrnet_torch.eval.distributed import run_lfb_distributed

        return run_lfb_distributed(cfg, extractor_state_dict, ds,
                                   cache_path=path, mesh=mesh,
                                   fused_kernel=fused_kernel)
    if engine == "video":
        tf = framewise_transform_for_video_build(ds)
        videos = ds.manifest.videos
        loaders = [(lambda v=v: _transformed(tf, load_video_frames(ds, v)))
                   for v in videos]
        return build_lfb_video(cfg, extractor_state_dict, loaders,
                               lengths=[len(v) for v in videos],
                               cache_path=path, device=device,
                               fused_kernel=fused_kernel, devices=devices)
    if engine != "clip":
        raise ValueError(f"unknown engine {engine!r} (want clip or video)")
    dev = resolve_device(device)
    model = load_weights(dataclasses.replace(cfg.model, head="lfb"),
                         extractor_state_dict, dev, fused_kernel)
    prep = DevicePrep(cfg.data, cfg.model.compute_dtype, dev)
    bank = FeatureBank.create(ds.seq_len, ds.manifest.video_lengths,
                              cfg.model.hidden_dim, device=dev)
    extract = lambda model, prep, clips: model(prep(clips))
    shards = None
    if devices and len(devices) > 1:
        shards = replicas(devices, (model, prep), lambda d: (
            load_weights(dataclasses.replace(cfg.model, head="lfb"),
                         extractor_state_dict, d, fused_kernel),
            DevicePrep(cfg.data, cfg.model.compute_dtype, d)))
    d = cfg.data
    local = (None if mesh is None else
             process_local_bounds(d.batch_clips, mesh.rank, mesh.world))
    loader = ClipLoader(ds, d.batch_clips, shuffle=False,
                        num_workers=d.num_workers, prefetch=d.prefetch,
                        use_processes=d.use_process_workers, local_rows=local)
    mine = []
    with torch.inference_mode():
        for clips, _, rows, pad in device_prefetch(loader.epoch(0), device=dev,
                                                   array_indices=(0, 2)):
            b = len(rows) - pad
            if shards is not None and len(clips) % len(shards) == 0:
                update_bank(bank.features, rows[:b],
                            run_shards(shards, dev, extract, clips)[:b])
            elif mesh is None:
                update_bank(bank.features, rows[:b], extract(model, prep,
                                                             clips)[:b])
            else:
                mine.append((rows, b, model(prep(clips))))
        if mine:
            # one gather of every rank's rows of every batch, (world,
            # batches, B / world, hidden); each batch's real rows written
            got = all_gather_host(torch.stack([v for _, _, v in mine])
                                  .float().cpu().numpy(), mesh)
            for j, (rows, b, _) in enumerate(mine):
                values = got[:, j].reshape(len(rows), -1)[:b]
                update_bank(bank.features, rows[:b],
                            torch.from_numpy(values).to(dev))
    if path and (mesh is None or mesh.rank == 0):
        save_bank(path, bank)
    return bank


def _transformed(tf, frames: np.ndarray) -> np.ndarray:
    return frames if tf is None else tf(frames)


def framewise_transform_for_video_build(ds: ClipDataset):
    """The dataset's transform, checked for the video engine: it runs once
    over a whole video, so it must act frame by frame and deterministically
    (`EvalTransform` crop types 1/2/3, or none)."""
    if not hasattr(ds, "manifest"):
        raise ValueError("engine='video' needs a frame-manifest dataset")
    tf = ds.transform
    if tf is not None and getattr(tf, "crop_type", None) not in (1, 2, 3):
        raise ValueError(
            "engine='video' needs a deterministic frame-wise transform "
            f"(EvalTransform crop types 1/2/3); got {type(tf).__name__}")
    return tf


def load_video_frames(ds: ClipDataset, video) -> np.ndarray:
    """One video's raw uint8 frames (N, H, W, 3) through the dataset's
    loader, a frame that fails to load zero-filled under error_policy
    'zeros' as `ClipDataset.get_clip` does."""
    out = []
    for p in video.frame_paths:
        try:
            out.append(ds.frame_loader(p))
        except Exception:
            if getattr(ds, "error_policy", "raise") != "zeros":
                raise
            out.append(None)
    shape = next((f.shape for f in out if f is not None), None)
    if shape is None:
        raise ValueError(f"video {video.video_id}: every frame failed "
                         f"to decode")
    return np.stack([f if f is not None else np.zeros(shape, np.uint8)
                     for f in out])


def build_lfb_video(cfg: ExperimentConfig,
                    extractor_state_dict: Mapping[str, torch.Tensor],
                    videos: Sequence, lengths: Optional[Sequence[int]] = None,
                    cache_path: Optional[str] = None, device="cuda",
                    fused_kernel: str = "block",
                    devices: Optional[Sequence] = None) -> FeatureBank:
    """One bank row per clip position of each video, in order (f32, as
    JAX's). videos: (N_i, H, W, 3) frames (uint8 raw, as the wire carries
    them, or float), host or device, or zero-arg loaders of them, which
    need `lengths` and are checked against them. cache_path: where to
    write the bank (`.npz`), if given. devices: the sequence-parallel
    pass over them."""
    ns = corpus_lengths(videos, lengths)
    engine = VideoInference(
        cfg.replace(model=dataclasses.replace(cfg.model, head="lfb")),
        extractor_state_dict, extractor_state_dict, device=device,
        fused_kernel=fused_kernel, devices=devices)
    bank = FeatureBank.create(cfg.data.sequence_length, ns,
                              cfg.model.hidden_dim, device=engine.device)
    row = 0
    for i, video in enumerate(videos):
        vals = engine.bank_features(load_video(video, ns[i], i))
        k = vals.shape[0]
        if k:
            update_bank(bank.features,
                        torch.arange(row, row + k, device=engine.device), vals)
        row += k
    if cache_path:
        save_bank(cache_path, bank)
    return bank


@dataclasses.dataclass
class EpochStats:
    epoch: int
    train_loss: float
    train_acc: float
    val_loss: float
    val_acc: float
    lr: float
    seconds: float


def step_generator(seed: int, epoch: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The dropout masks' generator of one train step, on `device`, seeded
    from (seed, epoch * 100003 + step) as JAX folds the step into its
    key."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + epoch * 100003 + step) % (1 << 63))
    return gen


def _make_memory_fn(cfg: ExperimentConfig, ds: Optional[ClipDataset],
                    bank: Optional[FeatureBank], window: int
                    ) -> Optional[Callable]:
    """rows (numpy) -> their (B, window, F) memory, gathered on the bank's
    device: clamped at each video's first row, or, under
    `memory.compat_cross_video`, the reference's cross-video walk through
    a precomputed table (`data/indexing.py::quirk_window_table`)."""
    if bank is None or ds is None:
        return None
    dev = bank.features.device
    to_dev = lambda rows: torch.as_tensor(np.asarray(rows), dtype=torch.long,
                                          device=dev)
    if cfg.memory.compat_cross_video:
        table = to_dev(quirk_window_table(ds.seq_len, ds.manifest.video_lengths,
                                          window))
        return lambda rows: bank.features[table[to_dev(rows)]]
    first_rows = to_dev(ds.first_rows)

    def fn(rows):
        r = to_dev(rows)
        return gather_memory_windows(bank.features, r, first_rows[r], window)

    return fn


# The preemption check over the ranks is a host collective, so under a
# mesh it runs every K steps (and after each epoch): a stop lags K steps
# at most, well inside any SIGTERM grace (JAX's cadence, loop.py:186).
_STOP_CHECK_EVERY = 8


def _global_stop(stop: Optional[dict], mesh: Optional[DataMesh] = None
                 ) -> bool:
    """The preemption flag: this process's, or under a mesh any rank's (a
    MAX over the ranks, which every rank calls at the same boundaries; a
    SIGTERM that reaches one rank alone then stops them all at one step,
    where a local check would leave that rank in the checkpoint's
    collective while the others train on)."""
    flag = bool(stop is not None and stop.get("stop"))
    if mesh is not None:
        flag = bool(all_reduce_host(np.asarray([flag], np.int32), mesh,
                                    "max")[0])
        if flag and stop is not None:
            stop["stop"] = True         # a peer's preemption, adopted
    return flag


def _sums(acc, mesh: Optional[DataMesh]) -> Tuple[float, int, int]:
    """The running (loss, correct, count) on the host, summed over the
    data group under a mesh."""
    got = np.asarray([float(acc[0]), float(acc[1]), float(acc[2])])
    if mesh is not None:
        got = all_reduce_host(got, mesh, data_only=True)
    return float(got[0]), int(got[1]), int(got[2])


def _gather_rows(mesh: Optional[DataMesh], *arrays: np.ndarray):
    """Each array's global batches from every data rank's rows: (batches,
    B / dp, ...) on each rank -> (batches, B, ...), the data ranks' rows
    in order. Without a mesh, the arrays as they are."""
    if mesh is None:
        return arrays
    out = []
    for a in arrays:
        g = all_gather_host(a, mesh, data_only=True)   # (dp, batches, ...)
        g = np.moveaxis(g, 0, 1)
        out.append(g.reshape((g.shape[0], -1) + g.shape[3:]))
    return tuple(out)


def _run_epoch_train(train_step, state: TrainState, loader: ClipLoader,
                     epoch: int, seed: int, device: torch.device,
                     memory_fn: Optional[Callable] = None,
                     log: Optional[MetricLogger] = None, log_every: int = 50,
                     minibatch_val: Optional[Callable] = None,
                     minibatch_val_every: int = 0, log_images_every: int = 0,
                     stop: Optional[dict] = None,
                     mesh: Optional[DataMesh] = None):
    """One epoch of train steps. Returns (mean loss, accuracy, whether a
    preemption signal stopped it); the running sums stay on the card
    between logs. Under a mesh the loader gives this rank's rows of each
    batch, whose memory windows alone are gathered."""
    acc = None
    interrupted = False
    prev_loss, prev_count = 0.0, 0
    timer = Timer()
    lo, hi = loader.local_rows or (0, loader.batch)
    batches = device_prefetch(loader.epoch(epoch), device=device,
                              array_indices=(0, 1))
    for i, (clips, labels, rows, pad) in enumerate(batches):
        gen = step_generator(seed, epoch, i, device)
        if memory_fn is not None:
            m = train_step(state, clips, memory_fn(rows[lo:hi]), labels, gen)
        else:
            m = train_step(state, clips, labels, gen)
        got = (m["loss"], m["correct"], m["count"])
        acc = got if acc is None else tuple(a + b for a, b in zip(acc, got))
        timer.add_frames((len(rows) - pad) * clips.shape[1])
        if log is not None and log_images_every and i % log_images_every == 0:
            log.log_images(state.step, "train/input_sequence",
                           clips[0].cpu().numpy())
        if log is not None and (i + 1) % log_every == 0:
            tot_loss, _, tot_count = _sums(acc, mesh)
            n = max(tot_count - prev_count, 1)
            log.log(state.step, {"loss": (tot_loss - prev_loss) / n,
                                 "fps": timer.fps}, prefix="train/")
            prev_loss, prev_count = tot_loss, tot_count
        if (minibatch_val is not None and minibatch_val_every
                and (i + 1) % minibatch_val_every == 0):
            vm = minibatch_val(state)
            if log is not None:
                log.log(state.step, vm, prefix="val_minibatch/")
        if stop is not None:
            due = (mesh is None
                   or i % _STOP_CHECK_EVERY == _STOP_CHECK_EVERY - 1)
            if due and _global_stop(stop, mesh):
                # the step in flight is applied: leave at this boundary so
                # the caller checkpoints a consistent state
                interrupted = True
                break
    batches.close()
    if acc is None:
        return 0.0, 0.0, interrupted
    loss, correct, count = _sums(acc, mesh)
    count = max(count, 1)
    return loss / count, correct / count, interrupted


def _eval_batch(eval_step, state, clips, labels, rows, memory_fn, lo, hi):
    if memory_fn is not None:
        m = eval_step(state, clips, memory_fn(rows[lo:hi]), labels)
    else:
        m = eval_step(state, clips, labels)
    return m["losses"].cpu().numpy(), m["preds"].cpu().numpy()


def _run_epoch_eval(eval_step, state: TrainState, loader: ClipLoader,
                    device: torch.device,
                    memory_fn: Optional[Callable] = None,
                    mesh: Optional[DataMesh] = None):
    """A full pass over the loader. Returns (mean loss, accuracy, preds,
    labels, rows) over the real rows (a padded batch's repeats dropped).
    Under a mesh, each rank scores its rows of each batch; the ranks'
    losses and predictions are gathered once at the end, and the labels
    are the dataset's (`ds.clip_labels`)."""
    lo, hi = loader.local_rows or (0, loader.batch)
    losses, preds, all_labels, all_rows = [], [], [], []
    for clips, labels, rows, pad in device_prefetch(
            loader.epoch(0), device=device, array_indices=(0, 1)):
        ls, ps = _eval_batch(eval_step, state, clips, labels, rows,
                             memory_fn, lo, hi)
        losses.append(ls)
        preds.append(ps)
        b = len(rows) - pad
        all_labels.append(labels[:b].cpu().numpy() if mesh is None
                          else loader.ds.clip_labels[rows[:b]])
        all_rows.append(rows[:b])
    if not all_rows:
        empty = np.zeros(0, np.int64)
        return 0.0, 0.0, empty, empty, empty
    losses, preds = _gather_rows(mesh, np.stack(losses), np.stack(preds))
    loss_sum, correct, count = 0.0, 0, 0
    for ls, ps, labels, rows in zip(losses, preds, all_labels, all_rows):
        b = len(rows)
        loss_sum += float(ls[:b].sum())
        correct += int((ps[:b] == labels).sum())
        count += b
    preds = np.concatenate([ps[:len(r)] for ps, r in zip(preds, all_rows)])
    return (loss_sum / max(count, 1), correct / max(count, 1), preds,
            np.concatenate(all_labels), np.concatenate(all_rows))


def _fit(cfg: ExperimentConfig, model_cfg, train_ds: ClipDataset,
         val_ds: Optional[ClipDataset], use_memory: bool,
         bank: Optional[FeatureBank], slow_modules,
         init_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
         log: Optional[MetricLogger] = None,
         val_bank: Optional[FeatureBank] = None, device="cuda",
         mesh: Optional[DataMesh] = None
         ) -> Tuple[TrainState, List[EpochStats]]:
    from tmrnet_torch.models.tmrnet import init_state_dict as fresh_init

    dev = mesh.device if mesh is not None else resolve_device(device)
    t = cfg.train
    for name, b in (("bank", bank), ("val_bank", val_bank)):
        if b is not None and b.features.device != dev:
            raise ValueError(f"{name} on {b.features.device}, trainer on "
                             f"{dev}")
    if init_state_dict is None:
        init_state_dict = fresh_init(model_cfg, t.seed)
    model = load_weights(model_cfg, init_state_dict, dev, "block")
    if mesh is not None:
        broadcast_module(model, mesh)       # rank 0's weights on all
        shard_model_(model, mesh)           # then the rank's slices
    state = TrainState(model, make_optimizer(t, model, slow_modules),
                       grad_accum=t.grad_accum, grad_clip=t.grad_clip,
                       mesh=mesh)

    ckpt = CheckpointManager(t.checkpoint_dir, keep=t.keep_checkpoints,
                             use_async=t.async_checkpoint, mesh=mesh)
    start_epoch = 0
    resume_meta: Dict = {}
    ckpt.barrier()          # no rank reads while another still writes
    if t.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        resume_meta = ckpt.metadata(ckpt.latest_step()).get("metrics", {})
        start_epoch = int(resume_meta.get("epoch", -1)) + 1

    class_weights = (balanced_class_weights(train_ds.manifest.flat_labels(),
                                            model_cfg.num_classes)
                     if t.class_weighting else None)
    make_steps = make_stage2_steps if use_memory else make_stage1_steps
    prep = (DevicePrep(cfg.data, model_cfg.compute_dtype, dev)
            if cfg.data.device_normalize else None)
    train_step, eval_step = make_steps(class_weights, "sum",
                                       label_smoothing=t.label_smoothing,
                                       prep=prep, mesh=mesh)
    d = cfg.data
    local = (None if mesh is None else
             process_local_bounds(d.batch_clips, mesh.data_index, mesh.dp))
    train_loader = ClipLoader(train_ds, d.batch_clips, shuffle=True,
                              num_workers=d.num_workers, prefetch=d.prefetch,
                              seed=t.seed, drop_remainder=True,
                              use_processes=d.use_process_workers,
                              local_rows=local)
    val_loader = (ClipLoader(val_ds, d.batch_clips, shuffle=False,
                             num_workers=d.num_workers, prefetch=d.prefetch,
                             use_processes=d.use_process_workers,
                             local_rows=local)
                  if val_ds is not None else None)

    schedule = make_schedule(t)
    if start_epoch and hasattr(schedule, "scale"):
        # the plateau schedule's host state: a fresh one would revert the
        # rate to base_lr after the first resumed epoch
        for k in ("best", "bad_epochs", "scale"):
            if f"sched_{k}" in resume_meta:
                setattr(schedule, k, resume_meta[f"sched_{k}"])
    tracker = BestTracker()
    if start_epoch:
        # re-seed the rule from the saved best, so the first resumed epoch
        # cannot overwrite the real best checkpoint
        bm = ckpt.best_metadata().get("metrics", {})
        tracker.best_val = float(bm.get("val_acc", -1.0))
        tracker.best_train = float(bm.get("train_acc", -1.0))
        tracker.best_epoch = int(bm.get("epoch", -1))
    window = cfg.memory.window
    memory_fn = (_make_memory_fn(cfg, train_ds, bank, window)
                 if use_memory else None)
    val_memory_fn = (_make_memory_fn(
        cfg, val_ds, val_bank if val_bank is not None else bank, window)
        if use_memory and val_ds is not None else None)

    minibatch_val = None
    if t.val_minibatch_every and val_ds is not None:
        vb_clips, vb_dlabels, vb_rows, vb_pad = next(iter(device_prefetch(
            val_loader.epoch(0), device=dev, array_indices=(0, 1))))
        b = len(vb_rows) - vb_pad
        vb_labels = (vb_dlabels[:b].cpu().numpy() if mesh is None
                     else val_ds.clip_labels[vb_rows[:b]])
        lo, hi = local or (0, d.batch_clips)

        def minibatch_val(st):
            losses, preds = _gather_rows(mesh, *(a[None] for a in _eval_batch(
                eval_step, st, vb_clips, vb_dlabels, vb_rows, val_memory_fn,
                lo, hi)))
            return {"loss": float(losses[0, :b].sum()) / max(b, 1),
                    "acc": float((preds[0, :b] == vb_labels).mean())}

    stop = {"stop": False}
    restore_sigs = []
    if t.preempt_save:
        def _on_preempt(signum, frame):
            # this process's own signals only: a peer's stop adopted by
            # _global_stop must not make a first local one interrupt
            stop["signals"] = stop.get("signals", 0) + 1
            if stop["signals"] > 1:     # the second signal interrupts
                raise KeyboardInterrupt
            stop["stop"] = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                restore_sigs.append((sig, signal.signal(sig, _on_preempt)))
            except ValueError:          # not the main thread: raw signals
                pass
    try:
        return _epoch_loop(cfg, state, stop, start_epoch, train_step,
                           eval_step, train_loader, val_loader, dev,
                           memory_fn, val_memory_fn, log, minibatch_val,
                           schedule, tracker, ckpt, [], mesh)
    finally:
        # an async save, the preemption's too, is durable before the
        # trainer returns (on every rank: rank 0's write, waited for)
        ckpt.wait()
        for sig, prev in restore_sigs:
            signal.signal(sig, prev)


def _epoch_loop(cfg, state, stop, start_epoch, train_step, eval_step,
                train_loader, val_loader, dev, memory_fn, val_memory_fn,
                log, minibatch_val, schedule, tracker,
                ckpt: CheckpointManager, history: List[EpochStats],
                mesh: Optional[DataMesh] = None):
    """The epochs of `_fit`, inside the signal handlers. Returns (the
    state, the history)."""
    from tmrnet_torch.eval.metrics import classification_metrics

    t = cfg.train
    ncls = cfg.model.num_classes
    plateau = lambda: ({"sched_best": schedule.best,
                        "sched_bad_epochs": schedule.bad_epochs,
                        "sched_scale": schedule.scale}
                       if hasattr(schedule, "scale") else {})
    for epoch in range(start_epoch, t.epochs):
        t0 = time.time()
        tr_loss, tr_acc, interrupted = _run_epoch_train(
            train_step, state, train_loader, epoch, t.seed, dev, memory_fn,
            log, t.log_every, minibatch_val, t.val_minibatch_every,
            t.log_images_every, stop, mesh)
        if interrupted:
            # marked for the epoch's replay (epoch = the last completed
            # one): resume restarts this epoch from these weights
            ckpt.save(state, step=state.step,
                      metrics={"epoch": epoch - 1, "preempted": True,
                               **plateau()})
            if log is not None:
                log.log(epoch, {"preempted": 1.0}, prefix="epoch/")
            break
        if val_loader is not None:
            va_loss, va_acc, va_preds, va_labels, _ = _run_epoch_eval(
                eval_step, state, val_loader, dev, val_memory_fn, mesh)
            if log is not None and va_preds.size:
                cmm = classification_metrics(va_labels, va_preds, ncls)
                for c in range(ncls):
                    log.log(epoch, {f"precision_{c}": cmm["precision"][c],
                                    f"recall_{c}": cmm["recall"][c]},
                            prefix="val/")
                log.log_confusion_matrix(epoch, va_labels, va_preds, ncls,
                                         tag="val/confusion")
        else:
            va_loss, va_acc = tr_loss, tr_acc
        lr = schedule(epoch + 1, va_loss)
        set_learning_rate(state.optimizer, lr)
        secs = time.time() - t0
        history.append(EpochStats(epoch, tr_loss, tr_acc, va_loss, va_acc,
                                  lr, secs))
        if log is not None:
            log.log(epoch, {"train_loss": tr_loss, "train_acc": tr_acc,
                            "val_loss": va_loss, "val_acc": va_acc,
                            "lr": lr, "seconds": secs}, prefix="epoch/")
        is_best = tracker.update(epoch, va_acc, tr_acc)
        ckpt.save(state, step=state.step,
                  metrics={"epoch": epoch, "val_acc": va_acc,
                           "train_acc": tr_acc, "val_loss": va_loss,
                           **plateau()},
                  is_best=is_best)
        if _global_stop(stop, mesh):
            # the signal came in the val pass or the bookkeeping: this
            # epoch is complete and saved, resume goes on with the next
            if log is not None:
                log.log(epoch, {"preempted": 1.0}, prefix="epoch/")
            break
        if (t.early_stop_patience
                and epoch - tracker.best_epoch >= t.early_stop_patience):
            if log is not None:
                log.log(epoch, {"early_stop": 1.0}, prefix="epoch/")
            break
    return state, history


def _check_mesh(mesh) -> Optional[DataMesh]:
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise NotImplementedError(
            f"mesh={type(mesh).__name__}: the trainers take the grid over "
            f"processes (parallel/mesh.py::make_mesh)")
    return mesh


def train_stage1(cfg: ExperimentConfig, train_ds: ClipDataset,
                 val_ds: Optional[ClipDataset] = None,
                 init_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 mesh: Optional[DataMesh] = None,
                 log: Optional[MetricLogger] = None,
                 device="cuda") -> Tuple[TrainState, List[EpochStats]]:
    """Stage-1 memory-bank model training (head stage1) from
    `init_state_dict` (default: fresh flax-distributed weights at
    train.seed) on `device`, or over the grid `mesh` on its device (only
    encoder.lstm.weight_ih is sliced over its model axis, as JAX's rules
    shard it). Returns (the train state, the history)."""
    _check_mesh(mesh)
    model_cfg = dataclasses.replace(cfg.model, head="stage1",
                                    remat=cfg.train.remat)
    return _fit(cfg, model_cfg, train_ds, val_ds, use_memory=False, bank=None,
                slow_modules=slow_modules_for_head("stage1"),
                init_state_dict=init_state_dict, log=log, device=device,
                mesh=mesh)


def train_stage2(cfg: ExperimentConfig, train_ds: ClipDataset,
                 bank: FeatureBank, val_ds: Optional[ClipDataset] = None,
                 val_bank: Optional[FeatureBank] = None,
                 init_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 mesh: Optional[DataMesh] = None,
                 log: Optional[MetricLogger] = None,
                 device="cuda") -> Tuple[TrainState, List[EpochStats]]:
    """TMRNet (or only-non-local) head training over a built bank; train
    and val read their own banks (val_bank defaults to bank). Under a mesh
    every rank holds the whole banks on its device, and the head's layers
    that the TP rules name are sliced over its model axis."""
    _check_mesh(mesh)
    if val_ds is not None and val_bank is None:
        val_bank = bank
    head = cfg.model.head if cfg.model.head in ("tmr", "nl_only") else "tmr"
    model_cfg = dataclasses.replace(cfg.model, head=head,
                                    remat=cfg.train.remat)
    return _fit(cfg, model_cfg, train_ds, val_ds, use_memory=True, bank=bank,
                slow_modules=slow_modules_for_head(head),
                init_state_dict=init_state_dict, log=log, val_bank=val_bank,
                device=device, mesh=mesh)
