"""Evaluation and the bank build partitioned over processes.

Port of `tmrnet_tpu/eval/distributed.py`. The corpus engine and the
video-engine bank build are independent across videos: each rank runs its
own `VideoInference` on its own card over its part of the videos
(`partition_videos`, the same on every rank from the manifest alone), and
the results are gathered so that every rank, rank 0 among them (which
writes the outputs), holds the whole, in manifest order. The outputs equal
a one-process run's: a video's math does not depend on the rank that runs
it. A rank that owns no video still joins every gather.

Reference workload scaled out: the 40-video Cholec80 test pass of
`code/eval/python/test_singlenet_phase_non-local_pretrained_2fc_copy.py:273-457`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tmrnet_torch.config import ExperimentConfig
from tmrnet_torch.data.indexing import clips_per_video
from tmrnet_torch.parallel.mesh import (DataMesh, all_gather_host,
                                        initialize_multihost, make_mesh)


def partition_videos(lengths: Sequence[int], num_parts: int
                     ) -> List[List[int]]:
    """Balanced partition of video indices by frame count (JAX's :26-41):
    longest first, each into the lightest part so far (ties to the lower
    part index); every part sorted."""
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    order = sorted(range(len(lengths)), key=lambda i: (-int(lengths[i]), i))
    parts: List[List[int]] = [[] for _ in range(num_parts)]
    loads = [0] * num_parts
    for i in order:
        p = min(range(num_parts), key=lambda j: (loads[j], j))
        parts[p].append(i)
        loads[p] += int(lengths[i])
    return [sorted(p) for p in parts]


def owners(parts: Sequence[Sequence[int]], n: int) -> List[int]:
    """Video index -> the part (rank) that owns it."""
    owner_of = [0] * n
    for p, vids in enumerate(parts):
        for i in vids:
            owner_of[i] = p
    return owner_of


def local_eval_mesh(cfg: ExperimentConfig, device="cuda") -> DataMesh:
    """Join the process group of `cfg.mesh` (before any other CUDA call)
    and return the data mesh, whose device is this rank's card: the
    engines run on it in this process alone, the videos are what is
    partitioned."""
    m = cfg.mesh
    dev = initialize_multihost(
        coordinator=m.coordinator or None,
        num_processes=None if m.num_processes < 0 else m.num_processes,
        process_id=None if m.process_id < 0 else m.process_id,
        device=device)
    return make_mesh(m, dev)


def gather_video_results(local: dict, owner_of: Sequence[int],
                         lengths: Sequence[int], seq_len: int,
                         num_classes: int,
                         mesh: Optional[DataMesh] = None
                         ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Every rank's per-video (preds, probs) on every rank, in video order.

    local: {video index: (preds (k,), probs (k, C))} of this rank's
    videos; owner_of: video index -> rank. The arrays are padded to the
    longest video, gathered once each, and each video's row read from its
    owner's slot. Without a mesh over several ranks, `local` in order."""
    nv = len(lengths)
    ks = [max(0, int(n) - seq_len + 1) for n in lengths]
    width = max(max(ks, default=0), 1)
    preds = np.full((nv, width), -1, np.int32)
    probs = np.zeros((nv, width, num_classes), np.float32)
    for i, (p, s) in local.items():
        if ks[i]:
            preds[i, :ks[i]] = np.asarray(p, np.int32)
            probs[i, :ks[i]] = np.asarray(s, np.float32)
    if mesh is not None and mesh.world > 1:
        g_preds = all_gather_host(preds, mesh)
        g_probs = all_gather_host(probs, mesh)
        preds = np.stack([g_preds[owner_of[i], i] for i in range(nv)])
        probs = np.stack([g_probs[owner_of[i], i] for i in range(nv)])
    return [(preds[i, :ks[i]].astype(np.int64), probs[i, :ks[i]])
            for i in range(nv)]


def run_lfb_distributed(cfg: ExperimentConfig,
                        extractor_state_dict: Mapping[str, torch.Tensor],
                        ds, cache_path: Optional[str] = None,
                        mesh: Optional[DataMesh] = None,
                        fused_kernel: str = "block", device="cuda"):
    """The video-engine bank of a dataset, its videos partitioned over the
    ranks: each rank runs `VideoInference.bank_features` over its own
    videos on its card, and only the rows it owns travel (padded to the
    largest count of owned rows, one gather); every rank returns the whole
    bank, rank 0 writes the `.npz`. device: without a mesh."""
    from tmrnet_torch.eval.infer import VideoInference
    from tmrnet_torch.memory.lfb import FeatureBank, save_bank
    from tmrnet_torch.train.loop import (framewise_transform_for_video_build,
                                         load_video_frames)

    dev = mesh.device if mesh is not None else device
    world = mesh.world if mesh is not None else 1
    rank = mesh.rank if mesh is not None else 0
    tf = framewise_transform_for_video_build(ds)
    lengths = ds.manifest.video_lengths
    bank = FeatureBank.create(ds.seq_len, lengths, cfg.model.hidden_dim,
                              device=dev)
    total, dim = bank.features.shape
    first_of = np.concatenate(
        [[0], np.cumsum(clips_per_video(ds.seq_len, lengths))]).astype(np.int64)
    parts = partition_videos(lengths, world)
    row_owner = np.zeros(total, np.int64)
    for p, vids in enumerate(parts):
        for i in vids:
            row_owner[first_of[i]:first_of[i + 1]] = p
    if parts[rank]:
        engine = VideoInference(
            cfg.replace(model=dataclasses.replace(cfg.model, head="lfb")),
            extractor_state_dict, extractor_state_dict, device=dev,
            fused_kernel=fused_kernel)
        for i in parts[rank]:
            frames = load_video_frames(ds, ds.manifest.videos[i])
            if tf is not None:
                frames = tf(frames)
            vals = engine.bank_features(frames)
            if vals.shape[0]:
                bank.features[first_of[i]:first_of[i + 1]] = vals
    if world > 1:
        own = [np.flatnonzero(row_owner == p) for p in range(world)]
        send = np.zeros((max(max(len(r) for r in own), 1), dim), np.float32)
        send[:len(own[rank])] = bank.features[
            torch.as_tensor(own[rank], device=dev)].cpu().numpy()
        got = all_gather_host(send, mesh)
        for p, rows in enumerate(own):
            if p != rank and len(rows):
                bank.features[torch.as_tensor(rows, device=dev)] = (
                    torch.from_numpy(got[p, :len(rows)]).to(dev))
    if cache_path and rank == 0:
        save_bank(cache_path, bank)
    return bank


def run_corpus_distributed(cfg: ExperimentConfig,
                           state_dict: Mapping[str, torch.Tensor],
                           extractor_state_dict: Mapping[str, torch.Tensor],
                           lengths: Sequence[int],
                           load_video: Callable[[int], np.ndarray],
                           mesh: Optional[DataMesh] = None,
                           fused_kernel: str = "block", device="cuda"
                           ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Whole-test-set inference partitioned over the ranks: each rank runs
    `VideoInference.run_corpus` on its card over its own videos (loaded
    lazily by `load_video(index)`, transformed frames), then
    `gather_video_results`. Returns every video's (preds, probs) in order,
    on every rank, equal to a one-process `run_corpus`. device: without a
    mesh."""
    from tmrnet_torch.eval.infer import VideoInference

    world = mesh.world if mesh is not None else 1
    rank = mesh.rank if mesh is not None else 0
    parts = partition_videos(lengths, world)
    mine = parts[rank]
    local = {}
    if mine:
        engine = VideoInference(cfg, state_dict, extractor_state_dict,
                                device=mesh.device if mesh else device,
                                fused_kernel=fused_kernel)
        outs = engine.run_corpus([(lambda i=i: load_video(i)) for i in mine],
                                 lengths=[lengths[i] for i in mine],
                                 chunk=cfg.eval.corpus_chunk)
        local = dict(zip(mine, outs))
    return gather_video_results(local, owners(parts, len(lengths)), lengths,
                                cfg.data.sequence_length,
                                cfg.model.num_classes, mesh)
