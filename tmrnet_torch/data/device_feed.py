"""The host-to-card feed and the wire convention for frames on the card.

Port of `tmrnet_tpu/data/device_feed.py` (`device_prefetch` :19-64,
`DevicePrep` :67-92). `device_prefetch` copies each batch's arrays to the
card `buffer_size` batches ahead of the consumer, from page-locked staging
on a copy stream. `DevicePrep`: uint8 frames are cast to the compute dtype
and, under `device_normalize`, become (x - mean*255) / (std*255) in that
dtype; float frames are only cast.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from tmrnet_torch.config import DataConfig
from tmrnet_torch.device import resolve_device, torch_dtype


class _CardStager:
    """Copies host arrays to the card from page-locked staging on a copy
    stream. Batch k stages through slot k % slots; a slot's buffers are
    written again only after the event of its last copies has completed,
    so no copy reads a buffer the host is refilling."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers = [dict() for _ in range(slots)]
        self.events = [None] * slots
        self.count = 0

    def stage(self, items, indices):
        """items' host arrays at `indices` -> tensors on the card (their
        copies queued); returns (items, the copies' event)."""
        slot = self.count % len(self.buffers)
        self.count += 1
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        out = []
        for i, item in enumerate(items):
            if i not in indices:
                out.append(item)
                continue
            host = _host_tensor(item)
            buf = self.buffers[slot].get(i)
            if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
                buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                self.buffers[slot][i] = buf
            buf.copy_(host)
            with torch.cuda.stream(self.stream):
                out.append(buf.to(self.device, non_blocking=True))
        event = torch.cuda.Event()
        event.record(self.stream)
        self.events[slot] = event
        return out, event

    def hand_over(self, items, event):
        """The consumer's stream waits for the copies, and the allocator
        keeps each card tensor until that stream is done with it."""
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for item in items:
            if isinstance(item, torch.Tensor) and item.device == self.device:
                item.record_stream(current)
        return tuple(items)


def _is_array(item) -> bool:
    return isinstance(item, (np.ndarray, torch.Tensor))


def _host_tensor(item) -> torch.Tensor:
    if isinstance(item, torch.Tensor):
        return item.contiguous()
    return torch.from_numpy(np.ascontiguousarray(item))


def device_prefetch(batches: Iterable, device="cuda", buffer_size: int = 2,
                    array_indices: Optional[Tuple[int, ...]] = None
                    ) -> Iterator[tuple]:
    """Wrap an iterator of batch tuples: the arrays (numpy or CPU tensors)
    at `array_indices` (all arrays when None) become tensors on `device`,
    `buffer_size` batches ahead of consumption; other items pass through.
    On the card the copies run from page-locked staging on a copy stream
    and the consumer's stream waits on each batch's event; on the CPU the
    arrays become CPU tensors. A bare array batch raises, as JAX's does."""
    dev = resolve_device(device)

    def indices(batch):
        if _is_array(batch):
            raise TypeError(
                "device_prefetch expects each batch to be a tuple/list of "
                "items; wrap a bare array batch as (array,)")
        return {i for i, item in enumerate(batch) if _is_array(item)
                and (array_indices is None or i in array_indices)}

    if dev.type == "cpu":
        for batch in batches:
            at = indices(batch)
            yield tuple(_host_tensor(item) if i in at else item
                        for i, item in enumerate(batch))
        return

    stager = _CardStager(dev, buffer_size + 1)
    staged: deque = deque()
    for batch in batches:
        staged.append(stager.stage(batch, indices(batch)))
        if len(staged) > buffer_size:
            yield stager.hand_over(*staged.popleft())
    while staged:
        yield stager.hand_over(*staged.popleft())


class DevicePrep:
    def __init__(self, data_cfg: DataConfig, compute_dtype, device):
        self.cdt = torch_dtype(compute_dtype)
        self.mean = torch.tensor(data_cfg.mean, dtype=self.cdt,
                                 device=device) * 255.0
        self.std = torch.tensor(data_cfg.std, dtype=self.cdt,
                                device=device) * 255.0
        self.dev_norm = data_cfg.device_normalize

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        if frames.dtype == torch.uint8:
            frames = frames.to(self.cdt)
            if self.dev_norm:
                frames = (frames - self.mean) / self.std
        elif frames.dtype != self.cdt:
            frames = frames.to(self.cdt)
        return frames
