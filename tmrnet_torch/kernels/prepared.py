"""Copies of parameters in the layout a kernel reads, made once and made
again only when a parameter changed.

A parameter counts as changed when its storage or its version counter
(bumped by every in-place write: `load_state_dict`, `add_`, indexing) moved.
A `Prepared` holds the tensors it was made from, so their storage is not
reused while it is compared against. The copies carry no gradient.

A module keeps its `Prepared` beside its parameters; a function handed bare
tensors keeps its copies beside them through `copy_beside`.

Under `torch.export` the sources are fake tensors, with no storage to
compare: `get` hands back the copies it holds, which the export made from
the real weights by running its step once before tracing
(`eval/saved.py`), so that the exported program holds them as constants
instead of tracing the layout ops into every call.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.utils.weak import WeakIdKeyDictionary


class Prepared:
    """One set of prepared copies; its owner keeps it beside the tensors it
    is made from."""

    def __init__(self):
        self._held = None   # (sources, their versions, the copies)

    def get(self, sources: Sequence[torch.Tensor], make: Callable):
        """make(*sources), or what it returned last time if no source
        changed since (under export: whenever there is one)."""
        if torch.compiler.is_exporting():
            return make(*sources) if self._held is None else self._held[2]
        if self._held is not None:
            held, versions, out = self._held
            if len(held) == len(sources) and all(
                    s.data_ptr() == h.data_ptr() and s._version == v
                    for s, h, v in zip(sources, held, versions)):
                return out
        with torch.no_grad():
            out = make(*sources)
        self._held = ([s.detach() for s in sources],
                      [s._version for s in sources], out)
        return out


# Each tensor's copies by the function that makes them, for as long as the
# tensor lives.
_BESIDE = WeakIdKeyDictionary()


def copy_beside(t: torch.Tensor, make: Callable):
    """make(t), made once per change of t and kept beside t for as long as t
    lives."""
    by_make = _BESIDE.get(t)
    if by_make is None:
        by_make = _BESIDE[t] = {}
    prepared = by_make.get(make)
    if prepared is None:
        prepared = by_make[make] = Prepared()
    return prepared.get((t,), make)
