"""Head-level architecture ranking on the multi-scale task: the memory head
alone, trained on frozen stage-1 bank features as a binary classifier of
the designed ambiguous pair (phases 5 vs 11 of
`data/synthetic.py::MULTISCALE_SPEC`).

    python -m tmrnet_torch.experimental.headlevel_multiscale --work DIR
        [--seeds 0 1] [--full-scale] [--device cuda|cpu] ...

Port of `scripts/headlevel_multiscale.py` (`HeadOnly` :68-87,
`build_assets` :90-113, `pair_tensors` :116-133, `train_head` :136-167,
`main` :170-198). nl_only reads the window as a row multiset, whose
distribution is the same for both classes, so its pair accuracy is ~0.5;
TimeConv sees up to 7 adjacent rows before the attention and can tell the
close gap from the far one. The dataset, the stage-1 extractor and the
banks come from the port's command line in this process (synth ->
manifest -> train-bank -> build-lfb, the overrides of
`experimental/efficacy_study.py`); then each head (tmr with TimeConv,
nl_only without) trains with Adam (lr 1e-3) on the pair clips only, its
weights drawn from a torch generator seeded with the run's seed by flax's
initialisers' distributions, its batches drawn by numpy's
`default_rng(seed)` as JAX's are. Rows with JAX's keys go to stdout and
`headlevel_results.json`.

The tiny default (backbone tiny, f32, hidden 32) runs on the CPU only
(`--device cpu`); on the card, `--full-scale` (ResNet-50 at 224² crops,
hidden 512, bf16) is required, and the tiny model is refused by name
(`efficacy_study.check_scale`): the card's kernels need C a multiple of
64.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tmrnet_torch.device import resolve_device, torch_dtype
from tmrnet_torch.experimental.efficacy_study import (FULL_SCALE, card_sets,
                                                      check_scale,
                                                      common_overrides,
                                                      folded_sets, run_cli)
from tmrnet_torch.models.blocks import NLBlock, TimeConv, dense
from tmrnet_torch.models.tmrnet import init_weights_


class HeadOnly(nn.Module):
    """TMRNet's stack after the clip encoder (`models/tmrnet.py::TMRNet.
    head`) over frozen features: st the clip's own bank row, lt its memory
    window; dropout off (an expressivity experiment). Leaf names are JAX's,
    so `models/convert.py::from_jax_variables` carries its weights."""

    def __init__(self, hidden: int, use_time_conv: bool, num_classes: int = 2,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = torch_dtype(compute_dtype)
        self.time_conv = (TimeConv(hidden, self.compute_dtype)
                          if use_time_conv else None)
        self.nl_block = NLBlock(hidden, self.compute_dtype, dropout=0.0)
        self.fc_h_c = nn.Linear(2 * hidden, hidden)
        self.fc_c = nn.Linear(hidden, num_classes)

    def forward(self, st: torch.Tensor, lt: torch.Tensor) -> torch.Tensor:
        """st (B, hidden), lt (B, window, hidden) -> logits (B, classes) in
        the compute dtype."""
        st, lt = st.to(self.compute_dtype), lt.to(self.compute_dtype)
        if self.time_conv is not None:
            lt = self.time_conv(lt)
        y = torch.cat([st, self.nl_block(st, lt)], dim=-1)
        return dense(self.fc_c, torch.relu(dense(self.fc_h_c, y)))


def build_assets(work: str, videos=(24, 2, 8), seed: int = 0,
                 epochs1: int = 6, lr1: float = 0.05, scale: dict = {},
                 device: str = "cuda") -> None:
    """Dataset, stage-1 extractor and train/test banks through the port's
    command line; what exists is kept."""
    scale = {**scale, "extra_sets": tuple(scale.get("extra_sets", ()))
             + card_sets(device)}
    ov = common_overrides(work, seed, task="multiscale", **scale)
    if not os.path.exists(f"{work}/test.pkl"):
        run_cli(["synth", "--out-dir", work, "--train", videos[0],
                 "--val", videos[1], "--test", videos[2],
                 "--hw", scale.get("hw", 32), "--seed", 0,
                 "--task", "multiscale"], device)
        for split in ("train", "val", "test"):
            run_cli(["manifest", "--frames", f"{work}/frames-{split}",
                     "--annotations", f"{work}/annotations",
                     "--stride", 1, "--out", f"{work}/{split}.pkl"], device)
    s1 = f"{work}/ckpt-stage1"
    if not os.path.exists(os.path.join(s1, "best.json")):
        run_cli(["train-bank", "--train-manifest", f"{work}/train.pkl",
                 "--val-manifest", f"{work}/val.pkl",
                 "--log-dir", f"{work}/logs-s1", *ov,
                 "--set", f"train.epochs={epochs1}",
                 "--set", f"train.lr={lr1}",
                 "--set", f"train.checkpoint_dir={s1}"], device)
    for split in ("train", "test"):
        if not os.path.exists(f"{work}/lfb_{split}.npz"):
            run_cli(["build-lfb", "--manifest", f"{work}/{split}.pkl",
                     "--ckpt", s1, "--out", f"{work}/lfb_{split}.npz", *ov,
                     *folded_sets(device)], device)


def pair_tensors(work: str, split: str):
    """(st, window, binary label) as numpy arrays for every clip of the
    designed pair, by the engines' row and window mapping
    (`memory/lfb.py`)."""
    from tmrnet_torch.data.indexing import (clip_start_indices,
                                            rows_to_video_ids,
                                            video_first_rows)
    from tmrnet_torch.data.manifests import load_pickle_manifest
    from tmrnet_torch.data.synthetic import (MULTISCALE_PAIR, MULTISCALE_SEQ,
                                             MULTISCALE_WINDOW)
    from tmrnet_torch.memory.lfb import gather_memory_windows, load_bank

    m, _ = load_pickle_manifest(f"{work}/{split}.pkl")
    bank = load_bank(f"{work}/lfb_{split}.npz", device="cpu")
    seq = MULTISCALE_SEQ
    starts = clip_start_indices(seq, m.video_lengths)
    y = m.flat_labels()[starts + seq - 1]
    rows = np.arange(len(starts), dtype=np.int64)
    vids = rows_to_video_ids(len(rows), seq, m.video_lengths)
    firsts = video_first_rows(seq, m.video_lengths)[vids]
    mask = np.isin(y, MULTISCALE_PAIR)
    rows, firsts = rows[mask], firsts[mask]
    lt = gather_memory_windows(bank.features, torch.from_numpy(rows),
                               torch.from_numpy(firsts), MULTISCALE_WINDOW)
    st = bank.features[torch.from_numpy(rows)]
    yb = (y[mask] == MULTISCALE_PAIR[1]).astype(np.int64)
    return st.numpy(), lt.numpy(), yb


def init_head(hidden: int, use_time_conv: bool, seed: int, device="cpu",
              compute_dtype="float32") -> HeadOnly:
    """A HeadOnly on `device` with weights from a torch generator at
    `seed` (`models/tmrnet.py::init_weights_`)."""
    model = HeadOnly(hidden, use_time_conv, compute_dtype=compute_dtype)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device))


def adam_step(model: HeadOnly, lr: float = 1e-3):
    """step(st, lt, y) -> the batch's mean softmax cross-entropy (f32),
    after one Adam update of `model` (optax.adam's defaults)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def step(st, lt, y):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(st, lt).float(), y)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


@torch.no_grad()
def accuracy(model: HeadOnly, st, lt, y) -> float:
    return float((model(st, lt).argmax(-1) == y).float().mean())


def train_head(st, lt, y, st_te, lt_te, y_te, use_time_conv: bool,
               seed: int, hidden: int, steps: int = 3000, batch: int = 128,
               lr: float = 1e-3, device="cuda",
               compute_dtype="float32") -> dict:
    """One head trained for `steps` Adam steps on batches of `batch` rows
    drawn with replacement; its row of train and test pair accuracy."""
    dev = resolve_device(device)
    model = init_head(hidden, use_time_conv, seed, dev, compute_dtype)
    step = adam_step(model, lr)
    put = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
    st, lt, y = put(st), put(lt), put(y)
    rng = np.random.default_rng(seed)
    n = st.shape[0]
    for _ in range(steps):
        idx = put(rng.integers(0, n, size=min(batch, n)))
        step(st[idx], lt[idx], y[idx])
    return {"head": "tmr" if use_time_conv else "nl_only", "seed": seed,
            "train_acc": accuracy(model, st, lt, y),
            "test_acc": accuracy(model, put(st_te), put(lt_te), put(y_te))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--train-videos", type=int, default=24)
    ap.add_argument("--test-videos", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--hidden", type=int, default=32,
                    help="the bank's and the head's width (512 under "
                         "--full-scale)")
    ap.add_argument("--full-scale", action="store_true",
                    help="the real ResNet-50 at 224px crops, hidden 512, "
                         "bf16: the card's configuration")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs --full-scale) or cpu")
    args = ap.parse_args(argv)
    scale = (dict(FULL_SCALE) if args.full_scale
             else {"hidden": args.hidden})
    check_scale(scale, args.device)
    os.makedirs(args.work, exist_ok=True)
    build_assets(args.work, videos=(args.train_videos, 2, args.test_videos),
                 scale=scale, device=args.device)
    st, lt, y = pair_tensors(args.work, "train")
    st_te, lt_te, y_te = pair_tensors(args.work, "test")
    print(f"pair clips: train={len(y)} (pos {int(y.sum())}) "
          f"test={len(y_te)} (pos {int(y_te.sum())})")
    rows = []
    for seed in args.seeds:
        for tc in (True, False):
            r = train_head(st, lt, y, st_te, lt_te, y_te, tc, seed,
                           scale["hidden"], steps=args.steps,
                           device=args.device,
                           compute_dtype=scale.get("compute_dtype",
                                                   "float32"))
            rows.append(r)
            print(json.dumps(r))
    with open(os.path.join(args.work, "headlevel_results.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
