"""Weight bridge from the JAX package's variables to the port's state dict,
and seeded random variables in the same layout.

`from_jax_variables` takes the flax variables tree ({"params": ...,
"batch_stats": ...}, folded or not) as nested dicts of numpy arrays and
returns a state dict that the port's model loads with
`load_state_dict(strict=True)`. The port's module names are the flax names,
so the bridge only changes layouts:

- conv kernels HWIO -> OIHW;
- Conv1d kernels (k, Cin, Cout) -> (Cout, Cin, k);
- Dense kernels (in, out) -> torch Linear (out, in);
- norm `scale` -> `weight`; BatchNorm `mean`/`var` -> `running_mean`/
  `running_var` (plus torch's `num_batches_tracked`).

`random_variables` builds a flax-layout tree of the same names and shapes
from a numpy seed, for runs that need full-size weights without the JAX
package (chip_smoke.py).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from tmrnet_torch.config import ModelConfig

_KERNEL_PERM = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}


def _tensor(a, perm=None) -> torch.Tensor:
    a = np.asarray(a)
    if perm is not None:
        a = a.transpose(perm)
    return torch.from_numpy(np.array(a, order="C"))


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def walk(params: Mapping, stats: Mapping, prefix: str) -> None:
        for name, node in params.items():
            key = prefix + name
            node_stats = stats.get(name, {}) if stats else {}
            if not isinstance(node, Mapping):
                out[key] = _tensor(node)
            elif "kernel" in node:
                kernel = np.asarray(node["kernel"])
                out[key + ".weight"] = _tensor(kernel, _KERNEL_PERM[kernel.ndim])
                if "bias" in node:
                    out[key + ".bias"] = _tensor(node["bias"])
            elif "scale" in node:
                out[key + ".weight"] = _tensor(node["scale"])
                out[key + ".bias"] = _tensor(node["bias"])
                if "mean" in node_stats:
                    out[key + ".running_mean"] = _tensor(node_stats["mean"])
                    out[key + ".running_var"] = _tensor(node_stats["var"])
                    out[key + ".num_batches_tracked"] = torch.tensor(0)
            else:
                walk(node, node_stats, key + ".")

    walk(variables["params"], variables.get("batch_stats", {}), "")
    return out


def random_variables(cfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    """Unfolded flax-layout variables for `cfg`, f32, drawn from numpy's
    generator at `seed`: the backbone and `encoder.lstm` for every head,
    plus `fc` (head stage1), or the memory head (tmr: `time_conv`,
    `nl_block`, `fc_h_c`, `fc_c`; nl_only the same without `time_conv`);
    head lfb has nothing more. Scales keep activations O(1) through a deep
    trunk: He-normal convs, the last BatchNorm of each residual branch
    scaled by 0.25, Xavier LSTM and dense kernels."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    normal = lambda shape, std: f32(rng.normal(0.0, std, shape))
    uniform = lambda shape, lo, hi: f32(rng.uniform(lo, hi, shape))

    def conv(kh, cin, cout):
        return {"kernel": normal((kh, kh, cin, cout), np.sqrt(2.0 / (kh * kh * cin)))}

    def bn(c, scale=1.0):
        p = {"scale": uniform((c,), 0.8 * scale, 1.2 * scale),
             "bias": normal((c,), 0.05)}
        s = {"mean": normal((c,), 0.1), "var": uniform((c,), 0.5, 1.5)}
        return p, s

    def dense(din, dout):
        lim = np.sqrt(6.0 / (din + dout))
        return {"kernel": uniform((din, dout), -lim, lim),
                "bias": normal((dout,), 0.02)}

    if cfg.backbone == "resnet50":
        stage_sizes, width = tuple(cfg.stage_sizes), cfg.width
    elif cfg.backbone == "tiny":
        stage_sizes, width = (1, 1), 8
    else:
        raise ValueError(f"backbone {cfg.backbone!r} is not ported")
    bp: Dict[str, Any] = {"conv1": conv(7, 3, width)}
    bs: Dict[str, Any] = {}
    bp["bn1"], bs["bn1"] = bn(width)
    cin = width
    for l, n_blocks in enumerate(stage_sizes):
        planes = width * 2 ** l
        for i in range(n_blocks):
            strides = 2 if l > 0 and i == 0 else 1
            p: Dict[str, Any] = {"conv1": conv(1, cin, planes),
                                 "conv2": conv(3, planes, planes),
                                 "conv3": conv(1, planes, planes * 4)}
            s: Dict[str, Any] = {}
            p["bn1"], s["bn1"] = bn(planes)
            p["bn2"], s["bn2"] = bn(planes)
            p["bn3"], s["bn3"] = bn(planes * 4, 0.25)
            if strides != 1 or cin != planes * 4:
                p["downsample_conv"] = conv(1, cin, planes * 4)
                p["downsample_bn"], s["downsample_bn"] = bn(planes * 4, 0.25)
            bp[f"layer{l + 1}_{i}"], bs[f"layer{l + 1}_{i}"] = p, s
            cin = planes * 4

    h = cfg.hidden_dim
    xavier = lambda rows, cols: normal((rows, cols), np.sqrt(2.0 / (rows + cols)))
    params: Dict[str, Any] = {
        "backbone": bp,
        "encoder": {"lstm": {"weight_ih": xavier(4 * h, cin),
                             "weight_hh": xavier(4 * h, h),
                             "bias_ih": normal((4 * h,), 0.02),
                             "bias_hh": normal((4 * h,), 0.02)}},
    }
    if cfg.head == "stage1":
        params["fc"] = dense(h, cfg.num_classes)
    elif cfg.head in ("tmr", "nl_only"):
        params.update(
            nl_block={"query": dense(h, h), "key": dense(h, h),
                      "value": dense(h, h), "out": dense(h, h),
                      "layer_norm": {"scale": uniform((h,), 0.8, 1.2),
                                     "bias": normal((h,), 0.05)}},
            fc_h_c=dense(2 * h, h), fc_c=dense(h, cfg.num_classes))
    elif cfg.head != "lfb":
        raise ValueError(f"unknown head {cfg.head!r}")
    if cfg.head == "tmr":
        params["time_conv"] = {
            f"conv_k{k}": {"kernel": normal((k, h, h), np.sqrt(1.0 / (k * h))),
                           "bias": normal((h,), 0.02)}
            for k in (3, 5, 7)}
    return {"params": params, "batch_stats": {"backbone": bs}}
