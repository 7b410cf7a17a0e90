"""`python -m tmrnet_torch serve` against `python -m tmrnet_tpu serve`:
both CLIs read the same `--config` JSON (written by the JAX package), the
same reference-format `--torch-ckpt` (and `--extractor-torch-ckpt`) and
the same protocol file of packed `.npy#idx` frames, and must print the
same rows on stdout, probabilities within 1e-4 absolute (f32 on both; the
same math summed in another order). The port runs on the CPU
(`--device cpu`), folded (`--set model.folded=true`) and unfolded; the JAX
CLI runs unfolded. Also: the port's `--listen` over TCP, and what the port
CLI refuses."""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_serve import _assert_rows_match
from tmrnet_tpu import cli as jax_cli
from tmrnet_tpu.config import DataConfig, ExperimentConfig, MemoryConfig, ModelConfig
from tmrnet_tpu.models.torch_import import export_reference_checkpoint
from tmrnet_torch import cli
from tmrnet_torch.config import ModelConfig as PortModelConfig
from tmrnet_torch.eval import serve_net
from tmrnet_torch.models.convert import random_variables

torch.set_num_threads(2)

MODEL = dict(backbone="tiny", stage_sizes=(1, 1), width=8, hidden_dim=16,
             num_classes=5, head="tmr", compute_dtype="float32")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The config JSON, the model's and the extractor's `.pth`, and a
    packed video of 8 frames of 40x40 per stream."""
    d = tmp_path_factory.mktemp("cli")
    cfg = ExperimentConfig(
        data=DataConfig(sequence_length=4, resize=40, crop_size=32,
                        test_crop_type=1, device_normalize=True),
        model=ModelConfig(**MODEL), memory=MemoryConfig(window=4))
    (d / "cfg.json").write_text(cfg.to_json())
    for name, head, seed in (("model", "tmr", 41), ("extractor", "lfb", 42)):
        variables = random_variables(PortModelConfig(**dict(MODEL, head=head)),
                                     seed)
        sd = export_reference_checkpoint(variables, head, (1, 1))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   d / f"{name}.pth")
    rng = np.random.default_rng(43)
    for v in ("v0", "v1"):
        np.save(d / f"{v}.npy",
                rng.integers(0, 256, (8, 40, 40, 3), dtype=np.uint8))
    return d


def _protocol(d):
    """Join, tick, end and recycle over 2 slots, and a third stream that
    finds no free slot."""
    lines = []
    for t in range(7):
        lines.append({"id": "or-1", "image": f"{d}/v0.npy#{t}"})
        if t < 5:
            lines.append({"id": "or-2", "image": f"{d}/v1.npy#{t}"})
        if t == 1:
            lines.append({"id": "or-3", "image": f"{d}/v1.npy#0"})
        if t == 5:
            lines.append({"id": "or-2", "end": True})
            lines.append({"id": "or-3", "image": f"{d}/v1.npy#0"})
        if t == 6:
            lines.append({"id": "or-3", "image": f"{d}/v1.npy#1"})
        lines.append({"step": True})
    path = d / "events.jsonl"
    path.write_text("".join(json.dumps(o) + "\n" for o in lines))
    return str(path)


def _rows_and_summary(capsys):
    cap = capsys.readouterr()
    rows = [json.loads(line) for line in cap.out.splitlines()]
    summary = json.loads(cap.err.strip().splitlines()[-1])["summary"]
    return rows, summary


@pytest.mark.parametrize("folded,extractor", [(False, True), (True, False),
                                              (True, True)])
def test_port_serve_cli_matches_jax_cli(files, tmp_path, capsys, folded,
                                        extractor):
    d = files
    common = ["serve", "--config", str(d / "cfg.json"), "--input",
              _protocol(d), "--torch-ckpt", str(d / "model.pth"), "--slots",
              "2", "--probs"]
    if extractor:
        common += ["--extractor-torch-ckpt", str(d / "extractor.pth")]
    assert jax_cli.main(common + ["--set", "mesh.data_parallel=1"]) == 0
    want, want_sum = _rows_and_summary(capsys)
    port = common + ["--device", "cpu", "--state-dir", str(tmp_path / "sd")]
    if folded:
        port += ["--set", "model.folded=true"]
    assert cli.main(port) == 0
    got, got_sum = _rows_and_summary(capsys)
    _assert_rows_match(got, want)
    assert [r["error"] for r in got if "error" in r] == ["no free slot"]
    assert sum(r["valid"] for r in got if "valid" in r) > 0
    for k in ("ticks", "rows", "live_streams", "slots", "evicted"):
        assert got_sum[k] == want_sum[k], k
    assert "latency_ms" in got_sum and "step_ms" in got_sum
    assert (tmp_path / "sd" / "state.npz").exists()


def test_port_serve_cli_listens_over_tcp(files, capsys, monkeypatch):
    """`--listen` through the port's CLI: the bound address on stderr, then
    `ready`; a client drives one stream over the socket."""
    d = files
    created = []
    real = serve_net.JsonlTcpServer

    class _Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            created.append(self)

    monkeypatch.setattr(serve_net, "JsonlTcpServer", _Spy)
    got = {}

    def client():
        deadline = time.monotonic() + 60
        while not created:
            assert time.monotonic() < deadline, "server never started"
            time.sleep(0.05)
        srv = created[0]
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        f = sock.makefile("r")
        try:
            for t in range(3):
                sock.sendall(json.dumps(
                    {"id": "or-1", "image": f"{d}/v0.npy#{t}"}).encode()
                    + b"\n" + b'{"step": true}\n')
                got.setdefault("rows", []).append(json.loads(f.readline()))
        finally:
            sock.shutdown(socket.SHUT_RDWR)
            f.close()
            sock.close()
            srv.stop()

    th = threading.Thread(target=client)
    th.start()
    assert cli.main(["serve", "--config", str(d / "cfg.json"), "--torch-ckpt",
                     str(d / "model.pth"), "--device", "cpu", "--listen",
                     "127.0.0.1:0", "--slots", "1"]) == 0
    th.join(timeout=30)
    assert not th.is_alive()
    assert [r["frame"] for r in got["rows"]] == [0, 1, 2]
    err = [json.loads(line) for line in capsys.readouterr().err.splitlines()]
    assert err[0] == {"listening": {"host": "127.0.0.1",
                                    "port": created[0].port}}
    assert err[1] == {"ready": True} and "summary" in err[-1]


def test_port_serve_cli_refuses(files, tmp_path, capsys):
    d = files
    base = ["serve", "--config", str(d / "cfg.json"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="exclusive"):
        cli.main(base + ["--torch-ckpt", str(d / "model.pth"), "--input",
                         "x.jsonl", "--listen", "127.0.0.1:0"])
    with pytest.raises(SystemExit, match="crop"):
        cli.main(base + ["--torch-ckpt", str(d / "model.pth"), "--set",
                         "data.test_crop_type=5"])
    # --ckpt, --torch-ckpt and --artifact exclude each other, as do the two
    # extractor flags: argparse errors
    for extra in (["--ckpt", "x"], ["--artifact", "x"],
                  ["--extractor-ckpt", "x", "--extractor-torch-ckpt", "y"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(base + ["--torch-ckpt", str(d / "model.pth"), *extra])
        assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:      # one of them is needed
        cli.main(base)
    assert exc.value.code == 2
    with pytest.raises(SystemExit, match="checkpoint dir not found"):
        cli.main(base + ["--ckpt", str(tmp_path / "none")])
    with pytest.raises(AttributeError):         # a field the port lacks
        cli.main(base + ["--torch-ckpt", str(d / "model.pth"), "--set",
                         "model.use_pallas=true"])
    # the extractor's .pth has no memory head: as the model it is incomplete
    with pytest.raises(KeyError, match="nl_block"):
        cli.main(base + ["--torch-ckpt", str(d / "extractor.pth")])


def test_port_config_names_what_it_ignores(tmp_path, capsys):
    """A JAX config JSON loads in the port; the fields the port lacks but
    JAX would honour are named once on stderr where they differ from JAX's
    defaults, and not at all where they do not."""
    from tmrnet_torch.config import JAX_ONLY_DEFAULTS

    jax_cfg = json.loads(ExperimentConfig().to_json())
    for dotted, default in JAX_ONLY_DEFAULTS.items():
        section, name = dotted.split(".")
        assert jax_cfg[section][name] == default
        assert name not in json.loads(cli.ExperimentConfig().to_json()).get(
            section, {})
    args = lambda path: type("Args", (), {"config": str(path), "set": []})()
    plain = tmp_path / "plain.json"
    plain.write_text(ExperimentConfig().to_json())
    cli.load_config(args(plain))
    assert capsys.readouterr().err == ""
    changed = tmp_path / "changed.json"
    changed.write_text(ExperimentConfig(
        memory=MemoryConfig(window=4, compat_cross_video=True, feature_dim=32),
        model=ModelConfig(**MODEL, use_pallas=True)).to_json())
    cfg = cli.load_config(args(changed))
    assert cfg.memory.window == 4 and cfg.model.hidden_dim == 16
    assert cfg.memory.compat_cross_video       # read by the port, not ignored
    err = [json.loads(line) for line in capsys.readouterr().err.splitlines()]
    assert err == [{"config_ignored": {"memory.feature_dim": 32,
                                       "model.use_pallas": True}}]
