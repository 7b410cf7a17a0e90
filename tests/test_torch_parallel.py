"""The port's data-parallel pieces on the CPU, against the JAX package where
it has them: `partition_videos`, `process_local_bounds`,
`gather_video_results` in one process, `ClipLoader(local_rows=)` against
JAX's local-row batches, the mesh's checks and refusals (a failed
rendezvous raises, `data_parallel` must be the world size over
`model_parallel`, the engines refuse a mesh over several
processes, `_mesh_for` an indivisible batch, the in-process N > 1 of
the trainers and of `--artifact`, `serve` under a grid), `doctor --mesh`
against JAX's,
the kernel build's lock
between two processes (a stand-in `nvcc`), and `dryrun_multichip(2)` and
`(3)`."""

import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tmrnet_tpu.data import manifests as jax_manifests
from tmrnet_tpu.data import pipeline as jax_pipeline
from tmrnet_tpu.eval.distributed import partition_videos as jax_partition
from tmrnet_torch import cli
from tmrnet_torch.config import (ExperimentConfig, MeshConfig, ModelConfig,
                                 apply_override)
from tmrnet_torch.data import manifests, pipeline
from tmrnet_torch.eval import distributed
from tmrnet_torch.eval.distributed import (gather_video_results, owners,
                                           partition_videos)
from tmrnet_torch.parallel.mesh import (DataMesh, all_gather_host,
                                        all_reduce_host, initialize_multihost,
                                        make_mesh, process_local_bounds,
                                        require_single_controller, shutdown)

from tests.test_torch_multiprocess_train import free_port

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 7])
def test_partition_videos_equals_jax(parts):
    rng = np.random.default_rng(parts)
    for n in (0, 1, 5, 40):
        lengths = rng.integers(1, 3000, n).tolist()
        lengths[n // 2:n // 2 + 2] = [1500, 1500][:min(2, n - n // 2)]
        got = partition_videos(lengths, parts)
        assert got == jax_partition(lengths, parts)
        assert sorted(i for p in got for i in p) == list(range(n))
        owner = owners(got, n)
        assert all(i in got[owner[i]] for i in range(n))
    with pytest.raises(ValueError):
        partition_videos([3], 0)


@pytest.mark.parametrize("batch,world", [(8, 1), (8, 2), (12, 3), (40, 8)])
def test_process_local_bounds(batch, world):
    spans = [process_local_bounds(batch, r, world) for r in range(world)]
    assert spans == [(r * batch // world, (r + 1) * batch // world)
                     for r in range(world)]
    with pytest.raises(ValueError, match="does not divide"):
        process_local_bounds(2 * batch + 1, 0, max(world, 2))


def test_gather_video_results_in_one_process():
    """Without a mesh over several processes the results come back as
    given, in video order, a video shorter than a clip empty."""
    rng = np.random.default_rng(0)
    lengths, seq, ncls = [7, 3, 12], 4, 5
    local = {i: (rng.integers(0, ncls, max(0, n - seq + 1)),
                 rng.random((max(0, n - seq + 1), ncls)).astype(np.float32))
             for i, n in enumerate(lengths)}
    got = gather_video_results(local, [0, 0, 0], lengths, seq, ncls)
    for i, (p, s) in enumerate(got):
        assert p.dtype == np.int64 and s.dtype == np.float32
        np.testing.assert_array_equal(p, local[i][0])
        np.testing.assert_array_equal(s, local[i][1])
    assert got[1][0].shape == (0,) and got[1][1].shape == (0, ncls)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    d = tmp_path_factory.mktemp("local_rows")
    rng = np.random.default_rng(5)
    out = []
    for mod, pipe in ((manifests, pipeline), (jax_manifests, jax_pipeline)):
        videos = []
        for v, n in enumerate((9, 6, 4)):
            path = d / f"v{v}.npy"
            if not path.exists():
                np.save(path, rng.integers(0, 256, (n, 8, 8, 3),
                                           dtype=np.uint8))
            videos.append(mod.VideoRecord(
                f"v{v}", [f"{path}#{t}" for t in range(n)],
                (np.arange(n) % 3).astype(np.int64)))
        out.append(pipe.ClipDataset(mod.Manifest(videos), 3))
    return out


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_local_rows_equal_jax(datasets, shuffle):
    """Every process's local rows of every batch (4 clips over 2 ranks,
    the last batch padded, its repeats labelled -1) equal JAX's loader's
    and the slices of the full batch."""
    ours, theirs = datasets
    assert ours.num_clips == 13
    full = list(pipeline.ClipLoader(ours, 4, shuffle=shuffle, seed=3,
                                    num_workers=2).epoch(1))
    for lo, hi in ((0, 2), (2, 4)):
        got = list(pipeline.ClipLoader(ours, 4, shuffle=shuffle, seed=3,
                                       num_workers=2,
                                       local_rows=(lo, hi)).epoch(1))
        want = list(jax_pipeline.ClipLoader(theirs, 4, shuffle=shuffle,
                                            seed=3, num_workers=2,
                                            local_rows=(lo, hi)).epoch(1))
        assert len(got) == len(want) == len(full) == 4
        for g, w, f in zip(got, want, full):
            for a, b in zip(g[:3], w[:3]):
                np.testing.assert_array_equal(a, b)
            assert g[3] == w[3] == f[3]
            np.testing.assert_array_equal(g[0], f[0][lo:hi])
            np.testing.assert_array_equal(g[1], f[1][lo:hi])
            np.testing.assert_array_equal(g[2], f[2])
        assert got[-1][3] == 3 and (got[-1][1] == -1).sum() == hi - max(lo, 1)


def test_one_process_group_mesh_and_collectives():
    """A one-rank gloo group over tcp://: make_mesh checks
    mesh.data_parallel against the world size, the host collectives and
    the data mesh work at world size 1, initialize_multihost is a no-op
    once the group is up, and an engine takes a one-process mesh."""
    from tmrnet_torch.eval.infer import VideoInference
    from tmrnet_torch.models.tmrnet import init_state_dict

    dev = initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                               device="cpu", timeout=30)
    try:
        assert dev == torch.device("cpu")
        mesh = make_mesh(MeshConfig(data_parallel=1), "cpu")
        assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, "gloo")
        assert mesh.cpu_group is mesh.group
        with pytest.raises(ValueError, match="needs 2 processes, have 1"):
            make_mesh(MeshConfig(data_parallel=2), "cpu")
        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        np.testing.assert_array_equal(all_gather_host(a, mesh), a[None])
        np.testing.assert_array_equal(
            all_gather_host(a > 2, mesh), (a > 2)[None])
        np.testing.assert_array_equal(all_reduce_host(a, mesh, "max"), a)
        assert initialize_multihost(device="cpu") == dev
        cfg = ModelConfig(backbone="tiny", stage_sizes=(1, 1), width=8,
                          hidden_dim=16, compute_dtype="float32")
        state = init_state_dict(cfg, 0)
        extractor = {k: v for k, v in state.items()
                     if k.startswith(("backbone.", "encoder."))}
        engine = VideoInference(ExperimentConfig(model=cfg), state,
                                extractor, mesh=mesh)
        assert engine.device == torch.device("cpu")
    finally:
        shutdown()
    assert not torch.distributed.is_initialized()


def test_rendezvous_failures_raise():
    """No hidden fallback: torchrun's environment missing, a coordinator
    nobody serves, half-given rendezvous flags, a card that is not there,
    and a mesh without a group all raise; none leaves a group up."""
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE",
                                          "MASTER_ADDR", "MASTER_PORT")
           if k in os.environ}
    try:
        with pytest.raises((ValueError, RuntimeError)):
            initialize_multihost(device="cpu", timeout=5)
    finally:
        os.environ.update(env)
    with pytest.raises(Exception, match="(?i)time|connect|refused"):
        initialize_multihost(f"127.0.0.1:{free_port()}", 2, 1, device="cpu",
                             timeout=2)
    with pytest.raises(ValueError, match="go together"):
        initialize_multihost("127.0.0.1:1", None, 0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh()
    assert not torch.distributed.is_initialized()


def test_refusals_of_what_is_not_ported(monkeypatch):
    """The engines refuse a mesh over several processes; _mesh_for exits on
    a global batch that does not divide over the ranks; in one process,
    mesh.data_parallel=N > 1 (the in-process shards) is refused by name by
    the trainers and by `stream` and `serve` with --artifact, and
    mesh.model_parallel > 1 without mesh.multihost by every command,
    `serve` included, which also refuses mesh.multihost by name."""
    from tmrnet_torch.eval.infer import ClipInference
    from tmrnet_torch.eval.stream import StreamingInference

    two = DataMesh(None, None, 0, 2, torch.device("cpu"))
    require_single_controller(DataMesh(None, None, 0, 1,
                                       torch.device("cpu")), "x")
    for make in (lambda: ClipInference(ExperimentConfig(), {}, mesh=two),
                 lambda: StreamingInference(ExperimentConfig(), {}, {},
                                            mesh=two)):
        with pytest.raises(ValueError, match="over 2 processes"):
            make()
    cfg = apply_override(apply_override(ExperimentConfig(),
                                        "mesh.multihost=true"),
                         "data.batch_clips=3")
    args = type("Args", (), {"device": "cpu"})()
    ranks = types.SimpleNamespace(rank=0, world=2, backend="gloo",
                                  device=torch.device("cpu"), data_index=0,
                                  model_index=0, dp=2,
                                  shape={"data": 2, "model": 1})
    monkeypatch.setattr(distributed, "local_eval_mesh",
                        lambda cfg, device: ranks)
    with pytest.raises(SystemExit, match="divisible by the 2"):
        cli._mesh_for(cfg, args)
    assert cli._mesh_for(cfg, args, batch=0) == (ranks.device, ranks)
    sp = apply_override(ExperimentConfig(), "mesh.data_parallel=2")
    for argv in (["train-bank", "--train-manifest", "m.pkl"],
                 ["train-tmr", "--train-manifest", "m.pkl", "--lfb",
                  "b.npz"]):
        with pytest.raises(SystemExit, match="shards the work of"):
            cli.main(argv + ["--device", "cpu", "--set",
                             "mesh.data_parallel=2"])
    for argv in (["stream", "--manifest", "m.pkl", "--artifact", "a.pt2",
                  "--out", "s.jsonl"],
                 ["serve", "--artifact", "a.pt2"]):
        with pytest.raises(SystemExit, match="--artifact runs on the one"):
            cli.main(argv + ["--device", "cpu", "--set",
                             "mesh.data_parallel=2"])
    for sets, match in ((["mesh.model_parallel=2"], "mesh.multihost=true"),
                        (["mesh.multihost=true"], "serve runs in one")):
        with pytest.raises(SystemExit, match=match):
            cli.main(["serve", "--torch-ckpt", "t.pth", "--device", "cpu"]
                     + [a for s in sets for a in ("--set", s)])
    assert cli._sp_devices(sp, args, "test") == [torch.device("cpu")] * 2
    # N above the visible cards exits (one card, as it would be seen)
    import tmrnet_torch.device

    monkeypatch.setattr(tmrnet_torch.device, "resolve_device",
                        lambda d: torch.device(d))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = type("Args", (), {"device": "cuda"})()
    with pytest.raises(SystemExit, match="1 are visible"):
        cli._sp_devices(sp, cuda, "test")
    with pytest.raises(SystemExit, match="mesh.multihost=true"):
        cli._mesh_for(apply_override(ExperimentConfig(),
                                     "mesh.model_parallel=2"), args)


def test_doctor_mesh_and_smoke(capsys):
    """The port's counterpart of JAX's `test_doctor_mesh_and_smoke`: `doctor
    --mesh --smoke` with a 4 x 2 grid prints the grid as JAX does and
    exits 0 (on the CPU: the grid needs its processes, which `doctor`
    names)."""
    assert cli.main(["doctor", "--mesh", "--smoke", "--device", "cpu",
                     "--set", "mesh.data_parallel=4",
                     "--set", "mesh.model_parallel=2"]) == 0
    out = capsys.readouterr().out
    assert "'data': 4" in out and "'model': 2" in out
    assert "8 processes" in out and "FAIL" not in out
    assert cli.main(["doctor", "--mesh", "--device", "cpu", "--set",
                     "mesh.data_parallel=2"]) == 0
    assert "sequence-parallel pass" in capsys.readouterr().out


def test_kernel_build_is_locked_between_processes(tmp_path):
    """Two processes that build the same kernel library at once (ranks
    sharing a checkout): one compiler run, both load the library. A
    stand-in nvcc logs its runs and links an empty shared library."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ "$#" -gt 0 ]; do [ "$1" = -o ] && out="$2"; shift; done\n'
        f"echo run >> {log}\nsleep 1\n"
        'cc -shared -fPIC -x c /dev/null -o "$out"\n')
    nvcc.chmod(0o755)
    code = ("import pathlib, sys; import tmrnet_torch.kernels.build as b; "
            "b.BUILD_DIR = pathlib.Path(sys.argv[1]); "
            "b.build_all(['nl_attention']); print('loaded')")
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"))
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "build")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=60)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert all("loaded" in o for o in outs)
    assert log.read_text().count("run") == 1
    assert len(list((tmp_path / "build").glob("libnl_attention_*.so"))) == 1


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip(n, capfd):
    """n gloo ranks: one data-parallel stage-2 step of the flagship
    ResNet-50 TMRNet (64x64, f32) and a distributed corpus pass; every
    rank prints the same loss, which equals one process's."""
    from tmrnet_torch.entry import dryrun_multichip

    loss = dryrun_multichip(n)
    out = capfd.readouterr().out
    losses = [ln.split("loss ")[1] for ln in out.splitlines()
              if ln.startswith("rank ") and ": loss " in ln]
    assert len(losses) == n and len(set(losses)) == 1
    assert float(losses[0]) == loss and np.isfinite(loss)
    assert "one process: loss" in out
