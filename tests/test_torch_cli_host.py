"""The host commands `synth`, `stats` and `pack` through `tmrnet_torch.cli.
main` against `tmrnet_tpu.cli.main` on the same inputs: equal JSON lines
(output paths aside), byte-equal files, statistics within 1e-6 (and equal
to numpy's own over the frames), and the same refusals. None of them, nor
`prepare` and `migrate`, takes `--device`."""

import json
import os

import numpy as np
import pytest

from tmrnet_torch import cli
from tmrnet_torch.data.manifests import load_csv_manifest, load_pickle_manifest
from tmrnet_tpu import cli as jax_cli

from tests.test_torch_cli_test import _Capture

MAINS = {"port": cli.main, "jax": jax_cli.main}


def _run(main, argv, cwd):
    """main(argv) with cwd as the working directory; (rc, stdout)."""
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with _Capture() as cap:
            rc = main([str(a) for a in argv])
        return rc, cap.readouterr().out
    finally:
        os.chdir(old)


def _json(out):
    return json.loads(out.strip().splitlines()[-1])


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.suffix != ".pkl" and p.suffix != ".csv"}


def _both(tmp_path, argv):
    """The same command in tmp/port and tmp/jax (relative paths, so that
    the JSON lines compare as they are); returns {pkg: (rc, out)}."""
    res = {}
    for pkg, main in MAINS.items():
        (tmp_path / pkg).mkdir(exist_ok=True)
        res[pkg] = _run(main, argv, tmp_path / pkg)
    return res


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """`synth` and `manifest --stride 1` of each split run by both
    packages, each in its own directory."""
    d = tmp_path_factory.mktemp("host")
    out = {}
    for pkg, main in MAINS.items():
        (d / pkg).mkdir()
        out[pkg] = _run(main, ["synth", "--out-dir", "ds", "--train", 2,
                               "--val", 1, "--test", 1, "--hw", 20,
                               "--dur-min", 6, "--dur-max", 9, "--seed", 3],
                        d / pkg)
        for split in ("train", "val", "test"):
            rc, _ = _run(main, ["manifest", "--frames", f"ds/frames-{split}",
                                "--annotations", "ds/annotations",
                                "--stride", 1, "--out", f"{split}.pkl"],
                         d / pkg)
            assert rc == 0
        # the train and val videos in one two-split pickle
        tr, _ = load_pickle_manifest(str(d / pkg / "train.pkl"))
        va, _ = load_pickle_manifest(str(d / pkg / "val.pkl"))
        from tmrnet_torch.data.manifests import save_pickle_manifest

        save_pickle_manifest(str(d / pkg / "trainval.pkl"), tr, va)
    return d, out


@pytest.mark.parametrize("task,extra", [
    ("pairs", ["--phases", 6, "--seq", 4, "--dur-min", 5, "--dur-max", 8]),
    ("pairs", []),
    ("multiscale", []),
])
def test_synth_equal(tmp_path, task, extra):
    res = _both(tmp_path, ["synth", "--out-dir", "ds", "--train", 1,
                           "--val", 0, "--test", 2, "--hw", 8, "--seed", 5,
                           "--task", task, *extra])
    assert res["port"][0] == res["jax"][0] == 0
    assert res["port"][1] == res["jax"][1]
    line = _json(res["port"][1])
    assert line["videos"] == 3
    assert sorted(line["out"]) == ["annotations", "test", "train"]
    a, b = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(a) == sorted(b) and a == b
    assert len([k for k in a if k.endswith(".npy")]) == 3


def test_synth_fixture_equal(synth):
    d, out = synth
    assert out["port"] == out["jax"]
    line = _json(out["port"][1])
    assert line["ambiguous_phases"] == [1, 3, 4, 6]
    assert _files(d / "port" / "ds") == _files(d / "jax" / "ds")
    for split in ("train", "val", "test"):
        a, _ = load_pickle_manifest(str(d / "port" / f"{split}.pkl"))
        b, _ = load_pickle_manifest(str(d / "jax" / f"{split}.pkl"))
        assert [v.video_id for v in a.videos] == [v.video_id for v in b.videos]
        np.testing.assert_array_equal(a.flat_labels(), b.flat_labels())
        assert a.flat_paths() == b.flat_paths()


def _frames(d, manifest):
    m, _ = load_pickle_manifest(str(d / manifest))
    from tmrnet_torch.data.pipeline import load_frame

    old = os.getcwd()
    os.chdir(d)
    try:
        return [load_frame(p) for p in m.flat_paths()]
    finally:
        os.chdir(old)


@pytest.mark.parametrize("resize", [True, False])
@pytest.mark.parametrize("population", [True, False])
def test_stats_equal(synth, resize, population):
    d, _ = synth
    argv = ["stats", "--manifest", "train.pkl", "--subsample", 2,
            *([] if resize else ["--no-resize"]),
            *(["--population"] if population else [])]
    got = {pkg: _run(main, argv, d / pkg) for pkg, main in MAINS.items()}
    assert got["port"][0] == got["jax"][0] == 0
    a, b = _json(got["port"][1]), _json(got["jax"][1])
    assert a["frames"] == b["frames"] == len(_frames(d / "port",
                                                     "train.pkl")[::2])
    for k in ("mean", "std"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
    if not resize:
        x = np.stack(_frames(d / "port", "train.pkl")[::2]).astype(
            np.float64) / 255.0
        if population:
            mean, std = x.mean(axis=(0, 1, 2)), x.std(axis=(0, 1, 2))
        else:
            mean = x.mean(axis=(1, 2)).mean(axis=0)
            std = x.std(axis=(1, 2)).mean(axis=0)
        np.testing.assert_allclose(a["mean"], mean, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a["std"], std, rtol=0, atol=1e-6)


def test_stats_workers_and_no_pil(synth, monkeypatch):
    d, _ = synth
    argv = ["stats", "--manifest", "test.pkl", "--no-resize", "--workers"]
    one = _json(_run(cli.main, argv + [1], d / "port")[1])
    many = _json(_run(cli.main, argv + [3], d / "port")[1])
    assert one == many
    # without PIL the reference's resize raises and names --no-resize
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="--no-resize"):
        _run(cli.main, ["stats", "--manifest", "test.pkl", "--workers", 1],
             d / "port")


@pytest.mark.parametrize("src,out", [("trainval.pkl", "p.pkl"),
                                     ("test.pkl", "p.csv")])
def test_pack_repacks_packed_manifests(synth, src, out):
    d, _ = synth
    argv = ["pack", "--manifest", src, "--out-dir", f"re-{out}",
            "--manifest-out", out, "--workers", 2]
    got = {pkg: _run(main, argv, d / pkg) for pkg, main in MAINS.items()}
    assert got["port"][0] == got["jax"][0] == 0
    assert got["port"][1] == got["jax"][1]
    a, b = (_files(d / pkg / f"re-{out}") for pkg in MAINS)
    assert a == b and len(a) == (3 if src == "trainval.pkl" else 1)
    # the packs are synth's own files, byte for byte
    for name, data in a.items():
        split = "test" if src == "test.pkl" else (
            "train" if name in ("1.npy", "2.npy") else "val")
        assert (d / "port" / "ds" / f"frames-{split}" / name).read_bytes() \
            == data
    # the manifests list the same ids, labels and splits
    if out.endswith(".csv"):
        ms = [[load_csv_manifest(str(d / pkg / out))] for pkg in MAINS]
        srcs = [[load_pickle_manifest(str(d / "port" / src))[0]]]
    else:
        ms = [list(load_pickle_manifest(str(d / pkg / out))) for pkg in MAINS]
        srcs = [list(load_pickle_manifest(str(d / "port" / src)))]
    for got_m in ms + srcs:
        assert [[v.video_id for v in m.videos] for m in got_m] == \
            [[v.video_id for v in m.videos] for m in ms[0]]
        for m, m0 in zip(got_m, ms[0]):
            np.testing.assert_array_equal(m.flat_labels(), m0.flat_labels())
    assert [[p.split("#")[1] for p in m.flat_paths()] for m in ms[0]] == \
        [[p.split("#")[1] for p in m.flat_paths()] for m in ms[1]]


def test_pack_image_tree(tmp_path):
    """pack from an image tree (cv2 decodes PNGs here) into a CSV."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(11)
    from tmrnet_torch.data.manifests import (Manifest, VideoRecord,
                                             save_csv_manifest)

    videos = []
    for v in range(2):
        (tmp_path / "img" / f"video{v}").mkdir(parents=True)
        paths = []
        for k in range(3 + v):
            p = tmp_path / "img" / f"video{v}" / f"{k}.png"
            cv2.imwrite(str(p), rng.integers(0, 256, (6, 7, 3),
                                             dtype=np.uint8))
            paths.append(str(p))
        videos.append(VideoRecord(f"video{v}", paths,
                                  np.arange(3 + v) % 3))
    src = Manifest(videos)
    save_csv_manifest(str(tmp_path / "src.csv"), src)
    res = {}
    for pkg, main in MAINS.items():
        res[pkg] = _run(main, ["pack", "--manifest", str(tmp_path / "src.csv"),
                               "--out-dir", str(tmp_path / pkg),
                               "--manifest-out",
                               str(tmp_path / f"{pkg}.csv")], tmp_path)
    assert res["port"][0] == res["jax"][0] == 0
    a, b = _json(res["port"][1]), _json(res["jax"][1])
    assert a.pop("manifest") != b.pop("manifest") and a == b
    assert a["videos"] == 2 and a["frames"] == 7
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    m = load_csv_manifest(str(tmp_path / "port.csv"))
    np.testing.assert_array_equal(m.flat_labels(), src.flat_labels())
    from tmrnet_torch.data.pipeline import load_frame

    for p, q in zip(m.flat_paths(), src.flat_paths()):
        np.testing.assert_array_equal(load_frame(p), load_frame(q))


def test_refusals_equal(synth, tmp_path):
    """Each package in its own fixture directory (the manifests' frame
    paths are relative to it), outputs under tmp_path."""
    d, _ = synth
    tr, _ = load_pickle_manifest(str(d / "port" / "train.pkl"))
    from tmrnet_torch.data.manifests import save_pickle_manifest

    save_pickle_manifest(str(tmp_path / "dup.pkl"), tr, tr)
    cases = [
        # all splits 0
        ["synth", "--out-dir", "{out}/z", "--train", 0, "--val", 0,
         "--test", 0],
        # a two-split pickle to a CSV
        ["pack", "--manifest", "trainval.pkl", "--out-dir", "{out}/c",
         "--manifest-out", "{out}/c.csv"],
        # video ids shared across splits
        ["pack", "--manifest", str(tmp_path / "dup.pkl"), "--out-dir",
         "{out}/p", "--manifest-out", "{out}/p.pkl"],
    ]
    for argv in cases:
        msgs = []
        for pkg, main in MAINS.items():
            (tmp_path / pkg).mkdir(exist_ok=True)
            out = str(tmp_path / pkg)
            with pytest.raises(SystemExit) as e:
                _run(main, [str(a).format(out=out) for a in argv], d / pkg)
            msgs.append(str(e.value.code))
        assert msgs[0] == msgs[1], argv
    for pkg in MAINS:
        assert not (tmp_path / pkg / "c.csv").exists()
        assert not (tmp_path / pkg / "p.pkl").exists()
        assert not (tmp_path / pkg / "z").exists()


@pytest.mark.parametrize("command", ["synth", "pack", "stats", "prepare",
                                     "migrate"])
def test_host_commands_take_no_device(command):
    with pytest.raises(SystemExit) as e:
        with _Capture():
            cli.main([command, "--device", "cpu"])
    assert e.value.code == 2
