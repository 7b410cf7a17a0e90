"""Tensor parallelism on the CPU, against one process and against JAX.

- The parameters the port slices over a model axis, mapped through the
  weight bridge, are those JAX's `param_shardings` shards, along the same
  logical dimensions (conftest's 8 CPU devices), replicated where a
  dimension does not divide.
- `time_conv`'s column slice: the plain version's slice equals the slice
  of the whole call, forward and backward; csrc/time_conv.cu's index
  arithmetic over a slice (numpy) equals it; the op `tmrnet::time_conv_
  slice` takes the plain version on the CPU and the kernel's checks on
  fake CUDA tensors.
- Four gloo ranks as a 2 x 2 grid (`parallel/mesh.py`, model groups of 2):
  the model group's collectives equal the unsharded forward and backward;
  every case of `test_torch_multiprocess_train.py` (both stages, both loss
  reductions, grad_accum, the global-norm clip, dropout) equals the port's
  one-process step within 1e-5, with the replicated parameters bit-equal
  across each model group; a step from JAX's weights equals JAX's
  `shard_state` dp 2 x tp 2 step within its own dp x tp tolerances; a
  grid's `train_stage1` checkpoint holds whole tensors that one process
  loads, and a resume under the grid continues it as one process's
  run does.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tmrnet_torch.config import (DataConfig, ModelConfig, TrainConfig)
from tmrnet_torch.models.tmrnet import build_model, init_state_dict, state_shapes
from tmrnet_torch.ops.time_conv import (TimeConvPlan, plan_time_conv,
                                        time_conv, time_conv_plain,
                                        time_conv_slice_op)
from tmrnet_torch.parallel.tensor import flax_path, sharded_dims

from tests.test_torch_head_plan import rehearse
from tests.test_torch_multiprocess_train import (B, CASES, CLASS_WEIGHTS,
                                                 MODEL, ROOT, TRAIN,
                                                 fit, free_port,
                                                 global_batch, result_of,
                                                 run_case, write_videos)

torch.set_num_threads(2)

WORLD, MP = 4, 2
CHILD_TIMEOUT = 180
# JAX's test_dp_tp_train_step_runs_and_matches: the loss; the parameters
# within the tolerances of its dp step test.
JAX_LOSS_RTOL, JAX_RTOL, JAX_ATOL = 5e-4, 2e-4, 1e-5


# -- the sharded-parameter map against JAX -----------------------------------

def _jax_sharded(head, hidden, dp, mp):
    """{(flax path, dimension)} that JAX's param_shardings shards."""
    from tmrnet_tpu.config import MeshConfig as JaxMeshConfig
    from tmrnet_tpu.config import ModelConfig as JaxModelConfig
    from tmrnet_tpu.models.tmrnet import build_model as jax_build_model
    from tmrnet_tpu.parallel.mesh import make_mesh, param_shardings

    model = jax_build_model(JaxModelConfig(**dict(MODEL, head=head,
                                                  hidden_dim=hidden)))
    clips = jnp.zeros((2, 3, 32, 32, 3), jnp.float32)
    args = (clips,) if head == "stage1" else (
        clips, jnp.zeros((2, 4, hidden), jnp.float32))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    mesh = make_mesh(JaxMeshConfig(data_parallel=dp, model_parallel=mp))
    flat = jax.tree_util.tree_flatten_with_path(
        param_shardings(mesh, shapes["params"]))[0]
    out = set()
    for path, sh in flat:
        spec = tuple(sh.spec)
        if "model" in spec:
            out.add(("/".join(str(k.key) for k in path), spec.index("model")))
    return out


@pytest.mark.parametrize("head,hidden,dp,mp", [
    ("tmr", 16, 4, 2), ("stage1", 16, 4, 2), ("nl_only", 16, 4, 2),
    ("tmr", 18, 2, 4)])
def test_sharded_map_equals_jax_param_shardings(head, hidden, dp, mp):
    """At hidden 18 over 4 the head's layers stay replicated (18 % 4) and
    the LSTM's input projection (64 features) is sliced."""
    cfg = ModelConfig(**dict(MODEL, head=head, hidden_dim=hidden))
    shapes = state_shapes(cfg)
    got = set()
    for name, dim in sharded_dims(shapes, mp).items():
        path, perm = flax_path(name, len(shapes[name]))
        got.add((path, dim if perm is None else perm[dim]))
    want = _jax_sharded(head, hidden, dp, mp)
    assert got == want
    assert got, "nothing sharded"
    if hidden % mp:
        assert got == {("encoder/lstm/weight_ih", 1)}
    assert sharded_dims(shapes, 1) == {}


# -- time_conv's column slice ------------------------------------------------

def _tc_operands(rng, b, w, c, dtype=torch.float32):
    x = torch.from_numpy(rng.standard_normal((b, w, c)).astype(np.float32))
    ws = []
    for k in (3, 5, 7):
        ws.append(torch.from_numpy((rng.standard_normal((k, c, c))
                                    / np.sqrt(k * c)).astype(np.float32)))
        ws.append(torch.from_numpy((rng.standard_normal(c) * 0.1)
                                   .astype(np.float32)))
    return x.to(dtype), [t.to(dtype) if t.dim() == 3 else t for t in ws]


def _slice(ws, c0, cout):
    return [t[..., c0:c0 + cout].contiguous() if t.dim() == 3
            else t[c0:c0 + cout].contiguous() for t in ws]


@pytest.mark.parametrize("c,m", [(64, 2), (128, 4), (12, 3)])
def test_time_conv_slice_equals_the_slice_of_the_whole_call(c, m):
    """Forward and backward: each of the M slices of the plain version
    (through `time_conv`'s autograd Function) equals the slice of the
    whole call, and its gradients the whole call's restricted to the slice
    (x's gradient summed over the slices)."""
    rng = np.random.default_rng(c + m)
    x, ws = _tc_operands(rng, 3, 9, c)
    g = torch.from_numpy(rng.standard_normal((3, 9, c)).astype(np.float32))
    xw = x.clone().requires_grad_(True)
    wsw = [t.clone().requires_grad_(True) for t in ws]
    whole = time_conv(xw, *wsw)
    (whole * g).sum().backward()
    cout = c // m
    x_grad = torch.zeros_like(x)
    for i in range(m):
        c0 = i * cout
        xs = x.clone().requires_grad_(True)
        wss = [t.requires_grad_(True) for t in _slice(ws, c0, cout)]
        out = time_conv(xs, *wss, c0=c0)
        assert out.shape == (3, 9, cout)
        torch.testing.assert_close(out, whole.detach()[..., c0:c0 + cout],
                                   rtol=1e-6, atol=1e-6)
        (out * g[..., c0:c0 + cout]).sum().backward()
        x_grad += xs.grad
        for t, tw in zip(wss, wsw):
            want = (tw.grad[..., c0:c0 + cout] if t.dim() == 3
                    else tw.grad[c0:c0 + cout])
            torch.testing.assert_close(t.grad, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(x_grad, xw.grad, rtol=1e-5, atol=1e-6)
    # the op, with grad off, is the plain version
    torch.testing.assert_close(time_conv_slice_op(x, *_slice(ws, cout, cout),
                                                  cout),
                               time_conv_plain(x, *_slice(ws, cout, cout),
                                               c0=cout), rtol=0, atol=0)


@pytest.mark.parametrize("shape,cout,c0,plan", [
    ((3, 7, 128), 64, 64, None), ((2, 45, 256), 128, 128, None),
    ((2, 30, 512), 256, 256, None), ((1, 70, 512), 128, 384, None),
    ((3, 11, 192), 64, 128, TimeConvPlan(192, 64, 64)),
    ((2, 40, 256), 64, 192, TimeConvPlan(256, 128, 128))])
def test_time_conv_slice_index_rehearsal_matches_plain(shape, cout, c0, plan):
    """csrc/time_conv.cu's arithmetic over a column slice (weight rows
    Cout apart, the causal branch read from x's channel c0 + n, a grid of
    Cout / 64 columns), plans with x staged once and in two buffers."""
    b, w, c = shape
    plan = plan or plan_time_conv(b, w, c)
    rng = np.random.default_rng(b * w + c + c0)
    x, ws = _tc_operands(rng, b, w, c)
    sl = _slice(ws, c0, cout)
    got = rehearse(x.numpy(), [t.numpy() for t in sl[::2]],
                   [t.numpy() for t in sl[1::2]], plan, c0)
    want = time_conv_plain(x, *sl, c0=c0).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_time_conv_slice_op_checks():
    """opcheck of the slice op; fake CUDA operands take the kernel's
    checks (a slice off the 64-column tiles, or past C, is refused)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.default_rng(3)
    x, ws = _tc_operands(rng, 2, 6, 128, torch.bfloat16)
    sl = _slice(ws, 64, 64)
    torch.library.opcheck(time_conv_slice_op, (x, *sl, 64))
    with FakeTensorMode():
        fake = lambda t: torch.empty(t.shape, dtype=t.dtype, device="cuda")
        fx, fsl = fake(x), [fake(t) for t in sl]
        out = time_conv_slice_op(fx, *fsl, 64)
        assert out.shape == (2, 6, 64) and out.device.type == "cuda"
        for c0 in (32, 128):
            with pytest.raises(ValueError, match="column slice"):
                time_conv_slice_op(fx, *fsl, c0)


# -- a 2 x 2 grid of gloo ranks ----------------------------------------------

JAX_HEADS = ("tmr", "stage1")


def _grid_child(rank, world, port, mp, out_dir):
    """One rank of the grid: every case's steps, the collectives, the steps
    from JAX's weights, then train_stage1 and its resume; all saved."""
    from tmrnet_torch.config import MeshConfig
    from tmrnet_torch.parallel.mesh import (initialize_multihost, make_mesh,
                                            shutdown)

    rank, world, mp = int(rank), int(world), int(mp)
    torch.set_num_threads(1)
    dev = initialize_multihost(f"127.0.0.1:{port}", world, rank,
                               device="cpu", timeout=60)
    mesh = make_mesh(MeshConfig(model_parallel=mp), dev)
    out = {"steps": {name: run_case(name, mesh) for name in CASES},
           "collectives": _collectives(mesh),
           "jax": {h: _jax_weights_step(h, out_dir, mesh)
                   for h in JAX_HEADS},
           "index": (mesh.data_index, mesh.model_index)}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    with open(os.path.join(out_dir, "videos.json")) as f:
        videos = json.load(f)
    fits = []
    for epochs in (1, 2):
        state, hist = fit(videos, os.path.join(out_dir, "ck"), epochs, mesh)
        fits.append({"step": state.step, "hist": [
            [h.epoch, h.train_loss, h.train_acc, h.val_loss, h.val_acc, h.lr]
            for h in hist]})
    print("RESULT " + json.dumps(fits), flush=True)
    shutdown()


def _collective_inputs():
    rng = np.random.default_rng(11)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return t(3, 8), t(6, 8), t(6), t(3, 6), t(5, 6), t(5), t(3, 5)


def _unsharded_collectives():
    """The layers the collectives make, unsharded: a column-parallel
    linear (8 -> 6) and a row-parallel one (6 -> 5), with the gradients
    of a seeded weighting of their outputs."""
    x, w1, b1, gy1, w2, b2, gy2 = _collective_inputs()
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    x, w1, b1, w2, b2 = leaves
    y1 = F.linear(x, w1, b1)
    y2 = F.linear(y1, w2, b2)
    ((y1 * gy1).sum() + (y2 * gy2).sum()).backward()
    return [y1.detach(), y2.detach()] + [t.grad for t in leaves]


def _collectives(mesh):
    """The same layers over the model group: column-parallel through
    copy_in, the bias's split and the gather; row-parallel on the
    column slice through sum_partials; the sliced weights' gradients
    gathered whole."""
    from tmrnet_torch.parallel import tensor as tp

    x, w1, b1, gy1, w2, b2, gy2 = _collective_inputs()
    shard = tp.Shard(0, mesh.model_index, mesh.model_parallel,
                     mesh.model_group)
    lo, hi = shard.bounds(6)
    x = x.requires_grad_(True)
    w1s = w1[lo:hi].clone().requires_grad_(True)
    b1 = b1.requires_grad_(True)
    w2s = w2[:, lo:hi].clone().requires_grad_(True)
    b2 = b2.requires_grad_(True)
    y1s = F.linear(tp.copy_in(x, shard), w1s, tp.split(b1, shard))
    y1 = tp.gather(y1s, shard)
    y2 = tp.sum_partials(F.linear(y1s, w2s), shard) + b2
    ((y1 * gy1).sum() + (y2 * gy2).sum()).backward()
    wshard = tp.Shard(1, mesh.model_index, mesh.model_parallel,
                      mesh.model_group)
    return [y1.detach(), y2.detach(), x.grad,
            tp._gather_along(w1s.grad, shard, 0), b1.grad,
            tp._gather_along(w2s.grad, wshard, 1), b2.grad]


def _jax_weights_step(head, out_dir, mesh=None):
    """One SGD step of the port from JAX's initial weights (saved by the
    parent) over global_batch(41): (the loss summed over the data ranks,
    the whole state dict)."""
    from tmrnet_torch.data.device_feed import DevicePrep
    from tmrnet_torch.parallel.mesh import (all_reduce_host,
                                            process_local_bounds)
    from tmrnet_torch.parallel.tensor import shard_model_
    from tmrnet_torch.train.optim import make_optimizer, slow_modules_for_head
    from tmrnet_torch.train.state import TrainState
    from tmrnet_torch.train.steps import make_stage1_steps, make_stage2_steps

    model = build_model(ModelConfig(**dict(MODEL, head=head)), device="cpu")
    model.load_state_dict(torch.load(os.path.join(out_dir,
                                                  f"jax_{head}.pt")))
    shard_model_(model, mesh)
    state = TrainState(model, make_optimizer(TrainConfig(**TRAIN), model,
                                             slow_modules_for_head(head)),
                       mesh=mesh)
    make = make_stage1_steps if head == "stage1" else make_stage2_steps
    step, _ = make(CLASS_WEIGHTS, prep=DevicePrep(
        DataConfig(device_normalize=True), "float32", "cpu"), mesh=mesh)
    args, labels = global_batch(41, head)
    lo, hi = (0, B) if mesh is None else process_local_bounds(
        B, mesh.data_index, mesh.dp)
    m = step(state, *(a[lo:hi] for a in args), labels[lo:hi],
             torch.Generator().manual_seed(0))
    loss = np.asarray([float(m["loss"])])
    if mesh is not None:
        loss = all_reduce_host(loss, mesh, data_only=True)
    return float(loss[0]), {k: v.clone()
                            for k, v in state.whole_state()[0].items()}


def _jax_init(head):
    from tmrnet_tpu.config import ModelConfig as JaxModelConfig
    from tmrnet_tpu.models.tmrnet import build_model as jax_build_model

    args, _ = global_batch(41, head)
    model = jax_build_model(JaxModelConfig(**dict(MODEL, head=head)))
    jargs = tuple(jnp.asarray(a.numpy(), jnp.float32) for a in args)
    return model, jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(5), *jargs))


def _jax_grid_step(head, model, variables):
    """JAX's shard_state dp 2 x tp 2 step over the same batch: (loss, the
    new variables through the weight bridge)."""
    from tmrnet_torch.models.convert import from_jax_variables
    from tmrnet_tpu.config import DataConfig as JaxDataConfig
    from tmrnet_tpu.config import MeshConfig as JaxMeshConfig
    from tmrnet_tpu.config import TrainConfig as JaxTrainConfig
    from tmrnet_tpu.data.device_feed import DevicePrep as JaxDevicePrep
    from tmrnet_tpu.parallel.mesh import make_mesh, shard_batch, shard_state
    from tmrnet_tpu.train.optim import make_optimizer as jax_make_optimizer
    from tmrnet_tpu.train.optim import slow_modules_for_head as jax_slow
    from tmrnet_tpu.train.state import create_train_state
    from tmrnet_tpu.train.steps import make_stage1_steps as jax_stage1
    from tmrnet_tpu.train.steps import make_stage2_steps as jax_stage2

    args, labels = global_batch(41, head)
    state = create_train_state(model, variables, jax_make_optimizer(
        JaxTrainConfig(**TRAIN), variables["params"], jax_slow(head)))
    mesh = make_mesh(JaxMeshConfig(data_parallel=2, model_parallel=MP),
                     devices=jax.devices()[:2 * MP])
    state = shard_state(mesh, state)
    make = jax_stage1 if head == "stage1" else jax_stage2
    step, _ = make(class_weights=CLASS_WEIGHTS, donate=False,
                   prep=JaxDevicePrep(JaxDataConfig(device_normalize=True),
                                      "float32"))
    state, m = step(state, *(shard_batch(mesh, jnp.asarray(a.numpy()))
                             for a in args),
                    shard_batch(mesh, jnp.asarray(labels.numpy())),
                    jax.random.PRNGKey(0))
    return float(m["loss"]), from_jax_variables(
        jax.tree_util.tree_map(np.asarray, state.variables))


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The 2 x 2 grid's ranks, run once for the module; while they run,
    the one-process references (the port's steps, JAX's dp x tp steps and
    train_stage1)."""
    from tmrnet_torch.models.convert import from_jax_variables

    out = tmp_path_factory.mktemp("grid")
    models = {}
    for head in JAX_HEADS:
        models[head] = _jax_init(head)
        torch.save(from_jax_variables(models[head][1]),
                   out / f"jax_{head}.pt")
    videos = write_videos(str(out))
    (out / "videos.json").write_text(json.dumps(videos))
    code = ("import sys; sys.path[:0] = sys.argv[1:3]; "
            "import test_torch_tensor_parallel as t; "
            "t._grid_child(*sys.argv[3:])")
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), str(ROOT / "tests"), str(r),
         str(WORLD), str(port), str(MP), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(WORLD)]
    try:
        refs = {"jax": {h: _jax_grid_step(h, *models[h]) for h in JAX_HEADS},
                "port_jax": {h: _jax_weights_step(h, str(out))
                             for h in JAX_HEADS},
                "collectives": _unsharded_collectives()}
        _, refs["fit"] = fit(videos, out / "one", 2)
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{o}"
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]
    return {"ranks": ranks, "fits": [result_of(o) for o in outs],
            "refs": refs, "dir": out}


def test_grid_ranks_and_collectives(grid):
    """Rank r sits at data index r // 2 and model index r % 2; the
    collectives' outputs and gradients equal the unsharded layers' on
    every rank."""
    assert [r["index"] for r in grid["ranks"]] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]
    want = grid["refs"]["collectives"]
    for r in grid["ranks"]:
        for got, w in zip(r["collectives"], want):
            torch.testing.assert_close(got, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_grid_step_equals_one_process(grid, name):
    """Each case's losses and whole weights on every rank within 1e-5 of
    one process's (rtol and atol; where the one-process f32 step itself is
    further than that from f64, within twice that distance, as the
    two-rank test rules); replicated weights bit-equal across each model
    group, and the whole weights the same on every rank."""
    losses, want = run_case(name)
    exact = {}
    ranks = grid["ranks"]
    for r, rank in enumerate(ranks):
        got_losses, got = rank["steps"][name]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5, atol=1e-6,
                                   err_msg=f"rank {r}")
        for k, v in want.items():
            g, w = got[k].double().numpy(), v.double().numpy()
            if np.allclose(g, w, rtol=1e-5, atol=1e-5):
                continue
            if not exact:
                exact.update(run_case(name, dtype=torch.float64)[1])
            floor = float(np.abs(w - exact[k].double().numpy()).max())
            assert floor > 1e-5 and np.abs(g - w).max() <= 2 * floor, (
                f"rank {r} {k}: {np.abs(g - w).max()} from one process, "
                f"which is {floor} from f64")
    for k in want:
        for r in range(1, WORLD):
            assert torch.equal(ranks[0]["steps"][name][1][k],
                               ranks[r]["steps"][name][1][k]), (k, r)


@pytest.mark.parametrize("head", JAX_HEADS)
def test_grid_step_equals_jax_dp_tp_step(grid, head):
    """From JAX's initial weights, the grid's step against JAX's
    shard_state dp 2 x tp 2 step: the loss within 5e-4 relative, each
    parameter within rtol 2e-4 / atol 1e-5 (the running statistics as the
    one-process JAX test holds them, rtol 2e-3 / atol 1e-5); and against
    the port's own one-process step within 1e-5."""
    want_loss, want = grid["refs"]["jax"][head]
    one_loss, one = grid["refs"]["port_jax"][head]
    for rank in grid["ranks"]:
        loss, got = rank["jax"][head]
        assert loss == pytest.approx(want_loss, rel=JAX_LOSS_RTOL)
        assert loss == pytest.approx(one_loss, rel=1e-5)
        for k, v in got.items():
            if k.endswith("num_batches_tracked"):
                continue
            tol = (dict(rtol=2e-3, atol=1e-5) if "running" in k
                   else dict(rtol=JAX_RTOL, atol=JAX_ATOL))
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                       err_msg=k, **tol)
            np.testing.assert_allclose(v.numpy(), one[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_grid_checkpoint_loads_in_one_process_and_resumes(grid):
    """train_stage1 over the grid for an epoch, then again to 2 epochs:
    every rank reports one process's epoch statistics, the second run
    resumes after the first's checkpoint, and the checkpoint (rank 0's)
    holds whole tensors that a one-process model loads (strict) and
    whose weights equal one process's after the same 2 epochs."""
    from tmrnet_torch.models.convert import from_jax_variables
    from tmrnet_torch.utils.checkpoint import CheckpointManager

    fits = grid["fits"]
    assert all(f == fits[0] for f in fits)
    first, second = fits[0]
    assert [h[0] for h in first["hist"]] == [0] and first["step"] == 13
    assert [h[0] for h in second["hist"]] == [1], "not a resume"
    assert second["step"] == 26
    for got, h in zip(first["hist"] + second["hist"], grid["refs"]["fit"]):
        epoch, tr_loss, tr_acc, va_loss, va_acc, lr = got
        assert epoch == h.epoch and lr == h.lr
        assert tr_acc == h.train_acc and va_acc == h.val_acc
        np.testing.assert_allclose([tr_loss, va_loss],
                                   [h.train_loss, h.val_loss], rtol=1e-5)
    ck = CheckpointManager(str(grid["dir"] / "ck"))
    assert ck.all_steps() == [13, 26]
    saved = CheckpointManager._load(ck._step_dir(26))
    cfg = ModelConfig(**dict(MODEL, head="stage1", dropout_stage1=0.2))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(saved["variables"]),
                          strict=True)
    one = CheckpointManager(str(grid["dir"] / "one"))
    want = from_jax_variables(CheckpointManager._load(
        one._step_dir(26))["variables"])
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # the momentum of the sliced weight_ih is whole too
    slots = saved["train"]["optimizer"]["state"]
    shapes = sorted(tuple(s["momentum_buffer"].shape) for s in
                    slots.values())
    assert (64, 64) in shapes and not any(s == (64, 32) for s in shapes)
