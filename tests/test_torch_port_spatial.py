"""Spatial sharding of the port (``parallel/spatial.py``, the runner's
spatial axis, ``--num_spatial_shards``) against one process and against
the JAX package's step on a spatial mesh.

``gloo`` processes start through the launcher's contract
(``DVIE_MULTIHOST=1``, ``DVIE_COORDINATOR`` on a free port,
``DVIE_NUM_PROCS``, ``DVIE_PROC_ID``), each with its own time limit
(``communicate(timeout=...)``), so a rendezvous or a collective that hangs
fails here, not at the suite's limit.

- A pair of ranks (S = 2) runs each primitive on its band against the same
  function on the whole tensor, in f32: the 3x3 conv at stride 1 and 2, a
  dilated 5x5, the bilinear x2 and x4, the shifted add, the SSIM blur and
  value, GDL, the L1 and cross-entropy means and the VGG19 to relu5_4,
  each output and input gradient within 1e-6 relative of the whole one's
  band (max |d| over max |ref|; a loss by the sum of the bands' shares);
  and the halo exchange's adjoint by a dot-product test, in f64.
- The same pair runs recipe 1 (``INTER --model InterNet --train_coarse``)
  at B=2, 32x64, f32, through the runner's producer, one step on its band,
  with ``--vgg_w 0`` and with the VGG19 on, and the image panel of that
  batch, gathered to rank 0; then the launcher (``cli.main.run``): an
  epoch, the checkpoint rank 0 writes, and ``--split val`` on it.
- Four ranks (D=2 x S=2) run one step of recipe 1 at B=4.

Each step is held to the one-process step of the plain model (the route a
spatial step takes, as JAX's under a spatial mesh) on one thread: the loss
terms within 1e-5 relative; the ranks' parameters, gradients and buffers
after the step equal, and the parameters against one process as
``tests/test_torch_port_ddp.py`` holds them (99.9% within 1e-3 lr, all
within 2 lr); the gradient within 1e-5 rel-L2 in a float64 run of the same
step (the model's compute dtype float64, the plain versions' f32
accumulation f64): in f32 the step's gradient is not fixed to 1e-5 by its
arithmetic, since GDL's signs, SSIM's near-zero denominators and the
lrelu masks amplify last-bit differences (the one-process step itself
moves by 1.9e-5 rel-L2 between 1 and 3 threads, its GDL term alone by
9.7e-4), while in float64 the bands agree with one process to ~4e-8, the
f32 rounding of ``.grad``.  ``loss_all`` of the VGG-off step is held to
the JAX step with ``num_spatial_shards=2`` on a (1, 2) CPU mesh within
1e-4 relative, on the weights the runner seeds.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_video_interpolation_extrapolation_tpu.core.config import (
    Config as JConfig,
)
from deep_video_interpolation_extrapolation_tpu.models import (
    registry as jregistry,
)
from deep_video_interpolation_extrapolation_tpu.parallel import mesh as jmesh
from deep_video_interpolation_extrapolation_tpu.tools.torch_port import (
    port_hrnet,
)
from deep_video_interpolation_extrapolation_tpu.train import (
    common as jcommon,
    inter as jinter,
    state as jstate,
)
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    check_spatial,
    parse_args,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.data.synthetic import (
    synthetic_batch,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.parallel import (
    dist,
    spatial,
)
from deep_video_interpolation_extrapolation_tpu_torch.train import runner

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W, NT, SEED = 2, 32, 64, 2, 7
TIMEOUT = 240
GLOBAL = (f"--dataset synthetic --split train --syn_type inter --mode xs2xs "
          f"--input_h {H} --input_w {W} --compute_dtype float32 "
          f"--n_track {NT}")
RECIPE1 = "INTER --model InterNet --train_coarse"
ARGV = {"novgg": f"{GLOBAL} --bs {B} --vgg_w 0 {RECIPE1}",
        "vgg": f"{GLOBAL} --bs {B} {RECIPE1}",
        "d2s2": f"{GLOBAL} --bs 4 --vgg_w 0 {RECIPE1}"}
# the launcher's epoch (8 synthetic steps) and its val
LAUNCH = f"{GLOBAL} --bs {B} --vgg_w 0 --epochs 1 --disp_interval 1"
PRIM_REL, REL = 1e-6, 1e-5

# what every rank runs first: the group from the launcher's contract, the
# step through the runner's producer on this rank's shard and band
_COMMON = r"""
import json, sys
import torch
torch.set_num_threads(1)
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args)
from deep_video_interpolation_extrapolation_tpu_torch.data.synthetic import (
    synthetic_batch)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import (
    dist, spatial)
from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
    Runner)

spec = json.loads(sys.argv[1])
device = dist.init_from_env("cpu")
RANK = dist.rank()


def after(model):
    # the state a step leaves: parameters, buffers and the gradients the
    # optimizer stepped on (still in .grad)
    return {"state": model.state_dict(),
            "grads": {k: p.grad for k, p in model.named_parameters()
                      if p.grad is not None}}


def step_on(r, batch):
    r._build_steps(train=True)
    for n, b in r._device_prefetch([batch]):
        with r._on_shard(n):
            r.state, losses = r.train_step(r.state, b)
    return r._read_back([losses])[0]


_float = torch.Tensor.float


def recipe_step(name, before=None):
    # the f32 step (losses, the state it leaves), then the same step in
    # float64 arithmetic on a fresh runner (its gradients)
    cfg = parse_args(spec["argv"][name].split())
    r = Runner(cfg, spec["exp"], device=device)
    batch = synthetic_batch(*spec["batch"][name])
    if before is not None:
        before(r, batch)
    losses = step_on(r, batch)
    state = after(r.model)
    r64 = Runner(cfg, spec["exp"], device=device)
    r64.model.coarse_model.dtype = torch.float64
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else _float(t, *a, **k))
    try:
        step_on(r64, batch)
    finally:
        torch.Tensor.float = _float
    state["grads64"] = after(r64.model)["grads"]
    torch.save(state, spec["out"] % (name, RANK))
    return r, losses
"""

# a pair of ranks, one spatial group: every primitive on its band, recipe 1
# with and without the VGG19, the image panel, the launcher's epoch and val
_PAIR = r"""
import numpy as np
from deep_video_interpolation_extrapolation_tpu_torch.cli.main import run
from deep_video_interpolation_extrapolation_tpu_torch.losses import image
from deep_video_interpolation_extrapolation_tpu_torch.losses.perceptual import (
    make_vgg_l1_loss)
from deep_video_interpolation_extrapolation_tpu_torch.models.blocks import Conv
from deep_video_interpolation_extrapolation_tpu_torch.models.features import (
    VGG19Features, init_vgg_weights)
from deep_video_interpolation_extrapolation_tpu_torch.ops.resize import (
    interpolate_bilinear)
from deep_video_interpolation_extrapolation_tpu_torch.ops.shiftadd import (
    shifted_add_bias_plain)

band = dist.spatial_band(2)
rng = np.random.RandomState(0)


def t(*shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def held(fn, xs, map_out=True, consts=()):
    # fn on the whole tensors and on this rank's bands: the output's band
    # (or, for a scalar, the sum of the bands' shares) and each input's
    # gradient under a fixed random cotangent; ``consts`` follow the
    # inputs, banded too, without a gradient
    whole = [x.clone().requires_grad_() for x in xs]
    ref = fn(*whole, *consts)
    cot = t(*ref.shape) if map_out else torch.ones(())
    (ref * cot).sum().backward()
    mine = [x[:, band.rows(x.shape[1])].clone().requires_grad_() for x in xs]
    with spatial.banded(band):
        out = fn(*mine, *(c[:, band.rows(c.shape[1])] for c in consts))
        c = cot[:, band.rows(cot.shape[1])] if map_out else cot
        (out * c).sum().backward()
        got = out.detach() if map_out else spatial.all_sum(out)
    want = ref.detach()[:, band.rows(ref.shape[1])] if map_out else ref.detach()
    errs = [rel(got, want)]
    for w, m in zip(whole, mine):
        if w.grad is None:       # an input the function takes no grad of
            assert m.grad is None
            continue
        errs.append(rel(m.grad, w.grad[:, band.rows(w.grad.shape[1])]))
    return max(errs)


def conv(cin, cout, k, **kw):
    m = Conv(cin, cout, k, **kw)
    with torch.no_grad():
        m.weight.copy_(t(*m.weight.shape) * 0.2)
        m.bias.copy_(t(*m.bias.shape))
    return m


vgg = init_vgg_weights(VGG19Features(), seed=3)
x = t(2, 32, 16, 8)
a, b = (torch.from_numpy(rng.random_sample((2, 32, 16, 3))).float()
        for _ in range(2))
prims = {
    "conv3x3": held(conv(8, 6, 3), [x]),
    "conv3x3_s2": held(conv(8, 6, 3, stride=2), [x]),
    "conv5x5_d2": held(conv(8, 6, 5, dilation=2), [x]),
    "bilinear_x2": held(lambda v: interpolate_bilinear(
        v, size=(2 * v.shape[1], 2 * v.shape[2])), [x]),
    "bilinear_x4": held(lambda v: interpolate_bilinear(
        v, size=(4 * v.shape[1], 4 * v.shape[2])), [x]),
    "shiftadd": held(lambda v: shifted_add_bias_plain(v, torch.arange(
        3.0)), [t(2, 32, 16, 27)]),
    "ssim_blur": held(lambda v: image._depthwise_blur(v, 11, 1.5), [x]),
    "ssim": held(image.ssim, [a, b], map_out=False),
    "gdl": held(image.gdl_loss, [a, b], map_out=False),
    "l1": held(image.l1_loss, [a, b], map_out=False),
    "ce": held(image.cross_entropy_loss, [t(2, 32, 16, 5)], map_out=False,
               consts=[torch.from_numpy(rng.randint(0, 5, (2, 32, 16)))]),
    "vgg19": held(lambda v: sum((f * f).sum() for f in vgg(v)),
                  [t(1, 64, 32, 3)], map_out=False),
    "vgg_l1": held(make_vgg_l1_loss(vgg), [a, b], map_out=False),
}
rng = np.random.RandomState(1)        # the same x and y on both ranks
xd = t(2, 16, 6, 5, dtype=torch.float64)
yd = t(2, 16 // 2 + 3, 6, 5, dtype=torch.float64)
xb = xd[:, band.rows(16)].clone().requires_grad_()
with spatial.banded(band):
    y = spatial.halo(xb, 2, 1)
(gx,) = torch.autograd.grad(y, xb, yd)
dots = torch.stack([(y.detach() * yd).sum(), (xb.detach() * gx).sum()])
torch.distributed.all_reduce(dots)
prims["halo_adjoint"] = float((dots[0] - dots[1]).abs() / dots[0].abs())

class Writer:
    def add_image(self, tag, img, step):
        torch.save(torch.as_tensor(img), spec["out"] % ("panel", RANK))


def panel(r, batch):
    # the image panel of the batch before the step, gathered to rank 0
    r.writer = Writer() if RANK == 0 else None
    r._log_images({k: r._band_of(k, torch.from_numpy(v))
                   for k, v in batch.items()}, 0)


out = {"prims": prims}
_, out["novgg"] = recipe_step("novgg")
_, out["vgg"] = recipe_step("vgg", before=panel)

# the launcher: an epoch, the checkpoint rank 0 writes, val on it
exp = spec["exp"] + "/launch"
run(parse_args(spec["launch"].split() + ["--num_spatial_shards", "2",
                                        *spec["recipe"].split()]),
    exp_dir=exp, device="cpu")
out["ckpts"] = sorted(__import__("os").listdir(exp + "/checkpoint"))
out["val"] = run(parse_args(
    spec["launch"].replace("--split train", "--split val").split()
    + ["--num_spatial_shards", "2", "--load_dir", exp, "--checksession",
       "0", "--checkepoch", "1", *spec["recipe"].split(), "--load_coarse"]),
    exp_dir=exp, device="cpu")
print(json.dumps(out))
torch.distributed.destroy_process_group()
"""

# four ranks, two data shards of two bands: one step of recipe 1
_QUAD = r"""
_, losses = recipe_step("d2s2")
print(json.dumps({"d2s2": losses}))
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks:
    """``code`` started as ranks 0 .. n-1 of one group."""

    def __init__(self, code, n, tmp):
        self.tmp = tmp
        port = _free_port()
        spec = json.dumps({
            "argv": {k: v.replace(RECIPE1, f"--num_spatial_shards 2 "
                                  f"{RECIPE1}") for k, v in ARGV.items()},
            "batch": {k: [4 if k == "d2s2" else B, H, W, 3, NT, SEED]
                      for k in ARGV},
            "exp": str(tmp), "out": str(tmp / "%s_rank%d.pt"),
            "launch": LAUNCH, "recipe": RECIPE1})
        self.procs = []
        for r in range(n):
            env = dict(os.environ, DVIE_MULTIHOST="1",
                       DVIE_COORDINATOR=f"127.0.0.1:{port}",
                       DVIE_NUM_PROCS=str(n), DVIE_PROC_ID=str(r),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _COMMON + code, spec], cwd=REPO,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        self._outs = None

    def result(self):
        """Each rank's JSON line, each process waited for on its own
        clock."""
        if self._outs is None:
            outs = []
            try:
                for p in self.procs:
                    out, err = p.communicate(timeout=TIMEOUT)
                    assert p.returncode == 0, err[-3000:]
                    outs.append(json.loads(out.strip().splitlines()[-1]))
            finally:
                self.kill()
            self._outs = outs
        return self._outs

    def state(self, name, rank):
        return torch.load(self.tmp / f"{name}_rank{rank}.pt")

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The pair and the four ranks, started together, so that they run
    beside each other and beside the one-process and JAX steps."""
    started = {"pair": _Ranks(_PAIR, 2, tmp_path_factory.mktemp("pair")),
               "quad": _Ranks(_QUAD, 4, tmp_path_factory.mktemp("quad"))}
    yield started
    for g in started.values():
        g.kill()


def _rel_l2(a, b) -> float:
    num = sum(float(((x.double() - y.double()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.double() ** 2).sum()) for y in b)
    return (num / max(den, 1e-30)) ** 0.5


def _f64(monkeypatch, model):
    """The step in float64 arithmetic: the model's compute dtype float64,
    and ``Tensor.float`` keeping a float64 tensor as it is (the plain
    versions' f32 accumulation of compute-dtype operands becomes f64)."""
    model.coarse_model.dtype = torch.float64
    fl = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: (
        t if t.dtype == torch.float64 else fl(t, *a, **k)))


def _one_process(name, tmp_path, monkeypatch, before=None):
    """The step in this process on one thread, on the plain model (the
    route of a spatial step), in f32 (losses, the state it leaves) and in
    float64 arithmetic (its gradients); ``before(runner, batch)`` runs
    first."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        4 if name == "d2s2" else B, H, W, 3, NT, SEED).items()}
    out = []
    try:
        for f64 in (False, True):
            monkeypatch.setattr(registry, "build_model", functools.partial(
                registry.build_model, use_kernels=False))
            one = runner.Runner(parse_args(ARGV[name].split()),
                                str(tmp_path), device="cpu")
            one._build_steps(train=True)
            if f64:
                _f64(monkeypatch, one.model)
            elif before is not None:
                before(one, batch)
            one.state, losses = one.train_step(one.state, batch)
            monkeypatch.undo()
            out.append((losses, one))
    finally:
        torch.set_num_threads(threads)
        monkeypatch.undo()
    (losses, one), (_, one64) = out

    def grads(m):
        return {k: p.grad for k, p in m.named_parameters()
                if p.grad is not None}
    return ({k: float(v) for k, v in losses.items()},
            {"state": one.model.state_dict(), "grads": grads(one.model),
             "grads64": grads(one64.model)}, one)


def _held(name, losses, ranks, ref, lr=1e-3):
    """Every rank's loss dict, gradients and parameters after the step
    against one process's."""
    l_ref, a, _ = ref
    for got in losses:
        assert got.keys() == l_ref.keys()
        for k in l_ref:
            assert abs(got[k] - l_ref[k]) <= REL * max(abs(l_ref[k]), 1e-6), (
                name, k, got[k], l_ref[k])
    s0 = ranks[0]
    for s in ranks[1:]:
        for part in ("state", "grads", "grads64"):
            assert s[part].keys() == s0[part].keys()
            for k in s0[part]:
                assert torch.equal(s[part][k], s0[part][k]), (name, k)
    assert s0["grads"].keys() == a["grads"].keys() == a["grads64"].keys()
    keys = list(a["grads"])
    err = _rel_l2([s0["grads64"][k] for k in keys],
                  [a["grads64"][k] for k in keys])
    assert err <= REL, (name, err)
    d = torch.cat([(s0["state"][k] - a["state"][k]).abs().flatten()
                   for k in keys])
    assert float(d.max()) <= 2 * lr * (1 + 1e-4), name
    assert float((d > 1e-3 * lr).float().mean()) <= 1e-3, name


@pytest.fixture(scope="module")
def jax_recipe1():
    """``loss_all`` of the JAX train step of recipe 1 with
    ``num_spatial_shards=2``: H of the batch sharded over a (1, 2) mesh of
    the CPU (the JAX ``Runner._shard``), the model on its XLA compositions
    (``spatial_sharded``), on the weights the port's runner seeds, mapped
    by ``tools/torch_port.port_hrnet`` onto the tree of ``jax.eval_shape``
    (no JAX init runs)."""
    cfg = JConfig(runner="INTER", model="InterNet", syn_type="inter",
                  mode="xs2xs", coarse_model="HRNet", compute_dtype="float32",
                  input_h=H, input_w=W, batch_size=B, dataset="synthetic",
                  train_coarse=True, vgg_weight=0.0, num_data_shards=1,
                  num_spatial_shards=2)
    model = jregistry.build_model(cfg)
    batch = synthetic_batch(B, H, W, n_track=NT, seed=SEED)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "bboxes"}
    for i in (1, 2, 3):
        jb[f"seg{i}"] = jax.nn.one_hot(jb[f"seg{i}"], 20)
    x, seg, _, _ = jcommon.get_inter_inputs(jb)
    tmpl = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, seg,
                                             train=False))
    pcfg = parse_args(ARGV["novgg"].split())
    port = registry.build_model(pcfg, device="cpu", seed=pcfg.seed)
    sd = {k: v.numpy() for k, v in port.coarse_model.state_dict().items()}
    variables = {"params": {"coarse_model": port_hrnet(
        sd, tmpl["params"]["coarse_model"])}}
    state = jstate.create_train_state(cfg, variables, frozen={})
    mesh = jmesh.create_mesh(1, 2)
    jb = {k: jax.device_put(v, jmesh.batch_sharding(mesh, v.ndim,
                                                    spatial_dim=1))
          for k, v in jb.items()}
    state = jax.device_put(state, jmesh.replicated_sharding(mesh))
    _, losses = jax.jit(jinter.make_train_step(cfg, model))(
        state, jb, jax.random.PRNGKey(1))
    return float(losses["loss_all"])


def test_primitives_on_bands_match_the_whole(groups):
    for rank_out in groups["pair"].result():
        prims = rank_out["prims"]
        assert len(prims) == 14
        for name, err in prims.items():
            assert err <= PRIM_REL, (name, err)


def test_recipe1_two_bands_match_one_and_jax(groups, jax_recipe1, tmp_path,
                                             monkeypatch):
    pair = groups["pair"]
    losses = [o["novgg"] for o in pair.result()]
    ref = _one_process("novgg", tmp_path, monkeypatch)
    _held("novgg", losses, [pair.state("novgg", r) for r in range(2)], ref)
    assert abs(losses[0]["loss_all"] - jax_recipe1) <= 1e-4 * abs(
        jax_recipe1), (losses[0]["loss_all"], jax_recipe1)


def test_recipe1_with_vgg_two_bands_match_one(groups, tmp_path, monkeypatch):
    pair = groups["pair"]
    losses = [o["vgg"] for o in pair.result()]
    assert losses[0]["coarse_vgg_loss"] > 0
    panels = []

    class Writer:
        def add_image(self, tag, img, step):
            panels.append(torch.as_tensor(img))

    def panel(one, batch):
        one.writer = Writer()
        one._log_images(batch, 0)
    ref = _one_process("vgg", tmp_path, monkeypatch, before=panel)
    _held("vgg", losses, [pair.state("vgg", r) for r in range(2)], ref)
    # the image panel of the seeded model, gathered to rank 0
    got = pair.state("panel", 0)
    assert got.shape == panels[0].shape
    assert float((got - panels[0]).abs().max()) <= 1e-5


def test_two_data_shards_of_two_bands_match_one(groups, tmp_path,
                                                monkeypatch):
    quad = groups["quad"]
    losses = [o["d2s2"] for o in quad.result()]
    ref = _one_process("d2s2", tmp_path, monkeypatch)
    _held("d2s2", losses, [quad.state("d2s2", r) for r in range(4)], ref)


def test_launcher_trains_an_epoch_and_validates_on_two_bands(groups):
    outs = groups["pair"].result()
    assert outs[0]["ckpts"] and outs[0]["ckpts"] == outs[1]["ckpts"]
    val = outs[0]["val"]
    assert val == outs[1]["val"]
    assert {"coarse_l1", "coarse_psnr", "coarse_ssim", "coarse_iou"} <= set(
        val) and all(np.isfinite(list(val.values())))


@pytest.mark.parametrize("s, h, match", [
    (0, 128, "at least 1"), (2, 48, "divisible by 32"),
    (4, 96, "divisible by 64")])
def test_bad_spatial_shards_raise(s, h, match):
    """S x 16 must divide H; S must divide the world (here one process)."""
    with pytest.raises(ValueError, match=match):
        check_spatial(Config(num_spatial_shards=s, input_h=h))
    with pytest.raises(ValueError, match="does not divide the 1 processes"):
        dist.data_shards(0, 2)


def test_band_rows_and_the_unbanded_primitives():
    """A band's rows; outside a band ``halo`` is zero padding, ``mean``
    the mean and ``gather_rows`` the map itself."""
    assert spatial.Band(2, 1).rows(32) == slice(16, 32)
    with pytest.raises(ValueError, match="do not divide"):
        spatial.Band(2, 0).rows(5)
    x = torch.randn(2, 3, 4, 5)
    torch.testing.assert_close(spatial.halo(x, 2, 1), torch.nn.functional.pad(
        x, (0, 0, 0, 0, 2, 1)), rtol=0, atol=0)
    assert spatial.mean(x) == x.mean()
    assert spatial.gather_rows(x) is x
    assert spatial.global_rows(7) == 7
