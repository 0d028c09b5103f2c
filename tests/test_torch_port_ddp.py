"""Data parallelism of the port (``parallel/dist.py``, the runner's data
axis) against one process and against the JAX package's sharded step.

Two ``gloo`` processes start through the launcher's contract
(``DVIE_MULTIHOST=1``, ``DVIE_COORDINATOR`` on a free port,
``DVIE_NUM_PROCS=2``, ``DVIE_PROC_ID``) and build the port's ``Runner``
with ``--num_data_shards 2``; each takes its rows of one global batch
through the runner's producer and runs one train step on its shard.  The
same ``Runner`` in this process, one rank, runs the step on the whole
batch.  Recipe 1 (InterNet/HRNet) and recipe 4 (InterGANNet: VAEHRNet's
BatchNorms and eps, four discriminator families, the video box family
with BatchNorms over its track crops and its sync_neg draws) at B=4 (2 a
rank) 32x64 f32, ``--vgg_w 0``.

Held: the two ranks end with the same parameters, buffers and gradients,
bit for bit; every loss term, reduced over the ranks, within 1e-5
relative of the one-process step's; each submodel's gradient (what its
optimizer stepped on) within 1e-5 rel-L2 of the one-process step's, or
twice what summing the BatchNorm statistics in the ranks' order moves it
in one process (recipe 4: VAEHRNet's deepest BatchNorms see 2 x 4
positions a sample, where E[x^2] - E[x]^2 amplifies the order of a sum:
the video discriminator's gradient moves by 2.6e-4 rel-L2 in one process
so); the parameters after the step as ``tests/test_torch_port_train.py``
holds them (a first Adamax or Adam step moves a weight by about lr *
sign(g), so where |g| is rounding noise, as for a bias before a
train-mode BatchNorm, two sums may move it 2 lr apart): 99.9% within 1e-3
lr, all within 2 lr; the buffers (running statistics, spectral-norm
vectors) within 1e-5 rel-L2.  Recipe 1's ``loss_all`` is held to the JAX
step with ``num_data_shards=2`` on a 2-device CPU mesh, on the weights the
runner seeds, within 1e-4 relative (``tests/test_torch_port_train.py``'s
loss tolerance).
Recipe 4's draws come from torch's generator, not JAX's keys, so its JAX
step is not compared here (``tests/test_torch_port_gan_step.py`` holds
the one-process port step to JAX with the draws carried across).

Every subprocess has its own time limit (``communicate(timeout=...)``),
so a rendezvous that hangs fails here, not at the suite's limit.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
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
    parse_args,
)
from deep_video_interpolation_extrapolation_tpu_torch.core.config import Config
from deep_video_interpolation_extrapolation_tpu_torch.data.synthetic import (
    synthetic_batch,
)
from deep_video_interpolation_extrapolation_tpu_torch.models import registry
from deep_video_interpolation_extrapolation_tpu_torch.models.subnets import (
    BatchNorm,
)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import dist
from deep_video_interpolation_extrapolation_tpu_torch.train import runner

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W, NT = 4, 32, 64, 2
TIMEOUT = 180
GLOBAL = (f"--dataset synthetic --split train --syn_type inter --mode xs2xs "
          f"--input_h {H} --input_w {W} --bs {B} --compute_dtype float32 "
          f"--vgg_w 0 --n_track {NT}")
RECIPE1 = "INTER --model InterNet --train_coarse"
RECIPE4 = (
    "INTER --model InterGANNet --coarse_model VAEHRNet "
    "--vae --gan --train_coarse "
    "--frame_disc --frame_disc_model FrameSNDiscriminator --train_frame_disc "
    "--frame_disc_g_w 0.4 --frame_disc_d_w 0.001 --frame_disc_lr 0.0001 "
    "--video_disc --video_disc_model VideoSNDiscriminator --train_video_disc "
    "--video_disc_g_w 0.4 --video_disc_d_w 0.001 --video_disc_lr 0.0001 "
    "--frame_det_disc --frame_det_disc_model FrameSNDetDiscriminator "
    "--train_frame_det_disc --frame_det_disc_g_w 0.4 "
    "--frame_det_disc_d_w 0.001 --frame_det_disc_lr 0.0001 "
    "--video_det_disc --video_det_disc_model VideoLSSNDetDiscriminator "
    "--train_video_det_disc --video_det_disc_g_w 0.4 "
    "--video_det_disc_d_w 0.01 --video_det_disc_lr 0.0001")
REL = 1e-5
ARGV = {"recipe1": f"{GLOBAL} --num_data_shards 2 {RECIPE1}".split(),
        "recipe4": f"{GLOBAL} --kld_w 20 --num_data_shards 2 {RECIPE4}"
        .split()}
BATCH = {"recipe1": [B, H, W, 3, NT, 7], "recipe4": [B, H, W, 3, NT, 8]}

# one rank: the launcher's process group, the runner's producer and one
# train step on its shard of the global batch
_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from deep_video_interpolation_extrapolation_tpu_torch.cli.options import (
    parse_args)
from deep_video_interpolation_extrapolation_tpu_torch.data.synthetic import (
    synthetic_batch)
from deep_video_interpolation_extrapolation_tpu_torch.parallel import dist
from deep_video_interpolation_extrapolation_tpu_torch.train.runner import (
    Runner)

args = json.loads(sys.argv[1])
device = dist.init_from_env("cpu")
assert dist.world_size() == 2
cfg = parse_args(args["argv"])
out = args["out"] % dist.rank()
print(json.dumps(step_on(Runner(cfg, args["exp"], device=device),
                         synthetic_batch(*args["batch"]), out)))
torch.distributed.destroy_process_group()
"""

# the step both sides run: the runner's producer, then one step on the
# shard it gives (the whole batch in one process)
_STEP = r"""
def step_on(r, batch, out=None):
    import torch
    from deep_video_interpolation_extrapolation_tpu_torch.parallel import (
        dist)
    r._build_steps(train=True)
    for n, b in r._device_prefetch([batch]):
        with dist.sharded(dist.shard_of(n)):
            r.state, losses = r.train_step(r.state, b)
    losses = r._read_back([losses])[0]
    if out is not None:
        torch.save(after(r.model), out)
    return losses


def after(model):
    # the state a step leaves: parameters, buffers and the gradients the
    # optimizers stepped on (still in .grad)
    return {"state": model.state_dict(),
            "grads": {k: p.grad for k, p in model.named_parameters()
                      if p.grad is not None}}
"""
exec(_STEP)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks:
    """The worker started as ranks 0 and 1 of one group."""

    def __init__(self, argv, tmp, batch_args):
        self.tmp = tmp
        port = _free_port()
        spec = json.dumps({"argv": argv, "exp": str(tmp),
                           "out": str(tmp / "rank%d.pt"),
                           "batch": batch_args})
        self.procs = []
        for r in range(2):
            env = dict(os.environ, DVIE_MULTIHOST="1",
                       DVIE_COORDINATOR=f"127.0.0.1:{port}",
                       DVIE_NUM_PROCS="2", DVIE_PROC_ID=str(r),
                       OMP_NUM_THREADS="1", PYTHONPATH=REPO)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _STEP + _WORKER, spec], cwd=REPO,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))

    def result(self):
        """Each rank's loss dict and state, each process waited for on its
        own clock."""
        outs = []
        try:
            for p in self.procs:
                out, err = p.communicate(timeout=TIMEOUT)
                assert p.returncode == 0, err[-3000:]
                outs.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            self.kill()
        return outs, [torch.load(self.tmp / f"rank{r}.pt") for r in range(2)]

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both recipes' two ranks, started together, so that they run beside
    each other and beside the JAX step."""
    started = {name: _Ranks(ARGV[name], tmp_path_factory.mktemp(name),
                            BATCH[name]) for name in ARGV}
    yield started
    for r in started.values():
        r.kill()


def _rel_l2(a, b) -> float:
    num = sum(float(((x.double() - y.double()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((y.double() ** 2).sum()) for y in b)
    return (num / max(den, 1e-30)) ** 0.5


def _split_moments(x, axes):
    """``dist.batch_moments`` in one process with the sums taken as two
    ranks take them: each half of the batch summed, then the halves
    added."""
    h, n = x.shape[0] // 2, x.numel() // x.shape[-1]
    s1 = x[:h].sum(axes) + x[h:].sum(axes)
    s2 = (x[:h] * x[:h]).sum(axes) + (x[h:] * x[h:]).sum(axes)
    mean = s1 / n
    return mean, (s2 / n - mean * mean).clamp_min(0.0)


def _one_process(argv, tmp_path, batch_args):
    """The step in this process on one thread, as each rank runs it (the
    thread count orders the convolutions' sums too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = runner.Runner(parse_args(argv).replace(num_data_shards=0),
                            str(tmp_path), device="cpu")
        losses = step_on(one, synthetic_batch(*batch_args))
    finally:
        torch.set_num_threads(threads)
    return losses, after(one.model), one.model


def _held(name, ranks, monkeypatch, lr=1e-3):
    """Two ranks against this process's one; returns rank 0's losses."""
    (l0, l1), (s0, s1) = ranks[name].result()
    argv, batch_args, tmp_path = ARGV[name], BATCH[name], ranks[name].tmp
    assert l0 == l1
    for part in ("state", "grads"):
        assert s0[part].keys() == s1[part].keys()
        for k in s0[part]:
            assert torch.equal(s0[part][k], s1[part][k]), k
    ref, a, one = _one_process(argv, tmp_path, batch_args)
    assert l0.keys() == ref.keys()
    for k in ref:
        assert abs(l0[k] - ref[k]) <= REL * max(abs(ref[k]), 1e-6), (
            k, l0[k], ref[k])
    # the gradients each optimizer stepped on, per submodel: within 1e-5,
    # or twice what summing the BatchNorm statistics in the ranks' order
    # moves them in one process (their deepest maps hold 2 x 4 positions
    # a sample, where E[x^2] - E[x]^2 amplifies the order of the sums)
    split = a
    if any(isinstance(m, BatchNorm) for m in one.modules()):
        monkeypatch.setattr(dist, "batch_moments", _split_moments)
        _, split, _ = _one_process(argv, tmp_path, batch_args)
        monkeypatch.undo()
    assert s0["grads"].keys() == a["grads"].keys()
    for sub in {k.split(".")[0] for k in a["grads"]}:
        keys = [k for k in a["grads"] if k.split(".")[0] == sub]

        def err(g):
            return _rel_l2([g[k] for k in keys], [a["grads"][k] for k in keys])
        assert err(s0["grads"]) <= 2 * err(split["grads"]) + REL, (
            sub, err(s0["grads"]), err(split["grads"]))
    # parameters after the step: a first Adamax or Adam step moves a weight
    # by about lr * sign(g), so where |g| sits within rounding noise of 0
    # (a bias before a train-mode BatchNorm has a gradient of exactly 0 in
    # exact arithmetic) the two steps may differ by up to 2 lr
    sd = a["state"]
    params = [k for k in a["grads"]]
    d = torch.cat([(s0["state"][k] - sd[k]).abs().flatten()
                   for k in params])
    assert float(d.max()) <= 2 * lr * (1 + 1e-4)
    assert float((d > 1e-3 * lr).float().mean()) <= 1e-3
    # the buffers (running statistics, spectral-norm vectors)
    bufs = [k for k in sd if k not in a["grads"]
            and sd[k].is_floating_point()]
    assert _rel_l2([s0["state"][k] for k in bufs],
                   [sd[k] for k in bufs]) <= REL
    return l0


@pytest.fixture(scope="module")
def jax_recipe1():
    """The loss of the JAX train step of recipe 1 with
    ``num_data_shards=2`` (the global batch sharded over a 2-device mesh of
    the CPU, ``parallel/mesh.py``), on the weights the port's runner
    seeds: mapped by the JAX package's ``tools/torch_port.port_hrnet`` onto
    the tree of ``jax.eval_shape`` (no JAX init runs)."""
    cfg = JConfig(runner="INTER", model="InterNet", syn_type="inter",
                  mode="xs2xs", coarse_model="HRNet", compute_dtype="float32",
                  input_h=H, input_w=W, batch_size=B, dataset="synthetic",
                  train_coarse=True, vgg_weight=0.0, num_data_shards=2)
    model = jregistry.build_model(cfg)
    batch = synthetic_batch(B, H, W, n_track=NT, seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "bboxes"}
    for i in (1, 2, 3):
        jb[f"seg{i}"] = jax.nn.one_hot(jb[f"seg{i}"], 20)
    x, seg, _, _ = jcommon.get_inter_inputs(jb)
    tmpl = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, seg,
                                             train=False))
    pcfg = parse_args(f"{GLOBAL} {RECIPE1}".split())
    port = registry.build_model(pcfg, device="cpu", seed=pcfg.seed)
    sd = {k: v.numpy() for k, v in port.coarse_model.state_dict().items()}
    variables = {"params": {"coarse_model": port_hrnet(
        sd, tmpl["params"]["coarse_model"])}}
    state = jstate.create_train_state(cfg, variables, frozen={})
    mesh = jmesh.create_mesh(2, 1)
    jb = {k: jax.device_put(v, jmesh.batch_sharding(mesh, v.ndim))
          for k, v in jb.items()}
    state = jax.device_put(state, jmesh.replicated_sharding(mesh))
    _, losses = jax.jit(jinter.make_train_step(cfg, model))(
        state, jb, jax.random.PRNGKey(1))
    return float(losses["loss_all"])


def test_recipe1_two_ranks_match_one_and_jax(ranks, jax_recipe1,
                                             monkeypatch):
    losses = _held("recipe1", ranks, monkeypatch)
    assert abs(losses["loss_all"] - jax_recipe1) <= 1e-4 * abs(
        jax_recipe1), (losses["loss_all"], jax_recipe1)


def test_recipe4_two_ranks_match_one(ranks, monkeypatch):
    """BatchNorm statistics over the global batch (VAEHRNet's encoder and
    decoder, the video box discriminator) and the global batch's eps and
    sync_neg draws."""
    losses = _held("recipe4", ranks, monkeypatch)
    assert {"coarse_kld_loss", "disc_video_det_fake_loss"} <= set(losses)


@pytest.mark.parametrize("kw", [
    dict(model="InterGANNet", coarse_model="VAEHRNet"),
    dict(model="ExtraNet", syn_type="extra"),
    dict(model="InterNet", highres_large=True),
    dict(model="InterNet", split="cycgen"),
    dict(model="InterNet")])
def test_spatial_sharding_still_raises(kw):
    """Under --num_spatial_shards 2 every combination but recipe 1's
    (InterNet on HRNet, train or val) raises, citing its ROADMAP item,
    before any step; recipe 1 passes (tests/test_torch_port_spatial.py
    runs it)."""
    cfg = Config(**{"num_spatial_shards": 2, "syn_type": "inter", **kw})
    if kw == dict(model="InterNet"):
        runner._check_supported(cfg)
        return
    with pytest.raises(NotImplementedError, match="item 10"):
        runner._check_supported(cfg)


def test_data_shards_follow_the_group():
    """Without a group there is one shard: 0 and 1 mean it, 2 asks for two
    processes; the global batch must divide over the shards."""
    assert dist.data_shards(0) == dist.data_shards(1) == 1
    with pytest.raises(ValueError, match="needs 2 processes"):
        dist.data_shards(2)
    assert dist.local_batch_size(24, 2) == 12
    with pytest.raises(ValueError, match="does not divide"):
        dist.local_batch_size(5, 2)
    assert dist.shard_of(4) is None
    assert dist.Shard(2, 1).rows(24) == slice(12, 24)


@pytest.mark.parametrize("env, match", [
    ({"DVIE_COORDINATOR": "127.0.0.1:1", "DVIE_NUM_PROCS": "2"},
     "needs all three"),
    ({"DVIE_COORDINATOR": "127.0.0.1:1", "DVIE_NUM_PROCS": "2",
      "DVIE_PROC_ID": "2"}, "out of range"),
])
def test_partial_contract_raises(monkeypatch, env, match):
    """The JAX contract's errors (mesh.py:55-66), before any rendezvous."""
    monkeypatch.setenv("DVIE_MULTIHOST", "1")
    monkeypatch.delenv("DVIE_PROC_ID", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=match):
        dist.init_from_env("cpu")


def test_draws_and_moments_of_a_shard():
    """Under a shard a draw is the global batch's, this rank's rows; out of
    one, the local draw; the moments are a batch's mean and biased
    variance."""
    def draw(s):
        return torch.randn(s, generator=torch.Generator().manual_seed(3))
    whole = draw((4, 5))
    with dist.sharded(dist.Shard(2, 1)):
        torch.testing.assert_close(dist.global_draw(draw, (2, 5)),
                                   whole[2:], rtol=0, atol=0)
    torch.testing.assert_close(dist.global_draw(draw, (4, 5)), whole,
                               rtol=0, atol=0)
    x = torch.randn(4, 3, 5, 8)
    mean, var = dist.batch_moments(x, (0, 1, 2))
    torch.testing.assert_close(mean, x.mean((0, 1, 2)))
    torch.testing.assert_close(var, x.var((0, 1, 2), unbiased=False),
                               atol=1e-6, rtol=1e-5)
