"""One rank of the port's multi-process checks, on the CPU over gloo.

Started once per rank, with ``torchrun``'s variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) in its
environment, by :func:`launch` (``tests/test_torch_train_parity.py``,
``tests/test_torch_parallel.py``):

    python tests/_torch_parallel_worker.py <scenario> <directory>

It reads ``spec.pt`` (the start weights, the global batch, the serving
payloads and the sizes) from the directory and writes its results there as
``<scenario>_rank<r>.pt``. The body imports torch and the port only, never
JAX: the parent test computes the JAX side.

Scenarios:
- ``mmfn`` (2 ranks): MMFN-rad's data-parallel (DDP) step; model_parallel 2
  at data 1: the forward (plain and ``attn_impl="pallas"`` attention), one
  step with its gathered ``.pth``, and ``TorchPipeline`` serving the
  sharded model. Each step also gives its AdamW ``exp_avg`` by parameter
  name, gathered to full tensors (0.1 x the gradient after the first step).
- ``tiny`` (2 ranks): on :class:`TinyFusion`, the dropout masks of the two
  data ranks and the ``"orbax"`` (DCP) backend, saved at world 2 by DDP and
  by model_parallel 2 and resumed at world 2; then the phase2 CLI on the
  uneven pools ``spec.pt`` names.
- ``grid`` (4 ranks): MMFN-rad on the ("data", "model") = (2, 2) mesh: the
  sharded forward of each data rank's rows and one step.
"""

import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

from mmfn_tpu_torch.config import GlobalConfig  # noqa: E402
from mmfn_tpu_torch.data.batch import Batch  # noqa: E402
from mmfn_tpu_torch.harness.agents.pipeline import TorchPipeline  # noqa: E402
from mmfn_tpu_torch.models import build_model  # noqa: E402
from mmfn_tpu_torch.models.gpt import FusionTransformer, SelfAttention  # noqa: E402
from mmfn_tpu_torch.models.resnet import BatchNorm2d  # noqa: E402
from mmfn_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from mmfn_tpu_torch.train import phase2  # noqa: E402
from mmfn_tpu_torch.train.engine import Engine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(scenario, world, out_dir):
    """``world`` ranks of ``scenario``, each a process with torchrun's
    variables and 2 torch threads; returns the processes."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PYTHONPATH=ROOT)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario,
                                       str(out_dir)],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def join(procs, scenario, out_dir):
    """Each rank's results, once every rank has exited 0. A rank that has
    not exited within 300 s fails the call, and every rank is killed."""
    try:
        logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(os.path.join(out_dir, f"{scenario}_rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


class TinyFusion(nn.Module):
    """Batch -> (B, 4, 2) waypoints through a conv, a train-mode BatchNorm,
    one 4-head fusion transformer and a Linear: every kind of state the
    multi-process checkpoints hold, in a few KB."""

    variant = "tiny"

    def __init__(self, seed: int = 0, embd_pdrop: float = 0.0):
        super().__init__()
        with torch.random.fork_rng():
            torch.manual_seed(seed)
            self.conv = nn.Conv2d(3, 32, 3, 4, 1)
            self.bn = BatchNorm2d(32)
            self.gpt = FusionTransformer(32, 4, 2, 1, n_groups=1, embd_pdrop=embd_pdrop,
                                         attn_pdrop=0.0, resid_pdrop=0.0)
            self.head = nn.Linear(32, 8)

    def forward(self, batch):
        x = F.relu(self.bn(self.conv(batch.image.permute(0, 3, 1, 2) / 255.0)))
        (grid,) = self.gpt([F.adaptive_avg_pool2d(x, 8)], batch.velocity)
        return self.head(grid.mean((2, 3))).view(-1, 4, 2)


def _model(spec, cfg, seed=0):
    model = build_model(cfg, "rad", torch.Generator().manual_seed(seed), device="cpu")
    if spec is not None:
        model.load_state_dict(spec["start"])
    return model


@torch.no_grad()
def _forwards(model, batch):
    """The eval forward with plain attention and through ``fused_attention``
    (its plain version on the CPU) at the local head count."""
    model.eval()
    out = {"xla": model(batch).clone()}
    attns = [m for m in model.modules() if isinstance(m, SelfAttention)]
    for m in attns:
        m.attn_impl = "pallas"
    out["pallas"] = model(batch).clone()
    for m in attns:
        m.attn_impl = "xla"
    return out


def _one_step(engine, batch, validate=False):
    state = engine.initial_state()
    engine.train(state, [batch], seed=0)
    if validate:
        engine.validate(state, [batch])
    return state


def _state(model):
    return {k: v.clone() for k, v in pmesh.full_state_dict(model).items()}


def _moments(state):
    """AdamW's exp_avg by parameter name, tensor-parallel shards gathered (a
    collective on the model group: every rank calls it)."""
    tp = pmesh.layout_of(state.model)
    out = {}
    for name, p in state.model.named_parameters():
        m = state.optimizer.state[p]["exp_avg"]
        if tp is not None and name in tp.dims:
            m = pmesh.gather_full(m, tp.dims[name], tp.group, tp.size)
        out[name] = m.clone()
    return out


def mmfn(spec, cfg, out_dir, rank):
    res = {}
    batch = spec["batch"]
    mesh = pmesh.make_mesh(2)
    shard = pmesh.shard_batch(batch, mesh)
    tp_mesh = pmesh.make_mesh(2, ("data", "model"), (1, 2))

    # MMFN-rad, data parallel over 2 ranks
    engine = Engine(_model(spec, cfg), cfg, os.path.join(out_dir, "dp"), mesh=mesh)
    state = _one_step(engine, shard)
    res["dp_loss"] = engine.train_loss[-1]
    if rank == 0:
        res["dp_after"] = _state(state.model)
        res["dp_mu"] = _moments(state)

    # MMFN-rad, model_parallel 2 at data 1
    model = pmesh.tensor_parallel_sharding(_model(spec, cfg), tp_mesh)
    res["tp_local_heads"] = {m.local_heads for m in model.modules()
                             if isinstance(m, SelfAttention)}
    res["tp_forward"] = _forwards(model, batch)
    engine = Engine(model, cfg, os.path.join(out_dir, "tp2"), mesh=tp_mesh)
    state = _one_step(engine, batch)
    engine.save(state)                          # model.pth: full tensors, rank 0
    res["tp_loss"] = engine.train_loss[-1]
    res["tp_mu"] = _moments(state)
    res["tp_waypoints"] = TorchPipeline(model, cfg, points_per_sweep=spec["pps"],
                                        device="cpu").dispatch_fleet(spec["payloads"])
    return res


def tiny(spec, cfg, out_dir, rank):
    res = {}
    batch = spec["batch"]
    mesh = pmesh.make_mesh(2)
    shard = pmesh.shard_batch(batch, mesh)
    tp_mesh = pmesh.make_mesh(2, ("data", "model"), (1, 2))

    # dropout: the same rows on both ranks, so only the seed tells the masks apart
    engine = Engine(TinyFusion(embd_pdrop=0.5), cfg, os.path.join(out_dir, "noisy"),
                    mesh=mesh)
    masks = []
    handle = engine.model.gpt.drop.register_forward_hook(
        lambda m, i, o: masks.append((o != 0).float()))
    engine.train(engine.initial_state(), [batch], seed=0)
    handle.remove()
    both = [torch.empty_like(masks[0]) for _ in range(2)]
    dist.all_gather(both, masks[0])
    res["masks_equal"] = bool(torch.equal(both[0], both[1]))
    res["mask_keep"] = float(masks[0].mean())

    # the DCP backend: DDP at world 2, saved and resumed at world 2
    orbax = cfg.replace(checkpoint_backend="orbax")
    logdir = os.path.join(out_dir, "dcp_dp")
    engine = Engine(TinyFusion(), orbax, logdir, mesh=mesh)
    state = _one_step(engine, shard, validate=True)
    engine.save(state)
    if rank == 0:
        res["dcp_dp_after"] = _state(state.model)
    fresh = Engine(TinyFusion(seed=5), orbax, logdir, mesh=mesh)
    back = fresh.initial_state()
    assert fresh.resume(back) is not None
    want = state.model.state_dict()
    res["resume_world2_equal"] = all(torch.equal(v, want[k])
                                     for k, v in back.model.state_dict().items())
    res["resume_world2"] = (back.step, fresh.cur_epoch)

    # the DCP backend under model_parallel 2: DTensor shards over "model"
    model = pmesh.tensor_parallel_sharding(TinyFusion(), tp_mesh)
    engine = Engine(model, orbax, os.path.join(out_dir, "dcp_tp"), mesh=tp_mesh)
    engine.save(_one_step(engine, batch))
    res["dcp_tp_after"] = _state(model)

    # the phase2 CLI on pools whose frames do not split evenly over the data
    # ranks; it ends the process group, so it comes last
    assert phase2.main(spec["phase2_args"]) == 0
    if rank == 0:
        with open(os.path.join(spec["phase2_logdir"], "recent.log")) as f:
            res["phase2_log"] = f.read()
    return res


def grid(spec, cfg, out_dir, rank):
    res = {}
    mesh = pmesh.make_mesh(4, ("data", "model"), (2, 2))
    shard = pmesh.shard_batch(spec["batch"], mesh)
    model = pmesh.tensor_parallel_sharding(_model(spec, cfg), mesh)
    res["rows"] = pmesh.axis_rank(mesh, "data")
    res["forward"] = _forwards(model, shard)
    engine = Engine(model, cfg, os.path.join(out_dir, "grid"), mesh=mesh)
    state = _one_step(engine, shard)
    res["loss"] = engine.train_loss[-1]
    after, mu = _state(model), _moments(state)  # collectives on the model group
    if rank == 0:
        res["after"], res["mu"] = after, mu
    return res


def main():
    scenario, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(2)
    spec = torch.load(os.path.join(out_dir, "spec.pt"), weights_only=False)
    spec["batch"] = Batch(**spec["batch"])
    cfg = GlobalConfig(**spec["config"])
    pmesh.init_distributed(device="cpu")
    rank = dist.get_rank()
    try:
        res = {"mmfn": mmfn, "tiny": tiny, "grid": grid}[scenario](spec, cfg, out_dir, rank)
        torch.save(res, os.path.join(out_dir, f"{scenario}_rank{rank}.pt"))
    finally:
        pmesh.destroy_distributed()


if __name__ == "__main__":
    main()
