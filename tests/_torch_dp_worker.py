"""One rank of the port's data-parallel tests (tests/test_torch_dp.py,
tests/test_torch_dp_loop.py), started as

    python tests/_torch_dp_worker.py <job.pt> <rank> <world size> <init method>

It imports torch and the port only, joins a gloo group through the init
method (a ``file://`` store beside the job), runs
the job's cases in order and writes ``out_<rank>.pt`` beside the job file:

- ``steps``: {name: {"cfg": a config dict, "state": a one-card train state
  dict, "batches": [global batch dicts of numpy arrays], "fsdp": bool,
  "min_size": int, "draws": {step: EMA draws} or None, "model_devices":
  a TP model axis or None}}; each rank takes its rows of every batch
  (``parallel/mesh.py::shard_batch``) and runs the data-parallel step; out:
  per step the metrics and the gathered state dict, the names of the
  leaves FSDP sharded and of the TP leaves, and the most blocks whose cuts
  were full at once during the steps, counted at every gather
  (``max_full_blocks``);
- ``loops``: {name: {"cfg": ..., "run_dir": ..., "max_steps": int,
  "model_devices": optional}}: ``train.loop.train`` on the config's
  filelists, each rank on its stripe;
  out: the returned state's dict and a validation pass run again.
"""
import sys
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from audiotokenization_tpu_torch import config as PC  # noqa: E402
from audiotokenization_tpu_torch.parallel import fsdp  # noqa: E402
from audiotokenization_tpu_torch.parallel.mesh import shard_batch  # noqa: E402
from audiotokenization_tpu_torch.train.state import init_train_state  # noqa: E402
from audiotokenization_tpu_torch.train.step import make_train_step  # noqa: E402


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(numpy_tree(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy().copy()
    return tree


def counting_gathers(syncs, counts):
    """``fsdp.ShardedParams._gather_unit`` that appends to ``counts`` the
    number of blocks of ``syncs`` whose cuts are full after each gather."""
    orig = fsdp.ShardedParams._gather_unit

    def gather(self, unit):
        orig(self, unit)
        counts.append(sum(u.full for sp in syncs for u in sp.units if u.module is not None))

    return gather


def run_steps(case, group):
    cfg = PC.from_dict(case["cfg"])
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                             group=group, fsdp=case["fsdp"], fsdp_min_size=case["min_size"],
                             model_devices=case.get("model_devices"))
    state.load_state_dict(case["state"])
    draws = case.get("draws")
    step = make_train_step(cfg, device="cpu", group=group,
                           draws=(lambda s, codes, vectors: draws[s]) if draws else None)
    out = {"steps": [], "sharded": ([f"{side}.{name}" for side, opt in
                                     (("gen", state.gen_opt), ("disc", state.disc_opt))
                                     for name in opt.sync.sharded()] if case["fsdp"] else []),
           "tp_leaves": [f"gen.{name}" for name in state.gen_opt.sync.tp_leaves()]}
    counts = []
    gather = counting_gathers([state.gen_opt.sync, state.disc_opt.sync], counts)
    with torch.backends.mkldnn.flags(enabled=False):
        for batch in case["batches"]:
            local = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, group)
            orig, fsdp.ShardedParams._gather_unit = fsdp.ShardedParams._gather_unit, gather
            try:
                metrics = step(state, local)
            finally:
                fsdp.ShardedParams._gather_unit = orig
            sd = state.state_dict()
            out["steps"].append({"metrics": numpy_tree(metrics),
                                 "gen": numpy_tree(sd["gen"]), "disc": numpy_tree(sd["disc"])})
    out["max_full_blocks"] = max(counts, default=0)
    return out


def run_loop(case, group):
    from audiotokenization_tpu_torch.cli.train import make_loaders
    from audiotokenization_tpu_torch.train.loop import run_validation, train

    cfg = PC.from_dict(case["cfg"])
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    train_loader, val_loader, test_loader = make_loaders(cfg, process_index=rank,
                                                         process_count=n)
    state = train(cfg, train_loader=train_loader, val_loader=val_loader,
                  test_loader=test_loader, run_dir=case["run_dir"],
                  max_steps=case["max_steps"], device=case.get("model_devices", "cpu"))
    with state.gen_opt.gathered():
        val = run_validation(cfg, state.gen, val_loader, compute_stoi=False)
    return {"state": numpy_tree(state.state_dict()), "val": val,
            "batches": [len(train_loader), len(val_loader), len(test_loader)]}


def main(job_path, rank, world, init_method):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    group = dist.group.WORLD
    out = {"steps": {name: run_steps(case, group) for name, case in job.get("steps", {}).items()},
           "loops": {name: run_loop(case, group) for name, case in job.get("loops", {}).items()}}
    torch.save(out, Path(job_path).parent / f"out_{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
