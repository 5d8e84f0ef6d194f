"""The port's data-parallel training step (``train/step.py`` with a group,
``parallel/dp.py``) and FSDP (``parallel/fsdp.py``) on two gloo ranks
against the JAX package's ``jit_train_step`` over a 2-device data mesh
(conftest's virtual CPU devices), on one global batch from the same
weights.

One rank group serves every case of a file: two spawned workers
(``tests/_torch_dp_worker.py``, torch and the port only) run each case's
step on their halves of the global batch while this process compiles the
JAX steps in threads (``run_cases``, which tests/test_torch_dp_loop.py
shares). The JAX states hold the port's initial weights
(``test_torch_conformer_train.py::states``). fp32, AdamW eps 1 and no
warmup (``test_torch_train.py::smooth``), global batch 4 x 800 (2 rows a
rank). Here the tiny flagship (``__graft_entry__._tiny_config``,
factorized VQ, K1's path) three ways:

- ``plain``: data parallel;
- ``accum``: ``accumulate_grad_batches`` 2: each rank splits its own rows,
  so a micro-batch holds other rows than JAX's (the same function, summed
  in another order);
- ``fsdp``: ``train.fsdp`` over leaves of 256 elements or more, against
  JAX's ``fsdp=True`` step at ``fsdp_min_size`` 256;
and ``semantic``, the semantic codec (``concat_semantic``) on precomputed
teacher targets (the teacher replicated, the targets split with the rows).

Held: every metric within rtol 1e-4 / atol 1e-6 of JAX's, the codebook
histograms equal; every leaf's update by ``test_torch_train.py::
hold_update`` at 1e-3 (an EMA codebook's buffers within rtol 1e-4 / atol
1e-5), but on the flagship's rounding leaves. Those are picked on JAX's
side alone. JAX's one-device float64 step of the plain config is the
reference (its float32 islands pinned, as tests/test_torch_train64.py's
port-init check runs it; accumulation and FSDP compute the same
function). A leaf whose update in JAX's own fp32 step is more than
``ROUNDING_FLOOR`` x max |update| off it (a quarter of ``hold_update``'s
1e-3) is a sum that cancels in fp32 (ROADMAP Queue 3: here the encoder's
snake α/β, conv biases and one down-sampling weight, updates
~1e-10-1e-7). Such a leaf that misses ``hold_update`` is held by the
precision rule: its error against the float64 step no more than 2x the
worst error of JAX's own fp32 step over the rounding leaves (each less
twice the fp32 spacing, over its max |update|), a scale that must be
under ``ROUNDING_SCALE_MAX``. The reference and the scale are both
JAX's. The count of leaves held so, the worst and the scale are printed
(``-s``). Against the port's own one-process step on the global
batch every metric is within 1e-6 relative and the histograms equal; both
ranks return the same metrics and state bit for bit; FSDP's update holds
the data-parallel one's by ``hold_update``, and it sharded some leaves,
none under 256 elements, and gathered per block: at no gather of the
step were two blocks' cuts full at once (``parallel/fsdp.py``). In one
process over a gloo group of one, the per-block step with recomputation
gives the same state bit for bit with its backward run on another thread
(as autograd runs a CUDA backward) and every freed cut filled with NaN in
place of being freed, so a use of a freed cut cannot pass.
"""
import copy
import dataclasses
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.parallel.mesh import make_data_mesh, shard_batch
from audiotokenization_tpu.train.step import jit_train_step
from audiotokenization_tpu.train.step import make_train_step as jax_make_train_step
from audiotokenization_tpu_torch.train.step import make_train_step

from test_torch_conformer_train import MOE_KEYS, states
from test_torch_ema_vq import step_draws
from test_torch_semantic import semantic_tiny
from test_torch_semantic import spread as spread_semantic
from test_torch_train import KEYS, hold_update, jax_leaves, leaves, smooth
from test_torch_train64 import _f64_state, _worst_rel

WORKER = Path(__file__).parent / "_torch_dp_worker.py"
RANKS = 2
B, T = 4, 800
SELF_RTOL = 1e-6
FSDP_MIN_SIZE = 256  # JAX's dry run's: the tiny config's leaves are small
EMA_RTOL, EMA_ATOL = 1e-4, 1e-5
ROUNDING_FLOOR = 2.5e-4  # JAX's fp32 update this far off its float64 one: a rounding leaf
FP32_RATIO = 2.0  # the port's fp32 vs JAX float64, over JAX's fp32 vs JAX float64
ROUNDING_SCALE_MAX = 0.05  # JAX's own fp32 error on those leaves, x max |update|
FLOAT64 = {"plain": "plain", "accum": "plain", "fsdp": "plain"}  # case -> its float64 reference


def free_port() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return str(port)


def start_ranks(job: dict, tmp: Path):
    """Spawn the RANKS workers on ``job``; returns a function that waits for
    them and gives each rank's output."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(job, tmp / "job.pt")
    # a file store in the job's own dir: no probed port that another test's
    # ranks could take meanwhile
    init = (tmp / "rendezvous").as_uri()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(tmp / "job.pt"), str(r),
                               str(RANKS), init], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(RANKS)]

    def wait():
        logs = [p.communicate(timeout=600)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs), "\n---- rank ----\n".join(logs)
        return [torch.load(tmp / f"out_{r}.pt", weights_only=False) for r in range(RANKS)]

    return wait


def variants():
    """name -> (JAX config, seed, edit of the port's generator, the global
    batch, FSDP): the tiny flagship three ways on one batch, and the
    semantic codec."""
    wav = (np.random.RandomState(5).randn(B, T) * 0.1).astype(np.float32)
    plain = smooth(GE._tiny_config())
    plain.train.precision = "fp32"
    accum = copy.deepcopy(plain)
    accum.train.accumulate_grad_batches = 2
    target = np.random.RandomState(7).randn(B, 1024, T // 10).astype(np.float32)
    return {"plain": (plain, 0, None, {"wav": wav}, False),
            "accum": (accum, 0, None, {"wav": wav}, False),
            "fsdp": (plain, 0, None, {"wav": wav}, True),
            "semantic": (smooth(semantic_tiny(True)), 0, spread_semantic,
                         {"wav": wav, "semantic_target": target}, False)}


def jax_dp(jcfg, jstate, batch, fsdp=False):
    """JAX's data-mesh step (``fsdp``: its ZeRO-3 shardings of leaves of 256
    elements or more): (metrics, leaves before, leaves after)."""
    mesh = make_data_mesh(jax.devices()[:RANKS])
    before = jax_leaves(jstate)
    after, m = jit_train_step(jcfg, mesh, fsdp=fsdp, fsdp_min_size=FSDP_MIN_SIZE)(
        jstate, shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()}))
    return ({k: np.asarray(v) for k, v in m.items()}, before, jax_leaves(after))


def jax_f64(jcfg, jstate, batch):
    """JAX's one-device step in float64, its float32 islands pinned (the
    quantizer's parameters, the VQ, the STFTs): (metrics, leaves before,
    leaves after)."""
    with jax.enable_x64(True):
        state = _f64_state(jstate, jcfg, quantizer_f64=False)
        before = jax_leaves(state)
        after, m = jax.jit(jax_make_train_step(jcfg))(
            state, {k: jnp.asarray(v.astype(np.float64)) for k, v in batch.items()})
        return {k: np.asarray(v) for k, v in m.items()}, before, jax_leaves(after)


def run_cases(variants, tmp, extra_job=None, float64=()):
    """Every case of ``variants`` (name -> (JAX config, seed, edit, batch,
    fsdp)) on the ranks, in JAX (compiled in threads meanwhile) and in the
    port's one process. Returns per case (JAX, port one-process, rank 0,
    rank 1), each (metrics, leaves before, leaves after), the names FSDP
    sharded, and the ranks' outputs; the cases named in ``float64`` also
    give JAX's float64 step (``jax_f64``) under ``out["float64"]``."""
    torch.set_num_threads(1)
    cases, job = {}, {}
    for name, (jcfg, seed, edit, batch, fsdp) in variants.items():
        cfg, port, jstate = states(jcfg, seed, edit=edit)
        draws = None
        if jcfg.model.codec_decoder.quantizer == "ema_vq":  # the global batch's frames
            n_vectors = next(iter(batch.values())).shape[0] * T // 10
            draws = {0: step_draws(0, jcfg.model.codec_decoder.codebook_size, n_vectors)}
        job[name] = {"cfg": dataclasses.asdict(cfg), "state": copy.deepcopy(port.state_dict()),
                     "batches": [batch], "fsdp": fsdp, "min_size": FSDP_MIN_SIZE,
                     "draws": draws}
        cases[name] = (jcfg, cfg, port, jstate, batch, draws, fsdp)
    wait = start_ranks({"steps": job, **(extra_job or {})}, tmp)
    with ThreadPoolExecutor(len(cases) + len(float64)) as pool:
        f64 = {name: pool.submit(jax_f64, cases[name][0], cases[name][3], cases[name][4])
               for name in float64}
        futures = {name: pool.submit(jax_dp, jcfg, jstate, batch, fsdp)
                   for name, (jcfg, _, _, jstate, batch, _, fsdp) in cases.items()}
        port_side = {}
        for name, (_, cfg, port, _, batch, draws, _) in cases.items():
            port = copy.deepcopy(port)  # JAX's arrays may alias the port's weights
            before = leaves(port)
            with torch.backends.mkldnn.flags(enabled=False):
                m = make_train_step(cfg, device="cpu",
                                    draws=(lambda s, c, v, d=draws: d[s]) if draws else None)(
                    port, {k: torch.from_numpy(v) for k, v in batch.items()})
            port_side[name] = ({k: np.asarray(v) for k, v in m.items()}, before, leaves(port))
        jax_side = {name: f.result() for name, f in futures.items()}
        float64_side = {name: f.result() for name, f in f64.items()}
    outs = wait()
    out = {"float64": float64_side}
    for name in cases:
        ranks = []
        for o in outs:
            s = o["steps"][name]["steps"][0]
            after = {**{"gen." + k: v for k, v in s["gen"].items()},
                     **{"disc." + k: v for k, v in s["disc"].items()}}
            ranks.append((s["metrics"], port_side[name][1], after))
        out[name] = (jax_side[name], port_side[name], *ranks)
    sharded = {name: outs[0]["steps"][name]["sharded"] for name in cases}
    return out, sharded, outs


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out, sharded, outs = run_cases(variants(), tmp_path_factory.mktemp("dp"),
                                   float64=sorted(set(FLOAT64.values())))
    out["sharded"] = sharded["fsdp"]
    out["max_full_blocks"] = [o["steps"]["fsdp"]["max_full_blocks"] for o in outs]
    return out


def _only(side, names):
    metrics, before, after = side
    return metrics, {n: before[n] for n in names}, {n: after[n] for n in names}


def hold_against_jax(name, jax_side, port_side, float64=None):
    """The module docstring's holds, the rounding rule against ``float64``
    (JAX's float64 step; None: no leaf is held by it). Returns the leaves
    held by it with their errors, and the rule's scale."""
    (jm, jb, ja), (pm, pb, pa) = jax_side, port_side
    scale, rounding = None, set()
    if float64 is not None:
        rounding = {leaf for leaf in ja if _worst_rel(_only(jax_side, [leaf]),
                                                      _only(float64, [leaf])) > ROUNDING_FLOOR}
        scale = _worst_rel(_only(jax_side, rounding), _only(float64, rounding))
        assert scale < ROUNDING_SCALE_MAX, (
            f"{name}: JAX's own fp32 step is {scale:.3g} x max |update| off its float64 step")
    keys = KEYS + tuple(k for k in ("semantic_recon_loss", *MOE_KEYS) if k in jm)
    for key in keys:
        np.testing.assert_allclose(pm[key], jm[key], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{name}: {key}")
    np.testing.assert_array_equal(pm["codebook_hist"], jm["codebook_hist"])
    assert set(pm) == set(jm) and set(pa) == set(ja)
    by_rounding, bad = [], []
    for leaf in ja:
        if leaf.startswith("gen.quantizer.") and name == "ema":
            np.testing.assert_allclose(pa[leaf], ja[leaf], rtol=EMA_RTOL, atol=EMA_ATOL,
                                       err_msg=leaf)
        elif np.array_equal(ja[leaf], jb[leaf]):  # an update below the fp32 spacing
            np.testing.assert_array_equal(pa[leaf], pb[leaf], err_msg=leaf)
        else:
            try:
                hold_update(f"{name}: {leaf}", (pb[leaf], pa[leaf]), (jb[leaf], ja[leaf]))
                continue
            except AssertionError as e:
                if leaf not in rounding:
                    bad.append(str(e))
                    continue
            err = _worst_rel(_only(port_side, [leaf]), _only(float64, [leaf]))
            if err <= FP32_RATIO * scale:
                by_rounding.append((leaf, err))
            else:
                bad.append(f"{leaf}: the port's fp32 update is {err:.3g} x max |update| off "
                           f"JAX's float64 step, beyond 2x JAX's own fp32 step's {scale:.3g}")
    assert not bad, f"{name}: " + "; ".join(bad)
    return by_rounding, scale


def hold_ranks(name, one_process, rank0, rank1):
    """Against the port's one-process step: every metric within SELF_RTOL,
    the histograms equal; the two ranks equal bit for bit."""
    pm, _, pa = one_process
    for key in pm:
        if key == "codebook_hist":
            np.testing.assert_array_equal(rank0[0][key], pm[key])
        else:
            np.testing.assert_allclose(rank0[0][key], pm[key], rtol=SELF_RTOL, atol=0,
                                       err_msg=f"{name}: {key}")
    for key in rank0[0]:
        np.testing.assert_array_equal(rank0[0][key], rank1[0][key], err_msg=key)
    for leaf in rank0[2]:
        np.testing.assert_array_equal(rank0[2][leaf], rank1[2][leaf], err_msg=leaf)
    assert set(rank0[2]) == set(pa)


@pytest.mark.parametrize("name", ["plain", "accum", "fsdp", "semantic"])
def test_dp_step_matches_jax_data_mesh(results, name):
    jax_side, _, rank0, _ = results[name]
    held, scale = hold_against_jax(name, jax_side, rank0,
                                   results["float64"].get(FLOAT64.get(name)))
    if held:
        leaf, err = max(held, key=lambda h: h[1])
        print(f"{name}: {len(held)} of {len(rank0[2])} leaves held by the rounding rule, the "
              f"worst {leaf} {err:.3g} x max |update| off JAX's float64 step, JAX's own fp32 "
              f"step up to {scale:.3g} ({err / scale:.3g}x)")


@pytest.mark.parametrize("name", ["plain", "accum", "fsdp", "semantic"])
def test_dp_step_matches_the_one_process_step(results, name):
    hold_ranks(name, *results[name][1:])


def test_fsdp_matches_the_dp_step_and_shards(results):
    """FSDP's update against the data-parallel one (rank 0 of each), leaf by
    leaf (hold_update at 1e-3); some leaves sharded, the small ones not; one
    block's cuts full at a time on each rank."""
    _, (_, pb, _), (_, _, dp_after), _ = results["plain"]
    _, _, (_, _, fsdp_after), _ = results["fsdp"]
    for leaf in dp_after:
        if np.array_equal(dp_after[leaf], pb[leaf]):
            np.testing.assert_array_equal(fsdp_after[leaf], pb[leaf], err_msg=leaf)
        else:
            hold_update(leaf, (pb[leaf], fsdp_after[leaf]), (pb[leaf], dp_after[leaf]))
    sharded = set(results["sharded"])
    assert sharded and len(sharded) < len(dp_after) and sharded <= set(dp_after)
    assert all(pb[leaf].size >= FSDP_MIN_SIZE for leaf in sharded)
    assert results["max_full_blocks"] == [1] * RANKS, results["max_full_blocks"]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_fsdp_blocks_hold_on_the_backward_thread(monkeypatch, tmp_path, precision):
    import threading

    import torch.distributed as dist

    from audiotokenization_tpu_torch.parallel import dryrun, fsdp
    from audiotokenization_tpu_torch.train.state import init_train_state

    def poison(self, unit):
        for leaf in unit.leaves:
            if leaf.param.untyped_storage().nbytes():
                leaf.param.data.fill_(float("nan"))
        unit.full = False
        if fsdp._state.slot is unit:
            fsdp._state.slot = None

    backward = torch.Tensor.backward

    def on_another_thread(self, *args, **kwargs):
        errors = []

        def run():
            try:
                backward(self, *args, **kwargs)
            except BaseException as e:  # re-raised on the caller's thread
                errors.append(e)

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if errors:
            raise errors[0]

    torch.set_num_threads(1)
    cfg = dryrun.tiny_config()
    cfg.train.precision, cfg.train.remat = precision, True
    wav = torch.from_numpy((np.random.RandomState(3).randn(2, T) * 0.1).astype(np.float32))
    dist.init_process_group("gloo", init_method=(tmp_path / "rendezvous").as_uri(), rank=0,
                            world_size=1)
    try:
        after = []
        for patched in (False, True):
            state = init_train_state(cfg, generator=torch.Generator().manual_seed(0),
                                     device="cpu", group=dist.group.WORLD, fsdp=True,
                                     fsdp_min_size=FSDP_MIN_SIZE)
            assert state.gen_opt.sync.units and state.disc_opt.sync.units
            with monkeypatch.context() as m, torch.backends.mkldnn.flags(enabled=False):
                if patched:
                    m.setattr(fsdp.ShardedParams, "free", poison)
                    m.setattr(torch.Tensor, "backward", on_another_thread)
                make_train_step(cfg, device="cpu", group=dist.group.WORLD)(state, {"wav": wav})
            after.append(state.state_dict())
    finally:
        dist.destroy_process_group()
    for side in ("gen", "disc"):
        for k, v in after[0][side].items():
            np.testing.assert_array_equal(after[1][side][k].numpy(), v.numpy(), err_msg=k)
