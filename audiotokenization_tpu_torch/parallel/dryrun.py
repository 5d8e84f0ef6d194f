"""The multi-device dry run (counterpart of ``__graft_entry__.py::
dryrun_multichip``): the tiny flagship config through every parallel path
once, over ``n`` ranks.

    python -m audiotokenization_tpu_torch.parallel.dryrun --n 2 [--device cpu]

``dryrun_multichip(n, device)`` spawns ``n`` processes, one a rank, in a
process group on localhost (NCCL where there is a card a rank, else gloo,
which lets ranks share a card or run on the CPU), and each runs one step of:

- the plain VQ step (data parallel over the global batch);
- FSDP, asserting that some parameter is sharded;
- the EMA-codebook step, asserting that the codebook moved;
- the semantic step with an in-loop w2v-bert teacher, in bf16;
- a validation pass over the ranks' stripes of a batch list;
- gradient accumulation (two micro-batches a rank);
- the tiny Conformer's tensor-parallel step over two model devices (the
  rank's device twice), asserting that the TP leaves are held as cuts;
- expert parallelism: the MoE Conformer's step under TP 2, its router's
  aux losses finite;
- the pipeline-parallel step (2 + 2 layers over two stages), asserting
  that the stages' layers sit on the stages' devices;

and rank 0 then runs, in one process over ``n`` shards, the
sequence-parallel tokenize and synthesize of one utterance
(``parallel/sp.py``) and the anti-aliased codec's SP tokenize, the
Conformer's TP tokenize and PP tokenize (against one-device tokenize),
and the ragged Conformer tokenizer against per-file tokenize. Each check
raises on a non-finite loss or a broken promise; the run raises if a rank
fails.
"""
from __future__ import annotations

import argparse
import copy
import os
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config


def tiny_config() -> Config:
    """The JAX package's ``__graft_entry__._tiny_config`` (fp32 added, as
    its tests train it): a 2-stride BigCodec at hop 10, 64 codes of 8 dims,
    small discriminators."""
    cfg = Config()
    cfg.train.precision = "fp32"
    e = cfg.model.codec_encoder
    e.ngf, e.out_channels, e.up_ratios, e.rnn_num_layers = 4, 32, (2, 5), 1
    d = cfg.model.codec_decoder
    d.in_channels, d.upsample_initial_channel, d.up_ratios, d.rnn_num_layers = 32, 16, (5, 2), 1
    d.codebook_size, d.codebook_dim = 64, 8
    cfg.model.mpd.periods, cfg.model.mpd.channels = (2, 3), 4
    cfg.model.mpd.max_downsample_channels = 16
    s = cfg.model.mstft
    s.stft_params.fft_sizes, s.stft_params.hop_sizes = (128, 256), (32, 64)
    s.stft_params.win_lengths = (128, 256)
    s.channels, s.max_downsample_channels = 4, 16
    return cfg


def tiny_conformer_config() -> Config:
    """The JAX package's ``__graft_entry__._tiny_conformer_config``: one
    layer a side of dim 32, 4 heads, hop 40, 64 codes of 8 dims."""
    cfg = tiny_config()
    for m in (cfg.model.codec_encoder, cfg.model.codec_decoder):
        m.hop_length, m.n_fft, m.window_size = 40, 160, 160
        m.dim, m.n_layers, m.n_head, m.rope_theta = 32, 1, 4, 500.0
    cfg.model.codec_encoder.type, cfg.model.codec_encoder.out_channels = "conformer_stft", 32
    cfg.model.codec_decoder.type, cfg.model.codec_decoder.in_channels = "conformer_istft", 32
    s = cfg.model.mstft
    s.stft_params.fft_sizes, s.stft_params.hop_sizes, s.stft_params.win_lengths = (
        (128,), (32,), (128,))
    return cfg


def _finite(metrics, key="gen_loss"):
    value = float(metrics[key])
    if not np.isfinite(value):
        raise RuntimeError(f"dry run: {key} is {value}")
    return value


def _rank_checks(device: torch.device, group, n: int) -> dict:
    """One rank's steps (module docstring); returns their losses."""
    from ..models.w2v_bert import init_w2v_bert, teacher_config
    from .mesh import shard_batch
    from ..train.loop import run_validation
    from ..train.state import init_train_state
    from ..train.step import make_train_step

    out = {}
    wav = torch.from_numpy((np.random.RandomState(0).randn(2 * n, 800) * 0.1)
                           .astype(np.float32))
    local = {k: v.to(device) for k, v in shard_batch({"wav": wav}, group).items()}

    def state_of(cfg, seed, **kw):
        return init_train_state(cfg, generator=torch.Generator().manual_seed(seed),
                                device=device, group=group, **kw)

    cfg = tiny_config()
    state = state_of(cfg, 0, fsdp=False)
    out["plain"] = _finite(make_train_step(cfg, device=device, group=group)(state, local))

    fsdp = state_of(cfg, 0, fsdp=True, fsdp_min_size=256)
    if not (fsdp.gen_opt.sync.sharded() or fsdp.disc_opt.sync.sharded()):
        raise RuntimeError("dry run: FSDP left every parameter replicated")
    out["fsdp"] = _finite(make_train_step(cfg, device=device, group=group)(fsdp, local))

    cfg_e = tiny_config()
    cfg_e.model.codec_decoder.quantizer = "ema_vq"
    ema = state_of(cfg_e, 1, fsdp=False)
    embed0 = ema.gen.quantizer.embed.clone()
    out["ema"] = _finite(make_train_step(cfg_e, device=device, group=group)(ema, local))
    if torch.equal(ema.gen.quantizer.embed, embed0):
        raise RuntimeError("dry run: the EMA codebook did not move in the data-parallel step")

    cfg_s = tiny_config()
    t = cfg_s.train
    t.use_semantic, t.precision = True, "bf16"
    t.teacher_layers, t.teacher_heads, t.teacher_intermediate, t.teacher_layer = 1, 4, 64, 1
    teacher = init_w2v_bert(teacher_config(cfg_s), generator=torch.Generator().manual_seed(2),
                            device=device)
    feats = torch.from_numpy(np.random.RandomState(2).randn(2 * n, 4, 160).astype(np.float32))
    sem_batch = {k: v.to(device) for k, v in shard_batch({"wav": wav, "feats": feats},
                                                         group).items()}
    sem = state_of(cfg_s, 3, fsdp=False)
    out["semantic"] = _finite(make_train_step(cfg_s, device=device, group=group)(
        sem, sem_batch, teacher), "semantic_recon_loss")

    cfg_a = tiny_config()
    cfg_a.train.accumulate_grad_batches = 2
    out["accumulate"] = _finite(make_train_step(cfg_a, device=device, group=group)(
        state_of(cfg_a, 4, fsdp=False), local))
    out.update(_model_axis_checks(device, group, local, state_of))

    rank = dist.get_rank(group) if group is not None else 0
    batches = [{"wav": wav[i:i + 2], "lengths": torch.full((2,), 800)}
               for i in range(0, 2 * n, 2)][rank::n]  # this rank's stripe of the list
    val = run_validation(cfg, state.gen, batches, compute_stoi=False)
    out["val_si_snr"] = float(val["val_si_snr"])
    if not np.isfinite(out["val_si_snr"]):
        raise RuntimeError("dry run: validation gave a non-finite SI-SNR")
    return out


def _model_axis_checks(device, group, local, state_of) -> dict:
    """One rank's tensor-, expert- and pipeline-parallel steps over two
    model devices (the rank's device twice)."""
    from ..train.step import make_train_step

    out = {}
    cfg_t = tiny_conformer_config()
    cfg_t.train.tensor_parallel = 2
    tp = state_of(cfg_t, 6, fsdp=False, model_devices=[device] * 2)
    if not tp.gen_opt.sync.tp_leaves():
        raise RuntimeError("dry run: TP left the FFN replicated")
    out["tp"] = _finite(make_train_step(cfg_t, device=device, group=group)(tp, local))

    cfg_m = tiny_conformer_config()
    cfg_m.train.tensor_parallel = 2
    e = cfg_m.model.codec_encoder
    e.ffn_type, e.moe_experts, e.moe_capacity_factor = "moe", 4, 2.0
    ep = state_of(cfg_m, 8, fsdp=False, model_devices=[device] * 2)
    m = make_train_step(cfg_m, device=device, group=group)(ep, local)
    out["ep"] = _finite(m)
    out["ep_load_balance"] = _finite(m, "moe_load_balance")

    cfg_p = tiny_conformer_config()
    cfg_p.model.codec_encoder.n_layers = cfg_p.model.codec_decoder.n_layers = 2
    cfg_p.train.pipeline_parallel = 2
    stages = [torch.device(device)] * 2
    pp = state_of(cfg_p, 9, fsdp=False, model_devices=stages)
    placed = [next(layer.parameters()).device for layer in pp.gen.encoder.backbone.layers]
    if placed != [torch.device(d) for d in stages]:
        raise RuntimeError(f"dry run: the PP stages' layers sit on {placed}")
    out["pp"] = _finite(make_train_step(cfg_p, device=device, group=group)(pp, local))
    return out


def _serving_checks(device: torch.device, n: int) -> dict:
    """The anti-aliased SP tokenize, the Conformer's TP and PP tokenize and
    the ragged Conformer tokenizer, in one process over n shards."""
    from ..models import codec as C
    from ..utils.ragged import make_ragged_tokenizer
    from .pp import make_pipe_mesh, pp_tokenize
    from .sp import make_sp_tokenizer
    from .tp import make_dp_tp_mesh, tp_tokenize

    out = {}
    cfg_aa = tiny_config()
    cfg_aa.model.codec_encoder.antialias = True
    aa = C.init_codec(cfg_aa, generator=torch.Generator().manual_seed(5), device=device)
    wav1 = torch.from_numpy((np.random.RandomState(1).randn(n * 400) * 0.1)
                            .astype(np.float32)).to(device)
    codes = make_sp_tokenizer(cfg_aa, [device] * n, chunk_quantum_seconds=0.025,
                              device=device.type)(aa, wav1)
    if codes.shape[-1] != n * 400 // 10:
        raise RuntimeError(f"dry run: the anti-aliased SP tokenize gave {codes.shape[-1]} frames")
    out["sp_antialias_frames"] = int(codes.shape[-1])

    cfg = tiny_conformer_config()
    cfg.model.codec_encoder.n_layers = 2
    codec = C.init_codec(cfg, generator=torch.Generator().manual_seed(7), device=device)
    wav = torch.from_numpy((np.random.RandomState(4).randn(4, 800) * 0.1)
                           .astype(np.float32)).to(device)
    with torch.no_grad():
        ref = C.tokenize(codec, wav, mode="conformant")
    tp_codes = tp_tokenize(codec, cfg, make_dp_tp_mesh(2, [device] * 2))(wav)
    if tp_codes.shape[1] != wav.shape[0]:
        raise RuntimeError(f"dry run: TP tokenize gave {tp_codes.shape[1]} rows")
    pp_codes = pp_tokenize(codec, cfg, make_pipe_mesh(2, [device] * 2))(wav)
    if not torch.equal(pp_codes, ref):
        raise RuntimeError("dry run: pipeline tokenize diverged from sequential")

    cfg_r = tiny_conformer_config()
    ragged_codec = C.init_codec(cfg_r, generator=torch.Generator().manual_seed(10),
                                device=device)
    lens = [280, 400]
    wavs = torch.zeros((2, 400))
    rng = np.random.RandomState(7)
    for i, ln in enumerate(lens):
        wavs[i, :ln] = torch.from_numpy((rng.randn(ln) * 0.1).astype(np.float32))
    got = make_ragged_tokenizer(cfg_r, device=device)(ragged_codec, wavs.to(device),
                                                      torch.tensor(lens))
    with torch.no_grad():
        one = C.tokenize(ragged_codec, wavs[:1, :280].to(device), mode="conformant")
    if not torch.equal(one[:, 0], got[:, 0, :280 // 40]):
        raise RuntimeError("dry run: ragged conformer tokens diverged from per-file")
    out.update(tp_rows=int(tp_codes.shape[1]), pp_frames=int(pp_codes.shape[-1]),
               ragged_frames=280 // 40)
    return out


def _sp_checks(device: torch.device, n: int) -> dict:
    """The sequence-parallel tokenize and synthesize (parallel/sp.py) over n shards."""
    from ..models.codec import init_codec
    from .sp import make_sp_synthesizer, make_sp_tokenizer

    cfg = tiny_config()
    codec = init_codec(cfg, generator=torch.Generator().manual_seed(0), device=device)
    devices = [device] * n
    wav = torch.from_numpy((np.random.RandomState(1).randn(n * 400) * 0.1)
                           .astype(np.float32)).to(device)
    codes = make_sp_tokenizer(cfg, devices, chunk_quantum_seconds=0.025,
                              device=device.type)(codec, wav)
    if codes.shape[-1] != n * 400 // 10:
        raise RuntimeError(f"dry run: SP tokenize gave {codes.shape[-1]} frames")
    syn = make_sp_synthesizer(cfg, devices, chunk_quantum_frames=40, device=device.type)
    wav2 = syn(codec, codes)
    if wav2.shape[-1] != codes.shape[-1] * 10:
        raise RuntimeError(f"dry run: SP synthesize gave {wav2.shape[-1]} samples")
    return {"sp_frames": int(codes.shape[-1]), "sp_samples": int(wav2.shape[-1])}


def _rank_main(rank: int, n: int, device: str, init_method: str, backend: str, results):
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n)
    try:
        out = _rank_checks(dev, dist.group.WORLD, n)
        if rank == 0:
            out.update(_sp_checks(dev, n))
            out.update(_serving_checks(dev, n))
        results[rank] = out
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the dry run over ``n_devices`` ranks (module docstring); returns
    rank 0's results. Raises without a card unless ``device="cpu"``."""
    import torch.multiprocessing as mp

    from ..models.codec import resolve_device

    device = resolve_device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = "nccl" if device.type == "cuda" and cards >= n_devices else "gloo"
    # the ranks meet at a file store: no probed port that another process
    # could take before rank 0 binds it
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp, mp.Manager() as manager:
        results = manager.dict()
        init = (Path(tmp) / "rendezvous").as_uri()
        mp.spawn(_rank_main, args=(n_devices, device.type, init, backend, results),
                 nprocs=n_devices, join=True)
        out = copy.deepcopy(dict(results))
    if sorted(out) != list(range(n_devices)):
        raise RuntimeError(f"dry run: ranks {sorted(out)} of {n_devices} reported")
    return {"backend": backend, **out[0]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    print(dryrun_multichip(args.n, args.device))


if __name__ == "__main__":
    main()
