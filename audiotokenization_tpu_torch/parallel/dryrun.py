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

and rank 0 then runs the sequence-parallel tokenize and synthesize of
one utterance over ``n`` shards (``parallel/sp.py``, one process). Each
check raises on a non-finite loss or a broken promise; the run raises if a
rank fails.
"""
from __future__ import annotations

import argparse
import copy
import os
import socket

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

    rank = dist.get_rank(group) if group is not None else 0
    batches = [{"wav": wav[i:i + 2], "lengths": torch.full((2,), 800)}
               for i in range(0, 2 * n, 2)][rank::n]  # this rank's stripe of the list
    val = run_validation(cfg, state.gen, batches, compute_stoi=False)
    out["val_si_snr"] = float(val["val_si_snr"])
    if not np.isfinite(out["val_si_snr"]):
        raise RuntimeError("dry run: validation gave a non-finite SI-SNR")
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


def _rank_main(rank: int, n: int, device: str, port: int, backend: str, results):
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=n)
    try:
        out = _rank_checks(dev, dist.group.WORLD, n)
        if rank == 0:
            out.update(_sp_checks(dev, n))
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
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with mp.Manager() as manager:
        results = manager.dict()
        mp.spawn(_rank_main, args=(n_devices, device.type, port, backend, results),
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
