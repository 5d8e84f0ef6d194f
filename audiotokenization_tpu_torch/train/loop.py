"""The training loop (counterpart of ``audiotokenization_tpu/train/loop.py``
on one card): the GAN step of ``train/step.py`` over the loader's batches,
with periodic validation (reconstruction metrics and codebook statistics),
asynchronous checkpoints (rolling window plus the best on ``mel_loss``),
``metrics.jsonl`` logging, and a full-length test pass at the end through
the ragged codec.

Between log, validation and checkpoint steps the loop reads nothing back
from the card: the step's metrics and the codebook histogram stay on the
device until a log step. Batches arrive in pinned memory and upload with
``non_blocking=True``. The generator stays in ``train()`` mode throughout
(cuDNN's LSTM has no backward in eval mode, and nothing else differs);
validation and the test pass run under ``torch.no_grad()``.

A semantic codec trains with the frozen w2v-bert ``teacher`` passed to
``train`` (its batches carry the teacher's input ``feats``), or on
precomputed ``semantic_target`` batches; validation logs
``val_semantic_recon_loss``. Under ``concat_semantic`` the test pass runs
the teacher per file (``make_test_teacher``), and without a teacher it
is skipped with a ``test_skipped_concat_semantic`` marker, as in JAX.

Data parallelism and FSDP run one process per rank (``torchrun``; the
group from ``parallel/mesh.py::initialize_distributed``): each rank steps
on its loader's stripe (``train/step.py`` with the group; ``train.fsdp``
shards the weights and moments, ``parallel/fsdp.py``), the validation and
test passes run on the stripes and sum their aggregates over the ranks
(``reduce_validation_aggregates``), and rank 0 alone logs, dumps the
validation artifacts and writes the checkpoints, which every rank restores
from. Tensor parallelism (``train.tensor_parallel``, the MoE's experts
split with it) and pipeline parallelism (``train.pipeline_parallel``) take
a list of model devices (the model axis, in this process; a device may
repeat) and compose with the data axis of a ``torchrun`` launch, TP also
with FSDP; the state is placed on them before any restore, the refusals
are the JAX loop's, validation and the test pass give the one-device
numbers, and the checkpoints keep the one-card layout, so a TP or PP run
resumes on one device and the other way round. As in the JAX loop, a
resumed run restarts the loader at its first epoch.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import Config, codec_hop
from ..models import codec as C
from ..utils.logging import MetricsLogger
from . import metrics as M
from .checkpoint import CheckpointManager, restore_train_state
from .state import init_train_state
from .step import make_train_step


def _placement(cfg: Config, device):
    """(the device, the group, the model devices): the rank's card (or the
    CPU), the data-parallel group of a multi-process launch (None in one
    process), and under tensor or pipeline parallelism ``device``'s list of
    model devices (else None), with the JAX loop's refusals. Without a
    model axis a device list of more than one raises (one process per rank,
    under ``torchrun``)."""
    from ..parallel.mesh import local_device, process_count, process_group
    from .state import model_axis

    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    kind, n = model_axis(cfg)
    if kind is None and len(devices) != 1:
        raise NotImplementedError(
            f"the loop runs one device a process, {len(devices)} were requested: launch "
            "one process per device (torchrun) for data parallelism or FSDP")
    group = process_group()
    devices = [C.resolve_device(d) for d in devices]  # raises without a card unless the CPU
    if group is not None:
        devices = [local_device(d) for d in devices]
    if kind is None:
        return devices[0], group, None
    knob = "tensor_parallel" if kind == "tp" else "pipeline_parallel"
    n_dev = len(devices)
    if n_dev == 1:
        raise ValueError(
            f"train.{knob}={n} requires >1 devices (have {n_dev}); set {knob}: 1 to run "
            "unsharded")
    if kind == "pp" and cfg.train.fsdp:
        raise ValueError("fsdp + pipeline_parallel is not composed "
                         "yet; pick one memory axis")
    if n_dev % n:
        raise ValueError(f"train.{knob}={n} does not divide the {n_dev} attached devices")
    if n_dev != n:
        raise ValueError(f"the data axis is the processes of a torchrun launch: pass the "
                         f"{n} model devices of this one, not {n_dev}")
    global_bs = cfg.dataset.train.batch_size * process_count()
    d_axis = process_count()
    if kind == "pp":
        from ..parallel.pp import validate_pp

        validate_pp(cfg, n)
        n_micro = int(cfg.train.pipeline_microbatches) or n
        if global_bs % n_micro or (global_bs // n_micro) % max(d_axis, 1):
            raise ValueError(
                f"global batch {global_bs} must split into "
                f"{n_micro} microbatches x the {d_axis}-way data axis "
                f"(pipeline_parallel={n})")
    else:
        from ..parallel.tp import validate_tp

        validate_tp(cfg, n)
        if global_bs % d_axis:
            raise ValueError(
                f"global batch {global_bs} not divisible by the "
                f"{d_axis}-way data axis (tensor_parallel={n})")
    return devices[0], group, devices


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


BATCH_KEYS = ("wav", "feats", "semantic_target")  # what a step or eval forward reads


def _to_device(batch, device) -> dict:
    return {k: batch[k].to(device, non_blocking=True) for k in BATCH_KEYS if k in batch}


def make_eval_step(cfg: Config):
    """``eval_step(gen, batch, teacher=None)`` -> the validation metrics of
    one batch, on the device: SI-SNR, SI-SDR, the codebook histogram, both
    waveforms and a semantic codec's ``semantic_recon_loss``."""
    codebook_size = cfg.model.codec_decoder.codebook_size

    def eval_step(gen, batch, teacher=None):
        with torch.no_grad():
            out = C.forward(gen, batch, training=False, teacher=teacher)
            y, y_ = out.gt_wav[:, 0, :], out.gen_wav[:, 0, :]
            res = {"si_snr": M.si_snr(y_, y), "si_sdr": M.si_sdr(y_, y),
                   "codebook_hist": M.codebook_histogram(out.vq_code, codebook_size),
                   "gen_wav": out.gen_wav, "gt_wav": out.gt_wav}
            if out.semantic_recon_loss is not None:
                res["semantic_recon_loss"] = out.semantic_recon_loss
            return res

    return eval_step


def run_validation(cfg: Config, gen, val_loader, *, compute_stoi: bool = True,
                   max_batches: Optional[int] = None, artifact_dir: Optional[str] = None,
                   step: int = 0, eval_step=None, timings: Optional[dict] = None,
                   teacher=None):
    """Validation pass over fixed-length batches. STOI and PESQ run on a
    seeded random subset of ``quality_metric_items`` items per batch, as in
    the JAX loop. With ``artifact_dir``, writes the first item of each
    batch in ``cfg.dataset.val.log_idxs`` (original and reconstruction) as
    wavs. ``timings``, when given, accumulates the seconds spent in the
    device forward (up to the metrics on the host) as ``forward_s`` and in
    STOI/PESQ as ``quality_s``. ``teacher``: a semantic codec's, for
    batches that carry ``feats``."""
    from ..parallel.mesh import process_index

    eval_step = eval_step if eval_step is not None else make_eval_step(cfg)
    device = _device_of(gen)
    rank = process_index()
    sr = cfg.dataset.sample_rate
    agg = {"si_snr": [], "si_sdr": [], "stoi": [], "pesq": [], "quality_items": [],
           "semantic_recon_loss": []}
    hist = None
    log_idxs = set(cfg.dataset.val.log_idxs or ())
    forward_s = quality_s = 0.0
    for i, batch in enumerate(val_loader):
        if max_batches is not None and i >= max_batches:
            break
        if len(set(batch["lengths"].tolist())) > 1:
            # no masking in the fixed-crop forward: zero tails would skew the
            # metrics; full-length evaluation is run_test's ragged path
            raise ValueError(
                "run_validation got a ragged batch (unequal lengths); use a "
                "fixed min_audio_length val split or run_test's ragged path")
        t0 = time.perf_counter()
        out = eval_step(gen, _to_device(batch, device), teacher)
        agg["si_snr"].append(float(out["si_snr"]))
        agg["si_sdr"].append(float(out["si_sdr"]))
        if "semantic_recon_loss" in out:
            agg["semantic_recon_loss"].append(float(out["semantic_recon_loss"]))
        hist = out["codebook_hist"] if hist is None else hist + out["codebook_hist"]
        dump = artifact_dir is not None and i in log_idxs and rank == 0
        if compute_stoi or dump:
            gt = out["gt_wav"][:, 0].float().cpu().numpy()
            est = out["gen_wav"][:, 0].float().cpu().numpy()
        t1 = time.perf_counter()
        if dump:
            _dump_val_artifacts(artifact_dir, i, step, gt[0], est[0], sr)
        if compute_stoi:
            cap = cfg.dataset.val.quality_metric_items
            if cap >= len(gt):
                idxs = range(len(gt))
            else:
                seed = ((int(step or 0) << 10) ^ i) & 0xFFFFFFFF
                idxs = np.random.RandomState(seed).choice(len(gt), cap, replace=False)
            for j in idxs:
                agg["quality_items"].append(1.0)
                s = M.stoi(gt[j], est[j], sr)
                if np.isfinite(s):
                    agg["stoi"].append(s)
                p = M.pesq_metric(gt[j], est[j], sr)
                if p is not None:
                    agg["pesq"].append(p)
        forward_s += t1 - t0
        quality_s += time.perf_counter() - t1
    if timings is not None:
        timings["forward_s"] = timings.get("forward_s", 0.0) + forward_s
        timings["quality_s"] = timings.get("quality_s", 0.0) + quality_s
    return _finalize_validation(
        agg, None if hist is None else hist.double().cpu().numpy(),
        cfg.model.codec_decoder.codebook_size)


def _finalize_validation(agg, hist, codebook_size):
    """Means of the aggregates, ``val_``-prefixed, through the (sum, count)
    vector that ``reduce_validation_aggregates`` reduces; the STOI/PESQ
    subsample size as ``val_quality_items_used``; perplexity and
    utilization of the summed histogram (numpy, or None when no batch)."""
    keys = sorted(agg)
    local = np.concatenate([
        np.asarray([np.sum(agg[k]) if agg[k] else 0.0 for k in keys], np.float64),
        np.asarray([len(agg[k]) for k in keys], np.float64),
        np.zeros(codebook_size, np.float64) if hist is None else np.asarray(hist, np.float64),
    ])
    total = reduce_validation_aggregates(local)
    sums, counts = total[:len(keys)], total[len(keys):2 * len(keys)]
    results = {f"val_{k}": float(sums[i] / counts[i])
               for i, k in enumerate(keys) if counts[i] > 0 and k != "quality_items"}
    if "val_pesq" in results:
        results["val_pesq_impl"] = M.pesq_impl()  # which calibration made the number
    if "quality_items" in keys and counts[keys.index("quality_items")] > 0:
        results["val_quality_items_used"] = float(counts[keys.index("quality_items")])
    h = torch.from_numpy(total[2 * len(keys):]).float()
    if float(h.sum()) > 0:
        results["val_codebook_perplexity"] = float(M.perplexity_from_histogram(h))
        results["val_codebook_utilization"] = float(M.utilization_from_histogram(h))
    return results


def reduce_validation_aggregates(local: np.ndarray, group=None) -> np.ndarray:
    """The sum of the aggregate vector over the ranks (``group``, by default
    the process group; the identity in one process), in float64: every rank
    reports the same metrics. Its length never depends on the batches a
    rank saw, so a rank whose stripe gave none still joins."""
    from ..parallel import dp
    from ..parallel.mesh import process_group

    group = process_group() if group is None else group
    if group is None:
        return local
    t = torch.from_numpy(np.ascontiguousarray(local, np.float64)).to(dp.collective_device(group))
    torch.distributed.all_reduce(t, group=group)
    return t.cpu().numpy()


def _dump_val_artifacts(artifact_dir, batch_idx, step, gt, gen, sr):
    """The original and reconstructed wavs of one validation item, and their
    mel spectrograms as a PNG (skipped without matplotlib)."""
    from ..cli.inference_full import _save_spectrogram_png
    from ..data.audio_io import write_wav

    d = Path(artifact_dir) / f"val_batch_{batch_idx}"
    d.mkdir(parents=True, exist_ok=True)
    write_wav(d / f"step{step}_original.wav", gt, sr)
    write_wav(d / f"step{step}_reconstructed.wav", gen, sr)
    _save_spectrogram_png(d / f"step{step}_spec.png", gt, gen, sr)


def make_test_teacher(cfg: Config):
    """The teacher's per-file targets for the ``concat_semantic`` test pass:
    ``compute(teacher, w, plen, hop)`` -> (1, 1024, plen // hop) on the
    teacher's device, for a file w (T,) zero-padded to plen samples. The
    features are the host fbank of the file alone (its own ±160-sample
    pad), zero-padded to the bucket's frame count; the teacher masks the
    pad keys (``valid_frames``), at the precision the codec evaluates in,
    and its output is zeroed past the file's frames, the zero padding to
    Tf that the reference applies."""
    from ..models.semantic import teacher_target
    from ..ops.fbank import feature_frames, w2v_bert_features_from_clip

    layer = cfg.train.teacher_layer

    def compute(teacher, w, plen, hop):
        device = _device_of(teacher)
        f = w2v_bert_features_from_clip(np.asarray(w))  # (nf_file, 160)
        nfb = feature_frames(plen)  # the bucket's frames: one shape per bucket
        n = min(len(f), nfb)
        feats = torch.zeros((1, nfb, 160))
        feats[0, :n] = torch.from_numpy(f[:n])
        with torch.no_grad(), C.precision_scope(cfg):
            return teacher_target(teacher, feats.to(device), plen // hop, layer,
                                  valid_frames=torch.tensor([n], device=device)).float()

    return compute


def run_test(cfg: Config, gen, test_loader, *, max_batches: Optional[int] = None,
             teacher=None):
    """Full-length test pass over a batch-1 loader: each file zero-padded
    to a whole number of seconds and run through the ragged codec
    (``utils/ragged.py``), metrics on its own length. Returns
    ``test_``-prefixed metrics. A ``concat_semantic`` codec quantizes the
    teacher's output too: its ``teacher`` runs per file
    (``make_test_teacher``); without one the pass is skipped and returns
    ``{"test_skipped_concat_semantic": 1.0}``. A codec with no exact ragged
    path (the MoE Conformer) skips it with
    ``{"test_skipped_ragged_unavailable": 1.0}``."""
    from ..utils.ragged import make_ragged_codec

    teacher_fwd = None
    if cfg.train.use_semantic and cfg.train.concat_semantic:
        if teacher is None:
            # an explicit marker: an unattended run must not read "no teacher,
            # phase skipped" as "the test phase ran clean"
            print("[test] concat_semantic quantizes concat(teacher, latents) "
                  "and no w2v-bert teacher is loaded — skipping the test "
                  "phase (pass teacher / --w2v_bert_path)")
            return {"test_skipped_concat_semantic": 1.0}
        teacher_fwd = make_test_teacher(cfg)
    sr = cfg.dataset.sample_rate
    hop = codec_hop(cfg)
    quantum = max(sr // hop * hop, hop)
    try:
        ragged = make_ragged_codec(cfg, device=_device_of(gen))
    except NotImplementedError as exc:
        # a family with no exact ragged path (the MoE Conformer: capacity
        # routing is batch-global): an explicit marker, as in JAX, not a crash
        # at the end of a long run (cli/inference_full evaluates per file)
        print(f"[test] ragged full-length path unavailable ({exc}); skipping the test phase")
        return {"test_skipped_ragged_unavailable": 1.0}
    agg = {"si_snr": [], "si_sdr": [], "stoi": [], "pesq": []}
    hist = np.zeros(cfg.model.codec_decoder.codebook_size, np.int64)
    for i, batch in enumerate(test_loader):
        if max_batches is not None and i >= max_batches:
            break
        w = batch["wav"][0].numpy()
        wav = torch.zeros((1, -(-len(w) // quantum) * quantum))
        wav[0, :len(w)] = torch.from_numpy(w)
        sem_t = None if teacher_fwd is None else teacher_fwd(teacher, w, wav.shape[1], hop)
        recon, codes = ragged(gen, wav, torch.tensor([len(w)]), sem_t)
        est = recon[0, :len(w)].float().cpu().numpy()
        np.add.at(hist, codes[:, 0, :len(w) // hop].cpu().numpy().reshape(-1), 1)
        e, t = torch.from_numpy(est)[None], torch.from_numpy(w)[None]
        agg["si_snr"].append(float(M.si_snr(e, t)))
        agg["si_sdr"].append(float(M.si_sdr(e, t)))
        s = M.stoi(w, est, sr)
        if np.isfinite(s):
            agg["stoi"].append(s)
        p = M.pesq_metric(w, est, sr)
        if p is not None:
            agg["pesq"].append(p)
    res = _finalize_validation(agg, hist, cfg.model.codec_decoder.codebook_size)
    return {k.replace("val_", "test_"): v for k, v in res.items()}


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def train(cfg: Config, *, train_loader, val_loader=None, test_loader=None, run_dir: str,
          max_steps: Optional[int] = None, logger: Optional[MetricsLogger] = None,
          profile_steps: Optional[tuple] = None, resume_from: Optional[str] = None,
          resume_best: bool = False, device="cuda", teacher=None):
    """Train until ``max_steps`` (default ``cfg.train.max_steps``) and return
    the ``TrainState``.

    The state starts from ``cfg.train.seed``, then from ``resume_from``'s
    checkpoint (its best with ``resume_best``) or else ``run_dir``'s latest.
    Before the first step, ``num_sanity_val_steps`` validation batches run
    (metrics discarded, a ``sanity_val_ok`` line). Every
    ``log_every_n_steps`` steps the metrics are logged with
    ``steps_per_sec`` over the steps since the last log (host time between
    two device syncs); every ``val_every_n_steps`` a validation pass is
    logged with ``val_forward_s`` and ``val_quality_s``; every
    ``checkpoint_every_n_steps`` and at ``max_steps`` a checkpoint is saved
    and ``ckpt_stall_ms`` and ``ckpt_bytes`` logged. Then the test pass over
    ``test_loader``, if given. ``profile_steps=(start, stop)`` writes a
    ``torch.profiler`` trace of those steps to ``<run_dir>/profile``.
    ``teacher``: a semantic codec's frozen w2v-bert, for the step, the
    validation and the test pass (never checkpointed). Raises without a
    card unless ``device="cpu"``.

    Under ``torchrun`` (a process group made, ``parallel/mesh.py::
    initialize_distributed``) each rank trains on its loaders' stripes
    (``DataLoader(process_index=, process_count=)``) on ``cuda:LOCAL_RANK``
    (module docstring); ``train.fsdp`` shards the state. With
    ``train.tensor_parallel`` or ``train.pipeline_parallel`` N, ``device``
    is the list of N model devices (``[cuda:0] * N`` on one card).
    """
    device, group, model_devices = _placement(cfg, device)
    t = cfg.train
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(t.seed), device=device,
                             group=group, model_devices=model_devices)
    ckpt = CheckpointManager(run_dir, cfg, group=group)
    if resume_from is not None:
        restore_train_state(resume_from, state, best=resume_best)
    elif ckpt.latest_step() is not None:
        ckpt.restore(state)
    # a logger made here is closed here; the caller's stays open
    with (contextlib.nullcontext(logger) if logger is not None
          else MetricsLogger(run_dir, run_name=cfg.name, use_wandb=False)) as logger:
        return _train(cfg, state, ckpt, logger, train_loader=train_loader,
                      val_loader=val_loader, test_loader=test_loader, run_dir=run_dir,
                      max_steps=max_steps, profile_steps=profile_steps, device=device,
                      teacher=teacher, group=group)


def _train(cfg: Config, state, ckpt: CheckpointManager, logger: MetricsLogger, *,
           train_loader, val_loader, test_loader, run_dir, max_steps, profile_steps, device,
           teacher, group=None):
    """The loop of ``train`` from a restored state."""
    t = cfg.train
    step_fn = make_train_step(cfg, device=device, group=group)
    gen_weights = state.gen_opt.gathered  # FSDP: the generator's full weights for an eval pass
    eval_step = make_eval_step(cfg) if val_loader is not None else None
    max_steps = max_steps if max_steps is not None else t.max_steps

    step = state.step
    if step < max_steps and len(train_loader) == 0:
        raise ValueError("the training loader yields no batch (fewer files than batch_size?)")
    if val_loader is not None and t.num_sanity_val_steps > 0:
        # a fault in the eval path shows at step 0, not at val_every_n_steps
        with gen_weights():
            run_validation(cfg, state.gen, val_loader, eval_step=eval_step,
                           max_batches=t.num_sanity_val_steps, compute_stoi=False,
                           teacher=teacher)
        logger.log({"sanity_val_ok": 1.0}, step)
    t_last = time.perf_counter()
    hist_accum = None
    skip_accum = 0.0
    prof = None
    while step < max_steps:
        for batch in train_loader:
            if step >= max_steps:
                break
            if profile_steps and step == profile_steps[0]:
                prof = _profiler(device)
                prof.start()
            metrics = step_fn(state, _to_device(batch, device), teacher)
            step = state.step
            if prof is not None and step == profile_steps[1]:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof.stop()
                (Path(run_dir) / "profile").mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(Path(run_dir) / "profile" / f"trace_{step}.json"))
                prof = None
            h = metrics.pop("codebook_hist")
            hist_accum = h if hist_accum is None else hist_accum + h
            if "nonfinite_skipped" in metrics:
                # summed between logs: sampling the flag at log steps would hide skips
                skip_accum = skip_accum + metrics.pop("nonfinite_skipped")
            if step % t.log_every_n_steps == 0:
                logs = {k: float(v) for k, v in metrics.items()}  # the device sync
                now = time.perf_counter()
                logs["steps_per_sec"] = t.log_every_n_steps / (now - t_last)
                t_last = now
                if t.guard_nonfinite:
                    logs["nonfinite_skipped"] = float(skip_accum)
                    skip_accum = 0.0
                logs["codebook_perplexity"] = float(M.perplexity_from_histogram(hist_accum))
                logs["codebook_utilization"] = float(M.utilization_from_histogram(hist_accum))
                hist_accum = None
                logger.log(logs, step)
            if val_loader is not None and step % t.val_every_n_steps == 0:
                timings: dict = {}
                with gen_weights():
                    val = run_validation(cfg, state.gen, val_loader, artifact_dir=run_dir,
                                         step=step, eval_step=eval_step, timings=timings,
                                         teacher=teacher)
                logger.log({**val, "val_forward_s": timings["forward_s"],
                            "val_quality_s": timings["quality_s"]}, step)
            if step % t.checkpoint_every_n_steps == 0 or step == max_steps:
                mel = metrics.get("mel_loss")
                if ckpt.save(state, metric=float(mel) if mel is not None else None):
                    logger.log({"ckpt_stall_ms": ckpt.last_save["stall_s"] * 1e3,
                                "ckpt_bytes": ckpt.last_save["bytes"]}, step)
    ckpt.save(state)
    ckpt.wait()
    if test_loader is not None:
        with gen_weights():
            test = run_test(cfg, state.gen, test_loader, teacher=teacher)
        logger.log(test, step)
    return state
