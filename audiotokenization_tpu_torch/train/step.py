"""The GAN training step (counterpart of
``audiotokenization_tpu/train/step.py``), in the reference's order:

  1. one generator forward (encode -> VQ -> decode), its graph kept;
  2. the discriminator update on the real and the **detached** fake,
     pushed through both discriminators as one 2B batch: LSGAN over the
     logits of every MPD and spectrogram sub-discriminator;
  3. the generator loss against the **updated** discriminator, with no
     gradient into it: mel x15 + adv + feature matching (real side
     detached) + Σ vq (+ the MoE router's load-balance and z losses,
     logged with the dropped share as ``moe_*``; + the semantic branch's
     fp32 reconstruction mse x ``lambda_semantic_loss``, logged as
     ``semantic_recon_loss``); backward through the saved generator graph,
     then the generator update.

``accumulate_grad_batches = N`` splits the batch into N micro-batches:
phase 1 averages the discriminator's gradients at its pre-update weights
(the fakes regenerated without a graph), one update; phase 2 averages the
generator's against the updated discriminator, one update.
``train.remat`` (``config.resolve_remat``, resolved once a step) recomputes
in the backward each BigCodec block, each Conformer layer (the MoE's aux
losses counted once) and both discriminators, rather than keeping their
activations, as the JAX step's ``jax.checkpoint`` does.
``guard_nonfinite`` skips a side's update when its loss or any of its
gradients is not finite (one host sync per side). In the JAX step the
generator loss then sees the discriminator's poisoned update, and so skips
too; here it sees the discriminator as it was.

The EMA quantizer's codebook is state (buffers), which the forward returns
and never writes: the fused step writes the forward's state into the
buffers after the generator's update, and only when the guard did not skip
it, as the JAX step swaps it in after the optimizer; accumulation's phase 1
reads the state from before the step and discards its updates, phase 2
threads it from micro-batch to micro-batch and writes the last. Its draws
are ``draws(step, codes, vectors)`` (``make_train_step``'s argument,
default ``models.codec.ema_draws``), salted by the state's step, so the
same step and batch give the same update. LFQ's codebook histogram has
2^bits bins.

A semantic codec's teacher (``models/w2v_bert.py``) is an argument of the
step, not a part of its state: frozen (no gradient), it is in no optimizer,
no weight decay, no gradient clipping and no checkpoint; in bf16 it runs
on bf16 copies of its weights. A batch carries the teacher's input
``feats`` (B, Tf', 160) or its precomputed ``semantic_target`` (B, 1024,
Tf) beside ``wav``.

Over ranks (``group``, ``parallel/dp.py``) each rank steps on its own rows
of the global batch: the gradients are reduced once an update (all-reduced,
or reduce-scattered under FSDP), after the backward and before the clip;
the batch-global terms (the EMA statistics, LFQ's entropy, the MoE router,
the STFT loss's spectral convergence) reduce across the ranks inside the
forward; the guard's verdict is the ranks' common one; and the metrics come
back as the global batch's (means, the histogram summed). Under FSDP each
block's cuts are gathered at its use, in the forward and again in the
backward, its gradients reduce-scattered as autograd accumulates them
(``parallel/fsdp.py``), and the discriminator's leaves outside its blocks
are gathered again after its update, which the generator's loss reads.

Under tensor parallelism (the state made with ``train.tensor_parallel``
model devices) the step runs inside ``parallel/tp.py::
tp_shard_activations``: the Conformer's heads, SwiGLU width and MoE experts
split over the model devices, the TP leaves read as their cuts. Under
pipeline parallelism it runs inside ``parallel/pp.py::pp_train_context``:
both backbones as GPipe pipelines of ``train.pipeline_microbatches``
microbatches (default one a stage) over the stages' devices, each layer
recomputed in the backward under ``train.remat``.

K1 runs once per generator forward with the factorized VQ (FSQ, the EMA
VQ and LFQ have none) and K2 once per fused ResidualUnit (30 in the
flagship, none in the Conformer) on CUDA tensors; K2's backward recomputes
each unit.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict

import torch

from ..config import Config, quantizer_kind, resolve_remat
from ..losses.gan import disc_loss, feature_matching_loss, gen_adv_loss
from ..losses.mel import MultiResolutionMelLoss
from ..losses.stft_loss import multi_resolution_stft_loss
from ..models import codec as C
from ..models.discriminators import discriminator_apply
from ..ops.params import cast_parameters, checkpointed, parameters_as
from ..parallel import dp
from .metrics import codebook_histogram
from .schedule import warmup_lr_schedule
from .state import ClippedAdamW, TrainState


def _finite(total, grads, group=None) -> bool:
    ok = torch.stack([torch.isfinite(total).all()] + [torch.isfinite(g).all() for g in grads])
    return dp.all_agree(ok.all(), group)


def make_train_step(cfg: Config, *, device="cuda", draws=None, group=None):
    """``step(state, batch, teacher=None) -> metrics`` for ``batch =
    {"wav": (B, T)}`` (a semantic codec's with ``feats`` for the frozen
    ``teacher``, or ``semantic_target``) on ``device`` (the state's):
    updates ``state`` in place and returns the JAX step's metrics as
    tensors (``gen_lr`` a float). ``draws``: the EMA
    quantizer's, a callable ``(step, codes, vectors) -> {"expiry": rows}``
    (default ``models.codec.ema_draws``). ``group``: the ranks of a
    data-parallel step (the state's optimizers made over the same group,
    ``train.state.train_state``; ``batch`` this rank's rows); None: one
    process. Raises without a card unless ``device="cpu"``, and for a
    config the port does not build (``models.codec.check_config``)."""
    C.resolve_device(device)
    C.check_config(cfg)
    cfg = copy.deepcopy(cfg)
    cfg.train.remat = resolve_remat(cfg)  # once, for the whole step
    tcfg = cfg.train
    lam = tcfg.lambdas
    dtype = torch.bfloat16 if tcfg.precision == "bf16" else torch.float32
    mel_loss = (MultiResolutionMelLoss(sample_rate=cfg.dataset.sample_rate)
                if tcfg.use_mel_loss else None)
    s = tcfg.gen_schedule_params
    gen_sched = warmup_lr_schedule(warmup_step=s.warmup_step, down_step=s.down_step,
                                   max_lr=s.max_lr, min_lr=s.min_lr)
    n_accum = max(int(tcfg.accumulate_grad_batches), 1)
    d = cfg.model.codec_decoder
    codebook_size = 2 ** d.in_channels if quantizer_kind(cfg) == "lfq" else d.codebook_size

    def disc_forward(disc, wav, *, detach: bool):
        """Both discriminators on ``wav`` (B, 1, T), in the compute dtype;
        ``detach``: on detached weights, so no gradient reaches them."""
        with parameters_as(disc, cast_parameters(disc, dtype, detach=detach)):
            wav = wav.to(dtype)
            if tcfg.remat:  # the discriminators' activations dominate step memory
                return checkpointed(discriminator_apply, disc, wav)
            return discriminator_apply(wav, disc)

    def disc_forward_pair(disc, a, b, *, detach: bool):
        """a and b as one 2B batch (the convs are per sample); split after."""
        n = a.shape[0]
        outs = disc_forward(disc, torch.cat([a.float(), b.float()]), detach=detach)
        return ([[t[:n] for t in sub] for sub in outs], [[t[n:] for t in sub] for sub in outs])

    def disc_losses(disc, y, y_fake):
        real_outs, fake_outs = disc_forward_pair(disc, y, y_fake.detach(), detach=False)
        real_l, fake_l = disc_loss(real_outs, fake_outs)
        total = lam.lambda_disc * (real_l + fake_l)
        return total, {"real_loss": real_l, "fake_loss": fake_l, "disc_loss": total}

    def gen_losses(disc, y, out: C.CodecOutput):
        y_g = out.gen_wav
        logs: Dict[str, Any] = {}
        total = 0.0
        if mel_loss is not None:
            logs["mel_loss"] = mel_loss(y_g[:, 0, :], y[:, 0, :])
            total = total + logs["mel_loss"] * lam.lambda_mel_loss
        if tcfg.use_stft_loss:
            p = tcfg.stft_loss_params
            logs["stft_loss"] = multi_resolution_stft_loss(
                y_g[:, 0, :], y[:, 0, :], fft_sizes=p.fft_sizes, hop_sizes=p.hop_sizes,
                win_lengths=p.win_lengths)
            total = total + logs["stft_loss"] * lam.lambda_stft_loss
        if tcfg.use_feat_match_loss:
            fake_outs, real_outs = disc_forward_pair(disc, y_g, y, detach=True)
        else:
            fake_outs = disc_forward(disc, y_g, detach=True)
        logs["adv_loss"] = gen_adv_loss(fake_outs)
        total = total + logs["adv_loss"] * lam.lambda_adv
        if tcfg.use_feat_match_loss:
            logs["fm_loss"] = feature_matching_loss(fake_outs, real_outs)
            total = total + logs["fm_loss"] * lam.lambda_feat_match_loss
        logs["vq_loss"] = torch.sum(out.vq_loss)
        total = total + logs["vq_loss"]
        if out.semantic_recon_loss is not None:
            logs["semantic_recon_loss"] = out.semantic_recon_loss
            total = total + out.semantic_recon_loss * lam.lambda_semantic_loss
        if out.moe_aux_loss is not None:  # the router's Switch aux losses
            lb, z, dropped = out.moe_aux_loss
            total = total + lb * lam.lambda_moe_load_balance + z * lam.lambda_moe_router_z
            logs.update(moe_load_balance=lb, moe_router_z=z, moe_dropped_frac=dropped)
        logs["gen_loss"] = total
        return total, logs

    def update(opt: ClippedAdamW, total) -> bool:
        """Reduce the side's gradients over the ranks and apply its update;
        False where the guard skipped it."""
        opt.reduce_grads()
        if tcfg.guard_nonfinite and not _finite(total, opt.grads(), group):
            return False
        opt.step()
        return True

    def fused_step(state: TrainState, batch, teacher):
        y = batch["wav"][:, None, :]
        out = C.forward(state.gen, batch, training=True, step=state.step, draws=draws,
                        teacher=teacher)
        state.disc_opt.zero_grad()
        disc_total, disc_logs = disc_losses(state.disc, y, out.gen_wav)
        disc_total.backward()
        ok_d = update(state.disc_opt, disc_total)
        state.disc_opt.refresh()
        state.gen_opt.zero_grad()
        gen_total, gen_logs = gen_losses(state.disc, y, out)
        gen_total.backward()
        ok_g = update(state.gen_opt, gen_total)
        if ok_g and out.quantizer_state is not None:
            state.gen.quantizer.load_state(out.quantizer_state)
        return {**disc_logs, **gen_logs}, codebook_histogram(out.vq_code, codebook_size), ok_d, ok_g

    def accumulated_step(state: TrainState, batch, teacher):
        n = n_accum
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch dim {v.shape[0]} of {k!r} not divisible by "
                                 f"accumulate_grad_batches={n}")
        mbs = [dict(zip(batch, vs)) for vs in zip(*(v.chunk(n) for v in batch.values()))]

        def mean_logs(acc, logs):
            for k, v in logs.items():
                acc[k] = acc.get(k, 0.0) + v.detach() / n

        disc_logs: Dict[str, Any] = {}
        state.disc_opt.zero_grad()
        for mb in mbs:  # phase 1: the discriminator's gradients at its weights before the update
            with torch.no_grad():  # the EMA state as before the step; its update discarded
                fake = C.forward(state.gen, mb, training=True, step=state.step,
                                 draws=draws, teacher=teacher).gen_wav
            total, logs = disc_losses(state.disc, mb["wav"][:, None, :], fake)
            (total / n).backward()
            mean_logs(disc_logs, logs)
        ok_d = update(state.disc_opt, disc_logs["disc_loss"])
        state.disc_opt.refresh()

        gen_logs: Dict[str, Any] = {}
        hist = torch.zeros(codebook_size, device=batch["wav"].device)
        state.gen_opt.zero_grad()
        qstate = None  # the EMA state threaded through phase 2 (None: the buffers)
        for mb in mbs:  # phase 2: the generator's, against the updated discriminator
            out = C.forward(state.gen, mb, training=True, step=state.step, draws=draws,
                            quantizer_state=qstate, teacher=teacher)
            qstate = out.quantizer_state
            total, logs = gen_losses(state.disc, mb["wav"][:, None, :], out)
            (total / n).backward()
            mean_logs(gen_logs, logs)
            hist += codebook_histogram(out.vq_code, codebook_size)
        ok_g = update(state.gen_opt, gen_logs["gen_loss"])
        if ok_g and qstate is not None:
            state.gen.quantizer.load_state(qstate)
        return {**disc_logs, **gen_logs}, hist, ok_d, ok_g

    body = accumulated_step if n_accum > 1 else fused_step

    def model_context(state: TrainState):
        """The step's tensor- or pipeline-parallel context (or none)."""
        if state.tp is not None:
            from ..parallel.tp import tp_shard_activations

            return tp_shard_activations(state.tp)
        if state.model_devices is not None:
            from ..parallel.pp import pp_train_context

            return pp_train_context(state.model_devices, int(tcfg.pipeline_microbatches) or None,
                                    remat=tcfg.remat)
        return contextlib.nullcontext()

    def step(state: TrainState, batch: Dict[str, torch.Tensor], teacher=None) -> Dict[str, Any]:
        with C.precision_scope(cfg), dp.batch_group(group), state.gen_opt.per_block(), \
                state.disc_opt.per_block(), model_context(state):
            logs, hist, ok_d, ok_g = body(state, batch, teacher)
        metrics = {k: v.detach() for k, v in logs.items()}
        if tcfg.guard_nonfinite:
            metrics["nonfinite_skipped"] = torch.tensor(float(not (ok_d and ok_g)),
                                                        device=hist.device)
        metrics["codebook_hist"] = hist
        metrics = dp.reduce_metrics(metrics, group)
        metrics["gen_lr"] = gen_sched(state.step)
        state.step += 1
        return metrics

    return step
