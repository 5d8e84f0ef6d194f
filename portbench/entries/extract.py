"""Entry ``extract``: corpus tokenization as ``cli/extract_indices.py`` does
it, with the disk left out.

Utterances of the mix's pool (int16 PCM on the host) go into buckets of
``quantum_s`` and are flushed ``batch_size`` at a time, each batch zero-
padded to (batch_size, bucket) with its lengths, through the program's
``utils/ragged.py::make_ragged_tokenizer(cfg, mode=...)``: the copy to the
card, the ragged encoder and the quantizer, and the codes back to the host.
The loop is closed: the next batch is assembled once the codes of the last
are on the host.

The check: a sample of the utterances tokenized in the window, drawn from
the seed with the longest among them, is encoded again by the plain
reference (``reference/<family>.py``, fp32, TF32 off), each utterance
alone; for every frame the program's code is judged by how far its
distance to the reference's normalised projected latent lies above the
reference's nearest code's (``code_gap_max``, the widest such gap).
"""
from __future__ import annotations

import numpy as np
import torch

from ..harness.traffic import Pool
from ..harness.weights import make_weights
from ..reference.common import code_gaps, vq_distances


class Entry:
    """One cell's program, traffic and check: ``setup``, ``step`` (one batch
    through the program), ``end_to_end``, ``release`` (the program's state
    freed) and ``check``; ``work`` is what the readers count."""

    metric = "tokenize_audio_s_per_s"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfgd, self.mix = ctx.config, ctx.traffic
        self.device = ctx.device
        self.records = []       # (utterance ids, their codes (Nq, rows, frames))
        self.work = []          # (rows, padded samples, [lengths]) of each batch, for the readers
        self.audio_s = 0.0

    # -- set-up ------------------------------------------------------------------------
    def setup(self):
        from audiotokenization_tpu_torch.config import codec_hop, from_dict
        from audiotokenization_tpu_torch.models.codec import init_codec
        from audiotokenization_tpu_torch.utils.ragged import make_ragged_tokenizer

        ctx = self.ctx
        with ctx.span("program_config"):
            cfg = from_dict({k: self.cfgd[k] for k in ("model", "train", "dataset")})
            self.hop = codec_hop(cfg)
        with ctx.span("weights"):
            self.weights = make_weights(ctx.reference.param_specs(self.cfgd), ctx.seed,
                                        self.device)
        with ctx.span("program_build"):
            # the program's own constructor (it draws its weights on the host),
            # then the benchmark's weights in their place
            self.codec = init_codec(cfg, generator=torch.Generator(), device=self.device)
            self.codec.load_state_dict(self.weights)
            self.run = make_ragged_tokenizer(cfg, mode=self.mix["mode"], device=self.device)
            if ctx.program_hook is not None:
                self.run = ctx.program_hook(self.run)
        with ctx.span("traffic"):
            self.pool = Pool(self.mix, ctx.seed, self.device, hop=self.hop)
            self.stream = self.pool.passes()
        ctx.reset_peak()
        with ctx.span("warm_up"):
            for top in np.unique(self.pool.bucket) if ctx.warm_up else ():
                # one batch of each bucket shape the traffic uses
                ids = np.flatnonzero(self.pool.bucket == top)[:self.pool.batch_size]
                self._call(ids.tolist(), record=False)

    # -- the timed path ------------------------------------------------------------------
    def _call(self, ids, record=True):
        ctx, pool = self.ctx, self.pool
        with ctx.span("assemble"):
            plen = int(pool.bucket[ids[0]])
            wavs = np.zeros((pool.batch_size, plen), np.int16)
            lens = np.zeros((pool.batch_size,), np.int64)
            for i, u in enumerate(ids):
                wavs[i, :pool.lengths[u]] = pool.pcm(u)
                lens[i] = pool.lengths[u]
        with ctx.span("ragged_call"):
            codes = self.run(self.codec, torch.from_numpy(wavs), torch.from_numpy(lens))
        with ctx.span("codes_back"):
            codes = codes.cpu().numpy()
        if record:
            self.records.append((list(ids), codes[:, :len(ids)]))
            self.work.append((pool.batch_size, plen, [int(pool.lengths[u]) for u in ids]))
            self.audio_s += float(sum(pool.lengths[u] for u in ids)) / pool.sample_rate
        return codes

    def step(self):
        self._call(next(self.stream))

    def attempted(self):
        return sum(len(ids) for ids, _ in self.records)

    def end_to_end(self, window_s: float) -> dict:
        return {self.metric: self.audio_s / window_s}

    # -- the check, once the window has closed ---------------------------------------------
    def release(self):
        """Free the program's state before the reference runs."""
        self.codec = self.run = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """(utterance, its codes (Nq, frames)) of a seeded sample of the
        window's utterances, the longest among them."""
        rows = [(u, codes[:, i]) for ids, codes in self.records for i, u in enumerate(ids)]
        n = min(int(self.mix["check"]["utterances"]), len(rows))
        rng = np.random.default_rng([self.ctx.seed % (2 ** 63), 11])
        longest = max(range(len(rows)), key=lambda r: self.pool.lengths[rows[r][0]])
        rest = [r for r in rng.permutation(len(rows)).tolist() if r != longest]
        return [rows[r] for r in [longest] + rest[:n - 1]]

    def _malformed(self, u, codes) -> bool:
        """Whether an utterance's codes (Nq, frames) miss frames or leave the codebook."""
        n = self.cfgd["model"]["codec_decoder"]["codebook_size"]
        row = codes[:, :int(self.pool.lengths[u]) // self.hop]
        return (row.shape[-1] < int(self.pool.lengths[u]) // self.hop
                or bool(row.size and (row.min() < 0 or row.max() >= n)))

    def reference_gaps(self, sample, *, tf32: bool = False):
        """(the widest code gap against the fp32 reference over ``sample``,
        the frames compared); with ``tf32`` the codes judged are the
        reference's own under TF32 (the control), else the program's, whose
        malformed rows ``check`` counts apart."""
        ref, P, dev = self.ctx.reference, self.weights, self.device
        worst, frames = 0.0, 0
        for chunk in _chunks([(u, c) for u, c in sample if not self._malformed(u, c)], 8):
            wavs = [torch.as_tensor(self.pool.pcm(u), device=dev).float() / 32768.0
                    for u, _ in chunk]
            with _tf32(False), torch.no_grad():
                dists = [vq_distances(P, lat) for lat in ref.encode(P, self.cfgd, wavs)]
            if tf32:
                with _tf32(True), torch.no_grad():
                    own = [vq_distances(P, lat).argmin(dim=1)
                           for lat in ref.encode(P, self.cfgd, wavs)]
            for k, ((u, codes), dist) in enumerate(zip(chunk, dists)):
                nf = dist.shape[0]
                got = own[k] if tf32 else torch.as_tensor(codes[0, :nf], device=dev)
                worst = max(worst, float(code_gaps(dist, got).max()))
                frames += nf
        return worst, frames

    def check(self, limits: dict):
        """(the numbers compared, each beside its limit; what was compared;
        the utterances whose codes miss frames or leave the codebook)."""
        sample = self.sample()
        worst, frames = self.reference_gaps(sample)
        bad = sum(self._malformed(u, codes[:, i])
                  for ids, codes in self.records for i, u in enumerate(ids))
        checks = {"code_gap_max": {"value": worst, "limit": limits.get("code_gap_max")},
                  "rows_malformed": {"value": bad, "limit": 0}}
        info = {"utterances_compared": len(sample), "frames_compared": frames}
        return checks, info, bad


def _chunks(xs, n):
    return [xs[i:i + n] for i in range(0, len(xs), n)]


class _tf32:
    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev
