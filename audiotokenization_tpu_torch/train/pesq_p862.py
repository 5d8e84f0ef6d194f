"""Native ITU-T P.862 PESQ (wideband P.862.2 primary; narrowband via P.862.1).

The port's own copy of ``audiotokenization_tpu/train/pesq_p862.py`` (numpy
only); the tests named below check the JAX package's copy, and
``tests/test_torch_metrics.py`` holds this one to it.

The reference's headline quality metric is wideband PESQ computed by
torchmetrics' wrapper around the ITU `pesq` package
(BigCodec_SSL/lightning_module.py:214-222; offline wrapper
inference_full.py:438-476). That package does not exist in this image, so
this module implements the published P.862 pipeline natively:

  level alignment -> input filtering -> crude time alignment ->
  utterance segmentation -> per-utterance fine alignment (weighted
  correlation histogram) -> delay-discontinuity utterance splitting ->
  perceptual model (Hann power spectra, Bark band densities via the ITU
  fixed tables, frequency/gain compensation, Zwicker loudness with the
  low-band modified exponents, deadzone + asymmetry-weighted disturbance,
  frame weighting, bad-interval realignment) -> L6-over-syllables /
  L2-over-time aggregation -> raw MOS -> P.862.2 (wb) / P.862.1 (nb)
  logistic mapping.

Fidelity statement:
- The ITU *fixed tables* (49-band Bark layout @16 kHz / 42 @8 kHz,
  FFT-bin->band counts, power-density corrections, per-band absolute
  thresholds) are TRANSCRIBED published standards constants
  (train/pesq_tables.py, validated by structural identities in
  tests/test_pesq_tables.py). There is NO free calibration parameter:
  the disturbance norms are the ITU pseudo-Lp forms over the published
  Bark widths, and Sp/Sl are the published calibration constants.
- Perceptual model follows the ITU reference structure stage by stage:
  total-audible power from band 1 with the 100x-threshold silence
  criterion, frequency-response compensation of the reference via
  (avg+1000) ratios clipped to [0.01, 100], short-term gain compensation
  of the degraded with 0.8/0.2 first-order smoothing clipped to
  [3e-4, 5], modified Zwicker exponents 0.23*min(6/(bark+2), 2)^0.15
  below 4 Bark, 0.25-min deadzone, ((P+50)/(P+50))^1.2 asymmetry
  (<3 -> 0, cap 12), pseudo-Lp frame norms (p=2 / p=1 asymmetric),
  ((E_ref+1e5)/1e7)^0.04 frame weight with the 45 clip, bad-frame
  (>30) interval realignment with per-frame minimum, 20-frame/10-step
  L6 syllable -> weighted L2 time aggregation with the >1000-frame
  linear time-weight ramp, MOS = 4.5 - 0.1 D - 0.0309 DA, and the
  published P.862.2 / P.862.1 logistic maps.
- The time-alignment stage is a vectorized redesign (batched-FFT
  weighted-correlation histograms) of the ITU crude+fine+split search;
  it produces the same per-utterance delay structure the model consumes.
- Remaining known deltas vs the ITU C tool: level alignment integrates
  over the original extent (the C tool includes its 320 ms zero
  datapadding in the average) and uses a brick-wall 350-3250 Hz band
  instead of the C tool's FIR; both differences are absorbed by the
  model's own gain compensation. The oracle-gated conformance test
  (tests/test_pesq_conformance.py) asserts a +-0.1 MOS bound wherever
  the ITU `pesq` package is installed.
"""
from __future__ import annotations

import numpy as np

from . import pesq_tables as _T

# --- published P.862 constants ------------------------------------------------
_TARGET_POWER = 1e7           # fix_power_level target (350-3250 Hz band power)
_ZWICKER = 0.23               # Zwicker loudness exponent
_D_WEIGHT, _DA_WEIGHT = 0.1, 0.0309
_THRESHOLD_BAD_FRAMES = 30.0  # frame disturbance triggering realignment
_SMEAR_RANGE = 2              # bad-interval boundary extension (frames)
_SEARCH_RANGE_TRANSFORMS = 4  # bad-interval delay search, in FFT lengths

_MODEL_CACHE: dict = {}


class _Model:
    """Per-sample-rate tables: ITU band mapping, thresholds, window."""

    def __init__(self, fs: int):
        if fs == 16000:
            self.nfft, self.nb = _T.NFFT_16K, _T.NB_16K
            nr = _T.NR_OF_HZ_BANDS_PER_BARK_BAND_16K
            corr = _T.POW_DENS_CORRECTION_FACTOR_16K
            self.width = _T.WIDTH_OF_BAND_BARK_16K
            self.abs_thresh = _T.ABS_THRESH_POWER_16K
            centre = _T.CENTRE_OF_BAND_BARK_16K
            sp, self.sl = _T.SP_16K, _T.SL_16K
            self.wb_sos = _T.WB_IIR_SOS_16K
        elif fs == 8000:
            self.nfft, self.nb = _T.NFFT_8K, _T.NB_8K
            nr = _T.NR_OF_HZ_BANDS_PER_BARK_BAND_8K
            corr = _T.POW_DENS_CORRECTION_FACTOR_8K
            self.width = _T.WIDTH_OF_BAND_BARK_8K
            self.abs_thresh = _T.ABS_THRESH_POWER_8K
            centre = _T.CENTRE_OF_BAND_BARK_8K
            sp, self.sl = _T.SP_8K, _T.SL_8K
            self.wb_sos = _T.WB_IIR_SOS_8K
        else:
            raise ValueError(f"PESQ supports 8 kHz / 16 kHz, got {fs}")
        self.fs = fs
        self.hop = self.nfft // 2
        n = np.arange(self.nfft)
        self.window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / self.nfft))
        # FFT power bins -> Bark band map: consecutive bins per band per the
        # ITU nr_of_hz_bands table (DC included in band 0), x correction x Sp
        edges = np.concatenate([[0], np.cumsum(nr)])
        self.nbins = int(edges[-1])            # == nfft // 2
        W = np.zeros((self.nb, self.nbins))
        for b in range(self.nb):
            W[b, edges[b]:edges[b + 1]] = corr[b] * sp
        self.Wt = W.T                          # (nbins, nb)
        # pseudo-Lp / total-audible run over bands 1..Nb-1 (band 0 is DC)
        self.total_width = float(self.width[1:].sum())
        # modified Zwicker exponent below 4 Bark
        h = np.where(centre < 4.0, 6.0 / (centre + 2.0), 1.0)
        self.zwicker = _ZWICKER * np.minimum(h, 2.0) ** 0.15


def _model(fs: int) -> _Model:
    m = _MODEL_CACHE.get(fs)
    if m is None:
        m = _MODEL_CACHE[fs] = _Model(fs)
    return m


# =============================================================================
# Stage 1-2: level alignment + input filtering
# =============================================================================

def _band_power(x, fs, lo, hi):
    """Mean power of x restricted to [lo, hi] Hz (FFT brick-wall, the
    fix_power_level band limit)."""
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / fs)
    sel = (f >= lo) & (f <= hi)
    # Parseval: band power = sum |X|^2 / N^2 * 2 (one-sided)
    p = (np.sum(np.abs(X[sel]) ** 2) * 2.0) / (len(x) ** 2)
    return max(p, 1e-20)


def _fix_power_level(x, fs):
    """Scale so the mean 350-3250 Hz power equals the ITU calibration target
    (P.862 fix_power_level: PESQ operates at 16-bit sample scale; mean
    band-limited power 1e7 ~= RMS 3162)."""
    return x * np.sqrt(_TARGET_POWER / _band_power(x, fs, 350.0, 3250.0))


def _wb_input_filter(x, m: _Model):
    """P.862.2 wideband input filter: one IIR SOS per rate (high-pass ~100 Hz
    with gain), replacing the narrowband IRS receive characteristic."""
    from scipy.signal import lfilter

    b0, b1, b2, a1, a2 = m.wb_sos
    return lfilter([b0, b1, b2], [1.0, a1, a2], x)


def _nb_input_filter(x, fs):
    """Narrowband IRS-like receive filter, applied in the frequency domain
    (the ITU apply_filter piecewise-dB gain curve)."""
    pts_hz = np.array([0, 50, 100, 125, 160, 200, 250, 300, 350, 400,
                       500, 600, 700, 800, 1000, 1300, 1600, 2000, 2500,
                       3000, 3250, 3500, 4000, 5000, 6300, 8000], float)
    gains_db = np.array([-200, -40, -20, -12, -6, 0, 4, 6, 8, 10,
                         11, 12, 12, 12, 12, 12, 12, 12, 12,
                         12, 12, 4, -200, -200, -200, -200], float)
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1.0 / fs)
    g = 10.0 ** (np.interp(f, pts_hz, gains_db) / 20.0)
    return np.fft.irfft(X * g, len(x))


# =============================================================================
# Stage 3: time alignment
# =============================================================================

_ALIGN_FRAME_MS = 4.0


def _frame_energies(x, fs):
    """Per-4ms-frame energies (the ITU crude-alignment / VAD feature)."""
    n = int(fs * _ALIGN_FRAME_MS / 1000.0)
    m = len(x) // n
    return np.sum(x[:m * n].reshape(m, n) ** 2, axis=1)


def _xcorr_argmax(a, b):
    """Lag of max cross-correlation of zero-mean sequences (FFT-based).
    Positive lag means b is delayed relative to a."""
    a = a - a.mean()
    b = b - b.mean()
    nf = 1 << int(np.ceil(np.log2(len(a) + len(b) - 1)))
    c = np.fft.irfft(np.conj(np.fft.rfft(a, nf)) * np.fft.rfft(b, nf), nf)
    # order lags [-(len(a)-1) .. len(b)-1]
    c_ord = np.concatenate([c[nf - len(a) + 1:], c[:len(b)]])
    i = int(np.argmax(c_ord))
    return i - (len(a) - 1), float(c_ord[i])


def _crude_align(ref, deg, fs):
    """Global delay estimate (samples) from log-envelope cross-correlation."""
    er = np.log2(_frame_energies(ref, fs) + 1e4)
    ed = np.log2(_frame_energies(deg, fs) + 1e4)
    frame = int(fs * _ALIGN_FRAME_MS / 1000.0)
    lag, _ = _xcorr_argmax(er, ed)
    return lag * frame


def _locate_utterances(energies, thr_db_below_max: float = 35.0,
                       min_frames: int = 50, join_gap: int = 50):
    """Active-speech sections of the reference envelope: frames above
    (max - thr) dB, min 200 ms long, gaps under 200 ms joined (the ITU
    utterance-search structure on the VAD profile)."""
    e_db = 10.0 * np.log10(energies + 1e-10)
    thr = e_db.max() - thr_db_below_max
    active = e_db > thr
    utts = []
    i = 0
    n = len(active)
    while i < n:
        if active[i]:
            j = i
            while j < n and active[j]:
                j += 1
            utts.append([i, j])
            i = j
        else:
            i += 1
    joined = []
    for u in utts:
        if joined and u[0] - joined[-1][1] < join_gap:
            joined[-1][1] = u[1]
        else:
            joined.append(u)
    return [(a, b) for a, b in joined if b - a >= min_frames]


def _fine_align(ref, deg, fs, search: int):
    """Per-utterance fine delay: 64 ms Hann windows every 4 ms; weighted
    histogram of per-window best lags (weight = corr^0.125), triangular
    smoothing; returns (delay_samples, confidence) — the ITU time_align
    histogram construction. All window correlations run as ONE batched FFT
    (the loop formulation cost ~0.4 s/call, dominating val-time PESQ)."""
    win = int(fs * 0.064)
    step = int(fs * 0.004)
    empty = (np.zeros(0, np.int64),) * 3
    if len(ref) < win or len(deg) < win:
        lag, _ = _xcorr_argmax(ref, deg)
        return lag, 0.0, empty
    h = np.hanning(win)
    nf = 1 << int(np.ceil(np.log2(win + 2 * search)))
    n = min(len(ref), len(deg))
    # pad so every window's [s - search, s + win + search) slice exists;
    # zeros contribute zero correlation, identical to skipping them
    degp = np.concatenate([np.zeros(search), deg,
                           np.zeros(search + win)])
    starts = np.arange(0, n - win, step)
    if len(starts) == 0:
        return 0, 0.0, empty
    idx_a = starts[:, None] + np.arange(win)[None, :]
    A = (ref[idx_a] * h[None, :]).astype(np.float32)  # (S, win)
    idx_b = starts[:, None] + np.arange(win + 2 * search)[None, :]
    Bm = degp[idx_b].astype(np.float32)               # (S, win + 2*search)
    # float32 FFTs: the histogram argmax is insensitive to the precision
    # and they run ~2x faster (the dominant cost of the whole metric)
    C = np.fft.irfft(np.conj(np.fft.rfft(A, nf, axis=1))
                     * np.fft.rfft(Bm, nf, axis=1), nf, axis=1)
    C = C[:, :2 * search + 1]  # lag s-search .. s+search relative to ref
    k = np.argmax(np.abs(C), axis=1)                 # (S,)
    w = np.abs(C[np.arange(len(starts)), k]) ** 0.125
    hist = np.bincount(k, weights=w, minlength=2 * search + 1)
    if hist.sum() <= 0:
        return 0, 0.0, (starts, k - search, w)
    # triangular smoothing +-1 ms
    tri_w = max(int(fs * 0.001), 1)
    kern = 1.0 - np.abs(np.arange(-tri_w, tri_w + 1)) / (tri_w + 1)
    sm = np.convolve(hist, kern, mode="same")
    best = int(np.argmax(sm))
    conf = float(sm[best] / (sm.sum() + 1e-12))
    return best - search, conf, (starts, k - search, w)


def _align_utterances(ref, deg, fs):
    """Full alignment: crude global delay, utterance segmentation, fine
    per-utterance delay, one level of delay-discontinuity splitting.
    Returns a list of (ref_start, ref_end, delay_samples)."""
    crude = _crude_align(ref, deg, fs)
    frame = int(fs * _ALIGN_FRAME_MS / 1000.0)
    energies = _frame_energies(ref, fs)
    utts = _locate_utterances(energies)
    if not utts:
        utts = [(0, len(energies))]
    # fine search covers the RESIDUAL of the crude (4 ms-frame envelope)
    # alignment: +-64 ms is ~16 envelope frames of slack (the crude stage
    # can err by several frames on noisy signals), and the halved
    # correlation span halves the FFT length (the metric's dominant cost)
    search = int(fs * 0.064)
    out = []
    for a, b in utts:
        r0, r1 = a * frame, min(b * frame, len(ref))
        d0 = r0 + crude
        seg_ref = ref[r0:r1]
        # seg_deg starts AT d0: _fine_align pads internally for the +-search
        # lag span, so passing extra left context here would shift the
        # search center off crude (reachable range [crude-2s, crude] instead
        # of crude+-s — a delayed signal whose residual is positive becomes
        # unfindable)
        lo = max(d0, 0)
        hi = min(d0 + (r1 - r0), len(deg))
        seg_deg = deg[lo:hi]
        lag, conf, (w_starts, w_lags, w_wts) = _fine_align(
            seg_ref, seg_deg, fs, search)
        delay = crude + (lo - d0) + lag
        # delay-discontinuity split (ITU split_align): re-aligning the two
        # halves costs two more batched-FFT passes, so only attempt it when
        # the single pass's per-window lag evidence actually DISAGREES
        # between halves (weighted-median lag difference > 2 ms) — for
        # sample-aligned codec audio the halves agree and the whole metric
        # runs one alignment pass per utterance.
        mid = (r1 - r0) // 2
        halves_disagree = False
        if len(w_starts) >= 8:
            first = w_starts < mid
            if first.any() and (~first).any():
                def wmed(sel):
                    order = np.argsort(w_lags[sel])
                    cw = np.cumsum(w_wts[sel][order])
                    return w_lags[sel][order][
                        int(np.searchsorted(cw, cw[-1] / 2))]
                halves_disagree = abs(wmed(first) - wmed(~first)) > fs * 0.002
        if halves_disagree and mid > int(fs * 0.3):
            l1, c1, _ = _fine_align(seg_ref[:mid], deg[max(r0 + crude, 0):
                                                   min(r0 + crude + mid, len(deg))], fs, search)
            l2, c2, _ = _fine_align(seg_ref[mid:], deg[max(r0 + mid + crude, 0):
                                                   min(r1 + crude, len(deg))], fs, search)
            if min(c1, c2) > conf * 1.25 and abs(l1 - l2) > int(fs * 0.002):
                base1 = max(r0 + crude, 0) - (r0 + crude)
                base2 = max(r0 + mid + crude, 0) - (r0 + mid + crude)
                out.append((r0, r0 + mid, crude + base1 + l1))
                out.append((r0 + mid, r1, crude + base2 + l2))
                continue
        out.append((r0, r1, delay))
    return out


# =============================================================================
# Stage 4: perceptual model (ITU pesq_psychoacoustic_model structure)
# =============================================================================

def _bark_spectra(xpad, starts, m: _Model):
    """Pitch power densities of the windows starting at `starts` into the
    zero-padded signal `xpad` (one batched FFT; ITU short_term_fft +
    freq_warping with the fixed bin->band tables)."""
    idx = starts[:, None] + np.arange(m.nfft)[None, :]
    F = np.fft.rfft(xpad[idx] * m.window[None, :], axis=1)
    P = F.real ** 2 + F.imag ** 2
    P[:, 0] *= 0.5  # ITU short_term_fft halves the DC power bin
    return P[:, :m.nbins] @ m.Wt  # (frames, nb)


def _total_audible(P, m: _Model, factor: float):
    """Sum of band powers above factor x absolute threshold, bands 1..Nb-1
    (ITU total_audible)."""
    Pb = P[:, 1:]
    thr = factor * m.abs_thresh[None, 1:]
    return np.where(Pb > thr, Pb, 0.0).sum(axis=1)


def _loudness(P, m: _Model):
    """Zwicker loudness densities with the ITU low-band modified exponents
    (intensity_warping_of)."""
    thr = m.abs_thresh[None, :]
    mz = m.zwicker[None, :]
    L = m.sl * (thr / 0.5) ** mz * ((0.5 + 0.5 * P / thr) ** mz - 1.0)
    return np.where(P > thr, L, 0.0)


def _disturbances(Pr, Pd, m: _Model):
    """Per-frame (D, DA) from compensated pitch power densities: loudness
    difference, 0.25-min deadzone, asymmetry weighting, pseudo-Lp norms
    over bands 1..Nb-1 (ITU pseudo_Lp with p=2 / p=1)."""
    Lr, Ld = _loudness(Pr, m), _loudness(Pd, m)
    d = Ld - Lr
    dead = 0.25 * np.minimum(Ld, Lr)
    d = np.sign(d) * np.maximum(np.abs(d) - dead, 0.0)
    asym = ((Pd + 50.0) / (Pr + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))
    w = m.width[None, 1:]
    ad = np.abs(d[:, 1:])
    d_f = np.sqrt(np.sum((ad * w) ** 2, axis=1) / m.total_width) * m.total_width
    da_f = np.sum(ad * asym[:, 1:] * w, axis=1)
    return d_f, da_f


def _lpq_weight(df, tw):
    """L6 over 20-frame 'syllable' intervals every 10 frames, then weighted
    L2 over the interval series (ITU Lpq_weight, powers 6 and 2)."""
    num = 0.0
    den = 0.0
    for s in range(0, len(df), 10):
        chunk = np.minimum(df[s:s + 20], 45.0)
        syl = np.mean(chunk ** 6.0) ** (1.0 / 6.0)
        w = tw[s]
        num += (w * syl) ** 2
        den += w ** 2
    if den <= 0:
        return 0.0
    return float(np.sqrt(num / den))


def _perceptual(ref, deg, utts, m: _Model):
    """Whole-file frame-grid disturbance profile -> (D, DA).

    Frames advance by nfft/2 over the full reference extent; each frame's
    degraded window is offset by the delay of the utterance containing it
    (assignment by last utterance start <= frame start, the ITU rule)."""
    hop, nfft = m.hop, m.nfft
    n = len(ref)
    F = (n - nfft) // hop + 1
    if F <= 0 or not utts:
        return None, None
    starts = hop * np.arange(F, dtype=np.int64)
    utt_starts = np.array([u[0] for u in utts], dtype=np.int64)
    utt_delays = np.array([u[2] for u in utts], dtype=np.int64)
    which = np.clip(np.searchsorted(utt_starts, starts, side="right") - 1,
                    0, len(utts) - 1)
    delay = utt_delays[which]
    # zero padding stands in for the ITU SEARCHBUFFER/DATAPADDING zeros:
    # out-of-range degraded windows read zeros. Must cover the ordinary
    # per-utterance delays AND the bad-interval realignment's extra
    # +-SEARCH_RANGE_TRANSFORMS*nfft delay excursion on top of them.
    pad = int((_SEARCH_RANGE_TRANSFORMS + 1) * nfft + np.abs(delay).max())
    degp = np.concatenate([np.zeros(pad), deg, np.zeros(pad)])
    Pr = _bark_spectra(np.concatenate([ref, np.zeros(nfft)]), starts, m)
    Pd = _bark_spectra(degp, starts + delay + pad, m)
    # silence criterion: audible power (100x threshold) under 1e7
    silent = _total_audible(Pr, m, 100.0) < 1e7
    # frequency (transducer) response compensation of the REFERENCE:
    # per-band averages over non-silent frames of components above
    # 100x threshold, ratio (avg_deg+1000)/(avg_ref+1000) in [0.01, 100]
    act = ~silent
    if act.any():
        mr = (Pr > 100.0 * m.abs_thresh[None, :]) & act[:, None]
        md = (Pd > 100.0 * m.abs_thresh[None, :]) & act[:, None]
        avg_r = np.where(mr, Pr, 0.0).sum(axis=0) / F
        avg_d = np.where(md, Pd, 0.0).sum(axis=0) / F
        ratio = np.clip((avg_d + 1000.0) / (avg_r + 1000.0), 0.01, 100.0)
        Pr = Pr * ratio[None, :]
    # short-term gain compensation of the DEGRADED: smoothed audible-power
    # ratio, new-sample weight 0.8, clipped to [3e-4, 5] after smoothing
    er = _total_audible(Pr, m, 1.0)
    ed = _total_audible(Pd, m, 1.0)
    g = (er + 5e3) / (ed + 5e3)
    scale = np.empty(F)
    prev = 0.0
    for f in range(F):
        s = g[f] if f == 0 else 0.2 * prev + 0.8 * g[f]
        prev = s
        scale[f] = min(max(s, 3e-4), 5.0)
    Pd = Pd * scale[:, None]
    d_f, da_f = _disturbances(Pr, Pd, m)
    # frame weighting by the (equalized) reference audible energy
    h = ((er + 1e5) / 1e7) ** 0.04
    d_f = np.minimum(d_f / h, 45.0)
    da_f = np.minimum(da_f / h, 45.0)
    # --- bad-interval realignment (ITU bad-frame loop) -----------------------
    bad = d_f > _THRESHOLD_BAD_FRAMES
    if bad.any() and F >= 3:
        core = bad.copy()
        core[1:-1] = bad[1:-1] & bad[:-2] & bad[2:]  # smear: isolated frames out
        core[0] = bad[0] & bad[1]
        core[-1] = bad[-1] & bad[-2]
        if core.any():
            edges = np.flatnonzero(np.diff(np.concatenate(
                [[0], core.view(np.int8), [0]])))
            search = _SEARCH_RANGE_TRANSFORMS * nfft
            for f0, f1 in zip(edges[::2], edges[1::2]):
                f0 = max(f0 - _SMEAR_RANGE, 0)
                f1 = min(f1 + _SMEAR_RANGE, F)
                s0, s1 = starts[f0], starts[f1 - 1] + nfft
                d_old = int(delay[f0])
                seg_ref = ref[s0:s1]
                lo = s0 + d_old - search + pad
                hi = s1 + d_old + search + pad
                lag, _ = _xcorr_argmax(seg_ref, degp[max(lo, 0):hi])
                new_delay = d_old - search + lag + max(lo, 0) - lo
                if new_delay == d_old:
                    continue
                Pd2 = _bark_spectra(degp, starts[f0:f1] + new_delay + pad, m)
                Pd2 = Pd2 * scale[f0:f1, None]
                d2, da2 = _disturbances(Pr[f0:f1], Pd2, m)
                d2 = np.minimum(d2 / h[f0:f1], 45.0)
                da2 = np.minimum(da2 / h[f0:f1], 45.0)
                # per-frame minimum of old/realigned disturbance
                d_f[f0:f1] = np.minimum(d_f[f0:f1], d2)
                da_f[f0:f1] = np.minimum(da_f[f0:f1], da2)
    # --- aggregation ---------------------------------------------------------
    tw = np.ones(F)
    if F > 1000:
        factor = min((F - 1000.0) / 5500.0, 0.5)
        tw = (1.0 - factor) + factor * np.arange(F) / F
    return _lpq_weight(d_f, tw), _lpq_weight(da_f, tw)


# =============================================================================
# Public API
# =============================================================================

def pesq_p862(ref, deg, fs: int = 16000, mode: str = "wb") -> float:
    """PESQ MOS-LQO of `deg` against `ref` (full P.862 pipeline).

    mode='wb' (P.862.2 wideband, 16 kHz — the reference's metric) or
    mode='nb' (P.862 narrowband with the P.862.1 mapping).
    Returns NaN for degenerate inputs (too short / silent).
    """
    x = np.asarray(ref, np.float64).ravel()
    y = np.asarray(deg, np.float64).ravel()
    if min(len(x), len(y)) < fs // 4:
        return float("nan")
    if np.max(np.abs(x)) < 1e-8 or np.max(np.abs(y)) < 1e-8:
        return float("nan")
    x = _fix_power_level(x, fs)
    y = _fix_power_level(y, fs)
    m = _model(fs)
    if mode == "wb":
        x = _wb_input_filter(x, m)
        y = _wb_input_filter(y, m)
    else:
        x = _nb_input_filter(x, fs)
        y = _nb_input_filter(y, fs)
    utts = _align_utterances(x, y, fs)
    D, DA = _perceptual(x, y, utts, m)
    if D is None:
        return float("nan")
    raw = 4.5 - _D_WEIGHT * D - _DA_WEIGHT * DA
    if mode == "wb":
        return float(0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
    return float(0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607)))
