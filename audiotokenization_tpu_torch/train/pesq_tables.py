"""ITU-T P.862 fixed tables (transcribed standards constants).

The port's own copy of ``audiotokenization_tpu/train/pesq_tables.py`` (numpy
only); the tests named below check the JAX package's copy, and
``tests/test_torch_metrics.py`` holds this one to it.

These are the published fixed tables of the ITU-T P.862 reference
implementation (pesqpar.h of the P.862 (02/2001) + P.862.2 Annex A C
code): the Bark band layout, the FFT-bin -> Bark-band mapping, the
per-band power-density correction factors, and the per-band absolute
hearing thresholds. They are standards constants, not code.

Layout facts the transcription is validated against
(tests/test_pesq_tables.py):

- 16 kHz model: Nfft 512 (32 ms), 49 Bark bands, FFT bin width 31.25 Hz,
  sum(nr_of_hz_bands) == 256 == Nfft/2 (bins 0..255, DC included in
  band 0 whose absolute threshold is ~77 dB -> never audible).
- 8 kHz model: Nfft 256 (32 ms), 42 bands, same 31.25 Hz bin width, so
  the 8 kHz tables are EXACT 42-entry prefixes of the 16 kHz tables and
  sum(nr_of_hz_bands) == 128 + 1 == 129 ... see test for the exact split.
- centre_of_band_bark[i+1] - centre_of_band_bark[i] ==
  (width_of_band_bark[i] + width_of_band_bark[i+1]) / 2 to 4 decimals
  (adjacent abutting bands).
- pow_dens_correction_factor[i] ~= 100 / nr_of_hz_bands_per_bark_band[i]
  (mean power density per band, x100 absorbed by Sp), with the published
  sub-1e-5 calibration wiggles kept verbatim.
"""
from __future__ import annotations

import numpy as np

# --- 16 kHz (wideband model, 49 bands) ---------------------------------------

NB_16K = 49
NFFT_16K = 512

CENTRE_OF_BAND_BARK_16K = np.array([
    0.078672, 0.316341, 0.636559, 0.961246, 1.290450,
    1.624217, 1.962597, 2.305636, 2.653383, 3.005889,
    3.363201, 3.725371, 4.092449, 4.464486, 4.841533,
    5.223642, 5.610866, 6.003256, 6.400869, 6.803755,
    7.211971, 7.625571, 8.044611, 8.469146, 8.899232,
    9.334927, 9.776288, 10.223374, 10.676242, 11.134952,
    11.599563, 12.070135, 12.546731, 13.029408, 13.518232,
    14.013264, 14.514566, 15.022202, 15.536238, 16.056736,
    16.583761, 17.117382, 17.657663, 18.204674, 18.758478,
    19.319147, 19.886751, 20.461355, 21.043034])

CENTRE_OF_BAND_HZ_16K = np.array([
    7.867213, 31.634144, 63.655895, 96.124611, 129.044968,
    162.421738, 196.259659, 230.563568, 265.338348, 300.588867,
    336.320129, 372.537140, 409.244934, 446.448578, 484.568604,
    526.600586, 570.303833, 619.423340, 672.121643, 728.525696,
    785.675964, 846.835693, 909.691650, 977.063293, 1049.861694,
    1129.635986, 1217.257568, 1312.109497, 1412.501465, 1517.999390,
    1628.894165, 1746.194336, 1871.568848, 2008.776123, 2158.979248,
    2326.743164, 2513.787109, 2722.488770, 2952.586670, 3205.835449,
    3492.679932, 3820.219238, 4193.938477, 4619.846191, 5100.437012,
    5636.199219, 6234.313965, 6946.734863, 7796.473633])

WIDTH_OF_BAND_BARK_16K = np.array([
    0.157344, 0.317994, 0.322441, 0.326934, 0.331474,
    0.336061, 0.340697, 0.345381, 0.350114, 0.354897,
    0.359729, 0.364611, 0.369544, 0.374529, 0.379565,
    0.384653, 0.389794, 0.394989, 0.400236, 0.405538,
    0.410894, 0.416306, 0.421773, 0.427297, 0.432877,
    0.438514, 0.444209, 0.449962, 0.455774, 0.461645,
    0.467577, 0.473569, 0.479621, 0.485736, 0.491912,
    0.498151, 0.504454, 0.510819, 0.517250, 0.523745,
    0.530308, 0.536934, 0.543629, 0.550390, 0.557220,
    0.564119, 0.571085, 0.578125, 0.585232])

WIDTH_OF_BAND_HZ_16K = np.array([
    15.734426, 31.799433, 32.244064, 32.693359, 33.147385,
    33.606140, 34.069702, 34.538116, 35.011429, 35.489655,
    35.972870, 36.461121, 36.954407, 37.452911, 40.269653,
    42.311859, 45.992554, 51.348511, 55.040527, 56.775208,
    58.699402, 62.445862, 65.820923, 69.195374, 76.745667,
    84.016235, 90.825684, 97.931152, 103.348877, 107.801880,
    113.552246, 121.490601, 130.420410, 143.431763, 158.486816,
    176.872803, 198.314697, 219.549561, 240.600098, 268.702393,
    306.060059, 349.937012, 398.686279, 454.713867, 506.841797,
    564.863770, 637.261230, 794.331055, 931.068359])

NR_OF_HZ_BANDS_PER_BARK_BAND_16K = np.array([
    1, 1, 1, 1, 1,
    1, 1, 1, 2, 1,
    1, 1, 1, 1, 2,
    1, 1, 2, 2, 2,
    2, 2, 2, 2, 2,
    3, 3, 3, 3, 4,
    3, 4, 5, 4, 5,
    6, 6, 7, 8, 9,
    9, 12, 12, 15, 16,
    18, 21, 25, 20], dtype=np.int64)

POW_DENS_CORRECTION_FACTOR_16K = np.array([
    100.000000, 99.999992, 100.000000, 100.000008, 100.000008,
    100.000015, 99.999992, 99.999969, 50.000027, 100.000000,
    99.999969, 100.000015, 99.999947, 100.000015, 49.999836,
    100.000061, 100.000023, 49.999817, 49.999969, 50.000027,
    50.000000, 50.000027, 49.999969, 49.999908, 49.999969,
    33.333317, 33.333340, 33.333317, 33.333313, 24.999993,
    33.333321, 24.999941, 19.999998, 25.000005, 20.000024,
    16.666683, 16.666666, 14.285713, 12.500000, 11.111111,
    11.111111, 8.333333, 8.333333, 6.666667, 6.250000,
    5.555555, 4.761904, 4.000000, 5.000000])

ABS_THRESH_POWER_16K = np.array([
    51286152.00, 2454709.500, 70794.593750, 4897.788574, 1174.897705,
    389.045166, 104.712860, 45.708820, 17.782795, 9.772372,
    4.897789, 3.090296, 1.905461, 1.258925, 0.977237,
    0.724436, 0.562341, 0.457088, 0.389045, 0.331131,
    0.295121, 0.269153, 0.257040, 0.251189, 0.251189,
    0.251189, 0.251189, 0.263027, 0.288403, 0.309030,
    0.338844, 0.371535, 0.398107, 0.436516, 0.467735,
    0.489779, 0.501187, 0.501187, 0.512861, 0.524807,
    0.524807, 0.524807, 0.524807, 0.524807, 0.524807,
    0.524807, 0.524807, 0.524807, 0.524807])

# --- 8 kHz (narrowband model, 42 bands): exact prefixes ----------------------

NB_8K = 42
NFFT_8K = 256

CENTRE_OF_BAND_BARK_8K = CENTRE_OF_BAND_BARK_16K[:NB_8K]
CENTRE_OF_BAND_HZ_8K = CENTRE_OF_BAND_HZ_16K[:NB_8K]
WIDTH_OF_BAND_BARK_8K = WIDTH_OF_BAND_BARK_16K[:NB_8K]
WIDTH_OF_BAND_HZ_8K = WIDTH_OF_BAND_HZ_16K[:NB_8K]
NR_OF_HZ_BANDS_PER_BARK_BAND_8K = NR_OF_HZ_BANDS_PER_BARK_BAND_16K[:NB_8K]
POW_DENS_CORRECTION_FACTOR_8K = POW_DENS_CORRECTION_FACTOR_16K[:NB_8K]
ABS_THRESH_POWER_8K = ABS_THRESH_POWER_16K[:NB_8K]

# --- calibration constants (P.862 / P.862.2) ---------------------------------

SP_16K = 6.910853e-6      # power-density calibration, 16 kHz model
SP_8K = 2.764344e-5       # power-density calibration, 8 kHz model
SL_16K = 1.866055e-1      # loudness-density calibration (both rates)
SL_8K = 1.866055e-1

# P.862.2 wideband input filter: one IIR second-order section per rate
# (b0, b1, b2, a1, a2)
WB_IIR_SOS_16K = (2.6657628, -5.3315255, 2.6657628, -1.8890331, 0.89487434)
WB_IIR_SOS_8K = (2.740826, -5.4816519, 2.740826, -1.9444777, 0.94597794)
