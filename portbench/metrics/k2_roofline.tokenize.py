"""`k2_roofline.tokenize` (%), read by ``_tokenize.k2_roofline``; it moves `tokenize_audio_s_per_s`."""
from portbench.metrics._tokenize import k2_roofline as read  # noqa: F401
