"""`k1_roofline.tokenize` (%), read by ``_tokenize.k1_roofline``; it moves `tokenize_audio_s_per_s`."""
from portbench.metrics._tokenize import k1_roofline as read  # noqa: F401
