"""`ffn_roofline.tokenize.conformer` (%), read by ``_spans.ffn_roofline``; it moves `tokenize_audio_s_per_s.conformer`."""
from portbench.metrics._spans import ffn_roofline as read  # noqa: F401
