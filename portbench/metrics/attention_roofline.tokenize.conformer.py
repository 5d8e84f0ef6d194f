"""`attention_roofline.tokenize.conformer` (%), read by ``_spans.attention_roofline``; it moves `tokenize_audio_s_per_s.conformer`."""
from portbench.metrics._spans import attention_roofline as read  # noqa: F401
