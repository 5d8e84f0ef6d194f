"""`lstm_roofline.tokenize` (%), read by ``_spans.lstm_roofline``; it moves `tokenize_audio_s_per_s`."""
from portbench.metrics._spans import lstm_roofline as read  # noqa: F401
