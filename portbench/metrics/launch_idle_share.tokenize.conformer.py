"""`launch_idle_share.tokenize.conformer` (%), read by ``_spans.launch_idle_share``; it moves `tokenize_audio_s_per_s.conformer`."""
from portbench.metrics._spans import launch_idle_share as read  # noqa: F401
