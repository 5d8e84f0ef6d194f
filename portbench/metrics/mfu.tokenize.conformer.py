"""`mfu.tokenize.conformer` (%), read by ``_tokenize.mfu``; it moves `tokenize_audio_s_per_s.conformer`."""
from portbench.metrics._tokenize import mfu as read  # noqa: F401
