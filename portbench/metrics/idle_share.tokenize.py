"""`idle_share.tokenize` (%), read by ``_tokenize.idle_share``; it moves `tokenize_audio_s_per_s`."""
from portbench.metrics._tokenize import idle_share as read  # noqa: F401
