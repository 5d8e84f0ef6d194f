"""Models: the BigCodec encoder/decoder and the codec facade."""
