"""GAN training losses (counterpart of ``audiotokenization_tpu/losses``)."""
