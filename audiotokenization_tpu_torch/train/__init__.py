"""The GAN training step and its state (counterpart of
``audiotokenization_tpu/train``: the step, its optimizers and schedule, and
the codebook histogram)."""
