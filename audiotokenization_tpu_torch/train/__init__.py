"""Training (counterpart of ``audiotokenization_tpu/train``): the GAN step,
its optimizers and schedule, the loop, checkpoints and evaluation
metrics."""
