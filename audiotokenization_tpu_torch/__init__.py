"""audiotokenization_tpu_torch — the BigCodec tokenizer in PyTorch on CUDA.

The PyTorch/CUDA counterpart of ``audiotokenization_tpu``: the same module
layout, parameter names and (B, C, T) layouts, with hand-written Hopper
(sm_90a) CUDA kernels where the JAX package has Pallas kernels
(``csrc/``). This package imports neither jax nor the JAX package.

Covered so far: the flagship BigCodec serving path — ``models.codec.tokenize``
(wav -> encoder -> factorized-VQ argmin -> int codes) and
``codes_to_emb`` -> ``decode`` back to a waveform — its GAN training
step, ``train.step.make_train_step`` on a ``train.state.TrainState``, and
the training loop around it (``train.loop.train``, ``cli.train``: data,
validation, checkpoints, the ragged full-length test pass).
"""

__version__ = "0.1.0"
