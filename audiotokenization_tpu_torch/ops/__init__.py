"""Tensor ops: convolutions, snake, LSTM, and the CUDA kernels (``cuda/``)."""
