"""Audio files and the training data pipeline (counterpart of
``audiotokenization_tpu/data``)."""
