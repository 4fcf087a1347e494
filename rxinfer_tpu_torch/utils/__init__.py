"""Instrumentation of the PyTorch port (counterpart of ``rxinfer_tpu/utils``)."""
