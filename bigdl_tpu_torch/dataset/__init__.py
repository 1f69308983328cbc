"""Data pipeline of the port (counterpart of ``bigdl_tpu/dataset``)."""
