"""Applications of the port (counterpart of ``bigdl_tpu/apps``)."""
