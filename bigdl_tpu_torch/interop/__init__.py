"""Weight interchange (counterpart of ``bigdl_tpu/interop``)."""
