"""Weight interchange (counterpart of ``bigdl_tpu/interop``): Torch ``.t7``
and Caffe ``.caffemodel`` import and export (``torch_file``, ``caffe``,
``prototxt``), the LM state dicts (``state_dict``), Hugging Face
checkpoints and tokenizers (``hf``, ``hf_tokenizer``) and SentencePiece
(``sentencepiece``).
"""

from bigdl_tpu_torch.interop.caffe import CaffeLoader, load_caffe
from bigdl_tpu_torch.interop.torch_file import load_torch, save_torch

__all__ = ["load_torch", "save_torch", "CaffeLoader", "load_caffe"]
