"""Caffe ``.caffemodel`` import (counterpart of ``bigdl_tpu/interop/caffe.py``;
BigDL's ``utils/CaffeLoader.scala:38``; "reference" below means BigDL's
Scala).

Weights are copied **by layer name** into an existing model
(``CaffeLoader.copyParameters``, ``CaffeLoader.scala:132``). The protobuf
wire format is walked with ``utils/protowire.py`` over a table of the few
field numbers needed (caffe.proto):

    NetParameter:      name=1, layers(V1)=2, layer=100
    LayerParameter:    name=1, type=2 (string), blobs=7
    V1LayerParameter:  name=4, type=5 (enum), blobs=6
    BlobProto:         num=1 channels=2 height=3 width=4 (legacy 4-D),
                       data=5 (packed float), double_data=8, shape=7
    BlobShape:         dim=1 (packed int64)

Layouts: Caffe's convolution blobs are (O, I/g, kH, kW), the port's conv
weight is HWIO (kH, kW, I/g, O); Deconvolution blobs are (I, O/g, kH, kW),
the port's transposed conv weight (kH, kW, O/g, I); InnerProduct blobs are
(out, in), as the port's ``Linear``. Covered: Convolution, InnerProduct,
Deconvolution, BatchNorm (its statistics divided by the scale-factor blob;
gamma and beta live in Caffe's separate Scale layer, so mirror it with
``SpatialBatchNormalization(affine=False)`` and an ``nn.Scale``), Scale,
PReLU, Embed. A name-matched layer with blobs whose module has parameters
but no mapping raises rather than keep random weights.

Every copy lands in the module's existing parameter or buffer, in place,
on its device and in its dtype (``Tensor.copy_`` under ``no_grad``): the
reference rebinds ``module.weight`` to a new array, which in PyTorch would
detach the parameter from an optimizer that already holds it. A blob whose
size does not fill the tensor raises.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.utils.protowire import WT_I32 as _WT_I32
from bigdl_tpu_torch.utils.protowire import WT_LEN as _WT_LEN
from bigdl_tpu_torch.utils.protowire import WT_VARINT as _WT_VARINT
from bigdl_tpu_torch.utils.protowire import iter_fields as _iter_fields
from bigdl_tpu_torch.utils.protowire import read_varint as _read_varint

logger = logging.getLogger("bigdl_tpu_torch.interop")

# V1LayerParameter.LayerType enum values (caffe.proto V1 enum; the ones a
# weight walk can encounter — others surface as their number)
_V1_TYPES = {0: "None", 4: "Convolution", 5: "Data", 14: "InnerProduct",
             17: "Pooling", 18: "ReLU", 19: "Sigmoid", 26: "Power",
             39: "Deconvolution"}


def _parse_blob(buf: memoryview) -> np.ndarray:
    shape: List[int] = []
    legacy = [0, 0, 0, 0]  # num, channels, height, width
    pieces: List[np.ndarray] = []
    for field, wt, val in _iter_fields(buf):
        if field == 7 and wt == _WT_LEN:  # BlobShape
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    if w2 == _WT_LEN:  # packed int64
                        pos = 0
                        while pos < len(v2):
                            d, pos = _read_varint(v2, pos)
                            shape.append(d)
                    elif w2 == _WT_VARINT:
                        shape.append(v2)
        elif field in (1, 2, 3, 4) and wt == _WT_VARINT:
            legacy[field - 1] = val
        elif field == 5 and wt == _WT_LEN:  # packed float data — protobuf
            # allows one packed field split across several LEN records;
            # parsers must concatenate (done once, below)
            pieces.append(np.frombuffer(bytes(val), dtype="<f4"))
        elif field == 8 and wt == _WT_LEN:  # packed double data
            pieces.append(np.frombuffer(bytes(val), dtype="<f8")
                          .astype(np.float32))
        elif field == 5 and wt == _WT_I32:  # unpacked float (rare)
            pieces.append(np.frombuffer(bytes(val), dtype="<f4"))
    if not pieces:
        return np.zeros((0,), dtype=np.float32)
    data = pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
    if not shape and any(legacy):
        shape = [d for d in legacy]
        # legacy blobs are padded with 1s in the leading dims; keep all 4
        shape = [d if d else 1 for d in shape]
    if shape and int(np.prod(shape)) == data.size:
        data = data.reshape(shape)
    return data.astype(np.float32)


class CaffeLayer:
    def __init__(self, name: str, type_: str, blobs: List[np.ndarray]):
        self.name = name
        self.type = type_
        self.blobs = blobs

    def __repr__(self):
        return (f"CaffeLayer({self.name!r}, {self.type!r}, "
                f"blobs={[b.shape for b in self.blobs]})")


def parse_caffemodel(path: str) -> List[CaffeLayer]:
    """Extract every weight-carrying layer from a binary ``.caffemodel``."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    layers: List[CaffeLayer] = []
    for field, wt, val in _iter_fields(buf):
        if wt != _WT_LEN or field not in (2, 100):
            continue
        name, type_, blobs = "", "", []
        if field == 100:  # LayerParameter
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == _WT_LEN:
                    name = bytes(v2).decode("utf-8", "replace")
                elif f2 == 2 and w2 == _WT_LEN:
                    type_ = bytes(v2).decode("utf-8", "replace")
                elif f2 == 7 and w2 == _WT_LEN:
                    blobs.append(_parse_blob(v2))
        else:  # V1LayerParameter
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 4 and w2 == _WT_LEN:
                    name = bytes(v2).decode("utf-8", "replace")
                elif f2 == 5 and w2 == _WT_VARINT:
                    type_ = _V1_TYPES.get(v2, str(v2))
                elif f2 == 6 and w2 == _WT_LEN:
                    blobs.append(_parse_blob(v2))
        if name:
            layers.append(CaffeLayer(name, type_, blobs))
    return layers


def parse_prototxt_layers(def_path: str) -> List[CaffeLayer]:
    """Layer definitions from a ``.prototxt`` model definition (reference
    ``CaffeLoader.loadBinary`` merges the text NetParameter first,
    ``CaffeLoader.scala:63-66``). Text-format blobs (rare, but legal — e.g.
    the reference test fixture ``caffe/test_persist.prototxt``) are decoded
    into arrays like their binary counterparts."""
    from bigdl_tpu_torch.interop import prototxt as pt
    net = pt.parse_file(def_path)
    layers: List[CaffeLayer] = []
    for entry in net.get("layer", []) + net.get("layers", []):
        name = pt.first(entry, "name", "")
        type_ = pt.first(entry, "type", "")
        if isinstance(type_, int):  # V1 enum number
            type_ = _V1_TYPES.get(type_, str(type_))
        blobs = []
        for blob in entry.get("blobs", []):
            data = np.asarray(blob.get("data", []), np.float32)
            shape = blob.get("shape")
            if shape:
                dims = shape[0].get("dim", [])
            else:
                dims = [pt.first(blob, k, 0)
                        for k in ("num", "channels", "height", "width")]
                dims = [d if d else 1 for d in dims] if any(dims) else []
            if dims and int(np.prod(dims)) == data.size:
                data = data.reshape(dims)
            blobs.append(data)
        if name:
            layers.append(CaffeLayer(str(name), str(type_), blobs))
    return layers


def _assign(target: torch.Tensor, value: np.ndarray,
            layer: CaffeLayer) -> None:
    """Copy ``value`` into ``target`` in place, on its device and in its
    dtype."""
    value = np.ascontiguousarray(value, np.float32)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f"caffe layer {layer.name!r}: a blob of shape "
                         f"{value.shape} for a tensor of shape "
                         f"{tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(torch.from_numpy(value))


class CaffeLoader:
    """Copy caffemodel weights by layer name into an existing model
    (reference ``CaffeLoader.copyParameters``). ``def_path`` merges the
    prototxt definition the way ``TextFormat.merge`` + binary ``mergeFrom``
    do: the definition contributes the layer-name universe (and any text
    blobs); binary blobs win when both exist."""

    def __init__(self, model, model_path: str, match_all: bool = True,
                 def_path: Optional[str] = None):
        self.model = model
        self.model_path = model_path
        self.match_all = match_all
        self.def_path = def_path

    def _copy_conv(self, module, layer: CaffeLayer) -> None:
        w = layer.blobs[0]
        if w.ndim != 4:
            w = w.reshape(module.n_output_plane, -1,
                          module.kernel_h, module.kernel_w)
        # OIHW -> HWIO
        _assign(module.weight, np.transpose(w, (2, 3, 1, 0)), layer)
        if len(layer.blobs) > 1 and getattr(module, "with_bias", True):
            _assign(module.bias, layer.blobs[1].reshape(-1), layer)

    def _copy_linear(self, module, layer: CaffeLayer) -> None:
        w = layer.blobs[0].reshape(module.output_size, module.input_size)
        _assign(module.weight, w, layer)   # Caffe's (out, in) is the port's
        if len(layer.blobs) > 1 and getattr(module, "with_bias", True):
            _assign(module.bias, layer.blobs[1].reshape(-1), layer)

    def _copy_deconv(self, module, layer: CaffeLayer) -> None:
        w = layer.blobs[0]
        if w.ndim != 4:   # Caffe's deconvolution blob: (I, O/g, kH, kW)
            w = w.reshape(module.n_input_plane,
                          module.n_output_plane // module.n_group,
                          module.kh, module.kw)
        # (I, O/g, kH, kW) -> the port's (kH, kW, O/g, I)
        _assign(module.weight, np.transpose(w, (2, 3, 1, 0)), layer)
        if len(layer.blobs) > 1 and getattr(module, "with_bias", True):
            _assign(module.bias, layer.blobs[1].reshape(-1), layer)

    def _copy_batchnorm(self, module, layer: CaffeLayer) -> None:
        """Caffe's "BatchNorm" blobs are [mean, var, scale_factor]: the
        statistics are stored multiplied by the scalar scale factor (its
        moving-average accumulator), so they are divided by it here."""
        mean = layer.blobs[0].reshape(-1)
        var = layer.blobs[1].reshape(-1)
        sf = 1.0
        if len(layer.blobs) > 2 and layer.blobs[2].size:
            raw = float(layer.blobs[2].reshape(-1)[0])
            sf = 0.0 if raw == 0.0 else 1.0 / raw
        _assign(module.running_mean, mean * sf, layer)
        _assign(module.running_var, var * sf, layer)

    def _copy_scale(self, module, layer: CaffeLayer) -> None:
        gamma = layer.blobs[0].reshape(-1)
        _assign(module.cmul.weight,
                gamma.reshape(tuple(module.cmul.weight.shape)), layer)
        if len(layer.blobs) > 1:
            beta = layer.blobs[1].reshape(-1)
            _assign(module.cadd.bias,
                    beta.reshape(tuple(module.cadd.bias.shape)), layer)

    def _copy_prelu(self, module, layer: CaffeLayer) -> None:
        slopes = layer.blobs[0].reshape(-1)
        _assign(module.weight, slopes.reshape(tuple(module.weight.shape)),
                layer)

    def _copy_embed(self, module, layer: CaffeLayer) -> None:
        if len(layer.blobs) > 1:
            # Caffe's Embed has bias_term=true by default; LookupTable has
            # no bias to hold it
            raise ValueError(
                f"caffe Embed layer {layer.name!r} carries a bias blob; "
                "LookupTable cannot represent it — follow the embedding "
                "with nn.CAdd (named to a Scale/Bias layer) or retrain "
                "with bias_term=false")
        w = layer.blobs[0].reshape(module.n_index, module.n_output)
        _assign(module.weight, w, layer)

    def copy_parameters(self):
        from bigdl_tpu_torch import nn
        layers: Dict[str, CaffeLayer] = {}
        def_names = set()
        if self.def_path:
            defs = parse_prototxt_layers(self.def_path)
            def_names = {l.name for l in defs}
            layers.update((l.name, l) for l in defs)
        for l in parse_caffemodel(self.model_path):
            if l.blobs or l.name not in layers:
                layers[l.name] = l  # binary blobs win over text definition
        copied, missed = [], []
        weighted = (nn.Linear, nn.SpatialConvolution, nn.SpaceToDepthConv7,
                    nn.SpatialFullConvolution, nn.BatchNormalization,
                    nn.Scale, nn.PReLU, nn.LookupTable)
        for _, module in self.model.named_modules():
            lname = module.get_name()
            layer = layers.get(lname)
            if layer is None:
                if isinstance(module, weighted):
                    missed.append(lname)
                continue
            if not layer.blobs:
                if lname in def_names:
                    # declared in the definition but weightless: it keeps
                    # its initial parameters (CaffeLoader.scala:150-155)
                    if isinstance(module, weighted):
                        logger.info("%s uses initialized parameters", lname)
                else:
                    # a blobless layer in the binary itself is a missing
                    # weight (truncated/deploy-only caffemodel), not a
                    # benign definition entry
                    if isinstance(module, weighted):
                        missed.append(lname)
                continue
            if isinstance(module, (nn.SpatialConvolution,
                                   nn.SpaceToDepthConv7)):
                self._copy_conv(module, layer)
            elif isinstance(module, nn.SpatialFullConvolution):
                self._copy_deconv(module, layer)
            elif isinstance(module, nn.Linear):
                self._copy_linear(module, layer)
            elif isinstance(module, nn.BatchNormalization):
                self._copy_batchnorm(module, layer)
            elif isinstance(module, nn.Scale):
                self._copy_scale(module, layer)
            elif isinstance(module, nn.PReLU):
                self._copy_prelu(module, layer)
            elif isinstance(module, nn.LookupTable):
                self._copy_embed(module, layer)
            elif any(True for _ in module.parameters()):
                # name-matched, with blobs, but no mapping: keeping random
                # weights would be wrong, so refuse (children's parameters
                # count too)
                raise ValueError(
                    f"caffe layer {lname!r} (type {layer.type!r}, "
                    f"{len(layer.blobs)} blobs) matches parametric module "
                    f"{type(module).__name__} with no weight mapping")
            else:
                continue
            copied.append(lname)
        if missed and self.match_all:
            raise ValueError(
                f"caffemodel is missing weights for layers {missed}; "
                f"pass match_all=False to load a partial match "
                f"(reference CaffeLoader.scala:132 contract)")
        for lname in missed:
            logger.warning("no caffe weights for layer %s", lname)
        logger.info("copied caffe weights for %d layers", len(copied))
        return self.model


def load_caffe(model, *paths: str, match_all: bool = True):
    """Reference ``Module.loadCaffe(defPath, modelPath, matchAll)``
    (``CaffeLoader.scala:154``). Accepts either ``load_caffe(model,
    model_path)`` — names live in the caffemodel, so the definition is
    optional — or the reference's full ``load_caffe(model, def_path,
    model_path)`` form."""
    if len(paths) == 1:
        def_path, model_path = None, paths[0]
    elif len(paths) == 2:
        def_path, model_path = paths
    else:
        raise TypeError("load_caffe(model, [def_path,] model_path)")
    return CaffeLoader(model, model_path, match_all,
                       def_path=def_path).copy_parameters()


def load_mean_file(path: str) -> np.ndarray:
    """Read a caffe ``.binaryproto`` mean image (a bare serialized BlobProto,
    reference ``example/loadmodel/DatasetUtil.scala`` AlexNetPreprocessor).
    Returns (H, W, C) float32 in caffe's BGR channel order."""
    with open(path, "rb") as f:
        arr = _parse_blob(memoryview(f.read()))
    if arr.ndim == 4:  # legacy (1, C, H, W)
        arr = arr[0]
    if arr.ndim != 3:
        raise ValueError(f"mean file {path} has shape {arr.shape}; "
                         f"expected a (C, H, W) image blob")
    return np.transpose(arr, (1, 2, 0))  # CHW -> HWC
