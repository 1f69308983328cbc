"""Torch7 ``.t7`` binary serialization (counterpart of
``bigdl_tpu/interop/torch_file.py``; BigDL's ``utils/TorchFile.scala:67``).

The Torch object-stream wire format (typed records with an object-reuse
index), and a table mapping Lua ``nn.*`` classes to and from the port's
modules. The same object tree gives the same bytes as the reference's
writer.

Wire format (binary, little-endian):

    object  := int32 type_tag , payload
    tag 0 nil | 1 number (f64) | 2 string (i32 len + bytes) | 3 table |
    4 torch-object | 5 boolean (i32) | 6/7/8 function (skipped on read)
    table   := i32 index , i32 count , count * (key object, value object)
    torch   := i32 index , [string version "V 1"] , string class , payload
    Tensor  := i32 ndim , i64[ndim] size , i64[ndim] stride ,
               i64 storageOffset (1-based) , object storage
    Storage := i64 size , raw elements

Tables and torch objects share one index space; a repeated index refers
back to the object already read, so a shared object is written once.

Modules are written from their tensors on the host (weights as f64, as
Torch's ``nn`` saves them) and read into modules built on the CPU, then
moved to ``load_torch``'s ``device`` (the card by default). A Torch conv
saved without a bias loads as a conv without one; the reference keeps a
randomly initialised bias there.
"""


from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_LEGACY_RECUR_FUNCTION = 7
TYPE_RECUR_FUNCTION = 8

_TENSOR_DTYPES = {
    "torch.DoubleTensor": np.float64, "torch.FloatTensor": np.float32,
    "torch.LongTensor": np.int64, "torch.IntTensor": np.int32,
    "torch.ShortTensor": np.int16, "torch.ByteTensor": np.uint8,
    "torch.CharTensor": np.int8,
}
_STORAGE_DTYPES = {
    "torch.DoubleStorage": np.float64, "torch.FloatStorage": np.float32,
    "torch.LongStorage": np.int64, "torch.IntStorage": np.int32,
    "torch.ShortStorage": np.int16, "torch.ByteStorage": np.uint8,
    "torch.CharStorage": np.int8,
}
_DTYPE_TO_TENSOR = {np.dtype(v): k for k, v in _TENSOR_DTYPES.items()}
_TENSOR_TO_STORAGE = {
    t: t.replace("Tensor", "Storage") for t in _TENSOR_DTYPES}


class TorchObject:
    """A decoded ``torch.*``/``nn.*`` object: class name + field table."""

    def __init__(self, torch_type: str, fields: Any):
        self.torch_type = torch_type
        self.fields = fields

    def __getitem__(self, key):
        return self.fields[key]

    def get(self, key, default=None):
        try:
            return self.fields.get(key, default)
        except AttributeError:
            return default

    def __repr__(self):
        return f"TorchObject({self.torch_type})"


# ===================================================================== reader

class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.objects: Dict[int, Any] = {}

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        data = self.f.read(size)
        if len(data) < size:
            raise EOFError("truncated .t7 file")
        return struct.unpack(fmt, data)[0]

    def read_int(self) -> int:
        return self._read("<i")

    def read_long(self) -> int:
        return self._read("<q")

    def read_string(self) -> str:
        n = self.read_int()
        return self.f.read(n).decode("latin-1")

    def read_object(self) -> Any:
        tag = self.read_int()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            return self._read("<d")
        if tag == TYPE_STRING:
            return self.read_string()
        if tag == TYPE_BOOLEAN:
            return bool(self.read_int())
        if tag in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                   TYPE_LEGACY_RECUR_FUNCTION):
            # size-prefixed dump + upvalue table; skip both
            n = self.read_int()
            self.f.read(n)
            self.read_object()
            return None
        if tag == TYPE_TABLE:
            index = self.read_int()
            if index in self.objects:
                return self.objects[index]
            out: Dict[Any, Any] = {}
            self.objects[index] = out
            count = self.read_int()
            for _ in range(count):
                key = self.read_object()
                val = self.read_object()
                if isinstance(key, float) and key.is_integer():
                    key = int(key)
                out[key] = val
            return out
        if tag == TYPE_TORCH:
            index = self.read_int()
            if index in self.objects:
                return self.objects[index]
            version = self.read_string()
            if version.startswith("V "):
                cls = self.read_string()
            else:
                cls = version
            obj = self._read_torch_payload(cls, index)
            return obj
        raise ValueError(f"unsupported .t7 type tag {tag}")

    def _read_torch_payload(self, cls: str, index: int) -> Any:
        if cls in _TENSOR_DTYPES:
            # reserve slot first; sub-reads can't reference the tensor itself
            self.objects[index] = None
            ndim = self.read_int()
            sizes = [self.read_long() for _ in range(ndim)]
            strides = [self.read_long() for _ in range(ndim)]
            offset = self.read_long() - 1
            storage = self.read_object()
            if storage is None or ndim == 0 or 0 in sizes:
                arr = np.zeros(sizes or (0,), dtype=_TENSOR_DTYPES[cls])
            else:
                # bound-check file-supplied geometry before as_strided — a
                # corrupt header must not address memory outside the storage
                last = offset + sum(st * (sz - 1)
                                    for sz, st in zip(sizes, strides))
                if (offset < 0 or any(s < 0 for s in sizes + strides)
                        or last >= storage.size
                        or offset >= storage.size):
                    raise ValueError(
                        f".t7 tensor geometry out of bounds: sizes={sizes} "
                        f"strides={strides} offset={offset} "
                        f"storage={storage.size}")
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:], shape=sizes,
                    strides=[s * storage.itemsize for s in strides]).copy()
            self.objects[index] = arr
            return arr
        if cls in _STORAGE_DTYPES:
            dtype = np.dtype(_STORAGE_DTYPES[cls])
            size = self.read_long()
            data = self.f.read(size * dtype.itemsize)
            arr = np.frombuffer(data, dtype=dtype).copy()
            self.objects[index] = arr
            return arr
        # generic torch class (nn.*): payload is one object (its field table)
        obj = TorchObject(cls, {})
        self.objects[index] = obj
        obj.fields = self.read_object()
        return obj


# ===================================================================== writer

class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.next_index = 1
        self.seen: Dict[int, int] = {}
        self._keepalive: List[Any] = []  # pin ids in `seen` against reuse

    def _write(self, fmt: str, value) -> None:
        self.f.write(struct.pack(fmt, value))

    def write_int(self, v: int) -> None:
        self._write("<i", v)

    def write_long(self, v: int) -> None:
        self._write("<q", v)

    def write_string(self, s: str) -> None:
        data = s.encode("latin-1")
        self.write_int(len(data))
        self.f.write(data)

    def write_object(self, obj: Any) -> None:
        if obj is None:
            self.write_int(TYPE_NIL)
        elif isinstance(obj, bool):
            self.write_int(TYPE_BOOLEAN)
            self.write_int(int(obj))
        elif isinstance(obj, (int, float)):
            self.write_int(TYPE_NUMBER)
            self._write("<d", float(obj))
        elif isinstance(obj, str):
            self.write_int(TYPE_STRING)
            self.write_string(obj)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, dict):
            self._write_table(obj)
        elif isinstance(obj, TorchObject):
            self._write_torch(obj)
        else:
            raise TypeError(f"cannot serialize {type(obj)} to .t7")

    def _alloc(self, obj: Any) -> Optional[int]:
        """Index bookkeeping; returns None if obj was already written."""
        key = id(obj)
        if key in self.seen:
            self.write_int(self.seen[key])
            return None
        idx = self.next_index
        self.next_index += 1
        self.seen[key] = idx
        self._keepalive.append(obj)  # a freed id could be recycled by a new
        self.write_int(idx)          # object, faking a back-reference
        return idx

    def _write_table(self, table: dict) -> None:
        self.write_int(TYPE_TABLE)
        if self._alloc(table) is None:
            return
        self.write_int(len(table))
        for k, v in table.items():
            self.write_object(float(k) if isinstance(k, int) else k)
            self.write_object(v)

    def _write_tensor(self, arr: np.ndarray) -> None:
        cls = _DTYPE_TO_TENSOR.get(arr.dtype)
        if cls is None:
            arr = arr.astype(np.float32)
            cls = "torch.FloatTensor"
        arr = np.ascontiguousarray(arr)
        self.write_int(TYPE_TORCH)
        if self._alloc(arr) is None:
            return
        self.write_string("V 1")
        self.write_string(cls)
        self.write_int(arr.ndim)
        for s in arr.shape:
            self.write_long(s)
        stride = 1
        strides = []
        for s in reversed(arr.shape):
            strides.append(stride)
            stride *= s
        for s in reversed(strides):
            self.write_long(s)
        self.write_long(1)  # storageOffset, 1-based
        # storage object
        self.write_int(TYPE_TORCH)
        storage_idx = self.next_index
        self.next_index += 1
        self.write_int(storage_idx)
        self.write_string("V 1")
        self.write_string(_TENSOR_TO_STORAGE[cls])
        self.write_long(arr.size)
        self.f.write(arr.tobytes())

    def _write_torch(self, obj: TorchObject) -> None:
        # the torch object and its payload table get distinct indices
        # (the table is written through write_object with its own _alloc)
        self.write_int(TYPE_TORCH)
        if self._alloc(obj) is None:
            return
        self.write_string("V 1")
        self.write_string(obj.torch_type)
        self.write_object(obj.fields)


# ============================================================ module mapping

def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as f64 numpy on the host (Torch's ``nn`` saves doubles)."""
    return t.detach().to("cpu", torch.float64).numpy()


def _set(target: torch.Tensor, value) -> None:
    """Copy ``value`` into ``target`` in place, in ``target``'s dtype."""
    value = np.ascontiguousarray(value, np.float32)
    if tuple(value.shape) != tuple(target.shape):
        raise ValueError(f".t7 tensor of shape {value.shape} for a tensor "
                         f"of shape {tuple(target.shape)}")
    with torch.no_grad():
        target.copy_(torch.from_numpy(value))


def _empty() -> np.ndarray:
    return np.zeros((0,), dtype=np.float32)


def _base_fields(extra: dict) -> dict:
    out = {"output": _empty(), "gradInput": _empty(), "train": False}
    out.update(extra)
    return out


def _conv_to_torch(m) -> TorchObject:
    # the port's HWIO (kH, kW, I/g, O) -> Torch's (O, I/g, kH, kW), groups
    # folded flat as BigDL's nn.SpatialConvolution writes them
    w = np.ascontiguousarray(np.transpose(_host(m.weight), (3, 2, 0, 1)))
    fields = {
        "nInputPlane": m.n_input_plane, "nOutputPlane": m.n_output_plane,
        "kW": m.kernel_w, "kH": m.kernel_h, "dW": m.stride_w, "dH": m.stride_h,
        "padW": m.pad_w, "padH": m.pad_h, "nGroup": m.n_group,
        "weight": w, "gradWeight": np.zeros_like(w),
    }
    if getattr(m, "bias", None) is not None:
        b = _host(m.bias)
        fields["bias"] = b
        fields["gradBias"] = np.zeros_like(b)
    return TorchObject("nn.SpatialConvolution", _base_fields(fields))


def _conv_from_torch(obj: TorchObject):
    from bigdl_tpu_torch import nn
    f = obj.fields
    w = np.asarray(f["weight"], dtype=np.float32)
    n_group = w.shape[0] if w.ndim == 5 else int(f.get("nGroup", 1))
    m = nn.SpatialConvolution(
        int(f["nInputPlane"]), int(f["nOutputPlane"]),
        int(f["kW"]), int(f["kH"]), int(f["dW"]), int(f["dH"]),
        int(f.get("padW", 0)), int(f.get("padH", 0)), n_group=n_group,
        with_bias=f.get("bias") is not None)
    if w.ndim == 5:   # BigDL's group layout (G, O/g, I/g, kH, kW): flatten
        w = w.reshape(-1, *w.shape[2:])
    elif w.ndim == 2:   # nn.SpatialConvolutionMM: (O, I*kH*kW)
        w = w.reshape(int(f["nOutputPlane"]), -1,
                      int(f["kH"]), int(f["kW"]))
    # flat (O, I/g, kH, kW) -> HWIO (kH, kW, I/g, O), groups kept
    _set(m.weight, np.transpose(w, (2, 3, 1, 0)))
    if f.get("bias") is not None:
        _set(m.bias, f["bias"])
    return m


def _linear_to_torch(m) -> TorchObject:
    w = _host(m.weight)   # the port's (out, in) is Torch's
    fields = {"weight": w, "gradWeight": np.zeros_like(w)}
    if getattr(m, "bias", None) is not None:
        b = _host(m.bias)
        fields["bias"] = b
        fields["gradBias"] = np.zeros_like(b)
    return TorchObject("nn.Linear", _base_fields(fields))


def _linear_from_torch(obj: TorchObject):
    from bigdl_tpu_torch import nn
    w = np.asarray(obj["weight"], dtype=np.float32)
    m = nn.Linear(w.shape[1], w.shape[0],
                  with_bias=obj.get("bias") is not None)
    _set(m.weight, w)
    if obj.get("bias") is not None:
        _set(m.bias, obj["bias"])
    return m


def _bn_to_torch(m, cls: str) -> TorchObject:
    fields = {
        "nOutput": m.n_output, "eps": m.eps, "momentum": m.momentum,
        "running_mean": _host(m.running_mean),
        "running_var": _host(m.running_var),
        "affine": getattr(m, "weight", None) is not None,
    }
    if getattr(m, "weight", None) is not None:
        fields["weight"] = _host(m.weight)
        fields["bias"] = _host(m.bias)
        fields["gradWeight"] = np.zeros_like(fields["weight"])
        fields["gradBias"] = np.zeros_like(fields["bias"])
    return TorchObject(cls, _base_fields(fields))


def _bn_from_torch(obj: TorchObject, spatial: bool):
    from bigdl_tpu_torch import nn
    mean = np.asarray(obj["running_mean"], dtype=np.float32)
    cls = nn.SpatialBatchNormalization if spatial else nn.BatchNormalization
    m = cls(mean.shape[0], eps=float(obj.get("eps", 1e-5)),
            momentum=float(obj.get("momentum", 0.1)),
            affine=obj.get("weight") is not None)
    _set(m.running_mean, mean)
    _set(m.running_var, obj["running_var"])
    if obj.get("weight") is not None:
        _set(m.weight, obj["weight"])
        _set(m.bias, obj["bias"])
    return m


def _pool_to_torch(m, cls: str) -> TorchObject:
    fields = {"kW": m.kw, "kH": m.kh, "dW": m.dw, "dH": m.dh,
              "padW": m.pad_w, "padH": m.pad_h,
              "ceil_mode": getattr(m, "ceil_mode", False)}
    return TorchObject(cls, _base_fields(fields))


def _pool_from_torch(obj: TorchObject, avg: bool):
    from bigdl_tpu_torch import nn
    cls = nn.SpatialAveragePooling if avg else nn.SpatialMaxPooling
    m = cls(int(obj["kW"]), int(obj["kH"]), int(obj["dW"]), int(obj["dH"]),
            int(obj.get("padW", 0)), int(obj.get("padH", 0)))
    if obj.get("ceil_mode"):
        m.ceil_mode = True
    return m


def _seq_children(obj: TorchObject) -> List[Any]:
    mods = obj.get("modules", {}) or {}
    return [mods[k] for k in sorted(k for k in mods if isinstance(k, int))]


def _container_to_torch(m, cls: str) -> TorchObject:
    modules = {i + 1: to_torch_object(child)
               for i, child in enumerate(m._modules.values())}
    return TorchObject(cls, _base_fields({"modules": modules}))


def _reshape_from_torch(obj: TorchObject):
    from bigdl_tpu_torch import nn
    size = np.asarray(obj["size"], dtype=np.int64).tolist()
    return nn.Reshape(tuple(int(s) for s in size))


def to_torch_object(m) -> TorchObject:
    """A port module as a TorchObject tree (reference ``to_torch_object``;
    an unmapped class raises)."""
    from bigdl_tpu_torch import nn
    simple = {
        nn.Tanh: "nn.Tanh", nn.Sigmoid: "nn.Sigmoid",
        nn.SoftMax: "nn.SoftMax", nn.LogSoftMax: "nn.LogSoftMax",
        nn.Identity: "nn.Identity",
    }
    if isinstance(m, nn.Linear):
        return _linear_to_torch(m)
    if isinstance(m, (nn.SpatialConvolution, nn.SpaceToDepthConv7)):
        # the space-to-depth stem is a 7x7/s2 conv: written as one
        return _conv_to_torch(m)
    if isinstance(m, nn.SpatialBatchNormalization):
        return _bn_to_torch(m, "nn.SpatialBatchNormalization")
    if isinstance(m, nn.BatchNormalization):
        return _bn_to_torch(m, "nn.BatchNormalization")
    if isinstance(m, nn.SpatialMaxPooling):
        return _pool_to_torch(m, "nn.SpatialMaxPooling")
    if isinstance(m, nn.SpatialAveragePooling):
        return _pool_to_torch(m, "nn.SpatialAveragePooling")
    if isinstance(m, nn.ReLU):
        return TorchObject("nn.ReLU", _base_fields(
            {"threshold": 0.0, "val": 0.0, "inplace": False}))
    if isinstance(m, nn.Dropout):
        return TorchObject("nn.Dropout", _base_fields({"p": m.p}))
    if isinstance(m, nn.View):   # a subclass of Reshape: tested first
        return TorchObject("nn.View", _base_fields(
            {"size": np.asarray(m.size, dtype=np.int64)}))
    if isinstance(m, nn.Reshape):
        return TorchObject("nn.Reshape", _base_fields(
            {"size": np.asarray(m.size, dtype=np.int64),
             "nelement": float(int(np.prod(m.size)))}))
    if isinstance(m, nn.Sequential):
        return _container_to_torch(m, "nn.Sequential")
    if isinstance(m, nn.ConcatTable):
        return _container_to_torch(m, "nn.ConcatTable")
    if isinstance(m, nn.Concat):
        obj = _container_to_torch(m, "nn.Concat")
        obj.fields["dimension"] = float(m.dimension)
        return obj
    for cls, name in simple.items():
        if isinstance(m, cls):
            return TorchObject(name, _base_fields({}))
    raise ValueError(f"no .t7 mapping for module {type(m).__name__} "
                     f"(reference TorchFile supports a fixed class table)")


def from_torch_object(obj: Any):
    """A TorchObject tree as port modules on the CPU (reference
    ``from_torch_object``; an unmapped class raises)."""
    from bigdl_tpu_torch import nn
    if not isinstance(obj, TorchObject):
        raise ValueError(f"expected a torch nn object, got {type(obj)}")
    t = obj.torch_type
    simple = {
        "nn.Tanh": nn.Tanh, "nn.Sigmoid": nn.Sigmoid,
        "nn.SoftMax": nn.SoftMax, "nn.LogSoftMax": nn.LogSoftMax,
        "nn.Identity": nn.Identity, "nn.ReLU": nn.ReLU,
    }
    if t == "nn.Linear":
        return _linear_from_torch(obj)
    if t in ("nn.SpatialConvolution", "nn.SpatialConvolutionMM"):
        return _conv_from_torch(obj)
    if t == "nn.BatchNormalization":
        return _bn_from_torch(obj, spatial=False)
    if t == "nn.SpatialBatchNormalization":
        return _bn_from_torch(obj, spatial=True)
    if t == "nn.SpatialMaxPooling":
        return _pool_from_torch(obj, avg=False)
    if t == "nn.SpatialAveragePooling":
        return _pool_from_torch(obj, avg=True)
    if t == "nn.Dropout":
        return nn.Dropout(float(obj.get("p", 0.5)))
    if t == "nn.Reshape":
        return _reshape_from_torch(obj)
    if t == "nn.View":
        size = np.asarray(obj["size"], dtype=np.int64).tolist()
        return nn.View(tuple(int(s) for s in size))
    if t == "nn.Threshold":
        return nn.Threshold(float(obj.get("threshold", 0.0)),
                            float(obj.get("val", 0.0)))
    if t in ("nn.Sequential", "nn.ConcatTable", "nn.Concat"):
        children = [from_torch_object(c) for c in _seq_children(obj)]
        if t == "nn.Sequential":
            out = nn.Sequential()
        elif t == "nn.ConcatTable":
            out = nn.ConcatTable()
        else:
            out = nn.Concat(int(obj.get("dimension", 1)))
        for c in children:
            out.add(c)
        return out
    if t in simple:
        return simple[t]()
    raise ValueError(f"no bigdl_tpu mapping for torch class {t!r}")


# ==================================================================== facade

def load_torch(path: str, as_module: bool = True,
               device: DeviceLike = "cuda"):
    """Read a ``.t7`` file (reference ``load_torch``). With ``as_module``
    the tree becomes port modules on ``device`` (the card by default; it
    raises without one unless ``device="cpu"``); with ``as_module=False``
    the raw tree (numbers, strings, dicts, arrays, TorchObjects)."""
    dev = resolve_device(device) if as_module else None
    with open(path, "rb") as f:
        obj = _Reader(f).read_object()
    return from_torch_object(obj).to(dev) if as_module else obj


def save_torch(obj, path: str, overwrite: bool = True) -> None:
    """Write a module (or a raw object tree) as ``.t7`` (reference
    ``save_torch``)."""
    import os
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    if isinstance(obj, torch.nn.Module):
        obj = to_torch_object(obj)
    with open(path, "wb") as f:
        _Writer(f).write_object(obj)
