"""``Storage`` and ``Tensor`` (counterpart of ``bigdl_tpu/tensor/tensor.py``):
the reference's Torch-style API over a ``torch.Tensor`` on an explicit
device.

- Dimension and index arguments are 1-based (Torch's convention), as in
  the reference; negative values are not supported.
- Mutating methods (``fill``, ``zero``, ``copy``, ``add``, ``mul``, ...)
  write into this tensor's memory and return ``self``.
- Views (``select``, ``narrow``, ``transpose``, ``t``, ``view``,
  ``squeeze``, ``unsqueeze``, ``expand``, ``split``, ``chunk`` and integer
  ``[i]`` of an n-d tensor) share storage with their source, as Torch's
  do: a write through a view is seen by the source and the other way
  round. (The reference's arrays are immutable, so its views are copies.)
- ``storage()`` is the tensor's underlying storage, 1-based, and writes
  into it reach the tensor.
- Random fills draw from ``utils.rng.RandomGenerator.RNG()``, the host
  generator the reference draws from, so a seeded fill gives the
  reference's numbers.

A tensor is made on ``device`` (default ``"cuda"``, which raises without a
card; pass ``"cpu"``), or wraps a given ``torch.Tensor`` where it lies.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

Scalar = Union[int, float]


class Storage:
    """1-based, 1-D access to a tensor's elements (reference ``Storage``).
    Over a ``torch.Tensor`` it aliases that memory; over anything else
    (numpy, a list) it holds a host copy."""

    def __init__(self, data):
        if isinstance(data, torch.Tensor):
            self._data = data.reshape(-1) if data.dim() != 1 else data
        else:
            self._data = torch.from_numpy(np.array(data).ravel())

    def __len__(self) -> int:
        return self._data.numel()

    def _check(self, i: int) -> int:
        if not 1 <= i <= self._data.numel():
            raise IndexError(f"storage index {i} out of range "
                             f"[1, {self._data.numel()}] (1-based)")
        return i - 1

    def __getitem__(self, i: int) -> Scalar:
        return self._data[self._check(i)].item()

    def __setitem__(self, i: int, v: Scalar) -> None:
        self._data[self._check(i)] = v

    def array(self) -> np.ndarray:
        """The elements as numpy (the same memory for a CPU storage)."""
        return self._data.detach().cpu().numpy()

    def tensor(self) -> torch.Tensor:
        return self._data

    def __iter__(self):
        return iter(self.array())


def _is_scalar(x) -> bool:
    return isinstance(x, (int, float, np.integer, np.floating))


class Tensor:
    """N-d tensor with the reference's Torch-style API (reference
    ``Tensor``, math ``TensorMath``)::

        >>> t = Tensor(2, 3, device="cpu")
        >>> t.size()
        (2, 3)
        >>> t.fill(2.0).sum()
        12.0
        >>> t.select(1, 1).size()       # first row (1-based)
        (3,)
        >>> t.narrow(2, 2, 2).size()    # columns 2..3
        (2, 2)
    """

    __array_priority__ = 100   # numpy defers to our __r*__ operators

    def __init__(self, *args, dtype=None, device: DeviceLike = "cuda"):
        if len(args) == 1 and isinstance(args[0], torch.Tensor):
            # wraps the tensor where it lies (a view of it, not a copy)
            self.data = (args[0] if dtype is None
                         else args[0].to(_torch_dtype(dtype)))
            return
        if len(args) == 1 and isinstance(args[0], Tensor):
            self.data = args[0].data
            return
        dev = resolve_device(device)
        if len(args) == 1 and isinstance(args[0], np.ndarray):
            # an array keeps its dtype (index tensors, f64, ...)
            arr = np.ascontiguousarray(args[0])
            t = torch.from_numpy(arr.copy())
            self.data = (t if dtype is None else
                         t.to(_torch_dtype(dtype))).to(dev)
        elif len(args) == 1 and isinstance(args[0], (list, tuple)):
            self.data = torch.tensor(np.asarray(args[0]),
                                     dtype=_torch_dtype(dtype
                                                        or np.float32),
                                     device=dev)
        elif args:
            if not all(isinstance(a, (int, np.integer)) for a in args):
                raise TypeError(f"bad Tensor(...) arguments {args!r}")
            self.data = torch.zeros(tuple(int(a) for a in args),
                                    dtype=_torch_dtype(dtype or np.float32),
                                    device=dev)
        else:
            self.data = torch.zeros((0,), dtype=_torch_dtype(
                dtype or np.float32), device=dev)

    # ------------------------------------------------------------ structure
    def dim(self) -> int:
        return self.data.dim()

    n_dimension = dim

    def size(self, dim: Optional[int] = None):
        """size() -> tuple; size(d) -> int, d 1-based."""
        if dim is None:
            return tuple(self.data.shape)
        return self.data.shape[self._dim(dim)]

    def n_element(self) -> int:
        return self.data.numel()

    def _dim(self, d: int) -> int:
        if not 1 <= d <= max(1, self.data.dim()):
            raise IndexError(f"dimension {d} out of range for "
                             f"{self.data.dim()}-d tensor (1-based)")
        return d - 1

    @staticmethod
    def _index(i: int, size: int, what: str = "index") -> int:
        """A 1-based index checked: Torch raises on 0 or past the end."""
        if not 1 <= i <= size:
            raise IndexError(f"{what} {i} out of range [1, {size}] (1-based)")
        return i - 1

    def is_same_size_as(self, other: "Tensor") -> bool:
        return self.data.shape == other.data.shape

    def is_contiguous(self) -> bool:
        return self.data.is_contiguous()

    def contiguous(self) -> "Tensor":
        return self if self.data.is_contiguous() else \
            Tensor(self.data.contiguous())

    def _like(self, value) -> torch.Tensor:
        """``value`` (a Tensor, a torch tensor, numpy or a scalar) as a
        torch tensor on this tensor's device."""
        if isinstance(value, Tensor):
            value = value.data
        if isinstance(value, torch.Tensor):
            return value.to(self.data.device)
        return torch.as_tensor(np.asarray(value), device=self.data.device)

    def _assign(self, value: torch.Tensor) -> "Tensor":
        """Write a result into this tensor: in place when the shape and
        dtype agree (views see it), else the tensor is rebound."""
        if value.shape == self.data.shape and value.dtype == self.data.dtype:
            self.data.copy_(value)
        else:
            self.data = value
        return self

    # ------------------------------------------------------------- indexing
    def select(self, dim: int, index: int) -> "Tensor":
        """A view without ``dim``, at 1-based ``index``."""
        ax = self._dim(dim)
        return Tensor(self.data.select(
            ax, self._index(index, self.data.shape[ax])))

    def narrow(self, dim: int, index: int, size: int) -> "Tensor":
        """A view of [index, index + size) on ``dim`` (1-based)."""
        ax = self._dim(dim)
        start = self._index(index, self.data.shape[ax])
        if start + size > self.data.shape[ax]:
            raise IndexError(f"narrow({dim},{index},{size}) exceeds size "
                             f"{self.data.shape[ax]}")
        return Tensor(self.data.narrow(ax, start, size))

    def view(self, *sizes: int) -> "Tensor":
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        return Tensor(self.data.reshape(sizes))

    reshape = view

    def transpose(self, dim1: int, dim2: int) -> "Tensor":
        return Tensor(self.data.transpose(self._dim(dim1), self._dim(dim2)))

    def t(self) -> "Tensor":
        if self.data.dim() != 2:
            raise ValueError("t() expects a 2-d tensor")
        return Tensor(self.data.t())

    def squeeze(self, dim: Optional[int] = None) -> "Tensor":
        if dim is None:
            return Tensor(self.data.squeeze())
        return Tensor(self.data.squeeze(self._dim(dim)))

    def unsqueeze(self, dim: int) -> "Tensor":
        return Tensor(self.data.unsqueeze(dim - 1))

    def expand(self, *sizes: int) -> "Tensor":
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        return Tensor(self.data.expand(*sizes))

    def repeat_tensor(self, *sizes: int) -> "Tensor":
        return Tensor(torch.tile(self.data, sizes))

    def _checked_index(self, index, ax: int) -> torch.Tensor:
        """A 1-based index tensor checked and made 0-based (an index out of
        range raises rather than wrapping)."""
        idx = self._like(index).long()
        if idx.numel() and (int(idx.min()) < 1
                            or int(idx.max()) > self.data.shape[ax]):
            raise IndexError(f"index out of range [1, {self.data.shape[ax]}]"
                             " (1-based)")
        return idx - 1

    def index_select(self, dim: int, indices) -> "Tensor":
        ax = self._dim(dim)
        return Tensor(self.data.index_select(
            ax, self._checked_index(indices, ax).reshape(-1)))

    def masked_select(self, mask) -> "Tensor":
        return Tensor(self.data[self._like(mask).bool()])

    def __getitem__(self, idx):
        """1-based: ``t[i]`` of a 1-d tensor and ``t[i, j, ...]`` are
        Python numbers, ``t[i]`` of an n-d tensor the view ``select(1, i)``."""
        if isinstance(idx, int):
            if self.data.dim() == 1:
                return self.data[self._index(idx, self.data.shape[0])].item()
            return self.select(1, idx)
        if isinstance(idx, tuple) and all(isinstance(i, int) for i in idx):
            zero_based = tuple(self._index(i, s) for i, s in
                               zip(idx, self.data.shape))
            return self.data[zero_based].item()
        raise TypeError("Tensor indexing is 1-based ints (Torch apply "
                        "semantics); use .data for tensor slicing")

    def set_value(self, *args) -> "Tensor":
        *idx, value = args
        zero_based = tuple(self._index(i, s) for i, s in
                           zip(idx, self.data.shape))
        self.data[zero_based] = value
        return self

    # ------------------------------------------------------------- mutation
    def fill(self, value: Scalar) -> "Tensor":
        self.data.fill_(value)
        return self

    def zero(self) -> "Tensor":
        return self.fill(0)

    def copy(self, other) -> "Tensor":
        src = self._like(other)
        if src.numel() != self.data.numel():
            raise ValueError(f"copy size mismatch {src.numel()} vs "
                             f"{self.data.numel()}")
        self.data.copy_(src.reshape(self.data.shape))
        return self

    def resize(self, *sizes: int) -> "Tensor":
        """New shape over the first elements, zeros past the old ones."""
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        n_new = int(np.prod(sizes))
        flat = self.data.reshape(-1)
        if n_new <= flat.numel():
            flat = flat[:n_new]
        else:
            flat = torch.cat([flat, flat.new_zeros(n_new - flat.numel())])
        self.data = flat.reshape(sizes)
        return self

    def resize_as(self, other: "Tensor") -> "Tensor":
        return self.resize(*other.size())

    def apply1(self, fn: Callable[[float], float]) -> "Tensor":
        """A Python function of each element, in place (host round trip)."""
        host = self.data.detach().cpu().numpy()
        self.data.copy_(torch.from_numpy(
            np.asarray(np.vectorize(fn)(host), host.dtype)))
        return self

    # ----------------------------------------------------------------- math
    def _binary(self, other, fn) -> "Tensor":
        return self._assign(fn(self.data, self._like(other))
                            .to(self.data.dtype))

    def add(self, *args) -> "Tensor":
        """add(value) | add(tensor) | add(scalar, tensor), in place."""
        if len(args) == 1:
            return self._binary(args[0], torch.add)
        scalar, tensor = args
        return self._assign(self.data + scalar * self._like(tensor))

    def sub(self, *args) -> "Tensor":
        if len(args) == 1:
            return self._binary(args[0], torch.sub)
        scalar, tensor = args
        return self._assign(self.data - scalar * self._like(tensor))

    def mul(self, other) -> "Tensor":
        return self._binary(other, torch.mul)

    def div(self, other) -> "Tensor":
        return self._binary(other, torch.div)

    def cmul(self, other) -> "Tensor":
        return self._binary(other, torch.mul)

    def cdiv(self, other) -> "Tensor":
        return self._binary(other, torch.div)

    def cadd(self, scalar, other) -> "Tensor":
        return self.add(scalar, other)

    def pow(self, exponent: Scalar) -> "Tensor":
        return self._assign(torch.pow(self.data, exponent))

    def sqrt(self) -> "Tensor":
        return self._assign(torch.sqrt(self.data))

    def abs(self) -> "Tensor":
        return self._assign(torch.abs(self.data))

    def log(self) -> "Tensor":
        return self._assign(torch.log(self.data))

    def log1p(self) -> "Tensor":
        return self._assign(torch.log1p(self.data))

    def exp(self) -> "Tensor":
        return self._assign(torch.exp(self.data))

    # reductions and products (new tensors; the receiver of mm-style
    # products is written, as the reference's)
    def sum(self, dim: Optional[int] = None):
        if dim is None:
            return self.data.sum().item()
        return Tensor(self.data.sum(self._dim(dim), keepdim=True))

    def mean(self, dim: Optional[int] = None):
        if dim is None:
            return self.data.mean().item()
        return Tensor(self.data.mean(self._dim(dim), keepdim=True))

    def max(self, dim: Optional[int] = None):
        """max() -> a number; max(d) -> (values, 1-based int32 indices)."""
        if dim is None:
            return self.data.max().item()
        ax = self._dim(dim)
        values = self.data.amax(ax, keepdim=True)
        indices = self.data.argmax(ax, keepdim=True) + 1
        return Tensor(values), Tensor(indices.to(torch.int32))

    def min(self, dim: Optional[int] = None):
        if dim is None:
            return self.data.min().item()
        ax = self._dim(dim)
        values = self.data.amin(ax, keepdim=True)
        indices = self.data.argmin(ax, keepdim=True) + 1
        return Tensor(values), Tensor(indices.to(torch.int32))

    def norm(self, p: Scalar = 2) -> float:
        if p == 1:
            return self.data.abs().sum().item()
        return (self.data.abs() ** p).sum().pow(1.0 / p).item()

    def dot(self, other) -> float:
        return torch.dot(self.data.reshape(-1),
                         self._like(other).reshape(-1)).item()

    def mm(self, a, b) -> "Tensor":
        """self = a @ b."""
        return self._assign(torch.matmul(self._like(a), self._like(b)))

    def mv(self, a, x) -> "Tensor":
        return self._assign(torch.matmul(self._like(a), self._like(x)))

    def addmm(self, *args) -> "Tensor":
        """addmm([beta,] [M,] [alpha,] mat1, mat2) = beta M + alpha mat1
        mat2; the overloads are told apart by scalar or tensor type (a
        leading scalar is beta, a leading tensor M)."""
        beta, alpha, m = 1.0, 1.0, self
        rest = list(args)
        mat1, mat2 = rest[-2], rest[-1]
        head = rest[:-2]
        if head and _is_scalar(head[0]):
            beta = head.pop(0)
        if head and not _is_scalar(head[0]):
            m = head.pop(0)
        if head and _is_scalar(head[0]):
            alpha = head.pop(0)
        if head:
            raise TypeError(f"unsupported addmm argument shape {args!r}")
        return self._assign(beta * self._like(m) + alpha * torch.matmul(
            self._like(mat1), self._like(mat2)))

    def addmv(self, beta: Scalar, alpha: Scalar, mat, vec) -> "Tensor":
        return self._assign(beta * self.data + alpha * torch.matmul(
            self._like(mat), self._like(vec)))

    def addr(self, alpha: Scalar, vec1, vec2) -> "Tensor":
        return self._assign(self.data + alpha * torch.outer(
            self._like(vec1), self._like(vec2)))

    def bmm(self, a, b) -> "Tensor":
        """self = a @ b over a leading batch dimension."""
        return self._assign(torch.matmul(self._like(a), self._like(b)))

    def cinv(self) -> "Tensor":
        """Each element's reciprocal, in place."""
        return self._assign((1.0 / self.data).to(self.data.dtype))

    def stride(self, dim: Optional[int] = None):
        """Element strides (Torch's: a view's are its source's)."""
        if dim is None:
            return tuple(self.data.stride())
        return self.data.stride(self._dim(dim))

    def _draw(self, draws) -> "Tensor":
        self.data.copy_(torch.from_numpy(np.asarray(draws)))
        return self

    def uniform(self, a: float = 0.0, b: float = 1.0) -> "Tensor":
        """U[a, b) draws from the framework's generator, in place."""
        from bigdl_tpu_torch.utils.rng import RandomGenerator
        return self._draw(RandomGenerator.RNG().uniform(
            a, b, size=tuple(self.data.shape)))

    def sort(self, dim: Optional[int] = None, descending: bool = False):
        """(sorted values, 1-based int32 indices) along ``dim`` (default:
        the last); descending is the ascending order reversed, ties too."""
        ax = self._dim(dim) if dim is not None else self.data.dim() - 1
        idx = torch.argsort(self.data, dim=ax, stable=True)
        if descending:
            idx = torch.flip(idx, (ax,))
        values = torch.take_along_dim(self.data, idx, dim=ax)
        return Tensor(values), Tensor((idx + 1).to(torch.int32))

    def topk(self, k: int, dim: Optional[int] = None,
             increase: bool = True):
        """The k smallest (``increase``, the reference's default) or
        largest values and their 1-based indices along ``dim``."""
        ax = self._dim(dim) if dim is not None else self.data.dim() - 1
        if not 1 <= k <= self.data.shape[ax]:
            raise IndexError(f"k={k} out of range [1, {self.data.shape[ax]}]")
        values, idx = self.sort(dim=ax + 1, descending=not increase)
        return (Tensor(values.data.narrow(ax, 0, k)),
                Tensor(idx.data.narrow(ax, 0, k)))

    def kthvalue(self, k: int, dim: Optional[int] = None):
        """The k-th smallest value and its 1-based index along ``dim``."""
        values, idx = self.topk(k, dim=dim, increase=True)
        ax = self._dim(dim) if dim is not None else self.data.dim() - 1
        return (Tensor(values.data.narrow(ax, k - 1, 1)),
                Tensor(idx.data.narrow(ax, k - 1, 1)))

    def gather(self, dim: int, index) -> "Tensor":
        """Gather along ``dim`` at 1-based ``index``."""
        ax = self._dim(dim)
        return Tensor(torch.gather(self.data, ax,
                                   self._checked_index(index, ax)))

    def scatter(self, dim: int, index, src) -> "Tensor":
        """Scatter ``src`` along ``dim`` at 1-based ``index``, in place."""
        ax = self._dim(dim)
        self.data.scatter_(ax, self._checked_index(index, ax),
                           self._like(src).to(self.data.dtype))
        return self

    def split(self, size: int, dim: int = 1):
        """Views of width ``size`` along 1-based ``dim`` (the last may be
        narrower)."""
        return [Tensor(p) for p in torch.split(self.data, size,
                                               dim=self._dim(dim))]

    def chunk(self, n: int, dim: int = 1):
        """``n`` near-equal views (widths rounded up)."""
        ax = self._dim(dim)
        return self.split(-(-self.data.shape[ax] // n), dim)

    def _conv2_like(self, kernel, conv_type: str, flip: bool) -> "Tensor":
        k = self._like(kernel)
        if self.data.dim() != 2 or k.dim() != 2:
            raise ValueError("conv2/xcorr2 expect 2-d tensors")
        if flip:   # a convolution is a correlation with the flipped kernel
            k = torch.flip(k, (0, 1))
        if conv_type not in ("V", "F"):
            raise ValueError("conv type must be 'V' (valid) or 'F' (full)")
        pad = 0 if conv_type == "V" else (k.shape[0] - 1, k.shape[1] - 1)
        out = F.conv2d(self.data[None, None].float(), k[None, None].float(),
                       padding=pad)
        return Tensor(out[0, 0].to(self.data.dtype))

    def conv2(self, kernel, conv_type: str = "V") -> "Tensor":
        """2-D convolution, 'V'alid or 'F'ull (reference ``conv2``)."""
        return self._conv2_like(kernel, conv_type, flip=True)

    def xcorr2(self, kernel, conv_type: str = "V") -> "Tensor":
        """2-D cross-correlation (reference ``xcorr2``)."""
        return self._conv2_like(kernel, conv_type, flip=False)

    # ------------------------------------------------------------ operators
    def __add__(self, other):
        return Tensor(self.data + self._like(other))

    __radd__ = __add__

    def __sub__(self, other):
        return Tensor(self.data - self._like(other))

    def __rsub__(self, other):
        return Tensor(self._like(other) - self.data)

    def __mul__(self, other):
        return Tensor(self.data * self._like(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return Tensor(self.data / self._like(other))

    def __neg__(self):
        return Tensor(-self.data)

    def __eq__(self, other):
        if isinstance(other, Tensor):
            return (self.data.shape == other.data.shape
                    and bool((self.data == self._like(other)).all()))
        return NotImplemented

    def __hash__(self):
        return id(self)

    def almost_equal(self, other, tol: float = 1e-6) -> bool:
        o = self._like(other)
        return (self.data.shape == o.shape
                and bool(((self.data - o).abs() <= tol).all()))

    # ---------------------------------------------------------------- misc
    def clone(self) -> "Tensor":
        return Tensor(self.data.clone())

    def storage(self) -> Storage:
        """The underlying storage (a view's is its source's), 1-based;
        writes reach the tensor."""
        n = self.data.untyped_storage().nbytes() // self.data.element_size()
        flat = self.data.new_empty(0).set_(self.data.untyped_storage(), 0,
                                           (n,))
        return Storage(flat)

    def set_storage(self, storage: Storage) -> "Tensor":
        """This tensor's elements from ``storage``'s first ones."""
        src = storage.tensor() if isinstance(storage, Storage) else \
            torch.as_tensor(np.asarray(storage))
        self.data.copy_(src.reshape(-1)[:self.data.numel()]
                        .reshape(self.data.shape))
        return self

    def to_torch(self) -> torch.Tensor:
        return self.data

    def numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()

    def rand(self) -> "Tensor":
        from bigdl_tpu_torch.utils.rng import RandomGenerator
        return self._draw(RandomGenerator.RNG().uniform(
            0, 1, tuple(self.data.shape)))

    def randn(self) -> "Tensor":
        from bigdl_tpu_torch.utils.rng import RandomGenerator
        return self._draw(RandomGenerator.RNG().normal(
            0, 1, tuple(self.data.shape)))

    def bernoulli(self, p: float) -> "Tensor":
        from bigdl_tpu_torch.utils.rng import RandomGenerator
        return self._draw(RandomGenerator.RNG().bernoulli(
            p, tuple(self.data.shape)))

    def __repr__(self) -> str:
        return (f"Tensor(size={tuple(self.data.shape)}, "
                f"dtype={self.data.dtype}, device={self.data.device})\n"
                f"{self.numpy()}")

    # ---------------------------------------------------------- conversions
    @staticmethod
    def from_numpy(arr: np.ndarray, device: DeviceLike = "cuda") -> "Tensor":
        return Tensor(np.asarray(arr), device=device)

    @staticmethod
    def range(start: Scalar, stop: Scalar, step: Scalar = 1,
              device: DeviceLike = "cuda") -> "Tensor":
        """Inclusive of ``stop``, like Torch's ``Tensor.range`` (f32)."""
        return Tensor(np.arange(start, stop + step * 0.5, step,
                                dtype=np.float32), device=device)

    @staticmethod
    def ones(*sizes: int, device: DeviceLike = "cuda") -> "Tensor":
        return Tensor(torch.ones(sizes, device=resolve_device(device)))

    @staticmethod
    def zeros(*sizes: int, device: DeviceLike = "cuda") -> "Tensor":
        return Tensor(torch.zeros(sizes, device=resolve_device(device)))


def _torch_dtype(dtype) -> torch.dtype:
    """A numpy or torch dtype as torch's."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((0,), dtype)).dtype
