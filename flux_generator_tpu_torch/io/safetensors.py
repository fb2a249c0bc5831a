"""A reader and a writer of the safetensors format, on the standard library
and torch (they stand in for the `safetensors` package).

A file is an 8-byte little-endian header length N, N bytes of JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}, then the raw little-endian bytes, offsets counted from the end of
the header. The file is memory-mapped copy-on-write, so a tensor's pages are
read when it is first touched. Every dtype lands as the torch dtype of the
same bytes; BF16 goes straight to torch.bfloat16 (numpy has no bf16).

The writer takes tensors or `Lazy` descriptions of them (shape, dtype and a
function that makes the tensor): it works out the whole header first, then
makes each tensor, writes its bytes and lets it go, so a file of many GB
never lies whole in host memory. Tensors are laid out widest dtype first,
then by name, so every offset is aligned to its element size.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Callable, NamedTuple

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}

NAMES = {dtype: name for name, dtype in DTYPES.items()}


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def read_header(path) -> tuple:
    """(header dict without "__metadata__", data start offset in bytes,
    the "__metadata__" dict or {})."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than its 8-byte header length)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    metadata = header.pop("__metadata__", None) or {}
    return header, 8 + n, metadata


def load_safetensors(path) -> dict:
    """{name: CPU tensor} of one file. Raises ValueError naming the file and
    the tensor when a tensor's bytes do not match its shape and dtype or lie
    past the end of the file (a truncated file)."""
    path = Path(path)
    header, start, _ = read_header(path)
    size = path.stat().st_size
    out = {}
    if not header:
        return out
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
        begin, end = info["data_offsets"]
        numel, itemsize = _numel(shape), _itemsize(dtype)
        if end - begin != numel * itemsize:
            raise ValueError(f"{path}: tensor {name!r} holds {end - begin} bytes, but shape {list(shape)} "
                             f"of {info['dtype']} needs {numel * itemsize}")
        if start + end > size:
            raise ValueError(f"{path}: tensor {name!r} ends at byte {start + end}, past the end of the file "
                             f"({size} bytes): the file is truncated")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin, offset=start + begin)
        if (start + begin) % itemsize:
            raw = raw.clone()  # a view of a wider dtype needs an aligned offset
        out[name] = raw.view(dtype).reshape(shape)
    return out


def load_sharded_safetensors(directory, index_file) -> dict:
    """A checkpoint in several files, through its *.index.json weight map."""
    directory = Path(directory)
    with open(directory / index_file) as f:
        index = json.load(f)
    out = {}
    for shard in sorted(set(index["weight_map"].values())):
        out.update(load_safetensors(directory / shard))
    return out


# ------------------------------------------------------------ writer


class Lazy(NamedTuple):
    """A tensor to be written, described before it is made."""

    shape: tuple
    dtype: torch.dtype
    make: Callable[[], torch.Tensor]


def _lazy(value) -> Lazy:
    if isinstance(value, Lazy):
        return value
    return Lazy(tuple(value.shape), value.dtype, lambda: value)


def nbytes(value) -> int:
    """Bytes of a tensor or a Lazy in the file."""
    lz = _lazy(value)
    return _numel(lz.shape) * _itemsize(lz.dtype)


def save_safetensors(path, tensors: dict, metadata: dict = None) -> int:
    """Write {name: tensor or Lazy} to `path` (its parent made as needed),
    with optional string `metadata`; returns the bytes of tensor data. A
    made tensor whose shape or dtype differs from its description raises."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    entries = {k: _lazy(v) for k, v in tensors.items()}
    order = sorted(entries, key=lambda k: (-_itemsize(entries[k].dtype), k))
    header, offset = {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name in order:
        lz = entries[name]
        if lz.dtype not in NAMES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {lz.dtype}")
        size = nbytes(lz)
        header[name] = {"dtype": NAMES[lz.dtype], "shape": list(lz.shape), "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            lz = entries[name]
            t = lz.make()
            if tuple(t.shape) != tuple(lz.shape) or t.dtype != lz.dtype:
                raise ValueError(f"{path}: tensor {name!r} was described as {list(lz.shape)} {lz.dtype}, "
                                 f"made as {list(t.shape)} {t.dtype}")
            if t.numel():
                f.write(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy())
            del t
    return offset


def save_sharded_safetensors(directory, tensors: dict, n_shards: int = 2, prefix: str = "model") -> int:
    """A checkpoint in `n_shards` files, `{prefix}-0000i-of-0000n.safetensors`
    (sorted names dealt out in turn), with `{prefix}.safetensors.index.json`
    {"metadata": {"total_size"}, "weight_map": {name: file}}, the layout
    T5-XXL ships in. Returns the bytes of tensor data."""
    directory = Path(directory)
    keys = sorted(tensors)
    weight_map, total = {}, 0
    for i in range(n_shards):
        fname = f"{prefix}-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        shard = keys[i::n_shards]
        total += save_safetensors(directory / fname, {k: tensors[k] for k in shard})
        weight_map.update((k, fname) for k in shard)
    with open(directory / f"{prefix}.safetensors.index.json", "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return total
