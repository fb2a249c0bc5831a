"""A reader of the safetensors format, on the standard library and torch
(it stands in for the `safetensors` package).

A file is an 8-byte little-endian header length N, N bytes of JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}, then the raw little-endian bytes, offsets counted from the end of
the header. The file is memory-mapped copy-on-write, so a tensor's pages are
read when it is first touched. Every dtype lands as the torch dtype of the
same bytes; BF16 goes straight to torch.bfloat16 (numpy has no bf16).
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}


def read_header(path) -> tuple:
    """(header dict without "__metadata__", data start offset in bytes)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than its 8-byte header length)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_safetensors(path) -> dict:
    """{name: CPU tensor} of one file. Raises ValueError naming the file and
    the tensor when a tensor's bytes do not match its shape and dtype or lie
    past the end of the file (a truncated file)."""
    path = Path(path)
    header, start = read_header(path)
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
        numel = 1
        for d in shape:
            numel *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
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
