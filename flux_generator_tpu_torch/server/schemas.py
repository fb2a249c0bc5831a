"""API request / response schemas (the port's copy of
flux_generator_tpu/server/schemas.py) as dataclasses, since the card's
installation has no pydantic.

Fields and defaults are the JAX package's. Construction validates as
pydantic's lax mode does for these field types: a missing required field or
a value that cannot be taken as its type raises ValueError (HTTP 422 in
server/httpd.py); ints take bools, integral floats and integer strings,
floats take bools, ints and numeric strings, strings take only strings; an
unknown field is ignored, as pydantic's default ignores it. `model_dump()`
(with `exclude=`) gives the fields as a dict.
"""

from __future__ import annotations

import dataclasses
import math
import typing
from typing import List, Optional

_MISSING = dataclasses.MISSING


def _as_int(name, v):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float) and math.isfinite(v) and v == int(v):
        return int(v)
    if isinstance(v, str):
        try:
            return int(v.strip())
        except ValueError:
            pass
    raise ValueError(f"{name}: input should be a valid integer, got {v!r}")


def _as_float(name, v):
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            pass
    raise ValueError(f"{name}: input should be a valid number, got {v!r}")


def _as_str(name, v):
    if isinstance(v, str):
        return v
    raise ValueError(f"{name}: input should be a valid string, got {v!r}")


def _check(name, tp, v):
    if typing.get_origin(tp) is typing.Union:  # Optional[X]
        if v is None:
            return None
        tp = next(a for a in typing.get_args(tp) if a is not type(None))
    if tp is int:
        return _as_int(name, v)
    if tp is float:
        return _as_float(name, v)
    if tp is str:
        return _as_str(name, v)
    if tp is dict:
        if isinstance(v, dict):
            return v
        raise ValueError(f"{name}: input should be a valid dictionary, got {v!r}")
    if typing.get_origin(tp) is list:
        if not isinstance(v, (list, tuple)):
            raise ValueError(f"{name}: input should be a valid list, got {v!r}")
        (item,) = typing.get_args(tp)
        return [_check(f"{name}.{i}", item, x) for i, x in enumerate(v)]
    raise TypeError(f"{name}: unsupported field type {tp}")


class _Schema:
    """Validating constructor and model_dump for the dataclasses below."""

    def __init__(self, **data):
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            if f.name in data:
                value = _check(f.name, hints[f.name], data[f.name])
            elif f.default is not _MISSING:
                value = f.default
            elif f.default_factory is not _MISSING:
                value = f.default_factory()
            else:
                raise ValueError(f"{f.name}: field required")
            setattr(self, f.name, value)

    def model_dump(self, exclude=None) -> dict:
        exclude = set(exclude or ())
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self) if f.name not in exclude}

    def __eq__(self, other):
        return type(self) is type(other) and self.model_dump() == other.model_dump()

    def __repr__(self):
        return f"{type(self).__name__}({', '.join(f'{k}={v!r}' for k, v in self.model_dump().items())})"


def _schema(cls):
    return dataclasses.dataclass(init=False, eq=False, repr=False)(cls)


@_schema
class SDAPIRequest(_Schema):
    prompt: str
    negative_prompt: Optional[str] = None
    width: int = 512
    height: int = 512
    steps: Optional[int] = None
    cfg_scale: float = 4.0
    batch_size: int = 1
    n_iter: int = 1
    seed: int = -1
    # "schnell", "dev", "flux-schnell", "flux-dev",
    # "stabilityai/stable-diffusion-2-1-base", "stabilityai/sdxl-turbo"
    model: str = "schnell"


@_schema
class SDAPIResponse(_Schema):
    images: List[str]
    parameters: dict
    info: str


@_schema
class Img2ImgRequest(_Schema):
    prompt: str
    init_images: List[str]  # base64 or data-URL PNGs
    negative_prompt: Optional[str] = None
    denoising_strength: float = 0.75
    width: int = 512
    height: int = 512
    steps: Optional[int] = None
    cfg_scale: float = 7.5
    batch_size: int = 1
    seed: int = -1
    model: str = "stabilityai/stable-diffusion-2-1-base"


@_schema
class MusicRequest(_Schema):
    prompt: str
    max_steps: int = 500
    top_k: int = 250
    temperature: float = 1.0
    guidance: float = 3.0
    seed: int = -1
    # the samples share one batched AR loop
    n_samples: int = 1
