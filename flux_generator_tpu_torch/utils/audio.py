"""Audio output (counterpart of flux_generator_tpu/utils/audio.py), through
the standard library's `wave` module."""

from __future__ import annotations

import os
import wave

import numpy as np


def save_audio(file, audio, sampling_rate: int):
    """Clip to [-1, 1], convert to int16 (× 32767, truncated as the JAX
    package's astype) and write a WAV to `file`, a path or a binary file
    object. audio: (T,), (T, 1) or (T, C)."""
    if hasattr(audio, "detach"):  # a torch tensor
        audio = audio.detach().float().cpu().numpy()
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim > 1 and audio.shape[-1] == 1:
        audio = audio[..., 0]
    pcm = (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(os.fspath(file) if isinstance(file, (str, os.PathLike)) else file, "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[-1])
        w.setsampwidth(2)
        w.setframerate(int(sampling_rate))
        w.writeframes(pcm.astype("<i2").tobytes())
