"""The port's native tokenizer engines (tokenizers/native.py, built from
flux_generator_tpu_torch/csrc/{clip_bpe,spm_unigram}.cpp): ids equal to the
port's Python engines and to the JAX package's tokenizers on
tests/assets, the per-word (CLIP) and per-text (SentencePiece) overflow
fallbacks, a first build raced by two processes, and a subprocess that
imports every module new with the parallel slice and builds the engines
without loading jax or flux_generator_tpu."""

import json
import pathlib
import subprocess
import sys

import pytest

from flux_generator_tpu_torch.tokenizers import native
from flux_generator_tpu_torch.tokenizers.clip_bpe import CLIPTokenizer
from flux_generator_tpu_torch.tokenizers.sentencepiece_unigram import SentencePieceUnigramTokenizer

REPO = pathlib.Path(__file__).resolve().parents[1]
ASSETS = REPO / "tests" / "assets"
GOLDENS = json.loads((ASSETS / "tokenizer_goldens.json").read_text())
PROMPTS = ["a photograph of a red fox in fresh snow", "an oil painting of a lighthouse at dusk",
           "Héllo, wörld! it's 2048² — λ café", "   spaces\tand\nnewlines  "]


def _clip(engine, max_length=77):
    return CLIPTokenizer.from_files(ASSETS / "clip_tokenizer" / "vocab.json", ASSETS / "clip_tokenizer" / "merges.txt",
                                    max_length=max_length, engine=engine)


def _spm(engine, name="t5_like.model"):
    return SentencePieceUnigramTokenizer.from_file(ASSETS / "spiece" / name, max_length=32, engine=engine)


def test_clip_native_equals_python_and_jax():
    from flux_generator_tpu.tokenizers.clip_bpe import CLIPTokenizer as JaxCLIP

    jax_tok = JaxCLIP.from_files(ASSETS / "clip_tokenizer" / "vocab.json", ASSETS / "clip_tokenizer" / "merges.txt")
    tok, py = _clip("native"), _clip("python")
    assert tok._native is not None and py._native is None
    for text in [*GOLDENS["clip"], *PROMPTS]:
        assert tok.encode(text) == py.encode(text) == jax_tok.encode(text), repr(text)
    for text, want in GOLDENS["clip"].items():
        assert tok.tokenize(text) == want


@pytest.mark.parametrize("model", ["t5_like.model", "byte_fallback.model"])
def test_spm_native_equals_python_and_jax(model):
    from flux_generator_tpu.tokenizers.sentencepiece_unigram import SentencePieceUnigramTokenizer as JaxSpm

    jax_tok = JaxSpm.from_file(ASSETS / "spiece" / model, max_length=32)
    tok, py = _spm("native", model), _spm("python", model)
    goldens = GOLDENS["spiece" if model == "t5_like.model" else "spiece_byte_fallback"]
    for text in [*goldens, *PROMPTS]:
        assert tok.encode(text) == py.encode(text) == jax_tok.encode(text), repr(text)
    for text, want in goldens.items():
        assert tok.tokenize(text, pad=False) == want


def test_clip_word_overflow_takes_the_python_loop():
    """A word of more than BPE_MAX_IDS pieces overflows the native buffer;
    that word alone runs the Python merge loop (the JAX package's n < 0
    fallback)."""
    tok, py = _clip("native", max_length=4096), _clip("python", max_length=4096)
    word = "".join(chr(0x4E00 + i) for i in range(400))  # 1200 bytes, no merges among them
    encoded = "".join(tok.byte_encoder[b] for b in word.encode())
    assert tok._native.encode_word(encoded) is None
    text = f"a {word} fox"
    assert len(tok.tokenize(text)) > native.BPE_MAX_IDS
    assert tok.tokenize(text) == py.tokenize(text)


def test_spm_text_overflow_takes_the_python_viterbi():
    tok, py = _spm("native"), _spm("python")
    text = "qz" * 3000
    with pytest.raises(ValueError, match="overflow"):
        tok._native.segment(tok._normalize(text))
    got = tok.tokenize(text, pad=False)
    assert len(got) > native.SPM_MAX_IDS and got == py.tokenize(text, pad=False)


def test_engine_is_an_argument():
    with pytest.raises(ValueError, match="engine"):
        _clip("rust")
    with pytest.raises(ValueError, match="engine"):
        _spm("c")


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.library_path(tmp_path)


_BUILD = """
import sys, time
from flux_generator_tpu_torch.tokenizers import native
start = float(sys.argv[2])
while time.time() < start:
    time.sleep(0.005)
path = native.library_path(sys.argv[1])
import ctypes
lib = ctypes.CDLL(str(path))
print(path, lib.fgt_bpe_create is not None)
"""


def test_two_processes_race_the_first_build(tmp_path):
    """Both wait for one build under the lock and load the same library; no
    temporary file is left behind."""
    import time

    start = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path), str(start)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    lines = [out.strip() for out, _ in outs]
    assert lines[0] == lines[1] and lines[0].endswith("True")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [pathlib.Path(lines[0].split()[0]).name, "libfgt_tokenizer.lock"])


_NO_JAX = """
import sys
import flux_generator_tpu_torch.parallel.distributed
import flux_generator_tpu_torch.parallel.mesh
import flux_generator_tpu_torch.parallel.sharding
import flux_generator_tpu_torch.parallel.pipeline
import flux_generator_tpu_torch.parallel.ring_attention
import flux_generator_tpu_torch.training.dreambooth
import flux_generator_tpu_torch.server.app
from flux_generator_tpu_torch.io.tokenizers import load_clip_tokenizer, load_t5_tokenizer
clip = load_clip_tokenizer("tests/assets/clip_tokenizer/vocab.json", "tests/assets/clip_tokenizer/merges.txt")
t5 = load_t5_tokenizer("tests/assets/spiece/t5_like.model")
assert clip._native is not None and t5._native is not None
clip.encode("a fox"); t5.encode("a fox")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "flux_generator_tpu.")) or m == "flux_generator_tpu")
print("LOADED", bad)
"""


def test_new_modules_and_native_engines_load_no_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
