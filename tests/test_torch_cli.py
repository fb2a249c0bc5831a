"""The port's command-line entry points (flux_generator_tpu_torch/cli/*): each
parser gives the JAX CLI's namespace on the same argv (the JAX parsers are
built inside `main`, so their namespace is caught at parse_args), each
`--help` exits 0, each `run` on a tiny CPU pipeline loaded from a
port-written tiny cache writes the file that the pipeline's direct call
makes, byte for byte, and importing the CLI modules loads no jax."""

import argparse
import subprocess
import sys

import numpy as np
import pytest
import torch

from flux_generator_tpu.cli import image2image as jimage2image
from flux_generator_tpu.cli import musicgen_generate as jmusicgen
from flux_generator_tpu.cli import sd_txt2image as jsd
from flux_generator_tpu.cli import t5_generate as jt5
from flux_generator_tpu.cli import txt2image as jtxt2image
from flux_generator_tpu_torch.cli import image2image, musicgen_generate, sd_txt2image, t5_generate, txt2image
from flux_generator_tpu_torch.io import synthetic
from flux_generator_tpu_torch.models.t5.t5 import tiny_t5_config
from flux_generator_tpu_torch.pipelines.flux import FluxPipeline
from flux_generator_tpu_torch.pipelines.musicgen import MusicGenPipeline
from flux_generator_tpu_torch.pipelines.sd import StableDiffusion, StableDiffusionXL
from flux_generator_tpu_torch.utils.audio import save_audio
from flux_generator_tpu_torch.utils.images import save_image_grid
from tests.test_torch_bridge import _LOADED, REPO

CLIS = {
    "txt2image": (txt2image, jtxt2image, [
        ["a cat"],
        ["a cat", "--model", "dev", "--n-images", "2", "--image-size", "768x512", "--steps", "3",
         "--guidance", "3.5", "--n-rows", "2", "--decoding-batch-size", "2", "-q", "--no-t5-padding",
         "--seed", "7", "--adapter", "a.safetensors", "--fuse-adapter", "--output", "x.png", "--save-raw", "-v"],
    ]),
    "sd_txt2image": (sd_txt2image, jsd, [
        ["a cat"],
        ["a cat", "--model", "sd", "--n_images", "1", "--steps", "5", "--cfg", "2.0", "--negative_prompt", "blurry",
         "--n_rows", "1", "--decoding_batch_size", "2", "--quantize", "--preload-models", "--output", "o.png",
         "--seed", "3", "-v"],
    ]),
    "image2image": (image2image, jimage2image, [
        ["in.png", "a cat"],
        ["in.png", "a cat", "--model", "sd", "--strength", "0.5", "--n_images", "2", "--steps", "4", "--cfg", "1.5",
         "--negative_prompt", "x", "--n_rows", "2", "--output", "o.png", "--seed", "1", "--verbose"],
    ]),
    "musicgen_generate": (musicgen_generate, jmusicgen, [
        [],
        ["--model", "facebook/musicgen-small", "--text", "jazz", "--output-path", "a.wav", "--max-steps", "10",
         "--top-k", "5", "--temp", "0.7", "--guidance", "2.0", "--seed", "4"],
    ]),
    "t5_generate": (t5_generate, jt5, [
        ["--prompt", "translate this"],
        ["--model", "t5-small", "--prompt", "x", "--max-tokens", "9"],
    ]),
}


class _Parsed(Exception):
    pass


def _jax_namespace(module, argv, monkeypatch):
    """The namespace the JAX CLI's parser makes of argv; main stops there."""
    parse = argparse.ArgumentParser.parse_args
    caught = {}

    def catch(self, args=None, namespace=None):
        caught["ns"] = parse(self, args, namespace)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed):
            module.main(argv)
    return caught["ns"]


@pytest.mark.parametrize("name", list(CLIS))
def test_parser_matches_the_jax_cli(name, monkeypatch):
    port, jax_cli, argvs = CLIS[name]
    for argv in argvs:
        assert vars(port.build_parser().parse_args(argv)) == vars(_jax_namespace(jax_cli, argv, monkeypatch)), argv
    # an unknown flag is an error in both, and a model outside the choices
    for parse in (lambda: port.build_parser().parse_args(argvs[0] + ["--bogus-flag"]),
                  lambda: jax_cli.main(argvs[0] + ["--bogus-flag"])):
        with pytest.raises(SystemExit) as e:
            parse()
        assert e.value.code == 2
    if name not in ("t5_generate", "musicgen_generate"):  # these take any repo id
        with pytest.raises(SystemExit):
            port.build_parser().parse_args(argvs[0] + ["--model", "bogus"])


@pytest.mark.parametrize("name", list(CLIS))
def test_help_exits_0(name, capsys):
    with pytest.raises(SystemExit) as e:
        CLIS[name][0].main(["--help"])
    assert e.value.code == 0
    assert "usage" in capsys.readouterr().out


def test_cli_modules_import_no_jax():
    code = ("import sys\n"
            + "".join(f"import flux_generator_tpu_torch.cli.{n}\n" for n in CLIS)
            + f"print({_LOADED})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# ------------------------------------------------------------ run on tiny pipelines


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_caches")
    flux_configs = synthetic.make_flux_cache(root / "flux", device="cpu")
    synthetic.make_sd_cache(root / "sd", device="cpu")
    synthetic.make_sd_cache(root / "sdxl", xl=True, device="cpu")
    synthetic.make_musicgen_cache(root / "musicgen", device="cpu")
    synthetic.make_t5_cache(root / "t5", tiny_t5_config(vocab_size=324, num_decoder_layers=2), device="cpu")
    return root, flux_configs


def _same_file(a, b):
    assert a.read_bytes() == b.read_bytes()


def test_txt2image_run_writes_the_direct_call(caches, tmp_path):
    root, configs = caches
    pipe = FluxPipeline.from_pretrained(local_dir=root / "flux", configs=configs, dtype=torch.float32, device="cpu")
    out = tmp_path / "cli.png"
    args = txt2image.build_parser().parse_args(["a photo of a cat", "--n-images", "2", "--image-size", "64x48",
                                                "--seed", "7", "--output", str(out)])
    txt2image.run(pipe, args)
    direct = [pipe.generate_images("a photo of a cat", n_images=1, num_steps=2, guidance=4.0, latent_size=(6, 8),
                                   seed=7 + i, as_uint8=True).numpy() for i in range(2)]
    save_image_grid(tmp_path / "direct.png", np.concatenate(direct), rows=1)
    _same_file(out, tmp_path / "direct.png")
    args = txt2image.build_parser().parse_args(["a photo of a cat", "--n-images", "2", "--image-size", "64x48",
                                                "--seed", "7", "--output", str(out), "--save-raw",
                                                "--decoding-batch-size", "2"])
    txt2image.run(pipe, args)
    from PIL import Image

    both = pipe.generate_images("a photo of a cat", n_images=2, num_steps=2, latent_size=(6, 8), seed=7,
                                as_uint8=True).numpy()
    for i in range(2):
        assert np.array_equal(np.asarray(Image.open(tmp_path / f"cli_{i}.png")), both[i])


def test_sd_txt2image_and_image2image_runs_write_the_direct_calls(caches, tmp_path):
    root, _ = caches
    sd = StableDiffusion.from_pretrained(local_dir=root / "sd", dtype=torch.float32, device="cpu")
    out = tmp_path / "sd.png"
    args = sd_txt2image.build_parser().parse_args(["a cat", "--model", "sd", "--n_images", "1", "--steps", "3",
                                                   "--seed", "5", "--output", str(out)])
    sd_txt2image.run(sd, args)
    x = None
    for x in sd.generate_latents("a cat", n_images=1, num_steps=3, cfg_weight=7.5, negative_text="", seed=5):
        pass
    save_image_grid(tmp_path / "direct.png", sd.decode_u8(x).numpy(), rows=1)
    _same_file(out, tmp_path / "direct.png")

    xl = StableDiffusionXL.from_pretrained(local_dir=root / "sdxl", dtype=torch.float32, device="cpu")
    out2 = tmp_path / "xl.png"
    sd_txt2image.run(xl, sd_txt2image.build_parser().parse_args(
        ["a cat", "--n_images", "2", "--decoding_batch_size", "2", "--seed", "5", "--output", str(out2)]))
    for x in xl.generate_latents("a cat", n_images=2, num_steps=2, cfg_weight=0.0, negative_text="", seed=5):
        pass
    save_image_grid(tmp_path / "direct2.png", xl.decode_u8(x).numpy(), rows=1)
    _same_file(out2, tmp_path / "direct2.png")

    out3 = tmp_path / "i2i.png"
    image2image.run(xl, image2image.build_parser().parse_args(
        [str(out), "a dog", "--n_images", "1", "--seed", "9", "--output", str(out3)]))
    img = image2image.read_image(out)
    assert img.shape == (128, 128, 3) and img.dtype == torch.float32
    for x in xl.generate_latents_from_image(img, "a dog", n_images=1, strength=0.9, num_steps=2, cfg_weight=0.0,
                                            negative_text="", seed=9):
        pass
    save_image_grid(tmp_path / "direct3.png", xl.decode_u8(x).numpy(), rows=1)
    _same_file(out3, tmp_path / "direct3.png")


def test_musicgen_run_writes_the_direct_call(caches, tmp_path):
    root, _ = caches
    pipe = MusicGenPipeline.from_pretrained(local_dir=root / "musicgen", dtype=torch.float32, device="cpu")
    out = tmp_path / "cli.wav"
    musicgen_generate.run(pipe, musicgen_generate.build_parser().parse_args(
        ["--max-steps", "6", "--top-k", "4", "--seed", "2", "--output-path", str(out)]))
    audio = pipe.generate("happy rock", max_steps=6, top_k=4, temp=1.0, guidance_coef=3.0, seed=2)
    save_audio(tmp_path / "direct.wav", audio, pipe.sampling_rate)
    _same_file(out, tmp_path / "direct.wav")


def test_t5_generate_run_prints_the_greedy_text(caches, capsys):
    root, _ = caches
    model = t5_generate.load("t5-tiny", device="cpu", local_dir=root / "t5")
    args = t5_generate.build_parser().parse_args(["--prompt", "a photo of a cat", "--max-tokens", "5"])
    text = t5_generate.run(model, args)
    assert capsys.readouterr().out == text + "\n"
    assert text == t5_generate.generate_greedy(model.params, model.cfg, model.tokenizer, "a photo of a cat", 5)


# ------------------------------------------------------------ what the CLIs call


def _dense_tree(rng):
    def dense(d_in, d_out):
        return {"kernel": rng.randn(d_in, d_out).astype(np.float32), "bias": rng.randn(d_out).astype(np.float32)}

    return {
        "unet": {"ff": dense(512, 8), "small": dense(64, 8), "stack": {"kernel": rng.randn(2, 1024, 8).astype(np.float32)},
                 "conv": {"kernel": rng.randn(3, 3, 512, 8).astype(np.float32)}},
        "clip": {"fc2": dense(1024, 16), "q": dense(48, 48)},
        "clip_2": {"fc2": dense(512, 4)},
        "vae": {"conv": {"kernel": rng.randn(3, 3, 512, 4).astype(np.float32)}},
    }


@pytest.mark.parametrize("bits,te_bits", [(8, None), (8, 4)])
def test_quantize_pipeline_matches_jax_and_keeps_convs(bits, te_bits):
    """Every dense the JAX package quantizes, the port quantizes to the same
    values (the int8 ones stored K-contiguous); a 4-D conv kernel stays as
    it is in the port, where JAX quantizes it too (and its conv then finds
    no kernel)."""
    import types

    import jax
    import jax.numpy as jnp

    from flux_generator_tpu.ops.quant import quantize_pipeline as jquantize_pipeline
    from flux_generator_tpu_torch.io.params import to_numpy, to_torch
    from flux_generator_tpu_torch.ops.quant import is_k_major, quantize_pipeline
    from tests.test_torch_bridge import jax_to_torch
    from tests.test_torch_loaders import assert_trees_equal

    tree = _dense_tree(np.random.RandomState(0))
    jp = types.SimpleNamespace(params=jax.tree.map(jnp.asarray, tree))
    tp = types.SimpleNamespace(params=to_torch(tree))
    jquantize_pipeline(jp, bits=bits, text_encoder_bits=te_bits)
    quantize_pipeline(tp, bits=bits, text_encoder_bits=te_bits)
    want = jax_to_torch(jp.params)
    assert "kernel_q" in want["unet"]["conv"] and tp.params["unet"]["conv"]["kernel"].dim() == 4
    want["unet"]["conv"] = tp.params["unet"]["conv"]
    assert_trees_equal(to_numpy(tp.params), to_numpy(want))
    assert "kernel" in tp.params["unet"]["small"] and "kernel" in tp.params["vae"]["conv"]
    assert is_k_major(tp.params["unet"]["ff"]["kernel_q"])


def test_to_pil_matches_jax():
    from flux_generator_tpu.utils.images import to_pil as jto_pil
    from flux_generator_tpu_torch.utils.images import to_pil

    rng = np.random.RandomState(1)
    for images in (rng.rand(2, 8, 6, 3).astype(np.float32), (rng.rand(1, 5, 4, 3) * 255).astype(np.uint8)):
        got, want = to_pil(torch.from_numpy(images)), jto_pil(images)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.size == b.size and np.array_equal(np.asarray(a), np.asarray(b))
