"""The yardstick's counts against counts worked out by hand at the
published widths."""

import json
from pathlib import Path

import pytest

from benchmark.counts import flux, musicgen, peaks

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
FLUX = json.loads((CONFIGS / "flux-schnell.json").read_text())
MG = json.loads((CONFIGS / "musicgen-medium.json").read_text())


def test_flux_image_step_at_1024():
    dense, attn = flux.denoise_flops(FLUX["flow"], 4096, 256)
    # a double block: per token 2·3072·9216 + 2·3072² + 4·3072·12288 = 226,492,416
    # over 4096 + 256 tokens; a single block: 2·4352·3072·21504 + 2·4352·15360·3072
    assert dense == 19 * 4352 * 226_492_416 + 38 * (2 * 4352 * 3072 * 21504 + 2 * 4352 * 15360 * 3072)
    assert dense == pytest.approx(5.61e13, rel=2e-3)
    assert attn == 57 * 4 * 4352 ** 2 * 3072 == pytest.approx(1.33e13, rel=3e-3)


def test_text_encoders():
    # T5-XXL at 256 tokens: q, k, v, o 4·2·256·4096·4096; scores and mix 4·256²·4096;
    # gated FFN 3·2·256·4096·10240; 24 layers
    layer = 4 * 2 * 256 * 4096 * 4096 + 4 * 256 ** 2 * 4096 + 3 * 2 * 256 * 4096 * 10240
    assert flux.t5_flops(FLUX["t5"], 256) == 24 * layer == pytest.approx(2.3966e12, rel=1e-4)
    # CLIP-L at 77: 4 projections and a 4·768-wide MLP, 12 layers
    assert flux.clip_flops(FLUX["clip"], 77) == 12 * (24 * 77 * 768 ** 2 + 4 * 77 ** 2 * 768)
    # T5-base (ReLU FFN) at 20 tokens
    assert flux.t5_flops(MG["t5"], 20) == 12 * (8 * 20 * 768 * 768 + 4 * 400 * 768 + 4 * 20 * 768 * 3072)


def test_vae_decoder_at_1024():
    px = {128: 128 ** 2, 256: 256 ** 2, 512: 512 ** 2, 1024: 1024 ** 2}

    def conv(cin, cout, n, k=9):
        return 2 * k * cin * cout * n

    total = conv(16, 512, px[128])  # conv_in
    total += 4 * conv(512, 512, px[128]) + 4 * 2 * px[128] * 512 ** 2 + 4 * px[128] ** 2 * 512  # mid
    total += 6 * conv(512, 512, px[128]) + conv(512, 512, px[256])  # level 3 and its upsample
    total += 6 * conv(512, 512, px[256]) + conv(512, 512, px[512])  # level 2
    total += conv(512, 256, px[512]) + conv(256, 256, px[512]) + conv(512, 256, px[512], 1)  # level 1
    total += 4 * conv(256, 256, px[512]) + conv(256, 256, px[1024])
    total += conv(256, 128, px[1024]) + conv(128, 128, px[1024]) + conv(256, 128, px[1024], 1)  # level 0
    total += 4 * conv(128, 128, px[1024]) + conv(128, 3, px[1024])  # conv_out
    assert flux.vae_decode_flops(FLUX["ae"], 128, 128) == total == pytest.approx(1.047e13, rel=1e-3)


def test_attention_and_rope_launch_bounds():
    ops, nbytes = flux.attention_launch(4, 4352, 24, 128)
    assert ops == 4 * 4 * 24 * 4352 ** 2 * 128
    assert nbytes == 4 * 2 * 4 * 4352 * 24 * 128 + 4 * 4 * 24 * 4352
    assert peaks.bound_ms(ops, nbytes)[1] == "operations"
    ops, nbytes = flux.rope_launch(1, 1280, 24, 128)
    assert nbytes == 2 * 2 * 2 * 1280 * 24 * 128 + 2 * 2 * 1280 * 64
    assert peaks.bound_ms(ops, nbytes)[1] == "bytes"


def test_musicgen_step():
    dec = MG["decoder"]
    # a layer's weights a step: qkv 3·1536², o, cross q and o, FFN 2·1536·6144, 3 LayerNorms, bf16
    assert musicgen.layer_weight_bytes(dec) == 2 * (6 * 1536 ** 2 + 2 * 1536 * 6144 + 6 * 1536)
    ops, nbytes = musicgen.decode_launch(dec, 8, 499, 64)
    assert nbytes == 48 * 2 * 33_039_360 + 48 * 2 * 8 * (2 * 500 * 1536 + 2 * 64 * 1536 + 2 * 1536) + 4 * 8 * 1536
    assert nbytes / peaks.PEAK_BYTES_S * 1e3 == pytest.approx(1.3447, rel=1e-4)  # ms: D's floor at B 8
    assert ops == 48 * 8 * (2 * 1536 * 6 * 1536 + 4 * 1536 * 6144 + 4 * 500 * 1536 + 4 * 64 * 1536)
    heads = 4 * 1536 * 2048
    assert musicgen.step(dec, 8, 499, 64) == (ops + 2 * 8 * heads, nbytes + 2 * heads)
    assert len(musicgen.request_steps(dec, 2, 500, 16)) == 500


def test_bound_is_the_larger_of_the_two():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_ms(989e9, 3.35e12)[0] == pytest.approx(1000.0)
