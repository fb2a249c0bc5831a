"""The plain reference against the port at tiny configurations on the CPU,
both in f32 from the same weights (the benchmark's own draw, norms with
affine parts): the tokenizers, T5 and CLIP, the Flux flow and VAE decoder,
MusicGen's guided logits and EnCodec's decoder."""

import dataclasses
import json
import random
from pathlib import Path

import pytest
import torch

from benchmark import weights
from benchmark.reference import flux as rflux
from benchmark.reference import musicgen as rmg
from benchmark.reference import text as rtext
from benchmark.reference.tokenizers import BpeCLIP, UnigramT5

ASSETS = Path(__file__).resolve().parents[1] / "assets"


def _d(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def _w(spec, seed=0):
    return weights.draw(spec, seed, "cpu", torch.float32)


def _prompts(n=40):
    words = (ASSETS / "words.txt").read_text().split() + ["Zoë", "naïve", "x-ray", "it's", "42", "?!", "東京"]
    rng = random.Random(3)
    return [" ".join(rng.choice(words) for _ in range(rng.randint(1, 30))) for _ in range(n)] + ["", "  a  "]


def test_tokenizers_match_the_port():
    from flux_generator_tpu_torch.io.tokenizers import load_clip_tokenizer, load_t5_tokenizer

    t5 = load_t5_tokenizer(ASSETS / "spiece" / "t5_like.model", max_length=256, engine="python")
    clip = load_clip_tokenizer(ASSETS / "clip_tokenizer" / "vocab.json", ASSETS / "clip_tokenizer" / "merges.txt",
                               engine="python")
    rt5, rclip = UnigramT5(ASSETS / "spiece" / "t5_like.model", 256), BpeCLIP(ASSETS / "clip_tokenizer")
    for p in _prompts():
        assert rt5.encode(p) == t5.encode(p)[0]
        assert rt5.encode(p, pad=False) == t5.encode(p, pad=False)[0]
        assert rclip.encode(p) == clip.encode(p)[0]


def test_t5_buckets_at_full_size():
    from flux_generator_tpu_torch.models.t5.t5 import T5Config, _relative_position_bucket

    cfg = T5Config()
    pos = torch.arange(600)
    rel = pos[None, :] - pos[:, None]
    assert torch.equal(rtext._buckets(rel, 32, 128),
                       _relative_position_bucket(rel, True, cfg.relative_attention_num_buckets,
                                                 cfg.relative_attention_max_distance))


def test_t5_and_clip():
    from flux_generator_tpu_torch.models.clip.text import clip_text_forward, tiny_clip_config
    from flux_generator_tpu_torch.models.t5.t5 import t5_encode, tiny_t5_config

    for ff in ("gated-gelu", "relu"):
        cfg = tiny_t5_config(feed_forward_proj=ff)
        p = _w(weights.t5_encoder(_d(cfg)))
        tok = torch.randint(0, cfg.vocab_size, (2, 13), generator=_g(1))
        torch.testing.assert_close(rtext.t5_encode(p, _d(cfg), tok), t5_encode(p, cfg, tok), rtol=1e-4, atol=1e-5)
    cfg = tiny_clip_config(vocab_size=100, max_length=20)
    p = _w(weights.clip_text(_d(cfg)))
    tok = torch.randint(0, 98, (2, 11), generator=_g(2))
    tok[0, 6], tok[1, 9] = 99, 99
    torch.testing.assert_close(rtext.clip_pooled(p, _d(cfg), tok), clip_text_forward(p, cfg, tok)["pooled_output"],
                               rtol=1e-4, atol=1e-5)


def test_flux_flow_and_vae():
    from flux_generator_tpu_torch.models.flux import autoencoder as ae
    from flux_generator_tpu_torch.models.flux.model import flux_forward, tiny_flux_config
    from flux_generator_tpu_torch.pipelines.flux import latent_ids

    cfg = tiny_flux_config()
    p = _w(weights.flux_flow(_d(cfg)))
    g = _g(4)
    img, txt = torch.randn(2, 16, cfg.in_channels, generator=g), torch.randn(2, 5, cfg.context_in_dim, generator=g)
    y, t = torch.randn(2, cfg.vec_in_dim, generator=g), torch.tensor([1.0, 0.5])
    ids, tids = latent_ids(2, 8, 8), torch.zeros(2, 5, 3, dtype=torch.int32)
    want = flux_forward(p, cfg, img=img, img_ids=ids, txt=txt, txt_ids=tids, timesteps=t, y=y)
    torch.testing.assert_close(rflux.flow(p, _d(cfg), img, ids, txt, tids, t, y), want, rtol=1e-4, atol=1e-4)
    acfg = ae.tiny_ae_config(ch=32, z_channels=4)
    ap = _w(weights.flux_ae(_d(acfg)), 5)
    z = torch.randn(2, 6, 6, 4, generator=g)
    torch.testing.assert_close(rflux.vae_decode(ap, _d(acfg), z), ae.decode(ap, acfg, z), rtol=1e-4, atol=1e-4)


def test_musicgen_guided_logits_follow_the_cached_steps():
    from flux_generator_tpu_torch.models.musicgen import model as mg

    cfg = mg.tiny_musicgen_config()
    p = _w(weights.musicgen_decoder(_d(cfg)))
    n, steps, s = 2, 12, 5
    cond = torch.randn(n, s, cfg.hidden_size, generator=_g(6))
    codes = torch.randint(0, cfg.codebook_size, (n, cfg.num_codebooks, steps - cfg.num_codebooks + 1), generator=_g(7))
    seq = rmg.delayed(codes, _d(cfg), steps)
    got = rmg.guided_logits({"decoder": p}, _d(cfg), cond, seq, 3.0)
    both = torch.cat([cond, torch.zeros_like(cond)])
    cross = mg.precompute_cross_kv(p, cfg, both)
    kc, vc = mg.init_kv_cache(cfg, 2 * n, steps, torch.float32)
    for t in range(steps):
        tok = torch.cat([seq[:, t:t + 1], seq[:, t:t + 1]])
        logits, kc, vc = mg.decode_step(p, cfg, tok, cross, kc, vc, t)
        want = logits[n:, 0] + (logits[:n, 0] - logits[n:, 0]) * 3.0
        torch.testing.assert_close(got[:, t], want, rtol=1e-4, atol=1e-4)
    live = rmg.live_mask(_d(cfg), steps, "cpu")
    assert live.sum() == cfg.num_codebooks * (steps - cfg.num_codebooks + 1)


def test_delay_pattern_round_trips_the_ports_undo():
    cfg = {"num_codebooks": 4, "bos_token_id": 99}
    steps = 10
    codes = torch.arange(4 * 7).reshape(1, 4, 7)
    seq = rmg.delayed(codes, cfg, steps)
    undone = torch.stack([seq[:, k + 1:k + 1 + 7, k] for k in range(4)], dim=1)  # the port's undo
    assert torch.equal(undone, codes)
    assert (seq[0, 0] == 99).all() and seq[0, 1, 1] == 99


def test_encodec_decoder():
    from flux_generator_tpu_torch.models.musicgen.encodec import EncodecModel, tiny_encodec_config

    cfg = tiny_encodec_config()
    model = EncodecModel(cfg, _w(weights.encodec(_d(cfg))))
    codes = torch.randint(0, cfg.codebook_size, (1, 2, 9), generator=_g(8))
    torch.testing.assert_close(rmg.encodec_decode(model.params, _d(cfg), codes),
                               model.decode(codes[None], [None]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_encodec_pads_by_the_effective_kernel(dilation):
    """A stride-1 SEANet conv keeps the length at any dilation: the padding
    is (k − 1)·dilation + 1 − stride, as EnCodec pads."""
    c = {"conv": {"kernel": torch.randn(3, 2, 2, generator=_g(10)), "bias": torch.zeros(2)}}
    x = torch.randn(1, 17, 2, generator=_g(11))
    assert rmg._pad_conv(c, None, x, 3, 1, dilation, rmg.F32).shape == x.shape


@pytest.mark.parametrize("name", ["fp8", "bf16"])
def test_lower_precisions_round_the_products(name):
    from benchmark.reference.ops import Precision, dense

    g = _g(9)
    p = {"kernel": torch.randn(64, 32, generator=g), "bias": torch.zeros(32)}
    x = torch.randn(8, 64, generator=g)
    err = (dense(p, x, Precision(name)) - dense(p, x)).norm() / dense(p, x).norm()
    assert (2e-2 < err < 1e-1) if name == "fp8" else (1e-3 < err < 1e-2)
