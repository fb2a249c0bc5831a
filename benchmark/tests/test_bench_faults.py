"""Whole runs at a tiny size on the CPU, the card's check skipped: a sound
system comes out correct, and each fault a cell can have, planted in the
timed path, comes out not correct. The control, the reference computed a
precision below the configuration's in the program's place, comes out not
correct by each cell's own limits."""

import pytest
import torch

from benchmark import harness

FLUX_LIMITS = {"image_rel_l2": 0.05}
MUSIC_LIMITS = {"logit_gap": 0.05, "topk_gap": 0.05, "wave_rel_l2": 1e-3}


def _cell(name, limits, dtype="float32"):
    cell = harness.load_cell(name)
    tiny = dict(width=64, height=64) if "width" in cell.traffic else dict(max_steps=[16, 24], top_k=4)
    cell.traffic = dict(cell.traffic, **tiny)
    cell.config = dict(cell.config, dtype=dtype)
    cell.checks = {"sample": 2, "limits": limits}
    return cell


def _run(name, limits, plant=None, seconds=1.5):
    return harness.run(_cell(name, limits), 2 ** 31 + 5, seconds, False, device="cpu", tiny=True, on_system=plant)


def test_sound_systems_are_correct():
    for name, limits in (("flux-schnell.1024-b4", FLUX_LIMITS), ("musicgen-medium.b4", MUSIC_LIMITS)):
        res = _run(name, limits)
        assert res["correct"], res


def _flux_decode(fault):
    def plant(system):
        pipe = system.pipe
        decode = pipe.decode_u8

        def broken(x, latent_size):
            return fault(decode(x, latent_size))
        pipe.decode_u8 = broken
    return plant


def _answer_altered(img):
    img = img.clone()
    img[0] = img[0] // 2 + 60
    return img


def _half_batch(system):
    """Each step computes the first half of the batch and hands it out twice."""
    pipe = system.pipe
    step = pipe._step

    def broken(x_t, *args):
        out = step(x_t, *args)
        half = x_t.shape[0] // 2
        return torch.cat([out[:half], out[:half]]) if half else out
    pipe._step = broken


def _step_unchanged(system):
    pipe = system.pipe
    step = pipe._step
    calls = []

    def broken(x_t, *args):
        calls.append(1)
        return x_t if len(calls) % 4 == 2 else step(x_t, *args)
    pipe._step = broken


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch", "step_unchanged"])
def test_flux_faults_fail(fault):
    plant = {"answer_altered": _flux_decode(_answer_altered), "half_batch": _half_batch,
             "step_unchanged": _step_unchanged}[fault]
    res = _run("flux-schnell.1024-b4", FLUX_LIMITS, plant)
    assert res["checked_requests"] and not res["correct"], res["checks"]


def _token_altered(monkeypatch):
    from flux_generator_tpu_torch.models.musicgen import model as mg

    sample = mg.top_k_sample
    count = []

    def broken(generator, logits, top_k, temperature):
        out = sample(generator, logits, top_k, temperature)
        count.append(1)
        if len(count) % 7 == 5:
            out = (out + 1) % logits.shape[-2]
        return out
    monkeypatch.setattr(mg, "top_k_sample", broken)


def _cache_unchanged(monkeypatch):
    from flux_generator_tpu_torch.models.musicgen import model as mg

    step = mg.decode_step

    def broken(params, cfg, tokens, cross_kv, k_cache, v_cache, offset, **kw):
        keep = (k_cache[:, :, offset].clone(), v_cache[:, :, offset].clone())
        logits, k_cache, v_cache = step(params, cfg, tokens, cross_kv, k_cache, v_cache, offset, **kw)
        if offset > 0:  # every step after the first leaves the caches as it found them
            k_cache[:, :, offset], v_cache[:, :, offset] = keep
        return logits, k_cache, v_cache
    monkeypatch.setattr(mg, "decode_step", broken)


def _topk_ignored(monkeypatch):
    """Sampled requests draw from the whole vocabulary; greedy ones stay sound."""
    from flux_generator_tpu_torch.models.musicgen import model as mg

    sample = mg.top_k_sample

    def broken(generator, logits, top_k, temperature):
        return sample(generator, logits, logits.shape[-2] if top_k > 1 else top_k, temperature)
    monkeypatch.setattr(mg, "top_k_sample", broken)


@pytest.mark.parametrize("fault", ["token_altered", "cache_unchanged", "topk_ignored"])
def test_musicgen_faults_fail(fault, monkeypatch):
    {"token_altered": _token_altered, "cache_unchanged": _cache_unchanged,
     "topk_ignored": _topk_ignored}[fault](monkeypatch)
    res = _run("musicgen-medium.b4", MUSIC_LIMITS, seconds=3.0)
    assert res["checked_requests"] and not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["flux-schnell.1024-b4", "musicgen-medium.b4", "musicgen-medium.solo"])
def test_control_fails_the_cells_own_limits(name):
    """The program in bf16 as configured, judged by the cell's own limits
    (workloads/<cell>.json): correct; the control in fp8 (bf16 for the f32
    codec) in its place, on the same requests: not correct, and above the
    program in every number."""
    cell = _cell(name, harness.load_cell(name).checks["limits"], dtype="bfloat16")
    res = harness.run(cell, 11, 2.0, False, device="cpu", tiny=True, control=True)
    got, low = res["checks"], res["control_checks"]
    assert res["correct"] and res["control_correct"] is False, (got, low)
    assert set(low) == set(got) and all(c["limit"] is not None for c in low.values())
    assert all(low[k]["value"] > got[k]["value"] for k in got), (got, low)
    if "wave_rel_l2" in low:
        assert low["wave_rel_l2"]["value"] > low["wave_rel_l2"]["limit"]
