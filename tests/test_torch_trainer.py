"""The ported trainer, datasets and checkpoints against the JAX package:
crop boxes and batch order from the same seeded draws, the dataset loaders,
adapter files read and written both ways, the train-state round trip, and a
tiny `train` run end to end on the CPU."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_generator_tpu.training import checkpoints as jckpt
from flux_generator_tpu.training import lora as jlora
from flux_generator_tpu.training.trainer import Trainer as JaxTrainer
from flux_generator_tpu_torch.io.params import to_numpy, tree_leaves
from flux_generator_tpu_torch.pipelines.flux import FluxPipeline
from flux_generator_tpu_torch.training import checkpoints as tckpt
from flux_generator_tpu_torch.training import datasets as tds
from flux_generator_tpu_torch.training import lora as tlora
from flux_generator_tpu_torch.training.dreambooth import build_optimizer, build_parser, main, train
from flux_generator_tpu_torch.training.trainer import Trainer
from tests.test_torch_bridge import jax_to_torch


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in ((40, 36, 3), (64, 48, 3), (20, 30, 3), (33, 65, 4))]


@pytest.mark.parametrize("resolution", [(32, 24), (16, 16), (24, 40)])
def test_crops_equal_the_jax_trainer(resolution):
    """The same np.random.RandomState draws in the same order give the same
    PIL crop boxes and Lanczos resizes: arrays equal exactly, for PIL images
    and for (H, W, C) uint8 arrays handed to the port."""
    from PIL import Image

    jt = JaxTrainer(None, None, resolution=resolution, seed=3)
    tt = Trainer(None, None, resolution=resolution, seed=3)
    for i, arr in enumerate(_images() * 2):
        want = jt._random_crop_resize(Image.fromarray(arr))
        got = tt._random_crop_resize(arr if i % 2 else Image.fromarray(arr))
        assert got.shape == (resolution[1], resolution[0], arr.shape[2])
        np.testing.assert_array_equal(got, want)


def test_iterate_order_equals_the_jax_trainer():
    """6 latents (3 prompts × 2 augmentations), batch 4: the same shuffles and
    the augmentation → caption mapping over three epochs."""
    jt = JaxTrainer(None, None, num_augmentations=2, seed=5)
    tt = Trainer(None, None, num_augmentations=2, seed=5)
    for i in range(6):
        jt.latents.append(np.full((1, 2), i, np.float32))
        tt.latents.append(torch.full((1, 2), float(i)))
    for i in range(3):
        jt.t5_features.append(np.full((1, 3), 10 + i, np.float32))
        jt.clip_features.append(np.full((1, 1), 20 + i, np.float32))
        tt.t5_features.append(torch.full((1, 3), 10.0 + i))
        tt.clip_features.append(torch.full((1, 1), 20.0 + i))
    for (xj, tj, cj), (xt, tt_, ct), _ in zip(jt.iterate(4), tt.iterate(4), range(6)):
        for a, b in ((xj, xt), (tj, tt_), (cj, ct)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _write_dataset(tmp_path, n=2):
    from PIL import Image

    for i, arr in enumerate(_images()[:n]):
        Image.fromarray(arr).save(tmp_path / f"img{i}.png")
    with open(tmp_path / "train.jsonl", "w") as f:
        for i in range(n):
            f.write(json.dumps({"image": f"img{i}.png", "prompt": f"a photo {i}"}) + "\n")
    return tmp_path


def test_load_dataset_local_and_legacy(tmp_path):
    _write_dataset(tmp_path)
    ds = tds.load_dataset(str(tmp_path))
    assert isinstance(ds, tds.LocalDataset) and len(ds) == 2
    img, prompt = ds[1]
    assert prompt == "a photo 1" and img.size == (48, 64)
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    with open(legacy / "index.json", "w") as f:
        json.dump({"data": [{"image": "../img0.png", "text": "t"}]}, f)
    ds = tds.load_dataset(str(legacy))
    assert isinstance(ds, tds.LegacyDataset) and ds[0][1] == "t"


def test_load_dataset_hugging_face(tmp_path, monkeypatch):
    """Neither train.jsonl nor index.json: the `datasets` package loads it
    (stubbed here; nothing is downloaded)."""
    import datasets

    rows = [{"image": "I", "prompt": "p"}]
    monkeypatch.setattr(datasets, "load_dataset", lambda name: {"train": rows})
    ds = tds.load_dataset(str(tmp_path / "some-hub-name"))
    assert isinstance(ds, tds.HuggingFaceDataset) and len(ds) == 1 and ds[0] == ("I", "p")


class _Pipe:
    def __init__(self, flow):
        self.params = {"flow": flow}


def _jax_lora_flow():
    from flux_generator_tpu.models.flux.model import init_flux, tiny_flux_config

    flow = init_flux(jax.random.PRNGKey(0), tiny_flux_config())
    flow = jlora.apply_lora_to_flux(flow, rank=2, key=jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
        if "lora" in jax.tree_util.keystr(p) else v, flow)


def test_adapter_files_both_ways(tmp_path):
    """The port's adapter file is read by safetensors.numpy and by the JAX
    loader; the port reads a file the JAX package wrote. Same keys, f32
    tensors, metadata."""
    from safetensors import safe_open

    flow_j = _jax_lora_flow()
    flow_t = jax_to_torch(flow_j)
    ours, theirs = tmp_path / "port.safetensors", tmp_path / "jax.safetensors"
    tckpt.save_adapter(ours, flow_t, 2, 3)
    jckpt.save_adapter(theirs, flow_j, 2, 3)
    with safe_open(str(ours), framework="np") as f:
        meta = f.metadata()
        port_tensors = {k: f.get_tensor(k) for k in f.keys()}
    assert meta == {"lora_rank": "2", "lora_blocks": "3", "format": "flux_generator_tpu.stacked.v1"}
    want = jckpt.extract_lora_flat(flow_j)
    assert set(port_tensors) == set(want)
    for k, v in port_tensors.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, want[k])

    # the JAX loader reads the port's file into a flow whose adapters are zero
    zeroed = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.zeros_like(v) if "lora" in jax.tree_util.keystr(p) else v, flow_j)
    pipe = _Pipe(zeroed)
    jckpt.load_adapter_file(pipe, ours)
    for k, v in jckpt.extract_lora_flat(pipe.params["flow"]).items():
        np.testing.assert_array_equal(v, want[k])

    # the port reads the JAX package's file
    tensors, meta = tckpt.load_safetensors(theirs)
    assert meta["lora_rank"] == "2" and set(tensors) == set(want)
    pipe = _Pipe(tlora.merge_lora(flow_t, jax_to_torch(jlora.extract_lora(zeroed))))
    tckpt.load_adapter_file(pipe, theirs)
    for k, v in tckpt.extract_lora_flat(pipe.params["flow"]).items():
        np.testing.assert_array_equal(v.numpy(), want[k])


def test_load_adapter_injects_and_fuses(tmp_path):
    """Into a flow without adapters: inject at the recorded rank, then fuse
    into the kernels as the JAX loader does."""
    flow_j = _jax_lora_flow()
    path = tmp_path / "a.safetensors"
    jckpt.save_adapter(path, flow_j, 2, -1)
    base_t = jax_to_torch(jlora.fuse_lora(jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.zeros_like(v) if "lora" in jax.tree_util.keystr(p) else v, flow_j)))
    pipe = _Pipe(base_t)
    tckpt.load_adapter_file(pipe, path, fuse=True)
    want = jax.tree.map(np.asarray, jlora.fuse_lora(flow_j))
    got = to_numpy(pipe.params["flow"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_train_state_round_trip(tmp_path):
    flow_t = jax_to_torch(_jax_lora_flow())
    lora = tlora.extract_lora(flow_t)
    opt = build_optimizer(1e-3, 1, 4)
    state = opt.init(lora)
    grads = [torch.randn_like(p) for p in tree_leaves(lora)]
    it = iter(grads)
    state = opt.update(jax.tree.map(lambda _: next(it), lora), state, lora)
    tckpt.save_train_state(tmp_path / "ckpt", 1, lora, state)
    tckpt.save_train_state(tmp_path / "ckpt", 3, lora, state)
    template = tlora.extract_lora(jax_to_torch(_jax_lora_flow()))
    step, lora2, state2 = tckpt.load_train_state(tmp_path / "ckpt", template, opt.init(template))
    assert step == 3 and state2["count"] == 1
    for a, b in zip(tree_leaves((lora, state["mu"], state["nu"])),
                    tree_leaves((lora2, state2["mu"], state2["nu"]))):
        assert torch.equal(a, b)
    assert tckpt.load_train_state(tmp_path / "none", template, state) is None


class _TokStub:
    def encode(self, texts, **kw):
        if isinstance(texts, str):
            texts = [texts]
        return [[1, 2, 3, 0] for _ in texts]


@pytest.mark.parametrize("quantize", [False, True])
def test_train_tiny_end_to_end(tmp_path, quantize):
    """Three optimizer steps of accumulation 2 on the CPU with a last-2-blocks
    mask: losses finite, the adapter files written, only the unmasked blocks
    trained, the base untouched (int8 with --quantize-base)."""
    pipe = FluxPipeline.random_init("flux-dev", tiny=True, dtype=torch.float32, device="cpu",
                                    hidden_size=512, num_heads=4, axes_dim=(16, 56, 56))
    pipe.t5_tokenizer = pipe.clip_tokenizer = _TokStub()
    base = {k: v.clone() for k, v in tckpt._flatten(pipe.params["flow"]).items()}
    out = tmp_path / "out"
    args = build_parser().parse_args([
        str(tmp_path), "--model", "dev", "--iterations", "3", "--batch-size", "1",
        "--resolution", "32x32", "--num-augmentations", "2", "--grad-accumulate", "2",
        "--lora-rank", "2", "--lora-blocks", "2", "--progress-every", "0",
        "--checkpoint-every", "2", "--warmup-steps", "1", "--save-state",
        "--output-dir", str(out), *(["--quantize-base"] if quantize else []),
    ])
    dataset = [(img, f"prompt {i}") for i, img in enumerate(_images()[:2])]
    trace = {}
    trained = train(args, pipeline=pipe, dataset=dataset, trace=trace)
    assert len(trace["micro_step_s"]) == 6 and np.isfinite(trace["losses"]).all()
    for name in ("adapter_config.json", "0000002_adapters.safetensors",
                 "final_adapters.safetensors", "ckpt/0000002.pt"):
        assert (out / name).exists(), name
    flat = tckpt._flatten(trained.params["flow"])
    assert any(k.endswith("kernel_q") for k in flat) == quantize
    for k, v in flat.items():
        if k.endswith("lora_b"):
            assert bool(v.any()) == k.startswith("single_blocks"), k
        elif "lora" not in k and k in base:
            assert torch.equal(v, base[k]), k
    tensors, meta = tckpt.load_safetensors(out / "final_adapters.safetensors")
    assert meta["lora_blocks"] == "2"
    for k, v in tckpt.extract_lora_flat(trained.params["flow"]).items():
        np.testing.assert_array_equal(tensors[k], v.detach().numpy())


def test_train_needs_a_pipeline(tmp_path):
    with pytest.raises(NotImplementedError):
        main([str(tmp_path), "--output-dir", str(tmp_path / "out")])


ASSETS = Path(__file__).parent / "assets"
TOKENIZER_ARGS = ["--t5-tokenizer", str(ASSETS / "spiece" / "t5_like.model"),
                  "--clip-tokenizer", str(ASSETS / "clip_tokenizer")]


def test_main_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """With no card and no --device, the CLI's random-weights path raises
    instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(tmp_path), "--random-weights", *TOKENIZER_ARGS, "--output-dir", str(tmp_path / "out")])


def test_main_random_weights_on_the_cpu(tmp_path, monkeypatch):
    """`main` end to end with --device cpu on a dataset directory: the
    full-width random init is swapped for a tiny one whose text encoders
    take the test tokenizers' ids; T5 goes to int4 as on the card."""
    from flux_generator_tpu_torch.models.clip.text import init_clip_text, tiny_clip_config

    real = FluxPipeline.random_init.__func__

    def tiny(cls, name, device=None, **kw):
        assert device == torch.device("cpu")
        pipe = real(cls, name, tiny=True, dtype=torch.float32, device=device, hidden_size=128,
                    num_heads=2, axes_dim=(16, 24, 24))
        pipe.clip_cfg = tiny_clip_config(model_dims=pipe.flow_cfg.vec_in_dim, vocab_size=719,
                                         max_length=77)
        pipe.params["clip"] = init_clip_text(torch.Generator().manual_seed(1), pipe.clip_cfg)
        return pipe

    monkeypatch.setattr(FluxPipeline, "random_init", classmethod(tiny))
    data = tmp_path / "data"
    data.mkdir()
    _write_dataset(data)
    out = tmp_path / "out"
    main([str(data), "--model", "schnell", "--random-weights", *TOKENIZER_ARGS, "--device", "cpu",
          "--iterations", "2", "--resolution", "32x32", "--num-augmentations", "1",
          "--grad-accumulate", "1", "--lora-rank", "2", "--progress-every", "0",
          "--output-dir", str(out)])
    tensors, meta = tckpt.load_safetensors(out / "final_adapters.safetensors")
    assert meta["lora_rank"] == "2" and any(k.endswith("lora_b") and v.any() for k, v in tensors.items())
