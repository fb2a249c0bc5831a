"""Multi-process DreamBooth LoRA training (training/dreambooth.py), the
port's counterpart of tests/test_multihost.py, on the CPU: two spawned
processes joined by a gloo group run the unmodified `train` on one tiny
dataset; each takes its rows of the shared global batch and the LoRA
gradients are averaged across them. Their losses agree bit for bit, only
process 0 writes files, and losses and adapters agree with one process
training on the whole global batch (1e-5 and 1e-4)."""

import json

import numpy as np
import pytest
import torch

from flux_generator_tpu_torch.io.params import tree_leaves
from flux_generator_tpu_torch.training.lora import extract_lora
from tests.test_torch_parallel import _one_thread, spawn_ranks  # noqa: F401 (_one_thread: autouse)


class _Tokens:
    def encode(self, texts):
        texts = [texts] if isinstance(texts, str) else texts
        return [[1, 2, 3, 0] for _ in texts]


def _train(data_dir, out_dir, batch=8, iterations=2):
    """The tiny run: 2 images × 4 augmentations, a global batch of 8, 2
    optimizer steps → (pipeline, trace)."""
    from flux_generator_tpu_torch.pipelines.flux import FluxPipeline
    from flux_generator_tpu_torch.training.datasets import load_dataset
    from flux_generator_tpu_torch.training.dreambooth import build_parser, train

    pipe = FluxPipeline.random_init("flux-schnell", tiny=True, dtype=torch.float32, device="cpu")
    pipe.clip_tokenizer = pipe.t5_tokenizer = _Tokens()
    args = build_parser().parse_args([
        str(data_dir), "--model", "schnell", "--iterations", str(iterations), "--batch-size", str(batch),
        "--resolution", "32x32", "--num-augmentations", "4", "--grad-accumulate", "1", "--lora-rank", "2",
        "--progress-every", "0", "--checkpoint-every", "0", "--warmup-steps", "1", "--device", "cpu",
        "--output-dir", str(out_dir)])
    trace = {}
    trained = train(args, pipeline=pipe, dataset=load_dataset(str(data_dir)), trace=trace)
    return trained, trace


def _rank_train(rank, world, payload):
    from flux_generator_tpu_torch.parallel.distributed import process_info

    trained, trace = _train(payload["data"], f"{payload['out']}/rank{rank}")
    res = dict(info=process_info(), losses=trace["losses"], lora=_lora(trained))
    # a batch of 3 on 2 processes: gcd 1, so process 1 sits out and takes
    # process 0's adapters at the end
    trained, trace = _train(payload["data"], f"{payload['out']}/gcd{rank}", batch=3, iterations=1)
    return dict(res, gcd_losses=trace["losses"], gcd_lora=_lora(trained))


def _lora(pipe):
    return [t.detach().numpy() for t in tree_leaves(extract_lora(pipe.params["flow"]))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from PIL import Image

    data = tmp_path_factory.mktemp("data")
    for i in range(2):
        Image.fromarray((np.random.RandomState(i).rand(64, 64, 3) * 255).astype(np.uint8)).save(data / f"img{i}.png")
    (data / "train.jsonl").write_text("".join(json.dumps({"image": f"img{i}.png", "prompt": f"p {i}"}) + "\n"
                                              for i in range(2)))
    out = tmp_path_factory.mktemp("out")
    ranks = spawn_ranks(_rank_train, 2, tmp_path_factory.mktemp("mh"), dict(data=str(data), out=str(out)))
    trained, trace = _train(data, out / "single")
    single = dict(losses=trace["losses"], lora=_lora(trained))
    trained, trace = _train(data, out / "single_gcd", batch=3, iterations=1)
    single.update(gcd_losses=trace["losses"], gcd_lora=_lora(trained))
    return ranks, single, out


def test_ranks_agree_bit_for_bit(runs):
    ranks, _, _ = runs
    assert [r["info"]["process_index"] for r in ranks] == [0, 1]
    assert all(r["info"]["process_count"] == 2 for r in ranks)
    assert len(ranks[0]["losses"]) == 2 and ranks[0]["losses"] == ranks[1]["losses"]
    for a, b in zip(ranks[0]["lora"], ranks[1]["lora"]):
        np.testing.assert_array_equal(a, b)
    assert sum(float(np.abs(a).sum()) for a in ranks[0]["lora"]) != 0.0


def test_only_process_zero_writes(runs):
    _, _, out = runs
    assert (out / "rank0" / "final_adapters.safetensors").exists()
    assert (out / "rank0" / "adapter_config.json").exists()
    assert not (out / "rank1" / "final_adapters.safetensors").exists()
    assert not (out / "rank1" / "adapter_config.json").exists()


def test_two_processes_equal_one_on_the_global_batch(runs):
    ranks, single, _ = runs
    np.testing.assert_allclose(ranks[0]["losses"], single["losses"], atol=1e-5)
    assert len(ranks[0]["lora"]) == len(single["lora"])
    for a, b in zip(ranks[0]["lora"], single["lora"]):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_a_batch_that_does_not_divide_trains_on_the_gcd(runs):
    ranks, single, out = runs
    assert ranks[0]["gcd_losses"] and not ranks[1]["gcd_losses"]  # process 1 sat out
    np.testing.assert_allclose(ranks[0]["gcd_losses"], single["gcd_losses"], atol=1e-5)
    for a, b, c in zip(ranks[0]["gcd_lora"], ranks[1]["gcd_lora"], single["gcd_lora"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, atol=1e-4)
    assert (out / "gcd0" / "final_adapters.safetensors").exists()
    assert not (out / "gcd1" / "final_adapters.safetensors").exists()
