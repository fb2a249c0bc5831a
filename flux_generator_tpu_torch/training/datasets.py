"""Fine-tuning datasets (counterpart of flux_generator_tpu/training/datasets.py).
PIL and the `datasets` package are imported when an item or a Hugging Face
dataset is loaded."""

from __future__ import annotations

import json
from pathlib import Path


class Dataset:
    def __getitem__(self, index: int):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class LocalDataset(Dataset):
    """train.jsonl with {"image": ..., "prompt": ...} rows."""

    prompt_key = "prompt"

    def __init__(self, dataset: str, data_file):
        self.dataset_base = Path(dataset)
        with open(data_file) as f:
            self._data = [json.loads(line) for line in f if line.strip()]

    def __len__(self):
        return len(self._data)

    def __getitem__(self, index: int):
        from PIL import Image

        item = self._data[index]
        return Image.open(self.dataset_base / item["image"]), item[self.prompt_key]


class LegacyDataset(LocalDataset):
    """index.json with {"data": [{"image": ..., "text": ...}]}."""

    prompt_key = "text"

    def __init__(self, dataset: str):
        self.dataset_base = Path(dataset)
        with open(self.dataset_base / "index.json") as f:
            self._data = json.load(f)["data"]


class HuggingFaceDataset(Dataset):
    def __init__(self, dataset: str):
        from datasets import load_dataset as hf_load_dataset

        self._df = hf_load_dataset(dataset)["train"]

    def __len__(self):
        return len(self._df)

    def __getitem__(self, index: int):
        item = self._df[index]
        return item["image"], item["prompt"]


def load_dataset(dataset: str) -> Dataset:
    base = Path(dataset)
    if (base / "train.jsonl").exists():
        print(f"Load the local dataset {base / 'train.jsonl'} .", flush=True)
        return LocalDataset(dataset, base / "train.jsonl")
    if (base / "index.json").exists():
        print(
            f"Load the local dataset {base / 'index.json'} .\n"
            "     WARNING: 'index.json' is deprecated in favor of 'train.jsonl'.",
            flush=True,
        )
        return LegacyDataset(dataset)
    print(f"Load the Hugging Face dataset {dataset} .", flush=True)
    return HuggingFaceDataset(dataset)
