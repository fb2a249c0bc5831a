"""Dataset pre-encoding and batch iteration (counterpart of
flux_generator_tpu/training/trainer.py).

Every image is encoded to VAE latents under N random crop/pan augmentations
(crop scale in [0.8, 1.0]), every prompt to T5/CLIP features; `iterate`
then serves an endless shuffled batch stream that maps augmentation index →
caption index. The draws come from `np.random.RandomState(seed)` in the JAX
package's order, so crop boxes and shuffles equal its own.
"""

from __future__ import annotations

import numpy as np
import torch


class Trainer:
    def __init__(self, flux, dataset, resolution=(512, 512), num_augmentations: int = 5,
                 seed: int = 0):
        self.flux = flux
        self.dataset = dataset
        self.resolution = tuple(resolution)
        self.num_augmentations = num_augmentations
        self.rng = np.random.RandomState(seed)
        self.latents = []
        self.t5_features = []
        self.clip_features = []

    def _random_crop_resize(self, img) -> np.ndarray:
        """A PIL image or an (H, W, C) uint8 array → (H', W', C) uint8 at
        `resolution`: random crop and pan, centre crop to the aspect ratio,
        Lanczos resize (PIL's, as in the JAX package)."""
        from PIL import Image

        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        resolution = self.resolution
        width, height = img.size
        a, b, c, d = self.rng.uniform(size=4)

        crop_size = (
            max((0.8 + 0.2 * a) * width, resolution[0]),
            max((0.8 + 0.2 * b) * height, resolution[1]),
        )
        pan = (width - crop_size[0], height - crop_size[1])
        img = img.crop(
            (pan[0] * c, pan[1] * d, crop_size[0] + pan[0] * c, crop_size[1] + pan[1] * d)
        )

        width, height = crop_size
        ratio = resolution[0] / resolution[1]
        r1 = (height * ratio, height)
        r2 = (width, width / ratio)
        r = r1 if r1[0] <= width else r2
        img = img.crop(
            (
                (width - r[0]) / 2,
                (height - r[1]) / 2,
                (width + r[0]) / 2,
                (height + r[1]) / 2,
            )
        )
        return np.array(img.resize(resolution, Image.LANCZOS))

    def _encode_image(self, input_img, num_augmentations: int):
        flux = self.flux
        for _ in range(num_augmentations):
            img = self._random_crop_resize(input_img)
            x = torch.from_numpy(np.ascontiguousarray(img[:, :, :3])).to(flux.device, flux.dtype)
            x_0 = flux._encode_image((x / 255 * 2 - 1)[None])
            self.latents.append(x_0.to(flux.dtype))

    def _encode_prompt(self, prompt: str):
        t5_tok, clip_tok = self.flux.tokenize([prompt])
        txt, _, vec = self.flux.prepare_conditioning(1, t5_tok, clip_tok)
        self.t5_features.append(txt)
        self.clip_features.append(vec)

    @torch.no_grad()
    def encode_dataset(self):
        for image, prompt in self.dataset:
            self._encode_image(image, self.num_augmentations)
            self._encode_prompt(prompt)

    def iterate(self, batch_size: int):
        xs = torch.cat(self.latents)
        t5 = torch.cat(self.t5_features)
        clip = torch.cat(self.clip_features)
        n_aug = self.num_augmentations
        while True:
            x_indices = self.rng.permutation(len(self.latents))
            c_indices = x_indices // n_aug
            for i in range(0, len(self.latents), batch_size):
                x_i = torch.as_tensor(x_indices[i : i + batch_size], device=xs.device)
                c_i = torch.as_tensor(c_indices[i : i + batch_size], device=xs.device)
                yield xs[x_i], t5[c_i], clip[c_i]
