"""Small seeded images for checking the image path where no dataset is at
hand (``chip_smoke.py`` phase 13, ``tests/test_torch_decoder.py``).

``fixtures/`` holds JPEGs of several shapes (landscape, portrait, square,
grayscale; downscaled and upscaled to 448) and one PNG, written by
:func:`write_fixtures` with PIL from ``default_rng(seed)``, and
``fixtures/sha256.json``: the SHA-256 of PIL's 448 preprocess of each
(``models/convnets.preprocess_image_uint8`` after ``convert("RGB")``), the
bytes any decoder of this package must reproduce.  Regenerate with::

    python -m vqa_counterexamples_tpu_torch.data.image_fixtures
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures")
DIGESTS = "sha256.json"
SIZE = 448
# (name, height, width, mode): JPEG quality 90, the PNG lossless
SHAPES = (("land_240x320.jpg", 240, 320, "RGB"),
          ("port_336x224.jpg", 336, 224, "RGB"),
          ("square_200.jpg", 200, 200, "RGB"),
          ("wide_180x500.jpg", 180, 500, "RGB"),
          ("gray_260x300.jpg", 260, 300, "L"),
          ("big_480x640.jpg", 480, 640, "RGB"),
          ("image_120x96.png", 120, 96, "RGB"))


def _pixels(h: int, w: int, mode: str, rng) -> np.ndarray:
    """A smooth gradient with mild noise (compresses to a few KB)."""
    x = (np.linspace(0, 255, w)[None, :] + np.linspace(0, 100, h)[:, None]
         + rng.normal(0, 6, (h, w)))
    g = x.clip(0, 255).astype(np.uint8)
    if mode == "L":
        return g
    return np.stack([g, np.roll(g, w // 5, axis=1), 255 - g], axis=-1)


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def pil_digests(directory: str = FIXTURE_DIR, size: int = SIZE) -> dict:
    """{name: SHA-256 of PIL's ``size`` preprocess} of every fixture."""
    from .native_decoder import pil_decode

    return {name: digest(pil_decode(os.path.join(directory, name), size))
            for name, *_ in SHAPES}


def write_fixtures(directory: str = FIXTURE_DIR, seed: int = 0) -> dict:
    """Write the images and their digests; returns the digests."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    for name, h, w, mode in SHAPES:
        img = Image.fromarray(_pixels(h, w, mode, rng), mode)
        path = os.path.join(directory, name)
        if name.endswith(".png"):
            img.save(path, "PNG")
        else:
            img.save(path, "JPEG", quality=90)
    digests = pil_digests(directory)
    with open(os.path.join(directory, DIGESTS), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    return digests


def load_digests(directory: str = FIXTURE_DIR) -> dict:
    with open(os.path.join(directory, DIGESTS)) as f:
        return json.load(f)


def fixture_paths(directory: str = FIXTURE_DIR) -> list:
    return [os.path.join(directory, name) for name, *_ in SHAPES]


if __name__ == "__main__":
    print(json.dumps(write_fixtures(), indent=1))
