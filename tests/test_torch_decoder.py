"""The port's native image decoder (``vqa_counterexamples_tpu_torch/native/
image_decoder.cpp``, bound by ``data/native_decoder.py``) against the JAX
package's ``NativeImageDecoder`` and against the PIL path, byte for byte:
the cases of ``tests/test_native_decoder.py``, plus the committed image
fixtures against their recorded digests, the PIL fallback of the batch
helpers, the build's key and the no-library error.  Tolerance: none (the
outputs are uint8 and must be equal)."""

import io

import numpy as np
import pytest

from vqa_counterexamples_tpu.data.native_decoder import (
    NativeImageDecoder as JaxDecoder)
from vqa_counterexamples_tpu.models.convnets import (
    preprocess_image_uint8 as jax_preprocess_uint8)
from vqa_counterexamples_tpu_torch.data import image_fixtures
from vqa_counterexamples_tpu_torch.data import native_decoder as nd


@pytest.fixture(scope="module")
def decoder():
    dec = nd.NativeImageDecoder(n_threads=2)
    if not dec.available:
        pytest.skip("native decoder unavailable (no g++/libjpeg)")
    return dec


@pytest.fixture(scope="module")
def jax_decoder():
    dec = JaxDecoder(n_threads=2)
    if not dec.available:
        pytest.skip("the JAX package's native decoder is unavailable")
    return dec


def _jpeg_bytes(arr, mode=None, quality=92):
    from PIL import Image

    img = Image.fromarray(arr, mode=mode)
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def _pil_reference(raw, size):
    """The JAX package's PIL path."""
    from PIL import Image

    return jax_preprocess_uint8(Image.open(io.BytesIO(raw)).convert("RGB"),
                                size)


def _smooth_rgb(h, w, seed):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, w)[None, :] + np.linspace(0, 100, h)[:, None]
    g = (x + rng.normal(0, 20, (h, w))).clip(0, 255).astype(np.uint8)
    return np.stack([g, np.roll(g, 7, axis=1), 255 - g], axis=-1)


def _three_ways(decoder, jax_decoder, raws, size):
    """The port's native batch, JAX's native batch and the port's PIL
    path must all equal JAX's PIL path."""
    out, ok = decoder.decode_buffers(raws, size=size)
    jout, jok = jax_decoder.decode_buffers(raws, size=size)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(out, jout)
    for i, raw in enumerate(raws):
        ref = _pil_reference(raw, size)
        np.testing.assert_array_equal(nd.pil_decode(raw, size), ref)
        if ok[i]:
            np.testing.assert_array_equal(out[i], ref)
    return out, ok


@pytest.mark.parametrize("shape", [(480, 640), (640, 480), (448, 448),
                                   (200, 300), (500, 500), (683, 1024)])
def test_byte_exact_vs_jax_and_pil(decoder, jax_decoder, shape):
    h, w = shape
    out, ok = _three_ways(decoder, jax_decoder,
                          [_jpeg_bytes(_smooth_rgb(h, w, h * w))], 448)
    assert bool(ok[0])


def test_grayscale_jpeg(decoder, jax_decoder):
    rng = np.random.default_rng(3)
    raw = _jpeg_bytes(rng.integers(0, 255, (500, 700), dtype=np.uint8),
                      mode="L")
    out, ok = _three_ways(decoder, jax_decoder, [raw], 448)
    assert bool(ok[0])
    assert (out[0][..., 0] == out[0][..., 1]).all()


def test_small_size_and_batch(decoder, jax_decoder):
    raws = [_jpeg_bytes(_smooth_rgb(80, 70, i)) for i in range(5)]
    out, ok = _three_ways(decoder, jax_decoder, raws, 64)
    assert ok.all() and out.shape == (5, 64, 64, 3)


def _bad_batch():
    from PIL import Image

    png = io.BytesIO()
    Image.fromarray(_smooth_rgb(100, 100, 0)).save(png, "PNG")
    good = _jpeg_bytes(_smooth_rgb(480, 640, 1))
    return [good, b"not a jpeg", png.getvalue(), b""]


def test_bad_items_flagged_not_fatal(decoder, jax_decoder):
    raws = _bad_batch()
    out, ok = decoder.decode_buffers(raws, size=64)
    jout, jok = jax_decoder.decode_buffers(raws, size=64)
    assert ok.tolist() == jok.tolist() == [True, False, False, False]
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out[0], _pil_reference(raws[0], 64))
    assert (out[1:] == 0).all()


def test_batch_helper_falls_back_to_pil(decoder):
    """``decode_buffers``: the PNG row through PIL, the JPEG natively;
    an undecodable item raises (PIL's error) instead of a zero row."""
    raws = _bad_batch()
    good = nd.decode_buffers(decoder, [raws[0], raws[2]], 64)
    np.testing.assert_array_equal(good[0], _pil_reference(raws[0], 64))
    np.testing.assert_array_equal(good[1], _pil_reference(raws[2], 64))
    with pytest.raises(Exception):
        nd.decode_buffers(decoder, [raws[1]], 64)


def test_decode_files(decoder, jax_decoder, tmp_path):
    raw = _jpeg_bytes(_smooth_rgb(480, 640, 9))
    p = tmp_path / "img.jpg"
    p.write_bytes(raw)
    paths = [str(p), str(tmp_path / "missing.jpg")]
    out, ok = decoder.decode_files(paths, size=64)
    jout, jok = jax_decoder.decode_files(paths, size=64)
    assert ok.tolist() == jok.tolist() == [True, False]
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out[0], _pil_reference(raw, 64))


def test_truncated_jpeg_rejected(decoder, jax_decoder):
    raw = _jpeg_bytes(_smooth_rgb(480, 640, 21))
    out, ok = decoder.decode_buffers([raw[: len(raw) // 2]], size=64)
    _, jok = jax_decoder.decode_buffers([raw[: len(raw) // 2]], size=64)
    assert not ok[0] and not jok[0]


@pytest.mark.parametrize("route", ["native", "pil"])
def test_fixtures_match_recorded_digests(decoder, route):
    """The committed fixtures decode to the SHA-256 recorded beside them,
    through the native library (the PNG through PIL) or PIL alone."""
    want = image_fixtures.load_digests()
    paths = image_fixtures.fixture_paths()
    out = nd.decode_files(decoder if route == "native" else None, paths,
                          image_fixtures.SIZE)
    got = {name: image_fixtures.digest(o)
           for (name, *_), o in zip(image_fixtures.SHAPES, out)}
    assert got == want
    assert image_fixtures.pil_digests() == want


def test_fixtures_are_small_and_regenerate(tmp_path):
    """Under 200 KB together; :func:`write_fixtures` with the seed gives
    images whose PIL preprocess has the recorded digests."""
    import os

    total = sum(os.path.getsize(p) for p in image_fixtures.fixture_paths())
    assert total < 200 * 1024
    assert image_fixtures.write_fixtures(str(tmp_path)) == \
        image_fixtures.load_digests()


def test_unavailable_decoder_degrades():
    """With the library missing the class reports unavailable and returns
    all-False masks, as JAX's does."""
    dec = nd.NativeImageDecoder(build=False)
    dec._lib = None
    out, ok = dec.decode_buffers([b"xx"], size=32)
    assert not ok.any() and out.shape == (1, 32, 32, 3)
    out, ok = dec.decode_files(["/nonexistent.jpg"], size=32)
    assert not ok.any() and out.shape == (1, 32, 32, 3)


def test_no_library_and_no_pil_raises(monkeypatch, tmp_path):
    """A failed build with PIL present prints and returns None (PIL
    decodes); with PIL absent too it raises, naming both."""
    monkeypatch.setattr(nd, "_LIB", None)
    monkeypatch.setattr(nd, "_LIB_FAILED", False)
    monkeypatch.setattr(nd, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert nd.load_library() is None
    assert nd._LIB_FAILED
    monkeypatch.setattr(nd, "_have_pil", lambda: False)
    with pytest.raises(RuntimeError, match="(?s)native decoder.*PIL"):
        nd.load_library()
    with pytest.raises(RuntimeError, match="PIL does not import"):
        nd.NativeImageDecoder()


def test_build_key_follows_source_and_flags(monkeypatch):
    """The library's name carries the hash of the source and the flags;
    no ``-march=native`` (the build and run hosts may differ)."""
    base = nd.library_path()
    assert base.parent == nd.BUILD_DIR and base.name.startswith(
        "libimage_decoder_")
    assert "-march=native" not in nd.CXX_FLAGS
    monkeypatch.setattr(nd, "CXX_FLAGS", nd.CXX_FLAGS + ("-g",))
    assert nd.library_path() != base
