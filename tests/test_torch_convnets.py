"""The port's ResNet trunk (``vqa_counterexamples_tpu_torch/models/
convnets.py``) against the JAX package's, on the same inputs and the same
weights (carried by ``models/from_jax.resnet_from_jax``, or drawn by both
``init_resnet``s from one seed).

Tolerances, as a share of the reference's largest entry: f32 1e-4 (the
same convolutions summed in another order); bf16 5e-2 (both trunks round
every activation to bf16, in other places: XLA fuses the BN multiply-add
and the residual add; the repo's bf16 bound).  The preprocessing and the
init draws are exact."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_counterexamples_tpu.models import convnets as jax_convnets
from vqa_counterexamples_tpu_torch.models import convnets, from_jax

TINY = (1, 1, 1, 1)
F32_REL = 1e-4
BF16_REL = 5e-2


def _rel_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _jax_params(depths, seed=0):
    model = jax_convnets.ResNet(depths=depths)
    return jax.tree_util.tree_map(
        np.asarray, jax_convnets.init_resnet(model, 64, seed=seed))


def _images(n=2, size=64, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("depths", [TINY, jax_convnets.RESNET_DEPTHS[50]],
                         ids=["tiny", "resnet50"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunk_matches_jax(depths, dtype):
    params = _jax_params(depths, seed=1)
    jm = jax_convnets.ResNet(depths=depths, dtype=getattr(jnp, dtype))
    x = _images()
    ref = np.asarray(jm.apply({"params": params}, x))
    pm = convnets.ResNet(depths=depths, dtype=getattr(torch, dtype))
    pm.load_state_dict(from_jax.resnet_from_jax(params))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 2, 2, 2048)
    assert got.dtype == np.float32
    assert _rel_err(got, ref) < (F32_REL if dtype == "float32"
                                 else BF16_REL)


@pytest.mark.parametrize("size", [64, 256], ids=["map2", "map8"])
def test_pooling_divides_by_h_plus_w(size):
    """``pooling=True``: the 7x7/1 average pool when the map is at least
    7x7 (256 -> 8x8 -> 2x2), then the sum over the map / (H + W), as JAX
    (and the reference) do; at 64 (a 2x2 map) no average pool."""
    params = _jax_params(TINY)
    jm = jax_convnets.ResNet(depths=TINY, pooling=True, dtype=jnp.float32)
    x = _images(size=size, seed=2)
    ref = np.asarray(jm.apply({"params": params}, x))
    pm = convnets.ResNet(depths=TINY, pooling=True, dtype=torch.float32)
    pm.load_state_dict(from_jax.resnet_from_jax(params))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    assert _rel_err(got, ref) < F32_REL
    # the quirk itself: the map's sum over (H + W), not its mean
    pm.pooling = False
    with torch.no_grad():
        fmap = pm(torch.from_numpy(x))
    if size == 64:
        np.testing.assert_allclose(got, fmap.sum((1, 2)).numpy() / 4,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("depths", [TINY, jax_convnets.RESNET_DEPTHS[152]],
                         ids=["tiny", "resnet152"])
def test_init_resnet_draws_equal_jax(depths):
    """The seeded init draws the JAX trunk's values in its leaf order."""
    want = from_jax.resnet_from_jax(_jax_params(depths, seed=5))
    pm = convnets.init_resnet(convnets.ResNet(depths=depths), seed=5)
    got = pm.state_dict()
    assert set(got) == set(want)
    for name, tensor in got.items():
        assert torch.equal(tensor, want[name]), name


def _fabricated_state_dict(depths, seed=0):
    """A torchvision-named state dict: random conv weights and BN
    statistics, plus ``fc.*`` and ``num_batches_tracked`` entries."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in convnets.ResNet(depths=depths).state_dict().items():
        if name.endswith("running_var"):
            sd[name] = torch.rand(t.shape, generator=gen) + 0.5
        elif name.endswith(".weight") and t.dim() == 4:
            fan_in = t[0].numel()
            sd[name] = torch.randn(t.shape, generator=gen) / fan_in ** 0.5
        else:
            sd[name] = 0.1 * torch.randn(t.shape, generator=gen) + (
                1.0 if name.endswith(".weight") else 0.0)
        if name.endswith("running_var"):
            sd[name[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    sd["fc.weight"] = torch.randn(1000, 2048, generator=gen)
    sd["fc.bias"] = torch.randn(1000, generator=gen)
    return sd


def test_reference_state_dict_through_both_loaders(tmp_path):
    sd = _fabricated_state_dict(TINY)
    path = str(tmp_path / "resnet.pth")
    torch.save(sd, path)
    params = jax_convnets.load_torch_resnet152(_jax_params(TINY), path)
    params = jax.tree_util.tree_map(np.asarray, params)
    pm = convnets.ResNet(depths=TINY, dtype=torch.float32)
    convnets.load_torch_resnet152(pm, path)
    carried = from_jax.resnet_from_jax(params)
    for name, tensor in pm.state_dict().items():
        assert torch.equal(tensor, carried[name]), name
        assert torch.equal(tensor, sd[name]), name
    jm = jax_convnets.ResNet(depths=TINY, dtype=jnp.float32)
    x = _images(seed=3)
    ref = np.asarray(jm.apply({"params": params}, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert _rel_err(got, ref) < F32_REL


def test_loader_raises_on_missing_keys(tmp_path):
    sd = _fabricated_state_dict(TINY)
    del sd["layer2.0.downsample.1.running_mean"]
    path = str(tmp_path / "broken.pth")
    torch.save(sd, path)
    with pytest.raises((KeyError, ValueError)):
        jax_convnets.load_torch_resnet152(_jax_params(TINY), path)
    with pytest.raises(ValueError, match="missing"):
        convnets.load_torch_resnet152(convnets.ResNet(depths=TINY), path)


def test_factory_names():
    for arch, depth in (("fbresnet152", 152), ("fbresnet152torch", 152),
                        ("resnet101", 101), ("resnet50", 50)):
        model = convnets.factory({"arch": arch})
        assert model.depths == jax_convnets.factory({"arch": arch}).depths \
            == convnets.RESNET_DEPTHS[depth]
        assert model.dtype == torch.bfloat16 and not model.pooling
    assert convnets.factory({"arch": "resnet50", "pooling": True}).pooling
    with pytest.raises(ValueError):
        convnets.factory({"arch": "vgg16"})


def _pil_image(h=500, w=400, seed=3, mode="RGB"):
    from PIL import Image

    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    return Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8), mode)


@pytest.mark.parametrize("h,w,mode", [(500, 400, "RGB"), (300, 640, "RGB"),
                                      (200, 200, "L")])
def test_preprocess_equals_jax(h, w, mode):
    img = _pil_image(h, w, mode=mode)
    got = convnets.preprocess_image_uint8(img, size=64)
    np.testing.assert_array_equal(
        got, jax_convnets.preprocess_image_uint8(img, size=64))
    assert got.shape == (64, 64, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(convnets.preprocess_image(img, size=64),
                                  jax_convnets.preprocess_image(img, size=64))


def test_normalize_images_device_matches_jax_and_host():
    """The device half of the transform equals JAX's (same f32 ops) and
    reproduces the one-shot host transform (JAX's bound, atol 1e-6)."""
    img = _pil_image()
    u8 = convnets.preprocess_image_uint8(img, size=64)
    got = convnets.normalize_images_device(torch.from_numpy(u8)).numpy()
    ref = np.asarray(jax_convnets.normalize_images_device(jnp.asarray(u8)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, convnets.preprocess_image(img, size=64),
                               atol=1e-6)
    assert got.dtype == np.float32


def test_jpeg_roundtrip_through_trunk_is_finite():
    """A JPEG through PIL's preprocess, the device normalize and the bf16
    trunk: finite maps of the expected shape."""
    from PIL import Image

    buf = io.BytesIO()
    _pil_image().save(buf, "JPEG")
    with Image.open(io.BytesIO(buf.getvalue())) as img:
        u8 = convnets.preprocess_image_uint8(img.convert("RGB"), 64)
    pm = convnets.init_resnet(convnets.ResNet(depths=TINY))
    with torch.no_grad():
        out = pm(convnets.normalize_images_device(
            torch.from_numpy(u8[None])))
    assert out.shape == (1, 2, 2, 2048) and torch.isfinite(out).all()
