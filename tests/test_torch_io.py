"""PyTorch port, IO: weights, golden camera and image bytes against the JAX
package's loaders and writers."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_rs_tpu.io import golden as jax_golden
from nerf_rs_tpu.io import image as jax_image
from nerf_rs_tpu.io import weights as jax_weights
from nerf_rs_tpu_torch.io import golden, image, weights

torch.set_num_threads(1)

ASSETS = Path(__file__).resolve().parents[1] / "assets"
BUNDLES = ["lego_rust", "trained/student128_30db", "trained/student128_sp29",
           "trained/teacher256_31db", "trained/teacher_sp30"]


@pytest.mark.parametrize("bundle", BUNDLES)
def test_weights_equal_jax_loader(bundle):
    """Same arrays, bit for bit, through the numpy loader and the weight
    bridge to tensors."""
    for net in ("coarse", "fine"):
        d = ASSETS / bundle / net
        want = jax_weights.load_nerf_params(d, device_put=False)
        got = weights.load_nerf_params(d)
        as_torch = weights.params_to_torch(got, "cpu")
        assert list(got) == list(want)
        for layer in want:
            for part in ("kernel", "bias"):
                assert got[layer][part].dtype == np.float32
                np.testing.assert_array_equal(got[layer][part], want[layer][part])
                np.testing.assert_array_equal(as_torch[layer][part].numpy(),
                                              want[layer][part])


def test_unused_parameters_rejected(tmp_path):
    src = ASSETS / "lego_rust" / "coarse"
    shutil.copytree(src, tmp_path / "net")
    np.zeros(4, "<f4").tofile(tmp_path / "net" / "extra_kernel.bin")
    with open(tmp_path / "net" / "shapes.txt", "a") as f:
        f.write("extra_kernel 4\n")
    with pytest.raises(ValueError, match="unused parameters"):
        weights.load_nerf_params(tmp_path / "net")


def test_broken_chain_rejected():
    params = weights.load_nerf_params(ASSETS / "lego_rust" / "coarse")
    params["dense3"]["kernel"] = params["dense3"]["kernel"][:100]
    with pytest.raises(ValueError, match="dense3"):
        weights.validate_param_chain(params)


def test_find_lego_assets_env(tmp_path, monkeypatch):
    monkeypatch.setenv(weights.ASSET_ENV_VAR, str(tmp_path))
    assert weights.find_lego_assets() == ASSETS / "lego_rust"   # env dir lacks weights
    for net in ("coarse", "fine"):
        (tmp_path / net).mkdir()
        (tmp_path / net / "shapes.txt").write_text("")
    assert weights.find_lego_assets() == tmp_path


def test_camera_from_golden_equals_jax():
    g = golden.load_golden(ASSETS / "lego_rust" / "tf_reference_samples.json")
    got = golden.camera_from_golden(g)
    want = jax_golden.camera_from_golden(g)
    for field in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))
    for a, b in zip(golden.golden_examples(g), jax_golden.golden_examples(g)):
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_quantize_and_ppm_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    px = rng.uniform(-0.2, 1.2, size=(7, 5, 3)).astype(np.float32)
    px[0, 0] = [0.5 / 255, 254.5 / 255, 1.0]     # rounding edges
    np.testing.assert_array_equal(image.quantize_u8(px), jax_image.quantize_u8(px))
    np.testing.assert_array_equal(image.quantize_u8(torch.from_numpy(px)),
                                  jax_image.quantize_u8(px))
    image.save_ppm(tmp_path / "port.ppm", torch.from_numpy(px), 7, 5)
    jax_image.save_ppm(tmp_path / "jax.ppm", px, 7, 5)
    assert (tmp_path / "port.ppm").read_bytes() == (tmp_path / "jax.ppm").read_bytes()
    np.testing.assert_array_equal(image.load_ppm(tmp_path / "port.ppm"),
                                  jax_image.load_ppm(tmp_path / "jax.ppm"))
