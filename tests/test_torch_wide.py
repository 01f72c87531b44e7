"""PyTorch port, K1's wide envelope: networks wider than 256 or deeper than
16, up to width and v_width 512 and depth 32, which the forward kernel K1
serves through its wide pair (``csrc/fused_mlp_wide_tc.cu``,
``csrc/fused_mlp_wide_f32.cu``) and the backward K2 through its own
(tests/test_torch_wide_bwd.py); and ``--impl int8``, which the int8
kernels serve within the same envelope (tests/test_torch_wide_int8.py)
and which renders the plain int8 MLP beyond it.

On the CPU the wrappers run the plain versions: the port's plain K1 at the
wide architectures against the JAX Pallas kernel (interpret mode, as
tests/test_fused_mlp.py runs it), ``chip_smoke.widen_nerf`` (phase 29's
widened lego) against the lego function, and a tiny frame of the widened
lego through the CLI against JAX's frame of the lego itself. The kernels
are held to the same plain versions on the card (``chip_smoke.py`` phase
29, ``tests/test_torch_cuda.py``)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.config import ArchConfig as JaxArchConfig
from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.io.golden import camera_from_golden as jax_camera_from_golden
from nerf_rs_tpu.io.golden import load_golden as jax_load_golden
from nerf_rs_tpu.models.mlp import init_nerf_params as jax_init_nerf_params
from nerf_rs_tpu.models.mlp import nerf_mlp as jax_nerf_mlp
from nerf_rs_tpu.ops.kernels.fused_mlp import fused_nerf_mlp as jax_fused_nerf_mlp
from nerf_rs_tpu.ops.kernels.fused_mlp import supports_arch as jax_supports_arch
from nerf_rs_tpu.render import render_image as jax_render_image
from nerf_rs_tpu_torch.cli import main as cli_main
from nerf_rs_tpu_torch.config import ArchConfig
from nerf_rs_tpu_torch.io.image import load_ppm
from nerf_rs_tpu_torch.io.weights import load_nerf_params, params_to_torch
from nerf_rs_tpu_torch.models.mlp import NerfMLP, nerf_mlp
from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
    fused_nerf_mlp,
    fused_nerf_mlp_reference,
    pack_params,
    supports_arch,
    supports_backward_arch,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LEGO = ROOT / "assets" / "lego_rust"
# (width, v_width, depth, skip_at): phase 29's random networks.
WIDE = [(384, 192, 8, 4), (512, 256, 8, 4), (512, 256, 20, 4)]
WIDE_IDS = ["384x192x8", "512x256x8", "512x256x20"]


def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    return cs


def jax_params(arch, seed):
    """JAX's ``init_nerf_params`` kernels (Glorot-uniform), with biases
    drawn from numpy (JAX's init leaves them zero), as numpy arrays."""
    tree = jax_init_nerf_params(jax.random.key(seed), arch=JaxArchConfig(*arch))
    rng = np.random.default_rng(seed)
    return {layer: {"kernel": np.asarray(p["kernel"], np.float32),
                    "bias": rng.normal(0.0, 0.1, p["bias"].shape).astype(np.float32)}
            for layer, p in tree.items()}


def np_inputs(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


@pytest.fixture(scope="module", params=WIDE, ids=WIDE_IDS)
def wide(request):
    return request.param, jax_params(request.param, sum(request.param))


@pytest.mark.parametrize("n", [128, 200])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_reference_matches_jax_fused_wide_f32(wide, sigma_only, n):
    """The plain K1 at the wide architectures against the JAX kernel, f32:
    test_reference_matches_jax_fused_f32's bars; n=200 is ragged."""
    arch, params = wide
    assert jax_supports_arch(params)
    pts, dirs = np_inputs(n, 1)
    rgb_j, sig_j = jax_fused_nerf_mlp(jax.tree_util.tree_map(jnp.asarray, params),
                                      jnp.asarray(pts), jnp.asarray(dirs), sigma_only=sigma_only)
    rgb, sig = fused_nerf_mlp_reference(params_to_torch(params, "cpu"), torch.from_numpy(pts),
                                        torch.from_numpy(dirs), sigma_only=sigma_only)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=1e-4, rtol=1e-5)
    if sigma_only:
        assert not rgb.any()


@pytest.mark.parametrize("n", [128, 200])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_reference_bf16_close_to_jax_fused_wide(wide, sigma_only, n):
    """bf16: test_reference_bf16_close_to_jax_fused's bars for two bf16
    orderings."""
    _, params = wide
    pts, dirs = np_inputs(n, 2)
    rgb_j, sig_j = jax_fused_nerf_mlp(jax.tree_util.tree_map(jnp.asarray, params),
                                      jnp.asarray(pts), jnp.asarray(dirs), dtype="bfloat16",
                                      sigma_only=sigma_only)
    rgb, sig = fused_nerf_mlp_reference(params_to_torch(params, "cpu"), torch.from_numpy(pts),
                                        torch.from_numpy(dirs), dtype="bfloat16",
                                        sigma_only=sigma_only)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=2e-2)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", [(512, 256, 8), (384, 192, 8), (512, 256, 20)],
                         ids=["512x256x8", "384x192x8", "512x256x20"])
@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_widened_lego_computes_the_lego_function(arch, net):
    """``chip_smoke.widen_nerf`` (phase 29's networks): the widened and
    deepened lego through the port's plain K1 against JAX's ``nerf_mlp`` of
    the lego itself, f32. Only the order of the sums differs: rgb within
    1e-5; sigma within 1e-4 + 1e-5 |sigma| (it reaches 770, where one f32
    ulp is 6e-5)."""
    cs = chip_smoke()
    lego = load_nerf_params(LEGO / net)
    tree = cs.widen_nerf(lego, *arch, seed=3)
    assert fm.infer_arch(tree) == (*arch, 4) and supports_arch(tree)
    pts, dirs = np_inputs(256, 5)
    pts *= np.float32(0.4)                          # inside the scene, where sigma is large
    rgb_j, sig_j = jax_nerf_mlp(jax.tree_util.tree_map(jnp.asarray, lego), jnp.asarray(pts),
                                jnp.asarray(dirs))
    rgb, sig = fused_nerf_mlp(NerfMLP(tree), torch.from_numpy(pts), torch.from_numpy(dirs))
    assert float(sig.max()) > 10.0
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=1e-4, rtol=1e-5)


def test_widen_nerf_places_copies_by_permutation():
    """Every unit kept, the extra ones copied once, placed by a seeded
    permutation (not appended), the copies' outgoing rows halved; more
    than quadrupling a layer (1152 from 256), or a unit 3 times (1023), is
    refused."""
    cs = chip_smoke()
    lego = load_nerf_params(LEGO / "fine")
    k0 = np.asarray(lego["dense0"]["kernel"])
    for width in (384, 512):
        tree = cs.widen_nerf(lego, width, 192, seed=7)
        cols = tree["dense0"]["kernel"]
        # Each widened column is some lego column; every lego column is there.
        src = [int(np.flatnonzero((k0 == cols[:, [j]]).all(0))[0]) for j in range(width)]
        counts = np.bincount(src, minlength=256)
        assert counts.min() >= 1 and counts.max() <= 2 and counts.sum() == width
        assert src[:256] != list(range(256))
        # Each column of the next layer is a lego column fed by those
        # units, a copied unit's rows halved.
        rows = tree["dense1"]["kernel"]
        want = np.asarray(lego["dense1"]["kernel"])[src] / counts[src][:, None]
        for j in range(width):
            assert (want == rows[:, [j]]).all(0).any(), j
    for width in (1152, 1023):
        with pytest.raises(ValueError, match="cannot widen"):
            cs.widen_nerf(lego, width, 128)


@pytest.mark.parametrize("arch", [(512, 256, 8), (512, 256, 20)], ids=["512x256x8", "512x256x20"])
def test_cli_render_widened_lego_matches_jax_lego_frame(arch, tmp_path, capsys):
    """``render --weights <widened lego> --impl pallas --device cpu``: no
    note (K1 serves it), and the frame of the lego itself as JAX renders
    it, within one 8-bit level."""
    cs = chip_smoke()
    d = cs.write_wide_lego(tmp_path, LEGO, *arch)
    out = tmp_path / "w.ppm"
    assert cli_main(["render", "--device", "cpu", "--weights", str(d), "--impl", "pallas",
                     "--width", "8", "--height", "6", "--coarse-samples", "4",
                     "--fine-samples", "4", "--ray-chunk", "16", "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert "outside the fused kernels' range" not in text and "(pallas/float32" in text
    from nerf_rs_tpu.io.weights import load_nerf_params as jax_load_nerf_params

    coarse, fine = (jax_load_nerf_params(LEGO / n) for n in ("coarse", "fine"))
    cam = jax_camera_from_golden(jax_load_golden(LEGO / "tf_reference_samples.json"))
    want = jax_render_image(coarse, fine, cam, 6, 8, jax.random.key(0),
                            JaxRenderConfig(n_coarse=4, n_fine=4, ray_chunk=16, impl="xla"))
    got = load_ppm(out)
    assert np.abs(got - np.clip(np.asarray(want, np.float32), 0, 1)).max() <= 1.0 / 255 + 1e-6


@pytest.mark.parametrize("dims, forward, backward", [
    ((256, 128, 8), True, True), ((384, 128, 8), True, True), ((512, 512, 8), True, True),
    ((256, 128, 32), True, True), ((576, 128, 8), True, True), ((640, 128, 8), True, True),
    ((256, 640, 8), True, True), ((256, 128, 33), False, False),
    ((1152, 128, 8), False, False)])
def test_envelopes(dims, forward, backward):
    """K1's envelope (width, v_width <= 1024, depth <= 32), which is K2's;
    the JAX kernel takes every one of these trunk widths that is a
    multiple of 128."""
    assert fm.supports_dims(*dims) == forward
    assert fm.supports_backward_dims(*dims) == backward
    width, v_width, depth = dims
    tree = params_to_torch(jax_params((width, v_width, min(depth, 3), 0), 1), "cpu")
    assert supports_arch(tree) == fm.supports_dims(width, v_width, min(depth, 3))
    assert supports_backward_arch(tree) == fm.supports_backward_dims(width, v_width, min(depth, 3))
    if width % 128 == 0:
        assert jax_supports_arch(jax_params((width, v_width, 3, 0), 1))
    if not fm.supports_dims(width, v_width, min(depth, 3)):
        with pytest.raises(ValueError, match=f"width={width}"):
            pack_params(tree, "float32")


def test_pack_params_rejects_depth_past_32():
    tree = params_to_torch(jax_params((64, 32, 33, 4), 2), "cpu")
    with pytest.raises(ValueError, match="depth=33"):
        pack_params(tree, "bfloat16")


def test_wide_grads_on_cpu_run_the_plain_versions():
    """Gradients at width 384 on CPU tensors: the plain forward and
    backward (the wide K2 runs on the card), equal to autograd through
    ``models.mlp.nerf_mlp``."""
    params = jax_params((384, 192, 3, 1), 4)
    net = NerfMLP(params, requires_grad=True)
    ref = {k: v.detach().clone().requires_grad_(True) for k, v in net.weights.items()}
    pts, dirs = (torch.from_numpy(a) for a in np_inputs(64, 6))
    rgb, sig = fused_nerf_mlp(net, pts, dirs)
    (rgb.sum() + 1e-2 * sig.sum()).backward()
    tree = {layer: {"kernel": ref[f"{layer}_kernel"], "bias": ref[f"{layer}_bias"]}
            for layer in params}
    rgb_p, sig_p = nerf_mlp(tree, pts, dirs)
    (rgb_p.sum() + 1e-2 * sig_p.sum()).backward()
    for name, w in net.weights.items():
        np.testing.assert_allclose(w.grad.numpy(), ref[name].grad.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_int8_route_picks_the_plain_function_beyond_the_kernel_on_the_card():
    """``render.get_mlp_fn`` for one network: ``impl="int8"`` on a card
    device within the int8 kernels' envelope (512, 32: K1's) resolves to
    the kernels' wrapper, for a network the narrow kernel serves (256/128/3)
    and for those only the wide one serves (300/72/18 and 512/256/20, and
    512/512/32 at the envelope's edge); beyond it (width 640) up front to
    ``models.quant.int8_nerf_mlp(fake=False)``, the same real-int8
    arithmetic without a kernel. On the CPU it is always the wrapper, which
    keeps refusing what the kernels do not serve (its pack raises)."""
    from nerf_rs_tpu_torch.config import RenderConfig
    from nerf_rs_tpu_torch.models.quant import int8_nerf_mlp
    from nerf_rs_tpu_torch.ops.kernels import int8_mlp
    from nerf_rs_tpu_torch.render import get_mlp_fn

    cfg = RenderConfig(impl="int8", dtype="bfloat16")
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    for arch in ((256, 128, 3, 1), (300, 72, 18, 4), (512, 256, 20, 4), (512, 512, 32, 10)):
        net = NerfMLP(jax_params(arch, 8))
        assert int8_mlp.supports_arch(net), arch
        assert get_mlp_fn(cfg, net, card).func is int8_mlp.fused_int8_mlp, arch
    assert (int8_mlp.INT8_MAX_WIDTH, int8_mlp.INT8_MAX_DEPTH) == (512, 32)
    wider = NerfMLP(jax_params((640, 128, 3, 1), 8))
    fn = get_mlp_fn(cfg, wider, card)
    assert fn.func is int8_nerf_mlp and fn.keywords["fake"] is False
    assert get_mlp_fn(cfg, wider, cpu).func is int8_mlp.fused_int8_mlp
    assert get_mlp_fn(cfg).func is int8_mlp.fused_int8_mlp
    assert get_mlp_fn(RenderConfig(impl="pallas"), wider, card).func is fused_nerf_mlp
    assert not int8_mlp.supports_arch(wider)
    with pytest.raises(ValueError, match="width=640"):
        int8_mlp.pack_int8_params(wider.tree())
    pts, dirs = (torch.from_numpy(a) for a in np_inputs(64, 9))
    got = fn(wider, pts, dirs)
    want = int8_mlp.fused_int8_mlp(wider, pts, dirs)      # on the CPU: the plain version
    assert all(torch.equal(a, b) for a, b in zip(got, want))
