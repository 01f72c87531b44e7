"""PyTorch port, K1 past width 512: trunk and view widths up to 1024 (depth
up to 32), which the forward kernel K1 serves through its wide1k pair
(``csrc/fused_mlp_wide1k_tc.cu`` in bf16, ``csrc/fused_mlp_wide1k_f32tc.cu``
in f32, whose arithmetic and pack ``tests/test_torch_wide1k_split_f32.py``
holds), and the backward K2 with it (tests/test_torch_wide1k_bwd.py).

On the CPU the wrapper runs the plain version: the port's plain K1 at
1024-wide architectures against the JAX Pallas kernel (interpret mode, as
tests/test_fused_mlp.py runs it) and, where that kernel does not go (776 is
not a multiple of 128; depth 32 costs too much in interpret mode), against
JAX's plain ``nerf_mlp``; the pack at 1024; the envelopes; the bf16
kernel's split of each weight chunk between a cluster's two CTAs, emulated
on the pack; ``chip_smoke.widen_nerf`` at 4x;
and a tiny frame of the lego widened to 1024/512/8 through the CLI against
JAX's frame of the lego. The kernels themselves are held to the same plain
version on the card (``chip_smoke.py`` phase 29 (e),
``tests/test_torch_cuda.py::test_wide_kernel_matches_plain``)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.io.golden import camera_from_golden as jax_camera_from_golden
from nerf_rs_tpu.io.golden import load_golden as jax_load_golden
from nerf_rs_tpu.models.mlp import nerf_mlp as jax_nerf_mlp
from nerf_rs_tpu.ops.kernels.fused_mlp import fused_nerf_mlp as jax_fused_nerf_mlp
from nerf_rs_tpu.ops.kernels.fused_mlp import supports_arch as jax_supports_arch
from nerf_rs_tpu.render import render_image as jax_render_image
from nerf_rs_tpu_torch.cli import main as cli_main
from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig
from nerf_rs_tpu_torch.io.image import load_ppm
from nerf_rs_tpu_torch.io.weights import load_nerf_params, params_to_torch
from nerf_rs_tpu_torch.models.mlp import NerfMLP, arch_shapes
from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
    fused_nerf_mlp,
    fused_nerf_mlp_backward,
    fused_nerf_mlp_reference,
    pack_params,
    tc_tile,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LEGO = ROOT / "assets" / "lego_rust"
NOTE = "outside the fused kernels' range"
# (width, v_width, depth, skip_at) that JAX's kernel takes: mip-NeRF 360's
# trunk width with its view width and with the NeRF view width, and a trunk
# that splits 12 pieces of 64 unevenly between two CTAs with a view width
# that is not a multiple of 64.
KERNEL_ARCHS = [(1024, 512, 8, 4), (1024, 128, 8, 4), (768, 200, 12, 4)]
KERNEL_IDS = ["1024x512x8", "1024x128x8", "768x200x12"]


def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    return cs


def np_params(arch, seed):
    """Glorot-uniform kernels (JAX's ``init_nerf_params`` scheme) and small
    random biases, from numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(ArchConfig(*arch)).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        out[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    return out


def np_inputs(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


@pytest.fixture(scope="module", params=KERNEL_ARCHS, ids=KERNEL_IDS)
def wide1k(request):
    return request.param, np_params(request.param, sum(request.param))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_reference_matches_jax_fused_wide1k(wide1k, sigma_only, dtype):
    """The plain K1 past width 512 against the JAX kernel on 64 samples,
    tests/test_torch_wide.py's bars: f32 rgb within 1e-5, sigma within
    1e-4 + 1e-5 |sigma|; bf16 within 2e-2 (two bf16 orderings)."""
    arch, params = wide1k
    assert jax_supports_arch(params) and fm.supports_arch(params)
    pts, dirs = np_inputs(64, 11)
    rgb_j, sig_j = jax_fused_nerf_mlp(jax.tree_util.tree_map(jnp.asarray, params),
                                      jnp.asarray(pts), jnp.asarray(dirs), dtype=dtype,
                                      sigma_only=sigma_only)
    net = NerfMLP(params)
    assert net.packed(dtype).wide1k
    rgb, sig = fused_nerf_mlp_reference(net, torch.from_numpy(pts), torch.from_numpy(dirs),
                                        dtype=dtype, sigma_only=sigma_only)
    if dtype == "float32":
        np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5)
        np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=1e-4, rtol=1e-5)
    else:
        np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=2e-2)
        np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=2e-2, rtol=2e-2)
    if sigma_only:
        assert not rgb.any()


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("arch", [(776, 264, 12, 4), (1024, 1024, 32, 10)],
                         ids=["776x264x12", "1024x1024x32"])
def test_reference_matches_jax_plain_mlp_wide1k(arch, sigma_only):
    """Where JAX's kernel does not go (776 is not a multiple of 128), or
    would take too long in interpret mode (depth 32): the plain K1 in f32
    against JAX's ``nerf_mlp``, at the same bars. The sigma head's bias is
    1, so that sigma is not cut to 0 by its ReLU."""
    params = np_params(arch, 7)
    params["alpha"]["bias"][:] = 1.0
    assert not jax_supports_arch(params) or arch[2] == 32
    pts, dirs = np_inputs(48, 12)
    rgb_j, sig_j = jax_nerf_mlp(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(pts),
                                jnp.asarray(dirs), sigma_only=sigma_only)
    rgb, sig = fused_nerf_mlp(NerfMLP(params), torch.from_numpy(pts), torch.from_numpy(dirs),
                              sigma_only=sigma_only)
    assert float(sig.min()) > 0.0
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=1e-4, rtol=1e-5)
    if sigma_only:
        assert not rgb.any()
    else:
        np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5)


def test_pack_at_1024_segments_offsets_and_padding():
    """A 1000/1020/5 network (skip at layer 3): the wide tables of 32
    slots, every segment 8-aligned and in the layout's order, the padding
    zero (encode rows 63 and 27 on, view columns 1020 on), the f32 pack
    with K2's transposed pack and without the narrow split pack, and the
    bf16 tensor-core pack each layer segment's ``tc_tile`` at widths padded
    to 64, with K2's transposed pack of its bf16 weights."""
    params = np_params((1000, 1020, 5, 2), 3)
    tree = params_to_torch(params, "cpu")
    pk = pack_params(tree, "float32")
    assert pk.wide and pk.wide1k and (pk.ldw, pk.ldv) == (1000, 1024)
    assert pk.layout.size == 3 * fm.MAX_DEPTH + 9 and pk.mma_wt is not None
    assert pk.layout_mma.size == 2 * fm.MAX_DEPTH + 3
    assert pk.weights_f32tc is None and pk.weights_tc is None
    names = (["dense0", "dense1", "dense2", "dense3_enc", "dense3", "dense4", "alpha",
              "bottleneck", "viewdirs", "viewdirs_dir", "rgb"])
    assert list(pk.segments) == names
    shapes = {"dense0": (64, 1000), "dense3_enc": (64, 1000), "alpha": (1000, 1),
              "bottleneck": (1000, 1000), "viewdirs": (1000, 1024), "viewdirs_dir": (32, 1024),
              "rgb": (1024, 3)}
    end = 0
    for name in names:
        off, k, ld = pk.segments[name]
        assert off % 8 == 0 and off >= end, name
        assert (k, ld) == shapes.get(name, (1000, 1000)), name
        end = off + k * ld
    assert pk.weights.numel() == -(-end // 8) * 8
    d = sum(1 for k in pk.layout[:fm.MAX_DEPTH] if k >= 0)
    assert d == 5 and (pk.layout[5:fm.MAX_DEPTH] == -1).all()
    assert pk.layout[fm.MAX_DEPTH + 3] == pk.segments["dense3_enc"][0]
    assert (pk.mat("dense0")[63:] == 0).all() and (pk.mat("viewdirs_dir")[27:] == 0).all()
    assert (pk.mat("viewdirs")[:, 1020:] == 0).all() and (pk.mat("rgb")[1020:] == 0).all()
    np.testing.assert_array_equal(pk.mat("dense3_enc")[:63].numpy(),
                                  params["dense3"]["kernel"][:63])
    np.testing.assert_array_equal(pk.mat("viewdirs")[:, :1020].numpy(),
                                  params["viewdirs"]["kernel"][:1000])
    pk16 = pack_params(tree, "bfloat16")
    assert pk16.wide1k and pk16.layout_tc.size == pk.layout.size
    assert pk16.mma_wt is not None and np.array_equal(pk16.layout_mma, pk.layout_mma)
    off = pk16.layout_tc[fm.MAX_DEPTH * 2 + 2]                      # viewdirs
    seg = pk16.weights_tc[off:off + 1024 * 1024].float()
    assert torch.equal(seg, tc_tile(pk16.mat("viewdirs"), 1024, 1024).to(torch.bfloat16).float())


@pytest.mark.parametrize("n", [832, 1024, 320, 128, 64], ids=["832", "1024", "320", "128", "64"])
def test_bf16_kernel_pass_chunks_are_tc_tiles_of_the_pass(n):
    """The wide1k bf16 kernel's producers (csrc/fused_mlp_wide1k_tc.cu,
    PassProducer): CTA r of a cluster takes half r of a segment's 64-column
    pieces (the first half rounded up) in passes of at most 4 pieces, and
    copies each chunk's rows of a pass's columns as one run a k-group of 8
    rows, ``nh * 16`` bytes from element ``(c + 8 g) n + 8 col0`` of the
    segment; the runs laid end to end in the ring stage must be ``tc_tile``
    of that (rows x nh) block, which the consumers' wgmma descriptors read
    with an LBO of ``nh * 16``. The chunk rows fill at most 16 KB; the
    passes of both CTAs cover every column once, and each warpgroup of a
    pass takes at most 2 pieces (``wide::Share``)."""
    k = 96
    m = torch.arange(k * n, dtype=torch.float32).reshape(k, n)
    flat = tc_tile(m, k, n)
    pieces = n // 64
    covered = []
    for rank in (0, 1):
        p0 = (pieces + 1) // 2 if rank else 0
        count = pieces // 2 if rank else (pieces + 1) // 2
        for q0 in range(0, count, 4):
            pc = min(4, count - q0)
            assert max((pc + 1) // 2, pc // 2) <= 2
            nh, col0 = 64 * pc, 64 * (p0 + q0)
            covered += list(range(col0, col0 + nh))
            rows = 32 if nh > 128 else 64
            assert rows * nh * 2 <= 16384
            for c in range(0, k, rows):
                kc = min(rows, k - c)
                runs = [flat[(c + 8 * g) * n + 8 * col0:(c + 8 * g) * n + 8 * col0 + 8 * nh]
                        for g in range(kc // 8)]
                assert torch.equal(torch.cat(runs), tc_tile(m[c:c + kc, col0:col0 + nh], kc, nh))
    assert covered == list(range(n))


@pytest.mark.parametrize("dims, forward, backward", [
    ((512, 512, 32), True, True), ((576, 128, 8), True, True), ((640, 128, 8), True, True),
    ((256, 640, 8), True, True), ((1024, 512, 8), True, True), ((1024, 1024, 32), True, True),
    ((1152, 128, 8), False, False), ((256, 1152, 8), False, False),
    ((1024, 512, 33), False, False), ((256, 128, 33), False, False)])
def test_envelopes_past_512(dims, forward, backward):
    """K1's envelope (width, v_width <= 1024, depth <= 32) is K2's: a
    network inside it packs and its backward is served (the plain version
    on the CPU, in both dtypes); past it the pack raises, and K2's refusal
    names the envelope."""
    assert fm.supports_dims(*dims) == forward
    assert fm.supports_backward_dims(*dims) == backward
    width, v_width, depth = dims
    params = np_params((width, v_width, min(depth, 2), 0), 1)
    net = NerfMLP(params)
    assert fm.supports_arch(net) == fm.supports_dims(width, v_width, min(depth, 2))
    assert fm.supports_backward_arch(net) == fm.supports_backward_dims(width, v_width, min(depth, 2))
    assert (fm._backward_refusal(*dims)
            == f"fused backward K2 serves width, v_width <= 1024 and depth <= 32; got "
               f"width={width}, v_width={v_width}, depth={depth}")
    pts, dirs = (torch.from_numpy(a) for a in np_inputs(8, 2))
    if not fm.supports_dims(width, v_width, min(depth, 2)):
        with pytest.raises(ValueError, match=f"width={width}"):
            pack_params(net.tree(), "float32")
        return
    g = torch.ones(8)
    for dtype in ("float32", "bfloat16"):
        got = fused_nerf_mlp_backward(net, pts, dirs, g[:, None].expand(8, 3), g, dtype=dtype)
        want = fm.fused_nerf_mlp_backward_reference(net, pts, dirs, g[:, None].expand(8, 3), g,
                                                    dtype=dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_backward_past_512_raises_after_a_forward_with_gradients():
    """At 1024/512/3 a forward with gradients runs (K1 serves it; the plain
    version here) and its backward now runs too (K2 serves every network
    K1 serves; no network K1 serves is refused by K2): every parameter's
    and the points' gradient equals the plain backward's, and
    ``recorded_outputs`` gives the plain forward's layers."""
    net = NerfMLP(np_params((1024, 512, 3, 1), 4), requires_grad=True)
    pts, dirs = (torch.from_numpy(a) for a in np_inputs(16, 5))
    pts.requires_grad_(True)
    rgb, sig = fused_nerf_mlp(net, pts, dirs)
    assert rgb.requires_grad and bool(torch.isfinite(rgb).all())
    (rgb.sum() + sig.sum()).backward()
    with torch.no_grad():
        dw, db, dpts, _ = fm.fused_nerf_mlp_backward_reference(
            net, pts, dirs, torch.ones_like(rgb), torch.ones_like(sig))
    want = fm.unpack_grads(net.packed("float32"), dw, db)
    for layer in want:
        for part in ("kernel", "bias"):
            assert torch.equal(net.tree()[layer][part].grad, want[layer][part]), (layer, part)
    assert torch.equal(pts.grad, dpts)
    rec = fm.recorded_outputs(net, pts.detach(), dirs)
    assert len(rec) == 5 and [r.shape[1] for r in rec] == [1024] * 4 + [512]


def test_front_ends_keep_the_kernel_at_1024():
    """The front ends' check (``cli._impl_for_params``: render, evaluate,
    verify, extract) keeps ``impl="pallas"`` at 1024 with no note and
    notes past it; the trainer's check and ``train._trainable`` keep
    ``pallas`` there too (K2 serves K1's envelope) and note past it; the
    renderer's MLP is the kernels' wrapper, the server keeps ``pallas`` and
    ``accel.build_scene_grid`` takes the fused sigma."""
    import contextlib
    import io

    from nerf_rs_tpu_torch import accel, cli, render, train

    cfg = RenderConfig(impl="pallas")
    for dims, note in (((1024, 512, 8), False), ((1024, 1024, 32), False),
                       ((1152, 512, 8), True), ((1024, 512, 33), True)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            got = cli._impl_for_params(cfg, *dims)
        assert (NOTE in out.getvalue()) == note and got.impl == ("xla" if note else "pallas")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            got = cli._train_impl_for_params(cfg, *dims)
        assert ("K2 serves width, v_width <= 1024, depth <= 32" in out.getvalue()) == note
        assert got.impl == ("xla" if note else "pallas")
    net = NerfMLP(np_params((1024, 128, 2, 0), 6))
    assert render.get_mlp_fn(cfg, net, torch.device("cuda", 0)).func is fused_nerf_mlp
    assert accel._default_mlp_fn(net) is accel._fused_sigma
    assert train._trainable({"coarse": net, "fine": net}, cfg).impl == "pallas"


@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_widened_lego_at_4x_computes_the_lego_function(net):
    """``chip_smoke.widen_nerf`` at 4x (phase 29 (e)'s 1024/512/8 lego):
    every unit 4 times, its outgoing rows quartered (exact in binary),
    through the port's plain K1 against JAX's ``nerf_mlp`` of the lego
    itself, f32: rgb within 1e-5, sigma within 1e-4 + 1e-5 |sigma|."""
    cs = chip_smoke()
    lego = load_nerf_params(LEGO / net)
    tree = cs.widen_nerf(lego, 1024, 512, seed=3)
    assert fm.infer_arch(tree) == (1024, 512, 8, 4)
    k0 = np.asarray(lego["dense0"]["kernel"])
    src = [int(np.flatnonzero((k0 == tree["dense0"]["kernel"][:, [j]]).all(0))[0])
           for j in range(1024)]
    assert (np.bincount(src, minlength=256) == 4).all() and src[:256] != list(range(256))
    pts, dirs = np_inputs(64, 5)
    pts *= np.float32(0.4)                          # inside the scene, where sigma is large
    rgb_j, sig_j = jax_nerf_mlp(jax.tree_util.tree_map(jnp.asarray, lego), jnp.asarray(pts),
                                jnp.asarray(dirs))
    rgb, sig = fused_nerf_mlp(NerfMLP(tree), torch.from_numpy(pts), torch.from_numpy(dirs))
    assert float(sig.max()) > 10.0
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_j), atol=1e-4, rtol=1e-5)


def test_cli_render_lego_widened_to_1024_matches_jax_lego_frame(tmp_path, capsys):
    """``render --weights <lego widened to 1024/512/8> --impl pallas
    --device cpu``: no note (K1 serves it), and the frame of the lego itself
    as JAX renders it, within one 8-bit level."""
    cs = chip_smoke()
    d = cs.write_wide_lego(tmp_path, LEGO, 1024, 512, 8)
    out = tmp_path / "w.ppm"
    assert cli_main(["render", "--device", "cpu", "--weights", str(d), "--impl", "pallas",
                     "--width", "8", "--height", "6", "--coarse-samples", "4",
                     "--fine-samples", "4", "--ray-chunk", "16", "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert NOTE not in text and "(pallas/float32" in text
    from nerf_rs_tpu.io.weights import load_nerf_params as jax_load_nerf_params

    coarse, fine = (jax_load_nerf_params(LEGO / n) for n in ("coarse", "fine"))
    cam = jax_camera_from_golden(jax_load_golden(LEGO / "tf_reference_samples.json"))
    want = jax_render_image(coarse, fine, cam, 6, 8, jax.random.key(0),
                            JaxRenderConfig(n_coarse=4, n_fine=4, ray_chunk=16, impl="xla"))
    got = load_ppm(out)
    assert np.abs(got - np.clip(np.asarray(want, np.float32), 0, 1)).max() <= 1.0 / 255 + 1e-6
