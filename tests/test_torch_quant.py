"""PyTorch port, the int8 W8A8 family (models/quant.py and the int8 kernel's
wrapper, ops/kernels/int8_mlp.py) against the JAX package's
nerf_rs_tpu/models/quant.py.

The same numpy inputs go to both packages. Weight and activation scales and
codes agree bit for bit. The dequantized outputs do not: XLA fuses
``acc * sx * sw + b`` into one loop, whose rounding differs from three
separately rounded ops by up to an ulp, and the two packages' positional
encodings differ in the last bit of some entries; either can move a code by
one, and a moved code cascades through the layers. Whole-network parity is
therefore stated as the share of samples within tests/test_quant.py's
real-vs-fake bars. On the CPU the int8 kernel's wrapper runs its plain
version; the kernel is held against it on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.config import ArchConfig as JaxArchConfig
from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.config import TrainConfig as JaxTrainConfig
from nerf_rs_tpu.io.golden import camera_from_golden as jax_camera_from_golden
from nerf_rs_tpu.io.golden import load_golden as jax_load_golden
from nerf_rs_tpu.models import quant as jq
from nerf_rs_tpu.render import render_image as jax_render_image
from nerf_rs_tpu.train import create_train_state as jax_create_train_state
from nerf_rs_tpu.train import train_step as jax_train_step
from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig, TrainConfig
from nerf_rs_tpu_torch.io.golden import camera_from_golden, load_golden
from nerf_rs_tpu_torch.io.weights import load_nerf_params, params_to_torch
from nerf_rs_tpu_torch.models import quant
from nerf_rs_tpu_torch.models.encoding import positional_encoding
from nerf_rs_tpu_torch.models.mlp import NerfMLP, arch_shapes
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.kernels.int8_mlp import (
    fused_int8_mlp,
    fused_int8_mlp_reference,
    kernel_codes,
    pack_int8_params,
)
from nerf_rs_tpu_torch.render import get_mlp_fn, render_image
from nerf_rs_tpu_torch.train import train_state_from_numpy, train_step

torch.set_num_threads(1)

LEGO = Path(__file__).resolve().parents[1] / "assets" / "lego_rust"
LAYERS = [f"dense{i}" for i in range(8)] + ["alpha", "bottleneck", "viewdirs", "rgb"]
# A ragged arch: widths not multiples of 8, the skip at dense1, depth 3.
RAGGED = ArchConfig(width=100, v_width=36, depth=3, skip_at=0)
# tests/test_quant.py:30-33, the JAX package's real-vs-fake bars.
RGB_ATOL, RGB_RTOL, SIG_ATOL, SIG_RTOL = 2e-5, 1e-4, 2e-3, 1e-3


def lego_np(net):
    return {layer: {part: np.asarray(a) for part, a in p.items()}
            for layer, p in load_nerf_params(LEGO / net).items()}


def np_params(arch, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for layer, (d_in, d_out) in arch_shapes(arch).items():
        lim = np.sqrt(6.0 / (d_in + d_out))
        out[layer] = {"kernel": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                      "bias": rng.normal(0.0, 0.1, d_out).astype(np.float32)}
    return out


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def port_tree(tree):
    return params_to_torch(tree, "cpu")


def points_dirs(n, seed):
    """tests/test_quant.py's inputs: points uniform in +-1.2, unit dirs."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def within_bars(rgb, sig, rgb_want, sig_want):
    """Per sample: rgb and sigma within the real-vs-fake bars."""
    ok_rgb = np.abs(rgb - rgb_want) <= RGB_ATOL + RGB_RTOL * np.abs(rgb_want)
    ok_sig = np.abs(sig - sig_want) <= SIG_ATOL + SIG_RTOL * np.abs(sig_want)
    return ok_rgb.all(-1) & ok_sig


@pytest.mark.parametrize("layer", LAYERS)
@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_weight_scales_and_codes_match_jax(net, layer):
    """Every lego layer, the skip layer's 319 rows and the view layer's 283
    included: per-column scales and int8 codes bit for bit."""
    w = lego_np(net)[layer]["kernel"]
    sw_want = np.asarray(jq._weight_scale(jnp.asarray(w)))
    q_want = np.asarray(jnp.round(jnp.asarray(w) / sw_want).clip(-127, 127).astype(jnp.int8))
    codes, sw = quant.quantize_weights(torch.from_numpy(w))
    assert codes.dtype == torch.int8 and tuple(sw.shape) == (1, w.shape[1])
    np.testing.assert_array_equal(sw.numpy(), sw_want)
    np.testing.assert_array_equal(codes.numpy(), q_want)


def test_row_scales_and_codes_match_jax():
    """Per-sample scales and activation codes on the same f32 input, an
    all-zero row (the 1e-12 floor) and halves (round half to even)
    included."""
    rng = np.random.default_rng(0)
    x = np.maximum(rng.normal(size=(4096, 256)), 0).astype(np.float32) * 3.0
    x[7] = 0.0
    x[8, :4] = [127.0, 0.5, 1.5, -2.5]
    sx_want = jq._row_scale(jnp.asarray(x))
    q_want = np.asarray(jnp.round(jnp.asarray(x) / sx_want).clip(-127, 127))
    sx = quant._row_scale(torch.from_numpy(x))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_want))
    np.testing.assert_array_equal(quant._codes(torch.from_numpy(x), sx).numpy(), q_want)
    assert float(sx[7]) == np.float32(1e-12)
    np.testing.assert_array_equal(q_want[8, :4], [127.0, 0.0, 2.0, -2.0])


@pytest.mark.parametrize("layer", ["dense0", "dense5", "viewdirs"])
def test_qdense_real_matches_jax(layer):
    """One real W8A8 layer (the encode input, the skip layer, the view
    layer) on a ReLU'd f32 input: the int32 accumulator equals
    lax.dot_general's, and the dequantized output is within 2 f32 ulps of
    max(|acc sx sw|, |b|) of XLA's fused dequant."""
    tree = lego_np("fine")
    d_in = tree[layer]["kernel"].shape[0]
    rng = np.random.default_rng(1)
    x = np.maximum(rng.normal(size=(2048, d_in)), 0).astype(np.float32)
    w = jnp.asarray(tree[layer]["kernel"])
    sw = jq._weight_scale(w)
    wq = jnp.round(w / sw).clip(-127, 127).astype(jnp.int8)
    sx = jq._row_scale(jnp.asarray(x))
    xq = jnp.round(jnp.asarray(x) / sx).clip(-127, 127).astype(jnp.int8)
    acc_want = np.asarray(jax.lax.dot_general(xq, wq, (((1,), (0,)), ((), ())),
                                              preferred_element_type=jnp.int32))
    want = np.asarray(jq._qdense_real(jax_tree(tree), layer, jnp.asarray(x)))
    pt = port_tree(tree)
    xt = torch.from_numpy(x)
    codes, _ = quant.quantize_weights(pt[layer]["kernel"])
    acc = quant._codes(xt, quant._row_scale(xt)) @ codes.to(torch.float32)
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), acc_want)
    got = quant._qdense_real(pt, layer, xt).numpy()
    scale = np.maximum(np.abs(acc_want * np.asarray(sx) * np.asarray(sw)),
                       np.abs(tree[layer]["bias"]))
    assert (np.abs(got - want) <= 2 * np.spacing(scale.astype(np.float32))).all()


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
@pytest.mark.parametrize("net", ["coarse", "fine"])
def test_int8_mlp_matches_jax(net, fake):
    """int8_nerf_mlp on 8192 lego points: at least 99.5% of the samples
    within the real-vs-fake bars of the JAX package (measured here: 100%,
    max |d rgb| 4e-7), every value finite, max |d rgb| <= 0.05 (a code that
    moves can cascade)."""
    tree = lego_np(net)
    pts, dirs = points_dirs(8192, 2)
    rgb_w, sig_w = (np.asarray(a) for a in jq.int8_nerf_mlp(
        jax_tree(tree), jnp.asarray(pts), jnp.asarray(dirs), fake=fake))
    rgb, sig = (a.numpy() for a in quant.int8_nerf_mlp(
        port_tree(tree), torch.from_numpy(pts), torch.from_numpy(dirs), fake=fake))
    assert rgb.shape == (8192, 3) and sig.shape == (8192,)
    assert np.isfinite(rgb).all() and np.isfinite(sig).all()
    assert within_bars(rgb, sig, rgb_w, sig_w).mean() >= 0.995
    assert np.abs(rgb - rgb_w).max() <= 0.05


def test_int8_mlp_sigma_only_matches_full():
    """sigma_only: the same sigma as the full network, rgb zeros."""
    tree = port_tree(lego_np("coarse"))
    pts, dirs = (torch.from_numpy(a) for a in points_dirs(512, 3))
    rgb, sig = quant.int8_nerf_mlp(tree, pts, dirs, sigma_only=True)
    _, sig_full = quant.int8_nerf_mlp(tree, pts, dirs)
    assert torch.equal(sig, sig_full) and not rgb.any()


def input_rows(pk, name):
    """The pack's code rows that hold the kernel's input rows, in order."""
    if name == "dense0":
        return list(range(63))
    if name == "viewdirs":
        return list(range(pk.width)) + list(range(pk.ldw, pk.ldw + 27))
    if name == "rgb":
        return list(range(pk.v_width))
    if pk.segments[name][1] == 64 + pk.ldw:                       # the skip layer
        return list(range(63)) + list(range(64, 64 + pk.width))
    return list(range(pk.width))


@pytest.mark.parametrize("source", ["lego_fine", "ragged"])
def test_pack_holds_the_quantized_kernels(source):
    """The pack: each layer's codes are quantize_weights' of the whole,
    unsplit kernel, placed at the kernel's input rows; every padding code,
    scale and bias is zero; each column's scale is _weight_scale of the
    full kernel (the skip layer's all 63 + width rows)."""
    tree = port_tree(lego_np("fine") if source == "lego_fine" else np_params(RAGGED, 4))
    pk = pack_int8_params(tree)
    assert pk.weights.dtype == torch.int8
    for name, p in tree.items():
        n_in, n_out = p["kernel"].shape
        codes = pk.codes(name)
        want, _ = quant.quantize_weights(p["kernel"])
        rows = input_rows(pk, name)
        assert len(rows) == n_in, name
        assert torch.equal(codes[rows, :n_out], want), name
        pad = torch.ones(codes.shape, dtype=torch.bool)
        pad[rows, :n_out] = False
        assert not codes[pad].any(), name
        off, n = pk.slots[name]
        ld = pk.segments[name][2]
        assert n == n_out
        assert torch.equal(pk.scales[off:off + n], quant._weight_scale(p["kernel"])[0]), name
        assert torch.equal(pk.biases[off:off + n], p["bias"]), name
        assert not pk.scales[off + n:off + ld].any() and not pk.biases[off + n:off + ld].any()


@pytest.mark.parametrize("source", ["lego_fine", "ragged"])
def test_pack_tiles_the_codes_for_wgmma(source):
    """The tensor-core pack read byte by byte: code (k, n) of each layer's
    padded (K, ld) matrix sits in core matrix (k // 16, n // 8), at byte
    (k // 16 * ld / 8 + n // 8) * 128 + n % 8 * 16 + k % 16 of the layer's
    segment; K pads to a multiple of 32 (an s8 wgmma k-step), every width
    to a multiple of 64 (the kernel's N; the heads' to 8), segments start
    on 128-byte boundaries and tile the buffer without gaps; every byte
    that is not a real code is zero."""
    tree = port_tree(lego_np("fine") if source == "lego_fine" else np_params(RAGGED, 16))
    pk = pack_int8_params(tree)
    flat = pk.weights.numpy()
    assert pk.ldw % 64 == 0 and pk.ldv % 64 == 0
    assert (pk.ldw, pk.ldv) == ((256, 128) if source == "lego_fine" else (128, 64))
    ends = []
    for name, p in tree.items():
        off, k, ld = pk.segments[name]
        assert off % 128 == 0 and k % 32 == 0, name
        assert ld == (8 if name in ("alpha", "rgb") else pk.ldv if name == "viewdirs" else pk.ldw)
        seg = flat[off:off + k * ld]
        kk, nn = np.meshgrid(np.arange(k), np.arange(ld), indexing="ij")
        at = (kk // 16 * (ld // 8) + nn // 8) * 128 + nn % 8 * 16 + kk % 16
        want = np.zeros((k, ld), np.int8)
        codes, _ = quant.quantize_weights(p["kernel"])
        want[input_rows(pk, name), :p["kernel"].shape[1]] = codes.numpy()
        np.testing.assert_array_equal(seg[at], want, err_msg=name)
        ends.append((off, off + k * ld))
    ends.sort()
    assert ends[0][0] == 0 and ends[-1][1] == flat.size
    assert all(a[1] == b[0] for a, b in zip(ends, ends[1:]))


def test_kernel_requantize_equals_the_division():
    """The kernel's requantize (a product with the rounded reciprocal,
    corrected twice by its remainder) gives the codes of the rounded
    quotient bit for bit: on ReLU'd and signed rows at their own scale, on
    rows of zeros and at the 1e-12 floor, and on values placed within a few
    ulps of every half-integer code boundary, where the product alone would
    be wrong."""
    rng = np.random.default_rng(17)
    rows = [np.maximum(rng.normal(size=(2048, 256)), 0) * 3.0,
            rng.normal(size=(2048, 320)) * rng.uniform(1e-6, 1e6, (2048, 1)),
            np.zeros((4, 64)), rng.uniform(-1e-11, 1e-11, (4, 64))]
    for x in rows:
        x = torch.from_numpy(x.astype(np.float32))
        sx = quant._row_scale(x)
        assert torch.equal(kernel_codes(x, sx), quant._codes(x, sx))
    s = torch.from_numpy(rng.uniform(1e-3, 10.0, (4096, 1)).astype(np.float32))
    half = torch.arange(-127, 128, dtype=torch.float32) + 0.5
    x = (half * s).repeat(1, 9)
    for i, step in enumerate(range(-4, 5)):       # nextafter step times, both ways
        cols = x[:, i * 255:(i + 1) * 255]
        for _ in range(abs(step)):
            cols = torch.nextafter(cols, torch.full_like(cols, np.sign(step) * np.inf))
        x[:, i * 255:(i + 1) * 255] = cols
    x = torch.cat([x, torch.full_like(s, 127.0) * s], 1)   # the absmax element
    sx = s.expand(-1, 1)
    fast = torch.clamp(torch.round(x * torch.reciprocal(sx)), -127.0, 127.0)
    want = quant._codes(x, sx)
    assert torch.equal(kernel_codes(x, sx), want)
    assert not torch.equal(fast, want)     # the boundary cases are there


def emulate_kernel(pk, points, dirs, sigma_only):
    """The kernel's dataflow read off the tensor-core pack, in plain torch:
    the padded f32 encodes; each layer's int32 sums from the codes (the
    kernel's requantize, ``kernel_codes``) of its input pieces (the skip layer's encode and trunk codes, the view layer's
    bottleneck and dir-encode codes), all at one row scale, the epilogue's
    absmax of the layer output combined with the encode's; ((acc sx) sw) +
    b with the pack's scales and biases; the heads as integer dot products
    of the codes with the heads' codes."""
    enc_x = torch.nn.functional.pad(positional_encoding(points, 10), (0, 1))
    enc_d = torch.nn.functional.pad(positional_encoding(dirs, 4), (0, 5))

    def absmax(x):
        return torch.amax(torch.abs(x), dim=-1, keepdim=True)

    def layer(name, *pieces):
        soff, _ = pk.slots[name]
        ld = pk.segments[name][2]
        m = torch.stack([absmax(x) for x in pieces]).amax(0)
        sx = torch.clamp_min(m / m.new_full((), 127.0), 1e-12)
        codes = torch.cat([kernel_codes(x, sx) for x in pieces], -1)
        acc = codes.to(torch.int64) @ pk.codes(name).to(torch.int64)   # exact int sums
        return acc.to(torch.float32) * sx * pk.scales[soff:soff + ld] + pk.biases[soff:soff + ld]

    h = torch.relu(layer("dense0", enc_x))
    for i in range(1, pk.depth):
        h = torch.relu(layer(f"dense{i}", enc_x, h) if pk.layout[32 + i] else
                       layer(f"dense{i}", h))
    sigma = torch.relu(layer("alpha", h))[:, 0]
    if sigma_only:
        return torch.zeros_like(points), sigma
    bottleneck = layer("bottleneck", h)
    hv = torch.relu(layer("viewdirs", bottleneck, enc_d))
    return torch.sigmoid(layer("rgb", hv))[:, :3], sigma


@pytest.mark.parametrize("source, sigma_only", [("lego_coarse", True), ("lego_fine", False),
                                                ("ragged", False), ("ragged", True)])
def test_kernel_dataflow_on_the_pack_equals_the_plain_version(source, sigma_only):
    """The layout contract of csrc/int8_mlp_tc.cu, checked where a CPU can: its
    dataflow read off the pack (zero padding rows and columns, the skip
    layer's encode rows first, the dir encode after the bottleneck's ldw
    rows) gives the plain version's outputs bit for bit."""
    tree = port_tree({"lego_coarse": lambda: lego_np("coarse"),
                      "lego_fine": lambda: lego_np("fine"),
                      "ragged": lambda: np_params(RAGGED, 5)}[source]())
    pts, dirs = (torch.from_numpy(a) for a in points_dirs(1024, 6))
    rgb, sig = emulate_kernel(pack_int8_params(tree), pts, dirs, sigma_only)
    rgb_w, sig_w = fused_int8_mlp_reference(tree, pts, dirs, sigma_only=sigma_only)
    assert torch.equal(sig, sig_w)
    assert torch.equal(rgb, rgb_w)


def test_ste_gradients_flow():
    """STE: the gradient of a loss through the fake-quant forward is
    finite and nonzero for every layer of the lego fine network."""
    net = NerfMLP(lego_np("fine"), requires_grad=True)
    pts, dirs = (torch.from_numpy(a) for a in points_dirs(128, 7))
    rgb, sig = quant.int8_nerf_mlp(net, pts, dirs, fake=True)
    (torch.mean(rgb ** 2) + torch.mean(torch.clamp(sig, max=10.0) ** 2) * 1e-3).backward()
    for name, p in net.weights.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if name.endswith("kernel"):
            assert p.grad.abs().max() > 0, name


def test_ste_gradients_match_jax():
    """The same loss's gradients against jax.grad on a small student,
    every leaf within 1e-5 in relative norm (measured 2.7e-7: the same
    codes, products in another order)."""
    tree = np_params(ArchConfig(width=64, v_width=32, depth=4, skip_at=2), 3)
    pts, dirs = points_dirs(128, 8)

    def jax_loss(p):
        rgb, sig = jq.int8_nerf_mlp(p, jnp.asarray(pts), jnp.asarray(dirs), fake=True)
        return jnp.mean(rgb ** 2) + jnp.mean(jnp.minimum(sig, 10.0) ** 2) * 1e-3

    want = jax.grad(jax_loss)(jax_tree(tree))
    net = NerfMLP(tree, requires_grad=True)
    rgb, sig = quant.int8_nerf_mlp(net, torch.from_numpy(pts), torch.from_numpy(dirs), fake=True)
    (torch.mean(rgb ** 2) + torch.mean(torch.clamp(sig, max=10.0) ** 2) * 1e-3).backward()
    for layer, parts in want.items():
        for part, g in parts.items():
            g = np.asarray(g)
            got = net.weights[f"{layer}_{part}"].grad.numpy()
            assert np.linalg.norm(got - g) <= 1e-5 * np.linalg.norm(g), (layer, part)


def test_int8qat_train_step_matches_jax():
    """One int8qat Adam step from the same state, batch and key as
    tests/test_torch_train.py::test_train_step_matches_jax: the loss to
    1e-5, the parameters within tests/test_train.py:106-112's bound (every
    entry within 2 lr, under 0.1% of each leaf's entries > 1e-5). On other
    batches a code that the encode's last bit moves can shift the loss by
    up to ~6e-5 relative (measured), with the fine network's first layer
    moving most."""
    small = dict(width=128, v_width=64, depth=4, skip_at=2)
    jax_cfg = JaxTrainConfig(batch_rays=64, arch=JaxArchConfig(**small), render=JaxRenderConfig(
        n_coarse=8, n_fine=8, ray_chunk=64, impl="int8qat"))
    cfg = TrainConfig(batch_rays=64, arch=ArchConfig(**small), render=RenderConfig(
        n_coarse=8, n_fine=8, ray_chunk=64, impl="int8qat"))
    rng = np.random.default_rng(1)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    batch = {"origins": np.zeros((64, 3), np.float32), "dirs": dirs,
             "rgb": rng.uniform(size=(64, 3)).astype(np.float32),
             "near": np.float32(2.0), "far": np.float32(6.0)}
    jax_state = jax_create_train_state(jax.random.key(0), jax_cfg)
    adam = jax_state.opt_state[0]

    def to_np(tree):
        return jax.tree_util.tree_map(np.array, tree)

    state = train_state_from_numpy(to_np(jax_state.params), to_np(adam.mu), to_np(adam.nu),
                                   int(adam.count), int(jax_state.step), "cpu")
    jax_state, want = jax_train_step(jax_state, {k: jnp.asarray(v) for k, v in batch.items()},
                                     jax.random.key(1), jax_cfg)
    state, metrics = train_step(state, {k: torch.as_tensor(v) for k, v in batch.items()},
                                random.key(1, "cpu"), cfg)
    np.testing.assert_allclose(float(metrics["loss"]), float(want["loss"]), rtol=1e-5)
    for net, tree in to_np(jax_state.params).items():
        for layer, parts in tree.items():
            for part, value in parts.items():
                diff = np.abs(state.params[net].weights[f"{layer}_{part}"].detach().numpy()
                              - value)
                assert diff.max() < 2 * cfg.lr_init, (net, layer, part, diff.max())
                assert (diff > 1e-5).mean() < 1e-3, (net, layer, part)


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return -10.0 * np.log10(max(mse, 1e-20))


def test_int8_frame_matches_jax():
    """The 64x64 16 + 32 lego frame with impl="int8" (the kernel's plain
    version on the CPU): at least 60 dB from the JAX package's int8 frame
    (measured 69.08 dB; a moved code shifts a pixel by up to 0.03), and
    above tests/test_quant.py's 25 dB from the port's f32 frame (measured
    33.05 dB)."""
    golden = load_golden(LEGO / "tf_reference_samples.json")
    jax_nets = {net: jax_tree(lego_np(net)) for net in ("coarse", "fine")}
    want = jax_render_image(jax_nets["coarse"], jax_nets["fine"],
                            jax_camera_from_golden(jax_load_golden(
                                LEGO / "tf_reference_samples.json")),
                            64, 64, jax.random.key(0),
                            JaxRenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024, impl="int8"))
    nets = {net: NerfMLP(lego_np(net)) for net in ("coarse", "fine")}
    cfg = RenderConfig(n_coarse=16, n_fine=32, ray_chunk=1024, impl="int8")
    cam = camera_from_golden(golden)
    got = render_image(nets["coarse"], nets["fine"], cam, 64, 64, random.key(0, "cpu"), cfg)
    f32 = render_image(nets["coarse"], nets["fine"], cam, 64, 64, random.key(0, "cpu"),
                       cfg.replace(impl="xla"))
    assert got.shape == (64, 64, 3) and bool(torch.isfinite(got).all())
    assert psnr(got.numpy(), np.asarray(want)) >= 60.0
    assert psnr(got.numpy(), f32.numpy()) > 25.0


def test_fused_int8_mlp_on_cpu_is_the_plain_version():
    """CPU tensors run the plain version and launch nothing; a NerfMLP and
    a param tree give the same outputs."""
    tree = port_tree(np_params(RAGGED, 9))
    net = NerfMLP(tree)
    pts = torch.from_numpy(points_dirs(37 * 5, 10)[0]).reshape(37, 5, 3)
    dirs = torch.nn.functional.normalize(torch.ones(37, 1, 3), dim=-1)
    before = fused_int8_mlp.launches
    for sigma_only in (False, True):
        rgb, sig = fused_int8_mlp(net, pts, dirs, sigma_only=sigma_only)
        rgb_w, sig_w = fused_int8_mlp_reference(tree, pts, dirs, sigma_only=sigma_only)
        assert rgb.shape == (37, 5, 3) and sig.shape == (37, 5)
        assert torch.equal(rgb, rgb_w) and torch.equal(sig, sig_w)
    assert fused_int8_mlp.launches == before


def test_fused_int8_mlp_refuses_other_devices():
    tree = port_tree(np_params(RAGGED, 11))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_int8_mlp(tree, torch.zeros(4, 3, device="meta"), torch.zeros(4, 3, device="meta"))


def test_pack_refuses_what_the_kernel_does_not_serve():
    """Widths beyond 512 and depths beyond 32 are outside the kernels'
    envelope: the pack raises (on the card the wrapper raises
    NotImplementedError first). Width 264, beyond the narrow kernel, is
    served: the wide kernel's pack."""
    wide = port_tree(np_params(ArchConfig(width=576, v_width=32, depth=2, skip_at=5), 12))
    with pytest.raises(ValueError, match="width=576"):
        pack_int8_params(wide)
    deep = port_tree(np_params(ArchConfig(width=64, v_width=32, depth=33, skip_at=4), 12))
    with pytest.raises(ValueError, match="depth=33"):
        pack_int8_params(deep)
    served = pack_int8_params(port_tree(np_params(ArchConfig(width=264, v_width=32, depth=2,
                                                             skip_at=5), 12)))
    assert served.wide and served.ldw == 320


def test_get_mlp_fn_routes_the_int8_family():
    """impl="int8" is the kernel's wrapper; impl="int8qat" the STE
    forward, differentiable in the network's parameters. Both ignore
    cfg.dtype, as the JAX package's family does."""
    net = NerfMLP(np_params(RAGGED, 13), requires_grad=True)
    pts, dirs = (torch.from_numpy(a) for a in points_dirs(64, 14))
    real = get_mlp_fn(RenderConfig(impl="int8", dtype="bfloat16"))
    assert real.func is fused_int8_mlp
    rgb, sig = real(net, pts, dirs)
    assert rgb.dtype == torch.float32
    want = quant.int8_nerf_mlp(net, pts, dirs)
    assert torch.equal(rgb, want[0]) and torch.equal(sig, want[1])
    fake = get_mlp_fn(RenderConfig(impl="int8qat"))
    rgb_f, sig_f = fake(net, pts, dirs)
    (rgb_f.sum() + sig_f.sum()).backward()
    assert net.weights["dense0_kernel"].grad.abs().max() > 0


def test_int8_pack_is_cached_and_follows_the_parameters():
    """NerfMLP keeps its int8 pack under the key "int8" until a parameter
    changes in place (an optimizer step), then repacks."""
    net = NerfMLP(np_params(RAGGED, 15))
    pk = net.packed("int8")
    assert net.packed("int8") is pk
    with torch.no_grad():
        net.weights["dense1_kernel"].mul_(2.0)
    again = net.packed("int8")
    assert again is not pk
    assert torch.equal(again.weights, pack_int8_params(net.tree()).weights)
    assert not torch.equal(again.scales, pk.scales)
