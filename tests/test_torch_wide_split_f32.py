"""PyTorch port, a split-f32 route for K1's wide f32 kernel, its arithmetic
on the CPU: the plain K1 with every layer product in the narrow f32
kernel's split-f32 arithmetic, its big accumulator in groups of
``GROUP_STEPS`` k-steps (tools/torch_wide_split_f32_groups.py;
``fused_mlp.split_f32_dense(group=...)``), at the wide architectures:
the lego fine network widened to 384/192/8 and 512/256/8
(``chip_smoke.widen_nerf``, the same function) and a random 512/256/20
network, at 1,024 samples from numpy (three in four where the lego is
dense). The emulated forward is held

(a) to the JAX fused kernel (interpret mode) at tests/test_torch_wide.py's
    f32 bars;
(b) to float64: no further than twice the plain f32 version, rgb and sigma
    each;
(c) to float64's ReLU masks: none on the other side outside
    ``chip_smoke.MASK_TAU``'s band (f32 cannot resolve the rest), and no
    more pre-activations far from float64 than one big accumulator a
    layer leaves (the narrow kernel's arithmetic);
(d) as K2 would differentiate it: the plain backward run on the emulated
    forward's activations and masks lies within phase 29's f32 bar of the
    float64 evaluation, which follows the emulated masks where they are
    unresolved (``chip_smoke.kernel_mask_exact``)."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.ops.kernels.fused_mlp import fused_nerf_mlp as jax_fused_nerf_mlp
from nerf_rs_tpu_torch.io.weights import load_nerf_params
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
    fused_nerf_mlp_backward_reference,
    fused_nerf_mlp_reference,
    split_f32_dense,
)
from test_torch_wide import jax_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LEGO = ROOT / "assets" / "lego_rust"
N = 1024
CASES = ["lego_384x192x8", "lego_512x256x8", "random_512x256x20"]


def groups_tool():
    """tools/torch_wide_split_f32_groups.py: the samples, the emulation and
    its measures, shared with this file."""
    path = ROOT / "tools" / "torch_wide_split_f32_groups.py"
    spec = importlib.util.spec_from_file_location("torch_wide_split_f32_groups", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


TOOL = groups_tool()
G = TOOL.GROUP_STEPS


@pytest.fixture(scope="module")
def samples():
    return TOOL.surface_samples(N)


@pytest.fixture(scope="module", params=CASES)
def case(request, samples):
    """(tree of numpy arrays, NerfMLP, torch inputs, plain f32 forward,
    float64 forward, emulated forward) of one case."""
    kind, arch = request.param.split("_")
    width, v_width, depth = (int(v) for v in arch.split("x"))
    if kind == "lego":
        tree = TOOL.chip_smoke().widen_nerf(load_nerf_params(LEGO / "fine"), width, v_width,
                                            depth, seed=3)
    else:
        tree = jax_params((width, v_width, depth, 4), 7)
    net = NerfMLP(tree)
    args = tuple(torch.from_numpy(a) for a in samples)
    pts, dirs = args[:2]
    plain = fused_nerf_mlp_reference(net, pts, dirs)
    exact = fused_nerf_mlp_reference(net, pts.double(), dirs.double())
    with TOOL.kernel_arithmetic(G):
        emulated = fused_nerf_mlp_reference(net, pts, dirs)
    return tree, net, args, plain, exact, emulated


@pytest.mark.parametrize("width", [256, 512])
def test_one_group_a_layer_is_the_narrow_arithmetic(width):
    """A group as long as the layer is the narrow kernel's emulation, bit
    for bit (a layer of 256 takes 16 k-steps, one group); at 512 the groups
    change the sums."""
    rng = np.random.default_rng(width)
    a = torch.from_numpy(rng.normal(size=(64, width)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(width, 128)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=128).astype(np.float32))
    narrow = split_f32_dense([(a, w)], b)
    assert torch.equal(split_f32_dense([(a, w)], b, group=width // fm._STEP_K), narrow)
    grouped = split_f32_dense([(a, w)], b, group=G)
    assert torch.equal(grouped, narrow) == (width <= G * fm._STEP_K)


def test_emulation_matches_jax_fused_kernel(case):
    """(a) The emulated forward against the JAX fused kernel (interpret
    mode) on the same network and inputs, at tests/test_torch_wide.py's
    f32 bars."""
    tree, _, args, plain, _, emulated = case
    rgb_j, sig_j = jax_fused_nerf_mlp(jax.tree_util.tree_map(jnp.asarray, tree),
                                      jnp.asarray(args[0].numpy()), jnp.asarray(args[1].numpy()))
    np.testing.assert_allclose(emulated[0].numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(emulated[1].numpy(), np.asarray(sig_j), atol=1e-4, rtol=1e-5)
    assert not torch.equal(emulated[1], plain[1])      # the emulation ran


def test_emulation_is_as_close_to_float64_as_plain(case):
    """(b) rgb and sigma each no further from the float64 evaluation than
    twice the plain f32 version is."""
    _, _, _, plain, exact, emulated = case
    for got, want, ref in zip(emulated, plain, exact):
        dist = float((got.double() - ref).abs().max())
        assert dist <= 2 * float((want.double() - ref).abs().max()), dist


def test_emulation_masks_stay_within_the_band(case):
    """(c) Every ReLU mask of the emulated forward (the trunk layers, the
    sigma head, the view layer) is float64's wherever the float64
    pre-activation lies outside MASK_TAU x (|b| + sum |w x|) of zero."""
    _, net, args, _, _, _ = case
    outside, _, checked = TOOL.band_misses(net, args, G)
    pk = net.packed("float32")
    assert checked == N * (pk.depth * pk.width + 1 + pk.v_width)
    assert outside == 0


@pytest.mark.parametrize("arch", [(384, 192, 8), (512, 256, 8)], ids=["384x192x8", "512x256x8"])
def test_groups_keep_preactivations_as_close_as_the_narrow_kernel(arch, samples):
    """(c) Why groups: on the widened lego the share of ReLU
    pre-activations further than MASK_TAU / 8 of their size from float64
    is smaller with GROUP_STEPS than with one big accumulator a layer
    (the narrow kernel's arithmetic at 384 and 512, 24 and 32 roundings of
    it), and no larger than the narrow kernel's share on the lego itself."""
    args = tuple(torch.from_numpy(a) for a in samples)
    lego = load_nerf_params(LEGO / "fine")
    wide = NerfMLP(TOOL.chip_smoke().widen_nerf(lego, *arch, seed=3))
    grouped = TOOL.far_share(wide, args, G)
    one = TOOL.far_share(wide, args, None)
    narrow = TOOL.far_share(NerfMLP(lego), args, None)
    assert grouped < 0.7 * one, (grouped, one)
    assert grouped <= 1.25 * narrow, (grouped, narrow)


def test_backward_on_the_emulated_forward_meets_the_f32_bar(case):
    """(d) The plain f32 backward recomputing with the emulated forward's
    activations and masks: every gradient within max(1e-4, 1.5 x the plain
    f32 backward's distance) of the float64 evaluation (phase 29's f32
    bar), the float64 side following the emulated masks on the samples
    where they are unresolved and set the other way."""
    _, net, args, _, _, _ = case
    ratio, worst, info = TOOL.backward_margin(net, args, G)
    assert info["unresolved"] > 0                 # the inputs reach unresolved masks
    assert ratio <= 1.0, (worst, info)
    with TOOL.kernel_arithmetic(G):
        emulated = fused_nerf_mlp_backward_reference(net, *args)[2]
    assert not torch.equal(emulated, fused_nerf_mlp_backward_reference(net, *args)[2])
