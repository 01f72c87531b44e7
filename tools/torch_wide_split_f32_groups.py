#!/usr/bin/env python3
"""A split-f32 route for K1's wide f32 kernel, its arithmetic on the CPU,
for each size of its big accumulator's groups: how far the emulated forward
(``fused_mlp.split_f32_dense(group=G)``, the plain K1 with every layer
product in the narrow f32 kernel's bf16x6 split, its big accumulator summed
in groups of G k-steps) lies from float64 on the lego fine network widened
to 384/192/8, 512/256/8 and 512/256/20 (``chip_smoke.widen_nerf``), at
samples on rays through the lego, three in four where it is dense.

    python3 tools/torch_wide_split_f32_groups.py [--samples 1024] [--groups 4,8,16,32,0]

For each network and G (0: one big accumulator a layer, the narrow
kernel's arithmetic) it prints: the ReLU masks on the other side of
float64's outside ``chip_smoke.MASK_TAU``'s band (those f32 can resolve;
must be 0) and inside it; the share of pre-activations further than
MASK_TAU / 8 of their size (|b| + sum |w x|) from float64, beside the
narrow kernel's share on the lego itself; and the plain f32 backward run
on the emulated forward's activations and masks against float64 (which
follows the emulated masks where they are unresolved:
``chip_smoke.kernel_mask_exact``), as the largest ratio of a gradient's
distance to phase 29's f32 bar, max(1e-4, 1.5 x the plain backward's).
No card; about a minute on one CPU core.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
LEGO = REPO / "assets" / "lego_rust"
ARCHS = ((384, 192, 8), (512, 256, 8), (512, 256, 20))
# The largest group (k-steps of 16) whose share of pre-activations beyond
# MASK_TAU / 8 of float64 stays at the narrow kernel's (16 is the narrow
# kernel's own count at width 256), with no mask outside the band and the
# plain backward on its forward within phase 29's f32 bar.
GROUP_STEPS = 16


def chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(REPO))
    return cs


@contextlib.contextmanager
def kernel_arithmetic(group, seen=None):
    """The plain versions with every layer product in split-f32, its big
    accumulator in groups of ``group`` k-steps (None: one group a layer);
    ``seen``, a list, collects each pre-activation in order."""
    from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm

    def dense(sources, b):
        z = fm.split_f32_dense(sources, b, group=group)
        if seen is not None:
            seen.append(z)
        return z

    real = fm._dense
    fm._dense = dense
    try:
        yield
    finally:
        fm._dense = real


def surface_samples(n: int, seed: int = 19):
    """``n`` samples, each its own ray (points and viewdirs (n, 1, 3)), and
    cotangents ((n, 1, 3), (n, 1)), numpy f32: points on rays toward the
    lego's middle, three in four where the lego fine network's sigma is
    largest (where the training path's fine samples gather), the rest drawn
    from the others."""
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp_reference

    rng = np.random.default_rng(seed)
    rays, steps = 64, 128
    o = rng.uniform(-1, 1, (rays, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, (rays, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(2, 6, steps)[None, :, None] + rng.uniform(0, 4 / steps, (rays, steps, 1))
    pts = (o[:, None] + t * d[:, None]).reshape(-1, 3).astype(np.float32)
    dirs = np.repeat(d, steps, axis=0).astype(np.float32)
    lego = NerfMLP(load_nerf_params(LEGO / "fine"))
    with torch.no_grad():
        sig = fused_nerf_mlp_reference(lego, torch.from_numpy(pts), torch.from_numpy(dirs),
                                       sigma_only=True)[1].numpy()
    order = np.argsort(-sig, kind="stable")
    dense = 3 * n // 4
    pick = np.concatenate([order[:dense], rng.choice(order[dense:], n - dense, replace=False)])
    g_rgb = (1e-2 * rng.normal(size=(n, 1, 3))).astype(np.float32)
    g_sigma = (1e-2 * rng.normal(size=(n, 1))).astype(np.float32)
    return pts[pick].reshape(n, 1, 3), dirs[pick].reshape(n, 1, 3), g_rgb, g_sigma


def band_misses(net, args, group):
    """(masks on the other side of float64's outside MASK_TAU's band,
    inside it, masks checked) of the emulated forward: the trunk layers,
    the sigma head and the view layer."""
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp_reference, recorded_outputs

    cs = chip_smoke()
    with kernel_arithmetic(group):
        rec = recorded_outputs(net, *args[:2])
        sigma = fused_nerf_mlp_reference(net, *args[:2])[1]
    depth = net.packed("float32").depth
    layers = {f"dense{i}": rec[i] for i in range(depth)}
    layers["alpha"] = sigma.reshape(-1, 1)
    layers["viewdirs"] = rec[depth + 1]
    outside = inside = checked = 0
    for name, s, z, size in cs.float64_preactivations(net, args, False):
        on = layers[name][s:s + z.shape[0]] > 0
        z, size = z[:, :on.shape[1]], size[:, :on.shape[1]]
        flipped, band = on != (z > 0), z.abs() < cs.MASK_TAU * size
        outside += int((flipped & ~band).sum())
        inside += int((flipped & band).sum())
        checked += z.numel()
    return outside, inside, checked


def far_share(net, args, group) -> float:
    """The share of the ReLU layers' pre-activations (trunk, view) that the
    emulated forward puts further than MASK_TAU / 8 of their size from
    float64."""
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import recorded_outputs

    cs = chip_smoke()
    seen = []
    with kernel_arithmetic(group, seen):
        recorded_outputs(net, *args[:2])
    zs = {name: (z, size) for name, _, z, size in cs.float64_preactivations(net, args, False)}
    names = [f"dense{i}" for i in range(len(seen) - 2)] + ["bottleneck", "viewdirs"]
    far = total = 0
    for name, z in zip(names, seen):
        if name in zs:
            z64, size = zs[name]
            r = (z.double()[:, :z64.shape[1]] - z64).abs() / size
            far += int((r > cs.MASK_TAU / 8).sum())
            total += r.numel()
    return far / total


def backward_margin(net, args, group):
    """(the largest ratio of a gradient's distance from float64 to phase
    29's f32 bar for the plain backward on the emulated forward, that
    gradient, kernel_mask_exact's counts)."""
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp_backward_reference

    cs = chip_smoke()
    pk = net.packed("float32")

    def rel(got, want):
        return float((got.double() - want.double()).norm()
                     / max(float(want.double().norm()), 1e-30))

    plain = cs.named_gradients(pk, fused_nerf_mlp_backward_reference(net, *args))
    g64 = cs.named_gradients(pk, fused_nerf_mlp_backward_reference(
        net, *(a.double() for a in args)))
    with kernel_arithmetic(group):
        emulated = cs.named_gradients(pk, fused_nerf_mlp_backward_reference(net, *args))
        g64k, info = cs.kernel_mask_exact(net, args, False, g64)
    ratio = {k: rel(emulated[k], g64k[k])
             / max(cs.BWD_BARS["float32"], cs.F32_VS_PLAIN * rel(plain[k], g64[k]))
             for k in g64}
    worst = max(ratio, key=ratio.get)
    return ratio[worst], worst, info


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--samples", type=int, default=1024)
    parser.add_argument("--groups", default="4,8,16,32,0",
                        help="comma-separated k-steps a group (0: one group a layer)")
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    from nerf_rs_tpu_torch.io.weights import load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP

    cs = chip_smoke()
    torch.set_num_threads(1)
    data = tuple(torch.from_numpy(a) for a in surface_samples(args.samples))
    lego = load_nerf_params(LEGO / "fine")
    narrow = far_share(NerfMLP(lego), data, None)
    print(f"the lego fine network (256/128/8, the narrow kernel's arithmetic): "
          f"{narrow:.4%} of pre-activations beyond MASK_TAU / 8 of float64", flush=True)
    for arch in ARCHS:
        net = NerfMLP(cs.widen_nerf(lego, *arch, seed=3))
        for g in (int(v) for v in args.groups.split(",")):
            group = g or None
            outside, inside, checked = band_misses(net, data, group)
            share = far_share(net, data, group)
            ratio, worst, info = backward_margin(net, data, group)
            print(f"lego widened to {arch}, groups of {g or 'a whole layer'} k-steps: masks on "
                  f"the other side of float64's outside the band {outside}, inside {inside} "
                  f"(of {checked}); beyond MASK_TAU / 8 {share:.4%} ({share / narrow:.2f} x "
                  f"the narrow kernel's); plain backward on its forward: {ratio:.3f} of phase "
                  f"29's f32 bar at worst ({worst}; {info['unresolved']} masks unresolved, "
                  f"{info['other_side']} set the other way)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
