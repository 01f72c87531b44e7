#!/usr/bin/env python3
"""Where K2 in f32 parts from the float64 evaluation, sample by sample and
unit by unit, and how far f32's unresolved ReLU masks move that evaluation.

    python3 tools/torch_k2_mask_probe.py [--quick]

Part 1, the lego coarse network sigma-only at the training path's inputs
(``chip_smoke.main_path_backward_inputs``, 4096 x 64), through the narrow
K2 on the lego itself and the wide K2 on the lego widened to 512/256/8
(``chip_smoke.widen_nerf``, the same function):
- every gradient's distance from float64, kernel and plain;
- the rays halved down to one (the half holding the larger share of the
  kernel's error in the tightest gradient), then that ray's samples one
  by one: the sample the error comes from, and its share of the error;
- that sample's trunk pre-activations in float64, the units closest to
  zero relative to |b| + sum |w_i x_i|, the plain f32 value and what the
  kernel's own forward makes of each (K1 on the network cut after that
  layer with a sigma head of e_k: its sigma is the unit's output);
- the gradients again with that sample's cotangent at zero;
- the float64 gradients with every mask within tau of zero flipped
  (``chip_smoke.mask_gradients``), for three tau: how far masks f32
  cannot resolve could move them;
- the kernel against float64 with those masks (at ``chip_smoke.MASK_TAU``)
  set as the kernel's forward set them (``chip_smoke.kernel_mask_exact``).
Part 2, random networks (``tests/test_torch_cuda.py``'s ``np_params``,
seed 5, and its inputs: 37 x 29 samples, seed 5, cotangents seed 6): the
wide 384/192/8, 512/512/32 and 200/264/20 and the narrow 256/128/16, f32
and bf16, full and sigma-only: each gradient's kernel, plain and float64
distances, the tightest at ``test_wide_backward_kernel_matches_plain``'s
bars (f32 within max(1e-4, 1.5 x plain's distance) of float64 with the
masks f32 cannot resolve set as the kernel's forward set them,
``chip_smoke.kernel_mask_exact``; bf16 within 3e-2 of plain); an f32 miss
is located as in part 1.
Each line names the card and its power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TAUS = (2.0 ** -20, 2.0 ** -18, 2.0 ** -16)


def gradients(net, args, dtype, sigma_only):
    """K2, its plain version and (f32) float64, named."""
    import chip_smoke as smoke

    got, _, want, exact = smoke.k2_gradients(net, args, dtype, sigma_only,
                                             smoke.WIDE_EXACT_RAYS)
    pk = net.packed(dtype)
    named = [smoke.named_gradients(pk, out) for out in (got, want)]
    return named[0], named[1], smoke.named_gradients(pk, exact) if exact is not None else None


def flip_distance(net, args, sigma_only: bool, tau: float):
    """Per gradient, how far flipping every ReLU mask within ``tau`` of
    zero (``chip_smoke.mask_gradients``) moves the float64 gradient,
    ||g_flipped - g|| / ||g||. -> (that dict, masks flipped)."""
    import chip_smoke as smoke

    exact, _ = smoke.mask_gradients(net, args, sigma_only)
    flipped, n = smoke.mask_gradients(net, args, sigma_only, tau)
    return {k: smoke.rel_err(flipped[k], exact[k]) for k in exact}, n


def rays_of(args, idx):
    return tuple(a[idx] for a in args)


def leaf_error(net, args, sigma_only, leaf):
    """The kernel's f32 gradient ``leaf`` minus float64's, on ``args``."""
    import chip_smoke as smoke

    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        fused_nerf_mlp_backward,
        fused_nerf_mlp_backward_reference,
    )

    pk = net.packed("float32")
    got = fused_nerf_mlp_backward(net, *args, dtype="float32", sigma_only=sigma_only)
    ex = fused_nerf_mlp_backward_reference(net, *(a.double() for a in args), sigma_only=sigma_only)
    return (smoke.named_gradients(pk, got)[leaf].double()
            - smoke.named_gradients(pk, ex)[leaf]).reshape(-1)


def preactivations(pk, pts):
    """Each trunk layer's and the sigma head's float64 pre-activations and
    |b| + sum |w_i x_i| at points ``pts`` (n, 3), and the same
    pre-activations in f32 (cuBLAS, TF32 off)."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm

    out = {}
    for dt in (torch.float64, torch.float32):
        x = pts.to(dt)
        enc = fm._encode(x, 10, fm._ENC_X)
        h = None
        for i in range(pk.depth + 1):
            name = f"dense{i}" if i < pk.depth else "alpha"
            src = [(enc, name)] if i == 0 else [(h, name)]
            if f"dense{i}_enc" in pk.segments:
                src.insert(0, (enc, f"dense{i}_enc"))
            b = pk.bias(name).to(dt)
            z = b + sum(a @ pk.mat(w).to(dt) for a, w in src)
            size = b.abs() + sum(a.abs() @ pk.mat(w).to(dt).abs() for a, w in src)
            out.setdefault(name, {})[dt] = (z, size)
            h = torch.relu(z)
    return out


def kernel_unit(tree, layer: int, unit: int, pts, dirs):
    """What K1's own f32 forward gives trunk layer ``layer``'s unit
    ``unit`` at ``pts``: the network cut after that layer, its sigma head
    e_unit with bias 0, sigma-only."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp

    width = tree["dense0"]["kernel"].shape[1]
    cut = {k: v for k, v in tree.items()
           if not (k.startswith("dense") and int(k[5:]) > layer)}
    head = torch.zeros((width, 1), device=pts.device)
    head[unit, 0] = 1.0
    cut["alpha"] = {"kernel": head, "bias": torch.zeros(1, device=pts.device)}
    with torch.no_grad():
        _, sig = fused_nerf_mlp(cut, pts, dirs, dtype="float32", sigma_only=True)
    return float(sig.reshape(-1)[0])


def locate(card, label, net, tree, args, sigma_only, leaf):
    """Halve the rays down to the one holding the larger share of the
    kernel's error in gradient ``leaf``, then its samples one by one; print
    the sample, its units closest to zero and what the kernel's forward
    makes of them, and the gradients with its cotangents at zero."""
    import torch

    import chip_smoke as smoke

    bar = smoke.BWD_BARS["float32"]
    total = leaf_error(net, args, sigma_only, leaf)
    idx = torch.arange(args[0].shape[0], device=args[0].device)
    while idx.numel() > 1:
        halves = (idx[:idx.numel() // 2], idx[idx.numel() // 2:])
        errs = [leaf_error(net, rays_of(args, h), sigma_only, leaf) for h in halves]
        pick = int(errs[1].norm() > errs[0].norm())
        idx = halves[pick]
    ray = int(idx[0])
    one = rays_of(args, idx)
    samples = one[0].shape[1]
    errs = []
    for s in range(samples):
        sub = (one[0][:, s:s + 1], one[1], one[2][:, s:s + 1], one[3][:, s:s + 1])
        errs.append(leaf_error(net, sub, sigma_only, leaf))
    s = max(range(samples), key=lambda j: float(errs[j].norm()))
    share = float(errs[s].norm() / total.norm())
    ray_share = float(leaf_error(net, one, sigma_only, leaf).norm() / total.norm())
    sample = ray * samples + s
    print(f"{card}: {label}: the error in {leaf} (norm {float(total.norm()):.3e}) halves down "
          f"to ray {ray} ({ray_share:.3f} of it), sample {s} of it (flat {sample}): "
          f"{share:.3f} of it; its sigma cotangent {float(one[3][0, s]):.4e}", flush=True)
    pk = net.packed("float32")
    pre = preactivations(pk, one[0][0, s:s + 1])
    rows = []
    for name, by in pre.items():
        z64, size = (t[0].double() for t in by[torch.float64])
        z32 = by[torch.float32][0][0].double()
        r = (z64.abs() / size.clamp_min(1e-300))
        for u in torch.argsort(r)[:3].tolist():
            if float(size[u]) > 0:
                rows.append((float(r[u]), name, u, float(z64[u]), float(size[u]),
                             float(z32[u])))
    rows.sort()
    for r, name, u, z64, size, z32 in rows[:4]:
        if name == "alpha":
            k_val = "n/a (the sigma head)"
        else:
            h = kernel_unit(tree, int(name[5:]), u, one[0][:, s:s + 1], one[1])
            k_val = (f"{h:.4e} (mask {'on' if h > 0 else 'off'}; float64's "
                     f"{'on' if z64 > 0 else 'off'})")
        print(f"{card}: {label}: sample {sample} {name} unit {u}: float64 z {z64:.4e}, "
              f"|b| + sum |w x| {size:.4e}, ratio {r:.3e}; plain f32 z {z32:.4e}; the "
              f"kernel's forward: {k_val}", flush=True)
    cut = list(args)
    for j in (2, 3):
        cut[j] = args[j].clone()
        cut[j].reshape(-1, *args[j].shape[2:])[sample] = 0.0
    gk2, gp2, g642 = gradients(net, cut, "float32", sigma_only)
    m2 = {k: smoke.rel_err(gk2[k], g642[k])
          / max(bar, smoke.F32_VS_PLAIN * smoke.rel_err(gp2[k], g642[k])) for k in g642}
    t2 = max(m2, key=m2.get)
    print(f"{card}: {label}: sample {sample}'s cotangent at zero: tightest {t2}: kernel "
          f"{smoke.rel_err(gk2[t2], g642[t2]):.3e}, plain {smoke.rel_err(gp2[t2], g642[t2]):.3e}"
          f" from float64, {m2[t2]:.3f} of row 35's bar; {leaf} {m2[leaf]:.3f}", flush=True)


def oracle_line(card, label, net, args, sigma_only, gk, gp, g64):
    """The kernel against float64 with the masks f32 cannot resolve set as
    the kernel's forward set them (``chip_smoke.kernel_mask_exact``), at
    row 35's bar; printed under ``label`` unless it is None. -> (the line,
    margins, the tightest gradient)."""
    import chip_smoke as smoke

    g64k, info = smoke.kernel_mask_exact(net, args, sigma_only, g64)
    keys = [k for k in g64 if bool(g64[k].any()) or bool(gk[k].any())]
    if not keys:
        return "every gradient zero in float64 and in the kernel", {None: 0.0}, None
    m = {k: smoke.rel_err(gk[k], g64k[k])
         / max(1e-4, smoke.F32_VS_PLAIN * smoke.rel_err(gp[k], g64[k])) for k in keys}
    t = max(m, key=m.get)
    line = (f"{info['unresolved']} masks within 2^{round(math.log2(smoke.MASK_TAU))} of zero, "
            f"{info['other_side']} set the other way by the kernel's forward ({info['samples']} "
            f"samples on its masks, {info['masks']} of theirs differing); against that float64 "
            f"tightest {t}: kernel {smoke.rel_err(gk[t], g64k[t]):.3e}, plain "
            f"{smoke.rel_err(gp[t], g64[t]):.3e} from float64, {m[t]:.3f} of row 35's bar "
            f"(against float64's own masks {smoke.rel_err(gk[t], g64[t]):.3e})")
    if label is not None:
        print(f"{card}: {label}: {line}", flush=True)
    return line, m, t


def part_lego(dev, card):
    import torch

    import chip_smoke as smoke

    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
    from nerf_rs_tpu_torch.models.mlp import NerfMLP

    bwd = smoke.main_path_backward_inputs(dev)
    lego_c, *args = bwd["coarse"]
    assets = find_lego_assets()
    lego = load_nerf_params(assets / "coarse")
    wide = smoke.widen_nerf(lego, 512, 256, 8)

    def on_card(tree):
        return {k: {p: torch.as_tensor(t, device=dev) for p, t in v.items()}
                for k, v in tree.items()}

    nets = [("lego coarse (narrow K2)", lego_c, on_card(lego)),
            ("lego coarse widened to 512/256/8 (wide K2)", NerfMLP(wide, device=dev),
             on_card(wide))]
    bar = smoke.BWD_BARS["float32"]
    for label, net, tree in nets:
        gk, gp, g64 = gradients(net, args, "float32", True)
        dist = {k: (smoke.rel_err(gk[k], g64[k]), smoke.rel_err(gp[k], g64[k])) for k in g64}
        margin = {k: d[0] / max(bar, smoke.F32_VS_PLAIN * d[1]) for k, d in dist.items()}
        leaf = max(margin, key=margin.get)
        top = sorted(margin, key=margin.get, reverse=True)[:4]
        print(f"{card}: {label} {tuple(args[0].shape[:-1])} float32 sigma-only: distances from "
              "float64 (kernel, plain): " + "; ".join(
                  f"{k} {dist[k][0]:.3e}, {dist[k][1]:.3e}" for k in top)
              + f"; tightest {leaf} at {margin[leaf]:.3f} of row 35's bar", flush=True)
        locate(card, label, net, tree, args, True, leaf)
        oracle_line(card, label, net, args, True, gk, gp, g64)
        for tau in TAUS:
            flip, n = flip_distance(net, args, True, tau)
            ok = all(dist[k][0] <= max(bar, smoke.F32_VS_PLAIN * max(dist[k][1], flip[k]))
                     for k in dist)
            print(f"{card}: {label}: masks within tau = 2^{round(math.log2(tau))} "
                  f"flipped: {n}; they move {leaf} {flip[leaf]:.3e} from float64 (largest "
                  f"{max(flip.values()):.3e}); every gradient within max(1e-4, 1.5 x plain, "
                  f"1.5 x that): {ok}", flush=True)


def part_random(dev, card, quick: bool):
    import torch

    import chip_smoke as smoke

    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_cuda import cotangents, inputs, np_params

    from nerf_rs_tpu_torch.config import ArchConfig
    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import fused_nerf_mlp_backward_reference

    archs = [ArchConfig(384, 192, 8, 4), ArchConfig(512, 512, 32, 10), ArchConfig(200, 264, 20, 1),
             ArchConfig(256, 128, 16, 4)]
    pts, dirs = inputs(37, 29, 5, dev)
    g_rgb, g_sig = cotangents(pts.shape[:-1], 6, dev)
    args = (pts, dirs, g_rgb, g_sig)
    for arch in archs[:1] if quick else archs:
        params = np_params(arch, 5)
        net = NerfMLP(params, device=dev)
        kind = "wide" if net.packed("float32").wide else "narrow"
        for dtype in ("float32", "bfloat16"):
            for so in (False, True):
                gk, gp, g64 = gradients(net, args, dtype, so)
                m, t = {None: 0.0}, None
                if dtype == "bfloat16":
                    ex = fused_nerf_mlp_backward_reference(net, *(a.double() for a in args),
                                                           dtype=dtype, sigma_only=so)
                    g64 = smoke.named_gradients(net.packed(dtype), ex)
                    kp = {k: smoke.rel_err(gk[k], gp[k]) for k in gp
                          if bool(gp[k].any()) or bool(gk[k].any())}
                    if not kp:
                        detail = "every gradient zero in the kernel and in the plain version"
                    else:
                        w = max(kp, key=kp.get)
                        detail = (f"worst kernel vs plain {w} {kp[w]:.3e} (kernel from "
                                  f"float64 {smoke.rel_err(gk[w], g64[w]):.3e}, plain "
                                  f"{smoke.rel_err(gp[w], g64[w]):.3e}); within 3e-2 of "
                                  f"plain: {kp[w] <= smoke.BWD_BARS[dtype]}")
                else:
                    detail, m, t = oracle_line(card, None, net, args, so, gk, gp, g64)
                label = (f"random {kind} {arch.width}/{arch.v_width}/{arch.depth} "
                         f"{tuple(pts.shape[:-1])} {dtype} {'sigma-only' if so else 'full'}")
                print(f"{card}: {label}: {detail}", flush=True)
                if dtype == "float32" and m[t] > 1.0:
                    tree = {k: {p: torch.from_numpy(a).to(dev) for p, a in v.items()}
                            for k, v in params.items()}
                    locate(card, label, net, tree, args, so, t)
                torch.cuda.empty_cache()


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true", help="one random network only")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    part_lego(dev, card)
    part_random(dev, card, args.quick)
    return 0


if __name__ == "__main__":
    sys.exit(main())
