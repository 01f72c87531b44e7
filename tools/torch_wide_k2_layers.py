#!/usr/bin/env python3
"""Where the wide K2 parts from its plain version, layer by layer: the
card test's random networks (``tests/test_torch_cuda.py``'s WIDE_ARCHS,
np_params seed 5, 37 rays x 29 samples, cotangents seed 6), each leaf's
gradient from the top layer down, as three relative distances
(||a - b|| / ||b||): kernel to plain, kernel to the float64 evaluation
(the plain version on float64 inputs: the same function, rounded where
the kernels round, without summation error) and plain to float64.

    python3 tools/torch_wide_k2_layers.py [--arch 512x512x32] [--dtype bfloat16] [--parent DIR]

Shows whether a gap opens at the heads and the recompute's masks, grows
down the trunk through W·dz, or appears only in dW. Prints the card's
name and power limit. Needs one CUDA card and nvcc. With ``--parent DIR``
(another version of ``csrc/``, e.g. the parent commit's unpacked into a
gitignored directory), every call runs that version's kernels instead,
built as ``tools/torch_k1_parent_ab.py`` builds them.

With ``--witness`` (bf16): the same call again, its round's workspace
kept (the per-tile kernel's H and dZ images, ``csrc/fused_mlp_wide_dw.cuh``),
and the backward evaluated in float64 on the kernel's own recomputed
activations and masks, rounded to bf16 where the kernel rounds: (a) one
step at a time, each layer's dZ from the kernel's own dZ above it (W·dz
and its rounding alone: relative distance and the share of entries that
differ); (b) as a chain from the kernel's view-layer dZ down, and each
layer's dW = H^T dZ from it, against the kernel's dW and the float64
evaluation. If the kernel lies as near the chain as the chain's own
roundings allow, its W·dz and dW compute the function on its
activations, and what parts it from plain comes from the activations.

With ``--activations`` (bf16): the same call's recomputed activations (the
wide bf16 forward's device code, ``csrc/fused_mlp_wide_tc.cuh``, which K2
runs for its recompute), layer by layer against (a) the plain version's
chain on the same inputs and (b) one step of the function from the
kernel's own layer input, evaluated in float64 and rounded to bf16 where
the plain version rounds: entries that differ, entries more than one bf16
ulp apart (the ulp of the larger magnitude) and the largest gap in ulps.
If (b) stays within one ulp everywhere, the kernel's rounding points and
operands are the plain version's and only the f32 summation order parts
them; the first layer where (a) exceeds one ulp on more than a handful of
entries is where the gap enters.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--arch", default="512x512x32")
    parser.add_argument("--dtype", action="append", choices=["float32", "bfloat16"])
    parser.add_argument("--witness", action="store_true",
                        help="bf16: the backward on the kernel's own activations")
    parser.add_argument("--activations", action="store_true",
                        help="bf16: the recomputed activations against plain, layer by layer")
    parser.add_argument("--parent", type=Path, default=None,
                        help="run another version's csrc/ (its *.cu and headers)")
    args = parser.parse_args()
    if args.parent is not None:
        import importlib.util
        import tempfile

        sys.path.insert(0, str(REPO))
        spec = importlib.util.spec_from_file_location(
            "torch_k1_parent_ab", REPO / "tools" / "torch_k1_parent_ab.py")
        ab = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ab)
        lib = ab.build_other(args.parent, Path(tempfile.mkdtemp(prefix="layers_")))[0]
        from nerf_rs_tpu_torch.ops.kernels import _build

        _build.load_library = lambda: lib
        print(f"the kernels of {args.parent}", flush=True)
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import chip_smoke as smoke
    from test_torch_cuda import WIDE_ARCHS, WIDE_IDS, cotangents, inputs, np_params

    from nerf_rs_tpu_torch.models.mlp import NerfMLP
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
        fused_nerf_mlp_backward,
        fused_nerf_mlp_backward_reference,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    arch = WIDE_ARCHS[WIDE_IDS.index(args.arch)]
    net = NerfMLP(np_params(arch, 5), device=dev)
    pts, dirs = inputs(37, 29, 5, dev)
    g_rgb, g_sig = cotangents(pts.shape[:-1], 6, dev)
    call = (pts, dirs, g_rgb, g_sig)
    order = (["rgb", "viewdirs", "bottleneck", "alpha"]
             + [f"dense{i}" for i in range(arch.depth - 1, -1, -1)])
    for dtype in args.dtype or ["bfloat16", "float32"]:
        pk = net.packed(dtype)
        got = smoke.named_gradients(pk, fused_nerf_mlp_backward(net, *call, dtype=dtype))
        plain = smoke.named_gradients(pk, fused_nerf_mlp_backward_reference(net, *call,
                                                                            dtype=dtype))
        exact = smoke.named_gradients(pk, fused_nerf_mlp_backward_reference(
            net, *(x.double() for x in call), dtype=dtype))
        print(f"{card}: wide K2 {dtype}, random {args.arch} (seed 5), 37 x 29 samples; "
              "kernel-plain, kernel-float64, plain-float64:", flush=True)
        keys = [f"{layer}/{part}" for layer in order for part in ("kernel", "bias")]
        for key in keys + ["d(points)", "d(dirs)"]:
            if key not in plain or not plain[key].any():
                continue
            print(f"    {key:18s} {rel(got[key], plain[key]):.3e} {rel(got[key], exact[key]):.3e} "
                  f"{rel(plain[key], exact[key]):.3e}", flush=True)
        if args.witness and dtype == "bfloat16":
            witness(net, call, card, args.arch, exact)
        if args.activations and dtype == "bfloat16":
            activations(net, call, card, args.arch)
    return 0


class KeepWorkspace:
    """The kernels' library, but the wide bf16 per-tile kernel and the dW
    kernel get ``self.ws`` as their workspace, so that it outlives the call
    (one round: the call's tiles must fit in one)."""

    def __init__(self, lib, nbytes, device):
        import torch

        self.lib, self.ws = lib, torch.zeros(nbytes, dtype=torch.uint8, device=device)

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        at = {"nerf_wide_bwd_bf16_tiles": 14, "nerf_wide_dw": 0}.get(name)
        if at is None:
            return fn

        def call(*a):
            a = list(a)
            a[at] = self.ws.data_ptr()
            return fn(*a)
        return call


def kept_workspace(net, call):
    """The bf16 K2 call once more, its round's workspace kept -> (its
    output, the pack, n, tiles, slot): slot(s, width) reads workspace slot
    s's values, (n, width) float64 (csrc/fused_mlp_wide_dw.cuh)."""
    import torch

    from nerf_rs_tpu_torch.ops.kernels import _build
    from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm

    dev = call[0].device
    pk = net.packed("bfloat16")
    n = call[0].numel() // 3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fm.wide_plan(pk, n, sms, sigma_only=False)
    if plan.rounds != 1:
        raise RuntimeError("the witness reads one round's workspace: the call must fit in one")
    keep = KeepWorkspace(_build.load_library(), plan.ws_bytes, dev)
    load = _build.load_library
    fm._build.load_library = lambda: keep
    try:
        out = fm.fused_nerf_mlp_backward(net, *call, dtype="bfloat16")
    finally:
        fm._build.load_library = load
    torch.cuda.synchronize()
    cols = fm.wide_slot_cols(pk)
    tiles = plan.round_tiles

    def slot(s, width):
        """Slot s's values, (n, width) float64 (csrc/fused_mlp_wide_dw.cuh)."""
        c = cols[s]
        r = torch.arange(64, device=dev)[:, None]
        k = torch.arange(c, device=dev)[None, :]
        off = (k >> 3) * 1024 + (r >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2
        t = torch.arange(tiles, device=dev)[:, None, None]
        idx = (128 * sum(cols[:s]) * tiles + t * 128 * c + off[None]) // 2
        v = keep.ws.view(torch.int16)[idx.reshape(-1)].view(torch.bfloat16)
        return v.reshape(tiles * 64, c)[:n, :width].double()

    return out, pk, n, tiles, slot


def activations(net, call, card, arch_name) -> None:
    import torch

    from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm

    _, pk, n, tiles, slot = kept_workspace(net, call)
    depth, w = pk.depth, pk.width
    pts, _ = fm._flat_inputs(call[0], call[1])

    def bf16(x):
        return x.to(torch.bfloat16).to(x.dtype)

    def mat(name, dt=torch.float32):
        return pk.mat(name).to(dt)

    def bias(name, dt=torch.float32):
        return pk.bias(name).to(dt)

    enc_plain = bf16(fm._encode(pts, 10, 64))
    hs = fm._trunk(mat, bias, enc_plain, bf16, depth, pk.segments)
    hs.append(bf16(fm._dense([(hs[-1], mat("bottleneck"))], bias("bottleneck"))))
    hs = [h[:, :w] for h in hs]
    kern = [slot(2 + i, pk.ldw)[:, :w] for i in range(depth + 1)]   # depth: the bottleneck
    enc_k = slot(0, 64)

    def ulp_gap(a, b):
        """(entries that differ, entries more than one bf16 ulp apart, the
        largest gap in ulps), the ulp of the larger magnitude."""
        a, b = a.double(), b.double()
        big = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
        ulps = (a - b).abs() / torch.exp2(torch.floor(torch.log2(big)) - 7)
        return int((a != b).sum()), int((ulps > 1).sum()), round(float(ulps.max()), 3)

    def step(i):
        """Layer i from the kernel's own input, float64, rounded as plain."""
        e = enc_k.double()
        if i == 0:
            z = e @ mat("dense0", torch.float64) + bias("dense0", torch.float64)
        else:
            name = "bottleneck" if i == depth else f"dense{i}"
            z = kern[i - 1] @ mat(name, torch.float64)[:w] + bias(name, torch.float64)
            if f"dense{i}_enc" in pk.segments:
                z = z + e @ mat(f"dense{i}_enc", torch.float64)
        z = z[:, :w]
        return bf16(z if i == depth else torch.relu(z))

    print(f"{card}: wide bf16 forward (K2's recompute) activations, random {arch_name}, {n} "
          f"samples, {tiles} tiles: layer, (a) kernel vs the plain chain, (b) kernel vs one "
          "float64 step from its own input: entries that differ, entries > 1 ulp, max ulps "
          f"(of {n * w} entries a layer)", flush=True)
    print(f"        {'encode':12s} (a) {ulp_gap(enc_k[:, :63], enc_plain[:, :63])}", flush=True)
    for i in range(depth + 1):
        name = "bottleneck" if i == depth else f"dense{i}"
        print(f"        {name:12s} (a) {ulp_gap(kern[i], hs[i])} (b) {ulp_gap(kern[i], step(i))}",
              flush=True)


def witness(net, call, card, arch_name, exact) -> None:
    import torch

    import chip_smoke as smoke

    out, pk, n, tiles, slot = kept_workspace(net, call)
    depth, ldw, ldv = pk.depth, pk.ldw, pk.ldv

    def bf16(x):
        return x.to(torch.bfloat16).double()

    def mat(name):
        return pk.mat(name).to(torch.bfloat16).double()

    def differ(a, b):
        return float((a != b).double().mean())

    h = {i: slot(2 + i, ldw) for i in range(depth + 1)}          # depth: the bottleneck
    dz = {i: slot(3 + depth + i, ldw) for i in range(depth + 1)}
    dz_view = slot(4 + 2 * depth, ldv)
    enc_x, enc_d = slot(0, 64), slot(1, 32)
    g_sigma = call[3].reshape(-1).double()
    w_alpha = mat("alpha")[:, 0]
    pre = h[depth - 1] @ w_alpha + pk.bias("alpha").double()
    gs = bf16(torch.where(pre > 0, g_sigma, torch.zeros_like(g_sigma)))

    def step(i, above):
        """Layer i's dZ (i = depth - 1: d(h_last)) from the dZ above it."""
        if i == depth:                                   # the bottleneck: no activation
            return bf16(above @ mat("viewdirs").T)
        if i == depth - 1:
            z = above @ mat("bottleneck").T + gs[:, None] * w_alpha[None, :]
        else:
            z = above @ mat(f"dense{i + 1}").T
        return bf16(torch.where(h[i] > 0, z, torch.zeros_like(z)))

    print(f"{card}: wide K2 bfloat16, random {arch_name}, witness on the kernel's own "
          f"activations ({n} samples, one round of {tiles} tiles):", flush=True)
    print("    (a) one step: layer, dZ kernel-step relative distance, share of entries "
          "that differ", flush=True)
    above = dz_view
    for i in range(depth, -1, -1):
        want = step(i, above)
        print(f"        {('bottleneck' if i == depth else f'dense{i}'):12s} "
              f"{rel(dz[i], want):.3e} {differ(dz[i], want):.3e}", flush=True)
        above = dz[i]
    chain, above = {}, dz_view
    for i in range(depth, -1, -1):
        chain[i] = above = step(i, above)
    got = smoke.named_gradients(pk, out)
    w_ = pk.width
    inputs = {"dense0": enc_x, "bottleneck": h[depth - 1][:, :w_], "viewdirs": h[depth][:, :w_]}
    inputs.update({f"dense{i}": h[i - 1][:, :w_] for i in range(1, depth)})
    grads = {"viewdirs": dz_view, "bottleneck": chain[depth]}
    grads.update({f"dense{i}": chain[i] for i in range(depth)})
    print("    (b) chain: leaf, kernel-chain, chain-float64, kernel-float64 (relative)",
          flush=True)
    for name in ["viewdirs", "bottleneck"] + [f"dense{i}" for i in range(depth - 1, -1, -1)]:
        key = f"{name}/kernel"
        k = got[key].double()
        x = inputs[name][:, :k.shape[0]]
        if name == "viewdirs":
            x = torch.cat([inputs[name], enc_d[:, :27]], 1)
        elif name == "dense0":
            x = enc_x[:, :k.shape[0]]
        elif f"{name}_enc" in pk.segments:          # the skip layer: [encode, h]
            x = torch.cat([enc_x[:, :63], inputs[name]], 1)[:, :k.shape[0]]
        w = x.T @ grads[name][:, :k.shape[1]]
        print(f"        {key:20s} {rel(k, w):.3e} {rel(w, exact[key]):.3e} "
              f"{rel(k, exact[key]):.3e}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
