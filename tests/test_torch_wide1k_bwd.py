"""PyTorch port, K2 past width 512: the gradients of networks with a trunk
or view width from 513 up to 1024, which the backward kernel K2 serves on
the card through the wide1k forwards' record modes
(``csrc/fused_mlp_wide1k_f32tc.cu``, ``csrc/fused_mlp_wide1k_tc.cu``), the
half-tile backward ``csrc/fused_mlp_wide1k_bwd.cu`` and the dW kernel.

On the CPU the wrappers run the plain versions: the port's K2 plain
version on a wide1k pack (through the autograd function ``_FusedMLP``)
against ``jax.grad`` of the JAX package's fused MLP (its Pallas backward
kernel in interpret mode, as tests/test_torch_wide_bwd.py runs it at 512),
at that file's bars. The layouts the half-tile backward reads and writes
are held to the plain backward by emulating its dataflow in float64: the
record in ``fused_mlp_f32tc.cuh``'s ws_index order, the workspace images
of ``csrc/fused_mlp_wide_dw.cuh`` written 32 rows at a time, the
transposed pack ``mma_wt`` through ``layout_mma``, the heads through
``layout``, the per-CTA small sums, and the dW kernel's job table
(tests/test_torch_wide_dw.py's emulation). The kernels are held to the
same plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 29 (f))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.ops.kernels.fused_mlp import fused_nerf_mlp as jax_fused_nerf_mlp
from nerf_rs_tpu_torch.config import ArchConfig
from nerf_rs_tpu_torch.io.weights import params_to_torch
from nerf_rs_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import (
    fused_nerf_mlp,
    fused_nerf_mlp_backward,
    fused_nerf_mlp_backward_reference,
    pack_params,
    unpack_grads,
)
from test_torch_fused_mlp_bwd import mma_segments, np_params, np_rays, torch_leaves, untile_mma
from test_torch_wide_bwd import ATOL, BF16_REL, BF16_VS_JAX, COLOR, F32_INPUT_REL, RTOL, rel
from test_torch_wide_dw import bf16_bits, emulate_dw, image_offsets, image_start

torch.set_num_threads(1)

# (width, v_width, depth, skip_at): mip-NeRF 360's trunk width with the
# NeRF view width, and widths past 512 with narrower view branches.
WIDE1K = [ArchConfig(1024, 512, 3, 1), ArchConfig(768, 128, 3, 1), ArchConfig(640, 256, 3, 1)]
WIDE1K_IDS = ["1024x512x3", "768x128x3", "640x256x3"]
KMAX = fm.MAX_DEPTH                       # layer slots of a wide table


@pytest.fixture(scope="module", params=WIDE1K, ids=WIDE1K_IDS)
def wide1k(request):
    return request.param, np_params(request.param, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sigma_only", [False, True])
def test_wide1k_grads_match_jax_fused_kernel(wide1k, sigma_only, dtype, monkeypatch):
    """Parameter, point and per-ray dir gradients of sum(g_rgb * rgb +
    g_sigma * sigma) through the port's fused MLP on CPU tensors (K2's
    plain version on a wide1k pack) against jax.grad of the JAX kernel at
    the same widths, 64 samples, at tests/test_torch_wide_bwd.py's bars:
    f32 parameter gradients elementwise, input gradients as a relative
    norm; bf16 (JAX's encode with exact sin) each gradient within max(3e-2,
    1.5 x JAX's distance) of the float64 evaluation. With sigma_only the
    rgb cotangent gives the color branch no gradient in either package."""
    arch, params = wide1k
    monkeypatch.setenv("NERF_FUSED_TRIG", "exact")
    pts, dirs, g_rgb, g_sig = np_rays(2, 32, 1)

    def jax_loss(p, x, d):
        rgb, sig = jax_fused_nerf_mlp(p, x, d, sigma_only=sigma_only, dtype=dtype)
        return jnp.sum(rgb * g_rgb) + jnp.sum(sig * g_sig)

    want_p, want_x, want_d = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(pts), jnp.asarray(dirs))
    leaves = torch_leaves(params)
    x = torch.tensor(pts, requires_grad=True)
    d = torch.tensor(dirs, requires_grad=True)
    tree = params_to_torch(params, "cpu")
    assert pack_params(tree, dtype).wide1k
    rgb, sig = fused_nerf_mlp(leaves, x, d, sigma_only=sigma_only, dtype=dtype)
    (torch.sum(rgb * torch.from_numpy(g_rgb)) + torch.sum(sig * torch.from_numpy(g_sig))).backward()
    got = {f"{layer}/{part}": t.grad.numpy() for layer, p in leaves.items()
           for part, t in p.items()}
    want = {f"{layer}/{part}": np.asarray(want_p[layer][part]) for layer in params
            for part in ("kernel", "bias")}
    got.update(points=x.grad.numpy(), dirs=d.grad.numpy())
    want.update(points=np.asarray(want_x), dirs=np.asarray(want_d))
    out = fused_nerf_mlp_backward_reference(
        tree, *(torch.from_numpy(a).double() for a in (pts, dirs, g_rgb, g_sig)), dtype=dtype,
        sigma_only=sigma_only)
    leaves64 = unpack_grads(pack_params(tree, dtype), out[0], out[1])
    exact = {f"{layer}/{part}": leaves64[layer][part].numpy() for layer in params
             for part in ("kernel", "bias")}
    exact.update(points=out[2].numpy(), dirs=out[3].sum(1, keepdim=True).numpy())
    for name, w in want.items():
        if sigma_only and name.split("/")[0] in COLOR:
            assert not got[name].any() and not w.any(), name
        elif dtype == "float32" and name in ("points", "dirs"):
            assert rel(got[name], w) <= F32_INPUT_REL, (name, rel(got[name], w))
        elif dtype == "float32":
            np.testing.assert_allclose(got[name], w, atol=ATOL, rtol=RTOL, err_msg=name)
        else:
            bar = max(BF16_REL, BF16_VS_JAX * rel(w, exact[name]))
            assert rel(got[name], exact[name]) <= bar, (name, rel(got[name], exact[name]), bar)


def test_wide1k_backward_wrapper_on_cpu_is_the_reference_and_counts_no_launch(wide1k):
    """K2's wrapper on CPU tensors of a network past width 512: the plain
    version, no launch counted (wide1k or not), in both dtypes."""
    _, params = wide1k
    pts, dirs, g_rgb, g_sig = (torch.from_numpy(a) for a in np_rays(2, 24, 5))
    tree = params_to_torch(params, "cpu")
    counts = ("launches", "wide_launches", "wide1k_launches", "dw_launches")
    before = [getattr(fused_nerf_mlp_backward, c) for c in counts]
    for dtype in ("float32", "bfloat16"):
        got = fused_nerf_mlp_backward(tree, pts, dirs, g_rgb, g_sig, dtype=dtype)
        want = fused_nerf_mlp_backward_reference(tree, pts, dirs, g_rgb, g_sig, dtype=dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [getattr(fused_nerf_mlp_backward, c) for c in counts] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide1k_transposed_pack_round_trip(wide1k, dtype):
    """A wide1k pack of either dtype holds the transposed pack the half-tile
    backward reads: layout_mma has 2 x 32 + 3 entries; each segment reads
    back through the inverse of its tiling as hi + lo, within 2^-22 of the
    f32 weight (f32), or as hi equal to the bf16 weight and lo zero (bf16:
    tf32 holds a bf16 value exactly, so one tf32 product is the bf16
    product); padding zero; every element belongs to one segment."""
    arch, params = wide1k
    pk = pack_params(params_to_torch(params, "cpu"), dtype)
    assert pk.wide1k and pk.layout_mma.size == 2 * KMAX + 3
    assert (pk.layout_mma[arch.depth:KMAX] == -1).all()
    hi, lo = pk.mma_wt[0], pk.mma_wt[1]
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    covered = np.zeros(hi.numel(), np.int64)
    for name, (slot, k, ld) in mma_segments(pk, arch).items():
        want = pk.mat(name).double().numpy().T
        kp, n = -(-want.shape[0] // 16) * 16, want.shape[1]
        off = int(pk.layout_mma[slot])
        got_hi, idx = untile_mma(hi.double().numpy(), off, kp, n)
        got_lo, _ = untile_mma(lo.double().numpy(), off, kp, n)
        np.add.at(covered, idx.reshape(-1), 1)
        r = want.shape[0]
        if dtype == "bfloat16":
            assert np.array_equal(got_hi[:r], want) and not got_lo.any(), name
        else:
            err = np.abs(got_hi[:r] + got_lo[:r] - want)
            assert (err <= 2.0 ** -22 * np.abs(want)).all(), (name, float(err.max()))
        assert not got_hi[r:].any() and not got_lo[r:].any(), name
    assert (covered == 1).all()


def ws_index(row, col, n8):
    """csrc/fused_mlp_f32tc.cuh's ws_index: where (sample row, feature col)
    lies in a record slot of n8 feature blocks."""
    r = row & 15
    return ((((row >> 4) * n8 + (col >> 3)) * 32 + 4 * (col & 7) + (r & 3)) * 4 + (r >> 2))


def emulate_wide1k_backward(pk, pts, dirs, g_rgb, g_sig, sigma_only):
    """nerf_wide1k_bwd_tiles's dataflow over one round of every tile, in
    float64 with its rounding points, its operands read only where the
    kernel reads them: the recompute's outputs from the record (f32, per
    tile in ws_index order, slot i at 64 (96 + i ldw)) or the workspace
    images (bf16; the view output from an image of its own); each half
    tile's output gradients written to rows 32 h .. of their workspace
    images (f32 split into three planes) and read back; W^T from mma_wt at
    layout_mma's offsets (dense i, its encode part at 32 + i, the
    bottleneck, viewdirs and its dir part at 64, 65, 66); the heads from
    ``weights`` at ``layout``'s offsets; the biases and heads summed into a
    small partial (n_b biases, ldw alpha, 3 ldv rgb). Then the dW kernel's
    emulation on that workspace. -> (dweights, dbiases, dpts, ddirs)."""
    f32 = pk.dtype == "float32"
    rnd = (lambda x: x) if f32 else (lambda x: x.to(torch.bfloat16).double())
    n = pts.shape[0]
    tiles = -(-n // 64)
    rows = 64 * tiles

    def pad(a):
        return torch.nn.functional.pad(a, (0, 0, 0, rows - n))

    x_in, d_in, gr_in, gs_in = (pad(a) for a in (pts, dirs, g_rgb, g_sig[:, None]))
    nw, nv = (-(-ld // 64) * 64 for ld in (pk.ldw, pk.ldv))
    depth, ldw, ldv = pk.depth, pk.ldw, pk.ldv
    planes = fm.wide_planes(pk.dtype)
    cols = fm.wide_slot_cols(pk)
    ws = np.zeros(128 * planes * tiles * sum(cols), np.uint8)
    dz = lambda i: 3 + depth + i  # noqa: E731

    def put(s, r, width, x):
        """x (row block r of 32 rows of every tile, `width` columns of
        slot s) into the images, split in f32."""
        vals = np.zeros((tiles * 32, cols[s]), np.float32)
        vals[:, :width] = x.float().numpy()
        pieces = fm.bf16_split3(torch.from_numpy(vals)) if f32 else [torch.from_numpy(vals)]
        offs = image_offsets(cols[s])[32 * r:32 * r + 32]
        for t in range(tiles):
            for q, p in enumerate(pieces):
                start = image_start(pk, tiles, s, t, q)
                ws.view(np.uint16)[(start + offs) // 2] = bf16_bits(p[32 * t:32 * t + 32].numpy())

    def get(s, r, width):
        """Rows r of every tile of slot s back from its images (f32: hi +
        mid + lo)."""
        offs = image_offsets(cols[s])[32 * r:32 * r + 32, :width]
        out = np.zeros((tiles * 32, width))
        for t in range(tiles):
            for q in range(planes):
                start = image_start(pk, tiles, s, t, q)
                bits = ws.view(np.uint16)[(start + offs) // 2]
                out[32 * t:32 * t + 32] += torch.from_numpy(bits.view(np.int16)).view(
                    torch.bfloat16).double().numpy()
        return torch.from_numpy(out)

    # The recompute (the plain forward stands in for K1's record mode).
    with torch.no_grad():
        rnd32 = fm._rounder(pk.dtype)
        enc_x = rnd32(fm._encode(x_in.float(), 10, fm._ENC_X))
        hs = fm._trunk(pk.mat, pk.bias, enc_x, rnd32, depth, pk.segments)
        enc_d = rnd32(fm._encode(d_in.float(), 4, fm._ENC_D))
        bneck, hv = fm._color_branch(pk.mat, pk.bias, hs[-1], enc_d, rnd32)
    outs = hs + [bneck, hv]
    record = np.zeros((tiles, 64 * (96 + (depth + 1) * ldw + ldv)), np.float32)
    for i, o in enumerate(outs):
        ld = ldv if i == depth + 1 else ldw
        rr, cc = np.meshgrid(np.arange(64), np.arange(ld), indexing="ij")
        for t in range(tiles):
            record[t, 64 * (96 + i * ldw) + ws_index(rr, cc, ld >> 3)] = (
                o[64 * t:64 * t + 64, :ld].numpy())
    # bf16: the view outputs' images (128 nv bytes a tile), as the record writes them.
    view_img = np.zeros(tiles * 64 * nv, np.uint16)
    for t in range(tiles):
        vals = np.zeros((64, nv), np.float32)
        vals[:, :ldv] = hv[64 * t:64 * t + 64, :ldv].numpy()
        view_img[t * 64 * nv + image_offsets(nv) // 2] = bf16_bits(vals)
    for s, x in ((0, enc_x), (1, enc_d), *((2 + i, o) for i, o in enumerate(outs[:depth + 1]))):
        for r in (0, 1):
            put(s, r, x.shape[1], torch.cat([x[64 * t + 32 * r:64 * t + 32 * r + 32]
                                             for t in range(tiles)]).double())

    def wt(slot, k_red, n_out):
        """W^T (k_red x n_out) from the transposed pack, hi + lo."""
        off = int(pk.layout_mma[slot])
        kp = -(-k_red // 16) * 16
        hi, _ = untile_mma(pk.mma_wt[0].double().numpy(), off, kp, n_out)
        lo, _ = untile_mma(pk.mma_wt[1].double().numpy(), off, kp, n_out)
        return torch.from_numpy(hi + lo)[:k_red]

    w = pk.weights.double()
    w_alpha = w[pk.layout[2 * KMAX]:][:ldw]
    w_rgb = w[pk.layout[2 * KMAX + 4]:][:3 * ldv].reshape(ldv, 3)
    b = pk.biases.double()
    b_dense = [int(pk.layout[2 * KMAX + 5 + i]) for i in range(depth)]
    b_alpha, b_bneck, b_view, b_rgb = (int(pk.layout[3 * KMAX + 5 + j]) for j in range(4))
    n_b = pk.biases.numel()
    small = torch.zeros(n_b + ldw + 3 * ldv, dtype=torch.float64)
    dpts, ddirs = torch.zeros(rows, 3, dtype=torch.float64), torch.zeros(rows, 3,
                                                                           dtype=torch.float64)
    for r in (0, 1):                                    # the half tiles' rows of every tile
        sel = torch.cat([torch.arange(64 * t + 32 * r, 64 * t + 32 * r + 32)
                         for t in range(tiles)])

        def rec(i, ld):
            rr, cc = np.meshgrid(32 * r + np.arange(32), np.arange(ld), indexing="ij")
            base = 64 * (96 + i * ldw)
            return torch.from_numpy(np.concatenate(
                [record[t, base + ws_index(rr, cc, ld >> 3)] for t in range(tiles)])).double()

        def layer_out(i):                               # a trunk output, where the kernel reads it
            return rec(i, ldw) if f32 else get(2 + i, r, ldw)

        gs, gr = gs_in[sel].double(), gr_in[sel].double()
        x = layer_out(depth - 1)
        gs = rnd(gs * ((x @ w_alpha + b[b_alpha]) > 0)[:, None])
        small[n_b:n_b + ldw] += x.t() @ gs[:, 0]
        small[b_alpha] += gs.sum()
        if not sigma_only:
            if f32:
                xv = rec(depth + 1, ldv)
            else:
                offs = image_offsets(nv)[32 * r:32 * r + 32, :ldv] // 2
                xv = torch.cat([torch.from_numpy(view_img[t * 64 * nv + offs].view(np.int16)).view(
                    torch.bfloat16).double() for t in range(tiles)])
            pre = xv @ w_rgb + b[b_rgb:b_rgb + 3]
            gr = rnd(gr * torch.sigmoid(pre) * torch.sigmoid(-pre))
            small[n_b + ldw:] += (xv.t() @ gr).reshape(-1)
            small[b_rgb:b_rgb + 3] += gr.sum(0)
            x = rnd((gr @ w_rgb.t()) * (xv > 0))
            put(4 + 2 * depth, r, ldv, x)
            x = get(4 + 2 * depth, r, ldv)
            small[b_view:b_view + ldv] += x.sum(0)
            de_d = x @ wt(2 * KMAX + 2, ldv, fm._ENC_D)
            x = rnd(x @ wt(2 * KMAX + 1, ldv, ldw))
            put(dz(depth), r, ldw, x)
            x = get(dz(depth), r, ldw)
            ddirs[sel] = fm._encode_vjp(d_in[sel].double(), de_d, 4)
            small[b_bneck:b_bneck + ldw] += x.sum(0)
            x = x @ wt(2 * KMAX, ldw, ldw) + gs * w_alpha
        else:
            x = gs * w_alpha
        x = rnd(x * (layer_out(depth - 1) > 0))
        put(dz(depth - 1), r, ldw, x)
        x = get(dz(depth - 1), r, ldw)
        de_x = torch.zeros(32 * tiles, fm._ENC_X, dtype=torch.float64)
        for i in range(depth - 1, 0, -1):
            small[b_dense[i]:b_dense[i] + ldw] += x.sum(0)
            if f"dense{i}_enc" in pk.segments:
                de_x += x @ wt(KMAX + i, ldw, fm._ENC_X)
            x = rnd((x @ wt(i, ldw, ldw)) * (layer_out(i - 1) > 0))
            put(dz(i - 1), r, ldw, x)
            x = get(dz(i - 1), r, ldw)
        small[b_dense[0]:b_dense[0] + ldw] += x.sum(0)
        de_x += x @ wt(0, ldw, fm._ENC_X)
        dpts[sel] = fm._encode_vjp(x_in[sel].double(), de_x, 10)
    dweights = torch.from_numpy(emulate_dw(pk, fm.wide_dw_jobs(pk, sigma_only), ws, tiles))
    dweights[pk.segments["alpha"][0]:][:ldw] = small[n_b:n_b + ldw]
    dweights[pk.segments["rgb"][0]:][:3 * ldv] = small[n_b + ldw:]
    return dweights, small[:n_b], dpts[:n], ddirs[:n]


@pytest.mark.parametrize("sigma_only", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [ArchConfig(640, 136, 3, 1), ArchConfig(520, 576, 2, 1)],
                         ids=["640x136x3", "520x576x2_unaligned"])
def test_wide1k_backward_dataflow_emulated_gives_the_plain_backward(arch, dtype, sigma_only):
    """The half-tile backward's dataflow (emulate_wide1k_backward: the
    record, the workspace images a half tile at a time, the transposed
    pack and the heads through their tables, the small sums, the dW jobs)
    on 100 samples (two tiles, the second ragged) gives the plain
    backward's gradients: every weight, bias, point and dir gradient within
    1e-5 of it relative to its norm in f32 (float64 products against f32
    sums), 3e-2 in bf16 (float64 sums flip a bf16 rounding of an output
    gradient where f32 sums round the other way)."""
    params = params_to_torch(np_params(arch, 2), "cpu")
    pk = pack_params(params, dtype)
    assert pk.wide1k
    pts, dirs, g_rgb, g_sig = (torch.from_numpy(a) for a in np_rays(4, 25, 3))
    flat = (pts.reshape(-1, 3), torch.broadcast_to(dirs, pts.shape).reshape(-1, 3).contiguous(),
            g_rgb.reshape(-1, 3), g_sig.reshape(-1))
    got = emulate_wide1k_backward(pk, *flat, sigma_only)
    want = fused_nerf_mlp_backward_reference(pk, *flat, dtype=dtype, sigma_only=sigma_only)
    bar = 1e-5 if dtype == "float32" else 3e-2
    gk, gp = unpack_grads(pk, got[0], got[1]), unpack_grads(pk, want[0], want[1])
    for layer in gp:
        for part in ("kernel", "bias"):
            w = gp[layer][part]
            if sigma_only and layer in COLOR:
                assert not gk[layer][part].any() and not w.any(), layer
                continue
            assert rel(gk[layer][part].numpy(), w.numpy()) <= bar, (
                layer, part, rel(gk[layer][part].numpy(), w.numpy()))
    for g, w, name in ((got[2], want[2], "points"), (got[3], want[3], "dirs")):
        if sigma_only and name == "dirs":
            assert not w.any()
            continue
        assert rel(g.numpy(), w.numpy()) <= bar, (name, rel(g.numpy(), w.numpy()))
