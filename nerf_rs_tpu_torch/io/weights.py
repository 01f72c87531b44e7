"""Weight I/O for the reference `.bin` format and `.npz` bundles.

Each network is a directory of raw little-endian f32 row-major tensors plus
a ``shapes.txt`` manifest (one ``name dim0 [dim1]`` per line); a bundle
holds both networks and the golden JSON in one file. Loading gives
the param tree ``{layer: {"kernel": (in, out), "bias": (out,)}}`` as numpy
arrays, the same tree the JAX package builds; :func:`params_to_torch` turns
that tree into tensors. The same numpy tree fed to both packages is how the
tests hold the port against the JAX reference.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

ASSET_ENV_VAR = "NERF_RS_TPU_ASSETS"
_REPO_ASSETS = Path(__file__).resolve().parents[2] / "assets" / "lego_rust"

# The lego architecture's layer shapes (coarse and fine are identical):
# dense0 63x256, dense1-4 256x256, dense5 319x256 (skip), dense6-7 256x256,
# bottleneck 256x256, viewdirs 283x128, rgb 128x3, alpha 256x1.
CANONICAL_SHAPES: Dict[str, Tuple[int, int]] = {
    **{f"dense{i}": (63 if i == 0 else 319 if i == 5 else 256, 256) for i in range(8)},
    "bottleneck": (256, 256),
    "viewdirs": (283, 128),
    "rgb": (128, 3),
    "alpha": (256, 1),
}


def find_lego_assets() -> Optional[Path]:
    """Locate the pretrained lego weights — a directory with coarse/ +
    fine/ + golden JSON, or a single-file ``.npz`` bundle
    (:func:`save_bundle`): ``$NERF_RS_TPU_ASSETS`` first, then the
    repository's ``assets/lego_rust``. Returns None when neither holds
    the weights."""
    candidates = []
    if os.environ.get(ASSET_ENV_VAR):
        candidates.append(Path(os.environ[ASSET_ENV_VAR]))
    candidates.append(_REPO_ASSETS)
    for p in candidates:
        if p.suffix == ".npz" and p.is_file():
            return p
        if (p / "coarse" / "shapes.txt").exists() and (p / "fine" / "shapes.txt").exists():
            return p
    return None


def read_shapes(path: Path) -> List[Tuple[str, Tuple[int, ...]]]:
    """Parse a ``shapes.txt`` manifest (name followed by dims, whitespace-split)."""
    entries: List[Tuple[str, Tuple[int, ...]]] = []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if parts:
            entries.append((parts[0], tuple(int(d) for d in parts[1:])))
    return entries


def _read_tensor(path: Path, dims: Tuple[int, ...]) -> np.ndarray:
    arr = np.fromfile(path, dtype="<f4")
    expected = int(np.prod(dims)) if dims else arr.size
    if arr.size != expected:
        raise ValueError(f"{path}: expected {expected} f32 values, got {arr.size}")
    return arr.reshape(dims)


def param_layer_names(params_or_keys) -> Tuple[str, ...]:
    """Ordered layer list for any ArchConfig family member: dense0..N in
    index order, then the four heads."""
    keys = set(params_or_keys)
    dense = sorted((k for k in keys if re.fullmatch(r"dense\d+", k)),
                   key=lambda k: int(k[5:]))
    heads = tuple(h for h in ("bottleneck", "viewdirs", "rgb", "alpha") if h in keys)
    return tuple(dense) + heads


def load_raw_params(directory: os.PathLike) -> Dict[str, np.ndarray]:
    """Load every tensor named in ``shapes.txt`` from ``directory``."""
    directory = Path(directory)
    return {name: _read_tensor(directory / f"{name}.bin", dims)
            for name, dims in read_shapes(directory / "shapes.txt")}


def load_nerf_params(directory: os.PathLike,
                     dtype=np.float32) -> Dict[str, Dict[str, np.ndarray]]:
    """Assemble the numpy param tree from a reference-format directory,
    refusing tensors that no layer consumes and trees whose layers do not
    chain (:func:`validate_param_chain`)."""
    raw = load_raw_params(directory)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    layers = param_layer_names(
        {n[: -len("_kernel")] for n in raw if n.endswith("_kernel")})
    for layer in layers:
        kernel = raw.pop(f"{layer}_kernel")
        bias = raw.pop(f"{layer}_bias")
        if kernel.ndim != 2:
            raise ValueError(f"{layer}_kernel must be rank-2, got {kernel.shape}")
        if bias.shape != (kernel.shape[1],):
            raise ValueError(
                f"{layer}_bias shape {bias.shape} does not match kernel {kernel.shape}")
        params[layer] = {"kernel": kernel.astype(dtype), "bias": bias.astype(dtype)}
    if raw:
        raise ValueError(f"unused parameters left after load: {sorted(raw)}")
    validate_param_chain(params)
    return params


def params_to_torch(params, device, dtype=torch.float32) -> Dict[str, Dict[str, torch.Tensor]]:
    """The weight bridge: a numpy (or array-like) param tree as tensors of
    ``dtype`` on ``device``, layer by layer."""
    return {
        layer: {part: torch.as_tensor(np.asarray(arr), dtype=dtype, device=device)
                for part, arr in p.items()}
        for layer, p in params.items()
    }


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype="<f4")


def _tree(params):
    return params.tree() if hasattr(params, "tree") else params


def save_nerf_params(directory: os.PathLike, params) -> None:
    """Write one network (a param tree or a NerfMLP) in the reference
    format: ``{layer}_kernel.bin`` and ``{layer}_bias.bin`` as raw
    little-endian f32, and the ``shapes.txt`` manifest, layer by layer in
    :func:`param_layer_names` order — the bytes the JAX package's
    ``save_nerf_params`` writes for the same tree."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    params = _tree(params)
    lines = []
    for layer in param_layer_names(params):
        kernel = _to_numpy(params[layer]["kernel"])
        bias = _to_numpy(params[layer]["bias"])
        kernel.tofile(directory / f"{layer}_kernel.bin")
        bias.tofile(directory / f"{layer}_bias.bin")
        lines.append(f"{layer}_kernel {kernel.shape[0]} {kernel.shape[1]}")
        lines.append(f"{layer}_bias {bias.shape[0]}")
    (directory / "shapes.txt").write_text("\n".join(lines) + "\n")


def save_bundle(path: os.PathLike, coarse_params, fine_params, golden_json_text: str) -> None:
    """Pack both networks (param trees or NerfMLPs) and the camera/golden
    JSON into ONE ``.npz`` file: arrays ``{net}.{layer}.kernel`` and
    ``{net}.{layer}.bias`` (little-endian f32) and ``golden_json`` (UTF-8
    bytes), the layout the JAX package's ``save_bundle`` writes and its
    ``load_bundle`` reads. Load with :func:`load_bundle`, or point
    ``$NERF_RS_TPU_ASSETS`` / ``api.init_renderer(assets_dir=...)`` at it."""
    arrays: Dict[str, np.ndarray] = {}
    for net, params in (("coarse", _tree(coarse_params)), ("fine", _tree(fine_params))):
        for layer in param_layer_names(params):
            arrays[f"{net}.{layer}.kernel"] = _to_numpy(params[layer]["kernel"])
            arrays[f"{net}.{layer}.bias"] = _to_numpy(params[layer]["bias"])
    arrays["golden_json"] = np.frombuffer(golden_json_text.encode("utf-8"), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def load_bundle(path: os.PathLike, dtype=np.float32):
    """Load a :func:`save_bundle` artifact (or the JAX package's) ->
    ``(params, golden_dict)`` with ``params = {"coarse": tree, "fine":
    tree}`` of numpy arrays, each tree checked by
    :func:`validate_param_chain`."""
    import json

    with np.load(Path(path)) as z:
        golden = json.loads(bytes(z["golden_json"]).decode("utf-8"))
        params: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
        for net in ("coarse", "fine"):
            layers = param_layer_names({f.split(".")[1] for f in z.files
                                        if f.startswith(f"{net}.") and f.endswith(".kernel")})
            tree = {layer: {"kernel": z[f"{net}.{layer}.kernel"].astype(dtype),
                            "bias": z[f"{net}.{layer}.bias"].astype(dtype)}
                    for layer in layers}
            validate_param_chain(tree)
            params[net] = tree
    return params, golden


def load_scene_assets(assets: os.PathLike, dtype=np.float32):
    """``assets`` is a reference-format weight directory (coarse/ + fine/ +
    tf_reference_samples.json) or a ``.npz`` bundle. Returns
    ``({"coarse": tree, "fine": tree}, golden_dict)`` with numpy trees."""
    import json

    assets = Path(assets)
    if assets.is_file():
        return load_bundle(assets, dtype=dtype)
    params = {net: load_nerf_params(assets / net, dtype=dtype) for net in ("coarse", "fine")}
    with open(assets / "tf_reference_samples.json") as f:
        golden = json.load(f)
    return params, golden


def validate_param_shapes(params) -> None:
    """Check that a param tree has the canonical lego architecture's
    shapes (:data:`CANONICAL_SHAPES`); raises ValueError naming the first
    layer that does not."""
    for layer, (d_in, d_out) in CANONICAL_SHAPES.items():
        k = params[layer]["kernel"]
        b = params[layer]["bias"]
        if tuple(k.shape) != (d_in, d_out):
            raise ValueError(f"{layer}.kernel: expected {(d_in, d_out)}, got {tuple(k.shape)}")
        if tuple(b.shape) != (d_out,):
            raise ValueError(f"{layer}.bias: expected {(d_out,)}, got {tuple(b.shape)}")


def validate_param_chain(params, x_freqs: int = 10, d_freqs: int = 4) -> None:
    """Check that a param tree is a consistent ArchConfig family member:
    trunk dims chain (with at most one skip re-concat of the encoded
    input), the heads consume the trunk width and rgb consumes the view
    branch."""
    enc_x, enc_d = 3 + 6 * x_freqs, 3 + 6 * d_freqs
    layers = param_layer_names(params)
    dense = [n for n in layers if n.startswith("dense")]
    if not dense or dense != [f"dense{i}" for i in range(len(dense))]:
        raise ValueError(f"trunk layers must be dense0..N, got {dense}")
    for head in ("bottleneck", "viewdirs", "rgb", "alpha"):
        if head not in layers:
            raise ValueError(f"missing head layer {head!r}")
    h = enc_x
    skips = 0
    for name in dense:
        k = params[name]["kernel"]
        b = params[name]["bias"]
        if tuple(b.shape) != (k.shape[1],):
            raise ValueError(f"{name}.bias {tuple(b.shape)} != kernel cols {k.shape[1]}")
        if k.shape[0] == h + enc_x and name != "dense0":
            skips += 1
        elif k.shape[0] != h:
            raise ValueError(
                f"{name}.kernel input dim {k.shape[0]} matches neither the "
                f"running width {h} nor a skip concat {h + enc_x}")
        h = k.shape[1]
    if skips > 1:
        raise ValueError(f"expected at most one skip concat, found {skips}")
    width = h
    for name, d_in in (("bottleneck", width), ("alpha", width),
                       ("viewdirs", width + enc_d)):
        if params[name]["kernel"].shape[0] != d_in:
            raise ValueError(
                f"{name}.kernel input dim {params[name]['kernel'].shape[0]} "
                f"!= expected {d_in}")
    v_width = params["viewdirs"]["kernel"].shape[1]
    if tuple(params["rgb"]["kernel"].shape) != (v_width, 3):
        raise ValueError(
            f"rgb.kernel {tuple(params['rgb']['kernel'].shape)} != ({v_width}, 3)")
    if params["alpha"]["kernel"].shape[1] != 1:
        raise ValueError("alpha.kernel must have 1 output column")
