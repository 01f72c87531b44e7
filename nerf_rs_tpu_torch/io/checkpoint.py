"""Training checkpoints in the port's own format, the reference `.bin`
export, and the ``model.json`` sidecar: the counterpart of
``nerf_rs_tpu/io/checkpoint.py``, which is orbax.

A checkpoint is a directory ``<dir>/step_<step:08d>/`` holding

- ``state.npz``: every array of the training state as little-endian f32,
  keyed ``params/<net>/<layer>/<part>`` (``params/shared/hash_tables`` for
  the hash grid's bare table array), ``mu/...`` and ``nu/...`` for Adam's
  moments, keyed as the params;
- ``meta.json``: the format's name, ``step``, Adam's ``count`` and the
  params' keys and shapes, which the resume guards read without the
  arrays.

It holds no device: a checkpoint written from a CUDA state restores on the
CPU and the reverse. A save writes into ``.tmp_step_<step>`` and renames it
into place, so a run killed while it writes leaves no ``step_*`` directory
that :func:`latest_checkpoint` could pick. The JAX package's orbax
checkpoints cannot be read without JAX: the weights move between the two
packages through the reference ``.bin`` format or ``.npz`` bundles.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from nerf_rs_tpu_torch.io.weights import load_nerf_params, save_nerf_params

FORMAT = "nerf_rs_tpu_torch checkpoint"
VERSION = 1
_STEP_DIR = re.compile(r"step_\d{8}")


def _arrays(tree, prefix: str) -> Dict[str, np.ndarray]:
    """A nested tree of arrays or tensors, flattened to ``prefix/a/b``
    keys, as little-endian f32 numpy arrays."""
    out = {}
    for name, value in tree.items():
        key = f"{prefix}/{name}"
        if isinstance(value, dict):
            out.update(_arrays(value, key))
        else:
            if hasattr(value, "detach"):
                value = value.detach().cpu().numpy()
            out[key] = np.asarray(value, dtype="<f4")
    return out


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    """The inverse of :func:`_arrays` (prefix included)."""
    out: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return out


def _state_trees(state) -> Dict[str, dict]:
    """A port ``train.TrainState`` as nested trees: params from each
    module's ``tree()``; each moment keyed like its param (the moments are
    keyed like the modules' ``weights``, ``{layer}_{part}`` or a bare
    name)."""
    params, mu, nu = {}, {}, {}
    for net, module in state.params.items():
        tree = module.tree()
        params[net] = tree
        for moments, out in ((state.mu[net], mu), (state.nu[net], nu)):
            out[net] = {name: ({part: moments[f"{name}_{part}"] for part in value}
                               if isinstance(value, dict) else moments[name])
                        for name, value in tree.items()}
    return {"params": params, "mu": mu, "nu": nu}


def save_checkpoint(directory, state, *, keep: int = 3) -> Path:
    """Save a port ``train.TrainState`` at ``<directory>/step_<step>``,
    atomically, and prune all but the newest ``keep`` checkpoints. A
    checkpoint of the same step is replaced."""
    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    step = int(state.step)
    name = f"step_{step:08d}"
    path = directory / name
    arrays = {}
    for kind, tree in _state_trees(state).items():
        arrays.update(_arrays(tree, kind))
    meta = {"format": FORMAT, "version": VERSION, "step": step, "count": int(state.count),
            "params": {key[len("params/"):]: list(a.shape) for key, a in arrays.items()
                       if key.startswith("params/")}}
    tmp = directory / f".tmp_{name}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    np.savez(tmp / "state.npz", **arrays)
    (tmp / "meta.json").write_text(json.dumps(meta, indent=1))
    if path.exists():
        # rename() does not replace a non-empty directory: move the old one
        # aside first, so that the step is never half written.
        old = directory / f".old_{name}"
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
    steps = _step_dirs(directory)
    for stale in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(stale)
    return path


def _step_dirs(directory: Path):
    return sorted(p for p in directory.iterdir() if p.is_dir() and _STEP_DIR.fullmatch(p.name))


def latest_checkpoint(directory) -> Optional[Path]:
    """The newest ``step_*`` directory under ``directory``, or None."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    steps = _step_dirs(directory)
    return steps[-1] if steps else None


def _meta(path) -> dict:
    """A checkpoint's ``meta.json``. A missing path raises
    FileNotFoundError; anything else that is not a checkpoint of this
    package (an orbax checkpoint of the JAX package among them) raises
    ValueError with what to do instead."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint at {path}")
    meta_path = path / "meta.json"
    if meta_path.is_file():
        meta = json.loads(meta_path.read_text())
        if meta.get("format") == FORMAT:
            return meta
    orbax = path.is_dir() and any((path / n).exists() for n in (
        "_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt", "checkpoint"))
    what = "an orbax checkpoint of the JAX package" if orbax else "not a checkpoint of this package"
    raise ValueError(
        f"{path} is {what}. The port reads its own checkpoints only; move weights between the "
        f"two packages through the reference .bin format or an .npz bundle: `python -m "
        f"nerf_rs_tpu export --checkpoint {path} -o DIR`, then `--init-weights DIR` (or "
        f"`render --weights DIR`)")


def _load_arrays(path) -> Dict[str, np.ndarray]:
    _meta(path)
    with np.load(Path(path) / "state.npz", allow_pickle=False) as z:
        return {key: z[key] for key in z.files}


def restore_checkpoint(path, device):
    """Restore a :func:`save_checkpoint` checkpoint as a port
    ``train.TrainState`` on ``device``: params, ``mu``, ``nu``, ``count``
    and ``step``, each array bitwise as saved."""
    from nerf_rs_tpu_torch.train import train_state_from_numpy

    meta = _meta(path)
    trees = _nest(_load_arrays(path))
    return train_state_from_numpy(trees["params"], trees["mu"], trees["nu"], meta["count"],
                                  meta["step"], device)


def restore_params(path) -> Tuple[dict, int]:
    """Only ``(params, step)`` of a checkpoint, template-free: numpy trees
    ``{"coarse": tree, "fine": tree}`` (any ArchConfig member) or
    ``{"shared": tree}`` for the hash grid."""
    meta = _meta(path)
    arrays = {k: v for k, v in _load_arrays(path).items() if k.startswith("params/")}
    return _nest(arrays)["params"], int(meta["step"])


def checkpoint_param_keys(path) -> set:
    """The params' top-level keys ({"coarse", "fine"} for the MLP family,
    {"shared"} for the hash grid), from ``meta.json`` alone."""
    return {key.split("/")[0] for key in _meta(path)["params"]}


def checkpoint_kernel_shapes(path) -> Dict[str, Tuple[int, ...]]:
    """{layer: kernel shape} of the checkpoint's coarse network, from
    ``meta.json`` alone: the architecture guard's cheap read."""
    out = {}
    for key, shape in _meta(path)["params"].items():
        net, layer, *part = key.split("/")
        if net == "coarse" and part == ["kernel"]:
            out[layer] = tuple(shape)
    return out


def save_model_config(directory, info: dict) -> Path:
    """Write the model family's metadata (the model name, and the hash
    grid's hyper-parameters, which its arrays do not determine) as the
    ``model.json`` sidecar at the checkpoint directory's root."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "model.json"
    path.write_text(json.dumps(info, indent=1))
    return path


def load_model_config(path) -> Optional[dict]:
    """The ``model.json`` sidecar of a checkpoint (the step directory or
    the root), or None where there is none."""
    path = Path(path)
    for candidate in (path / "model.json", path.parent / "model.json"):
        if candidate.is_file():
            return json.loads(candidate.read_text())
    return None


def hashgrid_render_config(info: dict, base):
    """The RenderConfig of a hash-grid checkpoint from its sidecar
    ``info``, over the caller's sampling and chunk settings in ``base``."""
    from nerf_rs_tpu_torch.config import HashGridConfig

    hash_kw = dict(info.get("hash", {}))
    if "aabb" in hash_kw:
        hash_kw["aabb"] = tuple(hash_kw["aabb"])
    return base.replace(model="hashgrid", hash=HashGridConfig(**hash_kw))


def checkpoint_networks(params, path, cfg, device):
    """(coarse, fine, cfg) of a checkpoint's restored param trees on
    ``device``: the hash grid's field for both passes, its RenderConfig
    from the ``model.json`` sidecar over ``cfg`` (FileNotFoundError where
    there is none), or the MLP family's two networks with ``cfg`` as
    given."""
    from nerf_rs_tpu_torch.models.mlp import as_module

    if "shared" in params:
        info = load_model_config(Path(path))
        if info is None or info.get("model") != "hashgrid":
            raise FileNotFoundError(f"{path} holds a shared-network (hashgrid) checkpoint but no "
                                    f"model.json sidecar was found next to it")
        field = as_module(params["shared"], device)
        return field, field, hashgrid_render_config(info, cfg)
    return as_module(params["coarse"], device), as_module(params["fine"], device), cfg


def export_reference_format(directory, params) -> None:
    """Write ``{coarse,fine}/`` in the reference ``.bin`` format, readable
    by the reference renderer and by both packages' loaders."""
    directory = Path(directory)
    for net in ("coarse", "fine"):
        save_nerf_params(directory / net, params[net])


def import_reference_format(directory) -> dict:
    directory = Path(directory)
    return {net: load_nerf_params(directory / net) for net in ("coarse", "fine")}
