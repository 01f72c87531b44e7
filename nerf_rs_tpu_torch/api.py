"""Embedder-facing API: ``init_renderer()`` + ``render_image_rgba(width,
height)``, the reference renderer's wasm surface, for Python embedders and
the HTTP viewer (``serve.py``): cached networks on the device, validated
dimensions, flat RGBA u8 output with A=255.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerf_rs_tpu_torch.config import RenderConfig

_lock = threading.Lock()
# Serializes device work across concurrent embedder and viewer requests
# (serve.py answers on a ThreadingHTTPServer): one render in flight.
_render_lock = threading.Lock()
_state: dict = {}

# "Keep the current checkpoint" default of init_renderer: None stays
# distinct (it asks for the pretrained weights).
_KEEP = object()


def init_renderer(assets_dir: Optional[str] = None, cfg: Optional[RenderConfig] = None,
                  accel: Optional[bool] = None, accel_res: int = 128, checkpoint=_KEEP,
                  device=None) -> None:
    """Load and cache the coarse/fine networks and camera on ``device``
    (idempotent).

    ``assets_dir`` is a weight directory or a ``.npz`` bundle (default:
    ``io.weights.find_lego_assets``). ``accel=True`` also bakes an
    occupancy grid (``accel.build_scene_grid``, once) and serves every
    frame through the empty-space-skipping path; compaction modes calibrate
    their capacities per image size on first use and cache them.
    ``accel=None`` keeps the current mode; ``accel=False`` turns it off.
    ``device`` (default ``cuda``) keeps the current one on a re-init that
    does not name it.

    ``checkpoint`` serves a training checkpoint (``io/checkpoint.py``, any
    model family) instead of the pretrained weights; the camera still comes
    from the scene assets, and a hash-grid checkpoint takes its config from
    the ``model.json`` sidecar ``train`` writes. Left unset it keeps the
    current one; ``checkpoint=None`` restores the pretrained weights. A
    failed init (a missing checkpoint raises FileNotFoundError) leaves the
    previous renderer as it was.
    """
    from nerf_rs_tpu_torch.io.golden import camera_from_golden
    from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_scene_assets
    from nerf_rs_tpu_torch.models.mlp import as_module

    with _lock:
        if checkpoint is _KEEP:
            checkpoint = _state.get("checkpoint")
        if device is None:
            device = _state.get("device", torch.device("cuda"))
        device = torch.device(device)
        if (_state.get("ready") and assets_dir is None and cfg is None
                and device == _state.get("device")
                and checkpoint == _state.get("checkpoint")
                and (accel is None
                     or (accel == (_state.get("grid") is not None)
                         and (not accel or accel_res == _state.get("accel_res"))))):
            return
        if accel is None:
            # accel=None keeps the current mode: a cfg-only re-init must not
            # drop a baked grid.
            accel = _state.get("grid") is not None
            accel_res = _state.get("accel_res", accel_res)
        assets = assets_dir or find_lego_assets()
        if assets is None:
            raise FileNotFoundError(
                "no weight assets found; pass assets_dir or set $NERF_RS_TPU_ASSETS")
        assets = Path(assets)
        # The grid is a function of the weights and the resolution: rebake
        # only when one of them changed.
        reuse_grid = (_state.get("grid") is not None and _state.get("accel_res") == accel_res
                      and _state.get("assets") == assets and _state.get("device") == device
                      and _state.get("checkpoint") == checkpoint)
        # Everything that can fail runs on locals; _state is committed in
        # one block at the end.
        trees, golden = load_scene_assets(assets)
        camera = camera_from_golden(golden)
        new_cfg = cfg or _state.get("cfg") or RenderConfig(ray_chunk=16384, accel_cull_rays=True)
        new_cfg = new_cfg.replace(model="mlp")
        if checkpoint is not None:
            from nerf_rs_tpu_torch.io.checkpoint import checkpoint_networks, restore_params

            trees, _ = restore_params(checkpoint)
            coarse, fine, new_cfg = checkpoint_networks(trees, checkpoint, new_cfg, device)
            params = {"coarse": coarse, "fine": fine}
        else:
            params = {net: as_module(trees[net], device) for net in ("coarse", "fine")}
        if new_cfg.model == "mlp" and new_cfg.impl == "pallas":
            from nerf_rs_tpu_torch.ops.kernels.fused_mlp import supports_arch

            if not supports_arch(params["coarse"]):
                new_cfg = new_cfg.replace(impl="xla")
        if accel:
            if reuse_grid:
                grid = _state["grid"]
            else:
                from nerf_rs_tpu_torch.accel import build_scene_grid, hashgrid_grid_kwargs

                grid_kw = hashgrid_grid_kwargs(new_cfg) if new_cfg.model == "hashgrid" else {}
                grid = build_scene_grid(params["coarse"], params["fine"], resolution=accel_res,
                                        **grid_kw)
        else:
            grid = None

        # ---- commit (nothing below can fail) ----
        _state["assets"] = assets
        _state["checkpoint"] = checkpoint
        _state["device"] = device
        _state["params"] = params
        _state["camera"] = camera
        _state["cfg"] = new_cfg
        _state["grid"] = grid
        if accel:
            _state["accel_res"] = accel_res
        else:
            _state.pop("accel_res", None)
        _state["size_cfgs"] = {}
        _state["ready"] = True


def render_image_rgba(width: int, height: int, seed: int = 0) -> np.ndarray:
    """Render and return a flat (H*W*4,) u8 RGBA buffer (A=255), the
    reference's JS-facing contract."""
    from nerf_rs_tpu_torch.io.image import pixels_to_rgba
    from nerf_rs_tpu_torch.ops import random
    from nerf_rs_tpu_torch.render import render_image

    if width <= 0 or height <= 0:
        raise ValueError("width and height must be greater than zero")
    init_renderer()
    # One snapshot of the whole state, so a concurrent init_renderer cannot
    # pair a stale grid with a new cfg; a re-init replaces size_cfgs, so
    # calibrations never leak across grids.
    with _lock:
        base_cfg = cfg = _state["cfg"]
        grid = _state["grid"]
        params = _state["params"]
        camera = _state["camera"]
        device = _state["device"]
        size_cfgs = _state["size_cfgs"]
    if grid is not None and base_cfg.accel_compact not in ("none", "off"):
        # Compaction modes need capacities calibrated for the size.
        with _lock:
            cfg = size_cfgs.get((width, height))
        if cfg is None:
            from nerf_rs_tpu_torch.accel import calibrate_capacities

            with _render_lock:
                cfg = calibrate_capacities(params["coarse"], params["fine"], grid, camera,
                                           height, width, random.key(0, device), base_cfg)
            with _lock:
                size_cfgs[(width, height)] = cfg
    with _render_lock:
        img = render_image(params["coarse"], params["fine"], camera, height, width,
                           random.key(seed, device), cfg, device=device, grid=grid)
        out = img.cpu().numpy()
    return pixels_to_rgba(out)
