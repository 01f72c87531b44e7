"""Differentiable NeRF training, the port of ``nerf_rs_tpu/train.py``.

The original NeRF recipe: joint photometric MSE on the coarse and fine
renders, Adam with an exponential learning-rate decay from 5e-4 to 5e-6.
The coarse and fine networks are independent parameter sets trained
together. With ``impl="pallas"`` every MLP forward runs the fused kernel K1
and every MLP backward the fused kernel K2 (``ops/kernels/fused_mlp.py``);
a student beyond K2's envelope (``fused_mlp.supports_backward_arch``)
trains on the plain MLP instead.
The hash-grid family (``model="hashgrid"``) trains one field that serves
both passes; its encode runs the hash-encode kernel
(``ops/kernels/hash_encode.py``). Its recipe (the CLI's) is Adam from 1e-2
to 1e-4 with eps 1e-15.

The JAX step is a pure function that returns a new state. Here
:func:`train_step` updates the state in place: the parameters and Adam's
moments are not copied, and the in-place update bumps the parameters'
version counters, so each ``NerfMLP`` repacks its kernel weights on the
next call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nerf_rs_tpu_torch.config import TrainConfig
from nerf_rs_tpu_torch.models.hashgrid import HashGridField, init_hashgrid_params, is_hashgrid_params
from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params
from nerf_rs_tpu_torch.render import render_rays


@dataclasses.dataclass
class TrainState:
    """``params`` {"coarse": NerfMLP, "fine": NerfMLP}, or {"shared":
    HashGridField} for the hash-grid family; Adam's first and second
    moments ``mu``/``nu``, keyed like ``params`` and then like each
    module's ``weights``; ``count``, the number of Adam updates so far
    (optax's ``ScaleByAdamState.count``); ``step``."""

    params: Dict[str, torch.nn.Module]
    mu: Dict[str, Dict[str, torch.Tensor]]
    nu: Dict[str, Dict[str, torch.Tensor]]
    count: int = 0
    step: int = 0


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(optax.exponential_decay(lr_init, lr_decay_steps,
    lr_final / lr_init), eps=eps)`` written out: b1 = 0.9, b2 = 0.999,
    eps outside the square root, bias correction with the update count
    starting at 1, and the update at 0-based count t scaled by
    ``lr_init * (lr_final / lr_init) ** (t / lr_decay_steps)``, with no
    staircase."""

    lr_init: float
    lr_final: float
    lr_decay_steps: int
    eps: float
    b1: float = 0.9
    b2: float = 0.999

    def learning_rate(self, count: int) -> float:
        return self.lr_init * (self.lr_final / self.lr_init) ** (count / self.lr_decay_steps)

    @torch.no_grad()
    def update(self, state: TrainState) -> None:
        """One update of every parameter from its ``.grad``, in place."""
        t = state.count + 1
        lr = self.learning_rate(state.count)
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for net, module in state.params.items():
            for name, p in module.weights.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                mu, nu = state.mu[net][name], state.nu[net][name]
                mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) * -lr)
        state.count = t


def make_optimizer(cfg: TrainConfig) -> Adam:
    return Adam(cfg.lr_init, cfg.lr_final, cfg.lr_decay_steps, cfg.adam_eps)


def _zeros_like(params: Dict[str, torch.nn.Module]) -> Dict[str, Dict[str, torch.Tensor]]:
    return {net: {name: torch.zeros_like(p) for name, p in module.weights.items()}
            for net, module in params.items()}


def create_train_state(generator: torch.Generator, cfg: TrainConfig) -> TrainState:
    """Random networks on the generator's device, with zero Adam moments:
    for the MLP family coarse and fine networks of ``cfg.arch`` (the
    coarse one drawn first); for the hash-grid family one field,
    ``{"shared": HashGridField}``, that both passes query, so that the
    gradients of both passes accumulate in the same tables."""
    if cfg.render.model == "hashgrid":
        params = {"shared": HashGridField(init_hashgrid_params(generator, cfg.render.hash),
                                          device=generator.device, requires_grad=True)}
    else:
        params = {net: NerfMLP(init_nerf_params(generator, arch=cfg.arch),
                               device=generator.device, requires_grad=True)
                  for net in ("coarse", "fine")}
    return TrainState(params=params, mu=_zeros_like(params), nu=_zeros_like(params))


def _flat(tree) -> Dict[str, object]:
    """A param tree keyed as the modules' ``weights``: ``{layer}_{part}``
    for each layer's arrays, the name itself for a bare array
    (``hash_tables``)."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update({f"{name}_{part}": arr for part, arr in value.items()})
        else:
            out[name] = value
    return out


def _modules(params, device) -> Dict[str, torch.nn.Module]:
    return {net: (HashGridField if is_hashgrid_params(tree) else NerfMLP)(
                tree, device=device, requires_grad=True)
            for net, tree in params.items()}


def train_state_from_params(params, device) -> TrainState:
    """A state that starts from the given param trees ({"coarse", "fine"}
    or {"shared"}; numpy arrays or tensors) with zero Adam moments, count
    and step 0: a new run from trained weights (``train
    --init-weights``), not a resume."""
    modules = _modules(params, device)
    return TrainState(params=modules, mu=_zeros_like(modules), nu=_zeros_like(modules))


def train_state_from_numpy(params, mu, nu, count: int, step: int, device) -> TrainState:
    """The port's state from a JAX ``TrainState`` taken to numpy:
    ``params``, ``mu`` and ``nu`` are {"coarse": tree, "fine": tree} with
    trees of {layer: {"kernel", "bias"}} arrays, or {"shared": tree} with a
    hash-grid tree (optax's Adam moments have the params' structure);
    ``count`` is the Adam count, ``step`` the step. Lets a run continue
    from a JAX run."""
    modules = _modules(params, device)

    def moments(trees):
        return {net: {name: torch.as_tensor(np.asarray(arr), dtype=torch.float32,
                                            device=device).clone()
                      for name, arr in _flat(tree).items()}
                for net, tree in trees.items()}

    return TrainState(params=modules, mu=moments(mu), nu=moments(nu), count=int(count),
                      step=int(step))


def split_params(params) -> Tuple[torch.nn.Module, torch.nn.Module]:
    """(coarse, fine) networks of a train-state param dict: the one shared
    network twice, or the coarse and fine networks."""
    if "shared" in params:
        return params["shared"], params["shared"]
    return params["coarse"], params["fine"]


def _trainable(params, rcfg):
    """``rcfg``, or with ``impl="xla"`` where ``impl="pallas"`` would ask
    the fused backward K2 for a network beyond its envelope."""
    from nerf_rs_tpu_torch.ops.kernels.fused_mlp import supports_backward_arch

    if rcfg.model == "mlp" and rcfg.impl == "pallas" and not all(
            supports_backward_arch(p) for p in split_params(params)):
        return rcfg.replace(impl="xla")
    return rcfg


def nerf_loss(params, batch: Dict[str, torch.Tensor], key: torch.Tensor, cfg: TrainConfig,
              grid=None, ray_ids: Optional[torch.Tensor] = None):
    """Joint coarse + fine photometric MSE over a ray batch -> (loss,
    metrics).

    batch: origins (B, 3) or one (3,) origin, dirs (B, 3) unit, rgb (B, 3)
    targets, near/far scalars. Every ray draws from its own stream, folded
    from ``key`` by ``ray_ids`` (default: its batch position).

    ``grid`` (``accel.OccupancyGrid``) culls the MLP evaluation inside the
    differentiable render: culled samples get sigma = 0 and no gradient
    (mask-only, or compacted into ``accel_*_capacity`` rows), and with
    ``accel_sample_aabb`` the samples are placed in each ray's occupied
    range. The grid is refreshed from the student by the caller (``cli
    train --accel-every``).

    The metrics (loss, mse_fine, mse_coarse, psnr; with a grid also
    ``live_frac_coarse`` and ``live_frac_fine``, each pass's live rows over
    its capacity, and ``accel_overflow``, 1.0 when either exceeds 1 and
    samples were dropped) are detached 0-d tensors.
    """
    rcfg = _trainable(params, cfg.render)
    dirs = batch["dirs"]
    if ray_ids is None:
        ray_ids = torch.arange(dirs.shape[0], dtype=torch.int64, device=dirs.device)
    p_coarse, p_fine = split_params(params)
    rgb_fine, aux = render_rays(p_coarse, p_fine, batch["origins"], dirs, batch["near"],
                                batch["far"], key, rcfg, return_aux=True, grid=grid,
                                ray_ids=ray_ids)
    mse_fine = torch.mean((rgb_fine - batch["rgb"]) ** 2)
    mse_coarse = torch.mean((aux["rgb_coarse"] - batch["rgb"]) ** 2)
    # Single pass: the "coarse" image is the render; adding it again would
    # only double the loss scale.
    coarse_w = cfg.coarse_loss_weight if rcfg.n_fine > 0 else 0.0
    loss = mse_fine + coarse_w * mse_coarse
    psnr = -10.0 * torch.log10(torch.clamp(mse_fine.detach(), min=1e-10))
    metrics = {"loss": loss.detach(), "mse_fine": mse_fine.detach(),
               "mse_coarse": mse_coarse.detach(), "psnr": psnr}
    if "live_frac_coarse" in aux:
        metrics["live_frac_coarse"] = aux["live_frac_coarse"].detach()
        metrics["live_frac_fine"] = aux["live_frac_fine"].detach()
        metrics["accel_overflow"] = (torch.maximum(metrics["live_frac_coarse"],
                                                   metrics["live_frac_fine"]) > 1.0).to(torch.float32)
    return loss, metrics


def refresh_grid(params, cfg: TrainConfig, step: int, *, resolution: int, explore: float,
                 sweep_kw: dict):
    """The occupancy grid of occupancy-culled training, rebuilt from the
    current student -> (grid or None, the config to train with until the
    next refresh, the line to print), as the JAX CLI's ``train
    --accel-every`` refreshes it.

    The sweep is ``sweep_kw`` (``accel.field_grid_kwargs(cfg.render)``:
    the student's configured impl and dtype). A grid under 0.5% occupied
    (a density not yet formed) and a grid whose capacities would reach 1.0
    (culling would skip nothing) give None: the period trains dense. A
    culled cell gets no gradient, so ``explore`` re-opens that fraction
    of the cells, drawn on the host from ``np.random.default_rng(cfg.seed
    + step)``, and the capacities cover them too. Mask-only culling
    (``accel_compact`` "none" or "off") keeps the config; the compaction
    modes get capacities from ``accel.capacities_from_occupancy``."""
    from nerf_rs_tpu_torch.accel import build_scene_grid, capacities_from_occupancy

    pc, pf = split_params(params)
    grid = build_scene_grid(pc, pf, resolution=resolution, **sweep_kw)
    occ = grid.occ.cpu().numpy()
    # The near-empty test reads the raw grid: explored cells would hide an
    # unformed density.
    raw_frac = float(occ.mean())
    if raw_frac < 0.005:
        return None, cfg, (f"accel: grid only {raw_frac:.2%} occupied — training dense until "
                           "density forms")
    if explore > 0:
        rng = np.random.default_rng(cfg.seed + step)
        occ = occ | (rng.random(occ.shape) < explore)
        grid = grid._replace(occ=torch.as_tensor(occ, device=grid.occ.device))
    frac = float(occ.mean())
    cap_c, cap_f = capacities_from_occupancy(frac, cfg.render)
    if cap_c >= 1.0:
        return None, cfg, (f"accel: grid {frac:.1%} occupied — culling would skip nothing, "
                           "training dense this period")
    if cfg.render.accel_compact in ("none", "off"):
        return grid, cfg, f"accel: rebuilt {resolution}^3 grid ({frac:.1%} occupied; mask-only)"
    cfg = cfg.replace(render=cfg.render.replace(accel_coarse_capacity=cap_c,
                                                accel_fine_capacity=cap_f))
    return grid, cfg, (f"accel: rebuilt {resolution}^3 grid ({frac:.1%} occupied; capacities "
                       f"{cap_c:.2f}/{cap_f:.2f})")


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], key: torch.Tensor,
               cfg: TrainConfig, grid=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One Adam step on :func:`nerf_loss` (``grid``: occupancy-culled), in
    place; returns the same state and the step's metrics."""
    for module in state.params.values():
        module.zero_grad(set_to_none=True)
    loss, metrics = nerf_loss(state.params, batch, key, cfg, grid=grid)
    loss.backward()
    make_optimizer(cfg).update(state)
    state.step += 1
    return state, metrics
