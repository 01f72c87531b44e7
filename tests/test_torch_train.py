"""PyTorch port, training: nerf_loss, train_step, Adam and the distillation
batches against the JAX package (optax, jax.random), the state bridge
that continues a JAX run in the port, and the CLI's train subcommand.

The same numpy inputs go to both packages. On the CPU the port's
impl="pallas" runs the fused kernels' plain versions; the kernels are held
against them on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_rs_tpu.config import ArchConfig as JaxArchConfig
from nerf_rs_tpu.config import RenderConfig as JaxRenderConfig
from nerf_rs_tpu.config import TrainConfig as JaxTrainConfig
from nerf_rs_tpu.data import _distill_batch as jax_distill_batch
from nerf_rs_tpu.train import create_train_state as jax_create_train_state
from nerf_rs_tpu.train import nerf_loss as jax_nerf_loss
from nerf_rs_tpu.train import train_step as jax_train_step
from nerf_rs_tpu_torch.cli import main as cli_main
from nerf_rs_tpu_torch.config import ArchConfig, RenderConfig, TrainConfig
from nerf_rs_tpu_torch.data import DistillationDataset, _distill_batch
from nerf_rs_tpu_torch.io.weights import find_lego_assets, load_nerf_params
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops import random
from nerf_rs_tpu_torch.ops.kernels.fused_mlp import pack_params
from nerf_rs_tpu_torch.train import (
    TrainState,
    create_train_state,
    make_optimizer,
    nerf_loss,
    train_state_from_numpy,
    train_step,
)

torch.set_num_threads(1)

# tests/test_train.py's TINY config (canonical 8x256 arch, 64 rays, 8 + 8
# samples), in both packages; the step tests use a small arch.
JAX_TINY = JaxTrainConfig(batch_rays=64, render=JaxRenderConfig(n_coarse=8, n_fine=8,
                                                                 ray_chunk=64))
TINY = TrainConfig(batch_rays=64, render=RenderConfig(n_coarse=8, n_fine=8, ray_chunk=64))
SMALL = dict(width=128, v_width=64, depth=4, skip_at=2)
JAX_SMALL = JAX_TINY.replace(arch=JaxArchConfig(**SMALL))
PORT_SMALL = TINY.replace(arch=ArchConfig(**SMALL))


def np_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return {"origins": np.zeros((n, 3), np.float32), "dirs": dirs,
            "rgb": rng.uniform(size=(n, 3)).astype(np.float32),
            "near": np.float32(2.0), "far": np.float32(6.0)}


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_adam_state(state):
    adam = state.opt_state[0]                 # optax.adam = chain(scale_by_adam, ...)
    return to_np(adam.mu), to_np(adam.nu), int(adam.count)


def port_state_from_jax(state):
    mu, nu, count = jax_adam_state(state)
    return train_state_from_numpy(to_np(state.params), mu, nu, count, int(state.step), "cpu")


def assert_params_close(jax_params, port_state, lr):
    """tests/test_train.py's bound after a step: every entry within two
    learning rates, under 0.1% of them more than 1e-5 apart (Adam turns
    an ulp of a near-zero gradient into a visible fraction of a step)."""
    for net, tree in jax_params.items():
        module = port_state.params[net]
        for layer, parts in tree.items():
            for part, want in parts.items():
                got = module.weights[f"{layer}_{part}"].detach().numpy()
                diff = np.abs(got - np.asarray(want))
                assert diff.max() < 2 * lr, (net, layer, part, diff.max())
                assert (diff > 1e-5).mean() < 1e-3, (net, layer, part)


@pytest.fixture(scope="module")
def jax_tiny_state():
    return jax_create_train_state(jax.random.key(0), JAX_TINY)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_nerf_loss_and_grads_match_jax(jax_tiny_state, impl):
    """The port's loss and its gradients (impl="xla": torch autograd of the
    oracle; impl="pallas": the fused autograd function) against JAX
    nerf_loss with impl="xla". The draws are bit-identical, so the loss
    agrees to 1e-5, and every gradient to atol 1e-6, rtol 1e-4 — except
    the fine network's under impl="pallas": its coarse sigmas differ from
    JAX's by an ulp (another summation order), which moves the importance
    samples by up to ~4e-5, and the encode's 2^9 frequency turns that into
    gradients ~5e-3 apart (relative norm) in the first layers. Those are
    held to 2e-2 per leaf."""
    b = np_batch(64)
    grad_fn = jax.jit(jax.value_and_grad(jax_nerf_loss, has_aux=True), static_argnames=("cfg",))
    (want_loss, want_m), want_g = grad_fn(jax_tiny_state.params, jax_batch(b), jax.random.key(1),
                                          JAX_TINY.replace(render=JAX_TINY.render.replace(impl="xla")))
    state = port_state_from_jax(jax_tiny_state)
    cfg = TINY.replace(render=TINY.render.replace(impl=impl))
    loss, metrics = nerf_loss(state.params, torch_batch(b), random.key(1, "cpu"), cfg)
    loss.backward()
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=1e-5)
    for name in ("mse_fine", "mse_coarse", "psnr"):
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]), rtol=1e-5)
    for net, tree in to_np(want_g).items():
        for layer, parts in tree.items():
            for part, want in parts.items():
                got = state.params[net].weights[f"{layer}_{part}"].grad.numpy()
                if impl == "pallas" and net == "fine":
                    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want), (layer, part)
                else:
                    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4,
                                               err_msg=f"{net}/{layer}/{part}")


def test_train_step_matches_jax():
    """One Adam step from the same state, batch and key: the loss to 1e-5,
    the parameters within the bound of tests/test_train.py."""
    b = np_batch(64, seed=1)
    jax_state = jax_create_train_state(jax.random.key(0), JAX_SMALL)
    state = port_state_from_jax(jax_state)
    jax_state, want_m = jax_train_step(jax_state, jax_batch(b), jax.random.key(1), JAX_SMALL)
    state, metrics = train_step(state, torch_batch(b), random.key(1, "cpu"),
                                PORT_SMALL.replace(render=PORT_SMALL.render.replace(impl="pallas")))
    np.testing.assert_allclose(float(metrics["loss"]), float(want_m["loss"]), rtol=1e-5)
    assert state.step == 1 and state.count == 1
    assert_params_close(to_np(jax_state.params), state, PORT_SMALL.lr_init)


def test_port_continues_a_jax_run():
    """Three JAX steps, the state carried over by train_state_from_numpy,
    then one more step in each package: the same loss and parameters."""
    b = np_batch(64, seed=2)
    jax_state = jax_create_train_state(jax.random.key(0), JAX_SMALL)
    key = jax.random.key(5)
    for step in range(3):
        jax_state, _ = jax_train_step(jax_state, jax_batch(b), jax.random.fold_in(key, step),
                                      JAX_SMALL)
    state = port_state_from_jax(jax_state)
    assert (state.step, state.count) == (3, 3)
    jax_state, want_m = jax_train_step(jax_state, jax_batch(b), jax.random.fold_in(key, 3),
                                       JAX_SMALL)
    state, metrics = train_step(state, torch_batch(b),
                                random.fold_in(random.key(5, "cpu"), torch.tensor(3)), PORT_SMALL)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_m["loss"]), rtol=1e-5)
    assert_params_close(to_np(jax_state.params), state, PORT_SMALL.lr_init)
    mu, nu, count = jax_adam_state(jax_state)
    assert state.count == count == 4
    for net, tree in mu.items():
        for layer, parts in tree.items():
            for part, want in parts.items():
                np.testing.assert_allclose(state.mu[net][f"{layer}_{part}"].numpy(), want,
                                           atol=1e-7, rtol=1e-4)
                np.testing.assert_allclose(state.nu[net][f"{layer}_{part}"].numpy(),
                                           nu[net][layer][part], atol=1e-10, rtol=1e-4)


def test_adam_matches_optax():
    """The written-out Adam against optax.adam(optax.exponential_decay),
    five updates over a decay horizon of ten steps: eps outside the square
    root, bias correction counted from 1, no staircase."""
    cfg = TrainConfig(lr_init=1e-2, lr_final=1e-3, lr_decay_steps=10, adam_eps=1e-8)
    rng = np.random.default_rng(3)
    p0 = {"dense0": {"kernel": rng.normal(size=(63, 8)).astype(np.float32),
                     "bias": rng.normal(size=8).astype(np.float32)}}
    grads = [rng.normal(size=(63, 8)).astype(np.float32) for _ in range(5)]
    opt = optax.adam(optax.exponential_decay(cfg.lr_init, cfg.lr_decay_steps,
                                             cfg.lr_final / cfg.lr_init), eps=cfg.adam_eps)
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = opt.init(params)
    kernel = torch.nn.Parameter(torch.tensor(p0["dense0"]["kernel"]))
    net = types.SimpleNamespace(weights={"dense0_kernel": kernel})
    state = TrainState(params={"net": net}, mu={"net": {"dense0_kernel": torch.zeros_like(kernel)}},
                       nu={"net": {"dense0_kernel": torch.zeros_like(kernel)}})
    adam = make_optimizer(cfg)
    for g in grads:
        gj = {"dense0": {"kernel": jnp.asarray(g), "bias": jnp.zeros(8, jnp.float32)}}
        updates, opt_state = opt.update(gj, opt_state, params)
        params = optax.apply_updates(params, updates)
        kernel.grad = torch.from_numpy(g)
        adam.update(state)
    # Rounding differs in order only: within 1e-4 of one step (lr 1e-2).
    np.testing.assert_allclose(kernel.detach().numpy(),
                               np.asarray(params["dense0"]["kernel"]), atol=1e-6, rtol=0)
    assert state.count == 5


def test_module_repacks_after_an_optimizer_step():
    """NerfMLP's pack cache is keyed by the parameters' version counters:
    the in-place Adam update makes the next kernel call repack."""
    state = create_train_state(torch.Generator().manual_seed(0), PORT_SMALL)
    fine = state.params["fine"]
    before = fine.packed("float32")
    assert fine.packed("float32") is before
    train_step(state, torch_batch(np_batch(64, seed=3)), random.key(2, "cpu"),
               PORT_SMALL.replace(render=PORT_SMALL.render.replace(impl="pallas")))
    after = fine.packed("float32")
    assert after is not before
    assert not torch.equal(after.weights, before.weights)
    assert torch.equal(after.weights, pack_params(fine.tree(), "float32").weights)


def test_training_reduces_loss_on_cpu():
    cfg = PORT_SMALL.replace(render=PORT_SMALL.render.replace(impl="pallas"))
    state = create_train_state(torch.Generator().manual_seed(0), cfg)
    b = torch_batch(np_batch(64, seed=4))
    losses = [float(train_step(state, b, random.key(42, "cpu"), cfg)[1]["loss"])
              for _ in range(12)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.fixture(scope="module")
def lego_np():
    assets = find_lego_assets()
    if assets is None:
        pytest.skip("lego_rust pretrained assets not available")
    return {net: {layer: {part: np.asarray(t) for part, t in p.items()}
                  for layer, p in load_nerf_params(assets / net).items()}
            for net in ("coarse", "fine")}


def test_distill_batch_matches_jax(lego_np):
    """Viewpoints and teacher targets of one distillation batch: the same
    key schedule and draws (normal to about an ulp), so origins and dirs
    agree to 1e-6 and the teacher rgb above 60 dB."""
    jcfg = JaxRenderConfig(n_coarse=8, n_fine=8)
    key = jax.random.fold_in(jax.random.key(3), 2)
    want = jax_distill_batch(jax.tree_util.tree_map(jnp.asarray, lego_np), key, jnp.float32(4.03),
                             jnp.float32(2.0), jnp.float32(6.0), 64, jcfg)
    params = {net: NerfMLP(p) for net, p in lego_np.items()}
    got = _distill_batch(params, random.fold_in(random.key(3, "cpu"), torch.tensor(2)), 4.03,
                         torch.tensor(2.0), torch.tensor(6.0), 64,
                         RenderConfig(n_coarse=8, n_fine=8, impl="pallas"))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    mse = np.mean((got[2].numpy().astype(np.float64) - np.asarray(want[2], np.float64)) ** 2)
    assert -10 * np.log10(max(mse, 1e-20)) > 60.0
    assert float(np.abs(np.asarray(want[2]) - 1.0).max()) > 0.05    # not just background


def test_distillation_dataset_key_schedule(lego_np):
    """batches(seed) draws step k from fold_in(key(dataset seed + seed), k)."""
    cfg = RenderConfig(n_coarse=4, n_fine=4)
    ds = DistillationDataset(lego_np, cfg=cfg, seed=1, device="cpu")
    it = ds.batches(8, seed=2)
    next(it)
    second = next(it)
    want = _distill_batch(ds.params, random.fold_in(random.key(3, "cpu"), torch.tensor(1)),
                          ds.radius, second["near"], second["far"], 8, cfg)
    assert all(torch.equal(a, second[k]) for a, k in zip(want, ("origins", "dirs", "rgb")))


def test_cli_train_on_cpu(capsys):
    rc = cli_main(["train", "--device", "cpu", "--width", "64", "--v-width", "32", "--depth", "3",
                   "--skip-at", "1", "--steps", "3", "--batch-rays", "32", "--coarse-samples",
                   "8", "--fine-samples", "8", "--log-every", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = re.findall(r"^step (\d+): loss ([0-9.]+) psnr ([0-9.]+) \(([0-9,]+) rays/s fwd\+bwd\)$",
                       out, flags=re.M)
    assert [int(s) for s, *_ in lines] == [0, 1, 2], out
    assert "distilling from the pretrained lego networks" in out


def test_cli_train_int8qat_on_cpu(capsys):
    """train --impl int8qat distills a W8A8 student through the STE
    forward; the teacher renders through the fused kernel's path."""
    rc = cli_main(["train", "--device", "cpu", "--impl", "int8qat", "--width", "64", "--v-width",
                   "32", "--depth", "3", "--skip-at", "1", "--steps", "2", "--batch-rays", "32",
                   "--coarse-samples", "8", "--fine-samples", "8", "--log-every", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = re.findall(r"^step (\d+): loss ([0-9.]+) psnr", out, flags=re.M)
    assert [int(s) for s, _ in lines] == [0, 1], out


def test_cli_train_int8_is_inference_only():
    with pytest.raises(SystemExit) as exc:
        cli_main(["train", "--device", "cpu", "--impl", "int8"])
    assert "--impl int8 is inference-only" in str(exc.value.code)
