"""--full_finetuning in the port (the whole UNet trains: base weights and
LoRA) against the JAX package, at tiny geometry on the CPU.

- The fp32 SD1.5 step with `full_finetuning` against JAX's
  (`partition_params(full_finetuning=True)`): the loss within 1e-3
  absolute, every UNet leaf's gradient and post-step value within 1e-3
  relative (`torch_step_parity`).
- The bf16 UNet with fp32 masters: the replay's gradients land on the
  masters in fp32 (the working copies get none), the K segments summed
  there; the step writes each master back rounded into its bf16 working
  copy. The LoRA factors' gradients equal those of the bf16 LoRA-only
  step bit for bit, and the base weights' gradients are no further from
  the fp32 step's than the LoRA factors' are (within NOISE_RATIO, L2 over
  each group): the bf16 UNet's own rounding puts both ~10 % from fp32 at
  this geometry.
- Pass 1's fused twin reloads the updated base weights.
- The discriminator takes a frozen copy of the generator's base
  (`copy_base`): after two steps its base equals its initial values and
  holds no gradient, while the generator's base has moved; D's default
  device goes through `resolve_device` (CUDA unless asked for the CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

from comat_tpu_torch.losses import gan as tgan
from comat_tpu_torch.models.lora import fuse_lora
from comat_tpu_torch.training import train_step as tts
from torch_step_parity import assert_step_matches, jax_case, port_pipeline, port_step

RES, STEPS, K, RANK = 64, 4, 2, 4
NOISE_RATIO = 1.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    return jax_case("sd_1_5", RES, STEPS, K, RANK, partition=dict(full_finetuning=True))


@pytest.fixture(scope="module")
def fp32_step(case):
    pipe, blip, tcfg = port_pipeline(case, "sd_1_5", RANK)
    return pipe, port_step(pipe, blip, tcfg, case["batch"], case["draws"],
                           full_finetuning=True)


def test_full_finetuning_step_matches_jax(case, fp32_step):
    pipe, (metrics, grads, after, state) = fp32_step
    n_unet = sum(1 for _ in pipe.unet.parameters())
    assert len(state.trainable) == n_unet and all(n.startswith("unet.") for n in grads)
    assert_step_matches(case, metrics, grads, after, must=("unet.conv_in.", "unet.mid_block."))


def test_fused_twin_reloads_the_updated_base(case, fp32_step):
    pipe, (_, _, _, state) = fp32_step
    assert pipe.unet_inf is not None
    before = case["weights"]["unet"]["conv_in.weight"]
    twin = pipe.fused_unet().state_dict()
    want = fuse_lora(pipe.unet.state_dict())
    assert twin.keys() == want.keys()
    assert all(torch.equal(twin[n], want[n]) for n in want)
    assert not torch.equal(twin["conv_in.weight"], before)
    assert torch.equal(twin["conv_in.weight"], state.trainable["unet.conv_in.weight"])


def _bf16_step(case, full_finetuning):
    pipe, blip, tcfg = port_pipeline(
        case, "sd_1_5", RANK, edit_cfg=lambda c: dataclasses.replace(
            c, unet=dataclasses.replace(c.unet, dtype=torch.bfloat16)))
    masters = {f"unet.{n}": t for n, t in case["weights"]["unet"].items()}
    return pipe, port_step(pipe, blip, tcfg, case["batch"], case["draws"],
                           full_finetuning=full_finetuning, initial_masters=masters)


def _l2(got, want, names):
    g = np.concatenate([got[n].ravel() for n in names])
    w = np.concatenate([want[n].ravel() for n in names])
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def test_bf16_unet_trains_through_fp32_masters(case, fp32_step):
    _, (_, want, _, _) = fp32_step
    pipe, (_, grads, _, state) = _bf16_step(case, True)
    opt = state.optimizer
    bf16 = [n for n, p in state.trainable.items() if p.dtype == torch.bfloat16]
    assert bf16 and set(bf16) == {n for n, m in opt.masters.items()
                                  if m is not state.trainable[n]}
    assert set(pipe.masters) == set(bf16)
    for n in bf16:
        assert opt.masters[n].dtype == torch.float32
        assert state.trainable[n].grad is None, n
        assert torch.equal(state.trainable[n], opt.masters[n].to(torch.bfloat16)), n
    _, (_, lora_grads, _, _) = _bf16_step(case, False)
    lora = sorted(lora_grads)
    assert lora and all(np.array_equal(grads[n], lora_grads[n]) for n in lora)
    base = sorted(set(want) - set(lora))
    assert set(bf16) <= set(base)
    assert _l2(grads, want, base) <= NOISE_RATIO * _l2(grads, want, lora), (
        _l2(grads, want, base), _l2(grads, want, lora))


def _gan_run(case, steps=2):
    pipe, blip, tcfg = port_pipeline(case, "sd_1_5", RANK)
    tcfg = dataclasses.replace(tcfg, gan_loss=True)
    state = tts.init_train_state(pipe, tcfg, full_finetuning=True)
    disc = tgan.Discriminator(pipe.cfg.unet, tgan.GanConfig(lora_rank=RANK), device="cpu",
                              base_unet=pipe.unet, seed=2, copy_base=True)
    d_state = tts.init_disc_state(disc, tcfg)
    base = {n: p.detach().clone() for n, p in disc.unet.named_parameters()
            if "lora_" not in n}
    g_before = {n: p.detach().clone() for n, p in state.trainable.items()}
    batch = dict(case["batch"], gt_latents=np.random.default_rng(0).standard_normal(
        (2, RES // 8, RES // 8, 4)).astype(np.float32))
    step = tts.make_train_step(pipe, blip, tcfg, disc=disc, d_optimizer=d_state.optimizer)
    for _ in range(steps):
        state, metrics = step(state, batch, case["draws"])
    return pipe, disc, state, base, g_before, metrics


def test_discriminator_base_stays_at_its_initial_values(case):
    pipe, disc, state, base, g_before, metrics = _gan_run(case)
    assert "D_loss" in metrics and "G_loss" in metrics
    g_ids = {id(p) for p in pipe.unet.parameters()}
    d_base = dict(disc.unet.named_parameters())
    assert base and not any(id(d_base[n]) in g_ids for n in base)
    for n, value in base.items():
        assert torch.equal(d_base[n], value) and d_base[n].grad is None, n
        assert not d_base[n].requires_grad, n
    moved = [n for n in base if not torch.equal(state.trainable[f"unet.{n}"],
                                                g_before[f"unet.{n}"])]
    assert len(moved) > len(base) // 2
    # D's own tensors trained
    assert any(p.grad is not None for n, p in disc.named_parameters()
               if "lora_" in n or n.startswith("head."))


def test_discriminator_device_goes_through_resolve_device():
    cfg = tts.TrainConfig()  # noqa: F841 (the module builds without a card)
    from comat_tpu_torch.config import UNetConfig

    disc = tgan.Discriminator(UNetConfig.tiny(), tgan.GanConfig(lora_rank=RANK),
                              device="cpu")
    assert {p.device.type for p in disc.parameters()} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgan.Discriminator(UNetConfig.tiny(), tgan.GanConfig(lora_rank=RANK))
