"""The text towers' LoRA (--train_text_encoder_lora) in the port against
the JAX package, at tiny geometry in fp32 on the CPU.

- `CLIPTextEncoder(lora_rank=4)` (q/k/v/out projections as
  `LoRALinear`) against JAX's `CLIPTextEncoder(lora_rank=4)` on the same
  weights, nonzero `lora_b` included: the final states, the penultimate
  states SDXL reads and the pooled output within 1e-5 of max abs.
- The SD1.5 step with `text_lora_rank` 4 and `train_text_encoder` (the
  trainer's --train_text_encoder_lora, with --textenc_lora_lr's group)
  against JAX's step: the loss within 1e-3 absolute, every trainable
  leaf's gradient and post-step value (the UNet's and the text tower's
  LoRA factors) within 1e-3 relative (`torch_step_parity`).
- A seeded pipeline gives its towers and the UNet's LoRA the same weights
  at every text-LoRA rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.config import CLIPTextConfig as JCLIPConfig
from comat_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from comat_tpu_torch import config as tcfg
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models.clip_text import CLIPTextEncoder
from comat_tpu_torch.weights import from_jax_params
from torch_step_parity import assert_step_matches, jax_case, port_pipeline, port_step, seeded_params

RES, STEPS, K, RANK = 64, 4, 2, 4
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("skip", [0, 1])
def test_lora_clip_matches_jax(skip):
    jax.config.update("jax_default_matmul_precision", "highest")
    model = JCLIP(JCLIPConfig.tiny(), lora_rank=RANK)
    ids = np.random.default_rng(0).integers(1, 1000, (2, 77)).astype(np.int32)
    eos = np.array([9, 76], np.int32)
    params = seeded_params(model.init, jax.random.PRNGKey(0), jnp.asarray(ids), seed=skip)
    want_h, want_p = model.apply(params, jnp.asarray(ids), jnp.asarray(eos),
                                 output_hidden_state_skip=skip)
    port = CLIPTextEncoder(tcfg.CLIPTextConfig.tiny(), lora_rank=RANK)
    sd = from_jax_params({"text": jax.tree_util.tree_map(np.asarray, params)})["text"]
    assert any(n.endswith("q_proj.base.weight") for n in sd)
    assert sum(n.endswith((".lora_a", ".lora_b")) for n in sd) == 4 * 2 * 2
    port.load_state_dict(sd)
    with torch.no_grad():
        h, p = port(torch.from_numpy(ids).long(), torch.from_numpy(eos).long(),
                    output_hidden_state_skip=skip)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=TOL, rtol=0)
    np.testing.assert_allclose(p.numpy(), np.asarray(want_p), atol=TOL, rtol=0)


def test_seeded_towers_do_not_depend_on_the_text_lora_rank():
    def sds(text_rank):
        cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=RANK, resolution=RES,
                                         tiny=True, text_lora_rank=text_rank)
        return tpipe.DiffusionPipeline(cfg, device="cpu", seed=3).state_dicts()

    plain, lora = sds(0), sds(RANK)
    for tower in ("unet", "vae"):
        assert all(torch.equal(lora[tower][n], t) for n, t in plain[tower].items())
    text = lora["text"]
    for n, t in plain["text"].items():
        m = n.replace("_proj.weight", "_proj.base.weight").replace(
            "_proj.bias", "_proj.base.bias") if "self_attn" in n else n
        assert torch.equal(text[m], t), n
    assert any(n.endswith("lora_a") for n in text)


@pytest.fixture(scope="module")
def case():
    return jax_case("sd_1_5", RES, STEPS, K, RANK, text_lora_rank=RANK,
                    train_text_encoder=True, textenc_lr=1e-4)


def test_text_lora_step_matches_jax(case):
    pipe, blip, tcfg_ = port_pipeline(case, "sd_1_5", RANK, text_lora_rank=RANK)
    metrics, grads, after, state = port_step(pipe, blip, tcfg_, case["batch"],
                                             case["draws"])
    assert_step_matches(case, metrics, grads, after, must=("unet.", "text."))
    text = [n for n in state.trainable if n.startswith("text.")]
    assert text and all(n.endswith((".lora_a", ".lora_b")) for n in text)
    # the text group's rate is --textenc_lora_lr's
    assert [g["lr"] for g in state.optimizer.adam.param_groups] == [5e-5, 1e-4]
