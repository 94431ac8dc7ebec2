"""SDXL with --tune_text_encoder in the port against the JAX package, at
tiny geometry in fp32 on the CPU: both text towers train whole, and the
second tower's pooled output reaches the UNet through the added
condition, whose gradient JAX carries in `diff_tree["added"]` and the
port through the replay's inputs (`_CachedPrimalEps`).

The tiny SDXL pipeline, its second tower given a 32 -> 32
`text_projection` on both sides (the real bigG's 1280 -> 1280 stands
there; the tiny config has none), 64^2, total_step 4, K 2, LoRA rank 4;
JAX's `partition_params(tune_text_encoder=True)` (the UNet's LoRA, "text"
and "text2" whole) and `train_text_encoder`. Gates (`torch_step_parity`):
the loss within 1e-3 absolute, every trainable leaf's gradient and
post-step value within 1e-3 relative, `text2`'s leaves and its
`text_projection` among them; the projection's gradient is nonzero, which
it is only through the pooled embeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_step_parity import assert_step_matches, jax_case, port_pipeline, port_step

RES, STEPS, K, RANK = 64, 4, 2, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _projected(cfg):
    return dataclasses.replace(cfg, text2=dataclasses.replace(cfg.text2, projection_dim=32))


@pytest.fixture(scope="module")
def case():
    return jax_case("sdxl", RES, STEPS, K, RANK, edit_cfg=_projected,
                    partition=dict(tune_text_encoder=True), train_text_encoder=True)


@pytest.fixture(scope="module")
def port(case):
    pipe, blip, tcfg = port_pipeline(case, "sdxl", RANK, edit_cfg=_projected)
    assert pipe.text2.text_projection is not None
    return port_step(pipe, blip, tcfg, case["batch"], case["draws"],
                     tune_text_encoder=True)


def test_sdxl_tune_text_encoder_step_matches_jax(case, port):
    metrics, grads, after, _ = port
    assert_step_matches(case, metrics, grads, after,
                        must=("unet.", "text.", "text2.text_model.", "text2.text_projection"))


def test_pooled_embed_gradient_reaches_the_projection(case, port):
    _, grads, _, state = port
    proj = grads["text2.text_projection.weight"]
    assert np.isfinite(proj).all() and np.abs(proj).max() > 0
    assert {n.split(".")[0] for n in state.trainable} == {"unet", "text", "text2"}
