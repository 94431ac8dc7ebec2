"""A bf16 trained tensor used twice in a step sums its cotangents in fp32
at its master, as JAX sums the cotangents of its two casts of the fp32
leaf (`DiffusionPipeline.set_masters`, `_MasterView`; the pipeline's
encode_prompt is what the step runs on the prompts and on the null
prompts).

Tiny pipeline, the text tower in bf16 and trained
(`init_train_state(tune_text_encoder=True)`), CPU. The two encodings'
losses are backpropagated together and each alone: the master's
gradient of the joint pass equals the fp32 sum of the two single passes
bit for bit, the bf16 working copies get no gradient, and on at least
one leaf that sum differs from the bf16 sum autograd formed before at the
working copy.
"""

import dataclasses

import pytest
import torch

from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.training import train_step as tts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_text_tower_master_gradient_is_the_fp32_sum_of_both_uses():
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64, tiny=True)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, dtype=torch.bfloat16))
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", seed=0)
    state = tts.init_train_state(pipe, tts.TrainConfig(), tune_text_encoder=True)
    masters = {n: m for n, m in state.optimizer.masters.items()
               if n.startswith("text.") and m is not state.trainable[n]}
    assert masters and all(m.dtype == torch.float32 and m.requires_grad
                           and state.trainable[n].dtype == torch.bfloat16
                           for n, m in masters.items())
    tok = HashTokenizer(cfg.text.vocab_size)
    prompts = ["a red car and a blue bird", "two green cats on a mat"]
    enc, null = tok(prompts), tok([""] * 2)
    g = torch.Generator().manual_seed(1)
    w_p, w_n = (torch.randn(2, 77, cfg.text.hidden_size, generator=g) for _ in range(2))

    def grads(use_prompt, use_null):
        state.optimizer.zero_grad()
        loss = 0.0
        if use_prompt:
            ctx = pipe.encode_prompt(enc["input_ids"], enc["eos_positions"], True).context
            loss = loss + (ctx.float() * w_p).sum()
        if use_null:
            ctx = pipe.encode_prompt(null["input_ids"], None, True).context
            loss = loss + (ctx.float() * w_n).sum()
        loss.backward()
        assert all(state.trainable[n].grad is None for n in masters)
        return {n: m.grad.clone() for n, m in masters.items() if m.grad is not None}

    both, g_prompt, g_null = grads(True, True), grads(True, False), grads(False, True)
    assert set(both) == set(g_prompt) == set(g_null) and len(both) > 10
    for n in both:
        assert torch.equal(both[n], g_prompt[n] + g_null[n]), n
    # the bf16 sum at the working copy, as autograd formed it before
    bf16_sum = {n: (g_prompt[n].bfloat16() + g_null[n].bfloat16()).float() for n in both}
    assert any(not torch.equal(both[n], bf16_sum[n]) for n in both)
    # the optimizer takes the masters' gradients
    grads(True, True)
    before = {n: m.detach().clone() for n, m in masters.items()}
    state.optimizer.step()
    moved = [n for n in masters if not torch.equal(before[n], masters[n].detach())]
    assert len(moved) == len(masters)
    assert all(torch.equal(state.trainable[n].detach(), masters[n].detach().bfloat16())
               for n in masters)
    assert set(pipe.masters) == set(masters)
