"""Pass 1's guided UNet call as one CUDA graph (`diffusion/pass1_graph.py`)
on the card, at tiny geometry: the graphed pass 1 against the eager one
(the same `GuidedEps` without the graph, `GraphedEps.eager`) bit for bit,
its final latents, eps table and trajectory; across a LoRA update that
`fused_unet()` loads into the twin in place; SDXL's added conditions and
v-prediction; a new batch captures again; an installed int8 weight set
and a grad-enabled context run eagerly; and the flash forward's launch
counter reads the same for a replayed pass as for an eager one.

These tests need an NVIDIA card and skip without one. The file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_pass1_graph_cuda.py
"""

import dataclasses

import pytest
import torch

from comat_tpu_torch.diffusion import pass1_graph
from comat_tpu_torch.diffusion.sampler import sample_inference
from comat_tpu_torch.diffusion.schedulers import make_sampler_coeffs
from comat_tpu_torch.models import quant
from comat_tpu_torch.models.pipeline import DiffusionPipeline, make_pipeline_config
from comat_tpu_torch.ops import flash_attention as fa
from comat_tpu_torch.text.tokenizer import HashTokenizer
from comat_tpu_torch.trace import PhaseClock

STEPS = 5
PROMPTS = ["a red car and a blue bird", "two green cats on a mat",
           "a yellow bus next to a brown horse"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pipe(name="sd_1_5", prediction_type="epsilon", seed=0, fuse_pass1=True, **unet):
    """A tiny pipeline at 128^2: its top level attends over 256 keys, so the
    self-attention there takes the flash kernel (SD1.5's topology). `unet`
    replaces fields of the tiny UNet's config."""
    cfg = make_pipeline_config(name, lora_rank=4, resolution=128, tiny=True,
                               prediction_type=prediction_type)
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, **unet))
    return DiffusionPipeline(cfg, device="cuda", seed=seed, fuse_pass1=fuse_pass1)


def _conditions(pipe, B):
    tok = HashTokenizer(1000)
    enc, null = tok(PROMPTS[:B], max_length=77), tok([""] * B, max_length=77)
    kw = {}
    if pipe.cfg.is_sdxl:
        tok2 = HashTokenizer(1000, pad_token_id=0)
        kw = dict(input_ids2=tok2(PROMPTS[:B], max_length=77)["input_ids"],
                  null_ids2=tok2([""] * B, max_length=77)["input_ids"])
    with torch.no_grad():
        return pipe._encode_pair(enc["input_ids"], null["input_ids"], enc["eos_positions"],
                                 None, kw.get("input_ids2"), kw.get("null_ids2"))


def _draws(pipe, B, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = pipe.cfg.latent_size
    return (torch.randn(B, s, s, 4, generator=g, device="cuda"),
            torch.randn(STEPS, B, s, s, 4, generator=g, device="cuda"))


def _model(pipe, B, rescale=0.0):
    enc, nenc, added, null_added = _conditions(pipe, B)
    return pipe._pass1_eps_model(enc.context, nenc.context, 7.5, rescale,
                                 pipe._pass1_unet(), added, null_added)


def _run(model, pipe, lat, noise):
    """(final latents, eps table, trajectory), and the clock's tallies."""
    clock = PhaseClock(torch.device("cuda"))
    with torch.no_grad(), clock.active():
        out = sample_inference(model, make_sampler_coeffs(pipe.schedule, STEPS), lat,
                               step_noise=noise)
    torch.cuda.synchronize()
    return out, clock.tallies


def _assert_equal(got, want):
    for name, g, w in zip(("latents", "eps table", "trajectory"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"{name}: max |diff| {(g - w).abs().max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_pass1_equals_eager_bit_for_bit(card, dtype):
    pipe = _pipe(dtype=dtype)
    model = _model(pipe, 2, rescale=0.7 if dtype == torch.float32 else 0.0)
    lat, noise = _draws(pipe, 2, 1)
    captures = pass1_graph.CAPTURES
    first, tallies = _run(model, pipe, lat, noise)
    assert pass1_graph.CAPTURES == captures + 1
    assert tallies == {"pass1_capture": 1, "pass1_eager": 1, "pass1_graph": STEPS - 1}
    launched = fa.KERNEL.launches
    graphed, tallies = _run(model, pipe, lat, noise)
    replayed = fa.KERNEL.launches - launched
    assert tallies == {"pass1_graph": STEPS} and pass1_graph.CAPTURES == captures + 1
    launched = fa.KERNEL.launches
    eager, tallies = _run(model.eager, pipe, lat, noise)
    assert tallies == {}
    # the flash forward ran in the graph, and its counter says so
    assert replayed == fa.KERNEL.launches - launched > 0
    _assert_equal(first, eager)
    _assert_equal(graphed, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_pass1", [True, False])
def test_a_lora_update_is_what_the_graph_replays(card, fuse_pass1):
    """Two presamples around an in-place LoRA update, as the optimizer makes
    it: the second replays the graph of the first (no capture), on the
    twin's weights as `fused_unet()` has just loaded them, or without the
    twin (--gradient_checkpointing) on the LoRA'd UNet's factors. A graph
    that held stale weights would give the first step's tables here."""
    pipe = _pipe(seed=4, fuse_pass1=fuse_pass1)
    tok = HashTokenizer(1000)
    enc, null = tok(PROMPTS[:2], max_length=77), tok([""] * 2, max_length=77)
    lat, noise = _draws(pipe, 2, 2)

    def presample():
        _, table, traj = pipe.presample(enc["input_ids"], null["input_ids"],
                                        num_inference_steps=STEPS,
                                        eos_positions=enc["eos_positions"], latents0=lat,
                                        step_noise=noise)
        return table, traj

    before, _ = presample()
    captures = pass1_graph.CAPTURES
    with torch.no_grad():
        for name, p in pipe.unet.named_parameters():
            if name.endswith("lora_b"):
                p.add_(0.05 * torch.randn_like(p))
    table, traj = presample()
    assert pass1_graph.CAPTURES == captures
    (_, eager_table, eager_traj), _ = _run(_model(pipe, 2).eager, pipe, lat, noise)
    assert torch.equal(table, eager_table) and torch.equal(traj, eager_traj)
    assert (table - before).abs().max() > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name,prediction_type", [("sdxl", "epsilon"),
                                                  ("sd_1_5", "v_prediction"),
                                                  ("sdxl", "v_prediction")])
def test_sdxl_added_conditions_and_v_prediction_replay_bit_for_bit(card, name,
                                                                   prediction_type):
    pipe = _pipe(name, prediction_type=prediction_type, seed=5)
    model = _model(pipe, 2)
    assert (model.eager.added is not None) == pipe.cfg.is_sdxl
    lat, noise = _draws(pipe, 2, 3)
    _run(model, pipe, lat, noise)
    graphed, tallies = _run(model, pipe, lat, noise)
    assert tallies == {"pass1_graph": STEPS}
    eager, _ = _run(model.eager, pipe, lat, noise)
    _assert_equal(graphed, eager)
    # another pass's conditions go through the static buffers
    other = _model(pipe, 2)
    other.eager.context.mul_(0.5)
    for v in (other.eager.added or {}).values():
        v.mul_(0.5)
    graphed, tallies = _run(other, pipe, lat, noise)
    assert tallies == {"pass1_graph": STEPS}
    eager, _ = _run(other.eager, pipe, lat, noise)
    _assert_equal(graphed, eager)


@pytest.mark.cuda
def test_a_new_batch_captures_again_and_one_graph_is_kept(card):
    pipe = _pipe(seed=6)
    captures = pass1_graph.CAPTURES
    for B, more in ((2, 1), (2, 0), (3, 1), (3, 0), (2, 1)):
        lat, noise = _draws(pipe, B, B)
        _, tallies = _run(_model(pipe, B), pipe, lat, noise)
        captures += more
        assert pass1_graph.CAPTURES == captures, B
        assert tallies.get("pass1_capture", 0) == more
        assert pipe.pass1_graph._static["x"].shape[0] == B


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["int8", "grad"])
def test_int8_weights_and_gradients_take_the_eager_loop(card, case):
    # the int8 kernels' shapes: conv channels % 64, more than 16 rows a linear
    pipe = _pipe(seed=7, block_out_channels=(64, 64, 64, 64))
    model = _model(pipe, 3)
    lat, noise = _draws(pipe, 3, 4)
    captures = pass1_graph.CAPTURES
    unet = pipe._pass1_unet()
    clock = PhaseClock(card)
    coeffs = make_sampler_coeffs(pipe.schedule, STEPS)
    with clock.active():
        if case == "int8":
            with torch.no_grad(), quant.pass1_w8a8(unet, True):
                sample_inference(model, coeffs, lat, step_noise=noise)
        else:
            with torch.enable_grad():
                model(lat, torch.tensor(981, device="cuda"))
    assert clock.tallies == {"pass1_eager": STEPS if case == "int8" else 1}
    assert pass1_graph.CAPTURES == captures and pipe.pass1_graph._graph is None
