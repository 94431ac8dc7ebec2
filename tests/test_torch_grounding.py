"""The port's grounding losses (comat_tpu_torch/losses/grounding.py)
against the JAX ones, in fp32 on the CPU.

- The binarized mask resize equals JAX's exactly: `> 0` after an
  antialiased resize flips a pixel at any difference in which filter
  weights are zero, and the center-prior boxes are not aligned to the
  capture grid. Checked on CenterPrior masks at 128^2 and 512^2 at every
  capture resolution of the tiny (2, 4, 8, 16) and SD1.5 (8, 16, 32, 64)
  layer lists.
- The losses and their gradients into the maps within 1e-5 relative:
  a few fp32 contractions over at most 77 x 256 terms.
- `_bce_log`'s gradient is finite at 0, 1 and a subnormal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comat_tpu.losses import grounding as jg
from comat_tpu.segmentation.interface import CenterPriorSegmenter as JCenter
from comat_tpu_torch.losses import grounding as tg
from comat_tpu_torch.segmentation.interface import CenterPriorSegmenter

TOL = 1e-5
KEYS = ("mid_2", "up_4", "up_8")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel worker processes (pytest-xdist);
    one intra-op thread per worker keeps their torch work from
    oversubscribing the cores, which slows every worker many times."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    denom = max(np.abs(got).max(), np.abs(want).max(), 1e-12)
    return np.abs(got - want).max() / denom


def _center_masks(size, counts):
    """(len(counts), max(counts), size, size): sample b holds counts[b]
    center-prior boxes, the port's segmenter's, equal to JAX's."""
    out = np.zeros((len(counts), max(counts), size, size), np.float32)
    img = np.zeros((size, size, 3), np.float32)
    for b, n in enumerate(counts):
        nouns = [f"noun{i}" for i in range(n)]
        ours, theirs = CenterPriorSegmenter()(img, nouns), JCenter()(img, nouns)
        for w, (m, j) in enumerate(zip(ours, theirs)):
            assert np.array_equal(m, j)
            out[b, w] = m
    return out


@pytest.mark.parametrize("size,resolutions", [(128, (2, 4, 8, 16)),
                                              (512, (8, 16, 32, 64))])
def test_resized_masks_equal_jax(size, resolutions):
    masks = _center_masks(size, [1, 2, 3, 4, 5, 7])
    for res in resolutions:
        got = tg._resize_masks(torch.from_numpy(masks), res).numpy()
        want = np.asarray(jg._resize_masks(jnp.asarray(masks), res))
        assert got.shape == want.shape == (6, 7, res, res)
        assert np.array_equal(got, want), (res, int((got != want).sum()))
        assert got.any()


def _inputs(seed=0, B=2, W=4, T=3, heads=2, zeros=False):
    """Softmax maps per key (two layer instances each), token groups and
    masks; `zeros` puts exact zeros and ones into the word maps."""
    rng = np.random.default_rng(seed)
    captured = {}
    for key in KEYS:
        res = int(key.split("_")[1])
        maps = []
        for _ in range(2):
            logits = rng.standard_normal((2, B, heads, res * res, 77)).astype(np.float32)
            p = np.exp(logits)
            if zeros:
                p[..., 5:9] = 0.0                       # word tokens 5..8 get 0
                p[:, :, :, :1, :] = 0.0
                p[:, :, :, :1, 9] = 1.0                 # a pixel all on token 9
            maps.append((p / p.sum(-1, keepdims=True)).astype(np.float32))
        captured[key] = maps
    token_idx = rng.integers(1, 12, (B, W, T)).astype(np.int32)
    token_valid = rng.random((B, W, T)) < 0.7
    token_valid[:, :, 0] = True
    word_valid = np.array([[True, True, True, False], [True, True, False, False]])
    masks = _center_masks(64, [3, 2]).astype(np.float32)[:, :W]
    masks = np.pad(masks, ((0, 0), (0, W - masks.shape[1]), (0, 0), (0, 0)))
    return captured, masks, token_idx, token_valid, word_valid


def test_grounding_losses_for_layer_match_jax():
    captured, masks, token_idx, token_valid, word_valid = _inputs(seed=1)
    for key in KEYS:
        maps = [m[0] for m in captured[key]]
        want = jg.grounding_losses_for_layer(
            [jnp.asarray(m) for m in maps], jnp.asarray(masks), jnp.asarray(token_idx),
            jnp.asarray(token_valid), jnp.asarray(word_valid))
        got = tg.grounding_losses_for_layer(
            [torch.from_numpy(m) for m in maps], torch.from_numpy(masks),
            torch.from_numpy(token_idx).long(), torch.from_numpy(token_valid),
            torch.from_numpy(word_valid))
        for g, w in zip(got, want):
            assert g.shape == (2,)
            assert _rel(g.numpy(), w) <= TOL


@pytest.mark.parametrize("draws", [[0, 1], [3, 3], [2, 0, 2, 4, 0]])
def test_dedup_draw_weights_match_jax(draws):
    got = tg.dedup_draw_weights(torch.tensor(draws)).numpy()
    want = np.asarray(jg.dedup_draw_weights(jnp.asarray(draws)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("zeros", [False, True], ids=["softmax", "zeros_and_ones"])
def test_comat_grounding_loss_and_gradient_match_jax(zeros):
    """The total token and pixel losses over A = 2 segments (the second a
    repeat, weight 0) and their gradients into every captured map."""
    captured, masks, token_idx, token_valid, word_valid = _inputs(seed=2, zeros=zeros)
    weights = np.array([1.0, 0.0], np.float32)
    args = (masks, token_idx, token_valid, word_valid)

    def jloss(cap):
        tl, pl = jg.comat_grounding_loss(cap, jnp.asarray(weights),
                                         *map(jnp.asarray, args), 0, KEYS)
        return tl + 0.5 * pl, (tl, pl)

    (_, (jt, jp)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        {k: [jnp.asarray(m) for m in v] for k, v in captured.items()})
    cap = {k: [torch.tensor(m, requires_grad=True) for m in v] for k, v in captured.items()}
    tl, pl = tg.comat_grounding_loss(
        cap, torch.from_numpy(weights), torch.from_numpy(masks),
        torch.from_numpy(token_idx).long(), torch.from_numpy(token_valid),
        torch.from_numpy(word_valid), 0, KEYS)
    (tl + 0.5 * pl).backward()
    assert _rel(tl.detach(), jt) <= TOL and _rel(pl.detach(), jp) <= TOL
    for key in KEYS:
        for g, w in zip(cap[key], jgrad[key]):
            assert torch.isfinite(g.grad).all()
            assert _rel(g.grad.numpy(), w) <= TOL
            assert not g.grad[1].any()              # the repeat weighs 0


def test_bce_log_gradient_is_finite():
    x = torch.tensor([0.0, 1.0, 1e-40, 0.5, 1.0 - 2.0 ** -24], requires_grad=True)
    y = tg._bce_log(x) + tg._bce_log(1.0 - x)
    y.sum().backward()
    assert torch.isfinite(x.grad).all()
    assert y[0] == -100.0 and y[1] == -100.0 and y[2] == -100.0
    want = np.asarray(jg._bce_log(jnp.asarray(x.detach().numpy()))
                      + jg._bce_log(1.0 - jnp.asarray(x.detach().numpy())))
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-6)
