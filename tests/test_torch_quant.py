"""The port's W8A8 pass 1 (comat_tpu_torch/models/quant.py, ops/quant.py)
against the JAX package's comat_tpu/models/quant.py, at tiny geometry on
the CPU, on the same numpy inputs:

- the activation and weight codes and scales (`_quant_dynamic` per token
  and per sample, `_weight_quant` of a dense, conv and GEGLU kernel) equal
  exactly, values on a .5 boundary of the code grid included (both round
  half to even);
- the int32 sums of the linear, GEGLU, 3x3 (stride 1 and 2) and 1x1 conv
  products equal exactly;
- the int8 layers' outputs (`QDense`, `QDenseGeneral`, `QConv` against
  `QLinear` / `QConv2d` with an installed weight set) within 1 ulp;
- the set of quantized weights equals JAX's `quantize_unet_tree` set, by
  name through weights.py, for the tiny SD1.5 and SDXL UNets, and the
  modules are plain again after `installed`;
- the tiny SD1.5 UNet's int8 forward (LoRA fused, then quantized) within
  1e-5 of max abs of JAX's (`fused_params(int8=True)`). The CUDA kernels
  are held to these plain versions on the card (`tests/test_torch_quant_cuda.py`,
  chip_smoke.py phase 18).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from comat_tpu.models import pipeline as jpipe
from comat_tpu.models.quant import (
    QConv, QDense, QDenseGeneral, _quant_dynamic, _weight_quant, quantize_unet_tree,
)
from comat_tpu_torch.models import pipeline as tpipe
from comat_tpu_torch.models.quant import (
    QConv2d, QLinear, W8A8Weight, installed, quantize_unet, weight_quant,
)
from comat_tpu_torch.ops import quant as tq
from comat_tpu_torch.weights import _unet_rule, from_jax_params
from torch_step_parity import seeded_params

FORWARD_TOL = 1e-5
JIT_ULPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per xdist worker (see tests/test_torch_text_lora.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _on_grid(x):
    """Rows whose absmax is 127 * 2^k, so the scale is a power of two and
    x / s lands exactly on k + 0.5 for the values planted there."""
    x = x.copy()
    flat = x.reshape(-1, x.shape[-1])
    for i, row in enumerate(flat):
        s = 2.0 ** (i % 3 - 1)
        row[0] = 127 * s
        row[1:9] = s * np.array([0.5, -0.5, 1.5, -2.5, 3.5, 126.5, -126.5, 64.5])
    return x


def test_activation_codes_and_scales_equal_jax():
    x = _on_grid(_rng(0).standard_normal((3, 5, 40)).astype(np.float32))
    q, s = _quant_dynamic(jnp.asarray(x), reduce_axes=2)
    tq_, ts = tq.quantize(torch.tensor(x).reshape(15, 40), 15)
    np.testing.assert_array_equal(tq_.numpy().reshape(x.shape), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s).reshape(-1))
    # the .5 boundaries round half to even on both sides
    assert tq_[0, 1:9].tolist() == [0, 0, 2, -2, 4, 126, -126, 64]
    # per sample over (H, W, C), a conv's NHWC activation; bf16 too
    xc = _on_grid(_rng(1).standard_normal((2, 4, 4, 48)).astype(np.float32))
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        xj = jnp.asarray(xc).astype(dt_j)
        q, s = _quant_dynamic(xj, reduce_axes=(1, 2, 3))
        tq_, ts = tq.quantize(torch.tensor(np.asarray(xj.astype(jnp.float32))).to(dt_t), 2)
        np.testing.assert_array_equal(tq_.numpy(), np.asarray(q))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s).reshape(-1))


@pytest.mark.parametrize("kind", ["dense", "conv", "geglu"])
def test_weight_codes_and_scales_equal_jax(kind):
    rng = _rng(2)
    shape = {"dense": (40, 24), "conv": (3, 3, 16, 8), "geglu": (16, 2, 12)}[kind]
    k = rng.standard_normal(shape).astype(np.float32) / 4
    q, s = _weight_quant(jnp.asarray(k))
    q, s = np.asarray(q), np.asarray(s)
    if kind == "dense":
        w, want_q, want_s = k.T, q.T, s
    elif kind == "conv":       # HWIO -> OIHW; the port's codes (O, (H, W, I))
        w, want_q, want_s = k.transpose(3, 2, 0, 1), q.transpose(3, 0, 1, 2).reshape(8, -1), s
    else:                      # (dim, 2, 4d) -> diffusers' flat (8d, dim), values first
        w, want_q, want_s = k.reshape(16, -1).T, q.reshape(16, -1).T, s.reshape(-1)
    got_q, got_s = weight_quant(torch.tensor(np.ascontiguousarray(w)))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


CONVS = [(3, 1, 1), (3, 2, 1), (1, 1, 0)]   # (kernel, stride, padding)


@pytest.mark.parametrize("ks,stride,pad", CONVS)
def test_conv_int32_sums_equal_jax(ks, stride, pad):
    rng = _rng(3)
    xq = rng.integers(-127, 128, (2, 8, 8, 64)).astype(np.int8)
    kq = rng.integers(-127, 128, (ks, ks, 64, 24)).astype(np.int8)
    dn = lax.conv_dimension_numbers(xq.shape, kq.shape, ("NHWC", "HWIO", "NHWC"))
    want = lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(kq), (stride, stride),
                                    [(pad, pad)] * 2, dimension_numbers=dn,
                                    preferred_element_type=jnp.int32)
    wq = torch.tensor(kq.transpose(3, 0, 1, 2).reshape(24, -1).copy())
    got = tq.conv_s8(torch.tensor(xq), wq, ks, stride, pad, torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("features", [24, (2, 12)])
def test_linear_and_geglu_int32_sums_equal_jax(features):
    rng = _rng(4)
    xq = rng.integers(-127, 128, (2, 9, 40)).astype(np.int8)
    shape = (40, features) if isinstance(features, int) else (40, *features)
    kq = rng.integers(-127, 128, shape).astype(np.int8)
    want = lax.dot_general(jnp.asarray(xq), jnp.asarray(kq), (((2,), (0,)), ((), ())),
                           preferred_element_type=jnp.int32)
    wq = torch.tensor(kq.reshape(40, -1).T.copy())
    got = torch._int_mm(torch.tensor(xq).reshape(18, 40), wq.t())
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), np.asarray(want))


def _assert_within_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("features,bias", [(24, True), (24, False), ((2, 12), True)])
def test_int8_linear_output_within_one_ulp_of_jax(features, bias):
    rng = _rng(5)
    x = rng.standard_normal((2, 9, 40)).astype(np.float32)
    layer = (QDense(features, use_bias=bias) if isinstance(features, int)
             else QDenseGeneral(features, use_bias=bias))
    shape = (40, features) if isinstance(features, int) else (40, *features)
    p = {"kernel": rng.standard_normal(shape).astype(np.float32) / 6}
    if bias:
        p["bias"] = rng.standard_normal(shape[1:]).astype(np.float32)
    want = layer.apply({"params": quantize_unet_tree(jax.tree_util.tree_map(jnp.asarray, p))},
                       jnp.asarray(x))
    n = int(np.prod(shape[1:]))
    port = QLinear(40, n, bias=bias)
    with torch.no_grad():
        port.weight.copy_(torch.tensor(p["kernel"].reshape(40, n).T.copy()))
        if bias:
            port.bias.copy_(torch.tensor(p["bias"].reshape(-1)))
    port.w8a8 = W8A8Weight(*weight_quant(port.weight), port.bias.detach() if bias else None)
    got = port(torch.tensor(x))
    _assert_within_ulp(got.detach().numpy(), np.asarray(want).reshape(2, 9, n))


@pytest.mark.parametrize("ks,stride,pad", CONVS)
def test_int8_conv_output_within_one_ulp_of_jax(ks, stride, pad):
    rng = _rng(6)
    x = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    p = {"kernel": rng.standard_normal((ks, ks, 64, 24)).astype(np.float32) / 20,
         "bias": rng.standard_normal(24).astype(np.float32)}
    conv = QConv(24, (ks, ks), strides=(stride, stride), padding=pad)
    want = conv.apply({"params": quantize_unet_tree(jax.tree_util.tree_map(jnp.asarray, p))},
                      jnp.asarray(x))
    port = QConv2d(64, 24, ks, stride=stride, padding=pad)
    with torch.no_grad():
        port.weight.copy_(torch.tensor(p["kernel"].transpose(3, 2, 0, 1).copy()))
        port.bias.copy_(torch.tensor(p["bias"]))
    port.w8a8 = W8A8Weight(*weight_quant(port.weight), port.bias.detach())
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = port(xt).permute(0, 2, 3, 1)
    _assert_within_ulp(got.detach().numpy(), np.asarray(want))


def _int8_names(unet_tree):
    """Port weight names of the int8 kernels of JAX's quantize_unet_tree."""
    shapes = jax.eval_shape(quantize_unet_tree, unet_tree)
    names = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        if leaf.dtype == jnp.int8:
            keys = tuple(str(getattr(k, "key", k)) for k in path)
            names.add(_unet_rule(keys)[0])
    return names


@pytest.mark.parametrize("name,res", [("sd_1_5", 64), ("sdxl", 128)])
def test_quantized_set_equals_jax_by_name(name, res):
    jcfg = jpipe.make_pipeline_config(name, lora_rank=0, resolution=res, tiny=True)
    tree = jax.eval_shape(jpipe.DiffusionPipeline(jcfg).init_params, jax.random.PRNGKey(0))
    want = _int8_names(tree["unet"]["params"] if "params" in tree["unet"] else tree["unet"])
    cfg = tpipe.make_pipeline_config(name, lora_rank=4, resolution=res, tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu")
    twin = pipe.fused_unet()
    weights = quantize_unet(twin)
    assert {f"{n}.weight" for n in weights} == want
    # the LoRA'd UNet (the unfused pass 1) quantizes the same layers: the
    # attention projections' bases, its LoRA factors left out
    assert set(quantize_unet(pipe.unet)) == set(weights)
    before = {k: v.clone() for k, v in twin.state_dict().items()}
    with installed(twin, weights):
        assert all(twin.get_submodule(n).w8a8 is w for n, w in weights.items())
    assert all(m.w8a8 is None for m in twin.modules() if isinstance(m, (QLinear, QConv2d)))
    after = twin.state_dict()
    assert after.keys() == before.keys()
    assert all(torch.equal(after[k], before[k]) for k in before)


def test_int8_unet_forward_matches_jax():
    jax.config.update("jax_default_matmul_precision", "highest")
    jcfg = jpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64, tiny=True)
    jp = jpipe.DiffusionPipeline(jcfg)
    params = seeded_params(jp.init_params, jax.random.PRNGKey(0), seed=0)
    rng = _rng(7)
    s = jcfg.latent_size
    lat = rng.standard_normal((2, s, s, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, jcfg.unet.cross_attention_dim)).astype(np.float32)
    t = np.array([981, 501], np.int32)

    @jax.jit
    def run(params, lat, t, ctx):
        return jp.unet_apply(jp.fused_params(params, int8=True), lat, t, ctx, fused=True)[0]

    want = np.asarray(run(params, lat, t, ctx))
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64, tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", params=from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    twin = pipe.fused_unet()
    with torch.no_grad(), installed(twin, quantize_unet(twin)):
        got = pipe.unet_apply(torch.tensor(lat), torch.tensor(t), torch.tensor(ctx),
                              fused=True).numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= FORWARD_TOL, err


def test_every_int8_layer_equals_jax_on_jax_activations():
    """Each quantized layer of the tiny SD1.5 UNet, fed the input that JAX's
    own jitted int8 forward gave the same layer (recorded through
    `nn.intercept_methods`), returns JAX's output: the codes, sums and
    dequantize of every layer at the activations a real forward makes,
    with no dependence on the two sides' fp32 roundoff upstream. Inside
    jit XLA's fused program does not keep `_dequant_bias`'s order (it
    reorders the two scale products and contracts the bias add: up to 4
    ulps against its own eager result, measured), so the bound is
    JIT_ULPS ulps of the output and of its pre-bias product; one differing
    code moves an output by ~1/127 of its row, far above it."""
    import flax.linen as nn

    jax.config.update("jax_default_matmul_precision", "highest")
    jcfg = jpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64, tiny=True)
    jp = jpipe.DiffusionPipeline(jcfg)
    params = seeded_params(jp.init_params, jax.random.PRNGKey(0), seed=0)
    rng = _rng(8)
    s = jcfg.latent_size
    lat = rng.standard_normal((4, s, s, 4)).astype(np.float32)
    ctx = rng.standard_normal((4, 77, jcfg.unet.cross_attention_dim)).astype(np.float32)
    paths = []

    @jax.jit
    def run(params, lat, ctx):
        seen = []

        def record(next_fun, args, kwargs, context):
            y = next_fun(*args, **kwargs)
            if (isinstance(context.module, (QDense, QDenseGeneral, QConv))
                    and context.method_name == "__call__"):
                paths.append(tuple(context.module.scope.path))
                seen.append((args[0], y))
            return y

        with nn.intercept_methods(record):
            jp.unet_apply(jp.fused_params(params, int8=True), lat, jnp.asarray(981), ctx,
                          fused=True)
        return seen

    seen = jax.tree_util.tree_map(np.asarray, run(params, lat, ctx))
    cfg = tpipe.make_pipeline_config("sd_1_5", lora_rank=4, resolution=64, tiny=True)
    pipe = tpipe.DiffusionPipeline(cfg, device="cpu", params=from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    twin = pipe.fused_unet()
    weights = quantize_unet(twin)
    names = [_unet_rule(p + ("kernel",))[0][:-len(".weight")] for p in paths]
    assert sorted(names) == sorted(weights)     # every quantized layer, once
    with torch.no_grad(), installed(twin, weights):
        for name, (x, y) in zip(names, seen):
            layer = twin.get_submodule(name)
            if isinstance(layer, QConv2d):
                got = layer(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            else:
                got = layer(torch.tensor(x))
            want = np.asarray(y).reshape(got.shape)
            bias = 0.0 if layer.bias is None else layer.bias.numpy()
            ulps = np.spacing(np.abs(want)) + np.spacing(np.abs(want - bias))
            worst = float(np.max(np.abs(got.numpy() - want) / ulps))
            assert worst <= JIT_ULPS, (name, worst)
