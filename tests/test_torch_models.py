"""The port's layers and models against the JAX package's, on the CPU.

JAX-initialised weights (with BN statistics and affine parameters drawn
from a seed, so that eval BatchNorm is not the identity) are carried
into the port through ``state_dict_from_jax``; both sides get the same
numpy inputs. JAX results are materialised before any torch compute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semseg_tpu.models import layers as jlayers
from semseg_tpu.models.convert import export_torch_state_dict
from semseg_tpu.models.pspnet import PSPNet as JPSPNet
from semseg_tpu.models.resnet import ResNet as JResNet
from semseg_tpu.models.resnet import ResNetClassifier as JResNetClassifier
from semseg_tpu.models.resnet import SEG_DILATIONS, SEG_STRIDES
from semseg_torch.models import build, convert, layers
from semseg_torch.models.psanet import PSANet
from semseg_torch.models.pspnet import PSPNet
from semseg_torch.models.resnet import ResNet, ResNetClassifier


def _randomize_bn(variables, seed):
    """Draw every BN's scale/bias/mean/var from a seed (numpy trees)."""
    rs = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])

    def walk(p, s):
        for k in p:
            if k == "bn":
                n = p[k]["scale"].shape
                p[k]["scale"] = rs.uniform(0.5, 1.5, n).astype(np.float32)
                p[k]["bias"] = (rs.randn(*n) * 0.1).astype(np.float32)
                s[k]["mean"] = (rs.randn(*n) * 0.1).astype(np.float32)
                s[k]["var"] = rs.uniform(0.5, 1.5, n).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def psp_variables():
    """JAX PSPNet50 (4 classes, aux head included) at a 33x33 input."""
    model = JPSPNet(layers=50, classes=4, zoom_factor=8)
    x = jnp.zeros((1, 33, 33, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    v = jax.jit(lambda k, x: model.init({"params": k, "dropout": k}, x, train=True))(key, x)
    return _randomize_bn(v, seed=1)


def test_state_dict_from_jax_matches_jax_exporter(psp_variables):
    want = export_torch_state_dict(psp_variables, "psp", 50, ddp_prefix=False)
    got = convert.state_dict_from_jax(psp_variables, "psp", 50)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = PSPNet(layers=50, classes=4, zoom_factor=8)
    model.load_state_dict(got, strict=True)
    assert sorted(model.state_dict()) == sorted(want)


def test_pspnet50_eval_logits_match_jax(psp_variables):
    """f32, zoomed logits and the feature-resolution form. Tolerance
    1e-4 abs: 50+ conv layers summed in a different order (XLA vs
    oneDNN) on logits of magnitude ~10 (measured: 3.7e-5)."""
    x = np.random.RandomState(0).randn(2, 33, 33, 3).astype(np.float32)
    jmodel = JPSPNet(layers=50, classes=4, zoom_factor=8)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        psp_variables, jnp.asarray(x)))
    want_low = np.asarray(jax.jit(
        lambda v, x: jmodel.clone(zoom_factor=1).apply(v, x, train=False)
    )(psp_variables, jnp.asarray(x)))

    model = PSPNet(layers=50, classes=4, zoom_factor=8).eval()
    model.load_state_dict(convert.state_dict_from_jax(psp_variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(xt)
        got_low = model(xt, zoom=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, 33, 33)
    assert tuple(got_low.shape) == (2, 4, 5, 5)
    scale = np.abs(want).max()
    assert 0.1 < scale < 100, scale
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_low.permute(0, 2, 3, 1).numpy(), want_low,
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["psp", "psa"])
def test_state_dict_from_jax_at_depth_101(arch):
    """The 101-layer recipes' models (``config/*/*_{psp,psa}net101.yaml``):
    the JAX PSPNet101 / PSANet101 variable tree (shapes from
    ``jax.eval_shape``, values drawn from a seed) through
    ``state_dict_from_jax(variables, arch, 101)`` equals the JAX exporter's
    entry for entry and loads strictly into the port's model, layer3's
    blocks 0-22 included."""
    from semseg_tpu.models.psanet import PSANet as JPSANet

    if arch == "psp":
        jmodel, model = JPSPNet(layers=101, classes=4), PSPNet(layers=101, classes=4)
    else:
        keys = dict(layers=101, classes=4, mask_h=9, mask_w=9)
        jmodel, model = JPSANet(**keys), PSANet(**keys)
    x = jax.ShapeDtypeStruct((1, 65, 65, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k, x: jmodel.init({"params": k, "dropout": k}, x,
                                                     train=True),
                            jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(101)
    variables = jax.tree.map(lambda s: rs.randn(*s.shape).astype(np.float32),
                             {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})
    want = export_torch_state_dict(variables, arch, 101, ddp_prefix=False)
    got = convert.state_dict_from_jax(variables, arch, 101)
    assert sorted(got) == sorted(want)
    assert {k.split(".")[1] for k in got if k.startswith("layer3.")} == {
        str(b) for b in range(23)}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("depth", [18, 50, 101])
def test_resnet_features_match_jax(depth):
    """Segmentation strides/dilations, all four stage outputs, f32; at
    depth 101 layer3's 23 blocks (two-digit block names) convert too.
    Tolerance rtol 1e-4 and atol 1e-4; at depth 101 the seeded eval
    BatchNorm grows layer3's and layer4's features to 5.4e4 and 7.3e4
    through the residual sums, so there atol is 1e-6 of the stage's largest
    magnitude (f32 sums of terms that size; measured at most 3.6e-7 of it,
    on elements near zero)."""
    jmodel = JResNet(depth=depth, stage_strides=SEG_STRIDES,
                     stage_dilations=SEG_DILATIONS)
    x = np.random.RandomState(3).randn(1, 17, 17, 3).astype(np.float32)
    v = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(depth), jnp.asarray(x))
    v = _randomize_bn(v, seed=depth)
    want = [np.asarray(f) for f in jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False))(v, jnp.asarray(x))]

    model = ResNet(depth, stage_strides=SEG_STRIDES,
                   stage_dilations=SEG_DILATIONS).eval()
    model.load_state_dict(convert.backbone_state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 4
    for g, w in zip(got, want):
        atol = 1e-4 if depth < 101 else 1e-6 * np.abs(w).max()
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   rtol=1e-4, atol=atol)


def test_resnet_classifier_matches_jax():
    """``ResNetClassifier`` depth 18 at 33x33, f32: JAX-initialised weights
    (seeded BN) through ``classifier_state_dict_from_jax`` (the ``fc``
    kernel transposed), logits within 1e-4; the port's own init draws
    ``fc`` as ``nn.Linear`` does, U(+-1/sqrt(512))."""
    jmodel = JResNetClassifier(depth=18, num_classes=10)
    x = np.random.RandomState(4).randn(2, 33, 33, 3).astype(np.float32)
    v = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(18), jnp.asarray(x))
    v = _randomize_bn(v, seed=18)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(v, jnp.asarray(x)))

    model = ResNetClassifier(depth=18, num_classes=10).eval()
    model.load_state_dict(convert.classifier_state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(model.fc.weight.detach().numpy(),
                                  np.asarray(v["params"]["fc"]["kernel"]).T)

    fresh = ResNetClassifier(depth=18, num_classes=10)
    fresh.init_weights(torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(512)
    for t in (fresh.fc.weight, fresh.fc.bias):
        assert t.abs().max().item() <= bound and t.std().item() > bound / 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_eval_matches_jax(dtype):
    """Eval BN: f32 statistics math, cast to the compute dtype. f32 is
    exact to rounding (rtol 1e-6); bf16 to one bf16 ulp."""
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 5, 6, 8) * 3).astype(np.float32)  # NHWC
    scale, bias = rs.uniform(0.5, 1.5, 8).astype(np.float32), rs.randn(8).astype(np.float32)
    mean, var = rs.randn(8).astype(np.float32), rs.uniform(0.5, 2, 8).astype(np.float32)
    jdt = jnp.dtype(dtype)
    bn = jlayers.BatchNorm(dtype=jdt)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    want = np.asarray(bn.apply(v, jnp.asarray(x, jdt), use_running_average=True),
                      np.float32)

    tdt = getattr(torch, dtype)
    m = layers.BatchNorm2d(8).eval()
    m.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                       "running_mean": torch.from_numpy(mean),
                       "running_var": torch.from_numpy(var),
                       "num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt))
    assert got.dtype == tdt
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def test_convbn_eval_matches_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 9, 9, 4).astype(np.float32)
    cb = jlayers.ConvBN(6, 3, strides=2, padding=2, dilation=2)
    v = cb.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    v = _randomize_bn({"params": {"m": v["params"]}, "batch_stats": {"m": v["batch_stats"]}}, 6)
    v = {"params": v["params"]["m"], "batch_stats": v["batch_stats"]["m"]}
    want = np.asarray(cb.apply(v, jnp.asarray(x), train=False))

    m = layers.ConvBN(4, 6, 3, stride=2, padding=2, dilation=2).eval()
    sd = {}
    convert._convbn(sd, v["params"], v["batch_stats"], "0", "1")
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert (got >= 0).all()  # ReLU
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


def test_init_distributions_and_placement():
    """Backbone convs: kaiming fan_out normal; PPM and heads: PyTorch's
    default U(+-1/sqrt(fan_in)); BN weight 1, bias 0. Seeded."""
    a = PSPNet(layers=50, classes=21)
    a.init_weights(torch.Generator().manual_seed(0))
    b = PSPNet(layers=50, classes=21)
    b.init_weights(torch.Generator().manual_seed(0))
    assert torch.equal(a.layer3[2].conv2.weight, b.layer3[2].conv2.weight)
    w = a.layer3[0].conv2.weight  # 256 out, 3x3
    assert abs(w.std().item() / (2.0 / (256 * 9)) ** 0.5 - 1) < 0.02
    for conv, fan_in in ((a.cls[0], 4096 * 9), (a.ppm.features[0][1], 2048),
                         (a.cls[4], 512)):
        bound = fan_in ** -0.5
        assert conv.weight.abs().max().item() <= bound * (1 + 1e-6)
        assert conv.weight.abs().max().item() > 0.9 * bound
    assert a.cls[4].bias.abs().max().item() <= 512 ** -0.5 * (1 + 1e-6)
    assert torch.equal(a.layer1[0].bn1.weight, torch.ones(64))
    assert torch.equal(a.layer1[0].bn1.bias, torch.zeros(64))


def test_load_pth_strips_ddp_prefix(tmp_path, psp_variables):
    sd = convert.state_dict_from_jax(psp_variables)
    path = str(tmp_path / "m.pth")
    torch.save({"epoch": 3, "state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    loaded = convert.load_pth(path)
    assert sorted(loaded) == sorted(sd)
    PSPNet(layers=50, classes=4).load_state_dict(loaded, strict=True)


def test_build_model_rules():
    from types import SimpleNamespace as NS

    cfg = NS(arch="psp", layers=50, classes=3, zoom_factor=8, train_h=33, train_w=33)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        m = build.build_model(cfg, dtype=torch.float32, device="cpu")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert not m.training and m.dtype == torch.float32 and m.classes == 3
    # arch psa builds PSANet; the mask derives from train_h/w and shrink
    psa = NS(**{**vars(cfg), "arch": "psa", "psa_type": 2, "compact": 0,
                "shrink_factor": 2, "normalization_factor": 1.0, "psa_softmax": 1})
    m = build.build_model(psa, device="cpu")
    assert isinstance(m, PSANet) and (m.psa.mask_h, m.psa.mask_w) == (5, 5)
    city = NS(**{**vars(psa), "train_h": 705, "train_w": 705})
    assert build.derive_psa_mask_dims(city) == (89, 89)
    assert build.derive_psa_mask_dims(NS(**{**vars(psa), "train_h": 465,
                                            "train_w": 465})) == (59, 59)
    assert build.derive_psa_mask_dims(NS(**{**vars(city), "compact": 1})) == (45, 45)
    assert build.derive_psa_mask_dims(NS(**{**vars(city), "mask_h": 7,
                                            "mask_w": 9})) == (7, 9)
    for mask in ((8, 9), (91, 89), (89, 1)):  # even, oversized, below 3
        with pytest.raises(ValueError, match="invalid"):
            build.derive_psa_mask_dims(NS(**{**vars(city), "mask_h": mask[0],
                                             "mask_w": mask[1]}))
    with pytest.raises(ValueError, match="both"):
        build.derive_psa_mask_dims(NS(**{**vars(city), "mask_h": 7}))
    with pytest.raises(ValueError):
        build.validate_arch(NS(**{**vars(cfg), "train_h": 32}))
    with pytest.raises(ValueError):
        build.validate_arch(NS(**{**vars(cfg), "zoom_factor": 3}))
    with pytest.raises(ValueError):
        PSPNet(layers=50, classes=3)(torch.zeros(1, 3, 32, 33))


def _eager_bn(bn, x):
    """Eval BatchNorm as the port computed it before the fused kernel:
    float32 statistics math, cast back to the input dtype."""
    shape = (1, -1, 1, 1)
    y = (x.float() - bn.running_mean.view(shape)) * torch.rsqrt(
        bn.running_var.view(shape) + bn.eps)
    return (y * bn.weight.view(shape) + bn.bias.view(shape)).to(x.dtype)


def _seeded_bn(bn, g):
    """Affine parameters and running statistics drawn from ``g``, so that
    eval BatchNorm is far from the identity."""
    with torch.no_grad():
        c = bn.num_features
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.3)
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.05)
    return bn


@pytest.mark.parametrize("variant", ["plain", "relu", "residual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_eval_reference_is_the_eager_path(dtype, variant):
    """``batchnorm_eval_reference`` (which CPU tensors and float32 models
    run) and the eval module equal the eager expression bit for bit: BN,
    then the activation dtype's add and the in-place ReLU."""
    from semseg_torch.ops.batchnorm import batchnorm_eval, batchnorm_eval_reference

    g = torch.Generator().manual_seed(7)
    bn = _seeded_bn(layers.BatchNorm2d(6), g).eval()
    x = (torch.randn(2, 6, 5, 7, generator=g) * 3).to(dtype)
    res = (torch.randn(2, 6, 5, 7, generator=g) * 2).to(dtype) if variant == "residual" else None
    want = _eager_bn(bn, x)
    if res is not None:
        want = want + res
    if variant != "plain":
        want = torch.relu_(want)
    with torch.no_grad():
        for got in (batchnorm_eval_reference(x, bn, residual=res, relu=variant != "plain"),
                    batchnorm_eval(x, bn, residual=res, relu=variant != "plain")):
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            assert got.dtype == dtype and torch.equal(got.view(bits), want.view(bits))
        if variant == "plain":
            assert torch.equal(bn(x), want)


def _unfused_block(block, x):
    """A residual block's eval forward as the port ran it before the BN
    calls took the ReLUs and the residual add in."""
    out = torch.relu_(_eager_bn(block.bn1, block.conv1(x)))
    if hasattr(block, "conv3"):
        out = torch.relu_(_eager_bn(block.bn2, block.conv2(out)))
        out = _eager_bn(block.bn3, block.conv3(out))
    else:
        out = _eager_bn(block.bn2, block.conv2(out))
    ds = block.downsample
    residual = x if ds is None else _eager_bn(ds[1], ds[0](x))
    return torch.relu_(out + residual)


def _seeded_block(kind, stride, seed):
    from semseg_torch.models.resnet import BasicBlock, Bottleneck, _stage

    block_cls, planes = (Bottleneck, 4) if kind == "bottleneck" else (BasicBlock, 16)
    block = _stage(block_cls, 16, planes, 1, stride, 1)[0]
    g = torch.Generator().manual_seed(seed)
    for m in block.modules():
        if isinstance(m, layers.BatchNorm2d):
            _seeded_bn(m, g)
        elif isinstance(m, torch.nn.Conv2d):
            layers.kaiming_normal_fan_out_(m.weight, g)
    return block, torch.relu(torch.randn(2, 16, 9, 9, generator=g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,stride", [("bottleneck", 1), ("bottleneck", 2), ("basic", 1),
                                         ("basic", 2)])
def test_eval_blocks_fold_relu_and_residual_bit_for_bit(kind, stride, dtype):
    """Eval ``Bottleneck`` and ``BasicBlock`` (with and without a
    ``downsample``) equal the unfused sequence bit for bit on seeded
    weights and running statistics."""
    block, x = _seeded_block(kind, stride, 11 + stride)
    assert (block.downsample is not None) == (stride == 2)
    block.eval()
    x = x.to(dtype)
    with torch.no_grad():
        got, want = block(x), _unfused_block(block, x)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("training", [False, True])
def test_batchnorm_eval_calls_by_mode(monkeypatch, training):
    """An eval PSPNet50 forward calls ``batchnorm_eval`` once for each of
    the 60 BatchNorms it runs (the ``aux`` head's runs only in training),
    the blocks' ReLUs and residual adds inside those calls. A train-mode
    forward never calls it."""
    calls = []

    def counting(x, bn, residual=None, relu=False):
        calls.append(bn)
        return original(x, bn, residual=residual, relu=relu)

    original = layers.batchnorm_eval
    monkeypatch.setattr(layers, "batchnorm_eval", counting)
    model = PSPNet(layers=50, classes=3, zoom_factor=8)
    model.init_weights(torch.Generator().manual_seed(0))
    model.train(training)
    x = torch.randn(2, 3, 33, 33, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model(x)
    bns = [m for name, m in model.named_modules()
           if isinstance(m, layers.BatchNorm2d) and not name.startswith("aux")]
    if training:
        assert calls == []
    else:
        assert len(calls) == len(bns) == 60 and {id(m) for m in calls} == {id(m) for m in bns}


@pytest.mark.parametrize("kind", ["bottleneck", "basic"])
def test_block_batchnorm_mode_is_each_batchnorms_own(kind):
    """A block in eval mode whose BatchNorms are in train mode normalises
    with batch statistics, as the all-train block does: each BN's own mode
    picks its path, and the block has one forward."""
    import copy

    block, x = _seeded_block(kind, 2, 5)
    mixed = copy.deepcopy(block)
    block.train()
    mixed.eval()
    for m in mixed.modules():
        if isinstance(m, layers.BatchNorm2d):
            m.train()
    with torch.no_grad():
        want, got = block(x), mixed(x)
    assert torch.equal(got, want)
    for a, b in zip(block.buffers(), mixed.buffers()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["relu", "residual"])
def test_train_batchnorm_folds_relu_and_residual_as_separate_ops(variant):
    """Train-mode ``BatchNorm2d(x, residual, relu)`` is the BN, then the
    add and the in-place ReLU, bit for bit, in the output, the running
    statistics and the gradients."""
    import copy

    g = torch.Generator().manual_seed(9)
    bn = _seeded_bn(layers.BatchNorm2d(6), g).train()
    ref = copy.deepcopy(bn)
    x = torch.randn(4, 6, 5, 7, generator=g, requires_grad=True)
    res = (torch.randn(4, 6, 5, 7, generator=g, requires_grad=True)
           if variant == "residual" else None)
    got = bn(x, residual=res, relu=True)
    want = ref(x)
    want = torch.relu_(want if res is None else want + res)
    assert torch.equal(got, want)
    for a, b in zip(bn.buffers(), ref.buffers()):
        assert torch.equal(a, b)
    leaves = [x, bn.weight, bn.bias] + ([res] if res is not None else [])
    grads = torch.autograd.grad(got.square().sum(), leaves)
    ref_leaves = [x, ref.weight, ref.bias] + ([res] if res is not None else [])
    for a, b in zip(grads, torch.autograd.grad(want.square().sum(), ref_leaves)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_batchnorm_after_training_uses_the_new_statistics(dtype):
    """Eval BatchNorm, between train-mode steps that move the running
    statistics, normalises with the statistics of the moment: the eager
    expression on the current buffers, bit for bit."""
    from semseg_torch.ops.batchnorm import batchnorm_eval

    g = torch.Generator().manual_seed(13)
    bn = _seeded_bn(layers.BatchNorm2d(6), g)
    x = (torch.randn(4, 6, 5, 7, generator=g) * 3).to(dtype)
    for _ in range(3):
        bn.train()
        with torch.no_grad():
            bn(torch.randn(4, 6, 5, 7, generator=g) * 2 + 1)
        bn.eval()
        with torch.no_grad():
            got, want = batchnorm_eval(x, bn, relu=True), torch.relu_(_eager_bn(bn, x))
        assert torch.equal(got, want)
