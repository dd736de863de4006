"""The port's tensor-parallel sharding plan against the JAX package's
(``semseg_tpu/parallel/sharding_rules.py``), on the CPU.

The JAX side's sharded leaves are carried through ``state_dict_from_jax``
as markers (ones where ``tp_spec_for_leaf`` shards, zeros elsewhere), so
the set of port names is exactly what the converter maps JAX's choice to.
JAX's placed shards on a ``(data 1, model 2)`` mesh of the conftest's
virtual CPU devices are held to the port's shards of the same converted
weights, bit for bit. Weights and momentum come from seeds with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from semseg_tpu.engine.optim import SGDState
from semseg_tpu.engine.trainer import TrainState
from semseg_tpu.models.psanet import PSANet as JPSANet
from semseg_tpu.models.pspnet import PSPNet as JPSPNet
from semseg_tpu.parallel.sharding_rules import shard_train_state, tp_spec_for_leaf
from semseg_torch.engine.optim import make_sgd
from semseg_torch.models.convert import state_dict_from_jax
from semseg_torch.models.psanet import PSANet
from semseg_torch.models.pspnet import PSPNet
from semseg_torch.parallel import tensor


def _models(arch, crop, mask):
    """The JAX model, the port's of the same widths, the crop to init at."""
    if arch == "psp":
        return (JPSPNet(layers=50, classes=5, zoom_factor=8),
                PSPNet(layers=50, classes=5, zoom_factor=8))
    kw = dict(layers=50, classes=5, zoom_factor=8, psa_type=2, shrink_factor=2, mask_h=mask,
              mask_w=mask, normalization_factor=1.0)
    return JPSANet(**kw, fused_attention=False), PSANet(**kw)


def _init(jmodel, crop, shapes_only=False):
    x = jnp.zeros((1, crop, crop, 3), jnp.float32)
    fn = lambda k, x: jmodel.init({"params": k, "dropout": k}, x, train=True)  # noqa: E731
    if shapes_only:
        return jax.eval_shape(fn, jax.random.PRNGKey(0), x)
    return jax.tree.map(np.asarray, jax.jit(fn)(jax.random.PRNGKey(0), x))


def _jax_sharded_names(variables, arch):
    """The port names of the leaves ``tp_spec_for_leaf`` shards: a marker
    tree (ones where the spec names the model axis) converted."""
    def marker(path, leaf):
        spec = tp_spec_for_leaf(path, leaf)
        return np.full(leaf.shape, float(spec != P()), np.float32)

    marked = {k: jax.tree_util.tree_map_with_path(marker, variables[k])
              for k in ("params", "batch_stats")}  # each tree as shard_train_state places it
    sd = state_dict_from_jax(marked, arch)
    return {k for k, v in sd.items() if v.is_floating_point() and v.numel() and bool(v.all())}


@pytest.mark.parametrize("arch,crop,mask", [("psp", 33, None), ("psa", 129, 17)],
                         ids=["pspnet50", "psanet50-mask17x17"])
def test_tp_plan_is_what_jax_shards(arch, crop, mask):
    """``tp_plan`` of the port's model names exactly the parameters and
    BatchNorm buffers whose JAX leaves ``tp_spec_for_leaf`` shards, with
    their full output channels: for PSPNet50 the PPM branches, ``cls.0/.1``
    and ``aux.0/.1`` (256 channels, at the threshold); for PSANet50 at a
    17x17 mask (289 channels, odd) also ``psa.attention{,_p}.3``, which
    JAX names ``attention_conv``, not ``conv_logits``."""
    jmodel, model = _models(arch, crop, mask)
    variables = _init(jmodel, crop, shapes_only=True)
    want = _jax_sharded_names(variables, arch)
    plan = tensor.tp_plan(model)
    assert set(plan) == want
    sd = model.state_dict()
    assert all(plan[k] == sd[k].shape[0] for k in plan)
    if arch == "psp":
        assert {"ppm.features.3.1.weight", "cls.0.weight", "aux.1.running_var"} <= want
        assert len(want) == 4 * 5 + 2 * 5
    else:
        assert plan["psa.attention_p.3.weight"] == 289
        assert {"psa.reduce.1.bias", "psa.proj.0.weight", "psa.attention.1.weight"} <= want
        assert len(want) == 2 * 5 + 2 * 6 + 5 + 2 * 5
    assert not any(k.startswith(("cls.4", "aux.4", "layer")) for k in want)


def _randomize(tree, rs):
    return jax.tree.map(lambda a: rs.randn(*a.shape).astype(np.float32), tree)


@pytest.mark.parametrize("arch", ["psp", "psa"], ids=["pspnet50", "psanet50"])
def test_shards_equal_jax_device_shards(arch):
    """JAX's ``shard_train_state`` on a ``(1, 2)`` mesh (data 1, model 2):
    each device's shard of every parameter, BatchNorm statistic and
    momentum leaf, converted to the port's names, equals the port's shard
    at that model index of the converted full state (``shard_state_dict``,
    and ``shard_optimizer_state`` of a port SGD state holding the momentum)
    bit for bit; ``gather_state_dict`` of the shards gives the full state
    back."""
    jmodel, model = _models(arch, 33, 5)
    variables = _init(jmodel, 33)
    rs = np.random.RandomState(7)
    params, stats = _randomize(variables["params"], rs), _randomize(variables["batch_stats"], rs)
    momentum = _randomize(params, rs)
    state = TrainState(params=params, batch_stats=stats, opt=SGDState(momentum=momentum),
                       step=jnp.zeros((), jnp.int32))
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    placed = shard_train_state(state, mesh)

    full = state_dict_from_jax({"params": params, "batch_stats": stats}, arch)
    mom_full = state_dict_from_jax({"params": momentum, "batch_stats": stats}, arch)
    plan = tensor.tp_plan(model)
    model.load_state_dict(full, strict=True)
    opt = make_sgd(model, 0.01)
    names = tensor.param_names(model, opt)
    opt_sd = opt.state_dict()
    opt_sd["state"] = {i: {"momentum_buffer": mom_full[n].clone()} for i, n in enumerate(names)}

    shards = []
    for m in range(2):
        device = mesh.devices[0, m]

        def on_device(tree):
            return jax.tree.map(lambda a: np.asarray(
                [s.data for s in a.addressable_shards if s.device == device][0]), tree)

        jax_sd = state_dict_from_jax({"params": on_device(placed.params),
                                      "batch_stats": on_device(placed.batch_stats)}, arch)
        jax_mom = state_dict_from_jax({"params": on_device(placed.opt.momentum),
                                       "batch_stats": on_device(placed.batch_stats)}, arch)
        mine = tensor.shard_state_dict(full, plan, m, 2)
        mine_opt = tensor.shard_optimizer_state(opt_sd, names, plan, m, 2)
        assert sorted(mine) == sorted(jax_sd)
        for k, v in jax_sd.items():
            assert torch.equal(mine[k], v), k
            assert k not in plan or v.shape[0] == plan[k] // 2, k
        for i, n in enumerate(names):
            assert torch.equal(mine_opt["state"][i]["momentum_buffer"], jax_mom[n]), n
        shards.append(mine)
    back = tensor.gather_state_dict(shards, plan)
    assert all(torch.equal(back[k], v) for k, v in full.items())


def test_uneven_splits_follow_tensor_split():
    """``split_sizes`` is ``torch.tensor_split``'s (the Cityscapes
    PSANet50's 7921 attention channels: 3961 and 3960; ADE20K's 3481 over
    4 ranks), and a shard of a planned entry of the wrong width raises."""
    for full, size in ((7921, 2), (3481, 4), (512, 2), (289, 3), (256, 4)):
        want = [len(c) for c in torch.tensor_split(torch.arange(full), size)]
        assert tensor.split_sizes(full, size) == want
    assert tensor.split_sizes(7921, 2) == [3961, 3960]
    plan = {"psa.attention.3.weight": 289}
    full = {"psa.attention.3.weight": torch.randn(289, 4, 1, 1), "other": torch.ones(3)}
    parts = [tensor.shard_state_dict(full, plan, r, 2) for r in range(2)]
    assert [p["psa.attention.3.weight"].shape[0] for p in parts] == [145, 144]
    assert parts[1]["other"] is full["other"]
    assert torch.equal(tensor.gather_state_dict(parts, plan)["psa.attention.3.weight"],
                       full["psa.attention.3.weight"])
    with pytest.raises(ValueError, match="289"):
        tensor.shard_state_dict(parts[0], plan, 0, 2)


def test_jax_refuses_an_odd_split_the_port_takes():
    """JAX places TP shards with ``jax.device_put``, which refuses a
    dimension the ``model`` axis does not divide: ``shard_train_state`` of
    a PSA attention logits conv to 289 channels (a 17x17 mask; the recipe
    PSANet50s have 7921 and 3481) raises on a ``(1, 2)`` mesh. The port
    splits it 145 / 144 and gathers it back."""
    kernel = np.random.RandomState(3).randn(1, 1, 8, 289).astype(np.float32)
    params = {"psa": {"attention_conv": {"kernel": kernel}}}
    state = TrainState(params=params, batch_stats={}, opt=SGDState(momentum=params),
                       step=jnp.zeros((), jnp.int32))
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="divisible by 2"):
        shard_train_state(state, mesh)
    sd = {"psa.attention.3.weight": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())}
    plan = {"psa.attention.3.weight": 289}
    parts = [tensor.shard_state_dict(sd, plan, r, 2) for r in range(2)]
    assert [p["psa.attention.3.weight"].shape[0] for p in parts] == [145, 144]
    assert torch.equal(tensor.gather_state_dict(parts, plan)["psa.attention.3.weight"],
                       sd["psa.attention.3.weight"])
