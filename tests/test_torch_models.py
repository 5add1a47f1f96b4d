"""The port's learned models (``sks_tpu_torch.models``) against
``sks_tpu.models`` on carried weights, and their benchmark's pieces.

Weights are the JAX package's flax initializations carried across by
``utils.convert.homography_net_state_from`` / ``ihn_state_from``; batches
are the JAX ``synth_training_batch``'s, and the port's renderer is held to it
through ``draws=`` (``jax.random`` and torch draw different streams).
``HomographyNet`` runs at full width (64 x 64, B = 2), the IHN narrow (32 x
32, dim 16, 2 iterations) to keep the JAX compiles short.  Tolerances, each
against the largest entry compared unless stated:

* forwards, ``homography()``, losses, the warp's values and gradients and
  flax's 'SAME' convolution: 5e-5 (XLA on the CPU contracts multiply-adds
  and the port does not; the gaps measured are 0 to 2.2e-6);
* the rendered pair: 1e-5 (measured 2.1e-6: the warp samples a smooth
  image at points that the two 3 x 3 inverses place slightly apart);
* three Adam steps: losses within 2e-5 relative, parameters within 3e-5
  absolute, a tenth of the 3e-4 each moves (Adam normalizes the step, so
  an entry whose gradient sits at rounding level moves by up to lr = 1e-4
  a step in either direction; measured 5e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sks_tpu.models as jm
from sks_tpu.models.deep_homography import TrainState as JTrainState
from sks_tpu.models.deep_homography import synth_training_batch as j_synth
from sks_tpu.models.iterative import warp_by_homography as j_warp

import sks_tpu_torch.models as tm
from sks_tpu_torch.bench import models_mace
from sks_tpu_torch.models.deep_homography import (
    SameConv2d,
    TrainState,
    synth_training_batch,
)
from sks_tpu_torch.utils.convert import homography_net_state_from, ihn_state_from
from torch_parity import to_np

RTOL = 5e-5
STEPS = 3
IHN_DIM, IHN_ITERS, IHN_SIZE = 16, 2, 32


def T(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol=RTOL):
    got, want = to_np(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_run(model, step, size, batch_kw):
    """Params, 3 batches, the first batch's forward, and 3 JAX steps."""
    key = jax.random.PRNGKey(0)
    params = model.init(key, jnp.zeros((1, size, size, 2), jnp.float32))
    synth = jax.jit(lambda k: j_synth(k, 2, size, **batch_kw))
    keys = [jax.random.fold_in(key, i) for i in range(STEPS)]
    batches = [tuple(np.asarray(x) for x in synth(k)) for k in keys]
    out = np.asarray(jax.jit(model.apply)(params, batches[0][0]))
    state = JTrainState(params, optax.adam(1e-4).init(params))
    losses = []
    for pair, off in batches:
        state, loss = step(model, state, pair, off)
        losses.append(float(loss))
    return {"params": _numpy_tree(params), "keys": keys, "batches": batches,
            "out": out, "losses": losses,
            "trained": _numpy_tree(state.params)}


@pytest.fixture(scope="module")
def hnet():
    return _jax_run(jm.HomographyNet(), jm.train_step, 64, {})


@pytest.fixture(scope="module")
def ihn():
    model = jm.IterativeHomographyNet(dim=IHN_DIM, iters=IHN_ITERS)
    run = _jax_run(model, jm.ihn_train_step, IHN_SIZE, {"max_offset": 8.0})
    run["model"] = model
    return run


def _port_hnet(run):
    net = tm.HomographyNet()
    net.load_state_dict(homography_net_state_from(run["params"]))
    return net


def _port_ihn(run):
    net = tm.IterativeHomographyNet(dim=IHN_DIM, iters=IHN_ITERS)
    net.load_state_dict(ihn_state_from(run["params"], dim=IHN_DIM))
    return net


def test_models_export_the_reference_names():
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    assert public(tm) == public(jm)


def test_synth_training_batch_matches_jax(hnet):
    """The JAX function's own key split and draws, rendered by the port."""
    k1, k1b, k2 = jax.random.split(hnet["keys"][0], 3)
    draws = (jax.random.uniform(k1, (2, 8, 8), jnp.float32),
             jax.random.uniform(k1b, (2, 24, 24), jnp.float32),
             jax.random.uniform(k2, (2, 4, 2), jnp.float32, -16.0, 16.0))
    pair, off = synth_training_batch(None, 2, 64,
                                     draws=[T(d) for d in draws])
    want_pair, want_off = hnet["batches"][0]
    assert pair.shape == (2, 64, 64, 2) and off.shape == (2, 4, 2)
    np.testing.assert_array_equal(to_np(off), want_off)
    _close(pair, want_pair, rtol=1e-5)


def test_synth_training_batch_draws_from_its_generator():
    def draw(seed):
        return synth_training_batch(torch.Generator().manual_seed(seed), 3,
                                    32, max_offset=4.0)

    (p0, o0), (p1, o1), (p2, _) = draw(0), draw(0), draw(1)
    assert p0.shape == (3, 32, 32, 2) and o0.shape == (3, 4, 2)
    assert torch.equal(p0, p1) and torch.equal(o0, o1)
    assert not torch.equal(p0, p2)
    assert o0.abs().max() <= 4.0 and torch.isfinite(p0).all()
    assert p0[..., 0].min() >= 0.0 and p0[..., 0].max() <= 1.0


@pytest.mark.parametrize("side", [16, 63, 64])
def test_same_conv_pads_as_flax(side):
    """flax 'SAME' at stride 2: (0, 1) on an even side, (1, 1) on an odd."""
    import flax.linen as nn

    x = np.random.default_rng(side).normal(size=(2, side, side, 3))
    x = x.astype(np.float32)
    conv = nn.Conv(4, (3, 3), strides=(2, 2))
    params = conv.init(jax.random.PRNGKey(1), x)["params"]
    want = np.asarray(jax.jit(conv.apply)({"params": params}, x))
    port = SameConv2d(3, 4)
    with torch.no_grad():
        port.weight.copy_(T(params["kernel"]).permute(3, 2, 0, 1))
        port.bias.copy_(T(params["bias"]))
        got = port(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got, want)


def test_homography_net_matches_jax(hnet):
    net = _port_hnet(hnet)
    with torch.no_grad():
        got = net(T(hnet["batches"][0][0]))
    assert got.shape == (2, 4, 2)
    _close(got, hnet["out"])


def test_homography_net_homography_matches_jax(hnet):
    pair = hnet["batches"][0][0]
    origin = np.zeros((2, 2), np.float32)
    size = np.full((2, 2), 63.0, np.float32)
    want = jm.HomographyNet().homography(hnet["params"], pair, origin, size)
    with torch.no_grad():
        got = _port_hnet(hnet).homography(T(pair), T(origin), T(size))
    _close(got, want)


def test_ihn_matches_jax(ihn):
    net = _port_ihn(ihn)
    with torch.no_grad():
        got = net(T(ihn["batches"][0][0]))
    assert got.shape == (IHN_ITERS, 2, 4, 2)
    _close(got, ihn["out"])


def test_ihn_homography_matches_jax(ihn):
    pair = ihn["batches"][0][0]
    want = jax.jit(ihn["model"].homography)(ihn["params"], pair)
    with torch.no_grad():
        got = _port_ihn(ihn).homography(T(pair))
    _close(got, want)


def _warp_inputs():
    rng = np.random.default_rng(7)
    img = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    h = np.eye(3, dtype=np.float32) + rng.normal(0.0, 0.02, (2, 3, 3))
    h[:, :2, 2] = rng.uniform(-2.0, 2.0, (2, 2))
    h[:, 2, :2] = rng.normal(0.0, 1e-3, (2, 2))
    h[:, 2, 2] = 1.0
    weights = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    return img, h.astype(np.float32), weights


def test_warp_by_homography_matches_jax_in_values_and_gradients():
    img, h, w = _warp_inputs()

    def loss(i, hh):
        return jnp.sum(j_warp(i, hh, sampler="gather") * w)

    want = np.asarray(jax.jit(lambda i, hh: j_warp(i, hh, "gather"))(img, h))
    gi_want, gh_want = jax.jit(jax.grad(loss, argnums=(0, 1)))(img, h)
    ti, th = T(img).requires_grad_(), T(h).requires_grad_()
    got = tm.warp_by_homography(ti, th)
    torch.sum(got * T(w)).backward()
    assert got.shape == img.shape
    _close(got.detach(), want)
    _close(ti.grad, gi_want)
    _close(th.grad, gh_want)


def test_warp_by_homography_identity_and_matmul_raises():
    img, _, _ = _warp_inputs()
    eye = torch.eye(3).expand(2, 3, 3)
    # The clamp at w - 1.001 blends ~1e-3 of the last row and column.
    np.testing.assert_allclose(to_np(tm.warp_by_homography(T(img), eye)),
                               img, atol=5e-3)
    with pytest.raises(ValueError, match="matmul"):
        tm.warp_by_homography(T(img), eye, sampler="matmul")


def test_losses_match_jax():
    rng = np.random.default_rng(8)
    seq = rng.normal(0.0, 4.0, (5, 3, 4, 2)).astype(np.float32)
    true = rng.normal(0.0, 4.0, (3, 4, 2)).astype(np.float32)
    _close(tm.sequence_loss(T(seq), T(true)),
           jm.sequence_loss(seq, true))
    _close(tm.corner_loss(T(seq[0]), T(true)), jm.corner_loss(seq[0], true))


def _train(net, step, run):
    state = TrainState.create(net)
    losses = []
    for pair, off in run["batches"]:
        state, loss = step(net, state, T(pair), T(off))
        assert loss.dim() == 0
        losses.append(loss.item())
    return losses


def _held_to_jax_steps(net, losses, run, state_from):
    np.testing.assert_allclose(losses, run["losses"], rtol=2e-5)
    want = state_from(run["trained"])
    got = net.state_dict()
    start = state_from(run["params"])
    for k in want:
        assert (want[k] - start[k]).abs().max() > 1e-4, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=3e-5,
                                   msg=k)


def test_train_step_matches_jax(hnet):
    net = _port_hnet(hnet)
    losses = _train(net, tm.train_step, hnet)
    _held_to_jax_steps(net, losses, hnet, homography_net_state_from)


def test_ihn_train_step_matches_jax(ihn):
    net = _port_ihn(ihn)
    losses = _train(net, tm.ihn_train_step, ihn)
    _held_to_jax_steps(net, losses, ihn,
                       lambda t: ihn_state_from(t, dim=IHN_DIM))


def _drop(tree, *path):
    tree = jax.tree_util.tree_map(lambda x: x, tree)  # a copy
    node = tree
    for k in path[:-1]:
        node = node[k]
    del node[path[-1]]
    return tree


@pytest.mark.parametrize("fault", ["no_params", "missing_layer",
                                   "extra_layer", "missing_leaf",
                                   "wrong_shape"])
def test_convert_raises_on_a_wrong_tree(hnet, ihn, fault):
    h, i = hnet["params"], ihn["params"]
    if fault == "no_params":
        bad_h, bad_i = h["params"], i["params"]
    elif fault == "missing_layer":
        bad_h = _drop(h, "params", "Dense_1")
        bad_i = _drop(i, "params", "_Update_0", "Conv_1")
    elif fault == "extra_layer":
        bad_h = {"params": {**h["params"], "Conv_3": h["params"]["Conv_2"]}}
        bad_i = {"params": {**i["params"], "_Extra_0": {}}}
    elif fault == "missing_leaf":
        bad_h = _drop(h, "params", "Conv_0", "bias")
        bad_i = _drop(i, "params", "_Encoder_0", "Conv_0", "kernel")
    else:
        bad_h = {"params": {**h["params"],
                            "Dense_1": {"kernel": np.zeros((256, 9)),
                                        "bias": np.zeros(9)}}}
        bad_i = ihn["params"]  # carried to the full-width module
    with pytest.raises(ValueError):
        homography_net_state_from(bad_h)
    with pytest.raises(ValueError):
        ihn_state_from(bad_i, dim=IHN_DIM if fault != "wrong_shape" else 64)


def test_initialization_follows_flax():
    """lecun_normal: a normal truncated at two standard deviations with
    variance 1 / fan-in (within 2% on the 2M-entry dense kernel); zero
    biases; the same generator seed gives the same weights."""
    net, state = tm.create_train_state(torch.Generator().manual_seed(0),
                                       device="cpu")
    again, _ = tm.create_train_state(torch.Generator().manual_seed(0),
                                     device="cpu")
    for (name, p), q in zip(net.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            std = (1.0 / p[0].numel()) ** 0.5
            assert p.abs().max() <= 2 * std / 0.87962566103423978, name
    w = net.dense0.weight
    assert abs(w.std().item() / (1.0 / 8192) ** 0.5 - 1.0) < 0.02
    assert isinstance(state.optimizer, torch.optim.Adam)
    assert state.optimizer.defaults["lr"] == 1e-4
    ihn_net, _ = tm.create_ihn_state(torch.Generator().manual_seed(0),
                                     device="cpu")
    assert ihn_net.iters == 6 and ihn_net.encoder.conv1.out_channels == 64
    assert next(ihn_net.parameters()).device.type == "cpu"


def test_forward_and_backward_read_nothing_back(monkeypatch):
    """No host read in the render, the forwards or the backward passes
    (every way a tensor reaches the host raises); Adam's step is checked
    on the card, where it keeps its step count on the host."""
    net = tm.IterativeHomographyNet(dim=8, iters=2)
    cnn = tm.HomographyNet(image_size=32)

    def refuse(*_args, **_kwargs):
        raise AssertionError("a host read inside the models path")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    pair, off = synth_training_batch(torch.Generator().manual_seed(0), 2, 32)
    tm.sequence_loss(net(pair), off).backward()
    tm.corner_loss(cnn(pair), off).backward()


def test_models_mace_pieces_on_the_cpu():
    """The benchmark's training loop and MACE at toy size; its timed entry
    point refuses the CPU."""
    net, state = tm.create_train_state(torch.Generator().manual_seed(0),
                                       image_size=32, device="cpu")
    loss = models_mace.train(tm.train_step, net, state,
                             torch.Generator().manual_seed(1), 2, 2, 32)
    assert loss.dim() == 0 and torch.isfinite(loss)
    pred = torch.zeros(3, 4, 2)
    true = torch.full((3, 4, 2), 3.0)
    true[..., 1] = 4.0
    assert models_mace.mace(pred, true).item() == pytest.approx(5.0)
    with pytest.raises(ValueError, match="CUDA"):
        models_mace.train_and_eval(steps=1, device="cpu")
    res = {"card": "card, 700.00 W", "steps": 1, "batch": 2,
           "image_size": 32, "eval_batch": 4}
    for name in ("cnn", "ihn"):
        res.update({f"mace_{name}_untrained_px": 9.0, f"mace_{name}_px": 5.0,
                    f"{name}_train_seconds": 1.0,
                    f"{name}_step_device_ms": 1.0,
                    f"{name}_forward_device_ms": 0.5})
    res["mace_ihn_px"] = 4.0
    assert "Expected ordering holds" in models_mace.to_markdown(res)
